// Flash attention backward (GQA, causal and/or sliding window) for Hopper
// (sm_90a), bound to Python with ctypes. Three routes, each two launches:
// bfloat16 at head widths 64, 128, 192 and 256 runs on the tensor cores
// (dq: flash_bwd_dq_wgmma_pipe at 128, flash_bwd_dq_wgmma at 64, 192 and
// 256; dk/dv: flash_bwd_dkdv_wgmma_pipe at 64 and 128 when G > 1,
// flash_bwd_dkdv_wgmma at 64 and 128 when G = 1, flash_bwd_dkdv_wgmma_split
// at 192 and 256; the wrapper zero-pads any width up to 256 to the next of
// these; the one-warpgroup pair at 64 and 128 stays bound as the
// two-warpgroup kernels' yardstick, flash_bwd_dq_bf16_yardstick and
// flash_bwd_dkdv_bf16_yardstick); bfloat16 at a multiple of 64
// above 256 on the tensor cores in column blocks (flash_bwd_dq_wgmma_cols,
// flash_bwd_dkdv_wgmma_cols; the wrapper pads the width to a multiple of
// 64); float32 at a multiple of 32 on the tensor cores too, each fp32
// product as three TF32 products (flash_bwd_dq_tf32x3,
// flash_bwd_dkdv_tf32x3, route tf32x3; one TF32 product would break the
// fp32 tolerances, the split of each operand into hi and lo parts keeps
// them; the wrapper pads the width to a multiple of 32). The CUDA-core pair
// (flash_bwd_dq_cc, flash_bwd_dkdv_cc; any hd, either dtype) stays as the
// yardstick of the tensor-core routes; no route reaches it.
//
// Replaces the backward of the JAX package's flash attention custom VJP,
// src/repro/models/layers.py:201 _fa_bwd (jnp; the JAX package has no
// backward kernel), whose math the port's plain version
// kernels/ref.py::flash_attention_bwd repeats. For q, out, dout [B, S, H,
// hd], k, v [B, S, Kv, hd] (self-attention, query head h reads kv head
// h / G, G = H / Kv) and the forward's lse fp32 [B, H, S]:
//
//   D_i = sum_d dout_id out_id
//   P_ij = exp(q_i . k_j * scale - lse_i)      (0 where j is masked)
//   dv_j = sum_i P_ij dout_i          dP_ij = dout_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) scale
//   dq_i = sum_j dS_ij k_j            dk_j = sum_i dS_ij q_i
//
// with scale = 1 / sqrt(hd), the masks of the forward (causal: j <= i;
// window w > 0: j > i - w), and dk, dv summed over the G query heads of
// each kv head; dq, dk, dv are stored in their inputs' dtypes.
//
// Bound on an H100: the causal backward's five products (q k^T recomputed,
// dv, dP, dq, dk) take 5 * 2 * B * H * hd * S(S+1)/2 flops; at
// stablelm-1.6b's training shape (B=1, S=4,096, 32 heads, hd 64) 171.8
// GFLOP, 0.174 ms at the 989 TFLOP/s bf16 rate, against ~4.2 MB of inputs
// and outputs (~1.3 us at 3.35 TB/s), so operations bound it. This design
// runs seven products (q k^T and dout v^T once in each launch), so its own
// floor is 7/5 of that, 0.243 ms, plus the diagonal tiles' masked halves.
//
// Deterministic, no atomics: each output element is summed by one thread
// of one block, in a fixed order. Two launches:
//  1. dq (q-outer): one block per (64-row q tile, query head, batch). It
//     computes D for its rows from out and dout (and writes it, fp32 [B, H,
//     S], for launch 2), then over the kv tiles its rows can see recomputes
//     S = q k^T and dP = dout v^T, forms P and dS in registers and adds dS k
//     into dq, kept in registers.
//  2. dk/dv (kv-outer): one block per (64-row kv tile, kv head, batch). Over
//     the G query heads and the q tiles that can see its rows it computes
//     S^T = k q^T and dP^T = v dout^T, forms P^T and dS^T, and adds P^T dout
//     into dv and dS^T q into dk, both kept in registers.
// That is FlashAttention-2's backward order (Dao, 2023) with its atomic dq
// replaced by a second pass, so the card keeps deterministic mode.
//
// The one-warpgroup tensor-core kernels (128 threads a block). Its own two
// tiles (q and dout, or k and v) and a two-stage ring of the other side's
// tiles come into shared memory by TMA (64 positions x 64 columns a box,
// 128-byte swizzle; rows past S arrive as zeros), each stage on a "full"
// mbarrier; thread 0 loads stage i + 1 while the warpgroup computes on
// stage i, and a barrier at the end of each iteration frees the stage. Per
// tile: S and dP by wgmma m64n64k16 with both operands in shared memory
// (K-major, over hd); P = 2^(s * scale * log2(e) - lse * log2(e)) by one
// FFMA and one ex2.approx a score, masked only on tiles that cross the
// diagonal, the window's edge or S; P and dS rounded once to bf16 in
// registers, in wgmma's A-register layout (the accumulator layout), so they
// never touch shared memory; then dq += dS k, dv += P^T dout and dk += dS^T
// q by wgmma m64n{hd}k16 with A from registers and B the tile in shared
// memory, MN-major. Blocks start with the heaviest causal tiles. P and dS
// in bf16 (2^-9 relative each) keep dq/dk/dv within 2e-2 of max |grad|
// (tests/test_torch_bwd_kernels.py models this rounding on the CPU).
//
// The two-warpgroup kernels (hd 64 and 128; 256 threads, no producer
// warpgroup, so ptxas still budgets 255 registers a thread). The
// one-warpgroup dk/dv block walks G x n_q iterations in one chain, one
// warpgroup an SM, and ends every iteration in a block barrier: at
// internvl2-1b's G = 7 its 128 blocks leave one warpgroup on each SM and
// kv tile 0's chain is 448 iterations, twice an SM's mean load.
// flash_bwd_dkdv_wgmma_pipe splits a kv tile's iterations between two
// warpgroups (i to warpgroup i % 2), each with its own dk and dv, and while
// the kv tiles are fewer than the SMs between the two blocks of a thread
// block cluster as well (pairs of iterations alternating between them: four
// warpgroups, kv tile 0's chain 112 iterations); a ring of q and dout
// stages (8 at hd 64, 4 at 128), each with a full and an empty mbarrier,
// takes the place of the barrier: the warpgroup that read a stage releases
// it and refills it (TMA by its thread 0, the stage's lse and D by its 128
// threads, read from global memory an iteration ahead). Within a warpgroup
// S^T and dP^T are two product groups: P^T is formed while dP^T runs,
// dS^T while dv's product runs, and dk's product runs on into the next
// iteration. At the end a block's warpgroup 1 hands its dv and warpgroup 0
// its dk over through shared memory (dv = dv_0 + dv_1, dk = dk_0 + dk_1),
// and a cluster's block 1 its sums to block 0 through distributed shared
// memory (block 0's + block 1's): a fixed order, no atomics, no sum through
// global memory. At G = 1 there is no chain to split and the blocks are
// many (stablelm-1.6b: 2,048), and the one-warpgroup kernel (163
// registers, three blocks an SM at hd 64) measured faster, so it keeps G =
// 1. flash_bwd_dq_wgmma_pipe (hd 128)
// takes the (q tile, query head) units of a kv head two a block in
// q-tile-major order, so its warpgroups' q tiles are one or two neighbours,
// and streams the pair's kv tiles once through one ring that both read
// (each warpgroup computes on its own unit's span and passes the rest): at
// qwen1.5-110b's G = 8 the two are two query heads of one q tile, and the k
// and v reads and the block count halve. At hd 64 the one-warpgroup dq
// kernel (128 registers, four blocks an SM) measured faster than the pair
// and stays. Sums start with a product of scale_d 0, not with zeroed
// registers: a zeroing of accumulators that a product in flight across the
// loop's back edge adds into made ptxas serialize every wgmma (C7515).
//
// At hd 192 and 256 the dq kernel is the same template (96 / 128
// accumulators beside S and dP: 160 / 192 registers of the 255 a thread
// of a 128-thread block may hold). One warpgroup cannot hold dk and dv
// there (96 + 96 or 128 + 128 accumulators beside S^T and dP^T), so
// flash_bwd_dkdv_wgmma_split runs two warpgroups a block (256 threads:
// ptxas still budgets 255 registers a thread; no producer warpgroup, whose
// third warpgroup would cut that to 168) over the same k and v tiles and
// one ring of q and dout tiles: warpgroup 0 computes S^T, P^T and dv +=
// P^T dout; warpgroup 1 computes S^T again, dP^T, dS^T and dk += dS^T q.
// A stage is freed by a barrier of both warpgroups. That is eight
// products a call (S^T recomputed once more) against seven at 64 and 128,
// the same bits of P^T and dS^T as the one-warpgroup kernel (the same
// wgmma on the same tiles), and each output element still summed by one
// thread in a fixed order.
//
// Above hd 256 (flash_bwd_dq_wgmma_cols, flash_bwd_dkdv_wgmma_cols; hd a
// multiple of 64 at run time) no tile of q, k, v or dout fits shared
// memory whole beside the others (64 rows are 128 KB at hd 1,024), so
// everything streams in 64-column chunks, the forward's column-block idea:
// S = sum_c q_c k_c^T and dP = sum_c dout_c v_c^T accumulate in the wgmma
// registers over the hd / 64 chunks (m64n64k16, both operands in shared
// memory), each ring stage one TMA box of q, dout, k and v (64 positions x
// 64 columns; the maps index positions, so no producer warpgroup is needed
// as in the forward), refilled by thread 0 once the barrier after a
// stage's products has passed. A block owns NB = 192 or 256 output
// columns (col_block: the fewest blocks n_cb, then the fewest wasted
// columns): the dq launch is one warpgroup per (q tile, head, batch,
// column block) with NB / 2 accumulators beside S and dP, as dq<256>; the
// dk/dv launch keeps the split per (kv tile, kv head, batch, column
// block), warpgroup 0 S^T -> P^T -> dv and warpgroup 1 S^T -> dP^T -> dS^T
// -> dk, NB / 2 accumulators each. The NB columns of the other operand of
// the output product (k for dq; q and dout for dk and dv) come as their
// own TMA boxes once an iteration. P and dS stay in registers in the
// A-register layout, rounded once to bf16 as at hd <= 256 (the CPU model
// in tests/test_torch_bwd_kernels.py holds the 2e-2 gate at hd 576 and
// 1,024). Every column block recomputes S and dP in full, so a call runs
// 5 n_cb + 3 full-width products against the bound's five (dq: 2 n_cb +
// 1; dk/dv: 3 n_cb + 2): 3.6x at hd 576 (n_cb 3), 4.6x at 1,024 (n_cb 4);
// and every column block streams the full-width q, k, v and dout once per
// tile pair through L2. D is over the full width: every dq block computes
// it for its rows (64 rows x hd, a small share of its reads) and column
// block 0 writes it for the dk/dv launch.
//
// The CUDA-core kernels (the yardstick): 256 threads a block, 64 rows a
// block, 4 threads a row, the other side in tiles of 32 positions (8
// columns a thread); scores and dP summed over hd in chunks of 64 columns
// staged in shared memory, then P and dS through shared memory into this
// block's 64 output columns (blocks own column chunks, so any hd runs; each
// chunk's block recomputes the scores: exact, simple, not fast).
//
// The fp32 tensor-core kernels (tf32x3; the split and its products live in
// csrc/tf32x3.cuh, which the fp32 forward shares). An fp32 operand x is
// split into hi, x itself (the tensor core reads a raw fp32 value as its
// TF32 truncation, trunc(x), as a one-time probe on an H100 showed;
// PERF.md section 6), and lo = tf32(x - trunc(x)) by cvt.rna; a product is
// hi hi' + hi lo' + lo hi' in fp32, ~2^-20 of it dropped. The tensor core's
// fp32 accumulation truncates (the probe: ~3e-8 of the result per
// accumulation), so every chain is kept short (12 products: one 32-column
// chunk of hd; 24: one 64-position tile of an output product) and the
// chains are added in fp32 registers; the gradients then hold the plain backward's 2e-5 of max
// |grad| (tests/test_torch_bwd_kernels.py models the split against JAX).
// Both launches are one template (tf32x3_block): a block owns 64 rows and
// takes the other side in tiles of 64 positions, its two warpgroups over
// one ring of 32-column chunks (128 bytes, one row of the 128-byte
// swizzle) that thread 0 fills by TMA. Per tile, hd / 32 product steps (a
// chunk of each of the four inputs: warpgroup 0 forms S, or S^T, and
// warpgroup 1 dP, or dP^T, on wgmma m64n64k8 .tf32 with both operands in
// shared memory, K-major), then P and dS in registers, exchanged between
// the warpgroups through shared memory, then output steps of the other
// side's output columns (dq += dS k over each warpgroup's half of the
// block's columns; dv += P^T dout on warpgroup 0, dk += dS^T q on
// warpgroup 1) on mma.sync m16n8k8 .tf32: wgmma reads a 32-bit B only
// K-major, and these B are MN-major; A is the accumulator as it stands, its
// k permuted within each group of 8 on the B side. The threads write each
// landed stage's lo parts beside it while the previous stage's products
// run. The block owns as many output columns as 255 registers a thread
// allow (128 accumulators a warpgroup beside its 64 of S or dP): dq 128,
// 256 or 512 columns, dk/dv 64, 128 or 256, so up to hd 256 each launch
// forms S and dP once per tile pair (8 products a call, dq's S and dP each
// on one warpgroup), and above it dq's column blocks are half as many as
// dk/dv's. What bounds them on the H100 is the bytes they stream: the own
// side's 64 rows cross L2 once per other tile (PERF.md, §6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kMaxSmem = 232448;            // a block's dynamic opt-in bytes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Whether query position qp sees key position kp (the forward's masks).
__device__ __forceinline__ bool sees(int qp, int kp, int seq, int causal,
                                     int window) {
  return qp < seq && kp < seq && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// The kv positions [lo, hi) that q rows q0 .. q_last see, and the q
// positions [lo, hi) that see kv rows k0 .. k_last.
__device__ __forceinline__ int2 kv_span(int q0, int q_last, int seq,
                                        int causal, int window) {
  return make_int2(window > 0 ? max(0, q0 - window + 1) : 0,
                   causal ? min(seq, q_last + 1) : seq);
}
__device__ __forceinline__ int2 q_span(int k0, int k_last, int seq,
                                       int causal, int window) {
  return make_int2(causal ? k0 : 0,
                   window > 0 ? min(seq, k_last + window) : seq);
}

// ---------------------------------------------------------------------------
// CUDA cores: any dtype, any hd
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kRows = 64;                    // rows a block owns
constexpr int kLanes = kThreads / kRows;     // threads a row
constexpr int kCols = 32;                    // positions of the other side a tile
constexpr int kPer = kCols / kLanes;         // score columns a thread
constexpr int kChunk = 64;                   // hd columns a pass of the sums
constexpr int kOut = 64;                     // output columns a block owns
constexpr int kOutPer = kOut / kLanes;       // output columns a thread

static_assert(kLanes == 4, "the shuffles below combine 4 lanes");

// Shared memory, in floats: two row-side hd chunks [kRows][kA], two
// tile-side ones [kCols][kA], two probability tiles [kRows][kP], two
// tile-side output-column blocks [kCols][kOut], two vectors [kCols]. The +4
// keeps rows 16-byte aligned and spreads a warp's rows over the banks.
struct Smem {
  static constexpr int kA = kChunk + 4;
  static constexpr int kP = kCols + 4;
  static constexpr int kRowSide = kRows * kA;
  static constexpr int kTileSide = kCols * kA;
  static constexpr int kProb = kRows * kP;
  static constexpr int kOutTile = kCols * kOut;
  static constexpr int kFloats =
      2 * kRowSide + 2 * kTileSide + 2 * kProb + 2 * kOutTile + 2 * kCols;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kBytes <= kMaxSmem, "over the 227 KB a block may opt in to");
};

// rows [pos0, pos0 + n) of one head, columns [d0, d0 + width) of hd, as fp32
// into dst (row stride `stride`); zeros past S and past hd. `base` points at
// (batch, position 0, head, column 0); positions are `step` elements apart.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ base,
                                      int64_t step, int pos0, int n, int seq,
                                      int64_t d0, int64_t hd, int width) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int r = idx / width, d = idx % width;
    const int p = pos0 + r;
    dst[r * stride + d] = p < seq && d0 + d < hd
                              ? to_float(base[p * step + d0 + d])
                              : 0.0f;
  }
}

// s[c] += row . a_c and t[c] += row2 . b_c over a staged chunk, for this
// thread's columns lane + kLanes * c.
__device__ __forceinline__ void chunk_sums(const float* r1, const float* r2,
                                           const float* c1, const float* c2,
                                           int lane, float (&s)[kPer],
                                           float (&t)[kPer]) {
#pragma unroll 4
  for (int d = 0; d < kChunk; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(r1 + d);
    const float4 b = *reinterpret_cast<const float4*>(r2 + d);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(
          c1 + (lane + kLanes * c) * Smem::kA + d);
      const float4 y = *reinterpret_cast<const float4*>(
          c2 + (lane + kLanes * c) * Smem::kA + d);
      s[c] = fmaf(a.x, x.x, s[c]);
      s[c] = fmaf(a.y, x.y, s[c]);
      s[c] = fmaf(a.z, x.z, s[c]);
      s[c] = fmaf(a.w, x.w, s[c]);
      t[c] = fmaf(b.x, y.x, t[c]);
      t[c] = fmaf(b.y, y.y, t[c]);
      t[c] = fmaf(b.z, y.z, t[c]);
      t[c] = fmaf(b.w, y.w, t[c]);
    }
  }
}

// acc[4 i + e] += sum_j p[j] * m[j][16 i + 4 lane + e] over a tile.
__device__ __forceinline__ void add_tile(const float* p, const float* m,
                                         int lane, float (&acc)[kOutPer]) {
#pragma unroll 4
  for (int j = 0; j < kCols; ++j) {
    const float w = p[j];
#pragma unroll
    for (int i = 0; i < kOut / 16; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(m + j * kOut + 16 * i + 4 * lane);
      acc[4 * i + 0] = fmaf(w, x.x, acc[4 * i + 0]);
      acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
    }
  }
}

// Launch 1: dq, and D for launch 2. Block: (column chunk, q tile, head,
// batch), the q tiles heaviest first when causal.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_cc(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, T* __restrict__ dq, int seq,
                    int H, int Kv, int B, long long hd, int causal,
                    int window, float scale, int n_tiles, int n_oc) {
  using S = Smem;
  extern __shared__ float4 smem4[];
  float* Rq = reinterpret_cast<float*>(smem4);
  float* Ro = Rq + S::kRowSide;
  float* Ck = Ro + S::kRowSide;
  float* Cv = Ck + S::kTileSide;
  float* Ps = Cv + S::kTileSide;
  float* Ko = Ps + 2 * S::kProb;

  int64_t bid = blockIdx.x;
  const int oc = static_cast<int>(bid % n_oc);
  bid /= n_oc;
  const int h = static_cast<int>(bid % H);
  bid /= H;
  const int b = static_cast<int>(bid % B);
  const int t_lin = static_cast<int>(bid / B);
  const int qt = causal ? n_tiles - 1 - t_lin : t_lin;
  const int G = H / Kv, kvh = h / G;
  const int tr = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int q0 = qt * kRows, qp = q0 + tr;
  const bool row_ok = qp < seq;
  const int64_t c0 = static_cast<int64_t>(oc) * kOut;
  const int64_t qs = static_cast<int64_t>(H) * hd;     // position strides
  const int64_t ks = static_cast<int64_t>(Kv) * hd;
  const int64_t qoff = (static_cast<int64_t>(b) * seq * H + h) * hd;
  const int64_t koff = (static_cast<int64_t>(b) * seq * Kv + kvh) * hd;
  const int64_t voff = (static_cast<int64_t>(b) * H + h) * seq;

  // D of this thread's row over hd, its 4 lanes on interleaved columns
  float drow = 0.0f;
  if (row_ok)
    for (int64_t d = lane; d < hd; d += kLanes)
      drow = fmaf(to_float(dout[qoff + qp * qs + d]),
                  to_float(o[qoff + qp * qs + d]), drow);
  drow += __shfl_xor_sync(0xffffffffu, drow, 1);
  drow += __shfl_xor_sync(0xffffffffu, drow, 2);
  const float lrow = row_ok ? lse[voff + qp] : 0.0f;
  if (row_ok && lane == 0 && oc == 0) dsum[voff + qp] = drow;

  const int2 span = kv_span(q0, min(q0 + kRows, seq) - 1, seq, causal,
                            window);
  const int t_begin = span.x / kCols, t_end = (span.y + kCols - 1) / kCols;
  const bool one_chunk = hd <= kChunk;
  if (one_chunk) {
    stage(Rq, S::kA, q + qoff, qs, q0, kRows, seq, 0, hd, kChunk);
    stage(Ro, S::kA, dout + qoff, qs, q0, kRows, seq, 0, hd, kChunk);
  }
  float acc[kOutPer];
#pragma unroll
  for (int i = 0; i < kOutPer; ++i) acc[i] = 0.0f;
  const float* rq = Rq + tr * S::kA;
  const float* ro = Ro + tr * S::kA;
  float* prow = Ps + tr * S::kP;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kCols;
    float s[kPer], dp[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) s[c] = dp[c] = 0.0f;
    for (int64_t d0 = 0; d0 < hd; d0 += kChunk) {
      __syncthreads();                 // the last chunk (or tile) is read
      if (!one_chunk) {
        stage(Rq, S::kA, q + qoff, qs, q0, kRows, seq, d0, hd, kChunk);
        stage(Ro, S::kA, dout + qoff, qs, q0, kRows, seq, d0, hd, kChunk);
      }
      stage(Ck, S::kA, k + koff, ks, k0, kCols, seq, d0, hd, kChunk);
      stage(Cv, S::kA, v + koff, ks, k0, kCols, seq, d0, hd, kChunk);
      __syncthreads();
      chunk_sums(rq, ro, Ck, Cv, lane, s, dp);
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int kp = k0 + lane + kLanes * c;
      const float p = sees(qp, kp, seq, causal, window)
                          ? expf(s[c] * scale - lrow)
                          : 0.0f;
      prow[lane + kLanes * c] = p * (dp[c] - drow) * scale;
    }
    stage(Ko, kOut, k + koff, ks, k0, kCols, seq, c0, hd, kOut);
    __syncthreads();
    add_tile(prow, Ko, lane, acc);
  }
  if (!row_ok) return;
  T* out = dq + qoff + qp * qs + c0;
#pragma unroll
  for (int i = 0; i < kOut / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * i + 4 * lane + e;
      if (c0 + col < hd) out[col] = from_float<T>(acc[4 * i + e]);
    }
}

// Launch 2: dk and dv. Block: (column chunk, kv tile, kv head, batch), the
// kv tiles heaviest first when causal (tile 0 is seen by every q row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_cc(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, int H, int Kv, int B,
                      long long hd, int causal, int window, float scale,
                      int n_oc) {
  using S = Smem;
  extern __shared__ float4 smem4[];
  float* Rk = reinterpret_cast<float*>(smem4);
  float* Rv = Rk + S::kRowSide;
  float* Cq = Rv + S::kRowSide;
  float* Cd = Cq + S::kTileSide;
  float* Ps = Cd + S::kTileSide;
  float* Ds = Ps + S::kProb;
  float* Od = Ds + S::kProb;
  float* Oq = Od + S::kOutTile;
  float* sL = Oq + S::kOutTile;
  float* sD = sL + kCols;

  int64_t bid = blockIdx.x;
  const int oc = static_cast<int>(bid % n_oc);
  bid /= n_oc;
  const int kvh = static_cast<int>(bid % Kv);
  bid /= Kv;
  const int b = static_cast<int>(bid % B);
  const int kt = static_cast<int>(bid / B);
  const int G = H / Kv;
  const int tr = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int k0 = kt * kRows, kp = k0 + tr;
  const bool row_ok = kp < seq;
  const int64_t c0 = static_cast<int64_t>(oc) * kOut;
  const int64_t qs = static_cast<int64_t>(H) * hd;
  const int64_t ks = static_cast<int64_t>(Kv) * hd;
  const int64_t koff = (static_cast<int64_t>(b) * seq * Kv + kvh) * hd;

  const int2 span = q_span(k0, min(k0 + kRows, seq) - 1, seq, causal,
                           window);
  const int t_begin = span.x / kCols, t_end = (span.y + kCols - 1) / kCols;
  const bool one_chunk = hd <= kChunk;
  if (one_chunk) {
    stage(Rk, S::kA, k + koff, ks, k0, kRows, seq, 0, hd, kChunk);
    stage(Rv, S::kA, v + koff, ks, k0, kRows, seq, 0, hd, kChunk);
  }
  float ak[kOutPer], av[kOutPer];
#pragma unroll
  for (int i = 0; i < kOutPer; ++i) ak[i] = av[i] = 0.0f;
  const float* rk = Rk + tr * S::kA;
  const float* rv = Rv + tr * S::kA;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t qoff = (static_cast<int64_t>(b) * seq * H + h) * hd;
    const int64_t voff = (static_cast<int64_t>(b) * H + h) * seq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kCols;
      float s[kPer], dp[kPer];
#pragma unroll
      for (int c = 0; c < kPer; ++c) s[c] = dp[c] = 0.0f;
      for (int64_t d0 = 0; d0 < hd; d0 += kChunk) {
        __syncthreads();
        if (!one_chunk) {
          stage(Rk, S::kA, k + koff, ks, k0, kRows, seq, d0, hd, kChunk);
          stage(Rv, S::kA, v + koff, ks, k0, kRows, seq, d0, hd, kChunk);
        }
        stage(Cq, S::kA, q + qoff, qs, q0, kCols, seq, d0, hd, kChunk);
        stage(Cd, S::kA, dout + qoff, qs, q0, kCols, seq, d0, hd, kChunk);
        if (d0 == 0 && threadIdx.x < 2 * kCols) {
          const int j = threadIdx.x % kCols, p = q0 + j;
          const float* src = threadIdx.x < kCols ? lse : dsum;
          (threadIdx.x < kCols ? sL : sD)[j] = p < seq ? src[voff + p] : 0.0f;
        }
        __syncthreads();
        chunk_sums(rk, rv, Cq, Cd, lane, s, dp);
      }
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int j = lane + kLanes * c;
        const float p = sees(q0 + j, kp, seq, causal, window)
                            ? expf(s[c] * scale - sL[j])
                            : 0.0f;
        Ps[tr * S::kP + j] = p;
        Ds[tr * S::kP + j] = p * (dp[c] - sD[j]) * scale;
      }
      stage(Od, kOut, dout + qoff, qs, q0, kCols, seq, c0, hd, kOut);
      stage(Oq, kOut, q + qoff, qs, q0, kCols, seq, c0, hd, kOut);
      __syncthreads();
      add_tile(Ps + tr * S::kP, Od, lane, av);
      add_tile(Ds + tr * S::kP, Oq, lane, ak);
    }
  }
  if (!row_ok) return;
  T* out_k = dk + koff + kp * ks + c0;
  T* out_v = dv + koff + kp * ks + c0;
#pragma unroll
  for (int i = 0; i < kOut / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * i + 4 * lane + e;
      if (c0 + col < hd) {
        out_k[col] = from_float<T>(ak[4 * i + e]);
        out_v[col] = from_float<T>(av[4 * i + e]);
      }
    }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dsum, void* dq,
              int B, int seq, int H, int Kv, long long hd, int causal,
              int window, float scale, cudaStream_t st) {
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kRows - 1) / kRows;
  const int64_t n_oc = (hd + kOut - 1) / kOut;
  const int64_t blocks = n_tiles * H * B * n_oc;
  if (blocks >= (int64_t{1} << 31) || n_oc >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_cc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_cc<T><<<static_cast<unsigned>(blocks), kThreads, Smem::kBytes,
                       st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), seq, H,
      Kv, B, hd, causal, window, scale, static_cast<int>(n_tiles),
      static_cast<int>(n_oc));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dsum,
                void* dk, void* dv, int B, int seq, int H, int Kv,
                long long hd, int causal, int window, float scale,
                cudaStream_t st) {
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kRows - 1) / kRows;
  const int64_t n_oc = (hd + kOut - 1) / kOut;
  const int64_t blocks = n_tiles * Kv * B * n_oc;
  if (blocks >= (int64_t{1} << 31) || n_oc >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_cc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_cc<T><<<static_cast<unsigned>(blocks), kThreads,
                         Smem::kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, H, Kv, B, hd, causal,
      window, scale, static_cast<int>(n_oc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA; hd 64, 128, 192 and 256, then above 256
// in column blocks
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kTile = 64;                    // positions a tile, either side
constexpr int kThreads = 128;                // one warpgroup
constexpr int kChunkBytes = kTile * 128;     // 64 columns of a tile, swizzled

// Shared memory, from a 1024-byte aligned base: the block's own two tiles,
// two stages of two tiles of the other side, the q-side vectors (lse in the
// log2 domain, D) [2 stages][2][kTile] fp32, then 3 mbarriers (full[2],
// own). A tile is [HD / 64 chunks][64 rows][128 bytes], as TMA writes it.
template <int HD>
struct Cfg {
  static constexpr int kChunks = HD / 64;
  static constexpr int kTileBytes = kChunks * kChunkBytes;
  static constexpr int kStage0 = 2 * kTileBytes;
  static constexpr int kVec = kStage0 + 4 * kTileBytes;
  static constexpr int kBar = kVec + 2 * 2 * kTile * 4;
  static constexpr int kSmem = kBar + 3 * 8 + 1024;
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
};

// wgmma descriptors of a tile: K-major (a product over hd) and MN-major (a
// product over the tile's 64 rows, hd the N dimension); 8-row groups 1,024
// bytes apart, 64-column chunks kChunkBytes apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return desc(addr, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  return desc(addr, kChunkBytes, 1024, 1);
}

// d[64 x 64] = A B^T over hd, A and B tiles in shared memory (K-major).
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
  const uint64_t da = k_major(a), db = k_major(b);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = ((kk / 4) * kChunkBytes + 32 * (kk % 4)) >> 4;
    wgmma_ss(d, da + off, db + off, kk > 0);
  }
}

// acc[64 x HD] += A B over the 64 rows of B, A in registers (wgmma's
// A-register layout, 4 registers a k step of 16), B a tile (MN-major);
// with scale_d 0, acc = A B (acc need not be zeroed first).
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[kTile / 4],
                                         uint32_t b, int scale_d = 1) {
  const uint64_t db = mn_major(b);
#pragma unroll
  for (int t = 0; t < kTile / 16; ++t) {
    const uint32_t f[4] = {a[4 * t], a[4 * t + 1], a[4 * t + 2],
                           a[4 * t + 3]};
    wgmma_rs(acc, f, db + ((t * 16 * 128) >> 4), t > 0 || scale_d);
  }
}

// One [64 x HD] bf16 tile at (column col of the row, position pos, batch b)
// of a [B][S][heads * HD] tensor map, completing on bar.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col, int pos,
                                          int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    tma_load(dst + c * kChunkBytes, map, bar, col + 64 * c, pos, b);
}

// acc [64 x HD] of rows r (position row0 + r < seq), its first n_cols
// columns, into a bf16 [B][S][heads * hd] output at element offset base +
// position * stride.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           __nv_bfloat16* __restrict__ out,
                                           int64_t base, int64_t stride,
                                           int row0, int seq, const Frag& fr,
                                           int n_cols = HD) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row0 + fr.row_a + 8 * half;
    if (pos >= seq) continue;
    __nv_bfloat16* o = out + base + pos * stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (8 * j < n_cols)
        *reinterpret_cast<uint32_t*>(o + 8 * j + fr.cq) =
            bf16x2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

// n mbarriers of one arrival each at bars, bars + 8, ...
__device__ __forceinline__ void bar_init(uint32_t bars, int n = 3) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Whether no pair of q tile q0 and kv tile k0 is masked.
__device__ __forceinline__ bool tile_whole(int q0, int k0, int seq,
                                           int causal, int window) {
  return q0 + kTile <= seq && k0 + kTile <= seq &&
         (!causal || k0 + kTile - 1 <= q0) &&
         (window <= 0 || k0 > q0 + kTile - 1 - window);
}

// dS of a q-outer tile (launch 1) in bf16, in the A-register layout:
// register 2 j holds row a's pair of columns (8 j + cq, + 1), register
// 2 j + 1 row b's. sc and dp are the tile's S and dP accumulators, lse2
// and drow the thread's two rows' lse * log2(e) and D.
__device__ __forceinline__ void q_tile_ds(
    uint32_t (&ds)[kTile / 4], const float (&sc)[32], const float (&dp)[32],
    const float (&lse2)[2], const float (&drow)[2], int q0, int k0,
    bool whole, const Frag& fr, int seq, int causal, int window, float c2,
    float scale) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int half = u / 2, idx = 4 * j + u;
      const bool ok = whole || sees(q0 + fr.row_a + 8 * half,
                                    k0 + 8 * j + fr.cq + u % 2, seq,
                                    causal, window);
      const float p = ok ? ex2(fmaf(sc[idx], c2, -lse2[half])) : 0.0f;
      d[u] = p * (dp[idx] - drow[half]) * scale;
    }
    ds[2 * j] = bf16x2(d[0], d[1]);
    ds[2 * j + 1] = bf16x2(d[2], d[3]);
  }
}

// D = rowsum(dout * out) of the q tile's rows at position q0 (two threads
// a row over hd / 2 columns each, 16-byte loads from global memory) into
// vec[0 .. 63], by the 128 threads of one warpgroup (tid: the thread's
// index in it); when `write`, also into dsum for launch 2. T is bf16 or
// fp32 (hd / 2 a multiple of 8 or 4).
template <typename T>
__device__ __forceinline__ void tile_dsum(
    float* vec, const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dsum, int q0, int b, int h, int seq, int H, int hd,
    bool write, int tid) {
  constexpr int kPer = 16 / sizeof(T);
  const int r = tid / 2, part = tid % 2;
  const int pos = q0 + r;
  float d = 0.0f;
  if (pos < seq) {
    const int64_t off = ((static_cast<int64_t>(b) * seq + pos) * H + h) *
                            hd + part * (hd / 2);
#pragma unroll 4
    for (int c = 0; c < hd / 2; c += kPer) {
      const uint4 x = *reinterpret_cast<const uint4*>(dout + off + c);
      const uint4 y = *reinterpret_cast<const uint4*>(o + off + c);
      const T* xs = reinterpret_cast<const T*>(&x);
      const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        d = fmaf(to_float(xs[e]), to_float(ys[e]), d);
    }
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (part == 0) {
    vec[r] = d;
    if (write && pos < seq)
      dsum[(static_cast<int64_t>(b) * H + h) * seq + pos] = d;
  }
}

// Launch 1: dq and D. Block: (q tile, batch, head) with the q tiles
// heaviest first when causal; own tiles q and dout, the ring k and v.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dq, int seq, int H,
                       int Kv, int B, int causal, int window, float scale,
                       int n_tiles) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kVec);
  const uint32_t sQ = base, sDo = base + C::kTileBytes;
  const uint32_t full = base + C::kBar, own = full + 16;

  const int t_lin = blockIdx.x / (B * H);
  const int b = (blockIdx.x % (B * H)) / H, h = blockIdx.x % H;
  const int qt = causal ? n_tiles - 1 - t_lin : t_lin;
  const int kvh = h / (H / Kv);
  const int q0 = qt * kTile;
  const int2 span = kv_span(q0, min(q0 + kTile, seq) - 1, seq, causal,
                            window);
  const int t_begin = span.x / kTile;
  const int n_t = (span.y + kTile - 1) / kTile - t_begin;

  bar_init(full);
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * C::kTileBytes);
    load_tile<HD>(sQ, &qmap, own, h * HD, q0, b);
    load_tile<HD>(sDo, &dmap, own, h * HD, q0, b);
    mbar_expect_tx(full, 2 * C::kTileBytes);
    load_tile<HD>(base + C::kStage0, &kmap, full, kvh * HD, t_begin * kTile,
                  b);
    load_tile<HD>(base + C::kStage0 + C::kTileBytes, &vmap, full, kvh * HD,
                  t_begin * kTile, b);
  }
  // D of the tile's rows while the tiles arrive
  tile_dsum(vec, o, dout, dsum, q0, b, h, seq, H, HD, true, threadIdx.x);
  __syncthreads();
  const Frag fr;
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * seq;
  float lse2[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = fr.row_a + 8 * half, pos = q0 + r;
    lse2[half] = pos < seq ? lse[lrow + pos] * kLog2e : 0.0f;
    drow[half] = vec[r];
  }
  const float c2 = scale * kLog2e;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  mbar_wait(own, 0);
  for (int i = 0; i < n_t; ++i) {
    const int s = i & 1;
    const uint32_t sK = base + C::kStage0 + s * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    if (threadIdx.x == 0 && i + 1 < n_t) {     // the next stage's tiles
      const uint32_t nK = base + C::kStage0 + (s ^ 1) * 2 * C::kTileBytes;
      const int pos = (t_begin + i + 1) * kTile;
      mbar_expect_tx(full + 8 * (s ^ 1), 2 * C::kTileBytes);
      load_tile<HD>(nK, &kmap, full + 8 * (s ^ 1), kvh * HD, pos, b);
      load_tile<HD>(nK + C::kTileBytes, &vmap, full + 8 * (s ^ 1), kvh * HD,
                    pos, b);
    }
    mbar_wait(full + 8 * s, (i >> 1) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_ss<HD>(sc, sQ, sK);
    issue_ss<HD>(dp, sDo, sV);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(dp);
    const int k0 = (t_begin + i) * kTile;
    uint32_t ds[kTile / 4];
    q_tile_ds(ds, sc, dp, lse2, drow, q0, k0,
              tile_whole(q0, k0, seq, causal, window), fr, seq, causal,
              window, c2, scale);
    wgmma_fence();
    issue_rs<HD>(acc, ds, sK);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(ds);
    __syncthreads();                 // stage s is free for iteration i + 2
  }
  store_rows<HD>(acc, dq, static_cast<int64_t>(b) * seq * H * HD +
                              static_cast<int64_t>(h) * HD,
                 static_cast<int64_t>(H) * HD, q0, seq, fr);
}

// The kv side of a dk/dv block: its kv tile, (batch, kv head), and the
// iterations over (query head of the group, q tile) that its rows see.
// Block blk (blockIdx.x, or its quotient by the column blocks) runs kv tile
// blk / (B * Kv); kv tile 0 (seen by every q row when causal) comes first.
// Iteration i reads query head kvh * G + i / n_q at q tile qt_begin + i %
// n_q.
struct KvBlock {
  int b, kvh, G, H, seq, k0, qt_begin, n_q, causal, window;

  __device__ __forceinline__ KvBlock(int blk, int seq_, int H_, int Kv,
                                     int B, int causal_, int window_)
      : H(H_), seq(seq_), causal(causal_), window(window_) {
    const int kt = blk / (B * Kv);
    b = (blk % (B * Kv)) / Kv;
    kvh = blk % Kv;
    G = H / Kv;
    k0 = kt * kTile;
    const int2 span = q_span(k0, min(k0 + kTile, seq) - 1, seq, causal,
                             window);
    qt_begin = span.x / kTile;
    n_q = (span.y + kTile - 1) / kTile - qt_begin;
  }
  __device__ __forceinline__ int iterations() const { return G * n_q; }
  __device__ __forceinline__ int q0(int i) const {
    return (qt_begin + i % n_q) * kTile;
  }
  // the q-side vector entry t (0..127) of iteration i: lse * log2(e) of
  // position q0(i) + t for t < 64, D of position q0(i) + t - 64 above
  __device__ __forceinline__ float vec(const float* __restrict__ lse,
                                       const float* __restrict__ dsum,
                                       int i, int t) const {
    const int pos = q0(i) + t % kTile;
    if (pos >= seq) return 0.0f;
    const int64_t at =
        (static_cast<int64_t>(b) * H + kvh * G + i / n_q) * seq + pos;
    return t < kTile ? lse[at] * kLog2e : dsum[at];
  }
  // whether no pair of q tile q0_ and this kv tile is masked
  __device__ __forceinline__ bool whole(int q0_) const {
    return tile_whole(q0_, k0, seq, causal, window);
  }
  // iteration i's q and dout tiles into the ring stage at dst, on bar
  template <int HD>
  __device__ __forceinline__ void load_stage(int i, uint32_t dst,
                                             const CUtensorMap* qmap,
                                             const CUtensorMap* dmap,
                                             uint32_t bar) const {
    constexpr int kTileBytes = Cfg<HD>::kTileBytes;
    const int col = (kvh * G + i / n_q) * HD;
    mbar_expect_tx(bar, 2 * kTileBytes);
    load_tile<HD>(dst, qmap, bar, col, q0(i), b);
    load_tile<HD>(dst + kTileBytes, dmap, bar, col, q0(i), b);
  }
  // Column kernels (hd at run time): chunk m of the block's stream, its
  // iteration m / n_c's k, q, v and dout chunks at hd columns 64 (m % n_c),
  // into the ring stage at dst, on bar
  __device__ __forceinline__ void load_chunk(int m, int n_c, int hd,
                                             uint32_t dst,
                                             const CUtensorMap* qmap,
                                             const CUtensorMap* dmap,
                                             const CUtensorMap* kmap,
                                             const CUtensorMap* vmap,
                                             uint32_t bar) const {
    const int i = m / n_c, c = m % n_c;
    const int kcol = kvh * hd + 64 * c;
    const int qcol = (kvh * G + i / n_q) * hd + 64 * c;
    mbar_expect_tx(bar, 4 * kChunkBytes);
    tma_load(dst, kmap, bar, kcol, k0, b);
    tma_load(dst + kChunkBytes, qmap, bar, qcol, q0(i), b);
    tma_load(dst + 2 * kChunkBytes, vmap, bar, kcol, k0, b);
    tma_load(dst + 3 * kChunkBytes, dmap, bar, qcol, q0(i), b);
  }
  // and iteration i's q and dout columns [c0, c0 + NB) below hd into the
  // column tiles at q_dst and d_dst, on bar
  template <int NB>
  __device__ __forceinline__ void load_cols(int i, int hd, int c0,
                                            uint32_t q_dst, uint32_t d_dst,
                                            const CUtensorMap* qmap,
                                            const CUtensorMap* dmap,
                                            uint32_t bar) const {
    const int col = (kvh * G + i / n_q) * hd + c0;
    const int n = min(NB, hd - c0) / 64;
    mbar_expect_tx(bar, 2 * n * kChunkBytes);
    for (int j = 0; j < n; ++j) {
      tma_load(q_dst + j * kChunkBytes, qmap, bar, col + 64 * j, q0(i), b);
      tma_load(d_dst + j * kChunkBytes, dmap, bar, col + 64 * j, q0(i), b);
    }
  }
};

// P^T (ROLE 0) or dS^T (ROLE 1) of a kv-outer tile (launch 2) in bf16, in
// the A-register layout (as q_tile_ds); st and dpt are the tile's S^T and
// dP^T accumulators (ROLE 0 reads no dpt), sl and sd the q tile's lse *
// log2(e) and D in shared memory.
template <int ROLE>
__device__ __forceinline__ void kv_tile_a(
    uint32_t (&a)[kTile / 4], const float (&st)[32], const float (&dpt)[32],
    const float* sl, const float* sd, const KvBlock& kb, int q0, bool whole,
    const Frag& fr, float c2, float scale) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = 4 * j + u, col = 8 * j + fr.cq + u % 2;
      const bool ok = whole || sees(q0 + col, kb.k0 + fr.row_a + 8 * (u / 2),
                                    kb.seq, kb.causal, kb.window);
      const float p = ok ? ex2(fmaf(st[idx], c2, -sl[col])) : 0.0f;
      x[u] = ROLE == 0 ? p : p * (dpt[idx] - sd[col]) * scale;
    }
    a[2 * j] = bf16x2(x[0], x[1]);
    a[2 * j + 1] = bf16x2(x[2], x[3]);
  }
}

// The start of a dk/dv block: its barriers, then thread 0's TMA of its own
// k and v tiles and of ring stage 0, and threads 0..127's stage 0 lse and D.
template <int HD>
__device__ __forceinline__ void dkdv_start(
    const KvBlock& kb, uint32_t base, float* vec, const CUtensorMap* qmap,
    const CUtensorMap* dmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ lse, const float* __restrict__ dsum) {
  using C = Cfg<HD>;
  const uint32_t full = base + C::kBar, own = full + 16;
  bar_init(full);
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * C::kTileBytes);
    load_tile<HD>(base, kmap, own, kb.kvh * HD, kb.k0, kb.b);
    load_tile<HD>(base + C::kTileBytes, vmap, own, kb.kvh * HD, kb.k0, kb.b);
    kb.load_stage<HD>(0, base + C::kStage0, qmap, dmap, full);
  }
  if (threadIdx.x < kThreads) vec[threadIdx.x] = kb.vec(lse, dsum, 0,
                                                        threadIdx.x);
  __syncthreads();
  mbar_wait(own, 0);
}

// Launch 2 at hd 64 and 128: dk and dv. Block: (kv tile, batch, kv head)
// (KvBlock); own tiles k and v, the ring q and dout of each iteration.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap dmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int seq, int H,
                         int Kv, int B, int causal, int window, float scale) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kVec);
  const uint32_t sK = base, sV = base + C::kTileBytes;
  const uint32_t full = base + C::kBar;
  const KvBlock kb(blockIdx.x, seq, H, Kv, B, causal, window);
  const int n_it = kb.iterations();
  const Frag fr;
  const float c2 = scale * kLog2e;

  float ak[HD / 2], av[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) ak[i] = av[i] = 0.0f;
  dkdv_start<HD>(kb, base, vec, &qmap, &dmap, &kmap, &vmap, lse, dsum);
  for (int i = 0; i < n_it; ++i) {
    const int s = i & 1;
    const uint32_t sQ = base + C::kStage0 + s * 2 * C::kTileBytes;
    const uint32_t sDo = sQ + C::kTileBytes;
    float next = 0.0f;
    if (i + 1 < n_it) {
      if (threadIdx.x == 0)
        kb.load_stage<HD>(i + 1, base + C::kStage0 + (s ^ 1) * 2 *
                                     C::kTileBytes,
                          &qmap, &dmap, full + 8 * (s ^ 1));
      next = kb.vec(lse, dsum, i + 1, threadIdx.x);
    }
    mbar_wait(full + 8 * s, (i >> 1) & 1);
    float st[32], dpt[32];
    wgmma_fence();
    issue_ss<HD>(st, sK, sQ);
    issue_ss<HD>(dpt, sV, sDo);
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);
    const float* sl = vec + s * 2 * kTile;     // this stage's lse * log2(e)
    const float* sd = sl + kTile;              // and D
    const int q0 = kb.q0(i);
    const bool whole = kb.whole(q0);
    // P^T and dS^T in bf16, in the A-register layout (as in launch 1),
    // packed as they are made so the fp32 tiles die early
    uint32_t pf[kTile / 4], dsf[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float p[4], d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = 4 * j + u, col = 8 * j + fr.cq + u % 2;
        const bool ok = whole || sees(q0 + col, kb.k0 + fr.row_a +
                                      8 * (u / 2), seq, causal, window);
        p[u] = ok ? ex2(fmaf(st[idx], c2, -sl[col])) : 0.0f;
        d[u] = p[u] * (dpt[idx] - sd[col]) * scale;
      }
      pf[2 * j] = bf16x2(p[0], p[1]);
      pf[2 * j + 1] = bf16x2(p[2], p[3]);
      dsf[2 * j] = bf16x2(d[0], d[1]);
      dsf[2 * j + 1] = bf16x2(d[2], d[3]);
    }
    wgmma_fence();
    issue_rs<HD>(av, pf, sDo);
    issue_rs<HD>(ak, dsf, sQ);
    wgmma_commit();
    wgmma_wait<0>();
    pin(av);
    pin(ak);
    pin(pf);
    pin(dsf);
    if (i + 1 < n_it) vec[(s ^ 1) * 2 * kTile + threadIdx.x] = next;
    __syncthreads();                 // stage s is free for iteration i + 2
  }
  const int64_t kv_base = static_cast<int64_t>(kb.b) * seq * Kv * HD +
                          static_cast<int64_t>(kb.kvh) * HD;
  store_rows<HD>(ak, dk, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0, seq,
                 fr);
  store_rows<HD>(av, dv, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0, seq,
                 fr);
}

// Barrier 1 over both warpgroups of a flash_bwd_dkdv_wgmma_split block
// (each warpgroup reaches it from its own loop).
__device__ __forceinline__ void both_warpgroups() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One warpgroup's loop of flash_bwd_dkdv_wgmma_split over the block's
// iterations, summing into acc: ROLE 0 S^T = k q^T, P^T and dv += P^T
// dout; ROLE 1 S^T, dP^T = v dout^T, dS^T and dk += dS^T q. Warpgroup 0
// also keeps the ring: its thread 0 loads stage i + 1 by TMA, and its
// threads the next stage's lse and D into vec.
template <int HD, int ROLE>
__device__ __forceinline__ void dkdv_split_loop(
    float (&acc)[HD / 2], const KvBlock& kb, uint32_t base, float* vec,
    const CUtensorMap* qmap, const CUtensorMap* dmap,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float scale) {
  using C = Cfg<HD>;
  const uint32_t sK = base, sV = base + C::kTileBytes;
  const uint32_t full = base + C::kBar;
  const int tid = threadIdx.x % kThreads;
  const Frag fr;
  const float c2 = scale * kLog2e;
  const int n_it = kb.iterations();
  for (int i = 0; i < n_it; ++i) {
    const int s = i & 1;
    const uint32_t sQ = base + C::kStage0 + s * 2 * C::kTileBytes;
    const uint32_t sDo = sQ + C::kTileBytes;
    float next = 0.0f;
    if (ROLE == 0 && i + 1 < n_it) {
      if (tid == 0)
        kb.load_stage<HD>(i + 1, base + C::kStage0 + (s ^ 1) * 2 *
                                     C::kTileBytes,
                          qmap, dmap, full + 8 * (s ^ 1));
      next = kb.vec(lse, dsum, i + 1, tid);
    }
    mbar_wait(full + 8 * s, (i >> 1) & 1);
    const float* sl = vec + s * 2 * kTile;     // this stage's lse * log2(e)
    const float* sd = sl + kTile;              // and D
    const int q0 = kb.q0(i);
    const bool whole = kb.whole(q0);
    float st[32];
    // P^T (ROLE 0) or dS^T (ROLE 1) in bf16, in the A-register layout
    uint32_t a[kTile / 4];
    if constexpr (ROLE == 0) {
      wgmma_fence();
      issue_ss<HD>(st, sK, sQ);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      kv_tile_a<0>(a, st, st, sl, sd, kb, q0, whole, fr, c2, scale);
      wgmma_fence();
      issue_rs<HD>(acc, a, sDo);
    } else {
      float dpt[32];
      wgmma_fence();
      issue_ss<HD>(st, sK, sQ);
      issue_ss<HD>(dpt, sV, sDo);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      pin(dpt);
      kv_tile_a<1>(a, st, dpt, sl, sd, kb, q0, whole, fr, c2, scale);
      wgmma_fence();
      issue_rs<HD>(acc, a, sQ);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(a);
    if (ROLE == 0 && i + 1 < n_it) vec[(s ^ 1) * 2 * kTile + tid] = next;
    both_warpgroups();               // stage s is free for iteration i + 2
  }
}

// Launch 2 at hd 192 and 256: dk and dv, split between two warpgroups
// (dkdv_split_loop). Block: (kv tile, batch, kv head) as in
// flash_bwd_dkdv_wgmma, with its shared memory layout.
template <int HD>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkdv_wgmma_split(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap dmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int seq,
                               int H, int Kv, int B, int causal, int window,
                               float scale) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kVec);
  const KvBlock kb(blockIdx.x, seq, H, Kv, B, causal, window);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  dkdv_start<HD>(kb, base, vec, &qmap, &dmap, &kmap, &vmap, lse, dsum);
  const int64_t kv_base = static_cast<int64_t>(kb.b) * seq * Kv * HD +
                          static_cast<int64_t>(kb.kvh) * HD;
  const Frag fr;
  if (threadIdx.x < kThreads) {
    dkdv_split_loop<HD, 0>(acc, kb, base, vec, &qmap, &dmap, lse, dsum,
                           scale);
    store_rows<HD>(acc, dv, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0,
                   seq, fr);
  } else {
    dkdv_split_loop<HD, 1>(acc, kb, base, vec, &qmap, &dmap, lse, dsum,
                           scale);
    store_rows<HD>(acc, dk, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0,
                   seq, fr);
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64 and 128: two consumer warpgroups a block over one ring
// ---------------------------------------------------------------------------

// The two-warpgroup kernels' shared memory, from a 1024-byte aligned base:
// the block's own tiles (dk/dv: k and v; dq: q and dout of each
// warpgroup), a ring of kStages stages of two tiles of the other side
// (dk/dv: q and dout; dq: k and v), the q-side vectors (dk/dv: [kStages][2]
// [kTile] fp32, a stage's lse * log2(e) and D; dq: [2][kTile], each
// warpgroup's D), then the mbarriers full[kStages], empty[kStages] and own
// (dq: one a warpgroup). At the end of dk/dv the ring holds the two
// warpgroups' exchanged partial sums, then the block's sums that block 1
// of a cluster hands to block 0: [4][HD / 2][kThreads] fp32.
template <int HD, bool DQ>
struct PipeCfg {
  static constexpr int kTileBytes = HD / 64 * kChunkBytes;
  static constexpr int kOwn = (DQ ? 4 : 2) * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  // dq runs at hd 128 only (flash_bwd_dq_wgmma keeps 64)
  static constexpr int kStages = !DQ && HD == 64 ? 8 : 4;
  static constexpr int kVec = kOwn + kStages * kStageBytes;
  static constexpr int kVecFloats = (DQ ? 1 : kStages) * 2 * kTile;
  static constexpr int kBar = kVec + 4 * kVecFloats;
  static constexpr int kSmem = kBar + 8 * (2 * kStages + 2) + 1024;
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
  static_assert(kStages >= 2, "a stage is refilled once both its readers "
                              "are past it");
  static_assert(DQ || 4 * HD / 2 * kThreads * 4 <= kStages * kStageBytes,
                "the partial sums' exchanges fit the ring");
};

// Launch 2 at hd 64 and 128 with G > 1: dk and dv. Cluster: (kv tile,
// batch, kv head) (KvBlock) on one or two blocks (dkdv_cluster), two
// warpgroups a block: the block's warpgroup w takes the block's iterations
// i = w, w + 2, w + 4, ... into its own dk and dv; at the end warpgroup 1
// hands its dv and warpgroup 0 its dk over through shared memory, and with
// two blocks block 1 its sums to block 0; dv and dk are stored by block 0's
// warpgroups 0 and 1. The block's iteration i's q and dout tiles and its
// lse * log2(e) and D come into ring stage i % kStages. Per iteration a
// warpgroup issues S^T and dP^T as two product groups, waits for S^T alone
// (wgmma_wait<1>: iteration i - 2's dv and dk products are then done too,
// so it frees their stage), forms P^T while dP^T runs, issues dv += P^T
// dout, waits for dP^T, forms dS^T while dv's product runs, and issues dk
// += dS^T q, which stays in flight into the next iteration.
template <int HD>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkdv_wgmma_pipe(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap dmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq, int H,
                              int Kv, int B, int causal, int window,
                              float scale) {
  using C = PipeCfg<HD, false>;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* vec = reinterpret_cast<float*>(smem + C::kVec);
  const uint32_t sK = base, sV = base + C::kTileBytes, ring = base + C::kOwn;
  const uint32_t full = base + C::kBar, empty = full + 8 * kS;
  const uint32_t own = empty + 8 * kS;
  // A cluster of nc blocks (1 or 2, set by the launch) shares the kv tile:
  // its block of rank r takes the kv tile's pairs of iterations 2p, 2p + 1
  // with p % nc == r, iteration 2p + w to its warpgroup w. Below i counts
  // the block's own iterations; at(i) is the kv tile's.
  const int nc = cluster_size(), rank = cluster_rank();
  const KvBlock kb(blockIdx.x / nc, seq, H, Kv, B, causal, window);
  const int n_all = kb.iterations(), n_pairs = (n_all + 1) / 2;
  const int n_it =
      n_pairs > rank
          ? 2 * ((n_pairs - rank + nc - 1) / nc) -
                ((n_all & 1) && (n_pairs - 1) % nc == rank ? 1 : 0)
          : 0;
  const auto at = [&](int i) { return 2 * (nc * (i / 2) + rank) + i % 2; };
  const int lane = threadIdx.x % 32;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it as uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  const Frag fr;
  const float c2 = scale * kLog2e;

  // iteration f's lse * log2(e) and D (entry, this thread's, read from
  // global memory ahead) and its q and dout tiles into stage f % kS, by the
  // 128 threads of one warpgroup; each warp arrives on the stage's full
  // barrier once its lanes' entries are written, warp 0's lane 0 with the
  // tiles' bytes
  const auto fill = [&](int f, float entry) {
    const int s = f % kS;
    vec[s * 2 * kTile + tid] = entry;
    __syncwarp();
    if (tid == 0)
      kb.load_stage<HD>(at(f), ring + s * C::kStageBytes, &qmap, &dmap,
                        full + 8 * s);
    else if (lane == 0)
      mbar_arrive(full + 8 * s);
  };
  // this warpgroup's reads of iteration u's stage are done: each warp
  // releases it; once all four have, the warpgroup fills it with
  // iteration u + kS
  const auto release = [&](int u, float entry) {
    const int s = u % kS;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (u + kS < n_it) {
      mbar_wait(empty + 8 * s, (u / kS) & 1);
      fill(u + kS, entry);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 4);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * C::kTileBytes);
    load_tile<HD>(sK, &kmap, own, kb.kvh * HD, kb.k0, kb.b);
    load_tile<HD>(sV, &vmap, own, kb.kvh * HD, kb.k0, kb.b);
  }
  for (int f = wg; f < min(kS, n_it); f += 2)
    fill(f, kb.vec(lse, dsum, at(f), tid));

  // The sums start with the warpgroup's first products (scale_d 0): a
  // zeroing of registers that a product in flight across the loop's back
  // edge accumulates into made ptxas serialize every wgmma (C7515).
  float ak[HD / 2], av[HD / 2];
  uint32_t pf[kTile / 4], dsf[kTile / 4];
  mbar_wait(own, 0);
  for (int i = wg; i < n_it; i += 2) {
    const int s = i % kS;
    const uint32_t sQ = ring + s * C::kStageBytes;
    const uint32_t sDo = sQ + C::kTileBytes;
    // the entry this iteration's refill writes, its load under the products
    const float entry = i >= 2 && i - 2 + kS < n_it
                            ? kb.vec(lse, dsum, at(i - 2 + kS), tid) : 0.0f;
    mbar_wait(full + 8 * s, (i / kS) & 1);
    float st[32], dpt[32];
    wgmma_fence();
    issue_ss<HD>(st, sK, sQ);
    wgmma_commit();
    issue_ss<HD>(dpt, sV, sDo);
    wgmma_commit();
    wgmma_wait<1>();                 // S^T, and iteration i - 2's products
    pin(st);
    if (i >= 2) release(i - 2, entry);
    const float* sl = vec + s * 2 * kTile;     // this stage's lse * log2(e)
    const float* sd = sl + kTile;              // and D
    const int q0 = kb.q0(at(i));
    // P^T over S^T in fp32, in place (as flash_bwd_dkdv_wgmma forms it; a
    // tile that no mask cuts skips the mask's tests), then in bf16 in the
    // A-register layout
    if (kb.whole(q0)) {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx)
        st[idx] = ex2(fmaf(st[idx], c2, -sl[8 * (idx / 4) + fr.cq + idx % 2]));
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int col = 8 * (idx / 4) + fr.cq + idx % 2;
        st[idx] = sees(q0 + col, kb.k0 + fr.row_a + 8 * ((idx % 4) / 2),
                       seq, causal, window)
                      ? ex2(fmaf(st[idx], c2, -sl[col])) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      pf[2 * j] = bf16x2(st[4 * j], st[4 * j + 1]);
      pf[2 * j + 1] = bf16x2(st[4 * j + 2], st[4 * j + 3]);
    }
    wgmma_fence();
    issue_rs<HD>(av, pf, sDo, i >= 2);
    wgmma_commit();
    wgmma_wait<1>();                 // dP^T
    pin(dpt);
    // dS^T, while dv's product runs
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = 4 * j + u, col = 8 * j + fr.cq + u % 2;
        d[u] = st[idx] * (dpt[idx] - sd[col]) * scale;
      }
      dsf[2 * j] = bf16x2(d[0], d[1]);
      dsf[2 * j + 1] = bf16x2(d[2], d[3]);
    }
    wgmma_fence();
    issue_rs<HD>(ak, dsf, sQ, i >= 2);
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(ak);
  pin(av);
  // a warpgroup with no iteration (n_it 1 or 0) adds zeros
  const bool any = wg < n_it;

  // the partials' exchange: every stage has been read, so the ring is free
  __syncthreads();
  float* xs = reinterpret_cast<float*>(smem + C::kOwn);
  float* mine = xs + wg * (HD / 2) * kThreads;
  const float* theirs = xs + (wg ^ 1) * (HD / 2) * kThreads;
  if (wg == 0) {
#pragma unroll
    for (int r = 0; r < HD / 2; ++r)
      mine[r * kThreads + tid] = any ? ak[r] : 0.0f;
  } else {
#pragma unroll
    for (int r = 0; r < HD / 2; ++r)
      mine[r * kThreads + tid] = any ? av[r] : 0.0f;
  }
  __syncthreads();
  // the block's sums: dv = dv_0 + dv_1 in warpgroup 0, dk = dk_0 + dk_1 in
  // warpgroup 1
  if (wg == 0) {
#pragma unroll
    for (int r = 0; r < HD / 2; ++r)
      av[r] = (any ? av[r] : 0.0f) + theirs[r * kThreads + tid];
  } else {
#pragma unroll
    for (int r = 0; r < HD / 2; ++r)
      ak[r] = theirs[r * kThreads + tid] + (any ? ak[r] : 0.0f);
  }
  if (nc > 1) {
    // block 1's sums cross the cluster to block 0, which adds them to its
    // own: dv = (block 0's) + (block 1's), dk likewise
    float* out = xs + (2 + wg) * (HD / 2) * kThreads;
    if (rank == 1) {
      if (wg == 0) {
#pragma unroll
        for (int r = 0; r < HD / 2; ++r) out[r * kThreads + tid] = av[r];
      } else {
#pragma unroll
        for (int r = 0; r < HD / 2; ++r) out[r * kThreads + tid] = ak[r];
      }
    }
    cluster_sync();
    if (rank == 0) {
      const uint32_t addr = smem_u32(out + tid);
      if (wg == 0) {
#pragma unroll
        for (int r = 0; r < HD / 2; ++r)
          av[r] = av[r] + ld_cluster(addr + 4 * r * kThreads, 1);
      } else {
#pragma unroll
        for (int r = 0; r < HD / 2; ++r)
          ak[r] = ak[r] + ld_cluster(addr + 4 * r * kThreads, 1);
      }
    }
  }
  if (rank == 0) {
    const int64_t kv_base = static_cast<int64_t>(kb.b) * seq * Kv * HD +
                            static_cast<int64_t>(kb.kvh) * HD;
    if (wg == 0)
      store_rows<HD>(av, dv, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0,
                     seq, fr);
    else
      store_rows<HD>(ak, dk, kv_base, static_cast<int64_t>(Kv) * HD, kb.k0,
                     seq, fr);
  }
  // block 1's shared memory stays until block 0 has read it
  if (nc > 1) cluster_sync();
}

// The kv tiles [x, y) that the rows of q tile qt see.
__device__ __forceinline__ int2 kv_tiles(int qt, int seq, int causal,
                                         int window) {
  const int q0 = qt * kTile;
  const int2 span = kv_span(q0, min(q0 + kTile, seq) - 1, seq, causal,
                            window);
  return make_int2(span.x / kTile, (span.y + kTile - 1) / kTile);
}

// Launch 1 at hd 128: dq and D. The (q tile, query head) units of a
// (batch, kv head), in q-tile-major order (unit u: q tile u / G, query head
// u % G of the group), are taken two a block: block pair m holds units 2m
// and 2m + 1, one a warpgroup (the second missing when the count is odd),
// so its two q tiles are one tile or two neighbours. The pair's kv tiles
// (the union of its units' spans: the lower unit's start to the upper
// unit's end) stream once through one ring of k and v stages that both
// warpgroups read; a warpgroup computes on its own unit's steps and passes
// the others (waits for the stage, releases it). Per step it issues S and
// dP as two product groups, waits for S (the previous step's dS k product
// is then done too, so it frees that stage), forms P while dP runs, waits
// for dP, forms dS and issues dq += dS k, which stays in flight into the
// next step. Pairs come heaviest first when causal. Thread 0 fills a stage
// once both warpgroups have released it.
template <int HD>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dq_wgmma_pipe(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dq, int seq, int H,
                            int Kv, int B, int causal, int window,
                            float scale, int n_tiles) {
  using C = PipeCfg<HD, true>;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int lane = threadIdx.x % 32;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  float* vec = reinterpret_cast<float*>(smem + C::kVec) + wg * kTile;
  const uint32_t sQ = base + wg * 2 * C::kTileBytes;
  const uint32_t sDo = sQ + C::kTileBytes, ring = base + C::kOwn;
  const uint32_t full = base + C::kBar, empty = full + 8 * kS;
  const uint32_t own = empty + 8 * kS + 8 * wg;

  const int G = H / Kv;
  const int n_units = n_tiles * G;
  const int n_pairs = (n_units + 1) / 2;
  const int m_lin = blockIdx.x / (B * Kv);
  const int b = (blockIdx.x % (B * Kv)) / Kv, kvh = blockIdx.x % Kv;
  const int m = causal ? n_pairs - 1 - m_lin : m_lin;
  const int unit = 2 * m + wg;
  const bool has = unit < n_units;
  const int qt = (has ? unit : 2 * m) / G;
  const int h = kvh * G + (has ? unit : 2 * m) % G;
  const int q0 = qt * kTile;
  // the pair's kv tiles [lo, lo + n_steps), this warpgroup's [beg, end) of
  // them (none for a missing unit)
  const int lo = kv_tiles(2 * m / G, seq, causal, window).x;
  const int n_steps =
      kv_tiles(min(2 * m + 1, n_units - 1) / G, seq, causal, window).y - lo;
  const int2 mine = kv_tiles(qt, seq, causal, window);
  const int beg = has ? mine.x - lo : n_steps;
  const int end = has ? mine.y - lo : n_steps;

  // step t's k and v tiles into stage t % kS, by one thread
  const auto fill = [&](int t) {
    const int s = t % kS;
    const uint32_t dst = ring + s * C::kStageBytes;
    mbar_expect_tx(full + 8 * s, 2 * C::kTileBytes);
    load_tile<HD>(dst, &kmap, full + 8 * s, kvh * HD, (lo + t) * kTile, b);
    load_tile<HD>(dst + C::kTileBytes, &vmap, full + 8 * s, kvh * HD,
                  (lo + t) * kTile, b);
  };
  // this warpgroup's reads of step t's stage are done: each warp releases
  // it; warpgroup 0 waits until both warpgroups have, then its thread 0
  // fills it with step t + kS
  const auto release = [&](int t) {
    const int s = t % kS;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (wg == 0 && t + kS < n_steps) {
      mbar_wait(empty + 8 * s, (t / kS) & 1);
      if (tid == 0) fill(t + kS);
    }
  };
  const auto pass = [&](int t) {
    mbar_wait(full + 8 * (t % kS), (t / kS) & 1);
    release(t);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(empty + 8 * kS, 1);
    mbar_init(empty + 8 * kS + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < min(kS, n_steps); ++t) fill(t);
  if (has) {
    if (tid == 0) {
      mbar_expect_tx(own, 2 * C::kTileBytes);
      load_tile<HD>(sQ, &qmap, own, h * HD, q0, b);
      load_tile<HD>(sDo, &dmap, own, h * HD, q0, b);
    }
    // D of the unit's rows while the tiles arrive
    tile_dsum(vec, o, dout, dsum, q0, b, h, seq, H, HD, true, tid);
  }
  __syncthreads();
  const Frag fr;
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * seq;
  float lse2[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = fr.row_a + 8 * half, pos = q0 + r;
    lse2[half] = pos < seq ? lse[lrow + pos] * kLog2e : 0.0f;
    drow[half] = vec[r];
  }
  const float c2 = scale * kLog2e;

  float acc[HD / 2];                   // from its first product (scale_d 0)
  uint32_t ds[kTile / 4];
  for (int t = 0; t < beg; ++t) pass(t);
  if (has) mbar_wait(own, 0);
  for (int t = beg; t < end; ++t) {
    const int s = t % kS;
    const uint32_t sK = ring + s * C::kStageBytes;
    const uint32_t sV = sK + C::kTileBytes;
    mbar_wait(full + 8 * s, (t / kS) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    issue_ss<HD>(sc, sQ, sK);
    wgmma_commit();
    issue_ss<HD>(dp, sDo, sV);
    wgmma_commit();
    wgmma_wait<1>();                 // S, and the previous step's dS k
    pin(sc);
    if (t > beg) release(t - 1);
    const int k0 = (lo + t) * kTile;
    // P over S in fp32, in place (as q_tile_ds forms it), while dP runs
    if (tile_whole(q0, k0, seq, causal, window)) {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx)
        sc[idx] = ex2(fmaf(sc[idx], c2, -lse2[(idx % 4) / 2]));
    } else {
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int half = (idx % 4) / 2;
        sc[idx] = sees(q0 + fr.row_a + 8 * half,
                       k0 + 8 * (idx / 4) + fr.cq + idx % 2, seq, causal,
                       window)
                      ? ex2(fmaf(sc[idx], c2, -lse2[half])) : 0.0f;
      }
    }
    wgmma_wait<0>();                 // dP
    pin(dp);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        d[u] = sc[4 * j + u] * (dp[4 * j + u] - drow[u / 2]) * scale;
      ds[2 * j] = bf16x2(d[0], d[1]);
      ds[2 * j + 1] = bf16x2(d[2], d[3]);
    }
    wgmma_fence();
    issue_rs<HD>(acc, ds, sK, t > beg);
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin(acc);
  if (end > beg) release(end - 1);
  for (int t = end; t < n_steps; ++t) pass(t);
  if (has)
    store_rows<HD>(acc, dq, static_cast<int64_t>(b) * seq * H * HD +
                                static_cast<int64_t>(h) * HD,
                   static_cast<int64_t>(H) * HD, q0, seq, fr);
}

// ---------------------------------------------------------------------------
// bf16 above hd 256: tensor cores in column blocks
// ---------------------------------------------------------------------------

// The column kernels' shared memory, from a 1024-byte aligned base: a ring
// of kStages stages of four 64-column chunks [64 rows][128 bytes] each
// (dq: q, dout, k, v; dk/dv: k, q, v, dout), kColTiles column tiles
// [NB / 64][64][128 bytes] (dq: k's NB columns of the kv tile; dk/dv: q's
// and dout's of the q tile), the q-side vectors [2][2][kTile] fp32, then
// kStages + 1 mbarriers (full[kStages], cols).
template <int NB, int kColTiles, int kStages>
struct ColsCfg {
  static constexpr int kStage = 4 * kChunkBytes;
  static constexpr int kColTile = NB / 64 * kChunkBytes;
  static constexpr int kColBase = kStages * kStage;
  static constexpr int kVec = kColBase + kColTiles * kColTile;
  static constexpr int kBar = kVec + 2 * 2 * kTile * 4;
  static constexpr int kSmem = kBar + 8 * (kStages + 1) + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
};
// dq: two stages, so two blocks (97 KB each at NB 256) share an SM and
// one's softmax overlaps the other's products (four stages, one block an
// SM, ran no faster on the H100); dk/dv (256 threads of up to 234
// registers, one block an SM): as many stages as shared memory holds
constexpr int kDqColStages = 2;
template <int NB>
constexpr int kDkdvColStages =
    (kMaxSmem - 2048 - 2 * (NB / 64) * kChunkBytes) / (4 * kChunkBytes);
template <int NB>
using DqCols = ColsCfg<NB, 1, kDqColStages>;
template <int NB>
using DkdvCols = ColsCfg<NB, 2, kDkdvColStages<NB>>;

// d[64 x 64] (+)= A B^T over one 64-column chunk, A and B in shared memory
// (K-major); `first` starts the sum.
__device__ __forceinline__ void issue_chunk(float (&d)[32], uint32_t a,
                                            uint32_t b, bool first) {
  const uint64_t da = k_major(a), db = k_major(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, da + 2 * kk, db + 2 * kk, !first || kk > 0);
}

// Launch 1 above hd 256: dq and D. Block: (column block, head, batch, q
// tile), q tiles heaviest first when causal; it owns dq's columns [c0, c0
// + NB). Per kv tile it sums S = sum_c q_c k_c^T and dP = sum_c dout_c
// v_c^T over the hd / 64 chunks c, each stage of the ring holding one
// chunk of q, dout, k and v (thread 0 refills a stage once every warp has
// passed the barrier after its products), then adds dS k[:, c0 : c0 + NB]
// from the column tile. Every block computes D over the full width for its
// rows; column block 0 writes it for launch 2.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_cols(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dq, int seq, int H,
                            int Kv, int B, int hd, int causal, int window,
                            float scale, int n_tiles, int n_cb) {
  using C = DqCols<NB>;
  constexpr int K = kDqColStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kVec);
  const uint32_t sK = base + C::kColBase;
  const uint32_t full = base + C::kBar, cols = full + 8 * K;

  const int cb = blockIdx.x % n_cb;
  const int h = blockIdx.x / n_cb % H;
  const int b = blockIdx.x / n_cb / H % B;
  const int t_lin = blockIdx.x / n_cb / H / B;
  const int qt = causal ? n_tiles - 1 - t_lin : t_lin;
  const int kvh = h / (H / Kv);
  const int q0 = qt * kTile, c0 = cb * NB;
  const int2 span = kv_span(q0, min(q0 + kTile, seq) - 1, seq, causal,
                            window);
  const int t_begin = span.x / kTile;
  const int n_t = (span.y + kTile - 1) / kTile - t_begin;
  const int n_c = hd / 64, n_chunks = n_t * n_c;

  // chunk m of the stream (kv tile t_begin + m / n_c, columns 64 (m % n_c))
  auto load_chunk = [&](int m) {
    const int c = m % n_c, k0 = (t_begin + m / n_c) * kTile;
    const uint32_t st = base + (m % K) * C::kStage, bar = full + 8 * (m % K);
    mbar_expect_tx(bar, C::kStage);
    tma_load(st, &qmap, bar, h * hd + 64 * c, q0, b);
    tma_load(st + kChunkBytes, &dmap, bar, h * hd + 64 * c, q0, b);
    tma_load(st + 2 * kChunkBytes, &kmap, bar, kvh * hd + 64 * c, k0, b);
    tma_load(st + 3 * kChunkBytes, &vmap, bar, kvh * hd + 64 * c, k0, b);
  };
  // kv tile i's k columns [c0, c0 + NB) below hd
  auto load_cols = [&](int i) {
    const int k0 = (t_begin + i) * kTile, n = min(NB, hd - c0) / 64;
    mbar_expect_tx(cols, n * kChunkBytes);
    for (int j = 0; j < n; ++j)
      tma_load(sK + j * kChunkBytes, &kmap, cols, kvh * hd + c0 + 64 * j, k0,
               b);
  };

  bar_init(full, K + 1);
  if (threadIdx.x == 0) {
    for (int m = 0; m < min(K, n_chunks); ++m) load_chunk(m);
    load_cols(0);
  }
  tile_dsum(vec, o, dout, dsum, q0, b, h, seq, H, hd, cb == 0,
            threadIdx.x);
  __syncthreads();
  const Frag fr;
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * seq;
  float lse2[2], drow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = fr.row_a + 8 * half, pos = q0 + r;
    lse2[half] = pos < seq ? lse[lrow + pos] * kLog2e : 0.0f;
    drow[half] = vec[r];
  }
  const float c2 = scale * kLog2e;

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < n_t; ++i) {
    float sc[32], dp[32];
    for (int c = 0; c < n_c; ++c) {
      const int n = i * n_c + c;
      const uint32_t st = base + (n % K) * C::kStage;
      mbar_wait(full + 8 * (n % K), (n / K) & 1);
      wgmma_fence();
      issue_chunk(sc, st, st + 2 * kChunkBytes, c == 0);
      issue_chunk(dp, st + kChunkBytes, st + 3 * kChunkBytes, c == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0) {
        __syncthreads();               // chunk n - 1's stage is read
        if (threadIdx.x == 0 && n - 1 + K < n_chunks) load_chunk(n - 1 + K);
      }
    }
    wgmma_wait<0>();
    pin(sc);
    pin(dp);
    __syncthreads();                   // the tile's last stage is read
    const int last = (i + 1) * n_c - 1;
    if (threadIdx.x == 0 && last + K < n_chunks) load_chunk(last + K);
    const int k0 = (t_begin + i) * kTile;
    uint32_t ds[kTile / 4];
    q_tile_ds(ds, sc, dp, lse2, drow, q0, k0,
              tile_whole(q0, k0, seq, causal, window), fr, seq, causal,
              window, c2, scale);
    mbar_wait(cols, i & 1);
    wgmma_fence();
    issue_rs<NB>(acc, ds, sK);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(ds);
    __syncthreads();                   // the k columns are read
    if (threadIdx.x == 0 && i + 1 < n_t) load_cols(i + 1);
  }
  store_rows<NB>(acc, dq, static_cast<int64_t>(b) * seq * H * hd +
                              static_cast<int64_t>(h) * hd + c0,
                 static_cast<int64_t>(H) * hd, q0, seq, fr, hd - c0);
}

// One warpgroup's loop of flash_bwd_dkdv_wgmma_cols, summing its NB
// columns into acc: ROLE 0 S^T = sum_c k_c q_c^T, P^T and dv += P^T
// dout[:, c0 : c0 + NB]; ROLE 1 S^T, dP^T = sum_c v_c dout_c^T, dS^T and
// dk += dS^T q[:, c0 : c0 + NB]. Warpgroup 0 also keeps the ring: its
// thread 0 refills a stage once both warpgroups have passed the barrier
// after its products, and loads the next iteration's column tiles; its
// threads the next iteration's lse and D into vec.
template <int NB, int ROLE>
__device__ __forceinline__ void dkdv_cols_loop(
    float (&acc)[NB / 2], const KvBlock& kb, int hd, int c0, uint32_t base,
    float* vec, const CUtensorMap* qmap, const CUtensorMap* dmap,
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float scale) {
  using C = DkdvCols<NB>;
  constexpr int K = kDkdvColStages<NB>;
  const uint32_t sQ = base + C::kColBase, sDo = sQ + C::kColTile;
  const uint32_t full = base + C::kBar, cols = full + 8 * K;
  const int tid = threadIdx.x % kThreads;
  const Frag fr;
  const float c2 = scale * kLog2e;
  const int n_c = hd / 64, n_it = kb.iterations(), n_chunks = n_it * n_c;
  for (int i = 0; i < n_it; ++i) {
    const float next = ROLE == 0 && i + 1 < n_it
                           ? kb.vec(lse, dsum, i + 1, tid) : 0.0f;
    float st[32], dpt[32];
    for (int c = 0; c < n_c; ++c) {
      const int n = i * n_c + c;
      const uint32_t stg = base + (n % K) * C::kStage;
      mbar_wait(full + 8 * (n % K), (n / K) & 1);
      wgmma_fence();
      issue_chunk(st, stg, stg + kChunkBytes, c == 0);
      if constexpr (ROLE == 1)
        issue_chunk(dpt, stg + 2 * kChunkBytes, stg + 3 * kChunkBytes,
                    c == 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0) {
        both_warpgroups();             // chunk n - 1's stage is read
        if (ROLE == 0 && tid == 0 && n - 1 + K < n_chunks)
          kb.load_chunk(n - 1 + K, n_c, hd, base + ((n - 1) % K) * C::kStage,
                        qmap, dmap, kmap, vmap, full + 8 * ((n - 1) % K));
      }
    }
    wgmma_wait<0>();
    pin(st);
    if constexpr (ROLE == 1) pin(dpt);
    both_warpgroups();                 // the iteration's last stage is read
    const int last = (i + 1) * n_c - 1;
    if (ROLE == 0 && tid == 0 && last + K < n_chunks)
      kb.load_chunk(last + K, n_c, hd, base + (last % K) * C::kStage, qmap,
                    dmap, kmap, vmap, full + 8 * (last % K));
    const float* sl = vec + (i & 1) * 2 * kTile;   // lse * log2(e)
    const float* sd = sl + kTile;                  // and D
    const int q0 = kb.q0(i);
    uint32_t a[kTile / 4];
    kv_tile_a<ROLE>(a, st, ROLE == 0 ? st : dpt, sl, sd, kb, q0,
                    kb.whole(q0), fr, c2, scale);
    mbar_wait(cols, i & 1);
    wgmma_fence();
    issue_rs<NB>(acc, a, ROLE == 0 ? sDo : sQ);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(a);
    if (ROLE == 0 && i + 1 < n_it) vec[((i + 1) & 1) * 2 * kTile + tid] = next;
    both_warpgroups();                 // the column tiles are read
    if (ROLE == 0 && tid == 0 && i + 1 < n_it)
      kb.load_cols<NB>(i + 1, hd, c0, sQ, sDo, qmap, dmap, cols);
  }
}

// Launch 2 above hd 256: dk and dv. Block: (column block, kv head, batch,
// kv tile) as KvBlock, two warpgroups (dkdv_cols_loop) over one ring of k,
// q, v and dout chunks; it owns dk's and dv's columns [c0, c0 + NB).
template <int NB>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkdv_wgmma_cols(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap dmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq, int H,
                              int Kv, int B, int hd, int causal, int window,
                              float scale, int n_cb) {
  using C = DkdvCols<NB>;
  constexpr int K = kDkdvColStages<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vec = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kVec);
  const uint32_t full = base + C::kBar;
  const int c0 = blockIdx.x % n_cb * NB;
  const KvBlock kb(blockIdx.x / n_cb, seq, H, Kv, B, causal, window);
  const int n_c = hd / 64, n_chunks = kb.iterations() * n_c;

  bar_init(full, K + 1);
  if (threadIdx.x == 0) {
    for (int m = 0; m < min(K, n_chunks); ++m)
      kb.load_chunk(m, n_c, hd, base + m * C::kStage, &qmap, &dmap, &kmap,
                    &vmap, full + 8 * m);
    kb.load_cols<NB>(0, hd, c0, base + C::kColBase,
                     base + C::kColBase + C::kColTile, &qmap, &dmap,
                     full + 8 * K);
  }
  if (threadIdx.x < kThreads)
    vec[threadIdx.x] = kb.vec(lse, dsum, 0, threadIdx.x);
  __syncthreads();

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.0f;
  const int64_t kv_base = static_cast<int64_t>(kb.b) * seq * Kv * hd +
                          static_cast<int64_t>(kb.kvh) * hd + c0;
  const int64_t stride = static_cast<int64_t>(Kv) * hd;
  const Frag fr;
  // the warpgroup, broadcast from lane 0 so that ptxas sees the role branch
  // as uniform (on a branch it takes for divergent, it serializes the
  // loops' wgmma, which stay in flight across the ring's barriers)
  if (__shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0) == 0) {
    dkdv_cols_loop<NB, 0>(acc, kb, hd, c0, base, vec, &qmap, &dmap, &kmap,
                          &vmap, lse, dsum, scale);
    store_rows<NB>(acc, dv, kv_base, stride, kb.k0, seq, fr, hd - c0);
  } else {
    dkdv_cols_loop<NB, 1>(acc, kb, hd, c0, base, vec, &qmap, &dmap, &kmap,
                          &vmap, lse, dsum, scale);
    store_rows<NB>(acc, dk, kv_base, stride, kb.k0, seq, fr, hd - c0);
  }
}

struct Maps {
  CUtensorMap q, d, k, v;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int seq, int H, int Kv, int hd) {
  int err = tensor_map_128b(&m->q, q, B, seq, H, hd);
  if (err == 0) err = tensor_map_128b(&m->d, dout, B, seq, H, hd);
  if (err == 0) err = tensor_map_128b(&m->k, k, B, seq, Kv, hd);
  if (err == 0) err = tensor_map_128b(&m->v, v, B, seq, Kv, hd);
  return err;
}

template <int HD>
int launch_dq_hd(const Maps& m, const void* o, const void* dout,
                 const float* lse, float* dsum, void* dq, int B, int seq,
                 int H, int Kv, int causal, int window, float scale,
                 cudaStream_t st) {
  using C = Cfg<HD>;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int64_t blocks = n_tiles * H * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma<HD><<<static_cast<unsigned>(blocks), kThreads, C::kSmem,
                           st>>>(
      m.q, m.d, m.k, m.v, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      static_cast<__nv_bfloat16*>(dq), seq, H, Kv, B, causal, window, scale,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// hd 64 and 128 on flash_bwd_dkdv_wgmma, 192 and 256 on its two-warpgroup
// split
template <int HD>
int launch_dkdv_hd(const Maps& m, const float* lse, const float* dsum,
                   void* dk, void* dv, int B, int seq, int H, int Kv,
                   int causal, int window, float scale, cudaStream_t st) {
  using C = Cfg<HD>;
  constexpr bool kSplit = HD > 128;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int64_t blocks = n_tiles * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&flash_bwd_dkdv_wgmma<64>) kernel;
  if constexpr (kSplit)
    kernel = flash_bwd_dkdv_wgmma_split<HD>;
  else
    kernel = flash_bwd_dkdv_wgmma<HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kSplit ? 2 * kThreads : kThreads,
           C::kSmem, st>>>(
      m.q, m.d, m.k, m.v, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq, H, Kv, B, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The two-warpgroup kernels: dq over pairs of (q tile, query head) units
// (hd 128), dk/dv over kv tiles (hd 64 and 128, G > 1)
template <int HD>
int launch_dq_pipe(const Maps& m, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, int B, int seq,
                   int H, int Kv, int causal, int window, float scale,
                   cudaStream_t st) {
  using C = PipeCfg<HD, true>;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int64_t n_pairs = (n_tiles * (H / Kv) + 1) / 2;
  const int64_t blocks = n_pairs * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_pipe<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_pipe<HD><<<static_cast<unsigned>(blocks), 2 * kThreads,
                                C::kSmem, st>>>(
      m.q, m.d, m.k, m.v, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      static_cast<__nv_bfloat16*>(dq), seq, H, Kv, B, causal, window, scale,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The streaming multiprocessors of the current device.
inline int sm_count() {
  int device = 0, n = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return n;
}

// Blocks a kv tile's dk/dv takes (flash_bwd_dkdv_wgmma_pipe's cluster): two
// when the kv tiles are fewer than the SMs (internvl2-1b's and qwen1.5-110b's
// training microbatches: 128 on 132), so four warpgroups split each chain
// and every SM works; one when the kv tiles fill the card.
int dkdv_cluster(int64_t kv_tiles) { return kv_tiles < sm_count() ? 2 : 1; }

template <int HD>
int launch_dkdv_pipe(const Maps& m, const float* lse, const float* dsum,
                     void* dk, void* dv, int B, int seq, int H, int Kv,
                     int causal, int window, float scale, cudaStream_t st) {
  using C = PipeCfg<HD, false>;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int nc = dkdv_cluster(n_tiles * Kv * B);
  const int64_t blocks = n_tiles * Kv * B * nc;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_pipe<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(2 * kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, flash_bwd_dkdv_wgmma_pipe<HD>, m.q, m.d, m.k, m.v, lse, dsum,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq,
      H, Kv, B, causal, window, scale);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// The column block of a width above 256 (a multiple of 64): the fewest
// blocks, ceil(hd / 256), then the narrowest of 192 and 256 that covers hd
// in that many (hd / n_cb is above 128 there, so 128 is never the pick):
// 192 at hd 320, 384 and 576, 256 at 448, 512, 640 and 1,024.
int col_block(int hd) {
  const int n_cb = (hd + 255) / 256;
  return (hd + n_cb - 1) / n_cb <= 192 ? 192 : 256;
}

template <int NB>
int launch_dq_cols(const Maps& m, const void* o, const void* dout,
                   const float* lse, float* dsum, void* dq, int B, int seq,
                   int H, int Kv, int hd, int causal, int window, float scale,
                   cudaStream_t st) {
  using C = DqCols<NB>;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int n_cb = (hd + NB - 1) / NB;
  const int64_t blocks = n_tiles * H * B * n_cb;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_cols<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_cols<NB><<<static_cast<unsigned>(blocks), kThreads,
                                C::kSmem, st>>>(
      m.q, m.d, m.k, m.v, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      static_cast<__nv_bfloat16*>(dq), seq, H, Kv, B, hd, causal, window,
      scale, static_cast<int>(n_tiles), n_cb);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_dkdv_cols(const Maps& m, const float* lse, const float* dsum,
                     void* dk, void* dv, int B, int seq, int H, int Kv,
                     int hd, int causal, int window, float scale,
                     cudaStream_t st) {
  using C = DkdvCols<NB>;
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int n_cb = (hd + NB - 1) / NB;
  const int64_t blocks = n_tiles * Kv * B * n_cb;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_cols<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_wgmma_cols<NB><<<static_cast<unsigned>(blocks),
                                  2 * kThreads, C::kSmem, st>>>(
      m.q, m.d, m.k, m.v, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq, H, Kv, B, hd, causal, window,
      scale, n_cb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: tensor cores, each product as three TF32 products (tf32x3), any
// width that is a multiple of 32
// ---------------------------------------------------------------------------

namespace x3 {

// The split and its chunk layout (csrc/tf32x3.cuh, shared with the
// forward). A ring stage's slots: a product step holds the own side's two
// chunks and the other side's two (own0 other0^T is S or S^T, own1
// other1^T dP or dP^T); an output step four chunks of the other side's
// output columns (dq: two of k's for each warpgroup's columns; dk/dv: two
// of q's, then two of dout's).
using namespace hopper;
using tf32x3::issue_chunk;
using tf32x3::kChunk;
using tf32x3::kCols;
using tf32x3::kLo;
using tf32x3::kStage;
using tf32x3::kStages;
using tf32x3::kThreads;
using tf32x3::kTile;
using tf32x3::out_chunk;
using tf32x3::split;
using tf32x3::store_rows;
using tf32x3::whole;

// Shared memory from a 1024-byte aligned base: three stages, the q-side
// vectors [2][2][kTile] fp32 (dk/dv: lse * log2(e) and D of the ring's two
// q tiles; dq: D of the block's rows), two exchange tiles [8][kThreads]
// float4 (P or P^T from warpgroup 0; dP from warpgroup 1 in dq), then the
// mbarriers: 231,448 bytes, one block an SM.
constexpr int kVec = kStages * kStage;
constexpr int kXchg = kVec + 2 * 2 * kTile * 4;
constexpr int kXchgTile = 8 * kThreads * 16;
constexpr int kBar = kXchg + 2 * kXchgTile;
constexpr int kSmem = kBar + 8 * kStages + 1024;
static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");

// One block of either launch: its own 64-row tile, the iterations over the
// other side's 64-position tiles that its rows see, and its columns.
// Launch 1 (DQ): block (column block, head, batch, q tile), q tiles
// heaviest first when causal; own q and dout, other k and v (kv tiles
// t_begin + i); it owns dq's columns [c0, c0 + 2 WC), warpgroup w the
// WC from c0 + w WC. Launch 2: block (column block, kv head, batch, kv
// tile), kv tile 0 (seen by every q row when causal) first; own k and v,
// other q and dout of query head kvh G + i / n_q at q tile qt_begin + i %
// n_q; it owns dk's and dv's columns [c0, c0 + WC).
template <bool DQ, int WC>
struct Block {
  int b, h, kvh, G, H, seq, own0, t_begin, n_t, c0, hd, ncols, n_c, per, n;
  static constexpr int kOutCols = 2 * kCols;   // a warpgroup's, a step

  __device__ __forceinline__ Block(int H_, int Kv, int B, int seq_, int hd_,
                                   int causal, int window, int n_cb)
      : H(H_), seq(seq_), hd(hd_) {
    const int n_tiles = (seq + kTile - 1) / kTile;
    const int cb = blockIdx.x % n_cb;
    const int rest = blockIdx.x / n_cb;
    G = H / Kv;
    if constexpr (DQ) {
      h = rest % H;
      b = rest / H % B;
      const int t_lin = rest / H / B;
      const int qt = causal ? n_tiles - 1 - t_lin : t_lin;
      kvh = h / G;
      own0 = qt * kTile;
      const int2 span = kv_span(own0, min(own0 + kTile, seq) - 1, seq,
                                causal, window);
      t_begin = span.x / kTile;
      n_t = (span.y + kTile - 1) / kTile - t_begin;
      c0 = cb * 2 * WC;
      ncols = min(2 * WC, hd - c0);
    } else {
      const int kt = rest / (B * Kv);
      b = rest % (B * Kv) / Kv;
      kvh = rest % Kv;
      h = kvh * G;
      own0 = kt * kTile;
      const int2 span = q_span(own0, min(own0 + kTile, seq) - 1, seq,
                               causal, window);
      t_begin = span.x / kTile;
      n_t = (span.y + kTile - 1) / kTile - t_begin;
      c0 = cb * WC;
      ncols = min(WC, hd - c0);
    }
    n_c = hd / kCols;
    per = n_c + (min(WC, ncols) + kOutCols - 1) / kOutCols;
    n = (DQ ? n_t : G * n_t) * per;
  }
  // iteration i's other tile: its first position and its head
  __device__ __forceinline__ int other0(int i) const {
    return (t_begin + (DQ ? i : i % n_t)) * kTile;
  }
  __device__ __forceinline__ int head(int i) const {
    return DQ ? h : kvh * G + i / n_t;
  }
  // warpgroup w's output columns: its first, and how many below hd
  __device__ __forceinline__ int col0(int w) const {
    return c0 + (DQ ? w * WC : 0);
  }
  __device__ __forceinline__ int cols(int w) const {
    return max(0, min(WC, hd - col0(w)));
  }
  // the q-side vector entry t (0..127) of dk/dv iteration i: lse * log2(e)
  // of q position other0(i) + t for t < 64, D of position other0(i) + t -
  // 64 above
  __device__ __forceinline__ float vec(const float* __restrict__ lse,
                                       const float* __restrict__ dsum,
                                       int i, int t) const {
    const int pos = other0(i) + t % kTile;
    if (pos >= seq) return 0.0f;
    const int64_t at = (static_cast<int64_t>(b) * H + head(i)) * seq + pos;
    return t < kTile ? lse[at] * kLog2e : dsum[at];
  }
  // step m (iteration m / per) into its ring stage: a product step (chunk
  // m % per of the four inputs) or an output step (the other side's output
  // columns from 64 u on, u = m % per - n_c); by one thread
  __device__ __forceinline__ void load(int m, uint32_t base, uint32_t full,
                                       const CUtensorMap* qmap,
                                       const CUtensorMap* dmap,
                                       const CUtensorMap* kmap,
                                       const CUtensorMap* vmap) const {
    const int i = m / per, s = m % per, at = other0(i);
    const uint32_t st = base + (m % kStages) * kStage;
    const uint32_t bar = full + 8 * (m % kStages);
    const int qcol = head(i) * hd, kcol = kvh * hd;
    if (s < n_c) {                     // own0, own1, other0, other1
      const int c = kCols * s;
      const int own = (DQ ? qcol : kcol) + c, other = (DQ ? kcol : qcol) + c;
      mbar_expect_tx(bar, 4 * kChunk);
      tma_load(st, DQ ? qmap : kmap, bar, own, own0, b);
      tma_load(st + kChunk, DQ ? dmap : vmap, bar, own, own0, b);
      tma_load(st + 2 * kChunk, DQ ? kmap : qmap, bar, other, at, b);
      tma_load(st + 3 * kChunk, DQ ? vmap : dmap, bar, other, at, b);
    } else {
      // chunk j of warpgroup w's 64 columns from its col0(w) + 64 u: dq's
      // k chunks at slots 2 w + j; dk/dv's q chunks at j, dout's at 2 + j
      const int u = s - n_c;
      int chunks = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = u * kOutCols + j * kCols;
        chunks += DQ ? (off < cols(0)) + (off < cols(1)) : 2 * (off < ncols);
      }
      mbar_expect_tx(bar, chunks * kChunk);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = u * kOutCols + j * kCols;
        if constexpr (DQ) {
#pragma unroll
          for (int w = 0; w < 2; ++w)
            if (off < cols(w))
              tma_load(st + (2 * w + j) * kChunk, kmap, bar,
                       kcol + col0(w) + off, at, b);
        } else if (off < ncols) {
          tma_load(st + j * kChunk, qmap, bar, qcol + c0 + off, at, b);
          tma_load(st + (2 + j) * kChunk, dmap, bar, qcol + c0 + off, at, b);
        }
      }
    }
  }
};

// Barrier 1 over both warpgroups of a block (each reaches it from its own
// loop).
__device__ __forceinline__ void both_warpgroups() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One warpgroup's loop over the block's steps, summing its output columns
// into acc. Warpgroup 0 forms S (S^T in dk/dv) chunk by chunk, then P (P^T),
// which it leaves in the exchange tile; warpgroup 1 forms dP (dP^T), which
// in dq it leaves in the other exchange tile. Once the barrier after the
// last product step has passed, dq's warpgroups both form dS = P (dP - D)
// scale from their own tile and the other's, and each adds dS k over its
// columns; dk/dv's warpgroup 1 forms dS^T = P^T (dP^T - D) scale and adds
// dS^T q into dk, warpgroup 0 P^T dout into dv. Both split each next stage
// while the products run; warpgroup 0's thread 0 keeps the ring, refilling
// a stage once both have passed the barrier after its step; in dk/dv
// warpgroup 0 also writes each next q tile's lse and D into vec.
template <bool DQ, int WC, int ROLE>
__device__ __forceinline__ void block_loop(
    float (&acc)[WC / 2], const Block<DQ, WC>& bk, uint32_t base,
    uint8_t* sm, float* vec, float4* xchg,
    const float (&lse2)[2], const CUtensorMap* qmap, const CUtensorMap* dmap,
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    int causal, int window, float scale) {
  constexpr int kMaxOut = WC / Block<DQ, WC>::kOutCols;
  const int tid = threadIdx.x % kThreads;
  const uint32_t full = base + kBar;
  const Frag fr;
  const float c2 = scale * kLog2e;
  float4* mine = xchg + ROLE * 8 * kThreads;        // the tile this leaves
  const float4* theirs = xchg + (1 - ROLE) * 8 * kThreads;
  float drow[2];                       // dq: D of this thread's two rows
  if constexpr (DQ) {
    drow[0] = vec[fr.row_a];
    drow[1] = vec[fr.row_a + 8];
  }
  float x[32];                 // S, then P, then dS (DQ: dS in both)
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.0f;
  for (int m = 0; m < bk.n; ++m) {
    const int s = m % bk.per, i = m / bk.per;
    const uint32_t st = base + (m % kStages) * kStage;
    if (!DQ && ROLE == 0 && s == 0 && i + 1 < bk.n / bk.per)
      vec[((i + 1) & 1) * 2 * kTile + tid] = bk.vec(lse, dsum, i + 1, tid);
    float tx[32];
    if (s < bk.n_c) {
      wgmma_fence();
      issue_chunk(tx, st + ROLE * kChunk, st + (2 + ROLE) * kChunk);
      wgmma_commit();
    }
    if (m + 1 < bk.n) {                // the next stage, meanwhile
      const int n = m + 1;
      mbar_wait(full + 8 * (n % kStages), (n / kStages) & 1);
      split(sm + (n % kStages) * kStage);
    }
    if (s < bk.n_c) {
      wgmma_wait<0>();
      pin(tx);
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] = s == 0 ? tx[e] : x[e] + tx[e];
      if (s == bk.n_c - 1) {
        if constexpr (ROLE == 0) {     // P (P^T), masked
          const int o0 = bk.other0(i);
          const bool all = DQ ? whole(bk.own0, o0, bk.seq, causal, window)
                              : whole(o0, bk.own0, bk.seq, causal, window);
          const float* sl = vec + (i & 1) * 2 * kTile;
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int idx = 4 * j + u, half = u / 2;
              const int row = bk.own0 + fr.row_a + 8 * half;
              const int col = 8 * j + fr.cq + u % 2;
              const bool ok =
                  all || (DQ ? sees(row, o0 + col, bk.seq, causal, window)
                             : sees(o0 + col, row, bk.seq, causal, window));
              const float l2 = DQ ? lse2[half] : sl[col];
              x[idx] = ok ? ex2(fmaf(x[idx], c2, -l2)) : 0.0f;
            }
        }
        if (ROLE == 0 || DQ)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mine[j * kThreads + tid] = make_float4(
                x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
    } else {
      const int u = s - bk.n_c;
      if (u == 0 && (DQ || ROLE == 1)) {   // dS (dS^T) = P (dP - D) scale
        const float* sd = vec + (i & 1) * 2 * kTile + kTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 o = theirs[j * kThreads + tid];
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            const float d = DQ ? drow[e / 2] : sd[8 * j + fr.cq + e % 2];
            const float p = ROLE == 0 ? x[idx] : ov[e];
            const float dp = ROLE == 0 ? ov[e] : x[idx];
            x[idx] = p * (dp - d) * scale;
          }
        }
      }
      // this warpgroup's B chunks: dq k's (2 ROLE, + 1), dv dout's (2, 3),
      // dk q's (0, 1)
      const uint8_t* stp =
          sm + (m % kStages) * kStage + (DQ ? 2 * ROLE : 2 - 2 * ROLE) *
                                            kChunk;
      const int ncols = DQ ? bk.cols(ROLE) : bk.ncols;
#pragma unroll
      for (int uu = 0; uu < kMaxOut; ++uu)
        if (uu == u)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (uu * Block<DQ, WC>::kOutCols + j * kCols < ncols)
              out_chunk(acc, uu * 8 + 4 * j, x, stp + j * kChunk);
    }
    both_warpgroups();                 // stage m is read; m + 1 is split
    if (ROLE == 0 && tid == 0 && m + kStages < bk.n)
      bk.load(m + kStages, base, full, qmap, dmap, kmap, vmap);
  }
}

// A block of launch 1 (DQ: dq and D) or launch 2 (dk and dv): two
// warpgroups (block_loop; 256 threads keep ptxas's 255-register budget)
// over one ring of 64 KB stages. In dq every column block computes D over
// the full width for its rows (warpgroup 0); column block 0 writes it for
// launch 2.
template <bool DQ, int WC>
__device__ __forceinline__ void tf32x3_block(
    const CUtensorMap& qmap, const CUtensorMap& dmap,
    const CUtensorMap& kmap, const CUtensorMap& vmap,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dsum,
    float* __restrict__ out0, float* __restrict__ out1, int seq, int H,
    int Kv, int B, int hd, int causal, int window, float scale, int n_cb) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* vec = reinterpret_cast<float*>(sm + kVec);
  float4* xchg = reinterpret_cast<float4*>(sm + kXchg);
  const uint32_t full = base + kBar;
  const Block<DQ, WC> bk(H, Kv, B, seq, hd, causal, window, n_cb);

  tc::bar_init(full, kStages);
  if (threadIdx.x == 0)
    for (int m = 0; m < min(kStages, bk.n); ++m)
      bk.load(m, base, full, &qmap, &dmap, &kmap, &vmap);
  const Frag fr;
  float lse2[2] = {0.0f, 0.0f};
  if constexpr (DQ) {
    // D of the block's rows into vec, by warpgroup 0
    if (threadIdx.x < kThreads)
      tc::tile_dsum(vec, o, dout, dsum, bk.own0, bk.b, bk.h, seq, H, hd,
                    blockIdx.x % n_cb == 0, threadIdx.x);
    const int64_t lrow = (static_cast<int64_t>(bk.b) * H + bk.h) * seq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = bk.own0 + fr.row_a + 8 * half;
      lse2[half] = pos < seq ? lse[lrow + pos] * kLog2e : 0.0f;
    }
  } else if (threadIdx.x < 2 * kTile) {
    vec[threadIdx.x] = bk.vec(lse, dsum, 0, threadIdx.x);
  }
  if (bk.n > 0) {
    mbar_wait(full, 0);
    split(sm);
  }
  __syncthreads();

  constexpr int NACC = WC / 2;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  const int rows = DQ ? H : Kv;
  const int64_t at = static_cast<int64_t>(bk.b) * seq * rows * hd +
                     static_cast<int64_t>(DQ ? bk.h : bk.kvh) * hd;
  const int64_t stride = static_cast<int64_t>(rows) * hd;
  // the warpgroup, broadcast from lane 0 so that ptxas sees the role branch
  // as uniform (on a branch it takes for divergent it serializes wgmma)
  if (__shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0) == 0) {
    block_loop<DQ, WC, 0>(acc, bk, base, sm, vec, xchg, lse2, &qmap, &dmap,
                          &kmap, &vmap, lse, dsum, causal, window, scale);
    // dq's first WC columns; dv
    store_rows<WC>(acc, out0, at + bk.col0(0), stride, bk.own0, seq, fr,
                   DQ ? bk.cols(0) : bk.ncols);
  } else {
    block_loop<DQ, WC, 1>(acc, bk, base, sm, vec, xchg, lse2, &qmap, &dmap,
                          &kmap, &vmap, lse, dsum, causal, window, scale);
    // dq's next WC columns; dk
    store_rows<WC>(acc, DQ ? out0 : out1, at + bk.col0(1), stride, bk.own0,
                   seq, fr, DQ ? bk.cols(1) : bk.ncols);
  }
}

// Launch 1: dq (out0) and D; a block owns 2 WC of dq's columns.
template <int WC>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dq_tf32x3(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum, float* __restrict__ dq,
                        int seq, int H, int Kv, int B, int hd, int causal,
                        int window, float scale, int n_cb) {
  tf32x3_block<true, WC>(qmap, dmap, kmap, vmap, o, dout, lse, dsum, dq,
                         nullptr, seq, H, Kv, B, hd, causal, window, scale,
                         n_cb);
}

// Launch 2: dv (out0) and dk (out1); a block owns WC of their columns.
template <int WC>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_bwd_dkdv_tf32x3(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dv, float* __restrict__ dk,
                          int seq, int H, int Kv, int B, int hd, int causal,
                          int window, float scale, int n_cb) {
  tf32x3_block<false, WC>(qmap, dmap, kmap, vmap, nullptr, nullptr, lse,
                          const_cast<float*>(dsum), dv, dk, seq, H, Kv, B,
                          hd, causal, window, scale, n_cb);
}

// The output columns a warpgroup owns at width hd (a multiple of 32): dq's
// block owns two warpgroups' worth (128 up to hd 128, 256 up to 256, 512
// above, in ceil(hd / 512) column blocks), dk/dv's one (64, 128, or 256 in
// ceil(hd / 256) blocks); up to hd 256 one block a tile, so S and dP are
// formed once per tile pair.
int warp_cols(int hd, bool dq) {
  if (dq) return hd <= 128 ? 64 : hd <= 256 ? 128 : 256;
  return hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// fp32 tensor maps, boxes of 64 positions x 32 columns.
int f32_maps(tc::Maps* m, const void* q, const void* k, const void* v,
             const void* dout, int B, int seq, int H, int Kv, int hd) {
  int err = tensor_map_128b(&m->q, q, B, seq, H, hd, 4);
  if (err == 0) err = tensor_map_128b(&m->d, dout, B, seq, H, hd, 4);
  if (err == 0) err = tensor_map_128b(&m->k, k, B, seq, Kv, hd, 4);
  if (err == 0) err = tensor_map_128b(&m->v, v, B, seq, Kv, hd, 4);
  return err;
}

template <bool DQ, int WC>
int launch_wc(const tc::Maps& m, const void* o, const void* dout,
              const float* lse, float* dsum, void* out0, void* out1, int B,
              int seq, int H, int Kv, int hd, int causal, int window,
              float scale, cudaStream_t st) {
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int block_cols = DQ ? 2 * WC : WC;
  const int n_cb = (hd + block_cols - 1) / block_cols;
  const int64_t blocks = n_tiles * (DQ ? H : Kv) * B * n_cb;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t e;
  if constexpr (DQ) {
    e = cudaFuncSetAttribute(flash_bwd_dq_tf32x3<WC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_tf32x3<WC><<<grid, 2 * kThreads, kSmem, st>>>(
        m.q, m.d, m.k, m.v, static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, dsum,
        static_cast<float*>(out0), seq, H, Kv, B, hd, causal, window, scale,
        n_cb);
  } else {
    e = cudaFuncSetAttribute(flash_bwd_dkdv_tf32x3<WC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkdv_tf32x3<WC><<<grid, 2 * kThreads, kSmem, st>>>(
        m.q, m.d, m.k, m.v, lse, dsum, static_cast<float*>(out0),
        static_cast<float*>(out1), seq, H, Kv, B, hd, causal, window, scale,
        n_cb);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq (out0 = dq) or dk/dv (out0 = dv, out1 = dk) at width hd.
template <bool DQ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* out0,
           void* out1, int B, int seq, int H, int Kv, long long hd,
           int causal, int window, float scale, cudaStream_t st) {
  if (hd < kCols || hd % kCols != 0 || hd > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(hd);
  tc::Maps m;
  const int err = f32_maps(&m, q, k, v, dout, B, seq, H, Kv, w);
  if (err != 0) return err;
  switch (warp_cols(w, DQ)) {
    case 64:
      return launch_wc<DQ, 64>(m, o, dout, lse, dsum, out0, out1, B, seq, H,
                               Kv, w, causal, window, scale, st);
    case 128:
      return launch_wc<DQ, 128>(m, o, dout, lse, dsum, out0, out1, B, seq,
                                H, Kv, w, causal, window, scale, st);
  }
  return launch_wc<DQ, 256>(m, o, dout, lse, dsum, out0, out1, B, seq, H,
                            Kv, w, causal, window, scale, st);
}

}  // namespace x3

}  // namespace

extern "C" {

// Each returns 0 when the kernel was launched, else a cudaError_t, or for
// the tensor-core kernels a negative code when a TMA tensor map could not be
// built (-1: no cuTensorMapEncodeTiled in the driver; -1000 - CUresult: it
// refused). q, out, dout and dq hold B * seq * H * hd contiguous elements;
// k, v, dk and dv B * seq * Kv * hd; lse and dsum B * H * seq fp32; H % Kv
// == 0; window >= 0 (0: no window); scale = 1 / sqrt(hd). The _dq launch
// writes dq and dsum (D); the _dkdv launch, on the same stream after it,
// reads dsum and writes dk and dv. The CUDA-core functions (_f32,
// _bf16_cc) take any hd; the tensor-core ones hd 64, 128, 192, 256 or a
// multiple of 64 above 256 (_bf16) or a multiple of 32 (_f32_tf32x3), and
// 16-byte aligned q, k, v, out and dout.
int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dsum, void* dq, int B, int seq, int H, int Kv,
                     long long hd, int causal, int window, float scale,
                     void* stream) {
  return cc::launch_dq<float>(q, k, v, o, dout,
                              static_cast<const float*>(lse),
                              static_cast<float*>(dsum), dq, B, seq, H, Kv,
                              hd, causal, window, scale,
                              static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int seq, int H, int Kv,
                       long long hd, int causal, int window, float scale,
                       void* stream) {
  return cc::launch_dkdv<float>(q, k, v, dout, static_cast<const float*>(lse),
                                static_cast<const float*>(dsum), dk, dv, B,
                                seq, H, Kv, hd, causal, window, scale,
                                static_cast<cudaStream_t>(stream));
}

int flash_bwd_dq_f32_tf32x3(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dsum, void* dq, int B, int seq, int H,
                            int Kv, long long hd, int causal, int window,
                            float scale, void* stream) {
  return x3::launch<true>(q, k, v, o, dout, static_cast<const float*>(lse),
                          static_cast<float*>(dsum), dq, nullptr, B, seq, H,
                          Kv, hd, causal, window, scale,
                          static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkdv_f32_tf32x3(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dsum, void* dk, void* dv, int B,
                              int seq, int H, int Kv, long long hd,
                              int causal, int window, float scale,
                              void* stream) {
  return x3::launch<false>(q, k, v, nullptr, dout,
                           static_cast<const float*>(lse),
                           const_cast<float*>(static_cast<const float*>(dsum)),
                           dv, dk, B, seq, H, Kv, hd, causal, window, scale,
                           static_cast<cudaStream_t>(stream));
}

int flash_bwd_dq_bf16_cc(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* dsum, void* dq, int B, int seq, int H, int Kv,
                         long long hd, int causal, int window, float scale,
                         void* stream) {
  return cc::launch_dq<__nv_bfloat16>(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(dsum), dq, B, seq, H, Kv, hd, causal, window,
      scale, static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkdv_bf16_cc(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* dsum, void* dk, void* dv, int B,
                           int seq, int H, int Kv, long long hd, int causal,
                           int window, float scale, void* stream) {
  return cc::launch_dkdv<__nv_bfloat16>(
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), dk, dv, B, seq, H, Kv, hd, causal,
      window, scale, static_cast<cudaStream_t>(stream));
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dsum, void* dq, int B, int seq, int H, int Kv,
                      long long hd, int causal, int window, float scale,
                      void* stream) {
  tc::Maps m;
  const int err = tc::make_maps(&m, q, k, v, dout, B, seq, H, Kv,
                                static_cast<int>(hd));
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  switch (hd) {
    case 64:
      return tc::launch_dq_hd<64>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                  causal, window, scale, st);
    case 128:
      return tc::launch_dq_pipe<128>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                     causal, window, scale, st);
    case 192:
      return tc::launch_dq_hd<192>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                   causal, window, scale, st);
    case 256:
      return tc::launch_dq_hd<256>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                   causal, window, scale, st);
  }
  if (hd <= 256 || hd % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(hd);
  return tc::col_block(w) == 192
             ? tc::launch_dq_cols<192>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                       w, causal, window, scale, st)
             : tc::launch_dq_cols<256>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                       w, causal, window, scale, st);
}

int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dk, void* dv, int B, int seq, int H, int Kv,
                        long long hd, int causal, int window, float scale,
                        void* stream) {
  tc::Maps m;
  const int err = tc::make_maps(&m, q, k, v, dout, B, seq, H, Kv,
                                static_cast<int>(hd));
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  switch (hd) {
    case 64:
      return H == Kv ? tc::launch_dkdv_hd<64>(m, l, ds, dk, dv, B, seq, H,
                                              Kv, causal, window, scale, st)
                     : tc::launch_dkdv_pipe<64>(m, l, ds, dk, dv, B, seq, H,
                                                Kv, causal, window, scale,
                                                st);
    case 128:
      return H == Kv ? tc::launch_dkdv_hd<128>(m, l, ds, dk, dv, B, seq, H,
                                               Kv, causal, window, scale, st)
                     : tc::launch_dkdv_pipe<128>(m, l, ds, dk, dv, B, seq, H,
                                                 Kv, causal, window, scale,
                                                 st);
    case 192:
      return tc::launch_dkdv_hd<192>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                     window, scale, st);
    case 256:
      return tc::launch_dkdv_hd<256>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                     window, scale, st);
  }
  if (hd <= 256 || hd % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(hd);
  return tc::col_block(w) == 192
             ? tc::launch_dkdv_cols<192>(m, l, ds, dk, dv, B, seq, H, Kv, w,
                                         causal, window, scale, st)
             : tc::launch_dkdv_cols<256>(m, l, ds, dk, dv, B, seq, H, Kv, w,
                                         causal, window, scale, st);
}

// The one-warpgroup pair that bf16 ran on at hd 64 and 128 before the
// two-warpgroup kernels (flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma), kept
// bound as their yardstick; hd 64 or 128 only, no route reaches it.
int flash_bwd_dq_bf16_yardstick(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dsum, void* dq, int B,
                                int seq, int H, int Kv, long long hd,
                                int causal, int window, float scale,
                                void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  tc::Maps m;
  const int err = tc::make_maps(&m, q, k, v, dout, B, seq, H, Kv,
                                static_cast<int>(hd));
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  return hd == 64 ? tc::launch_dq_hd<64>(m, o, dout, l, ds, dq, B, seq, H,
                                         Kv, causal, window, scale, st)
                  : tc::launch_dq_hd<128>(m, o, dout, l, ds, dq, B, seq, H,
                                          Kv, causal, window, scale, st);
}

int flash_bwd_dkdv_bf16_yardstick(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dsum, void* dk,
                                  void* dv, int B, int seq, int H, int Kv,
                                  long long hd, int causal, int window,
                                  float scale, void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  tc::Maps m;
  const int err = tc::make_maps(&m, q, k, v, dout, B, seq, H, Kv,
                                static_cast<int>(hd));
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  return hd == 64 ? tc::launch_dkdv_hd<64>(m, l, ds, dk, dv, B, seq, H, Kv,
                                           causal, window, scale, st)
                  : tc::launch_dkdv_hd<128>(m, l, ds, dk, dv, B, seq, H, Kv,
                                            causal, window, scale, st);
}

}  // extern "C"
