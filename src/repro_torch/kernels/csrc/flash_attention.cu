// Flash attention (GQA, causal and/or sliding window, forward) for Hopper
// (sm_90a), bound to Python with ctypes. Six kernels: bfloat16 runs on
// the tensor cores, flash_kernel_wgmma up to hd 256 (but at 192),
// flash_kernel_wgmma_pipe at 192 and flash_kernel_wgmma_cols above 256
// (the scores summed over hd in 64-column chunks, the output in column
// blocks); float32 on the tensor cores too,
// flash_kernel_tf32x3 at any multiple of 32, each fp32 product as three
// TF32 products (one TF32 product would break the fp32 tolerances; the
// split of each operand into hi and lo parts keeps them). The CUDA-core
// kernels (flash_kernel at hd 16, 32, 64, 128, 192 and 256,
// flash_kernel_chunked at any other width, fp32 products) take either
// dtype: they are the float32 route's yardstick, and bfloat16 runs on them
// where a (batch, kv head) holds 2^31 - 256 folded rows or more. The
// wrapper zero-pads a bfloat16 width below 256 to the next built one, a
// bfloat16 width above 256 to a multiple of 64 and a float32 width to a
// multiple of 32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fa_kernel
// (Pallas). For q [B, S, H, hd] and k, v [B, S, Kv, hd] (self-attention,
// Sq == Skv, q aligned to the end of kv), query head h reads kv head
// h / G with G = H / Kv (the JAX reshape(B, S, Kv, G, hd) order), and
//
//   out[b, i, h] = sum_j softmax_j(q_i . k_j / sqrt(hd) + mask_ij) v_j
//
// with mask_ij = -1e30 where j > i (causal), where j <= i - window
// (window > 0) and where j >= S. Scores, the online softmax (m, l, acc) and
// the output sum are fp32; out is stored in q's dtype. Given a non-null lse
// (fp32 [B, H, S]), each kernel also writes every row's log-sum-exp of its
// scaled, masked scores, lse = m + log(l) in the natural log (l = 1 where
// it is 0), which the backward (_fa_bwd in repro/models/layers.py) reads;
// with a null lse nothing more is written.
//
// Bound on an H100: the causal products take 4 * B * H * S^2 * hd / 2 flops
// (qwen1.5-110b's prefill, B=4, S=1024, H=64, hd=128: 68.7 GFLOP, ~69 us at
// the 989 TFLOP/s bf16 tensor-core rate) against ~151 MB of q, k, v and out
// (~45 us at 3.35 TB/s), so operations bound it.
//
// Every kernel but flash_kernel_tf32x3 folds the G query heads of a kv
// head into a tile's rows, as _fa_kernel does: folded row r is query position r / G, head
// kv_head * G + r % G, so one kv tile in shared memory serves all G heads.
// Masked scores are -1e30, not -inf: a row that sees only masked positions
// in its first tile keeps finite junk that alpha = exp(-1e30 - m) = 0 wipes
// at its first valid tile (every row sees its own position). Tiles past the
// causal bound of a block's last row and before the window of its first are
// never visited. No atomics and no split reductions: the same bits on every
// run.
//
// flash_kernel_wgmma (bf16): one block of 288 threads per 128 folded rows
// of one (batch, kv head): two consumer warpgroups of 64 rows (wgmma's M)
// and one producer warp. The consumers copy their q rows into shared memory
// once (all of a thread's 16-byte loads in flight together), raw bf16, in
// the swizzled layout that TMA gives k and v. The producer's first lane
// streams k and v tiles of 64 positions by TMA (cp.async.bulk.tensor over a
// [B][S][Kv * hd] view, one box per 64 columns of a head: the 128-byte
// swizzle holds 64 bf16, so hd 128 and 192 take two and three boxes; hd 16
// and 32 use the 32- and 64-byte swizzles; rows past S arrive as zeros)
// into a ring of two stages, each with a
// "full" mbarrier (expect_tx) and an "empty" one that all 8 consumer warps
// arrive on once their products have read it, so tile i + 1 loads while
// tile i computes. Per tile each consumer warpgroup runs
//   S = Q K^T   wgmma m64n64k16, A (q) and B (k, K-major) in shared memory;
//   softmax     in the log2 domain after the product, p = 2^(s * log2(e)
//               / sqrt(hd) - m) with one FFMA and one ex2.approx a score
//               (the products of bf16 values are exact in fp32, so this
//               differs from Pallas's "scale q first" in the last fp32 bits
//               only), masked only where the tile crosses the diagonal, the
//               window's lower edge or S;
//   O += P V    wgmma m64n{hd}k16 (N = 256 at hd 256: 128 fp32
//               accumulators a thread) with A = P from registers (the score
//               accumulator's layout is wgmma's A-register layout, so P never
//               touches shared memory) and B = v, MN-major (transpose bit).
// P is split into bf16 hi + lo and both go through the P V product: hi is
// p truncated to bf16 (its upper 16 bits, one byte permute a pair), lo = p
// - hi exactly in fp32, rounded to bf16, so hi + lo = p to 2^-16 relative.
// P rounded once to bf16 (2^-9 relative) misses the gates
// the fp32 Pallas kernel is held to at qwen's shape (shown on the CPU by a
// model of this arithmetic in tests/test_torch_attention.py), so the second
// product costs twice the first. The output leaves through the warpgroup's
// q region (swizzled, so the accumulator layout's 4-byte writes meet no
// bank conflicts) in 16-byte row pieces. Blocks start with the heaviest
// causal q tiles, so the last wave holds the short ones. Row indices stay
// in 32 bits (64-bit division made the q load and the output store
// measurably slower). A warpgroup runs its tile's steps one after the
// other; the two warpgroups of a block overlap each other's softmax with
// their products. Several schemes that overlap more (a software pipeline
// inside the warpgroup, turns between the warpgroups, 128-position kv
// tiles, deeper rings, a persistent grid that prefetches q) did not beat
// this loop on the H100 (PERF.md). Registers bind at hd 256: ptxas
// budgets the 288-thread block as three warpgroups, 168 registers a
// thread, of which the 128 accumulators leave 40. So hd 256 takes kv tiles
// of 32 (16 score and 16 P registers, m64n32k16 for S) through a ring of
// four stages (the same 128 positions in flight), q 64 KB of shared memory
// and the ring 128 KB. It still spills (PERF.md gives ptxas's bytes) and
// ptxas serializes its wgmma; tiles of 64 spilled more and ran slower, and
// a producer warpgroup handing its registers to the consumers (setmaxnreg)
// left ptxas's allocation at 168. At hd 192 the same budget spilled and
// serialized the wgmma too; flash_kernel_wgmma<192, 64> stays built as the
// yardstick of the kernel that replaced it there.
//
// flash_kernel_wgmma_pipe (bf16 at hd 192; the wrapper pads 129-191 to it)
// computes what flash_kernel_wgmma does, in the same order (S over hd in
// one wgmma chain, the online softmax, P_hi V then P_lo V onto the
// rescaled accumulator), on a block built for the register file. 256
// threads, two warpgroups of 64 folded rows and no producer warp, so ptxas
// budgets 255 registers a thread, not 168: 96 accumulators, S (32) and P
// hi + lo (32) fit beside each other, with no spill. One thread loads q
// once by TMA, one box a 64-column chunk from a 4-D view of q {hd, H, S,
// B}: a box of G heads x kRows / G positions is a q tile's folded rows in
// order, so a tile holds whole positions, 128 rows where G divides 128
// and fewer otherwise (120 at G = 12, nemotron-4-340b's, where 8 of a
// tile's rows idle; where G is above 128, one position's share, the
// widest divisor of G up to 128). k and v stream through a ring of three
// stages of 64 positions (q 48 KB and the ring 144 KB): the last of the
// block's 8 warps to finish with a stage (a shared counter) loads the
// tile three ahead into it, so no thread waits to refill. Inside a
// warpgroup each step issues S of tile i and P V of tile i - 1 together,
// waits for S alone (wgmma_wait<1>) and runs tile i's softmax while P V
// is on the tensor cores, then packs P and rescales the accumulator once
// P V is done (FlashAttention-3's pipelining inside a warpgroup; packing
// P while P V still read the last one made ptxas serialize the wgmma,
// C7513). Turns between the two warpgroups on named barriers (ping-pong)
// on top of it, and the same block without the pipelining, were no
// faster on the H100 (PERF.md). Blocks start with the heaviest causal
// tiles; out leaves through the warpgroup's q region as in
// flash_kernel_wgmma.
//
// flash_kernel_wgmma_cols (bf16, hd above 256, a multiple of 64): q and k
// no longer fit shared memory beside each other (a 128-row q tile is 256
// KB at hd 1,024), so both stream in 64-column chunks. A block of 128
// folded rows owns NB = 128 output columns: 64 accumulators a consumer
// thread, the hd-128 kernel's budget, which fits 168 registers without a
// spill (blocks of 192 or 256 columns, fewer blocks, spilled, serialized
// the wgmma and ran slower). Per kv tile of 64 positions each consumer warpgroup
// sums S = sum_c Q_c K_c^T in its wgmma registers over the chunks
// (m64n64k16, A and B in shared memory), runs the online softmax once,
// then adds P_hi V + P_lo V over its NB columns (m64n128k16, A = P from
// registers). The producer warpgroup copies each q chunk with
// cp.async (a folded row's q lies on no stride TMA could walk: the G heads
// of a position, then the next position H heads on), 16 bytes a thread,
// into the 128-byte swizzle, and lane 0 of it loads each k chunk and the
// tile's v columns by TMA; q/k chunks go through a ring of as many stages
// as shared memory leaves beside two v stages, each full barrier counting
// the producer's 128 cp.async arrivals and one expect_tx. The consumers
// fence the generic proxy's copies before wgmma reads them. Every column
// block recomputes S, so with n_cb = ceil(hd / 128) blocks the products
// cost (n_cb + 2) / 2 times the bound's: 3.5x at hd 576 (5 blocks, the
// last half used) and 5x at 1,024 (S once per block, P.V twice for hi +
// lo); q crosses L2 once per kv tile and column block. Column block 0
// writes lse; the output leaves straight from the accumulators in 4-byte
// stores.
//
// flash_kernel_tf32x3 (fp32, hd a multiple of 32) runs the backward's
// split (csrc/tf32x3.cuh): an fp32 operand is hi, the raw value (the
// tensor core reads it as its TF32 truncation), and lo = tf32(x -
// trunc(x)); a product is hi hi' + hi lo' + lo hi'. The tensor core's fp32
// accumulation truncates, so every chain is short and fresh: S a 32-column
// chunk of hd at a time (12 wgmma m64n64k8 .tf32), P V a 64-position kv
// tile at a time (24 mma.sync m16n8k8 .tf32 an n8 block), each added in
// fp32. A block owns 64 rows of one query head, not the G heads of a kv
// head folded: the position-indexed tensor maps of the backward serve
// unchanged (a folded row's q lies on no TMA stride), at the cost of k and
// v crossing L2 once per query head. Two warpgroups (256 threads keep
// ptxas's 255-register budget; a producer warpgroup would cut it to 168)
// share one three-stage TMA ring of 64 KB stages, each four 32-column
// chunks and their lo parts, which the block writes beside a landed stage
// while the previous stage's products run. Per kv tile: ceil(hd / 64)
// product steps, in which warpgroup w forms chunk 2s + w of S and adds it
// in fp32 to its share (registers), which it leaves in an exchange tile of
// shared memory after the last; then output steps of 64 columns, the first
// of which adds the two shares (S = S_0 + S_1, the same bits in both),
// and both run the online softmax on the whole S (the same m, l and P),
// rescale their accumulators and add P V over their own columns, P in the
// accumulator layout as mma.sync's A fragment (k permuted within each
// group of 8 on the B side) and v MN-major. A block owns 2 WC output
// columns: 128 up to hd 128 and 256 up to 256, so S is formed once per
// tile pair, and 512 above, in n_cb = ceil(hd / 512) column blocks that
// each form S again: (n_cb + 1) / 2 of the bound's products, 1.5x at hd
// 576 and 1,024. Per visited 64 x 64 tile pair and column block it
// requests q's and k's 64 rows over the full width and v's over its
// columns, 256 (2 n_cb hd + hd) bytes: at qwen1.5-110b's prefill (B=4,
// S=1,024, 64 heads, causal) 3.42 / 6.85 / 25.7 / 45.6 GB at hd 128 / 256
// / 576 / 1,024, a model from the shapes (chip_smoke.py x3_fwd_work), not
// measured. Blocks run (column block, head, batch, q tile), the heaviest
// causal q tiles first. The scale is applied after the product, in the
// log2 domain, with ex2.approx, as the bf16 kernels do; the CPU model in
// tests/test_torch_fwd_kernels.py holds that (and q scaled first, and exp2
// off by 2^-21 either way) within the fp32 gates against JAX. Warpgroup 0
// of column block 0 writes lse.
//
// flash_kernel (CUDA cores, either dtype; the fp32 yardstick): one block of
// 256 threads per (q tile, kv head, batch). A tile holds 64 folded rows (8 positions at G = 8); each row
// belongs to 4 threads. The block copies its q rows (scaled, fp32) into
// shared memory once, then streams kv tiles of 32 positions through shared
// memory from the first tile the window can see to the causal bound of its
// last row. Per tile, each thread computes 8 scores of its row (16-byte
// shared loads along hd), the row's max and sum combine across its 4
// threads by shuffles, the probabilities go to shared memory, and each
// thread adds them times v into its hd / 4 output columns. As the Pallas
// kernel does, q is scaled by 1/sqrt(hd) before the product (the plain
// version scales the scores after it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 64;                   // folded q rows per block
constexpr int kLanes = kThreads / kRows;    // threads per row
constexpr int kCols = 32;                   // kv positions per tile
constexpr int kColsPerLane = kCols / kLanes;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;            // a block's dynamic opt-in bytes

static_assert(kLanes == 4, "the shuffles below combine 4 lanes");

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

// Shared memory, in floats: q [kRows][HD + 4], k [kCols][HD + 4],
// v [kCols][HD], p [kRows][kCols + 4]. The +4 keeps rows 16-byte aligned and
// spreads a warp's rows over the banks.
template <int HD>
struct Smem {
  static constexpr int kQK = HD + 4;
  static constexpr int kP = kCols + 4;
  static constexpr int kQ = kRows * kQK;
  static constexpr int kK = kCols * kQK;
  static constexpr int kV = kCols * HD;
  static constexpr int kPs = kRows * kP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kPs);
  static_assert(kBytes <= kMaxSmem, "over the 227 KB a block may opt in to");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int H, int Kv, int causal,
                 int window, float scale) {
  using S = Smem<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;
  float* Vs = Ks + S::kK;
  float* Ps = Vs + S::kV;

  const int G = H / Kv;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int64_t n_rows = static_cast<int64_t>(seq) * G;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int tr = threadIdx.x / kLanes;        // row within the tile
  const int lane = threadIdx.x % kLanes;
  const int64_t row = r0 + tr;
  const bool row_ok = row < n_rows;
  const int qpos = row_ok ? static_cast<int>(row / G) : 0;

  // q rows of this tile, scaled, as fp32 (zeros past the last row)
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int rr = idx / HD, d = idx % HD;
    const int64_t grow = r0 + rr;
    float val = 0.0f;
    if (grow < n_rows) {
      const int64_t qi = grow / G, g = grow % G;
      val = to_float(q[((b * static_cast<int64_t>(seq) + qi) * H +
                        static_cast<int64_t>(kvh) * G + g) * HD + d]) *
            scale;
    }
    Qs[rr * S::kQK + d] = val;
  }

  // kv tiles this q tile can see: from the window's lower bound of its first
  // position to the causal bound of its last
  const int64_t last_row = (r0 + kRows < n_rows ? r0 + kRows : n_rows) - 1;
  const int q_lo = static_cast<int>(r0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int kv_end = causal ? min(seq, q_hi + 1) : seq;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kCols;
  const int t_end = (kv_end + kCols - 1) / kCols;

  float m = kNegInf, l = 0.0f;
  float acc[HD / kLanes];   // columns 16 * i + 4 * lane + e, i < HD / 16
#pragma unroll
  for (int i = 0; i < HD / kLanes; ++i) acc[i] = 0.0f;

  const float* qrow = Qs + tr * S::kQK;
  float* prow = Ps + tr * S::kP;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kCols;
    __syncthreads();   // q is written; the previous tile is read
    for (int idx = threadIdx.x; idx < kCols * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int kp = k0 + c;
      float kval = 0.0f, vval = 0.0f;
      if (kp < seq) {
        const int64_t off =
            ((b * static_cast<int64_t>(seq) + kp) * Kv + kvh) * HD + d;
        kval = to_float(k[off]);
        vval = to_float(v[off]);
      }
      Ks[c * S::kQK + d] = kval;
      Vs[c * HD + d] = vval;
    }
    __syncthreads();

    // scores of this thread's columns lane + 4 * c
    float s[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) s[c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const float4 ka = *reinterpret_cast<const float4*>(
            Ks + (lane + kLanes * c) * S::kQK + d);
        s[c] = fmaf(qa.x, ka.x, s[c]);
        s[c] = fmaf(qa.y, ka.y, s[c]);
        s[c] = fmaf(qa.z, ka.z, s[c]);
        s[c] = fmaf(qa.w, ka.w, s[c]);
      }
    }

    // mask, then the online softmax over the row's 4 threads
    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int kp = k0 + lane + kLanes * c;
      bool ok = kp < seq;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[c] = ok ? s[c] : kNegInf;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      s[c] = expf(s[c] - m_new);
      psum += s[c];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) prow[lane + kLanes * c] = s[c];
    __syncthreads();

    // acc = acc * alpha + p @ v over this thread's columns
#pragma unroll
    for (int i = 0; i < HD / kLanes; ++i) acc[i] *= alpha;
    const float* vcol = Vs + 4 * lane;
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        const float4 va =
            *reinterpret_cast<const float4*>(vcol + j * HD + 16 * i);
        acc[4 * i + 0] = fmaf(p, va.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, va.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, va.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, va.w, acc[4 * i + 3]);
      }
    }
  }

  if (!row_ok) return;
  const float l_safe = l == 0.0f ? 1.0f : l;
  const int64_t qi = row / G, g = row % G;
  if (lse != nullptr && lane == 0)
    lse[(b * static_cast<int64_t>(H) + static_cast<int64_t>(kvh) * G + g) *
            seq + qi] = m + logf(l_safe);
  T* orow = o + ((b * static_cast<int64_t>(seq) + qi) * H +
                 static_cast<int64_t>(kvh) * G + g) * HD;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      orow[16 * i + 4 * lane + e] = from_float<T>(acc[4 * i + e] / l_safe);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int seq, int H, int Kv, int causal,
              int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), Kv, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, H, Kv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Any head width (the wrapper sends those above the widest tier): the
// same tiles, rows and online softmax as flash_kernel, but hd is a runtime
// value and neither q nor an output row lives in a thread whole. A block
// owns kChunkCols output columns of its q tile (blockIdx.x = q tile *
// column chunks + chunk). Per kv tile it sums each score over hd in chunks
// of kChunkD columns (q scaled and k staged in shared memory a chunk at a
// time), then runs the softmax and adds P times its columns of v. Each
// column chunk's block recomputes the scores, so the products q k cost
// ceil(hd / kChunkCols) times over: exact, simple, not fast.
constexpr int kChunkD = 64;                 // hd columns a score step sums
constexpr int kChunkCols = 128;             // output columns a block owns

struct ChunkSmem {
  static constexpr int kQK = kChunkD + 4;
  static constexpr int kP = kCols + 4;
  static constexpr int kQ = kRows * kQK;
  static constexpr int kK = kCols * kQK;
  static constexpr int kV = kCols * kChunkCols;
  static constexpr int kPs = kRows * kP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kPs);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel_chunked(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int seq, int H, int Kv,
                         long long hd, int causal, int window, float scale,
                         int n_chunks) {
  using S = ChunkSmem;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;
  float* Vs = Ks + S::kK;
  float* Ps = Vs + S::kV;

  const int G = H / Kv;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x % n_chunks) *
                       kChunkCols;
  const int64_t n_rows = static_cast<int64_t>(seq) * G;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / n_chunks) * kRows;
  const int tr = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t row = r0 + tr;
  const bool row_ok = row < n_rows;
  const int qpos = row_ok ? static_cast<int>(row / G) : 0;
  // element offset of each folded row's q (and out) row, -1 past the last
  __shared__ int64_t row_off[kRows];
  if (threadIdx.x < kRows) {
    const int64_t grow = r0 + threadIdx.x;
    row_off[threadIdx.x] =
        grow < n_rows ? ((b * static_cast<int64_t>(seq) + grow / G) * H +
                         static_cast<int64_t>(kvh) * G + grow % G) * hd
                      : -1;
  }
  __syncthreads();

  const int64_t last_row = (r0 + kRows < n_rows ? r0 + kRows : n_rows) - 1;
  const int q_lo = static_cast<int>(r0 / G);
  const int q_hi = static_cast<int>(last_row / G);
  const int kv_end = causal ? min(seq, q_hi + 1) : seq;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kCols;
  const int t_end = (kv_end + kCols - 1) / kCols;

  float m = kNegInf, l = 0.0f;
  float acc[kChunkCols / kLanes];  // columns c0 + 16 * i + 4 * lane + e
#pragma unroll
  for (int i = 0; i < kChunkCols / kLanes; ++i) acc[i] = 0.0f;
  const float* qrow = Qs + tr * S::kQK;
  float* prow = Ps + tr * S::kP;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kCols;
    float s[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) s[c] = 0.0f;
    for (long long d0 = 0; d0 < hd; d0 += kChunkD) {
      __syncthreads();   // the last chunk (or tile) is read
      for (int idx = threadIdx.x; idx < kRows * kChunkD; idx += kThreads) {
        const int rr = idx / kChunkD, d = idx % kChunkD;
        const int64_t off = row_off[rr];
        Qs[rr * S::kQK + d] = off >= 0 && d0 + d < hd
                                  ? to_float(q[off + d0 + d]) * scale
                                  : 0.0f;
      }
      for (int idx = threadIdx.x; idx < kCols * kChunkD; idx += kThreads) {
        const int c = idx / kChunkD, d = idx % kChunkD;
        const int kp = k0 + c;
        float kval = 0.0f;
        if (kp < seq && d0 + d < hd)
          kval = to_float(k[((b * static_cast<int64_t>(seq) + kp) * Kv + kvh) *
                                hd + d0 + d]);
        Ks[c * S::kQK + d] = kval;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kChunkD; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const float4 ka = *reinterpret_cast<const float4*>(
              Ks + (lane + kLanes * c) * S::kQK + d);
          s[c] = fmaf(qa.x, ka.x, s[c]);
          s[c] = fmaf(qa.y, ka.y, s[c]);
          s[c] = fmaf(qa.z, ka.z, s[c]);
          s[c] = fmaf(qa.w, ka.w, s[c]);
        }
      }
    }

    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int kp = k0 + lane + kLanes * c;
      bool ok = kp < seq;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[c] = ok ? s[c] : kNegInf;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      s[c] = expf(s[c] - m_new);
      psum += s[c];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) prow[lane + kLanes * c] = s[c];
    // this block's columns of the tile's v
    for (int idx = threadIdx.x; idx < kCols * kChunkCols; idx += kThreads) {
      const int c = idx / kChunkCols, d = idx % kChunkCols;
      const int kp = k0 + c;
      float vval = 0.0f;
      if (kp < seq && c0 + d < hd)
        vval = to_float(v[((b * static_cast<int64_t>(seq) + kp) * Kv + kvh) *
                              hd + c0 + d]);
      Vs[c * kChunkCols + d] = vval;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kChunkCols / kLanes; ++i) acc[i] *= alpha;
    const float* vcol = Vs + 4 * lane;
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int i = 0; i < kChunkCols / 16; ++i) {
        const float4 va =
            *reinterpret_cast<const float4*>(vcol + j * kChunkCols + 16 * i);
        acc[4 * i + 0] = fmaf(p, va.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, va.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, va.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, va.w, acc[4 * i + 3]);
      }
    }
  }

  if (!row_ok) return;
  const float l_safe = l == 0.0f ? 1.0f : l;
  // every column chunk's block holds the same m and l: the first writes
  if (lse != nullptr && lane == 0 && c0 == 0)
    lse[(b * static_cast<int64_t>(H) + static_cast<int64_t>(kvh) * G +
         row % G) * seq + qpos] = m + logf(l_safe);
  T* orow = o + row_off[tr] + c0;
#pragma unroll
  for (int i = 0; i < kChunkCols / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * i + 4 * lane + e;
      if (c0 + col < hd) orow[col] = from_float<T>(acc[4 * i + e] / l_safe);
    }
}

template <typename T>
int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int seq, int H, int Kv, long long hd,
                   int causal, int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = ChunkSmem::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_chunked<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const int64_t n_chunks = (hd + kChunkCols - 1) / kChunkCols;
  const int64_t blocks = (n_rows + kRows - 1) / kRows * n_chunks;
  if (blocks >= (int64_t{1} << 31) || n_chunks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), Kv, B);
  flash_kernel_chunked<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, H, Kv, hd,
      causal, window, scale, static_cast<int>(n_chunks));
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core kernels of type T: flash_kernel at the built widths
// (16 .. 256), flash_kernel_chunked at any other.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int seq, int H, int Kv, long long hd, int causal,
           int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, lse, B, seq, H, Kv, causal,
                              window, scale, st);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, lse, B, seq, H, Kv, causal,
                              window, scale, st);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, lse, B, seq, H, Kv, causal,
                              window, scale, st);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, lse, B, seq, H, Kv, causal,
                               window, scale, st);
    case 192:
      return launch_hd<T, 192>(q, k, v, o, lse, B, seq, H, Kv, causal,
                               window, scale, st);
    case 256:
      return launch_hd<T, 256>(q, k, v, o, lse, B, seq, H, Kv, causal,
                               window, scale, st);
    default:
      return launch_chunked<T>(q, k, v, o, lse, B, seq, H, Kv, hd, causal,
                               window, scale, st);
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;             // folded q rows a block
constexpr float kLog2e = 1.4426950408889634f;

// Threads a block: the consumer warpgroups and a producer warp
// (flash_kernel_wgmma) or warpgroup (flash_kernel_wgmma_cols, whose
// producer copies q). ptxas budgets either as three warpgroups: 168
// registers a thread (65,536 / 384).
constexpr int threads(bool wg_producer) {
  return (4 * kConsumers + (wg_producer ? 4 : 1)) * 32;
}

// kv positions a tile of flash_kernel_wgmma: 64, and 32 at hd 256, whose
// 128 accumulators leave 40 of the 168 registers: a tile of 32 takes 16
// for its scores and 16 for P hi + lo (tiles of 64 spilled more and ran
// slower on the H100).
constexpr int kv_tile(int hd) { return hd == 256 ? 32 : 64; }

// Shared memory, from a 1024-byte aligned base: q [kChunks][kRows][kCW],
// k and v [kStages][kChunks][KV][kCW], then the barriers. A row of kCW
// bf16 is the swizzle's span (32, 64 or 128 bytes); the ring holds 128 kv
// positions (2 stages of 64 or 4 of 32).
template <int HD, int KV>
struct Cfg {
  static constexpr int kHd = HD;
  static constexpr int kKv = KV;
  static constexpr int kCW = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kCW;
  static constexpr int kChunks = HD / kCW;
  // 16-byte unit ^= address bits 7.. (Swizzle<3|2|1, 4, 3>), as TMA writes
  static constexpr uint32_t kSwz = kRowBytes == 128 ? 7 : kRowBytes == 64 ? 3
                                                                         : 1;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64
                                                                 ? 2
                                                                 : 3;
  static constexpr int kStages = 128 / KV;
  static constexpr int kQChunk = kRows * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKvChunk = KV * kRowBytes;
  static constexpr int kTile = kChunks * kKvChunk;     // one k or v tile
  static constexpr int kBar = kQBytes + 2 * kStages * kTile;
  static constexpr int kSmem = kBar + 2 * kStages * 8 + 1024;
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
  static_assert(kQChunk % 1024 == 0 && kKvChunk % 1024 == 0,
                "swizzled regions must stay 1024-byte aligned");
};

// Descriptors of a q or k region (K-major: hd contiguous) and of a v tile
// (MN-major for P V: hd contiguous, 64-column chunks kKvChunk apart); 8-row
// groups are 8 swizzled rows apart in both.
template <class C>
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return desc(addr, 16, 8 * C::kRowBytes, C::kLayout);
}
template <class C>
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  return desc(addr, C::kKvChunk, 8 * C::kRowBytes, C::kLayout);
}

// The upper 16 bits of x (x truncated to bf16), as a float.
__device__ __forceinline__ float hi_part(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}
// The upper halves of two floats packed as bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t hi_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// S = Q K^T for one warpgroup: 64 q rows x KV kv positions, over hd in
// steps of 16; q and k K-major in shared memory, given by the descriptors
// of their first byte (a step adds its byte offset / 16 to the address
// field).
template <class C>
__device__ __forceinline__ void issue_qk(float (&sc)[C::kKv / 2],
                                         uint64_t dq, uint64_t dk) {
  constexpr int kStepsPerChunk = C::kCW / 16;
#pragma unroll
  for (int kk = 0; kk < C::kHd / 16; ++kk) {
    const int c = kk / kStepsPerChunk, w = kk % kStepsPerChunk;
    wgmma_ss(sc, dq + ((c * C::kQChunk + 32 * w) >> 4),
             dk + ((c * C::kKvChunk + 32 * w) >> 4), kk > 0);
  }
}

// O += P_hi V + P_lo V over a tile's KV positions in steps of 16; dv is
// the v tile's descriptor (MN-major, N = the accumulator's columns).
template <int N, int KV, int kRowBytes>
__device__ __forceinline__ void issue_pv(float (&acc)[N / 2],
                                         const uint32_t (&p_hi)[KV / 4],
                                         const uint32_t (&p_lo)[KV / 4],
                                         uint64_t dv) {
#pragma unroll
  for (int t = 0; t < KV / 16; ++t) {
    const uint32_t a[4] = {p_hi[4 * t], p_hi[4 * t + 1], p_hi[4 * t + 2],
                           p_hi[4 * t + 3]};
    wgmma_rs(acc, a, dv + ((t * 16 * kRowBytes) >> 4));
  }
#pragma unroll
  for (int t = 0; t < KV / 16; ++t) {
    const uint32_t a[4] = {p_lo[4 * t], p_lo[4 * t + 1], p_lo[4 * t + 2],
                           p_lo[4 * t + 3]};
    wgmma_rs(acc, a, dv + ((t * 16 * kRowBytes) >> 4));
  }
}

// The online softmax of one thread's two rows (a, b = a + 8) over a tile,
// in the log2 domain: m, l (this thread's share of the row sum, summed
// across the row's 4 threads at the end) and the rescale factors of the
// last tile.
struct Softmax {
  int qpos_a, qpos_b, wq_lo, wq_hi, cq, seq, causal, window;
  float scale_log2;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  float alpha_a = 1.0f, alpha_b = 1.0f;

  // The rows of a warpgroup whose first folded row is w0, for the thread
  // at (warp, lane) of it: a = lane / 4 of the warp's 16, b = a + 8.
  __device__ __forceinline__ Softmax(int w0, int warp, int lane, int n_rows,
                                     int G, int seq_, int causal_,
                                     int window_, float scale_log2_)
      : qpos_a((w0 + 16 * (warp % 4) + lane / 4) / G),
        qpos_b((w0 + 16 * (warp % 4) + lane / 4 + 8) / G),
        wq_lo(min(w0, n_rows - 1) / G),
        wq_hi(min(w0 + 63, n_rows - 1) / G),
        cq(2 * (lane % 4)),
        seq(seq_),
        causal(causal_),
        window(window_),
        scale_log2(scale_log2_) {}

  // The scores of the tile at k0 into P = 2^(s * scale_log2 - m), as bf16
  // hi + lo in wgmma's A-register layout: the j-th n8 block of S gives
  // registers 2j (row a) and 2j + 1 (row b). A tile with every position
  // visible to every row takes the max on the raw scores (scaling by a
  // positive number keeps the order) and one FFMA a score into ex2; a tile
  // that crosses the diagonal, the window's lower edge or S is scaled
  // first and masked with -1e30 in the scaled domain, as _fa_kernel does
  // (an FFMA on a raw -1e30 would leave a rounding residue of ~1e21).
  template <int KV>
  __device__ __forceinline__ void tile(float (&sc)[KV / 2],
                                       uint32_t (&p_hi)[KV / 4],
                                       uint32_t (&p_lo)[KV / 4], int k0) {
    const float c = rows_max<KV>(sc, k0);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      const float pa0 = ex2(fmaf(sc[4 * j], c, -m_a));
      const float pa1 = ex2(fmaf(sc[4 * j + 1], c, -m_a));
      const float pb0 = ex2(fmaf(sc[4 * j + 2], c, -m_b));
      const float pb1 = ex2(fmaf(sc[4 * j + 3], c, -m_b));
      sum_a += pa0 + pa1;
      sum_b += pb0 + pb1;
      p_hi[2 * j] = hi_pair(pa0, pa1);
      p_hi[2 * j + 1] = hi_pair(pb0, pb1);
      p_lo[2 * j] = bf16x2(pa0 - hi_part(pa0), pa1 - hi_part(pa1));
      p_lo[2 * j + 1] = bf16x2(pb0 - hi_part(pb0), pb1 - hi_part(pb1));
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  }

  // tile's first part: the masking, each row's new max m and alpha; the
  // factor the exponent's FMA takes (scale_log2, or 1 once scaled).
  template <int KV>
  __device__ __forceinline__ float rows_max(float (&sc)[KV / 2], int k0) {
    const bool whole = k0 + KV <= seq &&
                       (!causal || k0 + KV - 1 <= wq_lo) &&
                       (window <= 0 || k0 > wq_hi - window);
    float c = scale_log2;
    if (!whole) {
#pragma unroll
      for (int j = 0; j < KV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + cq + e;
          bool ok_a = kp < seq, ok_b = kp < seq;
          if (causal) {
            ok_a = ok_a && kp <= qpos_a;
            ok_b = ok_b && kp <= qpos_b;
          }
          if (window > 0) {
            ok_a = ok_a && kp > qpos_a - window;
            ok_b = ok_b && kp > qpos_b - window;
          }
          sc[4 * j + e] = ok_a ? sc[4 * j + e] * c : kNegInf;
          sc[4 * j + 2 + e] = ok_b ? sc[4 * j + 2 + e] * c : kNegInf;
        }
      }
      c = 1.0f;
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a * c);
    const float mn_b = fmaxf(m_b, mx_b * c);
    alpha_a = ex2(m_a - mn_a);
    alpha_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    return c;
  }

  // tile in two parts, for a caller that runs the first while a P V
  // product still reads the last P: the scores into p, in place (fp32), m,
  // l and alpha updated, the same arithmetic as tile's ... (tile keeps its
  // fused loop: built as probs then pack, it made ptxas serialize
  // flash_kernel_wgmma_cols's wgmma, C7518)
  template <int KV>
  __device__ __forceinline__ void probs(float (&sc)[KV / 2], int k0) {
    const float c = rows_max<KV>(sc, k0);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], c, -m_a));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], c, -m_a));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], c, -m_b));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], c, -m_b));
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  }

  // ... and, once that product is done, p as bf16 hi + lo in wgmma's
  // A-register layout.
  template <int KV>
  __device__ __forceinline__ void pack(const float (&p)[KV / 2],
                                       uint32_t (&p_hi)[KV / 4],
                                       uint32_t (&p_lo)[KV / 4]) const {
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      p_hi[2 * j] = hi_pair(p[4 * j], p[4 * j + 1]);
      p_hi[2 * j + 1] = hi_pair(p[4 * j + 2], p[4 * j + 3]);
      p_lo[2 * j] = bf16x2(p[4 * j] - hi_part(p[4 * j]),
                           p[4 * j + 1] - hi_part(p[4 * j + 1]));
      p_lo[2 * j + 1] = bf16x2(p[4 * j + 2] - hi_part(p[4 * j + 2]),
                               p[4 * j + 3] - hi_part(p[4 * j + 3]));
    }
  }

  // O *= alpha, row by row, before the tile's P V joins it.
  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }
  }

  // After the last tile: 1 / l of rows a and b (l summed across each row's
  // 4 threads; l = 1 where it is 0), and, given a non-null lse, each row's
  // log-sum-exp, written by one thread of its 4. m and l are in the log2
  // domain of the scaled scores: the natural log-sum-exp is ln 2 * (m +
  // log2 l).
  __device__ __forceinline__ void finish(float (&inv)[2], float* lse,
                                         int row_a, int n_rows, int G,
                                         int H, int kvh, int b, int lane) {
    float la = l_a, lb = l_b;
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    la = la == 0.0f ? 1.0f : la;
    lb = lb == 0.0f ? 1.0f : lb;
    inv[0] = 1.0f / la;
    inv[1] = 1.0f / lb;
    if (lse == nullptr || lane % 4 != 0) return;
    constexpr float kLn2 = 0.6931471805599453f;
    const float ms[2] = {m_a, m_b}, ls[2] = {la, lb};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= n_rows) continue;
      const int pos = row / G, g = row - pos * G;
      lse[(b * static_cast<int64_t>(H) + static_cast<int64_t>(kvh) * G + g) *
              seq + pos] = kLn2 * (ms[half] + log2f(ls[half]));
    }
  }
};

// The block's (q tile, column block, kv head, batch entry): q tiles from
// the last when causal (the heaviest first, so the last wave holds the
// short ones), each over every column block, kv head and batch entry.
struct BlockPos {
  int qt, cb, kvh, b;
  __device__ __forceinline__ BlockPos(int n_qtiles, int n_cb, int Kv,
                                      int causal) {
    const int per_tile = gridDim.x / n_qtiles;
    const int qt_lin = blockIdx.x / per_tile;
    const int rest = blockIdx.x % per_tile;
    qt = causal ? n_qtiles - 1 - qt_lin : qt_lin;
    cb = rest % n_cb;
    kvh = rest / n_cb % Kv;
    b = rest / n_cb / Kv;
  }
};

// A warpgroup's 64 output rows from w0 (acc times 1 / l, bf16) through its
// q region, which its wgmma reads no more, in the region's swizzled layout,
// so the 4-byte writes of the accumulator layout meet no bank conflicts;
// then whole rows leave in 16-byte pieces, none from row_end on.
template <class C>
__device__ __forceinline__ void store_out(const float (&acc)[C::kHd / 2],
                                          const float (&inv)[2],
                                          uint8_t* smem,
                                          __nv_bfloat16* __restrict__ o,
                                          int wg, int w0, int row_end,
                                          int seq, int H, int G, int kvh,
                                          int b) {
  constexpr int HD = C::kHd;
  constexpr int kVecs = HD / 8;                 // 16-byte pieces of a row
  constexpr int kPer = 64 * kVecs / 128;        // pieces a thread
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 8 * j + 2 * (lane % 4);
      const int r = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * half;
      uint32_t off = (col / C::kCW) * C::kQChunk + r * C::kRowBytes +
                     (col % C::kCW) * 2;
      off ^= ((off >> 7) & C::kSwz) << 4;
      *reinterpret_cast<uint32_t*>(smem + off) =
          bf16x2(acc[4 * j + 2 * half] * inv[half],
                 acc[4 * j + 2 * half + 1] * inv[half]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int idx = tid + 128 * u;
    const int row = w0 + idx / kVecs;
    if (row >= row_end) continue;
    const int col = (idx % kVecs) * 8;
    uint32_t off = (col / C::kCW) * C::kQChunk +
                   (64 * wg + idx / kVecs) * C::kRowBytes + (col % C::kCW) * 2;
    off ^= ((off >> 7) & C::kSwz) << 4;
    const int pos = row / G, g = row - pos * G;
    __nv_bfloat16* orow = o + ((b * static_cast<int64_t>(seq) + pos) * H +
                               static_cast<int64_t>(kvh) * G + g) * HD;
    *reinterpret_cast<uint4*>(orow + col) =
        *reinterpret_cast<const uint4*>(smem + off);
  }
}

template <int HD, int KV>
__global__ void __launch_bounds__(threads(false), 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int seq, int H, int Kv, int causal, int window,
                       float scale_log2, int n_qtiles) {
  using C = Cfg<HD, KV>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::kQBytes;
  const uint32_t sV = sK + kStages * C::kTile;
  const uint32_t full = base + C::kBar;         // kStages barriers of 8 bytes
  const uint32_t empty = full + 8 * kStages;

  const BlockPos at(n_qtiles, 1, Kv, causal);
  const int kvh = at.kvh, b = at.b;

  const int G = H / Kv;
  // row indices fit in 32 bits (S * H < 2^31, the wrapper checks), and
  // 32-bit division is several times cheaper than 64-bit
  const int n_rows = seq * G;
  const int r0 = at.qt * kRows;
  const int last_row = min(r0 + kRows, n_rows) - 1;
  const int kv_end = causal ? min(seq, last_row / G + 1) : seq;
  const int kv_begin = window > 0 ? max(0, r0 / G - window + 1) : 0;
  const int t_begin = kv_begin / KV;
  const int n_t = (kv_end + KV - 1) / KV - t_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // consumers: warpgroup wg owns folded rows w0 .. w0 + 63; their q loads
  // go out before the barriers are set up
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int w0 = r0 + 64 * wg;
  // all of a thread's loads in flight at once, then the swizzled stores
  constexpr int kVecs = HD / 8;                 // 16-byte pieces of a row
  constexpr int kPer = 64 * kVecs / 128;        // pieces a thread
  uint4 qv[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (wg == kConsumers) break;
    const int idx = tid + 128 * u;
    const int row = w0 + idx / kVecs;
    qv[u] = make_uint4(0, 0, 0, 0);
    if (row < n_rows) {
      const int pos = row / G, g = row - pos * G;
      qv[u] = *reinterpret_cast<const uint4*>(
          q + ((b * static_cast<int64_t>(seq) + pos) * H +
               static_cast<int64_t>(kvh) * G + g) * HD + (idx % kVecs) * 8);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kStages;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kTile);
        const int k0 = (t_begin + i) * KV;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const int col = kvh * HD + c * C::kCW;
          tma_load(sK + s * C::kTile + c * C::kKvChunk, &kmap, full + 8 * s,
                   col, k0, b);
          tma_load(sV + s * C::kTile + c * C::kKvChunk, &vmap, full + 8 * s,
                   col, k0, b);
        }
      }
    }
    return;
  }

  // the stores of the q pieces loaded at the start, swizzled
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int idx = tid + 128 * u;
    const int col = (idx % kVecs) * 8;
    uint32_t off = (col / C::kCW) * C::kQChunk +
                   (64 * wg + idx / kVecs) * C::kRowBytes + (col % C::kCW) * 2;
    off ^= ((off >> 7) & C::kSwz) << 4;
    *reinterpret_cast<uint4*>(smem + off) = qv[u];
  }
  // the generic-proxy stores, before the async proxy (wgmma) reads them
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  const int row_a = w0 + 16 * (warp % 4) + lane / 4;   // and row_a + 8
  Softmax sm(w0, warp, lane, n_rows, G, seq, causal, window, scale_log2);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const uint64_t dq = k_major<C>(sQ + 64 * wg * C::kRowBytes);
  float sc[KV / 2];
  uint32_t p_hi[KV / 4], p_lo[KV / 4];

  for (int i = 0; i < n_t; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_qk<C>(sc, dq, k_major<C>(sK + s * C::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    sm.tile<KV>(sc, p_hi, p_lo, (t_begin + i) * KV);
    sm.rescale(acc);
    wgmma_fence();
    issue_pv<HD, KV, C::kRowBytes>(acc, p_hi, p_lo,
                                   mn_major<C>(sV + s * C::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  float inv[2];
  sm.finish(inv, lse, row_a, n_rows, G, H, kvh, b, lane);
  store_out<C>(acc, inv, smem, o, wg, w0, n_rows, seq, H, G, kvh, b);
}

// ---------------------------------------------------------------------------
// bf16 at hd 192: two warpgroups, no producer, a three-stage ring
// ---------------------------------------------------------------------------

// flash_kernel_wgmma_pipe's shared memory, from a 1024-byte aligned base:
// q [kChunks][kRows][64] as Cfg lays it out, a ring of three stages of k
// and v tiles of 64 positions (k [3][kChunks][64][64], then v likewise),
// the stages' full barriers, q's barrier and a count of the warps that
// have released each stage: 192 KB at hd 192.
template <int HD>
struct PipeCfg : Cfg<HD, 64> {
  using Base = Cfg<HD, 64>;
  static constexpr int kStages = 3;
  static constexpr int kBar = Base::kQBytes + 2 * kStages * Base::kTile;
  static constexpr int kQBar = kBar + 8 * kStages;
  static constexpr int kReleased = kQBar + 8;
  static constexpr int kSmem = kReleased + 4 * kStages + 1024;
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
};

template <int HD>
__global__ void __launch_bounds__(2 * 128, 1)
    flash_kernel_wgmma_pipe(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int seq, int H, int Kv,
                            int causal, int window, float scale_log2,
                            int n_qtiles, int tile_rows) {
  using C = PipeCfg<HD>;
  constexpr int KV = C::kKv;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::kQBytes;
  const uint32_t sV = sK + kStages * C::kTile;
  const uint32_t full = base + C::kBar;         // kStages barriers of 8 bytes
  const uint32_t qbar = base + C::kQBar;
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + C::kReleased);

  const BlockPos at(n_qtiles, 1, Kv, causal);
  const int kvh = at.kvh, b = at.b;
  const int G = H / Kv;
  const int n_rows = seq * G;
  // the tile's folded rows r0 .. row_end - 1: whole positions (or one
  // position's share of its G rows), as its q box holds them
  const int r0 = at.qt * tile_rows;
  const int row_end = min(r0 + tile_rows, n_rows);
  const int kv_end = causal ? min(seq, (row_end - 1) / G + 1) : seq;
  const int kv_begin = window > 0 ? max(0, r0 / G - window + 1) : 0;
  const int t_begin = kv_begin / KV;
  const int n_t = (kv_end + KV - 1) / KV - t_begin;

  // k and v of tile i into stage i % kStages, by one thread
  const auto load = [&](int i) {
    const int s = i % kStages;
    mbar_expect_tx(full + 8 * s, 2 * C::kTile);
    const int k0 = (t_begin + i) * KV;
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      const int col = kvh * HD + c * C::kCW;
      tma_load(sK + s * C::kTile + c * C::kKvChunk, &kmap, full + 8 * s, col,
               k0, b);
      tma_load(sV + s * C::kTile + c * C::kKvChunk, &vmap, full + 8 * s, col,
               k0, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // q: one box a 64-column chunk, rows past S as zeros
    mbar_expect_tx(qbar, C::kChunks * tile_rows * C::kRowBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(sQ + c * C::kQChunk, &qmap, qbar, c * C::kCW,
                  kvh * G + r0 % G, r0 / G, b);
    for (int i = 0; i < min(kStages, n_t); ++i) load(i);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it as uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int w0 = r0 + 64 * wg;
  const int row_a = w0 + 16 * (warp % 4) + lane / 4;   // and row_a + 8
  Softmax sm(w0, warp, lane, row_end, G, seq, causal, window, scale_log2);
  // once every warp of the block is done with tile i, the last to get here
  // loads tile i + kStages into its stage
  const auto release = [&](int i) {
    if (lane == 0) {
      __threadfence_block();
      const uint32_t n = atomicAdd(released + i % kStages, 1u);
      if (n % 8 == 7 && i + kStages < n_t) {
        __threadfence_block();
        load(i + kStages);
      }
    }
  };

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const uint64_t dq = k_major<C>(sQ + 64 * wg * C::kRowBytes);
  float sc[KV / 2];
  uint32_t p_hi[KV / 4], p_lo[KV / 4];
  mbar_wait(qbar, 0);

  // tile 0's S and P; then each step issues S of tile i and P V of tile
  // i - 1 together and runs tile i's softmax while P V is on the tensor
  // cores; the accumulator takes tile i's rescale once P V is in
  mbar_wait(full, 0);
  wgmma_fence();
  issue_qk<C>(sc, dq, k_major<C>(sK));
  wgmma_commit();
  wgmma_wait<0>();
  pin(sc);
  sm.tile<KV>(sc, p_hi, p_lo, t_begin * KV);
  for (int i = 1; i < n_t; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_qk<C>(sc, dq, k_major<C>(sK + s * C::kTile));
    wgmma_commit();
    issue_pv<HD, KV, C::kRowBytes>(
        acc, p_hi, p_lo, mn_major<C>(sV + ((i - 1) % kStages) * C::kTile));
    wgmma_commit();
    wgmma_wait<1>();
    pin(sc);
    sm.probs<KV>(sc, (t_begin + i) * KV);
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    release(i - 1);
    sm.rescale(acc);
    sm.pack<KV>(sc, p_hi, p_lo);
  }
  wgmma_fence();
  issue_pv<HD, KV, C::kRowBytes>(
      acc, p_hi, p_lo, mn_major<C>(sV + ((n_t - 1) % kStages) * C::kTile));
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(p_hi);
  pin(p_lo);

  float inv[2];
  sm.finish(inv, lse, row_a, row_end, G, H, kvh, b, lane);
  store_out<C>(acc, inv, smem, o, wg, w0, row_end, seq, H, G, kvh, b);
}

// ---------------------------------------------------------------------------
// bf16 above hd 256: tensor cores in column blocks
// ---------------------------------------------------------------------------

// flash_kernel_wgmma_cols: the output columns a block owns and the kv
// positions a tile (64 accumulators, 32 scores and 32 P registers a
// consumer thread, as at hd 128; wider blocks spilled and serialized the
// wgmma at the 168-register budget). Shared memory, from a 1024-byte
// aligned base: a ring of kQkStages stages, each a q chunk [kRows][64] and
// a k chunk [KV][64]; a ring of kVStages v tiles [NB / 64][KV][64]; then
// the barriers. Every row is 64 bf16, 128-byte swizzled; the q ring takes
// what the v ring leaves.
struct ColCfg {
  static constexpr int NB = 128;
  static constexpr int KV = 64;
  static constexpr int kRowBytes = 128;
  static constexpr int kQChunk = kRows * kRowBytes;
  static constexpr int kKChunk = KV * kRowBytes;
  static constexpr int kQkStage = kQChunk + kKChunk;
  static constexpr int kVChunk = KV * kRowBytes;
  static constexpr int kVTile = NB / 64 * kVChunk;
  static constexpr int kVStages = 2;
  static constexpr int kQkStages =
      (kMaxSmem - 2048 - kVStages * kVTile) / kQkStage;
  static constexpr int kV = kQkStages * kQkStage;
  static constexpr int kBar = kV + kVStages * kVTile;
  static constexpr int kSmem = kBar + 16 * (kQkStages + kVStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");
  static_assert(kQkStages >= 2, "the q ring needs two stages");
  static_assert(kQChunk % 1024 == 0 && kKChunk % 1024 == 0,
                "swizzled regions must stay 1024-byte aligned");
};

__global__ void __launch_bounds__(threads(true), 1)
    flash_kernel_wgmma_cols(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ q,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int seq, int H, int Kv,
                            int hd, int causal, int window, float scale_log2,
                            int n_qtiles, int n_cb) {
  using C = ColCfg;
  constexpr int NB = C::NB, KV = C::KV;
  using QK = Cfg<64, KV>;               // the q/k chunk layout: 128-byte rows
  constexpr int kQS = C::kQkStages, kVS = C::kVStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sV = base + C::kV;
  const uint32_t qk_full = base + C::kBar;
  const uint32_t qk_empty = qk_full + 8 * kQS;
  const uint32_t v_full = qk_empty + 8 * kQS;
  const uint32_t v_empty = v_full + 8 * kVS;

  const BlockPos at(n_qtiles, n_cb, Kv, causal);
  const int kvh = at.kvh, b = at.b;
  const int c0 = at.cb * NB;                   // the block's first column

  const int G = H / Kv;
  const int n_rows = seq * G;
  const int r0 = at.qt * kRows;
  const int last_row = min(r0 + kRows, n_rows) - 1;
  const int kv_end = causal ? min(seq, last_row / G + 1) : seq;
  const int kv_begin = window > 0 ? max(0, r0 / G - window + 1) : 0;
  const int t_begin = kv_begin / KV;
  const int n_t = (kv_end + KV - 1) / KV - t_begin;
  const int n_c = hd / 64;                     // q and k chunks a tile

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQS; ++s) {
      // the producer's 128 threads' cp.async arrivals, one expect_tx
      mbar_init(qk_full + 8 * s, 129);
      mbar_init(qk_empty + 8 * s, 4 * kConsumers);
    }
    for (int s = 0; s < kVS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: every q chunk by cp.async (thread p copies
    // 16-byte piece p % 8 of rows p / 8 + 16 j, so a warp's copy covers 4
    // whole rows; a folded row's q is not on a stride TMA could walk), k
    // chunks and v tiles by TMA from its first thread
    const int p = threadIdx.x - 128 * kConsumers;
    constexpr int kMine = kRows / 16;
    const __nv_bfloat16* qrow[kMine];
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int row = r0 + p / 8 + 16 * j;
      qrow[j] = q;
      if (row < n_rows) {
        const int pos = row / G, g = row - pos * G;
        qrow[j] = q + ((b * static_cast<int64_t>(seq) + pos) * H +
                       static_cast<int64_t>(kvh) * G + g) * hd + 8 * (p % 8);
        valid |= 1u << j;
      }
    }
    int n = 0;
    for (int i = 0; i < n_t; ++i) {
      const int k0 = (t_begin + i) * KV;
      for (int c = 0; c < n_c; ++c, ++n) {
        const int s = n % kQS;
        mbar_wait(qk_empty + 8 * s, ((n / kQS) & 1) ^ 1);
        const uint32_t st = base + s * C::kQkStage;
        if (p == 0) {
          mbar_expect_tx(qk_full + 8 * s, C::kKChunk);
          tma_load(st + C::kQChunk, &kmap, qk_full + 8 * s, kvh * hd + 64 * c,
                   k0, b);
        }
#pragma unroll
        for (int j = 0; j < kMine; ++j) {
          const int r = p / 8 + 16 * j;
          const uint32_t off = r * 128 + (((p % 8) ^ (r % 8)) << 4);
          cp_async_16(st + off, qrow[j] + 64 * c, (valid >> j & 1u) * 16);
        }
        cp_async_arrive(qk_full + 8 * s);
      }
      const int sv = i % kVS;
      if (p != 0) continue;
      mbar_wait(v_empty + 8 * sv, ((i / kVS) & 1) ^ 1);
      {
        mbar_expect_tx(v_full + 8 * sv, C::kVTile);
#pragma unroll
        for (int cc = 0; cc < NB / 64; ++cc)
          tma_load(sV + sv * C::kVTile + cc * C::kVChunk, &vmap,
                   v_full + 8 * sv, kvh * hd + c0 + 64 * cc, k0, b);
      }
    }
    cp_async_wait_all();
    return;
  }

  const int wg = warp / 4;
  const int w0 = r0 + 64 * wg;
  const int row_a = w0 + 16 * (warp % 4) + lane / 4;   // and row_a + 8
  Softmax sm(w0, warp, lane, n_rows, G, seq, causal, window, scale_log2);
  const int cq = sm.cq;

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.0f;
  float sc[KV / 2];
  uint32_t p_hi[KV / 4], p_lo[KV / 4];

  int n = 0;
  for (int i = 0; i < n_t; ++i) {
    // S = sum over the chunks c of Q_c K_c^T, accumulated in registers;
    // each stage goes back to the producer once the next chunk's products
    // are issued and its own have completed
    for (int c = 0; c < n_c; ++c, ++n) {
      const int s = n % kQS;
      mbar_wait(qk_full + 8 * s, (n / kQS) & 1);
      fence_proxy_async();                 // q arrived by cp.async
      const uint32_t st = base + s * C::kQkStage;
      const uint64_t dq = k_major<QK>(st + 64 * wg * 128);
      const uint64_t dk = k_major<QK>(st + C::kQChunk);
      wgmma_fence();
#pragma unroll
      for (int w = 0; w < 4; ++w)
        wgmma_ss(sc, dq + 2 * w, dk + 2 * w, c > 0 || w > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(qk_empty + 8 * ((n - 1) % kQS));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(qk_empty + 8 * ((n - 1) % kQS));
    pin(sc);
    sm.tile<KV>(sc, p_hi, p_lo, (t_begin + i) * KV);
    sm.rescale(acc);
    const int sv = i % kVS;
    mbar_wait(v_full + 8 * sv, (i / kVS) & 1);
    wgmma_fence();
    issue_pv<NB, KV, 128>(acc, p_hi, p_lo,
                          desc(sV + sv * C::kVTile, C::kVChunk, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(v_empty + 8 * sv);
  }

  // every column block holds the same m and l: the first writes lse
  float inv[2];
  sm.finish(inv, at.cb == 0 ? lse : nullptr, row_a, n_rows, G, H, kvh, b,
            lane);
  // straight from the accumulators: 4-byte stores, 16 contiguous bytes a
  // row's 4 threads (the output is a small share of what a block moves)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
    if (row >= n_rows) continue;
    const int pos = row / G, g = row - pos * G;
    __nv_bfloat16* orow = o + ((b * static_cast<int64_t>(seq) + pos) * H +
                               static_cast<int64_t>(kvh) * G + g) * hd + c0;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      if (c0 + 8 * j >= hd) break;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) =
          bf16x2(acc[4 * j + 2 * half] * inv[half],
                 acc[4 * j + 2 * half + 1] * inv[half]);
    }
  }
}

// A [B][S][width] view of k or v (width = Kv * hd), boxes of `rows`
// positions x `cw` columns, swizzled over rows of 2 * cw bytes (32, 64 or
// 128).
int tensor_map(CUtensorMap* map, const void* ptr, int B, int seq,
               long long width, int cw, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(seq) * width * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cw),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = cw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int seq, int H, int Kv, int causal,
              int window, float scale, cudaStream_t st) {
  constexpr int KV = kv_tile(HD);
  using C = Cfg<HD, KV>;
  CUtensorMap kmap, vmap;
  int err = tensor_map(&kmap, k, B, seq, static_cast<long long>(Kv) * HD,
                       C::kCW, KV);
  if (err == 0)
    err = tensor_map(&vmap, v, B, seq, static_cast<long long>(Kv) * HD,
                     C::kCW, KV);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_wgmma<HD, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const int64_t n_qtiles = (n_rows + kRows - 1) / kRows;
  const int64_t blocks = n_qtiles * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_wgmma<HD, KV><<<static_cast<unsigned>(blocks),
                               threads(false), C::kSmem, st>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, seq, H, Kv, causal, window,
      scale * kLog2e, static_cast<int>(n_qtiles));
  return static_cast<int>(cudaGetLastError());
}

// q [B][S][H][hd] as a 4-D view {hd, H, S, B}: boxes of 64 columns x gh
// heads x np positions, the folded rows of one q tile in their order,
// 128-byte swizzle.
int q_tensor_map(CUtensorMap* map, const void* ptr, int B, int seq, int H,
                 int hd, int gh, int np) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(hd) * 2, static_cast<cuuint64_t>(H) * hd * 2,
      static_cast<cuuint64_t>(seq) * H * hd * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(gh),
                             static_cast<cuuint32_t>(np), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

template <int HD>
int launch_pipe(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int seq, int H, int Kv, int causal,
                int window, float scale, cudaStream_t st) {
  using C = PipeCfg<HD>;
  // a q tile is one TMA box a chunk, from a swizzle atom (1024 bytes):
  // kRows / G whole positions of G folded rows, or, where G is larger,
  // one position's share of them, the widest divisor of G up to kRows
  const int G = H / Kv;
  int gh = G, np = kRows / G;
  if (G > kRows) {
    for (gh = kRows; G % gh; --gh) {
    }
    np = 1;
  }
  const int tile_rows = gh * np;
  CUtensorMap qmap, kmap, vmap;
  int err = q_tensor_map(&qmap, q, B, seq, H, HD, gh, np);
  if (err == 0)
    err = tensor_map(&kmap, k, B, seq, static_cast<long long>(Kv) * HD,
                     C::kCW, C::kKv);
  if (err == 0)
    err = tensor_map(&vmap, v, B, seq, static_cast<long long>(Kv) * HD,
                     C::kCW, C::kKv);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_wgmma_pipe<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(seq) * G;
  const int64_t n_qtiles = (n_rows + tile_rows - 1) / tile_rows;
  const int64_t blocks = n_qtiles * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_wgmma_pipe<HD><<<static_cast<unsigned>(blocks), 2 * 128,
                                C::kSmem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, seq, H, Kv,
      causal, window, scale * kLog2e, static_cast<int>(n_qtiles), tile_rows);
  return static_cast<int>(cudaGetLastError());
}

int launch_cols(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int seq, int H, int Kv, int hd,
                int causal, int window, float scale, cudaStream_t st) {
  using C = ColCfg;
  constexpr int NB = C::NB, KV = C::KV;
  CUtensorMap kmap, vmap;
  const long long width = static_cast<long long>(Kv) * hd;
  int err = tensor_map(&kmap, k, B, seq, width, 64, KV);
  if (err == 0) err = tensor_map(&vmap, v, B, seq, width, 64, KV);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_wgmma_cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const int64_t n_qtiles = (n_rows + kRows - 1) / kRows;
  const int n_cb = (hd + NB - 1) / NB;
  const int64_t blocks = n_qtiles * n_cb * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_wgmma_cols<<<static_cast<unsigned>(blocks), threads(true),
                            C::kSmem, st>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, seq, H, Kv, hd, causal, window,
      scale * kLog2e, static_cast<int>(n_qtiles), n_cb);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int seq, int H, int Kv, long long hd, int causal,
           int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                           scale, st);
    case 32:
      return launch_hd<32>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                           scale, st);
    case 64:
      return launch_hd<64>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                           scale, st);
    case 128:
      return launch_hd<128>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                            scale, st);
    case 192:
      return launch_pipe<192>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                              scale, st);
    case 256:
      return launch_hd<256>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                            scale, st);
    default:
      break;
  }
  // above 256, a multiple of 64: column blocks; TMA's column coordinate is
  // 32-bit
  if (hd <= 256 || hd % 64 || Kv * hd >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cols(q, k, v, o, lse, B, seq, H, Kv, static_cast<int>(hd),
                     causal, window, scale, st);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: tensor cores, each product as three TF32 products (tf32x3), any
// width that is a multiple of 32
// ---------------------------------------------------------------------------

namespace fx3 {

using namespace hopper;
using tf32x3::issue_chunk;
using tf32x3::kChunk;
using tf32x3::kCols;
using tf32x3::kStage;
using tf32x3::kStages;
using tf32x3::kThreads;
using tf32x3::kTile;
using tf32x3::out_chunk;
using tf32x3::split;
using tf32x3::store_rows;
using tf32x3::whole;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kOutCols = 2 * kCols;        // a warpgroup's columns, a step
// Shared memory from a 1024-byte aligned base: three ring stages, two
// exchange tiles [8][kThreads] float4 (each warpgroup's share of S), the
// mbarriers, then the block's Pos: 230,448 bytes, one block an SM.
constexpr int kXchg = kStages * kStage;
constexpr int kXchgTile = 8 * kThreads * 16;
constexpr int kBar = kXchg + 2 * kXchgTile;
constexpr int kPos = kBar + 32;
constexpr int kSmem = kPos + 16 + 1024;
static_assert(kSmem <= kMaxSmem, "over the 227 KB a block may opt in to");

// The tensor maps of q, k and v, one kernel parameter (one pointer to
// carry).
struct Maps {
  CUtensorMap q, k, v;
};

// The block's batch entry, query head, kv head and first output column.
// Thread 0 leaves them in shared memory (kPos) and every use reads them
// back (a volatile load), so that no register carries them through the
// loop beside 128 accumulators (carried, they spilled).
struct Pos {
  int b, h, kvh, c0;
};
template <int WC>
__device__ __forceinline__ Pos block_pos(int H, int Kv, int B, int n_cb) {
  const int rest = blockIdx.x / n_cb, h = rest % H;
  return Pos{rest / H % B, h, h / (H / Kv),
             static_cast<int>(blockIdx.x % n_cb) * 2 * WC};
}
__device__ __forceinline__ void write_pos(uint32_t addr, const Pos& p) {
  asm volatile("st.shared.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(p.b), "r"(p.h), "r"(p.kvh), "r"(p.c0)
               : "memory");
}
__device__ __forceinline__ Pos read_pos(uint32_t addr) {
  Pos p;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(p.b), "=r"(p.h), "=r"(p.kvh), "=r"(p.c0)
               : "r"(addr)
               : "memory");
  return p;
}

// One block: 64 q rows of one query head (position own0 + r), the kv tiles
// of 64 positions its rows see, and the output columns [c0, c0 + 2 WC),
// warpgroup w's the WC from c0 + w WC. Blocks run (column block, head,
// batch, q tile), q tiles heaviest first when causal. Per kv tile, n_p
// product steps (a stage holds q's and k's chunks 2s and 2s + 1 of hd, at
// slots 0, 1 and 2, 3; warpgroup w takes chunk 2s + w), then n_o output
// steps (v's chunks of warpgroup w's columns from 64 u on, at slots 2 w
// and 2 w + 1).
template <int WC>
struct Block {
  int seq, hd, own0, t_begin, n_c, n_p, per, n;

  __device__ __forceinline__ Block(int c0, int H, int B, int seq_, int hd_,
                                   int causal, int window, int n_cb)
      : seq(seq_), hd(hd_) {
    const int n_tiles = (seq + kTile - 1) / kTile;
    const int t_lin = blockIdx.x / n_cb / H / B;
    own0 = (causal ? n_tiles - 1 - t_lin : t_lin) * kTile;
    const int last = min(own0 + kTile, seq) - 1;
    const int lo = window > 0 ? max(0, own0 - window + 1) : 0;
    const int hi = causal ? min(seq, last + 1) : seq;
    t_begin = lo / kTile;
    const int n_t = (hi + kTile - 1) / kTile - t_begin;
    n_c = hd / kCols;
    n_p = (n_c + 1) / 2;
    per = n_p + (cols(c0, 0) + kOutCols - 1) / kOutCols;
    n = n_t * per;
  }
  // warpgroup w's output columns below hd, from the block's first c0
  __device__ __forceinline__ int cols(int c0, int w) const {
    return max(0, min(WC, hd - c0 - w * WC));
  }
  __device__ __forceinline__ int k0(int i) const {
    return (t_begin + i) * kTile;
  }
  // step m into its ring stage, by one thread
  __device__ __forceinline__ void load(int m, uint32_t base, uint32_t full,
                                       const Maps* maps) const {
    const int s = m % per, at = k0(m / per);
    const uint32_t st = base + (m % kStages) * kStage;
    const uint32_t bar = full + 8 * (m % kStages);
    const Pos p = read_pos(base + kPos);
    if (s < n_p) {
      const int two = min(2, n_c - 2 * s);
      mbar_expect_tx(bar, 2 * two * kChunk);
      for (int j = 0; j < two; ++j) {
        const int c = kCols * (2 * s + j);
        tma_load(st + j * kChunk, &maps->q, bar, p.h * hd + c, own0, p.b);
        tma_load(st + (2 + j) * kChunk, &maps->k, bar, p.kvh * hd + c, at,
                 p.b);
      }
    } else {
      const int off = (s - n_p) * kOutCols;
      int chunks = 0;
      for (int w = 0; w < 2; ++w)
        for (int j = 0; j < 2; ++j) chunks += off + j * kCols < cols(p.c0, w);
      mbar_expect_tx(bar, chunks * kChunk);
      for (int w = 0; w < 2; ++w)
        for (int j = 0; j < 2; ++j)
          if (off + j * kCols < cols(p.c0, w))
            tma_load(st + (2 * w + j) * kChunk, &maps->v, bar,
                     p.kvh * hd + p.c0 + w * WC + off + j * kCols, at, p.b);
    }
  }
};

// Barrier 1 over both warpgroups of a block.
__device__ __forceinline__ void both_warpgroups() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The online softmax of this thread's rows a and b = a + 8, in the log2
// domain of the scaled scores.
struct Rows {
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
};

// One warpgroup's loop over the block's steps into acc, its WC columns.
// Each forms its chunks' share of S (x, a fresh 12-product chain a chunk,
// the chunks added in fp32) and leaves it in its exchange tile after the
// last product step; at the first output step both add the other's share
// (S = S_0 + S_1, the same bits in both), and each runs the online softmax
// on the full S (the same m, l and P in both), rescales acc and adds P V
// over its columns. Both split each next stage while the products run;
// warpgroup 0's thread 0 keeps the ring, refilling a stage once both have
// passed the barrier after its step.
template <int WC, int ROLE>
__device__ __forceinline__ void block_loop(
    float (&acc)[WC / 2], Rows& rw, const Block<WC>& bk, uint32_t base,
    uint8_t* sm, float4* xchg, const Maps* maps, int causal,
    int window, float c2) {
  constexpr int kMaxOut = WC / kOutCols;
  const int tid = threadIdx.x % kThreads;
  const uint32_t full = base + kBar;
  const Frag fr;
  float4* mine = xchg + ROLE * 8 * kThreads + tid;
  const float4* theirs = xchg + (1 - ROLE) * 8 * kThreads + tid;
  // this warpgroup's columns, read back where used
  const auto ncols = [&] { return bk.cols(read_pos(base + kPos).c0, ROLE); };
  float x[32];                         // S, then P
  for (int m = 0; m < bk.n; ++m) {
    const int s = m % bk.per, i = m / bk.per;
    const uint32_t st = base + (m % kStages) * kStage;
    const bool product = s < bk.n_p && 2 * s + ROLE < bk.n_c;
    float tx[32];
    if (product) {
      wgmma_fence();
      issue_chunk(tx, st + ROLE * kChunk, st + (2 + ROLE) * kChunk);
      wgmma_commit();
    }
    if (m + 1 < bk.n) {                // the next stage, meanwhile
      const int n = m + 1;
      mbar_wait(full + 8 * (n % kStages), (n / kStages) & 1);
      split(sm + (n % kStages) * kStage);
    }
    if (s < bk.n_p) {
      if (product) {
        wgmma_wait<0>();
        pin(tx);
#pragma unroll
        for (int e = 0; e < 32; ++e) x[e] = s == 0 ? tx[e] : x[e] + tx[e];
      } else if (s == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) x[e] = 0.0f;
      }
      if (s == bk.n_p - 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mine[j * kThreads] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    } else if (ncols() > 0) {
      const int u = s - bk.n_p;
      if (u == 0) {                    // S, then P; acc rescaled
        const int k0 = bk.k0(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 o = theirs[j * kThreads];
          x[4 * j] += o.x;
          x[4 * j + 1] += o.y;
          x[4 * j + 2] += o.z;
          x[4 * j + 3] += o.w;
        }
        // a tile that crosses the diagonal, the window's lower edge or seq
        // is scaled first and masked with -1e30 in the scaled domain; a
        // whole one takes the max on the raw scores and one FMA a score
        float c = c2;
        if (!whole(bk.own0, k0, bk.seq, causal, window)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = bk.own0 + fr.row_a + 8 * (e / 2);
              const int kp = k0 + 8 * j + fr.cq + e % 2;
              const bool ok = qp < bk.seq && kp < bk.seq &&
                              (!causal || kp <= qp) &&
                              (window <= 0 || kp > qp - window);
              x[4 * j + e] = ok ? x[4 * j + e] * c2 : kNegInf;
            }
          c = 1.0f;
        }
        float alpha[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(x[4 * j + 2 * half],
                                 x[4 * j + 2 * half + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(rw.m[half], mx * c);
          alpha[half] = ex2(rw.m[half] - mn);
          rw.m[half] = mn;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& p = x[4 * j + 2 * half + e];
              p = ex2(fmaf(p, c, -mn));
              sum += p;
            }
          rw.l[half] = rw.l[half] * alpha[half] + sum;
        }
#pragma unroll
        for (int j = 0; j < WC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
      }
      const uint8_t* stp = sm + (m % kStages) * kStage + 2 * ROLE * kChunk;
#pragma unroll
      for (int uu = 0; uu < kMaxOut; ++uu)
        if (uu == u)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (uu * kOutCols + j * kCols < ncols())
              out_chunk(acc, uu * 8 + 4 * j, x, stp + j * kChunk);
    }
    both_warpgroups();                 // stage m is read; m + 1 is split
    if (ROLE == 0 && tid == 0 && m + kStages < bk.n)
      bk.load(m + kStages, base, full, maps);
  }
}

// acc / l into out; warpgroup 0 of column block 0 also writes lse = ln 2
// (m + log2 l) of its rows where lse is non-null.
template <int WC>
__device__ __forceinline__ void finish(float (&acc)[WC / 2], Rows& rw,
                                       const Block<WC>& bk, uint32_t base,
                                       float* out, float* lse, int H,
                                       int w) {
  const Frag fr;
  const Pos p = read_pos(base + kPos);
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = rw.l[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = l == 0.0f ? 1.0f : l;
    inv[half] = 1.0f / l;
    const int pos = bk.own0 + fr.row_a + 8 * half;
    if (w == 0 && lse != nullptr && p.c0 == 0 && fr.cq == 0 &&
        pos < bk.seq)
      lse[(static_cast<int64_t>(p.b) * H + p.h) * bk.seq + pos] =
          kLn2 * (rw.m[half] + log2f(l));
  }
#pragma unroll
  for (int j = 0; j < WC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= inv[e / 2];
  const int64_t stride = static_cast<int64_t>(H) * bk.hd;
  store_rows<WC>(acc, out,
                 static_cast<int64_t>(p.b) * bk.seq * stride +
                     static_cast<int64_t>(p.h) * bk.hd + p.c0 + w * WC,
                 stride, bk.own0, bk.seq, fr, bk.cols(p.c0, w));
}

// Two warpgroups (256 threads keep ptxas's 255-register budget) over one
// ring of 64 KB stages.
template <int WC>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_kernel_tf32x3(const __grid_constant__ Maps maps,
                        float* __restrict__ o, float* __restrict__ lse,
                        int seq, int H, int Kv, int B, int hd, int causal,
                        int window, float c2, int n_cb) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float4* xchg = reinterpret_cast<float4*>(sm + kXchg);
  const uint32_t full = base + kBar;
  const Pos pos = block_pos<WC>(H, Kv, B, n_cb);
  const Block<WC> bk(pos.c0, H, B, seq, hd, causal, window, n_cb);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    write_pos(base + kPos, pos);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int m = 0; m < min(kStages, bk.n); ++m)
      bk.load(m, base, full, &maps);
  if (bk.n > 0) {
    mbar_wait(full, 0);
    split(sm);
  }
  __syncthreads();

  float acc[WC / 2];
#pragma unroll
  for (int i = 0; i < WC / 2; ++i) acc[i] = 0.0f;
  Rows rw;
  // the warpgroup, broadcast from lane 0 so that ptxas sees the role branch
  // as uniform (on a branch it takes for divergent it serializes wgmma)
  if (__shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0) == 0) {
    block_loop<WC, 0>(acc, rw, bk, base, sm, xchg, &maps, causal, window,
                      c2);
    finish<WC>(acc, rw, bk, base, o, lse, H, 0);
  } else {
    block_loop<WC, 1>(acc, rw, bk, base, sm, xchg, &maps, causal, window,
                      c2);
    if (bk.cols(read_pos(base + kPos).c0, 1) > 0)
      finish<WC>(acc, rw, bk, base, o, lse, H, 1);
  }
}

// The output columns a warpgroup owns at width hd (a multiple of 32): a
// block owns two warpgroups' worth, 128 up to hd 128, 256 up to 256 (one
// block a q tile: S formed once per tile pair) and 512 above, in
// ceil(hd / 512) column blocks, each forming S again.
int warp_cols(int hd) { return hd <= 128 ? 64 : hd <= 256 ? 128 : 256; }

template <int WC>
int launch_wc(const Maps& maps, void* o, float* lse, int B, int seq, int H,
              int Kv, int hd, int causal, int window, float scale,
              cudaStream_t st) {
  const int64_t n_tiles = (static_cast<int64_t>(seq) + kTile - 1) / kTile;
  const int n_cb = (hd + 2 * WC - 1) / (2 * WC);
  const int64_t blocks = n_tiles * H * B * n_cb;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_tf32x3<WC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_kernel_tf32x3<WC><<<static_cast<unsigned>(blocks), 2 * kThreads,
                            kSmem, st>>>(
      maps, static_cast<float*>(o), lse, seq, H, Kv, B, hd, causal, window,
      scale * kLog2e, n_cb);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int seq, int H, int Kv, long long hd, int causal,
           int window, float scale, void* stream) {
  // TMA's column coordinate (head * hd + column) is 32-bit
  if (hd < kCols || hd % kCols != 0 ||
      static_cast<long long>(H) * hd >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(hd);
  Maps maps;
  int err = tensor_map_128b(&maps.q, q, B, seq, H, w, 4);
  if (err == 0) err = tensor_map_128b(&maps.k, k, B, seq, Kv, w, 4);
  if (err == 0) err = tensor_map_128b(&maps.v, v, B, seq, Kv, w, 4);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (warp_cols(w)) {
    case 64:
      return launch_wc<64>(maps, o, lse, B, seq, H, Kv, w, causal, window,
                           scale, st);
    case 128:
      return launch_wc<128>(maps, o, lse, B, seq, H, Kv, w, causal, window,
                            scale, st);
  }
  return launch_wc<256>(maps, o, lse, B, seq, H, Kv, w, causal, window,
                        scale, st);
}

}  // namespace fx3

}  // namespace

extern "C" {

// Each returns 0 when the kernel was launched, else a cudaError_t, or for
// the tensor-core kernels a negative code when the TMA tensor map could not
// be built (-1: no cuTensorMapEncodeTiled in the driver; -1000 - CUresult:
// it refused). q and o hold B * seq * H * hd contiguous elements, k and v
// B * seq * Kv * hd; lse is null (not written) or holds B * H * seq fp32;
// H % Kv == 0; window >= 0 (0: no window). Element offsets are 64-bit in
// every kernel; rows of a (batch, kv head) are 64-bit in the CUDA-core
// kernels and 32-bit in the bf16 tensor-core ones (seq * H / Kv below 2^31
// - 256, the wrapper routes larger ones to the CUDA cores);
// flash_kernel_tf32x3's rows are one head's positions. The CUDA-core
// functions (_f32, _bf16_cc) take any hd: {16, 32, 64, 128, 192, 256} run
// flash_kernel, any other
// flash_kernel_chunked. The tensor-core one (_bf16) takes hd in {16, 32,
// 64, 128, 192, 256} (flash_kernel_wgmma) or a multiple of 64 above 256
// (flash_kernel_wgmma_cols; Kv * hd below 2^31), and 16-byte aligned
// pointers; _f32_tf32x3 (flash_kernel_tf32x3) a multiple of 32 with H * hd
// below 2^31, and 16-byte aligned q, k and v. The wrapper zero-pads other
// widths to the next the route takes and splits a batch only where a
// launch's grid would be too large.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int seq, int H, int Kv,
                        long long hd, int causal, int window, float scale,
                        void* stream) {
  return launch<float>(q, k, v, o, static_cast<float*>(lse), B, seq, H, Kv,
                       hd, causal, window, scale, stream);
}

int flash_attention_bf16_cc(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int seq, int H, int Kv,
                            long long hd, int causal, int window, float scale,
                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B, seq,
                               H, Kv, hd, causal, window, scale, stream);
}

int flash_attention_f32_tf32x3(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int seq, int H,
                               int Kv, long long hd, int causal, int window,
                               float scale, void* stream) {
  return fx3::launch(q, k, v, o, static_cast<float*>(lse), B, seq, H, Kv,
                     hd, causal, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int seq, int H, int Kv,
                         long long hd, int causal, int window, float scale,
                         void* stream) {
  return tc::launch(q, k, v, o, static_cast<float*>(lse), B, seq, H, Kv, hd,
                    causal, window, scale, stream);
}

// hd 192 only: flash_kernel_wgmma<192, 64> (a producer warp beside the two
// consumer warpgroups, ptxas's 168 registers), which the bf16 route ran at
// 192 before flash_kernel_wgmma_pipe; no route reaches it, it stays bound
// as that kernel's yardstick.
int flash_attention_bf16_wgmma192(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int seq, int H,
                                  int Kv, long long hd, int causal, int window,
                                  float scale, void* stream) {
  if (hd != 192) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_hd<192>(q, k, v, o, static_cast<float*>(lse), B, seq, H,
                            Kv, causal, window, scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
