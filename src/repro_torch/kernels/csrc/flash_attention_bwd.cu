// Flash attention backward (GQA, causal and/or sliding window) for Hopper
// (sm_90a), bound to Python with ctypes. Two routes, each two launches:
// bfloat16 at head widths 64, 128, 192 and 256 runs on the tensor cores
// (flash_bwd_dq_wgmma, then flash_bwd_dkdv_wgmma at 64 and 128 or
// flash_bwd_dkdv_wgmma_split at 192 and 256; the wrapper zero-pads any
// width up to 256 to the next of these); float32 at every width, and
// bfloat16 above 256, runs on the CUDA cores with fp32 products
// (flash_bwd_dq_cc, flash_bwd_dkdv_cc; TF32 would break the fp32
// tolerances), which take any hd at run time.
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
// The tensor-core kernels: one warpgroup (128 threads) a block. Its own two
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
// The CUDA-core kernels: 256 threads a block, 64 rows a block, 4 threads a
// row, the other side in tiles of 32 positions (8 columns a thread); scores
// and dP summed over hd in chunks of 64 columns staged in shared memory,
// then P and dS through shared memory into this block's 64 output columns
// (blocks own column chunks, so any hd runs; each chunk's block recomputes
// the scores: exact, simple, not fast).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bf16 at hd 64, 128, 192 and 256: tensor cores (wgmma), TMA
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
// A-register layout, 4 registers a k step of 16), B a tile (MN-major).
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[kTile / 4],
                                         uint32_t b) {
  const uint64_t db = mn_major(b);
#pragma unroll
  for (int t = 0; t < kTile / 16; ++t) {
    const uint32_t f[4] = {a[4 * t], a[4 * t + 1], a[4 * t + 2],
                           a[4 * t + 3]};
    wgmma_rs(acc, f, db + ((t * 16 * 128) >> 4));
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

// Rows of this thread in its warpgroup's 64-row accumulator (a, and b = a
// + 8), and the first of its columns in each n8 block (8 j + cq, + 1).
struct Frag {
  int row_a, cq;
  __device__ __forceinline__ Frag() {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    row_a = 16 * warp + lane / 4;
    cq = 2 * (lane % 4);
  }
};

// acc [64 x HD] of rows r (position row0 + r < seq) into a bf16 [B][S][heads
// * HD] output at element offset base + position * stride.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           __nv_bfloat16* __restrict__ out,
                                           int64_t base, int64_t stride,
                                           int row0, int seq, const Frag& fr) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row0 + fr.row_a + 8 * half;
    if (pos >= seq) continue;
    __nv_bfloat16* o = out + base + pos * stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j + fr.cq) =
          bf16x2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

__device__ __forceinline__ void bar_init(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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
  // D of the tile's rows, two threads a row over HD / 2 columns each, from
  // global memory (16-byte loads) while the tiles arrive
  {
    const int r = threadIdx.x / 2, part = threadIdx.x % 2;
    const int pos = q0 + r;
    float d = 0.0f;
    if (pos < seq) {
      const int64_t off = ((static_cast<int64_t>(b) * seq + pos) * H + h) *
                              HD + part * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 y = *reinterpret_cast<const uint4*>(o + off + c);
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&x);
        const __nv_bfloat16* ys = reinterpret_cast<const __nv_bfloat16*>(&y);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d = fmaf(__bfloat162float(xs[e]), __bfloat162float(ys[e]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      vec[r] = d;
      if (pos < seq) dsum[(static_cast<int64_t>(b) * H + h) * seq + pos] = d;
    }
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
    const bool whole = q0 + kTile <= seq && k0 + kTile <= seq &&
                       (!causal || k0 + kTile - 1 <= q0) &&
                       (window <= 0 || k0 > q0 + kTile - 1 - window);
    // dS in bf16, in the A-register layout: register 2 j holds row a's
    // pair of columns (8 j + cq, + 1), register 2 j + 1 row b's
    uint32_t ds[kTile / 4];
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
// Blocks run kv tile 0 (seen by every q row when causal) first; iteration i
// reads query head kvh * G + i / n_q at q tile qt_begin + i % n_q.
struct KvBlock {
  int b, kvh, G, H, seq, k0, qt_begin, n_q, causal, window;

  __device__ __forceinline__ KvBlock(int seq_, int H_, int Kv, int B,
                                     int causal_, int window_)
      : H(H_), seq(seq_), causal(causal_), window(window_) {
    const int kt = blockIdx.x / (B * Kv);
    b = (blockIdx.x % (B * Kv)) / Kv;
    kvh = blockIdx.x % Kv;
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
    return q0_ + kTile <= seq && k0 + kTile <= seq &&
           (!causal || k0 + kTile - 1 <= q0_) &&
           (window <= 0 || k0 > q0_ + kTile - 1 - window);
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
};

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
  const KvBlock kb(seq, H, Kv, B, causal, window);
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
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        float p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = 8 * j + fr.cq + u % 2;
          const bool ok = whole || sees(q0 + col, kb.k0 + fr.row_a +
                                        8 * (u / 2), kb.seq, kb.causal,
                                        kb.window);
          p[u] = ok ? ex2(fmaf(st[4 * j + u], c2, -sl[col])) : 0.0f;
        }
        a[2 * j] = bf16x2(p[0], p[1]);
        a[2 * j + 1] = bf16x2(p[2], p[3]);
      }
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
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        float d[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = 4 * j + u, col = 8 * j + fr.cq + u % 2;
          const bool ok = whole || sees(q0 + col, kb.k0 + fr.row_a +
                                        8 * (u / 2), kb.seq, kb.causal,
                                        kb.window);
          const float p = ok ? ex2(fmaf(st[idx], c2, -sl[col])) : 0.0f;
          d[u] = p * (dpt[idx] - sd[col]) * scale;
        }
        a[2 * j] = bf16x2(d[0], d[1]);
        a[2 * j + 1] = bf16x2(d[2], d[3]);
      }
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
  const KvBlock kb(seq, H, Kv, B, causal, window);

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

// A [B][S][heads * HD] bf16 view, boxes of 64 positions x 64 columns,
// 128-byte swizzle.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int seq, int heads,
               int hd) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * hd,
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(heads) * hd * 2,
      static_cast<cuuint64_t>(seq) * heads * hd * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

struct Maps {
  CUtensorMap q, d, k, v;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int seq, int H, int Kv, int hd) {
  int err = tensor_map(&m->q, q, B, seq, H, hd);
  if (err == 0) err = tensor_map(&m->d, dout, B, seq, H, hd);
  if (err == 0) err = tensor_map(&m->k, k, B, seq, Kv, hd);
  if (err == 0) err = tensor_map(&m->v, v, B, seq, Kv, hd);
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

}  // namespace tc

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
// _bf16_cc) take any hd; the tensor-core ones (_bf16) hd 64, 128, 192 or
// 256 and 16-byte aligned q, k, v, out and dout.
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
      return tc::launch_dq_hd<128>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                   causal, window, scale, st);
    case 192:
      return tc::launch_dq_hd<192>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                   causal, window, scale, st);
    case 256:
      return tc::launch_dq_hd<256>(m, o, dout, l, ds, dq, B, seq, H, Kv,
                                   causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
      return tc::launch_dkdv_hd<64>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                    window, scale, st);
    case 128:
      return tc::launch_dkdv_hd<128>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                     window, scale, st);
    case 192:
      return tc::launch_dkdv_hd<192>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                     window, scale, st);
    case 256:
      return tc::launch_dkdv_hd<256>(m, l, ds, dk, dv, B, seq, H, Kv, causal,
                                     window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
