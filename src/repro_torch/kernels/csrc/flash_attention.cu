// Flash attention (GQA, causal and/or sliding window, forward) for Hopper
// (sm_90a), bound to Python with ctypes. Three kernels: bfloat16 at head
// widths up to 192 runs on the tensor cores (flash_kernel_wgmma), float32
// on the CUDA cores (flash_kernel, whose fp32 products the fp32 tolerances
// need: TF32 would break them), and so does bfloat16 at 256 (wgmma's
// accumulators at hd 256 exceed two consumer warpgroups' registers) and
// where a (batch, kv head) holds 2^31 - 256 folded rows or more; any width
// above 256 runs flash_kernel_chunked in either type, which sums over hd
// in chunks. The kernels are built for hd 16, 32, 64, 128, 192 and 256; the
// wrapper zero-pads a width between them to the next.
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
// Both kernels fold the G query heads of a kv head into a tile's rows, as
// _fa_kernel does: folded row r is query position r / G, head
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
// into a ring of kStages stages, each with a
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
//   O += P V    wgmma m64n{hd}k16 (N = 192 at hd 192: 96 fp32
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
// this loop on the H100 (PERF.md).
//
// flash_kernel (fp32): one block of 256 threads per (q tile, kv head,
// batch). A tile holds 64 folded rows (8 positions at G = 8); each row
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
constexpr int kThreads = (4 * kConsumers + 1) * 32;
constexpr int kKv = 64;                            // kv positions a tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: q [kChunks][kRows][kCW],
// k and v [kStages][kChunks][kKv][kCW], then the barriers. A row of kCW
// bf16 is the swizzle's span (32, 64 or 128 bytes).
template <int HD>
struct Cfg {
  static constexpr int kCW = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kCW;
  static constexpr int kChunks = HD / kCW;
  // 16-byte unit ^= address bits 7.. (Swizzle<3|2|1, 4, 3>), as TMA writes
  static constexpr uint32_t kSwz = kRowBytes == 128 ? 7 : kRowBytes == 64 ? 3
                                                                         : 1;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64
                                                                 ? 2
                                                                 : 3;
  static constexpr int kQChunk = kRows * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKvChunk = kKv * kRowBytes;
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
template <int HD>
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  using C = Cfg<HD>;
  return desc(addr, 16, 8 * C::kRowBytes, C::kLayout);
}
template <int HD>
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  using C = Cfg<HD>;
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

// S = Q K^T for one warpgroup: 64 q rows x 64 kv positions, over hd in
// steps of 16; q and k K-major in shared memory, given by the descriptors
// of their first byte (a step adds its byte offset / 16 to the address
// field).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kKv / 2], uint64_t dq,
                                         uint64_t dk) {
  using C = Cfg<HD>;
  constexpr int kStepsPerChunk = C::kCW / 16;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / kStepsPerChunk, w = kk % kStepsPerChunk;
    wgmma_ss(sc, dq + ((c * C::kQChunk + 32 * w) >> 4),
             dk + ((c * C::kKvChunk + 32 * w) >> 4), kk > 0);
  }
}

// O += P_hi V + P_lo V over a tile's 64 positions in steps of 16; dv is
// the v tile's descriptor (MN-major).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&p_hi)[kKv / 4],
                                         const uint32_t (&p_lo)[kKv / 4],
                                         uint64_t dv) {
  using C = Cfg<HD>;
#pragma unroll
  for (int t = 0; t < kKv / 16; ++t) {
    const uint32_t a[4] = {p_hi[4 * t], p_hi[4 * t + 1], p_hi[4 * t + 2],
                           p_hi[4 * t + 3]};
    wgmma_rs(acc, a, dv + ((t * 16 * C::kRowBytes) >> 4));
  }
#pragma unroll
  for (int t = 0; t < kKv / 16; ++t) {
    const uint32_t a[4] = {p_lo[4 * t], p_lo[4 * t + 1], p_lo[4 * t + 2],
                           p_lo[4 * t + 3]};
    wgmma_rs(acc, a, dv + ((t * 16 * C::kRowBytes) >> 4));
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

  // The scores of the tile at k0 into P = 2^(s * scale_log2 - m), as bf16
  // hi + lo in wgmma's A-register layout: the j-th n8 block of S gives
  // registers 2j (row a) and 2j + 1 (row b). A tile with every position
  // visible to every row takes the max on the raw scores (scaling by a
  // positive number keeps the order) and one FFMA a score into ex2; a tile
  // that crosses the diagonal, the window's lower edge or S is scaled
  // first and masked with -1e30 in the scaled domain, as _fa_kernel does
  // (an FFMA on a raw -1e30 would leave a rounding residue of ~1e21).
  __device__ __forceinline__ void tile(float (&sc)[kKv / 2],
                                       uint32_t (&p_hi)[kKv / 4],
                                       uint32_t (&p_lo)[kKv / 4], int k0) {
    const bool whole = k0 + kKv <= seq &&
                       (!causal || k0 + kKv - 1 <= wq_lo) &&
                       (window <= 0 || k0 > wq_hi - window);
    float c = scale_log2;
    if (!whole) {
#pragma unroll
      for (int j = 0; j < kKv / 8; ++j) {
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
    for (int j = 0; j < kKv / 8; ++j) {
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
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      const float pa0 = ex2(fmaf(sc[4 * j], c, -mn_a));
      const float pa1 = ex2(fmaf(sc[4 * j + 1], c, -mn_a));
      const float pb0 = ex2(fmaf(sc[4 * j + 2], c, -mn_b));
      const float pb1 = ex2(fmaf(sc[4 * j + 3], c, -mn_b));
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
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int seq, int H, int Kv, int causal, int window,
                       float scale_log2, int n_qtiles) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + C::kQBytes;
  const uint32_t sV = sK + kStages * C::kTile;
  const uint32_t full = base + C::kBar;         // kStages barriers of 8 bytes
  const uint32_t empty = full + 8 * kStages;

  // heaviest q tiles first when causal: block order walks q tiles from the
  // last, each over every (kv head, batch)
  const int per_tile = gridDim.x / n_qtiles;
  const int qt_lin = blockIdx.x / per_tile;
  const int qt = causal ? n_qtiles - 1 - qt_lin : qt_lin;
  const int kvh = (blockIdx.x % per_tile) % Kv;
  const int b = (blockIdx.x % per_tile) / Kv;

  const int G = H / Kv;
  // row indices fit in 32 bits (S * H < 2^31, the wrapper checks), and
  // 32-bit division is several times cheaper than 64-bit
  const int n_rows = seq * G;
  const int r0 = qt * kRows;
  const int last_row = min(r0 + kRows, n_rows) - 1;
  const int kv_end = causal ? min(seq, last_row / G + 1) : seq;
  const int kv_begin = window > 0 ? max(0, r0 / G - window + 1) : 0;
  const int t_begin = kv_begin / kKv;
  const int n_t = (kv_end + kKv - 1) / kKv - t_begin;

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
        const int k0 = (t_begin + i) * kKv;
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
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  // this thread's two rows in the accumulators: a = lane / 4, b = a + 8
  const int row_a = w0 + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  Softmax sm;
  sm.qpos_a = row_a / G;
  sm.qpos_b = row_b / G;
  sm.wq_lo = min(w0, n_rows - 1) / G;
  sm.wq_hi = min(w0 + 63, n_rows - 1) / G;
  sm.cq = 2 * (lane % 4);
  sm.seq = seq;
  sm.causal = causal;
  sm.window = window;
  sm.scale_log2 = scale_log2;
  const int cq = sm.cq;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const uint64_t dq = k_major<HD>(sQ + 64 * wg * C::kRowBytes);
  float sc[kKv / 2];
  uint32_t p_hi[kKv / 4], p_lo[kKv / 4];

  for (int i = 0; i < n_t; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_qk<HD>(sc, dq, k_major<HD>(sK + s * C::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    sm.tile(sc, p_hi, p_lo, (t_begin + i) * kKv);
    sm.rescale(acc);
    wgmma_fence();
    issue_pv<HD>(acc, p_hi, p_lo, mn_major<HD>(sV + s * C::kTile));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }


  float l_a = sm.l_a, l_b = sm.l_b;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = l_a == 0.0f ? 1.0f : l_a;
  l_b = l_b == 0.0f ? 1.0f : l_b;
  const float inv[2] = {1.0f / l_a, 1.0f / l_b};
  if (lse != nullptr && lane % 4 == 0) {
    // m and l are in the log2 domain of the scaled scores: the natural
    // log-sum-exp is ln 2 * (m + log2 l); one thread of the row's 4 writes
    constexpr float kLn2 = 0.6931471805599453f;
    const int rows[2] = {row_a, row_b};
    const float ms[2] = {sm.m_a, sm.m_b}, ls[2] = {l_a, l_b};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (rows[half] >= n_rows) continue;
      const int pos = rows[half] / G, g = rows[half] - pos * G;
      lse[(b * static_cast<int64_t>(H) + static_cast<int64_t>(kvh) * G + g) *
              seq + pos] = kLn2 * (ms[half] + log2f(ls[half]));
    }
  }
  // out goes through this warpgroup's q region (read by no wgmma any more),
  // in its swizzled layout, so the 4-byte writes of the accumulator layout
  // meet no bank conflicts; then whole rows leave in 16-byte pieces
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 8 * j + cq;
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
    if (row >= n_rows) continue;
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

// A [B][S][Kv * hd] view of k or v, boxes of kKv positions x kCW columns.
template <int HD>
int tensor_map(CUtensorMap* map, const void* ptr, int B, int seq, int Kv) {
  using C = Cfg<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kv) * HD,
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kv) * HD * 2,
                                 static_cast<cuuint64_t>(seq) * Kv * HD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kCW), kKv, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz =
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
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
  using C = Cfg<HD>;
  CUtensorMap kmap, vmap;
  int err = tensor_map<HD>(&kmap, k, B, seq, Kv);
  if (err == 0) err = tensor_map<HD>(&vmap, v, B, seq, Kv);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const int64_t n_qtiles = (n_rows + kRows - 1) / kRows;
  const int64_t blocks = n_qtiles * Kv * B;
  if (blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_wgmma<HD><<<static_cast<unsigned>(blocks), kThreads, C::kSmem,
                           st>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, seq, H, Kv, causal, window,
      scale * kLog2e, static_cast<int>(n_qtiles));
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
      return launch_hd<192>(q, k, v, o, lse, B, seq, H, Kv, causal, window,
                            scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Each returns 0 when the kernel was launched, else a cudaError_t, or for
// the tensor-core kernel a negative code when the TMA tensor map could not
// be built (-1: no cuTensorMapEncodeTiled in the driver; -1000 - CUresult:
// it refused). q and o hold B * seq * H * hd contiguous elements, k and v
// B * seq * Kv * hd; lse is null (not written) or holds B * H * seq fp32;
// H % Kv == 0; window >= 0 (0: no window). Element
// offsets are 64-bit in every kernel; rows of a (batch, kv head) are
// 64-bit in the CUDA-core kernels and 32-bit in the tensor-core one
// (seq * H / Kv below 2^31 - 256, the wrapper routes larger ones to the
// CUDA cores). The CUDA-core functions (_f32, _bf16_cc) take any hd:
// {16, 32, 64, 128, 192, 256} run flash_kernel, any other
// flash_kernel_chunked. The tensor-core one (_bf16) takes hd in {16, 32,
// 64, 128, 192} and 16-byte aligned pointers. The wrapper zero-pads other
// widths up to 256 to the next built one and splits a batch only where a
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

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int seq, int H, int Kv,
                         long long hd, int causal, int window, float scale,
                         void* stream) {
  return tc::launch(q, k, v, o, static_cast<float*>(lse), B, seq, H, Kv, hd,
                    causal, window, scale, stream);
}

}  // extern "C"
