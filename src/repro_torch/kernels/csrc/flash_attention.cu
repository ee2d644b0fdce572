// Flash attention (GQA, causal and/or sliding window, forward) for Hopper
// (sm_90a), bound to Python with ctypes.
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
// the output sum are fp32; out is stored in q's dtype. As the Pallas kernel
// does, q is scaled by 1/sqrt(hd) before the product (the plain version
// scales the scores after it).
//
// Bound on an H100: the causal products take 4 * B * H * S^2 * hd / 2 flops
// (qwen1.5-110b's prefill, B=4, S=1024, H=64, hd=128: 68.7 GFLOP, ~69 us at
// the 989 TFLOP/s bf16 tensor-core rate) against ~151 MB of q, k, v and out
// (~45 us at 3.35 TB/s), so operations bound it. This first kernel does its
// products in fp32 on the CUDA cores (67 TFLOP/s peak): it is simple and
// right, and stays far above the bound. Tensor cores (wgmma), TMA and a
// pipelined ring of kv tiles are the work of a later change.
//
// Design: one block of 256 threads per (q tile, kv head, batch). The G query
// heads of a kv head are folded into the tile's rows, as _fa_kernel does:
// folded row r is query position r / G, head kv_head * G + r % G, so one kv
// tile in shared memory serves all G heads. A tile holds 64 folded rows
// (8 positions at G = 8); each row belongs to 4 threads. The block copies
// its q rows (scaled, fp32) into shared memory once, then streams kv tiles
// of 32 positions through shared memory from the first tile the window can
// see to the causal bound of its last row. Per tile, each thread computes 8
// scores of its row (16-byte shared loads along hd), the row's max and sum
// combine across its 4 threads by shuffles, the probabilities go to shared
// memory, and each thread adds them times v into its hd / 4 output columns.
// Masked scores are -1e30, not -inf: a row that sees only masked positions
// in its first tile keeps finite junk that alpha = exp(-1e30 - m) = 0 wipes
// at its first valid tile (every row sees its own position). No atomics and
// no split reductions: the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                   // folded q rows per block
constexpr int kLanes = kThreads / kRows;    // threads per row
constexpr int kCols = 32;                   // kv positions per tile
constexpr int kColsPerLane = kCols / kLanes;
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16_rn(v);
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
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq, int H,
                 int Kv, int causal, int window, float scale) {
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
  T* orow = o + ((b * static_cast<int64_t>(seq) + qi) * H +
                 static_cast<int64_t>(kvh) * G + g) * HD;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      orow[16 * i + 4 * lane + e] = from_float<T>(acc[4 * i + e] / l_safe);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int seq, int H, int Kv, int causal, int window, float scale,
              cudaStream_t st) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rows = static_cast<int64_t>(seq) * (H / Kv);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), Kv, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, H, Kv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int seq, int H, int Kv, int hd, int causal, int window,
           float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, B, seq, H, Kv, causal, window,
                              scale, st);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, seq, H, Kv, causal, window,
                              scale, st);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, seq, H, Kv, causal, window,
                              scale, st);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, seq, H, Kv, causal, window,
                               scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns 0 when the kernel was launched, else a cudaError_t. q and o
// hold B * seq * H * hd contiguous elements, k and v B * seq * Kv * hd;
// H % Kv == 0; hd in {16, 32, 64, 128}; window >= 0 (0: no window).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int seq, int H, int Kv, int hd, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, seq, H, Kv, hd, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int seq, int H, int Kv, int hd, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, seq, H, Kv, hd, causal, window,
                               scale, stream);
}

}  // extern "C"
