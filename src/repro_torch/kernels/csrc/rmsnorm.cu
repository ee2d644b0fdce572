// RMSNorm for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel (Pallas).
// For x [R, D] and scale [D], each row is
//
//   y = x * (1 / sqrt(sum(x^2) / D + eps)) * scale
//
// with every operation in fp32 and y stored in x's dtype (fp32 or bf16),
// as the Pallas body and repro/kernels/ref.py::rmsnorm compute it.
//
// Bound on an H100: one read of x, one write of y and one read of scale,
// 4 flops per element, so bytes bound it (qwen1.5-110b's prefill norm,
// [4096, 8192] bf16: 134 MB, ~40 us at 3.35 TB/s; a decode norm, [4, 8192],
// moves 147 KB and is launch-latency bound).
//
// Design: one pass over device memory. Where the wrapper found every row
// 16-byte aligned, each thread loads its slice of a row with 16-byte loads
// into registers, sums its squares, and after the row's reduction scales
// and writes the same registers: x is read once. Rows of up to 2,048
// 16-byte pieces (D <= 16,384 bf16 / 8,192 fp32) take a block of 256
// threads each, with 1, 2, 4 or 8 pieces a thread (D = 8,192 bf16: 4);
// rows of up to 128 pieces take one warp each, eight rows a block. Either
// kernel keeps its slice of scale in registers, loaded once, and walks
// rows with a grid stride. Other rows (wider, or not 16-byte aligned: D =
// 5, 129, 130 in the JAX sweep) take the two-pass kernel: pass 1 sums, pass
// 2 reads the row again (from L1/L2) and writes y. The sum of squares runs
// in a fixed order in every kernel: each thread over its elements, a
// butterfly of warp shuffles, then (for a block per row) the warps'
// partials in order. No atomics, no split reduction: the same bits on every
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// VEC elements of T moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int d, float eps) {
  using P = Pack<T, VEC>;
  const int64_t row = blockIdx.x;
  const P* xv = reinterpret_cast<const P*>(x + row * d);
  const P* sv = reinterpret_cast<const P*>(scale);
  P* yv = reinterpret_cast<P*>(y + row * d);
  const int nvec = d / VEC;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(p.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float part[kWarps];
  __shared__ float inv_rms;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w];
    inv_rms = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const P p = xv[i];
    const P s = sv[i];
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_float<T>(to_float(p.v[j]) * r * to_float(s.v[j]));
    yv[i] = out;
  }
}

constexpr int kRowBlocks = 1024;    // grid cap of the one-pass kernels

// Sum of squares of a packed piece.
template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const Pack<T, VEC>& p) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_float(p.v[j]);
    ss += f * f;
  }
  return ss;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> scaled(const Pack<T, VEC>& x,
                                               const Pack<T, VEC>& s,
                                               float r) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    out.v[j] = from_float<T>(to_float(x.v[j]) * r * to_float(s.v[j]));
  return out;
}

// One pass, a block per row: thread t holds pieces t, t + 256, ... of the
// row (NV of them, the last ones possibly past the row's end).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       T* __restrict__ y, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const P* sv = reinterpret_cast<const P*>(scale);
  P s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) s[k] = sv[i];
  }
  __shared__ float part[kWarps];
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const P* xv = reinterpret_cast<const P*>(x + row * d);
    P* yv = reinterpret_cast<P*>(y + row * d);
    P v[NV];
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        v[k] = xv[i];
        ss += sum_sq(v[k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w];
    const float r = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
    __syncthreads();     // part is read before the next row writes it
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) yv[i] = scaled(v[k], s[k], r);
    }
  }
}

// One pass, a warp per row (narrow rows): lane l holds pieces l, l + 32, ...
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ y, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const int lane = threadIdx.x % 32;
  const P* sv = reinterpret_cast<const P*>(scale);
  P s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) s[k] = sv[i];
  }
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     threadIdx.x / 32;
       row < rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const P* xv = reinterpret_cast<const P*>(x + row * d);
    P* yv = reinterpret_cast<P*>(y + row * d);
    P v[NV];
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        v[k] = xv[i];
        ss += sum_sq(v[k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) yv[i] = scaled(v[k], s[k], r);
    }
  }
}

template <typename T, int NV>
int launch_row(const T* x, const T* s, T* y, int rows, int d, float eps,
               cudaStream_t st) {
  const int blocks = rows < kRowBlocks ? rows : kRowBlocks;
  rmsnorm_row_kernel<T, NV><<<blocks, kThreads, 0, st>>>(x, s, y, rows,
                                                            d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int launch_warp(const T* x, const T* s, T* y, int rows, int d, float eps,
                cudaStream_t st) {
  const int want = (rows + kWarps - 1) / kWarps;
  const int blocks = want < kRowBlocks ? want : kRowBlocks;
  rmsnorm_warp_kernel<T, NV><<<blocks, kThreads, 0, st>>>(x, s, y, rows, d,
                                                          eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vec, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  const int nvec = d / kVec;
  if (vec) {
    if (nvec <= 32) return launch_warp<T, 1>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= 64) return launch_warp<T, 2>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= 128) return launch_warp<T, 4>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= kThreads)
      return launch_row<T, 1>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= 2 * kThreads)
      return launch_row<T, 2>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= 4 * kThreads)
      return launch_row<T, 4>(xp, sp, yp, rows, d, eps, st);
    if (nvec <= 8 * kThreads)
      return launch_row<T, 8>(xp, sp, yp, rows, d, eps, st);
    rmsnorm_kernel<T, kVec><<<rows, kThreads, 0, st>>>(xp, sp, yp, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, st>>>(xp, sp, yp, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// x and y hold rows * d contiguous elements, scale d; vec != 0 only when
// d is a multiple of 16 / sizeof(T) and x, y and scale are 16-byte aligned.
int rmsnorm_f32(const void* x, const void* scale, void* y, int rows, int d,
                float eps, int vec, void* stream) {
  return launch<float>(x, scale, y, rows, d, eps, vec, stream);
}

int rmsnorm_bf16(const void* x, const void* scale, void* y, int rows, int d,
                 float eps, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, vec, stream);
}

}  // extern "C"
