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
// Design (simple and exact first): one block of 256 threads per row. Pass 1
// reads the row with 16-byte loads where the wrapper found the row 16-byte
// aligned (else one element at a time) and sums x^2 in fp32 in a fixed
// order: each thread over its strided elements, then a butterfly of warp
// shuffles, then warp 0's eight partials in order. No atomics, no split
// reduction: the same bits on every run. Pass 2 reads the row again (from
// L1/L2: 16 KB for D = 8192 bf16) and writes y. The Pallas kernel keeps a
// block of rows in VMEM; here a row is small enough for the cache.

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

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vec, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, kVec><<<rows, kThreads, 0, st>>>(xp, sp, yp, d, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, st>>>(xp, sp, yp, d, eps);
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
