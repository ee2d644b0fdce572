// TernGrad 2-bit codec for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels repro/kernels/ternary.py::_encode_kernel and
// ::_decode_kernel (Pallas). For a flat fp32 gradient g [N] (N % 4 == 0)
// and its scale s (one fp32 value in device memory):
//
//   encode: code_i = |g_i| >= s/2 ? (g_i > 0 ? 0b01 : 0b10) : 0b00
//           byte_j = code_{4j} | code_{4j+1} << 2 | code_{4j+2} << 4
//                    | code_{4j+3} << 6            -> uint8 [N/4]
//   decode: code 0b01 -> +s, 0b10 -> -s, else +0.0 -> fp32 [N]
//
// These are exactly the Pallas bodies: the same comparison (|g| >= s/2, not
// |g|/s >= 0.5), the same little-endian order within a byte, and +0.0 (not
// -0.0) for a zero code, which is what ``t.astype(f32) * s`` gives for s > 0.
//
// Bound on an H100: each kernel moves 4N + N/4 + 4 bytes (g or the output,
// the packed bytes, s) and does a few integer operations per element, so
// bytes bound it. At the paper's largest leaf (N = 29,000) that is
// 123,254 B, ~37 ns at 3.35 TB/s; a launch costs
// microseconds, so launch latency is what a call will show. Fusing the six
// leaves of a gradient into one launch is what would approach the bound.
//
// Design (simple and exact first): one thread per output byte (encode) or
// input byte (decode). An encode thread reads its four floats (four scalar
// loads, so g may start anywhere) and writes one byte; a decode thread reads
// one byte and writes one float4 (the output is allocated by the wrapper, so
// it is aligned). Consecutive threads touch consecutive addresses. No
// atomics and no reductions: the same bytes on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t code_of(float v, float half) {
  return fabsf(v) >= half ? (v > 0.0f ? 1u : 2u) : 0u;
}

__device__ __forceinline__ float value_of(uint32_t code, float s) {
  return code == 1u ? s : (code == 2u ? -s : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
    ternary_encode_kernel(const float* __restrict__ g,
                          const float* __restrict__ s,
                          uint8_t* __restrict__ out, int n_bytes) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_bytes) return;
  const float half = __ldg(s) / 2.0f;
  const float* v = g + 4 * j;
  const uint32_t byte =
      code_of(__ldg(v), half) | (code_of(__ldg(v + 1), half) << 2) |
      (code_of(__ldg(v + 2), half) << 4) | (code_of(__ldg(v + 3), half) << 6);
  out[j] = static_cast<uint8_t>(byte);
}

__global__ void __launch_bounds__(kThreads)
    ternary_decode_kernel(const uint8_t* __restrict__ packed,
                          const float* __restrict__ s,
                          float* __restrict__ out, int n_bytes) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_bytes) return;
  const float sv = __ldg(s);
  const uint32_t byte = __ldg(packed + j);
  reinterpret_cast<float4*>(out)[j] =
      make_float4(value_of(byte & 3u, sv), value_of((byte >> 2) & 3u, sv),
                  value_of((byte >> 4) & 3u, sv),
                  value_of((byte >> 6) & 3u, sv));
}

inline dim3 grid_for(int n_bytes) {
  return dim3((n_bytes + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// n_bytes = N / 4 > 0; g, s and out are device pointers; out holds n_bytes
// (encode) or 4 * n_bytes floats (decode, 16-byte aligned).
int ternary_encode_f32(const void* g, const void* s, void* out, int n_bytes,
                       void* stream) {
  ternary_encode_kernel<<<grid_for(n_bytes), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(s),
      static_cast<uint8_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

int ternary_decode_f32(const void* packed, const void* s, void* out,
                       int n_bytes, void* stream) {
  ternary_decode_kernel<<<grid_for(n_bytes), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(s),
      static_cast<float*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
