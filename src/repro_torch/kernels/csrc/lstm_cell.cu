// Fused LSTM cell for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/lstm_cell.py::_cell_kernel (Pallas).
// One launch computes, for x [B,Din], h/c [B,H], W [Din+H, 4H], b [4H]
// (Keras gate order i, f, g, o along the 4H axis):
//
//     z  = [x, h] @ W + b                       (fp32 accumulation)
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')                (outputs in the input type)
//
// Bound on an H100 at the paper's shapes (B=8, H=50, Din=95 or 50, fp32):
// it must read W once, 145*200*4 B = 116 KB for layer 0, plus ~8 KB of
// activations; at 3.35 TB/s that is ~37 ns, and its 0.46 MFLOP take ~7 ns
// at the 67 TFLOP/s fp32 rate, so bytes bound it. In practice one launch is
// bounded by launch latency (microseconds), far above either; a later design
// that runs the whole T-step sequence in one persistent launch, or a CUDA
// graph over the steps, is what would approach the bound.
//
// Design (simple and exact first):
//  - one block per (batch tile of kBT rows, hidden tile of kHT units);
//  - the block stages its [x, h] rows in shared memory as fp32, so no
//    concatenated copy of [x, h] is ever written to device memory;
//  - thread (r, j) runs the four gate dot products over Din+H in a fixed
//    order, reading W[k, g*H + j] coalesced across j, then the gate math.
// No atomics and no split reductions: the result is the same bits on every
// run, which the Coordinator's bit-equality with the sequential reference
// needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 8;   // batch rows per block
constexpr int kHT = 32;  // hidden units per block (one warp per row)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

template <typename T>
__global__ void __launch_bounds__(kBT* kHT)
    lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const T* __restrict__ c, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ h_out,
                     T* __restrict__ c_out, int B, int Din, int H) {
  extern __shared__ float sxh[];  // [rows][Din + H], fp32
  const int dxh = Din + H;
  const int b0 = blockIdx.y * kBT;
  const int rows = min(kBT, B - b0);
  const int tid = threadIdx.y * kHT + threadIdx.x;
  for (int idx = tid; idx < rows * dxh; idx += kBT * kHT) {
    const int r = idx / dxh;
    const int k = idx - r * dxh;
    const size_t row = static_cast<size_t>(b0 + r);
    sxh[idx] = k < Din ? to_f32(x[row * Din + k])
                       : to_f32(h[row * H + (k - Din)]);
  }
  __syncthreads();

  const int r = threadIdx.y;
  const int j = blockIdx.x * kHT + threadIdx.x;
  if (r >= rows || j >= H) return;

  const float* xr = sxh + r * dxh;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const T* wj = w + j;
  float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
  for (int k = 0; k < dxh; ++k) {
    const float xv = xr[k];
    const T* wk = wj + k * H4;
    ai = fmaf(xv, to_f32(wk[0]), ai);
    af = fmaf(xv, to_f32(wk[H]), af);
    ag = fmaf(xv, to_f32(wk[2 * H]), ag);
    ao = fmaf(xv, to_f32(wk[3 * H]), ao);
  }
  const float zi = ai + to_f32(bias[j]);
  const float zf = af + to_f32(bias[H + j]);
  const float zg = ag + to_f32(bias[2 * H + j]);
  const float zo = ao + to_f32(bias[3 * H + j]);

  const size_t o = static_cast<size_t>(b0 + r) * H + j;
  const float c_new = sigmoid(zf) * to_f32(c[o]) + sigmoid(zi) * tanhf(zg);
  const float h_new = sigmoid(zo) * tanhf(c_new);
  h_out[o] = from_f32<T>(h_new);
  c_out[o] = from_f32<T>(c_new);
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w,
           const void* b, void* h_out, void* c_out, int B, int Din, int H,
           void* stream) {
  const size_t smem = static_cast<size_t>(kBT) * (Din + H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H + kHT - 1) / kHT, (B + kBT - 1) / kBT);
  const dim3 block(kHT, kBT);
  lstm_cell_kernel<T><<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), B, Din, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int lstm_cell_f32(const void* x, const void* h, const void* c, const void* w,
                  const void* b, void* h_out, void* c_out, int B, int Din,
                  int H, void* stream) {
  return launch<float>(x, h, c, w, b, h_out, c_out, B, Din, H, stream);
}

int lstm_cell_bf16(const void* x, const void* h, const void* c, const void* w,
                   const void* b, void* h_out, void* c_out, int B, int Din,
                   int H, void* stream) {
  return launch<__nv_bfloat16>(x, h, c, w, b, h_out, c_out, B, Din, H,
                               stream);
}

}  // extern "C"
