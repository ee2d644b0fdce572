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
//
// The backward (the JAX package differentiates the formula with jax.grad of
// repro/models/layers.py::apply_norm; it has no kernel of its own): for the
// cotangent dy [R, D] of y, each row's
//
//   r = 1 / sqrt(sum(x^2) / D + eps),  c = sum(dy * scale * x) / D
//   dx = r * scale * dy - x * r^3 * c
//
// in fp32, stored in x's dtype, and dscale = sum over rows of dy * x * r in
// fp32, stored in scale's dtype. Two launches, no atomics:
//   rows  block b walks rows b, b + G, b + 2G, ... (G blocks), writes each
//         row's dx and keeps its own fp32 column sums of dy * x * r, which
//         it writes to part[b, :] at the end;
//   cols  dscale[c] = the G partials of column c added in a fixed order:
//         warp w of a block adds rows w, w + 8, ... of part in order, then
//         the 8 warps' sums are added in warp order.
// Rows of 16-byte pieces (the wrapper found every row 16-byte aligned, up
// to 2,048 pieces) keep their pieces, their slice of scale and their
// column sums in registers (bwd_row_kernel, 256 threads, a thread's pieces
// at t, t + 256, ...); other rows take bwd_any_kernel, which reads a row
// twice and adds into part[b, :] in global memory, each column owned by
// one thread of the block. Both row sums of a row run in one fixed order,
// as the forward's. Bound on an H100: x and dy read once, dx written once
// ([4096, 8192] bf16: 201 MB, 0.0601 ms at 3.35 TB/s; part adds
// 2 * 4 * G * D bytes).
//   Those kernels (rmsnorm_bwd_row_kernel, rmsnorm_bwd_any_kernel,
// rmsnorm_bwd_cols_kernel) stay bound as the yardstick, through
// rmsnorm_bwd_rows_* and rmsnorm_bwd_cols_*. The route, rmsnorm_bwd_f32 /
// rmsnorm_bwd_bf16, is one C call that issues both launches; its rows
// launch keeps the next row's loads in flight while it finishes the
// current one, so each SM holds two rows of x and dy in flight:
//   narrow rows (up to kBwdWarpPieces = 128 pieces; internvl2-1b's 896
//     bf16 is 112) take rmsnorm_bwd_warp_kernel: a warp a row, eight
//     warps a block, both row sums reduced by warp shuffles alone (no block
//     barrier a row); warp w of block b walks rows b * 8 + w, then every
//     8 * G-th row after it, and keeps its lanes' column sums of dscale in
//     registers; at the end the block adds its 8 warps' sums in warp order
//     (through shared memory) into part[b, :];
//   wide rows (up to kBwdBlockPieces = 1,024 pieces; 2,048 to 8,192 bf16)
//     take rmsnorm_bwd_block_kernel: a block a row as rmsnorm_bwd_row_kernel,
//     with the two sums' one barrier a row on a double-buffered red;
//   other rows (wider, or not 16-byte aligned) take the yardstick's rows
//     kernels;
// then the yardstick's rmsnorm_bwd_cols_kernel adds part's G rows. The new
// kernels round every operation explicitly (__fmaf_rn, __fmul_rn,
// __fsub_rn), so nvcc contracts nothing and tests/test_torch_rmsnorm_bwd.py
// repeats their order on the CPU. launch_bwd picks the tier and G, which
// fixes the order of dscale's sums; the wrapper's part holds kBwdPartRows
// rows, the most G of any tier.

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

// The two row sums of the backward (sum x^2 and sum dy * scale * x) over
// the block, in a fixed order: each thread's, a butterfly of warp shuffles,
// then the warps' partials in warp order. Every thread gets both totals.
__device__ __forceinline__ void block_sums2(float& a, float& b,
                                            float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = a;
    red[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  __syncthreads();     // red is read before the next row writes it
}

// Launch 1 of the backward, rows of 16-byte pieces: thread t holds pieces
// t, t + 256, ... of every row (NV of them), with their scale and column
// sums in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_row_kernel(const T* __restrict__ x,
                           const T* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int d,
                           float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const P* sv = reinterpret_cast<const P*>(scale);
  P s[NV];
  float acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) s[k] = sv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.0f;
  }
  __shared__ float red[2][kWarps];
  const float inv_d = 1.0f / static_cast<float>(d);
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const P* xv = reinterpret_cast<const P*>(x + row * d);
    const P* gv = reinterpret_cast<const P*>(dy + row * d);
    P* dxv = reinterpret_cast<P*>(dx + row * d);
    P xp[NV], gp[NV];
    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        xp[k] = xv[i];
        gp[k] = gv[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_float(xp[k].v[j]);
          ss += xf * xf;
          dot += to_float(gp[k].v[j]) * to_float(s[k].v[j]) * xf;
        }
      }
    }
    block_sums2(ss, dot, red);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float c = r * r * r * (dot * inv_d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nvec) {
        P out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_float(xp[k].v[j]);
          const float gf = to_float(gp[k].v[j]);
          out.v[j] = from_float<T>(r * to_float(s[k].v[j]) * gf - xf * c);
          acc[k][j] += gf * (xf * r);
        }
        dxv[i] = out;
      }
    }
  }
  float* pp = part + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(pp + i * VEC + j) =
            make_float4(acc[k][j], acc[k][j + 1], acc[k][j + 2],
                        acc[k][j + 3]);
    }
  }
}

// Launch 1 of the backward, any row: two passes over each row (the second
// from L1/L2); column c's sum lives in part[b, c], read, added to and
// written by the one thread that owns c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_any_kernel(const T* __restrict__ x,
                           const T* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int d,
                           float eps) {
  __shared__ float red[2][kWarps];
  const float inv_d = 1.0f / static_cast<float>(d);
  float* pp = part + static_cast<int64_t>(blockIdx.x) * d;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* dxr = dx + row * d;
    float ss = 0.0f, dot = 0.0f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xf = to_float(xr[i]);
      ss += xf * xf;
      dot += to_float(gr[i]) * to_float(scale[i]) * xf;
    }
    block_sums2(ss, dot, red);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float c = r * r * r * (dot * inv_d);
    const bool first = row == blockIdx.x;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xf = to_float(xr[i]);
      const float gf = to_float(gr[i]);
      dxr[i] = from_float<T>(r * to_float(scale[i]) * gf - xf * c);
      const float v = gf * (xf * r);
      pp[i] = first ? v : pp[i] + v;
    }
  }
}

// Launch 2 of the backward: dscale[c] from the G partials of column c. A
// block takes 32 columns, a lane each; warp w adds rows w, w + 8, ... of
// part in order, then the 8 warps' sums are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_cols_kernel(const float* __restrict__ part,
                            T* __restrict__ dscale, int blocks, int d) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float sum = 0.0f;
  if (c < d)
    for (int b = warp; b < blocks; b += kWarps)
      sum += part[static_cast<int64_t>(b) * d + c];
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][lane];
    dscale[c] = from_float<T>(total);
  }
}

template <typename T>
int launch_bwd_rows(const void* x, const void* scale, const void* dy,
                    void* dx, void* part, int rows, int d, int blocks,
                    float eps, int vec, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const int nvec = d / kVec;
#define RMS_BWD_ROW(NV)                                                   \
  rmsnorm_bwd_row_kernel<T, NV><<<blocks, kThreads, 0, st>>>(            \
      xp, sp, gp, dxp, pp, rows, d, eps)
  if (vec && nvec <= kThreads)
    RMS_BWD_ROW(1);
  else if (vec && nvec <= 2 * kThreads)
    RMS_BWD_ROW(2);
  else if (vec && nvec <= 4 * kThreads)
    RMS_BWD_ROW(4);
  else if (vec && nvec <= 8 * kThreads)
    RMS_BWD_ROW(8);
  else
    rmsnorm_bwd_any_kernel<T><<<blocks, kThreads, 0, st>>>(
        xp, sp, gp, dxp, pp, rows, d, eps);
#undef RMS_BWD_ROW
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_cols(const void* part, void* dscale, int blocks, int d,
                    void* stream) {
  const int grid = (d + 31) / 32;
  rmsnorm_bwd_cols_kernel<T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<T*>(dscale), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

// ---- the route's backward (see the note at the top) ----

constexpr int kBwdWarpPieces = 128;     // widest row of the warp tier
constexpr int kBwdBlockPieces = 1024;   // widest row of the block tier
// the yardstick's blocks at most (kernels/rmsnorm.py BWD_BLOCKS), and the
// rows of part the route's wrapper holds (BWD_PART_ROWS): the most blocks
// of any rows launch of launch_bwd
constexpr int kBwdBlocks = 264;
constexpr int kBwdPartRows = 396;
static_assert(kBwdBlocks <= kBwdPartRows, "part holds every G");

// One row's two sums over a thread's pieces, in piece order: sum x^2 and
// sum (dy * scale) * x, each an fma chain.
template <typename T, int VEC>
__device__ __forceinline__ void piece_sums(const Pack<T, VEC>& x,
                                           const Pack<T, VEC>& g,
                                           const Pack<T, VEC>& s, float& ss,
                                           float& dot) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float xf = to_float(x.v[j]);
    ss = __fmaf_rn(xf, xf, ss);
    dot = __fmaf_rn(__fmul_rn(to_float(g.v[j]), to_float(s.v[j])), xf, dot);
  }
}

// dx of a piece, and its terms of the column sums of dscale:
// dx = (r * scale) * dy - x * c, acc += dy * (x * r).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> piece_dx(const Pack<T, VEC>& x,
                                                 const Pack<T, VEC>& g,
                                                 const Pack<T, VEC>& s,
                                                 float r, float c,
                                                 float (&acc)[VEC]) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float xf = to_float(x.v[j]);
    const float gf = to_float(g.v[j]);
    out.v[j] = from_float<T>(__fsub_rn(
        __fmul_rn(__fmul_rn(r, to_float(s.v[j])), gf), __fmul_rn(xf, c)));
    acc[j] = __fmaf_rn(gf, __fmul_rn(xf, r), acc[j]);
  }
  return out;
}

// r = 1 / sqrt(ss / D + eps) and c = r^3 * (dot / D) from a row's sums.
__device__ __forceinline__ float2 row_scalars(float ss, float dot,
                                              float inv_d, float eps) {
  const float r = __frcp_rn(__fsqrt_rn(__fmaf_rn(ss, inv_d, eps)));
  return make_float2(r, __fmul_rn(__fmul_rn(__fmul_rn(r, r), r),
                                  __fmul_rn(dot, inv_d)));
}

// The pieces first, first + kStep, ... (NV of them) of a row's x and dy.
template <int kStep, typename P, int NV>
__device__ __forceinline__ void load_row(const P* __restrict__ xv,
                                         const P* __restrict__ gv,
                                         int first, int nvec, P (&xp)[NV],
                                         P (&gp)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = first + kStep * k;
    if (i < nvec) {
      xp[k] = xv[i];
      gp[k] = gv[i];
    }
  }
}

// A thread's share of a row's two sums, its pieces in order.
template <int kStep, typename T, int VEC, int NV>
__device__ __forceinline__ void thread_sums(const Pack<T, VEC> (&xp)[NV],
                                            const Pack<T, VEC> (&gp)[NV],
                                            const Pack<T, VEC> (&s)[NV],
                                            int first, int nvec, float& ss,
                                            float& dot) {
  ss = 0.0f;
  dot = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (first + kStep * k < nvec) piece_sums(xp[k], gp[k], s[k], ss, dot);
}

// The butterfly of xor shuffles over a warp: every lane gets both sums.
__device__ __forceinline__ void warp_sums2(float& ss, float& dot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
  }
}

// A thread's pieces of dx from the row's r and c, and their column terms.
template <int kStep, typename T, int VEC, int NV>
__device__ __forceinline__ void write_dx(Pack<T, VEC>* __restrict__ dxv,
                                         const Pack<T, VEC> (&xp)[NV],
                                         const Pack<T, VEC> (&gp)[NV],
                                         const Pack<T, VEC> (&s)[NV],
                                         int first, int nvec, float2 rc,
                                         float (&acc)[NV][VEC]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = first + kStep * k;
    if (i < nvec) dxv[i] = piece_dx(xp[k], gp[k], s[k], rc.x, rc.y, acc[k]);
  }
}

// Warp tier: lane l of warp w holds pieces l, l + 32, ... (NV of them) of
// its row; the loads of the warp's next row are issued before the current
// row's sums, so two rows are in flight a warp.
template <typename T, int NV>
__device__ __forceinline__ void bwd_warp_rows(const T* __restrict__ x,
                                              const T* __restrict__ scale,
                                              const T* __restrict__ dy,
                                              T* __restrict__ dx,
                                              float* __restrict__ part,
                                              int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const P* sv = reinterpret_cast<const P*>(scale);
  P s[NV];
  float acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) s[k] = sv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.0f;
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  P xa[NV], ga[NV], xb[NV], gb[NV];
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
#define RMS_ROW(R) reinterpret_cast<const P*>(x + (R) * d), \
                   reinterpret_cast<const P*>(dy + (R) * d)
#define RMS_FINISH(XP, GP)                                                \
  {                                                                       \
    float ss, dot;                                                        \
    thread_sums<32>(XP, GP, s, lane, nvec, ss, dot);                      \
    warp_sums2(ss, dot);                                                  \
    write_dx<32>(reinterpret_cast<P*>(dx + row * d), XP, GP, s, lane,     \
                 nvec, row_scalars(ss, dot, inv_d, eps), acc);            \
  }
  if (row < rows) load_row<32>(RMS_ROW(row), lane, nvec, xa, ga);
  while (row < rows) {                   // two rows an iteration: a, then b
    int64_t next = row + stride;
    if (next < rows) load_row<32>(RMS_ROW(next), lane, nvec, xb, gb);
    RMS_FINISH(xa, ga);
    row = next;
    if (row >= rows) break;
    next = row + stride;
    if (next < rows) load_row<32>(RMS_ROW(next), lane, nvec, xa, ga);
    RMS_FINISH(xb, gb);
    row = next;
  }
#undef RMS_FINISH
  // the block's 8 warps' column sums, added in warp order
  __shared__ float4 red[kWarps][NV * 32 * VEC / 4];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      red[warp][(i * VEC + j) / 4] = make_float4(
          acc[k][j], acc[k][j + 1], acc[k][j + 2], acc[k][j + 3]);
  }
  __syncthreads();
  float4* pp = reinterpret_cast<float4*>(part +
                                         static_cast<int64_t>(blockIdx.x) * d);
  for (int q = threadIdx.x; q < d / 4; q += kThreads) {
    float4 t = red[0][q];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 u = red[w][q];
      t = make_float4(__fadd_rn(t.x, u.x), __fadd_rn(t.y, u.y),
                      __fadd_rn(t.z, u.z), __fadd_rn(t.w, u.w));
    }
    pp[q] = t;
  }
}

// Block tier: thread t holds pieces t, t + 256, ... (NV of them) of the
// block's row, as rmsnorm_bwd_row_kernel; the loads of the block's next
// row are issued before the current row's sums, so two rows are in flight
// a block. One barrier a row: the warps' partials go to red[row parity], so
// the next row's writes cannot meet this row's reads (a warp writes row i +
// 2's only after the barrier of row i + 1, which every warp reaches after
// reading row i's).
template <typename T, int NV>
__device__ __forceinline__ void bwd_block_rows(const T* __restrict__ x,
                                               const T* __restrict__ scale,
                                               const T* __restrict__ dy,
                                               T* __restrict__ dx,
                                               float* __restrict__ part,
                                               int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const P* sv = reinterpret_cast<const P*>(scale);
  P s[NV];
  float acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * kThreads;
    if (i < nvec) s[k] = sv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.0f;
  }
  __shared__ float red[2][2][kWarps];
  const float inv_d = 1.0f / static_cast<float>(d);
  const int64_t stride = gridDim.x;
#define RMS_FINISH(XP, GP, PAR)                                          \
  {                                                                       \
    float ss, dot;                                                        \
    thread_sums<kThreads>(XP, GP, s, t, nvec, ss, dot);                   \
    warp_sums2(ss, dot);                                                  \
    if (lane == 0) {                                                      \
      red[PAR][0][warp] = ss;                                             \
      red[PAR][1][warp] = dot;                                            \
    }                                                                     \
    __syncthreads();                                                      \
    ss = red[PAR][0][0];                                                  \
    dot = red[PAR][1][0];                                                 \
    _Pragma("unroll") for (int w = 1; w < kWarps; ++w) {                  \
      ss = __fadd_rn(ss, red[PAR][0][w]);                                 \
      dot = __fadd_rn(dot, red[PAR][1][w]);                               \
    }                                                                     \
    write_dx<kThreads>(reinterpret_cast<P*>(dx + row * d), XP, GP, s, t,  \
                       nvec, row_scalars(ss, dot, inv_d, eps), acc);      \
  }
  P xa[NV], ga[NV], xb[NV], gb[NV];
  int64_t row = blockIdx.x;
  if (row < rows) load_row<kThreads>(RMS_ROW(row), t, nvec, xa, ga);
  while (row < rows) {                   // two rows an iteration: a, then b
    int64_t next = row + stride;
    if (next < rows) load_row<kThreads>(RMS_ROW(next), t, nvec, xb, gb);
    RMS_FINISH(xa, ga, 0);
    row = next;
    if (row >= rows) break;
    next = row + stride;
    if (next < rows) load_row<kThreads>(RMS_ROW(next), t, nvec, xa, ga);
    RMS_FINISH(xb, gb, 1);
    row = next;
  }
#undef RMS_FINISH
#undef RMS_ROW
  float* pp = part + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * kThreads;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(pp + i * VEC + j) =
            make_float4(acc[k][j], acc[k][j + 1], acc[k][j + 2],
                        acc[k][j + 3]);
    }
  }
}

// The route's kernels: the bodies above, one launch each.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_warp_kernel(const T* __restrict__ x,
                            const T* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int d,
                            float eps) {
  bwd_warp_rows<T, NV>(x, scale, dy, dx, part, rows, d, eps);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_block_kernel(const T* __restrict__ x,
                             const T* __restrict__ scale,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             float* __restrict__ part, int rows, int d,
                             float eps) {
  bwd_block_rows<T, NV>(x, scale, dy, dx, part, rows, d, eps);
}

// The route's backward: the rows launch of the row's tier (the yardstick's
// rows kernels where neither new tier takes it) at G blocks, then the
// yardstick's cols launch. Each tier's G is its walkers (a warp tier block
// takes kWarps rows at once) up to a grid, one block an SM where a thread
// holds four pieces (ptxas gives those kernels more than 128 registers),
// else as many as were fastest on the card at the training rows: 3 an SM
// at 2,048 bf16, 2 at 4,096.
template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* part, int rows, int d, float eps, int vec,
               void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const int nvec = d / kVec;
  int blocks = rows < kBwdBlocks ? rows : kBwdBlocks;
#define RMS_BWD_NEW(KERNEL, NV, WALK, GRID)                               \
  do {                                                                    \
    static_assert(GRID <= kBwdPartRows, "part holds every G");            \
    const int64_t walkers = (static_cast<int64_t>(rows) + WALK - 1) / WALK; \
    blocks = walkers < GRID ? static_cast<int>(walkers) : GRID;           \
    KERNEL<T, NV><<<blocks, kThreads, 0, st>>>(xp, sp, gp, dxp, pp, rows,  \
                                               d, eps);                   \
  } while (0)
  if (vec && nvec <= 32)
    RMS_BWD_NEW(rmsnorm_bwd_warp_kernel, 1, kWarps, 264);
  else if (vec && nvec <= 64)
    RMS_BWD_NEW(rmsnorm_bwd_warp_kernel, 2, kWarps, 264);
  else if (vec && nvec <= kBwdWarpPieces)
    RMS_BWD_NEW(rmsnorm_bwd_warp_kernel, 4, kWarps, 132);
  else if (vec && nvec <= kThreads)
    RMS_BWD_NEW(rmsnorm_bwd_block_kernel, 1, 1, 396);
  else if (vec && nvec <= 2 * kThreads)
    RMS_BWD_NEW(rmsnorm_bwd_block_kernel, 2, 1, 264);
  else if (vec && nvec <= kBwdBlockPieces)
    RMS_BWD_NEW(rmsnorm_bwd_block_kernel, 4, 1, 132);
  else {
    const int err = launch_bwd_rows<T>(x, scale, dy, dx, part, rows, d,
                                       blocks, eps, vec, stream);
    if (err != 0) return err;
  }
#undef RMS_BWD_NEW
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bwd_cols<T>(part, dscale, blocks, d, stream);
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

// The backward, the route's one call: dx (rows * d, x's type) and dscale
// (d, scale's type), through the fp32 column partials part[kBwdPartRows,
// d]; vec as below. Two launches.
int rmsnorm_bwd_f32(const void* x, const void* scale, const void* dy,
                    void* dx, void* dscale, void* part, int rows, int d,
                    float eps, int vec, void* stream) {
  return launch_bwd<float>(x, scale, dy, dx, dscale, part, rows, d, eps, vec,
                           stream);
}

int rmsnorm_bwd_bf16(const void* x, const void* scale, const void* dy,
                     void* dx, void* dscale, void* part, int rows, int d,
                     float eps, int vec, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, part, rows, d,
                                   eps, vec, stream);
}

// The yardstick's launch 1: dx (rows * d, x's type) and the fp32 column
// partials part[blocks, d], blocks <= rows; vec != 0 only when d is a
// multiple of 16 / sizeof(T) and x, dy, dx and scale are 16-byte aligned
// (part, from the allocator, is).
int rmsnorm_bwd_rows_f32(const void* x, const void* scale, const void* dy,
                         void* dx, void* part, int rows, int d, int blocks,
                         float eps, int vec, void* stream) {
  return launch_bwd_rows<float>(x, scale, dy, dx, part, rows, d, blocks, eps,
                                vec, stream);
}

int rmsnorm_bwd_rows_bf16(const void* x, const void* scale, const void* dy,
                          void* dx, void* part, int rows, int d, int blocks,
                          float eps, int vec, void* stream) {
  return launch_bwd_rows<__nv_bfloat16>(x, scale, dy, dx, part, rows, d,
                                        blocks, eps, vec, stream);
}

// The yardstick's launch 2: dscale[d] (scale's type) from part[blocks, d].
int rmsnorm_bwd_cols_f32(const void* part, void* dscale, int blocks, int d,
                         void* stream) {
  return launch_bwd_cols<float>(part, dscale, blocks, d, stream);
}

int rmsnorm_bwd_cols_bf16(const void* part, void* dscale, int blocks, int d,
                          void* stream) {
  return launch_bwd_cols<__nv_bfloat16>(part, dscale, blocks, d, stream);
}

}  // extern "C"
