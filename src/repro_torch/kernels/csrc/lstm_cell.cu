// Fused LSTM cell for Hopper (sm_90a), bound to Python with ctypes: one
// step (lstm_cell_kernel) and a whole sequence in one launch
// (lstm_seq_kernel).
//
// Replaces the TPU kernel repro/kernels/lstm_cell.py::_cell_kernel (Pallas).
// A step computes, for x [B,Din], h/c [B,H], W [Din+H, 4H], b [4H] (Keras
// gate order i, f, g, o along the 4H axis):
//
//     z  = [x, h] @ W + b                       (fp32 accumulation)
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')                (outputs in the input type)
//
// lstm_cell_kernel, one step. One block per (batch tile of kBT rows, hidden
// tile of kHT units); the block stages its [x, h] rows in shared memory as
// fp32, and thread (r, j) runs the four gate sums of unit j over k = 0 ..
// Din+H-1 in order, reading W[k, g*H + j] coalesced across j. Bound at the
// paper's shapes (B=8, H=50, Din=95 or 50, fp32): W read once, 116 KB for
// layer 0, plus ~8 KB of activations, ~37 ns at 3.35 TB/s; its 0.46 MFLOP
// ~7 ns at 67 TFLOP/s fp32, so bytes bound it. A launch costs microseconds
// of latency, far above either, and the model needs T of them a layer.
//
// lstm_seq_kernel, a whole sequence: x_seq [T,B,Din], h0/c0 [B,H] ->
// hs, cs [T,B,H] (input type) and gates [T,B,4H] (fp32: sigmoid(i),
// sigmoid(f), tanh(g), sigmoid(o) of every step, which the backward reads
// instead of recomputing z). Batch rows are independent across time, so
// block b owns row b for all T steps and no grid-wide sync is needed.
// Thread c owns gate column c = 4j + g (unit j, gate g) and runs its sum
// alone; the four gates of a unit sit in neighbouring lanes, meet by
// shuffles, and each lane finishes the unit's cell. Where one column a
// thread fits the block and Din + H <= kMaxRegRows (the paper's layers:
// 4H = 200 columns, 145 and 100 rows), the column's weights live in the
// thread's registers for the whole sequence, so a row costs one FFMA and a
// quarter of a 16-byte shared load of [x_t, h_{t-1}]; else W is read from
// global memory / L2 each step (the JAX sweep's wider shapes, where 4H >
// 256). [x_t, h_{t-1}] is a double
// buffer in shared memory, x comes in windows of steps loaded all at once,
// and c stays in shared memory, so one __syncthreads a step suffices.
//   Bound at the paper's layer 0 (T=40, B=8, fp32): W once (116 KB), x_seq
// (122 KB), hs and cs (128 KB) and gates (256 KB) cross HBM once: 0.62 MB,
// ~0.19 us at 3.35 TB/s; 2 * T * B * (Din+H) * 4H = 18.6 MFLOP, ~0.28 us at
// 67 TFLOP/s fp32, so operations bound it. The real floor is the recurrence:
// T dependent steps, each a (Din+H)-deep chain of dependent FMAs (~4.5
// cycles each on the H100, measured), plus the gate math, the shuffles and
// a barrier; some 13 us a layer at 1.98 GHz, ~50x the bound, and no
// schedule of the sums can shorten it without changing the bits.
//
// Same bits in both kernels: each gate column sums fmaf over k = 0 ..
// Din+H-1 in order from 0, and the arithmetic after the sums is two
// __noinline__ functions (gate_act, cell_update: explicit round-to-nearest
// intrinsics, so nvcc contracts nothing) that both call. In bf16, h and c
// are rounded to bf16 at every step, as the step kernel's outputs are. So
// the sequence kernel equals T chained step launches bit for bit. No
// atomics and no split reductions: the same bits on every run, which the
// Coordinator's bit-equality with the sequential reference needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 8;             // step kernel: batch rows per block
constexpr int kHT = 32;            // step kernel: hidden units per block
constexpr int kSeqThreads = 512;   // sequence kernel: most threads a block
constexpr int kSeqThreadsMin = 128;  // ... and fewest (they stage W and x)
constexpr int kSeqThreadsReg = 256;  // ... with a thread's column in registers
constexpr int kMaxRegRows = 160;   // most rows of W held in registers
constexpr int kMaxSmem = 232448;   // a block's dynamic opt-in bytes

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
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
}

// The arithmetic after a gate's sum, in two pieces that both kernels call
// (never inlined, explicit round-to-nearest intrinsics, so their bits
// cannot differ): one gate's activation (sigmoid, or tanh for gate 2), and
// the cell update from the four activated gates, (c', h').
__device__ __noinline__ float gate_act(float sum, float bias, int gate) {
  const float z = __fadd_rn(sum, bias);
  return gate == 2 ? tanhf(z) : sigmoid(z);
}

__device__ __noinline__ float2 cell_update(float i, float f, float g,
                                           float o, float c) {
  const float c_new = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  return make_float2(c_new, __fmul_rn(o, tanhf(c_new)));
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
  const size_t o = static_cast<size_t>(b0 + r) * H + j;
  const float2 ch = cell_update(
      gate_act(ai, to_f32(bias[j]), 0), gate_act(af, to_f32(bias[H + j]), 1),
      gate_act(ag, to_f32(bias[2 * H + j]), 2),
      gate_act(ao, to_f32(bias[3 * H + j]), 3), to_f32(c[o]));
  h_out[o] = from_f32<T>(ch.y);
  c_out[o] = from_f32<T>(ch.x);
}

// One gate column's sum over the n rows of W from wc (the column's first
// weight, rows `stride` apart, in global memory / L2) against n values v
// (shared memory, 16-byte aligned): an fmaf chain in row order, as the
// step kernel sums.
template <typename T>
__device__ __forceinline__ float column_sum(const float* __restrict__ v,
                                            const T* __restrict__ wc, int n,
                                            int stride, float a) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= n; k += 4, wc += 4 * stride) {
    const float4 xv = v4[k >> 2];
    a = fmaf(xv.x, to_f32(__ldg(wc)), a);
    a = fmaf(xv.y, to_f32(__ldg(wc + stride)), a);
    a = fmaf(xv.z, to_f32(__ldg(wc + 2 * stride)), a);
    a = fmaf(xv.w, to_f32(__ldg(wc + 3 * stride)), a);
  }
  for (; k < n; ++k, wc += stride) a = fmaf(v[k], to_f32(__ldg(wc)), a);
  return a;
}

// The same sum with the column's weights in registers: wr[k] for the rows
// of the n / 4 whole groups of four (n / 4 <= kRows / 4), wt[u] for the
// n % 4 rows after them. Unrolled in full with no early exit (else wr
// would go to local memory), so each row is one FFMA on a register and a
// quarter of a 16-byte load of v; the tail rows go last, in order.
template <int kRows>
__device__ __forceinline__ float column_sum_reg(const float* __restrict__ v,
                                                const float (&wr)[kRows],
                                                const float (&wt)[3], int n,
                                                float a) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int n4 = n >> 2, rem = n & 3;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    if (q < n4) {
      const float4 xv = v4[q];
      a = fmaf(xv.x, wr[4 * q], a);
      a = fmaf(xv.y, wr[4 * q + 1], a);
      a = fmaf(xv.z, wr[4 * q + 2], a);
      a = fmaf(xv.w, wr[4 * q + 3], a);
    }
  }
  const float* vt = v + 4 * n4;
  if (rem > 0) a = fmaf(vt[0], wt[0], a);
  if (rem > 1) a = fmaf(vt[1], wt[1], a);
  if (rem > 2) a = fmaf(vt[2], wt[2], a);
  return a;
}

// One block per batch row, for all T steps. A thread owns gate column
// c = 4j + g (unit j, gate g) and sums it alone, so the four gates of a
// unit sit in four neighbouring lanes and meet by shuffles; the one barrier
// a step publishes h. W: kWReg > 0, the thread's column in registers
// (kWReg >= Din + H rows, one column a thread); else read from global
// memory / L2 every step. Shared memory, in floats: [x_t, h_{t-1}] [2][dxh
// rounded up to 4]; x of a window of t_win steps [t_win][Din], loaded a
// window at a time; c [H]; bias [4H].
template <typename T, int kWReg>
__global__ void __launch_bounds__(kWReg > 0 ? kSeqThreadsReg : kSeqThreads)
    lstm_seq_kernel(const T* __restrict__ x, const T* __restrict__ h0,
                    const T* __restrict__ c0, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ hs,
                    T* __restrict__ cs, float* __restrict__ gates, int n_t,
                    int B, int Din, int H, int t_win) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dxh = Din + H;
  const int dxp = (dxh + 3) & ~3;
  const int H4 = 4 * H;
  float* sxh = smem;                                       // [2][dxp]
  float* sx = sxh + 2 * dxp;                               // [t_win][Din]
  float* sc = sx + t_win * Din;                            // [H]
  float* sb = sc + H;                                      // [4H]
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                               // a multiple of 32
  const int quad = (tid & 31) & ~3;                        // lane of gate 0

  // this thread's column, row after row: whole groups of four in wr, the
  // rows after them in wt
  float wr[kWReg > 0 ? kWReg : 1], wt[3] = {0.f, 0.f, 0.f};
  if (kWReg > 0) {
    const int full = dxh & ~3;
    const T* wp = w + (tid & 3) * H + (tid >> 2);
#pragma unroll
    for (int k = 0; k < (kWReg > 0 ? kWReg : 1); ++k, wp += H4)
      wr[k] = tid < H4 && k < full ? to_f32(*wp) : 0.f;
    wp = w + static_cast<size_t>(full) * H4 + (tid & 3) * H + (tid >> 2);
#pragma unroll
    for (int u = 0; u < 3; ++u, wp += H4)
      if (tid < H4 && full + u < dxh) wt[u] = to_f32(*wp);
  }
  for (int i = tid; i < H4; i += nt) sb[i] = to_f32(bias[i]);
  for (int j = tid; j < H; j += nt) {
    sxh[Din + j] = to_f32(h0[static_cast<size_t>(row) * H + j]);
    sc[j] = to_f32(c0[static_cast<size_t>(row) * H + j]);
  }

  for (int t = 0; t < n_t; ++t) {
    const int tw = t % t_win;
    float* cur = sxh + (t & 1) * dxp;
    float* nxt = sxh + ((t + 1) & 1) * dxp;
    if (tw == 0) {           // the next window's x rows, many loads in flight
      const int rows = min(t_win, n_t - t);
      const T* xw = x + (static_cast<size_t>(t) * B + row) * Din;
      const size_t step = static_cast<size_t>(B) * Din;
      for (int k = tid; k < Din; k += nt) {
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          sx[r * Din + k] = to_f32(xw[r * step + k]);
      }
      __syncthreads();
      for (int k = tid; k < Din; k += nt) cur[k] = sx[k];
      __syncthreads();
    }
    // every lane runs every pass (the shuffles need the whole warp)
    for (int base = 0; base < H4; base += nt) {
      const int c = base + tid;
      const bool live = c < H4;
      const int j = c >> 2, g = c & 3;
      float act = 0.f, c_prev = 0.f;
      if (live) {
        float a;
        a = kWReg > 0 ? column_sum_reg(cur, wr, wt, dxh, 0.f)
                      : column_sum(cur, w + g * H + j, dxh, H4, 0.f);
        act = gate_act(a, sb[g * H + j], g);
        c_prev = sc[j];
      }
      const float gi = __shfl_sync(0xffffffffu, act, quad);
      const float gf = __shfl_sync(0xffffffffu, act, quad + 1);
      const float gg = __shfl_sync(0xffffffffu, act, quad + 2);
      const float go = __shfl_sync(0xffffffffu, act, quad + 3);
      __syncwarp();                // every lane has read sc before it moves
      if (!live) continue;
      // the unit's four lanes all run the update (same inputs, same bits)
      // and share the stores
      const float2 ch = cell_update(gi, gf, gg, go, c_prev);
      gates[(static_cast<size_t>(t) * B + row) * H4 + g * H + j] = act;
      const size_t o = (static_cast<size_t>(t) * B + row) * H + j;
      if (g == 0) {
        const T h_t = from_f32<T>(ch.y);
        hs[o] = h_t;
        nxt[Din + j] = to_f32(h_t);
      } else if (g == 1) {
        const T c_t = from_f32<T>(ch.x);
        cs[o] = c_t;
        sc[j] = to_f32(c_t);
      }
    }
    if (t + 1 < n_t && tw + 1 < t_win)    // x_{t+1}, from the window
      for (int k = tid; k < Din; k += nt) nxt[k] = sx[(tw + 1) * Din + k];
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w,
           const void* b, void* h_out, void* c_out, int B, int Din, int H,
           void* stream) {
  const size_t smem = static_cast<size_t>(kBT) * (Din + H) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
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

template <typename T, int kWReg>
int launch_seq_as(const void* x, const void* h0, const void* c0,
                  const void* w, const void* b, void* hs, void* cs,
                  void* gates, int n_t, int B, int Din, int H, int t_win,
                  size_t smem, int threads, cudaStream_t stream) {
  auto kern = lstm_seq_kernel<T, kWReg>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(hs), static_cast<T*>(cs),
      static_cast<float*>(gates), n_t, B, Din, H, t_win);
  return static_cast<int>(cudaGetLastError());
}

// W lives in registers, a column a thread, when the columns fit one block
// of kSeqThreadsReg and Din + H <= kMaxRegRows (the paper's layers), in the
// smallest tier that holds the rows; else it is read from global memory.
// The x window takes the shared memory left.
template <typename T>
int launch_seq(const void* x, const void* h0, const void* c0, const void* w,
               const void* b, void* hs, void* cs, void* gates, int n_t,
               int B, int Din, int H, void* stream) {
  const size_t f = sizeof(float);
  const size_t din = static_cast<size_t>(Din), h = static_cast<size_t>(H);
  const size_t dxh = din + h;
  const size_t held = (2 * ((dxh + 3) & ~size_t{3}) + 5 * h) * f;
  const size_t x_step = din * f;
  if (held + x_step > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fit = (kMaxSmem - held) / x_step;
  const int t_win = static_cast<int>(fit < size_t(n_t) ? fit : n_t);
  const size_t smem = held + t_win * x_step;
  const int cols = (4 * H + 31) / 32 * 32;
  const int threads = cols < kSeqThreadsMin ? kSeqThreadsMin
                      : cols > kSeqThreads  ? kSeqThreads
                                            : cols;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = cols <= kSeqThreadsReg ? static_cast<int>(dxh) : 1 << 30;
  if (rows <= 64)
    return launch_seq_as<T, 64>(x, h0, c0, w, b, hs, cs, gates, n_t, B, Din,
                                H, t_win, smem, threads, st);
  if (rows <= 128)
    return launch_seq_as<T, 128>(x, h0, c0, w, b, hs, cs, gates, n_t, B, Din,
                                 H, t_win, smem, threads, st);
  if (rows <= kMaxRegRows)
    return launch_seq_as<T, kMaxRegRows>(x, h0, c0, w, b, hs, cs, gates, n_t,
                                         B, Din, H, t_win, smem, threads, st);
  return launch_seq_as<T, 0>(x, h0, c0, w, b, hs, cs, gates, n_t, B, Din, H,
                             t_win, smem, threads, st);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
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

// x [n_t,B,Din], h0/c0 [B,H], w [Din+H,4H], b [4H] in one type; hs/cs
// [n_t,B,H] in that type, gates [n_t,B,4H] fp32.
int lstm_seq_f32(const void* x, const void* h0, const void* c0,
                 const void* w, const void* b, void* hs, void* cs,
                 void* gates, int n_t, int B, int Din, int H, void* stream) {
  return launch_seq<float>(x, h0, c0, w, b, hs, cs, gates, n_t, B, Din, H,
                           stream);
}

int lstm_seq_bf16(const void* x, const void* h0, const void* c0,
                  const void* w, const void* b, void* hs, void* cs,
                  void* gates, int n_t, int B, int Din, int H, void* stream) {
  return launch_seq<__nv_bfloat16>(x, h0, c0, w, b, hs, cs, gates, n_t, B,
                                   Din, H, stream);
}

}  // extern "C"
