// Fused LSTM cell for Hopper (sm_90a), bound to Python with ctypes: one
// step (lstm_cell_kernel), a whole sequence in one launch
// (lstm_seq_kernel), and its backpropagation through time in one launch
// (lstm_seq_bwd_staged_kernel on the paper's layers, lstm_seq_bwd_kernel
// above them and as its yardstick; each note stands above its kernel).
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
#include <stdint.h>

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

// lstm_seq_bwd_kernel: backpropagation through time over a whole sequence,
// one launch per layer. Replaces the backward of the JAX package's
// lax.scan over the cell (src/repro/models/lstm.py:68, differentiated by
// jax.grad; the JAX package has no backward kernel) and, in the port, the
// per-step loop of ops.lstm_seq_bwd's plain version (ref.lstm_seq_bwd).
// From the forward's saved gates [T,B,4H] (fp32: sigmoid(i), sigmoid(f),
// tanh(g), sigmoid(o)), cs [T,B,H] and c0, with W_h = kernel[Din:] [H,4H],
// for the cotangent dhs [T,B,H], per step t from the last:
//
//     dh   = dhs[t] + dh_next
//     dc   = dc_next + dh * o(1 - tanh(c_t)^2)
//     dz_t = (dc g i(1-i), dc c_{t-1} f(1-f), dc i(1-g^2), dh tanh(c_t) o(1-o))
//     dc_next = dc * f,   dh_next = dz_t W_h^T
//
// and writes dz [T,B,4H] fp32 and the final dh_next, dc_next (dh0, dc0,
// fp32). The products over all T*B rows (dW = [x; h_prev]^T dZ, db = sum dZ,
// dx = dZ W_x^T) stay plain torch products after the launch, as the JAX
// package leaves them to XLA.
//   Bound at the paper's layer 0 (T=40, B=8, H=50, fp32): dhs, cs (64 KB
// each), the gates (256 KB) and W_h (40 KB) read once, dz (256 KB) written
// once: ~0.68 MB, ~0.2 us at 3.35 TB/s; T * B * (2 * H * 4H + ~20 H) = 6.7
// MFLOP, ~0.1 us at 67 TFLOP/s fp32, so bytes bound it. The real floor is
// the recurrence, as in the forward: T dependent steps, each an H-deep chain
// of dependent FMAs, the quad's two shuffles and a barrier.
//   Design, mirroring lstm_seq_kernel: one block per batch row for all T
// steps (rows are independent: no grid-wide sync). Thread c owns column
// c = 4j + g (unit j, gate g), so a unit's four gates sit in neighbouring
// lanes. Per step each lane reads its own gate's activation and the quad
// shares them by shuffles; all four lanes of a unit run the same dh and dc
// update (same inputs, same bits) and each writes its gate's dz to global
// memory and to shared memory (gate-major, each gate's row padded to 4).
// After one barrier, lane (j, g) sums dz's gate block g against W_h[j,
// g*H ..] (an fmaf chain in column order; the weights live in its registers
// when 4H fits one block of kSeqThreadsReg and H <= kBwdRegCols, the paper's
// layers; else they are read from global memory / L2), and the quad adds its
// four partial sums as (p0 + p1) + (p2 + p3) by two xor shuffles, so every
// lane of the unit holds dh_next[j] bit for bit. dh and dc are kept in
// shared memory, each read and written only by its unit's quad (one warp:
// __syncwarp orders them), and dz is a double buffer, so one __syncthreads a
// step suffices. In the register tier each lane loads the next step's
// inputs while the current step computes. Fixed sum orders, no atomics: the
// same bits on every run (tests/test_torch_bwd_kernels.py models the order
// on the CPU against jax.grad).
constexpr int kBwdRegCols = 64;    // most columns of W_h a thread holds

// The step clock of the stamp instantiations: thread 0 of block 0 writes
// the SM's clock into stamps[t * kStampPhases + phase] once v (the
// phase's last result) is ready: v is stored to the slot first (a warp
// issues in order, so that store waits for v's producer), then the clock,
// read by an asm with a memory clobber so that nothing moves across it.
// Phases: 0 the step's start, 1 the gate update done (dz in shared
// memory), 2 past the barrier, 3 the dh_next chains done, 4 the quad's
// shuffles done. After the T steps' stamps, kStampEnds more (stamp_ends):
// 0 the kernel's entry, 1 its exit; the staged kernel's prologue: 2 its
// copies issued, 3 the first window's copies landed, 4 W_h in registers,
// 5 the first window's factors computed.
constexpr int kStampPhases = 5;
constexpr int kStampEnds = 6;

__device__ __forceinline__ void stamp_slot(long long* stamps, int index,
                                           float v) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  volatile long long* slot = stamps + index;
  *reinterpret_cast<volatile float*>(slot) = v;
  long long clk;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk)::"memory");
  *slot = clk;
}

__device__ __forceinline__ void stamp_step(long long* stamps, int t,
                                           int phase, float v) {
  stamp_slot(stamps, t * kStampPhases + phase, v);
}

// end: the slot (kStampEnds) after the steps' stamps
__device__ __forceinline__ void stamp_ends(long long* stamps, int n_t,
                                           int end, float v) {
  stamp_slot(stamps, n_t * kStampPhases + end, v);
}

// One step's inputs of column (j, g): its gate's activation, dhs, c_t and
// c_{t-1} (c0 at t = 0).
struct BwdIn {
  float act, dhs, ct, cp;
};

template <typename T>
__device__ __forceinline__ BwdIn bwd_load(const T* __restrict__ dhs,
                                          const float* __restrict__ gates,
                                          const T* __restrict__ cs,
                                          const T* __restrict__ c0, int t,
                                          int B, int H, int row, int j,
                                          int g) {
  const size_t rt = static_cast<size_t>(t) * B + row;
  BwdIn in;
  in.act = gates[rt * 4 * H + g * H + j];
  in.dhs = to_f32(dhs[rt * H + j]);
  in.ct = to_f32(cs[rt * H + j]);
  in.cp = t > 0 ? to_f32(cs[(rt - B) * H + j])
                : to_f32(c0[static_cast<size_t>(row) * H + j]);
  return in;
}

// One gate block's partial of dh_next[j]: sum over u < H of z[u] * w(u),
// an fmaf chain from 0 in column order; z is 16-byte aligned and zero from
// H up to H rounded to 4. Registers: wr[u] (zero past H), unrolled in full
// with no early exit (else wr would go to local memory).
template <int kCols>
__device__ __forceinline__ float dz_dot_reg(const float* __restrict__ z,
                                            const float (&wr)[kCols],
                                            int n4) {
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float a = 0.f;
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    if (q < n4) {
      const float4 v = z4[q];
      a = fmaf(v.x, wr[4 * q], a);
      a = fmaf(v.y, wr[4 * q + 1], a);
      a = fmaf(v.z, wr[4 * q + 2], a);
      a = fmaf(v.w, wr[4 * q + 3], a);
    }
  }
  return a;
}

template <typename T>
__device__ __forceinline__ float dz_dot(const float* __restrict__ z,
                                        const T* __restrict__ w, int H) {
  float a = 0.f;
  for (int u = 0; u < H; ++u) a = fmaf(z[u], to_f32(__ldg(w + u)), a);
  return a;
}

// kStamp (off on every route; chip_smoke.py launches it through
// lstm_seq_bwd_stamps_*): thread 0 of block 0 writes clock64 at each
// step's phase boundaries (stamp_step).
template <typename T, int kWReg, bool kStamp = false>
__global__ void __launch_bounds__(kWReg > 0 ? kSeqThreadsReg : kSeqThreads)
    lstm_seq_bwd_kernel(const T* __restrict__ dhs,
                        const float* __restrict__ gates,
                        const T* __restrict__ cs, const T* __restrict__ c0,
                        const T* __restrict__ w_h, float* __restrict__ dz,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        int n_t, int B, int H,
                        long long* __restrict__ stamps = nullptr) {
  if (kStamp) stamp_ends(stamps, n_t, 0, 0.f);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = (H + 3) & ~3;
  const int H4 = 4 * H;
  float* sdz = smem;                                       // [2][4][hp]
  float* sdh = sdz + 8 * hp;                               // [H]
  float* sdc = sdh + H;                                    // [H]
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                               // a multiple of 32
  const int quad = (tid & 31) & ~3;                        // lane of gate 0

  // register tier: one column a thread, W_h[j, g*H + u] for u < H
  float wr[kWReg > 0 ? kWReg : 1];
  if (kWReg > 0) {
    const int j = tid >> 2, g = tid & 3;
    const T* wp = w_h + static_cast<size_t>(j) * H4 + g * H;
#pragma unroll
    for (int u = 0; u < (kWReg > 0 ? kWReg : 1); ++u)
      wr[u] = tid < H4 && u < H ? to_f32(wp[u]) : 0.f;
  }
  for (int i = tid; i < 8 * hp; i += nt) sdz[i] = 0.f;
  for (int j = tid; j < H; j += nt) sdh[j] = sdc[j] = 0.f;
  BwdIn cur = {0.f, 0.f, 0.f, 0.f};
  if (kWReg > 0 && tid < H4)
    cur = bwd_load(dhs, gates, cs, c0, n_t - 1, B, H, row, tid >> 2,
                   tid & 3);
  __syncthreads();

  for (int t = n_t - 1; t >= 0; --t) {
    float* z = sdz + (t & 1) * 4 * hp;
    const size_t rt = static_cast<size_t>(t) * B + row;
    if (kStamp) stamp_step(stamps, t, 0, 0.f);
    BwdIn nxt = {0.f, 0.f, 0.f, 0.f};
    if (kWReg > 0 && tid < H4 && t > 0)      // next step's inputs in flight
      nxt = bwd_load(dhs, gates, cs, c0, t - 1, B, H, row, tid >> 2,
                     tid & 3);
    // every lane runs every pass (the shuffles need the whole warp)
    for (int base = 0; base < H4; base += nt) {
      const int c = base + tid;
      const bool live = c < H4;
      const int j = c >> 2, g = c & 3;
      BwdIn in = cur;
      float dh = 0.f, dc = 0.f;
      if (live) {
        if (kWReg == 0) in = bwd_load(dhs, gates, cs, c0, t, B, H, row, j, g);
        dh = __fadd_rn(in.dhs, sdh[j]);
        dc = sdc[j];
      }
      const float gi = __shfl_sync(0xffffffffu, in.act, quad);
      const float gf = __shfl_sync(0xffffffffu, in.act, quad + 1);
      const float gg = __shfl_sync(0xffffffffu, in.act, quad + 2);
      const float go = __shfl_sync(0xffffffffu, in.act, quad + 3);
      __syncwarp();              // the quad has read sdh and sdc before they move
      if (!live) continue;
      const float tc = tanhf(in.ct);
      dc = __fadd_rn(dc, __fmul_rn(dh, __fmul_rn(go, __fsub_rn(
                                           1.f, __fmul_rn(tc, tc)))));
      float d;
      if (g == 0)
        d = __fmul_rn(__fmul_rn(__fmul_rn(gg, gi), __fsub_rn(1.f, gi)), dc);
      else if (g == 1)
        d = __fmul_rn(__fmul_rn(__fmul_rn(in.cp, gf), __fsub_rn(1.f, gf)),
                      dc);
      else if (g == 2)
        d = __fmul_rn(__fmul_rn(gi, __fsub_rn(1.f, __fmul_rn(gg, gg))), dc);
      else
        d = __fmul_rn(__fmul_rn(__fmul_rn(tc, go), __fsub_rn(1.f, go)), dh);
      dz[rt * H4 + g * H + j] = d;
      z[g * hp + j] = d;
      if (g == 0) sdc[j] = __fmul_rn(dc, gf);
      if (kStamp) stamp_step(stamps, t, 1, d);
    }
    cur = nxt;
    __syncthreads();
    if (kStamp) stamp_step(stamps, t, 2, 0.f);
    // dh_next[j] = sum over the 4H columns of dz_t W_h[j, :]: lane (j, g)
    // sums gate block g, the quad adds the four in a fixed order
    for (int base = 0; base < H4; base += nt) {
      const int c = base + tid;
      const bool live = c < H4;
      const int j = c >> 2, g = c & 3;
      float a = 0.f;
      if (live)
        a = kWReg > 0 ? dz_dot_reg(z + g * hp, wr, hp >> 2)
                      : dz_dot(z + g * hp,
                               w_h + static_cast<size_t>(j) * H4 + g * H, H);
      if (kStamp) stamp_step(stamps, t, 3, a);
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 2));
      if (live && g == 0) sdh[j] = a;
      if (kStamp) stamp_step(stamps, t, 4, a);
    }
    __syncwarp();                // the quad's next step reads what lane 0 wrote
  }
  __syncthreads();
  for (int j = tid; j < H; j += nt) {
    dh0[static_cast<size_t>(row) * H + j] = sdh[j];
    dc0[static_cast<size_t>(row) * H + j] = sdc[j];
  }
  if (kStamp) stamp_ends(stamps, n_t, 1, sdh[0]);
}

template <typename T, int kWReg, bool kStamp = false>
int launch_seq_bwd_as(const void* dhs, const void* gates, const void* cs,
                      const void* c0, const void* w_h, void* dz, void* dh0,
                      void* dc0, int n_t, int B, int H, size_t smem,
                      int threads, cudaStream_t stream,
                      long long* stamps = nullptr) {
  lstm_seq_bwd_kernel<T, kWReg, kStamp><<<B, threads, smem, stream>>>(
      static_cast<const T*>(dhs), static_cast<const float*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(c0),
      static_cast<const T*>(w_h), static_cast<float*>(dz),
      static_cast<float*>(dh0), static_cast<float*>(dc0), n_t, B, H, stamps);
  return static_cast<int>(cudaGetLastError());
}

// The register tier of both backward kernels: the 4H columns fit one block
// of kSeqThreadsReg and H <= kBwdRegCols (the paper's layers).
inline bool bwd_reg_tier(int H) {
  return (4 * H + 31) / 32 * 32 <= kSeqThreadsReg && H <= kBwdRegCols;
}

// The yardstick (lstm_seq_bwd_kernel, the first one): W_h in registers,
// one column a thread, on the register tier; else read from global memory,
// the block's threads looping over the columns (the route's kernel there
// too).
template <typename T, bool kStamp = false>
int launch_seq_bwd(const void* dhs, const void* gates, const void* cs,
                   const void* c0, const void* w_h, void* dz, void* dh0,
                   void* dc0, int n_t, int B, int H, void* stream,
                   long long* stamps = nullptr) {
  const size_t hp = (static_cast<size_t>(H) + 3) & ~size_t{3};
  const size_t smem = (8 * hp + 2 * static_cast<size_t>(H)) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = (4 * H + 31) / 32 * 32;
  if (bwd_reg_tier(H)) {
    const int threads = cols < kSeqThreadsMin ? kSeqThreadsMin : cols;
    return launch_seq_bwd_as<T, kBwdRegCols, kStamp>(
        dhs, gates, cs, c0, w_h, dz, dh0, dc0, n_t, B, H, smem, threads, st,
        stamps);
  }
  if (kStamp) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_kernel<T, 0>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = cols > kSeqThreads ? kSeqThreads : cols;
  return launch_seq_bwd_as<T, 0>(dhs, gates, cs, c0, w_h, dz, dh0, dc0, n_t,
                                 B, H, smem, threads, st);
}

// lstm_seq_bwd_staged_kernel: the route's backward on the register tier
// (the paper's layers), redesigned for Hopper; the same recurrence and
// outputs as lstm_seq_bwd_kernel, which stays as its yardstick and runs
// wider layers. One block a batch row for all T steps, thread c = 4j + g
// on column (j, g) with W_h[j, g*H ..] in its registers, as there. What
// changes:
//   - no global memory inside the step loop. The block stages its row of
//     a window of W steps in shared memory, every copy in flight at once by
//     cp.async: each step's gates (16H bytes, by 16-byte copies where the
//     gates are 16-byte aligned), dhs and cs (the 16-byte chunks covering
//     a step's H elements) and c_{t-1} of the window's first step (c0 at t =
//     0). At the paper's T = 40, H = 50 (fp32) the whole sequence is one
//     window; longer sequences walk windows of W steps from the last, two
//     buffers, the next window's copies in flight under the current one;
//   - what does not depend on the recurrence is computed before a window's
//     steps by the whole block at once, a (step, unit) a thread: tanh(c_t),
//     f2 = o(1 - tanh(c_t)^2), each column's gate factor (g i(1-i),
//     c_{t-1} f(1-f), i(1-g^2) or tanh(c_t) o(1-o)) and dhs in fp32, so a
//     step loads four values a lane (the next step's under the current
//     step's dot) and its chain is dh = dhs + dh_next, dc += dh * f2, dz =
//     factor * dc (or * dh), dc *= f: the yardstick's roundings;
//   - dz is written to shared memory (over the lane's own factor) and stored
//     a window at a time, 16-byte stores, coalesced;
//   - dh_next and dc stay in registers: every lane of a unit's quad computes
//     them (same inputs, same bits), so no shared memory carries them;
//   - each lane's dot over its gate block runs as kBwdChains = 8
//     independent fmaf chains (chain k takes u = k, k + 8, ...; 7 deep at H
//     = 50 instead of 50), added ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6
//     + c7)), then the quad's four as (p0 + p1) + (p2 + p3) by two xor
//     shuffles. tests/test_torch_bwd_kernels.py models this order.
// One __syncthreads a step remains (dz of the step, double-buffered for the
// dot). kStamp: as lstm_seq_bwd_kernel's. At the paper's layers a window of
// all 40 steps takes ~96 KB of shared memory.
constexpr int kBwdChains = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The 4-byte words of shared memory a step's H elements of T are staged in:
// the 16-byte chunks covering them (one more for a start inside a chunk).
// A 16-byte aligned chunk never crosses a page, so reading a whole chunk
// around elements of the tensor is safe wherever the tensor starts.
__host__ __device__ __forceinline__ int staged_words(int H, int elem) {
  return 4 * ((H * elem + 15) / 16 + 1);
}

// Chunk k of the 16-byte chunks covering n elements of T from src, by
// cp.async, into dst + 4k (dst 16-byte aligned).
template <typename T>
__device__ __forceinline__ void stage_chunk(unsigned* dst, const T* src,
                                            int n, int k) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base =
      (a & ~uintptr_t{15}) + 16 * static_cast<uintptr_t>(k);
  if (base < a + n * sizeof(T))
    cp_async16(dst + 4 * k, reinterpret_cast<const void*>(base));
}

// Element j of the H elements from src staged in slot (stage_chunk).
template <typename T>
__device__ __forceinline__ float staged(const unsigned* slot, const T* src,
                                        int j) {
  const int off =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  return to_f32(reinterpret_cast<const T*>(slot)[off + j]);
}

// A window's buffer, in 4-byte words, each part 16-byte aligned but the
// last two: the gates [W][4H] (fp32), the factors [W][4H] (the gate factor
// of each column, then dz over it), the staged chunks of dhs [W][hw] and
// cs [W + 1][hw] (slot 0 holds c_{t-1} of the window's first step), f2
// [W][H] and dhs [W][H] (fp32), rounded up to 16 bytes.
__host__ __device__ __forceinline__ int window_step_words(int H, int hw) {
  return 10 * H + 2 * hw;
}

__host__ __device__ __forceinline__ int window_words(int W, int H, int hw) {
  return (W * window_step_words(H, hw) + hw + 3) & ~3;
}

struct Window {
  float *gates, *fac, *f2, *dhs;
  unsigned *sdh, *scs;
};

__device__ __forceinline__ Window window_at(float* buf, int W, int H,
                                            int hw) {
  Window w;
  w.gates = buf;
  w.fac = buf + W * 4 * H;
  w.sdh = reinterpret_cast<unsigned*>(w.fac + W * 4 * H);
  w.scs = w.sdh + W * hw;
  w.f2 = reinterpret_cast<float*>(w.scs + (W + 1) * hw);
  w.dhs = w.f2 + W * H;
  return w;
}

// The (step, index) pairs of a loop over `steps` steps of `per` indices,
// per <= blockDim.x: thread tid takes index tid % per of steps s0, s0 +
// spw, ... (spw = blockDim.x / per steps a pass, s0 = tid / per; threads
// past spw * per idle), so a warp's lanes walk their steps together.
struct StepWalk {
  int s0, q, spw;
};

__device__ __forceinline__ StepWalk step_walk(int per) {
  StepWalk w;
  w.spw = blockDim.x / per;
  w.s0 = threadIdx.x / per;
  w.q = threadIdx.x - w.s0 * per;
  if (w.s0 >= w.spw) w.s0 = 1 << 30;            // idle
  return w;
}

// Issue the copies of steps lo .. lo + steps - 1 of batch row `row` into
// the window at buf, as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_window(
    float* buf, const float* __restrict__ gates, const T* __restrict__ dhs,
    const T* __restrict__ cs, const T* __restrict__ c0, int lo, int steps,
    int W, int B, int H, int hw, int row) {
  const int H4 = 4 * H;
  const Window w = window_at(buf, W, H, hw);
  const bool g16 = (reinterpret_cast<uintptr_t>(gates) & 15) == 0;
  const StepWalk gw = step_walk(g16 ? H : H4);
  for (int s = gw.s0; s < steps; s += gw.spw) {
    const float* src = gates + (static_cast<size_t>(lo + s) * B + row) * H4;
    if (g16)
      cp_async16(w.gates + s * H4 + 4 * gw.q, src + 4 * gw.q);
    else
      cp_async4(w.gates + s * H4 + gw.q, src + gw.q);
  }
  const StepWalk ww = step_walk(hw / 4);          // 16-byte chunks a step
  for (int s = ww.s0; s < steps; s += ww.spw)
    stage_chunk(w.sdh + s * hw, dhs + (static_cast<size_t>(lo + s) * B + row)
                                          * H, H, ww.q);
  for (int s = ww.s0; s <= steps; s += ww.spw) {   // slot s: step lo - 1 + s
    const T* src = lo + s > 0
                       ? cs + (static_cast<size_t>(lo + s - 1) * B + row) * H
                       : c0 + static_cast<size_t>(row) * H;
    stage_chunk(w.scs + s * hw, src, H, ww.q);
  }
  cp_async_commit();
}

// What the steps of a staged window need that does not depend on the
// recurrence, computed by the whole block at once (one thread a (step,
// unit)): each column's gate factor (g i(1-i), c_{t-1} f(1-f), i(1-g^2),
// tanh(c_t) o(1-o)), f2 = o(1 - tanh(c_t)^2) and dhs in fp32; the
// yardstick's roundings.
template <typename T>
__device__ __forceinline__ void window_factors(
    const Window& w, const T* __restrict__ dhs, const T* __restrict__ cs,
    const T* __restrict__ c0, int lo, int steps, int B, int H, int hw,
    int row) {
  const int H4 = 4 * H;
  const StepWalk sw = step_walk(H);
  const int j = sw.q;
  for (int s = sw.s0; s < steps; s += sw.spw) {
    const int t = lo + s;
    const float* gs = w.gates + s * H4;
    const float gi = gs[j], gf = gs[H + j], gg = gs[2 * H + j],
                gc = gs[3 * H + j];
    const size_t rt = static_cast<size_t>(t) * B + row;
    const float ct = staged(w.scs + (s + 1) * hw, cs + rt * H, j);
    const float cp = staged(
        w.scs + s * hw,
        t > 0 ? cs + (rt - B) * H : c0 + static_cast<size_t>(row) * H, j);
    const float tc = tanhf(ct);
    float* fs = w.fac + s * H4;
    fs[j] = __fmul_rn(__fmul_rn(gg, gi), __fsub_rn(1.f, gi));
    fs[H + j] = __fmul_rn(__fmul_rn(cp, gf), __fsub_rn(1.f, gf));
    fs[2 * H + j] = __fmul_rn(gi, __fsub_rn(1.f, __fmul_rn(gg, gg)));
    fs[3 * H + j] = __fmul_rn(__fmul_rn(tc, gc), __fsub_rn(1.f, gc));
    w.f2[s * H + j] = __fmul_rn(gc, __fsub_rn(1.f, __fmul_rn(tc, tc)));
    w.dhs[s * H + j] = staged(w.sdh + s * hw, dhs + rt * H, j);
  }
}

// One step's loads of column (j, g) from its window slot s: dhs, f2, the
// column's gate factor and f.
struct StepF {
  float dhs, f2, fg, gf;
};

__device__ __forceinline__ StepF step_loads(const Window& w, int s, int H,
                                            int j, int g) {
  StepF f;
  f.dhs = w.dhs[s * H + j];
  f.f2 = w.f2[s * H + j];
  f.fg = w.fac[s * 4 * H + g * H + j];
  f.gf = w.gates[s * 4 * H + H + j];
  return f;
}

// dz_dot_reg's sum as kBwdChains independent fmaf chains: chain k adds u =
// k, k + 8, ... in order, then ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 +
// c7)).
template <int kCols>
__device__ __forceinline__ float dz_dot_chains(const float* __restrict__ z,
                                               const float (&wr)[kCols],
                                               int n4) {
  static_assert(kBwdChains == 8, "two float4 a round");
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float c[kBwdChains];
#pragma unroll
  for (int k = 0; k < kBwdChains; ++k) c[k] = 0.f;
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
    if (q < n4) {
      const float4 v = z4[q];
      const int k = 4 * (q & 1);
      c[k] = fmaf(v.x, wr[4 * q], c[k]);
      c[k + 1] = fmaf(v.y, wr[4 * q + 1], c[k + 1]);
      c[k + 2] = fmaf(v.z, wr[4 * q + 2], c[k + 2]);
      c[k + 3] = fmaf(v.w, wr[4 * q + 3], c[k + 3]);
    }
  }
  return __fadd_rn(
      __fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3])),
      __fadd_rn(__fadd_rn(c[4], c[5]), __fadd_rn(c[6], c[7])));
}

// One block an SM (B blocks, a batch row each): ptxas is told so, or it
// holds the kernel to 128 registers, for two blocks an SM, and spills.
template <typename T, bool kStamp>
__global__ void __launch_bounds__(kSeqThreadsReg, 1)
    lstm_seq_bwd_staged_kernel(const T* __restrict__ dhs,
                               const float* __restrict__ gates,
                               const T* __restrict__ cs,
                               const T* __restrict__ c0,
                               const T* __restrict__ w_h,
                               float* __restrict__ dz,
                               float* __restrict__ dh0,
                               float* __restrict__ dc0, int n_t, int B,
                               int H, int W, long long* __restrict__ stamps) {
  if (kStamp) stamp_ends(stamps, n_t, 0, 0.f);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hp = (H + 3) & ~3;
  const int H4 = 4 * H;
  const int hw = staged_words(H, sizeof(T));
  const int buf_words = window_words(W, H, hw);
  float* zb = smem;                                        // [2][4][hp]
  float* bufs = zb + 8 * hp;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid >> 2, g = tid & 3;
  const bool live = tid < H4;
  const int nwin = (n_t + W - 1) / W;

  // window k: steps lo(k) .. hi(k), from the last. The first two windows'
  // copies go out first, then W_h's register loads, which land under the
  // first window's factor pass.
  const int hi0 = n_t - 1, lo0 = max(0, hi0 - W + 1);
  stage_window(bufs, gates, dhs, cs, c0, lo0, hi0 - lo0 + 1, W, B, H, hw,
               row);
  if (nwin > 1) {
    const int hi1 = hi0 - W, lo1 = max(0, hi1 - W + 1);
    stage_window(bufs + buf_words, gates, dhs, cs, c0, lo1, hi1 - lo1 + 1, W,
                 B, H, hw, row);
  }
  float wr[kBwdRegCols];                    // W_h[j, g*H + u], zero past H
  const T* wp = w_h + static_cast<size_t>(j) * H4 + g * H;
#pragma unroll
  for (int u = 0; u < kBwdRegCols; ++u)
    wr[u] = live && u < H ? to_f32(wp[u]) : 0.f;
  for (int i = tid; i < 8 * hp; i += blockDim.x) zb[i] = 0.f;
  if (kStamp) stamp_ends(stamps, n_t, 2, 0.f);

  float dhn = 0.f, dc = 0.f;        // dh_next and dc_next of unit j
  for (int k = 0; k < nwin; ++k) {
    const int hi = n_t - 1 - k * W, lo = max(0, hi - W + 1);
    float* buf = bufs + (k & 1) * buf_words;
    const Window win = window_at(buf, W, H, hw);
    if (k + 1 < nwin)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (kStamp && k == 0) {
      stamp_ends(stamps, n_t, 3, 0.f);
      stamp_ends(stamps, n_t, 4, wr[0] + wr[kBwdRegCols - 1]);
    }
    window_factors(win, dhs, cs, c0, lo, hi - lo + 1, B, H, hw, row);
    __syncthreads();
    if (kStamp && k == 0) stamp_ends(stamps, n_t, 5, 0.f);
    StepF f = {0.f, 0.f, 0.f, 0.f};
    if (live) f = step_loads(win, hi - lo, H, j, g);
    for (int t = hi; t >= lo; --t) {
      const int s = t - lo;
      if (kStamp) stamp_step(stamps, t, 0, 0.f);
      const float dh = __fadd_rn(f.dhs, dhn);
      dc = __fadd_rn(dc, __fmul_rn(dh, f.f2));
      const float d = __fmul_rn(f.fg, g == 3 ? dh : dc);
      dc = __fmul_rn(dc, f.gf);
      float* z = zb + (t & 1) * 4 * hp;
      if (live) {
        z[g * hp + j] = d;
        win.fac[s * H4 + g * H + j] = d;   // over the lane's own factor
      }
      if (kStamp) stamp_step(stamps, t, 1, d);
      __syncthreads();
      if (kStamp) stamp_step(stamps, t, 2, 0.f);
      if (live && t > lo) f = step_loads(win, s - 1, H, j, g);
      float a = dz_dot_chains(z + g * hp, wr, hp >> 2);
      if (kStamp) stamp_step(stamps, t, 3, a);
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 2));
      dhn = a;
      if (kStamp) stamp_step(stamps, t, 4, a);
    }
    __syncthreads();                       // the window's dz, all in fac
    for (int i = tid; i < (hi - lo + 1) * H; i += blockDim.x) {
      const int s = i / H, q = i - s * H;
      reinterpret_cast<float4*>(
          dz + (static_cast<size_t>(lo + s) * B + row) * H4)[q] =
          reinterpret_cast<const float4*>(win.fac + s * H4)[q];
    }
    if (k + 2 < nwin) {
      __syncthreads();             // buf's dz are read before copies land
      const int hi2 = hi - 2 * W, lo2 = max(0, hi2 - W + 1);
      stage_window(buf, gates, dhs, cs, c0, lo2, hi2 - lo2 + 1, W, B, H, hw,
                   row);
    }
  }
  if (live && g == 0) {
    dh0[static_cast<size_t>(row) * H + j] = dhn;
    dc0[static_cast<size_t>(row) * H + j] = dc;
  }
  if (kStamp) stamp_ends(stamps, n_t, 1, dc);
}

// The staged kernel's window: every step in one buffer where it fits the
// shared memory, else two buffers of as many steps as fit.
template <typename T, bool kStamp = false>
int launch_seq_bwd_staged(const void* dhs, const void* gates, const void* cs,
                          const void* c0, const void* w_h, void* dz,
                          void* dh0, void* dc0, int n_t, int B, int H,
                          void* stream, long long* stamps = nullptr) {
  if (!bwd_reg_tier(H)) return static_cast<int>(cudaErrorInvalidValue);
  const int hw = staged_words(H, sizeof(T));
  const int hp = (H + 3) & ~3;
  const int fixed = 8 * hp;
  const int cap = static_cast<int>(kMaxSmem / sizeof(float)) - fixed;
  int W = n_t, nbuf = 1;
  if (window_words(W, H, hw) > cap) {
    nbuf = 2;
    W = (cap / 2 - hw - 3) / window_step_words(H, hw);
  }
  const size_t smem =
      (static_cast<size_t>(fixed) + nbuf * window_words(W, H, hw)) *
      sizeof(float);
  auto kern = lstm_seq_bwd_staged_kernel<T, kStamp>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cols = (4 * H + 31) / 32 * 32;
  const int threads = cols < kSeqThreadsMin ? kSeqThreadsMin : cols;
  kern<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dhs), static_cast<const float*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(c0),
      static_cast<const T*>(w_h), static_cast<float*>(dz),
      static_cast<float*>(dh0), static_cast<float*>(dc0), n_t, B, H, W,
      stamps);
  return static_cast<int>(cudaGetLastError());
}

// The route: the staged kernel on the register tier, the yardstick's
// global-memory kernel above it.
template <typename T>
int launch_seq_bwd_route(const void* dhs, const void* gates, const void* cs,
                         const void* c0, const void* w_h, void* dz, void* dh0,
                         void* dc0, int n_t, int B, int H, void* stream) {
  if (bwd_reg_tier(H))
    return launch_seq_bwd_staged<T>(dhs, gates, cs, c0, w_h, dz, dh0, dc0,
                                    n_t, B, H, stream);
  return launch_seq_bwd<T>(dhs, gates, cs, c0, w_h, dz, dh0, dc0, n_t, B, H,
                           stream);
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

// dhs/cs [n_t,B,H], c0 [B,H], w_h [H,4H] in one type; gates [n_t,B,4H]
// fp32; dz [n_t,B,4H], dh0/dc0 [B,H] fp32.
// The route: lstm_seq_bwd_staged_kernel on the register tier (4H <= 256,
// H <= 64), else lstm_seq_bwd_kernel from global memory.
int lstm_seq_bwd_f32(const void* dhs, const void* gates, const void* cs,
                     const void* c0, const void* w_h, void* dz, void* dh0,
                     void* dc0, int n_t, int B, int H, void* stream) {
  return launch_seq_bwd_route<float>(dhs, gates, cs, c0, w_h, dz, dh0, dc0,
                                     n_t, B, H, stream);
}

int lstm_seq_bwd_bf16(const void* dhs, const void* gates, const void* cs,
                      const void* c0, const void* w_h, void* dz, void* dh0,
                      void* dc0, int n_t, int B, int H, void* stream) {
  return launch_seq_bwd_route<__nv_bfloat16>(dhs, gates, cs, c0, w_h, dz,
                                             dh0, dc0, n_t, B, H, stream);
}

// The yardstick: lstm_seq_bwd_kernel at every width, as the route ran it
// before the staged kernel. Same arguments.
int lstm_seq_bwd_yardstick_f32(const void* dhs, const void* gates,
                               const void* cs, const void* c0,
                               const void* w_h, void* dz, void* dh0,
                               void* dc0, int n_t, int B, int H,
                               void* stream) {
  return launch_seq_bwd<float>(dhs, gates, cs, c0, w_h, dz, dh0, dc0, n_t, B,
                               H, stream);
}

int lstm_seq_bwd_yardstick_bf16(const void* dhs, const void* gates,
                                const void* cs, const void* c0,
                                const void* w_h, void* dz, void* dh0,
                                void* dc0, int n_t, int B, int H,
                                void* stream) {
  return launch_seq_bwd<__nv_bfloat16>(dhs, gates, cs, c0, w_h, dz, dh0, dc0,
                                       n_t, B, H, stream);
}

// The stamp instantiations (fp32, register tier only, else CUDA error 1):
// staged != 0 the route's kernel, 0 the yardstick's, with stamps n_t *
// kStampPhases + kStampEnds int64 written by thread 0 of block 0
// (stamp_step, stamp_ends). Timing probes only.
int lstm_seq_bwd_stamps_f32(const void* dhs, const void* gates,
                            const void* cs, const void* c0, const void* w_h,
                            void* dz, void* dh0, void* dc0, int n_t, int B,
                            int H, void* stamps, int staged, void* stream) {
  long long* st = static_cast<long long*>(stamps);
  if (staged)
    return launch_seq_bwd_staged<float, true>(dhs, gates, cs, c0, w_h, dz,
                                              dh0, dc0, n_t, B, H, stream,
                                              st);
  return launch_seq_bwd<float, true>(dhs, gates, cs, c0, w_h, dz, dh0, dc0,
                                     n_t, B, H, stream, st);
}

}  // extern "C"
