// TernGrad 2-bit codec for Hopper (sm_90a), over a whole gradient at once,
// bound to Python with ctypes.
//
// Replaces the TPU kernels repro/kernels/ternary.py::_encode_kernel and
// ::_decode_kernel (Pallas), and around them the per-leaf torch ops of the
// JAX codec (repro/optim/compression.py: the scale max|g|, g + r, the
// decode t * s and the residual c - d). One launch covers every leaf of a
// gradient: the leaves are described by a table (Table, passed by value
// as a __grid_constant__ parameter, so no host-to-device copy), which gives
// each leaf its pointers, its element count n, its element offset into a
// padded virtual concatenation (every leaf padded to a multiple of 16, so
// every leaf starts on a 64-byte boundary of the fp32 outputs and a 4-byte
// boundary of the packed stream) and its run of blocks. A pad element reads
// as 0.0 and encodes as 0b00.
//
//   code_i = gate && |c_i| >= s/2 ? (c_i > 0 ? 0b01 : 0b10) : 0b00
//   byte_j = code_4j | code_4j+1 << 2 | code_4j+2 << 4 | code_4j+3 << 6
//   decoded_i = v_i * s  with v = +1.0, -1.0 or 0.0 for 0b01, 0b10, else
//
// The codec (flag kCodec) gates on isfinite(s), so for s = inf or NaN every
// code is 0 and every decoded value 0 * s = NaN, as the JAX codec gives
// (|g|/s >= 0.5 is false there). The single-leaf counterparts of the Pallas
// bodies run without the gate: |g| >= s/2 alone, as _encode_kernel tests it.
// A decoded zero code is v * s, not a literal 0.0: +0.0 for a finite s > 0,
// NaN for s = inf or NaN, as _decode_kernel's val * s.
//
// Kernels (each a launch over every block of every leaf in the table):
//   ternary_scale_kernel   c = g (+ r); each block writes the max |c| of
//                          its span (NaN propagates) to partial[block];
//   ternary_encode_kernel  reduces its leaf's partials to s = max(...)
//                          clamped to 1e-12 (NaN kept), or reads a given
//                          s; writes the packed codes and s;
//   ternary_ef_kernel      the same, and also the decoded values and the
//                          residual c - decoded (error feedback);
//   ternary_decode_kernel  packed codes and s -> decoded values.
// So error feedback over a gradient is two launches (scale, ef), encoding
// two (scale, encode) or one with given scales, decoding one. No atomics:
// a max is exact in any order, so s equals torch.max bit for bit; every
// add, subtraction and product is one IEEE operation (__fadd_rn, __fsub_rn,
// __fmul_rn: never contracted into an FMA), as torch computes them.
//
// Bound on an H100: bytes. Error feedback reads g and r and writes the
// decoded values, the residual and the codes, 16.25 bytes an element
// (the paper's gradient, 54,245 elements: 0.88 MB, ~0.26 us at 3.35 TB/s;
// 2^26 elements: 1.09 GB, ~0.33 ms). The scale pass reads g and r a second
// time (the max must be known before the first code), so the two launches
// move 24.25 bytes an element, 1.49x the bound. At the paper's size a
// launch costs more than the bytes, so the design keeps launches few.
//
// Design: 256 threads a block, each step of a block covers 1,024 elements,
// a float4 a thread (16-byte loads where a leaf's pointers are 16-byte
// aligned; scalar loads, bounded by n, at a leaf's ragged end or on an
// unaligned leaf). A leaf gets 1 to 1,024 blocks of at least 4,096
// elements, so its partials fit one reduction of 4 loads a thread. The four
// codes of a thread make one byte; the four lanes of a 16-element group OR
// their bytes together by two shuffles, and the first writes the 32-bit
// word: consecutive words from consecutive groups.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 4 * kThreads;      // elements a block covers a step
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinScale = 1e-12f;      // the codec's clamp of s

enum Flags : int { kCodec = 1 };         // gate the codes on isfinite(s)

constexpr int kMaxLeaves = 64;           // leaves a launch's table holds

// One leaf of the table (56 bytes; the ctypes mirror in ternary.py must
// match it field for field).
struct Leaf {
  const void* src;     // fp32 g [n] (scale, encode, ef); uint8 packed (decode)
  const float* r;      // fp32 residual [n] (scale, ef), else null
  const float* s;      // a given scale (encode with scales, decode), or null
  long long n;         // elements
  long long off;       // element offset in the padded concatenation (% 16)
  int block0;          // the leaf's first block in this launch
  int nblocks;         // its blocks (1 .. 1024)
  int span;            // elements a block covers (a multiple of kStep)
  int pad_;
};

struct Table {
  float* partial;      // [blocks] max |c| of each block's span
  uint8_t* packed;     // packed codes, leaf at byte off / 4
  float* s_out;        // [n_leaves] the scales (written when computed)
  float* dec;          // fp32 decoded values, leaf at element off
  float* res;          // fp32 residual, leaf at element off
  int n_leaves;
  int flags;
  Leaf leaf[kMaxLeaves];
};

static_assert(sizeof(Leaf) == 56, "the ctypes mirror assumes 56 bytes");
static_assert(sizeof(Table) <= 4096, "kernel parameters above 4 KB");

// max that keeps a NaN from either side (fmaxf drops it), as torch.max and
// jnp.max do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The leaf whose blocks hold block b: the last leaf with block0 <= b.
__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].block0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Elements e .. e + 3 of c = g (+ r): one 16-byte load of each where the
// leaf is aligned and all four are real, else scalar loads, 0.0 past n.
__device__ __forceinline__ float4 load_c(const Leaf& f, long long e,
                                         bool vec) {
  const float* g = static_cast<const float*>(f.src);
  if (vec && e + 4 <= f.n) {
    float4 c = __ldg(reinterpret_cast<const float4*>(g + e));
    if (f.r != nullptr) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(f.r + e));
      c = make_float4(__fadd_rn(c.x, r.x), __fadd_rn(c.y, r.y),
                      __fadd_rn(c.z, r.z), __fadd_rn(c.w, r.w));
    }
    return c;
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0.0f;
    if (e + k < f.n) {
      v[k] = __ldg(g + e + k);
      if (f.r != nullptr) v[k] = __fadd_rn(v[k], __ldg(f.r + e + k));
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ bool aligned(const Leaf& f) {
  return ((reinterpret_cast<uintptr_t>(f.src) |
           reinterpret_cast<uintptr_t>(f.r)) & 15u) == 0;
}

// The block's max of v (NaN propagates); every thread gets it.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = nanmax(v, warp_max[w]);
  return v;
}

__device__ __forceinline__ uint32_t code_of(float v, float half, bool gate) {
  return gate && fabsf(v) >= half ? (v > 0.0f ? 1u : 2u) : 0u;
}

__device__ __forceinline__ float value_of(uint32_t code, float s) {
  const float v = code == 1u ? 1.0f : (code == 2u ? -1.0f : 0.0f);
  return __fmul_rn(v, s);
}

__global__ void __launch_bounds__(kThreads)
    ternary_scale_kernel(const __grid_constant__ Table t) {
  const Leaf& f = t.leaf[leaf_of(t, blockIdx.x)];
  const long long begin =
      static_cast<long long>(blockIdx.x - f.block0) * f.span;
  const long long end = min(begin + f.span, f.n);
  const bool vec = aligned(f);
  float m = 0.0f;      // a max of |c| over at least one element is >= 0
#pragma unroll 4
  for (long long e = begin + 4 * threadIdx.x; e < end; e += kStep) {
    const float4 c = load_c(f, e, vec);
    m = nanmax(m, nanmax(nanmax(fabsf(c.x), fabsf(c.y)),
                         nanmax(fabsf(c.z), fabsf(c.w))));
  }
  m = block_max(m);
  if (threadIdx.x == 0) t.partial[blockIdx.x] = m;
}

// The codes (and with EF the decoded values and the residual) of one block.
template <bool kEF>
__device__ __forceinline__ void encode_block(const Table& t) {
  const int li = leaf_of(t, blockIdx.x);
  const Leaf& f = t.leaf[li];
  float s;
  if (f.s != nullptr) {
    s = __ldg(f.s);
  } else {
    float m = 0.0f;
    for (int j = threadIdx.x; j < f.nblocks; j += kThreads)
      m = nanmax(m, t.partial[f.block0 + j]);
    m = block_max(m);
    s = m != m ? m : fmaxf(m, kMinScale);
    if (blockIdx.x == f.block0 && threadIdx.x == 0) t.s_out[li] = s;
  }
  const float half = s / 2.0f;
  const bool gate = !(t.flags & kCodec) || isfinite(s);
  const long long begin =
      static_cast<long long>(blockIdx.x - f.block0) * f.span;
  const long long n16 = (f.n + 15) / 16 * 16;
  const long long end = min(begin + f.span, n16);
  const bool vec = aligned(f);
  const int lane = threadIdx.x % 32;
  uint32_t* words = reinterpret_cast<uint32_t*>(t.packed + f.off / 4);
  // every thread runs every step (the shuffles need the whole warp); a
  // 16-element group is real or past the leaf as a whole
  for (long long base = begin; base < end; base += kStep) {
    const long long e = base + 4 * threadIdx.x;
    const bool real = e < end;
    const float4 c = real ? load_c(f, e, vec) : make_float4(0, 0, 0, 0);
    const uint32_t c0 = code_of(c.x, half, gate);
    const uint32_t c1 = code_of(c.y, half, gate);
    const uint32_t c2 = code_of(c.z, half, gate);
    const uint32_t c3 = code_of(c.w, half, gate);
    uint32_t word = (c0 | c1 << 2 | c2 << 4 | c3 << 6) << (8 * (lane & 3));
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    if (!real) continue;
    if ((lane & 3) == 0) words[e / 16] = word;
    if (kEF) {
      const float4 d = make_float4(value_of(c0, s), value_of(c1, s),
                                   value_of(c2, s), value_of(c3, s));
      reinterpret_cast<float4*>(t.dec + f.off)[e / 4] = d;
      reinterpret_cast<float4*>(t.res + f.off)[e / 4] =
          make_float4(__fsub_rn(c.x, d.x), __fsub_rn(c.y, d.y),
                      __fsub_rn(c.z, d.z), __fsub_rn(c.w, d.w));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ternary_encode_kernel(const __grid_constant__ Table t) {
  encode_block<false>(t);
}

__global__ void __launch_bounds__(kThreads)
    ternary_ef_kernel(const __grid_constant__ Table t) {
  encode_block<true>(t);
}

__global__ void __launch_bounds__(kThreads)
    ternary_decode_kernel(const __grid_constant__ Table t) {
  const Leaf& f = t.leaf[leaf_of(t, blockIdx.x)];
  const uint8_t* packed = static_cast<const uint8_t*>(f.src);
  const float s = __ldg(f.s);
  const long long begin =
      static_cast<long long>(blockIdx.x - f.block0) * f.span;
  const long long n4 = (f.n + 3) / 4 * 4;       // the leaf's bytes * 4
  const long long end = min(begin + f.span, (f.n + 15) / 16 * 16);
  float4* out = reinterpret_cast<float4*>(t.dec + f.off);
#pragma unroll 4
  for (long long e = begin + 4 * threadIdx.x; e < end; e += kStep) {
    const uint32_t byte = e < n4 ? __ldg(packed + e / 4) : 0u;
    out[e / 4] = make_float4(value_of(byte & 3u, s),
                             value_of((byte >> 2) & 3u, s),
                             value_of((byte >> 4) & 3u, s),
                             value_of((byte >> 6) & 3u, s));
  }
}

enum Kernel : int { kScale = 0, kEncode = 1, kEF = 2, kDecode = 3 };

int launch(int kernel, const void* table, int blocks, cudaStream_t st) {
  const Table& t = *static_cast<const Table*>(table);
  switch (kernel) {
    case kScale:
      ternary_scale_kernel<<<blocks, kThreads, 0, st>>>(t);
      break;
    case kEncode:
      ternary_encode_kernel<<<blocks, kThreads, 0, st>>>(t);
      break;
    case kEF:
      ternary_ef_kernel<<<blocks, kThreads, 0, st>>>(t);
      break;
    case kDecode:
      ternary_decode_kernel<<<blocks, kThreads, 0, st>>>(t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one kernel (0 scale, 1 encode, 2 ef, 3 decode) over ``blocks``
// blocks of the table at ``table`` (host memory, copied into the launch's
// parameters). Returns cudaGetLastError() after the launch (0 = launched).
int ternary_launch(int kernel, const void* table, int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kernel, table, blocks, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
