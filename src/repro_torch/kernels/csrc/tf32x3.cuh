// The three-product TF32 split of fp32 products on Hopper's tensor cores
// (route tf32x3), shared by the fp32 flash forward (flash_attention.cu,
// flash_kernel_tf32x3) and backward (flash_attention_bwd.cu,
// flash_bwd_dq_tf32x3 / flash_bwd_dkdv_tf32x3): the ring's chunk layout,
// the split of a landed stage into lo parts, S = Q K^T over one 32-column
// chunk on wgmma, an output product over a 64-position tile on mma.sync,
// and the fp32 stores. Header only; kernels/build.py hashes it into both
// libraries' names.
#pragma once

#include "hopper.cuh"

namespace tf32x3 {

using namespace hopper;

constexpr int kTile = 64;                  // own rows; other positions a tile
constexpr int kCols = 32;                  // fp32 columns a chunk (128 bytes)
constexpr int kChunk = kTile * 128;        // [64 rows][128 bytes], swizzled
constexpr int kThreads = 128;              // a warpgroup; a block has two
// A ring stage: four chunks as TMA writes them, then their lo parts kLo
// further (64 KB); what each slot holds is the kernel's.
constexpr int kLo = 4 * kChunk;
constexpr int kStage = 2 * kLo;
constexpr int kStages = 3;
constexpr int kWords = kLo / 16;           // 16-byte words a stage's split

// The wgmma descriptor of a chunk: K-major, 8-row groups 1,024 bytes apart,
// 128-byte swizzle.
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return desc(addr, 16, 1024, 1);
}

// The split of an fp32 x into TF32 parts: hi is x itself, since the tensor
// core reads a raw fp32 value as its TF32 truncation (the probe: one
// product on raw values matched the truncated operands' fp64 product to
// ~3e-6, the rounded ones' only to ~1e-3; should it not, the 2e-5 gates on
// these kernels fail, as one TF32 product misses them); lo =
// tf32(x - trunc(x)) (x - trunc(x) is exact in fp32; hi lo' + lo hi'
// restore the product to ~2^-20 of it, the dropped lo lo' and lo's
// rounding included).
__device__ __forceinline__ float lo_part(float x) {
  return tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
}

// lo_part of every value of a stage, written kLo bytes further by the
// block's 256 threads (the hi parts stay as TMA wrote them); the fence
// orders these generic-proxy writes before the wgmma reads them.
__device__ __forceinline__ void split(uint8_t* st) {
#pragma unroll 2
  for (int i = 0; i < kWords / (2 * kThreads); ++i) {
    const int e = threadIdx.x + i * 2 * kThreads;
    const float4 x = reinterpret_cast<const float4*>(st)[e];
    reinterpret_cast<float4*>(st + kLo)[e] =
        make_float4(lo_part(x.x), lo_part(x.y), lo_part(x.z), lo_part(x.w));
  }
  fence_proxy_async();
}

// d = A B^T over one 32-column chunk, A and B [64 x 32] split chunks in
// shared memory (K-major, 128-byte swizzle, each lo part kLo after its hi
// part), by wgmma m64n64k8 .tf32: per k step of 8 columns hi hi', hi lo'
// and lo hi'. The sum starts fresh: the tensor core's fp32 accumulation
// truncates (the probe: ~3e-8 of the result per accumulation, 1e-5 over
// 384 of them), so each chain stays 12 products long and the caller adds
// the chunks in fp32.
__device__ __forceinline__ void issue_chunk(float (&d)[32], uint32_t a,
                                            uint32_t b) {
  const uint64_t ah = k_major(a), al = k_major(a + kLo);
  const uint64_t bh = k_major(b), bl = k_major(b + kLo);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32(d, ah + 2 * kk, bh + 2 * kk, kk > 0);
    wgmma_tf32(d, ah + 2 * kk, bl + 2 * kk, 1);
    wgmma_tf32(d, al + 2 * kk, bh + 2 * kk, 1);
  }
}

// acc's n8 blocks n0 .. n0 + 3 (32 output columns) += X B over the 64
// positions of an other-side tile: X [64 x 64] this warpgroup's tile in the
// accumulator layout (P in the forward; dS, P^T or dS^T in the backward;
// 32 values a thread), B a split
// [64 positions][32 columns] chunk at b. mma.sync m16n8k8 .tf32, one warp
// on its 16 rows: wgmma reads a 32-bit B only K-major, and B is MN-major
// here. The accumulator holds columns 2t and 2t + 1 of each group of 8 (t =
// lane % 4) where the A fragment wants t and t + 4, so k is permuted
// within each group on the B side: slot t reads position 2t, slot t + 4
// position 2t + 1, and X's values are the A fragment as they stand (split a
// k step at a time). Each n8 block sums its 24 products fresh in one of 4
// independent chains (issue_chunk's reason), then adds them to acc in fp32.
template <int NACC>
__device__ __forceinline__ void out_chunk(float (&acc)[NACC], int n0,
                                          const float (&x)[32],
                                          const uint8_t* b) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  float d[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const float xa[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                         x[4 * kk + 3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[e] = __float_as_uint(xa[e]);
      al[e] = __float_as_uint(lo_part(xa[e]));
    }
    // rows 8 kk + 2t (+ 1): 128 bytes each, their 16-byte units swizzled
    // by row % 8 = 2t (+ 1); a warp's 32 loads hit 32 banks
    const uint8_t* rows = b + (8 * kk + 2 * t) * 128 + (g & 3) * 4;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int unit = 2 * nb + (g >> 2);
      const int o0 = (unit ^ (2 * t)) << 4;
      const int o1 = 128 + ((unit ^ (2 * t + 1)) << 4);
      const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(rows + o0);
      const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(rows + o1);
      const uint32_t bl0 =
          *reinterpret_cast<const uint32_t*>(rows + kLo + o0);
      const uint32_t bl1 =
          *reinterpret_cast<const uint32_t*>(rows + kLo + o1);
      mma_tf32(d[nb], ah, bh0, bh1);
      mma_tf32(d[nb], ah, bl0, bl1);
      mma_tf32(d[nb], al, bh0, bh1);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * (n0 + nb) + e] += d[nb][e];
}

// Whether no pair of the q rows [q0, q0 + 64) and kv rows [k0, k0 + 64) is
// masked (causal: k <= q; window w > 0: k > q - w; both below seq).
__device__ __forceinline__ bool whole(int q0, int k0, int seq, int causal,
                                      int window) {
  return q0 + kTile <= seq && k0 + kTile <= seq &&
         (!causal || k0 + kTile - 1 <= q0) &&
         (window <= 0 || k0 > q0 + kTile - 1 - window);
}

// acc [64 x NC] of rows r (position row0 + r < seq), its first n_cols
// columns, into an fp32 [B][S][heads * hd] output at element offset base +
// position * stride.
template <int NC>
__device__ __forceinline__ void store_rows(const float (&acc)[NC / 2],
                                           float* __restrict__ out,
                                           int64_t base, int64_t stride,
                                           int row0, int seq, const Frag& fr,
                                           int n_cols) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = row0 + fr.row_a + 8 * half;
    if (pos >= seq) continue;
    float* o = out + base + pos * stride;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      if (8 * j < n_cols)
        *reinterpret_cast<float2*>(o + 8 * j + fr.cq) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
}

}  // namespace tf32x3
