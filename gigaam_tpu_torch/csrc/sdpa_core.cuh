// K3's kernel body, masked scaled-dot-product attention on `wgmma`
// (sm_90a), templated on the variants of the SDPA ablation.
//
// attention.cu instantiates the full variant in the head-major layout as
// K3's `sdpa_kernel` (its design note is there); sdpa_ablation.cu
// instantiates the variants and layouts of the ablation
// (gigaam_tpu_torch/probes/sdpa_ablation.py, the counterpart of
// benchmarks/sdpa_ablation.py).  Each departure from K3 is an `if constexpr`
// on the variant or the layout, so that the ablation measures K3's own code
// with one thing changed, and K3 compiles to what it did before the variants
// existed.
//
// In every variant s is fp32 and the softmax runs online over 64-key tiles,
// in base-2 units (scores times log2(e)), where the Pallas bodies take the
// whole row at once: the two differ by rounding only.

#pragma once

#include <type_traits>

#include "wgmma.cuh"

namespace gigaam {

// What a block computes: the Pallas bodies of benchmarks/sdpa_ablation.py.
enum SdpaVariant : int {
  kSdpaFull = 0,         // k_full: K3's function
  kSdpaCopy = 1,         // k_copy: o = q
  kSdpaTwoProducts = 2,  // k_scores_only: o = bf16(bf16(q . k^T) . v)
  kSdpaNoMax = 3,        // k_no_max: exp(s - 20) in place of the row max
  kSdpaNoScale = 4,      // k_prescaled: no 1/sqrt(d_h)
  kSdpaMaddRow = 5,      // k_maddrow: no scale, the mask an fp32 additive row
  kSdpaBf16Exp = 6,      // k_bf16_softmax: k_maddrow, exp in bf16
};

// Where a block finds its rows.  q, k, v, o are [B, H, T, 48] (or [B * H, T,
// 48]) unless packed; the mask is [B, T] unless per head.
enum SdpaLayout : int {
  kSdpaHeads = 0,        // one block a (64-row query tile, head, batch)
  kSdpaHeadGroups = 1,   // one block a (query tile, group of heads, batch),
                         // walking its heads in turn on one shared memory
  kSdpaMaskPerHead = 2,  // kSdpaHeads with the mask [B * H, T]
  kSdpaPacked = 3,       // [B, T, H * 48]: head h is columns 48 h .. 48 h + 47
};

constexpr int kSdpaStages = 2;
// variant D's fixed shift, exp(s - 20), in base-2 units
constexpr float kNoMaxShift2 = 20.f * kLog2e;

template <int kVariant>
constexpr bool kMaddMask =
    kVariant == kSdpaMaddRow || kVariant == kSdpaBf16Exp;

// the mask's element type: valid flags (one byte, nonzero = valid), or the
// fp32 additive row of the madd variants
template <int kVariant>
using SdpaMask = std::conditional_t<kMaddMask<kVariant>, float, uint8_t>;

// the additive mask of key j in base-2 units (-inf past T); variant D's
// shift joins it
template <int kVariant>
__device__ __forceinline__ float sdpa_key_mask2(const SdpaMask<kVariant>* row,
                                                int j, int t) {
  if constexpr (kMaddMask<kVariant>) {
    return j < t ? row[j] * kLog2e : -INFINITY;
  } else if constexpr (kVariant == kSdpaNoMax) {
    return key_mask2(row, j, t) - kNoMaxShift2;
  } else {
    return key_mask2(row, j, t);
  }
}

// Variant D's softmax tile: P = exp2(s * scale2 + mask), the shift already in
// the mask, so there is no running max and the output is never rescaled.
__device__ __forceinline__ void fixed_shift_softmax_tile(
    float (&s)[32], const float* mask, float scale2, float& l_lo, float& l_hi,
    uint32_t (&p)[16]) {
  const int l = threadIdx.x & 3;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 mk = *reinterpret_cast<const float2*>(&mask[8 * j + 2 * l]);
    s[4 * j] = exp2f(fmaf(s[4 * j], scale2, mk.x));
    s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale2, mk.y));
    s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale2, mk.x));
    s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale2, mk.y));
    sum_lo += s[4 * j] + s[4 * j + 1];
    sum_hi += s[4 * j + 2] + s[4 * j + 3];
  }
  l_lo += sum_lo;
  l_hi += sum_hi;
  pack_fragment(s, p);
}

// two bf16 exponentials of base 2 in one instruction
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// Variant G's softmax tile: online_softmax_tile's fp32 running max, then
// s - max rounded to bf16 and exponentiated in bf16 pairs (ex2.approx on
// bf16x2), which are P's A fragment as they stand; the sum is taken in fp32
// over the bf16 P.
__device__ __forceinline__ void bf16_exp_softmax_tile(
    float (&s)[32], const float* mask, float scale2, float& m_lo, float& m_hi,
    float& l_lo, float& l_hi, float (&o_acc)[24], uint32_t (&p)[16]) {
  const int l = threadIdx.x & 3;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 mk = *reinterpret_cast<const float2*>(&mask[8 * j + 2 * l]);
    s[4 * j] = fmaf(s[4 * j], scale2, mk.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, mk.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, mk.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, mk.y);
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float new_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float new_hi = fmaxf(m_hi, quad_max(mx_hi));
  const float corr_lo = exp2f(m_lo - new_lo), corr_hi = exp2f(m_hi - new_hi);
  m_lo = new_lo;
  m_hi = new_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // pack_fragment's order: pair 2 j is row g, pair 2 j + 1 row g + 8
    p[2 * j] = ex2_bf16x2(pack_bf16(s[4 * j] - m_lo, s[4 * j + 1] - m_lo));
    p[2 * j + 1] =
        ex2_bf16x2(pack_bf16(s[4 * j + 2] - m_hi, s[4 * j + 3] - m_hi));
    sum_lo += bf16_lo(p[2 * j]) + bf16_hi(p[2 * j]);
    sum_hi += bf16_lo(p[2 * j + 1]) + bf16_hi(p[2 * j + 1]);
  }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    o_acc[4 * j] *= corr_lo;
    o_acc[4 * j + 1] *= corr_lo;
    o_acc[4 * j + 2] *= corr_hi;
    o_acc[4 * j + 3] *= corr_hi;
  }
}

// The body of one block of 128 threads (one warpgroup): the 64 query rows
// from blockIdx.x * 64 of the head blockIdx.y (kSdpaHeadGroups: of each head
// of the group blockIdx.y, in turn) of the batch element blockIdx.z.  lse
// ([B, H, T] fp32, or null) is written by the full variant only.
template <int kVariant, int kLayout>
__device__ __forceinline__ void sdpa_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const SdpaMask<kVariant>* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int n_heads, int t,
    float scale, int heads_per_block) {
  __shared__ __align__(128) unsigned char qs[kTileBytes];
  __shared__ __align__(128) unsigned char ks[kSdpaStages][kTileBytes];
  __shared__ __align__(128) unsigned char vs[kSdpaStages][kTileBytes];
  __shared__ __align__(16) float madd[kSdpaStages][kTile];

  const int lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 =
      (kVariant == kSdpaNoScale || kMaddMask<kVariant>) ? kLog2e
                                                        : scale * kLog2e;
  const int row_stride = kLayout == kSdpaPacked ? n_heads * kD : kD;
  // unsigned, as blockIdx.y: the full head-major variant is K3's code
  unsigned head0 = blockIdx.y;
  int n_block_heads = 1;
  if constexpr (kLayout == kSdpaHeadGroups) {
    head0 = blockIdx.y * heads_per_block;
    n_block_heads = heads_per_block;
  }

  for (int hh = 0; hh < n_block_heads; ++hh) {
    // the last head's tiles are consumed before this head's loads overwrite
    // them
    if (hh > 0) __syncthreads();
    const size_t bh = (size_t)b * n_heads + head0 + hh;
    const size_t base = kLayout == kSdpaPacked
                            ? (size_t)b * t * row_stride + (head0 + hh) * kD
                            : bh * t * kD;

    if constexpr (kVariant == kSdpaCopy) {
      // o = q over the block's rows, 16 bytes a thread a step
      for (int n = threadIdx.x; n < kTile * kChunks; n += kThreads) {
        const int row = q0 + n / kChunks;
        const size_t at = base + (size_t)row * row_stride + (n % kChunks) * 8;
        if (row < t)
          *reinterpret_cast<uint4*>(o + at) =
              *reinterpret_cast<const uint4*>(q + at);
      }
      continue;
    }

    const SdpaMask<kVariant>* mrow =
        mask + (kLayout == kSdpaMaskPerHead ? bh : (size_t)b) * t;

    // the loads of key tile `tile` into its stage; commits a group even when
    // there is no such tile, so that the count of pending groups is uniform
    auto prefetch = [&](int tile) {
      if (tile < n_tiles) {
        const int st = tile % kSdpaStages, k0 = tile * kTile;
        load_tile_async(smem_u32(ks[st]), k + base, k0, t, row_stride);
        load_tile_async(smem_u32(vs[st]), v + base, k0, t, row_stride);
        if constexpr (kVariant != kSdpaTwoProducts) {
          if (threadIdx.x < kTile)
            madd[st][threadIdx.x] =
                sdpa_key_mask2<kVariant>(mrow, k0 + threadIdx.x, t);
        }
      }
      cp_async_commit();
    };

    // joins the first group
    load_tile_async(smem_u32(qs), q + base, q0, t, row_stride);
#pragma unroll
    for (int s = 0; s < kSdpaStages - 1; ++s) prefetch(s);

    // this thread's two rows (g and g + 8 of its warp's 16): running max in
    // base-2 units, its share of the running sum, and the output fragment
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    float o_acc[24];
#pragma unroll
    for (int i = 0; i < 24; ++i) o_acc[i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      ring_wait<kSdpaStages>();   // tile `it` is whole, tile `it - 1` consumed
      prefetch(it + kSdpaStages - 1);
      const int st = it % kSdpaStages;

      float s[32];
      wgmma_fence();
      product_nt(s, smem_u32(qs), smem_u32(ks[st]));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      uint32_t p[16];
      if constexpr (kVariant == kSdpaTwoProducts) {
        pack_fragment(s, p);   // S itself, rounded to bf16
      } else if constexpr (kVariant == kSdpaNoMax) {
        fixed_shift_softmax_tile(s, madd[st], scale2, l_lo, l_hi, p);
      } else if constexpr (kVariant == kSdpaBf16Exp) {
        bf16_exp_softmax_tile(s, madd[st], scale2, m_lo, m_hi, l_lo, l_hi,
                              o_acc, p);
      } else {
        online_softmax_tile(s, madd[st], scale2, m_lo, m_hi, l_lo, l_hi,
                            o_acc, p);
      }

      fence_regs(o_acc);
      wgmma_fence();
      accumulate_nn(o_acc, p, smem_u32(vs[st]));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }

    if constexpr (kVariant == kSdpaTwoProducts) {
      store_fragment(o_acc, 1.f, 1.f, o + base, q0, t, row_stride);
    } else {
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      store_fragment(o_acc, 1.f / l_lo, 1.f / l_hi, o + base, q0, t,
                     row_stride);
      if constexpr (kVariant == kSdpaFull) {
        if (lse != nullptr && l == 0) {
          const int row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
          if (row < t) lse[bh * t + row] = (m_lo + log2f(l_lo)) * kLn2;
          if (row + 8 < t) lse[bh * t + row + 8] = (m_hi + log2f(l_hi)) * kLn2;
        }
      }
    }
  }
}

}  // namespace gigaam
