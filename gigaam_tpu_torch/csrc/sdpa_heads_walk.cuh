// The per-head walk of the SDPA ablation's redesign, shared by the
// translation units that instantiate it: sdpa_heads_ws.cu (P12's bodies and
// P10: q, k, v and o head-major, [B H, T, 48]) and sdpa_packed_heads_ws.cu
// (P11: the full variant on the packed [B, T, H 48], read through a 4-D
// tensor map and stored packed).  sdpa_heads_ws.cu's header says what the
// walk computes, what bounds it and how it is built.  The device code takes
// the layout as a template argument (kPacked), so that the head-major
// instances compile from the code they had; the packed instance lives in
// its own library, as a second kernel in one translation unit has moved
// the first's SASS before (sdpa_walk.cuh).

#pragma once

#include "sdpa_core.cuh"
#include "sdpa_walk.cuh"

namespace {

using namespace gigaam;

constexpr int kRingStages = 8;                  // K/V stages, both consumers'
constexpr int kMaskBytes = kTile * 4;           // a stage's key masks, fp32
constexpr int kQBytes = kConsumers * kQSlots * kTileSmem;
constexpr int kHeadsSmem =
    kQBytes + kRingStages * (kStageBytes + kMaskBytes) + kSmemAlign;

struct HeadsMaps {
  CUtensorMap q, k, v;   // head-major: [B H, T, 48], boxes [1, 64, 64];
                         // packed: [B, T, H, 48], boxes [1, 64, 1, 64]
                         // (or, planted, [B, T, H 48], boxes [1, 64, 64]);
                         // 128-byte swizzle
};

struct HeadsArgs {
  const int2* plan;      // {first unit, units}, one a block; unit u is
                         // (head bh = u / n_pairs, query tiles 2 (u %
                         // n_pairs) and + 1)
  const void* mask;      // [B, T] (one row serves mask_heads heads) or
                         // [B H, T]; bytes, or fp32 for the madd variants
  bf16* o;               // [B H, T, 48], or packed [B, T, kPackedHeads 48]
  int t, n_pairs, mask_heads;
  float scale;
};

// the aligned dynamic shared memory: kQSlots Q slots a consumer, the ring's
// K/V stages, then the stages' key masks; barrier arrays of 8 bytes a slot
struct HeadsRing {
  uint32_t smem;
  float* masks;
  uint32_t full, empty, q_full, q_empty;

  __device__ __forceinline__ uint32_t q_tile(int c, int i) const {
    return smem + (c * kQSlots + i % kQSlots) * kTileSmem;
  }
  __device__ __forceinline__ uint32_t q_bar(uint32_t arr, int c, int i) const {
    return arr + 8 * (c * kQSlots + i % kQSlots);
  }
  __device__ __forceinline__ uint32_t stage(int it) const {
    return smem + kQBytes + (it % kRingStages) * kStageBytes;
  }
  __device__ __forceinline__ float* mask(int it) const {
    return masks + (it % kRingStages) * kTile;
  }
  __device__ __forceinline__ uint32_t bar(uint32_t arr, int it) const {
    return arr + 8 * (it % kRingStages);
  }
  __device__ __forceinline__ uint32_t phase(int it) const {
    return (it / kRingStages) & 1;
  }
};

__device__ __forceinline__ int2 uniform(int2 x) {
  return make_int2(uniform(x.x), uniform(x.y));
}

// rows row0 .. row0 + 63 of head bh into the tile at `dst`, on `bar`:
// head-major, head_map's box at (0, row0, bh); packed, the box of the 4-D
// map [B, T, H, 48] at (0, h, row0, b), columns 48 .. 63 zero-filled as
// head_map's, or, with flat >= 0 (a slip that chip_smoke.py plants), the
// box of a 3-D map over the flat H 48 columns at (48 h + flat, row0, b)
template <bool kPacked>
__device__ __forceinline__ void load_head_tile(uint32_t dst,
                                               const CUtensorMap* map,
                                               int row0, int bh, int flat,
                                               uint32_t bar) {
  if constexpr (kPacked) {
    const int b = bh / kPackedHeads, h = bh % kPackedHeads;
    if (flat < 0)
      tma_load_4d(dst, map, 0, h, row0, b, bar);
    else
      tma_load_3d(dst, map, h * kD + flat, row0, b, bar);
  } else {
    load_tile(dst, map, row0, bh, bar);
  }
}

// The producer warp: for each unit of the block's run, the Q tile of each
// consumer whose tile lies below T into its free slot, then the head's key
// tiles into free stages, each with its 64 additive key masks (all lanes);
// lane 0 issues the copies.
template <int kVariant, bool kPacked>
__device__ __forceinline__ void produce_heads(const HeadsRing& r,
                                              const HeadsMaps& maps,
                                              const HeadsArgs& a, int2 span,
                                              int n_tiles, int flat) {
  const int lane = threadIdx.x & 31;
  int it = 0, qi[kConsumers] = {0, 0};
  for (int n = 0; n < span.y; ++n) {
    const int u = span.x + n, bh = u / a.n_pairs;
    const int qt0 = 2 * (u % a.n_pairs);
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      if (qt0 + c >= n_tiles) continue;
      const uint32_t qb = r.q_bar(r.q_full, c, qi[c]);
      mbar_wait(r.q_bar(r.q_empty, c, qi[c]), ((qi[c] / kQSlots) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(qb, kTileSmem);
        load_head_tile<kPacked>(r.q_tile(c, qi[c]), &maps.q,
                                (qt0 + c) * kTile, bh, flat, qb);
      }
      ++qi[c];
    }
    const SdpaMask<kVariant>* mrow =
        static_cast<const SdpaMask<kVariant>*>(a.mask) +
        (size_t)(bh / a.mask_heads) * a.t;
    for (int j = 0; j < n_tiles; ++j, ++it) {
      mbar_wait(r.bar(r.empty, it), r.phase(it) ^ 1);
      if constexpr (kVariant != kSdpaTwoProducts) {
        float* mk = r.mask(it);
        mk[lane] = sdpa_key_mask2<kVariant>(mrow, j * kTile + lane, a.t);
        mk[lane + 32] =
            sdpa_key_mask2<kVariant>(mrow, j * kTile + lane + 32, a.t);
        __syncwarp();   // the lanes' masks before lane 0's release
      }
      if (lane == 0) {
        const uint32_t fb = r.bar(r.full, it);
        mbar_expect_tx(fb, kStageBytes);
        load_head_tile<kPacked>(r.stage(it), &maps.k, j * kTile, bh, flat,
                                fb);
        load_head_tile<kPacked>(r.stage(it) + kTileSmem, &maps.v, j * kTile,
                                bh, flat, fb);
      }
    }
  }
}

// this thread's 16 key masks of a stage, as softmax_tile reads them
__device__ __forceinline__ void stage_mask(const float* m, float (&mk)[16]) {
  const int l = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(&m[8 * j + 2 * l]);
    mk[2 * j] = x.x;
    mk[2 * j + 1] = x.y;
  }
}

// the variants whose tile is online_softmax_tile's (sdpa_walk.cuh's
// softmax_tile, then the rescale and the packing)
template <int kVariant>
constexpr bool kOnline = kVariant == kSdpaFull || kVariant == kSdpaNoScale ||
                         kVariant == kSdpaMaddRow;

// pack_fragment's inverse, exact: the bf16 pairs of a as fp32 in d
__device__ __forceinline__ void unpack_fragment(const uint32_t (&a)[16],
                                                float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[2 * i] = bf16_lo(a[i]);
    d[2 * i + 1] = bf16_hi(a[i]);
  }
}

// One query tile's walk over the head's key tiles `it` .. `it + n_tiles -
// 1` of the ring, Q at `q` (its slot released on `q_empty` once the last
// S has landed); the 64 rows from row0 of o_head, kRowStride elements apart
// (48 head-major, kPackedHeads 48 packed).
template <int kVariant, int kRowStride>
__device__ __forceinline__ void walk(const HeadsRing& r, uint32_t q,
                                     uint32_t q_empty, int it, int n_tiles,
                                     float scale2, bf16* o_head, int row0,
                                     int t) {
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float corr_lo = 1.f, corr_hi = 1.f;
  float o[24];
#pragma unroll
  for (int e = 0; e < 24; ++e) o[e] = 0.f;
  float s[32], mk[16];
  uint32_t p[16], pn[16];
  uint64_t ds[2 * kSteps], dv[kPvSteps];

  // key tile 0: S alone, then P straight into the operand registers
  mbar_wait(r.bar(r.full, it), r.phase(it));
  product_descs(q, r.stage(it), 0, ds, dv);
  wgmma_fence();
  scores(s, ds);
  wgmma_commit();
  if constexpr (kOnline<kVariant>) stage_mask(r.mask(it), mk);
  wgmma_wait<0>();
  fence_regs(s);
  if (n_tiles == 1) warp_arrive(q_empty);
  if constexpr (kOnline<kVariant>) {
    softmax_tile(s, mk, scale2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
    pack_fragment(s, p);
  } else if constexpr (kVariant == kSdpaNoMax) {
    fixed_shift_softmax_tile(s, r.mask(it), scale2, l_lo, l_hi, p);
  } else if constexpr (kVariant == kSdpaBf16Exp) {
    bf16_exp_softmax_tile(s, r.mask(it), scale2, m_lo, m_hi, l_lo, l_hi, o,
                          p);
  } else {
    pack_fragment(s, p);   // S itself, rounded to bf16
  }

  for (int j = 1; j < n_tiles; ++j) {
    const int prev = it + j - 1, cur = it + j;
    mbar_wait(r.bar(r.full, cur), r.phase(cur));
    product_descs(q, r.stage(cur), r.stage(prev) + kTileSmem, ds, dv);
    fence_regs(o);
    fence_words(p);
    wgmma_fence();
    scores(s, ds);
    wgmma_commit();
    accumulate(o, p, dv);
    wgmma_commit();
    if constexpr (kOnline<kVariant>) stage_mask(r.mask(cur), mk);
    wgmma_wait<1>();            // S of tile j has landed
    fence_regs(s);
    if (j == n_tiles - 1) warp_arrive(q_empty);
    // the softmax of tile j runs while P.V of tile j - 1 is in flight, its
    // P left in s as fp32
    if constexpr (kOnline<kVariant>) {
      softmax_tile(s, mk, scale2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
    } else if constexpr (kVariant == kSdpaNoMax) {
      // s becomes exp2(s scale2 + mask); the packing into pn is dropped
      fixed_shift_softmax_tile(s, r.mask(cur), scale2, l_lo, l_hi, pn);
    } else if constexpr (kVariant == kSdpaBf16Exp) {
      float ones[24];
#pragma unroll
      for (int e = 0; e < 24; ++e) ones[e] = 1.f;
      bf16_exp_softmax_tile(s, r.mask(cur), scale2, m_lo, m_hi, l_lo, l_hi,
                            ones, pn);
      corr_lo = ones[0];
      corr_hi = ones[2];
      unpack_fragment(pn, s);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) asm volatile("" :: "f"(s[e]));
    wgmma_wait<0>();            // P.V of tile j - 1 has landed
    fence_regs(o);
    fence_regs(s);              // P's packing waits for the wait
    warp_arrive(r.bar(r.empty, prev));
    if constexpr (kOnline<kVariant> || kVariant == kSdpaBf16Exp)
      rescale(o, corr_lo, corr_hi);
    pack_fragment(s, p);
  }

  const int last = it + n_tiles - 1;
  product_descs(q, 0, r.stage(last) + kTileSmem, ds, dv);
  fence_regs(o);
  fence_words(p);
  wgmma_fence();
  accumulate(o, p, dv);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  warp_arrive(r.bar(r.empty, last));

  if constexpr (kVariant == kSdpaTwoProducts) {
    store_rows<kRowStride>(o, 1.f, 1.f, o_head, row0, t);
  } else {
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    store_rows<kRowStride>(o, 1.f / l_lo, 1.f / l_hi, o_head, row0, t);
  }
}

// Consumer warpgroup c: query tile 2 p + c of each unit (head, pair p) of the
// block's run; a tile past T only releases the unit's stages.  Head bh's
// output: head-major at o + bh T 48; packed (b = bh / H, h = bh % H) at o +
// b T H 48 + 48 h, rows H 48 apart.
template <int kVariant, bool kPacked>
__device__ __forceinline__ void consume_heads(const HeadsRing& r,
                                              const HeadsArgs& a, int2 span,
                                              int n_tiles, int c) {
  const float scale2 =
      (kVariant == kSdpaNoScale || kMaddMask<kVariant>) ? kLog2e
                                                        : a.scale * kLog2e;
  int it = 0, qi = 0;
  for (int n = 0; n < span.y; ++n, it += n_tiles) {
    const int u = span.x + n, bh = u / a.n_pairs;
    const int qt = 2 * (u % a.n_pairs) + c;
    if (qt >= n_tiles) {
      for (int j = it; j < it + n_tiles; ++j) {
        mbar_wait(r.bar(r.full, j), r.phase(j));
        warp_arrive(r.bar(r.empty, j));
      }
      continue;
    }
    mbar_wait(r.q_bar(r.q_full, c, qi), (qi / kQSlots) & 1);
    if constexpr (kPacked)
      walk<kVariant, kPackedHeads * kD>(
          r, r.q_tile(c, qi), r.q_bar(r.q_empty, c, qi), it, n_tiles, scale2,
          a.o + (size_t)(bh / kPackedHeads) * a.t * kPackedHeads * kD +
              (bh % kPackedHeads) * kD,
          qt * kTile, a.t);
    else
      walk<kVariant, kD>(r, r.q_tile(c, qi), r.q_bar(r.q_empty, c, qi), it,
                         n_tiles, scale2, a.o + (size_t)bh * a.t * kD,
                         qt * kTile, a.t);
    ++qi;
  }
}

// A block of a walk's kernel: one an SM, walking its run of the plan; 384
// threads, two consumer warpgroups, then the producer's.  The kernel passes
// its dynamic shared memory and its barrier arrays (kRingStages full and
// empty, kConsumers kQSlots q_full and q_empty).
template <int kVariant, bool kPacked>
__device__ __forceinline__ void heads_ws_block(
    const HeadsMaps& maps, const HeadsArgs& a, unsigned char* smem_raw,
    uint64_t* full, uint64_t* empty, uint64_t* q_full, uint64_t* q_empty,
    int flat) {
  const uint32_t base = aligned_smem(smem_raw);
  const HeadsRing r{
      base,
      reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                               kQBytes + kRingStages * kStageBytes),
      smem_u32(full), smem_u32(empty), smem_u32(q_full), smem_u32(q_empty)};
  const int2 span = uniform(a.plan[blockIdx.x]);
  const int n_tiles = (a.t + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 4 * kConsumers);   // both consumers' warps
    }
    for (int s = 0; s < kConsumers * kQSlots; ++s) {
      mbar_init(r.q_full + 8 * s, 1);
      mbar_init(r.q_empty + 8 * s, 4);   // the consumer's four warps
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / 128);
  if (wg == kConsumers) {
    regs_release<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers)
      produce_heads<kVariant, kPacked>(r, maps, a, span, n_tiles, flat);
  } else {
    regs_claim<kConsumerRegs>();
    consume_heads<kVariant, kPacked>(r, a, span, n_tiles, wg);
  }
}

}  // namespace
