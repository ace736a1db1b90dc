// The SDPA ablation's per-head bodies (P12) and its per-head mask (P10)
// redesigned for Hopper (sm_90a): a persistent, warp-specialised walk in
// which the two query tiles of a unit share one K/V ring.
//
// It replaces the Pallas probes benchmarks/sdpa_ablation.py::run (the bodies
// k_full, k_scores_only, k_no_max, k_prescaled, k_maddrow, k_bf16_softmax) and
// ::run_identity_maps (k_full with the mask given per head), as
// sdpa_ablation.cu's head-major layout of K3's body did (kept there for an A/B
// on the same card).  The copy (k_copy) stays on sdpa_ablation.cu: it reads at
// its byte bound there, and a copy on this walk ran slower.  For q, k, v [B H,
// T, 48] bf16 and a key mask, o = softmax(s) v per (batch element, head), s = q
// k^T / sqrt(48) + (mask - 1) 1e9, the softmax in fp32 online over 64-key tiles
// in base-2 units, P rounded to bf16 before P.V and the denominator divided out
// after it: K3's arithmetic (sdpa_core.cuh), in the same order, with one thing
// changed a variant (SdpaVariant): the two products alone, a fixed shift for
// the row max, no scale, the mask an fp32 additive row, bf16 exponentials.
// Each tile's arithmetic is sdpa_core.cuh's and sdpa_walk.cuh's own functions,
// so each body keeps the bits of its kept kernel and the full variant K3's.
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 67 TFLOP/s fp32,
// 3.35 TB/s): 4 B H T^2 48 tensor operations and ~4 fp32 operations a score
// against 8 B H T 48 bytes, so operations: 0.0082 ms at B 8, H 16, T 501.
// At the exponential unit's published rate (about 3.9 T exp/s, not
// measured on the card) the 32.1 M exponentials at B 8, T 501 take as long.
//
// What held the kept kernel back, and what this design does:
//   * One warpgroup a (64-row query tile, head, batch element) waited on
//     each tile's loads (two cp.async stages) and on each product in turn,
//     and each block loaded every K/V tile of its head for 64 query rows.
//     Here a unit is (head, pair of query tiles).  One producer warp (its
//     warpgroup lowered to 40 registers with setmaxnreg) issues TMA copies
//     into one ring of eight K/V stages that both consumer warpgroups
//     (raised to 232) read, each walking one query tile of the pair: a
//     stage's `empty` barrier counts the eight warps of both.  A K/V tile
//     then leaves L2 once per 128 query rows.
//   * The producer warp also writes each stage's 64 additive key masks
//     (sdpa_key_mask2 of the variant, as the kept body's `madd` row), which
//     both consumers read from shared memory, so that the variants' softmax
//     tiles of sdpa_core.cuh run as they are.
//   * Blocks are persistent: one a card's SM, each walking a contiguous run
//     of the units of a static plan (probes/sdpa_ablation.py::heads_plan),
//     so that a head's units sit side by side (its K/V stays in L2) and the
//     producer runs ahead across unit boundaries: the next unit's Q tiles
//     (two slots a consumer) and first K/V stages are in flight while the
//     consumers finish this one.  A unit whose second query tile lies past T
//     (an odd count of tiles) leaves that consumer only the ring's barriers.
//   * Within a consumer, sdpa_walk.cuh's order: key tile j's S = Q K^T is
//     issued before tile j - 1's P.V is waited on, and the output is
//     rescaled, and P packed to bf16 as the next A operand, only after that
//     product lands.  The variants whose softmax tile packs P itself (the
//     fixed shift, the bf16 exponentials) pack into a second register set
//     in flight, which is dropped (the fixed shift: P is still fp32 in s)
//     or unpacked into s (the bf16 pairs, exact) and packed again after the
//     wait: moved from that set into the operand's registers, P was
//     coalesced into them in flight and ptxas serialised the products
//     (C7513).  The bf16 variant's rescale of the output is taken on a
//     stand-in accumulator of ones and applied after the wait.
//   * One TMA box of [64 rows, 64 columns] with the 128-byte swizzle a tile,
//     the last 16 columns zero-filled (sdpa_walk.cuh's head_map), and the
//     plan's entry broadcast from lane 0, so that the descriptors stay in
//     uniform registers.

#include "sdpa_core.cuh"
#include "sdpa_walk.cuh"

using namespace gigaam;

namespace {

constexpr int kRingStages = 8;                  // K/V stages, both consumers'
constexpr int kMaskBytes = kTile * 4;           // a stage's key masks, fp32
constexpr int kQBytes = kConsumers * kQSlots * kTileSmem;
constexpr int kHeadsSmem =
    kQBytes + kRingStages * (kStageBytes + kMaskBytes) + kSmemAlign;

struct HeadsMaps {
  CUtensorMap q, k, v;   // [B H, T, 48], boxes [1, 64, 64], 128-byte swizzle
};

struct HeadsArgs {
  const int2* plan;      // {first unit, units}, one a block; unit u is
                         // (head bh = u / n_pairs, query tiles 2 (u %
                         // n_pairs) and + 1)
  const void* mask;      // [B, T] (one row serves mask_heads heads) or
                         // [B H, T]; bytes, or fp32 for the madd variants
  bf16* o;               // [B H, T, 48]
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

// The producer warp: for each unit of the block's run, the Q tile of each
// consumer whose tile lies below T into its free slot, then the head's key
// tiles into free stages, each with its 64 additive key masks (all lanes);
// lane 0 issues the copies.
template <int kVariant>
__device__ __forceinline__ void produce_heads(const HeadsRing& r,
                                              const HeadsMaps& maps,
                                              const HeadsArgs& a, int2 span,
                                              int n_tiles) {
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
        load_tile(r.q_tile(c, qi[c]), &maps.q, (qt0 + c) * kTile, bh, qb);
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
        load_tile(r.stage(it), &maps.k, j * kTile, bh, fb);
        load_tile(r.stage(it) + kTileSmem, &maps.v, j * kTile, bh, fb);
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
// S has landed); the 64 rows from row0 of o_head.
template <int kVariant>
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
    store_rows<kD>(o, 1.f, 1.f, o_head, row0, t);
  } else {
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    store_rows<kD>(o, 1.f / l_lo, 1.f / l_hi, o_head, row0, t);
  }
}

// Consumer warpgroup c: query tile 2 p + c of each unit (head, pair p) of the
// block's run; a tile past T only releases the unit's stages.
template <int kVariant>
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
    walk<kVariant>(r, r.q_tile(c, qi), r.q_bar(r.q_empty, c, qi), it,
                   n_tiles, scale2, a.o + (size_t)bh * a.t * kD, qt * kTile,
                   a.t);
    ++qi;
  }
}

// one block an SM, walking its run of the plan; 384 threads: two consumer
// warpgroups, then the producer's
template <int kVariant>
__global__ void __launch_bounds__(kWsThreads, 1)
sdpa_heads_ws_kernel(const __grid_constant__ HeadsMaps maps,
                     const __grid_constant__ HeadsArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRingStages];
  __shared__ __align__(8) uint64_t empty[kRingStages];
  __shared__ __align__(8) uint64_t q_full[kConsumers * kQSlots];
  __shared__ __align__(8) uint64_t q_empty[kConsumers * kQSlots];
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
      produce_heads<kVariant>(r, maps, a, span, n_tiles);
  } else {
    regs_claim<kConsumerRegs>();
    consume_heads<kVariant>(r, a, span, n_tiles, wg);
  }
}

template <int kVariant>
int launch_heads(const HeadsMaps& maps, const HeadsArgs& a, int n_blocks,
                 cudaStream_t stream) {
  return static_cast<int>(launch<sdpa_heads_ws_kernel<kVariant>>(
      dim3(n_blocks), kWsThreads, kHeadsSmem, stream, maps, a));
}

}  // namespace

extern "C" {

// q, k, v, o: [B H, T, 48] bf16, contiguous, 16-byte aligned.  mask: [B, T]
// (layout kSdpaHeads: head bh reads row bh / H) or [B H, T] (layout
// kSdpaMaskPerHead, the full variant only), one byte each, nonzero = valid;
// fp32 and 4-byte aligned for the madd variants, the additive mask itself.
// plan: n_blocks int2 (int32 [n_blocks, 2]) on the card, 8-byte aligned,
// {first unit, units (>= 1)}, one block each.  variant: an SdpaVariant but
// the copy.  Returns cudaErrorInvalidValue, without a launch, for
// any other variant or layout, an unaligned pointer or a tensor map that
// cannot be made; else the first CUDA error of the opt-in and the launch.
int gigaam_sdpa_heads_ws(const void* q, const void* k, const void* v,
                         const void* mask, void* o, const void* plan,
                         int n_blocks, int variant, int layout, int batch,
                         int n_heads, int t, float scale, void* stream) {
  const bool madd = variant == kSdpaMaddRow || variant == kSdpaBf16Exp;
  const uintptr_t tiles = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  const bool layout_ok =
      layout == kSdpaHeads ||
      (layout == kSdpaMaskPerHead && variant == kSdpaFull);
  const bool aligned = tiles % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(plan) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % (madd ? 4 : 1) == 0;
  if (!layout_ok || !aligned || n_blocks < 1 || batch < 1 || n_heads < 1 ||
      t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadsMaps maps;
  const int bh = batch * n_heads;
  if (!head_map(&maps.q, q, bh, t) || !head_map(&maps.k, k, bh, t) ||
      !head_map(&maps.v, v, bh, t))
    return static_cast<int>(cudaErrorInvalidValue);
  HeadsArgs a;
  a.plan = static_cast<const int2*>(plan);
  a.mask = mask;
  a.o = static_cast<bf16*>(o);
  a.t = t;
  a.n_pairs = ((t + kTile - 1) / kTile + 1) / 2;
  a.mask_heads = layout == kSdpaMaskPerHead ? 1 : n_heads;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kSdpaFull: return launch_heads<kSdpaFull>(maps, a, n_blocks, s);
    case kSdpaTwoProducts:
      return launch_heads<kSdpaTwoProducts>(maps, a, n_blocks, s);
    case kSdpaNoMax: return launch_heads<kSdpaNoMax>(maps, a, n_blocks, s);
    case kSdpaNoScale: return launch_heads<kSdpaNoScale>(maps, a, n_blocks, s);
    case kSdpaMaddRow: return launch_heads<kSdpaMaddRow>(maps, a, n_blocks, s);
    case kSdpaBf16Exp: return launch_heads<kSdpaBf16Exp>(maps, a, n_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[2 i], out[2 i + 1]: the dynamic shared memory in bytes and how many
// blocks one SM holds at a time of sdpa_heads_ws_kernel<0>, <2> ... <6> in
// turn.
// Returns the first CUDA error code.
int gigaam_sdpa_heads_ws_occupancy(int* out) {
  const cudaError_t errs[] = {
      occupancy(sdpa_heads_ws_kernel<kSdpaFull>, kWsThreads, kHeadsSmem, out),
      occupancy(sdpa_heads_ws_kernel<kSdpaTwoProducts>, kWsThreads,
                kHeadsSmem, out + 2),
      occupancy(sdpa_heads_ws_kernel<kSdpaNoMax>, kWsThreads, kHeadsSmem,
                out + 4),
      occupancy(sdpa_heads_ws_kernel<kSdpaNoScale>, kWsThreads, kHeadsSmem,
                out + 6),
      occupancy(sdpa_heads_ws_kernel<kSdpaMaddRow>, kWsThreads, kHeadsSmem,
                out + 8),
      occupancy(sdpa_heads_ws_kernel<kSdpaBf16Exp>, kWsThreads, kHeadsSmem,
                out + 10)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
