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
//
// The walk's device code is sdpa_heads_walk.cuh's, which P11's packed
// instance (sdpa_packed_heads_ws.cu) shares.

#include "sdpa_heads_walk.cuh"

using namespace gigaam;

namespace {

template <int kVariant>
__global__ void __launch_bounds__(kWsThreads, 1)
sdpa_heads_ws_kernel(const __grid_constant__ HeadsMaps maps,
                     const __grid_constant__ HeadsArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRingStages];
  __shared__ __align__(8) uint64_t empty[kRingStages];
  __shared__ __align__(8) uint64_t q_full[kConsumers * kQSlots];
  __shared__ __align__(8) uint64_t q_empty[kConsumers * kQSlots];
  heads_ws_block<kVariant, false>(maps, a, smem_raw, full, empty, q_full,
                                  q_empty, -1);
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
