// The SDPA ablation on Hopper (sm_90a): K3's kernel body (sdpa_core.cuh)
// with one thing changed at a time, to split K3's time between the launch
// and loads, the two products, the softmax and its parts, the mask, the head
// layout and the block geometry.
//
// Replaces the Pallas probes of benchmarks/sdpa_ablation.py: `run` (the
// bodies k_full, k_copy, k_scores_only, k_no_max, k_prescaled, k_maddrow,
// k_bf16_softmax), `run_allheads` (k_allheads), `run_identity_maps` (k_full
// with the mask pre-broadcast per head) and `run_packed` (k_full_packed).
// What each variant computes is in sdpa_core.cuh's SdpaVariant; the Python
// side (gigaam_tpu_torch/probes/sdpa_ablation.py) holds the plain version of
// each.
//
// Bound on the card: as K3, by operations at the ablation's shapes (B 8,
// H 16, T' 501: 4 B H T^2 d_h tensor operations against 8 B H T d_h bytes),
// but for the copy (bytes) and the two bare products (no softmax work).
//
// Design: K3's, one warpgroup a block; the full variant in the head-major
// layout is K3's code.  The head-group layout is one block per (64-row query
// tile, group of heads, batch element) that walks its heads in turn on one
// shared memory: at B 8, H 16, T' 501 and 16 heads a group that is 8 x 8 =
// 64 blocks for 132 SMs.  The packed layout reads and writes each head as a
// 48-column slice of [B, T, H * 48], through the row stride of
// load_tile_async and store_fragment.

#include "sdpa_core.cuh"

using namespace gigaam;

namespace {

template <int kVariant, int kLayout>
__global__ void __launch_bounds__(kThreads)
sdpa_ablation_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const void* __restrict__ mask,
                     bf16* __restrict__ o, int n_heads, int t, float scale,
                     int heads_per_block) {
  sdpa_body<kVariant, kLayout>(
      q, k, v, static_cast<const SdpaMask<kVariant>*>(mask), o, nullptr,
      n_heads, t, scale, heads_per_block);
}

typedef void (*AblationKernel)(const bf16*, const bf16*, const bf16*,
                               const void*, bf16*, int, int, float, int);

// the kernel of (variant, layout): every variant in the head-major layout,
// the full variant in the others; null for any other pair
AblationKernel ablation_kernel(int variant, int layout) {
  if (layout == kSdpaHeads) {
    switch (variant) {
      case kSdpaFull: return sdpa_ablation_kernel<kSdpaFull, kSdpaHeads>;
      case kSdpaCopy: return sdpa_ablation_kernel<kSdpaCopy, kSdpaHeads>;
      case kSdpaTwoProducts:
        return sdpa_ablation_kernel<kSdpaTwoProducts, kSdpaHeads>;
      case kSdpaNoMax: return sdpa_ablation_kernel<kSdpaNoMax, kSdpaHeads>;
      case kSdpaNoScale: return sdpa_ablation_kernel<kSdpaNoScale, kSdpaHeads>;
      case kSdpaMaddRow: return sdpa_ablation_kernel<kSdpaMaddRow, kSdpaHeads>;
      case kSdpaBf16Exp: return sdpa_ablation_kernel<kSdpaBf16Exp, kSdpaHeads>;
      default: return nullptr;
    }
  }
  if (variant != kSdpaFull) return nullptr;
  switch (layout) {
    case kSdpaHeadGroups:
      return sdpa_ablation_kernel<kSdpaFull, kSdpaHeadGroups>;
    case kSdpaMaskPerHead:
      return sdpa_ablation_kernel<kSdpaFull, kSdpaMaskPerHead>;
    case kSdpaPacked: return sdpa_ablation_kernel<kSdpaFull, kSdpaPacked>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, 48] bf16 ([B, T, H * 48] for the packed layout),
// contiguous, 16-byte aligned.  mask: [B, T] (the per-head layout: [B * H,
// T]) of one byte each, nonzero = valid; for the madd variants fp32, the
// additive mask itself.  heads_per_block: the head-group layout's group
// (dividing H); 1 otherwise.  Returns cudaErrorInvalidValue, without a
// launch, for a pair of variant and layout that has no kernel or a group that
// does not divide H; else cudaGetLastError().
int gigaam_sdpa_ablation(const void* q, const void* k, const void* v,
                         const void* mask, void* o, int variant, int layout,
                         int batch, int n_heads, int t, int heads_per_block,
                         float scale, void* stream) {
  const AblationKernel kernel = ablation_kernel(variant, layout);
  const bool groups = layout == kSdpaHeadGroups;
  if (kernel == nullptr || heads_per_block < 1 ||
      (groups ? n_heads % heads_per_block != 0 : heads_per_block != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((t + kTile - 1) / kTile,
            groups ? n_heads / heads_per_block : n_heads, batch);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), n_heads, t,
      scale, heads_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
