// The SDPA ablation's packed layout (P11) redesigned for Hopper (sm_90a):
// the per-head walk of P12 and P10 (sdpa_heads_walk.cuh) reading each head
// of the packed [B, T, H 48] through a four-dimensional tensor map.
//
// It replaces the Pallas probe benchmarks/sdpa_ablation.py::run_packed (the
// body k_full_packed), as sdpa_ablation.cu's packed layout of K3's body did
// (kept there for an A/B on the same card).  For q, k, v [B, T, H 48] bf16,
// head h the 48 columns from 48 h, and a key mask [B, T], o [B, T, H 48]
// holds at columns 48 h .. the masked SDPA of head h of batch element b: K3's
// arithmetic (sdpa_core.cuh), an fp32 online softmax over 64-key tiles in
// base 2, P rounded to bf16 before P.V and the denominator divided out after
// it.  The function is A_full's on the heads moved to the packed layout.
//
// Bound on the card: as A_full's (sdpa_heads_ws.cu), by operations, 0.0082
// ms at B 8, H 16, T 501.
//
// The design is sdpa_heads_ws_kernel<kSdpaFull>'s (persistent blocks over
// heads_plan's units, a producer warp filling one ring of eight K/V stages
// with their key masks, two consumer warpgroups, one query tile of a unit
// each), with three things changed:
//   * Loads.  [B, T, H 48] is the contiguous [B, T, H, 48]: its 4-D tensor
//     map has dims {48, H, T, B}, byte strides {96, H 96, T H 96} and boxes
//     {64, 1, 64, 1} with the 128-byte swizzle.  Columns 48 .. 63 of a box
//     lie past dimension 0 and rows past T past dimension 2, so TMA fills
//     both with zeros: the tile in shared memory is byte for byte the one
//     head_map's box gives the head-major walk, and a box never reaches into
//     the next head.  The products read columns 0 .. 47 only (S three
//     k-steps of 16, P.V 48 output columns), so the fill is never read.
//   * Store.  o goes out packed, as P6's walk stores it: rows H 48 apart
//     from o + b T H 48 + 48 h.
//   * Mask.  Row b serves the H heads of batch element b.
// The row stride is a compile-time kPackedHeads 48 (the port's 16 heads);
// the entry refuses any other H.

#include "sdpa_heads_walk.cuh"

using namespace gigaam;

namespace {

struct PackedArgs {
  HeadsArgs a;
  int flat;   // -1: the 4-D map; else the planted 3-D map's column offset
};

__global__ void __launch_bounds__(kWsThreads, 1)
sdpa_packed_heads_ws_kernel(const __grid_constant__ HeadsMaps maps,
                            const __grid_constant__ PackedArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRingStages];
  __shared__ __align__(8) uint64_t empty[kRingStages];
  __shared__ __align__(8) uint64_t q_full[kConsumers * kQSlots];
  __shared__ __align__(8) uint64_t q_empty[kConsumers * kQSlots];
  heads_ws_block<kSdpaFull, true>(maps, p.a, smem_raw, full, empty, q_full,
                                  q_empty, p.flat);
}

// [B, T, kPackedHeads 48] bf16 as the 4-D [B, T, H, 48], boxes [1, 64 rows,
// 1, 64 columns] with the 128-byte swizzle: columns 48 .. 63 and rows past T
// are zero-filled.  With flat: the 3-D [B, T, H 48] over the flat columns,
// boxes [1, 64, 64], whose columns reach into the next head.
bool packed_map(CUtensorMap* map, const void* base, int batch, int t,
                bool flat) {
  const cuuint64_t row = kPackedHeads * kD;
  if (flat) {
    const cuuint64_t dims[3] = {row, (cuuint64_t)t, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {row * 2, (cuuint64_t)t * row * 2};
    const cuuint32_t box[3] = {64, kTile, 1};
    return bf16_map(map, base, 3, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)kPackedHeads,
                              (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {kD * 2, row * 2, (cuuint64_t)t * row * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  return bf16_map(map, base, 4, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

// q, k, v, o: [B, T, H 48] bf16 with H = 16 (kPackedHeads), contiguous,
// 16-byte aligned; head h the columns 48 h ...  mask: [B, T], one byte each,
// nonzero = valid; row b serves the H heads of batch element b.  plan:
// n_blocks int2 (int32 [n_blocks, 2]) on the card, 8-byte aligned, {first
// unit, units (>= 1)}, one block each, heads_plan's over B H heads (unit u
// is head bh = u / pairs, b = bh / H, h = bh % H).  flat: -1 for the 4-D
// map; 0 .. 47 reads each tile through a 3-D map over the flat H 48
// columns at column 48 h + flat (a slip that chip_smoke.py plants: 0 puts
// the next head's columns in the unread columns 48 .. 63 of a box, 16 in
// its read columns 32 .. 47).  Returns cudaErrorInvalidValue, without a
// launch, for any other H or flat, an unaligned pointer or a tensor map that
// cannot be made; else the first CUDA error of the opt-in and the launch.
int gigaam_sdpa_packed_heads_ws(const void* q, const void* k, const void* v,
                                const void* mask, void* o, const void* plan,
                                int n_blocks, int batch, int n_heads, int t,
                                int flat, float scale, void* stream) {
  const uintptr_t tiles = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  if (n_heads != kPackedHeads || flat < -1 || flat >= kD || tiles % 16 != 0 ||
      reinterpret_cast<uintptr_t>(plan) % 8 != 0 || n_blocks < 1 ||
      batch < 1 || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadsMaps maps;
  if (!packed_map(&maps.q, q, batch, t, flat >= 0) ||
      !packed_map(&maps.k, k, batch, t, flat >= 0) ||
      !packed_map(&maps.v, v, batch, t, flat >= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  PackedArgs p;
  p.a.plan = static_cast<const int2*>(plan);
  p.a.mask = mask;
  p.a.o = static_cast<bf16*>(o);
  p.a.t = t;
  p.a.n_pairs = ((t + kTile - 1) / kTile + 1) / 2;
  p.a.mask_heads = kPackedHeads;
  p.a.scale = scale;
  p.flat = flat;
  return static_cast<int>(launch<sdpa_packed_heads_ws_kernel>(
      dim3(n_blocks), kWsThreads, kHeadsSmem,
      static_cast<cudaStream_t>(stream), maps, p));
}

// out[0], out[1]: the dynamic shared memory in bytes and how many blocks one
// SM holds at a time of sdpa_packed_heads_ws_kernel.  Returns a CUDA error
// code.
int gigaam_sdpa_packed_heads_ws_occupancy(int* out) {
  return static_cast<int>(occupancy(sdpa_packed_heads_ws_kernel, kWsThreads,
                                    kHeadsSmem, out));
}

}  // extern "C"
