// The SDPA ablation's head-group walk (P9) redesigned for Hopper (sm_90a): a
// pipelined, warp-specialised kernel.
//
// It replaces the Pallas probe benchmarks/sdpa_ablation.py::run_allheads
// (the body k_allheads), as sdpa_ablation.cu's head-group layout of K3's body
// did (kept there for an A/B on the same card), and computes the same
// function: for q, k, v [B, H, T, 48] bf16 and a key mask [B, T] of one byte
// each (nonzero = valid), o = softmax(q k^T / sqrt(48) + (mask - 1) 1e9) v
// per (batch element, head), the softmax in fp32 online over 64-key tiles in
// base-2 units, P rounded to bf16 before P.V and the denominator divided out
// after it: K3's arithmetic (sdpa_core.cuh), in the same order, so the
// output has the head-group kernel's bits.
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 67 TFLOP/s fp32,
// 3.35 TB/s): 4 B H T^2 48 tensor operations and ~4 fp32 operations a score
// against 8 B H T 48 bytes, so operations: 0.0082 ms at B 8, H 16, T 501.
//
// What held the head-group kernel back, and what this design does:
//   * Its grid was one block per (64-row query tile, group of heads, batch
//     element): at 16 heads a group, B 8 and T 501, 64 blocks for 132 SMs.
//     Here a cell (query tile, group, batch element) is cut into runs of
//     its heads, one block a run, by the caller's plan
//     (probes/sdpa_ablation.py::groups_plan, the fewest modelled waves of
//     head walks: 128 blocks there).  A block still walks a contiguous run
//     of one cell's heads.
//   * One warpgroup waited on each tile's loads (two cp.async stages) and on
//     each product in turn.  Here one producer warp (its warpgroup lowered to
//     40 registers with setmaxnreg) only issues TMA copies: per consumer a
//     ring of four K/V stages and two Q slots (a head's Q tile loads once),
//     each on mbarriers.  Two consumer warpgroups (raised to 232) each walk
//     their own heads of the run (every other one) and only wait on `full`,
//     multiply and release: while one runs its softmax the other's products
//     hold the tensor cores.
//   * Within a consumer, key tile j's S = Q K^T is issued before tile j - 1's
//     P.V is waited on, so the softmax of tile j runs while P.V of tile j - 1
//     is in flight; the output is rescaled to the new running max, and P
//     packed to bf16, after that product lands (the order of K3's online
//     softmax).  Packed while it runs, P went to registers that ptxas could
//     share with the operand still being read, and ptxas serialised every
//     product (its warning C7513).
//   * A 48-column row is 96 bytes, which no swizzle width fits.  Each tile
//     is one TMA box of [64 rows, 64 columns] with the 128-byte swizzle, the
//     last 16 columns zero-filled (as are rows past T, whose keys the mask
//     sets to -inf): gemm.cuh's K-major layout for Q and K and its MN-major
//     layout for V, 64 requests of 96 bytes a tile.  Six boxes of 8 columns
//     in the core-matrix layout (384 requests of 16 bytes a tile) held the
//     walk at the loads' rate.
//   * The warpgroup and the unit are broadcast from lane 0, so that ptxas
//     keeps the descriptors in uniform registers.
//
// The walk's device code is in sdpa_walk.cuh, which attn_fold_ws.cu also
// includes for the attention fold's packed instance.


#include "sdpa_walk.cuh"

using namespace gigaam;

namespace {

// one block a unit of the plan, 384 threads: two consumer warpgroups, then
// the producer's
__global__ void __launch_bounds__(kWsThreads, 1)
sdpa_groups_ws_kernel(const __grid_constant__ GroupsMaps maps,
                      const __grid_constant__ GroupsArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kConsumers * kStages];
  __shared__ __align__(8) uint64_t empty[kConsumers * kStages];
  __shared__ __align__(8) uint64_t q_full[kConsumers * kQSlots];
  __shared__ __align__(8) uint64_t q_empty[kConsumers * kQSlots];
  const Ring r{aligned_smem(smem_raw), smem_u32(full), smem_u32(empty),
               smem_u32(q_full), smem_u32(q_empty)};
  const int4 unit = uniform(a.units[blockIdx.x]);
  const int n_tiles = (a.t + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConsumers * kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, 4);   // the consumer's four warps
    }
    for (int s = 0; s < kConsumers * kQSlots; ++s) {
      mbar_init(r.q_full + 8 * s, 1);
      mbar_init(r.q_empty + 8 * s, 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / 128);
  if (wg == kConsumers) {
    regs_release<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) produce(r, maps, a, unit, n_tiles);
  } else {
    regs_claim<kConsumerRegs>();
    consume<false>(r, a, unit, n_tiles, wg);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, 48] bf16, contiguous, 16-byte aligned; mask: [B, T]
// of one byte each, nonzero = valid; units: the plan, n_units int4 (int32
// [n_units, 4]) on the card, {batch element, query tile, first head, heads
// (>= 1)}, one block each.  Returns cudaErrorInvalidValue for a tensor map
// that cannot be made, else the first CUDA error of the opt-in and the
// launch.
int gigaam_sdpa_groups_ws(const void* q, const void* k, const void* v,
                          const void* mask, void* o, const void* units,
                          int n_units, int batch, int n_heads, int t,
                          float scale, void* stream) {
  GroupsMaps maps;
  const int bh = batch * n_heads;
  if (!head_map(&maps.q, q, bh, t) || !head_map(&maps.k, k, bh, t) ||
      !head_map(&maps.v, v, bh, t))
    return static_cast<int>(cudaErrorInvalidValue);
  GroupsArgs a;
  a.units = static_cast<const int4*>(units);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = static_cast<bf16*>(o);
  a.n_heads = n_heads;
  a.t = t;
  a.scale = scale;
  return static_cast<int>(launch<sdpa_groups_ws_kernel>(
      dim3(n_units), kWsThreads, kSmem, static_cast<cudaStream_t>(stream),
      maps, a));
}

// out[0]: the kernel's dynamic shared memory in bytes, out[1]: how many of
// its blocks one SM holds at a time.  Returns a CUDA error code.
int gigaam_sdpa_groups_ws_occupancy(int* out) {
  return static_cast<int>(
      occupancy(sdpa_groups_ws_kernel, kWsThreads, kSmem, out));
}

}  // extern "C"
