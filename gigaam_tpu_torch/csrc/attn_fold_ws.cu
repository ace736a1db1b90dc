// The attention-fold probes P6 and P7 redesigned for Hopper (sm_90a): the
// module's two products on conv_ws.cuh's warp-specialised, persistent cores
// around the SDPA ablation's pipelined head walk (sdpa_groups_ws.cu).
//
// It replaces the Pallas probes benchmarks/pallas_attn_fold_probe.py::
// folded_attention_nb (P6, the body _fold_kernel_nb) and ::folded_attention
// (P7, _fold_kernel, with per-head weight blocks or lane-sliced full
// weights), as attn_fold_probe.cu's four launches did (kept there for an
// A/B on the same card and for P8), and computes the same function with the
// same rounding points: for post-LN x [B, T, 768] bf16,
//   the row pass (projection.cu's ln_rope_kernel<false>)
//                           xr = bf16(RoPE(x))
//   fold_qkv_*_kernel       q, k = bf16(xr Wq|Wk + bq|bk), v = bf16(x Wv + bv),
//                           stored head-major [B, 16, T, 48] (1/sqrt(48) is in
//                           Wq and bq)
//   sdpa_packed_ws_kernel   o = bf16(softmax(q k^T + mask) v), P rounded to
//                           bf16 before P.V, the denominator divided out
//                           after it, stored packed [B T, 768]
//   fold_out_*_kernel       out = bf16(o Wo + bo), accumulated in fp32
// Rows are b T + t: T (500, 768) is no multiple of 64, so a tile's rows
// straddle batch elements; each row is addressed on its own, and rows past
// M are neither loaded (TMA fills zeros) nor stored.
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): 2 M 768 3072
// tensor operations in the products and 4 B 16 T^2 48 in the SDPA against
// ~6 KB a row, so operations: 0.0547 ms at B 16, T 500.
//
// What held attn_fold_probe.cu's products back, and what this design does:
//   * They are K1/K2's TMA-ring GEMMs (gemm.cuh): 64 nb-row, N-128 tiles,
//     one block a tile, each item's products drained before its stage was
//     released; at B 16, T 500 the Q/K/V product ran at 0.40 of its bound
//     and the output product at 0.28.  K is 768 here: 12 items of 64, so a
//     tile's epilogue (bias, rounding, 32-64 KB of stores) is as long as a
//     good part of its main loop.  On WsCore's cooperative schedule both
//     consumer warpgroups share a 128-row tile and run that epilogue at
//     once while the tensor cores idle.
//   * So P7 runs on conv_ws.cuh's PingPongCore: each consumer owns whole
//     64-row tiles, the two take turns on the tensor cores (named barriers),
//     and one's epilogue runs under the other's products; the producer
//     warp fills one ring in unit order; the grid is persistent, one block
//     an SM, walking probes/ws_plan.py::ws_plan's units with K unsplit.
//     foldB (the full weights sliced per head) takes 64 x 256 tiles that
//     straddle heads, in clusters of two that multicast half of each weight
//     box (128 rows a box); foldA (per-head weight blocks) 64 x 192 tiles
//     of four whole heads, unshared, its Q/K weights read K-major straight
//     from the [16, 48, 768] blocks (wgmma_ss_tk<192>), so each store
//     writes whole 96-byte head rows.
//   * P6 keeps its question, more rows a weight box, on WsCore: nb 2 on
//     128 x 256 tiles (the cooperative schedule, the epilogue exposed), nb 4
//     the same in clusters of two with the weight boxes multicast, 256 rows
//     a weight box.
//   * The Q/K columns [0, 1536) read xr, the V columns x: both tile widths
//     break at 1536 (and at 768), so each column tile picks its A map and
//     its weight (Wq, Wk or Wv) by itself.
//   * The SDPA is P9's walk (sdpa_walk.cuh, the code of sdpa_groups_ws.cu's
//     kernel: a producer warp, two consumer warpgroups with S in flight
//     across the softmax) with o stored packed, so that the output product
//     reads it as a plain 2-D map; its arithmetic is K3's, so o has
//     attention.cu's bits.  Its instance is here, not beside P9's: a
//     second kernel in P9's translation unit changed P9's SASS.

#include "attn_fold_ws.cuh"
#include "sdpa_walk.cuh"

using namespace gigaam;

namespace {

struct QkvMaps {
  CUtensorMap a[2];    // xr (the q/k columns), x (the v columns): [M, 768]
  CUtensorMap b[3];    // Wq, Wk, Wv [768, 768] [in, out] read MN-major; with
                       // per-head blocks Wq, Wk [768 (16 x 48), 768] read K-major
};

// As conv_ws.cuh's load_b_mn, of a K-major B tile [kBN rows of N, 64 K
// columns] (a weight laid out [N, K]): one box, or in a cluster its rows
// kBN / kCluster rank ..
template <int kBN, int kCluster>
__device__ __forceinline__ void load_b_k(uint32_t sb, const CUtensorMap* map,
                                         int c0, int item, uint32_t bar,
                                         uint32_t rank) {
  constexpr int kRows = kBN / kCluster;
  static_assert(kRows % 8 == 0, "parts of whole 8-row swizzle atoms");
  if constexpr (kCluster == 1)
    tma_load_2d(sb, map, item * kBK, c0, bar);
  else
    tma_load_2d_multicast(sb + rank * kRows * 128, map, item * kBK,
                          c0 + rank * kRows, bar, (1 << kCluster) - 1);
}

// A warpgroup's [64, kBN] accumulator of rows r0 .. and Q/K/V columns n0 ..
// (within one of q, k, v: no tile straddles column 768 or 1536): + the fp32
// bias, rounded to bf16, each 16-byte chunk (8 columns of one head) stored
// at its row's place in [B, 16, T, 48]
template <int kBN>
__device__ __forceinline__ void store_qkv(const float (&acc)[kBN / 2],
                                          const FoldArgs& a, int r0,
                                          int n0) {
  const int which = n0 / kModel, c0 = n0 % kModel;
  bf16* out = a.out[which];
  const int lane = threadIdx.x & 31;
  const int row = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  // the fragment's two rows (row, row + 8): b 16 T 48 + t 48, -1 past M
  long long base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    base[h] = m < a.m ? ((long long)(m / a.t) * kHeads * a.t + m % a.t) * kD
                      : -1;
  }
  const long long head_stride = (long long)a.t * kD;
  store_tile_chunks<kBN>(acc, a.bias[which] + c0,
                         [&](int r, int chunk, uint4 val) {
    const long long b0 = base[(r >> 3) & 1];
    const int col = c0 + chunk * 8;
    if (b0 >= 0)
      *reinterpret_cast<uint4*>(out + b0 + (col / kD) * head_stride +
                                col % kD) = val;
  });
}

// A warpgroup's [64, kBN] accumulator of rows r0 .., columns n0 ..: + bo,
// rounded to bf16, stored into out [M, 768]
template <int kBN>
__device__ __forceinline__ void store_out(const float (&acc)[kBN / 2],
                                          const FoldArgs& a, int r0, int n0) {
  bf16* out = a.out[0];
  store_tile_chunks<kBN>(acc, a.bias[0] + n0,
                         [&](int r, int chunk, uint4 val) {
    const int m = r0 + r;
    if (m < a.m)
      *reinterpret_cast<uint4*>(out + (size_t)m * kModel + n0 + chunk * 8) =
          val;
  });
}

// ---------------------------------------------------------------------------
// the kernels: one block an SM (in clusters of kCluster), 384 threads, two
// consumer warpgroups, then the producer's
// ---------------------------------------------------------------------------

template <int kBN, int kCluster, bool kHeadBlocks>
__global__ void __launch_bounds__(PingPong<kBN, kCluster>::kThreads, 1)
fold_qkv_pp_kernel(const __grid_constant__ QkvMaps maps,
                   const __grid_constant__ FoldArgs a) {
  using Core = PingPong<kBN, kCluster>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  Core::run(
      smem, full, empty, a.units, a.n_units,
      [&](int4 unit, int item, uint32_t sa, uint32_t sb, uint32_t bar,
          uint32_t rank) {
        const int n0 = unit_col(unit) * kBN;
        const int which = n0 / kModel, c0 = n0 % kModel;
        tma_load_2d(sa, &maps.a[which == 2], item * kBK, unit.x * Core::kBM,
                    bar);
        if (kHeadBlocks && which < 2)
          load_b_k<kBN, kCluster>(sb, &maps.b[which], c0, item, bar, rank);
        else
          load_b_mn<kBN, kCluster>(sb, &maps.b[which], c0, item, bar, rank);
      },
      [&](float (&acc)[kBN / 2], uint32_t sa, uint32_t sb, int4 unit) {
        if (kHeadBlocks && unit_col(unit) * kBN < 2 * kModel)
          mma_item<kBN, kCluster, kHeadBlocks>(acc, sa, sb);
        else
          mma_item<kBN, kCluster, false>(acc, sa, sb);
      },
      [&](const float (&acc)[kBN / 2], int4 unit) {
        store_qkv<kBN>(acc, a, unit.x * Core::kBM, unit_col(unit) * kBN);
      });
}

template <int kCluster>
__global__ void __launch_bounds__(Coop<kCluster>::kThreads, 1)
fold_qkv_coop_kernel(const __grid_constant__ QkvMaps maps,
                     const __grid_constant__ FoldArgs a) {
  using Core = Coop<kCluster>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  Core::run_loads(
      smem, full, empty, a.units, a.n_units,
      [&](int4 unit, int item, uint32_t sa, uint32_t sb, uint32_t bar,
          uint32_t rank) {
        const int n0 = unit_col(unit) * 256;
        const int which = n0 / kModel;
        tma_load_2d(sa, &maps.a[which == 2], item * kBK, unit.x * Core::kBM,
                    bar);
        load_b_coop<kCluster>(sb, &maps.b[which], n0 % kModel, item, bar,
                              rank);
      },
      [&](const float (&acc)[128], int4 unit) {
        store_qkv<256>(acc, a, unit.x * Core::kBM + (threadIdx.x / 128) * 64,
                       unit_col(unit) * 256);
      });
}

template <int kBN, int kCluster>
__global__ void __launch_bounds__(PingPong<kBN, kCluster>::kThreads, 1)
fold_out_pp_kernel(const __grid_constant__ OutMaps maps,
                   const __grid_constant__ FoldArgs a) {
  using Core = PingPong<kBN, kCluster>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  Core::run(
      smem, full, empty, a.units, a.n_units,
      [&](int4 unit, int item, uint32_t sa, uint32_t sb, uint32_t bar,
          uint32_t rank) {
        tma_load_2d(sa, &maps.a, item * kBK, unit.x * Core::kBM, bar);
        load_b_mn<kBN, kCluster>(sb, &maps.b, unit_col(unit) * kBN, item, bar,
                                 rank);
      },
      [&](float (&acc)[kBN / 2], uint32_t sa, uint32_t sb, int4) {
        mma_item<kBN, kCluster, false>(acc, sa, sb);
      },
      [&](const float (&acc)[kBN / 2], int4 unit) {
        store_out<kBN>(acc, a, unit.x * Core::kBM, unit_col(unit) * kBN);
      });
}

template <int kCluster>
__global__ void __launch_bounds__(Coop<kCluster>::kThreads, 1)
fold_out_coop_kernel(const __grid_constant__ OutMaps maps,
                     const __grid_constant__ FoldArgs a) {
  using Core = Coop<kCluster>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  Core::run_loads(
      smem, full, empty, a.units, a.n_units,
      [&](int4 unit, int item, uint32_t sa, uint32_t sb, uint32_t bar,
          uint32_t rank) {
        tma_load_2d(sa, &maps.a, item * kBK, unit.x * Core::kBM, bar);
        load_b_coop<kCluster>(sb, &maps.b, unit_col(unit) * 256, item, bar,
                              rank);
      },
      [&](const float (&acc)[128], int4 unit) {
        store_out<256>(acc, a, unit.x * Core::kBM + (threadIdx.x / 128) * 64,
                       unit_col(unit) * 256);
      });
}

// the SDPA stage: sdpa_groups_ws.cu's kernel (P9's walk, sdpa_walk.cuh) with
// o packed
__global__ void __launch_bounds__(kWsThreads, 1)
sdpa_packed_ws_kernel(const __grid_constant__ GroupsMaps maps,
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
      mbar_init(r.empty + 8 * s, 4);
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
    consume<true>(r, a, unit, n_tiles, wg);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Maps>
cudaError_t launch_qkv(int schedule, int grid, cudaStream_t s,
                       const Maps& maps, const FoldArgs& a) {
  switch (schedule) {
    case kLaneSlices:
      return launch_ws<PingPong<256, 2>, 2,
                       fold_qkv_pp_kernel<256, 2, false>>(grid, s, maps, a);
    case kHeadTiles:
      return launch_ws<PingPong<192, 1>, 1,
                       fold_qkv_pp_kernel<192, 1, true>>(grid, s, maps, a);
    case kCoop:
      return launch_ws<Coop<1>, 1, fold_qkv_coop_kernel<1>>(grid, s, maps, a);
    case kCoopCluster:
      return launch_ws<Coop<2>, 2, fold_qkv_coop_kernel<2>>(grid, s, maps, a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Maps>
cudaError_t launch_out(int schedule, int grid, cudaStream_t s,
                       const Maps& maps, const FoldArgs& a) {
  switch (schedule) {
    case kLaneSlices:
      return launch_ws<PingPong<256, 2>, 2, fold_out_pp_kernel<256, 2>>(
          grid, s, maps, a);
    case kHeadTiles:
      return launch_ws<PingPong<192, 1>, 1, fold_out_pp_kernel<192, 1>>(
          grid, s, maps, a);
    case kCoop:
      return launch_ws<Coop<1>, 1, fold_out_coop_kernel<1>>(grid, s, maps, a);
    case kCoopCluster:
      return launch_ws<Coop<2>, 2, fold_out_coop_kernel<2>>(grid, s, maps, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// blocks of the schedule's Q/K/V kernel that the card holds at once (its
// persistent grid's ceiling): clusters at once times their size
template <typename Core, int kCluster, auto kKernel>
cudaError_t slots_of(int* out) {
  cudaError_t err = ws_opt_in<Core, kKernel>();
  if (err != cudaSuccess) return err;
  const int sms = sm_count() > 0 ? sm_count() : 132;
  if constexpr (kCluster == 1) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kKernel, Core::kThreads, Core::kSmem);
    *out = per_sm * sms;
    return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ws_launch_config<Core, kCluster>(kCluster * sms, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kKernel, &cfg);
  *out = clusters * kCluster;
  return err;
}

}  // namespace

extern "C" {

// The Q/K/V product of schedule `schedule` (Schedule: 0 64 x 256 ping-pong
// in clusters of two, 1 64 x 192 ping-pong with per-head Q/K blocks, 2
// 128 x 256 cooperative, 3 the same in clusters of two): xr, x [M, 768]
// bf16 (M = B T); wq, wk [768, 768] bf16 [in, out], or with schedule 1
// the per-head blocks [16, 48, 768] (the transposed weights); wv
// [768, 768] [in, out]; bq, bk, bv [768]
// fp32; q, k, v [B, 16, T, 48] bf16; units: the plan, n_units int4 on the
// card (probes/ws_plan.py: ws_plan with one K split, in the schedule's
// row tiles and cluster); grid blocks (a multiple of the cluster).  Every pointer 16-byte aligned.  Returns cudaErrorInvalidValue
// for arguments or tensor maps it cannot take, else the first CUDA error
// of the opt-in and the launch.
int gigaam_fold_ws_qkv(const void* xr, const void* x, const void* wq,
                       const void* wk, const void* wv, const void* bq,
                       const void* bk, const void* bv, void* q, void* k,
                       void* v, const void* units, int n_units, int grid,
                       int m, int t, int schedule, void* stream) {
  if (m < 1 || t < 1 || m % t || n_units < 1 || grid < 1 ||
      schedule < 0 || schedule >= kSchedules || grid % cluster_of(schedule))
    return static_cast<int>(cudaErrorInvalidValue);
  QkvMaps maps;
  const int rows = a_box_rows(schedule);
  const bool heads = schedule == kHeadTiles;
  const int k_rows = (heads ? 192 : 0) / cluster_of(schedule);
  if (!matrix_map(&maps.a[0], xr, m, kModel, rows) ||
      !matrix_map(&maps.a[1], x, m, kModel, rows) ||
      !matrix_map(&maps.b[0], wq, kModel, kModel,
                  heads ? k_rows : mn_box_rows(schedule)) ||
      !matrix_map(&maps.b[1], wk, kModel, kModel,
                  heads ? k_rows : mn_box_rows(schedule)) ||
      !matrix_map(&maps.b[2], wv, kModel, kModel, mn_box_rows(schedule)))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs a;
  a.units = static_cast<const int4*>(units);
  a.bias[0] = static_cast<const float*>(bq);
  a.bias[1] = static_cast<const float*>(bk);
  a.bias[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  a.n_units = n_units;
  a.m = m;
  a.t = t;
  return static_cast<int>(launch_qkv(
      schedule, grid, static_cast<cudaStream_t>(stream), maps, a));
}

// The output product of schedule `schedule` (as gigaam_fold_ws_qkv): out
// [M, 768] = bf16(o . wo + bo), o packed [M, 768] bf16 (head h at columns
// 48 h ..), wo [768, 768] bf16 [in, out], bo [768] fp32.  Returns a CUDA
// error code as gigaam_fold_ws_qkv.
int gigaam_fold_ws_out(const void* o, const void* wo, const void* bo,
                       void* out, const void* units, int n_units, int grid,
                       int m, int schedule, void* stream) {
  if (m < 1 || n_units < 1 || grid < 1 || schedule < 0 ||
      schedule >= kSchedules || grid % cluster_of(schedule))
    return static_cast<int>(cudaErrorInvalidValue);
  OutMaps maps;
  if (!matrix_map(&maps.a, o, m, kModel, a_box_rows(schedule)) ||
      !matrix_map(&maps.b, wo, kModel, kModel, mn_box_rows(schedule)))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs a = {};
  a.units = static_cast<const int4*>(units);
  a.bias[0] = static_cast<const float*>(bo);
  a.out[0] = static_cast<bf16*>(out);
  a.n_units = n_units;
  a.m = m;
  a.t = 1;
  return static_cast<int>(launch_out(
      schedule, grid, static_cast<cudaStream_t>(stream), maps, a));
}

// The SDPA stage, sdpa_packed_ws_kernel: as sdpa_groups_ws.cu's
// gigaam_sdpa_groups_ws (q, k, v [B, 16, T, 48] bf16, mask [B, T] of one
// byte each, nonzero = valid, units: groups_plan's, one block each), but o
// is packed, [B, T, 16 * 48] bf16 with head h at columns 48 h ..; n_heads
// must be 16.  Rows past T are not stored: in this layout they are the
// next batch element's.  Returns cudaErrorInvalidValue for arguments or a
// tensor map it cannot take, else the first CUDA error of the opt-in and
// the launch.
int gigaam_fold_ws_sdpa(const void* q, const void* k, const void* v,
                        const void* mask, void* o, const void* units,
                        int n_units, int batch, int n_heads, int t,
                        float scale, void* stream) {
  if (n_heads != kPackedHeads || n_units < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  return static_cast<int>(launch<sdpa_packed_ws_kernel>(
      dim3(n_units), kWsThreads, kSmem, static_cast<cudaStream_t>(stream),
      maps, a));
}

// out[0]: how many blocks of schedule `schedule`'s Q/K/V kernel the card
// holds at once (clusters times their size), the persistent grids' ceiling.
// Returns a CUDA error code.
int gigaam_fold_ws_slots(int schedule, int* out) {
  switch (schedule) {
    case kLaneSlices:
      return static_cast<int>(slots_of<PingPong<256, 2>, 2,
                              fold_qkv_pp_kernel<256, 2, false>>(out));
    case kHeadTiles:
      return static_cast<int>(slots_of<PingPong<192, 1>, 1,
                              fold_qkv_pp_kernel<192, 1, true>>(out));
    case kCoop:
      return static_cast<int>(
          slots_of<Coop<1>, 1, fold_qkv_coop_kernel<1>>(out));
    case kCoopCluster:
      return static_cast<int>(
          slots_of<Coop<2>, 2, fold_qkv_coop_kernel<2>>(out));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// For the Q/K/V kernel, then the output kernel, of each schedule in order
// (fold_qkv_pp_kernel <256, 2, false>, <192, 1, true>, fold_qkv_coop_kernel
// <1>, <2>; fold_out_pp_kernel <256, 2>, <192, 1>, fold_out_coop_kernel
// <1>, <2>), then sdpa_packed_ws_kernel: out[2 i] the dynamic shared memory
// in bytes, out[2 i + 1] how many blocks one SM holds at a time.  Returns a
// CUDA error code.
int gigaam_attn_fold_ws_occupancy(int* out) {
  const cudaError_t errs[] = {
      occupancy(fold_qkv_pp_kernel<256, 2, false>, PingPong<256, 2>::kThreads,
                PingPong<256, 2>::kSmem, out),
      occupancy(fold_qkv_pp_kernel<192, 1, true>, PingPong<192, 1>::kThreads,
                PingPong<192, 1>::kSmem, out + 2),
      occupancy(fold_qkv_coop_kernel<1>, Coop<1>::kThreads,
                Coop<1>::kSmem, out + 4),
      occupancy(fold_qkv_coop_kernel<2>, Coop<2>::kThreads,
                Coop<2>::kSmem, out + 6),
      occupancy(fold_out_pp_kernel<256, 2>, PingPong<256, 2>::kThreads,
                PingPong<256, 2>::kSmem, out + 8),
      occupancy(fold_out_pp_kernel<192, 1>, PingPong<192, 1>::kThreads,
                PingPong<192, 1>::kSmem, out + 10),
      occupancy(fold_out_coop_kernel<1>, Coop<1>::kThreads,
                Coop<1>::kSmem, out + 12),
      occupancy(fold_out_coop_kernel<2>, Coop<2>::kThreads,
                Coop<2>::kSmem, out + 14),
      occupancy(sdpa_packed_ws_kernel, kWsThreads, kSmem, out + 16)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
