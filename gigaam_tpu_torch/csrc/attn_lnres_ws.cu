// The output product of the attention-fold probe P8 redesigned for Hopper
// (sm_90a): attn_fold_ws.cu's output product (P6/P7) with the pre-LN
// residual added to the fp32 accumulator and rounded once.
//
// P8 replaces the Pallas probe benchmarks/pallas_attn_lnres_probe.py::
// lnres_folded (the body _lnres_kernel): K1's function, pre-LN x [B, T, 768]
// bf16 to x + attention(LN(x)), with bo and x added to the output product's
// fp32 accumulator before its one rounding.  attn_fold_probe.cu's four
// launches (K1/K2's TMA-ring GEMMs at 64 nb-row, N-128 tiles around K3) are
// kept for an A/B on the same card.  The redesign runs P6's four stages,
// with the same rounding points as the Pallas body:
//   projection.cu's ln_rope_kernel<true>
//                      xn = bf16(LN(x)) (fp32, eps 1e-5), xr = bf16(RoPE(xn))
//   attn_fold_ws.cu's fold_qkv_*_kernel
//                      q, k = bf16(xr Wq|Wk + bq|bk), v = bf16(xn Wv + bv),
//                      stored head-major [B, 16, T, 48]
//   attn_fold_ws.cu's sdpa_packed_ws_kernel
//                      o = P9's walk (K3's bits), stored packed [B T, 768]
//   lnres_out_*_kernel (here)
//                      out = bf16(o Wo + bo + float(x)), one rounding
// Rows are b T + t; rows past M are neither loaded (TMA fills zeros) nor
// stored.
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): K1's, 0.0554
// ms at B 16, T 500, by operations.
//
// P8's question, more rows a weight box, keeps P6's schedules (nb 1: the
// ping-pong core's 64 x 256 tiles in clusters of two with the weight boxes
// multicast; nb 2: WsCore's cooperative 128 x 256 tiles; nb 4: the same in
// clusters of two), so these kernels are P6's output kernels with another
// epilogue.  They are in a translation unit of their own, on the code they
// share with attn_fold_ws.cu (attn_fold_ws.cuh): a second kernel in a file
// has changed the first one's SASS (the head-group walk's), and P6/P7's
// kernels are held to theirs.
//
// The epilogue adds x's bf16 pairs to acc + bo in fp32 at the accumulator's
// positions (store_out_residual), every load before the first store.

#include "attn_fold_ws.cuh"

using namespace gigaam;

namespace {

// a bf16 pair (low half first) as two floats, exactly
__device__ __forceinline__ float2 widen(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" :: "l"(p));
}

// A warpgroup's [64, kBN] accumulator of rows r0 .., columns n0 ..: bf16(acc
// + bo + float(x)) stored into out [M, 768].  The thread's part of x's rows
// g and g + 8 (the accumulator fragment's rows) is asked for into L1 first,
// 16 bytes a lane and round; then x's bf16 pair at each accumulator
// position (columns 8 j + 2 l, + 1) is loaded as the position is reached
// and added to acc + bo in fp32.  With the accumulator live, x in
// registers any wider (16-byte chunks, moved to these positions within the
// quad) spilled.
template <int kBN>
__device__ __forceinline__ void store_out_residual(
    const float (&acc)[kBN / 2], const FoldArgs& a, const bf16* x, int r0,
    int n0) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const bf16* x_lo = x + (size_t)g * kModel + n0;
  const bf16* x_hi = x_lo + 8 * kModel;
  const bool in_lo = g < a.m, in_hi = g + 8 < a.m;
#pragma unroll
  for (int r = 0; r < kBN / 32; ++r) {
    if (in_lo) prefetch_l1(x_lo + 32 * r + 8 * l);
    if (in_hi) prefetch_l1(x_hi + 32 * r + 8 * l);
  }
  const float* bias = a.bias[0] + n0;
  uint32_t lo[kBN / 8], hi[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * l;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    const float2 fl = widen(
        in_lo ? *reinterpret_cast<const uint32_t*>(x_lo + col) : 0u);
    const float2 fh = widen(
        in_hi ? *reinterpret_cast<const uint32_t*>(x_hi + col) : 0u);
    lo[j] = pack_bf16((acc[4 * j] + bb.x) + fl.x,
                      (acc[4 * j + 1] + bb.y) + fl.y);
    hi[j] = pack_bf16((acc[4 * j + 2] + bb.x) + fh.x,
                      (acc[4 * j + 3] + bb.y) + fh.y);
  }
  bf16* out = a.out[0];
  put_chunks<kBN>(lo, hi, [&](int r, int chunk, uint4 val) {
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

template <int kBN, int kCluster>
__global__ void __launch_bounds__(PingPong<kBN, kCluster>::kThreads, 1)
lnres_out_pp_kernel(const __grid_constant__ OutMaps maps,
                    const __grid_constant__ FoldArgs a, const bf16* x) {
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
        store_out_residual<kBN>(acc, a, x, unit.x * Core::kBM,
                                unit_col(unit) * kBN);
      });
}

template <int kCluster>
__global__ void __launch_bounds__(Coop<kCluster>::kThreads, 1)
lnres_out_coop_kernel(const __grid_constant__ OutMaps maps,
                      const __grid_constant__ FoldArgs a, const bf16* x) {
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
        store_out_residual<256>(
            acc, a, x, unit.x * Core::kBM + (threadIdx.x / 128) * 64,
            unit_col(unit) * 256);
      });
}

}  // namespace

extern "C" {

// P8's output product of schedule `schedule` (0: 64 x 256 ping-pong in
// clusters of two; 2: 128 x 256 cooperative; 3: the same in clusters of
// two; attn_fold_ws.cu's schedules, of which P8 takes these three): out
// [M, 768] = bf16(o . wo + bo + x), o packed [M, 768] bf16 (head h at
// columns 48 h ..), wo [768, 768] bf16 [in, out], bo [768] fp32, x [M, 768]
// bf16 (the pre-LN input); units: the plan (probes/ws_plan.py: ws_plan with
// one K split, in the schedule's row tiles and cluster), n_units int4 on
// the card; grid blocks (a multiple of the cluster).  Every pointer 16-byte
// aligned.  Returns cudaErrorInvalidValue for arguments or tensor maps it
// cannot take, else the first CUDA error of the opt-in and the launch.
int gigaam_lnres_ws_out(const void* o, const void* wo, const void* bo,
                        const void* x, void* out, const void* units,
                        int n_units, int grid, int m, int schedule,
                        void* stream) {
  if (m < 1 || n_units < 1 || grid < 1 || schedule < 0 ||
      schedule >= kSchedules || schedule == kHeadTiles ||
      grid % cluster_of(schedule))
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
  const bf16* xx = static_cast<const bf16*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case kLaneSlices:
      return static_cast<int>(launch_ws<PingPong<256, 2>, 2,
                              lnres_out_pp_kernel<256, 2>>(grid, s, maps, a,
                                                           xx));
    case kCoop:
      return static_cast<int>(launch_ws<Coop<1>, 1, lnres_out_coop_kernel<1>>(
          grid, s, maps, a, xx));
    default:
      return static_cast<int>(launch_ws<Coop<2>, 2, lnres_out_coop_kernel<2>>(
          grid, s, maps, a, xx));
  }
}

// For lnres_out_pp_kernel<256, 2>, lnres_out_coop_kernel<1>, <2>: out[2 i]
// the dynamic shared memory in bytes, out[2 i + 1] how many blocks one SM
// holds at a time.  Returns a CUDA error code.
int gigaam_attn_lnres_ws_occupancy(int* out) {
  const cudaError_t errs[] = {
      occupancy(lnres_out_pp_kernel<256, 2>, PingPong<256, 2>::kThreads,
                PingPong<256, 2>::kSmem, out),
      occupancy(lnres_out_coop_kernel<1>, Coop<1>::kThreads, Coop<1>::kSmem,
                out + 2),
      occupancy(lnres_out_coop_kernel<2>, Coop<2>::kThreads, Coop<2>::kSmem,
                out + 4)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
