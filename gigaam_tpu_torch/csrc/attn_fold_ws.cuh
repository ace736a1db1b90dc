// What the attention-fold redesign's two products share (attn_fold_ws.cu:
// P6 and P7; attn_lnres_ws.cu: P8's output product with the fp32 residual):
// the module's width, the four schedules of conv_ws.cuh's cores as the
// wrappers (probes/attn_fold_probes.py) name them, the output product's
// tensor maps and arguments, the cooperative core's share of a weight box,
// a ping-pong unit's products, and the launch of a kernel on either core.

#pragma once

#include "conv_ws.cuh"

namespace {

using namespace gigaam;

constexpr int kModel = 768;          // the module's width: 16 heads of 48
constexpr int kHeads = kModel / kD;
constexpr int kBK = 64;

// the schedules, as the wrappers (probes/attn_fold_probes.py) name them
enum Schedule {
  kLaneSlices = 0,     // ping-pong, 64 x 256 tiles in clusters of two, B
                       // multicast (P7 foldB, P6 nb 1, P8 nb 1)
  kHeadTiles = 1,      // ping-pong, 64 x 192 tiles, per-head Q/K blocks (foldA)
  kCoop = 2,           // WsCore, 128 x 256 tiles (P6 and P8 nb 2)
  kCoopCluster = 3,    // the same in clusters of two, B multicast (nb 4)
  kSchedules = 4
};

template <int kBN, int kCluster>
using PingPong = PingPongCore<kBN, kBN == 256 ? 5 : 6, kCluster>;
template <int kCluster>
using Coop = WsCore<256, kCluster, true>;

struct OutMaps {
  CUtensorMap a;       // o packed [M, 768]
  CUtensorMap b;       // Wo [768, 768] [in, out]
};

struct FoldArgs {
  const int4* units;   // the plan (conv_ws.cuh's units), n_units of them
  const float* bias[3];   // bq, bk, bv (the output product: bo)
  bf16* out[3];        // q, k, v [B, 16, T, 48] (the output product: [M, 768])
  int n_units, m, t;
};

// WsCore's share of B: whole boxes, rank kBoxes / kCluster .. of them
template <int kCluster>
__device__ __forceinline__ void load_b_coop(uint32_t sb,
                                            const CUtensorMap* map, int c0,
                                            int item, uint32_t bar,
                                            uint32_t rank) {
  constexpr int kMine = Coop<kCluster>::kBoxes / kCluster;
#pragma unroll
  for (int jj = 0; jj < kMine; ++jj) {
    const int j = rank * kMine + jj;
    if constexpr (kCluster == 1)
      tma_load_2d(sb + j * kBK * 128, map, c0 + 64 * j, item * kBK, bar);
    else
      tma_load_2d_multicast(sb + j * kBK * 128, map, c0 + 64 * j, item * kBK,
                            bar, 3);
  }
}

// the products of one K item of a ping-pong unit: B MN-major, or K-major
// (the per-head Q/K blocks)
template <int kBN, int kCluster, bool kKMajor>
__device__ __forceinline__ void mma_item(float (&acc)[kBN / 2], uint32_t sa,
                                         uint32_t sb) {
  using Core = PingPong<kBN, kCluster>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (kKMajor)
      wgmma_ss_tk<kBN>(acc, Core::a_desc(sa, kk),
                       swizzled_desc(sb + 32 * kk, 16, 1024, kSwizzle128));
    else
      wgmma_ss_tb<kBN>(acc, Core::a_desc(sa, kk), weight_desc<kBK>(sb, kk));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// kKernel, a kernel on Core, on `grid` blocks in clusters of kCluster with
// its arguments `args`
template <typename Core, int kCluster, auto kKernel, typename... Args>
cudaError_t launch_ws(int grid, cudaStream_t s, const Args&... args) {
  cudaError_t err = ws_opt_in<Core, kKernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<Core, kCluster>(grid, s,
                                                                  &attr);
  err = cudaLaunchKernelEx(&cfg, kKernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the rows of an A box and of a B box (MN-major: K rows; K-major: N rows)
// of each schedule
int a_box_rows(int schedule) {
  return schedule == kCoop || schedule == kCoopCluster ? 128 : 64;
}

int cluster_of(int schedule) {
  return schedule == kCoopCluster || schedule == kLaneSlices ? 2 : 1;
}

int mn_box_rows(int schedule) {
  // WsCore multicasts whole boxes; the ping-pong cores halves of each
  const bool coop = schedule == kCoop || schedule == kCoopCluster;
  return coop ? kBK : kBK / cluster_of(schedule);
}

}  // namespace
