// A warp-specialised, persistent implicit-GEMM core for Hopper (sm_90a):
// the redesign of the conv2d-subsampling probes P1 and P2
// (subsampling_ws.cu).  gemm.cuh's ring (TmaRing, gemm_tma_ring) stays as
// it is for the kernels built on it; this header adds what it does not
// have, on the same barriers, tensor maps and tile layouts.
//
// What held the ring back on the stage-2 conv, and what the core does:
//   * Thread 0 of the first consumer warpgroup issued the refills, after
//     waiting for every warp of the block on the stage's `empty` barrier.
//     Here one producer warpgroup (its registers lowered to 40 with
//     `setmaxnreg`) only waits on `empty` and issues TMA copies, one thread
//     of it; two consumer warpgroups (raised to 232) only wait on `full`,
//     multiply and release.
//   * A consumer waited for each K item's products (wait_group 0) before
//     it released the stage, so the tensor cores drained at every item.
//     Here it issues item i's `wgmma`s, waits with wait_group 1 (item
//     i - 1 done) and releases item i - 1's stage: one item's products are
//     always in flight.
//   * 128 x 128 tiles with three 32 KB stages: 64 operations a byte of L2.
//     Here 128 x 256 tiles (each consumer warpgroup m64n256k16, 128 fp32
//     accumulators a thread) and four stages of A 16 KB + B 32 KB (192 KB,
//     one block an SM): 85 operations a byte.
//   * One block a tile.  Here the grid is one block an SM and each block
//     walks a static list of work units: unit u runs on block u % grid.
//     The list (a device table of int4 {row tile, column tile | split <<
//     16, first K item, K items}) is the caller's plan: it orders the
//     column tiles of one row tile next to each other, so that they run at
//     the same time and read that row tile's A boxes from L2 once between
//     them, and it splits K where the tiles do not fill the card.  The
//     producer runs ahead into the next unit while the consumers store the
//     last one: one tile's epilogue overlaps the next one's loads.
//   * kCluster 2: two blocks of a cluster take partner units (the same
//     column tile and K range, neighbouring row tiles) and each issues half
//     of the B (weight) boxes with TMA multicast to both, which halves the
//     weights' L2 reads.  A stage is free when the consumers of both
//     blocks have released it (each consumer warp arrives on both blocks'
//     `empty` barrier), and the producer waits at the end until every
//     stage is free, so that no block leaves while its partner may still
//     arrive on its barriers.
//   * Where the plan splits K, the splits' fp32 partials go to device
//     memory and a second pass sums them.
//
// Item `it` (counted over all units of the block, in the same order by the
// producer and the consumers) lives in stage it % kStages; its barriers'
// phase is (it / kStages) & 1.  The producer waits on `empty` with the
// other parity, which a fresh barrier passes at once.
//
// PingPongCore (below) is the same producer and ring on the "ping-pong"
// schedule, for products whose K is short (the attention fold's K 768 in
// attn_fold_ws.cu: 12 items a tile), where WsCore's two consumers, sharing
// each tile, run their epilogue at once while the tensor cores idle: there
// each consumer owns whole 64-row tiles and the two take turns on the
// tensor cores.  WsCore::run_loads lets the caller issue every copy, so a
// product can read its B from one of several weights by column tile.

#pragma once

#include "gemm.cuh"

namespace gigaam {

// d[64, 256] += A[64, 16] . B[16, 256]: A a K-major tile, B MN-major (the
// transpose bit set), both in shared memory
template <>
__device__ __forceinline__ void wgmma_ss_tb<256>(float (&d)[128],
                                               uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64, 192] += A[64, 16] . B[16, 192]: A a K-major tile, B MN-major (the
// transpose bit set), both in shared memory
template <>
__device__ __forceinline__ void wgmma_ss_tb<192>(float (&d)[96],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64, N] += A[64, 16] . B[N, 16]^T: A and B both K-major tiles in shared
// memory (no transpose bit), B a weight laid out [N, K]
template <int kN>
__device__ __forceinline__ void wgmma_ss_tk(float (&d)[kN / 2],
                                            uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss_tk<192>(float (&d)[96],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// waits until at most kPending of this warpgroup's committed `wgmma`
// groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// a warpgroup's register budget a thread, lowered or raised (every warp of
// the warpgroup executes it)
template <int kRegs>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---------------------------------------------------------------------------
// clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address, in block `rank` of the cluster, of this
// block's shared address `addr`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// one arrival on a barrier of any block of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(cluster_bar) : "memory");
}

// tma_load_2d to the same shared address and barrier in every block of
// `mask` (bit r: block r of the cluster)
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      int c0, int c1,
                                                      uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar), "h"(mask) : "memory");
}

// ---------------------------------------------------------------------------
// the core
// ---------------------------------------------------------------------------

// A work unit of the caller's plan: x the row tile, y the column tile in
// bits 0-15 and the K split (the partial's slot) above, z the first K item,
// w the number of K items (at least one).
__device__ __forceinline__ int unit_col(int4 unit) { return unit.y & 0xffff; }
__device__ __forceinline__ int unit_split(int4 unit) { return unit.y >> 16; }

// [128, kBN] output tiles of A [M, K] . B [K, N] over K items of 64, A
// K-major and B MN-major, both by TMA with the 128-byte swizzle (gemm.cuh's
// layouts); kCluster blocks (1 or 2) share each B box by multicast;
// kInflight keeps one item's products in flight (else each item is waited
// for before its stage is released, the ring's order).
template <int kBN, int kCluster, bool kInflight>
struct WsCore {
  static constexpr int kWarpgroup = 128;
  static constexpr int kBM = 128, kBK = 64, kStages = 4;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + kSmemAlign;
  static constexpr int kConsumers = 2;                 // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
  static constexpr int kBoxes = kBN / 64;              // B boxes a stage
  static constexpr int kBoxBytes = kBK * 128;
  // arrivals that free a stage: every consumer warp of every block
  static constexpr int kReleases = 4 * kConsumers * kCluster;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(kBoxes % kCluster == 0, "B boxes split over the cluster");

  // k-step kk of this consumer warpgroup's 64 rows of the [128, 64] A tile
  static __device__ __forceinline__ uint64_t a_desc(uint32_t sa, int kk) {
    const int wg = threadIdx.x / kWarpgroup;
    return swizzled_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024, kSwizzle128);
  }

  // Every thread of the block.  full/empty: kStages barriers each in
  // static shared memory; smem_raw: kSmem bytes of dynamic shared memory.
  // issue_a(unit, item, a, bar) starts the copy of the unit's A tile of K
  // item `item` to shared address a (kABytes, completing on bar);
  // epilogue(acc, unit) stores a consumer warpgroup's [64, kBN] fp32
  // accumulator fragment (rows 64 * warpgroup ..) of the unit's tile.
  template <typename IssueA, typename Epilogue>
  static __device__ __forceinline__ void run(unsigned char* smem_raw,
                                             uint64_t* full, uint64_t* empty,
                                             const int4* units, int n_units,
                                             const CUtensorMap* b_map,
                                             IssueA issue_a,
                                             Epilogue epilogue) {
    const uint32_t smem = aligned_smem(smem_raw);
    const uint32_t full0 = smem_u32(full), empty0 = smem_u32(empty);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, kReleases);
      }
      fence_mbar_init();
    }
    // the partner's barriers are initialised before anyone multicasts
    if constexpr (kCluster > 1) cluster_sync(); else __syncthreads();

    if (threadIdx.x / kWarpgroup == kConsumers) {
      regs_release<kProducerRegs>();
      if (threadIdx.x == kConsumers * kWarpgroup)
        produce(smem, full0, empty0, units, n_units, b_map, issue_a);
    } else {
      regs_claim<kConsumerRegs>();
      consume(smem, full0, empty0, units, n_units, epilogue);
    }
  }

  // run() with the caller issuing every copy of an item: issue(unit, item,
  // sa, sb, bar, rank) starts the unit's A tile of K item `item` at sa and
  // this block's share of its B boxes at sb (all kBoxes with kCluster 1,
  // else boxes rank * kBoxes / kCluster .. multicast to the cluster),
  // completing on bar: for a product whose B comes from one of several
  // weights by column tile (attn_fold_ws.cu's Q/K/V product).
  template <typename Issue, typename Epilogue>
  static __device__ __forceinline__ void run_loads(unsigned char* smem_raw,
                                                   uint64_t* full,
                                                   uint64_t* empty,
                                                   const int4* units,
                                                   int n_units, Issue issue,
                                                   Epilogue epilogue) {
    const uint32_t smem = aligned_smem(smem_raw);
    const uint32_t full0 = smem_u32(full), empty0 = smem_u32(empty);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, kReleases);
      }
      fence_mbar_init();
    }
    if constexpr (kCluster > 1) cluster_sync(); else __syncthreads();

    if (threadIdx.x / kWarpgroup == kConsumers) {
      regs_release<kProducerRegs>();
      if (threadIdx.x == kConsumers * kWarpgroup)
        produce_loads(smem, full0, empty0, units, n_units, issue);
    } else {
      regs_claim<kConsumerRegs>();
      consume(smem, full0, empty0, units, n_units, epilogue);
    }
  }

  template <typename Issue>
  static __device__ __forceinline__ void produce_loads(uint32_t smem,
                                                       uint32_t full0,
                                                       uint32_t empty0,
                                                       const int4* units,
                                                       int n_units,
                                                       Issue issue) {
    const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int4 unit = units[u];
      for (int k = 0; k < unit.w; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        const uint32_t sa = smem + s * kStageBytes;
        mbar_expect_tx(bar, kStageBytes);
        issue(unit, unit.z + k, sa, sa + kABytes, bar, rank);
      }
    }
    if constexpr (kCluster > 1) {
      for (int j = 0; j < kStages; ++j, ++it)
        mbar_wait(empty0 + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
    }
  }

  template <typename IssueA>
  static __device__ __forceinline__ void produce(uint32_t smem,
                                                 uint32_t full0,
                                                 uint32_t empty0,
                                                 const int4* units,
                                                 int n_units,
                                                 const CUtensorMap* b_map,
                                                 IssueA issue_a) {
    const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int4 unit = units[u];
      const int n0 = unit_col(unit) * kBN;
      for (int k = 0; k < unit.w; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        const uint32_t sa = smem + s * kStageBytes, sb = sa + kABytes;
        const int item = unit.z + k;
        // this block's A and all of B land here (half of B from the
        // partner's multicast)
        mbar_expect_tx(bar, kStageBytes);
        issue_a(unit, item, sa, bar);
        if constexpr (kCluster == 1) {
#pragma unroll
          for (int j = 0; j < kBoxes; ++j)
            tma_load_2d(sb + j * kBoxBytes, b_map, n0 + 64 * j, item * kBK,
                        bar);
        } else {
          constexpr int kMine = kBoxes / kCluster;
#pragma unroll
          for (int jj = 0; jj < kMine; ++jj) {
            const int j = rank * kMine + jj;
            tma_load_2d_multicast(sb + j * kBoxBytes, b_map, n0 + 64 * j,
                                  item * kBK, bar,
                                  static_cast<uint16_t>((1 << kCluster) - 1));
          }
        }
      }
    }
    // the partner's consumers have released every stage of this block
    if constexpr (kCluster > 1) {
      for (int j = 0; j < kStages; ++j, ++it)
        mbar_wait(empty0 + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
    }
  }

  // this warp's release of item j's stage, in every block of the cluster
  static __device__ __forceinline__ void release(uint32_t empty0, int j) {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t bar = empty0 + 8 * (j % kStages);
      if constexpr (kCluster == 1) {
        mbar_arrive(bar);
      } else {
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          mbar_arrive_cluster(cluster_addr(bar, r));
      }
    }
  }

  template <typename Epilogue>
  static __device__ __forceinline__ void consume(uint32_t smem,
                                                 uint32_t full0,
                                                 uint32_t empty0,
                                                 const int4* units,
                                                 int n_units,
                                                 Epilogue epilogue) {
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int4 unit = units[u];
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < unit.w; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t sa = smem + s * kStageBytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss_tb<kBN>(acc, a_desc(sa, kk),
                           weight_desc<kBK>(sa + kABytes, kk));
        wgmma_commit();
        if constexpr (kInflight) {
          wgmma_wait<1>();          // item it - 1's products are done
          if (k > 0) release(empty0, it - 1);
        } else {
          wgmma_wait<0>();
          release(empty0, it);
        }
      }
      if constexpr (kInflight) {
        wgmma_wait<0>();
        release(empty0, it - 1);
      }
      fence_regs(acc);
      epilogue(acc, unit);
    }
  }
};

// ---------------------------------------------------------------------------
// the ping-pong schedule
// ---------------------------------------------------------------------------

// named barrier `id` (0 is __syncthreads'): wait for `threads` arrivals,
// this warp's included, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// [64, kBN] output tiles of A [M, K] . B over K items of 64 on the Hopper
// "ping-pong" schedule.  In WsCore the two consumer warpgroups share each
// 128-row tile, so both run their epilogue at once while the tensor cores
// idle; here each consumer owns whole 64-row tiles:
//   * unit i of a block (in plan order, unit u on block u % grid) is
//     consumer i % 2's, and the producer fills one ring of kStages stages
//     in unit order (a stage is freed by the four warps of the consumer
//     that reads it);
//   * two named barriers make the consumers' main loops take turns: a
//     consumer issues unit i's products only after its partner has issued
//     all of unit i - 1's, and hands the turn on as soon as it has issued
//     its own last ones, so one consumer's epilogue (bias, rounding,
//     stores) runs while the other's products hold the tensor cores;
//   * kCluster 2: the two blocks of a cluster take partner units (the same
//     column tile and K range, neighbouring row tiles, in the same order:
//     probes/ws_plan.py::ws_plan, K unsplit) and each loads half of every B box
//     with multicast to both; a stage is free when the owning consumers of
//     both blocks have released it, and the producer waits for every stage
//     before it leaves.
// The caller supplies the copies, issue(unit, item, sa, sb, bar, rank) (the
// unit's A tile at sa, this block's share of the B tile at sb, completing
// on bar), the products of one K item, mma(acc, sa, sb, unit) (kBK / 16
// `wgmma`s, fenced and committed here), and the epilogue(acc, unit) of a
// consumer's [64, kBN] fp32 accumulator fragment.
template <int kBN, int kStageCount, int kCluster>
struct PingPongCore {
  static constexpr int kWarpgroup = 128;
  static constexpr int kBM = 64, kBK = 64, kStages = kStageCount;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + kSmemAlign;
  static constexpr int kConsumers = 2;                 // warpgroups
  static constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
  static constexpr int kReleases = 4 * kCluster;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  // consumer c waits on named barrier kTurn + c; both consumers take part
  static constexpr int kTurn = 1, kTurnThreads = kConsumers * kWarpgroup;
  static_assert(kSmem <= 232448 - 1024, "one block an SM");

  // k-step kk of the [64, 64] K-major A tile
  static __device__ __forceinline__ uint64_t a_desc(uint32_t sa, int kk) {
    return swizzled_desc(sa + kk * 32, 16, 1024, kSwizzle128);
  }

  // Every thread of the block; full/empty: kStages barriers each in static
  // shared memory; smem_raw: kSmem bytes of dynamic shared memory.
  template <typename Issue, typename Mma, typename Epilogue>
  static __device__ __forceinline__ void run(unsigned char* smem_raw,
                                             uint64_t* full, uint64_t* empty,
                                             const int4* units, int n_units,
                                             Issue issue, Mma mma,
                                             Epilogue epilogue) {
    const uint32_t smem = aligned_smem(smem_raw);
    const uint32_t full0 = smem_u32(full), empty0 = smem_u32(empty);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, kReleases);
      }
      fence_mbar_init();
    }
    if constexpr (kCluster > 1) cluster_sync(); else __syncthreads();

    const int wg = threadIdx.x / kWarpgroup;
    if (wg == kConsumers) {
      regs_release<kProducerRegs>();
      if (threadIdx.x == kConsumers * kWarpgroup)
        produce(smem, full0, empty0, units, n_units, issue);
    } else {
      regs_claim<kConsumerRegs>();
      consume(smem, full0, empty0, units, n_units, wg, mma, epilogue);
    }
  }

  template <typename Issue>
  static __device__ __forceinline__ void produce(uint32_t smem,
                                                 uint32_t full0,
                                                 uint32_t empty0,
                                                 const int4* units,
                                                 int n_units, Issue issue) {
    const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int4 unit = units[u];
      for (int k = 0; k < unit.w; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        const uint32_t sa = smem + s * kStageBytes;
        mbar_expect_tx(bar, kStageBytes);
        issue(unit, unit.z + k, sa, sa + kABytes, bar, rank);
      }
    }
    // the partner's consumers have released every stage of this block
    if constexpr (kCluster > 1) {
      for (int j = 0; j < kStages; ++j, ++it)
        mbar_wait(empty0 + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);
    }
  }

  // this warp's release of item j's stage, in every block of the cluster
  static __device__ __forceinline__ void release(uint32_t empty0, int j) {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t bar = empty0 + 8 * (j % kStages);
      if constexpr (kCluster == 1) {
        mbar_arrive(bar);
      } else {
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          mbar_arrive_cluster(cluster_addr(bar, r));
      }
    }
  }

  // Consumer warpgroup c: the block's units i with i % 2 == c, each a main
  // loop in its turn (one K item's products in flight, as WsCore's), then
  // the epilogue under the partner's main loop.  Every barrier wait has an
  // arrival to match: consumer 1 opens consumer 0's first turn, and a
  // consumer hands the turn on only where the block has a next unit.
  template <typename Mma, typename Epilogue>
  static __device__ __forceinline__ void consume(uint32_t smem,
                                                 uint32_t full0,
                                                 uint32_t empty0,
                                                 const int4* units,
                                                 int n_units, int c, Mma mma,
                                                 Epilogue epilogue) {
    if (c == 1) named_arrive(kTurn, kTurnThreads);
    int it = 0, i = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++i) {
      const int4 unit = units[u];
      if ((i & 1) != c) {          // the partner's unit: its items
        it += unit.w;
        continue;
      }
      float acc[kBN / 2];
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.f;
      named_sync(kTurn + c, kTurnThreads);
      for (int k = 0; k < unit.w; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t sa = smem + s * kStageBytes;
        fence_regs(acc);
        wgmma_fence();
        mma(acc, sa, sa + kABytes, unit);
        wgmma_commit();
        wgmma_wait<1>();            // item it - 1's products are done
        if (k > 0) release(empty0, it - 1);
      }
      // every product of the unit is issued: the partner's turn
      if (u + static_cast<int>(gridDim.x) < n_units)
        named_arrive(kTurn + (c ^ 1), kTurnThreads);
      wgmma_wait<0>();
      release(empty0, it - 1);
      fence_regs(acc);
      epilogue(acc, unit);
    }
  }
};

// A ping-pong block's share of the MN-major B tile [64 K rows, kBN columns]
// of weight columns c0 .. at K item `item`: kBN / 64 boxes of [64, 64], or
// in a cluster the K rows 64 / kCluster rank .. of each box, multicast to
// the cluster (each part keeps the box's 128-byte swizzle: the parts start
// on 1024-byte boundaries)
template <int kBN, int kCluster>
__device__ __forceinline__ void load_b_mn(uint32_t sb, const CUtensorMap* map,
                                          int c0, int item, uint32_t bar,
                                          uint32_t rank) {
  constexpr int kBK = 64, kRows = kBK / kCluster;
#pragma unroll
  for (int j = 0; j < kBN / 64; ++j) {
    if constexpr (kCluster == 1)
      tma_load_2d(sb + j * kBK * 128, map, c0 + 64 * j, item * kBK, bar);
    else
      tma_load_2d_multicast(sb + j * kBK * 128 + rank * kRows * 128, map,
                            c0 + 64 * j, item * kBK + rank * kRows, bar,
                            (1 << kCluster) - 1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Opts kKernel, a kernel on Core, in to Core::kSmem bytes of dynamic shared
// memory, once per device.
template <typename Core, auto kKernel>
cudaError_t ws_opt_in() {
  static bool done[kMaxDevices] = {};
  const int dev = current_device();
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Core::kSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// A launch of `grid` blocks of a kernel on Core, in clusters of kCluster
// (*attr holds the cluster attribute the configuration points at)
template <typename Core, int kCluster>
cudaLaunchConfig_t ws_launch_config(int grid, cudaStream_t s,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(Core::kThreads);
  cfg.dynamicSmemBytes = Core::kSmem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;
  return cfg;
}

}  // namespace gigaam
