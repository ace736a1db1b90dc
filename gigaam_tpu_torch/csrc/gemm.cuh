// Building blocks of the projection GEMMs (projection.cu, sm_90a): a
// [64 * kWG, kBN] output tile of A [M, K] . B [K, N] with A read K-major and
// B, a row-major [in, out] weight, read MN-major (the transpose bit), both
// brought into shared memory by the Tensor Memory Accelerator (TMA) through a
// ring of kStages stages and multiplied with `wgmma`, one warpgroup per 64
// rows of the tile, fp32 accumulation.
//
// The ring.  Stage s has two barriers in shared memory: full[s] completes
// when the TMA copies of its tiles have landed (one arrival that announces
// the stage's bytes, then the copies' transaction bytes), empty[s] when
// every warp of the block has finished the products that read it.  One
// thread (thread 0) issues the copies: the first kStages K tiles before the
// loop, then K tile kt + kStages into stage s as soon as K tile kt has left
// it.  The copies of kStages - 1 tiles are in flight while the tensor cores
// work on one: the loads no longer take turns with the products, and no
// thread spends registers or instructions on addresses.
//
// Tile layouts (the TMA box and the `wgmma` descriptor describe the same
// bytes; every box starts on a 1024-byte boundary):
//   * 128-byte swizzle, K-major (A of the QKV GEMM, K tile 64 = 128 bytes a
//     row): 8-row atoms of 1024 bytes, the 16-byte chunk c of row r at
//     chunk c ^ (r % 8).  Descriptor: stride byte offset 1024 (between 8-row
//     groups); k-step kk starts 32 kk bytes in (the swizzle is applied to
//     the address, so the step is a plain offset); warpgroup w's 64 rows
//     start 8192 w bytes in.
//   * 32-byte swizzle, K-major (A of the output GEMM: a head's 48 columns of
//     O, 96 bytes a row, as three boxes of 16 columns): each box is [rows,
//     32 bytes], 8-row atoms of 256 bytes; k-step kk is box kk.
//   * 128-byte swizzle, MN-major (B: 64 weight columns = 128 bytes a row of
//     the box, kBN / 64 boxes side by side): within a box 8-row atoms of
//     1024 bytes along K (stride byte offset 1024), the boxes one box apart
//     along N (leading byte offset); k-step kk starts 2048 kk bytes in.

#pragma once

#include <cuda.h>

#include "wgmma.cuh"

namespace gigaam {

// ---------------------------------------------------------------------------
// barriers and bulk tensor copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (the TMA unit)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// the box of `map` at coordinates (c0, c1[, c2]) to shared address `dst`,
// completing `bar`'s transaction bytes; `map` is a __grid_constant__ kernel
// parameter
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma on swizzled tiles
// ---------------------------------------------------------------------------


enum Swizzle : uint64_t { kSwizzle128 = 1, kSwizzle32 = 3 };

// shared-memory matrix descriptor of a swizzled tile: address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (bits 62-63)
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr,
                                                  int leading_bytes,
                                                  int stride_bytes,
                                                  Swizzle mode) {
  return smem_desc(addr, leading_bytes, stride_bytes)
         | (static_cast<uint64_t>(mode) << 62);
}

// d[64, N] += A[64, 16] . B[16, N]: A a K-major tile, B an MN-major tile
// (the transpose bit set), both in shared memory
template <int kN>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[kN / 2],
                                            uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss_tb<64>(float (&d)[32],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_tb<128>(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


// The products of one output tile over n_k K tiles: the TMA ring described
// above.  `smem` (1024-aligned) holds kStages stages of kStageBytes, each an
// A region of kABytes and then a B region; full/empty are 2 kStages barriers
// in shared memory.  issue(a, b, kt, bar) starts the copies of K tile kt to
// shared addresses a and b, completing on bar (thread 0 only);
// desc_a(a, kk) and desc_b(b, kk) give k-step kk's descriptors for this
// warpgroup.  acc is this warpgroup's [64, kBN] fp32 accumulator fragment.
template <int kWG, int kBN, int kBK, int kStages, int kABytes, int kBBytes,
          typename Issue, typename DescA, typename DescB>
__device__ __forceinline__ void gemm_tma_ring(float (&acc)[kBN / 2],
                                              uint32_t smem, uint64_t* full,
                                              uint64_t* empty, int n_k,
                                              Issue issue, DescA desc_a,
                                              DescB desc_b) {
  constexpr int kStageBytes = kABytes + kBBytes;
  const bool leader = threadIdx.x == 0;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  if (leader) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * kWG);   // one arrival per warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  auto load = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t a = smem + s * kStageBytes, bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, kStageBytes);
    issue(a, a + kABytes, kt, bar);
  };
  if (leader)
    for (int kt = 0; kt < kStages && kt < n_k; ++kt) load(kt);

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    mbar_wait(smem_u32(&full[s]), parity);
    const uint32_t a = smem + s * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_tb<kBN>(acc, desc_a(a, kk), desc_b(a + kABytes, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(&empty[s]));
    if (leader && kt + kStages < n_k) {
      mbar_wait(smem_u32(&empty[s]), parity);   // every warp has left stage s
      load(kt + kStages);
    }
  }
}

// This warpgroup's [64, kBN] accumulator plus an fp32 bias (the tile's kBN
// columns), rounded to bf16 and handed out as whole 16-byte chunks:
// put(row of the warpgroup's 64, chunk of the tile's kBN / 8, value).  The
// quad's lanes trade pieces (quad_gather) so that each holds whole chunks.
template <int kBN, typename Put>
__device__ __forceinline__ void store_tile_chunks(const float (&d)[kBN / 2],
                                                  const float* bias, Put put) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  uint32_t lo[kBN / 8], hi[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * l);
    lo[j] = pack_bf16(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
    hi[j] = pack_bf16(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
  }
#pragma unroll
  for (int r = 0; r < kBN / 32; ++r) {
    put(row, 4 * r + l,
        quad_gather(lo[4 * r], lo[4 * r + 1], lo[4 * r + 2], lo[4 * r + 3], l));
    put(row + 8, 4 * r + l,
        quad_gather(hi[4 * r], hi[4 * r + 1], hi[4 * r + 2], hi[4 * r + 3], l));
  }
}

}  // namespace gigaam
