// Building blocks of the TMA-fed `wgmma` GEMMs: the projection GEMMs
// (projection.cuh, for projection.cu and attn_fold_probe.cu), the FFN and
// conv-module fold probes (fold_probes.cu) and the conv2d-subsampling probes
// (subsampling_probe.cu), sm_90a.  A
// [64 * kWG, kBN] output tile of A [M, K] . B [K, N] with A read K-major and
// B, a row-major [in, out] weight, read MN-major (the transpose bit), both
// brought into shared memory by the Tensor Memory Accelerator (TMA) through
// a ring of kStages stages and multiplied with `wgmma`, one warpgroup per 64
// rows of the tile, fp32 accumulation.
//
// The ring (TmaRing).  Stage s has two barriers in shared memory: full[s]
// completes when the TMA copies of its tiles have landed (one arrival that
// announces the stage's bytes, then the copies' transaction bytes), empty[s]
// when every warp of the block has finished the products that read it.  One
// thread (thread 0) issues the copies: the first kStages items before the
// loop, then item i + kStages into stage s as soon as item i has left it.
// The copies of kStages - 1 items are in flight while the tensor cores work
// on one: the loads no longer take turns with the products, and no thread
// spends registers or instructions on addresses.  Every warp waits for and
// releases every item in order, also one whose tiles it does not read: a
// barrier's parity names one of two phases, so a warp that skipped a phase
// could mistake the phase before it for the one after.
//
// Tile layouts (the TMA box and the `wgmma` descriptor describe the same
// bytes; every box starts on a 1024-byte boundary):
//   * 128-byte swizzle, K-major (A of the QKV GEMM and of the fold probes'
//     products, K tile 64 = 128 bytes a row): 8-row atoms of 1024 bytes, the
//     16-byte chunk c of row r at chunk c ^ (r % 8).  Descriptor: stride
//     byte offset 1024 (between 8-row groups); k-step kk starts 32 kk bytes
//     in (the swizzle is applied to the address, so the step is a plain
//     offset); warpgroup w's 64 rows start 8192 w bytes in.
//   * 32-byte swizzle, K-major (A of the output GEMM: a head's 48 columns of
//     O, 96 bytes a row, as three boxes of 16 columns): each box is [rows,
//     32 bytes], 8-row atoms of 256 bytes; k-step kk is box kk.
//   * 128-byte swizzle, MN-major (B: 64 weight columns = 128 bytes a row of
//     the box, kBN / 64 boxes side by side): within a box 8-row atoms of
//     1024 bytes along K (stride byte offset 1024), the boxes one box apart
//     along N (leading byte offset); k-step kk starts 2048 kk bytes in.  A
//     product of N 32 reads half a box: it starts 64 bytes into the box's
//     rows, which, like the K-major k-step, leaves the address bits that
//     the swizzle reads untouched.
//   * 128-byte swizzle, K-major B (attn_fold_probe.cu's per-head weight
//     blocks laid out [48 rows of N, K]): the A layout with N in place of
//     the rows, boxes [48, 64], read without the transpose bit
//     (wgmma_ss_nt48).

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
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
__device__ __forceinline__ void wgmma_ss_tb<32>(float (&d)[16],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

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


// d[64, 48] += A[64, 16] . B[48, 16]^T: A and B both K-major tiles in shared
// memory (no transpose bit), as the attention-fold probe's per-head
// projection reads a head's weight block laid out [48, K]
__device__ __forceinline__ void wgmma_ss_nt48(float (&d)[24], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, "
      "%24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}


// The ring described above: kStages stages of kStageBytes from shared
// address `smem` (1024-aligned), with 2 kStages barriers full/empty in
// shared memory.  Items are numbered 0, 1, ...; item i lives in stage
// i % kStages.  issue(stage address, i, bar) starts item i's copies,
// completing on bar; only thread 0 issues.
template <int kStages, int kStageBytes>
struct TmaRing {
  uint32_t smem;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ uint32_t stage(int i) const {
    return smem + (i % kStages) * kStageBytes;
  }

  // thread 0, followed by a block barrier before any use: `warps` arrivals
  // (one per warp of the block) release a stage
  __device__ __forceinline__ void init(int warps) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), warps);
    }
    fence_mbar_init();
  }

  template <typename Issue>
  __device__ __forceinline__ void load(int i, Issue issue) const {
    const uint32_t bar = smem_u32(&full[i % kStages]);
    mbar_expect_tx(bar, kStageBytes);
    issue(stage(i), i, bar);
  }

  // thread 0: the first kStages of n items
  template <typename Issue>
  __device__ __forceinline__ void prime(int n, Issue issue) const {
    for (int i = 0; i < kStages && i < n; ++i) load(i, issue);
  }

  // every thread: item i has landed
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(smem_u32(&full[i % kStages]), (i / kStages) & 1);
  }

  // every thread, after its warp's last read of item i: the warp releases
  // the stage; thread 0 then refills it with item i + kStages of n
  template <typename Issue>
  __device__ __forceinline__ void release(int i, int n, Issue issue) const {
    const int s = i % kStages;
    if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(&empty[s]));
    if (threadIdx.x == 0 && i + kStages < n) {
      // every warp has left stage s
      mbar_wait(smem_u32(&empty[s]), (i / kStages) & 1);
      load(i + kStages, issue);
    }
  }
};

// The products of one output tile over n_k K tiles on a TmaRing.  Each
// stage is an A region of kABytes and then a B region; full/empty are
// 2 kStages barriers in shared memory.  issue(a, b, kt, bar) starts the
// copies of K tile kt to shared addresses a and b, completing on bar
// (thread 0 only); desc_a(a, kk) and desc_b(b, kk) give k-step kk's
// descriptors for this warpgroup.  acc is this warpgroup's [64, kBN] fp32
// accumulator fragment.
template <int kWG, int kBN, int kBK, int kStages, int kABytes, int kBBytes,
          typename Issue, typename DescA, typename DescB>
__device__ __forceinline__ void gemm_tma_ring(float (&acc)[kBN / 2],
                                              uint32_t smem, uint64_t* full,
                                              uint64_t* empty, int n_k,
                                              Issue issue, DescA desc_a,
                                              DescB desc_b) {
  const TmaRing<kStages, kABytes + kBBytes> ring{smem, full, empty};
  auto load = [&](uint32_t a, int kt, uint32_t bar) {
    issue(a, a + kABytes, kt, bar);
  };
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  if (threadIdx.x == 0) ring.init(4 * kWG);   // one arrival per warp
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(n_k, load);

  for (int kt = 0; kt < n_k; ++kt) {
    ring.wait(kt);
    const uint32_t a = ring.stage(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_tb<kBN>(acc, desc_a(a, kk), desc_b(a + kABytes, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    ring.release(kt, n_k, load);
  }
}

// bf16 pairs of this warpgroup's [64, kBN] tile, lo[j] of row g and hi[j]
// of row g + 8 at columns 8 j + 2 l, + 1 (the accumulator fragment's
// positions), handed out as whole 16-byte chunks: put(row of the
// warpgroup's 64, chunk of the tile's kBN / 8, value).  The quad's lanes
// trade pieces (quad_gather) so that each holds whole chunks.
template <int kBN, typename Put>
__device__ __forceinline__ void put_chunks(const uint32_t (&lo)[kBN / 8],
                                           const uint32_t (&hi)[kBN / 8],
                                           Put put) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < kBN / 32; ++r) {
    put(row, 4 * r + l,
        quad_gather(lo[4 * r], lo[4 * r + 1], lo[4 * r + 2], lo[4 * r + 3], l));
    put(row + 8, 4 * r + l,
        quad_gather(hi[4 * r], hi[4 * r + 1], hi[4 * r + 2], hi[4 * r + 3], l));
  }
}

// This warpgroup's [64, kBN] accumulator plus an fp32 bias (the tile's kBN
// columns), rounded to bf16 and handed out by put_chunks.
template <int kBN, typename Put>
__device__ __forceinline__ void store_tile_chunks(const float (&d)[kBN / 2],
                                                  const float* bias, Put put) {
  const int l = threadIdx.x & 3;
  uint32_t lo[kBN / 8], hi[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * l);
    lo[j] = pack_bf16(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
    hi[j] = pack_bf16(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
  }
  put_chunks<kBN>(lo, hi, put);
}

// ---------------------------------------------------------------------------
// rows of bf16 and fp32 in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(f[e]);
  return u;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// ---------------------------------------------------------------------------
// shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int kSmemAlign = 1024;   // swizzle atoms start on 1024 bytes

__device__ __forceinline__ uint32_t aligned_smem(unsigned char* smem) {
  return (smem_u32(smem) + kSmemAlign - 1) & ~uint32_t(kSmemAlign - 1);
}

// B: k-step kk of kBN / 64 MN-major boxes of [kBK rows, 64 columns]
template <int kBK>
__device__ __forceinline__ uint64_t weight_desc(uint32_t b, int kk) {
  return swizzled_desc(b + kk * 2048, kBK * 128, 1024, kSwizzle128);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link
// to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 tensor map of `rank` <= 5 dimensions (innermost first), byte
// strides of dimensions 1.., the box and its swizzle; false on failure.
// Boxes reaching past the tensor are zero-filled.
inline bool bf16_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [rows, cols] row-major, boxes [box_rows, 64 columns] with the 128 B swizzle
inline bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                       int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return bf16_map(map, base, 2, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int kMaxDevices = 64;

inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

inline int sm_count() {
  static int counts[kMaxDevices] = {};
  const int dev = current_device();
  if (dev >= kMaxDevices) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// Launches kKernel after opting it in to `smem` bytes of dynamic shared
// memory, once per device.
template <auto kKernel, typename Maps, typename Args>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t s,
                   const Maps& maps, const Args& args) {
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  kKernel<<<grid, threads, smem, s>>>(maps, args);
  return cudaGetLastError();
}

// out[0]: `smem`; out[1]: how many blocks of `kernel` one SM holds at a time
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  out[0] = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                       threads, smem);
}

}  // namespace gigaam
