// Building blocks shared by attention.cu and attention_bwd.cu (sm_90a):
// the shared-memory tile layout that `wgmma` reads, asynchronous tile
// loads, the warpgroup matrix products, and the accumulator-fragment store.
//
// Tile layout.  A tile is 64 rows (queries or keys) of d_h = 48 bf16, 96
// bytes a row.  96 is no swizzle width (32, 64 or 128 bytes), and padding
// the rows to 128 would cost a third more work in every product over d_h, so
// the tiles use the no-swizzle "core matrix" layout instead: a core matrix
// is 8 rows x 16 bytes, stored as 128 contiguous bytes; the six core
// matrices of an 8-row group follow each other (768 bytes), and the eight
// groups of a tile follow each other (6144 bytes):
//
//   byte offset of (row r, 16-byte chunk c) = (r / 8) * 768 + c * 128
//                                             + (r % 8) * 16
//
// One such tile serves both operand roles without a second copy:
//   * "K-major" (the product contracts over d_h: S = Q.K^T, dP = dO.V^T and
//     their transposes): 8-row groups are 768 bytes apart (stride byte
//     offset), the two core matrices of a k-step of 16 are 128 bytes apart
//     (leading byte offset), and k-step kk starts 256 * kk bytes in.
//   * "MN-major" (the product contracts over the rows: P.V, ds.K, P^T.dO,
//     ds^T.Q; the transpose bit of the instruction): the two 8-row groups of
//     a k-step of 16 rows are 768 bytes apart (leading byte offset), the six
//     8-column groups of N = 48 are 128 bytes apart (stride byte offset),
//     and k-step kk starts 1536 * kk bytes in.
// Every core matrix is 128 contiguous bytes, so neither the loads nor the
// tensor cores meet a bank conflict.
//
// Loads.  Thread i of the block's 128 copies the 16-byte chunks i, i + 128,
// i + 256 of the tile's 384 with `cp.async`; chunk n lands at byte 16 * n,
// which the formula above turns into row 8 * (n / 48) + n % 8 and chunk
// (n / 8) % 6: eight neighbouring threads fill one core matrix (128
// contiguous bytes of shared memory) from eight rows of device memory, and a
// warp reads whole 32-byte sectors.  Rows past T are zero-filled (source size
// 0).  `cp.async` writes through the generic proxy and `wgmma` reads through
// the async proxy, so each thread runs `fence.proxy.async` between its
// `cp.async.wait_group` and the block barrier that publishes the tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gigaam {

typedef __nv_bfloat16 bf16;

constexpr int kD = 48;               // head dim
constexpr int kTile = 64;            // rows (queries or keys) per tile
constexpr int kThreads = 128;        // one warpgroup
constexpr int kChunks = kD / 8;      // 16-byte chunks per row
constexpr int kCoreBytes = 128;      // one core matrix: 8 rows x 16 bytes
constexpr int kGroupBytes = kChunks * kCoreBytes;        // an 8-row group
constexpr int kTileBytes = (kTile / 8) * kGroupBytes;    // 6144
constexpr int kStepKMajor = 2 * kCoreBytes;              // k-step over d_h
constexpr int kStepMnMajor = 2 * kGroupBytes;            // k-step over rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the additive key mask (mask - 1) * 1e9, in the base-2 exponent's units
constexpr float kMaskedScore2 = -1e9f * kLog2e;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a [T, 48] matrix into a tile at shared address
// `tile`, zero past T
__device__ __forceinline__ void load_tile_async(uint32_t tile, const bf16* src,
                                                int row0, int t) {
#pragma unroll
  for (int n = threadIdx.x; n < kTile * kChunks; n += kThreads) {
    const int group = n / 8;
    const int row = row0 + 8 * (group / kChunks) + n % 8;
    const int chunk = group % kChunks;
    const bool in = row < t;
    cp_async_16(tile + 16 * n,
                src + (size_t)(in ? row : 0) * kD + chunk * 8, in ? 16 : 0);
  }
}

// Top of a ring iteration: this thread's copies of the oldest pending tile
// have landed (all but the kStages - 2 newest groups), they are published to
// the async proxy, and after the barrier the tile is whole for every thread,
// while the stage consumed one iteration ago is free to be refilled.
template <int kStages>
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
}

// the additive mask of key j in base-2 units: 0 for a valid key, -1e9 *
// log2(e) for a masked one (its P is exactly 0 beside any valid key), -inf
// past T
__device__ __forceinline__ float key_mask2(const uint8_t* valid_row, int j,
                                           int t) {
  return j < t ? (valid_row[j] ? 0.f : kMaskedScore2) : -INFINITY;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, no swizzle: address, leading and stride
// byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int leading_bytes,
                                              int stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(leading_bytes >> 4) << 16)
         | (static_cast<uint64_t>(stride_bytes >> 4) << 32);
}

// k-step kk of a tile read K-major (contraction over d_h)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * kStepKMajor, kCoreBytes, kGroupBytes);
}

// k-step kk of a tile read MN-major (contraction over the tile's rows)
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * kStepMnMajor, kGroupBytes, kCoreBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of an accumulator across the
// asynchronous product that writes it
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64, 64] (+)= A[64, 16] . B[64, 16]^T, both K-major tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64, 48] += A[64, 16] . B[16, 48]: A a bf16 register fragment, B an
// MN-major tile in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// S[64, 64] = A . B^T over d_h = 48 (three k-steps), both tiles K-major
__device__ __forceinline__ void product_nt(float (&d)[32], uint32_t tile_a,
                                           uint32_t tile_b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n64(d, desc_k_major(tile_a, kk), desc_k_major(tile_b, kk),
                 kk > 0);
}

// d[64, 48] += A[64, 64] . B[64, 48] over the tile's 64 rows (four k-steps);
// a[16] is the [64, 64] fp32 accumulator fragment packed by pack_fragment
__device__ __forceinline__ void accumulate_nn(float (&d)[24],
                                              const uint32_t (&a)[16],
                                              uint32_t tile_b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_n48(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                 desc_mn_major(tile_b, kk));
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------
//
// A [64, N] accumulator: warp w owns rows 16 w .. 16 w + 15; with g = lane / 4
// and l = lane % 4, d[4 j], d[4 j + 1] are (row g, columns 8 j + 2 l, + 1) and
// d[4 j + 2], d[4 j + 3] the same columns of row g + 8.  The four lanes of a
// quad share two rows.  The bf16 A fragment of k-step kk is the same
// positions of columns 16 kk .. 16 kk + 15, so a [64, 64] accumulator turns
// into the A operand of the next product in registers.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void pack_fragment(const float (&d)[32],
                                              uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Each lane of a quad holds its 4-byte piece of four 16-byte units u0..u3;
// lane l returns unit l whole, the pieces in lane order.
__device__ __forceinline__ uint4 quad_gather(uint32_t u0, uint32_t u1,
                                             uint32_t u2, uint32_t u3, int l) {
  auto unit = [&](int i) {
    return i == 0 ? u0 : i == 1 ? u1 : i == 2 ? u2 : u3;
  };
  const uint32_t self = unit(l);
  // lane l ^ x sends its piece of unit (l ^ x) ^ x = l
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, unit(l ^ 1), 1);
  const uint32_t r2 = __shfl_xor_sync(0xffffffffu, unit(l ^ 2), 2);
  const uint32_t r3 = __shfl_xor_sync(0xffffffffu, unit(l ^ 3), 3);
  auto from = [&](int lane) {
    const int x = lane ^ l;
    return x == 0 ? self : x == 1 ? r1 : x == 2 ? r2 : r3;
  };
  return make_uint4(from(0), from(1), from(2), from(3));
}

// The [64, 48] accumulator, rows scaled by mul_lo (row g) and mul_hi (row
// g + 8), to rows row0 .. row0 + 63 of a [T, 48] bf16 matrix, as 16-byte
// stores: the quad's lanes trade pieces so that each holds whole 8-column
// chunks (12 chunks a quad: three rounds of four).
__device__ __forceinline__ void store_fragment(const float (&d)[24],
                                               float mul_lo, float mul_hi,
                                               bf16* dst, int row0, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int row_lo = row0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  uint32_t lo[kChunks], hi[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    lo[j] = pack_bf16(d[4 * j] * mul_lo, d[4 * j + 1] * mul_lo);
    hi[j] = pack_bf16(d[4 * j + 2] * mul_hi, d[4 * j + 3] * mul_hi);
  }
  auto put = [&](int row, int chunk, uint4 val) {
    if (row < t)
      *reinterpret_cast<uint4*>(dst + (size_t)row * kD + chunk * 8) = val;
  };
  put(row_lo, l, quad_gather(lo[0], lo[1], lo[2], lo[3], l));
  put(l < 2 ? row_lo : row_hi, l < 2 ? 4 + l : l - 2,
      quad_gather(lo[4], lo[5], hi[0], hi[1], l));
  put(row_hi, 2 + l, quad_gather(hi[2], hi[3], hi[4], hi[5], l));
}

}  // namespace gigaam
