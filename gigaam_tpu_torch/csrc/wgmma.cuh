// Building blocks shared by attention.cu, attention_bwd.cu,
// relpos_attention.cu and relpos_attention_bwd.cu (sm_90a): the shared-memory
// tile layout that `wgmma` reads, asynchronous tile loads, the warpgroup
// matrix products, the accumulator-fragment store, and (at the end) the
// relative-position window: its stream of tiles, the shear of its product
// and the skewed score gradient.
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
// warp reads whole 32-byte sectors.  Rows outside the matrix are zero-filled
// (source size 0).  `cp.async` writes through the generic proxy and `wgmma` reads through
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

// rows [row0, row0 + 64) of an [n_rows, 48] matrix into a tile at shared
// address `tile`, zero outside [0, n_rows): past T for q, k, v and do, and
// for the position table, whose window starts below row 0 for late query
// tiles and ends past the last row for early ones, on either side
__device__ __forceinline__ void load_tile_async(uint32_t tile, const bf16* src,
                                                int row0, int n_rows) {
#pragma unroll
  for (int n = threadIdx.x; n < kTile * kChunks; n += kThreads) {
    const int group = n / 8;
    const int row = row0 + 8 * (group / kChunks) + n % 8;
    const int chunk = group % kChunks;
    const bool in = row >= 0 && row < n_rows;
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

// d[64, 48] (+)= A[64, 16] . B[16, 48], both in shared memory: B an MN-major
// tile (the transpose bit set), A K-major or, with kTransA, MN-major (A read
// transposed, which `wgmma` allows for 16-bit types from shared memory)
template <int kTransA>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA));
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

// One key tile of the online softmax, on this thread's part of a [64, 64]
// score fragment `s` (rows g and g + 8 of its warp's 16: `_lo` and `_hi`).
// In: the raw scores, the tile's additive key masks `mask` [64] in base-2
// units, and scale * log2(e).  Updates the rows' running max (base-2 units)
// and this thread's share of their running sum, rescales the output
// accumulator to the new max, and leaves P = exp2(s - max), packed to bf16, in
// `p`: the A fragment of O += P.V.
__device__ __forceinline__ void online_softmax_tile(
    float (&s)[32], const float* mask, float scale2, float& m_lo, float& m_hi,
    float& l_lo, float& l_hi, float (&o_acc)[24], uint32_t (&p)[16]) {
  const int l = threadIdx.x & 3;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 mk = *reinterpret_cast<const float2*>(&mask[8 * j + 2 * l]);
    s[4 * j] = fmaf(s[4 * j], scale2, mk.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, mk.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, mk.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, mk.y);
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // every tile holds a key below T, so the new max is finite
  const float new_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float new_hi = fmaxf(m_hi, quad_max(mx_hi));
  const float corr_lo = exp2f(m_lo - new_lo), corr_hi = exp2f(m_hi - new_hi);
  m_lo = new_lo;
  m_hi = new_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = exp2f(s[4 * j] - m_lo);
    s[4 * j + 1] = exp2f(s[4 * j + 1] - m_lo);
    s[4 * j + 2] = exp2f(s[4 * j + 2] - m_hi);
    s[4 * j + 3] = exp2f(s[4 * j + 3] - m_hi);
    sum_lo += s[4 * j] + s[4 * j + 1];
    sum_hi += s[4 * j + 2] + s[4 * j + 3];
  }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
  pack_fragment(s, p);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    o_acc[4 * j] *= corr_lo;
    o_acc[4 * j + 1] *= corr_lo;
    o_acc[4 * j + 2] *= corr_hi;
    o_acc[4 * j + 3] *= corr_hi;
  }
}

// sum_c a[row, c] * b[row, c] over one row of two [T, 48] matrices, by the
// four lanes of the quad that owns the row (12 columns each); 0 past T
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b, int row,
                                         int t, int l) {
  float part = 0.f;
  if (row < t) {
    const uint2* pa = reinterpret_cast<const uint2*>(a + (size_t)row * kD + 12 * l);
    const uint2* pb = reinterpret_cast<const uint2*>(b + (size_t)row * kD + 12 * l);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint2 xa = pa[i], xb = pb[i];
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa.x));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa.y));
      const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb.x));
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xb.y));
      part += a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y;
    }
  }
  return quad_sum(part);
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

// ---------------------------------------------------------------------------
// the relative-position window (relpos_attention.cu, relpos_attention_bwd.cu)
// ---------------------------------------------------------------------------
//
// For the 64-query tile at q0 and the 64-key tile at k0, every relative
// position the pair needs lies in the 127 rows T-1-q0-63+k0 .. T-1-q0+k0+63
// of p_heads[h]: a 128-row window W with
//   bias[q0 + li][k0 + lj] = (Q_v . W^T)[li][63 - li + lj].
// The window of the next tile of a sweep starts 64 rows further on (or back),
// so windows are two consecutive 64-row tiles of one stream: a sweep loads
// each table row once, through a ring of kWinSlots tile slots.  Rows outside
// [0, 2T-1) are zero (load_tile_async).
//
// The shear.  R = Q_v . W^T is two m64n64 products; their accumulators give a
// warp its 16 rows over all 128 window columns, but row li needs columns
// 63 - li .. 126 - li: a per-row offset, which no register layout holds.  So
// R, rounded to bf16 (the rounding the Pallas kernel makes before its shear),
// passes through one bf16 buffer of [64, 128], rows kBiasStride bytes apart,
// and is read back sheared, already in the layout of the score fragment it
// is added to (add_bias) or of the transposed one (add_bias_transposed).
//
// The skew.  The backward needs the score gradient dz in the window's
// coordinates: G[li][63 - li + lj] = dz[li][lj], zero elsewhere ([64, 128]
// bf16).  G lives in shared memory as core matrices (8 rows x 16 bytes, the
// 16 of an 8-row group 128 bytes apart, groups kSkewGroupBytes apart), so it
// is a `wgmma` operand both ways: K-major for dq_v = G . W (skew_desc), and
// read transposed for the window's share of dp, G^T . Q_v (skew_desc_t).

constexpr int kWinSlots = 3;   // two tiles in use, one in flight
constexpr int kBiasStride = 2 * (2 * kTile) + 16;   // 272 bytes: rows padded
constexpr int kBiasBytes = kTile * kBiasStride;
constexpr int kSkewGroupBytes = (2 * kTile / 8) * kCoreBytes;   // 2048
constexpr int kSkewBytes = (kTile / 8) * kSkewGroupBytes;       // 16384

// The halves of R (window columns 0..63 and 64..127) as bf16 to this warp's
// 16 rows of the bias buffer.  Rows 16 w .. 16 w + 15 use columns
// 48 - 16 w .. 126 - 16 w only: 8-column chunks 6 - 2 w .. 15 - 2 w.
__device__ __forceinline__ void store_window_product(unsigned char* buf,
                                                     const float (&r_lo)[32],
                                                     const float (&r_hi)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* row_lo =
      buf + (warp * 16 + (lane >> 2)) * kBiasStride + 4 * (lane & 3);
  unsigned char* row_hi = row_lo + 8 * kBiasStride;
  const int first = 6 - 2 * warp;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    if (jj >= first && jj < first + 10) {
      const int j = jj & 7;
      const float a = jj < 8 ? r_lo[4 * j] : r_hi[4 * j];
      const float b = jj < 8 ? r_lo[4 * j + 1] : r_hi[4 * j + 1];
      const float c = jj < 8 ? r_lo[4 * j + 2] : r_hi[4 * j + 2];
      const float d = jj < 8 ? r_lo[4 * j + 3] : r_hi[4 * j + 3];
      *reinterpret_cast<uint32_t*>(row_lo + 16 * jj) = pack_bf16(a, b);
      *reinterpret_cast<uint32_t*>(row_hi + 16 * jj) = pack_bf16(c, d);
    }
  }
}

__device__ __forceinline__ float widen_bf16_at(const unsigned char* p) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}

// s[li][lj] += bias[li][lj] on a [64 queries, 64 keys] accumulator fragment;
// a warp reads the rows it stored itself
__device__ __forceinline__ void add_bias(float (&s)[32],
                                         const unsigned char* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = warp * 16 + (lane >> 2);
  const unsigned char* lo =
      buf + li * kBiasStride + 2 * (kTile - 1 - li + 2 * (lane & 3));
  const unsigned char* hi = lo + 8 * kBiasStride - 16;   // row li + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] += widen_bf16_at(lo + 16 * j);
    s[4 * j + 1] += widen_bf16_at(lo + 16 * j + 2);
    s[4 * j + 2] += widen_bf16_at(hi + 16 * j);
    s[4 * j + 3] += widen_bf16_at(hi + 16 * j + 2);
  }
}

// the same on a transposed fragment, [64 keys, 64 queries]: element (key lj,
// query li) is at byte li * (kBiasStride - 2) + 2 * (63 + lj); the rows read
// were stored by every warp
__device__ __forceinline__ void add_bias_transposed(float (&s)[32],
                                                    const unsigned char* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kStep = kBiasStride - 2;   // one query on, same key
  const int lj = warp * 16 + (lane >> 2);
  const unsigned char* p =
      buf + 2 * (lane & 3) * kStep + 2 * (kTile - 1 + lj);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] += widen_bf16_at(p + 8 * j * kStep);
    s[4 * j + 1] += widen_bf16_at(p + (8 * j + 1) * kStep);
    s[4 * j + 2] += widen_bf16_at(p + 8 * j * kStep + 16);   // key lj + 8
    s[4 * j + 3] += widen_bf16_at(p + (8 * j + 1) * kStep + 16);
  }
}

__device__ __forceinline__ int skew_offset(int li, int c) {
  return (li >> 3) * kSkewGroupBytes + (c >> 3) * kCoreBytes + (li & 7) * 16
         + (c & 7) * 2;
}

// G[li][63 - li + lj] = dz[li][lj] for the packed [64, 64] fragment `dz`
// (pack_fragment's order).  The band's positions are the same for every tile,
// so the zeros around it are written once, before the sweep.
__device__ __forceinline__ void store_skewed(unsigned char* g,
                                             const uint32_t (&dz)[16]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int li = warp * 16 + (lane >> 2) + 8 * half;
    const int c = kTile - 1 - li + 2 * (lane & 3);   // column of lj = 2 l
    // lj = 8 j + 2 l (+ 1) is j chunks of 8 columns further on
    unsigned char* even = g + skew_offset(li, c);
    unsigned char* odd = g + skew_offset(li, c + 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t pair = dz[2 * j + half];
      *reinterpret_cast<uint16_t*>(even + j * kCoreBytes) =
          static_cast<uint16_t>(pair & 0xffffu);
      *reinterpret_cast<uint16_t*>(odd + j * kCoreBytes) =
          static_cast<uint16_t>(pair >> 16);
    }
  }
}

// k-step kk (window columns 16 kk .. 16 kk + 15) of G as the K-major A
// operand of dq_v = G . W
__device__ __forceinline__ uint64_t skew_desc(uint32_t g, int kk) {
  return smem_desc(g + kk * kStepKMajor, kCoreBytes, kSkewGroupBytes);
}

// k-step kk (query rows 16 kk .. 16 kk + 15) of window rows 64 half ..
// 64 half + 63 of G^T: G read transposed as the A operand of G^T . Q_v
__device__ __forceinline__ uint64_t skew_desc_t(uint32_t g, int half, int kk) {
  return smem_desc(g + half * (kTile / 8) * kCoreBytes
                     + kk * 2 * kSkewGroupBytes,
                   kSkewGroupBytes, kCoreBytes);
}

// rows [0, 64) of a [64, 48] accumulator added into rows row0 .. of an fp32
// [n_rows, 48] matrix with 8-byte vector atomics (sm_90), skipping rows
// outside [0, n_rows) and pairs that are zero (masked or padded keys)
__device__ __forceinline__ void atomic_add_fragment(const float (&d)[24],
                                                    float* dst, int row0,
                                                    int n_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_lo = row0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int col = 2 * (lane & 3);
  auto add = [&](int row, int j, float x, float y) {
    if (row >= 0 && row < n_rows && (x != 0.f || y != 0.f))
      atomicAdd(reinterpret_cast<float2*>(dst + (size_t)row * kD + 8 * j + col),
                make_float2(x, y));
  };
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    add(row_lo, j, d[4 * j], d[4 * j + 1]);
    add(row_hi, j, d[4 * j + 2], d[4 * j + 3]);
  }
}

}  // namespace gigaam
