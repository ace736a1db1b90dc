// The head-group walk of the SDPA ablation's redesign (P9), shared by the
// translation units that instantiate it: sdpa_groups_ws.cu (P9's
// sdpa_groups_ws_kernel, o head-major) and attn_fold_ws.cu (the attention
// fold's sdpa_packed_ws_kernel, o packed).  sdpa_groups_ws.cu's header says
// what the walk computes, what bounds it and how it is built.  A second
// kernel in P9's translation unit changed P9's SASS (its producer's
// shared-memory address setup), so the packed instance
// lives in the other library.

#pragma once

#include "conv_ws.cuh"

namespace {

using namespace gigaam;

constexpr int kConsumers = 2;                   // warpgroups
constexpr int kWsThreads = (kConsumers + 1) * 128;
constexpr int kStages = 4;                      // K/V stages a consumer
constexpr int kQSlots = 2;                      // Q tiles a consumer
// a K, V or Q tile in shared memory: 64 rows of 128 bytes, the 48 columns
// and 16 of zero fill, with the 128-byte swizzle
constexpr int kTileSmem = kTile * 128;
constexpr int kStageBytes = 2 * kTileSmem;     // K, then V
constexpr int kConsumerBytes = kQSlots * kTileSmem + kStages * kStageBytes;
constexpr int kSmem = kConsumers * kConsumerBytes + kSmemAlign;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kPackedHeads = 16;                 // the packed o's heads

struct GroupsMaps {
  CUtensorMap q, k, v;   // [B H, T, 48], boxes [1, 64, 64], 128-byte swizzle
};

struct GroupsArgs {
  const int4* units;     // the plan: {batch element, query tile, first head,
                         // heads}, one a block
  const uint8_t* mask;   // [B, T]
  bf16* o;               // [B, H, T, 48]
  int n_heads, t;
  float scale;
};

// k-step kk (columns 16 kk ..) of a tile read K-major (gemm.cuh's A
// layout): 8-row atoms 1024 bytes apart, the step 32 bytes in
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return swizzled_desc(tile + 32 * kk, 16, 1024, kSwizzle128);
}

// k-step kk (rows 16 kk ..) of a tile read MN-major (gemm.cuh's B layout,
// one box of 64 columns, of which P.V reads 48)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return swizzled_desc(tile + 2048 * kk, kTileSmem, 1024, kSwizzle128);
}

// rows row0 .. row0 + 63 of head bh into the tile at `dst`, on `bar`
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int row0, int bh, uint32_t bar) {
  tma_load_3d(dst, map, 0, row0, bh, bar);
}

// heads of a run of n that consumer c walks: its own every other one
__device__ __forceinline__ int heads_of(int n, int c) {
  return (n - c + 1) / 2;
}

struct Ring {
  uint32_t smem;         // the aligned dynamic shared memory
  uint32_t full, empty, q_full, q_empty;   // barrier arrays [consumer][slot]

  __device__ __forceinline__ uint32_t base(int c) const {
    return smem + c * kConsumerBytes;
  }
  __device__ __forceinline__ uint32_t q_tile(int c, int i) const {
    return base(c) + (i % kQSlots) * kTileSmem;
  }
  __device__ __forceinline__ uint32_t stage(int c, int it) const {
    return base(c) + kQSlots * kTileSmem + (it % kStages) * kStageBytes;
  }
  __device__ __forceinline__ uint32_t bar(uint32_t arr, int c, int slot,
                                          int slots) const {
    return arr + 8 * (c * slots + slot);
  }
};

// One thread of the producer warpgroup: for each head the consumer walks, its
// Q tile into a free slot, then its key tiles' K and V into free stages;
// the two consumers' items taken in turn.
__device__ __forceinline__ void produce(const Ring& r, const GroupsMaps& maps,
                                        const GroupsArgs& a, int4 unit,
                                        int n_tiles) {
  const int nh[kConsumers] = {heads_of(unit.w, 0), heads_of(unit.w, 1)};
  const int steps = nh[0] * n_tiles;   // nh[0] >= nh[1]
  for (int it = 0; it < steps; ++it) {
    const int i = it / n_tiles, j = it % n_tiles;
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
      if (i >= nh[c]) continue;
      const int bh = unit.x * a.n_heads + unit.z + c + 2 * i;
      if (j == 0) {
        const uint32_t qb = r.bar(r.q_full, c, i % kQSlots, kQSlots);
        mbar_wait(r.bar(r.q_empty, c, i % kQSlots, kQSlots),
                  ((i / kQSlots) & 1) ^ 1);
        mbar_expect_tx(qb, kTileSmem);
        load_tile(r.q_tile(c, i), &maps.q, unit.y * kTile, bh, qb);
      }
      const uint32_t fb = r.bar(r.full, c, it % kStages, kStages);
      mbar_wait(r.bar(r.empty, c, it % kStages, kStages),
                ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(fb, kStageBytes);
      const uint32_t st = r.stage(c, it);
      load_tile(st, &maps.k, j * kTile, bh, fb);
      load_tile(st + kTileSmem, &maps.v, j * kTile, bh, fb);
    }
  }
}

// this warp's arrival on a consumer barrier (four arrivals complete it)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int kN>
__device__ __forceinline__ void fence_words(uint32_t (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// this thread's 16 additive key masks of the tile at k0 (columns 8 jj + 2 l
// and + 1), in base-2 units, as online_softmax_tile reads them
__device__ __forceinline__ void tile_mask(const uint8_t* row, int k0, int t,
                                          float (&mk)[16]) {
  const int l = threadIdx.x & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = k0 + 8 * jj + 2 * l;
    mk[2 * jj] = key_mask2(row, j, t);
    mk[2 * jj + 1] = key_mask2(row, j + 1, t);
  }
}

// online_softmax_tile's arithmetic on one key tile, in place and without
// the output's rescale or the packing: the running max and sum move on, s
// becomes P = exp2(s - max) in fp32, and corr_* is the factor the output
// takes before P.V.  P is packed to bf16 (the next P.V's A operand) only
// after the product in flight has landed: packed while it runs, into
// registers that ptxas may share with the operand it is still reading,
// it makes ptxas serialise the products.
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             const float (&mk)[16],
                                             float scale2, float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& corr_lo,
                                             float& corr_hi) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = fmaf(s[4 * j], scale2, mk[2 * j]);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, mk[2 * j + 1]);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, mk[2 * j]);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, mk[2 * j + 1]);
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float new_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float new_hi = fmaxf(m_hi, quad_max(mx_hi));
  corr_lo = exp2f(m_lo - new_lo);
  corr_hi = exp2f(m_hi - new_hi);
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
}

// d[64, 64] = A[64, 16] . B[64, 16]^T, both K-major tiles in shared memory:
// wgmma_ss_n64 without accumulation, d written only, so that the registers
// the last tile's softmax left in d are no input of the product
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// the output accumulator to a new running max (corr = exp2(old - new))
__device__ __forceinline__ void rescale(float (&o)[24], float corr_lo,
                                        float corr_hi) {
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    o[4 * j] *= corr_lo;
    o[4 * j + 1] *= corr_lo;
    o[4 * j + 2] *= corr_hi;
    o[4 * j + 3] *= corr_hi;
  }
}

constexpr int kSteps = kD / 16;       // k-steps of S over d_h
constexpr int kPvSteps = kTile / 16;  // k-steps of P.V over the keys

// the descriptors of S = Q K^T (Q's k-step kk at ds[kk], K's at
// ds[kSteps + kk]) and of P.V (V's k-step kk at dv[kk])
__device__ __forceinline__ void product_descs(uint32_t q, uint32_t k,
                                              uint32_t v,
                                              uint64_t (&ds)[2 * kSteps],
                                              uint64_t (&dv)[kPvSteps]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    ds[kk] = desc_k(q, kk);
    ds[kSteps + kk] = desc_k(k, kk);
  }
#pragma unroll
  for (int kk = 0; kk < kPvSteps; ++kk) dv[kk] = desc_mn(v, kk);
}

// S [64, 64] = Q . K^T over d_h (three k-steps)
__device__ __forceinline__ void scores(float (&s)[32],
                                       const uint64_t (&ds)[2 * kSteps]) {
  wgmma_ss_n64_first(s, ds[0], ds[kSteps]);
#pragma unroll
  for (int kk = 1; kk < kSteps; ++kk)
    wgmma_ss_n64(s, ds[kk], ds[kSteps + kk], 1);
}

// O [64, 48] += P [64, 64] . V [64, 48] (four k-steps)
__device__ __forceinline__ void accumulate(float (&o)[24],
                                           const uint32_t (&p)[16],
                                           const uint64_t (&dv)[kPvSteps]) {
#pragma unroll
  for (int kk = 0; kk < kPvSteps; ++kk)
    wgmma_rs_n48(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 dv[kk]);
}

// store_fragment for a warpgroup that is not the block's first: rows by the
// warp's place in its warpgroup, kRowStride elements apart in dst
template <int kRowStride>
__device__ __forceinline__ void store_rows(const float (&d)[24], float mul_lo,
                                           float mul_hi, bf16* dst, int row0,
                                           int t) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
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
      *reinterpret_cast<uint4*>(dst + (size_t)row * kRowStride + chunk * 8) =
          val;
  };
  put(row_lo, l, quad_gather(lo[0], lo[1], lo[2], lo[3], l));
  put(l < 2 ? row_lo : row_hi, l < 2 ? 4 + l : l - 2,
      quad_gather(lo[4], lo[5], hi[0], hi[1], l));
  put(row_hi, 2 + l, quad_gather(hi[2], hi[3], hi[4], hi[5], l));
}

// Consumer warpgroup c: its heads of the run, each a walk over the key tiles
// with one product in flight across the softmax.  kPacked: o is [B, T,
// kPackedHeads * 48], head h at columns 48 h .. (the attention fold's
// layout, read by its output product), else [B, H, T, 48].
template <bool kPacked>
__device__ __forceinline__ void consume(const Ring& r, const GroupsArgs& a,
                                        int4 unit, int n_tiles, int c) {
  const int nh = heads_of(unit.w, c);
  const int q0 = unit.y * kTile;
  const uint8_t* mrow = a.mask + (size_t)unit.x * a.t;
  const float scale2 = a.scale * kLog2e;
  int it = 0;   // this consumer's items so far
  for (int i = 0; i < nh; ++i, it += n_tiles) {
    const size_t bh = (size_t)unit.x * a.n_heads + unit.z + c + 2 * i;
    const uint32_t q = r.q_tile(c, i);
    const uint32_t q_empty = r.bar(r.q_empty, c, i % kQSlots, kQSlots);
    mbar_wait(r.bar(r.q_full, c, i % kQSlots, kQSlots), (i / kQSlots) & 1);

    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    float corr_lo, corr_hi;
    float o[24];
#pragma unroll
    for (int e = 0; e < 24; ++e) o[e] = 0.f;
    float s[32], mk[16];
    uint32_t p[16];

    // key tile 0: S alone
    mbar_wait(r.bar(r.full, c, it % kStages, kStages), (it / kStages) & 1);
    uint64_t ds[2 * kSteps], dv[kPvSteps];
    product_descs(q, r.stage(c, it), 0, ds, dv);
    wgmma_fence();
    scores(s, ds);
    wgmma_commit();
    tile_mask(mrow, 0, a.t, mk);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_tiles == 1) warp_arrive(q_empty);
    softmax_tile(s, mk, scale2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
    pack_fragment(s, p);

    for (int j = 1; j < n_tiles; ++j) {
      const int prev = it + j - 1, cur = it + j;
      mbar_wait(r.bar(r.full, c, cur % kStages, kStages),
                (cur / kStages) & 1);
      // every register input of the two products is defined before the
      // fence that opens their batch
      product_descs(q, r.stage(c, cur), r.stage(c, prev) + kTileSmem, ds,
                    dv);
      fence_regs(o);
      fence_words(p);
      wgmma_fence();
      scores(s, ds);
      wgmma_commit();
      accumulate(o, p, dv);
      wgmma_commit();
      tile_mask(mrow, j * kTile, a.t, mk);
      wgmma_wait<1>();          // S of tile j has landed
      fence_regs(s);
      if (j == n_tiles - 1) warp_arrive(q_empty);
      softmax_tile(s, mk, scale2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
      // the softmax runs before this wait (s is read, not redefined)
#pragma unroll
      for (int e = 0; e < 32; ++e) asm volatile("" :: "f"(s[e]));
      wgmma_wait<0>();          // P.V of tile j - 1 has landed
      fence_regs(o);
      fence_regs(s);            // P's packing waits for the wait
      warp_arrive(r.bar(r.empty, c, prev % kStages, kStages));
      rescale(o, corr_lo, corr_hi);
      pack_fragment(s, p);
    }

    const int last = it + n_tiles - 1;
    product_descs(q, 0, r.stage(c, last) + kTileSmem, ds, dv);
    fence_regs(o);
    fence_words(p);
    wgmma_fence();
    accumulate(o, p, dv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    warp_arrive(r.bar(r.empty, c, last % kStages, kStages));

    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if constexpr (kPacked)
      store_rows<kPackedHeads * kD>(
          o, 1.f / l_lo, 1.f / l_hi,
          a.o + (size_t)unit.x * a.t * kPackedHeads * kD +
              (unit.z + c + 2 * i) * kD,
          q0, a.t);
    else
      store_rows<kD>(o, 1.f / l_lo, 1.f / l_hi, a.o + bh * a.t * kD, q0, a.t);
  }
}

// x broadcast from lane 0, so that ptxas knows it to be warp-uniform: the
// warpgroup and the unit decide every loop bound, shared address and `wgmma`
// descriptor, which then live in uniform registers
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ int4 uniform(int4 u) {
  return make_int4(uniform(u.x), uniform(u.y), uniform(u.z), uniform(u.w));
}

// [B H, T, 48] bf16 as a 3-D map, boxes [1, 64 rows, 64 columns] with the
// 128-byte swizzle: columns 48 .. 63 and rows past T are zero-filled
bool head_map(CUtensorMap* map, const void* base, int bh, int t) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kD * 2, (cuuint64_t)t * kD * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  return bf16_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
