// The FFN and conv-module fold probes for Hopper (sm_90a).
//
// They replace the Pallas kernels of two probes of the JAX package:
// benchmarks/pallas_ffn_fold_probe.py::ffn_lnres_folded (P4, the body
// _ffn_lnres_kernel) and benchmarks/pallas_conv_fold_probe.py::
// conv_lnres_folded (P5, the body _conv_lnres_kernel).  Neither is on a path
// of the model: they measure whether folding a Conformer sub-block beats the
// stock composition on this card.  Both now run on their redesign (ffn_ws.cu,
// conv_fold_ws.cu); these kernels are kept for an A/B on the same card.
//
// What each kernel computes, for the rows m of x [M, 768] bf16 (M = B*T):
//   ffn_fold_kernel (P4)   xn = bf16(LN(x))                 (fp32, eps 1e-5)
//                          h  = bf16(SiLU(xn W1 + b1))      (fp32 before SiLU)
//                          out = bf16(bf16(0.5 (h W2 + b2)) + x)
//   glu_fold_kernel (P5)   y = bf16((xn Wv + bv) sigmoid(xn Wg + bg)), 0 on
//                          padded frames
//   dw_proj_kernel  (P5)   c = bf16(SiLU(bns dw31(y) + bnb))  (fp32 taps)
//                          out = bf16(bf16(c W2 + b2) + x)
// Every product is a `wgmma` product of this file, bf16 operands with fp32
// accumulation; biases, LayerNorm, SiLU and the BatchNorm affine are fp32,
// rounded to bf16 where the Pallas bodies round.  The depthwise taps fuse
// each multiply-add (one rounding where the Pallas body rounds twice).
//
// What bounds them on the card, and what the design does about it:
//   * P4 is 4 * 768 * 3072 = 9.4 M tensor operations a row against 3 KB of
//     the row's bytes: bounded by operations.  The fold only pays if h
//     [rows, 3072] never reaches device memory.  A [64, 3072] bf16 h is 384 KB
//     and an SM grants 227 KB, so a block walks d_ff in chunks of 64:
//     h_c = SiLU(xn W1[:, c] + b1[c]) goes to shared memory and
//     acc += h_c W2[c, :] stays in registers.  The [64, 768] fp32
//     accumulator is 384 registers a thread in one warpgroup, over the 255
//     limit, so two warpgroups split the output's columns, 384 each (192
//     registers); each computes 32 of h_c's 64 columns (16 registers) and
//     both read the whole chunk from shared memory.  Shared memory: xn
//     resident, 96 KB (LayerNorm is the block's prologue: no xn round trip);
//     h_c double-buffered, 16 KB; a ring of six 16 KB stages, 96 KB (chunk
//     64: six W1 stages and six W2 stages a chunk, one chunk's worth of
//     either kind in flight).  A block holds 64 rows, so it reads all of W1
//     and W2 (9.4 MB, from L2) for 64 rows: 64 operations a byte of L2.
//   * P5 is 6 * 768 * 768 = 3.5 M tensor operations a row and 2 * 31 * 768
//     fp32 operations: bounded by operations.  Its depthwise conv needs 15
//     frames of halo on each side of a tile and its last product needs all
//     768 channels of a row, so it is two kernels: glu_fold_kernel (LN
//     prologue, the value and gate products, the mask) writes y once as
//     bf16, dw_proj_kernel reads a tile's y window of one batch element
//     (zero past its ends: a tile never reads the next element's frames),
//     runs the 31 taps, the BatchNorm affine and SiLU as the prologue of the
//     W2 product, and adds b2 and the residual in its epilogue.  The extra
//     device-memory traffic is y's write and read, 2 * M * 1536 bytes.
//   * Weights are read MN-major (the transpose bit) from [in, out] row-major
//     tensors through gemm.cuh's TMA ring; the resident A tiles (xn, h_c,
//     c) are written by the block in the layout a 128-byte-swizzled TMA box
//     would have, so the same K-major descriptors read them.

#include "gemm.cuh"

using namespace gigaam;

namespace {

constexpr int kModel = 768;
constexpr int kFF = 3072;
constexpr int kTaps = 31;
constexpr int kHalo = kTaps / 2;
constexpr int kRowTile = 64;                  // rows a block
constexpr int kFoldThreads = 2 * kThreads;    // two warpgroups
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kBoxBytes = 64 * 128;           // [64 rows, 64 columns] bf16
constexpr int kTileBytes = kModel / 64 * kBoxBytes;   // [64, 768]: 12 boxes
constexpr int kStageBytes = 2 * kBoxBytes;    // P4 and dw_proj_kernel's items

// byte offset of (row r, 16-byte chunk q of the row's 96) in a [64, 768]
// tile stored as 12 K-major boxes of 64 columns with the 128-byte swizzle
__device__ __forceinline__ int tile_offset(int r, int q) {
  return (q >> 3) * kBoxBytes + r * 128 + (((q & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ int warpgroup() { return threadIdx.x / kThreads; }

__device__ __forceinline__ float silu(float v) {
  return v * (1.f / (1.f + __expf(-v)));
}

// K-major descriptor of k-step kk (16 columns) of box `box` of a resident
// tile at shared address `tile`; `col` shifts the step by 16-column steps
// within the box (0..3)
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int box, int col) {
  return swizzled_desc(tile + box * kBoxBytes + col * 32, 16, 1024,
                       kSwizzle128);
}

// rows m0 .. m0 + 63 of x [m, 768] -> bf16(LN(x)) into the resident tile
// `tile` (generic address); rows past m are zero.  One warp a row; lane l
// holds the row's 16-byte chunks l, l + 32, l + 64.
__device__ __forceinline__ void ln_rows(const bf16* x, const float* g,
                                        const float* b, int m0, int m,
                                        unsigned char* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRowTile; r += kFoldWarps) {
    const int row = m0 + r;
    if (row >= m) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<uint4*>(tile + tile_offset(r, lane + 32 * i)) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    const bf16* xr = x + (size_t)row * kModel;
    float v[3][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      unpack8(*reinterpret_cast<const uint4*>(xr + (lane + 32 * i) * 8), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
    const float mean = warp_sum(s) / kModel;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s2 += (v[i][e] - mean) * (v[i][e] - mean);
    const float rstd = rsqrtf(warp_sum(s2) / kModel + 1e-5f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int q = lane + 32 * i;
      float gg[8], bb[8];
      load8f(g + q * 8, gg);
      load8f(b + q * 8, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[i][e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mean), rstd), gg[e]), bb[e]);
      *reinterpret_cast<uint4*>(tile + tile_offset(r, q)) = pack8(v[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// the wide product: acc [64, 768] += A [64, K] . W [K, 768], two warpgroups
// ---------------------------------------------------------------------------
//
// A K tile of 64 rows of W is six items of [64 rows, 128 columns] (two
// boxes); warpgroup w holds output columns 384 w .. 384 w + 383 as acc[0..2]
// and multiplies the items jj with jj % 2 == w.  Item jj holds the 128
// columns from 128 wide_block(jj).

__device__ __forceinline__ int wide_block(int jj) {
  return (jj & 1) * 3 + (jj >> 1);
}

// item i of the ring, the wide item jj of its K tile, against the A box at
// shared address `a` (its 64 columns are the K tile's)
template <typename Ring, typename Issue>
__device__ __forceinline__ void wide_step(float (&acc)[3][64], const Ring& ring,
                                          int i, int n, int jj, uint32_t a,
                                          Issue issue) {
  ring.wait(i);
  if ((jj & 1) == warpgroup()) {
    const uint32_t b = ring.stage(i);
    auto product = [&](float (&d)[64]) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tb<128>(d, tile_desc(a, 0, kk), weight_desc<64>(b, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
    };
    if ((jj >> 1) == 0) product(acc[0]);
    else if ((jj >> 1) == 1) product(acc[1]);
    else product(acc[2]);
  }
  ring.release(i, n, issue);
}

// out[row] = bf16(bf16(scale (acc + bias)) + x[row]) over this warpgroup's
// 384 columns (scale 0.5 or 1: exact on a bf16 value); row_of(r) is the row
// of x and out of the tile's row r, or -1 past their end
template <typename RowOf>
__device__ __forceinline__ void store_residual(const float (&acc)[3][64],
                                               const float* bias, float scale,
                                               const bf16* x, bf16* out,
                                               RowOf row_of) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int n0 = 384 * warpgroup() + 128 * i;
    store_tile_chunks<128>(acc[i], bias + n0, [&](int r, int chunk, uint4 val) {
      const int row = row_of(r);
      if (row < 0) return;
      const size_t at = (size_t)row * kModel + n0 + chunk * 8;
      float y[8], res[8];
      unpack8(val, y);
      unpack8(*reinterpret_cast<const uint4*>(x + at), res);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = __fadd_rn(scale * y[e], res[e]);
      *reinterpret_cast<uint4*>(out + at) = pack8(y);
    });
  }
}

__device__ __forceinline__ void zero(float (&acc)[3][64]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
}

// ---------------------------------------------------------------------------
// P4: ffn_fold_kernel
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;                      // h columns a chunk
constexpr int kChunks = kFF / kChunk;           // 48
constexpr int kW1Items = kModel / 128;          // W1 [128 rows, 64 columns]
constexpr int kW2Items = 6;                     // W2: one K tile, wide items
constexpr int kChunkItems = kW1Items + kW2Items;
constexpr int kFfnStages = 6;
constexpr int kHBytes = kBoxBytes;              // h_c [64, 64] bf16
constexpr int kFfnSmem =
    kTileBytes + 2 * kHBytes + kFfnStages * kStageBytes + kSmemAlign;

struct FfnArgs {
  const bf16* x;        // [M, 768]
  const float* ln_g;    // [768] fp32
  const float* ln_b;
  const float* b1;      // [3072] fp32
  const float* b2;      // [768] fp32
  bf16* out;            // [M, 768]
  int m;
};

struct FfnMaps {
  CUtensorMap w1;       // [768, 3072], boxes [128 rows, 64 columns]
  CUtensorMap w2;       // [3072, 768], boxes [64 rows, 64 columns]
};

// grid (row tiles of 64); item i of the ring is item i % 12 of chunk i / 12
__global__ void __launch_bounds__(kFoldThreads, 1)
ffn_fold_kernel(const __grid_constant__ FfnMaps maps, FfnArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kFfnStages], empty[kFfnStages];
  const uint32_t xn = aligned_smem(smem), h = xn + kTileBytes;
  unsigned char* base = smem + (xn - smem_u32(smem));
  const TmaRing<kFfnStages, kStageBytes> ring{h + 2 * kHBytes, full, empty};
  constexpr int n = kChunks * kChunkItems;
  const int m0 = blockIdx.x * kRowTile, wg = warpgroup();
  auto issue = [&](uint32_t st, int i, uint32_t bar) {
    const int c = i / kChunkItems, j = i % kChunkItems;
    if (j < kW1Items) {
      tma_load_2d(st, &maps.w1, c * kChunk, 128 * j, bar);
    } else {
      const int n0 = 128 * wide_block(j - kW1Items);
      tma_load_2d(st, &maps.w2, n0, c * kChunk, bar);
      tma_load_2d(st + kBoxBytes, &maps.w2, n0 + 64, c * kChunk, bar);
    }
  };
  if (threadIdx.x == 0) ring.init(kFoldWarps);
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(n, issue);
  ln_rows(a.x, a.ln_g, a.ln_b, m0, a.m, base);
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, l = lane & 3;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float acc[3][64];
  zero(acc);
  for (int c = 0; c < kChunks; ++c) {
    // h_c's columns 32 wg .. 32 wg + 31: half of each W1 box
    float hacc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) hacc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kW1Items; ++j) {
      const int i = c * kChunkItems + j;
      ring.wait(i);
      const uint32_t b = ring.stage(i) + 64 * wg;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_tb<32>(hacc, tile_desc(xn, 2 * j + kk / 4, kk % 4),
                        swizzled_desc(b + kk * 2048, 128 * 128, 1024,
                                      kSwizzle128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hacc);
      ring.release(i, n, issue);
    }
    unsigned char* hp = base + kTileBytes + (c & 1) * kHBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * wg + 8 * j + 2 * l;
      const float2 bb =
          *reinterpret_cast<const float2*>(a.b1 + c * kChunk + col);
      const int at = row * 128 + (((col >> 3) ^ (row & 7)) << 4) + 4 * l;
      *reinterpret_cast<uint32_t*>(hp + at) =
          pack_bf16(silu(hacc[4 * j] + bb.x), silu(hacc[4 * j + 1] + bb.y));
      *reinterpret_cast<uint32_t*>(hp + at + 8 * 128) =   // row + 8
          pack_bf16(silu(hacc[4 * j + 2] + bb.x), silu(hacc[4 * j + 3] + bb.y));
    }
    fence_proxy_async();
    __syncthreads();   // both halves of h_c are in place
#pragma unroll
    for (int jj = 0; jj < kW2Items; ++jj)
      wide_step(acc, ring, c * kChunkItems + kW1Items + jj, n, jj,
                h + (c & 1) * kHBytes, issue);
  }
  store_residual(acc, a.b2, 0.5f, a.x, a.out,
                 [&](int r) { return m0 + r < a.m ? m0 + r : -1; });
}

// ---------------------------------------------------------------------------
// P5, first kernel: glu_fold_kernel
// ---------------------------------------------------------------------------

constexpr int kGluCols = 256;                  // value (and gate) columns a block
constexpr int kGluBK = 32;                     // K rows an item
constexpr int kGluItems = kModel / kGluBK;
constexpr int kGluBox = kGluBK * 128;          // [32 rows, 64 columns]
constexpr int kGluStageBytes = 2 * (kGluCols / 64) * kGluBox;
constexpr int kGluStages = 3;
constexpr int kGluSmem = kTileBytes + kGluStages * kGluStageBytes + kSmemAlign;

struct GluArgs {
  const bf16* x;          // [M, 768]
  const float* ln_g;      // [768] fp32
  const float* ln_b;
  const float* bv;        // [768] fp32
  const float* bg;
  const uint8_t* valid;   // [M], 0 or 1
  bf16* y;                // [M, 768]
  int m;
};

struct GluMaps {
  CUtensorMap wv, wg;     // [768, 768], boxes [32 rows, 64 columns]
};

// grid (row tiles of 64, 768 / 256 column groups); an item is 32 rows of Wv
// then the same rows of Wg, the group's 256 columns of each (four boxes);
// warpgroup w takes the columns 128 w .. 128 w + 127 of both
__global__ void __launch_bounds__(kFoldThreads, 1)
glu_fold_kernel(const __grid_constant__ GluMaps maps, GluArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kGluStages], empty[kGluStages];
  const uint32_t xn = aligned_smem(smem);
  unsigned char* base = smem + (xn - smem_u32(smem));
  const TmaRing<kGluStages, kGluStageBytes> ring{xn + kTileBytes, full, empty};
  const int m0 = blockIdx.x * kRowTile, n0 = blockIdx.y * kGluCols;
  const int wg = warpgroup();
  auto issue = [&](uint32_t st, int kt, uint32_t bar) {
#pragma unroll
    for (int bx = 0; bx < kGluCols / 64; ++bx) {
      tma_load_2d(st + bx * kGluBox, &maps.wv, n0 + 64 * bx, kGluBK * kt, bar);
      tma_load_2d(st + (kGluCols / 64 + bx) * kGluBox, &maps.wg, n0 + 64 * bx,
                  kGluBK * kt, bar);
    }
  };
  if (threadIdx.x == 0) ring.init(kFoldWarps);
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(kGluItems, issue);
  ln_rows(a.x, a.ln_g, a.ln_b, m0, a.m, base);
  fence_proxy_async();
  __syncthreads();

  float accv[64], accg[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) accv[e] = accg[e] = 0.f;
  for (int kt = 0; kt < kGluItems; ++kt) {
    ring.wait(kt);
    const uint32_t st = ring.stage(kt) + 2 * wg * kGluBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGluBK / 16; ++kk) {
      // K rows 32 kt + 16 kk ..: box kt / 2, 16-column step 2 (kt % 2) + kk
      const uint64_t da = tile_desc(xn, kt / 2, 2 * (kt % 2) + kk);
      wgmma_ss_tb<128>(accv, da, weight_desc<kGluBK>(st, kk));
      wgmma_ss_tb<128>(accg, da, weight_desc<kGluBK>(
                                     st + kGluCols / 64 * kGluBox, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(accv);
    fence_regs(accg);
    ring.release(kt, kGluItems, issue);
  }

  const int l = threadIdx.x & 3, c0 = n0 + 128 * wg;
  uint32_t lo[16], hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * l;
    const float2 bv = *reinterpret_cast<const float2*>(a.bv + col);
    const float2 bg = *reinterpret_cast<const float2*>(a.bg + col);
    auto glu = [&](float v, float g) {
      return v * (1.f / (1.f + __expf(-g)));
    };
    lo[j] = pack_bf16(glu(accv[4 * j] + bv.x, accg[4 * j] + bg.x),
                      glu(accv[4 * j + 1] + bv.y, accg[4 * j + 1] + bg.y));
    hi[j] = pack_bf16(glu(accv[4 * j + 2] + bv.x, accg[4 * j + 2] + bg.x),
                      glu(accv[4 * j + 3] + bv.y, accg[4 * j + 3] + bg.y));
  }
  put_chunks<128>(lo, hi, [&](int r, int chunk, uint4 val) {
    const int m = m0 + r;
    if (m >= a.m) return;
    if (!a.valid[m]) val = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(a.y + (size_t)m * kModel + c0 + chunk * 8) = val;
  });
}

// ---------------------------------------------------------------------------
// P5, second kernel: dw_proj_kernel
// ---------------------------------------------------------------------------

constexpr int kSlice = 128;                    // channels a depthwise pass
constexpr int kWin = kRowTile + 2 * kHalo;     // y rows a tile reads
constexpr int kYBytes = kWin * kSlice * 2;
constexpr int kDwBytes = kTaps * kSlice * 4;
constexpr int kProjItems = (kModel / 64) * 6;  // K tile kt, wide item jj
constexpr int kProjStages = 4;
constexpr int kProjSmem = kTileBytes + kYBytes + kDwBytes
                          + kProjStages * kStageBytes + kSmemAlign;
static_assert((kTileBytes + kYBytes + kDwBytes) % kSmemAlign == 0,
              "the ring's stages start on 1024 bytes");

struct DwArgs {
  const bf16* y;        // [B, T, 768], 0 on padded frames
  const bf16* x;        // [B, T, 768]: the residual
  const float* dw;      // [31, 768] fp32: tap k of channel c at k * 768 + c
  const float* bns;     // [768] fp32: the BatchNorm scale
  const float* bnb;     // [768] fp32: its bias, the depthwise bias folded in
  const float* b2;      // [768] fp32
  bf16* out;            // [B, T, 768]
  int t;
};

struct DwMaps {
  CUtensorMap w2;       // [768, 768], boxes [64 rows, 64 columns]
};

// The 31 taps of this thread's two channels (2 p, 2 p + 1 of the slice) for
// the tile's rows 16 g .. 16 g + 15 (p = thread % 64, g = thread / 64), from
// the slice's y window `ybuf` [94, 128] bf16 and taps `wbuf` [31, 128] fp32;
// then the BatchNorm affine and SiLU, rounded into the A tile.  Each window
// row is read once and meets the taps of every output row it reaches, in
// the Pallas body's order of k.
__device__ __forceinline__ void depthwise_slice(const unsigned char* ybuf,
                                                const unsigned char* wbuf,
                                                const float* bns,
                                                const float* bnb, int ch0,
                                                unsigned char* tile) {
  const int p = threadIdx.x % 64, g = threadIdx.x / 64;
  float2 w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    w[k] = *reinterpret_cast<const float2*>(wbuf + (k * kSlice + 2 * p) * 4);
  float2 acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 16 + kTaps - 1; ++j) {
    const float2 yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        ybuf + ((16 * g + j) * kSlice + 2 * p) * 2));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = j - i;
      if (k >= 0 && k < kTaps) {
        acc[i].x = fmaf(yv.x, w[k].x, acc[i].x);
        acc[i].y = fmaf(yv.y, w[k].y, acc[i].y);
      }
    }
  }
  const int ch = ch0 + 2 * p;
  const float2 sc = *reinterpret_cast<const float2*>(bns + ch);
  const float2 bi = *reinterpret_cast<const float2*>(bnb + ch);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * g + i;
    *reinterpret_cast<uint32_t*>(tile + tile_offset(r, ch >> 3) + (ch & 7) * 2) =
        pack_bf16(silu(acc[i].x * sc.x + bi.x), silu(acc[i].y * sc.y + bi.y));
  }
}

// grid (time tiles of 64, B): the tile's rows are frames t0 .. t0 + 63 of
// batch element b
__global__ void __launch_bounds__(kFoldThreads, 1)
dw_proj_kernel(const __grid_constant__ DwMaps maps, DwArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kProjStages], empty[kProjStages];
  const uint32_t tile = aligned_smem(smem);
  unsigned char* base = smem + (tile - smem_u32(smem));
  unsigned char* ybuf = base + kTileBytes;
  unsigned char* wbuf = ybuf + kYBytes;
  const TmaRing<kProjStages, kStageBytes> ring{
      tile + kTileBytes + kYBytes + kDwBytes, full, empty};
  const int t0 = blockIdx.x * kRowTile, b = blockIdx.y;
  auto issue = [&](uint32_t st, int i, uint32_t bar) {
    const int kt = i / 6, n0 = 128 * wide_block(i % 6);
    tma_load_2d(st, &maps.w2, n0, 64 * kt, bar);
    tma_load_2d(st + kBoxBytes, &maps.w2, n0 + 64, 64 * kt, bar);
  };
  if (threadIdx.x == 0) ring.init(kFoldWarps);
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(kProjItems, issue);

  const size_t first = (size_t)b * a.t * kModel;   // batch element b's row 0
  for (int s = 0; s < kModel / kSlice; ++s) {
    for (int u = threadIdx.x; u < kWin * kSlice / 8; u += kFoldThreads) {
      const int r = u / (kSlice / 8), q = u % (kSlice / 8);
      const int tt = t0 - kHalo + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (tt >= 0 && tt < a.t)
        val = *reinterpret_cast<const uint4*>(a.y + first + (size_t)tt * kModel
                                              + kSlice * s + 8 * q);
      *reinterpret_cast<uint4*>(ybuf + (r * kSlice + 8 * q) * 2) = val;
    }
    for (int u = threadIdx.x; u < kTaps * kSlice / 4; u += kFoldThreads) {
      const int k = u / (kSlice / 4), q = u % (kSlice / 4);
      *reinterpret_cast<float4*>(wbuf + (k * kSlice + 4 * q) * 4) =
          *reinterpret_cast<const float4*>(a.dw + k * kModel + kSlice * s
                                           + 4 * q);
    }
    __syncthreads();
    depthwise_slice(ybuf, wbuf, a.bns, a.bnb, kSlice * s, base);
    fence_proxy_async();
    __syncthreads();   // the slice's columns of the A tile are in place,
                       // and ybuf and wbuf are free for the next slice
  }

  float acc[3][64];
  zero(acc);
  for (int kt = 0; kt < kModel / 64; ++kt)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj)
      wide_step(acc, ring, kt * 6 + jj, kProjItems, jj,
                tile + kt * kBoxBytes, issue);
  store_residual(acc, a.b2, 1.f, a.x + first, a.out + first,
                 [&](int r) { return t0 + r < a.t ? t0 + r : -1; });
}

}  // namespace

extern "C" {

// x, out: [M, 768] bf16; ln_g, ln_b, b2: [768] fp32; w1: [768, 3072] bf16;
// b1: [3072] fp32; w2: [3072, 768] bf16; m >= 1; all pointers 16-byte
// aligned.  Returns the CUDA error code of the tensor maps, of the
// shared-memory opt-in or of the launch.
int gigaam_ffn_fold(const void* x, const void* ln_g, const void* ln_b,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, int m, void* stream) {
  FfnMaps maps;
  if (!matrix_map(&maps.w1, w1, kModel, kFF, 128) ||
      !matrix_map(&maps.w2, w2, kFF, kModel, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  FfnArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<bf16*>(out);
  a.m = m;
  return static_cast<int>(launch<ffn_fold_kernel>(
      dim3((m + kRowTile - 1) / kRowTile), kFoldThreads, kFfnSmem,
      static_cast<cudaStream_t>(stream), maps, a));
}

// x, out: [B, T, 768] bf16; ln_g, ln_b, bv, bg, bns, bnb, b2: [768] fp32;
// wv, wg, w2: [768, 768] bf16; valid: [B, T] of 0/1 bytes; dw: [31, 768]
// fp32; y: [B, T, 768] bf16 scratch (written, then read); B, T >= 1; all
// pointers 16-byte aligned.  Runs glu_fold_kernel, then dw_proj_kernel;
// returns the first CUDA error code.
int gigaam_conv_fold(const void* x, const void* ln_g, const void* ln_b,
                     const void* wv, const void* bv, const void* wg,
                     const void* bg, const void* valid, const void* dw,
                     const void* bns, const void* bnb, const void* w2,
                     const void* b2, void* y, void* out, int batch, int t,
                     void* stream) {
  GluMaps gm;
  DwMaps dm;
  if (!matrix_map(&gm.wv, wv, kModel, kModel, kGluBK) ||
      !matrix_map(&gm.wg, wg, kModel, kModel, kGluBK) ||
      !matrix_map(&dm.w2, w2, kModel, kModel, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GluArgs ga;
  ga.x = static_cast<const bf16*>(x);
  ga.ln_g = static_cast<const float*>(ln_g);
  ga.ln_b = static_cast<const float*>(ln_b);
  ga.bv = static_cast<const float*>(bv);
  ga.bg = static_cast<const float*>(bg);
  ga.valid = static_cast<const uint8_t*>(valid);
  ga.y = static_cast<bf16*>(y);
  ga.m = batch * t;
  const cudaError_t err = launch<glu_fold_kernel>(
      dim3((ga.m + kRowTile - 1) / kRowTile, kModel / kGluCols), kFoldThreads,
      kGluSmem, s, gm, ga);
  if (err != cudaSuccess) return static_cast<int>(err);
  DwArgs da;
  da.y = static_cast<const bf16*>(y);
  da.x = static_cast<const bf16*>(x);
  da.dw = static_cast<const float*>(dw);
  da.bns = static_cast<const float*>(bns);
  da.bnb = static_cast<const float*>(bnb);
  da.b2 = static_cast<const float*>(b2);
  da.out = static_cast<bf16*>(out);
  da.t = t;
  return static_cast<int>(launch<dw_proj_kernel>(
      dim3((t + kRowTile - 1) / kRowTile, batch), kFoldThreads, kProjSmem, s,
      dm, da));
}

// For ffn_fold_kernel, glu_fold_kernel and dw_proj_kernel: out[2 i] the
// dynamic shared memory in bytes, out[2 i + 1] how many blocks one SM holds
// at a time.  Returns a CUDA error code.
int gigaam_fold_probes_occupancy(int* out) {
  cudaError_t err;
  if ((err = occupancy(ffn_fold_kernel, kFoldThreads, kFfnSmem, out)) !=
          cudaSuccess ||
      (err = occupancy(glu_fold_kernel, kFoldThreads, kGluSmem, out + 2)) !=
          cudaSuccess ||
      (err = occupancy(dw_proj_kernel, kFoldThreads, kProjSmem, out + 4)) !=
          cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

}  // extern "C"
