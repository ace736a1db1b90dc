// The Q/K/V and output projection GEMMs of the folded rotary attention
// module (sm_90a), shared by projection.cu (K1, K2) and attn_fold_probe.cu
// (the attention-fold probes P6-P8, which run the same templates at other
// row tiles and with a third epilogue).  Both are gemm.cuh's TMA ring with
// `wgmma`; projection.cu's header says what bounds them and why they are
// built so.
//
//   qkv_kernel<kWG, kBN>       q, k, v = bf16(A @ W + b) for one of the three
//                              weights per block, stored into [B, H, T, 48];
//                              64 kWG rows of the flat [B*T, D] rows a block
//   out_proj_kernel<kWG, kBN, kRes>
//                              out = sum_h O[b, h, t] @ Wo[48h:48h+48] + bo
//                              over 64 kWG rows of one batch element a block,
//                              with the epilogue kRes:
//     kNoResidual    (K2, P6, P7)  out = bf16(acc + bo)
//     kBf16Residual  (K1)          out = bf16(bf16(acc + bo) + x): the module
//                                  output rounded, then the residual added in
//                                  bf16, as the Pallas K1 adds it
//     kFp32Residual  (P8)          out = bf16((acc + bo) + float(x)): the
//                                  residual added to the fp32 accumulator and
//                                  rounded once, as the P8 probe adds it
//
// Everything here is in the unnamed namespace, so that each library that
// includes it holds its own instances with internal linkage.  With external
// linkage the two libraries' instances of one template would share the
// function-local statics of gemm.cuh's `launch` (the compiler makes such a
// static a symbol that the dynamic loader unifies across libraries), and
// the first library to opt its kernel in to its shared memory would mark
// the other's as done too: that one's launch then fails.

#pragma once

#include "gemm.cuh"

namespace {

using namespace gigaam;

enum ResidualMode { kNoResidual = 0, kBf16Residual = 1, kFp32Residual = 2 };

struct QkvArgs {
  const bf16* xr;      // A of the q and k columns
  const bf16* xv;      // A of the v columns: xn (K1) or x (K2)
  const bf16* w[3];    // Wq (pre-scaled), Wk, Wv: [D, D] bf16, [in, out]
  const float* bias[3];
  bf16* out[3];        // q, k, v: [B, H, T, 48] bf16
  int m, t, d, n_heads;
};

struct OutArgs {
  const bf16* o;       // [B, H, T, 48] bf16
  const bf16* w;       // Wo [D, D] bf16
  const float* bias;   // bo [D] fp32
  const bf16* residual;  // x [B*T, D] (kBf16Residual, kFp32Residual)
  bf16* out;           // [B*T, D] bf16
  int t, d, n_heads;
};

// ---------------------------------------------------------------------------
// the GEMMs
// ---------------------------------------------------------------------------

template <int kWG, int kBN>
struct QkvTile {
  static constexpr int kBM = 64 * kWG, kBK = 64, kStages = 3;
  static constexpr int kABytes = kBM * kBK * 2, kBBytes = kBK * kBN * 2;
  static constexpr int kSmem = kStages * (kABytes + kBBytes) + kSmemAlign;
};

// a K tile is kHeads heads of O (48 columns each) against Wo's 48 kHeads
// rows, which follow each other
template <int kWG, int kBN>
struct OutTile {
  static constexpr int kBM = 64 * kWG, kHeads = 2, kStages = 2;
  static constexpr int kBK = kD * kHeads;
  static constexpr int kABytes = kBM * kBK * 2, kBBytes = kBK * kBN * 2;
  static constexpr int kSmem = kStages * (kABytes + kBBytes) + kSmemAlign;
};

struct QkvMaps {
  CUtensorMap a[2];   // xr, then xv: [M, D], boxes [64 kWG rows, 64], 128 B swizzle
  CUtensorMap w[3];   // Wq, Wk, Wv: [D, D], boxes [64 rows, 64 columns], 128 B swizzle
};

struct OutMaps {
  CUtensorMap o;      // O as [B*H, T, 48], boxes [1, 64 kWG, 16], 32 B swizzle
  CUtensorMap w;      // Wo: [D, D], boxes [48 rows, 64 columns], 128 B swizzle
};

// grid (3 D / kBN column tiles, row tiles of 64 kWG)
template <int kWG, int kBN>
__global__ void __launch_bounds__(kWG * kThreads)
qkv_kernel(const __grid_constant__ QkvMaps maps, QkvArgs a) {
  using Tile = QkvTile<kWG, kBN>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Tile::kStages], empty[Tile::kStages];
  const int tiles_per_w = a.d / kBN;
  const int which = blockIdx.x / tiles_per_w;   // 0: q, 1: k, 2: v
  const int n0 = (blockIdx.x % tiles_per_w) * kBN;
  const int m0 = blockIdx.y * Tile::kBM;
  const int wg = threadIdx.x / kThreads;
  const CUtensorMap* map_a = &maps.a[which < 2 ? 0 : 1];
  const CUtensorMap* map_w = &maps.w[which];

  float acc[kBN / 2];
  gemm_tma_ring<kWG, kBN, Tile::kBK, Tile::kStages, Tile::kABytes,
                Tile::kBBytes>(
      acc, aligned_smem(smem), full, empty, a.d / Tile::kBK,
      [&](uint32_t sa, uint32_t sb, int kt, uint32_t bar) {
        tma_load_2d(sa, map_a, kt * Tile::kBK, m0, bar);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load_2d(sb + j * Tile::kBK * 128, map_w, n0 + 64 * j,
                      kt * Tile::kBK, bar);
      },
      [&](uint32_t sa, int kk) {
        return swizzled_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024,
                             kSwizzle128);
      },
      [&](uint32_t sb, int kk) { return weight_desc<Tile::kBK>(sb, kk); });

  const int row0 = m0 + wg * 64;
  bf16* out = a.out[which];
  store_tile_chunks<kBN>(acc, a.bias[which] + n0,
                         [&](int row, int chunk, uint4 val) {
    const int m = row0 + row;
    if (m >= a.m) return;
    const int n = n0 + chunk * 8;        // 8 columns never straddle a head
    const int b = m / a.t, t = m % a.t;
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * a.n_heads + n / kD) * a.t + t) * kD + n % kD) = val;
  });
}

// grid (D / kBN column tiles, B * row tiles of 64 kWG per batch element)
template <int kWG, int kBN, int kRes>
__global__ void __launch_bounds__(kWG * kThreads)
out_proj_kernel(const __grid_constant__ OutMaps maps, OutArgs a) {
  using Tile = OutTile<kWG, kBN>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Tile::kStages], empty[Tile::kStages];
  const int tiles_per_b = (a.t + Tile::kBM - 1) / Tile::kBM;
  const int b = blockIdx.y / tiles_per_b;
  const int t0 = (blockIdx.y % tiles_per_b) * Tile::kBM;
  const int n0 = blockIdx.x * kBN;
  const int wg = threadIdx.x / kThreads;
  constexpr int kBoxA = Tile::kBM * 32;   // one 16-column box of O

  float acc[kBN / 2];
  gemm_tma_ring<kWG, kBN, Tile::kBK, Tile::kStages, Tile::kABytes,
                Tile::kBBytes>(
      acc, aligned_smem(smem), full, empty, a.n_heads / Tile::kHeads,
      [&](uint32_t sa, uint32_t sb, int kt, uint32_t bar) {
        const int h0 = kt * Tile::kHeads;
        // box i: columns 16 (i % 3) .. 16 (i % 3) + 15 of head h0 + i / 3
#pragma unroll
        for (int i = 0; i < Tile::kBK / 16; ++i)
          tma_load_3d(sa + i * kBoxA, &maps.o, 16 * (i % 3), t0,
                      b * a.n_heads + h0 + i / 3, bar);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load_2d(sb + j * Tile::kBK * 128, &maps.w, n0 + 64 * j,
                      h0 * kD, bar);
      },
      [&](uint32_t sa, int kk) {
        return swizzled_desc(sa + kk * kBoxA + wg * 64 * 32, 16, 256,
                             kSwizzle32);
      },
      [&](uint32_t sb, int kk) { return weight_desc<Tile::kBK>(sb, kk); });

  const int row0 = t0 + wg * 64;
  auto put = [&](int row, int chunk, uint4 val) {
    const int t = row0 + row;
    if (t >= a.t) return;
    const size_t at = ((size_t)b * a.t + t) * a.d + n0 + chunk * 8;
    if (kRes == kBf16Residual) {
      // the module output is rounded to bf16 first, then the residual is
      // added in bf16 (rounded once more)
      float y[8], res[8];
      unpack8(val, y);
      unpack8(*reinterpret_cast<const uint4*>(a.residual + at), res);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = __fadd_rn(y[e], res[e]);
      val = pack8(y);
    }
    *reinterpret_cast<uint4*>(a.out + at) = val;
  };
  if constexpr (kRes == kFp32Residual) {
    // x's bf16 pair at each of this thread's accumulator positions (rows g
    // and g + 8 of its warp, columns 8 j + 2 l, + 1), widened and added to
    // acc + bo in fp32 before the one rounding
    const int l = threadIdx.x & 3;
    const int t_lo = row0 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
    const int t_hi = t_lo + 8;
    const bf16* x_lo = a.residual + ((size_t)b * a.t + t_lo) * a.d + n0 + 2 * l;
    const bf16* x_hi = x_lo + 8 * (size_t)a.d;
    auto widen = [](const bf16* p, bool in) {
      return in ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
                : make_float2(0.f, 0.f);
    };
    uint32_t lo[kBN / 8], hi[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(a.bias + n0 + 8 * j + 2 * l);
      const float2 xl = widen(x_lo + 8 * j, t_lo < a.t);
      const float2 xh = widen(x_hi + 8 * j, t_hi < a.t);
      lo[j] = pack_bf16((acc[4 * j] + bb.x) + xl.x,
                        (acc[4 * j + 1] + bb.y) + xl.y);
      hi[j] = pack_bf16((acc[4 * j + 2] + bb.x) + xh.x,
                        (acc[4 * j + 3] + bb.y) + xh.y);
    }
    put_chunks<kBN>(lo, hi, put);
  } else {
    store_tile_chunks<kBN>(acc, a.bias + n0, put);
  }
}

// ---------------------------------------------------------------------------
// host side: the tensor maps of one call and the launch
// ---------------------------------------------------------------------------

// the C entry points' arguments
QkvArgs qkv_args(const void* xr, const void* xv, const void* wq,
                 const void* wk, const void* wv, const void* bq,
                 const void* bk, const void* bv, void* q, void* k, void* v,
                 int batch, int t, int d, int n_heads) {
  QkvArgs a;
  a.xr = static_cast<const bf16*>(xr);
  a.xv = static_cast<const bf16*>(xv);
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  a.bias[0] = static_cast<const float*>(bq);
  a.bias[1] = static_cast<const float*>(bk);
  a.bias[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  a.m = batch * t;
  a.t = t;
  a.d = d;
  a.n_heads = n_heads;
  return a;
}

OutArgs out_args(const void* o, const void* wo, const void* bo,
                 const void* residual, void* out, int t, int d, int n_heads) {
  OutArgs a;
  a.o = static_cast<const bf16*>(o);
  a.w = static_cast<const bf16*>(wo);
  a.bias = static_cast<const float*>(bo);
  a.residual = static_cast<const bf16*>(residual);
  a.out = static_cast<bf16*>(out);
  a.t = t;
  a.d = d;
  a.n_heads = n_heads;
  return a;
}

template <int kWG, int kBN>
cudaError_t launch_qkv(const QkvArgs& a, cudaStream_t s) {
  using Tile = QkvTile<kWG, kBN>;
  QkvMaps maps;
  bool ok = matrix_map(&maps.a[0], a.xr, a.m, a.d, Tile::kBM) &&
            matrix_map(&maps.a[1], a.xv, a.m, a.d, Tile::kBM);
  for (int i = 0; i < 3; ++i)
    ok = ok && matrix_map(&maps.w[i], a.w[i], a.d, a.d, Tile::kBK);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid(3 * a.d / kBN, (a.m + Tile::kBM - 1) / Tile::kBM);
  return launch<qkv_kernel<kWG, kBN>>(grid, kWG * kThreads, Tile::kSmem, s,
                                     maps, a);
}

template <int kWG, int kBN, int kRes>
cudaError_t launch_out(const OutArgs& a, int batch, cudaStream_t s) {
  using Tile = OutTile<kWG, kBN>;
  OutMaps maps;
  const cuuint64_t dims[3] = {kD, (cuuint64_t)a.t,
                              (cuuint64_t)batch * a.n_heads};
  const cuuint64_t strides[2] = {kD * 2, (cuuint64_t)a.t * kD * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)Tile::kBM, 1};
  if (!bf16_map(&maps.o, a.o, 3, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_32B) ||
      !matrix_map(&maps.w, a.w, a.d, a.d, Tile::kBK))
    return cudaErrorInvalidValue;
  dim3 grid(a.d / kBN, batch * ((a.t + Tile::kBM - 1) / Tile::kBM));
  return launch<out_proj_kernel<kWG, kBN, kRes>>(grid, kWG * kThreads,
                                                 Tile::kSmem, s, maps, a);
}

}  // namespace
