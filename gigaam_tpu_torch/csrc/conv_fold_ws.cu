// The conv-module fold probe (P5) redesigned for Hopper (sm_90a): a row pass,
// the GLU product and the pointwise product on conv_ws.cuh's ping-pong core,
// and between them the depthwise pass on the CUDA cores.
//
// It replaces the Pallas probe benchmarks/pallas_conv_fold_probe.py::
// conv_lnres_folded (the body _conv_lnres_kernel), as fold_probes.cu's
// glu_fold_kernel + dw_proj_kernel did (kept there for an A/B on the same
// card), and computes the same function with the same rounding points
// (the kept kernels' products in the same order of K and their fused taps;
// the sigmoid and SiLU by the fast division, see below), for x [B, T, 768]
// bf16, rows m = b T + t:
//   ffn_ws.cu's ffn_rows_kernel   xn = bf16(LN(x))            (fp32, eps 1e-5)
//   conv_fold_ws_kernel<kGlu>     y = bf16((xn Wv + bv) sigmoid(xn Wg + bg)),
//                                 0 where valid[m] is 0
//   conv_dw_kernel                c = bf16(SiLU(bns dw31(y) + bnb)) (31 fp32
//                                 taps in order of k, zero outside [0, T) of
//                                 each batch element)
//   conv_fold_ws_kernel<kResidual>  out = bf16(bf16(c W2 + b2) + x)
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35
// TB/s): 6 * 768 * 768 = 3.5 M tensor operations and ~85 fp32 operations a
// channel (62 of them the taps) a row against 3 KB of the row's bytes, so
// operations (0.0364 ms at M 8000).
//
// What held the kept kernels back, and what this design does:
//   * glu_fold_kernel was one block a 64 x 256 tile, not persistent; each of
//     a row tile's three column-group blocks ran the tile's LayerNorm again
//     in its prologue, each K item's products were drained before its stage
//     was released, and thread 0 issued the refills.  dw_proj_kernel ran the
//     31 taps of all 768 channels on every thread of the block while the
//     tensor cores idled, and only then the W2 product.
//   * Here the LayerNorm is a row pass of its own (P4's), and both products
//     run on PingPongCore: a producer warp issuing TMA copies, two consumer
//     warpgroups that each own whole 64-row tiles and take turns on the
//     tensor cores (one's epilogue under the other's products), a
//     persistent grid walking probes/ws_plan.py::ws_plan's units with K
//     unsplit (12 items of 64), 64 x 256 tiles in clusters of two that
//     multicast half of each weight box.  That is the schedule that took
//     P6/P7's products (K 768 as here) fastest at B 16, T 500 and B 128,
//     T 768 for N 2304 and at B 128 for N 768 in the attention fold's study;
//     unshared ping-pong tiles were 9% ahead at B 16 for N 768, not worth a
//     second instance.
//   * The GLU: prepare_conv interleaves Wv and Wg into W_vg [768, 1536] in
//     blocks of 128 columns (tile c: Wv's columns 128 c .. then Wg's), so
//     that a consumer's accumulator holds the value and the gate of the
//     same 128 channels in the same thread: columns 8 j + 2 l and
//     8 (j + 16) + 2 l of the m64n256 fragment.  A 256-wide tile yields 128
//     channels of y.
//   * The epilogues divide with __fdividef: with the IEEE division of the
//     kept kernels, the GLU's sigmoid, not the products, bounded the GLU
//     product (0.057 ms with it, 0.039 without, at B 16, T 500 on an H100
//     by chip_smoke.py's fold-probe phase).
//   * The depthwise pass: one block a (64-frame tile, 128-channel slice,
//     batch element), so that no window reads the next element's frames;
//     the y window [94, 128] comes in by 16-byte loads into shared memory,
//     each thread holds its channel's 31 taps in registers and meets each
//     window row once with every one of its 32 output frames that the row
//     reaches: one channel a thread takes 80 registers, three blocks an SM
//     (two channels took 128, two blocks).  y is read and c written once:
//     2 * M * 768 * 2 bytes, mostly from L2.
//   * Why the taps do not feed the W2 product as an A-producer warpgroup: a
//     unit covering all 768 output columns needs two consumers at 64 x 384
//     (192 accumulator registers each), leaving under 40 a thread for the
//     tap warpgroup, whose taps alone take 62; with 256-wide units the taps
//     would be recomputed three times.

#include "conv_ws.cuh"

using namespace gigaam;

namespace {

constexpr int kModel = 768;
constexpr int kBK = 64;
constexpr int kTaps = 31, kHalo = kTaps / 2;
// the products: 64 x 256 tiles, five stages, clusters of two
constexpr int kBN = 256, kCluster = 2;
using Core = PingPongCore<kBN, 5, kCluster>;

// the products' epilogues
enum Mode { kGlu = 1, kResidual = 2 };

struct Maps {
  CUtensorMap a;          // [M, 768] (xn or c), boxes [64 rows, 64 columns]
  CUtensorMap b;          // [768, N] (W_vg or W2), boxes [32 rows, 64 columns]
};

struct Args {
  const int4* units;      // the plan (conv_ws.cuh), n_units of them
  const float* bias;      // [768] fp32: bv (kGlu) or b2 (kResidual)
  const float* gate_bias; // [768] fp32: bg (kGlu)
  const uint8_t* valid;   // [M], 0 or 1 (kGlu)
  const bf16* x;          // [M, 768]: the residual (kResidual)
  bf16* out;              // [M, 768]: y (kGlu) or the output
  int n_units, m;
};

// v sigmoid(g) and v sigmoid(v), fp32, with the fast division
__device__ __forceinline__ float glu(float v, float g) {
  return __fdividef(v, 1.f + __expf(-g));
}

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// bf16(y + x) over a chunk of eight values already rounded to bf16
__device__ __forceinline__ uint4 add_residual(uint4 y, uint4 x) {
  float fy[8], fx[8];
  unpack8(y, fy);
  unpack8(x, fx);
#pragma unroll
  for (int e = 0; e < 8; ++e) fy[e] = __fadd_rn(fy[e], fx[e]);
  return pack8(fy);
}

// A consumer's [64, 256] accumulator of rows r0 .. and W_vg's column tile
// of channels c0 .. c0 + 127 (values at fragment columns 8 j + 2 l, gates at
// 8 (j + 16) + 2 l): y, zeroed on padded rows, into out [M, 768]
__device__ __forceinline__ void store_glu(const float (&acc)[128],
                                          const Args& a, int r0, int c0) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const bool keep_lo = g < a.m && a.valid[g];
  const bool keep_hi = g + 8 < a.m && a.valid[g + 8];
  uint32_t lo[16], hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * l;
    const float2 bv = *reinterpret_cast<const float2*>(a.bias + col);
    const float2 bg = *reinterpret_cast<const float2*>(a.gate_bias + col);
    lo[j] = pack_bf16(glu(acc[4 * j] + bv.x, acc[4 * j + 64] + bg.x),
                      glu(acc[4 * j + 1] + bv.y, acc[4 * j + 65] + bg.y));
    hi[j] = pack_bf16(glu(acc[4 * j + 2] + bv.x, acc[4 * j + 66] + bg.x),
                      glu(acc[4 * j + 3] + bv.y, acc[4 * j + 67] + bg.y));
  }
  put_chunks<128>(lo, hi, [&](int r, int chunk, uint4 val) {
    const int m = r0 + r;
    if (m >= a.m) return;
    if (!(((r >> 3) & 1) ? keep_hi : keep_lo)) val = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(a.out + (size_t)m * kModel + c0 + chunk * 8) =
        val;
  });
}

// A consumer's [64, 256] accumulator of rows r0 .., columns n0 ..:
// bf16(bf16(acc + b2) + x) into out [M, 768].  put_chunks' order: round r
// of eight stores the 16-byte chunk 4 r + l of rows g and g + 8 of the
// warp's 16; the residual's chunks are all loaded before the first store,
// so that their reads overlap.
__device__ __forceinline__ void store_residual(const float (&acc)[128],
                                               const Args& a, int r0,
                                               int n0) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  uint4 res[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = g + 8 * (i & 1);
    res[i] = m < a.m ? *reinterpret_cast<const uint4*>(
                           a.x + (size_t)m * kModel + n0 + (4 * (i >> 1) + l) * 8)
                     : make_uint4(0, 0, 0, 0);
  }
  uint32_t lo[32], hi[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 bb =
        *reinterpret_cast<const float2*>(a.bias + n0 + 8 * j + 2 * l);
    lo[j] = pack_bf16(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    hi[j] = pack_bf16(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = g + 8 * (i & 1), rr = 4 * (i >> 1);
    const uint32_t(&half)[32] = (i & 1) ? hi : lo;
    const uint4 val = add_residual(
        quad_gather(half[rr], half[rr + 1], half[rr + 2], half[rr + 3], l),
        res[i]);
    if (m < a.m)
      *reinterpret_cast<uint4*>(a.out + (size_t)m * kModel + n0 +
                                (rr + l) * 8) = val;
  }
}

// one block an SM in clusters of two, 384 threads: two consumer
// warpgroups, then the producer's
template <int kMode>
__global__ void __launch_bounds__(Core::kThreads, 1)
conv_fold_ws_kernel(const __grid_constant__ Maps maps,
                    const __grid_constant__ Args a) {
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
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss_tb<kBN>(acc, Core::a_desc(sa, kk), weight_desc<kBK>(sb, kk));
      },
      [&](const float (&acc)[kBN / 2], int4 unit) {
        if constexpr (kMode == kGlu)
          store_glu(acc, a, unit.x * Core::kBM, unit_col(unit) * kBN / 2);
        else
          store_residual(acc, a, unit.x * Core::kBM, unit_col(unit) * kBN);
      });
}

// ---------------------------------------------------------------------------
// the depthwise pass
// ---------------------------------------------------------------------------

constexpr int kDwRows = 64;                   // frames a block
constexpr int kDwSlice = 128;                 // channels a block
constexpr int kDwGroup = 32;                  // frames a thread
constexpr int kDwThreads = kDwSlice * kDwRows / kDwGroup;
constexpr int kWin = kDwRows + 2 * kHalo;     // the y window's frames

// grid (frame tiles of 64, 768 / 128 channel slices, B): the block's output
// is c at frames t0 .. t0 + 63 of batch element b, channels ch0 .. ch0 +
// 127.  Thread (p = thread % 128, g = thread / 128) computes channel ch0 + p
// at frames t0 + 32 g .. t0 + 32 g + 31.
__global__ void __launch_bounds__(kDwThreads)
conv_dw_kernel(const bf16* __restrict__ y, const float* __restrict__ dw,
               const float* __restrict__ bns, const float* __restrict__ bnb,
               bf16* __restrict__ c, int t) {
  // the y window [kWin frames, kDwSlice channels] bf16
  __shared__ __align__(16) unsigned char win[kWin * kDwSlice * 2];
  const int t0 = blockIdx.x * kDwRows, ch0 = blockIdx.y * kDwSlice;
  // batch element b's frame 0, the slice's channel 0
  const size_t first = (size_t)blockIdx.z * t * kModel + ch0;
  for (int u = threadIdx.x; u < kWin * kDwSlice / 8; u += kDwThreads) {
    const int r = u / (kDwSlice / 8), q = u % (kDwSlice / 8);
    const int tt = t0 - kHalo + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tt >= 0 && tt < t)
      val = *reinterpret_cast<const uint4*>(y + first + (size_t)tt * kModel +
                                            8 * q);
    *reinterpret_cast<uint4*>(win + (r * kDwSlice + 8 * q) * 2) = val;
  }
  const int p = threadIdx.x % kDwSlice, g = threadIdx.x / kDwSlice;
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = dw[k * kModel + ch0 + p];
  __syncthreads();
  float acc[kDwGroup];
#pragma unroll
  for (int i = 0; i < kDwGroup; ++i) acc[i] = 0.f;
  // window row kDwGroup g + j meets output frame i at tap k = j - i, in
  // order of k
#pragma unroll
  for (int j = 0; j < kDwGroup + kTaps - 1; ++j) {
    const float yv = __bfloat162float(*reinterpret_cast<const bf16*>(
        win + ((kDwGroup * g + j) * kDwSlice + p) * 2));
#pragma unroll
    for (int i = 0; i < kDwGroup; ++i) {
      const int k = j - i;
      if (k >= 0 && k < kTaps) acc[i] = fmaf(yv, w[k], acc[i]);
    }
  }
  const float sc = bns[ch0 + p], bi = bnb[ch0 + p];
#pragma unroll
  for (int i = 0; i < kDwGroup; ++i) {
    const int tt = t0 + kDwGroup * g + i;
    if (tt < t)
      c[first + (size_t)tt * kModel + p] =
          __float2bfloat16(silu(acc[i] * sc + bi));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int kMode>
cudaError_t launch_product(int grid, cudaStream_t s, const Maps& maps,
                           const Args& a) {
  cudaError_t err = ws_opt_in<Core, conv_fold_ws_kernel<kMode>>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<Core, kCluster>(grid, s,
                                                                  &attr);
  err = cudaLaunchKernelEx(&cfg, conv_fold_ws_kernel<kMode>, maps, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// One product of the redesign, epilogue `mode`: 1, y [M, 768] =
// bf16((a . w_vg)_value + bv) sigmoid((a . w_vg)_gate + bg)), 0 where
// valid[m] is 0, with w_vg [768, 1536] interleaved in blocks of 128 columns
// (value, gate); 2, out [M, 768] = bf16(bf16(a . w2 + b2) + x), w2
// [768, 768].  a [M, 768] bf16; bias (bv or b2), gate_bias (bg) [768] fp32;
// valid [M] bytes (mode 1), x [M, 768] bf16 (mode 2); every matrix bf16,
// row-major, 16-byte aligned; units: the plan (conv_ws.cuh; probes/
// ws_plan.py::ws_plan with one K split for 64-row tiles paired in clusters
// of two and 256-wide column tiles), n_units int4 on the card; grid blocks
// (even).  Returns cudaErrorInvalidValue for arguments or tensor maps it
// cannot take, else the first CUDA error of the opt-in and the launch.
int gigaam_conv_ws_product(const void* a_ptr, const void* w, const void* bias,
                           const void* gate_bias, const void* valid,
                           const void* x, void* out, const void* units,
                           int n_units, int grid, int m, int mode,
                           void* stream) {
  if (m < 1 || n_units < 1 || grid < 1 || grid % kCluster ||
      (mode != kGlu && mode != kResidual))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  if (!matrix_map(&maps.a, a_ptr, m, kModel, Core::kBM) ||
      !matrix_map(&maps.b, w, kModel, mode == kGlu ? 2 * kModel : kModel,
                  kBK / kCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.units = static_cast<const int4*>(units);
  a.bias = static_cast<const float*>(bias);
  a.gate_bias = static_cast<const float*>(gate_bias);
  a.valid = static_cast<const uint8_t*>(valid);
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.n_units = n_units;
  a.m = m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == kGlu
                              ? launch_product<kGlu>(grid, s, maps, a)
                              : launch_product<kResidual>(grid, s, maps, a));
}

// The depthwise pass: c [B, T, 768] = bf16(SiLU(bns dw31(y) + bnb)) of y
// [B, T, 768] bf16 (zero on padded frames), dw [31, 768] fp32 (tap k of
// channel ch at k 768 + ch), bns, bnb [768] fp32; 16-byte aligned.
// Returns the launch's CUDA error code.
int gigaam_conv_ws_depthwise(const void* y, const void* dw, const void* bns,
                             const void* bnb, void* c, int batch, int t,
                             void* stream) {
  if (batch < 1 || t < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  conv_dw_kernel<<<dim3((t + kDwRows - 1) / kDwRows, kModel / kDwSlice,
                        batch),
                   kDwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(dw),
      static_cast<const float*>(bns), static_cast<const float*>(bnb),
      static_cast<bf16*>(c), t);
  return static_cast<int>(cudaGetLastError());
}

// out[0]: how many blocks of the products' kernel the card holds at once
// (clusters of two at once, times two), the persistent grid's ceiling.
// Returns a CUDA error code.
int gigaam_conv_ws_slots(int* out) {
  cudaError_t err = ws_opt_in<Core, conv_fold_ws_kernel<kGlu>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<Core, kCluster>(
      kCluster * (sm_count() > 0 ? sm_count() : 132), nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, conv_fold_ws_kernel<kGlu>,
                                       &cfg);
  out[0] = clusters * kCluster;
  return static_cast<int>(err);
}

// For conv_fold_ws_kernel<1>, <2> and conv_dw_kernel: out[2 i] the dynamic
// shared memory in bytes, out[2 i + 1] how many blocks one SM holds at a
// time.  Returns a CUDA error code.
int gigaam_conv_fold_ws_occupancy(int* out) {
  const cudaError_t errs[] = {
      occupancy(conv_fold_ws_kernel<kGlu>, Core::kThreads, Core::kSmem, out),
      occupancy(conv_fold_ws_kernel<kResidual>, Core::kThreads, Core::kSmem,
                out + 2),
      occupancy(conv_dw_kernel, kDwThreads, 0, out + 4)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
