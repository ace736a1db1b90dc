// The FFN fold probe (P4) redesigned for Hopper (sm_90a): a row pass and two
// products on conv_ws.cuh's warp-specialised, persistent GEMM core.
//
// It replaces the Pallas probe benchmarks/pallas_ffn_fold_probe.py::
// ffn_lnres_folded (the body _ffn_lnres_kernel), as fold_probes.cu's
// ffn_fold_kernel did (kept there for an A/B on the same card), and computes
// the same function with the same rounding points, for the rows m of x
// [M, 768] bf16:
//   ffn_rows_kernel            xn = bf16(LN(x))               (fp32, eps 1e-5)
//   ffn_ws_kernel<kSiluBias>   h = bf16(SiLU(xn W1 + b1))     (fp32 SiLU)
//   ffn_ws_kernel<kResidual>   out = bf16(bf16(0.5 (h W2 + b2)) + x)
// and, where the plan splits K, ffn_reduce_kernel<mode>: the splits' fp32
// partials summed in order, then the same epilogue.
//
// Bound on the card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): 4 * 768 * 3072
// = 9.4 M tensor operations a row against 3 KB of the row's bytes, so
// operations (0.0792 ms at M 8000).
//
// What held ffn_fold_kernel back, and what this design does:
//   * A block held 64 rows and walked d_ff in chunks of 64 with h in shared
//     memory, so it read all 9.4 MB of W1 and W2 from L2 for every 64 rows
//     (64 operations a byte of L2), and each warpgroup's h-chunk product was
//     N = 32 wide, bound by shared memory.  Thread 0 issued every refill
//     after all warps had waited, and each item's products were drained
//     before the stage was released.  Its products ran at 225 TFLOP/s.
//   * The [64, 768] fp32 accumulator of the fused product already took 192
//     registers a thread in each of two warpgroups, so the fold cannot take
//     wider rows.  Here the fold is given up: h [M, 3072] bf16 is written
//     once and read once (49 MB at M 8000, mostly from the 50 MB L2), and
//     both products run on WsCore<256, 2, true>: a producer warpgroup at 40
//     registers issuing TMA copies, two consumer warpgroups at 232 with one
//     K item's products in flight, 128 x 256 tiles (85 operations a byte of
//     L2), a persistent grid walking the caller's static plan
//     (probes/ws_plan.py::ws_plan) and the weights' boxes multicast to a
//     cluster of two, which halves their L2 reads.
//   * The row pass is one warp a row (ln_rows' arithmetic of fold_probes.cu,
//     written to device memory instead of shared memory).

#include "conv_ws.cuh"

using namespace gigaam;

namespace {

constexpr int kModel = 768;
constexpr int kBK = 64;
constexpr int kRowWarps = 8;         // rows a block of the row pass
using Core = WsCore<256, 2, true>;

// the products' epilogues
enum Mode { kSiluBias = 1, kResidual = 2 };

struct Maps {
  CUtensorMap a;          // [M, K], boxes [128 rows, 64 columns]
  CUtensorMap b;          // [K, N], boxes [64 rows, 64 columns]
};

struct Args {
  const int4* units;      // the plan (conv_ws.cuh), n_units of them
  const float* bias;      // [N] fp32
  const bf16* x;          // [M, N]: the residual (kResidual)
  bf16* out;              // [M, N]
  float* partial;         // [splits, M, N] fp32 where splits > 1
  int n_units, m, n, splits;
};

// v sigmoid(v) with the fast division: with the IEEE one the epilogue, not
// the products, bounded the W1 product
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the epilogue of one output pair before rounding: SiLU(v + b) or
// 0.5 (v + b)
template <int kMode>
__device__ __forceinline__ float finish(float v, float b) {
  return kMode == kSiluBias ? silu(v + b) : 0.5f * (v + b);
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

// This consumer warpgroup's [64, 256] accumulator of the unit's tile: the
// epilogue to bf16 with one split, else fp32 to the unit's split of the
// partials.  put_chunks' order: round r of eight stores the 16-byte chunk
// 4 r + l of rows g and g + 8 of the warp's 16.  The residual's chunks are
// all loaded before the first store, so that their reads overlap (a store
// in between would order each read behind it).
template <int kMode>
__device__ __forceinline__ void store_tile(const float (&acc)[128],
                                           const Args& a, int4 unit) {
  const int n0 = unit_col(unit) * 256;
  const int r0 = unit.x * Core::kBM + (threadIdx.x / 128) * 64;
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  if (a.splits == 1) {
    uint4 res[16];
    if (kMode == kResidual) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int m = g + 8 * (i & 1);
        res[i] = m < a.m
                     ? *reinterpret_cast<const uint4*>(
                           a.x + (size_t)m * a.n + n0 + (4 * (i >> 1) + l) * 8)
                     : make_uint4(0, 0, 0, 0);
      }
    }
    uint32_t lo[32], hi[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(a.bias + n0 + 8 * j + 2 * l);
      lo[j] = pack_bf16(finish<kMode>(acc[4 * j], bb.x),
                        finish<kMode>(acc[4 * j + 1], bb.y));
      hi[j] = pack_bf16(finish<kMode>(acc[4 * j + 2], bb.x),
                        finish<kMode>(acc[4 * j + 3], bb.y));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = g + 8 * (i & 1), rr = 4 * (i >> 1);
      const uint32_t(&half)[32] = (i & 1) ? hi : lo;
      uint4 val = quad_gather(half[rr], half[rr + 1], half[rr + 2],
                              half[rr + 3], l);
      if (kMode == kResidual) val = add_residual(val, res[i]);
      if (m < a.m)
        *reinterpret_cast<uint4*>(a.out + (size_t)m * a.n + n0 +
                                  (rr + l) * 8) = val;
    }
    return;
  }
  // acc[4 j], acc[4 j + 1] of row g and acc[4 j + 2], acc[4 j + 3] of row
  // g + 8, columns 8 j + 2 l, + 1
  float* p = a.partial + (size_t)unit_split(unit) * a.m * a.n + n0 + 2 * l;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (g < a.m)
      *reinterpret_cast<float2*>(p + (size_t)g * a.n + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (g + 8 < a.m)
      *reinterpret_cast<float2*>(p + (size_t)(g + 8) * a.n + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// one block an SM (in clusters of two), 384 threads: two consumer
// warpgroups, then the producer's
template <int kMode>
__global__ void __launch_bounds__(Core::kThreads, 1)
ffn_ws_kernel(const __grid_constant__ Maps maps,
              const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  Core::run(
      smem, full, empty, a.units, a.n_units, &maps.b,
      [&](int4 unit, int item, uint32_t sa, uint32_t bar) {
        tma_load_2d(sa, &maps.a, item * kBK, unit.x * Core::kBM, bar);
      },
      [&](const float (&acc)[128], int4 unit) {
        store_tile<kMode>(acc, a, unit);
      });
}

// out = the epilogue of the sum of the splits' partials, 4 values a thread
template <int kMode>
__global__ void __launch_bounds__(256)
ffn_reduce_kernel(const float* partial, const float* bias, const bf16* x,
                  bf16* out, int mn4, int n, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn4;
       i += gridDim.x * blockDim.x) {
    float4 sum = reinterpret_cast<const float4*>(partial)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v =
          reinterpret_cast<const float4*>(partial)[(size_t)s * mn4 + i];
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(bias + (4 * i) % n);
    float y[4] = {finish<kMode>(sum.x, b.x), finish<kMode>(sum.y, b.y),
                  finish<kMode>(sum.z, b.z), finish<kMode>(sum.w, b.w)};
    if (kMode == kResidual) {
      const uint2 xx = reinterpret_cast<const uint2*>(x)[i];
      const float2 x0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xx.x));
      const float2 x1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xx.y));
      y[0] = __fadd_rn(round_bf16(y[0]), x0.x);
      y[1] = __fadd_rn(round_bf16(y[1]), x0.y);
      y[2] = __fadd_rn(round_bf16(y[2]), x1.x);
      y[3] = __fadd_rn(round_bf16(y[3]), x1.y);
    }
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  }
}

// xn[row] = bf16(LN(x[row])) for M rows of 768, one warp a row: lane l holds
// the row's 16-byte chunks l, l + 32, l + 64 (ln_rows' arithmetic)
__global__ void __launch_bounds__(32 * kRowWarps)
ffn_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, bf16* __restrict__ xn, int m) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= m) return;
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
    *reinterpret_cast<uint4*>(xn + (size_t)row * kModel + q * 8) = pack8(v[i]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int kMode>
cudaError_t opt_in() {
  return ws_opt_in<Core, ffn_ws_kernel<kMode>>();
}

// the product's persistent launch, then the partials' reduction where K is
// split
template <int kMode>
cudaError_t launch_product(int grid, cudaStream_t s, const Maps& maps,
                           const Args& a) {
  cudaError_t err = opt_in<kMode>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<Core, 2>(grid, s, &attr);
  err = cudaLaunchKernelEx(&cfg, ffn_ws_kernel<kMode>, maps, a);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess ||
      a.splits == 1)
    return err;
  const int mn4 = a.m * a.n / 4;
  const size_t blocks = (static_cast<size_t>(mn4) + 255) / 256;
  const size_t cap = static_cast<size_t>(sm_count() > 0 ? sm_count() : 132) * 8;
  ffn_reduce_kernel<kMode><<<static_cast<int>(blocks < cap ? blocks : cap),
                             256, 0, s>>>(a.partial, a.bias, a.x, a.out, mn4,
                                          a.n, a.splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, xn: [M, 768] bf16; ln_g, ln_b: [768] fp32; M >= 1; 16-byte aligned.
// Returns the launch's CUDA error code.
int gigaam_ffn_ws_rows(const void* x, const void* ln_g, const void* ln_b,
                       void* xn, int m, void* stream) {
  ffn_rows_kernel<<<(m + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<bf16*>(xn), m);
  return static_cast<int>(cudaGetLastError());
}

// out [M, N] = the epilogue `mode` (1: bf16(SiLU(a . b + bias)); 2:
// bf16(bf16(0.5 (a . b + bias)) + x)) of a [M, K] . b [K, N]: a, b, x, out
// bf16, row-major, 16-byte aligned, bias [N] fp32; K a multiple of 64, N of
// 256; units: the plan (conv_ws.cuh), n_units int4 on the card, for row
// tiles of 128 paired in clusters of two and column tiles of 256; grid
// blocks (even); with splits > 1 partial [splits, M, N] fp32 scratch.
// Returns the first CUDA error code of the tensor maps, the opt-in and the
// launches.
int gigaam_ffn_ws_product(const void* a_ptr, const void* b_ptr,
                          const void* bias, const void* x, void* out,
                          void* partial, const void* units, int m, int n,
                          int k, int n_units, int grid, int splits, int mode,
                          void* stream) {
  Maps maps;
  if (!matrix_map(&maps.a, a_ptr, m, k, Core::kBM) ||
      !matrix_map(&maps.b, b_ptr, k, n, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.units = static_cast<const int4*>(units);
  a.bias = static_cast<const float*>(bias);
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.n_units = n_units;
  a.m = m;
  a.n = n;
  a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSiluBias: return static_cast<int>(
        launch_product<kSiluBias>(grid, s, maps, a));
    case kResidual: return static_cast<int>(
        launch_product<kResidual>(grid, s, maps, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0]: how many clusters of two the card holds at a time for the
// products, which caps their persistent grid.  Returns a CUDA error code.
int gigaam_ffn_ws_max_clusters(int* out) {
  const cudaError_t err = opt_in<kSiluBias>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<Core, 2>(
      2 * (sm_count() > 0 ? sm_count() : 132), nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, ffn_ws_kernel<kSiluBias>, &cfg));
}

// For ffn_ws_kernel<1>, ffn_ws_kernel<2>: out[2 i] the dynamic shared
// memory in bytes, out[2 i + 1] how many blocks one SM holds at a time.
// Returns a CUDA error code.
int gigaam_ffn_ws_occupancy(int* out) {
  cudaError_t err;
  if ((err = opt_in<kSiluBias>()) != cudaSuccess ||
      (err = opt_in<kResidual>()) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[1], ffn_ws_kernel<kSiluBias>, Core::kThreads, Core::kSmem)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[3], ffn_ws_kernel<kResidual>, Core::kThreads, Core::kSmem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  out[0] = out[2] = Core::kSmem;
  return 0;
}

}  // extern "C"
