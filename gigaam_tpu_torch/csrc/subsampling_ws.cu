// The conv2d-subsampling probes P1 and P2 redesigned for Hopper (sm_90a), on
// conv_ws.cuh's warp-specialised, persistent implicit-GEMM core.
//
// They replace the Pallas kernels of benchmarks/pallas_subsampling_probe.py
// (probe_taps, P1; probe_im2col, P2) as subsampling_probe.cu's taps_kernel,
// patch_kernel and probe_gemm_kernel did, and compute the same functions on
// the same inputs (that file's header sets out the parity blocks, the tap
// table and the stage-2 conv they make up).  Those kernels stay there for an
// A/B on the same card; the wrappers launch these.
//
//   ws_conv_kernel, taps mode (P1, and P2's first product)
//       out[m] = bf16(sum_i tap_i[m] . w[i]) (relu'd where asked) for rows
//       m = (b, t, f) of M = B T 16 and w [9, 768, 768].  A tap's A tile
//       is one 4-D TMA box [1 batch element, 8 steps, 16 frequencies, 64
//       channels] of its block at (t0 + dt, df), as in the ring's taps_kernel:
//       the patch of P2 is never written anywhere, since TMA builds each
//       [128 rows, 64 channels] slice of it in shared memory from the box
//       at the tap's offset.  P2 is this product with the taps with copies
//       (its patch's column order, w [6912, 768] viewed [9, 768, 768]).
//       The box's batch coordinate keeps a tile inside its batch element:
//       steps past T read zeros and are not stored.
//   ws_conv_kernel, GEMM mode (P2's linear)
//       out = bf16(A [M, K] . B [K, N]) with a plain 2-D A map: relu(s2)
//       viewed [B T, 12288] times wl [12288, 768].
//   ws_reduce_kernel
//       where the plan splits K: bf16(sum of the splits' fp32 partials),
//       relu'd where asked, rounded once.
//
// Bounds on the card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): the stage-2
// conv is 9 * 2 * 768 * 768 = 10.6 M operations a row against ~2.5 KB of
// the blocks' bytes and a 10.6 MB weight read once, so it is bounded by
// operations (1.374 ms at B 16, T 500); the linear adds 0.153 ms.  What the
// core does about the ring's limits is in conv_ws.cuh.  The four template
// instances are the design's steps, kept apart so that each can be timed:
// <128, 1, false> a producer warp alone, <128, 1, true> with products in
// flight, <256, 1, true> with 128 x 256 tiles, <256, 2, true> with the
// weights multicast to a cluster of two (a persistent grid or one block a
// unit is the caller's choice).

#include "conv_ws.cuh"

using namespace gigaam;

namespace {

constexpr int kCh = 768;            // channels in and out
constexpr int kFreq = 16;           // output frequencies a time step
constexpr int kNumTaps = 9;
constexpr int kBK = 64;             // K columns an item
constexpr int kSteps = 128 / kFreq; // time steps of a taps tile
constexpr int kChunksK = kCh / kBK; // K items a tap

// The tap table, as subsampling_probe.cu packs it: 4 bits a tap, tap i at
// bits 4 i ..: the block (0 ee, 1 eo, 2 oe, 3 oo), then dt, then df.
struct Tap {
  int block, dt, df;
};

__device__ __forceinline__ Tap tap_of(uint64_t taps, int i) {
  const int code = static_cast<int>(taps >> (4 * i)) & 15;
  return {code & 3, (code >> 2) & 1, code >> 3};
}

struct WsMaps {
  CUtensorMap block[4];  // taps mode: ee, eo, oe, oo as [B, T(+1), 16 | F,
                         // 768], boxes [1, 8, 16, 64]
  CUtensorMap a;         // GEMM mode: [M, K], boxes [128 rows, 64 columns]
  CUtensorMap b;         // [K, N], boxes [64 rows, 64 columns]
};

struct WsArgs {
  const int4* units;     // the plan (conv_ws.cuh), n_units of them
  bf16* out;             // [M, N]
  float* partial;        // [splits, M, N] fp32 where splits > 1
  uint64_t taps;
  int n_units, taps_mode, batch, steps, m, n, splits, relu;
};

// This consumer warpgroup's [64, kBN] accumulator to columns n0 .. of the
// rows row_of(tile row) (-1: not stored): bf16 (relu'd where asked) with
// one split, else fp32 to the unit's slot of the partials.
template <int kBN, typename RowOf>
__device__ __forceinline__ void store_tile(const float (&acc)[kBN / 2],
                                           const WsArgs& a, int n0, int split,
                                           RowOf row_of) {
  const int r0 = (threadIdx.x / 128) * 64;
  if (a.splits == 1) {
    uint32_t lo[kBN / 8], hi[kBN / 8];
    auto f = [&](float v) { return a.relu ? fmaxf(v, 0.f) : v; };
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      lo[j] = pack_bf16(f(acc[4 * j]), f(acc[4 * j + 1]));
      hi[j] = pack_bf16(f(acc[4 * j + 2]), f(acc[4 * j + 3]));
    }
    put_chunks<kBN>(lo, hi, [&](int row, int chunk, uint4 val) {
      const int m = row_of(r0 + row);
      if (m >= 0)
        *reinterpret_cast<uint4*>(a.out + (size_t)m * a.n + n0 + chunk * 8) =
            val;
    });
    return;
  }
  // acc[4 j], acc[4 j + 1] of row g and acc[4 j + 2], acc[4 j + 3] of row
  // g + 8, columns 8 j + 2 l, + 1
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int m_lo = row_of(g), m_hi = row_of(g + 8);
  float* p = a.partial + (size_t)split * a.m * a.n + n0 + 2 * l;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    if (m_lo >= 0)
      *reinterpret_cast<float2*>(p + (size_t)m_lo * a.n + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (m_hi >= 0)
      *reinterpret_cast<float2*>(p + (size_t)m_hi * a.n + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// one block an SM (or a unit), 384 threads: two consumer warpgroups, then
// the producer's
template <int kBN, int kCluster, bool kInflight>
__global__ void __launch_bounds__(WsCore<kBN, kCluster, kInflight>::kThreads, 1)
ws_conv_kernel(const __grid_constant__ WsMaps maps,
               const __grid_constant__ WsArgs a) {
  using Core = WsCore<kBN, kCluster, kInflight>;
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[Core::kStages], empty[Core::kStages];
  // taps mode: a row tile is 8 steps of one batch element
  const int tiles_per_b = a.taps_mode ? (a.steps + kSteps - 1) / kSteps : 1;

  Core::run(
      smem, full, empty, a.units, a.n_units, &maps.b,
      [&](int4 unit, int item, uint32_t sa, uint32_t bar) {
        if (a.taps_mode) {
          const int b = unit.x / tiles_per_b;
          const int t0 = (unit.x % tiles_per_b) * kSteps;
          const Tap tap = tap_of(a.taps, item / kChunksK);
          tma_load_4d(sa, &maps.block[tap.block], (item % kChunksK) * kBK,
                      tap.df, t0 + tap.dt, b, bar);
        } else {
          tma_load_2d(sa, &maps.a, item * kBK, unit.x * Core::kBM, bar);
        }
      },
      [&](const float (&acc)[kBN / 2], int4 unit) {
        const int n0 = unit_col(unit) * kBN;
        if (a.taps_mode) {
          // tile row r is step t0 + r / 16, frequency r % 16
          const int b = unit.x / tiles_per_b;
          const int t0 = (unit.x % tiles_per_b) * kSteps;
          const int row0 = (b * a.steps + t0) * kFreq;
          auto row_of = [&](int r) {
            return b < a.batch && t0 + r / kFreq < a.steps ? row0 + r : -1;
          };
          store_tile<kBN>(acc, a, n0, unit_split(unit), row_of);
        } else {
          const int m0 = unit.x * Core::kBM;
          store_tile<kBN>(acc, a, n0, unit_split(unit), [&](int r) {
            return m0 + r < a.m ? m0 + r : -1;
          });
        }
      });
}

// out = bf16(sum_s partial[s]) (relu'd where asked), 4 values a thread
__global__ void __launch_bounds__(256)
ws_reduce_kernel(const float* partial, bf16* out, int mn4, int splits,
                 int relu) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn4;
       i += gridDim.x * blockDim.x) {
    float4 sum = reinterpret_cast<const float4*>(partial)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v =
          reinterpret_cast<const float4*>(partial)[(size_t)s * mn4 + i];
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    if (relu) {
      sum.x = fmaxf(sum.x, 0.f); sum.y = fmaxf(sum.y, 0.f);
      sum.z = fmaxf(sum.z, 0.f); sum.w = fmaxf(sum.w, 0.f);
    }
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the design's steps, as the wrapper names them (WS_VARIANTS)
enum Variant {
  kMulticast = 0, kWide = 1, kInflight128 = 2, kProducer128 = 3
};

template <int kBN, int kCluster, bool kInflight>
cudaError_t opt_in() {
  return ws_opt_in<WsCore<kBN, kCluster, kInflight>,
                   ws_conv_kernel<kBN, kCluster, kInflight>>();
}

template <int kBN, int kCluster, bool kInflight>
cudaError_t launch_ws(int grid, cudaStream_t s, const WsMaps& maps,
                      const WsArgs& a) {
  cudaError_t err = opt_in<kBN, kCluster, kInflight>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ws_launch_config<WsCore<kBN, kCluster, kInflight>, kCluster>(grid, s,
                                                                  &attr);
  err = cudaLaunchKernelEx(&cfg, ws_conv_kernel<kBN, kCluster, kInflight>,
                           maps, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the variant's launch, then the partials' reduction where K is split
cudaError_t launch(int variant, int grid, cudaStream_t s, const WsMaps& maps,
                   const WsArgs& a) {
  cudaError_t err;
  switch (variant) {
    case kMulticast: err = launch_ws<256, 2, true>(grid, s, maps, a); break;
    case kWide: err = launch_ws<256, 1, true>(grid, s, maps, a); break;
    case kInflight128: err = launch_ws<128, 1, true>(grid, s, maps, a); break;
    case kProducer128: err = launch_ws<128, 1, false>(grid, s, maps, a); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.splits == 1) return err;
  const int mn4 = a.m * a.n / 4;
  const size_t blocks = (static_cast<size_t>(mn4) + 255) / 256;
  const size_t cap = static_cast<size_t>(sm_count() > 0 ? sm_count() : 132) * 8;
  ws_reduce_kernel<<<static_cast<int>(blocks < cap ? blocks : cap), 256, 0,
                     s>>>(a.partial, a.out, mn4, a.splits, a.relu);
  return cudaGetLastError();
}

uint64_t tap_code(const int* taps) {
  uint64_t code = 0;
  for (int i = 0; i < kNumTaps; ++i)
    code |= static_cast<uint64_t>(taps[3 * i] | taps[3 * i + 1] << 2 |
                                  taps[3 * i + 2] << 3) << (4 * i);
  return code;
}

// block `blk` (0 ee, 1 eo, 2 oe, 3 oo) as [B, T(+1), 16 | f_odd, 768],
// boxes [1, 8, 16, 64] with the 128-byte swizzle
bool block_map(CUtensorMap* map, const void* base, int blk, int batch,
               int steps, int f_odd) {
  const cuuint64_t t = steps + (blk >> 1), f = (blk & 1) ? f_odd : kFreq;
  const cuuint64_t dims[4] = {(cuuint64_t)kCh, f, t, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {kCh * 2, f * kCh * 2, t * f * kCh * 2};
  const cuuint32_t box[4] = {64, kFreq, kSteps, 1};
  return bf16_map(map, base, 4, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

WsArgs args_of(const void* units, int n_units, void* out, void* partial,
               int m, int n, int splits, int relu) {
  WsArgs a = {};
  a.units = static_cast<const int4*>(units);
  a.n_units = n_units;
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.m = m;
  a.n = n;
  a.splits = splits;
  a.relu = relu;
  return a;
}

template <int kBN, int kCluster, bool kInflight>
cudaError_t occupancy_of(int* out) {
  return occupancy(ws_conv_kernel<kBN, kCluster, kInflight>,
                   WsCore<kBN, kCluster, kInflight>::kThreads,
                   WsCore<kBN, kCluster, kInflight>::kSmem, out);
}

}  // namespace

extern "C" {

// P1 (and P2's first product): ee [B, T, 16, 768], eo [B, T, f_odd, 768],
// oe [B, T + 1, 16, 768], oo [B, T + 1, f_odd, 768], w [9 * 768, 768] ([in,
// out] per tap), out [B T 16, 768]: bf16, contiguous, 16-byte aligned;
// taps: 27 ints, (block, dt, df) per tap, every read inside its block;
// units: the plan, n_units int4 (int32 [n_units, 4]) on the card, for row
// tiles of 8 steps (B ceil(T / 8) of them, a phantom past the last allowed)
// and column tiles of 256 (128 for the variants 2, 3); grid blocks (even
// for variant 0); splits the plan's K splits, and with splits > 1 partial
// [splits, B T 16, 768] fp32 scratch; relu: out is relu'd.  Returns the first CUDA error code of the tensor
// maps, the opt-in and the launches.
int gigaam_ws_taps(const void* ee, const void* eo, const void* oe,
                   const void* oo, const void* w, void* out, void* partial,
                   const void* units, const int* taps, int batch, int steps,
                   int f_odd, int n_units, int grid, int splits, int relu,
                   int variant, void* stream) {
  const void* blocks[4] = {ee, eo, oe, oo};
  WsMaps maps = {};
  for (int i = 0; i < 4; ++i)
    if (!block_map(&maps.block[i], blocks[i], i, batch, steps, f_odd))
      return static_cast<int>(cudaErrorInvalidValue);
  if (!matrix_map(&maps.b, w, kNumTaps * kCh, kCh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  WsArgs a = args_of(units, n_units, out, partial, batch * steps * kFreq, kCh,
                     splits, relu);
  a.taps = tap_code(taps);
  a.taps_mode = 1;
  a.batch = batch;
  a.steps = steps;
  return static_cast<int>(
      launch(variant, grid, static_cast<cudaStream_t>(stream), maps, a));
}

// P2's linear: out [M, N] = bf16(A [M, K] . B [K, N]), relu'd where asked:
// bf16, row-major, 16-byte aligned; K a multiple of 64, N of the variant's
// column tile; units, grid, splits and partial ([splits, M, N]) as for
// gigaam_ws_taps, with row tiles of 128 rows.  Returns the first CUDA
// error code.
int gigaam_ws_gemm(const void* a_ptr, const void* b_ptr, void* out,
                   void* partial, const void* units, int m, int n, int k,
                   int n_units, int grid, int splits, int relu, int variant,
                   void* stream) {
  WsMaps maps = {};
  if (!matrix_map(&maps.a, a_ptr, m, k, 128) ||
      !matrix_map(&maps.b, b_ptr, k, n, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const WsArgs a = args_of(units, n_units, out, partial, m, n, splits, relu);
  return static_cast<int>(
      launch(variant, grid, static_cast<cudaStream_t>(stream), maps, a));
}

// For the variants 0-3 in order: out[2 i] the dynamic shared memory in
// bytes, out[2 i + 1] how many blocks one SM holds at a time.  Returns a
// CUDA error code.
int gigaam_subsampling_ws_occupancy(int* out) {
  cudaError_t err;
  if ((err = occupancy_of<256, 2, true>(out)) != cudaSuccess ||
      (err = occupancy_of<256, 1, true>(out + 2)) != cudaSuccess ||
      (err = occupancy_of<128, 1, true>(out + 4)) != cudaSuccess ||
      (err = occupancy_of<128, 1, false>(out + 6)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

// out[0]: how many clusters of variant 0 (two blocks) the card holds at a
// time, which caps its persistent grid.  Returns a CUDA error code.
int gigaam_ws_max_clusters(int* out) {
  const cudaError_t err = opt_in<256, 2, true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ws_launch_config<WsCore<256, 2, true>, 2>(
      2 * (sm_count() > 0 ? sm_count() : 132), nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, ws_conv_kernel<256, 2, true>, &cfg));
}

}  // extern "C"
