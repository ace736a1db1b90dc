// The conv2d-subsampling probes for Hopper (sm_90a).
//
// They replace the Pallas kernels of benchmarks/pallas_subsampling_probe.py:
// probe_taps (P1, its `kernel`), probe_im2col (P2) and probe_vmem (P3).  None
// is on a path of the model: P1 and P2 ask whether a hand-written implicit
// GEMM could run the subsampling's second stage, a 3x3 stride-2 conv from
// 768 to 768 channels, as fast as the library conv; P3 asks how much fast
// memory a block is granted.
//
// The stage-2 conv on parity blocks.  Split the zero-padded stage-1 output X
// [2T + 1, 33, 768] (time, frequency, channel) by the parity of each
// coordinate: ee = X[1::2, 1::2] [T, 16], eo = X[1::2, 0::2] [T, 17],
// oe = X[0::2, 1::2] [T + 1, 16], oo = X[0::2, 0::2] [T + 1, 17].  Output
// (t, f) of the conv is then the sum of nine taps, each a [768] row of one
// block at (t + dt, f + df) times a [768, 768] weight:
//   tap 0 ee (0, 0)   1 eo (0, 0)   2 eo (0, 1)   3 oe (0, 0)   4 oe (1, 0)
//   tap 5 oo (0, 0)   6 oo (0, 1)   7 oo (1, 0)   8 oo (1, 1)
// (kernel positions (1,1) (1,0) (1,2) (0,1) (2,1) (0,0) (0,2) (2,0) (2,2)).
// P1's aligned variant reads [ee, ee, ee, oe, oe+1, oe, oe+1, ee, oe]: no
// offset in frequency, eo and oo unread.  The caller passes the table, as
// (block, dt, df) per tap; every block carries a leading batch dimension.
//
// What each kernel computes (rows m = (b, t, f), M = B T 16):
//   taps_kernel (P1)          out[m] = bf16(sum_i tap_i[m] . w[i]), fp32 sum
//   patch_kernel (P2)         patch[m] = [tap_0[m], ..., tap_8[m]]  [M, 6912]
//   probe_gemm_kernel (P2)    bf16(A . B) or bf16(relu(A . B)), fp32 sum
//                             (patch . w [6912, 768], then for the linear the
//                             result viewed [B T, 12288] . wl [12288, 768])
//   split_reduce_kernel       where the K range of either product is split
//                             over blocks: bf16(sum of their fp32 partials),
//                             relu'd where asked, rounded once
//   smem_probe_kernel (P3)    2 x through the last 16 KB of a dynamic
//                             shared-memory buffer of the size asked for
//
// What bounds them on the card, and what the design does about it:
//   * P1 is 9 * 2 * 768 * 768 = 10.6 M tensor operations a row against
//     ~2.5 KB of its blocks' bytes and a 10.6 MB weight read once: bounded
//     by operations (1.37 ms at B 16, T 500).  It runs on gemm.cuh's TMA
//     ring: a tile of rows is 8 time steps x 16 frequencies, and each
//     tap's A tile is one 4-D TMA box [1 batch element, 8 steps, 16
//     frequencies, 64 channels] at the tap's (t + dt, f + df).  The
//     misaligned frequency offset is a box coordinate, so no thread copies
//     anything; the 128-byte swizzle lays the box out as the
//     [rows, 64] K-major tile the descriptors read.  The K loop is 9 taps x
//     12 chunks of 64 channels, w[i]'s rows of the chunk riding the same
//     ring.  The box's batch coordinate keeps a tile inside its batch
//     element: steps past T read zeros, and their rows are not stored.
//   * P2 keeps the probe's question, a materialised patch with one long
//     contraction against P1's nine strided tap loads.  The patch [M, 6912]
//     bf16 (13.8 KB a row) cannot live in one SM's 227 KB, so patch_kernel
//     writes it to device memory (L2-resident at the script's shapes) and a
//     TMA-fed GEMM reads it back with K = 6912: the patch's write and read,
//     27.6 KB a row, is the design's price beside P1.  The GEMM computes the
//     whole [M, 768] product even where the probe keeps one row in 16.  The
//     linear has only B T rows and K = 12288.
//   * Grids: every product runs 128 x 128 output tiles (two warpgroups,
//     three 32 KB stages, two blocks an SM).  A tile reads 32 KB of A and B
//     a K step for 2 M operations, 64 operations a byte of L2, which at the
//     ~5.5 TB/s that the projection GEMMs reached bounds it near 350
//     TFLOP/s; 64 x 64 tiles would halve that.  Where the tiles do not give
//     every SM a block (the script's shapes, B 1, T 32-128: 24-96 tiles;
//     the linear's B T rows), the caller splits the K range over blocks
//     (grid z) until they do: each block stores fp32 partials [splits, M,
//     N], and split_reduce_kernel sums them in one pass.  That costs 8
//     bytes an output value a split (write and read) and one more launch,
//     a few microseconds at those shapes, where the launch and one wave's
//     ramp are most of the time whatever the design.
//   * P3 moves 32 KB: its time is the launch's.  The entry asks for the
//     buffer's size (cudaFuncSetAttribute) before the launch; a size past
//     the card's opt-in limit is refused there, which the entry reports on
//     its own, and nothing is launched.

#include "gemm.cuh"

using namespace gigaam;

namespace {

constexpr int kCh = 768;                  // channels in and out
constexpr int kFreq = 16;                 // output frequencies a time step
constexpr int kNumTaps = 9;
constexpr int kPatchCols = kNumTaps * kCh;
constexpr int kBM = 128, kBN = 128, kBK = 64;   // a tile; K columns an item
constexpr int kSteps = kBM / kFreq;       // time steps of a taps tile
constexpr int kChunksK = kCh / kBK;       // K items a tap
constexpr int kStages = 3;
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBK * kBN * 2;
constexpr int kGemmSmem = kStages * (kABytes + kBBytes) + kSmemAlign;
constexpr int kGemmThreads = 2 * kThreads;   // one warpgroup a 64 rows
constexpr int kProbeBytes = 8 * 1024 * 2; // P3's x [8, 1024] bf16
constexpr int kProbeThreads = 256;

// The tap table: 4 bits a tap, tap i at bits 4 i ..: the block (0 ee,
// 1 eo, 2 oe, 3 oo; bit 0 of it: the odd-frequency blocks, bit 1: the
// odd-time ones), then dt, then df.
struct Tap {
  int block, dt, df;
};

__device__ __forceinline__ Tap tap_of(uint64_t taps, int i) {
  const int code = static_cast<int>(taps >> (4 * i)) & 15;
  return {code & 3, (code >> 2) & 1, code >> 3};
}

// where a tile's products go: bf16 rows of out [M, N] (relu'd when asked)
// with one split, else this block's fp32 partial [M, N] of partial
// [splits, M, N]
struct Epilogue {
  bf16* out;
  float* partial;
  int m, n, relu;
};

// The K items of this block's split (grid z) of n_k items.
struct Split {
  int first, count;
};

__device__ __forceinline__ Split split_of(int n_k) {
  const int z = blockIdx.z, splits = gridDim.z;
  const int first = z * n_k / splits;
  return {first, (z + 1) * n_k / splits - first};
}

// k-step kk of this warpgroup's 64 rows of a K-major [128, 64] A tile
__device__ __forceinline__ uint64_t a_desc(uint32_t sa, int kk) {
  const int wg = threadIdx.x / kThreads;
  return swizzled_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024, kSwizzle128);
}

// The products of one tile over `count` K items on gemm.cuh's ring;
// load(a, b, item, bar) starts the copies of item `item`.
template <typename Load>
__device__ __forceinline__ void tile_products(float (&acc)[kBN / 2],
                                              unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              int count, Load load) {
  gemm_tma_ring<2, kBN, kBK, kStages, kABytes, kBBytes>(
      acc, aligned_smem(smem), full, empty, count, load,
      [](uint32_t sa, int kk) { return a_desc(sa, kk); },
      [](uint32_t sb, int kk) { return weight_desc<kBK>(sb, kk); });
}

// This warpgroup's [64, kBN] accumulator to columns n0 .. of the epilogue's
// rows; row_of(r) is the output row of the tile's row r (of 128), or -1.
template <typename RowOf>
__device__ __forceinline__ void store_tile(const float (&acc)[kBN / 2],
                                           const Epilogue& e, int n0,
                                           RowOf row_of) {
  const int r0 = (threadIdx.x / kThreads) * 64;
  if (gridDim.z == 1) {
    uint32_t lo[kBN / 8], hi[kBN / 8];
    auto f = [&](float v) { return e.relu ? fmaxf(v, 0.f) : v; };
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      lo[j] = pack_bf16(f(acc[4 * j]), f(acc[4 * j + 1]));
      hi[j] = pack_bf16(f(acc[4 * j + 2]), f(acc[4 * j + 3]));
    }
    put_chunks<kBN>(lo, hi, [&](int row, int chunk, uint4 val) {
      const int m = row_of(r0 + row);
      if (m >= 0)
        *reinterpret_cast<uint4*>(e.out + (size_t)m * e.n + n0 + chunk * 8) =
            val;
    });
    return;
  }
  // fp32 partials straight from the fragment: acc[4 j], acc[4 j + 1] of
  // row g and acc[4 j + 2], acc[4 j + 3] of row g + 8, columns 8 j + 2 l, + 1
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int g = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int m_lo = row_of(g), m_hi = row_of(g + 8);
  float* p = e.partial + (size_t)blockIdx.z * e.m * e.n + n0 + 2 * l;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    if (m_lo >= 0)
      *reinterpret_cast<float2*>(p + (size_t)m_lo * e.n + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (m_hi >= 0)
      *reinterpret_cast<float2*>(p + (size_t)m_hi * e.n + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// P1: taps_kernel
// ---------------------------------------------------------------------------

struct TapArgs {
  uint64_t taps;
  Epilogue e;      // out [B T 16, 768]
  int steps;       // T
};

struct TapMaps {
  CUtensorMap block[4];  // ee, eo, oe, oo: [B, T(+1), 16 | F, 768], boxes
                         // [1, 8, 16, 64], 128-byte swizzle
  CUtensorMap w;         // [9 * 768, 768], boxes [64 rows, 64 columns]
};

// grid (768 / 128 column tiles, B * tiles of 8 time steps, splits)
__global__ void __launch_bounds__(kGemmThreads)
taps_kernel(const __grid_constant__ TapMaps maps, TapArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int tiles_per_b = (a.steps + kSteps - 1) / kSteps;
  const int b = blockIdx.y / tiles_per_b;
  const int t0 = (blockIdx.y % tiles_per_b) * kSteps;
  const int n0 = blockIdx.x * kBN;
  const Split split = split_of(kNumTaps * kChunksK);

  float acc[kBN / 2];
  tile_products(acc, smem, full, empty, split.count,
                [&](uint32_t sa, uint32_t sb, int kt, uint32_t bar) {
    const int item = split.first + kt;
    const int i = item / kChunksK, k0 = (item % kChunksK) * kBK;
    const Tap tap = tap_of(a.taps, i);
    tma_load_4d(sa, &maps.block[tap.block], k0, tap.df, t0 + tap.dt, b, bar);
#pragma unroll
    for (int j = 0; j < kBN / 64; ++j)
      tma_load_2d(sb + j * kBK * 128, &maps.w, n0 + 64 * j, i * kCh + k0,
                  bar);
  });
  // tile row r is step t0 + r / 16, frequency r % 16
  const int row0 = (b * a.steps + t0) * kFreq;
  store_tile(acc, a.e, n0, [&](int r) {
    return t0 + r / kFreq < a.steps ? row0 + r : -1;
  });
}

// ---------------------------------------------------------------------------
// P2: patch_kernel, probe_gemm_kernel
// ---------------------------------------------------------------------------

struct Im2colArgs {
  const bf16* block[4];  // ee, eo, oe, oo
  uint64_t taps;
  bf16* patch;           // [B T 16, 6912]
  int batch, steps, f_odd;
};

// one 16-byte chunk of the patch a thread and step: neighbouring threads
// read neighbouring chunks of one block row and write neighbouring chunks of
// one patch row
__global__ void __launch_bounds__(256)
patch_kernel(const __grid_constant__ Im2colArgs a) {
  constexpr uint32_t kRowChunks = kPatchCols / 8, kTapChunks = kCh / 8;
  const uint32_t n = (uint32_t)a.batch * a.steps * kFreq * kRowChunks;
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u < n;
       u += gridDim.x * blockDim.x) {
    const uint32_t row = u / kRowChunks, q = u % kRowChunks;
    const int i = q / kTapChunks, c = (q % kTapChunks) * 8;
    const int f = row % kFreq, bt = row / kFreq;
    const int t = bt % a.steps, b = bt / a.steps;
    const Tap tap = tap_of(a.taps, i);
    const int t_blk = a.steps + (tap.block >> 1);
    const int f_blk = (tap.block & 1) ? a.f_odd : kFreq;
    const bf16* src =
        a.block[tap.block] +
        (((size_t)b * t_blk + t + tap.dt) * f_blk + f + tap.df) * kCh + c;
    *reinterpret_cast<uint4*>(a.patch + (size_t)row * kPatchCols + i * kCh +
                              c) = *reinterpret_cast<const uint4*>(src);
  }
}

struct GemmArgs {
  Epilogue e;        // out [M, N]
  int k_tiles;       // K / 64
};

struct GemmMaps {
  CUtensorMap a;     // [M, K], boxes [128 rows, 64 columns]
  CUtensorMap b;     // [K, N], boxes [64 rows, 64 columns]
};

// grid (N / 128, row tiles of 128, splits)
__global__ void __launch_bounds__(kGemmThreads)
probe_gemm_kernel(const __grid_constant__ GemmMaps maps, GemmArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const Split split = split_of(a.k_tiles);

  float acc[kBN / 2];
  tile_products(acc, smem, full, empty, split.count,
                [&](uint32_t sa, uint32_t sb, int kt, uint32_t bar) {
    const int k0 = (split.first + kt) * kBK;
    tma_load_2d(sa, &maps.a, k0, m0, bar);
#pragma unroll
    for (int j = 0; j < kBN / 64; ++j)
      tma_load_2d(sb + j * kBK * 128, &maps.b, n0 + 64 * j, k0, bar);
  });
  store_tile(acc, a.e, n0,
             [&](int r) { return m0 + r < a.e.m ? m0 + r : -1; });
}

// out = bf16(sum_s partial[s]) (relu'd when asked), 4 values a thread
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* partial, bf16* out, int mn4, int splits,
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
// P3: smem_probe_kernel
// ---------------------------------------------------------------------------

// x [8, 1024] bf16 into the last 16 KB of the n_bytes buffer, then 2 x out
__global__ void __launch_bounds__(kProbeThreads)
smem_probe_kernel(const bf16* x, bf16* out, int n_bytes) {
  extern __shared__ __align__(16) unsigned char buf[];
  unsigned char* last = buf + n_bytes - kProbeBytes;
  for (int u = threadIdx.x; u < kProbeBytes / 16; u += kProbeThreads)
    *reinterpret_cast<uint4*>(last + 16 * u) =
        reinterpret_cast<const uint4*>(x)[u];
  __syncthreads();
  for (int u = threadIdx.x; u < kProbeBytes / 16; u += kProbeThreads) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(last + 16 * u), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= 2.f;
    reinterpret_cast<uint4*>(out)[u] = pack8(v);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

Epilogue epilogue(void* out, void* partial, int m, int n, int relu) {
  Epilogue e;
  e.out = static_cast<bf16*>(out);
  e.partial = static_cast<float*>(partial);
  e.m = m;
  e.n = n;
  e.relu = relu;
  return e;
}

int grid_for(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  const size_t cap = static_cast<size_t>(sm_count() > 0 ? sm_count() : 132) * 8;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// with splits > 1: out = bf16(sum of the partials), relu'd when asked
cudaError_t reduce_splits(const void* partial, void* out, int m, int n,
                          int splits, int relu, cudaStream_t s) {
  const int mn4 = m * n / 4;
  split_reduce_kernel<<<grid_for(mn4, 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(out), mn4, splits,
      relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ee [B, T, 16, 768], eo [B, T, f_odd, 768], oe [B, T + 1, 16, 768],
// oo [B, T + 1, f_odd, 768], w [9, 768, 768] ([in, out] per tap), out
// [B, T, 16, 768]: bf16, contiguous, 16-byte aligned; taps: 27 ints, (block,
// dt, df) per tap, every read inside its block; f_odd 16 or 17; 1 <= splits
// <= 108, and with splits > 1 partial [splits, B T 16, 768] fp32 scratch.
// Returns the first CUDA error code of the tensor maps, the shared-memory
// opt-in and the launches.
int gigaam_taps(const void* ee, const void* eo, const void* oe, const void* oo,
                const void* w, void* out, void* partial, const int* taps,
                int batch, int steps, int f_odd, int splits, void* stream) {
  const void* blocks[4] = {ee, eo, oe, oo};
  TapMaps maps;
  for (int i = 0; i < 4; ++i)
    if (!block_map(&maps.block[i], blocks[i], i, batch, steps, f_odd))
      return static_cast<int>(cudaErrorInvalidValue);
  if (!matrix_map(&maps.w, w, kNumTaps * kCh, kCh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = batch * steps * kFreq;
  TapArgs a;
  a.taps = tap_code(taps);
  a.e = epilogue(out, partial, m, kCh, 0);
  a.steps = steps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kCh / kBN, batch * ((steps + kSteps - 1) / kSteps), splits);
  cudaError_t err =
      launch<taps_kernel>(grid, kGemmThreads, kGemmSmem, s, maps, a);
  if (err == cudaSuccess && splits > 1)
    err = reduce_splits(partial, out, m, kCh, splits, 0, s);
  return static_cast<int>(err);
}

// The blocks as for gigaam_taps (f_odd 17 where a tap reads df 1); patch
// [B T 16, 6912] bf16, written whole; B T 16 * 864 < 2^31.
int gigaam_im2col(const void* ee, const void* eo, const void* oe,
                  const void* oo, void* patch, const int* taps, int batch,
                  int steps, int f_odd, void* stream) {
  Im2colArgs a;
  a.block[0] = static_cast<const bf16*>(ee);
  a.block[1] = static_cast<const bf16*>(eo);
  a.block[2] = static_cast<const bf16*>(oe);
  a.block[3] = static_cast<const bf16*>(oo);
  a.taps = tap_code(taps);
  a.patch = static_cast<bf16*>(patch);
  a.batch = batch;
  a.steps = steps;
  a.f_odd = f_odd;
  const size_t work = (size_t)batch * steps * kFreq * (kPatchCols / 8);
  patch_kernel<<<grid_for(work, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out [M, N] = bf16(A [M, K] . B [K, N]), relu'd when asked: bf16,
// row-major, 16-byte aligned; K a multiple of 64, N of 128; 1 <= splits <=
// K / 64, and with splits > 1 partial [splits, M, N] fp32 scratch.  Returns
// the first CUDA error code.
int gigaam_probe_gemm(const void* a, const void* b, void* out, void* partial,
                      int m, int n, int k, int splits, int relu,
                      void* stream) {
  GemmMaps maps;
  if (!matrix_map(&maps.a, a, m, k, kBM) || !matrix_map(&maps.b, b, k, n, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs args;
  args.e = epilogue(out, partial, m, n, splits == 1 ? relu : 0);
  args.k_tiles = k / kBK;
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM, splits);
  cudaError_t err = launch<probe_gemm_kernel>(grid, kGemmThreads, kGemmSmem,
                                              s, maps, args);
  if (err == cudaSuccess && splits > 1)
    err = reduce_splits(partial, out, m, n, splits, relu, s);
  return static_cast<int>(err);
}

// x, out: [8, 1024] bf16; n_bytes a multiple of 16, >= 16384.  Sets
// smem_probe_kernel's dynamic shared memory to n_bytes, launches it, then
// asks how many such blocks one SM holds (result[0]).  A size the card
// refuses sets result[1] to 1, clears the error and returns its code before
// any launch; any other failure returns its code with result[1] 0.
int gigaam_smem_probe(const void* x, void* out, int n_bytes, int* result,
                      void* stream) {
  result[0] = result[1] = 0;
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    result[1] = 1;
    return static_cast<int>(err);
  }
  smem_probe_kernel<<<1, kProbeThreads, n_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), n_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      result, smem_probe_kernel, kProbeThreads, n_bytes));
}

// For taps_kernel and probe_gemm_kernel: out[2 i] the dynamic shared memory
// in bytes, out[2 i + 1] how many blocks one SM holds at a time.  Returns a
// CUDA error code.
int gigaam_subsampling_probe_occupancy(int* out) {
  cudaError_t err;
  if ((err = occupancy(taps_kernel, kGemmThreads, kGemmSmem, out)) !=
          cudaSuccess ||
      (err = occupancy(probe_gemm_kernel, kGemmThreads, kGemmSmem, out + 2)) !=
          cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

}  // extern "C"
