// The attention-fold probes for Hopper (sm_90a): variants of K1/K2's
// projection GEMMs (projection.cuh) at other tiles.
//
// They replace the Pallas kernels of two probes of the JAX package:
//   P6  benchmarks/pallas_attn_fold_probe.py::folded_attention_nb (the body
//       _fold_kernel_nb): K2's function, nb batch rows a grid cell;
//   P7  ::folded_attention (_fold_kernel): the same, one row a cell, with
//       per-head [H, 768, 48] Q/K weight blocks (foldA) or the full
//       [768, 768] projections sliced per head (foldB);
//   P8  benchmarks/pallas_attn_lnres_probe.py::lnres_folded (_lnres_kernel):
//       K1's function with the residual added to the fp32 accumulator.
// None is on a path of the model: they measure how the projections around
// the SDPA are best tiled, and what K1's rounding of the residual costs.
// All three now run on their redesign (attn_fold_ws.cu, and for P8's
// output product attn_lnres_ws.cu); these kernels are kept for an A/B on
// the same card.
//
// The Pallas bodies keep four 768x768 weights resident in a 100 MB VMEM; an
// SM has 227 KB, so each probe is, like K1/K2, four launches: the row pass
// (projection.cu's ln_rope_kernel), a Q/K/V GEMM of this file, the SDPA
// core (attention.cu) and an output GEMM of this file.  On the TPU the
// probes' axis was how the projections are blocked around the SDPA; on the
// card that is the GEMMs' tiles:
//   * foldB and P6 (nb 1, 2, 4): qkv_kernel<nb, 128> and
//     out_proj_kernel<nb, 128, kNoResidual>, nb consumer warpgroups a block,
//     so each TMA-loaded weight tile feeds 64 nb rows.  N-128 column tiles
//     straddle heads (128 = 2 2/3 heads); the store splits them per head.
//     K2's own dispatch picks its tile from the grid size; here nb pins it.
//     nb 4 is 512 threads with three 48 KB QKV stages and two 72 KB output
//     stages.
//   * foldA: qkv_head_kernel, one block a head's q or k for 64 rows: a
//     [64, 768] x [768, 48] product with `wgmma` m64n48k16, so no tile
//     straddles a head and the store writes whole 96-byte head rows.  The
//     same launch runs the v projection on the N-128 path (the Pallas body,
//     too, projects v with the full weight).  A head's weight block [768,
//     48] has 96-byte rows, no swizzle width, so the wrapper lays the blocks
//     out K-major once, [H, 48, 768] (the transposed [768, 768] weight, split
//     by head), and a block reads [48 rows, 64 columns] boxes with the
//     128-byte swizzle: the layout of the A tiles, read through the same
//     descriptor, with no transpose bit.  (The other way, MN-major reads of
//     [768, 48] through 32-byte-swizzled boxes of 16 columns, would need a
//     descriptor layout that nothing in this repository uses yet.)  The
//     cost the probe measures: each row tile's A is read 32 times (once a
//     head of q and of k) against 12 times on the N-128 path.
//   * P8: the row pass with its LayerNorm, qkv_kernel<nb, 128>, and
//     out_proj_kernel<nb, 128, kFp32Residual>, whose epilogue adds bo and
//     x, widened from its bf16 row, to the fp32 accumulator before the one
//     rounding (K1's kBf16Residual rounds first and adds in bf16).
//
// What bounds them is what bounds K1/K2's GEMMs (projection.cu's header):
// at B*T = 8000 operations, at B*T = 500 the weight bytes.

#include "projection.cuh"

using namespace gigaam;

namespace {

// foldA's per-head products: [64 rows, 64 columns] of A and [48 rows, 64
// columns] of a head's K-major weight block a stage, three stages
constexpr int kHeadBK = 64;
constexpr int kHeadStages = 3;
constexpr int kHeadABytes = kTile * kHeadBK * 2;       // 8192
constexpr int kHeadBBytes = kD * kHeadBK * 2;          // 6144
constexpr int kHeadStageBytes = kHeadABytes + kHeadBBytes;
static_assert(kHeadStageBytes % kSmemAlign == 0, "stages start on 1024 bytes");
// the v blocks of the same launch: qkv_kernel<1, 128>'s tiles
using VTile = QkvTile<1, 128>;
static_assert(VTile::kSmem >= kHeadStages * kHeadStageBytes + kSmemAlign,
              "the v ring is the larger");
constexpr int kHeadSmem = VTile::kSmem;

struct HeadMaps {
  CUtensorMap a[2];    // xr, then xv: [M, D], boxes [64 rows, 64], 128 B swizzle
  CUtensorMap wh[2];   // Wq, Wk heads: [H * 48, D] (K-major), boxes [48, 64], 128 B swizzle
  CUtensorMap wv;      // Wv: [D, D], boxes [64 rows, 64 columns], 128 B swizzle
};

// K-major [rows, 64 columns] 128-byte-swizzled tile: k-step kk
__device__ __forceinline__ uint64_t k_major_desc(uint32_t tile, int kk) {
  return swizzled_desc(tile + kk * 32, 16, 1024, kSwizzle128);
}

// The [64, 48] accumulator plus its head's 48 fp32 biases, rounded to bf16
// and handed out as 16-byte chunks: put(row of 64, chunk of 6, value).  The
// quad's lanes trade pieces so that each holds whole chunks (12 a quad:
// three rounds of four), as wgmma.cuh's store_fragment does.
template <typename Put>
__device__ __forceinline__ void put_head_chunks(const float (&d)[24],
                                                const float* bias, Put put) {
  const int lane = threadIdx.x & 31, l = lane & 3;
  const int row_lo = (threadIdx.x >> 5) * 16 + (lane >> 2), row_hi = row_lo + 8;
  uint32_t lo[kChunks], hi[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * l);
    lo[j] = pack_bf16(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
    hi[j] = pack_bf16(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
  }
  put(row_lo, l, quad_gather(lo[0], lo[1], lo[2], lo[3], l));
  put(l < 2 ? row_lo : row_hi, l < 2 ? 4 + l : l - 2,
      quad_gather(lo[4], lo[5], hi[0], hi[1], l));
  put(row_hi, 2 + l, quad_gather(hi[2], hi[3], hi[4], hi[5], l));
}

// grid (2 H head blocks of q and k, then D / 128 column tiles of v; row
// tiles of 64).  One warpgroup a block.
__global__ void __launch_bounds__(kThreads)
qkv_head_kernel(const __grid_constant__ HeadMaps maps, QkvArgs a) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kHeadStages], empty[kHeadStages];
  const int m0 = blockIdx.y * kTile;
  const int head_blocks = 2 * a.n_heads;
  const uint32_t base = aligned_smem(smem);
  auto store = [&](bf16* out, int n, int row, uint4 val) {
    const int m = m0 + row;
    if (m >= a.m) return;
    const int b = m / a.t, t = m % a.t;
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * a.n_heads + n / kD) * a.t + t) * kD + n % kD) = val;
  };

  if (blockIdx.x >= head_blocks) {
    // v: qkv_kernel<1, 128>'s tile of xv . Wv
    const int n0 = (blockIdx.x - head_blocks) * 128;
    float acc[64];
    gemm_tma_ring<1, 128, VTile::kBK, VTile::kStages, VTile::kABytes,
                  VTile::kBBytes>(
        acc, base, full, empty, a.d / VTile::kBK,
        [&](uint32_t sa, uint32_t sb, int kt, uint32_t bar) {
          tma_load_2d(sa, &maps.a[1], kt * VTile::kBK, m0, bar);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_2d(sb + j * VTile::kBK * 128, &maps.wv, n0 + 64 * j,
                        kt * VTile::kBK, bar);
        },
        [&](uint32_t sa, int kk) { return k_major_desc(sa, kk); },
        [&](uint32_t sb, int kk) { return weight_desc<VTile::kBK>(sb, kk); });
    store_tile_chunks<128>(acc, a.bias[2] + n0,
                           [&](int row, int chunk, uint4 val) {
      store(a.out[2], n0 + chunk * 8, row, val);
    });
    return;
  }

  // q or k of head h: xr [64, D] . W_h^T, W_h the head's [48, D] block
  const int which = blockIdx.x / a.n_heads;   // 0: q, 1: k
  const int h = blockIdx.x % a.n_heads;
  const int n_k = a.d / kHeadBK;
  const TmaRing<kHeadStages, kHeadStageBytes> ring{base, full, empty};
  auto load = [&](uint32_t s, int kt, uint32_t bar) {
    tma_load_2d(s, &maps.a[0], kt * kHeadBK, m0, bar);
    tma_load_2d(s + kHeadABytes, &maps.wh[which], kt * kHeadBK, h * kD, bar);
  };
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  if (threadIdx.x == 0) ring.init(4);   // one arrival per warp
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(n_k, load);
  for (int kt = 0; kt < n_k; ++kt) {
    ring.wait(kt);
    const uint32_t s = ring.stage(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadBK / 16; ++kk)
      wgmma_ss_nt48(acc, k_major_desc(s, kk),
                    k_major_desc(s + kHeadABytes, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    ring.release(kt, n_k, load);
  }
  put_head_chunks(acc, a.bias[which] + h * kD,
                  [&](int row, int chunk, uint4 val) {
    store(a.out[which], h * kD + chunk * 8, row, val);
  });
}

template <int kRes>
cudaError_t launch_out_nb(const OutArgs& a, int batch, int nb,
                          cudaStream_t s) {
  switch (nb) {
    case 1: return launch_out<1, 128, kRes>(a, batch, s);
    case 2: return launch_out<2, 128, kRes>(a, batch, s);
    case 4: return launch_out<4, 128, kRes>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// foldB, P6 and P8's Q/K/V GEMM: qkv_kernel<nb, 128>.  xr, xv: [B*T, D]
// bf16 (the A of the q/k and of the v columns); w*: [D, D] bf16 [in, out];
// b*: [D] fp32; q/k/v: [B, H, T, 48] bf16.  nb is 1, 2 or 4; D % 128 == 0,
// D == 48 * n_heads, all pointers 16-byte aligned.  Returns the CUDA error
// code of the shared-memory opt-in or of the launch.
int gigaam_probe_qkv(const void* xr, const void* xv, const void* wq,
                     const void* wk, const void* wv, const void* bq,
                     const void* bk, const void* bv, void* q, void* k,
                     void* v, int batch, int t, int d, int n_heads, int nb,
                     void* stream) {
  const QkvArgs a = qkv_args(xr, xv, wq, wk, wv, bq, bk, bv, q, k, v, batch,
                             t, d, n_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 1: return static_cast<int>(launch_qkv<1, 128>(a, s));
    case 2: return static_cast<int>(launch_qkv<2, 128>(a, s));
    case 4: return static_cast<int>(launch_qkv<4, 128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// foldA's Q/K/V GEMM: qkv_head_kernel.  As gigaam_probe_qkv, but wq_heads,
// wk_heads are the per-head blocks laid out K-major, [H, 48, D] bf16 (the
// transposed [D, D] weights); wv stays [D, D] [in, out].
int gigaam_probe_qkv_heads(const void* xr, const void* xv,
                           const void* wq_heads, const void* wk_heads,
                           const void* wv, const void* bq, const void* bk,
                           const void* bv, void* q, void* k, void* v,
                           int batch, int t, int d, int n_heads,
                           void* stream) {
  const QkvArgs a = qkv_args(xr, xv, wq_heads, wk_heads, wv, bq, bk, bv, q,
                             k, v, batch, t, d, n_heads);
  HeadMaps maps;
  if (!matrix_map(&maps.a[0], a.xr, a.m, a.d, kTile) ||
      !matrix_map(&maps.a[1], a.xv, a.m, a.d, kTile) ||
      !matrix_map(&maps.wh[0], a.w[0], n_heads * kD, a.d, kD) ||
      !matrix_map(&maps.wh[1], a.w[1], n_heads * kD, a.d, kD) ||
      !matrix_map(&maps.wv, a.w[2], a.d, a.d, VTile::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(2 * n_heads + d / 128, (a.m + kTile - 1) / kTile);
  return static_cast<int>(launch<qkv_head_kernel>(
      grid, kThreads, kHeadSmem, static_cast<cudaStream_t>(stream), maps, a));
}

// The output GEMM at 64 nb rows a block: out_proj_kernel<nb, 128,
// kNoResidual> when residual is null, else <nb, 128, kFp32Residual> with
// residual the pre-LN x [B*T, D] bf16.  o: [B, H, T, 48] bf16; wo: [D, D]
// bf16; bo: [D] fp32; out: [B*T, D] bf16.  nb is 1, 2 or 4; D % 128 == 0,
// D == 48 * n_heads.  Returns a CUDA error code.
int gigaam_probe_out_proj(const void* o, const void* wo, const void* bo,
                          const void* residual, void* out, int batch, int t,
                          int d, int n_heads, int nb, void* stream) {
  const OutArgs a = out_args(o, wo, bo, residual, out, t, d, n_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      residual == nullptr ? launch_out_nb<kNoResidual>(a, batch, nb, s)
                          : launch_out_nb<kFp32Residual>(a, batch, nb, s));
}

// For qkv_kernel <1, 128>, <2, 128>, <4, 128>, qkv_head_kernel,
// out_proj_kernel <1, 128, 0>, <2, 128, 0>, <4, 128, 0>, <1, 128, 2>,
// <2, 128, 2>, <4, 128, 2>: out[2 i] the dynamic shared memory in bytes,
// out[2 i + 1] how many blocks one SM holds at a time.  Returns a CUDA
// error code.
int gigaam_attn_fold_probe_occupancy(int* out) {
  const cudaError_t errs[] = {
      occupancy(qkv_kernel<1, 128>, kThreads, QkvTile<1, 128>::kSmem, out),
      occupancy(qkv_kernel<2, 128>, 2 * kThreads, QkvTile<2, 128>::kSmem,
                out + 2),
      occupancy(qkv_kernel<4, 128>, 4 * kThreads, QkvTile<4, 128>::kSmem,
                out + 4),
      occupancy(qkv_head_kernel, kThreads, kHeadSmem, out + 6),
      occupancy(out_proj_kernel<1, 128, kNoResidual>, kThreads,
                OutTile<1, 128>::kSmem, out + 8),
      occupancy(out_proj_kernel<2, 128, kNoResidual>, 2 * kThreads,
                OutTile<2, 128>::kSmem, out + 10),
      occupancy(out_proj_kernel<4, 128, kNoResidual>, 4 * kThreads,
                OutTile<4, 128>::kSmem, out + 12),
      occupancy(out_proj_kernel<1, 128, kFp32Residual>, kThreads,
                OutTile<1, 128>::kSmem, out + 14),
      occupancy(out_proj_kernel<2, 128, kFp32Residual>, 2 * kThreads,
                OutTile<2, 128>::kSmem, out + 16),
      occupancy(out_proj_kernel<4, 128, kFp32Residual>, 4 * kThreads,
                OutTile<4, 128>::kSmem, out + 18)};
  for (const cudaError_t err : errs)
    if (err != cudaSuccess) return static_cast<int>(err);
  return 0;
}

}  // extern "C"
