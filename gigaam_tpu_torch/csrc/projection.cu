// Prologue and epilogue of the folded rotary attention module for Hopper
// (sm_90a): the row pass (LayerNorm and RoPE), the Q/K/V projection and the
// output projection.
//
// Together with attention.cu these replace the Pallas kernels
// gigaam_tpu/ops/pallas_attention.py::_fold_rotary_kernel (K2, through
// _folded_rotary_pallas) and ::_fold_rotary_lnres_kernel (K1, through
// _folded_lnres_pallas).  The Pallas kernels keep the four 768x768 weights
// resident in a 100 MB VMEM; an SM has 227 KB of shared memory, so on Hopper
// the module is four launches: this file's row pass and QKV GEMM, the SDPA
// core (attention.cu) and this file's output GEMM.
//
// What each computes, for every row m = (b, t) of x [B*T, D] (bf16):
//   ln_rope_kernel   xn = bf16(LN(x))      (K1 only: fp32 statistics, eps
//                                           1e-5, fp32 scale and bias; K2's
//                                           xn is x itself and is not written)
//                    xr = bf16(xn * cos[t] + rotate_half(xn) * sin[t])
//                                          per 48-wide head
//   qkv_kernel       q = bf16(xr @ Wq + bq), k = bf16(xr @ Wk + bk),
//                    v = bf16(xn @ Wv + bv), stored in the [B, H, T, 48]
//                    layout the SDPA core reads; Wq and bq arrive pre-scaled
//                    by 1/sqrt(48)
//   out_proj_kernel  out = bf16(sum_h O[b, h, t] @ Wo[48h:48h+48] + bo), and
//                    for K1 out = bf16(out + x): the residual added in bf16,
//                    as the Pallas kernel adds it
// The Pallas kernel applies rotate-half as a +-1 permutation matmul (x @ R,
// _rope_perm_matrix); the row pass uses the index swap with a sign that the
// permutation stands for, which is exact.  Its products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn), as the plain PyTorch version rounds
// them, so that given the same xn the two give the same xr.
//
// What bounds each stage on the card, and what the design does about it:
//   * The row pass moves bytes: x in, xn and xr out (~37 MB at B*T = 8000,
//     ~11 us at 3.35 TB/s).  One warp a row, 16-byte loads and stores; the
//     LN statistics are taken once per row from registers, the RoPE partner
//     chunk (j +- 24 within the head) is read back from the warp's copy of
//     the row in shared memory, and ln_g, ln_b, cos and sin are read once
//     per row.  The GEMMs then read plain bf16 rows: nothing is recomputed
//     per output tile (the WMMA kernel this replaces redid LN and RoPE for
//     every one of a row block's 36 column tiles).
//   * The GEMMs: [B*T, 768] x [768, 2304] (QKV) and [B*T, 768] x [768, 768]
//     (output), ~590 operations per weight byte at B*T = 8000 (bounded by
//     operations) and ~40 at B*T = 500 (by the weight bytes).  What held
//     them back was the loads: with per-thread `cp.async` copies into the
//     core-matrix layout, the QKV GEMM took as long without its products as
//     with them.  So both run on gemm.cuh's TMA ring:
//     one thread issues bulk tensor copies into swizzled tiles, completion
//     and release go through `mbarrier`s, and one warpgroup per 64 rows
//     multiplies with `wgmma` m64n128k16 (m64n64k16 for the small output
//     grid), the weight read MN-major through the transpose bit (no
//     transposed copy), fp32 accumulation.
//   * QKV is one sweep over N = 2304: the block's N tile picks Wq, Wk or Wv
//     and, with it, A = xr (q, k) or xn (v); 128 divides 768, so no tile
//     straddles two weights.  K steps by 64: A's 128-byte rows take the
//     128-byte swizzle.  Three stages of 32 KB (two blocks an SM).
//   * The output GEMM runs over (b, t-tile), so that head h's A tile is a
//     [rows, 48] block of O; a K tile is two heads (O's 96-byte rows as
//     32-byte-swizzled boxes of 16 columns) against Wo's 96 rows of those
//     heads.  Two stages.
//   * Grids: 128-row tiles (two warpgroups) when they give at least one
//     block per SM, else 64-row tiles (and, for the output GEMM, 64-column
//     tiles), so that batch 1 (B*T = 500) still spreads over the card.
//   * Each wrapper call encodes its tensor maps on the host (the pointers
//     change from call to call) and opts each kernel in to its shared memory
//     once per device.
//   * The GEMM kernels are templates of projection.cuh, which the
//     attention-fold probes (attn_fold_probe.cu) instantiate at other row
//     tiles and with a third epilogue.

#include "projection.cuh"

using namespace gigaam;

namespace {

constexpr int kRowWarps = 8;          // rows a block of the row pass
constexpr int kMaxRowChunks = 4;      // 16-byte chunks a lane holds: D <= 1024
constexpr int kMaxD = kMaxRowChunks * 32 * 8;

struct RowArgs {
  const bf16* x;       // [B*T, D]
  const float* ln_g;   // [D] fp32, or null: no LayerNorm (K2)
  const float* ln_b;
  const float* cos;    // [T, 48] fp32
  const float* sin;
  bf16* xn;            // [B*T, D], written with LayerNorm only
  bf16* xr;            // [B*T, D]
  int m, t, d;
};

// One warp a row; lane l holds the row's 16-byte chunks l, l + 32, ...
template <bool kLn>
__global__ void __launch_bounds__(kRowWarps * 32) ln_rope_kernel(RowArgs a) {
  __shared__ __align__(16) bf16 rows[kRowWarps][kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowWarps + warp;
  if (m >= a.m) return;
  const int n_chunks = a.d / 8;
  const bf16* xrow = a.x + (size_t)m * a.d;
  float v[kMaxRowChunks][8];
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) unpack8(*reinterpret_cast<const uint4*>(xrow + c * 8), v[i]);
  }
  if (kLn) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i)
      if (lane + 32 * i < n_chunks)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[i][e];
    const float mean = warp_sum(s) / a.d;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i)
      if (lane + 32 * i < n_chunks)
#pragma unroll
        for (int e = 0; e < 8; ++e) s2 += (v[i][e] - mean) * (v[i][e] - mean);
    const float rstd = rsqrtf(warp_sum(s2) / a.d + 1e-5f);
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        float g[8], b[8];
        load8f(a.ln_g + c * 8, g);
        load8f(a.ln_b + c * 8, b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[i][e] = __bfloat162float(__float2bfloat16(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mean), rstd), g[e]),
              b[e])));
        *reinterpret_cast<uint4*>(a.xn + (size_t)m * a.d + c * 8) = pack8(v[i]);
      }
    }
  }
  // the row as bf16 (exact: v holds bf16 values) for the partner reads
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) *reinterpret_cast<uint4*>(&rows[warp][c * 8]) = pack8(v[i]);
  }
  __syncwarp();
  const int t = m % a.t;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) {
      // rotate_half within the head: chunk j < 3 of the head takes -x of
      // chunk j + 3, chunk j >= 3 takes x of chunk j - 3
      const int j = c % kChunks;
      const int partner = j < kChunks / 2 ? c + kChunks / 2 : c - kChunks / 2;
      float p[8], cs[8], sn[8], y[8];
      unpack8(*reinterpret_cast<const uint4*>(&rows[warp][partner * 8]), p);
      load8f(a.cos + t * kD + j * 8, cs);
      load8f(a.sin + t * kD + j * 8, sn);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float rot = j < kChunks / 2 ? -p[e] : p[e];
        y[e] = __fadd_rn(__fmul_rn(v[i][e], cs[e]), __fmul_rn(rot, sn[e]));
      }
      *reinterpret_cast<uint4*>(a.xr + (size_t)m * a.d + c * 8) = pack8(y);
    }
  }
}

// 128-row tiles when they give every SM a block, else 64-row tiles
bool wide_rows(int row_tiles_of_128, int col_tiles) {
  return row_tiles_of_128 * col_tiles >= sm_count();
}

}  // namespace

extern "C" {

// x: [B*T, D] bf16; ln_g/ln_b: [D] fp32, or both null (no LayerNorm; xn is
// then not written and may be null); cos/sin: [T, 48] fp32; xn, xr: [B*T, D]
// bf16.  D % 48 == 0, D <= 1024, all pointers 16-byte aligned.  Returns
// cudaGetLastError().
int gigaam_ln_rope(const void* x, const void* ln_g, const void* ln_b,
                   const void* cos, const void* sin, void* xn, void* xr,
                   int m, int t, int d, void* stream) {
  RowArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.xn = static_cast<bf16*>(xn);
  a.xr = static_cast<bf16*>(xr);
  a.m = m;
  a.t = t;
  a.d = d;
  const dim3 grid((m + kRowWarps - 1) / kRowWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln_g != nullptr)
    ln_rope_kernel<true><<<grid, kRowWarps * 32, 0, s>>>(a);
  else
    ln_rope_kernel<false><<<grid, kRowWarps * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// xr, xv: [B*T, D] bf16 (the A of the q/k and of the v columns); w*: [D, D]
// bf16; b*: [D] fp32; q/k/v: [B, H, T, 48] bf16.  D % 128 == 0,
// D == 48 * n_heads, all pointers 16-byte aligned.  Returns the CUDA error
// code of the shared-memory opt-in or of the launch.
int gigaam_qkv_proj(const void* xr, const void* xv, const void* wq,
                    const void* wk, const void* wv, const void* bq,
                    const void* bk, const void* bv, void* q, void* k, void* v,
                    int batch, int t, int d, int n_heads, void* stream) {
  const QkvArgs a = qkv_args(xr, xv, wq, wk, wv, bq, bk, bv, q, k, v, batch,
                             t, d, n_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wide_rows((a.m + 127) / 128, 3 * d / 128)
                              ? launch_qkv<2, 128>(a, s)
                              : launch_qkv<1, 128>(a, s));
}

// o: [B, H, T, 48] bf16; wo: [D, D] bf16; bo: [D] fp32; residual: [B*T, D]
// bf16 or null; out: [B*T, D] bf16.  D % 128 == 0, D == 48 * n_heads.
// Returns the CUDA error code of the shared-memory opt-in or of the launch.
int gigaam_out_proj(const void* o, const void* wo, const void* bo,
                    const void* residual, void* out, int batch, int t, int d,
                    int n_heads, void* stream) {
  const OutArgs a = out_args(o, wo, bo, residual, out, t, d, n_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = wide_rows(batch * ((t + 127) / 128), d / 128);
  if (residual != nullptr)
    return static_cast<int>(wide ? launch_out<2, 128, kBf16Residual>(a, batch, s)
                                 : launch_out<1, 64, kBf16Residual>(a, batch, s));
  return static_cast<int>(wide ? launch_out<2, 128, kNoResidual>(a, batch, s)
                               : launch_out<1, 64, kNoResidual>(a, batch, s));
}

// For each GEMM configuration (qkv <2, 128>, qkv <1, 128>, out <2, 128>,
// out <1, 64>): out[2 i] its dynamic shared memory in bytes, out[2 i + 1]
// how many of its blocks one SM holds at a time.  Returns a CUDA error code.
int gigaam_projection_occupancy(int* out) {
  cudaError_t err;
  if ((err = occupancy(qkv_kernel<2, 128>, 2 * kThreads,
                       QkvTile<2, 128>::kSmem, out)) != cudaSuccess ||
      (err = occupancy(qkv_kernel<1, 128>, kThreads, QkvTile<1, 128>::kSmem,
                       out + 2)) != cudaSuccess ||
      (err = occupancy(out_proj_kernel<2, 128, kBf16Residual>, 2 * kThreads,
                       OutTile<2, 128>::kSmem, out + 4)) != cudaSuccess ||
      (err = occupancy(out_proj_kernel<1, 64, kBf16Residual>, kThreads,
                       OutTile<1, 64>::kSmem, out + 6)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

}  // extern "C"
