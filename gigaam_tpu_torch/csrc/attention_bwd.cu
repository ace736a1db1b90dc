// Backward of the masked scaled-dot-product attention core for Hopper
// (sm_90a): the gradient of attention.cu.
//
// Replaces the Pallas kernel
// gigaam_tpu/ops/pallas_attention.py::_attn_bwd_kernel (reached through
// _mha_bwd_pallas, the custom VJP of fused_mha), the attention backward of
// every rotary (v3) fine-tuning step.
//
// What it computes, per (batch b, head h), from q, k, v, the output gradient
// do [T, 48], the key mask, and what the forward left: its output `out`
// [T, 48] and the rows' log-sum-exp lse [T] (fp32, natural log, of the scaled
// and masked scores):
//   s[i, j]  = scale * q[i] . k[j] + (valid[b, j] ? 0 : -1e9)        (fp32)
//   P[i, j]  = exp(s[i, j] - lse_i)
//   dv[j]    = sum_i bf16(P[i, j]) * do[i]
//   dP[i, j] = do[i] . v[j]                                          (fp32)
//   D_i      = sum_c do[i, c] * out[i, c]               (= sum_j dP P, fp32)
//   ds[i, j] = bf16(P[i, j] * (dP[i, j] - D_i) * scale)
//   dq[i]    = sum_j ds[i, j] * k[j]        dk[j] = sum_i ds[i, j] * q[i]
// with the Pallas kernel's rounding points: fp32 scores and softmax, P cast
// to bf16 before dv, ds cast to bf16 before dq and dk, fp32 accumulation.
// D differs from the Pallas kernel's sum_j dP[i, j] P[i, j] by the bf16
// rounding of `out`.  Rows of masked keys get dk = dv = 0 (their P is
// exp(-1e9) = 0); rows of padded queries hold finite garbage in dq, as the
// forward's output does.
//
// Bound on the card: at the encoder's shapes the five products
// (10*B*H*T^2*d_h operations) dominate the bytes (q, k, v, do, out, lse in;
// dq, dk, dv out), so the kernel is bounded by operations.
//
// Design.  The Pallas kernel holds the whole [T, T] fp32 probability block
// of one (batch, head) in VMEM, which bounds it at T = 768.  Here tiles are
// streamed, so T is unbounded, and the work is split by who owns which sum,
// in two launches that need no atomics and give the same bits every run.
// Each sweeps the other side's tiles once: with lse and D at hand no row
// statistic is recomputed, and each score costs one exp2f a launch.
//
// 1. sdpa_bwd_dq_kernel, one block per (64-row query tile, head, batch),
//    first forms D for its 64 rows from the `do` and `out` rows (a quad of
//    lanes per row), and writes D and lse * log2(e) to the `stats` scratch
//    for the second launch.  Then one sweep over the key tiles: S = Q.K^T and
//    dP = dO.V^T into register accumulators, P and ds in registers, and
//    dq += ds.K with ds as the register operand.  Three products.
// 2. sdpa_bwd_dkv_kernel, one block per (64-key tile, head, batch), sweeps
//    the query tiles with the transposed products S^T = K.Q^T and
//    dP^T = V.dO^T, so that P^T and ds^T come out as the register operands of
//    dv += P^T.dO and dk += ds^T.Q; lse and D are read per column from the
//    ring stage.  Four products.
//
// Seven products where five are the least: the price of having no atomics.
// All run on `wgmma` (wgmma.cuh has the tile layout and the fragments), the
// streamed tiles arrive through a `cp.async` ring of kStages stages, one
// block barrier a tile, and scores, dP, P and ds never touch shared memory.

#include "wgmma.cuh"

using namespace gigaam;

namespace {

constexpr int kStages = 2;

__global__ void __launch_bounds__(kThreads)
sdpa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const bf16* __restrict__ out, const float* __restrict__ lse,
                   const uint8_t* __restrict__ valid, bf16* __restrict__ dq,
                   float* __restrict__ stats, int n_heads, int t, float scale) {
  __shared__ __align__(128) unsigned char qs[kTileBytes];
  __shared__ __align__(128) unsigned char dos[kTileBytes];
  __shared__ __align__(128) unsigned char ks[kStages][kTileBytes];
  __shared__ __align__(128) unsigned char vs[kStages][kTileBytes];
  __shared__ __align__(16) float madd[kStages][kTile];

  const int lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + blockIdx.y;
  const size_t base = bh * t * kD;
  const uint8_t* vrow = valid + (size_t)b * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;

  auto prefetch = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, k0 = tile * kTile;
      load_tile_async(smem_u32(ks[st]), k + base, k0, t);
      load_tile_async(smem_u32(vs[st]), v + base, k0, t);
      if (threadIdx.x < kTile)
        madd[st][threadIdx.x] = key_mask2(vrow, k0 + threadIdx.x, t);
    }
    cp_async_commit();
  };

  load_tile_async(smem_u32(qs), q + base, q0, t);       // join the first group
  load_tile_async(smem_u32(dos), dout + base, q0, t);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // this thread's two rows (g and g + 8 of its warp's 16): D and lse in
  // base-2 units.  Past T both are 0, and with q and do zero-filled there
  // ds is exactly 0.
  const int row_lo = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;
  const float d_lo = row_dot(dout + base, out + base, row_lo, t, l);
  const float d_hi = row_dot(dout + base, out + base, row_hi, t, l);
  const float lse_lo = row_lo < t ? lse[bh * t + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < t ? lse[bh * t + row_hi] * kLog2e : 0.f;
  if (l == 0) {
    const size_t n_rows = (size_t)gridDim.z * n_heads * t;
    if (row_lo < t) {
      stats[bh * t + row_lo] = lse_lo;
      stats[n_rows + bh * t + row_lo] = d_lo;
    }
    if (row_hi < t) {
      stats[bh * t + row_hi] = lse_hi;
      stats[n_rows + bh * t + row_hi] = d_hi;
    }
  }

  float dq_acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) dq_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    ring_wait<kStages>();   // tile `it` is whole, tile `it - 1` consumed
    prefetch(it + kStages - 1);
    const int st = it % kStages;

    float s[32], dp[32];
    wgmma_fence();
    product_nt(s, smem_u32(qs), smem_u32(ks[st]));
    product_nt(dp, smem_u32(dos), smem_u32(vs[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // ds over s, in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&madd[st][8 * j + 2 * l]);
      const float p0 = exp2f(fmaf(s[4 * j], scale2, mk.x) - lse_lo);
      const float p1 = exp2f(fmaf(s[4 * j + 1], scale2, mk.y) - lse_lo);
      const float p2 = exp2f(fmaf(s[4 * j + 2], scale2, mk.x) - lse_hi);
      const float p3 = exp2f(fmaf(s[4 * j + 3], scale2, mk.y) - lse_hi);
      s[4 * j] = p0 * (dp[4 * j] - d_lo) * scale;
      s[4 * j + 1] = p1 * (dp[4 * j + 1] - d_lo) * scale;
      s[4 * j + 2] = p2 * (dp[4 * j + 2] - d_hi) * scale;
      s[4 * j + 3] = p3 * (dp[4 * j + 3] - d_hi) * scale;
    }
    uint32_t ds[16];
    pack_fragment(s, ds);

    fence_regs(dq_acc);
    wgmma_fence();
    accumulate_nn(dq_acc, ds, smem_u32(ks[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
  }

  store_fragment(dq_acc, 1.f, 1.f, dq + base, q0, t);
}

__global__ void __launch_bounds__(kThreads)
sdpa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ stats, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n_heads, int t, float scale) {
  __shared__ __align__(128) unsigned char ks[kTileBytes];
  __shared__ __align__(128) unsigned char vs[kTileBytes];
  __shared__ __align__(128) unsigned char qs[kStages][kTileBytes];
  __shared__ __align__(128) unsigned char dos[kStages][kTileBytes];
  __shared__ __align__(16) float lse_s[kStages][kTile];   // lse * log2(e)
  __shared__ __align__(16) float d_s[kStages][kTile];

  const int lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + blockIdx.y;
  const size_t base = bh * t * kD;
  const size_t n_rows = (size_t)gridDim.z * n_heads * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;

  // the loads of query tile `tile`: q, do and the rows' lse and D (zero past
  // T: with q and do zero-filled there, P.do and ds are exactly 0)
  auto prefetch = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, q0 = tile * kTile;
      load_tile_async(smem_u32(qs[st]), q + base, q0, t);
      load_tile_async(smem_u32(dos[st]), dout + base, q0, t);
      const int i = threadIdx.x % kTile;
      const bool in = q0 + i < t;
      const size_t at = bh * t + (in ? q0 + i : 0);
      if (threadIdx.x < kTile)
        cp_async_4(smem_u32(&lse_s[st][i]), stats + at, in ? 4 : 0);
      else
        cp_async_4(smem_u32(&d_s[st][i]), stats + n_rows + at, in ? 4 : 0);
    }
    cp_async_commit();
  };

  load_tile_async(smem_u32(ks), k + base, k0, t);        // join the first group
  load_tile_async(smem_u32(vs), v + base, k0, t);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // this thread's two key rows (g and g + 8 of its warp's 16) and their mask
  const uint8_t* vrow = valid + (size_t)b * t;
  const int key_lo = k0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int key_hi = key_lo + 8;
  const float madd_lo = key_mask2(vrow, key_lo, t);
  const float madd_hi = key_mask2(vrow, key_hi, t);

  float dk_acc[24], dv_acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    ring_wait<kStages>();   // tile `it` is whole, tile `it - 1` consumed
    prefetch(it + kStages - 1);
    const int st = it % kStages;

    // transposed: rows are this block's keys, columns the tile's queries
    float s[32], dp[32];
    wgmma_fence();
    product_nt(s, smem_u32(ks), smem_u32(qs[st]));
    product_nt(dp, smem_u32(vs), smem_u32(dos[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T over s and ds^T over dp, in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&lse_s[st][8 * j + 2 * l]);
      const float2 dd = *reinterpret_cast<const float2*>(&d_s[st][8 * j + 2 * l]);
      s[4 * j] = exp2f(fmaf(s[4 * j], scale2, madd_lo) - ls.x);
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale2, madd_lo) - ls.y);
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale2, madd_hi) - ls.x);
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale2, madd_hi) - ls.y);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - dd.x) * scale;
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dd.y) * scale;
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dd.x) * scale;
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dd.y) * scale;
    }
    uint32_t p[16], ds[16];
    pack_fragment(s, p);
    pack_fragment(dp, ds);

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    accumulate_nn(dv_acc, p, smem_u32(dos[st]));
    accumulate_nn(dk_acc, ds, smem_u32(qs[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  store_fragment(dk_acc, 1.f, 1.f, dk + base, k0, t);
  store_fragment(dv_acc, 1.f, 1.f, dv + base, k0, t);
}

}  // namespace

extern "C" {

// q, k, v, d_out, out, dq, dk, dv: [B, H, T, 48] bf16, contiguous, 16-byte
// aligned; lse: [B, H, T] fp32, the forward's; valid: [B, T] bool (one byte
// each); stats: [2, B, H, T] fp32 scratch (lse * log2(e), D).  Returns the
// CUDA error code of the launches.
int gigaam_sdpa_bwd(const void* q, const void* k, const void* v,
                    const void* d_out, const void* out, const void* lse,
                    const void* valid, void* dq, void* dk, void* dv,
                    void* stats, int batch, int n_heads, int t, float scale,
                    void* stream) {
  dim3 grid((t + kTile - 1) / kTile, n_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sdpa_bwd_dq_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
      static_cast<const bf16*>(out), static_cast<const float*>(lse),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(dq),
      static_cast<float*>(stats), n_heads, t, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sdpa_bwd_dkv_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
