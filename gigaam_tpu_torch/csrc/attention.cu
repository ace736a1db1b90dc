// Masked scaled-dot-product attention core for Hopper (sm_90a).
//
// Replaces the Pallas kernel gigaam_tpu/ops/pallas_attention.py::_attn_kernel
// (reached through fused_mha -> _mha_pallas), and is the SDPA stage of the
// two folded attention kernels (_fold_rotary_kernel, _fold_rotary_lnres_kernel)
// whose Hopper decomposition is projection.cu + this kernel.
//
// What it computes, per (batch b, head h), for every query row i < T:
//   s[i, j] = scale * q[i] . k[j] + (valid[b, j] ? 0 : -1e9)      (fp32)
//   o[i]    = (sum_j bf16(exp(s[i, j] - m_i)) * v[j]) / (sum_j exp(s[i, j] - m_i))
//   lse[i]  = m_i + log(sum_j exp(s[i, j] - m_i))       (optional, fp32)
// with m_i the row max: fp32 softmax, P cast to bf16 before P.V, the division
// after P.V, as the Pallas kernel does.  Query rows of masked frames are
// finite garbage by the same contract.  lse is what the backward
// (attention_bwd.cu) starts from; inference passes a null pointer.
//
// Bound on the card: at the encoder's shapes (T' <= ~1200, d_h = 48) the
// score work 4*B*H*T^2*d_h dominates the bytes (q, k, v, o: 8*B*H*T*d_h), so
// the kernel is bounded by operations.
//
// Design: one block of one warpgroup per (64-row query tile, head, batch).
//   * K and V arrive in 64-key tiles through a ring of kStages stages filled
//     by `cp.async`: the loads of tile i + kStages - 1 are started before the
//     products of tile i start, one block barrier a tile.
//   * Both products run on `wgmma` (wgmma.cuh has the tile layout): S = Q.K^T
//     as m64n64k16 over three k-steps with both operands in shared memory,
//     O += P.V as m64n48k16 over four k-steps with P as the register operand
//     and V read MN-major (the transpose bit), so V needs no transposed copy.
//   * Scores, P and O never leave registers: the online softmax (running max
//     and sum) works on the accumulator fragment, a row's max and sum are
//     combined across the four lanes that share the row by shuffles, P is
//     packed to bf16 where it stands and is the A fragment of P.V, and O is
//     rescaled in its accumulator.  Shared memory holds Q, the ring and the
//     ring's key masks only.
//   * exp2f on scores multiplied by scale * log2(e) in the same fma that adds
//     the mask: a masked key is -1e9 * log2(e) (its P is exactly 0 beside any
//     valid key), a key past T is -inf.
//   * The output leaves as 16-byte stores (store_fragment).

#include "wgmma.cuh"

using namespace gigaam;

namespace {

constexpr int kStages = 2;

__global__ void __launch_bounds__(kThreads)
sdpa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
            bf16* __restrict__ o, float* __restrict__ lse, int n_heads, int t,
            float scale) {
  __shared__ __align__(128) unsigned char qs[kTileBytes];
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

  // the loads of key tile `tile` into its stage; commits a group even when
  // there is no such tile, so that the count of pending groups is uniform
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

  load_tile_async(smem_u32(qs), q + base, q0, t);   // joins the first group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // this thread's two rows (g and g + 8 of its warp's 16): running max in
  // base-2 units, its share of the running sum, and the output fragment
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o_acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) o_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    ring_wait<kStages>();   // tile `it` is whole, tile `it - 1` consumed
    prefetch(it + kStages - 1);
    const int st = it % kStages;

    float s[32];
    wgmma_fence();
    product_nt(s, smem_u32(qs), smem_u32(ks[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&madd[st][8 * j + 2 * l]);
      s[4 * j] = fmaf(s[4 * j], scale2, mk.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, mk.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, mk.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, mk.y);
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // every tile holds a key below T, so the new max is finite
    const float new_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float new_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = exp2f(m_lo - new_lo), corr_hi = exp2f(m_hi - new_hi);
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
    uint32_t p[16];
    pack_fragment(s, p);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      o_acc[4 * j] *= corr_lo;
      o_acc[4 * j + 1] *= corr_lo;
      o_acc[4 * j + 2] *= corr_hi;
      o_acc[4 * j + 3] *= corr_hi;
    }

    fence_regs(o_acc);
    wgmma_fence();
    accumulate_nn(o_acc, p, smem_u32(vs[st]));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  store_fragment(o_acc, 1.f / l_lo, 1.f / l_hi, o + base, q0, t);
  if (lse != nullptr && l == 0) {
    const int row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    if (row < t) lse[bh * t + row] = (m_lo + log2f(l_lo)) * kLn2;
    if (row + 8 < t) lse[bh * t + row + 8] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, 48] bf16, contiguous, 16-byte aligned;
// valid: [B, T] bool (one byte each); lse: [B, H, T] fp32 or null.
// Returns cudaGetLastError().
int gigaam_sdpa(const void* q, const void* k, const void* v, const void* valid,
                void* o, void* lse, int batch, int n_heads, int t, float scale,
                void* stream) {
  dim3 grid((t + kTile - 1) / kTile, n_heads, batch);
  sdpa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(o), static_cast<float*>(lse), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
