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
//   * The body lives in sdpa_core.cuh, templated on the variants of the SDPA
//     ablation (sdpa_ablation.cu); this is its full variant in the
//     head-major layout.

#include "sdpa_core.cuh"

using namespace gigaam;

namespace {

__global__ void __launch_bounds__(kThreads)
sdpa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
            bf16* __restrict__ o, float* __restrict__ lse, int n_heads, int t,
            float scale) {
  sdpa_body<kSdpaFull, kSdpaHeads>(q, k, v, valid, o, lse, n_heads, t, scale,
                                   1);
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
