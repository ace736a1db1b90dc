// Transformer-XL relative-position attention core for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// gigaam_tpu/ops/pallas_attention.py::_attn_relpos_kernel (reached through
// fused_relpos_mha -> _relpos_pallas), the attention core of the rel-pos
// (v1/v2) encoder.
//
// What it computes, per (batch b, head h), for every query row i < T and
// every key j < T:
//   raw[i, p]  = q_v[i] . p_heads[h, p]                              (fp32)
//   bias[i, j] = float(bf16(raw[i, T-1-i+j]))        (relative position i-j)
//   s[i, j]    = (q_u[i] . k[j] + bias[i, j]) * scale
//                + (valid[b, j] ? 0 : -1e9)                           (fp32)
//   o[i]       = (sum_j bf16(exp(s[i, j] - m_i)) * v[j])
//                / (sum_j exp(s[i, j] - m_i))
//   lse[i]     = m_i + log(sum_j exp(s[i, j] - m_i))      (optional, fp32)
// with m_i the row max.  The bias is rounded to bf16 where the Pallas kernel
// rounds it (it shears the product in the input dtype); the rest follows
// attention.cu: fp32 softmax, P cast to bf16 before P.V, the division after
// P.V.  Query rows of masked frames are finite garbage by the same contract.
// lse is what the backward (relpos_attention_bwd.cu) starts from; inference
// passes a null pointer.
//
// Bound on the card: at the encoder's shapes (T' ~ 250-1130, d_h = 48) the
// three products (q_u.k^T, the positional term that is used, P.v:
// 6*B*H*T^2*d_h operations) dominate the bytes (five [B, H, T, 48] tensors
// and one [H, 2T-1, 48] table), so the kernel is bounded by operations.
//
// Design: attention.cu's kernel with one more term in the scores.  One block
// of one warpgroup per (64-row query tile, head, batch); K, V and the
// position table arrive in 64-row tiles through a `cp.async` ring, one block
// barrier a tile, so T is unbounded and neither the [T, T] scores nor the
// [T, 2T-1] positional term reach device memory.
//   * The Pallas kernel's log2(T) roll/select shear (which bounds it to
//     T <= 1024 there) becomes an index.  The window of key tile `it` is rows
//     base + 64 it .. base + 64 it + 127 of p_heads[h], base = T-1-q0-63: two
//     consecutive tiles of one stream, so each ring step loads one new
//     64-row tile of the table and every table row is read once a sweep.
//   * Four `wgmma` products a tile (wgmma.cuh has the layouts): S = Q_u.K^T
//     and the two halves of R = Q_v.W^T as m64n64k16 with both operands in
//     shared memory, O += P.V as m64n48k16 with P as the register operand.
//     R is twice the positional term that is used: a warpgroup product has
//     one B operand for all four warps, and each warp's band lies elsewhere.
//   * The shear is the one round trip through shared memory: R goes, rounded
//     to bf16, through a [64, 128] buffer and comes back as the bias in the
//     layout of the S fragment (a warp reads its own 16 rows: a warp barrier).
//     S, P and O never leave registers; the online softmax is attention.cu's
//     (exp2f on scores times scale * log2(e), quad shuffles for a row's max
//     and sum), and the output leaves as 16-byte stores.
// 72 KB of dynamic shared memory: three blocks an SM.

#include "wgmma.cuh"

using namespace gigaam;

namespace {

constexpr int kStages = 2;
static_assert(kWinSlots == kStages + 1,
              "a window is two stream tiles; one more is in flight");

// dynamic shared memory, in bytes from its (128-byte aligned) start
constexpr int kOffQu = 0;
constexpr int kOffQv = kOffQu + kTileBytes;
constexpr int kOffK = kOffQv + kTileBytes;
constexpr int kOffV = kOffK + kStages * kTileBytes;
constexpr int kOffWin = kOffV + kStages * kTileBytes;
constexpr int kOffBias = kOffWin + kWinSlots * kTileBytes;
constexpr int kOffMask = kOffBias + kBiasBytes;
constexpr int kSmemBytes = kOffMask + kStages * kTile * 4;

__global__ void __launch_bounds__(kThreads)
relpos_sdpa_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ qv,
                   const bf16* __restrict__ pos,
                   const uint8_t* __restrict__ valid, bf16* __restrict__ o,
                   float* __restrict__ lse, int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t qus = sbase + kOffQu, qvs = sbase + kOffQv;
  unsigned char* bias = smem + kOffBias;
  float* madd = reinterpret_cast<float*>(smem + kOffMask);
  auto ks = [&](int st) { return sbase + kOffK + st * kTileBytes; };
  auto vs = [&](int st) { return sbase + kOffV + st * kTileBytes; };
  auto win = [&](int u) {
    return sbase + kOffWin + (u % kWinSlots) * kTileBytes;
  };

  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const uint8_t* vrow = valid + (size_t)b * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;
  // stream tile u of the window holds table rows wrow0 + 64 u ..; key tile
  // `it` uses tiles it (window columns 0..63) and it + 1 (64..127)
  const int wrow0 = t - 1 - q0 - (kTile - 1);

  // the loads of key tile `tile` and of the window tile that it newly needs;
  // commits a group even when there is no such tile, so that the count of
  // pending groups is uniform
  auto prefetch = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, k0 = tile * kTile;
      load_tile_async(ks(st), k + base, k0, t);
      load_tile_async(vs(st), v + base, k0, t);
      load_tile_async(win(tile + 1), ph, wrow0 + (tile + 1) * kTile, n_pos);
      if (threadIdx.x < kTile)
        madd[st * kTile + threadIdx.x] = key_mask2(vrow, k0 + threadIdx.x, t);
    }
    cp_async_commit();
  };

  load_tile_async(qus, qu + base, q0, t);   // these join the first group
  load_tile_async(qvs, qv + base, q0, t);
  load_tile_async(win(0), ph, wrow0, n_pos);
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
    {
      float r_lo[32], r_hi[32];
      wgmma_fence();
      product_nt(r_lo, qvs, win(it));
      product_nt(r_hi, qvs, win(it + 1));
      product_nt(s, qus, ks(st));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(r_lo);
      fence_regs(r_hi);
      fence_regs(s);
      store_window_product(bias, r_lo, r_hi);
    }
    __syncwarp();
    add_bias(s, bias);

    uint32_t p[16];
    online_softmax_tile(s, madd + st * kTile, scale2, m_lo, m_hi, l_lo, l_hi,
                        o_acc, p);

    fence_regs(o_acc);
    wgmma_fence();
    accumulate_nn(o_acc, p, vs(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  store_fragment(o_acc, 1.f / l_lo, 1.f / l_hi, o + base, q0, t);
  if (lse != nullptr && (lane & 3) == 0) {
    const int row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    if (row < t) lse[bh * t + row] = (m_lo + log2f(l_lo)) * kLn2;
    if (row + 8 < t) lse[bh * t + row + 8] = (m_hi + log2f(l_hi)) * kLn2;
  }
}

}  // namespace

extern "C" {

// q_u, k, v, q_v, o: [B, H, T, 48] bf16; p_heads: [H, 2T-1, 48] bf16;
// valid: [B, T] bool (one byte each); all contiguous and 16-byte aligned;
// lse: [B, H, T] fp32 or null.  Returns the CUDA error code of the
// shared-memory opt-in or of the launch.
int gigaam_relpos_sdpa(const void* q_u, const void* k, const void* v,
                       const void* q_v, const void* p_heads, const void* valid,
                       void* o, void* lse, int batch, int n_heads, int t,
                       float scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_sdpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kTile - 1) / kTile, n_heads, batch);
  relpos_sdpa_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(o), static_cast<float*>(lse), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

// out[0]: the kernel's dynamic shared memory in bytes; out[1]: how many of
// its blocks one SM holds at a time.  Returns a CUDA error code.
int gigaam_relpos_sdpa_occupancy(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      relpos_sdpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], relpos_sdpa_kernel, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

}  // extern "C"
