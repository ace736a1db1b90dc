// Backward of the Transformer-XL relative-position attention core for
// Hopper (sm_90a): the gradient of relpos_attention.cu.
//
// Replaces the Pallas kernel
// gigaam_tpu/ops/pallas_attention.py::_attn_relpos_bwd_kernel (reached
// through _relpos_bwd_pallas, the custom VJP of fused_relpos_mha), the
// attention backward of every rel-pos (v1/v2) fine-tuning step.
//
// What it computes, per (batch b, head h), from q_u, k, v, q_v, the
// projected position table p_heads[h] [2T-1, 48], the output gradient
// do [T, 48], the key mask, and what the forward left: its output `out`
// [T, 48] and the rows' log-sum-exp lse [T] (fp32, natural log, of the
// scaled, biased and masked scores):
//   bias[i, j] = float(bf16(q_v[i] . p_heads[h, T-1-i+j]))
//   s[i, j]    = (q_u[i] . k[j] + bias[i, j]) * scale
//                + (valid[b, j] ? 0 : -1e9)                            (fp32)
//   P[i, j]    = exp(s[i, j] - lse_i)
//   dv[j]      = sum_i bf16(P[i, j]) * do[i]
//   dP[i, j]   = do[i] . v[j]                                          (fp32)
//   D_i        = sum_c do[i, c] * out[i, c]             (= sum_j dP P, fp32)
//   dz[i, j]   = bf16(P[i, j] * (dP[i, j] - D_i) * scale)
//   dq_u[i]    = sum_j dz[i, j] * k[j]      dk[j] = sum_i dz[i, j] * q_u[i]
//   dq_v[i]    = sum_j dz[i, j] * p_heads[h, T-1-i+j]
//   dp[h, c]   = sum_b sum_i dz[i, c-(T-1)+i] * q_v[i]  (fp32 over the batch)
// with the Pallas kernel's rounding points: the bias rounded to bf16 where
// the forward rounds it, fp32 scores and softmax, P cast to bf16 before dv,
// dz cast to bf16 before every product that consumes it, fp32 accumulation.
// D differs from the Pallas kernel's sum_j dP[i, j] P[i, j] by the bf16
// rounding of `out`.  The caller passes dp zeroed and casts it once after
// the launch.  Rows of padded queries hold finite garbage in dq_u and dq_v
// unless `do` is zero there, as the forward's output does.
//
// Bound on the card: the products (8*B*H*T^2*d_h used multiply-adds:
// q_u.k, the positional term, do.v, P.do, dz.k, dz.q_u, dz.p, dz.q_v)
// dominate the bytes, so the kernel is bounded by operations.
//
// Design.  The Pallas kernel holds the [T, T] fp32 probabilities and the
// whole position table of one (batch, head) in VMEM (T <= 768 there) and
// unshears dz with a log2(T) ladder of rolls.  Here tiles are streamed
// through a `cp.async` ring, T is unbounded, every product runs on `wgmma`,
// and the shear and the unshear are indices into the window of
// relpos_attention.cu (wgmma.cuh has the layouts): the (64-query tile at q0,
// 64-key tile at k0) pair touches only rows T-1-q0-63+k0 .. T-1-q0+k0+63 of
// p_heads, two tiles of a stream of which each ring step loads one.  With
// lse and D at hand no row statistic is recomputed: each launch sweeps the
// other side's tiles once.  The work is split by who owns which sum:
//
// 1. relpos_bwd_dq_kernel, one block per (64-row query tile, head, batch),
//    first forms D for its 64 rows from the `do` and `out` rows and writes D
//    and lse * log2(e) to the `stats` scratch.  Then one sweep over the key
//    tiles.  R = Q_v.W^T goes, rounded to bf16, through the bias buffer (the
//    one round trip of the scores' side, a warp barrier); S = Q_u.K^T and
//    dP = dO.V^T stay in registers, as do P and dz; dq_u += dz.K takes dz as
//    the register operand.  dz is also written skewed into G,
//    G[li][63 - li + lj] = dz[li][lj], in the core-matrix layout, so that
//    dq_v += G.W and the window's share of dp, G^T.Q_v (G read transposed),
//    are `wgmma` products too.  Eight products a tile (dq_v's is 128 deep).
//    dp: window rows 0..63 of key tile `it` are complete once that tile is
//    done (tile it + 1 touches rows 64 and beyond), so the [128, 48]
//    accumulator stays in registers across tiles: the finished half is
//    flushed and the other half moves down.  Every dp row is added once per
//    (query tile, batch element) with 8-byte vector atomics, half of what a
//    flush per (query tile, key tile) needs.  fp32 atomics: dp's low bits
//    depend on the order of the blocks and differ from run to run.
//    Everything else is deterministic.
// 2. relpos_bwd_dkv_kernel, one block per (64-key tile, head, batch), sweeps
//    the query tiles (the window stream read backwards) with the transposed
//    products S^T = K.Q_u^T and dP^T = V.dO^T, so that P^T and dz^T come out
//    as the register operands of dv += P^T.dO and dk += dz^T.Q_u.  The bias
//    reaches the transposed fragment through the same buffer, read as
//    [lj][li]: rows written by every warp, so a block barrier.  Six products.
//
// 94 KB and 84 KB of dynamic shared memory: two blocks an SM.

#include "wgmma.cuh"

using namespace gigaam;

namespace {

constexpr int kStages = 2;
static_assert(kWinSlots == kStages + 1,
              "a window is two stream tiles; one more is in flight");

// dynamic shared memory of the dq kernel, in bytes from its start
constexpr int kDqOffQu = 0;
constexpr int kDqOffQv = kDqOffQu + kTileBytes;
constexpr int kDqOffDo = kDqOffQv + kTileBytes;
constexpr int kDqOffK = kDqOffDo + kTileBytes;
constexpr int kDqOffV = kDqOffK + kStages * kTileBytes;
constexpr int kDqOffWin = kDqOffV + kStages * kTileBytes;
constexpr int kDqOffBias = kDqOffWin + kWinSlots * kTileBytes;
constexpr int kDqOffSkew = kDqOffBias + kBiasBytes;
constexpr int kDqOffMask = kDqOffSkew + kSkewBytes;
constexpr int kDqSmemBytes = kDqOffMask + kStages * kTile * 4;
static_assert(kDqOffSkew % 128 == 0, "G holds whole core matrices");

__global__ void __launch_bounds__(kThreads)
relpos_bwd_dq_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ qv,
                     const bf16* __restrict__ pos,
                     const bf16* __restrict__ dout,
                     const bf16* __restrict__ out,
                     const float* __restrict__ lse,
                     const uint8_t* __restrict__ valid,
                     bf16* __restrict__ dqu, bf16* __restrict__ dqv,
                     float* __restrict__ dp, float* __restrict__ stats,
                     int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t qus = sbase + kDqOffQu, qvs = sbase + kDqOffQv;
  const uint32_t dos = sbase + kDqOffDo, skew = sbase + kDqOffSkew;
  unsigned char* bias = smem + kDqOffBias;
  unsigned char* skew_p = smem + kDqOffSkew;
  float* madd = reinterpret_cast<float*>(smem + kDqOffMask);
  auto ks = [&](int st) { return sbase + kDqOffK + st * kTileBytes; };
  auto vs = [&](int st) { return sbase + kDqOffV + st * kTileBytes; };
  auto win = [&](int u) {
    return sbase + kDqOffWin + (u % kWinSlots) * kTileBytes;
  };

  const int lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const uint8_t* vrow = valid + (size_t)b * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;
  float* dph = dp + (size_t)h * n_pos * kD;
  // stream tile u of the window holds table rows wrow0 + 64 u ..; key tile
  // `it` uses tiles it (window rows 0..63) and it + 1 (64..127)
  const int wrow0 = t - 1 - q0 - (kTile - 1);

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

  load_tile_async(qus, qu + base, q0, t);       // these join the first group
  load_tile_async(qvs, qv + base, q0, t);
  load_tile_async(dos, dout + base, q0, t);
  load_tile_async(win(0), ph, wrow0, n_pos);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  // G's zeros, written once: every tile overwrites the same band
  for (int i = threadIdx.x; i < kSkewBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(skew_p)[i] = make_uint4(0, 0, 0, 0);

  // this thread's two rows (g and g + 8 of its warp's 16): D and lse in
  // base-2 units.  Past T both are 0, and with q_u, q_v and do zero-filled
  // there dz is exactly 0.
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

  // dp_lo and dp_hi: window rows 0..63 and 64..127 of the current key tile
  float dqu_acc[24], dqv_acc[24], dp_lo[24], dp_hi[24];
#pragma unroll
  for (int i = 0; i < 24; ++i)
    dqu_acc[i] = dqv_acc[i] = dp_lo[i] = dp_hi[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    ring_wait<kStages>();   // tile `it` is whole, tile `it - 1` consumed
    prefetch(it + kStages - 1);
    const int st = it % kStages;
    const uint32_t w_lo = win(it), w_hi = win(it + 1);

    {
      float r_lo[32], r_hi[32];
      wgmma_fence();
      product_nt(r_lo, qvs, w_lo);
      product_nt(r_hi, qvs, w_hi);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(r_lo);
      fence_regs(r_hi);
      store_window_product(bias, r_lo, r_hi);
    }
    __syncwarp();

    float s[32], dprob[32];
    wgmma_fence();
    product_nt(s, qus, ks(st));
    product_nt(dprob, dos, vs(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dprob);
    add_bias(s, bias);

    // dz over s, in place
    const float* mk_row = madd + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&mk_row[8 * j + 2 * l]);
      const float p0 = exp2f(fmaf(s[4 * j], scale2, mk.x) - lse_lo);
      const float p1 = exp2f(fmaf(s[4 * j + 1], scale2, mk.y) - lse_lo);
      const float p2 = exp2f(fmaf(s[4 * j + 2], scale2, mk.x) - lse_hi);
      const float p3 = exp2f(fmaf(s[4 * j + 3], scale2, mk.y) - lse_hi);
      s[4 * j] = p0 * (dprob[4 * j] - d_lo) * scale;
      s[4 * j + 1] = p1 * (dprob[4 * j + 1] - d_lo) * scale;
      s[4 * j + 2] = p2 * (dprob[4 * j + 2] - d_hi) * scale;
      s[4 * j + 3] = p3 * (dprob[4 * j + 3] - d_hi) * scale;
    }
    uint32_t dz[16];
    pack_fragment(s, dz);
    store_skewed(skew_p, dz);
    // G was written through the generic proxy and is read by `wgmma`
    fence_proxy_async();
    __syncthreads();        // every warp's rows of G are written

    fence_regs(dqu_acc);
    fence_regs(dqv_acc);
    fence_regs(dp_lo);
    fence_regs(dp_hi);
    wgmma_fence();
    accumulate_nn(dqu_acc, dz, ks(st));
#pragma unroll
    for (int kk = 0; kk < 2 * kTile / 16; ++kk)
      wgmma_ss_n48<0>(dqv_acc, skew_desc(skew, kk),
                      desc_mn_major(kk < kTile / 16 ? w_lo : w_hi,
                                    kk % (kTile / 16)), 1);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_ss_n48<1>(dp_lo, skew_desc_t(skew, 0, kk), desc_mn_major(qvs, kk),
                      1);
      wgmma_ss_n48<1>(dp_hi, skew_desc_t(skew, 1, kk), desc_mn_major(qvs, kk),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqu_acc);
    fence_regs(dqv_acc);
    fence_regs(dp_lo);
    fence_regs(dp_hi);

    // window rows 0..63 are complete: the next tile's window starts at 64
    atomic_add_fragment(dp_lo, dph, wrow0 + it * kTile, n_pos);
#pragma unroll
    for (int i = 0; i < 24; ++i) dp_lo[i] = dp_hi[i];
  }
  atomic_add_fragment(dp_lo, dph, wrow0 + n_tiles * kTile, n_pos);

  store_fragment(dqu_acc, 1.f, 1.f, dqu + base, q0, t);
  store_fragment(dqv_acc, 1.f, 1.f, dqv + base, q0, t);
}

// dynamic shared memory of the dk/dv kernel
constexpr int kDkvOffK = 0;
constexpr int kDkvOffV = kDkvOffK + kTileBytes;
constexpr int kDkvOffQu = kDkvOffV + kTileBytes;
constexpr int kDkvOffQv = kDkvOffQu + kStages * kTileBytes;
constexpr int kDkvOffDo = kDkvOffQv + kStages * kTileBytes;
constexpr int kDkvOffWin = kDkvOffDo + kStages * kTileBytes;
constexpr int kDkvOffBias = kDkvOffWin + kWinSlots * kTileBytes;
constexpr int kDkvOffLse = kDkvOffBias + kBiasBytes;     // lse * log2(e)
constexpr int kDkvOffD = kDkvOffLse + kStages * kTile * 4;
constexpr int kDkvSmemBytes = kDkvOffD + kStages * kTile * 4;

__global__ void __launch_bounds__(kThreads)
relpos_bwd_dkv_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ qv,
                      const bf16* __restrict__ pos,
                      const bf16* __restrict__ dout,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ stats, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ks = sbase + kDkvOffK, vs = sbase + kDkvOffV;
  unsigned char* bias = smem + kDkvOffBias;
  float* lse_s = reinterpret_cast<float*>(smem + kDkvOffLse);
  float* d_s = reinterpret_cast<float*>(smem + kDkvOffD);
  auto qus = [&](int st) { return sbase + kDkvOffQu + st * kTileBytes; };
  auto qvs = [&](int st) { return sbase + kDkvOffQv + st * kTileBytes; };
  auto dos = [&](int st) { return sbase + kDkvOffDo + st * kTileBytes; };
  auto win = [&](int u) {
    return sbase + kDkvOffWin + (u % kWinSlots) * kTileBytes;
  };

  const int lane = threadIdx.x & 31;
  const int l = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const size_t n_rows = (size_t)gridDim.z * n_heads * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;
  // The window moves down by 64 rows a query tile: stream tile u holds table
  // rows wrow0 - 64 u ..; query tile `it` uses tiles it + 1 (window rows
  // 0..63) and it (64..127)
  const int wrow0 = t + k0;

  // the loads of query tile `tile`: q_u, q_v, do, the rows' lse and D (zero
  // past T: with q_u, q_v and do zero-filled there, P.do and dz are exactly
  // 0) and the window tile that it newly needs
  auto prefetch = [&](int tile) {
    if (tile < n_tiles) {
      const int st = tile % kStages, q0 = tile * kTile;
      load_tile_async(qus(st), qu + base, q0, t);
      load_tile_async(qvs(st), qv + base, q0, t);
      load_tile_async(dos(st), dout + base, q0, t);
      load_tile_async(win(tile + 1), ph, wrow0 - (tile + 1) * kTile, n_pos);
      const int i = threadIdx.x % kTile;
      const bool in = q0 + i < t;
      const size_t at = bh * t + (in ? q0 + i : 0);
      if (threadIdx.x < kTile)
        cp_async_4(smem_u32(&lse_s[st * kTile + i]), stats + at, in ? 4 : 0);
      else
        cp_async_4(smem_u32(&d_s[st * kTile + i]), stats + n_rows + at,
                   in ? 4 : 0);
    }
    cp_async_commit();
  };

  load_tile_async(ks, k + base, k0, t);        // these join the first group
  load_tile_async(vs, v + base, k0, t);
  load_tile_async(win(0), ph, wrow0, n_pos);
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

    // R for the tile's 64 queries (rows) over the 128 window rows (columns)
    {
      float r_lo[32], r_hi[32];
      wgmma_fence();
      product_nt(r_lo, qvs(st), win(it + 1));
      product_nt(r_hi, qvs(st), win(it));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(r_lo);
      fence_regs(r_hi);
      store_window_product(bias, r_lo, r_hi);
    }
    __syncthreads();        // every warp's rows of R are written

    // transposed: rows are this block's keys, columns the tile's queries
    float s[32], dprob[32];
    wgmma_fence();
    product_nt(s, ks, qus(st));
    product_nt(dprob, vs, dos(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dprob);
    add_bias_transposed(s, bias);

    // P^T over s and dz^T over dprob, in place
    const float* lse_row = lse_s + st * kTile;
    const float* d_row = d_s + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&lse_row[8 * j + 2 * l]);
      const float2 dd = *reinterpret_cast<const float2*>(&d_row[8 * j + 2 * l]);
      s[4 * j] = exp2f(fmaf(s[4 * j], scale2, madd_lo) - ls.x);
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale2, madd_lo) - ls.y);
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale2, madd_hi) - ls.x);
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale2, madd_hi) - ls.y);
      dprob[4 * j] = s[4 * j] * (dprob[4 * j] - dd.x) * scale;
      dprob[4 * j + 1] = s[4 * j + 1] * (dprob[4 * j + 1] - dd.y) * scale;
      dprob[4 * j + 2] = s[4 * j + 2] * (dprob[4 * j + 2] - dd.x) * scale;
      dprob[4 * j + 3] = s[4 * j + 3] * (dprob[4 * j + 3] - dd.y) * scale;
    }
    uint32_t p[16], dz[16];
    pack_fragment(s, p);
    pack_fragment(dprob, dz);

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    accumulate_nn(dv_acc, p, dos(st));
    accumulate_nn(dk_acc, dz, qus(st));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  store_fragment(dk_acc, 1.f, 1.f, dk + base, k0, t);
  store_fragment(dv_acc, 1.f, 1.f, dv + base, k0, t);
}

cudaError_t opt_in_shared_memory() {
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      relpos_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmemBytes);
}

}  // namespace

extern "C" {

// q_u, k, v, q_v, d_out, out, dq_u, dk, dv, dq_v: [B, H, T, 48] bf16;
// p_heads: [H, 2T-1, 48] bf16; lse: [B, H, T] fp32, the forward's; dp:
// [H, 2T-1, 48] fp32, zeroed by the caller and added into; valid: [B, T] bool
// (one byte each); stats: [2, B, H, T] fp32 scratch (lse * log2(e), D).  All
// contiguous and 16-byte aligned.  Returns the CUDA error code of the
// shared-memory opt-in or of the launches.
int gigaam_relpos_sdpa_bwd(const void* q_u, const void* k, const void* v,
                           const void* q_v, const void* p_heads,
                           const void* d_out, const void* out, const void* lse,
                           const void* valid, void* dq_u, void* dk, void* dv,
                           void* dq_v, void* dp, void* stats, int batch,
                           int n_heads, int t, float scale, void* stream) {
  cudaError_t err = opt_in_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kTile - 1) / kTile, n_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  relpos_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, st>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const bf16*>(d_out),
      static_cast<const bf16*>(out), static_cast<const float*>(lse),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(dq_u),
      static_cast<bf16*>(dq_v), static_cast<float*>(dp),
      static_cast<float*>(stats), n_heads, t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, st>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

// out[0], out[1]: the dq kernel's dynamic shared memory in bytes and how
// many of its blocks one SM holds at a time; out[2], out[3]: the same for
// the dk/dv kernel.  Returns a CUDA error code.
int gigaam_relpos_sdpa_bwd_occupancy(int* out) {
  cudaError_t err = opt_in_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kDqSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], relpos_bwd_dq_kernel, kThreads, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = kDkvSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], relpos_bwd_dkv_kernel, kThreads, kDkvSmemBytes);
  return static_cast<int>(err);
}

}  // extern "C"
