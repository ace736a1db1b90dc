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
// do [T, 48] and the key mask:
//   bias[i, j] = float(bf16(q_v[i] . p_heads[h, T-1-i+j]))
//   s[i, j]    = (q_u[i] . k[j] + bias[i, j]) * scale
//                + (valid[b, j] ? 0 : -1e9)                            (fp32)
//   P[i, j]    = exp(s[i, j] - m_i) / l_i
//   dv[j]      = sum_i bf16(P[i, j]) * do[i]
//   dP[i, j]   = do[i] . v[j]             D_i = sum_j dP[i, j] * P[i, j]
//   dz[i, j]   = bf16(P[i, j] * (dP[i, j] - D_i) * scale)
//   dq_u[i]    = sum_j dz[i, j] * k[j]      dk[j] = sum_i dz[i, j] * q_u[i]
//   dq_v[i]    = sum_j dz[i, j] * p_heads[h, T-1-i+j]
//   dp[h, c]   = sum_b sum_i dz[i, c-(T-1)+i] * q_v[i]  (fp32 over the batch)
// with the Pallas kernel's rounding points: the bias rounded to bf16 where
// the forward rounds it, fp32 scores and softmax, P cast to bf16 before dv,
// dz cast to bf16 before every product that consumes it, fp32 accumulation.
// The caller passes dp zeroed and casts it once after the launch.
//
// Bound on the card: the products (8*B*H*T^2*d_h used multiply-adds:
// q_u.k, the positional term, do.v, P.do, dz.k, dz.q_u, dz.p, dz.q_v)
// dominate the bytes, so the kernel is bounded by operations.
//
// Design.  The Pallas kernel holds the [T, T] fp32 probabilities and the
// whole position table of one (batch, head) in VMEM (T <= 768 there) and
// unshears dz with a log2(T) ladder of rolls.  Here tiles are streamed, T is
// unbounded, and the shear and the unshear are index remaps into the window
// of relpos_attention.cu: the (64-query tile at q0, 64-key tile at k0) pair
// touches only the 127 rows T-1-q0-63+k0 .. T-1-q0+k0+63 of p_heads, loaded
// as a 128-row window, with bias[q0+li][k0+lj] at window row 63 - li + lj.
// The work is split by who owns which sum, in two launches:
//
// 1. relpos_bwd_dq_kernel, one block per (64-row query tile, head, batch).
//    A first sweep over the key tiles recomputes s and dP and carries the
//    row statistics (running max, sum, and sum exp(s - m) * dP, rescaled
//    online), since the forward saves none.  A second sweep recomputes s and
//    dP, forms dz, and accumulates dq_u = dz . k.  It also writes dz skewed
//    into a block-wide [64, 128] buffer G, G[li][63 - li + lj] = dz[li][lj]
//    (zero elsewhere): then dq_v = G . window is one more product per warp
//    over the 80 window rows its 16 query rows touch, and the window's share
//    of dp is G^T . q_v, a [128, 48] product split over the four warps.
//    dp rows are shared by every query tile and every batch element, so that
//    share is added with fp32 atomicAdd: its low bits depend on the order of
//    the blocks and differ from run to run.  Everything else is
//    deterministic.
// 2. relpos_bwd_dkv_kernel, one block per (64-key tile, head, batch),
//    streams the query tiles: each warp recomputes s (with the bias) and dP
//    for its 16 query rows from the saved statistics, writes bf16 P and dz
//    into block-wide [64, 64] buffers, and then owns 16 keys of
//    dv = P^T . do and dk = dz^T . q_u.
//
// About 130 KB of dynamic shared memory: one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kD = 48;             // head dim
constexpr int kBlockQ = 64;        // query rows per tile
constexpr int kBlockK = 64;        // keys per tile
constexpr int kWarps = 4;          // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kD / 8;    // 16-byte chunks per row
constexpr int kWin = kBlockQ + kBlockK;  // p_heads window rows (127 used)
constexpr int kWarpWin = 16 + kBlockK;   // window rows one warp reads (79 used)
constexpr float kMaskedScore = -1e9f;
static_assert(kBlockQ == kWarps * 16, "one 16-row WMMA tile per warp");
static_assert(kBlockQ == kBlockK, "square tile pairs");
static_assert(kWin == kWarps * 32, "dp: 32 window rows per warp");

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// Dynamic shared memory, in bytes; every buffer starts on a 128-byte
// boundary (WMMA needs 32).
constexpr int kTileBytes = kBlockQ * kD * 2;
constexpr int kOffQu = 0;
constexpr int kOffQv = kOffQu + kTileBytes;
constexpr int kOffDo = kOffQv + kTileBytes;
constexpr int kOffK = kOffDo + kTileBytes;
constexpr int kOffV = kOffK + kTileBytes;
constexpr int kOffWin = kOffV + kTileBytes;
constexpr int kOffS = kOffWin + kWin * kD * 2;              // fp32 scores
constexpr int kOffDp = kOffS + kBlockQ * kBlockK * 4;       // fp32 dP
constexpr int kOffR = kOffDp + kBlockQ * kBlockK * 4;       // positional term
constexpr int kOffP = kOffR + kWarps * 16 * kWarpWin * 4;   // bf16 P
constexpr int kOffDz = kOffP + kBlockQ * kBlockK * 2;       // bf16 dz
constexpr int kOffG = kOffDz + kBlockQ * kBlockK * 2;       // bf16 skewed dz
constexpr int kOffMask = kOffG + kBlockQ * kWin * 2;
constexpr int kOffStats = kOffMask + kBlockK * 4;           // m, 1/l, D
constexpr int kSmemBytes = kOffStats + 3 * kBlockQ * 4;
static_assert(kOffWin % 128 == 0 && kOffS % 128 == 0 && kOffDp % 128 == 0 &&
              kOffR % 128 == 0 && kOffP % 128 == 0 && kOffDz % 128 == 0 &&
              kOffG % 128 == 0 && kOffMask % 128 == 0 &&
              kOffStats % 128 == 0, "buffer alignment");

// rows [row0, row0 + n) of a [rows, 48] matrix into shared memory, zero for
// rows outside [0, rows)
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n, int rows) {
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int g = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g >= 0 && g < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)g * kD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kD + c * 8) = val;
  }
}

__device__ __forceinline__ void load_key_mask(float* madd,
                                              const uint8_t* vrow, int k0,
                                              int t) {
  if (threadIdx.x < kBlockK) {
    const int j = k0 + threadIdx.x;
    madd[threadIdx.x] = j < t ? (vrow[j] ? 0.f : kMaskedScore) : -INFINITY;
  }
}

// out[16, N] (fp32, row stride N) = a[16, 48] . b[N, 48]^T
template <int N>
__device__ __forceinline__ void product_nt(const bf16* a, const bf16* b,
                                           float* out) {
  AccFrag acc[N / 16];
#pragma unroll
  for (int n = 0; n < N / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, kD);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, b + n * 16 * kD + kk * 16, kD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], N, wmma::mem_row_major);
}

// acc[16, 48] += a[16, K] . b[K, 48]; a row-major with stride lda
template <int K>
__device__ __forceinline__ void accumulate_nn(AccFrag* acc, const bf16* a,
                                              int lda, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + kk * 16 * kD + n * 16, kD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
}

// acc[16, 48] += a^T . b[64, 48], where a has 64 rows, row stride lda, and
// the 16 output rows are a's columns col0 .. col0 + 15
__device__ __forceinline__ void accumulate_tn(AccFrag* acc, const bf16* a,
                                              int lda, int col0,
                                              const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBlockQ / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
    wmma::load_matrix_sync(af, a + kk * 16 * lda + col0, lda);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + kk * 16 * kD + n * 16, kD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
}

// the warp's [16, 48] accumulator, through its fp32 scratch (row stride 64),
// to rows row0 + r of a [T, 48] bf16 matrix; each lane writes half a row
__device__ __forceinline__ void store_rows(AccFrag* acc, float* scratch,
                                           bf16* dst, int row0, int t) {
  const int lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;
#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], kBlockK,
                            wmma::mem_row_major);
  __syncwarp();
  if (row0 + r < t) {
    bf16* out = dst + (size_t)(row0 + r) * kD;
#pragma unroll
    for (int c = 0; c < kD / 2; ++c) {
      const int col = half * (kD / 2) + (c + r) % (kD / 2);
      out[col] = __float2bfloat16(scratch[r * kBlockK + col]);
    }
  }
  __syncwarp();
}

// the score of (row r of the warp, key column j of the tile) before the
// scale and the mask: q_u.k plus the positional term, which for row r sits at
// column 15 - r + j of the warp's window product, rounded to bf16 as the
// forward rounds it
__device__ __forceinline__ float raw_score(const float* sw, const float* rw,
                                           int r, int j) {
  const float bias =
      __bfloat162float(__float2bfloat16(rw[r * kWarpWin + 15 - r + j]));
  return sw[r * kBlockK + j] + bias;
}

__global__ void __launch_bounds__(kThreads)
relpos_bwd_dq_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ qv,
                     const bf16* __restrict__ pos,
                     const bf16* __restrict__ dout,
                     const uint8_t* __restrict__ valid,
                     bf16* __restrict__ dqu, bf16* __restrict__ dqv,
                     float* __restrict__ dp, float* __restrict__ stats,
                     int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qus = reinterpret_cast<bf16*>(smem + kOffQu);
  bf16* qvs = reinterpret_cast<bf16*>(smem + kOffQv);
  bf16* dos = reinterpret_cast<bf16*>(smem + kOffDo);
  bf16* ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + kOffV);
  bf16* win = reinterpret_cast<bf16*>(smem + kOffWin);
  bf16* gs = reinterpret_cast<bf16*>(smem + kOffG);      // [64, 128]
  float* madd = reinterpret_cast<float*>(smem + kOffMask);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;
  const uint8_t* vrow = valid + (size_t)b * t;

  float* sw = reinterpret_cast<float*>(smem + kOffS) + warp * 16 * kBlockK;
  float* dpw = reinterpret_cast<float*>(smem + kOffDp) + warp * 16 * kBlockK;
  float* rw = reinterpret_cast<float*>(smem + kOffR) + warp * 16 * kWarpWin;
  bf16* dzw = reinterpret_cast<bf16*>(smem + kOffDz) + warp * 16 * kBlockK;
  const bf16* quw = qus + warp * 16 * kD;
  const bf16* qvw = qvs + warp * 16 * kD;
  const bf16* dow = dos + warp * 16 * kD;
  // this warp's 80 rows of the window: rows (kBlockQ - 16) - 16 * warp on
  const int wcol0 = kBlockQ - 16 - 16 * warp;
  const bf16* wwin = win + wcol0 * kD;

  load_rows(qus, qu + base, q0, kBlockQ, t);
  load_rows(qvs, qv + base, q0, kBlockQ, t);
  load_rows(dos, dout + base, q0, kBlockQ, t);
  for (int i = threadIdx.x; i < kBlockQ * kWin / 8; i += kThreads)
    reinterpret_cast<uint4*>(gs)[i] = make_uint4(0, 0, 0, 0);

  const int r = lane / 2;          // this lane's row within the warp's 16
  const int half = lane % 2;       // and which half of that row it owns
  const int lrow = warp * 16 + r;  // its row within the tile

  // sweep 1: the row statistics m, l and sum_j exp(s - m) * dP
  float m_run = -INFINITY, l_run = 0.f, d_run = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    load_rows(ks, k + base, k0, kBlockK, t);
    load_rows(vs, v + base, k0, kBlockK, t);
    load_rows(win, ph, t - 1 - q0 - (kBlockQ - 1) + k0, kWin, n_pos);
    load_key_mask(madd, vrow, k0, t);
    __syncthreads();
    product_nt<kBlockK>(quw, ks, sw);
    product_nt<kWarpWin>(qvw, wwin, rw);
    product_nt<kBlockK>(dow, vs, dpw);
    __syncwarp();

    // sv[c] is column half*32 + (c + lane) % 32: the rotation spreads the
    // lanes' shared-memory reads over the banks
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      sv[c] = raw_score(sw, rw, r, j) * scale + madd[j];
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f, dsum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float p = expf(sv[c] - m_new);
      sum += p;
      dsum += p * dpw[r * kBlockK + j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    l_run = l_run * corr + sum;
    d_run = d_run * corr + dsum;
    m_run = m_new;
    __syncwarp();  // sw, rw and dpw are rewritten by the next tile
  }
  const float inv_l = 1.f / l_run;
  const float d_row = d_run * inv_l;

  // sweep 2: dz, dq_u = dz . k, dq_v = G . window, dp += G^T . q_v
  AccFrag dquacc[kD / 16], dqvacc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dquacc[n], 0.f);
    wmma::fill_fragment(dqvacc[n], 0.f);
  }
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    const int wrow0 = t - 1 - q0 - (kBlockQ - 1) + k0;  // window's first row
    __syncthreads();
    load_rows(ks, k + base, k0, kBlockK, t);
    load_rows(vs, v + base, k0, kBlockK, t);
    load_rows(win, ph, wrow0, kWin, n_pos);
    load_key_mask(madd, vrow, k0, t);
    __syncthreads();
    product_nt<kBlockK>(quw, ks, sw);
    product_nt<kWarpWin>(qvw, wwin, rw);
    product_nt<kBlockK>(dow, vs, dpw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float s = raw_score(sw, rw, r, j) * scale + madd[j];
      const float p = expf(s - m_run) * inv_l;
      const bf16 dz =
          __float2bfloat16(p * (dpw[r * kBlockK + j] - d_row) * scale);
      dzw[r * kBlockK + j] = dz;
      gs[lrow * kWin + (kBlockQ - 1) - lrow + j] = dz;
    }
    __syncwarp();
    accumulate_nn<kBlockK>(dquacc, dzw, kBlockK, ks);
    // row lrow of G is nonzero in columns 63 - lrow .. 126 - lrow only, all
    // inside the warp's 80 window rows
    accumulate_nn<kWarpWin>(dqvacc, gs + warp * 16 * kWin + wcol0, kWin, wwin);
    __syncthreads();  // every warp's rows of G are written

    // window rows 32 * warp .. 32 * warp + 31 of G^T . q_v, added into dp
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int c0 = warp * 32 + mt * 16;
      AccFrag acc[kD / 16];
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
      accumulate_tn(acc, gs, kWin, c0, qvs);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n)
        wmma::store_matrix_sync(sw + n * 16, acc[n], kBlockK,
                                wmma::mem_row_major);
      __syncwarp();
      const int g = wrow0 + c0 + r;
      if (g >= 0 && g < n_pos) {
        float* out = dp + ((size_t)h * n_pos + g) * kD;
#pragma unroll
        for (int c = 0; c < kD / 2; ++c) {
          const int col = half * (kD / 2) + (c + r) % (kD / 2);
          const float val = sw[r * kBlockK + col];
          if (val != 0.f) atomicAdd(out + col, val);
        }
      }
      __syncwarp();
    }
  }

  store_rows(dquacc, sw, dqu + base, q0 + warp * 16, t);
  store_rows(dqvacc, sw, dqv + base, q0 + warp * 16, t);
  const int row = q0 + lrow;
  if (half == 0 && row < t) {
    const size_t n_rows = (size_t)gridDim.z * n_heads * t;
    const size_t at = bh * t + row;
    stats[at] = m_run;
    stats[n_rows + at] = inv_l;
    stats[2 * n_rows + at] = d_row;
  }
}

__global__ void __launch_bounds__(kThreads)
relpos_bwd_dkv_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ qv,
                      const bf16* __restrict__ pos,
                      const bf16* __restrict__ dout,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ stats, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qus = reinterpret_cast<bf16*>(smem + kOffQu);
  bf16* qvs = reinterpret_cast<bf16*>(smem + kOffQv);
  bf16* dos = reinterpret_cast<bf16*>(smem + kOffDo);
  bf16* ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + kOffV);
  bf16* win = reinterpret_cast<bf16*>(smem + kOffWin);
  bf16* pb = reinterpret_cast<bf16*>(smem + kOffP);     // [64 q, 64 k]
  bf16* dzb = reinterpret_cast<bf16*>(smem + kOffDz);   // [64 q, 64 k]
  float* madd = reinterpret_cast<float*>(smem + kOffMask);
  float* st = reinterpret_cast<float*>(smem + kOffStats);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const size_t n_rows = (size_t)gridDim.z * n_heads * t;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;

  float* sw = reinterpret_cast<float*>(smem + kOffS) + warp * 16 * kBlockK;
  float* dpw = reinterpret_cast<float*>(smem + kOffDp) + warp * 16 * kBlockK;
  float* rw = reinterpret_cast<float*>(smem + kOffR) + warp * 16 * kWarpWin;
  const bf16* wwin = win + (kBlockQ - 16 - 16 * warp) * kD;

  load_rows(ks, k + base, k0, kBlockK, t);
  load_rows(vs, v + base, k0, kBlockK, t);
  load_key_mask(madd, valid + (size_t)b * t, k0, t);

  const int r = lane / 2, half = lane % 2;
  const int lrow = warp * 16 + r;  // this lane's query row within the tile

  AccFrag dkacc[kD / 16], dvacc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dkacc[n], 0.f);
    wmma::fill_fragment(dvacc[n], 0.f);
  }

  for (int q0 = 0; q0 < t; q0 += kBlockQ) {
    __syncthreads();  // the previous tile is fully consumed
    load_rows(qus, qu + base, q0, kBlockQ, t);
    load_rows(qvs, qv + base, q0, kBlockQ, t);
    load_rows(dos, dout + base, q0, kBlockQ, t);
    load_rows(win, ph, t - 1 - q0 - (kBlockQ - 1) + k0, kWin, n_pos);
    if (threadIdx.x < kBlockQ) {
      // rows past T: 1/l = 0 makes their P and dz exactly 0
      const int row = q0 + threadIdx.x;
      const bool in = row < t;
      const size_t at = bh * t + row;
      st[threadIdx.x] = in ? stats[at] : 0.f;
      st[kBlockQ + threadIdx.x] = in ? stats[n_rows + at] : 0.f;
      st[2 * kBlockQ + threadIdx.x] = in ? stats[2 * n_rows + at] : 0.f;
    }
    __syncthreads();
    product_nt<kBlockK>(qus + warp * 16 * kD, ks, sw);
    product_nt<kWarpWin>(qvs + warp * 16 * kD, wwin, rw);
    product_nt<kBlockK>(dos + warp * 16 * kD, vs, dpw);
    __syncwarp();
    const float m = st[lrow], inv_l = st[kBlockQ + lrow];
    const float d_row = st[2 * kBlockQ + lrow];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float s = raw_score(sw, rw, r, j) * scale + madd[j];
      const float p = expf(s - m) * inv_l;
      const float dz = p * (dpw[r * kBlockK + j] - d_row) * scale;
      pb[lrow * kBlockK + j] = __float2bfloat16(p);
      dzb[lrow * kBlockK + j] = __float2bfloat16(dz);
    }
    __syncthreads();  // every warp's rows of P and dz are written
    // this warp's 16 keys: dv += P^T . do, dk += dz^T . q_u
    accumulate_tn(dvacc, pb, kBlockK, warp * 16, dos);
    accumulate_tn(dkacc, dzb, kBlockK, warp * 16, qus);
  }

  store_rows(dkacc, sw, dk + base, k0 + warp * 16, t);
  store_rows(dvacc, sw, dv + base, k0 + warp * 16, t);
}

}  // namespace

extern "C" {

// q_u, k, v, q_v, d_out, dq_u, dk, dv, dq_v: [B, H, T, 48] bf16; p_heads:
// [H, 2T-1, 48] bf16; dp: [H, 2T-1, 48] fp32, zeroed by the caller and added
// into; valid: [B, T] bool (one byte each); stats: [3, B, H, T] fp32 scratch
// (row max, 1 / row sum, D).  All contiguous and 16-byte aligned.  Returns
// the CUDA error code of the shared-memory opt-in or of the launches.
int gigaam_relpos_sdpa_bwd(const void* q_u, const void* k, const void* v,
                           const void* q_v, const void* p_heads,
                           const void* d_out, const void* valid, void* dq_u,
                           void* dk, void* dv, void* dq_v, void* dp,
                           void* stats, int batch, int n_heads, int t,
                           float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      relpos_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kBlockQ - 1) / kBlockQ, n_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  relpos_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(dq_u),
      static_cast<bf16*>(dq_v), static_cast<float*>(dp),
      static_cast<float*>(stats), n_heads, t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  relpos_bwd_dkv_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
