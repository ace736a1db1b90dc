// Backward of the masked scaled-dot-product attention core for Hopper
// (sm_90a): the gradient of attention.cu.
//
// Replaces the Pallas kernel
// gigaam_tpu/ops/pallas_attention.py::_attn_bwd_kernel (reached through
// _mha_bwd_pallas, the custom VJP of fused_mha), the attention backward of
// every rotary (v3) fine-tuning step.
//
// What it computes, per (batch b, head h), from q, k, v, the output gradient
// do [T, 48] and the key mask:
//   s[i, j]  = scale * q[i] . k[j] + (valid[b, j] ? 0 : -1e9)        (fp32)
//   P[i, j]  = exp(s[i, j] - m_i) / l_i           (m_i row max, l_i row sum)
//   dv[j]    = sum_i bf16(P[i, j]) * do[i]
//   dP[i, j] = do[i] . v[j]                                          (fp32)
//   D_i      = sum_j dP[i, j] * P[i, j]
//   ds[i, j] = bf16(P[i, j] * (dP[i, j] - D_i) * scale)
//   dq[i]    = sum_j ds[i, j] * k[j]        dk[j] = sum_i ds[i, j] * q[i]
// with the Pallas kernel's rounding points: fp32 scores and softmax, P cast
// to bf16 before dv, ds cast to bf16 before dq and dk, fp32 accumulation.
// Rows of masked keys get dk = dv = 0 (their P is exp(-1e9) = 0); rows of
// padded queries hold finite garbage in dq, as the forward's output does.
//
// Bound on the card: at the encoder's shapes the five products
// (10*B*H*T^2*d_h operations) dominate the bytes (q, k, v, do in; dq, dk, dv
// out), so the kernel is bounded by operations.
//
// Design.  The Pallas kernel holds the whole [T, T] fp32 probability block
// of one (batch, head) in VMEM, which bounds it at T = 768.  Here tiles are
// streamed, so T is unbounded, and the work is split by who owns which sum,
// in two launches that need no atomics and give the same bits every run:
//
// 1. sdpa_bwd_dq_kernel, one block per (64-row query tile, head, batch).
//    The forward saves no row statistics, so a first sweep over the key
//    tiles recomputes s and dP and carries the running max m_i, sum l_i and
//    sum_j exp(s - m_i) * dP (all rescaled online, as the forward rescales
//    its output), which gives D_i.  A second sweep recomputes s and dP,
//    forms ds and accumulates dq = ds . k in WMMA accumulators.  It writes
//    dq and the per-row (m_i, 1/l_i, D_i) for the second launch.
// 2. sdpa_bwd_dkv_kernel, one block per (64-key tile, head, batch), streams
//    the query tiles: each warp recomputes s and dP for its 16 query rows
//    from the saved statistics and writes bf16 P and ds into a block-wide
//    [64, 64] buffer; then each warp owns 16 keys and accumulates
//    dv = P^T . do and dk = ds^T . q over the 64 queries of the tile.
//
// That is 2 + 3 + 4 = 9 products instead of 5, the price of having neither
// atomics nor saved statistics.  Products run on the tensor cores
// through WMMA (bf16 inputs, fp32 accumulation).

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
constexpr int kWarps = 4;          // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kD / 8;    // 16-byte chunks per row
constexpr float kMaskedScore = -1e9f;
static_assert(kBlockQ == kBlockK, "load_rows serves both tiles");
static_assert(kBlockQ == kWarps * 16, "one 16-row WMMA tile per warp");

typedef __nv_bfloat16 bf16;

// Dynamic shared memory, in bytes; every buffer starts on a 128-byte
// boundary (WMMA needs 32).
constexpr int kTileBytes = kBlockQ * kD * 2;
constexpr int kOffQ = 0;
constexpr int kOffDo = kOffQ + kTileBytes;
constexpr int kOffK = kOffDo + kTileBytes;
constexpr int kOffV = kOffK + kTileBytes;
constexpr int kOffS = kOffV + kTileBytes;                  // fp32 scores
constexpr int kOffDp = kOffS + kBlockQ * kBlockK * 4;      // fp32 dP
constexpr int kOffP = kOffDp + kBlockQ * kBlockK * 4;      // bf16 P
constexpr int kOffDs = kOffP + kBlockQ * kBlockK * 2;      // bf16 ds
constexpr int kOffMask = kOffDs + kBlockQ * kBlockK * 2;
constexpr int kOffStats = kOffMask + kBlockK * 4;          // m, 1/l, D
constexpr int kSmemBytes = kOffStats + 3 * kBlockQ * 4;
static_assert(kOffS % 128 == 0 && kOffDp % 128 == 0 && kOffP % 128 == 0 &&
              kOffDs % 128 == 0 && kOffMask % 128 == 0 &&
              kOffStats % 128 == 0, "buffer alignment");

// rows [row0, row0 + 64) of a [T, 48] matrix into shared memory, zero past T
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int t) {
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < t)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD + c * 8);
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

// out[16, 64] (fp32, row stride 64) = a[16, 48] . b[64, 48]^T
__device__ __forceinline__ void product_nt(const bf16* a, const bf16* b,
                                           float* out) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockK / 16];
#pragma unroll
  for (int n = 0; n < kBlockK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, kD);
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, b + n * 16 * kD + kk * 16, kD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBlockK / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], kBlockK, wmma::mem_row_major);
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc[16, 48] += a[16, 64] . b[64, 48]; a row-major with stride 64
__device__ __forceinline__ void accumulate_nn(AccFrag* acc, const bf16* a,
                                              const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, kBlockK);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + kk * 16 * kD + n * 16, kD);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
}

// acc[16, 48] += a^T . b[64, 48], where a[64, 64] is row-major with stride 64
// and the 16 output rows are a's columns col0 .. col0 + 15
__device__ __forceinline__ void accumulate_tn(AccFrag* acc, const bf16* a,
                                              int col0, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBlockQ / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
    wmma::load_matrix_sync(af, a + kk * 16 * kBlockK + col0, kBlockK);
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

__global__ void __launch_bounds__(kThreads)
sdpa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const uint8_t* __restrict__ valid, bf16* __restrict__ dq,
                   float* __restrict__ stats, int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + kOffQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + kOffDo);
  bf16* ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + kOffV);
  float* madd = reinterpret_cast<float*>(smem + kOffMask);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const uint8_t* vrow = valid + (size_t)b * t;

  float* sw = reinterpret_cast<float*>(smem + kOffS) + warp * 16 * kBlockK;
  float* dpw = reinterpret_cast<float*>(smem + kOffDp) + warp * 16 * kBlockK;
  bf16* dsw = reinterpret_cast<bf16*>(smem + kOffDs) + warp * 16 * kBlockK;
  const bf16* qw = qs + warp * 16 * kD;
  const bf16* dow = dos + warp * 16 * kD;

  load_rows(qs, q + base, q0, t);
  load_rows(dos, dout + base, q0, t);

  const int r = lane / 2;          // this lane's row within the warp's 16
  const int half = lane % 2;       // and which half of that row it owns

  // sweep 1: the row statistics m, l and sum_j exp(s - m) * dP
  float m_run = -INFINITY, l_run = 0.f, d_run = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    load_rows(ks, k + base, k0, t);
    load_rows(vs, v + base, k0, t);
    load_key_mask(madd, vrow, k0, t);
    __syncthreads();
    product_nt(qw, ks, sw);
    product_nt(dow, vs, dpw);
    __syncwarp();

    // sv[c] is column half*32 + (c + lane) % 32: the rotation spreads the
    // lanes' shared-memory reads over the banks
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      sv[c] = sw[r * kBlockK + j] * scale + madd[j];
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
    __syncwarp();  // sw and dpw are rewritten by the next tile
  }
  const float inv_l = 1.f / l_run;
  const float d_row = d_run * inv_l;

  // sweep 2: ds and dq = ds . k
  AccFrag dqacc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(dqacc[n], 0.f);
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_rows(ks, k + base, k0, t);
    load_rows(vs, v + base, k0, t);
    load_key_mask(madd, vrow, k0, t);
    __syncthreads();
    product_nt(qw, ks, sw);
    product_nt(dow, vs, dpw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float s = sw[r * kBlockK + j] * scale + madd[j];
      const float p = expf(s - m_run) * inv_l;
      const float ds = p * (dpw[r * kBlockK + j] - d_row) * scale;
      dsw[r * kBlockK + j] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_nn(dqacc, dsw, ks);
  }

  store_rows(dqacc, sw, dq + base, q0 + warp * 16, t);
  const int row = q0 + warp * 16 + r;
  if (half == 0 && row < t) {
    const size_t n_rows = (size_t)gridDim.z * n_heads * t;
    const size_t at = bh * t + row;
    stats[at] = m_run;
    stats[n_rows + at] = inv_l;
    stats[2 * n_rows + at] = d_row;
  }
}

__global__ void __launch_bounds__(kThreads)
sdpa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ stats, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + kOffQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + kOffDo);
  bf16* ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + kOffV);
  bf16* pb = reinterpret_cast<bf16*>(smem + kOffP);     // [64 q, 64 k]
  bf16* dsb = reinterpret_cast<bf16*>(smem + kOffDs);   // [64 q, 64 k]
  float* madd = reinterpret_cast<float*>(smem + kOffMask);
  float* st = reinterpret_cast<float*>(smem + kOffStats);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * n_heads + h;
  const size_t base = bh * t * kD;
  const size_t n_rows = (size_t)gridDim.z * n_heads * t;

  float* sw = reinterpret_cast<float*>(smem + kOffS) + warp * 16 * kBlockK;
  float* dpw = reinterpret_cast<float*>(smem + kOffDp) + warp * 16 * kBlockK;

  load_rows(ks, k + base, k0, t);
  load_rows(vs, v + base, k0, t);
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
    load_rows(qs, q + base, q0, t);
    load_rows(dos, dout + base, q0, t);
    if (threadIdx.x < kBlockQ) {
      // rows past T: 1/l = 0 makes their P and ds exactly 0
      const int row = q0 + threadIdx.x;
      const bool in = row < t;
      const size_t at = bh * t + row;
      st[threadIdx.x] = in ? stats[at] : 0.f;
      st[kBlockQ + threadIdx.x] = in ? stats[n_rows + at] : 0.f;
      st[2 * kBlockQ + threadIdx.x] = in ? stats[2 * n_rows + at] : 0.f;
    }
    __syncthreads();
    product_nt(qs + warp * 16 * kD, ks, sw);
    product_nt(dos + warp * 16 * kD, vs, dpw);
    __syncwarp();
    const float m = st[lrow], inv_l = st[kBlockQ + lrow];
    const float d_row = st[2 * kBlockQ + lrow];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float s = sw[r * kBlockK + j] * scale + madd[j];
      const float p = expf(s - m) * inv_l;
      const float ds = p * (dpw[r * kBlockK + j] - d_row) * scale;
      pb[lrow * kBlockK + j] = __float2bfloat16(p);
      dsb[lrow * kBlockK + j] = __float2bfloat16(ds);
    }
    __syncthreads();  // every warp's rows of P and ds are written
    // this warp's 16 keys: dv += P^T . do, dk += ds^T . q
    accumulate_tn(dvacc, pb, warp * 16, dos);
    accumulate_tn(dkacc, dsb, warp * 16, qs);
  }

  store_rows(dkacc, sw, dk + base, k0 + warp * 16, t);
  store_rows(dvacc, sw, dv + base, k0 + warp * 16, t);
}

}  // namespace

extern "C" {

// q, k, v, d_out, dq, dk, dv: [B, H, T, 48] bf16, contiguous, 16-byte
// aligned; valid: [B, T] bool (one byte each); stats: [3, B, H, T] fp32
// scratch (row max, 1 / row sum, D).  Returns the CUDA error code of the
// shared-memory opt-in or of the launches.
int gigaam_sdpa_bwd(const void* q, const void* k, const void* v,
                    const void* d_out, const void* valid, void* dq, void* dk,
                    void* dv, void* stats, int batch, int n_heads, int t,
                    float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      sdpa_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kBlockQ - 1) / kBlockQ, n_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sdpa_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(dq),
      static_cast<float*>(stats), n_heads, t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sdpa_bwd_dkv_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(stats),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
