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
// with m_i the row max: fp32 softmax, P cast to bf16 before P.V, the division
// after P.V, as the Pallas kernel does.  Query rows of masked frames are
// finite garbage by the same contract.
//
// Bound on the card: at the encoder's shapes (T' <= ~1200, d_h = 48) the
// score work 4*B*H*T^2*d_h dominates the bytes (q, k, v, o: 8*B*H*T*d_h), so
// the kernel is bounded by operations.  Design: one block per
// (64-row query tile, head, batch); K and V are streamed through shared
// memory in 64-key tiles with an online (running max / running sum) fp32
// softmax, so T is unbounded and the [T, T] scores never reach device
// memory.  The products run on the tensor cores through WMMA (bf16 inputs,
// fp32 accumulation); d_h = 48 is three k-steps of 16, with no padding.
// Each warp owns 16 query rows; each lane owns one half-row of the softmax
// and of the output accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kD = 48;             // head dim
constexpr int kBlockQ = 64;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kWarps = 4;          // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kD / 8;    // 16-byte chunks per row
constexpr float kMaskedScore = -1e9f;
static_assert(kBlockQ == kBlockK, "load_rows serves both tiles");

typedef __nv_bfloat16 bf16;

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

__global__ void __launch_bounds__(kThreads)
sdpa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
            bf16* __restrict__ o, int n_heads, int t, float scale) {
  __shared__ __align__(128) bf16 qs[kBlockQ * kD];
  __shared__ __align__(128) bf16 ks[kBlockK * kD];
  __shared__ __align__(128) bf16 vs[kBlockK * kD];
  __shared__ __align__(128) float ss[kWarps][16 * kBlockK];  // scores, then P.V
  __shared__ __align__(128) bf16 ps[kWarps][16 * kBlockK];
  __shared__ float madd[kBlockK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * n_heads + blockIdx.y) * t * kD;
  const uint8_t* vrow = valid + (size_t)b * t;

  load_rows(qs, q + base, q0, t);

  const int r = lane / 2;          // this lane's row within the warp's 16
  const int half = lane % 2;       // and which half of that row it owns
  float m_run = -INFINITY, l_run = 0.f;
  // o_acc[c] holds output column half*24 + (c + r) % 24: the rotation spreads
  // the lanes' shared-memory reads over the banks
  float o_acc[kD / 2];
#pragma unroll
  for (int c = 0; c < kD / 2; ++c) o_acc[c] = 0.f;

  float* sw = ss[warp];
  bf16* pw = ps[warp];

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    load_rows(ks, k + base, k0, t);
    load_rows(vs, v + base, k0, t);
    if (threadIdx.x < kBlockK) {
      const int j = k0 + threadIdx.x;
      madd[threadIdx.x] = j < t ? (vrow[j] ? 0.f : kMaskedScore) : -INFINITY;
    }
    __syncthreads();

    // S[16, 64] = Q[16, 48] . K^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[kBlockK / 16];
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, qs + warp * 16 * kD + kk * 16, kD);
#pragma unroll
      for (int n = 0; n < kBlockK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, ks + n * 16 * kD + kk * 16, kD);
        wmma::mma_sync(sacc[n], af, bfr, sacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, sacc[n], kBlockK, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this lane's 32 columns; sv[c] is column
    // half*32 + (c + lane) % 32 (order is free here, the rotation avoids
    // bank conflicts)
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
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float p = expf(sv[c] - m_new);
      sum += p;
      pw[r * kBlockK + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    __syncwarp();

    // O_tile[16, 48] = P[16, 64] . V[64, 48], then O = O * corr + O_tile
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[kD / 16];
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(oacc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, pw + kk * 16, kBlockK);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, vs + kk * 16 * kD + n * 16, kD);
        wmma::mma_sync(oacc[n], af, bfr, oacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, oacc[n], kBlockK, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kD / 2; ++c) {
      const int col = half * (kD / 2) + (c + r) % (kD / 2);
      o_acc[c] = o_acc[c] * corr + sw[r * kBlockK + col];
    }
    __syncwarp();  // sw is rewritten by the next tile's scores
  }

  const int row = q0 + warp * 16 + r;
  if (row < t) {
    bf16* dst = o + base + (size_t)row * kD;
#pragma unroll
    for (int c = 0; c < kD / 2; ++c) {
      const int col = half * (kD / 2) + (c + r) % (kD / 2);
      dst[col] = __float2bfloat16(o_acc[c] / l_run);
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, 48] bf16, contiguous, 16-byte aligned;
// valid: [B, T] bool (one byte each).  Returns cudaGetLastError().
int gigaam_sdpa(const void* q, const void* k, const void* v, const void* valid,
                void* o, int batch, int n_heads, int t, float scale,
                void* stream) {
  dim3 grid((t + kBlockQ - 1) / kBlockQ, n_heads, batch);
  sdpa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(o), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
