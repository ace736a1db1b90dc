// Projection GEMMs of the folded rotary attention module for Hopper (sm_90a).
//
// Together with attention.cu these replace the Pallas kernels
// gigaam_tpu/ops/pallas_attention.py::_fold_rotary_kernel (K2, through
// _folded_rotary_pallas) and ::_fold_rotary_lnres_kernel (K1, through
// _folded_lnres_pallas).  The Pallas kernels keep the four 768x768 weights
// resident in a 100 MB VMEM; an SM has 227 KB of shared memory, so on Hopper
// the module is three launches: this file's QKV projection (prologue), the
// SDPA core (attention.cu) and this file's output projection (epilogue).
//
// qkv_kernel computes, for every row m = (b, t) of x [B*T, D] (bf16):
//   xn = LN(x)                        (K1 only: fp32 statistics, eps 1e-5,
//                                      fp32 scale/bias, rounded to bf16)
//   xr = bf16(xn * cos[t] + rotate_half(xn) * sin[t])   per 48-wide head
//   q  = bf16(xr @ Wq + bq),  k = bf16(xr @ Wk + bk),  v = bf16(xn @ Wv + bv)
// stored in the [B, H, T, 48] layout the SDPA core reads.  Wq and bq arrive
// pre-scaled by 1/sqrt(48).  The Pallas kernel applies rotate-half as a
// +-1 permutation matmul (x @ R, _rope_perm_matrix); here it is the index
// swap with a sign that the permutation stands for, which is exact.
//
// out_proj_kernel computes out = bf16(sum_h O[b, h, t] @ Wo[h] + bo), and for
// K1 adds the residual in bf16: out = bf16(out + x), as the Pallas kernel does.
//
// Bound on the card: each GEMM is [B*T, 768] x [768, 768] with 768-wide
// rows, ~590 operations per weight byte at B*T = 8000 and ~40 at B*T = 500,
// so the large batches are bounded by operations and batch 1 by the weight
// bytes.  Design: 64x64 output tiles, 4 warps of 2x2 WMMA 16x16x16 bf16
// tiles with fp32 accumulation, K stepped in 48-wide tiles so that one K tile
// is one head: the RoPE partner column (j +- 24) and the head of the
// [B, H, T, 48] operand are always inside the tile being loaded.  LN
// statistics are computed per 64-row block before the K loop and applied
// while loading A, so the normalized rows never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 48;              // head dim == K tile
constexpr int kBM = 64, kBN = 64, kBK = kDh;
constexpr int kThreads = 128;        // 4 warps, 2 x 2 over the output tile
constexpr int kLdA = kBK + 8;        // padded shared-memory row strides
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;
constexpr int kAChunks = kBK / 8;    // 16-byte chunks per A-tile row (6)
constexpr int kBChunks = kBN / 8;    // and per B-tile row (8)

struct QkvArgs {
  const bf16* x;
  const float* ln_g;   // null: no LayerNorm (K2)
  const float* ln_b;
  const float* cos;    // [T, 48] fp32
  const float* sin;
  const bf16* w[3];    // Wq (pre-scaled), Wk, Wv: [D, D] bf16, [in, out]
  const float* bias[3];
  bf16* out[3];        // q, k, v: [B, H, T, 48] bf16
  int m, t, d, n_heads;
};

struct OutArgs {
  const bf16* o;       // [B, H, T, 48] bf16
  const bf16* w;       // Wo [D, D] bf16
  const float* bias;   // bo [D] fp32
  const bf16* residual;  // null: no residual (K2)
  bf16* out;           // [B*T, D] bf16
  int m, t, d, n_heads;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(f[e]);
  return u;
}

// LayerNorm statistics of rows [m0, m0 + 64): warp w takes 16 rows
__device__ void row_stats(const bf16* x, int m_total, int d, int m0,
                          float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < kBM / 4; ++rr) {
    const int r = warp * (kBM / 4) + rr, m = m0 + r;
    float mean = 0.f, var = 0.f;
    if (m < m_total) {
      const bf16* row = x + (size_t)m * d;
      float f[8], s = 0.f;
      for (int c = lane; c < d / 8; c += 32) {
        unpack8(*reinterpret_cast<const uint4*>(row + c * 8), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[e];
      }
      mean = warp_sum(s) / d;
      float s2 = 0.f;
      for (int c = lane; c < d / 8; c += 32) {
        unpack8(*reinterpret_cast<const uint4*>(row + c * 8), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s2 += (f[e] - mean) * (f[e] - mean);
      }
      var = warp_sum(s2) / d;
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rsqrtf(var + 1e-5f);
    }
  }
}

// 8 consecutive LN'd (or raw) inputs of row m at columns col..col+7, rounded
// to bf16 as the Pallas kernel rounds xn before the body
template <bool kLn>
__device__ __forceinline__ void load_input8(const QkvArgs& a, int m, int col,
                                            float mean, float rstd, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(a.x + (size_t)m * a.d + col), f);
  if (kLn) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = __bfloat162float(__float2bfloat16(
          (f[e] - mean) * rstd * a.ln_g[col + e] + a.ln_b[col + e]));
  }
}

// B tile: rows [k0, k0 + 48) x cols [n0, n0 + 64) of a [D, D] weight
__device__ __forceinline__ void load_weight_tile(bf16* bs, const bf16* w,
                                                 int d, int k0, int n0) {
  for (int i = threadIdx.x; i < kBK * kBChunks; i += kThreads) {
    const int r = i / kBChunks, c = i % kBChunks;
    *reinterpret_cast<uint4*>(bs + r * kLdB + c * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * d + n0 + c * 8);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc[i][j] += A_tile[warp rows] . B_tile[warp cols]
__device__ __forceinline__ void mma_tile(const bf16* as, const bf16* bs,
                                         Acc (&acc)[2][2]) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * kLdA + kk * 16, kLdA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(bfr[j], bs + kk * 16 * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_acc(float* cs, Acc (&acc)[2][2]) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
}

template <bool kLn>
__global__ void __launch_bounds__(kThreads) qkv_kernel(QkvArgs a) {
  __shared__ __align__(128) bf16 as[kBM * kLdA];
  __shared__ __align__(128) bf16 bs[kBK * kLdB];
  __shared__ __align__(128) float cs[kBM * kLdC];
  __shared__ float mean_s[kBM], rstd_s[kBM];

  const int which = blockIdx.z;          // 0: q, 1: k (rotated), 2: v
  const bool rope = which < 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  if (kLn) {
    row_stats(a.x, a.m, a.d, m0, mean_s, rstd_s);
    __syncthreads();
  }

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < a.d; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kAChunks; i += kThreads) {
      const int r = i / kAChunks, c = i % kAChunks, m = m0 + r;
      float y[8];
      if (m < a.m) {
        const float mean = kLn ? mean_s[r] : 0.f, rstd = kLn ? rstd_s[r] : 1.f;
        float xv[8];
        load_input8<kLn>(a, m, k0 + c * 8, mean, rstd, xv);
        if (rope) {
          // rotate_half within the head: column j takes -x[j+24] (j < 24)
          // or x[j-24] (j >= 24); 24 columns are 3 chunks
          float pv[8];
          load_input8<kLn>(a, m, k0 + ((c + 3) % kAChunks) * 8, mean, rstd, pv);
          const float sgn = c < kAChunks / 2 ? -1.f : 1.f;
          const int t = m % a.t;
          const float* cr = a.cos + t * kDh + c * 8;
          const float* sr = a.sin + t * kDh + c * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = xv[e] * cr[e] + (sgn * pv[e]) * sr[e];
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = xv[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = 0.f;
      }
      *reinterpret_cast<uint4*>(as + r * kLdA + c * 8) = pack8(y);
    }
    load_weight_tile(bs, a.w[which], a.d, k0, n0);
    __syncthreads();
    mma_tile(as, bs, acc);
    __syncthreads();
  }

  store_acc(cs, acc);
  __syncthreads();
  const float* bias = a.bias[which];
  bf16* out = a.out[which];
  for (int i = threadIdx.x; i < kBM * kBChunks; i += kThreads) {
    const int r = i / kBChunks, c = i % kBChunks, m = m0 + r;
    if (m >= a.m) continue;
    const int n = n0 + c * 8;            // 8 columns never straddle a head
    const int h = n / kDh, dd = n % kDh, b = m / a.t, t = m % a.t;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = cs[r * kLdC + c * 8 + e] + bias[n + e];
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * a.n_heads + h) * a.t + t) * kDh + dd) = pack8(y);
  }
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads) out_proj_kernel(OutArgs a) {
  __shared__ __align__(128) bf16 as[kBM * kLdA];
  __shared__ __align__(128) bf16 bs[kBK * kLdB];
  __shared__ __align__(128) float cs[kBM * kLdC];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < a.d; k0 += kBK) {
    const int h = k0 / kDh;              // one K tile is one head
    for (int i = threadIdx.x; i < kBM * kAChunks; i += kThreads) {
      const int r = i / kAChunks, c = i % kAChunks, m = m0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < a.m) {
        const int b = m / a.t, t = m % a.t;
        val = *reinterpret_cast<const uint4*>(
            a.o + (((size_t)b * a.n_heads + h) * a.t + t) * kDh + c * 8);
      }
      *reinterpret_cast<uint4*>(as + r * kLdA + c * 8) = val;
    }
    load_weight_tile(bs, a.w, a.d, k0, n0);
    __syncthreads();
    mma_tile(as, bs, acc);
    __syncthreads();
  }

  store_acc(cs, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBChunks; i += kThreads) {
    const int r = i / kBChunks, c = i % kBChunks, m = m0 + r;
    if (m >= a.m) continue;
    const int n = n0 + c * 8;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = cs[r * kLdC + c * 8 + e] + a.bias[n + e];
    if (kRes) {
      // the module output is rounded to bf16 first, then the residual is
      // added in bf16 (rounded once more)
      float res[8];
      unpack8(*reinterpret_cast<const uint4*>(a.residual + (size_t)m * a.d + n), res);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __bfloat162float(__float2bfloat16(y[e])) + res[e];
    }
    *reinterpret_cast<uint4*>(a.out + (size_t)m * a.d + n) = pack8(y);
  }
}

}  // namespace

extern "C" {

// x: [B*T, D] bf16; ln_g/ln_b: [D] fp32 or both null; cos/sin: [T, 48] fp32;
// w*: [D, D] bf16; b*: [D] fp32; q/k/v: [B, H, T, 48] bf16.  D % 64 == 0,
// D == 48 * n_heads, all pointers 16-byte aligned.  Returns cudaGetLastError().
int gigaam_qkv_proj(const void* x, const void* ln_g, const void* ln_b,
                    const void* cos, const void* sin, const void* wq,
                    const void* wk, const void* wv, const void* bq,
                    const void* bk, const void* bv, void* q, void* k, void* v,
                    int batch, int t, int d, int n_heads, void* stream) {
  QkvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  a.bias[0] = static_cast<const float*>(bq);
  a.bias[1] = static_cast<const float*>(bk);
  a.bias[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  a.m = batch * t;
  a.t = t;
  a.d = d;
  a.n_heads = n_heads;
  dim3 grid(d / kBN, (a.m + kBM - 1) / kBM, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln_g != nullptr)
    qkv_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    qkv_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// o: [B, H, T, 48] bf16; wo: [D, D] bf16; bo: [D] fp32; residual: [B*T, D]
// bf16 or null; out: [B*T, D] bf16.  Returns cudaGetLastError().
int gigaam_out_proj(const void* o, const void* wo, const void* bo,
                    const void* residual, void* out, int batch, int t, int d,
                    int n_heads, void* stream) {
  OutArgs a;
  a.o = static_cast<const bf16*>(o);
  a.w = static_cast<const bf16*>(wo);
  a.bias = static_cast<const float*>(bo);
  a.residual = static_cast<const bf16*>(residual);
  a.out = static_cast<bf16*>(out);
  a.m = batch * t;
  a.t = t;
  a.d = d;
  a.n_heads = n_heads;
  dim3 grid(d / kBN, (a.m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (residual != nullptr)
    out_proj_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    out_proj_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
