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
// with m_i the row max.  The bias is rounded to bf16 where the Pallas kernel
// rounds it (it shears the product in the input dtype); the rest follows
// attention.cu: fp32 softmax, P cast to bf16 before P.V, the division after
// P.V.  Query rows of masked frames are finite garbage by the same contract.
//
// Bound on the card: at the encoder's shapes (T' ~ 250-1130, d_h = 48) the
// three products (q_u.k^T, the positional term that is used, P.v:
// 6*B*H*T^2*d_h operations) dominate the bytes (five [B, H, T, 48] tensors
// and one [H, 2T-1, 48] table), so the kernel is bounded by operations.
//
// Design: attention.cu's streaming kernel, one block per (64-row query tile,
// head, batch), K and V streamed through shared memory in 64-key tiles with
// an online fp32 softmax, so T is unbounded and neither the [T, T] scores
// nor the [T, 2T-1] positional term reach device memory.  The Pallas
// kernel's log2(T) roll/select shear (which bounds it to T <= 1024 there)
// becomes an index remap.  For the query tile at q0 and the key tile at k0,
// every relative position the pair needs lies in the 127 rows
// T-1-q0-63+k0 .. T-1-q0+k0+63 of p_heads; they are loaded as a 128-row
// window, zero past either end of [0, 2T-1), so that
//   bias[q0 + li][k0 + lj] = raw at window row 63 - li + lj.
// Warp w owns the query rows li = 16w .. 16w+15 and so reads window rows
// 48-16w .. 126-16w only: one WMMA product Q_v[16 x 48] . W^T[48 x 80] per
// warp and key tile (1.25x the q_u.k^T work), after which the shear is a read
// of that fp32 product at column 15 - r + lj (r = li - 16w).  The buffers
// (about 80 KB) live in dynamic shared memory, two blocks to an SM.

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
constexpr int kWin = kBlockQ + kBlockK;  // p_heads window rows (127 used)
constexpr int kWarpWin = 16 + kBlockK;   // window rows one warp reads (79 used)
constexpr float kMaskedScore = -1e9f;
static_assert(kBlockQ == kWarps * 16, "one 16-row WMMA tile per warp");
static_assert(kWarpWin % 16 == 0, "the warp window is whole WMMA tiles");

typedef __nv_bfloat16 bf16;

// Dynamic shared memory, in bytes; every buffer starts on a 128-byte
// boundary (WMMA needs 32).
constexpr int kTileBytes = kBlockQ * kD * 2;
constexpr int kOffQu = 0;
constexpr int kOffQv = kOffQu + kTileBytes;
constexpr int kOffK = kOffQv + kTileBytes;
constexpr int kOffV = kOffK + kTileBytes;
constexpr int kOffWin = kOffV + kTileBytes;
constexpr int kOffS = kOffWin + kWin * kD * 2;            // scores, then P.V
constexpr int kOffR = kOffS + kWarps * 16 * kBlockK * 4;  // positional term
constexpr int kOffP = kOffR + kWarps * 16 * kWarpWin * 4;
constexpr int kOffMask = kOffP + kWarps * 16 * kBlockK * 2;
constexpr int kSmemBytes = kOffMask + kBlockK * 4;
static_assert(kOffWin % 128 == 0 && kOffS % 128 == 0 && kOffR % 128 == 0 &&
              kOffP % 128 == 0 && kOffMask % 128 == 0, "buffer alignment");

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

__global__ void __launch_bounds__(kThreads)
relpos_sdpa_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ qv,
                   const bf16* __restrict__ pos,
                   const uint8_t* __restrict__ valid, bf16* __restrict__ o,
                   int n_heads, int t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qus = reinterpret_cast<bf16*>(smem + kOffQu);
  bf16* qvs = reinterpret_cast<bf16*>(smem + kOffQv);
  bf16* ks = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* vs = reinterpret_cast<bf16*>(smem + kOffV);
  bf16* win = reinterpret_cast<bf16*>(smem + kOffWin);
  float* madd = reinterpret_cast<float*>(smem + kOffMask);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * n_heads + h) * t * kD;
  const int n_pos = 2 * t - 1;
  const bf16* ph = pos + (size_t)h * n_pos * kD;
  const uint8_t* vrow = valid + (size_t)b * t;

  load_rows(qus, qu + base, q0, kBlockQ, t);
  load_rows(qvs, qv + base, q0, kBlockQ, t);

  const int r = lane / 2;          // this lane's row within the warp's 16
  const int half = lane % 2;       // and which half of that row it owns
  float m_run = -INFINITY, l_run = 0.f;
  // o_acc[c] holds output column half*24 + (c + r) % 24: the rotation spreads
  // the lanes' shared-memory reads over the banks
  float o_acc[kD / 2];
#pragma unroll
  for (int c = 0; c < kD / 2; ++c) o_acc[c] = 0.f;

  float* sw = reinterpret_cast<float*>(smem + kOffS) + warp * 16 * kBlockK;
  float* rw = reinterpret_cast<float*>(smem + kOffR) + warp * 16 * kWarpWin;
  bf16* pw = reinterpret_cast<bf16*>(smem + kOffP) + warp * 16 * kBlockK;
  // this warp's 80 rows of the window: rows (kBlockQ - 16) - 16 * warp on
  const bf16* wwin = win + (kBlockQ - 16 - 16 * warp) * kD;

  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    load_rows(ks, k + base, k0, kBlockK, t);
    load_rows(vs, v + base, k0, kBlockK, t);
    load_rows(win, ph, t - 1 - q0 - (kBlockQ - 1) + k0, kWin, n_pos);
    if (threadIdx.x < kBlockK) {
      const int j = k0 + threadIdx.x;
      madd[threadIdx.x] = j < t ? (vrow[j] ? 0.f : kMaskedScore) : -INFINITY;
    }
    __syncthreads();

    // S[16, 64] = Q_u[16, 48] . K^T  and  R[16, 80] = Q_v[16, 48] . W^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[kBlockK / 16];
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> racc[kWarpWin / 16];
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
    for (int n = 0; n < kWarpWin / 16; ++n) wmma::fill_fragment(racc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, qus + warp * 16 * kD + kk * 16, kD);
#pragma unroll
      for (int n = 0; n < kBlockK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, ks + n * 16 * kD + kk * 16, kD);
        wmma::mma_sync(sacc[n], af, bfr, sacc[n]);
      }
      wmma::load_matrix_sync(af, qvs + warp * 16 * kD + kk * 16, kD);
#pragma unroll
      for (int n = 0; n < kWarpWin / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, wwin + n * 16 * kD + kk * 16, kD);
        wmma::mma_sync(racc[n], af, bfr, racc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, sacc[n], kBlockK, wmma::mem_row_major);
#pragma unroll
    for (int n = 0; n < kWarpWin / 16; ++n)
      wmma::store_matrix_sync(rw + n * 16, racc[n], kWarpWin, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this lane's 32 columns; sv[c] is column
    // half*32 + (c + lane) % 32 (order is free here, the rotation avoids
    // bank conflicts).  Row r's bias for key lj sits at column 15 - r + lj.
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + ((c + lane) & 31);
      const float bias =
          __bfloat162float(__float2bfloat16(rw[r * kWarpWin + 15 - r + j]));
      sv[c] = (sw[r * kBlockK + j] + bias) * scale + madd[j];
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

// q_u, k, v, q_v, o: [B, H, T, 48] bf16; p_heads: [H, 2T-1, 48] bf16;
// valid: [B, T] bool (one byte each); all contiguous and 16-byte aligned.
// Returns the CUDA error code of the shared-memory opt-in or of the launch.
int gigaam_relpos_sdpa(const void* q_u, const void* k, const void* v,
                       const void* q_v, const void* p_heads, const void* valid,
                       void* o, int batch, int n_heads, int t, float scale,
                       void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      relpos_sdpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kBlockQ - 1) / kBlockQ, n_heads, batch);
  relpos_sdpa_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(p_heads), static_cast<const uint8_t*>(valid),
      static_cast<bf16*>(o), n_heads, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
