// The shared-memory ceiling probe (P3) redesigned for Hopper (sm_90a): one
// bulk copy a block, over eight blocks.
//
// It replaces the Pallas probe benchmarks/pallas_subsampling_probe.py::
// probe_vmem, as subsampling_probe.cu's smem_probe_kernel did (kept there for
// an A/B on the same card).  The function: out = 2 x, exactly, for x [8, 1024]
// bf16 passed through the top of a dynamic shared-memory buffer of n_bytes;
// the question: which n_bytes a block is granted (the card's opt-in limit,
// 227 KB on an H100, and nothing past it) and how many such blocks one SM
// holds.
//
// Bound on the card: 16 KB in and 16 KB out, 0.00001 ms at 3.35 TB/s; a
// launch alone takes longer, so the probe is bound by its launch.
//
// What held the kept kernel back, and what this design does:
//   * It was one block of 256 threads on one SM: 1024 16-byte loads from
//     device memory into the buffer, in turn, a barrier, then 1024 loads
//     from shared memory and 16-byte stores.  Here each of eight blocks takes
//     one 2 KB row of x.  Each block claims the whole n_bytes, so past half
//     the limit one fits an SM and the eight land on eight SMs.
//   * One thread moves the row into the last 2 KB of its block's buffer with
//     one bulk copy (cp.async.bulk, global to shared) that completes an
//     mbarrier; the 128 threads wait on it, then each doubles 16 bytes in
//     registers and stores them.  No thread spends instructions on the
//     copy's addresses.
//   * The barrier lives in the buffer's first 8 bytes: static shared memory
//     would count against the opt-in limit, and the probe must be granted
//     the limit itself.

#include "gemm.cuh"

using namespace gigaam;

namespace {

constexpr int kRowBytes = 1024 * 2;            // a row of x, bf16
constexpr int kRows = 8;                       // rows of x, one a block
constexpr int kBulkThreads = kRowBytes / 16;   // 16 bytes a thread

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar) : "memory");
}

// row blockIdx.x of x into the last kRowBytes of the n_bytes buffer, then 2 x
// out
__global__ void __launch_bounds__(kBulkThreads)
smem_bulk_kernel(const bf16* x, bf16* out, int n_bytes) {
  extern __shared__ __align__(16) unsigned char buf[];
  const uint32_t bar = smem_u32(buf);
  unsigned char* row = buf + n_bytes - kRowBytes;
  const size_t at = (size_t)blockIdx.x * (kRowBytes / 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, kRowBytes);
    bulk_load(smem_u32(row), x + at, kRowBytes, bar);
  }
  __syncthreads();   // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);
  float v[8];
  unpack8(*reinterpret_cast<const uint4*>(row + 16 * threadIdx.x), v);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] *= 2.f;
  reinterpret_cast<uint4*>(out + at)[threadIdx.x] = pack8(v);
}

// the launch alone: the floor that one launch of the probe's grid reaches
__global__ void __launch_bounds__(kBulkThreads) empty_kernel() {}

}  // namespace

extern "C" {

// x, out: [8, 1024] bf16, 16-byte aligned; n_bytes a multiple of 16, at least
// 2 KB + 16.  Sets smem_bulk_kernel's dynamic shared memory to n_bytes,
// launches its eight blocks, then asks how many such blocks one SM holds
// (result[0]).  A size the card refuses sets result[1] to 1, clears the error
// and returns its code before any launch; any other failure returns its code
// with result[1] 0 (cudaErrorInvalidValue, without a launch, for an unaligned
// pointer or a size the kernel does not take).
int gigaam_smem_probe_ws(const void* x, void* out, int n_bytes, int* result,
                         void* stream) {
  result[0] = result[1] = 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
              16 != 0 ||
      n_bytes % 16 != 0 || n_bytes < kRowBytes + 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      smem_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    result[1] = 1;
    return static_cast<int>(err);
  }
  smem_bulk_kernel<<<kRows, kBulkThreads, n_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), n_bytes);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      result, smem_bulk_kernel, kBulkThreads, n_bytes));
}

// empty_kernel on the probe's grid (eight blocks of 128 threads).  Returns
// cudaGetLastError().
int gigaam_smem_probe_ws_empty(void* stream) {
  empty_kernel<<<kRows, kBulkThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
