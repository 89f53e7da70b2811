// EmbeddingBag gather-reduce for Hopper (sm_90a): the recsys towers' sparse
// lookup (SASRec's item gather on the serve path).
//
// Replaces repro/kernels/embedding_bag.py:embedding_bag (the Pallas kernel
// with grid (B, nnz) and a revisited (1, D) VMEM accumulator).
//
// Contract (repro_torch/kernels/ref.py:embedding_bag_ref): out[b] = sum over
// j of table[ids[b, j]] for ids >= 0 (-1 pads), accumulated in float32 and
// cast once to the table dtype; "mean" divides by max(live, 1) first.
//
// What bounds it: each bag reads nnz ids and its live (D,) rows and writes
// one (D,) row; there is no reuse, so it is bound by HBM bytes: ~10 MB for
// 25,600 nnz=1 bags of D=50 f32 (about 3 us at 3.35 TB/s). The rows sit at
// random places in a 200 MB table, so the reads are scattered 200-byte
// rows. The design: one warp per bag with lanes over D (a row read is one
// contiguous run of lanes), the nnz loop runs in order j = 0..nnz-1 inside
// the warp (the Pallas grid's order), the sum stays in a float32 register
// and is cast once at the end. No shared memory, no atomics, so the result
// is deterministic and, for nnz = 1, exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void bag_kernel(const T* table, const int32_t* ids, int B, int nnz,
                           int D, bool mean, T* out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* bag = ids + (size_t)b * nnz;
  int live = 0;
  for (int j = 0; j < nnz; ++j) live += bag[j] >= 0;
  const float denom = (float)(live > 1 ? live : 1);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.0f;
    for (int j = 0; j < nnz; ++j) {
      const int32_t id = bag[j];
      if (id >= 0) acc += to_float(table[(size_t)id * D + d]);
    }
    if (mean) acc = acc / denom;
    out[(size_t)b * D + d] = from_float<T>(acc);
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16.
int ercache_embedding_bag(const void* table, const int32_t* ids, int B,
                          int nnz, int D, int mean, int dtype_code, void* out,
                          void* stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      bag_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(table), ids, B, nnz, D, mean != 0,
          static_cast<float*>(out));
      break;
    case 1:
      bag_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), ids, B, nnz, D,
          mean != 0, static_cast<__nv_bfloat16*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ercache_embedding_bag_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
