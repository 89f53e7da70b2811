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
// one (D,) row; there is no reuse, so the floor is HBM bytes: ~7.8 MB for
// the serve path's 19,200 nnz=1 bags of D=50 f32 (2.3 us at 3.35 TB/s).
// The rows sit at random places in a 200 MB table, so every row is a
// dependent load behind its id, and what holds a simple kernel back is
// latency: too few bytes in flight and a tail wave. The design:
//   * lanes cover (bag, unit) items, a unit being the widest copy (16, 8,
//     4 or 2 bytes) that divides the row's D*elem bytes and the table's and
//     output's base addresses, chosen on the host (float2 at D=50 f32). The
//     items are numbered bag-major, so a warp's row reads are runs of whole
//     rows and its stores one contiguous run of the output;
//   * each lane takes kItems items and, per round of kIds ids, loads the
//     ids of all its items, then issues all their row loads, then adds: a
//     lane keeps kItems * kIds independent loads in flight where a warp per
//     bag kept one. Rows are read once, so they are loaded evict-first
//     (__ldcs) and leave L2 to the ids and the output;
//   * the grid is one wave of resident blocks (SM count x occupancy),
//     striding over the items, so no tail wave runs alone.
// The ids are read once, for the live count and the addresses together.
// The float32 sum of each item runs in order j = 0..nnz-1 and is cast once
// at the end; no shared memory, no atomics, so the result is deterministic
// and, for nnz = 1, exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kItems = 2;  // (bag, unit) items per lane
constexpr int kIds = 2;    // ids of each item's bag loaded per round

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

// T: the table's element; U: the copy unit (row_units of them per row).
template <typename T, typename U>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    bag_kernel(const U* table, const int32_t* ids, int B, int nnz,
               int row_units, bool mean, U* out) {
  constexpr int kE = sizeof(U) / sizeof(T);
  // item numbers stay below 2^31 (checked on the host), so base + stride
  // cannot wrap in 32 unsigned bits
  const unsigned total = (unsigned)B * row_units;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned stride = (gridDim.x * blockDim.x >> 5) * 32 * kItems;
  for (unsigned base = warp * 32 * kItems + lane; base < total;
       base += stride) {
    int bag[kItems], unit[kItems], live[kItems];
    float acc[kItems][kE];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned f = base + 32 * k;
      bag[k] = f < total ? (int)(f / row_units) : -1;
      unit[k] = (int)(f - (unsigned)bag[k] * row_units);
      live[k] = 0;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[k][e] = 0.0f;
    }
    for (int j0 = 0; j0 < nnz; j0 += kIds) {
      int32_t id[kItems][kIds];
#pragma unroll
      for (int k = 0; k < kItems; ++k)
#pragma unroll
        for (int j = 0; j < kIds; ++j)
          id[k][j] = bag[k] >= 0 && j0 + j < nnz
                         ? __ldg(ids + (size_t)bag[k] * nnz + j0 + j)
                         : -1;
      U row[kItems][kIds];
#pragma unroll
      for (int k = 0; k < kItems; ++k)
#pragma unroll
        for (int j = 0; j < kIds; ++j)
          row[k][j] = id[k][j] >= 0
                          ? __ldcs(table + (size_t)id[k][j] * row_units +
                                   unit[k])
                          : U{};
#pragma unroll
      for (int k = 0; k < kItems; ++k)
#pragma unroll
        for (int j = 0; j < kIds; ++j) {
          if (id[k][j] < 0) continue;
          ++live[k];
          T x[kE];
          memcpy(x, &row[k][j], sizeof(U));
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[k][e] += to_float(x[e]);
        }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (bag[k] < 0) continue;
      const float denom = (float)(live[k] > 1 ? live[k] : 1);
      T y[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        y[e] = from_float<T>(mean ? acc[k][e] / denom : acc[k][e]);
      U o;
      memcpy(&o, y, sizeof(U));
      out[base + 32 * k] = o;
    }
  }
}

template <typename T, typename U>
int launch_unit(const void* table, const int32_t* ids, int B, int nnz,
                int row_units, bool mean, void* out, int n_sm,
                cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks of this instance on one SM
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bag_kernel<T, U>, 32 * kWarpsPerBlock, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t per_block = 32 * kItems * kWarpsPerBlock;
  const int64_t want = ((int64_t)B * row_units + per_block - 1) / per_block;
  const int64_t wave = (int64_t)n_sm * (per_sm > 0 ? per_sm : 1);
  bag_kernel<T, U><<<(unsigned)(want < wave ? want : wave),
                     32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const U*>(table), ids, B, nnz, row_units, mean,
      static_cast<U*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, const int32_t* ids, int B, int nnz, int D,
           bool mean, void* out, int n_sm, cudaStream_t stream) {
  // the widest unit dividing the row and both base addresses (torch
  // allocations are 256-byte aligned; a view of a table may not be)
  const size_t row_bytes = (size_t)D * sizeof(T);
  const uintptr_t align = row_bytes | (uintptr_t)table | (uintptr_t)out;
  int unit = 16;
  while (align % unit) unit /= 2;
  const int units = (int)(row_bytes / unit);
  if ((int64_t)B * units >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  switch (unit) {
    case 16:
      return launch_unit<T, uint4>(table, ids, B, nnz, units, mean, out,
                                   n_sm, stream);
    case 8:
      return launch_unit<T, uint2>(table, ids, B, nnz, units, mean, out,
                                   n_sm, stream);
    case 4:
      return launch_unit<T, uint32_t>(table, ids, B, nnz, units, mean, out,
                                      n_sm, stream);
    case 2:
      if constexpr (sizeof(T) <= 2)
        return launch_unit<T, uint16_t>(table, ids, B, nnz, units, mean, out,
                                        n_sm, stream);
      break;
  }
  return (int)cudaErrorMisalignedAddress;
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16. n_sm: the device's SM count.
int ercache_embedding_bag(const void* table, const int32_t* ids, int B,
                          int nnz, int D, int mean, int dtype_code, void* out,
                          int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float>(table, ids, B, nnz, D, mean != 0, out, n_sm, s);
    case 1:
      return launch<__nv_bfloat16>(table, ids, B, nnz, D, mean != 0, out,
                                   n_sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ercache_embedding_bag_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
