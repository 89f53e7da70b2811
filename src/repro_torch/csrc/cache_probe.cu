// Set-associative TTL probe of the ERCache tables, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of repro/kernels/cache_probe.py:
//   * _cache_probe_tiled (entry cache_probe_tiled) -> ercache_probe_tiled
//   * _cache_probe_dual  (entry cache_probe_dual)  -> ercache_probe_dual
//   * _cache_probe_dual_multi (entry cache_probe_dual_multi, TTL gather
//     _policy_ttls) -> ercache_probe_dual_multi
// All entries share one kernel body; the dual entries probe the direct and
// the failover table for the same queries in ONE launch, as the serve step
// requires (one probe launch per step).
//
// Multi-model tier: the tables are the POOLED (M*Nb, W) views of the
// per-model stacks and the buckets already carry the slot offset, so the
// body is the dual probe's. Only the TTLs differ: query q is validated at
// policy[2*slots[q] + 0] (direct) and policy[2*slots[q] + 1] (failover),
// read from the (M, 2) int32 table in device memory through the read-only
// cache (a few hundred bytes, shared by every warp). The TPU kernel
// prefetches the table into SMEM and unrolls a select over M; that is a
// TPU artefact with no counterpart here. The failover column may hold
// NO_TTL_MS = INT32_MAX (the relaxed degradation-path probe), which the
// signed compare below passes for every real entry. Slots must lie in
// [0, M); the kernel does not check them (the wrapper cannot without a
// host sync). A pooled tier is M*Nb*W*D elements (2^31 and more at
// 8 x 2^21 x 8 x 50), so row offsets are size_t.
//
// Contract (repro_torch/kernels/ref.py:cache_probe_ref): for query q with
// bucket b, lane w of the warp checks way w of row b:
//     valid[w] = key_hi[b,w] == q_hi && key_lo[b,w] == q_lo
//                && int32(now - write_ts[b,w]) <= ttl
// The FIRST valid way wins (the ref's argmax, the Pallas cumsum==1 select):
// __ballot_sync + __ffs. Outputs hit (bool), the winning (D,) value row
// (zeros on a miss), age = now - ts (-1 on a miss) and way (-1 on a miss).
//
// `now - ts` wraps on TS_EMPTY lanes (INT32_MIN). Signed overflow is
// undefined in C++, so the difference is taken in uint32 and reinterpreted,
// which is exactly JAX's int32 wrap; those lanes never match a real key.
//
// What bounds it: per query it reads 3*W int32 of metadata and, on a hit,
// one (D,) value row, and writes (1 + 4 + 4) bytes plus a (D,) row per
// table: ~1 KB a query for both tables at W=8, D=50 f32, ~0.5 MB at B=512
// (the multi-model entry adds a 4-byte slot per query and the table).
// That is well under a microsecond of HBM time, so a serve-size launch is
// bound by launch latency. The design keeps it to one launch and one
// dependent round trip per table: one warp per query, lanes on ways (the
// three metadata words are coalesced 32-byte reads), then the warp copies
// only the winning row (W x less value traffic than fetching the bucket).
// Value rows are D*elem bytes (200 B at D=50 f32), so rows are at best
// 8-byte aligned and are copied element by element, never as 16-byte
// vectors. Values are copied as raw bits (uint32 / uint16), so the probe is
// bit-exact for float32, bfloat16 and float16 tables alike.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

struct Table {
  const int32_t* key_hi;   // (Nb, W)
  const int32_t* key_lo;   // (Nb, W)
  const int32_t* write_ts; // (Nb, W)
  const void* values;      // (Nb, W, D)
  const int32_t* bucket;   // (B,) probed bucket per query
  int32_t ttl;             // the table's TTL when no policy table is given
  int ways;
};

// Per-query TTLs of the multi-model tier; policy == nullptr for the
// single-model entries (each table's scalar ttl then applies).
struct Policy {
  const int32_t* slots;   // (B,) model slot per query, in [0, M)
  const int32_t* policy;  // (M, 2) [direct_ttl, failover_ttl]
};

struct Out {
  uint8_t* hit;   // (B,) bool
  void* value;    // (B, D)
  int32_t* age;   // (B,)
  int32_t* way;   // (B,)
};

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

template <typename T>
__device__ __forceinline__ void probe_one(const Table& t, const Out& o, int q,
                                          int32_t q_hi, int32_t q_lo,
                                          int32_t now, int32_t ttl, int D,
                                          int lane) {
  const size_t row = (size_t)t.bucket[q] * t.ways;
  bool valid = false;
  int32_t ts = 0;
  if (lane < t.ways) {
    ts = t.write_ts[row + lane];
    valid = t.key_hi[row + lane] == q_hi && t.key_lo[row + lane] == q_lo &&
            wrap_sub(now, ts) <= ttl;
  }
  const unsigned mask = __ballot_sync(kFullMask, valid);
  const int way = __ffs(mask) - 1;  // -1 when no way is valid
  const int32_t ts_hit = __shfl_sync(kFullMask, ts, way < 0 ? 0 : way);
  if (lane == 0) {
    o.hit[q] = mask != 0u;
    o.way[q] = way;
    o.age[q] = mask != 0u ? wrap_sub(now, ts_hit) : -1;
  }
  const T* src = static_cast<const T*>(t.values) +
                 (row + (way < 0 ? 0 : way)) * (size_t)D;
  T* dst = static_cast<T*>(o.value) + (size_t)q * D;
  for (int d = lane; d < D; d += 32) dst[d] = mask != 0u ? src[d] : T(0);
}

template <typename T>
__global__ void probe_kernel(Table direct, Out out_d, Table failover,
                             Out out_f, bool dual, Policy pol,
                             const int32_t* q_hi, const int32_t* q_lo,
                             const int32_t* now_p, int B, int D) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= B) return;  // warp-uniform: every lane of a warp shares q
  const int32_t now = *now_p;
  const int32_t hi = q_hi[q];
  const int32_t lo = q_lo[q];
  int32_t ttl_d = direct.ttl;
  int32_t ttl_f = failover.ttl;
  if (pol.policy != nullptr) {
    const size_t row = 2 * (size_t)pol.slots[q];
    ttl_d = __ldg(pol.policy + row);
    ttl_f = __ldg(pol.policy + row + 1);
  }
  probe_one<T>(direct, out_d, q, hi, lo, now, ttl_d, D, lane);
  if (dual) probe_one<T>(failover, out_f, q, hi, lo, now, ttl_f, D, lane);
}

int launch(const Table& direct, const Out& out_d, const Table& failover,
           const Out& out_f, bool dual, const Policy& pol,
           const int32_t* q_hi, const int32_t* q_lo, const int32_t* now,
           int B, int D, int elem_bytes, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  switch (elem_bytes) {
    case 4:
      probe_kernel<uint32_t><<<grid, block, 0, stream>>>(
          direct, out_d, failover, out_f, dual, pol, q_hi, q_lo, now, B, D);
      break;
    case 2:
      probe_kernel<uint16_t><<<grid, block, 0, stream>>>(
          direct, out_d, failover, out_f, dual, pol, q_hi, q_lo, now, B, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ercache_probe_tiled(const int32_t* key_hi, const int32_t* key_lo,
                        const int32_t* write_ts, const void* values, int ways,
                        const int32_t* q_hi, const int32_t* q_lo,
                        const int32_t* bucket, const int32_t* now, int ttl,
                        int B, int D, int elem_bytes, uint8_t* hit, void* out,
                        int32_t* age, int32_t* way, void* stream) {
  const Table t{key_hi, key_lo, write_ts, values, bucket, ttl, ways};
  const Out o{hit, out, age, way};
  return launch(t, o, t, o, false, Policy{nullptr, nullptr}, q_hi, q_lo, now,
                B, D, elem_bytes, static_cast<cudaStream_t>(stream));
}

int ercache_probe_dual(const int32_t* d_key_hi, const int32_t* d_key_lo,
                       const int32_t* d_write_ts, const void* d_values,
                       int d_ways, const int32_t* f_key_hi,
                       const int32_t* f_key_lo, const int32_t* f_write_ts,
                       const void* f_values, int f_ways, const int32_t* q_hi,
                       const int32_t* q_lo, const int32_t* bucket_d,
                       const int32_t* bucket_f, const int32_t* now,
                       int ttl_d, int ttl_f, int B, int D, int elem_bytes,
                       uint8_t* d_hit, void* d_out, int32_t* d_age,
                       int32_t* d_way, uint8_t* f_hit, void* f_out,
                       int32_t* f_age, int32_t* f_way, void* stream) {
  const Table d{d_key_hi, d_key_lo, d_write_ts, d_values, bucket_d, ttl_d,
                d_ways};
  const Table f{f_key_hi, f_key_lo, f_write_ts, f_values, bucket_f, ttl_f,
                f_ways};
  const Out od{d_hit, d_out, d_age, d_way};
  const Out of{f_hit, f_out, f_age, f_way};
  return launch(d, od, f, of, true, Policy{nullptr, nullptr}, q_hi, q_lo, now,
                B, D, elem_bytes, static_cast<cudaStream_t>(stream));
}

int ercache_probe_dual_multi(
    const int32_t* d_key_hi, const int32_t* d_key_lo,
    const int32_t* d_write_ts, const void* d_values, int d_ways,
    const int32_t* f_key_hi, const int32_t* f_key_lo,
    const int32_t* f_write_ts, const void* f_values, int f_ways,
    const int32_t* q_hi, const int32_t* q_lo, const int32_t* slots,
    const int32_t* bucket_d, const int32_t* bucket_f, const int32_t* policy,
    const int32_t* now, int B, int D, int elem_bytes, uint8_t* d_hit,
    void* d_out, int32_t* d_age, int32_t* d_way, uint8_t* f_hit, void* f_out,
    int32_t* f_age, int32_t* f_way, void* stream) {
  const Table d{d_key_hi, d_key_lo, d_write_ts, d_values, bucket_d, 0,
                d_ways};
  const Table f{f_key_hi, f_key_lo, f_write_ts, f_values, bucket_f, 0,
                f_ways};
  const Out od{d_hit, d_out, d_age, d_way};
  const Out of{f_hit, f_out, f_age, f_way};
  return launch(d, od, f, of, true, Policy{slots, policy}, q_hi, q_lo, now, B,
                D, elem_bytes, static_cast<cudaStream_t>(stream));
}

const char* ercache_probe_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
