// Set-associative TTL probe of the ERCache tables, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of repro/kernels/cache_probe.py:
//   * _cache_probe_tiled (entry cache_probe_tiled) -> ercache_probe_tiled
//   * _cache_probe_dual  (entry cache_probe_dual)  -> ercache_probe_dual
//   * _cache_probe_dual_multi (entry cache_probe_dual_multi, TTL gather
//     _policy_ttls) -> ercache_probe_dual_multi
//   * _cache_probe_perquery (entry cache_probe_perquery, the benchmark's
//     one-query-per-grid-step baseline) -> ercache_probe_perquery
// Every entry runs one probe body (probe_kernel); the dual entries probe
// the direct and the failover table for the same queries in ONE launch,
// as the serve step requires (one probe launch per step).
//
// Per-query entry: the one-table body with kPlusZero set, which also
// drops the way output (Out.way == nullptr). Its value is the reference kernel's masked
// SUM over the ways (the winning row plus zeros), so it is the winning row
// + 0.0: a stored -0.0 comes back +0.0 and every other value keeps its
// bits. kPlusZero clears a lone sign bit in each element of a copy unit
// (each 32-bit word of a 4-byte type, each 16-bit half of a 2-byte one)
// instead of adding, since a float add would also canonicalize NaN
// payloads; on a miss it writes zeros, like the others. The TPU's "one
// query per grid step" against "a tile of queries per grid step" is a
// difference of TPU schedules: on this card both are one warp per query,
// eight queries a CTA.
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
// bound by launch latency and by the chain of DEPENDENT HBM round trips
// each warp waits on (each a full HBM latency). The design cuts that
// chain to three, whatever the entry:
//   1. every load that depends only on q at once: q_hi, q_lo, the clock,
//      both buckets and, on the multi entry, the slot;
//   2. both tables' metadata together, lane w on way w of the direct table
//      (w < Wd) AND of the failover table (w < Wf), beside the TTL pair
//      read at the slot; then the two ballots;
//   3. both winning rows loaded before either is stored.
// One warp per query, lanes on ways (the three metadata words are
// coalesced 32-byte reads), and the warp fetches only the winning row (W x
// less value traffic than fetching the bucket). Rows are copied as raw
// bits in the widest unit (16, 8, 4 or 2 bytes) that divides the row's
// D*elem bytes and the tables' and outputs' base addresses, chosen on the
// host: 8 bytes at D=50 float32 (one pass over 25 lanes), 16 at D=64, 4 at
// D=50 bfloat16, the element otherwise. The probe is therefore bit-exact
// for float32, bfloat16 and float16 tables alike.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // one query per warp
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

// x + 0.0 on the raw bits of an IEEE value: -0.0 -> +0.0, nothing else.
__device__ __forceinline__ uint32_t plus_zero(uint32_t x) {
  return x == 0x80000000u ? 0u : x;
}
__device__ __forceinline__ uint16_t plus_zero(uint16_t x) {
  return x == (uint16_t)0x8000u ? (uint16_t)0u : x;
}

// x + 0.0 on each element of a copy unit, kElem bytes an element.
template <int kElem>
__device__ __forceinline__ uint32_t plus_zero_unit(uint32_t x) {
  if (kElem == 4) return plus_zero(x);
  return (uint32_t)plus_zero((uint16_t)x) |
         ((uint32_t)plus_zero((uint16_t)(x >> 16)) << 16);
}
template <int kElem>
__device__ __forceinline__ uint16_t plus_zero_unit(uint16_t x) {
  return plus_zero(x);  // the launch never pairs 2-byte units with kElem 4
}
template <int kElem>
__device__ __forceinline__ uint2 plus_zero_unit(uint2 x) {
  return make_uint2(plus_zero_unit<kElem>(x.x), plus_zero_unit<kElem>(x.y));
}
template <int kElem>
__device__ __forceinline__ uint4 plus_zero_unit(uint4 x) {
  return make_uint4(plus_zero_unit<kElem>(x.x), plus_zero_unit<kElem>(x.y),
                    plus_zero_unit<kElem>(x.z), plus_zero_unit<kElem>(x.w));
}

// The probe body of every entry. kDual: probe the failover table too;
// kPolicy: per-query TTLs from the multi-model policy table; kPlusZero: 0
// copies the row's bits, 4 or 2 (the element bytes) reads -0.0 back as
// +0.0 and writes no way (the per-query entry). U is the copy unit.
template <typename U, bool kDual, bool kPolicy, int kPlusZero>
__global__ void probe_kernel(Table direct, Out out_d, Table failover,
                             Out out_f, Policy pol, const int32_t* q_hi,
                             const int32_t* q_lo, const int32_t* now_p,
                             int B, int row_units) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= B) return;  // warp-uniform: every lane of a warp shares q
  // round trip 1: everything that depends only on q
  const int32_t now = *now_p;
  const int32_t hi = q_hi[q];
  const int32_t lo = q_lo[q];
  const size_t row_d = (size_t)direct.bucket[q] * direct.ways;
  const size_t row_f = kDual ? (size_t)failover.bucket[q] * failover.ways : 0;
  const size_t slot = kPolicy ? 2 * (size_t)pol.slots[q] : 0;
  // round trip 2: both tables' metadata and the TTL pair
  int32_t ttl_d = direct.ttl;
  int32_t ttl_f = failover.ttl;
  if (kPolicy) {
    ttl_d = __ldg(pol.policy + slot);
    ttl_f = __ldg(pol.policy + slot + 1);
  }
  const bool on_d = lane < direct.ways;
  const bool on_f = kDual && lane < failover.ways;
  int32_t khi_d = 0, klo_d = 0, ts_d = 0, khi_f = 0, klo_f = 0, ts_f = 0;
  if (on_d) {
    khi_d = direct.key_hi[row_d + lane];
    klo_d = direct.key_lo[row_d + lane];
    ts_d = direct.write_ts[row_d + lane];
  }
  if (on_f) {
    khi_f = failover.key_hi[row_f + lane];
    klo_f = failover.key_lo[row_f + lane];
    ts_f = failover.write_ts[row_f + lane];
  }
  const unsigned m_d = __ballot_sync(
      kFullMask, on_d && khi_d == hi && klo_d == lo &&
                     wrap_sub(now, ts_d) <= ttl_d);
  const unsigned m_f =
      kDual ? __ballot_sync(kFullMask, on_f && khi_f == hi && klo_f == lo &&
                                           wrap_sub(now, ts_f) <= ttl_f)
            : 0u;
  const int way_d = __ffs(m_d) - 1;  // -1 when no way is valid
  const int way_f = __ffs(m_f) - 1;
  const int32_t hit_ts_d = __shfl_sync(kFullMask, ts_d, way_d < 0 ? 0 : way_d);
  const int32_t hit_ts_f = __shfl_sync(kFullMask, ts_f, way_f < 0 ? 0 : way_f);
  if (lane == 0) {
    out_d.hit[q] = m_d != 0u;
    if (kPlusZero == 0) out_d.way[q] = way_d;
    out_d.age[q] = m_d != 0u ? wrap_sub(now, hit_ts_d) : -1;
  }
  if (kDual && lane == 1) {
    out_f.hit[q] = m_f != 0u;
    out_f.way[q] = way_f;
    out_f.age[q] = m_f != 0u ? wrap_sub(now, hit_ts_f) : -1;
  }
  // round trip 3: both winning rows (zeros on a miss), loaded then stored
  const U* src_d = static_cast<const U*>(direct.values) +
                   (row_d + (way_d < 0 ? 0 : way_d)) * (size_t)row_units;
  const U* src_f = static_cast<const U*>(failover.values) +
                   (row_f + (way_f < 0 ? 0 : way_f)) * (size_t)row_units;
  U* dst_d = static_cast<U*>(out_d.value) + (size_t)q * row_units;
  U* dst_f = static_cast<U*>(out_f.value) + (size_t)q * row_units;
  for (int i = lane; i < row_units; i += 32) {
    U x_d = m_d != 0u ? src_d[i] : U{};
    if (kPlusZero != 0) x_d = plus_zero_unit<kPlusZero>(x_d);
    U x_f{};
    if (kDual && m_f != 0u) x_f = src_f[i];
    dst_d[i] = x_d;
    if (kDual) dst_f[i] = x_f;
  }
}

template <typename U, bool kDual, bool kPolicy, int kPlusZero>
int launch_unit(const Table& direct, const Out& out_d, const Table& failover,
                const Out& out_f, const Policy& pol, const int32_t* q_hi,
                const int32_t* q_lo, const int32_t* now, int B,
                int row_units, cudaStream_t stream) {
  probe_kernel<U, kDual, kPolicy, kPlusZero>
      <<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
         stream>>>(direct, out_d, failover, out_f, pol, q_hi, q_lo, now, B,
                   row_units);
  return (int)cudaGetLastError();
}

template <bool kDual, bool kPolicy, int kPlusZero = 0>
int launch(const Table& direct, const Out& out_d, const Table& failover,
           const Out& out_f, const Policy& pol, const int32_t* q_hi,
           const int32_t* q_lo, const int32_t* now, int B, int D,
           int elem_bytes, cudaStream_t stream) {
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  // the widest unit dividing the row and every base address it copies from
  // or to (torch allocations are 256-byte aligned; a view may not be)
  const size_t row_bytes = (size_t)D * elem_bytes;
  uintptr_t align = row_bytes | (uintptr_t)direct.values |
                    (uintptr_t)out_d.value;
  if (kDual) align |= (uintptr_t)failover.values | (uintptr_t)out_f.value;
  int unit = 16;
  while (align % unit) unit /= 2;
  // an element-wise +0.0 needs whole elements in a unit (a float32 view
  // is always 4-byte aligned, so this refuses nothing torch can pass)
  if (unit < kPlusZero) return (int)cudaErrorMisalignedAddress;
  const int units = (int)(row_bytes / unit);
  switch (unit) {
    case 16:
      return launch_unit<uint4, kDual, kPolicy, kPlusZero>(
          direct, out_d, failover, out_f, pol, q_hi, q_lo, now, B, units,
          stream);
    case 8:
      return launch_unit<uint2, kDual, kPolicy, kPlusZero>(
          direct, out_d, failover, out_f, pol, q_hi, q_lo, now, B, units,
          stream);
    case 4:
      return launch_unit<uint32_t, kDual, kPolicy, kPlusZero>(
          direct, out_d, failover, out_f, pol, q_hi, q_lo, now, B, units,
          stream);
    case 2:
      return launch_unit<uint16_t, kDual, kPolicy, kPlusZero>(
          direct, out_d, failover, out_f, pol, q_hi, q_lo, now, B, units,
          stream);
  }
  return (int)cudaErrorMisalignedAddress;
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
  return launch<false, false>(t, o, t, o, Policy{nullptr, nullptr}, q_hi,
                              q_lo, now, B, D, elem_bytes,
                              static_cast<cudaStream_t>(stream));
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
  return launch<true, false>(d, od, f, of, Policy{nullptr, nullptr}, q_hi,
                             q_lo, now, B, D, elem_bytes,
                             static_cast<cudaStream_t>(stream));
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
  return launch<true, true>(d, od, f, of, Policy{slots, policy}, q_hi, q_lo,
                            now, B, D, elem_bytes,
                            static_cast<cudaStream_t>(stream));
}

int ercache_probe_perquery(const int32_t* key_hi, const int32_t* key_lo,
                           const int32_t* write_ts, const void* values,
                           int ways, const int32_t* q_hi, const int32_t* q_lo,
                           const int32_t* bucket, const int32_t* now, int ttl,
                           int B, int D, int elem_bytes, uint8_t* hit,
                           void* out, int32_t* age, void* stream) {
  const Table t{key_hi, key_lo, write_ts, values, bucket, ttl, ways};
  const Out o{hit, out, age, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Policy none{nullptr, nullptr};
  if (elem_bytes == 2)
    return launch<false, false, 2>(t, o, t, o, none, q_hi, q_lo, now, B, D,
                                   elem_bytes, s);
  // launch refuses an element size other than 4 (or 2, above)
  return launch<false, false, 4>(t, o, t, o, none, q_hi, q_lo, now, B, D,
                                 elem_bytes, s);
}

const char* ercache_probe_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
