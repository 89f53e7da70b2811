// Flash-decode of one query token against a KV cache, for Hopper (sm_90a):
// the attention of the LM's decode step.
//
// Replaces repro/kernels/decode_attention.py:decode_attention (the Pallas
// kernel with grid (B, Hkv, S / bs), the S axis sequential, the n_rep query
// heads of a KV head sharing its blocks, m, l and acc in VMEM scratch).
//
// Contract (repro_torch/kernels/ref.py:decode_attention_ref and the Pallas
// kernel): q (B, Hq, hd), k and v (B, S, Hkv, hd), float32 or bfloat16,
// valid_len (B,) int32; query head h reads KV head h / n_rep; q is scaled by
// hd^-0.5 in float32 before the product; positions at and after valid_len[b]
// are masked (score -1e30) and never read; the softmax state (m, l, acc) is
// float32; the output is acc / max(l, 1e-30) cast to q's dtype, so a row
// with valid_len <= 0 gives zeros. A valid_len above S means all S
// positions.
//
// What bounds it: it reads each valid key's k and v row once, q once, and
// writes the output: 4 * B * Hq * hd * valid operations against
// 2 * B * Hkv * hd * valid * sizeof(T) bytes, i.e. 2 * n_rep operations per
// byte in bfloat16 (16 at n_rep 8): memory bounds it by far. At the decode
// path's shapes (B=128, 32/4 heads, hd 64, bf16, 2048 valid positions) the
// cache prefix is 268 MB, ~80 us at 3.35 TB/s.
//
// The design: split-S. The TPU grid's sequential S axis is cut into splits
// of `split_len` keys (whole 64-key tiles); the wrapper picks the number of
// splits from B * Hkv, S (the longest valid_len it knows without a sync)
// and the SM count, so that a launch has at least ~2 CTAs per SM (264 CTAs
// or more at long_500k instead of the B * Hkv = 4 of one CTA per (row, KV
// head)) and no CTA walks more than 4096 keys. One CTA of 4 warps runs per
// (batch row, KV head, split, group of NR query heads); NR = 8, 4 or 1
// divides n_rep, so at n_rep 4 and 8 each key's k and v rows are read from
// device memory once per KV head. Each warp walks its own warp tiles of the
// split (32 keys; fewer for rows above 128 bytes) up to valid_len with its
// own online softmax, through its own 2-stage ring in shared memory: the
// next tile's k and v rows come by 16-byte cp.async copies (XOR-swizzled
// chunks) while the current tile is computed, so the memory stays busy
// without registers holding loads and without block-wide barriers:
//
// - scores: lane j owns key j of the tile, reads its k row from the ring,
//   converts it in registers and takes the NR dot products against q
//   (pre-scaled in float32, in shared memory, read as broadcast float4s),
//   so k is read from device memory once and never n_rep times;
// - softmax: the tile's max per head by warp shuffles, float32 p =
//   exp(s - m) kept per lane in l and written to a warp-private p buffer;
// - P.V: lanes split over (key group, 16-byte slice of the v row); each
//   reads its keys' v slices from the ring and accumulates p * v for the
//   NR heads in float32 registers (no bf16 rounding of p).
//
// Keys past valid_len are never loaded (a stale NaN times p = 0 would
// poison acc). The 4 warps' states merge in shared memory (each warp's
// ring, free by then, holds its accumulator). With one split
// the CTA writes the output; otherwise it writes float32 partials (m, l,
// acc) to the wrapper's scratch and decode_combine merges a row's splits
// as seq_sharded_decode_attention does (repro/distributed/collectives.py):
// m = max of the partial maxima, l and acc the sums of the partials scaled
// by exp(m_s - m). The one trap: a split wholly at or past valid_len reads
// nothing and writes m = -1e30, l = 0, acc = 0, so it drops out of the
// merge (exp(-1e30 - m) = 0) and a row with valid_len <= 0 still gives
// zeros. The JAX partials of such a split would carry l = Sl (every p =
// exp(-1e30 + 1e30) = 1) and make that row the mean of v.
//
// The partials entry (ercache_decode_attention_partials) runs the same
// split kernel on a key range of a longer cache and writes every split's
// partials, the combine skipped: a sequence shard of
// seq_sharded_decode_attention (repro/distributed/collectives.py:77). The
// range is a view: its batch rows lie `kv_bstride` elements apart, and
// its key j is position pos_off + j against valid_len. A split it leaves
// empty writes m = -1e30 exactly (never -inf: with every shard empty,
// exp(m - max m) would be NaN), l = 0 and acc = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // split granularity: splits are whole 64-key tiles
constexpr int kStages = 2;  // per-warp ring of k/v tiles

template <typename T, int HD, int NR>
struct Cfg {
  static constexpr int RB = HD * (int)sizeof(T);  // bytes of a k or v row
  static constexpr int CH = RB / 16;              // 16-byte chunks per row
  static constexpr int VE = 16 / (int)sizeof(T);  // elements per chunk
  // keys per warp tile: 32 (a lane each in the score pass), fewer for rows
  // above 128 bytes so that a stage of k and v stays at 8 KB
  static constexpr int WT = RB <= 128 ? 32 : 4096 / RB;
  static constexpr int KG = 32 / CH;  // P.V: key groups (lanes per row: CH)
  static constexpr int kStage = WT * HD;  // elements of k (or v) per stage
  static_assert(RB % 16 == 0 && CH <= 32 && 32 % CH == 0, "bad width");
  static_assert(kTile % WT == 0 && WT % KG == 0, "bad tile");
};

// Element offset of 16-byte chunk c of row r in a [rows][HD] tile, chunks
// XORed with bits of the row so that lanes reading one chunk of 8
// consecutive rows (the score pass) hit distinct bank groups.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8) return c ^ (r & 7);
  else if constexpr (CH == 4) return c ^ ((r >> 1) & 3);
  else if constexpr (CH == 2) return c ^ ((r >> 2) & 1);
  else return c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory -> float32 (bf16 -> float32 is exact).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// cp.async one warp tile (keys t0 .. t0 + WT - 1, those below kend; the
// rest zero-filled, never read) of k and v into a stage.
template <typename T, int HD, int NR>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, size_t stride, int t0,
                                          int kend, int lane) {
  using C = Cfg<T, HD, NR>;
#pragma unroll
  for (int e = lane; e < C::WT * C::CH; e += 32) {
    const int r = e / C::CH, c = e % C::CH;
    const bool ok = t0 + r < kend;
    const size_t off = ok ? (size_t)(t0 + r) * stride + c * C::VE : 0;
    const int so = r * HD + swz<C::CH>(r, c) * C::VE;
    cp_async16(ks + so, kb + off, ok);
    cp_async16(vs + so, vb + off, ok);
  }
}

// Grid: one CTA per (batch row, KV head, split, head group), head group
// fastest. `part` (nullable when `out` is written) is (B, Hq, n_split,
// HD + 2) float32: acc, then m, then l. The S keys of batch row b start
// at k + b * kv_bstride; key j is position pos_off + j.
template <typename T, int HD, int NR>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ valid_len,
                        T* __restrict__ out, float* __restrict__ part, int S,
                        int Hq, int Hkv, int n_split, int split_len,
                        long long kv_bstride, int pos_off, float scale) {
  using C = Cfg<T, HD, NR>;
  constexpr int CH = C::CH, VE = C::VE, WT = C::WT, KG = C::KG;
  extern __shared__ uint4 smem_dec[];
  T* ring = reinterpret_cast<T*>(smem_dec);  // [kWarps][kStages][2][WT][HD]
  __shared__ __align__(16) float Qs[NR * HD];         // scaled q
  __shared__ __align__(16) float Ps[kWarps][WT * NR];  // p, key-major
  __shared__ float Wm[kWarps][NR], Wl[kWarps][NR];
  static_assert(kStages * 2 * C::kStage * sizeof(T) >=
                    NR * HD * sizeof(float), "ring too small for the merge");

  const int n_rep = Hq / Hkv, groups = n_rep / NR;
  int idx = blockIdx.x;
  const int hg = idx % groups;
  idx /= groups;
  const int sp = idx % n_split;
  idx /= n_split;
  const int kvh = idx % Hkv, b = idx / Hkv;
  const int h0 = kvh * n_rep + hg * NR;  // first query head of the group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int s0 = sp * split_len;
  // keys < kend (a valid_len at or before pos_off leaves none)
  const int kend =
      (int)min(min((long long)valid_len[b] - pos_off, (long long)S),
               (long long)s0 + split_len);
  const size_t stride = (size_t)Hkv * HD;  // elements between keys
  const T* kb = k + (size_t)b * kv_bstride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * kv_bstride + (size_t)kvh * HD;
  T* my = ring + (size_t)warp * kStages * 2 * C::kStage;
  const int step = kWarps * WT;  // this warp's tiles: t0, t0 + step, ...
  int t0 = s0 + warp * WT;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // the ring's first tiles
    if (t0 + i * step < kend)
      load_tile<T, HD, NR>(my + i * 2 * C::kStage,
                           my + (i * 2 + 1) * C::kStage, kb, vb, stride,
                           t0 + i * step, kend, lane);
    cp_async_commit();
  }

  for (int e = tid; e < NR * HD; e += kThreads)
    Qs[e] = to_f(q[((size_t)b * Hq + h0) * HD + e]) * scale;
  __syncthreads();

  float m[NR], l[NR], acc[NR][VE];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[h][e] = 0.f;
  }
  float* P = Ps[warp];
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const int kg = lane / CH, slice = lane % CH;  // P.V roles

  for (int i = 0; t0 < kend; ++i, t0 += step) {
    {  // keep kStages - 1 tiles in flight ahead of this one
      const int ahead = t0 + (kStages - 1) * step;
      const int st = (i + kStages - 1) % kStages;
      if (ahead < kend)
        load_tile<T, HD, NR>(my + st * 2 * C::kStage,
                             my + (st * 2 + 1) * C::kStage, kb, vb, stride,
                             ahead, kend, lane);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
    }
    const T* ks = my + (i % kStages) * 2 * C::kStage;
    const T* vs = ks + C::kStage;

    // scores: lane j owns key t0 + j
    const bool ok = lane < WT && t0 + lane < kend;
    float s[NR];
#pragma unroll
    for (int h = 0; h < NR; ++h) s[h] = 0.f;
    if (lane < WT) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kf[VE];
        unpack(*reinterpret_cast<const uint4*>(
                   ks + lane * HD + swz<CH>(lane, c) * VE),
               kf);
#pragma unroll
        for (int h = 0; h < NR; ++h) {
#pragma unroll
          for (int e = 0; e < VE / 4; ++e) {
            const float4 qv = Q4[(h * HD + c * VE) / 4 + e];
            s[h] = fmaf(qv.x, kf[4 * e + 0], s[h]);
            s[h] = fmaf(qv.y, kf[4 * e + 1], s[h]);
            s[h] = fmaf(qv.z, kf[4 * e + 2], s[h]);
            s[h] = fmaf(qv.w, kf[4 * e + 3], s[h]);
          }
        }
      }
    }
    // online softmax per head (key t0 is always valid: m_new is finite)
#pragma unroll
    for (int h = 0; h < NR; ++h) {
      const float x = ok ? s[h] : kNegInf;
      const float m_new = fmaxf(m[h], warp_max(x));
      const float corr = expf(m[h] - m_new);
      m[h] = m_new;
      const float p = ok ? expf(x - m_new) : 0.f;
      if (lane < WT) P[lane * NR + h] = p;
      l[h] = l[h] * corr + p;  // this lane's share; warp-summed last
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[h][e] *= corr;
    }
    __syncwarp();
    // acc += p . v over this lane's keys (key group kg), its 16-byte slice
#pragma unroll
    for (int jj = 0; jj < WT / KG; ++jj) {
      const int j = kg + KG * jj;
      if (t0 + j < kend) {
        float vf[VE];
        unpack(*reinterpret_cast<const uint4*>(
                   vs + j * HD + swz<CH>(j, slice) * VE),
               vf);
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          const float p = P[j * NR + h];
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
        }
      }
    }
    __syncwarp();  // this stage and the p buffer are consumed
  }
  cp_async_wait<0>();
  __syncwarp();  // the ring is free: it takes this warp's accumulator

  // merge the warp's key groups, then the 4 warps
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    l[h] = warp_sum(l[h]);
#pragma unroll
    for (int off = CH; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
  }
  if (lane < CH) {
    float* wacc = reinterpret_cast<float*>(my);
#pragma unroll
    for (int h = 0; h < NR; ++h)
#pragma unroll
      for (int e = 0; e < VE; ++e) wacc[h * HD + slice * VE + e] = acc[h][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < NR; ++h) {
      Wm[warp][h] = m[h];
      Wl[warp][h] = l[h];
    }
  }
  __syncthreads();
  for (int e = tid; e < NR * HD; e += kThreads) {
    const int h = e / HD, d = e % HD;
    float mc = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, Wm[w][h]);
    float lc = 0.f, ac = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float corr = expf(Wm[w][h] - mc);
      lc += Wl[w][h] * corr;
      ac += reinterpret_cast<const float*>(
                ring + (size_t)w * kStages * 2 * C::kStage)[e] * corr;
    }
    if (part == nullptr) {
      from_f(out + ((size_t)b * Hq + h0 + h) * HD + d,
             ac / fmaxf(lc, 1e-30f));
    } else {
      float* pp = part + (((size_t)b * Hq + h0 + h) * n_split + sp) * (HD + 2);
      pp[d] = ac;
      if (d == 0) {
        pp[HD] = mc;
        pp[HD + 1] = lc;
      }
    }
  }
}

// One warp per (batch row, query head): the online-softmax merge of its
// n_split partials, in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int rows, int n_split) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pp = part + (size_t)row * n_split * (HD + 2);
  float mg = kNegInf;
  for (int s = lane; s < n_split; s += 32) mg = fmaxf(mg, pp[s * (HD + 2) + HD]);
  mg = warp_max(mg);
  float lg = 0.f;
  for (int s = lane; s < n_split; s += 32) {
    const float* ps = pp + s * (HD + 2);
    lg += ps[HD + 1] * expf(ps[HD] - mg);
  }
  lg = warp_sum(lg);
  const float denom = fmaxf(lg, 1e-30f);
  for (int d = lane; d < HD; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = pp + s * (HD + 2);
      a += ps[d] * expf(ps[HD] - mg);
    }
    from_f(out + (size_t)row * HD + d, a / denom);
  }
}

// part == nullptr: one split, the output written by the split kernel;
// out == nullptr: the partials only; both set: split, then combine.
template <typename T, int HD, int NR>
int launch_nr(const void* q, const void* k, const void* v,
              const int32_t* valid_len, void* out, float* part, int B, int S,
              int Hq, int Hkv, int n_split, int split_len,
              long long kv_bstride, int pos_off, float scale,
              cudaStream_t stream) {
  const long long ctas =
      (long long)B * Hkv * n_split * ((Hq / Hkv) / NR);
  if (ctas <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using C = Cfg<T, HD, NR>;
  constexpr size_t smem = sizeof(T) * kWarps * kStages * 2 * C::kStage;
  static bool attr_set = false;  // above 48 KB only as opted-in dynamic smem
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, HD, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  decode_split_kernel<T, HD, NR><<<(unsigned)ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, static_cast<T*>(out), part, S, Hq,
      Hkv, n_split, split_len, kv_bstride, pos_off, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr || out == nullptr) return (int)e;
  const int rows = B * Hq;
  decode_combine_kernel<T, HD>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part, static_cast<T*>(out), rows, n_split);
  return (int)cudaGetLastError();
}

// The arguments every launch shares, past the template's choices.
struct Args {
  const void *q, *k, *v;
  const int32_t* valid_len;
  void* out;
  float* part;
  int B, S, Hq, Hkv, n_split, split_len;
  long long kv_bstride;
  int pos_off;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch(const Args& a) {
  const int n_rep = a.Hq / a.Hkv;
#define ERCACHE_LAUNCH_NR(NR)                                              \
  return launch_nr<T, HD, NR>(a.q, a.k, a.v, a.valid_len, a.out, a.part,  \
                              a.B, a.S, a.Hq, a.Hkv, a.n_split,           \
                              a.split_len, a.kv_bstride, a.pos_off,       \
                              a.scale, a.stream)
  if (n_rep % 8 == 0) ERCACHE_LAUNCH_NR(8);
  if (n_rep % 4 == 0) ERCACHE_LAUNCH_NR(4);
  ERCACHE_LAUNCH_NR(1);
#undef ERCACHE_LAUNCH_NR
}

template <typename T>
int dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 8:
      return launch<T, 8>(a);
    case 16:
      return launch<T, 16>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int hd, int dtype_code) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.n_split <= 0 || a.split_len <= 0 || a.split_len % kTile != 0 ||
      (long long)a.n_split * a.split_len < a.S ||
      (long long)(a.n_split - 1) * a.split_len >= a.S ||
      (a.n_split > 1 && a.part == nullptr) ||
      (a.out == nullptr && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      return dispatch_hd<float>(a, hd);
    case 1:
      return dispatch_hd<__nv_bfloat16>(a, hd);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16. q, k, v, valid_len and out
// contiguous; q, k and v 16-byte aligned. The keys are cut into n_split
// splits of split_len (a multiple of 64, n_split * split_len >= S); with
// n_split > 1, part is float32 scratch of B * Hq * n_split * (hd + 2).
int ercache_decode_attention(const void* q, const void* k, const void* v,
                             const int32_t* valid_len, void* out, void* part,
                             int B, int S, int Hq, int Hkv, int hd,
                             int n_split, int split_len, float scale,
                             int dtype_code, void* stream) {
  const Args a{q, k, v, valid_len, out,
               n_split > 1 ? static_cast<float*>(part) : nullptr, B, S, Hq,
               Hkv, n_split, split_len, (long long)S * Hkv * hd, 0, scale,
               static_cast<cudaStream_t>(stream)};
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(a, hd, dtype_code);
}

// The partials of n_split splits of a key range, no combine: part is
// float32 (B, Hq, n_split, hd + 2) (acc, m, l), written for every split.
// k and v hold the range's S keys of each batch row, rows kv_bstride
// elements apart (a view of a longer cache); key j is position
// pos_off + j against valid_len. Same dtypes and alignment as above.
int ercache_decode_attention_partials(const void* q, const void* k,
                                      const void* v,
                                      const int32_t* valid_len, void* part,
                                      int B, int S, int Hq, int Hkv, int hd,
                                      int n_split, int split_len,
                                      long long kv_bstride, int pos_off,
                                      float scale, int dtype_code,
                                      void* stream) {
  const Args a{q, k, v, valid_len, nullptr, static_cast<float*>(part), B, S,
               Hq, Hkv, n_split, split_len, kv_bstride, pos_off, scale,
               static_cast<cudaStream_t>(stream)};
  if (part == nullptr || kv_bstride < (long long)S * Hkv * hd)
    return (int)cudaErrorInvalidValue;
  return dispatch(a, hd, dtype_code);
}

const char* ercache_decode_attention_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
