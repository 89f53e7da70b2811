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
// are masked (score -1e30) and blocks starting at or beyond it are skipped;
// the softmax state (m, l, acc) is float32; the output is acc / max(l, 1e-30)
// cast to q's dtype, so a row with valid_len <= 0 gives zeros. A valid_len
// above S means all S positions.
//
// What bounds it: it reads each valid key's k and v row once, q once, and
// writes the output: 4 * B * Hq * hd * valid operations against
// 2 * B * Hkv * hd * valid * sizeof(T) bytes, i.e. 2 * n_rep operations per
// byte in bfloat16 (16 at n_rep 8): memory bounds it by far. At the decode
// path's shapes (B=128, 32/4 heads, hd 64, bf16, 2048 valid positions) the
// cache prefix is 268 MB, ~80 us at 3.35 TB/s.
//
// The design (simple first; split-S across CTAs, cp.async/TMA and tensor
// cores are later work): the TPU grid's sequential S axis becomes a loop in
// one CTA of 128 threads per (batch row, KV head), which walks the cache in
// tiles of TK keys and stops at valid_len. Only the valid keys are read: the
// tail of the last tile is zero-filled, never loaded (a stale NaN times
// p = 0 would poison acc). Each tile of k and v goes global -> registers as
// 16-byte loads (neighbouring threads on neighbouring bytes of a key row),
// is converted to float32 into shared memory, and the NEXT tile's loads are
// issued before the current one is computed, so a tile's memory latency
// hides behind the previous tile's arithmetic. The n_rep query heads' q
// (pre-scaled) sits in shared memory with k; scores are float4 dot products
// (rows padded by 4 floats: conflict-free 128-bit reads), one (head, key)
// pair per thread; then one warp per head updates m and l and turns the
// scores into p; then each thread updates 4 consecutive accumulator dims of
// one head with p * v. A warp's control flow is uniform.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to on sm_90

template <typename T, int HD>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int kRowVecs = HD / kVec;         // 16-byte loads per row
  // keys per tile: at most 64, and k + v of a tile in 8 uint4 per thread
  static constexpr int kTK0 = 8 * kThreads * 16 / (2 * HD * (int)sizeof(T));
  static constexpr int TK = kTK0 < 64 ? kTK0 : 64;
  static constexpr int kChunks = 2 * TK * kRowVecs / kThreads;
  static constexpr int KS = HD + 4;  // padded k / q row (floats)
  static constexpr int PS = TK + 1;  // padded p row (floats)
  static_assert(HD % kVec == 0 && TK % 4 == 0, "bad width");
  static_assert(kChunks * kThreads == 2 * TK * kRowVecs, "bad tile");
};

template <typename T, int HD>
size_t smem_bytes(int n_rep) {
  using C = Tile<T, HD>;
  return sizeof(float) * ((size_t)C::TK * C::KS + (size_t)C::TK * HD +
                          (size_t)n_rep * (C::KS + C::PS + HD + 3));
}

__device__ __forceinline__ void put(float* dst, const uint4& u, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
}
__device__ __forceinline__ void put(float* dst, const uint4& u,
                                    __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

// Issue the 16-byte loads of one tile (keys k0 .. k0 + nk - 1) into buf.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(uint4 (&buf)[Tile<T, HD>::kChunks],
                                          const T* kb, const T* vb,
                                          size_t key_stride, int k0, int nk) {
  using C = Tile<T, HD>;
#pragma unroll
  for (int i = 0; i < C::kChunks; ++i) {
    const int c = threadIdx.x + kThreads * i;
    const bool is_v = c >= C::TK * C::kRowVecs;
    const int r = is_v ? c - C::TK * C::kRowVecs : c;
    const int j = r / C::kRowVecs, part = r % C::kRowVecs;
    buf[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < nk)
      buf[i] = *reinterpret_cast<const uint4*>(
          (is_v ? vb : kb) + (size_t)(k0 + j) * key_stride + part * C::kVec);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const int32_t* __restrict__ valid_len, T* __restrict__ out,
                  int S, int Hq, int Hkv, float scale) {
  using C = Tile<T, HD>;
  constexpr int TK = C::TK, KS = C::KS, PS = C::PS, HD4 = HD / 4;
  const int n_rep = Hq / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [TK][KS]
  float* Vs = Ks + TK * KS;                     // [TK][HD]
  float* Qs = Vs + TK * HD;                     // [n_rep][KS], 16 B aligned
  float* Acc = Qs + n_rep * KS;                 // [n_rep][HD], 16 B aligned
  float* Ps = Acc + n_rep * HD;                 // [n_rep][PS]
  float* Ms = Ps + n_rep * PS;                  // [n_rep]
  float* Ls = Ms + n_rep;
  float* Cs = Ls + n_rep;                       // this tile's rescale

  const size_t q0 = ((size_t)b * Hq + (size_t)kvh * n_rep) * HD;
  for (int e = tid; e < n_rep * HD; e += kThreads) {
    Qs[(e / HD) * KS + e % HD] = to_f(q[q0 + e]) * scale;
    Acc[e] = 0.0f;
  }
  for (int h = tid; h < n_rep; h += kThreads) {
    Ms[h] = kNegInf;
    Ls[h] = 0.0f;
  }

  const int kend = min(max(valid_len[b], 0), S);  // keys to read
  const size_t key_stride = (size_t)Hkv * HD;     // elements between keys
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * HD;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * HD;

  uint4 buf[C::kChunks];
  if (kend > 0) load_tile<T, HD>(buf, kb, vb, key_stride, 0, min(TK, kend));
  for (int k0 = 0; k0 < kend; k0 += TK) {
    const int nk = min(TK, kend - k0);
    __syncthreads();  // the previous tile (and q, Acc at first) is consumed
#pragma unroll
    for (int i = 0; i < C::kChunks; ++i) {
      const int c = tid + kThreads * i;
      const bool is_v = c >= TK * C::kRowVecs;
      const int r = is_v ? c - TK * C::kRowVecs : c;
      const int j = r / C::kRowVecs, col = (r % C::kRowVecs) * C::kVec;
      put(is_v ? Vs + j * HD + col : Ks + j * KS + col, buf[i], T());
    }
    __syncthreads();
    if (k0 + TK < kend)  // in flight while this tile is computed
      load_tile<T, HD>(buf, kb, vb, key_stride, k0 + TK,
                       min(TK, kend - k0 - TK));

    // scores: one (head, key) pair per thread, keys past the tile -1e30
    for (int p = tid; p < n_rep * TK; p += kThreads) {
      const int h = p / TK, j = p % TK;
      float s = kNegInf;
      if (j < nk) {
        const float4* qr = reinterpret_cast<const float4*>(Qs + h * KS);
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * KS);
        s = 0.0f;
#pragma unroll
        for (int i = 0; i < HD4; ++i) {
          const float4 a = qr[i], c = kr[i];
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
          s = fmaf(a.z, c.z, s);
          s = fmaf(a.w, c.w, s);
        }
      }
      Ps[h * PS + j] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int h = warp; h < n_rep; h += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, Ps[h * PS + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < TK; j += 32) {
        const float p = expf(Ps[h * PS + j] - m_new);
        Ps[h * PS + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[h] = corr;
        Ls[h] = Ls[h] * corr + sum;
        Ms[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v, 4 dims of one head per thread
    const float4* V4 = reinterpret_cast<const float4*>(Vs);
    float4* A4 = reinterpret_cast<float4*>(Acc);
    for (int g = tid; g < n_rep * HD4; g += kThreads) {
      const int h = g / HD4, d4 = g % HD4;
      const float corr = Cs[h];
      float4 a = A4[g];
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
      const float* pr = Ps + h * PS;
      for (int j = 0; j < nk; ++j) {
        const float p = pr[j];
        const float4 x = V4[j * HD4 + d4];
        a.x = fmaf(p, x.x, a.x);
        a.y = fmaf(p, x.y, a.y);
        a.z = fmaf(p, x.z, a.z);
        a.w = fmaf(p, x.w, a.w);
      }
      A4[g] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < n_rep * HD; e += kThreads)
    from_f(out + q0 + e, Acc[e] / fmaxf(Ls[e / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v,
           const int32_t* valid_len, void* out, int B, int S, int Hq, int Hkv,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(Hq / Hkv);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;  // above 48 KB only after opting in
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  decode_kernel<T, HD><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, static_cast<T*>(out), S, Hq, Hkv,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int32_t* valid_len, void* out, int B, int S, int Hq,
                int Hkv, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, valid_len, out, B, S, Hq, Hkv, scale, s);
    case 16:
      return launch<T, 16>(q, k, v, valid_len, out, B, S, Hq, Hkv, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, valid_len, out, B, S, Hq, Hkv, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, valid_len, out, B, S, Hq, Hkv, scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16. q, k, v, valid_len and out
// contiguous; q, k and v 16-byte aligned.
int ercache_decode_attention(const void* q, const void* k, const void* v,
                             const int32_t* valid_len, void* out, int B, int S,
                             int Hq, int Hkv, int hd, float scale,
                             int dtype_code, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return dispatch_hd<float>(q, k, v, valid_len, out, B, S, Hq, Hkv, hd,
                                scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, valid_len, out, B, S, Hq,
                                        Hkv, hd, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ercache_decode_attention_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
