// Causal GQA flash attention (FA-2 online softmax) for Hopper (sm_90a): the
// LM user tower's attention at sequence lengths above 1024.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel with grid (B, Hq, nQ, nK), nK sequential, the running max, sum and
// accumulator in VMEM scratch across the KV steps).
//
// Contract (repro_torch/kernels/ref.py:flash_attention_ref and the Pallas
// kernel): q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), float32 or
// bfloat16; query head h reads KV head h / n_rep; q is scaled by hd^-0.5 in
// float32 before the QK^T product; masked scores are -1e30; with `causal`
// the key at position j is visible to the query at position i + q_offset
// iff j <= i + q_offset, and KV tiles wholly above the diagonal are
// skipped; the softmax state (m, l, acc) is float32; the output is
// acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it: 4 * B * Hq * hd * (visible query-key pairs) operations.
// At the tower's shapes (B=48, S=2048, 32 query heads, 4 KV heads, hd 64,
// bf16, causal) that is 8.25e11 operations against ~0.9 GB of q, k, v and
// output: about 900 operations per byte, so compute bounds it (0.83 ms at
// the tensor cores' 989 TFLOP/s bf16 rate; 12 ms at the CUDA cores' 67
// TFLOP/s float32 rate, which is the rate this kernel can reach).
//
// The design (simple first; tensor cores are later work): the TPU grid's
// sequential KV axis becomes a loop inside one CTA per (q tile of 64 rows,
// head, batch row), which walks its KV tiles only up to its last row's
// diagonal. The CTAs of the longest causal rows are launched first. Each
// 64-key tile of K and V is converted to float32 and staged in shared
// memory (zero-filled past the last key). Each query row belongs to G
// consecutive lanes (G = 2, or hd/32 from hd 128 on), each holding hd/G of
// the row's q (pre-scaled) and accumulator dims in registers, in 4-wide
// groups so that shared memory is read as float4; a score is the lanes'
// partial dot products summed with __shfl_xor_sync, which leaves the same
// bits on every lane of the row. The softmax is updated once per chunk of
// 16 keys: chunk max, one rescale of l and acc, then p * V accumulated with
// float32 FMAs on the CUDA cores. Control flow is uniform across a warp;
// keys a row may not see score -1e30, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;      // query rows per CTA
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

template <int HD>
struct Shape {
  static constexpr int G = HD >= 128 ? HD / 32 : 2;  // lanes per query row
  static constexpr int DL = HD / G;                    // dims per lane
  static constexpr int V4 = DL / 4;                    // float4 groups per lane
  static constexpr int kThreads = kBQ * G;
  static constexpr size_t kSmem = 2 * kBK * HD * sizeof(float);
  static_assert(DL % 4 == 0 && G <= 32 && (G & (G - 1)) == 0, "bad width");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float x, float y,
                                       float z, float w) {
  // round to nearest even, as torch's cast
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(z, w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
              int Hq, int Hkv, int causal, int q_offset, float scale) {
  using S = Shape<HD>;
  constexpr int G = S::G, DL = S::DL, V4 = S::V4, R4 = HD / 4;
  extern __shared__ float4 smem[];
  float4* Ks = smem;               // [kBK][HD / 4]
  float4* Vs = smem + kBK * R4;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int row = threadIdx.x / G, lane = threadIdx.x % G;
  const int qi = qt * kBQ + row;
  const bool live = qi < Sq;
  const int qpos = qi + q_offset;

  // this lane's dims: group i holds dims 4 * (lane + G * i) .. + 3
  float qr[DL], acc[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) qr[d] = acc[d] = 0.0f;
  if (live) {
    const T* qp = q + (((size_t)b * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const float4 x = load4(qp + 4 * (lane + G * i));
      qr[4 * i + 0] = x.x * scale;
      qr[4 * i + 1] = x.y * scale;
      qr[4 * i + 2] = x.z * scale;
      qr[4 * i + 3] = x.w * scale;
    }
  }
  float m = kNegInf, l = 0.0f;

  // keys this CTA needs: with `causal`, up to its last row's diagonal
  int k_end = Sk;
  if (causal) {
    const int last = min(qt * kBQ + kBQ, Sq) - 1 + q_offset;
    k_end = min(Sk, last + 1);
  }
  const size_t kv_stride = (size_t)Hkv * HD;  // elements between keys
  const T* kb = k + ((size_t)b * Sk * Hkv + kvh) * HD;
  const T* vb = v + ((size_t)b * Sk * Hkv + kvh) * HD;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, k_end - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBK * R4; e += S::kThreads) {
      const int j = e / R4, c4 = e % R4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (j < nk) {
        const size_t off = (size_t)(k0 + j) * kv_stride + 4 * c4;
        kk = load4(kb + off);
        vv = load4(vb + off);
      }
      Ks[e] = kk;
      Vs[e] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* kr = Ks + (j0 + c) * R4;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          const float4 kk = kr[lane + G * i];
          dot = fmaf(qr[4 * i + 0], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int j = j0 + c, kpos = k0 + j;
        const bool visible = j < nk && (!causal || kpos <= qpos);
        s[c] = visible ? dot : kNegInf;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = __expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = __expf(s[c] - m_new);
        psum += p;
        const float4* vr = Vs + (j0 + c) * R4;
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          const float4 vv = vr[lane + G * i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      l = l * corr + psum;
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + (((size_t)b * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int i = 0; i < V4; ++i)
      store4(op + 4 * (lane + G * i), acc[4 * i + 0] / denom,
             acc[4 * i + 1] / denom, acc[4 * i + 2] / denom,
             acc[4 * i + 3] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  using S = Shape<HD>;
  static bool attr_set = false;  // above 48 KB only as opted-in dynamic smem
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  fa_kernel<T, HD><<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                int q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, q_offset,
                          scale, s);
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                           q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                            q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16. q, k, v and out contiguous.
int ercache_flash_attention(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Sk, int Hq,
                            int Hkv, int hd, int causal, int q_offset,
                            float scale, int dtype_code, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return dispatch_hd<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal,
                                q_offset, scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd,
                                        causal, q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ercache_flash_attention_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
