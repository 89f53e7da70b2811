// Causal GQA flash attention (FA-2 online softmax) for Hopper (sm_90a): the
// LM user tower's attention at sequence lengths above 1024.
//
// Replaces repro/kernels/flash_attention.py:flash_attention (the Pallas
// kernel with grid (B, Hq, nQ, nK), nK sequential, the running max, sum and
// accumulator in VMEM scratch across the KV steps).
//
// Contract (repro_torch/kernels/ref.py:flash_attention_ref and the Pallas
// kernel): q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), float32 or
// bfloat16 (and, the port's own, bfloat16 v of width hd_v = 128 under q and
// k of hd = 192: MLA); query head h reads KV head h / n_rep; q is scaled by
// hd^-0.5 (q's width) in float32 before the QK^T product; the output is
// (B, Sq, Hq, hd_v); masked scores are -1e30; with `causal`
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
// TFLOP/s float32 rate). MLA's (192, 128) body at the Moonlight tower's
// shape (B=6, S=8192, 16 heads, each with its own 192-wide key, causal):
// 2 * B * Hq * (192 + 128) = 61,440 operations a visible pair, 2.06e12 over
// 33.6M pairs a head, against 1.0 GB of q, k, v and output: compute bound,
// 2.09 ms at 989 TFLOP/s.
//
// Two bodies, chosen by dtype and head width (a dispatch, not a fallback):
//
// fa_wgmma_kernel: bfloat16 at hd 16, 64 and 128, on the tensor cores
// through Hopper's warpgroup mma. One CTA = one warpgroup (4 warps, 16
// query rows each) per (64-row q tile, query head, batch row). The launch
// order is linear: the longest causal q tiles first, and within a q tile
// the n_rep query heads of one KV head next to each other, so 7 of a
// group's 8 CTAs find each K/V tile in L2. Q goes to shared memory once;
// each 64-key tile of K and V comes from device memory as bf16 by 16-byte
// cp.async.cg copies into a 2-stage ring, the next tile's copies issued
// before the current tile is computed; keys past the last one the CTA
// needs are zero-filled, never read. Tiles are stored in wgmma's canonical
// swizzled layout (128-byte rows at hd 64/128, 32-byte at hd 16), so
// S = Q K^T is wgmma m64n64k16 with both operands read by descriptor from
// shared memory (K-major), accumulating in float32; Q is NOT pre-scaled in
// bf16. The online softmax (m, l, acc) stays in float32 registers, m in
// units of log2: the row max is taken on the raw scores (the scale is
// positive) and p = 2^(s * scale * log2 e - m) is one FMA and one
// ex2.approx, so the scale hd^-0.5 is applied to S in float32 (at hd 16
// and 64 a power of two: S equals the reference's (q * scale) . k up to
// summation order). p is summed into l in float32, then packed to bf16 as
// the register A operand of acc += P V, a wgmma m64n{hd}k16 that reads V
// transposed (MN-major) from its [key][dim] tile; the accumulator
// fragment of S is the A fragment of P. P in bf16 is the one new rounding
// against the reference, which multiplies float32 p by float32 v. The
// mask (causal, q_offset, the last key) is applied only on tiles that
// cross it; ragged Sq and Sk are masked per row and per key, not padded in
// memory. The output acc / max(l, 1e-30) is rounded to nearest even into
// bf16, staged in the Q buffer and written as 16-byte stores. Each wgmma
// is waited for before its registers are used (no producer warp, no TMA,
// no overlap of softmax with the next product inside a warpgroup: the
// FA-3 schedule is later work); CTAs on one SM overlap each other.
// fa_wgmma_kernel_qv<192, 128> runs the same body at separate widths (MLA):
// S = Q K^T takes 12 k-steps of m64n64k16 over 192-wide Q and K tiles,
// acc += P V one m64n128k16 per 16 keys over 128-wide V tiles, the output
// 128 wide; shared memory holds Q (24 KB), two K stages (48 KB) and two V
// stages (32 KB), 105 KB with the alignment, so two CTAs share an SM. A v
// zero-padded to 192 would spend half as many P.V operations again.
//
// fa_kernel: float32 (where TF32 would break the 2e-5 bar against the
// reference) and bfloat16 at hd 8 (below the mma depth of 16), on the CUDA
// cores. The TPU grid's sequential KV axis becomes a loop inside one CTA
// per (q tile of 64 rows, head, batch row), which walks its KV tiles only
// up to its last row's diagonal, longest causal rows first. Each 64-key
// tile of K and V is converted to float32 and staged in shared memory
// (zero-filled past the last key). Each query row belongs to G consecutive
// lanes (G = 2, or hd/32 from hd 128 on), each holding hd/G of the row's q
// (pre-scaled) and accumulator dims in registers, in 4-wide groups so that
// shared memory is read as float4; a score is the lanes' partial dot
// products summed with __shfl_xor_sync. The softmax is updated once per
// chunk of 16 keys, then p * V accumulated with float32 FMAs. Keys a row
// may not see score -1e30, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------ tensor-core body (bf16)
using bf16 = __nv_bfloat16;
constexpr int kBQTC = 64;             // query rows per CTA: one warpgroup
constexpr int kBKTC = 64;             // keys per K/V tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreadsTC = 128;       // 4 warps, 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tiles are [atom][rows][AW] bf16: AW = 64 elements (128-byte
// rows, the 128-byte swizzle) at hd 64 and 128, 16 (32-byte rows, the
// 32-byte swizzle) at hd 16. This is the canonical layout wgmma reads
// through a matrix descriptor: K-major for Q and K, MN-major (transposed)
// for V.
template <int HD>
struct TC {
  static constexpr int AW = HD < 64 ? HD : 64;   // elements per atom row
  static constexpr int CPA = AW / 8;              // 16-byte chunks per row
  static constexpr int DT = HD / 8;               // n-tiles of the output
  static constexpr int NT = kBKTC / 8;            // n-tiles of S
  static constexpr int kTile = kBKTC * HD;        // elements of a K/V tile
  static constexpr uint64_t kSwizzle = AW == 64 ? 1 : 3;  // 128 B : 32 B
  static constexpr uint32_t kGroup = 8 * AW * 2;  // bytes of 8 atom rows
  static_assert(AW == 64 || AW == 16, "bad width");
};

// Dynamic shared memory of the body at widths (HQK, HV): the Q tile, then
// kStages K tiles and kStages V tiles; + 1024 to align the tiles to 1024 B.
template <int HQK, int HV>
constexpr size_t tc_smem_bytes() {
  return 1024 + sizeof(bf16) * ((size_t)kBQTC * HQK +
                                (size_t)kStages * kBKTC * (HQK + HV));
}

// Element offset of 16-byte chunk c (of HD / 8) of row r in a tile of
// `rows` rows: the chunk index within its atom row XORed with row bits, as
// the hardware swizzle does (address bits [4, 7) ^= bits [7, 10) for
// 128-byte rows, bit 4 ^= bit 7 for 32-byte rows).
template <int HD>
__device__ __forceinline__ int soff(int rows, int r, int c) {
  using C = TC<HD>;
  const int x = C::AW == 64 ? (r & 7) : ((r >> 2) & 1);
  return (c / C::CPA) * rows * C::AW + r * C::AW + ((c % C::CPA) ^ x) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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
// the threads' cp.async writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers a wgmma writes asynchronously are not ready when its asm
// statement returns: this keeps the compiler from touching them before the
// wait that completes it.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
template <int HD>
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo,
                                          uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (TC<HD>::kSwizzle << 62);
}

// d (+)= A (smem, K-major) * B (smem, K-major), m64n64k16, bf16 -> f32
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (registers) * B (smem, MN-major), m64n16k16, bf16 -> f32
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (registers) * B (smem, MN-major), m64n64k16, bf16 -> f32
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A (registers) * B (smem, MN-major), m64n128k16, bf16 -> f32
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&x);
}

// cp.async the first `valid` of ROWS rows (row stride `stride` elements)
// into a swizzled tile; the rest is zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int valid) {
  constexpr int CH = HD / 8, N = ROWS * CH;
  static_assert(N % kThreadsTC == 0, "bad tile");
#pragma unroll
  for (int i = 0; i < N / kThreadsTC; ++i) {
    const int e = threadIdx.x + kThreadsTC * i, r = e / CH, c = e % CH;
    const bool ok = r < valid;
    cp_async16(dst + soff<HD>(ROWS, r, c), ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// The tensor-core body at q and k width HQK and v width HV: the kernels
// below are this body at (HD, HD) and at MLA's (192, 128).
template <int HQK, int HV>
__device__ __forceinline__ void fa_wgmma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int B, int Sq, int Sk,
    int Hq, int Hkv, int causal, int q_offset, float scale_log2) {
  using CK = TC<HQK>;
  using CV = TC<HV>;
  static_assert(CK::AW == CV::AW, "q, k and v tiles share one atom width");
  constexpr int NT = CK::NT, DT = CV::DT, AW = CK::AW;
  extern __shared__ uint8_t smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_tc) + 1023) & ~uintptr_t(1023));
  bf16* Ks = Qs + kBQTC * HQK;  // [kStages] K tiles, then [kStages] V tiles
  bf16* Vs = Ks + kStages * CK::kTile;

  // linear launch order: q tile slowest (longest first), head fastest
  const int nq = (Sq + kBQTC - 1) / kBQTC;
  const int h = blockIdx.x % Hq, rest = blockIdx.x / Hq;
  const int b = rest % B, qt = nq - 1 - rest / B;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates

  const int q0 = qt * kBQTC;
  int k_end = Sk;  // keys this CTA needs: with `causal`, to its diagonal
  if (causal) k_end = min(Sk, min(q0 + kBQTC, Sq) + q_offset);
  const int n_tiles = (k_end + kBKTC - 1) / kBKTC;

  const size_t q_stride = (size_t)Hq * HQK, k_stride = (size_t)Hkv * HQK;
  const size_t v_stride = (size_t)Hkv * HV, o_stride = (size_t)Hq * HV;
  const bf16* qg = q + ((size_t)b * Sq + q0) * q_stride + (size_t)h * HQK;
  const bf16* kg = k + (size_t)b * Sk * k_stride + (size_t)kvh * HQK;
  const bf16* vg = v + (size_t)b * Sk * v_stride + (size_t)kvh * HV;

  load_rows<HQK, kBQTC>(Qs, qg, q_stride, Sq - q0);
  load_rows<HQK, kBKTC>(Ks, kg, k_stride, min(kBKTC, k_end));
  load_rows<HV, kBKTC>(Vs, vg, v_stride, min(kBKTC, k_end));
  cp_async_commit();

  const int w0 = q0 + warp * 16;  // this warp's first row
  const int pos_min = w0 + q_offset;
  float o[DT * 4];
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKTC;
    if (t + 1 < n_tiles) {  // the next tile's copies fly during this one
      const int st = (t + 1) % kStages, k1 = k0 + kBKTC;
      load_rows<HQK, kBKTC>(Ks + st * CK::kTile, kg + (size_t)k1 * k_stride,
                            k_stride, min(kBKTC, k_end - k1));
      load_rows<HV, kBKTC>(Vs + st * CV::kTile, vg + (size_t)k1 * v_stride,
                           v_stride, min(kBKTC, k_end - k1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const bf16* Kt = Ks + (t % kStages) * CK::kTile;
    const bf16* Vt = Vs + (t % kStages) * CV::kTile;

    // S = Q K^T over the head dim, 16 at a time (within an atom row: +32 B)
    float s[NT * 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HQK / 16; ++kk) {
      const int a = kk * 16 / AW, e = kk * 16 % AW;
      wgmma_ss(s, sdesc<HQK>(Qs + a * kBQTC * AW + e, 16, CK::kGroup),
               sdesc<HQK>(Kt + a * kBKTC * AW + e, 16, CK::kGroup), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(s);

    // mask where the tile crosses the diagonal or the last key
    if (k0 + kBKTC > k_end || (causal && k0 + kBKTC - 1 > pos_min)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = w0 + g + 8 * (e >> 1) + q_offset;
          if (kpos >= k_end || (causal && kpos > qpos)) s[4 * j + e] = kNegInf;
        }
      }
    }
    // online softmax, rows g (r = 0) and g + 8 (r = 1) of this warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m in units of log2: the scale (> 0) commutes with the max
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float corr = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -m_new));
          sum += s[4 * j + e];
        }
      }
      l[r] = l[r] * corr + sum;  // this thread's share; quad-summed last
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[4 * d + 2 * r] *= corr;
        o[4 * d + 2 * r + 1] *= corr;
      }
    }
    // acc += P (bf16, registers) . V (transposed from its [key][dim] tile)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc)
      wgmma_rs(o, pa[kc], sdesc<HV>(Vt + kc * 16 * AW, kBKTC * AW * 2,
                                    CV::kGroup));
    wgmma_commit();
    wgmma_wait();
    pin(o);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (w0 >= Sq) return;
  // stage the warp's 16 rows in its rows of the Q buffer, then 16-byte
  // stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(
          Qs + soff<HV>(kBQTC, warp * 16 + g + 8 * r, d) + 2 * t4) =
          pack_bf16(o[4 * d + 2 * r] / denom, o[4 * d + 2 * r + 1] / denom);
  }
  __syncwarp();
  bf16* og = out + ((size_t)b * Sq + w0) * o_stride + (size_t)h * HV;
#pragma unroll
  for (int e = lane; e < 16 * DT; e += 32) {
    const int r = e / DT, c = e % DT;
    if (w0 + r < Sq)
      *reinterpret_cast<uint4*>(og + r * o_stride + c * 8) =
          *reinterpret_cast<const uint4*>(
              Qs + soff<HV>(kBQTC, warp * 16 + r, c));
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC)
    fa_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int B,
                    int Sq, int Sk, int Hq, int Hkv, int causal, int q_offset,
                    float scale_log2) {
  fa_wgmma_body<HD, HD>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, q_offset,
                        scale_log2);
}

template <int HQK, int HV>
__global__ void __launch_bounds__(kThreadsTC)
    fa_wgmma_kernel_qv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       int q_offset, float scale_log2) {
  fa_wgmma_body<HQK, HV>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, q_offset,
                         scale_log2);
}

// The kernel of widths (HQK, HV): fa_wgmma_kernel<HD> where they are one.
template <int HQK, int HV>
auto wgmma_kernel() {
  if constexpr (HQK == HV)
    return &fa_wgmma_kernel<HQK>;
  else
    return &fa_wgmma_kernel_qv<HQK, HV>;
}

template <int HQK, int HV = HQK>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int Hq, int Hkv, int causal, int q_offset,
              float scale, cudaStream_t stream) {
  constexpr size_t kSmem = tc_smem_bytes<HQK, HV>();
  const auto kernel = wgmma_kernel<HQK, HV>();
  static bool attr_set = false;  // above 48 KB only as opted-in dynamic smem
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long ctas =
      (long long)((Sq + kBQTC - 1) / kBQTC) * Hq * (long long)B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, kThreadsTC, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), B, Sq, Sk, Hq,
      Hkv, causal, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
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
                int B, int Sq, int Sk, int Hq, int Hkv, int hd, int hd_v,
                int causal, int q_offset, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (hd == 192 && hd_v == 128)  // MLA: the tensor cores at two widths
      return launch_tc<192, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                                 q_offset, scale, s);
  }
  if (hd_v != hd) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (hd) {  // the tensor cores; hd 8 is below the mma depth of 16
      case 8:
        return launch<T, 8>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                            q_offset, scale, s);
      case 16:
        return launch_tc<16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                             q_offset, scale, s);
      case 64:
        return launch_tc<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                             q_offset, scale, s);
      case 128:
        return launch_tc<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                              q_offset, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (hd) {
      case 8:
        return launch<T, 8>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                            q_offset, scale, s);
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
}

}  // namespace

extern "C" {

// dtype_code: 0 = float32, 1 = bfloat16. q, k, v and out contiguous; hd
// the width of q and k, hd_v that of v and out.
int ercache_flash_attention(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Sk, int Hq,
                            int Hkv, int hd, int hd_v, int causal,
                            int q_offset, float scale, int dtype_code,
                            void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return dispatch_hd<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, hd_v,
                                causal, q_offset, scale, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd,
                                        hd_v, causal, q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ercache_flash_attention_strerror(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
