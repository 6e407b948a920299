// L1: flash attention, forward pass (prefill, and forward over a prompt).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_padded
//   (body _kernel), and the padding of its wrapper ops.flash_attention.
// For q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd), f32 or bf16, query row i
// of head h attends to key j of KV head h / (H / Hkv) iff
//   (!causal || j <= i) && (window == 0 || j > i - window) && j < Skv,
// with softmax(q k^T / sqrt(hd)) v computed in f32 by an online softmax and
// written in the input dtype (JAX's f32 result cast to the input dtype).
// When asked (lse != nullptr, the training forward), it also writes each
// row's logsumexp m + log(max(l, 1e-30)), with m := 0 for a row that saw
// no key, in f32 (B, Sq, H): the reference's _finalize with return_lse.
// Serving passes nullptr and does no extra work.
//
// Bound on Hopper: operations. At the serve path's prefill shape (B = 8,
// S = 4000, H = 32, Hkv = 8, hd = 128, causal) the call does 1.05 TFLOP for
// 655 MB of q/k/v/o. This first version computes both products in f32 on
// the CUDA cores, as the TPU kernel does in f32 on its MXU; so it is far
// from the bf16 tensor-core bound (wgmma, TMA and warp specialisation come
// in a later PR).
// Design:
//   - one block of 128 threads owns (b, h, 64 query rows) and loops over
//     64-row KV tiles staged in shared memory; the online-softmax state
//     (m, l) and the 64 x hd accumulator live in registers: the loop inside
//     the block takes the place of the TPU's sequential KV grid axis and
//     its VMEM scratch.
//   - one q-head per block: a block holds 4 x hd accumulators per thread
//     already, so the GQA group's heads are neighbouring blocks (head is
//     the fastest grid axis) and read the same K/V tile through L2.
//   - causal and window masks are loop bounds (the first and last KV tile
//     a query tile needs) instead of the per-tile skip; only tiles that
//     straddle the diagonal, the window edge or the ragged Skv edge mask
//     element by element. Rows past Sq are computed and not stored; keys
//     past Skv are masked. Nothing is padded or copied.
//   - query tiles run longest first (causal rows near the end see the most
//     keys), which shortens the tail of the grid.
//   - thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 i (i < 4) of
//     the score tile, columns tx + 8 j (j < 8), and output columns
//     tx + 8 j (j < hd / 8) of the same rows, so a row's max and sum are
//     reduced over 8 lanes by shuffles. Shared rows are padded by 4 floats
//     so the float4 reads of q and k rows hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBQ == kBK, "stage_rows stages kBK rows for q and k tiles");

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4
load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [r0, r0 + 64) of a (rows, stride) matrix into shared memory
// as f32 (leading dimension LD), times `scale`; rows >= n_rows are zeros.
template <int HD, int LD, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t stride, int r0, int n_rows,
                                           float scale) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < kBK * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) {
      x = load4<T>(src + (int64_t)(r0 + r) * stride + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// the k tile's region also holds P (kBQ x (kBK + 4)) once the scores are
// formed; at hd < 64 P is the larger of the two
template <int HD>
__host__ __device__ constexpr int kt_floats() {
  return kBK * (HD + 4) > kBQ * (kBK + 4) ? kBK * (HD + 4) : kBQ * (kBK + 4);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int window, float scale) {
  constexpr int LDQ = HD + 4;   // q and k rows
  constexpr int LDP = kBK + 4;  // probabilities, in the k tile's space
  constexpr int NJ = HD / 8;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x LDQ
  float* ks = qs + kBQ * LDQ;                   // kBK x LDQ, then P
  float* vs = ks + kt_floats<HD>();             // kBK x HD
  float* ps = ks;                               // kBQ x LDP

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const T* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const T* kb = k + ((int64_t)b * Skv * Hkv + hk) * HD;
  const T* vb = v + ((int64_t)b * Skv * Hkv + hk) * HD;

  stage_rows<HD, LDQ, T>(qs, qb, q_stride, q0, Sq, scale);

  // keys this query tile can see: causal => j <= q0 + kBQ - 1;
  // window => j > q0 - window
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kBQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V reads are done
    stage_rows<HD, LDQ, T>(ks, kb, kv_stride, k0, Skv, 1.f);
    stage_rows<HD, HD, T>(vs, vb, kv_stride, k0, Skv, 1.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * LDQ + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

    const bool interior = k0 + kBK <= Skv &&
                          (!causal || k0 + kBK - 1 <= q0) &&
                          (window <= 0 || k0 > q0 + kBQ - 1 - window);
    if (!interior) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kp = k0 + tx + 8 * j;
          const bool ok = kp < Skv && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) s[i][j] = -INFINITY;
        }
      }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // a row with no key yet keeps m = -inf; exp(-inf - -inf) would be nan
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        s[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sum += __shfl_xor_sync(kFull, sum, 4);
      corr[i] = isinf(m[i]) ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading ks: P goes there
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ps[(ty + 16 * i) * LDP + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * HD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 8 * j] = from_f32<T>(acc[i][j] / denom);
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * Sq + qp) * H + h] =
          (isinf(m[i]) ? 0.f : m[i]) + logf(denom);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (kBQ * (HD + 4) + kt_floats<HD>() + kBK * HD);
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, cudaStream_t st) {
  auto kern = flash_fwd_kernel<HD, T>;
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, Hkv,
      causal, window, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int Sq, int Skv, int H,
                     int Hkv, int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, causal,
                           window, st);
    case 64:
      return launch<64, T>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, causal,
                           window, st);
    case 112:  // zamba2's shared attention block
      return launch<112, T>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, causal,
                            window, st);
    case 128:
      return launch<128, T>(q, k, v, o, lse, B, Sq, Skv, H, Hkv, causal,
                            window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); o: (B, Sq, H, hd), all of one
// dtype (bf16 when is_bf16, else f32), contiguous; lse: f32 (B, Sq, H) or
// nullptr. Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int is_bf16, int B, int Sq, int Skv,
                                      int H, int Hkv, int hd, int causal,
                                      int window, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kBQ || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, l, B, Sq, Skv, H,
                                        Hkv, causal, window, st)
              : dispatch<float>(hd, q, k, v, o, l, B, Sq, Skv, H, Hkv, causal,
                                window, st);
  return (int)err;
}
