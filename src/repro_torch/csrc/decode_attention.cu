// L3: one-token GQA decode attention over a (ring) KV cache.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py: decode_attention_padded
//   (body _kernel), and the padding of its wrapper ops.decode_attention.
// For q (B, H, hd) and one layer's cache k, v (B, S, Hkv, hd) with kv_pos
// (S,) the absolute position held by each slot (-1 = empty), query head h
// attends to slot s of KV head h / (H / Hkv) iff
//   kv_pos[s] >= 0 && kv_pos[s] <= q_pos &&
//   (window == 0 || kv_pos[s] > q_pos - window),
// so a ring cache stays exact after wrap-around. softmax in f32; the output
// (B, H, hd) is written in q's dtype; zeros where no slot is valid.
//
// Bound on Hopper: bytes. Each valid slot's K and V rows are read once
// (at B = 8, S = 4096, Hkv = 8, hd = 128, bf16: 134 MB, 40 us at
// 3.35 TB/s) for 4 flops per byte-pair and query head; the card needs ~300
// flops per byte before its arithmetic is the limit.
// Design (split-S flash-decoding):
//   - the TPU grid (B, Hkv, S / 512) runs its S axis in order and carries
//     (m, l, acc) in VMEM. At B = 8, Hkv = 8 that is 64 programs, too few
//     for 132 SMs, so pass 1 cuts S into chunks of 256 slots: one block of
//     128 threads per (b, kv head, chunk), 1024 blocks at S = 4096. It
//     stages 64-slot K and V tiles in shared memory and reads each K/V row
//     once for all `group` query heads of its KV head, keeps an online
//     softmax per head, and writes partial (m, l, acc) per chunk.
//   - pass 2 combines the partials of each (b, h): the cross-block
//     reduction that the TPU did in its sequential grid.
//   - validity comes from kv_pos per slot; a 64-slot tile with no valid
//     slot is skipped without reading K/V, and invalid rows are not read
//     (zeros are staged). A ragged S is masked here: the cache is never
//     padded or copied. The wrapper allocates only the output and the
//     partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTS = 64;          // slots per staged tile
constexpr int kHeadsPerThread = 16;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <int HD>
constexpr int smem_floats(int G) {
  // q (G x HD), k tile (kTS x (HD + 4)), v tile (kTS x HD), scores
  // (G x kTS), per-head m, l, corr
  return G * HD + kTS * (HD + 4) + kTS * HD + G * kTS + 3 * G;
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v,
                      const int32_t* __restrict__ kv_pos,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int S, int H, int Hkv,
                      int q_pos, int window, int chunk, float scale) {
  constexpr int LDK = HD + 4;
  constexpr int TPH = kThreads / HD;  // threads sharing one column d
  extern __shared__ float4 smem4[];
  const int G = H / Hkv;
  float* qs = reinterpret_cast<float*>(smem4);  // G x HD, scaled
  float* ks = qs + G * HD;                      // kTS x LDK
  float* vs = ks + kTS * LDK;                   // kTS x HD
  float* ss = vs + kTS * HD;                    // G x kTS
  float* m_s = ss + G * kTS;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  __shared__ int ok_s[kTS];

  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int s_lo = c * chunk;
  const int s_hi = min(S, s_lo + chunk);
  const int64_t stride = (int64_t)Hkv * HD;
  const TKV* kb = k + ((int64_t)b * S * Hkv + hk) * HD;
  const TKV* vb = v + ((int64_t)b * S * Hkv + hk) * HD;

  const TQ* qb = q + ((int64_t)b * H + (int64_t)hk * G) * HD;
  for (int i = t; i < G * HD; i += kThreads) qs[i] = to_f32<TQ>(qb[i]) * scale;
  for (int g = t; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  // this thread's output column d and heads g0, g0 + TPH, ...; when HD
  // does not divide kThreads (hd = 112) the last kThreads - TPH * HD
  // threads own no column
  const int d = t % HD;
  const int g0 = t / HD;
  const int nh = g0 < G && g0 < TPH ? (G - g0 + TPH - 1) / TPH : 0;
  float acc[kHeadsPerThread];
#pragma unroll
  for (int j = 0; j < kHeadsPerThread; ++j) acc[j] = 0.f;

  for (int s0 = s_lo; s0 < s_hi; s0 += kTS) {
    __syncthreads();  // previous tile's reads done (and q, m, l written)
    int ok = 0;
    if (t < kTS) {
      const int s = s0 + t;
      if (s < s_hi) {
        const int p = kv_pos[s];
        ok = p >= 0 && p <= q_pos && (window <= 0 || p > q_pos - window);
      }
      ok_s[t] = ok;
    }
    if (!__syncthreads_or(ok)) continue;  // no valid slot in this tile

    constexpr int V4 = HD / 4;
    for (int i = t; i < kTS * V4; i += kThreads) {
      const int r = i / V4;
      const int cc = (i % V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (ok_s[r]) {
        const int64_t off = (int64_t)(s0 + r) * stride + cc;
        kx = load4<TKV>(kb + off);
        vx = load4<TKV>(vb + off);
      }
      *reinterpret_cast<float4*>(ks + r * LDK + cc) = kx;
      *reinterpret_cast<float4*>(vs + r * HD + cc) = vx;
    }
    __syncthreads();

    for (int i = t; i < G * kTS; i += kThreads) {
      const int g = i / kTS;
      const int r = i % kTS;
      float sc = -INFINITY;
      if (ok_s[r]) {
        const float* qr = qs + g * HD;
        const float* kr = ks + r * LDK;
        float a = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < HD; dd += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + dd);
          const float4 kv = *reinterpret_cast<const float4*>(kr + dd);
          a = fmaf(qv.x, kv.x, a);
          a = fmaf(qv.y, kv.y, a);
          a = fmaf(qv.z, kv.z, a);
          a = fmaf(qv.w, kv.w, a);
        }
        sc = a;
      }
      ss[g * kTS + r] = sc;
    }
    __syncthreads();

    // online softmax, one warp per head
    const int warp = t / 32;
    const int lane = t % 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = ss[g * kTS + lane];
      const float bb = ss[g * kTS + lane + 32];
      float mx = fmaxf(a, bb);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float pa = a == -INFINITY ? 0.f : expf(a - m_safe);
      const float pb = bb == -INFINITY ? 0.f : expf(bb - m_safe);
      ss[g * kTS + lane] = pa;
      ss[g * kTS + lane + 32] = pb;
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float corr = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kHeadsPerThread; ++j) {
      if (j < nh) {
        const int g = g0 + j * TPH;
        const float* pr = ss + g * kTS;
        float a = acc[j] * corr_s[g];
#pragma unroll 8
        for (int r = 0; r < kTS; ++r) a = fmaf(pr[r], vs[r * HD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

  const int64_t base = (((int64_t)b * Hkv + hk) * gridDim.x + c) * G;
#pragma unroll
  for (int j = 0; j < kHeadsPerThread; ++j)
    if (j < nh) part_acc[(base + g0 + j * TPH) * HD + d] = acc[j];
  for (int g = t; g < G; g += kThreads) {
    part_ml[(base + g) * 2] = m_s[g];
    part_ml[(base + g) * 2 + 1] = l_s[g];
  }
}

// One block of hd threads per (b, h): o = sum_c acc_c e^(m_c - M) /
// sum_c l_c e^(m_c - M), M = max_c m_c over chunks that saw a valid slot.
template <typename TO>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      TO* __restrict__ o, int H, int Hkv,
                                      int hd, int n_chunks) {
  const int G = H / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int g = h % G;
  const int d = threadIdx.x;
  const int64_t row0 = ((int64_t)b * Hkv + hk) * n_chunks;
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_ml[((row0 + c) * G + g) * 2]);
  float L = 0.f, A = 0.f;
  if (!isinf(M)) {
    for (int c = 0; c < n_chunks; ++c) {
      const int64_t r = (row0 + c) * G + g;
      const float mc = part_ml[r * 2];
      if (isinf(mc)) continue;
      const float w = expf(mc - M);
      L = fmaf(part_ml[r * 2 + 1], w, L);
      A = fmaf(part_acc[r * hd + d], w, A);
    }
  }
  o[((int64_t)b * H + h) * hd + d] = from_f32<TO>(A / fmaxf(L, 1e-30f));
}

template <int HD, typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* kv_pos, void* o, float* part_acc,
                   float* part_ml, int B, int S, int H, int Hkv, int q_pos,
                   int window, int chunk, cudaStream_t st) {
  const int G = H / Hkv;
  if (G > kHeadsPerThread * (kThreads / HD)) return cudaErrorInvalidValue;
  auto kern = decode_partial_kernel<HD, TQ, TKV>;
  const int bytes = (int)sizeof(float) * smem_floats<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (S + chunk - 1) / chunk;
  kern<<<dim3(n_chunks, Hkv, B), kThreads, bytes, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kv_pos, part_acc, part_ml, S, H, Hkv, q_pos,
      window, chunk, 1.0f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ><<<B * H, HD, 0, st>>>(
      part_acc, part_ml, static_cast<TQ*>(o), H, Hkv, HD, n_chunks);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     const int32_t* kv_pos, void* o, float* part_acc,
                     float* part_ml, int B, int S, int H, int Hkv, int q_pos,
                     int window, int chunk, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<32, TQ, TKV>(q, k, v, kv_pos, o, part_acc, part_ml, B, S,
                                 H, Hkv, q_pos, window, chunk, st);
    case 64:
      return launch<64, TQ, TKV>(q, k, v, kv_pos, o, part_acc, part_ml, B, S,
                                 H, Hkv, q_pos, window, chunk, st);
    case 112:  // zamba2's shared attention block
      return launch<112, TQ, TKV>(q, k, v, kv_pos, o, part_acc, part_ml, B, S,
                                  H, Hkv, q_pos, window, chunk, st);
    case 128:
      return launch<128, TQ, TKV>(q, k, v, kv_pos, o, part_acc, part_ml, B, S,
                                  H, Hkv, q_pos, window, chunk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, hd); k, v: (B, S, Hkv, hd); kv_pos: (S,) int32; o: (B, H, hd)
// in q's dtype; part_acc: (B, Hkv, n_chunks, H / Hkv, hd) f32 and part_ml:
// (B, Hkv, n_chunks, H / Hkv, 2) f32 scratch, n_chunks = ceil(S / chunk).
// q_bf16 / kv_bf16 pick bf16 over f32. Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_pos,
                                       void* o, void* part_acc, void* part_ml,
                                       int q_bf16, int kv_bf16, int B, int S,
                                       int H, int Hkv, int hd, int q_pos,
                                       int window, int chunk, void* stream) {
  if (B < 0 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || window < 0 ||
      chunk < kTS || chunk % kTS != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pos = static_cast<const int32_t*>(kv_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, pos, o, pa, pm,
                                                 B, S, H, Hkv, q_pos, window,
                                                 chunk, st);
  else if (q_bf16)
    err = dispatch<__nv_bfloat16, float>(hd, q, k, v, pos, o, pa, pm, B, S, H,
                                         Hkv, q_pos, window, chunk, st);
  else if (kv_bf16)
    err = dispatch<float, __nv_bfloat16>(hd, q, k, v, pos, o, pa, pm, B, S, H,
                                         Hkv, q_pos, window, chunk, st);
  else
    err = dispatch<float, float>(hd, q, k, v, pos, o, pa, pm, B, S, H, Hkv,
                                 q_pos, window, chunk, st);
  return (int)err;
}
