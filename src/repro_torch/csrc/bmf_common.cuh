// Shared device code of the BMF kernels B1 (bmf_precision.cu) and B2
// (bmf_sweep.cu): the gather and accumulate of one padded-CSR row's Gibbs
// sufficient statistics, by one thread (K <= 16: bmf_row_accum, both
// kernels) or by one warp (16 < K <= 32: bmf_warp_accum_row, B2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BMF_FULL_MASK 0xffffffffu

template <typename T>
__device__ __forceinline__ float bmf_to_f32(T x);

template <>
__device__ __forceinline__ float bmf_to_f32<float>(float x) { return x; }

// bf16 factors are widened on load; products and sums stay in f32
template <>
__device__ __forceinline__ float bmf_to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// One thread per row (K <= 16)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// v = row p[0..K) of the other factor in f32, in the widest aligned loads
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p + k));
      v[k] = q.x;
      v[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ float2 widen(uint32_t pair) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pair));
}

template <int K>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&v)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + k));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = widen(w[e]);
        v[k + 2 * e] = f.x;
        v[k + 2 * e + 1] = f.y;
      }
    }
  } else if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p + k));
      const float2 f0 = widen(q.x), f1 = widen(q.y);
      v[k] = f0.x;
      v[k + 1] = f0.y;
      v[k + 2] = f1.x;
      v[k + 3] = f1.y;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 f = widen(__ldg(reinterpret_cast<const unsigned*>(p + k)));
      v[k] = f.x;
      v[k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __bfloat162float(p[k]);
  }
}

// G slots, in order: gather their rows (a slot at or past live is not
// read: its row is zero and w = r = 0) and add w v v^T and w r v
template <int K, int G, typename T>
__device__ __forceinline__ void add_slots(const T* __restrict__ ob,
                                          const int (&j)[G],
                                          const float (&w)[G],
                                          const float (&r)[G],
                                          const bool (&ok)[G],
                                          float (&lam)[K * (K + 1) / 2],
                                          float (&eta)[K]) {
  float v[G][K];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (ok[q]) {
      load_row<K>(ob + (int64_t)j[q] * K, v[q]);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) v[q][k] = 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float wq = ok[q] ? w[q] : 0.f;
    const float wr = wq * (ok[q] ? r[q] : 0.f);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float wv = wq * v[q][i];
#pragma unroll
      for (int c = 0; c <= i; ++c)
        lam[tri(i, c)] = fmaf(wv, v[q][c], lam[tri(i, c)]);
      eta[i] = fmaf(wr, v[q][i], eta[i]);
    }
  }
}

// One thread accumulates one row's lower triangle lam[tri(i, c)] =
// sum_m w_m v_m[i] v_m[c] and eta[i] = sum_m w_m r_m v_m[i] over its live
// slots m < n, in slot order, one fma per entry and slot. ix/vl/mk are the
// row's planes and ob its block's factor (16-byte aligned); with vec4 (the
// planes' width a multiple of 4 and the planes 16-byte aligned) the slots'
// idx/val/mask come four at a time in 16-byte loads, the next four in
// flight while this four's factor rows are gathered and added.
// G: factor rows gathered at once.
template <int K, typename T, int G = (K <= 12 ? 4 : 2)>
__device__ __forceinline__ void bmf_row_accum(
    const T* ob, const int32_t* ix, const float* vl, const float* mk, int n,
    int vec4, float (&lam)[K * (K + 1) / 2], float (&eta)[K]) {
  constexpr int KT = K * (K + 1) / 2;
#pragma unroll
  for (int i = 0; i < KT; ++i) lam[i] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) eta[i] = 0.f;

  if (vec4) {
    // four slots per 16-byte load of each plane; the next four in flight
    int4 jn = make_int4(0, 0, 0, 0);
    float4 wn = make_float4(0.f, 0.f, 0.f, 0.f), rn = wn;
    if (n > 0) {
      jn = __ldg(reinterpret_cast<const int4*>(ix));
      wn = __ldg(reinterpret_cast<const float4*>(mk));
      rn = __ldg(reinterpret_cast<const float4*>(vl));
    }
    for (int m0 = 0; m0 < n; m0 += 4) {
      const int js[4] = {jn.x, jn.y, jn.z, jn.w};
      const float ws[4] = {wn.x, wn.y, wn.z, wn.w};
      const float rs[4] = {rn.x, rn.y, rn.z, rn.w};
      if (m0 + 4 < n) {
        jn = __ldg(reinterpret_cast<const int4*>(ix + m0 + 4));
        wn = __ldg(reinterpret_cast<const float4*>(mk + m0 + 4));
        rn = __ldg(reinterpret_cast<const float4*>(vl + m0 + 4));
      }
#pragma unroll
      for (int q0 = 0; q0 < 4; q0 += G) {
        int j[G];
        float w[G], r[G];
        bool ok[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          j[q] = js[q0 + q];
          w[q] = ws[q0 + q];
          r[q] = rs[q0 + q];
          ok[q] = m0 + q0 + q < n;
        }
        add_slots<K, G, T>(ob, j, w, r, ok, lam, eta);
      }
    }
  } else {
    for (int m0 = 0; m0 < n; m0 += G) {
      int j[G];
      float w[G], r[G];
      bool ok[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        ok[q] = m0 + q < n;
        j[q] = ok[q] ? __ldg(ix + m0 + q) : 0;
        w[q] = ok[q] ? __ldg(mk + m0 + q) : 0.f;
        r[q] = ok[q] ? __ldg(vl + m0 + q) : 0.f;
      }
      add_slots<K, G, T>(ob, j, w, r, ok, lam, eta);
    }
  }
}

// ---------------------------------------------------------------------------
// One warp per row (16 < K <= 32)
// ---------------------------------------------------------------------------

// One warp accumulates one row's
//     lam[k] = sum_m w_m v_m[k] v_m[l],   eta = sum_m w_m r_m v_m[l]
// over the row's slots m < live, with v_m = other[idx[m]] gathered here
// and l = lane % KP the column the lane owns (K <= KP <= 32).
//
// The warp splits into SUB = 32 / KP sub-slots: lane = s * KP + l works on
// slot base + s, so K = 10 keeps 20 of 32 lanes busy instead of 10. Slot
// indices, values and masks are read 32 at a time, one coalesced load,
// and handed to the sub-slots by shuffle; v_m[k] is broadcast by shuffle
// from lane s * KP + k. On return every lane holds the full sums of its
// column (the sub-slots are folded with xor shuffles).
//
// Slots >= live are never read: CSR padding fills a row from the left,
// so they are the all-padding tail that the TPU kernel skips through
// tile_occupancy. Masked slots below live are multiplied by zero.
template <int KP, typename T>
__device__ __forceinline__ void bmf_warp_accum_row(
    const int32_t* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ mask, int live, const T* __restrict__ other,
    int K, int lane, float (&lam)[KP], float& eta) {
  constexpr int SUB = 32 / KP;
  const int s = lane / KP;
  const int l = lane % KP;
#pragma unroll
  for (int k = 0; k < KP; ++k) lam[k] = 0.f;
  eta = 0.f;
  for (int c0 = 0; c0 < live; c0 += 32) {
    const int m = c0 + lane;
    int my_j = 0;
    float my_w = 0.f, my_r = 0.f;
    if (m < live) {
      my_j = idx[m];
      my_w = mask[m];
      my_r = val[m];
    }
    const int n_in = min(32, live - c0);
    for (int t = 0; t < n_in; t += SUB) {
      const int src = t + s;
      const int j = __shfl_sync(BMF_FULL_MASK, my_j, src);
      const float w = __shfl_sync(BMF_FULL_MASK, my_w, src);
      const float r = __shfl_sync(BMF_FULL_MASK, my_r, src);
      float v = 0.f;
      if (l < K && src < n_in) v = bmf_to_f32(other[(int64_t)j * K + l]);
      const float wv = w * v;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const float vk = __shfl_sync(BMF_FULL_MASK, v, s * KP + k);
        lam[k] = fmaf(wv, vk, lam[k]);
      }
      eta = fmaf(w * r, v, eta);
    }
  }
#pragma unroll
  for (int off = KP; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < KP; ++k)
      lam[k] += __shfl_xor_sync(BMF_FULL_MASK, lam[k], off);
    eta += __shfl_xor_sync(BMF_FULL_MASK, eta, off);
  }
}
