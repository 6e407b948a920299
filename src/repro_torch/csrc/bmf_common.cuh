// Shared device code of the BMF kernels: the warp-level gather and
// accumulate of one padded-CSR row's Gibbs sufficient statistics.
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
