// B1: per-row Gibbs sufficient statistics with the gather inside the kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bmf_precision/kernel.py: precision_accum_fused_padded
//   (body _fused_kernel).
// For every row n of a stacked batch of padded-CSR planes
//     Lam[n] = tau * sum_m w_m v_m v_m^T,   eta[n] = tau * sum_m w_m r_m v_m
// with v_m = other[b][idx[n, m]] gathered here: no (N, M, K) tensor exists.
//
// Bound on Hopper: bytes. Each live slot costs 12 bytes of CSR planes plus
// a K-float gathered row, for 2 K^2 flops; at K = 10 that is ~0.4 flop per
// byte, far below the card's ~20 fp32 flops per byte. `other` (D x K) is
// small enough to stay in the 50 MB L2, so the gathers mostly hit L2.
// Design: loads are coalesced (32 slot indices per warp load, K
// consecutive floats per gathered row), the all-padding tail of each row is
// never read (per-row live lengths take the place of tile_occupancy), and
// Lam/eta are written once. For K <= 32 one warp owns a row (lane owns a
// column, sub-slots keep small-K lanes busy); for 32 < K <= 128 a block of
// 256 threads owns a row and stages 16 gathered rows at a time in shared
// memory.
#include "bmf_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBigThreads = 256;
constexpr int kBigTM = 16;     // gathered rows staged per tile (K > 32)
constexpr int kBigAcc = 64;    // accumulators per thread: 128 rows / 2 groups

template <int KP, typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
precision_warp_kernel(const int32_t* __restrict__ idx,
                      const float* __restrict__ val,
                      const float* __restrict__ mask,
                      const int32_t* __restrict__ live,
                      const T* __restrict__ other, float* __restrict__ lam_out,
                      float* __restrict__ eta_out, int64_t rows, int N, int M,
                      int D, int K, float tau) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const int64_t b = row / N;
  float lam[KP];
  float eta;
  bmf_warp_accum_row<KP, T>(idx + row * M, val + row * M, mask + row * M,
                            live[row], other + b * (int64_t)D * K, K, lane,
                            lam, eta);
  if (lane < K) {
    float* L = lam_out + row * K * K;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K) L[k * K + lane] = tau * lam[k];
    eta_out[row * K + lane] = tau * eta;
  }
}

// 32 < K <= 128: thread t owns column l = t % 128 and the rows k = g, g+2,
// ... with g = t / 128; a warp shares g, so the shared-memory reads of
// v[k] are broadcasts.
template <typename T>
__global__ void __launch_bounds__(kBigThreads)
precision_block_kernel(const int32_t* __restrict__ idx,
                       const float* __restrict__ val,
                       const float* __restrict__ mask,
                       const int32_t* __restrict__ live,
                       const T* __restrict__ other, float* __restrict__ lam_out,
                       float* __restrict__ eta_out, int N, int M, int D, int K,
                       float tau) {
  extern __shared__ float smem[];
  float* sv = smem;                 // kBigTM x K gathered rows
  float* sw = smem + kBigTM * K;    // kBigTM masks
  float* sr = sw + kBigTM;          // kBigTM values
  const int64_t row = blockIdx.x;
  const int64_t b = row / N;
  const int t = threadIdx.x;
  const int l = t % 128;
  const int g = t / 128;
  const T* oth = other + b * (int64_t)D * K;
  const int32_t* ix = idx + row * M;
  const int n_live = live[row];
  float acc[kBigAcc];
#pragma unroll
  for (int i = 0; i < kBigAcc; ++i) acc[i] = 0.f;
  float eacc = 0.f;
  for (int m0 = 0; m0 < n_live; m0 += kBigTM) {
    const int n_in = min(kBigTM, n_live - m0);
    for (int e = t; e < kBigTM * K; e += kBigThreads) {
      const int s = e / K;
      float v = 0.f;
      if (s < n_in) v = bmf_to_f32(oth[(int64_t)ix[m0 + s] * K + e % K]);
      sv[e] = v;
    }
    if (t < kBigTM) {
      sw[t] = t < n_in ? mask[row * M + m0 + t] : 0.f;
      sr[t] = t < n_in ? val[row * M + m0 + t] : 0.f;
    }
    __syncthreads();
    if (l < K) {
      for (int s = 0; s < n_in; ++s) {
        const float vl = sv[s * K + l];
        const float wv = sw[s] * vl;
#pragma unroll
        for (int i = 0; i < kBigAcc; ++i) {
          const int k = g + 2 * i;
          if (k < K) acc[i] = fmaf(wv, sv[s * K + k], acc[i]);
        }
        if (g == 0) eacc = fmaf(sw[s] * sr[s], vl, eacc);
      }
    }
    __syncthreads();
  }
  if (l < K) {
    float* L = lam_out + row * K * K;
#pragma unroll
    for (int i = 0; i < kBigAcc; ++i) {
      const int k = g + 2 * i;
      if (k < K) L[k * K + l] = tau * acc[i];
    }
    if (g == 0) eta_out[row * K + l] = tau * eacc;
  }
}

template <typename T>
void launch(const void* idx, const void* val, const void* mask,
            const void* live, const void* other, void* lam, void* eta,
            int64_t rows, int N, int M, int D, int K, float tau,
            cudaStream_t st) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vl = static_cast<const float*>(val);
  const float* mk = static_cast<const float*>(mask);
  const int32_t* lv = static_cast<const int32_t*>(live);
  const T* ot = static_cast<const T*>(other);
  float* lo = static_cast<float*>(lam);
  float* eo = static_cast<float*>(eta);
  if (K <= 32) {
    const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    const dim3 block(32 * kWarpsPerBlock);
    if (K <= 8)
      precision_warp_kernel<8, T><<<grid, block, 0, st>>>(
          ix, vl, mk, lv, ot, lo, eo, rows, N, M, D, K, tau);
    else if (K <= 16)
      precision_warp_kernel<16, T><<<grid, block, 0, st>>>(
          ix, vl, mk, lv, ot, lo, eo, rows, N, M, D, K, tau);
    else
      precision_warp_kernel<32, T><<<grid, block, 0, st>>>(
          ix, vl, mk, lv, ot, lo, eo, rows, N, M, D, K, tau);
  } else {
    const size_t smem = (size_t)(kBigTM * K + 2 * kBigTM) * sizeof(float);
    precision_block_kernel<T><<<(unsigned)rows, kBigThreads, smem, st>>>(
        ix, vl, mk, lv, ot, lo, eo, N, M, D, K, tau);
  }
}

}  // namespace

// idx/val/mask: (B, N, M); live: (B, N) int32; other: (B, D, K) f32 or
// bf16; lam: (B, N, K, K) f32; eta: (B, N, K) f32. Returns a cudaError_t.
extern "C" int bmf_precision_launch(const void* idx, const void* val,
                                    const void* mask, const void* live,
                                    const void* other, int other_bf16,
                                    void* lam, void* eta, long long B, int N,
                                    int M, int D, int K, float tau,
                                    void* stream) {
  if (K < 1 || K > 128 || N < 0 || M < 1 || D < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * N;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (other_bf16)
    launch<__nv_bfloat16>(idx, val, mask, live, other, lam, eta, rows, N, M,
                          D, K, tau, st);
  else
    launch<float>(idx, val, mask, live, other, lam, eta, rows, N, M, D, K,
                  tau, st);
  return (int)cudaGetLastError();
}
