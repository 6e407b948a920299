// B2: one-pass fused Gibbs factor step, K <= 32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bmf_sweep/kernel.py: fused_sweep_padded
//   (body _sweep_kernel; tile math accum_tile, chol_tile, solve_lower_tile,
//   solve_upper_tile, sample_tile).
// Per row n of a stacked batch:
//     A = tau * sum_m w_m v_m v_m^T + prior_lam[n] + jitter * I,  A = L L^T
//     u[n] = A^-1 (tau * sum_m w_m r_m v_m + prior_eta[n]) + L^-T z[n]
// with v_m = other[b][idx[n, m]] gathered here. Only u reaches device
// memory: Lam, eta and L live in registers.
//
// Bound on Hopper: bytes. Per row it reads the live CSR slots (12 bytes
// each) and their gathered K-float rows, the K x K prior precision and two
// K-vectors, and writes K floats; the O(K^3) factorization is ~11k flops
// at K = 32 against several KB of traffic. Design: one warp owns one row
// and lane l owns column l of Lam (the accumulate of bmf_common.cuh). The
// Cholesky is right-looking over the columns held in registers: step j
// broadcasts column j of L from lane j by shuffle, and every lane picks
// L[l][j] out of that broadcast, so each lane ends with both its column
// and its row of L. The forward solve runs on the rows, the two backward
// solves (mean and noise) on the columns, one shuffle per step each.
// There is no lane padding: lanes >= K never feed a shuffle that is read.
#include "bmf_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int KP, typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sweep_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ mask, const int32_t* __restrict__ live,
             const T* __restrict__ other, const float* __restrict__ prior_eta,
             const float* __restrict__ prior_lam, const float* __restrict__ z,
             float* __restrict__ u_out, int64_t rows, int N, int M, int D,
             int K, float tau, float jitter) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const int64_t b = row / N;
  float lam[KP];
  float eta;
  bmf_warp_accum_row<KP, T>(idx + row * M, val + row * M, mask + row * M,
                            live[row], other + b * (int64_t)D * K, K, lane,
                            lam, eta);
  const int l = lane % KP;
  const bool col = l < K;

  // c[i] = A[i][l]: column l of the conditional precision
  const float* PL = prior_lam + row * K * K;
  float c[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    float a = 0.f;
    if (i < K && col) a = tau * lam[i] + PL[i * K + l] + (i == l ? jitter : 0.f);
    c[i] = a;
  }
  const float bl = col ? tau * eta + prior_eta[row * K + l] : 0.f;
  const float zl = col ? z[row * K + l] : 0.f;

  // Cholesky A = L L^T. Afterwards c[i] = L[i][l] for i >= l and
  // r[j] = L[l][j] for j <= l.
  float r[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    r[j] = 0.f;
    if (j < K) {
      const float d = sqrtf(__shfl_sync(BMF_FULL_MASK, c[j], j));
      float mine = d;
#pragma unroll
      for (int i = j + 1; i < KP; ++i) {
        if (i < K) {
          const float lij = __shfl_sync(BMF_FULL_MASK, c[i], j) / d;
          if (l == i) mine = lij;
          if (l > j && l <= i) c[i] = fmaf(-lij, mine, c[i]);
        }
      }
      if (l >= j) r[j] = mine;
      if (l == j) {
        c[j] = d;
#pragma unroll
        for (int i = j + 1; i < KP; ++i) c[i] = c[i] / d;
      }
    }
  }

  // forward: y = L^-1 b, on the rows of L
  float acc = 0.f, y = 0.f;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j < K) {
      const float yj = __shfl_sync(BMF_FULL_MASK, (bl - acc) / r[j], j);
      if (l == j) y = yj;
      if (l > j) acc = fmaf(r[j], yj, acc);
    }
  }

  // backward: mu = L^-T y and delta = L^-T z, on the columns of L
  float am = 0.f, az = 0.f, um = 0.f, uz = 0.f;
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    const int j = KP - 1 - t;
    if (j < K) {
      const float xm = __shfl_sync(BMF_FULL_MASK, (y - am) / c[j], j);
      const float xz = __shfl_sync(BMF_FULL_MASK, (zl - az) / c[j], j);
      if (l == j) {
        um = xm;
        uz = xz;
      }
      if (l < j) {
        am = fmaf(c[j], xm, am);
        az = fmaf(c[j], xz, az);
      }
    }
  }
  if (lane < K) u_out[row * K + lane] = um + uz;
}

template <typename T>
void launch(const void* idx, const void* val, const void* mask,
            const void* live, const void* other, const void* prior_eta,
            const void* prior_lam, const void* z, void* u, int64_t rows,
            int N, int M, int D, int K, float tau, float jitter,
            cudaStream_t st) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vl = static_cast<const float*>(val);
  const float* mk = static_cast<const float*>(mask);
  const int32_t* lv = static_cast<const int32_t*>(live);
  const T* ot = static_cast<const T*>(other);
  const float* pe = static_cast<const float*>(prior_eta);
  const float* pl = static_cast<const float*>(prior_lam);
  const float* zz = static_cast<const float*>(z);
  float* uo = static_cast<float*>(u);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  if (K <= 8)
    sweep_kernel<8, T><<<grid, block, 0, st>>>(ix, vl, mk, lv, ot, pe, pl, zz,
                                               uo, rows, N, M, D, K, tau,
                                               jitter);
  else if (K <= 16)
    sweep_kernel<16, T><<<grid, block, 0, st>>>(ix, vl, mk, lv, ot, pe, pl,
                                                zz, uo, rows, N, M, D, K, tau,
                                                jitter);
  else
    sweep_kernel<32, T><<<grid, block, 0, st>>>(ix, vl, mk, lv, ot, pe, pl,
                                                zz, uo, rows, N, M, D, K, tau,
                                                jitter);
}

}  // namespace

// idx/val/mask: (B, N, M); live: (B, N) int32; other: (B, D, K) f32 or
// bf16; prior_eta/z/u: (B, N, K) f32; prior_lam: (B, N, K, K) f32.
// Returns a cudaError_t.
extern "C" int bmf_sweep_launch(const void* idx, const void* val,
                                const void* mask, const void* live,
                                const void* other, int other_bf16,
                                const void* prior_eta, const void* prior_lam,
                                const void* z, void* u, long long B, int N,
                                int M, int D, int K, float tau, float jitter,
                                void* stream) {
  if (K < 1 || K > 32 || N < 0 || M < 1 || D < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * N;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (other_bf16)
    launch<__nv_bfloat16>(idx, val, mask, live, other, prior_eta, prior_lam,
                          z, u, rows, N, M, D, K, tau, jitter, st);
  else
    launch<float>(idx, val, mask, live, other, prior_eta, prior_lam, z, u,
                  rows, N, M, D, K, tau, jitter, st);
  return (int)cudaGetLastError();
}
