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
// each) and their gathered K-value rows, the K x K prior precision and two
// K-vectors, and writes K floats; the O(K^3) factorization is ~0.6k flops
// at K = 10 against ~0.9 KB of traffic.
//
// K <= 16: one thread owns one row (sweep_row_kernel, one instantiation
// per K). The first design put one warp on a row and one lane on each
// column of Lam: at K = 10 most lanes idled, every pair of slots cost 19
// shuffles, and the Cholesky and the solves were a chain of dependent
// shuffles and divisions, ~450 shuffles a row (4.0-4.3 ms at the
// MovieLens-20M phase-c bucket against a 0.105 ms bound). Now:
//   - the thread keeps Lam's lower triangle (K(K+1)/2 floats, 55 at
//     K = 10) and eta in registers and adds each live slot's factor row,
//     loaded whole in the widest aligned loads (a 40-byte f32 row at
//     K = 10 is five 8-byte loads); the slots' idx/val/mask come four at
//     a time in 16-byte loads when M % 4 == 0, the next four in flight
//     while this four's rows are gathered and added, in slot order
//     (bmf_common.cuh's bmf_row_accum, which B1 shares). Two
//     alternatives measured slower at the bucket (PERF.md): reading each
//     row as the 16-byte aligned chunks that hold it (three loads and
//     selects; 0.62 against 0.48 ms in f32), and staging a warp's 32 rows
//     x 16 slots of idx/val/mask in shared memory by coalesced loads
//     (0.72 ms), which runs every row to its warp's longest;
//   - the right-looking Cholesky, the forward solve L y = b and one
//     backward solve L^T u = y + z (the reference's two backward systems,
//     mean and noise, are linear in their right sides, so they are one)
//     run inside the thread: one sqrtf and one correctly rounded
//     reciprocal per column, every other step a multiply or an fma, and
//     no shuffle or division anywhere in the chain;
//   - neighbouring rows have near-equal live lengths (core/partition.py
//     sorts each stripe's rows by descending rating count), so a warp of
//     32 rows loses little to divergence; a warp of unsorted rows is
//     correct, only slower.
// 16 < K <= 32: one warp per row (sweep_warp_kernel), the first design:
// lane l owns column l of Lam (bmf_common.cuh's bmf_warp_accum_row) and
// the Cholesky broadcasts each column by shuffle. A thread cannot
// hold Lam's 528 floats at K = 32 in registers.
#include <utility>

#include "bmf_common.cuh"

namespace {

template <typename T>
struct SweepArgs {
  const int32_t* idx;
  const float* val;
  const float* mask;
  const int32_t* live;
  const T* other;
  const float* prior_eta;
  const float* prior_lam;
  const float* z;
  float* u;
  int64_t rows;
  int N, M, D, K;
  float tau, jitter;
  int vec4;   // M % 4 == 0 and the planes 16-byte aligned
};

// ---------------------------------------------------------------------------
// K <= 16: one thread per row
// ---------------------------------------------------------------------------

// 8 warps a block: at the bucket it ran 0.35 ms against 0.50 with 128
// threads (three blocks, 12 warps an SM) and 0.49 with 512 (PERF.md); the
// lanes' strided slot and prior reads live on L1 reuse, which fewer rows
// in flight per SM keep. K = 16's 254 registers still fit 256 threads.
constexpr int kRowThreads = 256;
constexpr int kRowK = 16;

template <int K, typename T>
__global__ void __launch_bounds__(kRowThreads)
sweep_row_kernel(const SweepArgs<T> a) {
  constexpr int KT = K * (K + 1) / 2;
  const int64_t row = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= a.rows) return;
  const T* ob = a.other + (row / a.N) * (int64_t)a.D * K;
  const int32_t* ix = a.idx + row * a.M;
  const float* vl = a.val + row * a.M;
  const float* mk = a.mask + row * a.M;
  const int n = a.live[row];

  float lam[KT], eta[K];
  bmf_row_accum<K, T>(ob, ix, vl, mk, n, a.vec4, lam, eta);

  // A = tau Lam + prior + jitter I (lower triangle), b = tau eta + prior
  const float* PL = a.prior_lam + row * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int c = 0; c <= i; ++c) {
      float x = fmaf(a.tau, lam[tri(i, c)], __ldg(PL + i * K + c));
      if (c == i) x += a.jitter;
      lam[tri(i, c)] = x;
    }
  }
  float x[K], inv[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    x[i] = fmaf(a.tau, eta[i], __ldg(a.prior_eta + row * K + i));

  // right-looking Cholesky in place: lam[tri(i, c)] = L[i][c] for c < i
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float rc = __frcp_rn(sqrtf(lam[tri(c, c)]));
    inv[c] = rc;
#pragma unroll
    for (int i = c + 1; i < K; ++i) lam[tri(i, c)] *= rc;
#pragma unroll
    for (int i = c + 1; i < K; ++i)
#pragma unroll
      for (int q = c + 1; q <= i; ++q)
        lam[tri(i, q)] = fmaf(-lam[tri(i, c)], lam[tri(q, c)], lam[tri(i, q)]);
  }
  // forward: y = L^-1 b
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float acc = x[i];
#pragma unroll
    for (int c = 0; c < i; ++c) acc = fmaf(-lam[tri(i, c)], x[c], acc);
    x[i] = acc * inv[i];
  }
  // backward: u = L^-T (y + z) = A^-1 b + L^-T z
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] += __ldg(a.z + row * K + i);
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float acc = x[i];
#pragma unroll
    for (int c = i + 1; c < K; ++c) acc = fmaf(-lam[tri(c, i)], x[c], acc);
    x[i] = acc * inv[i];
  }
#pragma unroll
  for (int i = 0; i < K; ++i) a.u[row * K + i] = x[i];
}

template <int K, typename T>
void launch_rows(const SweepArgs<T>& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.rows + kRowThreads - 1) / kRowThreads));
  sweep_row_kernel<K, T><<<grid, kRowThreads, 0, st>>>(a);
}

template <typename T, int... Ks>
void dispatch_rows(const SweepArgs<T>& a, cudaStream_t st,
                   std::integer_sequence<int, Ks...>) {
  (void)((a.K == Ks + 1 ? (launch_rows<Ks + 1, T>(a, st), true) : false) ||
         ...);
}

// ---------------------------------------------------------------------------
// 16 < K <= 32: one warp per row, lane l owns column l of Lam
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 8;

// The Cholesky is right-looking over the columns held in registers: step j
// broadcasts column j of L from lane j by shuffle, and every lane picks
// L[l][j] out of that broadcast, so each lane ends with both its column
// and its row of L. The forward solve runs on the rows, the two backward
// solves (mean and noise) on the columns, one shuffle per step each.
// There is no lane padding: lanes >= K never feed a shuffle that is read.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sweep_warp_kernel(const SweepArgs<T> a) {
  constexpr int KP = 32;
  const int K = a.K;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // uniform per warp
  const int64_t b = row / a.N;
  float lam[KP];
  float eta;
  bmf_warp_accum_row<KP, T>(a.idx + row * a.M, a.val + row * a.M,
                            a.mask + row * a.M, a.live[row],
                            a.other + b * (int64_t)a.D * K, K, lane, lam,
                            eta);
  const int l = lane;
  const bool col = l < K;
  const float tau = a.tau;

  // c[i] = A[i][l]: column l of the conditional precision
  const float* PL = a.prior_lam + row * K * K;
  float c[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    float v = 0.f;
    if (i < K && col)
      v = tau * lam[i] + PL[i * K + l] + (i == l ? a.jitter : 0.f);
    c[i] = v;
  }
  const float bl = col ? tau * eta + a.prior_eta[row * K + l] : 0.f;
  const float zl = col ? a.z[row * K + l] : 0.f;

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
  if (lane < K) a.u[row * K + lane] = um + uz;
}

template <typename T>
cudaError_t launch(const SweepArgs<T>& a, cudaStream_t st) {
  // the vector loads of the gathered rows need the factor 16-byte aligned
  if (reinterpret_cast<uintptr_t>(a.other) % 16)
    return cudaErrorMisalignedAddress;
  if (a.K <= kRowK) {
    dispatch_rows<T>(a, st, std::make_integer_sequence<int, kRowK>{});
  } else {
    const dim3 grid(
        (unsigned)((a.rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    sweep_warp_kernel<T><<<grid, 32 * kWarpsPerBlock, 0, st>>>(a);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// idx/val/mask: (B, N, M); live: (B, N) int32; other: (B, D, K) f32 or
// bf16, 16-byte aligned; prior_eta/z/u: (B, N, K) f32; prior_lam:
// (B, N, K, K) f32. Returns a cudaError_t.
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
  const int vec4 = M % 4 == 0 && aligned16(idx) && aligned16(val) &&
                   aligned16(mask);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vl = static_cast<const float*>(val);
  const float* mk = static_cast<const float*>(mask);
  const int32_t* lv = static_cast<const int32_t*>(live);
  const float* pe = static_cast<const float*>(prior_eta);
  const float* pl = static_cast<const float*>(prior_lam);
  const float* zz = static_cast<const float*>(z);
  float* uo = static_cast<float*>(u);
  if (other_bf16)
    return (int)launch(SweepArgs<__nv_bfloat16>{
        ix, vl, mk, lv, static_cast<const __nv_bfloat16*>(other), pe, pl, zz,
        uo, rows, N, M, D, K, tau, jitter, vec4}, st);
  return (int)launch(SweepArgs<float>{
      ix, vl, mk, lv, static_cast<const float*>(other), pe, pl, zz, uo, rows,
      N, M, D, K, tau, jitter, vec4}, st);
}
