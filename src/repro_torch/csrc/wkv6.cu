// L5: the RWKV6 WKV recurrence over a whole sequence, forward (prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6/kernel.py: wkv_chunk_padded (body _kernel)
// and the lax.scan over chunks of its wrapper ops.wkv6. Per (batch b,
// head h), with r, k, v, logw (N per step; logw < 0 the per-channel log
// decay), the bonus u (N) and the state S (N, N):
//   y_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t,
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T.
// Chunk by chunk, with L_t = sum_{s <= t} logw_s (per channel) inside the
// chunk, L_{t-1} = L_t - logw_t and the mid-chunk shift c = L_last / 2
// (the reference's stabilizer):
//   y_t = (r_t e^{L_{t-1}-c}) . (e^{c} S)
//       + sum_{j < t} [(r_t e^{L_{t-1}-c}) . (k_j e^{c-L_j})] v_j
//       + (r_t . u . k_t) v_t
//   S'  = e^{c} (e^{c} S + sum_j (k_j e^{c-L_j}) v_j^T)
// which is the reference's e^{L_last} S + sum_j (k_j e^{L_last-L_j}) v_j^T.
// Every factor's exponent lies in [c, -c], as in the TPU kernel. f32 in,
// f32 out.
//
// Bound on Hopper: about balanced. At rwkv6's prefill shape (B = 8,
// S = 4096, H = 64, N = 64) one call moves 2.69 GB (r, k, v, logw in and
// y out) and does ~52 GFLOP in f32; the kernel multiplies on the CUDA
// cores, as the TPU kernel does in f32.
// Design:
//   - the TPU's sequential lax.scan over 128-step chunks becomes a loop
//     inside one block per (b, h), with the (N, N) state in shared memory:
//     one launch per layer, 512 blocks at B = 8, H = 64.
//   - the block's chunk is 64 steps, not 128: ~25% fewer operations on
//     the CUDA cores, half the shared memory (89 KB at N = 64, two blocks
//     per SM), and |c| half as large, so the factorised exponents stay
//     exact over twice the reference's range of decay. The result is the
//     same recurrence; only rounding differs.
//   - the per-channel cumulative sum runs in 256 / N segments per channel
//     (16 steps each at N = 64) joined by their partial sums, not as one
//     sequential walk over the chunk.
//   - causal structure is loop bounds: thread (ty, tx) of 16 x 16 owns
//     rows t = ty + 16 i and columns tx + 16 k, and only the blocks with
//     k <= i of the (t, j) triangle are formed or read; the diagonal
//     blocks zero j >= t. wgmma and TMA are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // steps per chunk in the block
constexpr int kThreads = 256;   // 16 x 16
constexpr unsigned kFull = 0xffffffffu;

template <int N>
struct Layout {                  // shared memory, in floats
  static constexpr int LD = N + 4;
  static constexpr int LDA = kT + 4;
  static constexpr int WA = kT * LDA > kT * LD ? kT * LDA : kT * LD;
  static constexpr int r = 0;                  // kT x LD   r, then r e^{L_{t-1}-c}
  static constexpr int k = r + kT * LD;        // kT x LD   k, then k e^{c-L_t}
  static constexpr int v = k + kT * LD;        // kT x LD
  static constexpr int s = v + kT * LD;        // N x LD    state
  static constexpr int a = s + N * LD;         // logw (kT x LD), then A (kT x LDA)
  static constexpr int part = a + WA;          // kThreads  per-segment sums
  static constexpr int bonus = part + kThreads;  // kT
  static constexpr int ec = bonus + kT;        // N         e^{c}
  static constexpr int u = ec + N;             // N
  static constexpr int floats = u + N;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int W, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t stride) {
  constexpr int V = W / 4;
  for (int i = threadIdx.x; i < kT * V; i += kThreads) {
    const int row = i / V;
    const int col = (i % V) * 4;
    *reinterpret_cast<float4*>(dst + row * LD + col) =
        *reinterpret_cast<const float4*>(src + row * stride + col);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s1, int S, int H) {
  using Lay = Layout<N>;
  constexpr int LD = Lay::LD, LDA = Lay::LDA;
  constexpr int KN = N / 16;          // columns (or state rows) per thread
  constexpr int NSEG = kThreads / N;  // cumulative-sum segments per channel
  constexpr int TL = kT / NSEG;       // steps per segment
  static_assert(kThreads % N == 0 && kT % NSEG == 0, "segments");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* rs = sm + Lay::r;
  float* ks = sm + Lay::k;
  float* vs = sm + Lay::v;
  float* ss = sm + Lay::s;
  float* as = sm + Lay::a;   // logw tile, then the A tile
  float* part = sm + Lay::part;
  float* bonus = sm + Lay::bonus;
  float* ec = sm + Lay::ec;
  float* us = sm + Lay::u;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t stride = (int64_t)H * N;
  const int64_t bh = (int64_t)b * H + h;

  for (int i = tid; i < N; i += kThreads) us[i] = u[(int64_t)h * N + i];
  for (int i = tid; i < N * N / 4; i += kThreads) {
    const int n = i / (N / 4);
    const int m = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(ss + n * LD + m) =
        *reinterpret_cast<const float4*>(s0 + (bh * N + n) * N + m);
  }

  for (int c0 = 0; c0 < S; c0 += kT) {
    __syncthreads();  // the previous chunk is done with every tile
    const int64_t off = (((int64_t)b * S + c0) * H + h) * N;
    stage<N, LD>(rs, r + off, stride);
    stage<N, LD>(ks, k + off, stride);
    stage<N, LD>(vs, v + off, stride);
    stage<N, LD>(as, logw + off, stride);
    __syncthreads();

    // the bonus (r_t . u . k_t), one warp per row; the segments' sums of
    // logw, thread (seg, n)
    for (int t = warp; t < kT; t += kThreads / 32) {
      float acc = 0.f;
      for (int n = lane; n < N; n += 32)
        acc = fmaf(rs[t * LD + n] * us[n], ks[t * LD + n], acc);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) bonus[t] = acc;
    }
    const int n_own = tid % N;
    const int seg = tid / N;
    {
      float sum = 0.f;
      for (int t = seg * TL; t < (seg + 1) * TL; ++t) sum += as[t * LD + n_own];
      part[seg * N + n_own] = sum;
    }
    __syncthreads();

    // L per channel; r -> r e^{L_{t-1}-c}, k -> k e^{c-L_t} in place
    {
      float run = 0.f, total = 0.f;
#pragma unroll
      for (int q = 0; q < NSEG; ++q) {
        const float pq = part[q * N + n_own];
        if (q < seg) run += pq;
        total += pq;
      }
      const float c = 0.5f * total;
      if (seg == 0) ec[n_own] = expf(c);
      for (int t = seg * TL; t < (seg + 1) * TL; ++t) {
        const float Lm1 = run;
        run += as[t * LD + n_own];
        rs[t * LD + n_own] *= expf(Lm1 - c);
        ks[t * LD + n_own] *= expf(c - run);
      }
    }
    __syncthreads();

    // A[t][j] = r2_t . k2_j for j < t, on the blocks k <= i; and the state
    // scaled by e^{c} (rows n = ty + 16 i, columns m = tx + 16 k)
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) g[i][q] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 rv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rv[i] = *reinterpret_cast<const float4*>(rs + (ty + 16 * i) * LD + n);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          kv[q] = *reinterpret_cast<const float4*>(ks + (tx + 16 * q) * LD + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q <= i; ++q) g[i][q] = dot4(rv[i], kv[q], g[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int q = 0; q <= i; ++q) {
          const int j = tx + 16 * q;
          as[t * LDA + j] = (q < i || j < t) ? g[i][q] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < KN; ++i) {
        const int n = ty + 16 * i;
        const float e = ec[n];
#pragma unroll
        for (int q = 0; q < KN; ++q) ss[n * LD + tx + 16 * q] *= e;
      }
    }
    __syncthreads();

    // y[t][m] = r2_t . (e^{c} S)[:, m] + sum_{j < t} A[t][j] v[j][m]
    //         + bonus_t v[t][m]
    {
      float acc[4][KN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < KN; ++q) acc[i][q] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 rv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rv[i] = *reinterpret_cast<const float4*>(rs + (ty + 16 * i) * LD + n);
#pragma unroll
        for (int q = 0; q < KN; ++q) {
          const float* sc = ss + n * LD + tx + 16 * q;
          const float4 sv = make_float4(sc[0], sc[LD], sc[2 * LD], sc[3 * LD]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][q] = dot4(rv[i], sv, acc[i][q]);
        }
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
#pragma unroll 4
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float vv[KN];
#pragma unroll
          for (int q = 0; q < KN; ++q) vv[q] = vs[j * LD + tx + 16 * q];
#pragma unroll
          for (int i = jb; i < 4; ++i) {
            const float av = as[(ty + 16 * i) * LDA + j];
#pragma unroll
            for (int q = 0; q < KN; ++q) acc[i][q] = fmaf(av, vv[q], acc[i][q]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float bt = bonus[t];
        float* yrow = y + off + (int64_t)t * stride;
#pragma unroll
        for (int q = 0; q < KN; ++q) {
          const int m = tx + 16 * q;
          yrow[m] = fmaf(bt, vs[t * LD + m], acc[i][q]);
        }
      }
    }
    __syncthreads();  // every read of the scaled state is done

    // S[n][m] = e^{c_n} (S[n][m] + sum_j k2_j[n] v_j[m])
    {
      float acc[KN][KN];
#pragma unroll
      for (int i = 0; i < KN; ++i)
#pragma unroll
        for (int q = 0; q < KN; ++q) acc[i][q] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float kv[KN], vv[KN];
#pragma unroll
        for (int i = 0; i < KN; ++i) kv[i] = ks[j * LD + ty + 16 * i];
#pragma unroll
        for (int q = 0; q < KN; ++q) vv[q] = vs[j * LD + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < KN; ++i)
#pragma unroll
          for (int q = 0; q < KN; ++q) acc[i][q] = fmaf(kv[i], vv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < KN; ++i) {
        const int n = ty + 16 * i;
        const float e = ec[n];
#pragma unroll
        for (int q = 0; q < KN; ++q) {
          float* sp = ss + n * LD + tx + 16 * q;
          *sp = e * (*sp + acc[i][q]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * N / 4; i += kThreads) {
    const int n = i / (N / 4);
    const int m = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(s1 + (bh * N + n) * N + m) =
        *reinterpret_cast<const float4*>(ss + n * LD + m);
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s0,
                   float* y, float* s1, int B, int S, int H,
                   cudaStream_t st) {
  auto kern = wkv6_kernel<N>;
  constexpr int bytes = (int)sizeof(float) * Layout<N>::floats;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), kThreads, bytes, st>>>(r, k, v, logw, u, s0, y, s1, S,
                                             H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, logw: (B, S, H, N); u: (H, N); s0: (B, H, N, N); y: (B, S, H,
// N); s1: (B, H, N, N), which may be s0 itself (each block reads its own
// (N, N) slice before it writes it). All f32, contiguous; S % 64 == 0;
// N in {32, 64}. Returns a cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* y, void* s1, int B, int S, int H, int N,
                           void* stream) {
  if (B < 0 || S < 0 || S % kT != 0 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* s1p = static_cast<float*>(s1);
  if (N == 32)
    return (int)launch<32>(rp, kp, vp, wp, up, s0p, yp, s1p, B, S, H, st);
  if (N == 64)
    return (int)launch<64>(rp, kp, vp, wp, up, s0p, yp, s1p, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}
