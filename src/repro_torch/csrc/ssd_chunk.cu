// L4: the Mamba2 SSD scan over a whole sequence, forward (prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/kernel.py: ssd_chunk_padded (body _kernel)
// and the lax.scan over chunks of its wrapper ops.ssd_scan. Per (batch b,
// head h), with a_t < 0 the log decay, xdt_t (P) the input already scaled
// by dt, B_t and C_t (N) shared by all heads, and S (P, N) the state:
//   S_t = exp(a_t) S_{t-1} + xdt_t B_t^T,   y_t = S_t C_t.
// Chunk by chunk, with L_t = sum_{s <= t} a_s inside the chunk:
//   y_t = exp(L_t) (S C_t) + sum_{j <= t} (C_t . B_j) exp(L_t - L_j) xdt_j
//   S'  = exp(L_last) S + sum_j exp(L_last - L_j) xdt_j B_j^T
// Every exponent is <= 0 (exp(L_t - L_j) is formed from the difference,
// never as exp(L_t) / exp(L_j)), so no decay underflows a term that
// matters and nothing overflows. f32 in, f32 out.
//
// Bound on Hopper: operations. At zamba2's prefill shape (B = 8, S = 4096,
// H = 112, P = N = 64) one call moves 1.94 GB (xdt and y dominate) and
// does ~75 GFLOP in f32 (the two triangles, S C and the state update);
// the kernel multiplies on the CUDA cores, as the TPU kernel does in f32.
// Design:
//   - the TPU's sequential lax.scan over 128-step chunks becomes a loop
//     inside one block per (b, h), with the (P, N) state in shared memory:
//     one launch per layer, 896 blocks at B = 8, H = 112.
//   - the block's chunk is 64 steps, not 128: on the CUDA cores the
//     intra-chunk triangle costs ~T per step, so T = 64 does ~25% fewer
//     operations than T = 128 and halves the shared memory (88 KB at
//     P = N = 64, two blocks per SM). The result is the same recurrence;
//     only rounding differs.
//   - causal structure is loop bounds: thread (ty, tx) of 16 x 16 owns
//     rows t = ty + 16 i and columns tx + 16 k, and only the blocks with
//     k <= i of the (t, j) triangle are formed or read; the diagonal
//     blocks zero j > t.
//   - C B^T is recomputed by each head although B and C are shared by
//     all heads (B and C are read from L2 after the first head); forming
//     it once per (b, chunk) for all heads is later work, as are wgmma
//     and TMA.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // steps per chunk in the block
constexpr int kThreads = 256;   // 16 x 16
constexpr unsigned kFull = 0xffffffffu;
static_assert(kT == 64, "the cumulative sum takes 2 steps per lane");

template <int P, int N>
struct Layout {                  // shared memory, in floats
  static constexpr int LDX = P + 4;
  static constexpr int LDN = N + 4;
  static constexpr int LDM = kT + 4;
  static constexpr int x = 0;                  // kT x LDX   xdt rows
  static constexpr int b = x + kT * LDX;       // kT x LDN   B rows
  static constexpr int c = b + kT * LDN;       // kT x LDN   C rows
  static constexpr int s = c + kT * LDN;       // P x LDN    state
  static constexpr int m = s + P * LDN;        // kT x LDM   (C.B) e^{L_t-L_j}
  static constexpr int L = m + kT * LDM;       // kT         L_t
  static constexpr int eL = L + kT;            // kT         exp(L_t)
  static constexpr int w = eL + kT;            // kT         exp(L_last - L_t)
  static constexpr int floats = w + kT;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [0, kT) of a (rows, stride) f32 matrix starting at src into shared
// memory with leading dimension LD; W floats per row, W % 4 == 0
template <int W, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t stride) {
  constexpr int V = W / 4;
  for (int i = threadIdx.x; i < kT * V; i += kThreads) {
    const int r = i / V;
    const int col = (i % V) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + col) =
        *reinterpret_cast<const float4*>(src + r * stride + col);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s1, int S, int H) {
  using Lay = Layout<P, N>;
  constexpr int LDX = Lay::LDX, LDN = Lay::LDN, LDM = Lay::LDM;
  constexpr int KP = P / 16;   // p columns (y) or p rows (state) a thread
  constexpr int KN = N / 16;   // n columns of the state a thread owns
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + Lay::x;
  float* bs = sm + Lay::b;
  float* cs = sm + Lay::c;
  float* ss = sm + Lay::s;
  float* ms = sm + Lay::m;
  float* Ls = sm + Lay::L;
  float* eLs = sm + Lay::eL;
  float* ws = sm + Lay::w;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t x_stride = (int64_t)H * P;
  const int64_t bh = (int64_t)b * H + h;

  for (int i = tid; i < P * N / 4; i += kThreads) {
    const int p = i / (N / 4);
    const int n = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(ss + p * LDN + n) =
        *reinterpret_cast<const float4*>(s0 + (bh * P + p) * N + n);
  }

  for (int c0 = 0; c0 < S; c0 += kT) {
    __syncthreads();  // the previous chunk's reads of x, B and w are done
    const int64_t row0 = (int64_t)b * S + c0;
    stage<P, LDX>(xs, xdt + (row0 * H + h) * P, x_stride);
    stage<N, LDN>(bs, Bm + row0 * N, N);
    stage<N, LDN>(cs, Cm + row0 * N, N);
    if (tid < 32) {
      // inclusive scan of the chunk's 64 log decays, two per lane
      float v0 = a[(row0 + tid) * H + h];
      float v1 = a[(row0 + tid + 32) * H + h];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u0 = __shfl_up_sync(kFull, v0, off);
        const float u1 = __shfl_up_sync(kFull, v1, off);
        if (tid >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(kFull, v0, 31);
      const float last = __shfl_sync(kFull, v1, 31);
      Ls[tid] = v0;
      Ls[tid + 32] = v1;
      eLs[tid] = expf(v0);
      eLs[tid + 32] = expf(v1);
      ws[tid] = expf(last - v0);
      ws[tid + 32] = expf(last - v1);
    }
    __syncthreads();

    // M[t][j] = (C_t . B_j) exp(L_t - L_j) on the blocks k <= i
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[i][k] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * LDN + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          bv[k] = *reinterpret_cast<const float4*>(bs + (tx + 16 * k) * LDN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k <= i; ++k) g[i][k] = dot4(cv[i], bv[k], g[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int k = 0; k <= i; ++k) {
          const int j = tx + 16 * k;
          ms[t * LDM + j] =
              (k < i || j <= t) ? g[i][k] * expf(Ls[t] - Ls[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = exp(L_t) (S C_t)[p] + sum_{j <= t} M[t][j] x[j][p]
    {
      float inter[4][KP], intra[4][KP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < KP; ++k) inter[i][k] = intra[i][k] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[KP];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * LDN + n);
#pragma unroll
        for (int k = 0; k < KP; ++k)
          sv[k] = *reinterpret_cast<const float4*>(ss + (tx + 16 * k) * LDN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < KP; ++k)
            inter[i][k] = dot4(cv[i], sv[k], inter[i][k]);
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
#pragma unroll 4
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * jb + jj;
          float xv[KP];
#pragma unroll
          for (int k = 0; k < KP; ++k) xv[k] = xs[j * LDX + tx + 16 * k];
#pragma unroll
          for (int i = jb; i < 4; ++i) {
            const float mv = ms[(ty + 16 * i) * LDM + j];
#pragma unroll
            for (int k = 0; k < KP; ++k)
              intra[i][k] = fmaf(mv, xv[k], intra[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        float* yrow = y + ((row0 + t) * H + h) * P;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          yrow[tx + 16 * k] = fmaf(eLs[t], inter[i][k], intra[i][k]);
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[p][n] = exp(L_last) S[p][n] + sum_j w_j x[j][p] B[j][n]
    {
      float acc[KP][KN];
#pragma unroll
      for (int i = 0; i < KP; ++i)
#pragma unroll
        for (int k = 0; k < KN; ++k) acc[i][k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        const float wj = ws[j];
        float xv[KP], bv[KN];
#pragma unroll
        for (int i = 0; i < KP; ++i) xv[i] = xs[j * LDX + ty + 16 * i] * wj;
#pragma unroll
        for (int k = 0; k < KN; ++k) bv[k] = bs[j * LDN + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < KP; ++i)
#pragma unroll
          for (int k = 0; k < KN; ++k) acc[i][k] = fmaf(xv[i], bv[k], acc[i][k]);
      }
      const float e_last = eLs[kT - 1];
#pragma unroll
      for (int i = 0; i < KP; ++i)
#pragma unroll
        for (int k = 0; k < KN; ++k) {
          float* sp = ss + (ty + 16 * i) * LDN + tx + 16 * k;
          *sp = fmaf(e_last, *sp, acc[i][k]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N / 4; i += kThreads) {
    const int p = i / (N / 4);
    const int n = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(s1 + (bh * P + p) * N + n) =
        *reinterpret_cast<const float4*>(ss + p * LDN + n);
  }
}

template <int P, int N>
cudaError_t launch(const float* xdt, const float* a, const float* Bm,
                   const float* Cm, const float* s0, float* y, float* s1,
                   int Bb, int S, int H, cudaStream_t st) {
  auto kern = ssd_scan_kernel<P, N>;
  constexpr int bytes = (int)sizeof(float) * Layout<P, N>::floats;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, Bb), kThreads, bytes, st>>>(xdt, a, Bm, Cm, s0, y, s1, S,
                                              H);
  return cudaGetLastError();
}

}  // namespace

// xdt: (Bb, S, H, P); a: (Bb, S, H); B, C: (Bb, S, N); s0: (Bb, H, P, N);
// y: (Bb, S, H, P); s1: (Bb, H, P, N), which may be s0 itself (each block
// reads its own (P, N) slice before it writes it). All f32, contiguous;
// S % 64 == 0; (P, N) in {(32, 16), (64, 64)}. Returns a cudaError_t.
extern "C" int ssd_chunk_launch(const void* xdt, const void* a,
                                const void* Bm, const void* Cm,
                                const void* s0, void* y, void* s1, int Bb,
                                int S, int H, int P, int N, void* stream) {
  if (Bb < 0 || S < 0 || S % kT != 0 || H < 1 || H > 65535 || Bb > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bb == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(xdt);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float* s0p = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* s1p = static_cast<float*>(s1);
  if (P == 32 && N == 16)
    return (int)launch<32, 16>(xp, ap, bp, cp, s0p, yp, s1p, Bb, S, H, st);
  if (P == 64 && N == 64)
    return (int)launch<64, 64>(xp, ap, bp, cp, s0p, yp, s1p, Bb, S, H, st);
  return (int)cudaErrorInvalidValue;
}
