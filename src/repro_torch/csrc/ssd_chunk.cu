// L4: the Mamba2 SSD scan over a whole sequence, forward (prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/kernel.py: ssd_chunk_padded (body _kernel)
// and the lax.scan over chunks of its wrapper ops.ssd_scan. Per (batch b,
// head h), with a_t < 0 the log decay, xdt_t (P) the input already scaled
// by dt, B_t and C_t (N) shared by all heads, and S (P, N) the state:
//   S_t = exp(a_t) S_{t-1} + xdt_t B_t^T,   y_t = S_t C_t.
// Chunk by chunk, with L_t = sum_{s <= t} a_s inside the chunk:
//   y_t = exp(L_t) (C_t S^T) + sum_{j <= t} (C_t . B_j) exp(L_t - L_j) xdt_j
//   S'  = exp(L_last) S + sum_j exp(L_last - L_j) xdt_j B_j^T
// Every exponent is <= 0 (exp(L_t - L_j) is formed from the difference,
// never as exp(L_t) / exp(L_j)), so no decay underflows a term that
// matters and nothing overflows. f32 in, f32 out.
//
// Bound on Hopper: bytes, once the products are on the tensor cores. At
// zamba2's prefill shape (B = 8, S = 4,096, H = 112, P = N = 64) one call
// moves 1.94 GB (xdt in, y out: 0.579 ms at 3.35 TB/s); the recurrence's
// own 60 GFLOP would take 0.898 ms on the CUDA cores' f32 (the first
// design did ~1.5x that there, 4.2 ms). Design:
//   - the TPU's sequential lax.scan over 128-step chunks becomes a loop
//     over 64-step chunks inside one block of 8 warps per (b, pair of
//     heads). Each head's (P, N) state stays in its warps' mma
//     accumulators for the whole sequence: warp wi owns state rows and y
//     columns 16 wi .. 16 wi + 15, so its accumulator tile is, as it
//     stands, the B operand of the next chunk's C S^T. The (T, T) decay
//     scores never leave the block (the reference kernel's reason to be).
//   - the four products C B^T, M X, C S^T and (w x)^T B run on the tensor
//     cores as mma.sync m16n8k16 with bf16 operands and f32 accumulators.
//     The inputs are f32 and the parity limit is 1e-4 of the largest
//     value, which one bf16 (or TF32) rounding does not hold, so each
//     operand is split as x = hi + lo, both bf16 (round to nearest even),
//     and each product is hi.hi + hi.lo + lo.hi (about 16 bits; the lo.lo
//     term is dropped; mma_split.cuh, shared with L5). bf16 rather than
//     TF32 because the k-16 bf16 mma does twice the work per instruction
//     at the same issue rate, and the kernel is bound by what its warps
//     issue, not by bytes (PERF.md).
//   - C B^T is the same for every head of a batch row: the block forms it
//     once per chunk, on the 20 lower-triangle 16 x 8 tiles only, for its
//     two heads, and each head applies its own mask exp(L_t - L_j) when it
//     forms M's fragments. Two heads per block keeps shared memory at
//     159 KB (one block per SM: 448 blocks at B = 8, H = 112, 3.4 waves).
//   - the next chunk's xdt, B, C and a are in flight (cp.async, two
//     buffers) while this chunk computes; two barriers per chunk.
#include <math.h>

#include "mma_split.cuh"

namespace {

constexpr int kT = 64;              // steps per chunk
constexpr int kHB = 2;              // heads per block
constexpr int kWarpsPerHead = 4;
constexpr int kWarps = kWarpsPerHead * kHB;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kT == 64 && kWarpsPerHead == 4,
              "the scan takes 2 steps per lane; 4 row tiles of 16 steps");

// shared memory, in floats. Every leading dimension is 4 mod 32, which
// keeps the fragment loads free of bank conflicts: pairs of adjacent
// columns (t, n) or (n, j), and pairs of adjacent rows (j, p) or (j, n)
template <int P, int N>
struct Layout {
  static constexpr int LDX = P + 4;    // xdt rows (j, p)
  static constexpr int LDB = N + 4;    // B rows (j, n)
  static constexpr int LDC = N + 4;    // C rows (t, n)
  static constexpr int LDG = kT + 4;   // C B^T (t, j)
  // one buffer of a chunk's inputs
  static constexpr int x = 0;                       // kHB x kT x LDX
  static constexpr int b = x + kHB * kT * LDX;      // kT x LDB
  static constexpr int c = b + kT * LDB;            // kT x LDC
  static constexpr int a = c + kT * LDC;            // kHB x kT
  static constexpr int buf = a + kHB * kT;
  static constexpr int g = 2 * buf;                 // kT x LDG  C B^T
  static constexpr int L = g + kT * LDG;            // kHB x kT  L_t log2(e)
  static constexpr int eL = L + kHB * kT;           // kHB x kT  exp(L_t)
  static constexpr int w = eL + kHB * kT;   // kHB x kT  exp(L_last - L_t)
  static constexpr int floats = w + kHB * kT;
  static_assert(b % 4 == 0 && c % 4 == 0 && a % 4 == 0 && buf % 4 == 0,
                "cp.async destinations are 16-byte aligned");
};

// Warp wi of a head owns state rows and y columns 16 wi .. 16 wi + 15, so
// P / 16 of its 4 warps (all 4 at P = 64) scan; all 8 warps form C B^T.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* s0, float* y, float* s1, int S, int H) {
  using Lay = Layout<P, N>;
  constexpr int LDX = Lay::LDX, LDB = Lay::LDB, LDC = Lay::LDC,
                LDG = Lay::LDG;
  constexpr int NTS = N / 8;   // state column tiles of a warp
  static_assert(P % 16 == 0 && P / 16 <= kWarpsPerHead && N % 16 == 0,
                "shape");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hh = wid / kWarpsPerHead;   // this warp's head in the block
  const int wi = wid % kWarpsPerHead;   // and its place among that head's
  const int h0 = blockIdx.x * kHB;
  const int h = h0 + hh;
  const bool live = h < H;              // an odd H leaves one head idle
  const bool scans = live && wi < P / 16;
  const int b = blockIdx.y;
  float* Gs = sm + Lay::g;
  float* Ls = sm + Lay::L + hh * kT;
  float* eLs = sm + Lay::eL + hh * kT;
  float* ws = sm + Lay::w + hh * kT;

  // this warp's state tile, rows pr0 + g (+ 8), columns 8 j + 2t (+ 1), in
  // mma accumulators for the whole sequence
  const int pr0 = 16 * wi;
  const int64_t bh = (int64_t)b * H + h;
  float st[NTS][4];
#pragma unroll
  for (int j = 0; j < NTS; ++j) {
    float2 lo2 = make_float2(0.f, 0.f), hi2 = lo2;
    if (scans) {
      const float* row = s0 + (bh * P + pr0 + g) * N + 8 * j + 2 * t;
      lo2 = *reinterpret_cast<const float2*>(row);
      hi2 = *reinterpret_cast<const float2*>(row + 8 * N);
    }
    st[j][0] = lo2.x;
    st[j][1] = lo2.y;
    st[j][2] = hi2.x;
    st[j][3] = hi2.y;
  }

  // one chunk's xdt (both heads), B, C and a into buffer `buf`
  auto issue = [&](int c0, int buf) {
    float* base = sm + buf * Lay::buf;
    const int64_t row0 = (int64_t)b * S + c0;
    constexpr int XV = P / 4;
    for (int i = tid; i < kHB * kT * XV; i += kThreads) {
      const int q = i / (kT * XV);
      const int r = (i / XV) % kT;
      const int col = (i % XV) * 4;
      if (h0 + q < H)
        cp_async16(base + Lay::x + (q * kT + r) * LDX + col,
                   xdt + ((row0 + r) * H + h0 + q) * P + col);
    }
    constexpr int NV = N / 4;
    for (int i = tid; i < kT * NV; i += kThreads) {
      const int r = i / NV;
      const int col = (i % NV) * 4;
      cp_async16(base + Lay::b + r * LDB + col, Bm + (row0 + r) * N + col);
      cp_async16(base + Lay::c + r * LDC + col, Cm + (row0 + r) * N + col);
    }
    for (int i = tid; i < kHB * kT; i += kThreads) {
      const int q = i / kT;
      const int r = i % kT;
      if (h0 + q < H)
        cp_async4(base + Lay::a + i, a + (row0 + r) * H + h0 + q);
    }
    cp_async_commit();
  };

  const int n_chunks = S / kT;
  if (n_chunks > 0) issue(0, 0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk ci is in; every read of chunk ci - 1 is done
    if (ci + 1 < n_chunks)
      issue((ci + 1) * kT, buf ^ 1);   // in flight while chunk ci computes
    const float* base = sm + buf * Lay::buf;
    const float* Xs = base + Lay::x + hh * kT * LDX;
    const float* Bs = base + Lay::b;
    const float* Cs = base + Lay::c;

    // the head's log decays in log2 units: L, exp(L), exp(L_last - L)
    if (wi == 0 && live) {
      const float* As = base + Lay::a + hh * kT;
      float v0 = As[lane];
      float v1 = As[lane + 32];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float u0 = __shfl_up_sync(kFull, v0, off);
        const float u1 = __shfl_up_sync(kFull, v1, off);
        if (lane >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(kFull, v0, 31);
      const float last = __shfl_sync(kFull, v1, 31);
      Ls[lane] = v0 * kLog2e;
      Ls[lane + 32] = v1 * kLog2e;
      eLs[lane] = exp2f(v0 * kLog2e);
      eLs[lane + 32] = exp2f(v1 * kLog2e);
      ws[lane] = exp2f((last - v0) * kLog2e);
      ws[lane + 32] = exp2f((last - v1) * kLog2e);
    }

    // C B^T on the 20 16 x 8 tiles (row tile rt, column tile jt <= 2 rt + 1)
    // that touch the lower triangle, once for both heads: warp w takes
    // tiles w, w + 8, w + 16, their k-steps interleaved
    {
      constexpr int kTiles = (kT / 16) * (kT / 16 + 1);
      constexpr int kPer = (kTiles + kWarps - 1) / kWarps;
      int rt[kPer], jt[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = wid + kWarps * u;
        rt[u] = idx < 2 ? 0 : idx < 6 ? 1 : idx < 12 ? 2 : 3;
        jt[u] = idx - rt[u] * (rt[u] + 1);
      }
      float d[kPer][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (wid + kWarps * u >= kTiles) continue;   // warp-uniform
          FragA fa;
          fa.rows(Cs, LDC, 16 * rt[u], k0, g, t);
          FragB fb;
          fb.rows(Bs, LDB, 8 * jt[u], k0, g, t);
          mma3(d[u], fa, fb);
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (wid + kWarps * u >= kTiles) continue;
        float* gr = Gs + (16 * rt[u] + g) * LDG + 8 * jt[u] + 2 * t;
        *reinterpret_cast<float2*>(gr) = make_float2(d[u][0], d[u][1]);
        *reinterpret_cast<float2*>(gr + 8 * LDG) =
            make_float2(d[u][2], d[u][3]);
      }
    }
    __syncthreads();   // C B^T and the decays are in

    if (scans) {
      // y = exp(L_t) (C S^T) + M X on rows 0..63, columns pr0..pr0 + 15
      float acc[4][2][4];
#pragma unroll
      for (int rt = 0; rt < 4; ++rt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;
      // C S^T: the B operand (n, p) is the state tile as it stands
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        const int j = k0 / 8;
        FragB f0, f1;
        f0.set(make_float2(st[j][0], st[j][1]),
               make_float2(st[j + 1][0], st[j + 1][1]));
        f1.set(make_float2(st[j][2], st[j][3]),
               make_float2(st[j + 1][2], st[j + 1][3]));
#pragma unroll
        for (int rt = 0; rt < 4; ++rt) {
          FragA fa;
          fa.rows(Cs, LDC, 16 * rt, k0, g, t);
          mma3(acc[rt][0], fa, f0);
          mma3(acc[rt][1], fa, f1);
        }
      }
#pragma unroll
      for (int rt = 0; rt < 4; ++rt) {
        const float e0 = eLs[16 * rt + g];
        const float e1 = eLs[16 * rt + g + 8];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[rt][j][0] *= e0;
          acc[rt][j][1] *= e0;
          acc[rt][j][2] *= e1;
          acc[rt][j][3] *= e1;
        }
      }
      // M (r, j) = (C B^T)(r, j) exp(L_r - L_j) for j <= r, else 0
#pragma unroll
      for (int k0 = 0; k0 < kT; k0 += 16) {
        FragB fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          fb[j].cols(Xs, LDX, pr0 + 8 * j, k0, g, t);
        const int j0 = k0 + 2 * t;   // this lane's depths j0, +1, +8, +9
        const float Lj[4] = {Ls[j0], Ls[j0 + 1], Ls[j0 + 8], Ls[j0 + 9]};
#pragma unroll
        for (int rt = k0 / 16; rt < 4; ++rt) {
          float2 m[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {   // row + 8 (q & 1), depth + 8 (q >> 1)
            const int r = 16 * rt + g + 8 * (q & 1);
            const int j = j0 + 8 * (q >> 1);
            const float2 gv =
                *reinterpret_cast<const float2*>(Gs + r * LDG + j);
            const float Lr = Ls[r];
            m[q] = make_float2(
                j <= r ? gv.x * exp2f(Lr - Lj[2 * (q >> 1)]) : 0.f,
                j + 1 <= r ? gv.y * exp2f(Lr - Lj[2 * (q >> 1) + 1]) : 0.f);
          }
          FragA fa;
          fa.set(m[0], m[1], m[2], m[3]);
          mma3(acc[rt][0], fa, fb[0]);
          mma3(acc[rt][1], fa, fb[1]);
        }
      }
      const int64_t row0 = (int64_t)b * S + (int64_t)ci * kT;
#pragma unroll
      for (int rt = 0; rt < 4; ++rt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * rt + g;
          float* yr = y + ((row0 + r) * H + h) * P + pr0 + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(yr) =
              make_float2(acc[rt][j][0], acc[rt][j][1]);
          *reinterpret_cast<float2*>(yr + (int64_t)8 * H * P) =
              make_float2(acc[rt][j][2], acc[rt][j][3]);
        }

      // S = exp(L_last) S + (w x)^T B on this warp's state tile
      const float e_last = eLs[kT - 1];
#pragma unroll
      for (int j = 0; j < NTS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= e_last;
#pragma unroll
      for (int k0 = 0; k0 < kT; k0 += 16) {
        // A (p, j) = w_j x (j, p) at depths j0, j0 + 1, j0 + 8, j0 + 9
        const int j0 = k0 + 2 * t;
        const float* xr = Xs + j0 * LDX + pr0 + g;
        const float w0 = ws[j0], w1 = ws[j0 + 1], w8 = ws[j0 + 8],
                    w9 = ws[j0 + 9];
        FragA fa;
        fa.set(make_float2(w0 * xr[0], w1 * xr[LDX]),
               make_float2(w0 * xr[8], w1 * xr[LDX + 8]),
               make_float2(w8 * xr[8 * LDX], w9 * xr[9 * LDX]),
               make_float2(w8 * xr[8 * LDX + 8], w9 * xr[9 * LDX + 8]));
#pragma unroll
        for (int j = 0; j < NTS; ++j) {   // B (j, n) = B (j, n)
          FragB fb;
          fb.cols(Bs, LDB, 8 * j, k0, g, t);
          mma3(st[j], fa, fb);
        }
      }
    }
  }
  if (scans) {
#pragma unroll
    for (int j = 0; j < NTS; ++j) {
      float* row = s1 + (bh * P + pr0 + g) * N + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(st[j][0], st[j][1]);
      *reinterpret_cast<float2*>(row + 8 * N) =
          make_float2(st[j][2], st[j][3]);
    }
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
  kern<<<dim3((H + kHB - 1) / kHB, Bb), kThreads, bytes, st>>>(
      xdt, a, Bm, Cm, s0, y, s1, S, H);
  return cudaGetLastError();
}

}  // namespace

// xdt: (Bb, S, H, P); a: (Bb, S, H); B, C: (Bb, S, N); s0: (Bb, H, P, N);
// y: (Bb, S, H, P); s1: (Bb, H, P, N), which may be s0 itself (each block
// reads its own heads' (P, N) slices before it writes them). All f32,
// contiguous, 16-byte aligned; S % 64 == 0; (P, N) in {(32, 16), (64, 64)}.
// Returns a cudaError_t.
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
