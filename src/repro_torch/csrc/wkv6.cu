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
// (the reference's stabilizer), r2_t = r_t e^{L_{t-1}-c} and
// k2_j = k_j e^{c-L_j}:
//   y_t = r2_t . (e^{c} S) + sum_{j < t} (r2_t . k2_j) v_j
//       + (r_t . u . k_t) v_t
//   S'  = e^{c} (e^{c} S + sum_j k2_j v_j^T)
// which is the reference's e^{L_last} S + sum_j (k_j e^{L_last-L_j}) v_j^T.
// Every factor's exponent lies in [c, -c], as in the TPU kernel. f32 in,
// f32 out.
//
// Bound on Hopper: bytes, once the products are on the tensor cores. At
// rwkv6's prefill shape (B = 8, S = 4096, H = 64, N = 64) one call moves
// 2.69 GB (r, k, v, logw in and y out: 0.806 ms at 3.35 TB/s). The first
// design multiplied on the CUDA cores in f32 (~52 GFLOP, ~0.8 ms at the
// f32 peak alone) and copied each chunk synchronously before computing
// it, so loads and FMAs ran in series (2.74-2.79 ms). Design:
//   - one block of N / 16 warps per (b, h) loops over 64-step chunks
//     (512 blocks at B = 8, H = 64; 100 KB of shared memory at N = 64, two
//     blocks per SM). Warp wi owns the transposed state's rows m = 16 wi
//     .. 16 wi + 15 in its mma accumulators for the whole sequence, so the
//     tile is, as it stands, the B operand of r2 (e^{c} S), the layout
//     L4 uses for C S^T; and it owns y's columns m of the chunk.
//   - the four products r2 k2^T (on the 20 16 x 8 tiles that touch the
//     lower triangle), r2 (e^{c} S), A v and k2^T v run on the tensor
//     cores as mma.sync m16n8k16, each f32 operand split as bf16 hi + lo
//     and each product hi.hi + hi.lo + lo.hi (mma_split.cuh, shared with
//     L4): one bf16 rounding does not hold SCAN_TOL. The operands are
//     split once per chunk into bf16 tiles in shared memory (swizzled,
//     free of bank conflicts) and read by ldmatrix; the A tile
//     (r2 k2^T below the diagonal, the bonus r_t . u . k_t on it) takes the
//     place of r2's tiles once r2 is consumed, and one ldmatrix of v
//     serves both as the B operand of A v and, transposed, as the A
//     operand of the state update.
//   - the next chunk's r, k, v are in flight (cp.async into one f32 stage,
//     issued as soon as this chunk's are split) and its logw in registers
//     while this chunk multiplies; four barriers per chunk.
//   - the per-channel cumulative sum runs in 4 segments of 16 steps per
//     channel, joined by shuffles; exponents in log2 units.
#include <math.h>

#include "mma_split.cuh"

namespace {

constexpr int kT = 64;          // steps per chunk
constexpr int kSeg = 16;        // steps per cumulative-sum segment
constexpr int kRP = 16;         // f32 pad per 16 rows of a raw tile
constexpr int kTiles = 20;      // 16 x 8 tiles of r2 k2^T touching j <= t
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// element offset of (row, col) in a [rows][W] bf16 tile: 16-byte chunks
// XOR-swizzled so that the 8 rows of an ldmatrix, and the 4 rows 16 apart
// that one store of the split writes, fall in distinct banks
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int RC = W / 8;     // chunks per row
  constexpr int RPL = 8 / RC;   // rows per 128-byte line
  const int x =
      ((row / RPL) & (RC - 1)) ^ (((row >> 4) & (RC / 2 - 1)) << 1);
  return row * W + (((col >> 3) ^ x) << 3) + (col & 7);
}

// f32 raw tiles: row t at t N + (t / 16) kRP, so that the split's reads of
// 4 rows 16 apart spread over the banks
template <int N>
__device__ __forceinline__ int raw_off(int t, int n) {
  return t * N + (t >> 4) * kRP + n;
}

template <int N>
struct Layout {                                   // bytes
  static_assert(N <= kT, "the r2 slot holds A");
  static constexpr int RAW = kT * N + 4 * kRP;    // floats of one raw tile
  static constexpr int raw = 0;                   // r, k, v: 3 x RAW floats
  static constexpr int r2h = raw + 3 * RAW * 4;   // r2 [kT][N], then A [kT][kT]
  static constexpr int r2l = r2h + kT * kT * 2;
  static constexpr int k2h = r2l + kT * kT * 2;   // k2 [kT][N]
  static constexpr int k2l = k2h + kT * N * 2;
  static constexpr int vh = k2l + kT * N * 2;     // v [kT][N]
  static constexpr int vl = vh + kT * N * 2;
  static constexpr int ec = vl + kT * N * 2;      // N floats: e^{c}
  static constexpr int bonus = ec + N * 4;        // N / 16 x kT partial bonuses
  static constexpr int bytes = bonus + (N / 16) * kT * 4;
  static_assert(RAW % 4 == 0 && r2h % 16 == 0, "16-byte alignment");
};

template <int N>
__global__ void __launch_bounds__(2 * N, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* s0, float* y,
            float* s1, int S, int H) {
  using Lay = Layout<N>;
  constexpr int kWarps = N / 16;
  constexpr int kThreads = 32 * kWarps;
  constexpr int NT = N / 8;                 // state column tiles (n)
  constexpr int kPer = kTiles / kWarps;     // A tiles per warp
  static_assert(kTiles % kWarps == 0 && kT == 4 * kSeg, "shape");
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  float* raw_r = reinterpret_cast<float*>(sm + Lay::raw);
  float* raw_k = raw_r + Lay::RAW;
  float* raw_v = raw_k + Lay::RAW;
  __nv_bfloat16* r2h = reinterpret_cast<__nv_bfloat16*>(sm + Lay::r2h);
  __nv_bfloat16* r2l = reinterpret_cast<__nv_bfloat16*>(sm + Lay::r2l);
  __nv_bfloat16* k2h = reinterpret_cast<__nv_bfloat16*>(sm + Lay::k2h);
  __nv_bfloat16* k2l = reinterpret_cast<__nv_bfloat16*>(sm + Lay::k2l);
  __nv_bfloat16* vh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::vh);
  __nv_bfloat16* vl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::vl);
  float* ec = reinterpret_cast<float*>(sm + Lay::ec);
  float* bonus = reinterpret_cast<float*>(sm + Lay::bonus);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t stride = (int64_t)H * N;    // between steps
  const int64_t bh = (int64_t)b * H + h;
  const int m0 = 16 * wid;                  // this warp's state rows m
  // ldmatrix row addresses: x4 (16 x 16 at r0, c0) and x2 (8 x 16)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  const int brow = lane & 7;
  const int bcol = ((lane >> 3) & 1) * 8;
  // the split's roles: channels n0, n0 + 1, steps kSeg seg .. + kSeg - 1
  const int cp = lane & 7;
  const int seg = lane >> 3;
  const int n0 = 16 * wid + 2 * cp;
  const float2 uu =
      *reinterpret_cast<const float2*>(u + (int64_t)h * N + n0);

  // the transposed state St[m][n] = S[n][m]: rows m0 + g (+ 8), columns
  // 8 j + 2 t4 (+ 1)
  float st[NT][4];
  {
    const float* p = s0 + bh * N * N + m0 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t4;
      st[j][0] = p[n * N];
      st[j][1] = p[(n + 1) * N];
      st[j][2] = p[n * N + 8];
      st[j][3] = p[(n + 1) * N + 8];
    }
  }
  // A tiles of this warp: (row tile, 8-column tile) for tile wid + kWarps u
  int rt_u[kPer], jt_u[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = wid + kWarps * q;
    rt_u[q] = idx < 2 ? 0 : idx < 6 ? 1 : idx < 12 ? 2 : 3;
    jt_u[q] = idx - rt_u[q] * (rt_u[q] + 1);
  }

  auto issue = [&](int c0) {   // r, k, v of the chunk at c0 into the stage
    const int64_t off = (((int64_t)b * S + c0) * H + h) * N;
    constexpr int V = N / 4;
    for (int i = tid; i < kT * V; i += kThreads) {
      const int row = i / V;
      const int col = (i % V) * 4;
      const int d = raw_off<N>(row, col);
      const int64_t s = off + row * stride + col;
      cp_async16(raw_r + d, r + s);
      cp_async16(raw_k + d, k + s);
      cp_async16(raw_v + d, v + s);
    }
    cp_async_commit();
  };
  float2 lw[kSeg];             // this thread's logw of the next chunk
  auto fetch_logw = [&](int c0) {
    const float* p =
        logw + (((int64_t)b * S + c0 + kSeg * seg) * H + h) * N + n0;
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      lw[i] = __ldg(reinterpret_cast<const float2*>(p + i * stride));
  };

  const int n_chunks = S / kT;
  if (n_chunks > 0) {
    issue(0);
    fetch_logw(0);
  }
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * kT;
    cp_async_wait_all();
    __syncthreads();   // chunk ci is in; every read of chunk ci - 1 is done

    // ---- split: L per channel (log2 units), r2, k2, v as bf16 hi + lo,
    // e^{c}, the bonus partial sums
    {
      float s0x = 0.f, s0y = 0.f;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        lw[i].x *= kLog2e;
        lw[i].y *= kLog2e;
        s0x += lw[i].x;
        s0y += lw[i].y;
      }
      // inclusive prefix over the 4 segments (lanes cp + 8 seg)
      float ix = s0x, iy = s0y;
#pragma unroll
      for (int off = 8; off < 32; off *= 2) {
        const float ax = __shfl_up_sync(kFull, ix, off);
        const float ay = __shfl_up_sync(kFull, iy, off);
        if (lane >= off) {
          ix += ax;
          iy += ay;
        }
      }
      const float cx = 0.5f * __shfl_sync(kFull, ix, cp + 24);
      const float cy = 0.5f * __shfl_sync(kFull, iy, cp + 24);
      float runx = __shfl_up_sync(kFull, ix, 8);
      float runy = __shfl_up_sync(kFull, iy, 8);
      if (seg == 0) {
        runx = runy = 0.f;
        ec[n0] = exp2f(cx);
        ec[n0 + 1] = exp2f(cy);
      }
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int t = kSeg * seg + i;
        const int d = raw_off<N>(t, n0);
        const float2 rr = *reinterpret_cast<const float2*>(raw_r + d);
        const float2 kk = *reinterpret_cast<const float2*>(raw_k + d);
        const float2 vv = *reinterpret_cast<const float2*>(raw_v + d);
        const float ex = exp2f(runx - cx), ey = exp2f(runy - cy);
        runx += lw[i].x;
        runy += lw[i].y;
        const float fx = exp2f(cx - runx), fy = exp2f(cy - runy);
        float p = fmaf(rr.y * uu.y, kk.y, rr.x * uu.x * kk.x);
        const int o = swz<N>(t, n0);
        uint32_t hi, lo;
        split2(rr.x * ex, rr.y * ey, hi, lo);
        *reinterpret_cast<uint32_t*>(r2h + o) = hi;
        *reinterpret_cast<uint32_t*>(r2l + o) = lo;
        split2(kk.x * fx, kk.y * fy, hi, lo);
        *reinterpret_cast<uint32_t*>(k2h + o) = hi;
        *reinterpret_cast<uint32_t*>(k2l + o) = lo;
        split2(vv.x, vv.y, hi, lo);
        *reinterpret_cast<uint32_t*>(vh + o) = hi;
        *reinterpret_cast<uint32_t*>(vl + o) = lo;
        p += __shfl_xor_sync(kFull, p, 1);
        p += __shfl_xor_sync(kFull, p, 2);
        p += __shfl_xor_sync(kFull, p, 4);
        if (cp == 0) bonus[wid * kT + t] = p;
      }
    }
    __syncthreads();   // the split tiles, e^{c} and the bonuses are in
    if (ci + 1 < n_chunks) {   // in flight while this chunk multiplies
      issue(c0 + kT);
      fetch_logw(c0 + kT);
    }

    // ---- y = r2 (e^{c} S) on columns m0..m0 + 15; A = r2 k2^T tiles
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 e = *reinterpret_cast<const float2*>(ec + 8 * j + 2 * t4);
      st[j][0] *= e.x;
      st[j][1] *= e.y;
      st[j][2] *= e.x;
      st[j][3] *= e.y;
    }
    float acc[4][2][4];
#pragma unroll
    for (int rt = 0; rt < 4; ++rt)
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rt][ct][e] = 0.f;
    float d[kPer][4];
#pragma unroll
    for (int q = 0; q < kPer; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[q][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < N / 16; ++kq) {
      // B (n, m) of e^{c} S: the state tile as it stands
      FragB fs0, fs1;
      fs0.set(make_float2(st[2 * kq][0], st[2 * kq][1]),
              make_float2(st[2 * kq + 1][0], st[2 * kq + 1][1]));
      fs1.set(make_float2(st[2 * kq][2], st[2 * kq][3]),
              make_float2(st[2 * kq + 1][2], st[2 * kq + 1][3]));
#pragma unroll
      for (int rt = 0; rt < 4; ++rt) {
        FragA fr;
        const int o = swz<N>(16 * rt + arow, 16 * kq + acol);
        ldsm_x4(fr.hi, r2h + o);
        ldsm_x4(fr.lo, r2l + o);
        mma3(acc[rt][0], fr, fs0);
        mma3(acc[rt][1], fr, fs1);
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (rt_u[q] != rt) continue;   // warp-uniform
          FragB fk;
          const int ok = swz<N>(8 * jt_u[q] + brow, 16 * kq + bcol);
          ldsm_x2(fk.hi, k2h + ok);
          ldsm_x2(fk.lo, k2l + ok);
          mma3(d[q], fr, fk);
        }
      }
    }
    __syncthreads();   // every read of r2 is done: its slot takes A

    // A[t][j]: r2_t . k2_j for j < t, the bonus for j = t, 0 above
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * rt_u[q] + g + 8 * hf;
        const int j = 8 * jt_u[q] + 2 * t4;
        float bt = 0.f;
        if (t == j || t == j + 1) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) bt += bonus[w * kT + t];
        }
        const float a0 = j < t ? d[q][2 * hf] : j == t ? bt : 0.f;
        const float a1 = j + 1 < t ? d[q][2 * hf + 1] : j + 1 == t ? bt : 0.f;
        uint32_t hi, lo;
        split2(a0, a1, hi, lo);
        const int o = swz<kT>(t, j);
        *reinterpret_cast<uint32_t*>(r2h + o) = hi;
        *reinterpret_cast<uint32_t*>(r2l + o) = lo;
      }
    }
    __syncthreads();   // A is in

    // ---- y += A v; S^T += v^T k2 (one ldmatrix of v for both)
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      uint32_t xh[4], xl[4];
      const int ov = swz<N>(16 * kj + arow, m0 + acol);
      ldsm_x4_trans(xh, vh + ov);
      ldsm_x4_trans(xl, vl + ov);
      const FragB fv0 = {{xh[0], xh[1]}, {xl[0], xl[1]}};
      const FragB fv1 = {{xh[2], xh[3]}, {xl[2], xl[3]}};
#pragma unroll
      for (int rt = kj; rt < 4; ++rt) {
        FragA fa;
        const int oa = swz<kT>(16 * rt + arow, 16 * kj + acol);
        ldsm_x4(fa.hi, r2h + oa);
        ldsm_x4(fa.lo, r2l + oa);
        mma3(acc[rt][0], fa, fv0);
        mma3(acc[rt][1], fa, fv1);
      }
      const FragA fvt = {{xh[0], xh[2], xh[1], xh[3]},
                         {xl[0], xl[2], xl[1], xl[3]}};
#pragma unroll
      for (int q = 0; q < N / 16; ++q) {
        uint32_t kh[4], kl[4];
        const int ok = swz<N>(16 * kj + arow, 16 * q + acol);
        ldsm_x4_trans(kh, k2h + ok);
        ldsm_x4_trans(kl, k2l + ok);
        const FragB fk0 = {{kh[0], kh[1]}, {kl[0], kl[1]}};
        const FragB fk1 = {{kh[2], kh[3]}, {kl[2], kl[3]}};
        mma3(st[2 * q], fvt, fk0);
        mma3(st[2 * q + 1], fvt, fk1);
      }
    }
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
      const int t = 16 * rt + g;
      float* yr = y + (((int64_t)b * S + c0 + t) * H + h) * N + m0 + 2 * t4;
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        *reinterpret_cast<float2*>(yr + 8 * ct) =
            make_float2(acc[rt][ct][0], acc[rt][ct][1]);
        *reinterpret_cast<float2*>(yr + 8 * stride + 8 * ct) =
            make_float2(acc[rt][ct][2], acc[rt][ct][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 e = *reinterpret_cast<const float2*>(ec + 8 * j + 2 * t4);
      st[j][0] *= e.x;
      st[j][1] *= e.y;
      st[j][2] *= e.x;
      st[j][3] *= e.y;
    }
  }
  {
    float* p = s1 + bh * N * N + m0 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t4;
      p[n * N] = st[j][0];
      p[(n + 1) * N] = st[j][1];
      p[n * N + 8] = st[j][2];
      p[(n + 1) * N + 8] = st[j][3];
    }
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s0,
                   float* y, float* s1, int B, int S, int H,
                   cudaStream_t st) {
  auto kern = wkv6_kernel<N>;
  constexpr int bytes = Layout<N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // two blocks per SM need the largest shared-memory carve-out
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), 2 * N, bytes, st>>>(r, k, v, logw, u, s0, y, s1, S, H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, logw: (B, S, H, N); u: (H, N); s0: (B, H, N, N); y: (B, S, H,
// N); s1: (B, H, N, N), which may be s0 itself (each block reads its own
// (N, N) slice before it writes it). All f32, contiguous, 16-byte aligned;
// S % 64 == 0; N in {32, 64}. Returns a cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* y, void* s1, int B, int S, int H, int N,
                           void* stream) {
  if (B < 0 || S < 0 || S % kT != 0 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(logw);
  if (any % 16) return (int)cudaErrorMisalignedAddress;   // cp.async
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
