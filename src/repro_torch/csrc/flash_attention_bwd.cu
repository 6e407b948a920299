// L2 (f32): flash attention, backward pass (training), on the CUDA cores.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel_bwd.py: flash_bwd_padded
//   (bodies _dq_kernel and _dkv_kernel), and the GQA handling of their
//   wrapper ops._fa_bwd (K/V repeated to every q-head, per-q-head f32
//   dk/dv summed over the group afterwards).
// For q, do (B, Sq, H, hd), k, v (B, Skv, Hkv, hd), o (B, Sq, H, hd) and
// the forward's f32 row logsumexp lse (B, Sq, H), with D = rowsum(do * o):
//   p  = exp(q k^T scale - lse)   masked as in L1 (causal / window / edges)
//   dv = sum p^T do,  dp = do v^T,  ds = p * (dp - D)
//   dq = ds k scale,  dk = ds^T q scale
// dk and dv are summed over each GQA group. This file serves f32 inputs;
// bf16 ones go to flash_attention_bwd_sm90.cu (wgmma fed by TMA). Every
// product is an f32 FMA on the CUDA cores, since the tensor cores have no
// f32 product that keeps the f32 results to 1e-5; dq, dk and dv are
// written once.
//
// Bound on Hopper: operations. A fused backward needs five products per
// unmasked (query, key) pair and q-head, 10 hd flops. At the train path's
// shape (B = 2, S = 4096, H = 32, Hkv = 8, hd = 128, causal) that is
// 0.69 TFLOP for 676 MB of f32 operands and results (0.20 ms at
// 3.35 TB/s against 10.2 ms at 67 TFLOP/s f32). This design runs two
// passes, as the reference does, and so forms s and dp twice (14 hd flops
// per pair): the dq pass forms s, dp and ds k; the dk/dv pass forms s, dp,
// p^T do and ds^T q.
// Design:
//   - dq pass: one 256-thread block per (b, q-head, 64 query rows) loops
//     over 64-key tiles, with dq in registers. It reads K/V of the head's
//     KV head directly: no repeated copy. It also forms D for its rows
//     from o and do (so no (B, Sq, H, hd) f32 temporaries exist) and
//     writes D (B, Sq, H) f32 for the second pass.
//   - dk/dv pass: one 256-thread block per (b, KV head, 64 key rows)
//     loops over the group's q-heads and, for each, over the query tiles
//     that see its keys; dk and dv stay in registers and are written once.
//     The GQA sum happens inside the block: no cross-block reduction, no
//     atomics, no per-q-head dk/dv.
//   - causal and window masks are loop bounds (the first and last tile a
//     tile pairs with); only tiles that straddle the diagonal, the window
//     edge or a ragged Sq/Skv edge mask element by element. Rows past Sq
//     and keys past Skv are staged as zeros, masked and not stored.
//     Nothing is padded or copied.
//   - thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 32 i (i < 2) of
//     a 64 x 64 score tile and its columns tx + 8 j (j < 8), and columns
//     tx + 8 j (j < hd / 8) of the same rows of its accumulators. Shared
//     rows are padded by 4 floats so that float4 reads hit distinct banks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;  // the 64 x 64 tile of p or ds in shared
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBQ == kBK, "stage_rows and the tile products take 64 rows");

// Stage rows [r0, r0 + 64) of a (rows, stride) matrix into shared memory
// (leading dimension LD), times `scale`; rows >= n_rows are zeros.
template <int HD, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t stride, int r0, int n_rows,
                                           float scale) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < kBK * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) {
      x = *reinterpret_cast<const float4*>(
          src + (int64_t)(r0 + r) * stride + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// acc[i][j] += sum_d A[ty + 32 i][d] * B[tx + 8 j][d]: a 64 x 64 tile of
// A B^T, with A and B 64 x HD in shared memory (leading dimension LD).
template <int HD, int LD>
__device__ __forceinline__ void tile_abt(float (&acc)[2][8], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 32 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum_r P[ty + 32 i][r] * M[r][tx + 8 j]: rows of a 64 x 64
// tile P (leading dimension kLDP) times a 64 x HD matrix M (leading LD).
template <int HD, int LD>
__device__ __forceinline__ void tile_pm(float (&acc)[2][HD / 8],
                                        const float* P, const float* M,
                                        int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < kBK; ++r) {
    const float p0 = P[ty * kLDP + r];
    const float p1 = P[(ty + 32) * kLDP + r];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float m = M[r * LD + tx + 8 * j];
      acc[0][j] = fmaf(p0, m, acc[0][j]);
      acc[1][j] = fmaf(p1, m, acc[1][j]);
    }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// every (query, key) pair of the tiles at q0 and k0 is in range and visible
__device__ __forceinline__ bool interior(int q0, int k0, int Sq, int Skv,
                                         int causal, int window) {
  return q0 + kBQ <= Sq && k0 + kBK <= Skv &&
         (!causal || k0 + kBK - 1 <= q0) &&
         (window <= 0 || k0 > q0 + kBQ - 1 - window);
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) *
         (4 * kBQ * (HD + 4) + kBQ * kLDP + 2 * kBQ);
}

// dq pass, and D = rowsum(do * o). Grid (H, query tiles, B); query tiles
// run longest first (causal rows near the end see the most keys).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ Dg,
                    float* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x LD, q * scale
  float* dos = qs + kBQ * LD;                   // kBQ x LD
  float* ks = dos + kBQ * LD;                   // kBK x LD
  float* vs = ks + kBK * LD;                    // kBK x LD
  float* ps = vs + kBK * LD;                    // kBQ x kLDP: ds
  float* ls = ps + kBQ * kLDP;                  // kBQ: lse
  float* Ds = ls + kBQ;                         // kBQ: D

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int lane = threadIdx.x & 31;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t qoff = ((int64_t)b * Sq * H + h) * HD;
  const float* kb = k + ((int64_t)b * Skv * Hkv + hk) * HD;
  const float* vb = v + ((int64_t)b * Skv * Hkv + hk) * HD;

  stage_rows<HD, LD>(qs, q + qoff, q_stride, q0, Sq, scale);
  stage_rows<HD, LD>(dos, dout + qoff, q_stride, q0, Sq, 1.f);
  __syncthreads();
  // D for this tile's rows: warp w takes rows w, w + 8, ...
  for (int r = threadIdx.x >> 5; r < kBQ; r += kThreads / 32) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < Sq) {
      const float* orow = o + qoff + (int64_t)qp * q_stride;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dos[r * LD + d], orow[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      const int64_t row = ((int64_t)b * Sq + qp) * H + h;
      Ds[r] = acc;
      ls[r] = qp < Sq ? lse[row] : 0.f;
      if (qp < Sq) Dg[row] = acc;
    }
  }

  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kBQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of ks and ps are done
    stage_rows<HD, LD>(ks, kb, kv_stride, k0, Skv, 1.f);
    stage_rows<HD, LD>(vs, vb, kv_stride, k0, Skv, 1.f);
    __syncthreads();

    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<HD, LD>(s, qs, ks, ty, tx);
    tile_abt<HD, LD>(dp, dos, vs, ty, tx);

    const bool inner = interior(q0, k0, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 32 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const bool ok =
            inner || visible(q0 + r, k0 + c, Sq, Skv, causal, window);
        const float p = ok ? expf(s[i][j] - ls[r]) : 0.f;
        ps[r * kLDP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    tile_pm<HD, LD>(acc, ps, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + ty + 32 * i;
    if (qp >= Sq) continue;
    float* row = dq + qoff + (int64_t)qp * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      row[tx + 8 * j] = acc[i][j] * scale;
  }
}

// dk/dv pass. Grid (Hkv, key tiles, B); key tiles run first to last,
// which is longest first under a causal mask.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ Dg, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int causal, int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x LD
  float* vs = ks + kBK * LD;                    // kBK x LD
  float* qs = vs + kBK * LD;                    // kBQ x LD, q * scale
  float* dos = qs + kBQ * LD;                   // kBQ x LD
  float* ps = dos + kBQ * LD;                   // kBK x kLDP: p, then ds
  float* ls = ps + kBK * kLDP;                  // kBQ: lse
  float* Ds = ls + kBQ;                         // kBQ: D

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t kvoff = ((int64_t)b * Skv * Hkv + hk) * HD;
  stage_rows<HD, LD>(ks, k + kvoff, kv_stride, k0, Skv, 1.f);
  stage_rows<HD, LD>(vs, v + kvoff, kv_stride, k0, Skv, 1.f);

  // queries that see this tile's keys: causal => i >= k0;
  // window => i < j + window <= k0 + kBK - 1 + window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBK - 1 + window) : Sq;

  float gk[2][NJ], gv[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t qoff = ((int64_t)b * Sq * H + h) * HD;
    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      __syncthreads();  // the previous tile's reads of qs, dos, ps are done
      stage_rows<HD, LD>(qs, q + qoff, q_stride, q0, Sq, scale);
      stage_rows<HD, LD>(dos, dout + qoff, q_stride, q0, Sq, 1.f);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int qp = q0 + r;
        const int64_t row = ((int64_t)b * Sq + qp) * H + h;
        ls[r] = qp < Sq ? lse[row] : 0.f;
        Ds[r] = qp < Sq ? Dg[row] : 0.f;
      }
      __syncthreads();

      // the transposed tile: rows are keys, columns are queries
      float p[2][8], ds[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = ds[i][j] = 0.f;
      tile_abt<HD, LD>(p, ks, qs, ty, tx);
      tile_abt<HD, LD>(ds, vs, dos, ty, tx);

      const bool inner = interior(q0, k0, Sq, Skv, causal, window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty + 32 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;
          const bool ok =
              inner || visible(q0 + c, k0 + r, Sq, Skv, causal, window);
          const float pv = ok ? expf(p[i][j] - ls[c]) : 0.f;
          p[i][j] = pv;
          ds[i][j] = pv * (ds[i][j] - Ds[c]);
          ps[r * kLDP + c] = pv;
        }
      }
      __syncthreads();
      tile_pm<HD, LD>(gv, ps, dos, ty, tx);  // dv += p^T do
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ps[(ty + 32 * i) * kLDP + tx + 8 * j] = ds[i][j];
      __syncthreads();
      tile_pm<HD, LD>(gk, ps, qs, ty, tx);   // dk += ds^T (q scale)
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + ty + 32 * i;
    if (kp >= Skv) continue;
    const int64_t off = kvoff + (int64_t)kp * kv_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 8 * j] = gk[i][j];
      dv[off + tx + 8 * j] = gv[i][j];
    }
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* D, float* dq, float* dk, float* dv, int B, int Sq,
                   int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  auto dq_kern = flash_bwd_dq_kernel<HD>;
  auto dkv_kern = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  if (Sq > 0) {  // with Skv == 0 it writes dq = 0
    dq_kern<<<dim3(H, (Sq + kBQ - 1) / kBQ, B), kThreads, bytes, st>>>(
        q, k, v, o, dout, lse, D, dq, Sq, Skv, H, Hkv, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Skv == 0) return cudaSuccess;  // with Sq == 0 it writes dk = dv = 0
  // same stream: the dk/dv pass reads the D that the dq pass wrote
  dkv_kern<<<dim3(Hkv, (Skv + kBK - 1) / kBK, B), kThreads, bytes, st>>>(
      q, k, v, dout, lse, D, dk, dv, Sq, Skv, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, Hkv, hd), all f32,
// contiguous; hd in {32, 64, 112, 128}; lse: f32 (B, Sq, H) from the
// forward; D: f32 (B, Sq, H) scratch that the dq pass fills. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* D, float* dq, float* dk,
    float* dv, int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
    int window, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kBQ || Skv > 65535 * kBK || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                             Skv, H, Hkv, causal, window, st);
    case 64:
      return (int)launch<64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                             Skv, H, Hkv, causal, window, st);
    case 112:  // zamba2's shared attention block: 14 columns per thread
      return (int)launch<112>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                              Skv, H, Hkv, causal, window, st);
    case 128:
      return (int)launch<128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                              Skv, H, Hkv, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
