// L2 (f32): flash attention, backward pass (training), on the tensor cores
// in 3xTF32.
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
// product runs as three TF32 tensor-core products (x = hi + lo, lo.hi +
// hi.lo + hi.hi, attention_tf32.cuh) into partials of at most 4 depth
// steps (a tile's 16 keys or queries for dq, dk and dv), added into f32
// sums on the CUDA cores; D is an f32 sum on the CUDA cores. dq, dk and dv
// are written once, with no atomics: a run repeats bit for bit.
//
// Bound on Hopper: operations. A fused backward needs five products per
// unmasked (query, key) pair and q-head, 10 hd flops. At the train path's
// shape (B = 2, S = 4096, H = 32, Hkv = 8, hd = 128, causal) that is
// 0.69 TFLOP for 676 MB of f32 operands and results: 4.17 ms as 3xTF32
// products at 495 TFLOP/s (10.2 ms on the CUDA cores at 67). This design
// runs two passes, as the reference does, and so forms s and dp twice
// (14 hd flops per pair, 5.84 ms): the dq pass forms s, dp and ds k; the
// dk/dv pass forms s, dp, p^T do and ds^T q.
// Design:
//   - dq pass: one block of 8 warps per (b, q-head, 128 query rows), a
//     warp 16 rows, loops over 16-key tiles with dq in registers. Its q
//     (times scale) and do rows stay raw in shared memory, split as a
//     warp loads them. It reads K/V of the head's KV head directly (no
//     repeated copy), forms D for its rows from o and do (so no
//     (B, Sq, H, hd) f32 temporaries exist) and writes D (B, Sq, H) f32
//     for the second pass.
//   - dk/dv pass: one block of 8 warps per (b, KV head, 64 key rows),
//     loops over the group's q-heads and, for each, over the 16-query
//     tiles that see its keys; its K and V rows stay raw in shared
//     memory. A pair of warps owns 16 keys: one forms s^T and p^T and
//     adds p^T do into dv, the other forms dp^T, takes p^T from its
//     partner through shared memory (a named barrier per pair) and adds
//     ds^T q into dk. Each holds hd / 2 accumulator registers a lane: one
//     warp holding both (hd) made ptxas spill at hd 112 and 128 however
//     the loop was arranged, and two separate passes cost 45% more time.
//     dk and dv are written once. The GQA sum happens inside the block:
//     no cross-block reduction, no atomics, no per-q-head dk/dv. The
//     tiles are transposed (rows are keys), so p^T and ds^T leave their
//     accumulators as the A fragments of p^T do and ds^T q.
//   - streamed tiles (K/V in the dq pass, q/do in the dk/dv pass) arrive
//     by cp.async into a raw stage while the block multiplies the
//     previous tile, and are split once by the block into the row and
//     pair planes their products read (attention_tf32.cuh; K, q and do
//     into both from one split). 208 KB (dq) and 158 KB (dk/dv) of
//     shared memory at hd 128: one block, 8 warps, an SM.
//   - causal and window masks are loop bounds (the first and last tile a
//     block pairs with) and a warp skips the tiles none of its rows
//     sees; only tiles that straddle the diagonal, the window edge or a
//     ragged Sq/Skv edge mask element by element. Rows past Sq and keys
//     past Skv are staged as zeros, masked and not stored. Nothing is
//     padded or copied.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"

namespace {

using namespace tf32att;

constexpr int kRows = 128;   // query rows a dq block keeps: 8 warps x 16
constexpr int kPairs = 4;    // warp pairs of a dk/dv block
constexpr int kKeys = 16 * kPairs;   // key rows a dk/dv block keeps
constexpr int kTile = 16;    // streamed tile rows: keys (dq), queries (dk/dv)
constexpr int kThreads = 256;

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * kRows * raw_ld<HD>() + 2 * kTile * HD + 2 * kTile * row_ld<HD>() +
         kTile / 2 * pair_ld<HD>() + 2 * kRows;
}

template <int HD>
constexpr int dkv_smem_floats() {
  return 2 * kKeys * raw_ld<HD>() + 2 * kTile * HD + 2 * kTile +
         2 * kTile * row_ld<HD>() + 2 * (kTile / 2) * pair_ld<HD>() +
         2 * kTile + kPairs * (kTile / 8) * 32 * 4;
}

// the two warps of pair i meet (named barrier i + 1; __syncthreads is 0)
__device__ __forceinline__ void pair_sync(int i) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(i + 1) : "memory");
}

// sum += a m for a tile: a is kTile / 8 accumulators (16 rows x kTile
// columns, the depth of the product), m a pair plane (kTile x HD); a fresh
// partial per column tile of sum
template <int HD>
__device__ __forceinline__ void tile_rows(float (&sum)[HD / 8][4],
                                          const float (&a)[kTile / 8][4],
                                          const float* m, int g, int t) {
  constexpr int NT = kTile / 8;
  Frag f[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) frag_acc(f[j], a[j]);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float part[4];
    mma3_tf32_first(part, f[0], frag_pair<HD>(m, 8 * n, 0, g, t));
#pragma unroll
    for (int j = 1; j < NT; ++j)
      mma3_tf32(part, f[j], frag_pair<HD>(m, 8 * n, j, g, t));
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += part[e];
  }
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
  constexpr int NK = HD / 8;      // depth steps of q k^T, columns tiles of dq
  constexpr int NT = kTile / 8;   // column tiles of s, depth steps of ds k
  constexpr int LDA = raw_ld<HD>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kRows x LDA, q * scale
  float* dos = qs + kRows * LDA;                // kRows x LDA
  float* raw_k = dos + kRows * LDA;             // kTile x HD
  float* raw_v = raw_k + kTile * HD;            // kTile x HD
  float* kp = raw_v + kTile * HD;               // row plane of K
  float* vp = kp + kTile * row_ld<HD>();        // row plane of V
  float* kt = vp + kTile * row_ld<HD>();        // pair plane of K
  float* Ds = kt + kTile / 2 * pair_ld<HD>();   // kRows: D
  float* ls = Ds + kRows;                       // kRows: lse

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;    // the warp's first row in the block
  const int wq = q0 + wr;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t qoff = ((int64_t)b * Sq * H + h) * HD;
  const float* kb = k + ((int64_t)b * Skv * Hkv + hk) * HD;
  const float* vb = v + ((int64_t)b * Skv * Hkv + hk) * HD;

  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kRows);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (kv_lo / kTile) * kTile;

  load_rows<HD, LDA, kRows, kThreads>(qs, q + qoff, q_stride, q0, Sq);
  load_rows<HD, LDA, kRows, kThreads>(dos, dout + qoff, q_stride, q0, Sq);
  if (k_first < kv_hi) {
    load_rows<HD, HD, kTile, kThreads>(raw_k, kb, kv_stride, k_first, Skv);
    load_rows<HD, HD, kTile, kThreads>(raw_v, vb, kv_stride, k_first, Skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * HD; i += kThreads)
    qs[(i / HD) * LDA + i % HD] *= scale;
  // D for the warp's own rows, lanes over the head dimension
  for (int r = wr; r < wr + 16; ++r) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < Sq) {
      const float* orow = o + qoff + (int64_t)qp * q_stride;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dos[r * LDA + d], orow[d], acc);
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
  __syncthreads();  // q is scaled; D and lse are staged
  const float Dr[2] = {Ds[wr + g], Ds[wr + g + 8]};
  const float lr[2] = {ls[wr + g], ls[wr + g + 8]};

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = k_first; k0 < kv_hi; k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; every warp is done with the planes
    split_both<HD, kTile, kThreads>(kp, kt, raw_k, 1.f);
    split_rows<HD, kTile, kThreads>(vp, raw_v, 1.f);
    __syncthreads();  // the planes are ready and the raw stage is free
    if (k0 + kTile < kv_hi) {
      load_rows<HD, HD, kTile, kThreads>(raw_k, kb, kv_stride, k0 + kTile,
                                         Skv);
      load_rows<HD, HD, kTile, kThreads>(raw_v, vb, kv_stride, k0 + kTile,
                                         Skv);
      cp_async_commit();
    }
    // none of the warp's rows sees a key of this tile
    if (wq >= Sq || (causal && k0 > wq + 15) ||
        (window > 0 && k0 + kTile - 1 <= wq - window))
      continue;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    dot_chunked<NK, NT>(
        s, [&](Frag& a, int ks) { frag_raw<LDA>(a, qs, wr, ks, g, t); },
        [&](int ks, int j) { return frag_row<HD>(kp, 8 * j, ks, g, t); });
    dot_chunked<NK, NT>(
        dp, [&](Frag& a, int ks) { frag_raw<LDA>(a, dos, wr, ks, g, t); },
        [&](int ks, int j) { return frag_row<HD>(vp, 8 * j, ks, g, t); });

    const bool inner = wq + 16 <= Sq && k0 + kTile <= Skv &&
                       (!causal || k0 + kTile - 1 <= wq) &&
                       (window <= 0 || k0 > wq + 15 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = inner || visible(wq + g + 8 * r,
                                         k0 + 8 * j + 2 * t + (e & 1), Sq,
                                         Skv, causal, window);
        const float p = ok ? expf(s[j][e] - lr[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - Dr[r]);   // ds
      }
    tile_rows<HD>(acc, s, kt, g, t);   // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq + g + 8 * r;
    if (qp >= Sq) continue;
    float* row = dq + qoff + (int64_t)qp * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// dk/dv pass. Grid (Hkv, key tiles of kKeys, B); key tiles run first to
// last, which is longest first under a causal mask. Warp pair i (warps i
// and i + kPairs) owns keys k0 + 16 i ..: the first forms s^T and p^T and
// adds p^T do into dv, the second forms dp^T, takes p^T from its partner
// through shared memory, and adds ds^T q into dk.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ Dg, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int causal, int window, float scale) {
  constexpr int NK = HD / 8;      // depth steps of k q^T, column tiles of dk
  constexpr int NT = kTile / 8;   // column tiles of s^T, depth steps of p^T do
  constexpr int LDA = raw_ld<HD>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kKeys x LDA
  float* vs = ks + kKeys * LDA;                 // kKeys x LDA
  float* raw_q = vs + kKeys * LDA;              // kTile x HD
  float* raw_do = raw_q + kTile * HD;           // kTile x HD
  float* raw_l = raw_do + kTile * HD;           // kTile: lse
  float* raw_D = raw_l + kTile;                 // kTile: D
  float* qp = raw_D + kTile;                    // row plane of q * scale
  float* dop = qp + kTile * row_ld<HD>();       // row plane of do
  float* qt = dop + kTile * row_ld<HD>();       // pair plane of q * scale
  float* dot = qt + kTile / 2 * pair_ld<HD>();  // pair plane of do
  float* ls = dot + kTile / 2 * pair_ld<HD>();  // kTile: lse
  float* Ds = ls + kTile;                       // kTile: D
  float* xp = Ds + kTile;                       // kPairs x NT x 32 lanes x 4

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp % kPairs;
  const bool dk_warp = warp >= kPairs;
  const int wr = 16 * pair;
  const int wk = k0 + wr;      // the pair's first key
  float* xlane = xp + pair * NT * 128 + 4 * lane;   // + 128 j: p^T's tile j

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const int64_t kvoff = ((int64_t)b * Skv * Hkv + hk) * HD;

  // queries that see this block's keys: causal => i >= k0;
  // window => i < j + window <= k0 + kKeys - 1 + window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kKeys - 1 + window) : Sq;
  const int q_first = (q_lo / kTile) * kTile;

  // tile (h, q0): queries q0 .. q0 + kTile - 1 of q-head h; the loop
  // visits the group's q-heads in turn, each over its query tiles
  const float* qb = q + (int64_t)b * Sq * H * HD;
  const float* dob = dout + (int64_t)b * Sq * H * HD;
  auto issue = [&](int h, int q0) {
    load_rows<HD, HD, kTile, kThreads>(raw_q, qb + (int64_t)h * HD,
                                       q_stride, q0, Sq);
    load_rows<HD, HD, kTile, kThreads>(raw_do, dob + (int64_t)h * HD,
                                       q_stride, q0, Sq);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int64_t row = ((int64_t)b * Sq + q0 + r) * H + h;
      if (q0 + r < Sq) {
        cp_async4(raw_l + r, lse + row);
        cp_async4(raw_D + r, Dg + row);
      } else {
        raw_l[r] = 0.f;
        raw_D[r] = 0.f;
      }
    }
  };
  // the next tile to multiply; none when no query sees the block's keys
  const int h_end = (hk + 1) * group;
  int h_cur = q_first < q_hi ? hk * group : h_end, q0_cur = q_first;

  load_rows<HD, LDA, kKeys, kThreads>(ks, k + kvoff, kv_stride, k0, Skv);
  load_rows<HD, LDA, kKeys, kThreads>(vs, v + kvoff, kv_stride, k0, Skv);
  if (h_cur < h_end) issue(h_cur, q0_cur);
  cp_async_commit();

  float acc[NK][4];   // dv (the first warp of a pair) or dk (the second)
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  while (h_cur < h_end) {
    const int q0 = q0_cur;
    if (q0_cur + kTile < q_hi) {
      q0_cur += kTile;
    } else {
      q0_cur = q_first;
      ++h_cur;
    }
    cp_async_wait_all();
    __syncthreads();  // tile q0 has landed; every warp is done with the planes
    split_both<HD, kTile, kThreads>(qp, qt, raw_q, scale);
    split_both<HD, kTile, kThreads>(dop, dot, raw_do, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      ls[r] = raw_l[r];
      Ds[r] = raw_D[r];
    }
    __syncthreads();  // the planes are ready and the raw stage is free
    if (h_cur < h_end) {
      issue(h_cur, q0_cur);
      cp_async_commit();
    }
    // none of the pair's keys is seen by a query of this tile
    if (wk >= Skv || (causal && q0 + kTile - 1 < wk) ||
        (window > 0 && q0 >= wk + 15 + window))
      continue;

    // the transposed tile: rows are the pair's keys, columns the queries
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (!dk_warp) {
      dot_chunked<NK, NT>(
          s, [&](Frag& a, int kk) { frag_raw<LDA>(a, ks, wr, kk, g, t); },
          [&](int kk, int j) { return frag_row<HD>(qp, 8 * j, kk, g, t); });
      const bool inner = q0 + kTile <= Sq && wk + 16 <= Skv &&
                         (!causal || wk + 15 <= q0) &&
                         (window <= 0 || wk > q0 + kTile - 1 - window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok = inner || visible(q0 + c, wk + g + 8 * (e >> 1),
                                           Sq, Skv, causal, window);
          s[j][e] = ok ? expf(s[j][e] - ls[c]) : 0.f;   // p^T
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float4*>(xlane + 128 * j) =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      pair_sync(pair);   // p^T is in shared memory for the partner
      tile_rows<HD>(acc, s, dot, g, t);   // dv += p^T do
    } else {
      dot_chunked<NK, NT>(
          s, [&](Frag& a, int kk) { frag_raw<LDA>(a, vs, wr, kk, g, t); },
          [&](int kk, int j) { return frag_row<HD>(dop, 8 * j, kk, g, t); });
      pair_sync(pair);   // the partner's p^T has arrived
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 pj = *reinterpret_cast<const float4*>(xlane + 128 * j);
        const float p4[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)   // ds^T = p^T (dp^T - D)
          s[j][e] = p4[e] * (s[j][e] - Ds[8 * j + 2 * t + (e & 1)]);
      }
      tile_rows<HD>(acc, s, qt, g, t);    // dk += ds^T q
    }
  }
  cp_async_wait_all();   // a block with no tile still has K/V in flight

  float* out = dk_warp ? dk : dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = wk + g + 8 * r;
    if (kp >= Skv) continue;
    float* row = out + kvoff + (int64_t)kp * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* D, float* dq, float* dk, float* dv, int B, int Sq,
                   int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t st) {
  constexpr int dq_bytes = (int)sizeof(float) * dq_smem_floats<HD>();
  constexpr int dkv_bytes = (int)sizeof(float) * dkv_smem_floats<HD>();
  auto dq_kern = flash_bwd_dq_kernel<HD>;
  auto dkv_kern = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  if (Sq > 0) {  // with Skv == 0 it writes dq = 0
    dq_kern<<<dim3(H, (Sq + kRows - 1) / kRows, B), kThreads, dq_bytes,
              st>>>(q, k, v, o, dout, lse, D, dq, Sq, Skv, H, Hkv, causal,
                    window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Skv == 0) return cudaSuccess;  // with Sq == 0 it writes dk = dv = 0
  // same stream: the dk/dv pass reads the D that the dq pass wrote
  dkv_kern<<<dim3(Hkv, (Skv + kKeys - 1) / kKeys, B), kThreads, dkv_bytes,
             st>>>(q, k, v, dout, lse, D, dk, dv, Sq, Skv, H, Hkv, causal,
                   window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, Hkv, hd), all f32,
// contiguous, 16-byte aligned; hd in {32, 64, 112, 128}; lse: f32
// (B, Sq, H) from the forward; D: f32 (B, Sq, H) scratch that the dq pass
// fills. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* D, float* dq, float* dk,
    float* dv, int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
    int window, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kRows || Skv > 65535 * kKeys || B > 65535)
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
    case 112:  // zamba2's shared attention block
      return (int)launch<112>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                              Skv, H, Hkv, causal, window, st);
    case 128:
      return (int)launch<128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq,
                              Skv, H, Hkv, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
