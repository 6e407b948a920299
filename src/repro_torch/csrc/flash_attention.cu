// L1 (f32): flash attention, forward pass (prefill, and forward over a
// prompt), on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_padded
//   (body _kernel), and the padding of its wrapper ops.flash_attention.
// For q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd), all f32, query row i of
// head h attends to key j of KV head h / (H / Hkv) iff
//   (!causal || j <= i) && (window == 0 || j > i - window) && j < Skv,
// with softmax(q k^T / sqrt(hd)) v computed in f32 by an online softmax.
// When asked (lse != nullptr, the training forward), it also writes each
// row's logsumexp m + log(max(l, 1e-30)), with m := 0 for a row that saw
// no key, in f32 (B, Sq, H): the reference's _finalize with return_lse.
// Serving passes nullptr and does no extra work. bf16 inputs go to
// flash_attention_sm90.cu (wgmma fed by TMA).
//
// Bound on Hopper: operations. At the serve path's prefill shape (B = 8,
// S = 4000, H = 32, Hkv = 8, hd = 128, causal) the call does 1.05 TFLOP
// for 1.31 GB of f32 q/k/v/o: 15.7 ms on the CUDA cores (67 TFLOP/s f32),
// 6.36 ms as 3xTF32 products (3 x 1.05 TFLOP at 495 TFLOP/s). One TF32
// product would keep ~11 bits and miss the 1e-5 contract; three hold it
// (x = hi + lo, products lo.hi + hi.lo + hi.hi, attention_tf32.cuh).
// Design:
//   - one block of 8 warps owns (b, q-head, 128 query rows), a warp 16
//     rows; the GQA group's heads are neighbouring blocks (head is the
//     fastest grid axis) and read the same K/V tiles through L2; query
//     tiles run longest first (causal rows near the end see the most
//     keys), which shortens the tail of the grid;
//   - q is scaled by 1/sqrt(hd) once and stays raw in shared memory,
//     split as each depth step loads it: split fragments in registers
//     (hd a lane) made ptxas spill at hd 112 and 128, and the registers
//     go to the P V partials instead;
//   - 32-key K/V tiles arrive by cp.async into a raw stage while the
//     block multiplies the previous tile; the block then splits the tile
//     once into a K row plane and a V pair plane (attention_tf32.cuh), so
//     the eight warps that read it do not each split it again. Two
//     stages: the raw tile in flight and the split tile in use; with q,
//     170 KB at hd 128, one block an SM;
//   - S = Q K^T in m16n8k8 TF32 partials of 4 depth steps, and each
//     tile's P V as one partial, added into f32 sums on the CUDA cores
//     (the tensor cores' truncating accumulation drifts over thousands of
//     products: attention_tf32.cuh); the online softmax (m, l) runs on
//     the accumulator layout, a row's max and sum over its quad's lanes;
//     P leaves the accumulators as the A fragment of P V with the depth
//     slots permuted (attention_tf32.cuh), no shuffle, and is split there;
//   - causal and window masks are loop bounds (the first and last KV tile
//     a query tile needs) and a warp skips the tiles none of its rows
//     sees; only tiles that straddle the diagonal, the window edge or the
//     ragged Skv edge mask element by element. Rows past Sq are zeros,
//     masked and not stored; keys past Skv are zeros and masked. Nothing
//     is padded or copied.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tf32.cuh"

namespace {

using namespace tf32att;

constexpr int kBQ = 128;      // query rows per block: 8 warps x 16
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256;

template <int HD>
constexpr int smem_floats() {
  return kBQ * raw_ld<HD>() + 2 * kBK * HD + kBK * row_ld<HD>() +
         kBK / 2 * pair_ld<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int window, float scale) {
  constexpr int NK = HD / 8;    // depth steps of Q K^T, column tiles of O
  constexpr int NS = kBK / 8;   // column tiles of S, depth steps of P V
  // column tiles of O a P V pass takes: 4 (hd 112: 7), so that the
  // compiler does not hoist every B fragment of P V at once (8 of hd 128's
  // 16 made ptxas spill)
  constexpr int NG = NK % 4 == 0 ? 4 : NK / 2;
  constexpr int LDA = raw_ld<HD>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // kBQ x LDA, q * scale
  float* raw_k = qs + kBQ * LDA;                   // kBK x HD
  float* raw_v = raw_k + kBK * HD;                 // kBK x HD
  float* kp = raw_v + kBK * HD;                    // row plane of K
  float* vt = kp + kBK * row_ld<HD>();             // pair plane of V

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int wr = 16 * warp;       // the warp's first row in the block
  const int wq = q0 + wr;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const float* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const float* kb = k + ((int64_t)b * Skv * Hkv + hk) * HD;
  const float* vb = v + ((int64_t)b * Skv * Hkv + hk) * HD;

  // keys this query tile can see: causal => j <= q0 + kBQ - 1;
  // window => j > q0 - window
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kBQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (kv_lo / kBK) * kBK;
  load_rows<HD, LDA, kBQ, kThreads>(qs, qb, q_stride, q0, Sq);
  if (k_first < kv_hi) {
    load_rows<HD, HD, kBK, kThreads>(raw_k, kb, kv_stride, k_first, Skv);
    load_rows<HD, HD, kBK, kThreads>(raw_v, vb, kv_stride, k_first, Skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads)
    qs[(i / HD) * LDA + i % HD] *= scale;

  // rows g (registers 0, 1) and g + 8 (2, 3) of the warp's 16
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = k_first; k0 < kv_hi; k0 += kBK) {
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; every warp is done with the planes
    split_rows<HD, kBK, kThreads>(kp, raw_k, 1.f);
    split_pairs<HD, kBK, kThreads>(vt, raw_v, 1.f);
    __syncthreads();  // the planes are ready and the raw stage is free
    if (k0 + kBK < kv_hi) {
      load_rows<HD, HD, kBK, kThreads>(raw_k, kb, kv_stride, k0 + kBK, Skv);
      load_rows<HD, HD, kBK, kThreads>(raw_v, vb, kv_stride, k0 + kBK, Skv);
      cp_async_commit();
    }
    // none of the warp's rows sees a key of this tile
    if (wq >= Sq || (causal && k0 > wq + 15) ||
        (window > 0 && k0 + kBK - 1 <= wq - window))
      continue;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    dot_chunked<NK, NS>(
        s, [&](Frag& a, int ks) { frag_raw<LDA>(a, qs, wr, ks, g, t); },
        [&](int ks, int j) { return frag_row<HD>(kp, 8 * j, ks, g, t); });

    const bool interior = wq + 16 <= Sq && k0 + kBK <= Skv &&
                          (!causal || k0 + kBK - 1 <= wq) &&
                          (window <= 0 || k0 > wq + 15 - window);
    if (!interior) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(wq + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1),
                       Sq, Skv, causal, window))
            s[j][e] = -INFINITY;
    }

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a row with no key yet keeps m = -inf; exp(-inf - -inf) would be nan
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p =
              s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_safe);
          s[j][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      corr[r] = isinf(m[r]) ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }

    // the tile's P V as fresh partials, NG column tiles at a time (their
    // chains are independent): acc = acc corr + partial, rounded once
#pragma unroll
    for (int n0 = 0; n0 < NK; n0 += NG) {
      float pv[NG][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        Frag pf;
        frag_acc(pf, s[j]);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const float4 b = frag_pair<HD>(vt, 8 * (n0 + n), j, g, t);
          if (j == 0)
            mma3_tf32_first(pv[n], pf, b);
          else
            mma3_tf32(pv[n], pf, b);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], corr[e >> 1], pv[n][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq + g + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + (((int64_t)b * Sq + qp) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * Sq + qp) * H + h] =
          (isinf(m[r]) ? 0.f : m[r]) + logf(denom);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, cudaStream_t st) {
  auto kern = flash_fwd_kernel<HD>;
  constexpr int bytes = (int)sizeof(float) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, bytes, st>>>(q, k, v, o, lse, Sq, Skv, H, Hkv,
                                      causal, window,
                                      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); o: (B, Sq, H, hd), all f32,
// contiguous, 16-byte aligned; hd in {32, 64, 112, 128}; lse: f32
// (B, Sq, H) or nullptr. Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq, int Skv, int H, int Hkv,
                                      int hd, int causal, int window,
                                      void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kBQ || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32:
      return (int)launch<32>(qf, kf, vf, of, l, B, Sq, Skv, H, Hkv, causal,
                             window, st);
    case 64:
      return (int)launch<64>(qf, kf, vf, of, l, B, Sq, Skv, H, Hkv, causal,
                             window, st);
    case 112:  // zamba2's shared attention block
      return (int)launch<112>(qf, kf, vf, of, l, B, Sq, Skv, H, Hkv, causal,
                              window, st);
    case 128:
      return (int)launch<128>(qf, kf, vf, of, l, B, Sq, Skv, H, Hkv, causal,
                              window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
