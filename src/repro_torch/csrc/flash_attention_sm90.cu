// L1 (bf16): flash attention, forward pass, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py: flash_attention_padded
//   (body _kernel, with return_lse), and the padding of its wrapper
//   ops.flash_attention,
// for bf16 inputs; flash_attention.cu keeps serving f32 ones. The function
// is L1's: for q (B, Sq, H, hd), k, v (B, Skv, Hkv, hd), query row i of
// head h attends to key j of KV head h / (H / Hkv) iff
//   (!causal || j <= i) && (window == 0 || j > i - window) && j < Skv,
// softmax(q k^T / sqrt(hd)) v by an online softmax in f32, written in bf16;
// with lse != nullptr (the training forward) also each row's logsumexp
// m + log(max(l, 1e-30)), m := 0 for a row that saw no key, f32
// (B, Sq, H). Serving passes nullptr and does no extra work.
//
// Bound on the H100: operations. At the serve path's prefill shape
// (B = 8, S = 4000, H = 32, Hkv = 8, hd = 128, causal) the call needs
// 4 hd flops per unmasked (query, key) pair and head, 1.05 TFLOP, for
// 655 MB of q/k/v/o: 1.06 ms at 989 TFLOP/s (bf16) against 0.20 ms at
// 3.35 TB/s.
// Design:
//   - both products run on wgmma with f32 accumulators in registers:
//     S = Q K^T with both operands in shared memory (K-major), then
//     O += P V with P from registers and V in shared memory as the
//     transposed (MN-major) operand.
//   - P enters the second product as hi = bf16(p) plus lo = bf16(p - hi),
//     two wgmmas into the same accumulator: P keeps ~16 bits, as the f32
//     product of the reference nearly does; one bf16 P moves the output
//     by more than the port's bf16 limits allow (PERF.md). That is 6 hd
//     flops per pair on the tensor cores, 1.5x the bound's 4 hd.
//   - one CTA of two warpgroups per (b, head, 128 query rows); each owns
//     64 query rows (wgmma's M) and keeps m, l and the 64 x hd accumulator
//     in registers. Thread 0 issues the TMA loads: Q once, then K and V
//     tiles of 128 keys through a 3-stage ring guarded by full and empty
//     mbarriers, refilling a stage as soon as both warpgroups have
//     released it. At hd 128 shared memory holds Q 32 KB + 3 x (32 + 32)
//     KB. There is no producer warpgroup: ptxas (CUDA 12.9) compiles every
//     role of a 384-thread kernel to the launch's 168 registers even
//     after setmaxnreg, and the consumers then spill; at 256 threads each
//     consumer thread may hold up to 255.
//   - tiles are 64-column boxes in TMA's 128-byte swizzle (one box per 64
//     columns of hd), which is wgmma's canonical layout; hd 32 and 112
//     run as 64 and 128 with the extra columns zero-filled by the tensor
//     map's bound (they add nothing to S; O's are not stored).
//   - head is the fastest grid axis, so a GQA group's CTAs read the same
//     K/V tiles through L2; query tiles run longest first.
//   - causal and window masks are loop bounds (the first and last KV tile
//     a query tile needs); only tiles that straddle the diagonal, the
//     window edge or the ragged Skv edge mask element by element. TMA
//     zero-fills rows past Sq or Skv; keys past Skv are masked, rows past
//     Sq not stored. Nothing is padded or copied.
#include "attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;               // query rows per CTA
constexpr int kBK = 128;               // keys per tile
constexpr int kStages = 3;
constexpr int kThreads = 256;          // two warpgroups
constexpr int kBoxBytes = 128 * kRowBytes;   // one 128-row box: 16 KB
static_assert(kBQ == 128 && kBK == 128, "boxes hold 128 rows");

template <int HDP>
struct Smem {
  static constexpr int NB = HDP / kBoxCols;    // boxes per tile
  static constexpr int q = 0;
  static constexpr int k = q + NB * kBoxBytes;
  static constexpr int v = k + kStages * NB * kBoxBytes;
  static constexpr int bars = v + kStages * NB * kBoxBytes;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HDP>
__device__ __forceinline__ void mma_pv(float (&acc)[HDP / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDP == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n64(acc, a, db);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
               int Skv, int H, int Hkv, int hd, int causal, int window,
               float scale) {
  using L = Smem<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t q_full = base + L::bars;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // keys this query tile can see: causal => j < q0 + kBQ;
  // window => j > q0 - window
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kBQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kBK;
  const int n_tiles = max(0, (kv_hi + kBK - 1) / kBK - t_lo);

  // thread 0 loads K and V tile `it` into stage it % kStages
  auto load_kv = [&](int it) {
    const int s = it % kStages;
    const int k0 = (t_lo + it) * kBK;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * NB * kBoxBytes);
    for (int kb = 0; kb < NB; ++kb) {
      const uint32_t off = (s * NB + kb) * kBoxBytes;
      tma_load(sk + off, &tk, full, kb * kBoxCols, hk, k0, b);
      tma_load(sv + off, &tv, full, kb * kBoxCols, hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per warp
    }
    fence_barrier_init();
    mbar_expect_tx(q_full, NB * kBoxBytes);
    for (int kb = 0; kb < NB; ++kb)
      tma_load(sq + kb * kBoxBytes, &tq, q_full, kb * kBoxCols, h, q0, b);
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_kv(it);
  }
  __syncthreads();

  {
    // warpgroup wg owns query rows qw0 .. qw0 + 63; this thread holds rows
    // r0 and r0 + 8, columns c0, c0 + 1 of every 8
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;
    const int r0 = qw0 + 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    __syncwarp();   // converged for the .aligned wgmma
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = (t_lo + it) * kBK;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      __syncwarp();   // converged for the .aligned wgmma
      const uint32_t ks = sk + s * NB * kBoxBytes;
      const uint32_t vs = sv + s * NB * kBoxBytes;

      // S = Q K^T over hd, in 16-column k-steps
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc,
                      desc_sw128(sq + off + wg * 64 * kRowBytes, 16, 1024),
                      desc_sw128(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if (!all_visible(qw0, qw0 + 63, k0, k0 + kBK - 1, Skv, causal,
                       window)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int qp = r0 + 8 * ((i >> 1) & 1);
          const int kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
          if (!visible(qp, kp, Skv, causal, window)) sc[i] = -INFINITY;
        }
      }
      // online softmax on the accumulator: a row's 4 threads are a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale);
        // a row with no key yet keeps m = -inf; exp(-inf - -inf) is nan
        const float m_safe = isinf(m_new) ? 0.f : m_new;
        corr[r] = isinf(m[r]) ? 0.f : exp2f((m[r] - m_safe) * kLog2e);
        m[r] = m_new;
        l[r] *= corr[r];
        mb[r] = m_safe * kLog2e;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p =
            sc[i] == -INFINITY ? 0.f : exp2f(fmaf(sc[i], sl2, -mb[r]));
        sc[i] = p;
        l[r] += p;
      }
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V with P = hi + lo
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
      split_fragments(sc, ph, pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv =
            desc_sw128(vs + kk * 16 * kRowBytes, kBoxBytes, 1024);
        mma_pv<HDP>(acc, ph[kk], dv);
        mma_pv<HDP>(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // refill this stage once both warpgroups are done with it
      if (threadIdx.x == 0 && it + kStages < n_tiles) {
        mbar_wait(empty0 + 8 * s, (it / kStages) & 1);
        load_kv(it + kStages);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      if (qp >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / denom;
      const int64_t row = ((int64_t)b * Sq + qp) * H + h;
      __nv_bfloat16* orow = o + row * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        if (8 * j >= hd) break;
        *reinterpret_cast<uint32_t*>(orow + 8 * j + c0) = pack_bf16x2(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
      if (lse != nullptr && lane % 4 == 0)
        lse[row] = (isinf(m[r]) ? 0.f : m[r]) + logf(denom);
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int Hkv, int hd, int causal,
           int window, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  // with Skv == 0 no K/V tile is ever loaded: the maps point at q
  const void* kp = Skv > 0 ? k : q;
  const void* vp = Skv > 0 ? v : q;
  const int S_kv = Skv > 0 ? Skv : 1;
  int err = encode_rows(&tq, q, B, Sq, H, hd, kBQ);
  if (!err) err = encode_rows(&tk, kp, B, S_kv, Hkv, hd, kBK);
  if (!err) err = encode_rows(&tv, vp, B, S_kv, Hkv, hd, kBK);
  if (err) return err;
  auto kern = flash_fwd_sm90<HDP>;
  constexpr int bytes = Smem<HDP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  kern<<<grid, kThreads, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, Hkv, hd,
      causal, window, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); o: (B, Sq, H, hd), all bf16,
// contiguous, 16-byte aligned; hd in {32, 64, 112, 128}; lse: f32
// (B, Sq, H) or nullptr. Returns a cudaError_t, or 10000 and above for a
// tensor map that cuTensorMapEncodeTiled refused (attention_sm90.cuh).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int Sq, int Skv, int H,
                                           int Hkv, int hd, int causal,
                                           int window, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kBQ || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32:
    case 64:
      return launch<64>(q, k, v, o, l, B, Sq, Skv, H, Hkv, hd, causal,
                        window, st);
    case 112:  // zamba2's shared attention block
    case 128:
      return launch<128>(q, k, v, o, l, B, Sq, Skv, H, Hkv, hd, causal,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
