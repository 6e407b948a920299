// L2 (bf16): flash attention, backward pass (training), on Hopper's
// tensor cores.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention/kernel_bwd.py: flash_bwd_padded
//   (bodies _dq_kernel and _dkv_kernel), and the GQA handling of their
//   wrapper ops._fa_bwd (K/V repeated to every q-head, per-q-head f32
//   dk/dv summed over the group afterwards),
// for bf16 inputs; flash_attention_bwd.cu keeps serving f32 ones. The
// function is L2's: for q, do, o (B, Sq, H, hd), k, v (B, Skv, Hkv, hd) and
// the forward's f32 lse (B, Sq, H), with D = rowsum(do * o):
//   p  = exp(q k^T scale - lse)   masked as in L1 (causal / window / edges)
//   dv = sum p^T do,  dp = do v^T,  ds = p * (dp - D)
//   dq = ds k scale,  dk = ds^T q scale
// with dk and dv summed over each GQA group, in f32, written once in bf16.
//
// Bound on the H100: operations. A fused backward needs five products per
// unmasked (query, key) pair and q-head, 10 hd flops. At the train path's
// shape (B = 2, S = 4096, H = 32, Hkv = 8, hd = 128, causal) that is
// 0.69 TFLOP for 338 MB of operands and results: 0.70 ms at 989 TFLOP/s
// (bf16) against 0.10 ms at 3.35 TB/s.
// Design: the reference's two passes, each product on wgmma with f32
// accumulators in registers, deterministic (no atomics), no repeated K/V.
//   - the second product of each pass takes p or ds from registers as
//     hi = bf16(x) plus lo = bf16(x - hi), two wgmmas into one
//     accumulator: one bf16 p or ds moves dq/dk by more than the port's
//     bf16 limits allow (PERF.md). With s and dp formed in both passes
//     that is 20 hd flops per pair against the bound's 10 hd: 1.39 ms at
//     the train shape at peak.
//   - both passes run two warpgroups per CTA and no producer warpgroup
//     (at 384 threads ptxas, CUDA 12.9, compiles every role to the
//     launch's 168 registers even after setmaxnreg, and dk/dv then spills
//     and serializes its wgmmas); warp 0 keeps a 3-stage TMA ring full
//     (full/empty mbarriers), refilling a stage as soon as both
//     warpgroups have released it.
//   - dq pass: one CTA per (b, q-head, 128 query rows). Thread 0 loads Q
//     and dO once and K/V tiles of 64 keys through the ring. Warpgroups 0
//     and 1 own 64 rows each: they form D for their rows
//     from o and do (written to D (B, Sq, H) f32 for the second pass),
//     then per tile S = Q K^T and dP = dO V^T (both operands in shared
//     memory), P and dS in registers, and dQ += dS K with K as the
//     transposed operand.
//   - dk/dv pass: one CTA per (b, KV head, 128 keys), two consumer
//     warpgroups of 64 keys. It loops over the group's q-heads and the
//     query tiles (64 rows) that see its keys; warp 0 streams Q, dO
//     (TMA) and the tile's lse and D (loads) through the ring. The
//     products are formed transposed, S^T = K Q^T and dP^T = V dO^T, so
//     the accumulators already hold the A operands of dV += P^T dO and
//     dK += dS^T Q. dK and dV stay in registers and are written once: the
//     GQA sum happens inside the CTA.
//   - causal and window masks are loop bounds; a warpgroup skips a tile
//     none of whose pairs it sees, and masks element by element only on
//     tiles that straddle the diagonal, the window edge or a ragged edge.
//     TMA zero-fills rows past Sq or Skv; nothing is padded or copied.
//   - hd 32 and 112 run as 64 and 128, as in L1: the tensor maps' bound
//     zero-fills the extra columns of Q, K, V and dO, which add nothing to
//     S or dP; D sums hd columns (two threads of a row take hd / 2 each),
//     and the extra columns of dQ, dK and dV are not stored.
#include "attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBig = 128;      // rows a CTA owns: queries (dq), keys (dk/dv)
constexpr int kTile = 64;      // rows of a ring tile: keys (dq), queries
constexpr int kStages = 3;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBigBytes = kBig * kRowBytes;     // 16 KB per box
constexpr int kTileBytes = kTile * kRowBytes;   // 8 KB per box

template <int HDP>
struct Smem {
  static constexpr int NB = HDP / kBoxCols;
  static constexpr int a = 0;                           // Q | K resident
  static constexpr int b = a + NB * kBigBytes;          // dO | V resident
  static constexpr int ra = b + NB * kBigBytes;         // ring: K | Q
  static constexpr int rb = ra + kStages * NB * kTileBytes;   // V | dO
  static constexpr int f = rb + kStages * NB * kTileBytes;    // floats
  static constexpr int bars = f + 2 * kStages * kTile * 4;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HDP>
__device__ __forceinline__ void mma_rs(float (&acc)[HDP / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDP == 128)
    wgmma_rs_n128(acc, a, db);
  else
    wgmma_rs_n64(acc, a, db);
}

// acc (64 x 64) = A (64 rows at `a`) B^T (64 rows at `b`) over HDP
// columns, A in a box of kBig rows, B in a ring box of kTile rows
template <int HDP>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss_n64(acc,
                 desc_sw128(a + (kk / 4) * kBigBytes + (kk % 4) * 32, 16,
                            1024),
                 desc_sw128(b + (kk / 4) * kTileBytes + (kk % 4) * 32, 16,
                            1024),
                 kk > 0);
}

// acc (64 x HDP) += X (64 x 64, registers as hi + lo) M (64 rows of a ring
// box at `m`, the transposed operand)
template <int HDP>
__device__ __forceinline__ void mma_xm(float (&acc)[HDP / 2],
                                       const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4],
                                       uint32_t m) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = desc_sw128(m + kk * 16 * kRowBytes, kTileBytes, 1024);
    mma_rs<HDP>(acc, hi[kk], d);
    mma_rs<HDP>(acc, lo[kk], d);
  }
}

// write rows r0 and r0 + 8 of a 64 x HDP accumulator times `mul` into
// rows of `out` (row stride `stride` elements), columns < hd
template <int HDP>
__device__ __forceinline__ void store_rows(const float (&acc)[HDP / 2],
                                           __nv_bfloat16* out, int64_t row0,
                                           int64_t row8, bool ok0, bool ok8,
                                           int hd, int c0, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!(r ? ok8 : ok0)) continue;
    __nv_bfloat16* p = out + (r ? row8 : row0);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      if (8 * j >= hd) break;
      *reinterpret_cast<uint32_t*>(p + 8 * j + c0) = pack_bf16x2(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// dq pass, and D = rowsum(do * o). Grid (H, query tiles, B); query tiles
// run longest first.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ Dg,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                  int Hkv, int hd, int causal, int window, float scale) {
  using L = Smem<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* Ds = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                       L::f);   // kBig floats
  const uint32_t sq = base + L::a, sdo = base + L::b;
  const uint32_t sk = base + L::ra, sv = base + L::rb;
  const uint32_t qd_full = base + L::bars;
  const uint32_t full0 = qd_full + 8, empty0 = full0 + 8 * kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBig;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q0 + kBig);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kTile;
  const int n_tiles = max(0, (kv_hi + kTile - 1) / kTile - t_lo);

  // thread 0 loads K and V tile `it` into stage it % kStages
  auto load_kv = [&](int it) {
    const int s = it % kStages;
    const int k0 = (t_lo + it) * kTile;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * NB * kTileBytes);
    for (int kb = 0; kb < NB; ++kb) {
      const uint32_t off = (s * NB + kb) * kTileBytes;
      tma_load(sk + off, &tk, full, kb * kBoxCols, hk, k0, b);
      tma_load(sv + off, &tv, full, kb * kBoxCols, hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per warp
    }
    fence_barrier_init();
    mbar_expect_tx(qd_full, 2 * NB * kBigBytes);
    for (int kb = 0; kb < NB; ++kb) {
      tma_load(sq + kb * kBigBytes, &tq, qd_full, kb * kBoxCols, h, q0, b);
      tma_load(sdo + kb * kBigBytes, &tdo, qd_full, kb * kBoxCols, h, q0, b);
    }
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_kv(it);
  }
  __syncthreads();

  {
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qw0 = q0 + 64 * wg;
    const int r0 = qw0 + 16 * (tid / 32) + lane / 4;   // rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;

    // D for this warpgroup's rows: two threads per row, half of hd each
    {
      const int qp = qw0 + tid / 2;
      float part = 0.f;
      if (qp < Sq) {
        const int64_t off = (((int64_t)b * Sq + qp) * H + h) * hd;
        const int half = hd / 2;
        for (int c = (tid % 2) * half; c < (tid % 2 + 1) * half; c += 8) {
          const uint4 ou = *reinterpret_cast<const uint4*>(o + off + c);
          const uint4 du = *reinterpret_cast<const uint4*>(dout + off + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ou);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            part = fmaf(df.x, of.x, part);
            part = fmaf(df.y, of.y, part);
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (tid % 2 == 0) {
        Ds[64 * wg + tid / 2] = part;
        if (qp < Sq) Dg[((int64_t)b * Sq + qp) * H + h] = part;
      }
      named_sync(1 + wg, 128);
    }
    float Dr[2], Lr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      Dr[r] = Ds[qp - q0];
      Lr[r] = qp < Sq ? lse[((int64_t)b * Sq + qp) * H + h] * kLog2e : 0.f;
    }

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

    mbar_wait(qd_full, 0);
    __syncwarp();   // converged for the .aligned wgmma
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = (t_lo + it) * kTile;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      __syncwarp();   // converged for the .aligned wgmma
      if (any_visible(qw0, qw0 + 63, k0, k0 + kTile - 1, Skv, causal,
                      window)) {
        const uint32_t ks = sk + s * NB * kTileBytes;
        const uint32_t vs = sv + s * NB * kTileBytes;
        float sc[32], dp[32];
        wgmma_fence();
        mma_abt<HDP>(sc, sq + wg * 64 * kRowBytes, ks);
        mma_abt<HDP>(dp, sdo + wg * 64 * kRowBytes, vs);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        const bool inner = all_visible(qw0, qw0 + 63, k0, k0 + kTile - 1,
                                       Skv, causal, window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
          const float p =
              inner || visible(r0 + 8 * r, kp, Skv, causal, window)
                  ? exp2f(fmaf(sc[i], sl2, -Lr[r]))
                  : 0.f;
          dp[i] = p * (dp[i] - Dr[r]);
        }
        uint32_t hi[4][4], lo[4][4];
        split_fragments(dp, hi, lo);
        wgmma_fence();
        mma_xm<HDP>(acc, hi, lo, ks);     // dQ += dS K
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // refill this stage once both warpgroups are done with it
      if (threadIdx.x == 0 && it + kStages < n_tiles) {
        mbar_wait(empty0 + 8 * s, (it / kStages) & 1);
        load_kv(it + kStages);
      }
    }

    const int64_t stride = (int64_t)H * hd;
    const int64_t row0 = (((int64_t)b * Sq + r0) * H + h) * hd;
    store_rows<HDP>(acc, dq, row0, row0 + 8 * stride, r0 < Sq, r0 + 8 < Sq,
                    hd, c0, scale);
  }
}

// dk/dv pass. Grid (Hkv, key tiles, B); key tiles run first to last,
// which is longest first under a causal mask.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ Dg,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                   int Hkv, int hd, int causal, int window, float scale) {
  using L = Smem<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // per stage: kTile lse values (times log2 e), then kTile D values
  float* fs = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                       L::f);
  const uint32_t sk = base + L::a, sv = base + L::b;
  const uint32_t sq = base + L::ra, sdo = base + L::rb;
  const uint32_t kv_full = base + L::bars;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * kStages;

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kBig;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  // queries that see this CTA's keys: causal => i >= k0;
  // window => i < j + window <= k0 + kBig - 1 + window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBig - 1 + window) : Sq;
  const int t_lo = q_lo / kTile;
  const int per_head = max(0, (q_hi + kTile - 1) / kTile - t_lo);
  const int n_tiles = group * per_head;

  // warp 0 loads query tile `it` (q-head hk * group + it / per_head) into
  // stage it % kStages: Q and dO by TMA from lane 0, lse (times log2 e)
  // and D by all 32 lanes, each of which arrives on the stage's barrier
  auto load_q = [&](int it) {
    const int lane = threadIdx.x;
    const int s = it % kStages;
    const int h = hk * group + it / per_head;
    const int q0 = (t_lo + it % per_head) * kTile;
    float* ls = fs + s * 2 * kTile;
    for (int r = lane; r < kTile; r += 32) {
      const int qp = q0 + r;
      const int64_t row = ((int64_t)b * Sq + qp) * H + h;
      ls[r] = qp < Sq ? lse[row] * kLog2e : 0.f;
      ls[kTile + r] = qp < Sq ? Dg[row] : 0.f;
    }
    const uint32_t full = full0 + 8 * s;
    if (lane == 0) {
      mbar_expect_tx(full, 2 * NB * kTileBytes);
      for (int kb = 0; kb < NB; ++kb) {
        const uint32_t off = (s * NB + kb) * kTileBytes;
        tma_load(sq + off, &tq, full, kb * kBoxCols, h, q0, b);
        tma_load(sdo + off, &tdo, full, kb * kBoxCols, h, q0, b);
      }
    } else {
      mbar_arrive(full);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);   // warp 0's lanes
      mbar_init(empty0 + 8 * s, 8);   // one arrival per warp
    }
    fence_barrier_init();
    mbar_expect_tx(kv_full, 2 * NB * kBigBytes);
    for (int kb = 0; kb < NB; ++kb) {
      tma_load(sk + kb * kBigBytes, &tk, kv_full, kb * kBoxCols, hk, k0, b);
      tma_load(sv + kb * kBigBytes, &tv, kv_full, kb * kBoxCols, hk, k0, b);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_q(it);

  {
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw0 = k0 + 64 * wg;
    const int r0 = kw0 + 16 * (tid / 32) + lane / 4;   // keys r0, r0 + 8
    const int c0 = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;

    float gk[HDP / 2], gv[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) gk[i] = gv[i] = 0.f;

    mbar_wait(kv_full, 0);
    __syncwarp();   // converged for the .aligned wgmma
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = (t_lo + it % per_head) * kTile;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      __syncwarp();   // converged for the .aligned wgmma
      const int q_last = min(q0 + kTile, Sq) - 1;
      if (any_visible(q0, q_last, kw0, kw0 + 63, Skv, causal, window)) {
        const uint32_t qs = sq + s * NB * kTileBytes;
        const uint32_t dos = sdo + s * NB * kTileBytes;
        const float* ls = fs + s * 2 * kTile;
        // the transposed tile: rows are keys, columns are queries
        float st[32], dpt[32];
        wgmma_fence();
        mma_abt<HDP>(st, sk + wg * 64 * kRowBytes, qs);
        mma_abt<HDP>(dpt, sv + wg * 64 * kRowBytes, dos);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        const bool inner = q0 + kTile <= Sq &&
                           all_visible(q0, q0 + kTile - 1, kw0, kw0 + 63,
                                       Skv, causal, window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kp = r0 + 8 * ((i >> 1) & 1);
          const int qc = 8 * (i >> 2) + c0 + (i & 1);
          const int qp = q0 + qc;
          const float p =
              inner || (qp < Sq && visible(qp, kp, Skv, causal, window))
                  ? exp2f(fmaf(st[i], sl2, -ls[qc]))
                  : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - ls[kTile + qc]);
        }
        uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
        split_fragments(st, phi, plo);
        split_fragments(dpt, dhi, dlo);
        wgmma_fence();
        mma_xm<HDP>(gv, phi, plo, dos);   // dV += P^T dO
        mma_xm<HDP>(gk, dhi, dlo, qs);    // dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(gv);
        fence_regs(gk);
        fence_regs(phi);
        fence_regs(plo);
        fence_regs(dhi);
        fence_regs(dlo);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // refill this stage once both warpgroups are done with it
      if (threadIdx.x < 32 && it + kStages < n_tiles) {
        mbar_wait(empty0 + 8 * s, (it / kStages) & 1);
        load_q(it + kStages);
      }
      __syncwarp();
    }

    const int64_t stride = (int64_t)Hkv * hd;
    const int64_t row0 = (((int64_t)b * Skv + r0) * Hkv + hk) * hd;
    store_rows<HDP>(gk, dk, row0, row0 + 8 * stride, r0 < Skv, r0 + 8 < Skv,
                    hd, c0, scale);
    store_rows<HDP>(gv, dv, row0, row0 + 8 * stride, r0 < Skv, r0 + 8 < Skv,
                    hd, c0, 1.f);
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int H, int Hkv, int hd,
           int causal, int window, cudaStream_t st) {
  constexpr int bytes = Smem<HDP>::bytes;
  const float scale = 1.0f / sqrtf((float)hd);
  using bf16 = __nv_bfloat16;
  // a pass whose loop is empty never loads through the maps of the empty
  // side: with Sq == 0 or Skv == 0 they point at the other side's tensor
  const void* qp = Sq > 0 ? q : k;
  const void* dop = Sq > 0 ? dout : k;
  const void* kp = Skv > 0 ? k : q;
  const void* vp = Skv > 0 ? v : q;
  const int sq = Sq > 0 ? Sq : 1, skv = Skv > 0 ? Skv : 1;
  const int hq = Sq > 0 ? H : Hkv, hkv = Skv > 0 ? Hkv : H;
  if (Sq > 0) {  // with Skv == 0 it writes dq = 0
    CUtensorMap tq, tdo, tk, tv;
    int err = encode_rows(&tq, qp, B, sq, hq, hd, kBig);
    if (!err) err = encode_rows(&tdo, dop, B, sq, hq, hd, kBig);
    if (!err) err = encode_rows(&tk, kp, B, skv, hkv, hd, kTile);
    if (!err) err = encode_rows(&tv, vp, B, skv, hkv, hd, kTile);
    if (err) return err;
    auto kern = flash_bwd_dq_sm90<HDP>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(H, (Sq + kBig - 1) / kBig, B), kThreads, bytes, st>>>(
        tq, tdo, tk, tv, static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), Sq,
        Skv, H, Hkv, hd, causal, window, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (Skv == 0) return 0;  // with Sq == 0 it writes dk = dv = 0
  CUtensorMap tk, tv, tq, tdo;
  int err = encode_rows(&tk, kp, B, skv, hkv, hd, kBig);
  if (!err) err = encode_rows(&tv, vp, B, skv, hkv, hd, kBig);
  if (!err) err = encode_rows(&tq, qp, B, sq, hq, hd, kTile);
  if (!err) err = encode_rows(&tdo, dop, B, sq, hq, hd, kTile);
  if (err) return err;
  auto kern = flash_bwd_dkv_sm90<HDP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  // same stream: the dk/dv pass reads the D that the dq pass wrote
  kern<<<dim3(Hkv, (Skv + kBig - 1) / kBig, B), kThreads, bytes, st>>>(
      tk, tv, tq, tdo, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Sq, Skv, H, Hkv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, Hkv, hd), all
// bf16, contiguous, 16-byte aligned; hd in {32, 64, 112, 128}; lse: f32
// (B, Sq, H) from the forward; D: f32 (B, Sq, H) scratch that the dq pass
// fills. Returns a cudaError_t, or 10000 and above for a tensor map that
// cuTensorMapEncodeTiled refused (attention_sm90.cuh).
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int Sq, int Skv, int H, int Hkv, int hd, int causal, int window,
    void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      window < 0 || Sq > 65535 * kBig || Skv > 65535 * kBig || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  switch (hd) {
    case 32:
    case 64:
      return launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, H,
                        Hkv, hd, causal, window, st);
    case 112:  // zamba2's shared attention block
    case 128:
      return launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Skv, H,
                         Hkv, hd, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
