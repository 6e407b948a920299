// B1: per-row Gibbs sufficient statistics with the gather inside the kernel.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/bmf_precision/kernel.py: precision_accum_fused_padded
//   (body _fused_kernel).
// For every row n of a stacked batch of padded-CSR planes
//     Lam[n] = tau * sum_m w_m v_m v_m^T,   eta[n] = tau * sum_m w_m r_m v_m
// with v_m = other[b][idx[n, m]] gathered here: no (N, M, K) tensor exists.
// Slots at or past a row's live length are never read (they take the place
// of tile_occupancy's skipped M tiles); Lam, full and symmetric, and eta
// are written once.
//
// K <= 16 (precision_row_kernel, one instantiation per K): one thread owns
// a row. Bound on Hopper: bytes (at the MovieLens-20M phase-c bucket, K =
// 10, ~0.1 ms of traffic, half of it Lam's write, against ~0.03 ms of f32
// fmas). The thread adds its live slots in slot order into Lam's lower
// triangle and eta in registers: bmf_common.cuh's bmf_row_accum, the
// accumulate of B2. The first design put a warp on a row and a lane on a
// column: at K = 10 20 of 32 lanes worked and every pair of slots cost 19
// shuffles (0.95-1.02 ms at the bucket). A thread's Lam is K * K
// contiguous floats, so 32 lanes storing their own rows would touch 32
// sectors per instruction: the warp stages stage_lanes(K) rows at a time
// in shared memory and writes each staged span with coalesced 16-byte
// stores.
//
// 16 < K <= 128 (precision_gram_kernel): Lam = tau (w . V)^T V on the
// tensor cores, V a row's gathered (live, K) factor rows, K zero-padded to
// KP = 16 NB. On the CUDA cores the 2 K^2 flops per slot would bound it
// (K = 100 at the Netflix-shape bucket: ~1.3 ms against ~0.66 ms of
// bytes); on the tensor cores the bytes do, three quarters of them Lam's
// write. Persistent blocks of 4 consumer warps and a producer warp walk
// their rows as one stream of 32-slot chunks through a ring of kStages
// stages:
//   - the producer loads the slots' index, weight and value a chunk
//     ahead and copies each live slot's factor row into the stage by the
//     TMA (rows padded by the wrapper to a multiple of 16 bytes; w = 0
//     zero-filled), the stage's mbarrier counting the bytes; cp.async,
//     from each consumer warp in turn and then from the producer, held
//     the issue queue that the consumers' fragment loads share;
//   - the consumers add mma.sync products over 8 (f32) or 16 (bf16) slots
//     into the 16 x 16 tiles of Lam's lower triangle, spread over the
//     warps by plan() so that each loads the fragments of at most 5 column
//     blocks, every fragment serving as both operands (the A fragment of a
//     block's rows holds the elements of the B fragments of its columns);
//     f32 factors run 3xTF32, x = hi + lo with each product lo.hi + hi.lo
//     + hi.hi (~2^-22 relative; one TF32 rounding misses the 1e-5
//     contract); bf16 factors are exact in bf16, so one bf16 product is
//     exact for 0/1 weights, and a chunk holding another weight scales A
//     by w in f32 and splits it bf16 hi + lo (two products); eta is a
//     CUDA-core side sum, one thread per two columns, in slot order;
//   - at a row's last chunk Lam goes through shared memory (each tile and
//     its mirror, cropped to K) and out as one contiguous span in 16-byte
//     streaming stores: from the accumulators, 8 scattered sectors per
//     store, it took 2 of ~3 ms at the Netflix-shape bucket.
// The measurements behind each choice are in PERF.md.
#include <algorithm>
#include <type_traits>
#include <utility>

#include "bmf_common.cuh"
#include "mma_split.cuh"

namespace {

template <typename T>
struct PrecArgs {
  const int32_t* idx;
  const float* val;
  const float* mask;
  const int32_t* live;
  const T* other;
  float* lam;
  float* eta;
  int64_t rows;
  int N, M, D, K;
  int ldo;    // elements between the factor's rows (>= K)
  float tau;
  int vec4;   // M % 4 == 0 and the planes 16-byte aligned
};

// ---------------------------------------------------------------------------
// K <= 16: one thread per row
// ---------------------------------------------------------------------------

// 8 warps a block, as B2: 0.349-0.385 ms at the MovieLens-20M bucket in
// f32 against 0.376-0.390 with 128 threads (PERF.md)
constexpr int kRowThreads = 256;
constexpr int kRowK = 16;
constexpr int kStageFloats = 1024;   // one warp's staging buffer, 4 KB

// rows a warp stages at once: the most, a power of two, whose Lam fit
__host__ __device__ constexpr int stage_lanes(int K) {
  int l = 32;
  while (l > 4 && l * K * K > kStageFloats) l /= 2;
  return l;
}

// entry e of the row-major K x K Lam in the lower triangle tri()
__host__ __device__ constexpr int sym(int K, int e) {
  return e / K >= e % K ? tri(e / K, e % K) : tri(e % K, e / K);
}

// d[0 .. n) = s[0 .. n) by one warp, d and s 16-byte aligned
__device__ __forceinline__ void warp_copy(float* __restrict__ d,
                                          const float* __restrict__ s, int n,
                                          int lane) {
  const int n4 = n >> 2;
  for (int i = lane; i < n4; i += 32)
    reinterpret_cast<float4*>(d)[i] = reinterpret_cast<const float4*>(s)[i];
  for (int i = 4 * n4 + lane; i < n; i += 32) d[i] = s[i];
}

// d[0 .. K * K) = tau * Lam, row-major, from the triangle
template <int K>
__device__ __forceinline__ void put_lam(float* __restrict__ d, float tau,
                                        const float (&lam)[K * (K + 1) / 2]) {
  if constexpr (K % 2 == 0) {   // K * K % 4 == 0: 16-byte stores
#pragma unroll
    for (int e = 0; e < K * K; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(tau * lam[sym(K, e)], tau * lam[sym(K, e + 1)],
                      tau * lam[sym(K, e + 2)], tau * lam[sym(K, e + 3)]);
  } else {
#pragma unroll
    for (int e = 0; e < K * K; ++e) d[e] = tau * lam[sym(K, e)];
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(kRowThreads)
precision_row_kernel(const PrecArgs<T> a) {
  constexpr int KK = K * K;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowThreads + threadIdx.x;
  const int64_t r0 = row - lane;      // the warp's first row
  if (r0 >= a.rows) return;           // uniform per warp
  const bool on = row < a.rows;
  const int64_t rr = on ? row : r0;
  float lam[K * (K + 1) / 2], eta[K];
  // K = 15, 16: one factor row and one slot at a time keep the triangle
  // in registers
  bmf_row_accum<K, T, K <= 12 ? 4 : K <= 14 ? 2 : 1>(
      a.other + (rr / a.N) * (int64_t)a.D * K, a.idx + rr * a.M,
      a.val + rr * a.M, a.mask + rr * a.M, on ? a.live[row] : 0,
      K <= 14 ? a.vec4 : 0, lam, eta);
  // a warp's 32 rows of Lam (then of eta) are one contiguous span; each
  // lane storing its own row took 0.62 against 0.35-0.39 ms (PERF.md)
  __shared__ __align__(16) float stage[kRowThreads / 32][kStageFloats];
  float* st = stage[threadIdx.x >> 5];
  const int nv = a.rows - r0 < 32 ? (int)(a.rows - r0) : 32;
  constexpr int SL = stage_lanes(K);
#pragma unroll 1
  for (int p = 0; p < 32; p += SL) {
    if (lane >= p && lane < p + SL) put_lam<K>(st + (lane - p) * KK, a.tau,
                                               lam);
    __syncwarp();
    warp_copy(a.lam + (r0 + p) * KK, st, max(0, min(SL, nv - p)) * KK, lane);
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < K; ++i) st[lane * K + i] = a.tau * eta[i];
  __syncwarp();
  warp_copy(a.eta + r0 * K, st, nv * K, lane);
}

template <int K, typename T>
void launch_rows(const PrecArgs<T>& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.rows + kRowThreads - 1) / kRowThreads));
  precision_row_kernel<K, T><<<grid, kRowThreads, 0, st>>>(a);
}

template <typename T, int... Ks>
void dispatch_rows(const PrecArgs<T>& a, cudaStream_t st,
                   std::integer_sequence<int, Ks...>) {
  (void)((a.K == Ks + 1 ? (launch_rows<Ks + 1, T>(a, st), true) : false) ||
         ...);
}

// ---------------------------------------------------------------------------
// 16 < K <= 128: one block per row, Lam's lower triangle on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kGramWarps = 4;                 // consumer warps
constexpr int kGramThreads = 32 * kGramWarps;  // consumer threads
constexpr int kChunk = 32;          // slots per pipeline stage (one per lane)
constexpr int kStages = 3;          // chunks in the ring
constexpr int kBarSlots = (kStages + 1) / 2 * 2;   // 16-byte multiple
constexpr int kMaxBlk = 5, kMaxTiles = 9;

// What warp w computes of Lam's NB x NB grid of 16 x 16 tiles: it loads the
// fragments of the column blocks blk[0 .. nb) and accumulates the nt lower
// tiles (rows blk[a[q]], columns blk[b[q]]). The table came from a search
// for the fewest block loads with the tiles balanced and at most kMaxBlk
// blocks a warp (NB = 7: 17 in all, NB = 8: 19); plan_covers checks it.
// Dealing the tiles greedily at compile time (bottom row first, each to
// the warp it adds the fewest blocks to) loads 18 and 20 and ran 2-4%
// slower at K = 100 (PERF.md).
struct WarpPlan {
  int nb;
  int blk[kMaxBlk];
  int nt;
  int a[kMaxTiles];
  int b[kMaxTiles];
};

__host__ __device__ constexpr WarpPlan plan(int NB, int w) {
  switch (NB) {
    case 2:  // 3 tiles, 4 block loads
      switch (w) {
        case 0: return {2, {0, 1}, 1, {1}, {0}};
        case 1: return {1, {1}, 1, {0}, {0}};
        case 2: return {1, {0}, 1, {0}, {0}};
        case 3: return {0, {}, 0, {}, {}};
      }
      break;
    case 3:  // 6 tiles, 7 block loads
      switch (w) {
        case 0: return {2, {1, 2}, 2, {0, 1}, {0, 0}};
        case 1: return {2, {0, 2}, 1, {1}, {0}};
        case 2: return {1, {2}, 1, {0}, {0}};
        case 3: return {2, {0, 1}, 2, {0, 1}, {0, 0}};
      }
      break;
    case 4:  // 10 tiles, 9 block loads
      switch (w) {
        case 0: return {2, {1, 2}, 2, {0, 1}, {0, 0}};
        case 1: return {3, {0, 1, 3}, 3, {1, 2, 2}, {0, 0, 1}};
        case 2: return {2, {0, 2}, 2, {0, 1}, {0, 0}};
        case 3: return {2, {2, 3}, 3, {0, 1, 1}, {0, 0, 1}};
      }
      break;
    case 5:  // 15 tiles, 12 block loads
      switch (w) {
        case 0: return {3, {0, 1, 2}, 4, {1, 1, 2, 2}, {0, 1, 1, 2}};
        case 1: return {3, {1, 3, 4}, 3, {1, 2, 2}, {0, 0, 1}};
        case 2: return {3, {0, 2, 4}, 4, {0, 2, 2, 2}, {0, 0, 1, 2}};
        case 3: return {3, {0, 2, 3}, 4, {1, 2, 2, 2}, {0, 0, 1, 2}};
      }
      break;
    case 6:  // 21 tiles, 14 block loads
      switch (w) {
        case 0: return {4, {1, 2, 3, 5}, 6, {0, 1, 2, 3, 3, 3}, {0, 0, 0, 0, 1, 2}};
        case 1: return {4, {0, 1, 4, 5}, 6, {1, 2, 2, 3, 3, 3}, {0, 0, 1, 0, 2, 3}};
        case 2: return {3, {0, 2, 3}, 4, {0, 1, 1, 2}, {0, 0, 1, 0}};
        case 3: return {3, {2, 3, 4}, 5, {1, 1, 2, 2, 2}, {0, 1, 0, 1, 2}};
      }
      break;
    case 7:  // 28 tiles, 17 block loads
      switch (w) {
        case 0: return {5, {0, 2, 3, 5, 6}, 7, {2, 2, 2, 3, 3, 4, 4}, {0, 1, 2, 0, 1, 2, 3}};
        case 1: return {4, {0, 1, 2, 6}, 7, {1, 1, 2, 2, 3, 3, 3}, {0, 1, 1, 2, 0, 1, 3}};
        case 2: return {4, {1, 3, 4, 5}, 7, {1, 2, 2, 3, 3, 3, 3}, {0, 0, 1, 0, 1, 2, 3}};
        case 3: return {4, {0, 2, 4, 6}, 7, {0, 1, 2, 2, 2, 3, 3}, {0, 0, 0, 1, 2, 1, 2}};
      }
      break;
    case 8:  // 36 tiles, 19 block loads
      switch (w) {
        case 0: return {5, {1, 2, 3, 4, 5}, 9, {0, 1, 2, 2, 2, 3, 3, 4, 4}, {0, 0, 0, 1, 2, 0, 2, 0, 2}};
        case 1: return {5, {0, 1, 3, 6, 7}, 9, {0, 1, 2, 3, 3, 3, 4, 4, 4}, {0, 0, 0, 0, 1, 2, 1, 2, 3}};
        case 2: return {5, {0, 2, 4, 5, 7}, 9, {1, 2, 2, 3, 4, 4, 4, 4, 4}, {0, 0, 2, 0, 0, 1, 2, 3, 4}};
        case 3: return {4, {2, 4, 5, 6}, 9, {0, 1, 2, 2, 2, 3, 3, 3, 3}, {0, 0, 0, 1, 2, 0, 1, 2, 3}};
      }
      break;
  }
  return {0, {}, 0, {}, {}};
}

// every lower tile (I >= J) of the NB x NB grid exactly once
__host__ __device__ constexpr bool plan_covers(int NB) {
  int seen[8][8] = {};
  for (int w = 0; w < kGramWarps; ++w) {
    const WarpPlan p = plan(NB, w);
    if (p.nb > kMaxBlk || p.nt > kMaxTiles) return false;
    for (int q = 0; q < p.nt; ++q) {
      const int I = p.blk[p.a[q]], J = p.blk[p.b[q]];
      if (I < J || I >= NB) return false;
      ++seen[I][J];
    }
  }
  for (int I = 0; I < NB; ++I)
    for (int J = 0; J <= I; ++J)
      if (seen[I][J] != 1) return false;
  return true;
}
static_assert(plan_covers(2) && plan_covers(3) && plan_covers(4) &&
                  plan_covers(5) && plan_covers(6) && plan_covers(7) &&
                  plan_covers(8),
              "a Gram plan misses or repeats a tile");

// the staging's row stride: >= K, 4 mod 8 (16-byte rows; the mirror
// writes, 8 t + g, hit 32 banks)
__host__ __device__ constexpr int stage_stride(int K) {
  return (K + 3) / 8 * 8 + 4;
}

// shared memory (GramSmem): kStages chunks of gathered rows (stride KP + 8
// elements: conflict-free fragment loads), their w and w r, the stages'
// mbarriers and the staging of a finished row's Lam (K x stage_stride(K)
// floats)
template <typename T>
int gram_smem_bytes(int NB, int K) {
  return kStages * kChunk * (16 * NB + 8) * (int)sizeof(T) +
         2 * kStages * kChunk * 4 + kBarSlots * 8 + K * stage_stride(K) * 4;
}

// the gathered factor stays in L2 (evict_last): each of its rows is read
// ~70 times at the Netflix-shape bucket while ~2 GB of Lam stream past
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma(d, a, b);
}

// f(q, j) for every tile q of warp W's plan whose rows are its block i
// (j: the block of its columns)
template <int NB, int W, typename F>
__device__ __forceinline__ void for_row_tiles(int i, F&& f) {
  constexpr WarpPlan P = plan(NB, W);
#pragma unroll
  for (int q = 0; q < P.nt; ++q)
    if (P.a[q] == i) f(q, P.b[q]);
}

// One chunk of f32 factor rows (tile: kChunk x SP): 8-slot steps of
// m16n8k8 TF32 products, each split 3x. Lane 4 g + t loads, per block i,
// x = V[s + t][16 i + g], V[s + t][16 i + g + 8], V[s + t + 4][16 i + g],
// V[s + t + 4][16 i + g + 8]: its A fragment of rows 16 i.. (k) by slots,
// and, as (x0, x2) and (x1, x3), its B fragments of columns 16 i.. and
// 16 i + 8... A (the rows) is scaled by w unless every w is 0 or 1.
template <int NB, int W, bool BIN>
__device__ __forceinline__ void gram_chunk(const float* __restrict__ tl,
                                           const float* __restrict__ w,
                                           int n_in, int g, int t,
                                           float (&acc)[kMaxTiles][2][4]) {
  constexpr WarpPlan P = plan(NB, W);
  constexpr int SP = 16 * NB + 8;
#pragma unroll 1
  for (int s0 = 0; s0 < n_in; s0 += 8) {
    const float* base = tl + (s0 + t) * SP + g;
    uint32_t bh[P.nb][4], bl[P.nb][4];
#pragma unroll
    for (int i = 0; i < P.nb; ++i) {
      const float* p = base + 16 * P.blk[i];
      split_tf32(p[0], bh[i][0], bl[i][0]);
      split_tf32(p[8], bh[i][1], bl[i][1]);
      split_tf32(p[4 * SP], bh[i][2], bl[i][2]);
      split_tf32(p[4 * SP + 8], bh[i][3], bl[i][3]);
    }
    if constexpr (BIN) {
      // three passes, each of independent products: lo.hi, hi.lo, hi.hi
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int q = 0; q < P.nt; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int I = P.a[q], J = P.b[q];
            if (pass == 0) mma_tf32(acc[q][h], bl[I], bh[J][h], bh[J][2 + h]);
            if (pass == 1) mma_tf32(acc[q][h], bh[I], bl[J][h], bl[J][2 + h]);
            if (pass == 2) mma_tf32(acc[q][h], bh[I], bh[J][h], bh[J][2 + h]);
          }
    } else {
      const float w0 = w[s0 + t], w1 = w[s0 + t + 4];
#pragma unroll
      for (int i = 0; i < P.nb; ++i) {
        const float* p = base + 16 * P.blk[i];
        uint32_t ah[4], al[4];
        split_tf32(w0 * p[0], ah[0], al[0]);
        split_tf32(w0 * p[8], ah[1], al[1]);
        split_tf32(w1 * p[4 * SP], ah[2], al[2]);
        split_tf32(w1 * p[4 * SP + 8], ah[3], al[3]);
        for_row_tiles<NB, W>(i, [&](int q, int J) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_tf32(acc[q][h], al, bh[J][h], bh[J][2 + h]);
            mma_tf32(acc[q][h], ah, bl[J][h], bl[J][2 + h]);
            mma_tf32(acc[q][h], ah, bh[J][h], bh[J][2 + h]);
          }
        });
      }
    }
  }
}

// One chunk of bf16 factor rows: 16-slot steps of m16n8k16 products. One
// ldmatrix.trans per block gives lane 4 g + t the pairs (V[s + 2t][k],
// V[s + 2t + 1][k]) for k = 16 i + g, + 8 and slots + 8: its A fragment,
// and its B fragments as (r0, r2) and (r1, r3). Exact for 0/1 weights;
// otherwise A = w . V in f32, split bf16 hi + lo.
template <int NB, int W, bool BIN>
__device__ __forceinline__ void gram_chunk(
    const __nv_bfloat16* __restrict__ tl, const float* __restrict__ w,
    int n_in, int g, int t, float (&acc)[kMaxTiles][2][4]) {
  constexpr WarpPlan P = plan(NB, W);
  constexpr int SP = 16 * NB + 8;
  const int lane = 4 * g + t;
#pragma unroll 1
  for (int s0 = 0; s0 < n_in; s0 += 16) {
    uint32_t r[P.nb][4];
#pragma unroll
    for (int i = 0; i < P.nb; ++i)
      ldsm_x4_trans(r[i], tl + (s0 + ((lane >> 4) << 3) + (lane & 7)) * SP +
                              16 * P.blk[i] + ((lane >> 3) & 1) * 8);
    if constexpr (BIN) {
#pragma unroll
      for (int q = 0; q < P.nt; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_bf16(acc[q][h], r[P.a[q]], r[P.b[q]][h], r[P.b[q]][2 + h]);
    } else {
      const float2 w0 = make_float2(w[s0 + 2 * t], w[s0 + 2 * t + 1]);
      const float2 w1 = make_float2(w[s0 + 2 * t + 8], w[s0 + 2 * t + 9]);
#pragma unroll
      for (int i = 0; i < P.nb; ++i) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = widen(r[i][e]);
          const float2 ws = e < 2 ? w0 : w1;
          split2(ws.x * v.x, ws.y * v.y, hi[e], lo[e]);
        }
        for_row_tiles<NB, W>(i, [&](int q, int J) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(acc[q][h], lo, r[J][h], r[J][2 + h]);
            mma_bf16(acc[q][h], hi, r[J][h], r[J][2 + h]);
          }
        });
      }
    }
  }
}

// columns c, c + 1 of a stage row (c even: one 8- or 4-byte load)
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint32_t*>(p));
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same<T, float>::value) return 0.f;
  else return __float2bfloat16(0.f);
}

// A block walks its rows blockIdx.x, + gridDim.x, ... as one stream of
// chunks, max(1, ceil(live / kChunk)) per row; a cursor is a position in
// it, with the live length of the row after its row loaded a row early
struct Cursor {
  int64_t row;   // >= rows: past the end
  int c;         // chunk of the row
  int n;         // the row's live length
  int n_next;    // the next row's
};

__device__ __forceinline__ int live_of(const int32_t* live, int64_t row,
                                       int64_t rows) {
  return row < rows ? __ldg(live + row) : 0;
}

__device__ __forceinline__ void advance(Cursor& p, const int32_t* live,
                                        int64_t rows) {
  if ((p.c + 1) * kChunk < p.n) {
    ++p.c;
    return;
  }
  p.row += gridDim.x;
  p.c = 0;
  p.n = p.n_next;
  p.n_next = live_of(live, p.row + gridDim.x, rows);
}

// tau Lam of the finished row from the accumulators into the staging
// (K x S floats): each lower tile and its mirror, cropped to K (a
// diagonal tile's lower half only, so Lam is exactly symmetric)
template <int NB, int W>
__device__ __forceinline__ void stage_lam(float* __restrict__ stg, int K,
                                          int S, float tau, int g, int t,
                                          const float (&acc)[kMaxTiles][2][4]) {
  constexpr WarpPlan P = plan(NB, W);
#pragma unroll
  for (int q = 0; q < P.nt; ++q) {
    const int I = P.blk[P.a[q]], J = P.blk[P.b[q]];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e2 = 0; e2 < 4; e2 += 2) {
        // columns c, c + 1 of row r: one 8-byte store where both are kept
        const int r = 16 * I + g + 4 * e2;
        const int c = 16 * J + 8 * h + 2 * t;
        const float v0 = tau * acc[q][h][e2], v1 = tau * acc[q][h][e2 + 1];
        const bool k0 = r < K && c < K && (I != J || r >= c);
        const bool k1 = r < K && c + 1 < K && (I != J || r >= c + 1);
        if (k0 && k1) {
          *reinterpret_cast<float2*>(stg + r * S + c) = make_float2(v0, v1);
        } else {
          if (k0) stg[r * S + c] = v0;
          if (k1) stg[r * S + c + 1] = v1;
        }
        if (k0) stg[c * S + r] = v0;
        if (k1) stg[(c + 1) * S + r] = v1;
      }
  }
}

// K x K floats of the staging to L as one contiguous span, 16-byte
// streaming stores when K % 4 == 0: each warp store is 512 contiguous bytes
// (a row of Lam, 4 K bytes, is only 16-byte aligned: a warp per row leaves
// sectors half written across warps). Lam is read once, by the next
// kernel, and should not push the gathered factor out of L2. `magic` =
// ceil(2^32 / K): f / K = umulhi(f, magic) for f < 2^32 / K.
__device__ __forceinline__ void write_lam(float* __restrict__ L,
                                          const float* __restrict__ stg,
                                          int K, int S, unsigned magic,
                                          int tid) {
  if (K % 4 == 0) {
    for (int e = tid; e < K * K / 4; e += kGramThreads) {
      const int f = 4 * e, k = (int)__umulhi((unsigned)f, magic);
      __stcs(reinterpret_cast<float4*>(L) + e,
             *reinterpret_cast<const float4*>(stg + k * S + f - k * K));
    }
  } else {
    for (int f = tid; f < K * K; f += kGramThreads) {
      const int k = (int)__umulhi((unsigned)f, magic);
      __stcs(L + f, stg[k * S + f - k * K]);
    }
  }
}

// named barriers (0 is the block's): empty[s] = 1 + s, and one for the
// consumer warps alone
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

constexpr int kEmpty = 1, kConsumerBar = 1 + kStages;

// The factor rows are gathered by the TMA, one bulk copy per row (its
// bytes a multiple of 16: the wrapper pads the rows, `ldo`), completion
// counted in bytes on the stage's mbarrier (full). cp.async, 16 bytes per
// lane and copy, ran 10% slower at K = 100 in f32 and, in 8-byte copies
// for bf16's 200-byte rows, held the issue queue that the consumers'
// ldmatrix shares (PERF.md).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one row of `bytes` (a multiple of 16) by the TMA, L2 keeping the line
__device__ __forceinline__ void tma_row(void* dst, const void* src,
                                        unsigned bytes, uint64_t* bar,
                                        uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(pol)
      : "memory");
}

template <typename T>
struct GramSmem {
  T* tile;       // [kStages][kChunk][SP]: the chunks' gathered rows
  float* sw;     // [kStages][kChunk]: w
  float* swr;    // [kStages][kChunk]: w r
  float* stg;    // [K][S]: tau Lam of a finished row
  uint64_t* bar; // [kStages]: the TMA's full barriers
};

template <int NB, typename T>
__device__ __forceinline__ GramSmem<T> gram_smem(unsigned char* smem) {
  constexpr int SP = 16 * NB + 8;
  GramSmem<T> m;
  m.tile = reinterpret_cast<T*>(smem);
  m.sw = reinterpret_cast<float*>(smem + kStages * kChunk * SP * sizeof(T));
  m.swr = m.sw + kStages * kChunk;
  m.bar = reinterpret_cast<uint64_t*>(m.swr + kStages * kChunk);
  m.stg = reinterpret_cast<float*>(m.bar + kBarSlots);
  return m;
}

// The producer warp walks the block's chunks: lane s loads slot s's index,
// weight and value (the next chunk's, a chunk ahead); once the consumers
// released stage i % kStages, lane s copies slot s's factor row into it
// by the TMA (w = 0: zero-filled instead) and lane 0 sets the bytes the
// stage's full barrier waits for.
template <int NB, typename T>
__device__ __forceinline__ void gram_producer(const PrecArgs<T>& a,
                                              const GramSmem<T>& m,
                                              int lane) {
  constexpr int SP = 16 * NB + 8;
  const int64_t rows = a.rows;
  const int bytes = a.ldo * (int)sizeof(T);   // a multiple of 16
  const uint64_t pol = l2_evict_last();
  auto fetch = [&](const Cursor& p, int& j, float& w, float& r) {
    const int s = p.c * kChunk + lane;
    j = 0;
    w = r = 0.f;
    if (p.row < rows && s < p.n) {
      const int64_t o = p.row * a.M + s;
      j = __ldg(a.idx + o);
      w = __ldg(a.mask + o);
      r = __ldg(a.val + o);
    }
  };
  const int64_t r0 = blockIdx.x;
  Cursor p{r0, 0, live_of(a.live, r0, rows),
           live_of(a.live, r0 + gridDim.x, rows)};
  int j, jn;
  float w, r, wn, rn;
  fetch(p, j, w, r);
  int i = 0;
  for (; p.row < rows; ++i) {
    Cursor nx = p;
    advance(nx, a.live, rows);
    fetch(nx, jn, wn, rn);
    const int st = i % kStages;
    if (i >= kStages) bar_sync(kEmpty + st, kGramThreads + 32);
    // the stage's last readers were the consumers' generic loads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    m.sw[st * kChunk + lane] = w;
    m.swr[st * kChunk + lane] = w * r;
    unsigned char* row = reinterpret_cast<unsigned char*>(
        m.tile + (st * kChunk + lane) * SP);
    if (w == 0.f)
      for (int o = 0; o < bytes; o += 16)
        *reinterpret_cast<uint4*>(row + o) = make_uint4(0, 0, 0, 0);
    const unsigned live = __ballot_sync(BMF_FULL_MASK, w != 0.f);
    __syncwarp();
    if (lane == 0) mbar_expect_tx(m.bar + st, __popc(live) * bytes);
    if (live >> lane & 1)
      tma_row(row, a.other + ((p.row / a.N) * a.D + j) * (int64_t)a.ldo,
              bytes, m.bar + st, pol);
    p = nx;
    j = jn;
    w = wn;
    r = rn;
  }
  // take the consumers' releases of the last stages: none stays pending
  for (int k = max(0, i - kStages); k < i; ++k)
    bar_sync(kEmpty + k % kStages, kGramThreads + 32);
}

// A consumer warp W walks the same chunks: its plan's products, eta (one
// thread per column), and at a row's last chunk Lam through the staging.
template <int NB, int W, typename T>
__device__ __forceinline__ void gram_consumer(const PrecArgs<T>& a,
                                              const GramSmem<T>& m, int tid) {
  constexpr WarpPlan P = plan(NB, W);
  constexpr int SP = 16 * NB + 8;
  const int K = a.K;
  const int S = stage_stride(K);
  const unsigned magic = (unsigned)((0xffffffffull + K) / K);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t rows = a.rows;

  float acc[kMaxTiles][2][4];
#pragma unroll
  for (int q = 0; q < kMaxTiles; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][h][e] = 0.f;
  float2 eacc = make_float2(0.f, 0.f);   // eta[2 tid], eta[2 tid + 1]
  const int64_t r0 = blockIdx.x;
  Cursor C{r0, 0, live_of(a.live, r0, rows),
           live_of(a.live, r0 + gridDim.x, rows)};
  for (int i = 0; C.row < rows; ++i) {
    const int st = i % kStages;
    mbar_wait(m.bar + st, (i / kStages) & 1);
    const int n_in = min(kChunk, C.n - C.c * kChunk);
    const T* tl = m.tile + st * kChunk * SP;
    const float* w = m.sw + st * kChunk;
    const float* wr = m.swr + st * kChunk;
    if constexpr (P.nt > 0) {
      const float wl = w[lane];
      if (__ballot_sync(BMF_FULL_MASK, wl != 0.f && wl != 1.f) == 0)
        gram_chunk<NB, W, true>(tl, w, n_in, g, t, acc);
      else
        gram_chunk<NB, W, false>(tl, w, n_in, g, t, acc);
    }
    if (2 * tid < K) {
#pragma unroll 8
      for (int s = 0; s < n_in; ++s) {
        const float2 v = pair_f32(tl + s * SP + 2 * tid);
        eacc.x = fmaf(wr[s], v.x, eacc.x);
        eacc.y = fmaf(wr[s], v.y, eacc.y);
      }
    }
    __threadfence_block();
    bar_arrive(kEmpty + st, kGramThreads + 32);
    if ((C.c + 1) * kChunk >= C.n) {   // the row's last chunk
      stage_lam<NB, W>(m.stg, K, S, a.tau, g, t, acc);
#pragma unroll
      for (int q = 0; q < kMaxTiles; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][h][e] = 0.f;
      bar_sync(kConsumerBar, kGramThreads);
      if (2 * tid < K) a.eta[C.row * K + 2 * tid] = a.tau * eacc.x;
      if (2 * tid + 1 < K) a.eta[C.row * K + 2 * tid + 1] = a.tau * eacc.y;
      eacc = make_float2(0.f, 0.f);
      write_lam(a.lam + C.row * K * K, m.stg, K, S, magic, tid);
      bar_sync(kConsumerBar, kGramThreads);   // the staging is free again
    }
    advance(C, a.live, rows);
  }
}

// registers for 2 blocks a SM (ptxas allows the 160-thread blocks 168);
// NB = 8 (K > 112) needs more, at one block a SM

// persistent blocks: warps 0-3 consume (their own plans, one
// instantiation each), warp 4 produces
template <int NB, typename T>
__global__ void __launch_bounds__(kGramThreads + 32,
                                  NB >= 8 ? 1 : 2)
precision_gram_kernel(const PrecArgs<T> a) {
  constexpr int SP = 16 * NB + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const GramSmem<T> m = gram_smem<NB, T>(smem);
  // columns ldo .. SP of every stage stay zero (the TMA writes 0 .. ldo,
  // the padding of the rows K .. ldo zeros too)
  const int L = a.ldo;
  for (int e = threadIdx.x; e < kStages * kChunk * (SP - L);
       e += blockDim.x)
    m.tile[(e / (SP - L)) * SP + L + e % (SP - L)] = zero_of<T>();
  if (threadIdx.x < kStages) mbar_init(m.bar + threadIdx.x, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  switch (threadIdx.x >> 5) {
    case 0: gram_consumer<NB, 0, T>(a, m, threadIdx.x); break;
    case 1: gram_consumer<NB, 1, T>(a, m, threadIdx.x); break;
    case 2: gram_consumer<NB, 2, T>(a, m, threadIdx.x); break;
    case 3: gram_consumer<NB, 3, T>(a, m, threadIdx.x); break;
    default: gram_producer<NB, T>(a, m, threadIdx.x & 31); break;
  }
}

template <int NB, typename T>
cudaError_t launch_gram(const PrecArgs<T>& a, cudaStream_t st) {
  const int smem = gram_smem_bytes<T>(NB, a.K);
  const auto kernel = precision_gram_kernel<NB, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kGramThreads + 32, smem);
  if (err != cudaSuccess) return err;
  const int64_t grid =
      std::min<int64_t>(a.rows, (int64_t)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)grid, kGramThreads + 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PrecArgs<T>& a, cudaStream_t st) {
  if (a.K <= kRowK) {
    dispatch_rows<T>(a, st, std::make_integer_sequence<int, kRowK>{});
    return cudaGetLastError();
  }
  switch ((a.K + 15) / 16) {
    case 2: return launch_gram<2, T>(a, st);
    case 3: return launch_gram<3, T>(a, st);
    case 4: return launch_gram<4, T>(a, st);
    case 5: return launch_gram<5, T>(a, st);
    case 6: return launch_gram<6, T>(a, st);
    case 7: return launch_gram<7, T>(a, st);
    default: return launch_gram<8, T>(a, st);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// idx/val/mask: (B, N, M); live: (B, N) int32; other: (B, D, ldo) f32 or
// bf16, 16-byte aligned, its first K columns the factor (ldo = K up to
// K = 16; above, ldo's bytes a multiple of 16 and the padding zero); lam:
// (B, N, K, K) f32; eta: (B, N, K) f32, both 16-byte aligned. Returns a
// cudaError_t.
extern "C" int bmf_precision_launch(const void* idx, const void* val,
                                    const void* mask, const void* live,
                                    const void* other, int other_bf16,
                                    void* lam, void* eta, long long B, int N,
                                    int M, int D, int K, int ldo, float tau,
                                    void* stream) {
  const int row_bytes = ldo * (other_bf16 ? 2 : 4);
  if (K < 1 || K > 128 || N < 0 || M < 1 || D < 1 || B < 0 || ldo < K ||
      (K <= kRowK ? ldo != K : row_bytes % 16 != 0 || ldo >= K + 8))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * N;
  if (rows == 0) return 0;
  if (!aligned16(other) || !aligned16(lam) || !aligned16(eta))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = M % 4 == 0 && aligned16(idx) && aligned16(val) &&
                   aligned16(mask);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* vl = static_cast<const float*>(val);
  const float* mk = static_cast<const float*>(mask);
  const int32_t* lv = static_cast<const int32_t*>(live);
  float* lo = static_cast<float*>(lam);
  float* eo = static_cast<float*>(eta);
  if (other_bf16)
    return (int)launch(PrecArgs<__nv_bfloat16>{
        ix, vl, mk, lv, static_cast<const __nv_bfloat16*>(other), lo, eo,
        rows, N, M, D, K, ldo, tau, vec4}, st);
  return (int)launch(PrecArgs<float>{
      ix, vl, mk, lv, static_cast<const float*>(other), lo, eo, rows, N, M,
      D, K, ldo, tau, vec4}, st);
}
