// L3: one-token GQA decode attention over a (ring) KV cache.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py: decode_attention_padded
//   (body _kernel), and the padding of its wrapper ops.decode_attention.
// For q (B, H, hd) and one layer's cache k, v (B, S, Hkv, hd) with kv_pos
// (S,) the absolute position held by each slot (-1 = empty), query head h
// attends to slot s of KV head h / (H / Hkv) iff
//   kv_pos[s] >= 0 && kv_pos[s] <= q_pos &&
//   (window == 0 || kv_pos[s] > q_pos - window),
// so a ring cache stays exact after wrap-around. softmax in f32; the output
// (B, H, hd) is written in q's dtype; zeros where no slot is valid.
//
// Bound on Hopper: bytes. Each valid slot's K and V rows are read once
// (B = 8, S = 4,096, bf16: 134 MB at Qwen3's Hkv = 8, hd = 128, 40 us at
// 3.35 TB/s; 470 MB at zamba2's Hkv = 32, hd = 112, 140 us) for G flops
// per byte (G = H / Hkv query heads per KV head: 4 and 1). The card's f32
// rate limits only above ~20 flops per byte, so the arithmetic stays f32 on
// the CUDA cores and the design is about keeping bytes in flight.
// Design (pipelined split-KV flash-decoding):
//   - the TPU grid (B, Hkv, S / 512) runs its S axis in order and carries
//     (m, l, acc) in VMEM. Here S is cut into splits: one block of 4 warps
//     per (split, kv head, b). The wrapper's split_plan picks as many
//     splits as keep the grid to one wave of two blocks per SM (4 at
//     Qwen3's 64 (b, kv head) pairs, 1 at zamba2's 256): on the H100 one
//     wave beat 2-32 waves at both shapes, since a longer split pays its
//     ring's fill and its partials once per more slots. With one split
//     the block writes the output itself; with more, a second launch
//     combines the splits' partials, the cross-block reduction that the
//     TPU did in its grid.
//   - K and V tiles of 32 slots stay in the cache's dtype in shared memory,
//     in a ring of 4 stages (2 for f32) kept full by 16-byte cp.async with
//     commit/wait groups: while one tile is consumed the next three are in
//     flight. One barrier per tile. No f32 staging copy.
//   - every lane works at any group size: a slot is read by a group of
//     4, 8 or 16 lanes (hd / 8 rounded up to a power of two; at hd 112, 14
//     of 16 lanes hold data), each lane holding 8 head-dim elements (16
//     bytes of bf16) of q for every query head of the group in registers
//     (beyond 4 heads, in shared memory). Scores are reduced by warp
//     shuffles inside the lane group; each lane group keeps its own online
//     softmax over its slots of each tile (4 at a time, one rescale per
//     batch), and the 8-32 lane groups of the block are merged in shared
//     memory at the end into one partial per head.
//   - validity comes from kv_pos per slot (one warp ballot per tile, its
//     positions loaded a tile ahead): a tile with no valid slot is neither
//     read nor computed; an invalid slot inside a tile, and the ragged end
//     of S, are zero-filled by cp.async (source size 0: nothing is read)
//     and get no weight. The cache is never padded or copied; the wrapper
//     allocates only the output and, with more than one split, the
//     partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTS = 32;          // slots per ring tile: one warp ballot
constexpr int kCh = 8;           // head-dim elements per lane (16 bytes)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct KV;

template <>
struct KV<float> {
  static constexpr int kStages = 2;
  static __device__ __forceinline__ void load(const float* p,
                                              float (&x)[kCh]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 w = *reinterpret_cast<const float4*>(p + 4);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
    x[4] = w.x;
    x[5] = w.y;
    x[6] = w.z;
    x[7] = w.w;
  }
};

template <>
struct KV<__nv_bfloat16> {
  static constexpr int kStages = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[kCh]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// how the lanes of a warp share the slots of a tile at head size HD
template <int HD>
struct Lanes {
  static constexpr int kChunks = HD / kCh;   // lanes holding data: 4..16
  static constexpr int kPerSlot = kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : 16;
  static constexpr int kGroups = kWarps * (32 / kPerSlot);
  static constexpr int kSlots = kTS / kGroups;   // per group and tile
  static_assert(HD % kCh == 0 && kChunks <= 16, "head size");
};

// dynamic shared memory: the K/V ring, reused at the end for the merge of
// the lane groups' (m, l, acc); beyond 4 query heads per KV head (GB =
// 16) q lives after it, in shared memory rather than registers
template <int HD, int GB, typename TKV>
struct Smem {
  static constexpr bool kQShared = GB > 4;
  static constexpr int kRow = HD * (int)sizeof(TKV);
  static constexpr int kTile = kTS * kRow;
  static constexpr int kRing = KV<TKV>::kStages * 2 * kTile;
  static constexpr int kMerge = Lanes<HD>::kGroups * GB * (HD + 2) * 4;
  static constexpr int kQ = kRing > kMerge ? kRing : kMerge;
  static constexpr int kMasks = kQ + (kQShared ? GB * HD * 4 : 0);
  static constexpr int kBytes = kMasks + KV<TKV>::kStages * 4;
  static_assert(kRow % 16 == 0, "rows are whole 16-byte chunks");
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One block per (split c, kv head hk, batch b): the partial (m, l, acc) of
// each of the G query heads over slots [c * chunk, min(S, (c + 1) * chunk)).
// When the grid has one split, part_acc is the output (B, H, hd) in q's
// dtype, whose index is then the partials' own, and gets acc / l.
// m is kept in log2 units (q is pre-scaled by log2(e) / sqrt(hd)). GB >= G
// is the compile-time head count of the registers.
template <int HD, int GB, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q, int q_bf16,
                    const TKV* __restrict__ k, const TKV* __restrict__ v,
                    const int32_t* __restrict__ kv_pos,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int H, int Hkv, int q_pos, int window, int chunk,
                    float qscale) {
  using Ln = Lanes<HD>;
  using Sm = Smem<HD, GB, TKV>;
  constexpr int kStages = KV<TKV>::kStages;
  constexpr int kLps = Ln::kPerSlot;
  constexpr int kSpg = Ln::kSlots;
  // slots scored per batch: bounded so that the scores fit registers
  constexpr int kSb = kSpg < (16 / GB > 1 ? 16 / GB : 1)
                          ? kSpg
                          : (16 / GB > 1 ? 16 / GB : 1);
  constexpr int kCpr = Sm::kRow / 16;
  // at GB = 16 the batches stay a loop: unrolled, they spill
  constexpr int kUnroll = GB > 4 ? 1 : kSpg / kSb;
  static_assert(kSpg % kSb == 0, "batches tile a group's slots");
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = H / Hkv;
  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gl = lane % kLps;                       // lane in its group
  const int grp = (tid >> 5) * (32 / kLps) + lane / kLps;
  const bool active = gl < Ln::kChunks;
  const int s_lo = c * chunk;
  const int s_hi = min(S, s_lo + chunk);
  const int nt = (s_hi - s_lo + kTS - 1) / kTS;
  const int64_t slot_bytes = (int64_t)Hkv * HD * (int64_t)sizeof(TKV);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + ((int64_t)b * S * Hkv + hk) * HD);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      v + ((int64_t)b * S * Hkv + hk) * HD);

  // this lane's q chunk of each head, scaled: in registers, or for GB = 16
  // in shared memory (written by lane group 0, read after the first
  // barrier of the tile loop)
  float qr[Sm::kQShared ? 1 : GB][kCh];
  float* qs = reinterpret_cast<float*>(smem + Sm::kQ);
  {
    const int64_t q0 = ((int64_t)b * H + (int64_t)hk * G) * HD + gl * kCh;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float x[kCh] = {};
      if (g < G && active) {
        if (q_bf16)
          KV<__nv_bfloat16>::load(
              static_cast<const __nv_bfloat16*>(q) + q0 + g * HD, x);
        else
          KV<float>::load(static_cast<const float*>(q) + q0 + g * HD, x);
#pragma unroll
        for (int e = 0; e < kCh; ++e) x[e] *= qscale;
      }
      if constexpr (Sm::kQShared) {
        if (grp == 0 && active) {
          float4* qd = reinterpret_cast<float4*>(qs + g * HD + gl * kCh);
          qd[0] = make_float4(x[0], x[1], x[2], x[3]);
          qd[1] = make_float4(x[4], x[5], x[6], x[7]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kCh; ++e) qr[g][e] = x[e];
      }
    }
  }

  // kv_pos of this lane's slot of tile t (-1 past the split), loaded one
  // tile before its mask is needed; the masks of the tiles in the ring
  // are kept in shared memory for their consumers
  auto load_pos = [&](int t) -> int {
    const int s = s_lo + t * kTS + lane;
    return t < nt && s < s_hi ? kv_pos[s] : -1;
  };
  unsigned* masks = reinterpret_cast<unsigned*>(smem + Sm::kMasks);
  // every thread issues its share of tile t's K and V rows (slot positions
  // pos) and commits one group (empty for a tile with no valid slot)
  auto issue = [&](int t, int pos) {
    const unsigned mask = __ballot_sync(
        kFull, pos >= 0 && pos <= q_pos &&
                   (window <= 0 || pos > q_pos - window));
    if (tid == 0) masks[t % kStages] = mask;
    if (mask) {
      unsigned char* ks = smem + (t % kStages) * 2 * Sm::kTile;
      unsigned char* vs = ks + Sm::kTile;
      const int s0 = s_lo + t * kTS;
      for (int i = tid; i < kTS * kCpr; i += kThreads) {
        const int r = i / kCpr;
        const int cc = i % kCpr;
        const bool ok = (mask >> r) & 1u;
        const int64_t off = ok ? (int64_t)(s0 + r) * slot_bytes + cc * 16 : 0;
        cp_async16(ks + r * Sm::kRow + cc * 16, kb + off, ok ? 16 : 0);
        cp_async16(vs + r * Sm::kRow + cc * 16, vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float m[GB], l[GB], acc[GB][kCh];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kCh; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt)
      issue(t, load_pos(t));
    else
      cp_async_commit();
  }
  int pos_next = load_pos(kStages - 1);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t landed
    __syncthreads();                // everyone's; and tile t - 1 consumed
    if (t + kStages - 1 < nt)
      issue(t + kStages - 1, pos_next);   // into the stage tile t - 1 used
    else
      cp_async_commit();
    pos_next = load_pos(t + kStages);
    const unsigned mask = masks[t % kStages];
    if (!mask) continue;
    const TKV* kt =
        reinterpret_cast<const TKV*>(smem + (t % kStages) * 2 * Sm::kTile);
    const TKV* vt = kt + kTS * HD;
#pragma unroll kUnroll
    for (int sb = 0; sb < kSpg; sb += kSb) {
      const int j0 = grp * kSpg + sb;
      float sc[kSb][GB];
#pragma unroll
      for (int i = 0; i < kSb; ++i) {
        float kx[kCh] = {};
        if (active) KV<TKV>::load(kt + (j0 + i) * HD + gl * kCh, kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float qv[kCh];
          if constexpr (Sm::kQShared) {
            KV<float>::load(qs + g * HD + gl * kCh, qv);
          } else {
#pragma unroll
            for (int e = 0; e < kCh; ++e) qv[e] = qr[g][e];
          }
          float a = qv[0] * kx[0];
#pragma unroll
          for (int e = 1; e < kCh; ++e) a = fmaf(qv[e], kx[e], a);
          sc[i][g] = a;
        }
      }
#pragma unroll
      for (int off = kLps / 2; off > 0; off /= 2)
#pragma unroll
        for (int i = 0; i < kSb; ++i)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            sc[i][g] += __shfl_xor_sync(kFull, sc[i][g], off);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kSb; ++i)
          if ((mask >> (j0 + i)) & 1u) mx = fmaxf(mx, sc[i][g]);
        const float m_new = fmaxf(m[g], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = m[g] == -INFINITY ? 0.f : exp2f(m[g] - m_safe);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kSb; ++i) {
          const float p =
              ((mask >> (j0 + i)) & 1u) ? exp2f(sc[i][g] - m_safe) : 0.f;
          sc[i][g] = p;
          sum += p;
        }
        l[g] = fmaf(l[g], corr, sum);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kCh; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < kSb; ++i) {
        float vx[kCh] = {};
        if (active) KV<TKV>::load(vt + (j0 + i) * HD + gl * kCh, vx);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < kCh; ++e)
            acc[g][e] = fmaf(sc[i][g], vx[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: merge the lane groups through it

  float* red_ml = reinterpret_cast<float*>(smem);    // [group][GB][2]
  float* red_acc = red_ml + Ln::kGroups * GB * 2;    // [group][GB][HD]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (gl == 0) {
      red_ml[(grp * GB + g) * 2] = m[g];
      red_ml[(grp * GB + g) * 2 + 1] = l[g];
    }
    if (active) {
      float4* ra =
          reinterpret_cast<float4*>(red_acc + (grp * GB + g) * HD + gl * kCh);
      ra[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      ra[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  const int64_t base = (((int64_t)b * Hkv + hk) * gridDim.x + c) * G;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int n = 0; n < Ln::kGroups; ++n)
      M = fmaxf(M, red_ml[(n * GB + g) * 2]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int n = 0; n < Ln::kGroups; ++n) {
        const float mn = red_ml[(n * GB + g) * 2];
        if (mn == -INFINITY) continue;
        const float w = exp2f(mn - M);
        L = fmaf(red_ml[(n * GB + g) * 2 + 1], w, L);
        A = fmaf(red_acc[(n * GB + g) * HD + d], w, A);
      }
    }
    if (gridDim.x == 1) {   // the only split: no combine follows
      const float x = A / fmaxf(L, 1e-30f);
      if (q_bf16)
        reinterpret_cast<__nv_bfloat16*>(part_acc)[(base + g) * HD + d] =
            from_f32<__nv_bfloat16>(x);
      else
        part_acc[(base + g) * HD + d] = x;
      continue;
    }
    part_acc[(base + g) * HD + d] = A;
    if (d == 0) {
      part_ml[(base + g) * 2] = M;
      part_ml[(base + g) * 2 + 1] = L;
    }
  }
}

// One block of hd threads per (b, h): o = sum_c acc_c 2^(m_c - M) /
// sum_c l_c 2^(m_c - M), M = max_c m_c over splits that saw a valid slot.
template <typename TO>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      TO* __restrict__ o, int H, int Hkv,
                                      int hd, int n_chunks) {
  const int G = H / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int g = h % G;
  const int d = threadIdx.x;
  const int64_t row0 = ((int64_t)b * Hkv + hk) * n_chunks;
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c)
    M = fmaxf(M, part_ml[((row0 + c) * G + g) * 2]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int c = 0; c < n_chunks; ++c) {
      const int64_t r = (row0 + c) * G + g;
      const float mc = part_ml[r * 2];
      if (mc == -INFINITY) continue;
      const float w = exp2f(mc - M);
      L = fmaf(part_ml[r * 2 + 1], w, L);
      A = fmaf(part_acc[r * hd + d], w, A);
    }
  }
  o[((int64_t)b * H + h) * hd + d] = from_f32<TO>(A / fmaxf(L, 1e-30f));
}

template <int HD, int GB, typename TKV>
cudaError_t launch(const void* q, int q_bf16, const void* k, const void* v,
                   const int32_t* kv_pos, void* o, float* part_acc,
                   float* part_ml, int B, int S, int H, int Hkv, int q_pos,
                   int window, int chunk, cudaStream_t st) {
  auto kern = decode_split_kernel<HD, GB, TKV>;
  constexpr int bytes = Smem<HD, GB, TKV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (S + chunk - 1) / chunk;
  kern<<<dim3(n_chunks, Hkv, B), kThreads, bytes, st>>>(
      q, q_bf16, static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      kv_pos, n_chunks == 1 ? static_cast<float*>(o) : part_acc, part_ml, S,
      H, Hkv, q_pos, window, chunk,
      1.4426950408889634f / sqrtf((float)HD));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  if (q_bf16)
    decode_combine_kernel<__nv_bfloat16><<<B * H, HD, 0, st>>>(
        part_acc, part_ml, static_cast<__nv_bfloat16*>(o), H, Hkv, HD,
        n_chunks);
  else
    decode_combine_kernel<float><<<B * H, HD, 0, st>>>(
        part_acc, part_ml, static_cast<float*>(o), H, Hkv, HD, n_chunks);
  return cudaGetLastError();
}

template <int HD, typename TKV>
cudaError_t by_group(int G, const void* q, int q_bf16, const void* k,
                     const void* v, const int32_t* kv_pos, void* o,
                     float* part_acc, float* part_ml, int B, int S, int H,
                     int Hkv, int q_pos, int window, int chunk,
                     cudaStream_t st) {
  if (G == 1)
    return launch<HD, 1, TKV>(q, q_bf16, k, v, kv_pos, o, part_acc, part_ml,
                              B, S, H, Hkv, q_pos, window, chunk, st);
  if (G <= 4)
    return launch<HD, 4, TKV>(q, q_bf16, k, v, kv_pos, o, part_acc, part_ml,
                              B, S, H, Hkv, q_pos, window, chunk, st);
  if (G <= 16)
    return launch<HD, 16, TKV>(q, q_bf16, k, v, kv_pos, o, part_acc,
                               part_ml, B, S, H, Hkv, q_pos, window, chunk,
                               st);
  return cudaErrorInvalidValue;
}

template <typename TKV>
cudaError_t dispatch(int hd, int G, const void* q, int q_bf16, const void* k,
                     const void* v, const int32_t* kv_pos, void* o,
                     float* part_acc, float* part_ml, int B, int S, int H,
                     int Hkv, int q_pos, int window, int chunk,
                     cudaStream_t st) {
  switch (hd) {
    case 32:
      return by_group<32, TKV>(G, q, q_bf16, k, v, kv_pos, o, part_acc,
                               part_ml, B, S, H, Hkv, q_pos, window, chunk,
                               st);
    case 64:
      return by_group<64, TKV>(G, q, q_bf16, k, v, kv_pos, o, part_acc,
                               part_ml, B, S, H, Hkv, q_pos, window, chunk,
                               st);
    case 112:  // zamba2's shared attention block
      return by_group<112, TKV>(G, q, q_bf16, k, v, kv_pos, o, part_acc,
                                part_ml, B, S, H, Hkv, q_pos, window, chunk,
                                st);
    case 128:
      return by_group<128, TKV>(G, q, q_bf16, k, v, kv_pos, o, part_acc,
                                part_ml, B, S, H, Hkv, q_pos, window, chunk,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, hd); k, v: (B, S, Hkv, hd); kv_pos: (S,) int32; o: (B, H, hd)
// in q's dtype; part_acc: (B, Hkv, n_chunks, H / Hkv, hd) f32 and part_ml:
// (B, Hkv, n_chunks, H / Hkv, 2) f32 scratch, n_chunks = ceil(S / chunk),
// chunk a multiple of 32 slots; with n_chunks = 1 they are not touched
// (may be null). H / Hkv <= 16. q_bf16 / kv_bf16 pick bf16 over f32.
// Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_pos,
                                       void* o, void* part_acc, void* part_ml,
                                       int q_bf16, int kv_bf16, int B, int S,
                                       int H, int Hkv, int hd, int q_pos,
                                       int window, int chunk, void* stream) {
  if (B < 0 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || window < 0 ||
      chunk < kTS || chunk % kTS != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* pos = static_cast<const int32_t*>(kv_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const int G = H / Hkv;
  cudaError_t err;
  if (kv_bf16)
    err = dispatch<__nv_bfloat16>(hd, G, q, q_bf16, k, v, pos, o, pa, pm, B,
                                  S, H, Hkv, q_pos, window, chunk, st);
  else
    err = dispatch<float>(hd, G, q, q_bf16, k, v, pos, o, pa, pm, B, S, H,
                          Hkv, q_pos, window, chunk, st);
  return (int)err;
}
