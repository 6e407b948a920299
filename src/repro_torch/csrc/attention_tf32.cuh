// Shared device code of the f32 attention kernels L1 (flash_attention.cu)
// and L2 (flash_attention_bwd.cu): 3xTF32 products on m16n8k8 tensor
// cores, with operands split x = hi + lo (`split_tf32`, mma_split.cuh).
//
// Depth slots. A product's depth (8 per mma) is summed, so its order is
// free: slot t of a step is depth 2t and slot t + 4 is depth 2t + 1. Then
//   - a lane's two B elements (slots t and t + 4 of column g) are
//     neighbours, and one 16-byte load gives both, hi and lo;
//   - a lane's A elements of rows g, g + 8 are two float2 of a row-major
//     tile;
//   - the accumulator of one product is, as it stands, the A fragment of
//     the next over its columns (scores -> P V, dS -> dS K): lane (g, t)
//     holds columns 2t and 2t + 1 of rows g and g + 8, slots t and t + 4.
//     No shuffle and no trip through shared memory.
//
// Split planes. A streamed tile is split once, by the whole block, into
// float4s (hi_a, hi_b, lo_a, lo_b) of the two elements a, b that a lane
// takes together:
//   - a row plane [row][depth pair] when the product's depth runs along a
//     row (the head dimension: Q K^T, dO V^T, K Q^T, V dO^T). Row stride
//     2 HD + 16 words, 16 mod 32: the 8 lanes of a 16-byte load phase
//     read rows g, g + 1 at 4t, conflict-free;
//   - a pair plane [row pair][column] when it runs across rows (keys or
//     queries: P V, dS K, P^T dO, dS^T Q). Row stride 4 HD + 8 words,
//     8 mod 32: pairs t at 8t, columns g at 4g, conflict-free.
// Operands a block keeps for its whole life (q of L1 in registers; q and
// dO of the dq pass, K and V of the dk/dv pass in shared memory, row
// stride HD + 8, 8 mod 32 for the float2 loads) stay raw and are split as
// a warp uses them: split, they would take twice the registers (L1 spilled
// at hd 112 and 128) or would not fit in shared memory beside the
// streamed tiles.
//
// Partial sums. The tensor cores add a product into the accumulator with
// truncation, so a sum carried through hundreds of mma drifts toward zero
// (L1's output over 4,096 keys and L2's gradients moved ~1e-4 relative,
// ten times the f32 kernels' error). So no accumulator takes more than
// kChunk depth steps (3 kChunk mma): it starts from zero
// (`mma3_tf32_first`) and is added into an f32 running sum on the CUDA
// cores, rounded to nearest. Within a chunk the error stays a few units
// in the last place of the partial.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace tf32att {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4;   // depth steps an mma accumulator takes at most

template <int HD>
__host__ __device__ constexpr int row_ld() { return 2 * HD + 16; }
template <int HD>
__host__ __device__ constexpr int pair_ld() { return 4 * HD + 8; }
template <int HD>
__host__ __device__ constexpr int raw_ld() { return HD + 8; }

// threadIdx.x read afresh: the copy and split loops index from it, and
// their offsets, hoisted out of a kernel's tile loop, held registers for
// the whole loop
__device__ __forceinline__ int thread_index() {
  int i;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(i));
  return i;
}

// an A fragment, split
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ float4 split_pair(float a, float b) {
  uint32_t ha, la, hb, lb;
  split_tf32(a, ha, la);
  split_tf32(b, hb, lb);
  return make_float4(__uint_as_float(ha), __uint_as_float(hb),
                     __uint_as_float(la), __uint_as_float(lb));
}

// Rows [r0, r0 + ROWS) of a (n_rows, stride) f32 matrix into `dst`
// (leading dimension LD) by cp.async, 16 bytes a copy; rows past n_rows
// are zeros. The caller commits.
template <int HD, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int r0,
                                          int n_rows) {
  constexpr int V = HD / 4;
#pragma unroll 1   // unrolled, its addresses held registers across a tile loop
  for (int i = thread_index(); i < ROWS * V; i += NT) {
    const int r = i / V;
    const int c = (i % V) * 4;
    float* d = dst + r * LD + c;
    if (r0 + r < n_rows)
      cp_async16(d, src + (int64_t)(r0 + r) * stride + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a raw ROWS x HD tile (leading dimension HD) times `scale` into a row
// plane
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void split_rows(float* plane, const float* raw,
                                           float scale) {
  constexpr int P = HD / 2;
  for (int i = thread_index(); i < ROWS * P; i += NT) {
    const int r = i / P, p = i % P;
    const float2 x = *reinterpret_cast<const float2*>(raw + r * HD + 2 * p);
    *reinterpret_cast<float4*>(plane + r * row_ld<HD>() + 4 * p) =
        split_pair(x.x * scale, x.y * scale);
  }
}

// ... into a pair plane
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void split_pairs(float* plane, const float* raw,
                                            float scale) {
  for (int i = thread_index(); i < ROWS / 2 * HD; i += NT) {
    const int rp = i / HD, d = i % HD;
    *reinterpret_cast<float4*>(plane + rp * pair_ld<HD>() + 4 * d) =
        split_pair(raw[2 * rp * HD + d] * scale,
                   raw[(2 * rp + 1) * HD + d] * scale);
  }
}

// ... into both planes, each element split once (a thread per 2 x 2 block)
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void split_both(float* rows, float* pairs,
                                           const float* raw, float scale) {
  constexpr int P = HD / 2;
  for (int i = thread_index(); i < ROWS / 2 * P; i += NT) {
    const int rp = i / P, p = i % P;
    const float2 a =
        *reinterpret_cast<const float2*>(raw + 2 * rp * HD + 2 * p);
    const float2 b =
        *reinterpret_cast<const float2*>(raw + (2 * rp + 1) * HD + 2 * p);
    uint32_t h[4], l[4];
    split_tf32(a.x * scale, h[0], l[0]);
    split_tf32(a.y * scale, h[1], l[1]);
    split_tf32(b.x * scale, h[2], l[2]);
    split_tf32(b.y * scale, h[3], l[3]);
    float* r = rows + 2 * rp * row_ld<HD>() + 4 * p;
    *reinterpret_cast<uint4*>(r) = make_uint4(h[0], h[1], l[0], l[1]);
    *reinterpret_cast<uint4*>(r + row_ld<HD>()) =
        make_uint4(h[2], h[3], l[2], l[3]);
    float* c = pairs + rp * pair_ld<HD>() + 8 * p;
    *reinterpret_cast<uint4*>(c) = make_uint4(h[0], h[2], l[0], l[2]);
    *reinterpret_cast<uint4*>(c + 4) = make_uint4(h[1], h[3], l[1], l[3]);
  }
}

// an A fragment from its four elements (g, slot t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4), split
__device__ __forceinline__ void frag_split(Frag& f, float a0, float a1,
                                           float a2, float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

// A fragment of rows r0 + g, r0 + g + 8, depth step ks of a raw row-major
// tile (leading dimension LD), split here
template <int LD>
__device__ __forceinline__ void frag_raw(Frag& f, const float* raw, int r0,
                                         int ks, int g, int t) {
  const float* p = raw + (r0 + g) * LD + 8 * ks + 2 * t;
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD);
  frag_split(f, x0.x, x1.x, x0.y, x1.y);
}

// the accumulator c of columns 8j .. 8j + 7 as the A fragment of depth
// step j of the next product
__device__ __forceinline__ void frag_acc(Frag& f, const float (&c)[4]) {
  frag_split(f, c[0], c[2], c[1], c[3]);
}

// B fragment of columns n0 .. n0 + 7 at depth step ks, from a row plane
template <int HD>
__device__ __forceinline__ float4 frag_row(const float* plane, int n0,
                                           int ks, int g, int t) {
  return *reinterpret_cast<const float4*>(plane + (n0 + g) * row_ld<HD>() +
                                          16 * ks + 4 * t);
}

// B fragment of columns n0 .. n0 + 7 at depth step j (rows 8j ..), from a
// pair plane
template <int HD>
__device__ __forceinline__ float4 frag_pair(const float* plane, int n0,
                                            int j, int g, int t) {
  return *reinterpret_cast<const float4*>(plane + (4 * j + t) * pair_ld<HD>() +
                                          4 * (n0 + g));
}

// d += a b in 3xTF32: the two small cross terms, then hi.hi; b is a lane's
// (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const Frag& a,
                                          float4 b) {
  mma_tf32(d, a.lo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a.hi, __float_as_uint(b.x), __float_as_uint(b.y));
}

// d = a b in 3xTF32, a fresh partial: the first product goes into zero
// accumulators
__device__ __forceinline__ void mma3_tf32_first(float (&d)[4], const Frag& a,
                                                float4 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.lo[0]), "r"(a.lo[1]), "r"(a.lo[2]), "r"(a.lo[3]),
        "r"(__float_as_uint(b.x)), "r"(__float_as_uint(b.y)), "f"(0.f),
        "f"(0.f), "f"(0.f), "f"(0.f));
  mma_tf32(d, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a.hi, __float_as_uint(b.x), __float_as_uint(b.y));
}

// sum[j] += sum over depth steps c .. c + N - 1 of a(ks) b(ks, j), for the
// NJ column tiles j, as one fresh partial. `a_of(f, ks)` fills the A
// fragment of step ks, `b_of(ks, j)` returns the B fragment.
template <int N, int NJ, typename AOf, typename BOf>
__device__ __forceinline__ void dot_chunk(float (&sum)[NJ][4], int c,
                                          AOf& a_of, BOf& b_of) {
  float part[NJ][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    Frag a;
    a_of(a, c + i);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = b_of(c + i, j);
      if (i == 0)
        mma3_tf32_first(part[j], a, b);
      else
        mma3_tf32(part[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] += part[j][e];
}

// ... over the NK depth steps, kChunk at a time: a loop at run time over
// the whole chunks (only a chunk is unrolled, so the compiler does not
// hoist every step's loads at once), then the rest
template <int NK, int NJ, typename AOf, typename BOf>
__device__ __forceinline__ void dot_chunked(float (&sum)[NJ][4], AOf&& a_of,
                                            BOf&& b_of) {
  constexpr int whole = NK / kChunk * kChunk;
#pragma unroll 1
  for (int c = 0; c < whole; c += kChunk)
    dot_chunk<kChunk>(sum, c, a_of, b_of);
  if constexpr (NK % kChunk != 0)
    dot_chunk<NK % kChunk>(sum, whole, a_of, b_of);
}

// key kp is visible from query qp
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

}  // namespace tf32att
