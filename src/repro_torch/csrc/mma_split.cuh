// Shared device code of the tensor-core kernels that take f32 operands:
// the scans L4 (ssd_chunk.cu) and L5 (wkv6.cu), B1's Gram kernel
// (bmf_precision.cu) and the f32 attention kernels L1 and L2
// (flash_attention.cu, flash_attention_bwd.cu): cp.async copies, the bf16
// and TF32 hi + lo splits of f32 operands, mma.sync fragments and
// ldmatrix loads.
//
// L4 and L5 hold 1e-4 of the largest value, which one bf16 rounding does
// not. So each operand is split as x = hi + lo, both bf16 (round to
// nearest even), and each product is hi.hi + hi.lo + lo.hi with f32
// accumulators (about 16 bits; the lo.lo term is dropped). B1, L1 and L2
// hold 1e-5 (1e-4 for L2's gradients), which needs 3xTF32: x = hi + lo
// with hi rounded to TF32 (`split_tf32`) and each product lo.hi + hi.lo +
// hi.hi on m16n8k8 TF32 tensor cores (`mma_tf32`, ~2^-22 relative).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + lo, each a bf16 pair (x in the low half: the lower k)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Fragments of mma m16n8k16 (PTX), lane = 4 g + t. A (16 x 16, rows r,
// depth k): registers (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..). B (16 x 8): (2t..2t+1, g), (2t + 8.., g). The
// accumulator: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {   // split
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float2 p0, float2 p1, float2 p2,
                                      float2 p3) {
    split2(p0.x, p0.y, hi[0], lo[0]);
    split2(p1.x, p1.y, hi[1], lo[1]);
    split2(p2.x, p2.y, hi[2], lo[2]);
    split2(p3.x, p3.y, hi[3], lo[3]);
  }
  // rows r0 + g (+ 8), depth k0 + 2t (+ 1, + 8, + 9) of a row-major matrix
  __device__ __forceinline__ void rows(const float* m, int ld, int r0,
                                       int k0, int g, int t) {
    const float* p = m + (r0 + g) * ld + k0 + 2 * t;
    set(*reinterpret_cast<const float2*>(p),
        *reinterpret_cast<const float2*>(p + 8 * ld),
        *reinterpret_cast<const float2*>(p + 8),
        *reinterpret_cast<const float2*>(p + 8 * ld + 8));
  }
};

struct FragB {   // split
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float2 p0, float2 p1) {
    split2(p0.x, p0.y, hi[0], lo[0]);
    split2(p1.x, p1.y, hi[1], lo[1]);
  }
  // column n0 + g, depth k0 + 2t (+ 1, + 8, + 9) of a matrix stored as
  // rows n (depth contiguous)
  __device__ __forceinline__ void rows(const float* m, int ld, int n0,
                                       int k0, int g, int t) {
    const float* p = m + (n0 + g) * ld + k0 + 2 * t;
    set(*reinterpret_cast<const float2*>(p),
        *reinterpret_cast<const float2*>(p + 8));
  }
  // column n0 + g, depth k0 + 2t (+ 1, + 8, + 9) of a matrix stored as
  // rows k (columns n contiguous)
  __device__ __forceinline__ void cols(const float* m, int ld, int n0,
                                       int k0, int g, int t) {
    const float* p = m + (k0 + 2 * t) * ld + n0 + g;
    set(make_float2(p[0], p[ld]), make_float2(p[8 * ld], p[9 * ld]));
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in about 16 bits: the two small cross terms, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// ldmatrix of bf16 tiles in shared memory: each lane gives the address of
// one 16-byte row of one 8 x 8 matrix (lanes 8 i .. 8 i + 7: matrix i).
// Plain, lane 4 g + t receives row g, columns 2t, 2t + 1 of each matrix;
// .trans, rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: what
// cvt.rna.tf32.f32 gives, in two integer operations on the full-rate
// pipe), lo = x - hi exactly in f32, of which the tensor core reads the
// TF32 part (it ignores an operand's low 13 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8 TF32 (PTX), lane = 4 g + t. A (16 x 8, rows r, depth
// k): registers (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4). B (8 x 8):
// (t, g), (t + 4, g). The accumulator: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
