// Warp-level tensor-core building blocks shared by the kernels in csrc/.
//
// f32 operands go through the TF32 tensor cores with the 3xTF32 split
// (CUTLASS's "fast f32"): x = hi + lo with hi = tf32(x), lo = tf32(x - hi),
// and a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi.  The dropped a_lo*b_lo term
// is below 2^-22 |a b|, so a product is as accurate as an f32 FMA chain at
// the repository's tolerances, where one TF32 product (10-bit mantissa) is
// not.  bf16 operands take the bf16 tensor cores with f32 accumulation.
// The MMA's own accumulation does not round to nearest: each product adds
// an error of up to one ulp of the accumulator, in one direction.  Over a
// long sum (the 7 * 512 = 3584-term conv7 of the ResidualUnit) that bias
// outgrows the f32 tolerances, so a kernel with a long reduction sums short
// MMA partials into a separate register sum with ordinary f32 adds.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8/k16"), with
// g = lane / 4 and t = lane % 4:
//   m16n8k8 tf32   A (16x8, row): a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B (8x8, col):  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   m16n8k16 bf16  A (16x16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//                  B (16x8):  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   both           C (16x8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// (the lower 16 bits of a packed bf16 pair hold the lower k index).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ezk {

// ---- TF32 split and products ----------------------------------------------
// x rounded to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32, bit for bit on finite values, but on the integer pipe
// (add half a TF32 ulp to the magnitude bits, clear the 13 dropped bits)
// instead of the conversion pipe, whose lower rate the split would
// otherwise saturate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a * b, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in f32 accuracy from split operands: the two small cross terms
// first, then hi*hi, so the small terms are not lost against a large sum.
__device__ __forceinline__ void mma3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                          const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// c += a * b, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a packed bf16 pair, `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The B fragment of m16n8k16 from a row-major (k, n) bf16 tile in shared
// memory: `row0` points at element (k0, n0), `ld` is the row stride in
// elements.  ldmatrix .trans hands lane (g, t) the pairs (k=2t..2t+1, n=g)
// and (k=2t+8.., n=g); lanes 0-15 give the 16 row addresses.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t* b, const __nv_bfloat16* row0,
                                                 int ld, int lane) {
  const __nv_bfloat16* p = row0 + (lane & 15) * ld;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr)
               : "memory");
}

// An A fragment (m16n8k8 TF32 or m16n8k16 bf16) from a row-major tile in
// shared memory: four 8x8 b16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i (rows 0-7, rows 8-15, then the same rows 16 bytes
// on).  Read as 32-bit TF32 words, an 8x8 b16 matrix is 8 rows x 4 words,
// and lane (g, t) receives word t of row g: the TF32 A layout.
__device__ __forceinline__ void ldmatrix_a(uint32_t* a, const void* row_addr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// ---- cp.async --------------------------------------------------------------
// 16 bytes global -> shared; when `valid` is false nothing is read and the
// 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every committed group of this thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace ezk
