// Tensor-core and asynchronous-copy helpers of the kernels that stage tiles
// in shared memory: the m16n8k16 bf16 product and the ldmatrix loads that
// feed K's and (transposed) V's B fragments (paged_prefill_attention.cu's
// and flash_decode.cuh's mma kernels), bf16 packing, the m16n8k8 TF32
// product and its split (3xTF32) form (ssm_scan.cu), and the cp.async
// copies (with zero fill) that stage the tiles (those kernels and
// flash_attention.cu's wgmma kernel).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace paged {

// d += a . b on the tensor cores: a 16 x 16 bf16 A fragment (four registers,
// rows g and g + 8, columns 2 t, 2 t + 1, 2 t + 8, 2 t + 9 with g = lane / 4
// and t = lane % 4), a 16 x 8 B fragment (b0: rows 2 t, 2 t + 1 of column
// g; b1: rows 2 t + 8, 2 t + 9), f32 accumulators (rows g, g + 8 at
// columns 2 t, 2 t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices: lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and r[i] receives row lane / 4, columns 2 (lane % 4) and
// 2 (lane % 4) + 1 of it: the B fragment of a matrix stored column-major
// (K's rows are B's columns).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint32_t* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8x8 b16 matrices, transposed: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i, and r[i] receives its B-fragment register.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint32_t* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on the tensor cores in TF32: a 16 x 8 A fragment (rows g and
// g + 8, columns t and t + 4, with g = lane / 4 and t = lane % 4: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), an 8 x 8 B fragment
// (b0: row t of column g; b1: row t + 4), f32 accumulators laid out as
// mma_bf16's. Operands are float32 bit patterns already rounded to TF32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo + (a residual below 2^-21 |v|): hi is v rounded to TF32 (10
// mantissa bits, to nearest, ties away, as cvt.rna rounds: an integer add of
// half the dropped bits, then a mask), lo = v - hi exactly, which the tensor
// core reads as TF32 by dropping its low 13 bits. Three integer and float
// instructions, fewer than two cvt.rna and a subtraction.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a . b in split precision (3xTF32): lo.hi + hi.lo + hi.hi, the small
// terms first; only lo.lo (about 2^-22 of the product) is dropped. Near
// float32 accuracy at a third of the TF32 rate.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// cp.async of 16, 8 or 4 bytes from global into shared memory. With `fill`
// false nothing is read and the destination is written with zeros (the
// src-size operand 0), so a masked row lands as zeros in the same stage.
// 16-byte copies bypass L1 (.cg); 8- and 4-byte copies can only go through
// it.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(fill ? 8 : 0));
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool fill) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(fill ? 4 : 0));
}
// Close the copies started since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are in flight; the
// landed bytes are then visible to this thread (a barrier makes them
// visible to the block).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The same for a count known only at run time, 0 to 3 (the instruction
// takes an immediate).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    default: cp_async_wait_group<3>(); break;
  }
}

}  // namespace paged
