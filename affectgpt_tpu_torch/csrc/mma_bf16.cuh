// bf16 tensor-core helpers shared by the port's mma.sync kernels on Hopper
// (sm_90a): the m16n8k16 product with f32 accumulators, the ldmatrix loads
// of its fragments from shared memory, and the packing of two floats into a
// bf16 pair. Fragment layouts are those of mma.m16n8k16 (PTX ISA): with
// gid = lane / 4 and tig = lane % 4, a thread holds accumulator rows gid and
// gid + 8, columns 2 * tig and 2 * tig + 1 of each 8-column tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agk {

// c += a (16 x 16, row-major) @ b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8. With rows r0 + l % 16 and columns k0 + (l / 16)
// * 8 of a row-major tile, r[0..3] are the A fragment of its 16 x 16 block.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: from a [k][n] row-major tile it gives B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The int8 values in the low bytes of the two 16-bit halves of `h` (the high
// bytes are ignored) as an exact bf16 pair, low half first. A byte b is
// (b & 0x7F) - (b & 0x80): the bf16 128 + (b & 0x7F) (0x4300 | low bits)
// plus the bf16 -128 or -256 (0xC300 | the sign bit), one bf16x2 add.
// All are small integers, exact in bf16. Two logic operations and one FMA
// a pair.
__device__ __forceinline__ uint32_t s8_halves_to_bf16x2(uint32_t h) {
  const uint32_t lo = (h & 0x007F007Fu) | 0x43004300u, neg = (h & 0x00800080u) | 0xC300C300u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(lo), "r"(0x3F803F80u), "r"(neg));
  return out;
}

// The nibbles at bits 0-3 and 16-19 of `v` (two's complement) as a bf16 pair
// of their values: (nibble & 0xF) ^ 0x4308 is the bf16 128 + (nibble ^ 8) =
// 136 + value, and 136 is subtracted in bf16 (exact: all are small integers).
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  uint32_t biased, out;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(biased) : "r"(v), "n"(0x000F000F), "n"(0x43084308));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // x * 1 - 136
  return out;
}

// bf16(f32(a) * s) for both halves of an exact bf16 pair: the dequantized
// weights of int4_matmul_smallm
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  return pack_bf16x2(__uint_as_float(v << 16) * s, __uint_as_float(v & 0xFFFF0000u) * s);
}

// The transpose of an 8x8 matrix of 16-bit elements held as an mma
// fragment (lane l: row l / 4, columns 2 (l % 4), 2 (l % 4) + 1): afterwards
// lane l holds row l / 4 of the transpose, that is the elements (2 (l % 4),
// l / 4) and (2 (l % 4) + 1, l / 4) of the matrix, low half first.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

}  // namespace agk
