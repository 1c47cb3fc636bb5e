// int8 values as exact bf16 MMA fragments, shared by the weight-quantized
// matmuls (wq_matmul.cuh: K1's int8 weights, K5's nibbles) and K7, verify
// attention over the int8 cache (dense_attention.cu).
//
// A fragment of mma.m16n8k16 holds two consecutive k values of one column
// in a 32-bit word, while an int8 tile in shared memory holds a row's values
// side by side. gather / gather_hi pick the bytes of two rows that one word
// of each of two fragments needs, and i8x4_to_bf16 turns the four bytes into
// the two words, exactly.
#pragma once

#include <stdint.h>

namespace int8_bf16 {

// 4 int8 as two bf16x2 (bytes 0,1 and bytes 2,3), exactly: |q| <= 128 fits
// bf16's 8 significant bits. 2^23 + (q + 128) is built as float bits and the
// offset subtracted; the bf16 is then the float's upper half.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t u, uint32_t& lo, uint32_t& hi) {
  u ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Bytes 0 and 1 of two rows' words, interleaved: (a0, b0, a1, b1). Through
// i8x4_to_bf16, column 0 of rows a, b and column 1 of rows a, b.
__device__ __forceinline__ uint32_t gather(uint32_t row_a, uint32_t row_b) {
  return __byte_perm(row_a, row_b, 0x5140);
}

// The same for bytes 2 and 3: (a2, b2, a3, b3).
__device__ __forceinline__ uint32_t gather_hi(uint32_t row_a, uint32_t row_b) {
  return __byte_perm(row_a, row_b, 0x7362);
}

}  // namespace int8_bf16
