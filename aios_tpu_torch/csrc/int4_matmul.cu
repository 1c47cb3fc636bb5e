// Int4-weight matmul for Hopper:
// y[M, N] = x[M, K] @ dequant(packed[K/2, N], s[K/128, 1, N]).
//
// Replaces: aios_tpu/ops/int4_matmul.py, `int4_matmul` (the Pallas
// `_w4_kernel` launched by `_w4mm_2d`), which streams packed nibbles and
// dequantizes each [group, bn] weight tile next to the matrix unit.
//
// Storage: within each group of 128 K-rows, packed byte row r (0..63) holds
// K-row r in its low nibble and K-row r + 64 in its high nibble, both
// offset-binary (q + 8). One f32 scale per (group, column).
//
// What bounds it on the H100: in decode and verify (M <= 64) the packed
// bytes and scales over 3.35 TB/s; in prefill (M >= 128) the bf16
// tensor-core rate (989 TFLOP/s). In decode the dequantization itself comes
// close: every weight costs a float multiply and a rounding, about 16 integer
// and float instructions per packed byte at the rate the bytes arrive.
//
// What the design does about it: the shared core in wq_matmul.cuh. A ring
// stage is one scale group: 64 packed rows stream in by TMA with the group's
// scales, and the same four packed rows a thread reads give it a k16
// A fragment of the group's lower half (low nibbles) and one of its upper
// half (high nibbles). Each value becomes bf16_rn(f32(q - 8) * s) in
// registers, the plain version's dequantized weight, and feeds wgmma as its A
// operand with the activation rows on wgmma's N side; the epilogue only
// rounds. Split K sums in the same launch, in split order, so repeats are
// bit-identical.

#include "wq_matmul.cuh"

// (block_t, block_n): a tile of wq::run (8-64 x 64 streaming, 128 x 128 prefill); K and
// k_per_split multiples of 128; partial and counters as in wq_matmul.cuh.
extern "C" int aios_int4_matmul(const void* x, const void* packed, const void* s, void* y,
                                void* partial, void* counters, int M, int N, int K,
                                int block_t, int block_n, int splits, int k_per_split,
                                void* stream) {
  if (K % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return wq::run<wq::Int4Weights>(x, packed, s, y, partial, counters, M, N, K, block_t, block_n, splits,
                                  k_per_split, stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
