// Int8-weight matmul for Hopper: y[M, N] = (x[M, K] @ w_q[K, N]) * s[N].
//
// Replaces: aios_tpu/ops/quantized_matmul.py, `quantized_matmul` (the Pallas
// `_qmm_kernel` launched by `_qmm_2d`), which streams int8 weights and
// dequantizes each tile next to the matrix unit.
//
// What bounds it on the H100: in decode and verify M is the number of rows
// in flight (8 slots, or 8 slots x 8 query rows), so the product does at most
// 2*M = 128 operations per weight byte, below the ~295 the card needs before
// compute matters: the int8 weight bytes over 3.35 TB/s bound it. In prefill
// M is the bucket (>= 128) and the bf16 tensor-core rate (989 TFLOP/s) bounds
// it.
//
// What the design does about it: the shared core in wq_matmul.cuh. Raw int8
// rows stream through a 3-8 stage TMA ring, three or two blocks per SM at
// decode (24-64 KB of weights in flight per SM), K split over one wave of
// blocks; each weight becomes bf16 exactly (|q| <= 127) in registers, as
// wgmma's A operand, with the activation rows on wgmma's N side (8 to 64 rows
// without padding at decode, 128 in prefill, where two consumer warpgroups
// keep the tensor cores busy). The per-column scale multiplies the fp32 sum
// once in the epilogue, the (acc * s) order of the TPU kernel. Split K sums
// in the same launch, in split order, so repeats are bit-identical.

#include "wq_matmul.cuh"

// (block_t, block_n): a tile of wq::run (8-64 x 64 streaming, 128 x 128 prefill);
// k_per_split a multiple of 64; partial and counters as in wq_matmul.cuh.
extern "C" int aios_quantized_matmul(const void* x, const void* w, const void* s, void* y,
                                     void* partial, void* counters, int M, int N, int K,
                                     int block_t, int block_n, int splits, int k_per_split,
                                     void* stream) {
  return wq::run<wq::Int8Weights>(x, w, s, y, partial, counters, M, N, K, block_t, block_n, splits,
                                  k_per_split, stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
