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

// The expert-batched entry on the same core (quantized_matmul_experts in
// ops/quantized_matmul.py). Replaces no Pallas kernel: the JAX package
// computes its mixture-of-experts products as XLA einsums over int8 expert
// stacks (aios_tpu/engine/moe.py, `_expert_einsum` and `pick_einsum`).
// y[b] = x[b] (x_batched) or x (shared) @ w[index[b]] (b without an index),
// times that expert's column scales, for b < batches: w [X, K, N] int8, s
// [X, N], y [batches, M, N] bf16. Bound like K1 by the weight bytes at
// decode (8 rows per expert, or one row per pick) and by the tensor cores at
// a 512-row chunk: the same tiles, split K and plan, with a grid of batches x
// row tiles and a 3-D weight map whose expert coordinate each block reads
// from the index in device memory.
extern "C" int aios_quantized_matmul_experts(const void* x, const void* w, const void* s,
                                             const void* index, void* y, void* partial,
                                             void* counters, int batches, int M, int x_batched,
                                             int experts, int N, int K, int block_t, int block_n,
                                             int splits, int k_per_split, void* stream) {
  return wq::run_experts<wq::Int8Weights>(x, w, s, static_cast<const int*>(index), y, partial,
                                          counters, batches, M, x_batched, experts, N, K, block_t,
                                          block_n, splits, k_per_split, stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
