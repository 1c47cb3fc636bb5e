// Int8-weight matmul for Hopper: y[M, N] = (x[M, K] @ w_q[K, N]) * s[N].
//
// Replaces: aios_tpu/ops/quantized_matmul.py, `quantized_matmul` (the Pallas
// `_qmm_kernel` launched by `_qmm_2d`), which streams int8 weights and
// dequantizes each tile next to the matrix unit.
//
// What bounds it on the H100: in decode M is the number of slots (8), so the
// product does 2*M = 16 operations per weight byte, far below the ~295 the
// card needs before compute matters: the int8 weight bytes over 3.35 TB/s
// bound it. In prefill M is the bucket (>= 128) and the bf16 tensor-core rate
// (989 TFLOP/s) bounds it.
//
// What the design does about it: the weight leaves device memory as int8 in
// 16-byte vector loads and becomes bf16 only in shared memory, so the
// dequantized matrix never exists in device memory. The product runs on the
// tensor cores (WMMA bf16 16x16x16 fragments, fp32 accumulation) and the
// per-column scale multiplies once in the epilogue, the (acc * s) order of the
// TPU kernel. The loads of the next K tile are issued into registers before
// the tensor cores work on the current one, so they are in flight during the
// product. Decode-sized M takes 16-row tiles with 128-deep K tiles (8 KB of
// weights per block and step in flight); larger M takes 64x64 tiles 64 deep.
// A small M leaves too few output tiles to fill 132 SMs, so K is split over
// blocks: each split writes an fp32 partial, and a second kernel sums the
// splits in a fixed order (deterministic), scales and rounds. Ragged M, N and
// K edges are masked, so any shape works. Not yet: TMA, wgmma, a multi-stage
// shared-memory ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBN = 64;
constexpr int kThreads = 128;

template <int BM, int BK>
struct Tile {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = kBN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  // padded leading dimensions: multiples of 8 bf16 / 4 fp32 as WMMA needs,
  // and every fragment pointer stays 32-byte aligned
  static constexpr int LDA = BK + 8;
  static constexpr int LDB = kBN + 8;
  static constexpr int LDC = kBN + 4;
  static constexpr int A_VECS = BM * BK / 8 / kThreads;   // 8 bf16 each
  static constexpr int B_VECS = BK * kBN / 16 / kThreads; // 16 int8 each
  static_assert(BM * BK % (8 * kThreads) == 0, "A tile splits evenly");
  static_assert(BK * kBN % (16 * kThreads) == 0, "B tile splits evenly");
  static constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  // the epilogue's fp32 tile reuses the operand tiles' memory
  static constexpr int BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

union Bf16x8 {
  uint4 v;
  uint16_t h[8];
};

union Int8x16 {
  int4 v;
  int8_t b[16];
};

// 8 bf16 of row m from column k on, zero outside [0, M) x [k, k_end).
__device__ __forceinline__ uint4 load_x(const __nv_bfloat16* x, int M, int K,
                                        int m, int k, int k_end, bool vec) {
  if (m < M && vec && k + 8 <= k_end)
    return *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
  Bf16x8 r;
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    r.h[e] = (m < M && k + e < k_end) ? raw[(size_t)m * K + k + e] : 0;
  return r.v;
}

// 16 int8 of row k from column n on, zero outside [k, k_end) x [0, N).
__device__ __forceinline__ int4 load_w(const int8_t* w, int N, int k, int n,
                                       int k_end, bool vec) {
  if (k < k_end && vec && n + 16 <= N)
    return *reinterpret_cast<const int4*>(w + (size_t)k * N + n);
  Int8x16 r;
#pragma unroll
  for (int e = 0; e < 16; ++e)
    r.b[e] = (k < k_end && n + e < N) ? w[(size_t)k * N + n + e] : 0;
  return r.v;
}

__device__ __forceinline__ uint32_t bf16_bits(int8_t b) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(b)));
}

template <int BM, int BK>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ y,
           float* __restrict__ partial, int M, int N, int K, int k_per_split) {
  using TL = Tile<BM, BK>;
  __shared__ __align__(128) unsigned char smem[TL::BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * TL::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / TL::WARPS_N;
  const int wn = warp % TL::WARPS_N;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // 16-byte vector loads need aligned rows; anything else takes the
  // element-wise path
  const bool x_vec =
      (K % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_vec =
      (N % 16) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  uint4 a_reg[TL::A_VECS];
  int4 b_reg[TL::B_VECS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TL::A_VECS; ++i) {
      const int v = tid + i * kThreads;
      a_reg[i] = load_x(x, M, K, m0 + v / (BK / 8), k0 + (v % (BK / 8)) * 8,
                        k_end, x_vec);
    }
#pragma unroll
    for (int i = 0; i < TL::B_VECS; ++i) {
      const int v = tid + i * kThreads;
      b_reg[i] = load_w(w, N, k0 + v / (kBN / 16), n0 + (v % (kBN / 16)) * 16,
                        k_end, w_vec);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TL::FM][TL::FN];
#pragma unroll
  for (int i = 0; i < TL::FM; ++i)
#pragma unroll
    for (int j = 0; j < TL::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // the fetched tile into shared memory, int8 -> bf16 on the way
#pragma unroll
    for (int i = 0; i < TL::A_VECS; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (v / (BK / 8)) * TL::LDA + (v % (BK / 8)) * 8) =
          a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < TL::B_VECS; ++i) {
      const int v = tid + i * kThreads;
      Int8x16 raw;
      raw.v = b_reg[i];
      uint32_t pair[8];  // two bf16 each, low half first (exact: |b| <= 128)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pair[e] = bf16_bits(raw.b[2 * e]) | (bf16_bits(raw.b[2 * e + 1]) << 16);
      uint4* dst = reinterpret_cast<uint4*>(Bs + (v / (kBN / 16)) * TL::LDB +
                                            (v % (kBN / 16)) * 16);
      dst[0] = make_uint4(pair[0], pair[1], pair[2], pair[3]);
      dst[1] = make_uint4(pair[4], pair[5], pair[6], pair[7]);
    }
    __syncthreads();
    // the next tile's loads fly while the tensor cores work on this one
    if (k0 + BK < k_end) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[TL::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[TL::FN];
#pragma unroll
      for (int i = 0; i < TL::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * TL::WM + i * 16) * TL::LDA + kk, TL::LDA);
#pragma unroll
      for (int j = 0; j < TL::FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * TL::LDB + wn * TL::WN + j * 16, TL::LDB);
#pragma unroll
      for (int i = 0; i < TL::FM; ++i)
#pragma unroll
        for (int j = 0; j < TL::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TL::FM; ++i)
#pragma unroll
    for (int j = 0; j < TL::FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * TL::WM + i * 16) * TL::LDC + wn * TL::WN + j * 16,
                              acc[i][j], TL::LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * kBN; e += kThreads) {
    const int r = e / kBN;
    const int c = e % kBN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      const float a = Cs[r * TL::LDC + c];
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + m) * N + n] = a;
      else
        y[(size_t)m * N + n] = __float2bfloat16(a * s[n]);
    }
  }
}

// Sums the K splits in split order, applies the scale, rounds to bf16.
__global__ void qmm_reduce(const float* __restrict__ partial,
                           const float* __restrict__ s,
                           __nv_bfloat16* __restrict__ y, int M, int N,
                           int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.0f;
    for (int z = 0; z < splits; ++z) a += partial[(size_t)z * total + i];
    y[i] = __float2bfloat16(a * s[i % N]);
  }
}

template <int BM, int BK>
cudaError_t launch_tiles(const __nv_bfloat16* x, const int8_t* w, const float* s,
                         __nv_bfloat16* y, float* part, int M, int N, int K,
                         int splits, int k_per_split, cudaStream_t st) {
  if (k_per_split % BK != 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  qmm_kernel<BM, BK><<<grid, kThreads, 0, st>>>(x, w, s, y, part, M, N, K,
                                                 k_per_split);
  return cudaGetLastError();
}

}  // namespace

// block_m is 16 (K tiles 128 deep) or 64 (64 deep); k_per_split is a
// multiple of that depth; partial holds splits * M * N floats when
// splits > 1 and is ignored otherwise.
extern "C" int aios_quantized_matmul(const void* x, const void* w,
                                     const void* s, void* y, void* partial,
                                     int M, int N, int K, int block_m,
                                     int splits, int k_per_split,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (block_m == 16) {
    err = launch_tiles<16, 128>(xb, wq, sc, yb, part, M, N, K, splits, k_per_split, st);
  } else if (block_m == 64) {
    err = launch_tiles<64, 64>(xb, wq, sc, yb, part, M, N, K, splits, k_per_split, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t total = (size_t)M * N;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  qmm_reduce<<<blocks, 256, 0, st>>>(part, sc, yb, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
