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
// What bounds it on the H100: in decode M is the number of slots (8), so the
// product does 2*M = 16 operations per weight element, or about 30 per byte
// of nibbles and scales, far below the ~295 the card needs before compute
// matters: the packed bytes over 3.35 TB/s bound it. In prefill M is the
// bucket (>= 128) and the bf16 tensor-core rate (989 TFLOP/s) bounds it.
//
// What the design does about it: the weight leaves device memory as packed
// nibbles in 16-byte vector loads and becomes bf16 only in shared memory, so
// the dequantized matrix never exists in device memory. A K tile is one
// 128-row group: its 64 packed rows unpack into 128 bf16 rows, the low
// nibbles to rows 0..63 and the high nibbles to rows 64..127, and each value
// is float(nibble - 8) * s[group, n] rounded to bf16 (round to nearest even)
// as it is written, exactly the plain version's dequantized weight. Group
// scales cannot post-scale the accumulator, so the scale goes on the weight
// tile and the epilogue only rounds. The product runs on the tensor cores
// (WMMA bf16 16x16x16 fragments, fp32 accumulation); the next K tile's loads
// (x, packed bytes and its 16 scales per thread) are issued into registers
// before the tensor cores work on the current one. Decode-sized M takes
// 16-row tiles, larger M 64-row tiles, both 64 columns wide. A small M leaves
// too few output tiles to fill 132 SMs, so K is split over blocks: each
// split writes an fp32 partial and a second kernel sums the splits in a fixed
// order (deterministic, so greedy streams repeat) and rounds. Ragged M and N
// edges are masked; K is a multiple of 128. Not yet: TMA, wgmma, a
// multi-stage shared-memory ring, a GEMV-shaped decode variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kGroup = 128;        // K rows per scale, and the K tile depth
constexpr int kHalf = kGroup / 2;  // packed byte rows per K tile
constexpr int kBN = 64;
constexpr int kThreads = 128;

template <int BM>
struct Tile {
  static constexpr int BK = kGroup;
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
  static constexpr int A_VECS = BM * BK / 8 / kThreads;       // 8 bf16 each
  static constexpr int B_VECS = kHalf * kBN / 16 / kThreads;  // 16 bytes each
  static_assert(BM * BK % (8 * kThreads) == 0, "A tile splits evenly");
  static_assert(kHalf * kBN % (16 * kThreads) == 0, "B tile splits evenly");
  // every B vector of a thread covers the same 16 columns, so a thread
  // needs the scales of those 16 columns only
  static_assert(kThreads % (kBN / 16) == 0, "B columns fixed per thread");
  static constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  // the epilogue's fp32 tile reuses the operand tiles' memory
  static constexpr int BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

union Bf16x8 {
  uint4 v;
  uint16_t h[8];
};

union U8x16 {
  int4 v;
  uint8_t b[16];
};

// 8 bf16 of row m from column k on, zero for rows outside [0, M).
__device__ __forceinline__ uint4 load_x(const __nv_bfloat16* x, int M, int K,
                                        int m, int k, bool vec) {
  if (m < M && vec) return *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
  Bf16x8 r;
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
  for (int e = 0; e < 8; ++e) r.h[e] = m < M ? raw[(size_t)m * K + k + e] : 0;
  return r.v;
}

// 16 packed bytes of packed row kp from column n on, zero past N.
__device__ __forceinline__ int4 load_p(const uint8_t* p, int N, int kp, int n,
                                       bool vec) {
  if (vec && n + 16 <= N)
    return *reinterpret_cast<const int4*>(p + (size_t)kp * N + n);
  U8x16 r;
#pragma unroll
  for (int e = 0; e < 16; ++e) r.b[e] = n + e < N ? p[(size_t)kp * N + n + e] : 0;
  return r.v;
}

// the 16 scales of group g from column n on, zero past N.
__device__ __forceinline__ void load_s(const float* s, int N, int g, int n,
                                       bool vec, float* out) {
  const float* row = s + (size_t)g * N;
  if (vec && n + 16 <= N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(row + n + 4 * i);
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = n + e < N ? row[n + e] : 0.f;
  }
}

// float(nibble - 8) * scale rounded to bf16, as raw bits
__device__ __forceinline__ uint32_t w_bits(uint32_t nibble, float scale) {
  const float w = static_cast<float>(static_cast<int>(nibble) - 8) * scale;
  return __bfloat16_as_ushort(__float2bfloat16_rn(w));
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
w4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ p,
          const float* __restrict__ s, __nv_bfloat16* __restrict__ y,
          float* __restrict__ partial, int M, int N, int K, int k_per_split) {
  using TL = Tile<BM>;
  constexpr int BK = TL::BK;
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
  const int bcol = (tid % (kBN / 16)) * 16;  // this thread's B columns
  // 16-byte vector loads need aligned rows; anything else takes the
  // element-wise path
  const bool x_vec = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool p_vec = (N % 16) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const bool s_vec = (N % 4) == 0 && (reinterpret_cast<uintptr_t>(s) & 15) == 0;

  uint4 a_reg[TL::A_VECS];
  int4 b_reg[TL::B_VECS];
  float sc[16];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TL::A_VECS; ++i) {
      const int v = tid + i * kThreads;
      a_reg[i] = load_x(x, M, K, m0 + v / (BK / 8), k0 + (v % (BK / 8)) * 8, x_vec);
    }
#pragma unroll
    for (int i = 0; i < TL::B_VECS; ++i) {
      const int v = tid + i * kThreads;
      b_reg[i] = load_p(p, N, k0 / 2 + v / (kBN / 16), n0 + bcol, p_vec);
    }
    load_s(s, N, k0 / kGroup, n0 + bcol, s_vec, sc);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TL::FM][TL::FN];
#pragma unroll
  for (int i = 0; i < TL::FM; ++i)
#pragma unroll
    for (int j = 0; j < TL::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // the fetched tile into shared memory; nibbles -> scaled bf16 on the way
#pragma unroll
    for (int i = 0; i < TL::A_VECS; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (v / (BK / 8)) * TL::LDA + (v % (BK / 8)) * 8) =
          a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < TL::B_VECS; ++i) {
      const int r = (tid + i * kThreads) / (kBN / 16);  // packed row in the tile
      U8x16 raw;
      raw.v = b_reg[i];
      uint32_t lo[8], hi[8];  // two bf16 each, low half first
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t b0 = raw.b[2 * e], b1 = raw.b[2 * e + 1];
        lo[e] = w_bits(b0 & 15u, sc[2 * e]) | (w_bits(b1 & 15u, sc[2 * e + 1]) << 16);
        hi[e] = w_bits(b0 >> 4, sc[2 * e]) | (w_bits(b1 >> 4, sc[2 * e + 1]) << 16);
      }
      uint4* dlo = reinterpret_cast<uint4*>(Bs + r * TL::LDB + bcol);
      uint4* dhi = reinterpret_cast<uint4*>(Bs + (r + kHalf) * TL::LDB + bcol);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
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
        y[(size_t)m * N + n] = __float2bfloat16(a);
    }
  }
}

// Sums the K splits in split order and rounds to bf16.
__global__ void w4_reduce(const float* __restrict__ partial,
                          __nv_bfloat16* __restrict__ y, int M, int N,
                          int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.0f;
    for (int z = 0; z < splits; ++z) a += partial[(size_t)z * total + i];
    y[i] = __float2bfloat16(a);
  }
}

template <int BM>
cudaError_t launch_tiles(const __nv_bfloat16* x, const uint8_t* p, const float* s,
                         __nv_bfloat16* y, float* part, int M, int N, int K,
                         int splits, int k_per_split, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  w4_kernel<BM><<<grid, kThreads, 0, st>>>(x, p, s, y, part, M, N, K, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// block_m is 16 or 64; K and k_per_split are multiples of 128 (one scale
// group per K tile); partial holds splits * M * N floats when splits > 1
// and is ignored otherwise.
extern "C" int aios_int4_matmul(const void* x, const void* packed, const void* s,
                                void* y, void* partial, int M, int N, int K,
                                int block_m, int splits, int k_per_split,
                                void* stream) {
  if (K % kGroup != 0 || k_per_split % kGroup != 0 || k_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (block_m == 16) {
    err = launch_tiles<16>(xb, pk, sc, yb, part, M, N, K, splits, k_per_split, st);
  } else if (block_m == 64) {
    err = launch_tiles<64>(xb, pk, sc, yb, part, M, N, K, splits, k_per_split, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const size_t total = (size_t)M * N;
  const int blocks = static_cast<int>(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  w4_reduce<<<blocks, 256, 0, st>>>(part, yb, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
