// Causal GQA flash attention for prefill: q [B, T, H, D], k/v [B, S, KH, D]
// (bf16, the model's layout) -> o [B, T, H, D].
//
// Replaces: aios_tpu/ops/flash_attention.py, `flash_attention` (the Pallas
// `_flash_kernel`), which walks kv blocks on the TPU's sequential grid axis
// with an online softmax in VMEM scratch.
//
// What bounds it on the H100: the work, 2*T*S*H*D operations under the
// causal triangle (about 1 GFLOP per layer at T = 512) against a few MB of
// q/k/v/o, so the arithmetic rate bounds it, not the bytes.
//
// What the design does about it: both products run on the tensor cores (WMMA
// bf16 16x16x16 fragments, fp32 accumulation). One block per (batch, head, 64
// query rows) with a loop over 64-row kv tiles inside the block, which takes
// the place of the TPU's sequential grid axis; blocks share nothing. Each of
// the four warps owns 16 query rows: their q fragments stay in registers, the
// warp's [16, 64] score tile goes through its own shared-memory scratch, and
// two lanes share a row for the fp32 online softmax (max and sum combined by
// one shuffle). The running output lives in those two lanes' registers; each
// tile's P @ V product lands in the scratch and is folded in as
// o = o * alpha + pv. Masks use -1e30 with an explicit p = 0 where masked, p
// is rounded to bf16 for the PV product as the TPU kernel casts p to the
// value dtype, the output is o / l with l <= 0 -> 1, and kv tiles wholly
// outside the causal triangle or the window are skipped. Every T works, not
// only multiples of 128. Not yet: cp.async/TMA double buffering, wgmma, one
// block serving all heads of a kv group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBKV = 64;          // kv rows per tile
static_assert(kBQ == kBKV, "stage_rows copies 64-row tiles of q, k and v");

// Shared-memory layout for head dim D. Leading dimensions are padded (and
// stay multiples of 8 bf16 / 4 fp32, as WMMA needs); every region starts on
// a 32-byte boundary.
template <int D>
struct Layout {
  static constexpr int LDKV = D + 8;     // bf16, K / V / staged Q rows
  static constexpr int LDS = kBKV + 4;   // fp32, scores
  static constexpr int LDO = D + 4;      // fp32, the P @ V tile
  static constexpr int LDP = kBKV + 8;   // bf16, probabilities
  static constexpr int SCRATCH = 16 * (LDS > LDO ? LDS : LDO);  // floats
  static constexpr size_t kv_bytes = (size_t)kBKV * LDKV * 2;
  static constexpr size_t warp_bytes = SCRATCH * 4 + 16 * LDP * 2;
  static constexpr size_t bytes = 2 * kv_bytes + kWarps * warp_bytes;
};

__device__ __forceinline__ bool visible(int col, int row, int S, int causal,
                                        int window) {
  return col < S && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Copies rows [r0, r0 + kBKV) of a row-strided bf16 matrix (row r at
// base + r * stride) into shared memory, zero from row `rows` on.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* base,
                                           size_t stride, int r0, int rows) {
  constexpr int VEC = D / 8;
  for (int idx = threadIdx.x; idx < kBKV * VEC; idx += kThreads) {
    const int r = idx / VEC;
    const int c = (idx % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDKV + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int T, int S, int H, int KH, int causal, int window,
             float sm_scale) {
  using L = Layout<D>;
  constexpr int DH = D / 2;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kv_bytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* mine = smem + 2 * L::kv_bytes + warp * L::warp_bytes;
  float* scratch = reinterpret_cast<float*>(mine);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(mine + L::SCRATCH * 4);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * kBQ;
  const int w0 = q0 + warp * 16;  // the warp's first query row
  const int r = lane / 2;         // the lane's row within the warp's 16
  const int half = lane % 2;      // which half of the row's columns
  const int row = w0 + r;

  // q rows through the K buffer into fragments that stay in registers
  stage_rows<D>(Ks, q + ((size_t)b * T * H + h) * D, (size_t)H * D, q0, T);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], Ks + warp * 16 * L::LDKV + kk * 16, L::LDKV);

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // dead tiles: the window hides kv rows older than what the OLDEST query
  // row of the block can see; causality hides rows newer than the NEWEST
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1) / kBKV * kBKV;
  const int kv_hi = causal ? min(S, q0 + kBQ) : S;
  const size_t kv_stride = (size_t)KH * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KH + kh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KH + kh) * D;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBKV) {
    __syncthreads();  // every warp is done with the previous tile (and q)
    stage_rows<D>(Ks, kb, kv_stride, t0, S);
    stage_rows<D>(Vs, vb, kv_stride, t0, S);
    __syncthreads();
    // a tile wholly newer than the warp's newest row or older than its
    // oldest row's window adds nothing to these 16 rows
    if ((causal && t0 > w0 + 15) || (window > 0 && t0 + kBKV - 1 <= w0 - window))
      continue;

    // scores [16, 64] = q [16, D] @ K^T, K read as a column-major [D, 64]
#pragma unroll
    for (int n = 0; n < kBKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * L::LDKV + kk * 16, L::LDKV);
        wmma::mma_sync(s, qa[kk], kf, s);
      }
      wmma::store_matrix_sync(scratch + n * 16, s, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the lane's 32 columns, combined with its partner
    const float* srow = scratch + r * L::LDS + half * 32;
    float sc[32];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = t0 + half * 32 + j;
      sc[j] = visible(col, row, S, causal, window) ? srow[j] * sm_scale : kNegInf;
      m_cur = fmaxf(m_cur, sc[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    __nv_bfloat16* prow = Ps + r * L::LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = t0 + half * 32 + j;
      // rows with no visible column in this tile have m_new = -1e30 and
      // would otherwise get p = exp(0) = 1 across the board
      const float p = visible(col, row, S, causal, window) ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      prow[j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // pv [16, D] = p [16, 64] @ V [64, D], into the scratch (scores are
    // consumed), then folded into the lanes' running output
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * L::LDKV + n * 16, L::LDKV);
        wmma::mma_sync(pv, pf, vf, pv);
      }
      wmma::store_matrix_sync(scratch + n * 16, pv, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
    const float* pvrow = scratch + r * L::LDO + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] * alpha + pvrow[d];
    __syncwarp();
  }

  if (row < T) {
    const float inv = 1.f / (l <= 0.f ? 1.f : l);
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
        o + (((size_t)b * T + row) * H + h) * D + half * DH);
#pragma unroll
    for (int d = 0; d < DH / 2; ++d)
      op[d] = __floats2bfloat162_rn(acc[2 * d] * inv, acc[2 * d + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T,
           int S, int H, int KH, int causal, int window, float sm_scale,
           cudaStream_t st) {
  constexpr size_t bytes = Layout<D>::bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, S,
      H, KH, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no sliding window. D must be 32, 64 or 128.
extern "C" int aios_flash_attention(const void* q, const void* k, const void* v,
                                    void* o, int B, int T, int S, int H, int KH,
                                    int D, int causal, int window,
                                    float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, B, T, S, H, KH, causal, window, sm_scale, st);
    case 64:
      return launch<64>(q, k, v, o, B, T, S, H, KH, causal, window, sm_scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, T, S, H, KH, causal, window, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
