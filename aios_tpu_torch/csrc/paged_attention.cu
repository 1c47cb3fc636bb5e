// Paged decode attention over a bf16 page pool: one query per slot,
// q [B, H, D], pools [N, P, KH, D], tables [B, MB] int32, lengths [B] int32
// -> o [B, H, D].
//
// Replaces: aios_tpu/ops/paged_attention.py, `paged_decode_attention` (the
// Pallas `_paged_decode_kernel` launched by `_paged_call`), which reads the
// page table by scalar prefetch and DMAs only the pages that hold valid rows.
//
// What bounds it on the H100: the K/V bytes of each slot's valid rows. Every
// row is read once and used for G = H/KH query heads, about 2*G operations
// per byte, so 3.35 TB/s bounds it.
//
// What the design does about it: one block per (slot, kv head), so the G
// query heads of a group share every K/V row the block loads (the point of
// GQA; the TPU kernel looped over kv heads inside one program instead). The
// block walks only the columns [start, length] of its slot, reading
// tables[b, col / P] itself; no page outside the slot's valid range is
// touched. Its eight warps take turns over 32-row chunks of those columns,
// each warp with its own fp32 online softmax, and merge their (max, sum,
// output) at the end, so one long slot keeps eight chunks in flight and no
// barrier runs per chunk. Within a chunk a lane owns one cache row: it loads
// the row's K with 16-byte loads and forms the G scores against q held in
// shared memory; max and sum are warp reductions; for P @ V each lane owns
// D/32 output dims of every head, loads those dims of all 32 V rows up front
// (one coalesced line per row, in flight together with the K loads) and takes
// each row's probabilities from its lane by shuffle.
// Row `lengths[b]` is the token just written, so a slot has lengths[b] + 1
// valid rows; an inactive slot arrives with length 0 and reads one row of the
// page tables[b, 0] names, which stays finite. The mask is the TPU kernel's
// whole mask: col <= length, the sliding window col > length - window, and
// col < sink || col >= win_starts[b] when win_starts is given; p is rounded
// to bf16 before the P @ V product, as the TPU kernel casts p to the pool
// dtype. Not yet: splitting a long slot over several blocks (flash-decoding),
// which is what fills 132 SMs when B * KH is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;  // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool live_col(int col, int length, int window,
                                         const int* win_starts, int sink,
                                         int ws) {
  return col <= length && (window <= 0 || col > length - window) &&
         (win_starts == nullptr || col < sink || col >= ws);
}

// two bf16 packed in a word (low half first) as floats: bf16 is the top
// half of an fp32
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ win_starts,
                    __nv_bfloat16* __restrict__ o, int H, int KH, int P, int MB,
                    int window, int sink, float sm_scale) {
  constexpr int KV = D / 8;   // 16-byte vectors per K row
  constexpr int DL = D / 32;  // output dims per lane and head
  __shared__ __align__(16) float qs[kMaxG * D];
  __shared__ float m_w[kWarps][kMaxG];
  __shared__ float l_w[kWarps][kMaxG];
  __shared__ float acc_w[kWarps][kMaxG * D];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int length = lengths[b];
  const int total = length + 1;
  const int ws = win_starts != nullptr ? win_starts[b] : 0;
  const int c_lo = window > 0 ? max(total - window, 0) : 0;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + kh * G) * D + i]);
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][DL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[g][d] = 0.f;
  }

  for (int c0 = c_lo + warp * 32; c0 < total; c0 += kWarps * 32) {
    const int col = c0 + lane;
    const bool in = col < total;
    size_t row = 0;  // element offset of this lane's cache row in a pool
    uint4 kr[KV];
    if (in) {
      const int page = tables[(size_t)b * MB + col / P];
      row = (((size_t)page * P + col % P) * KH + kh) * D;
#pragma unroll
      for (int i = 0; i < KV; ++i)
        kr[i] = *reinterpret_cast<const uint4*>(k_pool + row + i * 8);
    } else {
#pragma unroll
      for (int i = 0; i < KV; ++i) kr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    // every V row of the chunk at once (this lane's D/32 dims of each), so
    // their loads fly together with the K loads; rows past the slot are 0
    uint32_t vr[32][DL / 2];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const size_t row_j = __shfl_sync(kFull, static_cast<unsigned long long>(row), j);
      const uint32_t* vp = reinterpret_cast<const uint32_t*>(v_pool + row_j + lane * DL);
#pragma unroll
      for (int d = 0; d < DL / 2; ++d) vr[j][d] = c0 + j < total ? vp[d] : 0u;
    }
    const bool live = in && live_col(col, length, window, win_starts, sink, ws);

    // scores of this lane's row for every head of the group, then the
    // online softmax over the warp's 32 rows
    float p_bf[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      p_bf[g] = 0.f;
      if (g >= G) continue;
      const float* qg = qs + g * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < KV; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(qg + i * 8);
        const float4 qb = *reinterpret_cast<const float4*>(qg + i * 8 + 4);
        const float2 k0 = bf16x2_to_float2(kr[i].x);
        const float2 k1 = bf16x2_to_float2(kr[i].y);
        const float2 k2 = bf16x2_to_float2(kr[i].z);
        const float2 k3 = bf16x2_to_float2(kr[i].w);
        dot += qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
               qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
      }
      const float s = live ? dot * sm_scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      p_bf[g] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[g][d] *= alpha;
    }

    // acc[g] += p[g] @ V over the chunk's rows
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v[DL];
#pragma unroll
      for (int d = 0; d < DL / 2; ++d) {
        const float2 f = bf16x2_to_float2(vr[j][d]);
        v[2 * d] = f.x;
        v[2 * d + 1] = f.y;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        const float pj = __shfl_sync(kFull, p_bf[g], j);
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[g][d] += pj * v[d];
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) acc_w[warp][g * D + lane * DL + d] = acc[g][d];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][g] - mx);
      lsum += l_w[w][g] * f;
      out += acc_w[w][i] * f;
    }
    o[((size_t)b * H + kh * G) * D + i] =
        __float2bfloat16(out / (lsum <= 0.f ? 1.f : lsum));
  }
}

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, const void* win_starts,
           void* o, int B, int H, int KH, int P, int MB, int window, int sink,
           float sm_scale, cudaStream_t st) {
  const dim3 grid(B, KH);
  paged_decode_kernel<D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(win_starts), static_cast<__nv_bfloat16*>(o), H,
      KH, P, MB, window, sink, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no sliding window; win_starts may be null (no sink mask).
// D must be 64 or 128 and H / KH at most 8.
extern "C" int aios_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, const void* win_starts, void* o, int B, int H, int KH,
    int D, int P, int MB, int window, int sink, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KH != 0 || H / KH > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch<64>(q, k_pool, v_pool, tables, lengths, win_starts, o, B, H,
                        KH, P, MB, window, sink, sm_scale, st);
    case 128:
      return launch<128>(q, k_pool, v_pool, tables, lengths, win_starts, o, B,
                         H, KH, P, MB, window, sink, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
