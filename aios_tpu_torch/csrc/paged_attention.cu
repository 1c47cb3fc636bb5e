// Paged decode attention over a bf16 or an int8 page pool: one query per
// slot, q [B, H, D] bf16, pools [N, P, KH, D], tables [B, MB] int32, lengths
// [B] int32 -> o [B, H, D] bf16. An int8 pool carries f32 scales [N, P, KH]
// for K and for V, one per (page row, kv head).
//
// Replaces: aios_tpu/ops/paged_attention.py, `paged_decode_attention` (bf16
// pool) and `paged_decode_attention_int8` (int8 pool + scales), both the
// Pallas `_paged_decode_kernel` launched by `_paged_call`, which reads the
// page table by scalar prefetch and DMAs only the pages that hold valid rows.
//
// What bounds it on the H100: the K/V bytes of each slot's valid rows (and
// for int8 their scales). Every row is read once and used for G = H/KH query
// heads, about 2*G operations per element, so 3.35 TB/s bounds it. The int8
// pool halves those bytes.
//
// What the design does about it: one block per (slot, kv head), so the G
// query heads of a group share every K/V row the block loads (the point of
// GQA; the TPU kernel looped over kv heads inside one program instead). The
// block walks only the columns [start, length] of its slot, reading
// tables[b, col / P] itself; no page outside the slot's valid range is
// touched, so table entries below a sliding window, which the allocator has
// already returned to the pool, are never read. Its eight warps take turns
// over 32-row chunks of those columns, each warp with its own fp32 online
// softmax, and merge their (max, sum, output) at the end, so one long slot
// keeps eight chunks in flight and no barrier runs per chunk. Within a chunk
// a lane owns one cache row: it loads the row's K with 16-byte loads and
// forms the G scores against q held in shared memory; max and sum are warp
// reductions; for P @ V each lane owns D/32 output dims of every head, loads
// those dims of all 32 V rows up front (in flight together with the K loads)
// and takes each row's probability from its lane by shuffle.
// Row `lengths[b]` is the token just written, so a slot has lengths[b] + 1
// valid rows; an inactive slot arrives with length 0 and reads one row of the
// page tables[b, 0] names, which stays finite (int8 scale pools start at
// 1.0). The mask is the TPU kernel's whole mask: col <= length, the sliding
// window col > length - window, and col < sink || col >= win_starts[b] when
// win_starts is given.
// Arithmetic follows the TPU kernel's two branches. bf16 pool: score =
// (q . k) * sm_scale, and p is rounded to bf16 before the P @ V product, as
// the TPU kernel casts p to the pool dtype. int8 pool: all in f32, q is
// scaled by sm_scale first, score = (q . k_int8) * k_scale[row], and
// p * v_scale[row] multiplies v_int8 without rounding; the running sum takes
// p itself. Not yet: splitting a long slot over several blocks
// (flash-decoding), which is what fills 132 SMs when B * KH is small.

#include "attention_common.cuh"

namespace {

__device__ __forceinline__ bool live_col(int col, int length, int window,
                                         const int* win_starts, int sink,
                                         int ws) {
  return col <= length && (window <= 0 || col > length - window) &&
         (win_starts == nullptr || col < sink || col >= ws);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ win_starts,
                    __nv_bfloat16* __restrict__ o, int H, int KH, int P, int MB,
                    int window, int sink, float sm_scale) {
  using E = Elem<T>;
  constexpr int KV = D / E::kPerVec;  // 16-byte vectors per K row
  constexpr int DL = D / 32;          // output dims per lane and head
  constexpr int VW = (DL * sizeof(T) + 3) / 4;  // words per lane of a V row
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
  // int8: q scaled before the dot, each score by its row's K scale;
  // bf16: each score by sm_scale
  const float q_mul = E::kQuant ? sm_scale : 1.f;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + kh * G) * D + i]) * q_mul;
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
    float k_mul = sm_scale, v_mul = 0.f;
    if (in) {
      const int page = tables[(size_t)b * MB + col / P];
      const size_t srow = ((size_t)page * P + col % P) * KH + kh;  // scale index
      row = srow * D;
#pragma unroll
      for (int i = 0; i < KV; ++i)
        kr[i] = *reinterpret_cast<const uint4*>(k_pool + row + i * E::kPerVec);
      if constexpr (E::kQuant) {
        k_mul = k_scales[srow];
        v_mul = v_scales[srow];
      }
    } else {
#pragma unroll
      for (int i = 0; i < KV; ++i) kr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    // every V row of the chunk at once (this lane's D/32 dims of each), so
    // their loads fly together with the K loads. Rows past the slot load
    // row 0 of the pool (always in bounds) and are zeroed: an unconditional
    // load and a select measured faster than a branch around the load
    uint32_t vr[32][VW];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const size_t row_j = __shfl_sync(kFull, static_cast<unsigned long long>(row), j);
      uint32_t w[VW];
      E::template load_v<DL>(v_pool + row_j + lane * DL, w);
#pragma unroll
      for (int d = 0; d < VW; ++d) vr[j][d] = c0 + j < total ? w[d] : 0u;
    }
    const bool live = in && live_col(col, length, window, win_starts, sink, ws);

    // scores of this lane's row for every head of the group, then the
    // online softmax over the warp's 32 rows
    float pv[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      pv[g] = 0.f;
      if (g >= G) continue;
      const float* qg = qs + g * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < KV; ++i) dot += E::dot(qg + i * E::kPerVec, kr[i]);
      const float s = live ? dot * k_mul : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      if constexpr (E::kQuant)
        pv[g] = p * v_mul;
      else
        pv[g] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[g][d] *= alpha;
    }

    // acc[g] += p[g] @ V over the chunk's rows
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v[DL];
      E::template v_floats<DL>(vr[j], v);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        const float pj = __shfl_sync(kFull, pv[g], j);
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

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* lengths, const void* win_starts, void* o, int B, int H,
           int KH, int P, int MB, int window, int sink, float sm_scale,
           cudaStream_t st) {
  const dim3 grid(B, KH);
  paged_decode_kernel<T, D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(win_starts),
      static_cast<__nv_bfloat16*>(o), H, KH, P, MB, window, sink, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scales, const void* v_scales, const void* tables,
             const void* lengths, const void* win_starts, void* o, int B, int H,
             int KH, int D, int P, int MB, int window, int sink, float sm_scale,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KH != 0 || H / KH > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, k_scales, v_scales, tables, lengths,
                           win_starts, o, B, H, KH, P, MB, window, sink, sm_scale, st);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, k_scales, v_scales, tables, lengths,
                            win_starts, o, B, H, KH, P, MB, window, sink, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window; win_starts may be null (no sink mask).
// D must be 64 or 128 and H / KH at most 8.
extern "C" int aios_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, const void* win_starts, void* o, int B, int H, int KH,
    int D, int P, int MB, int window, int sink, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                 lengths, win_starts, o, B, H, KH, D, P, MB,
                                 window, sink, sm_scale, stream);
}

// The int8 pool: k_scales / v_scales are [N, P, KH] f32.
extern "C" int aios_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* lengths,
    const void* win_starts, void* o, int B, int H, int KH, int D, int P, int MB,
    int window, int sink, float sm_scale, void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scales, v_scales, tables,
                          lengths, win_starts, o, B, H, KH, D, P, MB, window,
                          sink, sm_scale, stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
