// Decode attention over the dense slot cache, bf16 or int8: T queries per
// slot, q [B, T, H, D] bf16, caches [B, C, KH, D], lengths [B] and strides
// [B] int32 -> o [B, T, H, D] bf16. Query t of slot b sits at row
// pos = lengths[b] + t * strides[b] and sees the cache rows col <= pos and,
// with a sliding window, col > pos - window. An int8 cache carries f32 scales
// [B, C, KH] for K and for V, one per (cache row, kv head), as the engine
// stores them. T = 1 is the single-query decode step.
//
// Replaces: aios_tpu/ops/decode_attention.py, `decode_attention` (bf16 cache)
// and `decode_attention_int8` (int8 cache + scales), the Pallas
// `_decode_kernel` launched by `_ragged_call`; and
// aios_tpu/ops/verify_attention.py, `multiquery_decode_attention` and
// `multiquery_decode_attention_int8`, the Pallas `_mq_kernel` launched by
// `_mq_call`. Those run one program per slot, loop over the kv heads inside
// it and DMA [block_kv, KH*D] slabs of the valid rows into VMEM, double
// buffered, with the int8 scales transposed to [B, KH, C] for the lane tiling.
//
// What bounds it on the H100: the K/V bytes of each slot's valid rows (and
// for int8 their scales), read once: 3.35 TB/s. Each row serves the
// R = T * G query rows of its (slot, kv head), G = H / KH, about 4 * R
// operations per element, so from a few dozen query rows on, the fp32 units
// this kernel multiplies with bound it before the memory does.
//
// What the design does about it: the skeleton of paged_attention.cu with the
// page table replaced by the row index (b * C + col) * KH + kh. One block per
// (tile of 8 query rows, kv head, slot); query rows are ordered (t, g), so a
// tile holds the G heads of 8 / G consecutive queries, and T = 1 is one tile.
// The tile index is the fastest grid dimension, so the blocks that share a
// (slot, kv head) run together and find each other's K/V rows in the L2. A
// block walks only the rows its own queries can see, [pos of its first query
// + 1 - window, pos of its last query + 1), clamped to [0, C): a saturated
// slot, whose staircase runs past the cache end, never reads outside the
// cache (its outputs are unconsumed by the engine's contract). The eight
// warps take turns over 32-row chunks, each with its own fp32 online softmax,
// and merge (max, sum, output) at the end. Within a chunk a lane owns one
// cache row: 16-byte K loads, the tile's scores against q held in shared
// memory, warp reductions for max and sum, and for P @ V each lane owns D/32
// output dims of every query row and takes each cache row's probability from
// its lane by shuffle. A query row with no visible column gives 0.
// Arithmetic follows the four TPU kernels, which differ:
//   decode_attention (bf16, T = 1): q * sm_scale rounded to bf16 before the
//     dot; p rounded to bf16 before P @ V;
//   multiquery_decode_attention (bf16): q * sm_scale kept in f32; p rounded
//     to bf16;
//   both int8 kernels: f32 throughout, q scaled first,
//     score = (q . k_int8) * k_scale[row], p * v_scale[row] multiplies
//     v_int8 without rounding, and the running sum takes p itself.
//
// Split slots (the single-query bf16 entry, K8): the launch can split each
// (tile, kv head, slot)'s visible rows over up to eight blocks
// (attention_common.cuh): block z walks only its share of the rows the mask
// exposes, reduces it to a partial softmax, and the block that draws the
// group's last ticket merges the partials in split order, in the same
// launch. A decode step has only B * KH (slot, kv head) pairs, 32 for
// TinyLlama's 8 slots, against 132 SMs; split they fill the card and the
// longest slot no longer runs through one block. The other three entries
// launch one split, the kernel they had.
// Not yet: tensor-core products for the R x 32 score tiles (mma.sync or
// wgmma), which is what the multi-query shapes want, and the split for K6, K7
// and K9.

#include "attention_common.cuh"

namespace {

constexpr int kRows = kMaxG;  // query rows per block

template <typename T, int D, bool kQRound>
__device__ __forceinline__ void dense_attention(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k_cache, const T* __restrict__ v_cache,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ lengths,
                       const int* __restrict__ strides,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ partial,
                       int* __restrict__ tickets, int Tq, int H, int KH, int C,
                       int window, float sm_scale, int n_splits) {
  using E = Elem<T>;
  constexpr int KV = D / E::kPerVec;  // 16-byte vectors per K row
  constexpr int DL = D / 32;          // output dims per lane and query row
  constexpr int VW = (DL * sizeof(T) + 3) / 4;  // words per lane of a V row
  __shared__ __align__(16) float qs[kRows * D];
  __shared__ int qpos[kRows];  // each query row's own cache row
  __shared__ float m_w[kWarps][kRows];
  __shared__ float l_w[kWarps][kRows];
  __shared__ float acc_w[kWarps][kRows * D];
  __shared__ float m_part[kRows];  // the block's partial when split
  __shared__ float l_part[kRows];
  __shared__ int last;

  // only K8's build (bf16 cache, q rounded) takes a split: the other three
  // compile to the single-split kernel they had, registers and all
  const int splits = kQRound ? n_splits : 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x % splits;  // a group's splits are consecutive in x
  const int r0 = blockIdx.x / splits * kRows;  // first query row of this tile
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int nr = min(kRows, Tq * G - r0);  // query rows in this tile
  const int base = lengths[b];
  const int stride = strides != nullptr ? strides[b] : 0;
  const int pos_lo = base + (r0 / G) * stride;
  const int pos_hi = base + ((r0 + nr - 1) / G) * stride;
  int c_lo = window > 0 ? max(pos_lo + 1 - window, 0) : 0;
  int c_hi = min(pos_hi + 1, C);
  if (splits > 1) clip_to_split(c_lo, c_hi, split, splits);

  // query row r of the tile is head kh * G + g of query t
  for (int i = tid; i < nr * D; i += kThreads) {
    const int rr = r0 + i / D;
    const int t = rr / G, g = rr % G;
    const float x =
        __bfloat162float(q[(((size_t)b * Tq + t) * H + kh * G + g) * D + i % D]) *
        sm_scale;
    qs[i] = kQRound ? __bfloat162float(__float2bfloat16(x)) : x;
  }
  if (tid < kRows) qpos[tid] = base + (min(r0 + tid, r0 + nr - 1) / G) * stride;
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[r][d] = 0.f;
  }

  for (int c0 = c_lo + warp * 32; c0 < c_hi; c0 += kWarps * 32) {
    const int col = c0 + lane;
    const bool in = col < c_hi;
    size_t row = 0;  // element offset of this lane's cache row
    uint4 kr[KV];
    float k_mul = 1.f, v_mul = 0.f;
    if (in) {
      const size_t srow = ((size_t)b * C + col) * KH + kh;  // scale index
      row = srow * D;
#pragma unroll
      for (int i = 0; i < KV; ++i)
        kr[i] = *reinterpret_cast<const uint4*>(k_cache + row + i * E::kPerVec);
      if constexpr (E::kQuant) {
        k_mul = k_scales[srow];
        v_mul = v_scales[srow];
      }
    } else {
#pragma unroll
      for (int i = 0; i < KV; ++i) kr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    // every V row of the chunk at once (this lane's D/32 dims of each), so
    // their loads fly together with the K loads; rows past the range load
    // row 0 of the cache (always in bounds) and are zeroed
    uint32_t vr[32][VW];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const size_t row_j = __shfl_sync(kFull, static_cast<unsigned long long>(row), j);
      uint32_t w[VW];
      E::template load_v<DL>(v_cache + row_j + lane * DL, w);
#pragma unroll
      for (int d = 0; d < VW; ++d) vr[j][d] = c0 + j < c_hi ? w[d] : 0u;
    }

    // scores of this lane's cache row for every query row of the tile, each
    // under its own staircase mask, then the online softmax over the warp's
    // 32 cache rows
    float pv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pv[r] = 0.f;
      if (r >= nr) continue;
      const int pos = qpos[r];
      const bool live = in && col <= pos && (window <= 0 || col > pos - window);
      const float* qr = qs + r * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < KV; ++i) dot += E::dot(qr + i * E::kPerVec, kr[i]);
      const float s = live ? dot * k_mul : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      if constexpr (E::kQuant)
        pv[r] = p * v_mul;
      else
        pv[r] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[r][d] *= alpha;
    }

    // acc[r] += p[r] @ V over the chunk's rows
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v[DL];
      E::template v_floats<DL>(vr[j], v);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) continue;
        const float pj = __shfl_sync(kFull, pv[r], j);
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[r][d] += pj * v[d];
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    if (lane == 0) {
      m_w[warp][r] = m[r];
      l_w[warp][r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) acc_w[warp][r * D + lane * DL + d] = acc[r][d];
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][r] - mx);
      lsum += l_w[w][r] * f;
      out += acc_w[w][i] * f;
    }
    if (splits > 1) {  // this block's partial: only this thread reads or writes acc_w[0][i]
      acc_w[0][i] = out;
      if (i % D == 0) {
        m_part[r] = mx;
        l_part[r] = lsum;
      }
      continue;
    }
    const int rr = r0 + r;
    const int t = rr / G, g = rr % G;
    o[(((size_t)b * Tq + t) * H + kh * G + g) * D + i % D] =
        __float2bfloat16(out / (lsum <= 0.f ? 1.f : lsum));
  }
  if (splits > 1) {
    const int group = (b * KH + kh) * (gridDim.x / splits) + blockIdx.x / splits;
    merge_splits<D>(m_part, l_part, acc_w[0], nr, split, splits,
                    partial + (size_t)group * splits * partial_floats<D>(), tickets + group,
                    &last, [&](int i, float v) {
                      const int rr = r0 + i / D;
                      const int t = rr / G, g = rr % G;
                      o[(((size_t)b * Tq + t) * H + kh * G + g) * D + i % D] =
                          __float2bfloat16(v);
                    });
  }
}

#define DENSE_ATTENTION_PARAMS                                                          \
  const __nv_bfloat16 *__restrict__ q, const T *__restrict__ k_cache,                   \
      const T *__restrict__ v_cache, const float *__restrict__ k_scales,                \
      const float *__restrict__ v_scales, const int *__restrict__ lengths,              \
      const int *__restrict__ strides, __nv_bfloat16 *__restrict__ o,                   \
      float *__restrict__ partial, int *__restrict__ tickets, int Tq, int H, int KH,    \
      int C, int window, float sm_scale, int n_splits
#define DENSE_ATTENTION_ARGS                                                            \
  q, k_cache, v_cache, k_scales, v_scales, lengths, strides, o, partial, tickets, Tq,   \
      H, KH, C, window, sm_scale, n_splits

template <typename T, int D, bool kQRound>
__global__ void __launch_bounds__(kThreads) dense_attention_kernel(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound>(DENSE_ATTENTION_ARGS);
}

// K8's build at D = 64 keeps two blocks per SM: a split grid has up to eight
// blocks per (slot, kv head). The other builds keep the registers they had.
template <typename T, int D, bool kQRound>
__global__ void __launch_bounds__(kThreads, 2) dense_attention_kernel_2(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound>(DENSE_ATTENTION_ARGS);
}

template <typename T, int D, bool kQRound>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scales, const void* v_scales, const void* lengths,
           const void* strides, void* o, void* partial, void* tickets, int B, int Tq,
           int H, int KH, int C, int window, float sm_scale, int splits, cudaStream_t st) {
  const int G = H / KH;
  const dim3 grid((Tq * G + kRows - 1) / kRows * splits, KH, B);
  // only the build a launch needs is compiled
  void (*kernel)(DENSE_ATTENTION_PARAMS);
  if constexpr (kQRound && D == 64)
    kernel = dense_attention_kernel_2<T, D, kQRound>;
  else
    kernel = dense_attention_kernel<T, D, kQRound>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
      static_cast<const int*>(strides), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(partial), static_cast<int*>(tickets), Tq, H, KH, C, window,
      sm_scale, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kQRound>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* k_scales, const void* v_scales, const void* lengths,
             const void* strides, void* o, int B, int Tq, int H, int KH, int D,
             int C, int window, float sm_scale, void* stream, int splits = 1,
             void* partial = nullptr, void* tickets = nullptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tq < 1 || C < 1 || B > 65535 || KH > 65535 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!kQRound || !partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch<T, 64, kQRound>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                    strides, o, partial, tickets, B, Tq, H, KH, C, window,
                                    sm_scale, splits, st);
    case 128:
      return launch<T, 128, kQRound>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                     strides, o, partial, tickets, B, Tq, H, KH, C, window,
                                    sm_scale, splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window. D must be 64 or 128, H / KH at most 8
// and B and KH at most 65535 (grid dimensions).

// One query per slot over rows [0, lengths[b]] of a bf16 cache, each slot's
// visible rows split over `splits` blocks (1 to 8), merged in the same launch.
// With splits > 1, `partial` holds B * KH * splits * 8 * (D + 2) floats and
// `tickets` B * KH ints, 0 between launches (a launch leaves them at 0).
extern "C" int aios_decode_attention(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lengths,
                                     void* o, void* partial, void* tickets, int B,
                                     int H, int KH, int D, int C, int window,
                                     int splits, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k_cache, v_cache, nullptr, nullptr,
                                       lengths, nullptr, o, B, 1, H, KH, D, C,
                                       window, sm_scale, stream, splits, partial, tickets);
}

// The same over an int8 cache: k_scales / v_scales are [B, C, KH] f32.
extern "C" int aios_decode_attention_int8(const void* q, const void* k_cache,
                                          const void* v_cache, const void* k_scales,
                                          const void* v_scales, const void* lengths,
                                          void* o, int B, int H, int KH, int D,
                                          int C, int window, float sm_scale,
                                          void* stream) {
  return dispatch<int8_t, false>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                 nullptr, o, B, 1, H, KH, D, C, window, sm_scale,
                                 stream);
}

// T queries per slot over a bf16 cache, q and o [B, T, H, D].
extern "C" int aios_multiquery_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* lengths,
    const void* strides, void* o, int B, int T, int H, int KH, int D, int C,
    int window, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k_cache, v_cache, nullptr, nullptr,
                                        lengths, strides, o, B, T, H, KH, D, C,
                                        window, sm_scale, stream);
}

// The same over an int8 cache with [B, C, KH] f32 scales.
extern "C" int aios_multiquery_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
    const void* v_scales, const void* lengths, const void* strides, void* o, int B,
    int T, int H, int KH, int D, int C, int window, float sm_scale, void* stream) {
  return dispatch<int8_t, false>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                 strides, o, B, T, H, KH, D, C, window, sm_scale,
                                 stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
