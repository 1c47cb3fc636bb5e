// Paged decode attention over a bf16 or an int8 page pool: one query per
// slot, q [B, H, D] bf16, pools [N, P, KH, D], tables [B, MB] int32, lengths
// [B] int32 -> o [B, H, D] bf16. An int8 pool carries f32 scales [N, P, KH]
// for K and for V, one per (page row, kv head).
//
// Replaces: aios_tpu/ops/paged_attention.py:33, the Pallas
// `_paged_decode_kernel` launched by `_paged_call` (`pl.pallas_call` at
// :248) behind `paged_decode_attention` (bf16 pool) and
// `paged_decode_attention_int8` (int8 pool + scales). It runs one program
// per slot, reads the page table by scalar prefetch and DMAs only the pages
// that hold valid rows, looping over the kv heads inside the program.
//
// What bounds it on the H100: the K/V bytes of each slot's visible rows, and
// for int8 their f32 scales, each read once: 3.35 TB/s. Every row serves the
// G = H/KH query heads of its kv head, about 4*G operations per element, far
// below the card's rate.
//
// What the design does about that bound: a decode step has only B * KH (slot,
// kv head) pairs (32 for TinyLlama's 8 slots, 64 for Mistral's) against 132
// SMs, and one long slot would run through one block. So each pair's visible
// rows [c_lo, lengths[b] + 1) are cut into `splits` equal shares of whole
// 32-row warp chunks (the host's split_plan, from shapes alone;
// attention_common.cuh's clip_to_split), one block each, a share never shorter
// than kMinShareRows; a block whose share is empty leaves at once. A block
// first stages the page-table entries of its own share in shared memory,
// issued together with the loads of q, so no chunk waits on a table load
// before its rows: only the lengths, then tables and q, then the rows are
// dependent. Entries outside the share are never read: a page below the window
// may already belong to another slot. The block's eight warps take turns over
// 32-row chunks of its share, each warp with its own fp32 online softmax, and
// fold their (max, sum, output) into one block partial; the block that draws
// its pair's last ticket merges the partials in split order in the same launch
// (merge_splits): no float atomics, so two launches give identical bits. Only
// the shares that hold rows draw tickets; an empty one would contribute m =
// -1e30, l = 0, exact zeros in the merge. Within a chunk a lane owns one cache
// row: it loads the row's K with 16-byte loads and forms the G scores against
// q held in shared memory; max and sum are warp reductions; for P @ V each
// lane owns D/32 output dims of every head, loads those dims of all 32 V rows
// up front (in flight together with the K loads) and takes each row's
// probability from its lane by shuffle.
// Row `lengths[b]` is the token just written, so a slot has lengths[b] + 1
// valid rows; an inactive slot arrives with length 0 and reads one row of the
// page tables[b, 0] names, which stays finite (int8 scale pools start at
// 1.0). The mask is the TPU kernel's whole mask: the sliding window
// (col > length - window) is the cut [c_lo, length] itself, and inside it
// col < sink || col >= win_starts[b] when win_starts is given.
// Arithmetic follows the TPU kernel's two branches. bf16 pool: score =
// (q . k) * sm_scale, and p is rounded to bf16 before the P @ V product, as
// the TPU kernel casts p to the pool dtype. int8 pool: all in f32, q is
// scaled by sm_scale first, score = (q . k_int8) * k_scale[row], and
// p * v_scale[row] multiplies v_int8 without rounding; the running sum takes
// p itself.

#include "attention_common.cuh"

namespace {

// Pages per slot (MB) the kernel takes, so that a block's staged entries fit
// 8 KB of dynamic shared memory beside the 37 KB the D = 128 builds hold
// statically, under the 48 KB a launch gets without opting in.
constexpr int kMaxStagedPages = 2048;

// Page-table entries a block of a launch with `splits` splits may stage: its
// share's rows, rounded up to whole warp chunks, can straddle one page more
// than they fill.
template <int D>
int staged_pages(int P, int MB, int splits) {
  const int share = (MB * P + splits - 1) / splits;
  int rows = (share + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  rows = rows > kMinShareRows<D> ? rows : kMinShareRows<D>;
  const int pages = (rows + P - 1) / P + 1;
  return pages < MB ? pages : MB;
}

template <typename T, int D>
__device__ __forceinline__ void paged_attention(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ win_starts,
    __nv_bfloat16* __restrict__ o, float* __restrict__ partial,
    int* __restrict__ tickets, int H, int KH, int P, int MB, int window, int sink,
    float sm_scale, int splits) {
  using E = Elem<T>;
  constexpr int KV = D / E::kPerVec;  // 16-byte vectors per K row
  constexpr int DL = D / 32;          // output dims per lane and head
  constexpr int VW = (DL * sizeof(T) + 3) / 4;  // words per lane of a V row
  __shared__ __align__(16) float qs[kMaxG * D];
  __shared__ float m_w[kWarps][kMaxG];
  __shared__ float l_w[kWarps][kMaxG];
  __shared__ float acc_w[kWarps][kMaxG * D];
  __shared__ float m_part[kMaxG];  // the block's partial when split
  __shared__ float l_part[kMaxG];
  __shared__ int last;
  extern __shared__ int pages[];  // tables[b, first .. ] of this block's share

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int length = lengths[b];
  int c_lo = window > 0 ? max(length + 1 - window, 0) : 0;
  int c_hi = length + 1;
  // the group's shares that hold rows: the first n_live splits
  const int n_live = clip_to_split(c_lo, c_hi, split, splits, kMinShareRows<D>);
  // an empty share leaves at once: the merge waits for the live ones only,
  // whose partials are all it reads (an empty partial would add exact zeros)
  if (split >= n_live) return;
  const int first = c_lo / P;  // the share's first logical page
  const int ws = win_starts != nullptr ? win_starts[b] : 0;
  // int8: q scaled before the dot, each score by its row's K scale;
  // bf16: each score by sm_scale
  const float q_mul = E::kQuant ? sm_scale : 1.f;

  // the share's page-table entries and q, loaded together
  const int n_pages = (c_hi - 1) / P - first + 1;
  for (int i = tid; i < n_pages; i += kThreads) pages[i] = tables[(size_t)b * MB + first + i];
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

  for (int c0 = c_lo + warp * 32; c0 < c_hi; c0 += kWarps * 32) {
    const int col = c0 + lane;
    const bool in = col < c_hi;
    size_t row = 0;  // element offset of this lane's cache row in a pool
    uint4 kr[KV];
    float k_mul = sm_scale, v_mul = 0.f;
    if (in) {
      const int page = pages[col / P - first];
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
    // their loads fly together with the K loads. Rows past the share load
    // row 0 of the pool (always in bounds) and are zeroed: an unconditional
    // load and a select measured faster than a branch around the load
    uint32_t vr[32][VW];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const size_t row_j = __shfl_sync(kFull, static_cast<unsigned long long>(row), j);
      uint32_t w[VW];
      E::template load_v<DL>(v_pool + row_j + lane * DL, w);
#pragma unroll
      for (int d = 0; d < VW; ++d) vr[j][d] = c0 + j < c_hi ? w[d] : 0u;
    }
    // [c_lo, c_hi) already lies inside the sliding window
    const bool live = in && (win_starts == nullptr || col < sink || col >= ws);

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

  // fold the warps' partial softmaxes into the block's
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
  __nv_bfloat16* out = o + ((size_t)b * H + kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    float lsum = 0.f, acc_i = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][g] - mx);
      lsum += l_w[w][g] * f;
      acc_i += acc_w[w][i] * f;
    }
    if (n_live > 1) {  // this block's partial: only this thread reads or writes acc_w[0][i]
      acc_w[0][i] = acc_i;
      if (i % D == 0) {
        m_part[g] = mx;
        l_part[g] = lsum;
      }
      continue;
    }
    out[i] = __float2bfloat16(acc_i / (lsum <= 0.f ? 1.f : lsum));
  }
  if (n_live > 1) {
    const int group = b * KH + kh;
    merge_splits<D>(m_part, l_part, acc_w[0], G, split, n_live,
                    partial + (size_t)group * splits * partial_floats<D>(),
                    tickets + group, &last,
                    [&](int i, float v) { out[i] = __float2bfloat16(v); });
  }
}

#define PAGED_ATTENTION_PARAMS                                                          \
  const __nv_bfloat16 *__restrict__ q, const T *__restrict__ k_pool,                    \
      const T *__restrict__ v_pool, const float *__restrict__ k_scales,                 \
      const float *__restrict__ v_scales, const int *__restrict__ tables,               \
      const int *__restrict__ lengths, const int *__restrict__ win_starts,              \
      __nv_bfloat16 *__restrict__ o, float *__restrict__ partial,                       \
      int *__restrict__ tickets, int H, int KH, int P, int MB, int window, int sink,    \
      float sm_scale, int splits
#define PAGED_ATTENTION_ARGS                                                            \
  q, k_pool, v_pool, k_scales, v_scales, tables, lengths, win_starts, o, partial,       \
      tickets, H, KH, P, MB, window, sink, sm_scale, splits

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PAGED_ATTENTION_PARAMS) {
  paged_attention<T, D>(PAGED_ATTENTION_ARGS);
}

// D = 64 held to two blocks per SM, as K8's D = 64 build is (the default
// bound measured 1.5x slower); the D = 128 builds keep the default
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) paged_decode_kernel_2(PAGED_ATTENTION_PARAMS) {
  paged_attention<T, D>(PAGED_ATTENTION_ARGS);
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* lengths, const void* win_starts, void* o, void* partial,
           void* tickets, int B, int H, int KH, int P, int MB, int window, int sink,
           int splits, float sm_scale, cudaStream_t st) {
  // a group's splits are consecutive in x, so they run together
  const dim3 grid(splits, KH, B);
  const size_t smem = staged_pages<D>(P, MB, splits) * sizeof(int);
  void (*kernel)(PAGED_ATTENTION_PARAMS);
  if constexpr (D == 64)
    kernel = paged_decode_kernel_2<T, D>;
  else
    kernel = paged_decode_kernel<T, D>;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(win_starts),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(partial),
      static_cast<int*>(tickets), H, KH, P, MB, window, sink, sm_scale, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scales, const void* v_scales, const void* tables,
             const void* lengths, const void* win_starts, void* o, void* partial,
             void* tickets, int B, int H, int KH, int D, int P, int MB, int window,
             int sink, int splits, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || KH < 1 || KH > 65535 || P < 1 || MB < 1 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!partial || !tickets)) || MB > kMaxStagedPages)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, k_scales, v_scales, tables, lengths,
                           win_starts, o, partial, tickets, B, H, KH, P, MB, window,
                           sink, splits, sm_scale, st);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, k_scales, v_scales, tables, lengths,
                            win_starts, o, partial, tickets, B, H, KH, P, MB, window,
                            sink, splits, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window; win_starts may be null (no sink mask).
// D must be 64 or 128, H / KH at most 8, B and KH at most 65535 (grid
// dimensions) and MB at most kMaxStagedPages (2048). Each
// slot's visible rows are split over `splits` blocks (1 to 8), merged in the
// same launch: with splits > 1, `partial` holds B * KH * splits * 8 * (D + 2)
// floats and `tickets` B * KH ints, 0 between launches (a launch leaves them
// at 0).
extern "C" int aios_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, const void* win_starts, void* o, void* partial,
    void* tickets, int B, int H, int KH, int D, int P, int MB, int window, int sink,
    int splits, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, tables,
                                 lengths, win_starts, o, partial, tickets, B, H, KH,
                                 D, P, MB, window, sink, splits, sm_scale, stream);
}

// The int8 pool: k_scales / v_scales are [N, P, KH] f32.
extern "C" int aios_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* lengths,
    const void* win_starts, void* o, void* partial, void* tickets, int B, int H,
    int KH, int D, int P, int MB, int window, int sink, int splits, float sm_scale,
    void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scales, v_scales, tables, lengths,
                          win_starts, o, partial, tickets, B, H, KH, D, P, MB,
                          window, sink, splits, sm_scale, stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
