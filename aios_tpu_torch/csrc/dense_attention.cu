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
// operations per element: from a few dozen query rows on (R = 64 in
// TinyLlama's verify round, 248 at T = 31) the fp32 units bound a kernel
// that multiplies with them before the memory does; the tensor cores do not.
//
// Two kernels.
//
// K6, multiquery_decode_attention (bf16 cache, `mq_attention_kernel`), runs
// its products on the tensor cores. The R query rows of a (slot, kv head),
// ordered (t, g), stack in 16-row tiles, 32 rows a block when R <= 32 and 64
// otherwise; one block per (tile of rows, kv head, slot, split). TinyLlama's
// verify round (T = 8, G = 8) is one block per (slot, kv head, split); at
// T = 31 each K/V row is read by 4 blocks, not 31. Rows past R in the last
// tile are zero and masked. A block walks only the rows its queries can
// see, [pos of its first query + 1 - window, pos of its last query + 1),
// clamped to [0, C) (a saturated slot never reads past the cache, and its
// outputs are unconsumed by the engine's contract), cut to its split's share
// (clip_to_split). The share arrives in 64-row chunks of K and V, copied by
// cp.async into a ring of kMqStages stages in shared memory, so the next
// chunks' loads fly while the current chunk's products run; each row is
// padded by 16 bytes so the ldmatrix reads fall on distinct banks, and rows
// past the share are zero-filled, never read. The eight warps split a block
// as (tile, slice of each chunk): four tiles x two 32-row slices, or two
// tiles x four 16-row slices. A warp runs mma.sync.m16n8k16 (bf16 operands,
// fp32 sums): S = Q K^T for its tile and slice, the staircase and window
// masks and an fp32 online softmax per query row, then O += P V with P taken
// from the S accumulators as the A operand and V read transposed
// (ldmatrix.trans). The warps' (max, sum, output) merge in shared memory at
// the end; the split's partials merge through merge_row_splits, the last
// ticket (attention_common.cuh), which reads a 64-row partial four floats at
// a time. A query row with no visible column gives 0.
// Its arithmetic: q enters unscaled (it is bf16 already, so nothing is
// rounded), S is multiplied by sm_scale in fp32 after the product, p is
// rounded to bf16 for P V and the running sum takes the unrounded p: the TPU
// kernel's `ph.astype(vb.dtype)` and the plain version's
// `p.to(v_cache.dtype)`. (Scaling q by sm_scale in fp32 before an fp32 dot
// differs from it only in fp32 rounding order.)
// Its builds (ptxas -v, sm_90a, no spills; 256 threads at the default
// launch bound):
//   D = 64, 32 rows:  96 registers, 58.5 KB dynamic + 2.3 KB static shared,
//     2 blocks per SM (registers);
//   D = 64, 64 rows:  122 registers, 63 KB + 3.5 KB, 2 blocks per SM;
//   D = 128, 32 rows: 128 registers, 76.5 KB + 2.3 KB, 2 blocks per SM;
//   D = 128, 64 rows: 162 registers, 85 KB + 3.5 KB, 1 block per SM.
//
// K7, K8 and K9 (`dense_attention`) run the skeleton of paged_attention.cu
// with the page table replaced by the row index (b * C + col) * KH + kh. One
// block per (tile of kR query rows, kv head, slot): kR = 8, or 4 for K9
// where G <= 4 (Mistral-7B); query rows are ordered (t, g), so a tile holds
// the G heads of kR / G consecutive queries, and T = 1 is one tile. The tile index is the fastest grid dimension, so the blocks
// that share a (slot, kv head) run together and find each other's K/V rows in
// the L2. A block walks only the rows its own queries can see, as K6's does.
// The eight warps take turns over 32-row chunks, each with its own fp32
// online softmax, and merge (max, sum, output) at the end. Within a chunk a
// lane owns one cache row: 16-byte K loads, the tile's scores against q held
// in shared memory, warp reductions for max and sum, and for P @ V each lane
// owns D/32 output dims of every query row and takes each cache row's
// probability from its lane by shuffle. A query row with no visible column
// gives 0. Arithmetic follows the TPU kernels, which differ:
//   decode_attention (bf16, T = 1): q * sm_scale rounded to bf16 before the
//     dot; p rounded to bf16 before P @ V;
//   both int8 kernels: f32 throughout, q scaled first,
//     score = (q . k_int8) * k_scale[row], p * v_scale[row] multiplies
//     v_int8 without rounding, and the running sum takes p itself.
//
// Split slots (the single-query entries, K8 and K9, and K6): the launch
// splits each (tile, kv head, slot)'s visible rows over up to eight blocks
// (attention_common.cuh): block z walks only its share of the rows the mask
// exposes, reduces it to a partial softmax, and the block that draws the
// group's last ticket merges the partials in split order, in the same
// launch. A decode step has only B * KH (slot, kv head) pairs, 32 for
// TinyLlama's 8 slots, 64 for Mistral-7B's, against 132 SMs; split they fill
// the card and the longest slot no longer runs through one block. K9 takes
// K4's recipe: a D = 128 share is at least kMinShareRows rows, and a block
// whose share is empty leaves at once and draws no ticket (K6 too). K8
// keeps equal shares and every share in its merge. K7 launches one split,
// the kernel it had: a template switch (kSplit) leaves its code, and K8's,
// as they were. K9's builds: at 4 rows 128 registers at D = 128 and 120 at
// D = 64, two blocks per SM (at 8 rows, 171 and 128 with 4 bytes spilled:
// one and two), so Mistral-7B's long shares run on twice the warps of an SM.
// Not yet: the split and tensor-core score tiles for K7 (int8 cache, T
// queries).

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kRows = kMaxG;  // query rows per block

template <typename T, int D, bool kQRound, bool kSplit, int kR>
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
  __shared__ __align__(16) float qs[kR * D];
  __shared__ int qpos[kR];  // each query row's own cache row
  __shared__ float m_w[kWarps][kR];
  __shared__ float l_w[kWarps][kR];
  __shared__ float acc_w[kWarps][kR * D];
  __shared__ float m_part[kR];  // the block's partial when split
  __shared__ float l_part[kR];
  __shared__ int last;

  // K8's and K9's builds take a split; K7's compiles to the single-split
  // kernel it had, registers and all
  const int splits = kSplit ? n_splits : 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x % splits;  // a group's splits are consecutive in x
  const int r0 = blockIdx.x / splits * kR;  // first query row of this tile
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int nr = min(kR, Tq * G - r0);  // query rows in this tile
  const int base = lengths[b];
  const int stride = strides != nullptr ? strides[b] : 0;
  const int pos_lo = base + (r0 / G) * stride;
  const int pos_hi = base + ((r0 + nr - 1) / G) * stride;
  int c_lo = window > 0 ? max(pos_lo + 1 - window, 0) : 0;
  int c_hi = min(pos_hi + 1, C);
  // the blocks whose partials the merge reads: K8 all of its splits; K9 only
  // the live shares, each at least kMinShareRows rows, and an empty share
  // leaves at once without a ticket (an empty partial would add exact zeros)
  int n_merge = splits;
  if (splits > 1) {
    const int n_live = clip_to_split(c_lo, c_hi, split, splits, E::kQuant ? kMinShareRows<D> : 0);
    if constexpr (E::kQuant) {
      if (split >= n_live) return;
      n_merge = n_live;
    }
  }

  // query row r of the tile is head kh * G + g of query t
  for (int i = tid; i < nr * D; i += kThreads) {
    const int rr = r0 + i / D;
    const int t = rr / G, g = rr % G;
    const float x =
        __bfloat162float(q[(((size_t)b * Tq + t) * H + kh * G + g) * D + i % D]) *
        sm_scale;
    qs[i] = kQRound ? __bfloat162float(__float2bfloat16(x)) : x;
  }
  if (tid < kR) qpos[tid] = base + (min(r0 + tid, r0 + nr - 1) / G) * stride;
  __syncthreads();

  float m[kR], l[kR], acc[kR][DL];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
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
    float pv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
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
      for (int r = 0; r < kR; ++r) {
        if (r >= nr) continue;
        const float pj = __shfl_sync(kFull, pv[r], j);
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[r][d] += pj * v[d];
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int r = 0; r < kR; ++r) {
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
    if (n_merge > 1) {  // this block's partial: only this thread reads or writes acc_w[0][i]
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
  if (n_merge > 1) {
    const int group = (b * KH + kh) * (gridDim.x / splits) + blockIdx.x / splits;
    merge_splits<D>(m_part, l_part, acc_w[0], nr, split, n_merge,
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

template <typename T, int D, bool kQRound, bool kSplit, int kR>
__global__ void __launch_bounds__(kThreads) dense_attention_kernel(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound, kSplit, kR>(DENSE_ATTENTION_ARGS);
}

// K8's build at D = 64 keeps two blocks per SM: a split grid has up to eight
// blocks per (slot, kv head). The other builds keep the registers they had.
template <typename T, int D, bool kQRound, bool kSplit, int kR>
__global__ void __launch_bounds__(kThreads, 2) dense_attention_kernel_2(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound, kSplit, kR>(DENSE_ATTENTION_ARGS);
}

template <typename T, int D, bool kQRound, bool kSplit, int kR>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scales, const void* v_scales, const void* lengths,
           const void* strides, void* o, void* partial, void* tickets, int B, int Tq,
           int H, int KH, int C, int window, float sm_scale, int splits, cudaStream_t st) {
  const int G = H / KH;
  const dim3 grid((Tq * G + kR - 1) / kR * splits, KH, B);
  // only the build a launch needs is compiled
  void (*kernel)(DENSE_ATTENTION_PARAMS);
  if constexpr (kQRound && D == 64)
    kernel = dense_attention_kernel_2<T, D, kQRound, kSplit, kR>;
  else
    kernel = dense_attention_kernel<T, D, kQRound, kSplit, kR>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
      static_cast<const int*>(strides), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(partial), static_cast<int*>(tickets), Tq, H, KH, C, window,
      sm_scale, splits);
  return static_cast<int>(cudaGetLastError());
}

#define DENSE_LAUNCH_ARGS                                                               \
  q, k_cache, v_cache, k_scales, v_scales, lengths, strides, o, partial, tickets, B, Tq, H, \
      KH, D, C, window, sm_scale, splits, st

template <typename T, bool kQRound, bool kSplit, int kR>
int launch_d(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
             const void* v_scales, const void* lengths, const void* strides, void* o,
             void* partial, void* tickets, int B, int Tq, int H, int KH, int D, int C,
             int window, float sm_scale, int splits, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, kQRound, kSplit, kR>(q, k_cache, v_cache, k_scales, v_scales,
                                                lengths, strides, o, partial, tickets, B, Tq,
                                                H, KH, C, window, sm_scale, splits, st);
    case 128:
      return launch<T, 128, kQRound, kSplit, kR>(q, k_cache, v_cache, k_scales, v_scales,
                                                 lengths, strides, o, partial, tickets, B, Tq,
                                                 H, KH, C, window, sm_scale, splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool kQRound, bool kSplit>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* k_scales, const void* v_scales, const void* lengths,
             const void* strides, void* o, int B, int Tq, int H, int KH, int D,
             int C, int window, float sm_scale, void* stream, int splits = 1,
             void* partial = nullptr, void* tickets = nullptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tq < 1 || C < 1 || B > 65535 || KH > 65535 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!kSplit || !partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  // K9 holds four query rows a block where the group has at most four
  // heads (Mistral-7B's G = 4): no code for rows it never has, and 128
  // registers, two blocks per SM; K7 and K8 keep kRows
  if constexpr (std::is_same<T, int8_t>::value && kSplit) {
    if (H / KH <= 4) return launch_d<T, kQRound, kSplit, 4>(DENSE_LAUNCH_ARGS);
  }
  return launch_d<T, kQRound, kSplit, kRows>(DENSE_LAUNCH_ARGS);
}

// -- K6: T queries per slot over a bf16 cache, on the tensor cores ------------

constexpr int kMqChunk = 64;    // cache rows of a stage
constexpr int kMqMaxRows = 64;  // query rows of a block: four 16-row tiles

// stages of the K/V ring: 3 x 18 KB at D = 64, 2 x 34 KB at D = 128
template <int D>
constexpr int kMqStages = D == 64 ? 3 : 2;

// bf16 of a row in shared memory: D and 16 bytes of padding, so the eight
// rows an ldmatrix reads start on eight different 4-bank groups
template <int D>
constexpr int kMqPitch = D + 8;

// dynamic shared memory of a block with MT tiles: q's rows, then the ring
template <int D, int MT>
constexpr int mq_smem_bytes() {
  return (16 * MT + kMqStages<D> * 2 * kMqChunk) * kMqPitch<D> * 2;
}

// query rows of a block for R = T * G rows a (slot, kv head): two tiles when
// they hold R, else four (MQ_BLOCK_ROWS in ops/split.py sizes the workspace
// for the four)
__host__ __device__ constexpr int mq_tiles(int R) { return R <= 32 ? 2 : 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros, and no read,
// when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and each lane gets (row lane / 4, columns 2 (lane % 4), + 1) of
// each: the A and B fragments of mma.m16n8k16
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column-major), bf16,
// fp32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block: MT 16-row tiles of one (slot, kv head)'s query rows over one
// split's share of the rows they see.
template <int D, int MT>
__global__ void __launch_bounds__(kThreads) mq_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_cache,
    const __nv_bfloat16* __restrict__ v_cache, const int* __restrict__ lengths,
    const int* __restrict__ strides, __nv_bfloat16* __restrict__ o,
    float* __restrict__ partial, int* __restrict__ tickets, int Tq, int H, int KH, int C,
    int window, float sm_scale, int splits) {
  constexpr int BR = 16 * MT;        // query rows of the block
  constexpr int NG = kWarps / MT;    // warps on one tile, each on its own slice of a chunk
  constexpr int KW = kMqChunk / NG;  // cache rows of a warp's slice: 32 or 16
  constexpr int NT = KW / 8;         // 16 x 8 score tiles of a slice
  constexpr int PITCH = kMqPitch<D>;
  constexpr int S = kMqStages<D>;
  constexpr int STAGE = 2 * kMqChunk * PITCH * 2;  // bytes of a stage: K rows, then V rows
  constexpr int V8 = D / 8;                        // 16-byte pieces of a row
  static_assert(BR <= kMqMaxRows && NT % 2 == 0, "tiles of the block");
  static_assert(NG * BR * D * 4 <= S * STAGE, "the warps' partials fit in the ring");
  extern __shared__ __align__(16) unsigned char smem[];  // q's rows [BR][PITCH], then the ring
  unsigned char* ring = smem + BR * PITCH * 2;
  float* acc_w = reinterpret_cast<float*>(ring);  // after the loop: [NG][BR * D]
  __shared__ float m_w[NG][BR];
  __shared__ float l_w[NG][BR];
  __shared__ float m_part[BR];  // the block's partial when split
  __shared__ float l_part[BR];
  __shared__ float w_split[kMaxSplits][BR];  // the merge's weights
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tile0 = warp % MT * 16;  // the warp's tile of query rows
  const int kg = warp / MT;          // and its slice of every chunk
  const int split = blockIdx.x % splits;  // a group's splits are consecutive in x
  const int r0 = blockIdx.x / splits * BR;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int nr = min(BR, Tq * G - r0);  // query rows of this block
  const int base = lengths[b];
  const int stride = strides[b];
  const int pos_lo = base + (r0 / G) * stride;
  const int pos_hi = base + ((r0 + nr - 1) / G) * stride;
  int c_lo = window > 0 ? max(pos_lo + 1 - window, 0) : 0;
  int c_hi = min(pos_hi + 1, C);
  int n_live = 1;  // the group's blocks whose partials the merge reads
  if (c_lo >= c_hi) {
    // no cache row is visible to the block (a saturated staircase past the
    // cache end and its window): split 0 writes zeros
    if (split > 0) return;
    c_hi = c_lo;
  } else if (splits > 1) {
    n_live = clip_to_split(c_lo, c_hi, split, splits);
    // an empty share leaves at once without a ticket: the merge reads the
    // live shares only (an empty partial would add exact zeros)
    if (split >= n_live) return;
  }

  const uint32_t q_smem = smem_u32(smem);
  const uint32_t ring_smem = smem_u32(ring);
  const size_t row_step = (size_t)KH * D;  // elements from a slot's cache row to the next
  const __nv_bfloat16* k_rows = k_cache + ((size_t)b * C * KH + kh) * D;
  const __nv_bfloat16* v_rows = v_cache + ((size_t)b * C * KH + kh) * D;

  // the block's query rows (row r is head kh * G + r % G of query r / G),
  // unscaled; rows past nr are zeros
  for (int i = tid; i < BR * V8; i += kThreads) {
    const int r = i / V8, c8 = i % V8;
    const int rr = r0 + min(r, nr - 1);
    cp_async16(q_smem + (r * PITCH + c8 * 8) * 2,
               q + (((size_t)b * Tq + rr / G) * H + kh * G + rr % G) * D + c8 * 8, r < nr);
  }
  // chunk c of the share into stage s; rows past the share are zeros
  auto load_chunk = [&](int c, int s) {
    const int c0 = c_lo + c * kMqChunk;
    const uint32_t k_dst = ring_smem + s * STAGE;
    const uint32_t v_dst = k_dst + STAGE / 2;
    for (int i = tid; i < kMqChunk * V8; i += kThreads) {
      const int r = i / V8, c8 = i % V8;
      const bool in = c0 + r < c_hi;
      const size_t off = in ? (c0 + r) * row_step + c8 * 8 : 0;
      const uint32_t at = (r * PITCH + c8 * 8) * 2;
      cp_async16(k_dst + at, k_rows + off, in);
      cp_async16(v_dst + at, v_rows + off, in);
    }
  };
  const int n_chunks = (c_hi - c_lo + kMqChunk - 1) / kMqChunk;
  // group 0 holds q and chunk 0, then one group per chunk: S - 1 in flight
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  // this lane's two rows of its tile (the fragments' rows lane / 4 and
  // lane / 4 + 8) and the columns each sees, [lo, hi); a row past nr none
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile0 + lane / 4 + 8 * h;
    const int pos = base + ((r0 + r) / G) * stride;
    lo[h] = window > 0 ? pos + 1 - window : 0;
    hi[h] = r < nr ? min(pos + 1, c_hi) : lo[h];
  }
  // the columns some row of the tile sees: a slice outside them is skipped
  const bool tile_live = tile0 < nr;
  const int tile_lo = window > 0 ? base + ((r0 + tile0) / G) * stride + 1 - window : 0;
  const int tile_hi =
      min(base + ((r0 + min(tile0 + 15, nr - 1)) / G) * stride + 1, c_hi);

  float acc[D / 8][4];  // O: 16 rows x D as D/8 tiles of 16 x 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk c is in for every thread, and every warp is done with c - 1
    if (c + S - 1 < n_chunks) load_chunk(c + S - 1, (c + S - 1) % S);
    cp_async_commit();
    const int col0 = c_lo + c * kMqChunk + kg * KW;  // the warp's first column
    if (!tile_live || col0 >= tile_hi || col0 + KW <= tile_lo) continue;
    const uint32_t k_src = ring_smem + (c % S) * STAGE + kg * KW * PITCH * 2;
    const uint32_t v_src = k_src + STAGE / 2;

    // S = Q K^T over the slice
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_smem + ((tile0 + lane % 16) * PITCH + kk * 16 + lane / 16 * 8) * 2);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];  // K rows 8j .. 8j + 15 of the slice: two B fragments
        ldsm_x4(kb, k_src + ((j * 8 + lane % 8 + lane / 16 * 8) * PITCH + kk * 16 +
                             lane / 8 % 2 * 8) * 2);
        mma_16816(s[j], a, kb[0], kb[1]);
        mma_16816(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // masks, then the online softmax of each row over the slice: the max
    // over the four lanes that hold a row, p rounded to bf16 for P V
    float mx[2] = {m[0], m[1]};
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = col0 + j * 8 + lane % 4 * 2 + e % 2;
        const bool in = col >= lo[h] && col < hi[h];
        live |= (in ? 1u : 0u) << (j * 4 + e);
        s[j][e] = in ? s[j][e] * sm_scale : kNegInf;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    uint32_t pa[NT / 2][4];  // P as the A fragments of the slice's 16-row steps
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = live >> (j * 4 + e) & 1u ? expf(s[j][e] - m[e / 2]) : 0.f;
        l[e / 2] += p[e];
      }
      pa[j / 2][j % 2 * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][j % 2 * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V over the slice, V read transposed
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t vb[4];  // V rows 16 ks .. + 15, columns 16 n .. + 15: two B fragments
        ldsm_x4_t(vb, v_src + ((ks * 16 + lane % 16) * PITCH + n * 16 + lane / 16 * 8) * 2);
        mma_16816(acc[2 * n], pa[ks], vb[0], vb[1]);
        mma_16816(acc[2 * n + 1], pa[ks], vb[2], vb[3]);
      }
  }

  // merge the warps' partial softmaxes in the ring, now free
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's sum over its four lanes
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  {
    const int r = tile0 + lane / 4;
    if (lane % 4 == 0) {
      m_w[kg][r] = m[0];
      l_w[kg][r] = l[0];
      m_w[kg][r + 8] = m[1];
      l_w[kg][r + 8] = l[1];
    }
    float* mine = acc_w + kg * BR * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + lane % 4 * 2;
      *reinterpret_cast<float2*>(mine + r * D + d) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(mine + (r + 8) * D + d) = make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (tid < nr) {  // each row's max and sum over the warps; m_w becomes each warp's weight
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NG; ++w) mx = fmaxf(mx, m_w[w][tid]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NG; ++w) {
      const float f = expf(m_w[w][tid] - mx);
      m_w[w][tid] = f;
      lsum += l_w[w][tid] * f;
    }
    m_part[tid] = mx;
    l_part[tid] = lsum;
  }
  __syncthreads();
  // four dims of a row a thread: the block's output, or its partial when split
  auto store4 = [&](int j, float4 v) {  // dims 4j % D .. + 3 of block row 4j / D
    const int rr = r0 + j / (D / 4);
    uint2 w;
    w.x = pack_bf16(v.x, v.y);
    w.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(o + (((size_t)b * Tq + rr / G) * H + kh * G + rr % G) * D +
                              j % (D / 4) * 4) = w;
  };
  const int group = (b * KH + kh) * (gridDim.x / splits) + blockIdx.x / splits;
  float* part = n_live > 1 ? partial + (size_t)group * splits * partial_floats<D, BR>() : nullptr;
  for (int j = tid; j < nr * D / 4; j += kThreads) {
    const int r = j / (D / 4);
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NG; ++w) {
      const float f = m_w[w][r];
      const float4 a = reinterpret_cast<const float4*>(acc_w + w * BR * D)[j];
      out.x += a.x * f;
      out.y += a.y * f;
      out.z += a.z * f;
      out.w += a.w * f;
    }
    if (n_live > 1) {
      __stcg(reinterpret_cast<float4*>(part + split * partial_floats<D, BR>()) + j, out);
      continue;
    }
    const float L = l_part[r] <= 0.f ? 1.f : l_part[r];
    store4(j, make_float4(out.x / L, out.y / L, out.z / L, out.w / L));
  }
  if (n_live > 1)
    merge_row_splits<D, BR>(m_part, l_part, nr, split, n_live, part, tickets + group, &last,
                            &w_split[0][0], store4);
}

template <int D, int MT>
int launch_mq(const void* q, const void* k_cache, const void* v_cache, const void* lengths,
              const void* strides, void* o, void* partial, void* tickets, int B, int Tq,
              int H, int KH, int C, int window, float sm_scale, int splits,
              cudaStream_t st) {
  constexpr int smem = mq_smem_bytes<D, MT>();
  static bool ready[64] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(mq_attention_kernel<D, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int rows = Tq * (H / KH);
  const dim3 grid((rows + 16 * MT - 1) / (16 * MT) * splits, KH, B);
  mq_attention_kernel<D, MT><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), static_cast<const int*>(lengths),
      static_cast<const int*>(strides), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(partial), static_cast<int*>(tickets), Tq, H, KH, C, window,
      sm_scale, splits);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mq(const void* q, const void* k_cache, const void* v_cache, const void* lengths,
                const void* strides, void* o, void* partial, void* tickets, int B, int Tq,
                int H, int KH, int D, int C, int window, float sm_scale, int splits,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tq < 1 || C < 1 || KH < 1 || B > 65535 || KH > 65535 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = mq_tiles(Tq * (H / KH)) == 2;
#define AIOS_MQ_LAUNCH(D_, MT_)                                                        \
  launch_mq<D_, MT_>(q, k_cache, v_cache, lengths, strides, o, partial, tickets, B, Tq, H, \
                     KH, C, window, sm_scale, splits, st)
  switch (D) {
    case 64:
      return two ? AIOS_MQ_LAUNCH(64, 2) : AIOS_MQ_LAUNCH(64, 4);
    case 128:
      return two ? AIOS_MQ_LAUNCH(128, 2) : AIOS_MQ_LAUNCH(128, 4);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AIOS_MQ_LAUNCH
}

}  // namespace

// window <= 0 means no sliding window. D must be 64 or 128, H / KH at most 8
// and B and KH at most 65535 (grid dimensions). Each (tile, kv head, slot)'s
// visible rows are split over `splits` blocks (1 to 8), merged in the same
// launch: with splits > 1, `partial` holds groups * splits * partial_floats
// and `tickets` groups ints, 0 between launches (a launch leaves them at 0);
// groups and partial_floats below.

// One query per slot over rows [0, lengths[b]] of a bf16 cache: B * KH
// groups of partials of 8 * (D + 2) floats.
extern "C" int aios_decode_attention(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lengths,
                                     void* o, void* partial, void* tickets, int B,
                                     int H, int KH, int D, int C, int window,
                                     int splits, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, true, true>(q, k_cache, v_cache, nullptr, nullptr,
                                             lengths, nullptr, o, B, 1, H, KH, D, C,
                                             window, sm_scale, stream, splits, partial,
                                             tickets);
}

// The same over an int8 cache: k_scales / v_scales are [B, C, KH] f32.
extern "C" int aios_decode_attention_int8(const void* q, const void* k_cache,
                                          const void* v_cache, const void* k_scales,
                                          const void* v_scales, const void* lengths,
                                          void* o, void* partial, void* tickets, int B,
                                          int H, int KH, int D, int C, int window,
                                          int splits, float sm_scale, void* stream) {
  return dispatch<int8_t, false, true>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                       nullptr, o, B, 1, H, KH, D, C, window, sm_scale,
                                       stream, splits, partial, tickets);
}

// T queries per slot over a bf16 cache, q and o [B, T, H, D]: B * KH *
// ceil(T * H / KH / 64) groups of partials of 64 * (D + 2) floats.
extern "C" int aios_multiquery_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* lengths,
    const void* strides, void* o, void* partial, void* tickets, int B, int T, int H,
    int KH, int D, int C, int window, int splits, float sm_scale, void* stream) {
  return dispatch_mq(q, k_cache, v_cache, lengths, strides, o, partial, tickets, B, T, H,
                     KH, D, C, window, sm_scale, splits, stream);
}

// The same over an int8 cache with [B, C, KH] f32 scales, one split.
extern "C" int aios_multiquery_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
    const void* v_scales, const void* lengths, const void* strides, void* o, int B,
    int T, int H, int KH, int D, int C, int window, float sm_scale, void* stream) {
  return dispatch<int8_t, false, false>(q, k_cache, v_cache, k_scales, v_scales, lengths,
                                        strides, o, B, T, H, KH, D, C, window, sm_scale,
                                        stream);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
