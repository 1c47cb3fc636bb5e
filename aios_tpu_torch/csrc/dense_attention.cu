// Decode attention over the dense slot cache, bf16 or int8: T queries per
// slot, q [B, T, H, D] bf16, caches [B, C, KH, D], lengths [B] and strides
// [B] int32 -> o [B, T, H, D] bf16. Query t of slot b sits at row
// pos = lengths[b] + t * strides[b] and sees the cache rows col <= pos and,
// with a sliding window, col > pos - window. An int8 cache carries f32 scales
// [B, C, KH] for K and for V, one per (cache row, kv head), as the engine
// stores them. T = 1 is the single-query decode step. The multi-query
// entries' `_sink` twins take window+sink compression's predicate, K3's and
// K4's: slot b sees only the rows col < sink or col >= win_starts[b] (its
// pruned middle, [sink, win_starts[b]), is never scored). Both bounds are
// whole pages and the wrapper holds them to multiples of 32 rows, the
// alignment of a warp's slice of a chunk (16 or 32 rows, from a share start
// that is a multiple of 32; there is no window under compression): a slice
// is then pruned whole or not at all, so the kernel skips pruned slices and
// tests no row.
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
// K6 and K7, multiquery_decode_attention over a bf16 cache and
// multiquery_decode_attention_int8 over an int8 cache (`mq_attention_kernel`,
// one template on the cache element), run their products on the tensor
// cores. The R query rows of a (slot, kv head), ordered (t, g), stack in
// 16-row tiles, 32 rows a block when R <= 32 and 64 otherwise; one block per
// (tile of rows, kv head, slot, split). TinyLlama's and Mistral-7B's verify
// rounds (T = 8, G = 8 and 4) are one block per (slot, kv head, split); at
// T = 31 each K/V row is read by 4 or 2 blocks, not 31. Rows past R in the
// last tile are zero and masked. A block walks only the rows its queries can
// see, [pos of its first query + 1 - window, pos of its last query + 1),
// clamped to [0, C) (a saturated slot never reads past the cache, and its
// outputs are unconsumed by the engine's contract), cut to its split's share
// (clip_to_split). The share arrives in 64-row chunks of K and V (and K7's
// scales), copied by cp.async into a ring of stages in shared memory
// (MqSmem), so the next chunks' loads fly while the current chunk's products
// run; rows are padded so that each lane's shared loads of a phase fall on
// distinct banks, and rows past the share are zero-filled, never read. The
// eight warps split a block as (tile, slice of each chunk): four tiles x two
// 32-row slices, or two tiles x four 16-row slices. A warp runs
// mma.sync.m16n8k16 (bf16 operands, fp32 sums): S = Q K^T for its tile and
// slice, the staircase and window masks and an fp32 online softmax per query
// row, then O += P V with P taken from the S accumulators as the A operand.
// The warps' (max, sum, output) merge in shared memory at the end; the
// split's partials merge through merge_row_splits, the last ticket
// (attention_common.cuh), which reads a 64-row partial four floats at a
// time. A query row with no visible column gives 0. Both enter q unscaled
// (it is bf16 already, so nothing is rounded), multiply S by sm_scale in
// fp32 after the product and sum the unrounded p. (Scaling q by sm_scale in
// fp32 before an fp32 dot, as the TPU kernels do, differs from it only in
// fp32 rounding order.)
//
// K6 reads its fragments with ldmatrix (V transposed, ldmatrix.trans) from
// rows of D + 8 bf16, 3 stages at D = 64 and 2 at D = 128, and rounds p to
// bf16 for P V: the TPU kernel's `ph.astype(vb.dtype)` and the plain
// version's `p.to(v_cache.dtype)`.
//
// K7 keeps the TPU kernel's int8 arithmetic, f32 throughout, on the same
// bf16 mma:
//   - an int8 value is exact in bf16, so S = q . k_int8 takes exact products
//     into fp32 sums, then s * sm_scale * k_scale[col] in fp32;
//   - P V takes w = p * v_scale[col] (fp32) as kMqVTerms = 3 bf16 terms,
//     hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), each
//     difference exact in fp32, each term through its own mma against V's
//     exact bf16 image into the same fp32 accumulators: the terms sum to w
//     within 2^-24 of it, f32's own rounding (two leave up to 2^-16). p is
//     never rounded alone;
//   - the int8 bytes become bf16 fragments in registers (int8_bf16.cuh,
//     shared with K1 and K5). A lane reads 8 bytes of a K row, 32 dims, the
//     k slots of two k16 steps (q's A fragments read with the same
//     permutation, 16 bytes of each of its two rows: a sum over k does not
//     depend on its order). It reads D / 8 bytes of each of four V rows,
//     which gather / gather_hi pair into the B fragments of two n tiles, so
//     a lane's output dims come out side by side; the warps' partials are
//     stored in that order, granules swizzled (acc_granule), and read back
//     in row order;
//   - the ring (MqSmem<int8_t, D>): 4 stages of 64 rows, K rows D + 32 bytes
//     apart, V rows D + 16, then the chunk's 64 K and 64 V scales (4-byte
//     cp.async: consecutive rows' scales are KH floats apart), q's rows
//     2 D + 64 bytes apart: 11.5 KB a stage at D = 64 and 19.5 KB at
//     D = 128, three chunks in flight while one is read, about the bytes of
//     K6's two;
//   - a D = 128 share is at least kMinShareRows (256) rows, as K9's and
//     K4's: at the served lengths equal shares measured slower
//     (tools/dense_variants/k7_equal_shares.patch).
// Builds (ptxas -v, sm_90a, no spills; 256 threads at the default launch
// bound; dynamic + static shared memory):
//   K6 D = 64, 32 rows: 99 registers, 58.5 + 2.3 KB, 2 blocks per SM;
//   K6 D = 64, 64 rows: 122 registers, 63 + 3.5 KB, 2 blocks per SM;
//   K6 D = 128, 32 rows: 128 registers, 76.5 + 2.3 KB, 2 blocks per SM;
//   K6 D = 128, 64 rows: 160 registers, 85 + 3.5 KB, 1 block per SM;
//   K7 D = 64, 32 rows: 128 registers, 52 + 2.3 KB, 2 blocks per SM;
//   K7 D = 64, 64 rows: 132 registers, 58 + 3.5 KB, 1 block per SM;
//   K7 D = 128, 32 rows: 168 registers, 88 + 2.3 KB, 1 block per SM;
//   K7 D = 128, 64 rows: 181 registers, 98 + 3.5 KB, 1 block per SM.
// Forcing two blocks per SM on K7's D = 128, 32-row build
// (__launch_bounds__(256, 2), k7_two_blocks_per_sm.patch) measured slower.
//
// K8 and K9, decode_attention and decode_attention_int8 (`dense_attention`),
// one query per slot, run the skeleton of paged_attention.cu with the page
// table replaced by the row index (b * C + col) * KH + kh. A block holds the
// G query heads of a (slot, kv head) as one tile of kR rows: kR = 8, or 4
// for K9 where G <= 4 (Mistral-7B). A block walks only the rows the query
// sees. The eight warps take turns over 32-row chunks, each with its own
// fp32 online softmax, and merge (max, sum, output) at the end. Within a
// chunk a lane owns one cache row: 16-byte K loads, the tile's scores
// against q held in shared memory, warp reductions for max and sum, and for
// P @ V each lane owns D/32 output dims of every query row and takes each
// cache row's probability from its lane by shuffle. A query row with no
// visible column gives 0. Arithmetic follows the TPU kernels, which differ:
//   decode_attention (bf16): q * sm_scale rounded to bf16 before the dot; p
//     rounded to bf16 before P @ V;
//   decode_attention_int8: f32 throughout, q scaled first,
//     score = (q . k_int8) * k_scale[row], p * v_scale[row] multiplies
//     v_int8 without rounding, and the running sum takes p itself.
//
// Split slots (all four kernels): the launch splits each (tile, kv head,
// slot)'s visible rows over up to eight blocks (attention_common.cuh):
// block z walks only its share of the rows the mask exposes, reduces it to a
// partial softmax, and the block that draws the group's last ticket merges
// the partials in split order, in the same launch. A decode step has only
// B * KH (slot, kv head) pairs, 32 for TinyLlama's 8 slots, 64 for
// Mistral-7B's, against 132 SMs; split they fill the card and the longest
// slot no longer runs through one block. K9 and K7 take K4's recipe: a
// D = 128 share is at least kMinShareRows rows. A block whose share is
// empty leaves at once and draws no ticket (K6, K7, K9); K8 keeps equal
// shares and every share in its merge. K9's builds: at 4 rows 128 registers
// at D = 128 and 102 at D = 64, two blocks per SM (at 8 rows 175 and 128:
// one and two), so Mistral-7B's long shares run on twice the warps of an SM.
// K8's: 246 registers at D = 128, one block per SM; 128 at D = 64 under
// __launch_bounds__(256, 2), two blocks per SM (28 bytes spilled).

#include <type_traits>

#include "attention_common.cuh"
#include "int8_bf16.cuh"

namespace {

using int8_bf16::gather;
using int8_bf16::gather_hi;
using int8_bf16::i8x4_to_bf16;

constexpr int kRows = kMaxG;  // query rows per block

template <typename T, int D, bool kQRound, int kR>
__device__ __forceinline__ void dense_attention(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k_cache, const T* __restrict__ v_cache,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ partial,
                       int* __restrict__ tickets, int H, int KH, int C, int window,
                       float sm_scale, int splits) {
  using E = Elem<T>;
  constexpr int KV = D / E::kPerVec;  // 16-byte vectors per K row
  constexpr int DL = D / 32;          // output dims per lane and query row
  constexpr int VW = (DL * sizeof(T) + 3) / 4;  // words per lane of a V row
  __shared__ __align__(16) float qs[kR * D];
  __shared__ float m_w[kWarps][kR];
  __shared__ float l_w[kWarps][kR];
  __shared__ float acc_w[kWarps][kR * D];
  __shared__ float m_part[kR];  // the block's partial when split
  __shared__ float l_part[kR];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;  // the group's G heads are one tile of kR >= G rows
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int nr = G;  // query rows of the block
  const int pos = lengths[b];  // the query's own row: it sees [c_lo, c_hi)
  int c_lo = window > 0 ? max(pos + 1 - window, 0) : 0;
  int c_hi = min(pos + 1, C);
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

  // query row r of the tile is head kh * G + r
  for (int i = tid; i < nr * D; i += kThreads) {
    const float x = __bfloat162float(q[((size_t)b * H + kh * G) * D + i]) * sm_scale;
    qs[i] = kQRound ? __bfloat162float(__float2bfloat16(x)) : x;
  }
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
    const bool in = col < c_hi;  // every row of [c_lo, c_hi) is visible to the query
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

    // scores of this lane's cache row for every query row of the tile, then
    // the online softmax over the warp's 32 cache rows
    float pv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      pv[r] = 0.f;
      if (r >= nr) continue;
      const float* qr = qs + r * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < KV; ++i) dot += E::dot(qr + i * E::kPerVec, kr[i]);
      const float s = in ? dot * k_mul : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = in ? expf(s - m_new) : 0.f;
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
  __nv_bfloat16* out = o + ((size_t)b * H + kh * G) * D;  // the group's G rows
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][r]);
    float lsum = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][r] - mx);
      lsum += l_w[w][r] * f;
      sum += acc_w[w][i] * f;
    }
    if (n_merge > 1) {  // this block's partial: only this thread reads or writes acc_w[0][i]
      acc_w[0][i] = sum;
      if (i % D == 0) {
        m_part[r] = mx;
        l_part[r] = lsum;
      }
      continue;
    }
    out[i] = __float2bfloat16(sum / (lsum <= 0.f ? 1.f : lsum));
  }
  if (n_merge > 1) {
    const int group = b * KH + kh;
    merge_splits<D>(m_part, l_part, acc_w[0], nr, split, n_merge,
                    partial + (size_t)group * splits * partial_floats<D>(), tickets + group,
                    &last, [&](int i, float v) { out[i] = __float2bfloat16(v); });
  }
}

#define DENSE_ATTENTION_PARAMS                                                          \
  const __nv_bfloat16 *__restrict__ q, const T *__restrict__ k_cache,                   \
      const T *__restrict__ v_cache, const float *__restrict__ k_scales,                \
      const float *__restrict__ v_scales, const int *__restrict__ lengths,              \
      __nv_bfloat16 *__restrict__ o, float *__restrict__ partial,                       \
      int *__restrict__ tickets, int H, int KH, int C, int window, float sm_scale,      \
      int splits
#define DENSE_ATTENTION_ARGS                                                            \
  q, k_cache, v_cache, k_scales, v_scales, lengths, o, partial, tickets, H, KH, C,      \
      window, sm_scale, splits

template <typename T, int D, bool kQRound, int kR>
__global__ void __launch_bounds__(kThreads) dense_attention_kernel(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound, kR>(DENSE_ATTENTION_ARGS);
}

// K8's build at D = 64 keeps two blocks per SM: a split grid has up to eight
// blocks per (slot, kv head). The other builds keep the registers they had.
template <typename T, int D, bool kQRound, int kR>
__global__ void __launch_bounds__(kThreads, 2) dense_attention_kernel_2(DENSE_ATTENTION_PARAMS) {
  dense_attention<T, D, kQRound, kR>(DENSE_ATTENTION_ARGS);
}

template <typename T, int D, bool kQRound, int kR>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
           const void* v_scales, const void* lengths, void* o, void* partial, void* tickets,
           int B, int H, int KH, int C, int window, float sm_scale, int splits,
           cudaStream_t st) {
  const dim3 grid(splits, KH, B);
  // only the build a launch needs is compiled
  void (*kernel)(DENSE_ATTENTION_PARAMS);
  if constexpr (kQRound && D == 64)
    kernel = dense_attention_kernel_2<T, D, kQRound, kR>;
  else
    kernel = dense_attention_kernel<T, D, kQRound, kR>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(partial),
      static_cast<int*>(tickets), H, KH, C, window, sm_scale, splits);
  return static_cast<int>(cudaGetLastError());
}

#define DENSE_LAUNCH_ARGS                                                               \
  q, k_cache, v_cache, k_scales, v_scales, lengths, o, partial, tickets, B, H, KH, D, C, \
      window, sm_scale, splits, st

template <typename T, bool kQRound, int kR>
int launch_d(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
             const void* v_scales, const void* lengths, void* o, void* partial,
             void* tickets, int B, int H, int KH, int D, int C, int window, float sm_scale,
             int splits, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, kQRound, kR>(q, k_cache, v_cache, k_scales, v_scales, lengths, o,
                                        partial, tickets, B, H, KH, C, window, sm_scale,
                                        splits, st);
    case 128:
      return launch<T, 128, kQRound, kR>(q, k_cache, v_cache, k_scales, v_scales, lengths, o,
                                         partial, tickets, B, H, KH, C, window, sm_scale,
                                         splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8 (bf16, q rounded) and K9 (int8): one query per slot, split
template <typename T, bool kQRound>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
             const void* v_scales, const void* lengths, void* o, void* partial,
             void* tickets, int B, int H, int KH, int D, int C, int window, float sm_scale,
             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || KH < 1 || B > 65535 || KH > 65535 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  // K9 holds four query rows a block where the group has at most four
  // heads (Mistral-7B's G = 4): no code for rows it never has, and 128
  // registers, two blocks per SM; K8 keeps kRows
  if constexpr (std::is_same<T, int8_t>::value) {
    if (H / KH <= 4) return launch_d<T, kQRound, 4>(DENSE_LAUNCH_ARGS);
  }
  return launch_d<T, kQRound, kRows>(DENSE_LAUNCH_ARGS);
}

// -- K6 and K7: T queries per slot on the tensor cores -------------------------

constexpr int kMqChunk = 64;    // cache rows of a stage
constexpr int kMqMaxRows = 64;  // query rows of a block: four 16-row tiles
constexpr int kMqVTerms = 3;    // K7: bf16 terms of each P V weight

// A block's shared memory for a cache of T elements at head dim D: q's rows
// (bf16), then a ring of kStages stages, each a chunk's K rows, its V rows
// and, for int8, its K and V scales. Offsets and pitches in bytes.
template <typename T, int D>
struct MqSmem;

// K6: rows of D + 8 bf16, so the eight rows an ldmatrix reads start on eight
// different 4-bank groups; 3 x 18 KB stages at D = 64, 2 x 34 KB at D = 128
template <int D>
struct MqSmem<__nv_bfloat16, D> {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kPitchQ = (D + 8) * 2;
  static constexpr int kPitchK = kPitchQ;
  static constexpr int kPitchV = kPitchQ;
  static constexpr int kOffV = kMqChunk * kPitchK;
  static constexpr int kStage = 2 * kOffV;
  static constexpr int kOffScales = kStage;  // none
};

// K7: each lane reads 8 bytes of a K row (32 dims, two k16 steps), 16 bytes
// of two q rows and D / 8 bytes of four V rows at a time; the pitches put
// the rows a quarter or half warp reads on distinct banks (K: D + 32, V:
// D + 16, q: 2 D + 64 bytes). The scales follow the V rows, 64 floats each.
// Four stages, 11.5 KB at D = 64 and 19.5 KB at D = 128: three chunks in
// flight while one is read, about the bytes of K6's two.
template <int D>
struct MqSmem<int8_t, D> {
  static constexpr int kStages = 4;
  static constexpr int kPitchQ = 2 * D + 64;
  static constexpr int kPitchK = D + 32;
  static constexpr int kPitchV = D + 16;
  static constexpr int kOffV = kMqChunk * kPitchK;
  static constexpr int kOffScales = kOffV + kMqChunk * kPitchV;
  static constexpr int kStage = kOffScales + 2 * kMqChunk * 4;
};

// dynamic shared memory of a block with MT tiles: q's rows, then the ring
template <typename T, int D, int MT>
constexpr int mq_smem_bytes() {
  return 16 * MT * MqSmem<T, D>::kPitchQ + MqSmem<T, D>::kStages * MqSmem<T, D>::kStage;
}

// the least rows of a share (clip_to_split's min_rows): K7's D = 128 builds
// take kMinShareRows, as K9 and K4 do; K6 has none
template <typename T, int D>
constexpr int kMqMinShareRows = std::is_same<T, int8_t>::value ? kMinShareRows<D> : 0;

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

// the same for 4 bytes (a scale)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
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

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
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

// The float4 granule of row r, granule c4 of a block's warp partials in
// shared memory (rows of D floats). K7's fragment stores put a lane's D / 4
// output dims side by side (the V fragments' column order), so the lanes of a
// half warp would store to one bank pair (16 ways at D = 128); granule c4
// sits at c4 ^ ((c4 / 8 + 2 r) % 8) instead, within its aligned group of
// eight, which leaves two lanes a bank pair. K6 keeps rows as they are.
template <bool kSwizzle, int D>
__device__ __forceinline__ int acc_granule(int r, int c4) {
  return r * (D / 4) + (kSwizzle ? c4 ^ ((c4 / 8 + 2 * r) % 8) : c4);
}

// One block: MT 16-row tiles of one (slot, kv head)'s query rows over one
// split's share of the rows they see. T is the cache element: bf16 (K6) or
// int8 with [B, C, KH] f32 scales (K7).
template <typename T, int D, int MT, bool kSink>
__global__ void __launch_bounds__(kThreads) mq_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ lengths,
    const int* __restrict__ strides, __nv_bfloat16* __restrict__ o,
    float* __restrict__ partial, int* __restrict__ tickets, int Tq, int H, int KH, int C,
    int window, float sm_scale, int splits, const int* __restrict__ win_starts, int sink) {
  using Sm = MqSmem<T, D>;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int BR = 16 * MT;        // query rows of the block
  constexpr int NG = kWarps / MT;    // warps on one tile, each on its own slice of a chunk
  constexpr int KW = kMqChunk / NG;  // cache rows of a warp's slice: 32 or 16
  constexpr int NT = KW / 8;         // 16 x 8 score tiles of a slice
  constexpr int S = Sm::kStages;
  constexpr int STAGE = Sm::kStage;
  constexpr int V8 = D / 8;                       // 16-byte pieces of a q row
  constexpr int RP = D * (int)sizeof(T) / 16;     // 16-byte pieces of a cache row
  constexpr int EP = 16 / (int)sizeof(T);         // cache elements of a piece
  static_assert(BR <= kMqMaxRows && NT % 2 == 0, "tiles of the block");
  static_assert(NG * BR * D * 4 <= S * STAGE, "the warps' partials fit in the ring");
  extern __shared__ __align__(16) unsigned char smem[];  // q's rows [BR][kPitchQ], then the ring
  unsigned char* ring = smem + BR * Sm::kPitchQ;
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
  // the sink predicate of the `_sink` entries (kSink): rows [sink, ws) are
  // pruned; without it the code is the plain kernel's
  [[maybe_unused]] int ws = 0;
  if constexpr (kSink) ws = win_starts[b];
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
    n_live = clip_to_split(c_lo, c_hi, split, splits, kMqMinShareRows<T, D>);
    // an empty share leaves at once without a ticket: the merge reads the
    // live shares only (an empty partial would add exact zeros)
    if (split >= n_live) return;
  }

  const uint32_t q_smem = smem_u32(smem);
  const uint32_t ring_smem = smem_u32(ring);
  const size_t row_step = (size_t)KH * D;  // elements from a slot's cache row to the next
  const T* k_rows = k_cache + ((size_t)b * C * KH + kh) * D;
  const T* v_rows = v_cache + ((size_t)b * C * KH + kh) * D;

  // the block's query rows (row r is head kh * G + r % G of query r / G),
  // unscaled; rows past nr are zeros
  for (int i = tid; i < BR * V8; i += kThreads) {
    const int r = i / V8, c8 = i % V8;
    const int rr = r0 + min(r, nr - 1);
    cp_async16(q_smem + r * Sm::kPitchQ + c8 * 16,
               q + (((size_t)b * Tq + rr / G) * H + kh * G + rr % G) * D + c8 * 8, r < nr);
  }
  // chunk c of the share into stage s; rows past the share are zeros
  auto load_chunk = [&](int c, int s) {
    const int c0 = c_lo + c * kMqChunk;
    const uint32_t k_dst = ring_smem + s * STAGE;
    const uint32_t v_dst = k_dst + Sm::kOffV;
    for (int i = tid; i < kMqChunk * RP; i += kThreads) {
      const int r = i / RP, cp = i % RP;
      const bool in = c0 + r < c_hi;
      const size_t off = in ? (c0 + r) * row_step + cp * EP : 0;
      cp_async16(k_dst + r * Sm::kPitchK + cp * 16, k_rows + off, in);
      cp_async16(v_dst + r * Sm::kPitchV + cp * 16, v_rows + off, in);
    }
    if constexpr (kInt8) {  // the chunk's K scales, then its V scales
      for (int i = tid; i < 2 * kMqChunk; i += kThreads) {
        const int r = i % kMqChunk;
        const bool in = c0 + r < c_hi;
        const float* src = i < kMqChunk ? k_scales : v_scales;
        cp_async4(k_dst + Sm::kOffScales + i * 4,
                  src + (in ? ((size_t)b * C + c0 + r) * KH + kh : 0), in);
      }
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
    if constexpr (kSink) if (col0 >= sink && col0 < ws) continue;  // a pruned slice
    const uint32_t k_src = ring_smem + (c % S) * STAGE + kg * KW * Sm::kPitchK;
    const uint32_t v_src = ring_smem + (c % S) * STAGE + Sm::kOffV + kg * KW * Sm::kPitchV;

    // S = Q K^T over the slice
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kInt8) {
      // K's bytes become bf16 B fragments in registers, exactly. Within each
      // 32 dims a lane holds dims 8 (lane % 4) .. + 7 of its K row: the k
      // slots of two k16 steps, permuted alike in q's A fragments (a sum
      // over k does not depend on its order)
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        const uint32_t at = (32 * kk + 8 * (lane % 4)) * 2;
        const uint4 x = lds128(q_smem + (tile0 + lane / 4) * Sm::kPitchQ + at);
        const uint4 y = lds128(q_smem + (tile0 + lane / 4 + 8) * Sm::kPitchQ + at);
        const uint32_t a0[4] = {x.x, y.x, x.y, y.y};
        const uint32_t a1[4] = {x.z, y.z, x.w, y.w};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 kr = lds64(k_src + (j * 8 + lane / 4) * Sm::kPitchK + 32 * kk +
                                 8 * (lane % 4));
          uint32_t kb[4];
          i8x4_to_bf16(kr.x, kb[0], kb[1]);
          i8x4_to_bf16(kr.y, kb[2], kb[3]);
          mma_16816(s[j], a0, kb[0], kb[1]);
          mma_16816(s[j], a1, kb[2], kb[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_smem + (tile0 + lane % 16) * Sm::kPitchQ + (kk * 16 + lane / 16 * 8) * 2);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kb[4];  // K rows 8j .. 8j + 15 of the slice: two B fragments
          ldsm_x4(kb, k_src + (j * 8 + lane % 8 + lane / 16 * 8) * Sm::kPitchK +
                          (kk * 16 + lane / 8 % 2 * 8) * 2);
          mma_16816(s[j], a, kb[0], kb[1]);
          mma_16816(s[j + 1], a, kb[2], kb[3]);
        }
      }
    }

    // masks, then the online softmax of each row over the slice: the max
    // over the four lanes that hold a row
    const float* scales =  // K7: the slice's K scales, then 64 floats on its V scales
        reinterpret_cast<const float*>(ring + (c % S) * STAGE + Sm::kOffScales) + kg * KW;
    float mx[2] = {m[0], m[1]};
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float2 ks = make_float2(1.f, 1.f);
      if constexpr (kInt8) ks = *reinterpret_cast<const float2*>(scales + j * 8 + lane % 4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = col0 + j * 8 + lane % 4 * 2 + e % 2;
        const bool in = col >= lo[h] && col < hi[h];
        live |= (in ? 1u : 0u) << (j * 4 + e);
        if constexpr (kInt8)
          s[j][e] = in ? s[j][e] * sm_scale * (e % 2 ? ks.y : ks.x) : kNegInf;
        else
          s[j][e] = in ? s[j][e] * sm_scale : kNegInf;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
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
    // P as the A fragments of the slice's 16-row steps: K6 p rounded to
    // bf16; K7 w = p v_scale as kMqVTerms bf16 terms that sum to it
    constexpr int NP = kInt8 ? kMqVTerms : 1;
    uint32_t pa[NP][NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = live >> (j * 4 + e) & 1u ? expf(s[j][e] - m[e / 2]) : 0.f;
        l[e / 2] += p[e];
      }
      if constexpr (kInt8) {
        const float2 vs =
            *reinterpret_cast<const float2*>(scales + kMqChunk + j * 8 + lane % 4 * 2);
        float w[4] = {p[0] * vs.x, p[1] * vs.y, p[2] * vs.x, p[3] * vs.y};
#pragma unroll
        for (int t = 0; t < NP; ++t) {  // each term the bf16 of what the earlier ones left
          const uint32_t w01 = pack_bf16(w[0], w[1]), w23 = pack_bf16(w[2], w[3]);
          pa[t][j / 2][j % 2 * 2] = w01;
          pa[t][j / 2][j % 2 * 2 + 1] = w23;
          if (t + 1 < NP) {
            const float2 f01 = bf16x2_to_float2(w01), f23 = bf16x2_to_float2(w23);
            w[0] -= f01.x;
            w[1] -= f01.y;
            w[2] -= f23.x;
            w[3] -= f23.y;
          }
        }
      } else {
        pa[0][j / 2][j % 2 * 2] = pack_bf16(p[0], p[1]);
        pa[0][j / 2][j % 2 * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V over the slice
    if constexpr (kInt8) {
      // V's bytes become the B fragments in registers: a lane reads D / 8
      // bytes of four V rows, 16 ks + 2 (lane % 4), + 1, + 8, + 9 of the
      // slice, at dims (lane / 4) D / 8 .. + D / 8 - 1. gather / gather_hi
      // pair two rows' bytes, so 16-dim column step n2 takes dims
      // (lane / 4) D / 8 + 2 n2 and + 1 as its two n tiles: the output
      // columns are permuted, and put back when the partials are stored
      constexpr int VB = D / 8;  // bytes a lane reads of a V row
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks) {
        const uint32_t at = v_src + (16 * ks + 2 * (lane % 4)) * Sm::kPitchV + lane / 4 * VB;
        uint32_t rv[4][VB / 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t row = at + (i % 2 + i / 2 * 8) * Sm::kPitchV;  // rows +0, +1, +8, +9
          if constexpr (VB == 16) {
            const uint4 x = lds128(row);
            rv[i][0] = x.x;
            rv[i][1] = x.y;
            rv[i][2] = x.z;
            rv[i][3] = x.w;
          } else {
            const uint2 x = lds64(row);
            rv[i][0] = x.x;
            rv[i][1] = x.y;
          }
        }
#pragma unroll
        for (int wd = 0; wd < VB / 4; ++wd)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {  // column step n2 = 2 wd + hf
            const int n2 = 2 * wd + hf;
            const uint32_t u01 = hf ? gather_hi(rv[0][wd], rv[1][wd]) : gather(rv[0][wd], rv[1][wd]);
            const uint32_t u89 = hf ? gather_hi(rv[2][wd], rv[3][wd]) : gather(rv[2][wd], rv[3][wd]);
            uint32_t b0[2], b1[2];  // [the step's n tile]
            i8x4_to_bf16(u01, b0[0], b0[1]);
            i8x4_to_bf16(u89, b1[0], b1[1]);
#pragma unroll
            for (int t = 0; t < NP; ++t) {
              mma_16816(acc[2 * n2], pa[t][ks], b0[0], b1[0]);
              mma_16816(acc[2 * n2 + 1], pa[t][ks], b0[1], b1[1]);
            }
          }
      }
    } else {
      // V read transposed
#pragma unroll
      for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t vb[4];  // V rows 16 ks .. + 15, columns 16 n .. + 15: two B fragments
          ldsm_x4_t(vb, v_src + (ks * 16 + lane % 16) * Sm::kPitchV + (n * 16 + lane / 16 * 8) * 2);
          mma_16816(acc[2 * n], pa[0][ks], vb[0], vb[1]);
          mma_16816(acc[2 * n + 1], pa[0][ks], vb[2], vb[3]);
        }
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
    if constexpr (kInt8) {
      // tile n = 2 n2 + e holds dims (2 (lane % 4) + {0, 1}) D / 8 + 2 n2 + e
      auto at = [&](int row, int d) { return mine + acc_granule<true, D>(row, d / 4) * 4 + d % 4; };
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const int d = 2 * (lane % 4) * (D / 8) + 2 * n2;
        *reinterpret_cast<float2*>(at(r, d)) = make_float2(acc[2 * n2][0], acc[2 * n2 + 1][0]);
        *reinterpret_cast<float2*>(at(r, d + D / 8)) =
            make_float2(acc[2 * n2][1], acc[2 * n2 + 1][1]);
        *reinterpret_cast<float2*>(at(r + 8, d)) =
            make_float2(acc[2 * n2][2], acc[2 * n2 + 1][2]);
        *reinterpret_cast<float2*>(at(r + 8, d + D / 8)) =
            make_float2(acc[2 * n2][3], acc[2 * n2 + 1][3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = n * 8 + lane % 4 * 2;
        *reinterpret_cast<float2*>(mine + r * D + d) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(mine + (r + 8) * D + d) = make_float2(acc[n][2], acc[n][3]);
      }
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
    const int at = acc_granule<kInt8, D>(r, j % (D / 4));
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NG; ++w) {
      const float f = m_w[w][r];
      const float4 a = reinterpret_cast<const float4*>(acc_w + w * BR * D)[at];
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

template <typename T, int D, int MT, bool kSink>
int launch_mq(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
              const void* v_scales, const void* lengths, const void* strides, void* o,
              void* partial, void* tickets, int B, int Tq, int H, int KH, int C, int window,
              float sm_scale, int splits, const void* win_starts, int sink, cudaStream_t st) {
  constexpr int smem = mq_smem_bytes<T, D, MT>();
  static bool ready[64] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(mq_attention_kernel<T, D, MT, kSink>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int rows = Tq * (H / KH);
  const dim3 grid((rows + 16 * MT - 1) / (16 * MT) * splits, KH, B);
  mq_attention_kernel<T, D, MT, kSink><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(lengths),
      static_cast<const int*>(strides), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(partial), static_cast<int*>(tickets), Tq, H, KH, C, window,
      sm_scale, splits, static_cast<const int*>(win_starts), sink);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mq(const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
                const void* v_scales, const void* lengths, const void* strides, void* o,
                void* partial, void* tickets, int B, int Tq, int H, int KH, int D, int C,
                int window, float sm_scale, int splits, void* stream,
                const void* win_starts = nullptr, int sink = 0) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tq < 1 || C < 1 || KH < 1 || B > 65535 || KH > 65535 || H % KH != 0 ||
      H / KH > kMaxG || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = mq_tiles(Tq * (H / KH)) == 2;
#define AIOS_MQ_LAUNCH(D_, MT_)                                                          \
  (win_starts ? launch_mq<T, D_, MT_, true>(q, k_cache, v_cache, k_scales, v_scales,     \
                                            lengths, strides, o, partial, tickets, B, Tq, \
                                            H, KH, C, window, sm_scale, splits,           \
                                            win_starts, sink, st)                         \
              : launch_mq<T, D_, MT_, false>(q, k_cache, v_cache, k_scales, v_scales,    \
                                             lengths, strides, o, partial, tickets, B,   \
                                             Tq, H, KH, C, window, sm_scale, splits,     \
                                             nullptr, 0, st))
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
  return dispatch<__nv_bfloat16, true>(q, k_cache, v_cache, nullptr, nullptr, lengths, o,
                                       partial, tickets, B, H, KH, D, C, window, sm_scale,
                                       splits, stream);
}

// The same over an int8 cache: k_scales / v_scales are [B, C, KH] f32.
extern "C" int aios_decode_attention_int8(const void* q, const void* k_cache,
                                          const void* v_cache, const void* k_scales,
                                          const void* v_scales, const void* lengths,
                                          void* o, void* partial, void* tickets, int B,
                                          int H, int KH, int D, int C, int window,
                                          int splits, float sm_scale, void* stream) {
  return dispatch<int8_t, false>(q, k_cache, v_cache, k_scales, v_scales, lengths, o,
                                 partial, tickets, B, H, KH, D, C, window, sm_scale, splits,
                                 stream);
}

// T queries per slot over a bf16 cache, q and o [B, T, H, D]: B * KH *
// ceil(T * H / KH / 64) groups of partials of 64 * (D + 2) floats.
extern "C" int aios_multiquery_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* lengths,
    const void* strides, void* o, void* partial, void* tickets, int B, int T, int H,
    int KH, int D, int C, int window, int splits, float sm_scale, void* stream) {
  return dispatch_mq<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, lengths, strides,
                                    o, partial, tickets, B, T, H, KH, D, C, window, sm_scale,
                                    splits, stream);
}

// The same over an int8 cache with [B, C, KH] f32 scales, the same groups.
extern "C" int aios_multiquery_decode_attention_int8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
    const void* v_scales, const void* lengths, const void* strides, void* o, void* partial,
    void* tickets, int B, int T, int H, int KH, int D, int C, int window, int splits,
    float sm_scale, void* stream) {
  return dispatch_mq<int8_t>(q, k_cache, v_cache, k_scales, v_scales, lengths, strides, o,
                             partial, tickets, B, T, H, KH, D, C, window, sm_scale, splits,
                             stream);
}

// The two above with window+sink compression's predicate: win_starts [B]
// int32, query rows of slot b see only cache rows col < sink or col >=
// win_starts[b] (and their staircase and window). The same groups.
extern "C" int aios_multiquery_decode_attention_sink(
    const void* q, const void* k_cache, const void* v_cache, const void* lengths,
    const void* strides, const void* win_starts, void* o, void* partial, void* tickets, int B,
    int T, int H, int KH, int D, int C, int window, int sink, int splits, float sm_scale,
    void* stream) {
  return dispatch_mq<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, lengths, strides,
                                    o, partial, tickets, B, T, H, KH, D, C, window, sm_scale,
                                    splits, stream, win_starts, sink);
}

extern "C" int aios_multiquery_decode_attention_int8_sink(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scales,
    const void* v_scales, const void* lengths, const void* strides, const void* win_starts,
    void* o, void* partial, void* tickets, int B, int T, int H, int KH, int D, int C,
    int window, int sink, int splits, float sm_scale, void* stream) {
  return dispatch_mq<int8_t>(q, k_cache, v_cache, k_scales, v_scales, lengths, strides, o,
                             partial, tickets, B, T, H, KH, D, C, window, sm_scale, splits,
                             stream, win_starts, sink);
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
