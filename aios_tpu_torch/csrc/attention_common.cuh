// Shared by the decode-attention kernels (paged_attention.cu over the page
// pool, dense_attention.cu over the dense slot cache): the block geometry,
// warp reductions, per cache element type how a 16-byte K vector dots with q
// and how a lane's D/32 elements of a V row load and convert, and the split
// of a slot's rows over several blocks with its merge in the same launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;  // query heads per kv head
constexpr unsigned kFull = 0xffffffffu;

// two bf16 packed in a word (low half first) as floats: bf16 is the top
// half of an fp32
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// byte j of a word as a signed value
__device__ __forceinline__ float s8(uint32_t w, int j) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 24);
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

// What differs between the pool element types: how a 16-byte K vector
// dots with q, and how a lane's D/32 elements of a V row load and convert.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kQuant = false;
  static constexpr int kPerVec = 8;  // elements per 16-byte vector
  __device__ static float dot(const float* q, uint4 k) {
    const float4 qa = *reinterpret_cast<const float4*>(q);
    const float4 qb = *reinterpret_cast<const float4*>(q + 4);
    const float2 k0 = bf16x2_to_float2(k.x);
    const float2 k1 = bf16x2_to_float2(k.y);
    const float2 k2 = bf16x2_to_float2(k.z);
    const float2 k3 = bf16x2_to_float2(k.w);
    return qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
           qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
  }
  // DL elements = DL / 2 words
  template <int DL>
  __device__ static void load_v(const __nv_bfloat16* src, uint32_t* w) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int d = 0; d < DL / 2; ++d) w[d] = p[d];
  }
  template <int DL>
  __device__ static void v_floats(const uint32_t* w, float* out) {
#pragma unroll
    for (int d = 0; d < DL / 2; ++d) {
      const float2 f = bf16x2_to_float2(w[d]);
      out[2 * d] = f.x;
      out[2 * d + 1] = f.y;
    }
  }
};

template <>
struct Elem<int8_t> {
  static constexpr bool kQuant = true;
  static constexpr int kPerVec = 16;
  __device__ static float dot(const float* q, uint4 k) {
    const uint32_t w[4] = {k.x, k.y, k.z, k.w};
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(q + 4 * i);
      r += qa.x * s8(w[i], 0) + qa.y * s8(w[i], 1) + qa.z * s8(w[i], 2) +
           qa.w * s8(w[i], 3);
    }
    return r;
  }
  // DL elements = DL bytes: one 16-bit load (D = 64) or DL / 4 words
  template <int DL>
  __device__ static void load_v(const int8_t* src, uint32_t* w) {
    if constexpr (DL < 4) {
      w[0] = *reinterpret_cast<const uint16_t*>(src);
    } else {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
      for (int d = 0; d < DL / 4; ++d) w[d] = p[d];
    }
  }
  template <int DL>
  __device__ static void v_floats(const uint32_t* w, float* out) {
#pragma unroll
    for (int d = 0; d < DL; ++d) out[d] = s8(w[d / 4], d % 4);
  }
};

// -- one slot's rows split over blocks ------------------------------------------
//
// The host picks the number of splits from C, B, KH and the SM count alone
// (ops/split.py, split_plan), never from the lengths, which stay
// on the device. Each block of a (query tile, kv head, slot) cuts the rows the
// tile's queries can see into `splits` equal shares of whole 32-row warp
// chunks, in order, so every split has the same work whatever the slot's
// length and window; it reduces its share to a partial softmax, writes it to
// a workspace and takes a ticket, and the block that draws the last ticket
// merges the partials in split order in the same launch and sets the ticket
// back to 0 (wq_matmul.cuh's split K): no float atomics, and two launches
// give identical bits. (A thread-block cluster merging through distributed
// shared memory measured slower on the H100: a cluster holds all its SMs
// until its slowest block is done.)

constexpr int kMaxSplits = 8;
constexpr int kSplitAlign = 32;  // rows of a warp chunk

// The visible rows [c_lo, c_hi) cut to share z of `splits`, each share at
// least `min_rows` (a multiple of kSplitAlign); empty (c_lo >= c_hi) when
// the rows run out before it, and the block then contributes the empty
// partial m = -1e30, l = 0, acc = 0. Returns how many shares hold rows: the
// empty ones are the last. (split_share in ops/split.py is the same cut.)
__device__ __forceinline__ int clip_to_split(int& c_lo, int& c_hi, int z, int splits,
                                             int min_rows = 0) {
  const int visible = c_hi - c_lo;
  const int share = (visible + splits - 1) / splits;
  const int rows = max((share + kSplitAlign - 1) / kSplitAlign * kSplitAlign, min_rows);
  c_lo += z * rows;
  c_hi = min(c_hi, c_lo + rows);
  return (visible + rows - 1) / rows;
}

// The least rows of a share at head dim D (clip_to_split's min_rows) for the
// int8 kernels that split, K4 over the page pool and K9 over the dense cache.
// K4's D = 128 builds hold one block per SM (175 and 247 registers), so
// Mistral-7B's grid (8 slots x 8 kv heads x 4 splits) takes two waves:
// there a share is at least one pass of the block's eight warps, and a slot
// of a few hundred rows runs in fewer, fuller blocks within one wave. A
// D = 64 build holds two blocks per SM, and the finest shares were fastest
// (tools/split_sweep.py, the served lengths). K9 takes the same floor; its
// four-row build holds two blocks per SM, and there equal shares measured
// faster at the served lengths (tools/paged_variants/no_least_share.patch).
// 256 is kWarps * 32 rows (MIN_SHARE_ROWS_D128 in ops/split.py).
template <int D>
constexpr int kMinShareRows = D == 64 ? 0 : 256;

// Floats of one split's partial in the workspace for R query rows: acc
// [R * D], then m and l [R] each. The decode kernels hold kMaxG rows a
// block, K6 up to 64 (partial_floats in ops/split.py).
template <int D, int R = kMaxG>
__host__ __device__ constexpr int partial_floats() {
  return R * (D + 2);
}

// Split z of a group of `splits` blocks has its partial for nr <= R query
// rows in shared memory: m[r], l[r] (running max and sum) and acc[r * D + d]
// (the output, not yet divided by l). It writes them to slot z of `part` (the
// group's splits * partial_floats<D, R>() floats), and the block that draws the
// last of the group's tickets calls store(i, o) for i = r * D + d with
//   o = sum_z acc_z * e^(m_z - M) / sum_z l_z * e^(m_z - M),  M = max_z m_z,
// a sum <= 0 taken as 1 (a row with no visible column gives 0). Every thread
// of the block calls it; `last` is a shared int.
template <int D, int R = kMaxG, class Store>
__device__ __forceinline__ void merge_splits(const float* m, const float* l, const float* acc,
                                             int nr, int z, int splits, float* part,
                                             int* ticket, int* last, Store store) {
  constexpr int P = partial_floats<D, R>();
  const int tid = threadIdx.x;
  __syncthreads();  // the block's partial is in shared memory
  float* mine = part + z * P;
  for (int i = tid; i < nr * D; i += blockDim.x) __stcg(mine + i, acc[i]);
  if (tid < nr) {
    __stcg(mine + R * D + tid, m[tid]);
    __stcg(mine + R * D + R + tid, l[tid]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < nr * D; i += blockDim.x) {
    const int r = i / D;
    float mz[kMaxSplits], lz[kMaxSplits], az[kMaxSplits];
    float M = kNegInf;
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y) {  // every split's loads in flight at once
      const float* py = part + y * P;
      const bool in = y < splits;
      mz[y] = in ? __ldcg(py + R * D + r) : kNegInf;
      lz[y] = in ? __ldcg(py + R * D + R + r) : 0.f;
      az[y] = in ? __ldcg(py + i) : 0.f;
      M = fmaxf(M, mz[y]);
    }
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y) {
      if (y >= splits) break;
      const float f = expf(mz[y] - M);
      L += lz[y] * f;
      O += az[y] * f;
    }
    store(i, O / (L <= 0.f ? 1.f : L));
  }
  if (tid == 0) *ticket = 0;  // every split has drawn: ready for the next launch
}

// K6's merge (dense_attention.cu), for partials of up to R = 64 query rows:
// merge_splits' ticket and sums, read wider. merge_splits walks a partial
// one float a thread at a time, an L2 round trip per pass, 16 passes for a
// 64-row partial at D = 64; here each row's split weights e^(m_z - M) are
// taken once (thread r for row r) into shared memory `w` (kMaxSplits * R
// floats), and each thread reads four floats of a row at a time, two such
// reads of every split in flight. Split z has written its acc (R * D floats,
// float4 j = floats 4j .. 4j + 3) to slot z of `part` and has its m and l in
// shared memory; every thread of the block calls this, and the block that
// draws the last ticket calls store(j, o) for j < nr * D / 4 with
//   o = sum_z acc_z e^(m_z - M) / sum_z l_z e^(m_z - M),  M = max_z m_z,
// a sum <= 0 taken as 1. `l` is overwritten.
template <int D, int R, class Store>
__device__ __forceinline__ void merge_row_splits(const float* m, float* l, int nr, int z,
                                                 int splits, float* part, int* ticket,
                                                 int* last, float* w, Store store) {
  constexpr int P = partial_floats<D, R>();
  constexpr int D4 = D / 4;
  const int tid = threadIdx.x;
  float* mine = part + z * P;
  if (tid < nr) {
    __stcg(mine + R * D + tid, m[tid]);
    __stcg(mine + R * D + R + tid, l[tid]);
  }
  __threadfence();
  __syncthreads();  // every thread's stores of the partial are visible
  if (tid == 0) *last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid < nr) {
    float mz[kMaxSplits], lz[kMaxSplits];
    float M = kNegInf;
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y) {
      const bool in = y < splits;
      mz[y] = in ? __ldcg(part + y * P + R * D + tid) : kNegInf;
      lz[y] = in ? __ldcg(part + y * P + R * D + R + tid) : 0.f;
      M = fmaxf(M, mz[y]);
    }
    float L = 0.f;
#pragma unroll
    for (int y = 0; y < kMaxSplits; ++y) {
      const float f = y < splits ? expf(mz[y] - M) : 0.f;
      w[y * R + tid] = f;
      L += lz[y] * f;
    }
    l[tid] = L <= 0.f ? 1.f : L;
  }
  __syncthreads();
  const int n4 = nr * D4;
  for (int j0 = tid; j0 < n4; j0 += 2 * blockDim.x) {
    float4 a[2][kMaxSplits];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * blockDim.x;
#pragma unroll
      for (int y = 0; y < kMaxSplits; ++y)
        a[u][y] = y < splits && j < n4
                      ? __ldcg(reinterpret_cast<const float4*>(part + y * P) + j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j >= n4) break;
      const int r = j / D4;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int y = 0; y < kMaxSplits; ++y) {
        if (y >= splits) break;
        const float f = w[y * R + r];
        o.x += a[u][y].x * f;
        o.y += a[u][y].y * f;
        o.z += a[u][y].z * f;
        o.w += a[u][y].w * f;
      }
      const float L = l[r];
      store(j, make_float4(o.x / L, o.y / L, o.z / L, o.w / L));
    }
  }
  if (tid == 0) *ticket = 0;  // every split has drawn: ready for the next launch
}

}  // namespace
