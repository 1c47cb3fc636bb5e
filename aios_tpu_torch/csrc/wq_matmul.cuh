// The shared core of the weight-quantized matmuls K1 (int8 weights,
// quantized_matmul.cu) and K5 (int4 weights, int4_matmul.cu) on Hopper:
// y[M, N] = x[M, K] @ dequant(w)[K, N], x and y bf16, fp32 accumulation.
//
// One kernel template, specialised on a weight-format policy (Int8Weights or
// Int4Weights below) and on the tile: BT activation rows by 64 * NC weight
// columns, NC consumer warpgroups. The wrapper's plan() picks the tile by M:
//
//   * weight streaming (M <= 64: decode, verify, small prefill buckets), bound
//     by the weight bytes: BT = 8, 16, 32 or 64 rows by 64 columns, three or
//     two blocks per SM, each a ring of 3-8 stages; K split over blocks up to
//     one wave of resident blocks (at 64 rows, parts of at least 8 stages);
//   * prefill (M > 64), bound by the tensor cores: 128 x 128 tiles (BT = 128,
//     two consumer warpgroups), one block per SM, K whole; a grid of at most
//     half as many such tiles as SMs takes the 64 x 64 tile instead.
//
// Both paths are the same code. The operands are swapped: the dequantized
// weight is wgmma's A operand, in registers, 64 weight columns per consumer
// warpgroup, and x is the B operand, BT rows read from shared memory through
// a 128-byte-swizzled K-major descriptor. So the activation rows sit on
// wgmma's N side (m64nBTk16) and nothing is padded to 64 rows at decode; and
// the dequantized weight never exists anywhere but in registers.
//
// Warp roles. The consumer warpgroups come first, then one producer warp, of
// which one thread starts each stage's copies: TMA boxes of x (64 k x BT
// rows, 128-byte swizzle, the layout the descriptor names) and of the raw
// weight rows (64 rows x 64 * NC bytes, 64- or 128-byte swizzle), and for
// int4 a bulk copy of the group's scales, all counted on the stage's `full`
// mbarrier (arrive.expect_tx); TMA zero-fills rows past M and K and columns
// past N. Each consumer warpgroup waits on `full`, reads its raw bytes (each
// thread two adjacent columns of four weight rows per k16 step), turns them
// into bf16 A fragments by the policy, four k16 steps (a chunk) at a time,
// starts each chunk's wgmmas as one group, and keeps one group in flight
// while it dequantizes the next chunk into a second register buffer; when a
// stage's last group has retired the stage is released on `empty`.
//
// Split K. With more than one split, each block writes its fp32 tile to the
// partial buffer in fragment order, fences, and takes a ticket from the
// tile's counter. The block that draws the last ticket sums every split in
// split order (fixed, so two launches give identical bits; no float
// atomics), applies the epilogue, writes bf16 and sets the counter back to 0
// for the next launch on the stream.
//
// The expert-batched entry (EX, int8 weights only: run_experts) adds a batch
// axis: w is a stack [X, K, N] of experts with scales [X, N], the output
// [B, M, N] holds B batches of M rows, and each batch b multiplies its rows
// by expert index[b] (b itself without an index). Its rows are x's batch b
// when x is batched ([B, M, K]) and all of x ([M, K]) when it is shared. The
// grid's x axis walks (batch, row tile); each block reads its batch's expert
// from the index in device memory and takes that expert's rows through a 3-D
// weight map (an expert outside [0, X) reads as zeros), so routing never
// leaves the device and a launch captures into a CUDA graph. Split K and
// the tiles are K1's; the scale multiplies each expert's fp32 sums in the
// epilogue, before anything sums over experts.
//
// Launch contract (checked by run()): x, w, s 16-byte aligned; K % 8 == 0;
// N % 16 == 0; k_per_split a multiple of the policy's KT; (block_t, block_n)
// one of the tiles run() lists; partial holds splits * tiles * BT * COLS
// floats and counters one int per tile when splits > 1. The tensor maps are
// encoded per launch (they hold this launch's pointers) by
// hopper::encode (hopper.cuh), through the CUDA runtime: no link flag.

#pragma once

#include "hopper.cuh"
#include "int8_bf16.cuh"

namespace wq {

using namespace hopper;
using int8_bf16::gather;
using int8_bf16::i8x4_to_bf16;
constexpr int kWgCols = 64;  // weight columns per consumer warpgroup (wgmma's M)

struct Args {
  // x [M, K] bf16 (experts: [B or 1, M, K]): boxes of 64 k x BT rows, 128-byte swizzle
  CUtensorMap x_map;
  // raw weight rows [K or K/2, N] u8 (experts: [X, K, N]): boxes of COLS x 64 rows, swizzled
  CUtensorMap w_map;
  const float* s;     // [N] per-column scales or [K/128, N] group scales (experts: [X, N])
  __nv_bfloat16* y;        // [M, N] bf16 (experts: [B, M, N])
  float* partial;          // split-K partials, fragment order
  int* counters;           // one ticket counter per output tile, 0 between launches
  int M, N, K, k_per_split, splits;
  // the expert entry only
  const int* index;  // [B] the expert of each batch, or null: batch b is expert b
  int m_tiles;       // row tiles per batch
  int x_batched;     // x holds a batch axis (else every batch reads all of x)
  int experts;       // X
};

// What a block works on: its first row within its batch, the batch's x
// coordinate and expert, its output rows and its expert's scales. K1 and K5
// have one batch: row tile blockIdx.x of y and s themselves.
struct Tile {
  int m0, xb, e;
  __nv_bfloat16* y;
  const float* s;
};

template <bool EX>
__device__ __forceinline__ Tile tile_of(const Args& a, int bt) {
  if constexpr (!EX) {
    return Tile{static_cast<int>(blockIdx.x) * bt, 0, 0, a.y, a.s};
  } else {
    const int b = blockIdx.x / a.m_tiles;
    const int e = a.index ? __ldg(a.index + b) : b;
    // an expert out of range reads zero weights; any finite scale keeps its sums 0
    const int es = min(max(e, 0), a.experts - 1);
    return Tile{(static_cast<int>(blockIdx.x) % a.m_tiles) * bt, a.x_batched ? b : 0, e,
                a.y + static_cast<size_t>(b) * a.M * a.N, a.s + static_cast<size_t>(es) * a.N};
  }
}

// -- shared-memory loads of the raw weight tile --------------------------------

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// -- weight formats -----------------------------------------------------------

// nibbles (one per byte of v) b and b+1 as bf16x2 of bf16_rn(f32(q - 8) * scale)
template <int B>
__device__ __forceinline__ uint32_t nib_pair(uint32_t v, float scale) {
  const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | B)) - 8388616.f;
  const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 | (B + 1))) - 8388616.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0 * scale, f1 * scale);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A fragment rows g and g+8 of a warp are two ADJACENT weight columns (col,
// col + 1), so a thread reads 2 bytes per weight row; its k pairs are rows
// 2t, 2t+1 and 2t+8, 2t+9 of the k16 step, at byte offsets `even` and `odd`
// within an even and an odd row of the swizzled raw tile (see raw_offset).
// gather (int8_bf16.cuh) puts (row 2t, col), (row 2t+1, col), (row 2t, col+1),
// (row 2t+1, col+1) in bytes 0..3, and i8x4_to_bf16 makes them bf16x2 words.

// K1: int8 [K, N], one f32 scale per column applied to the fp32 sum in the
// epilogue (the TPU kernel's (acc * s) order).
struct Int8Weights {
  static constexpr int KT = 64;        // K rows per stage
  static constexpr int RAW_ROWS = 64;  // weight rows per stage
  static constexpr int CHUNKS = 1;     // chunks of four wgmma k16 steps per stage
  static constexpr bool kGroupScales = false;
  static __host__ __device__ __forceinline__ int raw_row(int k) { return k; }
  // the stage's k16 step of fragment i of chunk H
  template <int H>
  static __device__ __forceinline__ constexpr int kstep(int i) { return i; }

  template <int H>
  static __device__ __forceinline__ void dequant(uint32_t raw, int pitch, int t, uint32_t even,
                                                 uint32_t odd, uint32_t, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t r = raw + (16 * j + 2 * t) * pitch;
      const uint32_t r0 = lds_u16(r + even), r1 = lds_u16(r + pitch + odd);
      const uint32_t r2 = lds_u16(r + 8 * pitch + even), r3 = lds_u16(r + 9 * pitch + odd);
      i8x4_to_bf16(gather(r0, r1), a[j][0], a[j][1]);
      i8x4_to_bf16(gather(r2, r3), a[j][2], a[j][3]);
    }
  }

  static __device__ __forceinline__ float2 out_scale(const float* s, int n) {
    return *reinterpret_cast<const float2*>(s + n);
  }
};

// K5: split-half nibbles [K/2, N]: within each 128-row group, packed row r
// holds K-row r (low nibble) and K-row r + 64 (high nibble), offset-binary
// q + 8; one f32 scale per (group, column). Each weight becomes
// bf16_rn(f32(q - 8) * s) before the product, the plain version's rounding:
// group scales cannot post-scale the accumulator. A stage is one group, in
// two chunks: chunk H reads packed rows 32H .. 32H + 31, whose low nibbles
// are k16 steps 2H, 2H + 1 of the group's lower half and whose high nibbles
// are the matching steps 4 + 2H, 5 + 2H of its upper half.
struct Int4Weights {
  static constexpr int KT = 128;
  static constexpr int RAW_ROWS = 64;
  static constexpr int CHUNKS = 2;
  static constexpr bool kGroupScales = true;
  static __host__ __device__ __forceinline__ int raw_row(int k) { return k / 2; }
  template <int H>
  static __device__ __forceinline__ constexpr int kstep(int i) {
    return (i < 2 ? 0 : 4) + 2 * H + i % 2;
  }

  template <int H>
  static __device__ __forceinline__ void dequant(uint32_t raw, int pitch, int t, uint32_t even,
                                                 uint32_t odd, uint32_t sc, uint32_t (&a)[4][4]) {
    const float2 s = lds_f32x2(sc);  // this thread's two columns
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const uint32_t r = raw + (16 * (2 * H + jj) + 2 * t) * pitch;
      const uint32_t u01 = gather(lds_u16(r + even), lds_u16(r + pitch + odd));
      const uint32_t u23 = gather(lds_u16(r + 8 * pitch + even), lds_u16(r + 9 * pitch + odd));
      const uint32_t lo01 = u01 & 0x0F0F0F0Fu, hi01 = (u01 >> 4) & 0x0F0F0F0Fu;
      const uint32_t lo23 = u23 & 0x0F0F0F0Fu, hi23 = (u23 >> 4) & 0x0F0F0F0Fu;
      a[jj][0] = nib_pair<0>(lo01, s.x);
      a[jj][1] = nib_pair<2>(lo01, s.y);
      a[jj][2] = nib_pair<0>(lo23, s.x);
      a[jj][3] = nib_pair<2>(lo23, s.y);
      a[2 + jj][0] = nib_pair<0>(hi01, s.x);
      a[2 + jj][1] = nib_pair<2>(hi01, s.y);
      a[2 + jj][2] = nib_pair<0>(hi23, s.x);
      a[2 + jj][3] = nib_pair<2>(hi23, s.y);
    }
  }

  static __device__ __forceinline__ float2 out_scale(const float*, int) {
    return make_float2(1.f, 1.f);
  }
};

// -- the kernel ---------------------------------------------------------------

// Blocks resident per SM for BT activation rows per block: three up to 32
// streaming rows, two at 64, one in prefill (128 rows). The wrappers' plan
// splits K by the same table (BLOCKS_PER_SM in ops/quantized_matmul.py; a
// test holds the two equal).
constexpr int kBlocksPerSm[5][2] = {{8, 3}, {16, 3}, {32, 3}, {64, 2}, {128, 1}};

constexpr int blocks_per_sm(int bt) {
  for (const auto& e : kBlocksPerSm)
    if (e[0] == bt) return e[1];
  return 0;
}

template <class P, int BT, int NC>
struct Config {
  static constexpr int CONSUMERS = NC * kWarpgroup;
  static constexpr int THREADS = CONSUMERS + 32;  // the consumers, then one producer warp
  static constexpr int COLS = kWgCols * NC;     // weight columns per block
  static constexpr int PITCH = COLS;            // raw row pitch: one TMA box row
  static constexpr int X_BYTES = BT * P::KT * 2;  // BT rows, swizzled 64-k chunks
  static constexpr int RAW_BYTES = P::RAW_ROWS * PITCH;
  static constexpr int SC_BYTES = P::kGroupScales ? COLS * 4 : 0;
  static constexpr int STAGE_BYTES = X_BYTES + RAW_BYTES + SC_BYTES;
  // as many stages (3 to 8) as fit in the block's share of the SM's shared
  // memory
  static constexpr int MIN_BLOCKS = blocks_per_sm(BT);
  static constexpr int BUDGET = 220 * 1024 / MIN_BLOCKS - 2048;
  static constexpr int FIT = BUDGET / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : (FIT < 3 ? 3 : FIT);
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 16;
  static_assert(X_BYTES % 1024 == 0 && RAW_BYTES % 1024 == 0, "swizzle-aligned stages");
  static_assert(COLS == 64 || COLS == 128, "a raw row is one 64- or 128-byte swizzle span");
  static_assert(BT % 8 == 0 && BT <= 128, "wgmma N");
  static_assert(MIN_BLOCKS > 0 && (NC == 2) == (BT == 128), "a tile of kBlocksPerSm");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int V>
struct ChunkIndex {
  static constexpr int value = V;
};

// The block's weight column of A rows g (and g + 8: the next column) for
// consumer thread ctid: 64 columns per consumer warpgroup, 16 per warp.
__device__ __forceinline__ int fragment_col(int ctid) {
  return (ctid / kWarpgroup) * kWgCols + 16 * ((ctid % kWarpgroup) / 32) + 2 * ((ctid % 32) / 4);
}

// Byte offset of weight column `col` (and col + 1) within raw row r of a
// stage: TMA writes a row of COLS bytes with its 16-byte chunks permuted by
// the 64-byte (COLS = 64: chunk ^= (r / 2) % 4) or 128-byte (COLS = 128:
// chunk ^= r % 8) swizzle, which keeps the four row pairs a warp reads at
// once in different banks. `odd` selects the rows 2t + 1 and 2t + 9 of a
// thread, whose parity is all the swizzle sees of r besides t.
template <int COLS>
__device__ __forceinline__ uint32_t raw_offset(int col, int t, int odd) {
  const int f = COLS == 64 ? t : 2 * t + odd;
  return (((col >> 4) ^ f) << 4) | (col & 15);
}

// Floats from the start of `partial` to split z of this block's output tile.
template <int BT, int NC>
__device__ __forceinline__ size_t partial_offset(int splits, int z) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  return (static_cast<size_t>(tile) * splits + z) * (NC * kWarpgroup * BT / 2);
}

// Epilogue of four sums of one fragment: v = (col n, row m), (n, m + 1),
// (n + 1, m), (n + 1, m + 1), scaled by the policy and rounded to bf16.
template <class P>
__device__ __forceinline__ void store_pair(const Args& a, const Tile& tl, int m, int n, float4 v) {
  if (n >= a.N) return;  // N % 16 == 0: n + 1 is in range with n
  const float2 sc = P::out_scale(tl.s, n);
  if (m < a.M)
    *reinterpret_cast<__nv_bfloat162*>(tl.y + static_cast<size_t>(m) * a.N + n) =
        __floats2bfloat162_rn(v.x * sc.x, v.z * sc.y);
  if (m + 1 < a.M)
    *reinterpret_cast<__nv_bfloat162*>(tl.y + static_cast<size_t>(m + 1) * a.N + n) =
        __floats2bfloat162_rn(v.y * sc.x, v.w * sc.y);
}

// Split K, in the same launch. Every thread of the block comes here once the
// block's split is in `partial`; the block that draws the tile's last ticket
// sums every split in split order (fixed, so two launches give identical
// bits; no float atomics), with all its threads and a batch of splits' loads
// in flight each, applies the epilogue and sets the counter back to 0 for the
// next launch on the stream.
template <class P, int BT, int NC>
__device__ __forceinline__ void reduce_splits(const Args& a, const Tile& tl, int* last) {
  constexpr int THREADS = Config<P, BT, NC>::THREADS;
  constexpr int SLOTS = NC * kWarpgroup * BT / 8;  // float4 per split tile
  constexpr int PER_THREAD = BT / 8;               // float4 per consumer thread
  constexpr int SB = 8;                            // splits per batch of loads
  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  bar_sync(1, THREADS);  // the producer warp and the consumers, from their own branches
  if (tid == 0) *last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  bar_sync(1, THREADS);
  if (!*last) return;
  __threadfence();
  const float4* part = reinterpret_cast<const float4*>(a.partial + partial_offset<BT, NC>(a.splits, 0));
  const int m0 = tl.m0, n0 = blockIdx.y * NC * kWgCols;
  for (int q0 = tid; q0 < SLOTS; q0 += 2 * THREADS) {
    const int q[2] = {q0, q0 + THREADS};
    float4 sum[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int z0 = 0; z0 < a.splits; z0 += SB) {
      float4 v[2][SB];
#pragma unroll
      for (int b = 0; b < SB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (z0 + b < a.splits && q[h] < SLOTS) v[h][b] = __ldcg(part + (z0 + b) * SLOTS + q[h]);
#pragma unroll
      for (int b = 0; b < SB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (z0 + b < a.splits && q[h] < SLOTS) {
            sum[h].x += v[h][b].x;
            sum[h].y += v[h][b].y;
            sum[h].z += v[h][b].z;
            sum[h].w += v[h][b].w;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q[h] >= SLOTS) continue;
      const int ctid = q[h] / PER_THREAD, j = q[h] % PER_THREAD;
      store_pair<P>(a, tl, m0 + 8 * j + 2 * (ctid % 4), n0 + fragment_col(ctid), sum[h]);
    }
  }
  if (tid == 0) a.counters[tile] = 0;  // every split has drawn its ticket
}

template <class P, int BT, int NC, bool EX>
__global__ void __launch_bounds__(Config<P, BT, NC>::THREADS, Config<P, BT, NC>::MIN_BLOCKS)
wq_matmul_kernel(const __grid_constant__ Args args) {
  using C = Config<P, BT, NC>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t xs = base;                                // STAGES x X_BYTES
  const uint32_t raws = xs + STAGES * C::X_BYTES;          // STAGES x RAW_BYTES
  const uint32_t scs = raws + STAGES * C::RAW_BYTES;       // STAGES x SC_BYTES
  const uint32_t bars = scs + STAGES * C::SC_BYTES;        // full[STAGES], empty[STAGES]
  int* last = reinterpret_cast<int*>(smem + (bars + 16 * STAGES - smem_u32(smem)));

  const int tid = threadIdx.x;
  const Tile tl = tile_of<EX>(args, BT);
  const int m0 = tl.m0;
  const int n0 = blockIdx.y * C::COLS;
  const int k_begin = blockIdx.z * args.k_per_split;
  const int k_end = min(args.K, k_begin + args.k_per_split);
  const int n_stages = (k_end - k_begin + P::KT - 1) / P::KT;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // -- producer warp: one thread starts every stage's copies ------------------
    if (tid == C::CONSUMERS) {
      // a last column tile past N: its scale copy stops at N
      const uint32_t sc_bytes = P::kGroupScales ? 4 * min(C::COLS, args.N - n0) : 0;
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((i / STAGES) + 1) & 1);
        const int kb = k_begin + i * P::KT;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, C::X_BYTES + C::RAW_BYTES + sc_bytes);
        if constexpr (EX) {
#pragma unroll
          for (int c = 0; c < P::KT / 64; ++c)
            tma_3d(xs + s * C::X_BYTES + c * (BT * 128), &args.x_map, kb + 64 * c, m0, tl.xb, full);
          tma_3d(raws + s * C::RAW_BYTES, &args.w_map, n0, P::raw_row(kb), tl.e, full);
        } else {
#pragma unroll
          for (int c = 0; c < P::KT / 64; ++c)
            tma_2d(xs + s * C::X_BYTES + c * (BT * 128), &args.x_map, kb + 64 * c, m0, full);
          tma_2d(raws + s * C::RAW_BYTES, &args.w_map, n0, P::raw_row(kb), full);
        }
        if constexpr (P::kGroupScales)
          bulk_copy(scs + s * C::SC_BYTES, tl.s + static_cast<size_t>(kb / P::KT) * args.N + n0,
                    sc_bytes, full);
      }
    }
    __syncwarp();
    if (args.splits > 1) reduce_splits<P, BT, NC>(args, tl, last);  // it helps sum the splits
    return;
  }

  // -- consumer warpgroups --------------------------------------------------------
  const int ctid = tid;
  const int col = fragment_col(ctid);
  const int t = tid % 4;
  const uint32_t even = raw_offset<C::COLS>(col, t, 0), odd = raw_offset<C::COLS>(col, t, 1);

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  uint32_t fa[4][4], fb[4][4];  // the fragments of one chunk (four k16 steps), twice

  // Chunk H of stage u / CHUNKS: dequantize into `cur`, start its four
  // wgmmas as one group, wait until the previous chunk's group retired (so
  // `prev` may be rewritten next) and release the stage that group finished.
  auto chunk = [&](uint32_t(&cur)[4][4], uint32_t(&prev)[4][4], int u, auto h) {
    constexpr int H = decltype(h)::value;
    const int i = u / P::CHUNKS, s = i % STAGES;
    if constexpr (H == 0) {
      mbar_wait(bars + 8 * s, (i / STAGES) & 1);  // the stage's copies have landed
    }
    P::template dequant<H>(raws + s * C::RAW_BYTES, C::PITCH, t, even, odd,
                           scs + s * C::SC_BYTES + 4 * col, cur);
    const uint32_t xb = xs + s * C::X_BYTES;
    uint64_t desc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = P::template kstep<H>(j);
      desc[j] = desc_k_sw128(xb + (k / 4) * (BT * 128) + 32 * (k % 4));
    }
    // every operand is defined before the group opens: an instruction that
    // defines a wgmma input inside it makes ptxas serialize the wgmmas
    fence_regs(cur);
    fence_regs(desc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) Wgmma<BT>::mma(acc, cur[j], desc[j], 1u);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's group has retired
    fence_regs(acc);
    fence_regs(prev);
    if (H == 0 && i > 0) mbar_arrive(bars + 8 * (STAGES + (i - 1) % STAGES));
  };
  // fa and fb alternate on every path ptxas can see, so no buffer is
  // redefined while the group that reads it is in flight; with two chunks
  // per stage the pair is one stage, with one it is two
  constexpr int H1 = P::CHUNKS - 1;
  const int n_chunks = n_stages * P::CHUNKS;
  int u = 0;
  for (; u + 1 < n_chunks; u += 2) {
    chunk(fa, fb, u, ChunkIndex<0>{});
    chunk(fb, fa, u + 1, ChunkIndex<H1>{});
  }
  if (u < n_chunks) chunk(fa, fb, u, ChunkIndex<0>{});
  wgmma_wait<0>();
  fence_regs(acc);

  if (args.splits > 1) {
    // this split's fp32 tile, in fragment order: thread ctid's BT/2 sums
    float* mine = args.partial + partial_offset<BT, NC>(args.splits, blockIdx.z) +
                  static_cast<size_t>(ctid) * (BT / 2);
#pragma unroll
    for (int i = 0; i < BT / 2; i += 4)
      __stcg(reinterpret_cast<float4*>(mine + i), make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
    reduce_splits<P, BT, NC>(args, tl, last);
    return;
  }
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
    store_pair<P>(args, tl, m0 + 8 * j + 2 * t, n0 + col,
                  make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
}

// A 2-D row-major tensor [rows, cols] of `elem` bytes, read in boxes of
// box_cols x box_rows; out-of-range elements read as zero.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                      int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return encode<2>(map, type, ptr, dims, strides, box, swizzle);
}

// A 3-D row-major tensor [batches, rows, cols], read in boxes of one batch's
// box_cols x box_rows; out-of-range elements read as zero.
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                      int batches, int rows, int cols, int box_rows, int box_cols,
                      CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem,
                                 static_cast<cuuint64_t>(rows) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  return encode<3>(map, type, ptr, dims, strides, box, swizzle);
}

// `batches` is the expert entry's B (1 for K1 and K5): the grid's x axis
// holds B x the row tiles.
template <class P, int BT, int NC, bool EX>
cudaError_t launch(Args& a, const void* x, const void* w, cudaStream_t stream, int batches) {
  using C = Config<P, BT, NC>;
  const CUtensorMapSwizzle w_swizzle =
      C::COLS == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // the maps hold this launch's pointers: encoded per launch, never cached
  if constexpr (EX) {
    if (!encode_3d(&a.x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.x_batched ? batches : 1,
                   a.M, a.K, BT, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_3d(&a.w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, a.experts, P::raw_row(a.K), a.N,
                   64, C::COLS, w_swizzle))
      return cudaErrorInvalidValue;
  } else {
    if (!encode_2d(&a.x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.M, a.K, BT, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&a.w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, P::raw_row(a.K), a.N, 64,
                   C::COLS, w_swizzle))
      return cudaErrorInvalidValue;
  }
  static bool ready[64] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(wq_matmul_kernel<P, BT, NC, EX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  a.m_tiles = (a.M + BT - 1) / BT;
  const dim3 grid(a.m_tiles * batches, (a.N + C::COLS - 1) / C::COLS, a.splits);
  wq_matmul_kernel<P, BT, NC, EX><<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// The instance of the tile (block_t activation rows x block_n weight columns).
template <class P, bool EX>
cudaError_t launch_tile(Args& a, const void* x, const void* w, cudaStream_t st, int batches,
                        int block_t, int block_n) {
  switch (block_t * 1000 + block_n) {
    case 8064: return launch<P, 8, 1, EX>(a, x, w, st, batches);
    case 16064: return launch<P, 16, 1, EX>(a, x, w, st, batches);
    case 32064: return launch<P, 32, 1, EX>(a, x, w, st, batches);
    case 64064: return launch<P, 64, 1, EX>(a, x, w, st, batches);
    case 128128: return launch<P, 128, 2, EX>(a, x, w, st, batches);
    default: return cudaErrorInvalidValue;
  }
}

// The launch contract both entries share.
template <class P>
bool valid(const void* x, const void* w, const void* s, const void* partial,
           const void* counters, int M, int N, int K, int splits, int k_per_split) {
  return M > 0 && N > 0 && K > 0 && K % 8 == 0 && N % 16 == 0 && splits >= 1 &&
         k_per_split > 0 && k_per_split % P::KT == 0 && (splits - 1) * k_per_split < K &&
         aligned16(x) && aligned16(w) && aligned16(s) && (splits == 1 || (partial && counters));
}

// The C entry of both libraries: checks the launch contract, picks the
// template instance by the tile (block_t activation rows x block_n weight
// columns) and launches on `stream`.
template <class P>
int run(const void* x, const void* w, const void* s, void* y, void* partial, void* counters,
        int M, int N, int K, int block_t, int block_n, int splits, int k_per_split,
        void* stream) {
  Args a{};
  a.s = static_cast<const float*>(s);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.M = M, a.N = N, a.K = K, a.k_per_split = k_per_split, a.splits = splits;
  if (!valid<P>(x, w, s, partial, counters, M, N, K, splits, k_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_tile<P, false>(a, x, w, static_cast<cudaStream_t>(stream), 1, block_t, block_n));
}

// The expert-batched entry: y[b] = x[b or all] @ w[index[b] or b] scaled by
// that expert's s, for b < batches; M rows a batch, X = experts.
template <class P>
int run_experts(const void* x, const void* w, const void* s, const int* index, void* y,
                void* partial, void* counters, int batches, int M, int x_batched, int experts,
                int N, int K, int block_t, int block_n, int splits, int k_per_split,
                void* stream) {
  Args a{};
  a.s = static_cast<const float*>(s);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<int*>(counters);
  a.M = M, a.N = N, a.K = K, a.k_per_split = k_per_split, a.splits = splits;
  a.index = index, a.x_batched = x_batched, a.experts = experts;
  if (!valid<P>(x, w, s, partial, counters, M, N, K, splits, k_per_split) || batches <= 0 ||
      experts <= 0 || (!index && batches > experts) ||
      static_cast<long long>((M + 7) / 8) * batches > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_tile<P, true>(a, x, w, static_cast<cudaStream_t>(stream), batches, block_t, block_n));
}

}  // namespace wq
