// Causal GQA flash attention for prefill: q [B, T, H, D], k/v [B, S, KH, D]
// (bf16, the model's layout) -> o [B, T, H, D].
//
// Replaces: aios_tpu/ops/flash_attention.py, `flash_attention` (the Pallas
// `_flash_kernel`), which walks kv blocks on the TPU's sequential grid axis
// with an online softmax in VMEM scratch.
//
// What bounds it on the H100: the work, 4 * H * D operations per visible
// (query, key) pair under the causal triangle (137 GFLOP for a Mistral layer
// at T = 4096) against a few MB of q/k/v/o, so the tensor cores' rate bounds
// it, not the bytes.
//
// What the design does about it (Hopper, sm_90a):
//
//   * One block per (tile of positions, kv head, batch) serves the whole GQA
//     group: the G = H / KH query heads of its kv head are stacked on the row
//     axis, row r = position * G + head, so each K/V tile is loaded once for
//     G heads. Two consumer warpgroups own 64 rows each (PW = 64 / G
//     positions, the last 64 % G rows of a warpgroup idle and zeroed), so a
//     block shares each K/V tile among 128 query rows.
//   * Copies: one thread of a producer warpgroup issues TMA loads over 4-D
//     tensor maps of the model's own layout ([B, T, H, D] for q, [B, S, KH,
//     D] for k and v, boxes of 64 columns, 128-byte swizzle; no transpose or
//     copy before the launch). K/V tiles of 128 rows pass through a ring of 4
//     (D = 64) or 3 (D = 128) stages on `full` / `empty` mbarriers; TMA's
//     zero fill covers the ragged tail. The maps are encoded per launch
//     (hopper::encode). The producer hands most of its registers to the
//     consumers (setmaxnreg).
//   * Products: S = Q K^T is one wgmma group (m64n128k16, both operands in
//     shared memory, K-major) into fp32 registers. The online softmax runs on
//     the accumulator fragments: a row lives in the four threads of a quad
//     (row max by two shuffles; the row sum stays per thread until the
//     epilogue), and the mask is applied only to tiles that cross the
//     diagonal, the window's edge or the end of k. P goes to bf16 in
//     registers as wgmma's A operand (the accumulator layout of m64nN is the
//     A-fragment layout of the next product), and O += P V reads V as an
//     MN-major operand: the descriptor transposes it, not a copy. O stays in
//     registers until the epilogue; no score or P V tile touches shared
//     memory.
//   * Overlap: the two consumer warpgroups take turns on the tensor cores
//     (named barriers); a turn issues S of tile j right behind P V of tile
//     j - 1, and while one warpgroup runs its softmax the other's products
//     run. At D = 64 the softmax of tile j also overlaps the warpgroup's own
//     P V of tile j - 1.
//   * Order: causal blocks run longest first (the q-tile index reversed).
//
// Arithmetic, the TPU kernel's: scores (q . k) * sm_scale in fp32, -1e30
// where masked with p = 0 explicitly there, p = exp(s - m_new) in fp32
// (the running max is taken over q . k, whose order sm_scale > 0 keeps, and
// p = exp2(q . k * c - m * c) with c = sm_scale * log2(e): one FMA and one
// ex2 per score), the running sum l of fp32 p, P rounded to bf16 for the P V product with an fp32
// accumulator, o = acc / l with l <= 0 -> 1. Tiles the mask kills wholly are
// never loaded.
//
// Launch contract (checked by aios_flash_attention): D = 64 or 128; H % KH ==
// 0 with G = H / KH <= 64; every T >= 1 and S >= 1; q, k, v, o 16-byte
// aligned; B, KH <= 65535.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgs = 2;                 // consumer warpgroups
constexpr int kConsumers = kWgs * kWarpgroup;
constexpr int kThreads = kConsumers + kWarpgroup;  // the consumers, then the producer
// Registers per thread: the launch gives every thread the same share (168
// of 65,536 over 384 threads), and the producer warpgroup hands most of its
// share to the consumers. setmaxnreg.inc waits until the registers are free,
// so the consumers may take no more than the producer gives up: a split the
// launch's share cannot cover hangs the block.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kWarpgroup * kProducerRegs + kConsumers * kConsumerRegs <= kThreads * kLaunchRegs,
              "the consumers take only what the producer frees");
constexpr int kWgRows = 64;             // query rows per consumer warpgroup (wgmma's M)
constexpr int kBKV = 128;               // kv rows per tile (wgmma's N of S)
constexpr int kSpan = 64;               // bf16 columns per 128-byte swizzle span

template <int D>
struct Config {
  static constexpr int SPANS = D / kSpan;                    // TMA boxes per row
  static constexpr int Q_SPAN = kWgRows * 128;               // one warpgroup's rows, one span
  static constexpr int Q_BYTES = kWgs * SPANS * Q_SPAN;
  static constexpr int KV_SPAN = kBKV * 128;                 // one tile's rows, one span
  static constexpr int KV_BYTES = SPANS * KV_SPAN;           // one K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;           // K, then V
  // as many stages (up to 4) as fit beside Q: 4 at D = 64, 3 at D = 128
  static constexpr int FIT = (232448 - 1024 - 64 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
  static_assert(D % kSpan == 0, "whole swizzle spans");
  static_assert(STAGES >= 2 && SMEM <= 232448, "shared memory of one block");
};

struct Args {
  CUtensorMap q_map;  // [B, T, H, D]: boxes of 64 columns x G heads x PW positions
  CUtensorMap k_map;  // [B, S, KH, D]: boxes of 64 columns x 1 head x 128 rows
  CUtensorMap v_map;
  __nv_bfloat16* o;
  int T, S, H, KH, G, PW, causal, window;
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ bool visible(int col, int pos, const Args& a) {
  return col < a.S && (!a.causal || col <= pos) && (a.window <= 0 || col > pos - a.window);
}

// 2^x on the special function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const __grid_constant__ Args a) {
  using C = Config<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t qs = base;                                 // [wg][span] of 64 x 128 bytes
  const uint32_t kvs = qs + C::Q_BYTES;                     // STAGES x (K tile, V tile)
  const uint32_t bars = kvs + STAGES * C::STAGE_BYTES;      // full[STAGES], empty[STAGES], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int tid = threadIdx.x;
  // causal blocks run longest first: the last positions see the most keys
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int used = a.PW * a.G;  // live rows of a warpgroup
  const int t0 = qt * kWgs * a.PW;
  // kv tiles any row of the block can see: the window hides keys older than
  // the first position's window, causality keys newer than the last position
  const int kv_lo = a.window > 0 ? max(0, t0 - a.window + 1) / kBKV * kBKV : 0;
  const int kv_hi = a.causal ? min(a.S, t0 + kWgs * a.PW) : a.S;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kBKV - 1) / kBKV : 0;

  if (used < kWgRows && tid < kConsumers) {
    // the idle rows of each warpgroup read zeros, never stale shared memory
    constexpr int VEC = 128 / 16;
    const int idle = (kWgRows - used) * VEC;
    for (int i = tid; i < kWgs * C::SPANS * idle; i += kConsumers) {
      const uint32_t at = qs + (i / idle) * C::Q_SPAN + used * 128 + (i % idle) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // -- producer warpgroup: one thread issues every copy --------------------
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, kWgs * C::SPANS * used * 128);
#pragma unroll
      for (int w = 0; w < kWgs; ++w)
#pragma unroll
        for (int c = 0; c < C::SPANS; ++c)
          tma_4d(qs + (w * C::SPANS + c) * C::Q_SPAN, &a.q_map, kSpan * c, kh * a.G,
                 t0 + w * a.PW, b, q_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((i / STAGES) + 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t kt = kvs + s * C::STAGE_BYTES;
        const int c0 = kv_lo + i * kBKV;
        mbar_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < C::SPANS; ++c) {
          tma_4d(kt + c * C::KV_SPAN, &a.k_map, kSpan * c, kh, c0, b, full);
          tma_4d(kt + C::KV_BYTES + c * C::KV_SPAN, &a.v_map, kSpan * c, kh, c0, b, full);
        }
      }
    }
    return;
  }

  // -- consumer warpgroups -----------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / kWarpgroup;
  const int warp = (tid % kWarpgroup) / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int tw = t0 + wg * a.PW;  // the warpgroup's first position
  // this thread's rows of the warpgroup: r0 (h = 0) and r0 + 8 (h = 1)
  const int r0 = 16 * warp + lane / 4;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = tw + (r0 + 8 * h) / a.G;
  const uint32_t qa = qs + wg * C::SPANS * C::Q_SPAN;

  float sc[kBKV / 2];            // S, then p, of the newest tile
  float acc[D / 2];              // O
  uint32_t pf[kBKV / 16][4];     // the previous tile's p as bf16 A fragments
  float m[2] = {kNegInf, kNegInf};  // running row max of the raw scores q . k
  float l[2] = {0.f, 0.f};       // this thread's share of the row sums
  float alpha[2] = {1.f, 1.f};   // the rescale of O that the newest tile asks
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // One turn's products, each a group: S = Q K^T of tile j (D / 16 k16
  // steps, when S_NEW) behind O += P V of tile j - 1 (when PV; V [128 kv
  // rows, D] is the MN-major B operand, a k16 step 16 kv rows, the next 64
  // columns a span further). The registers the products read or write are
  // fenced before the first wgmma: a non-wgmma instruction touching them
  // between the wgmmas makes ptxas serialize them. V's descriptors are made
  // between the groups, so that they and K's are never live together.
  auto issue = [&](int j, auto s_new, auto pv) {
    constexpr bool S_NEW = decltype(s_new)::value, PV = decltype(pv)::value;
    fence_regs(pf);
    fence_regs(acc);
    if constexpr (S_NEW) {
      const uint32_t kt = kvs + (j % STAGES) * C::STAGE_BYTES;
      uint64_t da[D / 16], db[D / 16];  // Q (the A operand) and K, both K-major
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        da[k] = desc_k_sw128(qa + (k / 4) * C::Q_SPAN + 32 * (k % 4));
        db[k] = desc_k_sw128(kt + (k / 4) * C::KV_SPAN + 32 * (k % 4));
      }
      fence_regs(da);
      fence_regs(db);
      wgmma_fence();
      // the first step writes S without reading it: sc is dead until then
      WgmmaSS<kBKV>::mma_zero(sc, da[0], db[0]);
#pragma unroll
      for (int k = 1; k < D / 16; ++k) WgmmaSS<kBKV>::mma(sc, da[k], db[k], 1u);
      wgmma_commit();
    } else {
      wgmma_fence();
    }
    if constexpr (PV) {
      const uint32_t vt = kvs + ((j + STAGES - 1) % STAGES) * C::STAGE_BYTES + C::KV_BYTES;
      uint64_t dv[kBKV / 16];
#pragma unroll
      for (int k = 0; k < kBKV / 16; ++k) dv[k] = desc_mn_sw128(vt + k * 2048, C::KV_SPAN);
      fence_regs(dv);
#pragma unroll
      for (int k = 0; k < kBKV / 16; ++k) Wgmma<D, 1>::mma(acc, pf[k], dv[k], 1u);
      wgmma_commit();
    }
  };

  // The online softmax of tile i on its S fragments: p (fp32) replaces S in
  // sc, alpha is the rescale of O, l takes alpha and this thread's p.
  auto softmax = [&](int i) {
    const int c0 = kv_lo + i * kBKV;
    // a tile inside every row's causal and window range and inside k needs
    // no mask
    const bool masked = c0 + kBKV > a.S || (a.causal && c0 + kBKV - 1 > tw) ||
                        (a.window > 0 && c0 <= tw + a.PW - 1 - a.window);
    float mt[2] = {m[0], m[1]};
    if (masked) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(c0 + 8 * j + 2 * t + (e & 1), pos[e / 2], a)) sc[4 * j + e] = kNegInf;
    }
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e / 2] = fmaxf(mt[e / 2], sc[4 * j + e]);
    float mc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      alpha[h] = ex2((m[h] - mt[h]) * a.scale_log2);
      m[h] = mt[h];
      mc[h] = mt[h] * a.scale_log2;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // exp(s * sm_scale - m * sm_scale) as one FMA and one ex2; masked
        // columns get p = 0 explicitly: a row with nothing visible yet has
        // m = -1e30 and would otherwise take exp(0) = 1
        float p = ex2(fmaf(sc[4 * j + e], a.scale_log2, -mc[e / 2]));
        if (masked && sc[4 * j + e] == kNegInf) p = 0.f;
        ps[e / 2] += p;
        sc[4 * j + e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
  };

  // The two consumer warpgroups take turns on the tensor cores (named
  // barriers 1 and 2): while one issues its products the other runs its
  // softmax. Turn j issues S of tile j behind P V of tile j - 1; turn 0 has
  // S alone and turn n_tiles P V alone, so both warpgroups take n_tiles + 1
  // turns, warpgroup 0 first.
  auto turn_begin = [&] { bar_sync(1 + wg, kConsumers); };
  auto turn_end = [&](bool last) {
    if (!(wg == 1 && last)) bar_arrive(2 - wg, kConsumers);  // nobody waits after the last
  };
  // P of the newest tile to bf16 A fragments, O rescaled for it
  auto to_p = [&] {
#pragma unroll
    for (int k = 0; k < kBKV / 16; ++k) {
      pf[k][0] = pack_bf16(sc[8 * k], sc[8 * k + 1]);
      pf[k][1] = pack_bf16(sc[8 * k + 2], sc[8 * k + 3]);
      pf[k][2] = pack_bf16(sc[8 * k + 4], sc[8 * k + 5]);
      pf[k][3] = pack_bf16(sc[8 * k + 6], sc[8 * k + 7]);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }
  };
  using Yes = std::true_type;
  using No = std::false_type;
  mbar_wait(q_bar, 0);
  if (n_tiles > 0) {
    if (wg == 1) bar_arrive(1, kConsumers);
    mbar_wait(bars, 0);
    turn_begin();
    issue(0, Yes{}, No{});
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    for (int j = 1; j < n_tiles; ++j) {
      to_p();
      mbar_wait(bars + 8 * (j % STAGES), (j / STAGES) & 1);
      turn_begin();
      issue(j, Yes{}, Yes{});
      turn_end(false);
      if constexpr (D == 64) {
        wgmma_wait<1>();  // S of tile j has landed; P V of tile j - 1 runs on
        fence_regs(sc);
        softmax(j);
        wgmma_wait<0>();
      } else {
        // 240 registers do not hold S, P and a 128-column O at once (ptxas
        // spilled): P V retires first; the other warpgroup's turn keeps the
        // tensor cores busy meanwhile
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(j);
      }
      fence_regs(acc);
      fence_regs(pf);
      mbar_arrive(bars + 8 * (STAGES + (j - 1) % STAGES));  // done with tile j - 1
    }
    to_p();
    turn_begin();
    issue(n_tiles, No{}, Yes{});
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // -- o = acc / l, straight from the fragments --------------------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + 8 * h;
    if (r >= used || pos[h] >= a.T) continue;
    const float inv = 1.f / (l[h] <= 0.f ? 1.f : l[h]);
    __nv_bfloat16* orow =
        a.o + ((static_cast<size_t>(b) * a.T + pos[h]) * a.H + kh * a.G + r % a.G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
  }
}

template <int D>
int launch(Args& a, const void* q, const void* k, const void* v, int B, cudaStream_t st) {
  using C = Config<D>;
  const cuuint32_t span = kSpan;
  // the maps hold this launch's pointers: encoded per launch, never cached
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)a.H, (cuuint64_t)a.T, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)a.H * D * 2,
                                   (cuuint64_t)a.T * a.H * D * 2};
  const cuuint32_t q_box[4] = {span, (cuuint32_t)a.G, (cuuint32_t)a.PW, 1};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)a.KH, (cuuint64_t)a.S, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)a.KH * D * 2,
                                    (cuuint64_t)a.S * a.KH * D * 2};
  const cuuint32_t kv_box[4] = {span, 1, kBKV, 1};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode<4>(&a.q_map, bf16, q, q_dims, q_strides, q_box, sw) ||
      !encode<4>(&a.k_map, bf16, k, kv_dims, kv_strides, kv_box, sw) ||
      !encode<4>(&a.v_map, bf16, v, kv_dims, kv_strides, kv_box, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const dim3 grid((a.T + kWgs * a.PW - 1) / (kWgs * a.PW), a.KH, B);
  flash_kernel<D><<<grid, kThreads, C::SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no sliding window. D must be 64 or 128 and H / KH at
// most 64.
extern "C" int aios_flash_attention(const void* q, const void* k, const void* v,
                                    void* o, int B, int T, int S, int H, int KH,
                                    int D, int causal, int window,
                                    float sm_scale, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > kWgRows ||
      B > 65535 || KH > 65535 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.o = static_cast<__nv_bfloat16*>(o);
  a.T = T, a.S = S, a.H = H, a.KH = KH, a.G = H / KH, a.PW = kWgRows / a.G;
  a.causal = causal, a.window = window;
  a.scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(a, q, k, v, B, st);
    case 128:
      return launch<128>(a, q, k, v, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
