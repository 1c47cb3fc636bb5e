// Shared by the decode-attention kernels (paged_attention.cu over the page
// pool, dense_attention.cu over the dense slot cache): the block geometry,
// warp reductions and, per cache element type, how a 16-byte K vector dots
// with q and how a lane's D/32 elements of a V row load and convert.
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

}  // namespace
