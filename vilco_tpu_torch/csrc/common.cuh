// Shared helpers for the port's kernels: element loads/stores that convert
// between the storage type (float or bfloat16) and float registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vilco {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte vectors: 4 floats or 8 bfloat16 values.
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_f32<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_f32<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Stage `rows` rows of D bfloat16 values into shared rows of LDQ elements:
// src(r) gives row r's first element in global memory, or nullptr for a row
// to zero-fill; columns D .. DPAD are zero-filled too. 16 bytes a thread
// where `vec` (every row start 16-byte aligned, D a multiple of 8), else one
// element a thread.
template <int DPAD, int LDQ, int THREADS, typename RowSrc>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int rows,
                                           int D, bool vec, RowSrc src) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    constexpr int CH = DPAD / 8;
    for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
      const int r = e / CH, d = (e % CH) * 8;
      const __nv_bfloat16* g = src(r);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g != nullptr && d < D) val = *reinterpret_cast<const uint4*>(g + d);
      *reinterpret_cast<uint4*>(dst + r * LDQ + d) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * DPAD; e += THREADS) {
      const int r = e / DPAD, d = e % DPAD;
      const __nv_bfloat16* g = src(r);
      dst[r * LDQ + d] = (g != nullptr && d < D) ? g[d] : zero;
    }
  }
}

// Word 0 of Philox4x32-10 (Salmon et al., SC'11) for the counter
// (e mod 2^32, e / 2^32, 0, 0) and the key (k0, k1): the attention-dropout
// bits of element e. kernels/xl_attention.py::philox4x32_10 is the same
// function in torch integer arithmetic.
__device__ __forceinline__ uint32_t philox_word0(unsigned long long e,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)e, c1 = (uint32_t)(e >> 32), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Dropout of the attention probabilities: thresh = 0 keeps everything. The
// 64-bit seed is read from device memory (the step draws it on the card),
// its two halves the Philox key; the word after it is the counter's base
// (a data-parallel rank's first global row times the elements of a row).
struct Dropout {
  const unsigned long long* seed;
  uint32_t thresh;
  float inv_keep;   // 1 / (1 - rate)
  __device__ __forceinline__ bool keep(unsigned long long e) const {
    if (thresh == 0u) return true;
    const unsigned long long s = __ldg(seed);
    return philox_word0(e + __ldg(seed + 1), (uint32_t)s,
                        (uint32_t)(s >> 32)) >= thresh;
  }
};

}  // namespace vilco
