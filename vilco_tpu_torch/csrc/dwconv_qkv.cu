// Fused depthwise q/k/v convolution (K=3, zero padding 1), forward and
// backward.
//
// Replaces vilco_tpu/kernels/dwconv.py::fused_dwconv_qkv and
// fused_dwconv_qkv_s2 (the Pallas _run_fwd / _run_fwd_s2 and _run_bwd /
// _run_bwd_s2 kernels):
//
//   out_j[t] = x[s*t-1] w[j,0] + x[s*t] w[j,1] + x[s*t+1] w[j,2],  j = q, k, v
//
// for stride s in {1, 2}, with x[-1] = x[T] = 0. The three outputs come from
// one read of x. Bound on the card by memory traffic (9 FMAs per element
// read, 3 elements written per element read at s=1), so each thread moves
// 16 bytes along C per load and store, and the three taps of one output row
// are reread from L1/L2 by the neighbouring rows. The TPU's even/odd split
// for stride 2 is not needed: a thread reads x at 2t-1, 2t, 2t+1 directly.
// The mask multiply stays outside, as in the JAX model.
//
// Backward, one stride argument for both strides:
//   dx[t]     = sum_j sum_{tap: (t + 1 - tap) = s u, 0 <= u < T_out}
//               dy_j[u] w[j, tap]     (the transpose conv; at s = 2 row t
//               receives from u = t/2 (tap 1) or u = (t+1)/2 and (t-1)/2)
//   dw[j,tap] = sum_{b,u} x[s u - 1 + tap] dy_j[u]   (f32)
// dx is one pass, 16 bytes along C per thread, like the forward. dw sums
// over batch and time: a first launch writes per-(batch, 64-row chunk)
// partials in f32 (9 sums per channel per thread, in registers), a second
// launch adds the partials in a fixed order and stores dw in w's dtype, so
// dw is deterministic. Bound by memory traffic: x and the three dy are
// read twice (once per pass).

#include "common.cuh"

using vilco::Vec16;

template <typename T>
__global__ void dwconv_qkv_kernel(const T* __restrict__ x,
                                  const T* __restrict__ w,
                                  T* __restrict__ q, T* __restrict__ k,
                                  T* __restrict__ v, int B, int T_in,
                                  int T_out, int C, int stride) {
  constexpr int N = Vec16<T>::N;
  const int nvec = C / N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * T_out * nvec;
  if (idx >= total) return;
  const int c0 = (int)(idx % nvec) * N;
  const long long bt = idx / nvec;
  const int t = (int)(bt % T_out);
  const int b = (int)(bt / T_out);

  float xs[3][N];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const int ti = t * stride - 1 + tap;
    if (ti >= 0 && ti < T_in) {
      vilco::load16<T>(x + ((long long)b * T_in + ti) * C + c0, xs[tap]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) xs[tap][i] = 0.f;
    }
  }
  T* outs[3] = {q, k, v};
  const long long o = ((long long)b * T_out + t) * C + c0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      float wv[N];
      vilco::load16<T>(w + (j * 3 + tap) * C + c0, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = fmaf(xs[tap][i], wv[i], acc[i]);
    }
    vilco::store16<T>(outs[j] + o, acc);
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* w, void* q, void* k,
                          void* v, int B, int T_in, int T_out, int C,
                          int stride, cudaStream_t stream) {
  const long long total = (long long)B * T_out * (C / Vec16<T>::N);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    dwconv_qkv_kernel<T><<<blocks, threads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)q, (T*)k, (T*)v, B, T_in, T_out, C,
        stride);
  }
  return cudaGetLastError();
}


constexpr int DW_ROWS = 64;   // output rows per dw partial

template <typename T>
__global__ void dwconv_qkv_dx_kernel(const T* __restrict__ w,
                                     const T* __restrict__ dq,
                                     const T* __restrict__ dk,
                                     const T* __restrict__ dv,
                                     T* __restrict__ dx, int B, int T_in,
                                     int T_out, int C, int stride) {
  constexpr int N = Vec16<T>::N;
  const int nvec = C / N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * T_in * nvec) return;
  const int c0 = (int)(idx % nvec) * N;
  const long long bt = idx / nvec;
  const int t = (int)(bt % T_in);
  const int b = (int)(bt / T_in);
  const T* dys[3] = {dq, dk, dv};
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const int num = t + 1 - tap;
    if (num < 0 || num % stride) continue;
    const int u = num / stride;
    if (u >= T_out) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float dy[N], wv[N];
      vilco::load16<T>(dys[j] + ((long long)b * T_out + u) * C + c0, dy);
      vilco::load16<T>(w + (j * 3 + tap) * C + c0, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = fmaf(dy[i], wv[i], acc[i]);
    }
  }
  vilco::store16<T>(dx + ((long long)b * T_in + t) * C + c0, acc);
}

// partial[chunk, j*3 + tap, c] over the DW_ROWS output rows of one chunk
template <typename T>
__global__ void dwconv_qkv_dw_partial_kernel(const T* __restrict__ x,
                                             const T* __restrict__ dq,
                                             const T* __restrict__ dk,
                                             const T* __restrict__ dv,
                                             float* __restrict__ partial,
                                             int B, int T_in, int T_out,
                                             int C, int stride) {
  constexpr int N = Vec16<T>::N;
  const int nvec = C / N;
  const int chunks_per_b = (T_out + DW_ROWS - 1) / DW_ROWS;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * chunks_per_b * nvec) return;
  const int c0 = (int)(idx % nvec) * N;
  const int chunk = (int)(idx / nvec);
  const int b = chunk / chunks_per_b;
  const int u0 = (chunk % chunks_per_b) * DW_ROWS;
  const int u1 = min(u0 + DW_ROWS, T_out);
  const T* dys[3] = {dq, dk, dv};
  float acc[9][N];
#pragma unroll
  for (int e = 0; e < 9; ++e)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[e][i] = 0.f;
  for (int u = u0; u < u1; ++u) {
    float xs[3][N];
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      const int ti = u * stride - 1 + tap;
      if (ti >= 0 && ti < T_in) {
        vilco::load16<T>(x + ((long long)b * T_in + ti) * C + c0, xs[tap]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) xs[tap][i] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float dy[N];
      vilco::load16<T>(dys[j] + ((long long)b * T_out + u) * C + c0, dy);
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc[j * 3 + tap][i] = fmaf(xs[tap][i], dy[i], acc[j * 3 + tap][i]);
    }
  }
  float* pp = partial + (long long)chunk * 9 * C + c0;
#pragma unroll
  for (int e = 0; e < 9; ++e)
#pragma unroll
    for (int i = 0; i < N; ++i) pp[(long long)e * C + i] = acc[e][i];
}

template <typename T>
__global__ void dwconv_qkv_dw_reduce_kernel(const float* __restrict__ partial,
                                            T* __restrict__ dw, int chunks,
                                            int C) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 9 * C) return;
  float acc = 0.f;
  for (int ch = 0; ch < chunks; ++ch) acc += partial[(long long)ch * 9 * C + e];
  dw[e] = vilco::from_f32<T>(acc);
}

template <typename T>
static cudaError_t launch_bwd(const void* x, const void* w, const void* dq,
                              const void* dk, const void* dv, void* dx,
                              void* dw, void* partial, int B, int T_in,
                              int T_out, int C, int stride,
                              cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const int threads = 256;
  const long long n_dx = (long long)B * T_in * (C / N);
  dwconv_qkv_dx_kernel<T><<<(unsigned)((n_dx + threads - 1) / threads),
                            threads, 0, stream>>>(
      (const T*)w, (const T*)dq, (const T*)dk, (const T*)dv, (T*)dx, B,
      T_in, T_out, C, stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int chunks = B * ((T_out + DW_ROWS - 1) / DW_ROWS);
  const long long n_dw = (long long)chunks * (C / N);
  dwconv_qkv_dw_partial_kernel<T><<<(unsigned)((n_dw + threads - 1) / threads),
                                    threads, 0, stream>>>(
      (const T*)x, (const T*)dq, (const T*)dk, (const T*)dv,
      (float*)partial, B, T_in, T_out, C, stride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dwconv_qkv_dw_reduce_kernel<T><<<(9 * C + threads - 1) / threads, threads,
                                   0, stream>>>((const float*)partial,
                                                (T*)dw, chunks, C);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. x (B, T_in, C), w (3, 3, C),
// q/k/v (B, T_out, C), all contiguous and 16-byte aligned, C a multiple of
// 16 / sizeof(element).
extern "C" int dwconv_qkv_fwd(const void* x, const void* w, void* q, void* k,
                              void* v, int B, int T_in, int T_out, int C,
                              int stride, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(x, w, q, k, v, B, T_in, T_out, C, stride, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, q, k, v, B, T_in, T_out, C, stride, s);
  return (int)cudaErrorInvalidValue;
}

// Backward. x/dx (B, T_in, C), w/dw (3, 3, C), dq/dk/dv (B, T_out, C) in
// dtype; partial (B * ceil(T_out / 64), 9, C) f32 scratch; all contiguous
// and 16-byte aligned, C a multiple of 16 / sizeof(element).
extern "C" int dwconv_qkv_bwd(const void* x, const void* w, const void* dq,
                              const void* dk, const void* dv, void* dx,
                              void* dw, void* partial, int B, int T_in,
                              int T_out, int C, int stride, int dtype,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || T_in < 1 || T_out < 1 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_bwd<float>(x, w, dq, dk, dv, dx, dw, partial, B, T_in, T_out, C, stride, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, w, dq, dk, dv, dx, dw, partial, B, T_in, T_out, C, stride, s);
  return (int)cudaErrorInvalidValue;
}
