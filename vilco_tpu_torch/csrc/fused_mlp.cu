// Fused transformer MLP, forward: out = gelu_tanh(x W1 + b1) W2 + b2.
//
// Replaces vilco_tpu/kernels/mlp.py::fused_mlp (the Pallas _mlp_kernel run
// by _run). x (N, C), W1 (C, Hd), b1 (Hd,), W2 (Hd, C), b2 (C,), all in x's
// dtype (the wrapper rounds the f32 master weights and biases to it, as the
// Pallas call does); products accumulate in f32, the GELU runs in f32 and
// its result is rounded to x's dtype before the second product, as in the
// TPU kernel. Row offsets are 64-bit: N * Hd is 7.6e8 at a VQ serving
// request's clip call (240 frames of 1025 tokens) and 1.5e9 with a
// 16-window chunk, close to 2^31.
//
// What bounds it on the card: operations. At the ViT-B shape (C = 768,
// Hd = 3072) each token costs 4 C Hd = 9.4 MFLOP against 4 C bytes in and
// out, far above the ~295 operations a byte where Hopper's bf16 tensor
// cores become the limit. The unfused form also writes and reads the
// (N, Hd) intermediate twice (4x the bytes of x); this kernel keeps it on
// chip: a block owns a tile of token rows and walks the hidden units in
// chunks of HC = 128:
//   S  = X_tile W1[:, chunk]          (tensor cores, f32 in shared memory)
//   Hc = bf16(gelu(S + b1[chunk]))    (shared memory)
//   O += Hc W2[chunk, :]              (tensor cores, f32 O in shared memory)
// and writes bf16(O + b2) once. bfloat16: TS = 32 rows, 8 warps, WMMA
// 16x16x16 with the X tile and Hc in shared memory and the W1 / W2
// fragments read straight from device memory (L2-resident: 9.4 MB at
// ViT-B). Every block reads all of W1 and W2 once, (N / 32) x 9.4 MB of L2
// traffic in all; larger tiles (wgmma, TMA-staged weights) are later work.
// float32 (the parity path): TS = 16 rows, SIMT FMAs.

#include <mma.h>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int HC = 128;           // hidden units per chunk
constexpr int THREADS = 256;      // 8 warps
constexpr int TS = 32;            // token rows per block, bfloat16
constexpr int TS32 = 16;          // token rows per block, float32
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared-memory layout of the bfloat16 kernel for width C: the X tile
// (bf16, rows of C + 8), the f32 chunk scratch S (rows of HC + 4), the bf16
// GELU chunk Hc (rows of HC + 8), the f32 accumulator O (rows of C + 4).
struct TcLayout {
  int ldx, lds, ldh, ldo;
  size_t s_off, h_off, o_off, bytes;
  __host__ __device__ explicit TcLayout(int C)
      : ldx(C + 8), lds(HC + 4), ldh(HC + 8), ldo(C + 4) {
    s_off = align128((size_t)TS * ldx * 2);
    h_off = s_off + align128((size_t)TS * lds * 4);
    o_off = h_off + align128((size_t)TS * ldh * 2);
    bytes = o_off + (size_t)TS * ldo * 4;
  }
};

__global__ void __launch_bounds__(THREADS)
mlp_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ b2, bf16* __restrict__ out, int N,
              int C, int Hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout lay(C);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* ss = reinterpret_cast<float*>(smem + lay.s_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.h_off);
  float* os = reinterpret_cast<float*>(smem + lay.o_off);

  const long long r0 = (long long)blockIdx.x * TS;
  const int nr = (int)min((long long)TS, (long long)N - r0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < TS * C; e += THREADS) {
    const int r = e / C, c = e % C;
    xs[r * lay.ldx + c] = r < nr ? x[(r0 + r) * C + c] : zero;
    os[r * lay.ldo + c] = 0.f;
  }
  __syncthreads();

  const int ncb_out = C / 16;
  for (int h0 = 0; h0 < Hd; h0 += HC) {
    const int ncb = min(HC, Hd - h0) / 16;
    // S (TS x chunk) = X W1[:, chunk], fragments (row block, column block)
    for (int f = warp; f < (TS / 16) * ncb; f += THREADS / 32) {
      const int rb = f / ncb, cb = f % ncb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + rb * 16 * lay.ldx + kk * 16, lay.ldx);
        wmma::load_matrix_sync(b, w1 + (long long)kk * 16 * Hd + h0 + cb * 16,
                               Hd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + rb * 16 * lay.lds + cb * 16, acc, lay.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    const int hc = ncb * 16;
    for (int e = tid; e < TS * hc; e += THREADS) {
      const int r = e / hc, c = e % hc;
      const float t = ss[r * lay.lds + c] + __bfloat162float(b1[h0 + c]);
      hs[r * lay.ldh + c] = __float2bfloat16(gelu_tanh(t));
    }
    __syncthreads();
    // O (TS x C) += Hc W2[chunk, :]
    for (int f = warp; f < (TS / 16) * ncb_out; f += THREADS / 32) {
      const int rb = f / ncb_out, cb = f % ncb_out;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* op = os + rb * 16 * lay.ldo + cb * 16;
      wmma::load_matrix_sync(acc, op, lay.ldo, wmma::mem_row_major);
      for (int kk = 0; kk < ncb; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, hs + rb * 16 * lay.ldh + kk * 16, lay.ldh);
        wmma::load_matrix_sync(
            b, w2 + (long long)(h0 + kk * 16) * C + cb * 16, C);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(op, acc, lay.ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = tid; e < nr * C; e += THREADS) {
    const int r = e / C, c = e % C;
    out[(r0 + r) * C + c] =
        __float2bfloat16(os[r * lay.ldo + c] + __bfloat162float(b2[c]));
  }
}

size_t simt_smem_bytes(int C) {
  return sizeof(float) * ((size_t)2 * TS32 * C + (size_t)TS32 * HC);
}

__global__ void __launch_bounds__(THREADS)
mlp_simt_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int N,
                int C, int Hd) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                 // [TS32][C]
  float* hs = xs + TS32 * C;       // [TS32][HC]
  float* os = hs + TS32 * HC;      // [TS32][C]
  constexpr int RG = TS32 / (THREADS / HC);   // rows per thread, phase 1

  const long long r0 = (long long)blockIdx.x * TS32;
  const int nr = (int)min((long long)TS32, (long long)N - r0);
  const int tid = threadIdx.x;
  for (int e = tid; e < TS32 * C; e += THREADS) {
    const int r = e / C, c = e % C;
    xs[e] = r < nr ? x[(r0 + r) * C + c] : 0.f;
    os[e] = 0.f;
  }
  __syncthreads();

  for (int h0 = 0; h0 < Hd; h0 += HC) {
    const int hc = min(HC, Hd - h0);
    // Hc = gelu(X W1[:, chunk] + b1): column tid % HC, rows RG * (tid / HC)
    const int col = tid % HC, rg = (tid / HC) * RG;
    if (col < hc) {
      float acc[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = 0.f;
      for (int k = 0; k < C; ++k) {
        const float wv = w1[(long long)k * Hd + h0 + col];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          acc[r] = fmaf(xs[(rg + r) * C + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
        hs[(rg + r) * HC + col] = gelu_tanh(acc[r] + b1[h0 + col]);
    }
    __syncthreads();
    // O += Hc W2[chunk, :]: column c, all TS32 rows
    for (int c = tid; c < C; c += THREADS) {
      float acc[TS32];
#pragma unroll
      for (int r = 0; r < TS32; ++r) acc[r] = 0.f;
      for (int k = 0; k < hc; ++k) {
        const float wv = w2[(long long)(h0 + k) * C + c];
#pragma unroll
        for (int r = 0; r < TS32; ++r)
          acc[r] = fmaf(hs[r * HC + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < TS32; ++r) os[r * C + c] += acc[r];
    }
    __syncthreads();
  }

  for (int e = tid; e < nr * C; e += THREADS) {
    const int r = e / C, c = e % C;
    out[(r0 + r) * C + c] = os[e] + b2[c];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; every tensor in that dtype and
// contiguous: x, out (N, C), w1 (C, Hd), b1 (Hd,), w2 (Hd, C), b2 (C,).
// bfloat16 needs C and Hd multiples of 16, C <= 1072 and w1, w2 32-byte
// aligned; float32 C <= 1750.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int N,
                             int C, int Hd, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || C < 1 || Hd < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const TcLayout lay(C);
    if (C % 16 || Hd % 16 || lay.bytes > SMEM_MAX ||
        (((uintptr_t)w1 | (uintptr_t)w2) % 32) != 0)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        mlp_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lay.bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((N + TS - 1) / TS);
    mlp_tc_kernel<<<blocks, THREADS, lay.bytes, s>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
        (const bf16*)b2, (bf16*)out, N, C, Hd);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t bytes = simt_smem_bytes(C);
    if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        mlp_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((N + TS32 - 1) / TS32);
    mlp_simt_kernel<<<blocks, THREADS, bytes, s>>>(
        (const float*)x, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, N, C, Hd);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
