// Fused depthwise q/k/v convolution (K=3, zero padding 1), forward and
// backward.
//
// Replaces vilco_tpu/kernels/dwconv.py::fused_dwconv_qkv and
// fused_dwconv_qkv_s2 (the Pallas _run_fwd / _run_fwd_s2 and _run_bwd /
// _run_bwd_s2 kernels):
//
//   out_j[u]  = x[s u - 1] w[j,0] + x[s u] w[j,1] + x[s u + 1] w[j,2]
//   dx[t]     = sum over (u, tap) with s u - 1 + tap = t of
//               sum_j dy_j[u] w[j, tap]              (the transpose conv)
//   dw[j,tap] = sum_{b,u} x[s u - 1 + tap] dy_j[u]   (f32 sums)
//
// for stride s in {1, 2}, j = q, k, v, with x and dy zero outside their
// rows. Bound on the card by memory traffic: 9 multiply-adds a channel per
// output row against 2 to 5 bytes moved.
//
// Both kernels walk rows. A thread owns CH = 4 channels (8 bytes of bf16,
// 16 of f32) and takes `rows` consecutive output rows of one batch element:
// it holds w's 9 taps in f32 registers, loaded once, and a window of x rows,
// each new row loaded once (at stride 2 two rows an output row and one
// carried over: the TPU's even/odd split, done in registers). A step issues
// all its row loads before the first is used. A block is vx channel columns
// by THREADS / vx walkers on consecutive row tiles, so the halo a tile
// shares with the next is read again from L1 or L2; x comes from DRAM
// once. kernels/dwconv.py::Plan is this cut in Python: the wrapper picks
// `rows` and vx there and sizes the dw partials from them.
//
// The forward walks 8 rows a step (16 x rows in flight at stride 2) and
// takes 8 rows a walker, fewer where that leaves SMs without a block, in
// blocks of up to 32 columns, so a warp reads and writes 256 bytes of a
// row at once: the most blocks for the card to balance, since the forward
// adds nothing across blocks.
//
// The backward is one launch. The same walk holds x at the taps of the
// current dy row and scatters each dy row into three running dx rows, dx
// rows written as they complete (a dx row sums its terms by dy row, then by
// j); a walker also reads the dy rows just outside its tile, for the dx
// rows at its edges, and adds them to no dw sum. Each walker sums its 9 dw
// taps over its rows in f32 registers (2 rows a step, 1 in f32; at most 128
// registers, so an SM holds BWD_BLOCKS blocks); a block adds its walkers in
// a fixed order (a butterfly of shuffles within a warp, then warp by warp
// through shared memory) into one f32 partial; the last block of each
// channel group to finish, found by a ticket counter (the call's own,
// zeroed by the wrapper with the partials' scratch), adds the group's partials (slices of row blocks, eight 16-byte loads in
// flight a thread, then the slices in order) and stores dw in w's dtype.
// The wrapper takes the shortest walk whose grid fits in one wave, so every
// block runs at once and the partials are few. No floating-point atomics:
// dx and dw are the same bits on every call. x and the three dy go through
// DRAM once.

#include "common.cuh"

namespace {

constexpr int CH = 4;           // channels a thread owns
constexpr int THREADS = 256;    // threads a block (kernels/dwconv.py: THREADS)
constexpr int VX_MAX = 8;       // channel columns a backward block, at most
constexpr int FWD_VX_MAX = 32;  // channel columns a forward block, at most
constexpr int BWD_BLOCKS = 2;   // backward blocks an SM holds (<= 128 registers)

// CH elements of T as one 8- or 16-byte load, unpacked to f32.
template <typename T> struct Quad;
template <> struct Quad<float> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    return make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                      *reinterpret_cast<uint32_t*>(&hi));
  }
};

// Row `row` of a (rows, C) slice at `base` (already offset to the thread's
// channels), or zeros where the row lies outside [lo, hi).
template <typename T>
__device__ __forceinline__ typename Quad<T>::Raw load_row(const T* base,
                                                          int row, int lo,
                                                          int hi, int C) {
  typename Quad<T>::Raw r{};
  if (row >= lo && row < hi)
    r = *reinterpret_cast<const typename Quad<T>::Raw*>(base +
                                                        (long long)row * C);
  return r;
}

template <typename T>
__device__ __forceinline__ void store_row(T* base, int row, int C,
                                          const float* f) {
  *reinterpret_cast<typename Quad<T>::Raw*>(base + (long long)row * C) =
      Quad<T>::pack(f);
}

// A thread's place in the plan: its channel column and its walker's batch
// element and output rows [u0, u1); `active` is false for the spare walkers
// of the last row block.
struct Walk {
  int col, b, u0, u1;
  bool active;
};

__device__ __forceinline__ Walk walk_of(int B, int T_out, int rows, int vx,
                                        int groups) {
  const int tx = threadIdx.x % vx, ty = threadIdx.x / vx;
  const int g = blockIdx.x % groups, rb = blockIdx.x / groups;
  const int tiles = (T_out + rows - 1) / rows;
  const int slot = rb * (THREADS / vx) + ty;
  Walk w;
  w.col = g * vx + tx;
  w.b = slot / tiles;
  w.u0 = (slot % tiles) * rows;
  w.u1 = min(w.u0 + rows, T_out);
  w.active = w.b < B;
  return w;
}

template <typename T>
__device__ __forceinline__ void load_w(const T* w, int C, int c0,
                                       float (&wf)[9][CH]) {
#pragma unroll
  for (int e = 0; e < 9; ++e)
    Quad<T>::unpack(*reinterpret_cast<const typename Quad<T>::Raw*>(
                        w + e * C + c0), wf[e]);
}

// Forward. U output rows a step; the x window holds rows s u - 1 + k,
// k < K + S U, K = 3 - S of them carried from the step before.
template <typename T, int S, int U>
__global__ void __launch_bounds__(THREADS)
dwconv_qkv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ q, T* __restrict__ k,
                      T* __restrict__ v, int B, int T_in, int T_out, int C,
                      int rows, int vx, int groups) {
  using Q = Quad<T>;
  constexpr int K = 3 - S, NB = K + S * U;
  const Walk wk = walk_of(B, T_out, rows, vx, groups);
  if (!wk.active) return;
  const int c0 = wk.col * CH;
  float wf[9][CH];
  load_w(w, C, c0, wf);
  const T* xb = x + (long long)wk.b * T_in * C + c0;
  const long long ob = (long long)wk.b * T_out * C + c0;
  T* outs[3] = {q + ob, k + ob, v + ob};
  const int xlo = max(0, S * wk.u0 - 1);
  const int xhi = min(T_in, S * (wk.u1 - 1) + 2);
  typename Q::Raw buf[NB];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    buf[kk] = load_row(xb, S * wk.u0 - 1 + kk, xlo, xhi, C);
  for (int u = wk.u0; u < wk.u1; u += U) {
#pragma unroll
    for (int m = 0; m < S * U; ++m)
      buf[K + m] = load_row(xb, S * u - 1 + K + m, xlo, xhi, C);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (u + i >= wk.u1) break;
      float xs[3][CH];
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) Q::unpack(buf[S * i + tap], xs[tap]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float acc[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] = 0.f;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
#pragma unroll
          for (int c = 0; c < CH; ++c)
            acc[c] = fmaf(xs[tap][c], wf[j * 3 + tap][c], acc[c]);
        store_row(outs[j], u + i, C, acc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < K; ++kk) buf[kk] = buf[S * U + kk];
  }
}

// Backward: dx, the dw partials, and dw from the last block of each channel
// group. A walker takes dy rows ua .. u1 (ua = u0 - 1 at stride 1, u0 at
// stride 2), U a step; dy row r adds to dx rows s r - 1 + tap, and dA holds
// those three rows until they complete (S of them a dy row).
template <typename T, int S, int U>
__global__ void __launch_bounds__(THREADS, BWD_BLOCKS)
dwconv_qkv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ dq, const T* __restrict__ dk,
                      const T* __restrict__ dv, T* __restrict__ dx,
                      T* __restrict__ dw, float* __restrict__ partial,
                      int* __restrict__ tickets, int B, int T_in, int T_out,
                      int C, int rows, int vx, int groups, int row_blocks) {
  using Q = Quad<T>;
  constexpr int K = 3 - S, NB = K + S * U;
  const Walk wk = walk_of(B, T_out, rows, vx, groups);
  const int c0 = wk.col * CH;
  float acc[9][CH];
#pragma unroll
  for (int e = 0; e < 9; ++e)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[e][c] = 0.f;

  if (wk.active) {
    float wf[9][CH];
    load_w(w, C, c0, wf);
    const T* xb = x + (long long)wk.b * T_in * C + c0;
    T* dxb = dx + (long long)wk.b * T_in * C + c0;
    const long long yo = (long long)wk.b * T_out * C + c0;
    const T* dyb[3] = {dq + yo, dk + yo, dv + yo};
    const int ua = wk.u0 - (S == 1 ? 1 : 0);
    const int xlo = max(0, S * wk.u0 - 1);
    const int xhi = min(T_in, S * (wk.u1 - 1) + 2);
    const int ylo = max(0, ua), yhi = min(T_out, wk.u1 + 1);
    const int dlo = S * wk.u0, dhi = min(S * wk.u1, T_in);
    typename Q::Raw xbuf[NB];
    typename Q::Raw ybuf[3][U];
    float dA[3][CH];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int c = 0; c < CH; ++c) dA[t][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      xbuf[kk] = load_row(xb, S * ua - 1 + kk, xlo, xhi, C);
    for (int ud = ua; ud <= wk.u1; ud += U) {
#pragma unroll
      for (int m = 0; m < S * U; ++m)
        xbuf[K + m] = load_row(xb, S * ud - 1 + K + m, xlo, xhi, C);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < U; ++i)
          ybuf[j][i] = load_row(dyb[j], ud + i, ylo, yhi, C);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int r = ud + i;
        if (r > wk.u1) break;
        float dy[3][CH];
#pragma unroll
        for (int j = 0; j < 3; ++j) Q::unpack(ybuf[j][i], dy[j]);
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int c = 0; c < CH; ++c)
              dA[tap][c] = fmaf(dy[j][c], wf[j * 3 + tap][c], dA[tap][c]);
        if (r >= wk.u0 && r < wk.u1) {
          float xs[3][CH];
#pragma unroll
          for (int tap = 0; tap < 3; ++tap)
            Q::unpack(xbuf[S * i + tap], xs[tap]);
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int tap = 0; tap < 3; ++tap)
#pragma unroll
              for (int c = 0; c < CH; ++c)
                acc[j * 3 + tap][c] =
                    fmaf(xs[tap][c], dy[j][c], acc[j * 3 + tap][c]);
        }
        // dx rows s r - 1 .. s r + S - 2 have all their terms
#pragma unroll
        for (int m = 0; m < S; ++m) {
          const int t = S * r - 1 + m;
          if (t >= dlo && t < dhi) store_row(dxb, t, C, dA[m]);
        }
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int c = 0; c < CH; ++c)
            dA[t][c] = t + S < 3 ? dA[t + S][c] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) xbuf[kk] = xbuf[S * U + kk];
    }
  }

  // The block's dw partial: a butterfly over the walkers of a warp (the
  // lanes of one channel column, vx apart), then the warps in order.
  __shared__ __align__(16) float red[THREADS / 32][9][VX_MAX * CH];
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < 9; ++e)
#pragma unroll
    for (int c = 0; c < CH; ++c)
      for (int off = vx; off < 32; off <<= 1)
        acc[e][c] += __shfl_xor_sync(0xffffffffu, acc[e][c], off);
  if (lane < vx) {
#pragma unroll
    for (int e = 0; e < 9; ++e)
#pragma unroll
      for (int c = 0; c < CH; ++c) red[warp][e][lane * CH + c] = acc[e][c];
  }
  __syncthreads();
  const int g = blockIdx.x % groups, rb = blockIdx.x / groups;
  const int width = vx * CH, gc = g * width;
  for (int o = threadIdx.x; o < 9 * width; o += THREADS) {
    const int e = o / width, c = o % width;
    float s = red[0][e][c];
#pragma unroll
    for (int wp = 1; wp < THREADS / 32; ++wp) s += red[wp][e][c];
    partial[((long long)rb * 9 + e) * C + gc + c] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[g], 1) == row_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 9 vx quads of CH channels; slice sl of a quad adds row blocks sl,
  // sl + slices, ... in order, eight loads in flight, then the slices are
  // added in order
  const int nq = 9 * vx, slices = THREADS / nq;
  const int q = threadIdx.x % nq, sl = threadIdx.x / nq;
  const int e = q / vx, cq = (q % vx) * CH;
  float4* red4 = reinterpret_cast<float4*>(&red[0][0][0]);
  if (sl < slices) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* pp = partial + (long long)e * C + gc + cq;
    for (int r0 = sl; r0 < row_blocks; r0 += 8 * slices) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + k * slices;
        v[k] = r < row_blocks
            ? __ldcg(reinterpret_cast<const float4*>(pp + (long long)r * 9 * C))
            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (r0 + k * slices < row_blocks) {
          s.x += v[k].x; s.y += v[k].y; s.z += v[k].z; s.w += v[k].w;
        }
      }
    }
    red4[sl * nq + q] = s;
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float4 s = red4[q];
    for (int k = 1; k < slices; ++k) {
      const float4 v = red4[k * nq + q];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const float f[CH] = {s.x, s.y, s.z, s.w};
    store_row(dw + gc + cq, e, C, f);
  }
}

template <typename T, int S>
cudaError_t launch_fwd(const void* x, const void* w, void* q, void* k,
                       void* v, int B, int T_in, int T_out, int C, int rows,
                       int vx, int groups, int blocks, cudaStream_t stream) {
  dwconv_qkv_fwd_kernel<T, S, 8>
      <<<blocks, THREADS, 0, stream>>>((const T*)x, (const T*)w, (T*)q,
                                       (T*)k, (T*)v, B, T_in, T_out, C, rows,
                                       vx, groups);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_bwd(const void* x, const void* w, const void* dq,
                       const void* dk, const void* dv, void* dx, void* dw,
                       void* partial, void* tickets, int B, int T_in,
                       int T_out, int C, int rows, int vx, int groups,
                       int row_blocks, cudaStream_t stream) {
  dwconv_qkv_bwd_kernel<T, S, sizeof(T) == 2 ? 2 : 1>
      <<<groups * row_blocks, THREADS, 0, stream>>>(
          (const T*)x, (const T*)w, (const T*)dq, (const T*)dk,
          (const T*)dv, (T*)dx, (T*)dw, (float*)partial, (int*)tickets, B,
          T_in, T_out, C, rows, vx, groups, row_blocks);
  return cudaGetLastError();
}

// The plan's numbers, checked against each other: `rows` a divisor or a
// multiple of 8, vx a power of two up to vx_max dividing C / CH, and enough
// row blocks of THREADS / vx walkers for every row tile.
bool plan_ok(int B, int T_in, int T_out, int C, int stride, int rows, int vx,
             int vx_max, int row_blocks) {
  if (B < 1 || T_in < 1 || (stride != 1 && stride != 2) ||
      T_out != (T_in - 1) / stride + 1 || rows < 1 ||
      (rows > 8 ? rows % 8 : 8 % rows) ||
      vx < 1 || vx > vx_max || (vx & (vx - 1)) || C % (CH * vx))
    return false;
  const long long tiles = (T_out + rows - 1) / rows;
  return (long long)row_blocks * (THREADS / vx) >= (long long)B * tiles &&
         (long long)(row_blocks - 1) * (THREADS / vx) < (long long)B * tiles;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (B, T_in, C), w (3, 3, C),
// q/k/v (B, T_out, C), all contiguous and 16-byte aligned, C a multiple of
// 16 / sizeof(element); rows, vx and row_blocks from kernels/dwconv.py::plan.
extern "C" int dwconv_qkv_fwd(const void* x, const void* w, void* q, void* k,
                              void* v, int B, int T_in, int T_out, int C,
                              int stride, int rows, int vx, int row_blocks,
                              int dtype, void* stream) {
  if (!plan_ok(B, T_in, T_out, C, stride, rows, vx, FWD_VX_MAX, row_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = C / CH / vx, blocks = groups * row_blocks;
  if (dtype == 0)
    return stride == 1
        ? (int)launch_fwd<float, 1>(x, w, q, k, v, B, T_in, T_out, C, rows, vx, groups, blocks, s)
        : (int)launch_fwd<float, 2>(x, w, q, k, v, B, T_in, T_out, C, rows, vx, groups, blocks, s);
  if (dtype == 1)
    return stride == 1
        ? (int)launch_fwd<__nv_bfloat16, 1>(x, w, q, k, v, B, T_in, T_out, C, rows, vx, groups, blocks, s)
        : (int)launch_fwd<__nv_bfloat16, 2>(x, w, q, k, v, B, T_in, T_out, C, rows, vx, groups, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// Backward, one launch. x/dx (B, T_in, C), w/dw (3, 3, C), dq/dk/dv
// (B, T_out, C) in dtype; partial (row_blocks, 9, C) f32 scratch; tickets
// (C / 4 / vx) int32, all 0, this call's own (the kernel leaves each at
// row_blocks); all contiguous and 16-byte aligned, C a multiple of
// 16 / sizeof(element).
extern "C" int dwconv_qkv_bwd(const void* x, const void* w, const void* dq,
                              const void* dk, const void* dv, void* dx,
                              void* dw, void* partial, void* tickets, int B,
                              int T_in, int T_out, int C, int stride,
                              int rows, int vx, int row_blocks, int dtype,
                              void* stream) {
  if (!plan_ok(B, T_in, T_out, C, stride, rows, vx, VX_MAX, row_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = C / CH / vx;
  if (dtype == 0)
    return stride == 1
        ? (int)launch_bwd<float, 1>(x, w, dq, dk, dv, dx, dw, partial, tickets, B, T_in, T_out, C, rows, vx, groups, row_blocks, s)
        : (int)launch_bwd<float, 2>(x, w, dq, dk, dv, dx, dw, partial, tickets, B, T_in, T_out, C, rows, vx, groups, row_blocks, s);
  if (dtype == 1)
    return stride == 1
        ? (int)launch_bwd<__nv_bfloat16, 1>(x, w, dq, dk, dv, dx, dw, partial, tickets, B, T_in, T_out, C, rows, vx, groups, row_blocks, s)
        : (int)launch_bwd<__nv_bfloat16, 2>(x, w, dq, dk, dv, dx, dw, partial, tickets, B, T_in, T_out, C, rows, vx, groups, row_blocks, s);
  return (int)cudaErrorInvalidValue;
}
