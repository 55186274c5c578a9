// Sliding-window (banded) attention on channels-last q/k/v: forward, dq and
// dk/dv.
//
// Replaces vilco_tpu/kernels/banded_attention.py::banded_attention_fused
// (the Pallas _fwd_kernel run by _forward, and _dq_kernel / _dkv_kernel run
// by _backward). q/k/v (B, T, C) with C = H * D; head h is the column range
// [h*D, (h+1)*D) of each row, so the Linear outputs feed the kernel with no
// (B*H, T, D) fold. The mask is one byte per key (nonzero = valid) and
// doubles as the query mask. Semantics, those of the plain version
// (ops/attention.py::banded_attention):
//   s_ij = (q_i * scale) . k_j  for |i - j| <= w, 0 <= j < T, key j valid
//        = -1e9                 for a masked key of the band
//   o_i  = sum_j softmax(s_i)_j v_j   (f32 softmax), 0 for an invalid query
// Keys outside [0, T) are left out of the sum: against the plain version's
// -1e9 padding they only ever add exp(-1e9 - m) = 0 to a valid row (a valid
// query sees itself), and invalid rows are zeroed. Every T >= 1 and w >= 1
// is taken, the band wider than T included; D <= 128; all arithmetic f32.
//
// What bounds it on the card: memory. Per query the work is 2w + 1 dot
// products of length D (9 of 96 at the NLQ shape), far below the ~300
// operations per byte where Hopper's tensor cores would pay, so the TPU
// kernel's whole (BQ, BQ + 128) MXU score tile is not carried over. One warp
// owns a query (or, in dk/dv, a key): lane l holds channels l + 32c, c <
// NC = ceil(D / 32), each dot product is a warp sum, and the softmax runs
// online over the keys in f32. A block takes BT = 32 rows of one (batch,
// head) and stages the rows its band reaches, [t0 - w, t0 + BT + w), in
// shared memory in chunks of 64 (one chunk at w = 4), so each key or query
// row comes from device memory about once per block whatever w is.
//
// Forward: when a gradient follows it also stores lse_i = m_i + log(l_i)
// (natural log, f32, (B, H, T)).
// dq: per query, delta_i = dO_i . o_i with dO of an invalid query zeroed
// (the forward zeroes that row), p_ij = exp(s_ij - lse_i),
// dp_ij = dO_i . v_j (v zeroed at masked keys), ds = p (dp - delta),
// dq_i = scale * sum_j ds_ij k_j.
// dk/dv, blocked over keys from the start: key j is seen by the queries
// [j - w, j + w] in [0, T); the block stages that query halo (q, dO, lse and
// delta, recomputed from dO and o) and each warp sums dv_j = sum_i p_ij dO_i
// and dk_j = scale * sum_i ds_ij q_i in registers. No atomics and no
// accumulator over the full T: the TPU kernel's full-T dk/dv accumulators,
// which ran out of VMEM at T = 16384, have no counterpart here.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BT = 32;                 // rows (queries or keys) per block
constexpr int ROWS = BT / WARPS;       // rows per warp
constexpr int CHUNK = 64;              // staged halo rows per pass
constexpr float NEG_INF_BIAS = -1e9f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Channels lane + 32c of one row (global memory), zero past D.
template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int D,
                                         int lane, float (&r)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    r[c] = d < D ? vilco::to_f32<T>(row[d]) : 0.f;
  }
}

template <int NC>
__device__ __forceinline__ float dot_smem(const float (&a)[NC],
                                          const float* __restrict__ row,
                                          int lane) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) acc = fmaf(a[c], row[lane + 32 * c], acc);
  return acc;
}

// Row i of head h times `scale` (channels lane + 32c), zero for i >= Tn.
template <typename T, int NC>
__device__ __forceinline__ void load_head_row(const T* __restrict__ x,
                                              long long base, int i, int Tn,
                                              long long C, int h, int D,
                                              int lane, float scale,
                                              float (&r)[NC]) {
  if (i < Tn) {
    load_row<T, NC>(x + (base + i) * C + h * D, D, lane, r);
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) r[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) r[c] *= scale;
}

// Stages the key rows [c0, c0 + n) of head h for the query-blocked kernels:
// k, v zeroed at masked keys, and each key's valid bit. The sync before
// frees the previous chunk, the one after publishes this one.
template <typename T, int NC>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         const uint8_t* __restrict__ mask,
                                         long long base, int c0, int n,
                                         int h, int D, long long C, int warp,
                                         int lane, float* ks, float* vs,
                                         float* ok) {
  constexpr int DP = 32 * NC;
  __syncthreads();
  for (int r = warp; r < n; r += WARPS) {
    const long long off = (base + c0 + r) * C + h * D;
    const bool valid = mask[base + c0 + r] != 0;
    float kr[NC], vr[NC];
    load_row<T, NC>(k + off, D, lane, kr);
    load_row<T, NC>(v + off, D, lane, vr);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ks[r * DP + lane + 32 * c] = kr[c];
      vs[r * DP + lane + 32 * c] = valid ? vr[c] : 0.f;
    }
    if (lane == 0) ok[r] = valid ? 1.f : 0.f;
  }
  __syncthreads();
}

template <int NC>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * CHUNK * 32 * NC + 2 * CHUNK);
}

// ---- forward ---------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  T* __restrict__ out, float* __restrict__ lse, int Tn, int H,
                  int D, int w, float scale) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                    // [CHUNK][DP]
  float* vs = ks + CHUNK * DP;       // [CHUNK][DP], zero at masked keys
  float* ok = vs + CHUNK * DP;       // [CHUNK] 1 = valid key

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = (long long)H * D;
  const long long base = (long long)b * Tn;

  float qr[ROWS][NC], acc[ROWS][NC], m[ROWS], l[ROWS];
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    load_head_row<T, NC>(q, base, t0 + warp * ROWS + s, Tn, C, h, D, lane,
                         scale, qr[s]);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[s][c] = 0.f;
    m[s] = -INFINITY;
    l[s] = 0.f;
  }

  const int lo = max(t0 - w, 0), hi = min(t0 + BT + w, Tn);
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int n = min(CHUNK, hi - c0);
    stage_kv<T, NC>(k, v, mask, base, c0, n, h, D, C, warp, lane, ks, vs, ok);

#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = t0 + warp * ROWS + s;
      if (i >= Tn) continue;   // warp-uniform
      const int jlo = max(i - w, c0), jhi = min(i + w, c0 + n - 1);
      for (int j = jlo; j <= jhi; ++j) {
        const int r = j - c0;
        const float dot = warp_sum(dot_smem<NC>(qr[s], ks + r * DP, lane));
        const float sc = ok[r] != 0.f ? dot : NEG_INF_BIAS;
        const float m_new = fmaxf(m[s], sc);
        const float alpha = expf(m[s] - m_new);
        const float p = expf(sc - m_new);
        l[s] = l[s] * alpha + p;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[s][c] = fmaf(p, vs[r * DP + lane + 32 * c], acc[s][c] * alpha);
        m[s] = m_new;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = t0 + warp * ROWS + s;
    if (i >= Tn) continue;
    const bool valid = mask[base + i] != 0;
    const float inv = valid ? 1.f / l[s] : 0.f;
    T* op = out + (base + i) * C + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) op[d] = vilco::from_f32<T>(acc[s][c] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[((long long)b * H + h) * Tn + i] = m[s] + logf(l[s]);
  }
}

// ---- dq --------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
banded_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 const T* __restrict__ out, const T* __restrict__ dout,
                 const float* __restrict__ lse, T* __restrict__ dq, int Tn,
                 int H, int D, int w, float scale) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                    // [CHUNK][DP]
  float* vs = ks + CHUNK * DP;       // [CHUNK][DP], zero at masked keys
  float* ok = vs + CHUNK * DP;       // [CHUNK]

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = (long long)H * D;
  const long long base = (long long)b * Tn;

  float qr[ROWS][NC], g[ROWS][NC], dqa[ROWS][NC], delta[ROWS], lq[ROWS];
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = t0 + warp * ROWS + s;
    // the cotangent of an invalid query row is zeroed
    const float gm = (i < Tn && mask[base + i] != 0) ? 1.f : 0.f;
    float o[NC];
    load_head_row<T, NC>(q, base, i, Tn, C, h, D, lane, scale, qr[s]);
    load_head_row<T, NC>(dout, base, i, Tn, C, h, D, lane, gm, g[s]);
    load_head_row<T, NC>(out, base, i, Tn, C, h, D, lane, 1.f, o);
    lq[s] = i < Tn ? lse[((long long)b * H + h) * Tn + i] : 0.f;
    float dd = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dd = fmaf(g[s][c], o[c], dd);
      dqa[s][c] = 0.f;
    }
    delta[s] = warp_sum(dd);
  }

  const int lo = max(t0 - w, 0), hi = min(t0 + BT + w, Tn);
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int n = min(CHUNK, hi - c0);
    stage_kv<T, NC>(k, v, mask, base, c0, n, h, D, C, warp, lane, ks, vs, ok);

#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = t0 + warp * ROWS + s;
      if (i >= Tn) continue;
      const int jlo = max(i - w, c0), jhi = min(i + w, c0 + n - 1);
      for (int j = jlo; j <= jhi; ++j) {
        const int r = j - c0;
        const float* kr = ks + r * DP;
        const float dot = warp_sum(dot_smem<NC>(qr[s], kr, lane));
        const float dp = warp_sum(dot_smem<NC>(g[s], vs + r * DP, lane));
        const float sc = ok[r] != 0.f ? dot : NEG_INF_BIAS;
        const float ds = expf(sc - lq[s]) * (dp - delta[s]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dqa[s][c] = fmaf(ds, kr[lane + 32 * c], dqa[s][c]);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = t0 + warp * ROWS + s;
    if (i >= Tn) continue;
    T* p = dq + (base + i) * C + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) p[d] = vilco::from_f32<T>(dqa[s][c] * scale);
    }
  }
}

// ---- dk, dv ----------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
banded_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  const T* __restrict__ out, const T* __restrict__ dout,
                  const float* __restrict__ lse, T* __restrict__ dk,
                  T* __restrict__ dv, int Tn, int H, int D, int w,
                  float scale) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                    // [CHUNK][DP] q * scale
  float* gs = qs + CHUNK * DP;       // [CHUNK][DP] dO, zero at invalid rows
  float* ls = gs + CHUNK * DP;       // [CHUNK] lse
  float* ds_ = ls + CHUNK;           // [CHUNK] delta

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = (long long)H * D;
  const long long base = (long long)b * Tn;
  const float* lrow = lse + ((long long)b * H + h) * Tn;

  float kr[ROWS][NC], vr[ROWS][NC], dka[ROWS][NC], dva[ROWS][NC];
  bool kok[ROWS];
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int j = j0 + warp * ROWS + s;
    kok[s] = j < Tn && mask[base + j] != 0;
    load_head_row<T, NC>(k, base, j, Tn, C, h, D, lane, 1.f, kr[s]);
    load_head_row<T, NC>(v, base, j, Tn, C, h, D, lane, 1.f, vr[s]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!kok[s]) vr[s][c] = 0.f;
      dka[s][c] = dva[s][c] = 0.f;
    }
  }

  const int lo = max(j0 - w, 0), hi = min(j0 + BT + w, Tn);
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int n = min(CHUNK, hi - c0);
    __syncthreads();
    for (int r = warp; r < n; r += WARPS) {
      const int i = c0 + r;
      const long long off = (base + i) * C + h * D;
      const float gm = mask[base + i] != 0 ? 1.f : 0.f;
      float qv[NC], gv[NC], ov[NC];
      load_row<T, NC>(q + off, D, lane, qv);
      load_row<T, NC>(dout + off, D, lane, gv);
      load_row<T, NC>(out + off, D, lane, ov);
      float dd = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        gv[c] *= gm;
        dd = fmaf(gv[c], ov[c], dd);
        qs[r * DP + lane + 32 * c] = qv[c] * scale;
        gs[r * DP + lane + 32 * c] = gv[c];
      }
      dd = warp_sum(dd);
      if (lane == 0) {
        ls[r] = lrow[i];
        ds_[r] = dd;
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int j = j0 + warp * ROWS + s;
      if (j >= Tn) continue;
      const int ilo = max(j - w, c0), ihi = min(j + w, c0 + n - 1);
      for (int i = ilo; i <= ihi; ++i) {
        const int r = i - c0;
        const float* qrow = qs + r * DP;
        const float* grow = gs + r * DP;
        const float dot = warp_sum(dot_smem<NC>(kr[s], qrow, lane));
        const float dp = warp_sum(dot_smem<NC>(vr[s], grow, lane));
        const float sc = kok[s] ? dot : NEG_INF_BIAS;
        const float p = expf(sc - ls[r]);
        const float ds = p * (dp - ds_[r]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dva[s][c] = fmaf(p, grow[lane + 32 * c], dva[s][c]);
          dka[s][c] = fmaf(ds, qrow[lane + 32 * c], dka[s][c]);
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int j = j0 + warp * ROWS + s;
    if (j >= Tn) continue;
    const long long off = (base + j) * C + h * D;
    const float keep = kok[s] ? 1.f : 0.f;   // masked keys get no gradient
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[off + d] = vilco::from_f32<T>(dka[s][c] * keep);
        dv[off + d] = vilco::from_f32<T>(dva[s][c] * keep);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *mask, *out, *dout, *lse;
  void *o0, *o1, *lse_out;
  int B, T, H, D, w;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NC>
cudaError_t launch(int which, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>();
  const dim3 grid((a.T + BT - 1) / BT, a.H, a.B);
  const float scale = 1.f / sqrtf((float)a.D);
  cudaError_t e;
  if (which == 0) {
    auto kern = banded_fwd_kernel<T, NC>;
    if ((e = prepare(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (T*)a.o0, (float*)a.lse_out, a.T, a.H, a.D, a.w, scale);
  } else if (which == 1) {
    auto kern = banded_dq_kernel<T, NC>;
    if ((e = prepare(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (const T*)a.out, (const T*)a.dout, (const float*)a.lse, (T*)a.o0,
        a.T, a.H, a.D, a.w, scale);
  } else {
    auto kern = banded_dkv_kernel<T, NC>;
    if ((e = prepare(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (const T*)a.out, (const T*)a.dout, (const float*)a.lse, (T*)a.o0,
        (T*)a.o1, a.T, a.H, a.D, a.w, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, const Args& a, cudaStream_t s) {
  switch ((a.D + 31) / 32) {
    case 1: return launch<T, 1>(which, a, s);
    case 2: return launch<T, 2>(which, a, s);
    case 3: return launch<T, 3>(which, a, s);
    case 4: return launch<T, 4>(which, a, s);
  }
  return cudaErrorInvalidValue;
}

int run(int which, const Args& a, int dtype, void* stream) {
  if (a.D < 1 || a.D > 128 || a.B < 1 || a.T < 1 || a.H < 1 || a.w < 1 ||
      a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(which, a, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, T, H*D), mask (B, T) one
// byte per key, all contiguous; D <= 128, w >= 1. lse (B, H, T) f32, or
// null when no backward follows.
extern "C" int banded_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, void* lse, int B, int T, int H,
                                    int D, int w, int dtype, void* stream) {
  Args a{q, k, v, mask, nullptr, nullptr, nullptr, out, nullptr, lse,
         B, T, H, D, w};
  return run(0, a, dtype, stream);
}

// dq (B, T, H*D) in dtype from the forward's out and lse and the output
// gradient dout (B, T, H*D).
extern "C" int banded_attention_dq(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* out, const void* dout,
                                   const void* lse, void* dq, int B, int T,
                                   int H, int D, int w, int dtype,
                                   void* stream) {
  Args a{q, k, v, mask, out, dout, lse, dq, nullptr, nullptr, B, T, H, D, w};
  return run(1, a, dtype, stream);
}

// dk, dv (B, T, H*D) in dtype, blocked over keys.
extern "C" int banded_attention_dkv(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* out, const void* dout,
                                    const void* lse, void* dk, void* dv,
                                    int B, int T, int H, int D, int w,
                                    int dtype, void* stream) {
  Args a{q, k, v, mask, out, dout, lse, dk, dv, nullptr, B, T, H, D, w};
  return run(2, a, dtype, stream);
}
