// Sliding-window (banded) attention on channels-last q/k/v: the forward, and
// one backward launch that writes dq, dk and dv.
//
// Replaces vilco_tpu/kernels/banded_attention.py::banded_attention_fused
// (the Pallas _fwd_kernel run by _forward, and _dq_kernel / _dkv_kernel run
// by _backward). q/k/v (B, T, C) with C = H * D; head h is the column range
// [h*D, (h+1)*D) of each row, so the Linear outputs feed the kernel with no
// (B*H, T, D) fold. The mask is one byte per key (nonzero = valid) and
// doubles as the query mask. Semantics, those of the plain version
// (ops/attention.py::banded_attention):
//   s_ij = (q_i * scale) . k_j  for |i - j| <= w, key j valid
//        = -1e9                 for a masked key of the band, or one outside
//                               [0, T) (the plain version's padding)
//   o_i  = sum_j softmax(s_i)_j v_j   (f32 softmax), 0 for an invalid query
// A key outside [0, T) only ever adds exp(-1e9 - m) = 0 to a valid row (a
// valid query sees itself), and invalid rows are zeroed. Every T >= 1 and
// w >= 1 is taken, the band wider than T included; D <= 128; all arithmetic
// f32. The forward stores lse_i = m_i + log(l_i) (natural log, f32,
// (B, H, T)) when a gradient follows.
//
// What bounds it on the card: memory. Per query the work is 2w + 1 dot
// products of length D (9 of 96 at the NLQ shape), far below the ~300
// operations per byte where Hopper's tensor cores would pay, and the
// softmax stays f32, so the TPU kernel's (BQ, BQ + 128) MXU score tile is
// not carried over. The design keeps the chain per row short and each byte
// read from device memory about once:
// - A block takes one (batch, head) and a tile of BT rows (64 in the
//   forward, three blocks an SM; 32 in the longer backward, so twice the
//   blocks fill the card), and stages the rows its band reaches,
//   [t0 - w, t0 + BT + w), in shared memory in their own
//   dtype by 16-byte cp.async copies (a bf16 row of D = 96 is 12), zero
//   outside [0, T), v and dO also at masked rows, the mask bytes beside.
// - G = 4 lanes own one row: lane g holds the 16-byte vectors g, g + 4, ...
//   of it (24 channels of a D = 96 row), so a warp holds 8 rows, and the two
//   rows a quarter warp reads sit 64 bytes apart in the banks. A dot product
//   is the lane's partial sum and two shuffles.
// - A tile whose band holds no valid key (padding past a clip's length) is
//   written as 0 (lse -1e9, as the full computation rounds it) with no row
//   read: the bound counts the valid rows only.
// - Forward: the row's 2w + 1 scores are held in registers (unrolled for
//   w <= WCAP = 8), the softmax takes two passes over them (max, then exp
//   and sum), then p.v runs over the lane's channels from shared memory;
//   the output and the lse are written from registers, 16 bytes a store. A
//   wider window runs the same code pass after pass of NS = 17 keys, with an
//   online rescale between passes; a pass whose rows all lie outside
//   [0, T) is skipped (its keys only add exp(-1e9 - m) = 0).
// - Backward, one launch: the block stages q, k, v, dO, lse and delta_i =
//   dO_i . o_i (computed by the block from o and dO) of its halo rows. Each
//   group then writes dq_i of its query row from the keys of its band, and
//   dk_j, dv_j of its key row from the queries whose band holds it,
//   recomputing p_ij = exp(s_ij - lse_i) and ds_ij = p_ij (dp_ij - delta_i)
//   from shared memory: dq_i = scale sum_j ds_ij k_j, dk_j = scale sum_i
//   ds_ij q_i, dv_j = sum_i p_ij dO_i, 0 at masked keys. Every output row is
//   written once, by one group, in a fixed order: no atomics, two calls give
//   equal bits, and nothing accumulates over the full T (the TPU kernel's
//   full-T dk/dv accumulators ran out of VMEM at T = 16384). A window wider
//   than WCAP restages per pass: k, v for dq, then q, dO, lse and delta for
//   dk/dv.
// - A D that is not a multiple of the 16-byte vector, or a pointer that is
//   not 16-byte aligned, takes a scalar-load instantiation of the same
//   kernels (one element an access, plain loads into shared memory).

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int G = 4;                    // lanes per row
constexpr int WCAP = 8;                 // the widest window run in one pass
constexpr int NS = 2 * WCAP + 1;        // band slots per pass
constexpr float NEG_INF_BIAS = -1e9f;

// A block of WARPS warps: BT rows, SROWS staged rows a pass.
template <int WARPS>
struct Blk {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BT = WARPS * (32 / G);
  static constexpr int SROWS = BT + NS - 1;
};
using FwdBlk = Blk<8>;   // 64 rows
using BwdBlk = Blk<4>;   // 32 rows: twice the blocks, for the longer body

// A lane's share of a row: VW elements an access (16 bytes, or 1 in the
// scalar instantiation), access a at channels (a*G + g)*VW .. + VW - 1.
template <typename T, int VW, int NVL>
struct Lay {
  static constexpr bool VEC = VW * sizeof(T) == 16;
  static constexpr int NCH = NVL * VW;    // channels a lane holds
  static constexpr int PER = NVL * G;     // accesses a row
  static constexpr int DP = PER * VW;     // padded row, zero past D
  // shared row stride: rows 64 bytes apart mod 128 (vector), or G elements
  // apart (scalar), so a quarter warp's rows fall in different banks
  static constexpr int LDS =
      DP + (VEC ? ((DP * sizeof(T)) % 128 == 0 ? 64 / (int)sizeof(T) : 0)
                : G);
  // forward blocks an SM: three (a cap of 80 registers) at up to 24
  // channels a lane; the backward keeps the cap of 255, its body holding
  // four rows of channels and two operand rows
  static constexpr int FWD_MINB = NCH <= 24 ? 3 : 1;
};

template <typename T, int VW>
using Raw = std::conditional_t<VW * sizeof(T) == 16, uint4, T>;

template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> ldv(const T* p) {
  return *reinterpret_cast<const Raw<T, VW>*>(p);
}

template <typename T, int VW>
__device__ __forceinline__ void unpack(const Raw<T, VW>& r, float* out) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VW; ++i) out[i] = vilco::to_f32<T>(e[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The lane's channels of `row` times `scale`, zero past D or for a null row.
template <typename T, int VW, int NVL>
__device__ __forceinline__ void load_lane(const T* row, int D, int g,
                                          float scale,
                                          float (&x)[NVL * VW]) {
#pragma unroll
  for (int a = 0; a < NVL; ++a) {
    const int c = (a * G + g) * VW;
    if (row != nullptr && c < D) {
      unpack<T, VW>(ldv<T, VW>(row + c), x + a * VW);
#pragma unroll
      for (int e = 0; e < VW; ++e) x[a * VW + e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) x[a * VW + e] = 0.f;
    }
  }
}

// Stores the lane's channels times `mul` (0 where `zero`) into `row`.
template <typename T, int VW, int NVL>
__device__ __forceinline__ void store_lane(T* row, int D, int g,
                                           const float (&x)[NVL * VW],
                                           float mul, bool zero) {
#pragma unroll
  for (int a = 0; a < NVL; ++a) {
    const int c = (a * G + g) * VW;
    if (c >= D) continue;
    float y[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) y[e] = zero ? 0.f : x[a * VW + e] * mul;
    if constexpr (VW * sizeof(T) == 16) {
      vilco::store16<T>(row + c, y);
    } else {
      row[c] = vilco::from_f32<T>(y[0]);
    }
  }
}

// Zeroes the lane's channels of `row`.
template <typename T, int VW, int NVL>
__device__ __forceinline__ void zero_lane(T* row, int D, int g) {
#pragma unroll
  for (int a = 0; a < NVL; ++a) {
    const int c = (a * G + g) * VW;
    if (c < D) *reinterpret_cast<Raw<T, VW>*>(row + c) = Raw<T, VW>{};
  }
}

// The lane's partial dot product of x with a staged (padded) row.
template <typename T, int VW, int NVL>
__device__ __forceinline__ float dot_lane(const float (&x)[NVL * VW],
                                          const T* row, int g) {
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < NVL; ++a) {
    float r[VW];
    unpack<T, VW>(ldv<T, VW>(row + (a * G + g) * VW), r);
#pragma unroll
    for (int e = 0; e < VW; ++e) acc = fmaf(x[a * VW + e], r[e], acc);
  }
  return acc;
}

// x += p * (the lane's channels of a staged row)
template <typename T, int VW, int NVL>
__device__ __forceinline__ void axpy_lane(float (&x)[NVL * VW], float p,
                                          const T* row, int g) {
#pragma unroll
  for (int a = 0; a < NVL; ++a) {
    float r[VW];
    unpack<T, VW>(ldv<T, VW>(row + (a * G + g) * VW), r);
#pragma unroll
    for (int e = 0; e < VW; ++e) x[a * VW + e] = fmaf(p, r[e], x[a * VW + e]);
  }
}

// Stages rows [row0, row0 + n) of one head (xb: the head's first column of
// the batch's row 0; rows C apart) into shared rows of Lay::LDS elements:
// zero past D, outside [0, Tn) and, with `mrow`, where the row's mask byte
// is 0. Visible after cp_async_wait_all and a barrier.
template <typename T, int VW, int NVL, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ xb,
                                           long long C, int D, int row0,
                                           int n, int Tn,
                                           const uint8_t* __restrict__ mrow) {
  using L = Lay<T, VW, NVL>;
  for (int e = threadIdx.x; e < n * L::PER; e += THREADS) {
    const int r = e / L::PER, c = (e - r * L::PER) * VW, t = row0 + r;
    const bool ok = t >= 0 && t < Tn && c < D &&
                    (mrow == nullptr || mrow[t] != 0);
    T* d = dst + r * L::LDS + c;
    if constexpr (L::VEC) {
      cp_async16(d, ok ? xb + t * C + c : xb, ok);
    } else {
      *d = ok ? xb[t * C + c] : vilco::from_f32<T>(0.f);
    }
  }
}

// The valid bit of each staged row, 0 outside [0, Tn).
template <int THREADS>
__device__ __forceinline__ void stage_mask(uint8_t* okb,
                                           const uint8_t* __restrict__ mrow,
                                           int row0, int n, int Tn) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int t = row0 + r;
    okb[r] = (t >= 0 && t < Tn && mrow[t] != 0) ? 1 : 0;
  }
}

// Whether any key of the rows [row0, row0 + n) is valid, for the whole
// block (every thread must call it). A tile whose band holds none has every
// score at -1e9: its output and gradients are 0 and its lse is -1e9 (f32
// rounds off the log of the slot count), written without reading a row.
template <int THREADS>
__device__ __forceinline__ bool any_valid(const uint8_t* __restrict__ mrow,
                                          int row0, int n, int Tn) {
  bool any = false;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int t = row0 + r;
    any |= t >= 0 && t < Tn && mrow[t] != 0;
  }
  return __syncthreads_or(any) != 0;
}

// ---- forward ---------------------------------------------------------------

template <typename T, int VW, int NVL>
__global__ void __launch_bounds__(FwdBlk::THREADS, Lay<T, VW, NVL>::FWD_MINB)
banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  T* __restrict__ out, float* __restrict__ lse, int Tn, int H,
                  int D, int w, float scale) {
  using L = Lay<T, VW, NVL>;
  constexpr int NCH = L::NCH, THREADS = FwdBlk::THREADS, BT = FwdBlk::BT,
                SROWS = FwdBlk::SROWS;
  extern __shared__ __align__(16) unsigned char sm[];
  T* Ks = reinterpret_cast<T*>(sm);                   // [SROWS][LDS]
  T* Vs = Ks + SROWS * L::LDS;                        // zero at masked keys
  uint8_t* okb = reinterpret_cast<uint8_t*>(Vs + SROWS * L::LDS);

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
  const int g = threadIdx.x % G, lr = threadIdx.x / G, i = t0 + lr;
  const long long C = (long long)H * D;
  const long long off = (long long)b * Tn * C + (long long)h * D;
  const uint8_t* mrow = mask + (long long)b * Tn;

  float qr[NCH], acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.f;
  if (!any_valid<THREADS>(mrow, t0 - w, BT + 2 * w, Tn)) {
    if (i < Tn) {
      zero_lane<T, VW, NVL>(out + off + i * C, D, g);
      if (lse != nullptr && g == 0)
        lse[((long long)b * H + h) * Tn + i] = NEG_INF_BIAS;
    }
    return;
  }
  load_lane<T, VW, NVL>(i < Tn ? q + off + i * C : nullptr, D, g, scale, qr);
  float m = -INFINITY, l = 0.f;

  // pass jb: slots jb .. jb + ns - 1 of each row, key i - w + slot
  for (int jb = 0; jb < 2 * w + 1; jb += NS) {
    const int ns = min(NS, 2 * w + 1 - jb), n = BT + ns - 1,
              row0 = t0 - w + jb;
    if (row0 + n <= 0 || row0 >= Tn) continue;   // block-uniform
    __syncthreads();                             // the last pass is read
    stage_rows<T, VW, NVL, THREADS>(Ks, k + off, C, D, row0, n,
                                    Tn, nullptr);
    stage_rows<T, VW, NVL, THREADS>(Vs, v + off, C, D, row0, n,
                                    Tn, mrow);
    cp_async_commit();
    stage_mask<THREADS>(okb, mrow, row0, n, Tn);
    cp_async_wait_all();
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = -INFINITY;
      if (j < ns) {   // block-uniform: every lane reaches the shuffles
        const float d =
            group_sum(dot_lane<T, VW, NVL>(qr, Ks + (lr + j) * L::LDS, g));
        s[j] = okb[lr + j] ? d : NEG_INF_BIAS;
      }
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < NS; ++j) mx = fmaxf(mx, s[j]);
    const float alpha = expf(m - mx);            // 0 on the first pass
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j < ns) {
        const float p = expf(s[j] - mx);
        l += p;
        axpy_lane<T, VW, NVL>(acc, p, Vs + (lr + j) * L::LDS, g);
      }
    }
    m = mx;
  }

  if (i < Tn) {
    const bool valid = mrow[i] != 0;
    store_lane<T, VW, NVL>(out + off + i * C, D, g, acc, 1.f / l, !valid);
    if (lse != nullptr && g == 0)
      lse[((long long)b * H + h) * Tn + i] = m + logf(l);
  }
}

// ---- backward: dq, dk and dv in one launch ---------------------------------

template <typename T, int VW, int NVL>
__global__ void __launch_bounds__(BwdBlk::THREADS)
banded_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const uint8_t* __restrict__ mask,
                  const T* __restrict__ out, const T* __restrict__ dout,
                  const float* __restrict__ lse, T* __restrict__ dq,
                  T* __restrict__ dk, T* __restrict__ dv, int Tn, int H,
                  int D, int w, float scale) {
  using L = Lay<T, VW, NVL>;
  constexpr int NCH = L::NCH, THREADS = BwdBlk::THREADS, BT = BwdBlk::BT,
                SROWS = BwdBlk::SROWS;
  extern __shared__ __align__(16) unsigned char sm[];
  T* Qs = reinterpret_cast<T*>(sm);                   // [SROWS][LDS] each
  T* Ks = Qs + SROWS * L::LDS;
  T* Vs = Ks + SROWS * L::LDS;                        // zero at masked keys
  T* Gs = Vs + SROWS * L::LDS;                        // dO, zero at invalid
  float* ls = reinterpret_cast<float*>(Gs + SROWS * L::LDS);   // lse
  float* dl = ls + SROWS;                             // delta
  uint8_t* okb = reinterpret_cast<uint8_t*>(dl + SROWS);

  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BT;
  const int g = threadIdx.x % G, lr = threadIdx.x / G, i = t0 + lr;
  const long long C = (long long)H * D;
  const long long off = (long long)b * Tn * C + (long long)h * D;
  const uint8_t* mrow = mask + (long long)b * Tn;
  const float* lrow = lse + ((long long)b * H + h) * Tn;
  const int nslot = 2 * w + 1;
  const bool one = nslot <= NS;     // the whole band in one pass, staged once
  if (!any_valid<THREADS>(mrow, t0 - w, BT + 2 * w, Tn)) {
    if (i < Tn) {
      zero_lane<T, VW, NVL>(dq + off + i * C, D, g);
      zero_lane<T, VW, NVL>(dk + off + i * C, D, g);
      zero_lane<T, VW, NVL>(dv + off + i * C, D, g);
    }
    return;
  }

  // q and dO of the query rows [row0, row0 + n), their lse and delta (from
  // o and dO in device memory, a group a row; 0 outside [0, T)). The loads
  // for delta overlap the copies in flight.
  auto stage_queries = [&](int row0, int n) {
    stage_rows<T, VW, NVL, THREADS>(Qs, q + off, C, D, row0, n,
                                    Tn, nullptr);
    stage_rows<T, VW, NVL, THREADS>(Gs, dout + off, C, D, row0, n,
                                    Tn, mrow);
    cp_async_commit();
    for (int r0 = 0; r0 < n; r0 += BT) {          // block-uniform
      const int r = r0 + lr, t = row0 + r;
      const bool in = r < n && t >= 0 && t < Tn;
      const bool ok = in && mrow[t] != 0;
      float o[NCH], go[NCH];
      load_lane<T, VW, NVL>(ok ? out + off + t * C : nullptr, D, g, 1.f, o);
      load_lane<T, VW, NVL>(ok ? dout + off + t * C : nullptr, D, g, 1.f,
                            go);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) d = fmaf(go[c], o[c], d);
      d = group_sum(d);
      if (r < n && g == 0) {
        dl[r] = d;
        ls[r] = in ? lrow[t] : 0.f;
      }
    }
  };
  auto stage_keys = [&](int row0, int n) {
    stage_rows<T, VW, NVL, THREADS>(Ks, k + off, C, D, row0, n,
                                    Tn, nullptr);
    stage_rows<T, VW, NVL, THREADS>(Vs, v + off, C, D, row0, n,
                                    Tn, mrow);
    cp_async_commit();
    stage_mask<THREADS>(okb, mrow, row0, n, Tn);
  };

  if (one) {
    stage_keys(t0 - w, BT + 2 * w);
    stage_queries(t0 - w, BT + 2 * w);
    cp_async_wait_all();
    __syncthreads();
  }

  // ---- dq_i of query row i over the keys of its band
  {
    float qi[NCH], gi[NCH], acc[NCH], li, di;
    if (one) {           // row i is staged row lr + w
      load_lane<T, VW, NVL>(Qs + (lr + w) * L::LDS, L::DP, g, scale, qi);
      load_lane<T, VW, NVL>(Gs + (lr + w) * L::LDS, L::DP, g, 1.f, gi);
      li = ls[lr + w];
      di = dl[lr + w];
    } else {
      const bool in = i < Tn, ok = in && mrow[i] != 0;
      float o[NCH];
      load_lane<T, VW, NVL>(in ? q + off + i * C : nullptr, D, g, scale, qi);
      load_lane<T, VW, NVL>(ok ? dout + off + i * C : nullptr, D, g, 1.f,
                            gi);
      load_lane<T, VW, NVL>(ok ? out + off + i * C : nullptr, D, g, 1.f, o);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) d = fmaf(gi[c], o[c], d);
      di = group_sum(d);
      li = in ? lrow[i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.f;

    for (int jb = 0; jb < nslot; jb += NS) {
      const int ns = min(NS, nslot - jb), n = BT + ns - 1,
                row0 = t0 - w + jb;
      if (!one) {
        if (row0 + n <= 0 || row0 >= Tn) continue;   // block-uniform
        __syncthreads();
        stage_keys(row0, n);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int j = 0; j < ns; ++j) {
        const T* kr = Ks + (lr + j) * L::LDS;
        const T* vr = Vs + (lr + j) * L::LDS;
        Raw<T, VW> kraw[NVL];
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int a = 0; a < NVL; ++a) {
          float kf[VW], vf[VW];
          kraw[a] = ldv<T, VW>(kr + (a * G + g) * VW);
          unpack<T, VW>(kraw[a], kf);
          unpack<T, VW>(ldv<T, VW>(vr + (a * G + g) * VW), vf);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            sd = fmaf(qi[a * VW + e], kf[e], sd);
            pd = fmaf(gi[a * VW + e], vf[e], pd);
          }
        }
        sd = group_sum(sd);
        pd = group_sum(pd);
        const float p = expf((okb[lr + j] ? sd : NEG_INF_BIAS) - li);
        const float ds = p * (pd - di);
#pragma unroll
        for (int a = 0; a < NVL; ++a) {
          float kf[VW];
          unpack<T, VW>(kraw[a], kf);
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[a * VW + e] = fmaf(ds, kf[e], acc[a * VW + e]);
        }
      }
    }
    if (i < Tn) store_lane<T, VW, NVL>(dq + off + i * C, D, g, acc, scale,
                                       false);
  }

  // ---- dk_j, dv_j of key row j = i over the queries whose band holds it
  {
    const bool keep = i < Tn && mrow[i] != 0;   // masked keys get 0
    float kj[NCH], vj[NCH], dka[NCH], dva[NCH];
    if (one) {
      load_lane<T, VW, NVL>(Ks + (lr + w) * L::LDS, L::DP, g, scale, kj);
      load_lane<T, VW, NVL>(Vs + (lr + w) * L::LDS, L::DP, g, 1.f, vj);
    } else {
      load_lane<T, VW, NVL>(i < Tn ? k + off + i * C : nullptr, D, g, scale,
                            kj);
      load_lane<T, VW, NVL>(i < Tn ? v + off + i * C : nullptr, D, g, 1.f,
                            vj);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) dka[c] = dva[c] = 0.f;

    // pass jb: slots jb .. jb + ns - 1, query j - w + slot = staged lr + slot
    for (int jb = 0; jb < nslot; jb += NS) {
      const int ns = min(NS, nslot - jb), n = BT + ns - 1,
                row0 = t0 - w + jb;
      if (!one) {
        if (row0 + n <= 0 || row0 >= Tn) continue;   // block-uniform
        __syncthreads();
        stage_queries(row0, n);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int j = 0; j < ns; ++j) {
        const int r = lr + j;
        const T* qr = Qs + r * L::LDS;
        const T* gr = Gs + r * L::LDS;
        Raw<T, VW> qraw[NVL], graw[NVL];
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int a = 0; a < NVL; ++a) {
          float qf[VW], gf[VW];
          qraw[a] = ldv<T, VW>(qr + (a * G + g) * VW);
          graw[a] = ldv<T, VW>(gr + (a * G + g) * VW);
          unpack<T, VW>(qraw[a], qf);
          unpack<T, VW>(graw[a], gf);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            sd = fmaf(kj[a * VW + e], qf[e], sd);
            pd = fmaf(vj[a * VW + e], gf[e], pd);
          }
        }
        sd = group_sum(sd);
        pd = group_sum(pd);
        const float p = expf((keep ? sd : NEG_INF_BIAS) - ls[r]);
        const float ds = p * (pd - dl[r]);
#pragma unroll
        for (int a = 0; a < NVL; ++a) {
          float qf[VW], gf[VW];
          unpack<T, VW>(qraw[a], qf);
          unpack<T, VW>(graw[a], gf);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            dka[a * VW + e] = fmaf(ds, qf[e], dka[a * VW + e]);
            dva[a * VW + e] = fmaf(p, gf[e], dva[a * VW + e]);
          }
        }
      }
    }
    if (i < Tn) {
      store_lane<T, VW, NVL>(dk + off + i * C, D, g, dka, scale, !keep);
      store_lane<T, VW, NVL>(dv + off + i * C, D, g, dva, 1.f, !keep);
    }
  }
}

// ---- launchers -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *mask, *out, *dout, *lse;
  void *o0, *o1, *o2, *lse_out;
  int B, T, H, D, w;
};

template <typename T, int VW, int NVL>
cudaError_t launch(bool fwd, const Args& a, cudaStream_t stream) {
  using L = Lay<T, VW, NVL>;
  const float scale = 1.f / sqrtf((float)a.D);
  cudaError_t e;
  if (fwd) {
    using K = FwdBlk;
    const size_t smem = 2 * (size_t)K::SROWS * L::LDS * sizeof(T) + K::SROWS;
    const dim3 grid((a.T + K::BT - 1) / K::BT, a.H, a.B);
    auto kern = banded_fwd_kernel<T, VW, NVL>;
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return e;
    kern<<<grid, K::THREADS, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (T*)a.o0, (float*)a.lse_out, a.T, a.H, a.D, a.w, scale);
  } else {
    using K = BwdBlk;
    const size_t smem = 4 * (size_t)K::SROWS * L::LDS * sizeof(T) +
                        2 * K::SROWS * sizeof(float) + K::SROWS;
    const dim3 grid((a.T + K::BT - 1) / K::BT, a.H, a.B);
    auto kern = banded_bwd_kernel<T, VW, NVL>;
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return e;
    kern<<<grid, K::THREADS, smem, stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (const T*)a.out, (const T*)a.dout, (const float*)a.lse, (T*)a.o0,
        (T*)a.o1, (T*)a.o2, a.T, a.H, a.D, a.w, scale);
  }
  return cudaGetLastError();
}

// The 16-byte instantiation where D is a multiple of the vector and every
// pointer is 16-byte aligned, else the scalar one; NVL rounded up to an
// instantiated count (padded channels are zero).
template <typename T>
cudaError_t dispatch(bool fwd, const Args& a, bool aligned, cudaStream_t s) {
  constexpr int VW = 16 / sizeof(T);
  if (aligned && a.D % VW == 0) {
    const int nvl = (a.D / VW + G - 1) / G;
    if (nvl <= 1) return launch<T, VW, 1>(fwd, a, s);
    if (nvl <= 2) return launch<T, VW, 2>(fwd, a, s);
    if (nvl <= 3) return launch<T, VW, 3>(fwd, a, s);
    if (nvl <= 4) return launch<T, VW, 4>(fwd, a, s);
    if constexpr (VW == 4) {       // f32: D up to 128 is 8 accesses a lane
      if (nvl <= 6) return launch<T, VW, 6>(fwd, a, s);
      return launch<T, VW, 8>(fwd, a, s);
    }
    return cudaErrorInvalidValue;
  }
  const int nvl = (a.D + G - 1) / G;
  if (nvl <= 2) return launch<T, 1, 2>(fwd, a, s);
  if (nvl <= 8) return launch<T, 1, 8>(fwd, a, s);
  if (nvl <= 16) return launch<T, 1, 16>(fwd, a, s);
  return launch<T, 1, 32>(fwd, a, s);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return false;
  return true;
}

int run(bool fwd, const Args& a, int dtype, void* stream) {
  if (a.D < 1 || a.D > 128 || a.B < 1 || a.T < 1 || a.H < 1 || a.w < 1 ||
      a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  const bool al = aligned16({a.q, a.k, a.v, a.out, a.dout, a.o0, a.o1, a.o2});
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(fwd, a, al, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(fwd, a, al, s);
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
  Args a{q, k, v, mask, nullptr, nullptr, nullptr, out, nullptr, nullptr,
         lse, B, T, H, D, w};
  return run(true, a, dtype, stream);
}

// dq, dk, dv (B, T, H*D) in dtype, one launch, from the forward's out and
// lse and the output gradient dout (B, T, H*D).
extern "C" int banded_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* out, const void* dout,
                                    const void* lse, void* dq, void* dk,
                                    void* dv, int B, int T, int H, int D,
                                    int w, int dtype, void* stream) {
  Args a{q, k, v, mask, out, dout, lse, dq, dk, dv, nullptr, B, T, H, D, w};
  return run(false, a, dtype, stream);
}
