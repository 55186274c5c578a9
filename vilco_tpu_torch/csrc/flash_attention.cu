// Flash attention with key padding, forward, dq and dk/dv, on channels-last
// q/k/v.
//
// Replaces vilco_tpu/kernels/attention.py::flash_attention_jax (K1f), which
// calls JAX's TPU flash-attention Pallas kernels
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward, and the
// dkv and dq kernels of its backward) with the key mask as segment ids.
// Self-attention, q/k/v (B, T, C) with C = H * D read in place (head h is
// the column range [h*D, (h+1)*D) of each row: no fold). The library's
// semantics are kept:
//   s = (q . k in f32) * (1 / sqrt(D)),  + MASK for a masked key, where
//   MASK = -0.7 * FLT_MAX;  p = exp(s - m) (natural exp), online over key
//   tiles from m = -inf;  o = sum_j p_j v_j / sum_j p_j, in q's dtype.
// A fully masked row has every s equal to MASK, so it averages v over all
// T keys (masked ones included), as the library does; -inf there would give
// NaN. Keys at or past T (the ragged last tile, e.g. the ViT's 1025 tokens)
// are skipped (-inf), not masked. Invalid query rows are not zeroed.
//
// The forward stores each row's m and l (f32, (B, H, T)) for the backward,
// apart: l is the count T in a fully masked row, which m + log(l) would
// lose at m = MASK. The backward recomputes p = exp(s - m) / l and runs as
// two kernels with no atomics, as the library's does: dq blocked over query
// tiles (walking the key tiles), dk/dv blocked over key tiles (walking the
// query tiles), each with delta = rowsum(dO * O) of its query tile:
//   dP = dO V^T,  dS = P (dP - delta) / sqrt(D)
//   dq = dS K,  dk = dS^T Q,  dv = P^T dO
//
// Design, as K1's (csrc/attention_blc.cu), which this kernel matches in
// speed: one block per (query tile of 64 rows, head, batch).
//  - bfloat16 forward: 4 warps, key tiles of 64, S = Q K^T and O += P V on
//    the tensor cores (WMMA, bf16 in, f32 accumulate; P rounded to bf16 as
//    the library rounds p to v's dtype), S, P and O in shared memory where
//    two lanes per row run the softmax. Bound by shared-memory traffic
//    around the fragments.
//  - float32 forward: SIMT, one thread per query row, q and o in registers,
//    key tiles of 32 as shared-memory broadcasts. Bound by FMA issue.
//  - dq and dk/dv, both dtypes: SIMT f32, 256 threads, 64 x 64 tiles of the
//    scores in shared memory. Bound by shared-memory operand reads.
// Every T >= 1 and D <= 128 is taken (the wrapper gives T < 128 to K1, as
// JAX gives it to XLA).

#include <cfloat>
#include <mma.h>

#include "common.cuh"

namespace {

// the library's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX rounded once to f32
constexpr float MASK_VALUE = (float)(-0.7 * (double)FLT_MAX);

__device__ __forceinline__ long long row_at(int b, int t, int h, int T,
                                            int C, int D) {
  return ((long long)b * T + t) * C + (long long)h * D;
}

// ---- float32 forward: SIMT ------------------------------------------------

constexpr int BQ = 64;    // query rows per block (= threads)
constexpr int BK = 32;    // keys per shared-memory tile

template <int DPAD>
__global__ void __launch_bounds__(BQ)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int T, int C, int D,
                      float scale) {
  __shared__ __align__(16) float ks[BK][DPAD];
  __shared__ __align__(16) float vs[BK][DPAD];
  __shared__ float bias[BK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < T;

  float qr[DPAD], o[DPAD];
  const float* qp = q + row_at(b, active ? row : 0, h, T, C, D);
#pragma unroll
  for (int d = 0; d < DPAD; ++d) {
    qr[d] = (active && d < D) ? qp[d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint8_t* mp = mask + (long long)b * T;

  for (int j0 = 0; j0 < T; j0 += BK) {
    for (int e = threadIdx.x; e < BK * DPAD; e += BQ) {
      const int jj = e / DPAD, d = e % DPAD, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < T && d < D) {
        const long long off = row_at(b, j, h, T, C, D) + d;
        kv = k[off];
        vv = v[off];
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    for (int jj = threadIdx.x; jj < BK; jj += BQ) {
      const int j = j0 + jj;
      bias[jj] = j < T ? (mp[j] ? 0.f : MASK_VALUE) : -INFINITY;
    }
    __syncthreads();

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DPAD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][d]);
        acc = fmaf(qr[d], kk.x, acc);
        acc = fmaf(qr[d + 1], kk.y, acc);
        acc = fmaf(qr[d + 2], kk.z, acc);
        acc = fmaf(qr[d + 3], kk.w, acc);
      }
      s[jj] = acc * scale + bias[jj];
      tmax = fmaxf(tmax, s[jj]);
    }
    const float m_new = fmaxf(m, tmax);   // finite: the tile has a key < T
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPAD; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < DPAD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[jj][d]);
        o[d] = fmaf(p, vv.x, o[d]);
        o[d + 1] = fmaf(p, vv.y, o[d + 1]);
        o[d + 2] = fmaf(p, vv.z, o[d + 2]);
        o[d + 3] = fmaf(p, vv.w, o[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / l;            // l >= 1: the max term is exp(0)
    float* op = out + row_at(b, row, h, T, C, D);
#pragma unroll
    for (int d = 0; d < DPAD; ++d)
      if (d < D) op[d] = o[d] * inv;
    if (m_out != nullptr) {
      const long long r = ((long long)b * gridDim.y + h) * T + row;
      m_out[r] = m;
      l_out[r] = l;
    }
  }
}

// ---- bfloat16 forward: tensor cores through WMMA ---------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

template <int DPAD>
struct TcLayout {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
  static constexpr int LDQ = DPAD + 8;   // bf16 rows of Q, K, V
  static constexpr int LDS = BK + 4;     // f32 rows of S
  static constexpr int LDP = BK + 8;     // bf16 rows of P
  static constexpr int LDO = DPAD + 4;   // f32 rows of O
  // byte offsets, each a multiple of 128 (WMMA wants 32-byte alignment)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LDQ * 2;
  static constexpr int V_OFF = K_OFF + BK * LDQ * 2;
  static constexpr int S_OFF = V_OFF + BK * LDQ * 2;
  static constexpr int P_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + BQ * LDP * 2;
  static constexpr int B_OFF = O_OFF + BQ * LDO * 4;
  static constexpr int BYTES = B_OFF + BK * 4;
};

template <int DPAD>
__global__ void __launch_bounds__(128)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int T, int C, int D, float scale, bool vec) {
  using L = TcLayout<DPAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* bias = reinterpret_cast<float*>(smem + L::B_OFF);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16 zero = __float2bfloat16(0.f);

  for (int e = tid; e < L::BQ * DPAD; e += L::THREADS) {
    const int r = e / DPAD, d = e % DPAD, i = q0 + r;
    qs[r * L::LDQ + d] =
        (i < T && d < D) ? q[row_at(b, i, h, T, C, D) + d] : zero;
    os[r * L::LDO + d] = 0.f;
  }
  // two lanes per query row, each on half of the key tile and of D
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  float m = -INFINITY, l = 0.f;
  const uint8_t* mp = mask + (long long)b * T;

  for (int j0 = 0; j0 < T; j0 += L::BK) {
    __syncthreads();   // the previous tile's K, V are no longer read
    const int nk = min(L::BK, T - j0);
    const bf16* kb = k + row_at(b, j0, h, T, C, D);
    const bf16* vb = v + row_at(b, j0, h, T, C, D);
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(ks, L::BK, D, vec,
        [=](int r) { return r < nk ? kb + (long long)r * C : nullptr; });
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(vs, L::BK, D, vec,
        [=](int r) { return r < nk ? vb + (long long)r * C : nullptr; });
    for (int jj = tid; jj < L::BK; jj += L::THREADS) {
      const int j = j0 + jj;
      bias[jj] = j < T ? (mp[j] ? 0.f : MASK_VALUE) : -INFINITY;
    }
    __syncthreads();

    // S (this warp's 16 rows x 64 keys) = Q K^T
#pragma unroll
    for (int nb = 0; nb < L::BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(bt, ks + nb * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * L::LDS + nb * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row `row` in natural exp
    float* srow = ss + row * L::LDS;
    float tmax = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int col = 2 * c + half;   // interleaved: fewer bank conflicts
      const float x = srow[col] * scale + bias[col];
      srow[col] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int col = 2 * c + half;
      const float p = __expf(srow[col] - m_new);
      psum += p;
      ps[row * L::LDP + col] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = os + row * L::LDO;
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      orow[d] *= alpha;
    __syncwarp();

    // O (this warp's 16 rows x DPAD) += P V
#pragma unroll
    for (int db = 0; db < DPAD / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + warp * 16 * L::LDO + db * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, vs + kk * 16 * L::LDQ + db * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + warp * 16 * L::LDO + db * 16, acc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int i = q0 + row;
  if (i < T) {
    const float inv = 1.f / l;
    const float* orow = os + row * L::LDO;
    bf16* op = out + row_at(b, i, h, T, C, D);
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      if (d < D) op[d] = __float2bfloat16(orow[d] * inv);
    if (m_out != nullptr && half == 0) {
      const long long r = ((long long)b * gridDim.y + h) * T + i;
      m_out[r] = m;
      l_out[r] = l;
    }
  }
}

// ---- backward: dq (query tiles) and dk/dv (key tiles), SIMT f32 -----------

constexpr int BT = 64;             // query and key tile of the backward
constexpr int BWD_THREADS = 256;   // 16 x 16

// Stage `BT` rows of two (T, C) tensors' head h (rows past T zero) into
// shared [BT][LD] f32 tiles.
template <typename Tp, int DPAD, int LD>
__device__ __forceinline__ void stage_pair(const Tp* __restrict__ x,
                                           const Tp* __restrict__ y,
                                           float* xs, float* ys, int b,
                                           int r0, int h, int T, int C,
                                           int D) {
  for (int e = threadIdx.x; e < BT * DPAD; e += BWD_THREADS) {
    const int r = e / DPAD, d = e % DPAD, t = r0 + r;
    float xv = 0.f, yv = 0.f;
    if (t < T && d < D) {
      const long long off = row_at(b, t, h, T, C, D) + d;
      xv = vilco::to_f32<Tp>(x[off]);
      yv = vilco::to_f32<Tp>(y[off]);
    }
    xs[r * LD + d] = xv;
    ys[r * LD + d] = yv;
  }
}

// Per query row of the tile at i0: m, 1/l and delta = rowsum(dO * O), four
// lanes a row; rows past T get m = +inf, so their p is exactly 0.
template <typename Tp>
__device__ __forceinline__ void stage_rowstats(
    const Tp* __restrict__ out, const Tp* __restrict__ dout,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* ms, float* linv, float* delta, int b, int i0, int h, int T, int C,
    int D) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3, i = i0 + r;
  float acc = 0.f;
  if (i < T) {
    const long long off = row_at(b, i, h, T, C, D);
    for (int d = part; d < D; d += 4)
      acc += vilco::to_f32<Tp>(out[off + d]) * vilco::to_f32<Tp>(dout[off + d]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    const long long st = ((long long)b * gridDim.y + h) * T + i;
    delta[r] = acc;
    ms[r] = i < T ? m_in[st] : INFINITY;
    linv[r] = i < T ? 1.f / l_in[st] : 1.f;
  }
}

// p = exp(s * scale + bias_j - m_i) / l_i and dS = p (dP - delta_i) for the
// 64 x 64 tile held by the 16 x 16 threads (rows ty + 16a, keys tx + 16c),
// from the staged Q (or dO) and K (or V) tiles.
template <int DPAD, int LD>
__device__ __forceinline__ void scores_and_ds(
    const float* qs, const float* gs, const float* ks, const float* vs,
    const float* bias, const float* ms, const float* linv,
    const float* delta, float scale, float (&p)[BT / 16][BT / 16],
    float (&ds)[BT / 16][BT / 16]) {
  constexpr int RA = BT / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RA][RA], dp[RA][RA];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DPAD; ++d) {
    float qv[RA], gv[RA], kv[RA], vv[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      qv[a] = qs[(ty + 16 * a) * LD + d];
      gv[a] = gs[(ty + 16 * a) * LD + d];
      kv[a] = ks[(tx + 16 * a) * LD + d];
      vv[a] = vs[(tx + 16 * a) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RA; ++c) {
      const int i = ty + 16 * a, j = tx + 16 * c;
      p[a][c] = expf(s[a][c] * scale + bias[j] - ms[i]) * linv[i];
      ds[a][c] = p[a][c] * (dp[a][c] - delta[i]);
    }
}

template <int DPAD>
constexpr size_t bwd_smem_bytes(int n_score_tiles) {
  return sizeof(float) *
         (4 * BT * (DPAD + 1) + n_score_tiles * BT * (BT + 1) + 4 * BT);
}

template <typename Tp, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dq_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                const Tp* __restrict__ v, const uint8_t* __restrict__ mask,
                const Tp* __restrict__ out, const float* __restrict__ m_in,
                const float* __restrict__ l_in, const Tp* __restrict__ dout,
                Tp* __restrict__ dq, int T, int C, int D, float scale) {
  constexpr int LD = DPAD + 1, LP = BT + 1, RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD] this block's query rows
  float* gs = qs + BT * LD;        // dO
  float* ks = gs + BT * LD;        // the key tile
  float* vs = ks + BT * LD;
  float* dss = vs + BT * LD;       // [BT][LP] dS
  float* bias = dss + BT * LP;     // [BT] per key
  float* ms = bias + BT;           // [BT] per query row
  float* linv = ms + BT;
  float* delta = linv + BT;

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  stage_pair<Tp, DPAD, LD>(q, dout, qs, gs, b, i0, h, T, C, D);
  stage_rowstats<Tp>(out, dout, m_in, l_in, ms, linv, delta, b, i0, h, T, C,
                     D);
  float dq_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.f;

  for (int j0 = 0; j0 < T; j0 += BT) {
    __syncthreads();   // the previous key tile is no longer read
    stage_pair<Tp, DPAD, LD>(k, v, ks, vs, b, j0, h, T, C, D);
    for (int r = tid; r < BT; r += BWD_THREADS) {
      const int j = j0 + r;
      bias[r] = j < T ? (mask[(long long)b * T + j] ? 0.f : MASK_VALUE)
                      : -INFINITY;
    }
    __syncthreads();
    float p[RA][RA], ds[RA][RA];
    scores_and_ds<DPAD, LD>(qs, gs, ks, vs, bias, ms, linv, delta, scale, p,
                            ds);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c)
        dss[(ty + 16 * a) * LP + tx + 16 * c] = ds[a][c];
    __syncthreads();
    // dq += dS K: query rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float sv[RA], kv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) sv[a] = dss[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c)
          dq_acc[a][c] = fmaf(sv[a], kv[c], dq_acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= T) continue;
    Tp* dqp = dq + row_at(b, i, h, T, C, D);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqp[d] = vilco::from_f32<Tp>(dq_acc[a][c] * scale);
    }
  }
}

template <typename Tp, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dkv_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                 const Tp* __restrict__ v, const uint8_t* __restrict__ mask,
                 const Tp* __restrict__ out, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, const Tp* __restrict__ dout,
                 Tp* __restrict__ dk, Tp* __restrict__ dv, int T, int C,
                 int D, float scale) {
  constexpr int LD = DPAD + 1, LP = BT + 1, RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD] the query tile
  float* gs = qs + BT * LD;        // its dO
  float* ks = gs + BT * LD;        // this block's key rows
  float* vs = ks + BT * LD;
  float* ps = vs + BT * LD;        // [BT][LP] P
  float* dss = ps + BT * LP;       // [BT][LP] dS
  float* bias = dss + BT * LP;     // [BT] per key
  float* ms = bias + BT;           // [BT] per query row
  float* linv = ms + BT;
  float* delta = linv + BT;

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  stage_pair<Tp, DPAD, LD>(k, v, ks, vs, b, j0, h, T, C, D);
  for (int r = tid; r < BT; r += BWD_THREADS) {
    const int j = j0 + r;
    bias[r] = j < T ? (mask[(long long)b * T + j] ? 0.f : MASK_VALUE)
                    : -INFINITY;
  }
  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int i0 = 0; i0 < T; i0 += BT) {
    __syncthreads();   // the previous query tile is no longer read
    stage_pair<Tp, DPAD, LD>(q, dout, qs, gs, b, i0, h, T, C, D);
    stage_rowstats<Tp>(out, dout, m_in, l_in, ms, linv, delta, b, i0, h, T,
                       C, D);
    __syncthreads();
    float p[RA][RA], ds[RA][RA];
    scores_and_ds<DPAD, LD>(qs, gs, ks, vs, bias, ms, linv, delta, scale, p,
                            ds);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        ps[(ty + 16 * a) * LP + tx + 16 * c] = p[a][c];
        dss[(ty + 16 * a) * LP + tx + 16 * c] = ds[a][c];
      }
    __syncthreads();
    // dv += P^T dO, dk += dS^T Q: key rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float pv[RA], sv[RA], gv[CD], qv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pv[a] = ps[i * LP + ty + 16 * a];
        sv[a] = dss[i * LP + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = gs[i * LD + tx + 16 * c];
        qv[c] = qs[i * LD + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[a][c] = fmaf(pv[a], gv[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(sv[a], qv[c], dk_acc[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= T) continue;
    const long long off = row_at(b, j, h, T, C, D);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[off + d] = vilco::from_f32<Tp>(dk_acc[a][c] * scale);
        dv[off + d] = vilco::from_f32<Tp>(dv_acc[a][c]);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

template <int DPAD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* m_out, void* l_out,
                       int B, int T, int H, int D, int dtype, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)D);
  const int C = H * D;
  if (dtype == 0) {
    const dim3 grid((T + BQ - 1) / BQ, H, B);
    flash_fwd_simt_kernel<DPAD><<<grid, BQ, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const uint8_t*)mask, (float*)out, (float*)m_out, (float*)l_out, T, C,
        D, scale);
    return cudaGetLastError();
  }
  using L = TcLayout<DPAD>;
  const bool vec = D % 8 == 0 && C % 8 == 0 &&
                   (((uintptr_t)k | (uintptr_t)v) % 16) == 0;
  auto kern = flash_fwd_tc_kernel<DPAD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + L::BQ - 1) / L::BQ, H, B);
  kern<<<grid, L::THREADS, L::BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (bf16*)out, (float*)m_out, (float*)l_out, T, C, D, scale, vec);
  return cudaGetLastError();
}

template <typename Tp, int DPAD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* mask, const void* out, const void* m_in,
                      const void* l_in, const void* dout, void* dq, int B,
                      int T, int H, int D, cudaStream_t s) {
  auto kern = flash_dq_kernel<Tp, DPAD>;
  const size_t smem = bwd_smem_bytes<DPAD>(1);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BT - 1) / BT, H, B);
  kern<<<grid, BWD_THREADS, smem, s>>>(
      (const Tp*)q, (const Tp*)k, (const Tp*)v, (const uint8_t*)mask,
      (const Tp*)out, (const float*)m_in, (const float*)l_in,
      (const Tp*)dout, (Tp*)dq, T, H * D, D, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename Tp, int DPAD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* mask, const void* out, const void* m_in,
                       const void* l_in, const void* dout, void* dk, void* dv,
                       int B, int T, int H, int D, cudaStream_t s) {
  auto kern = flash_dkv_kernel<Tp, DPAD>;
  const size_t smem = bwd_smem_bytes<DPAD>(2);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BT - 1) / BT, H, B);
  kern<<<grid, BWD_THREADS, smem, s>>>(
      (const Tp*)q, (const Tp*)k, (const Tp*)v, (const uint8_t*)mask,
      (const Tp*)out, (const float*)m_in, (const float*)l_in,
      (const Tp*)dout, (Tp*)dk, (Tp*)dv, T, H * D, D, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int H, int D, int dtype) {
  return D < 1 || D > 128 || B < 1 || T < 1 || H < 1 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, T, H*D), mask (B, T) one
// byte per key (nonzero = valid), all contiguous; D <= 128. m and l
// (B, H, T) f32, both null when no backward follows.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* m, void* l, int B,
                         int T, int H, int D, int dtype, void* stream) {
  if (bad_shape(B, T, H, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(D <= 64
      ? launch_fwd<64>(q, k, v, mask, out, m, l, B, T, H, D, dtype, s)
      : launch_fwd<128>(q, k, v, mask, out, m, l, B, T, H, D, dtype, s));
}

// dq (B, T, H*D) in dtype, from the forward's out, m and l and dout.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* mask, const void* out, const void* m,
                        const void* l, const void* dout, void* dq, int B,
                        int T, int H, int D, int dtype, void* stream) {
  if (bad_shape(B, T, H, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define VILCO_DQ(Tp, DP) launch_dq<Tp, DP>(q, k, v, mask, out, m, l, dout, dq, B, T, H, D, s)
  if (dtype == 0) return (int)(D <= 64 ? VILCO_DQ(float, 64) : VILCO_DQ(float, 128));
  return (int)(D <= 64 ? VILCO_DQ(bf16, 64) : VILCO_DQ(bf16, 128));
#undef VILCO_DQ
}

// dk, dv (B, T, H*D) in dtype.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* mask, const void* out, const void* m,
                         const void* l, const void* dout, void* dk, void* dv,
                         int B, int T, int H, int D, int dtype, void* stream) {
  if (bad_shape(B, T, H, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define VILCO_DKV(Tp, DP) launch_dkv<Tp, DP>(q, k, v, mask, out, m, l, dout, dk, dv, B, T, H, D, s)
  if (dtype == 0) return (int)(D <= 64 ? VILCO_DKV(float, 64) : VILCO_DKV(float, 128));
  return (int)(D <= 64 ? VILCO_DKV(bf16, 64) : VILCO_DKV(bf16, 128));
#undef VILCO_DKV
}
