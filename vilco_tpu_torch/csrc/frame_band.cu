// Frame-banded attention on channels-last q/k/v: forward, dq and dk/dv.
//
// Replaces vilco_tpu/kernels/frame_band.py::frame_band_attention (the Pallas
// kernels run by _forward, and the dq and dk/dv calls of _backward).
// q/k/v (B, L, C) with L = n_frames * fr and C = H * D; head h is the column
// range [h*D, (h+1)*D) of each row, so the q/k/v Linear outputs feed the
// kernels with no (B, H, L, D) relayout. Token i (frame i / fr) attends every
// token of the frames [f - w, f + w] inside [0, n_frames):
//   s_ij = (q_i * scale * log2 e) . k_j  in the band, left out elsewhere
//   m_i  = max(row max of s_i, -1e8)       (the TPU kernel's row-max floor)
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
// Keys outside the band are never visited, which equals the plain version's
// -1e9 score there: exp(-1e9 - m) = 0, and no row is ever fully masked
// because every query sees its own frame. Every n_frames >= 1 (the band
// wider than the clip included), every fr >= 1 and D <= 128 is taken; C need
// not be a multiple of 128. The TPU kernel's padded halo, 128-row alignment
// and (BQ, SPAN) bias tile have no counterpart.
//
// What bounds it on the card, and the design: the band makes the attention
// block-dense. At the VQ flagship (fr = 64, w = 2, H = 8, D = 32, L = 1920)
// a query tile of 64 rows is one frame and sees at most 5 frames = 320 keys,
// so per (tile, head) the work is a 64 x 320 x 32 score product: ~2 x 64 x 320
// x 32 x 2 operations against (64 + 2 x 320) x 32 x 2 bytes, ~29 operations
// a byte, far under the ~295 where the tensor cores would be the limit: the
// kernels are bound by moving q, k, v (a dense (L, L) attention would do 6x
// the work for nothing). Each block stages only its window's K and V.
//  - forward, bfloat16: one block of 4 warps per (query tile of 64 rows,
//    head, batch) walks the window's key tiles of 64 with an f32 online
//    softmax; S = Q K^T and O += P V on the tensor cores (WMMA 16x16x16, bf16
//    in, f32 accumulate), S, P (rounded to bf16 before the P V product, as
//    the TPU kernel rounds e) and O staged in shared memory.
//  - forward, float32 (the parity path): one thread per query row, SIMT.
//  Both store lse = m + log2(l) per (batch, head, row) for the backward.
//  - dq: one block of 256 threads per (query tile of 64, head, batch) walks
//    the same window's key tiles: P = exp2(s - lse), dP = dO V^T,
//    dS = P (dP - delta) with delta = rowsum(dO * O) precomputed, and
//    dq += scale dS K, held in registers.
//  - dk/dv: one block per (key tile of 64, head, batch) walks the query
//    tiles of the transposed band (the band is symmetric, so the same
//    window): dv += P^T dO, dk += scale dS^T Q in registers.
//  No atomics and no accumulator over the full L. The backward runs SIMT in
//  f32 for both dtypes, bound by shared-memory operand reads.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr float ROWMAX_FLOOR = -1e8f;
constexpr int FAR = 1 << 20;     // frame of a padding row: outside any band

// The frame geometry: L tokens, fr a frame, w frames each side.
struct Band {
  int L, fr, w, n_frames;
  // the key (or query) token range [lo, hi) that rows r0 .. r1 reach
  __device__ __forceinline__ void window(int r0, int r1, int& lo,
                                         int& hi) const {
    lo = max(0, r0 / fr - w) * fr;
    hi = min(n_frames - 1, r1 / fr + w) * fr + fr;
  }
};

// ---- forward, float32: SIMT ----------------------------------------------

constexpr int BQ = 64;   // query rows per block (= threads)
constexpr int BK = 32;   // keys per shared-memory tile

template <int DPAD>
__global__ void __launch_bounds__(BQ)
fb_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, Band g, int H, int D,
                   float scale_log2) {
  __shared__ __align__(16) float ks[BK][DPAD];
  __shared__ __align__(16) float vs[BK][DPAD];
  __shared__ int kf[BK];

  const int b = blockIdx.z, h = blockIdx.y, C = H * D;
  const int q0 = blockIdx.x * BQ, nq = min(BQ, g.L - q0);
  const int row = q0 + threadIdx.x;
  const bool active = threadIdx.x < nq;
  const int fq = (active ? row : q0) / g.fr;
  const long long base = (long long)b * g.L;

  float qr[DPAD], o[DPAD];
  const float* qp = q + (base + (active ? row : q0)) * C + h * D;
#pragma unroll
  for (int d = 0; d < DPAD; ++d) {
    qr[d] = (active && d < D) ? qp[d] * scale_log2 : 0.f;
    o[d] = 0.f;
  }
  float m = ROWMAX_FLOOR, l = 0.f;
  int lo, hi;
  g.window(q0, q0 + nq - 1, lo, hi);

  for (int j0 = lo; j0 < hi; j0 += BK) {
    for (int e = threadIdx.x; e < BK * DPAD; e += BQ) {
      const int jj = e / DPAD, d = e % DPAD, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < hi && d < D) {
        const long long off = (base + j) * C + h * D + d;
        kv = k[off];
        vv = v[off];
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    for (int jj = threadIdx.x; jj < BK; jj += BQ)
      kf[jj] = j0 + jj < hi ? (j0 + jj) / g.fr : FAR;
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
      s[jj] = abs(kf[jj] - fq) <= g.w ? acc : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPAD; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = exp2f(s[jj] - m_new);
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
    const float inv = 1.f / l;
    float* op = out + (base + row) * C + h * D;
#pragma unroll
    for (int d = 0; d < DPAD; ++d)
      if (d < D) op[d] = o[d] * inv;
    if (lse != nullptr)
      lse[((long long)b * H + h) * g.L + row] = m + log2f(l);
  }
}

// ---- forward, bfloat16: tensor cores through WMMA -------------------------

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
  static constexpr int F_OFF = O_OFF + BQ * LDO * 4;
  static constexpr int BYTES = F_OFF + BK * 4;
};

template <int DPAD>
__global__ void __launch_bounds__(128)
fb_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, Band g, int H, int D,
                 float scale_log2, bool vec) {
  using Lay = TcLayout<DPAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::Q_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + Lay::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + Lay::S_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + Lay::P_OFF);
  float* os = reinterpret_cast<float*>(smem + Lay::O_OFF);
  int* kf = reinterpret_cast<int*>(smem + Lay::F_OFF);

  const int b = blockIdx.z, h = blockIdx.y, C = H * D;
  const int q0 = blockIdx.x * Lay::BQ, nq = min(Lay::BQ, g.L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)b * g.L;

  const bf16* qb = q + (base + q0) * C + h * D;
  vilco::stage_rows<DPAD, Lay::LDQ, Lay::THREADS>(qs, Lay::BQ, D, vec,
      [=](int r) { return r < nq ? qb + (long long)r * C : nullptr; });
  for (int e = tid; e < Lay::BQ * DPAD; e += Lay::THREADS)
    os[(e / DPAD) * Lay::LDO + e % DPAD] = 0.f;
  // two lanes per query row, each on half of the key tile and of D
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int fq = (q0 + min(row, nq - 1)) / g.fr;
  float m = ROWMAX_FLOOR, l = 0.f;
  int lo, hi;
  g.window(q0, q0 + nq - 1, lo, hi);

  for (int j0 = lo; j0 < hi; j0 += Lay::BK) {
    __syncthreads();   // the previous tile's K, V are no longer read
    const int nk = min(Lay::BK, hi - j0);
    const bf16* kb = k + (base + j0) * C + h * D;
    const bf16* vb = v + (base + j0) * C + h * D;
    vilco::stage_rows<DPAD, Lay::LDQ, Lay::THREADS>(ks, Lay::BK, D, vec,
        [=](int r) { return r < nk ? kb + (long long)r * C : nullptr; });
    vilco::stage_rows<DPAD, Lay::LDQ, Lay::THREADS>(vs, Lay::BK, D, vec,
        [=](int r) { return r < nk ? vb + (long long)r * C : nullptr; });
    for (int jj = tid; jj < Lay::BK; jj += Lay::THREADS)
      kf[jj] = jj < nk ? (j0 + jj) / g.fr : FAR;
    __syncthreads();

    // S (this warp's 16 rows x 64 keys) = Q K^T
#pragma unroll
    for (int nb = 0; nb < Lay::BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + warp * 16 * Lay::LDQ + kk * 16,
                               Lay::LDQ);
        wmma::load_matrix_sync(bt, ks + nb * 16 * Lay::LDQ + kk * 16,
                               Lay::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * Lay::LDS + nb * 16, acc,
                              Lay::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row `row` over the keys of its band
    float* srow = ss + row * Lay::LDS;
    float tmax = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < Lay::BK / 2; ++c) {
      const int col = 2 * c + half;   // interleaved: fewer bank conflicts
      const float x = abs(kf[col] - fq) <= g.w ? srow[col] * scale_log2
                                               : -INFINITY;
      srow[col] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll 8
    for (int c = 0; c < Lay::BK / 2; ++c) {
      const int col = 2 * c + half;
      const float p = exp2f(srow[col] - m_new);
      psum += p;
      ps[row * Lay::LDP + col] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = os + row * Lay::LDO;
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      orow[d] *= alpha;
    __syncwarp();

    // O (this warp's 16 rows x DPAD) += P V
#pragma unroll
    for (int db = 0; db < DPAD / 16; ++db) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + warp * 16 * Lay::LDO + db * 16,
                             Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < Lay::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + warp * 16 * Lay::LDP + kk * 16,
                               Lay::LDP);
        wmma::load_matrix_sync(bv, vs + kk * 16 * Lay::LDQ + db * 16,
                               Lay::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + warp * 16 * Lay::LDO + db * 16, acc,
                              Lay::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < nq) {
    const float inv = 1.f / l;
    const float* orow = os + row * Lay::LDO;
    bf16* op = out + (base + q0 + row) * C + h * D;
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      if (d < D) op[d] = __float2bfloat16(orow[d] * inv);
    if (lse != nullptr && half == 0)
      lse[((long long)b * H + h) * g.L + q0 + row] = m + log2f(l);
  }
}

// ---- backward: dq and dk/dv, SIMT in f32 ----------------------------------

constexpr int BT = 64;             // query and key tile of the backward
constexpr int BWD_THREADS = 256;   // 16 x 16

template <int DPAD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * BT * (DPAD + 1) + 2 * BT * (BT + 1) + 2 * BT)
         + sizeof(int) * 2 * BT;
}

// Stage rows [r0, r0 + BT) of head h of x and y (f32 in shared memory, rows
// of LD floats), zero at rows >= r1 and columns >= D.
template <typename T, int DPAD>
__device__ __forceinline__ void stage_pair(const T* __restrict__ x,
                                           const T* __restrict__ y,
                                           float* xs, float* ys,
                                           long long base, int r0, int r1,
                                           int C, int h, int D) {
  constexpr int LD = DPAD + 1;
  for (int e = threadIdx.x; e < BT * DPAD; e += BWD_THREADS) {
    const int r = e / DPAD, d = e % DPAD, i = r0 + r;
    float xv = 0.f, yv = 0.f;
    if (i < r1 && d < D) {
      const long long off = (base + i) * C + h * D + d;
      xv = vilco::to_f32<T>(x[off]);
      yv = vilco::to_f32<T>(y[off]);
    }
    xs[r * LD + d] = xv;
    ys[r * LD + d] = yv;
  }
}

// P and dS of a (query tile x key tile) pair: rows ty + 16a, keys tx + 16c.
// s = q . k and dp = dO . v from the staged tiles; pairs outside the band
// (frames qf, kf) get P = 0.
template <int DPAD>
__device__ __forceinline__ void band_scores(
    const float* qs, const float* gs, const float* ks, const float* vs,
    const float* lses, const float* dl, const int* qf, const int* kf, int w,
    float scale_log2, int tx, int ty, float (&p)[BT / 16][BT / 16],
    float (&ds)[BT / 16][BT / 16]) {
  constexpr int LD = DPAD + 1, RA = BT / 16;
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
      p[a][c] = abs(qf[i] - kf[j]) <= w
                    ? exp2f(s[a][c] * scale_log2 - lses[i]) : 0.f;
      ds[a][c] = p[a][c] * (dp[a][c] - dl[i]);
    }
}

// lse, delta and the frame of the rows [r0, r0 + BT) (rows >= r1: lse +inf,
// frame FAR, so P is 0 there).
__device__ __forceinline__ void stage_rowstats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* lses, float* dl, int* rf,
                                               long long rowbase, int r0,
                                               int r1, int fr) {
  for (int r = threadIdx.x; r < BT; r += BWD_THREADS) {
    const int i = r0 + r;
    const bool ok = i < r1;
    lses[r] = ok ? lse[rowbase + i] : INFINITY;
    dl[r] = ok ? delta[rowbase + i] : 0.f;
    rf[r] = ok ? i / fr : -FAR;
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
fb_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Band g, int H, int D, float scale_log2,
             float scale) {
  constexpr int LD = DPAD + 1, LP = BT + 1, RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD]
  float* gs = qs + BT * LD;        // dO tile
  float* ks = gs + BT * LD;
  float* vs = ks + BT * LD;
  float* dss = vs + BT * LD;       // [BT][LP] dS (the second tile unused)
  float* lses = dss + 2 * BT * LP;
  float* dl = lses + BT;
  int* qf = reinterpret_cast<int*>(dl + BT);
  int* kf = qf + BT;

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int C = H * D, nq = min(BT, g.L - i0);
  const long long base = (long long)b * g.L;
  const long long rowbase = ((long long)b * H + h) * g.L;
  stage_pair<T, DPAD>(q, dout, qs, gs, base, i0, g.L, C, h, D);
  stage_rowstats(lse, delta, lses, dl, qf, rowbase, i0, g.L, g.fr);
  int lo, hi;
  g.window(i0, i0 + nq - 1, lo, hi);

  float acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[a][c] = 0.f;

  for (int j0 = lo; j0 < hi; j0 += BT) {
    __syncthreads();   // the previous key tile and dS are no longer read
    stage_pair<T, DPAD>(k, v, ks, vs, base, j0, hi, C, h, D);
    for (int r = tid; r < BT; r += BWD_THREADS)
      kf[r] = j0 + r < hi ? (j0 + r) / g.fr : FAR;
    __syncthreads();
    float p[RA][RA], ds[RA][RA];
    band_scores<DPAD>(qs, gs, ks, vs, lses, dl, qf, kf, g.w, scale_log2, tx,
                      ty, p, ds);
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
        for (int c = 0; c < CD; ++c) acc[a][c] = fmaf(sv[a], kv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= g.L) continue;
    const long long off = (base + i) * C + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[off + d] = vilco::from_f32<T>(acc[a][c] * scale);
    }
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
fb_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, Band g, int H, int D,
              float scale_log2, float scale) {
  constexpr int LD = DPAD + 1, LP = BT + 1, RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD]
  float* gs = qs + BT * LD;        // dO tile
  float* ks = gs + BT * LD;
  float* vs = ks + BT * LD;
  float* ps = vs + BT * LD;        // [BT][LP] P
  float* dss = ps + BT * LP;       // [BT][LP] dS
  float* lses = dss + BT * LP;
  float* dl = lses + BT;
  int* qf = reinterpret_cast<int*>(dl + BT);
  int* kf = qf + BT;

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int C = H * D, nk = min(BT, g.L - j0);
  const long long base = (long long)b * g.L;
  const long long rowbase = ((long long)b * H + h) * g.L;
  stage_pair<T, DPAD>(k, v, ks, vs, base, j0, g.L, C, h, D);
  for (int r = tid; r < BT; r += BWD_THREADS)
    kf[r] = r < nk ? (j0 + r) / g.fr : FAR;
  int lo, hi;   // the band is symmetric: the keys' window is their queries'
  g.window(j0, j0 + nk - 1, lo, hi);

  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int i0 = lo; i0 < hi; i0 += BT) {
    __syncthreads();   // the previous query tile, P and dS are no longer read
    stage_pair<T, DPAD>(q, dout, qs, gs, base, i0, hi, C, h, D);
    stage_rowstats(lse, delta, lses, dl, qf, rowbase, i0, hi, g.fr);
    __syncthreads();
    float p[RA][RA], ds[RA][RA];
    band_scores<DPAD>(qs, gs, ks, vs, lses, dl, qf, kf, g.w, scale_log2, tx,
                      ty, p, ds);
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
    if (j >= g.L) continue;
    const long long off = (base + j) * C + h * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[off + d] = vilco::from_f32<T>(dk_acc[a][c] * scale);
        dv[off + d] = vilco::from_f32<T>(dv_acc[a][c]);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o0, *o1, *lse_out;
  int B, L, H, D, fr, w;
};

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DPAD>
cudaError_t launch_fwd(const Args& a, int dtype, cudaStream_t s) {
  const Band g{a.L, a.fr, a.w, a.L / a.fr};
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)a.D);
  if (dtype == 0) {
    const dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
    fb_fwd_simt_kernel<DPAD><<<grid, BQ, 0, s>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (float*)a.o0, (float*)a.lse_out, g, a.H, a.D, scale_log2);
    return cudaGetLastError();
  }
  using Lay = TcLayout<DPAD>;
  const bool vec = a.D % 8 == 0 && (a.H * a.D) % 8 == 0 &&
                   (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v) % 16)
                       == 0;
  auto kern = fb_fwd_tc_kernel<DPAD>;
  cudaError_t e = prepare(kern, Lay::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + Lay::BQ - 1) / Lay::BQ, a.H, a.B);
  kern<<<grid, Lay::THREADS, Lay::BYTES, s>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o0,
      (float*)a.lse_out, g, a.H, a.D, scale_log2, vec);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t launch_bwd(int which, const Args& a, cudaStream_t s) {
  const Band g{a.L, a.fr, a.w, a.L / a.fr};
  const size_t smem = bwd_smem_bytes<DPAD>();
  const dim3 grid((a.L + BT - 1) / BT, a.H, a.B);
  const float scale = 1.f / sqrtf((float)a.D);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t e;
  if (which == 1) {
    auto kern = fb_dq_kernel<T, DPAD>;
    if ((e = prepare(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, BWD_THREADS, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse_in, (const float*)a.delta, (T*)a.o0, g, a.H, a.D,
        scale_log2, scale);
  } else {
    auto kern = fb_dkv_kernel<T, DPAD>;
    if ((e = prepare(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, BWD_THREADS, smem, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse_in, (const float*)a.delta, (T*)a.o0, (T*)a.o1, g,
        a.H, a.D, scale_log2, scale);
  }
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t dispatch_dpad(int which, const Args& a, int dtype,
                          cudaStream_t s) {
  if (which == 0) return launch_fwd<DPAD>(a, dtype, s);
  if (dtype == 0) return launch_bwd<float, DPAD>(which, a, s);
  return launch_bwd<bf16, DPAD>(which, a, s);
}

int run(int which, const Args& a, int dtype, void* stream) {
  if (a.D < 1 || a.D > 128 || a.B < 1 || a.L < 1 || a.H < 1 || a.fr < 1 ||
      a.w < 0 || a.w >= FAR / 2 || a.L % a.fr != 0 || a.B > 65535 ||
      a.H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.D <= 32) return (int)dispatch_dpad<32>(which, a, dtype, s);
  if (a.D <= 64) return (int)dispatch_dpad<64>(which, a, dtype, s);
  return (int)dispatch_dpad<128>(which, a, dtype, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, L, H*D), all contiguous,
// L = n_frames * fr; D <= 128, w >= 0. lse (B, H, L) f32 (log2 domain), or
// null when no backward follows.
extern "C" int frame_band_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int L, int H, int D,
                              int fr, int w, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
         B, L, H, D, fr, w};
  return run(0, a, dtype, stream);
}

// dq (B, L, H*D) in dtype from the forward's lse, delta = rowsum(dO * O)
// (B, H, L) f32 and the output gradient dout (B, L, H*D).
extern "C" int frame_band_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int L, int H,
                             int D, int fr, int w, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, L, H, D, fr, w};
  return run(1, a, dtype, stream);
}

// dk, dv (B, L, H*D) in dtype, blocked over keys.
extern "C" int frame_band_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int L, int H, int D, int fr, int w, int dtype,
                              void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, B, L, H, D, fr, w};
  return run(2, a, dtype, stream);
}
