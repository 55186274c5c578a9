// Frame-banded attention on channels-last q/k/v: the forward.
//
// Replaces vilco_tpu/kernels/frame_band.py::frame_band_attention's Pallas
// `_forward` (its `_backward`, the dq and dk/dv kernels, is the band mode
// of K1's backward passes in csrc/attention_blc_bwd.cu, which reads the lse
// stored here). q/k/v (B, L, C) with L = n_frames * fr and C = H * D; head
// h is the column range [h*D, (h+1)*D) of each row, so the q/k/v Linear
// outputs feed the kernels with no (B, H, L, D) relayout. Token i (frame
// i / fr) attends every token of the frames [f - w, f + w] inside
// [0, n_frames) (attention_blc.cuh::Band):
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
// kernel is bound by moving q, k, v (a dense (L, L) attention would do 6x
// the work for nothing). Each block stages only its window's K and V.
//  - bfloat16: one block of 4 warps per (query tile of 64 rows, head,
//    batch) walks the window's key tiles of 64 with an f32 online softmax;
//    S = Q K^T and O += P V on the tensor cores (WMMA 16x16x16, bf16 in, f32
//    accumulate), S, P (rounded to bf16 before the P V product, as the TPU
//    kernel rounds e) and O staged in shared memory.
//  - float32 (the parity path): one thread per query row, SIMT.
//  Both store lse = m + log2(l) per (batch, head, row) for the backward.

#include <mma.h>

#include "attention_blc.cuh"

namespace {

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

// ---- launcher --------------------------------------------------------------

template <int DPAD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int D,
                       const Band& g, int dtype, cudaStream_t s) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  if (dtype == 0) {
    const dim3 grid((g.L + BQ - 1) / BQ, H, B);
    fb_fwd_simt_kernel<DPAD><<<grid, BQ, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
        g, H, D, scale_log2);
    return cudaGetLastError();
  }
  using Lay = TcLayout<DPAD>;
  const bool vec = D % 8 == 0 && (H * D) % 8 == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) == 0;
  auto kern = fb_fwd_tc_kernel<DPAD>;
  cudaError_t e = set_smem(kern, Lay::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.L + Lay::BQ - 1) / Lay::BQ, H, B);
  kern<<<grid, Lay::THREADS, Lay::BYTES, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, g, H,
      D, scale_log2, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, L, H*D), all contiguous,
// L = n_frames * fr; D <= 128, w >= 0. lse (B, H, L) f32 (log2 domain), or
// null when no backward follows.
extern "C" int frame_band_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int L, int H, int D,
                              int fr, int w, int dtype, void* stream) {
  if (D < 1 || D > 128 || B < 1 || L < 1 || H < 1 || fr < 1 || w < 0 ||
      w >= FAR / 2 || L % fr != 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Band g{L, fr, w, L / fr};
  auto run = D <= 32 ? launch_fwd<32> : D <= 64 ? launch_fwd<64>
                                                 : launch_fwd<128>;
  return (int)run(q, k, v, out, (float*)lse, B, H, D, g, dtype,
                  (cudaStream_t)stream);
}
