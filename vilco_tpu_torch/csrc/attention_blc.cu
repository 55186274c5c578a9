// Masked softmax attention, forward and backward, on channels-last or
// head-major q/k/v.
//
// Replaces vilco_tpu/kernels/attention.py::fused_attention_blc (the Pallas
// _fwd_kernel_blc run by _run_fwd_blc, and _bwd_kernel_blc run by
// _run_bwd_blc) and, on the head-major layout, fused_attention (K1n: the
// Pallas _fwd_kernel run by _run_fwd and _bwd_kernel run by _run_bwd, the
// same function on (H, B, T, D) folded tensors). The kernels address rows
// through element strides of batch, token and head (`Strides`): channels-
// last q (B, Tq, C), k/v (B, Tk, C) with C = H * D (head h is the column
// range [h*D, (h+1)*D) of each row, so no relayout is made), or head-major
// (H, B, T, D). Semantics kept from the TPU kernels:
//   s = (q * scale * log2 e) . k + bias,  bias = 0 for valid keys, -1e9 else
//   m = max(row max of s, -1e8)          (the row-max floor)
//   o = sum_j exp2(s_j - m) v_j / (sum_j exp2(s_j - m) + 1e-30)
// The floor makes every weight of a fully masked row exp2(-9e8) = 0, so such
// a row gives 0, not NaN, and masked keys need no v multiply.
//
// The forward also carries the two switches of the VQ attention probe
// (tools/probe_vq_attn.py::run_variant, P2), as template parameters whose
// defaults compile to the plain K1 forward:
//  - BOUND_SHIFT: the running row max is replaced by a shift fixed before
//    the key loop, |q_i * scale * log2 e| * max_j |k_j| over all Tk keys of
//    the head (a first pass of the block over K). Softmax is shift-
//    invariant and the shift bounds every score, so no rescaling of the
//    running sum and output is needed; far above the row max it underflows.
//  - MXU_SUM (bf16 only): the row sum is taken over the bf16-rounded P tile
//    as a WMMA product with a ones fragment, not from the f32 values. In
//    f32 the ones product of f32 values is the row sum, so f32 ignores it.
//
// Design, both paths: one block per (query tile of 64 rows, head, batch)
// walks the keys in tiles with an online softmax (running max and sum per
// query row), so no score tile leaves the chip.
//  - bfloat16 (the serving path): 4 warps, 16 query rows each, key tiles of
//    64. S = Q K^T and O += P V run on the tensor cores (WMMA 16x16x16,
//    bf16 in, f32 accumulate); S, P (rounded to bf16, as the TPU kernel
//    rounds e before its P V dot) and O live in shared memory, where two
//    lanes per row do the softmax. Bound by shared-memory traffic around
//    the fragments, which later PRs remove with register-resident
//    mma.sync/wgmma tiles.
//  - float32 (the parity path; TF32 would not be f32): SIMT, one thread per
//    query row holding q and the output in registers, key tiles of 32 read
//    as shared-memory broadcasts. Bound by FMA issue (2 * D FMAs per score).
// Every Tq, Tk >= 1 and D <= 128 is taken. When asked, the forward also
// stores lse = m + log2(l + 1e-30) per (batch, head, query row), the row's
// log-sum-exp in the log2 domain; a fully masked row gets -1e8 - 99.7, so
// exp2(s - lse) is 0 there in the backward too.
//
// Backward (both dtypes, SIMT in f32): one block of 256 threads per (key
// tile of 64, head, batch) keeps its K, V tile in shared memory and its
// dk, dv tile in registers (16 x 16 threads, each 4 key rows by D/16
// strided columns) and walks the query tiles of 64:
//   P  = exp2(s * scale log2 e + bias - lse)      (recomputed, exact f32)
//   dP = dO V^T,  delta = rowsum(dO * O),  dS = P (dP - delta)
//   dv += P^T dO,  dk += scale dS^T Q,  dq += scale dS K
// dq sums over key tiles, so it goes through f32 atomicAdd into an f32
// buffer (one pass over the scores, no separate dq pass); its f32 sums are
// order-dependent at the level of f32 rounding. Bound by shared-memory
// operand reads (each FMA reads two operands, one a broadcast).

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block (= threads)
constexpr int BK = 32;            // keys per shared-memory tile
constexpr float NEG_INF_BIAS = -1e9f;
constexpr float ROWMAX_FLOOR = -1e8f;

// Element strides of a row's batch, token and head: (B, T, H * D)
// channels-last or (H, B, T, D) head-major; column d of head h of token t
// of batch b is at b * sb + t * st + h * sh + d.
struct Strides {
  long long sb, st, sh;
  __device__ __forceinline__ long long at(int b, int t, int h) const {
    return b * sb + t * st + h * sh;
  }
};

Strides strides_of(bool head_major, int B, int T, int H, int D) {
  return head_major ? Strides{(long long)T * D, D, (long long)B * T * D}
                    : Strides{(long long)T * H * D, (long long)H * D, D};
}

// max_j |k_j|^2 over the Tk keys of head h of batch b, by every thread of
// the block (THREADS a multiple of 32); `red` holds THREADS / 32 floats.
// Groups of KG lanes share a key, each lane summing every KG-th column, so
// a group reads its row's columns side by side (coalesced); every lane runs
// the same number of rounds, so the shuffles see the whole warp.
template <typename T, int THREADS>
__device__ float key_norm2_max(const T* __restrict__ k, Strides sk, int b,
                               int h, int Tk, int D, float* red) {
  constexpr int KG = 8, KEYS = THREADS / KG;
  const int sub = threadIdx.x % KG, slot = threadIdx.x / KG;
  float best = 0.f;
#pragma unroll 4
  for (int j0 = 0; j0 < Tk; j0 += KEYS) {
    const int j = j0 + slot;
    float acc = 0.f;
    if (j < Tk) {
      const T* kp = k + sk.at(b, j, h);
      for (int d = sub; d < D; d += KG) {
        const float x = vilco::to_f32<T>(kp[d]);
        acc = fmaf(x, x, acc);
      }
    }
#pragma unroll
    for (int o = KG / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    best = fmaxf(best, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  float all = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) all = fmaxf(all, red[w]);
  return all;
}

template <typename T, int DPAD, bool BOUND_SHIFT>
__global__ void __launch_bounds__(BQ)
attention_blc_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          T* __restrict__ out, float* __restrict__ lse,
                          int Tq, int Tk, int D, Strides sq, Strides sk,
                          float scale_log2) {
  __shared__ __align__(16) float ks[BK][DPAD];
  __shared__ __align__(16) float vs[BK][DPAD];
  __shared__ float bias[BK];
  __shared__ float red[BQ / 32];

  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < Tq;

  float qr[DPAD], o[DPAD];
  const T* qp = q + sq.at(b, active ? row : 0, h);
#pragma unroll
  for (int d = 0; d < DPAD; ++d) {
    qr[d] = (active && d < D) ? vilco::to_f32<T>(qp[d]) * scale_log2 : 0.f;
    o[d] = 0.f;
  }
  float m = ROWMAX_FLOOR, l = 0.f;
  if constexpr (BOUND_SHIFT) {
    float qn2 = 0.f;
#pragma unroll
    for (int d = 0; d < DPAD; ++d) qn2 = fmaf(qr[d], qr[d], qn2);
    m = sqrtf(qn2) * sqrtf(key_norm2_max<T, BQ>(k, sk, b, h, Tk, D, red));
  }
  const uint8_t* mp = mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += BK) {
    for (int e = threadIdx.x; e < BK * DPAD; e += BQ) {
      const int jj = e / DPAD, d = e % DPAD, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < Tk && d < D) {
        const long long off = sk.at(b, j, h) + d;
        kv = vilco::to_f32<T>(k[off]);
        vv = vilco::to_f32<T>(v[off]);
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    for (int jj = threadIdx.x; jj < BK; jj += BQ) {
      const int j = j0 + jj;
      bias[jj] = j < Tk ? (mp[j] ? 0.f : NEG_INF_BIAS) : -INFINITY;
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
      s[jj] = acc + bias[jj];
      tmax = fmaxf(tmax, s[jj]);
    }
    if constexpr (!BOUND_SHIFT) {   // with the fixed shift, nothing rescales
      const float m_new = fmaxf(m, tmax);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DPAD; ++d) o[d] *= alpha;
      m = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = exp2f(s[jj] - m);
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
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / (l + 1e-30f);
    T* op = out + sq.at(b, row, h);
#pragma unroll
    for (int d = 0; d < DPAD; ++d)
      if (d < D) op[d] = vilco::from_f32<T>(o[d] * inv);
    if (lse != nullptr)
      lse[((long long)b * gridDim.y + h) * Tq + row] = m + log2f(l + 1e-30f);
  }
}

// ---- bfloat16: tensor cores through WMMA ---------------------------------

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

template <int DPAD, bool BOUND_SHIFT, bool MXU_SUM>
__global__ void __launch_bounds__(128)
attention_blc_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int Tq, int Tk, int D, Strides sq, Strides sk,
                        float scale_log2, bool vec) {
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
    qs[r * L::LDQ + d] = (i < Tq && d < D) ? q[sq.at(b, i, h) + d] : zero;
    os[r * L::LDO + d] = 0.f;
  }
  // two lanes per query row, each on half of the key tile and of D
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  float m = ROWMAX_FLOOR, l = 0.f;
  if constexpr (BOUND_SHIFT) {
    __shared__ float red[L::THREADS / 32];
    const float kn2 = key_norm2_max<bf16, L::THREADS>(k, sk, b, h, Tk, D,
                                                      red);
    float qn2 = 0.f;   // this lane's half of |q_row * scale * log2 e|^2
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d) {
      const float x = __bfloat162float(qs[row * L::LDQ + d]) * scale_log2;
      qn2 = fmaf(x, x, qn2);
    }
    qn2 += __shfl_xor_sync(0xffffffffu, qn2, 1);
    m = sqrtf(qn2) * sqrtf(kn2);
  }
  const uint8_t* mp = mask + (long long)b * Tk;

  for (int j0 = 0; j0 < Tk; j0 += L::BK) {
    __syncthreads();   // the previous tile's K, V are no longer read
    const int nk = min(L::BK, Tk - j0);
    const bf16* kb = k + sk.at(b, j0, h);
    const bf16* vb = v + sk.at(b, j0, h);
    const long long st = sk.st;
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(ks, L::BK, D, vec,
        [=](int r) { return r < nk ? kb + r * st : nullptr; });
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(vs, L::BK, D, vec,
        [=](int r) { return r < nk ? vb + r * st : nullptr; });
    for (int jj = tid; jj < L::BK; jj += L::THREADS) {
      const int j = j0 + jj;
      bias[jj] = j < Tk ? (mp[j] ? 0.f : NEG_INF_BIAS) : -INFINITY;
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

    // online softmax of row `row`: scale, bias, running max with the floor
    // (or the fixed shift)
    float* srow = ss + row * L::LDS;
    float tmax = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int col = 2 * c + half;   // interleaved: fewer bank conflicts
      const float x = srow[col] * scale_log2 + bias[col];
      srow[col] = x;
      tmax = fmaxf(tmax, x);
    }
    float alpha = 1.f;
    if constexpr (!BOUND_SHIFT) {
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m, tmax);
      alpha = exp2f(m - m_new);
      m = m_new;
    }
    float psum = 0.f;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int col = 2 * c + half;
      const float p = exp2f(srow[col] - m);
      psum += p;
      ps[row * L::LDP + col] = __float2bfloat16(p);
    }
    float* orow = os + row * L::LDO;
    if constexpr (!BOUND_SHIFT) {
      for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
        orow[d] *= alpha;
    }
    __syncwarp();
    if constexpr (MXU_SUM) {
      // row sums of this warp's bf16 P rows: P (16 x 64) times ones
      // (64 x 16), every column of the product the row sum; S is spent
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ones;
      wmma::fill_fragment(acc, 0.f);
      wmma::fill_fragment(ones, __float2bfloat16(1.f));
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::mma_sync(acc, a, ones, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * L::LDS, acc, L::LDS,
                              wmma::mem_row_major);
      __syncwarp();
      l = l * alpha + srow[0];
    } else {
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = l * alpha + psum;
    }

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
  if (i < Tq) {
    const float inv = 1.f / (l + 1e-30f);
    const float* orow = os + row * L::LDO;
    bf16* op = out + sq.at(b, i, h);
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      if (d < D) op[d] = __float2bfloat16(orow[d] * inv);
    if (lse != nullptr && half == 0)
      lse[((long long)b * gridDim.y + h) * Tq + i] = m + log2f(l + 1e-30f);
  }
}

// ---- backward -------------------------------------------------------------

constexpr int BT = 64;             // key and query tile of the backward
constexpr int BWD_THREADS = 256;   // 16 x 16

template <int DPAD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * BT * (DPAD + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
attention_blc_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ out,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout, float* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq,
                         int Tk, int D, Strides sq, Strides sk,
                         float scale_log2, float scale) {
  constexpr int LD = DPAD + 1, LP = BT + 1, RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD]
  float* gs = qs + BT * LD;        // dO tile
  float* ks = gs + BT * LD;
  float* vs = ks + BT * LD;
  float* ps = vs + BT * LD;        // [BT][LP] P
  float* dss = ps + BT * LP;       // [BT][LP] dS
  float* bias = dss + BT * LP;     // [BT] per key
  float* lses = bias + BT;         // [BT] per query row
  float* delta = lses + BT;        // [BT]

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int H = gridDim.y;

  for (int e = tid; e < BT * DPAD; e += BWD_THREADS) {
    const int r = e / DPAD, d = e % DPAD, j = j0 + r;
    float kv = 0.f, vv = 0.f;
    if (j < Tk && d < D) {
      const long long off = sk.at(b, j, h) + d;
      kv = vilco::to_f32<T>(k[off]);
      vv = vilco::to_f32<T>(v[off]);
    }
    ks[r * LD + d] = kv;
    vs[r * LD + d] = vv;
  }
  for (int r = tid; r < BT; r += BWD_THREADS) {
    const int j = j0 + r;
    bias[r] = j < Tk ? (mask[(long long)b * Tk + j] ? 0.f : NEG_INF_BIAS)
                     : -INFINITY;
  }
  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int i0 = 0; i0 < Tq; i0 += BT) {
    __syncthreads();   // the previous query tile is no longer read
    for (int e = tid; e < BT * DPAD; e += BWD_THREADS) {
      const int r = e / DPAD, d = e % DPAD, i = i0 + r;
      float qv = 0.f, gv = 0.f;
      if (i < Tq && d < D) {
        const long long off = sq.at(b, i, h) + d;
        qv = vilco::to_f32<T>(q[off]);
        gv = vilco::to_f32<T>(dout[off]);
      }
      qs[r * LD + d] = qv;
      gs[r * LD + d] = gv;
    }
    {  // delta = rowsum(dO * O) and lse, four lanes per row
      const int r = tid >> 2, part = tid & 3, i = i0 + r;
      float acc = 0.f;
      if (i < Tq) {
        const long long off = sq.at(b, i, h);
        for (int d = part; d < D; d += 4)
          acc += vilco::to_f32<T>(out[off + d]) *
                 vilco::to_f32<T>(dout[off + d]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) {
        delta[r] = acc;
        // rows past Tq: lse = +inf makes their P exactly 0
        lses[r] = i < Tq ? lse[((long long)b * H + h) * Tq + i] : INFINITY;
      }
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ty + 16a, keys tx + 16c
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
        const float p = exp2f(s[a][c] * scale_log2 + bias[j] - lses[i]);
        ps[i * LP + j] = p;
        dss[i * LP + j] = p * (dp[a][c] - delta[i]);
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
    // dq += scale dS K: query rows ty + 16a, columns tx + 16c
    float dq_acc[RA][CD];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.f;
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
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= Tq) continue;
      float* dqp = dq + sq.at(b, i, h);
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int d = tx + 16 * c;
        if (d < D) atomicAdd(dqp + d, dq_acc[a][c] * scale);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= Tk) continue;
    const long long off = sk.at(b, j, h);
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

template <typename T, int DPAD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* mask, const void* out, const void* lse,
                       const void* dout, void* dq, void* dk, void* dv, int B,
                       int Tq, int Tk, int H, int D, bool head_major,
                       cudaStream_t stream) {
  auto kern = attention_blc_bwd_kernel<T, DPAD>;
  const size_t smem = bwd_smem_bytes<DPAD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tk + BT - 1) / BT, H, B);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, BWD_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask,
      (const T*)out, (const float*)lse, (const T*)dout, (float*)dq, (T*)dk,
      (T*)dv, Tq, Tk, D, strides_of(head_major, B, Tq, H, D),
      strides_of(head_major, B, Tk, H, D), scale * 1.4426950408889634f,
      scale);
  return cudaGetLastError();
}

template <int DPAD, bool BS>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse, int B, int Tq,
                        int Tk, int H, int D, bool head_major,
                        cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  attention_blc_simt_kernel<float, DPAD, BS><<<grid, BQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (float*)out, (float*)lse, Tq, Tk, D,
      strides_of(head_major, B, Tq, H, D),
      strides_of(head_major, B, Tk, H, D), scale_log2);
  return cudaGetLastError();
}

template <int DPAD, bool BS, bool MS>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* mask, void* out, void* lse, int B, int Tq,
                      int Tk, int H, int D, bool head_major,
                      cudaStream_t stream) {
  const Strides sk = strides_of(head_major, B, Tk, H, D);
  const bool vec = D % 8 == 0 && sk.st % 8 == 0 &&
                   (((uintptr_t)k | (uintptr_t)v) % 16) == 0;
  using L = TcLayout<DPAD>;
  auto kern = attention_blc_tc_kernel<DPAD, BS, MS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + L::BQ - 1) / L::BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (bf16*)out, (float*)lse, Tq, Tk, D, strides_of(head_major, B, Tq, H, D),
      sk, scale_log2, vec);
  return cudaGetLastError();
}

// The forward of one dtype and head width, with the probe's switches
// (variant bit 0: bound_shift, bit 1: mxu_sum; f32 has no use for mxu_sum).
template <int DPAD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int Tq,
                       int Tk, int H, int D, int dtype, bool head_major,
                       int variant, cudaStream_t s) {
#define VILCO_FWD(F) F(q, k, v, mask, out, lse, B, Tq, Tk, H, D, head_major, s)
  const bool bs = variant & 1, ms = variant & 2;
  if (dtype == 0)
    return bs ? VILCO_FWD((launch_simt<DPAD, true>))
              : VILCO_FWD((launch_simt<DPAD, false>));
  if (bs)
    return ms ? VILCO_FWD((launch_tc<DPAD, true, true>))
              : VILCO_FWD((launch_tc<DPAD, true, false>));
  return ms ? VILCO_FWD((launch_tc<DPAD, false, true>))
            : VILCO_FWD((launch_tc<DPAD, false, false>));
#undef VILCO_FWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. layout 0: q/out (B, Tq, H*D), k/v
// (B, Tk, H*D); layout 1 (head-major): q/out (H, B, Tq, D), k/v
// (H, B, Tk, D). mask (B, Tk) one byte per key (nonzero = valid), all
// contiguous; D <= 128. lse (B, H, Tq) f32, or null when no backward
// follows. variant: 0 for K1; bit 0 bound_shift, bit 1 mxu_sum (the probe).
extern "C" int attention_blc_fwd(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* lse, int B,
                                 int Tq, int Tk, int H, int D, int dtype,
                                 int layout, int variant, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || Tq < 1 || Tk < 1 || H < 1 ||
      (dtype != 0 && dtype != 1) || layout < 0 || layout > 1 ||
      variant < 0 || variant > 3)
    return (int)cudaErrorInvalidValue;
  return (int)(D <= 64
      ? launch_fwd<64>(q, k, v, mask, out, lse, B, Tq, Tk, H, D, dtype,
                       layout == 1, variant, s)
      : launch_fwd<128>(q, k, v, mask, out, lse, B, Tq, Tk, H, D, dtype,
                        layout == 1, variant, s));
}

// Backward. q/out/dout and k/v/dk/dv in dtype and the forward's layout,
// lse (B, H, Tq) from the forward, dq f32 in q's layout and zeroed by the
// caller (the kernel adds into it), all contiguous; D <= 128.
extern "C" int attention_blc_bwd(const void* q, const void* k, const void* v,
                                 const void* mask, const void* out,
                                 const void* lse, const void* dout, void* dq,
                                 void* dk, void* dv, int B, int Tq, int Tk,
                                 int H, int D, int dtype, int layout,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || Tq < 1 || Tk < 1 || H < 1 ||
      layout < 0 || layout > 1)
    return (int)cudaErrorInvalidValue;
  const bool hm = layout == 1;
#define VILCO_BWD(T, DP) launch_bwd<T, DP>(q, k, v, mask, out, lse, dout, dq, dk, dv, B, Tq, Tk, H, D, hm, s)
  if (dtype == 0) return (int)(D <= 64 ? VILCO_BWD(float, 64) : VILCO_BWD(float, 128));
  if (dtype == 1) return (int)(D <= 64 ? VILCO_BWD(bf16, 64) : VILCO_BWD(bf16, 128));
#undef VILCO_BWD
  return (int)cudaErrorInvalidValue;
}
