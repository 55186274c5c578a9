// Transformer-XL relative attention, single stream: forward with dropout
// on the attention probabilities, and backward.
//
// Replaces vilco_tpu/kernels/xl_attention.py::xl_rel_attention (the Pallas
// _fwd_kernel run by _run_fwd, and _bwd_kernel run by _run_bwd). q/k/v (B, T, H, D), r (2T, H, D) = the
// projected embeddings of relative positions T .. -T+1, biases (H, D):
//   ac[i, j] = (q_i + r_w_bias) . k_j
//   bd[i, j] = (q_i + r_r_bias) . r[T + j - i]        (the relative shift)
//   P = softmax((ac + bd) * scale), with masked keys set to -1e9
//   out_i = sum_j drop(P)[i, j] (v_j * mask_j)
// drop(P) = P / (1 - rate) where the element's Philox bits (common.cuh) are
// >= rate 2^32, else 0; the online softmax sums every P into the row sum
// and only the kept ones into the output.
// A fully masked row softmaxes to uniform weights over zeroed values, so it
// gives 0, as the JAX model does.
//
// Design, both paths: one block per (query tile of 64 rows, head, batch),
// online softmax over key tiles. The TPU kernel needed a strided roll of the
// (S, 2T) position-score tile for the shift; here the shift is an index. For
// a tile of rows i0.. and keys j0.. the block stages the band
// r[T + j0 - i0 - 63 ..] (63 + BK rows) in shared memory, and row i, key j
// reads band row j - i + 63.
//  - bfloat16 (the serving path): 4 warps of 16 rows, key tiles of 64.
//    (q + r_w_bias) K^T, (q + r_r_bias) band^T (each warp only the 80 band
//    rows its 16 rows reach) and P V run on the tensor cores (WMMA
//    16x16x16, bf16 in, f32 accumulate), through shared memory, where two
//    lanes per row add the shifted position scores and do the softmax.
//    q + bias and P are rounded to bf16, as the TPU kernel's dots take them.
//  - float32 (the parity path): SIMT, one thread per row, key tiles of 32;
//    band rows padded by 4 floats so that eight neighbouring threads'
//    16-byte reads, on eight neighbouring rows, hit distinct banks. Bound
//    by FMA issue (3 * D FMAs per score).
// With `lse` set, the forward stores m + log2(l) per (batch, head, row).
//
// Backward (both dtypes, SIMT in f32): one block of 256 threads per (key
// tile, head, batch), tiles of 64 rows (32 at D > 64, to fit shared
// memory), keeps its K, V tile in shared memory and dk, dv in registers,
// and walks the query tiles, staging each tile's band of r:
//   P = exp2(x - lse) with x as in the forward;  Pd = drop(P)
//   dv += Pd^T dO (zeroed at masked keys);  dPd = dO (v mask)^T
//   dP = drop(dPd);  dS = P (dP - rowsum(dO O));  d_ac = scale dS
//   dk += d_ac^T (q + r_w_bias)
//   dq += d_ac K + d_raw r,  d_raw[i, T + j - i] = d_ac[i, j]  (the inverse
//         shift is the band index j - i + BQ - 1, no roll)
//   dr[T + j - i] += d_ac[i, j] (q_i + r_r_bias)   (per band row)
//   d r_w_bias += colsum(d_ac K), d r_r_bias += colsum(d_raw r)
// dq, dr and the bias grads sum over key tiles and batch: f32 atomicAdd
// into f32 buffers (order-dependent at f32 rounding). Bound by shared-memory
// operand reads; registers stay near 128 a thread (2 x 16 f32 dk/dv
// accumulators, 2 x 16 score/dP values).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int R = BQ + BK - 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e9f * LOG2E;   // -1e9 in the log2 domain

template <int DPAD> __host__ __device__ constexpr int rstride() { return DPAD + 4; }

template <int DPAD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)R * rstride<DPAD>() + 2 * BK * DPAD + DPAD + BK);
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(BQ)
xl_rel_attention_simt_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ r,
                             const T* __restrict__ rwb,
                             const T* __restrict__ rrb,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ out, float* __restrict__ lse,
                             int T_len, int H, int D, float scale_log2,
                             vilco::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);        // [R][DPAD + 4]
  float* ks = rs + R * rstride<DPAD>();              // [BK][DPAD]
  float* vs = ks + BK * DPAD;                        // [BK][DPAD]
  float* dlt = vs + BK * DPAD;                       // [DPAD]
  float* keep = dlt + DPAD;                          // [BK]

  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int i0 = blockIdx.x * BQ;
  const int i = i0 + tid;
  const bool active = i < T_len;
  const int C = H * D;

  // (r_r_bias - r_w_bias), so (q + r_r_bias) = (q + r_w_bias) + dlt
  for (int d = tid; d < DPAD; d += BQ)
    dlt[d] = d < D ? (vilco::to_f32<T>(rrb[h * D + d]) -
                      vilco::to_f32<T>(rwb[h * D + d])) * scale_log2
                   : 0.f;

  float qw[DPAD], o[DPAD];
  const T* qp = q + ((long long)b * T_len + (active ? i : 0)) * C + h * D;
#pragma unroll
  for (int d = 0; d < DPAD; ++d) {
    qw[d] = (active && d < D)
                ? (vilco::to_f32<T>(qp[d]) + vilco::to_f32<T>(rwb[h * D + d])) * scale_log2
                : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint8_t* mp = mask + (long long)b * T_len;

  for (int j0 = 0; j0 < T_len; j0 += BK) {
    for (int e = tid; e < BK * DPAD; e += BQ) {
      const int jj = e / DPAD, d = e % DPAD, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < T_len && d < D) {
        const long long off = ((long long)b * T_len + j) * C + h * D + d;
        kv = vilco::to_f32<T>(k[off]);
        vv = mp[j] ? vilco::to_f32<T>(v[off]) : 0.f;
      }
      ks[jj * DPAD + d] = kv;
      vs[jj * DPAD + d] = vv;
    }
    const int base = T_len + j0 - i0 - (BQ - 1);
    for (int e = tid; e < R * DPAD; e += BQ) {
      const int rr = e / DPAD, d = e % DPAD, src = base + rr;
      float x = 0.f;
      if (src >= 0 && src < 2 * T_len && d < D)
        x = vilco::to_f32<T>(r[(long long)src * C + h * D + d]);
      rs[rr * rstride<DPAD>() + d] = x;
    }
    for (int jj = tid; jj < BK; jj += BQ) {
      const int j = j0 + jj;
      keep[jj] = j < T_len ? (mp[j] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float* kr = ks + jj * DPAD;
      const float* rr = rs + (jj - tid + BQ - 1) * rstride<DPAD>();
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DPAD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        const float4 pp = *reinterpret_cast<const float4*>(rr + d);
        const float4 dd = *reinterpret_cast<const float4*>(dlt + d);
        acc = fmaf(qw[d], kk.x + pp.x, acc);
        acc = fmaf(qw[d + 1], kk.y + pp.y, acc);
        acc = fmaf(qw[d + 2], kk.z + pp.z, acc);
        acc = fmaf(qw[d + 3], kk.w + pp.w, acc);
        acc = fmaf(dd.x, pp.x, acc);
        acc = fmaf(dd.y, pp.y, acc);
        acc = fmaf(dd.z, pp.z, acc);
        acc = fmaf(dd.w, pp.w, acc);
      }
      const float kp = keep[jj];
      s[jj] = kp > 0.f ? acc : (kp == 0.f ? MASKED : -INFINITY);
      tmax = fmaxf(tmax, s[jj]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPAD; ++d) o[d] *= alpha;
    const unsigned long long e0 =
        (((unsigned long long)b * H + h) * T_len + i) * T_len + j0;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float p = exp2f(s[jj] - m_new);
      l += p;
      if (!drop.keep(e0 + jj)) p = 0.f;
      const float* vr = vs + jj * DPAD;
#pragma unroll
      for (int d = 0; d < DPAD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
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
    const float inv = drop.inv_keep / l;
    T* op = out + ((long long)b * T_len + i) * C + h * D;
#pragma unroll
    for (int d = 0; d < DPAD; ++d)
      if (d < D) op[d] = vilco::from_f32<T>(o[d] * inv);
    if (lse != nullptr)
      lse[((long long)b * H + h) * T_len + i] = m + log2f(l);
  }
}

// ---- bfloat16: tensor cores through WMMA ---------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

template <int DPAD>
struct TcLayout {
  static constexpr int BQ = 64, BK = 64, THREADS = 128;
  static constexpr int NBAND = BQ + BK;     // band rows staged (127 used)
  static constexpr int WBAND = 16 + BK;     // band rows one warp reaches
  static constexpr int LDQ = DPAD + 8;      // bf16 rows of Q, K, V, band
  static constexpr int LDS = BK + 4;        // f32 rows of S
  static constexpr int LDR = WBAND + 4;     // f32 rows of the position scores
  static constexpr int LDP = BK + 8;        // bf16 rows of P
  static constexpr int LDO = DPAD + 4;      // f32 rows of O
  // byte offsets, each a multiple of 128 (WMMA wants 32-byte alignment)
  static constexpr int QW_OFF = 0;
  static constexpr int QR_OFF = QW_OFF + BQ * LDQ * 2;
  static constexpr int K_OFF = QR_OFF + BQ * LDQ * 2;
  static constexpr int V_OFF = K_OFF + BK * LDQ * 2;
  static constexpr int R_OFF = V_OFF + BK * LDQ * 2;
  static constexpr int S_OFF = R_OFF + NBAND * LDQ * 2;
  static constexpr int RAW_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int P_OFF = RAW_OFF + BQ * LDR * 4;
  static constexpr int O_OFF = P_OFF + BQ * LDP * 2;
  static constexpr int KEEP_OFF = O_OFF + BQ * LDO * 4;
  static constexpr int BYTES = KEEP_OFF + BK * 4;
};

template <int DPAD>
__global__ void __launch_bounds__(128)
xl_rel_attention_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ r,
                           const bf16* __restrict__ rwb,
                           const bf16* __restrict__ rrb,
                           const uint8_t* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int T_len, int H, int D, float scale_log2,
                           bool vec, vilco::Dropout drop) {
  using L = TcLayout<DPAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qw = reinterpret_cast<bf16*>(smem + L::QW_OFF);
  bf16* qr = reinterpret_cast<bf16*>(smem + L::QR_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* rs = reinterpret_cast<bf16*>(smem + L::R_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* raw = reinterpret_cast<float*>(smem + L::RAW_OFF);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* keep = reinterpret_cast<float*>(smem + L::KEEP_OFF);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * L::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = H * D;
  const bf16 zero = __float2bfloat16(0.f);

  for (int e = tid; e < L::BQ * DPAD; e += L::THREADS) {
    const int rr = e / DPAD, d = e % DPAD, i = i0 + rr;
    bf16 a = zero, c = zero;
    if (i < T_len && d < D) {
      const float x = __bfloat162float(q[((long long)b * T_len + i) * C + h * D + d]);
      a = __float2bfloat16(x + __bfloat162float(rwb[h * D + d]));
      c = __float2bfloat16(x + __bfloat162float(rrb[h * D + d]));
    }
    qw[rr * L::LDQ + d] = a;
    qr[rr * L::LDQ + d] = c;
    os[rr * L::LDO + d] = 0.f;
  }
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  // first band row this warp's 16 rows reach, relative to the block's band
  const int c0 = L::BQ - 16 - warp * 16;
  float m = -INFINITY, l = 0.f;
  const uint8_t* mp = mask + (long long)b * T_len;

  for (int j0 = 0; j0 < T_len; j0 += L::BK) {
    __syncthreads();
    const int nk = min(L::BK, T_len - j0);
    const bf16* kb = k + ((long long)b * T_len + j0) * C + h * D;
    const bf16* vb = v + ((long long)b * T_len + j0) * C + h * D;
    const uint8_t* mj = mp + j0;
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(ks, L::BK, D, vec,
        [=](int rr) { return rr < nk ? kb + (long long)rr * C : nullptr; });
    // v is zeroed at masked keys
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(vs, L::BK, D, vec,
        [=](int rr) {
          return rr < nk && mj[rr] ? vb + (long long)rr * C : nullptr;
        });
    const int base = T_len + j0 - i0 - (L::BQ - 1);
    const bf16* rb = r + h * D;
    vilco::stage_rows<DPAD, L::LDQ, L::THREADS>(rs, L::NBAND, D, vec,
        [=](int rr) {
          const int src = base + rr;
          return src >= 0 && src < 2 * T_len ? rb + (long long)src * C
                                             : nullptr;
        });
    for (int jj = tid; jj < L::BK; jj += L::THREADS) {
      const int j = j0 + jj;
      keep[jj] = j < T_len ? (mp[j] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    // content scores: (q + r_w_bias) K^T
#pragma unroll
    for (int nb = 0; nb < L::BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qw + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(bt, ks + nb * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * L::LDS + nb * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    // position scores against the band rows c0 .. c0 + WBAND - 1
#pragma unroll
    for (int nb = 0; nb < L::WBAND / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DPAD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qr + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(
            bt, rs + (c0 + nb * 16) * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(raw + warp * 16 * L::LDR + nb * 16, acc, L::LDR,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // row `row`, key jj: band row jj - row + BQ - 1, local column minus c0
    float* srow = ss + row * L::LDS;
    const float* rrow = raw + row * L::LDR + (L::BQ - 1 - row - c0);
    float tmax = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int jj = 2 * c + half;    // interleaved: fewer bank conflicts
      const float kp = keep[jj];
      const float x = kp > 0.f ? (srow[jj] + rrow[jj]) * scale_log2
                               : (kp == 0.f ? MASKED : -INFINITY);
      srow[jj] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
    const unsigned long long e0 =
        (((unsigned long long)b * H + h) * T_len + i0 + row) * T_len + j0;
#pragma unroll 8
    for (int c = 0; c < L::BK / 2; ++c) {
      const int jj = 2 * c + half;
      const float p = exp2f(srow[jj] - m_new);
      psum += p;
      ps[row * L::LDP + jj] = __float2bfloat16(drop.keep(e0 + jj) ? p : 0.f);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = os + row * L::LDO;
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      orow[d] *= alpha;
    __syncwarp();

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

  const int i = i0 + row;
  if (i < T_len) {
    const float inv = drop.inv_keep / l;
    const float* orow = os + row * L::LDO;
    bf16* op = out + ((long long)b * T_len + i) * C + h * D;
    for (int d = half * (DPAD / 2); d < (half + 1) * (DPAD / 2); ++d)
      if (d < D) op[d] = __float2bfloat16(orow[d] * inv);
    if (lse != nullptr && half == 0)
      lse[((long long)b * H + h) * T_len + i] = m + log2f(l);
  }
}

template <int DPAD>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* r, const void* rwb, const void* rrb,
                        const void* mask, void* out, void* lse, int B,
                        int T_len, int H, int D, vilco::Dropout drop,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<DPAD>();
  auto kern = xl_rel_attention_simt_kernel<float, DPAD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kern<<<grid, BQ, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)r,
      (const float*)rwb, (const float*)rrb, (const uint8_t*)mask,
      (float*)out, (float*)lse, T_len, H, D, LOG2E / sqrtf((float)D), drop);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* r, const void* rwb, const void* rrb,
                      const void* mask, void* out, void* lse, int B,
                      int T_len, int H, int D, vilco::Dropout drop,
                      cudaStream_t stream) {
  using L = TcLayout<DPAD>;
  auto kern = xl_rel_attention_tc_kernel<DPAD>;
  const bool vec = D % 8 == 0 && (H * D) % 8 == 0 &&
                   (((uintptr_t)k | (uintptr_t)v | (uintptr_t)r) % 16) == 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + L::BQ - 1) / L::BQ, H, B);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)r,
      (const bf16*)rwb, (const bf16*)rrb, (const uint8_t*)mask, (bf16*)out,
      (float*)lse, T_len, H, D, LOG2E / sqrtf((float)D), vec, drop);
  return cudaGetLastError();
}

// ---- backward -------------------------------------------------------------

constexpr int BWD_THREADS = 256;   // 16 x 16

template <int DPAD> __host__ __device__ constexpr int bwd_tile() { return DPAD <= 64 ? 64 : 32; }

template <int DPAD>
constexpr size_t bwd_smem_bytes() {
  constexpr int BT = bwd_tile<DPAD>(), LD = DPAD + 1, LP = BT + 1;
  return sizeof(float) *
         ((size_t)6 * BT * LD + 2 * BT * LP + 3 * BT + 2 * DPAD);
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
xl_rel_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ r,
    const T* __restrict__ rwb, const T* __restrict__ rrb,
    const uint8_t* __restrict__ mask, const T* __restrict__ out,
    const float* __restrict__ lse, const T* __restrict__ dout,
    float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dr, float* __restrict__ drwb,
    float* __restrict__ drrb, int T_len, int H, int D, float scale_log2,
    float scale, vilco::Dropout drop) {
  constexpr int BT = bwd_tile<DPAD>(), LD = DPAD + 1, LP = BT + 1;
  constexpr int RA = BT / 16, CD = DPAD / 16, NB = 2 * BT;   // band rows
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [BT][LD] q (no bias)
  float* gs = qs + BT * LD;        // [BT][LD] dO
  float* ks = gs + BT * LD;        // [BT][LD]
  float* vs = ks + BT * LD;        // [BT][LD] v, zero at masked keys
  float* rs = vs + BT * LD;        // [NB][LD] band of r (2 * BT - 1 used)
  float* ps = rs + NB * LD;        // [BT][LP] drop(P)
  float* dss = ps + BT * LP;       // [BT][LP] dS
  float* keep = dss + BT * LP;     // [BT] 1 valid, 0 masked, -1 past T
  float* lses = keep + BT;         // [BT]
  float* delta = lses + BT;        // [BT]
  float* rw = delta + BT;          // [DPAD] r_w_bias
  float* rr = rw + DPAD;           // [DPAD] r_r_bias

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int C = H * D;
  const uint8_t* mp = mask + (long long)b * T_len;

  for (int d = tid; d < DPAD; d += BWD_THREADS) {
    rw[d] = d < D ? vilco::to_f32<T>(rwb[h * D + d]) : 0.f;
    rr[d] = d < D ? vilco::to_f32<T>(rrb[h * D + d]) : 0.f;
  }
  for (int e = tid; e < BT * DPAD; e += BWD_THREADS) {
    const int rrow = e / DPAD, d = e % DPAD, j = j0 + rrow;
    float kv = 0.f, vv = 0.f;
    if (j < T_len && d < D) {
      const long long off = ((long long)b * T_len + j) * C + h * D + d;
      kv = vilco::to_f32<T>(k[off]);
      vv = mp[j] ? vilco::to_f32<T>(v[off]) : 0.f;
    }
    ks[rrow * LD + d] = kv;
    vs[rrow * LD + d] = vv;
  }
  for (int jj = tid; jj < BT; jj += BWD_THREADS) {
    const int j = j0 + jj;
    keep[jj] = j < T_len ? (mp[j] ? 1.f : 0.f) : -1.f;
  }
  float dk_acc[RA][CD], dv_acc[RA][CD], cw[CD], cr[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    cw[c] = cr[c] = 0.f;
#pragma unroll
    for (int a = 0; a < RA; ++a) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }

  for (int i0 = 0; i0 < T_len; i0 += BT) {
    __syncthreads();   // the previous query tile is no longer read
    for (int e = tid; e < BT * DPAD; e += BWD_THREADS) {
      const int rrow = e / DPAD, d = e % DPAD, i = i0 + rrow;
      float qv = 0.f, gv = 0.f;
      if (i < T_len && d < D) {
        const long long off = ((long long)b * T_len + i) * C + h * D + d;
        qv = vilco::to_f32<T>(q[off]);
        gv = vilco::to_f32<T>(dout[off]);
      }
      qs[rrow * LD + d] = qv;
      gs[rrow * LD + d] = gv;
    }
    // band row mm holds r[T + j0 - i0 - (BT - 1) + mm]
    const int base = T_len + j0 - i0 - (BT - 1);
    for (int e = tid; e < NB * DPAD; e += BWD_THREADS) {
      const int mm = e / DPAD, d = e % DPAD, src = base + mm;
      rs[mm * LD + d] = (src >= 0 && src < 2 * T_len && d < D)
          ? vilco::to_f32<T>(r[(long long)src * C + h * D + d]) : 0.f;
    }
    for (int rrow = tid >> 2; rrow < BT; rrow += BWD_THREADS / 4) {
      const int part = tid & 3, i = i0 + rrow;
      float acc = 0.f;
      if (i < T_len) {
        const long long off = ((long long)b * T_len + i) * C + h * D;
        for (int d = part; d < D; d += 4)
          acc += vilco::to_f32<T>(out[off + d]) *
                 vilco::to_f32<T>(dout[off + d]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) {
        delta[rrow] = acc;
        lses[rrow] = i < T_len ? lse[((long long)b * H + h) * T_len + i]
                               : INFINITY;
      }
    }
    __syncthreads();

    // scores and dPd: query rows ty + 16a, keys tx + 16c
    float s[RA][RA], dp[RA][RA];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DPAD; ++d) {
      float qv[RA], gv[RA], kv[RA], vv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        qv[a] = qs[(ty + 16 * a) * LD + d];
        gv[a] = gs[(ty + 16 * a) * LD + d];
        kv[a] = ks[(tx + 16 * a) * LD + d];
        vv[a] = vs[(tx + 16 * a) * LD + d];
      }
      const float wd = rw[d], rd = rr[d];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < RA; ++c) {
          const float band =
              rs[(tx + 16 * c - ty - 16 * a + BT - 1) * LD + d];
          s[a][c] = fmaf(qv[a] + wd, kv[c], s[a][c]);
          s[a][c] = fmaf(qv[a] + rd, band, s[a][c]);
          dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        const int il = ty + 16 * a, jl = tx + 16 * c;
        const float kp = keep[jl];
        const float x = kp > 0.f ? s[a][c] * scale_log2
                                 : (kp == 0.f ? MASKED : -INFINITY);
        const float p = exp2f(x - lses[il]);
        const bool kept = drop.keep(
            (((unsigned long long)b * H + h) * T_len + i0 + il) * T_len +
            j0 + jl);
        ps[il * LP + jl] = kept ? p * drop.inv_keep : 0.f;
        const float dpk = kept ? dp[a][c] * drop.inv_keep : 0.f;
        dss[il * LP + jl] = p * (dpk - delta[il]);
      }
    __syncthreads();

    // dv += Pd^T dO, dk += dS^T (q + r_w_bias): key rows ty + 16a
#pragma unroll 2
    for (int il = 0; il < BT; ++il) {
      float pv[RA], sv[RA], gv[CD], qv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pv[a] = ps[il * LP + ty + 16 * a];
        sv[a] = dss[il * LP + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = gs[il * LD + tx + 16 * c];
        qv[c] = qs[il * LD + tx + 16 * c] + rw[tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[a][c] = fmaf(pv[a], gv[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(sv[a], qv[c], dk_acc[a][c]);
        }
    }
    // dq = scale (dS K + dS_shifted r): query rows ty + 16a
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int il = ty + 16 * a, i = i0 + il;
      float tw[CD], tr[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) tw[c] = tr[c] = 0.f;
      for (int jl = 0; jl < BT; ++jl) {
        const float sv = dss[il * LP + jl];
        const float* kr = ks + jl * LD + tx;
        const float* br = rs + (jl - il + BT - 1) * LD + tx;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          tw[c] = fmaf(sv, kr[16 * c], tw[c]);
          tr[c] = fmaf(sv, br[16 * c], tr[c]);
        }
      }
      if (i < T_len) {
        float* dqp = dq + ((long long)b * T_len + i) * C + h * D;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const int d = tx + 16 * c;
          cw[c] += tw[c];
          cr[c] += tr[c];
          if (d < D) atomicAdd(dqp + d, (tw[c] + tr[c]) * scale);
        }
      }
    }
    // dr: band row mm gets sum over the tile's (i, j = mm + i - BT + 1) of
    // dS[i, j] (q_i + r_r_bias)
    for (int mm = ty; mm < NB - 1; mm += 16) {
      const int src = base + mm;
      if (src < 0 || src >= 2 * T_len) continue;
      const int lo = max(0, BT - 1 - mm), hi = min(BT, 2 * BT - 1 - mm);
      float acc[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[c] = 0.f;
      for (int il = lo; il < hi; ++il) {
        const float sv = dss[il * LP + mm + il - BT + 1];
        const float* qr = qs + il * LD + tx;
#pragma unroll
        for (int c = 0; c < CD; ++c)
          acc[c] = fmaf(sv, qr[16 * c] + rr[tx + 16 * c], acc[c]);
      }
      float* drp = dr + (long long)src * C + h * D;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int d = tx + 16 * c;
        if (d < D) atomicAdd(drp + d, acc[c] * scale);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= T_len) continue;
    const long long off = ((long long)b * T_len + j) * C + h * D;
    const float vm = mp[j] ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[off + d] = vilco::from_f32<T>(dk_acc[a][c] * scale);
        dv[off + d] = vilco::from_f32<T>(dv_acc[a][c] * vm);
      }
    }
  }
  // bias grads: column sums over this block's rows, reduced over ty
  __syncthreads();
  float* red = qs;   // [16][2 * DPAD], in the q/dO/K/V tiles
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    red[ty * 2 * DPAD + tx + 16 * c] = cw[c];
    red[ty * 2 * DPAD + DPAD + tx + 16 * c] = cr[c];
  }
  __syncthreads();
  for (int e = tid; e < 2 * DPAD; e += BWD_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < 16; ++t) acc += red[t * 2 * DPAD + e];
    const int d = e % DPAD;
    if (d < D) atomicAdd((e < DPAD ? drwb : drrb) + h * D + d, acc * scale);
  }
}

template <typename T, int DPAD>
cudaError_t launch_bwd(const void* const* p, int B, int T_len, int H, int D,
                       vilco::Dropout drop, cudaStream_t stream) {
  auto kern = xl_rel_attention_bwd_kernel<T, DPAD>;
  const size_t smem = bwd_smem_bytes<DPAD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int BT = bwd_tile<DPAD>();
  const dim3 grid((T_len + BT - 1) / BT, H, B);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, BWD_THREADS, smem, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const uint8_t*)p[6],
      (const T*)p[7], (const float*)p[8], (const T*)p[9], (float*)p[10],
      (T*)p[11], (T*)p[12], (float*)p[13], (float*)p[14], (float*)p[15],
      T_len, H, D, scale * LOG2E, scale, drop);
  return cudaGetLastError();
}

}  // namespace

static vilco::Dropout make_dropout(const void* seed, int thresh,
                                   float inv_keep) {
  return vilco::Dropout{(const unsigned long long*)seed, (uint32_t)thresh,
                        inv_keep};
}

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out (B, T, H, D), r (2T, H, D),
// r_w_bias/r_r_bias (H, D), mask (B, T) one byte per key, all contiguous;
// D <= 128. lse (B, H, T) f32 or null. Dropout: seed points to one 64-bit
// seed on the device (null when thresh is 0), whose two 32-bit halves key
// Philox; keep iff bits >= thresh (0: no dropout), kept probabilities
// times inv_keep.
extern "C" int xl_rel_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* r,
                                    const void* rwb, const void* rrb,
                                    const void* mask, void* out, void* lse,
                                    const void* seed, int B, int T_len,
                                    int H, int D, int dtype, int thresh,
                                    float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || T_len < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const vilco::Dropout drop = make_dropout(seed, thresh, inv_keep);
  if (dtype == 0)
    return (int)(D <= 64
        ? launch_simt<64>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s)
        : launch_simt<128>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s));
  if (dtype == 1)
    return (int)(D <= 64
        ? launch_tc<64>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s)
        : launch_tc<128>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s));
  return (int)cudaErrorInvalidValue;
}

// Backward. Inputs as the forward's, plus out and lse from it and dout
// (B, T, H, D); dq (B, T, H, D), dr (2T, H, D), drwb and drrb (H, D) are
// f32 and zeroed by the caller (the kernel adds into them); dk, dv in dtype.
extern "C" int xl_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* r,
    const void* rwb, const void* rrb, const void* mask, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dr, void* drwb, void* drrb, const void* seed, int B, int T_len,
    int H, int D, int dtype, int thresh, float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || T_len < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const vilco::Dropout drop = make_dropout(seed, thresh, inv_keep);
  const void* p[16] = {q, k, v, r, rwb, rrb, mask, out, lse, dout,
                       dq, dk, dv, dr, drwb, drrb};
  if (dtype == 0)
    return (int)(D <= 64 ? launch_bwd<float, 64>(p, B, T_len, H, D, drop, s)
                         : launch_bwd<float, 128>(p, B, T_len, H, D, drop, s));
  if (dtype == 1)
    return (int)(D <= 64 ? launch_bwd<bf16, 64>(p, B, T_len, H, D, drop, s)
                         : launch_bwd<bf16, 128>(p, B, T_len, H, D, drop, s));
  return (int)cudaErrorInvalidValue;
}
