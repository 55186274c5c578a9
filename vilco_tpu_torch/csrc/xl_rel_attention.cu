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
// a tile of rows i0.. and keys j0.. row i and key j read band row
// j - i + 63 of r[T + j0 - i0 - 63 ..].
//  - bfloat16 (the serving path): FlashAttention-2 on mma.sync (bf16 in,
//    f32 accumulate), on K1's model (csrc/attention_blc.cu): 4 warps, each
//    owning two strips of 16 query rows (one where D > 64), key tiles of
//    64. Each warp keeps bf16(q + r_w_bias) as A fragments in registers
//    (q + bias rounded as the TPU kernel's dots take them), and S, P and O
//    in its accumulators. The position term of a key tile is, per strip,
//    the 16 x 80 raw tile (q + r_r_bias) band^T over the 80 band rows the
//    strip reaches, put in the warp's own f32 tile in shared memory and
//    read back sheared into S. Then scale, key flags and the online
//    softmax, with quad shuffles; P is rounded to bf16 A fragments straight
//    from the accumulators (zero where dropped or at a masked key, every P
//    into l), and O += P V reads V by ldmatrix.trans. K and V tiles and
//    the band stream through cp.async rings (two stages; the band MS + 2
//    chunks of 64 rows, each tile staging one), so tile t+1 loads while
//    tile t is in the tensor cores: 112 KB of shared memory at D 64, two
//    blocks an SM. The keep bits are drawn in a loop kept rolled: Philox
//    inlined per element made the kernel body too large to run fast, with
//    dropout or without. What bounds it: not the tensor cores but issue
//    and latency with 8 warps an SM (104 mma a key tile and strip, where
//    K1 does 64, the raw tile's round trip, the exp2 per score), and with
//    dropout the Philox bits (10 rounds per element).
//  - float32 (the parity path): SIMT, one thread per row, key tiles of 32,
//    the band (63 + 32 rows) staged per tile; band rows padded by 4 floats
//    so that eight neighbouring threads' 16-byte reads, on eight
//    neighbouring rows, hit distinct banks. Bound by FMA issue (3 * D FMAs
//    per score).
// With `lse` set, the forward stores m + log2(l) per (batch, head, row).
//
// Backward: five passes, each output element written once by one thread
// and every sum taken in a fixed order, so two calls give equal bits
// (kernels/xl_attention.py::xl_bwd_plain is the same passes in plain
// PyTorch), on csrc/attention_blc_bwd.cu's model (K1's backward). With P = exp2(x - lse) (x as in the forward, lse the
// forward's m + log2 l), Pd = drop(P), dP = drop(dO (v mask)^T) and
// dS = P (dP - delta):
//  1. delta = rowsum(dO O) per (batch, head, row) (attention_blc.cuh);
//  2. dk/dv: one block per (key tile, head, batch) walks the query tiles:
//     dv += Pd^T dO (zero at masked keys), dk += scale dS^T (q + r_w_bias);
//  3. dq: one block per (query tile, head, batch) walks the key tiles:
//     dq = scale (dS K + dS_sh r), dS_sh[i, T + j - i] = dS[i, j] (the
//     inverse shift is a band index, no roll); the tile's column sums of
//     the two terms are its partials of d r_w_bias and d r_r_bias;
//  4. dr: one block per (tile of r's positions, head) walks the batch and
//     then the query tiles: position p and query i meet key p - T + i, so
//     a tile pair needs a band of 127 keys; dr += scale dS^T (q + r_r_bias).
//     Keys outside [0, T) contribute 0, and so r's row 0 gets 0;
//  5. the partials summed over (batch, query tile) in order.
//  - bfloat16 (the training path): every product on mma.sync (bf16 in, f32
//    accumulate), 4 warps of 16 query rows, tiles of 64. Scores: q + r_w_bias
//    and q + r_r_bias rounded to bf16 as the forward rounds them. A warp's
//    16 rows reach 80 rows of the 128-row band (of r in passes 2 and 3, of
//    keys in pass 4): it computes its 16 x 80 raw tile, stores it to its own
//    f32 tile in shared memory and reads it back sheared. Pass 3 writes dS
//    sheared into a bf16 tile, the A operand of dS_sh r. Passes 2 and 4
//    turn P and dS around through shared memory (bf16, ldmatrix.trans) to
//    accumulate by key or position rows. P and dS are rounded to bf16
//    before their products, as the TPU kernel rounds them. Each pass
//    recomputes the scores of its tiles; pass 2 draws the keep bits (Philox
//    per element) and stores them, 64 keys a word, for passes 3 and 4.
//    Tiles are staged by cp.async; pass 4 starts the position tiles that
//    meet the most query tiles first. Not bound by the tensor cores: the
//    staging latency between products and the per-element exp2 and Philox
//    work bound it, with 2 blocks of 4 warps an SM (~100 KB of shared
//    memory each).
//  - float32 (the parity path): the same passes in SIMT, 256 threads of
//    16 x 16, tiles of 64 (32 at D > 64), operands from shared memory, the
//    keep bits drawn in each pass.
#include "attention_blc.cuh"

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

// ---- backward, and the bf16 forward's arguments ---------------------------
//
// Five passes (the header): 1 delta, attention_blc.cuh's kernel; 2 dk/dv,
// 3 dq and the bias partials, 4 dr, in bf16 on mma.sync or in SIMT; 5 the
// partials' sum. Each output element is written once.

// The inputs (the forward reads these and null lse, dout) and the
// backward's outputs and scratch
struct XlArgs {
  const void *q, *k, *v, *r, *rwb, *rrb, *mask, *lse, *dout;
  void *dq, *dk, *dv, *dr, *drwb, *drrb;
  const float* delta;
  float* partial;   // [2][B * query tiles][H * D]: r_w_bias's, r_r_bias's
  // bf16 with dropout: the keep bits, (B, H, T) rows of ceil(T / 64) words
  // (bit j % 64 of word j / 64: key j), drawn by pass 2 for passes 3 and 4
  unsigned long long* bits;
  int B, T, H, D;
  float scale, scale_log2;
  vilco::Dropout drop;
};

// key j of a batch row's mask mp: 1 valid, 0 masked, -1 outside [0, T)
__device__ __forceinline__ float key_flag(const uint8_t* mp, int j, int T) {
  return j >= 0 && j < T ? (mp[j] ? 1.f : 0.f) : -1.f;
}

// the log2-domain score x of a key of flag fl (masked: -1e9 log2 e,
// outside: -inf, so that P is 0 there)
__device__ __forceinline__ float flagged(float fl, float x) {
  return fl > 0.f ? x : (fl == 0.f ? MASKED : -INFINITY);
}

// ---- backward, SIMT (float32) ---------------------------------------------

constexpr int BWD_THREADS = 256;   // 16 x 16

template <int DPAD> __host__ __device__ constexpr int bwd_tile() { return DPAD <= 64 ? 64 : 32; }

// Shared memory of the SIMT passes, f32 rows of DPAD + 1: q (no bias) and
// dO of a query tile, K and V (a key tile, or pass 4's 2 BT - 1 band
// keys), a band of r (2 BT - 1 rows; pass 4: its position tile), P and dS
// (rows of BT + 1), the key flags, lse, delta, the two biases.
template <int DPAD>
struct SimtSmem {
  static constexpr int BT = bwd_tile<DPAD>(), LD = DPAD + 1, LP = BT + 1;
  static constexpr int NB = 2 * BT;
  float *qs, *gs, *ks, *vs, *rs, *ps, *dss, *keep, *lses, *delta, *rw, *rr;
  __device__ explicit SimtSmem(float* sm)
      : qs(sm), gs(qs + BT * LD), ks(gs + BT * LD), vs(ks + NB * LD),
        rs(vs + NB * LD), ps(rs + NB * LD), dss(ps + BT * LP),
        keep(dss + BT * LP), lses(keep + NB), delta(lses + BT),
        rw(delta + BT), rr(rw + DPAD) {}
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)(2 * BT + 3 * NB) * LD + 2 * BT * LP +
                            NB + 2 * BT + 2 * DPAD);
  }
};

// rows of a head into f32 rows of DPAD + 1: src(row) its first element, or
// null for a zero row; zero past D
template <typename T, int DPAD, typename RowSrc>
__device__ __forceinline__ void simt_stage(float* dst, int rows, int D,
                                           RowSrc src) {
  for (int e = threadIdx.x; e < rows * DPAD; e += BWD_THREADS) {
    const int rr = e / DPAD, d = e % DPAD;
    const T* g = src(rr);
    dst[rr * (DPAD + 1) + d] =
        (g != nullptr && d < D) ? vilco::to_f32<T>(g[d]) : 0.f;
  }
}

// The biases of head h, lse and delta of query rows i0 .. i0 + BT - 1 of
// (b, h) (rows past T: lse +inf, so their P is 0), q and dO of those rows.
template <typename T, int DPAD>
__device__ __forceinline__ void simt_stage_queries(const SimtSmem<DPAD>& sm,
                                                   const XlArgs& a, int b,
                                                   int h, int i0) {
  constexpr int BT = SimtSmem<DPAD>::BT;
  const long long C = (long long)a.H * a.D, hd = (long long)h * a.D;
  const int nq = min(BT, a.T - i0);
  const T* q0 = (const T*)a.q + ((long long)b * a.T + i0) * C + hd;
  const T* g0 = (const T*)a.dout + ((long long)b * a.T + i0) * C + hd;
  simt_stage<T, DPAD>(sm.qs, BT, a.D,
                      [&](int rr) { return rr < nq ? q0 + rr * C : nullptr; });
  simt_stage<T, DPAD>(sm.gs, BT, a.D,
                      [&](int rr) { return rr < nq ? g0 + rr * C : nullptr; });
  const long long at = ((long long)b * a.H + h) * a.T + i0;
  for (int rr = threadIdx.x; rr < BT; rr += BWD_THREADS) {
    sm.lses[rr] = rr < nq ? ((const float*)a.lse)[at + rr] : INFINITY;
    sm.delta[rr] = rr < nq ? a.delta[at + rr] : 0.f;
  }
  for (int d = threadIdx.x; d < DPAD; d += BWD_THREADS) {
    sm.rw[d] = d < a.D ? vilco::to_f32<T>(((const T*)a.rwb)[hd + d]) : 0.f;
    sm.rr[d] = d < a.D ? vilco::to_f32<T>(((const T*)a.rrb)[hd + d]) : 0.f;
  }
}

// `rows` keys from j0 of batch b into ks, vs (v zero at masked keys) and
// their flags
template <typename T, int DPAD>
__device__ __forceinline__ void simt_stage_keys(const SimtSmem<DPAD>& sm,
                                                const XlArgs& a, int b, int h,
                                                int j0, int rows) {
  const long long C = (long long)a.H * a.D;
  const uint8_t* mp = (const uint8_t*)a.mask + (long long)b * a.T;
  const T* k0 = (const T*)a.k + (long long)b * a.T * C + (long long)h * a.D;
  const T* v0 = (const T*)a.v + (long long)b * a.T * C + (long long)h * a.D;
  simt_stage<T, DPAD>(sm.ks, rows, a.D, [&](int rr) {
    const int j = j0 + rr;
    return j >= 0 && j < a.T ? k0 + j * C : nullptr;
  });
  simt_stage<T, DPAD>(sm.vs, rows, a.D, [&](int rr) {
    const int j = j0 + rr;
    return j >= 0 && j < a.T && mp[j] ? v0 + j * C : nullptr;
  });
  for (int rr = threadIdx.x; rr < rows; rr += BWD_THREADS)
    sm.keep[rr] = key_flag(mp, j0 + rr, a.T);
}

// `rows` rows of r from p0 (zero outside [0, 2T)) into rs
template <typename T, int DPAD>
__device__ __forceinline__ void simt_stage_r(const SimtSmem<DPAD>& sm,
                                             const XlArgs& a, int h, int p0,
                                             int rows) {
  const long long C = (long long)a.H * a.D;
  const T* r0 = (const T*)a.r + (long long)h * a.D;
  simt_stage<T, DPAD>(sm.rs, rows, a.D, [&](int rr) {
    const int p = p0 + rr;
    return p >= 0 && p < 2 * a.T ? r0 + p * C : nullptr;
  });
}

// P (dropped, into ps with `with_p`) and dS (into dss) of the staged query
// tile (rows i0 + il of batch b) against the staged columns: thread (ty,
// tx) takes rows ty + 16a and columns tx + 16c. A column is
//  - (BY_POS false) key j0 + jl: K, V and flag row jl, r band row
//    jl - il + BT - 1 (r[T + j - i]);
//  - (BY_POS true) position p0 + pl: r row pl, and key j0 + pl + il at K,
//    V and flag row pl + il (pass 4; j0 = p0 - T + i0).
template <int DPAD, bool BY_POS>
__device__ __forceinline__ void simt_p_ds(const SimtSmem<DPAD>& sm,
                                          const XlArgs& a, int b, int h,
                                          int i0, int j0, bool with_p,
                                          int tx, int ty) {
  constexpr int BT = SimtSmem<DPAD>::BT, LD = SimtSmem<DPAD>::LD;
  constexpr int LP = SimtSmem<DPAD>::LP, RA = BT / 16;
  float s[RA][RA], dp[RA][RA];
#pragma unroll
  for (int x = 0; x < RA; ++x)
#pragma unroll
    for (int c = 0; c < RA; ++c) s[x][c] = dp[x][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DPAD; ++d) {
    const float wd = sm.rw[d], rd = sm.rr[d];
    float qv[RA], gv[RA];
#pragma unroll
    for (int x = 0; x < RA; ++x) {
      qv[x] = sm.qs[(ty + 16 * x) * LD + d];
      gv[x] = sm.gs[(ty + 16 * x) * LD + d];
    }
    if constexpr (BY_POS) {
      float rv[RA];
#pragma unroll
      for (int c = 0; c < RA; ++c) rv[c] = sm.rs[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int x = 0; x < RA; ++x)
#pragma unroll
        for (int c = 0; c < RA; ++c) {
          const int kr = (tx + 16 * c + ty + 16 * x) * LD + d;
          s[x][c] = fmaf(qv[x] + wd, sm.ks[kr], s[x][c]);
          s[x][c] = fmaf(qv[x] + rd, rv[c], s[x][c]);
          dp[x][c] = fmaf(gv[x], sm.vs[kr], dp[x][c]);
        }
    } else {
      float kv[RA], vv[RA];
#pragma unroll
      for (int c = 0; c < RA; ++c) {
        kv[c] = sm.ks[(tx + 16 * c) * LD + d];
        vv[c] = sm.vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int x = 0; x < RA; ++x)
#pragma unroll
        for (int c = 0; c < RA; ++c) {
          const float band =
              sm.rs[(tx + 16 * c - ty - 16 * x + BT - 1) * LD + d];
          s[x][c] = fmaf(qv[x] + wd, kv[c], s[x][c]);
          s[x][c] = fmaf(qv[x] + rd, band, s[x][c]);
          dp[x][c] = fmaf(gv[x], vv[c], dp[x][c]);
        }
    }
  }
#pragma unroll
  for (int x = 0; x < RA; ++x)
#pragma unroll
    for (int c = 0; c < RA; ++c) {
      const int il = ty + 16 * x, cl = tx + 16 * c;
      const int kr = BY_POS ? cl + il : cl;
      const float fl = sm.keep[kr];
      const float p = exp2f(flagged(fl, s[x][c] * a.scale_log2) - sm.lses[il]);
      const unsigned long long e =
          (((unsigned long long)b * a.H + h) * a.T + i0 + il) * a.T + j0 + kr;
      const float mul = fl >= 0.f && a.drop.keep(e) ? a.drop.inv_keep : 0.f;
      if (with_p) sm.ps[il * LP + cl] = p * mul;
      sm.dss[il * LP + cl] = p * (dp[x][c] * mul - sm.delta[il]);
    }
}

// Pass 2: one block per (key tile, head, batch) walks the query tiles:
// dv += Pd^T dO, dk += dS^T (q + r_w_bias), key rows ty + 16a.
template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
xl_bwd_dkv_simt_kernel(XlArgs a) {
  using S = SimtSmem<DPAD>;
  constexpr int BT = S::BT, LD = S::LD, LP = S::LP;
  constexpr int RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float smf[];
  const S sm(smf);
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  simt_stage_keys<T, DPAD>(sm, a, b, h, j0, BT);
  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int x = 0; x < RA; ++x)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[x][c] = dv_acc[x][c] = 0.f;

  for (int i0 = 0; i0 < a.T; i0 += BT) {
    __syncthreads();   // the previous query tile is no longer read
    simt_stage_queries<T, DPAD>(sm, a, b, h, i0);
    simt_stage_r<T, DPAD>(sm, a, h, a.T + j0 - i0 - (BT - 1), S::NB);
    __syncthreads();
    simt_p_ds<DPAD, false>(sm, a, b, h, i0, j0, true, tx, ty);
    __syncthreads();
#pragma unroll 2
    for (int il = 0; il < BT; ++il) {
      float pv[RA], sv[RA], gv[CD], qv[CD];
#pragma unroll
      for (int x = 0; x < RA; ++x) {
        pv[x] = sm.ps[il * LP + ty + 16 * x];
        sv[x] = sm.dss[il * LP + ty + 16 * x];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = sm.gs[il * LD + tx + 16 * c];
        qv[c] = sm.qs[il * LD + tx + 16 * c] + sm.rw[tx + 16 * c];
      }
#pragma unroll
      for (int x = 0; x < RA; ++x)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[x][c] = fmaf(pv[x], gv[c], dv_acc[x][c]);
          dk_acc[x][c] = fmaf(sv[x], qv[c], dk_acc[x][c]);
        }
    }
  }
  const long long C = (long long)a.H * a.D;
#pragma unroll
  for (int x = 0; x < RA; ++x) {
    const int jl = ty + 16 * x, j = j0 + jl;
    if (j >= a.T) continue;
    const long long off = ((long long)b * a.T + j) * C + (long long)h * a.D;
    const float vm = sm.keep[jl] > 0.f ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) {
        ((T*)a.dk)[off + d] = vilco::from_f32<T>(dk_acc[x][c] * a.scale);
        ((T*)a.dv)[off + d] = vilco::from_f32<T>(dv_acc[x][c] * vm);
      }
    }
  }
}

// Pass 3: one block per (query tile, head, batch) walks the key tiles:
// dq = scale (dS K + dS_sh r), query rows ty + 16a, written once; the
// column sums of the two terms over the tile's rows are its bias partials.
template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
xl_bwd_dq_simt_kernel(XlArgs a) {
  using S = SimtSmem<DPAD>;
  constexpr int BT = S::BT, LD = S::LD, LP = S::LP;
  constexpr int RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float smf[];
  const S sm(smf);
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  simt_stage_queries<T, DPAD>(sm, a, b, h, i0);
  float tw[RA][CD], tr[RA][CD];
#pragma unroll
  for (int x = 0; x < RA; ++x)
#pragma unroll
    for (int c = 0; c < CD; ++c) tw[x][c] = tr[x][c] = 0.f;

  for (int j0 = 0; j0 < a.T; j0 += BT) {
    __syncthreads();   // the previous key tile is no longer read
    simt_stage_keys<T, DPAD>(sm, a, b, h, j0, BT);
    simt_stage_r<T, DPAD>(sm, a, h, a.T + j0 - i0 - (BT - 1), S::NB);
    __syncthreads();
    simt_p_ds<DPAD, false>(sm, a, b, h, i0, j0, false, tx, ty);
    __syncthreads();
#pragma unroll
    for (int x = 0; x < RA; ++x) {
      const int il = ty + 16 * x;
      for (int jl = 0; jl < BT; ++jl) {
        const float sv = sm.dss[il * LP + jl];
        const float* kr = sm.ks + jl * LD + tx;
        const float* br = sm.rs + (jl - il + BT - 1) * LD + tx;
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          tw[x][c] = fmaf(sv, kr[16 * c], tw[x][c]);
          tr[x][c] = fmaf(sv, br[16 * c], tr[x][c]);
        }
      }
    }
  }
  const long long C = (long long)a.H * a.D;
  float cw[CD], cr[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) cw[c] = cr[c] = 0.f;
#pragma unroll
  for (int x = 0; x < RA; ++x) {
    const int i = i0 + ty + 16 * x;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      cw[c] += tw[x][c];
      cr[c] += tr[x][c];
      const int d = tx + 16 * c;
      if (i < a.T && d < a.D)
        ((T*)a.dq)[((long long)b * a.T + i) * C + (long long)h * a.D + d] =
            vilco::from_f32<T>((tw[x][c] + tr[x][c]) * a.scale);
    }
  }
  // bias partials: the 16 thread rows' column sums, added in row order
  __syncthreads();
  float* red = sm.qs;   // [16][2 DPAD], in the q and dO tiles
#pragma unroll
  for (int c = 0; c < CD; ++c) {
    red[ty * 2 * DPAD + tx + 16 * c] = cw[c];
    red[ty * 2 * DPAD + DPAD + tx + 16 * c] = cr[c];
  }
  __syncthreads();
  const long long n = (long long)a.B * gridDim.x * C;
  for (int e = tid; e < 2 * DPAD; e += BWD_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < 16; ++t) acc += red[t * 2 * DPAD + e];
    const int d = e % DPAD;
    if (d < a.D)
      a.partial[(e < DPAD ? 0 : n) +
                ((long long)b * gridDim.x + blockIdx.x) * C +
                (long long)h * a.D + d] = acc * a.scale;
  }
}

// Pass 4: one block per (position tile, head) walks the batch and then the
// query tiles whose band of keys j = p - T + i meets [0, T): dr += dS^T (q
// + r_r_bias), position rows ty + 16a, written once.
template <typename T, int DPAD>
__global__ void __launch_bounds__(BWD_THREADS)
xl_bwd_dr_simt_kernel(XlArgs a) {
  using S = SimtSmem<DPAD>;
  constexpr int BT = S::BT, LD = S::LD, LP = S::LP;
  constexpr int RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float smf[];
  const S sm(smf);
  const int h = blockIdx.y, p0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  simt_stage_r<T, DPAD>(sm, a, h, p0, BT);
  float acc[RA][CD];
#pragma unroll
  for (int x = 0; x < RA; ++x)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[x][c] = 0.f;

  for (int b = 0; b < a.B; ++b)
    for (int i0 = 0; i0 < a.T; i0 += BT) {
      const int jb = p0 - a.T + i0;   // key of position p0, query i0
      if (jb + 2 * BT - 2 < 0 || jb >= a.T) continue;
      __syncthreads();   // the previous query tile is no longer read
      simt_stage_queries<T, DPAD>(sm, a, b, h, i0);
      simt_stage_keys<T, DPAD>(sm, a, b, h, jb, S::NB);
      __syncthreads();
      simt_p_ds<DPAD, true>(sm, a, b, h, i0, jb, false, tx, ty);
      __syncthreads();
#pragma unroll 2
      for (int il = 0; il < BT; ++il) {
        float sv[RA], qv[CD];
#pragma unroll
        for (int x = 0; x < RA; ++x) sv[x] = sm.dss[il * LP + ty + 16 * x];
#pragma unroll
        for (int c = 0; c < CD; ++c)
          qv[c] = sm.qs[il * LD + tx + 16 * c] + sm.rr[tx + 16 * c];
#pragma unroll
        for (int x = 0; x < RA; ++x)
#pragma unroll
          for (int c = 0; c < CD; ++c)
            acc[x][c] = fmaf(sv[x], qv[c], acc[x][c]);
      }
    }
  const long long C = (long long)a.H * a.D;
#pragma unroll
  for (int x = 0; x < RA; ++x) {
    const int p = p0 + ty + 16 * x;
    if (p >= 2 * a.T) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D)
        ((T*)a.dr)[(long long)p * C + (long long)h * a.D + d] =
            vilco::from_f32<T>(acc[x][c] * a.scale);
    }
  }
}

// ---- bfloat16 on mma.sync: the forward and the backward's passes ---------
//
// 4 warps, tiles of 64. 16 query rows (a warp's, or a strip of them in the
// forward) reach 80 rows of the band (of r in the forward and passes 2 and
// 3, of keys in pass 4): the warp computes their 16 x 80 raw tile on the
// tensor cores into its own f32 tile in shared memory and reads it back
// sheared.

template <int DPAD>
struct XlTile {
  static constexpr int THREADS = 128, BT = 64, NBAND = 128, WBAND = 80;
  static constexpr int LD = DPAD + 8;      // bf16 rows: q + biases, dO, K, V, r
  static constexpr int LDR = WBAND + 4;    // f32 rows of a warp's raw tile
  static constexpr int LDP = BT + 8;       // bf16 rows of P, dS
  static constexpr int LDH = WBAND + 8;    // bf16 rows of a warp's sheared dS
  static constexpr int TILE = BT * LD * 2, BAND = NBAND * LD * 2;   // bytes
  static constexpr int RAW = 4 * 16 * LDR * 4, PT = BT * LDP * 2;
  static constexpr int SH = 4 * 16 * LDH * 2, ROW = BT * 4, BIAS = DPAD * 4;
};

// The biases of head h as f32, zero past D
template <int DPAD>
__device__ __forceinline__ void tc_biases(float* bw, float* br, const XlArgs& a,
                                          int h) {
  const bf16* w = (const bf16*)a.rwb + (long long)h * a.D;
  const bf16* rr = (const bf16*)a.rrb + (long long)h * a.D;
  for (int d = threadIdx.x; d < DPAD; d += XlTile<DPAD>::THREADS) {
    bw[d] = d < a.D ? __bfloat162float(w[d]) : 0.f;
    br[d] = d < a.D ? __bfloat162float(rr[d]) : 0.f;
  }
}

// Rows of a head into bf16 shared rows of LD: src(row) its first element,
// or null for a zero row; zero past D. 16-byte cp.async where vec (a row
// that reads nothing is zero-filled, `any` a valid global address for it),
// else plain stores: visible after cp_async_wait and a barrier.
template <int DPAD, typename RowSrc>
__device__ __forceinline__ void tc_stage(bf16* dst, int rows, int D, bool vec,
                                         const bf16* any, RowSrc src) {
  using L = XlTile<DPAD>;
  if (vec) {
    constexpr int CH = DPAD / 8;
    for (int e = threadIdx.x; e < rows * CH; e += L::THREADS) {
      const int rr = e / CH, c = (e % CH) * 8;
      const bf16* g = src(rr);
      const bool ok = g != nullptr && c < D;
      cp_async16(dst + rr * L::LD + c, ok ? g + c : any, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < rows * DPAD; e += L::THREADS) {
      const int rr = e / DPAD, c = e % DPAD;
      const bf16* g = src(rr);
      dst[rr * L::LD + c] = (g != nullptr && c < D) ? g[c] : zero;
    }
  }
}

// Query rows i0 .. i0 + 63 of batch b: q into qw (tc_add_biases turns it
// into q + r_w_bias and q + r_r_bias), dO, and with lses, their lse and
// delta (rows past T: lse +inf, so their P is 0)
template <int DPAD>
__device__ __forceinline__ void tc_stage_queries(bf16* qw, bf16* gs,
                                                 float* lses, float* dels,
                                                 const XlArgs& a, int b, int h,
                                                 int i0, bool vec) {
  using L = XlTile<DPAD>;
  const long long C = (long long)a.H * a.D;
  const long long off = ((long long)b * a.T + i0) * C + (long long)h * a.D;
  const bf16* q0 = (const bf16*)a.q + off;
  const bf16* g0 = (const bf16*)a.dout + off;
  const int nq = min(L::BT, a.T - i0);
  tc_stage<DPAD>(qw, L::BT, a.D, vec, q0,
                 [=](int rr) { return rr < nq ? q0 + rr * C : nullptr; });
  tc_stage<DPAD>(gs, L::BT, a.D, vec, g0,
                 [=](int rr) { return rr < nq ? g0 + rr * C : nullptr; });
  if (lses == nullptr) return;
  const long long at = ((long long)b * a.H + h) * a.T + i0;
  for (int rr = threadIdx.x; rr < L::BT; rr += L::THREADS) {
    lses[rr] = rr < nq ? ((const float*)a.lse)[at + rr] : INFINITY;
    dels[rr] = rr < nq ? a.delta[at + rr] : 0.f;
  }
}

// The staged q rows (in qw) as bf16(q + r_w_bias) into qw and bf16(q +
// r_r_bias) into qr, as the TPU kernel's dots take them; rows from nq stay
// zero (bw, br are zero past D)
template <int DPAD>
__device__ __forceinline__ void tc_add_biases(bf16* qw, bf16* qr,
                                              const float* bw,
                                              const float* br, int nq) {
  using L = XlTile<DPAD>;
  constexpr int HALF = DPAD / 2;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int e = threadIdx.x; e < L::BT * HALF; e += L::THREADS) {
    const int rr = e / HALF, c = (e % HALF) * 2;
    auto* w = reinterpret_cast<__nv_bfloat162*>(qw + rr * L::LD + c);
    auto* p = reinterpret_cast<__nv_bfloat162*>(qr + rr * L::LD + c);
    const float2 x = __bfloat1622float2(*w);
    const bool ok = rr < nq;
    *p = ok ? __floats2bfloat162_rn(x.x + br[c], x.y + br[c + 1]) : zero;
    *w = ok ? __floats2bfloat162_rn(x.x + bw[c], x.y + bw[c + 1]) : zero;
  }
}

// `rows` keys from j0 of batch b into ks, vs (v zero at masked keys) and
// their flags
template <int DPAD>
__device__ __forceinline__ void tc_stage_keys(bf16* ks, bf16* vs, float* keep,
                                              const XlArgs& a, int b, int h,
                                              int j0, int rows, bool vec) {
  using L = XlTile<DPAD>;
  const long long C = (long long)a.H * a.D;
  const long long off = (long long)b * a.T * C + (long long)h * a.D;
  const bf16* k0 = (const bf16*)a.k + off;
  const bf16* v0 = (const bf16*)a.v + off;
  const uint8_t* mp = (const uint8_t*)a.mask + (long long)b * a.T;
  const int T_len = a.T;
  tc_stage<DPAD>(ks, rows, a.D, vec, k0, [=](int rr) {
    const int j = j0 + rr;
    return j >= 0 && j < T_len ? k0 + j * C : nullptr;
  });
  tc_stage<DPAD>(vs, rows, a.D, vec, v0, [=](int rr) {
    const int j = j0 + rr;
    return j >= 0 && j < T_len && mp[j] ? v0 + j * C : nullptr;
  });
  for (int rr = threadIdx.x; rr < rows; rr += L::THREADS)
    keep[rr] = key_flag(mp, j0 + rr, T_len);
}

// `rows` rows of r from p0 (zero outside [0, 2T)) into rs
template <int DPAD>
__device__ __forceinline__ void tc_stage_r(bf16* rs, const XlArgs& a, int h,
                                           int p0, int rows, bool vec) {
  const long long C = (long long)a.H * a.D;
  const bf16* r0 = (const bf16*)a.r + (long long)h * a.D;
  const int n = 2 * a.T;
  tc_stage<DPAD>(rs, rows, a.D, vec, r0, [=](int rr) {
    const int p = p0 + rr;
    return p >= 0 && p < n ? r0 + p * C : nullptr;
  });
}

// cp.async copies issued since the last wait, then a barrier
__device__ __forceinline__ void tc_landed() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// x = A B^T over the warp's 16 rows of A (from r0) and NT n8 tiles of B's
// rows from n0 (both row-major, k over DPAD), into acc (zeroed here)
template <int DPAD, int NT>
__device__ __forceinline__ void tc_abt(float (&acc)[NT][4], const bf16* A,
                                       int r0, const bf16* Bt, int n0,
                                       int lane) {
  constexpr int LD = XlTile<DPAD>::LD;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk) {
    uint32_t fa[4];
    load_a(fa, A, LD, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4];
      load_bt(fb, Bt, LD, n0 + np * 16, kk * 16, lane);
      mma16816(acc[2 * np], fa, fb[0], fb[1]);
      mma16816(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// A warp's raw tile (16 rows x 80) to its f32 tile in shared memory
__device__ __forceinline__ void tc_put_raw(float* raw_w, const float (&x)[10][4],
                                           int lane) {
  constexpr int LDR = XlTile<64>::LDR;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 10; ++n) {
    *reinterpret_cast<float2*>(raw_w + g * LDR + n * 8 + 2 * t4) =
        make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(raw_w + (g + 8) * LDR + n * 8 + 2 * t4) =
        make_float2(x[n][2], x[n][3]);
  }
}

// s += the warp's raw tile read back sheared: row il, key jl at column
// jl - il + 15 (band row jl - i + 63 of the block's band, the raw tile's
// 80 rows starting at c0 = 48 - 16 warp)
__device__ __forceinline__ void tc_add_sheared(float (&s)[8][4],
                                               const float* raw_w, int lane) {
  constexpr int LDR = XlTile<64>::LDR;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = g + 8 * rr, jl = n * 8 + 2 * t4 + e;
        s[n][2 * rr + e] += raw_w[il * LDR + jl - il + 15];
      }
}

// Passes 2 and 3: this warp's 16 query rows (from r0) against the 64 keys
// of the K, V tiles: s = qw K^T plus the position scores qr r[T + j - i],
// dp = dO V^T. The position scores of the 80 band rows from c0 (those the
// 16 rows reach) go through raw_w and come back at row il, column
// jl - il + 15 (band row jl - i + 63 of the block's band).
template <int DPAD>
__device__ __forceinline__ void tc_scores(float (&s)[8][4], float (&dp)[8][4],
                                          const bf16* qw, const bf16* qr,
                                          const bf16* gs, const bf16* ks,
                                          const bf16* vs, const bf16* rs,
                                          float* raw_w, int r0, int c0,
                                          int lane) {
  {
    float pr[10][4];
    tc_abt<DPAD, 10>(pr, qr, r0, rs, c0, lane);
    tc_put_raw(raw_w, pr, lane);
  }
  tc_abt<DPAD, 8>(s, qw, r0, ks, 0, lane);
  tc_abt<DPAD, 8>(dp, gs, r0, vs, 0, lane);
  __syncwarp();
  tc_add_sheared(s, raw_w, lane);
}

// x = A B^T over the warp's 16 rows of A, held as fragments fa (k over
// DPAD), and NT n8 tiles of B's rows from n0, 16 at a time: rows(x) is row
// x of B (row-major, LD), its 16 rows from x contiguous; acc zeroed here
template <int DPAD, int NT, typename Rows>
__device__ __forceinline__ void tc_abt_frag(float (&acc)[NT][4],
                                            const uint32_t (&fa)[DPAD / 16][4],
                                            Rows rows, int n0, int lane) {
  constexpr int LD = XlTile<DPAD>::LD;
  const bf16* bp[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) bp[np] = rows(n0 + np * 16);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4];
      load_bt(fb, bp[np], LD, 0, kk * 16, lane);
      mma16816(acc[2 * np], fa[kk], fb[0], fb[1]);
      mma16816(acc[2 * np + 1], fa[kk], fb[2], fb[3]);
    }
}

// Shared memory of the forward, byte offsets (each a multiple of 128). MS
// strips of 16 query rows a warp, as K1's forward: two where the head is
// at most 64 wide (each K and V fragment read from shared memory then
// feeds two products), one above. K and V tiles and their key flags in a
// two-stage ring; the band of r as a ring of MS + 2 chunks of 64 rows
// (key tile t reads chunks t .. t + MS and chunk t + MS + 1 loads while it
// runs, so each tile stages 64 rows of r, not BQ + 63); q + r_r_bias,
// read by each tile; q + r_w_bias, read once into registers, whose room
// then holds the warps' raw tiles; the biases. 112 KB at DPAD 64, so two
// blocks share an SM.
template <int DPAD>
struct TcFwd {
  using L = XlTile<DPAD>;
  static constexpr int MS = DPAD <= 64 ? 2 : 1, BQ = 64 * MS, NCH = MS + 2;
  static constexpr int TE = L::BT * L::LD;   // elements of a 64-row tile
  static constexpr int K = 0, V = K + 2 * L::TILE, BAND = V + 2 * L::TILE;
  static constexpr int QR = BAND + NCH * L::TILE, QW = QR + MS * L::TILE;
  static constexpr int FLAGS =
      QW + (MS * L::TILE > L::RAW ? MS * L::TILE : L::RAW);
  static constexpr int BW = FLAGS + 2 * L::ROW, BR = BW + L::BIAS;
  static constexpr int BYTES = BR + L::BIAS;
};

// The forward, bf16. Grid (query tiles of BQ, H, B): FlashAttention-2 over
// the key tiles on K1's model (csrc/attention_blc.cu), each warp's
// q + r_w_bias fragments, S, P and O in registers. Each key tile: S =
// qw K^T for every strip; the position term of each strip, qr band^T over
// its 80 band rows, through the warp's raw tile, added by tc_add_sheared;
// scale, key flags, online softmax with quad shuffles; P packed to bf16 A
// fragments (zero where dropped or at a masked key; every P into l);
// O += P V. Out = O inv_keep / l, and with lse, m + log2 l.
template <int DPAD>
__global__ void __launch_bounds__(128)
xl_fwd_tc_kernel(XlArgs a, bf16* __restrict__ out, float* __restrict__ lse,
                 bool vec) {
  using L = XlTile<DPAD>;
  using F = TcFwd<DPAD>;
  constexpr int MS = F::MS, KD = DPAD / 16, NO = DPAD / 8, TE = F::TE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + F::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + F::V);
  bf16* band = reinterpret_cast<bf16*>(smem + F::BAND);
  bf16* qr = reinterpret_cast<bf16*>(smem + F::QR);
  bf16* qw = reinterpret_cast<bf16*>(smem + F::QW);
  float* flags = reinterpret_cast<float*>(smem + F::FLAGS);
  float* bw = reinterpret_cast<float*>(smem + F::BW);
  float* br = reinterpret_cast<float*>(smem + F::BR);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * F::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = warp * 16 * MS;   // this warp's first row in the tile
  const int T_len = a.T, nq = min(F::BQ, T_len - i0);
  const int ntiles = (T_len + L::BT - 1) / L::BT;
  const long long C = (long long)a.H * a.D, hd = (long long)h * a.D;
  const bf16* k0 = (const bf16*)a.k + (long long)b * T_len * C + hd;
  const bf16* v0 = (const bf16*)a.v + (long long)b * T_len * C + hd;
  const uint8_t* mp = (const uint8_t*)a.mask + (long long)b * T_len;
  // chunk c of the band is r's rows p0 + 64 c ..: key tile t's band row x
  // (key j0 + jl, row i0 + il: x = jl - il + BQ - 1) is row x % 64 of
  // chunk t + x / 64
  const int p0 = T_len - i0 - (F::BQ - 1);
  auto stage = [&](int t) {   // key tile t and band chunk t + MS
    const int j0 = t * L::BT, sl = t & 1, nk = min(L::BT, T_len - j0);
    stage_tile<L::BT, DPAD, L::LD, L::THREADS>(ks + sl * TE, k0 + j0 * C, C,
                                               nk, a.D, vec);
    stage_tile<L::BT, DPAD, L::LD, L::THREADS>(vs + sl * TE, v0 + j0 * C, C,
                                               nk, a.D, vec);
    for (int jj = tid; jj < L::BT; jj += L::THREADS)
      flags[sl * L::BT + jj] = key_flag(mp, j0 + jj, T_len);
    tc_stage_r<DPAD>(band + ((t + MS) % F::NCH) * TE, a, h,
                     p0 + (t + MS) * L::BT, L::BT, vec);
    cp_async_commit();
  };

  tc_biases<DPAD>(bw, br, a, h);
  const bf16* q0 = (const bf16*)a.q + ((long long)b * T_len + i0) * C + hd;
  tc_stage<DPAD>(qw, F::BQ, a.D, vec, q0,
                 [=](int rr) { return rr < nq ? q0 + rr * C : nullptr; });
  for (int c = 0; c < MS; ++c)   // chunks 0 .. MS - 1
    tc_stage_r<DPAD>(band + c * TE, a, h, p0 + c * L::BT, L::BT, vec);
  cp_async_commit();
  stage(0);
  cp_async_wait<1>();
  __syncthreads();
  for (int c = 0; c < MS; ++c)
    tc_add_biases<DPAD>(qw + c * TE, qr + c * TE, bw, br, nq - c * L::BT);
  __syncthreads();
  uint32_t fw[MS][KD][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      load_a(fw[ms][kk], qw, L::LD, w0 + 16 * ms, kk * 16, lane);
  // the loop's first barrier orders these reads before the raw tiles'
  // writes, which reuse their room
  float* raw_w = reinterpret_cast<float*>(smem + F::QW) + warp * 16 * L::LDR;
  // [strip][r]: rows w0 + 16 strip + g (r = 0) and + 8 (r = 1): running
  // max, this lane's share of the sum; the Philox counter of row w0 + g,
  // key 0
  float m[MS][2], l[MS][2], o[MS][NO][4];
  const unsigned long long e_row =
      (((unsigned long long)b * a.H + h) * T_len + i0 + w0 + g) * T_len;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    m[ms][0] = m[ms][1] = -INFINITY;
    l[ms][0] = l[ms][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[ms][n][0] = o[ms][n][1] = o[ms][n][2] = o[ms][n][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = t * L::BT, sl = t & 1;
    const bf16* kt = ks + sl * TE;
    const bf16* vt = vs + sl * TE;
    const float* ft = flags + sl * L::BT;

    // S = qw K^T, each K fragment feeding every strip
    float s[MS][8][4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        s[ms][n][0] = s[ms][n][1] = s[ms][n][2] = s[ms][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        load_bt(kb, kt, L::LD, np * 16, kk * 16, lane);
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          mma16816(s[ms][2 * np], fw[ms][kk], kb[0], kb[1]);
          mma16816(s[ms][2 * np + 1], fw[ms][kk], kb[2], kb[3]);
        }
      }
    // the position term, strip by strip through the warp's raw tile
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      const int r0 = w0 + 16 * ms, c0 = F::BQ - 16 - r0;
      uint32_t fr[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        load_a(fr[kk], qr, L::LD, r0, kk * 16, lane);
      float pr[10][4];
      tc_abt_frag<DPAD, 10>(pr, fr, [&](int x) {
        return band + ((t + (x >> 6)) % F::NCH) * TE + (x & 63) * L::LD;
      }, c0, lane);
      if (ms > 0) __syncwarp();   // the last strip's raw tile is read
      tc_put_raw(raw_w, pr, lane);
      __syncwarp();
      tc_add_sheared(s[ms], raw_w, lane);
    }

    uint32_t pf[MS][4][4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      // scale, key flags, the quad's row max
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 fl =
            *reinterpret_cast<const float2*>(ft + n * 8 + 2 * t4);
        float* x = s[ms][n];
        x[0] = flagged(fl.x, x[0] * a.scale_log2);
        x[1] = flagged(fl.y, x[1] * a.scale_log2);
        x[2] = flagged(fl.x, x[2] * a.scale_log2);
        x[3] = flagged(fl.y, x[3] * a.scale_log2);
        tmax[0] = fmaxf(tmax[0], fmaxf(x[0], x[1]));
        tmax[1] = fmaxf(tmax[1], fmaxf(x[2], x[3]));
      }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        tmax[rr] = fmaxf(tmax[rr], __shfl_xor_sync(0xffffffffu, tmax[rr], 1));
        tmax[rr] = fmaxf(tmax[rr], __shfl_xor_sync(0xffffffffu, tmax[rr], 2));
        const float m_new = fmaxf(m[ms][rr], tmax[rr]);
        alpha[rr] = exp2f(m[ms][rr] - m_new);
        m[ms][rr] = m_new;
      }
      // the keep bits of this lane's 32 elements (bit 4 n + 2 rr + e), drawn
      // in a loop kept rolled, so that the Philox code stays out of the
      // unrolled tile and a call without dropout skips it whole
      uint32_t kept = ~0u;
      if (a.drop.thresh != 0u) {
        kept = 0u;
#pragma unroll 1
        for (int q = 0; q < 32; ++q) {
          const int n = q >> 2, rr = (q >> 1) & 1, e = q & 1;
          kept |= (uint32_t)a.drop.keep(
                      e_row + ((16 * ms + 8 * rr) * T_len + j0 + n * 8 +
                               2 * t4 + e))
                  << q;
        }
      }
      // P from the f32 values into l; into the A fragments only where kept
      // at a valid key (v mask is P mask), rounded to bf16
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 fl =
            *reinterpret_cast<const float2*>(ft + n * 8 + 2 * t4);
        float p[4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = exp2f(s[ms][n][2 * rr + e] - m[ms][rr]);
            psum[rr] += x;
            const bool keep = (kept >> (4 * n + 2 * rr + e)) & 1u;
            p[2 * rr + e] = (e ? fl.y : fl.x) > 0.f && keep ? x : 0.f;
          }
        pf[ms][n / 2][(n & 1) * 2] = pack2(p[0], p[1]);
        pf[ms][n / 2][(n & 1) * 2 + 1] = pack2(p[2], p[3]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l[ms][rr] = l[ms][rr] * alpha[rr] + psum[rr];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[ms][n][0] *= alpha[0];
        o[ms][n][1] *= alpha[0];
        o[ms][n][2] *= alpha[1];
        o[ms][n][3] *= alpha[1];
      }
    }
    // O += P V, V through ldmatrix.trans; each V fragment feeds every strip
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        load_b(vb, vt, L::LD, kk * 16, dp * 16, lane);
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          mma16816(o[ms][2 * dp], pf[ms][kk], vb[0], vb[1]);
          mma16816(o[ms][2 * dp + 1], pf[ms][kk], vb[2], vb[3]);
        }
      }
    __syncthreads();   // the stages are refilled from the next tile on
  }

  bf16* op = out + ((long long)b * T_len + i0) * C + hd;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[ms][rr] += __shfl_xor_sync(0xffffffffu, l[ms][rr], 1);
      l[ms][rr] += __shfl_xor_sync(0xffffffffu, l[ms][rr], 2);
    }
    store_rows<NO>(o[ms], a.drop.inv_keep / l[ms][0],
                   a.drop.inv_keep / l[ms][1], w0 + 16 * ms, nq, a.D, vec,
                   [&](int il) { return op + il * C; }, lane);
    if (lse != nullptr && t4 == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int il = w0 + 16 * ms + g + 8 * rr;
        if (il < nq)
          lse[((long long)b * a.H + h) * T_len + i0 + il] =
              m[ms][rr] + log2f(l[ms][rr]);
      }
    }
  }
}

template <int DPAD>
cudaError_t launch_fwd_tc(const XlArgs& a, void* out, void* lse, bool vec,
                          cudaStream_t s) {
  using F = TcFwd<DPAD>;
  auto kern = xl_fwd_tc_kernel<DPAD>;
  cudaError_t e = set_smem(kern, F::BYTES);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.T + F::BQ - 1) / F::BQ, a.H, a.B), 128, F::BYTES, s>>>(
      a, (bf16*)out, (float*)lse, vec);
  return cudaGetLastError();
}

// Pass 2, bf16. Grid (key tiles, H, B): P and dS of each query tile by
// query rows (tc_scores), through shared memory as bf16, then dv += Pd^T dO
// and dk += dS^T qw by key rows, P^T and dS^T by ldmatrix.trans.
template <int DPAD>
__global__ void __launch_bounds__(128)
xl_bwd_dkv_tc_kernel(XlArgs a, bool vec) {
  using L = XlTile<DPAD>;
  constexpr int NO = DPAD / 8;
  constexpr int QW = 0, QR = QW + L::TILE, G = QR + L::TILE, K = G + L::TILE;
  constexpr int V = K + L::TILE, R = V + L::TILE, RAW = R + L::BAND;
  constexpr int P = RAW + L::RAW, DS = P + L::PT, LS = DS + L::PT;
  constexpr int DL = LS + L::ROW, KP = DL + L::ROW, BW = KP + L::ROW;
  constexpr int BR = BW + L::BIAS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qw = reinterpret_cast<bf16*>(smem + QW);
  bf16* qr = reinterpret_cast<bf16*>(smem + QR);
  bf16* gs = reinterpret_cast<bf16*>(smem + G);
  bf16* ks = reinterpret_cast<bf16*>(smem + K);
  bf16* vs = reinterpret_cast<bf16*>(smem + V);
  bf16* rs = reinterpret_cast<bf16*>(smem + R);
  float* raw = reinterpret_cast<float*>(smem + RAW);
  bf16* ps = reinterpret_cast<bf16*>(smem + P);
  bf16* dss = reinterpret_cast<bf16*>(smem + DS);
  float* lses = reinterpret_cast<float*>(smem + LS);
  float* dels = reinterpret_cast<float*>(smem + DL);
  float* keep = reinterpret_cast<float*>(smem + KP);
  float* bw = reinterpret_cast<float*>(smem + BW);
  float* br = reinterpret_cast<float*>(smem + BR);

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * L::BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T;
  const long long C = (long long)a.H * a.D, hd = (long long)h * a.D;
  const int nk = min(L::BT, T_len - j0);
  tc_biases<DPAD>(bw, br, a, h);
  tc_stage_keys<DPAD>(ks, vs, keep, a, b, h, j0, L::BT, vec);
  float* raw_w = raw + warp * 16 * L::LDR;
  const int c0 = L::NBAND - L::WBAND - 16 * warp;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i0 = 0; i0 < T_len; i0 += L::BT) {
    __syncthreads();   // the previous query tile is no longer read
    tc_stage_queries<DPAD>(qw, gs, lses, dels, a, b, h, i0, vec);
    tc_stage_r<DPAD>(rs, a, h, T_len + j0 - i0 - (L::BT - 1), L::NBAND, vec);
    tc_landed();
    tc_add_biases<DPAD>(qw, qr, bw, br, min(L::BT, T_len - i0));
    __syncthreads();
    const long long at = ((long long)b * a.H + h) * T_len + i0;
    float s[8][4], dp[8][4];
    tc_scores<DPAD>(s, dp, qw, qr, gs, ks, vs, rs, raw_w, warp * 16, c0,
                    lane);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int il = warp * 16 + g + 8 * rr;
      const float ls = lses[il], dl = dels[il];
      const unsigned long long e0 =
          ((unsigned long long)at + il) * T_len + j0;
      const bool row_in = i0 + il < T_len;
      unsigned long long word = 0ull;   // the row's keep bits of the tile
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float pv[2], sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = n * 8 + 2 * t4 + e;
          const float p = exp2f(
              flagged(keep[jl], s[n][2 * rr + e] * a.scale_log2) - ls);
          const bool kept = row_in && jl < nk && a.drop.keep(e0 + jl);
          word |= (unsigned long long)kept << jl;
          const float mul = kept ? a.drop.inv_keep : 0.f;
          pv[e] = p * mul;
          sv[e] = p * (dp[n][2 * rr + e] * mul - dl);
        }
        const int at2 = il * L::LDP + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(ps + at2) = pack2(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(dss + at2) = pack2(sv[0], sv[1]);
      }
      if (a.bits != nullptr) {   // the row's four lanes' bits, one store
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        if (t4 == 0 && row_in)
          a.bits[((long long)at + il) * ((T_len + 63) / 64) + blockIdx.x] =
              word;
      }
    }
    __syncthreads();
    // dv += Pd^T dO, dk += dS^T qw: this warp's 16 keys
#pragma unroll
    for (int kk = 0; kk < L::BT / 16; ++kk) {
      uint32_t pa[4], sa[4];
      load_at(pa, ps, L::LDP, warp * 16, kk * 16, lane);
      load_at(sa, dss, L::LDP, warp * 16, kk * 16, lane);
#pragma unroll
      for (int dpi = 0; dpi < NO / 2; ++dpi) {
        uint32_t gb[4], qb[4];
        load_b(gb, gs, L::LD, kk * 16, dpi * 16, lane);
        load_b(qb, qw, L::LD, kk * 16, dpi * 16, lane);
        mma16816(dv[2 * dpi], pa, gb[0], gb[1]);
        mma16816(dv[2 * dpi + 1], pa, gb[2], gb[3]);
        mma16816(dk[2 * dpi], sa, qb[0], qb[1]);
        mma16816(dk[2 * dpi + 1], sa, qb[2], qb[3]);
      }
    }
  }
  const int k0 = warp * 16 + g;
  const float vm0 = keep[k0] > 0.f ? 1.f : 0.f;
  const float vm1 = keep[k0 + 8] > 0.f ? 1.f : 0.f;
  bf16* dkp = (bf16*)a.dk + ((long long)b * T_len + j0) * C + hd;
  bf16* dvp = (bf16*)a.dv + ((long long)b * T_len + j0) * C + hd;
  store_rows<NO>(dk, a.scale, a.scale, warp * 16, nk, a.D, vec,
                 [&](int jl) { return dkp + jl * C; }, lane);
  store_rows<NO>(dv, vm0, vm1, warp * 16, nk, a.D, vec,
                 [&](int jl) { return dvp + jl * C; }, lane);
}

// Pass 3, bf16. Grid (query tiles, H, B): dS of each key tile by query rows
// (tc_scores), as bf16 A fragments in registers for dq += dS K, and
// sheared through the warp's bf16 tile (row il, column j - i + 15 of its 80
// band rows; the 16 other columns of a row stay 0) for dq += dS_sh r.
template <int DPAD>
__global__ void __launch_bounds__(128)
xl_bwd_dq_tc_kernel(XlArgs a, bool vec) {
  using L = XlTile<DPAD>;
  constexpr int NO = DPAD / 8;
  constexpr int QW = 0, QR = QW + L::TILE, G = QR + L::TILE, K = G + L::TILE;
  constexpr int V = K + L::TILE, R = V + L::TILE, RAW = R + L::BAND;
  constexpr int SH = RAW + L::RAW, KP = SH + L::SH, BW = KP + L::ROW;
  constexpr int BR = BW + L::BIAS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qw = reinterpret_cast<bf16*>(smem + QW);
  bf16* qr = reinterpret_cast<bf16*>(smem + QR);
  bf16* gs = reinterpret_cast<bf16*>(smem + G);
  bf16* ks = reinterpret_cast<bf16*>(smem + K);
  bf16* vs = reinterpret_cast<bf16*>(smem + V);
  bf16* rs = reinterpret_cast<bf16*>(smem + R);
  float* raw = reinterpret_cast<float*>(smem + RAW);
  bf16* sh = reinterpret_cast<bf16*>(smem + SH);
  float* keep = reinterpret_cast<float*>(smem + KP);
  float* bw = reinterpret_cast<float*>(smem + BW);
  float* br = reinterpret_cast<float*>(smem + BR);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * L::BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T;
  const long long C = (long long)a.H * a.D, hd = (long long)h * a.D;
  tc_biases<DPAD>(bw, br, a, h);
  tc_stage_queries<DPAD>(qw, gs, nullptr, nullptr, a, b, h, i0, vec);
  tc_landed();
  tc_add_biases<DPAD>(qw, qr, bw, br, min(L::BT, T_len - i0));
  float* raw_w = raw + warp * 16 * L::LDR;
  bf16* sh_w = sh + warp * 16 * L::LDH;
  for (int e = lane; e < 16 * L::LDH; e += 32) sh_w[e] = __float2bfloat16(0.f);
  const int c0 = L::NBAND - L::WBAND - 16 * warp;
  float rl[2], rd[2];
  const unsigned long long* wrow[2];   // the rows' keep words
  const int nw = (T_len + 63) / 64;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + warp * 16 + g + 8 * rr;
    const long long at = ((long long)b * a.H + h) * T_len + i;
    const bool in = i < T_len;
    rl[rr] = in ? ((const float*)a.lse)[at] : INFINITY;
    rd[rr] = in ? a.delta[at] : 0.f;
    wrow[rr] = in && a.bits != nullptr ? a.bits + at * nw : nullptr;
  }
  float tw[NO][4], tr[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tw[n][e] = tr[n][e] = 0.f;

  for (int j0 = 0; j0 < T_len; j0 += L::BT) {
    __syncthreads();   // the previous key tile is no longer read
    tc_stage_keys<DPAD>(ks, vs, keep, a, b, h, j0, L::BT, vec);
    tc_stage_r<DPAD>(rs, a, h, T_len + j0 - i0 - (L::BT - 1), L::NBAND, vec);
    tc_landed();
    float s[8][4], dp[8][4];
    tc_scores<DPAD>(s, dp, qw, qr, gs, ks, vs, rs, raw_w, warp * 16, c0,
                    lane);
    unsigned long long kw[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      kw[rr] = a.bits == nullptr ? ~0ull
                                 : wrow[rr] ? wrow[rr][j0 / 64] : 0ull;
    uint32_t sa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d4[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = n * 8 + 2 * t4 + e, il = g + 8 * rr;
          const float p = exp2f(
              flagged(keep[jl], s[n][2 * rr + e] * a.scale_log2) - rl[rr]);
          const float mul = (kw[rr] >> jl) & 1ull ? a.drop.inv_keep : 0.f;
          d4[2 * rr + e] = p * (dp[n][2 * rr + e] * mul - rd[rr]);
          sh_w[il * L::LDH + jl - il + 15] = __float2bfloat16(d4[2 * rr + e]);
        }
      sa[n / 2][(n & 1) * 2] = pack2(d4[0], d4[1]);
      sa[n / 2][(n & 1) * 2 + 1] = pack2(d4[2], d4[3]);
    }
    __syncwarp();
    // dq content term: dS K, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < L::BT / 16; ++kk)
#pragma unroll
      for (int dpi = 0; dpi < NO / 2; ++dpi) {
        uint32_t kb[4];
        load_b(kb, ks, L::LD, kk * 16, dpi * 16, lane);
        mma16816(tw[2 * dpi], sa[kk], kb[0], kb[1]);
        mma16816(tw[2 * dpi + 1], sa[kk], kb[2], kb[3]);
      }
    // dq position term: dS_sh r over the warp's 80 band rows
#pragma unroll
    for (int kk = 0; kk < L::WBAND / 16; ++kk) {
      uint32_t ha[4];
      load_a(ha, sh_w, L::LDH, 0, kk * 16, lane);
#pragma unroll
      for (int dpi = 0; dpi < NO / 2; ++dpi) {
        uint32_t rb[4];
        load_b(rb, rs, L::LD, c0 + kk * 16, dpi * 16, lane);
        mma16816(tr[2 * dpi], ha, rb[0], rb[1]);
        mma16816(tr[2 * dpi + 1], ha, rb[2], rb[3]);
      }
    }
  }
  // bias partials: column sums of the two terms over the tile's rows, the
  // lanes' rows by a fixed shuffle tree, then the warps in order
  __syncthreads();   // raw is no longer read: it holds the warps' sums
  float* red = raw;  // [4 warps][2][DPAD]
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float cw = tw[n][e] + tw[n][2 + e], cr = tr[n][e] + tr[n][2 + e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cw += __shfl_xor_sync(0xffffffffu, cw, o);
        cr += __shfl_xor_sync(0xffffffffu, cr, o);
      }
      if (g == 0) {
        red[(warp * 2) * DPAD + n * 8 + 2 * t4 + e] = cw;
        red[(warp * 2 + 1) * DPAD + n * 8 + 2 * t4 + e] = cr;
      }
    }
  __syncthreads();
  const long long np = (long long)a.B * gridDim.x * C;
  for (int e = tid; e < 2 * DPAD; e += L::THREADS) {
    const int w = e / DPAD, d = e % DPAD;
    const float acc = ((red[w * DPAD + d] + red[(2 + w) * DPAD + d]) +
                       red[(4 + w) * DPAD + d]) + red[(6 + w) * DPAD + d];
    if (d < a.D)
      a.partial[w * np + ((long long)b * gridDim.x + blockIdx.x) * C + hd +
                d] = acc * a.scale;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tw[n][e] += tr[n][e];
  bf16* dqp = (bf16*)a.dq + ((long long)b * T_len + i0) * C + hd;
  store_rows<NO>(tw, a.scale, a.scale, warp * 16, min(L::BT, T_len - i0),
                 a.D, vec, [&](int il) { return dqp + il * C; }, lane);
}

// Pass 4, bf16. Grid (position tiles, H): for each batch and each query
// tile whose band of keys j = p - T + i (128 from jb = p0 - T + i0) meets
// [0, T), the scores by query rows: the position term qr R_tile^T, a plain
// tile product; the content term qw K_band^T and dO V_band^T over the 80
// band keys the warp's rows reach, sheared through raw_w (row il, column
// pl + il). dS goes through shared memory as bf16, and dr += dS^T qr by
// position rows.
template <int DPAD>
__global__ void __launch_bounds__(128)
xl_bwd_dr_tc_kernel(XlArgs a, bool vec) {
  using L = XlTile<DPAD>;
  constexpr int NO = DPAD / 8;
  constexpr int BAND_ROW = 2 * L::ROW;   // the key flags: 128 floats
  constexpr int QW = 0, QR = QW + L::TILE, G = QR + L::TILE, K = G + L::TILE;
  constexpr int V = K + L::BAND, RT = V + L::BAND, RAW = RT + L::TILE;
  constexpr int DS = RAW + L::RAW, LS = DS + L::PT, DL = LS + L::ROW;
  constexpr int KP = DL + L::ROW, BW = KP + BAND_ROW, BR = BW + L::BIAS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qw = reinterpret_cast<bf16*>(smem + QW);
  bf16* qr = reinterpret_cast<bf16*>(smem + QR);
  bf16* gs = reinterpret_cast<bf16*>(smem + G);
  bf16* ks = reinterpret_cast<bf16*>(smem + K);
  bf16* vs = reinterpret_cast<bf16*>(smem + V);
  bf16* rt = reinterpret_cast<bf16*>(smem + RT);
  float* raw = reinterpret_cast<float*>(smem + RAW);
  bf16* dss = reinterpret_cast<bf16*>(smem + DS);
  float* lses = reinterpret_cast<float*>(smem + LS);
  float* dels = reinterpret_cast<float*>(smem + DL);
  float* keep = reinterpret_cast<float*>(smem + KP);
  float* bw = reinterpret_cast<float*>(smem + BW);
  float* br = reinterpret_cast<float*>(smem + BR);

  // heads fastest, position tiles from the middle out (the tiles that meet
  // the most query tiles start first)
  const int h = blockIdx.x, mid = ((int)gridDim.y - 1) / 2, y = blockIdx.y;
  const int p0 = (mid + ((y & 1) ? (y + 1) / 2 : -(y / 2))) * L::BT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T_len = a.T;
  const long long C = (long long)a.H * a.D, hd = (long long)h * a.D;
  tc_biases<DPAD>(bw, br, a, h);
  tc_stage_r<DPAD>(rt, a, h, p0, L::BT, vec);
  float* raw_w = raw + warp * 16 * L::LDR;
  const int c0 = 16 * warp;   // the warp's first band key
  float dr[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dr[n][e] = 0.f;

  for (int b = 0; b < a.B; ++b)
    for (int i0 = 0; i0 < T_len; i0 += L::BT) {
      const int jb = p0 - T_len + i0;   // key of position p0, query i0
      if (jb + L::NBAND - 2 < 0 || jb >= T_len) continue;
      __syncthreads();   // the previous query tile is no longer read
      tc_stage_queries<DPAD>(qw, gs, lses, dels, a, b, h, i0, vec);
      tc_stage_keys<DPAD>(ks, vs, keep, a, b, h, jb, L::NBAND, vec);
      tc_landed();
      tc_add_biases<DPAD>(qw, qr, bw, br, min(L::BT, T_len - i0));
      __syncthreads();
      const long long at = ((long long)b * a.H + h) * T_len + i0;
      float pos[8][4];
      tc_abt<DPAD, 8>(pos, qr, warp * 16, rt, 0, lane);
      {
        float x[10][4];
        tc_abt<DPAD, 10>(x, qw, warp * 16, ks, c0, lane);
        tc_put_raw(raw_w, x, lane);
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int il = g + 8 * rr, pl = n * 8 + 2 * t4 + e;
            pos[n][2 * rr + e] += raw_w[il * L::LDR + pl + il];
          }
      __syncwarp();   // raw_w is rewritten with dO V_band^T
      {
        float x[10][4];
        tc_abt<DPAD, 10>(x, gs, warp * 16, vs, c0, lane);
        tc_put_raw(raw_w, x, lane);
      }
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int il = warp * 16 + g + 8 * rr;
        const float ls = lses[il], dl = dels[il];
        // the row's keep words over its keys jb + il .. + 63: fw, fw + 1
        const int nw = (T_len + 63) / 64, fw = (jb + il) >> 6;
        const bool row_in = i0 + il < T_len;
        auto word = [&](int w) {
          return a.bits == nullptr ? ~0ull
                 : row_in && w >= 0 && w < nw
                     ? a.bits[((long long)at + il) * nw + w] : 0ull;
        };
        const unsigned long long w0 = word(fw), w1 = word(fw + 1);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pl = n * 8 + 2 * t4 + e, c = pl + il;
            const float fl = keep[c];
            const float p = exp2f(
                flagged(fl, pos[n][2 * rr + e] * a.scale_log2) - ls);
            const int j = jb + c;
            const unsigned long long w = (j >> 6) > fw ? w1 : w0;
            const float mul =
                fl >= 0.f && ((w >> (j & 63)) & 1ull) ? a.drop.inv_keep : 0.f;
            const float dpv = raw_w[(g + 8 * rr) * L::LDR + c - c0];
            sv[e] = p * (dpv * mul - dl);
          }
          *reinterpret_cast<uint32_t*>(dss + il * L::LDP + n * 8 + 2 * t4) =
              pack2(sv[0], sv[1]);
        }
      }
      __syncthreads();
      // dr += dS^T qr: this warp's 16 positions
#pragma unroll
      for (int kk = 0; kk < L::BT / 16; ++kk) {
        uint32_t sa[4];
        load_at(sa, dss, L::LDP, warp * 16, kk * 16, lane);
#pragma unroll
        for (int dpi = 0; dpi < NO / 2; ++dpi) {
          uint32_t qb[4];
          load_b(qb, qr, L::LD, kk * 16, dpi * 16, lane);
          mma16816(dr[2 * dpi], sa, qb[0], qb[1]);
          mma16816(dr[2 * dpi + 1], sa, qb[2], qb[3]);
        }
      }
    }
  cp_async_wait<0>();   // a block that met no query tile never waited
  bf16* drp = (bf16*)a.dr + (long long)p0 * C + hd;
  store_rows<NO>(dr, a.scale, a.scale, warp * 16, min(L::BT, 2 * T_len - p0),
                 a.D, vec, [&](int pl) { return drp + pl * C; }, lane);
}

template <int DPAD>
constexpr int tc_dkv_bytes() {
  using L = XlTile<DPAD>;
  return 5 * L::TILE + L::BAND + L::RAW + 2 * L::PT + 3 * L::ROW + 2 * L::BIAS;
}
template <int DPAD>
constexpr int tc_dq_bytes() {
  using L = XlTile<DPAD>;
  return 5 * L::TILE + L::BAND + L::RAW + L::SH + L::ROW + 2 * L::BIAS;
}
template <int DPAD>
constexpr int tc_dr_bytes() {
  using L = XlTile<DPAD>;
  return 4 * L::TILE + 2 * L::BAND + L::RAW + L::PT + 4 * L::ROW + 2 * L::BIAS;
}

// Pass 5: the bias partials (`rows` of H D per bias) summed in row order
template <typename T>
__global__ void __launch_bounds__(256)
xl_bwd_bias_sum_kernel(const float* __restrict__ partial, T* __restrict__ drwb,
                       T* __restrict__ drrb, int rows, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float w = 0.f, p = 0.f;
  for (int t = 0; t < rows; ++t) {
    w += partial[(long long)t * n + e];
    p += partial[(long long)(rows + t) * n + e];
  }
  drwb[e] = vilco::from_f32<T>(w);
  drrb[e] = vilco::from_f32<T>(p);
}

// passes 2-4
template <int DPAD>
cudaError_t launch_bwd_tc(const XlArgs& a, bool vec, cudaStream_t s) {
  cudaError_t e;
  const int nt = (a.T + 63) / 64, np = (2 * a.T + 63) / 64;
  auto kd = xl_bwd_dkv_tc_kernel<DPAD>;
  auto kq = xl_bwd_dq_tc_kernel<DPAD>;
  auto kr = xl_bwd_dr_tc_kernel<DPAD>;
  if ((e = set_smem(kd, tc_dkv_bytes<DPAD>())) != cudaSuccess) return e;
  if ((e = set_smem(kq, tc_dq_bytes<DPAD>())) != cudaSuccess) return e;
  if ((e = set_smem(kr, tc_dr_bytes<DPAD>())) != cudaSuccess) return e;
  kd<<<dim3(nt, a.H, a.B), 128, tc_dkv_bytes<DPAD>(), s>>>(a, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kq<<<dim3(nt, a.H, a.B), 128, tc_dq_bytes<DPAD>(), s>>>(a, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kr<<<dim3(a.H, np), 128, tc_dr_bytes<DPAD>(), s>>>(a, vec);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t launch_bwd_simt(const XlArgs& a, cudaStream_t s) {
  cudaError_t e;
  constexpr int BT = bwd_tile<DPAD>();
  const int smem = (int)SimtSmem<DPAD>::bytes();
  const int nt = (a.T + BT - 1) / BT, np = (2 * a.T + BT - 1) / BT;
  auto kd = xl_bwd_dkv_simt_kernel<T, DPAD>;
  auto kq = xl_bwd_dq_simt_kernel<T, DPAD>;
  auto kr = xl_bwd_dr_simt_kernel<T, DPAD>;
  if ((e = set_smem(kd, smem)) != cudaSuccess) return e;
  if ((e = set_smem(kq, smem)) != cudaSuccess) return e;
  if ((e = set_smem(kr, smem)) != cudaSuccess) return e;
  kd<<<dim3(nt, a.H, a.B), BWD_THREADS, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kq<<<dim3(nt, a.H, a.B), BWD_THREADS, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kr<<<dim3(np, a.H), BWD_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// passes 1 and 5 around the dtype's passes 2-4; `tile`: the query tile of
// pass 3, which sets the number of bias partials
template <typename T, typename Passes>
cudaError_t launch_bwd(const XlArgs& a, const void* out, int tile,
                       cudaStream_t s, Passes passes) {
  const long long rows = (long long)a.B * a.H * a.T;
  attention_blc_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const T*)out, (const T*)a.dout, (float*)a.delta, rows, a.T, a.H, a.D,
      strides_of(false, a.B, a.T, a.H, a.D));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || (e = passes()) != cudaSuccess) return e;
  const int n = a.H * a.D;
  xl_bwd_bias_sum_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(
      a.partial, (T*)a.drwb, (T*)a.drrb, a.B * ((a.T + tile - 1) / tile),
      n);
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
// D <= 128. lse (B, H, T) f32 or null. Dropout: seed points to two 64-bit
// words on the device (null when thresh is 0), the seed, whose two 32-bit
// halves key Philox, and the base added to each element's counter; keep
// iff bits >= thresh (0: no dropout), kept probabilities times inv_keep.
extern "C" int xl_rel_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* r,
                                    const void* rwb, const void* rrb,
                                    const void* mask, void* out, void* lse,
                                    const void* seed, int B, int T_len,
                                    int H, int D, int dtype, int thresh,
                                    float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || T_len < 1 || H < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const vilco::Dropout drop = make_dropout(seed, thresh, inv_keep);
  if (dtype == 0)
    return (int)(D <= 64
        ? launch_simt<64>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s)
        : launch_simt<128>(q, k, v, r, rwb, rrb, mask, out, lse, B, T_len, H, D, drop, s));
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  XlArgs a{q, k, v, r, rwb, rrb, mask};   // the backward's fields null
  a.B = B, a.T = T_len, a.H = H, a.D = D;
  a.scale = 1.f / sqrtf((float)D), a.scale_log2 = a.scale * LOG2E;
  a.drop = drop;
  bool vec = D % 8 == 0;
  for (const void* p : {q, k, v, r, (const void*)out})
    vec = vec && (uintptr_t)p % 16 == 0;
  return (int)(D <= 64 ? launch_fwd_tc<64>(a, out, lse, vec, s)
                       : launch_fwd_tc<128>(a, out, lse, vec, s));
}

// Backward in five passes (the header): two calls give equal bits. Inputs as the forward's, plus out and lse from it and dout
// (B, T, H, D); dq, dk, dv (B, T, H, D), dr (2T, H, D), drwb and drrb (H,
// D) in dtype, each written once; delta (B, H, T) and partial (2 B
// ceil(T / 32) H D) f32 scratch; bits (B, H, T, ceil(T / 64)) 64-bit
// words of scratch for the keep bits in bf16 with dropout, else null.
extern "C" int xl_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* r,
    const void* rwb, const void* rrb, const void* mask, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dr, void* drwb, void* drrb, void* delta, void* partial, void* bits,
    const void* seed, int B, int T_len, int H, int D, int dtype, int thresh,
    float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || T_len < 1 || H < 1 || B > 65535 ||
      (dtype == 1 && thresh != 0) != (bits != nullptr))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  const XlArgs a{q, k, v, r, rwb, rrb, mask, lse, dout, dq, dk, dv, dr,
                drwb, drrb, (const float*)delta, (float*)partial,
                (unsigned long long*)bits, B, T_len, H, D, scale,
                scale * LOG2E,
                make_dropout(seed, thresh, inv_keep)};
  if (dtype == 0)
    return (int)launch_bwd<float>(a, out, D <= 64 ? 64 : 32, s, [&] {
      return D <= 64 ? launch_bwd_simt<float, 64>(a, s)
                     : launch_bwd_simt<float, 128>(a, s);
    });
  if (dtype == 1) {
    bool vec = D % 8 == 0;
    for (const void* p : {q, k, v, r, dout, (const void*)dq, (const void*)dk,
                          (const void*)dv, (const void*)dr})
      vec = vec && (uintptr_t)p % 16 == 0;
    return (int)launch_bwd<bf16>(a, out, 64, s, [&] {
      return D <= 64 ? launch_bwd_tc<64>(a, vec, s)
                     : launch_bwd_tc<128>(a, vec, s);
    });
  }
  return (int)cudaErrorInvalidValue;
}
