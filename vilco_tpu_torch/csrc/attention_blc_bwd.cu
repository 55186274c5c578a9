// K1's backward on channels-last or head-major q/k/v: replaces
// vilco_tpu/kernels/attention.py::_run_bwd_blc (the Pallas _bwd_kernel_blc)
// and, on the head-major layout, _run_bwd (_bwd_kernel; K1n). It reads the
// forward's lse (csrc/attention_blc.cu, which states the semantics).
//
// Backward, three passes and no atomics, so two calls give the same bits:
//  (a) delta = rowsum(dO * O) in f32 per (batch, head, query row);
//  (b) dk/dv: one block per (key tile of 64, head, batch, query slice)
//      holds its K and V tile in shared memory and dk, dv in registers and
//      walks the query tiles of its slice: P = exp2(s * scale log2 e + bias
//      - lse) (recomputed), dP = dO V^T, dS = P (dP - delta), dv += P^T dO,
//      dk += scale dS^T Q. Where the grid would have fewer than two blocks
//      per SM (few keys: the NLQ text), the query range is cut into slices
//      (kernels/attention.py::dkv_splits) whose f32 partials a last pass
//      sums in slice order;
//  (c) dq: one block per (query tile of 64, head, batch) walks the key
//      tiles, recomputes S, P, dP and dS and keeps dq += scale dS K in
//      registers; dq is written once, in q's dtype.
//  - bfloat16: every product on mma.sync (bf16 in, f32 accumulate), 4
//    warps of 16 rows (keys in (b), queries in (c)). (b) computes the
//    transposed tiles S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//    out of the accumulators with keys as rows and become bf16 A fragments
//    of dv += P^T dO and dk += dS^T Q in registers, with no trip through
//    shared memory; Q and dO tiles (two-stage cp.async ring) are read as B
//    operands by ldmatrix and ldmatrix.trans. (c) rounds dS to bf16 A
//    fragments for dq += dS K, K through ldmatrix.trans. P and dS are
//    rounded to bf16 before their products, as the TPU kernel rounds them.
//    Bound, like the forward, by the tensor cores fed from shared memory,
//    plus the exp2 of every recomputed score (both passes recompute P).
//  - float32 (the parity path): SIMT, one block of 256 threads per 64 x 64
//    tile pair (16 x 16 threads, each 4 rows by D/16 strided columns), P and
//    dS of the tile through shared memory. Bound by shared-memory operand
//    reads (each FMA reads two operands, one a broadcast).
// A fully masked row has P = 0 everywhere, so its gradients are exactly 0.
// Flash mode (a template switch; K1f: the backward of
// vilco_tpu/kernels/attention.py::flash_attention_jax, JAX's TPU flash
// dq and dkv kernels) reads the forward's m and l (csrc/attention_blc.cu)
// and recomputes P = exp2(s * scale log2 e + bias - m) / l with the
// library's masked-key value; a fully masked row then has P = 1 / Tk at
// every key and its gradients are not 0. The passes, tiles and the slice
// sums are K1's, so two calls give equal bits there too.
// Band mode (a template switch; K6: the backward of
// vilco_tpu/kernels/frame_band.py::frame_band_attention, the Pallas
// _dq_kernel and _dkv_kernel) reads the lse of K6's forward (the band mode
// of csrc/attention_blc.cu: K1's m + log2 l) on the channels-last layout, with no mask and one query slice:
// (b) walks only the query tiles of its key tile's window (the band is
// symmetric: Band::window), (c) only the key tiles of its query tile's
// window, so each pass visits at most 2w + 1 frames' worth of tiles (at the
// VQ flagship a 64-row tile is one frame: 5 tiles, not L / 64 = 30). A
// pair whose frames are more than w apart gets P = 0, tested element by
// element (each row's in-band range, Band::range) only where a frame edge
// crosses the tile pair (Band::covers); at fr = 64 no tile pair needs it.

#include "attention_blc.cuh"

namespace {

// ---- backward -------------------------------------------------------------

// dk/dv partials of the query slices, summed in slice order:
// partial[(w * splits + s) * n + e] is slice s's dk (w = 0, scaled) or dv
// (w = 1) at element e of k's layout.
template <typename T>
__global__ void __launch_bounds__(256)
attention_blc_sum_kernel(const float* __restrict__ partial, T* __restrict__ dk,
                         T* __restrict__ dv, long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += partial[s * n + e];
      c += partial[(splits + s) * n + e];
    }
    dk[e] = vilco::from_f32<T>(a);
    dv[e] = vilco::from_f32<T>(c);
  }
}

// Where a block writes dk/dv: straight into dk, dv (one slice), or as f32
// partials of slice `split` (the elements of k's layout at `off`).
template <typename T>
struct DkvOut {
  T* dk;
  T* dv;
  float* partial;   // null with one slice
  long long n;      // elements of k
  int splits;
  __device__ __forceinline__ void put(int split, long long off, int c,
                                      float dkx, float dvx) const {
    if (partial != nullptr) {
      partial[split * n + off + c] = dkx;
      partial[(splits + split) * n + off + c] = dvx;
    } else {
      dk[off + c] = vilco::from_f32<T>(dkx);
      dv[off + c] = vilco::from_f32<T>(dvx);
    }
  }
};

template <int DPAD>
struct DkvLayout {
  static constexpr int BK = 64, THREADS = 128;
  static constexpr int BQ = DPAD > 64 ? 32 : 64;   // query rows a step
  static constexpr int LD = DPAD + 8;
  static constexpr int QT = BQ * LD;               // one Q or dO stage
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + BK * LD * 2;
  static constexpr int Q_OFF = V_OFF + BK * LD * 2;
  static constexpr int G_OFF = Q_OFF + 2 * QT * 2;
  static constexpr int L_OFF = G_OFF + 2 * QT * 2;
  static constexpr int D_OFF = L_OFF + 2 * BQ * 4;
  static constexpr int I_OFF = D_OFF + 2 * BQ * 4;   // 1 / l (flash mode)
  static constexpr int BYTES = I_OFF + 2 * BQ * 4;
};

// (b), bfloat16. Grid (key tiles, H, B * splits); slice s of batch b takes
// query rows [s * rows_per_split, (s + 1) * rows_per_split), or in band
// mode (one slice) the key tile's window.
template <int DPAD, Mode M>
__global__ void __launch_bounds__(128)
attention_blc_dkv_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ lsum,
                            const float* __restrict__ delta,
                            const bf16* __restrict__ dout, DkvOut<bf16> dst,
                            int Tq, int Tk, int D, Strides sq, Strides sk,
                            float scale_log2, float scale, int rows_per_split,
                            Band band, bool vec) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
  using L = DkvLayout<DPAD>;
  constexpr int NQ = L::BQ / 8;   // n8 tiles of S^T (queries)
  constexpr int NO = DPAD / 8;    // n8 tiles of dk, dv (columns)
  constexpr int KD = DPAD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::G_OFF);
  float* lses = reinterpret_cast<float*>(smem + L::L_OFF);
  float* dels = reinterpret_cast<float*>(smem + L::D_OFF);
  float* linv = reinterpret_cast<float*>(smem + L::I_OFF);

  const int H = gridDim.y, h = blockIdx.y;
  const int b = blockIdx.z / dst.splits, split = blockIdx.z % dst.splits;
  const int j0 = blockIdx.x * L::BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nk = min(L::BK, Tk - j0);
  int i_begin = split * rows_per_split;
  int i_end = min(Tq, i_begin + rows_per_split);
  if constexpr (BAND) band.window(j0, j0 + nk - 1, i_begin, i_end);
  const int nsteps = i_end > i_begin ? (i_end - i_begin + L::BQ - 1) / L::BQ
                                     : 0;
  const float* lrow = lse + ((long long)b * H + h) * Tq;
  const float* srow = FLASH ? lsum + ((long long)b * H + h) * Tq : nullptr;
  const float* drow = delta + ((long long)b * H + h) * Tq;

  stage_tile<L::BK, DPAD, L::LD, L::THREADS>(ks, k + sk.at(b, j0, h), sk.st,
                                             nk, D, vec);
  stage_tile<L::BK, DPAD, L::LD, L::THREADS>(vs, v + sk.at(b, j0, h), sk.st,
                                             nk, D, vec);
  auto stage_q = [&](int t) {
    const int i0 = i_begin + t * L::BQ, s = t & 1;
    const int nq = min(L::BQ, i_end - i0);
    stage_tile<L::BQ, DPAD, L::LD, L::THREADS>(
        qs + s * L::QT, q + sq.at(b, i0, h), sq.st, nq, D, vec);
    stage_tile<L::BQ, DPAD, L::LD, L::THREADS>(
        gs + s * L::QT, dout + sq.at(b, i0, h), sq.st, nq, D, vec);
    // rows past the slice: lse (flash: m) = +inf makes their P exactly 0
    for (int r = tid; r < L::BQ; r += L::THREADS) {
      lses[s * L::BQ + r] = r < nq ? lrow[i0 + r] : INFINITY;
      dels[s * L::BQ + r] = r < nq ? drow[i0 + r] : 0.f;
      if constexpr (FLASH)
        linv[s * L::BQ + r] = r < nq ? 1.f / srow[i0 + r] : 0.f;
    }
    cp_async_commit();
  };
  if (nsteps > 0) stage_q(0);
  else cp_async_commit();
  // this lane's two key rows: warp * 16 + g and + 8 (band mode: no bias,
  // and the query rows each one sees)
  float kbias[2];
  int2 qwin[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + warp * 16 + g + 8 * r;
    if constexpr (BAND) {
      kbias[r] = 0.f;
      qwin[r] = band.range(j);
    } else {
      kbias[r] = key_bias<FLASH>(mask + (long long)b * Tk, j, Tk);
    }
  }
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = 0; t < nsteps; ++t) {
    if (t + 1 < nsteps) {
      stage_q(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + (t & 1) * L::QT;
    const bf16* gt = gs + (t & 1) * L::QT;
    const float* lt = lses + (t & 1) * L::BQ;
    const float* dt = dels + (t & 1) * L::BQ;
    const float* it = linv + (t & 1) * L::BQ;
    // band mode: the frame test where an edge crosses the tile pair (rows
    // past i_end have P = 0 from their lse already)
    const int i0 = i_begin + t * L::BQ;
    const bool test =
        BAND && !band.covers(j0, j0 + nk - 1, i0, min(i0 + L::BQ, i_end));

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, L::LD, warp * 16, kk * 16, lane);
      load_a(va, vs, L::LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4], gb[4];
        load_bt(qb, qt, L::LD, np * 16, kk * 16, lane);
        load_bt(gb, gt, L::LD, np * 16, kk * 16, lane);
        mma16816(st[2 * np], ka, qb[0], qb[1]);
        mma16816(st[2 * np + 1], ka, qb[2], qb[3]);
        mma16816(dpt[2 * np], va, gb[0], gb[1]);
        mma16816(dpt[2 * np + 1], va, gb[2], gb[3]);
      }
    }
    // P^T and dS^T, rounded to bf16 A fragments (keys x queries)
    uint32_t pa[NQ / 2][4], sa[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(lt + n * 8 + 2 * t4);
      const float2 dl = *reinterpret_cast<const float2*>(dt + n * 8 + 2 * t4);
      float p0 = exp2f(st[n][0] * scale_log2 + kbias[0] - ls.x);
      float p1 = exp2f(st[n][1] * scale_log2 + kbias[0] - ls.y);
      float p2 = exp2f(st[n][2] * scale_log2 + kbias[1] - ls.x);
      float p3 = exp2f(st[n][3] * scale_log2 + kbias[1] - ls.y);
      if constexpr (FLASH) {   // P = exp2(s - m) / l
        const float2 li = *reinterpret_cast<const float2*>(it + n * 8 + 2 * t4);
        p0 *= li.x, p1 *= li.y, p2 *= li.x, p3 *= li.y;
      }
      if constexpr (BAND) {
        if (test) {   // P^T: keys are rows, queries columns
          const int i = i0 + n * 8 + 2 * t4;
          p0 = keep_in(qwin[0], i, p0), p1 = keep_in(qwin[0], i + 1, p1);
          p2 = keep_in(qwin[1], i, p2), p3 = keep_in(qwin[1], i + 1, p3);
        }
      }
      pa[n / 2][(n & 1) * 2] = pack2(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack2(p2, p3);
      sa[n / 2][(n & 1) * 2] =
          pack2(p0 * (dpt[n][0] - dl.x), p1 * (dpt[n][1] - dl.y));
      sa[n / 2][(n & 1) * 2 + 1] =
          pack2(p2 * (dpt[n][2] - dl.x), p3 * (dpt[n][3] - dl.y));
    }
    // dv += P^T dO, dk += dS^T Q: dO and Q through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t gb[4], qb[4];
        load_b(gb, gt, L::LD, kk * 16, dp * 16, lane);
        load_b(qb, qt, L::LD, kk * 16, dp * 16, lane);
        mma16816(dv[2 * dp], pa[kk], gb[0], gb[1]);
        mma16816(dv[2 * dp + 1], pa[kk], gb[2], gb[3]);
        mma16816(dk[2 * dp], sa[kk], qb[0], qb[1]);
        mma16816(dk[2 * dp + 1], sa[kk], qb[2], qb[3]);
      }
    __syncthreads();   // this stage is refilled two steps on
  }
  cp_async_wait<0>();   // an empty slice never waited for its K and V

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + warp * 16 + g + 8 * r;
    if (j >= Tk) continue;
    const long long off = sk.at(b, j, h);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t4 + e;
        if (c < D)
          dst.put(split, off, c, dk[n][2 * r + e] * scale, dv[n][2 * r + e]);
      }
  }
}

template <int DPAD>
struct DqLayout {
  static constexpr int BQ = 64, THREADS = 128;
  static constexpr int BK = DPAD > 64 ? 32 : 64;   // keys a step
  static constexpr int LD = DPAD + 8;
  static constexpr int KT = BK * LD;               // one K or V stage
  static constexpr int Q_OFF = 0;
  static constexpr int G_OFF = Q_OFF + BQ * LD * 2;
  static constexpr int K_OFF = G_OFF + BQ * LD * 2;
  static constexpr int V_OFF = K_OFF + 2 * KT * 2;
  static constexpr int B_OFF = V_OFF + 2 * KT * 2;
  static constexpr int BYTES = B_OFF + 2 * BK * 4;
};

// (c), bfloat16. Grid (query tiles, H, B); band mode walks the query
// tile's window.
template <int DPAD, Mode M>
__global__ void __launch_bounds__(128)
attention_blc_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ lse,
                           const float* __restrict__ lsum,
                           const float* __restrict__ delta,
                           const bf16* __restrict__ dout,
                           bf16* __restrict__ dq, int Tq, int Tk, int D,
                           Strides sq, Strides sk, float scale_log2,
                           float scale, Band band, bool vec) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
  using L = DqLayout<DPAD>;
  constexpr int NS = L::BK / 8;   // n8 tiles of S (keys)
  constexpr int NO = DPAD / 8;
  constexpr int KD = DPAD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::G_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* bias = reinterpret_cast<float*>(smem + L::B_OFF);

  const int H = gridDim.y, h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * L::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint8_t* mp = BAND ? nullptr : mask + (long long)b * Tk;
  const int nq = min(L::BQ, Tq - i0);
  int j_begin = 0, j_end = Tk;
  if constexpr (BAND) band.window(i0, i0 + nq - 1, j_begin, j_end);
  const int ntiles = (j_end - j_begin + L::BK - 1) / L::BK;

  stage_tile<L::BQ, DPAD, L::LD, L::THREADS>(qs, q + sq.at(b, i0, h), sq.st,
                                             nq, D, vec);
  stage_tile<L::BQ, DPAD, L::LD, L::THREADS>(gs, dout + sq.at(b, i0, h),
                                             sq.st, nq, D, vec);
  auto stage_kv = [&](int t) {
    const int j0 = j_begin + t * L::BK, s = t & 1;
    const int nk = min(L::BK, j_end - j0);
    stage_tile<L::BK, DPAD, L::LD, L::THREADS>(
        ks + s * L::KT, k + sk.at(b, j0, h), sk.st, nk, D, vec);
    stage_tile<L::BK, DPAD, L::LD, L::THREADS>(
        vs + s * L::KT, v + sk.at(b, j0, h), sk.st, nk, D, vec);
    for (int jj = tid; jj < L::BK; jj += L::THREADS)
      bias[s * L::BK + jj] = BAND ? 0.f : key_bias<FLASH>(mp, j0 + jj, Tk);
    cp_async_commit();
  };
  stage_kv(0);
  // this lane's two query rows: warp * 16 + g and + 8 (rl: lse, or m in
  // flash mode; ri: 1 / l in flash mode; kwin: the keys each sees in band
  // mode)
  float rl[2], rd[2], ri[2];
  int2 kwin[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + g + 8 * r;
    const long long at = ((long long)b * H + h) * Tq + i;
    rl[r] = i < Tq ? lse[at] : INFINITY;
    rd[r] = i < Tq ? delta[at] : 0.f;
    ri[r] = FLASH && i < Tq ? 1.f / lsum[at] : 0.f;
    if constexpr (BAND) kwin[r] = band.range(i);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + (t & 1) * L::KT;
    const bf16* vt = vs + (t & 1) * L::KT;
    const float* bt = bias + (t & 1) * L::BK;
    // band mode: the frame test where an edge crosses the tile pair (keys
    // past j_end were staged as zeros and need it too)
    const int j0 = j_begin + t * L::BK;
    const bool test =
        BAND && !band.covers(i0, i0 + nq - 1, j0, j0 + L::BK);

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], ga[4];
      load_a(qa, qs, L::LD, warp * 16, kk * 16, lane);
      load_a(ga, gs, L::LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4], vb[4];
        load_bt(kb, kt, L::LD, np * 16, kk * 16, lane);
        load_bt(vb, vt, L::LD, np * 16, kk * 16, lane);
        mma16816(s[2 * np], qa, kb[0], kb[1]);
        mma16816(s[2 * np + 1], qa, kb[2], kb[3]);
        mma16816(dp[2 * np], ga, vb[0], vb[1]);
        mma16816(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    // dS = P (dP - delta), rounded to bf16 A fragments
    uint32_t sa[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + n * 8 + 2 * t4);
      float p0 = exp2f(s[n][0] * scale_log2 + bb.x - rl[0]);
      float p1 = exp2f(s[n][1] * scale_log2 + bb.y - rl[0]);
      float p2 = exp2f(s[n][2] * scale_log2 + bb.x - rl[1]);
      float p3 = exp2f(s[n][3] * scale_log2 + bb.y - rl[1]);
      if constexpr (FLASH)   // P = exp2(s - m) / l
        p0 *= ri[0], p1 *= ri[0], p2 *= ri[1], p3 *= ri[1];
      if constexpr (BAND) {
        if (test) {
          const int j = j0 + n * 8 + 2 * t4;
          p0 = keep_in(kwin[0], j, p0), p1 = keep_in(kwin[0], j + 1, p1);
          p2 = keep_in(kwin[1], j, p2), p3 = keep_in(kwin[1], j + 1, p3);
        }
      }
      sa[n / 2][(n & 1) * 2] =
          pack2(p0 * (dp[n][0] - rd[0]), p1 * (dp[n][1] - rd[0]));
      sa[n / 2][(n & 1) * 2 + 1] =
          pack2(p2 * (dp[n][2] - rd[1]), p3 * (dp[n][3] - rd[1]));
    }
    // dq += dS K, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
      for (int dpi = 0; dpi < NO / 2; ++dpi) {
        uint32_t kb[4];
        load_b(kb, kt, L::LD, kk * 16, dpi * 16, lane);
        mma16816(acc[2 * dpi], sa[kk], kb[0], kb[1]);
        mma16816(acc[2 * dpi + 1], sa[kk], kb[2], kb[3]);
      }
    __syncthreads();   // this stage is refilled two tiles on
  }
  store_rows<NO>(acc, scale, scale, warp * 16, nq, D, vec,
                 [&](int i) { return dq + sq.at(b, i0 + i, h); }, lane);
}

// ---- backward, float32 (SIMT) ---------------------------------------------

constexpr int BT = 64;             // key and query tile of the backward
constexpr int BWD_THREADS = 256;   // 16 x 16

template <int DPAD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * BT * (DPAD + 1) + 2 * BT * (BT + 1) + 6 * BT);
}

// linv: 1 / l of each query row in flash mode (lses then holds m); qf, kf:
// the frames of the query and key rows in band mode
template <int DPAD>
struct SimtTiles {
  static constexpr int LD = DPAD + 1, LP = BT + 1;
  float *qs, *gs, *ks, *vs, *ps, *dss, *bias, *lses, *delta, *linv;
  int *qf, *kf;
  __device__ explicit SimtTiles(float* sm)
      : qs(sm), gs(qs + BT * LD), ks(gs + BT * LD), vs(ks + BT * LD),
        ps(vs + BT * LD), dss(ps + BT * LP), bias(dss + BT * LP),
        lses(bias + BT), delta(lses + BT), linv(delta + BT),
        qf(reinterpret_cast<int*>(linv + BT)), kf(qf + BT) {}
};

// band mode: the frames of rows [r0, r0 + valid), `pad` past them (a query
// pad and a key pad are further than any w apart)
__device__ __forceinline__ void simt_frames(int* f, int r0, int valid,
                                            int fr, int pad) {
  for (int r = threadIdx.x; r < BT; r += BWD_THREADS)
    f[r] = r < valid ? (r0 + r) / fr : pad;
}

// lse (flash: m), delta and 1 / l of the query rows [i0, i0 + nq) of a
// head; rows past them get lse = +inf, so their P is exactly 0
template <int DPAD, bool FLASH>
__device__ __forceinline__ void simt_rowstats(const SimtTiles<DPAD>& sm,
                                              const float* lse,
                                              const float* lsum,
                                              const float* delta,
                                              long long at0, int nq) {
  for (int r = threadIdx.x; r < BT; r += BWD_THREADS) {
    const long long at = at0 + r;
    sm.lses[r] = r < nq ? lse[at] : INFINITY;
    sm.delta[r] = r < nq ? delta[at] : 0.f;
    sm.linv[r] = FLASH && r < nq ? 1.f / lsum[at] : 0.f;
  }
}

// rows [r0, r0 + valid) of a head into a [BT][LD] f32 tile, zero elsewhere
template <int DPAD>
__device__ __forceinline__ void simt_stage(float* dst, const float* src,
                                           Strides s, int b, int h, int r0,
                                           int valid, int D) {
  for (int e = threadIdx.x; e < BT * DPAD; e += BWD_THREADS) {
    const int r = e / DPAD, d = e % DPAD;
    dst[r * (DPAD + 1) + d] =
        (r < valid && d < D) ? src[s.at(b, r0 + r, h) + d] : 0.f;
  }
}

// P and dS of the staged query tile (qs, gs, lses, delta) against the
// staged key tile (ks, vs, bias), into ps and dss: thread (ty, tx) takes
// query rows ty + 16a and keys tx + 16c. Band mode: P = 0 where the rows'
// frames (qf, kf) are more than w apart.
template <int DPAD, Mode M>
__device__ __forceinline__ void simt_p_ds(const SimtTiles<DPAD>& sm,
                                          float scale_log2, int tx, int ty,
                                          int w) {
  constexpr int LD = SimtTiles<DPAD>::LD, LP = SimtTiles<DPAD>::LP;
  constexpr int RA = BT / 16;
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
      qv[a] = sm.qs[(ty + 16 * a) * LD + d];
      gv[a] = sm.gs[(ty + 16 * a) * LD + d];
      kv[a] = sm.ks[(tx + 16 * a) * LD + d];
      vv[a] = sm.vs[(tx + 16 * a) * LD + d];
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
      float p = exp2f(s[a][c] * scale_log2 + sm.bias[j] - sm.lses[i]);
      if constexpr (M == Mode::Flash) p *= sm.linv[i];   // exp2(s - m) / l
      if constexpr (M == Mode::FrameBand)
        p = abs(sm.qf[i] - sm.kf[j]) <= w ? p : 0.f;
      sm.ps[i * LP + j] = p;
      sm.dss[i * LP + j] = p * (dp[a][c] - sm.delta[i]);
    }
}

// (b), float32. Grid (key tiles, H, B * splits); band mode walks the key
// tile's window.
template <int DPAD, Mode M>
__global__ void __launch_bounds__(BWD_THREADS)
attention_blc_dkv_simt_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ lsum,
                              const float* __restrict__ delta,
                              const float* __restrict__ dout,
                              DkvOut<float> dst, int Tq, int Tk, int D,
                              Strides sq, Strides sk, float scale_log2,
                              float scale, int rows_per_split, Band band) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
  constexpr int LD = SimtTiles<DPAD>::LD, LP = SimtTiles<DPAD>::LP;
  constexpr int RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float smf[];
  const SimtTiles<DPAD> sm(smf);
  const int H = gridDim.y, h = blockIdx.y;
  const int b = blockIdx.z / dst.splits, split = blockIdx.z % dst.splits;
  const int j0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = min(BT, Tk - j0);
  int i_begin = split * rows_per_split;
  int i_end = min(Tq, i_begin + rows_per_split);
  if constexpr (BAND) band.window(j0, j0 + nk - 1, i_begin, i_end);

  simt_stage<DPAD>(sm.ks, k, sk, b, h, j0, nk, D);
  simt_stage<DPAD>(sm.vs, v, sk, b, h, j0, nk, D);
  for (int r = tid; r < BT; r += BWD_THREADS)
    sm.bias[r] = BAND ? 0.f
                      : key_bias<FLASH>(mask + (long long)b * Tk, j0 + r, Tk);
  if constexpr (BAND) simt_frames(sm.kf, j0, nk, band.fr, FAR);
  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += BT) {
    __syncthreads();   // the previous query tile is no longer read
    const int nq = min(BT, i_end - i0);
    simt_stage<DPAD>(sm.qs, q, sq, b, h, i0, nq, D);
    simt_stage<DPAD>(sm.gs, dout, sq, b, h, i0, nq, D);
    simt_rowstats<DPAD, FLASH>(sm, lse, lsum, delta,
                               ((long long)b * H + h) * Tq + i0, nq);
    if constexpr (BAND) simt_frames(sm.qf, i0, nq, band.fr, -FAR);
    __syncthreads();
    simt_p_ds<DPAD, M>(sm, scale_log2, tx, ty, band.w);
    __syncthreads();
    // dv += P^T dO, dk += dS^T Q: key rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float pv[RA], sv[RA], gv[CD], qv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pv[a] = sm.ps[i * LP + ty + 16 * a];
        sv[a] = sm.dss[i * LP + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        gv[c] = sm.gs[i * LD + tx + 16 * c];
        qv[c] = sm.qs[i * LD + tx + 16 * c];
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
    if (j >= Tk) continue;
    const long long off = sk.at(b, j, h);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dst.put(split, off, d, dk_acc[a][c] * scale, dv_acc[a][c]);
    }
  }
}

// (c), float32. Grid (query tiles, H, B); band mode walks the query tile's
// window.
template <int DPAD, Mode M>
__global__ void __launch_bounds__(BWD_THREADS)
attention_blc_dq_simt_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ lse,
                             const float* __restrict__ lsum,
                             const float* __restrict__ delta,
                             const float* __restrict__ dout,
                             float* __restrict__ dq, int Tq, int Tk, int D,
                             Strides sq, Strides sk, float scale_log2,
                             float scale, Band band) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
  constexpr int LD = SimtTiles<DPAD>::LD, LP = SimtTiles<DPAD>::LP;
  constexpr int RA = BT / 16, CD = DPAD / 16;
  extern __shared__ __align__(16) float smf[];
  const SimtTiles<DPAD> sm(smf);
  const int H = gridDim.y, h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * BT;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = min(BT, Tq - i0);

  simt_stage<DPAD>(sm.qs, q, sq, b, h, i0, nq, D);
  simt_stage<DPAD>(sm.gs, dout, sq, b, h, i0, nq, D);
  simt_rowstats<DPAD, FLASH>(sm, lse, lsum, delta,
                             ((long long)b * H + h) * Tq + i0, nq);
  int j_begin = 0, j_end = Tk;
  if constexpr (BAND) {
    band.window(i0, i0 + nq - 1, j_begin, j_end);
    simt_frames(sm.qf, i0, nq, band.fr, -FAR);
  }
  float dq_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_acc[a][c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += BT) {
    __syncthreads();   // the previous key tile is no longer read
    const int nk = min(BT, j_end - j0);
    simt_stage<DPAD>(sm.ks, k, sk, b, h, j0, nk, D);
    simt_stage<DPAD>(sm.vs, v, sk, b, h, j0, nk, D);
    for (int r = tid; r < BT; r += BWD_THREADS)
      sm.bias[r] = BAND ? 0.f : key_bias<FLASH>(mask + (long long)b * Tk,
                                                j0 + r, Tk);
    if constexpr (BAND) simt_frames(sm.kf, j0, nk, band.fr, FAR);
    __syncthreads();
    simt_p_ds<DPAD, M>(sm, scale_log2, tx, ty, band.w);
    __syncthreads();
    // dq += dS K: query rows ty + 16a, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float sv[RA], kv[CD];
#pragma unroll
      for (int a = 0; a < RA; ++a) sv[a] = sm.dss[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = sm.ks[j * LD + tx + 16 * c];
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
    if (i >= Tq) continue;
    float* dqp = dq + sq.at(b, i, h);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqp[d] = dq_acc[a][c] * scale;
    }
  }
}

// ---- launchers --------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *mask, *out, *lse, *lsum, *dout;
  void *dq, *dk, *dv, *delta, *partial;
  int B, Tq, Tk, H, D, splits;
  Strides sq, sk;
  float scale_log2, scale;
  int rows_per_split;   // a multiple of 64
  Band band;            // band mode only
};

template <typename T>
cudaError_t launch_delta(const BwdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.H * a.Tq;
  attention_blc_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const T*)a.out, (const T*)a.dout, (float*)a.delta, rows, a.Tq, a.H,
      a.D, a.sq);
  return cudaGetLastError();
}

// the slices' dk/dv partials summed into dk, dv (nothing for one slice)
template <typename T>
cudaError_t launch_sum(const BwdArgs& a, cudaStream_t s) {
  if (a.splits == 1) return cudaSuccess;
  const long long n = (long long)a.B * a.Tk * a.H * a.D;
  const unsigned blocks =
      (unsigned)std::min<long long>((n + 255) / 256, 132LL * 16);
  attention_blc_sum_kernel<T><<<blocks, 256, 0, s>>>(
      (const float*)a.partial, (T*)a.dk, (T*)a.dv, n, a.splits);
  return cudaGetLastError();
}

template <typename T>
DkvOut<T> dkv_out(const BwdArgs& a) {
  return DkvOut<T>{(T*)a.dk, (T*)a.dv,
                   a.splits > 1 ? (float*)a.partial : nullptr,
                   (long long)a.B * a.Tk * a.H * a.D, a.splits};
}

template <int DPAD, Mode M>
cudaError_t launch_bwd_tc(const BwdArgs& a, cudaStream_t s) {
  cudaError_t e = launch_delta<bf16>(a, s);
  if (e != cudaSuccess) return e;
  const bool vec = vec_ok(a.D, a.sq, a.sk, {a.q, a.k, a.v, a.dout, a.dq});
  using KL = DkvLayout<DPAD>;
  auto kd = attention_blc_dkv_tc_kernel<DPAD, M>;
  if ((e = set_smem(kd, KL::BYTES)) != cudaSuccess) return e;
  kd<<<dim3((a.Tk + KL::BK - 1) / KL::BK, a.H, a.B * a.splits), KL::THREADS,
       KL::BYTES, s>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const uint8_t*)a.mask, (const float*)a.lse, (const float*)a.lsum,
      (const float*)a.delta, (const bf16*)a.dout, dkv_out<bf16>(a), a.Tq,
      a.Tk, a.D, a.sq, a.sk, a.scale_log2, a.scale, a.rows_per_split,
      a.band, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = launch_sum<bf16>(a, s)) != cudaSuccess) return e;
  using QL = DqLayout<DPAD>;
  auto kq = attention_blc_dq_tc_kernel<DPAD, M>;
  if ((e = set_smem(kq, QL::BYTES)) != cudaSuccess) return e;
  kq<<<dim3((a.Tq + QL::BQ - 1) / QL::BQ, a.H, a.B), QL::THREADS, QL::BYTES,
       s>>>((const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
            (const uint8_t*)a.mask, (const float*)a.lse,
            (const float*)a.lsum, (const float*)a.delta,
            (const bf16*)a.dout, (bf16*)a.dq, a.Tq, a.Tk, a.D, a.sq, a.sk,
            a.scale_log2, a.scale, a.band, vec);
  return cudaGetLastError();
}

template <int DPAD, Mode M>
cudaError_t launch_bwd_simt(const BwdArgs& a, cudaStream_t s) {
  cudaError_t e = launch_delta<float>(a, s);
  if (e != cudaSuccess) return e;
  const int smem = (int)bwd_smem_bytes<DPAD>();
  auto kd = attention_blc_dkv_simt_kernel<DPAD, M>;
  if ((e = set_smem(kd, smem)) != cudaSuccess) return e;
  kd<<<dim3((a.Tk + BT - 1) / BT, a.H, a.B * a.splits), BWD_THREADS, smem,
       s>>>((const float*)a.q, (const float*)a.k, (const float*)a.v,
            (const uint8_t*)a.mask, (const float*)a.lse,
            (const float*)a.lsum, (const float*)a.delta,
            (const float*)a.dout, dkv_out<float>(a), a.Tq, a.Tk, a.D, a.sq,
            a.sk, a.scale_log2, a.scale, a.rows_per_split, a.band);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = launch_sum<float>(a, s)) != cudaSuccess) return e;
  auto kq = attention_blc_dq_simt_kernel<DPAD, M>;
  if ((e = set_smem(kq, smem)) != cudaSuccess) return e;
  kq<<<dim3((a.Tq + BT - 1) / BT, a.H, a.B), BWD_THREADS, smem, s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const uint8_t*)a.mask, (const float*)a.lse, (const float*)a.lsum,
      (const float*)a.delta, (const float*)a.dout, (float*)a.dq, a.Tq, a.Tk,
      a.D, a.sq, a.sk, a.scale_log2, a.scale, a.band);
  return cudaGetLastError();
}

// The passes of mode M at the padded width for D: f32 SIMT at 64 or 128
// (band mode also at 32, the VQ encoder's head width, where 64 would
// double the work), bf16 on mma.sync at 32, 64, 96 or 128 (flash mode at
// 64 or 128).
template <Mode M>
cudaError_t dispatch(const BwdArgs& a, int dtype, cudaStream_t s) {
  const int D = a.D;
  if (dtype == 0) {
    if constexpr (M == Mode::FrameBand)
      if (D <= 32) return launch_bwd_simt<32, M>(a, s);
    return D <= 64 ? launch_bwd_simt<64, M>(a, s)
                   : launch_bwd_simt<128, M>(a, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (M == Mode::Flash)
    return D <= 64 ? launch_bwd_tc<64, M>(a, s) : launch_bwd_tc<128, M>(a, s);
  else
    return D <= 32   ? launch_bwd_tc<32, M>(a, s)
           : D <= 64 ? launch_bwd_tc<64, M>(a, s)
           : D <= 96 ? launch_bwd_tc<96, M>(a, s)
                     : launch_bwd_tc<128, M>(a, s);
}

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace

// Backward: (a) delta, (b) dk/dv, the f32 partials' sum where splits > 1,
// (c) dq; no atomics. q/out/dout/dq and k/v/dk/dv in dtype and the
// forward's layout, lse (B, H, Tq) from the forward, delta (B, H, Tq) f32
// scratch, partial 2 * splits * numel(k) f32 scratch (null for one slice),
// all contiguous; D <= 128. splits (>= 1) cuts the query range of the
// dk/dv pass into slices of whole 64-row tiles. lsum non-null selects
// flash mode (K1f): lse then holds the forward's row max m and lsum its
// row sum l (both (B, H, Tq) f32), P = exp2(s - m) / l and masked keys
// score the library's -0.7 * FLT_MAX; flash mode pads D to 64 or 128.
extern "C" int attention_blc_bwd(const void* q, const void* k, const void* v,
                                 const void* mask, const void* out,
                                 const void* lse, const void* lsum,
                                 const void* dout, void* dq, void* dk,
                                 void* dv, void* delta, void* partial, int B,
                                 int Tq, int Tk, int H, int D, int dtype,
                                 int layout, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || B < 1 || Tq < 1 || Tk < 1 || H < 1 ||
      layout < 0 || layout > 1 || splits < 1 ||
      (long long)B * splits > 65535 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool hm = layout == 1;
  const float scale = 1.f / sqrtf((float)D);
  const int tiles = (Tq + BT - 1) / BT;
  const BwdArgs a{q, k, v, mask, out, lse, lsum, dout, dq, dk, dv, delta,
                  partial, B, Tq, Tk, H, D, splits,
                  strides_of(hm, B, Tq, H, D), strides_of(hm, B, Tk, H, D),
                  scale * LOG2E, scale, ((tiles + splits - 1) / splits) * BT,
                  Band{}};
  return (int)(lsum != nullptr ? dispatch<Mode::Flash>(a, dtype, s)
                               : dispatch<Mode::K1>(a, dtype, s));
}

// K6's backward, the passes in band mode: (a) delta, (b) dk/dv over each
// key tile's window, (c) dq over each query tile's window; no atomics.
// q/k/v/out/dout/dq/dk/dv (B, L, H * D) channels-last in dtype, L =
// n_frames * fr, D <= 128, w >= 0; lse (B, H, L) f32 from
// csrc/attention_blc.cu's frame_band_fwd; delta (B, H, L) f32 scratch; all
// contiguous.
extern "C" int frame_band_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int L, int H, int D, int fr,
                              int w, int dtype, void* stream) {
  if (D < 1 || D > 128 || B < 1 || L < 1 || L >= FAR / 2 || H < 1 ||
      fr < 1 || w < 0 || w >= FAR / 2 || L % fr != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  const Strides st = strides_of(false, B, L, H, D);
  const BwdArgs a{q, k, v, nullptr, out, lse, nullptr, dout, dq, dk, dv,
                  delta, nullptr, B, L, L, H, D, 1, st, st, scale * LOG2E,
                  scale, (L + BT - 1) / BT * BT, Band{L, fr, w, L / fr}};
  return (int)dispatch<Mode::FrameBand>(a, dtype, (cudaStream_t)stream);
}
