// Masked softmax attention, forward, on channels-last or head-major q/k/v.
//
// Replaces vilco_tpu/kernels/attention.py::fused_attention_blc's forward
// (the Pallas _fwd_kernel_blc run by _run_fwd_blc) and, on the head-major
// layout, fused_attention's (K1n: the Pallas _fwd_kernel run by _run_fwd,
// the same function on (H, B, T, D) folded tensors); the backward of both
// is csrc/attention_blc_bwd.cu. The kernels address rows
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
// Flash mode (a template switch, variant 4) is K1f: it replaces
// vilco_tpu/kernels/attention.py::flash_attention_jax's forward (JAX's TPU
// flash-attention kernel) with the library's semantics on the same tiles:
//   s = (q . k in f32) * scale * log2 e + bias,  bias = 0 for valid keys,
//       FLASH_MASK = -0.7 * FLT_MAX (added as it is) for masked ones, -inf
//       at or past Tk (skipped);
//   m = row max of s from -inf, no floor;  o = sum_j exp2(s_j - m) v_j / l,
//       l = sum_j exp2(s_j - m) >= 1, no 1e-30.
// A fully masked row has every score equal to FLASH_MASK (it absorbs every
// finite score), so it averages v over all Tk keys, as the library does.
// exp2 of the log2-scaled score is the library's natural exp up to the f32
// rounding of the scale product. When asked it stores m and l apart (not
// lse: m + log2 l rounds to m at m = FLASH_MASK, losing the 1 / Tk the
// backward needs).
//
// Band mode (a template switch; K6) replaces
// vilco_tpu/kernels/frame_band.py::frame_band_attention's forward (the
// Pallas _fwd_kernel run by _forward; its backward is the band mode of
// csrc/attention_blc_bwd.cu, which reads the lse stored here), on
// channels-last q/k/v (B, L, H * D) with no mask. L = n_frames * fr tokens
// in frames of fr; token i sees every token of the frames within +-w of its
// own, inside [0, n_frames) (attention_blc.cuh::Band):
//   s_ij = (q_i . k_j) * scale * log2 e  in the band, -inf elsewhere
// (before the row max), then K1's floor, sum and lse. Every row sees its
// own frame, so l >= 1 and K1's 1e-30 changes no bit of 1 / l or of lse.
// A block walks only the key tiles of its rows' window of frames, not 0 to
// Tk: at the VQ flagship (fr 64, w 2, 8 heads of 32, L 1920) a 128-row
// block is two frames and walks 6 key tiles, not 30. Where a tile pair is
// covered (Band::covers: every row sees every key) there is no element
// test; elsewhere each score is tested against its row's range
// (Band::range). A warp skips a key tile that no row of its own sees (at
// fr 64 each warp's 32 rows lie in one frame: one tile of the 6), which
// leaves m, l and o as an all -inf tile would. What bounds it: the band
// makes the attention block-dense at ~29 operations a byte at the
// flagship, far under the ~295 where the tensor cores would limit, so the
// staging of q, k and v and the latency of the short walk.
//
// The forward also carries the two switches of the VQ attention probe
// (tools/probe_vq_attn.py::run_variant, P2), as template parameters whose
// defaults compile to the plain K1 forward:
//  - BOUND_SHIFT: the running row max is replaced by a shift fixed before
//    the key loop, |q_i * scale * log2 e| * max_j |k_j| over all Tk keys of
//    the head (a first pass of the block over K). Softmax is shift-
//    invariant and the shift bounds every score, so no rescaling of the
//    running sum and output is needed; far above the row max it underflows.
//  - MXU_SUM (bf16 only): the row sum is taken over the bf16-rounded P
//    fragments as an mma.sync product with a ones fragment, not from the
//    f32 values. f32 ignores it.
//
// Forward: one block per (query tile, head, batch) walks the keys in tiles
// with an online softmax (running max and sum per query row), so no score
// tile leaves the chip.
//  - bfloat16 (the serving path), FlashAttention-2's design on mma.sync:
//    4 warps, each owning 32 query rows (two strips of 16, so each K and V
//    fragment read from shared memory feeds two products; one strip where
//    D > 64, whose O would not fit twice). Q is loaded once and kept as bf16
//    A fragments in registers (ldmatrix). K and V tiles of 64 keys stream
//    through a two-stage cp.async ring in shared memory (rows padded by 16
//    bytes, so ldmatrix has no bank conflicts); tile t+1 loads while tile t
//    is in the tensor cores. S = Q K^T (mma.sync.m16n8k16, bf16 in, f32
//    accumulate) stays in the accumulator registers; the row max and row
//    sum are reduced across each quad of lanes by shuffles; P is rounded to
//    bf16 straight from the S accumulators into A fragments (as the TPU
//    kernel rounds e before its P V dot, with l summed from the f32
//    values); O += P V reads V through ldmatrix.trans, and O stays in
//    registers until it is stored once with lse. Templated on the padded
//    head width DPAD in {32, 64, 96, 128}. What bounds it: the tensor
//    cores' issue rate, fed from shared memory through ldmatrix (each warp
//    reads the whole K and V tile), and, at short key lengths, the load of
//    Q and the first K/V tile, which nothing overlaps.
//  - float32 (the parity path; TF32 would not be f32): SIMT, one thread per
//    query row holding q and the output in registers, key tiles of 32 read
//    as shared-memory broadcasts. Bound by FMA issue (2 * D FMAs per score).
//    Band mode pads D to 32, 64 or 128 (32, the VQ encoder's head width,
//    where 64 would double the work).
// Every Tq, Tk >= 1 and D <= 128 is taken; in band mode every n_frames,
// fr >= 1 and w >= 0. When asked, the forward also
// stores lse = m + log2(l + 1e-30) per (batch, head, query row), the row's
// log-sum-exp in the log2 domain; a fully masked row gets -1e8 - 99.7, so
// exp2(s - lse) is 0 there in the backward too.
//
// Three libraries are built from this file, so that nvcc compiles their
// template instances side by side: this file itself (K1, K1n and K1f),
// csrc/attention_blc_probe.cu, which includes it with VILCO_PROBE_VARIANTS
// defined (the probe's variants 1-3 alone), and csrc/attention_blc_band.cu,
// with VILCO_FRAME_BAND defined (K6's frame_band_fwd alone).

#include "attention_blc.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block (= threads)
constexpr int BK = 32;            // keys per shared-memory tile

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

template <typename T, int DPAD, bool BOUND_SHIFT, Mode M>
__global__ void __launch_bounds__(BQ)
attention_blc_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const uint8_t* __restrict__ mask,
                          T* __restrict__ out, float* __restrict__ lse,
                          float* __restrict__ lsum, int Tq, int Tk, int D,
                          Strides sq, Strides sk, float scale_log2,
                          Band band) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
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
  float m = FLASH ? -INFINITY : ROWMAX_FLOOR, l = 0.f;
  if constexpr (BOUND_SHIFT) {
    float qn2 = 0.f;
#pragma unroll
    for (int d = 0; d < DPAD; ++d) qn2 = fmaf(qr[d], qr[d], qn2);
    m = sqrtf(qn2) * sqrtf(key_norm2_max<T, BQ>(k, sk, b, h, Tk, D, red));
  }
  const uint8_t* mp = BAND ? nullptr : mask + (long long)b * Tk;
  // the keys [j_begin, j_end) the block walks: all, or in band mode its
  // rows' window, with this row's own range (none past Tq)
  int j_begin = 0, j_end = Tk;
  int2 win = make_int2(0, 0);
  if constexpr (BAND) {
    const int r0 = blockIdx.x * BQ;
    band.window(r0, min(Tq, r0 + BQ) - 1, j_begin, j_end);
    win = band.range(row);
  }

  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    for (int e = threadIdx.x; e < BK * DPAD; e += BQ) {
      const int jj = e / DPAD, d = e % DPAD, j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < j_end && d < D) {
        const long long off = sk.at(b, j, h) + d;
        kv = vilco::to_f32<T>(k[off]);
        vv = vilco::to_f32<T>(v[off]);
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    if constexpr (!BAND)
      for (int jj = threadIdx.x; jj < BK; jj += BQ)
        bias[jj] = key_bias<FLASH>(mp, j0 + jj, Tk);
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
      s[jj] = BAND ? keep_in(win, j0 + jj, acc, -INFINITY) : acc + bias[jj];
      tmax = fmaxf(tmax, s[jj]);
    }
    if constexpr (!BOUND_SHIFT) {   // with the fixed shift, nothing rescales
      // (flash: m_new is finite, the tile having a key < Tk; alpha is 0 on
      // the first tile; band mode: a tile out of the row's band has tmax
      // -inf, so alpha 1 and every p 0)
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
    // flash: l >= 1 (the max term is exp2(0)), so no 1e-30
    const float inv = 1.f / (FLASH ? l : l + 1e-30f);
    T* op = out + sq.at(b, row, h);
#pragma unroll
    for (int d = 0; d < DPAD; ++d)
      if (d < D) op[d] = vilco::from_f32<T>(o[d] * inv);
    if (lse != nullptr) {
      const long long r = ((long long)b * gridDim.y + h) * Tq + row;
      if constexpr (FLASH) {
        lse[r] = m;
        lsum[r] = l;
      } else {
        lse[r] = m + log2f(l + 1e-30f);
      }
    }
  }
}

// MS strips of 16 query rows a warp: two where the head is at most 64 wide
// (each K and V fragment read from shared memory then feeds two products),
// one above (the registers would not hold two strips' O).
template <int DPAD>
struct FwdLayout {
  static constexpr int MS = DPAD <= 64 ? 2 : 1;
  static constexpr int BQ = 64 * MS, BK = 64, THREADS = 128;
  static constexpr int LD = DPAD + 8;      // bf16 rows of Q, K, V (+16 B)
  static constexpr int TILE = BK * LD;     // elements of one K or V stage
  // byte offsets, each a multiple of 128
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LD * 2;
  static constexpr int V_OFF = K_OFF + 2 * TILE * 2;
  static constexpr int B_OFF = V_OFF + 2 * TILE * 2;
  static constexpr int BYTES = B_OFF + 2 * BK * 4;
};

template <int DPAD, bool BOUND_SHIFT, bool MXU_SUM, Mode M>
__global__ void __launch_bounds__(128)
attention_blc_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ lsum, int Tq, int Tk, int D,
                        Strides sq, Strides sk, float scale_log2, bool vec,
                        Band band) {
  constexpr bool FLASH = M == Mode::Flash, BAND = M == Mode::FrameBand;
  using L = FwdLayout<DPAD>;
  constexpr int MS = L::MS;
  constexpr int NS = L::BK / 8;   // n8 tiles of S (keys)
  constexpr int NO = DPAD / 8;    // n8 tiles of O (columns)
  constexpr int KD = DPAD / 16;   // k16 steps of Q K^T
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  float* bias = reinterpret_cast<float*>(smem + L::B_OFF);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = warp * 16 * MS;   // this warp's first row in the tile
  const uint8_t* mp = BAND ? nullptr : mask + (long long)b * Tk;
  // the keys [j_begin, j_end) the block walks: all, or in band mode its
  // rows' window (no bias: keys past j_end are staged as zeros and fail
  // the element test)
  int j_begin = 0, j_end = Tk;
  if constexpr (BAND)
    band.window(q0, min(Tq, q0 + L::BQ) - 1, j_begin, j_end);
  const int ntiles = (j_end - j_begin + L::BK - 1) / L::BK;

  auto stage_kv = [&](int t) {
    const int j0 = j_begin + t * L::BK, s = t & 1;
    const int nk = min(L::BK, j_end - j0);
    stage_tile<L::BK, DPAD, L::LD, L::THREADS>(
        ks + s * L::TILE, k + sk.at(b, j0, h), sk.st, nk, D, vec);
    stage_tile<L::BK, DPAD, L::LD, L::THREADS>(
        vs + s * L::TILE, v + sk.at(b, j0, h), sk.st, nk, D, vec);
    if constexpr (!BAND)
      for (int jj = tid; jj < L::BK; jj += L::THREADS)
        bias[s * L::BK + jj] = key_bias<FLASH>(mp, j0 + jj, Tk);
    cp_async_commit();
  };

  stage_tile<L::BQ, DPAD, L::LD, L::THREADS>(
      qs, q + sq.at(b, q0, h), sq.st, min(L::BQ, Tq - q0), D, vec);
  stage_kv(0);   // one group: Q and the first K/V tile

  // [strip][r]: rows w0 + 16 strip + g (r = 0) and + 8 (r = 1)
  float m[MS][2], l[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      m[ms][r] = FLASH ? -INFINITY : ROWMAX_FLOOR, l[ms][r] = 0.f;
  float kn2 = 0.f;
  if constexpr (BOUND_SHIFT) {
    __shared__ float red[L::THREADS / 32];
    kn2 = key_norm2_max<bf16, L::THREADS>(k, sk, b, h, Tk, D, red);
  }
  // band mode: this warp's rows r0 .. r1 (none past Tq), the keys [wlo,
  // whi) they reach together (none if the warp has no row), and the range
  // each of this lane's rows sees
  int r0 = 0, r1 = -1, wlo = 0, whi = 0;
  int2 kwin[MS][2];
  if constexpr (BAND) {
    r0 = q0 + w0, r1 = min(Tq, r0 + 16 * MS) - 1;
    if (r0 <= r1) band.window(r0, r1, wlo, whi);
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        kwin[ms][r] = band.range(r0 + 16 * ms + g + 8 * r);
  }
  uint32_t qf[MS][KD][4];
  float o[MS][NO][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[ms][n][0] = o[ms][n][1] = o[ms][n][2] = o[ms][n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          load_a(qf[ms][kk], qs, L::LD, w0 + 16 * ms, kk * 16, lane);
      if constexpr (BOUND_SHIFT) {
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bf16* qrow = qs + (w0 + 16 * ms + g + 8 * r) * L::LD;
            float qn2 = 0.f;   // |q_row * scale * log2 e|^2, by the quad
            for (int d = t4; d < DPAD; d += 4) {
              const float x = __bfloat162float(qrow[d]) * scale_log2;
              qn2 = fmaf(x, x, qn2);
            }
            qn2 += __shfl_xor_sync(0xffffffffu, qn2, 1);
            qn2 += __shfl_xor_sync(0xffffffffu, qn2, 2);
            m[ms][r] = sqrtf(qn2) * sqrtf(kn2);
          }
      }
    }
    const bf16* kt = ks + (t & 1) * L::TILE;
    const bf16* vt = vs + (t & 1) * L::TILE;
    const float* bt = bias + (t & 1) * L::BK;
    // band mode: a tile no row of this warp sees is skipped (every score
    // -inf would leave m, l and o as they are); the element test where an
    // edge of the band crosses this warp's rows' pair with the tile (keys
    // past j_end, staged as zeros, need it too)
    const int j0 = j_begin + t * L::BK;
    bool run = true, test = false;
    if constexpr (BAND) {
      run = j0 < whi && j0 + L::BK > wlo;
      test = !band.covers(r0, r1, j0, j0 + L::BK);
    }
    if (run) {
      // S (this warp's MS x 16 rows x 64 keys) = Q K^T, in registers; each
      // K fragment feeds every strip
      float s[MS][NS][4];
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int n = 0; n < NS; ++n)
          s[ms][n][0] = s[ms][n][1] = s[ms][n][2] = s[ms][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kb[4];
          load_bt(kb, kt, L::LD, np * 16, kk * 16, lane);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            mma16816(s[ms][2 * np], qf[ms][kk], kb[0], kb[1]);
            mma16816(s[ms][2 * np + 1], qf[ms][kk], kb[2], kb[3]);
          }
        }

      uint32_t pf[MS][NS / 2][4];
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        // online softmax: scale, bias, the quad's row max with the floor
        // (or the fixed shift)
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float* x = s[ms][n];
          if constexpr (BAND) {   // -inf out of the row's band
            x[0] *= scale_log2, x[1] *= scale_log2;
            x[2] *= scale_log2, x[3] *= scale_log2;
            if (test) {
              const int j = j0 + n * 8 + 2 * t4;
              const int2 w0r = kwin[ms][0], w1r = kwin[ms][1];
              x[0] = keep_in(w0r, j, x[0], -INFINITY);
              x[1] = keep_in(w0r, j + 1, x[1], -INFINITY);
              x[2] = keep_in(w1r, j, x[2], -INFINITY);
              x[3] = keep_in(w1r, j + 1, x[3], -INFINITY);
            }
          } else {
            const float2 bb =
                *reinterpret_cast<const float2*>(bt + n * 8 + 2 * t4);
            x[0] = x[0] * scale_log2 + bb.x;
            x[1] = x[1] * scale_log2 + bb.y;
            x[2] = x[2] * scale_log2 + bb.x;
            x[3] = x[3] * scale_log2 + bb.y;
          }
          tmax[0] = fmaxf(tmax[0], fmaxf(x[0], x[1]));
          tmax[1] = fmaxf(tmax[1], fmaxf(x[2], x[3]));
        }
        float alpha[2] = {1.f, 1.f};
        if constexpr (!BOUND_SHIFT) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tmax[r] =
                fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
            tmax[r] =
                fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
            const float m_new = fmaxf(m[ms][r], tmax[r]);
            alpha[r] = exp2f(m[ms][r] - m_new);
            m[ms][r] = m_new;
          }
        }
        // P = exp2(s - m), rounded to bf16 A fragments; the sum from the
        // f32 values (this lane's share; the quad is summed once at the end)
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* x = s[ms][n];
          const float p0 = exp2f(x[0] - m[ms][0]);
          const float p1 = exp2f(x[1] - m[ms][0]);
          const float p2 = exp2f(x[2] - m[ms][1]);
          const float p3 = exp2f(x[3] - m[ms][1]);
          psum[0] += p0 + p1;
          psum[1] += p2 + p3;
          pf[ms][n / 2][(n & 1) * 2] = pack2(p0, p1);
          pf[ms][n / 2][(n & 1) * 2 + 1] = pack2(p2, p3);
        }
        if constexpr (MXU_SUM) {
          // the rows of the bf16 P tile times ones: every column of the
          // product is the row sum (the whole row's, not this lane's share)
          const uint32_t one = pack2(1.f, 1.f);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < NS / 2; ++kk)
            mma16816(acc, pf[ms][kk], one, one);
          l[ms][0] = l[ms][0] * alpha[0] + acc[0];
          l[ms][1] = l[ms][1] * alpha[1] + acc[2];
        } else {
          l[ms][0] = l[ms][0] * alpha[0] + psum[0];
          l[ms][1] = l[ms][1] * alpha[1] + psum[1];
        }
        if constexpr (!BOUND_SHIFT) {
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            o[ms][n][0] *= alpha[0];
            o[ms][n][1] *= alpha[0];
            o[ms][n][2] *= alpha[1];
            o[ms][n][3] *= alpha[1];
          }
        }
      }
      // O += P V, V through ldmatrix.trans; each V fragment feeds every
      // strip
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk)
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
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

  const int nrows = Tq - q0;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    if constexpr (!MXU_SUM) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[ms][r] += __shfl_xor_sync(0xffffffffu, l[ms][r], 1);
        l[ms][r] += __shfl_xor_sync(0xffffffffu, l[ms][r], 2);
      }
    }
    // flash: l >= 1, so no 1e-30
    const float eps = FLASH ? 0.f : 1e-30f;
    store_rows<NO>(o[ms], 1.f / (l[ms][0] + eps), 1.f / (l[ms][1] + eps),
                   w0 + 16 * ms, nrows, D, vec,
                   [&](int i) { return out + sq.at(b, q0 + i, h); }, lane);
    if (lse != nullptr && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + w0 + 16 * ms + g + 8 * r;
        if (i >= Tq) continue;
        const long long at = ((long long)b * gridDim.y + h) * Tq + i;
        if constexpr (FLASH) {
          lse[at] = m[ms][r];
          lsum[at] = l[ms][r];
        } else {
          lse[at] = m[ms][r] + log2f(l[ms][r] + 1e-30f);
        }
      }
    }
  }
}

// ---- launchers --------------------------------------------------------------

template <int DPAD, bool BS, Mode M>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse, void* lsum,
                        int B, int Tq, int Tk, int H, int D, bool head_major,
                        cudaStream_t stream, const Band& band = {}) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  attention_blc_simt_kernel<float, DPAD, BS, M><<<grid, BQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (float*)out, (float*)lse, (float*)lsum, Tq, Tk,
      D, strides_of(head_major, B, Tq, H, D),
      strides_of(head_major, B, Tk, H, D), scale_log2, band);
  return cudaGetLastError();
}

template <int DPAD, bool BS, bool MS, Mode M>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* mask, void* out, void* lse, void* lsum,
                      int B, int Tq, int Tk, int H, int D, bool head_major,
                      cudaStream_t stream, const Band& band = {}) {
  const Strides sq = strides_of(head_major, B, Tq, H, D);
  const Strides sk = strides_of(head_major, B, Tk, H, D);
  const bool vec = vec_ok(D, sq, sk, {q, k, v, out});
  using L = FwdLayout<DPAD>;
  auto kern = attention_blc_tc_kernel<DPAD, BS, MS, M>;
  cudaError_t e = set_smem(kern, L::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + L::BQ - 1) / L::BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, L::THREADS, L::BYTES, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (bf16*)out, (float*)lse, (float*)lsum, Tq, Tk, D, sq, sk, scale_log2,
      vec, band);
  return cudaGetLastError();
}

#ifndef VILCO_FRAME_BAND
// The forward of one head width: K1 (variant 0) or flash mode (variant 4,
// K1f); with VILCO_PROBE_VARIANTS, the probe's switches (variant bit 0:
// bound_shift, bit 1: mxu_sum; f32 has no use for mxu_sum) instead. f32
// pads D to 64 or 128, bf16 to 32, 64, 96 or 128 (flash mode to 64 or
// 128, which halves its instantiations).
template <int DPAD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, void* lsum,
                       int B, int Tq, int Tk, int H, int D, int dtype,
                       bool head_major, int variant, cudaStream_t s) {
#define VILCO_FWD(F) F(q, k, v, mask, out, lse, lsum, B, Tq, Tk, H, D, head_major, s)
  constexpr int FP = DPAD <= 64 ? 64 : 128;
  constexpr Mode K1 = Mode::K1;
#ifdef VILCO_PROBE_VARIANTS
  const bool bs = variant & 1, ms = variant & 2;
  if (dtype == 0)
    return bs ? VILCO_FWD((launch_simt<FP, true, K1>))
              : VILCO_FWD((launch_simt<FP, false, K1>));
  if (bs)
    return ms ? VILCO_FWD((launch_tc<DPAD, true, true, K1>))
              : VILCO_FWD((launch_tc<DPAD, true, false, K1>));
  return VILCO_FWD((launch_tc<DPAD, false, true, K1>));
#else
  constexpr Mode FL = Mode::Flash;
  if (variant == 4)
    return dtype == 0 ? VILCO_FWD((launch_simt<FP, false, FL>))
                      : VILCO_FWD((launch_tc<FP, false, false, FL>));
  return dtype == 0 ? VILCO_FWD((launch_simt<FP, false, K1>))
                    : VILCO_FWD((launch_tc<DPAD, false, false, K1>));
#endif
#undef VILCO_FWD
}
#else
// K6's forward at one head width: band mode on the channels-last layout,
// no mask, bf16 at DPAD, f32 at 32, 64 or 128.
template <int DPAD>
cudaError_t launch_band(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int L, int H, int D,
                        int dtype, const Band& band, cudaStream_t s) {
  constexpr Mode FB = Mode::FrameBand;
  constexpr int FP = DPAD == 96 ? 128 : DPAD;
  return dtype == 0
             ? launch_simt<FP, false, FB>(q, k, v, nullptr, out, lse,
                                          nullptr, B, L, L, H, D, false, s,
                                          band)
             : launch_tc<DPAD, false, false, FB>(q, k, v, nullptr, out, lse,
                                                 nullptr, B, L, L, H, D,
                                                 false, s, band);
}
#endif

}  // namespace

#ifndef VILCO_FRAME_BAND
// dtype: 0 = float32, 1 = bfloat16. layout 0: q/out (B, Tq, H*D), k/v
// (B, Tk, H*D); layout 1 (head-major): q/out (H, B, Tq, D), k/v
// (H, B, Tk, D). mask (B, Tk) one byte per key (nonzero = valid), all
// contiguous; D <= 128. variant: 0 for K1, 4 flash mode (K1f); in the
// probe's library (VILCO_PROBE_VARIANTS) 1-3: bit 0 bound_shift, bit 1
// mxu_sum. Another variant is refused. lse (B, H, Tq) f32, or null
// when no backward follows: K1 stores the row's log-sum-exp there (log2
// domain); flash mode stores the row max m there (log2 domain) and the
// row sum l in lsum (B, H, Tq) f32 (null with lse null, ignored by K1).
extern "C" int attention_blc_fwd(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* lse,
                                 void* lsum, int B, int Tq, int Tk, int H,
                                 int D, int dtype, int layout, int variant,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#ifdef VILCO_PROBE_VARIANTS
  const bool variant_ok = variant >= 1 && variant <= 3;
#else
  const bool variant_ok = variant == 0 || variant == 4;
#endif
  if (D < 1 || D > 128 || B < 1 || Tq < 1 || Tk < 1 || H < 1 ||
      (dtype != 0 && dtype != 1) || layout < 0 || layout > 1 ||
      !variant_ok ||
      (variant == 4 && (lse == nullptr) != (lsum == nullptr)))
    return (int)cudaErrorInvalidValue;
#define VILCO_FWD(DP) launch_fwd<DP>(q, k, v, mask, out, lse, lsum, B, Tq, Tk, H, D, dtype, layout == 1, variant, s)
  return (int)(D <= 32 ? VILCO_FWD(32) : D <= 64 ? VILCO_FWD(64)
               : D <= 96 ? VILCO_FWD(96) : VILCO_FWD(128));
#undef VILCO_FWD
}
#else
// K6's forward, the band mode of the kernels above. dtype: 0 = float32, 1 =
// bfloat16. q/k/v/out (B, L, H*D), all contiguous, L = n_frames * fr; D <=
// 128, w >= 0. lse (B, H, L) f32 (log2 domain), or null when no backward
// follows.
extern "C" int frame_band_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int L, int H, int D,
                              int fr, int w, int dtype, void* stream) {
  if (D < 1 || D > 128 || B < 1 || L < 1 || H < 1 || fr < 1 || w < 0 ||
      w >= FAR / 2 || L % fr != 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Band band{L, fr, w, L / fr};
  cudaStream_t s = (cudaStream_t)stream;
#define VILCO_FWD(DP) launch_band<DP>(q, k, v, out, lse, B, L, H, D, dtype, band, s)
  return (int)(D <= 32 ? VILCO_FWD(32) : D <= 64 ? VILCO_FWD(64)
               : D <= 96 ? VILCO_FWD(96) : VILCO_FWD(128));
#undef VILCO_FWD
}
#endif
