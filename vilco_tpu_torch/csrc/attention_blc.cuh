// Shared by csrc/attention_blc.cu (K1's forward) and
// csrc/attention_blc_bwd.cu (its backward): the modes both compile (K1,
// flash, K6's frame band), the row strides of the two layouts, the -1e9
// key bias and -1e8 row-max floor, flash mode's masked-key value, the
// band, the backward's delta pass, and the mma.sync, ldmatrix and cp.async
// helpers of the bf16 kernels. Two files, so that nvcc builds the forward
// and the backward side by side. csrc/xl_rel_attention.cu (K2) takes the
// delta pass and the mma.sync helpers from here too.
#pragma once

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

// What an instance of the forward or the backward computes: K1 (and K1n),
// K1f's flash mode or K6's band mode.
enum class Mode { K1, Flash, FrameBand };

constexpr float NEG_INF_BIAS = -1e9f;
constexpr float ROWMAX_FLOOR = -1e8f;
// K1f (flash mode): the flash-attention library's DEFAULT_MASK_VALUE,
// -0.7 * FLT_MAX rounded once to f32, added to a masked key's score. It is
// added as it is in the log2 domain too: times log2 e it would overflow to
// -inf (and a fully masked row to NaN). Every finite score is absorbed by
// it, so a fully masked row has all its scores equal and averages v.
constexpr float FLASH_MASK = (float)(-0.7 * 3.4028234663852886e38);

// The bias of key j (mp: its batch row's mask): 0 if valid, the mode's
// masked-key value if masked, -inf at or past Tk (skipped in both modes).
template <bool FLASH>
__device__ __forceinline__ float key_bias(const uint8_t* mp, int j, int Tk) {
  return j < Tk ? (mp[j] ? 0.f : (FLASH ? FLASH_MASK : NEG_INF_BIAS))
                : -INFINITY;
}

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

// K6's frame band (the band mode of the forward and of the backward):
// L tokens in frames of fr; a token sees every token of the frames within
// +-w of its own, inside [0, n_frames). The band is symmetric, so the keys
// a query row sees and the queries a key row is seen by are the same range.
constexpr int FAR = 1 << 20;     // frame of a padding row: outside any band

struct Band {
  int L, fr, w, n_frames;
  // the token range [lo, hi) that rows r0 .. r1 reach together
  __device__ __forceinline__ void window(int r0, int r1, int& lo,
                                         int& hi) const {
    lo = max(0, r0 / fr - w) * fr;
    hi = min(n_frames - 1, r1 / fr + w) * fr + fr;
  }
  // the tokens [x, y) that row r sees (none at or past L)
  __device__ __forceinline__ int2 range(int r) const {
    int lo = 0, hi = 0;
    if (r < L) window(r, r, lo, hi);
    return make_int2(lo, hi);
  }
  // every row of r0 .. r1 sees every token of [c0, c1)
  __device__ __forceinline__ bool covers(int r0, int r1, int c0,
                                         int c1) const {
    return max(0, r1 / fr - w) * fr <= c0 &&
           min(n_frames - 1, r0 / fr + w) * fr + fr >= c1;
  }
};

// x where token i lies in the range `win`, else `out`
__device__ __forceinline__ float keep_in(int2 win, int i, float x,
                                         float out = 0.f) {
  return i >= win.x && i < win.y ? x : out;
}

// The backward's first pass (K1's (a), K2-bwd's 1): delta = rowsum(dO * O)
// per (batch, head, query row) at ((b * H) + h) * Tq + i, in f32; one warp
// a row.
template <typename T>
__global__ void __launch_bounds__(256)
attention_blc_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int Tq,
                           int H, int D, Strides sq) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = (int)(row % Tq), h = (int)((row / Tq) % H);
  const int b = (int)(row / ((long long)Tq * H));
  const long long off = sq.at(b, i, h);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(vilco::to_f32<T>(out[off + d]), vilco::to_f32<T>(dout[off + d]),
               acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[row] = acc;
}

// ---- bfloat16: mma.sync fragments held in registers ----------------------
//
// mma.sync.m16n8k16 fragments, lane = 4 * g + t4 (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 (row g, cols 2 t4 .. +1),
//     a1 (row g + 8, same cols), a2 (row g, cols 8 + 2 t4 .. +1), a3 (row
//     g + 8, cols 8 + 2 t4 .. +1);
//   B (16 x 8, col-major), 2 regs: b0 (rows 2 t4 .. +1, col g), b1 (rows
//     8 + 2 t4 .. +1, col g);
//   C (16 x 8, f32), 4 floats: c0, c1 (row g, cols 2 t4 .. +1), c2, c3 (row
//     g + 8, same cols).
// So the C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of one k16 step: P and dS never leave registers.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Register i holds matrix i's row (lane / 4), cols 2 (lane %
// 4) .. +1; with .trans, its col (lane / 4), rows 2 (lane % 4) .. +1.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared, zero-filled where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `ROWS` rows of a head's D columns (row r at src + r * st) into
// shared rows of LD elements, zero past `valid` rows and past column D:
// 16-byte cp.async where `vec` (D a multiple of 8, rows 16-byte aligned),
// else one element a thread by plain stores. Either is visible after the
// caller's cp_async_wait and barrier.
template <int ROWS, int DPAD, int LD, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long st, int valid, int D,
                                           bool vec) {
  if (vec) {
    constexpr int CH = DPAD / 8;
    for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = r < valid && c < D;
      cp_async16(dst + r * LD + c, ok ? src + r * st + c : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < ROWS * DPAD; e += THREADS) {
      const int r = e / DPAD, c = e % DPAD;
      dst[r * LD + c] = (r < valid && c < D) ? src[r * st + c] : zero;
    }
  }
}

// A fragment of rows r0 .. r0 + 15, cols c0 .. c0 + 15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int LD, int r0, int c0, int lane) {
  ldsm4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles for a product with the transpose of a
// row-major tile: rows n0 .. n0 + 15 of the tile are the n index, cols
// c0 .. c0 + 15 the k index. b[0], b[1]: n0 .. +7; b[2], b[3]: n0 + 8 .. +15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* t,
                                        int LD, int n0, int c0, int lane) {
  ldsm4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
               ((lane >> 3) & 1) * 8);
}

// A fragment of the transpose of a row-major tile: A rows r0 .. r0 + 15 are
// the tile's cols, A cols c0 .. c0 + 15 its rows (ldmatrix.trans).
__device__ __forceinline__ void load_at(uint32_t (&a)[4], const bf16* t,
                                        int LD, int r0, int c0, int lane) {
  ldsm4t(a, t + (c0 + (lane & 7) + ((lane >> 4) << 3)) * LD + r0 +
                ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles for a product with a row-major tile itself:
// rows k0 .. k0 + 15 are the k index, cols n0 .. n0 + 15 the n index.
// b[0], b[1]: cols n0 .. +7; b[2], b[3]: cols n0 + 8 .. +15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t,
                                       int LD, int k0, int n0, int lane) {
  ldsm4t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                (lane >> 4) * 8);
}

// Store a warp's 16 rows of NO n8 accumulator tiles, times `mul`, as bf16
// rows of `dst` (row i at dst + row_off(i)); rows >= nrows are skipped.
template <int NO, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4],
                                           float mul0, float mul1, int r0,
                                           int nrows, int D, bool vec,
                                           RowPtr row, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= nrows) continue;
    const float mul = r ? mul1 : mul0;
    bf16* p = row(i);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t4;
      const float x = acc[n][2 * r] * mul, y = acc[n][2 * r + 1] * mul;
      if (vec) {
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(p + c) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (c < D) p[c] = __float2bfloat16(x);
        if (c + 1 < D) p[c + 1] = __float2bfloat16(y);
      }
    }
  }
}

// 16-byte loads of every row: D a multiple of 8, the row stride too, the
// tensors 16-byte aligned
bool vec_ok(int D, const Strides& sq, const Strides& sk,
            std::initializer_list<const void*> ptrs) {
  if (D % 8 != 0 || sq.st % 8 != 0 || sk.st % 8 != 0) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
