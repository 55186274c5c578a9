// Fused transformer MLP, forward: out = gelu_tanh(x W1 + b1) W2 + b2.
//
// Replaces vilco_tpu/kernels/mlp.py::fused_mlp (the Pallas _mlp_kernel run
// by _run). x (N, C), W1 (C, Hd), b1 (Hd,), W2 (Hd, C), b2 (C,), all in x's
// dtype (the wrapper rounds the f32 master weights and biases to it, as the
// Pallas call does); products accumulate in f32, the GELU runs in f32 and
// its result is rounded to x's dtype before the second product, as in the
// TPU kernel. Row offsets are 64-bit: N * Hd is 7.6e8 at a VQ serving
// request's clip call (240 frames of 1025 tokens).
//
// What bounds it on the card: operations. At the ViT-B shape (C = 768,
// Hd = 3072) each token costs 4 C Hd = 9.4 MFLOP against 4 C bytes in and
// out, far above the ~295 operations a byte where Hopper's bf16 tensor
// cores become the limit: 2.35 ms at the clip call (246,000 tokens).
//
// bfloat16: two launches of one Hopper GEMM, not one fused kernel.
//   1. H = bf16(gelu_tanh(X W1 + b1))   M = N, N = Hd, K = C
//   2. out = bf16(H W2 + b2)            M = N, N = C,  K = Hd
// H is rounded to bf16 exactly where the TPU kernel rounds it (its
// `.astype(x.dtype)`), so the function is unchanged. Why H goes to device
// memory: the TPU kernel keeps the (rows, Hd) intermediate in 16 MB of
// VMEM; here one block's f32 output accumulator alone is rows x C x 4
// bytes (384 KB for 128 rows, 196 KB for 64) against 256 KB of registers
// and 227 KB of shared memory an SM. A single fused kernel must either
// recompute the first product for each split of the output columns, or
// re-read all 9.4 MB of weights from L2 for every row tile (36 GB at 64
// rows a tile, 72 GB at the 32 of the kernel this one replaces). The
// intermediate instead costs 1.51 GB written and read once at the clip
// call (~0.9 ms at 3.35 TB/s), which the tensor-core work of two
// compute-bound GEMMs hides.
//
// The GEMM (mlp_wgmma_kernel), D = A B + bias, A (M, K) and B (K, N)
// row-major bf16, after the `hopper-kernels` design:
//  - block tiles of 128 x 256, K steps of 64 bf16 (128-byte rows with the
//    128-byte swizzle); two consumer warpgroups each own a 64-row
//    wgmma.m64n256k16 accumulator (128 f32 registers a thread); one
//    producer thread issues the TMA loads;
//  - a ring of 3 stages of A and B tiles in shared memory (48 KB a stage,
//    144 KB), mbarriers marking each stage full (TMA transaction bytes)
//    and empty (one arrival per consumer warpgroup once its wgmma on the
//    stage has retired); setmaxnreg moves registers from the producer to
//    the consumers;
//  - the weights are row-major (K, N), so B is MN-major: wgmma reads it
//    through its transpose flag, with no transpose on the card (TMA boxes
//    of 64 columns x 64 rows, four to a stage);
//  - a persistent grid of one block an SM walks the output tiles, the
//    column tiles of one row panel back to back, so the A panel and the
//    weights stay in L2; the producer runs ahead into the next tile while
//    the consumers run the epilogue;
//  - ragged edges: TMA zero-fills loads past row M (and past K or N) and
//    clips stores past them, so N = 246,000 and 8,200 need no padding;
//  - the epilogue adds the bias in f32 (and applies the tanh GELU, its tanh
//    by tanh.approx.f32), writes the bf16 tile into shared memory in the
//    swizzled layout (no bank conflicts) and one thread stores it with TMA
//    (64 KB of the 227, hence 3 stages, not 4): the global writes run
//    behind the next tile's products. Stores of 4-byte pairs straight from
//    the fragments (8 half-used sectors a warp instruction) kept the
//    load/store unit busy for about as long as a tile's products at
//    K = 768;
//  - tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint(ByVersion), so the library needs no
//    -lcuda.
// What bounds it: the tensor cores' rate while the ring keeps them fed,
// and the epilogue's arithmetic (the GELU's MUFU tanh, the shared-memory
// writes), which does not overlap the products: both consumer warpgroups
// finish it before the next tile's first wgmma. The first GEMM (K = 768,
// the GELU, 4x the tiles of the second) pays most of it.
// float32 (the parity path): TS = 16 rows a block, SIMT FMAs, H in shared
// memory.

#include <cuda.h>

#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HC = 128;           // hidden units per chunk, float32
constexpr int THREADS = 256;      // float32 kernel
constexpr int TS32 = 16;          // token rows per block, float32
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// ---- bfloat16: the wgmma / TMA GEMM ---------------------------------------

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int B_BOX = BK * 64 * 2;                // one 64-column box, 8 KB
constexpr int STAGE_BYTES = A_BYTES + 4 * B_BOX;  // 48 KB
constexpr int OUT_BYTES = 64 * BN * 2;            // a consumer's 64 x 256
// the ring, 1024-byte aligned (the swizzle's span), the two consumers'
// output tiles, then 2 x STAGES mbarriers; 1 KB of slack for the alignment
constexpr int GEMM_SMEM =
    1024 + STAGES * STAGE_BYTES + 2 * OUT_BYTES + 2 * STAGES * 8;
constexpr int GEMM_THREADS = 384;                 // producer + 2 consumers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait of more than 10 s (a lost arrival) traps, so a fault in the ring
// ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// a box of the tensor map at coordinates (c0 innermost, c1) into shared
// memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a 64 x 64 box of shared memory (128-byte swizzle) to the tensor map at
// (c0 innermost, c1); TMA clips what lies past the tensor's edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0),
      "r"(c1)
      : "memory");
}

// the shared-memory writes of this thread visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of one warpgroup (barrier `id`, 1 or 2)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 of the warpgroup, f32) = A B (+ d if accumulate): A K-major
// (row-major M x K), B MN-major (row-major K x N: the transpose flag)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the tanh GELU with tanh.approx.f32 (one MUFU operation; its ~2^-11
// relative error is below the bf16 rounding that follows)
__device__ __forceinline__ float gelu_fast(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;"
      : "=f"(t) : "f"(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + t);
}

// D (M, N) = bf16(act(A B + bias)), act the tanh GELU where GELU; ta, tb
// and td the tensor maps of A, B and D
template <bool GELU>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap td,
                 const bf16* __restrict__ bias, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t outs = base + STAGES * STAGE_BYTES;
  const uint32_t bars = outs + 2 * OUT_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const int ntn = (N + BN - 1) / BN;
  const int ntiles = ((M + BM - 1) / BM) * ntn, nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = (t / ntn) * BM, n0 = (t % ntn) * BN;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);   // the first round passes
          mbar_expect_tx(full(stage), STAGE_BYTES);
          const uint32_t sa = base + stage * STAGE_BYTES;
          tma_load(sa, &ta, full(stage), ks * BK, m0);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            tma_load(sa + A_BYTES + c * B_BOX, &tb, full(stage), n0 + 64 * c,
                     ks * BK);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int m0 = (t / ntn) * BM, n0 = (t % ntn) * BN;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = base + stage * STAGE_BYTES + cw * (64 * 128);
        const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
        fence_acc(d);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // A: 16 k columns = 32 bytes along the swizzled 128-byte rows,
          // 8-row groups 1024 bytes apart; B: 16 k rows = two 8-row groups
          // of 1024 bytes, 64-column boxes B_BOX apart
          wgmma_256(d, smem_desc(sa + 32 * kk, 16, 1024),
                    smem_desc(sb + 2048 * kk, B_BOX, 1024),
                    (ks | kk) != 0);
        wgmma_commit();
        if (ks > 0) {   // the previous stage's products have retired
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (tid == 0) mbar_arrive(empty(prev));

      // epilogue: the fragment of row 16 warp + lane / 4 (+ 8), columns
      // 8 j + 2 (lane % 4) .. +1 is d[4 j .. 4 j + 3]; it goes, bias added
      // (and the GELU applied) and rounded, into this warpgroup's output
      // tile in shared memory: four 64 x 64 boxes in TMA's 128-byte
      // swizzle (16-byte chunk (j % 8) ^ (row % 8) of its 128-byte row, so
      // the warp's 32 stores hit 32 banks); then one thread stores the
      // boxes with TMA, which clips rows past M and columns past N
      const uint32_t ot = outs + cw * OUT_BYTES;
      if (tid == 0)   // the previous tile's store has read the buffer
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(1 + cw);
      const int g = lane >> 2, t4 = lane & 3;
      const int c0 = n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        float2 bb = make_float2(0.f, 0.f);
        if (c < N)      // N is even: c + 1 < N too
          bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + c));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x0 = d[4 * j + 2 * r] + bb.x, x1 = d[4 * j + 2 * r + 1] + bb.y;
          if constexpr (GELU) x0 = gelu_fast(x0), x1 = gelu_fast(x1);
          const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
          const int row = warp * 16 + g + 8 * r;
          const uint32_t at = ot + (j / 8) * (64 * 128) + row * 128 +
                              (((j % 8) ^ g) << 4) + 4 * t4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(*reinterpret_cast<const uint32_t*>(&v)));
        }
      }
      fence_async_smem();
      warpgroup_sync(1 + cw);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          if (n0 + 64 * b < N)
            tma_store(&td, ot + b * (64 * 128), n0 + 64 * b, m0 + cw * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0)   // the last stores have read shared memory
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, or null
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix as boxes of (box_rows, 64) columns,
// 128-byte swizzle, zero fill past its edges
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = act(a (M, K) b (K, N) + bias), one persistent block an SM
template <bool GELU>
cudaError_t launch_gemm(const void* a, const void* b, const void* bias,
                        void* out, int M, int N, int K, cudaStream_t s) {
  CUtensorMap ta, tb, td;
  if (!tensor_map(&ta, a, M, K, BM) || !tensor_map(&tb, b, K, N, BK) ||
      !tensor_map(&td, out, M, N, 64))
    return cudaErrorInvalidValue;
  auto kern = mlp_wgmma_kernel<GELU>;
  // the shared-memory limit and the SM count, once per device (the query
  // call's GEMMs take ~70 us each, so host calls show)
  static int sms[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             GEMM_SMEM)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
  }
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<(unsigned)std::min<long long>(tiles, sms[dev]), GEMM_THREADS,
         GEMM_SMEM, s>>>(ta, tb, td, (const bf16*)bias, M, N, K);
  return cudaGetLastError();
}

// ---- float32: SIMT ---------------------------------------------------------

size_t simt_smem_bytes(int C) {
  return sizeof(float) * ((size_t)2 * TS32 * C + (size_t)TS32 * HC);
}

__global__ void __launch_bounds__(THREADS)
mlp_simt_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int N,
                int C, int Hd) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                 // [TS32][C]
  float* hs = xs + TS32 * C;       // [TS32][HC]
  float* os = hs + TS32 * HC;      // [TS32][C]
  constexpr int RG = TS32 / (THREADS / HC);   // rows per thread, phase 1

  const long long r0 = (long long)blockIdx.x * TS32;
  const int nr = (int)min((long long)TS32, (long long)N - r0);
  const int tid = threadIdx.x;
  for (int e = tid; e < TS32 * C; e += THREADS) {
    const int r = e / C, c = e % C;
    xs[e] = r < nr ? x[(r0 + r) * C + c] : 0.f;
    os[e] = 0.f;
  }
  __syncthreads();

  for (int h0 = 0; h0 < Hd; h0 += HC) {
    const int hc = min(HC, Hd - h0);
    // Hc = gelu(X W1[:, chunk] + b1): column tid % HC, rows RG * (tid / HC)
    const int col = tid % HC, rg = (tid / HC) * RG;
    if (col < hc) {
      float acc[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = 0.f;
      for (int k = 0; k < C; ++k) {
        const float wv = w1[(long long)k * Hd + h0 + col];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          acc[r] = fmaf(xs[(rg + r) * C + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
        hs[(rg + r) * HC + col] = gelu_tanh(acc[r] + b1[h0 + col]);
    }
    __syncthreads();
    // O += Hc W2[chunk, :]: column c, all TS32 rows
    for (int c = tid; c < C; c += THREADS) {
      float acc[TS32];
#pragma unroll
      for (int r = 0; r < TS32; ++r) acc[r] = 0.f;
      for (int k = 0; k < hc; ++k) {
        const float wv = w2[(long long)(h0 + k) * C + c];
#pragma unroll
        for (int r = 0; r < TS32; ++r)
          acc[r] = fmaf(hs[r * HC + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < TS32; ++r) os[r * C + c] += acc[r];
    }
    __syncthreads();
  }

  for (int e = tid; e < nr * C; e += THREADS) {
    const int r = e / C, c = e % C;
    out[(r0 + r) * C + c] = os[e] + b2[c];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; every tensor in that dtype and
// contiguous: x, out (N, C), w1 (C, Hd), b1 (Hd,), w2 (Hd, C), b2 (C,).
// bfloat16: h (N, Hd) is the wrapper's scratch for the GELU output, C and
// Hd multiples of 16, x, w1, w2 and h 16-byte aligned; two GEMM launches.
// float32 (h unused): C <= 1750.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h,
                             void* out, int N, int C, int Hd, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || C < 1 || Hd < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (C % 16 || Hd % 16 || h == nullptr ||
        (((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)h) % 16))
      return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_gemm<true>(x, w1, b1, h, N, Hd, C, s);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_gemm<false>(h, w2, b2, out, N, C, Hd, s);
  }
  if (dtype == 0) {
    const size_t bytes = simt_smem_bytes(C);
    if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        mlp_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((N + TS32 - 1) / TS32);
    mlp_simt_kernel<<<blocks, THREADS, bytes, s>>>(
        (const float*)x, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, N, C, Hd);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
