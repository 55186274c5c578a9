// AdamW update of many parameter leaves in one launch (multi-tensor).
//
// Replaces vilco_tpu/kernels/adamw.py::adamw_update_leaf (the Pallas
// _adamw_kernel, one pallas_call per leaf), with the arithmetic of
// FusedAdamW's update (vilco_tpu/train/optim.py::FusedAdamW._fused)
// operation for operation:
//   g   = g * gscale                       (the global-norm clip factor; a
//                                           bf16 gradient is multiplied by
//                                           gscale rounded to bf16 and the
//                                           product rounded to bf16, as
//                                           JAX's `g * scale.astype(g.dtype)`)
//   m2  = (1 - b1) g + round_m(b1_m * m)   (b1 * m rounds in m's storage
//                                           dtype before the f32 add, b1
//                                           itself rounded to it)
//   v2  = (1 - b2) g^2 + b2 f32(v)         (always in f32)
//   u   = (m2 / bc1) / (sqrt(v2 / bc2) + eps)  [+ wd p where the leaf decays]
//   p  -= lr u;  m = round_m(m2);  v = round_v(v2);  [pc = bf16(p)]
// Every product, sum, quotient and root is an explicitly rounded intrinsic,
// so nvcc contracts nothing into an FMA. lr, bc1, bc2 and gscale are read
// from device memory, so the step needs no host value and a CUDA graph could
// capture it. Parameters, m and v are updated in place.
//
// m and v each have their own storage dtype (f32 or bf16, one template
// instance per pair); a leaf's gradient is f32 or bf16 (a flag of the leaf),
// and a leaf may name a bf16 compute copy of its parameter (the
// param_compute_dtype=bfloat16 layout), written from the new value while it
// is still in a register.
//
// Design: a device table of leaves (p, g, m, v, pc pointers, length, flags)
// and a block map (leaf, first element) built by the wrapper; each block of
// 256 threads updates one chunk of 4096 elements of one leaf, neighbouring
// threads on neighbouring elements. Bound by memory traffic: with f32
// gradients and bf16 moments 4 + 4 + 2 + 2 bytes read and 4 + 2 + 2 written
// per element.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 4096;
constexpr long long DECAY = 1;      // Leaf.flags bits
constexpr long long GRAD_BF16 = 2;

struct Leaf {
  float* p;
  const void* g;
  void* m;
  void* v;
  __nv_bfloat16* pc;   // null: no compute copy
  long long n;
  long long flags;
};

struct Hyper {
  float wd, b1, b2, eps, omb1, omb2;   // omb = 1 - b, rounded from double
};

template <typename MT, typename VT>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const Leaf* __restrict__ leaves,
             const long long* __restrict__ blocks,
             const float* __restrict__ coef, Hyper hp) {
  const Leaf leaf = leaves[blocks[2 * blockIdx.x]];
  const long long off = blocks[2 * blockIdx.x + 1];
  const long long end = min(off + CHUNK, leaf.n);
  const float lr = coef[0], bc1 = coef[1], bc2 = coef[2], gscale = coef[3];
  // JAX's `g * scale.astype(bf16)` on a bf16 gradient
  const float gscale_bf = __bfloat162float(__float2bfloat16(gscale));
  // the JAX expression `B1 * m` takes the Python float in m's dtype
  const float b1m = vilco::to_f32<MT>(vilco::from_f32<MT>(hp.b1));
  const bool decay = leaf.flags & DECAY;
  const bool g_bf16 = leaf.flags & GRAD_BF16;
  const float* gf = reinterpret_cast<const float*>(leaf.g);
  const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(leaf.g);
  MT* m = reinterpret_cast<MT*>(leaf.m);
  VT* v = reinterpret_cast<VT*>(leaf.v);
  for (long long i = off + threadIdx.x; i < end; i += THREADS) {
    // the product of two bf16 values is exact in f32: one rounding, to bf16
    const float g = g_bf16
        ? __bfloat162float(__float2bfloat16(
              __fmul_rn(__bfloat162float(gb[i]), gscale_bf)))
        : __fmul_rn(gf[i], gscale);
    const float mt = vilco::to_f32<MT>(vilco::from_f32<MT>(
        __fmul_rn(b1m, vilco::to_f32<MT>(m[i]))));
    const float m2 = __fadd_rn(__fmul_rn(hp.omb1, g), mt);
    const float v2 = __fadd_rn(__fmul_rn(hp.omb2, __fmul_rn(g, g)),
                               __fmul_rn(hp.b2, vilco::to_f32<VT>(v[i])));
    float u = __fdiv_rn(__fdiv_rn(m2, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), hp.eps));
    const float p = leaf.p[i];
    if (decay) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
    const float pn = __fsub_rn(p, __fmul_rn(lr, u));
    leaf.p[i] = pn;
    if (leaf.pc) leaf.pc[i] = __float2bfloat16(pn);
    m[i] = vilco::from_f32<MT>(m2);
    v[i] = vilco::from_f32<VT>(v2);
  }
}

template <typename MT, typename VT>
cudaError_t launch(const void* leaves, const void* blocks, const void* coef,
                   int n_blocks, Hyper hp, cudaStream_t stream) {
  adamw_kernel<MT, VT><<<n_blocks, THREADS, 0, stream>>>(
      (const Leaf*)leaves, (const long long*)blocks, (const float*)coef, hp);
  return cudaGetLastError();
}

template <typename MT>
cudaError_t launch_v(const void* leaves, const void* blocks, const void* coef,
                     int n_blocks, int v_code, Hyper hp, cudaStream_t s) {
  if (v_code == 0) return launch<MT, float>(leaves, blocks, coef, n_blocks, hp, s);
  if (v_code == 1) return launch<MT, __nv_bfloat16>(leaves, blocks, coef, n_blocks, hp, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// leaves: device array of Leaf {p, g, m, v, pc, n, flags} (7 x 8 bytes
// each; flags bit 0 decay, bit 1 bf16 gradient; pc null or a bf16 copy);
// blocks: device array of (leaf index, first element) int64 pairs, one per
// block, each chunk 4096 elements; coef: device f32 {lr, bc1, bc2, gscale}.
// m_code, v_code: 0 = float32, 1 = bfloat16 storage of every leaf's m and v;
// p is float32.
extern "C" int adamw_multi(const void* leaves, const void* blocks,
                           const void* coef, int n_blocks, int m_code,
                           int v_code, float wd, float b1, float b2,
                           float eps, float omb1, float omb2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_blocks < 1) return (int)cudaSuccess;
  const Hyper hp{wd, b1, b2, eps, omb1, omb2};
  if (m_code == 0) return (int)launch_v<float>(leaves, blocks, coef, n_blocks, v_code, hp, s);
  if (m_code == 1) return (int)launch_v<__nv_bfloat16>(leaves, blocks, coef, n_blocks, v_code, hp, s);
  return (int)cudaErrorInvalidValue;
}
