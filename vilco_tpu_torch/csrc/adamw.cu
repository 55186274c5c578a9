// AdamW update of many parameter leaves in one launch (multi-tensor).
//
// Replaces vilco_tpu/kernels/adamw.py::adamw_update_leaf (the Pallas
// _adamw_kernel, one pallas_call per leaf), with the arithmetic of
// FusedAdamW's update (vilco_tpu/train/optim.py) operation for operation:
//   g   = g * gscale                       (the global-norm clip factor)
//   m2  = (1 - b1) g + round_m(b1_m * m)   (b1 * m rounds in the moments'
//                                           storage dtype before the f32
//                                           add, b1 itself rounded to it)
//   v2  = (1 - b2) g^2 + b2 f32(v)
//   u   = (m2 / bc1) / (sqrt(v2 / bc2) + eps)  [+ wd p where the leaf decays]
//   p  -= lr u;  m = round_m(m2);  v = round_v(v2)
// Every product, sum, quotient and root is an explicitly rounded intrinsic,
// so nvcc contracts nothing into an FMA. lr, bc1, bc2 and gscale are read
// from device memory, so the step needs no host value and a CUDA graph could
// capture it. Parameters, m and v are updated in place.
//
// Design: a device table of leaves (p, g, m, v pointers, length, decay
// flag) and a block map (leaf, first element) built by the wrapper; each
// block of 256 threads updates one chunk of 4096 elements of one leaf,
// neighbouring threads on neighbouring elements. Bound by memory traffic:
// 4 + 4 + 2 + 2 bytes read and 4 + 2 + 2 written per element with bf16
// moments.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 4096;

struct Leaf {
  float* p;
  const float* g;
  void* m;
  void* v;
  long long n;
  long long decay;
};

struct Hyper {
  float wd, b1, b2, eps, omb1, omb2;   // omb = 1 - b, rounded from double
};

template <typename MT>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const Leaf* __restrict__ leaves,
             const long long* __restrict__ blocks,
             const float* __restrict__ coef, Hyper hp) {
  const Leaf leaf = leaves[blocks[2 * blockIdx.x]];
  const long long off = blocks[2 * blockIdx.x + 1];
  const long long end = min(off + CHUNK, leaf.n);
  const float lr = coef[0], bc1 = coef[1], bc2 = coef[2], gscale = coef[3];
  // the JAX expression `B1 * m` takes the Python float in m's dtype
  const float b1m = vilco::to_f32<MT>(vilco::from_f32<MT>(hp.b1));
  MT* m = reinterpret_cast<MT*>(leaf.m);
  MT* v = reinterpret_cast<MT*>(leaf.v);
  for (long long i = off + threadIdx.x; i < end; i += THREADS) {
    const float g = __fmul_rn(leaf.g[i], gscale);
    const float mt = vilco::to_f32<MT>(vilco::from_f32<MT>(
        __fmul_rn(b1m, vilco::to_f32<MT>(m[i]))));
    const float m2 = __fadd_rn(__fmul_rn(hp.omb1, g), mt);
    const float v2 = __fadd_rn(__fmul_rn(hp.omb2, __fmul_rn(g, g)),
                               __fmul_rn(hp.b2, vilco::to_f32<MT>(v[i])));
    float u = __fdiv_rn(__fdiv_rn(m2, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), hp.eps));
    const float p = leaf.p[i];
    if (leaf.decay) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
    leaf.p[i] = __fsub_rn(p, __fmul_rn(lr, u));
    m[i] = vilco::from_f32<MT>(m2);
    v[i] = vilco::from_f32<MT>(v2);
  }
}

template <typename MT>
cudaError_t launch(const void* leaves, const void* blocks, const void* coef,
                   int n_blocks, Hyper hp, cudaStream_t stream) {
  adamw_kernel<MT><<<n_blocks, THREADS, 0, stream>>>(
      (const Leaf*)leaves, (const long long*)blocks, (const float*)coef, hp);
  return cudaGetLastError();
}

}  // namespace

// leaves: device array of Leaf {p, g, m, v, n, decay} (6 x 8 bytes each);
// blocks: device array of (leaf index, first element) int64 pairs, one per
// block, each chunk 4096 elements; coef: device f32 {lr, bc1, bc2, gscale}.
// moment_code: 0 = float32, 1 = bfloat16 storage of both m and v; p and g
// are float32.
extern "C" int adamw_multi(const void* leaves, const void* blocks,
                           const void* coef, int n_blocks, int moment_code,
                           float wd, float b1, float b2, float eps,
                           float omb1, float omb2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_blocks < 1) return (int)cudaSuccess;
  const Hyper hp{wd, b1, b2, eps, omb1, omb2};
  if (moment_code == 0) return (int)launch<float>(leaves, blocks, coef, n_blocks, hp, s);
  if (moment_code == 1) return (int)launch<__nv_bfloat16>(leaves, blocks, coef, n_blocks, hp, s);
  return (int)cudaErrorInvalidValue;
}
