"""AdamW update over many parameter leaves, one launch.

Replaces vilco_tpu/kernels/adamw.py::adamw_update_leaf (a Pallas kernel per
leaf) with csrc/adamw.cu: one multi-tensor launch over a device table of
leaves (pointers, length, decay flag) and a block-to-chunk map. The update
is FusedAdamW's (vilco_tpu/train/optim.py::FusedAdamW._fused), operation
for operation, including `b1 * m` rounded in m's storage dtype before the
f32 add and the moments stored in their own dtypes (m and v each f32 or
bf16); a bf16 gradient (the param_compute_dtype=bfloat16 layout) takes the
clip factor as JAX's `g * scale.astype(bf16)`, rounded to bf16, and a leaf
may name a bf16 compute copy that receives the new parameter. lr, bc1, bc2
and the clip factor come from device memory. Bound by memory traffic (20
bytes per element with f32 gradients and bf16 moments).

`adamw_update_plain` is the plain version (CPU tensors, the tests, the
comparison on the card); `adamw_update_multi` launches the kernel over a
`LeafTable`, which takes CUDA tensors only.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build

B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 0.05
CHUNK = 4096        # elements per block (csrc/adamw.cu)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and CUDA's): torch's
    vectorised f32 sqrt on the CPU can miss by an ulp; the f64 root
    rounded to f32 cannot. Other dtypes (the f64 tests) keep theirs."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def scale_grad(g: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """The clip factor on a gradient as JAX's step applies it (`g *
    scale.astype(g.dtype)`), in f32: an f32 g times gscale; a bf16 g times
    gscale rounded to bf16, the product rounded to bf16."""
    if g.dtype == torch.bfloat16:
        return (g * gscale.to(torch.bfloat16)).float()
    return g.float() * gscale


def adamw_update_plain(p, g, m, v, decay, lr, bc1, bc2, gscale=1.0,
                       wd: float = WEIGHT_DECAY):
    """One leaf: returns (p', m', v') with m', v' in m's and v's dtypes.
    p f32; g f32 or bf16 (a bf16 g is multiplied by gscale rounded to bf16
    and the product rounded to bf16, JAX's clip of a bf16 gradient); lr,
    bc1, bc2, gscale f32 scalars (0-d tensors or floats); decay a bool or a
    {0, 1} f32 vector (packed small leaves). Each Python constant enters as
    f32, as in the JAX expression, and b1 enters in m's dtype, where
    `b1 * m` also rounds. The compute copy of a leaf is p'.to(bfloat16)."""
    lr, bc1, bc2, gscale = (torch.as_tensor(x, dtype=torch.float32,
                                            device=p.device)
                            for x in (lr, bc1, bc2, gscale))
    dev = p.device
    c = lambda x: _f32(x).to(dev)
    g = scale_grad(g, gscale)
    b1m = c(B1).to(m.dtype).float()
    m2 = c(1.0 - B1) * g + (m.float() * b1m).to(m.dtype).float()
    v2 = c(1.0 - B2) * (g * g) + c(B2) * v.float()
    u = (m2 / bc1) / (sqrt_rn(v2 / bc2) + c(EPS))
    if isinstance(decay, torch.Tensor):
        u = u + (c(wd) * decay) * p
    elif decay:
        u = u + c(wd) * p
    return p - lr * u, m2.to(m.dtype), v2.to(v.dtype)


class LeafTable:
    """The device tables of one fixed list of leaves: (p, g, m, v, compute
    copy pointers, length, flags) per leaf, and (leaf index, first element)
    for every CHUNK of every leaf. Built once: the leaves' storage must not
    move afterwards (FusedAdamW keeps its gradients in persistent buffers
    for that). params f32; each grad f32 or bf16; every m of one dtype and
    every v of one dtype, each f32 or bf16; `copies` (optional) a bf16
    tensor or None per leaf; all on one CUDA device and contiguous."""

    def __init__(self, params, grads, ms, vs, decays, copies=None):
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError("LeafTable takes CUDA tensors")
        n = len(params)
        copies = [None] * n if copies is None else list(copies)
        if not len(grads) == len(ms) == len(vs) == len(decays) \
                == len(copies) == n:
            raise ValueError("leaf lists differ in length")
        self.m_dtype, self.v_dtype = ms[0].dtype, vs[0].dtype
        rows = []
        for p, g, m, v, d, c in zip(params, grads, ms, vs, decays, copies):
            if p.dtype != torch.float32 \
                    or g.dtype not in (torch.float32, torch.bfloat16) \
                    or m.dtype != self.m_dtype or v.dtype != self.v_dtype \
                    or (c is not None and c.dtype != torch.bfloat16):
                raise TypeError("params f32, grads f32 or bf16, every m of "
                                "one dtype and every v of one, copies bf16")
            ts = [t for t in (p, g, m, v, c) if t is not None]
            if any(t.device != dev or not t.is_contiguous()
                   or t.numel() != p.numel() for t in ts):
                raise ValueError("leaves must be contiguous, on one device "
                                 "and of equal sizes")
            flags = int(bool(d)) | (2 if g.dtype == torch.bfloat16 else 0)
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), 0 if c is None else c.data_ptr(),
                         p.numel(), flags])
        pairs = [(i, off) for i, p in enumerate(params)
                 for off in range(0, p.numel(), CHUNK)]
        self.keep = (params, grads, ms, vs, copies)  # the storage it names
        self.leaves = torch.tensor(rows, dtype=torch.int64).to(dev)
        self.blocks = torch.tensor(pairs, dtype=torch.int64).to(dev)
        self.n_blocks = len(pairs)


def adamw_update_multi(table: LeafTable, coef: torch.Tensor,
                       wd: float = WEIGHT_DECAY):
    """Update every leaf of `table` in place, one launch. coef: (4,) f32 on
    the card, {lr, bc1, bc2, gscale}."""
    if coef.dtype != torch.float32 or coef.shape != (4,) \
            or coef.device != table.leaves.device:
        raise ValueError("coef must be (4,) f32 on the table's device")
    fn = _build.bind("adamw", "adamw_multi", 3, 3, 6)
    err = fn(table.leaves.data_ptr(), table.blocks.data_ptr(),
             coef.data_ptr(), table.n_blocks,
             _build.dtype_code(table.keep[2][0]),
             _build.dtype_code(table.keep[3][0]), wd, B1, B2, EPS,
             1.0 - B1, 1.0 - B2, _build.stream_of(coef))
    _build.check(err, "adamw_multi")
    adamw_update_multi.launches += 1


adamw_update_multi.launches = 0
