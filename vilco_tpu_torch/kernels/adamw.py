"""AdamW update over many parameter leaves, one launch.

Replaces vilco_tpu/kernels/adamw.py::adamw_update_leaf (a Pallas kernel per
leaf) with csrc/adamw.cu: one multi-tensor launch over a device table of
leaves (pointers, length, decay flag) and a block-to-chunk map. The update
is FusedAdamW's (vilco_tpu/train/optim.py), operation for operation,
including `b1 * m` rounded in m's storage dtype before the f32 add and the
bf16 state stores; lr, bc1, bc2 and the clip factor come from device
memory. Bound by memory traffic (20 bytes per element with bf16 moments).

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


def adamw_update_plain(p, g, m, v, decay, lr, bc1, bc2, gscale=1.0,
                       wd: float = WEIGHT_DECAY):
    """One leaf: returns (p', m', v') with m', v' in m's and v's dtypes.
    p, g f32; lr, bc1, bc2, gscale f32 scalars (0-d tensors or floats);
    decay a bool or a {0, 1} f32 vector (packed small leaves). Each
    Python constant enters as f32, as in the JAX expression, and b1
    enters in m's dtype, where `b1 * m` also rounds."""
    lr, bc1, bc2, gscale = (torch.as_tensor(x, dtype=torch.float32,
                                            device=p.device)
                            for x in (lr, bc1, bc2, gscale))
    dev = p.device
    c = lambda x: _f32(x).to(dev)
    g = g.float() * gscale
    b1m = c(B1).to(m.dtype).float()
    m2 = c(1.0 - B1) * g + (m.float() * b1m).to(m.dtype).float()
    v2 = c(1.0 - B2) * (g * g) + c(B2) * v.float()
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + c(EPS))
    if isinstance(decay, torch.Tensor):
        u = u + (c(wd) * decay) * p
    elif decay:
        u = u + c(wd) * p
    return p - lr * u, m2.to(m.dtype), v2.to(v.dtype)


class LeafTable:
    """The device tables of one fixed list of leaves: (p, g, m, v pointers,
    length, decay flag) per leaf, and (leaf index, first element) for every
    CHUNK of every leaf. Built once: the leaves' storage must not move
    afterwards (FusedAdamW keeps its gradients in one persistent buffer for
    that). params/grads f32; every m and v of one dtype, f32 or bf16; all
    on one CUDA device and contiguous."""

    def __init__(self, params, grads, ms, vs, decays):
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError("LeafTable takes CUDA tensors")
        n = len(params)
        if not len(grads) == len(ms) == len(vs) == len(decays) == n:
            raise ValueError("leaf lists differ in length")
        self.moment_dtype = ms[0].dtype
        for p, g, m, v in zip(params, grads, ms, vs):
            if p.dtype != torch.float32 or g.dtype != torch.float32 \
                    or m.dtype != self.moment_dtype \
                    or v.dtype != self.moment_dtype:
                raise TypeError("params and grads f32, m and v one dtype")
            if any(t.device != dev or not t.is_contiguous()
                   or t.numel() != p.numel() for t in (p, g, m, v)):
                raise ValueError("leaves must be contiguous, on one device "
                                 "and of equal sizes")
        rows = [[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 p.numel(), int(bool(d))]
                for p, g, m, v, d in zip(params, grads, ms, vs, decays)]
        pairs = [(i, off) for i, p in enumerate(params)
                 for off in range(0, p.numel(), CHUNK)]
        self.keep = (params, grads, ms, vs)    # the storage the table names
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
    fn = _build.bind("adamw", "adamw_multi", 3, 2, 6)
    err = fn(table.leaves.data_ptr(), table.blocks.data_ptr(),
             coef.data_ptr(), table.n_blocks,
             _build.dtype_code(table.keep[2][0]), wd, B1, B2, EPS,
             1.0 - B1, 1.0 - B2, _build.stream_of(coef))
    _build.check(err, "adamw_multi")
    adamw_update_multi.launches += 1


adamw_update_multi.launches = 0
