"""Transformer MLP (fc1 -> tanh GELU -> fc2), forward.

Replaces vilco_tpu/kernels/mlp.py::fused_mlp (the Pallas `_run`) with
csrc/fused_mlp.cu. bfloat16: two launches of one Hopper GEMM (wgmma fed by
a TMA ring, warp-specialised, persistent), H = bf16(gelu(x W1 + b1)) into a
scratch tensor and out = bf16(H W2 + b2), each epilogue adding its bias in
f32: the TPU kernel keeps H in VMEM, which Hopper has no room for (the
source says why). H is rounded where the TPU kernel rounds it, so the
function is the Pallas kernel's. float32 (the parity path): one SIMT
kernel. The weights and biases are rounded to x's dtype, as the Pallas
call rounds them. Its backward recomputes through the plain form (the JAX
custom_vjp does the same: the VQ ViT is frozen, so no gradient flows there
on the flagship path).

A CPU tensor (any, in `plain_math()`) takes `fused_mlp_plain`; a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vilco_tpu_torch.kernels import _build, takes_plain


def fused_mlp_plain(x, w1, b1, w2, b2):
    """Plain version (the JAX `_ref_mlp`): x (N, C), w1 (C, H), w2 (H, C);
    both products accumulate in f32 with the weights rounded to x's dtype,
    the biases added in f32, the GELU's result rounded to x's dtype."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    h = F.gelu(h, approximate="tanh").to(dt)
    o = h.float() @ w2.to(dt).float() + b2.float()
    return o.to(dt)


def fused_mlp_cuda(x, w1, b1, w2, b2):
    """Launch the kernels on x (N, C) (bf16: the two GEMMs, one wrapper
    call): out (N, C) in x.dtype."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (w1, b1, w2, b2)):
        raise ValueError("x and the weights must be on one CUDA device")
    code = _build.dtype_code(x)
    N, C = x.shape
    Hd = w1.shape[1]
    if w1.shape != (C, Hd) or b1.shape != (Hd,) or w2.shape != (Hd, C) \
            or b2.shape != (C,):
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
                         f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 "
                         f"{tuple(b2.shape)}")
    if code == 1 and (C % 16 or Hd % 16):
        raise ValueError(f"bf16 needs C={C} and hidden {Hd} multiples of 16")
    x = x.contiguous()
    w1, b1, w2, b2 = (t.to(x.dtype).contiguous() for t in (w1, b1, w2, b2))
    out = torch.empty_like(x)
    # bf16: the GELU output between the two GEMMs (N x Hd, 1.51 GB at the
    # VQ clip call), written once and read once
    h = torch.empty((N, Hd), dtype=x.dtype, device=x.device) \
        if code == 1 else None
    fn = _build.bind("fused_mlp", "fused_mlp_fwd", 7, 4)
    err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), 0 if h is None else h.data_ptr(), out.data_ptr(),
             N, C, Hd, code, _build.stream_of(x))
    _build.check(err, "fused_mlp_fwd")
    fused_mlp.launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return fused_mlp_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = fused_mlp_plain(*xs)
            wrt = [t for t in xs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(got) if n else None for n in need)


def fused_mlp(x, w1, b1, w2, b2):
    """gelu_tanh(x @ w1 + b1) @ w2 + b2 on (..., C) tokens; w1 (C, H), b1
    (H,), w2 (H, C), b2 (C,) (the JAX layout). Differentiable."""
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c)
    if takes_plain(x):
        return fused_mlp_plain(x2, w1, b1, w2, b2).reshape(*lead, c)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, w1, b1, w2, b2)):
        out = _FusedMLP.apply(x2, w1, b1, w2, b2)
    else:
        out = fused_mlp_cuda(x2, w1, b1, w2, b2)
    return out.reshape(*lead, c)


fused_mlp.launches = 0
