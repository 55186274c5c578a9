"""Fused depthwise q/k/v convolution (K=3), forward and backward.

Replaces the Pallas kernels of vilco_tpu/kernels/dwconv.py
(`fused_dwconv_qkv`: `_run_fwd`, `_run_bwd`; `fused_dwconv_qkv_s2`:
`_run_fwd_s2`, `_run_bwd_s2`) with csrc/dwconv_qkv.cu, whose kernels take
the stride (1 or 2) as an argument. On the card they are bound by memory
traffic: each thread moves 16 bytes along C; the forward computes all three
outputs from one read of x, the backward computes dx from the three output
gradients (the transpose conv) and dw (3, 3, C) from per-chunk f32
partials reduced by a second launch, in a fixed order. The mask multiply
stays with the caller (MaskedMHCA), as in the JAX model.

A CPU tensor takes `fused_dwconv_qkv_plain` (autograd through it gives the
backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vilco_tpu_torch.kernels import _build


def fused_dwconv_qkv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """Plain version: three depthwise convs of x (B, T, C) with taps
    w (3, 3, C) (w[j, i] = tap i of conv j in q, k, v order), zero
    padding 1, computed in f32 and returned in x.dtype."""
    C = x.shape[-1]
    xt = x.float().transpose(1, 2)
    # output channel j*C + c convolves copy j of x with taps w[j, :, c]
    weight = w.float().permute(0, 2, 1).reshape(3 * C, 1, 3)
    out = F.conv1d(xt.repeat(1, 3, 1), weight, stride=stride, padding=1,
                   groups=3 * C)
    out = out.transpose(1, 2).to(x.dtype)
    return tuple(out[..., j * C:(j + 1) * C].contiguous() for j in range(3))


def fused_dwconv_qkv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """(q, k, v), each (B, (T - 1) // stride + 1, C) in x.dtype;
    differentiable in x and w."""
    if x.dim() != 3 or w.shape != (3, 3, x.shape[-1]):
        raise ValueError(f"x (B, T, C) and w (3, 3, C) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.device.type == "cpu":
        return fused_dwconv_qkv_plain(x, w, stride)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x on {x.device} and w on {w.device}: both must "
                         "be on one CUDA device (or on the CPU)")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}")
    B, T, C = x.shape
    _build.dtype_code(x)
    if C % (16 // x.element_size()):
        raise ValueError(f"C={C} must be a multiple of "
                         f"{16 // x.element_size()} for 16-byte accesses")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FusedDWConv.apply(x, w, stride)
    return dwconv_fwd_cuda(x, w, stride)


def dwconv_fwd_cuda(x, w, stride: int):
    B, T, C = x.shape
    T_out = (T - 1) // stride + 1
    q, k, v = (torch.empty((B, T_out, C), dtype=x.dtype, device=x.device)
               for _ in range(3))
    fn = _build.bind("dwconv_qkv", "dwconv_qkv_fwd", 5, 6)
    err = fn(x.data_ptr(), w.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), B, T, T_out, C, stride, _build.dtype_code(x),
             _build.stream_of(x))
    _build.check(err, "dwconv_qkv_fwd")
    fused_dwconv_qkv.launches += 1
    return q, k, v


DW_ROWS = 64   # output rows per dw partial (csrc/dwconv_qkv.cu)


def dwconv_bwd_cuda(x, w, dq, dk, dv, stride: int):
    """(dx in x.dtype, dw in w.dtype) from the three output gradients."""
    B, T, C = x.shape
    T_out = dq.shape[1]
    dq, dk, dv = (g.contiguous() for g in (dq, dk, dv))
    if any(g.shape != (B, T_out, C) or g.dtype != x.dtype
           or g.data_ptr() % 16 for g in (dq, dk, dv)):
        raise ValueError("output gradients must match the forward outputs "
                         "and be 16-byte aligned")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    chunks = B * ((T_out + DW_ROWS - 1) // DW_ROWS)
    partial = torch.empty((chunks, 9, C), dtype=torch.float32,
                          device=x.device)
    fn = _build.bind("dwconv_qkv", "dwconv_qkv_bwd", 8, 6)
    err = fn(x.data_ptr(), w.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
             B, T, T_out, C, stride, _build.dtype_code(x),
             _build.stream_of(x))
    _build.check(err, "dwconv_qkv_bwd")
    dwconv_bwd_cuda.launches += 1    # one call: dx, dw partials, dw reduce
    return dx, dw


class _FusedDWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return dwconv_fwd_cuda(x, w, stride)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, w = ctx.saved_tensors
        dx, dw = dwconv_bwd_cuda(x, w, dq, dk, dv, ctx.stride)
        return dx, dw, None


fused_dwconv_qkv.launches = 0
dwconv_bwd_cuda.launches = 0
