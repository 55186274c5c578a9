"""Masked 1-D sequence ops on (B, T, C) tensors (vilco_tpu/ops/masked.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 where it is f64 (an f64 witness of an f32
    step)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def masked_conv1d(
    x: torch.Tensor,             # (B, T, C_in)
    mask: torch.Tensor,          # (B, T) bool
    weight: torch.Tensor,        # (C_out, C_in / groups, K), Conv1d layout
    bias: torch.Tensor | None = None,
    stride: int = 1,
    groups: int = 1,
):
    """Conv with symmetric K//2 padding, output multiplied by the
    downsampled mask `mask[:, ::stride]`. Returns (out (B, T', C_out),
    out_mask (B, T')).

    A depthwise conv of at most 7 taps has JAX's length, ceil(T / stride):
    JAX sums K shifted slices of the padded input there, which at an even
    K (a stride-3 MaskedMHCA's 4 taps) stops one row before the conv's
    floor((T + 2 (K//2) - K) / stride) + 1."""
    k = weight.shape[-1]
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype),
                   None if bias is None else bias.to(x.dtype),
                   stride=stride, padding=k // 2, groups=groups)
    out = out.transpose(1, 2)
    out_mask = mask[:, ::stride] if stride > 1 else mask
    if groups == x.shape[-1] == weight.shape[0] and k <= 7:
        out = out[:, :out_mask.shape[1]]
    return out * out_mask[..., None].to(out.dtype), out_mask


def channel_layernorm(x: torch.Tensor, weight=None, bias=None,
                      eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last (channel) axis, computed in f32 (f64 for
    f64 inputs)."""
    dt = x.dtype
    x = wide(x)
    mu = x.mean(dim=-1, keepdim=True)
    res = x - mu
    sigma = (res * res).mean(dim=-1, keepdim=True)
    out = res * torch.rsqrt(sigma + eps)
    if weight is not None:
        out = out * wide(weight.to(dt))
    if bias is not None:
        out = out + wide(bias.to(dt))
    return out.to(dt)


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid position table (n_position, d_hid), f32."""
    position = np.arange(n_position)[:, None].astype(np.float64)
    hid_j = np.arange(d_hid)[None, :]
    angle = position / np.power(10000.0, 2 * (hid_j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def masked_max_pool1d(x: torch.Tensor, mask: torch.Tensor, kernel: int,
                      stride: int):
    """MaxPool1d padded with -inf (kernel//2 each side), then masked by
    `mask[:, ::stride]`. At kernel s + 1 and stride s the pool gives
    floor((T + 2 (K//2) - K) / s) + 1 rows and the mask ceil(T / s), as in
    JAX: at an even kernel (s = 3) and T a multiple of s they differ by
    one and the product raises, as JAX's does."""
    pad = kernel // 2
    xp = F.pad(x.transpose(1, 2), (pad, pad), value=float("-inf"))
    out = F.max_pool1d(xp, kernel, stride).transpose(1, 2)
    out_mask = mask[:, ::stride]
    return out * out_mask[..., None].to(out.dtype), out_mask


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int):
    """Mean over `dim` counting only the positions where `mask` is True; an
    empty row gives 0."""
    m = mask.to(x.dtype)
    if m.dim() < x.dim():
        m = m.unsqueeze(-1)
    total = (x * m).sum(dim)
    count = m.sum(dim)
    return total / torch.where(count == 0, torch.ones_like(count), count)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """x * rsqrt(max(sum x^2, eps)) along `dim` (vilco_tpu/cl/prompt.py)."""
    sq = x.square().sum(dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))
