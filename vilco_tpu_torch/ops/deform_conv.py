"""1-D deformable convolution with learned offsets
(vilco_tpu/ops/deform_conv.py): each tap samples the input at its base
position plus a learned fractional offset by linear interpolation, then
the usual weighted sum. One gather and one einsum, differentiable in the
input, the offsets and the weights; no configuration of the repo reaches
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def deform_conv1d(x, offsets, weight, bias=None):
    """'same' deformable conv: x (B, T, Cin), offsets (B, T, K), weight
    (Cout, Cin, K) (Conv1d's layout), bias (Cout,) or None -> (B, T, Cout).
    Tap k of output position t samples x[t + k - K//2 + offsets[t, k]],
    its two neighbours clamped to [0, T - 1]."""
    B, T, Cin = x.shape
    K = weight.shape[-1]
    ar = lambda n: torch.arange(n, dtype=x.dtype, device=x.device)
    base = ar(T)[None, :, None] + ar(K)[None, None, :] - K // 2   # (1, T, K)
    pos = base + offsets.to(x.dtype)
    lo = torch.clamp(torch.floor(pos), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = (pos - lo)[..., None]

    def take(idx):                               # (B, T, K) -> (B, T, K, Cin)
        i = idx.long().reshape(B, T * K, 1).expand(B, T * K, Cin)
        return torch.gather(x, 1, i).reshape(B, T, K, Cin)

    samp = take(lo) * (1 - frac) + take(hi) * frac
    out = torch.einsum("btkc,dck->btd", samp, weight.to(x.dtype))
    return out if bias is None else out + bias.to(x.dtype)


class PackedDeformConv(nn.Module):
    """The offsets predicted from the input by a K-tap conv whose kernel,
    `offset_kernel`, keeps JAX's (K, Cin, K) layout (zeros at init), then
    the deformable conv of `weight` (Cout, Cin, K) and `bias`; the output
    masked."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3):
        super().__init__()
        K = kernel_size
        self.offset_kernel = nn.Parameter(torch.zeros(K, cin, K))
        self.weight = nn.Parameter(torch.zeros(features, cin, K))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask):
        K = self.weight.shape[-1]
        offsets = F.conv1d(x.transpose(1, 2),
                           self.offset_kernel.permute(2, 1, 0).to(x.dtype),
                           padding=K // 2).transpose(1, 2)      # (B, T, K)
        out = deform_conv1d(x, offsets, self.weight, self.bias)
        return out * mask[..., None].to(out.dtype), mask
