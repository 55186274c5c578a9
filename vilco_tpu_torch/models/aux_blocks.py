"""The auxiliary blocks of vilco_tpu/models/aux_blocks.py, channels-last
(B, T, C) as JAX's, with parameters named after its Flax paths so that
models/convert.py carries them across unchanged:

  SGPBlock    the scalable-granularity perception block: an instant branch
              fc(x) * phi(mean over time), a window branch (convw + convkw)
              * psi(x) and the LayerNormed input, over the (max- or
              avg-pooled) input; then GroupNorm(16) and a 1x1-conv MLP;
              raw convs, the mask applied at the residual join only
  CxAM, CnAM  softmax attention with reduced q/k projections (CnAM's from
              the raw feature `init`, its values from `x`)
  DenseBlock  1x1 conv + GroupNorm(32) + ReLU + dilated 3-tap conv + ReLU
              + dropout
  DenseAPP    five DenseBlocks at rates 3, 6, 12, 18, 24, each on the
              concatenation of the input and the blocks before it, then a
              1x1 conv back to the input width and GroupNorm(32)
  ACConv      DenseAPP, then the mask: FPN1D's top level
              (models/point_transformer.py)

Flax's nn.Conv (explicit padding, dilation, groups) is `Conv`, a Conv1d
on the transposed input; nn.GroupNorm (eps 1e-5) is `GroupNorm`, whose
`weight` is Flax's `scale`; nn.Dense is `Dense`. Each computes in the
promoted dtype of its input and parameters, as Flax's modules do with no
`dtype` set: bf16 activations against f32 masters give f32 outputs.
Dropout and drop-path draw from `rng` (a
torch.Generator) in training mode; without it they are the identity, JAX's
`deterministic=True`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vilco_tpu_torch.models.layers import AffineDropPath, LayerNormC, _dropout
from vilco_tpu_torch.ops.activations import gelu


def _promoted(x, w):
    return torch.promote_types(x.dtype, w.dtype)


class Conv(nn.Module):
    """Flax's nn.Conv over time, channels-last: weight (Cout, Cin / groups,
    K), bias (Cout,), `padding` rows of zeros on each side."""

    lecun_normal = True   # Flax's default kernel init (layers.init_weights_)

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.padding, self.dilation, self.groups = padding, dilation, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        dt = _promoted(x, self.weight)
        out = F.conv1d(x.transpose(1, 2).to(dt), self.weight.to(dt),
                       self.bias.to(dt), padding=self.padding,
                       dilation=self.dilation, groups=self.groups)
        return out.transpose(1, 2)


class GroupNorm(nn.GroupNorm):
    """Flax's nn.GroupNorm (eps 1e-5) over the channels of (B, T, C),
    statistics over time and the group's channels."""

    def __init__(self, num_groups: int, c: int):
        super().__init__(num_groups, c, eps=1e-5)

    def forward(self, x):
        dt = _promoted(x, self.weight)
        return F.group_norm(x.transpose(1, 2).to(dt), self.num_groups,
                            self.weight.to(dt), self.bias.to(dt),
                            self.eps).transpose(1, 2)


class Dense(nn.Linear):
    """Flax's nn.Dense."""

    def forward(self, x):
        dt = _promoted(x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _DepthwiseConv(nn.Module):
    """A plain depthwise conv over time with K//2 zero rows each side, its
    parameters under `conv`."""

    def __init__(self, c: int, kernel_size: int):
        super().__init__()
        self.conv = Conv(c, c, kernel_size, kernel_size // 2, groups=c)

    def forward(self, x):
        return self.conv(x)


def nearest_downsample_mask(mask, out_len: int):
    """F.interpolate(mode="nearest")'s index rule, floor(i T / T_out)."""
    T = mask.shape[-1]
    idx = torch.arange(out_len, device=mask.device) * T // out_len
    return mask[..., idx]


class SGPBlock(nn.Module):
    def __init__(self, n_embd: int, kernel_size: int = 3,
                 n_ds_stride: int = 1, k: float = 1.5, n_out=None,
                 n_hidden=None, path_pdrop: float = 0.0,
                 downsample_type: str = "max"):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size {kernel_size}: odd")
        if downsample_type not in ("max", "avg"):
            raise NotImplementedError("downsample type error")
        C = n_embd
        up_size = round((kernel_size + 1) * k)
        up_size = up_size + 1 if up_size % 2 == 0 else up_size
        n_hidden, n_out = n_hidden or 4 * C, n_out or C
        self.stride, self.downsample_type = n_ds_stride, downsample_type
        if n_ds_stride > 1 and downsample_type == "avg":
            self.ds_conv = Conv(C, C, 1)
        self.ln = LayerNormC(C)
        self.psi = _DepthwiseConv(C, kernel_size)
        self.fc = _DepthwiseConv(C, 1)
        self.convw = _DepthwiseConv(C, kernel_size)
        self.convkw = _DepthwiseConv(C, up_size)
        self.global_fc = _DepthwiseConv(C, 1)
        self.drop_path_out = (AffineDropPath(C, path_pdrop)
                              if path_pdrop > 0 else None)
        self.drop_path_mlp = (AffineDropPath(n_out, path_pdrop)
                              if path_pdrop > 0 else None)
        self.gn = GroupNorm(16, C)
        self.mlp_fc1 = Conv(C, n_hidden, 1)
        self.mlp_fc2 = Conv(n_hidden, n_out, 1)

    def forward(self, x, mask, rng=None):
        T, s = x.shape[1], self.stride
        if s > 1 and self.downsample_type == "max":
            # MaxPool1d(s + 1, s, padding (s + 1) // 2), -inf padded
            x = F.max_pool1d(x.transpose(1, 2), s + 1, s,
                             padding=(s + 1) // 2).transpose(1, 2)
        elif s > 1:
            x = self.ds_conv(F.avg_pool1d(x.transpose(1, 2), s,
                                          s).transpose(1, 2))
        out_mask = nearest_downsample_mask(mask, T // s)
        if x.shape[1] != out_mask.shape[1]:
            raise ValueError(f"SGPBlock needs T divisible by the stride: T "
                             f"{T}, stride {s}")
        out = self.ln(x)
        psi = self.psi(out)
        phi = torch.relu(self.global_fc(out.mean(dim=1, keepdim=True)))
        out = (self.fc(out) * phi + (self.convw(out) + self.convkw(out)) * psi
               + out)
        drop = lambda dp, y: y if dp is None else dp(y, rng)
        out = x * out_mask[..., None].to(x.dtype) + drop(self.drop_path_out,
                                                         out)
        h = self.mlp_fc2(gelu(self.mlp_fc1(self.gn(out))))
        return out + drop(self.drop_path_mlp, h), out_mask


class CxAM(nn.Module):
    def __init__(self, c: int, reduction: int = 8):
        super().__init__()
        self.query = Dense(c, c // reduction)
        self.key = Dense(c, c // reduction)
        self.value = Dense(c, c)

    def forward(self, x):
        attn = torch.softmax(torch.einsum("btc,bsc->bts", self.query(x),
                                          self.key(x)), dim=-1)
        return torch.einsum("bts,bsc->btc", attn, self.value(x))


class CnAM(nn.Module):
    def __init__(self, c: int, reduction: int = 8):
        super().__init__()
        self.query = Dense(c, c // reduction)
        self.key = Dense(c, c // reduction)
        self.value = Dense(c, c)

    def forward(self, x, init):
        attn = torch.softmax(torch.einsum("btc,bsc->bts", self.query(init),
                                          self.key(init)), dim=-1)
        return torch.einsum("bts,bsc->btc", attn, self.value(x))


class DenseBlock(nn.Module):
    def __init__(self, cin: int, num1: int, num2: int, rate: int,
                 drop_out: float = 0.1):
        super().__init__()
        self.drop_out = drop_out
        self.conv1x1 = Conv(cin, num1, 1)
        self.gn = GroupNorm(32, num1)
        self.dilaconv = Conv(num1, num2, 3, padding=rate, dilation=rate)

    def forward(self, x, rng=None):
        x = torch.relu(self.gn(self.conv1x1(x)))
        return _dropout(torch.relu(self.dilaconv(x)), self.drop_out, rng)


class DenseAPP(nn.Module):
    RATES = (3, 6, 12, 18, 24)

    def __init__(self, num_channels: int, channels1: int = 512,
                 channels2: int = 256, drop_out: float = 0.1):
        super().__init__()
        for j, rate in enumerate(self.RATES):
            self.add_module(f"aspp{rate}", DenseBlock(
                num_channels + j * channels2, channels1, channels2, rate,
                drop_out))
        self.conv1x1 = Conv(len(self.RATES) * channels2, num_channels, 1)
        self.gn = GroupNorm(32, num_channels)

    def forward(self, x, rng=None):
        outs, feature = [], x
        for rate in self.RATES:
            o = getattr(self, f"aspp{rate}")(feature, rng)
            outs.append(o)
            feature = torch.cat([o, feature], dim=-1)
        return self.gn(self.conv1x1(torch.cat(outs, dim=-1)))


class ACConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.denseapp = DenseAPP(c)

    def forward(self, x, mask, rng=None):
        out = self.denseapp(x, rng)
        return out * mask[..., None].to(out.dtype), mask
