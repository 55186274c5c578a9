"""Building blocks of the point-transformer trunk (vilco_tpu/models/layers.py).

Layout is (B, T, C) with (B, T) bool masks; module and parameter names
follow the Flax tree (see models/convert.py). Parameters may be f32 masters
under a bf16 forward: every module casts its parameters to the input's
dtype on use, as the JAX modules do.

Regularisers: a forward given `rng` (a torch.Generator on the input's
device) in training mode applies the drop-path of the blocks built with a
rate > 0 (AffineDropPath residuals, the channel block's two residuals),
the blocks' `proj_drop` dropout (after the attention's and the
cross-attention's output projection, after the MLP's GELU and after its
second layer) and the XL stage's dropouts (`dropout`, default
XL_DROPOUT: on the attention probabilities inside the kernel, after the
output projection, after the FF's GELU and after its second layer).
Without `rng` they are the identity (the JAX modules'
`deterministic=True`, or training with the rates at 0).

  MaskedConv, LayerNormC, Scale, AffineDropPath
  MaskedMHCA        depthwise q/k/v convs (kernels/dwconv.py) + LN + dense
                    attention (kernels/attention.py: K1, or K1f / K1n by
                    `attention_impl`) or, with a window, banded attention
                    (kernels/banded_attention.py)
  MaskedMHA         1x1 projections + dense attention; self- or
                    cross-attention (kernels/attention.py, Tq != Tk)
  ChannelBlock      channel attention + MLP
  TimeAdapter       the CL adapter: an MLP over the time axis, T -> 5T -> T/2
  TransformerBlock  self-attention, the optional time adapter beside it,
                    the optional text cross-attention and the
                    channel-attention blend
  XLRelAttention    single stream: no mems, no g stream, no segments
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vilco_tpu_torch.kernels.attention import (
    flash_attention,
    fused_attention,
    fused_attention_blc,
)
from vilco_tpu_torch.kernels.banded_attention import banded_attention_blc
from vilco_tpu_torch.kernels.dwconv import fused_dwconv_qkv
from vilco_tpu_torch.kernels.xl_attention import xl_rel_attention
from vilco_tpu_torch.ops.activations import gelu
from vilco_tpu_torch.ops.attention import channel_attention
from vilco_tpu_torch.ops.masked import (
    channel_layernorm,
    masked_conv1d,
    masked_max_pool1d,
    wide,
)

T_C_ALPHA = 0.8  # train_cfg.t_c_alpha: temporal vs channel attention blend
XL_DROPOUT = 0.1  # model.xl_dropout (the xlnet json's dropout)


def _drop_path(x, rate: float, rng):
    """Stochastic depth: each batch row kept with probability 1 - rate and
    rescaled by 1 / (1 - rate)."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=rng,
                      device=x.device) < keep
    return x / keep * mask.to(x.dtype)


def _dropout(x, rate: float, rng):
    """Elementwise dropout with rescaling by 1 / (1 - rate)."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Linear(nn.Linear):
    """nn.Linear that casts its parameters to the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class MaskedConv(nn.Module):
    """Masked 1-D conv (stride 1) with symmetric K//2 padding; weight
    (Cout, Cin, K)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 bias: bool = True, bias_init: float = 0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel_size))
        self.bias = (nn.Parameter(torch.full((cout,), float(bias_init)))
                     if bias else None)

    def forward(self, x, mask):
        return masked_conv1d(x, mask, self.weight, self.bias)


class LayerNormC(nn.Module):
    """Channel LayerNorm (eps 1e-5), computed in f32."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return channel_layernorm(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """Flax's nn.LayerNorm: statistics in f32 (f64 for f64 inputs), result
    in the input dtype."""

    def forward(self, x):
        return F.layer_norm(wide(x), self.normalized_shape,
                            wide(self.weight), wide(self.bias),
                            self.eps).to(x.dtype)


class Scale(nn.Module):
    """Learnable scalar multiplier."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class AffineDropPath(nn.Module):
    """Per-channel learnable scale (init 1e-4), then drop-path at `rate`."""

    def __init__(self, c: int, rate: float):
        super().__init__()
        self.rate = rate
        self.scale = nn.Parameter(torch.full((1, 1, c), 1e-4))

    def forward(self, x, rng=None):
        return _drop_path(self.scale.to(x.dtype) * x, self.rate, rng)


class _DWKernel(nn.Module):
    """A depthwise-conv weight with MaskedConv's name and layout (E, 1, K)."""

    def __init__(self, e: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(e, 1, kernel_size))


class MaskedMHCA(nn.Module):
    """Multi-head conv attention: the three depthwise q/k/v convs (stride 1
    or 2) in one kernel launch, LN, projections, then attention, dispatched
    as JAX's MaskedMHCA does: with `window` > 0 (the half window) the
    banded kernel (LocalMaskedMHCA); else by `attention_impl`, "flash" the
    flash kernel (self-attention: Tq == Tk), "pallas_naive" the head-major
    one, and otherwise the channels-last dense kernel."""

    def __init__(self, n_embd: int, n_head: int, stride: int = 1,
                 window: int = -1, attention_impl: str = "xla",
                 proj_drop: float = 0.0):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride {stride}: the fused convs take 1 or 2")
        self.n_head, self.stride, self.window = n_head, stride, window
        self.proj_drop = proj_drop
        self.attention_impl = attention_impl
        E = n_embd
        self.query_conv = _DWKernel(E, 3)
        self.key_conv = _DWKernel(E, 3)
        self.value_conv = _DWKernel(E, 3)
        self.query_norm = LayerNormC(E)
        self.key_norm = LayerNormC(E)
        self.value_norm = LayerNormC(E)
        self.query = Linear(E, E)
        self.key = Linear(E, E)
        self.value = Linear(E, E)
        self.proj = Linear(E, E)

    def forward(self, x, mask, rng=None):
        w3 = torch.stack([self.query_conv.weight[:, 0],
                          self.key_conv.weight[:, 0],
                          self.value_conv.weight[:, 0]])      # (3, E, 3)
        w3 = w3.transpose(1, 2).to(x.dtype).contiguous()     # (3, 3, E)
        q, k, v = fused_dwconv_qkv(x.contiguous(), w3, self.stride)
        q_mask = mask[:, ::self.stride] if self.stride > 1 else mask
        mm = q_mask[..., None].to(q.dtype)
        q = self.query_norm(q * mm)
        k = self.key_norm(k * mm)
        v = self.value_norm(v * mm)
        q, k, v = self.query(q), self.key(k), self.value(v)
        kv_mask = q_mask.contiguous()
        B, T, E = q.shape
        heads = lambda x: x.view(B, T, self.n_head, E // self.n_head)
        if self.window > 0:
            out = banded_attention_blc(q, k, v, kv_mask, self.n_head,
                                       self.window)
        elif self.attention_impl == "flash":
            out = flash_attention(heads(q), heads(k), heads(v),
                                  kv_mask).reshape(B, T, E)
        elif self.attention_impl == "pallas_naive":
            out = fused_attention(heads(q), heads(k), heads(v),
                                  kv_mask).reshape(B, T, E)
        else:
            out = fused_attention_blc(q, k, v, kv_mask, self.n_head)
        out = _dropout(self.proj(out), self.proj_drop, rng)
        return out * mm, q_mask


class MaskedMHA(nn.Module):
    """Dense masked attention with 1x1 projections: self-attention, or
    cross-attention of x's queries to `enc`'s keys and values (Tq != Tk)
    through the attention kernel; the output is zeroed at x's invalid
    positions."""

    def __init__(self, n_embd: int, n_head: int, proj_drop: float = 0.0):
        super().__init__()
        E = n_embd
        self.n_head, self.proj_drop = n_head, proj_drop
        self.query = Linear(E, E)
        self.key = Linear(E, E)
        self.value = Linear(E, E)
        self.proj = Linear(E, E)

    def forward(self, x, mask, enc=None, enc_mask=None, rng=None):
        src, kv_mask = (x, mask) if enc is None else (enc, enc_mask)
        q, k, v = self.query(x), self.key(src), self.value(src)
        out = self.proj(fused_attention_blc(q, k, v, kv_mask.contiguous(),
                                            self.n_head))
        out = _dropout(out, self.proj_drop, rng)
        return out * mask[..., None].to(out.dtype), mask


class ChannelBlock(nn.Module):
    """Channel-attention block: qkv -> channel attention -> proj ->
    residual; LayerNorm (eps 1e-6) -> MLP -> residual; drop-path at
    `drop_path` on both residuals."""

    def __init__(self, n_embd: int, n_head: int, drop_path: float):
        super().__init__()
        C = n_embd
        self.n_head, self.drop_path = n_head, drop_path
        self.qkv = Linear(C, 3 * C, bias=False)
        self.proj = Linear(C, C)
        self.norm2 = LayerNorm(C, eps=1e-6)
        self.mlp_fc1 = Linear(C, 4 * C)
        self.mlp_fc2 = Linear(4 * C, C)

    def forward(self, x, rng=None):
        B, T, C = x.shape
        H = self.n_head
        qkv = self.qkv(x).reshape(B, T, 3, H, C // H)
        cur = self.proj(channel_attention(qkv, H).reshape(B, T, C))
        x = x + _drop_path(cur, self.drop_path, rng)
        h = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))
        return x + _drop_path(h, self.drop_path, rng)


class TimeAdapter(nn.Module):
    """The CL time adapter (vilco_tpu/models/layers.py::TimeAdapter): a
    Linear over the time axis of (B, t_in, C), t_in -> 5 t_in, GELU, ->
    t_in / 2, so its output has the strided attention's length. `fc2`
    starts at zero."""

    def __init__(self, t_in: int, down_sample: int = 5,
                 t_out_factor: int = 2):
        super().__init__()
        self.t_in = t_in
        self.fc1 = Linear(t_in, down_sample * t_in)
        self.fc2 = Linear(down_sample * t_in, t_in // t_out_factor)
        self.fc2.zero_init = True

    def forward(self, x):
        if x.shape[1] != self.t_in:
            raise ValueError(f"TimeAdapter of t_in {self.t_in} given T="
                             f"{x.shape[1]}")
        h = gelu(self.fc1(x.transpose(1, 2)))
        return self.fc2(h).transpose(1, 2)


class TransformerBlock(nn.Module):
    """Pre-LN block: MaskedMHCA (+ max-pool skip when strided; banded with
    `window` > 0), with `adapter_t_in` > 0 a TimeAdapter on the block's
    LayerNormed input added to the attention output, with
    `use_cross_modal` the text cross-attention (LayerNorm ln3 on both
    streams, MaskedMHA, sharing the attention residual's drop-path), MLP,
    and with `use_channel_attn` on stride-1 blocks the channel-attention
    blend by T_C_ALPHA. `proj_drop` is the dropout after the attention's
    and cross-attention's projections and inside the MLP. With `path_drop`
    > 0 both residuals carry AffineDropPath scales, as in JAX; at 0 there
    are none (the reference's nn.Identity)."""

    def __init__(self, n_embd: int, n_head: int, n_ds_stride: int = 1,
                 path_drop: float = 0.0, window: int = -1,
                 use_cross_modal: bool = False,
                 use_channel_attn: bool = True, attention_impl: str = "xla",
                 proj_drop: float = 0.0, adapter_t_in: int = 0):
        super().__init__()
        E = n_embd
        self.stride, self.proj_drop = n_ds_stride, proj_drop
        self.ln1 = LayerNormC(E)
        self.attn = MaskedMHCA(E, n_head, stride=n_ds_stride, window=window,
                               attention_impl=attention_impl,
                               proj_drop=proj_drop)
        self.adapter = (TimeAdapter(adapter_t_in) if adapter_t_in > 0
                        else None)
        self.drop_path_attn = (AffineDropPath(E, path_drop) if path_drop > 0
                               else None)
        self.drop_path_mlp = (AffineDropPath(E, path_drop) if path_drop > 0
                              else None)
        if use_cross_modal:
            self.ln3 = LayerNormC(E)
            self.cross_attn = MaskedMHA(E, n_head, proj_drop)
        else:
            self.ln3 = self.cross_attn = None
        self.ln2 = LayerNormC(E)
        self.mlp_fc1 = Linear(E, 4 * E)
        self.mlp_fc2 = Linear(4 * E, E)
        self.channel_attn = (ChannelBlock(E, n_head, path_drop)
                             if use_channel_attn and n_ds_stride == 1
                             else None)

    @staticmethod
    def _residual(dp, x, rng):
        return x if dp is None else dp(x, rng)

    def forward(self, x, mask, rng=None, cross_y=None, cross_y_mask=None):
        s = self.stride
        ln1 = self.ln1(x)
        out, out_mask = self.attn(ln1, mask, rng)
        if self.adapter is not None:
            out = out + self.adapter(ln1)
        out_mask_f = out_mask[..., None].to(out.dtype)
        if s > 1:
            skip, _ = masked_max_pool1d(x, mask, kernel=s + 1, stride=s)
        else:
            skip = x
        out = skip * out_mask_f + self._residual(self.drop_path_attn, out,
                                                 rng)
        if self.cross_attn is not None and cross_y is not None:
            cross_out, _ = self.cross_attn(self.ln3(out), out_mask,
                                           self.ln3(cross_y), cross_y_mask,
                                           rng)
            out = out * out_mask_f + self._residual(self.drop_path_attn,
                                                    cross_out, rng)
        h = _dropout(gelu(self.mlp_fc1(self.ln2(out))), self.proj_drop, rng)
        h = _dropout(self.mlp_fc2(h), self.proj_drop, rng)
        out = out + self._residual(self.drop_path_mlp, h * out_mask_f, rng)
        if self.channel_attn is not None:
            out2 = self.channel_attn(ln1, rng)
            out = T_C_ALPHA * out + (1.0 - T_C_ALPHA) * out2
        return out, out_mask


class XLRelAttention(nn.Module):
    """Transformer-XL relative attention + FF, post-LN (eps 1e-12), single
    stream. Head projections keep Flax's (C, H, D) layout."""

    def __init__(self, d_model: int, n_head: int, d_inner: int,
                 dropout: float = XL_DROPOUT):
        super().__init__()
        self.dropout = dropout
        C, H = d_model, n_head
        D = C // H
        for name in ("q", "k", "v", "r", "o"):
            self.register_parameter(name, nn.Parameter(torch.zeros(C, H, D)))
        self.r_w_bias = nn.Parameter(torch.zeros(H, D))
        self.r_r_bias = nn.Parameter(torch.zeros(H, D))
        self.ln_attn = LayerNorm(C, eps=1e-12)
        self.ff1 = Linear(C, d_inner)
        self.ff2 = Linear(d_inner, C)
        self.ln_ff = LayerNorm(C, eps=1e-12)

    def forward(self, x, mask, rng=None):
        T, C = x.shape[1:]
        dt = x.dtype
        # relative positions T .. -T+1
        pos_seq = torch.arange(T, -T, -1.0, device=x.device)
        inv_freq = 1.0 / (10000.0 ** (torch.arange(0, C, 2.0,
                                                   device=x.device) / C))
        sin_inp = pos_seq[:, None] * inv_freq[None, :]
        pos_emb = torch.cat([torch.sin(sin_inp), torch.cos(sin_inp)],
                            dim=-1).to(dt)                    # (2T, C)
        w = lambda p: p.to(dt)
        q = torch.einsum("btc,chd->bthd", x, w(self.q))
        k = torch.einsum("btc,chd->bthd", x, w(self.k))
        v = torch.einsum("btc,chd->bthd", x, w(self.v))
        r = torch.einsum("tc,chd->thd", pos_emb, w(self.r))
        rate, seed = 0.0, 0
        if rng is not None:
            # drawn on the generator's device: no host sync on the card
            rate = self.dropout
            seed = torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), generator=rng,
                                 device=rng.device)
        out = xl_rel_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), r.contiguous(),
                               w(self.r_w_bias), w(self.r_r_bias),
                               mask.contiguous(), seed, rate)
        o = torch.einsum("bqhd,chd->bqc", out, w(self.o))
        y = self.ln_attn(x + _dropout(o, self.dropout, rng))
        f = _dropout(gelu(self.ff1(y)), self.dropout, rng)
        f = _dropout(self.ff2(f), self.dropout, rng)
        return self.ln_ff(y + f) * mask[..., None].to(dt)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from `generator`, with Flax's initializers: He-uniform
    conv kernels, LeCun-normal dense kernels with zero bias (zero kernels
    where the module says `zero_init`: the time adapters' fc2), N(0,
    0.02) XL projections and biases, U(-b, b) for the own parameters of a
    module that sets `uniform_init = b` (the prompt pool's prompts and
    keys, b = 1). Norms, scales and conv biases keep the constants their
    constructors set."""
    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (MaskedConv, _DWKernel)):
            w = m.weight
            uniform_(w, math.sqrt(6.0 / (w.shape[1] * w.shape[2])))
        elif isinstance(m, nn.Linear):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                normal_(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, XLRelAttention):
            for name in ("q", "k", "v", "r", "o", "r_w_bias", "r_r_bias"):
                normal_(getattr(m, name), 0.02)
        elif hasattr(m, "uniform_init"):
            for p in m.parameters(recurse=False):
                uniform_(p, m.uniform_init)
