"""Pyramid backbones (vilco_tpu/models/backbone.py).

ConvTransformerBackbone, the MQ variant:

  (conv embed of cfg.embd_kernel_size taps [+ LN] + ReLU) x arch[0]
  [-> + abs PE with cfg.use_abs_pe] -> stem TransformerBlock x arch[1]
  -> cfg.xl_layers XLRelAttention layers (`cfg.use_xl`; else one more stem
  block, `pre_branch`, as JAX builds it) -> branch TransformerBlock x
  arch[2] (stride cfg.scale_factor each); the stem and branch blocks
  attend through `cfg.attention_impl` (K1, K1f or K1n; models/layers.py::
  MaskedMHCA) and blend in their channel attention by cfg.t_c_alpha. With
  `cfg.use_cross_modal` the text tower runs first: text (1x1 conv embed [+
  LN] + ReLU) x arch[0] -> text stem TransformerBlock x arch[1]
  (self-attention only), and every branch block outside
  cfg.cross_modal_skip_levels cross-attends to its output; given no text,
  the tower and the cross-attention are skipped, as in JAX. The stem blocks
  get no cross-attention: JAX builds them cross-modal but calls them with
  no text (vilco_tpu/models/backbone.py:138-147), and its TransformerBlock
  builds `cross_attn` only when given text (layers.py:412). Branch blocks
  in `adapt_blocks` carry a TimeAdapter on their input length.

ConvBackbone (`cfg.backbone_type` "conv"): the conv embed -> stem
ConvBlock x arch[1] -> branch ConvBlock x arch[2] (stride cfg.scale_factor
each); no position encoding, text or attention.

DualTowerBackbone, the NLQ variant, arch (convs, txt_stem, vid_stem,
cross_branch, plain_branch):

  video (conv embed [+ LN] + ReLU) x arch[0] [-> + abs PE]; text (1x1 conv
  embed [+ LN] + ReLU) x arch[0] -> text stem x arch[1] (full attention) ->
  video stem x arch[2] (banded attention + text cross-attention) -> branch
  x (arch[3] + arch[4]) (stride cfg.scale_factor, banded; the first arch[3]
  with text cross-attention); no channel attention.

Without the embedding's LayerNorm (`cfg.embd_with_ln` False) its convs
carry a bias, as JAX's. Each backbone returns the feature pyramid and its
masks; `rng` switches the blocks' regularisers on (models/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from vilco_tpu_torch.core.config import ModelConfig
from vilco_tpu_torch.models.layers import (
    LayerNormC,
    MaskedConv,
    TransformerBlock,
    XLRelAttention,
)
from vilco_tpu_torch.ops.masked import sinusoid_encoding


def _embed(backbone, prefix: str, n: int, x, mask):
    """n x (masked conv [+ channel LN] + ReLU) under `prefix`_i and
    `prefix`_norm_i."""
    for i in range(n):
        x, mask = getattr(backbone, f"{prefix}_{i}")(x, mask)
        norm = getattr(backbone, f"{prefix}_norm_{i}", None)
        x = torch.relu(x if norm is None else norm(x))
    return x, mask


def _add_embed(backbone, prefix: str, n: int, cin: int, e: int, k: int,
               with_ln: bool):
    for i in range(n):
        backbone.add_module(f"{prefix}_{i}", MaskedConv(
            cin if i == 0 else e, e, k, bias=not with_ln))
        if with_ln:
            backbone.add_module(f"{prefix}_norm_{i}", LayerNormC(e))


def _add_pe(backbone, x, mask):
    if not backbone.cfg.use_abs_pe:
        return x
    T = x.shape[1]
    if T > backbone.cfg.max_seq_len:
        raise ValueError(f"T={T} exceeds max_seq_len="
                         f"{backbone.cfg.max_seq_len}")
    return x + backbone.pe[None, :T].to(x.dtype) * mask[..., None].to(x.dtype)


def _pe_table(cfg: ModelConfig) -> torch.Tensor:
    E = cfg.embd_dim
    return torch.from_numpy(sinusoid_encoding(cfg.max_seq_len, E) / E ** 0.5)


class ConvTransformerBackbone(nn.Module):
    def __init__(self, cfg: ModelConfig, adapt_blocks=()):
        super().__init__()
        self.cfg = cfg
        E, s = cfg.embd_dim, cfg.scale_factor
        n_convs, n_stem, n_branch = (cfg.backbone_arch[0],
                                     cfg.backbone_arch[1],
                                     cfg.backbone_arch[-1])
        block = lambda **kw: TransformerBlock(
            E, cfg.n_head, path_drop=cfg.droppath, proj_drop=cfg.dropout,
            attention_impl=cfg.attention_impl, t_c_alpha=cfg.t_c_alpha, **kw)
        _add_embed(self, "embd", n_convs, cfg.input_dim, E,
                   cfg.embd_kernel_size, cfg.embd_with_ln)
        if cfg.use_cross_modal:
            _add_embed(self, "txt_embd", n_convs, cfg.n_txt_in, E, 1,
                       cfg.embd_with_ln)
            for i in range(n_stem):
                self.add_module(f"txt_stem_{i}", block())
        for i in range(n_stem):
            self.add_module(f"stem_{i}", block())
        self.n_xl = cfg.xl_layers if cfg.use_xl else 0
        for i in range(self.n_xl):
            # each layer draws its own dropout seed from `rng` per call
            self.add_module(f"xl_{i}", XLRelAttention(
                E, cfg.n_head, cfg.xl_d_inner, cfg.xl_dropout))
        if not cfg.use_xl:
            self.pre_branch = block()
        self.cross = [cfg.use_cross_modal
                      and i not in cfg.cross_modal_skip_levels
                      for i in range(n_branch)]
        for i in range(n_branch):
            self.add_module(f"branch_{i}", block(
                n_ds_stride=s, use_cross_modal=self.cross[i],
                adapter_t_in=(cfg.max_seq_len // s ** i if i in adapt_blocks
                              else 0)))
        self.register_buffer("pe", _pe_table(cfg), persistent=False)
        self.n_convs, self.n_stem, self.n_branch = n_convs, n_stem, n_branch

    def forward(self, x, mask, text=None, text_mask=None, rng=None):
        """`text` (B, L, n_txt_in) and `text_mask` (B, L): the text tokens,
        read with `cfg.use_cross_modal` (None: no text tower, no
        cross-attention) and ignored without."""
        x, mask = _embed(self, "embd", self.n_convs, x, mask)
        x = _add_pe(self, x, mask)
        if text is None or not self.cfg.use_cross_modal:
            text = text_mask = None
        else:
            text, text_mask = _embed(self, "txt_embd", self.n_convs, text,
                                     text_mask)
            for i in range(self.n_stem):
                text, text_mask = getattr(self, f"txt_stem_{i}")(
                    text, text_mask, rng)
        for i in range(self.n_stem):
            x, mask = getattr(self, f"stem_{i}")(x, mask, rng)
        feats, masks = [x], [mask]
        if self.cfg.use_xl:
            for i in range(self.n_xl):
                x = getattr(self, f"xl_{i}")(x, mask, rng)
        else:
            x, mask = self.pre_branch(x, mask, rng)
        for i in range(self.n_branch):
            y = (text, text_mask) if self.cross[i] else (None, None)
            x, mask = getattr(self, f"branch_{i}")(x, mask, rng, *y)
            feats.append(x)
            masks.append(mask)
        return feats, masks


class ConvBlock(nn.Module):
    """ResNet-style basic block of masked convs (vilco_tpu/models/
    backbone.py::ConvBlock): conv1 (k taps, stride s, to expansion x E) ->
    ReLU -> conv2 (k taps) + the input (through `downsample`, a strided 1x1
    conv, when s > 1) -> ReLU."""

    def __init__(self, n_embd: int, kernel_size: int = 3,
                 n_ds_stride: int = 1, expansion_factor: int = 2):
        super().__init__()
        E, width = n_embd, n_embd * expansion_factor
        self.conv1 = MaskedConv(E, width, kernel_size, stride=n_ds_stride)
        self.conv2 = MaskedConv(width, E, kernel_size)
        self.downsample = (MaskedConv(E, E, 1, stride=n_ds_stride)
                           if n_ds_stride > 1 else None)

    def forward(self, x, mask):
        out, out_mask = self.conv1(x, mask)
        out, out_mask = self.conv2(torch.relu(out), out_mask)
        identity = x if self.downsample is None else self.downsample(x,
                                                                     mask)[0]
        return torch.relu(out + identity), out_mask


class ConvBackbone(nn.Module):
    """The pure-conv pyramid (`backbone_type` "conv")."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.embd_dim
        self.n_convs, self.n_stem, self.n_branch = (cfg.backbone_arch[0],
                                                    cfg.backbone_arch[1],
                                                    cfg.backbone_arch[-1])
        _add_embed(self, "embd", self.n_convs, cfg.input_dim, E,
                   cfg.embd_kernel_size, cfg.embd_with_ln)
        for i in range(self.n_stem):
            self.add_module(f"stem_{i}", ConvBlock(E, 3, 1))
        for i in range(self.n_branch):
            self.add_module(f"branch_{i}", ConvBlock(E, 3, cfg.scale_factor))

    def forward(self, x, mask, text=None, text_mask=None, rng=None):
        """The text is not read, as in JAX."""
        x, mask = _embed(self, "embd", self.n_convs, x, mask)
        for i in range(self.n_stem):
            x, mask = getattr(self, f"stem_{i}")(x, mask)
        feats, masks = [x], [mask]
        for i in range(self.n_branch):
            x, mask = getattr(self, f"branch_{i}")(x, mask)
            feats.append(x)
            masks.append(mask)
        return feats, masks


class DualTowerBackbone(nn.Module):
    """The NLQ dual tower. The text stem attends densely (window -1); every
    video block attends within the band of half width cfg.window."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        E, H, win, dp = cfg.embd_dim, cfg.n_head, cfg.window, cfg.droppath
        (self.n_convs, self.n_txt_stem, self.n_vid_stem, self.n_cross,
         _) = cfg.backbone_arch
        self.n_branch = cfg.num_branch_layers
        block = lambda **kw: TransformerBlock(
            E, H, path_drop=dp, proj_drop=cfg.dropout,
            use_channel_attn=False, **kw)
        _add_embed(self, "vid_embd", self.n_convs, cfg.input_dim, E,
                   cfg.embd_kernel_size, cfg.embd_with_ln)
        _add_embed(self, "txt_embd", self.n_convs, cfg.n_txt_in, E, 1,
                   cfg.embd_with_ln)
        for i in range(self.n_txt_stem):
            self.add_module(f"txt_stem_{i}", block(window=-1))
        for i in range(self.n_vid_stem):
            self.add_module(f"vid_stem_{i}", block(window=win,
                                                   use_cross_modal=True))
        for i in range(self.n_branch):
            self.add_module(f"branch_{i}", block(
                n_ds_stride=cfg.scale_factor, window=win,
                use_cross_modal=i < self.n_cross))
        self.register_buffer("pe", _pe_table(cfg), persistent=False)

    def forward(self, x, mask, text, text_mask, rng=None):
        x, mask = _embed(self, "vid_embd", self.n_convs, x, mask)
        x = _add_pe(self, x, mask)
        text, text_mask = _embed(self, "txt_embd", self.n_convs, text,
                                 text_mask)
        for i in range(self.n_txt_stem):
            text, text_mask = getattr(self, f"txt_stem_{i}")(text, text_mask,
                                                             rng)
        for i in range(self.n_vid_stem):
            x, mask = getattr(self, f"vid_stem_{i}")(x, mask, rng, text,
                                                     text_mask)
        feats, masks = [x], [mask]
        for i in range(self.n_branch):
            y = (text, text_mask) if i < self.n_cross else (None, None)
            x, mask = getattr(self, f"branch_{i}")(x, mask, rng, *y)
            feats.append(x)
            masks.append(mask)
        return feats, masks
