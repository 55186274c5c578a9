"""The VQ ClipMatcher (vilco_tpu/models/clip_matcher.py): frozen ViT features
of the query crop and of every clip frame -> channel reduce -> query/frame
cross-attention -> spatial downsample to R x R -> spatio-temporal
self-attention over (T x R x R) tokens with a +-w frame band -> anchor head
(12 anchors a cell on the anchor grid): bbox deltas and occupancy logits.

Layouts follow the JAX model at the module boundaries (channels-last frames
and grids, (B, L, C) tokens); the conv stack runs NCHW inside. The forward
computes in `compute_dtype` (bf16 on the serving and training paths) with
f32 master parameters, the norms in f32, and f32 outputs. The dense
attentions (ViT, query/frame) run through kernels/attention.py (the ViT on
K1, or on K1f with `cfg.vit_attn_impl="flash"`), the frame-banded one
through kernels/frame_band.py, the ViT's MLP optionally through
kernels/mlp.py. Parameter names follow the Flax tree (models/convert.py
maps it).

The reference's own checkpoints (models/torch_import.py) run in its
geometry: `norm="frozen_bn"` (each conv block's BatchNorm in eval mode on
imported running statistics, which are buffers here), `interp_feat_to`
(the ViT's patch grid resized to S x S, bilinear with antialiasing, as
JAX's jax.image.resize) and `vit_final_norm=False` (the MAE ViT's tokens
taken without the final LayerNorm). With `cfg.use_query_roi` a given
query-frame box resamples the query's features onto it
(ops/roi_align.py).

Under data parallelism (`dp`, parallel/mesh.py::DataParallel) a rank holds
its clips and queries of the global batch; HNM pairs its clips with EVERY
query of the global batch, gathered after the channel reduce by an
autograd-aware gather (the backward sums the ranks' gradients of each
query), clip index slowest, so that the rank's pairs are a contiguous
block of JAX's global pair list, and the head's dropout draws the global
pair list's masks (each rank its rows).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vilco_tpu_torch.core.config import VQConfig
from vilco_tpu_torch.core.marks import mark
from vilco_tpu_torch.kernels.attention import fused_attention_blc
from vilco_tpu_torch.kernels.frame_band import frame_band_attention
from vilco_tpu_torch.models.layers import LayerNorm, Linear, _dropout
from vilco_tpu_torch.models.vit import LN_EPS, ViT, Conv2dSame
from vilco_tpu_torch.ops.activations import gelu
from vilco_tpu_torch.ops.anchors import generate_anchors, xyhw_to_xyxy
from vilco_tpu_torch.ops.masked import wide
from vilco_tpu_torch.ops.roi_align import roi_align_2d
from vilco_tpu_torch.parallel.mesh import RowDraw

N_ANCHORS = 12       # 4 base sizes x 3 aspect ratios
CQ_HEADS = 4         # the query/frame decoder layer
ST_HEADS = 8         # the spatio-temporal encoder layers
LEAKY_SLOPE = 0.01   # Flax's leaky_relu
BN_EPS = 1e-5        # torch's BatchNorm2d epsilon
NORMS = ("group", "frozen_bn")


def positional_encoding_3d(d_model: int, depth: int, height: int,
                           width: int) -> np.ndarray:
    """(t, h, w, C) sinusoids, the channels split across the three axes."""
    pe = np.zeros((depth, height, width, d_model), np.float32)
    d = d_model // 3
    d -= d % 2

    def table(n, dims):
        pos = np.arange(n)[:, None]
        div = np.exp(np.arange(0, dims, 2) * -(math.log(10000.0) / dims))
        out = np.zeros((n, dims), np.float32)
        out[:, 0::2] = np.sin(pos * div)
        out[:, 1::2] = np.cos(pos * div)
        return out

    pe[..., :d] += table(depth, d)[:, None, None, :]
    pe[..., d:2 * d] += table(height, d)[None, :, None, :]
    pe[..., 2 * d:3 * d] += table(width, d)[None, None, :, :]
    return pe


class ConvBlock2D(nn.Module):
    """3x3 'SAME' conv + norm + leaky ReLU, on NCHW. `norm` "group":
    GroupNorm(min(32, C), eps 1e-6, in f32, cast back); "frozen_bn": torch's
    eval-mode BatchNorm2d, the parameters `bn_scale` and `bn_bias` and the
    running statistics `bn_mean` and `bn_var` (buffers: no gradient, no
    optimizer state, in the state_dict under JAX's leaf names) folded into
    one multiply-add in f32 (eps 1e-5), cast back."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r}: one of {NORMS}")
        self.conv = Conv2dSame(cin, features, 3, stride)
        self.groups = min(32, features)
        if norm == "group":
            self.norm = nn.GroupNorm(self.groups, features, eps=LN_EPS)
        else:
            self.norm = None
            self.bn_scale = nn.Parameter(torch.ones(features))
            self.bn_bias = nn.Parameter(torch.zeros(features))
            self.register_buffer("bn_mean", torch.zeros(features))
            self.register_buffer("bn_var", torch.ones(features))

    def forward(self, x):
        dt = x.dtype
        x = self.conv(x)
        if self.norm is not None:
            x = F.group_norm(x.float(), self.groups,
                             self.norm.weight.float(),
                             self.norm.bias.float(), LN_EPS).to(dt)
        else:
            mult = self.bn_scale * torch.rsqrt(self.bn_var + BN_EPS)
            shift = self.bn_bias - self.bn_mean * mult
            x = (x.float() * mult[:, None, None]
                 + shift[:, None, None]).to(dt)
        return F.leaky_relu(x, LEAKY_SLOPE)


class DecoderLayer(nn.Module):
    """Post-LN self-attention + cross-attention + GELU FFN (separate q/k/v
    projections; both attentions dense, through the fused kernel)."""

    def __init__(self, dim: int, num_heads: int, ff: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("self", "cross"):
            for p in "qkvo":
                self.add_module(f"{name}_{p}", Linear(dim, dim))
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", LayerNorm(dim, eps=LN_EPS))
        self.ff1 = Linear(dim, ff)
        self.ff2 = Linear(ff, dim)

    def _attn(self, name, q_in, kv_in):
        proj = lambda p, t: getattr(self, f"{name}_{p}")(t)
        kv_mask = torch.ones(kv_in.shape[:2], dtype=torch.bool,
                             device=kv_in.device)
        o = fused_attention_blc(proj("q", q_in), proj("k", kv_in),
                                proj("v", kv_in), kv_mask, self.num_heads)
        return proj("o", o)

    def forward(self, x, mem):
        x = self.norm1(x + self._attn("self", x, x))
        x = self.norm2(x + self._attn("cross", x, mem))
        return self.norm3(x + self.ff2(gelu(self.ff1(x))))


class EncoderLayer(nn.Module):
    """Post-LN frame-banded self-attention (one fused (C, 3C) qkv
    projection) + GELU FFN; `fr` tokens a frame, `band_w` frames each
    side."""

    def __init__(self, dim: int, num_heads: int, ff: int, fr: int,
                 band_w: int):
        super().__init__()
        self.num_heads, self.fr, self.band_w = num_heads, fr, band_w
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.ff1 = Linear(dim, ff)
        self.ff2 = Linear(ff, dim)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        C = x.shape[-1]
        w, b = self.qkv.weight.to(x.dtype), self.qkv.bias.to(x.dtype)
        q, k, v = (F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
                   for i in range(3))
        o = frame_band_attention(q, k, v, self.num_heads, self.fr,
                                 self.band_w)
        x = self.norm1(x + self.proj(o))
        return self.norm2(x + self.ff2(gelu(self.ff1(x))))


class AnchorHead(nn.Module):
    """Upsample R -> the anchor grid (transposed 4x4 stride-2 convs), split
    into reg and cls towers (dropout, 3 conv blocks each), then per-anchor
    bbox deltas (B, h*w*12, 4) and occupancy logits (B, h*w*12)."""

    def __init__(self, dim: int, in_res: int, out_res: int,
                 dropout: float = 0.2, norm: str = "group"):
        super().__init__()
        self.dim, self.dropout = dim, dropout
        self.n_up = int(math.log2(out_res // in_res))
        for i in range(self.n_up):
            self.add_module(f"up_{i}", nn.ConvTranspose2d(dim, dim, 4, 2, 1))
        self.in_conv = ConvBlock2D(dim, 2 * dim, norm=norm)
        for i in range(3):
            self.add_module(f"reg_{i}", ConvBlock2D(dim, dim, norm=norm))
            self.add_module(f"cls_{i}", ConvBlock2D(dim, dim, norm=norm))
        self.reg_head = Conv2dSame(dim, N_ANCHORS * 4, 3)
        self.cls_head = Conv2dSame(dim, N_ANCHORS, 3)

    def forward(self, x, rng=None):
        for i in range(self.n_up):
            up = getattr(self, f"up_{i}")
            x = F.conv_transpose2d(x, up.weight.to(x.dtype),
                                   up.bias.to(x.dtype), stride=2, padding=1)
        feat_reg, feat_cls = self.in_conv(x).split(self.dim, dim=1)
        feat_reg = _dropout(feat_reg, self.dropout, rng)
        feat_cls = _dropout(feat_cls, self.dropout, rng)
        for i in range(3):
            feat_reg = getattr(self, f"reg_{i}")(feat_reg)
            feat_cls = getattr(self, f"cls_{i}")(feat_cls)
        out_reg = self.reg_head(feat_reg).permute(0, 2, 3, 1)
        out_cls = self.cls_head(feat_cls).permute(0, 2, 3, 1)
        B = out_reg.shape[0]
        return out_reg.reshape(B, -1, 4), out_cls.reshape(B, -1)


def frozen_bn_stats(model: nn.Module):
    """[(name, buffer)] of the frozen-BN running statistics (`bn_mean`,
    `bn_var`) of `model`, in state_dict order."""
    return [(n, b) for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in ("bn_mean", "bn_var")]


def init_clip_matcher_(model: "ClipMatcher",
                       generator: torch.Generator) -> None:
    """Random init from `generator` with Flax's initializers: LeCun-normal
    conv and dense kernels with zero biases, N(0, 0.02) for the ViT's CLS
    token and position table, N(0, 1e-6) for the two output convs' kernels
    and biases; norms keep ones and zeros, pe_3d its sinusoid table."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                w = m.weight           # (in, out, kh, kw)
                normal_(w, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                normal_(w, (w[0].numel()) ** -0.5)
                m.bias.zero_()
        normal_(model.backbone.cls_token, 0.02)
        normal_(model.backbone.pos_embed, 0.02)
        for m in (model.head.reg_head, model.head.cls_head):
            normal_(m.weight, 1e-6)
            normal_(m.bias, 1e-6)


class ClipMatcher(nn.Module):
    """The VQ meta-arch of `cfg` (a VQConfig). Parameters are drawn in f32
    from the CPU `generator` (seed 0 if None), then placed on `device` (the
    card unless the caller asks for the CPU; no card raises); they stay f32
    masters, and the forward computes in `compute_dtype` (bf16 unless
    asked otherwise, as the JAX model's default). With
    `cfg.freeze_backbone` the ViT's parameters take no gradient and its
    forward (and the grid resize) runs under no_grad. `norm`,
    `interp_feat_to` and `vit_final_norm` are the JAX model's fields of
    the same names (module docstring), which JAX's vq config section does
    not carry either: the grid resize to interp_feat_to x interp_feat_to
    also sets the number of stride-2 down heads to R."""

    def __init__(self, cfg: VQConfig, use_fused_mlp: bool = False,
                 generator: torch.Generator | None = None, device="cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm: str = "group", interp_feat_to: int | None = None,
                 vit_final_norm: bool = True):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.norm, self.interp_feat_to = norm, interp_feat_to
        dim, R = cfg.dim, cfg.resolution_transformer
        self.backbone = ViT(cfg.patch_size, cfg.vit_dim, cfg.vit_depth,
                            cfg.vit_heads, cfg.clip_size, use_fused_mlp,
                            cfg.vit_attn_impl, final_norm=vit_final_norm)
        self.reduce1 = ConvBlock2D(cfg.vit_dim, dim, norm=norm)
        self.reduce2 = ConvBlock2D(dim, dim, norm=norm)
        self.cq_corr = DecoderLayer(dim, CQ_HEADS, 4 * dim)
        feat_res = interp_feat_to or cfg.clip_size // cfg.patch_size
        self.n_down = max(0, int(math.log2(max(feat_res // R, 1))))
        for i in range(self.n_down):
            self.add_module(f"down_{i}", ConvBlock2D(dim, dim, stride=2,
                                                     norm=norm))
        for i in range(cfg.num_transformer):
            self.add_module(f"st_{i}", EncoderLayer(
                dim, ST_HEADS, 8 * dim, fr=R * R,
                band_w=cfg.window_transformer // 2))
        self.head = AnchorHead(dim, R, cfg.resolution_anchor_feat,
                               cfg.dropout, norm)
        anchors = generate_anchors(cfg.clip_size, cfg.resolution_anchor_feat)
        xyhw = anchors / cfg.clip_size
        self.register_buffer("anchors_xyhw", torch.from_numpy(xyhw),
                             persistent=False)
        self.register_buffer("anchors_xyxy",
                             torch.from_numpy(xyhw_to_xyxy(xyhw)),
                             persistent=False)
        pe = positional_encoding_3d(dim, cfg.num_frames, R, R)
        self.pe_3d = nn.Parameter(torch.from_numpy(pe.reshape(1, -1, dim)))
        init_clip_matcher_(self, generator if generator is not None
                           else torch.Generator().manual_seed(0))
        if cfg.freeze_backbone:
            self.backbone.requires_grad_(False)
        self.to(device)

    def extract(self, images):
        """Frames (N, H, W, 3) -> ViT patch grid (N, h, w, vit_dim), resized
        to interp_feat_to x interp_feat_to if set (in f32 or wider, cast
        back), with no gradient when the backbone is frozen."""
        with (torch.no_grad() if self.cfg.freeze_backbone
              else contextlib.nullcontext()):
            feats = self.backbone(images)
            if self.interp_feat_to:
                S = self.interp_feat_to
                feats = F.interpolate(
                    wide(feats.permute(0, 3, 1, 2)), size=(S, S),
                    mode="bilinear", align_corners=False, antialias=True,
                ).to(feats.dtype).permute(0, 2, 3, 1)
        return feats

    def query_roi(self, query_feat, query_frame_bbox, h: int, w: int):
        """The query's grid (B, h', w', C) resampled onto its query-frame
        box (B, 4; normalized xyxy) scaled to the clip's (h, w) grid, back
        to (h, w) by roi_align_2d in f32."""
        qb = query_frame_bbox.float()
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=qb.device)
        rois = torch.cat([torch.arange(qb.shape[0], dtype=torch.float32,
                                       device=qb.device)[:, None],
                          qb * scale], 1)
        return roi_align_2d(query_feat.float(), rois, (h, w)).to(
            query_feat.dtype)

    def match(self, clip_feat, query_feat, B: int, T: int, hnm: bool = False,
              rng=None, query_frame_bbox=None, dp=None):
        """Patch grids of the B*T clip frames (B*T, h, w, C) and the B
        queries (B, h, w, C) -> the output dict. hnm pairs every clip i with
        every query j (clip index slowest): B*B outputs; under `dp` the
        rank's B clips with the global batch's B x world queries. With
        `cfg.use_query_roi`, a `query_frame_bbox` (B, 4) resamples the
        queries' grids first (`query_roi`)."""
        dim, R = self.cfg.dim, self.cfg.resolution_transformer
        h, w = clip_feat.shape[1:3]
        if self.cfg.use_query_roi and query_frame_bbox is not None:
            query_feat = self.query_roi(query_feat, query_frame_bbox, h, w)
        reduce = lambda x: self.reduce2(self.reduce1(x.permute(0, 3, 1, 2)))
        cf, qf = reduce(clip_feat), reduce(query_feat)      # NCHW
        if hnm:
            if dp is not None:
                qf = dp.gather(qf)
            Bq = qf.shape[0]
            i_idx = torch.arange(B, device=cf.device).repeat_interleave(Bq)
            j_idx = torch.arange(Bq, device=cf.device).repeat(B)
            cf = cf.reshape(B, T, dim, h, w)[i_idx].reshape(B * Bq * T, dim,
                                                            h, w)
            qf = qf[j_idx]
            B = B * Bq
            if isinstance(rng, RowDraw):
                rng = rng.rows_of(Bq)
        tokens = lambda x: x.flatten(2).transpose(1, 2)     # (n, h*w, C)
        q_tokens = tokens(qf)[:, None].expand(B, T, h * w, dim).reshape(
            B * T, h * w, dim)
        c_tokens = self.cq_corr(tokens(cf).contiguous(), q_tokens)
        x = c_tokens.transpose(1, 2).reshape(B * T, dim, h, w)
        for i in range(self.n_down):
            x = getattr(self, f"down_{i}")(x)
        x = tokens(x).reshape(B, T * R * R, dim)
        x = x + self.pe_3d[:, :T * R * R].to(x.dtype)
        for i in range(self.cfg.num_transformer):
            x = getattr(self, f"st_{i}")(x)
        x = x.reshape(B * T, R, R, dim).permute(0, 3, 1, 2)
        if isinstance(rng, RowDraw):
            rng = rng.rows_of(T)        # the head's rows: pairs x frames
        bbox_delta, prob = self.head(x, rng)
        N = bbox_delta.shape[1]
        bbox_delta = bbox_delta.reshape(B, T, N, 4).float()
        prob = prob.reshape(B, T, N).float()
        refine = bbox_delta + self.anchors_xyhw[None, None]
        center, hw = refine[..., :2], 0.5 * refine[..., 2:]
        return {"center": center, "hw": hw,
                "bbox": torch.cat([center - hw, center + hw], -1),
                "prob": prob, "anchors_xyxy": self.anchors_xyxy}

    def forward(self, clip, query, from_features: bool = False,
                hnm: bool = False, rng=None, marks=None,
                query_frame_bbox=None, dp=None):
        """clip (B, T, H, W, 3) frames or (B, T, h, w, C) features; query
        (B, H, W, 3) or (B, h, w, C). `rng` (a torch.Generator on the
        inputs' device) switches on the head's dropout in training mode.
        `marks`, if a list, receives ("vit", mark) between the backbone and
        the matcher. `query_frame_bbox` (B, 4), the queries' boxes in
        normalized xyxy, is read with `cfg.use_query_roi`. `dp`: a
        data-parallel rank's place (module docstring), `rng` then a
        RowDraw over the global batch's clips."""
        dt = self.compute_dtype
        B, T = clip.shape[:2]
        clip = clip.to(dt).reshape((B * T,) + tuple(clip.shape[2:]))
        query = query.to(dt)
        if not from_features:
            clip, query = self.extract(clip), self.extract(query)
        mark(marks, "vit", clip.device)
        return self.match(clip, query, B, T, hnm,
                          rng if self.training else None, query_frame_bbox,
                          dp)
