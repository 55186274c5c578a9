"""Point-transformer meta-arch, MQ and NLQ serving and training paths
(vilco_tpu/models/point_transformer.py).

backbone (MQ: ConvTransformerBackbone; NLQ: DualTowerBackbone, which takes
the query text) -> identity neck (per-level LayerNorm) -> shared cls head
and reg head, each run once over all levels concatenated with zero gaps.
Returns the same keys as the JAX model's forward: `cls_logits` (B, P, C)
f32, `offsets` (B, P, 2) f32, `fpn_mask` (B, P), `level_lengths`,
`fpn_feats`, and `gaussians`: for MQ the six learnable per-class (C,)
parameters that weight the training losses, for NLQ None (the NLQ model
has no such parameters).

The CL extras of `cl` (core/config.py::CLCfg), as the MQ yaml runs them:
with `prompt_pool` the L2P pool (cl/prompt.py) prepends its prompts to the
raw text tokens, their positions valid, and the forward returns
`reduce_sim`; with `narration_ssl` and narration given, a Linear encoder
(in f32, as Flax promotes the bf16 tokens against its f32 kernel) and a
masked mean give the l2-normalised `narration_feat` (B, E), the mean over
levels of the neck features' masked means gives `video_feat`, and
`narration_valid` is passed through (all True when not given); with
`use_adapt` the branch blocks of `adapt_blocks` carry time adapters
(models/backbone.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from vilco_tpu_torch.cl.prompt import PromptPool
from vilco_tpu_torch.core.config import CLCfg, ModelConfig
from vilco_tpu_torch.models.backbone import (
    ConvTransformerBackbone,
    DualTowerBackbone,
)
from vilco_tpu_torch.models.layers import (
    LayerNormC,
    Linear,
    MaskedConv,
    Scale,
    init_weights_,
)
from vilco_tpu_torch.ops.masked import l2_normalize, masked_mean, wide

HEAD_KERNEL_SIZE = 3
HEAD_NUM_LAYERS = 3
CLS_PRIOR_PROB = 0.01
CLS_PRIOR_BIAS = -math.log((1 - CLS_PRIOR_PROB) / CLS_PRIOR_PROB)
# the MQ variant's learnable per-class Gaussians and their first values
GAUSSIAN_INIT = (("mu", 0.0), ("sigma", 1.0), ("mu_reg_left", -0.5),
                 ("sigma_reg_left", 1.0), ("mu_reg_right", 0.5),
                 ("sigma_reg_right", 1.0))


class FPNIdentity(nn.Module):
    """Per-level channel LayerNorm."""

    def __init__(self, c: int, n_levels: int):
        super().__init__()
        for i in range(n_levels):
            self.add_module(f"norm_{i}", LayerNormC(c))

    def forward(self, feats, masks):
        return [getattr(self, f"norm_{i}")(f)
                for i, f in enumerate(feats)], masks


def _concat_levels(feats, masks, gap: int):
    """Concatenate per-level (B, T_l, C) along time with `gap` zero,
    masked-off positions between levels. Returns (feats, mask, gap_keep,
    level_slices); gap_keep is False only at the gaps."""
    B, _, C = feats[0].shape
    dev, dt = feats[0].device, feats[0].dtype
    z = torch.zeros((B, gap, C), dtype=dt, device=dev)
    zm = torch.zeros((B, gap), dtype=torch.bool, device=dev)
    parts_f, parts_m, parts_k, slices = [], [], [], []
    off = 0
    for i, (f, m) in enumerate(zip(feats, masks)):
        if i:
            parts_f.append(z)
            parts_m.append(zm)
            parts_k.append(zm)
            off += gap
        T = f.shape[1]
        parts_f.append(f)
        parts_m.append(m)
        parts_k.append(torch.ones((B, T), dtype=torch.bool, device=dev))
        slices.append((off, T))
        off += T
    return (torch.cat(parts_f, 1), torch.cat(parts_m, 1),
            torch.cat(parts_k, 1), slices)


class _Head(nn.Module):
    """(HEAD_NUM_LAYERS - 1) x [masked conv + LN + ReLU, gaps re-zeroed]
    over the concatenated levels."""

    def __init__(self, cin: int, feat_dim: int):
        super().__init__()
        self.n = HEAD_NUM_LAYERS - 1
        for i in range(self.n):
            self.add_module(f"head_{i}", MaskedConv(
                cin if i == 0 else feat_dim, feat_dim, HEAD_KERNEL_SIZE,
                bias=False))
            self.add_module(f"norm_{i}", LayerNormC(feat_dim))

    def trunk(self, feats, masks):
        h, m, keep, slices = _concat_levels(feats, masks,
                                            HEAD_KERNEL_SIZE // 2)
        kf = keep[..., None].to(h.dtype)
        for i in range(self.n):
            h, _ = getattr(self, f"head_{i}")(h, m)
            h = torch.relu(getattr(self, f"norm_{i}")(h)) * kf
        return h, m, slices


class ClsHead(_Head):
    def __init__(self, cin: int, feat_dim: int, num_classes: int):
        super().__init__(cin, feat_dim)
        self.cls = MaskedConv(feat_dim, num_classes, HEAD_KERNEL_SIZE,
                              bias_init=CLS_PRIOR_BIAS)

    def forward(self, feats, masks):
        h, m, slices = self.trunk(feats, masks)
        logits, _ = self.cls(h, m)
        return [logits[:, o:o + T] for o, T in slices]


class RegHead(_Head):
    def __init__(self, cin: int, feat_dim: int, num_levels: int):
        super().__init__(cin, feat_dim)
        self.offset = MaskedConv(feat_dim, 2, HEAD_KERNEL_SIZE)
        for l in range(num_levels):
            self.add_module(f"scale_{l}", Scale())

    def forward(self, feats, masks):
        h, m, slices = self.trunk(feats, masks)
        offsets, _ = self.offset(h, m)
        return [torch.relu(getattr(self, f"scale_{l}")(offsets[:, o:o + T]))
                for l, (o, T) in enumerate(slices)]


class PointTransformer(nn.Module):
    """The meta-arch, variant `cfg.variant` ("mq" or "nlq"), with the CL
    extras of `cl` (None: the naive method, none of them; the MQ variant
    only). Parameters are drawn in f32 from the CPU `generator` (seed 0 if
    None), then placed on `device` (the card unless the caller asks for
    the CPU; no card raises). The forward computes in `compute_dtype`
    (default: the parameters' dtype), casting f32 master parameters on use
    as the JAX model does; `.to(device, torch.bfloat16)` gives the serving
    path's bf16 model."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None,
                 device="cuda", cl: CLCfg | None = None):
        super().__init__()
        if cfg.variant not in ("mq", "nlq"):
            raise ValueError(f"variant {cfg.variant!r}: 'mq' or 'nlq'")
        cl = cl or CLCfg()
        if cfg.variant == "nlq" and (cl.prompt_pool or cl.narration_ssl
                                     or cl.use_adapt):
            raise NotImplementedError("the NLQ model takes no CL extras")
        self.cfg, self.cl = cfg, cl
        n_levels = cfg.num_branch_layers + 1
        self.prompt = (PromptPool(cl.pool_size, cl.length, cl.embed_dim,
                                  cl.topk) if cl.prompt_pool else None)
        self.backbone = (DualTowerBackbone(cfg) if cfg.variant == "nlq"
                         else ConvTransformerBackbone(
                             cfg, cl.adapt_blocks if cl.use_adapt else ()))
        self.narration_encoder = (Linear(cl.narration_dim, cfg.embd_dim)
                                  if cl.narration_ssl else None)
        self.neck = FPNIdentity(cfg.fpn_dim, n_levels)
        self.cls_head = ClsHead(cfg.fpn_dim, cfg.head_dim, cfg.num_classes)
        self.reg_head = RegHead(cfg.fpn_dim, cfg.head_dim, n_levels)
        if cfg.variant == "mq":
            # learnable per-class Gaussians for label weighting in training
            C = cfg.num_classes
            for name, v in GAUSSIAN_INIT:
                self.register_parameter(name,
                                        nn.Parameter(torch.full((C,), v)))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)
        self.to(device)

    def forward(self, feats, mask, text=None, text_mask=None, narration=None,
                narration_mask=None, narration_valid=None, prompt_mask=None,
                rng=None, compute_dtype=None):
        """`text` (B, L, n_txt_in) and `text_mask` (B, L): the NLQ query or
        the MQ clip's text; `narration` (B, Ln, narration_dim),
        `narration_mask` (B, Ln) and `narration_valid` (B,): the SSL
        inputs; `prompt_mask` (B, top_k): the task's prompt ids; `rng` (a
        torch.Generator on the card or CPU of the inputs) switches on
        drop-path and the dropouts in training mode."""
        dt = compute_dtype or next(self.parameters()).dtype
        feats = feats.to(dt)
        text = None if text is None else text.to(dt)
        rng = rng if self.training else None
        out = {}
        if self.prompt is not None and text is not None:
            text, out["reduce_sim"], _ = self.prompt(text, prompt_mask)
            if text_mask is not None:
                text_mask = torch.cat([torch.ones(
                    (text.shape[0], self.prompt.total_prompt_len),
                    dtype=torch.bool, device=text_mask.device), text_mask], 1)
        if self.cfg.variant == "nlq":
            if text is None or text_mask is None:
                raise ValueError("the NLQ model needs text and text_mask")
            bb_feats, bb_masks = self.backbone(feats, mask, text, text_mask,
                                               rng)
            gaussians = None
        else:
            bb_feats, bb_masks = self.backbone(feats, mask, text, text_mask,
                                               rng)
            gaussians = (self.mu, self.sigma, self.mu_reg_left,
                         self.sigma_reg_left, self.mu_reg_right,
                         self.sigma_reg_right)
        fpn_feats, fpn_masks = self.neck(bb_feats, bb_masks)
        if self.narration_encoder is not None and narration is not None:
            nar = self.narration_encoder(wide(narration.to(dt)))
            out["narration_feat"] = l2_normalize(
                masked_mean(nar, narration_mask, 1), 1)
            vids = [masked_mean(wide(f), m, 1)
                    for f, m in zip(fpn_feats, fpn_masks)]
            out["video_feat"] = l2_normalize(torch.stack(vids).mean(0), 1)
            out["narration_valid"] = (
                narration_valid if narration_valid is not None
                else torch.ones(feats.shape[0], dtype=torch.bool,
                                device=feats.device))
        cls_list = self.cls_head(fpn_feats, fpn_masks)
        reg_list = self.reg_head(fpn_feats, fpn_masks)
        return {**out,
            "level_lengths": tuple(f.shape[1] for f in fpn_feats),
            "cls_logits": torch.cat([wide(c) for c in cls_list], 1),
            "offsets": torch.cat([wide(r) for r in reg_list], 1),
            "fpn_mask": torch.cat(fpn_masks, 1),
            "fpn_feats": fpn_feats,
            "gaussians": gaussians,
        }


def level_lengths(cfg: ModelConfig) -> Tuple[int, ...]:
    return tuple(cfg.max_seq_len // s for s in cfg.fpn_strides)
