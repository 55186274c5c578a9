"""Load the reference's own PyTorch state_dicts into the port's models
(vilco_tpu/models/torch_import.py): the MQ PtTransformer
(MQ/libs/modeling/meta_archs.py), the NLQ PtTransformer with its dual-tower
backbone (NLQ/libs/modeling/meta_archs.py, backbones.py) and the VQ
ClipMatcher (VQ/model/corr_clip_spatial_transformer2_anchor_2heads_hnm.py).

Both sides are PyTorch, so the map is a rename of each leaf of the port's
state_dict onto a reference key, plus one of a few reshapes (`RESHAPES`):

  as_is     the same tensor (Conv1d, Conv2d, Linear, LayerNorm, the XL
            q/k/v/r/o (C, H, D), BatchNorm, the ViT's tokens, pe_3d; a
            ConvTranspose2d as well: the port keeps torch's layout)
  channel   a channel LayerNorm's (1, C, 1) -> (C,)
  drop_path an AffineDropPath scale (1, C, 1) -> (1, 1, C)
  conv1x1   a 1x1 Conv1d (Cout, Cin, 1) -> Linear (Cout, Cin)
  column    the MQ label Gaussians (C, 1) -> (C,)
  scalar    a Scale's one value -> ()
  third_i   row third i of a packed nn.MultiheadAttention in_proj (3C, ...)
            -> the port's separate q, k or v projection (C, ...)

The rules are built from the model's configuration, and the load is
strict: a leaf of the port without a rule, a rule for a leaf the port does
not have, a reference key missing from the state_dict or a shape that does
not match raises, naming the leaf or the key. The state_dict's other keys
are not read, as in JAX: the ViT's final norm on the MAE path, the VQ
model's query_down_heads and its down heads past R, BatchNorm's
num_batches_tracked. What the reference shares, the port maps from one
key: with `use_xl` off the backbone re-applies stem.0 before the branch
(the port's `pre_branch` is loaded from stem.0), and a block's
drop_path_attn scales both its attention and cross-attention residuals in
both. The NLQ reference has no label Gaussians, and neither NLQ model
has any (JAX's importer lists them as leaves allowed to be missing).

`vit_rules` is the one map of the timm ViT names: the ClipMatcher's
backbone and models/vit.py::load_torch_vit_checkpoint both load through it.

`reference_shapes` gives the reference keys a model's rules read, with
their shapes, so that a seeded state_dict of the reference's names can be
drawn without a checkpoint file.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

Rules = Dict[str, Tuple[str, str]]    # port leaf -> (reference key, reshape)

RESHAPES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "as_is": lambda w: w,
    "channel": lambda w: w.reshape(-1),
    "drop_path": lambda w: w.transpose(1, 2),
    "conv1x1": lambda w: w[..., 0],
    "column": lambda w: w.reshape(-1),
    "scalar": lambda w: w.reshape(()),
    **{f"third_{i}": (lambda i: lambda w: w.chunk(3, 0)[i])(i)
       for i in range(3)},
}

# the reference shape of a port leaf of shape s under each reshape
_REFERENCE_SHAPE: Dict[str, Callable[[tuple], tuple]] = {
    "as_is": lambda s: s,
    "channel": lambda s: (1, s[0], 1),
    "drop_path": lambda s: (1, s[2], 1),
    "conv1x1": lambda s: s + (1,),
    "column": lambda s: s + (1,),
    "scalar": lambda s: (),
    **{f"third_{i}": lambda s: (3 * s[0],) + s[1:] for i in range(3)},
}


def _prefix(rules: Rules, ours: str) -> Rules:
    return {f"{ours}.{k}": v for k, v in rules.items()}


def _masked_conv(ours: str, ref: str, bias: bool) -> Rules:
    r = {f"{ours}.weight": (f"{ref}.conv.weight", "as_is")}
    if bias:
        r[f"{ours}.bias"] = (f"{ref}.conv.bias", "as_is")
    return r


def _channel_ln(ours: str, ref: str) -> Rules:
    return {f"{ours}.weight": (f"{ref}.weight", "channel"),
            f"{ours}.bias": (f"{ref}.bias", "channel")}


def _same(ours: str, ref: str, leaves=("weight", "bias")) -> Rules:
    return {f"{ours}.{n}": (f"{ref}.{n}", "as_is") for n in leaves}


def block_rules(ref: str, cross: bool, channel: bool,
                drop_path: bool) -> Rules:
    """A TransformerBlock (models/layers.py) <- the reference block at
    `ref`: the conv attention, with `cross` the text cross-attention and
    its LayerNorm, with `drop_path` the two AffineDropPath scales, with
    `channel` the channel-attention block (whose unused norm1 is not
    read)."""
    r: Rules = {}
    for ln in ("ln1", "ln2") + (("ln3",) if cross else ()):
        r.update(_channel_ln(ln, f"{ref}.{ln}"))
    for n in ("query", "key", "value"):
        r[f"attn.{n}_conv.weight"] = (f"{ref}.attn.{n}_conv.conv.weight",
                                      "as_is")
        r.update(_channel_ln(f"attn.{n}_norm", f"{ref}.attn.{n}_norm"))
    for n in ("query", "key", "value", "proj"):
        r[f"attn.{n}.weight"] = (f"{ref}.attn.{n}.weight", "conv1x1")
        r[f"attn.{n}.bias"] = (f"{ref}.attn.{n}.bias", "as_is")
        if cross:
            r[f"cross_attn.{n}.weight"] = (f"{ref}.cross_attn.{n}.weight",
                                           "conv1x1")
            r[f"cross_attn.{n}.bias"] = (f"{ref}.cross_attn.{n}.bias",
                                         "as_is")
    # the FFN: Sequential(Conv1d, GELU, Dropout, Conv1d, Dropout)
    for ours, i in (("mlp_fc1", 0), ("mlp_fc2", 3)):
        r[f"{ours}.weight"] = (f"{ref}.mlp.{i}.weight", "conv1x1")
        r[f"{ours}.bias"] = (f"{ref}.mlp.{i}.bias", "as_is")
    if drop_path:
        for n in ("drop_path_attn", "drop_path_mlp"):
            r[f"{n}.scale"] = (f"{ref}.{n}.scale", "drop_path")
    if channel:
        c = f"{ref}.channel_attn"
        r["channel_attn.qkv.weight"] = (f"{c}.attn.qkv.weight", "as_is")
        r.update(_prefix(_same("proj", f"{c}.attn.proj"), "channel_attn"))
        r.update(_prefix(_same("norm2", f"{c}.norm2"), "channel_attn"))
        r.update(_prefix(_same("mlp_fc1", f"{c}.mlp.0"), "channel_attn"))
        r.update(_prefix(_same("mlp_fc2", f"{c}.mlp.2"), "channel_attn"))
    return r


def xl_rules(ref: str) -> Rules:
    """XLRelAttention <- the reference's XLNet layer (rel_attn + ff)."""
    r: Rules = {n: (f"{ref}.rel_attn.{n}", "as_is")
                for n in ("q", "k", "v", "r", "o", "r_w_bias", "r_r_bias")}
    r.update(_same("ln_attn", f"{ref}.rel_attn.layer_norm"))
    r.update(_same("ff1", f"{ref}.ff.layer_1"))
    r.update(_same("ff2", f"{ref}.ff.layer_2"))
    r.update(_same("ln_ff", f"{ref}.ff.layer_norm"))
    return r


def _embeds(cfg, pairs, n_convs: int) -> Rules:
    """The conv embeds `pairs` (ours, ref): a bias without the LayerNorm,
    the norm with it (`embd_with_ln`)."""
    r: Rules = {}
    ln = cfg.embd_with_ln
    for ours, ref in pairs:
        for i in range(n_convs):
            r.update(_masked_conv(f"{ours}_{i}", f"backbone.{ref}.{i}",
                                  bias=not ln))
            if ln:
                r.update(_channel_ln(f"{ours}_norm_{i}",
                                     f"backbone.{ref}_norm.{i}"))
    return r


def _neck_and_heads(cfg) -> Rules:
    """The identity neck's LayerNorms over every pyramid level (with
    `fpn_with_ln`), the heads' `head_num_layers` - 1 convs (a bias without
    `head_with_ln`, a norm with it) and their last convs, the reg head's
    scales over the levels it reads (from `fpn_start_level`). FPN1D has no
    rule, as in JAX: its leaves are left without one and the strict load
    raises."""
    r: Rules = {}
    if cfg.fpn_type == "identity" and cfg.fpn_with_ln:
        for i in range(cfg.num_branch_layers + 1):
            r.update(_channel_ln(f"neck.norm_{i}", f"neck.fpn_norms.{i}"))
    for head in ("cls_head", "reg_head"):
        for i in range(cfg.head_num_layers - 1):
            r.update(_masked_conv(f"{head}.head_{i}", f"{head}.head.{i}",
                                  bias=not cfg.head_with_ln))
            if cfg.head_with_ln:
                r.update(_channel_ln(f"{head}.norm_{i}",
                                     f"{head}.norm.{i}"))
    r.update(_masked_conv("cls_head.cls", "cls_head.cls_head", bias=True))
    r.update(_masked_conv("reg_head.offset", "reg_head.offset_head",
                          bias=True))
    for i in range(cfg.num_fpn_levels):
        r[f"reg_head.scale_{i}.scale"] = (f"reg_head.scale.{i}.scale",
                                          "scalar")
    return r


MQ_GAUSSIANS = ("mu", "sigma", "mu_reg_left", "sigma_reg_left",
                "mu_reg_right", "sigma_reg_right")


def _transformer_trunk(cfg, n_stem: int, n_branch: int, dp: bool) -> Rules:
    """The conv-transformer backbone's stems, XL layers (or pre_branch)
    and branch blocks."""
    bb: Rules = {}
    stems = ["stem"] + (["txt_stem"] if cfg.use_cross_modal else [])
    for s in stems:
        for i in range(n_stem):
            bb.update(_prefix(block_rules(f"backbone.{s}.{i}", False, True,
                                          dp), f"{s}_{i}"))
    if cfg.use_xl:
        for i in range(cfg.xl_layers):
            bb.update(_prefix(xl_rules(f"backbone.xlnet.layer.{i}"),
                              f"xl_{i}"))
    else:
        bb.update(_prefix(block_rules("backbone.stem.0", False, True, dp),
                          "pre_branch"))
    for i in range(n_branch):
        cross = (cfg.use_cross_modal
                 and i not in cfg.cross_modal_skip_levels)
        bb.update(_prefix(block_rules(f"backbone.branch.{i}", cross, False,
                                      dp), f"branch_{i}"))
    return bb


def point_transformer_rules(cfg) -> Rules:
    """The MQ PointTransformer of ModelConfig `cfg` (no CL extras) <- the
    reference MQ PtTransformer: every XL layer `backbone.xlnet.layer.{i}`,
    i < xl_layers, as JAX's rules. The conv backbone has no rule, as in
    JAX."""
    n_convs, n_stem, n_branch = (cfg.backbone_arch[0],
                                 cfg.backbone_arch[1],
                                 cfg.backbone_arch[-1])
    embeds = [("embd", "embd")]
    if cfg.use_cross_modal:
        embeds.append(("txt_embd", "txt_embd"))
    bb = _embeds(cfg, embeds, n_convs)
    if cfg.backbone_type != "conv":
        bb.update(_transformer_trunk(cfg, n_stem, n_branch,
                                     cfg.droppath > 0))
    r = _prefix(bb, "backbone")
    r.update(_neck_and_heads(cfg))
    r.update({n: (n, "column") for n in MQ_GAUSSIANS})
    return r


def nlq_point_transformer_rules(cfg) -> Rules:
    """The NLQ PointTransformer (the dual tower) of ModelConfig `cfg` <-
    the reference NLQ PtTransformer: video and text conv embeds, the text
    stem, the video stem with its text cross-attention, the strided
    branch (the first arch[3] blocks with text cross-attention); no
    channel attention."""
    n_convs, n_txt, n_vid, n_cross = cfg.backbone_arch[:4]
    dp = cfg.droppath > 0
    bb = _embeds(cfg, [("vid_embd", "vid_embd"), ("txt_embd", "txt_embd")],
                 n_convs)
    for s, n, cross in (("txt_stem", n_txt, False), ("vid_stem", n_vid, True),
                        ("branch", cfg.num_branch_layers, False)):
        for i in range(n):
            bb.update(_prefix(block_rules(
                f"backbone.{s}.{i}", cross or (s == "branch" and i < n_cross),
                False, dp), f"{s}_{i}"))
    r = _prefix(bb, "backbone")
    r.update(_neck_and_heads(cfg))
    return r


def _conv_block(ours: str, ref_conv: str, ref_bn: str) -> Rules:
    """A frozen-BN ConvBlock2D <- Conv2d + BatchNorm2d."""
    r = _same(f"{ours}.conv", ref_conv)
    r.update({f"{ours}.bn_scale": (f"{ref_bn}.weight", "as_is"),
              f"{ours}.bn_bias": (f"{ref_bn}.bias", "as_is"),
              f"{ours}.bn_mean": (f"{ref_bn}.running_mean", "as_is"),
              f"{ours}.bn_var": (f"{ref_bn}.running_var", "as_is")})
    return r


def _mha(ours: str, ref: str) -> Rules:
    """nn.MultiheadAttention -> the port's q/k/v/o Linear quartet."""
    r: Rules = {}
    for i, p in enumerate("qkv"):
        r[f"{ours}_{p}.weight"] = (f"{ref}.in_proj_weight", f"third_{i}")
        r[f"{ours}_{p}.bias"] = (f"{ref}.in_proj_bias", f"third_{i}")
    r.update(_same(f"{ours}_o", f"{ref}.out_proj"))
    return r


_VIT_BLOCK = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj",
              "norm2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def vit_rules(depth: int, final_norm: bool, prefix: str = "") -> Rules:
    """The port's ViT (models/vit.py) <- the timm / DINO / DINOv2 / MAE
    names (patch_embed.proj, cls_token, pos_embed, blocks.N.{norm1,
    attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, the final norm only
    with `final_norm`), both sides under `prefix`."""
    r = {"patch_embed.weight": ("patch_embed.proj.weight", "as_is"),
         "patch_embed.bias": ("patch_embed.proj.bias", "as_is"),
         "cls_token": ("cls_token", "as_is"),
         "pos_embed": ("pos_embed", "as_is")}
    for i in range(depth):
        for ours, ref in _VIT_BLOCK.items():
            r.update(_same(f"block_{i}.{ours}", f"blocks.{i}.{ref}"))
    if final_norm:
        r.update(_same("norm", "norm"))
    return {prefix + n: (prefix + key, kind) for n, (key, kind) in r.items()}


def clip_matcher_rules(vit_depth: int, n_down: int, n_st: int, n_up: int,
                       vit_final_norm: bool = False) -> Rules:
    """The frozen-BN ClipMatcher <- the reference ClipMatcher: its timm/MAE
    ViT (the final norm only with `vit_final_norm`), the reduce stack, the
    query/frame decoder layer (nn.TransformerDecoderLayer), the `n_down`
    applied down heads, pe_3d, the spatio-temporal encoder layers
    (nn.TransformerEncoderLayer) and the anchor head."""
    r = vit_rules(vit_depth, vit_final_norm, prefix="backbone.")
    # Sequential(conv, bn, lrelu, conv, bn, lrelu)
    r.update(_conv_block("reduce1", "reduce.0", "reduce.1"))
    r.update(_conv_block("reduce2", "reduce.3", "reduce.4"))
    cq = "CQ_corr_transformer.0"
    r.update(_mha("cq_corr.self", f"{cq}.self_attn"))
    r.update(_mha("cq_corr.cross", f"{cq}.multihead_attn"))
    r.update(_same("cq_corr.ff1", f"{cq}.linear1"))
    r.update(_same("cq_corr.ff2", f"{cq}.linear2"))
    for i in (1, 2, 3):
        r.update(_same(f"cq_corr.norm{i}", f"{cq}.norm{i}"))
    for i in range(n_down):
        r.update(_conv_block(f"down_{i}", f"down_heads.{i}.0",
                             f"down_heads.{i}.1"))
    r["pe_3d"] = ("pe_3d", "as_is")
    for i in range(n_st):
        p = f"feat_corr_transformer.{i}"
        r[f"st_{i}.qkv.weight"] = (f"{p}.self_attn.in_proj_weight", "as_is")
        r[f"st_{i}.qkv.bias"] = (f"{p}.self_attn.in_proj_bias", "as_is")
        r.update(_same(f"st_{i}.proj", f"{p}.self_attn.out_proj"))
        for ours, ref in (("ff1", "linear1"), ("ff2", "linear2"),
                          ("norm1", "norm1"), ("norm2", "norm2")):
            r.update(_same(f"st_{i}.{ours}", f"{p}.{ref}"))
    for i in range(n_up):
        r.update(_same(f"head.up_{i}", f"head.up_convs.{i}"))
    r.update(_conv_block("head.in_conv", "head.in_conv.0", "head.in_conv.1"))
    for i in range(3):
        r.update(_conv_block(f"head.reg_{i}", f"head.regression_conv.{i}.0",
                             f"head.regression_conv.{i}.1"))
        r.update(_conv_block(f"head.cls_{i}",
                             f"head.classification_conv.{i}.0",
                             f"head.classification_conv.{i}.1"))
    r.update(_same("head.reg_head", "head.regression_head"))
    r.update(_same("head.cls_head", "head.classification_head"))
    return r


def rules_for(model: nn.Module) -> Rules:
    """The rules of a PointTransformer (MQ or NLQ) or a frozen-BN
    ClipMatcher, from its configuration."""
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.models.point_transformer import PointTransformer

    if isinstance(model, ClipMatcher):
        if model.norm != "frozen_bn":
            raise ValueError("the reference's conv blocks are BatchNorm: "
                             "build the ClipMatcher with norm='frozen_bn'")
        cfg = model.cfg
        return clip_matcher_rules(
            cfg.vit_depth, model.n_down, cfg.num_transformer,
            model.head.n_up, vit_final_norm=model.backbone.norm is not None)
    if isinstance(model, PointTransformer):
        if model.cfg.variant == "nlq":
            return nlq_point_transformer_rules(model.cfg)
        return point_transformer_rules(model.cfg)
    raise TypeError(f"no reference rules for {type(model).__name__}")


def reference_shapes(model: nn.Module) -> Dict[str, tuple]:
    """{reference key: shape} of every key the model's rules read."""
    rules = rules_for(model)
    own = model.state_dict()
    out: Dict[str, tuple] = {}
    for name, (key, kind) in rules.items():
        if name not in own:
            raise ValueError(f"a rule for {name} <- {key}: the model has no "
                             f"such leaf")
        shape = _REFERENCE_SHAPE[kind](tuple(own[name].shape))
        if out.setdefault(key, shape) != shape:
            raise ValueError(f"{key}: shapes {out[key]} and {shape}")
    return out


@torch.no_grad()
def load_rules(model: nn.Module, state_dict: Mapping[str, object],
               rules: Rules) -> None:
    """Fill every leaf of `model`'s state_dict (its parameters and
    persistent buffers) in place from `state_dict` (torch tensors or numpy
    arrays by reference key) through `rules`, strictly (module
    docstring)."""
    own = model.state_dict(keep_vars=True)
    unknown = sorted(set(rules) - set(own))
    if unknown:
        raise ValueError(f"rules for leaves the model does not have: "
                         f"{[(n, rules[n][0]) for n in unknown]}")
    uncovered = sorted(set(own) - set(rules))
    if uncovered:
        raise ValueError(f"leaves of the model without a reference key: "
                         f"{uncovered}")
    absent = sorted({key for key, _ in rules.values()} - set(state_dict))
    if absent:
        raise KeyError(f"reference keys missing from the state_dict: "
                       f"{absent}")
    bad, vals = [], {}
    for name, (key, kind) in rules.items():
        val = RESHAPES[kind](torch.as_tensor(state_dict[key]))
        if tuple(val.shape) != tuple(own[name].shape):
            bad.append(f"{key} -> {name}: {tuple(val.shape)} vs "
                       f"{tuple(own[name].shape)}")
        vals[name] = val
    if bad:
        raise ValueError(f"shapes differ: {bad}")
    for name, val in vals.items():
        own[name].copy_(val.to(own[name].device, own[name].dtype))


def load_torch_point_transformer(state_dict, model: nn.Module) -> None:
    """A reference MQ PtTransformer state_dict into the port's MQ
    PointTransformer (`use_xl` on or off), in place."""
    if model.cfg.variant != "mq":
        raise ValueError("load_torch_point_transformer: an MQ model")
    load_rules(model, state_dict, point_transformer_rules(model.cfg))


def load_torch_nlq_point_transformer(state_dict, model: nn.Module) -> None:
    """A reference NLQ PtTransformer state_dict into the port's NLQ
    PointTransformer, in place."""
    if model.cfg.variant != "nlq":
        raise ValueError("load_torch_nlq_point_transformer: an NLQ model")
    load_rules(model, state_dict, nlq_point_transformer_rules(model.cfg))


def load_torch_clip_matcher(state_dict, model: nn.Module) -> None:
    """A reference VQ ClipMatcher state_dict into the port's frozen-BN
    ClipMatcher (the MAE geometry: `interp_feat_to`, `vit_final_norm=
    False`), in place."""
    load_rules(model, state_dict, rules_for(model))
