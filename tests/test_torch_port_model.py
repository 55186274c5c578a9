"""The port's MQ model, decode and NMS against the JAX package on the CPU.

The JAX `PointTransformer` is initialised at `_flagship_cfg(tiny=True)`
with the XL stage on and f32 compute; its parameters (perturbed so that no
block is near its init) load into the port through `load_jax_params`, and
the same numpy inputs go through both. Model tolerance 1e-4: f32 on both
sides, but ~10 layers of matmuls, norms and softmaxes sum in a different
order, so errors of a few 1e-6 build up. Decode/NMS: labels, valid flags and
counts must match exactly, segments and scores to 1e-5 on valid slots.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from __graft_entry__ import _flagship_cfg
from vilco_tpu.models import layers as j_layers
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.ops import decode as j_decode
from vilco_tpu.ops import nms as j_nms
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.core.config import (
    ModelConfig,
    TestCfg,
    TrainCfg,
    flagship_config,
)
from vilco_tpu_torch.models import layers as t_layers
from vilco_tpu_torch.models.convert import load_jax_params, params_from_jax
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.ops.decode import decode_and_nms_batch
from vilco_tpu_torch.train import optim as t_optim

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _mask(B, T):
    lens = np.linspace(T, T // 2, B).astype(int)
    return np.arange(T)[None, :] < lens[:, None]


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


# what every MQ flagship config shares: the port's config defaults
_DEFAULT = ModelConfig()
FIXED_MODEL = dict(
    variant="mq", backbone_type="convTransformer", fpn_type="identity",
    scale_factor=2, n_mha_win_size=-1, use_cross_modal=False,
    embd_with_ln=True, fpn_with_ln=True, head_with_ln=True, use_abs_pe=True,
    fpn_start_level=0, use_xl=True, xl_layers=1,
    xl_d_inner=_DEFAULT.xl_d_inner,
    embd_kernel_size=_DEFAULT.embd_kernel_size,
    head_kernel_size=_DEFAULT.head_kernel_size,
    head_num_layers=_DEFAULT.head_num_layers,
    t_c_alpha=_DEFAULT.t_c_alpha, droppath=0.1)
FIXED_TEST = dict(nms_method="soft", multiclass_nms=True)


def assert_port_config_equals(port, ref):
    """Every field of the port's Config (model, test_cfg, train_cfg, opt
    and the loader/dataset scalars) equals the JAX Config's."""
    for sub in ("model", "test_cfg", "train_cfg", "opt"):
        for f in dataclasses.fields(getattr(port, sub)):
            assert getattr(getattr(port, sub), f.name) == getattr(
                getattr(ref, sub), f.name), f"{sub}.{f.name}"
    assert port.batch_size == ref.loader.batch_size
    assert port.max_segments == ref.dataset.max_segments
    assert port.max_text_len == ref.dataset.max_text_len


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_config_matches_jax(tiny):
    ref = _flagship_cfg(tiny=tiny)
    ref = ref.updated(model=ref.model.updated(use_xl=True)) if tiny else ref
    port = flagship_config(tiny=tiny)
    assert_port_config_equals(port, ref)
    for name, v in FIXED_MODEL.items():
        assert getattr(ref.model, name) == v, name
    for name, v in FIXED_TEST.items():
        assert getattr(ref.test_cfg, name) == v, name
    assert port.model.fpn_strides == ref.model.fpn_strides
    assert port.model.num_branch_layers == ref.model.num_branch_layers
    # the training constants: the port's train_cfg defaults, and those
    # fixed in train/optim.py and models/layers.py
    tc, opt = ref.train_cfg, ref.opt
    ptc = TrainCfg()
    assert (tc.center_sample, tc.center_sample_radius) == (
        "radius", ptc.center_sample_radius)
    assert tc.al_loss_weight == 0.0 and tc.dropout == 0.0
    assert tc.loss_weight == ptc.loss_weight
    assert tc.clip_grad_l2norm == ptc.clip_grad_l2norm
    assert tc.droppath == ref.model.droppath
    assert ref.model.xl_dropout == t_layers.XL_DROPOUT
    # the opt section reads into the port's OptCfg field for field
    popt = port.opt
    assert (opt.type, opt.weight_decay) == ("adamw", t_optim.WEIGHT_DECAY)
    assert (popt.type, popt.weight_decay) == (opt.type, opt.weight_decay)
    assert (popt.warmup, popt.schedule_type, popt.eta_min) == (
        opt.warmup, opt.schedule_type, opt.eta_min) == (True, "cosine", 1e-8)
    assert (popt.mu_dtype, popt.nu_dtype) == (opt.mu_dtype, opt.nu_dtype) \
        == ("bfloat16", "bfloat16")
    assert opt.fused_apply and opt.accumulation_steps == 1
    assert popt.param_compute_dtype == opt.param_compute_dtype == "float32"
    assert (j_optim.FusedAdamW.B1, j_optim.FusedAdamW.B2,
            j_optim.FusedAdamW.EPS) == (t_optim.B1, t_optim.B2, 1e-8)
    assert j_optim._SMALL_LEAF_ELEMS == t_optim.SMALL_LEAF_ELEMS


def test_port_imports_neither_jax_nor_yaml():
    code = (
        "import sys, pkgutil, importlib, vilco_tpu_torch\n"
        "for m in pkgutil.walk_packages(vilco_tpu_torch.__path__,"
        " 'vilco_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'yaml', 'vilco_tpu')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("stride", [1, 2])
def test_transformer_block_matches_jax(rng, stride):
    B, T, E, H = 2, 32, 64, 4
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mask = _mask(B, T)
    jblock = j_layers.TransformerBlock(E, H, n_ds_stride=stride,
                                       path_drop=0.1, t_c_alpha=0.8)
    params = jblock.init(jax.random.PRNGKey(stride), jnp.asarray(x),
                         jnp.asarray(mask))["params"]
    params = _perturbed(params, stride)
    ref, ref_m = jblock.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(mask))
    tblock = t_layers.TransformerBlock(E, H, n_ds_stride=stride,
                                       path_drop=0.1)
    load_jax_params(tblock, params)
    with torch.no_grad():
        out, out_m = tblock(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_xl_rel_attention_layer_matches_jax(rng):
    B, T, E, H = 2, 32, 64, 4
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mask = _mask(B, T)
    jxl = j_layers.XLRelAttention(E, H, 128, dropout=0.1)
    params = jxl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(mask))["params"]
    params = _perturbed(params, 3)
    ref = jxl.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    txl = t_layers.XLRelAttention(E, H, 128)
    load_jax_params(txl, params)
    with torch.no_grad():
        out = txl(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def tiny_models():
    cfg = _flagship_cfg(tiny=True)
    jcfg = cfg.model.updated(use_xl=True, compute_dtype="float32")
    jmodel = JPT(jcfg, cfg.cl_cfg)
    B, T = 2, jcfg.max_seq_len
    x = np.random.default_rng(1).standard_normal(
        (B, T, jcfg.input_dim)).astype(np.float32)
    mask = _mask(B, T)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))["params"]
    params = _perturbed(params, 7, scale=0.02)
    tmodel = PointTransformer(_port_cfg(jcfg), device="cpu").eval()
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel, x, mask


def test_point_transformer_matches_jax(tiny_models):
    jmodel, params, tmodel, x, mask = tiny_models
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(mask))
    assert out["level_lengths"] == ref["level_lengths"] \
        == level_lengths(tmodel.cfg)
    np.testing.assert_array_equal(out["fpn_mask"].numpy(),
                                  np.asarray(ref["fpn_mask"]))
    for key in ("cls_logits", "offsets"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_load_jax_params_is_strict(tiny_models):
    _, params, tmodel, _, _ = tiny_models
    sd = params_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    cut = dict(params)
    cut["backbone"] = {k: v for k, v in params["backbone"].items()
                       if k != "xl_0"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(tmodel, cut)
    wrong = jax.tree.map(lambda a: a, params)
    wrong["cls_head"]["cls"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tmodel, wrong)


def _jax_decode(points, logits, offsets, fmask, kw, cap):
    """The JAX decode + batched_nms per clip, with a bucket capacity."""
    t = kw
    outs = []
    for b in range(logits.shape[0]):
        cand = j_decode.decode_candidates(
            jnp.asarray(points), jnp.asarray(logits[b]),
            jnp.asarray(offsets[b]), jnp.asarray(fmask[b]),
            jnp.ones((logits.shape[2],), bool), t["pre_nms_topk"],
            t["pre_nms_thresh"], t["duration_thresh"])
        outs.append(j_nms.batched_nms(
            cand.segs, cand.scores, cand.labels, cand.valid,
            num_classes=t["num_classes"], max_seg_num=t["max_seg_num"],
            iou_threshold=0.1, min_score=t["min_score"],
            nms_sigma=t["nms_sigma"], voting_thresh=t["voting_thresh"],
            use_soft_nms=True, multiclass=t["multiclass"],
            per_class_capacity=cap))
    return j_nms.Detections(*(np.stack([np.asarray(getattr(o, f))
                                        for o in outs])
                              for f in j_nms.Detections._fields))


@pytest.mark.parametrize("cap,multiclass", [(None, True), (0, True),
                                            (None, False)])
def test_decode_and_nms_matches_jax(cap, multiclass):
    rng = np.random.default_rng(11)
    cfg = flagship_config(tiny=True).model
    lens = level_lengths(cfg)
    points = generate_points(lens, cfg.fpn_strides, cfg.regression_range)
    B, P, C = 3, points.shape[0], cfg.num_classes
    logits = (rng.standard_normal((B, P, C)) * 2 - 3).astype(np.float32)
    offsets = (np.abs(rng.standard_normal((B, P, 2))) * 2 + 0.2).astype(
        np.float32)
    fmask = np.ones((B, P), bool)
    fmask[1, P // 2:] = False
    fmask[2] = False                       # a clip with nothing valid
    kw = dict(num_classes=C, pre_nms_topk=400, pre_nms_thresh=0.001,
              duration_thresh=0.05, max_seg_num=20, min_score=0.001,
              nms_sigma=0.75, voting_thresh=0.75, multiclass=multiclass)
    if cap is None and multiclass:
        # the flagship's M=2000, 200 picks, 110 classes give 256 slots
        assert j_nms._auto_class_cap(110, 2000, 200) == 256
        from vilco_tpu_torch.ops.nms import _auto_class_cap
        assert _auto_class_cap(C, 400, 20) == j_nms._auto_class_cap(
            C, 400, 20) == 256
    ref = _jax_decode(points, logits, offsets, fmask, kw, cap)
    det = decode_and_nms_batch(
        torch.from_numpy(points), torch.from_numpy(logits),
        torch.from_numpy(offsets), torch.from_numpy(fmask),
        torch.ones(C, dtype=torch.bool), per_class_capacity=cap, **kw)
    valid = det.valid.numpy()
    np.testing.assert_array_equal(valid, ref.valid)
    np.testing.assert_array_equal(valid.sum(1), ref.valid.sum(1))
    assert valid[0].sum() > 0 and valid[2].sum() == 0
    np.testing.assert_array_equal(det.labels.numpy()[valid],
                                  ref.labels[valid])
    np.testing.assert_allclose(det.scores.numpy()[valid], ref.scores[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(det.segs.numpy()[valid], ref.segs[valid],
                               rtol=1e-5, atol=1e-5)
