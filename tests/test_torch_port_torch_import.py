"""The port's importer of the reference's own state_dicts
(models/torch_import.py) against the JAX package's
(vilco_tpu/models/torch_import.py followed by models/convert.py::
params_from_jax) on the CPU.

For each tiny configuration (MQ with the XL stage on and off, MQ with two
XL layers and 4-layer heads, NLQ, the VQ
ClipMatcher in the MAE geometry with frozen BN) a state_dict of the
reference's names is drawn from a seed at the shapes the port's rules give
(`reference_shapes`; the BN running variances positive), and goes through
both importers: every leaf equal, bit for bit. JAX's importer accepts the
same keys and shapes strictly, which holds the port's rules to JAX's. A
dropped key, a rule for a leaf the model does not have and a wrong shape
raise, naming the key or the leaf.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from __graft_entry__ import _flagship_cfg
from vilco_tpu.models import torch_import as j_import
from vilco_tpu.models.clip_matcher import ClipMatcher as JClipMatcher
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.tasks.nlq import nlq_tiny_config
from vilco_tpu_torch.core.config import ModelConfig, VQConfig
from vilco_tpu_torch.models import torch_import as t_import
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.models.convert import params_from_jax
from vilco_tpu_torch.models.point_transformer import PointTransformer

CASES = ("mq_xl", "mq_xl2", "mq", "nlq", "vq_mae")
VQ_TINY = dict(dim=32, clip_size=64, patch_size=8, vit_dim=24, vit_depth=1,
               vit_heads=2, resolution_transformer=2,
               resolution_anchor_feat=4, num_transformer=1,
               window_transformer=3, num_frames=3)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _mq(use_xl: bool, **model):
    cfg = _flagship_cfg(tiny=True)
    jcfg = cfg.model.updated(use_xl=use_xl, compute_dtype="float32",
                             **model)
    B, T = 1, jcfg.max_seq_len
    template = JPT(jcfg, cfg.cl_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((B, T, jcfg.input_dim)),
        jnp.ones((B, T), bool))["params"]
    port = PointTransformer(_port_cfg(jcfg), device="cpu")
    return (lambda sd: j_import.load_torch_point_transformer(
        sd, jcfg, template)), port, t_import.load_torch_point_transformer, \
        template


def _nlq():
    cfg = nlq_tiny_config()
    m = cfg.model
    B, T, L = 1, m.max_seq_len, 8
    template = JPT(m, cfg.cl_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((B, T, m.input_dim)),
        jnp.ones((B, T), bool), jnp.zeros((B, L, m.n_txt_in)),
        jnp.ones((B, L), bool))["params"]
    port = PointTransformer(_port_cfg(m), device="cpu")
    return (lambda sd: j_import.load_torch_nlq_point_transformer(
        sd, m, template)), port, \
        t_import.load_torch_nlq_point_transformer, template


def _vq():
    S = VQ_TINY["clip_size"]
    jmodel = JClipMatcher(**VQ_TINY, compute_dtype="float32",
                          norm="frozen_bn", interp_feat_to=4,
                          vit_final_norm=False)
    template = jmodel.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, VQ_TINY["num_frames"], S, S, 3)),
                           jnp.zeros((1, S, S, 3)),
                           deterministic=True)["params"]
    port = ClipMatcher(VQConfig(query_size=S, **VQ_TINY), device="cpu",
                       compute_dtype=torch.float32, norm="frozen_bn",
                       interp_feat_to=4, vit_final_norm=False)
    return (lambda sd: j_import.load_torch_clip_matcher(
        sd, jmodel, template)), port, t_import.load_torch_clip_matcher, \
        template


BUILD = {"mq_xl": lambda: _mq(True), "mq": lambda: _mq(False), "nlq": _nlq,
         # two XL layers (backbone.xlnet.layer.{0,1}) and 4-layer heads
         "mq_xl2": lambda: _mq(True, xl_layers=2, xl_d_inner=96,
                               head_num_layers=4),
         "vq_mae": _vq}


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return (request.param,) + BUILD[request.param]()


def seeded_state_dict(model, seed: int = 0):
    """{reference key: numpy f32} at the shapes of the model's rules, from
    numpy's default_rng(seed); running variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(t_import.reference_shapes(model).items()):
        a = (rng.uniform(0.5, 2.0, shape) if key.endswith("running_var")
             else rng.standard_normal(shape))
        out[key] = np.asarray(a, np.float32)
    return out


def test_importer_equals_jax_leaf_for_leaf(case):
    name, j_load, port, t_load, template = case
    sd = seeded_state_dict(port)
    want = params_from_jax(jax.tree.map(np.asarray, j_load(sd)))
    t_load({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    got = port.state_dict()
    assert set(got) == set(want)
    if name == "nlq":
        # JAX's allowed_missing (the label Gaussians, absent from the NLQ
        # reference) names no leaf of either NLQ model: nothing to keep
        assert not set(j_import.NLQ_GAUSSIAN_PARAMS) & (set(template)
                                                        | set(got))
    for n in got:
        assert torch.equal(got[n], want[n]), n
    if name == "mq":        # pre_branch is stem.0, re-applied
        assert torch.equal(got["backbone.pre_branch.attn.query.weight"],
                           got["backbone.stem_0.attn.query.weight"])
    if name == "vq_mae":    # the statistics are buffers, filled as well
        assert torch.equal(got["reduce1.bn_var"],
                           torch.from_numpy(sd["reduce.1.running_var"]))


def test_importer_reads_torch_tensors_and_numpy_alike(case):
    _, _, port, t_load, _ = case
    sd = seeded_state_dict(port, seed=3)
    t_load(sd, port)
    a = {k: v.clone() for k, v in port.state_dict().items()}
    t_load({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    assert all(torch.equal(a[k], v) for k, v in port.state_dict().items())


def test_a_dropped_key_raises_naming_it(case):
    _, j_load, port, t_load, _ = case
    sd = seeded_state_dict(port)
    key = sorted(sd)[len(sd) // 2]
    del sd[key]
    with pytest.raises(KeyError, match=re.escape(key)):
        t_load(sd, port)
    with pytest.raises(ValueError, match=re.escape(key)):
        j_load(sd)


def test_a_wrong_shape_raises_naming_the_key(case):
    _, _, port, t_load, _ = case
    sd = seeded_state_dict(port)
    key = max(sd, key=lambda k: sd[k].ndim)
    sd[key] = np.concatenate([sd[key], sd[key]], 0)
    with pytest.raises(ValueError, match=re.escape(key)):
        t_load(sd, port)


def test_a_rule_for_no_leaf_raises_naming_it(case):
    _, _, port, _, _ = case
    sd = seeded_state_dict(port)
    rules = dict(t_import.rules_for(port))
    rules["head.no_such_leaf.weight"] = ("no.such.key", "as_is")
    sd["no.such.key"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="head.no_such_leaf.weight"):
        t_import.load_rules(port, sd, rules)
    rules = dict(t_import.rules_for(port))
    dropped = sorted(rules)[0]
    del rules[dropped]
    with pytest.raises(ValueError, match=re.escape(dropped)):
        t_import.load_rules(port, sd, rules)


def test_group_norm_clip_matcher_is_refused():
    cfg = VQConfig(query_size=VQ_TINY["clip_size"], **VQ_TINY)
    model = ClipMatcher(cfg, device="cpu", interp_feat_to=4,
                        vit_final_norm=False)
    with pytest.raises(ValueError, match="frozen_bn"):
        t_import.rules_for(model)
