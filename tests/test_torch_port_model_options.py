"""The model, train and decode options of JAX's config (FPN1D, the conv
backbone, stacked XL, any scale_factor, fpn_start_level, the head,
embedding and position-encoding options, the text levels, t_c_alpha;
center sampling, the loss weight, the clip; hard and class-agnostic NMS)
against the JAX package on the CPU.

Each case is JAX's tiny config (vilco_tpu/data/synthetic.py::tiny_config
or vilco_tpu/tasks/nlq.py::nlq_tiny_config) with the option set; the port
reads JAX's `to_dict()` through `config_from_dict`, and JAX's parameter
tree (`jax.eval_shape` of its init), filled from a numpy seed, loads
through models/convert.py. Tolerances:
the forward's logits and offsets 1e-4 (f32 both sides, ~10 layers summed
in another order, as tests/test_torch_port_model.py); the loss and every
gradient leaf 1e-5 relative to the leaf's largest value (floored at 1e-4
of the model's largest gradient, as tests/test_torch_port_train.py; the
reg head's scales 3e-5; the leaves whose gradient is below that floor,
roundoff where the exact gradient is 0, within it on the port's side
too); the parameters after two SGD steps with every train option at once
5e-5 of the leaf's largest value; decode and
NMS: valid flags, labels and counts exact, segments and scores 1e-5.
"""

import json

import numpy as np
import pytest

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.aux_blocks as j_aux
import vilco_tpu.models.layers as j_layers
from vilco_tpu.cl.episode import EpisodeRunner as JRunner
from vilco_tpu.core.config import Config as JConfig
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.data.synthetic import tiny_config as j_tiny
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.models.point_transformer import level_lengths as j_lens
from vilco_tpu.ops import decode as j_decode
from vilco_tpu.tasks.nlq import nlq_tiny_config as j_nlq_tiny
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.cl.episode import EpisodeRunner
from vilco_tpu_torch.core import config as t_config
from vilco_tpu_torch.core.config import config_from_dict
from vilco_tpu_torch.models.convert import load_jax_params, params_from_jax
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.ops.decode import decode_and_nms_batch
from vilco_tpu_torch.train import engine as t_engine

TOL = dict(rtol=1e-4, atol=1e-4)
THREE = ((0, 4), (2, 8), (8, 10000))

# option -> (tiny config overrides, nlq?)
FORWARD = {
    "fpn": ({"model": {"fpn_type": "fpn"}}, False),
    "conv": ({"model": {"backbone_type": "conv"}}, False),
    "xl_layers_2": ({"model": {"use_xl": True, "xl_layers": 2,
                               "xl_d_inner": 48}}, False),
    # levels 64, 22, 8, 3: no branch input a multiple of 3 (see
    # test_scale_factor_3_refuses_what_jax_refuses)
    "scale_factor_3": ({"model": {"scale_factor": 3}}, False),
    "scale_factor_4": ({"model": {"scale_factor": 4}}, False),
    # stride 2 at 60, 30 and 15 rows: JAX's MaskedConvs at 30 and 15 (its
    # fused conv wants T a multiple of 4), the port's K3s2 at all three
    "stride_2_odd_pairs": ({"dataset": {"max_seq_len": 60}}, False),
    "fpn_start_level_1": ({"model": {"fpn_start_level": 1,
                                     "regression_range": THREE}}, False),
    "head": ({"model": {"head_kernel_size": 5, "head_num_layers": 2,
                        "head_with_ln": False}}, False),
    "head_one_layer": ({"model": {"head_num_layers": 1}}, False),
    "embedding": ({"model": {"embd_kernel_size": 5, "embd_with_ln": False,
                             "use_abs_pe": False, "fpn_with_ln": False}},
                  False),
    "cross_modal_t_c_alpha": ({"model": {"use_cross_modal": True,
                                         "cross_modal_skip_levels": (0,)},
                               "train_cfg": {"t_c_alpha": 0.6}}, False),
    # JAX's banded attention needs every level a multiple of the half
    # window and the stride-3 pool a branch input that is not a multiple
    # of 3: levels 28, 10, 4, 2 at window 5
    "nlq_scale_factor_3": ({"model": {"scale_factor": 3,
                                      "n_mha_win_size": 5},
                            "dataset": {"max_seq_len": 28}}, True),
    "nlq_cross_branch": ({"model": {"backbone_arch": (2, 1, 1, 1, 2),
                                    "embd_with_ln": False}}, True),
}


def _jcfg(over, nlq=False):
    return (j_nlq_tiny if nlq else j_tiny)(**over)


def _seeded(tree, seed):
    """JAX's parameter tree (jax.eval_shape of its init) filled from numpy
    at `seed`, in place of its init, whose random draws compile op by op
    on the CPU: a `scale` 1 + N(0, 0.02), every other leaf of one axis
    N(0, 0.02), a kernel N(0, 1 / fan_in), fan_in the product of all but
    its last axis."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        z = rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1 + 0.02 * z
        if len(a.shape) < 2:
            return 0.02 * z
        return z / np.float32(np.sqrt(np.prod(a.shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _inputs(jcfg, B=2, seed=1):
    m = jcfg.model
    rng = np.random.default_rng(seed)
    T = m.max_seq_len
    x = rng.standard_normal((B, T, m.input_dim)).astype(np.float32)
    mask = np.arange(T)[None] < np.linspace(T, T // 2, B).astype(int)[:, None]
    L = jcfg.dataset.max_text_len
    text = rng.standard_normal((B, L, m.n_txt_in)).astype(np.float32)
    tmask = np.arange(L)[None] < np.array([L, L // 2])[:B, None]
    return x, mask, text, tmask


def _pair(jcfg, seed=0):
    """JAX's model and seeded params, the port's model loaded from them,
    and the inputs."""
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    x, mask, text, tmask = _inputs(jcfg)
    text_args = (jnp.asarray(text), jnp.asarray(tmask)) if (
        jcfg.model.use_cross_modal) else ()
    params = _seeded(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(seed), jnp.asarray(x),
        jnp.asarray(mask), *text_args)["params"], seed + 7)
    pcfg = config_from_dict(jcfg.to_dict())
    tmodel = PointTransformer(pcfg.model, cl=pcfg.cl_cfg,
                              device="cpu").eval()
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel, pcfg, (x, mask, text, tmask)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_matches_jax(name):
    over, nlq = FORWARD[name]
    jcfg = _jcfg(over, nlq)
    jmodel, params, tmodel, pcfg, (x, mask, text, tmask) = _pair(jcfg)
    text_in = jcfg.model.use_cross_modal
    jargs = (jnp.asarray(text), jnp.asarray(tmask)) if text_in else ()
    ref = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(
        params, jnp.asarray(x), jnp.asarray(mask), *jargs)
    targs = (torch.from_numpy(text), torch.from_numpy(tmask)) if (
        text_in) else ()
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x), torch.from_numpy(mask), *targs)
    assert out["level_lengths"] == ref["level_lengths"]
    assert level_lengths(pcfg.model) == j_lens(jcfg.model)
    assert pcfg.model.fpn_strides == jcfg.model.fpn_strides
    np.testing.assert_array_equal(out["fpn_mask"].numpy(),
                                  np.asarray(ref["fpn_mask"]))
    for key in ("cls_logits", "offsets"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_scale_factor_3_refuses_what_jax_refuses():
    """JAX's level_lengths floors max_seq_len // stride, a strided layer
    gives ceil(T / s). At scale_factor 3 the max-pool skip of 4 taps gives
    floor(T / 3) + 1 rows against the mask's ceil(T / 3): a branch input
    that is a multiple of 3 fails to broadcast in both packages, and
    otherwise the levels are the ceilings (64, 22, 8, 3) while
    level_lengths says (64, 21, 7, 2) in both. FPN1D's top-down repeat by
    2 fails at scale_factor 4 in both."""
    jcfg = _jcfg({"model": {"scale_factor": 3},
                  "dataset": {"max_seq_len": 54}})
    pcfg = config_from_dict(jcfg.to_dict())
    x, mask, _, _ = _inputs(jcfg)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(JPT(jcfg.model, jcfg.cl_cfg).init,
                       jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask))
    tmodel = PointTransformer(pcfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="size of tensor"):
        tmodel(torch.from_numpy(x), torch.from_numpy(mask))
    fine = config_from_dict(_jcfg({"model": {"scale_factor": 3}}).to_dict())
    assert level_lengths(fine.model) == (64, 21, 7, 2) == j_lens(
        _jcfg({"model": {"scale_factor": 3}}).model)
    fpn4 = _jcfg({"model": {"scale_factor": 4, "fpn_type": "fpn"}})
    x, mask, _, _ = _inputs(fpn4)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(JPT(fpn4.model, fpn4.cl_cfg).init,
                       jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask))
    tmodel = PointTransformer(config_from_dict(fpn4.to_dict()).model,
                              device="cpu")
    with pytest.raises(RuntimeError, match="size of tensor"):
        tmodel(torch.from_numpy(x), torch.from_numpy(mask))


# ----------------------------------------------------------- config


CONFIG_OPTIONS = {
    **{k: v[0] for k, v in FORWARD.items() if not v[1]},
    "center_sample_none": {"train_cfg": {"center_sample": "none",
                                         "center_sample_radius": 2.5}},
    "loss_weight": {"train_cfg": {"loss_weight": 2.0}},
    "clip_off": {"train_cfg": {"clip_grad_l2norm": -1.0}},
    "stored": {"model": {"use_rel_pe": True, "max_buffer_len_factor": 4.0},
               "train_cfg": {"cls_prior_prob": 0.05}},
    "nms": {"test_cfg": {"nms_method": "hard", "iou_threshold": 0.3,
                         "multiclass_nms": False}},
}


@pytest.mark.parametrize("name", sorted(CONFIG_OPTIONS))
def test_config_round_trips_to_jax(name):
    """config_from_dict(JAX's to_dict()) carries the option, and the port's
    to_dict() equals JAX's, through JSON as the episode's config.json: every
    key the port writes holds JAX's value, and the keys it leaves out are
    the JAX fields no path of the port reads (core/config.py::_IGNORED,
    _IGNORED_TOP); JAX's Config reads the port's dict back to its own."""
    jcfg = _jcfg(CONFIG_OPTIONS[name])
    port = config_from_dict(jcfg.to_dict())
    for sec in ("model", "train_cfg", "test_cfg"):
        for k, v in CONFIG_OPTIONS[name].get(sec, {}).items():
            owner = port.model if k == "t_c_alpha" else getattr(port, sec)
            assert getattr(owner, k) == v, (sec, k)
    back = json.loads(json.dumps(port.to_dict()))
    want = json.loads(json.dumps(jcfg.to_dict()))
    assert set(want) - set(back) == set(t_config._IGNORED_TOP)
    for sec, v in back.items():
        if not isinstance(v, dict):
            assert v == want[sec], sec
            continue
        assert set(want[sec]) - set(v) == {
            k for s, k in t_config._IGNORED if s == sec} - set(v), sec
        for k, x in v.items():
            assert x == want[sec][k], (sec, k)
    assert JConfig.from_dict(back).derived() == jcfg


# ----------------------------------------------------------- train


class _NoDropout:
    """flax.linen with nn.Dropout the identity: JAX's train step runs
    deterministic=False, and DenseAPP's dropout of 0.1 cannot draw the
    port's bits."""

    def __getattr__(self, name):
        if name == "Dropout":
            return lambda rate: (lambda x, deterministic=True: x)
        return getattr(flax_nn, name)


TRAIN = {
    "center_sample_none": {"train_cfg": {"center_sample": "none"}},
    "loss_weight": {"train_cfg": {"loss_weight": 2.0}},
    "clip_off": {"train_cfg": {"clip_grad_l2norm": -1.0}},
    "fpn": {"model": {"fpn_type": "fpn"}},
    "xl_layers_2": {"model": {"use_xl": True, "xl_layers": 2,
                              "xl_d_inner": 48, "xl_dropout": 0.0}},
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _train_pair(over, monkeypatch, opt=None):
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    monkeypatch.setattr(j_aux, "nn", _NoDropout())
    jcfg = _jcfg({**over, "opt": opt or {"learning_rate": 1e-4}})
    jmodel, params, tmodel, pcfg, _ = _pair(jcfg, seed=3)
    rng = np.random.default_rng(5)
    batches = [j_make_batch(rng, 2, jcfg) for _ in range(2)]
    pts = generate_points(level_lengths(pcfg.model), pcfg.model.fpn_strides,
                          pcfg.model.regression_range)
    return jcfg, jmodel, params, tmodel, pcfg, batches, pts


def _grads(jcfg, jmodel, params, tmodel, pcfg, batch, pts):
    """(JAX's loss and gradients, the port's loss and gradients) of one
    training-mode forward and backward, regularisers off."""
    C = jcfg.model.num_classes
    jcl = j_engine.CLBatchExtras(class_mask=jnp.ones((C,), bool))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jb["feats"], jb["mask"],
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return j_engine.compute_losses(out, jb, jnp.asarray(pts), jcfg, jcl,
                                       jnp.asarray(20.0), "naive", 0)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tmodel.train()
    tb = t_engine.batch_to(batch, "cpu")
    tcl = t_engine.CLBatchExtras(torch.ones(C, dtype=torch.bool))
    out = tmodel(tb["feats"], tb["mask"])
    loss = t_engine.compute_losses(out, tb, torch.from_numpy(pts), tcl,
                                   torch.tensor(20.0), pcfg.train_cfg)[0]
    loss.backward()
    got = {n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()}
    tmodel.zero_grad()
    return (float(jloss), {n: g.numpy() for n, g in params_from_jax(
        jax.tree.map(np.asarray, jgrads)).items()}), (loss.item(), got)


def _tiny_leaves(want):
    """The leaves whose gradient is below the floor, 1e-4 of the model's
    largest: f32 roundoff on both sides where the exact gradient is 0 (the
    key projection's and key norm's biases, a bias before a GroupNorm of
    one channel a group, ...)."""
    top = max(np.abs(w).max() for w in want.values())
    return top, {n for n, w in want.items() if np.abs(w).max() <= 1e-4 * top}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_gradients_match_jax(name, monkeypatch):
    """The loss and every gradient leaf of one forward and backward."""
    jcfg, jmodel, params, tmodel, pcfg, batches, pts = _train_pair(
        TRAIN[name], monkeypatch)
    (jloss, want), (loss, got) = _grads(jcfg, jmodel, params, tmodel, pcfg,
                                        batches[0], pts)
    assert _rel(loss, jloss) <= 1e-5
    assert set(got) == set(want)
    top, tiny = _tiny_leaves(want)
    assert "backbone.stem_0.attn.key.bias" in tiny
    for n in tiny:
        assert np.abs(got[n]).max() <= 1e-4 * top, n
    worst = {n: np.abs(got[n] - want[n]).max()
             / max(np.abs(want[n]).max(), 1e-4 * top)
             for n in want if n not in tiny}
    bad = [(n, e) for n, e in worst.items()
           if e > (3e-5 if n.startswith("reg_head.scale_") else 1e-5)]
    assert not bad, bad


def test_train_steps_match_jax(monkeypatch):
    """Two train steps (the warmup reaches lr > 0 at the second) with every
    option of TRAIN at once: each step's loss, no grad_norm in either (the
    clip is off), and the parameters after them. The optimizer is SGD with
    momentum, whose update is linear in the gradient: AdamW's first
    update is lr x sign(g), so a gradient element within roundoff of 0
    moves by 2 lr on a sign flip, which no tolerance on the parameters can
    tell from a fault (the AdamW steps: tests/test_torch_port_train.py)."""
    over = {}
    for v in TRAIN.values():
        for sec, kv in v.items():
            over.setdefault(sec, {}).update(kv)
    jcfg, jmodel, params, tmodel, pcfg, batches, pts = _train_pair(
        over, monkeypatch, {"type": "sgd", "momentum": 0.9,
                            "learning_rate": 1e-2})
    C = jcfg.model.num_classes
    jcl = j_engine.CLBatchExtras(class_mask=jnp.ones((C,), bool))
    tcl = t_engine.CLBatchExtras(torch.ones(C, dtype=torch.bool))
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=1)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1))
    jstep = j_engine.make_train_step(jmodel, tx, jnp.asarray(pts), jcfg)
    tstate = t_engine.init_train_state(tmodel, pcfg, 1, device="cpu")
    tstep = t_engine.make_train_step(torch.from_numpy(pts), pcfg.train_cfg,
                                     regularize=False)
    for batch in batches:
        state, jm, _ = jstep(state, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcl)
        tm = tstep(tstate, t_engine.batch_to(batch, "cpu"), tcl)
        assert _rel(tm["final_loss"], jm["final_loss"]) <= 1e-5
        assert "grad_norm" not in tm and "grad_norm" not in jm
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    errs = {n: _rel(p.detach().numpy(), want[n].numpy())
            for n, p in tstate.model.named_parameters()}
    assert max(errs.values()) <= 5e-5, sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:4]


# ----------------------------------------------------------- decode


class _Stub:
    """What the runners' _decode_batch reads of `self`."""

    def __init__(self, cfg, points, num_classes):
        self.cfg, self.points, self.num_classes = cfg, points, num_classes


@pytest.mark.parametrize("test_cfg", [
    {"nms_method": "hard"},
    {"nms_method": "hard", "iou_threshold": 0.4},
    {"nms_method": "none"},
    {"multiclass_nms": False},
    {"nms_method": "hard", "multiclass_nms": False},
], ids=["hard", "hard_iou_0.4", "none", "class_agnostic",
        "hard_class_agnostic"])
def test_decode_matches_jax(test_cfg):
    """The episode's _decode_batch (JAX's `use_soft_nms = nms_method ==
    "soft"`: "none" runs hard NMS) on an MQ config, through both runners
    called on a stand-in `self`."""
    jcfg = _jcfg({"test_cfg": test_cfg})
    pcfg = config_from_dict(jcfg.to_dict())
    m = jcfg.model
    points = generate_points(j_lens(m), m.fpn_strides, m.regression_range)
    rng = np.random.default_rng(11)
    B, P, C = 3, points.shape[0], m.num_classes
    logits = (rng.standard_normal((B, P, C)) * 2 - 3).astype(np.float32)
    offsets = (np.abs(rng.standard_normal((B, P, 2))) * 2 + 0.2).astype(
        np.float32)
    fmask = np.ones((B, P), bool)
    fmask[1, P // 2:] = False
    fmask[2] = False
    cmask = np.ones(C, bool)
    cmask[-2:] = False
    ref = JRunner._decode_batch(
        _Stub(jcfg, jnp.asarray(points), C),
        {"cls_logits": jnp.asarray(logits), "offsets": jnp.asarray(offsets),
         "fpn_mask": jnp.asarray(fmask)}, jnp.asarray(cmask))
    det = EpisodeRunner._decode_batch(
        _Stub(pcfg, torch.from_numpy(points), C),
        {"cls_logits": torch.from_numpy(logits),
         "offsets": torch.from_numpy(offsets),
         "fpn_mask": torch.from_numpy(fmask)}, torch.from_numpy(cmask))
    valid = det.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid[0].sum() > 0 and valid[2].sum() == 0
    np.testing.assert_array_equal(det.labels.numpy()[valid],
                                  np.asarray(ref.labels)[valid])
    for f in ("scores", "segs"):
        np.testing.assert_allclose(getattr(det, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    if test_cfg.get("nms_method") == "none":
        hard = decode_and_nms_batch(
            torch.from_numpy(points), torch.from_numpy(logits),
            torch.from_numpy(offsets), torch.from_numpy(fmask),
            torch.from_numpy(cmask), num_classes=C,
            pre_nms_topk=jcfg.test_cfg.pre_nms_topk,
            pre_nms_thresh=jcfg.test_cfg.pre_nms_thresh,
            duration_thresh=jcfg.test_cfg.duration_thresh,
            max_seg_num=jcfg.test_cfg.max_seg_num,
            min_score=jcfg.test_cfg.min_score,
            nms_sigma=jcfg.test_cfg.nms_sigma,
            voting_thresh=jcfg.test_cfg.voting_thresh, use_soft_nms=False)
        assert torch.equal(hard.valid, det.valid)
        assert torch.equal(hard.scores, det.scores)


def test_jax_decode_reads_the_same_flags():
    """JAX's decode_and_nms_batch takes use_soft_nms and multiclass as
    keywords with no default; the port's defaults are soft and
    multiclass, the JAX config's defaults."""
    import inspect

    sig = inspect.signature(j_decode.decode_and_nms_batch)
    assert sig.parameters["use_soft_nms"].default is inspect._empty
    p = inspect.signature(decode_and_nms_batch).parameters
    t = JConfig().test_cfg
    assert (p["use_soft_nms"].default, p["multiclass"].default,
            p["iou_threshold"].default) == (
        t.nms_method == "soft", t.multiclass_nms, t.iou_threshold)


# ----------------------------------------------------------- the CLI


def test_train_cl_runs_a_yaml_that_sets_the_options(tmp_path):
    """train_cl from a yaml that sets fpn_type fpn and nms_method hard: one
    task of one epoch, the config.json written back with the options (JAX
    reads it), and evaluate from that config.json alone gives the run's
    final eval (rtol 1e-5)."""
    import yaml

    from vilco_tpu_torch.bin import evaluate, train_cl

    d = _jcfg({"model": {"fpn_type": "fpn"},
               "test_cfg": {"nms_method": "hard"},
               "cl_cfg": {"num_tasks": 1}}).to_dict()
    path = tmp_path / "opts.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(d))))
    wd = tmp_path / "run"
    res = train_cl.main(["--config", str(path), "--synthetic", "--workdir",
                         str(wd), "--epochs", "1", "--num-tasks", "1",
                         "--synthetic-videos", "2", "1", "--device", "cpu"])
    assert np.isfinite(res["tasks"][-1]["eval"]["avg_mAP"])
    saved = json.loads((wd / "config.json").read_text())
    assert saved["model"]["fpn_type"] == "fpn"
    assert saved["test_cfg"]["nms_method"] == "hard"
    assert JConfig.from_dict(saved).derived().model.fpn_type == "fpn"
    ev = evaluate.main(["--workdir", str(wd), "--synthetic",
                        "--synthetic-videos", "2", "1", "--device", "cpu"])
    np.testing.assert_allclose(ev["avg_mAP"],
                               res["tasks"][-1]["eval"]["avg_mAP"],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["fpn", "conv", "xl_layers_2"])
def test_export_covers_the_options(name, tmp_path):
    """bin/export_model.py's program (plain math) of the option's tiny
    model, saved and loaded, against the eager forward: 1e-5 of the
    largest output (f32; the same plain ops, traced)."""
    from vilco_tpu_torch.bin.export_model import (
        PointForward,
        export_forward,
        load_exported,
    )

    pcfg = config_from_dict(_jcfg(FORWARD[name][0]).to_dict())
    model = PointTransformer(pcfg.model, cl=pcfg.cl_cfg, device="cpu").eval()
    ep = export_forward(pcfg, model, "cpu")
    path = str(tmp_path / "m.pt2")
    torch.export.save(ep, path)
    x, mask, _, _ = _inputs(_jcfg(FORWARD[name][0]), B=pcfg.batch_size)
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    with torch.no_grad():
        got = load_exported(path)(*args)
        want = PointForward(model, torch.float32)(*args)
    for key in ("cls_logits", "offsets"):
        scale = want[key].abs().max().item()
        torch.testing.assert_close(got[key], want[key], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("s,T", [(3, 22), (3, 64), (4, 64), (4, 61)])
def test_strided_masked_ops_match_jax(s, T):
    """ops/masked.py at a stride above 2 against JAX's: the depthwise conv
    of s + 1 taps (even at s = 3: JAX's shifted slices give ceil(T / s)
    rows) and the max-pool skip of s + 1 taps, output lengths, values
    (1e-6) and the masks mask[:, ::s]."""
    from vilco_tpu.ops import masked as j_masked
    from vilco_tpu_torch.ops import masked as t_masked

    rng = np.random.default_rng(s * 100 + T)
    C = 8
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, T // 2])[:, None]
    k = rng.standard_normal((s + 1, 1, C)).astype(np.float32)
    jo, jm = j_masked.masked_conv1d(jnp.asarray(x), jnp.asarray(mask),
                                    jnp.asarray(k), stride=s, groups=C)
    to, tm = t_masked.masked_conv1d(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(k.transpose(2, 1, 0).copy()), None, s, groups=C)
    assert to.shape == jo.shape == (2, -(-T // s), C)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    jp, jpm = j_masked.masked_max_pool1d(jnp.asarray(x), jnp.asarray(mask),
                                         s + 1, s)
    tp, tpm = t_masked.masked_max_pool1d(torch.from_numpy(x),
                                         torch.from_numpy(mask), s + 1, s)
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(jpm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
