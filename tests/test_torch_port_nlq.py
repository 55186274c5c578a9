"""The port's NLQ flagship (dual tower, serving and train step) against the
JAX package on the CPU.

The config equals configs/nlq_vilco.yaml as `load_config` reads it (the
tiny twin `nlq_tiny_config()`), field by field. The JAX `PointTransformer`
(variant "nlq") is initialised at the tiny twin in f32; its parameters,
perturbed so that no block is near its init, load into the port through
`load_jax_params`, and the same numpy batches (text included) go through
both. The full-width tree (467 leaves from `jax.eval_shape`) loads
strictly. Tolerances: model 1e-4 (as the MQ model test: ~10 layers of f32
summed in another order); decode and NMS exact on labels, valid flags and
counts, 1e-5 on segments and scores; the train step as
test_torch_port_train.py: loss, grad norm and every gradient leaf 1e-5,
the 3-step trajectory 5e-5 on the parameters and two bf16 steps on the
moments.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_model import _jax_decode, assert_port_config_equals
from tests.test_torch_port_train import _rel
from vilco_tpu.core.config import load_config
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.models import layers as j_layers
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.ops import nms as j_nms
from vilco_tpu.tasks.nlq import nlq_tiny_config
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.core.config import (
    ModelConfig,
    TrainCfg,
    nlq_flagship_config,
)
from vilco_tpu_torch.data.synthetic import make_batch
from vilco_tpu_torch.models import layers as t_layers
from vilco_tpu_torch.models.convert import (
    adam_state_from_jax,
    load_jax_params,
    params_from_jax,
    port_name,
)
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops import nms as t_nms
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.ops.decode import decode_and_nms_batch
from vilco_tpu_torch.train import engine as t_engine
from vilco_tpu_torch.train import optim as t_optim

YAML = "configs/nlq_vilco.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)
SPE = 1
INPUTS = ("feats", "mask", "text", "text_mask")
# 30,168,202 parameters in 467 leaves (jax.eval_shape of the JAX model)
FLAGSHIP_LEAVES, FLAGSHIP_PARAMS = 467, 30_168_202


def _points(m):
    return generate_points(level_lengths(m), m.fpn_strides,
                           m.regression_range)


def _perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


@pytest.mark.parametrize("tiny", [False, True])
def test_nlq_config_matches_jax(tiny):
    ref = nlq_tiny_config() if tiny else load_config(YAML)
    port = nlq_flagship_config(tiny=tiny)
    assert_port_config_equals(port, ref)
    m = ref.model
    assert port.model.fpn_strides == m.fpn_strides
    assert port.model.num_branch_layers == m.num_branch_layers
    assert port.model.window == 4
    # what the port's modules fix, as the NLQ configs have it
    assert (m.fpn_type, m.scale_factor, m.fpn_start_level) == (
        "identity", 2, 0)
    assert m.embd_with_ln and m.fpn_with_ln and m.head_with_ln
    assert m.use_abs_pe and not m.use_xl
    d, dtc = ModelConfig(), TrainCfg()
    assert (m.embd_kernel_size, m.head_kernel_size, m.head_num_layers) == (
        d.embd_kernel_size, d.head_kernel_size, d.head_num_layers)
    tc, opt, t = ref.train_cfg, ref.opt, ref.test_cfg
    assert (tc.center_sample, tc.center_sample_radius) == (
        "radius", dtc.center_sample_radius)
    assert tc.al_loss_weight == 0.0 and tc.dropout == 0.0
    assert tc.loss_weight == dtc.loss_weight
    assert tc.clip_grad_l2norm == dtc.clip_grad_l2norm
    assert (opt.type, opt.weight_decay, opt.warmup, opt.schedule_type,
            opt.eta_min) == ("adamw", t_optim.WEIGHT_DECAY, True, "cosine",
                             1e-8)
    assert (opt.mu_dtype, opt.nu_dtype) == ("bfloat16", "bfloat16")
    assert all(getattr(port.opt, k) == getattr(opt, k) for k in (
        "type", "weight_decay", "warmup", "schedule_type", "eta_min",
        "mu_dtype", "nu_dtype", "second_moment", "param_compute_dtype"))
    assert (t.nms_method, t.multiclass_nms) == ("soft", True)
    if not tiny:
        assert ref.dataset.input_txt_dim == port.model.n_txt_in


def _jax_flagship_shapes():
    cfg = load_config(YAML)
    m, B = cfg.model, 1
    T, L = m.max_seq_len, cfg.dataset.max_text_len
    spec = lambda *s, dt=jnp.float32: jax.ShapeDtypeStruct(s, dt)
    tree = jax.eval_shape(
        JPT(m, cfg.cl_cfg).init, jax.random.PRNGKey(0),
        spec(B, T, m.input_dim), spec(B, T, dt=jnp.bool_),
        spec(B, L, m.n_txt_in), spec(B, L, dt=jnp.bool_))
    return tree["params"]


def test_nlq_flagship_tree_loads_strictly():
    """All 467 leaves of the full-width JAX tree land on the port's
    parameters (the cross_attn, ln3 and txt_* names included), no
    Gaussians exist, and the decay mask agrees with weight_decay_mask."""
    shapes = _jax_flagship_shapes()
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == FLAGSHIP_LEAVES
    assert sum(int(np.prod(a.shape)) for a in leaves) == FLAGSHIP_PARAMS
    model = PointTransformer(nlq_flagship_config().model, device="cpu")
    names = dict(model.named_parameters())
    assert len(names) == FLAGSHIP_LEAVES
    assert sum(p.numel() for p in names.values()) == FLAGSHIP_PARAMS
    assert not any(n in names for n in ("mu", "sigma"))
    for part in ("cross_attn.query.weight", "ln3.weight", "txt_embd_0",
                 "txt_stem_3", "vid_stem_3", "branch_5"):
        assert any(part in n for n in names), part
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    load_jax_params(model, zeros)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in model.parameters())
    _assert_decay_mask(shapes, model)


def _assert_decay_mask(params, model):
    jmask = j_optim.weight_decay_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = {port_name(tuple(p.key for p in path), len(a.shape)): bool(d)
            for (path, a), d in zip(flat, jax.tree_util.tree_leaves(jmask))}
    got = t_optim.weight_decay_mask(model.named_parameters())
    assert got == want
    assert 0 < sum(got.values()) < len(got)


@pytest.fixture(scope="module")
def tiny():
    """JAX model and perturbed params at the tiny twin, three batches."""
    jcfg = nlq_tiny_config()
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [j_make_batch(rng, 2, jcfg) for _ in range(3)]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                 for k in INPUTS))["params"]
    return jcfg, jmodel, _perturbed(params, 7), batches


def _port_model(params):
    model = PointTransformer(nlq_flagship_config(tiny=True).model,
                             device="cpu")
    load_jax_params(model, params)
    return model


def test_nlq_make_batch_matches_jax():
    a = j_make_batch(np.random.default_rng(4), 3, nlq_tiny_config())
    b = make_batch(np.random.default_rng(4), 3, nlq_flagship_config(True))
    assert set(a) == set(b) and "text_mask" in b
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nlq_tiny_decay_mask_matches_jax(tiny):
    _, _, params, _ = tiny
    _assert_decay_mask(params, _port_model(params))


@pytest.mark.parametrize("stride,cross", [(1, True), (2, False)])
def test_nlq_transformer_block_matches_jax(rng, stride, cross):
    """A banded block (w = 4) with and without the text cross-attention,
    no channel attention, drop-path scales on."""
    B, T, L, E, H = 2, 40, 6, 32, 4
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    y = rng.standard_normal((B, L, E)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[T], [27]])
    ymask = np.arange(L)[None, :] < np.array([[L], [4]])
    jblock = j_layers.TransformerBlock(
        E, H, n_ds_stride=stride, path_drop=0.1, window=4,
        use_cross_modal=cross, use_channel_attn=False)
    jargs = [jnp.asarray(a) for a in (x, mask)]
    kw = dict(cross_y=jnp.asarray(y), cross_y_mask=jnp.asarray(ymask))
    params = jax.jit(jblock.init)(jax.random.PRNGKey(stride), *jargs,
                                  **kw)["params"]
    params = _perturbed(params, stride, 0.05)
    ref, ref_m = jax.jit(jblock.apply)({"params": params}, *jargs, **kw)
    tblock = t_layers.TransformerBlock(
        E, H, n_ds_stride=stride, path_drop=0.1, window=4,
        use_cross_modal=cross, use_channel_attn=False)
    load_jax_params(tblock, params)
    with torch.no_grad():
        out, out_m = tblock(torch.from_numpy(x), torch.from_numpy(mask),
                            None, torch.from_numpy(y),
                            torch.from_numpy(ymask))
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_nlq_point_transformer_matches_jax(tiny):
    _, jmodel, params, batches = tiny
    b = batches[0]
    ref = jax.jit(jmodel.apply)({"params": params},
                                *(jnp.asarray(b[k]) for k in INPUTS))
    model = _port_model(params).eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(b[k]) for k in INPUTS))
    assert out["gaussians"] is None and ref["gaussians"] is None
    assert out["level_lengths"] == ref["level_lengths"] == (64, 32, 16, 8)
    np.testing.assert_array_equal(out["fpn_mask"].numpy(),
                                  np.asarray(ref["fpn_mask"]))
    for key in ("cls_logits", "offsets"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)
    with pytest.raises(ValueError, match="text"):
        model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]))


def test_nlq_decode_and_nms_matches_jax():
    """The flagship's points and test_cfg (one class, 2000 candidates, 5
    picks, voting 0.9): one class gives no buckets, so both sides take the
    exact per-class path."""
    cfg = nlq_flagship_config()
    m, t = cfg.model, cfg.test_cfg
    points = _points(m)
    B, P = 3, points.shape[0]
    assert t_nms._auto_class_cap(1, t.pre_nms_topk, t.max_seg_num) is None
    assert j_nms._auto_class_cap(1, t.pre_nms_topk, t.max_seg_num) is None
    rng = np.random.default_rng(12)
    logits = (rng.standard_normal((B, P, 1)) * 2 - 3).astype(np.float32)
    offsets = (np.abs(rng.standard_normal((B, P, 2))) * 2 + 0.2).astype(
        np.float32)
    fmask = np.ones((B, P), bool)
    fmask[1, P // 3:] = False
    fmask[2] = False                       # a clip with nothing valid
    kw = dict(num_classes=1, pre_nms_topk=t.pre_nms_topk,
              pre_nms_thresh=t.pre_nms_thresh,
              duration_thresh=t.duration_thresh, max_seg_num=t.max_seg_num,
              min_score=t.min_score, nms_sigma=t.nms_sigma,
              voting_thresh=t.voting_thresh, multiclass=True)
    ref = _jax_decode(points, logits, offsets, fmask, kw, None)
    det = decode_and_nms_batch(
        torch.from_numpy(points), torch.from_numpy(logits),
        torch.from_numpy(offsets), torch.from_numpy(fmask),
        torch.ones(1, dtype=torch.bool), **kw)
    valid = det.valid.numpy()
    np.testing.assert_array_equal(valid, ref.valid)
    np.testing.assert_array_equal(valid.sum(1), ref.valid.sum(1))
    assert valid[0].sum() == t.max_seg_num and valid[2].sum() == 0
    np.testing.assert_array_equal(det.labels.numpy()[valid],
                                  ref.labels[valid])
    np.testing.assert_allclose(det.scores.numpy()[valid], ref.scores[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(det.segs.numpy()[valid], ref.segs[valid],
                               rtol=1e-5, atol=1e-5)


# leaves whose exact gradient is 0: each attention's key bias and key-norm
# bias shift all of a query row's scores alike (banded rows included), and
# the softmax ignores that; both sides hold only f32 roundoff there
ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")


def _zero_grad(name):
    return name.endswith(ZERO_GRAD)


def _cl(jax_side):
    if jax_side:
        return j_engine.CLBatchExtras(class_mask=jnp.ones((1,), bool))
    return t_engine.CLBatchExtras(torch.ones(1, dtype=torch.bool))


def test_nlq_loss_and_gradients_match_jax(tiny):
    """Label smoothing over the seen classes + 1, no Gaussian weights, the
    loss normaliser at init_loss_norm; every gradient leaf."""
    jcfg, jmodel, params, batches = tiny
    pts = _points(nlq_flagship_config(tiny=True).model)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    norm = jcfg.train_cfg.init_loss_norm

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *(jb[k] for k in INPUTS),
                           deterministic=False)
        return j_engine.compute_losses(out, jb, jnp.asarray(pts), jcfg,
                                       _cl(True), jnp.asarray(norm),
                                       "naive", 0)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    cfg = nlq_flagship_config(tiny=True)
    model = _port_model(params).train()
    tb = t_engine.batch_to(batches[0], "cpu")
    out = model(*(tb[k] for k in INPUTS))
    loss, _, _ = t_engine.compute_losses(out, tb, torch.from_numpy(pts),
                                         _cl(False), torch.tensor(norm),
                                         cfg.train_cfg)
    loss.backward()
    assert _rel(loss.item(), float(jloss)) <= 1e-5
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    # as in the MQ test, the denominator floored at 1e-4 of the largest
    # gradient, and the per-level Scale scalars at 3e-5; each Scale sums a
    # level's ~T_l cancelling terms, which can cancel far below the terms'
    # size, so its denominator is the largest Scale gradient. The leaves
    # whose exact gradient is 0 must read as roundoff on both sides, under
    # 1e-7 of the largest gradient.
    mx = lambda n: np.abs(want[n].numpy()).max()
    gmax = max(mx(n) for n in want)
    smax = max(mx(n) for n in want if n.startswith("reg_head.scale_"))
    zero = [n for n in want if _zero_grad(n)]
    assert len(zero) == 2 * 5 + 1          # 5 MaskedMHCA, 1 cross-attention
    for n in zero:
        assert max(np.abs(got[n].numpy()).max(), mx(n)) <= 1e-7 * gmax, n
    worst = {n: np.abs(got[n].numpy() - want[n].numpy()).max()
             / max(mx(n), smax if n.startswith("reg_head.scale_")
                   else 1e-4 * gmax)
             for n in want if n not in zero}
    bad = [(n, e) for n, e in worst.items()
           if e > (3e-5 if n.startswith("reg_head.scale_") else 1e-5)]
    assert not bad, bad


def test_nlq_three_step_trajectory_matches_jax(tiny):
    """Three steps of the NLQ tiny twin's train step (warmup 1 epoch, label
    smoothing 0.1, init_loss_norm 20) from the same parameters and batches,
    at the flagship's peak lr 1e-4 on both sides, at the limits of the MQ
    trajectory test. The twin's own lr 3e-3 is not used: AdamW turns the
    f32 roundoff of near-zero gradients into steps of up to lr, which at
    3e-3 moves the third step's loss past the 1e-5 limit. The leaves whose
    exact gradient is 0 (ZERO_GRAD) take such roundoff steps on both sides
    (their roundoff gradient can come near AdamW's eps 1e-8), so they are
    held to the steps AdamW can take: port and JAX within 2 x the sum of
    the lrs."""
    jcfg, jmodel, params, batches = tiny
    lr = 1e-4
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=lr))
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1))
    cfg = nlq_flagship_config(tiny=True)
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(
        cfg.opt, learning_rate=lr))
    pts = _points(cfg.model)
    jstep = j_engine.make_train_step(jmodel, tx, jnp.asarray(pts), jcfg)
    tstate = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                       device="cpu")
    tstep = t_engine.make_train_step(torch.from_numpy(pts), cfg.train_cfg,
                                     regularize=False)
    for batch in batches:
        state, jm, _ = jstep(state, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, _cl(True))
        tm = tstep(tstate, t_engine.batch_to(batch, "cpu"), _cl(False))
        assert _rel(tm["final_loss"], jm["final_loss"]) <= 1e-5
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert tstate.loss_normalizer.item() == pytest.approx(
        float(state.loss_normalizer), rel=1e-7)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    lr_sum = sum(float(tstate.opt.sched(s)) for s in range(3))
    errs = {}
    for n, p in tstate.model.named_parameters():
        if _zero_grad(n):
            assert np.abs(p.detach().numpy() - want[n].numpy()).max() \
                <= 2 * lr_sum, n
        else:
            errs[n] = _rel(p.detach().numpy(), want[n].numpy())
    adam = state.opt_state[0]
    ref = adam_state_from_jax(adam.count, jax.tree.map(np.asarray, adam.mu),
                              jax.tree.map(np.asarray, adam.nu))
    assert ref["count"] == tstate.opt.count == 3
    mu, nu = tstate.opt.moments()
    merrs = {}
    for key, got, wantm in (("mu", mu, ref["mu"]), ("nu", nu, ref["nu"])):
        floor = 1e-4 * max(np.abs(w.numpy()).max() for w in wantm.values())
        for n, mom in got.items():
            assert mom.dtype == torch.bfloat16
            w = wantm[n].numpy()
            merrs[key + ":" + n] = (np.abs(mom.float().numpy() - w).max()
                                    / max(np.abs(w).max(), floor))
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= 5e-5 and max(merrs.values()) <= 2.0 ** -6, (
        top(errs), top(merrs))


def test_nlq_entry_points_default_to_the_card():
    """The NLQ model and its train state go to the card unless asked for
    the CPU; with no card they raise instead of falling back."""
    cfg = nlq_flagship_config(tiny=True)
    if torch.cuda.is_available():
        model = PointTransformer(cfg.model)
        assert next(model.parameters()).is_cuda
        assert t_engine.init_train_state(model, cfg, SPE).loss_normalizer \
            .is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        PointTransformer(cfg.model)
    with pytest.raises((RuntimeError, AssertionError)):
        t_engine.init_train_state(PointTransformer(cfg.model, device="cpu"),
                                  cfg, SPE)
