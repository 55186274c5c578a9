"""The port's MQ train step against the JAX package's, on the CPU, at the
tiny twin of the flagship (XL stage on, f32 compute).

The same numpy batches and the same perturbed parameters go through both.
JAX runs its train step with `deterministic=False`; drop-path and XL
dropout are switched off on both sides (the JAX `_drop_path` patched to the
identity and `xl_dropout=0`, the port's step with regularize=False), since
the two frameworks' random streams cannot be matched. Tolerances: loss and
every gradient leaf 1e-5 (max|port - jax| / max|jax| over the leaf, f32
summed in another order); the 3-step trajectory as stated at its test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.layers as j_layers
from __graft_entry__ import _flagship_cfg
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.ops import assign as j_assign
from vilco_tpu.ops import losses as j_losses
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.core.config import flagship_config
from vilco_tpu_torch.data.synthetic import make_batch
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
from vilco_tpu_torch.ops.assign import generate_points, label_points
from vilco_tpu_torch.ops.losses import ctr_diou_loss_1d, sigmoid_focal_loss
from vilco_tpu_torch.train import engine as t_engine
from vilco_tpu_torch.train import optim as t_optim

SPE = 1   # steps per epoch: the warmup reaches lr > 0 from the second step


def _jcfg(xl_dropout=0.0):
    cfg = _flagship_cfg(tiny=True)
    return cfg.updated(model=cfg.model.updated(
        use_xl=True, compute_dtype="float32", xl_dropout=xl_dropout))


def _points(cfg):
    return generate_points(level_lengths(cfg), cfg.fpn_strides,
                           cfg.regression_range)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_make_batch_matches_jax():
    jcfg = _jcfg()
    a = j_make_batch(np.random.default_rng(4), 3, jcfg)
    b = make_batch(np.random.default_rng(4), 3, flagship_config(tiny=True))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _gt(B=3, N=6):
    """GT with a video that has none (row 2) and a zero-length pad row."""
    rng = np.random.default_rng(2)
    segs = np.sort(rng.uniform(0, 60, (B, N, 2)), axis=-1).astype(np.float32)
    labels = rng.integers(0, 12, (B, N))
    valid = np.ones((B, N), bool)
    valid[0, 4:] = False
    segs[0, 5] = (7.0, 7.0)
    valid[2] = False
    return segs, labels, valid


def test_label_points_and_losses_match_jax():
    cfg = flagship_config(tiny=True).model
    pts = _points(cfg)
    segs, labels, valid = _gt()
    rng = np.random.default_rng(3)
    C = cfg.num_classes
    gauss = tuple((rng.standard_normal(C) * 0.2 + c).astype(np.float32)
                  for c in (0.0, 1.0, -0.5, 1.0, 0.5, 1.0))
    ref = j_assign.label_points(
        jnp.asarray(pts), jnp.asarray(segs), jnp.asarray(labels),
        jnp.asarray(valid), C, tuple(map(jnp.asarray, gauss)),
        center_sample="radius", center_sample_radius=1.5)
    got = label_points(torch.from_numpy(pts), torch.from_numpy(segs),
                       torch.from_numpy(labels), torch.from_numpy(valid), C,
                       tuple(map(torch.from_numpy, gauss)), 1.5)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert got.pos_mask[0].any() and not got.pos_mask[2].any()
    P = pts.shape[0]
    logits = rng.standard_normal((3, P, C)).astype(np.float32) * 3
    tgt = np.asarray(ref.cls)
    np.testing.assert_allclose(
        sigmoid_focal_loss(torch.from_numpy(logits),
                           torch.from_numpy(tgt)).numpy(),
        np.asarray(j_losses.sigmoid_focal_loss(jnp.asarray(logits),
                                               jnp.asarray(tgt))),
        rtol=1e-6, atol=1e-7)
    off = np.abs(rng.standard_normal((3, P, 2))).astype(np.float32)
    reg = np.maximum(np.asarray(ref.reg), 0.0)
    np.testing.assert_allclose(
        ctr_diou_loss_1d(torch.from_numpy(off), torch.from_numpy(reg)).numpy(),
        np.asarray(j_losses.ctr_diou_loss_1d(jnp.asarray(off),
                                             jnp.asarray(reg))),
        rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """JAX model and perturbed params, the port model loaded from them, two
    batches and the points."""
    jcfg = _jcfg()
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [j_make_batch(rng, 2, jcfg) for _ in range(3)]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0]["feats"]),
                                  jnp.asarray(batches[0]["mask"]))["params"]
    prng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * prng.standard_normal(
        np.shape(a)).astype(np.float32), params)
    return jcfg, jmodel, params, batches


def _port_model(params):
    model = PointTransformer(flagship_config(tiny=True).model, device="cpu")
    load_jax_params(model, params)
    return model


def test_weight_decay_mask_matches_jax(tiny):
    _, _, params, _ = tiny
    jmask = j_optim.weight_decay_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    mflat = jax.tree_util.tree_leaves(jmask)
    want = {port_name(tuple(p.key for p in path), np.ndim(a)): bool(m)
            for (path, a), m in zip(flat, mflat)}
    got = t_optim.weight_decay_mask(_port_model(params).named_parameters())
    assert got == want
    assert 0 < sum(got.values()) < len(got)


def test_schedule_matches_jax():
    jsched = j_optim.make_schedule(_flagship_cfg().opt, 7)
    sched = t_optim.make_schedule(flagship_config().opt, 7)
    for s in (0, 1, 5, 17, 34, 35, 36, 60, 90, 104, 105):
        np.testing.assert_allclose(sched(s), float(jsched(s)), rtol=1e-6,
                                   err_msg=str(s))


def _jax_loss_and_grads(jcfg, jmodel, params, batch, norm=100.0):
    pts = jnp.asarray(_points(jcfg.model))
    cl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jb["feats"], jb["mask"],
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        loss, _, _ = j_engine.compute_losses(
            out, jb, pts, jcfg, cl, jnp.asarray(norm), "naive", 0)
        return loss

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def test_loss_and_gradients_match_jax(tiny, monkeypatch):
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    jcfg, jmodel, params, batches = tiny
    jloss, jgrads = _jax_loss_and_grads(jcfg, jmodel, params, batches[0])
    model = _port_model(params).train()
    pts = torch.from_numpy(_points(model.cfg))
    tb = t_engine.batch_to(batches[0], "cpu")
    out = model(tb["feats"], tb["mask"])
    cl = t_engine.CLBatchExtras(torch.ones(12, dtype=torch.bool))
    loss, _, _ = t_engine.compute_losses(out, tb, pts, cl,
                                         torch.tensor(100.0),
                                         flagship_config().train_cfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    # max|port - jax| / max|jax| per leaf. Two kinds of leaf are held
    # apart: where the exact gradient is 0 (the key projection's and key
    # norm's biases: softmax ignores a shift common to a row's scores) both
    # sides hold f32 roundoff only, 1e-15 to 1e-11 here, so the denominator
    # is floored at 1e-4 of the model's largest gradient; the per-level
    # `Scale` scalars sum ~P cancelling terms and get 3e-5.
    floor = 1e-4 * max(np.abs(w.numpy()).max() for w in want.values())
    worst = {n: np.abs(got[n].numpy() - want[n].numpy()).max()
             / max(np.abs(want[n].numpy()).max(), floor) for n in want}
    bad = [(n, e) for n, e in worst.items()
           if e > (3e-5 if n.startswith("reg_head.scale_") else 1e-5)]
    assert not bad, bad


def test_three_step_trajectory_matches_jax(tiny, monkeypatch):
    """Three train steps from the same parameters and batches: the loss and
    the clipped-norm input (the global grad norm) of each step within 1e-5
    relative; after step 3 every parameter leaf within 5e-5 of its largest
    value (AdamW divides by sqrt(v), so an f32 difference in a small
    gradient moves a parameter by up to lr; 8.8e-6 measured), the bf16
    moments within two bf16 steps (2^-6) of the leaf's largest value, with
    the denominator floored at 1e-4 of the tree's largest moment for the
    leaves whose gradient is 0 (a gradient that differs in its last f32
    bits can round to the next bf16 value, and the step carries over:
    0.0106 measured), the loss normaliser to 1e-7."""
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    jcfg, jmodel, params, batches = tiny
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1))
    pts = _points(jcfg.model)
    jstep = j_engine.make_train_step(jmodel, tx, jnp.asarray(pts), jcfg)
    jcl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))

    cfg = flagship_config(tiny=True)
    tstate = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                       device="cpu")
    tstep = t_engine.make_train_step(torch.from_numpy(pts), cfg.train_cfg,
                                     regularize=False)
    tcl = t_engine.CLBatchExtras(torch.ones(12, dtype=torch.bool))
    for batch in batches:
        state, jm, _ = jstep(state, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcl)
        tm = tstep(tstate, t_engine.batch_to(batch, "cpu"), tcl)
        assert _rel(tm["final_loss"], jm["final_loss"]) <= 1e-5
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert tstate.loss_normalizer.item() == pytest.approx(
        float(state.loss_normalizer), rel=1e-7)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    errs = {n: _rel(p.detach().numpy(), want[n].numpy())
            for n, p in tstate.model.named_parameters()}
    adam = state.opt_state[0]
    ref = adam_state_from_jax(adam.count, jax.tree.map(np.asarray, adam.mu),
                              jax.tree.map(np.asarray, adam.nu))
    assert ref["count"] == tstate.opt.count == 3
    mu, nu = tstate.opt.moments()
    merrs = {}
    for key, got, wantm in (("mu", mu, ref["mu"]), ("nu", nu, ref["nu"])):
        floor = 1e-4 * max(np.abs(w.numpy()).max() for w in wantm.values())
        for n, m in got.items():
            assert m.dtype == torch.bfloat16
            w = wantm[n].numpy()
            merrs[key + ":" + n] = (np.abs(m.float().numpy() - w).max()
                                    / max(np.abs(w).max(), floor))
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= 5e-5 and max(merrs.values()) <= 2.0 ** -6, (
        top(errs), top(merrs))


def test_regularised_step_is_seeded_and_finite(tiny):
    _, _, params, batches = tiny
    cfg = flagship_config(tiny=True)
    pts = torch.from_numpy(_points(cfg.model))
    step = t_engine.make_train_step(pts, cfg.train_cfg, regularize=True)
    cl = t_engine.CLBatchExtras(torch.ones(12, dtype=torch.bool))
    runs = []
    for seed in (5, 5, 6):
        st = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                       seed=seed, device="cpu")
        b = t_engine.batch_to(batches[0], "cpu")
        losses = [step(st, b, cl)["final_loss"].item() for _ in range(2)]
        runs.append((losses, [p.detach().clone()
                              for p in st.model.parameters()]))
    assert all(np.isfinite(runs[0][0]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0][1] != runs[2][0][1]


def test_entry_points_default_to_the_card():
    """PointTransformer and the train state go to the card unless asked
    for the CPU; with no card they raise instead of falling back."""
    full = flagship_config(tiny=True)
    cfg = full.model
    if torch.cuda.is_available():
        model = PointTransformer(cfg)
        assert next(model.parameters()).is_cuda
        st = t_engine.init_train_state(model, full, SPE)
        assert st.loss_normalizer.is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        PointTransformer(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        t_engine.init_train_state(PointTransformer(cfg, device="cpu"), full,
                                  SPE)
