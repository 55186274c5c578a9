"""The VQ ClipMatcher in the reference's geometry, in the port against the
JAX package on the CPU: the ROI aligns (ops/roi_align.py), the frozen-BN
conv block, the tiny ClipMatcher with frozen BN, the MAE path's grid
resize and no final ViT norm, and the query-frame ROI resample; the
frozen-BN train step, importance, penalty and checkpoints; and the
`use_query_roi` config field.

The tiny ClipMatcher is vilco_tpu/models/clip_matcher.py::tiny_clip_matcher's
geometry with one transposed-conv up step (anchor grid 4 over R = 2), at
two resizes of the ViT's patch grid to 4 x 4: from 8 x 8 (64-pixel frames,
the downsampling case, whose antialiasing JAX's own parity test never
runs) and from 2 x 2 (16-pixel frames, upsampling). JAX's parameters are
perturbed, the BN running statistics drawn as the reference's parity test
draws them (mean N(0, 0.1), var U(0.5, 2)) and the output convs redrawn at a
normal scale, then loaded into the port.

Limits: the ROI aligns and the conv block 1e-6 (f32, the same gathers and
weights); the ClipMatcher's outputs 1e-5 (f32; one ViT block and one layer
of each attention); the train step's gradients 1e-4 of each leaf's largest
against JAX's step in f64, as the group-norm model's; the penalty 1e-6.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.cl import regularizers as j_regs
from vilco_tpu.core import checkpoint as j_ckpt
from vilco_tpu.core.config import VQCfg
from vilco_tpu.models.clip_matcher import ClipMatcher as JClipMatcher
from vilco_tpu.models.clip_matcher import ConvBlock2D as JConvBlock2D
from vilco_tpu.ops import roi_align as j_roi
from vilco_tpu.train import vq_engine as j_engine
from vilco_tpu.train.engine import reg_penalty as j_reg_penalty
from vilco_tpu_torch.cl import regularizers as t_regs
from vilco_tpu_torch.core import checkpoint as t_ckpt
from vilco_tpu_torch.core.config import VQConfig
from vilco_tpu_torch.data.synthetic import make_vq_batch
from vilco_tpu_torch.models.clip_matcher import (
    ClipMatcher,
    ConvBlock2D,
    frozen_bn_stats,
)
from vilco_tpu_torch.models.convert import (
    load_jax_params,
    params_from_jax,
    reg_tasks_from_jax,
)
from vilco_tpu_torch.ops import roi_align as t_roi
from vilco_tpu_torch.tasks import vq as t_vq
from vilco_tpu_torch.train import vq_engine as t_engine
from vilco_tpu_torch.train.engine import batch_to

ROI_ATOL = 1e-6
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
STATS = ("bn_mean", "bn_var")

# tiny_clip_matcher's geometry, one up step, the grid resized to 4 x 4
TINY = dict(dim=32, patch_size=8, vit_dim=24, vit_depth=1, vit_heads=2,
            resolution_transformer=2, resolution_anchor_feat=4,
            num_transformer=1, window_transformer=3, num_frames=3)
INTERP = 4
RESIZES = {"down_8_to_4": 64, "up_2_to_4": 16}     # frame side per case
BOXES = np.array([[0.1, 0.2, 0.7, 0.9], [0.3, 0.05, 0.95, 0.6]], np.float32)


# ----------------------------------------------------------- ROI align

FEATS_2D = (2, 6, 7, 3)
ROIS_2D = {
    "inside": [0, 1.2, 0.7, 4.5, 5.1],
    "on_the_border": [1, 0.0, 0.0, 7.0, 6.0],
    "outside": [0, -3.0, -2.5, -1.6, -1.2],
    "across_the_far_border": [1, 5.5, 4.5, 9.0, 8.0],
    "degenerate": [0, 2.0, 3.0, 2.0, 3.0],
}


@pytest.mark.parametrize("case", sorted(ROIS_2D))
def test_roi_align_2d_matches_jax(case):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal(FEATS_2D).astype(np.float32)
    rois = np.array([ROIS_2D[case]], np.float32)
    want = np.asarray(j_roi.roi_align_2d(jnp.asarray(feats),
                                         jnp.asarray(rois), (3, 4)))
    got = t_roi.roi_align_2d(torch.from_numpy(feats), torch.from_numpy(rois),
                             (3, 4)).numpy()
    assert got.shape == want.shape == (1, 3, 4, 3)
    if case == "outside":
        assert not want.any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROI_ATOL)


ROIS_1D = {
    "inside": [0, 1.3, 6.2],
    "on_the_border": [1, 0.0, 8.0],
    "outside": [0, -4.0, -1.0],
    "degenerate": [1, 3.0, 3.0],
}


@pytest.mark.parametrize("case", sorted(ROIS_1D))
def test_roi_align_1d_and_its_gradient_match_jax(case):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 9, 4)).astype(np.float32)
    rois = np.array([ROIS_1D[case]], np.float32)
    cot = rng.standard_normal((1, 5, 4)).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda f: (j_roi.roi_align_1d(
        f, jnp.asarray(rois), 5) * cot).sum())(jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_(True)
    out = t_roi.roi_align_1d(x, torch.from_numpy(rois), 5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(j_roi.roi_align_1d(jnp.asarray(feats), jnp.asarray(rois),
                                      5)), rtol=0, atol=ROI_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=ROI_ATOL)


# ----------------------------------------------------------- grid resize


@pytest.mark.parametrize("n", [28, 4])
def test_grid_resize_follows_jax_with_antialias(n):
    """The MAE path's resize of an n x n patch grid to 16 x 16: JAX's
    jax.image.resize ("bilinear", antialias on by default) against
    F.interpolate(align_corners=False), the reference's call. Downsampling
    (the full width's 28 -> 16), they agree only with antialias=True
    (1.6487 apart without it, on this seeded grid); upsampling (4 -> 16),
    either way."""
    x = np.random.default_rng(0).standard_normal((1, n, n, 8)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 16, 16, 8),
                                       "bilinear"))

    def torch_resize(antialias):
        return F.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(16, 16),
            mode="bilinear", align_corners=False, antialias=antialias,
        ).permute(0, 2, 3, 1).numpy()

    assert np.abs(torch_resize(True) - want).max() <= ROI_ATOL
    plain = np.abs(torch_resize(False) - want).max()
    assert plain > 1.0 if n > 16 else plain <= ROI_ATOL


# ----------------------------------------------------------- frozen BN


def _draw_bn(tree, rng):
    """The BN leaves of a Flax tree drawn as the reference's parity test
    draws them (running mean N(0, 0.1), var U(0.5, 2)), scale U(0.5, 1.5)
    and bias N(0, 0.1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _draw_bn(v, rng)
            continue
        n = np.shape(v)
        out[k] = {"bn_mean": lambda: rng.normal(0, 0.1, n),
                  "bn_var": lambda: rng.uniform(0.5, 2.0, n),
                  "bn_scale": lambda: rng.uniform(0.5, 1.5, n),
                  "bn_bias": lambda: rng.normal(0, 0.1, n)}.get(
                      k, lambda: np.asarray(v))()
        out[k] = np.asarray(out[k], np.float32)
    return out


def test_frozen_bn_conv_block_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    for stride in (1, 2):
        jblock = JConvBlock2D(16, stride=stride, norm="frozen_bn")
        params = _draw_bn(jax.tree.map(np.asarray, jblock.init(
            jax.random.PRNGKey(0), jnp.asarray(x))["params"]), rng)
        want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
        block = ConvBlock2D(8, 16, stride=stride, norm="frozen_bn")
        load_jax_params(block, params)
        assert {n for n, _ in block.named_buffers()} == set(STATS)
        assert not any(b.requires_grad for b in block.buffers())
        with torch.no_grad():
            got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=ROI_ATOL)


# ----------------------------------------------------------- the ClipMatcher


def _cfgs(side: int):
    """(JAX ClipMatcher, port VQConfig) of the tiny reference geometry on
    frames of `side` pixels."""
    jmodel = JClipMatcher(clip_size=side, **TINY, compute_dtype="float32",
                          norm="frozen_bn", interp_feat_to=INTERP,
                          vit_final_norm=False, use_query_roi=True)
    cfg = VQConfig(clip_size=side, query_size=side, use_query_roi=True,
                   **TINY)
    return jmodel, cfg


def _jax_params(jmodel, side: int, seed: int):
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, TINY["num_frames"], side,
                                             side, 3)),
        jnp.zeros((1, side, side, 3)), deterministic=True)["params"])
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    params = _draw_bn(params, rng)
    for name in ("reg_head", "cls_head"):
        for leaf in ("kernel", "bias"):
            a = params["head"][name][leaf]
            params["head"][name][leaf] = (0.05 * rng.standard_normal(
                a.shape)).astype(np.float32)
    return params


def _port(cfg, params, **kw):
    model = ClipMatcher(cfg, device="cpu", compute_dtype=torch.float32,
                        norm="frozen_bn", interp_feat_to=INTERP,
                        vit_final_norm=False, **kw)
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module", params=sorted(RESIZES))
def reference_geometry(request):
    side = RESIZES[request.param]
    jmodel, cfg = _cfgs(side)
    params = _jax_params(jmodel, side, 0)
    batch = make_vq_batch(np.random.default_rng(30), 2, cfg)
    return request.param, jmodel, cfg, params, batch


def test_reference_geometry_builds_as_jax(reference_geometry):
    """No final ViT norm, frozen-BN blocks with their statistics as
    buffers, one down head to R = 2, the patch grid resized to 4 x 4; the
    state_dict is JAX's tree."""
    _, jmodel, cfg, params, batch = reference_geometry
    model = _port(cfg, params)
    assert model.backbone.norm is None and model.n_down == 1
    assert len(frozen_bn_stats(model)) == 2 * (2 + 1 + 1 + 6)
    want = params_from_jax(params)
    assert set(model.state_dict()) == set(want)
    with torch.no_grad():
        grid = model.extract(torch.from_numpy(batch["query"]))
    assert grid.shape == (2, INTERP, INTERP, cfg.vit_dim)


@pytest.mark.parametrize("boxes", [False, True])
def test_reference_geometry_matches_jax(reference_geometry, boxes):
    """The forward with frozen BN, the resized grid and no final ViT norm,
    with and without query-frame boxes (ROI on): every output at 1e-5."""
    case, jmodel, cfg, params, batch = reference_geometry
    kw = {"query_frame_bbox": BOXES} if boxes else {}
    ref = jax.jit(lambda p, c, q, **k: jmodel.apply(
        {"params": p}, c, q, deterministic=True, **k))(
            params, jnp.asarray(batch["clip"]), jnp.asarray(batch["query"]),
            **{k: jnp.asarray(v) for k, v in kw.items()})
    model = _port(cfg, params).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["clip"]),
                    torch.from_numpy(batch["query"]),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert out["prob"].shape == (2, cfg.num_frames, 4 * 4 * 12)
    for k in ("center", "hw", "bbox", "prob"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=f"{case} {k}", **OUT_TOL)
    if boxes:       # the boxes move the outputs: the ROI path ran
        with torch.no_grad():
            plain = model(torch.from_numpy(batch["clip"]),
                          torch.from_numpy(batch["query"]))
        assert (plain["prob"] - out["prob"]).abs().max() > 1e-3


def test_query_roi_is_read_only_with_the_config_flag(reference_geometry):
    _, _, cfg, params, batch = reference_geometry
    model = _port(dataclasses.replace(cfg, use_query_roi=False), params)
    clip, query = (torch.from_numpy(batch[k]) for k in ("clip", "query"))
    with torch.no_grad():
        a = model(clip, query)["prob"]
        b = model(clip, query, query_frame_bbox=torch.from_numpy(BOXES))
    assert torch.equal(a, b["prob"])


# ----------------------------------------------------------- training


def _jax_loss(jmodel, p, batch):
    preds = jmodel.apply({"params": p}, batch["clip"], batch["query"],
                         hnm=True, deterministic=True)
    gts = j_engine.replicate_for_hnm(
        {k: batch[k] for k in t_engine.GT_KEYS}, batch["clip"].shape[0])
    return j_engine.vq_losses(preds, gts)[0]


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jmodel64(side):
    return JClipMatcher(clip_size=side, **TINY, compute_dtype="float64",
                        norm="frozen_bn", interp_feat_to=INTERP,
                        vit_final_norm=False, use_query_roi=True)


def test_frozen_bn_train_step_matches_jax(reference_geometry):
    """One HNM step (dropout off): every trainable leaf's gradient against
    JAX's in f64; the statistics take no gradient and no update in the
    port, and JAX's step (set_to_zero on them) leaves them too; the clip
    norm is over the trainable leaves only."""
    case, _, cfg, params, batch = reference_geometry
    side = cfg.clip_size
    with jax.enable_x64(True):
        jm = _jmodel64(side)
        jb = _f64(batch)
        jgrads = jax.jit(jax.grad(lambda p: _jax_loss(jm, p, jb)))(
            _f64(params))
        want = params_from_jax(jax.tree.map(
            lambda a: np.asarray(a, np.float64), jgrads))
        tx = j_engine.make_vq_optimizer(cfg.lr, cfg.weight_decay,
                                        grad_max=cfg.grad_max)
        jp = _f64(params)
        state = j_engine.VQTrainState(
            step=jnp.zeros((), jnp.int32), params=jp,
            opt_state=tx.init(jp), rng=jax.random.PRNGKey(1))
        jstep = j_engine.make_vq_train_step(jm, tx, use_hnm=True,
                                            deterministic=True)
        state, jmet = jstep(state, jb)
        after = params_from_jax(jax.tree.map(np.asarray, state.params))
    src = params_from_jax(params)
    st = t_engine.init_vq_train_state(_port(cfg, params), cfg, device="cpu")
    stats = dict(frozen_bn_stats(st.model))
    assert not set(stats) & set(st.opt.names)
    met = t_engine.make_vq_train_step(cfg, deterministic=True)(
        st, batch_to(batch, "cpu"))
    assert abs(float(met["final_loss"]) - float(jmet["final_loss"])) <= (
        1e-5 * abs(float(jmet["final_loss"])))
    got = {n: p.grad.numpy() for n, p in zip(st.opt.names, st.opt.params)}
    trainable = {n for n in want if not n.startswith("backbone.")
                 and n.rsplit(".", 1)[-1] not in STATS}
    assert set(got) == trainable
    gmax = max(np.abs(want[n].numpy()).max() for n in got)
    bad = {n: float(np.abs(got[n] - want[n].numpy()).max()
                    / max(np.abs(want[n].numpy()).max(), 1e-4 * gmax))
           for n in got}
    assert max(bad.values()) <= GRAD_RTOL, max(bad.items(),
                                               key=lambda kv: kv[1])
    for n, b in stats.items():
        assert b.grad is None and torch.equal(b, src[n]), n
        assert torch.equal(after[n], src[n]), n
    moved = [n for n in st.opt.names if n.endswith(("bn_scale", "bn_bias"))
             and not torch.equal(dict(st.model.named_parameters())[n],
                                 src[n])]
    assert len(moved) == len(stats)      # a scale and a bias a block


def test_frozen_bn_importance_and_penalty_match_jax(reference_geometry):
    """The EWC importance of the runner (JAX's: the square of the last
    batch's gradient, the statistics' included, the frozen ViT's 0), and
    the penalty over a task whose statistics did not drift: JAX gives them
    a zero share, and the port's value equals JAX's."""
    _, jmodel, cfg, params, batch = reference_geometry
    with jax.enable_x64(True):
        jm = _jmodel64(cfg.clip_size)

        def loss(p):
            preds = jm.apply({"params": p}, batch["clip"], batch["query"],
                             deterministic=True)
            return j_engine.vq_losses(
                preds, {k: batch[k] for k in t_engine.GT_KEYS})[0]

        g = jax.jit(jax.grad(loss))(_f64(params))
        want = params_from_jax(jax.tree.map(
            lambda a: np.asarray(a, np.float64) ** 2, g))
    model = _port(cfg, params)
    runner = types.SimpleNamespace(
        model=model, method="ewc", batch_size=2, reg_list=[],
        _train_batches=lambda *a, **k: iter([batch]),
        _to_device=lambda b: batch_to(b, "cpu"))
    t_vq.VQEpisodeRunner._estimate_importance(runner, None, None)
    (imp, optpar), = runner.reg_list
    assert set(imp) == set(optpar) == set(want)
    assert all(not imp[n].any() for n in imp if n.startswith("backbone."))
    top = max(float(w.abs().max()) for w in want.values())
    for n in imp:
        if n.startswith("backbone."):
            continue
        err = float((imp[n].double() - want[n]).abs().max())
        assert err <= GRAD_RTOL * max(float(want[n].abs().max()),
                                      1e-4 * top), n
    assert all(float(want[f"head.in_conv.{s}"].abs().max()) > 0
               for s in STATS)
    assert not any(b.requires_grad for _, b in frozen_bn_stats(model))

    # a task whose trainable leaves moved and whose statistics did not
    rng = np.random.default_rng(9)
    imp_j = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32),
                         params)

    def moved(path, a):
        if str(getattr(path[-1], "key", "")) in STATS:
            return np.asarray(a)
        return (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)

    opt_j = jax.tree_util.tree_map_with_path(moved, params)
    reg = [(imp_j, opt_j)]
    fisher, opar = j_regs.stack_reg_tasks(reg)
    val, jg = jax.value_and_grad(lambda p: j_reg_penalty(
        p, fisher, opar, 3000.0))(jax.tree.map(jnp.asarray, params))
    jg = params_from_jax(jax.tree.map(np.asarray, jg))
    assert all(not jg[n].any() for n in jg if n.rsplit(".", 1)[-1] in STATS)
    model = _port(cfg, params)
    opt = t_engine.make_vq_optimizer(model, cfg)
    pen = t_regs.RegPenalty.for_optimizer(reg_tasks_from_jax(reg), opt,
                                          3000.0, model=model)
    got = pen.apply(opt.param_flat, opt.grad_flat).item()
    assert abs(got - float(val)) <= 1e-6 * abs(float(val))


def test_frozen_bn_checkpoints_round_trip_both_ways(reference_geometry,
                                                    tmp_path):
    """The port's task checkpoint holds the statistics beside the
    parameters (JAX's tree holds both): written by the port and read back,
    bit-equal, and read by JAX's reader as the same container; JAX's Flax
    tree written by JAX's writer and read by the port, bit-equal."""
    _, _, cfg, params, _ = reference_geometry
    model = _port(cfg, params)
    runner = types.SimpleNamespace(model=model)
    flat = t_vq.VQEpisodeRunner.params_numpy(runner)
    assert set(flat) == set(model.state_dict())
    path = str(tmp_path / "vq_task_000.ckpt")
    t_ckpt.save_checkpoint(path, {"params": flat, "task": 0})
    jread = j_ckpt.load_checkpoint(path)
    assert set(jread["params"]) == set(flat)
    assert all(np.array_equal(jread["params"][k], flat[k]) for k in flat)
    fresh = _port(cfg, _jax_params(_cfgs(cfg.clip_size)[0],
                                   cfg.clip_size, 5))
    t_vq.VQEpisodeRunner.set_params(types.SimpleNamespace(model=fresh),
                                    t_ckpt.params_of(
                                        t_ckpt.load_checkpoint(path)))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    fresh2 = _port(cfg, _jax_params(_cfgs(cfg.clip_size)[0],
                                    cfg.clip_size, 6))
    assert t_ckpt.load_params_into(path, fresh2) == len(flat)
    assert all(torch.equal(fresh2.state_dict()[k], v)
               for k, v in model.state_dict().items())
    jpath = str(tmp_path / "jax.ckpt")
    j_ckpt.save_checkpoint(jpath, {"params": params, "task": 0})
    got = t_ckpt.params_of(t_ckpt.load_checkpoint(jpath))
    want = params_from_jax(params)
    assert set(got) == set(model.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_vq_config_accepts_use_query_roi_as_jax():
    cfg = VQConfig(use_query_roi=True)
    assert cfg.use_query_roi
    assert cfg.to_dict() == VQCfg(use_query_roi=True).to_dict()
    assert VQConfig.from_dict(cfg.to_dict()) == cfg
