"""The port's VQ flagship (ClipMatcher serving and the HNM train step)
against the JAX package on the CPU.

The config equals configs/vq_vilco.yaml's `vq` section; the full-width
ClipMatcher tree (jax.eval_shape) loads strictly. The tiny twin
(vq_flagship_config(tiny=True): 8 x 8 patches, one stride-2 down head, one
transposed-conv up step) is initialised in JAX in f32, its parameters
perturbed and its two output convs redrawn at a normal scale (at their
N(0, 1e-6) init every output would equal its bias), then loaded into the
port; the same numpy inputs go through both. Outputs are compared as the
deltas (the box before the anchors are added) and the logits. Tolerances:
the model 1e-4 (f32, ~10 layers summed in another order), the anchors and
the response track exact where they are integers. The gradients and the
3-step trajectory are held to the JAX step run in float64: in f32 Flax's
one-pass GroupNorm variance puts JAX's own gradient of reduce1 6.6e-4 off
its f64 value, where the port's two-pass one reads 4e-6. Every loss term
and every trainable gradient leaf 1e-4 relative to the leaf's largest value
(floored at 1e-4 of the largest gradient); the trajectory's losses 1e-5,
and its parameters as AdamW allows: an element whose gradient is near 0
(the key biases' is exactly 0: they shift a query's scores alike) takes
steps of up to lr from f32 roundoff alone, so every element within twice
the summed lr, and every other element (its first-step gradient above
1e-5 of its leaf's largest; that gradient is the one held to JAX above)
within 5e-6.
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vilco_tpu.core.config import load_config
from vilco_tpu.evals import vq_metrics as j_metrics
from vilco_tpu.models.clip_matcher import ClipMatcher as JClipMatcher
from vilco_tpu.models.vit import ViT as JViT
from vilco_tpu.ops import anchors as j_anchors
from vilco_tpu.tasks.vq import VQEpisodeRunner
from vilco_tpu.train import vq_engine as j_engine
from vilco_tpu_torch.core.config import vq_flagship_config
from vilco_tpu_torch.data.synthetic import make_vq_batch
from vilco_tpu_torch.evals import vq_metrics as t_metrics
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.models.convert import load_jax_params, params_from_jax
from vilco_tpu_torch.models.vit import ViT
from vilco_tpu_torch.ops import anchors as t_anchors
from vilco_tpu_torch.tasks.vq import predict_track
from vilco_tpu_torch.train import vq_engine as t_engine
from vilco_tpu_torch.train.engine import batch_to

YAML = "configs/vq_vilco.yaml"
TOL = dict(rtol=1e-4, atol=1e-4)
# JAX ClipMatcher fields the port's config carries under the same names
MODEL_FIELDS = ("dim", "clip_size", "patch_size", "vit_dim", "vit_depth",
                "vit_heads", "resolution_transformer",
                "resolution_anchor_feat", "num_transformer",
                "window_transformer", "num_frames", "freeze_backbone")


def _jax_model(cfg, compute_dtype="float32"):
    return JClipMatcher(**{f: getattr(cfg, f) for f in MODEL_FIELDS},
                        compute_dtype=compute_dtype, dropout=cfg.dropout)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _np64(tree):
    return params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float64), tree))


def test_vq_config_matches_jax():
    ref = load_config(YAML).vq
    port = vq_flagship_config()
    for f in dataclasses.fields(port):
        if hasattr(ref, f.name):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert ref.accumulation_steps == 1 and not ref.use_query_roi
    assert ref.query_size == port.clip_size
    # what the episode runner and the model fix
    run = inspect.signature(VQEpisodeRunner.__init__).parameters
    assert port.eval_windows == run["eval_windows"].default == 8
    assert port.grad_max == run["grad_max"].default
    assert port.lr_milestones == run["lr_milestones"].default
    assert port.lr_gamma == run["lr_gamma"].default
    assert port.dropout == JClipMatcher.dropout
    tiny = vq_flagship_config(tiny=True)
    assert tiny.clip_size // tiny.patch_size == 2 * tiny.resolution_transformer
    assert tiny.resolution_anchor_feat == 2 * tiny.resolution_transformer


def _flagship_shapes():
    cfg = vq_flagship_config()
    S = cfg.clip_size
    spec = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    return jax.eval_shape(_jax_model(cfg).init, jax.random.PRNGKey(0),
                          spec(1, 1, S, S, 3), spec(1, S, S, 3))["params"]


def test_vq_flagship_tree_loads_strictly():
    """Every leaf of the full-width JAX tree (the ViT-B/14, two down heads,
    three st layers, one up step) lands on a port parameter of its
    shape."""
    shapes = _flagship_shapes()
    leaves = jax.tree_util.tree_leaves(shapes)
    model = ClipMatcher(vq_flagship_config(), device="cpu")
    names = dict(model.named_parameters())
    assert len(names) == len(leaves)
    assert sum(p.numel() for p in names.values()) == sum(
        int(np.prod(a.shape)) for a in leaves)
    assert names["backbone.pos_embed"].shape == (1, 1025, 768)
    assert names["head.up_0.weight"].shape == (256, 256, 4, 4)
    assert names["pe_3d"].shape == (1, 30 * 64, 256)
    for part in ("down_1.conv.weight", "st_2.qkv.weight", "block_11.fc2",
                 "cq_corr.cross_v.weight", "head.cls_2.norm.weight"):
        assert any(part in n for n in names), part
    frozen = [n for n, p in names.items() if not p.requires_grad]
    assert frozen and all(n.startswith("backbone.") for n in frozen)
    assert all(p.requires_grad for n, p in names.items()
               if not n.startswith("backbone."))
    load_jax_params(model, jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    assert all(float(p.detach().abs().max()) == 0.0
               for p in model.parameters())


def test_anchors_match_jax():
    for size, res in ((448, 16), (64, 8)):
        a = t_anchors.generate_anchors(size, res)
        np.testing.assert_array_equal(a, j_anchors.generate_anchors(size,
                                                                    res))
        np.testing.assert_array_equal(t_anchors.xyhw_to_xyxy(a),
                                      j_anchors.xyhw_to_xyxy(a))
    rng = np.random.default_rng(3)
    anchors = t_anchors.xyhw_to_xyxy(t_anchors.generate_anchors(64, 8) / 64)
    c = rng.uniform(0.2, 0.8, (2, 3, 2))
    s = rng.uniform(0.1, 0.5, (2, 3, 2))
    gt = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    pred = (np.concatenate([c, c], -1)[..., None, :]
            + rng.normal(0, 0.2, (2, 3, 5, 4))).astype(np.float32)
    ta, tg = torch.from_numpy(anchors), torch.from_numpy(gt)
    np.testing.assert_allclose(
        t_anchors.box_iou(ta[None, None], tg).numpy(),
        np.asarray(j_anchors.box_iou(jnp.asarray(anchors)[None, None],
                                     jnp.asarray(gt))), rtol=1e-6, atol=1e-7)
    for thr in (0.2, 0.95):   # 0.95: no anchor passes, the top-k fallback
        got = t_anchors.assign_anchor_labels(ta, tg, thr, 5).numpy()
        want = np.asarray(j_anchors.assign_anchor_labels(
            jnp.asarray(anchors), jnp.asarray(gt), thr, 5))
        np.testing.assert_array_equal(got, want)
        assert got.any()
    assert t_anchors.assign_anchor_labels(ta, tg, 0.95, 5).sum() == 5
    for got, want in zip(
            t_anchors.giou(torch.from_numpy(pred), tg[..., None, :]),
            j_anchors.giou(jnp.asarray(pred), jnp.asarray(gt)[..., None, :])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def _perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def test_vit_matches_jax(rng):
    cfg = vq_flagship_config(tiny=True)
    S = cfg.clip_size
    x = rng.random((3, S, S, 3), np.float32)
    jvit = JViT(cfg.patch_size, cfg.vit_dim, cfg.vit_depth, cfg.vit_heads)
    params = _perturbed(jax.jit(jvit.init)(jax.random.PRNGKey(1),
                                           jnp.asarray(x))["params"], 2)
    ref = jax.jit(jvit.apply)({"params": params}, jnp.asarray(x))
    for fused_mlp in (False, True):
        vit = ViT(cfg.patch_size, cfg.vit_dim, cfg.vit_depth, cfg.vit_heads,
                  S, use_fused_mlp=fused_mlp)
        load_jax_params(vit, params)
        with torch.no_grad():
            out = vit(torch.from_numpy(x))
        assert out.shape == (3, S // cfg.patch_size, S // cfg.patch_size,
                             cfg.vit_dim)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny twin, its perturbed params with the output convs
    redrawn at scale 0.05, and three batches of two clips."""
    cfg = vq_flagship_config(tiny=True)
    jmodel = _jax_model(cfg)
    S = cfg.clip_size
    params = jax.jit(lambda k, c, q: jmodel.init(k, c, q, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, S, S, 3)),
        jnp.zeros((1, S, S, 3)))["params"]
    params = _perturbed(params, 5)
    rng = np.random.default_rng(11)
    for name in ("reg_head", "cls_head"):
        for leaf in ("kernel", "bias"):
            a = params["head"][name][leaf]
            params["head"][name][leaf] = (0.05 * rng.standard_normal(
                a.shape)).astype(np.float32)
    batches = [make_vq_batch(np.random.default_rng(20 + i), 2, cfg)
               for i in range(3)]
    return cfg, jmodel, params, batches


def _port_model(cfg, params, **kw):
    model = ClipMatcher(cfg, device="cpu", compute_dtype=torch.float32, **kw)
    load_jax_params(model, params)
    return model


def _deltas(out, anchors_xyhw):
    """(box deltas before the anchors, occupancy logits) of an output
    dict."""
    center, hw = np.asarray(out["center"]), np.asarray(out["hw"])
    refine = np.concatenate([center, 2 * hw], -1)
    return refine - anchors_xyhw, np.asarray(out["prob"])


@pytest.mark.parametrize("from_features,hnm", [(False, False), (False, True),
                                               (True, False), (True, True)])
def test_clip_matcher_matches_jax(tiny, from_features, hnm):
    cfg, jmodel, params, batches = tiny
    b = batches[0]
    clip, query = b["clip"], b["query"]
    if from_features:
        g = cfg.clip_size // cfg.patch_size
        rng = np.random.default_rng(4)
        clip = rng.standard_normal(clip.shape[:2] + (g, g, cfg.vit_dim)
                                   ).astype(np.float32)
        query = rng.standard_normal((clip.shape[0], g, g, cfg.vit_dim)
                                    ).astype(np.float32)
    ref = jax.jit(lambda p, c, q: jmodel.apply(
        {"params": p}, c, q, from_features=from_features, hnm=hnm,
        deterministic=True))(params, jnp.asarray(clip), jnp.asarray(query))
    model = _port_model(cfg, params).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(clip), torch.from_numpy(query),
                    from_features=from_features, hnm=hnm)
    n = 4 if hnm else 2
    assert out["prob"].shape == (n, cfg.num_frames, 8 * 8 * 12)
    anchors = model.anchors_xyhw.numpy()
    np.testing.assert_array_equal(out["anchors_xyxy"].numpy(),
                                  np.asarray(ref["anchors_xyxy"]))
    for got, want, nm in zip(_deltas(out, anchors), _deltas(ref, anchors),
                             ("deltas", "logits")):
        assert np.abs(want).max() > 0.05, nm       # not the 1e-6 init
        np.testing.assert_allclose(got, want, err_msg=nm, **TOL)


def test_eval_step_and_response_track_match_jax(tiny):
    """The eval step (sigmoid, first-max anchor per frame) and the whole
    sliding-window predict_track against VQEpisodeRunner.predict_track on a
    40-frame clip: 7 windows of 6 in chunks of 4, the tail padded."""
    cfg, jmodel, params, batches = tiny
    model = _port_model(cfg, params)
    b = batches[1]
    jbox, jprob = j_engine.make_vq_eval_step(jmodel)(
        params, jnp.asarray(b["clip"]), jnp.asarray(b["query"]))
    tbox, tprob = t_engine.make_vq_eval_step(model)(
        torch.from_numpy(b["clip"]), torch.from_numpy(b["query"]))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), **TOL)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), **TOL)

    rng = np.random.default_rng(8)
    frames = rng.random((40, cfg.clip_size, cfg.clip_size, 3), np.float32)
    query = rng.random((cfg.clip_size, cfg.clip_size, 3), np.float32)
    fake = types.SimpleNamespace(
        source=types.SimpleNamespace(query=lambda s: query),
        window=cfg.num_frames, eval_windows=cfg.eval_windows,
        _fetch_frames=lambda s, ix: frames[np.asarray(ix)],
        _to_device=lambda batch, is_training=True: batch,
        eval_step=j_engine.make_vq_eval_step(jmodel), params=params,
        frame_size=cfg.clip_size)
    want = VQEpisodeRunner.predict_track(
        fake, {"num_frames": 40, "query_frame": 33})
    got = predict_track(model, torch.from_numpy(frames),
                        torch.from_numpy(query), 33)
    assert [x.fno for x in got.bboxes] == [x.fno for x in want.bboxes]
    np.testing.assert_allclose(
        [[x.x1, x.y1, x.x2, x.y2] for x in got.bboxes],
        [[x.x1, x.y1, x.x2, x.y2] for x in want.bboxes], rtol=1e-4,
        atol=1e-3)


def test_predictions_to_response_track_matches_jax():
    rng = np.random.default_rng(9)
    for T, qf in ((50, 45), (7, 3), (120, 100)):
        scores = np.convolve(rng.random(T), np.ones(5) / 5, "same")
        boxes = rng.random((T, 4)) * 448
        got = t_metrics.predictions_to_response_track(scores, boxes, qf)
        want = j_metrics.predictions_to_response_track(scores, boxes, qf)
        assert got == t_metrics.ResponseTrack(
            [t_metrics.BBox(**vars(x)) for x in want.bboxes], want.score)
        assert got.temporal_extent == want.temporal_extent


def _rel_leaves(got, want, floor_frac=1e-4):
    gmax = max(np.abs(w).max() for w in want.values())
    return {n: np.abs(got[n] - want[n]).max()
            / max(np.abs(want[n]).max(), floor_frac * gmax)
            for n in want}


def _jax_loss(jmodel, p, batch):
    preds = jmodel.apply({"params": p}, batch["clip"], batch["query"],
                         hnm=True, deterministic=True)
    gts = j_engine.replicate_for_hnm(
        {k: batch[k] for k in t_engine.GT_KEYS}, batch["clip"].shape[0])
    return j_engine.vq_losses(preds, gts)


def test_vq_losses_and_gradients_match_jax(tiny):
    """HNM on (4 pairs of 2 clips), dropout off: every loss term and every
    trainable gradient leaf; the frozen ViT has no gradient in the port and
    an exact 0 in JAX."""
    cfg, _, params, batches = tiny
    with jax.enable_x64(True):
        jmodel = _jax_model(cfg, "float64")
        jb = _f64(batches[0])
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss(jmodel, p, jb)[:2], has_aux=True))(
                _f64(params))
        want = _np64(jgrads)
        jmet = {k: float(v) for k, v in jmet.items()}
    model = _port_model(cfg, params).train()
    step_batch = batch_to(batches[0], "cpu")
    preds = model(step_batch["clip"], step_batch["query"], hnm=True)
    gts = t_engine.replicate_for_hnm(
        {k: step_batch[k] for k in t_engine.GT_KEYS}, 2)
    loss, met, _ = t_engine.vq_losses(preds, gts)
    loss.backward()
    for k in ("loss_center", "loss_hw", "loss_giou", "loss_prob",
              "final_loss", "mean_iou"):
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-4 * abs(
            float(jmet[k])), k
    assert float(met["num_pos"]) == float(jmet["num_pos"]) > 0
    got = {n: p.grad.numpy() for n, p in model.named_parameters()
           if p.requires_grad}
    assert set(want) - set(got) == {n for n in want
                                    if n.startswith("backbone.")}
    assert all(float(np.abs(want[n].numpy()).max()) == 0.0
               for n in want if n.startswith("backbone."))
    errs = _rel_leaves(got, {n: want[n].numpy() for n in got})
    bad = sorted((e, n) for n, e in errs.items() if e > 1e-4)
    assert not bad, bad[-5:]


# the lockstep's parameters: every element whose first-step gradient is
# above this share of its leaf's largest is held to LOCKSTEP_ATOL (the
# worst such element reads 7.8e-7)
NEAR_ZERO_GRAD = 1e-5
LOCKSTEP_ATOL = 5e-6


def _zero_grad_slices(name, shape):
    """The elements whose exact gradient is 0: the key biases (the
    decoder's, and the middle third of each encoder's fused qkv bias)."""
    if name.endswith(("self_k.bias", "cross_k.bias")):
        return slice(None)
    if name.endswith("qkv.bias") and name.startswith("st_"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    return None


def test_vq_three_step_trajectory_matches_jax(tiny):
    """Three HNM steps from the same parameters and batches, lr 3e-4, decay
    5e-3, the global-norm clip at 20 active (norms 26-37), milestones (1, 2)
    so the MultiStepLR factor changes inside the 3 steps; the backbone
    stays bit-identical."""
    cfg, _, params, batches = tiny
    cfg = dataclasses.replace(cfg, lr_milestones=(1, 2))
    jl = []
    with jax.enable_x64(True):
        tx = j_engine.make_vq_optimizer(cfg.lr, cfg.weight_decay,
                                        grad_max=cfg.grad_max,
                                        milestones=cfg.lr_milestones,
                                        gamma=cfg.lr_gamma)
        jparams = _f64(params)
        state = j_engine.VQTrainState(
            step=jnp.zeros((), jnp.int32), params=jparams,
            opt_state=tx.init(jparams), rng=jax.random.PRNGKey(1))
        jstep = j_engine.make_vq_train_step(_jax_model(cfg, "float64"), tx,
                                            use_hnm=True, deterministic=True)
        for batch in batches:
            state, jm = jstep(state, _f64(batch))
            jl.append(float(jm["final_loss"]))
        want = _np64(state.params)
    tstate = t_engine.init_vq_train_state(_port_model(cfg, params), cfg,
                                          device="cpu")
    backbone0 = {n: p.detach().clone() for n, p
                 in tstate.model.backbone.named_parameters()}
    tstep = t_engine.make_vq_train_step(cfg, deterministic=True)
    lrs = [float(tstate.opt.lr_at(s)) for s in range(3)]
    assert lrs == pytest.approx([3e-4, 9e-5, 2.7e-5], rel=1e-6)
    g1 = None
    for batch, jloss in zip(batches, jl):
        tm = tstep(tstate, batch_to(batch, "cpu"))
        assert abs(float(tm["final_loss"]) - jloss) <= 1e-5 * jloss
        assert float(tm["grad_norm"]) > cfg.grad_max
        if g1 is None:
            g1 = {n: p.grad.abs().numpy().copy()
                  for n, p in tstate.model.named_parameters()
                  if p.requires_grad}
    assert tstate.opt.count == 3
    for n, p in tstate.model.backbone.named_parameters():
        assert torch.equal(p, backbone0[n]), n
        np.testing.assert_array_equal(p.numpy(),
                                      want["backbone." + n].numpy())
    reach = 2 * sum(lrs)
    for n, p in tstate.model.named_parameters():
        if not p.requires_grad:
            continue
        d = np.abs(p.detach().numpy() - want[n].numpy())
        assert d.max() <= reach, n
        free = g1[n] <= NEAR_ZERO_GRAD * g1[n].max()
        zero = _zero_grad_slices(n, d.shape)
        if zero is not None:
            free[zero] = True
        assert d[~free].max(initial=0.0) <= LOCKSTEP_ATOL, (
            n, float(d[~free].max()))


def test_vq_entry_points_default_to_the_card():
    """The ClipMatcher goes to the card unless asked for the CPU; with no
    card it raises instead of falling back."""
    cfg = vq_flagship_config(tiny=True)
    if torch.cuda.is_available():
        assert next(ClipMatcher(cfg).parameters()).is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        ClipMatcher(cfg)
