"""The port's CL methods' training terms against the JAX package on the CPU:
the EWC/MAS penalty and its importance estimation, iCaRL's and BiC's
distillation, BiC's bias and stage 2, iCaRL's exemplar means and keep
mask, gradient accumulation (MQ/NLQ and VQ), and 3-step locksteps of the
EWC, iCaRL and BiC train steps.

The MQ cases run the graft flagship's tiny twin (XL stage on, f32, 12
classes) from the same perturbed parameters and numpy batches as
tests/test_torch_port_train.py, drop-path off on both sides (JAX's
`_drop_path` patched to the identity, the port's step with
regularize=False): as CL task 1 with classes 0-8 seen and n_known 6, the
distillation at dist_factor 1 (the config's 0.01 leaves the term below
the tolerances' reach). The VQ case runs the ClipMatcher's tiny twin in
f64 on the JAX side, as tests/test_torch_port_vq.py does.

Tolerances (max|port - jax| / max|jax|, per leaf where a tree):
  penalty value 1e-6, its gradient 1e-6 per leaf (both sides sum the same
      f32 products, the port in f64);
  importance: MAS 1e-5 per leaf, EWC 2e-5 (a square doubles the gradient's
      1e-5), the denominators floored at 1e-4 of the tree's largest, as
      the gradient tests; the normaliser 1e-6;
  distillation and every loss term 1e-5; snapshot targets 1e-6;
  BiC stage 2: alpha and beta 1e-6 after 3 steps;
  exemplar means 1e-6; the keep mask equal (and the chunked form equal
      to the full one bit for bit);
  accumulation and the locksteps: loss, grad norm and every metric 1e-5
      each step; after the last step every parameter within 5e-5 of its
      largest value (AdamW divides by sqrt(v): an f32 difference in a
      small gradient moves a parameter by up to lr), the leaves whose
      exact gradient is 0 within 2 x the sum of the lrs; the normaliser
      1e-6 (a few f32 spacings: XLA fuses the EMA's multiply-add inside
      the accumulation's scan);
  VQ: loss 1e-5 and the trainable parameters within 5e-6 absolute where
      their first gradient is above 1e-5 of the leaf's largest (as the VQ
      lockstep), the frozen ViT bit-identical.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.layers as j_layers
from tests.test_torch_port_train import _jcfg, _points, _port_model, _rel
from tests.test_torch_port_vq import (
    _f64,
    _jax_model,
    _np64,
    _perturbed,
)
from vilco_tpu.cl import bic as j_bic
from vilco_tpu.cl import episode as j_episode
from vilco_tpu.cl import icarl as j_icarl
from vilco_tpu.cl import regularizers as j_regs
from vilco_tpu.core.config import load_config
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.tasks.nlq import nlq_tiny_config
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu.train import vq_engine as j_vq
from vilco_tpu_torch.cl import bic as t_bic
from vilco_tpu_torch.cl import icarl as t_icarl
from vilco_tpu_torch.cl import regularizers as t_regs
from vilco_tpu_torch.core.config import (
    CLCfg,
    flagship_config,
    nlq_flagship_config,
    vq_flagship_config,
)
from vilco_tpu_torch.data.synthetic import make_vq_batch
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.models.convert import (
    load_jax_params,
    params_from_jax,
    port_name,
    reg_tasks_from_jax,
)
from vilco_tpu_torch.train import engine as t_engine
from vilco_tpu_torch.train import vq_engine as t_vq

SPE = 1
C = 12               # the tiny twin's classes
SEEN = 9             # task 1: classes 0-8 seen
N_KNOWN = 6          # classes of task 0
DIST = 1.0           # the distillation weight of these tests
LAM = 50.0           # the penalty weight of these tests
LOCKSTEP_LR = 1e-4
ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")


def _class_mask():
    return np.arange(C) < SEEN


def _jcl_cfg(jcfg, method):
    return jcfg.updated(cl_cfg=jcfg.cl_cfg.updated(
        name=method, dist_factor=DIST, reg_lambda=LAM))


def _tcfg(method, accumulation_steps=1, lr=None):
    cfg = flagship_config(tiny=True)
    opt = cfg.opt if lr is None else dataclasses.replace(
        cfg.opt, learning_rate=lr)
    return dataclasses.replace(
        cfg, cl_cfg=CLCfg(name=method, dist_factor=DIST, reg_lambda=LAM),
        opt=dataclasses.replace(opt, accumulation_steps=accumulation_steps))


@pytest.fixture(scope="module")
def mq():
    """JAX model and perturbed params of the tiny twin, three batches of
    two clips, two batches of one clip."""
    jcfg = _jcfg()
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [j_make_batch(rng, 2, jcfg) for _ in range(3)]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0]["feats"]),
                                  jnp.asarray(batches[0]["mask"]))["params"]
    prng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * (
        prng.standard_normal(np.shape(a)).astype(np.float32)), params)
    return jcfg, jmodel, params, batches


@pytest.fixture(autouse=True)
def _no_drop_path(monkeypatch):
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)


def _reg_list(params, seed, K=2):
    """K tasks of (importance, optpar) JAX trees: importance |N(0, 1)|^2
    on every leaf, optpar the parameters moved by N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(K):
        imp = jax.tree.map(lambda a: np.square(rng.standard_normal(
            np.shape(a))).astype(np.float32), params)
        opt = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * (
            rng.standard_normal(np.shape(a)))).astype(np.float32), params)
        out.append((imp, opt))
    return out


def _leaf_errs(got, want, floor_frac=1e-4):
    floor = floor_frac * max(np.abs(w).max() for w in want.values())
    return {n: np.abs(got[n] - want[n]).max() / max(np.abs(want[n]).max(),
                                                    floor, 1e-30)
            for n in want}


# ---- the EWC/MAS penalty ---------------------------------------------------

def test_penalty_excluded_matches_jax(mq):
    """The skip rule on the port's names equals JAX's on the Flax paths,
    leaf by leaf: AffineDropPath's and the head's Scale leaves skipped,
    LayerNorm's `scale` (the port's `.weight`) kept."""
    params = mq[2]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got, want = {}, {}
    for path, a in flat:
        keys = tuple(p.key for p in path)
        name = port_name(keys, np.ndim(a))
        want[name] = j_engine._penalty_excluded(path)
        got[name] = t_regs.penalty_excluded(name)
    assert got == want
    skipped = [n for n, s in got.items() if s]
    assert any(".drop_path" in n for n in skipped)
    assert any(n.startswith("reg_head.scale_") for n in skipped)
    ln = [n for n, a in zip(got, flat) if a[0][-1].key == "scale"
          and not got[n]]
    assert "backbone.xl_0.ln_attn.weight" in ln, ln


def test_reg_tasks_from_jax_stacks_on_the_port_side(mq):
    """Each task maps leaf by leaf as params_from_jax maps it (importance x
    optpar maps to the product of the mapped leaves), and the stacked
    (K, N) rows hold each leaf at the optimizer's offset, zeros between."""
    params = mq[2]
    reg = _reg_list(params, 3)
    tasks = reg_tasks_from_jax(reg)
    for (imp, opt), (timp, topt) in zip(reg, tasks):
        prod = params_from_jax(jax.tree.map(np.multiply, imp, opt))
        for n in prod:
            np.testing.assert_array_equal((timp[n] * topt[n]).numpy(),
                                          prod[n].numpy(), err_msg=n)
    state = t_engine.init_train_state(_port_model(params), _tcfg("ewc"), SPE,
                                      device="cpu")
    o = state.opt
    n = o.param_flat.numel()
    f, p = t_regs.stack_reg_tasks(tasks, o.names, o.flat_offsets, n)
    assert f.shape == p.shape == (2, n)
    covered = torch.zeros(n, dtype=torch.bool)
    for k, (timp, topt) in enumerate(tasks):
        for name, off, par in zip(o.names, o.flat_offsets, o.params):
            sl = slice(off, off + par.numel())
            assert torch.equal(f[k, sl], timp[name].reshape(-1))
            assert torch.equal(p[k, sl], topt[name].reshape(-1))
            covered[sl] = True
    assert not f[:, ~covered].any() and not p[:, ~covered].any()
    assert o.param_flat.data_ptr() == o.params[0].data_ptr()


def _jax_penalty(params, reg, lam):
    fisher, optpar = j_regs.stack_reg_tasks(reg)
    return jax.jit(jax.value_and_grad(
        lambda p: j_engine.reg_penalty(p, fisher, optpar, lam)))(params)


@pytest.mark.parametrize("near", [False, True])
def test_reg_penalty_matches_jax(mq, near):
    """K = 2 stacked tasks: the value and every leaf's gradient against
    jax.value_and_grad of reg_penalty, the skipped leaves' gradient 0 on
    both sides. `near`: optpar within 1e-4 of the parameters, where the
    folded form's theta^2 terms cancel against (O - theta)^2 ~ 1e-8."""
    params = mq[2]
    reg = _reg_list(params, 4)
    if near:
        rng = np.random.default_rng(5)
        near = lambda a: (np.asarray(a) + 1e-4 * rng.standard_normal(
            np.shape(a))).astype(np.float32)
        reg = [(imp, jax.tree.map(near, params)) for imp, _ in reg]
    val, grads = _jax_penalty(params, reg, LAM)
    want = {n: g.numpy() for n, g in params_from_jax(
        jax.tree.map(np.asarray, grads)).items()}
    state = t_engine.init_train_state(_port_model(params), _tcfg("ewc"), SPE,
                                      device="cpu")
    pen = t_regs.RegPenalty.for_optimizer(reg_tasks_from_jax(reg), state.opt,
                                          LAM)
    state.opt.zero_grad()
    got_val = pen.apply(state.opt.param_flat, state.opt.grad_flat)
    assert got_val.dtype == torch.float32 and got_val.dim() == 0
    assert _rel(got_val.item(), float(val)) <= 1e-6
    got = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    skipped = [n for n in got if t_regs.penalty_excluded(n)]
    assert skipped
    for n in skipped:
        assert not got[n].any() and not want[n].any(), n
    errs = _leaf_errs(got, want, 0.0)
    assert max(errs.values()) <= 1e-6, max(errs.items(), key=lambda kv: kv[1])


def test_reg_penalty_vq_frozen_share(mq):
    """Leaves outside the optimizer (here: a frozen leaf) add their fixed
    share lambda sum F (O - theta)^2 to the value and nothing to the
    gradient."""
    params = mq[2]
    reg = _reg_list(params, 6, K=1)
    model = _port_model(params)
    frozen = next(n for n, _ in model.named_parameters()
                  if n.startswith("cls_head") and n.endswith("weight"))
    dict(model.named_parameters())[frozen].requires_grad_(False)
    val, _ = _jax_penalty(params, reg, LAM)
    opt = t_vq.VQOptimizer(model, 1e-3, 0.0)
    assert frozen not in opt.names
    pen = t_regs.RegPenalty.for_optimizer(reg_tasks_from_jax(reg), opt, LAM,
                                          model=model)
    assert _rel(pen.apply(opt.param_flat, opt.grad_flat).item(),
                float(val)) <= 1e-6


# ---- importance -------------------------------------------------------------

@pytest.fixture(scope="module")
def importance(mq):
    """JAX's estimate_importance (ewc and mas) over batches 0 and 1 at the
    classes through task 1, from the normaliser 100."""
    jcfg, jmodel, params, batches = mq
    pts = jnp.asarray(_points(jcfg.model))
    step = j_regs.make_grad_step(jmodel, pts, jcfg, "ewc")
    cl = j_engine.CLBatchExtras(class_mask=jnp.asarray(_class_mask()))
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches[:2]]
    return {mode: j_regs.estimate_importance(
        step, jax.tree.map(jnp.asarray, params), jb, cl,
        jnp.asarray(100.0), mode=mode) for mode in ("ewc", "mas")}


@pytest.mark.parametrize("mode,tol", [("ewc", 2e-5), ("mas", 1e-5)])
def test_estimate_importance_matches_jax(mq, importance, mode, tol):
    """Only the last batch's gradient becomes the importance (the first
    batch's alone gives another), the normaliser advances on both."""
    jcfg, _, params, batches = mq
    imp, optpar, norm = importance[mode]
    model = _port_model(params)
    pts = torch.from_numpy(_points(jcfg.model))
    cl = t_engine.CLBatchExtras(torch.from_numpy(_class_mask()))
    tb = [t_engine.batch_to(b, "cpu") for b in batches[:2]]
    tc = flagship_config().train_cfg
    got, gopt, gnorm = t_regs.estimate_importance(
        model, pts, tb, cl, torch.tensor(100.0), tc, mode)
    assert _rel(gnorm.item(), float(norm)) <= 1e-6
    assert all(p.grad is None or not p.grad.any()
               for p in model.parameters())
    want = {n: v.numpy() for n, v in params_from_jax(imp).items()}
    errs = _leaf_errs({n: v.numpy() for n, v in got.items()}, want)
    assert max(errs.values()) <= tol, max(errs.items(), key=lambda kv: kv[1])
    wopt = params_from_jax(optpar)
    assert all(torch.equal(gopt[n], wopt[n]) for n in wopt)
    first, _, _ = t_regs.estimate_importance(
        model, pts, tb[:1], cl, torch.tensor(100.0), tc, mode)
    assert max(_leaf_errs({n: v.numpy() for n, v in first.items()},
                          want).values()) > 1e-2


# ---- distillation, snapshot targets, BiC's bias ---------------------------

def _outputs(rng, B, P, lens):
    """Head outputs of the tiny twin's shape: logits N(0, 2), positive
    offsets, a ragged mask, the class Gaussians."""
    valid = np.ones((B, P), bool)
    valid[0, P // 3:] = False
    gauss = tuple((rng.standard_normal(C) * 0.2 + c).astype(np.float32)
                  for c in (0.0, 1.0, -0.5, 1.0, 0.5, 1.0))
    return dict(
        cls_logits=(2 * rng.standard_normal((B, P, C))).astype(np.float32),
        offsets=np.abs(rng.standard_normal((B, P, 2))).astype(np.float32),
        fpn_mask=valid, gaussians=gauss, level_lengths=lens)


@pytest.mark.parametrize("method", ["icarl", "bic"])
def test_distillation_matches_jax(mq, method):
    """compute_losses with the targets of snapshot_targets (held against
    JAX's snapshot_logits): the distillation term and the total."""
    jcfg, _, _, batches = mq
    jcfg = _jcl_cfg(jcfg, method)
    from vilco_tpu.models.point_transformer import level_lengths as j_lens

    lens = j_lens(jcfg.model)
    P = int(sum(lens))
    rng = np.random.default_rng(9)
    out = _outputs(rng, 2, P, lens)
    prev_logits = (2 * rng.standard_normal((2, P, C))).astype(np.float32)
    want_t = _jax_snapshot(method, prev_logits)
    prev = t_engine.snapshot_targets(torch.from_numpy(prev_logits), method,
                                     N_KNOWN)
    assert _rel(prev.numpy(), want_t) <= 1e-6
    b = batches[0]
    pts = _points(jcfg.model)
    jcl = j_engine.CLBatchExtras(class_mask=jnp.asarray(_class_mask()),
                                 prev_logits=jnp.asarray(want_t))
    jout = {k: (tuple(map(jnp.asarray, v)) if k == "gaussians"
                else jnp.asarray(v)) for k, v in out.items()
            if k != "level_lengths"}
    _, jm, jnorm = j_engine.compute_losses(
        jout, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(pts),
        jcfg, jcl, jnp.asarray(100.0), method, N_KNOWN)
    tout = {k: (tuple(map(torch.from_numpy, v)) if k == "gaussians"
                else v if k == "level_lengths" else torch.from_numpy(v))
            for k, v in out.items()}
    tcl = t_engine.CLBatchExtras(torch.from_numpy(_class_mask()),
                                 prev_logits=prev)
    _, tm, tnorm = t_engine.compute_losses(
        tout, t_engine.batch_to(b, "cpu"), torch.from_numpy(pts), tcl,
        torch.tensor(100.0), flagship_config().train_cfg, N_KNOWN,
        cl_method=method, dist_factor=DIST)
    for k in ("dist_loss", "cls_loss", "reg_loss", "final_loss"):
        assert _rel(tm[k].item(), float(jm[k])) <= 1e-5, k
    assert float(jm["dist_loss"]) > 0.1 * float(jm["final_loss"])
    assert tnorm.item() == pytest.approx(float(jnorm), rel=1e-7)


def _jax_snapshot(method, logits):
    """JAX's EpisodeRunner.snapshot_logits on one batch of `logits`, through
    a stand-in runner whose eval step returns them."""
    self = type("Runner", (), {})()
    self.method = method
    self.cfg = _jcfg().updated()
    self._make_dataset = lambda videos, is_training: None
    self._to_device = lambda batch, is_training: batch
    self.eval_step = lambda params, batch: {"cls_logits": logits}
    meta = {"video_id": ["a", "b"], "pad": [False, False]}
    saved = j_episode.BatchIterator
    j_episode.BatchIterator = lambda *a, **k: [({}, meta)]
    try:
        got = j_episode.EpisodeRunner.snapshot_logits(self, None, [],
                                                      n_known=N_KNOWN)
    finally:
        j_episode.BatchIterator = saved
    return np.stack([got["a"], got["b"]])


def test_apply_bias_matches_jax():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 30, C)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(j_bic.apply_bias(jnp.asarray(z), jnp.asarray(a),
                                       jnp.asarray(b)))
    got = t_bic.apply_bias(*map(torch.from_numpy, (z, a, b)))
    np.testing.assert_array_equal(got.numpy(), want)
    st, jst = t_bic.BicState(C, 3), j_bic.BicState(C, 3)
    for s in (st, jst):
        s.register_task(0, range(6))
        s.register_task(1, range(6, 9))
        s.alphas[:] = (0.9, 1.1, 1.2)
        s.betas[:] = (0.1, -0.2, 0.3)
    for t in (0, 1, 2):
        for x, y in zip(st.per_class(t), jst.per_class(t)):
            np.testing.assert_array_equal(x, y)


def test_bic_stage2_matches_jax(mq):
    """Three stage-2 steps from (1, 0) on task 1's pair, the past task's
    pair (0.9, 0.2) on classes 0-5: alpha and beta 1e-6, the model
    unchanged."""
    jcfg, jmodel, params, batches = mq
    class_task = np.where(np.arange(C) < N_KNOWN, 0, 1)
    base_a = np.where(class_task == 0, 0.9, 1.0).astype(np.float32)
    base_b = np.where(class_task == 0, 0.2, 0.0).astype(np.float32)
    pts = _points(jcfg.model)
    jstep, jinit = j_bic.make_bias_stage2_step(
        jmodel, jnp.asarray(pts), jcfg, 1, class_task)
    bias, opt = jinit()
    jcl = j_engine.CLBatchExtras(class_mask=jnp.asarray(_class_mask()),
                                 bias_alpha=jnp.asarray(base_a),
                                 bias_beta=jnp.asarray(base_b))
    jp = jax.tree.map(jnp.asarray, params)
    model = _port_model(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstep, tinit = t_bic.make_bias_stage2_step(
        model, torch.from_numpy(pts), flagship_config().train_cfg, 1,
        class_task)
    tbias = tinit()
    tcl = t_engine.CLBatchExtras(torch.from_numpy(_class_mask()),
                                 bias_alpha=torch.from_numpy(base_a),
                                 bias_beta=torch.from_numpy(base_b))
    for b in batches:
        bias, opt, jm = jstep(bias, opt, jp,
                              {k: jnp.asarray(v) for k, v in b.items()},
                              jcl, jnp.asarray(100.0))
        tbias, tm = tstep(tbias, t_engine.batch_to(b, "cpu"), tcl,
                          torch.tensor(100.0))
        assert _rel(tm["final_loss"].item(), float(jm["final_loss"])) <= 1e-5
    for k in ("alpha", "beta"):
        assert _rel(tbias[k].item(), float(bias[k])) <= 1e-6, k
        assert abs(tbias[k].item() - (1.0 if k == "alpha" else 0.0)) > 1e-6
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 3), (10, 1), (37, 5)])
def test_split_train_val_matches_jax(n, seed):
    videos = [f"v{i}" for i in range(n)]
    assert t_bic.split_train_val(videos, 0.9, seed) == \
        j_bic.split_train_val(videos, 0.9, seed)


# ---- iCaRL at eval ----------------------------------------------------------

def test_exemplar_means_and_keep_mask_match_jax():
    """Three levels (T 16, 8, 4, D 8), 5 classes, class 3 without
    exemplars: the means and the validity, the keep mask of a batch of 3
    by the expanded form and by the direct form (1, 2 and 5 classes a
    chunk, equal bit for bit), each equal to JAX's, the distances of the
    two forms within 1e-6 of the largest, and the bias and the filter on an
    eval step's outputs."""
    rng = np.random.default_rng(2)
    Tl, D, nc = (16, 8, 4), 8, 5
    bank = {v: [rng.standard_normal((t, D)).astype(np.float32) for t in Tl]
            for v in range(12)}
    class_videos = {0: [0, 1], 1: [2], 2: [3, 4, 5], 3: [], 4: [6, 7]}
    feats_np = lambda vids: [np.stack([bank[v][l] for v in vids])
                             for l in range(len(Tl))]
    feats_t = lambda vids: [torch.from_numpy(a) for a in feats_np(vids)]
    jmeans, jvalid = j_icarl.compute_exemplar_means(feats_np, class_videos,
                                                    nc)
    means, valid = t_icarl.compute_exemplar_means(feats_t, class_videos, nc)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    for m, jm in zip(means, jmeans):
        assert _rel(m.numpy(), jm) <= 1e-6
    fpn = [rng.standard_normal((3, t, D)).astype(np.float32) for t in Tl]
    # one clip's map near class 0's mean, so that both sides of the
    # threshold are populated
    fpn[0][1] = jmeans[0][0] * 40 + 0.01 * fpn[0][1]
    want = j_icarl.distance_keep_mask(fpn, jmeans, jvalid)
    tf = [torch.from_numpy(f) for f in fpn]
    np.testing.assert_array_equal(
        t_icarl.distance_keep_mask(tf, means, valid).numpy(), want)
    full = t_icarl.distance_keep_mask(tf, means, valid, chunk=nc)
    np.testing.assert_array_equal(full.numpy(), want)
    assert 0 < want.mean() < 1 and not want[..., 3].any()
    for f, m in zip(tf, means):
        direct = t_icarl.level_distances(f, m, nc)
        assert _rel(t_icarl.level_distances(f, m).numpy(),
                    direct.numpy()) <= 1e-6
        for chunk in (1, 2):
            assert torch.equal(t_icarl.level_distances(f, m, chunk), direct)
    P = sum(Tl)
    z = rng.standard_normal((3, P, nc)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, nc).astype(np.float32)
    b = rng.standard_normal(nc).astype(np.float32)
    out = t_icarl.adjust_eval_outputs(
        {"cls_logits": torch.from_numpy(z), "fpn_feats": tf},
        (torch.from_numpy(a), torch.from_numpy(b)), means, valid)
    expect = np.where(want, z * a + b, -1e9)
    np.testing.assert_array_equal(out["cls_logits"].numpy(), expect)


# ---- accumulation and the locksteps -----------------------------------------

def _jax_state(jcfg, params, tx):
    jparams = jax.tree.map(jnp.asarray, params)
    return j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1))


def _extras(method, params, rng, B):
    """Both sides' CL extras of `method`: the penalty of two stacked tasks
    (ewc), targets from snapshot_targets of N(0, 2) logits (icarl, bic), and
    the past task's bias (bic)."""
    pts_P = _points(_jcfg().model).shape[0]
    j, t = {}, {}
    if method == "ewc":
        reg = _reg_list(params, 8)
        fisher, optpar = j_regs.stack_reg_tasks(reg)
        j.update(fisher=jax.tree.map(jnp.asarray, fisher),
                 optpar=jax.tree.map(jnp.asarray, optpar))
        t["reg"] = reg_tasks_from_jax(reg)
    if method in ("icarl", "bic"):
        logits = (2 * rng.standard_normal((B, pts_P, C))).astype(np.float32)
        prev = t_engine.snapshot_targets(torch.from_numpy(logits), method,
                                         N_KNOWN)
        j["prev_logits"] = jnp.asarray(prev.numpy())
        t["prev_logits"] = prev
    if method == "bic":
        a = np.where(np.arange(C) < N_KNOWN, 0.9, 1.0).astype(np.float32)
        b = np.where(np.arange(C) < N_KNOWN, 0.2, 0.0).astype(np.float32)
        j.update(bias_alpha=jnp.asarray(a), bias_beta=jnp.asarray(b))
        t.update(bias_alpha=torch.from_numpy(a), bias_beta=torch.from_numpy(b))
    return j, t


def _run_lockstep(mq, method, batches, K):
    """Both sides' steps of `method` at accumulation K from the same
    parameters and batches: (JAX state, port state, per-step metrics)."""
    jcfg, jmodel, params, _ = mq
    jcfg = _jcl_cfg(jcfg, method)
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LOCKSTEP_LR,
                                             accumulation_steps=K))
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    state = _jax_state(jcfg, params, tx)
    pts = _points(jcfg.model)
    jstep = j_engine.make_train_step(
        jmodel, tx, jnp.asarray(pts), jcfg, cl_method=method,
        use_distill=method in ("icarl", "bic"),
        use_reg_penalty=method == "ewc", n_known=N_KNOWN,
        accumulation_steps=K)
    cfg = _tcfg(method, K, LOCKSTEP_LR)
    tstate = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                       device="cpu")
    tstep = t_engine.make_train_step(
        torch.from_numpy(pts), cfg.train_cfg, regularize=False,
        cl_cfg=cfg.cl_cfg, n_known=N_KNOWN,
        accumulation_steps=cfg.opt.accumulation_steps)
    jx, tx_ = _extras(method, params, np.random.default_rng(12),
                      batches[0]["feats"].shape[0])
    pen = None
    if "reg" in tx_:
        pen = t_regs.RegPenalty.for_optimizer(tx_.pop("reg"), tstate.opt,
                                              LAM)
    jcl = j_engine.CLBatchExtras(class_mask=jnp.asarray(_class_mask()), **jx)
    tcl = t_engine.CLBatchExtras(torch.from_numpy(_class_mask()),
                                 penalty=pen, **tx_)
    mets = []
    for b in batches:
        state, jm, _ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                             jcl)
        tm = tstep(tstate, t_engine.batch_to(b, "cpu"), tcl)
        mets.append((jm, tm))
    return state, tstate, mets


def _check_lockstep(state, tstate, mets, keys):
    for jm, tm in mets:
        for k in keys:
            assert _rel(tm[k].item(), float(jm[k])) <= 1e-5, k
    assert tstate.loss_normalizer.item() == pytest.approx(
        float(state.loss_normalizer), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    lr_sum = sum(float(tstate.opt.sched(s)) for s in range(len(mets)))
    errs = {}
    for n, p in tstate.model.named_parameters():
        if n.endswith(ZERO_GRAD):
            assert np.abs(p.detach().numpy() - want[n].numpy()).max() \
                <= 2 * lr_sum, n
        else:
            errs[n] = _rel(p.detach().numpy(), want[n].numpy())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= 5e-5, top


LOCKSTEP_KEYS = {"ewc": ("final_loss", "grad_norm", "reg_penalty"),
                 "icarl": ("final_loss", "grad_norm", "dist_loss"),
                 "bic": ("final_loss", "grad_norm", "dist_loss", "cls_loss")}


@pytest.mark.parametrize("method,K", [("ewc", 2), ("icarl", 1), ("bic", 2)])
def test_three_step_lockstep_matches_jax(mq, method, K):
    """Three steps of task 1 under each method against JAX's
    make_train_step: every step's loss, grad norm and the method's term,
    then the parameters and the normaliser. EWC and BiC run at
    accumulation K = 2 (micro-batches of one clip: the penalty's gradient
    added once after the division, BiC's targets split by rows, the
    normaliser advanced per micro-batch, the metrics their means)."""
    state, tstate, mets = _run_lockstep(mq, method, mq[3], K)
    jm = mets[0][0]
    term = "reg_penalty" if method == "ewc" else "dist_loss"
    assert float(jm[term]) > 0.01 * float(jm["final_loss"])
    _check_lockstep(state, tstate, mets, LOCKSTEP_KEYS[method])


def test_accumulation_rejects_a_batch_it_does_not_divide(mq):
    """K = 2 on a batch of 3 raises, as JAX's step does."""
    jcfg, jmodel, params, _ = mq
    b3 = j_make_batch(np.random.default_rng(3), 3, jcfg)
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jstep = j_engine.make_train_step(jmodel, tx,
                                     jnp.asarray(_points(jcfg.model)), jcfg,
                                     accumulation_steps=2)
    jcl = j_engine.CLBatchExtras(class_mask=jnp.ones((C,), bool))
    with pytest.raises(ValueError, match="not divisible"):
        jstep(_jax_state(jcfg, params, tx),
              {k: jnp.asarray(v) for k, v in b3.items()}, jcl)
    cfg = _tcfg("naive", 2)
    st = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                   device="cpu")
    step = t_engine.make_train_step(
        torch.from_numpy(_points(cfg.model)), cfg.train_cfg,
        regularize=False, accumulation_steps=2)
    with pytest.raises(ValueError, match="not divisible"):
        step(st, t_engine.batch_to(b3, "cpu"),
             t_engine.CLBatchExtras(torch.ones(C, dtype=torch.bool)))


def test_cl_methods_switch():
    pts = torch.zeros(4, 4)
    tc = flagship_config().train_cfg
    for name in t_engine.CL_METHODS:
        t_engine.make_train_step(pts, tc, cl_cfg=CLCfg(name=name))
    assert set(t_engine.CL_METHODS) == {"naive", "l2p", "ewc", "mas",
                                        "icarl", "bic"}
    for name in ("vilco", "lwf"):
        with pytest.raises(NotImplementedError):
            t_engine.make_train_step(pts, tc, cl_cfg=CLCfg(name=name))


# ---- VQ ---------------------------------------------------------------------

def test_vq_penalty_and_accumulation_match_jax():
    """Two HNM steps of the tiny ClipMatcher at K = 2 over batches of 4 (2
    pairs of 2 clips a micro-batch) with the EWC penalty of two stacked
    tasks over every leaf, the frozen ViT's included (JAX's penalty reads
    them; its optimizer drops their gradient), against
    make_vq_train_step in f64."""
    cfg = dataclasses.replace(vq_flagship_config(tiny=True),
                              accumulation_steps=2)
    jmodel32 = _jax_model(cfg)
    S = cfg.clip_size
    params = jax.jit(lambda k, c, q: jmodel32.init(k, c, q,
                                                   deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, S, S, 3)),
        jnp.zeros((1, S, S, 3)))["params"]
    params = _perturbed(params, 5)
    reg = _reg_list(params, 13)
    batches = [make_vq_batch(np.random.default_rng(30 + i), 4, cfg)
               for i in range(2)]
    lam = 0.5
    with jax.enable_x64(True):
        tx = j_vq.make_vq_optimizer(cfg.lr, cfg.weight_decay,
                                    grad_max=cfg.grad_max,
                                    milestones=cfg.lr_milestones,
                                    gamma=cfg.lr_gamma)
        jparams = _f64(params)
        state = j_vq.VQTrainState(step=jnp.zeros((), jnp.int32),
                                  params=jparams, opt_state=tx.init(jparams),
                                  rng=jax.random.PRNGKey(1))
        fisher, optpar = j_regs.stack_reg_tasks(reg)
        jreg = (_f64(fisher), _f64(optpar))
        jstep = j_vq.make_vq_train_step(
            _jax_model(cfg, "float64"), tx, use_hnm=True, reg_lambda=lam,
            accumulation_steps=2, deterministic=True)
        jm = []
        for b in batches:
            state, m = jstep(state, _f64(b), jreg)
            jm.append({k: float(v) for k, v in m.items()})
        want = _np64(state.params)
    model = ClipMatcher(cfg, device="cpu", compute_dtype=torch.float32)
    load_jax_params(model, params)
    tstate = t_vq.init_vq_train_state(model, cfg, device="cpu")
    backbone0 = {n: p.detach().clone()
                 for n, p in model.backbone.named_parameters()}
    pen = t_regs.RegPenalty.for_optimizer(reg_tasks_from_jax(reg),
                                          tstate.opt, lam, model=model)
    tstep = t_vq.make_vq_train_step(cfg, deterministic=True)
    for b, m in zip(batches, jm):
        tm = tstep(tstate, t_engine.batch_to(b, "cpu"), reg=pen)
        for k in ("final_loss", "reg_penalty", "loss_prob"):
            assert _rel(tm[k].item(), m[k]) <= 1e-5, k
    assert jm[0]["reg_penalty"] > jm[0]["final_loss"]
    for n, p in model.backbone.named_parameters():
        assert torch.equal(p, backbone0[n]), n
    for n, p in model.named_parameters():
        if p.requires_grad:
            d = np.abs(p.detach().numpy() - want[n].numpy())
            assert d.max() <= 5e-6, (n, float(d.max()))
    with pytest.raises(ValueError, match="not divisible"):
        tstep(tstate, t_engine.batch_to(
            make_vq_batch(np.random.default_rng(1), 3, cfg), "cpu"))


# ---- the NLQ flagship's CL method ------------------------------------------

@pytest.mark.parametrize("tiny", [False, True])
def test_nlq_cl_cfg_matches_yaml(tiny):
    """nlq_flagship_config()'s cl_cfg equals configs/nlq_vilco.yaml's (EWC
    at lambda 3000 over 13 tasks, no memory), the tiny twin's
    nlq_tiny_config()'s, field by field."""
    ref = nlq_tiny_config() if tiny else load_config("configs/nlq_vilco.yaml")
    port = nlq_flagship_config(tiny=tiny)
    for f in dataclasses.fields(port.cl_cfg):
        assert getattr(port.cl_cfg, f.name) == getattr(ref.cl_cfg, f.name), \
            f.name
    assert port.opt.accumulation_steps == ref.opt.accumulation_steps == 1
    if not tiny:
        assert (port.cl_cfg.name, port.cl_cfg.reg_lambda) == ("ewc", 3000.0)
