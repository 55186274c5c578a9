"""The port's data-parallel train steps on the CPU: 2 Gloo ranks, each on
its rows of the global batch (tests/test_torch_port_parallel_ranks.py over
parallel/launch.py), against JAX's single-device make_train_step /
make_vq_train_step fed the whole global batch (in the port's global row
order, which is JAX's: micro-batch k is rows [k b/K, (k+1) b/K)):

(The MQ yaml and NLQ cases, built here, run in
tests/test_torch_port_parallel_cl.py.)

  - the tiny graft config (XL on), global batch 2: loss and grad norm at
    1e-5 relative, the parameters at 1e-6 absolute (JAX's own DP limits,
    tests/test_seq_parallel.py:137-196), two steps, the second at lr > 0;
  - the MQ yaml's method (L2P, narration SSL, adapter EMA) at accumulation
    2, global batch 4: the first step's prompts by the pool's vote over the
    global batch, the second's the task's; the SSL bank and pointer, the
    EMA and the parameters;
  - NLQ with EWC at lambda 3000 over two stacked tasks, global batch 4;
  - VQ with HNM, global batch 4 (16 pairs, 8 a rank), f32, against the
    JAX step in f64: the loss terms at 1e-5, the trainable parameters at
    VQ_PARAM_ATOL (why: there), and the gradients against the port's
    one-process step at GRAD_RTOL;
  - train_cl --params-bf16 (the optimizer's bf16 compute copy) at the CLI's
    tiny MQ config in bf16, global batch 4: the copy's bf16 gradients
    all-reduced in bf16 (parallel/mesh.py::DataParallel.all_reduce_bf16_:
    Gloo sums in f32 and rounds once, for 2 ranks the bf16 sum), against
    JAX's step on a 2-device CPU mesh (the batch sharded over "data", the
    state replicated; XLA sums the copy's gradients), two steps at the
    limits of tests/test_torch_port_optim.py's bf16 lockstep (loss 2e-3,
    grad norm 5e-2 relative, each leaf's median error 0.25 of the summed
    lr, every element within 2 x the summed lr), each copy its master
    rounded to bf16, the ranks bitwise equal.

A leaf whose exact gradient is 0 or a cancelling sum near roundoff
(ZERO_GRAD, SHIFT_GRAD) takes AdamW steps of up to lr from a few bits of
gradient on either side (AdamW divides by sqrt(v)); it is held to the
steps AdamW can take, 2 x the sum of the lrs, as in the one-process
locksteps.

With dropout and drop-path on (rate 0.1, the XL kernel's dropout too, and
the VQ head's dropout), the 2-rank step against the port's one-process
step: every mask the ranks draw, joined in rank order, equals the
one-process mask bit for bit (so no two ranks share a mask), and the
steps agree at the limits above (the ranks sum their partial gradients in
another order than one backward does, so the updates agree to f32
roundoff, not bitwise). Both ranks end with bitwise equal parameters.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.layers as j_layers
from tests.test_torch_port_cl_methods import _reg_list
from tests.test_torch_port_episode import ROUNDOFF_GRAD
from tests.test_torch_port_mq_yaml import _bank, _batch, _jax_tiny
from tests.test_torch_port_train import _jcfg, _rel
from tests.test_torch_port_vq import _f64, _jax_model, _np64
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.data.synthetic import tiny_config as j_tiny
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.parallel import mesh as j_mesh
from vilco_tpu.tasks.nlq import nlq_tiny_config
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu.train import vq_engine as j_vq
from vilco_tpu_torch.core.config import (
    flagship_config,
    mq_yaml_config,
    nlq_flagship_config,
    vq_flagship_config,
)
from vilco_tpu_torch.data.synthetic import make_vq_batch, task_extras
from vilco_tpu_torch.data.synthetic import tiny_config
from vilco_tpu_torch.models.convert import params_from_jax, reg_tasks_from_jax
from vilco_tpu_torch.models.point_transformer import level_lengths
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.parallel.launch import spawn_ranks
from tests.test_torch_port_parallel_ranks import train_steps

RANKS = "tests.test_torch_port_parallel_ranks"    # the ranks' targets

SPAWN_TIMEOUT_S = 120
SPE = 1              # steps per epoch: the second step is at lr > 0
LR = 1e-4
RTOL = 1e-5          # loss, grad norm and loss terms, relative
PARAM_ATOL = 1e-6
# the VQ twin's lr is 3e-4 from the first step (no warmup), and AdamW's
# first update is lr g / (|g| + 1e-8): an element whose gradient is near
# 1e-8 moves by a share of lr that f32 roundoff changes. The port's
# one-process f32 step reads 9.2e-5 against JAX's f64 step on these
# batches (reduce1.conv.weight), the 2-rank step 4.7e-5; both under 0.5 lr
VQ_PARAM_ATOL = 1.5e-4
# the 2-rank step's gradients against the one-process step's, relative to
# the tree's largest gradient: a small leaf's gradient is a cancelling sum
# of large terms (the VQ reduce convs': 1e-4 from terms of 1e-1), whose
# f32 roundoff (1e-7 to 1e-6 here, and the one-process CPU step itself
# differs by that much between two runs) is no share of its own size
GRAD_RTOL = 1e-5
# VQ's channel-reduce convs feed a GroupNorm, which removes what their
# gradients' terms share: the gradient is a cancelling sum of terms 1e3
# larger, and the one-process CPU step itself reads 3.9e-4 of the tree's
# largest gradient between two runs in one process (reduce2.conv.weight)
VQ_GRAD_RTOL = 2e-3
TASK = 1             # the yaml's CL task: n_known > 0
EMA_DECAY = 0.5      # the yaml lockstep's adapter EMA decay
NLQ_LAMBDA = 3000.0
ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")
SHIFT_GRAD = ZERO_GRAD + ("adapter.fc2.bias",)
# this file's cases (the MQ yaml method's and NLQ's are in
# tests/test_torch_port_parallel_cl.py, so that the two files run side by
# side)
CASES = ("graft", "vq", "graft_dropout", "vq_dropout", "params_bf16")
# the compute copy: tests/test_torch_port_optim.py's bf16 lockstep limits
BF16_LOSS_RTOL, BF16_NORM_RTOL, BF16_STEP_FRAC = 2e-3, 5e-2, 0.25
PARAMS_BF16 = dict(opt={"param_compute_dtype": "bfloat16"},
                   model={"compute_dtype": "bfloat16"})


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread, as each CPU rank runs: the suite's
    workers share the host's cores, and a tiny model gains nothing from
    more threads while oversubscribed ones stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _points(m):
    return generate_points(level_lengths(m), m.fpn_strides,
                           m.regression_range)


def _perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


def _numpy(tree):
    return {n: t.numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _with_lr(cfg, lr=LR, accumulation_steps=1):
    return dataclasses.replace(cfg, opt=dataclasses.replace(
        cfg.opt, learning_rate=lr, accumulation_steps=accumulation_steps))


def _point_params(jcfg, batch, inputs, seed):
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *(
        None if batch.get(k) is None else jnp.asarray(batch[k])
        for k in inputs))["params"]
    return jmodel, _perturbed(params, seed)


# ---- the cases ----------------------------------------------------------------

def _graft(dropout=False):
    jcfg = _jcfg(xl_dropout=0.1 if dropout else 0.0)
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LR))
    rng = np.random.default_rng(3)
    batches = [j_make_batch(rng, 4 if dropout else 2, jcfg)
               for _ in range(2)]
    jmodel, params = _point_params(jcfg, batches[0], ("feats", "mask"), 7)
    cfg = _with_lr(flagship_config(tiny=True), LR, 2 if dropout else 1)
    if dropout:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dropout=0.1, droppath=0.1, xl_dropout=0.1))
    spec = dict(kind="point", cfg=cfg, params=_numpy(params),
                batches=batches, spe=SPE,
                cl=dict(class_mask=np.ones(cfg.model.num_classes, bool)),
                step=dict(regularize=dropout,
                          accumulation_steps=2 if dropout else 1),
                record=dropout)
    return spec, (jcfg, jmodel, params)


def _yaml():
    jcfg = _jax_tiny(xl_dropout=0.0)
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LR,
                                             accumulation_steps=2))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, jcfg, B=4) for _ in range(2)]
    # the first step: the prompts by the pool's vote over the global batch
    del batches[0]["prompt_mask"]
    jmodel, params = _point_params(
        jcfg, batches[1], ("feats", "mask", "text", "text_mask",
                           "narration", "narration_mask",
                           "narration_valid"), 9)
    cfg = _with_lr(mq_yaml_config(tiny=True), LR, 2)
    bank, ptr = _bank(1009)
    ex = task_extras(cfg, TASK, 4)
    spec = dict(kind="point", cfg=cfg, model_cl=cfg.cl_cfg,
                params=_numpy(params), batches=batches, spe=SPE,
                cl=dict(class_mask=ex["class_mask"], bank=bank, ptr=ptr),
                step=dict(regularize=False, cl_cfg=cfg.cl_cfg,
                          n_known=ex["n_known"], ema_decay=EMA_DECAY,
                          accumulation_steps=2))
    return spec, (jcfg, jmodel, params)


def _nlq():
    jcfg = nlq_tiny_config()
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LR),
                        cl_cfg=jcfg.cl_cfg.updated(name="ewc",
                                                   reg_lambda=NLQ_LAMBDA))
    rng = np.random.default_rng(6)
    batches = [j_make_batch(rng, 4, jcfg) for _ in range(2)]
    jmodel, params = _point_params(jcfg, batches[0],
                                   ("feats", "mask", "text", "text_mask"), 11)
    reg = _reg_list(params, 8)
    cfg = _with_lr(nlq_flagship_config(tiny=True))
    port_reg = [tuple({n: t.numpy() for n, t in d.items()} for d in task)
                for task in reg_tasks_from_jax(reg)]
    spec = dict(kind="point", cfg=cfg, params=_numpy(params),
                batches=batches, spe=SPE,
                cl=dict(class_mask=np.ones(1, bool), reg=port_reg,
                        **{"lambda": NLQ_LAMBDA}),
                step=dict(regularize=False))
    return spec, (jcfg, jmodel, params, reg)


def _vq(dropout=False):
    cfg = vq_flagship_config(tiny=True)
    jmodel = _jax_model(cfg)
    S = cfg.clip_size
    params = jax.jit(lambda k, c, q: jmodel.init(k, c, q,
                                                 deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, S, S, 3)),
        jnp.zeros((1, S, S, 3)))["params"]
    params = _perturbed(params, 5)
    batches = [make_vq_batch(np.random.default_rng(40 + i), 4, cfg)
               for i in range(2)]
    spec = dict(kind="vq", cfg=cfg, params=_numpy(params), batches=batches,
                dtype="float32", step=dict(deterministic=not dropout),
                record=dropout)
    return spec, (cfg, params)


def _params_bf16():
    jcfg = j_tiny(**PARAMS_BF16)
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LR))
    rng = np.random.default_rng(8)
    batches = [j_make_batch(rng, 4, jcfg) for _ in range(2)]
    jmodel, params = _point_params(jcfg, batches[0], ("feats", "mask"), 13)
    cfg = _with_lr(tiny_config(**PARAMS_BF16), LR)
    spec = dict(kind="point", cfg=cfg, params=_numpy(params),
                batches=batches, spe=SPE, dtype="bfloat16",
                cl=dict(class_mask=np.ones(cfg.model.num_classes, bool)),
                step=dict(regularize=False))
    return spec, (jcfg, jmodel, params)


BUILD = {"graft": _graft, "yaml": _yaml, "nlq": _nlq, "vq": _vq,
         "params_bf16": _params_bf16,
         "graft_dropout": lambda: _graft(dropout=True),
         "vq_dropout": lambda: _vq(dropout=True)}


def run_cases(names, tmp_dir):
    """({case: (spec, JAX side)}, {case: [rank 0's result, rank 1's]}):
    every case's steps in the same 2 Gloo ranks (one spawn)."""
    built = {c: BUILD[c]() for c in names}
    out = spawn_ranks(f"{RANKS}:rank_steps",
                      ["cpu", "cpu"], ([built[c][0] for c in names],),
                      timeout_s=SPAWN_TIMEOUT_S, tmp_dir=tmp_dir)
    return built, {c: [out[0][i], out[1][i]] for i, c in enumerate(names)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("dp")))


@pytest.fixture(scope="module")
def cases(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def _check_ranks_equal(res):
    a, b = res
    assert a["digest"] == b["digest"]
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n], n)
    assert a["metrics"] == b["metrics"]


def _check_params(got, want, atol, lr_sum, loose=ZERO_GRAD):
    assert set(got) == set(want)
    errs = {}
    for n, w in want.items():
        d = float(np.abs(np.asarray(got[n], np.float64) - w).max())
        if n.endswith(loose):
            assert d <= 2 * lr_sum, n
        else:
            errs[n] = d
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= atol, top


def _check_grads(got, want, limit=GRAD_RTOL):
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    errs = {n: np.abs(got[n] - w).max() / top for n, w in want.items()}
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= limit, top


def _jax_point_steps(jcfg, jmodel, params, batches, jcl, **kw):
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1),
        adapter_ema=(j_engine.init_adapter_ema(jparams)
                     if kw.pop("ema", False) else None))
    pts = jnp.asarray(_points(jcfg.model))
    step = j_engine.make_train_step(jmodel, tx, pts, jcfg, **kw)
    mets = []
    for b in batches:
        state, m, aux = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                             jcl)
        if kw.get("use_ssl"):
            jcl = jcl.replace(memory_bank=aux[0], memory_ptr=aux[1])
        mets.append({k: float(v) for k, v in m.items()})
    return state, mets, jcl


def _lr_sum(n):
    return n * LR


# ---- against JAX ----------------------------------------------------------------

def test_graft_dp_step_matches_jax(cases, ranks, monkeypatch):
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    spec, (jcfg, jmodel, params) = cases["graft"]
    jcl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))
    state, jm, _ = _jax_point_steps(jcfg, jmodel, params, spec["batches"],
                                    jcl)
    res = ranks["graft"]
    _check_ranks_equal(res)
    for tm, m in zip(res[0]["metrics"], jm):
        for k in ("final_loss", "grad_norm", "cls_loss", "reg_loss"):
            assert _rel(tm[k], m[k]) <= RTOL, k
        assert tm["num_pos"] == m["num_pos"]
    assert res[0]["norm"] == pytest.approx(float(state.loss_normalizer),
                                           rel=1e-7)
    _check_params(res[0]["params"], _numpy(state.params), PARAM_ATOL,
                  _lr_sum(2))


def test_vq_hnm_dp_step_matches_jax(cases, ranks):
    """HNM over the global batch: each rank's 2 clips against the 4
    queries (8 pairs a rank, 16 in all), the positives on the global
    diagonal, the counts global; against the JAX step in f64."""
    spec, (cfg, params) = cases["vq"]
    with jax.enable_x64(True):
        tx = j_vq.make_vq_optimizer(cfg.lr, cfg.weight_decay,
                                    grad_max=cfg.grad_max,
                                    milestones=cfg.lr_milestones,
                                    gamma=cfg.lr_gamma)
        jparams = _f64(params)
        state = j_vq.VQTrainState(step=jnp.zeros((), jnp.int32),
                                  params=jparams, opt_state=tx.init(jparams),
                                  rng=jax.random.PRNGKey(1))
        jstep = j_vq.make_vq_train_step(_jax_model(cfg, "float64"), tx,
                                        use_hnm=True, deterministic=True)
        jm = []
        for b in spec["batches"]:
            state, m = jstep(state, _f64(b))
            jm.append({k: float(v) for k, v in m.items()})
        want = {n: t.numpy() for n, t in _np64(state.params).items()}
    res = ranks["vq"]
    _check_ranks_equal(res)
    for tm, m in zip(res[0]["metrics"], jm):
        for k in ("final_loss", "loss_prob", "loss_giou", "loss_center"):
            assert _rel(tm[k], m[k]) <= RTOL, k
        assert tm["num_pos"] == m["num_pos"]
    trainable = {n: w for n, w in want.items()
                 if not n.startswith("backbone.")}
    got = {n: res[0]["params"][n] for n in trainable}
    _check_params(got, trainable, VQ_PARAM_ATOL, 0.0, ())
    with one_thread():
        one = train_steps(spec, "cpu")
    _check_grads(res[0]["grads"], one["grads"], VQ_GRAD_RTOL)
    for n, w in want.items():
        if n.startswith("backbone."):
            np.testing.assert_array_equal(res[0]["params"][n],
                                          params_of(params)[n], n)


def params_of(tree):
    return _numpy(tree)


def test_params_bf16_dp_step_matches_jax_on_a_2_device_mesh(cases, ranks):
    """train_cl --params-bf16 --dp 2: 2 Gloo ranks with the compute copy
    against JAX's step on a 2-device mesh (module docstring)."""
    spec, (jcfg, jmodel, params) = cases["params_bf16"]
    res = ranks["params_bf16"]
    _check_ranks_equal(res)
    for n in res[0]["copies"]:
        np.testing.assert_array_equal(res[0]["copies"][n],
                                      res[1]["copies"][n], n)
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm,
                                    jnp.float32),
        rng=jax.random.PRNGKey(1),
        params_c=j_optim.make_compute_copy(jparams))
    step = j_engine.make_train_step(jmodel, tx,
                                    jnp.asarray(_points(jcfg.model)), jcfg)
    jcl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))
    mesh = j_mesh.make_mesh(2, model_parallel=1)
    jm = []
    with mesh:
        state = jax.device_put(state, j_mesh.replicated(state, mesh))
        for b in spec["batches"]:
            state, m, _ = step(state, j_mesh.shard_batch(
                {k: jnp.asarray(v) for k, v in b.items()}, mesh), jcl)
            jm.append({k: float(v) for k, v in m.items()})
    for tm, m in zip(res[0]["metrics"], jm):
        assert _rel(tm["final_loss"], m["final_loss"]) <= BF16_LOSS_RTOL
        assert _rel(tm["grad_norm"], m["grad_norm"]) <= BF16_NORM_RTOL
    want = _numpy(state.params)
    lr_sum = _lr_sum(len(spec["batches"]))
    got = res[0]["params"]
    for n, w in want.items():
        err = np.abs(np.asarray(got[n], np.float64) - w)
        assert err.max() <= 2 * lr_sum, n
        if not n.endswith(ROUNDOFF_GRAD):
            assert np.median(err) <= BF16_STEP_FRAC * lr_sum, n
    assert res[0]["copies"]
    for n, c in res[0]["copies"].items():
        np.testing.assert_array_equal(
            c, torch.from_numpy(got[n]).to(torch.bfloat16).float().numpy(),
            n)


# ---- against the port's one-process step, with dropout ---------------------------

@pytest.mark.parametrize("case", ["graft_dropout", "vq_dropout"])
def test_dropout_dp_step_draws_the_one_process_masks(cases, ranks, case):
    """Dropout and drop-path at 0.1 (the graft twin's XL kernel dropout
    too; the VQ head's dropout, 0.2, over the HNM pairs): every mask the
    two ranks draw, joined in rank order, equals the one-process step's
    bit for bit; the losses agree at 1e-5 and the first step's gradients
    at GRAD_RTOL of the tree's largest (VQ_GRAD_RTOL for VQ: why there).
    The parameters are held to AdamW's own bound, 2 x the sum
    of the lrs: AdamW's first update is lr x sign(g), so an element whose
    gradient is f32 roundoff (a dropped channel's cancelling sum) moves by
    +-lr on either side."""
    spec = cases[case][0]
    with one_thread():
        one = train_steps(spec, "cpu")
    res = ranks[case]
    _check_ranks_equal(res)
    a, b = res[0]["draws"], res[1]["draws"]
    assert len(a) == len(b) == len(one["draws"]) > 0
    for i, (x, y, z) in enumerate(zip(a, b, one["draws"])):
        np.testing.assert_array_equal(np.concatenate([x, y]), z,
                                      err_msg=str(i))
        assert not np.array_equal(x, y) or x.size == 1
    for tm, m in zip(res[0]["metrics"], one["metrics"]):
        for k in ("final_loss", "grad_norm"):
            assert _rel(tm[k], m[k]) <= RTOL, k
    _check_grads(res[0]["grads"], one["grads"],
                 VQ_GRAD_RTOL if case == "vq_dropout" else GRAD_RTOL)
    lr = spec["cfg"].lr if case == "vq_dropout" else LR
    for n, w in one["params"].items():
        assert np.abs(res[0]["params"][n] - w).max() <= 2 * 2 * lr, n
