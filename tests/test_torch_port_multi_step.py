"""The port's make_multi_train_step (train/engine.py) on the CPU, where it
runs its K steps eagerly:

  - against JAX's make_multi_train_step (K = 3, one `lax.scan` of the step
    in one jit), built as tests/test_model_engine.py builds it, from the
    same perturbed parameters and stacked batches: the naive method at the
    flagship's tiny twin (XL on), the MQ yaml's method (L2P, narration SSL
    with the bank carried over the steps and its write wrapping, the
    adapter EMA at decay 0.5) and the naive method at accumulation 2 (as
    bench.py runs the scanned step). Limits of
    tests/test_torch_port_train.py's 3-step lockstep: the last step's loss,
    grad norm and every other metric 1e-5 relative, every parameter (and
    EMA) leaf within 5e-5 of its largest value, the loss normaliser 1e-7,
    the bank 1e-5 of its largest value, the pointer exact; the yaml's
    SHIFT_GRAD leaves within 2 x the summed lr, as in its lockstep;
  - against K calls of the port's own make_train_step, with dropout and
    drop-path on: bitwise (parameters, moments, normaliser, bank, pointer,
    adapter EMA, the last metrics and the generator's state);
  - its refusals: `cl.prev_logits`, batches not stacked K deep, and data
    parallelism on a Gloo group off the CPU (a graph cannot capture
    Gloo's collectives; meta tensors reach the check without a card).

The graph path itself (capture, replays bitwise against eager steps) is
card-only: tests/test_torch_port_cuda.py and chip_smoke.py's multi_step.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.layers as j_layers
from tests.test_torch_port_mq_yaml import (
    INPUTS,
    SHIFT_GRAD,
    _bank,
    _batch,
    _jax_tiny,
    _perturbed,
)
from tests.test_torch_port_train import _jcfg, _points, _rel
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.core.config import flagship_config, mq_yaml_config
from vilco_tpu_torch.data.synthetic import task_extras
from vilco_tpu_torch.models.convert import (
    adapter_ema_from_jax,
    load_jax_params,
    params_from_jax,
)
from vilco_tpu_torch.models.point_transformer import PointTransformer
from vilco_tpu_torch.parallel.mesh import DataParallel
from vilco_tpu_torch.train import engine as t_engine

K = 3
SPE = 1
RTOL = 1e-5
PARAM_RTOL = 5e-5
NORM_RTOL = 1e-7
YAML_LR = 1e-4          # the yaml lockstep's lr and EMA decay
YAML_EMA_DECAY = 0.5
TASK = 1


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _case(name):
    """(JAX config, JAX model, perturbed params, K batches, port config,
    the steps' flags on each side, the CL extras' numpy parts)."""
    if name == "yaml":
        jcfg = _jax_tiny(xl_dropout=0.0)
        jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=YAML_LR))
        rng = np.random.default_rng(0)
        batches = [_batch(rng, jcfg) for _ in range(K)]
        jmodel = JPT(jcfg.model, jcfg.cl_cfg)
        params = jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                     for k in INPUTS))["params"]
        cfg = mq_yaml_config(tiny=True)
        cfg = dataclasses.replace(cfg, opt=dataclasses.replace(
            cfg.opt, learning_rate=YAML_LR))
        ex = task_extras(cfg, TASK, 2)
        jflags = dict(cl_method="l2p", use_ssl=True, use_prompt=True,
                      n_known=ex["n_known"], ema_decay=YAML_EMA_DECAY)
        tflags = dict(cl_cfg=cfg.cl_cfg, n_known=ex["n_known"],
                      ema_decay=YAML_EMA_DECAY)
        bank, ptr = _bank()
        cl = dict(class_mask=ex["class_mask"], bank=bank, ptr=ptr)
        return (jcfg, jmodel, _perturbed(params, 7), batches, cfg, jflags,
                tflags, cl)
    accum = 2 if name == "accum2" else 1
    jcfg = _jcfg()
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [j_make_batch(rng, 2 * accum, jcfg) for _ in range(K)]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0]["feats"]),
                                  jnp.asarray(batches[0]["mask"]))["params"]
    cfg = flagship_config(tiny=True)
    flags = dict(accumulation_steps=accum) if accum > 1 else {}
    cl = dict(class_mask=np.ones(cfg.model.num_classes, bool))
    return (jcfg, jmodel, _perturbed(params, 7), batches, cfg, flags, flags,
            cl)


def _jax_multi(jcfg, jmodel, params, batches, flags, cl, ema):
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1),
        adapter_ema=j_engine.init_adapter_ema(jparams) if ema else None)
    pts = jnp.asarray(_points(jcfg.model))
    jcl = j_engine.CLBatchExtras(
        class_mask=jnp.asarray(cl["class_mask"]),
        **({} if "bank" not in cl else dict(
            memory_bank=jnp.asarray(cl["bank"]),
            memory_ptr=jnp.asarray(cl["ptr"], jnp.int32))))
    multi = j_engine.make_multi_train_step(jmodel, tx, pts, jcfg, K, **flags)
    stacked = {k: jnp.asarray(v) for k, v in _stack(batches).items()}
    return multi(state, stacked, jcl)


def _port_state(params, cfg, seed=1):
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    load_jax_params(model, params)
    return t_engine.init_train_state(model, cfg, SPE, seed=seed,
                                     device="cpu")


def _port_cl(cl):
    return t_engine.CLBatchExtras(
        torch.from_numpy(cl["class_mask"]),
        *(() if "bank" not in cl else (torch.tensor(cl["bank"]),
                                       torch.tensor(cl["ptr"]))))


@pytest.mark.parametrize("case", ["naive", "yaml", "accum2"])
def test_multi_step_matches_jax(case, monkeypatch):
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    jcfg, jmodel, params, batches, cfg, jflags, tflags, cl = _case(case)
    yaml = case == "yaml"
    state, jm, (jbank, jptr) = _jax_multi(jcfg, jmodel, params, batches,
                                          jflags, cl, ema=yaml)
    assert int(state.step) == K
    tstate = _port_state(params, cfg)
    tcl = _port_cl(cl)
    multi = t_engine.make_multi_train_step(
        torch.from_numpy(_points(cfg.model)), cfg.train_cfg, K,
        regularize=False, **tflags)
    tm = multi(tstate, t_engine.batch_to(_stack(batches), "cpu"), tcl)
    assert tstate.step == tstate.opt.count == K
    assert {"final_loss", "grad_norm"} <= set(tm) <= set(jm)
    for k in tm:
        assert _rel(tm[k], jm[k]) <= RTOL, k
    assert tstate.loss_normalizer.item() == pytest.approx(
        float(state.loss_normalizer), rel=NORM_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    got = {n: p.detach() for n, p in tstate.model.named_parameters()}
    if yaml:
        assert int(tcl.memory_ptr) == int(jptr) == (1008 + K) % 1010
        assert _rel(tcl.memory_bank.numpy(), np.asarray(jbank)) <= RTOL
        ema = adapter_ema_from_jax(state.adapter_ema)
        assert set(ema) == set(tstate.adapter_ema)
        got.update({"ema:" + n: e for n, e in tstate.adapter_ema.items()})
        want.update({"ema:" + n: e for n, e in ema.items()})
    lr_sum = sum(float(tstate.opt.sched(s)) for s in range(K))
    errs = {}
    for n, g in got.items():
        if yaml and n.endswith(SHIFT_GRAD):
            assert np.abs(g.numpy() - want[n].numpy()).max() \
                <= 2 * lr_sum, n
        else:
            errs[n] = _rel(g.numpy(), want[n].numpy())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= PARAM_RTOL, top


def _regularised_yaml():
    cfg = mq_yaml_config(tiny=True)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.1, droppath=0.1, xl_dropout=0.1))


def test_multi_step_equals_k_port_steps():
    """The yaml's method with dropout, drop-path and the XL kernel's dropout
    at 0.1: K steps of multi and K calls of make_train_step, each from its
    own copy of one state, bank and generator, agree bit for bit."""
    jcfg = _jax_tiny(xl_dropout=0.0)
    batches = [_batch(np.random.default_rng(3), jcfg) for _ in range(K)]
    cfg = _regularised_yaml()
    ex = task_extras(cfg, TASK, 2)
    flags = dict(cl_cfg=cfg.cl_cfg, n_known=ex["n_known"],
                 ema_decay=YAML_EMA_DECAY)
    pts = torch.from_numpy(_points(cfg.model))
    bank, ptr = _bank()
    cl = dict(class_mask=ex["class_mask"], bank=bank, ptr=ptr)

    def fresh():
        model = PointTransformer(cfg.model, torch.Generator().manual_seed(5),
                                 device="cpu", cl=cfg.cl_cfg)
        st = t_engine.init_train_state(model, cfg, SPE, seed=9,
                                       device="cpu")
        return st, _port_cl(cl)

    s1, c1 = fresh()
    step = t_engine.make_train_step(pts, cfg.train_cfg, regularize=True,
                                    **flags)
    for b in batches:
        m1 = step(s1, t_engine.batch_to(b, "cpu"), c1)
    s2, c2 = fresh()
    multi = t_engine.make_multi_train_step(pts, cfg.train_cfg, K,
                                           regularize=True, **flags)
    m2 = multi(s2, t_engine.batch_to(_stack(batches), "cpu"), c2)
    assert s1.step == s2.step == K and s1.opt.count == s2.opt.count == K
    assert m1.keys() == m2.keys()
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for (n, a), b in zip(s1.model.named_parameters(), s2.model.parameters()):
        assert torch.equal(a, b), n
    mu1, nu1 = s1.opt.moments()
    mu2, nu2 = s2.opt.moments()
    for n in mu1:
        assert torch.equal(mu1[n], mu2[n]) and torch.equal(nu1[n], nu2[n]), n
    for n, e in s1.adapter_ema.items():
        assert torch.equal(e, s2.adapter_ema[n]), n
    assert torch.equal(s1.loss_normalizer, s2.loss_normalizer)
    assert torch.equal(c1.memory_bank, c2.memory_bank)
    assert int(c1.memory_ptr) == int(c2.memory_ptr) == (1008 + K) % 1010
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())
    # the steps moved the generator and the bank
    assert not torch.equal(s1.generator.get_state(), fresh()[0].generator
                           .get_state())
    assert not torch.equal(c1.memory_bank, torch.from_numpy(bank))


def _tiny_multi(**flags):
    cfg = flagship_config(tiny=True)
    return cfg, t_engine.make_multi_train_step(
        torch.from_numpy(_points(cfg.model)), cfg.train_cfg, K, **flags)


def test_multi_step_refuses_prev_logits_and_a_wrong_depth():
    cfg, multi = _tiny_multi()
    model = PointTransformer(cfg.model, device="cpu")
    st = t_engine.init_train_state(model, cfg, SPE, device="cpu")
    batches = t_engine.batch_to(_stack(
        [j_make_batch(np.random.default_rng(i), 2, _jcfg())
         for i in range(K)]), "cpu")
    C = cfg.model.num_classes
    cl = t_engine.CLBatchExtras(torch.ones(C, dtype=torch.bool),
                                prev_logits=torch.zeros(2, 1, C))
    with pytest.raises(ValueError, match="prev_logits"):
        multi(st, batches, cl)
    cl = t_engine.CLBatchExtras(torch.ones(C, dtype=torch.bool))
    with pytest.raises(ValueError, match="stacked 3 deep"):
        multi(st, {k: v[:2] for k, v in batches.items()}, cl)
    assert st.step == st.opt.count == 0


def test_multi_step_refuses_a_gloo_group_off_the_cpu(tmp_path):
    """With dp on a Gloo group, batches off the CPU (meta tensors stand in
    for the card's) raise before any step: a CUDA graph cannot capture
    Gloo's collectives."""
    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                rank=0, world_size=1)
    try:
        group = None if own else dist.new_group([0], backend="gloo")
        dp = DataParallel(0, 1, group)
        _, multi = _tiny_multi(dp=dp)
        batches = {"feats": torch.empty(K, 2, 8, 4, device="meta")}
        cl = t_engine.CLBatchExtras(torch.ones(4, dtype=torch.bool))
        with pytest.raises(ValueError, match="gloo.*Gloo's collectives"):
            multi(None, batches, cl)
    finally:
        if own:
            dist.destroy_process_group()
