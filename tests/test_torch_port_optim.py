"""The port's `opt` section against the JAX package on the CPU: the config
fields both ways, the schedules step by step, the optimizer forms over a
small tree for 3 updates, K4's plain version in its new cases, the bf16
compute copy's mask, 2-step locksteps of the train step at the CLI's tiny
synthetic MQ config, and the CLI's optimizer flags.

Limits:
  the schedules 1e-6 relative (numpy's and XLA's f32 cos and pow may part
      in the last bit);
  FusedAdamW (mu and nu each bf16 or f32, and the compute copy through
      JAX's fused_apply_pc at a clip factor below 1) bit-equal to JAX's
      eager update at a constant lr (warmup off, multistep with no
      milestone: both schedules give the peak exactly);
  the chains (factored with mu bf16 and f32, SGD with momentum) 1e-6 of
      each leaf's largest value (optax's `x ** -0.5` against rsqrt, and
      XLA's means against torch's);
  adamw_update_plain's new cases (split moment dtypes, a bf16 gradient
      with JAX's clip) bit-equal to JAX's `_fused` expression op by op;
  the 2-step locksteps (the CLI's tiny config from JAX's init perturbed by
      N(0, 0.02), SPE 1, lr 2e-3, so 0 then 2e-3): every element within
      twice the most the form can move it (lr x 1 a step for AdamW, x the
      factored form's (t + 1)^0.4 through its 0.9 trace): an element of
      roundoff gradient may go either way; the f32 forms' losses and norms
      1e-5 relative and 99% of each leaf's elements within 5e-5 of its
      largest value (the 3-step trajectory's rule; 99.80% measured, the
      rest of near-zero gradient); with the compute copy, both sides in
      bf16 activations, the loss 2e-3 and the norm 5e-2 relative (JAX's
      and torch's bf16 matmuls part by 3% in the second step's norm, with
      the copy and without it alike), each leaf's median error within 0.25
      of the summed lr (0.109 measured: AdamW normalises the bf16
      gradients' differences), and each copy equal to its master rounded
      to bf16. The leaves of roundoff gradient (ROUNDOFF_GRAD) are held to
      the bound only.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_episode import ROUNDOFF_GRAD
from tests.test_torch_port_parallel_steps import one_thread
from vilco_tpu.core.config import Config as JConfig
from vilco_tpu.core.config import OptCfg as JOptCfg
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.data.synthetic import tiny_config as j_tiny
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.bin import train_cl
from vilco_tpu_torch.cl.regularizers import RegPenalty
from vilco_tpu_torch.core import config as t_config
from vilco_tpu_torch.core.config import OptCfg, mq_yaml_config
from vilco_tpu_torch.data.synthetic import tiny_config
from vilco_tpu_torch.kernels.adamw import B1, B2, EPS, adamw_update_plain
from vilco_tpu_torch.models.convert import (
    load_jax_params,
    params_from_jax,
    port_name,
    reg_tasks_from_jax,
)
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.train import engine as t_engine
from vilco_tpu_torch.train import optim as t_optim

CPU = ["--device", "cpu"]
SCHED_RTOL = 1e-6
CHAIN_RTOL = 1e-6
TRACE_BF16_RTOL = 2.0 ** -7
STEP_RTOL = 1e-5
PARAM_RTOL = 5e-5
BF16_LOSS_RTOL = 2e-3
BF16_NORM_RTOL = 5e-2
BF16_STEP_FRAC = 0.25
PARAM_KEEP = 0.99
SPE = 1
BF16 = jnp.bfloat16


# ------------------------------------------------------------- the config

def test_opt_section_round_trips_with_jax(tmp_path):
    """Every field of JAX's opt section that its optimizer reads, set away
    from its default, reads into the port's OptCfg and back into JAX's;
    the defaults are JAX's."""
    jopt = JOptCfg()
    assert all(getattr(OptCfg(), f.name) == getattr(jopt, f.name)
               for f in dataclasses.fields(OptCfg))
    over = {"type": "sgd", "momentum": 0.8, "weight_decay": 0.01,
            "warmup": False, "schedule_type": "multistep",
            "schedule_steps": (2, 5), "schedule_gamma": 0.5,
            "eta_min": 1e-6, "mu_dtype": "float32", "nu_dtype": "float32",
            "second_moment": "factored", "param_compute_dtype": "bfloat16"}
    jcfg = j_tiny(opt=over)
    port = t_config.config_from_dict(jcfg.to_dict())
    for k, v in over.items():
        assert getattr(port.opt, k) == v, k
    back = JConfig.from_dict(port.to_dict())
    assert back.opt == jcfg.opt


# ----------------------------------------------------------- the schedules

@pytest.mark.parametrize("opt", [
    dict(schedule_type="multistep", schedule_steps=(3, 1, 6),
         schedule_gamma=0.3),
    dict(schedule_type="multistep", schedule_steps=(2,), warmup=False),
    dict(warmup=False, eta_min=1e-6),
], ids=["multistep", "multistep_no_warmup", "cosine_no_warmup"])
def test_schedule_matches_jax(opt):
    base = dict(learning_rate=3e-4, epochs=8, warmup_epochs=2)
    jsched = j_optim.make_schedule(JOptCfg(**base, **opt), 5)
    sched = t_optim.make_schedule(OptCfg(**base, **opt), 5)
    for s in range(0, 60):
        np.testing.assert_allclose(sched(s), float(jsched(s)),
                                   rtol=SCHED_RTOL, err_msg=str(s))


# ------------------------------------------------------ a small tree, 3 steps

def _tree(rng):
    """A JAX tree of the trunk's kinds of leaf: conv and Dense kernels
    (one big leaf, one square, one that factors along other axes in the
    port's layout than in JAX's), biases, a norm scale, a head kernel, the
    prompt pool and a Gaussian."""
    n = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    return {
        "backbone": {
            "embd_0": {"kernel": n(3, 16, 160), "bias": n(160)},
            "big": {"kernel": n(512, 512)},
            "sq": {"kernel": n(256, 256), "bias": n(256)},
            "norm": {"scale": n(160)},
        },
        "cls_head": {"cls": {"kernel": n(3, 32, 130)}},
        "prompt": {"prompt": n(4, 2, 8)},
        "mu": n(10),
    }


def _module(state_dict):
    """A module holding `state_dict`'s tensors as parameters, by name."""
    root = torch.nn.Module()
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        m = root
        for k in mods:
            if not hasattr(m, k):
                m.add_module(k, torch.nn.Module())
            m = getattr(m, k)
        m.register_parameter(leaf, torch.nn.Parameter(t.clone()))
    return root


FORMS = {
    "adamw_mu_bf16_nu_f32": dict(nu_dtype="float32"),
    "adamw_mu_f32_nu_bf16": dict(mu_dtype="float32"),
    "adamw_f32": dict(mu_dtype="float32", nu_dtype="float32"),
    "compute_copy": dict(param_compute_dtype="bfloat16"),
    "factored_mu_bf16": dict(second_moment="factored"),
    "factored_mu_f32": dict(second_moment="factored", mu_dtype="float32",
                            nu_dtype="float32"),
    "sgd": dict(type="sgd", momentum=0.8, nu_dtype="float32"),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_optimizer_forms_match_jax(form):
    """3 updates of make_optimizer's form against JAX's optimizer, the same
    gradients (bf16 on the compute copy's leaves) and a clip factor 0.7
    applied as JAX's step applies it, at a constant lr."""
    kw = dict(learning_rate=1e-2, warmup=False, schedule_type="multistep",
              weight_decay=0.05, **FORMS[form])
    rng = np.random.default_rng(0)
    params = _tree(rng)
    model = _module(params_from_jax(params))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = t_optim.make_optimizer(OptCfg(**kw), model, SPE)
        jparams = jax.tree.map(jnp.asarray, params)
        tx, _ = j_optim.make_optimizer(JOptCfg(**kw), jparams, SPE)
    state = tx.init(jparams)
    pc = opt.copies is not None
    jmask = (j_optim.param_compute_mask(jparams) if pc else
             jax.tree.map(lambda _: False, jparams))
    scale = jnp.float32(0.7)
    for _ in range(3):
        raw = jax.tree.map(
            lambda a, m: jnp.asarray(rng.standard_normal(a.shape)
                                     .astype(np.float32))
            .astype(BF16 if m else jnp.float32), jparams, jmask)
        grads = jax.tree.map(lambda g: g * scale.astype(g.dtype), raw)
        if pc:
            jparams, jpc, state = tx.fused_apply_pc(grads, state, jparams)
        elif hasattr(tx, "fused_apply"):
            jparams, state = tx.fused_apply(grads, state, jparams)
        else:
            upd, state = tx.update(grads, state, jparams)
            jparams = optax.apply_updates(jparams, upd)
        tg = params_from_jax(jax.tree.map(
            lambda g: np.asarray(g.astype(jnp.float32)), raw))
        opt.zero_grad()
        for n, p in model.named_parameters():
            if pc and n in opt.copies:
                opt.copies[n].grad.copy_(tg[n])
            else:
                p.grad.copy_(tg[n])
        opt.stage()
        opt.update(torch.tensor(0.7), bf16_grads=pc)
        opt.count += 1
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    start = params_from_jax(params)
    for n, p in model.named_parameters():
        w, got = want[n].numpy(), p.detach().numpy()
        err = np.abs(got - w).max()
        if form.startswith(("adamw", "compute")):
            np.testing.assert_array_equal(got, w, err_msg=n)
        elif form == "factored_mu_bf16":
            # a last-bit difference of the update can round the bf16 trace
            # to its neighbour, which the next updates carry
            moved = np.abs(w - start[n].numpy()).max()
            assert err <= TRACE_BF16_RTOL * moved, n
        else:
            assert err <= CHAIN_RTOL * np.abs(w).max(), n
    if pc:
        copies = params_from_jax(_unflatten(
            {k: np.asarray(v.astype(jnp.float32)) for k, v in jpc.items()}))
        assert set(copies) == set(opt.copies)
        for n, c in opt.copies.items():
            np.testing.assert_array_equal(c.detach().float().numpy(),
                                          copies[n].numpy(), err_msg=n)


def _unflatten(flat):
    """{'a/b/kernel': x} -> {'a': {'b': {'kernel': x}}}."""
    tree = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        d = tree
        for k in mods:
            d = d.setdefault(k, {})
        d[leaf] = v
    return tree


def test_penalty_reads_the_compute_copy_as_jax():
    """The EWC/MAS penalty with the compute copy against JAX's reg_penalty
    on the forward's parameters (the bf16 overlay injected): its value
    1e-5 relative; the gradients of the unmasked leaves (f32) 1e-5 of each
    leaf's largest, those of the copy's leaves bf16 as JAX's and within
    one bf16 step (2^-8) of each leaf's largest (JAX rounds its f32
    gradient to bf16, the port its f64 one)."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    lam = 3000.0
    tasks = [(jax.tree.map(lambda a: np.abs(rng.standard_normal(
        a.shape)).astype(np.float32) * 1e-2, params),
        jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)) for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, params)
    fwd = j_engine.inject_adapters(jp, j_optim.make_compute_copy(jp))
    stack = lambda i: jax.tree.map(lambda *a: jnp.stack(a),
                                   *[t[i] for t in tasks])
    jval, jgrad = jax.value_and_grad(lambda p: j_engine.reg_penalty(
        p, stack(0), stack(1), lam))(fwd)
    model = _module(params_from_jax(params))
    opt = t_optim.make_optimizer(OptCfg(param_compute_dtype="bfloat16"),
                                 model, SPE)
    pen = RegPenalty.for_optimizer(reg_tasks_from_jax(tasks), opt, lam)
    opt.zero_grad()
    val = pen.apply(opt.param_flat, opt.grad_flat, opt, bf16_grads=True)
    assert abs(float(val) - float(jval)) <= 1e-5 * abs(float(jval))
    want = params_from_jax(jax.tree.map(
        lambda g: np.asarray(g.astype(jnp.float32)), jgrad))
    for n, p in model.named_parameters():
        w = want[n].numpy()
        if n in opt.copies:
            got = opt.copies[n].grad
            assert got.dtype == torch.bfloat16
            lim = 2.0 ** -8 * np.abs(w).max()
        else:
            got, lim = p.grad, 1e-5 * np.abs(w).max()
        assert np.abs(got.float().numpy() - w).max() <= lim, n


# ------------------------------------------- K4's plain version, new cases

@pytest.mark.parametrize("mdt,vdt,gbf", [
    ("bfloat16", "float32", False), ("float32", "bfloat16", False),
    ("float32", "float32", True), ("bfloat16", "bfloat16", True)])
def test_adamw_plain_new_cases_bit_equal_to_jax(mdt, vdt, gbf):
    """adamw_update_plain with m and v in their own dtypes and a bf16
    gradient against JAX's `_fused` update op by op, the clip of a bf16
    gradient as JAX's step applies it (`g * scale.astype(g.dtype)`):
    p, m and v bit-equal."""
    rng = np.random.default_rng(3)
    n = 8 * 128 * 3
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    mj = jnp.asarray(rng.standard_normal(n), jnp.float32).astype(mdt)
    vj = jnp.asarray(np.abs(rng.standard_normal(n)), jnp.float32).astype(vdt)
    lr, bc1, bc2 = (np.float32(1e-3), np.float32(1 - B1 ** 3),
                    np.float32(1 - B2 ** 3))
    scale = jnp.float32(0.37)
    jg = jnp.asarray(g).astype(BF16 if gbf else jnp.float32)
    jg = (jg * scale.astype(jg.dtype)).astype(jnp.float32)
    m2 = (1.0 - B1) * jg + B1 * mj
    v2 = (1.0 - B2) * (jg * jg) + B2 * vj.astype(jnp.float32)
    u = (m2 / bc1) / (jnp.sqrt(v2 / bc2) + EPS) + 0.05 * jnp.asarray(p)
    want = (jnp.asarray(p) - lr * u, m2.astype(mdt), v2.astype(vdt))
    to_t = lambda a: torch.from_numpy(np.asarray(
        jnp.asarray(a).astype(jnp.float32))).to(getattr(torch, str(
            jnp.asarray(a).dtype)))
    tg = torch.from_numpy(g).to(torch.bfloat16 if gbf else torch.float32)
    got = adamw_update_plain(torch.from_numpy(p), tg, to_t(mj), to_t(vj),
                             True, lr, bc1, bc2, torch.tensor(0.37))
    assert (got[1].dtype, got[2].dtype) == (getattr(torch, mdt),
                                            getattr(torch, vdt))
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)),
            err_msg=name)


# --------------------------------------------------- the compute copy's mask

def test_param_compute_mask_matches_jax():
    """The port's names of the compute copy's leaves (param_computes) are
    JAX's param_compute_mask through models/convert.py, on the MQ yaml's
    tiny twin: the trunk's and heads' kernels bf16; the prompt pool, the
    narration encoder, the norms and the Gaussians f32."""
    jcfg = j_tiny(dataset={"use_text": True, "use_narration": True},
                  model={"use_xl": True, "use_cross_modal": True},
                  cl_cfg={"name": "l2p", "memory_size": 1010,
                          "prompt_pool": True, "narration_ssl": True,
                          "use_adapt": True,
                          "adapt_blocks": (0, 1, 2, 3, 4)})
    m, cl = jcfg.model, jcfg.cl_cfg
    T, L = m.max_seq_len, jcfg.dataset.max_text_len
    Ln = jcfg.dataset.max_narration_len
    spec = lambda *s, dt=jnp.float32: jax.ShapeDtypeStruct(s, dt)
    shapes = jax.eval_shape(
        JPT(m, cl).init, jax.random.PRNGKey(0),
        spec(1, T, m.input_dim), spec(1, T, dt=jnp.bool_),
        spec(1, L, m.n_txt_in), spec(1, L, dt=jnp.bool_),
        spec(1, Ln, cl.narration_dim), spec(1, Ln, dt=jnp.bool_),
        spec(1, dt=jnp.bool_))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jmask = jax.tree_util.tree_leaves(j_optim.param_compute_mask(shapes))
    want = {port_name(tuple(p.key for p in path), len(a.shape)): bool(c)
            for (path, a), c in zip(flat, jmask)}
    cfg = mq_yaml_config(tiny=True)
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    got = t_optim.param_compute_mask(model.named_parameters())
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    for n in ("prompt.prompt", "prompt.prompt_key",
              "narration_encoder.weight", "mu"):
        assert not got[n], n
    copy = t_optim.make_compute_copy(model.named_parameters())
    assert set(copy) == {n for n, c in got.items() if c}
    assert all(c.dtype == torch.bfloat16 for c in copy.values())


# --------------------------------------------- 2-step locksteps of the step

LOCKSTEP_FORMS = {
    "factored": dict(opt={"second_moment": "factored"}),
    "f32_moments": dict(opt={"mu_dtype": "float32", "nu_dtype": "float32"}),
    "params_bf16": dict(opt={"param_compute_dtype": "bfloat16"},
                        model={"compute_dtype": "bfloat16"}),
}


@pytest.fixture(scope="module")
def tiny_start():
    """JAX's init of the CLI's tiny MQ config perturbed by N(0, 0.02) (the
    parameters do not depend on the compute dtype), and two batches."""
    jcfg = j_tiny()
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [j_make_batch(rng, 2, jcfg) for _ in range(2)]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batches[0]["feats"]),
                                  jnp.asarray(batches[0]["mask"]))["params"]
    prng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * prng
                          .standard_normal(np.shape(a)).astype(np.float32),
                          params)
    return params, batches


@pytest.mark.parametrize("form", list(LOCKSTEP_FORMS))
def test_two_step_lockstep_matches_jax(form, tiny_start):
    """Two train steps of the CLI's tiny synthetic MQ config under the
    form's opt section (and --compute-dtype bfloat16 with the compute
    copy) from the same parameters and batches, against JAX's
    make_train_step."""
    ov = LOCKSTEP_FORMS[form]
    jcfg = j_tiny(**ov)
    cfg = tiny_config(**ov)
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    params, batches = tiny_start
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams = jax.tree.map(jnp.asarray, params)
        tx, _ = j_optim.make_optimizer(jcfg.opt, jparams, SPE)
    bf16 = form == "params_bf16"
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        # not weak-typed, as the step returns it: one compile, not two
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm,
                                    jnp.float32),
        rng=jax.random.PRNGKey(1),
        params_c=j_optim.make_compute_copy(jparams) if bf16 else None)
    m = cfg.model
    pts = generate_points(level_lengths(m), m.fpn_strides,
                          m.regression_range)
    jstep = j_engine.make_train_step(jmodel, tx, jnp.asarray(pts), jcfg)
    jcl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))
    with one_thread(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = PointTransformer(m, device="cpu", cl=cfg.cl_cfg)
        load_jax_params(model, params)
        tstate = t_engine.init_train_state(model, cfg, SPE, device="cpu")
        tstep = t_engine.make_train_step(
            torch.from_numpy(pts), cfg.train_cfg, regularize=False,
            compute_dtype=getattr(torch, m.compute_dtype))
        tcl = t_engine.CLBatchExtras(
            torch.ones(m.num_classes, dtype=torch.bool))
        assert (tstate.opt.copies is not None) == bf16
        if form == "factored":
            assert all(t.dtype == torch.bfloat16
                       for t in tstate.opt.trace)
        elif form == "f32_moments":
            assert all(t.dtype == torch.float32 for t in
                       tstate.opt.mu_big + tstate.opt.nu_big
                       + [tstate.opt.mu_flat, tstate.opt.nu_flat])
        rtol = ({"final_loss": BF16_LOSS_RTOL, "grad_norm": BF16_NORM_RTOL}
                if bf16 else {"final_loss": STEP_RTOL,
                              "grad_norm": STEP_RTOL})
        for batch in batches:
            state, jm, _ = jstep(state, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, jcl)
            tm = tstep(tstate, t_engine.batch_to(batch, "cpu"), tcl)
            for k, tol in rtol.items():
                assert abs(float(tm[k]) - float(jm[k])) <= tol * abs(
                    float(jm[k])), k
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    start = params_from_jax(params)
    sched = t_optim.make_schedule(cfg.opt, SPE)
    lrs = [float(sched(s)) for s in range(len(batches))]
    # the most an element can move: lr x the largest update of the form
    # (AdamW ~1; the factored form's (t+1)^0.4 through its 0.9 trace)
    bound = sum(lr * (_factored_bound(t) if form == "factored" else 1.0)
                for t, lr in enumerate(lrs))
    for n, p in model.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        err = np.abs(got - w)
        assert err.max() <= 2 * bound, n
        if n.endswith(ROUNDOFF_GRAD):
            continue
        if bf16:
            assert np.median(err) <= BF16_STEP_FRAC * sum(lrs), n
            if n in tstate.opt.copies:
                np.testing.assert_array_equal(
                    tstate.opt.copies[n].detach().float().numpy(),
                    p.detach().to(torch.bfloat16).float().numpy(),
                    err_msg=n)
        else:
            assert np.mean(err <= PARAM_RTOL * np.abs(w).max()) >= \
                PARAM_KEEP, n


def _factored_bound(t: int) -> float:
    """The largest |update| of the factored form at step t: the trace of
    updates each at most (k + 1)^0.4 (1 / sqrt(1 - decay_rate_k))."""
    return sum(0.9 ** (t - k) * (k + 1) ** 0.4 for k in range(t + 1))


# ----------------------------------------------------------------- the CLI

def test_train_cl_takes_the_optimizer_flags(tmp_path):
    """--factored, --mu-dtype, --nu-dtype and --params-bf16 set JAX's opt
    fields; an MQ episode runs with the compute copy on the CPU."""
    p = train_cl.argparse.ArgumentParser()
    args = train_cl.parse(p, ["--factored", "--mu-dtype", "float32",
                              "--nu-dtype", "float32", "--params-bf16"])
    opt = train_cl.apply_overrides(tiny_config(), args).opt
    assert (opt.second_moment, opt.mu_dtype, opt.nu_dtype,
            opt.param_compute_dtype) == ("factored", "float32", "float32",
                                         "bfloat16")
    with one_thread():
        res = train_cl.main(["--synthetic", "--params-bf16",
                             "--compute-dtype", "bfloat16", "--epochs", "1",
                             "--num-tasks", "2", "--synthetic-videos", "2",
                             "1", "--workdir", str(tmp_path), *CPU])
    assert len(res["tasks"]) == 2 and np.isfinite(res["final"]["avg_mAP"])
    saved = t_config.load_config(str(tmp_path / "config.json"))
    assert saved.opt.param_compute_dtype == "bfloat16"


def test_vq_runner_ignores_the_optimizer_flags(tmp_path, monkeypatch,
                                               capsys):
    """The VQ runner reads none of --factored, --mu-dtype and --nu-dtype,
    as in JAX: its keywords are the same with and without them; and
    --params-bf16 with --task vq exits with JAX's message."""
    from vilco_tpu_torch.tasks import vq as t_vq

    seen = []

    class Stop(Exception):
        pass

    def runner(*a, **kw):
        seen.append((a[2:], kw))
        raise Stop

    monkeypatch.setattr(t_vq, "VQEpisodeRunner", runner)
    base = ["--task", "vq", "--synthetic", "--workdir", str(tmp_path), *CPU]
    for extra in ([], ["--factored", "--mu-dtype", "float32",
                       "--nu-dtype", "float32"]):
        with pytest.raises(Stop):
            train_cl.main(base + extra)
    assert seen[0] == seen[1]
    with pytest.raises(SystemExit) as e:
        train_cl.main(base + ["--params-bf16"])
    assert e.value.code != 0
    assert "VQ runner's optimizer does not consume it" in \
        capsys.readouterr().err
