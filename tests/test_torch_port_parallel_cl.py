"""The port's data-parallel train steps on the CPU, part 2: the MQ yaml's
method (L2P, narration SSL, adapter EMA) at accumulation 2 and NLQ with
EWC at lambda 3000, each as 2 Gloo ranks on their rows of the global
batch against JAX's single-device make_train_step, at the limits and by
the rules of tests/test_torch_port_parallel_steps.py (whose cases run
there, so that the two files run side by side).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.models.layers as j_layers
from tests.test_torch_port_mq_yaml import _bank
from tests.test_torch_port_parallel_steps import (
    EMA_DECAY,
    PARAM_ATOL,
    RTOL,
    SHIFT_GRAD,
    TASK,
    _check_params,
    _check_ranks_equal,
    _jax_point_steps,
    _lr_sum,
    _numpy,
    run_cases,
)
from tests.test_torch_port_train import _rel
from vilco_tpu.cl import regularizers as j_regs
from vilco_tpu.train import engine as j_engine
from vilco_tpu_torch.data.synthetic import task_extras
from vilco_tpu_torch.models.convert import adapter_ema_from_jax

CASES = ("yaml", "nlq")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("dp")))


@pytest.fixture(scope="module")
def cases(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def test_yaml_method_dp_step_with_accumulation_matches_jax(cases, ranks,
                                                           monkeypatch):
    """L2P (the first step's vote over the global batch), narration SSL
    (the bank written with both ranks' rows in global order, the pointer
    wrapping) and the adapter EMA, at accumulation 2."""
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    spec, (jcfg, jmodel, params) = cases["yaml"]
    bank, ptr = _bank(1009)
    ex = task_extras(spec["cfg"], TASK, 4)
    jcl = j_engine.CLBatchExtras(class_mask=jnp.asarray(ex["class_mask"]),
                                 memory_bank=jnp.asarray(bank),
                                 memory_ptr=jnp.asarray(ptr, jnp.int32))
    state, jm, jcl = _jax_point_steps(
        jcfg, jmodel, params, spec["batches"], jcl, cl_method="l2p",
        use_ssl=True, use_prompt=True, n_known=ex["n_known"],
        ema_decay=EMA_DECAY, accumulation_steps=2, ema=True)
    res = ranks["yaml"]
    _check_ranks_equal(res)
    for tm, m in zip(res[0]["metrics"], jm):
        for k in ("final_loss", "grad_norm", "ssl_loss", "al_loss",
                  "reduce_sim"):
            assert _rel(tm[k], m[k]) <= RTOL, k
    r = res[0]
    assert r["ptr"] == int(jcl.memory_ptr)
    np.testing.assert_array_equal(res[1]["bank"], r["bank"])
    assert _rel(r["bank"], np.asarray(jcl.memory_bank)) <= RTOL
    assert r["norm"] == pytest.approx(float(state.loss_normalizer), rel=1e-7)
    _check_params(r["params"], _numpy(state.params), PARAM_ATOL,
                  _lr_sum(2), SHIFT_GRAD)
    ema = {n: t.numpy() for n, t in
           adapter_ema_from_jax(state.adapter_ema).items()}
    _check_params(r["ema"], ema, PARAM_ATOL, _lr_sum(2), SHIFT_GRAD)


def test_nlq_ewc_dp_step_matches_jax(cases, ranks, monkeypatch):
    """The NLQ twin with the EWC penalty of two stacked tasks at lambda
    3000: its gradient added once after the all-reduce, on every rank."""
    monkeypatch.setattr(j_layers, "_drop_path", lambda x, *a: x)
    spec, (jcfg, jmodel, params, reg) = cases["nlq"]
    fisher, optpar = j_regs.stack_reg_tasks(reg)
    jcl = j_engine.CLBatchExtras(class_mask=jnp.ones((1,), bool),
                                 fisher=jax.tree.map(jnp.asarray, fisher),
                                 optpar=jax.tree.map(jnp.asarray, optpar))
    state, jm, _ = _jax_point_steps(jcfg, jmodel, params, spec["batches"],
                                    jcl, cl_method="ewc",
                                    use_reg_penalty=True)
    res = ranks["nlq"]
    _check_ranks_equal(res)
    for tm, m in zip(res[0]["metrics"], jm):
        for k in ("final_loss", "grad_norm", "reg_penalty"):
            assert _rel(tm[k], m[k]) <= RTOL, k
    assert jm[0]["reg_penalty"] > 0.01 * jm[0]["final_loss"]
    _check_params(res[0]["params"], _numpy(state.params), PARAM_ATOL,
                  _lr_sum(2))
