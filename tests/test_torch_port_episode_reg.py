"""The port's MQ CL episode against the JAX package on the CPU, part 3: the
EWC and iCaRL episodes (MAS's, marked slow: its importance is pinned by
tests/test_torch_port_cl_methods.py). The harness and limits are
test_torch_port_episode.py's. EWC runs at the reference's lambda 3000,
where the penalty is ~3e-4 of the second task's last loss: at 1e5 (~1%)
its gradient carries the importance's difference (a squared gradient at
parameters that differ by the lockstep's drift) into the grad norm, read
1.9e-4 apart. iCaRL runs with a memory of 20 clips (a quota of 5 keeps
every clip), the distillation against the snapshot targets, and the
nearest-mean filter at eval.
"""

import numpy as np
import pytest

import jax

from tests.test_torch_port_episode import (
    PARAM_RTOL,
    ROUNDOFF_GRAD,
    check_eval_chain,
    check_lockstep,
    run_pair,
)
from vilco_tpu_torch.models.convert import params_from_jax
from vilco_tpu_torch.train.optim import make_schedule

LAMBDA = 3000.0    # the reference's EWC/MAS weight (configs/nlq_vilco.yaml)
IMP_RTOL = 2 * PARAM_RTOL


def _check_importance(p):
    """The stacked task's optpar (the parameters after task 0) as
    check_lockstep holds parameters, and its importance per leaf within
    IMP_RTOL of the leaf's largest, floored at 1e-4 of the tree's as
    tests/test_torch_port_cl_methods.py floors it: that file holds the
    importance of equal parameters at 2e-5; here it is the gradient at
    parameters that differ by up to PARAM_RTOL, squared for EWC (2 x
    PARAM_RTOL). The leaves whose exact gradient is 0 hold squares of
    roundoff, within 1e-6 of the tree's largest."""
    (jimp, jopt), = p.jr.reg_list
    (imp, opt), = p.pr.reg_list
    want_imp = params_from_jax(jax.tree.map(np.asarray, jimp))
    want_opt = params_from_jax(jax.tree.map(np.asarray, jopt))
    top = max(float(v.abs().max()) for v in want_imp.values())
    sched = make_schedule(p.pr.cfg.opt, 1)
    lr_sum = sum(float(sched(s)) for s in range(p.jcfg.opt.total_epochs))
    for n in want_imp:
        den = max(float(want_imp[n].abs().max()), 1e-4 * top)
        if n.endswith(ROUNDOFF_GRAD):
            den = 0.05 * top
        err = float((imp[n] - want_imp[n]).abs().max())
        rtol = 2e-5 if n.endswith(ROUNDOFF_GRAD) else IMP_RTOL
        assert err <= rtol * den, n
        # optpar: the parameters after task 0, held as check_lockstep holds
        # the final ones
        err = float((opt[n] - want_opt[n]).abs().max())
        if n.endswith(ROUNDOFF_GRAD):
            assert err <= 2 * lr_sum, n
        else:
            assert err <= PARAM_RTOL * float(want_opt[n].abs().max()), n


@pytest.fixture(scope="module")
def ewc(tmp_path_factory):
    return run_pair("ewc", tmp_path_factory.mktemp("ewc"),
                    cl_cfg={"reg_lambda": LAMBDA})


def test_ewc_episode_lockstep_matches_jax(ewc):
    """EWC: the importance after task 0 (its mask through task 1, the
    normaliser carried through the pass), then the second task with the
    penalty, against JAX's runner."""
    _check_importance(ewc)
    last = ewc.pres["tasks"][-1]["train"]["last_metrics"]
    assert last["reg_penalty"] > 0
    check_lockstep(ewc)


@pytest.fixture(scope="module")
def icarl(tmp_path_factory):
    return run_pair("icarl", tmp_path_factory.mktemp("icarl"))


def test_icarl_episode_lockstep_matches_jax(icarl):
    """iCaRL: the distillation from task 1 on, the exemplar filter at
    eval, the memory after both tasks."""
    last = icarl.pres["tasks"][-1]["train"]["last_metrics"]
    assert last["dist_loss"] > 0
    check_lockstep(icarl)


def test_icarl_eval_chain_matches_jax(icarl, tmp_path):
    """JAX's end state in the port's runner: the exemplar means from the
    same memory, the same filtered detections, evaluate(1) at 1e-6."""
    pr, _, _ = check_eval_chain(icarl, tmp_path)
    assert pr._icarl_valid.sum() == len(pr.memory.data)


@pytest.mark.slow
def test_mas_episode_lockstep_matches_jax(tmp_path):
    """MAS: as EWC, the importance |g|."""
    p = run_pair("mas", tmp_path, cl_cfg={"reg_lambda": LAMBDA})
    _check_importance(p)
    check_lockstep(p)
