"""The port's MQ CL episode against the JAX package on the CPU, part 2: the
yaml's method (L2P prompt pool, narration SSL with its memory bank, time
adapters with their EMA, rehearsal memory) at the tiny twin with the XL
stage (its dropout at 0 on both sides, as every regulariser of the tiny
twin). The harness and limits are test_torch_port_episode.py's; here also
the narration-SSL bank and its pointer after the episode (1e-5 of the
bank's largest value, the pointer exact), and the eval chain through the
adapter ensemble (JAX's EMA loaded beside its params).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_episode import (
    _rel,
    check_eval_chain,
    check_lockstep,
    memory_ids,
    run_pair,
)

BANK_RTOL = 1e-5


@pytest.fixture(scope="module")
def yaml_pair(tmp_path_factory):
    return run_pair("vilco", tmp_path_factory.mktemp("yaml"))


def test_yaml_method_episode_lockstep_matches_jax(yaml_pair):
    """The 2-task episode of the yaml's method against JAX's runner: the
    memory, the normaliser, every epoch's metrics (the L2P pull and the SSL
    loss among them), the parameters, the eval series and BwF."""
    p = yaml_pair
    check_lockstep(p)
    last = p.pres["tasks"][-1]["train"]["last_metrics"]
    assert {"reduce_sim", "ssl_loss", "al_loss"} <= set(last)
    assert p.pr.method == "l2p" and memory_ids(p.pr.memory)
    assert int(p.pr.memory_ptr) == int(p.jr.memory_ptr)
    assert _rel(p.pr.memory_bank.numpy(),
                np.asarray(p.jr.memory_bank)) <= BANK_RTOL


def test_yaml_method_eval_chain_matches_jax(yaml_pair, tmp_path):
    """JAX's end-of-episode params and adapter EMA in the port's runner:
    evaluate(1) through the two-forward ensemble equals JAX's at 1e-6;
    then with the EMA moved by N(0, 0.05) on both sides (three steps at lr
    1e-4 leave it within ~1e-7 of the adapters, which would hide an EMA
    not read), equal again and unlike the single forward's."""
    p = yaml_pair
    check_eval_chain(p, tmp_path)
    ema = dict(p.jr._adapter_ema)
    rng = np.random.default_rng(9)
    p.jr._adapter_ema = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32)), ema)
    try:
        pr, ref, got = check_eval_chain(p, tmp_path / "moved")
    finally:
        p.jr._adapter_ema = ema
    pr._adapter_ema = None
    single = pr.evaluate(1, update_bwf=False)
    assert any(a["mAP"] != b["mAP"] or a["recall"] != b["recall"]
               for a, b in zip(single["per_task"], got["per_task"]))
