"""The port's MQ CL episode against the JAX package on the CPU, part 4: the
BiC episode (90/10 split, stage 2, the bias at eval) and the CLIs.

BiC's harness and limits are test_torch_port_episode.py's, and after the
episode both tasks' (alpha, beta) 1e-6. The CLIs:
  the port's train_cl --synthetic (2 tasks, 1 epoch, the CPU) followed by
      evaluate --workdir reproduces the final eval at rtol 1e-5, and with
      --task-idx 0 task 0's (as tests/test_evaluate_cli.py for JAX); the
      persisted config.json is JAX's layout (JAX's Config reads it);
  the port's evaluate on a JAX-written workdir gives JAX's evaluate's
      numbers at 1e-6;
  a workdir of the yaml's method evaluates with the single forward and no
      text (JAX's evaluate restores the params and the memory only, and
      its synthetic path builds no text source);
  the refused flags exit non-zero with a message; no card raises.
"""

import json

import numpy as np
import pytest

from tests.test_torch_port_episode import (
    CHAIN_ATOL,
    check_eval,
    check_eval_chain,
    check_lockstep,
    run_pair,
)
from vilco_tpu.bin import evaluate as j_evaluate
from vilco_tpu.bin import train_cl as j_train_cl
from vilco_tpu.core.config import Config as JConfig
from vilco_tpu_torch.bin import evaluate, train_cl

BIAS_ATOL = 1e-6
CLI_RTOL = 1e-5
CPU = ["--device", "cpu"]
# the port-only CLI runs: 2 train and 1 val clip a class (both CLIs)
SMALL = ["--synthetic-videos", "2", "1"]


@pytest.fixture(scope="module")
def bic(tmp_path_factory):
    return run_pair("bic", tmp_path_factory.mktemp("bic"))


def test_bic_episode_lockstep_matches_jax(bic):
    """BiC: the distillation against the softmax-T targets, the past tasks'
    bias in training, stage 2's pair on the held-out clips, the bias at
    eval."""
    check_lockstep(bic)
    np.testing.assert_allclose(bic.pr.bic.alphas, bic.jr.bic.alphas,
                               rtol=0, atol=BIAS_ATOL)
    np.testing.assert_allclose(bic.pr.bic.betas, bic.jr.bic.betas, rtol=0,
                               atol=BIAS_ATOL)
    assert bic.pr.bic.num_tasks_seen == 2
    assert (bic.pr.bic.alphas != 1).any()


def test_bic_eval_chain_matches_jax(bic, tmp_path):
    """JAX's end state (params, both tasks' bias pairs) in the port's
    runner: the BiC-biased detections give evaluate(1) at 1e-6."""
    pr, _, _ = check_eval_chain(bic, tmp_path)
    assert pr.bic.num_tasks_seen == 2


def _final_evals_match(ev, train_eval, rtol):
    assert len(ev["per_task"]) == len(train_eval["per_task"])
    for k in ("avg_mAP", "avg_R1@0.5", "avg_R5@0.3"):
        np.testing.assert_allclose(ev[k], train_eval[k], rtol=rtol)
    for a, b in zip(ev["per_task"], train_eval["per_task"]):
        np.testing.assert_allclose(a["avg_mAP"], b["avg_mAP"], rtol=rtol)


def test_train_cl_then_evaluate_reproduces_the_final_eval(tmp_path):
    """train_cl --synthetic, then evaluate --workdir from the persisted
    config alone: the final eval, and task 0's with --task-idx 0."""
    wd = str(tmp_path / "run")
    res = train_cl.main(["--synthetic", "--workdir", wd, "--epochs", "1",
                         "--num-tasks", "2", *SMALL, *CPU])
    with open(tmp_path / "run" / "config.json") as f:
        saved = json.load(f)
    assert saved["cl_cfg"]["num_tasks"] == 2 and saved["opt"]["epochs"] == 1
    JConfig.from_dict(saved).derived()          # JAX reads the port's file
    ev = evaluate.main(["--workdir", wd, "--synthetic", *SMALL, *CPU])
    _final_evals_match(ev, res["tasks"][-1]["eval"], CLI_RTOL)
    ev0 = evaluate.main(["--workdir", wd, "--synthetic", "--task-idx", "0",
                         *SMALL, *CPU])
    assert len(ev0["per_task"]) == 1
    np.testing.assert_allclose(ev0["avg_mAP"],
                               res["tasks"][0]["eval"]["avg_mAP"],
                               rtol=CLI_RTOL)
    sub = tmp_path / "sub.json"
    evaluate.main(["--workdir", wd, "--synthetic", "--submission", str(sub),
                   *SMALL, *CPU])
    assert set(json.loads(sub.read_text())) == {"version", "external_data",
                                                "results"}


def test_port_evaluate_reads_a_jax_workdir(tmp_path):
    """JAX's train_cl --synthetic workdir (config.json, Flax-tree
    checkpoints): the port's evaluate gives JAX's evaluate's numbers."""
    wd = str(tmp_path / "jax")
    j_train_cl.main(["--synthetic", "--workdir", wd, "--epochs", "1",
                     "--num-tasks", "2"])
    for idx in ([], ["--task-idx", "0"]):
        ref = j_evaluate.main(["--workdir", wd, "--synthetic", *idx])
        got = evaluate.main(["--workdir", wd, "--synthetic", *idx, *CPU])
        check_eval(ref, got, CHAIN_ATOL)


def test_yaml_method_workdir_evaluates_with_the_single_forward(tmp_path):
    """A run of the yaml's method: evaluate restores the params and the
    memory only (no adapter EMA, no text source, as JAX's CLI), so its
    numbers are the runner's single forward without text on the same
    params."""
    wd = str(tmp_path / "vilco")
    res = train_cl.main(["--synthetic", "--workdir", wd, "--epochs", "1",
                         "--num-tasks", "2", "--method", "vilco", *SMALL,
                         *CPU])
    ev = evaluate.main(["--workdir", wd, "--synthetic", *SMALL, *CPU])
    # the same restore by hand: the runner evaluate builds, EMA unset
    from vilco_tpu_torch.cl.episode import EpisodeRunner
    from vilco_tpu_torch.cl.stream import TaskStream
    from vilco_tpu_torch.core.checkpoint import load_checkpoint, params_of
    from vilco_tpu_torch.core.config import load_config
    from vilco_tpu_torch.data.pipeline import SyntheticFeatureSource
    from vilco_tpu_torch.data.synthetic import make_synthetic_cl_split

    cfg = load_config(f"{wd}/config.json")
    assert cfg.cl_cfg.use_adapt and cfg.dataset.use_text
    tr, va = make_synthetic_cl_split(
        np.random.default_rng(cfg.init_rand_seed), cfg, 2, 1)
    runner = EpisodeRunner(cfg, TaskStream(tr, va),
                           SyntheticFeatureSource(cfg.dataset.input_dim),
                           workdir=wd, persist_config=False, device="cpu")
    runner.set_params(params_of(load_checkpoint(f"{wd}/task_001.ckpt")))
    runner.memory.load(f"{wd}/{cfg.cl_cfg.path_memory}")
    assert runner._adapter_ema is None and runner.text_source is None
    check_eval(runner.evaluate(1), ev, 0.0)
    assert res["final"]["avg_mAP"] != ev["avg_mAP"] or any(
        a["mAP"] != b["mAP"] for a, b in zip(res["final"]["per_task"],
                                             ev["per_task"]))


@pytest.mark.parametrize("argv,msg", [
    (["--task", "nlq", "--dp", "2"], "item 7"),
    (["--task", "vq", "--params-bf16"], "bf16"),
    (["--dp", "2"], "item 7"), (["--distributed"], "item 7"),
    (["--factored"], "factored"), (["--mu-dtype", "float32"], "bf16"),
    (["--nu-dtype", "float32"], "bf16"), (["--params-bf16"], "bf16"),
    (["--ckpt-format", "orbax"], "orbax")])
def test_refused_flags_exit_with_a_message(argv, msg, capsys, tmp_path):
    """The JAX CLI's flags the port cannot honour exit non-zero and say
    why."""
    with pytest.raises(SystemExit) as e:
        train_cl.main(["--synthetic", "--workdir", str(tmp_path), *argv,
                       *CPU])
    assert e.value.code != 0
    assert msg in capsys.readouterr().err


def test_the_runner_refuses_a_missing_card(tmp_path, monkeypatch):
    """The default device is the card; without one the runner raises (it
    never falls back to the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        train_cl.main(["--synthetic", "--workdir", str(tmp_path),
                       "--num-tasks", "2"])
