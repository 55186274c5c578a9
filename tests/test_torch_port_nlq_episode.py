"""The port's NLQ CL episode against the JAX package on the CPU: the lmdb
copy, the task stream and config, 2-task episode locksteps (naive, and EWC
at lambda 3000 as configs/nlq_vilco.yaml) of tasks/nlq.py::
NLQEpisodeRunner against JAX's, and the CLIs.

The lockstep runs both runners on the same synthetic template split
(make_synthetic_nlq_split from default_rng(0): 8 train and 3 val queries a
template) at nlq_tiny_config with 2 tasks, 1 + 2 epochs of warmup and
cosine at lr 1e-4, the per-task best epoch tracked on avg R1@0.3 from the
first epoch on, from the same parameters: JAX's init perturbed by
N(0, 0.02), as the MQ episode's lockstep (tests/test_torch_port_episode.py)
starts. Limits, the MQ lockstep's:
  every train_epoch metric 1e-5 relative (the EWC penalty and the grad norm
      it enters 1e-4, 1e-6 absolute where JAX's penalty is exactly 0);
  the loss normaliser 1e-6 relative;
  the best-epoch scores (every track_best eval) and so the best epoch,
      each task's R1/R5 at tIoU 0.3/0.5 and BwF 1e-4 absolute;
  the final parameters: every leaf within 5e-5 of its largest value, the
      leaves whose exact gradient is 0 within 2 x the sum of the lrs.
The CLIs: the port's train_cl --task nlq --synthetic, then evaluate
--task nlq, reproduces the final eval; the port's evaluate on JAX's
train_cl workdir gives JAX's evaluate's numbers at 1e-6, its submission
JAX's records; the checkpoints read both ways.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_episode import (
    CHAIN_ATOL,
    EVAL_ATOL,
    LR,
    METRIC_RTOL,
    NORM_RTOL,
    PARAM_RTOL,
    PENALTY_ATOL,
    PENALTY_RTOL,
    PERTURB,
    _leaves_equal,
    _rel,
    train_epochs,
)
from vilco_tpu.bin import evaluate as j_evaluate
from vilco_tpu.core import checkpoint as j_ckpt
from vilco_tpu.data import lmdb_io as j_lmdb
from vilco_tpu.tasks import nlq as j_nlq
from vilco_tpu_torch.bin import evaluate, train_cl
from vilco_tpu_torch.core import checkpoint as t_ckpt
from vilco_tpu_torch.core.config import config_from_dict, nlq_flagship_config
from vilco_tpu_torch.core.registry import TASKS
from vilco_tpu_torch.data import lmdb_io as t_lmdb
from vilco_tpu_torch.models.convert import params_from_jax
from vilco_tpu_torch.tasks import nlq as t_nlq
from vilco_tpu_torch.train.optim import make_schedule

CPU = ["--device", "cpu"]
NLQ_KEYS = ("R1@0.3", "R1@0.5", "R5@0.3", "R5@0.5")
AVG_KEYS = ("avg_R1@0.3", "avg_R1@0.5", "avg_R5@0.3", "avg_R5@0.5",
            "BwF_R1@0.3")
# leaves whose exact gradient is 0 (test_torch_port_nlq.py::ZERO_GRAD)
ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")


def overrides(method: str) -> dict:
    cl = {"name": method, "num_tasks": 2}
    if method == "ewc":
        cl["reg_lambda"] = 3000.0
    return {"cl_cfg": cl,
            "opt": {"epochs": 2, "warmup_epochs": 1, "learning_rate": LR,
                    "track_best": True, "eval_start_ratio": 0.0,
                    "best_metric": "avg_R1@0.3"}}


def _record_best_scores(runner, log):
    """Wrap runner.evaluate so the track_best evals' scores land in log."""
    inner = runner.evaluate

    def evaluate(j, update_bwf=True):
        res = inner(j, update_bwf)
        if not update_bwf:
            log.append((j, res["avg_R1@0.3"]))
        return res

    runner.evaluate = evaluate


class Pair:
    def __init__(self, method, root):
        jcfg = j_nlq.nlq_tiny_config(**overrides(method))
        pcfg = t_nlq.nlq_tiny_config(**overrides(method))
        assert pcfg == config_from_dict(jcfg.to_dict())
        self.jdir, self.pdir = str(root / "jax"), str(root / "port")
        tr, va = j_nlq.make_synthetic_nlq_split(np.random.default_rng(0),
                                                jcfg)
        jf = j_nlq.SyntheticNLQFeatures(jcfg.dataset.input_dim,
                                        jcfg.model.n_txt_in)
        self.jr = j_nlq.NLQEpisodeRunner(
            jcfg, j_nlq.NLQTaskStream(tr, va), jf.video, workdir=self.jdir,
            text_source=jf.text)
        rng = np.random.default_rng(5)
        start = jax.tree.map(
            lambda a: np.asarray(a) + PERTURB * rng.standard_normal(
                np.shape(a)).astype(np.float32), self.jr.params)
        self.jr.params = jax.tree.map(jnp.asarray, start)
        tr, va = t_nlq.make_synthetic_nlq_split(np.random.default_rng(0),
                                                pcfg)
        tf = t_nlq.SyntheticNLQFeatures(pcfg.dataset.input_dim,
                                        pcfg.model.n_txt_in)
        self.pr = t_nlq.NLQEpisodeRunner(
            pcfg, t_nlq.NLQTaskStream(tr, va), tf.video, workdir=self.pdir,
            text_source=tf.text, device="cpu")
        self.pr.set_params(params_from_jax(start))
        self.jbest, self.pbest = [], []
        _record_best_scores(self.jr, self.jbest)
        _record_best_scores(self.pr, self.pbest)
        self.jcfg = jcfg
        self.jres = self.jr.run()
        self.pres = self.pr.run()


@pytest.fixture(scope="module")
def naive(tmp_path_factory):
    return Pair("naive", tmp_path_factory.mktemp("nlq_naive"))


@pytest.fixture(scope="module")
def ewc(tmp_path_factory):
    return Pair("ewc", tmp_path_factory.mktemp("nlq_ewc"))


def check_nlq_eval(ref: dict, got: dict, atol: float):
    for k in AVG_KEYS:
        assert abs(got[k] - ref[k]) <= atol, (k, got[k], ref[k])
    assert len(got["per_task"]) == len(ref["per_task"])
    for a, b in zip(ref["per_task"], got["per_task"]):
        for k in NLQ_KEYS:
            assert abs(b[k] - a[k]) <= atol, (a["task"], k, b[k], a[k])
        np.testing.assert_allclose(b["recall"], a["recall"], rtol=0,
                                   atol=atol)


def check_lockstep(p: Pair):
    assert p.pr.loss_normalizer == pytest.approx(p.jr.loss_normalizer,
                                                 rel=NORM_RTOL)
    je, pe = train_epochs(p.jdir), train_epochs(p.pdir)
    assert len(je) == len(pe) == 2 * p.jcfg.opt.total_epochs
    for a, b in zip(je, pe):
        assert (a["step"], a["task"], a["epoch"]) == (b["step"], b["task"],
                                                      b["epoch"])
        for k in set(a) - {"kind", "t", "step", "task", "epoch"}:
            if k == "al_loss" and k not in b:
                assert a[k] == 0.0
            elif k == "reg_penalty" and a[k] == 0.0:
                assert abs(b[k]) <= PENALTY_ATOL
            elif k == "reg_penalty" or (k == "grad_norm"
                                        and a.get("reg_penalty", 0.0) > 0):
                assert _rel(b[k], a[k]) <= PENALTY_RTOL, (k, a, b)
            else:
                assert _rel(b[k], a[k]) <= METRIC_RTOL, (k, a, b)
    # the best epoch: every track_best eval's score, in order
    assert [j for j, _ in p.pbest] == [j for j, _ in p.jbest]
    np.testing.assert_allclose([s for _, s in p.pbest],
                               [s for _, s in p.jbest], rtol=0,
                               atol=EVAL_ATOL)
    want = params_from_jax(jax.tree.map(np.asarray, p.jr.params))
    sched = make_schedule(p.pr.cfg.opt, 2)
    lr_sum = 2 * sum(float(sched(s))
                     for s in range(2 * p.jcfg.opt.total_epochs))
    errs = {}
    for n, v in p.pr.model.named_parameters():
        got, ref = v.detach().numpy(), want[n].numpy()
        if n.endswith(ZERO_GRAD):
            assert np.abs(got - ref).max() <= 2 * lr_sum, n
        else:
            errs[n] = _rel(got, ref)
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= PARAM_RTOL, top
    for a, b in zip(p.jres["tasks"], p.pres["tasks"]):
        check_nlq_eval(a["eval"], b["eval"], EVAL_ATOL)


# ----------------------------------------------------------- the copies


def test_lmdb_copy_reads_and_writes_as_jax(tmp_path):
    """An lmdb the JAX writer makes (inline and overflow values) reads the
    same through both readers, and the port's writer's file equals JAX's
    byte for byte."""
    rng = np.random.default_rng(0)
    feats = {f"v{i}": {"features": rng.standard_normal(
        (int(rng.integers(1, 400)), 16)).astype(np.float32)}
        for i in range(12)}
    jdir, tdir = str(tmp_path / "j.lmdb"), str(tmp_path / "t.lmdb")
    j_lmdb.write_feature_lmdb(jdir, feats)
    t_lmdb.write_feature_lmdb(tdir, feats)
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, open(
                os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jr, tr = j_lmdb.LmdbReader(jdir), t_lmdb.LmdbReader(jdir)
    for key, want in feats.items():
        a, b = jr.get(key.encode()), tr.get(key.encode())
        assert a == b
        np.testing.assert_array_equal(t_lmdb.read_npz_value(b)["features"],
                                      want["features"])
    assert tr.get(b"missing") is None


def test_lmdb_and_dir_features_feed_the_runner(tmp_path):
    """build_nlq_runner over a jsonl with lmdb features and with per-file
    features: the port's sources give JAX's arrays."""
    rng = np.random.default_rng(1)
    recs, vid, txt = [], {}, {}
    for q in range(4):
        recs.append({"query_id": f"q{q}", "video_id": f"v{q}",
                     "clip_uid": f"c{q}", "annotation_uid": f"a{q}",
                     "timestamps": [[1.0, 3.0]], "duration": 20.0,
                     "query_type": f"t{q % 2}"})
        vid[f"v{q}"] = {"features": rng.standard_normal((30, 16)).astype(
            np.float32)}
        txt[f"q{q}"] = {"token_features": rng.standard_normal(
            (5, 12)).astype(np.float32)}
    jsonl = tmp_path / "q.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in recs))
    j_lmdb.write_feature_lmdb(str(tmp_path / "v.lmdb"), vid)
    j_lmdb.write_feature_lmdb(str(tmp_path / "t.lmdb"), txt)
    (tmp_path / "vd").mkdir()
    (tmp_path / "td").mkdir()
    for k, d in vid.items():
        np.save(tmp_path / "vd" / f"{k}.npy", d["features"])
    for k, d in txt.items():
        np.savez(tmp_path / "td" / f"{k}.npz", **d)
    assert t_nlq.load_nlq_tasks(str(jsonl)).keys() == {"t0", "t1"}
    cfg = t_nlq.nlq_tiny_config()
    for kw in ({"video_lmdb": str(tmp_path / "v.lmdb"),
                "text_lmdb": str(tmp_path / "t.lmdb")},
               {"video_dir": str(tmp_path / "vd"),
                "text_dir": str(tmp_path / "td")}):
        r = t_nlq.build_nlq_runner(cfg, str(tmp_path / "w"), str(jsonl),
                                   str(jsonl), device="cpu", **kw)
        for v in r.stream.train_videos(0):
            np.testing.assert_array_equal(r.src(v),
                                          vid[v["video_id"]]["features"])
            np.testing.assert_array_equal(
                r.text_source(v), txt[v["id"]]["token_features"])
    with pytest.raises(ValueError, match="text"):
        t_nlq.build_nlq_runner(cfg, str(tmp_path / "w"), str(jsonl),
                               str(jsonl), video_lmdb="x", device="cpu")


def test_stream_split_and_features_equal_jax():
    """The synthetic split, the stream's views and the synthetic features,
    exact; nlq_tiny_config is nlq_flagship_config(tiny=True) and takes
    JAX's overrides; the registry names the runner."""
    jcfg, pcfg = j_nlq.nlq_tiny_config(), t_nlq.nlq_tiny_config()
    assert pcfg == nlq_flagship_config(tiny=True)
    assert pcfg == config_from_dict(jcfg.to_dict())
    ov = overrides("ewc")
    assert t_nlq.nlq_tiny_config(**ov) == config_from_dict(
        j_nlq.nlq_tiny_config(**ov).to_dict())
    assert TASKS.get("nlq") is t_nlq.NLQEpisodeRunner
    jt, jv = j_nlq.make_synthetic_nlq_split(np.random.default_rng(3), jcfg)
    tt, tv = t_nlq.make_synthetic_nlq_split(np.random.default_rng(3), pcfg)
    _leaves_equal(jt, tt)
    _leaves_equal(jv, tv)
    js = j_nlq.NLQTaskStream(jt, jv, shuffle_order=True, seed=4)
    ts = t_nlq.NLQTaskStream(tt, tv, shuffle_order=True, seed=4)
    assert ts.task_ids == js.task_ids
    for j in range(ts.num_tasks):
        assert ([v["id"] for v in ts.train_videos(j)]
                == [v["id"] for v in js.train_videos(j)])
        assert ([v["id"] for v in ts.val_videos_upto(j)]
                == [v["id"] for v in js.val_videos_upto(j)])
        assert ts.memory_quota(13, j + 1) == js.memory_quota(13, j + 1)
    jf = j_nlq.SyntheticNLQFeatures(16, 12)
    tf = t_nlq.SyntheticNLQFeatures(16, 12)
    for v in jv["template_0"] + jv["template_1"]:
        np.testing.assert_array_equal(tf.video(v), jf.video(v))
        np.testing.assert_array_equal(tf.text(v), jf.text(v))


# ----------------------------------------------------------- locksteps


def test_naive_nlq_episode_lockstep_matches_jax(naive):
    """The 2-task naive episode against JAX's NLQEpisodeRunner."""
    check_lockstep(naive)
    assert len(naive.pbest) == 2 * naive.jcfg.opt.total_epochs


def test_ewc_nlq_episode_lockstep_matches_jax(ewc):
    """EWC at lambda 3000: task 0's importance from its last batch, the
    penalty in task 1's steps."""
    check_lockstep(ewc)
    assert len(ewc.pr.reg_list) == len(ewc.jr.reg_list) == 1
    pen = [e["reg_penalty"] for e in train_epochs(ewc.pdir)
           if e["task"] == 1]
    assert max(pen) > 0


def test_nlq_checkpoints_read_both_ways(ewc):
    """JAX's task checkpoint (a Flax tree and its EWC task) in the port,
    the port's in JAX's reader: every leaf equal."""
    for j in range(2):
        path = os.path.join(ewc.pdir, f"task_{j:03d}.ckpt")
        _leaves_equal(t_ckpt.load_checkpoint(path),
                      j_ckpt.load_checkpoint(path))
    path = os.path.join(ewc.jdir, "task_000.ckpt")
    ref, got = j_ckpt.load_checkpoint(path), t_ckpt.load_checkpoint(path)
    _leaves_equal(ref, got)
    want = params_from_jax(ref["params"])
    have = t_ckpt.params_of(got)
    assert have.keys() == want.keys()
    assert all(torch.equal(have[k], want[k]) for k in want)
    (imp, opt), = t_ckpt.reg_tasks_of(got["reg_list"])
    assert imp.keys() == want.keys()


# ----------------------------------------------------------- the CLIs


def test_port_evaluate_reads_a_jax_nlq_workdir(ewc, tmp_path):
    """JAX's EWC episode's workdir (config.json, Flax-tree checkpoints):
    the port's evaluate --task nlq gives JAX's evaluate's numbers at 1e-6,
    for the last task and with --task-idx 0, and its submission JAX's
    records (times and scores at 1e-6 relative)."""
    for idx in ([], ["--task-idx", "0"]):
        ref = j_evaluate.main(["--workdir", ewc.jdir, "--synthetic", *idx])
        got = evaluate.main(["--workdir", ewc.jdir, "--synthetic", *idx,
                             *CPU])
        check_nlq_eval(ref, got, CHAIN_ATOL)
    subs = []
    for main, extra in ((j_evaluate.main, []), (evaluate.main, CPU)):
        path = tmp_path / f"sub{len(subs)}.json"
        main(["--workdir", ewc.jdir, "--synthetic", "--submission",
              str(path), *extra])
        subs.append(json.loads(path.read_text()))
    assert subs[0]["challenge"] == subs[1]["challenge"] == (
        "ego4d_nlq_challenge")
    assert len(subs[1]["results"]) == len(subs[0]["results"]) == 6
    for a, b in zip(subs[0]["results"], subs[1]["results"]):
        assert {k: a[k] for k in a if k != "predicted_times"} == {
            k: b[k] for k in b if k != "predicted_times"}
        # seconds and scores: f32 roundoff of the times, relative
        np.testing.assert_allclose(b["predicted_times"],
                                   a["predicted_times"], rtol=CHAIN_ATOL,
                                   atol=CHAIN_ATOL)


def test_train_cl_nlq_then_evaluate_reproduces_the_final_eval(tmp_path):
    """The port's train_cl --task nlq --synthetic (EWC at lambda 3000, 2
    tasks, 1 epoch): results.json has JAX's keys, config.json JAX's layout
    (JAX's Config reads it), and evaluate --task nlq from the workdir alone
    gives the final eval's per-task numbers."""
    from vilco_tpu.core.config import Config as JConfig

    wd = str(tmp_path / "run")
    res = train_cl.main(["--task", "nlq", "--synthetic", "--workdir", wd,
                         "--epochs", "1", "--num-tasks", "2", "--method",
                         "ewc", "--reg-lambda", "3000", *CPU])
    with open(tmp_path / "run" / "config.json") as f:
        saved = json.load(f)
    jcfg = JConfig.from_dict(saved).derived()
    assert jcfg.task == "nlq" and jcfg.cl_cfg.reg_lambda == 3000.0
    final = res["final"]
    assert set(final) == {"per_task", "avg_mAP", "avg_R1@0.3", "avg_R1@0.5",
                          "avg_R5@0.3", "avg_R5@0.5", "BwF_R1@0.5",
                          "BwF_R1@0.3", "BwF_mAP"}
    ev = evaluate.main(["--workdir", wd, "--synthetic", *CPU])
    for a, b in zip(ev["per_task"], final["per_task"]):
        for k in NLQ_KEYS:
            assert abs(a[k] - b[k]) <= 1e-6, k
    # 8 queries a template in batches of 4, 1 epoch + the tiny's 1 warmup
    assert res["tasks"][0]["train"]["steps"] == 4


def test_nlq_cli_refusals(tmp_path, capsys):
    """evaluate --task vq points to vq_infer; train_cl --task nlq without
    a source or with --joint exits with a message."""
    for main, argv, msg in (
            (evaluate.main, ["--task", "vq"], "vq_infer"),
            (train_cl.main, ["--task", "nlq"], "--synthetic"),
            (train_cl.main, ["--task", "nlq", "--synthetic", "--joint"],
             "joint")):
        with pytest.raises(SystemExit) as e:
            main(["--workdir", str(tmp_path), *argv, *CPU])
        assert e.value.code != 0
        assert msg in capsys.readouterr().err
