"""The port's VQ CL episode against the JAX package on the CPU: the task
stream, the synthetic source and split, the train batches, 2-task episode
locksteps (naive and EWC) of tasks/vq.py::VQEpisodeRunner against JAX's,
the checkpoints and vq_config.json both ways, and the train_cl / vq_infer
CLIs.

The lockstep runs both runners on JAX's synthetic split (default_rng(0),
2 tasks of 2 categories, 4 train and 2 val samples a category, 16-frame
clips) at vq_flagship_config(tiny=True) (6-frame windows), HNM on, batch
2, 1 epoch, lr 1e-4 (the other episode locksteps' rate), augmentation off
(JAX's draws cannot be reproduced; tests/test_torch_port_vq_data.py holds
the augmentation), the head's dropout at 0 and both forwards in f32 (JAX's
ClipMatcher built by a patched build_clip_matcher), from the same
parameters: JAX's init perturbed by N(0, 0.02). Limits:
  each task's last train metrics 1e-5 relative (those of a task trained
      under the EWC penalty 1e-4, the importance's limit: the MQ
      lockstep's rule);
  each task's tAP@0.25, stAP@0.25, Success and recovery, and BwF, 1e-4
      absolute;
  the EWC importance 1e-4 of each leaf's largest value (the leaves whose
      exact gradient is 0 hold squared roundoff: within 1e-6 of the
      largest importance);
  the final parameters 5e-4 of each leaf's largest value, the elements
      whose exact gradient is 0 within 2 x the sum of the lrs. AdamW moves
      an element whose gradient is at roundoff level by up to lr a step
      whatever its sign, so the elements of near-zero gradient read up to
      2.7e-4 here (test_torch_port_vq.py's 3-step trajectory separates
      them by their gradient and holds the rest to 5e-6).
The CLIs (JAX's ClipMatcher and the port's in f32, COMPUTE_DTYPE patched):
the port's vq_infer on JAX's workdir gives JAX's vq_infer's numbers at
1e-6; the port's train_cl --task vq --synthetic writes results.json with
JAX's keys, and vq_infer on its workdir reproduces the final eval.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_episode import PERTURB, _leaves_equal, _rel
from vilco_tpu.bin import train_cl as j_train_cl
from vilco_tpu.bin import vq_infer as j_vq_infer
from vilco_tpu.core import checkpoint as j_ckpt
from vilco_tpu.core.config import VQCfg
from vilco_tpu.tasks import vq as j_vq
from vilco_tpu_torch.bin import train_cl, vq_infer
from vilco_tpu_torch.core import checkpoint as t_ckpt
from vilco_tpu_torch.core.config import (
    Config,
    VQConfig,
    config_from_dict,
    vq_flagship_config,
)
from vilco_tpu_torch.core.registry import TASKS
from vilco_tpu_torch.models.convert import params_from_jax
from vilco_tpu_torch.tasks import vq as t_vq

CPU = ["--device", "cpu"]
LR = 1e-4
METRIC_RTOL = 1e-5
PENALTY_RTOL = 1e-4
EVAL_ATOL = 1e-4
IMP_RTOL = 1e-4
PARAM_RTOL = 5e-4
CHAIN_ATOL = 1e-6
EVAL_KEYS = ("tAP@0.25", "stAP@0.25", "Success", "recovery%")
AVG_KEYS = ("avg_tAP25", "avg_stAP25", "avg_success", "avg_recovery",
            "BwF_tAP25")


def zero_grad_slice(name, shape):
    """The elements whose exact gradient is 0: the key biases (the
    decoder's, and the middle third of each encoder's fused qkv bias)."""
    if name.endswith(("self_k.bias", "cross_k.bias")):
        return slice(None)
    if name.endswith("qkv.bias") and name.startswith("st_"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    return None


def _f32(mp):
    """JAX's ClipMatcher in f32 with no head dropout, the port's in f32."""
    build = j_vq.build_clip_matcher

    def f32(model_cfg=None, **kw):
        return build(model_cfg, **kw).clone(compute_dtype="float32",
                                            dropout=0.0)

    mp.setattr(j_vq, "build_clip_matcher", f32)
    mp.setattr(t_vq, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def f32_forwards(monkeypatch):
    _f32(monkeypatch)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


class Pair:
    def __init__(self, method, root):
        pcfg = dataclasses.replace(vq_flagship_config(tiny=True),
                                   dropout=0.0)
        jcfg = VQCfg.from_dict(pcfg.to_dict())
        kw = dict(method=method, epochs=1, batch_size=pcfg.batch_size,
                  lr=LR, weight_decay=pcfg.weight_decay, use_hnm=True,
                  augment=False, seed=0,
                  reg_lambda=3000.0 if method == "ewc" else 0.0)
        tr, va = j_vq.make_synthetic_vq_split(np.random.default_rng(0),
                                              num_tasks=2)
        self.jdir, self.pdir = str(root / "jax"), str(root / "port")
        self.jr = j_vq.VQEpisodeRunner(
            j_vq.VQTaskStream(tr, va), j_vq.SyntheticVQSource(pcfg.clip_size),
            self.jdir, model_cfg=jcfg, **kw)
        rng = np.random.default_rng(5)
        start = jax.tree.map(
            lambda a: np.asarray(a) + PERTURB * rng.standard_normal(
                np.shape(a)).astype(np.float32), self.jr.params)
        self.jr.params = jax.tree.map(jnp.asarray, start)
        self.pr = t_vq.VQEpisodeRunner(
            t_vq.VQTaskStream(tr, va), t_vq.SyntheticVQSource(pcfg.clip_size),
            self.pdir, model_cfg=pcfg, device="cpu", **kw)
        self.pr.set_params(params_from_jax(start))
        self.jcfg, self.pcfg = jcfg, pcfg
        self.jres = self.jr.run()
        self.pres = self.pr.run()


def _pair(method, root):
    with pytest.MonkeyPatch.context() as mp:
        _f32(mp)
        return Pair(method, root)


@pytest.fixture(scope="module")
def naive(tmp_path_factory):
    return _pair("naive", tmp_path_factory.mktemp("vq_naive"))


@pytest.fixture(scope="module")
def ewc(tmp_path_factory):
    return _pair("ewc", tmp_path_factory.mktemp("vq_ewc"))


def check_vq_eval(ref: dict, got: dict, atol: float):
    for k in AVG_KEYS:
        assert abs(got[k] - ref[k]) <= atol, (k, got[k], ref[k])
    assert len(got["per_task"]) == len(ref["per_task"])
    for a, b in zip(ref["per_task"], got["per_task"]):
        for k in EVAL_KEYS:
            assert abs(b[k] - a[k]) <= atol, (a["task"], k, b[k], a[k])


def check_lockstep(p: Pair):
    for a, b in zip(p.jres["tasks"], p.pres["tasks"]):
        assert set(b["train"]) == set(a["train"]) | {"grad_norm"}
        # a task trained under the penalty: its metrics carry the
        # importance's 1e-4
        lim = PENALTY_RTOL if "reg_penalty" in a["train"] else METRIC_RTOL
        for k, v in a["train"].items():
            assert _rel(b["train"][k], v) <= lim, (a["task"], k)
        check_vq_eval(a["eval"], b["eval"], EVAL_ATOL)
    want = params_from_jax(_np(p.jr.params))
    reach = 2 * LR * sum(
        len(p.jr.stream.train_videos(j)) // p.jr.batch_size
        for j in range(2))
    errs = {}
    for n, v in p.pr.model.named_parameters():
        d = np.abs(v.detach().numpy() - want[n].numpy())
        assert d.max() <= reach, n
        zero = zero_grad_slice(n, d.shape)
        if zero is not None:
            d[zero] = 0.0
        errs[n] = float(d.max() / np.abs(want[n].numpy()).max())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= PARAM_RTOL, top


# ----------------------------------------------------------- the pieces


def test_vq_stream_source_and_train_batches_equal_jax(f32_forwards,
                                                     tmp_path):
    """The synthetic split, the stream's views and the merged stream, the
    synthetic frames and query, and the train batches (the permutation,
    every window, at accumulation 2 and for the importance pass's last
    batch): bit for bit."""
    for kw in ({}, {"num_frames": 60, "window": 30}):
        jt, jv = j_vq.make_synthetic_vq_split(np.random.default_rng(4),
                                              **kw)
        tt, tv = t_vq.make_synthetic_vq_split(np.random.default_rng(4),
                                              **kw)
        _leaves_equal(jt, tt)
        _leaves_equal(jv, tv)
    js, ts = j_vq.VQTaskStream(jt, jv), t_vq.VQTaskStream(tt, tv)
    for j in range(3):
        assert ([v["id"] for v in ts.train_videos(j)]
                == [v["id"] for v in js.train_videos(j)])
        assert ([v["id"] for v in ts.val_videos_task(j)]
                == [v["id"] for v in js.val_videos_task(j)])
        assert ts.memory_quota(8, j + 1) == js.memory_quota(8, j + 1)
    jm, tm = j_vq.merge_vq_tasks(js), t_vq.merge_vq_tasks(ts)
    assert tm.num_tasks == jm.num_tasks == 1
    assert tm.train_tasks == jm.train_tasks
    src_j, src_t = j_vq.SyntheticVQSource(16), t_vq.SyntheticVQSource(16)
    s = tt[1]["cat_2"][0]
    np.testing.assert_array_equal(src_t.clip(s), src_j.clip(s))
    np.testing.assert_array_equal(src_t.query(s), src_j.query(s))
    assert TASKS.get("vq") is t_vq.VQEpisodeRunner
    jr = j_vq.VQEpisodeRunner(js, src_j, str(tmp_path / "j"), window=4,
                              frame_size=16, accumulation_steps=2,
                              persist_config=False)
    tr = t_vq.VQEpisodeRunner(ts, src_t, str(tmp_path / "t"), window=4,
                              frame_size=16, accumulation_steps=2,
                              persist_config=False, device="cpu")
    videos = ts.train_videos(1)
    for kw in ({"epoch_key": (1 << 16) | 1},
               {"batch_size": 2, "epoch_key": t_vq._IMPORTANCE_EPOCH_KEY,
                "last_only": True}):
        seq = np.random.SeedSequence([0, 1, 1])
        jb = list(jr._train_batches(videos, np.random.default_rng(seq),
                                    **kw))
        tb = list(tr._train_batches(videos, np.random.default_rng(seq),
                                    **kw))
        assert len(tb) == len(jb) >= 1
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], np.asarray(a[k]))


def test_vq_config_section_reads_and_writes_as_jax(tmp_path):
    """configs/vq_vilco.yaml's vq section: the port's config reads it
    (VQConfig equal to vq_flagship_config(), the runner's fields at their
    defaults) and writes it back in JAX's layout; use_query_roi is read
    and written as JAX's, and a field JAX's section lacks is refused."""
    from vilco_tpu.core.config import Config as JConfig
    from vilco_tpu.core.config import load_config as j_load_config

    jcfg = j_load_config("configs/vq_vilco.yaml")
    port = config_from_dict(jcfg.to_dict())
    assert port.task == "vq" and port.vq == vq_flagship_config()
    assert JConfig.from_dict(json.loads(json.dumps(port.to_dict()))).vq == (
        jcfg.vq)
    assert set(port.vq.to_dict()) == set(dataclasses.asdict(jcfg.vq))
    roi = VQConfig.from_dict({"use_query_roi": True})
    assert roi.use_query_roi and roi.to_dict() == VQCfg(
        use_query_roi=True).to_dict()
    with pytest.raises(ValueError, match="eval_windows"):
        VQConfig.from_dict({"eval_windows": 4})
    assert Config().vq == VQConfig()


# ----------------------------------------------------------- locksteps


def test_naive_vq_episode_lockstep_matches_jax(naive):
    """The 2-task naive episode against JAX's VQEpisodeRunner."""
    check_lockstep(naive)
    assert naive.pres["method"] == "naive" and not naive.pr.reg_list


def test_ewc_vq_episode_lockstep_matches_jax(ewc):
    """EWC at lambda 3000: task 0's importance from its last batch at the
    micro batch size (the frozen ViT's 0), the penalty in task 1."""
    check_lockstep(ewc)
    assert ewc.pres["tasks"][1]["train"]["reg_penalty"] > 0
    (jimp, jopt), = ewc.jr.reg_list
    (pimp, popt), = ewc.pr.reg_list
    jimp, jopt = params_from_jax(_np(jimp)), params_from_jax(_np(jopt))
    assert pimp.keys() == jimp.keys() == popt.keys()
    top = max(float(v.abs().max()) for v in jimp.values())
    for n in jimp:
        got, ref = pimp[n].numpy(), jimp[n].numpy()
        if n.startswith("backbone."):
            assert not got.any() and not ref.any(), n
            continue
        d = np.abs(got - ref)
        zero = zero_grad_slice(n, d.shape)
        if zero is not None:
            assert d[zero].max() <= 1e-6 * top, n
            d[zero] = 0.0
        assert d.max() <= IMP_RTOL * np.abs(ref).max(), n
        np.testing.assert_array_equal(popt[n].numpy().shape, jopt[n].shape)


def test_vq_checkpoints_and_config_read_both_ways(naive):
    """The port's vq_task_*.ckpt in JAX's reader and JAX's in the port
    (its Flax tree through models/convert.py, the frozen ViT included);
    each vq_config.json read by the other package's VQ config."""
    for j in range(2):
        path = os.path.join(naive.pdir, f"vq_task_{j:03d}.ckpt")
        got = j_ckpt.load_checkpoint(path)
        _leaves_equal(t_ckpt.load_checkpoint(path), got)
        assert got["task"] == j and set(got["params"]) == {
            n for n, _ in naive.pr.model.named_parameters()}
    path = os.path.join(naive.jdir, "vq_task_001.ckpt")
    ref, got = j_ckpt.load_checkpoint(path), t_ckpt.load_checkpoint(path)
    _leaves_equal(ref, got)
    want = params_from_jax(ref["params"])
    have = t_ckpt.params_of(got)
    assert have.keys() == {n for n, _ in naive.pr.model.named_parameters()}
    assert all(torch.equal(have[k], want[k]) for k in want)
    with open(os.path.join(naive.pdir, "vq_config.json")) as f:
        pman = json.load(f)
    with open(os.path.join(naive.jdir, "vq_config.json")) as f:
        jman = json.load(f)
    assert pman == jman
    assert VQCfg.from_dict(pman["model_cfg"]) == naive.jcfg
    assert VQConfig.from_dict(jman["model_cfg"]).to_dict() == (
        naive.pcfg.to_dict())


# ----------------------------------------------------------- the CLIs


def test_port_vq_infer_reads_a_jax_workdir(naive, f32_forwards):
    """vq_infer --synthetic on JAX's naive episode's workdir (its
    vq_config.json and Flax-tree checkpoint): the port's numbers equal
    JAX's vq_infer's at 1e-6."""
    ref = j_vq_infer.main(["--workdir", naive.jdir, "--synthetic"])
    got = vq_infer.main(["--workdir", naive.jdir, "--synthetic", *CPU])
    check_vq_eval(ref, got, CHAIN_ATOL)
    check_vq_eval(naive.jres["final"], got, EVAL_ATOL)


def test_train_cl_vq_then_vq_infer_reproduces_the_final_eval(f32_forwards,
                                                             tmp_path):
    """train_cl --task vq --synthetic at JAX's toy geometry (2 tasks, 1
    epoch, EWC): results.json has the keys of JAX's train_cl's, the
    workdir's vq_config.json JAX's layout, and the port's vq_infer on it
    reproduces the final eval."""
    argv = ["--task", "vq", "--synthetic", "--num-tasks", "2", "--epochs",
            "1", "--method", "ewc", "--reg-lambda", "3000"]
    ref = j_train_cl.main([*argv, "--workdir", str(tmp_path / "j")])
    res = train_cl.main([*argv, "--workdir", str(tmp_path / "t"), *CPU])
    with open(tmp_path / "t" / "results.json") as f:
        saved = json.load(f)
    assert saved.keys() == ref.keys() and len(saved["tasks"]) == 2
    for a, b in zip(ref["tasks"], saved["tasks"]):
        assert set(b["train"]) == set(a["train"]) | {"grad_norm"}
        assert b["eval"].keys() == a["eval"].keys()
        assert [t.keys() for t in b["eval"]["per_task"]] == [
            t.keys() for t in a["eval"]["per_task"]]
    with open(tmp_path / "t" / "vq_config.json") as f:
        man = json.load(f)
    assert man == {"window": 4, "frame_size": 32, "model_cfg": None}
    ev = vq_infer.main(["--workdir", str(tmp_path / "t"), "--synthetic",
                        *CPU])
    check_vq_eval(res["final"], ev, 0.0)


def test_vq_cli_refusals(tmp_path, capsys):
    """train_cl --task vq needs a source; --annotations without frames and
    --submission without annotations exit with a message."""
    for main, argv, msg in (
            (train_cl.main, ["--task", "vq"], "--synthetic"),
            (train_cl.main, ["--task", "vq", "--vq-annotations", "x.json"],
             "No such file"),
            (vq_infer.main, ["--submission", "s.json"], "--annotations")):
        with pytest.raises((SystemExit, FileNotFoundError)) as e:
            main(["--workdir", str(tmp_path), *argv, *CPU])
        if e.type is SystemExit:
            assert e.value.code != 0
            assert msg in capsys.readouterr().err
        else:
            assert msg in str(e.value)


def test_nlq_and_vq_runners_refuse_a_missing_card(tmp_path, monkeypatch):
    """The default device is the card; without one the NLQ and VQ runners
    and vq_infer raise (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((train_cl.main, ["--task", "nlq", "--synthetic"]),
                       (train_cl.main, ["--task", "vq", "--synthetic"]),
                       (vq_infer.main, ["--synthetic"])):
        with pytest.raises(RuntimeError, match="card"):
            main(["--workdir", str(tmp_path), "--num-tasks", "2", *argv])
