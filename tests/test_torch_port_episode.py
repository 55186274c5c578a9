"""The port's MQ CL episode against the JAX package on the CPU, part 1: the
copied modules, the configs, the checkpoints both ways, and the naive
method's episode lockstep and eval chain. The harness here (`run_pair`,
`check_lockstep`, `check_eval_chain`) also serves
test_torch_port_episode_{yaml,reg,cli}.py.

The episode lockstep runs vilco_tpu/cl/episode.py::EpisodeRunner and the
port's EpisodeRunner on the same 2-task synthetic split of
data/synthetic.py::tiny_config (2 classes a task, 2 train and 1 val
videos a class), from the same parameters: JAX's init perturbed by
N(0, 0.02), as the other locksteps start, so that no leaf sits at 0 where
a per-leaf relative measure would read f32 roundoff as a difference; at
lr 1e-4 (the other locksteps' rate), 1 + 2 epochs of warmup and cosine
(the first step's lr is 0); the loader's batch 8 holds a task's clips, so
an epoch is one step. The head rows a task reset draws are JAX's
(`_fresh_head_rows` replaced by the JAX draw through the conv layout).

Limits:
  the rehearsal memory's contents (class -> video ids, in order) exact;
  the loss normaliser 1e-6 relative;
  every train_epoch metric 1e-5 relative, but the EWC/MAS penalty: at
      theta = optpar (a task's first step) JAX's sum is 0 exactly and the
      port's folded f64 form leaves lambda x 2^-53-scale roundoff, 1e-6
      absolute there; elsewhere the penalty, and the grad norm its
      gradient enters, 1e-4 relative, as the importance it weighs by (a
      squared gradient at task 0's end, where the parameters differ by up
      to 5e-5; MAS's grad norm read 2.1e-5 at lambda 3000);
  the final parameters: every leaf within 5e-5 of its largest value, the
      leaves whose exact gradient is 0 or a cancelling sum of roundoff
      (an attention's key bias and key-norm bias, a time adapter's fc2
      bias) within 2 x the sum of the episode's lrs (AdamW moves any
      element by up to lr a step, whatever its gradient);
  the eval series (each task's avg mAP, R@k and per-threshold mAP) and
      both BwF 1e-4 absolute;
  the eval chain (JAX's end-of-episode state loaded into the port's
      runner): every number of evaluate(j) 1e-6 absolute.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.cl import episode as j_episode
from vilco_tpu.cl import stream as j_stream
from vilco_tpu.core import checkpoint as j_ckpt
from vilco_tpu.core.config import load_config as j_load_config
from vilco_tpu.data import pipeline as j_pipeline
from vilco_tpu.data.synthetic import make_synthetic_cl_split as j_split
from vilco_tpu.data.synthetic import tiny_config as j_tiny
from vilco_tpu.evals import anet_map as j_anet
from vilco_tpu.evals import retrieval as j_ret
from vilco_tpu.ops import ext_scores as j_ext
from vilco_tpu.tasks import tal as j_tal
from vilco_tpu.tasks.nlq import nlq_tiny_config
from vilco_tpu_torch.cl import episode as t_episode
from vilco_tpu_torch.cl import stream as t_stream
from vilco_tpu_torch.core import checkpoint as t_ckpt
from vilco_tpu_torch.core import config as t_config
from vilco_tpu_torch.data import pipeline as t_pipeline
from vilco_tpu_torch.data.synthetic import make_synthetic_cl_split as t_split
from vilco_tpu_torch.data.synthetic import tiny_config as t_tiny
from vilco_tpu_torch.evals import anet_map as t_anet
from vilco_tpu_torch.evals import retrieval as t_ret
from vilco_tpu_torch.models.convert import (
    adapter_ema_from_jax,
    params_from_jax,
)
from vilco_tpu_torch.ops import ext_scores as t_ext
from vilco_tpu_torch.tasks import tal as t_tal
from vilco_tpu_torch.train.optim import make_schedule

YAML = "configs/mq_vilco.yaml"
METRIC_RTOL = 1e-5
NORM_RTOL = 1e-6
PARAM_RTOL = 5e-5
EVAL_ATOL = 1e-4
CHAIN_ATOL = 1e-6
PENALTY_ATOL = 1e-6
# the penalty's F is the importance: a squared gradient taken at task 0's
# end, where the parameters differ by up to PARAM_RTOL
PENALTY_RTOL = 2 * PARAM_RTOL
LR = 1e-4
PERTURB = 0.02
VIDEOS = (2, 1)           # train, val videos a class
# leaves whose exact gradient is 0 (an attention's key and key-norm bias
# shift a query row's scores alike) or a cancelling sum of roundoff (a
# time adapter's fc2 bias: every LayerNorm removes its shift)
ROUNDOFF_GRAD = ("attn.key.bias", "attn.key_norm.bias", "adapter.fc2.bias")
EVAL_KEYS = ("avg_mAP", "avg_R1@0.3", "avg_R5@0.3", "avg_R1@0.5",
             "avg_R5@0.5", "BwF_R1@0.5", "BwF_mAP")
# the yaml's method at the tiny twin: L2P, narration SSL, time adapters
YAML_METHOD = {
    "dataset": {"use_text": True, "use_narration": True},
    "model": {"use_cross_modal": True, "use_xl": True, "xl_dropout": 0.0},
    "cl_cfg": {"name": "l2p", "memory_size": 20, "prompt_pool": True,
               "narration_ssl": True, "use_adapt": True,
               "adapt_blocks": (0, 1, 2)},
}


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def episode_overrides(method: str, **extra) -> dict:
    """tiny_config overrides of the lockstep's episode for `method`."""
    ov = {"cl_cfg": {"name": method, "num_tasks": 2},
          "opt": {"epochs": 2, "warmup_epochs": 1, "learning_rate": LR},
          "loader": {"batch_size": 8}}
    if method == "vilco":
        ov = _merge(ov, YAML_METHOD)
    if method in ("icarl", "bic"):
        ov["cl_cfg"]["memory_size"] = 20     # a quota of 5 keeps every clip
    return _merge(ov, extra)


def _sources(cfg, pipeline):
    text = (pipeline.SyntheticTextSource(cfg.model.n_txt_in,
                                         cfg.dataset.max_text_len)
            if cfg.dataset.use_text else None)
    nar = (pipeline.SyntheticNarrationSource(cfg.cl_cfg.narration_dim,
                                             cfg.dataset.max_narration_len)
           if cfg.cl_cfg.narration_ssl else None)
    return pipeline.SyntheticFeatureSource(cfg.dataset.input_dim), text, nar


def jax_fresh_rows(jcfg, kernel_shape):
    """The port runner's `_fresh_head_rows` giving JAX's draw
    (vilco_tpu/cl/episode.py::_reset_unseen_classes) in the conv layout."""
    def fresh(j, shape):
        f = nn.initializers.he_uniform()(
            jax.random.fold_in(jax.random.PRNGKey(jcfg.init_rand_seed),
                               1000 + j), kernel_shape, jnp.float32)
        return torch.from_numpy(np.asarray(f).transpose(2, 1, 0).copy())
    return fresh


@dataclasses.dataclass
class Pair:
    jcfg: object
    jr: object
    jres: dict
    pr: object
    pres: dict
    jdir: str
    pdir: str


def make_runners(method: str, root, **extra):
    """The JAX and port runners of the lockstep's episode (the port's with
    JAX's perturbed start parameters and head-row draws)."""
    jcfg = j_tiny(**episode_overrides(method, **extra))
    pcfg = t_config.config_from_dict(jcfg.to_dict())
    jdir, pdir = str(root / f"jax_{method}"), str(root / f"port_{method}")
    tr, va = j_split(np.random.default_rng(0), jcfg, *VIDEOS)
    src, text, nar = _sources(jcfg, j_pipeline)
    jr = j_episode.EpisodeRunner(jcfg, j_stream.TaskStream(tr, va), src,
                                 workdir=jdir, text_source=text,
                                 narration_source=nar)
    rng = np.random.default_rng(5)
    start = jax.tree.map(
        lambda a: np.asarray(a) + PERTURB * rng.standard_normal(
            np.shape(a)).astype(np.float32), jr.params)
    jr.params = jax.tree.map(jnp.asarray, start)
    tr, va = t_split(np.random.default_rng(0), pcfg, *VIDEOS)
    src, text, nar = _sources(pcfg, t_pipeline)
    pr = t_episode.EpisodeRunner(pcfg, t_stream.TaskStream(tr, va), src,
                                 workdir=pdir, text_source=text,
                                 narration_source=nar, device="cpu")
    pr.set_params(params_from_jax(start))
    pr._fresh_head_rows = jax_fresh_rows(
        jcfg, start["cls_head"]["cls"]["kernel"].shape)
    return jcfg, jr, pr, jdir, pdir


def run_pair(method: str, root, **extra) -> Pair:
    """Both episodes run to their end."""
    jcfg, jr, pr, jdir, pdir = make_runners(method, root, **extra)
    jres = jr.run()
    pres = pr.run()
    return Pair(jcfg, jr, jres, pr, pres, jdir, pdir)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def train_epochs(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train_epoch"]


def memory_ids(memory):
    return {int(c): [v["id"] for v in vs] for c, vs in memory.data.items()}


def check_lockstep(p: Pair):
    """The episode lockstep's limits (module docstring)."""
    assert memory_ids(p.pr.memory) == memory_ids(p.jr.memory)
    assert p.pr.loss_normalizer == pytest.approx(p.jr.loss_normalizer,
                                                 rel=NORM_RTOL)
    je, pe = train_epochs(p.jdir), train_epochs(p.pdir)
    assert len(je) == len(pe) == 2 * p.jcfg.opt.total_epochs
    for a, b in zip(je, pe):
        assert (a["step"], a["task"], a["epoch"]) == (b["step"], b["task"],
                                                      b["epoch"])
        for k in set(a) - {"kind", "t", "step", "task", "epoch"}:
            if k == "al_loss" and k not in b:
                assert a[k] == 0.0        # JAX's term at weight 0
            elif k == "reg_penalty" and a[k] == 0.0:
                assert abs(b[k]) <= PENALTY_ATOL, (a["task"], a["epoch"])
            elif k == "reg_penalty" or (k == "grad_norm"
                                        and a.get("reg_penalty", 0.0) > 0):
                assert _rel(b[k], a[k]) <= PENALTY_RTOL, (k, a, b)
            else:
                assert _rel(b[k], a[k]) <= METRIC_RTOL, (k, a, b)
    want = params_from_jax(jax.tree.map(np.asarray, p.jr.params))
    sched = make_schedule(p.pr.cfg.opt, 1)
    lr_sum = 2 * sum(float(sched(s)) for s in range(p.jcfg.opt.total_epochs))
    errs = {}
    for n, v in p.pr.model.named_parameters():
        got, ref = v.detach().numpy(), want[n].numpy()
        if n.endswith(ROUNDOFF_GRAD):
            assert np.abs(got - ref).max() <= 2 * lr_sum, n
        else:
            errs[n] = _rel(got, ref)
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= PARAM_RTOL, top
    for a, b in zip(p.jres["tasks"], p.pres["tasks"]):
        check_eval(a["eval"], b["eval"], EVAL_ATOL)


def check_eval(ref: dict, got: dict, atol: float):
    for k in EVAL_KEYS:
        assert abs(got[k] - ref[k]) <= atol, (k, got[k], ref[k])
    assert len(got["per_task"]) == len(ref["per_task"])
    for a, b in zip(ref["per_task"], got["per_task"]):
        np.testing.assert_allclose(b["mAP"], a["mAP"], rtol=0, atol=atol)
        np.testing.assert_allclose(b["recall"], a["recall"], rtol=0,
                                   atol=atol)


def chain_runner(p: Pair, root):
    """A fresh port runner holding JAX's end-of-episode state: the params,
    the adapter EMA, the memory and BiC's pairs."""
    _, _, pr, _, _ = make_runners(p.pr.method if p.pr.method != "l2p"
                                  else "vilco", root / "chain",
                                  **_extra_of(p))
    pr.set_params(params_from_jax(jax.tree.map(np.asarray, p.jr.params)))
    ema = getattr(p.jr, "_adapter_ema", None)
    if ema is not None:
        pr._adapter_ema = adapter_ema_from_jax(ema)
    pr.memory.data = p.jr.memory.data
    if p.jr.bic is not None:
        pr.bic.alphas = np.asarray(p.jr.bic.alphas, np.float32)
        pr.bic.betas = np.asarray(p.jr.bic.betas, np.float32)
        pr.bic.class_task = np.asarray(p.jr.bic.class_task)
        pr.bic.num_tasks_seen = p.jr.bic.num_tasks_seen
    return pr


def _extra_of(p: Pair) -> dict:
    return {"cl_cfg": {"reg_lambda": p.jcfg.cl_cfg.reg_lambda}}


def check_eval_chain(p: Pair, root):
    """evaluate(1) of the port's runner holding JAX's end state equals
    JAX's, every number at 1e-6."""
    pr = chain_runner(p, root)
    assert (pr._adapter_ema is None) == (
        getattr(p.jr, "_adapter_ema", None) is None)
    if pr._adapter_ema is not None:
        own = dict(pr.model.named_parameters())
        assert pr._adapter_ema.keys() <= own.keys()
    ref = p.jr.evaluate(1, update_bwf=False)
    got = pr.evaluate(1, update_bwf=False)
    check_eval(ref, got, CHAIN_ATOL)
    return pr, ref, got


@pytest.fixture(scope="module")
def naive(tmp_path_factory):
    return run_pair("naive", tmp_path_factory.mktemp("naive"))


# ----------------------------------------------------------- the copies


def _det_inputs(rng, n_vid=6, n_cls=3):
    gt = {"video-id": [], "t-start": [], "t-end": [], "label": []}
    pred = {"video-id": [], "t-start": [], "t-end": [], "label": [],
            "score": []}
    for v in range(n_vid):
        for _ in range(rng.integers(1, 4)):
            s = rng.uniform(0, 50)
            gt["video-id"].append(f"v{v}")
            gt["t-start"].append(s)
            gt["t-end"].append(s + rng.uniform(2, 20))
            gt["label"].append(int(rng.integers(0, n_cls)))
        for _ in range(rng.integers(0, 8)):
            s = rng.uniform(0, 50)
            pred["video-id"].append(f"v{v}")
            pred["t-start"].append(s)
            pred["t-end"].append(s + rng.uniform(1, 25))
            pred["label"].append(int(rng.integers(0, n_cls)))
            pred["score"].append(float(rng.random()))
    return gt, pred


def test_anet_map_copy_equals_jax():
    """ANETDetection's per-threshold mAP and mean, exact."""
    for seed in range(3):
        gt, pred = _det_inputs(np.random.default_rng(seed))
        ref = j_anet.ANETDetection(gt).evaluate(pred)
        got = t_anet.ANETDetection(gt).evaluate(pred)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_retrieval_and_bwf_copies_equal_jax():
    """moment_retrieval_recall on a task's own GT, ReferringRecall and two
    BwfTrackers over three tasks, exact."""
    cfg = j_tiny()
    _, va = j_split(np.random.default_rng(1), cfg, 2, 2)
    rng = np.random.default_rng(2)
    for task in va.values():
        gj, gt = (j_ret.retrieval_gt_from_task(task),
                  t_ret.retrieval_gt_from_task(task))
        assert gt == gj
        pred = {vid: {c: [[s, s + rng.uniform(1, 20), rng.random()]
                          for s in rng.uniform(0, 90, 5)]
                      for c in classes}
                for vid, classes in gj.items()}
        np.testing.assert_array_equal(t_ret.moment_retrieval_recall(gt, pred),
                                      j_ret.moment_retrieval_recall(gj, pred))
    gt = {k: [float(s), float(s) + 5.0]
          for k, s in enumerate(rng.uniform(0, 50, 8))}
    preds = [{"query_key": k, "predicted_times": rng.uniform(
        0, 60, (10, 2)).cumsum(1).tolist()} for k in gt]
    np.testing.assert_array_equal(t_ret.ReferringRecall(gt).evaluate(preds),
                                  j_ret.ReferringRecall(gt).evaluate(preds))
    jb, tb = j_ret.BwfTracker(), t_ret.BwfTracker()
    for t in range(3):
        vals = {i: float(rng.random()) for i in range(t + 1)}
        w = {i: i + 1 for i in range(t + 1)}
        assert tb.update(t, vals, w) == jb.update(t, vals, w)
    assert tb.recorded == jb.recorded


def test_cumulative_gt_and_ext_scores_copies_equal_jax():
    """cumulative_cl_gt over a 5-task split and the external score fusion,
    exact."""
    cfg = j_tiny()
    _, va = j_split(np.random.default_rng(3), cfg, 2, 2)
    ref, got = j_anet.cumulative_cl_gt(va), t_anet.cumulative_cl_gt(va)
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]))
    rng = np.random.default_rng(4)
    preds = {f"v{i}": {"segments": rng.uniform(0, 9, (5, 2)),
                       "scores": rng.random(5),
                       "labels": rng.integers(0, 4, 5)} for i in range(3)}
    scores = {"v0": rng.random(4), "v2": rng.random(4)}
    ref = j_ext.fuse_external_scores(preds, scores)
    got = t_ext.fuse_external_scores(preds, scores)
    for vid in preds:
        for k in ("segments", "scores", "labels"):
            np.testing.assert_array_equal(got[vid][k], ref[vid][k])


def test_tal_copy_equals_jax(tmp_path):
    """The TAL adapter's database read and label dict, exact."""
    db = {"database": {
        f"v{i}": {"subset": "training" if i < 3 else "validation",
                  "fps": 30.0, "duration": 60.0,
                  "annotations": [{"label": f"a{i % 2}", "label_id": i % 2,
                                   "segment": [1.0 + i, 5.0 + i]}] * 2}
        for i in range(5)}}
    path = tmp_path / "db.json"
    path.write_text(json.dumps(db))
    for split in ("train", "val"):
        ref = j_tal.DATASETS.make("thumos", str(path), split)
        got = t_tal.DATASETS.make("thumos", str(path), split)
        assert got["label_dict"] == ref["label_dict"]
        assert len(got["videos"]) == len(ref["videos"])
        for a, b in zip(ref["videos"], got["videos"]):
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(b["segments"], a["segments"])


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_iterator_copy_equals_jax(workers):
    """BatchIterator over ClipDataset, training (permutation, random-window
    crops, collate) for two epochs and eval (padding), with text and
    narration: every array and meta entry equal, bit for bit."""
    ov = {"dataset": {"use_text": True, "use_narration": True},
          "loader": {"num_workers": workers}}
    jcfg, pcfg = j_tiny(**ov), t_tiny(**ov)
    assert pcfg.dataset.crop_ratio == (0.9, 1.0)
    tr, _ = j_split(np.random.default_rng(0), jcfg, 3, 1)
    videos = j_stream.TaskStream(tr, tr).train_videos(0)
    its = []
    for pipe, cfg in ((j_pipeline, jcfg), (t_pipeline, pcfg)):
        src, text, nar = _sources(cfg, pipe)
        data = pipe.ClipDataset(videos, cfg, src, is_training=True,
                                text_source=text, narration_source=nar)
        ev = pipe.ClipDataset(videos, cfg, src, is_training=False)
        its.append((pipe.BatchIterator(data, cfg, 4, True, seed=3,
                                       num_workers=workers),
                    pipe.BatchIterator(ev, cfg, 4, False)))
    (jt, je), (tt, te) = its
    assert len(tt) == len(jt) and len(te) == len(je)
    for epoch in (0, 1):
        jt.set_epoch(epoch)
        tt.set_epoch(epoch)
        for (jb, jm), (tb, tm) in zip(jt, tt):
            assert jb.keys() == tb.keys() and jm == tm
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
    for (jb, jm), (tb, tm) in zip(je, te):
        assert jm == tm
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_rehearsal_memory_copy_equals_jax(tmp_path):
    """RehearsalMemory after two tasks at a quota that trims (random.Random
    shuffles), the merged train videos, and the save/load round trip
    through each package's checkpoint: exact."""
    cfg = j_tiny()
    tr, va = j_split(np.random.default_rng(0), cfg, 6, 1)
    js, ts = j_stream.TaskStream(tr, va), t_stream.TaskStream(tr, va)
    jm, tm = j_stream.RehearsalMemory(seed=4), t_stream.RehearsalMemory(seed=4)
    for j in range(2):
        m = js.memory_quota(8, len(js.classes_upto(j)))
        assert ts.memory_quota(8, len(ts.classes_upto(j))) == m
        jm.add_task(js.train_class_videos(j), m)
        tm.add_task(ts.train_class_videos(j), m)
        assert memory_ids(tm) == memory_ids(jm)
    assert ([v["id"] for v in ts.train_videos(2, tm)]
            == [v["id"] for v in js.train_videos(2, jm)])
    tm.save(str(tmp_path / "mem.pkl"))
    jm2 = j_stream.RehearsalMemory()
    jm2.load(str(tmp_path / "mem.pkl"))
    assert memory_ids(jm2) == memory_ids(jm)
    jm.save(str(tmp_path / "jmem.pkl"))
    tm2 = t_stream.RehearsalMemory()
    tm2.load(str(tmp_path / "jmem.pkl"))
    assert memory_ids(tm2) == memory_ids(jm)
    merged = t_stream.merge_tasks(ts)
    assert merged.num_tasks == 1
    assert merged.task_classes(0) == j_stream.merge_tasks(js).task_classes(0)


# ----------------------------------------------------------- the configs


def _jax_configs():
    from __graft_entry__ import _flagship_cfg

    mq_tiny = j_tiny(**_merge(YAML_METHOD, {
        "model": {"xl_dropout": 0.1},
        "cl_cfg": {"memory_size": 1010, "adapt_blocks": (0, 1, 2, 3, 4)}}))
    return {"mq_yaml": (j_load_config(YAML), t_config.mq_yaml_config()),
            "mq_yaml_tiny": (mq_tiny, t_config.mq_yaml_config(tiny=True)),
            "graft": (_flagship_cfg(), t_config.flagship_config()),
            "nlq_yaml": (j_load_config("configs/nlq_vilco.yaml"),
                         t_config.nlq_flagship_config()),
            "nlq_tiny": (nlq_tiny_config(),
                         t_config.nlq_flagship_config(tiny=True)),
            "tiny": (j_tiny(), t_tiny())}


@pytest.mark.parametrize("name", ["mq_yaml", "mq_yaml_tiny", "graft",
                                  "nlq_yaml", "nlq_tiny", "tiny"])
def test_config_from_dict_equals_port_config(name):
    """JAX's Config.to_dict() read by config_from_dict equals the port's
    config field by field, dataset and loader included; the port's
    to_dict() read by JAX's Config.from_dict().derived() equals JAX's (but
    output_folder, which no path reads)."""
    from vilco_tpu.core.config import Config as JConfig

    jcfg, port = _jax_configs()[name]
    assert t_config.config_from_dict(jcfg.to_dict()) == port
    back = JConfig.from_dict(json.loads(json.dumps(port.to_dict())))
    assert back.derived().updated(
        output_folder=jcfg.output_folder) == jcfg


def test_load_config_reads_yaml_and_json(tmp_path):
    """load_config of the yaml equals config_from_dict of JAX's derived
    config, and a config.json (what the episode persists) reads the
    same; tiny_config takes JAX's overrides."""
    port = t_config.load_config(YAML)
    assert port == t_config.config_from_dict(
        j_load_config(YAML).derived().to_dict()) == t_config.mq_yaml_config()
    path = tmp_path / "config.json"
    path.write_text(json.dumps(j_load_config(YAML).to_dict()))
    assert t_config.load_config(str(path)) == port
    ov = {"cl_cfg": {"name": "bic", "num_tasks": 2},
          "opt": {"epochs": 1}, "loader": {"batch_size": 4}}
    assert t_tiny(**ov) == t_config.config_from_dict(j_tiny(**ov).to_dict())
    assert t_tiny(**ov).batch_size == 4


@pytest.mark.parametrize("section,field,value", [
    ("opt", "no_such_field", 1), ("opt", "fused_apply_pc", True),
    ("model", "no_such_field", 1), (None, "ckpt_format", "orbax")])
def test_config_from_dict_refuses_what_the_port_cannot_run(section, field,
                                                           value):
    """A field the port cannot honour raises a ValueError naming it."""
    d = j_tiny().to_dict()
    if section is None:
        d[field] = value
    else:
        d[section][field] = value
    with pytest.raises(ValueError, match=field):
        t_config.config_from_dict(d)


@pytest.mark.parametrize("section,field,value", [
    ("train_cfg", "clip_grad_l2norm", 2.0),
    ("test_cfg", "nms_method", "hard"),
    ("model", "fpn_type", "fpn")])
def test_config_from_dict_carries_what_the_port_runs(section, field, value,
                                                     monkeypatch):
    """Fields the port once refused: the config carries the value and the
    model or the step reads it (the clip: a train step clips at 2.0; hard
    NMS: the runner's decode runs hard NMS; FPN1D: the model's neck)."""
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train import engine as t_engine

    d = j_tiny().to_dict()
    d[section][field] = value
    cfg = t_config.config_from_dict(d)
    assert getattr(getattr(cfg, section), field) == value
    assert cfg.to_dict()[section][field] == value
    calls = {}
    if section == "model":
        model = PointTransformer(cfg.model, device="cpu")
        assert type(model.neck).__name__ == "FPN1D"
    elif section == "test_cfg":
        monkeypatch.setattr(t_episode, "decode_and_nms_batch",
                            lambda *a, **kw: calls.update(kw))
        runner = type("Runner", (), {"cfg": cfg, "points": None,
                                     "num_classes": 3})()
        t_episode.EpisodeRunner._decode_batch(
            runner, {"cls_logits": None, "offsets": None, "fpn_mask": None},
            None)
        assert calls["use_soft_nms"] is False
    else:
        clip = t_engine.global_norm_clip
        monkeypatch.setattr(t_engine, "global_norm_clip", lambda *a, **kw: (
            calls.update(kw), clip(*a, **kw))[1])
        m = cfg.model
        pts = torch.from_numpy(generate_points(
            level_lengths(m), m.fpn_strides, m.regression_range))
        state = t_engine.init_train_state(
            PointTransformer(m, device="cpu"), cfg, 1, device="cpu")
        batch = t_engine.batch_to(make_batch(np.random.default_rng(0), 2,
                                             cfg), "cpu")
        met = t_engine.make_train_step(pts, cfg.train_cfg)(
            state, batch, t_engine.CLBatchExtras(
                torch.ones(m.num_classes, dtype=torch.bool)))
        assert calls["clip"] == 2.0 and torch.isfinite(met["grad_norm"])


# ----------------------------------------------------------- checkpoints


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(np.asarray(b), a)
    else:
        assert a == b


def test_jax_written_checkpoints_load_in_the_port(naive):
    """JAX's task_000.ckpt and memory file load in the port: every leaf
    equal, the Flax params equal to params_from_jax of JAX's read."""
    path = os.path.join(naive.jdir, "task_000.ckpt")
    ref, got = j_ckpt.load_checkpoint(path), t_ckpt.load_checkpoint(path)
    _leaves_equal(ref, got)
    want = params_from_jax(ref["params"])
    have = t_ckpt.params_of(got)
    assert have.keys() == want.keys()
    for k in want:
        assert torch.equal(have[k], want[k]), k
    mem = os.path.join(naive.jdir, naive.jcfg.cl_cfg.path_memory)
    if os.path.exists(mem):
        _leaves_equal(j_ckpt.load_checkpoint(mem), t_ckpt.load_checkpoint(mem))


def test_port_written_checkpoints_load_in_jax(naive):
    """The port's task checkpoints load in JAX's load_checkpoint with equal
    leaves: the flat params, bank, pointer, BwF records."""
    for j in range(2):
        path = os.path.join(naive.pdir, f"task_{j:03d}.ckpt")
        ref, got = t_ckpt.load_checkpoint(path), j_ckpt.load_checkpoint(path)
        _leaves_equal(ref, got)
        assert got["task"] == j and set(got["params"]) == {
            n for n, _ in naive.pr.model.named_parameters()}


def test_bf16_leaf_round_trips_without_ml_dtypes(tmp_path, monkeypatch):
    """A torch bf16 leaf round-trips with ml_dtypes unimportable; JAX's
    reader sees the same values as ml_dtypes.bfloat16; orbax is refused."""
    w = torch.randn(3, 5).to(torch.bfloat16)
    tree = {"w": w, "x": np.arange(4.0), 3: ("a", None, [1.5, True])}
    path = str(tmp_path / "bf16.ckpt")
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    t_ckpt.save_checkpoint(path, tree)
    back = t_ckpt.load_checkpoint(path)
    monkeypatch.delitem(sys.modules, "ml_dtypes")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert back[3] == ("a", None, [1.5, True])
    np.testing.assert_array_equal(back["x"], np.arange(4.0))
    jback = j_ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jback["w"], np.float32),
                                  w.float().numpy())
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.save_checkpoint(path, tree, arrays_format="orbax")


def test_load_params_into_keeps_resized_leaves_fresh(tmp_path, naive):
    """--init-from: leaves of another shape keep their fresh value, the
    rest are copied into the parameters' own storage."""
    tree = t_ckpt.load_checkpoint(os.path.join(naive.pdir, "task_001.ckpt"))
    tree["params"]["cls_head.cls.bias"] = np.zeros(3, np.float32)
    path = str(tmp_path / "init.ckpt")
    t_ckpt.save_checkpoint(path, tree)
    _, _, pr, _, _ = make_runners("naive", tmp_path)
    bias = pr.model.cls_head.cls.bias.detach().clone()
    ptr = pr.model.cls_head.cls.weight.data_ptr()
    n = t_ckpt.load_params_into(path, pr.model)
    assert n == len(tree["params"]) - 1
    assert torch.equal(pr.model.cls_head.cls.bias, bias)
    assert pr.model.cls_head.cls.weight.data_ptr() == ptr
    np.testing.assert_array_equal(
        pr.model.cls_head.cls.weight.detach().numpy(),
        tree["params"]["cls_head.cls.weight"])


# ----------------------------------------------------------- naive episode


def test_naive_episode_lockstep_matches_jax(naive):
    """The 2-task naive episode against JAX's EpisodeRunner (limits in the
    module docstring)."""
    check_lockstep(naive)
    assert naive.pres["method"] == "naive"


def test_naive_eval_chain_matches_jax(naive, tmp_path):
    """JAX's end-of-episode params in the port's runner: evaluate(1)
    equals JAX's at 1e-6."""
    check_eval_chain(naive, tmp_path)


def test_episode_resume_continues_from_the_last_checkpoint(naive, tmp_path):
    """_try_resume reads task_000.ckpt and the memory (the port's own, and
    JAX's through models/convert.py): the params bit-equal, the task and
    n_known as saved."""
    for src in (naive.pdir, naive.jdir):
        _, _, pr, _, _ = make_runners("naive", tmp_path / os.path.basename(
            src))
        shutil.copy(os.path.join(src, "task_000.ckpt"), pr.workdir)
        task, n_known = pr._try_resume()
        assert (task, n_known) == (0, 0)
        want = t_ckpt.params_of(t_ckpt.load_checkpoint(
            os.path.join(src, "task_000.ckpt")))
        for n, p in pr.model.named_parameters():
            assert torch.equal(p.detach(), want[n]), n
