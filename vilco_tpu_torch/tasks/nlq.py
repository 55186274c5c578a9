"""NLQ task plugin: natural-language query grounding as a CL stream
(vilco_tpu/tasks/nlq.py: the sources and the stream copied, the runner the
port's EpisodeRunner with NLQ's eval).

The equivalent of the NLQ stack (NLQ/train_cl.py:37-365,
NLQ/libs/datasets/{ego4d_loader,cl_benchmark}.py, NLQ/libs/utils/metrics.py):
samples are (video, text-query) pairs, tasks are the 13 query templates,
the model is the dual-tower point transformer with a class-agnostic head
(num_classes=1), evaluation is ReferringRecall R@{1,5,10} @ tIoU {0.3,0.5}
per task (non-cumulative val sets, NLQ/cl_benchmark.py:60-75) with BwF on
R1@0.3 (NLQ/train_utils.py:784-870).
"""

from __future__ import annotations

import hashlib
import json
import logging
import random
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from vilco_tpu_torch.cl.episode import EpisodeRunner
from vilco_tpu_torch.cl.stream import RehearsalMemory, _dedup_by_id
from vilco_tpu_torch.core.config import Config
from vilco_tpu_torch.core.registry import TASKS
from vilco_tpu_torch.evals.retrieval import BwfTracker, ReferringRecall

log = logging.getLogger("vilco.nlq")


def adapt_query_record(rec: dict, fps: float = 30.0) -> dict:
    """Normalize a reference NLQ jsonl record (query_id, video_id/clip_uid,
    timestamps, duration, query_type, ...) into the generic pipeline video
    dict."""
    ts = np.asarray(rec["timestamps"], np.float32)
    if ts.ndim == 1:
        ts = ts[None, :]
    return {
        "id": str(rec["query_id"]),
        "video_id": rec.get("video_id", rec.get("clip_uid")),
        "segments": ts,
        "labels": np.zeros((len(ts),), np.int64),
        "duration": float(rec["duration"]),
        "fps": float(rec.get("fps", fps)),
        "query_key": (
            rec.get("clip_uid", rec.get("video_id")),
            rec.get("annotation_uid", rec.get("query_id")),
            int(rec.get("query_idx", 0)),
        ),
        "query_type": rec.get("query_type", "nlq"),
        "raw": rec,
    }


class NLQTaskStream:
    """Template-keyed QIL stream ({template: [query records]},
    NLQ/cl_benchmark.py:18-110). Presents the same surface the episode
    engine uses from TaskStream."""

    def __init__(self, train_tasks: Dict[str, List[dict]],
                 val_tasks: Dict[str, List[dict]],
                 shuffle_order: bool = False, seed: int = 0):
        self.task_ids = list(train_tasks)
        if shuffle_order:
            random.Random(seed).shuffle(self.task_ids)
        self.train_tasks = train_tasks
        self.val_tasks = val_tasks

    @property
    def num_tasks(self) -> int:
        return len(self.task_ids)

    def task_classes(self, j: int) -> List[int]:
        return [0]

    def classes_upto(self, j: int) -> List[int]:
        return [0]

    def train_class_videos(self, j: int) -> Dict[str, List[dict]]:
        t = self.task_ids[j]
        return {t: list(self.train_tasks[t])}

    def train_videos(self, j: int,
                     memory: Optional[RehearsalMemory] = None) -> List[dict]:
        videos = []
        if memory is not None:
            videos.extend(memory.videos())
        for v in self.train_tasks[self.task_ids[j]]:
            v = dict(v)
            v.setdefault("is_memory", False)
            videos.append(v)
        return _dedup_by_id(videos)

    def val_videos_task(self, i: int) -> List[dict]:
        return list(self.val_tasks[self.task_ids[i]])

    def val_videos_upto(self, j: int) -> List[dict]:
        out = []
        for i in range(j + 1):
            out.extend(self.val_videos_task(i))
        return _dedup_by_id(out)

    def memory_quota(self, memory_size: int, n_seen: int) -> int:
        # reference hardcodes // num_templates (NLQ/train_cl.py:292-297)
        return memory_size // max(n_seen, 1)


@TASKS.register("nlq")
class NLQEpisodeRunner(EpisodeRunner):
    """Episode engine specialization: template tasks, ReferringRecall eval,
    BwF over R1@0.3."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.bwf_r1 = BwfTracker()

    def _setup_eval(self):
        self.cl_gt = None  # ReferringRecall builds GT per task in evaluate()

    def _class_mask(self, j: int) -> torch.Tensor:
        return torch.ones((self.num_classes,), dtype=torch.bool,
                          device=self.device)

    def predict_submission(self, j: int, topk: int = 5) -> List[dict]:
        """Official ego4d_nlq_challenge `results` records for every val
        query of tasks 0..j: {clip_uid, annotation_uid, query_idx,
        predicted_times: [[start_s, end_s, score], ...]} — the format the
        official scorer consumes (NLQ/evaluate_ego4d_nlq.py:84-96) and
        NLQ/ensemble.py fuses across models (our bin/ensemble.py reads
        these files directly)."""
        class_mask = self._class_mask(j)
        records = []
        for i in range(j + 1):
            videos = self.stream.val_videos_task(i)
            preds = self.predict_videos(videos, class_mask)
            for v in videos:
                clip_uid, anno_uid, q_idx = v["query_key"]
                p = preds.get(v["id"])
                times = []
                if p is not None:
                    # decode emits score-sorted proposals
                    for seg, sc in zip(p["segments"][:topk],
                                       p["scores"][:topk]):
                        times.append([float(seg[0]), float(seg[1]),
                                      float(sc)])
                records.append({
                    "clip_uid": clip_uid,
                    "annotation_uid": anno_uid,
                    "query_idx": int(q_idx),
                    "predicted_times": times,
                })
        return records

    def evaluate(self, j: int, update_bwf: bool = True) -> Dict:
        class_mask = self._class_mask(j)
        per_task = []
        per_task_r1_03 = {}
        weights = {}
        for i in range(j + 1):
            videos = self.stream.val_videos_task(i)
            preds = self.predict_videos(videos, class_mask)
            gt, records = {}, []
            for v in videos:
                qk = v["query_key"]
                seg = np.asarray(v["segments"], np.float32)[0]
                gt[qk] = [float(seg[0]), float(seg[1])]
                p = preds.get(v["id"])
                times = (
                    [[float(s[0]), float(s[1])] for s in p["segments"]]
                    if p is not None else []
                )
                records.append({"query_key": qk, "predicted_times": times})
            res = ReferringRecall(gt).evaluate(records)
            weights[i] = len(videos)
            per_task_r1_03[i] = float(res[0, 0])
            per_task.append({
                "task": i,
                "recall": res.tolist(),
                "R1@0.3": float(res[0, 0]),
                "R1@0.5": float(res[1, 0]),
                "R5@0.3": float(res[0, 1]),
                "R5@0.5": float(res[1, 1]),
                # keep keys the base runner's callers read
                "avg_mAP": float(res.mean()),
            })
        bwf = (self.bwf_r1.update(j, per_task_r1_03, weights)
               if update_bwf else 0.0)
        avg = lambda key: float(np.average(
            [t[key] for t in per_task],
            weights=[weights[t["task"]] for t in per_task],
        ))
        return {
            "per_task": per_task,
            "avg_mAP": avg("avg_mAP"),
            "avg_R1@0.3": avg("R1@0.3"),
            "avg_R1@0.5": avg("R1@0.5"),
            "avg_R5@0.3": avg("R5@0.3"),
            "avg_R5@0.5": avg("R5@0.5"),
            "BwF_R1@0.5": bwf,   # NLQ tracks BwF on R1@0.3; key kept uniform
            "BwF_R1@0.3": bwf,
            "BwF_mAP": bwf,
        }


def load_nlq_tasks(jsonl_path: str, fps: float = 30.0) -> Dict[str, List[dict]]:
    """Group a reference NLQ jsonl (NLQ/libs/datasets/ego4d_loader.py:130-135
    load_jsonl) into the template-keyed task dict NLQTaskStream consumes."""
    tasks: Dict[str, List[dict]] = {}
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = adapt_query_record(json.loads(line), fps=fps)
            tasks.setdefault(rec["query_type"], []).append(rec)
    return tasks


class LmdbNLQFeatures:
    """Real NLQ features straight from the reference's released LMDB envs
    (ego4d_loader.py:94-105: video env keyed by video_id with npz
    {'features': (Lv, D)}; text env keyed by query_id with
    {'token_features': (Lq, D)} or pooled {'features': (D,)}).

    Reads via the zero-dependency parser in data/lmdb_io.py — no `lmdb`
    package needed. A separate val text env (the reference opens one per
    split) is consulted as a fallback when the qid is absent from the
    train env.
    """

    def __init__(self, video_lmdb: str, text_lmdb: str,
                 val_text_lmdb: Optional[str] = None):
        from vilco_tpu_torch.data.lmdb_io import LmdbReader

        self._video = LmdbReader(video_lmdb)
        self._text = LmdbReader(text_lmdb)
        self._val_text = (
            LmdbReader(val_text_lmdb)
            if val_text_lmdb and val_text_lmdb != text_lmdb else None
        )

    def video(self, v: dict) -> np.ndarray:
        from vilco_tpu_torch.data.lmdb_io import read_npz_value

        buf = self._video.get(str(v["video_id"]).encode())
        if buf is None:
            raise KeyError(f"video_id {v['video_id']} not in video lmdb")
        return read_npz_value(buf)["features"].astype(np.float32)

    def text(self, v: dict) -> np.ndarray:
        from vilco_tpu_torch.data.lmdb_io import read_npz_value

        qid = str(v["id"]).encode()
        buf = self._text.get(qid)
        if buf is None and self._val_text is not None:
            buf = self._val_text.get(qid)
        if buf is None:
            raise KeyError(f"query_id {v['id']} not in text lmdb(s)")
        d = read_npz_value(buf)
        q = d.get("token_features", d.get("features"))
        q = np.asarray(q, np.float32)
        if q.ndim == 1:                        # pooled feature -> one token
            q = q[None, :]
        return q


class DirNLQFeatures:
    """NLQ features from per-key files ({video_id}.npy + {query_id}.npz),
    the layout bin/import_lmdb.py emits and extractors/clip_text.py
    produces."""

    def __init__(self, video_dir: str, text_dir: str):
        self.video_dir = video_dir
        self.text_dir = text_dir

    def video(self, v: dict) -> np.ndarray:
        import os

        return np.load(os.path.join(
            self.video_dir, f"{v['video_id']}.npy")).astype(np.float32)

    def text(self, v: dict) -> np.ndarray:
        import os

        d = np.load(os.path.join(self.text_dir, f"{v['id']}.npz"))
        q = np.asarray(
            d["token_features"] if "token_features" in d else d["features"],
            np.float32)
        return q[None, :] if q.ndim == 1 else q


def build_nlq_runner(cfg: Config, workdir: str, train_jsonl: str,
                     val_jsonl: str, video_lmdb: Optional[str] = None,
                     text_lmdb: Optional[str] = None,
                     val_text_lmdb: Optional[str] = None,
                     video_dir: Optional[str] = None,
                     text_dir: Optional[str] = None,
                     persist_config: bool = True,
                     device="cuda") -> "NLQEpisodeRunner":
    """Real-data NLQ episode: jsonl annotations + lmdb or per-file features
    (bin/train_cl.py's non-synthetic NLQ path), on `device`."""
    fps = float(getattr(cfg.dataset, "default_fps", 30.0) or 30.0)
    stream = NLQTaskStream(load_nlq_tasks(train_jsonl, fps),
                           load_nlq_tasks(val_jsonl, fps))
    if video_lmdb:
        if not text_lmdb:
            raise ValueError("--nlq-video-lmdb needs --nlq-text-lmdb "
                             "(query_id-keyed token features)")
        feats = LmdbNLQFeatures(video_lmdb, text_lmdb, val_text_lmdb)
    elif video_dir:
        if not text_dir:
            raise ValueError("--nlq-video-dir needs --nlq-text-dir "
                             "({query_id}.npz token features)")
        feats = DirNLQFeatures(video_dir, text_dir)
    else:
        raise ValueError("build_nlq_runner needs --nlq-video-lmdb or "
                         "--nlq-video-dir")
    return NLQEpisodeRunner(cfg, stream, feats.video, workdir=workdir,
                            text_source=feats.text,
                            persist_config=persist_config, device=device)


class SyntheticNLQFeatures:
    """Per-(query, video) features with the GT span marked by a bump whose
    channel depends on a hash of the query id, and matching query token
    features, so grounding is learnable."""

    def __init__(self, vid_dim: int, txt_dim: int, feat_stride: float = 16.0,
                 fps: float = 30.0, signal: float = 2.5, max_grid: int = 256):
        self.vid_dim = vid_dim
        self.txt_dim = txt_dim
        self.stride = feat_stride
        self.fps = fps
        self.signal = signal
        self.max_grid = max_grid

    def _qchan(self, qid: str) -> int:
        return int(hashlib.md5(qid.encode()).hexdigest()[:8], 16) % self.vid_dim

    def video(self, v: dict) -> np.ndarray:
        seed = int(hashlib.md5(v["id"].encode()).hexdigest()[8:16], 16)
        rng = np.random.default_rng(seed)
        dur = float(v["duration"])
        T = int(min(max(8, round(dur * self.fps / self.stride)),
                    self.max_grid))
        feats = rng.standard_normal((T, self.vid_dim)).astype(np.float32) * 0.5
        ch = self._qchan(v["id"])
        for seg in v["segments"]:
            s = int(np.clip(seg[0] / dur * T, 0, T - 1))
            e = int(np.clip(seg[1] / dur * T, s + 1, T))
            feats[s:e, ch] += self.signal
        return feats

    def text(self, v: dict) -> np.ndarray:
        ch = self._qchan(v["id"])
        rng = np.random.default_rng(ch)
        tokens = rng.standard_normal((6, self.txt_dim)).astype(np.float32) * 0.2
        tokens[:, ch % self.txt_dim] += 2.0
        return tokens


def make_synthetic_nlq_split(rng: np.random.Generator, cfg: Config,
                             queries_per_template_train: int = 8,
                             queries_per_template_val: int = 3):
    """{template: [adapted query records]} splits for tests/smoke runs."""
    K = cfg.cl_cfg.num_tasks

    def split(n, name):
        tasks = {}
        qid = 0
        for k in range(K):
            tmpl = f"template_{k}"
            recs = []
            for _ in range(n):
                dur = float(rng.uniform(40, 90))
                ln = float(rng.uniform(3, 15))
                st = float(rng.uniform(0, dur - ln))
                recs.append(adapt_query_record({
                    "query_id": f"{name}_q{qid:05d}",
                    "video_id": f"{name}_vid{qid:05d}",
                    "clip_uid": f"{name}_clip{qid:05d}",
                    "annotation_uid": f"a{qid:05d}",
                    "query_idx": 0,
                    "timestamps": [[st, st + ln]],
                    "duration": dur,
                    "query_type": tmpl,
                }))
                qid += 1
            tasks[tmpl] = recs
        return tasks

    return (split(queries_per_template_train, "train"),
            split(queries_per_template_val, "val"))


def nlq_tiny_config(**overrides) -> Config:
    """JAX's nlq_tiny_config with its overrides (a nested dict merged over
    JAX's layout): the port's one source of it is
    core/config.py::nlq_flagship_config(tiny=True)."""
    from vilco_tpu_torch.core.config import (
        config_from_dict,
        nlq_flagship_config,
    )
    from vilco_tpu_torch.data.synthetic import _deep_merge

    return config_from_dict(_deep_merge(
        nlq_flagship_config(tiny=True).to_dict(), overrides))
