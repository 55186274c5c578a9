"""MQ task plugin: moment-query temporal localization as a CL stream
(vilco_tpu/tasks/mq.py: the sources copied, the runner the port's).

The MQ flavor is the EpisodeRunner's native configuration (SURVEY.md §3.1):
class-keyed 5-task QIL over Ego4D moment annotations, the single-tower
conv-transformer pyramid with optional text cross-attention, ANET mAP +
retrieval R@k eval. This module adds the real-data source adapters matching
the reference file formats:

  - per-clip video features: .pt/.npy/.pkl (DirFeatureSource,
    MQ/libs/datasets/ego4d.py:612-684)
  - per-clip CLIP text prompts: a {class_name: (L, 768)} dict in one .pt
    per clip, concatenated in 'concat' mode (ego4d.py:762-788)
  - narration CLIP-token features: one .npz per query id with
    'token_features', plus a jsonl mapping clips to narration queries
    (ego4d.py:793-824; produced by extractors/clip_text.py)

VQ-style dead ctor code in the reference (prompt/narration members on
ClipMatcher that the forward never uses) has no counterpart here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from vilco_tpu_torch.cl.episode import EpisodeRunner
from vilco_tpu_torch.core.config import Config
from vilco_tpu_torch.core.registry import TASKS

MQEpisodeRunner = TASKS.register("mq")(EpisodeRunner)


class MQTextSource:
    """Concatenated per-class CLIP prompt tokens for a clip
    (ego4d.py:762-788, output_format='concat')."""

    def __init__(self, folder: str, ext: str = ".pt"):
        self.folder = folder
        self.ext = ext

    def __call__(self, video: dict) -> np.ndarray:
        path = os.path.join(self.folder, video["id"] + self.ext)
        if self.ext == ".pt":
            import torch

            d = torch.load(path, map_location="cpu", weights_only=False)
            parts = [np.asarray(v, np.float32) for v in d.values()]
        else:
            d = np.load(path, allow_pickle=True)
            parts = [np.asarray(d[k], np.float32) for k in d.files]
        return np.concatenate(parts, axis=0)        # (L_total, 768)


class MQNarrationSource:
    """Narration token features for clips whose narrations fall inside a GT
    segment (+-1s), ego4d.py:793-824."""

    def __init__(self, feat_dir: str, narration_jsonl: str,
                 ext: str = ".npz"):
        self.feat_dir = feat_dir
        self.ext = ext
        self.by_clip: Dict[str, List[dict]] = {}
        if narration_jsonl and os.path.exists(narration_jsonl):
            with open(narration_jsonl) as f:
                for line in f:
                    if not line.strip():
                        continue
                    nd = json.loads(line)
                    self.by_clip.setdefault(nd["video_id"], []).append(nd)

    def __call__(self, video: dict) -> Optional[np.ndarray]:
        cands = self.by_clip.get(video["id"], [])
        feats = []
        segs = np.asarray(video.get("segments", np.zeros((0, 2))))
        for nd in cands:
            ts = nd.get("timestamps", [[0, 0]])[0]
            hit = any(
                s[0] - 1 <= ts[0] and s[1] + 1 >= ts[1] for s in segs
            )
            if not hit:
                continue
            path = os.path.join(self.feat_dir, nd["query_id"] + self.ext)
            if not os.path.exists(path):
                continue
            d = np.load(path)
            feats.append(np.asarray(
                d.get("token_features", d.get("features")), np.float32
            ).reshape(-1, d["token_features"].shape[-1]
                      if "token_features" in d else -1))
        if not feats:
            return None
        return np.concatenate(feats, axis=0)


def build_mq_runner(cfg: Config, workdir: str,
                    persist_config: bool = True,
                    device="cuda", writes: bool = True) -> EpisodeRunner:
    """Wire up the real-data MQ episode from a config (bin/train_cl.py's
    non-synthetic path for MQ); `writes` as EpisodeRunner's."""
    from vilco_tpu_torch.cl.stream import TaskStream
    from vilco_tpu_torch.data.pipeline import DirFeatureSource

    stream = TaskStream.from_pkl(cfg.cl_cfg.pkl_file)
    src = DirFeatureSource(cfg.dataset.feat_folder, cfg.dataset.file_ext,
                           cfg.dataset.file_prefix)
    text_source = (
        MQTextSource(cfg.dataset.text_feat_folder)
        if cfg.dataset.use_text and cfg.dataset.text_feat_folder else None
    )
    narration_source = (
        MQNarrationSource(cfg.dataset.narration_feat_folder,
                          cfg.dataset.narration_jsonl)
        if cfg.dataset.use_narration and cfg.dataset.narration_feat_folder
        else None
    )
    return EpisodeRunner(
        cfg, stream, src, workdir=workdir,
        text_source=text_source, narration_source=narration_source,
        persist_config=persist_config, device=device, writes=writes,
    )
