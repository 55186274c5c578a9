"""External classification-score fusion.

Port of postprocess_results (MQ/libs/utils/postprocessing.py:97-150): for
each video, take the top-k external video-level class scores, replicate
every predicted segment once per top class, and geometric-mean the external
class score into the segment score (sqrt(cls_score * seg_score)).

A copy of vilco_tpu/ops/ext_scores.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Sequence

import numpy as np


def load_cls_scores(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
    else:
        with open(path, "rb") as f:
            data = pickle.load(f)
    return {k: np.asarray(v, np.float64) for k, v in data.items()}


def fuse_external_scores(
    preds: Dict[str, dict],
    cls_scores: Dict[str, np.ndarray],
    topk: int = 2,
    num_pred: int = 200,
) -> Dict[str, dict]:
    """preds: {vid: {'segments' (N,2), 'scores' (N,), 'labels' (N,)}} ->
    same structure with top-k external labels substituted in."""
    out = {}
    for vid, p in preds.items():
        if vid not in cls_scores:
            out[vid] = p
            continue
        cs = np.asarray(cls_scores[vid], np.float64)
        top_idx = np.argsort(cs)[::-1][:topk]
        top_score = cs[top_idx]
        segs = np.asarray(p["segments"])[:num_pred]
        scores = np.asarray(p["scores"])[:num_pred]
        n = len(scores)
        new_scores = np.sqrt(top_score[:, None] @ scores[None, :]).flatten()
        new_segs = np.tile(segs, (topk, 1))
        new_labels = np.tile(top_idx[:, None], (1, n)).flatten()
        out[vid] = {
            "segments": new_segs,
            "scores": new_scores,
            "labels": new_labels.astype(np.int64),
        }
    return out
