"""Generic temporal-action-localization dataset adapter.

The reference registers four extra TAL datasets inherited from ActionFormer
— thumos14, anet (ActivityNet-1.3), charades, multithumos
(MQ/libs/datasets/{thumos14,anet,charades,multithumos}.py) — all parsing
the same ActivityNet-family schema:

    {"database": {video_id: {"subset": ..., "fps": ..., "duration": ...,
                             "annotations": [{"label", "label_id",
                                              "segment": [s, e]}, ...]}}}

No ViLCo config uses them, but they ship in the repo, so one generic
adapter covers all four here: it emits the video-dict records that
`ClipDataset` (data/pipeline.py) consumes, paired with any feature source
(e.g. `DirFeatureSource`). Per-dataset evaluation attributes (tIoU
thresholds, thumos14.py:69-73 etc.) are carried alongside so `anet_map`
scores each benchmark on its official grid.

Use with the joint (non-CL) trainer: build records here, wrap in
ClipDataset + BatchIterator, run EpisodeRunner in joint mode.

A copy of vilco_tpu/tasks/tal.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vilco_tpu_torch.core.registry import DATASETS

# official evaluation grids (MQ/libs/datasets/*.py db_attributes)
TAL_ATTRIBUTES: Dict[str, dict] = {
    "thumos": {"tiou_thresholds": np.linspace(0.3, 0.7, 5),
               "empty_label_ids": []},
    "anet": {"tiou_thresholds": np.linspace(0.5, 0.95, 10),
             "empty_label_ids": []},
    "charades": {"tiou_thresholds": np.linspace(0.1, 0.9, 9),
                 "empty_label_ids": []},
    "multithumos": {"tiou_thresholds": np.linspace(0.1, 0.9, 9),
                    "empty_label_ids": []},
}


def remove_duplicate_annotations(ants: Sequence[dict],
                                 tol: float = 1e-3) -> List[dict]:
    """Drop events duplicated in (label_id, start, end) within `tol`
    (MQ/libs/utils/metrics.py:14-29 — the thumos cliff-diving quirk)."""
    valid: List[dict] = []
    for event in ants:
        s, e = event["segment"][0], event["segment"][1]
        lid = event["label_id"]
        if not any(abs(s - p["segment"][0]) <= tol
                   and abs(e - p["segment"][1]) <= tol
                   and lid == p["label_id"] for p in valid):
            valid.append(event)
    return valid


def build_label_dict(database: dict) -> Dict[str, int]:
    """label name -> id from the annotations themselves
    (thumos14.py _load_json_db)."""
    out: Dict[str, int] = {}
    for value in database.values():
        for act in value.get("annotations", []):
            out[act["label"]] = int(act["label_id"])
    return out


def load_tal_database(
    json_file: str,
    splits: Sequence[str],
    *,
    default_fps: Optional[float] = None,
    label_dict: Optional[Dict[str, int]] = None,
    num_classes: Optional[int] = None,
    dedup: bool = True,
    feat_folder: Optional[str] = None,
    file_prefix: str = "",
    file_ext: str = ".npy",
) -> Tuple[List[dict], Dict[str, int]]:
    """ActivityNet-family JSON -> (video dicts, label_dict).

    Mirrors the shared `_load_json_db` shape of the four reference loaders:
    filter by subset, optionally by feature-file existence, resolve fps,
    dedup annotations, map labels (single-class datasets collapse to 0).
    """
    with open(json_file) as f:
        database = json.load(f)["database"]
    if label_dict is None:
        label_dict = build_label_dict(database)
    splits = tuple(s.lower() for s in splits)

    videos: List[dict] = []
    for key, value in database.items():
        if value.get("subset", "").lower() not in splits:
            continue
        if feat_folder is not None and not os.path.exists(
                os.path.join(feat_folder, file_prefix + key + file_ext)):
            continue
        fps = default_fps if default_fps is not None else value.get("fps")
        if fps is None:
            raise ValueError(f"unknown fps for video {key}")
        duration = float(value.get("duration", 1e8))
        ants = value.get("annotations", [])
        if dedup:
            ants = remove_duplicate_annotations(ants)
        segments = np.asarray([a["segment"] for a in ants],
                              np.float32).reshape(-1, 2)
        if num_classes == 1:
            labels = np.zeros((len(ants),), np.int64)
        else:
            labels = np.asarray([label_dict[a["label"]] for a in ants],
                                np.int64)
        videos.append({
            "id": key,
            "fps": float(fps),
            "duration": duration,
            "segments": segments,
            "labels": labels,
        })
    return videos, label_dict


def _make_tal(name: str, train_splits, val_splits):
    def factory(json_file: str, split: str = "train", **kw):
        # accept both our split word and the schema's subset literal
        # ("train"/"training" etc.)
        splits = (train_splits if split.lower().startswith("train")
                  else val_splits)
        videos, label_dict = load_tal_database(json_file, splits, **kw)
        return {"videos": videos, "label_dict": label_dict,
                "attributes": TAL_ATTRIBUTES[name]}

    factory.__name__ = f"{name}_dataset"
    return DATASETS.register(name)(factory)


# the reference registers these by the same names (datasets.py register_dataset)
thumos_dataset = _make_tal("thumos", ("training",), ("validation", "test"))
anet_dataset = _make_tal("anet", ("training",), ("validation",))
charades_dataset = _make_tal("charades", ("training",), ("validation", "testing"))
multithumos_dataset = _make_tal("multithumos", ("training", "validation"),
                                ("test",))
