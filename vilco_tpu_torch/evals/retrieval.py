"""Moment-retrieval R@k x tIoU and NLQ ReferringRecall.

Pure-numpy ports of:
  - Moment_Retrieval  MQ/libs/utils/get_retrieval_performance.py:7-185
    (per-video, per-class-name recall where R@k uses the first k*num_gt
    predictions in stored order — the reference's exact quirk)
  - ReferringRecall   NLQ/libs/utils/metrics.py:9-176
    (R@{1,5,10} @ tIoU {0.3,0.5} keyed by (clip_uid, annotation_uid,
    query_idx); note the reference's *union-span* IoU denominator)

A copy of vilco_tpu/evals/retrieval.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def span_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The reference's IoU: union = max(e) - min(s) (the enclosing span, not
    the set union) — get_retrieval_performance.py:167-185."""
    inter_l = np.maximum(pred[:, 0, None], gt[None, :, 0])
    inter_r = np.minimum(pred[:, 1, None], gt[None, :, 1])
    inter = np.maximum(0.0, inter_r - inter_l)
    union_l = np.minimum(pred[:, 0, None], gt[None, :, 0])
    union_r = np.maximum(pred[:, 1, None], gt[None, :, 1])
    union = np.maximum(0.0, union_r - union_l)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def moment_retrieval_recall(
    gt_by_video: Dict[str, Dict[str, List[List[float]]]],
    pred_by_video: Dict[str, Dict[str, List[List[float]]]],
    tious: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
    recalls: Sequence[int] = (1, 5),
) -> np.ndarray:
    """Returns (len(tious), len(recalls)) recall matrix.

    Matches Moment_Retrieval.evaluate (get_retrieval_performance.py:119-165):
    for every GT instance of (video, class-name), it is retrieved at (t, r)
    if any of the first r*num_gt predictions of that class overlaps > t.
    Missing videos/classes count as misses.
    """
    eval_result = [[[] for _ in recalls] for _ in tious]
    for vid, gt_classes in gt_by_video.items():
        preds_v = pred_by_video.get(vid, {})
        for cname, gt_list in gt_classes.items():
            num_gt = len(gt_list)
            if cname in preds_v and len(preds_v[cname]):
                pred = np.asarray(
                    [p[:2] for p in preds_v[cname]], np.float64
                )
                gt = np.asarray(gt_list, np.float64)
                overlap = span_iou_matrix(pred, gt)
                for i, t in enumerate(tious):
                    hit = overlap > t
                    for j, r in enumerate(recalls):
                        top = hit[: r * num_gt]
                        eval_result[i][j].extend(
                            bool(top[:, g].any()) for g in range(num_gt)
                        )
            else:
                for i in range(len(tious)):
                    for j in range(len(recalls)):
                        eval_result[i][j].extend([False] * num_gt)
    if not eval_result[0][0]:
        return np.zeros((len(tious), len(recalls)))
    return np.array(eval_result, dtype=float).mean(axis=-1)


def retrieval_gt_from_task(task: dict) -> Dict[str, Dict[str, list]]:
    """{video_id: {class_name: [[s, e], ...]}} for ONE task (the reference
    evaluates retrieval per-task, get_retrieval_performance.py:47-70)."""
    inv = {v: k for k, v in task["label_dict"].items()}
    gt = {}
    for video in task["dict_db"]:
        ann = {}
        for idx, label in enumerate(video["labels"]):
            name = inv.get(int(label))
            if name is None:
                continue
            ann.setdefault(name, []).append(
                [float(video["segments"][idx][0]),
                 float(video["segments"][idx][1])]
            )
        if ann:
            gt[video["id"]] = ann
    return gt


class ReferringRecall:
    """NLQ recall (metrics.py:9-176). Predictions: list of dicts with keys
    query_key (any hashable id) and predicted_times (list of [s, e] in rank
    order); GT: {query_key: [s, e]}."""

    thresholds = np.array([0.3, 0.5])
    top_k = np.array([1, 5, 10])

    def __init__(self, gt: Dict):
        self.gt = gt

    def evaluate(self, predictions: List[dict]) -> np.ndarray:
        results = [[[] for _ in self.top_k] for _ in self.thresholds]
        for pred in predictions:
            gt_win = np.asarray([self.gt[pred["query_key"]]], np.float64)
            times = np.asarray(pred["predicted_times"], np.float64)
            if times.size == 0:
                overlap = np.zeros((1,))
            else:
                overlap = span_iou_matrix(times[:, :2], gt_win)[:, 0]
            for tt, thr in enumerate(self.thresholds):
                for rr, k in enumerate(self.top_k):
                    results[tt][rr].append(bool((overlap > thr)[:k].any()))
        if not results[0][0]:
            return np.zeros((len(self.thresholds), len(self.top_k)))
        return np.array(results, np.float64).mean(axis=-1)


class BwfTracker:
    """Backward-forgetting accumulator (final_validate,
    MQ/libs/utils/train_utils.py:1320-1336): record a task's metric when it
    is first trained; BwF after task T = weighted mean over prior tasks of
    (recorded_i - current_i)."""

    def __init__(self):
        self.recorded: Dict[int, float] = {}

    def update(self, current_task: int, per_task_values: Dict[int, float],
               weights: Dict[int, float] | None = None) -> float:
        total, wsum = 0.0, 0.0
        for t, v in per_task_values.items():
            if t == current_task:
                self.recorded[t] = v
            elif t < current_task and t in self.recorded:
                w = (weights or {}).get(t, 1.0)
                total += (self.recorded[t] - v) * w
                wsum += w
        return total / wsum if wsum > 0 else 0.0
