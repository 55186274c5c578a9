"""ANET-style detection mAP.

Pure-numpy port of MQ/libs/utils/metrics.py (ANETdetection :152-273,
compute_average_precision_detection :274-356, segment_iou :357-380,
interpolated_prec_rec :381-393) with the exact VOC-2011 interpolation and
greedy GT-locking semantics (verbatim algorithm — SURVEY.md "exact metric
parity" hard part). The CL mode mirrors load_gt_seg_from_json(use_cl=True)
(metrics.py:32-59): per-task *cumulative* ground truth with labels remapped
to a sorted per-task activity index.

A copy of vilco_tpu/evals/anet_map.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """IoU of one [s, e] segment against (N, 2) candidates (metrics.py:357)."""
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = (tt2 - tt1).clip(0)
    union = (
        (candidates[:, 1] - candidates[:, 0])
        + (target[1] - target[0])
        - inter
    )
    return inter.astype(np.float64) / union


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """VOC-2011 interpolated AP (metrics.py:381-393)."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(
    gt_videos: np.ndarray,       # (G,) video ids (any hashable)
    gt_segments: np.ndarray,     # (G, 2)
    pred_videos: np.ndarray,     # (P,)
    pred_segments: np.ndarray,   # (P, 2)
    pred_scores: np.ndarray,     # (P,)
    tiou_thresholds: np.ndarray,
) -> np.ndarray:
    """Greedy TP assignment with per-threshold GT locking
    (metrics.py:274-356)."""
    ap = np.zeros(len(tiou_thresholds))
    if len(pred_videos) == 0:
        return ap
    npos = float(len(gt_videos))

    order = np.argsort(-pred_scores, kind="stable")
    pred_videos = pred_videos[order]
    pred_segments = pred_segments[order]

    # group GT indices per video
    gt_by_vid: Dict = {}
    for i, v in enumerate(gt_videos):
        gt_by_vid.setdefault(v, []).append(i)

    T, P = len(tiou_thresholds), len(pred_videos)
    tp = np.zeros((T, P))
    fp = np.zeros((T, P))
    lock = np.full((T, len(gt_videos)), -1, dtype=np.int64)

    for idx in range(P):
        vid = pred_videos[idx]
        if vid not in gt_by_vid:
            fp[:, idx] = 1
            continue
        gidx = gt_by_vid[vid]
        tiou = segment_iou(pred_segments[idx], gt_segments[gidx])
        order_t = np.argsort(-tiou, kind="stable")
        for t, thr in enumerate(tiou_thresholds):
            assigned = False
            for j in order_t:
                if tiou[j] < thr:
                    fp[t, idx] = 1
                    assigned = True
                    break
                if lock[t, gidx[j]] >= 0:
                    continue
                tp[t, idx] = 1
                lock[t, gidx[j]] = idx
                assigned = True
                break
            if not assigned:
                fp[t, idx] = 1

    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    rec = tp_cum / npos
    prec = tp_cum / (tp_cum + fp_cum)
    for t in range(T):
        ap[t] = interpolated_prec_rec(prec[t], rec[t])
    return ap


class ANETDetection:
    """mAP evaluator over {'video-id', 't-start', 't-end', 'label'} records.

    `gt` is a dict of equal-length sequences. Labels must already be the
    evaluation label ids (the caller applies any activity-index remap).
    """

    def __init__(
        self,
        gt: Dict[str, Sequence],
        tiou_thresholds: Optional[np.ndarray] = None,
    ):
        self.tiou_thresholds = (
            np.linspace(0.1, 0.5, 5)
            if tiou_thresholds is None else np.asarray(tiou_thresholds)
        )
        self.gt_videos = np.asarray(gt["video-id"], dtype=object)
        self.gt_segments = np.stack(
            [np.asarray(gt["t-start"], np.float64),
             np.asarray(gt["t-end"], np.float64)], axis=-1,
        ) if len(gt["video-id"]) else np.zeros((0, 2))
        self.gt_labels = np.asarray(gt["label"], np.int64)
        self.labels = sorted(set(self.gt_labels.tolist()))

    def evaluate(self, preds: Dict[str, Sequence]):
        pv = np.asarray(preds["video-id"], dtype=object)
        ps = np.stack(
            [np.asarray(preds["t-start"], np.float64),
             np.asarray(preds["t-end"], np.float64)], axis=-1,
        ) if len(preds["video-id"]) else np.zeros((0, 2))
        pl = np.asarray(preds["label"], np.int64)
        sc = np.asarray(preds["score"], np.float64)

        ap = np.zeros((len(self.tiou_thresholds), len(self.labels)))
        for ci, c in enumerate(self.labels):
            g = self.gt_labels == c
            p = pl == c
            ap[:, ci] = compute_average_precision_detection(
                self.gt_videos[g], self.gt_segments[g],
                pv[p], ps[p], sc[p], self.tiou_thresholds,
            )
        mAP = ap.mean(axis=1) if len(self.labels) else np.zeros(
            len(self.tiou_thresholds)
        )
        return mAP, float(mAP.mean())


def cumulative_cl_gt(val_tasks: Dict[int, dict]) -> List[Dict]:
    """Per-task cumulative GT records with sorted-label remap, mirroring
    load_gt_seg_from_json(use_cl=True) (metrics.py:32-59).

    val_tasks: {task_idx: {'label_dict', 'dict_db'}} (the reference split-pkl
    'val' entry). Returns a list over tasks of dicts with the remapped
    records plus 'activity_index' {orig_label: eval_id}.
    """
    out = []
    vids, starts, ends, labels = [], [], [], []
    for k in sorted(val_tasks):
        sub = val_tasks[k]
        for video in sub["dict_db"]:
            for idx, label in enumerate(video["labels"]):
                vids.append(video["id"])
                starts.append(float(video["segments"][idx][0]))
                ends.append(float(video["segments"][idx][1]))
                labels.append(int(label))
        activity_index = {l: i for i, l in enumerate(sorted(set(labels)))}
        out.append({
            "video-id": list(vids),
            "t-start": list(starts),
            "t-end": list(ends),
            "label": [activity_index[l] for l in labels],
            "activity_index": activity_index,
        })
    return out
