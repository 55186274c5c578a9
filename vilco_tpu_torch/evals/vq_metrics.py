"""VQ (visual query) metrics (a copy of vilco_tpu/evals/vq_metrics.py, which
imports nothing of JAX): temporal AP, spatio-temporal AP, success,
tracking recovery — plus the response-track structures and the score-curve
peak-finding that turns per-frame predictions into tracks.

Pure-numpy ports of the reference VQ metric stack:
  - BBox / ResponseTrack          VQ/evaluation/structures.py:4-105
  - segment_iou (+1 convention), spatio-temporal (tube) IoU
                                  VQ/metrics/utils.py:11-125
  - TemporalDetection             VQ/metrics/temporal_metrics.py (AP over
                                  tIoU {0.25, 0.5, 0.75, 0.95})
  - SpatioTemporalDetection       VQ/metrics/spatio_temporal_metrics.py
  - SuccessMetrics                VQ/metrics/success_metrics.py (take max
                                  score; IoU {0.05, 0.1, 0.2})
  - TrackingMetrics (% recovery)  VQ/metrics/tracking_metrics.py (IoU
                                  {0.5, 0.75, 0.95})
  - compute_visual_query_metrics  VQ/metrics/metrics.py:21-110
  - peak finding + track assembly VQ/evaluation/task_inference_results.py
                                  :29-150 (medfilt k=5, peak-score 0.8,
                                  peak-window 0.7)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import find_peaks, medfilt

SMOOTHING_KERNEL = 5
PEAK_SCORE_THRESHOLD = 0.8
PEAK_WINDOW_THRESHOLD = 0.7


@dataclass
class BBox:
    fno: int
    x1: float
    y1: float
    x2: float
    y2: float

    def area(self) -> float:
        return abs(self.x2 - self.x1) * abs(self.y2 - self.y1)


@dataclass
class ResponseTrack:
    bboxes: List[BBox]
    score: Optional[float] = None

    @property
    def temporal_extent(self) -> Tuple[int, int]:
        fnos = [b.fno for b in self.bboxes]
        return (min(fnos), max(fnos))

    @property
    def length(self) -> int:
        return len(self.bboxes)

    def volume(self) -> float:
        return float(sum(b.area() for b in self.bboxes))

    def has_score(self) -> bool:
        return self.score is not None


def segment_iou_inclusive(target: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """Frame-inclusive tIoU (+1 lengths), metrics/utils.py:11-40."""
    tt1 = np.maximum(target[0], cands[:, 0])
    tt2 = np.minimum(target[1], cands[:, 1])
    inter = (tt2 - tt1 + 1).clip(0)
    union = (
        (cands[:, 1] - cands[:, 0] + 1)
        + (target[1] - target[0] + 1)
        - inter
    )
    return inter.astype(float) / union


def spatial_iou(b1: BBox, b2: BBox) -> float:
    xi = min(b1.x2, b2.x2) - max(b1.x1, b2.x1)
    yi = min(b1.y2, b2.y2) - max(b1.y1, b2.y1)
    inter = max(xi, 0.0) * max(yi, 0.0)
    u = b1.area() + b2.area() - inter
    return inter / u if u > 0 else 0.0


def spatio_temporal_iou(rt1: ResponseTrack, rt2: ResponseTrack) -> float:
    """Tube IoU: per-frame intersections / (vol1 + vol2 - inter)
    (metrics/utils.py:86-110)."""
    boxes1 = {b.fno: b for b in rt1.bboxes}
    inter = 0.0
    for b2 in rt2.bboxes:
        b1 = boxes1.get(b2.fno)
        if b1 is None:
            continue
        xi = min(b1.x2, b2.x2) - max(b1.x1, b2.x1)
        yi = min(b1.y2, b2.y2) - max(b1.y1, b2.y1)
        inter += max(xi, 0.0) * max(yi, 0.0)
    u = rt1.volume() + rt2.volume() - inter
    return inter / u if u > 0 else 0.0


def per_frame_iou_matches(pred: ResponseTrack, gt: ResponseTrack
                          ) -> Dict[int, float]:
    """Per-GT-frame IoU with the prediction, 0 when unmatched
    (spatial_matches_response_track, metrics/utils.py:128-148)."""
    gt_dict = {b.fno: b for b in gt.bboxes}
    ious = {b.fno: 0.0 for b in gt.bboxes}
    for pb in pred.bboxes:
        gb = gt_dict.get(pb.fno)
        if gb is not None:
            ious[gb.fno] = spatial_iou(gb, pb)
    return ious


def _interp_ap(prec, rec):
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def _detection_ap(n_queries: int, pred_q: np.ndarray, scores: np.ndarray,
                  iou_fn, thresholds: np.ndarray) -> np.ndarray:
    """Shared greedy-AP machinery: one GT per query, predictions scored by
    `iou_fn(pred_idx)` vs their query's GT."""
    ap = np.zeros(len(thresholds))
    P = len(pred_q)
    if P == 0:
        return ap
    order = np.argsort(-scores, kind="stable")
    tp = np.zeros((len(thresholds), P))
    fp = np.zeros((len(thresholds), P))
    lock = np.full((len(thresholds), n_queries), -1)
    for rank, idx in enumerate(order):
        q = pred_q[idx]
        iou = iou_fn(idx)
        for t, thr in enumerate(thresholds):
            if iou < thr or lock[t, q] >= 0:
                fp[t, rank] = 1
            else:
                tp[t, rank] = 1
                lock[t, q] = idx
    tp_c = np.cumsum(tp, axis=1)
    fp_c = np.cumsum(fp, axis=1)
    rec = tp_c / n_queries
    prec = tp_c / (tp_c + fp_c)
    for t in range(len(thresholds)):
        ap[t] = _interp_ap(prec[t], rec[t])
    return ap


def temporal_ap(gt: List[ResponseTrack], preds: List[List[ResponseTrack]],
                thresholds=np.array([0.25, 0.5, 0.75, 0.95])):
    gt_ext = np.array([g.temporal_extent for g in gt], float)
    pred_q, pred_ext, scores = [], [], []
    for q, plist in enumerate(preds):
        for p in plist:
            pred_q.append(q)
            pred_ext.append(p.temporal_extent)
            scores.append(p.score)
    pred_q = np.array(pred_q, int)
    pred_ext = np.array(pred_ext, float).reshape(-1, 2)
    scores = np.array(scores, float)

    def iou_fn(i):
        return segment_iou_inclusive(pred_ext[i],
                                     gt_ext[pred_q[i]][None])[0]

    return _detection_ap(len(gt), pred_q, scores, iou_fn, thresholds)


def spatio_temporal_ap(gt, preds,
                       thresholds=np.array([0.25, 0.5, 0.75, 0.95])):
    pred_q, flat, scores = [], [], []
    for q, plist in enumerate(preds):
        for p in plist:
            pred_q.append(q)
            flat.append(p)
            scores.append(p.score)
    pred_q = np.array(pred_q, int)
    scores = np.array(scores, float)

    def iou_fn(i):
        return spatio_temporal_iou(flat[i], gt[pred_q[i]])

    return _detection_ap(len(gt), pred_q, scores, iou_fn, thresholds)


def success_and_recovery(
    gt: List[ResponseTrack], preds: List[List[ResponseTrack]],
    success_thresholds=np.array([0.05, 0.1, 0.2]),
    recovery_thresholds=np.array([0.5, 0.75, 0.95]),
):
    """Success % (max-score prediction's tube IoU above threshold) and
    tracking % recovery (fraction of GT frames whose per-frame IoU with the
    max-score prediction passes threshold), compute_success /
    compute_tracking_metrics."""
    succ = np.zeros(len(success_thresholds))
    acc = np.zeros(len(recovery_thresholds))
    total = np.zeros(len(recovery_thresholds))
    n = 0
    for q, plist in enumerate(preds):
        if not plist:
            total += gt[q].length
            n += 1
            continue
        best = max(plist, key=lambda p: p.score)
        st = spatio_temporal_iou(best, gt[q])
        succ += (st >= success_thresholds).astype(float)
        frame_ious = np.array(
            list(per_frame_iou_matches(best, gt[q]).values())
        )
        for t, thr in enumerate(recovery_thresholds):
            acc[t] += np.count_nonzero(frame_ious >= thr)
            total[t] += gt[q].length
        n += 1
    success = succ / max(n, 1) * 100.0
    recovery = np.where(total > 0, 100.0 * acc / np.maximum(total, 1), 0.0)
    return success, recovery


def compute_visual_query_metrics(
    predicted: List[List[ResponseTrack]],
    ground_truth: List[ResponseTrack],
    accessed_frames: List[int] | None = None,
    total_frames: List[int] | None = None,
) -> Dict[str, float]:
    """Headline VQ metrics (compute_visual_query_metrics,
    VQ/metrics/metrics.py:21-110, 'all' pairing). When per-query
    accessed/total frame counts are given, also reports search efficiency
    (= mean(1 - accessed/total) * 100, metrics.py:100-102; 0 for the
    exhaustive sliding-window runner)."""
    t_ap = temporal_ap(ground_truth, predicted)
    st_ap = spatio_temporal_ap(ground_truth, predicted)
    success, recovery = success_and_recovery(ground_truth, predicted)
    out = {
        "tAP": float(t_ap.mean()),
        "tAP@0.25": float(t_ap[0]),
        "stAP": float(st_ap.mean()),
        "stAP@0.25": float(st_ap[0]),
        "Success": float(success[0]),
        "recovery%": float(recovery[0]),
    }
    if accessed_frames is not None and len(accessed_frames):
        eff = 1.0 - (np.asarray(accessed_frames, np.float32)
                     / np.asarray(total_frames, np.float32))
        out["search_eff%"] = float(eff.mean() * 100.0)
    return out


# area pairing tables (metrics.py:27-35)
AREA_RANGES = {
    "all": (0.0**2, 1e5**2),
    "small": (0.0**2, 64.0**2),
    "medium": (64.0**2, 192.0**2),
    "large": (192.0**2, 1e5**2),
}
VC_RT_PAIRINGS = {"all": ("all", "large")}


def compute_visual_query_metrics_paired(
    predicted: List[List[ResponseTrack]],
    ground_truth: List[ResponseTrack],
    visual_crop_boxes: List[BBox],
    accessed_frames: List[int] | None = None,
    total_frames: List[int] | None = None,
    area_ranges: Dict[str, tuple] = AREA_RANGES,
    vc_rt_pairings: Dict[str, tuple] = VC_RT_PAIRINGS,
) -> Dict[str, Dict[str, float]]:
    """Full pairing semantics of the reference aggregator
    (metrics.py:47-105): each (visual-crop area, GT max-box area) pairing
    selects the queries whose crop area falls in the first range and whose
    GT response-track MAX bbox area falls in the second; pairings with no
    queries are omitted."""
    vc_areas = np.array([b.area() for b in visual_crop_boxes])
    rt_areas = np.array(
        [max(bb.area() for bb in rt.bboxes) for rt in ground_truth]
    )
    out: Dict[str, Dict[str, float]] = {}
    for name, (vc_cat, rt_cat) in vc_rt_pairings.items():
        vlo, vhi = area_ranges[vc_cat]
        rlo, rhi = area_ranges[rt_cat]
        mask = ((vc_areas >= vlo) & (vc_areas < vhi)
                & (rt_areas >= rlo) & (rt_areas < rhi))
        if not mask.any():
            continue
        idx = np.flatnonzero(mask)
        out[name] = compute_visual_query_metrics(
            [predicted[i] for i in idx],
            [ground_truth[i] for i in idx],
            None if accessed_frames is None
            else [accessed_frames[i] for i in idx],
            None if total_frames is None
            else [total_frames[i] for i in idx],
        )
    return out


def predictions_to_response_track(
    scores: np.ndarray,      # (T,) per-frame occupancy probabilities
    bboxes: np.ndarray,      # (T, 4) per-frame top bbox (x1, y1, x2, y2)
    query_frame: int,
) -> ResponseTrack:
    """Score-curve smoothing + peak finding + window growing
    (task_inference_results.py:66-150)."""
    sm = medfilt(scores.astype(np.float64), kernel_size=SMOOTHING_KERNEL)
    peaks, _ = find_peaks(sm)
    num_frames = len(sm)

    if len(peaks) == 0:
        valid = [0] if sm[0] > sm[-1] else [num_frames - 1]
    else:
        peak_scores = sm[peaks]
        thr = peak_scores.max() * PEAK_SCORE_THRESHOLD
        valid = peaks[np.where(peak_scores > thr)[0]]

    recent_peak = None
    for p in list(valid)[::-1]:
        recent_peak = int(p)
        break

    if recent_peak is not None:
        thr = sm[recent_peak] * PEAK_WINDOW_THRESHOLD
        latest_idx = [recent_peak]
        for idx in range(recent_peak, 0, -1):
            if sm[idx] >= thr:
                latest_idx.append(idx)
            else:
                break
        for idx in range(recent_peak, max(query_frame - 1, 0)):
            if sm[idx] >= thr:
                latest_idx.append(idx)
            else:
                break
    else:
        latest_idx = [max(query_frame - 2, 0)]

    latest_idx = sorted(set(int(i) for i in latest_idx))
    boxes = [
        BBox(i, float(bboxes[i, 0]), float(bboxes[i, 1]),
             float(bboxes[i, 2]), float(bboxes[i, 3]))
        for i in latest_idx
    ]
    return ResponseTrack(boxes, score=1.0)
