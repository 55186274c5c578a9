"""Response tracks from per-frame VQ predictions: the structures and the
score-curve peak finding of vilco_tpu/evals/vq_metrics.py (BBox,
ResponseTrack, predictions_to_response_track), copied so that the port
needs nothing of the JAX package. Median filter of 5, peaks above 0.8 of
the best, the track grown while the smoothed score stays above 0.7 of its
peak.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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


def predictions_to_response_track(scores: np.ndarray, bboxes: np.ndarray,
                                  query_frame: int) -> ResponseTrack:
    """scores (T,) per-frame occupancy probabilities, bboxes (T, 4) the
    per-frame top box: smooth, find the most recent strong peak, grow the
    track around it."""
    sm = medfilt(scores.astype(np.float64), kernel_size=SMOOTHING_KERNEL)
    peaks, _ = find_peaks(sm)
    num_frames = len(sm)
    if len(peaks) == 0:
        valid = [0] if sm[0] > sm[-1] else [num_frames - 1]
    else:
        peak_scores = sm[peaks]
        thr = peak_scores.max() * PEAK_SCORE_THRESHOLD
        valid = peaks[np.where(peak_scores > thr)[0]]
    recent_peak = int(list(valid)[-1]) if len(valid) else None
    if recent_peak is not None:
        thr = sm[recent_peak] * PEAK_WINDOW_THRESHOLD
        latest_idx = [recent_peak]
        for idx in range(recent_peak, 0, -1):
            if sm[idx] < thr:
                break
            latest_idx.append(idx)
        for idx in range(recent_peak, max(query_frame - 1, 0)):
            if sm[idx] < thr:
                break
            latest_idx.append(idx)
    else:
        latest_idx = [max(query_frame - 2, 0)]
    latest_idx = sorted(set(int(i) for i in latest_idx))
    boxes = [BBox(i, float(bboxes[i, 0]), float(bboxes[i, 1]),
                  float(bboxes[i, 2]), float(bboxes[i, 3]))
             for i in latest_idx]
    return ResponseTrack(boxes, score=1.0)
