"""VQ serving: sliding-window inference over one clip
(vilco_tpu/tasks/vq.py::VQEpisodeRunner.predict_track) as a function of the
model and the frames. The model is `ClipMatcher(cfg)` (the JAX
`build_clip_matcher` maps a VQCfg onto the model's fields; the port's model
takes the config itself).

The clip is cut into windows of `window` frames (the last start pulled
back to T - window, the frame indices clipped to the clip), the windows run
through the eval step in chunks of eval_windows (a power of two no larger
than the window count, the tail chunk padded by repeating its last
window), each frame keeps the box of its best-scoring window (strictly
greater replaces), the boxes go to pixels, and peak finding on the score
curve gives the response track.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from vilco_tpu_torch.evals.vq_metrics import (
    ResponseTrack,
    predictions_to_response_track,
)
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.train.vq_engine import make_vq_eval_step


def window_chunks(T: int, window: int, eval_windows: int):
    """(window frame indices (n, window), chunk size) of a T-frame clip."""
    starts = [max(min(s, T - window), 0) for s in range(0, T, window)]
    idx = np.stack([np.minimum(np.arange(s, s + window), T - 1)
                    for s in starts])
    n = len(starts)
    return idx, max(min(eval_windows, 1 << (n - 1).bit_length()), 1)


def predict_track(model: ClipMatcher, frames: torch.Tensor,
                  query: torch.Tensor, query_frame: int,
                  window: Optional[int] = None,
                  eval_windows: Optional[int] = None,
                  marks: Optional[List] = None) -> ResponseTrack:
    """frames (T, H, W, 3) and query (H, W, 3) on the model's device ->
    the response track. window and eval_windows default to the model
    config's num_frames and eval_windows. `marks`, if a list, receives the
    eval step's ViT / matcher / top-anchor boundaries of each chunk and
    ("peaks_ms", host ms of the merge and the peak finding)."""
    cfg = model.cfg
    window = window or cfg.num_frames
    eval_windows = eval_windows or cfg.eval_windows
    T = frames.shape[0]
    idx, chunk = window_chunks(T, window, eval_windows)
    step = make_vq_eval_step(model)
    queries = query[None].repeat(chunk, 1, 1, 1)
    outs = []
    for c0 in range(0, len(idx), chunk):
        sel = idx[c0:c0 + chunk]
        pad = np.repeat(sel[-1:], chunk - len(sel), axis=0)
        take = torch.from_numpy(np.concatenate([sel, pad])).to(frames.device)
        bbox, prob = step(frames[take], queries, marks)
        outs.append((sel, bbox[:len(sel)].cpu().numpy(),
                     prob[:len(sel)].cpu().numpy()))
    t0 = time.perf_counter()
    scores = np.zeros((T,), np.float64)
    boxes = np.zeros((T, 4), np.float64)
    counts = np.zeros((T,), np.int64)
    for sel, bbox_b, prob_b in outs:
        for bi, frames_of in enumerate(sel):
            for i, f in enumerate(frames_of):
                if counts[f] == 0 or prob_b[bi, i] > scores[f]:
                    scores[f] = prob_b[bi, i]
                    boxes[f] = bbox_b[bi, i]
                counts[f] += 1
    track = predictions_to_response_track(scores, boxes * cfg.clip_size,
                                          query_frame)
    if marks is not None:
        marks.append(("peaks_ms", (time.perf_counter() - t0) * 1e3))
    return track
