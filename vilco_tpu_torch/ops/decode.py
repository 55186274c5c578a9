"""Decode head outputs into candidates, then NMS (vilco_tpu/ops/decode.py).

A single global top `pre_nms_topk` over the flattened (points x classes)
scores of each clip, then `batched_nms`; the batch axis is written out
where the JAX version uses `vmap`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .nms import Detections, batched_nms


class Candidates(NamedTuple):
    segs: torch.Tensor     # (B, K, 2) grid coords
    scores: torch.Tensor   # (B, K)
    labels: torch.Tensor   # (B, K) int32
    valid: torch.Tensor    # (B, K) bool


def decode_candidates(points, cls_logits, offsets, fpn_mask, class_mask,
                      pre_nms_topk: int, pre_nms_thresh: float,
                      duration_thresh: float) -> Candidates:
    """points (P, 4) [t, lo, hi, stride]; cls_logits (B, P, C);
    offsets (B, P, 2); fpn_mask (B, P); class_mask (C,)."""
    B, P, C = cls_logits.shape
    prob = torch.sigmoid(cls_logits.float())
    prob = prob * fpn_mask[..., None].float() * class_mask[None, None].float()
    flat = prob.reshape(B, -1)
    k = min(pre_nms_topk, P * C)
    # stable sort: equal scores keep index order, as jax.lax.top_k does
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    pt_idx = top_idx // C
    cls_idx = (top_idx % C).int()
    t = points[pt_idx, 0]
    stride = points[pt_idx, 3]
    off = torch.gather(offsets.float(), 1, pt_idx[..., None].expand(-1, -1, 2))
    seg_l = t - off[..., 0] * stride
    seg_r = t + off[..., 1] * stride
    segs = torch.stack([seg_l, seg_r], dim=-1)
    valid = (top_scores > pre_nms_thresh) & ((seg_r - seg_l) > duration_thresh)
    return Candidates(segs, top_scores, cls_idx, valid)


def decode_and_nms_batch(points, cls_logits, offsets, fpn_mask, class_mask,
                         *, num_classes: int, pre_nms_topk: int,
                         pre_nms_thresh: float, duration_thresh: float,
                         max_seg_num: int, min_score: float,
                         nms_sigma: float, voting_thresh: float,
                         multiclass: bool = True,
                         per_class_capacity: int | None = None,
                         use_soft_nms: bool = True,
                         iou_threshold: float = 0.1) -> Detections:
    """Batched decode + NMS (soft with `use_soft_nms`, else hard at
    `iou_threshold`), the eval-path postprocessor."""
    cand = decode_candidates(points, cls_logits, offsets, fpn_mask,
                             class_mask, pre_nms_topk, pre_nms_thresh,
                             duration_thresh)
    return batched_nms(
        cand.segs, cand.scores, cand.labels, cand.valid,
        num_classes=num_classes, max_seg_num=max_seg_num,
        min_score=min_score, nms_sigma=nms_sigma,
        voting_thresh=voting_thresh, multiclass=multiclass,
        per_class_capacity=per_class_capacity,
        use_soft_nms=use_soft_nms, iou_threshold=iou_threshold,
    )
