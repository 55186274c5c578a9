"""2-D anchors, IoU, label assignment and GIoU for the VQ tracker
(vilco_tpu/ops/anchors.py).

Anchors are [cy, cx, h, w]: 4 base sizes x 3 aspect ratios = 12 per cell of
an R x R grid. Boxes elsewhere are xyxy as the JAX functions name them
([y1, x1, y2, x2] for the anchors, in the same order as the GT boxes).
"""

from __future__ import annotations

import numpy as np
import torch

BASE_SIZES = np.array([[16, 16], [32, 32], [64, 64], [128, 128]], np.float32)
ASPECT_RATIOS = np.array([0.5, 1.0, 2.0], np.float32)


def generate_anchors(image_size: int, num_regions: int,
                     base_sizes: np.ndarray = BASE_SIZES,
                     aspect_ratios: np.ndarray = ASPECT_RATIOS) -> np.ndarray:
    """(R*R*N*M, 4) anchors as [cy, cx, h, w] in pixels, f32."""
    n, m = len(base_sizes), len(aspect_ratios)
    base = np.zeros((n * m, 4), np.float32)
    for i in range(n):
        for j in range(m):
            w = np.sqrt(base_sizes[i, 0] * base_sizes[i, 1] / aspect_ratios[j])
            base[i * m + j] = [0.0, 0.0, aspect_ratios[j] * w, w]
    region = image_size / num_regions
    out = []
    for i in range(num_regions):
        for j in range(num_regions):
            b = base.copy()
            b[:, 0] += (i + 0.5) * region
            b[:, 1] += (j + 0.5) * region
            out.append(b)
    return np.concatenate(out, axis=0)


def xyhw_to_xyxy(boxes):
    """[cy, cx, h, w] -> [y1, x1, y2, x2] (h, w the full extent); numpy in,
    numpy out, tensor in, tensor out."""
    c, hw = boxes[..., :2], boxes[..., 2:] * 0.5
    if isinstance(boxes, torch.Tensor):
        return torch.cat([c - hw, c + hw], dim=-1)
    return np.concatenate([c - hw, c + hw], axis=-1)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) xyxy boxes against (..., 4) single boxes ->
    (..., N)."""
    b2 = boxes2[..., None, :]
    tl = torch.maximum(boxes1[..., :2], b2[..., :2])
    br = torch.minimum(boxes1[..., 2:], b2[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def assign_anchor_labels(anchors_xyxy: torch.Tensor, gt_boxes: torch.Tensor,
                         iou_threshold: float = 0.5,
                         topk: int = 5) -> torch.Tensor:
    """(B, T, N) bool positives: IoU above the threshold; if no anchor
    anywhere passes, the top-k IoU anchors over the flattened (B, T, N)
    instead. Ties in that top-k may break otherwise than in JAX."""
    iou = box_iou(anchors_xyxy[None, None], gt_boxes)      # (B, T, N)
    labels = iou > iou_threshold
    flat = iou.reshape(-1)
    top = torch.topk(flat, min(topk, flat.numel())).indices
    fallback = torch.zeros_like(flat, dtype=torch.bool)
    fallback[top] = True
    return torch.where(labels.any(), labels, fallback.reshape(labels.shape))


def giou(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-9):
    """Generalized IoU of matching (..., 4) xyxy boxes -> (iou, giou); the
    predicted corners are put in order per axis first."""
    x1 = torch.minimum(pred[..., 0], pred[..., 2])
    x2 = torch.maximum(pred[..., 0], pred[..., 2])
    y1 = torch.minimum(pred[..., 1], pred[..., 3])
    y2 = torch.maximum(pred[..., 1], pred[..., 3])
    pred = torch.stack([x1, y1, x2, y2], dim=-1)
    tl = torch.maximum(pred[..., :2], gt[..., :2])
    br = torch.minimum(pred[..., 2:], gt[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (torch.clamp(pred[..., 2] - pred[..., 0], min=0)
          * torch.clamp(pred[..., 3] - pred[..., 1], min=0))
    a2 = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    union = a1 + a2 - inter
    iou = inter / torch.clamp(union, min=eps)
    etl = torch.minimum(pred[..., :2], gt[..., :2])
    ebr = torch.maximum(pred[..., 2:], gt[..., 2:])
    ewh = torch.clamp(ebr - etl, min=0.0)
    earea = ewh[..., 0] * ewh[..., 1]
    return iou, iou - (earea - union) / torch.clamp(earea, min=eps)
