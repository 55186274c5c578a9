"""Detection losses (vilco_tpu/ops/losses.py): sigmoid focal and 1-D
Distance-IoU, elementwise in f32 so callers apply their own weights and
masked sums."""

from __future__ import annotations

import torch

from vilco_tpu_torch.ops.masked import wide


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25,
                       gamma: float = 2.0):
    """Elementwise focal loss (RetinaNet) with a stable BCE-with-logits."""
    logits, targets = wide(logits), wide(targets)
    p = torch.sigmoid(logits)
    ce = (torch.clamp(logits, min=0.0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * loss


def _iou_1d(input_offsets, target_offsets, eps):
    lp, rp = input_offsets[..., 0], input_offsets[..., 1]
    lg, rg = target_offsets[..., 0], target_offsets[..., 1]
    intsctk = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    unionk = (lp + rp) + (lg + rg) - intsctk
    iouk = intsctk / torch.clamp(unionk, min=eps)
    return iouk, (lp, rp, lg, rg)


def ctr_diou_loss_1d(input_offsets, target_offsets, eps: float = 1e-8):
    """1 - IoU + rho^2 / len_c^2 on (left, right) center offsets, with rho
    the center distance and len_c the enclosing length."""
    iouk, (lp, rp, lg, rg) = _iou_1d(wide(input_offsets),
                                     wide(target_offsets), eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return 1.0 - iouk + torch.square(rho) / torch.square(
        torch.clamp(len_c, min=eps))
