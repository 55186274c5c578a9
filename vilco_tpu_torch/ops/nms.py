"""1-D soft- and hard NMS, segment voting and multiclass NMS
(vilco_tpu/ops/nms.py).

Plain torch, batched: every function takes a leading batch axis that the
JAX version gets from `vmap`. The greedy pick loop (`lax.fori_loop` there)
is a Python loop of `max_out` picks, each a few vector ops over all rows at
once. Ties break as in JAX: `argmax` takes the first maximum and the sorts
are stable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e9


def _iou_1d(seg, segs, eps: float = 1e-6):
    """IoU of one segment per row (N, 2) against that row's (N, M, 2)."""
    l, r = seg[:, 0:1], seg[:, 1:2]
    area = r - l + eps
    areas = segs[..., 1] - segs[..., 0] + eps
    inter = torch.clamp(torch.minimum(r, segs[..., 1])
                        - torch.maximum(l, segs[..., 0]), min=0.0)
    return inter / (area + areas - inter)


class NMSResult(NamedTuple):
    segs: torch.Tensor     # (..., K, 2)
    scores: torch.Tensor   # (..., K)
    valid: torch.Tensor    # (..., K) bool


def soft_nms_1d(segs, scores, valid, max_out: int, sigma: float = 0.75,
                min_score: float = 0.001, method: str = "gaussian",
                iou_threshold: float = 0.1) -> NMSResult:
    """Greedy NMS over the last axis of (..., M) candidates: pick the
    highest remaining score, then with `method` "gaussian" decay the rest
    by exp(-iou^2/sigma) and drop survivors below `min_score` (picked
    segments report their decayed-at-pick score); with "hard" drop the
    rest at IoU >= `iou_threshold`, keeping their scores, from candidates
    whose score exceeds `min_score`."""
    if method not in ("gaussian", "hard"):
        raise ValueError(f"method {method!r}: 'gaussian' or 'hard'")
    hard = method == "hard"
    lead = scores.shape[:-1]
    M = scores.shape[-1]
    segs = segs.reshape(-1, M, 2).float()
    cur = scores.reshape(-1, M).float()
    valid = valid.reshape(-1, M)
    N = cur.shape[0]
    rows = torch.arange(N, device=cur.device)
    alive = valid & (cur > min_score if hard else cur > 0)
    out_segs = torch.zeros((N, max_out, 2), device=cur.device)
    out_scores = torch.zeros((N, max_out), device=cur.device)
    out_valid = torch.zeros((N, max_out), dtype=torch.bool,
                            device=cur.device)
    for k in range(max_out):
        masked = torch.where(alive, cur, NEG)
        i = torch.argmax(masked, dim=-1)
        s = masked[rows, i]
        any_alive = s > NEG / 2
        seg_i = segs[rows, i]
        iou = _iou_1d(seg_i, segs)
        if hard:
            new_scores = cur
            new_alive = alive & (iou < iou_threshold)
        else:
            w = torch.exp(-torch.square(iou) / sigma)
            new_scores = torch.where(alive, cur * w, cur)
            new_alive = alive & (new_scores >= min_score)
        new_alive[rows, i] = False
        keep = any_alive[:, None]
        cur = torch.where(keep, new_scores, cur)
        alive = torch.where(keep, new_alive, alive)
        out_segs[:, k] = torch.where(keep, seg_i, 0.0)
        out_scores[:, k] = torch.where(any_alive, s, 0.0)
        out_valid[:, k] = any_alive
    return NMSResult(out_segs.reshape(*lead, max_out, 2),
                     out_scores.reshape(*lead, max_out),
                     out_valid.reshape(*lead, max_out))


def seg_voting(nms_segs, all_segs, all_scores, all_valid,
               iou_threshold: float):
    """Bounding-segment voting over a batch: nms_segs (B, K, 2),
    all_segs (B, M, 2), all_scores/all_valid (B, M)."""
    l = torch.maximum(nms_segs[:, :, None, 0], all_segs[:, None, :, 0])
    r = torch.minimum(nms_segs[:, :, None, 1], all_segs[:, None, :, 1])
    inter = torch.clamp(r - l, min=0.0)
    len_n = nms_segs[..., 1] - nms_segs[..., 0]
    len_a = all_segs[..., 1] - all_segs[..., 0]
    iou = inter / torch.clamp(len_n[:, :, None] + len_a[:, None, :] - inter,
                              min=1e-9)
    w = (iou >= iou_threshold).float() * all_scores[:, None, :] * iou
    w = w * all_valid[:, None, :].float()
    denom = w.sum(dim=2, keepdim=True)
    w = w / torch.where(denom == 0, 1.0, denom)
    refined = w @ all_segs
    return torch.where(denom > 0, refined, nms_segs)


class Detections(NamedTuple):
    segs: torch.Tensor     # (B, K, 2) feature-grid coords
    scores: torch.Tensor   # (B, K)
    labels: torch.Tensor   # (B, K) int32
    valid: torch.Tensor    # (B, K) bool


def _partition_by_class(segs, scores, valid, cls_idx, num_classes: int,
                        cap: int):
    """Scatter (B, M) candidates into per-class buckets (B, C, cap),
    keeping the within-class input order; a class's candidates beyond
    `cap` are dropped in input order."""
    B, M = scores.shape
    C = num_classes
    cls_eff = torch.where(valid, cls_idx.long(), C)
    onehot = cls_eff[..., None] == torch.arange(C, device=scores.device)
    rank_all = torch.cumsum(onehot.int(), dim=1) - 1               # (B,M,C)
    rank = torch.gather(rank_all, 2,
                        cls_eff.clamp(max=C - 1)[..., None])[..., 0]
    rank = torch.where(valid, rank, cap)
    keep = valid & (rank < cap)
    # one spare slot per row takes every dropped candidate
    slot = torch.where(keep, cls_eff * cap + rank, C * cap)
    flat = slot + torch.arange(B, device=slot.device)[:, None] * (C * cap + 1)
    n = B * (C * cap + 1)
    b_scores = scores.new_zeros(n).index_put_((flat.reshape(-1),),
                                              scores.reshape(-1))
    b_segs = segs.new_zeros((n, 2)).index_put_((flat.reshape(-1),),
                                               segs.reshape(-1, 2))
    b_valid = torch.zeros(n, dtype=torch.bool, device=scores.device)
    b_valid.index_put_((flat.reshape(-1),), keep.reshape(-1))
    unpack = lambda t: t.reshape(B, C * cap + 1, *t.shape[1:])[:, :C * cap]
    return (unpack(b_segs).reshape(B, C, cap, 2),
            unpack(b_scores).reshape(B, C, cap),
            unpack(b_valid).reshape(B, C, cap))


def _auto_class_cap(num_classes: int, m: int, k_per: int) -> int | None:
    """Bucket capacity: 4x the mean per-class share, at least the pick
    budget and 64, rounded up to a power of two; None where buckets would
    not shrink the work (few classes or small M). Matches the JAX code
    (whose docstring says 8x)."""
    want = max(k_per, 4 * -(-m // num_classes), 64)
    cap = 1
    while cap < want:
        cap *= 2
    if cap >= m or num_classes < 8:
        return None
    return cap


def batched_nms(segs, scores, cls_idx, valid, num_classes: int,
                max_seg_num: int, min_score: float, nms_sigma: float,
                voting_thresh: float, multiclass: bool = True,
                per_class_capacity: int | None = None,
                use_soft_nms: bool = True,
                iou_threshold: float = 0.1) -> Detections:
    """Multiclass NMS (or class-agnostic NMS with segment voting), then a
    global top `max_seg_num`, over a batch of (B, M) candidates: Gaussian
    soft-NMS with `use_soft_nms`, else hard NMS at `iou_threshold`, on both
    branches. `per_class_capacity`: None = the automatic bucket size, 0 =
    the exact full-array path."""
    B, M = scores.shape
    dev = scores.device
    nms = dict(sigma=nms_sigma, min_score=min_score,
               method="gaussian" if use_soft_nms else "hard",
               iou_threshold=iou_threshold)
    if multiclass:
        k_per = max_seg_num
        cap = per_class_capacity
        if cap is None:
            cap = _auto_class_cap(num_classes, M, k_per)
        if cap:
            b_segs, b_scores, b_valid = _partition_by_class(
                segs, scores, valid, cls_idx, num_classes, cap)
        else:
            classes = torch.arange(num_classes, device=dev)
            b_valid = valid[:, None, :] & (cls_idx[:, None, :]
                                           == classes[None, :, None])
            b_segs = segs[:, None].expand(B, num_classes, M, 2)
            b_scores = scores[:, None].expand(B, num_classes, M)
        res = soft_nms_1d(b_segs, b_scores, b_valid, max_out=k_per, **nms)
        out_segs = res.segs.reshape(B, -1, 2)
        out_scores = res.scores.reshape(B, -1)
        out_valid = res.valid.reshape(B, -1)
        out_labels = torch.arange(num_classes, dtype=torch.int32,
                                  device=dev).repeat_interleave(k_per)
        out_labels = out_labels.expand(B, -1)
    else:
        out_segs, out_scores, out_valid = soft_nms_1d(
            segs, scores, valid, max_out=max_seg_num, **nms)
        if voting_thresh > 0:
            out_segs = torch.where(
                out_valid[..., None],
                seg_voting(out_segs, segs.float(), scores.float(), valid,
                           voting_thresh),
                out_segs)
        out_labels = torch.zeros((B, max_seg_num), dtype=torch.int32,
                                 device=dev)

    order = torch.where(out_valid, out_scores, NEG)
    top = torch.sort(order, dim=1, descending=True,
                     stable=True).indices[:, :max_seg_num]
    return Detections(
        segs=torch.gather(out_segs, 1, top[..., None].expand(-1, -1, 2)),
        scores=torch.gather(out_scores, 1, top),
        labels=torch.gather(out_labels, 1, top),
        valid=torch.gather(out_valid, 1, top),
    )
