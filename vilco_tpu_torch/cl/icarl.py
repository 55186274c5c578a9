"""iCaRL's nearest-mean candidate filter at eval (vilco_tpu/cl/icarl.py,
applied with BiC's bias in vilco_tpu/cl/episode.py::predict_videos).

Per FPN level, a class's exemplar mean is the globally normalised mean of
its exemplar clips' globally normalised (T_l, D) feature maps
(`compute_exemplar_means`). At eval the squared distance between a clip's
normalised map and each class's mean, per time step, keeps a candidate
where it lies below the level's mean distance over the classes that have
exemplars (`distance_keep_mask`); `adjust_eval_outputs` applies BiC's bias
and then the filter (dropped candidates' logits -1e9) to an eval step's
outputs.

The distances take the form ||f||^2 + ||m||^2 - 2 f.m, the products one
batched GEMM over the time steps in f64 (no TF32, and no cancellation at
the threshold, where f32 would keep ~1e-7 of a distance): JAX's direct
form builds a (B, C, T, D) difference tensor, 7.4 GB at level 0 of the MQ
flagship's serving shape (B 16, C 110, T 1024, D 1024). `chunk` gives
the direct form instead, in chunks of that many classes: the reference
the keep mask's flipped bits are counted against.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from vilco_tpu_torch.cl.bic import apply_bias

DROPPED_LOGIT = -1e9


def _gnorm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Each (T, D) map of x (..., T, D) over its Frobenius norm + eps."""
    return x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
                + eps)


def compute_exemplar_means(
        feats_fn: Callable[[list], List[torch.Tensor]],
        class_videos: Dict[int, list], num_classes: int
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(per-level (C, T_l, D) means, (C,) bool: the classes with exemplars).
    feats_fn(videos) -> per level (n_videos, T_l, D) f32, on the device the
    means are made on; a class without exemplars keeps zero rows. No class
    with exemplars: ([], all False)."""
    per_class = {}
    for c, videos in class_videos.items():
        if videos:
            per_class[int(c)] = [_gnorm(f.float()) for f in feats_fn(videos)]
    if not per_class:
        return [], torch.zeros(num_classes, dtype=torch.bool)
    first = next(iter(per_class.values()))
    dev = first[0].device
    valid = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    means = [torch.zeros((num_classes,) + f.shape[1:], device=dev)
             for f in first]
    for c, levels in per_class.items():
        valid[c] = True
        for lvl, f in enumerate(levels):
            means[lvl][c] = _gnorm(f.mean(0))
    return means, valid


def level_distances(f: torch.Tensor, m: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """dists[b, t, c] = ||gnorm(f[b])[t] - m[c, t]||^2, (B, T, C), for f
    (B, T, D) and m (C, T, D): by the expanded form in f64 (module
    docstring), or with `chunk` the direct form in f32, `chunk` classes at
    a time."""
    fn = _gnorm(f.float())
    if chunk is not None:
        parts = [torch.square(fn[:, None] - m[None, c0:c0 + chunk]).sum(-1)
                 for c0 in range(0, m.shape[0], chunk)]     # (B, c, T)
        return torch.cat(parts, 1).transpose(1, 2)
    ft = fn.double().transpose(0, 1)                        # (T, B, D)
    mt = m.double().transpose(0, 1)                         # (T, C, D)
    d = (ft.square().sum(-1)[:, :, None] + mt.square().sum(-1)[:, None, :]
         - 2.0 * torch.bmm(ft, mt.transpose(1, 2)))         # (T, B, C)
    return d.transpose(0, 1)


def distance_keep_mask(fpn_feats: Sequence[torch.Tensor],
                       means_per_level: Sequence[torch.Tensor],
                       class_valid: torch.Tensor,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """(B, P, C) bool: dist < the level's mean distance over the valid
    classes (+inf for the others), per clip (inference_single_video
    :1626-1643 keep_idxs1); `chunk`: the direct form (level_distances)."""
    keeps = []
    for f, m in zip(fpn_feats, means_per_level):
        d = level_distances(f, m, chunk)
        d = torch.where(class_valid, d, torch.full_like(d, float("inf")))
        fin = torch.isfinite(d)
        thr = (torch.where(fin, d, torch.zeros_like(d)).sum((1, 2))
               / fin.sum((1, 2)))                           # (B,)
        keeps.append(d < thr[:, None, None])
    return torch.cat(keeps, 1)


def adjust_eval_outputs(out: dict, bias: Optional[Tuple] = None,
                        means: Optional[Sequence[torch.Tensor]] = None,
                        class_valid: Optional[torch.Tensor] = None) -> dict:
    """An eval step's outputs with BiC's bias (alpha, beta) on cls_logits,
    then iCaRL's filter (the logits of the candidates `distance_keep_mask`
    drops at DROPPED_LOGIT) where `means` holds levels, as
    vilco_tpu/cl/episode.py::predict_videos (:630-652) applies them."""
    out = dict(out)
    if bias is not None:
        out["cls_logits"] = apply_bias(out["cls_logits"], *bias)
    if means:
        keep = distance_keep_mask(out["fpn_feats"], means, class_valid)
        out["cls_logits"] = torch.where(
            keep, out["cls_logits"],
            torch.full_like(out["cls_logits"], DROPPED_LOGIT))
    return out
