"""Point generation (numpy) and training-target assignment
(vilco_tpu/ops/assign.py)."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


def generate_points(
    level_lengths: Sequence[int],
    fpn_strides: Sequence[int],
    regression_ranges: Sequence[Tuple[float, float]],
    use_offset: bool = False,
) -> np.ndarray:
    """All FPN-level points concatenated: (P, 4) rows
    [t, reg_lo, reg_hi, stride], t = arange(T_l) * stride."""
    rows = []
    for t_len, stride, (lo, hi) in zip(level_lengths, fpn_strides,
                                       regression_ranges):
        t = np.arange(t_len, dtype=np.float32) * stride
        if use_offset:
            t += 0.5 * stride
        rows.append(np.stack([t, np.full_like(t, lo), np.full_like(t, hi),
                              np.full_like(t, stride)], axis=-1))
    return np.concatenate(rows, axis=0)


INF = 1e9


def normal_distribution(x, mu, sigma):
    """exp(-(x - mu)^2 / (2 sigma^2))."""
    return torch.exp(-torch.square(x - mu) / (2.0 * torch.square(sigma)))


class Targets(NamedTuple):
    cls: torch.Tensor             # (B, P, C) multi-hot
    reg: torch.Tensor             # (B, P, 2) stride-normalised offsets
    prob_cls: torch.Tensor        # (B, P) Gaussian weight of the segment
    prob_reg_left: torch.Tensor   # (B, P)
    prob_reg_right: torch.Tensor  # (B, P)
    pos_mask: torch.Tensor        # (B, P) bool


def label_points(points, gt_segments, gt_labels, gt_valid, num_classes: int,
                 gaussians, center_sample_radius: float = 1.5,
                 center_sample: str = "radius") -> Targets:
    """Center-sampling assignment with the learned per-class Gaussian
    weights (vilco_tpu/ops/assign.py::label_points), vectorised over (B, P,
    N): candidates lie inside the segment's center window, clamped to the
    segment, of `center_sample_radius` strides each side (`center_sample`
    "radius"; any other value: inside the segment itself) with their max
    regression distance in the level's range; a point takes
    the shortest candidate segment, its cls target the multi-hot of the
    segments within 1e-3 of that length. Gradients flow into `gaussians`
    (mu, sigma, mu_l, sigma_l, mu_r, sigma_r, each (C,)); None (the NLQ
    model, which has none) takes the neutral constants (0, 1, -0.5, 1,
    0.5, 1), whose prob_* outputs the NLQ losses do not read."""
    if gaussians is None:
        C, dev = num_classes, points.device
        full = lambda v: torch.full((C,), v, dtype=torch.float32, device=dev)
        gaussians = (full(0.0), full(1.0), full(-0.5), full(1.0), full(0.5),
                     full(1.0))
    mu, sigma, mu_l, sig_l, mu_r, sig_r = gaussians
    t, reg_lo, reg_hi, stride = (points[:, i][None, :, None]
                                 for i in range(4))          # (1, P, 1)
    seg_l = gt_segments[..., 0][:, None, :]                  # (B, 1, N)
    seg_r = gt_segments[..., 1][:, None, :]
    lens = seg_r - seg_l
    left = t - seg_l                                         # (B, P, N)
    right = seg_r - t
    dist2center = (right - left) / 2.0

    # padded GT rows may have zero length: no inf/NaN into the graph
    seg_ok = gt_valid[:, None, :] & (lens > 0)
    lens_safe = torch.where(lens > 0, lens, torch.ones_like(lens))
    xn = torch.where(seg_ok, dist2center / (stride * lens_safe),
                     torch.zeros_like(dist2center))
    lbl = gt_labels.clamp(0, num_classes - 1).long()

    def g(m, s):
        return normal_distribution(xn, m[lbl][:, None, :], s[lbl][:, None, :])

    if center_sample == "radius":
        center = 0.5 * (seg_l + seg_r)
        t_min = torch.maximum(center - stride * center_sample_radius, seg_l)
        t_max = torch.minimum(center + stride * center_sample_radius, seg_r)
        inside = torch.minimum(t - t_min, t_max - t) > 0
    else:
        inside = torch.minimum(left, right) > 0
    max_reg_dist = torch.maximum(left, right)
    in_range = (max_reg_dist >= reg_lo) & (max_reg_dist <= reg_hi)
    valid = inside & in_range & gt_valid[:, None, :]
    lens_masked = torch.where(valid, lens.expand(valid.shape),
                              torch.full_like(left, INF))

    min_len, min_idx = lens_masked.min(dim=-1)               # first argmin
    min_len_mask = ((lens_masked <= (min_len[..., None] + 1e-3))
                    & (lens_masked < INF))
    onehot = torch.nn.functional.one_hot(lbl, num_classes).float()
    cls_t = torch.einsum("bpn,bnc->bpc", min_len_mask.float(),
                         onehot).clamp(0.0, 1.0)

    def take(a):
        return torch.gather(a, -1, min_idx[..., None])[..., 0]

    reg_t = torch.stack([take(left), take(right)], dim=-1) / stride
    return Targets(cls=cls_t, reg=reg_t, prob_cls=take(g(mu, sigma)),
                   prob_reg_left=take(g(mu_l, sig_l)),
                   prob_reg_right=take(g(mu_r, sig_r)),
                   pos_mask=min_len_mask.any(dim=-1))
