"""ROI align over a time axis and over a 2-D grid
(vilco_tpu/ops/roi_align.py), in plain PyTorch.

JAX writes both as gathers plus linear interpolation, with no Pallas
kernel, so plain PyTorch is their port: the same gathers and weights,
differentiable through autograd. The only consumer on a model's path is
the ClipMatcher's query-frame ROI resample (`VQConfig.use_query_roi`,
models/clip_matcher.py); `roi_align_1d` is kept for the temporal form.
"""

from __future__ import annotations

import torch


def roi_align_1d(feats: torch.Tensor, rois: torch.Tensor, out_size: int,
                 sampling_ratio: int = 2) -> torch.Tensor:
    """feats (B, T, C), rois (N, 3) [batch index, start, end] in grid
    coordinates -> (N, out_size, C): each bin the mean of `sampling_ratio`
    linearly interpolated samples, positions clamped to [0, T - 1] and the
    roi's length to >= 1e-6."""
    B, T, C = feats.shape
    batch_idx = rois[:, 0].long()
    start, end = rois[:, 1], rois[:, 2]
    bin_size = torch.clamp(end - start, min=1e-6) / out_size       # (N,)
    offs = (torch.arange(sampling_ratio, dtype=feats.dtype,
                         device=feats.device) + 0.5) / sampling_ratio
    bins = torch.arange(out_size, dtype=feats.dtype, device=feats.device)
    pos = (start[:, None, None] + (bins[None, :, None] + offs[None, None, :])
           * bin_size[:, None, None])                          # (N, out, S)
    lo = torch.clamp(torch.floor(pos), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = (pos - lo).to(feats.dtype)[..., None]
    rows = feats[batch_idx]                                    # (N, T, C)

    def take(idx):
        flat = idx.long().reshape(idx.shape[0], -1, 1).expand(-1, -1, C)
        return torch.gather(rows, 1, flat).reshape(idx.shape + (C,))

    v = take(lo) * (1 - frac) + take(hi) * frac
    return v.mean(dim=2)


def roi_align_2d(feats: torch.Tensor, rois: torch.Tensor, out_size,
                 sampling_ratio: int = 2) -> torch.Tensor:
    """feats (B, H, W, C), rois (N, 5) [batch index, x1, y1, x2, y2] in
    pixel coordinates -> (N, out_h, out_w, C), bilinear, torchvision's
    aligned=False rules: no half-pixel offset, the roi's sides clamped to
    >= 1, a sample outside [-1, dim] gives 0, and a fixed sampling_ratio x
    sampling_ratio grid a bin (torchvision's adaptive -1 is not taken,
    as in JAX)."""
    B, H, W, C = feats.shape
    out_h, out_w = out_size
    batch_idx = rois[:, 0].long()
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    r = sampling_ratio

    def axis_pos(start, size, out_len):                        # (N, out*r)
        bin_sz = size / out_len
        s = (torch.arange(r, dtype=feats.dtype, device=feats.device)
             + 0.5) / r
        grid = torch.arange(out_len, dtype=feats.dtype, device=feats.device)
        return (start[:, None, None] + (grid[None, :, None] + s[None, None, :])
                * bin_sz[:, None, None]).reshape(start.shape[0], -1)

    def weights(pos, dim):
        valid = (pos >= -1.0) & (pos <= dim)
        p = torch.clamp(pos, 0.0, dim - 1)
        lo = torch.floor(p)
        frac = (p - lo).to(feats.dtype)
        lo = lo.long()
        return lo, torch.clamp(lo + 1, max=dim - 1), frac, valid

    ylo, yhi, wy, vy = weights(axis_pos(y1, roi_h, out_h), H)
    xlo, xhi, wx, vx = weights(axis_pos(x1, roi_w, out_w), W)
    f = feats[batch_idx]                                       # (N, H, W, C)
    N, OH, OW = f.shape[0], ylo.shape[1], xlo.shape[1]

    def take_y(idx):                                           # (N, OH, W, C)
        return torch.gather(f, 1, idx[:, :, None, None].expand(N, OH, W, C))

    fy = take_y(ylo) * (1 - wy)[..., None, None] \
        + take_y(yhi) * wy[..., None, None]

    def take_x(idx):                                           # (N, OH, OW, C)
        return torch.gather(fy, 2, idx[:, None, :, None].expand(N, OH, OW, C))

    v = take_x(xlo) * (1 - wx)[:, None, :, None] \
        + take_x(xhi) * wx[:, None, :, None]
    v = v * (vy[:, :, None, None] & vx[:, None, :, None]).to(v.dtype)
    return v.reshape(N, out_h, r, out_w, r, C).mean(dim=(2, 4))
