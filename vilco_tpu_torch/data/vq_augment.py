"""The VQ train batches' augmentation (vilco_tpu/data/vq_augment.py) in
PyTorch: color jitter (brightness, contrast, saturation), horizontal flip
with the boxes flipped, RandomResizedCrop with the boxes remapped and the
ones that leave the crop invalidated (the reference's check_bbox), then
ImageNet normalization; the reference's kornia pipeline (process_data,
VQ/dataset/dataset_utils.py:76-197) in its order: jitter, flip, crop.

Each random transform is split into a draw and an apply. The draw takes
its parameters from an explicit CPU `torch.Generator` (`draw_vq_augment`:
jitter factors, flip bits, crop windows); the apply is a pure function of
them on the batch's device (`augment_vq_batch`). The same draws then give
the same batch on the card and on the CPU. JAX draws from its own keys,
which torch cannot reproduce: the apply takes JAX's draws as well.

Boxes are normalized xyxy. A crop is shared across a clip's frames (the
reference's same_on_batch=True per clip) and drawn per batch element.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the clip's jitter (dataset_utils.py:108) and the query's
CLIP_JITTER = (0.4, 0.4, 0.3)
QUERY_JITTER = (0.3, 0.3, 0.2)
CROP_SCALE = (0.66, 1.0)
CROP_RATIO = (0.8, 1.2)
CROP_TRIES = 8


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization over the trailing channel dim."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def draw_jitter(gen: torch.Generator, n: int,
                strength=QUERY_JITTER) -> torch.Tensor:
    """(n, 3) brightness, contrast and saturation factors, each uniform in
    1 -/+ its strength."""
    return torch.stack([_uniform(gen, (n,), 1 - s, 1 + s) for s in strength],
                       1)


def color_jitter(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Per-sample color jitter of (n, ..., H, W, 3) in [0, 1] by factors
    (n, 3) (brightness, contrast, saturation)."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    b, c, s = (factors[:, i].to(x).reshape(shape) for i in range(3))
    x = x * b
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)
    x = (x - mean) * c + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * s + gray
    return x.clamp(0.0, 1.0)


def draw_flip(gen: torch.Generator, n: int, p: float = 0.5) -> torch.Tensor:
    """(n,) flip bits, each set with probability p."""
    return torch.rand((n,), generator=gen) < p


def hflip_clip(clip: torch.Tensor, bbox: torch.Tensor, flip: torch.Tensor):
    """Horizontal flip of the (B, T, H, W, 3) clips and (B, T, 4) boxes
    whose bit in flip (B,) is set, one decision a clip."""
    flip = flip.to(clip.device)
    clip = torch.where(flip[:, None, None, None, None], clip.flip(3), clip)
    x1, y1, x2, y2 = bbox.unbind(-1)
    fb = torch.stack([1.0 - x2, y1, 1.0 - x1, y2], -1)
    return clip, torch.where(flip[:, None, None], fb, bbox)


def _sample_crop(gen: torch.Generator, scale=CROP_SCALE, ratio=CROP_RATIO,
                 tries: int = CROP_TRIES) -> Tuple[float, ...]:
    """RandomResizedCrop's window as JAX draws it: `tries` (area,
    log-aspect) candidates at once, the first whose crop fits the frame,
    else the full frame; then the corner. Fractional (x0, y0, w, h)."""
    area = _uniform(gen, (tries,), scale[0], scale[1])
    log_r = _uniform(gen, (tries,), math.log(ratio[0]), math.log(ratio[1]))
    aspect = torch.exp(log_r)
    w, h = torch.sqrt(area * aspect), torch.sqrt(area / aspect)
    ok = (w <= 1.0) & (h <= 1.0)
    idx = int(torch.cat([ok, torch.ones(1, dtype=torch.bool)]).int().argmax())
    w = torch.cat([w, torch.ones(1)])[idx]
    h = torch.cat([h, torch.ones(1)])[idx]
    x0 = torch.rand((), generator=gen) * (1.0 - w)
    y0 = torch.rand((), generator=gen) * (1.0 - h)
    return x0, y0, w, h


def draw_crops(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 4) crop windows (x0, y0, w, h), one a clip."""
    return torch.stack([torch.stack(_sample_crop(gen)) for _ in range(n)])


def _bilinear_crop_resize(frames: torch.Tensor, x0, y0, w, h):
    """The fractional window (x0, y0, w, h) of (..., H, W, C) frames
    resized back to (H, W) by bilinear sampling (align_corners=False),
    separably per axis."""
    H, W = frames.shape[-3], frames.shape[-2]

    def axis_coords(n, start, size):
        ar = torch.arange(n, dtype=torch.float32, device=frames.device)
        pos = start * n + (ar + 0.5) * (size * n) / n - 0.5
        lo = torch.floor(pos).long().clamp(0, n - 1)
        hi = (lo + 1).clamp(0, n - 1)
        frac = (pos - lo).clamp(0.0, 1.0)
        return lo, hi, frac

    ylo, yhi, yf = axis_coords(H, y0, h)
    x = (frames.index_select(-3, ylo) * (1.0 - yf)[:, None, None]
         + frames.index_select(-3, yhi) * yf[:, None, None])
    xlo, xhi, xf = axis_coords(W, x0, w)
    return (x.index_select(-2, xlo) * (1.0 - xf)[:, None]
            + x.index_select(-2, xhi) * xf[:, None])


def random_resized_crop_clip(clip, bbox, with_bbox, crops: torch.Tensor):
    """Each (T, H, W, 3) clip of (B, ...) cropped to its window of crops
    (B, 4) and resized back; the (B, T, 4) boxes remapped, a box wholly
    outside the crop invalidated in with_bbox (B, T), the rest clamped to
    [0, 1]."""
    crops = crops.to(device=clip.device, dtype=torch.float32)
    clip = torch.stack([_bilinear_crop_resize(c, *crops[i])
                        for i, c in enumerate(clip)])
    x0, y0, w, h = (crops[:, i, None, None] for i in range(4))
    x1 = (bbox[..., 0:1] - x0) / w
    y1 = (bbox[..., 1:2] - y0) / h
    x2 = (bbox[..., 2:3] - x0) / w
    y2 = (bbox[..., 3:4] - y0) / h
    invalid = ((x2 <= 0.0) | (x1 >= 1.0) | (y2 <= 0.0) | (y1 >= 1.0))[..., 0]
    bbox = torch.cat([x1, y1, x2, y2], -1).clamp(0.0, 1.0)
    return clip, bbox, with_bbox * (~invalid).to(with_bbox.dtype)


def draw_vq_augment(gen: torch.Generator, batch_size: int, *,
                    p_flip: float = 0.5, jitter: bool = True,
                    crop: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """The draws of one batch's augmentation, in the order they are
    applied: clip and query jitter factors (B, 3), flip bits (B,), crop
    windows (B, 4); a stage that is off draws nothing and is None."""
    B = batch_size
    return {
        "clip_jitter": draw_jitter(gen, B, CLIP_JITTER) if jitter else None,
        "query_jitter": draw_jitter(gen, B, QUERY_JITTER) if jitter else None,
        "flip": draw_flip(gen, B, p_flip),
        "crop": draw_crops(gen, B) if crop else None,
    }


def augment_vq_batch(batch: Dict[str, torch.Tensor],
                     draws: Dict[str, Optional[torch.Tensor]]):
    """A VQ batch (clip, query, clip_bbox, clip_with_bbox) augmented by
    `draws` (draw_vq_augment's, or JAX's), then normalized; the other keys
    kept."""
    clip, query, bbox = batch["clip"], batch["query"], batch["clip_bbox"]
    with_bbox = batch.get("clip_with_bbox")
    if with_bbox is None:
        with_bbox = torch.ones(bbox.shape[:2], dtype=torch.float32,
                               device=bbox.device)
    if draws["clip_jitter"] is not None:
        clip = color_jitter(clip, draws["clip_jitter"])
        query = color_jitter(query, draws["query_jitter"])
    clip, bbox = hflip_clip(clip, bbox, draws["flip"])
    if draws["crop"] is not None:
        clip, bbox, with_bbox = random_resized_crop_clip(
            clip, bbox, with_bbox, draws["crop"])
    out = dict(batch)
    out["clip"] = normalize_images(clip)
    out["query"] = normalize_images(query)
    out["clip_bbox"] = bbox
    out["clip_with_bbox"] = with_bbox
    return out
