"""Real-data VQ frame sources + Ego4D VQ annotation adapter (a copy of
vilco_tpu/data/vq_frames.py, which imports nothing of JAX; cv2 stays a soft
import, and a frame source raises naming it where it is missing).

The counterpart of the reference's raw-video pipeline
(VQ/dataset/base_dataset.py): annotation parsing (:60-120), pad-aware bbox
normalization (`_get_clip_bbox` :151-172 + `_process_clip` :294-330 square
padding), bbox cleaning (`_process_bbox` :270-291), balanced frame sampling
(`sample_frames_balance` :399-441), decord clip decode
(`read_frames_decord_balance` :446-463 — replaced by cv2.VideoCapture; the
image is decoded on the host and shipped to the card as float32 [0,1]),
query-crop extraction (`_get_query` :174-230, with the shipped config's
`query_square=True, query_padding=False`, VQ/config/train_cl.yaml:24).

Two sources, both satisfying the VQEpisodeRunner protocol
(`clip(sample)`, `query(sample)`, plus the faster `frames(sample, idxs)`):

- ``VideoFrameSource``  — decodes ``{clip_dir}/{clip_uid}.mp4`` with
  cv2.VideoCapture (decord is not a dependency).
- ``FrameDirSource``    — reads pre-extracted frames
  ``{images_dir}/{clip_uid}/frame_{fno+1:07d}.jpg`` (the reference's own
  `images/` layout, `_get_query_path` base_dataset.py:133-137).

Geometry convention: all boxes are xyxy, normalized to the SQUARE-PADDED
frame (the reference pads every frame to a centered square before resizing,
`_process_clip`); the normalization happens once at annotation-load time so
sources only need to pad pixels the same way.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

try:  # a soft import: the frame sources need cv2, nothing else here does
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


# ----------------------------------------------------------------------
# geometry helpers
# ----------------------------------------------------------------------

def square_pad_resize(img: np.ndarray, size: int,
                      pad_value: float = 0.0) -> np.ndarray:
    """Pad (H, W, 3) to a centered square, resize to (size, size).

    Mirrors `_process_clip` (base_dataset.py:294-330): pad the SHORT side
    symmetrically, then resize.
    """
    h, w = img.shape[:2]
    s = max(h, w)
    if h != w:
        out = np.full((s, s, img.shape[2]), pad_value, img.dtype)
        dy, dx = (s - h) // 2, (s - w) // 2
        out[dy:dy + h, dx:dx + w] = img
        img = out
    if s != size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return img


def _square_bbox(x1, y1, x2, y2, h, w):
    """Expand a box to a square of side max(bh, bw), kept inside the image
    (`create_square_bbox`, VQ/dataset/dataset_utils.py)."""
    bw, bh = x2 - x1, y2 - y1
    side = max(bw, bh)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    nx1 = np.clip(cx - side / 2.0, 0, max(w - side, 0))
    ny1 = np.clip(cy - side / 2.0, 0, max(h - side, 0))
    return nx1, ny1, min(nx1 + side, w), min(ny1 + side, h)


def normalize_track_box(box: dict) -> List[float]:
    """Response-track entry {x, y, width, height, original_*} -> xyxy
    normalized to the padded-square frame."""
    h = float(box["original_height"])
    w = float(box["original_width"])
    s = max(h, w)
    dx, dy = (s - w) / 2.0, (s - h) / 2.0
    x1 = (float(box["x"]) + dx) / s
    y1 = (float(box["y"]) + dy) / s
    return [x1, y1,
            x1 + float(box["width"]) / s,
            y1 + float(box["height"]) / s]


def denormalize_track_box(b: Sequence[float], oheight: float,
                          owidth: float) -> List[float]:
    """Inverse of `normalize_track_box`: padded-square-normalized xyxy ->
    ORIGINAL-resolution pixel xyxy, clamped to the unpadded frame (the
    reference's process_bbox_prediction + recover_bbox,
    VQ/evaluation/task_inference_predict.py:236-269 — same clamp-to-band
    then scale, without the torch/cv2 axis swap our convention avoids)."""
    s = float(max(oheight, owidth))
    dx, dy = (s - owidth) / 2.0, (s - oheight) / 2.0
    return [
        min(max(b[0] * s - dx, 0.0), float(owidth)),
        min(max(b[1] * s - dy, 0.0), float(oheight)),
        min(max(b[2] * s - dx, 0.0), float(owidth)),
        min(max(b[3] * s - dy, 0.0), float(oheight)),
    ]


def clean_box_flags(track: Dict[int, List[float]],
                    original_hw: Sequence[float],
                    min_size: float = 0.05,
                    max_ratio: float = 2.5) -> Dict[int, List[float]]:
    """Drop degenerate boxes (`_process_bbox` base_dataset.py:270-291):
    per-axis size < 5% or aspect ratio beyond 2.5, both measured in the
    [0, 1] coordinates of the padded SQUARE frame — exactly the units our
    tracks are stored in (scale_box divides by max(h, w)), matching the
    reference check."""
    del original_hw  # kept for signature stability; the check is
    # square-frame-relative like the reference's
    out = {}
    for fno, (x1, y1, x2, y2) in track.items():
        bw = x2 - x1
        bh = y2 - y1
        if bw <= min_size or bh <= min_size:
            continue
        ratio = bh / max(bw, 1e-9)
        if not (1.0 / max_ratio < ratio < max_ratio):
            continue
        out[fno] = [x1, y1, x2, y2]
    return out


# ----------------------------------------------------------------------
# annotation adapter
# ----------------------------------------------------------------------

def load_vq_annotations(json_path: str, split: str = "train",
                        clean: bool = False) -> List[dict]:
    """Ego4D vq_{train,val}.json -> runner sample dicts.

    Walks videos -> clips -> annotations -> query_sets exactly like the
    reference (base_dataset.py:76-115), skipping invalid query sets, and
    emits the VQEpisodeRunner schema:
      {id, category, clip_uid, num_frames, query_frame, track,
       valid_range, visual_crop, original_hw, clip_fps}

    `clean` applies the `_process_bbox` size/ratio filter — default OFF to
    match the reference, which defines the filter but comments it out at
    both call sites (base_dataset.py:336, :807); never clean GT used for
    metric evaluation.
    """
    with open(json_path) as f:
        data = json.load(f)
    videos = data["videos"] if isinstance(data, dict) else data
    samples, n = [], 0
    for video in videos:
        for clip in video.get("clips", []):
            clip_uid = clip.get("clip_uid")
            if clip_uid is None:
                continue
            for anno in clip.get("annotations", []):
                qsets = anno.get("query_sets", {})
                for qset_id in sorted(qsets):
                    qset = qsets[qset_id]
                    if not qset.get("is_valid", True):
                        continue
                    rt = qset.get("response_track") or []
                    vc = qset.get("visual_crop")
                    if not rt or vc is None:
                        continue
                    track = {int(b["frame_number"]): normalize_track_box(b)
                             for b in rt}
                    hw = (rt[0]["original_height"], rt[0]["original_width"])
                    if clean:
                        kept = clean_box_flags(track, hw)
                        if kept:   # never clean a track away entirely
                            track = kept
                    fnos = sorted(track)
                    query_frame = int(qset["query_frame"])
                    samples.append({
                        "id": f"{split}_{n:010d}",
                        "category": qset.get("object_title") or "unknown",
                        "clip_uid": clip_uid,
                        "annotation_uid": anno.get("annotation_uid"),
                        "query_set": qset_id,
                        "num_frames": max(query_frame, fnos[-1] + 1),
                        "query_frame": query_frame,
                        "track": track,
                        "valid_range": (fnos[0], fnos[-1]),
                        "visual_crop": vc,
                        "original_hw": hw,
                        "clip_fps": int(clip.get("clip_fps", 5)),
                    })
                    n += 1
    return samples


# ----------------------------------------------------------------------
# balanced training-frame sampling (sample_frames_balance, :399-441)
# ----------------------------------------------------------------------

def balanced_frame_indices(num_frames: int, sample: dict,
                           rng: np.random.Generator,
                           frame_interval: int = 1,
                           sampling: str = "rand") -> np.ndarray:
    """Pick `num_frames` annotation-fps frame indices biased to cover the
    response track, with negatives spilled before/after it — the
    reference's balanced sampler with numpy RNG semantics."""
    required = (num_frames - 1) * frame_interval + 1
    lo, hi = sample.get("valid_range") or (min(sample["track"]),
                                           max(sample["track"]))
    anno_len = hi - lo + 1
    if anno_len <= required:
        num_valid = (anno_len // frame_interval if anno_len < required
                     else num_frames)
        num_invalid = num_frames - num_valid
        if hi < required:
            start = int(rng.integers(0, lo)) if lo > 0 else 0
            end = start + required
        else:
            prior = int(rng.integers(0, num_invalid)) if num_invalid else 0
            post = num_invalid - prior
            start = lo - frame_interval * prior
            end = hi + frame_interval * post + 1
        edges = np.linspace(start, end, num_frames + 1).astype(int)
        if sampling == "rand":
            idxs = [int(rng.integers(a, max(b, a + 1)))
                    for a, b in zip(edges[:-1], edges[1:])]
        else:
            idxs = [(a + b) // 2 for a, b in zip(edges[:-1], edges[1:])]
    else:
        start = int(rng.integers(0, anno_len - required))
        idxs = [lo + start + i * frame_interval for i in range(num_frames)]
    return np.clip(np.asarray(idxs, np.int64), 0, None)


# ----------------------------------------------------------------------
# frame sources
# ----------------------------------------------------------------------

class _BaseFrameSource:
    """Shared query-crop + full-clip plumbing for real-pixel sources."""

    def __init__(self, frame_size: int = 448, query_size: Optional[int] = None,
                 pad_value: float = 0.0, query_square: bool = True):
        if cv2 is None:
            raise ImportError("the real VQ frame sources need cv2 (the "
                              "opencv-python package), which is not "
                              "installed")
        self.frame_size = frame_size
        self.query_size = query_size or frame_size
        self.pad_value = pad_value
        self.query_square = query_square

    # subclasses: _read_raw(sample, fno) -> (H, W, 3) float32 RGB in [0,1]
    def _read_raw(self, sample: dict, fno: int) -> np.ndarray:
        raise NotImplementedError

    def frames(self, sample: dict, idxs: Sequence[int]) -> np.ndarray:
        out = np.empty((len(idxs), self.frame_size, self.frame_size, 3),
                       np.float32)
        for i, fno in enumerate(idxs):
            out[i] = square_pad_resize(self._read_raw(sample, int(fno)),
                                       self.frame_size, self.pad_value)
        return out

    def clip(self, sample: dict) -> np.ndarray:
        return self.frames(sample, range(sample["num_frames"]))

    def query(self, sample: dict) -> np.ndarray:
        vc = sample["visual_crop"]
        img = self._read_raw(sample, int(vc["frame_number"]))
        h, w = img.shape[:2]
        ah, aw = int(vc["original_height"]), int(vc["original_width"])
        if (h, w) != (ah, aw):  # size drift guard (`_get_query` :177-182)
            img = cv2.resize(img, (aw, ah), interpolation=cv2.INTER_LINEAR)
            h, w = ah, aw
        x1, y1 = float(vc["x"]), float(vc["y"])
        x2, y2 = x1 + float(vc["width"]), y1 + float(vc["height"])
        if self.query_square:
            x1, y1, x2, y2 = _square_bbox(x1, y1, x2, y2, h, w)
        crop = img[int(round(y1)):max(int(round(y2)), int(round(y1)) + 1),
                   int(round(x1)):max(int(round(x2)), int(round(x1)) + 1)]
        return cv2.resize(crop, (self.query_size, self.query_size),
                          interpolation=cv2.INTER_LINEAR)


class VideoFrameSource(_BaseFrameSource):
    """Decode `{clip_dir}/{clip_uid}.mp4` with cv2.VideoCapture.

    Annotation frame indices are at the annotation fps (`clip_fps`, usually
    5); the raw clip runs at its native fps, so indices are scaled by
    `origin_fps // clip_fps` (read_frames_decord_balance :446-457).
    A one-clip decoder cache exploits the per-sample access locality.
    """

    def __init__(self, clip_dir: str, **kw):
        super().__init__(**kw)
        self.clip_dir = clip_dir
        self._cap = None
        self._cap_path = None
        self._vlen = 0
        self._down_rate = 1

    def _open(self, sample: dict):
        path = os.path.join(self.clip_dir, sample["clip_uid"] + ".mp4")
        if path != self._cap_path:
            if self._cap is not None:
                self._cap.release()
                # clear the cache BEFORE attempting the new open: a failed
                # open must not leave a released capture addressable under
                # the old path
                self._cap = None
                self._cap_path = None
            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open clip {path}")
            self._cap, self._cap_path = cap, path
            self._vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            # truncate like the reference's int(get_avg_fps())
            fps = int(cap.get(cv2.CAP_PROP_FPS) or 0)
            self._down_rate = max(fps // int(sample.get("clip_fps", 5)), 1)
        return self._cap

    def _read_raw(self, sample: dict, fno: int) -> np.ndarray:
        cap = self._open(sample)
        raw_idx = min(fno * self._down_rate, max(self._vlen - 1, 0))
        # sequential decode is much cheaper than a seek; only seek backwards
        pos = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
        if raw_idx != pos:
            cap.set(cv2.CAP_PROP_POS_FRAMES, raw_idx)
        ok, frame = cap.read()
        if not ok:  # past-EOF guard: re-seek to the last decodable frame
            cap.set(cv2.CAP_PROP_POS_FRAMES, max(self._vlen - 1, 0))
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"decode failure at frame {raw_idx} of "
                              f"{self._cap_path}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(
            np.float32) / 255.0


class FrameDirSource(_BaseFrameSource):
    """Pre-extracted frames `{images_dir}/{clip_uid}/frame_{fno+1:07d}.jpg`
    (the reference's `images/` layout, `_get_query_path`)."""

    def __init__(self, images_dir: str, **kw):
        super().__init__(**kw)
        self.images_dir = images_dir

    def _path(self, sample: dict, fno: int) -> str:
        return os.path.join(self.images_dir, sample["clip_uid"],
                            f"frame_{fno + 1:07d}.jpg")

    def _read_raw(self, sample: dict, fno: int) -> np.ndarray:
        path = self._path(sample, fno)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(
            np.float32) / 255.0


def group_by_category(samples: List[dict], categories_per_task: int,
                      seed: int = 0,
                      names: Optional[List[str]] = None
                      ) -> Dict[int, Dict[str, list]]:
    """Category-keyed QIL task dict from a flat sample list — the shape
    VQTaskStream consumes (VQ/dataset/cl_benchmark.py:18-120).

    `names` pins the category->task ordering (pass the same list for the
    train and val splits so a category lands in the same task in both)."""
    cats: Dict[str, list] = {}
    for s in samples:
        cats.setdefault(s["category"], []).append(s)
    if names is None:
        names = sorted(cats)
        rng = np.random.default_rng(seed)
        rng.shuffle(names)
    tasks: Dict[int, Dict[str, list]] = {}
    for i, name in enumerate(names):
        if name in cats:
            tasks.setdefault(i // categories_per_task, {})[name] = cats[name]
    return tasks


def group_splits(train_samples: List[dict], val_samples: List[dict],
                 categories_per_task: int, seed: int = 0):
    """Consistent category->task split over train ∪ val (the reference's
    split_vq.py shuffles the global category list once)."""
    names = sorted({s["category"] for s in train_samples}
                   | {s["category"] for s in val_samples})
    rng = np.random.default_rng(seed)
    rng.shuffle(names)
    train_t = group_by_category(train_samples, categories_per_task,
                                names=names)
    val_t = group_by_category(val_samples, categories_per_task, names=names)
    for k in set(train_t) | set(val_t):   # identical task keys in both
        train_t.setdefault(k, {})
        val_t.setdefault(k, {})
    return train_t, val_t
