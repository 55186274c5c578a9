"""Padded static-shape data pipeline.

TPU-native replacement of the reference's DataLoader + trivial list collator
(MQ/libs/datasets/datasets.py:19-40, data_utils.py:9-110) and the in-model
re-padding (`preprocessing`, meta_archs.py:1133-1181): every clip is padded to
`max_seq_len` with a boolean mask *in the pipeline*, GT is padded to
`max_segments`, so batches have one static shape for the whole run and XLA
compiles the train step exactly once.

Feature sources abstract where features come from: a directory of per-clip
.pt/.npy/.pkl files (the reference's formats, MQ/libs/datasets/ego4d.py:
612-684) or a deterministic synthetic generator for tests/benchmarks.

The index stream replaces DistributedSampler: a seeded permutation sliced
per host (`shard_id` / `num_shards`), deterministic across processes.

A copy of vilco_tpu/data/pipeline.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from vilco_tpu_torch.core.config import Config
from vilco_tpu_torch.core.registry import DATASETS


def linear_resize(feats: np.ndarray, out_len: int) -> np.ndarray:
    """F.interpolate(mode='linear', align_corners=False) for (T, C) -> (out, C),
    matching the upsample-to-max_seq_len path (ego4d.py:648-655)."""
    t_in = feats.shape[0]
    if t_in == out_len:
        return feats
    # torch linear: out[i] samples input at (i + 0.5) * t_in / out - 0.5
    pos = (np.arange(out_len) + 0.5) * (t_in / out_len) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)[:, None]
    lo0 = np.clip(lo, 0, t_in - 1)
    lo1 = np.clip(lo + 1, 0, t_in - 1)
    return feats[lo0] * (1.0 - frac) + feats[lo1] * frac


@DATASETS.register("dir_features")
class DirFeatureSource:
    """Loads per-clip feature files from one or more folders, concatenating
    channel-wise (ego4d.py:663-726 multi-folder path)."""

    def __init__(self, folders: Sequence[str], exts: Sequence[str],
                 prefix: str = ""):
        self.folders = list(folders)
        self.exts = list(exts)
        self.prefix = prefix

    def __call__(self, video: dict) -> np.ndarray:
        parts = []
        for folder, ext in zip(self.folders, self.exts):
            path = os.path.join(folder, self.prefix + video["id"] + ext)
            if ext == ".pt":
                import torch

                arr = torch.load(path, map_location="cpu",
                                 weights_only=False)
                arr = np.asarray(arr, dtype=np.float32)
            elif ext == ".npy":
                arr = np.load(path).astype(np.float32)
            else:
                with open(path, "rb") as f:
                    arr = np.asarray(pickle.load(f), dtype=np.float32)
            parts.append(arr)  # (T, C)
        if len(parts) > 1:
            # folders can disagree on T (different extractor strides); the
            # reference aligns by upsampling each to max_seq_len before
            # concat (ego4d.py:702-716) — align to the longest here and
            # let ClipDataset do the final max_seq_len resize
            t_max = max(p.shape[0] for p in parts)
            parts = [p if p.shape[0] == t_max else linear_resize(p, t_max)
                     for p in parts]
        return np.concatenate(parts, axis=-1)


@DATASETS.register("synthetic_features")
class SyntheticFeatureSource:
    """Deterministic per-video features with a class-conditional signal at
    GT locations so models can learn; used by tests/bench in place of the
    Ego4D feature dumps.

    The native grid length follows the video's duration/fps/stride (like the
    real extractors), so second->grid conversion in ClipDataset stays
    consistent with the annotations.
    """

    def __init__(self, input_dim: int, feat_stride: float = 16.0,
                 fps: float = 30.0, signal: float = 2.0,
                 max_grid: int = 512):
        self.input_dim = input_dim
        self.feat_stride = feat_stride
        self.fps = fps
        self.signal = signal
        self.max_grid = max_grid

    def __call__(self, video: dict) -> np.ndarray:
        seed = int(hashlib.md5(video["id"].encode()).hexdigest()[:8], 16)
        rng = np.random.default_rng(seed)
        dur = float(video["duration"])
        fps = float(video.get("fps", self.fps))
        stride = float(video.get("feat_stride", self.feat_stride))
        T = int(min(max(8, round(dur * fps / stride)), self.max_grid))
        feats = rng.standard_normal((T, self.input_dim)).astype(np.float32) * 0.5
        for seg, label in zip(video["segments"], video["labels"]):
            s = int(np.clip(seg[0] / dur * T, 0, T - 1))
            e = int(np.clip(seg[1] / dur * T, s + 1, T))
            c = int(label)
            feats[s:e, c % self.input_dim] += self.signal
            feats[s:e, (c * 7 + 1) % self.input_dim] += self.signal
        return feats


class SyntheticTextSource:
    """Deterministic per-video text-token features — stands in for the
    per-clip CLIP prompt features the reference loads (ego4d.py
    `prompt_feature`): one token per GT class in the clip (class-seeded,
    so the same class yields the same token across videos) plus a
    video-seeded context token. Lets the L2P prompt-pool/cross-modal path
    run end-to-end in synthetic episodes."""

    def __init__(self, text_dim: int, max_len: int = 8):
        self.dim = text_dim
        self.max_len = max_len

    def __call__(self, video: dict):
        toks = []
        for label in list(video.get("labels", []))[: self.max_len - 1]:
            seed = int(hashlib.md5(
                f"txtcls{int(label)}".encode()
            ).hexdigest()[:8], 16)
            toks.append(np.random.default_rng(seed)
                        .standard_normal(self.dim))
        seed = int(hashlib.md5(
            ("txt" + video["id"]).encode()
        ).hexdigest()[:8], 16)
        toks.append(np.random.default_rng(seed).standard_normal(self.dim))
        return np.stack(toks).astype(np.float32)


class SyntheticNarrationSource:
    """Deterministic per-video narration token features — stands in for the
    CLIP narration-token dumps the reference loads (ego4d.py:793-824) so
    the narration-SSL path runs end-to-end in smoke/synthetic episodes."""

    def __init__(self, narration_dim: int, max_len: int = 8,
                 p_missing: float = 0.2):
        self.dim = narration_dim
        self.max_len = max_len
        self.p_missing = p_missing

    def __call__(self, video: dict):
        seed = int(hashlib.md5(
            ("nar" + video["id"]).encode()
        ).hexdigest()[:8], 16)
        rng = np.random.default_rng(seed)
        if rng.random() < self.p_missing:
            return None   # clips without in-segment narrations
        n = int(rng.integers(1, self.max_len + 1))
        return rng.standard_normal((n, self.dim)).astype(np.float32)


class ClipDataset:
    """Video dicts -> fixed-shape samples (grid-coord conversion, upsample,
    random-crop truncation, GT padding).

    Mirrors Ego4dCLDataset.__getitem__ (ego4d.py:594-850): force-upsampling
    recomputes feat_stride as ((T_in - 1) * stride + num_frames) / max_seq_len
    and converts second timestamps to grid coords via
    (sec * fps - 0.5 * num_frames) / feat_stride.
    """

    def __init__(
        self,
        videos: List[dict],
        cfg: Config,
        feature_source: Callable[[dict], np.ndarray],
        is_training: bool,
        text_source: Optional[Callable[[dict], np.ndarray]] = None,
        narration_source: Optional[Callable[[dict], np.ndarray]] = None,
    ):
        self.videos = videos
        self.cfg = cfg
        self.src = feature_source
        self.text_source = text_source
        self.narration_source = narration_source
        self.is_training = is_training
        self._jitter_rng = np.random.default_rng(cfg.init_rand_seed + 7451)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ds = self.cfg.dataset
        v = self.videos[idx]
        T = ds.max_seq_len
        feats = self.src(v)                      # (T_in, C)
        t_in = feats.shape[0]
        fps = float(v.get("fps", 30.0))

        if ds.force_upsampling:
            feat_stride = (
                (t_in - 1) * ds.feat_stride + ds.num_frames
            ) / T
            num_frames = feat_stride
            feats = linear_resize(feats, T)
            t_len = T
        else:
            feat_stride = ds.feat_stride * ds.downsample_rate
            num_frames = ds.num_frames
            if ds.downsample_rate > 1:
                feats = feats[:: ds.downsample_rate]
            t_len = feats.shape[0]
            if not self.is_training and t_len > T:
                # over-length EVAL clips: compress onto the static grid
                # with the effective stride recomputed (the reference
                # instead grows T to the next divisible size and linearly
                # re-interpolates the abs PE, backbones.py:229-236 — a
                # dynamic shape that would recompile per clip under jit;
                # both cover the full duration, PARITY.md)
                feat_stride = ((t_len - 1) * feat_stride + num_frames) / T
                num_frames = feat_stride
                feats = linear_resize(feats, T)
                t_len = T
            # over-length TRAIN clips keep native length here; the
            # max_seq_len random-window crop happens in truncate_feats

        # seconds -> grid coords (ego4d.py:729-733; NLQ omits the centering
        # offset, ego4d_loader.py:180-186)
        segs_raw = np.asarray(v.get("segments"), np.float32)
        if (self.is_training and ds.enable_temporal_jittering
                and segs_raw is not None and segs_raw.size):
            # NLQ temporal jittering (ego4d_loader.py:168-179): random
            # scale in [1, 10] and center shift within the grown window
            segs_raw = segs_raw.copy()
            for i, (s, e) in enumerate(segs_raw):
                dur = e - s
                center = (s + e) / 2.0
                scale = float(self._jitter_rng.integers(1, 11))
                shift = float(self._jitter_rng.uniform(-1, 1)) * (
                    scale - 1.0
                ) * dur / 2.0
                c = center - shift
                segs_raw[i] = [c - scale * dur / 2.0, c + scale * dur / 2.0]
        if segs_raw is None or segs_raw.size == 0:
            segs = np.zeros((0, 2), np.float32)
            labels = np.zeros((0,), np.int64)
        else:
            offset = 0.5 * num_frames if ds.center_offset else 0.0
            segs = (segs_raw * fps - offset) / feat_stride
            labels = np.asarray(v["labels"], np.int64)
            # drop actions (mostly) outside the feature grid (ego4d.py:737-757)
            vid_len = t_len + 0.5 * num_frames / feat_stride
            keep = []
            for i, s in enumerate(segs):
                if s[0] >= vid_len:
                    continue
                ratio = (min(s[1], vid_len) - s[0]) / max(s[1] - s[0], 1e-6)
                if ratio >= ds.trunc_thresh or not self.is_training:
                    keep.append(i)
            segs = np.clip(segs[keep], 0, vid_len)
            labels = labels[keep]

        sample = {
            "feats": feats.astype(np.float32),
            "t_len": t_len,
            "segments": segs,
            "labels": labels,
            "video_id": v["id"],
            "fps": fps,
            "duration": float(v.get("duration", t_len)),
            "feat_stride": float(feat_stride),
            "feat_num_frames": float(num_frames),
            "is_memory": bool(v.get("is_memory", False)),
            "query_key": v.get("query_key", v["id"]),
        }
        if self.text_source is not None:
            sample["text"] = self.text_source(v)
        if self.narration_source is not None:
            nar = self.narration_source(v)
            sample["narration"] = nar
            sample["narration_valid"] = nar is not None and len(nar) > 0
        return sample


def truncate_feats(
    sample: dict, max_seq_len: int, trunc_thresh: float,
    crop_ratio, rng: np.random.Generator, max_num_trials: int = 200,
):
    """Random-window truncation (data_utils.py:24-110). Two duties, like
    the reference: (a) clips longer than max_seq_len ALWAYS get cropped to
    a max_seq_len window; (b) within-limit clips optionally get a shorter
    random crop sized by crop_ratio. Windows are resampled up to
    max_num_trials until one keeps >= trunc_thresh of some action — and,
    exactly like the reference, the LAST sampled window is used even when
    no trial succeeds."""
    t_len = sample["t_len"]
    if t_len <= max_seq_len:
        if crop_ratio is None:
            return sample
        win = int(rng.integers(max(round(crop_ratio[0] * t_len), 1),
                               min(round(crop_ratio[1] * t_len), t_len) + 1))
        win = max(2, win)
        if win >= t_len:
            return sample
    else:
        win = max_seq_len
    segs = sample["segments"]
    if len(segs) == 0:
        start = int(rng.integers(0, t_len - win + 1))
        out = dict(sample)
        out["feats"] = sample["feats"][start:start + win]
        out["t_len"] = win
        return out
    for _ in range(max_num_trials):
        start = int(rng.integers(0, t_len - win + 1))
        end = start + win
        left = np.maximum(segs[:, 0], start)
        right = np.minimum(segs[:, 1], end)
        inter = np.clip(right - left, 0, None)
        ratio = inter / np.maximum(segs[:, 1] - segs[:, 0], 1e-6)
        keep = ratio >= trunc_thresh
        if keep.any():
            break
    out = dict(sample)
    out["feats"] = sample["feats"][start:end]
    out["t_len"] = win
    out["segments"] = (
        np.stack([left[keep], right[keep]], -1) - start
    ).astype(np.float32)
    out["labels"] = sample["labels"][keep]
    return out


def collate(samples: List[dict], cfg: Config) -> Dict[str, np.ndarray]:
    """Pad a list of samples into one static-shape batch."""
    ds = cfg.dataset
    B, T, N = len(samples), ds.max_seq_len, ds.max_segments
    cin = samples[0]["feats"].shape[-1]
    batch = {
        "feats": np.zeros((B, T, cin), np.float32),
        "mask": np.zeros((B, T), bool),
        "gt_segments": np.zeros((B, N, 2), np.float32),
        "gt_labels": np.zeros((B, N), np.int64),
        "gt_valid": np.zeros((B, N), bool),
        "video_idx": np.full((B,), -1, np.int64),
    }
    meta = {"video_id": [], "fps": [], "duration": [], "feat_stride": [],
            "feat_num_frames": [], "query_key": []}
    for i, s in enumerate(samples):
        t = min(s["t_len"], T)
        batch["feats"][i, :t] = s["feats"][:t]
        batch["mask"][i, :t] = True
        n = min(len(s["segments"]), N)
        if n:
            batch["gt_segments"][i, :n] = s["segments"][:n]
            batch["gt_labels"][i, :n] = s["labels"][:n]
            batch["gt_valid"][i, :n] = True
        for k in meta:
            meta[k].append(s[k])
    if "text" in samples[0]:
        L = cfg.dataset.max_text_len
        ct = samples[0]["text"].shape[-1]
        batch["text"] = np.zeros((B, L, ct), np.float32)
        batch["text_mask"] = np.zeros((B, L), bool)
        for i, s in enumerate(samples):
            l = min(len(s["text"]), L)
            batch["text"][i, :l] = s["text"][:l]
            batch["text_mask"][i, :l] = True
    if "narration" in samples[0]:
        Ln = cfg.dataset.max_narration_len
        cn = cfg.cl_cfg.narration_dim
        batch["narration"] = np.zeros((B, Ln, cn), np.float32)
        batch["narration_mask"] = np.zeros((B, Ln), bool)
        batch["narration_valid"] = np.zeros((B,), bool)
        for i, s in enumerate(samples):
            nar = s.get("narration")
            if nar is not None and len(nar):
                l = min(len(nar), Ln)
                batch["narration"][i, :l] = nar[:l]
                batch["narration_mask"][i, :l] = True
                batch["narration_valid"][i] = bool(s["narration_valid"])
    return batch, meta


class BatchIterator:
    """Deterministic, host-sharded batch stream (replaces DistributedSampler
    + DataLoader workers, datasets.py:19-40). Training epochs reshuffle with
    (seed, epoch); eval iterates in order, padding the final batch by
    repeating sample 0 with a `pad` meta flag.

    `num_workers > 0` builds batches in a thread pool and prefetches
    `prefetch` batches ahead of the consumer (feature .npz/.npy loads are
    IO-bound, so threads suffice — the reference's worker processes exist to
    dodge the GIL for torch tensor transforms we don't do host-side). Batch
    ORDER and augmentation randomness are identical for any worker count:
    each batch draws from its own rng spawned from (seed, epoch, batch)."""

    def __init__(
        self,
        dataset: ClipDataset,
        cfg: Config,
        batch_size: int,
        is_training: bool,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        num_workers: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.is_training = is_training
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.epoch = 0

    def __len__(self):
        n = (len(self.dataset) + self.num_shards - 1) // self.num_shards
        if self.is_training:
            return n // self.batch_size if n >= self.batch_size else (
                1 if n else 0
            )
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _selections(self):
        """Per-epoch list of (indices, pad_flags) in yield order."""
        n = len(self.dataset)
        if n == 0:
            return []
        rng = np.random.default_rng((self.seed, self.epoch))
        idx = np.arange(n)
        if self.is_training:
            idx = rng.permutation(n)
        idx = idx[self.shard_id :: self.num_shards]
        bs = self.batch_size
        out = []
        if self.is_training:
            n_batches = max(len(idx) // bs, 1 if len(idx) else 0)
            if len(idx) < bs:
                idx = np.resize(idx, bs)
            for b in range(n_batches):
                sel = list(idx[b * bs : (b + 1) * bs])
                out.append((sel, [False] * len(sel)))
        else:
            for b in range(0, len(idx), bs):
                sel = list(idx[b : b + bs])
                pad = [False] * len(sel)
                while len(sel) < bs:
                    sel.append(idx[0])
                    pad.append(True)
                out.append((sel, pad))
        return out

    def _build(self, sel, pad, batch_rng):
        samples = [self.dataset[i] for i in sel]
        if self.is_training:
            # no-op for within-limit clips without crop_ratio; enforces
            # the max_seq_len window crop for over-length clips
            samples = [
                truncate_feats(
                    s, self.cfg.dataset.max_seq_len,
                    self.cfg.dataset.trunc_thresh,
                    self.cfg.dataset.crop_ratio, batch_rng,
                )
                for s in samples
            ]
        batch, meta = collate(samples, self.cfg)
        meta["pad"] = pad
        return batch, meta

    def __iter__(self) -> Iterator:
        sels = self._selections()
        if not sels:
            return
        rngs = np.random.default_rng(
            (self.seed, self.epoch, 7)
        ).spawn(len(sels))
        if self.num_workers <= 0:
            for (sel, pad), r in zip(sels, rngs):
                yield self._build(sel, pad, r)
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            depth = self.prefetch + self.num_workers
            futs = [
                pool.submit(self._build, sel, pad, r)
                for (sel, pad), r in zip(sels[:depth], rngs[:depth])
            ]
            nxt = depth
            for i in range(len(sels)):
                yield futs[i % depth].result()
                if nxt < len(sels):
                    sel, pad = sels[nxt]
                    futs[nxt % depth] = pool.submit(
                        self._build, sel, pad, rngs[nxt]
                    )
                    nxt += 1
