"""Synthetic MQ and NLQ batches (vilco_tpu/data/synthetic.py::make_batch),
so the card's machine draws batches with no JAX present. The same numpy
generator gives the same batch as the JAX package's function.
`task_extras` gives a CL task's class mask, prompt slots and known classes
as the JAX episode runner sets them (vilco_tpu/cl/episode.py). `make_vq_batch` draws a VQ training batch in the layout
of vilco_tpu/train/vq_engine.py (the JAX package draws its VQ bench batch
inline, bench.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from vilco_tpu_torch.core.config import Config, VQConfig


def make_batch(rng: np.random.Generator, batch_size: int, cfg: Config,
               signal: float = 2.0) -> Dict[str, np.ndarray]:
    """Clips of noise with a class-specific bump on each of 1-4 GT
    segments, in the padded batch layout: feats (B, T, Cin) f32, mask
    (B, T), gt_segments (B, N, 2), gt_labels (B, N) int64, gt_valid
    (B, N); for the NLQ variant and a cross-modal MQ model also the text
    (B, L, n_txt_in) f32 and text_mask (B, L), 4..L tokens valid; with
    narration SSL the narration (B, Ln, narration_dim) f32,
    narration_mask (B, Ln), 1..Ln tokens valid, and narration_valid (B,),
    each True with probability 0.8; all drawn after the clips in the JAX
    function's order."""
    m = cfg.model
    T, Cin, C, N = m.max_seq_len, m.input_dim, m.num_classes, cfg.max_segments
    B = batch_size
    feats = rng.standard_normal((B, T, Cin)).astype(np.float32) * 0.5
    mask = np.zeros((B, T), bool)
    segs = np.zeros((B, N, 2), np.float32)
    labels = np.zeros((B, N), np.int64)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        t_len = int(rng.integers(T // 2, T + 1))
        mask[b, :t_len] = True
        n = int(rng.integers(1, min(4, N) + 1))
        for i in range(n):
            length = int(rng.integers(max(2, T // 64), max(3, T // 8)))
            start = int(rng.integers(0, max(1, t_len - length)))
            c = int(rng.integers(0, C))
            segs[b, i] = (start, start + length)
            labels[b, i] = c
            valid[b, i] = True
            feats[b, start:start + length, c % Cin] += signal
            feats[b, start:start + length, (c * 7 + 1) % Cin] += signal
    batch = {"feats": feats, "mask": mask, "gt_segments": segs,
             "gt_labels": labels, "gt_valid": valid}
    if m.variant == "nlq" or m.use_cross_modal:
        L = cfg.max_text_len
        batch["text"] = rng.standard_normal((B, L, m.n_txt_in)).astype(
            np.float32)
        tl = rng.integers(4, L + 1, size=B)
        batch["text_mask"] = np.arange(L)[None, :] < tl[:, None]
    if cfg.cl_cfg.narration_ssl:
        Ln = cfg.max_narration_len
        batch["narration"] = rng.standard_normal(
            (B, Ln, cfg.cl_cfg.narration_dim)).astype(np.float32)
        nl = rng.integers(1, Ln + 1, size=B)
        batch["narration_mask"] = np.arange(Ln)[None, :] < nl[:, None]
        batch["narration_valid"] = rng.random(B) < 0.8
    return batch


def task_extras(cfg: Config, task: int, batch_size: int) -> dict:
    """CL task `task` of `cfg.cl_cfg` (0-based) as the JAX episode runner
    sets it up: `class_mask` (C,) over the classes of tasks 0..task,
    `n_known` the classes of the tasks before it, and with the prompt
    pool `prompt_mask` (B, topk), the task's own slots task x topk ..
    (task + 1) x topk - 1 (None once they pass the pool's end)."""
    cl = cfg.cl_cfg
    class_mask = np.zeros(cfg.model.num_classes, bool)
    class_mask[:(task + 1) * cl.classes_per_task] = True
    prompt_mask = None
    if cl.prompt_pool and (task + 1) * cl.topk <= cl.pool_size:
        prompt_mask = np.broadcast_to(
            np.arange(task * cl.topk, (task + 1) * cl.topk)[None],
            (batch_size, cl.topk)).copy()
    return {"class_mask": class_mask, "n_known": task * cl.classes_per_task,
            "prompt_mask": prompt_mask}


def make_vq_batch(rng: np.random.Generator, batch_size: int,
                  cfg: VQConfig) -> Dict[str, np.ndarray]:
    """A VQ batch of cfg.num_frames-frame windows: clip (B, T, S, S, 3) and
    query (B, S, S, 3) frames in [0, 1), f32; per clip a track of frames
    [t0, t1) holding the object (clip_with_bbox 1, clip_bbox a normalized
    xyxy box of side 0.1-0.5 drifting across the track, zeros elsewhere)
    and a query frame after t0 (before_query 1 for the frames before it)."""
    B, T, S = batch_size, cfg.num_frames, cfg.clip_size
    clip = rng.random((B, T, S, S, 3), np.float32)
    query = rng.random((B, S, S, 3), np.float32)
    bbox = np.zeros((B, T, 4), np.float32)
    with_box = np.zeros((B, T), np.float32)
    before = np.zeros((B, T), np.float32)
    for b in range(B):
        t0 = int(rng.integers(0, T // 2))
        t1 = int(rng.integers(t0 + 1, T + 1))
        side = rng.uniform(0.1, 0.5, size=2)
        c0, c1 = (rng.uniform(side / 2, 1 - side / 2) for _ in range(2))
        for t in range(t0, t1):
            c = c0 + (c1 - c0) * (t - t0) / max(t1 - t0 - 1, 1)
            bbox[b, t] = np.concatenate([c - side / 2, c + side / 2])
            with_box[b, t] = 1.0
        before[b, :int(rng.integers(t0 + 1, T + 1))] = 1.0
    return {"clip": clip, "query": query, "clip_bbox": bbox,
            "clip_with_bbox": with_box, "before_query": before}
