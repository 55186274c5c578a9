"""Synthetic MQ and NLQ batches (vilco_tpu/data/synthetic.py::make_batch
without the narration extras), so the card's machine draws batches with no
JAX present. The same numpy generator gives the same batch as the JAX
package's function."""

from __future__ import annotations

from typing import Dict

import numpy as np

from vilco_tpu_torch.core.config import Config


def make_batch(rng: np.random.Generator, batch_size: int, cfg: Config,
               signal: float = 2.0) -> Dict[str, np.ndarray]:
    """Clips of noise with a class-specific bump on each of 1-4 GT
    segments, in the padded batch layout: feats (B, T, Cin) f32, mask
    (B, T), gt_segments (B, N, 2), gt_labels (B, N) int64, gt_valid
    (B, N); for the NLQ variant also the query text (B, L, n_txt_in) f32
    and text_mask (B, L), 4..L tokens valid, drawn after the clips as the
    JAX function draws them."""
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
    if m.variant == "nlq":
        L = cfg.max_text_len
        batch["text"] = rng.standard_normal((B, L, m.n_txt_in)).astype(
            np.float32)
        tl = rng.integers(4, L + 1, size=B)
        batch["text_mask"] = np.arange(L)[None, :] < tl[:, None]
    return batch
