"""Sequence (time-axis) parallelism: halo-exchange sharded sequence ops
(vilco_tpu/parallel/seq.py).

Each rank holds a (B, Ts, ...) shard of the time axis, rank r rows
[r Ts, (r+1) Ts). A banded op needs only the w rows on either side of its
shard, so ONE halo exchange with the neighbours replaces a ring pass. The
functions equal their unsharded counterparts (ops/masked.py::
masked_conv1d, ops/attention.py::banded_attention) over the whole
sequence. JAX computes them in plain jnp under shard_map; here they are
plain PyTorch over the collectives of parallel/mesh.py (the halos move by
`DataParallel.gather`, differentiable), so one code runs on NCCL, on Gloo
on the CPU and on Gloo with CUDA tensors.

Opt-in, as in JAX: sequences too long for one card's memory at the
backbone's finest level. No model path shards its time axis yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vilco_tpu_torch.ops.attention import banded_attention
from vilco_tpu_torch.ops.masked import channel_layernorm
from vilco_tpu_torch.parallel.mesh import DataParallel


def halo_exchange(x: torch.Tensor, w: int, dp: DataParallel):
    """(left, right), each (B, w, ...): `left` the LAST w rows of the
    previous rank's shard, `right` the FIRST w rows of the next's; zeros at
    the sequence's two ends (the zero padding of the unsharded ops). One
    gather of every rank's two edges; each rank builds both halos with the
    same operations, so that every rank runs the gather's backward (a
    collective) at the same point."""
    r, n = dp.rank, dp.world
    edges = dp.gather(torch.stack([x[:, :w], x[:, -w:]])[None])
    keep = lambda t, on: t & on if t.dtype == torch.bool else t * on
    return (keep(edges[(r - 1) % n, 1], r > 0),
            keep(edges[(r + 1) % n, 0], r < n - 1))


def seq_masked_conv1d(x, mask, weight, bias=None, stride: int = 1,
                      groups: int = 1, *, dp: DataParallel):
    """Time-sharded masked_conv1d: x (B, Ts, C_in), mask (B, Ts) bool,
    weight (C_out, C_in / groups, K) (Conv1d layout). A VALID conv over the
    halo-extended shard equals the SAME conv over the whole sequence;
    needs Ts % stride == 0. Returns (out (B, Ts / stride, C_out),
    out_mask)."""
    k = weight.shape[-1]
    w = k // 2
    if w > 0:
        lx, rx = halo_exchange(x, w, dp)
        x = torch.cat([lx, x, rx], 1)
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype),
                   None if bias is None else bias.to(x.dtype),
                   stride=stride, groups=groups).transpose(1, 2)
    out_mask = mask[:, ::stride] if stride > 1 else mask
    return out * out_mask[..., None].to(out.dtype), out_mask


def seq_banded_attention(q, k, v, kv_mask, window: int, *,
                         dp: DataParallel):
    """Time-sharded banded_attention: q, k, v (B, Ts, H, D), kv_mask
    (B, Ts) bool; query i sees keys [i - window, i + window] of the whole
    sequence. One w-halo exchange of k, v and the mask, then the band over
    the extended shard, whose halo rows' outputs are dropped. Needs
    Ts >= window."""
    w = window
    if not 0 < w <= q.shape[1]:
        raise ValueError(f"window {w} with a shard of {q.shape[1]} rows")
    lk, rk = halo_exchange(k, w, dp)
    lv, rv = halo_exchange(v, w, dp)
    lm, rm = halo_exchange(kv_mask, w, dp)
    pad = lambda x: F.pad(x, (0, 0, 0, 0, w, w))
    out = banded_attention(pad(q), torch.cat([lk, k, rk], 1),
                           torch.cat([lv, v, rv], 1),
                           torch.cat([lm, kv_mask, rm], 1), w)
    return out[:, w:w + q.shape[1]]


def seq_channel_layernorm(x, weight=None, bias=None, eps: float = 1e-5):
    """channel_layernorm is pointwise over time, so shard-local already;
    the alias lets time-sharded blocks read uniformly."""
    return channel_layernorm(x, weight, bias, eps)
