"""Sliding-window (banded) attention on channels-last q/k/v, forward and
backward.

Replaces vilco_tpu/kernels/banded_attention.py::banded_attention_fused (the
Pallas `_forward`, and the dq and dk/dv passes of `_backward`) with
csrc/banded_attention.cu: one warp per query (forward, dq) or key (dk/dv),
the lanes splitting the head dim, an f32 online softmax over the 2w + 1
keys of the band, the rows of the block's halo staged in shared memory.
Memory-bound by design: 2w + 1 dot products per query leave no tile for
the tensor cores. The backward is blocked over queries (dq) and over keys
(dk/dv, the query halo [j - w, j + w] staged), so nothing accumulates over
the full T and no atomics are used. Every T and window >= 1 is taken on the
card: no length threshold and no block-alignment fallback.

A CPU tensor takes `banded_attention_blc_plain` (autograd through it gives
the backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build
from vilco_tpu_torch.ops.attention import banded_attention


def banded_attention_blc_plain(q, k, v, kv_mask, num_heads: int,
                               window: int):
    """Plain version: `banded_attention` on the (B, T, H, D) view, in f32,
    returned in q.dtype."""
    B, T, C = q.shape
    D = C // num_heads
    split = lambda x: x.float().reshape(B, T, num_heads, D)
    out = banded_attention(split(q), split(k), split(v), kv_mask, window)
    return out.reshape(B, T, C).to(q.dtype)


def _check(q, k, v, kv_mask, num_heads, window):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape \
            or kv_mask.shape != q.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(kv_mask.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"C={q.shape[2]} not divisible by {num_heads} heads")
    if window < 1:
        raise ValueError(f"window {window}: the band needs window >= 1")


def _check_cuda(q, k, v, kv_mask, num_heads):
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, kv_mask)):
        raise ValueError("q, k, v and kv_mask must be on one CUDA device")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype or kv_mask.dtype != torch.bool:
        raise TypeError("q, k, v must share a dtype and kv_mask be bool")
    if q.shape[2] // num_heads > 128:
        raise ValueError(f"head dim {q.shape[2] // num_heads} > 128")
    if not all(t.is_contiguous() for t in (q, k, v, kv_mask)):
        raise ValueError("q, k, v and kv_mask must be contiguous")


def banded_fwd_cuda(q, k, v, kv_mask, num_heads: int, window: int,
                    with_lse: bool):
    """Launch the forward kernel: (out, lse or None); lse (B, H, T) f32."""
    B, T, C = q.shape
    lse = (torch.empty((B, num_heads, T), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    out = torch.empty_like(q)
    fn = _build.bind("banded_attention", "banded_attention_fwd", 6, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, T,
             num_heads, C // num_heads, window, _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "banded_attention_fwd")
    banded_attention_blc.launches += 1
    return out, lse


def banded_dq_cuda(q, k, v, kv_mask, out, lse, dout, num_heads: int,
                   window: int):
    """Launch the dq kernel: dq in q.dtype."""
    B, T, C = q.shape
    dout = dout.contiguous()
    dq = torch.empty_like(q)
    fn = _build.bind("banded_attention", "banded_attention_dq", 8, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
             B, T, num_heads, C // num_heads, window, _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "banded_attention_dq")
    banded_dq_cuda.launches += 1
    return dq


def banded_dkv_cuda(q, k, v, kv_mask, out, lse, dout, num_heads: int,
                    window: int):
    """Launch the dk/dv kernel: (dk, dv) in q.dtype."""
    B, T, C = q.shape
    dout = dout.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.bind("banded_attention", "banded_attention_dkv", 9, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, T, num_heads, C // num_heads, window,
             _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "banded_attention_dkv")
    banded_dkv_cuda.launches += 1
    return dk, dv


banded_dq_cuda.launches = 0
banded_dkv_cuda.launches = 0


class _BandedAttentionBLC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads, window):
        out, lse = banded_fwd_cuda(q, k, v, kv_mask, num_heads, window,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.num_heads, ctx.window = num_heads, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        args = (q, k, v, kv_mask, out, lse, dout, ctx.num_heads, ctx.window)
        dq = banded_dq_cuda(*args)
        dk, dv = banded_dkv_cuda(*args)
        return dq, dk, dv, None, None, None


def banded_attention_blc(q, k, v, kv_mask, num_heads: int, window: int):
    """q, k, v (B, T, C), kv_mask (B, T) bool (also the query mask),
    C = H * D with D <= 128, window >= 1: query i sees keys [i - window,
    i + window]. Returns (B, T, C) with invalid query rows zeroed.
    Differentiable in q, k, v."""
    _check(q, k, v, kv_mask, num_heads, window)
    if q.device.type == "cpu":
        return banded_attention_blc_plain(q, k, v, kv_mask, num_heads, window)
    _check_cuda(q, k, v, kv_mask, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandedAttentionBLC.apply(q, k, v, kv_mask, num_heads, window)
    return banded_fwd_cuda(q, k, v, kv_mask, num_heads, window, False)[0]


banded_attention_blc.launches = 0
