"""Sliding-window (banded) attention on channels-last q/k/v, forward and
backward.

Replaces vilco_tpu/kernels/banded_attention.py::banded_attention_fused (the
Pallas `_forward`, and the dq and dk/dv passes of `_backward`) with
csrc/banded_attention.cu: a block stages the key and value rows of its
64-row tile's band in shared memory by 16-byte cp.async, four lanes own a
row (a warp holds eight), and the row's 2w + 1 scores stay in registers for
an f32 softmax in two passes. The backward is one launch that writes dq, dk
and dv: the block stages q, k, v, dO, lse and delta of its halo rows and
each row group writes its query's dq and its key's dk, dv, recomputing p
and ds from shared memory, with no atomics and nothing accumulated over the
full T. Every T and window >= 1 is taken on the card: no length threshold
and no block-alignment fallback.

A CPU tensor (any, in `plain_math()`) takes `banded_attention_blc_plain`
(autograd through it gives the backward); a CUDA tensor launches the
kernels or raises. `banded_lse_plain` and `banded_attention_bwd_plain` are
the forward's lse and the backward's passes in plain PyTorch, which the
tests and chip_smoke.py hold the kernels to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vilco_tpu_torch.kernels import _build, takes_plain
from vilco_tpu_torch.ops.attention import NEG_INF, banded_attention


def banded_attention_blc_plain(q, k, v, kv_mask, num_heads: int,
                               window: int):
    """Plain version: `banded_attention` on the (B, T, H, D) view, in f32,
    returned in q.dtype."""
    B, T, C = q.shape
    D = C // num_heads
    split = lambda x: x.float().reshape(B, T, num_heads, D)
    out = banded_attention(split(q), split(k), split(v), kv_mask, window)
    return out.reshape(B, T, C).to(q.dtype)


def _windows(x, w: int):
    """(B, T, ...) -> (B, T, ..., 2w + 1): slot s of row i is row i - w + s
    of x, zero (False) outside [0, T)."""
    return F.pad(x, [0, 0] * (x.dim() - 2) + [w, w]).unfold(1, 2 * w + 1, 1)


def _work_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _band_scores(q, k, kv_mask, num_heads: int, w: int):
    """(B, T, H, 2w + 1) scores in f32 (f64 for f64 inputs): slot s of row i
    is (q_i * scale) . k_j for the key j = i - w + s, -1e9 where j is masked
    or outside [0, T)."""
    B, T, C = q.shape
    D = C // num_heads
    dt = _work_dtype(q)
    qh = q.to(dt).reshape(B, T, num_heads, D) * (1.0 / D ** 0.5)
    kw = _windows(k.to(dt).reshape(B, T, num_heads, D), w)
    s = torch.einsum("bthd,bthdj->bthj", qh, kw)
    return s.masked_fill(~_windows(kv_mask, w)[:, :, None, :], NEG_INF)


def banded_lse_plain(q, k, kv_mask, num_heads: int, window: int):
    """The forward's lse (B, H, T), natural log, in f32 (f64 for f64
    inputs): m + log(sum exp(s - m)) over the row's 2w + 1 band slots."""
    s = _band_scores(q, k, kv_mask, num_heads, window)
    m = s.amax(-1)
    lse = m + torch.log(torch.exp(s - m[..., None]).sum(-1))
    return lse.transpose(1, 2).contiguous()


def banded_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout,
                               num_heads: int, window: int):
    """Plain version of K5's backward, the kernel's passes in f32 (f64 for
    f64 inputs) on channels-last tensors, from the forward's out and lse
    (B, H, T): delta_i = dO_i . o_i with dO zeroed at invalid queries;
    p_ij = exp(s_ij - lse_i), dp_ij = dO_i . v_j with v zeroed at masked
    keys, ds = p (dp - delta); dq_i = scale sum_j ds_ij k_j, dk_j = scale
    sum_i ds_ij q_i, dv_j = sum_i p_ij dO_i, both 0 at masked keys. Returns
    (dq, dk, dv) in q.dtype."""
    B, T, C = q.shape
    H, w = num_heads, window
    D = C // H
    dt = _work_dtype(q)
    mf = kv_mask[:, :, None, None].to(dt)
    heads = lambda x: x.to(dt).reshape(B, T, H, D)
    qh, kh, vh, gh = heads(q), heads(k), heads(v) * mf, heads(dout) * mf
    delta = (gh * heads(out)).sum(-1)                          # (B, T, H)
    p = torch.exp(_band_scores(q, k, kv_mask, H, w)
                  - lse.to(dt).transpose(1, 2)[..., None])
    dp = torch.einsum("bthd,bthdj->bthj", gh, _windows(vh, w))
    ds = p * (dp - delta[..., None])
    scale = 1.0 / D ** 0.5
    dq = torch.einsum("bthj,bthdj->bthd", ds, _windows(kh, w)) * scale
    # slot s of query row i is key i - w + s: row i + s of a w-padded sum
    dk = torch.zeros(B, T + 2 * w, H, D, dtype=dt, device=q.device)
    dv = torch.zeros_like(dk)
    for s in range(2 * w + 1):
        dk[:, s:s + T] += ds[..., s, None] * qh
        dv[:, s:s + T] += p[..., s, None] * gh
    dk = dk[:, w:w + T] * scale * mf
    dv = dv[:, w:w + T] * mf
    back = lambda x: x.reshape(B, T, C).to(q.dtype)
    return back(dq), back(dk), back(dv)


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


def banded_bwd_cuda(q, k, v, kv_mask, out, lse, dout, num_heads: int,
                    window: int):
    """Launch the backward kernel, one launch: (dq, dk, dv) in q.dtype."""
    B, T, C = q.shape
    dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.bind("banded_attention", "banded_attention_bwd", 10, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, T, num_heads, C // num_heads,
             window, _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "banded_attention_bwd")
    banded_bwd_cuda.launches += 1
    return dq, dk, dv


banded_bwd_cuda.launches = 0


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
        dq, dk, dv = banded_bwd_cuda(q, k, v, kv_mask, out, lse, dout,
                                     ctx.num_heads, ctx.window)
        return dq, dk, dv, None, None, None


def banded_attention_blc(q, k, v, kv_mask, num_heads: int, window: int):
    """q, k, v (B, T, C), kv_mask (B, T) bool (also the query mask),
    C = H * D with D <= 128, window >= 1: query i sees keys [i - window,
    i + window]. Returns (B, T, C) with invalid query rows zeroed.
    Differentiable in q, k, v."""
    _check(q, k, v, kv_mask, num_heads, window)
    if takes_plain(q):
        return banded_attention_blc_plain(q, k, v, kv_mask, num_heads, window)
    _check_cuda(q, k, v, kv_mask, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandedAttentionBLC.apply(q, k, v, kv_mask, num_heads, window)
    return banded_fwd_cuda(q, k, v, kv_mask, num_heads, window, False)[0]


banded_attention_blc.launches = 0
