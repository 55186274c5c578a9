"""Frame-banded attention on channels-last q/k/v, forward and backward: the
VQ spatio-temporal encoder's attention, where token i (frame i // fr) sees
every token of the frames within +-w of its own.

Replaces vilco_tpu/kernels/frame_band.py::frame_band_attention (the Pallas
`_forward`, and the dq and dk/dv calls of `_backward`) with
csrc/frame_band.cu. The band is by frame, so the attention is block-dense:
one block per query tile of 64 rows (one VQ frame) stages only its window's
K and V (at most 2w + 1 frames) and runs an f32 online softmax, on the
tensor cores in bf16; keys outside the window are never visited. The
backward is blocked over queries (dq) and over keys (dk/dv, over the
transposed band), with delta = rowsum(dO * O) computed once beside them:
no atomics and no accumulator over the full length. Every n_frames >= 1,
fr >= 1, w >= 0 and head dim <= 128 is taken on the card (the JAX version
gave shapes whose band covers the clip, or whose C is no multiple of 128,
to XLA).

A CPU tensor takes `frame_band_attention_plain` (autograd through it gives
the backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build

NEG_INF = -1e9


def frame_band_attention_plain(q, k, v, num_heads: int, fr: int, w: int):
    """Plain version (the JAX `_xla_ref`): dense softmax attention over the
    (B, H, L, L) scores in f32 with -1e9 outside the band, returned in
    q.dtype."""
    B, L, C = q.shape
    D = C // num_heads
    split = lambda x: x.float().reshape(B, L, num_heads, D)
    a = torch.einsum("bqhd,bkhd->bhqk", split(q) * D ** -0.5, split(k))
    f = torch.arange(L, device=q.device) // fr
    band = (f[:, None] - f[None, :]).abs() <= w
    a = torch.where(band, a, torch.full_like(a, NEG_INF)).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, split(v))
    return o.reshape(B, L, C).to(q.dtype)


def _check(q, k, v, num_heads, fr, w):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"C={q.shape[2]} not divisible by {num_heads} heads")
    if fr < 1 or w < 0 or q.shape[1] % fr:
        raise ValueError(f"L={q.shape[1]} must be n_frames * fr with fr >= 1 "
                         f"(fr={fr}) and w >= 0 (w={w})")


def _check_cuda(q, k, v, num_heads):
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("q, k and v must be on one CUDA device")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share a dtype")
    if q.shape[2] // num_heads > 128:
        raise ValueError(f"head dim {q.shape[2] // num_heads} > 128")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")


def frame_band_fwd_cuda(q, k, v, num_heads: int, fr: int, w: int,
                        with_lse: bool):
    """Launch the forward kernel: (out, lse or None); lse (B, H, L) f32 in
    the log2 domain."""
    B, L, C = q.shape
    lse = (torch.empty((B, num_heads, L), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    out = torch.empty_like(q)
    fn = _build.bind("frame_band", "frame_band_fwd", 5, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, L, num_heads,
             C // num_heads, fr, w, _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "frame_band_fwd")
    frame_band_attention.launches += 1
    return out, lse


def frame_band_delta(out, dout, num_heads: int):
    """delta = rowsum(dO * O) per (batch, head, row), (B, H, L) f32: what
    both backward kernels read beside lse."""
    B, L, C = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(B, L, num_heads, C // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


def frame_band_dq_cuda(q, k, v, lse, delta, dout, num_heads: int, fr: int,
                       w: int):
    """Launch the dq kernel: dq in q.dtype."""
    B, L, C = q.shape
    dout = dout.contiguous()
    dq = torch.empty_like(q)
    fn = _build.bind("frame_band", "frame_band_dq", 7, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, L,
             num_heads, C // num_heads, fr, w, _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "frame_band_dq")
    frame_band_dq_cuda.launches += 1
    return dq


def frame_band_dkv_cuda(q, k, v, lse, delta, dout, num_heads: int, fr: int,
                        w: int):
    """Launch the dk/dv kernel: (dk, dv) in q.dtype."""
    B, L, C = q.shape
    dout = dout.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.bind("frame_band", "frame_band_dkv", 8, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, L, num_heads, C // num_heads, fr, w, _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "frame_band_dkv")
    frame_band_dkv_cuda.launches += 1
    return dk, dv


frame_band_dq_cuda.launches = 0
frame_band_dkv_cuda.launches = 0


class _FrameBandAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, fr, w):
        out, lse = frame_band_fwd_cuda(q, k, v, num_heads, fr, w,
                                       with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (num_heads, fr, w)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        delta = frame_band_delta(out, dout, ctx.args[0])
        dq = frame_band_dq_cuda(q, k, v, lse, delta, dout, *ctx.args)
        dk, dv = frame_band_dkv_cuda(q, k, v, lse, delta, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def frame_band_attention(q, k, v, num_heads: int, fr: int, w: int):
    """q, k, v (B, L, C) with L = n_frames * fr and C = H * D, D <= 128:
    token i attends every token of the frames within +-w of frame i // fr.
    Returns (B, L, C). Differentiable in q, k, v."""
    _check(q, k, v, num_heads, fr, w)
    if q.device.type == "cpu":
        return frame_band_attention_plain(q, k, v, num_heads, fr, w)
    _check_cuda(q, k, v, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FrameBandAttention.apply(q, k, v, num_heads, fr, w)
    return frame_band_fwd_cuda(q, k, v, num_heads, fr, w, False)[0]


frame_band_attention.launches = 0
