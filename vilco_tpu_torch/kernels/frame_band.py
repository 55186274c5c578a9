"""Frame-banded attention on channels-last q/k/v, forward and backward: the
VQ spatio-temporal encoder's attention, where token i (frame i // fr) sees
every token of the frames within +-w of its own.

Replaces vilco_tpu/kernels/frame_band.py::frame_band_attention. The Pallas
`_forward` becomes the band mode of K1's forward (csrc/attention_blc.cu's
`frame_band_fwd`, built as the library attention_blc_band): the band is by
frame, so the attention is block-dense, and one block per query tile (128
rows, 64 where the head dim passes 64; two VQ frames) streams only its
window's key tiles of 64 (its own frames and w frames on either side)
through a cp.async ring and runs an f32 online softmax, S, P and O in
registers on mma.sync in bf16 (SIMT in f32, 64 rows and key tiles of 32);
keys outside the window are never staged, and a
score out of the band is -inf before the row max. `frame_band_fwd_plain`
is the same walk in plain PyTorch. The forward stores each row's
log-sum-exp (log2 domain, K1's m + log2 l). The Pallas `_backward` (the dq
and dk/dv kernels) becomes the band mode of K1's three backward passes
(csrc/attention_blc_bwd.cu):
delta = rowsum(dO * O), dk/dv by key tile over the query tiles of its
window, dq by query tile over the key tiles of its window, P = 0 where a
pair's frames are more than w apart; bf16 on mma.sync with P and dS
rounded to bf16 before their products (as the TPU kernel rounds them), f32
in SIMT; no atomics, so two calls give equal bits. `frame_band_bwd_plain`
is the same passes in plain PyTorch. Every n_frames >= 1, fr >= 1, w >= 0
and head dim <= 128 is taken on the card (the JAX version gave shapes whose
band covers the clip, or whose C is no multiple of 128, to XLA).

A CPU tensor takes `frame_band_attention_plain` (autograd through it gives
the backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build

NEG_INF = -1e9
LOG2E = 1.4426950408889634
ROWMAX_FLOOR = -1e8
BWD_TILE = 64        # the query and key tile of the backward's passes
FWD_KEYS = 64        # the key tile of the forward's walk (bf16)


def fwd_rows(head_dim: int) -> int:
    """The query rows of a block of the bf16 forward: two strips of 16 a
    warp where the head is at most 64 wide, one above."""
    return 128 if head_dim <= 64 else 64


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
    fn = _build.bind("attention_blc_band", "frame_band_fwd", 5, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, L, num_heads,
             C // num_heads, fr, w, _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "frame_band_fwd")
    frame_band_attention.launches += 1
    return out, lse


def frame_band_bwd_cuda(q, k, v, out, lse, dout, num_heads: int, fr: int,
                        w: int):
    """Launch K6's backward, K1's three passes in band mode (delta, dk/dv,
    dq), from the forward's out and lse (B, H, L) f32: (dq, dk, dv) in
    q.dtype."""
    B, L, C = q.shape
    dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, num_heads, L), dtype=torch.float32,
                        device=q.device)
    fn = _build.bind("attention_blc_bwd", "frame_band_bwd", 10, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), B, L, num_heads,
             C // num_heads, fr, w, _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "frame_band_bwd")
    frame_band_bwd_cuda.launches += 1
    return dq, dk, dv


frame_band_bwd_cuda.launches = 0


def _heads(x, H):
    """(B, L, H * D) -> (B, H, L, D) in f32 (f64 for f64 x)."""
    B, L, C = x.shape
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    return wide.reshape(B, L, H, C // H).transpose(1, 2)


def _window(r0: int, r1: int, L: int, fr: int, w: int):
    """The token range [lo, hi) that rows r0 .. r1 reach together (the
    kernels' Band::window)."""
    return max(0, r0 // fr - w) * fr, min(L // fr - 1, r1 // fr + w) * fr + fr


def _covers(r0: int, r1: int, c0: int, c1: int, L: int, fr: int, w: int):
    """Every row of r0 .. r1 sees every token of [c0, c1) (the kernels'
    Band::covers)."""
    return (max(0, r1 // fr - w) * fr <= c0
            and min(L // fr - 1, r0 // fr + w) * fr + fr >= c1)


def _band_scores(qh, kh, fr: int, w: int):
    """score(i0, i1, j0, j1): the log2-domain scores (q * scale * log2 e) . k
    of query rows i0:i1 and keys j0:j1, -inf where the frames are more than
    w apart."""
    sl2 = LOG2E / qh.shape[-1] ** 0.5
    f = torch.arange(qh.shape[2], device=qh.device) // fr

    def score(i0, i1, j0, j1):
        s = (qh[:, :, i0:i1] @ kh[:, :, j0:j1].transpose(-1, -2)) * sl2
        band = (f[i0:i1, None] - f[None, j0:j1]).abs() <= w
        return s.masked_fill(~band, float("-inf"))
    return score


def frame_band_lse_plain(q, k, num_heads: int, fr: int, w: int):
    """The forward's lse (B, H, L) in f32 (f64 for f64 inputs): m +
    log2(l), m the row max of the in-band log2-domain scores floored at
    -1e8."""
    L = q.shape[1]
    s = _band_scores(_heads(q, num_heads), _heads(k, num_heads), fr,
                     w)(0, L, 0, L)
    m = s.amax(-1).clamp(min=ROWMAX_FLOOR)
    return m + torch.log2(torch.exp2(s - m[..., None]).sum(-1))


def frame_band_fwd_plain(q, k, v, num_heads: int, fr: int, w: int):
    """Plain version of K6's forward, the bf16 kernel's walk in f32 (f64
    for f64 inputs) on channels-last tensors: query tiles of fwd_rows(D)
    rows, each over the key tiles of FWD_KEYS from its window's start, an
    online softmax from the -1e8 floor with -inf out of the band, P rounded
    to q's dtype before P V (as the TPU kernel rounds e) and l summed from
    the unrounded P. Returns (out in q.dtype, lse (B, H, L) m + log2 l)."""
    B, L, C = q.shape
    H = num_heads
    qh, kh, vh = (_heads(x, H) for x in (q, k, v))
    score = _band_scores(qh, kh, fr, w)
    bq = fwd_rows(C // H)
    out, lse = torch.empty_like(qh), qh.new_empty(qh.shape[:3])
    for i0 in range(0, L, bq):
        i1 = min(i0 + bq, L)
        lo, hi = _window(i0, i1 - 1, L, fr, w)
        m = qh.new_full((B, H, i1 - i0), ROWMAX_FLOOR)
        l, o = torch.zeros_like(m), torch.zeros_like(qh[:, :, i0:i1])
        for j0 in range(lo, hi, FWD_KEYS):
            j1 = min(j0 + FWD_KEYS, hi)
            s = score(i0, i1, j0, j1)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.to(q.dtype).to(p.dtype) \
                @ vh[:, :, j0:j1]
            m = m_new
        out[:, :, i0:i1] = o / l[..., None]
        lse[:, :, i0:i1] = m + torch.log2(l)
    return out.transpose(1, 2).reshape(B, L, C).to(q.dtype), lse


def frame_band_delta_plain(out, dout, num_heads: int):
    """Pass (a): delta = rowsum(dO * O) per (batch, head, row), (B, H, L)
    in f32 (f64 for f64 inputs)."""
    return (_heads(dout, num_heads) * _heads(out, num_heads)).sum(-1)


def frame_band_bwd_plain(q, k, v, out, lse, dout, num_heads: int, fr: int,
                         w: int):
    """Plain version of K6's backward, the kernels' three passes in f32 (f64
    for f64 inputs) on channels-last tensors: (a) delta; (b) dk, dv by key
    tile of BWD_TILE rows over the query rows of its window, in one product;
    (c) dq by query tile over the key rows of its window, scaled at the end.
    P = exp2(s - lse), 0 where the frames are more than w apart; lse (B, H,
    L) as the forward stores it. Returns (dq, dk, dv) in q.dtype."""
    B, L, C = q.shape
    H, T = num_heads, BWD_TILE
    qh, kh, vh, gh = (_heads(x, H) for x in (q, k, v, dout))
    lse = lse.to(qh.dtype)
    delta = frame_band_delta_plain(out, dout, H)
    score = _band_scores(qh, kh, fr, w)
    scale = 1.0 / qh.shape[-1] ** 0.5

    def p_ds(i0, i1, j0, j1):
        p = torch.exp2(score(i0, i1, j0, j1) - lse[:, :, i0:i1, None])
        dp = gh[:, :, i0:i1] @ vh[:, :, j0:j1].transpose(-1, -2)
        return p, p * (dp - delta[:, :, i0:i1, None])

    dq, dk, dv = (torch.zeros_like(x) for x in (qh, kh, vh))
    for j0 in range(0, L, T):
        j1 = min(j0 + T, L)
        i0, i1 = _window(j0, j1 - 1, L, fr, w)
        p, ds = p_ds(i0, i1, j0, j1)
        dv[:, :, j0:j1] = p.transpose(-1, -2) @ gh[:, :, i0:i1]
        dk[:, :, j0:j1] = ds.transpose(-1, -2) @ qh[:, :, i0:i1] * scale
    for i0 in range(0, L, T):
        i1 = min(i0 + T, L)
        j0, j1 = _window(i0, i1 - 1, L, fr, w)
        dq[:, :, i0:i1] = p_ds(i0, i1, j0, j1)[1] @ kh[:, :, j0:j1] * scale
    back = lambda x: x.transpose(1, 2).reshape(B, L, C).to(q.dtype)
    return back(dq), back(dk), back(dv)


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
        return *frame_band_bwd_cuda(*ctx.saved_tensors, dout, *ctx.args), \
            None, None, None


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
