"""Dense masked attention, forward and backward: the channels-last kernel
(K1), the head-major one (K1n), flash attention (K1f) and the VQ attention
probe's variants (P2).

K1 replaces vilco_tpu/kernels/attention.py::fused_attention_blc (the Pallas
`_run_fwd_blc` and `_run_bwd_blc` kernels) with csrc/attention_blc.cu and
csrc/attention_blc_bwd.cu.
Forward: one block per (query tile, head, batch) reads its head's D columns
straight out of the (B, T, C) tensors and walks the keys with an online
softmax in f32, keeping the TPU kernel's -1e9 key bias and -1e8 row-max
floor, so a fully masked row gives 0. Every pyramid length is taken (the
JAX version gave T < 128 to XLA). bfloat16 runs FlashAttention-2's design
on mma.sync: Q as register fragments, K/V through a cp.async ring, S, P
and O in registers, the tensor cores' issue rate its bound; float32, the
parity path, runs SIMT and is bound by FMA issue. When a gradient is
needed the forward also stores each row's log-sum-exp (log2 domain, one f32
per row and head), so the backward does not recompute row max and sum.
Backward, three passes with no atomics (bitwise repeatable): delta =
rowsum(dO O); dk/dv by key tile, walking the query tiles (P = exp2(s -
lse), dP = dO V^T, dS = P (dP - delta), dv += P^T dO, dk += dS^T Q), the
query range cut into `dkv_splits` slices whose f32 partials are summed in
slice order where the grid is small; dq by query tile, walking the key
tiles (dq += dS K), written once in q's dtype. bfloat16 on mma.sync,
float32 SIMT. A fully masked row has P = 0 everywhere, so its gradients
are exactly 0. `attention_bwd_plain` is the same three passes in plain
PyTorch.

K1n replaces `fused_attention` (the Pallas `_run_fwd` and `_run_bwd`, the
`attention_impl="pallas_naive"` ablation): the same function on (B, T, H, D)
heads, which the TPU kernel folds to (H, B, T, D). The port folds as JAX
does and runs the K1 kernels on that head-major layout (a stride argument,
as K3 takes its stride); where JAX's `_use_kernel` says no (Tq or Tk < 128)
it takes K1 on the channels-last tensors, the same function as JAX's XLA
form.

K1f replaces `flash_attention_jax` (JAX's TPU flash-attention kernels,
`attention_impl="flash"` and the ViT's `attn_impl="flash"`) with K1's
forward and three-pass backward in flash mode, a compile-time switch of
the same kernels that keeps the library's semantics: the scale on the f32
product, -0.7 * FLT_MAX added to a masked key's score (as it is, in the
log2 domain too), no row-max floor and no 1e-30, so a fully masked row
gives the mean of v, and its gradients P = 1 / T at every key. The
(B, T, H, D) inputs are read in place as channels-last rows. The forward
stores the row max m (log2 domain) and the row sum l apart, the backward
recomputes P = exp2(s - m) / l; `flash_stats_plain` and
`flash_attention_bwd_plain` are the same in plain PyTorch. Self-attention
only; T < 128 takes K1, as JAX takes XLA.

P2 replaces tools/probe_vq_attn.py::run_variant: K1's forward with the
probe's two switches, `bound_shift` (the row max replaced by |q_scaled| *
max_j |k_j|) and `mxu_sum` (the row sum of the bf16-rounded e as a product
with ones), compile-time options of the K1 kernel.

A CPU tensor takes the plain version (autograd through it gives the
backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build
from vilco_tpu_torch.ops.attention import NEG_INF, masked_attention
from vilco_tpu_torch.ops.masked import wide

LOG2E = 1.4426950408889634
ROWMAX_FLOOR = -1e8
# JAX's flash kernel runs from this length; shorter levels take XLA there,
# K1 here. K1n takes the same rule (`_use_kernel`: Tq and Tk >= 128).
KERNEL_MIN_T = 128
# the library's DEFAULT_MASK_VALUE, added to a masked key's score
FLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# K1's backward: keys of a dk/dv block, queries of a dq block and the unit
# of a dk/dv query slice
BWD_TILE = 64
SMS = 132            # streaming multiprocessors of one H100 SXM


def fused_attention_blc_plain(q, k, v, kv_mask, num_heads: int):
    """Plain version: `masked_attention` on the (B, T, H, D) view, in f32,
    returned in q.dtype."""
    B, Tq, C = q.shape
    D = C // num_heads
    split = lambda x: x.reshape(x.shape[0], x.shape[1], num_heads, D)
    return fused_attention_plain(split(q), split(k), split(v),
                                 kv_mask).reshape(B, Tq, C)


def fused_attention_plain(q, k, v, kv_mask):
    """Plain version of K1n (and of K1 on (B, T, H, D) heads):
    `masked_attention` in f32 (f64 for f64 inputs), returned in q.dtype."""
    return masked_attention(wide(q), wide(k), wide(v),
                            kv_mask).to(q.dtype)


def dkv_splits(B: int, H: int, Tq: int, Tk: int) -> int:
    """Query slices of K1's dk/dv pass: 1 where its grid of (key tile,
    head, batch) blocks has two blocks per SM; else enough slices of whole
    BWD_TILE-row query tiles to reach two blocks per SM, at most one slice
    per tile. A function of the shape alone, so the partials' order, and
    the result's bits, are fixed."""
    cdiv = lambda a, b: -(-a // b)
    blocks = cdiv(Tk, BWD_TILE) * H * B
    if blocks >= 2 * SMS:
        return 1
    tiles = cdiv(Tq, BWD_TILE)
    per = cdiv(tiles, min(cdiv(2 * SMS, blocks), tiles))
    return cdiv(tiles, per)


def _heads_f32(x, H):
    """(B, T, H * D) -> (B, H, T, D) in f32."""
    B, T, C = x.shape
    return x.float().reshape(B, T, H, C // H).transpose(1, 2)


def attention_lse_plain(q, k, kv_mask, num_heads: int):
    """The K1 forward's lse (B, H, Tq) in f32: m + log2(l + 1e-30), m the
    row max of s = (q * scale * log2 e) . k + bias floored at -1e8."""
    qh, kh = _heads_f32(q, num_heads), _heads_f32(k, num_heads)
    sl2 = LOG2E / qh.shape[-1] ** 0.5
    s = (qh * sl2) @ kh.transpose(-1, -2) \
        + torch.where(kv_mask, 0.0, NEG_INF)[:, None, None, :]
    m = s.amax(-1).clamp(min=ROWMAX_FLOOR)
    return m + torch.log2(torch.exp2(s - m[..., None]).sum(-1) + 1e-30)


def attention_bwd_plain(q, k, v, kv_mask, out, lse, dout, num_heads: int,
                        splits: int | None = None):
    """Plain version of K1's backward, the kernels' three passes in f32 on
    channels-last tensors: (a) delta = rowsum(dO * O); (b) dk, dv over the
    query range cut into `splits` slices (default `dkv_splits`) of whole
    BWD_TILE-row tiles, the tiles of a slice in order, each slice's
    partial (dk scaled) summed in slice order; (c) dq over the key tiles
    of BWD_TILE in order, scaled at the end. lse (B, H, Tq) as the forward
    stores it. Returns (dq, dk, dv) in q.dtype."""
    score = _scores(_heads_f32(q, num_heads), _heads_f32(k, num_heads),
                    torch.where(kv_mask, 0.0, NEG_INF))
    return _three_pass_bwd(q, k, v, out, dout, num_heads, score, lse, None,
                           splits)


def _three_pass_bwd(q, k, v, out, dout, num_heads, score, shift, inv,
                    splits):
    """K1's three backward passes on channels-last tensors, from the
    log2-domain scores (`_scores`): P = exp2(score - shift) (times inv,
    where given), shift and inv per (B, H, Tq) row."""
    B, Tq, C = q.shape
    Tk, H, T = k.shape[1], num_heads, BWD_TILE
    D = C // H
    qh, kh, vh, oh, gh = (wide(x).reshape(x.shape[0], x.shape[1], H, D)
                          .transpose(1, 2) for x in (q, k, v, out, dout))
    scale = 1.0 / D ** 0.5
    delta = (gh * oh).sum(-1)                                  # (B, H, Tq)

    def p_ds(i0, i1, j0, j1):
        p = torch.exp2(score(i0, i1, j0, j1) - shift[:, :, i0:i1, None])
        if inv is not None:
            p = p * inv[:, :, i0:i1, None]
        dp = gh[:, :, i0:i1] @ vh[:, :, j0:j1].transpose(-1, -2)
        return p, p * (dp - delta[:, :, i0:i1, None])

    splits = dkv_splits(B, H, Tq, Tk) if splits is None else splits
    tiles = -(-Tq // T)
    rows = -(-tiles // splits) * T                    # rows of a slice
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for sl in range(splits):
        pk, pv = torch.zeros_like(kh), torch.zeros_like(vh)
        end = min(Tq, (sl + 1) * rows)
        for i0 in range(sl * rows, end, T):
            i1 = min(i0 + T, end)
            p, ds = p_ds(i0, i1, 0, Tk)
            pv = pv + p.transpose(-1, -2) @ gh[:, :, i0:i1]
            pk = pk + ds.transpose(-1, -2) @ qh[:, :, i0:i1]
        dk, dv = dk + pk * scale, dv + pv
    dq = torch.zeros_like(qh)
    for j0 in range(0, Tk, T):
        j1 = min(j0 + T, Tk)
        dq = dq + p_ds(0, Tq, j0, j1)[1] @ kh[:, :, j0:j1]
    back = lambda x: x.transpose(1, 2).reshape(B, x.shape[2], C).to(q.dtype)
    return back(dq * scale), back(dk), back(dv)


def flash_attention_plain(q, k, v, kv_mask):
    """Plain version of K1f with the library's semantics: s = (q k^T in
    f32) / sqrt(D), -0.7 * FLT_MAX added at masked keys, softmax in natural
    exp (a fully masked row: the mean of every v), in f32 (f64 for f64
    inputs), returned in q.dtype; T < 128 gives `masked_attention`, as
    JAX's wrapper does. q/k/v (B, T, H, D), kv_mask (B, T) bool."""
    B, T, H, D = q.shape
    if T < KERNEL_MIN_T:
        return fused_attention_plain(q, k, v, kv_mask)
    s = torch.einsum("bqhd,bkhd->bhqk", wide(q), wide(k))
    s = s * (1.0 / D ** 0.5)
    s = s + torch.where(kv_mask, 0.0, FLASH_MASK_VALUE).to(
        s.dtype)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, wide(v)).to(q.dtype)


def _scores(qh, kh, bias):
    """The log2-domain scores of (B, H, T, D) heads as K1 and K1f form
    them, tile by tile: score(i0, i1, j0, j1) = (q k^T) * scale * log2 e
    + bias (B, Tk) over query rows i0:i1 and keys j0:j1."""
    sl2 = (1.0 / qh.shape[-1] ** 0.5) * LOG2E
    b = bias.to(qh.dtype)[:, None, None, :]
    return lambda i0, i1, j0, j1: (
        qh[:, :, i0:i1] @ kh[:, :, j0:j1].transpose(-1, -2)) * sl2 \
        + b[..., j0:j1]


def _flash_scores(q, k, kv_mask):
    """K1f's scores of (B, T, H, D) q/k: the library's -0.7 * FLT_MAX at
    masked keys, in f32 (f64 for f64 q)."""
    return _scores(wide(q).transpose(1, 2), wide(k).transpose(1, 2),
                   torch.where(kv_mask, 0.0, FLASH_MASK_VALUE))


def flash_stats_plain(q, k, kv_mask):
    """The K1f forward's row statistics on (B, T, H, D) q/k, each (B, H, T):
    m, the row max of the log2-domain scores (no floor), and l = sum_j
    exp2(s_j - m) (>= 1)."""
    T = k.shape[1]
    s = _flash_scores(q, k, kv_mask)(0, q.shape[1], 0, T)
    m = s.amax(-1)
    return m, torch.exp2(s - m[..., None]).sum(-1)


def flash_attention_bwd_plain(q, k, v, kv_mask, out, m, l, dout,
                              splits: int | None = None):
    """Plain version of K1f's backward as the kernels compute it: K1's
    three passes (`attention_bwd_plain`: delta, dk/dv over `splits` query
    slices, dq over key tiles) with P = exp2(s - m) / l from the forward's
    m and l (B, H, T) and the library's masked-key value, so a fully
    masked row has P = 1 / T at every key. q/k/v/out/dout (B, T, H, D);
    returns (dq, dk, dv) in q.dtype (f32 arithmetic, f64 for f64 inputs)."""
    B, T, H, D = q.shape
    flat = lambda x: x.reshape(B, T, H * D)
    dq, dk, dv = _three_pass_bwd(
        flat(q), flat(k), flat(v), flat(out), flat(dout), H,
        _flash_scores(q, k, kv_mask), m, 1.0 / l, splits)
    return tuple(x.reshape(B, T, H, D) for x in (dq, dk, dv))


def probe_variant_plain(q, k, v, kv_mask, num_heads: int, bound_shift: bool,
                        mxu_sum: bool):
    """Plain version of P2 (tools/probe_vq_attn.py::_e_variant and
    `_fwd_kernel_v`) on channels-last q/k/v: s = (q * scale * log2 e) . k
    - 1e9 at masked keys; the shift is |q * scale * log2 e| * max_j |k_j|
    (every key of the head) with `bound_shift`, else the row max floored at
    -1e8; e = exp2(s - shift); the row sum over e rounded to q's dtype with
    `mxu_sum`, else over e; out = (e in v's dtype) . v / (sum + 1e-30).
    In f32, except those roundings (q * scale is not rounded, as K1 does
    not round it), returned in q.dtype."""
    B, Tq, C = q.shape
    D = C // num_heads
    split = lambda x: x.float().reshape(x.shape[0], x.shape[1], num_heads, D)
    qs, kk = split(q) * (LOG2E / D ** 0.5), split(k)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kk)
    s = s + torch.where(kv_mask, 0.0, NEG_INF)[:, None, None, :]
    if bound_shift:
        qn = qs.square().sum(-1).sqrt().transpose(1, 2)      # (B, H, Tq)
        kn = kk.square().sum(-1).amax(1).sqrt()              # (B, H)
        shift = (qn * kn[:, :, None])[..., None]
    else:
        shift = s.amax(-1, keepdim=True).clamp(min=ROWMAX_FLOOR)
    e = torch.exp2(s - shift)
    total = (e.to(q.dtype).float() if mxu_sum else e).sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), split(v))
    o = o * (1.0 / (total + 1e-30)).transpose(1, 2)
    return o.reshape(B, Tq, C).to(q.dtype)


def _check(q, k, v, kv_mask, num_heads):
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or kv_mask.shape != k.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(kv_mask.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"C={q.shape[2]} not divisible by {num_heads} heads")


def _check_heads(q, k, v, kv_mask):
    """(B, Tq, H, D) q against (B, Tk, H, D) k/v and a (B, Tk) mask."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:] or kv_mask.shape != k.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(kv_mask.shape)}")


def _check_cuda(q, k, v, kv_mask, head_dim):
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, kv_mask)):
        raise ValueError("q, k, v and kv_mask must be on one CUDA device")
    _build.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype or kv_mask.dtype != torch.bool:
        raise TypeError("q, k, v must share a dtype and kv_mask be bool")
    if head_dim > 128:
        raise ValueError(f"head dim {head_dim} > 128")
    if not all(t.is_contiguous() for t in (q, k, v, kv_mask)):
        raise ValueError("q, k, v and kv_mask must be contiguous")


def _fwd(q, k, v, kv_mask, B, Tq, Tk, H, D, with_lse, head_major=False,
         bound_shift=False, mxu_sum=False, flash=False):
    """One launch of the K1 forward on contiguous tensors of either layout:
    (out, lse, lsum), each statistic (B, H, Tq) f32 or None. K1 stores
    lse; flash mode (K1f) the row max m in lse's place and the row sum l
    in lsum."""
    stat = lambda: torch.empty((B, H, Tq), dtype=torch.float32,
                               device=q.device)
    lse = stat() if with_lse else None
    lsum = stat() if with_lse and flash else None
    out = torch.empty_like(q)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    # the probe's variants are a library of their own (attention_blc_probe)
    lib = ("attention_blc_probe" if bound_shift or mxu_sum
           else "attention_blc")
    fn = _build.bind(lib, "attention_blc_fwd", 7, 8)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), ptr(lse), ptr(lsum), B, Tq, Tk, H, D,
             _build.dtype_code(q), int(head_major),
             4 if flash else int(bound_shift) | 2 * int(mxu_sum),
             _build.stream_of(q))
    _build.check(err, "attention_blc_fwd")
    return out, lse, lsum


def _bwd(q, k, v, kv_mask, out, lse, dout, B, Tq, Tk, H, D,
         head_major=False, lsum=None):
    """One call of the K1 backward (delta, dk/dv, the partials' sum where
    the query range is sliced, dq): (dq, dk, dv) in q.dtype. Given `lsum`,
    flash mode (K1f): lse is then the forward's m."""
    dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    splits = dkv_splits(B, H, Tq, Tk)
    partial = (torch.empty((2, splits, *k.shape), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    fn = _build.bind("attention_blc_bwd", "attention_blc_bwd", 13, 8)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), lse.data_ptr(),
             0 if lsum is None else lsum.data_ptr(), dout.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             0 if partial is None else partial.data_ptr(), B, Tq, Tk, H, D,
             _build.dtype_code(q), int(head_major), splits,
             _build.stream_of(q))
    _build.check(err, "attention_blc_bwd")
    return dq, dk, dv


def attention_fwd_cuda(q, k, v, kv_mask, num_heads: int, with_lse: bool):
    """Launch K1's forward on channels-last q (B, Tq, C), k/v (B, Tk, C):
    (out, lse or None); lse (B, H, Tq) f32."""
    B, Tq, C = q.shape
    res = _fwd(q, k, v, kv_mask, B, Tq, k.shape[1], num_heads,
               C // num_heads, with_lse)[:2]
    fused_attention_blc.launches += 1
    return res


def attention_bwd_cuda(q, k, v, kv_mask, out, lse, dout, num_heads: int):
    """Launch K1's backward: (dq, dk, dv) in q.dtype."""
    B, Tq, C = q.shape
    res = _bwd(q, k, v, kv_mask, out, lse, dout, B, Tq, k.shape[1],
               num_heads, C // num_heads)
    attention_bwd_cuda.launches += 1
    return res


attention_bwd_cuda.launches = 0


def fused_attention_fwd_cuda(q, k, v, kv_mask, with_lse: bool):
    """Launch K1n's forward on head-major q (H, B, Tq, D), k/v (H, B, Tk,
    D): (out (H, B, Tq, D), lse (B, H, Tq) or None)."""
    H, B, Tq, D = q.shape
    res = _fwd(q, k, v, kv_mask, B, Tq, k.shape[2], H, D, with_lse,
               head_major=True)[:2]
    fused_attention.launches += 1
    return res


def fused_attention_bwd_cuda(q, k, v, kv_mask, out, lse, dout):
    """Launch K1n's backward on the head-major tensors: (dq, dk, dv)."""
    H, B, Tq, D = q.shape
    res = _bwd(q, k, v, kv_mask, out, lse, dout, B, Tq, k.shape[2], H, D,
               head_major=True)
    fused_attention_bwd_cuda.launches += 1
    return res


fused_attention_bwd_cuda.launches = 0


class _FusedAttentionBLC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, num_heads):
        out, lse = attention_fwd_cuda(q, k, v, kv_mask, num_heads,
                                      with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd_cuda(q, k, v, kv_mask, out, lse, dout,
                                        ctx.num_heads)
        return dq, dk, dv, None, None


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_attention_blc(q, k, v, kv_mask, num_heads: int):
    """K1. q (B, Tq, C), k/v (B, Tk, C), kv_mask (B, Tk) bool, C = H * D
    with D <= 128. Returns (B, Tq, C); invalid query rows are not zeroed.
    Differentiable in q, k, v."""
    _check(q, k, v, kv_mask, num_heads)
    if q.device.type == "cpu":
        return fused_attention_blc_plain(q, k, v, kv_mask, num_heads)
    _check_cuda(q, k, v, kv_mask, q.shape[2] // num_heads)
    if _wants_grad(q, k, v):
        return _FusedAttentionBLC.apply(q, k, v, kv_mask, num_heads)
    return attention_fwd_cuda(q, k, v, kv_mask, num_heads, False)[0]


fused_attention_blc.launches = 0


def _heads_via_blc(q, k, v, kv_mask):
    """(B, T, H, D) heads through K1 on their channels-last view."""
    B, Tq, H, D = q.shape
    flat = lambda x: x.reshape(x.shape[0], x.shape[1], H * D)
    return fused_attention_blc(flat(q), flat(k), flat(v), kv_mask,
                               H).reshape(B, Tq, H, D)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = fused_attention_fwd_cuda(q, k, v, kv_mask, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = fused_attention_bwd_cuda(*ctx.saved_tensors, dout)
        return dq, dk, dv, None


def fused_attention(q, k, v, kv_mask):
    """K1n. q (B, Tq, H, D), k/v (B, Tk, H, D), kv_mask (B, Tk) bool,
    D <= 128: folded to (H, B, T, D), attended there, unfolded. Tq or Tk
    < 128 takes K1 on the channels-last view. Invalid query rows are not
    zeroed. Differentiable in q, k, v."""
    _check_heads(q, k, v, kv_mask)
    if min(q.shape[1], k.shape[1]) < KERNEL_MIN_T:
        return _heads_via_blc(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, kv_mask)
    fold = lambda x: x.permute(2, 0, 1, 3).contiguous()
    qf, kf, vf = fold(q), fold(k), fold(v)
    _check_cuda(qf, kf, vf, kv_mask, q.shape[3])
    if _wants_grad(q, k, v):
        out = _FusedAttention.apply(qf, kf, vf, kv_mask)
    else:
        out = fused_attention_fwd_cuda(qf, kf, vf, kv_mask, False)[0]
    return out.permute(1, 2, 0, 3)


fused_attention.launches = 0


def flash_fwd_cuda(q, k, v, kv_mask, with_stats: bool):
    """Launch K1f's forward (K1's in flash mode) on (B, T, H, D) q/k/v:
    (out, m, l), m and l (B, H, T) f32 or None."""
    B, T, H, D = q.shape
    res = _fwd(q, k, v, kv_mask, B, T, T, H, D, with_stats, flash=True)
    flash_attention.launches += 1
    return res


def flash_bwd_cuda(q, k, v, kv_mask, out, m, l, dout):
    """Launch K1f's backward (K1's three passes in flash mode) from the
    forward's out, m and l: (dq, dk, dv) in q.dtype."""
    B, T, H, D = q.shape
    res = _bwd(q, k, v, kv_mask, out, m, dout, B, T, T, H, D, lsum=l)
    flash_bwd_cuda.launches += 1
    return res


flash_bwd_cuda.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, m, l = flash_fwd_cuda(q, k, v, kv_mask, with_stats=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        return *flash_bwd_cuda(*ctx.saved_tensors, dout), None


def flash_attention(q, k, v, kv_mask):
    """K1f. Self-attention on q/k/v (B, T, H, D) with D <= 128 (read in
    place as the channels-last (B, T, H * D) rows), kv_mask (B, T) bool.
    T < 128 takes K1. Invalid query rows are not zeroed. Differentiable in
    q, k, v."""
    _check_heads(q, k, v, kv_mask)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"flash attention is self-attention: Tq "
                         f"{q.shape[1]} != Tk {k.shape[1]}")
    if q.shape[1] < KERNEL_MIN_T:
        return _heads_via_blc(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask)
    _check_cuda(q, k, v, kv_mask, q.shape[3])
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, kv_mask)
    return flash_fwd_cuda(q, k, v, kv_mask, False)[0]


flash_attention.launches = 0


def probe_variant(q, k, v, kv_mask, num_heads: int, bound_shift: bool,
                  mxu_sum: bool):
    """P2: K1's forward on channels-last q/k/v with the probe's switches
    (both off: K1 itself). Forward only."""
    _check(q, k, v, kv_mask, num_heads)
    if q.device.type == "cpu":
        return probe_variant_plain(q, k, v, kv_mask, num_heads, bound_shift,
                                   mxu_sum)
    _check_cuda(q, k, v, kv_mask, q.shape[2] // num_heads)
    B, Tq, C = q.shape
    out = _fwd(q, k, v, kv_mask, B, Tq, k.shape[1], num_heads,
               C // num_heads, False, bound_shift=bound_shift,
               mxu_sum=mxu_sum)[0]
    probe_variant.launches += 1
    return out


probe_variant.launches = 0
