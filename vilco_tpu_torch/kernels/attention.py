"""Masked softmax attention on channels-last q/k/v, forward and backward.

Replaces vilco_tpu/kernels/attention.py::fused_attention_blc (the Pallas
`_run_fwd_blc` and `_run_bwd_blc` kernels) with csrc/attention_blc.cu.

Forward: one block per (query tile, head, batch) reads its head's D columns
straight out of the (B, T, C) tensors and walks the keys with an online
softmax in f32, keeping the TPU kernel's -1e9 key bias and -1e8 row-max
floor, so a fully masked row gives 0. Every pyramid length is taken (the
JAX version gave T < 128 to XLA). bfloat16 runs its two products on the
tensor cores (WMMA) through shared memory, which bounds it; float32, the
parity path, runs SIMT and is bound by FMA issue. When a gradient is
needed the forward also stores each row's log-sum-exp (log2 domain, one f32
per row and head), so the backward does not recompute row max and sum.

Backward: one block per (key tile, head, batch) holds its dk and dv in f32
registers and walks the query tiles: P = exp2(s - lse), dP = dO V^T,
dS = P (dP - rowsum(dO O)), dv += P^T dO, dk += dS^T Q, and dq += dS K by
f32 atomics into an f32 buffer (no second pass over the scores). SIMT in
f32 for both dtypes, bound by shared-memory operand traffic. A fully
masked row has P = 0 everywhere, so its gradients are exactly 0.

A CPU tensor takes `fused_attention_blc_plain` (autograd through it gives
the backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from vilco_tpu_torch.kernels import _build
from vilco_tpu_torch.ops.attention import masked_attention


def fused_attention_blc_plain(q, k, v, kv_mask, num_heads: int):
    """Plain version: `masked_attention` on the (B, T, H, D) view, in f32,
    returned in q.dtype."""
    B, Tq, C = q.shape
    D = C // num_heads
    split = lambda x: x.float().reshape(x.shape[0], x.shape[1], num_heads, D)
    out = masked_attention(split(q), split(k), split(v), kv_mask)
    return out.reshape(B, Tq, C).to(q.dtype)


def _check(q, k, v, kv_mask, num_heads):
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or kv_mask.shape != k.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(kv_mask.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"C={q.shape[2]} not divisible by {num_heads} heads")


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


def attention_fwd_cuda(q, k, v, kv_mask, num_heads: int, with_lse: bool):
    """Launch the forward kernel: (out, lse or None); lse (B, H, Tq) f32."""
    B, Tq, C = q.shape
    lse = (torch.empty((B, num_heads, Tq), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    out = torch.empty_like(q)
    fn = _build.bind("attention_blc", "attention_blc_fwd", 6, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), 0 if lse is None else lse.data_ptr(), B, Tq,
             k.shape[1], num_heads, C // num_heads, _build.dtype_code(q),
             _build.stream_of(q))
    _build.check(err, "attention_blc_fwd")
    fused_attention_blc.launches += 1
    return out, lse


def attention_bwd_cuda(q, k, v, kv_mask, out, lse, dout, num_heads: int):
    """Launch the backward kernel: (dq, dk, dv) in q.dtype."""
    B, Tq, C = q.shape
    dout = dout.contiguous()
    f32 = q.dtype == torch.float32
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.bind("attention_blc", "attention_blc_bwd", 10, 6)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
             out.data_ptr(), lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Tq, k.shape[1], num_heads,
             C // num_heads, _build.dtype_code(q), _build.stream_of(q))
    _build.check(err, "attention_blc_bwd")
    attention_bwd_cuda.launches += 1
    return (dq if f32 else dq.to(q.dtype)), dk, dv


attention_bwd_cuda.launches = 0


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


def fused_attention_blc(q, k, v, kv_mask, num_heads: int):
    """q (B, Tq, C), k/v (B, Tk, C), kv_mask (B, Tk) bool, C = H * D with
    D <= 128. Returns (B, Tq, C); invalid query rows are not zeroed.
    Differentiable in q, k, v."""
    _check(q, k, v, kv_mask, num_heads)
    if q.device.type == "cpu":
        return fused_attention_blc_plain(q, k, v, kv_mask, num_heads)
    _check_cuda(q, k, v, kv_mask, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttentionBLC.apply(q, k, v, kv_mask, num_heads)
    return attention_fwd_cuda(q, k, v, kv_mask, num_heads, False)[0]


fused_attention_blc.launches = 0
