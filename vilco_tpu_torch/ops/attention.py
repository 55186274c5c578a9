"""Dense masked attention, banded (sliding-window) attention and channel
attention (vilco_tpu/ops/attention.py).

`masked_attention` and `banded_attention` are the plain versions that the
attention kernels (kernels/attention.py, kernels/banded_attention.py) are
held against; `channel_attention` is ChannelBlock's core. All take
(B, T, H, D) heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vilco_tpu_torch.ops.masked import wide

NEG_INF = -1e9


def masked_attention(q, k, v, kv_mask):
    """Softmax attention with invalid keys at -1e9 and their values zeroed,
    so a fully masked row gives 0; invalid query rows are not zeroed.
    q (B, Tq, H, D), k/v (B, Tk, H, D), kv_mask (B, Tk) bool."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / d ** 0.5, dtype=q.dtype)
    att = wide(torch.einsum("bqhd,bkhd->bhqk", q * scale, k))
    att = att.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    att = torch.softmax(att, dim=-1).to(q.dtype)
    vm = v * kv_mask[:, :, None, None].to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, vm)


def banded_attention(q, k, v, kv_mask, window: int):
    """Sliding-window attention (LocalMaskedMHCA): query i sees keys
    [i - window, i + window]. k, v and the key mask are padded by the
    window and cut into (B, T, H, D, 2w + 1) windows; keys that are masked
    or outside [0, T) get -1e9 before an f32 softmax, masked values are
    zeroed, and invalid query rows (kv_mask doubles as the query mask) are
    zeroed. Any T >= 1 and window >= 1, the band wider than T included.
    Computed in f32, returned in q.dtype. q/k/v (B, T, H, D), kv_mask
    (B, T) bool."""
    if window < 1:
        raise ValueError(f"window {window}: the band needs window >= 1")
    w = window
    scale = 1.0 / q.shape[-1] ** 0.5
    pad = lambda x: F.pad(x, (0, 0, 0, 0, w, w))       # time axis by w
    mf = kv_mask[:, :, None, None].float()
    kw = pad(k.float()).unfold(1, 2 * w + 1, 1)         # (B, T, H, D, 2w+1)
    vw = pad(v.float() * mf).unfold(1, 2 * w + 1, 1)
    mw = F.pad(kv_mask, (w, w), value=False).unfold(1, 2 * w + 1, 1)
    s = torch.einsum("bthd,bthdj->bthj", q.float() * scale, kw)
    s = s.masked_fill(~mw[:, :, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bthj,bthdj->bthd", p, vw) * mf
    return out.to(q.dtype)


def channel_attention(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """Transposed attention over head channels (ChannelAttention).
    qkv (B, T, 3, H, Dh) -> (B, T, H, Dh)."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k = k * q.shape[-1] ** -0.5
    att = wide(torch.einsum("bthd,bthe->bhde", k, v))
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhde,bthe->bthd", att, q)
