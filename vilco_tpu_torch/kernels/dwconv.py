"""Fused depthwise q/k/v convolution (K=3), forward and backward.

Replaces the Pallas kernels of vilco_tpu/kernels/dwconv.py
(`fused_dwconv_qkv`: `_run_fwd`, `_run_bwd`; `fused_dwconv_qkv_s2`:
`_run_fwd_s2`, `_run_bwd_s2`) with csrc/dwconv_qkv.cu, whose kernels take
the stride (1 or 2) as an argument. On the card they are bound by memory
traffic, and both walk rows: a thread owns 4 channels and takes `rows`
consecutive output rows of one batch element, w's taps in registers and a
window of x rows loaded once each (csrc/dwconv_qkv.cu says more). The forward writes q, k and v from one
read of x; the backward is one launch that writes dx (the transpose conv)
and dw (3, 3, C): f32 sums per walker, a partial per block added in a fixed
order, and the partials added by the last block of each channel group
(a ticket counter), so dw is the same bits on every call. `Plan` is that
cut in Python: the wrapper picks the rows a walker takes and sizes the dw
partials from it, and `walk_fwd_plain` / `walk_bwd_plain` are the walk in
plain PyTorch in the kernels' order of summation. The mask multiply stays
with the caller (MaskedMHCA), as in the JAX model.

A CPU tensor (any, in `plain_math()`) takes `fused_dwconv_qkv_plain`
(autograd through it gives the backward); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from vilco_tpu_torch.kernels import _build, takes_plain
from vilco_tpu_torch.ops.masked import wide

CH = 4                   # channels a thread owns (csrc/dwconv_qkv.cu)
THREADS = 256            # threads a block
# output rows a walker may take, per kernel
ROWS = {"fwd": (1, 2, 4, 8), "bwd": (8, 16, 32, 64)}
SMS = 132                # the H100's streaming multiprocessors
BWD_BLOCKS = 2           # backward blocks an SM holds at once
# channel columns (of CH channels) a block takes at most, per kernel
VX_MAX = {"fwd": 32, "bwd": 8}


@dataclass(frozen=True)
class Plan:
    """How csrc/dwconv_qkv.cu cuts a call. A block is `vx` channel columns
    of CH channels by `walkers` walkers; walker slot s = rb * walkers + ty
    of row block rb takes batch element s // tiles and output rows
    [u0, u0 + rows) of it, u0 = (s % tiles) * rows, cut at T_out; block
    index = rb * groups + g for channel group g. The backward's dw partial
    of row block rb is `partial[rb]` (partial_shape); dw is their sum in
    the order `walk_bwd_plain` gives."""

    B: int
    T_in: int
    C: int
    stride: int
    rows: int
    vx: int

    @property
    def T_out(self) -> int:
        return (self.T_in - 1) // self.stride + 1

    @property
    def walkers(self) -> int:
        return THREADS // self.vx

    @property
    def groups(self) -> int:
        return self.C // CH // self.vx

    @property
    def tiles(self) -> int:
        return -(-self.T_out // self.rows)

    @property
    def row_blocks(self) -> int:
        return -(-self.B * self.tiles // self.walkers)

    @property
    def blocks(self) -> int:
        return self.groups * self.row_blocks

    @property
    def partial_shape(self) -> tuple:
        return (self.row_blocks, 9, self.C)

    @property
    def slices(self) -> int:
        """The slices of row blocks the last block of a channel group sums
        its partials in: one thread a slice and a quad of CH channels."""
        return THREADS // (9 * self.vx)

    def walker(self, slot: int):
        """(b, u0, u1) of walker slot `slot`, or None for a spare slot of
        the last row block."""
        b, tile = divmod(slot, self.tiles)
        if b >= self.B:
            return None
        u0 = tile * self.rows
        return b, u0, min(u0 + self.rows, self.T_out)

    def reads(self, slot: int) -> dict:
        """The rows walker `slot` reads and writes: x rows (both kernels),
        dy rows and dx rows (the backward), output rows (the forward),
        each a range of its batch element's rows."""
        b, u0, u1 = self.walker(slot)
        s = self.stride
        return dict(
            out=range(u0, u1),
            x=range(max(0, s * u0 - 1), min(self.T_in, s * (u1 - 1) + 2)),
            dy=range(max(0, u0 - (s == 1)), min(self.T_out, u1 + 1)),
            dx=range(s * u0, min(s * u1, self.T_in)))


def plan(B: int, T_in: int, C: int, stride: int, kernel: str = "fwd",
         rows: int | None = None) -> Plan:
    """The Plan of a call of `kernel`: vx the largest power of two up to
    VX_MAX[kernel] that divides C / CH. Unless `rows` is given, the forward
    takes the most of ROWS["fwd"] that still gives every SM a block (the
    most blocks, which it balances best, since it adds nothing across
    blocks), else 1; the backward the fewest of ROWS["bwd"] whose grid
    fits in one wave of BWD_BLOCKS blocks an SM (every block at once, and
    few dw partials), else 64."""
    vx = VX_MAX[kernel]
    while (C // CH) % vx:
        vx //= 2
    if rows is not None:
        return Plan(B, T_in, C, stride, rows, vx)
    if kernel == "fwd":
        for r in reversed(ROWS["fwd"]):
            p = Plan(B, T_in, C, stride, r, vx)
            if p.blocks >= SMS:
                break
        return p
    for r in ROWS["bwd"]:
        p = Plan(B, T_in, C, stride, r, vx)
        if p.blocks <= BWD_BLOCKS * SMS:
            break
    return p


def fused_dwconv_qkv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """Plain version: three depthwise convs of x (B, T, C) with taps
    w (3, 3, C) (w[j, i] = tap i of conv j in q, k, v order), zero
    padding 1, computed in f32 and returned in x.dtype."""
    C = x.shape[-1]
    xt = wide(x).transpose(1, 2)
    # output channel j*C + c convolves copy j of x with taps w[j, :, c]
    weight = wide(w).permute(0, 2, 1).reshape(3 * C, 1, 3)
    out = F.conv1d(xt.repeat(1, 3, 1), weight, stride=stride, padding=1,
                   groups=3 * C)
    out = out.transpose(1, 2).to(x.dtype)
    return tuple(out[..., j * C:(j + 1) * C].contiguous() for j in range(3))


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors: the product exact in float64, one
    rounding to f32 (a second only where float64's own rounding of the sum
    was not already exact)."""
    return (a.double() * b.double() + c.double()).float()


def _at(x, b, r):
    """x (B, T, C) at rows (b, r), broadcast against each other, zero where
    r lies outside [0, T)."""
    ok = ((r >= 0) & (r < x.shape[1]))[..., None]
    return torch.where(ok, x[b, r.clamp(0, x.shape[1] - 1)], torch.zeros(()))


def _check_written_once(p: Plan, which: str, n_rows: int) -> None:
    """Every one of a batch element's n_rows `which` rows (out or dx) is
    written by exactly one walker of p."""
    count = torch.zeros(p.B, n_rows, dtype=torch.int64)
    for slot in range(p.B * p.tiles):
        rr = p.reads(slot)[which]
        count[p.walker(slot)[0], rr.start:rr.stop] += 1
    if not torch.all(count == 1):
        raise ValueError(f"{p}: {which} rows not written exactly once")


def walk_fwd_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """The forward kernel's walk in plain PyTorch, f32: each output row a
    chain of fmaf over taps 0, 1, 2 from 0, written by the walker that owns
    it. Returns (q, k, v)."""
    B, T, C = x.shape
    p = plan(B, T, C, stride, "fwd")
    _check_written_once(p, "out", p.T_out)
    xf, wf = x.float(), w.float()
    b, u = torch.arange(B)[:, None], torch.arange(p.T_out)[None]
    taps = [_at(xf, b, stride * u - 1 + tap) for tap in range(3)]
    outs = []
    for j in range(3):
        acc = torch.zeros(B, p.T_out, C)
        for tap in range(3):
            acc = _fma(taps[tap], wf[j, tap], acc)
        outs.append(acc)
    return tuple(outs)


def walk_bwd_plain(x: torch.Tensor, w: torch.Tensor, dq, dk, dv,
                   stride: int = 1):
    """The backward kernel's walk in plain PyTorch, f32. dx row t sums its
    terms dy_j[u] w[j, tap] (s u - 1 + tap = t) by dy row u, then by j, in a
    chain of fmaf from 0; dw sums x[s u - 1 + tap] dy_j[u] by fmaf over each
    walker's rows in order, then over the walkers of a warp as a butterfly
    (pairs of neighbours, then pairs of pairs), then over a block's warps
    in order, then over the row blocks: slice k of `slices` adds row blocks
    k, k + slices, ... in order, and the slices are added in order. Returns
    (dx, dw)."""
    B, T, C = x.shape
    s = stride
    p = plan(B, T, C, s, "bwd")
    _check_written_once(p, "dx", T)
    xf, wf = x.float(), w.float()
    dys = [g.float() for g in (dq, dk, dv)]

    t = torch.arange(T)
    u_lo = -((1 - t) // s)              # the first dy row that reaches t
    dx = torch.zeros(B, T, C)
    for du in range(4 - s):
        u = u_lo + du
        tap = t + 1 - s * u
        ok = ((tap >= 0) & (tap <= 2))[None, :, None]
        for j in range(3):
            wt = wf[j][tap.clamp(0, 2)][None]
            new = _fma(_at(dys[j], torch.arange(B)[:, None], u[None]), wt, dx)
            dx = torch.where(ok, new, dx)

    # dw: each walker over its rows in order, all walkers at once
    n = p.row_blocks * p.walkers
    wk = [p.walker(i) or (0, 0, 0) for i in range(n)]
    b = torch.tensor([v[0] for v in wk])
    u0 = torch.tensor([v[1] for v in wk])
    u1 = torch.tensor([v[2] for v in wk])
    acc = torch.zeros(n, 9, C)
    for k in range(p.rows):
        u = u0 + k
        live = (u < u1)[:, None]
        for j in range(3):
            dyr = _at(dys[j], b, u)
            for tap in range(3):
                xr = _at(xf, b, s * u - 1 + tap)
                e = j * 3 + tap
                acc[:, e] = torch.where(live, _fma(xr, dyr, acc[:, e]),
                                        acc[:, e])
    nw = 32 // p.vx                       # walkers of a warp
    acc = acc.reshape(p.row_blocks, THREADS // 32, nw, 9, C)
    while acc.shape[2] > 1:               # the shuffle butterfly
        acc = acc[:, :, 0::2] + acc[:, :, 1::2]
    part = acc[:, 0, 0]
    for wp in range(1, THREADS // 32):    # warps in order
        part = part + acc[:, wp, 0]
    sums = []                             # slice k: row blocks k, k + n, ...
    for k in range(min(p.slices, p.row_blocks)):
        sk = torch.zeros(9, C)
        for rb in range(k, p.row_blocks, p.slices):
            sk = sk + part[rb]
        sums.append(sk)
    dw = sums[0]
    for sk in sums[1:]:                   # then the slices in order
        dw = dw + sk
    return dx, dw.reshape(3, 3, C)


def fused_dwconv_qkv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """(q, k, v), each (B, (T - 1) // stride + 1, C) in x.dtype;
    differentiable in x and w."""
    if x.dim() != 3 or w.shape != (3, 3, x.shape[-1]):
        raise ValueError(f"x (B, T, C) and w (3, 3, C) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if takes_plain(x):
        return fused_dwconv_qkv_plain(x, w, stride)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x on {x.device} and w on {w.device}: both must "
                         "be on one CUDA device (or on the CPU)")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}")
    B, T, C = x.shape
    _build.dtype_code(x)
    if C % (16 // x.element_size()):
        raise ValueError(f"C={C} must be a multiple of "
                         f"{16 // x.element_size()} for 16-byte accesses")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FusedDWConv.apply(x, w, stride)
    return dwconv_fwd_cuda(x, w, stride)


def dwconv_fwd_cuda(x, w, stride: int):
    B, T, C = x.shape
    p = plan(B, T, C, stride, "fwd")
    q, k, v = (torch.empty((B, p.T_out, C), dtype=x.dtype, device=x.device)
               for _ in range(3))
    fn = _build.bind("dwconv_qkv", "dwconv_qkv_fwd", 5, 9)
    err = fn(x.data_ptr(), w.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), B, T, p.T_out, C, stride, p.rows, p.vx,
             p.row_blocks, _build.dtype_code(x), _build.stream_of(x))
    _build.check(err, "dwconv_qkv_fwd")
    fused_dwconv_qkv.launches += 1
    return q, k, v


def _scratch(p: Plan, device) -> tuple:
    """The backward's scratch, owned by the call: the dw partials (f32,
    p.partial_shape) and after them one int32 ticket per channel group,
    in one allocation. The tickets are zeroed here, each call (a memset
    node in a captured CUDA graph), so calls on several streams at once,
    or a graph's replays beside eager calls, share no counter. The last
    block of each group leaves its ticket at row_blocks."""
    n = math.prod(p.partial_shape)
    buf = torch.empty(n + -(-p.groups // 4) * 4, dtype=torch.float32,
                      device=device)
    tickets = buf[n:].view(torch.int32)[:p.groups]
    tickets.zero_()
    return buf[:n].view(p.partial_shape), tickets


def dwconv_bwd_cuda(x, w, dq, dk, dv, stride: int):
    """(dx in x.dtype, dw in w.dtype) from the three output gradients, in
    one kernel launch."""
    B, T, C = x.shape
    p = plan(B, T, C, stride, "bwd")
    dq, dk, dv = (g.contiguous() for g in (dq, dk, dv))
    if any(g.shape != (B, p.T_out, C) or g.dtype != x.dtype
           or g.data_ptr() % 16 for g in (dq, dk, dv)):
        raise ValueError("output gradients must match the forward outputs "
                         "and be 16-byte aligned")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    partial, tickets = _scratch(p, x.device)
    fn = _build.bind("dwconv_qkv", "dwconv_qkv_bwd", 9, 9)
    err = fn(x.data_ptr(), w.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
             tickets.data_ptr(), B, T, p.T_out, C,
             stride, p.rows, p.vx, p.row_blocks, _build.dtype_code(x),
             _build.stream_of(x))
    _build.check(err, "dwconv_qkv_bwd")
    dwconv_bwd_cuda.launches += 1
    return dx, dw


class _FusedDWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return dwconv_fwd_cuda(x, w, stride)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, w = ctx.saved_tensors
        dx, dw = dwconv_bwd_cuda(x, w, dq, dk, dv, ctx.stride)
        return dx, dw, None


fused_dwconv_qkv.launches = 0
dwconv_bwd_cuda.launches = 0
