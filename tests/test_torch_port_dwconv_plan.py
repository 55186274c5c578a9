"""K3's row walk (csrc/dwconv_qkv.cu) on the CPU: its plan and its order of
summation.

`kernels/dwconv.py::Plan` is how the kernels cut a call into walkers of
`rows` output rows. The plan must write every output row and every dx row
exactly once, count every (x row, dy row, tap) term of dw exactly once,
and read every row a walker needs (its one-row halo included): checked
here by brute force at T 1-70, 1024 and 2560, both strides (odd T at
stride 2), every `rows` the wrapper can pick and blocks of one to 16
channel columns. `walk_fwd_plain` and `walk_bwd_plain` are the walk in
plain PyTorch in the kernels' order of summation; they are held against
JAX's Pallas `_run_fwd` / `_run_bwd` and `_run_fwd_s2` / `_run_bwd_s2` in
interpret mode and against `fused_dwconv_qkv_plain` (and autograd through
it) in f32: rtol 1e-5, atol 1e-5 (dw, a sum over batch and time, 1e-4).
tests/test_torch_port_cuda.py holds the kernels against the plain version
on the card.
"""

from collections import Counter

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.dwconv as j_dw
from vilco_tpu_torch.kernels.dwconv import (
    BWD_BLOCKS,
    CH,
    ROWS,
    SMS,
    THREADS,
    VX_MAX,
    fused_dwconv_qkv_plain,
    plan,
    walk_bwd_plain,
    walk_fwd_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)
DW_TOL = dict(rtol=1e-5, atol=1e-4)


def _check_plan(B, T, C, s, kernel, rows):
    p = plan(B, T, C, s, kernel, rows)
    To = p.T_out
    assert p.groups * p.vx * CH == C and THREADS % p.vx == 0
    assert p.row_blocks * p.walkers >= B * p.tiles
    assert (p.row_blocks - 1) * p.walkers < B * p.tiles
    out, dx, terms, x_reads = Counter(), Counter(), Counter(), Counter()
    for slot in range(p.row_blocks * p.walkers):
        wk = p.walker(slot)
        if wk is None:
            assert slot >= B * p.tiles
            continue
        b, u0, u1 = wk
        rd = p.reads(slot)
        x_reads.update((b, t) for t in rd["x"])
        for u in rd["out"]:
            out[b, u] += 1
            for tap in range(3):
                t = s * u - 1 + tap
                if 0 <= t < T:        # a dw term, and a tap of the output
                    assert t in rd["x"], (slot, u, tap)
                    terms[b, u, tap] += 1
            assert u in rd["dy"]
        for t in rd["dx"]:
            dx[b, t] += 1
            for tap in range(3):     # every dy row that reaches dx row t
                u, r = divmod(t + 1 - tap, s)
                if r == 0 and 0 <= u < To:
                    assert u in rd["dy"], (slot, t, u)
    assert out == Counter({(b, u): 1 for b in range(B) for u in range(To)})
    assert dx == Counter({(b, t): 1 for b in range(B) for t in range(T)})
    assert terms == Counter({(b, u, tap): 1 for b in range(B)
                             for u in range(To) for tap in range(3)
                             if 0 <= s * u - 1 + tap < T})
    # each x row is read by its own walker and, as halo, by a neighbour
    # (by both neighbours where a walker takes one row at stride 1)
    assert set(x_reads) == {(b, t) for b in range(B) for t in range(T)}
    assert max(x_reads.values()) <= (3 if s * rows == 1 else 2)


@pytest.mark.parametrize("Ts", ["1-70", 1024, 2560])
@pytest.mark.parametrize("rows", sorted(ROWS["fwd"] + ROWS["bwd"]))
@pytest.mark.parametrize("stride", [1, 2])
def test_plan_writes_each_row_and_counts_each_term_once(Ts, rows, stride):
    """Both kernels; B 1 to 3; C 4, 8, 16, 96 and 256 give blocks of 1, 2,
    4, 8 and (the forward's) 16 channel columns."""
    for T in range(1, 71) if Ts == "1-70" else [Ts]:
        for B, C in ((2, 4), (1, 8), (3, 16), (3, 96), (2, 256)):
            for kernel in ("fwd", "bwd"):
                _check_plan(B, T, C, stride, kernel, rows)


def _flagship_calls():
    """(B, T, C, stride) of every K3 call of an MQ and an NLQ request
    (batch 16) and step (MQ batch 2, NLQ 4)."""
    calls = []
    for C, Bs, stems, T0, nb in ((1024, (16, 2), (1024,), 1024, 9),
                                 (384, (16, 4), (2560, 32), 2560, 6)):
        for B in Bs:
            calls += [(B, T, C, 1) for T in stems]
            calls += [(B, T0 >> i, C, 2) for i in range(nb)]
    return calls


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("B,T,C,s", _flagship_calls())
def test_plan_picks_the_walk_at_the_flagship_calls(B, T, C, s, kernel):
    """The forward takes the most of its rows that still gives every SM a
    block (8 at the long calls); the backward the fewest rows whose grid
    fits in one wave of BWD_BLOCKS blocks an SM, else 64. A call of
    T_out <= 8 is one short wave."""
    p = plan(B, T, C, s, kernel)
    wave = BWD_BLOCKS * SMS
    at = lambda r: plan(B, T, C, s, kernel, r).blocks
    assert p.vx == VX_MAX[kernel] and p.rows in ROWS[kernel]
    if kernel == "fwd":
        assert p.blocks >= SMS or p.rows == 1
        assert all(at(r) < SMS for r in ROWS["fwd"] if r > p.rows)
    else:
        assert p.blocks <= wave or p.rows == ROWS["bwd"][-1]
        assert all(at(r) > wave for r in ROWS["bwd"] if r < p.rows)
    if p.T_out <= 8:
        assert p.blocks <= SMS
    _check_plan(B, min(T, 256), C, s, kernel, p.rows)


def _inputs(B, T, C, s, seed):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    To = (T - 1) // s + 1
    return f(B, T, C), f(3, 3, C) * np.float32(0.3), [f(B, To, C)
                                                      for _ in range(3)]


@pytest.mark.parametrize("B,T,C,s", [(2, 16, 128, 1), (2, 37, 128, 1),
                                     (3, 128, 256, 1), (2, 32, 128, 2),
                                     (2, 74, 128, 2), (2, 256, 128, 2)])
def test_walk_matches_pallas(B, T, C, s):
    """The walk against the Pallas kernels in interpret mode: at stride 2
    the TPU's even/odd split of x outside the kernel (T even), and dx
    interleaved back from its even and odd rows, as dwconv.py's vjp
    does."""
    x, w, g = _inputs(B, T, C, s, T + s)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jg = [jnp.asarray(a) for a in g]
    if s == 1:
        refs = j_dw._run_fwd(jx, jw, True)
        rdx, rdw = j_dw._run_bwd(jx, jw, *jg, True)
    else:
        e, o = jx[:, ::2], jx[:, 1::2]
        refs = j_dw._run_fwd_s2(e, o, jw, True)
        de, do, rdw = j_dw._run_bwd_s2(e, o, jw, *jg, True)
        rdx = jnp.stack([de, do], axis=2).reshape(x.shape)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for o, r in zip(walk_fwd_plain(tx, tw, s), refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    dx, dw = walk_bwd_plain(tx, tw, *map(torch.from_numpy, g), stride=s)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), **DW_TOL)


@pytest.mark.parametrize("T", [1, 2, 3, 7, 63, 65, 70, 129])
@pytest.mark.parametrize("s", [1, 2])
def test_walk_matches_plain(T, s):
    """The walk against fused_dwconv_qkv_plain and autograd through it, at
    lengths below one walker's rows, about a tile edge and odd (stride 2:
    one dx row fewer than 2 T_out), C 24 (blocks of two channel
    columns)."""
    x, w, g = _inputs(3, T, 24, s, 100 + T)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tg = [torch.from_numpy(a) for a in g]
    for o, r in zip(walk_fwd_plain(tx, tw, s), fused_dwconv_qkv_plain(tx, tw,
                                                                      s)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), **TOL)
    xr, wr = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    torch.autograd.backward(fused_dwconv_qkv_plain(xr, wr, s), tg)
    dx, dw = walk_bwd_plain(tx, tw, *tg, stride=s)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), wr.grad.numpy(), **DW_TOL)
