"""K6's forward in plain PyTorch (`frame_band_fwd_plain`: the bf16 kernel's
walk, query tiles of 128 rows (64 where D > 64) over their window's key
tiles of 64, an online softmax from the -1e8 floor, P rounded to the input
dtype before P V) against the JAX package on the CPU, and the tile plan of
the band mode (`_window`, `_covers`) by brute force.

Where `supports` takes the shape (a test block height, as
tests/test_torch_port_frame_band_bwd.py sets it), against the Pallas
`_forward` in interpret mode, out and lse (JAX's (HP, B, L, H_blk) layout
turned to the port's (B, H, L)): fr 16 and 64, w 1 and 2, D 32 and 128.
Elsewhere (fr 7, the band wider than the clip, one frame) against
`_xla_ref`, the lse against a float64 log-sum-exp of the band's scores.
Tolerance x max(1, max |ref|), out and lse: f32 1e-5 for both (f32 on
both sides, summed in another order; the Pallas kernel scales q before its
dot, the port after). bf16: the Pallas kernel rounds q * scale * log2 e to
bf16 before its dot, the port scales the f32 dot, so each score differs by
up to 2^-9 of itself: the lse is held at 2^-8, the output (bf16, P
rounded to bf16 from those scores) at 2^-6, two bf16 units in the last
place at the largest output. tests/test_torch_port_cuda.py holds the CUDA
kernel against the plain versions on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.kernels import frame_band as j_fb
from vilco_tpu_torch.kernels import frame_band as fb

TOL = {jnp.float32: (1e-5, 1e-5), jnp.bfloat16: (2 ** -6, 2 ** -8)}


def _inputs(rng, B, L, C):
    return [rng.standard_normal((B, L, C)).astype(np.float32)
            for _ in range(3)]


def _assert_close(got, ref, tol, name):
    a, b = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    lim = tol * max(1.0, np.abs(b).max())
    assert np.abs(a - b).max() <= lim, (name, np.abs(a - b).max(), lim)


def _heads_last(x, B, H, L):
    """JAX's (HP, B, L, H_blk) residual layout -> the port's (B, H, L)."""
    return np.transpose(np.array(x), (1, 0, 3, 2)).reshape(B, H, L)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n_frames,fr,w,D,bq", [(8, 16, 1, 32, 32),
                                                (8, 16, 2, 128, 64),
                                                (6, 64, 2, 32, 128),
                                                (4, 64, 1, 128, 64)])
def test_frame_band_fwd_plain_matches_pallas_interpret(rng, n_frames, fr, w,
                                                       D, bq, dtype):
    B, C = 2, 128
    H, L = C // D, n_frames * fr
    assert j_fb.supports(L, C, H, fr, w, block_q=bq)
    q, k, v = _inputs(rng, B, L, C)
    out, lse = j_fb._forward(*(jnp.asarray(a, dtype) for a in (q, k, v)), H,
                             fr, w, bq, True)
    tq, tk, tv = (torch.from_numpy(a).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        for a in (q, k, v))
    got, got_lse = fb.frame_band_fwd_plain(tq, tk, tv, H, fr, w)
    assert got.dtype == tq.dtype and got_lse.dtype == torch.float32
    tol_out, tol_lse = TOL[dtype]
    _assert_close(got.float().numpy(), np.asarray(out, np.float32), tol_out,
                  "out")
    _assert_close(got_lse.numpy(), _heads_last(lse, B, H, L), tol_lse, "lse")


def _lse_f64(q, k, H, fr, w):
    """m + log2 sum exp2(s - m) over the band, in float64 from the f32
    inputs: (B, H, L)."""
    B, L, C = q.shape
    D = C // H
    split = lambda x: x.astype(np.float64).reshape(B, L, H, D)
    s = np.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * (
        np.log2(np.e) / np.sqrt(D))
    f = np.arange(L) // fr
    s = np.where(np.abs(f[:, None] - f[None, :]) <= w, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log2(np.exp2(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("n_frames,fr,w,H,D", [(9, 7, 2, 3, 24),
                                               (3, 16, 2, 2, 32),
                                               (1, 64, 2, 8, 32),
                                               (2, 100, 1, 1, 128),
                                               (20, 7, 0, 2, 16)])
def test_frame_band_fwd_plain_matches_xla_ref(rng, n_frames, fr, w, H, D):
    """Shapes JAX's `supports` gives to `_xla_ref`: fr 7 (frame edges
    inside every tile, L 63 and 140), the band wider than the clip (3
    frames at w 2), one frame, frames longer than a key tile (fr 100, D
    128: 64-row query tiles), w 0."""
    B, C = 2, H * D
    L = n_frames * fr
    assert not j_fb.supports(L, C, H, fr, w)
    q, k, v = _inputs(rng, B, L, C)
    ref = j_fb._xla_ref(*(jnp.asarray(a) for a in (q, k, v)), H, fr, w)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, lse = fb.frame_band_fwd_plain(tq, tk, tv, H, fr, w)
    tol_out, tol_lse = TOL[jnp.float32]
    _assert_close(got.numpy(), np.asarray(ref), tol_out, "out")
    _assert_close(lse.numpy(), _lse_f64(q, k, H, fr, w), tol_lse, "lse")
    _assert_close(lse.numpy(), fb.frame_band_lse_plain(tq, tk, H, fr,
                                                       w).numpy(),
                  tol_lse, "lse against frame_band_lse_plain")


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("fr", [7, 64, 100])
def test_frame_band_tile_plan_by_brute_force(fr, rows):
    """The band mode's plan against every pair: a block of `rows` query
    rows walks the key tiles of 64 from its window's start to its end; a
    warp (32 rows at 128-row blocks, 16 at 64) skips a tile that its own
    window misses and tests no element where `_covers` holds. For w 0-2
    and 1 to 30 frames: the walk holds every in-band pair of the block, no
    key outside it is in band for any of its rows, a tile a warp skips
    holds no in-band pair of the warp's rows, and a covered tile (also
    past the window's end or L, where the keys are staged as zeros) holds
    only in-band pairs."""
    warp_rows = rows // 4
    for w in range(3):
        for n_frames in range(1, 31):
            L = n_frames * fr
            f = np.arange(L) // fr
            band = np.abs(f[:, None] - f[None, :]) <= w
            for q0 in range(0, L, rows):
                q1 = min(q0 + rows, L)
                lo, hi = fb._window(q0, q1 - 1, L, fr, w)
                seen = band[q0:q1].any(0)
                walked = np.zeros(L, bool)
                walked[lo:hi] = True
                assert (seen <= walked).all(), (w, n_frames, q0)
                assert not seen[:lo].any() and not seen[hi:].any()
                for r0 in range(q0, q1, warp_rows):
                    r1 = min(r0 + warp_rows, L) - 1
                    wlo, whi = fb._window(r0, r1, L, fr, w)
                    for j0 in range(lo, hi, fb.FWD_KEYS):
                        j1 = j0 + fb.FWD_KEYS
                        pairs = band[r0:r1 + 1, j0:min(j1, hi)]
                        if j0 >= whi or j1 <= wlo:
                            assert not pairs.any(), (w, n_frames, r0, j0)
                        if fb._covers(r0, r1, j0, j1, L, fr, w):
                            assert j1 <= hi and pairs.all(), \
                                (w, n_frames, r0, j0)


def test_fwd_rows_follow_the_kernel_layout():
    """FwdLayout<DPAD>::BQ: two strips of 16 rows a warp up to D 64."""
    assert [fb.fwd_rows(d) for d in (8, 32, 64, 65, 96, 128)] == \
        [128, 128, 128, 64, 64, 64]
