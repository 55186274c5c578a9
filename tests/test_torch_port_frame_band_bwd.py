"""K6's backward in plain PyTorch (`frame_band_bwd_plain`: delta, dk/dv by
key tile of 64 over its window, dq by query tile over its window; the
passes the CUDA kernels run, in band mode of K1's backward) against the JAX
package on the CPU, in f32.

Where `supports` takes the shape (block_q as the forward's tests in
tests/test_torch_port_frame_band.py set it), against the Pallas
`_backward` in interpret mode, fed by `_forward`'s out and lse (JAX's
(HP, B, L, H_blk) layout turned to the port's (B, H, L)); delta against
the one JAX's dq kernel reads. Elsewhere
(the band wider than the clip, fr 7 and 100, w 0, D 128, L no multiple of
64) against `jax.vjp` of `frame_band_attention` (its XLA form), from the
port's plain lse. Frame edges fall inside the 64-row tiles in every case
but the one-frame clip. Tolerance 1e-5 x max(1, max |ref|): f32 on both
sides, summed in another order. tests/test_torch_port_cuda.py holds the
CUDA kernels against `frame_band_bwd_plain` on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.kernels import frame_band as j_fb
from vilco_tpu_torch.kernels import _build
from vilco_tpu_torch.kernels import frame_band as fb

TOL = 1e-5


def _inputs(rng, B, L, C):
    return [rng.standard_normal((B, L, C)).astype(np.float32)
            for _ in range(4)]


def _assert_close(got, ref, name):
    a, b = np.asarray(got), np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    lim = TOL * max(1.0, np.abs(b).max())
    assert np.abs(a - b).max() <= lim, (name, np.abs(a - b).max(), lim)


def _heads_last(x, B, H, L):
    """JAX's (HP, B, L, H_blk) residual layout -> the port's (B, H, L)."""
    return np.transpose(np.array(x), (1, 0, 3, 2)).reshape(B, H, L)


@pytest.mark.parametrize("n_frames,fr,w,H", [(6, 8, 1, 2), (8, 8, 2, 2),
                                             (7, 16, 2, 2), (10, 8, 2, 4)])
def test_frame_band_bwd_plain_matches_pallas_interpret(rng, monkeypatch,
                                                       n_frames, fr, w, H):
    B, C = 2, 128
    L = n_frames * fr
    bq = fr if fr >= 16 else 2 * fr
    assert j_fb.supports(L, C, H, fr, w, block_q=bq)
    q, k, v, g = _inputs(rng, B, L, C)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))

    seen = {}
    real = j_fb.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            seen[kw.get("name")] = args
            return call(*args)
        return run

    monkeypatch.setattr(j_fb.pl, "pallas_call", spy)
    out, lse = j_fb._forward(jq, jk, jv, H, fr, w, bq, True)
    refs = j_fb._backward(jq, jk, jv, H, fr, w, bq, out, lse, jg, True)
    lse_p = torch.from_numpy(_heads_last(lse, B, H, L))
    out_p = torch.from_numpy(np.array(out))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = fb.frame_band_bwd_plain(tq, tk, tv, out_p, lse_p, tg, H, fr, w)
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        _assert_close(a.numpy(), b, name)
    _assert_close(fb.frame_band_delta_plain(out_p, tg, H).numpy(),
                  _heads_last(seen["frame_band_dq"][5], B, H, L), "delta")
    _assert_close(fb.frame_band_lse_plain(tq, tk, H, fr, w).numpy(),
                  lse_p.numpy(), "lse")


@pytest.mark.parametrize("n_frames,fr,w,H,D", [(3, 8, 2, 2, 32),
                                               (5, 7, 2, 3, 24),
                                               (1, 64, 2, 8, 32),
                                               (4, 5, 0, 2, 16),
                                               (2, 9, 1, 1, 128),
                                               (3, 100, 1, 2, 128)])
def test_frame_band_bwd_plain_matches_jax_vjp(rng, n_frames, fr, w, H, D):
    """Shapes JAX's `supports` gives to `_xla_ref`: the band wider than the
    clip, fr 7 and 100 (frame edges inside a 64-row tile, L 35 and 300 no
    multiple of 64), one frame, w 0, one head of 128."""
    B, C = 2, H * D
    L = n_frames * fr
    assert not j_fb.supports(L, C, H, fr, w)
    q, k, v, g = _inputs(rng, B, L, C)
    out, vjp = jax.vjp(
        lambda *a: j_fb.frame_band_attention(*a, H, fr, w),
        *(jnp.asarray(a) for a in (q, k, v)))
    refs = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out_p = torch.from_numpy(np.array(out))
    got = fb.frame_band_bwd_plain(tq, tk, tv, out_p,
                                  fb.frame_band_lse_plain(tq, tk, H, fr, w),
                                  tg, H, fr, w)
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        _assert_close(a.numpy(), b, name)
    delta = (g * np.asarray(out)).reshape(B, L, H, D).sum(-1)
    _assert_close(fb.frame_band_delta_plain(out_p, tg, H).numpy(),
                  delta.transpose(0, 2, 1), "delta")


def test_frame_band_on_cpu_never_builds(rng, monkeypatch):
    """A CPU tensor takes the plain forward, and autograd through it the
    backward: no kernel is built or counted."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA kernel was built for a CPU tensor")

    monkeypatch.setattr(_build, "bind", refuse)
    monkeypatch.setattr(_build, "load_all", refuse)
    x = torch.from_numpy(rng.standard_normal((2, 48, 64)).astype(np.float32))
    x.requires_grad_()
    n = (fb.frame_band_attention.launches, fb.frame_band_bwd_cuda.launches)
    fb.frame_band_attention(x, x, x, 2, 8, 1).square().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert (fb.frame_band_attention.launches,
            fb.frame_band_bwd_cuda.launches) == n
