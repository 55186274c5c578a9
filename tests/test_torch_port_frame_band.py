"""The plain versions of the port's frame-banded attention (K6) and fused MLP
(K7) against the JAX package on the CPU: the Pallas kernels in interpret
mode and their XLA references, values and gradients, at the shapes of
tests/test_pallas_kernels.py and with the band wider than the clip.
Tolerances are the JAX tests' own: K6 values 2e-5 and gradients 3e-4, K7
values 2e-4 and the input gradient 2e-3 (f32, another summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.kernels import frame_band as j_fb
from vilco_tpu.kernels import mlp as j_mlp
from vilco_tpu_torch.kernels.frame_band import (
    frame_band_attention,
    frame_band_attention_plain,
)
from vilco_tpu_torch.kernels.mlp import fused_mlp, fused_mlp_plain


def _qkv(rng, B, L, C):
    return [rng.standard_normal((B, L, C)).astype(np.float32)
            for _ in range(3)]


def _torch_grads(fn, arrays):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("n_frames,fr,w", [(6, 8, 1), (8, 8, 2), (7, 16, 2)])
def test_frame_band_plain_matches_pallas_interpret(rng, n_frames, fr, w):
    B, C, H = 2, 128, 2
    L = n_frames * fr
    bq = fr if fr >= 16 else 2 * fr
    assert j_fb.supports(L, C, H, fr, w, block_q=bq)
    arrays = _qkv(rng, B, L, C)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    kern = lambda q, k, v: j_fb.frame_band_attention(q, k, v, H, fr, w, bq,
                                                     True)
    ref = lambda q, k, v: j_fb._xla_ref(q, k, v, H, fr, w)
    out, grads = _torch_grads(
        lambda q, k, v: frame_band_attention(q, k, v, H, fr, w), arrays)
    for jfn in (kern, ref):
        np.testing.assert_allclose(out, np.asarray(jax.jit(jfn)(jq, jk, jv)),
                                   atol=2e-5)
        jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                              argnums=(0, 1, 2)))(jq, jk, jv)
        for a, b, nm in zip(grads, jg, "qkv"):
            np.testing.assert_allclose(a, np.asarray(b), atol=3e-4,
                                       err_msg=f"d{nm}")


@pytest.mark.parametrize("n_frames,fr,w,H,D", [(3, 8, 2, 2, 32),
                                               (5, 7, 2, 3, 24),
                                               (1, 64, 2, 8, 32),
                                               (4, 5, 0, 2, 16),
                                               (2, 9, 1, 1, 128)])
def test_frame_band_plain_where_the_band_covers_the_clip(rng, n_frames, fr,
                                                         w, H, D):
    """n_frames <= 2w + 1, odd fr, C no multiple of 128, w = 0, one head of
    the widest D: JAX's `supports` sends these to `_xla_ref`; the port's
    kernel takes them."""
    B, C = 2, H * D
    L = n_frames * fr
    arrays = _qkv(rng, B, L, C)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    out, grads = _torch_grads(
        lambda q, k, v: frame_band_attention_plain(q, k, v, H, fr, w),
        arrays)
    jfn = lambda q, k, v: j_fb.frame_band_attention(q, k, v, H, fr, w)
    np.testing.assert_allclose(out, np.asarray(jax.jit(jfn)(jq, jk, jv)),
                               atol=2e-5)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                          argnums=(0, 1, 2)))(jq, jk, jv)
    for a, b, nm in zip(grads, jg, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-4,
                                   err_msg=f"d{nm}")


def test_frame_band_checks_its_shapes():
    x = torch.zeros(1, 10, 8)
    with pytest.raises(ValueError):
        frame_band_attention(x, x, x, 2, 3, 1)        # L not n_frames * fr
    with pytest.raises(ValueError):
        frame_band_attention(x, x, x, 3, 5, 1)        # C not H * D


def test_fused_mlp_plain_matches_pallas_interpret(rng):
    N, C, Hd = 600, 128, 512
    x = rng.standard_normal((N, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, Hd)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal((Hd,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((Hd, C)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    jw = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    tw = [torch.from_numpy(a) for a in (w1, b1, w2, b2)]
    kern = lambda xx: j_mlp.fused_mlp(xx, *jw, True)
    ref = lambda xx: j_mlp._ref_mlp(xx, *jw)
    xt = torch.from_numpy(x).reshape(2, 300, C).requires_grad_()
    out = fused_mlp(xt, *tw)
    assert out.shape == (2, 300, C)
    out.sum().backward()
    for jfn in (kern, ref):
        np.testing.assert_allclose(out.detach().numpy().reshape(N, C),
                                   np.asarray(jax.jit(jfn)(jnp.asarray(x))),
                                   atol=2e-4)
        g = jax.jit(jax.grad(lambda xx: jfn(xx).sum()))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy().reshape(N, C),
                                   np.asarray(g), atol=2e-3)
    np.testing.assert_array_equal(
        fused_mlp_plain(torch.from_numpy(x), *tw).numpy(),
        out.detach().numpy().reshape(N, C))
