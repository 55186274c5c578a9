"""K2-bwd's five passes in plain PyTorch (`xl_bwd_plain`: delta, dk/dv by
key tile, dq and the bias partials by query tile, dr by position tile, the
partials summed in order) against the JAX package on the CPU.

At dropout rate 0 against `jax.vjp` of the Pallas kernel in interpret mode
(vilco_tpu/kernels/xl_attention.py::xl_rel_attention), at lengths whose
tiles of 64 cross (70, 131) and odd lengths, head dims 8 and 64, a ragged
mask and one fully masked row, whose dq, dk and dv must be exactly 0.
Tolerance 1e-5 x max(1, max |ref|): f32 on both sides, summed in another
order. At rate 0.1 (the TPU's in-kernel bits cannot be matched) against
autograd through `xl_rel_attention_plain` in float64, where the keep mask
is a fixed function of the seed. tests/test_torch_port_cuda.py holds the
CUDA kernels against `xl_bwd_plain` on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.xl_attention as j_xl
from vilco_tpu_torch.kernels.xl_attention import (
    xl_bwd_plain,
    xl_lse_plain,
    xl_rel_attention_plain,
)

NAMES = ("dq", "dk", "dv", "dr", "d_r_w_bias", "d_r_r_bias")


def _inputs(rng, B, T, H, D, dtype):
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(dtype)
    arrays = [f(B, T, H, D), f(B, T, H, D), f(B, T, H, D), f(2 * T, H, D),
              f(H, D, scale=0.1), f(H, D, scale=0.1)]
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    mask = np.arange(T)[None, :] < lens[:, None]
    return arrays, mask, f(B, T, H, D)


def _plain_grads(arrays, mask, g, seed=0, rate=0.0):
    """xl_bwd_plain from the plain forward's output and row statistic."""
    args = (*map(torch.from_numpy, arrays), torch.from_numpy(mask))
    out = xl_rel_attention_plain(*args, seed=seed, rate=rate)
    return xl_bwd_plain(args, out, xl_lse_plain(args), torch.from_numpy(g),
                        seed, rate)


def _assert_close(got, refs, tol):
    for name, a, b in zip(NAMES, got, refs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        lim = tol * max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() <= lim, (name, np.abs(a - b).max(), lim)


@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("T", [32, 70, 131])
def test_xl_bwd_passes_match_pallas(T, D):
    rng = np.random.default_rng(T * 100 + D)
    arrays, mask, g = _inputs(rng, 3, T, 2, D, np.float32)
    seed = jnp.zeros((1,), jnp.int32)
    _, vjp = jax.vjp(
        lambda *a: j_xl.xl_rel_attention(*a, jnp.asarray(mask), seed, 0.0,
                                         True), *map(jnp.asarray, arrays))
    refs = vjp(jnp.asarray(g))
    got = _plain_grads(arrays, mask, g)
    _assert_close([x.numpy() for x in got], refs, 1e-5)
    for x in got[:3]:                  # the fully masked row
        assert torch.all(x[-1] == 0)


@pytest.mark.parametrize("T", [37, 70])
def test_xl_bwd_passes_match_autograd_with_dropout(T):
    """Rate 0.1 in float64: the passes against autograd through the plain
    forward, the same Philox keep mask on both sides. Tolerance 1e-10 x
    max(1, max |ref|): f64, summed in another order."""
    rng = np.random.default_rng(T)
    arrays, mask, g = _inputs(rng, 2, T, 2, 16, np.float64)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = xl_rel_attention_plain(*xs, torch.from_numpy(mask), seed=4242,
                                 rate=0.1)
    out.backward(torch.from_numpy(g))
    got = _plain_grads(arrays, mask, g, seed=4242, rate=0.1)
    _assert_close([x.numpy() for x in got], [x.grad.numpy() for x in xs],
                  1e-10)
    for x in got[:3]:
        assert torch.all(x[-1] == 0)
