"""Each port kernel module against the JAX Pallas kernel it replaces.

On the CPU a wrapper takes its plain PyTorch version (a CUDA kernel has no
interpret mode); the JAX side runs the Pallas kernel in interpret mode, at
the shapes the JAX package's own kernel tests use, with a fully masked row
whose output must be 0. Tolerance 1e-5: f32 on both sides, summation order
differs. tests/test_torch_port_cuda.py holds each CUDA kernel against its
plain version on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.attention as j_attn
import vilco_tpu.kernels.dwconv as j_dw
import vilco_tpu.kernels.xl_attention as j_xl
from vilco_tpu_torch.kernels.attention import (
    fused_attention_blc,
    fused_attention_blc_plain,
)
from vilco_tpu_torch.kernels.dwconv import (
    fused_dwconv_qkv,
    fused_dwconv_qkv_plain,
)
from vilco_tpu_torch.kernels.xl_attention import (
    xl_rel_attention,
    xl_rel_attention_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(rng, B, T):
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return np.arange(T)[None, :] < lens[:, None]


@pytest.mark.parametrize("H,D", [(2, 64), (2, 128)])
def test_fused_attention_blc_matches_pallas(rng, monkeypatch, H, D):
    monkeypatch.setattr(j_attn, "_block_size", lambda T: 16)
    B, T = 3, 128 if D == 128 else 64
    C = H * D
    q, k, v = (rng.standard_normal((B, T, C)).astype(np.float32)
               for _ in range(3))
    mask = _mask(rng, B, T)
    ref = j_attn.fused_attention_blc(*map(jnp.asarray, (q, k, v, mask)), H,
                                     True)
    out = fused_attention_blc(*map(torch.from_numpy, (q, k, v, mask)), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[-1] == 0)


@pytest.mark.parametrize("T,block", [(32, None), (64, 16)])
def test_xl_rel_attention_matches_pallas(rng, monkeypatch, T, block):
    if block:
        monkeypatch.setattr(j_xl, "_block_size", lambda T: block)
    B, H, D = 3, 2, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    r = f(2 * T, H, D)
    rwb, rrb = f(H, D) * 0.1, f(H, D) * 0.1
    mask = _mask(rng, B, T)
    ref = j_xl.xl_rel_attention(*map(jnp.asarray, (q, k, v, r, rwb, rrb,
                                                   mask)),
                                jnp.zeros((1,), jnp.int32), 0.0, True)
    out = xl_rel_attention(*map(torch.from_numpy, (q, k, v, r, rwb, rrb,
                                                   mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[-1] == 0)


@pytest.mark.parametrize("stride,B,T,C", [(1, 3, 128, 256), (2, 2, 256, 128)])
def test_fused_dwconv_qkv_matches_pallas(stride, B, T, C):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C)) * 0.3).astype(np.float32)
    jfn = j_dw.fused_dwconv_qkv if stride == 1 else j_dw.fused_dwconv_qkv_s2
    refs = jfn(jnp.asarray(x), jnp.asarray(w), True)
    outs = fused_dwconv_qkv(torch.from_numpy(x), torch.from_numpy(w), stride)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError):
        fused_dwconv_qkv(x, torch.zeros(3, 3, 8))
    with pytest.raises(ValueError):
        fused_dwconv_qkv(x, torch.zeros(3, 3, 16), stride=3)
    with pytest.raises(ValueError):
        fused_attention_blc(x, x, x, torch.ones(1, 7, dtype=torch.bool), 2)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        xl_rel_attention(q, q, q, torch.zeros(8, 2, 8), torch.zeros(2, 8),
                         torch.zeros(2, 8), torch.ones(1, 4, dtype=bool),
                         rate=1.0)
