"""The port's plain ops (vilco_tpu_torch/ops) against the JAX package's, on
the CPU in f32, same numpy inputs. Tolerance 1e-5: both sides compute the
same f32 math and differ only in summation order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.ops import activations as j_act
from vilco_tpu.ops import attention as j_att
from vilco_tpu.ops import masked as j_masked
from vilco_tpu_torch.ops import activations as t_act
from vilco_tpu_torch.ops import attention as t_att
from vilco_tpu_torch.ops import masked as t_masked

TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(B, T):
    lens = np.linspace(T, T // 2, B).astype(int)
    lens[-1] = 0                       # one fully masked row
    return np.arange(T)[None, :] < lens[:, None]


@pytest.mark.parametrize("stride,depthwise", [(1, False), (2, False),
                                              (1, True), (2, True)])
def test_masked_conv1d(rng, stride, depthwise):
    B, T, Cin, K = 3, 20, 8, 3
    Cout = Cin if depthwise else 12
    groups = Cin if depthwise else 1
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    kernel = rng.standard_normal((K, Cin // groups, Cout)).astype(np.float32)
    bias = rng.standard_normal((Cout,)).astype(np.float32)
    mask = _mask(B, T)
    ref, ref_m = j_masked.masked_conv1d(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(kernel),
        jnp.asarray(bias), stride=stride, groups=groups)
    out, out_m = t_masked.masked_conv1d(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(kernel.transpose(2, 1, 0).copy()),
        torch.from_numpy(bias), stride=stride, groups=groups)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_channel_layernorm(rng):
    x = rng.standard_normal((2, 7, 16)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    ref = j_masked.channel_layernorm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    out = t_masked.channel_layernorm(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("T", [16, 15])
def test_masked_max_pool1d(rng, T):
    x = rng.standard_normal((3, T, 8)).astype(np.float32)
    mask = _mask(3, T)
    ref, ref_m = j_masked.masked_max_pool1d(jnp.asarray(x),
                                            jnp.asarray(mask), 3, 2)
    out, out_m = t_masked.masked_max_pool1d(torch.from_numpy(x),
                                            torch.from_numpy(mask), 3, 2)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sinusoid_encoding_and_gelu(rng):
    np.testing.assert_array_equal(t_masked.sinusoid_encoding(33, 16),
                                  j_masked.sinusoid_encoding(33, 16))
    x = rng.standard_normal((64,)).astype(np.float32) * 3
    np.testing.assert_allclose(t_act.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(j_act.gelu(jnp.asarray(x))), **TOL)
    with t_act.exact_gelu(), j_act.exact_gelu():
        np.testing.assert_allclose(
            t_act.gelu(torch.from_numpy(x)).numpy(),
            np.asarray(j_act.gelu(jnp.asarray(x))), **TOL)


def test_masked_attention(rng):
    B, Tq, Tk, H, D = 3, 12, 10, 2, 8
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, H, D)).astype(np.float32)
            for _ in range(2))
    kv_mask = _mask(B, Tk)
    ref = j_att.masked_attention(*map(jnp.asarray, (q, k, v, kv_mask)))
    out = t_att.masked_attention(*map(torch.from_numpy, (q, k, v, kv_mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the fully masked row gives 0, not NaN
    assert np.all(out.numpy()[-1] == 0)


def test_channel_attention(rng):
    qkv = rng.standard_normal((2, 9, 3, 4, 8)).astype(np.float32)
    ref = j_att.channel_attention(jnp.asarray(qkv), 4)
    out = t_att.channel_attention(torch.from_numpy(qkv), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
