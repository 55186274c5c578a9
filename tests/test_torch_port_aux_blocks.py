"""The port's auxiliary blocks (models/aux_blocks.py: SGPBlock, CxAM, CnAM,
DenseAPP, ACConv) and deformable conv (ops/deform_conv.py) against JAX's
on the CPU: the same numpy input and JAX's parameter tree (`jax.eval_shape`
of its init) filled from a numpy seed, loaded through models/convert.py; the forward and the gradient of a
random projection of the output with respect to the input (jax.vjp
against autograd). Tolerance 1e-5 relative to the output's or input
gradient's largest value (f32 on both sides, a few layers summed in
another order), at deterministic=True (dropout and drop-path off);
DenseAPP and ACConv 3e-5: their last GroupNorm has one channel a group,
its statistics over the level's rows alone (4 at the short level), and
Flax takes the variance as E[x^2] - E[x]^2, torch as E[(x - mean)^2]
(1.2e-5 measured).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.models import aux_blocks as j_aux
from vilco_tpu.ops import deform_conv as j_deform
from vilco_tpu_torch.models import aux_blocks as t_aux
from vilco_tpu_torch.models.convert import load_jax_params
from vilco_tpu_torch.ops import deform_conv as t_deform

TOL = 1e-5
GN_TOL = 3e-5
B, T, C = 2, 16, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _seeded(tree, seed=0):
    """JAX's parameter tree (jax.eval_shape of its init) filled from numpy
    at `seed`, in place of its init, whose random draws compile op by op
    on the CPU: a `scale` 1 + N(0, 0.05), every other leaf of one axis
    N(0, 0.05), a kernel N(0, 1 / fan_in), fan_in the product of all but
    its last axis."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        z = rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1 + 0.05 * z
        if len(a.shape) < 2:
            return 0.05 * z
        return z / np.float32(np.sqrt(np.prod(a.shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _mask(T_=T):
    return np.arange(T_)[None] < np.array([T_, T_ - 5])[:, None]


def _check(jfn, tfn, xs, seed=3, tol=TOL):
    """Forward and input gradients of `jfn` (JAX, arrays) and `tfn` (torch,
    tensors) on the numpy inputs `xs`; the first output is compared."""
    jout, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, xs))
    cot = np.random.default_rng(seed).standard_normal(
        np.shape(jout)).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    out = tfn(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(out.detach().numpy(), jout) <= tol
    for t, g in zip(ts, jgrads):
        assert _rel(t.grad.numpy(), g) <= tol


def _params(jmod, *args, **kw):
    return _seeded(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                  *map(jnp.asarray, args), **kw)["params"])


@pytest.mark.parametrize("stride,downsample", [(1, "max"), (2, "max"),
                                               (4, "max"), (2, "avg")])
def test_sgp_block_matches_jax(stride, downsample):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _mask()
    jb = j_aux.SGPBlock(n_ds_stride=stride, path_pdrop=0.1,
                        downsample_type=downsample)
    params = _params(jb, x, mask)
    tb = t_aux.SGPBlock(C, n_ds_stride=stride, path_pdrop=0.1,
                        downsample_type=downsample)
    load_jax_params(tb, params)
    jm = jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))[1]
    tm = tb(torch.from_numpy(x), torch.from_numpy(mask))[1]
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _check(lambda a: jb.apply({"params": params}, a, jnp.asarray(mask))[0],
           lambda a: tb(a, torch.from_numpy(mask))[0], [x])


def test_sgp_block_refuses_what_jax_refuses():
    """An odd T at stride 2: the pooled rows and the nearest-downsampled
    mask differ by one, which JAX asserts against."""
    x = np.zeros((B, 15, C), np.float32)
    mask = _mask(15)
    with pytest.raises(AssertionError):
        jax.eval_shape(j_aux.SGPBlock(n_ds_stride=2).init,
                       jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask))
    with pytest.raises(ValueError, match="divisible"):
        t_aux.SGPBlock(C, n_ds_stride=2)(torch.from_numpy(x),
                                         torch.from_numpy(mask))


def test_cxam_and_cnam_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    init = rng.standard_normal((B, T, C)).astype(np.float32)
    jx = j_aux.CxAM()
    px = _params(jx, x)
    tx = t_aux.CxAM(C)
    load_jax_params(tx, px)
    _check(lambda a: jx.apply({"params": px}, a), tx, [x])
    jn = j_aux.CnAM()
    pn = _params(jn, x, init)
    tn = t_aux.CnAM(C)
    load_jax_params(tn, pn)
    _check(lambda a, b: jn.apply({"params": pn}, a, b), tn, [x, init])


@pytest.mark.parametrize("T_", [4, 16])
def test_dense_app_and_acconv_match_jax(T_):
    """DenseAPP at JAX's widths (512 -> 256 a block, rates 3 to 24, a
    level shorter than every dilation at T 4) and ACConv's mask."""
    rng = np.random.default_rng(T_)
    x = rng.standard_normal((B, T_, C)).astype(np.float32)
    mask = _mask(T_) if T_ > 5 else np.ones((B, T_), bool)
    jd = j_aux.DenseAPP()
    pd = _params(jd, x)
    td = t_aux.DenseAPP(C)
    load_jax_params(td, pd)
    _check(lambda a: jd.apply({"params": pd}, a), td, [x], tol=GN_TOL)
    ja = j_aux.ACConv()
    pa = _params(ja, x, mask)
    ta = t_aux.ACConv(C)
    load_jax_params(ta, pa)
    _check(lambda a: ja.apply({"params": pa}, a, jnp.asarray(mask))[0],
           lambda a: ta(a, torch.from_numpy(mask))[0], [x], tol=GN_TOL)


def test_dense_block_dropout_draws_from_the_generator():
    """With a generator the DenseBlocks drop at 0.1 (the same bits for the
    same seed); without one the block is deterministic."""
    x = torch.randn(B, T, C)
    td = t_aux.DenseAPP(C)
    from vilco_tpu_torch.models.layers import init_weights_

    init_weights_(td, torch.Generator().manual_seed(0))
    a = td(x, torch.Generator().manual_seed(1))
    b = td(x, torch.Generator().manual_seed(1))
    c = td(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, td(x))


@pytest.mark.parametrize("K", [3, 5])
def test_deform_conv1d_matches_jax(K):
    """Offsets of a few rows either way, some past both ends (clamped), and
    the gradients in the input, the offsets and the weights."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    off = (rng.standard_normal((B, T, K)) * 3).astype(np.float32)
    w = rng.standard_normal((K, C, 24)).astype(np.float32) * 0.1
    b = rng.standard_normal(24).astype(np.float32)
    _check(lambda a, o, k: j_deform.deform_conv1d(a, o, k, jnp.asarray(b)),
           lambda a, o, k: t_deform.deform_conv1d(
               a, o, k.permute(2, 1, 0), torch.from_numpy(b)),
           [x, off, w])


def test_packed_deform_conv_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = _mask()
    jp = j_deform.PackedDeformConv(24)
    params = _params(jp, x, mask)      # the offset kernel off its zero init
    tp = t_deform.PackedDeformConv(C, 24)
    load_jax_params(tp, params)
    assert tp.offset_kernel.shape == params["offset_kernel"].shape
    _check(lambda a: jp.apply({"params": params}, a, jnp.asarray(mask))[0],
           lambda a: tp(a, torch.from_numpy(mask))[0], [x])
