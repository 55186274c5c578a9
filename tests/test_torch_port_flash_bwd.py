"""K1f's backward as its kernels compute it, and the K7 wrapper's CPU path,
on the CPU.

K1f runs on K1's forward and three-pass backward in flash mode: the
forward keeps each row's max m (log2 domain) and sum l apart, and the
backward recomputes P = exp2(s - m) / l. `flash_stats_plain` and
`flash_attention_bwd_plain` are those kernels' arithmetic in plain
PyTorch. They are held here to JAX's TPU flash-attention kernels
(`flash_attention_jax`, its forward and jax.vjp, in interpret mode) in
float32 at 1e-5 x max(1, max|ref|) (f32 on both sides, sums in another
order), and to autograd through `flash_attention_plain` in float64 at
1e-12 x max(1, max|ref|) (the same function, f64 rounding only). Inputs
from numpy; ragged key masks with one fully masked row, where the library
averages v over every key and so gives every key P = 1 / T.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.attention as j_attn
from vilco_tpu_torch.kernels import _build
from vilco_tpu_torch.kernels import attention as t_attn
from vilco_tpu_torch.kernels import mlp as t_mlp


def _inputs(seed, B, T, H, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(dtype)
                  for _ in range(4))
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return q, k, v, g, np.arange(T)[None, :] < lens[:, None]


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("B,T,H,D", [(3, 128, 2, 32), (2, 256, 2, 64)])
def test_flash_bwd_plain_matches_jax_vjp(B, T, H, D):
    """The three passes from m and l against jax.vjp of JAX's flash kernels
    (the whole backward, the key range sliced for dk/dv as the kernel
    slices it at these shapes)."""
    q, k, v, g, mask = _inputs(T + D, B, T, H, D)
    jm = jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(
            lambda a, b, c: j_attn.flash_attention_jax(a, b, c, jm),
            *map(jnp.asarray, (q, k, v)))
        refs = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tm = torch.from_numpy(mask)
    out = t_attn.flash_attention_plain(tq, tk, tv, tm)
    _close(out.numpy(), ref, 1e-5, "out")
    m, l = t_attn.flash_stats_plain(tq, tk, tm)
    assert t_attn.dkv_splits(B, H, T, T) > 1
    got = t_attn.flash_attention_bwd_plain(tq, tk, tv, tm, out, m, l, tg)
    for name, a, b in zip("qkv", got, refs):
        _close(a.numpy(), b, 1e-5, f"d{name}")
    # the fully masked row: every key weighs 1 / T, so dv of that row's
    # keys holds its share of dout's sum over the rows
    _close(got[2][-1].numpy(),
           np.broadcast_to(g[-1].sum(0) / T, (T, H, D)), 1e-5,
           "dv of the fully masked row")


@pytest.mark.parametrize("B,T,H,D,splits", [(3, 128, 2, 32, None),
                                            (2, 200, 3, 24, 1),
                                            (2, 300, 1, 64, 3)])
def test_flash_bwd_plain_equals_autograd_in_f64(B, T, H, D, splits):
    """In float64 the kernels' three passes (any query slicing) give
    autograd's gradients through the library's softmax, the fully masked
    row included; its statistics are m = the mask value (log2 domain, as
    it is) and l = T."""
    q, k, v, g, mask = _inputs(7 * T + D, B, T, H, D, np.float64)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tm = torch.from_numpy(mask)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = t_attn.flash_attention_plain(*xs, tm)
    out.backward(tg)
    m, l = t_attn.flash_stats_plain(tq, tk, tm)
    assert m.dtype == l.dtype == torch.float64
    assert torch.all(l[-1] == T)
    assert torch.all(m[-1] == np.float32(t_attn.FLASH_MASK_VALUE))
    assert torch.all(l[:-1] >= 1)
    got = t_attn.flash_attention_bwd_plain(tq, tk, tv, tm, out.detach(), m,
                                           l, tg, splits)
    for name, a, x in zip("qkv", got, xs):
        assert a.dtype == torch.float64
        _close(a.numpy(), x.grad.numpy(), 1e-12, f"d{name}")
    assert torch.all(got[2][-1] != 0)


def test_flash_wrappers_on_cpu_never_build(monkeypatch):
    """A CPU tensor takes K1f's plain version forward and backward: the
    CUDA libraries are never built or bound."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "bind", refuse)
    monkeypatch.setattr(_build, "load_all", refuse)
    q, k, v, g, mask = _inputs(3, 2, 128, 2, 32)
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    n = t_attn.flash_attention.launches, t_attn.flash_bwd_cuda.launches
    t_attn.flash_attention(*xs, torch.from_numpy(mask)).backward(
        torch.from_numpy(g))
    assert all(torch.isfinite(x.grad).all() for x in xs)
    assert (t_attn.flash_attention.launches,
            t_attn.flash_bwd_cuda.launches) == n


@pytest.mark.parametrize("N,C,Hd", [(1, 48, 192), (37, 128, 512)])
def test_fused_mlp_on_cpu_never_builds(monkeypatch, N, C, Hd):
    """K7's wrapper on a CPU tensor takes the plain version, forward and
    input gradient, without reaching the CUDA build; its launch count
    stays put, and its launcher raises on a CPU tensor."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "bind", refuse)
    monkeypatch.setattr(_build, "load_all", refuse)
    rng = np.random.default_rng(N)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    x = f(2, N, C).requires_grad_()
    w1, b1, w2, b2 = f(C, Hd), f(Hd), f(Hd, C), f(C)
    n = t_mlp.fused_mlp.launches
    out = t_mlp.fused_mlp(x, w1, b1, w2, b2)
    assert out.shape == (2, N, C)
    torch.testing.assert_close(
        out, t_mlp.fused_mlp_plain(x.reshape(-1, C), w1, b1, w2,
                                   b2).reshape(2, N, C), rtol=0, atol=0)
    out.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert t_mlp.fused_mlp.launches == n
    with pytest.raises(ValueError):     # the launcher refuses CPU tensors
        t_mlp.fused_mlp_cuda(x.detach()[0], w1, b1, w2, b2)
