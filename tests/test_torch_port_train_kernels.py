"""The backward of each port kernel module, and the AdamW update, against
the JAX Pallas kernels they replace, on the CPU.

A wrapper given CPU tensors takes its plain PyTorch version, and autograd
through it is the backward held here against `jax.vjp` of the Pallas
kernel in interpret mode (block sizes cut as in test_torch_port_kernels.py
so that several tiles run), at the JAX tests' shapes, with a fully masked
row whose gradients must be 0. Tolerance 1e-5: f32 on both sides, summed
in another order. The XL kernel is compared at dropout rate 0 (the TPU's
in-kernel random bits cannot be matched); the port's own dropout is pinned
by its Philox generator's known answers. tests/test_torch_port_cuda.py
holds the CUDA kernels against these plain versions on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.attention as j_attn
import vilco_tpu.kernels.dwconv as j_dw
import vilco_tpu.kernels.xl_attention as j_xl
from vilco_tpu.kernels.adamw import adamw_update_leaf
from vilco_tpu_torch.kernels.adamw import (
    B1,
    B2,
    EPS,
    WEIGHT_DECAY,
    adamw_update_plain,
)
from vilco_tpu_torch.kernels.attention import fused_attention_blc
from vilco_tpu_torch.kernels.dwconv import fused_dwconv_qkv
from vilco_tpu_torch.kernels.xl_attention import (
    philox4x32_10,
    philox_keep_mask,
    xl_rel_attention,
    xl_rel_attention_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(rng, B, T):
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return np.arange(T)[None, :] < lens[:, None]


def _port_grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    gs = g if isinstance(g, tuple) else (g,)
    torch.autograd.backward(outs, [torch.from_numpy(x) for x in gs])
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("H,D", [(2, 64), (1, 128)])
def test_fused_attention_blc_backward_matches_pallas(rng, monkeypatch, H, D):
    monkeypatch.setattr(j_attn, "_block_size", lambda T: 32)
    B, T = 3, 128
    C = H * D
    q, k, v, g = (rng.standard_normal((B, T, C)).astype(np.float32)
                  for _ in range(4))
    mask = _mask(rng, B, T)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: j_attn.fused_attention_blc(*a, jm, H, True),
                     *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(g))
    mt = torch.from_numpy(mask)
    grads = _port_grads(lambda a, b, c: fused_attention_blc(a, b, c, mt, H),
                        (q, k, v), g)
    for name, got, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=name, **TOL)
    assert np.all(grads[0][-1] == 0)                 # fully masked row
    assert np.all(grads[1][-1] == 0) and np.all(grads[2][-1] == 0)


@pytest.mark.parametrize("T,block", [(32, None), (64, 16)])
def test_xl_rel_attention_backward_matches_pallas(rng, monkeypatch, T, block):
    if block:
        monkeypatch.setattr(j_xl, "_block_size", lambda T: block)
    B, H, D = 3, 2, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, g = f(B, T, H, D), f(B, T, H, D), f(B, T, H, D), f(B, T, H, D)
    r = f(2 * T, H, D)
    rwb, rrb = f(H, D) * 0.1, f(H, D) * 0.1
    mask = _mask(rng, B, T)
    jm = jnp.asarray(mask)
    seed = jnp.zeros((1,), jnp.int32)
    _, vjp = jax.vjp(
        lambda *a: j_xl.xl_rel_attention(*a, jm, seed, 0.0, True),
        *map(jnp.asarray, (q, k, v, r, rwb, rrb)))
    refs = vjp(jnp.asarray(g))
    mt = torch.from_numpy(mask)
    grads = _port_grads(
        lambda *a: xl_rel_attention(*a, mt), (q, k, v, r, rwb, rrb), g)
    for name, got, ref in zip(("q", "k", "v", "r", "r_w_bias", "r_r_bias"),
                              grads, refs):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=name, **TOL)
    for got in grads[:3]:
        assert np.all(got[-1] == 0)                  # fully masked row


@pytest.mark.parametrize("stride,B,T,C", [(1, 3, 128, 256), (2, 2, 256, 128)])
def test_fused_dwconv_qkv_backward_matches_pallas(stride, B, T, C):
    rng = np.random.default_rng(10 + stride)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C)) * 0.3).astype(np.float32)
    To = (T - 1) // stride + 1
    g = tuple(rng.standard_normal((B, To, C)).astype(np.float32)
              for _ in range(3))
    jfn = j_dw.fused_dwconv_qkv if stride == 1 else j_dw.fused_dwconv_qkv_s2
    _, vjp = jax.vjp(lambda a, b: jfn(a, b, True), jnp.asarray(x),
                     jnp.asarray(w))
    refs = vjp(tuple(map(jnp.asarray, g)))
    grads = _port_grads(lambda a, b: fused_dwconv_qkv(a, b, stride), (x, w),
                        g)
    for name, got, ref in zip(("x", "w"), grads, refs):
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=name,
                                   rtol=1e-5, atol=1e-4 if name == "w"
                                   else 1e-5)


@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_plain_matches_pallas_and_jnp(rng, decay, mdt):
    """The plain update against FusedAdamW's jnp expression (optim.py
    `upd`) run op by op, and against `adamw_update_leaf(..., interpret=True)`.
    Against the op-by-op expression p, m and v are bit-equal. The Pallas
    kernel compiles as one fused computation in which XLA may contract
    `(1 - b1) g + b1 m` and `p - lr u` into FMAs (see
    test_pallas_adamw_leaf_matches_jnp) and may skip the bf16 rounding of
    `b1 m`: there f32 state agrees to 1e-6 relative; with bf16 state a
    moment may land on the neighbouring bf16 value (at most 1 bf16 ulp at
    the tensor's scale, 2^-7 of its largest value, is allowed) and p then moves by lr times that change
    (the JAX test's 2e-3 relative, 2e-5 absolute)."""
    n = 8 * 128 * 3
    mu = jnp.dtype(mdt)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = np.asarray(jnp.asarray(rng.standard_normal(n), jnp.float32).astype(mu))
    v = np.asarray(jnp.asarray(np.abs(rng.standard_normal(n)),
                               jnp.float32).astype(mu))
    lr, bc1, bc2 = (np.float32(1e-3), np.float32(1 - B1 ** 3),
                    np.float32(1 - B2 ** 3))
    # FusedAdamW's jnp update (vilco_tpu/train/optim.py::upd), eagerly
    jg, jm, jv = jnp.asarray(g), jnp.asarray(m), jnp.asarray(v)
    m2 = (1.0 - B1) * jg + B1 * jm
    v2 = (1.0 - B2) * (jg * jg) + B2 * jv.astype(jnp.float32)
    u = (m2 / bc1) / (jnp.sqrt(v2 / bc2) + EPS)
    if decay:
        u = u + WEIGHT_DECAY * jnp.asarray(p)
    jnp_out = (jnp.asarray(p) - lr * u, m2.astype(mu), v2.astype(mu))
    pallas_out = adamw_update_leaf(
        jnp.asarray(p), jg, jm, jv, decay=decay, wd=WEIGHT_DECAY, lr=lr,
        bc1=bc1, bc2=bc2, b1=B1, b2=B2, eps=EPS, mu_dtype=mu, nu_dtype=mu,
        interpret=True)
    tdt = torch.float32 if mdt == "float32" else torch.bfloat16
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)
    got = adamw_update_plain(torch.from_numpy(p), torch.from_numpy(g),
                             to_t(m), to_t(v), decay, lr, bc1, bc2)
    f32 = lambda b: np.asarray(jnp.asarray(b).astype(jnp.float32))
    for name, a, b in zip("pmv", got, jnp_out):
        np.testing.assert_array_equal(a.float().numpy(), f32(b),
                                      err_msg=name)
    for name, a, b in zip("pmv", got, pallas_out):
        a, b = a.float().numpy(), f32(b)
        if mdt == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8,
                                       err_msg=name)
        elif name == "p":
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                       atol=np.abs(b).max() * 2.0 ** -7)


def test_philox_known_answers_and_mask():
    """Random123's known-answer vectors for Philox4x32-10, then the mask:
    the same seed gives the same mask, another seed another one, and the
    keep rate lies within 4 sigma of 0.9."""
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want
    a = philox_keep_mask(123456789012345, 2, 3, 64, 0.1)
    assert torch.equal(a, philox_keep_mask(123456789012345, 2, 3, 64, 0.1))
    assert not torch.equal(a, philox_keep_mask(7, 2, 3, 64, 0.1))
    n = a.numel()
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(a.float().mean().item() - 0.9) < 4 * sigma


def test_xl_plain_dropout_gradcheck():
    """Autograd through the plain XL attention with dropout 0.1 against
    finite differences, in f64: the mask is a fixed function of the seed."""
    rng = np.random.default_rng(5)
    B, T, H, D = 2, 6, 2, 4
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)).requires_grad_()
    args = (f(B, T, H, D), f(B, T, H, D), f(B, T, H, D), f(2 * T, H, D),
            f(H, D), f(H, D))
    mask = torch.from_numpy(_mask(rng, B, T))
    fn = lambda *a: xl_rel_attention_plain(*a, mask, seed=99, rate=0.1)
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("T", [5, 37, 70])
def test_xl_inverse_shift_is_a_store_offset(T):
    """The CUDA backward scatters the position-score gradient with the store
    offset d_raw[i, T + j - i] += d_ac[i, j] (a band index per tile, in
    place of the TPU's roll cascade, tools/probe_roll_hw.py). Pinned here
    against autograd through the plain version's reshape-slice shift, at odd
    T and at lengths that cross the kernel's 64-row tiles."""
    rng = np.random.default_rng(T)
    raw = torch.from_numpy(rng.standard_normal((T, 2 * T))).requires_grad_()
    d_ac = torch.from_numpy(rng.standard_normal((T, T)))
    shifted = raw.reshape(2 * T, T)[1:].reshape(T, 2 * T - 1)[:, :T]
    (shifted * d_ac).sum().backward()
    want = torch.zeros(T, 2 * T, dtype=torch.float64)
    for i in range(T):
        for j in range(T):
            want[i, T + j - i] += d_ac[i, j]
    assert torch.equal(raw.grad, want)
