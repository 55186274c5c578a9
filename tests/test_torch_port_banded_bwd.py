"""K5's backward contract on the CPU: `banded_attention_bwd_plain` (the
plain version of the one backward launch, which tests/test_torch_port_cuda.py
and chip_smoke.py hold the CUDA kernel to on the card) and `banded_lse_plain`
(the forward's lse it reads) against the JAX package.

- "pallas": T 128 and 256, where `_pick_block` finds a 128-multiple block:
  the plain passes, fed the port's plain forward output and lse, against
  vilco_tpu/kernels/banded_attention.py::_backward in interpret mode, fed
  JAX's own forward residuals (`_forward`'s unmasked output and lse).
- "xla": T 8 (the band wider than T), 37 and 130: against jax.vjp of
  vilco_tpu.ops.attention.banded_attention. Its blocked form needs T a
  multiple of w, so JAX takes the inputs padded to the next multiple with
  masked rows, cut back to T after: a masked key scores -1e9 with its value
  zeroed, as a key outside [0, T) does, and a masked query's output and
  gradient are zeroed, so the padding changes no gradient of the first T
  rows.
- "lse": `banded_lse_plain` against a float64 log-sum-exp written from the
  definition (masked keys and keys outside [0, T) at -1e9), at every T.

Windows 1, 4 and 8, head dims 8 and 96, a ragged mask and one fully masked
batch row, whose dq, dk and dv must be exactly 0. Tolerance 1e-5 x max(1,
max |ref|) for each output (a row of the lse): f32 on both sides, summed in
another order (the port by band slot, the Pallas kernel by (BQ, BQ + 128)
tiles, XLA by its blocked windows).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.banded_attention as j_band
from vilco_tpu.ops.attention import banded_attention as j_banded
from vilco_tpu_torch.kernels.banded_attention import (
    banded_attention_blc_plain,
    banded_attention_bwd_plain,
    banded_lse_plain,
)

B, H = 3, 2
CASES = ([("pallas", T, w, D) for T in (128, 256) for w in (1, 4, 8)
          for D in (8, 96)]
         + [("xla", T, w, D) for T in (8, 37, 130) for w in (1, 4, 8)
            for D in (8, 96)])
TOL = 1e-5


def _inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return q, k, v, g, np.arange(T)[None, :] < lens[:, None]


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _port(q, k, v, g, mask, w):
    """The port's plain forward output and lse, then its backward passes,
    on the channels-last view; (dq, dk, dv) in (B, T, H, D)."""
    T, D = q.shape[1], q.shape[3]
    blc = lambda x: torch.from_numpy(x.reshape(B, T, H * D))
    qt, kt, vt, gt = map(blc, (q, k, v, g))
    m = torch.from_numpy(mask)
    out = banded_attention_blc_plain(qt, kt, vt, m, H, w)
    lse = banded_lse_plain(qt, kt, m, H, w)
    return [x.numpy().reshape(B, T, H, D) for x in
            banded_attention_bwd_plain(qt, kt, vt, m, out, lse, gt, H, w)]


@pytest.mark.parametrize("ref,T,w,D", CASES)
def test_banded_bwd_plain_matches_jax(ref, T, w, D):
    q, k, v, g, mask = _inputs(T, D, 100 * T + 10 * w + D)
    jq, jk, jv, jg, jm = map(jnp.asarray, (q, k, v, g, mask))
    if ref == "pallas":
        bq = j_band._pick_block(T, w)
        assert bq and T % bq == 0

        def run(a, b, c, ct):
            _, out_f, lse = j_band._forward(a, b, c, jm, w, bq, True)
            return j_band._backward(a, b, c, jm, out_f, lse, ct, w, bq,
                                    True)
    else:
        Tp = -(-T // w) * w
        pad = lambda x: jnp.pad(x, [(0, 0), (0, Tp - T)]
                                + [(0, 0)] * (x.ndim - 2))
        jmp = pad(jm)

        def run(a, b, c, ct):
            _, vjp = jax.vjp(
                lambda x, y, z: j_banded(x, y, z, jmp, window=w),
                pad(a), pad(b), pad(c))
            return [x[:, :T] for x in vjp(pad(ct))]

    want = jax.jit(run)(jq, jk, jv, jg)
    got = _port(q, k, v, g, mask, w)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, f"{ref} {name}")
        assert np.all(a[-1] == 0), name


def _lse64(q, k, mask, w):
    """log sum_j exp(s_ij) over the 2w + 1 band slots in float64, s_ij =
    q_i . k_j / sqrt(D), -1e9 where key j is masked or outside [0, T);
    (B, H, T)."""
    q, k = q.astype(np.float64), k.astype(np.float64)
    T, D = q.shape[1], q.shape[3]
    s = np.full((B, H, T, 2 * w + 1), -1e9)
    for slot in range(2 * w + 1):
        for i in range(T):
            j = i - w + slot
            if 0 <= j < T:
                dot = np.einsum("bhd,bhd->bh", q[:, i], k[:, j]) / D ** 0.5
                s[:, :, i, slot] = np.where(mask[:, j, None], dot, -1e9)
    m = s.max(-1)
    return m + np.log(np.exp(s - m[..., None]).sum(-1))


@pytest.mark.parametrize("T", [8, 37, 128, 130, 256])
@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("D", [8, 96])
def test_banded_lse_plain_matches_float64(T, w, D):
    q, k, _, _, mask = _inputs(T, D, 7 * T + w + D)
    blc = lambda x: torch.from_numpy(x.reshape(B, T, H * D))
    got = banded_lse_plain(blc(q), blc(k), torch.from_numpy(mask), H,
                           w).numpy()
    want = _lse64(q, k, mask, w)
    assert got.dtype == np.float32 and got.shape == (B, H, T)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= TOL, err.max()
