"""K2's forward contract on the CPU: `xl_rel_attention_plain` and
`xl_lse_plain`, the plain versions that tests/test_torch_port_cuda.py and
chip_smoke.py hold the CUDA forward to on the card, against the JAX
package.

- "f32": the plain forward against the Pallas kernel in interpret mode
  (vilco_tpu/kernels/xl_attention.py::xl_rel_attention at dropout rate 0)
  at lengths whose 64-key tiles cross or fall short (70, 131), head dims 8
  and 64, a ragged mask and one fully masked batch row, which must be
  exactly 0. Tolerance 1e-5 x max(1, max |ref|): f32 on both sides,
  summed in another order.
- "bf16": the same with bf16 inputs on both sides, at 2e-2 x max(1, max
  |ref|): JAX rounds q + bias, the normalised P and the output to bf16,
  the plain version computes in f32 and rounds the output.
- "lse": `xl_lse_plain` (the row statistic m + log2 l that K2-bwd's
  passes read) against a float64 log-sum-exp in the log2 domain of the
  same scores, the fully masked row included, at 1e-5 x max(1, |ref|) a
  row.

T 32 and 64 at D 8 are in test_torch_port_kernels.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.xl_attention as j_xl
from vilco_tpu_torch.kernels.xl_attention import (
    LOG2E,
    NEG_INF,
    xl_lse_plain,
    xl_rel_attention_plain,
)

CASES = [(kind, T, D) for kind in ("f32", "bf16", "lse")
         for T in (70, 131) for D in (8, 64)]


def _inputs(rng, B, T, H, D):
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    arrays = [f(B, T, H, D), f(B, T, H, D), f(B, T, H, D), f(2 * T, H, D),
              f(H, D, scale=0.1), f(H, D, scale=0.1)]
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return arrays, np.arange(T)[None, :] < lens[:, None]


def _lse64(arrays, mask):
    """m + log2(sum exp2(s - m)) of the log2-domain scores in float64,
    written out from the definition: s[b, h, i, j] = ((q_i + r_w_bias) k_j
    + (q_i + r_r_bias) r[T + j - i]) / sqrt(D) log2 e, masked keys -1e9
    log2 e."""
    q, k, _, r, rwb, rrb = (a.astype(np.float64) for a in arrays)
    B, T, H, D = q.shape
    ac = np.einsum("bihd,bjhd->bhij", q + rwb, k)
    j_minus_i = np.arange(T)[None, :] - np.arange(T)[:, None]
    rs = r[T + j_minus_i]                                  # (T, T, H, D)
    bd = np.einsum("bihd,ijhd->bhij", q + rrb, rs)
    s = (ac + bd) / np.sqrt(D) * LOG2E
    s = np.where(mask[:, None, None, :], s, NEG_INF * LOG2E)
    m = s.max(-1)
    return m + np.log2(np.exp2(s - m[..., None]).sum(-1))


@pytest.mark.parametrize("kind,T,D", CASES)
def test_xl_forward_contract(kind, T, D):
    rng = np.random.default_rng(1000 * T + D)
    arrays, mask = _inputs(rng, 3, T, 2, D)
    if kind == "lse":
        got = xl_lse_plain((*map(torch.from_numpy, arrays),
                            torch.from_numpy(mask))).numpy()
        want = _lse64(arrays, mask)
        assert got.shape == want.shape == (3, 2, T)
        assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0,
                                                               np.abs(want)))
        return
    tol, jdt, tdt = {"f32": (1e-5, jnp.float32, torch.float32),
                     "bf16": (2e-2, jnp.bfloat16, torch.bfloat16)}[kind]
    ref = j_xl.xl_rel_attention(
        *(jnp.asarray(a, jdt) for a in arrays), jnp.asarray(mask),
        jnp.zeros((1,), jnp.int32), 0.0, True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = xl_rel_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in arrays),
        torch.from_numpy(mask))
    assert out.dtype == tdt and out.shape == ref.shape
    out = out.float().numpy()
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err
    assert np.all(out[-1] == 0) and np.all(ref[-1] == 0)
