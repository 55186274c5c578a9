"""The port's banded (sliding-window) attention against the JAX package.

`ops/attention.py::banded_attention` (the plain version of the K5 kernels)
and the `kernels/banded_attention.py` wrapper, which on the CPU takes that
plain version, against the JAX `ops.attention.banded_attention` (blocked
form, and the dense form where 2w + 1 >= T) and against the Pallas
`banded_attention_fused` in interpret mode (which runs its kernel where T
has a 128-multiple block and the XLA form elsewhere), over the NLQ pyramid's
corner cases: T = 8 with w = 4 (band wider than T), T = 40 (no 128 block),
128 and 256 (the Pallas kernel), 160; w = 1 and 4; ragged masks with one
fully masked row. Tolerances: forward 1e-5, gradients of a non-uniform
cotangent 1e-4, f32 on both sides (summation order differs).
tests/test_torch_port_cuda.py holds the CUDA kernels against the plain
version on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.kernels.banded_attention import banded_attention_fused
from vilco_tpu.ops.attention import banded_attention as j_banded
from vilco_tpu_torch.kernels.banded_attention import banded_attention_blc
from vilco_tpu_torch.ops.attention import banded_attention

B, H, D = 3, 2, 8


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    mask = np.arange(T)[None, :] < lens[:, None]
    return q, k, v, g, mask


def _port_grads(q, k, v, mask, g, w):
    """Forward and (dq, dk, dv) of <out, g> through the wrapper on the
    channels-last view, in (B, T, H, D)."""
    xs = [torch.from_numpy(x.reshape(B, -1, H * D)).requires_grad_()
          for x in (q, k, v)]
    out = banded_attention_blc(*xs, torch.from_numpy(mask), H, w)
    out.backward(torch.from_numpy(g.reshape(B, -1, H * D)))
    shape = q.shape
    return (out.detach().numpy().reshape(shape),
            [x.grad.numpy().reshape(shape) for x in xs])


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("T", [8, 40, 128, 160, 256])
def test_banded_attention_matches_jax(T, w):
    q, k, v, g, mask = _inputs(T, 10 * T + w)
    jq, jk, jv, jg, jm = map(jnp.asarray, (q, k, v, g, mask))
    refs = {
        "xla": lambda a, b, c: j_banded(a, b, c, jm, window=w),
        "pallas": lambda a, b, c: banded_attention_fused(a, b, c, jm, w, 0,
                                                         True),
    }
    plain = banded_attention(*map(torch.from_numpy, (q, k, v, mask)), w)
    out, grads = _port_grads(q, k, v, mask, g, w)
    np.testing.assert_array_equal(out, plain.numpy())
    assert np.all(out[-1] == 0)
    for name, fn in refs.items():
        def fwd_bwd(a, b, c, ct, fn=fn):
            ref, vjp = jax.vjp(fn, a, b, c)
            return ref, vjp(ct)

        ref, jgrads = jax.jit(fwd_bwd)(jq, jk, jv, jg)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        for i, (got, want) in enumerate(zip(grads, jgrads)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} grad {i}")


def test_banded_attention_bf16_rounds_only_its_output():
    """bf16 inputs run the same f32 arithmetic as their f32 values; only
    the output is rounded to bf16."""
    q, k, v, _, mask = _inputs(40, 3)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    m = torch.from_numpy(mask)
    out = banded_attention(qb, kb, vb, m, 4)
    assert out.dtype == torch.bfloat16
    ref = banded_attention(qb.float(), kb.float(), vb.float(), m, 4)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=0, rtol=0)


def test_banded_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 16)
    m = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        banded_attention_blc(x, x, x, m, 2, 0)
    with pytest.raises(ValueError):
        banded_attention_blc(x, x, x, m, 3, 4)
    with pytest.raises(ValueError):
        banded_attention_blc(x, x[:, :7], x, m, 2, 4)
    with pytest.raises(ValueError):
        banded_attention(x.reshape(1, 8, 2, 8), x.reshape(1, 8, 2, 8),
                         x.reshape(1, 8, 2, 8), m, 0)
