"""K1's backward as the port's kernels compute it, three passes with no
atomics, against the JAX package on the CPU.

`attention_bwd_plain` is the kernels' order in plain PyTorch: delta =
rowsum(dO O), dk/dv over query slices of whole 64-row tiles summed in
slice order, dq over 64-key tiles. It is held against JAX's
`_run_bwd_blc` (the Pallas backward, in interpret mode) where the head
width divides the kernel's 128 lanes, and against the vjp of JAX's
`fused_attention_blc` where it does not (D=24, D=96: JAX takes its XLA
form there), at one key tile with several slices (Tq=70, Tk=32), Tq !=
Tk both ways, ragged masks and one fully masked row, whose gradients must
be exactly 0. Tolerance 1e-5 x max(1, max|ref|): f32 on both sides,
summed in another order. `dkv_splits`, the slice count, is held at the
shapes of the MQ, NLQ and VQ paths, and the slices' partials to one
slice's bits on inputs where f32 sums exactly. tests/test_torch_port_cuda.py holds
the CUDA kernels against these plain versions on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.attention as j_attn
from vilco_tpu_torch.core.config import (
    flagship_config,
    nlq_flagship_config,
    vq_flagship_config,
)
from vilco_tpu_torch.kernels.attention import (
    BWD_TILE,
    SMS,
    attention_bwd_plain,
    attention_lse_plain,
    dkv_splits,
    fused_attention_blc_plain,
)

TOL = 1e-5


def _inputs(seed, B, Tq, Tk, C):
    rng = np.random.default_rng(seed)
    f = lambda T: rng.standard_normal((B, T, C)).astype(np.float32)
    q, g, k, v = f(Tq), f(Tq), f(Tk), f(Tk)
    lens = rng.integers(Tk // 2, Tk + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return q, k, v, g, np.arange(Tk)[None, :] < lens[:, None]


def _port(q, k, v, g, mask, H, splits=None):
    t = [torch.from_numpy(x) for x in (q, k, v, g, mask)]
    out = fused_attention_blc_plain(*t[:3], t[4], H)
    lse = attention_lse_plain(t[0], t[1], t[4], H)
    return [x.numpy() for x in attention_bwd_plain(
        t[0], t[1], t[2], t[4], out, lse, t[3], H, splits)]


def _assert_close(got, refs, what):
    for name, a, b in zip("qkv", got, refs):
        b = np.asarray(b)
        err = np.abs(a - b).max()
        assert err <= TOL * max(1.0, np.abs(b).max()), (what, name, err)
        assert np.all(a[-1] == 0), (what, name, "fully masked row")


# (B, Tq, Tk, H, D, splits): None takes dkv_splits
PALLAS_CASES = [(3, 70, 32, 4, 32, None), (3, 70, 32, 2, 64, 2),
                (2, 130, 200, 2, 64, None), (2, 200, 70, 4, 32, 4),
                (2, 64, 64, 1, 128, 1)]


@pytest.mark.parametrize("B,Tq,Tk,H,D,splits", PALLAS_CASES)
def test_split_backward_matches_pallas(B, Tq, Tk, H, D, splits):
    q, k, v, g, mask = _inputs(Tq + Tk + D, B, Tq, Tk, H * D)
    refs = j_attn._run_bwd_blc(*map(jnp.asarray, (q, k, v, mask)), H,
                               jnp.asarray(g), True)
    _assert_close(_port(q, k, v, g, mask, H, splits), refs,
                  f"Pallas B={B} Tq={Tq} Tk={Tk} H={H} D={D}")


@pytest.mark.parametrize("B,Tq,Tk,H,D,splits",
                         [(3, 70, 32, 4, 24, None), (3, 70, 32, 4, 96, 2),
                          (2, 150, 40, 2, 96, None), (2, 40, 150, 2, 24, 1)])
def test_split_backward_matches_jax_where_d_does_not_divide_128(
        B, Tq, Tk, H, D, splits):
    q, k, v, g, mask = _inputs(Tq + Tk + D, B, Tq, Tk, H * D)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: j_attn.fused_attention_blc(*a, jm, H, True),
                     *map(jnp.asarray, (q, k, v)))
    _assert_close(_port(q, k, v, g, mask, H, splits), vjp(jnp.asarray(g)),
                  f"XLA B={B} Tq={Tq} Tk={Tk} H={H} D={D}")


def _path_shapes():
    """(label, B, H, Tq, Tk) of every K1 backward call on
    the three train paths: the MQ stem and branch self-attention at batch
    2, the NLQ text self- and video-to-text cross-attention at batch 4,
    the VQ query/frame decoder (the patch grid as tokens, 4 heads) at the
    HNM step's batch^2 pairs x 30 frames."""
    mq, nlq, vq = flagship_config(), nlq_flagship_config(), \
        vq_flagship_config()
    m = mq.model
    rows = [(f"MQ T={m.max_seq_len >> i}", mq.batch_size, m.n_head,
             m.max_seq_len >> i, m.max_seq_len >> i)
            for i in range(m.num_branch_layers + 1)]
    n, L = nlq.model, nlq.max_text_len
    rows += [("NLQ text", nlq.batch_size, n.n_head, L, L),
             ("NLQ cross", nlq.batch_size, n.n_head, n.max_seq_len, L)]
    frames, Lc = vq.batch_size ** 2 * vq.num_frames, \
        (vq.clip_size // vq.patch_size) ** 2
    rows += [("VQ decoder", frames, 4, Lc, Lc)]
    return rows


def test_dkv_splits_at_the_path_shapes():
    want = {"MQ T=1024": 1, "MQ T=512": 2, "MQ T=256": 2, "MQ T=128": 2,
            "MQ T=64": 1, "NLQ text": 1, "NLQ cross": 14, "VQ decoder": 1}
    got = {}
    for label, B, H, Tq, Tk in _path_shapes():
        n = got[label] = dkv_splits(B, H, Tq, Tk)
        tiles = -(-Tq // BWD_TILE)
        assert 1 <= n <= tiles, label
        blocks = -(-Tk // BWD_TILE) * H * B
        # one slice where the grid fills the card twice; else no more
        # slices than reach that, and every slice but the last full
        assert (n == 1) == (blocks >= 2 * SMS or tiles == 1), label
        per = -(-tiles // n)
        assert (n - 1) * per < tiles, label
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("zero", ["q", "k"])
def test_split_partials_sum_to_one_slice_where_f32_is_exact(zero):
    """Where every product and partial sum is exact in f32, the query
    slices' partials summed in slice order give the bits of one slice:
    the slices cover each query tile once, every slice's dk scaled alike.
    With q or k zero every valid score is 0 and p = 1/n, n a power of two
    (64 or 32 valid keys, one fully masked row); small integers elsewhere
    keep dk (k zero) or dq (q zero) and dv exact dyadic sums."""
    B, Tq, Tk, H, D = 3, 230, 64, 2, 16         # 4 query tiles, scale 1/4
    rng = np.random.default_rng(7)
    ints = lambda T: torch.from_numpy(
        rng.integers(-1, 2, size=(B, T, H * D)).astype(np.float32))
    q, k, v, g = ints(Tq), ints(Tk), ints(Tk), ints(Tq)
    (q if zero == "q" else k).zero_()
    mask = torch.arange(Tk)[None, :] < torch.tensor([64, 32, 0])[:, None]
    out = fused_attention_blc_plain(q, k, v, mask, H)
    lse = attention_lse_plain(q, k, mask, H)
    assert torch.equal(lse[:2], torch.tensor([6.0, 5.0])[:, None, None]
                       .expand(2, H, Tq)), "p is not exactly 1/n"
    one = attention_bwd_plain(q, k, v, mask, out, lse, g, H, splits=1)
    assert one[1 if zero == "k" else 0].abs().max() > 0
    assert one[2].abs().max() > 0
    for splits in (2, 3, 4):
        got = attention_bwd_plain(q, k, v, mask, out, lse, g, H, splits)
        for name, a, b in zip("qkv", got, one):
            assert torch.equal(a, b), (splits, name)
