"""Each CUDA kernel of the port, forward and backward, against its plain
PyTorch version on the card, at small and odd lengths (2, 37, 70, 100, 256)
and head dims 24, 64, 128; the head-major (K1n) and flash (K1f) attention
and the probe's K1 variants (P2) from T=128 up to the ViT's 1025 tokens,
with a fully masked row; the banded kernels (K5's forward, its lse and
its one backward launch, two calls bitwise equal) also at the NLQ head dim
96, the edges of their row tiles, windows at and past the unroll cap,
the band wider than T, and a head dim that takes the scalar loads; the
frame-banded kernels at the VQ shape (fr 64, w 2, 8 heads of 32), odd fr,
frames longer than a tile and bands wider than the clip, the forward's lse
element by element, the backward's passes against their plain version, two
calls of each bitwise equal; the fused MLP at
the tiny twin's, a middle and the ViT-B width, up to the ViT's query call;
two K1f backward calls bitwise equal; K2-bwd's passes against their plain
version, two calls bitwise equal at dropout rate 0 and 0.1; K2's forward
at the edges of its tiles and band chunks (T 1 to 1024, D 32 to 128),
its lse, two calls bitwise equal, K2-bwd from its output; K3's row walk
(forward and its one backward launch) at T 1 to 129, odd T, one and two
channel columns a block and every walk length, dx and dw bitwise equal
over two calls, each call's own tickets, calls on two streams at once;
K1 forward and backward over the MQ yaml model's prompted text keys (208,
Tq 512 down to 2) and K3 at its text stem (T=208); make_multi_train_step's
captured graph against eager steps, bitwise, at the MQ yaml's twin; K1 in
f32 at the extractors' two shapes, the towers' answer for an empty text
(the mean of v) and the serving export on the card (no kernel in the
program, the eager forward matched). Marked
`gpu`: skips where there is no card. Imports no JAX, so that it runs on a
machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

import vilco_tpu_torch.kernels.banded_attention as banded
import vilco_tpu_torch.kernels.frame_band as fb
import vilco_tpu_torch.kernels.mlp as mlp
from vilco_tpu_torch.kernels.adamw import (
    LeafTable,
    adamw_update_multi,
    adamw_update_plain,
)
import vilco_tpu_torch.kernels.attention as attn
from vilco_tpu_torch.kernels.attention import (
    fused_attention_blc,
    fused_attention_blc_plain,
)
import vilco_tpu_torch.kernels.dwconv as dwconv
from vilco_tpu_torch.kernels.dwconv import (
    dwconv_bwd_cuda,
    fused_dwconv_qkv,
    fused_dwconv_qkv_plain,
)
from vilco_tpu_torch.kernels.xl_attention import (
    xl_bwd_cuda,
    xl_bwd_plain,
    xl_fwd_cuda,
    xl_lse_plain,
    xl_rel_attention,
    xl_rel_attention_plain,
)

# chip_smoke.py's limits, each against tol x max(1, max |ref|): forward
# outputs (bf16: one rounding of the output, and of P before P V) and the
# training kernels' outputs
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _mask(rng, B, T, dev):
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return torch.from_numpy(np.arange(T)[None, :] < lens[:, None]).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,D", [(2, 64), (37, 64), (256, 64), (100, 128),
                                 (70, 24)])
def test_kernels_match_plain_on_card(cuda, dtype, tol, T, D):
    """Tolerance: f32 1e-4 (summation order, exp2f); bf16 1e-2 (one
    rounding of the output, and of P before the P V product)."""
    rng = np.random.default_rng(T)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, H = 3, 4
    C = H * D
    q, k, v = rn(B, T, C), rn(B, T, C), rn(B, T, C)
    m = _mask(rng, B, T, cuda)
    out = fused_attention_blc(q, k, v, m, H)
    torch.testing.assert_close(
        out.float(), fused_attention_blc_plain(q, k, v, m, H).float(),
        atol=tol, rtol=tol)
    assert torch.all(out[-1] == 0)
    q4, k4, v4 = (t.reshape(B, T, H, D) for t in (q, k, v))
    r, rwb, rrb = rn(2 * T, H, D), rn(H, D) * 0.1, rn(H, D) * 0.1
    out = xl_rel_attention(q4, k4, v4, r, rwb, rrb, m)
    torch.testing.assert_close(
        out.float(),
        xl_rel_attention_plain(q4, k4, v4, r, rwb, rrb, m).float(),
        atol=tol, rtol=tol)
    assert torch.all(out[-1] == 0)
    if C % 8 == 0:
        w = rn(3, 3, C) * 0.3
        for s in (1, 2):
            for o, p in zip(fused_dwconv_qkv(q, w, s),
                            fused_dwconv_qkv_plain(q, w, s)):
                torch.testing.assert_close(o.float(), p.float(), atol=tol,
                                           rtol=tol)
    torch.cuda.synchronize()


def _grads(fn, inputs, g):
    """Gradients of <fn(*inputs), g> w.r.t. the float inputs."""
    xs = [x.detach().clone().requires_grad_() if x.is_floating_point()
          else x for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, g if isinstance(g, tuple) else (g,))
    return [x.grad for x in xs if x.is_floating_point()]


def _close(got, want, tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), (what, i)
        err = (a - b).abs().max().item()
        assert err <= tol * max(1.0, b.abs().max().item()), (what, i, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,D", [(2, 64), (37, 64), (256, 64), (100, 128),
                                 (70, 24)])
def test_backward_kernels_match_plain_on_card(cuda, dtype, tol, T, D):
    """Tolerance relative to the largest reference gradient: f32 1e-4
    (summation order); bf16 2e-2 (inputs and outputs rounded to bf16, P and
    dS rounded before their products, the backward reads the bf16 forward
    output)."""
    rng = np.random.default_rng(100 + T)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, H = 3, 4
    C = H * D
    q, k, v, g = rn(B, T, C), rn(B, T, C), rn(B, T, C), rn(B, T, C)
    m = _mask(rng, B, T, cuda)
    got = _grads(lambda *a: fused_attention_blc(*a, m, H), (q, k, v), g)
    want = _grads(lambda *a: fused_attention_blc_plain(*a, m, H), (q, k, v),
                  g)
    _close(got, want, tol, "attention_blc")
    assert all(torch.all(x[-1] == 0) for x in got)
    q4, k4, v4, g4 = (t.reshape(B, T, H, D) for t in (q, k, v, g))
    r, rwb, rrb = rn(2 * T, H, D), rn(H, D) * 0.1, rn(H, D) * 0.1
    for rate in (0.0, 0.1):
        args = (q4, k4, v4, r, rwb, rrb, m)
        out = xl_rel_attention(*args, 1234, rate)
        ref = xl_rel_attention_plain(*args, seed=1234, rate=rate)
        _close([out], [ref], tol, f"xl forward rate {rate}")
        got = _grads(lambda *a: xl_rel_attention(*a, 1234, rate), args, g4)
        want = _grads(lambda *a: xl_rel_attention_plain(*a, seed=1234,
                                                        rate=rate), args, g4)
        _close(got, want, tol, f"xl backward rate {rate}")
    if C % 8 == 0:
        w = rn(3, 3, C) * 0.3
        for s in (1, 2):
            To = (T - 1) // s + 1
            gs = tuple(rn(B, To, C) for _ in range(3))
            got = _grads(lambda a, b: fused_dwconv_qkv(a, b, s), (q, w), gs)
            want = _grads(lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                          (q, w), gs)
            _close(got, want, tol, f"dwconv stride {s}")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,H,D", [(37, 4, 64), (131, 4, 64), (70, 4, 20),
                                   (100, 2, 128)])
def test_xl_backward_passes_on_card(cuda, dtype, tol, T, H, D):
    """K2-bwd has no atomics: two calls give equal bits at rate 0 and 0.1,
    and each output is within tol x max(1, max |ref|) of `xl_bwd_plain`
    (the same passes in plain PyTorch) on the same forward output and lse;
    the fully masked row's dq, dk and dv are 0. D 20 stages rows element by
    element, D 128 pads to 128."""
    rng = np.random.default_rng(T + D)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B = 2
    args = (rn(B, T, H, D), rn(B, T, H, D), rn(B, T, H, D), rn(2 * T, H, D),
            rn(H, D) * 0.1, rn(H, D) * 0.1, _mask(rng, B, T, cuda))
    g = rn(B, T, H, D)
    seed = 0x243F6A8885A308D3
    st = torch.tensor([seed], dtype=torch.int64, device=cuda)
    for rate in (0.0, 0.1):
        out, lse = xl_fwd_cuda(args, st, rate, with_lse=True)
        first = xl_bwd_cuda(args, out, lse, g, st, rate)
        second = xl_bwd_cuda(args, out, lse, g, st, rate)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), rate
        _close(first, xl_bwd_plain(args, out, lse, g, seed, rate), tol,
               f"xl backward passes rate {rate}")
        assert all(torch.all(x[-1] == 0) for x in first[:3])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 131, 1024])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_xl_forward_edges_on_card(cuda, dtype, T, D):
    """K2's forward at lengths around its 64-row tiles and the band ring's
    64-row chunks (1, 63, 64, 65, 131, 1024) and head widths 32 to 128, at
    dropout rate 0 and 0.1: out within FWD_TOL of
    `xl_rel_attention_plain`; lse within FWD_TOL of `xl_lse_plain` on
    the batch rows with a valid key, and within 1e-6 of it relative on
    the fully masked one (-1e9 log2 e);
    two calls bitwise equal; the fully masked row exactly 0; K2-bwd from
    this (out, lse) within TRAIN_TOL of `xl_bwd_plain`."""
    rng = np.random.default_rng(T * 1000 + D)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, H = 2, 2
    args = (rn(B, T, H, D), rn(B, T, H, D), rn(B, T, H, D), rn(2 * T, H, D),
            rn(H, D) * 0.1, rn(H, D) * 0.1, _mask(rng, B, T, cuda))
    g = rn(B, T, H, D)
    seed = 0x13198A2E03707344
    st = torch.tensor([seed], dtype=torch.int64, device=cuda)
    for rate in (0.0, 0.1):
        out, lse = xl_fwd_cuda(args, st, rate, with_lse=True)
        again, lse2 = xl_fwd_cuda(args, st, rate, with_lse=True)
        assert torch.equal(out, again) and torch.equal(lse, lse2), rate
        assert torch.all(out[-1] == 0), rate
        _close([out], [xl_rel_attention_plain(*args, seed=seed, rate=rate)],
               FWD_TOL[dtype], f"xl forward rate {rate}")
        want = xl_lse_plain(args)
        _close([lse[:-1]], [want[:-1]], FWD_TOL[dtype], f"xl lse rate {rate}")
        torch.testing.assert_close(lse[-1], want[-1], rtol=1e-6, atol=0)
        _close(xl_bwd_cuda(args, out, lse, g, st, rate),
               xl_bwd_plain(args, out, lse, g, seed, rate), TRAIN_TOL[dtype],
               f"xl backward from the forward rate {rate}")
    torch.cuda.synchronize()


# (B, Tq, Tk, H, D): the NLQ head width, its video-to-text cross-attention
# (one key tile, a sliced dk/dv pass), the ViT's ragged 1025, Tq != Tk both
# ways, head widths below 32 (20 is no multiple of 8: rows are staged
# element by element, not by 16-byte copies)
K1_SHAPES = [(2, 200, 200, 4, 96), (4, 2560, 32, 4, 96),
             (2, 1025, 1025, 2, 64), (3, 300, 77, 2, 64),
             (2, 70, 130, 4, 24), (2, 130, 70, 4, 20)]


def _k1_inputs(rng, dev, dtype, B, Tq, Tk, H, D):
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    C = H * D
    return (rn(B, Tq, C), rn(B, Tk, C), rn(B, Tk, C), rn(B, Tq, C),
            _mask(rng, B, Tk, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,btol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 2e-2)])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_matches_plain_at_path_shapes_on_card(cuda, dtype, ftol, btol,
                                                 shape):
    """K1's forward and three-pass backward against the plain versions
    (autograd through the plain forward, and the plain three passes on
    the kernel's own out and lse); one wrapper call counts one launch.
    Tolerances as in the tests above: f32 1e-4 (summation order); bf16
    1e-2 forward (one rounding of the output and of P), 2e-2 backward (P
    and dS rounded before their products)."""
    B, Tq, Tk, H, D = shape
    q, k, v, g, m = _k1_inputs(np.random.default_rng(Tq + D), cuda, dtype,
                               *shape)
    n_fwd, n_bwd = fused_attention_blc.launches, attn.attention_bwd_cuda.launches
    with torch.no_grad():
        out = fused_attention_blc(q, k, v, m, H)
    _close([out], [fused_attention_blc_plain(q, k, v, m, H)], ftol,
           "K1 forward")
    got = _grads(lambda *a: fused_attention_blc(*a, m, H), (q, k, v), g)
    assert fused_attention_blc.launches == n_fwd + 2
    assert attn.attention_bwd_cuda.launches == n_bwd + 1
    want = _grads(lambda *a: fused_attention_blc_plain(*a, m, H), (q, k, v),
                  g)
    _close(got, want, btol, "K1 backward")
    o, lse = attn.attention_fwd_cuda(q, k, v, m, H, with_lse=True)
    # the fully masked row's lse is -1e8 - 99.7: compared apart
    _close([lse[:-1]], [attn.attention_lse_plain(q, k, m, H)[:-1]], 1e-4,
           "K1 lse")
    _close(attn.attention_bwd_cuda(q, k, v, m, o, lse, g, H),
           attn.attention_bwd_plain(q, k, v, m, o, lse, g, H), btol,
           "K1 backward against the plain three passes")
    assert all(torch.all(x[-1] == 0) for x in [out] + got)
    torch.cuda.synchronize()


# the MQ yaml model's text keys: 20 x 4 prompt tokens, all valid, then 128
# text tokens (Tk = 208, the last key tile 16 keys); the text stem's
# self-attention and the branch blocks' cross-attention, Tq 512 down to 2
YAML_TK, YAML_PROMPT = 208, 80


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,btol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 2e-2)])
@pytest.mark.parametrize("Tq", [208, 512, 64, 32, 16, 8, 4, 2])
def test_k1_at_mq_yaml_text_shapes_on_card(cuda, dtype, ftol, btol, Tq):
    """K1's forward and backward over the prompted text keys (16 heads of
    64, batch 2, one row with only the prompts valid) against autograd
    through the plain version, at the limits above; the backward (query
    slices in dk/dv where dkv_splits gives them) twice for equal bits; one
    launch a wrapper call."""
    B, H, D = 2, 16, 64
    rng = np.random.default_rng(Tq)
    q, k, v, g, _ = _k1_inputs(rng, cuda, dtype, B, Tq, YAML_TK, H, D)
    text = np.arange(YAML_TK - YAML_PROMPT)[None, :] < np.array([[37], [0]])
    m = torch.from_numpy(np.concatenate(
        [np.ones((B, YAML_PROMPT), bool), text], 1)).to(cuda)
    n_fwd, n_bwd = fused_attention_blc.launches, attn.attention_bwd_cuda.launches
    with torch.no_grad():
        out = fused_attention_blc(q, k, v, m, H)
    _close([out], [fused_attention_blc_plain(q, k, v, m, H)], ftol,
           "K1 forward")
    got = _grads(lambda *a: fused_attention_blc(*a, m, H), (q, k, v), g)
    assert fused_attention_blc.launches == n_fwd + 2
    assert attn.attention_bwd_cuda.launches == n_bwd + 1
    _close(got, _grads(lambda *a: fused_attention_blc_plain(*a, m, H),
                       (q, k, v), g), btol, "K1 backward")
    o, lse = attn.attention_fwd_cuda(q, k, v, m, H, with_lse=True)
    first = attn.attention_bwd_cuda(q, k, v, m, o, lse, g, H)
    second = attn.attention_bwd_cuda(q, k, v, m, o, lse, g, H)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_at_mq_yaml_text_stem_on_card(cuda, dtype):
    """K3 at the yaml model's text stem (T = 208, C = 1024, stride 1, batch
    2): q, k, v within FWD_TOL of the plain version, dx and dw within
    TRAIN_TOL of autograd through it, the backward twice for equal bits."""
    rng = np.random.default_rng(208)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    x, w = rn(2, YAML_TK, 1024), rn(3, 3, 1024) * 0.3
    gs = tuple(rn(2, YAML_TK, 1024) for _ in range(3))
    _close(fused_dwconv_qkv(x, w, 1), fused_dwconv_qkv_plain(x, w, 1),
           FWD_TOL[dtype], "dwconv forward")
    first = dwconv_bwd_cuda(x, w, *gs, 1)
    second = dwconv_bwd_cuda(x, w, *gs, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _close(first, _grads(lambda a, b: fused_dwconv_qkv_plain(a, b, 1),
                         (x, w), gs), TRAIN_TOL[dtype], "dwconv backward")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_is_bitwise_repeatable_on_card(cuda, dtype):
    """No atomics: two calls of the K1 backward give equal dq, dk and dv,
    with one query slice and with several (the NLQ cross-attention), on
    both layouts (K1n's backward is the same kernels)."""
    rng = np.random.default_rng(5)
    for shape in ((4, 2560, 32, 4, 96), (2, 1025, 1025, 2, 64)):
        B, Tq, Tk, H, D = shape
        q, k, v, g, m = _k1_inputs(rng, cuda, dtype, *shape)
        o, lse = attn.attention_fwd_cuda(q, k, v, m, H, with_lse=True)
        first = attn.attention_bwd_cuda(q, k, v, m, o, lse, g, H)
        second = attn.attention_bwd_cuda(q, k, v, m, o, lse, g, H)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        fold = lambda x: x.reshape(B, -1, H, D).permute(2, 0, 1, 3) \
            .contiguous()
        args = (fold(q), fold(k), fold(v), m)
        o, lse = attn.fused_attention_fwd_cuda(*args, with_lse=True)
        first = attn.fused_attention_bwd_cuda(*args, o, lse, fold(g))
        second = attn.fused_attention_bwd_cuda(*args, o, lse, fold(g))
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,w,D", [
    (8, 4, 96), (37, 4, 96), (160, 4, 96), (300, 1, 24), (100, 70, 64),
    (64, 64, 128), (2, 5, 32),
    # the tiles' edges (BT 64 rows forward, 32 backward): T = BT - 1, BT,
    # BT + 1, 2 BT + w
    (63, 4, 96), (64, 4, 8), (65, 4, 128), (132, 4, 96),
    (31, 4, 96), (32, 4, 24), (33, 8, 96), (68, 4, 96),
    # w at the unroll cap (8), one past it (two passes), w >= T
    (130, 8, 96), (130, 9, 96), (70, 9, 24), (40, 45, 96),
    # D not a multiple of the 16-byte vector: the scalar instantiation
    (70, 4, 37), (65, 9, 37)])
def test_banded_kernels_match_plain_on_card(cuda, dtype, tol, T, w, D):
    """K5's forward (and its lse) and its one backward launch against the
    plain versions with ragged masks and one fully masked row: the
    backward through autograd against autograd through the plain forward,
    and the kernel called on the forward's out and lse against
    `banded_attention_bwd_plain` on the same; two calls of each bitwise
    equal. Tolerance relative to each output's largest reference value: f32
    1e-4 (summation order); bf16 2e-2 (inputs and outputs rounded, the
    backward reading the bf16 forward output)."""
    rng = np.random.default_rng(200 + T + w)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, H = 3, 2
    C = H * D
    q, k, v, g = rn(B, T, C), rn(B, T, C), rn(B, T, C), rn(B, T, C)
    m = _mask(rng, B, T, cuda)
    with torch.no_grad():
        out = banded.banded_attention_blc(q, k, v, m, H, w)
    ref = banded.banded_attention_blc_plain(q, k, v, m, H, w)
    _close([out], [ref], tol, "banded forward")
    assert torch.all(out[-1] == 0)
    got = _grads(lambda *a: banded.banded_attention_blc(*a, m, H, w),
                 (q, k, v), g)
    want = _grads(lambda *a: banded.banded_attention_blc_plain(*a, m, H, w),
                  (q, k, v), g)
    _close(got, want, tol, "banded backward")
    assert all(torch.all(x[-1] == 0) for x in got)
    o, lse = banded.banded_fwd_cuda(q, k, v, m, H, w, True)
    o2, lse2 = banded.banded_fwd_cuda(q, k, v, m, H, w, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # element by element: a row whose band holds no valid key is -1e9 on
    # both sides (f32 rounds off the log of the slot count), every other
    # row within 1e-5 x max(1, |ref|)
    lse_ref = banded.banded_lse_plain(q, k, m, H, w)
    empty = lse_ref <= -1e8
    assert torch.equal(lse[empty], lse_ref[empty])
    err = (lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)
    assert err[~empty].max().item() <= 1e-5, "banded lse"
    first = banded.banded_bwd_cuda(q, k, v, m, o, lse, g, H, w)
    second = banded.banded_bwd_cuda(q, k, v, m, o, lse, g, H, w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _close(first, banded.banded_attention_bwd_plain(q, k, v, m, o, lse, g,
                                                    H, w), tol,
           "banded backward passes")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_banded_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    """On the card the wrapper launches its kernels (the forward's count
    and the one backward launch's rise by one) and no plain version is
    called."""
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("banded_attention_blc_plain", "banded_attention",
                 "banded_lse_plain", "banded_attention_bwd_plain"):
        monkeypatch.setattr(banded, name, refuse)
    x = torch.randn(2, 40, 192, device=cuda, requires_grad=True)
    m = torch.ones(2, 40, dtype=torch.bool, device=cuda)
    counts = (banded.banded_attention_blc.launches,
              banded.banded_bwd_cuda.launches)
    banded.banded_attention_blc(x, x, x, m, 2, 4).sum().backward()
    torch.cuda.synchronize()
    assert (banded.banded_attention_blc.launches,
            banded.banded_bwd_cuda.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(x.grad).all()
    with pytest.raises(TypeError):
        banded.banded_attention_blc(x.half(), x.half(), x.half(), m, 2, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 8), (torch.bfloat16, 16),
                                     (torch.bfloat16, 384), (torch.float32, 4),
                                     (torch.float32, 96)])
@pytest.mark.parametrize("T", [1, 2, 3, 5, 37, 63, 65, 129])
def test_dwconv_walk_on_card(cuda, dtype, C, T):
    """K3's row walk at both strides against the plain version: T 1, 2, 3
    and 5 below one walker's rows, odd T (one dx row fewer at stride 2),
    63 and 65 about a tile edge, C 8 and 16 bf16 and 4 f32 (blocks of one
    and two channel columns) and wider. q, k, v within FWD_TOL; dx and dw
    within TRAIN_TOL of autograd through the plain version; the backward
    one launch a call, its dx and dw bitwise equal over two calls, the
    forward one launch a call."""
    rng = np.random.default_rng(T * 7 + C)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B = 3
    x, w = rn(B, T, C), rn(3, 3, C) * 0.3
    for s in (1, 2):
        To = (T - 1) // s + 1
        gs = tuple(rn(B, To, C) for _ in range(3))
        n_fwd = fused_dwconv_qkv.launches
        _close(fused_dwconv_qkv(x, w, s), fused_dwconv_qkv_plain(x, w, s),
               FWD_TOL[dtype], f"dwconv forward stride {s}")
        assert fused_dwconv_qkv.launches == n_fwd + 1
        n_bwd = dwconv_bwd_cuda.launches
        first = dwconv_bwd_cuda(x, w, *gs, s)
        second = dwconv_bwd_cuda(x, w, *gs, s)
        assert dwconv_bwd_cuda.launches == n_bwd + 2
        assert all(torch.equal(a, b) for a, b in zip(first, second)), s
        _close(first, _grads(lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                             (x, w), gs), TRAIN_TOL[dtype],
               f"dwconv backward stride {s}")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", sorted(set(sum(dwconv.ROWS.values(), ()))))
def test_dwconv_every_walk_length_on_card(cuda, monkeypatch, dtype, rows):
    """Each number of rows a walker may take, forced through the plan, at
    a shape of several row blocks and channel groups (B 3, T 301, C 96):
    forward and backward against the plain version at both strides, each
    backward's own tickets (zeroed by its call) at row_blocks after it:
    every block of every channel group took one."""
    plan = dwconv.plan
    monkeypatch.setattr(dwconv, "plan", lambda B, T, C, s, kernel:
                        plan(B, T, C, s, kernel, rows))
    scratch, calls = dwconv._scratch, []

    def keep(p, device):
        out = scratch(p, device)
        calls.append((p, out[1]))
        return out

    monkeypatch.setattr(dwconv, "_scratch", keep)
    rng = np.random.default_rng(rows)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, T, C = 3, 301, 96
    x, w = rn(B, T, C), rn(3, 3, C) * 0.3
    for s in (1, 2):
        gs = tuple(rn(B, (T - 1) // s + 1, C) for _ in range(3))
        _close(fused_dwconv_qkv(x, w, s), fused_dwconv_qkv_plain(x, w, s),
               FWD_TOL[dtype], f"forward rows {rows} stride {s}")
        _close(_grads(lambda a, b: fused_dwconv_qkv(a, b, s), (x, w), gs),
               _grads(lambda a, b: fused_dwconv_qkv_plain(a, b, s), (x, w),
                      gs), TRAIN_TOL[dtype], f"backward rows {rows} s {s}")
    assert len(calls) == 2
    for p, tickets in calls:
        assert tickets.numel() == p.groups
        assert (tickets == p.row_blocks).all(), (p, tickets)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_adamw_kernel_matches_plain_on_card(cuda, mdt):
    """Every operation of the update is one IEEE-rounded operation on both
    sides (the kernel uses explicitly rounded intrinsics, the plain version
    one PyTorch kernel per operation), so they agree bit for bit."""
    rng = np.random.default_rng(1)
    sizes = [1, 37, 4096, 5000, 70000]
    f = lambda n: torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(cuda)
    ps = [f(n) for n in sizes]
    gs = [f(n) for n in sizes]
    ms = [f(n).to(mdt) for n in sizes]
    vs = [f(n).abs().to(mdt) for n in sizes]
    decays = [i % 2 == 0 for i in range(len(sizes))]
    coef = torch.tensor([1e-3, 0.271, 0.002997, 0.75], device=cuda)
    want = [adamw_update_plain(p, g, m, v, d, *coef)
            for p, g, m, v, d in zip(ps, gs, ms, vs, decays)]
    adamw_update_multi(LeafTable(ps, gs, ms, vs, decays), coef)
    torch.cuda.synchronize()
    for got, ref in zip(zip(ps, ms, vs), want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mdt,vdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_adamw_kernel_variants_match_plain_on_card(cuda, mdt, vdt):
    """m and v in their own dtypes, bf16 gradients on every other leaf
    (JAX's bf16 clip rounding) and their bf16 compute copies: bit for bit
    against the plain version, the copy against p' rounded to bf16."""
    rng = np.random.default_rng(2)
    sizes = [1, 37, 4096, 5000, 70000]
    f = lambda n: torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(cuda)
    bf = [i % 2 == 1 for i in range(len(sizes))]
    ps = [f(n) for n in sizes]
    gs = [f(n).to(torch.bfloat16 if b else torch.float32)
          for n, b in zip(sizes, bf)]
    ms = [f(n).to(mdt) for n in sizes]
    vs = [f(n).abs().to(vdt) for n in sizes]
    copies = [torch.zeros_like(p, dtype=torch.bfloat16) if b else None
              for p, b in zip(ps, bf)]
    decays = [i % 2 == 0 for i in range(len(sizes))]
    coef = torch.tensor([1e-3, 0.271, 0.002997, 0.75], device=cuda)
    want = [adamw_update_plain(p, g, m, v, d, *coef)
            for p, g, m, v, d in zip(ps, gs, ms, vs, decays)]
    adamw_update_multi(LeafTable(ps, gs, ms, vs, decays, copies), coef)
    torch.cuda.synchronize()
    for got, ref, c in zip(zip(ps, ms, vs), want, copies):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if c is not None:
            assert torch.equal(c, ref[0].to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_frames,fr,w,H,D", [
    (30, 64, 2, 8, 32), (3, 8, 2, 2, 32), (5, 7, 2, 3, 24), (4, 5, 0, 2, 16),
    (3, 100, 1, 2, 128), (6, 8, 1, 2, 64), (1, 64, 2, 8, 8)])
def test_frame_band_kernels_match_plain_on_card(cuda, dtype, tol, n_frames,
                                                fr, w, H, D):
    """K6 forward (the band mode of K1's forward) and backward against the
    plain versions (autograd through the plain forward, the plain walk
    `frame_band_fwd_plain`, and the plain backward passes on the kernel's
    own out and lse); the lse element by element against
    `frame_band_lse_plain` within 1e-4 + 1e-5 |lse| (f32 from the same
    inputs in both dtypes: the summation order of the dots and of l); two
    forward calls and two backward calls give equal bits (no atomics).
    Tolerance relative to each output's largest reference value: f32 1e-4
    (summation order, an online softmax against a two-pass one); bf16 2e-2
    (inputs and outputs rounded, P rounded before P V, P and dS before
    their products, the backward reading the bf16 forward output)."""
    rng = np.random.default_rng(300 + n_frames * fr + w)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, L = 2, n_frames * fr
    q, k, v, g = (rn(B, L, H * D) for _ in range(4))
    with torch.no_grad():
        out = fb.frame_band_attention(q, k, v, H, fr, w)
    _close([out], [fb.frame_band_attention_plain(q, k, v, H, fr, w)], tol,
           "frame band forward")
    got = _grads(lambda *a: fb.frame_band_attention(*a, H, fr, w), (q, k, v),
                 g)
    want = _grads(lambda *a: fb.frame_band_attention_plain(*a, H, fr, w),
                  (q, k, v), g)
    _close(got, want, tol, "frame band backward")
    o, lse = fb.frame_band_fwd_cuda(q, k, v, H, fr, w, True)
    o2, lse2 = fb.frame_band_fwd_cuda(q, k, v, H, fr, w, True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _close([o], [fb.frame_band_fwd_plain(q, k, v, H, fr, w)[0]], tol,
           "frame band forward against the plain walk")
    torch.testing.assert_close(lse, fb.frame_band_lse_plain(q, k, H, fr, w),
                               rtol=1e-5, atol=1e-4)
    first = fb.frame_band_bwd_cuda(q, k, v, o, lse, g, H, fr, w)
    second = fb.frame_band_bwd_cuda(q, k, v, o, lse, g, H, fr, w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _close(first, fb.frame_band_bwd_plain(q, k, v, o, lse, g, H, fr, w), tol,
           "frame band backward against the plain passes")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_frame_band_cuda_tensor_never_takes_the_plain_path(cuda,
                                                           monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fb, "frame_band_attention_plain", refuse)
    monkeypatch.setattr(fb, "frame_band_bwd_plain", refuse)
    x = torch.randn(2, 6 * 16, 64, device=cuda, requires_grad=True)
    counts = (fb.frame_band_attention.launches,
              fb.frame_band_bwd_cuda.launches)
    fb.frame_band_attention(x, x, x, 2, 16, 2).sum().backward()
    torch.cuda.synchronize()
    assert (fb.frame_band_attention.launches,
            fb.frame_band_bwd_cuda.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(x.grad).all()
    with pytest.raises(TypeError):
        fb.frame_band_attention(x.half(), x.half(), x.half(), 2, 16, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,C,Hd", [(1, 48, 192), (37, 48, 192),
                                    (600, 128, 512), (100, 768, 3072),
                                    (1000, 768, 3072), (8200, 768, 3072)])
def test_fused_mlp_matches_plain_on_card(cuda, dtype, tol, N, C, Hd):
    """K7 against the plain version, and its recomputed input gradient, at
    widths below one GEMM tile, a ragged N of a few 128-row tiles (1000)
    and the ViT's query call (8200 tokens). Tolerance relative to the
    output's largest value: f32 1e-4 (summation order); bf16 2e-2 (the
    GELU output rounded to bf16, and the biases rounded to bf16 in the
    kernel only)."""
    rng = np.random.default_rng(N + C)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(cuda)
    x = f(N, C).to(dtype)
    w1, b1 = f(C, Hd, sc=C ** -0.5), f(Hd, sc=0.1)
    w2, b2 = f(Hd, C, sc=Hd ** -0.5), f(C, sc=0.1)
    count = mlp.fused_mlp.launches
    with torch.no_grad():
        out = mlp.fused_mlp(x, w1, b1, w2, b2)
    assert mlp.fused_mlp.launches == count + 1
    _close([out], [mlp.fused_mlp_plain(x, w1, b1, w2, b2)], tol, "fused mlp")
    g = f(N, C).to(dtype)
    got = _grads(lambda a: mlp.fused_mlp(a, w1, b1, w2, b2), (x,), g)
    want = _grads(lambda a: mlp.fused_mlp_plain(a, w1, b1, w2, b2), (x,), g)
    _close(got, want, tol, "fused mlp input gradient")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,D", [(128, 64), (200, 32), (256, 128), (130, 24),
                                 (1025, 64)])
def test_flash_and_head_major_kernels_match_plain_on_card(cuda, dtype, tol,
                                                          T, D):
    """K1f (forward, dq, dk/dv) and K1n (forward, backward) against their
    plain versions, ragged masks and one fully masked row, where K1f
    averages v (the library's -0.7 * FLT_MAX) and K1n gives 0. Tolerance
    relative to each output's largest reference value: f32 1e-4 (summation
    order, an online softmax against a two-pass one); bf16 2e-2 (inputs
    and outputs rounded, P rounded before P V, the backward reading the
    bf16 forward output)."""
    rng = np.random.default_rng(400 + T + D)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    B, H = 3, 2
    q, k, v, g = (rn(B, T, H, D) for _ in range(4))
    m = _mask(rng, B, T, cuda)
    for fn, plain, counters in (
            (attn.flash_attention, attn.flash_attention_plain,
             (attn.flash_attention, attn.flash_bwd_cuda)),
            (attn.fused_attention, attn.fused_attention_plain,
             (attn.fused_attention, attn.fused_attention_bwd_cuda))):
        before = [c.launches for c in counters]
        with torch.no_grad():
            out = fn(q, k, v, m)
        ref = plain(q, k, v, m)
        _close([out], [ref], tol, f"{fn.__name__} forward")
        got = _grads(lambda *a: fn(*a, m), (q, k, v), g)
        want = _grads(lambda *a: plain(*a, m), (q, k, v), g)
        _close(got, want, tol, f"{fn.__name__} backward")
        assert [c.launches for c in counters] == [
            n + (2 if c is counters[0] else 1)
            for n, c in zip(before, counters)]
        if fn is attn.flash_attention:
            mean_v = v[-1].float().mean(0, keepdim=True).expand(T, H, D)
            _close([out[-1]], [mean_v], tol, "flash fully masked row")
            # the kernels' m and l, and their three passes against the
            # plain three passes from those m and l
            o, m_, l_ = attn.flash_fwd_cuda(q, k, v, m, with_stats=True)
            pm, pl = attn.flash_stats_plain(q, k, m)
            _close([m_[:-1], l_], [pm[:-1], pl], 1e-4, "flash m and l")
            assert torch.all(m_[-1] == pm[-1]) and torch.all(l_[-1] == T)
            _close(attn.flash_bwd_cuda(q, k, v, m, o, m_, l_, g),
                   attn.flash_attention_bwd_plain(q, k, v, m, o, m_, l_, g),
                   tol, "K1f backward against the plain three passes")
        else:
            assert torch.all(out[-1] == 0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1f_backward_is_bitwise_repeatable_on_card(cuda, dtype):
    """No atomics in flash mode either: two calls of the K1f backward give
    equal dq, dk and dv, with several query slices (the MQ stem at batch
    2) and with one (the ViT's 1025 tokens at batch 30), a fully masked
    row in each."""
    rng = np.random.default_rng(9)
    for B, T, H, D in ((2, 1024, 16, 64), (30, 1025, 12, 64)):
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (B, T, H, D)).astype(np.float32)).to(cuda, dtype)
            for _ in range(4))
        m = _mask(rng, B, T, cuda)
        o, mx, l = attn.flash_fwd_cuda(q, k, v, m, with_stats=True)
        first = attn.flash_bwd_cuda(q, k, v, m, o, mx, l, g)
        second = attn.flash_bwd_cuda(q, k, v, m, o, mx, l, g)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert all(torch.isfinite(x).all() for x in first)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_major_cross_attention_on_card(cuda, dtype):
    """K1n with Tq != Tk (both >= 128), and with Tk < 128, which takes K1
    on the channels-last view (JAX's XLA fallback)."""
    rng = np.random.default_rng(7)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for Tk, kernel in ((300, attn.fused_attention), (64, fused_attention_blc)):
        q, g = rn(2, 160, 4, 32), rn(2, 160, 4, 32)
        k, v = rn(2, Tk, 4, 32), rn(2, Tk, 4, 32)
        m = _mask(rng, 2, Tk, cuda)
        n = kernel.launches
        got = _grads(lambda *a: attn.fused_attention(*a, m), (q, k, v), g)
        want = _grads(lambda *a: attn.fused_attention_plain(*a, m),
                      (q, k, v), g)
        _close(got, want, tol, f"head-major Tk={Tk}")
        assert kernel.launches == n + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bound_shift,mxu_sum", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_probe_variants_match_plain_on_card(cuda, dtype, tol, bound_shift,
                                            mxu_sum):
    """P2: K1's forward with the probe's switches against the plain
    version, inputs N(0, 2^2) as the probe draws them, at two heads of 64
    and at the ViT's head layout; both switches off is K1 bit for bit.
    Tolerance: f32 1e-4; bf16 1e-2 (one rounding of the output and of e)."""
    rng = np.random.default_rng(11)
    for B, T, H in ((3, 300, 2), (2, 1025, 12)):
        q, k, v = (torch.from_numpy(
            (rng.standard_normal((B, T, H * 64)) * 2.0).astype(
                np.float32)).to(cuda, dtype) for _ in range(3))
        m = _mask(rng, B, T, cuda)
        n = attn.probe_variant.launches
        out = attn.probe_variant(q, k, v, m, H, bound_shift, mxu_sum)
        assert attn.probe_variant.launches == n + 1
        ref = attn.probe_variant_plain(q, k, v, m, H, bound_shift, mxu_sum)
        _close([out], [ref], tol, "probe variant")
        assert torch.all(out[-1] == 0)
        if not (bound_shift or mxu_sum):
            with torch.no_grad():
                assert torch.equal(out, fused_attention_blc(q, k, v, m, H))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_attention_impls_never_take_the_plain_path_on_card(cuda,
                                                           monkeypatch):
    """On the card the K1f, K1n and P2 wrappers launch their kernels (the
    counts rise) and never call a plain version; shapes and types the
    kernels do not take raise."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("flash_attention_plain", "fused_attention_plain",
                 "fused_attention_blc_plain", "probe_variant_plain",
                 "masked_attention"):
        monkeypatch.setattr(attn, name, refuse)
    x = torch.randn(2, 130, 2, 32, device=cuda, requires_grad=True)
    m = torch.ones(2, 130, dtype=torch.bool, device=cuda)
    for fn in (attn.flash_attention, attn.fused_attention):
        x.grad = None
        fn(x, x, x, m).sum().backward()
        assert torch.isfinite(x.grad).all()
    attn.probe_variant(x.detach().reshape(2, 130, 64), *(
        x.detach().reshape(2, 130, 64),) * 2, m, 2, True, True)
    torch.cuda.synchronize()
    wide = torch.randn(1, 128, 1, 160, device=cuda)
    m1 = torch.ones(1, 128, dtype=torch.bool, device=cuda)
    for fn in (attn.flash_attention, attn.fused_attention):
        with pytest.raises(ValueError):
            fn(wide, wide, wide, m1)
        with pytest.raises(TypeError):
            fn(x.half(), x.half(), x.half(), m)
    with pytest.raises(ValueError):
        attn.flash_attention(x, x[:, :128], x[:, :128], m[:, :128])
    with pytest.raises(ValueError):
        attn.probe_variant(*(wide.reshape(1, 128, 160),) * 3, m1, 1, True,
                           False)


def _state_bits(st, cl):
    opt = st.opt
    ts = [opt.param_flat, opt.scalars, opt.mu_flat, opt.nu_flat,
          *opt.mu_big, *opt.nu_big, st.loss_normalizer, cl.memory_bank,
          cl.memory_ptr, *st.adapter_ema.values()]
    return ts + [st.generator.get_state()]


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1.0, -1.0], ids=["clip", "no_clip"])
def test_multi_step_graph_replays_eager_steps_bitwise(cuda, clip):
    """make_multi_train_step on the card at the MQ yaml's tiny twin as CL
    task 1 (L2P, narration SSL, the adapter EMA), dropout, drop-path and
    the XL kernel's dropout at 0.1, bf16, cudnn.deterministic on: two
    calls of K = 3 (step 1 eagerly on the capture stream, the capture and
    2 replays; then 3 replays) against 6 eager steps of a clone, every
    buffer the step writes and the last metrics bitwise equal after each
    call; the wrappers' Python counters count the captured kernels once;
    the captured multi step refuses another state. With the clip off
    (clip_grad_l2norm <= 0, decided when the step is built) the graph
    holds the unclipped update and the metrics have no grad_norm."""
    import copy
    import dataclasses

    from vilco_tpu_torch.core.config import mq_yaml_config
    from vilco_tpu_torch.data.synthetic import make_batch, task_extras
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train import engine

    cfg = mq_yaml_config(tiny=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.1, droppath=0.1, xl_dropout=0.1),
        train_cfg=dataclasses.replace(cfg.train_cfg, clip_grad_l2norm=clip))
    m, K = cfg.model, 3
    ex = task_extras(cfg, 1, 2)
    model = PointTransformer(m, torch.Generator().manual_seed(0),
                             device="cpu", cl=cfg.cl_cfg)
    states = [engine.init_train_state(x, cfg, 1, seed=3, device=cuda)
              for x in (model, copy.deepcopy(model))]
    bank, ptr = engine.init_memory_bank(cfg, cuda)
    cls = [engine.CLBatchExtras(torch.from_numpy(ex["class_mask"]).to(cuda),
                                bank.clone(), ptr.clone()) for _ in range(2)]
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).to(cuda)
    kw = dict(regularize=True, compute_dtype=torch.bfloat16,
              cl_cfg=cfg.cl_cfg, n_known=ex["n_known"])
    multi = engine.make_multi_train_step(pts, cfg.train_cfg, K, **kw)
    step = engine.make_train_step(pts, cfg.train_cfg, **kw)
    rng = np.random.default_rng(1)
    bs = [dict(make_batch(rng, 2, cfg), prompt_mask=ex["prompt_mask"])
          for _ in range(K)]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(cuda)
               for k in bs[0]}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for call in range(2):
            n = fused_dwconv_qkv.launches
            got = multi(states[0], stacked, cls[0])
            assert fused_dwconv_qkv.launches - n == (2 * 5 if call == 0
                                                     else 0)
            for i in range(K):
                want = step(states[1], {k: v[i] for k, v in stacked.items()},
                            cls[1])
            torch.cuda.synchronize()
            assert states[0].step == states[1].step == K * (call + 1)
            assert got.keys() == want.keys()
            assert ("grad_norm" in got) == (clip > 0)
            assert all(torch.equal(got[k], want[k]) for k in got), call
            for i, (a, b) in enumerate(zip(_state_bits(states[0], cls[0]),
                                           _state_bits(states[1], cls[1]))):
                assert torch.equal(a, b), (call, i)
        assert multi.capture["seconds"] > 0
        with pytest.raises(ValueError, match="new multi step"):
            multi(states[1], stacked, cls[1])
    finally:
        torch.backends.cudnn.deterministic = was


@pytest.mark.gpu
def test_dwconv_backward_on_two_streams_at_once(cuda):
    """K3-bwd's tickets belong to each call: calls launched on two streams
    together (each behind a device sleep) give a lone call's bits."""
    rng = np.random.default_rng(4)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda, torch.bfloat16)
    B, T, C = 2, 1024, 256
    x, w, gs = rn(B, T, C), rn(3, 3, C) * 0.3, [rn(B, T, C) for _ in range(3)]
    lone = dwconv_bwd_cuda(x, w, *gs, 1)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for _ in range(8):
        outs = []
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(s):
                torch.cuda._sleep(1_000_000)
                outs.append(dwconv_bwd_cuda(x, w, *gs, 1))
        torch.cuda.synchronize()
        for dx, dw in outs:
            assert torch.equal(dx, lone[0]) and torch.equal(dw, lone[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,empty", [(64, 50, False), (32, 128, True)])
def test_k1_f32_at_extractor_shapes_on_card(cuda, B, T, empty):
    """K1 in f32 at the CLIP vision tower's shape (64 frames of 50 tokens,
    every key valid) and RoBERTa-base's (32 texts of 128 tokens, ragged,
    one empty), 12 heads of 64, against its plain version (FWD_TOL)."""
    rng = np.random.default_rng(B + T)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, k, v = rn(B, T, 768), rn(B, T, 768), rn(B, T, 768)
    m = (_mask(rng, B, T, cuda) if empty
         else torch.ones((B, T), dtype=torch.bool, device=cuda))
    n = fused_attention_blc.launches
    out = fused_attention_blc(q, k, v, m, 12)
    assert fused_attention_blc.launches == n + 1
    want = fused_attention_blc_plain(q, k, v, m, 12)
    tol = FWD_TOL[torch.float32] * max(1.0, want.abs().max().item())
    torch.testing.assert_close(out, want, atol=tol, rtol=0)


@pytest.mark.gpu
def test_empty_text_gives_the_mean_of_v_on_card(cuda):
    """The towers' attention through K1 (0 on a fully masked row) gives
    HF's answer for a text with no token, the mean of v over every key,
    and HF's finfo.min form elsewhere."""
    from vilco_tpu_torch.extractors.encoders import (
        attention_k1,
        attention_plain,
    )

    rng = np.random.default_rng(9)
    rn = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, k, v = rn(4, 128, 768), rn(4, 128, 768), rn(4, 128, 768)
    m = _mask(rng, 4, 128, cuda)
    n = fused_attention_blc.launches
    out = attention_k1(q, k, v, m, 12)
    assert fused_attention_blc.launches == n + 1
    torch.testing.assert_close(out[-1], v[-1].mean(0).expand(128, 768),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(
        out, attention_plain(q, k, v, m[:, None, None, :], 12),
        atol=FWD_TOL[torch.float32] * 5, rtol=0)


@pytest.mark.gpu
def test_exported_program_on_card_holds_no_kernel(cuda, tmp_path,
                                                  monkeypatch):
    """bin/export_model.py on the card: the program's calls are all ATen
    operators, it launches none of the port's kernels, and it matches the
    eager forward, which launches them (f32, the tiny MQ and NLQ twins;
    TF32 off, as the plain K3 is a cuDNN conv)."""
    import operator

    from vilco_tpu_torch.bin.export_model import (
        PointForward,
        export_forward,
        load_exported,
    )
    from vilco_tpu_torch.data.synthetic import tiny_config
    from vilco_tpu_torch.models.point_transformer import PointTransformer
    from vilco_tpu_torch.tasks.nlq import nlq_tiny_config

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for cfg, kernel in ((tiny_config(), fused_dwconv_qkv),
                        (nlq_tiny_config(), banded.banded_attention_blc)):
        model = PointTransformer(cfg.model, device=cuda, cl=cfg.cl_cfg).eval()
        ep = export_forward(cfg, model, cuda)
        other = {str(n.target) for n in ep.graph.nodes
                 if n.op == "call_function"
                 and n.target is not operator.getitem
                 and getattr(n.target, "namespace", None) != "aten"}
        assert not other, other
        torch.export.save(ep, str(tmp_path / "m.pt2"))
        prog = load_exported(str(tmp_path / "m.pt2"))
        rng = np.random.default_rng(3)
        B, T, C = cfg.batch_size, cfg.model.max_seq_len, cfg.model.input_dim
        xs = [torch.from_numpy(rng.standard_normal((B, T, C)).astype(
                  np.float32)).to(cuda),
              torch.from_numpy(np.arange(T)[None] < rng.integers(
                  T // 2, T + 1, (B, 1))).to(cuda)]
        if cfg.dataset.use_text:
            L = cfg.max_text_len
            text = rng.standard_normal((B, L, cfg.model.n_txt_in))
            xs += [torch.from_numpy(text.astype(np.float32)).to(cuda),
                   torch.ones((B, L), dtype=torch.bool, device=cuda)]
        n_k1, n_k = fused_attention_blc.launches, kernel.launches
        with torch.no_grad():
            got = prog(*xs)
            assert (fused_attention_blc.launches, kernel.launches) == (n_k1,
                                                                       n_k)
            want = PointForward(model, torch.float32)(*xs)
        assert kernel.launches > n_k
        for key in ("cls_logits", "offsets"):
            scale = want[key].abs().max().item()
            torch.testing.assert_close(got[key], want[key], rtol=0,
                                       atol=2e-5 * scale)


# the model options (scale_factor 4 levels 1024 down to 1, stacked XL, the
# stride-3 and stride-4 blocks): K1 at the stride-4 pyramid's lengths,
# 16 heads of 64, the last a level of one row
OPTION_K1_T = [256, 64, 16, 4, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,btol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 1e-2, 2e-2)])
@pytest.mark.parametrize("T", OPTION_K1_T)
def test_k1_at_scale_factor_4_levels_on_card(cuda, dtype, ftol, btol, T):
    """K1 forward and backward at scale_factor 4's level lengths (batch 2,
    a ragged mask: at one row the second row's only key is valid) against
    autograd through the plain version, at the limits above."""
    B, H, D = 2, 16, 64
    q, k, v, g, _ = _k1_inputs(np.random.default_rng(T), cuda, dtype, B, T,
                               T, H, D)
    m = torch.ones((B, T), dtype=torch.bool, device=cuda)
    m[1, max(1, T // 2):] = False
    with torch.no_grad():
        out = fused_attention_blc(q, k, v, m, H)
    _close([out], [fused_attention_blc_plain(q, k, v, m, H)], ftol,
           "K1 forward")
    _close(_grads(lambda *a: fused_attention_blc(*a, m, H), (q, k, v), g),
           _grads(lambda *a: fused_attention_blc_plain(*a, m, H), (q, k, v),
                  g), btol, "K1 backward")
    torch.cuda.synchronize()


def _option_model(cuda, **model):
    from dataclasses import replace

    from vilco_tpu_torch.data.synthetic import tiny_config
    from vilco_tpu_torch.models.point_transformer import PointTransformer

    cfg = tiny_config()
    m = replace(cfg.model, **model)
    return PointTransformer(m, device=cuda).to(torch.float32), m


@pytest.mark.gpu
def test_stacked_xl_matches_plain_on_card(cuda, monkeypatch):
    """The tiny model with two XL layers in f32: its forward and every
    parameter gradient with the kernels against the same inside
    kernels.plain_math(), 1e-4 of the largest; K2 and K2-bwd launched
    twice a forward and a backward (rate 0 in eval and with no rng)."""
    from vilco_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, m = _option_model(cuda, use_xl=True, xl_layers=2, xl_d_inner=64)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (2, m.max_seq_len, m.input_dim)).astype(np.float32)).to(cuda)
    mask = torch.ones((2, m.max_seq_len), dtype=torch.bool, device=cuda)
    mask[1, 40:] = False

    def run():
        model.zero_grad(set_to_none=True)
        out = model(x, mask)
        (out["cls_logits"].square().mean() + out["offsets"].mean()).backward()
        return [out["cls_logits"].detach()] + [
            p.grad.detach().clone() for p in model.parameters()
            if p.grad is not None]

    n_f, n_b = xl_rel_attention.launches, xl_bwd_cuda.launches
    got = run()
    assert (xl_rel_attention.launches - n_f, xl_bwd_cuda.launches - n_b) \
        == (2, 2)
    with kernels.plain_math():
        want = run()
    top = max(w.abs().max().item() for w in want[1:])
    for a, b in zip(got[1:], want[1:]):
        assert (a - b).abs().max().item() <= 1e-4 * top
    _close(got[:1], want[:1], 1e-4, "stacked XL forward")


@pytest.mark.gpu
def test_stride_2_odd_pairs_launch_k3s2_on_card(cuda, monkeypatch):
    """T = 60: the stride-2 branch blocks take 60, 30 and 15 rows, where
    JAX's Pallas conv gives way to its MaskedConvs (T not a multiple of
    4). The port launches K3s2 at every one of them, K3 at the stem
    blocks, and the f32 forward (TF32 off) equals the plain one within
    1e-4."""
    import vilco_tpu_torch.kernels.dwconv as dw
    from vilco_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, m = _option_model(cuda, max_seq_len=60)
    calls, fwd = [], dw.dwconv_fwd_cuda

    def record(x, w, stride):
        calls.append((x.shape[1], stride))
        return fwd(x, w, stride)

    monkeypatch.setattr(dw, "dwconv_fwd_cuda", record)
    x = torch.randn(2, 60, m.input_dim, device=cuda)
    mask = torch.ones((2, 60), dtype=torch.bool, device=cuda)
    mask[1, 41:] = False
    with torch.no_grad():
        out = model.eval()(x, mask)
        with kernels.plain_math():
            ref = model(x, mask)
    stems = m.backbone_arch[1] + (0 if m.use_xl else 1)
    branch = [(-(-60 // 2 ** i), 2) for i in range(m.num_branch_layers)]
    assert calls == [(60, 1)] * stems + branch
    assert [t for t, _ in branch][:3] == [60, 30, 15]
    _close([out["cls_logits"], out["offsets"]],
           [ref["cls_logits"], ref["offsets"]], 1e-4, "odd pairs forward")


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [3, 4])
def test_strides_above_2_launch_no_k3_on_card(cuda, monkeypatch, scale):
    """A branch block of stride 3 or 4 runs JAX's masked depthwise convs
    (s + 1 taps), not K3s2: K3 launches for the stem blocks only, and the
    f32 forward (TF32 off) equals the plain one within 1e-4."""
    from vilco_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    model, m = _option_model(cuda, scale_factor=scale)
    x = torch.randn(2, m.max_seq_len, m.input_dim, device=cuda)
    mask = torch.ones((2, m.max_seq_len), dtype=torch.bool, device=cuda)
    n = fused_dwconv_qkv.launches
    with torch.no_grad():
        out = model.eval()(x, mask)
        assert fused_dwconv_qkv.launches - n == m.backbone_arch[1] + (
            0 if m.use_xl else 1)
        with kernels.plain_math():
            ref = model(x, mask)
    _close([out["cls_logits"]], [ref["cls_logits"]], 1e-4, "stride forward")
