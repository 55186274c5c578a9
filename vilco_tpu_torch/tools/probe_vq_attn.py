"""The VQ attention probe (P2) on the card: K1's forward at the ViT shape
with the probe's two switches.

    python -m vilco_tpu_torch.tools.probe_vq_attn [--seed 0]

Replaces tools/probe_vq_attn.py (the Pallas `run_variant`) with
kernels/attention.py::probe_variant, K1's CUDA forward with compile-time
switches. The shape is the probe's: 120 folded frames of 1152 tokens (the
ViT's 1025 valid, the rest masked keys), C 768 in 12 heads of 64, inputs
N(0, 2^2) in bf16. The variants:

  A_current  K1 itself (both switches off)
  B_bound    bound_shift: the row max replaced by |q_scaled| * max_j |k_j|
  C_mxusum   mxu_sum: the row sum of the bf16-rounded e as a product with
             ones on the tensor cores
  D_both     B and C together

Prints one JSON line per variant: `ms_per_call` (median of 10 calls by CUDA
events), `max_rel_err` against an exact f32 attention on the first 2 rows
over the valid tokens (the probe's measure, |got - ref| / (|ref| + 1e-3),
which one bf16 rounding of an output near 0 already puts near 1) beside
`max_abs_err_exact`, and `max_abs_err_plain`, the kernel's largest error
against its plain version on every row.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from vilco_tpu_torch.kernels.attention import (
    probe_variant,
    probe_variant_plain,
)

B, L, C, H = 120, 1152, 768, 12
D = C // H
VALID = 1025
VARIANTS = (("A_current", False, False), ("B_bound", True, False),
            ("C_mxusum", False, True), ("D_both", True, True))


def make_inputs(seed: int = 0, device="cuda", batch: int | None = None):
    """q, k, v (batch, L, C) bf16 from N(0, 2^2) and the (batch, L) mask of
    the VALID leading tokens; batch B by default."""
    batch = batch or B
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((batch, L, C), generator=gen, device=device)
               .mul_(2.0).to(torch.bfloat16) for _ in range(3))
    mask = (torch.arange(L, device=device) < VALID).expand(batch, L)
    return q, k, v, mask.contiguous()


def exact_reference(q, k, v, rows: int = 2):
    """Exact f32 attention of the first `rows` rows over the VALID keys:
    (rows, VALID, C)."""
    f = lambda x: x[:rows, :VALID].float().reshape(rows, VALID, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", f(q) / D ** 0.5, f(k))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), f(v))
    return o.reshape(rows, VALID, C)


def exact_errors(out, ref):
    """(max relative error as the probe measures it, max absolute error) of
    `out` against the exact reference on its rows and valid tokens."""
    diff = (out[:ref.shape[0], :VALID].float() - ref).abs()
    return (diff / (ref.abs() + 1e-3)).max().item(), diff.max().item()


def plain_error(q, k, v, mask, bound_shift, mxu_sum, out, chunk: int = 8):
    """(max |kernel - plain|, max |plain|) over every row, the plain version
    run `chunk` rows at a time (each row's keys are its own)."""
    err = ref = 0.0
    for i in range(0, q.shape[0], chunk):
        sl = slice(i, i + chunk)
        want = probe_variant_plain(q[sl], k[sl], v[sl], mask[sl], H,
                                   bound_shift, mxu_sum).float()
        err = max(err, (out[sl].float() - want).abs().max().item())
        ref = max(ref, want.abs().max().item())
    return err, ref


def median_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(seed: int = 0, device="cuda"):
    """One row per variant: variant, ms_per_call, max_rel_err,
    max_abs_err_exact, max_abs_err_plain (and max_abs_plain, the plain
    output's largest value)."""
    q, k, v, mask = make_inputs(seed, device)
    ref = exact_reference(q, k, v)
    rows = []
    for name, bs, ms in VARIANTS:
        call = lambda: probe_variant(q, k, v, mask, H, bs, ms)
        ms_per_call = median_ms(call)
        out = call()
        err, top = plain_error(q, k, v, mask, bs, ms, out)
        rel, diff = exact_errors(out, ref)
        rows.append({"variant": name, "ms_per_call": ms_per_call,
                     "max_rel_err": rel, "max_abs_err_exact": diff,
                     "max_abs_err_plain": err, "max_abs_plain": top})
        del out
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe times CUDA kernels: no card here")
    for row in run(args.seed):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
