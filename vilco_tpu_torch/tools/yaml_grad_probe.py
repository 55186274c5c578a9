"""Which part of the MQ yaml's CL train step sets the card-vs-CPU gradient
gap, with the f64 step as the witness of both f32 sides.

    python -m vilco_tpu_torch.tools.yaml_grad_probe [--trace-only]

Builds the kernels and runs chip_smoke.py's `mq_yaml_train_parity` phase
(one f32 step of the yaml model at batch 1 as CL task 1: the card, the
CPU, the card through the plain versions and the TF32 control, each also
against the same step in f64 on the CPU) in five variants:

  A  as chip_smoke.py runs it
  B  under cudnn.deterministic
  C  the time adapters at their init (fc2 zero), not redrawn
  D  the narration-SSL weight 0
  E  the AL loss weight 0

then F: the first embedding conv's weight gradient (backbone.embd_0, the
leaf the card reads furthest from the f64 step) from the f64 step's own
input and upstream gradient, in f32 by cuDNN (as the port runs it), by
aten with cuDNN off, and by one cuBLAS GEMM over the unfolded input, and
on the CPU, each against the f64 result, with its time by CUDA events;
then G: the gradient of every module's output in the same step on the CPU
in f32 and on the card in f32 (through the plain versions: no build),
with cuDNN on and off, each against the CPU's f64, in the backward's
order, which shows where the card's gradient first parts from the truth.

`--trace-only` runs G alone (and builds nothing). A variant's failed checks are printed and the next variant runs; the exit
code is 1 if any failed. Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from vilco_tpu_torch.core.config import mq_yaml_config
from vilco_tpu_torch.models.layers import MaskedConv


def parity_batch(cfg):
    """The parity phase's batch and points."""
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import level_lengths
    from vilco_tpu_torch.ops.assign import generate_points

    m = cfg.model
    batch = make_batch(np.random.default_rng(cs.SEED + 4), 1, cfg)
    batch["narration_valid"][:] = True
    return batch, generate_points(level_lengths(m), m.fpn_strides,
                                  m.regression_range)


RELU_INPUTS = ("backbone.embd_norm_0", "backbone.embd_norm_1")


def module_grads(cfg, device, dtype):
    """({(module name, call): gradient of its output, f64 on the CPU} of
    the CL step on `device` in `dtype`, in the order the backward reached
    them; {name: output} of the RELU_INPUTS), caught by global module
    hooks."""
    from vilco_tpu_torch.models.point_transformer import PointTransformer

    names, grads, calls, outs = {}, {}, {}, {}

    def pre(mod, args):
        if isinstance(mod, PointTransformer):
            names.update({id(m): n for n, m in mod.named_modules()})

    def fwd(mod, args, out):
        if names.get(id(mod)) in RELU_INPUTS:
            outs[names[id(mod)]] = out.detach().double().cpu()

    def back(mod, grad_in, grad_out):
        n = names.get(id(mod))
        if n is not None and grad_out and torch.is_tensor(grad_out[0]):
            calls[n] = calls.get(n, -1) + 1
            grads[(n, calls[n])] = grad_out[0].detach().double().cpu()

    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(fwd),
             torch.nn.modules.module.register_module_full_backward_hook(
                 back))
    try:
        cs.step_gradients(cfg, cs.YAML_TASK, *parity_batch(cfg), device,
                          dtype)
    finally:
        for h in hooks:
            h.remove()
    return grads, outs


def probe_trace(dev, cfg) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want, want_outs = module_grads(cfg, "cpu", torch.float64)
    runs = {"CPU": module_grads(cfg, "cpu", torch.float32)}
    with cs.plain_versions():
        runs["card"] = module_grads(cfg, dev, torch.float32)
        with torch.backends.cudnn.flags(enabled=False):
            runs["card, cuDNN off"] = module_grads(cfg, dev, torch.float32)
    outs = {r: o for r, (_, o) in runs.items()}
    runs = {r: g for r, (g, _) in runs.items()}
    rel = lambda got, w: ((got - w).abs().max()
                          / w.abs().max().clamp(min=1e-300)).item()
    rows = [(k, {r: rel(g[k], w) for r, g in runs.items()})
            for k, w in want.items() if all(k in g for g in runs.values())]
    cs.say(f"[probe_G] {len(rows)} module outputs' gradients, in the "
           f"backward's order, f32 vs f64 (max rel err): "
           + ", ".join(runs))
    worst = 0.0
    for (n, c), e in rows:
        if e["card"] > 2 * worst or n.startswith(("backbone.embd",
                                                  "backbone.stem_0.")):
            cs.say(f"[probe_G]   {n}#{c}: " + ", ".join(
                f"{r} {v:.3e}" for r, v in e.items()))
        worst = max(worst, e["card"])
    ratio = sorted(rows, key=lambda r: -r[1]["card"]
                   / max(r[1]["CPU"], 1e-300))[:8]
    cs.say("[probe_G] the largest card / CPU ratios: " + "; ".join(
        f"{n}#{c} {e['card']:.3e} / {e['CPU']:.3e}" for (n, c), e in ratio))
    # a ReLU passes the gradient where its input is > 0: an f32 input on
    # the other side of 0 from the f64 one drops (or lets through) the whole
    # gradient there
    for n in RELU_INPUTS:
        for r, o in outs.items():
            flip = (o[n] > 0) != (want_outs[n] > 0)
            keep = ~flip
            g, w = runs[r][(n, 0)], want[(n, 0)]
            rest = ((g - w).abs() * keep).max() / w.abs().max()
            near = (want_outs[n].abs() * flip).max().item()
            cs.say(f"[probe_G] {n} (a ReLU's input), {r} vs f64: "
                   f"{int(flip.sum())} of {flip.numel()} elements on the "
                   f"other side of 0 (the largest |f64 value| among them "
                   f"{near:.3e}); its output gradient's max rel err "
                   f"{rel(g, w):.3e}, {rest.item():.3e} without them")


def embd_conv_inputs(cfg):
    """(x (1, Cin, T), upstream gradient (1, E, T) with the mask applied,
    weight shape) of backbone.embd_0 in the f64 step of the parity phase,
    caught by global module hooks on the conv whose input width is the
    clips' feature width."""
    m = cfg.model
    seen = {}
    first = lambda mod: (isinstance(mod, MaskedConv)
                         and mod.weight.shape[1] == m.input_dim)

    def pre(mod, args):
        if first(mod):
            seen["x"], seen["mask"] = args[0].detach(), args[1]
            seen["shape"] = mod.weight.shape

    def back(mod, grad_in, grad_out):
        if first(mod):
            seen["g"] = grad_out[0].detach()

    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_full_backward_hook(
                 back))
    try:
        cs.step_gradients(cfg, cs.YAML_TASK, *parity_batch(cfg))
    finally:
        for h in hooks:
            h.remove()
    g = seen["g"] * seen["mask"][..., None].to(seen["g"].dtype)
    return seen["x"].transpose(1, 2), g.transpose(1, 2), seen["shape"]


def gemm_weight_grad(x, g, shape):
    """The conv's weight gradient as one GEMM: the upstream gradient
    (E, B T) times the zero-padded input unfolded to (B T, Cin K)."""
    B, Cin, T = x.shape
    cols = F.pad(x, (1, 1)).unfold(2, shape[2], 1)          # B Cin T K
    cols = cols.permute(0, 2, 1, 3).reshape(B * T, Cin * shape[2])
    g2 = g.permute(0, 2, 1).reshape(B * T, shape[0])
    return (g2.T @ cols).reshape(shape)


def probe_embd_conv(dev, cfg) -> None:
    x, g, shape = embd_conv_inputs(cfg)
    want = torch.nn.grad.conv1d_weight(x, shape, g, padding=1)
    cuda = lambda t: t.float().to(dev)
    xc, gc = cuda(x), cuda(g)
    wgrad = lambda: torch.nn.grad.conv1d_weight(xc, shape, gc, padding=1)

    def no_cudnn():
        with torch.backends.cudnn.flags(enabled=False):
            return wgrad()

    ways = (("cuDNN (as the port runs it)", wgrad),
            ("aten, cuDNN off", no_cudnn),
            ("one cuBLAS GEMM over the unfolded input",
             lambda: gemm_weight_grad(xc, gc, shape)),
            ("CPU f32", lambda: torch.nn.grad.conv1d_weight(
                x.float(), shape, g.float(), padding=1)))
    scale = want.abs().max().item()
    terms = (x.abs().amax((0, 2)).max() * g.abs().sum()).item()
    cs.say(f"[probe_F] backbone.embd_0 weight gradient {tuple(shape)} from "
           f"the f64 step: largest |dW| {scale:.4e}, a bound on its terms' "
           f"sum {terms:.4e}")
    for label, fn in ways:
        got = fn()
        err = ((got.double().cpu() - want).abs().max() / scale).item()
        ms = (cs.median_ms(fn, reps=10) if got.is_cuda
              else float("nan"))
        cs.say(f"[probe_F] {label}: max rel err vs f64 {err:.3e}, "
               f"{ms:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-only", action="store_true")
    args = ap.parse_args()
    failed = []

    def note(msg: str) -> None:
        failed.append(msg)
        print(f"FAIL (noted, the probe goes on): {msg}", flush=True)

    cs.fail = note
    cs.phase_device()
    dev = torch.device("cuda", 0)
    y = mq_yaml_config()
    if args.trace_only:
        probe_trace(dev, y)
        return 0
    cs.phase_build()
    redraw = cs.redraw_adapters
    variants = (
        ("A", "as chip_smoke.py runs it", y, {}),
        ("B", "cudnn.deterministic", y, {"deterministic": True}),
        ("C", "adapters at init (no redraw)", y, {"no_redraw": True}),
        ("D", "ssl_factor 0", dataclasses.replace(
            y, cl_cfg=dataclasses.replace(y.cl_cfg, ssl_factor=0.0)), {}),
        ("E", "AL loss weight 0", dataclasses.replace(
            y, train_cfg=dataclasses.replace(y.train_cfg,
                                             al_loss_weight=0.0)), {}),
    )
    for key, what, cfg, opt in variants:
        print(f"===== {key}: {what}", flush=True)
        cs.redraw_adapters = ((lambda m: None) if opt.get("no_redraw")
                              else redraw)
        torch.backends.cudnn.deterministic = bool(opt.get("deterministic"))
        t0 = time.perf_counter()
        cs.phase_train_parity(dev, f"probe_{key}", cfg, task=cs.YAML_TASK)
        print(f"===== {key}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cudnn.deterministic = False
    cs.redraw_adapters = redraw
    print("===== F: the first embedding conv's weight gradient", flush=True)
    probe_embd_conv(dev, y)
    print("===== G: every module's output gradient", flush=True)
    probe_trace(dev, y)
    print(f"failed checks: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
