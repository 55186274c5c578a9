"""AdamW with the reference's decay split, and the warmup + cosine schedule
(vilco_tpu/train/optim.py: weight_decay_mask, make_schedule, FusedAdamW).

The constants are what the flagships' `opt` sections share
(vilco_tpu/core/config.py OptCfg defaults, which configs/mq_vilco.yaml and
configs/nlq_vilco.yaml keep): AdamW, weight decay 0.05, betas (0.9,
0.999), eps 1e-8, bf16 first and second moments, cosine to 1e-8. The peak
lr, the epochs and the warmup epochs come from the config's `opt`
(core/config.py::OptCfg: MQ 10 epochs, NLQ 8, both 5 of warmup and lr
1e-4).

`FusedAdamW` keeps the JAX optimizer's state layout: moments of the big
leaves (>= 2^18 elements) one tensor each, those of the small leaves packed
into one flat buffer per moment. On the card one multi-tensor launch of
kernels/adamw.py updates every leaf in place, the small ones through their
slices of the flat buffers; on the CPU each big leaf and the packed small
leaves go through the kernel's plain version, as the JAX step's jnp path
does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from vilco_tpu_torch.core.config import OptCfg
from vilco_tpu_torch.kernels.adamw import (  # noqa: F401 (re-exported)
    B1,
    B2,
    WEIGHT_DECAY,
    LeafTable,
    adamw_update_multi,
    adamw_update_plain,
)

ETA_MIN = 1e-8
FLAT_ALIGN = 64    # elements: each leaf of a flat buffer 256-byte aligned
MOMENT_DTYPE = torch.bfloat16      # opt.mu_dtype = opt.nu_dtype = bfloat16
SMALL_LEAF_ELEMS = 1 << 18

# the per-class Gaussians fall to the reference's decayed catch-all group
_GAUSSIANS = ("mu", "sigma", "mu_reg_left", "mu_reg_right",
              "sigma_reg_left", "sigma_reg_right")


def decays(name: str, ndim: int) -> bool:
    """True where weight decay applies, on the port's parameter names
    (equal to vilco_tpu's weight_decay_mask through models/convert.py):
    conv and dense kernels (the time adapters', the cross-attention's and
    the narration encoder's among them), the XL q/k/v/r/o projections, the
    channel block's LayerNorm weight and the per-class Gaussians; not
    biases, other norms, scales, the XL r_w/r_r biases or the L2P prompts
    and prompt keys."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight" and ndim >= 2:
        return True
    if len(parts) == 1 and leaf in _GAUSSIANS:
        return True
    if any(p.startswith("xl_") for p in parts) and leaf in ("q", "k", "v",
                                                              "r", "o"):
        return True
    return ("channel_attn" in parts and leaf == "weight"
            and parts[-2].startswith("norm"))


def weight_decay_mask(named_params) -> Dict[str, bool]:
    return {n: decays(n, p.dim()) for n, p in named_params}


def flat_buffers(params) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
    """(offsets, param_flat, grad_flat): each leaf's first element in two
    f32 buffers on the parameters' device, every leaf starting on a
    FLAT_ALIGN boundary; each parameter's data becomes a view of
    param_flat (its values copied) and its .grad a view of grad_flat
    (zeros) at its offset, so that the whole model is one vector for the
    EWC/MAS penalty (cl/regularizers.py) and the optimizer's leaf table is
    built once."""
    offs, n = [], 0
    for p in params:
        offs.append(n)
        n += -(-p.numel() // FLAT_ALIGN) * FLAT_ALIGN
    dev = params[0].device
    pf = torch.zeros(n, device=dev)
    gf = torch.zeros(n, device=dev)
    for p, off in zip(params, offs):
        sl = slice(off, off + p.numel())
        pf[sl].view_as(p).copy_(p.data)
        p.data = pf[sl].view_as(p)
        p.grad = gf[sl].view_as(p)
    return offs, pf, gf


def make_schedule(opt: OptCfg, steps_per_epoch: int):
    """step -> lr (numpy f32): linear warmup over opt.warmup_epochs
    reaching opt.learning_rate at step warmup - 1, then cosine from the
    peak to ETA_MIN over opt.epochs, in the f32 arithmetic of the JAX
    schedule."""
    f = np.float32
    peak = opt.learning_rate
    warmup = opt.warmup_epochs * steps_per_epoch
    max_steps = opt.epochs * steps_per_epoch + warmup

    def sched(step: int) -> np.float32:
        s = f(step)
        if s < warmup:
            return f(peak) * s / f(max(warmup - 1, 1))
        t = (s - f(warmup)) / f(max(max_steps - warmup, 1))
        cos = f(1.0) + np.cos(f(math.pi) * t, dtype=f)
        return f(ETA_MIN) + f(0.5 * (peak - ETA_MIN)) * cos

    return sched


class FusedAdamW:
    """AdamW over `model.named_parameters()`, updated in place by `step`.
    State: `count` (steps taken), `mu_big`/`nu_big` (one moment tensor per
    big leaf), `mu_flat`/`nu_flat` (the small leaves' moments, packed in
    parameter order). The parameters and the gradients live in two
    persistent f32 buffers (`param_flat`, `grad_flat`, flat_buffers: each
    parameter's data and .grad a view of them at its `flat_offsets` entry;
    `zero_grad` clears the gradients)."""

    def __init__(self, model: torch.nn.Module, steps_per_epoch: int,
                 opt: OptCfg):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [decays(n, p.dim()) for n, p in named]
        self.small = [p.numel() < SMALL_LEAF_ELEMS for p in self.params]
        self.sched = make_schedule(opt, steps_per_epoch)
        self.count = 0
        dev = self.params[0].device
        z = lambda n: torch.zeros(n, dtype=MOMENT_DTYPE, device=dev)
        self.mu_big = [z(p.shape) for p, s in zip(self.params, self.small)
                       if not s]
        self.nu_big = [torch.zeros_like(m) for m in self.mu_big]
        self.offsets: List[int] = []
        off = 0
        for p, s in zip(self.params, self.small):
            self.offsets.append(off if s else -1)
            off += p.numel() if s else 0
        self.mu_flat, self.nu_flat = z(off), z(off)
        self._decay_flat = torch.cat([
            torch.full((p.numel(),), float(d), device=dev)
            for p, d, s in zip(self.params, self.decay, self.small) if s])
        self.flat_offsets, self.param_flat, self.grad_flat = flat_buffers(
            self.params)
        self._table = None
        if dev.type == "cuda":
            mu, nu = self.moments()
            self._table = LeafTable(
                [p.data for p in self.params], [p.grad for p in self.params],
                [mu[n] for n in self.names], [nu[n] for n in self.names],
                self.decay)

    def zero_grad(self) -> None:
        self.grad_flat.zero_()

    def moments(self) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """(mu, nu) per parameter name; small leaves as views of the flat
        buffers."""
        mu, nu, bi = {}, {}, 0
        for n, p, s, off in zip(self.names, self.params, self.small,
                                self.offsets):
            if s:
                sl = slice(off, off + p.numel())
                mu[n] = self.mu_flat[sl].view(p.shape)
                nu[n] = self.nu_flat[sl].view(p.shape)
            else:
                mu[n], nu[n] = self.mu_big[bi], self.nu_big[bi]
                bi += 1
        return mu, nu

    def coefficients(self):
        """(lr, bc1, bc2) of the coming step as f32 scalars."""
        c = np.float32(self.count + 1)
        return (self.sched(self.count), np.float32(1) - np.float32(B1) ** c,
                np.float32(1) - np.float32(B2) ** c)

    @torch.no_grad()
    def step(self, gscale: torch.Tensor) -> None:
        """One update from the gradients, each multiplied by the clip factor
        `gscale` (a 0-d f32 tensor on the parameters' device) inside the
        update."""
        lr, bc1, bc2 = self.coefficients()
        if self._table is not None:
            dev = self.grad_flat.device
            host = torch.tensor([lr, bc1, bc2], dtype=torch.float32,
                                pin_memory=True)
            coef = torch.cat([host.to(dev, non_blocking=True),
                              gscale.reshape(1).float()])
            adamw_update_multi(self._table, coef)
        else:
            self._step_plain(lr, bc1, bc2, gscale)
        self.count += 1

    def _step_plain(self, lr, bc1, bc2, gscale):
        grads = [p.grad for p in self.params]
        bi = 0
        for p, g, d, s in zip(self.params, grads, self.decay, self.small):
            if s:
                continue
            p2, m2, v2 = adamw_update_plain(p.data, g, self.mu_big[bi],
                                            self.nu_big[bi], d, lr, bc1,
                                            bc2, gscale)
            p.data.copy_(p2)
            self.mu_big[bi].copy_(m2)
            self.nu_big[bi].copy_(v2)
            bi += 1
        sm = [i for i, s in enumerate(self.small) if s]
        if not sm:
            return
        p_sm = torch.cat([self.params[i].data.reshape(-1) for i in sm])
        g_sm = torch.cat([grads[i].reshape(-1) for i in sm])
        p2, m2, v2 = adamw_update_plain(
            p_sm, g_sm, self.mu_flat, self.nu_flat, self._decay_flat, lr,
            bc1, bc2, gscale)
        self.mu_flat.copy_(m2)
        self.nu_flat.copy_(v2)
        for i in sm:
            p = self.params[i]
            off = self.offsets[i]
            p.data.copy_(p2[off:off + p.numel()].view(p.shape))
