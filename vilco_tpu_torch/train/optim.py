"""The optimizer of JAX's `opt` section (vilco_tpu/train/optim.py:
weight_decay_mask, param_compute_mask, make_compute_copy, make_schedule,
make_optimizer, FusedAdamW), on the port's parameter names.

`make_optimizer(opt, model, steps_per_epoch)` gives, as JAX's does:
  - `FusedAdamW` for `type: adamw` with the full second moment: betas
    (0.9, 0.999), eps 1e-8, the decayed leaves' `weight_decay`, the first
    and second moments stored in `mu_dtype` and `nu_dtype` (each bfloat16
    or float32; the update in f32); with `param_compute_dtype: bfloat16`
    a persistent bf16 copy of the trunk's kernels (`param_compute_mask`)
    that the forward reads and the update rewrites;
  - `ChainOptimizer` for JAX's optax chains: `second_moment: factored`
    (optax.scale_by_factored_rms at its defaults, then a momentum trace
    of decay 0.9 stored in mu_dtype) and `type: sgd` (a momentum trace of
    decay `momentum`), each followed by the masked weight decay and the
    learning rate. The second moment stays f32 on these forms (JAX warns
    when nu_dtype asks for bf16), and param_compute_dtype bfloat16 raises.
The schedule is the warmup (optional) then cosine to `eta_min` or
multistep by `schedule_gamma` at `schedule_steps` epochs after the warmup.

`FusedAdamW` keeps the JAX optimizer's state layout: moments of the big
leaves (>= 2^18 elements) one tensor each, those of the small leaves packed
into one flat buffer per moment. On the card one multi-tensor launch of
kernels/adamw.py updates every leaf in place, the small ones through their
slices of the flat buffers; on the CPU each big leaf and the packed small
leaves go through the kernel's plain version, as the JAX step's jnp path
does. The chains run as plain PyTorch ops, leaf by leaf, on either device:
JAX computes them outside any Pallas kernel.

Every form reads the schedule's values of the coming step (the learning
rate, AdamW's bias corrections, Adafactor's decay rate) from `scalars`, a
persistent buffer on the parameters' device that `stage` fills from the
host before the update; `update` itself is device work only, so a CUDA
graph that captured it reads each replay's values from the buffer
(train/engine.py::make_multi_train_step). `step` is stage, update and the
count.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

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
    scale_grad,
)

FLAT_ALIGN = 64    # elements: each leaf of a flat buffer 256-byte aligned
SMALL_LEAF_ELEMS = 1 << 18
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the modules whose kernels the model consumes at bf16 (JAX's bf16_roots)
COMPUTE_ROOTS = ("backbone", "neck", "cls_head", "reg_head")
# optax.scale_by_factored_rms's defaults, and the momentum of the factored
# form (vilco_tpu/train/optim.py::make_optimizer)
FACTORED_DECAY_RATE = 0.8
FACTORED_EPSILON = 1e-30
FACTORED_MIN_DIM = 128
FACTORED_MOMENTUM = 0.9

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


def param_computes(name: str, ndim: int) -> bool:
    """True for the leaves of the bf16 compute copy (JAX's
    param_compute_mask on the port's names): a kernel (a `weight` of rank
    >= 2) under the backbone, the neck or a head. The prompt pool, the
    narration encoder, the norms and the per-class Gaussians stay f32."""
    parts = name.split(".")
    return parts[0] in COMPUTE_ROOTS and parts[-1] == "weight" and ndim >= 2


def param_compute_mask(named_params) -> Dict[str, bool]:
    return {n: param_computes(n, p.dim()) for n, p in named_params}


def make_compute_copy(named_params) -> Dict[str, torch.Tensor]:
    """{name: bf16 copy} of the masked leaves (JAX's make_compute_copy):
    the values the model's per-step cast would give."""
    return {n: p.detach().to(torch.bfloat16) for n, p in named_params
            if param_computes(n, p.dim())}


def jax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """The port's axes in the order of the JAX leaf's (models/convert.py:
    a Dense kernel is the Linear weight transposed, a conv kernel (K, Cin,
    Cout) or (kh, kw, Cin, Cout) the weight's axes reversed or moved; a
    transposed conv's kernel is also flipped, which moves no axis). What
    the factored second moment's choice of axes reads."""
    if name.split(".")[-1] != "weight" or ndim < 2:
        return tuple(range(ndim))
    if ndim == 2:
        return (1, 0)
    if ndim == 3:
        return (2, 1, 0)
    if name.split(".")[-2].startswith("up_"):
        return (2, 3, 0, 1)
    return (2, 3, 1, 0)


def factored_axes(name: str, shape) -> Optional[Tuple[int, int]]:
    """(a1, a0): the port's axes that optax's _factored_dims picks on the
    JAX leaf's shape (the second largest and the largest axis, by
    np.argsort), or None where the leaf keeps a full second moment (rank
    < 2, or the second largest axis < FACTORED_MIN_DIM)."""
    perm = jax_axes(name, len(shape))
    jshape = [shape[a] for a in perm]
    if len(jshape) < 2:
        return None
    order = np.argsort(jshape)
    if jshape[order[-2]] < FACTORED_MIN_DIM:
        return None
    return perm[int(order[-2])], perm[int(order[-1])]


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
    """step -> lr (numpy f32), JAX's make_schedule in its f32 arithmetic:
    with opt.warmup a linear warmup over opt.warmup_epochs reaching
    opt.learning_rate at step warmup - 1; then cosine from the peak to
    opt.eta_min over opt.epochs, or (schedule_type multistep) the peak x
    schedule_gamma^k, k the milestones (schedule_steps epochs after the
    warmup) at or before the step."""
    f = np.float32
    peak = opt.learning_rate
    warmup = opt.warmup_epochs * steps_per_epoch if opt.warmup else 0
    max_steps = opt.epochs * steps_per_epoch + warmup
    warm = lambda s: f(peak) * s / f(max(warmup - 1, 1))
    if opt.schedule_type == "cosine":
        eta = opt.eta_min

        def sched(step: int) -> np.float32:
            s = f(step)
            if s < warmup:
                return warm(s)
            t = (s - f(warmup)) / f(max(max_steps - warmup, 1))
            cos = f(1.0) + np.cos(f(math.pi) * t, dtype=f)
            return f(eta) + f(0.5 * (peak - eta)) * cos

        return sched
    if opt.schedule_type != "multistep":
        raise ValueError(f"opt.schedule_type={opt.schedule_type!r}: cosine "
                         "or multistep")
    ms = np.asarray(sorted(s * steps_per_epoch for s in opt.schedule_steps),
                    f)

    def sched(step: int) -> np.float32:
        s = f(step)
        if s < warmup:
            return warm(s)
        k = f(np.sum(ms <= s - f(warmup)))
        return f(peak) * f(opt.schedule_gamma) ** k

    return sched


def make_optimizer(opt: OptCfg, model: torch.nn.Module,
                   steps_per_epoch: int):
    """The optimizer of `opt` over `model.named_parameters()` (JAX's
    make_optimizer): FusedAdamW for adamw with the full second moment,
    else the optax chain's port (ChainOptimizer)."""
    kind = opt.type.lower()
    if kind not in ("adamw", "sgd"):
        raise ValueError(f"opt.type={opt.type!r}: adamw or sgd")
    if opt.second_moment not in ("full", "factored"):
        raise ValueError(f"opt.second_moment={opt.second_moment!r}: full "
                         "or factored")
    for field in ("mu_dtype", "nu_dtype", "param_compute_dtype"):
        if getattr(opt, field) not in DTYPES:
            raise ValueError(f"opt.{field}={getattr(opt, field)!r}: "
                             "bfloat16 or float32")
    if kind == "adamw" and opt.second_moment != "factored":
        return FusedAdamW(model, steps_per_epoch, opt)
    if opt.nu_dtype == "bfloat16":
        warnings.warn(
            "nu_dtype=bfloat16 is only honored on the FusedAdamW path; "
            "this optimizer keeps the second moment in float32")
    if opt.param_compute_dtype == "bfloat16":
        raise ValueError(
            "param_compute_dtype=bfloat16 requires the FusedAdamW path "
            "(adamw, non-factored): the chain would run its moment EMAs in "
            "the bf16 grad dtype")
    return ChainOptimizer(model, steps_per_epoch, opt)


class FlatOptimizer:
    """What every optimizer of the MQ/NLQ step shares: the parameters by
    name, their decay flags, the schedule, the step count, and the
    parameters and their gradients in two persistent f32 buffers
    (`param_flat`, `grad_flat`, flat_buffers: each parameter's data and
    .grad a view of them at its `flat_offsets` entry; `zero_grad` clears
    the gradients). `copies` is None but for FusedAdamW's compute copy.
    `scalars` (N_SCALARS f32 on the parameters' device) holds the coming
    step's `coefficients`, written by `stage`."""

    copies: Optional[Dict[str, torch.nn.Parameter]] = None
    N_SCALARS = 3

    def __init__(self, model: torch.nn.Module, steps_per_epoch: int,
                 opt: OptCfg):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [decays(n, p.dim()) for n, p in named]
        self.wd = opt.weight_decay
        self.sched = make_schedule(opt, steps_per_epoch)
        self.count = 0
        self.flat_offsets, self.param_flat, self.grad_flat = flat_buffers(
            self.params)
        self.scalars = torch.zeros(self.N_SCALARS,
                                   device=self.param_flat.device)

    def zero_grad(self) -> None:
        self.grad_flat.zero_()

    def coefficients(self) -> Tuple[np.float32, ...]:
        """The schedule's values of the coming step (step `count`) as f32
        scalars, in the order `update` reads them from `scalars`."""
        raise NotImplementedError

    def stage(self) -> None:
        """Write the coming step's coefficients into the first entries of
        `scalars`: on the card an asynchronous copy from a fresh pinned
        buffer (no host sync, and the buffer outlives the copy), on the CPU
        a plain copy."""
        host = torch.tensor(np.asarray(self.coefficients(), np.float32))
        dst = self.scalars[:host.numel()]
        if dst.is_cuda:
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)

    def update(self, gscale: torch.Tensor, bf16_grads: bool = False
               ) -> None:
        """One update from the gradients, each multiplied by the clip
        factor `gscale` (a 0-d f32 tensor on the parameters' device),
        reading the schedule's values from `scalars`: device work only,
        capturable in a CUDA graph. The caller stages before and counts
        after (train/engine.py::make_train_step)."""
        raise NotImplementedError


class FusedAdamW(FlatOptimizer):
    """AdamW over `model.named_parameters()`, updated in place by `update`.
    State: `count` (steps taken), `mu_big`/`nu_big` (one moment tensor per
    big leaf), `mu_flat`/`nu_flat` (the small leaves' moments, packed in
    parameter order), in opt.mu_dtype and opt.nu_dtype.

    With opt.param_compute_dtype bfloat16, `copies` maps each masked leaf's
    name (`param_computes`) to a bf16 parameter, a view of `pc_flat` at the
    leaf's flat offset, its .grad a view of `pc_grad_flat` (`copy_mask`
    marks their elements of the flat layout): the step's
    forward reads the copies in place of the f32 masters
    (torch.func.functional_call), their gradients land in bf16, and the
    update rewrites the copies from the new masters. Checkpoints, eval and
    the adapter EMA read the masters."""

    N_SCALARS = 4     # lr, bc1, bc2 and the clip factor: K4's coef

    def __init__(self, model: torch.nn.Module, steps_per_epoch: int,
                 opt: OptCfg):
        super().__init__(model, steps_per_epoch, opt)
        self.small = [p.numel() < SMALL_LEAF_ELEMS for p in self.params]
        dev = self.params[0].device
        mdt, vdt = DTYPES[opt.mu_dtype], DTYPES[opt.nu_dtype]
        big = [p for p, s in zip(self.params, self.small) if not s]
        self.mu_big = [torch.zeros(p.shape, dtype=mdt, device=dev)
                       for p in big]
        self.nu_big = [torch.zeros(p.shape, dtype=vdt, device=dev)
                       for p in big]
        self.offsets: List[int] = []
        off = 0
        for p, s in zip(self.params, self.small):
            self.offsets.append(off if s else -1)
            off += p.numel() if s else 0
        self.mu_flat = torch.zeros(off, dtype=mdt, device=dev)
        self.nu_flat = torch.zeros(off, dtype=vdt, device=dev)
        self._decay_flat = torch.cat([
            torch.full((p.numel(),), float(d), device=dev)
            for p, d, s in zip(self.params, self.decay, self.small) if s])
        if opt.param_compute_dtype == "bfloat16":
            self._init_copies()
        self._tables: Dict[bool, LeafTable] = {}
        # the update through K4 on the card; False sends it through the
        # plain version (a comparison)
        self.kernel = dev.type == "cuda"

    def _init_copies(self) -> None:
        n = self.param_flat.numel()
        dev = self.param_flat.device
        self.pc_flat = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        self.pc_grad_flat = torch.zeros_like(self.pc_flat)
        self.copy_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.copies = {}
        for name, p, off in zip(self.names, self.params, self.flat_offsets):
            if not param_computes(name, p.dim()):
                continue
            sl = slice(off, off + p.numel())
            self.copy_mask[sl] = True
            c = torch.nn.Parameter(torch.empty(0, dtype=torch.bfloat16,
                                               device=dev))
            c.data = self.pc_flat[sl].view(p.shape)
            c.grad = self.pc_grad_flat[sl].view(p.shape)
            self.copies[name] = c
        self.write_compute_copy()

    @torch.no_grad()
    def write_compute_copy(self) -> None:
        """The copies from the current masters (JAX's make_compute_copy,
        made for each task)."""
        own = dict(zip(self.names, self.params))
        for name, c in self.copies.items():
            c.data.copy_(own[name].data)

    def zero_grad(self) -> None:
        self.grad_flat.zero_()
        if self.copies is not None:
            self.pc_grad_flat.zero_()

    def fold_compute_grads(self) -> None:
        """Add the copies' bf16 gradients into the f32 gradient buffer and
        clear them: JAX's accumulation adds its micro-batches' gradients in
        f32 (the masters' own gradients are 0 there)."""
        self.grad_flat.add_(self.pc_grad_flat.float())
        self.pc_grad_flat.zero_()

    def grads(self, bf16_grads: bool) -> List[torch.Tensor]:
        """Each leaf's gradient: the copy's bf16 one for the masked leaves
        when `bf16_grads`, else the master's."""
        return [self.copies[n].grad if bf16_grads and self.copies is not None
                and n in self.copies else p.grad
                for n, p in zip(self.names, self.params)]

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
        """(lr, bc1, bc2) of the coming step as f32 scalars (the update
        writes the clip factor into scalars[3])."""
        c = np.float32(self.count + 1)
        return (self.sched(self.count), np.float32(1) - np.float32(B1) ** c,
                np.float32(1) - np.float32(B2) ** c)

    def table(self, bf16_grads: bool) -> LeafTable:
        """The kernel's leaf table (built once per gradient layout)."""
        if bf16_grads not in self._tables:
            mu, nu = self.moments()
            cp = self.copies or {}
            self._tables[bf16_grads] = LeafTable(
                [p.data for p in self.params], self.grads(bf16_grads),
                [mu[n] for n in self.names], [nu[n] for n in self.names],
                self.decay, [cp[n].data if n in cp else None
                             for n in self.names])
        return self._tables[bf16_grads]

    @torch.no_grad()
    def update(self, gscale: torch.Tensor, bf16_grads: bool = False) -> None:
        """The clip factor multiplies each gradient inside the update
        (kernels/adamw.py::scale_grad). `bf16_grads`: the masked leaves'
        gradients are the copies' (one micro-batch), else the masters'
        (after fold_compute_grads)."""
        self.scalars[3:].copy_(gscale.reshape(1))
        if self.kernel:
            adamw_update_multi(self.table(bf16_grads), self.scalars,
                               wd=self.wd)
        else:
            lr, bc1, bc2, g = self.scalars.unbind()
            self._step_plain(lr, bc1, bc2, g, self.grads(bf16_grads))

    def _step_plain(self, lr, bc1, bc2, gscale, grads):
        cp = self.copies or {}
        new = {}
        bi = 0
        for n, p, g, d, s in zip(self.names, self.params, grads, self.decay,
                                 self.small):
            if s:
                continue
            p2, m2, v2 = adamw_update_plain(p.data, g, self.mu_big[bi],
                                            self.nu_big[bi], d, lr, bc1,
                                            bc2, gscale, wd=self.wd)
            new[n] = p2
            self.mu_big[bi].copy_(m2)
            self.nu_big[bi].copy_(v2)
            bi += 1
        sm = [i for i, s in enumerate(self.small) if s]
        if sm:
            # each small leaf's gradient scaled in its own dtype, then the
            # packed update at gscale 1 (x * 1 is exact)
            p_sm = torch.cat([self.params[i].data.reshape(-1) for i in sm])
            g_sm = torch.cat([scale_grad(grads[i], gscale).reshape(-1)
                              for i in sm])
            p2, m2, v2 = adamw_update_plain(
                p_sm, g_sm, self.mu_flat, self.nu_flat, self._decay_flat,
                lr, bc1, bc2, wd=self.wd)
            self.mu_flat.copy_(m2)
            self.nu_flat.copy_(v2)
            for i in sm:
                off = self.offsets[i]
                new[self.names[i]] = p2[off:off + self.params[i].numel()]
        for n, p in zip(self.names, self.params):
            p.data.copy_(new[n].view(p.shape))
            if n in cp:
                cp[n].data.copy_(new[n].view(p.shape))


class ChainOptimizer(FlatOptimizer):
    """JAX's optax chains for the non-fused forms, leaf by leaf in plain
    PyTorch ops (the same on the card and the CPU):

      factored (second_moment factored): optax.scale_by_factored_rms() --
        Adafactor's second moment at decay 1 - (t + 1)^-0.8, epsilon 1e-30
        added to g^2; on a leaf whose two largest axes (JAX's layout) are
        >= 128 its row and column means, else the full g^2 -- then
        optax.trace(decay=0.9), the trace stored in opt.mu_dtype;
      sgd: optax.trace(decay=opt.momentum), f32;
    then u + weight_decay x p on the decayed leaves and p - lr u. The trace
    feeds the update unrounded and is rounded on store, as optax's."""

    def __init__(self, model: torch.nn.Module, steps_per_epoch: int,
                 opt: OptCfg):
        super().__init__(model, steps_per_epoch, opt)
        # adamw reaches the chain only with the factored second moment;
        # sgd ignores second_moment, as JAX's make_optimizer does
        self.factored = opt.type.lower() == "adamw"
        if self.factored:
            self.momentum = FACTORED_MOMENTUM
            tdt = DTYPES[opt.mu_dtype]
        else:
            self.momentum = opt.momentum
            tdt = torch.float32
        dev = self.param_flat.device
        self._mom = torch.tensor(self.momentum, dtype=torch.float32,
                                 device=dev)
        self._wd = torch.tensor(self.wd, dtype=torch.float32, device=dev)
        self.trace = [torch.zeros_like(p, dtype=tdt) for p in self.params]
        self.axes = [factored_axes(n, p.shape) if self.factored else None
                     for n, p in zip(self.names, self.params)]
        # per leaf the full second moment, or its (row, column) means
        self.v = []
        for p, ax in zip(self.params, self.axes):
            if self.factored:
                z = torch.zeros_like(p)
                self.v.append(z if ax is None else (z.mean(ax[1]),
                                                    z.mean(ax[0])))

    def coefficients(self):
        """(lr, the factored form's decay rate 1 - (t + 1)^-0.8 and one
        minus it) of the coming step as f32 scalars (SGD: the rates 0)."""
        lr = np.float32(self.sched(self.count))
        if not self.factored:
            return lr, np.float32(0), np.float32(0)
        t = np.float32(self.count + 1)
        rate = np.float32(1.0) - t ** np.float32(-FACTORED_DECAY_RATE)
        return lr, rate, np.float32(1.0) - rate

    @torch.no_grad()
    def update(self, gscale: torch.Tensor, bf16_grads: bool = False) -> None:
        lr, rate, one_minus = self.scalars.unbind()
        mom, wd = self._mom, self._wd
        for i, p in enumerate(self.params):
            g = scale_grad(p.grad, gscale)
            u = self._factored(i, g, rate, one_minus) if self.factored else g
            tr = self.trace[i]
            new_tr = u + (mom.to(tr.dtype) * tr).float()
            tr.copy_(new_tr)
            if self.decay[i]:
                new_tr = new_tr + wd * p.data
            p.data.copy_(p.data + (-lr) * new_tr)

    def _factored(self, i, g, rate, one_minus):
        sq = g * g + FACTORED_EPSILON
        if self.axes[i] is None:
            v = rate * self.v[i] + one_minus * sq
            self.v[i].copy_(v)
            return g * torch.rsqrt(v)
        a1, a0 = self.axes[i]
        vr0, vc0 = self.v[i]
        vr = rate * vr0 + one_minus * sq.mean(a0)
        vc = rate * vc0 + one_minus * sq.mean(a1)
        vr0.copy_(vr)
        vc0.copy_(vc)
        r1 = a1 - 1 if a1 > a0 else a1
        row = torch.rsqrt(vr / vr.mean(r1, keepdim=True))
        return g * row.unsqueeze(a0) * torch.rsqrt(vc).unsqueeze(a1)
