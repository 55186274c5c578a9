"""The MQ and NLQ train step (vilco_tpu/train/engine.py::make_train_step)
with every CL method JAX's step runs: naive; L2P with narration SSL and
the time adapters' EMA (the MQ yaml's); the EWC/MAS penalty over stacked
tasks (cl/regularizers.py); iCaRL's and BiC's distillation against
snapshot targets, and BiC's bias on the logits (cl/bic.py); each with
gradient accumulation over micro-batches; and the eval step
(`make_eval_step`, with the adapter ensemble).

    for each of K micro-batches: forward (training mode) -> BiC's bias
        -> compute_losses -> backward (the gradients add up)
        -> the SSL memory bank's ring write
    -> the gradients / K -> + the EWC/MAS penalty's gradient
    -> global-norm clip at train_cfg.clip_grad_l2norm (<= 0: none) -> the
       optimizer of cfg.opt
       (train/optim.py::make_optimizer)
    -> loss-normaliser EMA -> the adapter EMA

With the optimizer's bf16 compute copy (opt.param_compute_dtype bfloat16,
vilco_tpu/train/engine.py:395-400, :466-481) the forward reads the copy of
the trunk's kernels in place of their f32 masters and their gradients land
in bf16: with one micro-batch the clip norm sums their squares in f32 (f64
here) beside the other leaves' and K4 applies the clip factor to them in
bf16, as JAX's `g * scale.astype(g.dtype)`; with K micro-batches they add
up in the f32 gradient buffer, as JAX's accumulation does. The EWC/MAS
penalty reads the copy's values for those leaves and adds its gradient to
theirs in bf16. The update rewrites the copy.

Data parallelism (`dp`, parallel/mesh.py::DataParallel): each rank holds
its rows of every micro-batch and the step computes JAX's global-batch
function: #positives is all-reduced before the normaliser's update, the
distillation and SSL means divide by global counts, the SSL bank is
written with every rank's rows in global row order (so every rank keeps
the same bank), the prompt pool's vote is global, the dropout draws take
the global micro-batch's shape (each rank its rows), and after the
micro-batches ONE all-reduce (SUM) of the optimizer's flat gradient
buffer adds the ranks' partial gradients up, before the division by K,
the EWC/MAS penalty and the clip; the compute copy's bf16 gradients (one
micro-batch) have an all-reduce of their own, in bf16, as JAX sums them.
No DistributedDataParallel: it averages per-rank losses, a different
function here. The collectives run on the compute stream after each
backward.

`make_multi_train_step` runs K steps in one call: on the card one
captured CUDA graph of the step, replayed over pre-staged batches.

The step reads the config's `train_cfg` (core/config.py::TrainCfg): the
center sampling (radius 1.5 at JAX's defaults), the regression loss's
weight and the clip (1 and 1.0), label smoothing (NLQ 0.1), the Gaussian
loss weights (MQ only), the initial loss normaliser (MQ 100, NLQ 200), the
label-involved (AL) loss's weight (the MQ yaml 0.2) and the SSL
temperature; from its `cl_cfg`: the method, the SSL weight, the bank's
size and the distillation weight; from its `opt`: the accumulation steps.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vilco_tpu_torch.core.config import CLCfg, Config, TrainCfg
from vilco_tpu_torch.core.marks import mark
from vilco_tpu_torch.ops.assign import label_points
from vilco_tpu_torch.ops.losses import ctr_diou_loss_1d, sigmoid_focal_loss
from vilco_tpu_torch.parallel.mesh import RowDraw
from vilco_tpu_torch.train.optim import FlatOptimizer, make_optimizer

PULL_WEIGHT = 0.1        # the L2P pull: final -= 0.1 x reduce_sim
CL_METHODS = ("naive", "l2p", "ewc", "mas", "icarl", "bic")
BIC_T = 2.0              # BiC's distillation temperature
EMA_DECAY = 0.999        # the time adapters' EMA
AL_NEG = -1e7            # the AL loss's logit at invalid points, unseen classes


@dataclass
class CLBatchExtras:
    """Per-step CL inputs. `memory_bank` (M, E) f32 and `memory_ptr` (0-d
    int64), the narration-SSL negatives and the next row to write, are
    advanced in place by a step with SSL on (the tensors are written, not
    replaced). `prev_logits` (B, P, C) f32:
    the distillation targets, probabilities (`snapshot_targets`);
    `penalty`: the EWC/MAS penalty of the stacked tasks' fisher and optpar
    (cl/regularizers.py::RegPenalty); `bias_alpha`, `bias_beta` (C,) f32:
    BiC's per-class bias on the logits."""
    class_mask: torch.Tensor            # (C,) bool: the classes seen so far
    memory_bank: Optional[torch.Tensor] = None
    memory_ptr: Optional[torch.Tensor] = None
    prev_logits: Optional[torch.Tensor] = None
    penalty: Optional[object] = None
    bias_alpha: Optional[torch.Tensor] = None
    bias_beta: Optional[torch.Tensor] = None


@dataclass
class TrainState:
    """`model` holds the f32 master parameters and `opt` the optimizer
    (train/optim.py: FusedAdamW, or the chain of the factored and SGD
    forms);
    `generator` (on the model's device) draws drop-path, dropout and the
    XL kernel's dropout seed; `adapter_ema` maps each time-adapter
    parameter's name to its EMA (None without adapters). A step writes
    `loss_normalizer` (0-d f32) in place."""
    model: torch.nn.Module
    opt: FlatOptimizer
    loss_normalizer: torch.Tensor
    generator: torch.Generator
    step: int = 0
    adapter_ema: Optional[Dict[str, torch.Tensor]] = None


def init_adapter_ema(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of the time adapters' parameters, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if "adapter" in n.split(".")}


@torch.no_grad()
def update_adapter_ema(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
                       decay: float) -> None:
    """ema = decay ema + (1 - decay) p, in place, for each adapter leaf."""
    params = dict(model.named_parameters())
    for n, e in ema.items():
        e.copy_(decay * e + (1.0 - decay) * params[n])


def init_memory_bank(cfg: Config, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The narration-SSL memory bank's first value and pointer, as the JAX
    episode draws them (vilco_tpu/cl/episode.py): N(0, 1) rows from numpy's
    default_rng(0), (cl_cfg.memory_size, embd_dim) f32, and 0."""
    bank = np.random.default_rng(0).standard_normal(
        (cfg.cl_cfg.memory_size, cfg.model.embd_dim)).astype(np.float32)
    return (torch.from_numpy(bank).to(device),
            torch.zeros((), dtype=torch.int64, device=device))


def init_train_state(model: torch.nn.Module, cfg: Config,
                     steps_per_epoch: int, seed: int = 0,
                     device="cuda") -> TrainState:
    """Place `model` on `device` (the card unless the caller asks for the
    CPU; no card raises) and start the optimizer of `cfg.opt`
    (make_optimizer, with its compute copy where the config asks), the
    loss normaliser at `cfg.train_cfg.init_loss_norm` and, with
    `cfg.cl_cfg.use_adapt`, the adapter EMA at the adapters' values."""
    device = torch.device(device)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model,
                      opt=make_optimizer(cfg.opt, model, steps_per_epoch),
                      loss_normalizer=torch.tensor(
                          cfg.train_cfg.init_loss_norm, device=device),
                      generator=gen,
                      adapter_ema=(init_adapter_ema(model)
                                   if cfg.cl_cfg.use_adapt else None))


def compute_losses(outputs: dict, batch: dict, points: torch.Tensor,
                   cl: CLBatchExtras, loss_normalizer: torch.Tensor,
                   tc: TrainCfg, n_known: int = 0, ssl_factor: float = 0.0,
                   cl_method: str = "naive", dist_factor: float = 0.01,
                   dp=None):
    """Focal classification loss against the targets smoothed over the
    seen classes plus one, and Distance-IoU regression loss on the
    positives, with the Gaussian weights on the positives where
    `tc.use_gaussian_weights`, both over the new normaliser 0.9 old + 0.1
    max(#positives, 1), the regression loss x `tc.loss_weight` (1 where
    that is <= 0); the targets by `tc.center_sample` at
    `tc.center_sample_radius`; the AL loss x tc.al_loss_weight where that is > 0
    and there is more than one class; minus PULL_WEIGHT x the prompt
    pool's reduce_sim once `n_known` > 0; the distillation against
    `cl.prev_logits` once `n_known` > 0 (`distill_loss`: BiC's where
    `cl_method` is "bic", else iCaRL's); the narration-SSL loss x
    `ssl_factor` where the outputs hold narration features and `cl` a
    memory bank. The EWC/MAS penalty is the step's (it reads the
    parameters). Returns (loss, metrics, new normaliser).

    With `dp` (a data-parallel rank's place) the batch is the rank's rows
    of the global one: #positives (and so the normaliser) is the global
    count, the means divide by global counts, and the loss and its terms
    are this rank's share: the ranks' shares sum to the global values.
    The SSL branch leaves the gathered narration features and valid flags
    in outputs["narration_all"] for the step's bank write."""
    cls_logits = outputs["cls_logits"]            # (B, P, C) f32
    valid = outputs["fpn_mask"]                   # (B, P)
    class_mask_f = cl.class_mask.float()
    tgt = label_points(points, batch["gt_segments"], batch["gt_labels"],
                       batch["gt_valid"], cls_logits.shape[-1],
                       outputs["gaussians"], tc.center_sample_radius,
                       tc.center_sample)
    pos_mask = tgt.pos_mask & valid
    num_pos = pos_mask.float().sum()
    if dp is not None:
        num_pos = dp.sum(num_pos)
    norm = 0.9 * loss_normalizer + 0.1 * torch.clamp(num_pos, min=1.0)

    n_seen = class_mask_f.sum()
    gt_target = (tgt.cls * (1.0 - tc.label_smoothing)
                 + tc.label_smoothing / (n_seen + 1.0))
    cls_l = sigmoid_focal_loss(cls_logits, gt_target)
    cls_l = (cls_l * class_mask_f[None, None, :]).sum(-1)       # (B, P)
    reg_l = ctr_diou_loss_1d(outputs["offsets"], torch.clamp(tgt.reg,
                                                            min=0.0))
    if tc.use_gaussian_weights:
        cls_l = cls_l * torch.where(pos_mask, tgt.prob_cls,
                                    torch.ones_like(cls_l))
        reg_l = reg_l * (0.5 * (tgt.prob_reg_left + tgt.prob_reg_right)
                         * tgt.prob_cls)
    cls_loss = (cls_l * valid).sum() / norm
    reg_loss = (reg_l * pos_mask).sum() / norm
    reg_loss = torch.where(num_pos > 0, reg_loss, torch.zeros_like(reg_loss))

    final = cls_loss + reg_loss * (tc.loss_weight if tc.loss_weight > 0
                                   else 1.0)
    metrics = {"cls_loss": cls_loss, "reg_loss": reg_loss,
               "num_pos": num_pos}
    if tc.al_loss_weight > 0 and cls_logits.shape[-1] > 1:
        al_loss = label_involved_loss(cls_logits, valid, cl.class_mask,
                                      batch["gt_labels"],
                                      batch["gt_valid"]) / norm
        final = final + al_loss * tc.al_loss_weight
        metrics["al_loss"] = al_loss
    if "reduce_sim" in outputs and n_known > 0:
        final = final - PULL_WEIGHT * outputs["reduce_sim"]
        metrics["reduce_sim"] = outputs["reduce_sim"]
    if cl.prev_logits is not None and n_known > 0:
        dist = distill_loss(cls_logits, cl.prev_logits, valid,
                            outputs["level_lengths"], n_known, cl_method,
                            dist_factor,
                            None if dp is None else dp.rows(len(valid))[0])
        final = final + dist
        metrics["dist_loss"] = dist
    if "narration_feat" in outputs and cl.memory_bank is not None:
        nf, nvalid = outputs["narration_feat"], outputs["narration_valid"]
        every = None
        if dp is not None:
            every = (dp.gather(nf.detach()), dp.gather(nvalid))
            outputs["narration_all"] = every
        ssl = narration_ssl_loss(
            nf, outputs["video_feat"], nvalid, cl.memory_bank,
            cl.memory_ptr, tc.temperature, every) * ssl_factor
        final = final + ssl
        metrics["ssl_loss"] = ssl
    metrics["final_loss"] = final
    return final, metrics, norm


def distill_loss(cls_logits, prev, valid, lens, n_known: int,
                 cl_method: str, dist_factor: float,
                 n_rows: Optional[int] = None):
    """The distillation term (vilco_tpu/train/engine.py:178-203) over the
    first `n_known` classes against the targets `prev` (probabilities):
    BiC's softmax-T cross-entropy at T = BIC_T x dist_factor x n_known / C,
    or iCaRL's BCE-with-logits summed over the classes x dist_factor. Per
    clip, each level's mean over its valid points (`lens` the levels'
    lengths), summed over the levels; then the mean over the batch (over
    `n_rows` rows where given: a data-parallel rank's share of the global
    mean)."""
    x = cls_logits[..., :n_known]
    t = prev[..., :n_known].to(x.dtype)
    if cl_method == "bic":
        per_pt = -(t * torch.log_softmax(x / BIC_T, -1)).sum(-1)
        factor = dist_factor * (n_known / cls_logits.shape[-1])
    else:
        per_pt = (torch.clamp(x, min=0) - x * t
                  + torch.log1p(torch.exp(-x.abs()))).sum(-1)
        factor = dist_factor
    vf = valid.to(per_pt.dtype)
    lens = list(lens)
    sums = torch.stack([a.sum(1) for a in torch.split(per_pt * vf, lens, 1)],
                       1)
    counts = torch.stack([a.sum(1) for a in torch.split(vf, lens, 1)], 1)
    per_clip = (sums / torch.clamp(counts, min=1.0)).sum(-1)
    if n_rows is None:
        return factor * per_clip.mean()
    return factor * per_clip.sum() / n_rows


def snapshot_targets(cls_logits: torch.Tensor, cl_method: str,
                     n_known: int) -> torch.Tensor:
    """The distillation targets from an eval step's cls_logits, on their
    device (vilco_tpu/cl/episode.py::snapshot_logits): for BiC past task 0
    softmax(z / BIC_T) over the first n_known classes, zero-padded to C;
    else sigmoid(z)."""
    z = cls_logits.float()
    if cl_method == "bic" and n_known > 0:
        out = torch.zeros_like(z)
        out[..., :n_known] = torch.softmax(z[..., :n_known] / BIC_T, -1)
        return out
    return torch.sigmoid(z)


def label_involved_loss(cls_logits, valid, class_mask, gt_labels, gt_valid):
    """The AL loss before the normaliser (vilco_tpu/train/engine.py:125-140):
    per clip and seen class, the BCE of the class's largest softmax
    probability over the valid points (softmax over the seen classes)
    against whether a valid GT segment carries the class."""
    C = cls_logits.shape[-1]
    logits = torch.where(valid[..., None] & class_mask[None, None, :],
                         cls_logits, torch.full_like(cls_logits, AL_NEG))
    p = torch.softmax(logits, -1).amax(1).clamp(1e-7, 1.0 - 1e-7)  # (B, C)
    involved = torch.zeros_like(p).scatter_reduce(
        1, gt_labels.clamp(0, C - 1), gt_valid.to(p.dtype), "amax")
    al = -involved * torch.log(p) - (1 - involved) * torch.log1p(-p)
    return (al * class_mask.to(p.dtype)[None, :]).sum()


def ring_update(bank, ptr, feats, valid):
    """The memory bank's ring write (vilco_tpu/train/engine.py::
    _ring_update): the valid rows of `feats` in order from row `ptr`,
    wrapping at M; returns (new bank, (ptr + #valid) mod M). The invalid
    rows go to a scratch row past the bank, so nothing syncs with the
    host."""
    M = bank.shape[0]
    nv = valid.to(torch.int64)
    idx = torch.where(valid, (ptr + torch.cumsum(nv, 0) - 1) % M,
                      torch.full_like(nv, M))
    ext = torch.cat([bank, bank.new_zeros((1, bank.shape[1]))])
    ext = ext.index_put((idx,), feats.to(bank.dtype))
    return ext[:M], (ptr + nv.sum()) % M


def narration_ssl_loss(nf, vf, narration_valid, bank, ptr,
                       temperature: float, every=None):
    """The narration-SSL InfoNCE (vilco_tpu/train/engine.py::
    narration_ssl_loss), the JAX package's quirk kept: the bank is first
    written with the batch's detached narration features, so each valid
    row meets its own narration among the negatives; text-to-video and
    video-to-text cross-entropies averaged, over the valid rows. `every`,
    (narration features, valid) of the global batch under data
    parallelism: the bank is written with them and the mean is over the
    global batch's valid rows (this rank's share of it)."""
    nvalid = narration_valid.to(nf.dtype)
    all_nf, all_valid = every if every is not None else (nf.detach(),
                                                         narration_valid)
    neg_bank, _ = ring_update(bank, ptr, all_nf, all_valid)
    pos = (nf * vf).sum(-1, keepdim=True)
    lt = torch.cat([pos, nf @ neg_bank.T], 1) / temperature
    lv = torch.cat([pos, vf @ neg_bank.T], 1) / temperature
    ce = lambda lg: -torch.log_softmax(lg, -1)[:, 0]
    per_row = 0.5 * (ce(lt) + ce(lv))
    return (per_row * nvalid).sum() / torch.clamp(
        all_valid.to(nf.dtype).sum(), min=1.0)


def global_norm_clip(grad_flat: torch.Tensor,
                     extra: Optional[torch.Tensor] = None,
                     clip: float = 1.0):
    """(global L2 norm of the gradients, clip factor min(1, clip / (norm +
    1e-9))), both 0-d f32 tensors on the gradients' device; `grad_flat`
    holds every gradient (the optimizer's buffer), `extra` the compute
    copy's bf16 ones where they are kept apart. The sum of squares runs in
    f64: one f32 reduction over the whole buffer drifts ~2e-5 from optax's
    per-leaf sums."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float64)
             for g in (grad_flat, extra) if g is not None]
    gnorm = torch.linalg.vector_norm(torch.stack(norms)).float()
    return gnorm, torch.clamp(clip / (gnorm + 1e-9), max=1.0)


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(points: torch.Tensor, tc: TrainCfg, *,
                    regularize: bool = True,
                    compute_dtype: Optional[torch.dtype] = None,
                    cl_cfg: Optional[CLCfg] = None, n_known: int = 0,
                    ema_decay: float = EMA_DECAY,
                    accumulation_steps: int = 1, dp=None) -> Callable:
    """step(state, batch, cl, marks=None) -> metrics (0-d tensors, no
    host sync). `batch` holds tensors on the model's device: the text's
    `text` and `text_mask`, and for the CL method's extras `narration`,
    `narration_mask`, `narration_valid` (read with `cl_cfg.narration_ssl`)
    and `prompt_mask` (read with `cl_cfg.prompt_pool`). `tc`: the config's
    train_cfg; `cl_cfg` its cl_cfg (None: the naive method); `n_known`:
    the classes of the tasks before this one (the L2P pull and the
    distillation from 1 on). From `cl`: BiC's bias on the logits
    (`bias_alpha`, `bias_beta`), the distillation targets (`prev_logits`)
    and the EWC/MAS penalty (`penalty`, its gradient added once after the
    micro-batches, before the clip), each where given.

    `accumulation_steps` K (the config's opt.accumulation_steps): the
    batch's rows split into K micro-batches in order (micro-batch k is
    rows [k b/K, (k+1) b/K); a batch size K does not divide raises), each
    with its forward, its drop-path and dropout draws, its normaliser
    update and its ring write of the memory bank; the K backwards add up
    in the optimizer's f32 gradient buffer, which is then divided by K;
    one AdamW update; the metrics are the micro-batches' means.

    After the update, with `state.adapter_ema` the step moves the EMA
    toward the updated adapters at `ema_decay`. The step writes in place:
    the parameters, the optimizer's buffers, `state.loss_normalizer`, the
    adapter EMA, and `cl.memory_bank` / `cl.memory_ptr` (with SSL on).
    `step.body` is the step without the host's part (staging the
    optimizer's scalars before it, the counts after it), the function a
    CUDA graph captures (make_multi_train_step). regularize: drop-path and
    dropouts from state.generator (off: the deterministic step of the
    parity checks). `marks`, if a list, receives (phase, CUDA event or
    host time) at the forward / backward / optimizer boundaries (per
    micro-batch for the first two).

    `dp` (parallel/mesh.py::DataParallel; None: one process): `batch` is
    this rank's rows of the global batch, its share of every micro-batch
    (parallel/mesh.py::shard_rows), and the step is the global batch's
    (module docstring); the metrics are the global batch's, the same on
    every rank. With the optimizer's compute copy and one micro-batch its
    bf16 gradients are all-reduced in bf16 (DataParallel.all_reduce_bf16_),
    the other gradients in f32."""
    cl_cfg = cl_cfg or CLCfg()
    if cl_cfg.name not in CL_METHODS:
        raise NotImplementedError(f"cl method {cl_cfg.name!r}: the port "
                                  f"runs {CL_METHODS}")
    use_ssl, use_prompt = cl_cfg.narration_ssl, cl_cfg.prompt_pool
    K = accumulation_steps
    # the clip is on or off for the step's life: a captured graph
    # (make_multi_train_step) holds one form; off, K4 scales by 1 (exact)
    # and the metrics have no grad_norm, as JAX's
    clip = tc.clip_grad_l2norm if tc.clip_grad_l2norm > 0 else 0.0
    one = torch.ones((), device=points.device)

    def micro_loss(state, mb, mcl, norm, marks):
        model = state.model
        nar = (lambda k: mb.get(k)) if use_ssl else (lambda k: None)
        rng = state.generator if regularize else None
        if rng is not None and dp is not None:
            rng = RowDraw(rng, *dp.rows(len(mb["feats"])))
        args = (mb["feats"], mb["mask"], mb.get("text"),
                mb.get("text_mask"), nar("narration"),
                nar("narration_mask"), nar("narration_valid"),
                mb.get("prompt_mask") if use_prompt else None)
        kw = dict(rng=rng, compute_dtype=compute_dtype,
                  **({} if dp is None else {"dp": dp}))
        copies = state.opt.copies
        out = (model(*args, **kw) if copies is None else
               torch.func.functional_call(model, copies, args, kw))
        if mcl.bias_alpha is not None:
            out["cls_logits"] = (out["cls_logits"] * mcl.bias_alpha
                                 + mcl.bias_beta)
        loss, metrics, norm = compute_losses(
            out, mb, points, mcl, norm, tc, n_known, cl_cfg.ssl_factor,
            cl_cfg.name, cl_cfg.dist_factor, dp)
        mark(marks, "forward", points.device)
        loss.backward()
        mark(marks, "backward", points.device)
        return out, metrics, norm

    def body(state: TrainState, batch: dict, cl: CLBatchExtras,
             marks: Optional[list] = None):
        """The step's device work, reading the optimizer's staged scalars
        and writing the state, the bank and the pointer in place: what a
        CUDA graph captures (make_multi_train_step)."""
        b = batch["feats"].shape[0]
        if b % K:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accumulation_steps {K}")
        m = b // K
        copies = state.opt.copies
        if copies is not None and compute_dtype != torch.bfloat16:
            raise ValueError(
                "param_compute_dtype=bfloat16 needs model.compute_dtype="
                "bfloat16: with f32 activations the kernels are "
                "consumed at f32, so a stored bf16 copy would change "
                "the forward")
        state.model.train()
        mark(marks, "start", points.device)
        state.opt.zero_grad()
        norm, mets = state.loss_normalizer, []
        for k in range(K):
            rows = slice(k * m, (k + 1) * m)
            mb = batch if K == 1 else {n: v[rows] for n, v in batch.items()}
            mcl = cl if K == 1 or cl.prev_logits is None else \
                dataclasses.replace(cl, prev_logits=cl.prev_logits[rows])
            out, met, norm = micro_loss(state, mb, mcl, norm, marks)
            if copies is not None and K > 1:
                state.opt.fold_compute_grads()
            mets.append(met)
            if (use_ssl and cl.memory_bank is not None
                    and "narration_feat" in out):
                bank, ptr = ring_update(
                    cl.memory_bank, cl.memory_ptr, *out.get(
                        "narration_all", (out["narration_feat"].detach(),
                                          out["narration_valid"])))
                cl.memory_bank.copy_(bank)
                cl.memory_ptr.copy_(ptr)
        metrics = mets[0] if K == 1 else {
            n: torch.stack([mt[n].detach() for mt in mets]).mean()
            for n in mets[0]}
        bf16_grads = copies is not None and K == 1
        if dp is not None:
            # the ranks' partial gradients and loss terms add up to the
            # global batch's; #positives is global already. The copy's
            # bf16 gradients (one micro-batch) are summed in bf16, as
            # JAX's DP step sums them
            dp.all_reduce_(state.opt.grad_flat)
            if bf16_grads:
                dp.all_reduce_bf16_(state.opt.pc_grad_flat)
            metrics = global_metrics(metrics, dp)
        if K > 1:
            state.opt.grad_flat.div_(K)
        if cl.penalty is not None:
            metrics["reg_penalty"] = cl.penalty.apply(
                state.opt.param_flat, state.opt.grad_flat,
                state.opt if copies is not None else None, bf16_grads)
        if clip:
            gnorm, gscale = global_norm_clip(
                state.opt.grad_flat,
                state.opt.pc_grad_flat if bf16_grads else None, clip=clip)
            metrics["grad_norm"] = gnorm
        else:
            gscale = one
        state.opt.update(gscale, bf16_grads)
        if state.adapter_ema is not None:
            update_adapter_ema(state.adapter_ema, state.model, ema_decay)
        mark(marks, "optimizer", points.device)
        state.loss_normalizer.copy_(norm.detach())
        return {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch: dict, cl: CLBatchExtras,
             marks: Optional[list] = None):
        state.opt.stage()
        metrics = body(state, batch, cl, marks)
        state.opt.count += 1
        state.step += 1
        return metrics

    step.body = body
    return step


def make_multi_train_step(points: torch.Tensor, tc: TrainCfg,
                          scan_steps: int, **flags) -> Callable:
    """K = `scan_steps` train steps in one call (vilco_tpu/train/engine.py::
    make_multi_train_step, JAX's `lax.scan` of the step in one jit):
    multi(state, batches, cl) -> the last step's metrics. `flags` are
    make_train_step's; `batches` holds each key of the step's batch stacked
    on a leading axis of length K. The steps run in order on batch rows 0..
    K-1, the memory bank and its pointer carried from step to step (in
    place, as each step writes them). `cl.prev_logits` (per-batch
    distillation targets) is refused, as JAX's scanned path refuses it.

    On CPU tensors the K steps run eagerly. On the card the step is
    captured once as a torch.cuda.CUDAGraph and replayed, each replay
    after the batch's row is copied into the graph's own batch buffers
    and the optimizer's scalars staged (`FlatOptimizer.stage`); it never
    runs eagerly instead, and a capture that fails raises. The first call
    runs step 1 eagerly on the capture's stream, which builds and binds
    the kernels and warms the libraries, then captures and replays the
    other K - 1: no step is added. A later call whose state, optimizer, CL
    tensors or batch shapes differ from the captured ones raises: a new
    state needs a new multi step. The
    generator is registered with the graph, so each replay advances its
    offset as an eager step does. The wrappers' Python launch counters
    count a captured kernel once, at capture (a profiler counts the
    replays' launches). `dp` cannot be captured: Gloo's collectives run
    on the host, and capturing NCCL's is not ported; it raises on the
    card. `multi.capture` holds the last capture's seconds and the bytes
    the graph's memory pool reserved."""
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    step = make_train_step(points, tc, **flags)
    dp = flags.get("dp")
    graph = _StepGraph()

    def multi(state: TrainState, batches: Dict[str, torch.Tensor],
              cl: CLBatchExtras):
        if cl.prev_logits is not None:
            raise ValueError(
                "cl.prev_logits: CL extras with per-batch payloads "
                "(distillation targets) are not supported in the scanned "
                "path; run make_train_step per batch")
        lead = {k: v.shape[0] for k, v in batches.items()}
        if set(lead.values()) != {scan_steps}:
            raise ValueError(f"batches must be stacked {scan_steps} deep "
                             f"on their leading axis, got {lead}")
        dev = batches["feats"].device
        if dev.type == "cpu":
            for i in range(scan_steps):
                metrics = step(state, {k: v[i] for k, v in batches.items()},
                               cl)
            return metrics
        if dp is not None:
            import torch.distributed as dist

            backend = (dist.get_backend(dp.group) if dist.is_initialized()
                       else "no process group")
            raise ValueError(
                f"make_multi_train_step on the card with dp ({backend}): "
                "a CUDA graph cannot capture Gloo's collectives, which run "
                "on the host, and capturing NCCL's is not ported")
        if dev.type != "cuda":
            raise ValueError(f"batches on {dev}: the CPU or a CUDA device")
        return graph.run(step, state, batches, cl, scan_steps)

    multi.capture = graph.info
    return multi


class _StepGraph:
    """The captured step of make_multi_train_step on the card: the graph,
    its own batch buffers (one row of the stacked batches), the static
    metrics it writes, and the key of what it captured."""

    def __init__(self):
        self.graph = None
        self.key = None
        self.batch: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, torch.Tensor] = {}
        self.info: Dict[str, float] = {}

    @staticmethod
    def _key(state, batches, cl) -> tuple:
        ptr = lambda t: None if t is None else (t.data_ptr(), t.shape,
                                                t.dtype)
        opt = state.opt
        return (id(state), id(opt), id(state.generator), id(state.model),
                ptr(opt.param_flat), ptr(opt.grad_flat), ptr(opt.scalars),
                ptr(state.loss_normalizer),
                tuple((n, ptr(e)) for n, e in
                      (state.adapter_ema or {}).items()),
                ptr(cl.class_mask), ptr(cl.memory_bank), ptr(cl.memory_ptr),
                ptr(cl.bias_alpha), ptr(cl.bias_beta), id(cl.penalty),
                tuple((k, v.shape[1:], v.dtype, v.device)
                      for k, v in batches.items()))

    def _load(self, batches, i: int) -> None:
        for k, v in batches.items():
            self.batch[k].copy_(v[i], non_blocking=True)

    def _capture(self, step, state, batches, cl):
        """Step 1 eagerly on a side stream, then the step's body captured
        on it. Returns step 1's metrics."""
        dev = batches["feats"].device
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        self.batch = {k: torch.empty_like(v[0]) for k, v in batches.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "torch.cuda.CUDAGraph.register_generator_state is missing: "
                "this PyTorch cannot replay the step's dropout draws")
        with torch.cuda.stream(side):
            self._load(batches, 0)
            first = step(state, self.batch, cl)
            torch.cuda.synchronize(dev)
            warm = torch.cuda.memory_reserved(dev) - reserved
            # the capture empties the cache too: the pool's bytes are what
            # the capture reserves beyond the emptied cache
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved(dev)
            graph.register_generator_state(state.generator)
            with torch.cuda.graph(graph, stream=side):
                metrics = step.body(state, self.batch, cl)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph, self.metrics = graph, metrics
        self.key = self._key(state, batches, cl)
        self.info.update(seconds=time.perf_counter() - t0, warm_bytes=warm,
                         pool_bytes=torch.cuda.memory_reserved(dev) - base)
        return first

    def run(self, step, state, batches, cl, K: int):
        first = 0
        if self.graph is None:
            metrics = self._capture(step, state, batches, cl)
            first = 1
        elif self._key(state, batches, cl) != self.key:
            raise ValueError(
                "make_multi_train_step: the state, its optimizer, the CL "
                "tensors or the batch shapes differ from the ones the graph "
                "captured; make a new multi step for a new state")
        for i in range(first, K):
            self._load(batches, i)
            state.opt.stage()
            self.graph.replay()
            state.opt.count += 1
            state.step += 1
        if first == K:
            return metrics
        return {k: v.clone() for k, v in self.metrics.items()}


def global_metrics(metrics: Dict[str, torch.Tensor], dp,
                   replicated=("num_pos",)) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each loss term summed (one all-reduce of the
    stacked values); the `replicated` ones, global on every rank already,
    kept."""
    names = [n for n in metrics if n not in replicated]
    if not names:
        return dict(metrics)
    total = dp.sum(torch.stack([metrics[n].detach().float()
                                for n in names]))
    return {**metrics, **{n: total[i] for i, n in enumerate(names)}}


def make_eval_step(model: torch.nn.Module, ensemble_adapters: bool = False,
                   compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """step(batch, adapter_ema=None, marks=None) -> the head outputs
    (`cls_logits`, `offsets`, `fpn_mask`, `fpn_feats`) of the model in eval
    mode on batch["feats"], ["mask"] and the text, the prompt pool
    choosing its prompts; with `ensemble_adapters` and an EMA given, the
    mean of cls_logits and offsets over two forwards, the live adapters'
    and the EMA's (swapped in by torch.func.functional_call, the model
    unchanged) (vilco_tpu/train/engine.py::make_eval_step). `marks`, if a
    list, receives (phase, CUDA event or host time) after each forward.
    `compute_dtype`: the forwards' (default: the parameters' dtype)."""
    kw = {"compute_dtype": compute_dtype}

    def step(batch: dict, adapter_ema=None, marks: Optional[list] = None):
        model.eval()
        args = (batch["feats"], batch["mask"], batch.get("text"),
                batch.get("text_mask"))
        dev = batch["feats"].device
        with torch.no_grad():
            mark(marks, "start", dev)
            out = model(*args, **kw)
            mark(marks, "forward", dev)
            if ensemble_adapters and adapter_ema is not None:
                out2 = torch.func.functional_call(model, adapter_ema, args,
                                                  kw)
                mark(marks, "ema_forward", dev)
                out["cls_logits"] = 0.5 * (out["cls_logits"]
                                           + out2["cls_logits"])
                out["offsets"] = 0.5 * (out["offsets"] + out2["offsets"])
        return {k: out[k] for k in ("cls_logits", "offsets", "fpn_mask",
                                    "fpn_feats")}

    return step
