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
    -> global-norm clip at CLIP_GRAD_L2NORM -> FusedAdamW
    -> loss-normaliser EMA -> the adapter EMA

What the flagships share is fixed here: radius center sampling at 1.5,
loss weight 1, clip 1.0. What they differ in comes from the config's
`train_cfg` (core/config.py::TrainCfg): label smoothing (NLQ 0.1), the
Gaussian loss weights (MQ only), the initial loss normaliser (MQ 100, NLQ
200), the label-involved (AL) loss's weight (the MQ yaml 0.2) and the SSL
temperature; from its `cl_cfg`: the method, the SSL weight, the bank's
size and the distillation weight; from its `opt`: the accumulation steps.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vilco_tpu_torch.core.config import CLCfg, Config, TrainCfg
from vilco_tpu_torch.core.marks import mark
from vilco_tpu_torch.ops.assign import label_points
from vilco_tpu_torch.ops.losses import ctr_diou_loss_1d, sigmoid_focal_loss
from vilco_tpu_torch.train.optim import FusedAdamW

CENTER_SAMPLE_RADIUS = 1.5
CLIP_GRAD_L2NORM = 1.0
LOSS_WEIGHT = 1.0
PULL_WEIGHT = 0.1        # the L2P pull: final -= 0.1 x reduce_sim
CL_METHODS = ("naive", "l2p", "ewc", "mas", "icarl", "bic")
BIC_T = 2.0              # BiC's distillation temperature
EMA_DECAY = 0.999        # the time adapters' EMA
AL_NEG = -1e7            # the AL loss's logit at invalid points, unseen classes


@dataclass
class CLBatchExtras:
    """Per-step CL inputs. `memory_bank` (M, E) f32 and `memory_ptr` (0-d
    int64), the narration-SSL negatives and the next row to write, are
    advanced in place by a step with SSL on. `prev_logits` (B, P, C) f32:
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
    """`model` holds the f32 master parameters and `opt` the AdamW state;
    `generator` (on the model's device) draws drop-path, dropout and the
    XL kernel's dropout seed; `adapter_ema` maps each time-adapter
    parameter's name to its EMA (None without adapters)."""
    model: torch.nn.Module
    opt: FusedAdamW
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
    CPU; no card raises) and start AdamW (the schedule of `cfg.opt`), the
    loss normaliser at `cfg.train_cfg.init_loss_norm` and, with
    `cfg.cl_cfg.use_adapt`, the adapter EMA at the adapters' values."""
    device = torch.device(device)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model,
                      opt=FusedAdamW(model, steps_per_epoch, cfg.opt),
                      loss_normalizer=torch.tensor(
                          cfg.train_cfg.init_loss_norm, device=device),
                      generator=gen,
                      adapter_ema=(init_adapter_ema(model)
                                   if cfg.cl_cfg.use_adapt else None))


def compute_losses(outputs: dict, batch: dict, points: torch.Tensor,
                   cl: CLBatchExtras, loss_normalizer: torch.Tensor,
                   tc: TrainCfg, n_known: int = 0, ssl_factor: float = 0.0,
                   cl_method: str = "naive", dist_factor: float = 0.01):
    """Focal classification loss against the targets smoothed over the
    seen classes plus one, and Distance-IoU regression loss on the
    positives, with the Gaussian weights on the positives where
    `tc.use_gaussian_weights`, both over the new normaliser 0.9 old + 0.1
    max(#positives, 1); the AL loss x tc.al_loss_weight where that is > 0
    and there is more than one class; minus PULL_WEIGHT x the prompt
    pool's reduce_sim once `n_known` > 0; the distillation against
    `cl.prev_logits` once `n_known` > 0 (`distill_loss`: BiC's where
    `cl_method` is "bic", else iCaRL's); the narration-SSL loss x
    `ssl_factor` where the outputs hold narration features and `cl` a
    memory bank. The EWC/MAS penalty is the step's (it reads the
    parameters). Returns (loss, metrics, new normaliser)."""
    cls_logits = outputs["cls_logits"]            # (B, P, C) f32
    valid = outputs["fpn_mask"]                   # (B, P)
    class_mask_f = cl.class_mask.float()
    tgt = label_points(points, batch["gt_segments"], batch["gt_labels"],
                       batch["gt_valid"], cls_logits.shape[-1],
                       outputs["gaussians"], CENTER_SAMPLE_RADIUS)
    pos_mask = tgt.pos_mask & valid
    num_pos = pos_mask.float().sum()
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

    final = cls_loss + reg_loss * LOSS_WEIGHT
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
                            dist_factor)
        final = final + dist
        metrics["dist_loss"] = dist
    if "narration_feat" in outputs and cl.memory_bank is not None:
        ssl = narration_ssl_loss(
            outputs["narration_feat"], outputs["video_feat"],
            outputs["narration_valid"], cl.memory_bank, cl.memory_ptr,
            tc.temperature) * ssl_factor
        final = final + ssl
        metrics["ssl_loss"] = ssl
    metrics["final_loss"] = final
    return final, metrics, norm


def distill_loss(cls_logits, prev, valid, lens, n_known: int,
                 cl_method: str, dist_factor: float):
    """The distillation term (vilco_tpu/train/engine.py:178-203) over the
    first `n_known` classes against the targets `prev` (probabilities):
    BiC's softmax-T cross-entropy at T = BIC_T x dist_factor x n_known / C,
    or iCaRL's BCE-with-logits summed over the classes x dist_factor. Per
    clip, each level's mean over its valid points (`lens` the levels'
    lengths), summed over the levels; then the mean over the batch."""
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
    return factor * (sums / torch.clamp(counts, min=1.0)).sum(-1).mean()


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
                       temperature: float):
    """The narration-SSL InfoNCE (vilco_tpu/train/engine.py::
    narration_ssl_loss), the JAX package's quirk kept: the bank is first
    written with the batch's detached narration features, so each valid
    row meets its own narration among the negatives; text-to-video and
    video-to-text cross-entropies averaged, over the valid rows."""
    nvalid = narration_valid.to(nf.dtype)
    neg_bank, _ = ring_update(bank, ptr, nf.detach(), narration_valid)
    pos = (nf * vf).sum(-1, keepdim=True)
    lt = torch.cat([pos, nf @ neg_bank.T], 1) / temperature
    lv = torch.cat([pos, vf @ neg_bank.T], 1) / temperature
    ce = lambda lg: -torch.log_softmax(lg, -1)[:, 0]
    per_row = 0.5 * (ce(lt) + ce(lv))
    return (per_row * nvalid).sum() / torch.clamp(nvalid.sum(), min=1.0)


def global_norm_clip(grad_flat: torch.Tensor):
    """(global L2 norm of the gradients, clip factor min(1, clip / (norm +
    1e-9))), both 0-d f32 tensors on the gradients' device; `grad_flat`
    holds every gradient (FusedAdamW's buffer). The sum of squares runs in
    f64: one f32 reduction over the whole buffer drifts ~2e-5 from optax's
    per-leaf sums."""
    gnorm = torch.linalg.vector_norm(grad_flat, dtype=torch.float64).float()
    return gnorm, torch.clamp(CLIP_GRAD_L2NORM / (gnorm + 1e-9), max=1.0)


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(points: torch.Tensor, tc: TrainCfg, *,
                    regularize: bool = True,
                    compute_dtype: Optional[torch.dtype] = None,
                    cl_cfg: Optional[CLCfg] = None, n_known: int = 0,
                    ema_decay: float = EMA_DECAY,
                    accumulation_steps: int = 1) -> Callable:
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
    toward the updated adapters at `ema_decay`. regularize: drop-path and
    dropouts from state.generator (off: the deterministic step of the
    parity checks). `marks`, if a list, receives (phase, CUDA event or
    host time) at the forward / backward / optimizer boundaries (per
    micro-batch for the first two)."""
    cl_cfg = cl_cfg or CLCfg()
    if cl_cfg.name not in CL_METHODS:
        raise NotImplementedError(f"cl method {cl_cfg.name!r}: the port "
                                  f"runs {CL_METHODS}")
    use_ssl, use_prompt = cl_cfg.narration_ssl, cl_cfg.prompt_pool
    K = accumulation_steps

    def micro_loss(state, mb, mcl, norm, marks):
        model = state.model
        nar = (lambda k: mb.get(k)) if use_ssl else (lambda k: None)
        out = model(mb["feats"], mb["mask"], mb.get("text"),
                    mb.get("text_mask"), nar("narration"),
                    nar("narration_mask"), nar("narration_valid"),
                    mb.get("prompt_mask") if use_prompt else None,
                    rng=state.generator if regularize else None,
                    compute_dtype=compute_dtype)
        if mcl.bias_alpha is not None:
            out["cls_logits"] = (out["cls_logits"] * mcl.bias_alpha
                                 + mcl.bias_beta)
        loss, metrics, norm = compute_losses(
            out, mb, points, mcl, norm, tc, n_known, cl_cfg.ssl_factor,
            cl_cfg.name, cl_cfg.dist_factor)
        mark(marks, "forward", points.device)
        loss.backward()
        mark(marks, "backward", points.device)
        return out, metrics, norm

    def step(state: TrainState, batch: dict, cl: CLBatchExtras,
             marks: Optional[list] = None):
        b = batch["feats"].shape[0]
        if b % K:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accumulation_steps {K}")
        m = b // K
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
            mets.append(met)
            if (use_ssl and cl.memory_bank is not None
                    and "narration_feat" in out):
                cl.memory_bank, cl.memory_ptr = ring_update(
                    cl.memory_bank, cl.memory_ptr,
                    out["narration_feat"].detach(), out["narration_valid"])
        metrics = mets[0] if K == 1 else {
            n: torch.stack([mt[n].detach() for mt in mets]).mean()
            for n in mets[0]}
        if K > 1:
            state.opt.grad_flat.div_(K)
        if cl.penalty is not None:
            metrics["reg_penalty"] = cl.penalty.apply(state.opt.param_flat,
                                                      state.opt.grad_flat)
        gnorm, gscale = global_norm_clip(state.opt.grad_flat)
        state.opt.step(gscale)
        if state.adapter_ema is not None:
            update_adapter_ema(state.adapter_ema, state.model, ema_decay)
        mark(marks, "optimizer", points.device)
        metrics["grad_norm"] = gnorm
        state.loss_normalizer = norm.detach()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


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
