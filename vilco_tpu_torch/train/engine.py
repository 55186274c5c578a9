"""The MQ and NLQ train step (vilco_tpu/train/engine.py::make_train_step),
naive continual-learning method: no SSL, distillation, penalty or prompts,
one micro-batch per step.

    forward (training mode) -> compute_losses -> backward
    -> global-norm clip at CLIP_GRAD_L2NORM -> FusedAdamW -> loss-normaliser EMA

What the flagships share is fixed here: radius center sampling at 1.5,
the label-involved loss off, loss weight 1, clip 1.0. What they differ in
comes from the config's `train_cfg` (core/config.py::TrainCfg): label
smoothing (NLQ 0.1), the Gaussian loss weights (MQ only) and the initial
loss normaliser (MQ 100, NLQ 200).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vilco_tpu_torch.core.config import Config, TrainCfg
from vilco_tpu_torch.core.marks import mark
from vilco_tpu_torch.ops.assign import label_points
from vilco_tpu_torch.ops.losses import ctr_diou_loss_1d, sigmoid_focal_loss
from vilco_tpu_torch.train.optim import FusedAdamW

CENTER_SAMPLE_RADIUS = 1.5
CLIP_GRAD_L2NORM = 1.0
LOSS_WEIGHT = 1.0


@dataclass
class CLBatchExtras:
    class_mask: torch.Tensor            # (C,) bool: the classes seen so far


@dataclass
class TrainState:
    """`model` holds the f32 master parameters and `opt` the AdamW state;
    `generator` (on the model's device) draws drop-path, dropout and the
    XL kernel's dropout seed."""
    model: torch.nn.Module
    opt: FusedAdamW
    loss_normalizer: torch.Tensor
    generator: torch.Generator
    step: int = 0


def init_train_state(model: torch.nn.Module, cfg: Config,
                     steps_per_epoch: int, seed: int = 0,
                     device="cuda") -> TrainState:
    """Place `model` on `device` (the card unless the caller asks for the
    CPU; no card raises) and start AdamW (the schedule of `cfg.opt`) and
    the loss normaliser at `cfg.train_cfg.init_loss_norm`."""
    device = torch.device(device)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model,
                      opt=FusedAdamW(model, steps_per_epoch, cfg.opt),
                      loss_normalizer=torch.tensor(
                          cfg.train_cfg.init_loss_norm, device=device),
                      generator=gen)


def compute_losses(outputs: dict, batch: dict, points: torch.Tensor,
                   cl: CLBatchExtras, loss_normalizer: torch.Tensor,
                   tc: TrainCfg):
    """Focal classification loss against the targets smoothed over the
    seen classes plus one, and Distance-IoU regression loss on the
    positives, with the Gaussian weights on the positives where
    `tc.use_gaussian_weights`, both over the new normaliser 0.9 old + 0.1
    max(#positives, 1). Returns (loss, metrics, new normaliser)."""
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
               "num_pos": num_pos, "final_loss": final}
    return final, metrics, norm


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
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """step(state, batch, cl, marks=None) -> metrics (0-d tensors, no
    host sync). `batch` holds tensors on the model's device, the NLQ
    query's `text` and `text_mask` included. `tc`: the config's train_cfg.
    regularize: drop-path and dropouts from state.generator (off: the
    deterministic step of the parity checks). `marks`, if a list, receives
    (phase, CUDA event or host time) at the forward / backward / optimizer
    boundaries."""

    def step(state: TrainState, batch: dict, cl: CLBatchExtras,
             marks: Optional[list] = None):
        model = state.model
        model.train()
        mark(marks, "start", points.device)
        out = model(batch["feats"], batch["mask"], batch.get("text"),
                    batch.get("text_mask"),
                    rng=state.generator if regularize else None,
                    compute_dtype=compute_dtype)
        loss, metrics, new_norm = compute_losses(out, batch, points, cl,
                                                 state.loss_normalizer, tc)
        mark(marks, "forward", points.device)
        state.opt.zero_grad()
        loss.backward()
        mark(marks, "backward", points.device)
        gnorm, gscale = global_norm_clip(state.opt.grad_flat)
        state.opt.step(gscale)
        mark(marks, "optimizer", points.device)
        metrics["grad_norm"] = gnorm
        state.loss_normalizer = new_norm.detach()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
