"""The VQ train step and eval step (vilco_tpu/train/vq_engine.py): anchor
losses with batch-level hard-negative mining (HNM), the optimizer, the
per-frame top-anchor decode.

    forward (training mode, HNM pairs) -> vq_losses -> backward
    -> global-norm clip at grad_max -> AdamW (MultiStepLR) on the trainable
       leaves

The step takes the EWC/MAS penalty of the stacked tasks
(cl/regularizers.py::RegPenalty: its gradient on the trainable leaves, its
value over every leaf, the frozen ViT's share fixed) and
`accumulation_steps` micro-batches. The frozen ViT runs under no_grad and
its parameters are outside the optimizer: no update, no state, no decay.
Every trainable leaf decays (the VQ optimizer is optax.adamw with no mask: biases, norms and pe_3d
too), the moments are f32, and on the card the update is one multi-tensor
launch of kernels/adamw.py (which equals optax's chain expression for
expression at f32 state); on the CPU each leaf goes through its plain
version.

Data parallelism (`dp`, parallel/mesh.py::DataParallel): each rank holds
its rows of every micro-batch, and the step is the global batch's: HNM
pairs the rank's clips with every query of the global micro-batch
(models/clip_matcher.py), the positives sit at (i, i) by GLOBAL index, the
loss's #positives, its no-positive fallback and its occupancy denominator
are the global batch's, the head's dropout draws the global pair list's
masks, and after the micro-batches one all-reduce (SUM) of the trainable
leaves' flat gradient buffer comes before the division by K, the penalty
and the clip.

Batch (tensors on the model's device): clip (B, T, H, W, 3) frames, query
(B, H, W, 3), clip_bbox
(B, T, 4) normalized xyxy, clip_with_bbox (B, T) 1 where the frame holds
the object, before_query (B, T) 1 for frames before the query frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vilco_tpu_torch.core.config import VQConfig
from vilco_tpu_torch.core.marks import mark
from vilco_tpu_torch.kernels.adamw import (
    B1,
    B2,
    LeafTable,
    adamw_update_multi,
    adamw_update_plain,
)
from vilco_tpu_torch.ops.anchors import assign_anchor_labels, giou
from vilco_tpu_torch.parallel.mesh import RowDraw
from vilco_tpu_torch.train.engine import global_metrics
from vilco_tpu_torch.train.optim import flat_buffers

GT_KEYS = ("clip_bbox", "clip_with_bbox", "before_query")


def replicate_for_hnm(gts: Dict[str, torch.Tensor], b: int,
                      dp=None) -> Dict[str, torch.Tensor]:
    """(clip i, query j) pairs, clip index slowest: the diagonal keeps its
    targets, every other pair becomes a pure negative (no box, all frames
    before the query, a 1e-4 box). Under `dp` the rank's b clips with the
    global batch's queries, the diagonal by global index."""
    dev = next(iter(gts.values())).device
    bq, first = (b, 0) if dp is None else dp.rows(b)
    i_idx = torch.arange(b, device=dev).repeat_interleave(bq)  # clip
    j_idx = torch.arange(bq, device=dev).repeat(b)             # query
    diag = (i_idx + first == j_idx)[:, None]
    out = {}
    for k, v in gts.items():
        if k == "query":
            out[k] = v[j_idx]
        elif k == "clip_with_bbox":
            out[k] = torch.where(diag, v[i_idx], torch.zeros_like(v[i_idx]))
        elif k == "before_query":
            out[k] = torch.where(diag, v[i_idx], torch.ones_like(v[i_idx]))
        elif k == "clip_bbox":
            neg = torch.tensor([0.0, 0.0, 1e-4, 1e-4], dtype=v.dtype,
                               device=dev)
            out[k] = torch.where(diag[..., None], v[i_idx], neg)
        else:
            out[k] = v[i_idx]
    return out


def vq_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """VQ's focal variant, elementwise: positives weighted 1 - alpha,
    negatives alpha."""
    t, x = targets.float(), logits.float()
    bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p = torch.sigmoid(x)
    pt = torch.where(t == 1, p, 1 - p)
    a = torch.where(t == 1, torch.full_like(t, 1 - alpha),
                    torch.full_like(t, alpha))
    return a * (1 - pt) ** gamma * bce


def vq_losses(preds: dict, gts: dict, positive_threshold: float = 0.2,
              positive_topk: int = 5, weight_center: float = 1.0,
              weight_hw: float = 1.0, weight_giou: float = 0.3,
              weight_prob: float = 100.0, dp=None):
    """(total, metrics, top): L1 on centers and half extents and GIoU over
    the positive anchors, the focal occupancy loss over the anchors of the
    frames before the query; a batch with no positive gets one at the
    first anchor of the first frame. Under `dp` the batch is the rank's
    rows of the global one: the counts are global (the fallback positive
    on rank 0's first row), and the loss terms are this rank's shares."""
    pred_prob = preds["prob"]                               # (B, T, N)
    gt_bbox = gts["clip_bbox"].float()                      # (B, T, 4)
    gt_prob = gts["clip_with_bbox"].float()
    before_query = gts["before_query"].float()
    gt_center = 0.5 * (gt_bbox[..., :2] + gt_bbox[..., 2:])
    gt_hw = gt_center - gt_bbox[..., :2]

    assign = assign_anchor_labels(preds["anchors_xyxy"], gt_bbox,
                                  positive_threshold, positive_topk)
    positive = assign & (gt_prob[..., None] > 0)
    fake = torch.zeros_like(positive)
    count = lambda x: x if dp is None else dp.sum(x)
    if dp is None or dp.rank == 0:
        fake[0, 0, 0] = True
    positive = torch.where(count(positive.sum()) > 0, positive, fake)
    pos_f = positive.float()
    n_pos = count(pos_f.sum())
    num_pos = torch.clamp(n_pos, min=1.0)

    def l1(p, g):
        return ((p - g[..., None, :]).abs() * pos_f[..., None]).sum() / (
            num_pos * p.shape[-1])

    loss_center = l1(preds["center"], gt_center)
    loss_hw = l1(preds["hw"], gt_hw)
    iou_v, giou_v = giou(preds["bbox"], gt_bbox[..., None, :])
    loss_giou = ((1.0 - giou_v) * pos_f).sum() / num_pos
    bq = before_query[..., None].expand_as(pred_prob)
    fl = vq_focal_loss(pred_prob, pos_f)
    loss_prob = (fl * bq).sum() / torch.clamp(count(bq.sum()), min=1.0)
    total = (weight_center * loss_center + weight_hw * loss_hw
             + weight_giou * loss_giou + weight_prob * loss_prob)

    top_idx = pred_prob.argmax(-1)                          # (B, T)
    top = {"bbox": torch.gather(
               preds["bbox"], 2,
               top_idx[..., None, None].expand(-1, -1, 1, 4))[..., 0, :],
           "prob": torch.gather(pred_prob, 2, top_idx[..., None])[..., 0]}
    metrics = {"loss_center": loss_center, "loss_hw": loss_hw,
               "loss_giou": loss_giou, "loss_prob": loss_prob,
               "final_loss": total, "num_pos": n_pos,
               "mean_iou": (iou_v * pos_f).sum() / num_pos}
    return total, metrics, top


class VQOptimizer:
    """AdamW over the model's trainable parameters (requires_grad), f32
    moments, decay `weight_decay` on every one of them; the gradients
    clipped to global norm `grad_max` (optax.clip_by_global_norm: the norm
    over the trainable leaves, the factor 1 below the limit); the lr
    MultiStepLR, lr * gamma^k with k the milestones <= the updates taken
    before this one. The trainable parameters and their gradients live in
    two persistent f32 buffers (`param_flat`, `grad_flat`, as FusedAdamW's),
    and the moments in two more, so the kernel's leaf table is built
    once."""

    def __init__(self, model: torch.nn.Module, lr: float,
                 weight_decay: float, grad_max: float = 20.0,
                 milestones=(7000, 14000, 20000, 25000), gamma: float = 0.3):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_max, self.gamma = grad_max, gamma
        self.milestones = sorted(milestones)
        self.count = 0
        dev = self.params[0].device
        self.flat_offsets, self.param_flat, self.grad_flat = flat_buffers(
            self.params)
        self.mu_flat = torch.zeros_like(self.grad_flat)
        self.nu_flat = torch.zeros_like(self.grad_flat)
        self.mu, self.nu = [], []
        for p, off in zip(self.params, self.flat_offsets):
            sl = slice(off, off + p.numel())
            self.mu.append(self.mu_flat[sl].view_as(p))
            self.nu.append(self.nu_flat[sl].view_as(p))
        self._table = None
        if dev.type == "cuda":
            self._table = LeafTable([p.data for p in self.params],
                                    [p.grad for p in self.params], self.mu,
                                    self.nu, [True] * len(self.params))

    def zero_grad(self) -> None:
        self.grad_flat.zero_()

    def lr_at(self, count: int) -> np.float32:
        k = sum(1 for m in self.milestones if m <= count)
        return np.float32(self.lr) * np.float32(self.gamma) ** np.float32(k)

    def coefficients(self):
        """(lr, bc1, bc2) of the coming update as f32 scalars."""
        c = np.float32(self.count + 1)
        return (self.lr_at(self.count), np.float32(1) - np.float32(B1) ** c,
                np.float32(1) - np.float32(B2) ** c)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and update in place; returns the global gradient norm (a
        0-d f32 tensor, before clipping)."""
        gnorm = torch.linalg.vector_norm(self.grad_flat,
                                         dtype=torch.float64).float()
        gscale = torch.where(gnorm < self.grad_max, torch.ones_like(gnorm),
                             self.grad_max / gnorm)
        lr, bc1, bc2 = self.coefficients()
        if self._table is not None:
            host = torch.tensor([lr, bc1, bc2], dtype=torch.float32,
                                pin_memory=True)
            coef = torch.cat([host.to(gnorm.device, non_blocking=True),
                              gscale.reshape(1)])
            adamw_update_multi(self._table, coef, wd=self.weight_decay)
        else:
            for p, m, v in zip(self.params, self.mu, self.nu):
                p2, m2, v2 = adamw_update_plain(p.data, p.grad, m, v, True,
                                                lr, bc1, bc2, gscale,
                                                wd=self.weight_decay)
                p.data.copy_(p2)
                m.copy_(m2)
                v.copy_(v2)
        self.count += 1
        return gnorm


def make_vq_optimizer(model: torch.nn.Module, cfg: VQConfig) -> VQOptimizer:
    """The VQ optimizer of `cfg`: lr, weight decay, clip norm and
    MultiStepLR milestones and factor."""
    return VQOptimizer(model, cfg.lr, cfg.weight_decay, cfg.grad_max,
                       cfg.lr_milestones, cfg.lr_gamma)


@dataclass
class VQTrainState:
    """`model` holds the f32 master parameters, `opt` the AdamW state;
    `generator` (on the model's device) draws the head's dropout."""
    model: torch.nn.Module
    opt: VQOptimizer
    generator: torch.Generator
    step: int = 0


def init_vq_train_state(model: torch.nn.Module, cfg: VQConfig,
                        seed: int = 0, device="cuda") -> VQTrainState:
    """Place `model` on `device` (the card unless the caller asks for the
    CPU; no card raises) and start its optimizer."""
    device = torch.device(device)
    model.to(device)
    return VQTrainState(model=model, opt=make_vq_optimizer(model, cfg),
                        generator=torch.Generator(device=device)
                        .manual_seed(seed))


def make_vq_train_step(cfg: VQConfig, *, deterministic: bool = False,
                       dp=None) -> Callable:
    """step(state, batch, marks=None, reg=None) -> metrics (0-d tensors, no
    host sync), on frames, with HNM where cfg.use_hnm; `deterministic`
    turns the head's dropout off (the parity checks). `reg`, a RegPenalty
    over the optimizer's flat parameters (RegPenalty.for_optimizer with the
    model, for the frozen leaves' share), adds the EWC/MAS penalty: its
    gradient once after the micro-batches, before the clip, and its value
    as the metric `reg_penalty`. With cfg.accumulation_steps K the batch's
    rows split into K micro-batches in order (a batch size K does not
    divide raises), each with its own HNM pairs and dropout draws; the K
    backwards add up and are divided by K before one update, and the
    metrics are the micro-batches' means. `marks`, if a list, receives
    (phase, CUDA event or host time) at the forward / backward / optimizer
    boundaries (per micro-batch for the first two). `dp`: a data-parallel
    rank's place; `batch` then holds its rows of every micro-batch
    (parallel/mesh.py::shard_rows) and the step is the global batch's
    (module docstring), its metrics the same on every rank."""
    hnm, K = cfg.use_hnm, cfg.accumulation_steps

    def step(state: VQTrainState, batch: dict, marks: Optional[list] = None,
             reg=None):
        model = state.model
        model.train()
        dev = batch["clip"].device
        b = batch["clip"].shape[0]
        if b % K:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accumulation_steps {K}")
        m = b // K
        mark(marks, "start", dev)
        state.opt.zero_grad()
        mets = []
        for k in range(K):
            mb = batch if K == 1 else {n: v[k * m:(k + 1) * m]
                                       for n, v in batch.items()}
            rng = None if deterministic else state.generator
            kw = {}
            if dp is not None:
                kw = {"dp": dp}
                rng = rng if rng is None else RowDraw(rng, *dp.rows(m))
            preds = model(mb["clip"], mb["query"], hnm=hnm, rng=rng, **kw)
            gts = {n: mb[n] for n in GT_KEYS}
            if hnm:
                gts = replicate_for_hnm(gts, m, dp)
            loss, met, _ = vq_losses(preds, gts, cfg.positive_threshold,
                                     cfg.positive_topk, dp=dp)
            mark(marks, "forward", dev)
            loss.backward()
            mark(marks, "backward", dev)
            mets.append({n: v.detach() for n, v in met.items()})
        metrics = mets[0] if K == 1 else {
            n: torch.stack([mt[n] for mt in mets]).mean() for n in mets[0]}
        if dp is not None:
            dp.all_reduce_(state.opt.grad_flat)
            metrics = global_metrics(metrics, dp)
        if K > 1:
            state.opt.grad_flat.div_(K)
        if reg is not None:
            metrics["reg_penalty"] = reg.apply(state.opt.param_flat,
                                               state.opt.grad_flat)
        metrics["grad_norm"] = state.opt.step()
        mark(marks, "optimizer", dev)
        state.step += 1
        return metrics

    return step


def make_vq_eval_step(model: torch.nn.Module) -> Callable:
    """step(clip, query, marks=None) -> (bbox (B, T, 4), prob (B, T)) on
    frames: the sigmoid of the occupancy logits, then per frame the first
    anchor of highest probability, its box and probability. `marks`
    receives the ViT / matcher / top-anchor boundaries."""

    @torch.no_grad()
    def step(clip, query, marks: Optional[List] = None):
        model.eval()
        dev = clip.device
        mark(marks, "start", dev)
        preds = model(clip, query, marks=marks)
        mark(marks, "matcher", dev)
        prob = torch.sigmoid(preds["prob"])                 # (B, T, N)
        top_idx = prob.argmax(-1)
        bbox = torch.gather(preds["bbox"], 2, top_idx[..., None, None]
                            .expand(-1, -1, 1, 4))[..., 0, :]
        top_prob = torch.gather(prob, 2, top_idx[..., None])[..., 0]
        mark(marks, "top", dev)
        return bbox, top_prob

    return step
