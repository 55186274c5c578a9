"""BiC: bias correction (vilco_tpu/cl/bic.py).

Each task owns one (alpha, beta) pair, applied to its classes' logits as
alpha * z + beta (`apply_bias`); `BicState` keeps the pairs and the
class-to-task map on the host. Stage 1 trains the model with the softmax-T
distillation (train/engine.py) on 90% of the task's clips
(`split_train_val`), the logits biased by the past tasks' pairs; stage 2
(`make_bias_stage2_step`) trains only the current task's pair on the
held-out 10%, by SGD at lr 1e-3 with the model frozen: the training JAX
runs where the reference builds the bias optimizer but never steps it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vilco_tpu_torch.train.engine import CLBatchExtras, compute_losses


class BicState:
    """Host-side bias pairs (one per task) and the class -> task map."""

    def __init__(self, num_classes: int, num_tasks: int):
        self.alphas = np.ones((num_tasks,), np.float32)
        self.betas = np.zeros((num_tasks,), np.float32)
        self.class_task = np.zeros((num_classes,), np.int64)
        self.num_tasks_seen = 0

    def register_task(self, task_idx: int, class_ids) -> None:
        for c in class_ids:
            self.class_task[c] = task_idx
        self.num_tasks_seen = max(self.num_tasks_seen, task_idx + 1)

    def per_class(self, upto_task: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-class (alpha, beta), (C,) f32 each; the classes of tasks past
        `upto_task` get the identity (1, 0)."""
        a = self.alphas[self.class_task]
        b = self.betas[self.class_task]
        seen = self.class_task <= upto_task
        return (np.where(seen, a, 1.0).astype(np.float32),
                np.where(seen, b, 0.0).astype(np.float32))


def apply_bias(cls_logits: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """cls_logits (B, P, C) * alpha[c] + beta[c]."""
    return cls_logits * alpha + beta


def make_bias_stage2_step(model: torch.nn.Module, points: torch.Tensor, tc,
                          task_idx: int, class_task: np.ndarray,
                          lr: float = 1e-3) -> Tuple[Callable, Callable]:
    """(step, init) of BiC's stage 2. init(alpha0=1, beta0=0) -> the
    current task's pair {"alpha", "beta"} (0-d f32 on the points' device).
    step(bias, batch, cl, loss_norm) -> (new bias, metrics): the model's
    forward in eval mode under no_grad (feats, mask and text), the logits
    biased by `cl.bias_alpha`/`cl.bias_beta` with the current task's
    classes taking the pair, the naive loss (n_known 0, no distillation)
    at the normaliser `loss_norm`, and one SGD step at `lr` on the pair
    only."""
    cur = torch.from_numpy(np.asarray(class_task) == task_idx).to(
        points.device)

    def step(bias: Dict[str, torch.Tensor], batch: dict, cl: CLBatchExtras,
             loss_norm: torch.Tensor):
        model.eval()
        with torch.no_grad():
            out = model(batch["feats"], batch["mask"], batch.get("text"),
                        batch.get("text_mask"))
        a = bias["alpha"].detach().requires_grad_(True)
        b = bias["beta"].detach().requires_grad_(True)
        out = dict(out)
        out["cls_logits"] = apply_bias(
            out["cls_logits"], torch.where(cur, a, cl.bias_alpha),
            torch.where(cur, b, cl.bias_beta))
        loss, metrics, _ = compute_losses(out, batch, points, cl, loss_norm,
                                          tc)
        ga, gb = torch.autograd.grad(loss, (a, b))
        new = {"alpha": (a - lr * ga).detach(), "beta": (b - lr * gb).detach()}
        return new, {k: v.detach() for k, v in metrics.items()}

    def init(alpha0: float = 1.0, beta0: float = 0.0):
        return {"alpha": torch.tensor(alpha0, device=points.device),
                "beta": torch.tensor(beta0, device=points.device)}

    return step, init


def split_train_val(videos, perc: float = 0.9, seed: int = 0):
    """BiCQILSetTask's 90/10 split (cl_benchmark.py:159,214-235), numpy's
    default_rng(seed) as JAX's, so the split is the same one."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(videos))
    n_train = max(1, int(round(perc * len(videos))))
    train = [videos[i] for i in idx[:n_train]]
    val = [videos[i] for i in idx[n_train:]] or train[-1:]
    return train, val
