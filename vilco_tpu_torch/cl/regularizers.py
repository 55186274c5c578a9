"""The EWC/MAS penalty and its importance estimation
(vilco_tpu/cl/regularizers.py and vilco_tpu/train/engine.py::reg_penalty).

`estimate_importance` keeps the reference's rule: the loop zeroes the
gradients before every batch, so only the LAST batch's gradient becomes
the importance (its square for EWC, its magnitude for MAS), while the loss
normaliser advances on every batch and is returned.

The penalty over K finished tasks is

    lambda * sum_k sum_i F_k,i (O_k,i - theta_i)^2

over every leaf but those whose parent module is named `drop_path*` or
`scale*` (`penalty_excluded`). `stack_reg_tasks` lays the tasks out as two
(K, N) f32 buffers in the optimizer's flat parameter order (FusedAdamW's
`flat_offsets`), and `RegPenalty` folds them once into

    A = sum_k F_k,   B = sum_k F_k O_k,   C = sum_k sum_i F_k,i O_k,i^2

in f64, so that each step reads O(N) whatever K:

    value = lambda * (theta . (A theta - 2 B) + C)
    grad  = 2 lambda (A theta - B)

a fixed number of launches whatever K and the number of leaves. The
products of two f32 values are exact in f64, and the expansion's
cancellation (theta^2 terms against the small (O - theta)^2) costs f64's
2^-53 of theta^2 / (O - theta)^2: 1e-8 relative at a step of 1e-4 on a
weight of 1.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from vilco_tpu_torch.train.engine import CLBatchExtras, compute_losses

Tree = Dict[str, torch.Tensor]


def penalty_excluded(name: str) -> bool:
    """True for the leaves the penalty skips (EWC.py:14, MAS.py:13: every
    torch name holding 'scale'): those under a module named `drop_path*`
    (AffineDropPath's scale) or `scale*` (the reg head's per-level Scale).
    The rule reads the parent modules, which `models/convert.py::port_name`
    keeps as they are: a LayerNorm's Flax `scale` is the port's `.weight`
    and stays penalised."""
    return any(p.startswith(("drop_path", "scale"))
               for p in name.split(".")[:-1])


def estimate_importance(model: torch.nn.Module, points: torch.Tensor,
                        batches: Iterable[dict], cl: CLBatchExtras,
                        loss_norm: torch.Tensor, tc, mode: str = "ewc",
                        compute_dtype: Optional[torch.dtype] = None,
                        dp=None) -> Tuple[Tree, Tree, torch.Tensor]:
    """(importance, optpar, loss_norm) of the finished task
    (vilco_tpu/cl/regularizers.py: make_grad_step, estimate_importance):
    each batch's deterministic forward (feats, mask and text only) and
    compute_losses at n_known 0 advance the normaliser; the last batch's
    gradient of the loss gives the importance, g^2 for "ewc" and |g| for
    "mas" (zeros without a batch); optpar is a copy of the parameters. The
    parameters' .grad buffers are not touched. With `dp` (a data-parallel
    rank's place) the batches are the rank's rows of the global ones: the
    normaliser advances by the global #positives, and the gradient is
    all-reduced before the square or the magnitude, so every rank holds
    the global batch's importance."""
    if mode not in ("ewc", "mas"):
        raise ValueError(f"importance mode {mode!r}: ewc or mas")
    was = model.training
    model.eval()
    named = list(model.named_parameters())
    last = None
    for batch in batches:
        if last is not None:
            with torch.no_grad():
                loss_norm = _loss(model, points, last, cl, loss_norm, tc,
                                  compute_dtype, dp)[1]
        last = batch
    grads = [torch.zeros_like(p) for _, p in named]
    if last is not None:
        loss, loss_norm = _loss(model, points, last, cl, loss_norm, tc,
                                compute_dtype, dp)
        got = torch.autograd.grad(loss, [p for _, p in named],
                                  allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, (_, p) in zip(got, named)]
        if dp is not None:
            grads = all_reduce_tree(grads, dp)
    model.train(was)
    f = torch.square if mode == "ewc" else torch.abs
    imp = {n: f(g.detach().float()) for g, (n, _) in zip(grads, named)}
    optpar = {n: p.detach().float().clone() for n, p in named}
    return imp, optpar, loss_norm.detach()


def _loss(model, points, batch, cl, loss_norm, tc, compute_dtype, dp=None):
    out = model(batch["feats"], batch["mask"], batch.get("text"),
                batch.get("text_mask"), compute_dtype=compute_dtype)
    loss, _, norm = compute_losses(out, batch, points, cl, loss_norm, tc,
                                   dp=dp)
    return loss, norm


def all_reduce_tree(grads: List[torch.Tensor], dp) -> List[torch.Tensor]:
    """The SUM over the ranks of each tensor of `grads`, by one all-reduce
    of their f32 concatenation; returned in their dtypes."""
    flat = dp.all_reduce_(torch.cat([g.detach().float().reshape(-1)
                                     for g in grads]))
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
        at += g.numel()
    return out


def stack_reg_tasks(tasks: List[Tuple[Tree, Tree]], names: List[str],
                    offsets: List[int], n: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(importance, optpar), ...] by leaf name -> (fisher, optpar), each
    (K, n) f32 on `device`: task k's leaf `names[i]` flattened at
    `offsets[i]` of row k (the optimizer's flat layout; the gaps between
    leaves hold 0)."""
    dev = device if device is not None else next(
        iter(tasks[0][0].values())).device
    fisher = torch.zeros((len(tasks), n), device=dev)
    optpar = torch.zeros((len(tasks), n), device=dev)
    for k, (imp, opt) in enumerate(tasks):
        for name, off in zip(names, offsets):
            m = imp[name].numel()
            fisher[k, off:off + m] = imp[name].reshape(-1)
            optpar[k, off:off + m] = opt[name].reshape(-1)
    return fisher, optpar


def penalty_mask(names: List[str], offsets: List[int], shapes,
                 n: int, device=None) -> torch.Tensor:
    """(n,) f32: 1 on the elements of the penalised leaves, 0 on the
    excluded ones (`penalty_excluded`) and the gaps."""
    mask = torch.zeros(n, device=device)
    for name, off, shape in zip(names, offsets, shapes):
        if not penalty_excluded(name):
            mask[off:off + torch.Size(shape).numel()] = 1.0
    return mask


class RegPenalty:
    """The EWC/MAS penalty over stacked tasks, folded (module docstring) for
    an optimizer's flat parameters. `fisher`, `optpar`: (K, N) f32 from
    `stack_reg_tasks`; `mask` (N,) from `penalty_mask`; `lam` the config's
    reg_lambda; `const` the penalty of the leaves outside the flat buffer
    (the frozen VQ ViT's: they never move, so their share is fixed)."""

    def __init__(self, fisher: torch.Tensor, optpar: torch.Tensor,
                 mask: torch.Tensor, lam: float, const: float = 0.0):
        self.lam = float(lam)
        self.num_tasks = fisher.shape[0]
        m = mask.double()
        self.a = torch.zeros_like(m)
        self.neg_b = torch.zeros_like(m)
        c = torch.zeros((), dtype=torch.float64, device=m.device)
        for k in range(self.num_tasks):          # one task at a time: O(N)
            f = fisher[k].double() * m
            o = optpar[k].double()
            fo = f * o
            self.a += f
            self.neg_b -= fo
            c += (fo * o).sum()
        self.c = c + (const / self.lam if self.lam else 0.0)

    @classmethod
    def for_optimizer(cls, tasks: List[Tuple[Tree, Tree]], opt, lam: float,
                      model: Optional[torch.nn.Module] = None
                      ) -> "RegPenalty":
        """The penalty of `tasks` ([(importance, optpar)] by leaf name) over
        the flat parameters of `opt` (FusedAdamW or the VQ optimizer). With
        `model`, the leaves of its state_dict outside the optimizer add
        their fixed share lambda sum F (O - theta)^2."""
        dev = opt.param_flat.device
        n = opt.param_flat.numel()
        fisher, optpar = stack_reg_tasks(tasks, opt.names, opt.flat_offsets,
                                         n, dev)
        mask = penalty_mask(opt.names, opt.flat_offsets,
                            [p.shape for p in opt.params], n, dev)
        const = 0.0
        if model is not None:
            inside = set(opt.names)
            for name, theta in model.state_dict().items():
                if name in inside or penalty_excluded(name):
                    continue
                t = theta.detach().double()
                for imp, opt_k in tasks:
                    const += float((imp[name].to(t.device).double()
                                    * (opt_k[name].to(t.device).double()
                                       - t) ** 2).sum())
            const *= lam
        return cls(fisher, optpar, mask, lam, const)

    def apply(self, theta: torch.Tensor, grad: torch.Tensor, copy=None,
              bf16_grads: bool = False) -> torch.Tensor:
        """Add the penalty's gradient to `grad` in place and return its value
        (0-d f32); theta, grad: (N,) f32, the optimizer's param_flat and
        grad_flat. `copy`, an optimizer with a bf16 compute copy: theta
        takes the copy's values on its leaves (JAX's penalty reads the
        forward's parameters), and with `bf16_grads` their share of the
        gradient is rounded to bf16 and added to the copy's bf16 gradients
        (`pc_grad_flat`), the sum rounded to bf16."""
        t = theta.double()
        on_copy = None
        if copy is not None:
            on_copy = copy.copy_mask
            t = torch.where(on_copy, copy.pc_flat.double(), t)
        u = torch.addcmul(self.neg_b, self.a, t)          # A theta - B
        if on_copy is not None and bf16_grads:
            g2 = (2.0 * self.lam) * u
            gb = copy.pc_grad_flat
            gb.copy_(torch.where(on_copy, gb.float()
                                 + g2.to(torch.bfloat16).float(),
                                 gb.float()).to(torch.bfloat16))
            grad.add_(torch.where(on_copy, torch.zeros_like(g2), g2))
        else:
            grad.add_(u, alpha=2.0 * self.lam)
        val = torch.dot(t, u) + torch.dot(t, self.neg_b) + self.c
        return (val * self.lam).float()
