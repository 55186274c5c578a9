"""Data parallelism over torch.distributed, and the sharding rules
(vilco_tpu/parallel/mesh.py).

JAX's data parallelism is one SPMD program over the GLOBAL batch: XLA
inserts the collectives, so a DP step computes exactly what the single-
device step computes. The port runs one process per card and keeps that
function: each rank holds its rows of the batch, and the terms that couple
the rows meet through the collectives here (train/engine.py,
train/vq_engine.py, cl/prompt.py, models/clip_matcher.py):

  - the loss normalisers (#positives) are all-reduced before use, so every
    rank divides its partial sums by the global count, and the gradient's
    all-reduce (SUM) adds the partials up to the global loss's gradient
    (the optimizer's bf16 compute copy's gradients in bf16:
    `DataParallel.all_reduce_bf16_`);
  - batch means divide by the global row count;
  - row-coupled inputs (the SSL memory bank's write, HNM's queries) are
    gathered in global row order by `DataParallel.gather`: an all-reduce
    of a zero-padded buffer, so NCCL, Gloo on the CPU and Gloo with CUDA
    tensors run the same code (Gloo has no CUDA all-gather, NCCL refuses
    two ranks on one card);
  - random draws take the global batch's shape from the generator every
    rank shares, each rank keeping its rows (`RowDraw`).

Not DistributedDataParallel: it averages per-rank losses, a different
function wherever rows meet, and its bucket hooks run collectives on a
side stream during the backward. The collectives here run on the compute
stream, after the backward.

The tensor-parallel rules (`param_spec`) are JAX's `_param_spec` in the
port's layout; as in JAX no training path runs them.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run instead of hanging
COLLECTIVE_TIMEOUT_S = 600

# JAX's _param_spec: column-parallel (qkv projections, first MLP layer) and
# row-parallel (output projections, second MLP layer) Dense kernels
COLUMN_PARALLEL = ("query", "key", "value", "qkv", "mlp_fc1", "ff1")
ROW_PARALLEL = ("proj", "mlp_fc2", "ff2")


# ----------------------------------------------------------------------
# process groups

def init_distributed(device="cuda", timeout_s: float = COLLECTIVE_TIMEOUT_S
                     ) -> Tuple[int, int]:
    """The torchrun bring-up (vilco_tpu/parallel/mesh.py::init_distributed
    with one device per process): reads RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT (torchrun's environment) and joins the default process
    group, NCCL for the card and Gloo for the CPU. Without WORLD_SIZE it
    is a single process and joins nothing. Returns (rank, world): feed
    them to BatchIterator's (shard_id, num_shards)."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def local_device(device="cuda") -> torch.device:
    """The card of this torchrun process (cuda:LOCAL_RANK), or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


@dataclass
class Mesh:
    """The devices of a ("data", "model") mesh, row-major as JAX's."""
    devices: List[torch.device]
    shape: Dict[str, int] = field(default_factory=dict)


def available_devices(kind: str = "cuda") -> List[torch.device]:
    """The visible cards (none where there is no card)."""
    if kind != "cuda" or not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first `n_devices` of `devices` (default: the visible
    cards), shaped (n / model_parallel, model_parallel); JAX's two
    errors."""
    devices = list(devices if devices is not None else available_devices())
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: requested {n_devices} devices but only "
                f"{len(devices)} are available "
                f"(platform={devices[0].type if devices else '?'}). "
                "Without the cards, run the ranks as Gloo processes on the "
                "CPU (--device cpu).")
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"make_mesh: {n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return Mesh(devices, {"data": n // model_parallel,
                          "model": model_parallel})


# ----------------------------------------------------------------------
# the sharding rules

def param_spec(name: str, shape) -> tuple:
    """JAX's `_param_spec` (vilco_tpu/parallel/mesh.py:53-68) for the
    port's parameter `name` of `shape`: one entry per dimension, "model"
    where it is sharded, or () for replicated. A Flax Dense kernel (in,
    out) is a torch Linear weight (out, in), so column-parallel shards
    dim 0 and row-parallel dim 1; a non-depthwise conv (K, Cin/g, Cout) is
    a Conv1d weight (Cout, Cin/g, K), sharded on dim 0; a depthwise one
    (Cin/g = 1) is not sharded."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) >= 2 else "")
    if leaf == "weight" and len(shape) == 2:
        if parent in COLUMN_PARALLEL:
            return ("model", None)
        if parent in ROW_PARALLEL:
            return (None, "model")
    if leaf == "weight" and len(shape) == 3 and shape[1] > 1:
        return ("model", None, None)
    return ()


def param_shardings(named: Iterable[Tuple[str, object]],
                    mesh: Mesh) -> Dict[str, tuple]:
    """{name: spec} for (name, parameter or shape) pairs. A spec whose
    sharded dimension the mesh axis does not divide falls back to
    replication (e.g. a class-agnostic head with one output channel under
    TP), as JAX's param_shardings."""
    out = {}
    for name, p in named:
        shape = tuple(getattr(p, "shape", p))
        spec = param_spec(name, shape)
        if any(a is not None and shape[d] % mesh.shape[a]
               for d, a in enumerate(spec)):
            spec = ()
        out[name] = spec
    return out


def shard_rows(n: int, rank: int, world: int, micro: int = 1) -> np.ndarray:
    """The rows of a batch of `n` that rank `rank` of `world` holds when
    the step splits it into `micro` micro-batches: micro-batch k is global
    rows [k n/micro, (k+1) n/micro) (JAX's accumulation, vilco_tpu/train/
    engine.py:401-411), and the rank holds its contiguous share of each, so
    that its k-th local micro-batch is its part of the global k-th."""
    if n % (world * micro):
        raise ValueError(f"global batch {n} not divisible by {world} ranks "
                         f"x {micro} micro-batches")
    m, share = n // micro, n // (micro * world)
    return np.concatenate([np.arange(k * m + rank * share,
                                     k * m + (rank + 1) * share)
                           for k in range(micro)])


def shard_batch(batch: dict, rank: int, world: int, micro: int = 1) -> dict:
    """The rank's rows (`shard_rows`) of every array of `batch` (numpy or
    torch, leading batch axis)."""
    if world == 1:
        return dict(batch)
    n = len(next(iter(batch.values())))
    rows = shard_rows(n, rank, world, micro)
    take = lambda v: (v[torch.from_numpy(rows).to(v.device)]
                      if isinstance(v, torch.Tensor) else np.asarray(v)[rows])
    return {k: take(v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# the ranks of a data-parallel step

@dataclass
class DataParallel:
    """This process's place in the data-parallel group: its rank, the
    world size and the group (None: the default group). Every collective
    runs on the caller's stream, synchronously."""
    rank: int
    world: int
    group: Optional[object] = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place SUM over the ranks."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_bf16_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place SUM over the ranks of a bf16 tensor, as JAX's DP step
        sums the compute copy's bf16 gradients. NCCL sums bf16 natively.
        Gloo has no bf16 sum: the values are summed in f32 (each rank's
        share exact in f32) and the sum rounded to bf16 once. For two ranks
        both equal the correctly rounded bf16 sum: an f32 sum of two bf16
        values is exact unless their exponents lie 17 or more apart, and
        then it stays within 2^-16 of the larger one's magnitude, far from
        any bf16 rounding boundary. For more ranks NCCL rounds
        after each addition, in its ring's order, and Gloo's single
        rounding may differ from it by those roundings."""
        if t.dtype != torch.bfloat16:
            raise TypeError(f"all_reduce_bf16_ takes bf16, got {t.dtype}")
        if dist.get_backend(self.group) == "nccl":
            return self.all_reduce_(t)
        wide = self.all_reduce_(t.float())
        t.copy_(wide)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM over the ranks of `t`, out of place and detached."""
        return self.all_reduce_(t.detach().clone())

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src, group=self.group)
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' `x` (equal shapes) stacked along dim 0 in rank order,
        by the all-reduce of a zero-padded buffer (exact: each element has
        one non-zero term). Differentiable: the backward sums the ranks'
        gradients of the gathered rows and keeps this rank's."""
        return _Gather.apply(x, self)

    def rows(self, n_local: int) -> Tuple[int, int]:
        """(global rows, this rank's first) of an equal-share batch."""
        return n_local * self.world, n_local * self.rank


def _padded_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    wide = (torch.float32 if x.is_floating_point()
            and x.dtype != torch.float64 else
            x.dtype if x.is_floating_point() else torch.int64)
    n = x.shape[0]
    buf = torch.zeros((dp.world * n,) + tuple(x.shape[1:]), dtype=wide,
                      device=x.device)
    buf[dp.rank * n:(dp.rank + 1) * n] = x.to(wide)
    dp.all_reduce_(buf)
    return buf


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, ctx.n, ctx.dtype = dp, x.shape[0], x.dtype
        out = _padded_sum(x, dp)
        return out.to(torch.bool) if x.dtype == torch.bool else out.to(
            x.dtype)

    @staticmethod
    def backward(ctx, g):
        dp, n = ctx.dp, ctx.n
        g = dp.all_reduce_(g.float().contiguous().clone())
        return g[dp.rank * n:(dp.rank + 1) * n].to(ctx.dtype), None


@torch.no_grad()
def replicated(tensors: Iterable[torch.Tensor], dp: DataParallel,
               check: bool = True) -> None:
    """Give every rank rank 0's values of `tensors` (the parameters, in
    place), then, with `check`, verify that each rank's copy is bitwise
    equal to rank 0's (raises otherwise)."""
    ts = list(tensors)
    buf = dp.broadcast_(_bytes(ts))
    at = 0
    for t in ts:
        n = t.numel() * t.element_size()
        t.data.reshape(-1).view(torch.uint8).copy_(buf[at:at + n])
        at += n
    if check:
        assert_replicated(ts, dp)


def _bytes(ts) -> torch.Tensor:
    """The tensors' bytes in one buffer: every backend moves uint8, and
    one collective beats one a tensor."""
    return torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in ts])


@torch.no_grad()
def assert_replicated(tensors: Iterable[torch.Tensor], dp: DataParallel,
                      what: str = "parameters") -> None:
    """Raise unless every rank holds bitwise the values of rank 0: the
    tensors' bytes go out from rank 0 and are compared on every rank."""
    mine = _bytes(list(tensors))
    ref = dp.broadcast_(mine.clone())
    flag = torch.tensor([int(not torch.equal(ref, mine))], dtype=torch.int64,
                        device=mine.device)
    dp.all_reduce_(flag)
    if int(flag.item()):
        raise RuntimeError(f"the ranks' {what} differ from rank 0's on "
                           f"{int(flag.item())} of {dp.world} ranks")


@dataclass(frozen=True)
class RowDraw:
    """A generator's draws for `start`.. of a batch of `total` rows: a
    draw takes the global batch's shape from `generator` (which every rank
    holds in the same state) and keeps this rank's rows, so that the ranks
    together draw what one process draws for the whole batch, and no two
    ranks share a mask."""
    generator: torch.Generator
    total: int
    start: int

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def rows_of(self, per_row: int) -> "RowDraw":
        """The same rows, each expanded to `per_row` consecutive rows."""
        return RowDraw(self.generator, self.total * per_row,
                       self.start * per_row)


def generator_of(rng) -> Optional[torch.Generator]:
    return rng.generator if isinstance(rng, RowDraw) else rng


def rand_rows(shape, rng, device) -> torch.Tensor:
    """torch.rand(shape) from `rng`, a torch.Generator or a RowDraw (dim 0
    of `shape` the rank's rows of its batch)."""
    if isinstance(rng, RowDraw):
        n = shape[0]
        if rng.start + n > rng.total:
            raise ValueError(f"rows {rng.start}..{rng.start + n} of a draw "
                             f"of {rng.total}")
        full = torch.rand((rng.total,) + tuple(shape[1:]),
                          generator=rng.generator, device=device)
        return full[rng.start:rng.start + n]
    return torch.rand(shape, generator=rng, device=device)
