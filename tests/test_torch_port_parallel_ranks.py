"""The data-parallel step against the one-process step: train steps of the
MQ / NLQ point transformer or the VQ ClipMatcher, run the same way in one
process and in each rank of a data-parallel group (parallel/launch.py),
for the CPU tests (tests/test_torch_port_parallel*.py). It holds no test
of its own: its functions are the spawned ranks' targets.

A spec (a dict, pickled to the ranks) says what to run:

  kind       "point" (MQ and NLQ: train/engine.py) or "vq"
             (train/vq_engine.py)
  cfg        the port's Config ("point") or VQConfig ("vq")
  model_cl   the CLCfg the PointTransformer is built with (None: none)
  params     {name: array} loaded into the model, or None: the model's
             seeded init (`seed`)
  batches    the GLOBAL batches, numpy, one a step; each rank trains on
             its rows (parallel/mesh.py::shard_rows)
  step       make_train_step's / make_vq_train_step's keywords
  cl         "point": class_mask, memory bank and pointer, the EWC/MAS
             tasks [(importance, optpar)] and lambda
  opt_count  AdamW's update count before the first step (the schedule)
  dtype      the forward's compute dtype name; tf32: allow TF32
  record     record every dropout draw (the masks, in draw order)

`train_steps(spec, device, dp)` runs it in this process (dp None: the
whole batch); `rank_steps` is the ranks' entry point for spawn_ranks (a
list of specs runs one after the other in the same ranks).

`seq_rank` runs a sequence-parallel op of parallel/seq.py on the rank's
time shard of whole-sequence inputs, with its backward.
"""

from __future__ import annotations

import numpy as np
import torch


def _load(model, params, device):
    if params is None:
        return
    own = dict(model.state_dict(keep_vars=True))
    with torch.no_grad():
        for n, v in params.items():
            own[n].copy_(torch.as_tensor(np.asarray(v)).to(own[n]))


def _build_point(spec, device):
    from vilco_tpu_torch.cl.regularizers import RegPenalty
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import CLBatchExtras, init_train_state

    cfg = spec["cfg"]
    m = cfg.model
    model = PointTransformer(
        m, generator=torch.Generator().manual_seed(spec.get("seed", 0)),
        device="cpu", cl=spec.get("model_cl"))
    _load(model, spec.get("params"), "cpu")
    st = init_train_state(model, cfg, spec.get("spe", 1), seed=spec.get(
        "gen_seed", 1), device=device)
    st.opt.count = spec.get("opt_count", 0)
    c = spec.get("cl", {})
    bank = c.get("bank")
    cl = CLBatchExtras(
        class_mask=torch.as_tensor(np.asarray(c["class_mask"])).to(device),
        # copies: the steps advance the bank in place
        memory_bank=None if bank is None else torch.tensor(
            np.asarray(bank), device=device),
        memory_ptr=None if bank is None else torch.tensor(
            int(c.get("ptr", 0)), dtype=torch.int64, device=device))
    if c.get("reg"):
        tasks = [tuple({n: torch.as_tensor(np.asarray(v)).to(device)
                        for n, v in t.items()} for t in task)
                 for task in c["reg"]]
        cl.penalty = RegPenalty.for_optimizer(tasks, st.opt, c["lambda"])
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).float()
    return st, cl, pts.to(device)


def train_steps(spec: dict, device, dp=None) -> dict:
    """Run the spec's steps (module docstring) on `device`; under `dp` on
    this rank's rows. Returns {"metrics": [{name: float}] a step,
    "params" and "grads" (the first step's, after the all-reduce:
    later steps start from parameters that AdamW's roundoff already moved)
    / "digest", "draws", and for "point" the bank, pointer, normaliser and
    adapter EMA after the last step}."""
    from vilco_tpu_torch.parallel.mesh import shard_batch

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = bool(spec.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(spec.get("tf32", False))
    dtype = spec.get("dtype")
    kw = dict(spec.get("step", {}))
    if dtype is not None and spec["kind"] == "point":
        kw["compute_dtype"] = getattr(torch, dtype)
    draws = _record_draws() if spec.get("record") else None
    if spec["kind"] == "point":
        from vilco_tpu_torch.train.engine import make_train_step

        st, cl, pts = _build_point(spec, device)
        step = make_train_step(pts, spec["cfg"].train_cfg, dp=dp, **kw)
        micro = kw.get("accumulation_steps", 1)
        run = lambda b: step(st, b, cl)
        model, opt = st.model, st.opt
    else:
        st, reg = _build_vq(spec, device)
        from vilco_tpu_torch.train.vq_engine import make_vq_train_step

        step = make_vq_train_step(spec["cfg"], dp=dp, **kw)
        micro = spec["cfg"].accumulation_steps
        run = lambda b: step(st, b, reg=reg)
        model, opt = st.model, st.opt
    if dp is not None:
        from vilco_tpu_torch.parallel.mesh import replicated

        replicated(model.state_dict(keep_vars=True).values(), dp)
    out = {"metrics": []}
    for batch in spec["batches"]:
        if dp is not None:
            batch = shard_batch(batch, dp.rank, dp.world, micro)
        met = run({k: torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in batch.items()})
        out["metrics"].append({k: float(v) for k, v in met.items()})
        if "grads" not in out:
            out["grads"] = {n: p.grad.float().cpu().numpy()
                            for n, p in model.named_parameters()
                            if p.grad is not None}
    out["params"] = {n: p.detach().float().cpu().numpy()
                     for n, p in model.state_dict().items()}
    out["digest"] = digest(opt.param_flat)
    if getattr(opt, "copies", None) is not None:
        out["copies"] = {n: c.detach().float().cpu().numpy()
                         for n, c in opt.copies.items()}
    if draws is not None:
        out["draws"] = draws.stop()
    if spec["kind"] == "point":
        out["norm"] = float(st.loss_normalizer)
        if cl.memory_bank is not None:
            out["bank"] = cl.memory_bank.cpu().numpy()
            out["ptr"] = int(cl.memory_ptr)
        if st.adapter_ema is not None:
            out["ema"] = {n: e.cpu().numpy()
                          for n, e in st.adapter_ema.items()}
    return out


def _build_vq(spec, device):
    from vilco_tpu_torch.cl.regularizers import RegPenalty
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.train.vq_engine import init_vq_train_state

    cfg = spec["cfg"]
    dtype = getattr(torch, spec.get("dtype") or "float32")
    model = ClipMatcher(
        cfg, generator=torch.Generator().manual_seed(spec.get("seed", 0)),
        device="cpu", compute_dtype=dtype)
    _load(model, spec.get("params"), "cpu")
    st = init_vq_train_state(model, cfg, seed=spec.get("gen_seed", 1),
                             device=device)
    st.opt.count = spec.get("opt_count", 0)
    reg = None
    if spec.get("reg"):
        tasks = [tuple({n: torch.as_tensor(np.asarray(v)).to(device)
                        for n, v in t.items()} for t in task)
                 for task in spec["reg"]]
        reg = RegPenalty.for_optimizer(tasks, st.opt, spec["lambda"],
                                       model=model)
    return st, reg


def digest(flat: torch.Tensor) -> tuple:
    """A summary of a buffer's bits: its int32 words' sum and their sum
    weighted by position mod 65521, both exact in int64."""
    w = flat.detach().reshape(-1).view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 65521
    return int(w.sum()), int((w * pos).sum())


class _record_draws:
    """Record every mask drawn through parallel/mesh.py::rand_rows (as
    models/layers.py calls it) and every XL keep mask, in draw order."""

    def __init__(self):
        from vilco_tpu_torch.kernels import xl_attention
        from vilco_tpu_torch.models import layers

        self.got = []
        self._layers, self._xl = layers, xl_attention
        self._rand, self._keep = layers.rand_rows, xl_attention.philox_keep_mask

        def rand(shape, rng, device):
            r = self._rand(shape, rng, device)
            self.got.append(r.detach().cpu().numpy())
            return r

        def keep(*a, **k):
            m = self._keep(*a, **k)
            self.got.append(m.cpu().numpy())
            return m

        layers.rand_rows, xl_attention.philox_keep_mask = rand, keep

    def stop(self):
        self._layers.rand_rows = self._rand
        self._xl.philox_keep_mask = self._keep
        return self.got


def rank_steps(dp, device, spec):
    """spawn_ranks' entry: the spec's steps on this rank's rows (a list
    of specs: each in turn, a list of results)."""
    if isinstance(spec, (list, tuple)):
        return [train_steps(s, device, dp) for s in spec]
    return train_steps(spec, device, dp)


def seq_rank(dp, device, spec):
    """spawn_ranks' entry: the op `spec["op"]` ("banded" or "conv") of
    parallel/seq.py on this rank's shard of the whole-sequence inputs
    (B, T, ...), then the backward of sum(out * gout) (gout the whole
    sequence's output gradient). Returns the shard's output and the
    inputs' gradients."""
    from vilco_tpu_torch.parallel.seq import (
        seq_banded_attention,
        seq_masked_conv1d,
    )

    device = torch.device(device)
    T = np.asarray(spec["mask"]).shape[1]
    n = T // dp.world
    rows = slice(dp.rank * n, (dp.rank + 1) * n)
    dt = getattr(torch, spec.get("dtype", "float32"))
    shard = lambda k: torch.as_tensor(np.asarray(spec[k])[:, rows]).to(
        device)
    mask = shard("mask")
    s = spec.get("stride", 1)
    if spec["op"] == "banded":
        names = ("q", "k", "v")
        ins = [shard(k).to(dt).requires_grad_() for k in names]
        out = seq_banded_attention(*ins, mask, spec["window"], dp=dp)
    else:
        names = ("x",)
        ins = [shard("x").to(dt).requires_grad_()]
        w = torch.as_tensor(np.asarray(spec["weight"])).to(device, dt)
        b = (None if spec.get("bias") is None else
             torch.as_tensor(np.asarray(spec["bias"])).to(device, dt))
        out = seq_masked_conv1d(ins[0], mask, w, b, s, dp=dp)[0]
    g = np.asarray(spec["gout"])[:, dp.rank * n // s:(dp.rank + 1) * n // s]
    (out * torch.as_tensor(g).to(device, out.dtype)).sum().backward()
    return {"out": out.detach(),
            "grads": {k: t.grad for k, t in zip(names, ins)}}


def collectives_rank(dp, device):
    """spawn_ranks' entry for the collectives' check: all-reduce, the
    gather of floats, bf16, bools and ints, the gather's backward, the
    broadcast and the bitwise replication check (which must raise on a
    copy that differs)."""
    from vilco_tpu_torch.parallel.mesh import assert_replicated, replicated

    r = dp.rank
    s = dp.sum(torch.full((2,), float(r + 1), device=device))
    x = torch.full((1, 2), float(r), device=device, requires_grad=True)
    g = dp.gather(x)
    (g * float(r + 1)).sum().backward()
    w = torch.full((3,), float(r), device=device)
    replicated([w], dp)
    bad = torch.full((2,), float(r), device=device)
    try:
        assert_replicated([bad], dp)
        caught = False
    except RuntimeError:
        caught = True
    return {"sum": s, "gathered": g.detach().reshape(-1, 2),
            "bf16": dp.gather(torch.tensor([r + 0.5],
                                           dtype=torch.bfloat16)),
            "bools": dp.gather(torch.tensor([r % 2 == 0])),
            "ints": dp.gather(torch.tensor([10 * r])),
            "grad": x.grad.reshape(-1), "replicated": bool(
                torch.equal(w, torch.zeros(3))),
            "caught": caught}
