"""Observability: metrics bus + profiler hooks
(vilco_tpu/core/logging.py).

`MetricsLogger` and `StepTimer` are copies of the JAX package's; the
JSONL stream's records are the same. `profile_ctx` traces with
torch.profiler (CPU and CUDA activities) into the same `trace_dir` or
VILCO_PROFILE_DIR, as a Chrome trace per context.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream: one record per event with a
    monotonic step and wall-clock timestamp.

    Optionally mirrors scalar values to TensorBoard (the reference logs
    through torch.utils.tensorboard, MQ/train_cl.py:74-75): pass
    `tensorboard_dir` or set VILCO_TENSORBOARD_DIR (train_cl's
    --tensorboard flag does the latter). Silently disabled when no
    SummaryWriter implementation is importable — the JSONL stream is the
    source of truth either way."""

    def __init__(self, path: str, tensorboard_dir: str = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()
        self._tb = None
        tensorboard_dir = tensorboard_dir or os.environ.get(
            "VILCO_TENSORBOARD_DIR")
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                pass

    def log(self, kind: str, step: int = 0, **values):
        rec = {"kind": kind, "step": int(step),
               "t": round(time.time() - self._t0, 3)}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("kind", "step", "t") and isinstance(v, float):
                    self._tb.add_scalar(f"{kind}/{k}", v, rec["step"])

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._f.close()


@contextlib.contextmanager
def profile_ctx(trace_dir: Optional[str] = None):
    """torch.profiler trace when `trace_dir` set (or VILCO_PROFILE_DIR
    env), written as trace_dir/trace_<time>.json; no-op otherwise."""
    trace_dir = trace_dir or os.environ.get("VILCO_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))


class StepTimer:
    """Rolling step timing (AverageMeter equivalent,
    train_utils.py:219-246) without host syncs — call mark() around already
    host-blocking points."""

    def __init__(self, momentum: float = 0.9):
        self.avg = None
        self.momentum = momentum
        self._last = None

    def mark(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.avg = (
                dt if self.avg is None
                else self.momentum * self.avg + (1 - self.momentum) * dt
            )
        self._last = now
        return dt
