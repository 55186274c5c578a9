"""Run a function in N data-parallel processes on one host (train_cl's
`--dp N`, the DP checks of chip_smoke.py and the tests).

`spawn_ranks("package.module:function", devices, args)` starts one process
per entry of `devices` (start method spawn), each joined to a process
group over a `file://` rendezvous in a fresh temporary directory (no port
to race for), and calls `function(dp, device, *args)` there with `dp` a
parallel.mesh.DataParallel. It returns the ranks' return values in rank
order. A rank's exception, or a rank that has not finished within
`timeout_s`, stops every rank and raises here: nothing hangs.

The backend is NCCL when every rank has a card of its own, else Gloo
(the CPU, or several ranks on one card: NCCL refuses that, and Gloo
reduces CUDA tensors through the host).
"""

from __future__ import annotations

import datetime
import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import List, Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 600
CPU_THREADS = 1      # intra-op threads of a CPU rank: ranks share the cores


def backend_for(devices: Sequence[torch.device]) -> str:
    devs = [torch.device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len({d.index for d in cards}) == len(devs):
        return "nccl"
    return "gloo"


def to_host(obj):
    """`obj` with every tensor as a numpy array (bf16 as f32): a rank's
    result crosses to the parent by value, not through shared memory that
    the rank frees when it exits."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_entry(target: str, rank: int, devices, backend: str,
                init_file: str, timeout_s: float, args, results):
    import torch.distributed as dist

    from vilco_tpu_torch.parallel.mesh import DataParallel

    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores: no oversubscription
            torch.set_num_threads(max(1, min(CPU_THREADS, (
                os.cpu_count() or 1) // len(devices))))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout_s))
        mod, fn = target.split(":")
        out = getattr(importlib.import_module(mod), fn)(
            DataParallel(rank, len(devices)), dev, *args)
        results.put((rank, "ok", to_host(out)))
    except BaseException:                       # noqa: BLE001 - reported
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target: str, devices: Sequence, args: tuple = (),
                backend: Optional[str] = None,
                timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
                tmp_dir: Optional[str] = None) -> List:
    """Run `target` ("module:function") as function(dp, device, *args) in
    len(devices) processes; returns their results in rank order (module
    docstring). `timeout_s` None: no deadline for the run (each collective
    still times out after COLLECTIVE_TIMEOUT_S). `tmp_dir` holds the
    rendezvous file (default: TMPDIR)."""
    from vilco_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT_S

    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = backend or backend_for(devices)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    where = tempfile.mkdtemp(prefix="vilco_dp_", dir=tmp_dir)
    init_file = os.path.join(where, "rendezvous")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, devices, backend, init_file,
                               timeout_s or COLLECTIVE_TIMEOUT_S, args,
                               results), daemon=False)
             for r in range(len(devices))]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + (timeout_s or float("inf"))
    try:
        while len(got) < len(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{target}: ranks {sorted(set(range(len(procs))) - set(got))}"
                    f" not finished within {timeout_s:g} s")
            try:
                rank, status, out = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{target}: rank {dead[0]} died with "
                                       f"exit code {procs[dead[0]].exitcode}")
                continue
            if status != "ok":
                raise RuntimeError(f"{target}: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=min(max(deadline - time.monotonic(), 1.0), 60.0))
        return [got[r] for r in range(len(procs))]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(where, ignore_errors=True)
