"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes plain `extern "C"` functions and becomes one
shared library `_build/lib<name>-<hash>.so`, where the hash covers the
source, the headers it may include and the flags, so a changed source
rebuilds and an unchanged one loads from the cache. Nothing here runs at
import time: the first kernel launch builds every library, nvcc processes
running side by side.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")


@dataclass
class Library:
    lib: ctypes.CDLL
    build_seconds: float | None   # None: loaded from the cache
    ptxas_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under $CUDA_HOME")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(src: Path) -> Path:
    return BUILD / f"lib{src.stem}-{_digest(src)}.so"


def _start(src: Path):
    """Start nvcc on `src`; returns (process, temp output, start time)."""
    BUILD.mkdir(exist_ok=True)
    tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(src: Path, started) -> tuple[float, str]:
    proc, tmp, t0 = started
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, _target(src))
    return seconds, log


_LOADED: dict[str, Library] = {}


def load_all() -> dict[str, Library]:
    """Build every `csrc/*.cu` missing from the cache, the nvcc processes
    running side by side, then load them all."""
    srcs = [s for s in sorted(CSRC.glob("*.cu")) if s.stem not in _LOADED]
    started = {s: _start(s) for s in srcs if not _target(s).exists()}
    try:
        # one waiting thread a process, so each library's seconds are its
        # own nvcc's, not the time until its turn to be collected
        with ThreadPoolExecutor(max(1, len(started))) as pool:
            built = dict(zip(started, pool.map(lambda kv: _finish(*kv),
                                               started.items())))
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for s in srcs:
        seconds, log = built.get(s, (None, ""))
        _LOADED[s.stem] = Library(ctypes.CDLL(str(_target(s))), seconds,
                                  log)
    return {s.stem: _LOADED[s.stem] for s in sorted(CSRC.glob("*.cu"))}


@functools.lru_cache(maxsize=None)
def bind(name: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """The C function `fn` of library `name`, declared as taking n_ptrs
    pointers, n_ints ints, n_floats floats and a trailing stream, returning
    cudaError_t."""
    f = getattr(load_all()[name].lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                  + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16 (the codes the C functions take)."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def as_c_int(u: int) -> int:
    """An unsigned 32-bit value as the signed int that carries its bits."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= 1 << 31 else u


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
