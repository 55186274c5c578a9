"""The guard-ladder twin (vilco_tpu_torch/tools/guard_ladder.py) against
the JAX tool (tools/guard_ladder.py) on the CPU. The twin runs with
METHODS cut to naive and ewc, 2 tasks of 1 epoch: each row is one train_cl
subprocess and one JSON line, in the output file and on stdout, finite.
The JAX tool then runs the same rows with its subprocess answered by the
twin's train_cl outputs: its commands are the twin's (JAX's CLI module in
place of the port's, no --device, another workdir) and its rows the
twin's, field for field but the wall seconds."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu_torch.tools import guard_ladder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_guard_ladder", os.path.join(ROOT, "tools", "guard_ladder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cmd(cmd):
    """A row's command without its workdir and the port's --device."""
    out, skip = [], False
    for a in cmd:
        if skip:
            skip = False
        elif a in ("--workdir", "--device"):
            skip = True
        else:
            out.append(a)
    return out


def test_guard_ladder_rows_match_the_jax_tool(tmp_path, monkeypatch,
                                              capsys):
    jax_tool = _jax_tool()
    assert guard_ladder.METHODS == jax_tool.METHODS
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the workdirs
    monkeypatch.setattr(guard_ladder, "METHODS", guard_ladder.METHODS[:2])
    runs, real_run = [], subprocess.run

    def run(cmd, **kw):
        r = real_run(cmd, **kw)
        runs.append((cmd, r))
        return r

    monkeypatch.setattr(guard_ladder.subprocess, "run", run)
    out = tmp_path / "port.jsonl"
    rows = guard_ladder.main([str(out), "--tasks", "2", "--epochs", "1",
                              "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    written = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert rows == printed == written
    assert [(r["method"], r["extra"]) for r in rows] == [
        ("naive", []), ("ewc", ["--reg-lambda", "3000"])]
    for r in rows:
        assert "error" not in r, r.get("error")
        for k in ("final_avg_mAP", "final_R1@0.5", "BwF_R1@0.5"):
            assert np.isfinite(r[k]), k
        assert os.path.exists(r["results_file"])
    assert all(cmd[cmd.index("--device") + 1] == "cpu" for cmd, _ in runs)

    answers = iter(runs)
    jcmds = []

    def jax_run(cmd, **kw):
        jcmds.append(cmd)
        return next(answers)[1]

    monkeypatch.setattr(jax_tool, "METHODS", jax_tool.METHODS[:2])
    monkeypatch.setattr(jax_tool.subprocess, "run", jax_run)
    jout = tmp_path / "jax.jsonl"
    monkeypatch.setattr(sys, "argv", ["guard_ladder.py", str(jout),
                                      "--tasks", "2", "--epochs", "1"])
    jax_tool.main()
    jrows = [json.loads(ln) for ln in jout.read_text().splitlines()]
    swap = {"vilco_tpu.bin.train_cl": "vilco_tpu_torch.bin.train_cl"}
    assert [[swap.get(a, a) for a in _cmd(c)] for c in jcmds] == [
        _cmd(c) for c, _ in runs]
    drop = lambda r: {k: v for k, v in r.items() if k != "wall_s"}
    assert [drop(r) for r in jrows] == [drop(r) for r in rows]
    assert all(set(j) == set(r) for j, r in zip(jrows, rows))
