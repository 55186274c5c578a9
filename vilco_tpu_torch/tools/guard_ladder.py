"""CL method quality-guard ladder of the port (tools/guard_ladder.py's
twin).

Runs the synthetic MQ ladder for all seven CL methods (naive, ewc and mas
with the EWC/MAS penalty at the reference's lambda 3000, icarl, bic, l2p
and the full vilco recipe), each row one `vilco_tpu_torch.bin.train_cl
--synthetic` episode at the same seed and dims, on `--device` (the card by
default), and writes one JSON line per method to the output file as it
goes. A run is one seed, as in the JAX tool.

Usage: python -m vilco_tpu_torch.tools.guard_ladder [out.jsonl] [--tasks 3]
           [--epochs 4] [--seed S] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

METHODS = [
    ("naive", []),
    ("ewc", ["--reg-lambda", "3000"]),
    ("mas", ["--reg-lambda", "3000"]),
    ("icarl", []),
    ("bic", []),
    ("l2p", []),
    ("vilco", []),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out", nargs="?",
                   default=os.path.join(tempfile.gettempdir(),
                                        "guard_ladder.jsonl"))
    p.add_argument("--tasks", type=int, default=3)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="passed to train_cl: cuda (default) or cpu")
    args = p.parse_args(argv)

    with open(args.out, "w") as f:
        f.write("")
    rows = []
    for method, extra in METHODS:
        wd = tempfile.mkdtemp(prefix=f"guard_{method}_")
        cmd = [sys.executable, "-m", "vilco_tpu_torch.bin.train_cl",
               "--synthetic", "--method", method,
               "--num-tasks", str(args.tasks),
               "--epochs", str(args.epochs),
               "--device", args.device,
               "--workdir", wd] + extra
        if args.seed is not None:
            cmd += ["--seed", str(args.seed)]
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True)
        row = {"method": method, "extra": extra,
               "wall_s": round(time.time() - t0, 1)}
        if r.returncode != 0:
            row["error"] = r.stderr[-2000:]
        else:
            last = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("{")][-1]
            row.update(json.loads(last))
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
