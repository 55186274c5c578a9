"""Re-evaluate a finished MQ or NLQ CL run from its workdir
(vilco_tpu/bin/evaluate.py):

  python -m vilco_tpu_torch.bin.evaluate --workdir ./runs/x \
      [--task-idx 4] [--synthetic] [--submission out.json]

The config is `--config`, else the workdir's config.json (either
package's), else the tiny config of `--task` (MQ's, or NLQ's). VQ runs are
evaluated by bin/vq_infer.py. The submission is Ego4D-MQ's
submission.json for MQ and the ego4d_nlq_challenge file for NLQ. As JAX's
CLI, it restores the task
checkpoint's params (either package's) and the rehearsal memory only: no
adapter EMA and no BiC state, so a run of the yaml's method evaluates
with the single forward; and the synthetic path builds no text or
narration source.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None)
    p.add_argument("--workdir", required=True)
    p.add_argument("--task", default=None,
                   help="mq | nlq (default from config; vq: bin/vq_infer)")
    p.add_argument("--task-idx", type=int, default=None,
                   help="evaluate as of this task (default: latest ckpt)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-videos", type=int, nargs=2, default=(6, 2),
                   metavar=("TRAIN", "VAL"),
                   help="as train_cl's (default 6 2)")
    p.add_argument("--submission",
                   help="also write the official prediction file here: "
                        "Ego4D-MQ submission.json for mq, "
                        "ego4d_nlq_challenge for nlq")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    import numpy as np

    from vilco_tpu_torch.core.checkpoint import load_checkpoint, params_of
    from vilco_tpu_torch.core.config import load_config
    from vilco_tpu_torch.data.synthetic import (
        make_synthetic_cl_split,
        tiny_config,
    )

    saved_cfg = os.path.join(args.workdir, "config.json")
    if args.config:
        cfg = load_config(args.config)
    elif os.path.exists(saved_cfg):
        cfg = load_config(saved_cfg)
    elif (args.task or "mq") == "nlq":
        from vilco_tpu_torch.tasks.nlq import nlq_tiny_config

        cfg = nlq_tiny_config()
    else:
        cfg = tiny_config()
    task = args.task or cfg.task
    if task == "vq":
        p.error("VQ checkpoints are evaluated by the sliding-window "
                "inference pipeline: python -m vilco_tpu_torch.bin.vq_infer "
                f"--workdir {args.workdir}")
    if task == "nlq":
        if args.synthetic:
            from vilco_tpu_torch.bin.train_cl import synthetic_nlq_runner

            # as JAX's evaluate: no narration source
            runner = synthetic_nlq_runner(cfg, args.workdir, args.device,
                                          persist_config=False,
                                          narration=False)
        else:
            p.error("--task nlq evaluates the synthetic episode only "
                    "(--synthetic), as JAX's evaluate")
    elif args.synthetic:
        from vilco_tpu_torch.cl.episode import EpisodeRunner
        from vilco_tpu_torch.cl.stream import TaskStream
        from vilco_tpu_torch.data.pipeline import SyntheticFeatureSource

        rng = np.random.default_rng(cfg.init_rand_seed)
        train_t, val_t = make_synthetic_cl_split(
            rng, cfg, videos_per_class_train=args.synthetic_videos[0],
            videos_per_class_val=args.synthetic_videos[1])
        runner = EpisodeRunner(
            cfg, TaskStream(train_t, val_t),
            SyntheticFeatureSource(cfg.dataset.input_dim),
            workdir=args.workdir, persist_config=False, device=args.device)
    else:
        from vilco_tpu_torch.tasks.mq import build_mq_runner

        runner = build_mq_runner(cfg, args.workdir, persist_config=False,
                                 device=args.device)

    ckpts = sorted(glob.glob(os.path.join(args.workdir, "task_*.ckpt")))
    if not ckpts:
        raise SystemExit(f"no task_*.ckpt in {args.workdir}")
    if args.task_idx is not None:
        path = os.path.join(args.workdir, f"task_{args.task_idx:03d}.ckpt")
    else:
        path = ckpts[-1]
    tree = load_checkpoint(path)
    runner.set_params(params_of(tree))
    j = int(tree["task"])
    mem_path = os.path.join(args.workdir, cfg.cl_cfg.path_memory)
    if os.path.exists(mem_path):
        runner.memory.load(mem_path)

    if args.submission:
        sub = runner.predict_submission(j)
        if isinstance(sub, list):   # NLQ's records take the challenge wrapper
            sub = {"version": "1.0", "challenge": "ego4d_nlq_challenge",
                   "results": sub}
        with open(args.submission, "w") as f:
            json.dump(sub, f)
        logging.getLogger("vilco.evaluate").info(
            "wrote submission to %s", args.submission)

    results = runner.evaluate(j)
    out = {k: v for k, v in results.items() if k != "per_task"}
    out["per_task"] = results["per_task"]
    print(json.dumps(out, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
