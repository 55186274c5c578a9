"""The CL training CLI of the port, MQ task (vilco_tpu/bin/train_cl.py):

  python -m vilco_tpu_torch.bin.train_cl --config cfg.yaml --workdir ./runs/x
  python -m vilco_tpu_torch.bin.train_cl --synthetic --workdir ./runs/x

`--config` takes a yaml (read with PyYAML, which the card's machine does
not have) or the config.json an episode persists (read with json). With
no config, the tiny MQ config of the tests (data/synthetic.py::
tiny_config). Features come from the config's feat_folder, or with
`--synthetic` from the synthetic sources over a synthetic task split
(`synthetic_mq_runner`). The runner trains on the card (`--device`);
without one it raises. Writes {workdir}/results.json and prints a JSON
summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

# flags of the JAX CLI that the port refuses, each with why
REFUSED = {
    "dp": "--dp: data parallelism over devices is not ported "
          "(ROADMAP §1 item 7, multi-GPU)",
    "distributed": "--distributed: multi-host training is not ported "
                   "(ROADMAP §1 item 7, multi-GPU)",
    "factored": "--factored: the factored second moment is not ported "
                "(FusedAdamW keeps the full one)",
    "params_bf16": "--params-bf16: a persistent bf16 parameter copy is not "
                   "ported (the port casts its f32 masters on use)",
}


def synthetic_mq_runner(cfg, workdir: str, device="cuda",
                        videos_per_class=(6, 2), persist_config=True):
    """The synthetic MQ episode (vilco_tpu/bin/train_cl.py's synthetic MQ
    path): with the prompt pool on and no text, the text stream and the
    cross-modal model switched on (L2P prompts prepend to text tokens);
    a split of `videos_per_class` (train, val) synthetic videos per class
    from numpy's default_rng(init_rand_seed); SyntheticFeatureSource, and
    the synthetic text and narration sources where the config reads them.
    Returns (cfg, runner)."""
    import numpy as np

    from vilco_tpu_torch.cl.episode import EpisodeRunner
    from vilco_tpu_torch.cl.stream import TaskStream
    from vilco_tpu_torch.data.pipeline import (
        SyntheticFeatureSource,
        SyntheticNarrationSource,
        SyntheticTextSource,
    )
    from vilco_tpu_torch.data.synthetic import make_synthetic_cl_split

    if cfg.cl_cfg.prompt_pool and not cfg.dataset.use_text:
        model = dataclasses.replace(cfg.model, use_cross_modal=True,
                                    n_txt_in=cfg.model.n_txt_in or 16)
        cfg = dataclasses.replace(
            cfg, model=model,
            dataset=dataclasses.replace(cfg.dataset, use_text=True),
            cl_cfg=dataclasses.replace(cfg.cl_cfg,
                                       embed_dim=model.n_txt_in))
    rng = np.random.default_rng(cfg.init_rand_seed)
    train_tasks, val_tasks = make_synthetic_cl_split(
        rng, cfg, videos_per_class_train=videos_per_class[0],
        videos_per_class_val=videos_per_class[1])
    text = (SyntheticTextSource(cfg.model.n_txt_in, cfg.dataset.max_text_len)
            if cfg.dataset.use_text else None)
    nar = (SyntheticNarrationSource(cfg.cl_cfg.narration_dim,
                                    cfg.dataset.max_narration_len)
           if cfg.cl_cfg.narration_ssl else None)
    runner = EpisodeRunner(
        cfg, TaskStream(train_tasks, val_tasks),
        SyntheticFeatureSource(cfg.dataset.input_dim), workdir=workdir,
        text_source=text, narration_source=nar,
        persist_config=persist_config, device=device)
    return cfg, runner


def apply_overrides(cfg, args):
    """The CLI's overrides of the config, as the JAX CLI applies them."""
    rep = dataclasses.replace
    cl = cfg.cl_cfg
    if args.method == "vilco":
        # the full ViLCo recipe (configs/mq_vilco.yaml cl_cfg)
        cl = rep(cl, name="l2p", prompt_pool=True, narration_ssl=True,
                 use_adapt=True, adapt_blocks=cl.adapt_blocks or (0, 1, 2),
                 memory_size=cl.memory_size or 2 * cfg.dataset.num_classes)
    elif args.method:
        cl = rep(cl, name=args.method)
        if args.method == "l2p":
            # L2P is the prompt pool
            cl = rep(cl, prompt_pool=True)
        if args.method in ("icarl", "bic") and cl.memory_size == 0:
            # rehearsal methods need exemplars
            cl = rep(cl, memory_size=2 * cfg.dataset.num_classes)
    if args.reg_lambda is not None:
        cl = rep(cl, reg_lambda=args.reg_lambda)
    if args.num_tasks:
        cl = rep(cl, num_tasks=args.num_tasks)
    opt = cfg.opt
    if args.accum_steps:
        opt = rep(opt, accumulation_steps=args.accum_steps)
    if args.epochs:
        opt = rep(opt, epochs=args.epochs)
    model = cfg.model
    if args.compute_dtype:
        model = rep(model, compute_dtype=args.compute_dtype)
    loader = cfg.loader
    if args.workers is not None:
        loader = rep(loader, num_workers=args.workers)
    if args.batch_size:
        loader = rep(loader, batch_size=args.batch_size)
    cfg = rep(cfg, cl_cfg=cl, opt=opt, model=model, loader=loader)
    if args.seed is not None:
        cfg = rep(cfg, init_rand_seed=args.seed)
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="a yaml (needs PyYAML) or an episode's config.json")
    p.add_argument("--workdir", default="./runs/default")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic features + synthetic task split (smoke)")
    p.add_argument("--synthetic-videos", type=int, nargs=2, default=(6, 2),
                   metavar=("TRAIN", "VAL"),
                   help="synthetic videos per class in each task's train "
                        "and val split (default 6 2)")
    p.add_argument("--method", default=None,
                   help="override cl_cfg.name (naive|ewc|mas|icarl|bic|"
                        "l2p|vilco)")
    p.add_argument("--reg-lambda", type=float, default=None,
                   help="override cl_cfg.reg_lambda (EWC/MAS weight)")
    p.add_argument("--task", default=None,
                   help="mq (nlq and vq are not ported)")
    p.add_argument("--num-tasks", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--joint", action="store_true",
                   help="merge all tasks into one (the non-CL upper bound)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", default=None,
                   help="checkpoint (either package's) to initialize the "
                        "params from; missing or resized leaves keep their "
                        "fresh init")
    p.add_argument("--workers", type=int, default=None,
                   help="loader worker threads")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override loader.batch_size")
    p.add_argument("--accum-steps", type=int, default=0,
                   help="micro-batches per optimizer step")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default=None, help="activation dtype override")
    p.add_argument("--seed", type=int, default=None,
                   help="override config.init_rand_seed")
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror scalar metrics to TensorBoard events in "
                        "{workdir}/logs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    # the JAX CLI's flags that the port refuses
    p.add_argument("--dp", type=int, default=0, help=REFUSED["dp"])
    p.add_argument("--distributed", action="store_true",
                   help=REFUSED["distributed"])
    p.add_argument("--factored", action="store_true",
                   help=REFUSED["factored"])
    p.add_argument("--params-bf16", action="store_true",
                   help=REFUSED["params_bf16"])
    p.add_argument("--mu-dtype", choices=["bfloat16", "float32"],
                   default=None, help="bfloat16 only (FusedAdamW)")
    p.add_argument("--nu-dtype", choices=["bfloat16", "float32"],
                   default=None, help="bfloat16 only (FusedAdamW)")
    p.add_argument("--ckpt-format", choices=["npz", "orbax"], default=None,
                   help="npz only (orbax needs JAX)")
    args = p.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            p.error(why)
    for flag in ("mu_dtype", "nu_dtype"):
        if getattr(args, flag) == "float32":
            p.error(f"--{flag.replace('_', '-')} float32: FusedAdamW keeps "
                    "bf16 moments (train/optim.py::MOMENT_DTYPE)")
    if args.ckpt_format == "orbax":
        p.error("--ckpt-format orbax: orbax needs JAX; the port writes npz")
    if args.tensorboard:
        os.environ["VILCO_TENSORBOARD_DIR"] = os.path.join(args.workdir,
                                                           "logs")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s",
                        handlers=[logging.StreamHandler(sys.stdout)])

    from vilco_tpu_torch.core.config import load_config
    from vilco_tpu_torch.data.synthetic import tiny_config

    cfg = load_config(args.config) if args.config else tiny_config()
    task = args.task or cfg.task
    if task != "mq":
        p.error(f"--task {task}: only the MQ task is ported (NLQ is "
                "ROADMAP §1 item 3, VQ item 4)")
    cfg = apply_overrides(cfg, args)
    if args.synthetic:
        cfg, runner = synthetic_mq_runner(cfg, args.workdir, args.device,
                                          tuple(args.synthetic_videos))
    else:
        from vilco_tpu_torch.tasks.mq import build_mq_runner

        runner = build_mq_runner(cfg, args.workdir, device=args.device)
    if args.joint:
        from vilco_tpu_torch.cl.stream import merge_tasks

        runner.stream = merge_tasks(runner.stream)
        runner._setup_eval()
    if args.init_from:
        from vilco_tpu_torch.core.checkpoint import load_params_into

        load_params_into(args.init_from, runner.model)
    results = runner.run(resume=args.resume)
    out = os.path.join(args.workdir, "results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({
        "final_avg_mAP": results["final"]["avg_mAP"],
        "final_R1@0.5": results["final"]["avg_R1@0.5"],
        "BwF_R1@0.5": results["final"]["BwF_R1@0.5"],
        "results_file": out,
    }))
    return results


if __name__ == "__main__":
    main()
