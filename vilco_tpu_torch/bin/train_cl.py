"""The CL training CLI of the port, MQ, NLQ and VQ
(vilco_tpu/bin/train_cl.py):

  python -m vilco_tpu_torch.bin.train_cl --config cfg.yaml --workdir ./runs/x
  python -m vilco_tpu_torch.bin.train_cl --synthetic --workdir ./runs/x
  python -m vilco_tpu_torch.bin.train_cl --task nlq --synthetic --workdir W
  python -m vilco_tpu_torch.bin.train_cl --task vq --synthetic --workdir W

`--config` takes a yaml (read with PyYAML, which the card's machine does
not have) or the config.json an episode persists (read with json). With
no config, the tiny config of the tests: data/synthetic.py::tiny_config
(MQ), tasks/nlq.py::nlq_tiny_config (NLQ), JAX's toy ClipMatcher (VQ).
Features come from the config's feat_folder (MQ), jsonl annotations with
lmdb or per-file features (NLQ), Ego4D VQ annotations with clips or frame
folders (VQ), or with `--synthetic` from the synthetic sources over a
synthetic task split. The runner trains on the card (`--device`); without
one it raises. Writes {workdir}/results.json and prints a JSON summary
line.

The VQ synthetic split's clips are 16 frames long at every window, as
JAX's: at configs/vq_vilco.yaml's 30-frame window a training window
starts at frame -14 and numpy wraps its frames around, in both packages.

Data parallelism, at JAX's global-batch semantics (parallel/mesh.py):

  python -m vilco_tpu_torch.bin.train_cl --synthetic --dp 2 --workdir W
  python -m vilco_tpu_torch.bin.train_cl --synthetic --dp 2 --device cpu ...
  torchrun --nproc-per-node N -m vilco_tpu_torch.bin.train_cl \
      --distributed --synthetic --workdir W

`--dp N` spawns N ranks itself, one card each (`-1`: every visible card),
or N Gloo processes with `--device cpu`; the global batch is the config's
batch size, each rank training on its rows of it, and rank 0 writes the
run's files. `--distributed` runs under torchrun (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT): each rank loads its shard of the
train data, the global batch is batch size x world, and each rank writes
to its own workdir (rank r > 0: {workdir}/rank{r}); with several ranks
and no --dp it turns --dp -1 on, as JAX's CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

# the --dp ranks' whole run: no deadline (each collective's wait still
# times out after parallel/mesh.py's COLLECTIVE_TIMEOUT_S)
RUN_TIMEOUT_S = None

def synthetic_mq_runner(cfg, workdir: str, device="cuda",
                        videos_per_class=(6, 2), persist_config=True,
                        writes=True):
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
        persist_config=persist_config, device=device, writes=writes)
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
    if args.factored:
        opt = rep(opt, second_moment="factored")
    if args.mu_dtype:
        opt = rep(opt, mu_dtype=args.mu_dtype)
    if args.nu_dtype:
        opt = rep(opt, nu_dtype=args.nu_dtype)
    if args.params_bf16:
        opt = rep(opt, param_compute_dtype="bfloat16")
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
    args = parse(p, argv)
    if args.dp and not args.distributed:
        return spawn_dp(p, args, list(sys.argv[1:] if argv is None
                                      else argv))
    from vilco_tpu_torch.core.logging import configure_logging

    configure_logging()
    if not args.distributed:
        return run(p, args)
    return _main_distributed(p, args)


def parse(p, argv):
    """The CLI's arguments on `p`, parsed from `argv`; the flags the port
    cannot honour exit with why."""
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
                   help="mq | nlq | vq (default from config)")
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
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N ranks (0: one process; -1: "
                        "every visible card), each on its rows of the "
                        "global batch, the gradients all-reduced; with "
                        "--device cpu, N Gloo processes")
    p.add_argument("--distributed", action="store_true",
                   help="run under torchrun: join its process group, shard "
                        "the train data per rank (global batch = batch "
                        "size x world), DP over the ranks")
    # the optimizer's forms (MQ and NLQ; the VQ runner has its own)
    p.add_argument("--factored", action="store_true",
                   help="Adafactor-style factored second moment "
                        "(opt.second_moment factored)")
    p.add_argument("--mu-dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="Adam first-moment dtype (default: config; the "
                        "shipped default is bfloat16; float32 restores "
                        "exact reference AdamW state precision)")
    p.add_argument("--nu-dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="Adam second-moment storage dtype (default: "
                        "config, bfloat16; float32 restores exact "
                        "reference AdamW state precision)")
    p.add_argument("--params-bf16", action="store_true",
                   help="persistent bf16 compute copy of the matmul "
                        "kernels + bf16 grads over an f32 AdamW master "
                        "(forward numerics identical). Needs "
                        "model.compute_dtype=bfloat16 (the flagship "
                        "default; pass --compute-dtype bfloat16 on the "
                        "synthetic tiny config); not with --dp or "
                        "--distributed")
    p.add_argument("--ckpt-format", choices=["npz", "orbax"], default=None,
                   help="npz only (orbax needs JAX)")
    # real-data VQ sources (data/vq_frames.py)
    p.add_argument("--vq-annotations", default=None,
                   help="Ego4D vq_train.json (with --task vq)")
    p.add_argument("--vq-val-annotations", default=None,
                   help="Ego4D vq_val.json (defaults to --vq-annotations)")
    p.add_argument("--vq-clip-dir", default=None,
                   help="directory of {clip_uid}.mp4 clips (needs cv2)")
    p.add_argument("--vq-images-dir", default=None,
                   help="directory of {clip_uid}/frame_XXXXXXX.jpg frames "
                        "(needs cv2)")
    p.add_argument("--vq-frame-size", type=int, default=None,
                   help="default: config vq.clip_size (448) for real data, "
                        "32 for --synthetic")
    p.add_argument("--vq-window", type=int, default=None)
    p.add_argument("--vq-categories-per-task", type=int, default=None)
    p.add_argument("--vit-ckpt", default=None,
                   help="local DINO/DINOv2/MAE torch checkpoint for the VQ "
                        "ViT (models/vit.py::load_torch_vit_checkpoint)")
    # real-data NLQ sources (reference lmdb envs or per-key dirs)
    p.add_argument("--nlq-train-jsonl", default=None,
                   help="NLQ train annotations jsonl (with --task nlq)")
    p.add_argument("--nlq-val-jsonl", default=None)
    p.add_argument("--nlq-video-lmdb", default=None,
                   help="reference video-feature lmdb env (video_id keys)")
    p.add_argument("--nlq-text-lmdb", default=None,
                   help="reference text-feature lmdb env (query_id keys)")
    p.add_argument("--nlq-val-text-lmdb", default=None)
    p.add_argument("--nlq-video-dir", default=None,
                   help="dir of {video_id}.npy features")
    p.add_argument("--nlq-text-dir", default=None,
                   help="dir of {query_id}.npz token features")
    args = p.parse_args(argv)
    if args.ckpt_format == "orbax":
        p.error("--ckpt-format orbax: orbax needs JAX; the port writes npz")
    if args.tensorboard:
        os.environ["VILCO_TENSORBOARD_DIR"] = os.path.join(args.workdir,
                                                           "logs")
    return args


def _main_distributed(p, args):
    """--distributed under torchrun: one rank of the default group."""
    import torch.distributed as dist

    from vilco_tpu_torch.core.logging import configure_logging
    from vilco_tpu_torch.parallel.mesh import init_distributed, local_device

    rank, world = init_distributed(args.device)
    try:
        configure_logging(rank, world)
        args.device = str(local_device(args.device))
        if rank > 0:
            args.workdir = os.path.join(args.workdir, f"rank{rank}")
        if world > 1 and not args.dp:
            # without the all-reduce each rank would train a replica of
            # its own on 1/world of the data
            logging.getLogger("vilco").warning(
                "--distributed with %d hosts and no --dp: enabling --dp -1 "
                "so gradients all-reduce", world)
            args.dp = -1
        if args.dp not in (0, -1, world):
            p.error(f"--dp {args.dp} under --distributed: one rank a card, "
                    f"so --dp is the world size {world} (or -1)")
        dp = None
        if args.dp:
            from vilco_tpu_torch.parallel.mesh import DataParallel

            dp = DataParallel(rank, world)
        return run(p, args, dp, shard=(rank, world))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_dp(p, args, argv):
    """`--dp N` on one host: N ranks (parallel/launch.py), one card each
    or, with --device cpu, N Gloo processes on the CPU; returns rank 0's
    results with every rank's final metrics under "rank_finals"."""
    import torch

    from vilco_tpu_torch.parallel.launch import spawn_ranks
    from vilco_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(args.device)
    n = None if args.dp == -1 else args.dp
    if dev.type == "cpu":
        devices = [dev] * (n or 1)
    else:
        try:
            devices = make_mesh(n).devices
        except ValueError as err:
            p.error(str(err))
        if not devices:
            p.error("--dp -1: no card is visible (run with --device cpu "
                    "for Gloo processes)")
    out = spawn_ranks("vilco_tpu_torch.bin.train_cl:rank_main", devices,
                      (argv,), timeout_s=RUN_TIMEOUT_S)
    results = dict(out[0])
    results["rank_finals"] = [r["final"] for r in out]
    return results


def rank_main(dp, device, argv):
    """One rank of `--dp N` (spawn_dp): the run on `device`, rank 0
    writing the files."""
    from vilco_tpu_torch.core.logging import configure_logging

    configure_logging(dp.rank, dp.world)
    p = argparse.ArgumentParser()
    args = parse(p, argv)
    args.device = str(device)
    return run(p, args, dp)


def run(p, args, dp=None, shard=(0, 1)):
    """The episode of the parsed `args`; `dp` (parallel/mesh.py::
    DataParallel) runs its train steps over the ranks, `shard` (rank,
    world) shards its train data (--distributed). Under --dp only rank 0
    writes the run's files; under --distributed every rank writes its
    own workdir's."""
    from vilco_tpu_torch.core.config import load_config
    from vilco_tpu_torch.data.synthetic import tiny_config
    from vilco_tpu_torch.tasks.nlq import nlq_tiny_config

    if args.config:
        cfg = load_config(args.config)
    elif args.task == "nlq":
        cfg = nlq_tiny_config()
    else:
        cfg = tiny_config()
    task = args.task or cfg.task
    cfg = apply_overrides(cfg, args)
    writes = dp is None or shard[1] > 1 or dp.rank == 0
    if task == "vq":
        if args.params_bf16:
            p.error("--params-bf16 covers the point-transformer engine "
                    "(mq/nlq); the VQ runner's optimizer does not consume "
                    "it")
        return train_vq(p, args, cfg, dp, shard, writes)
    if task == "nlq":
        if args.joint:
            p.error("--joint: the NLQ runner has no joint mode")
        runner = nlq_runner(p, args, cfg, writes)
    elif task == "mq":
        if args.synthetic:
            cfg, runner = synthetic_mq_runner(
                cfg, args.workdir, args.device, tuple(args.synthetic_videos),
                writes=writes)
        else:
            from vilco_tpu_torch.tasks.mq import build_mq_runner

            runner = build_mq_runner(cfg, args.workdir, device=args.device,
                                     writes=writes)
        if args.joint:
            from vilco_tpu_torch.cl.stream import merge_tasks

            runner.stream = merge_tasks(runner.stream)
            runner._setup_eval()
    else:
        p.error(f"--task {task}: one of mq, nlq, vq")
    prep(runner, args, dp, shard)
    results = runner.run(resume=args.resume)
    if not writes:
        return results
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


def prep(runner, args, dp, shard):
    """The pre-run settings shared by the tasks' runners: the train
    data's shard, data parallelism (from rank 0's parameters, so after
    --init-from), --init-from."""
    runner.shard = shard
    if args.init_from:
        from vilco_tpu_torch.core.checkpoint import load_params_into

        load_params_into(args.init_from, runner.model)
    if dp is not None:
        runner.enable_data_parallel(dp, sharded_loader=shard[1] > 1)
    return runner


def synthetic_nlq_runner(cfg, workdir: str, device="cuda",
                         persist_config=True, narration=True, writes=True):
    """The synthetic NLQ episode (vilco_tpu/bin/train_cl.py's synthetic NLQ
    path): a template split of 8 train and 3 val queries a template from
    numpy's default_rng(init_rand_seed), SyntheticNLQFeatures, and, with
    `narration`, the synthetic narration source where the config reads
    it."""
    import numpy as np

    from vilco_tpu_torch.data.pipeline import SyntheticNarrationSource
    from vilco_tpu_torch.tasks.nlq import (
        NLQEpisodeRunner,
        NLQTaskStream,
        SyntheticNLQFeatures,
        make_synthetic_nlq_split,
    )

    train_tasks, val_tasks = make_synthetic_nlq_split(
        np.random.default_rng(cfg.init_rand_seed), cfg)
    feat = SyntheticNLQFeatures(cfg.dataset.input_dim, cfg.model.n_txt_in)
    nar = (SyntheticNarrationSource(cfg.cl_cfg.narration_dim,
                                    cfg.dataset.max_narration_len)
           if narration and cfg.cl_cfg.narration_ssl else None)
    return NLQEpisodeRunner(cfg, NLQTaskStream(train_tasks, val_tasks),
                            feat.video, workdir=workdir,
                            text_source=feat.text, narration_source=nar,
                            persist_config=persist_config, device=device,
                            writes=writes)


def nlq_runner(p, args, cfg, writes=True):
    """The NLQ runner of the CLI's arguments: jsonl annotations with lmdb
    or per-file features, or the synthetic episode."""
    if args.nlq_train_jsonl:
        from vilco_tpu_torch.tasks.nlq import build_nlq_runner

        return build_nlq_runner(
            cfg, args.workdir, args.nlq_train_jsonl,
            args.nlq_val_jsonl or args.nlq_train_jsonl,
            video_lmdb=args.nlq_video_lmdb, text_lmdb=args.nlq_text_lmdb,
            val_text_lmdb=args.nlq_val_text_lmdb,
            video_dir=args.nlq_video_dir, text_dir=args.nlq_text_dir,
            device=args.device, writes=writes)
    if not args.synthetic:
        p.error("--task nlq needs --synthetic or --nlq-train-jsonl with a "
                "feature source")
    return synthetic_nlq_runner(cfg, args.workdir, args.device,
                                writes=writes)


def vq_runner_kwargs(args, cfg):
    """(vq section with the --vq-* size flags on top or None, the VQ
    runner's keywords) as JAX's CLI derives them: the config's vq section
    when a config is given, the CLI's flags over it."""
    rep = dataclasses.replace
    vqc = cfg.vq if args.config else None
    if vqc is not None:
        if args.vq_frame_size:
            vqc = rep(vqc, clip_size=args.vq_frame_size,
                      query_size=args.vq_frame_size)
        if args.vq_window:
            vqc = rep(vqc, num_frames=args.vq_window)
    kw = {"seed": cfg.init_rand_seed, "ckpt_format": cfg.ckpt_format,
          "device": args.device, "method": args.method or "naive",
          "epochs": args.epochs or 4}
    if vqc is not None:
        kw.update(model_cfg=vqc, batch_size=vqc.batch_size, lr=vqc.lr,
                  weight_decay=vqc.weight_decay, use_hnm=vqc.use_hnm,
                  augment=vqc.augment,
                  positive_threshold=vqc.positive_threshold,
                  positive_topk=vqc.positive_topk,
                  vit_ckpt=args.vit_ckpt or vqc.vit_ckpt,
                  accumulation_steps=vqc.accumulation_steps)
    elif args.vit_ckpt:
        kw["vit_ckpt"] = args.vit_ckpt
    if args.accum_steps:
        kw["accumulation_steps"] = args.accum_steps
    if args.batch_size:
        kw["batch_size"] = args.batch_size
    if args.reg_lambda is not None:
        kw["reg_lambda"] = args.reg_lambda
    return vqc, kw


def train_vq(p, args, cfg, dp=None, shard=(0, 1), writes=True):
    """The VQ episode (vilco_tpu/bin/train_cl.py's --task vq): real
    annotations through data/vq_frames.py, or the synthetic split (JAX's:
    16-frame clips at any window); `--joint` merges the tasks into one."""
    import numpy as np

    from vilco_tpu_torch.tasks.vq import (
        SyntheticVQSource,
        VQEpisodeRunner,
        VQTaskStream,
        make_synthetic_vq_split,
        merge_vq_tasks,
    )

    vqc, kw = vq_runner_kwargs(args, cfg)
    rehearsal = args.method in ("icarl", "rehearsal", "vilco")
    if args.vq_annotations:
        from vilco_tpu_torch.data.vq_frames import (
            FrameDirSource,
            VideoFrameSource,
            group_splits,
            load_vq_annotations,
        )

        frame_size = args.vq_frame_size or (vqc.clip_size if vqc else 448)
        window = args.vq_window or (vqc.num_frames if vqc else 30)
        train_s = load_vq_annotations(args.vq_annotations, "train")
        val_s = load_vq_annotations(
            args.vq_val_annotations or args.vq_annotations, "val")
        per = args.vq_categories_per_task or (
            vqc.categories_per_task if vqc else 400)
        stream = VQTaskStream(*group_splits(train_s, val_s, per))
        if args.vq_images_dir:
            source = FrameDirSource(args.vq_images_dir, frame_size=frame_size)
        elif args.vq_clip_dir:
            source = VideoFrameSource(args.vq_clip_dir, frame_size=frame_size)
        else:
            p.error("--vq-annotations needs --vq-clip-dir or "
                    "--vq-images-dir")
        memory = 2 * per if rehearsal else 0
    else:
        if not args.synthetic:
            p.error("--task vq needs --synthetic or --vq-annotations with a "
                    "frame source")
        frame_size = args.vq_frame_size or (vqc.clip_size if vqc else 32)
        window = args.vq_window or (vqc.num_frames if vqc else 4)
        stream = VQTaskStream(*make_synthetic_vq_split(
            np.random.default_rng(cfg.init_rand_seed),
            num_tasks=args.num_tasks or 3))
        source = SyntheticVQSource(frame_size=frame_size)
        memory = 8 if args.method in ("icarl", "rehearsal") else 0
    if args.joint:
        stream = merge_vq_tasks(stream)
    runner = VQEpisodeRunner(stream, source, args.workdir, window=window,
                             frame_size=frame_size, memory_size=memory,
                             writes=writes, **kw)
    prep(runner, args, dp, shard)
    results = runner.run()
    if not writes:
        return results
    out = os.path.join(args.workdir, "results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({
        "final_avg_tAP25": results["final"]["avg_tAP25"],
        "final_avg_stAP25": results["final"]["avg_stAP25"],
        "final_avg_success": results["final"]["avg_success"],
        "results_file": out,
    }))
    return results


if __name__ == "__main__":
    main()
