"""VQ inference and scoring from a VQ episode's workdir
(vilco_tpu/bin/vq_infer.py): the ClipMatcher rebuilt from the workdir's
vq_config.json (either package's), the latest vq_task_*.ckpt loaded
(either package's: JAX's Flax tree through models/convert.py),
sliding-window prediction, peak finding into response tracks, the
official metrics; with `--submission`, the ego4d_vq2d_challenge file.

  python -m vilco_tpu_torch.bin.vq_infer --workdir ./runs/vq --synthetic

Real data (Ego4D vq_val.json with decoded clips or extracted frames; the
frame sources need cv2):

  python -m vilco_tpu_torch.bin.vq_infer --workdir ./runs/vq \\
      --annotations vq_val.json --clip-dir ./clips   # or --images-dir

The synthetic split is the one train_cl --task vq --synthetic draws at the
workdir's window (tasks/vq.py::synthetic_frames), from numpy's
default_rng(--seed), 0 by default as JAX's. The runner runs on the card
(`--device`); without one it raises.
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
    p.add_argument("--workdir", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-tasks", type=int, default=2)
    p.add_argument("--seed", type=int, default=0,
                   help="the synthetic split's seed (0, as JAX's; pass the "
                        "training run's init_rand_seed to score its split)")
    p.add_argument("--annotations", help="Ego4D vq_val.json to score")
    p.add_argument("--train-annotations",
                   help="Ego4D vq_train.json of the training run, for the "
                        "same category -> task grouping as train_cl")
    p.add_argument("--clip-dir", help="directory of {clip_uid}.mp4 clips")
    p.add_argument("--images-dir",
                   help="directory of {clip_uid}/frame_XXXXXXX.jpg frames")
    p.add_argument("--frame-size", type=int, default=448)
    p.add_argument("--window", type=int, default=30)
    p.add_argument("--categories-per-task", type=int, default=400,
                   help="QIL grouping (scripts/split_vq.py: 5 x ~400)")
    p.add_argument("--submission",
                   help="also write the ego4d_vq2d_challenge prediction "
                        "file here; requires --annotations")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)
    if args.submission and not args.annotations:
        p.error("--submission requires --annotations (the raw Ego4D json "
                "provides the videos -> clips -> query_sets structure)")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    import numpy as np

    from vilco_tpu_torch.core.checkpoint import load_checkpoint, params_of
    from vilco_tpu_torch.core.config import VQConfig
    from vilco_tpu_torch.tasks.vq import (
        SyntheticVQSource,
        VQEpisodeRunner,
        VQTaskStream,
        make_synthetic_vq_split,
        synthetic_frames,
    )

    # the training runner's model-defining settings: the rebuilt
    # ClipMatcher matches the checkpoint's shapes without the flags
    kw = {"persist_config": False, "device": args.device}
    man = None
    manifest = os.path.join(args.workdir, "vq_config.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            man = json.load(f)
        if man.get("model_cfg"):
            kw["model_cfg"] = VQConfig.from_dict(man["model_cfg"])
        if (args.window, args.frame_size) != (man["window"],
                                              man["frame_size"]):
            logging.info("vq_config.json overrides the CLI's shape: "
                         "window=%d frame_size=%d", man["window"],
                         man["frame_size"])
        args.window, args.frame_size = man["window"], man["frame_size"]

    if args.annotations:
        from vilco_tpu_torch.data.vq_frames import (
            FrameDirSource,
            VideoFrameSource,
            group_by_category,
            group_splits,
            load_vq_annotations,
        )

        samples = load_vq_annotations(args.annotations, split="val")
        if args.train_annotations:
            train_s = load_vq_annotations(args.train_annotations, "train")
            _, tasks = group_splits(train_s, samples,
                                    args.categories_per_task)
        else:
            logging.warning(
                "no --train-annotations: the category -> task grouping is "
                "over the val categories only and may not match training")
            tasks = group_by_category(samples, args.categories_per_task)
        stream = VQTaskStream(tasks, tasks)
        if args.images_dir:
            src = FrameDirSource(args.images_dir, frame_size=args.frame_size)
        elif args.clip_dir:
            src = VideoFrameSource(args.clip_dir, frame_size=args.frame_size)
        else:
            p.error("--annotations needs --clip-dir or --images-dir")
        window, frame_size = args.window, args.frame_size
    else:
        # without a manifest the synthetic path keeps the toy geometry
        window = args.window if man else 4
        frame_size = args.frame_size if man else 32
        stream = VQTaskStream(*make_synthetic_vq_split(
            np.random.default_rng(args.seed), num_tasks=args.num_tasks,
            num_frames=synthetic_frames(window), window=window))
        src = SyntheticVQSource(frame_size=frame_size)
    runner = VQEpisodeRunner(stream, src, args.workdir, window=window,
                             frame_size=frame_size, **kw)

    ckpts = sorted(glob.glob(os.path.join(args.workdir, "vq_task_*.ckpt")))
    if ckpts:
        tree = load_checkpoint(ckpts[-1])
        runner.set_params(params_of(tree))
        j = int(tree["task"])
    else:
        j = stream.num_tasks - 1

    results = runner.evaluate(j)
    if args.submission:
        from vilco_tpu_torch.tasks.vq import build_vq_submission

        with open(args.annotations) as f:
            raw = json.load(f)
        sub = build_vq_submission(runner, raw)
        with open(args.submission, "w") as f:
            json.dump(sub, f)
        logging.info("wrote %s submission to %s", sub["challenge"],
                     args.submission)
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
