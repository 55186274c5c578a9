"""VQ task plugin: visual-query 2-D tracking as a CL stream
(vilco_tpu/tasks/vq.py): the category-keyed task stream, the synthetic
source and split, the toy ClipMatcher's config, sliding-window serving
and the episode runner, on the port's model, train step and eval step.

Serving (`predict_track`) cuts a clip into windows of `window` frames (the
last start pulled back to T - window, the frame indices clipped to the
clip), runs them through the eval step in chunks of eval_windows (a power
of two no larger than the window count, the tail chunk padded by
repeating its last window), keeps for each frame the box of its
best-scoring window (strictly greater replaces), turns the boxes into
pixels and finds the response track by peak finding on the score curve.

The episode (`VQEpisodeRunner`, JAX's method by method): for each task,
train the tracker on the task's samples (plus the rehearsal memory), a
fresh optimizer a task; evaluate every seen task by sliding-window
inference and the official metrics (tAP, stAP, Success, recovery), BwF on
tAP@0.25; (EWC/MAS) the importance of the finished task from its last
batch; update the memory; save vq_task_{j:03d}.ckpt. The train batches
are drawn by numpy exactly as JAX draws them (the task's permutation and
each window from SeedSequence([seed, epoch_key, step, position])), so the
two packages train on the same windows; the augmentation's draws come
from a CPU torch.Generator (data/vq_augment.py). The runner runs on
`device` (the card unless the caller asks for the CPU; no card raises).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.cl.stream import RehearsalMemory, _dedup_by_id
from vilco_tpu_torch.core.checkpoint import save_checkpoint
from vilco_tpu_torch.core.config import VQConfig
from vilco_tpu_torch.core.registry import TASKS
from vilco_tpu_torch.evals.retrieval import BwfTracker
from vilco_tpu_torch.evals.vq_metrics import (
    BBox,
    ResponseTrack,
    compute_visual_query_metrics,
    predictions_to_response_track,
)
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.train.vq_engine import (
    GT_KEYS,
    VQTrainState,
    make_vq_eval_step,
    make_vq_optimizer,
    make_vq_train_step,
    vq_losses,
)

log = logging.getLogger("vilco.vq")

# epoch_key of the EWC/MAS importance pass's batches; training epochs key
# theirs by (task << 16) | epoch, which stays far below it
_IMPORTANCE_EPOCH_KEY = 0x7FFF0000
# the synthetic split's clip length: JAX's 16 frames up to a window of
# SYNTHETIC_WINDOW_MAX, else 2 x window, so that no training window starts
# before frame 0 (JAX's 16-frame clips with a 30-frame window wrap around)
SYNTHETIC_FRAMES = 16
SYNTHETIC_WINDOW_MAX = 8
# the ClipMatcher's forward dtype when the caller names none: bf16, as the
# JAX model's default
COMPUTE_DTYPE = torch.bfloat16


def window_chunks(T: int, window: int, eval_windows: int):
    """(window frame indices (n, window), chunk size) of a T-frame clip."""
    starts = [max(min(s, T - window), 0) for s in range(0, T, window)]
    idx = np.stack([np.minimum(np.arange(s, s + window), T - 1)
                    for s in starts])
    n = len(starts)
    return idx, max(min(eval_windows, 1 << (n - 1).bit_length()), 1)


def predict_track(model: ClipMatcher,
                  frames: Union[torch.Tensor, Callable],
                  query: torch.Tensor, query_frame: int,
                  window: Optional[int] = None,
                  eval_windows: Optional[int] = None,
                  marks: Optional[List] = None,
                  num_frames: Optional[int] = None) -> ResponseTrack:
    """frames (T, H, W, 3) and query (H, W, 3) on the model's device ->
    the response track. `frames` may instead be a callable taking the
    frame indices of a chunk's windows (n, window) and returning their
    frames (n, window, H, W, 3) on the device, with `num_frames` T: a
    chunk's frames are then fetched when it runs. window and eval_windows
    default to the model config's num_frames and eval_windows. `marks`,
    if a list, receives the eval step's ViT / matcher / top-anchor
    boundaries of each chunk and ("peaks_ms", host ms of the merge and the
    peak finding)."""
    cfg = model.cfg
    window = window or cfg.num_frames
    eval_windows = eval_windows or cfg.eval_windows
    if callable(frames):
        fetch, T = frames, num_frames
    else:
        fetch, T = (lambda ix: frames[torch.from_numpy(ix).to(
            frames.device)]), frames.shape[0]
    idx, chunk = window_chunks(T, window, eval_windows)
    step = make_vq_eval_step(model)
    queries = query[None].repeat(chunk, 1, 1, 1)
    outs = []
    for c0 in range(0, len(idx), chunk):
        sel = idx[c0:c0 + chunk]
        clips = fetch(sel)
        if len(sel) < chunk:        # pad the tail chunk by repetition
            clips = torch.cat([clips, clips[-1:].expand(
                (chunk - len(sel),) + tuple(clips.shape[1:]))])
        bbox, prob = step(clips, queries, marks)
        outs.append((sel, bbox[:len(sel)].cpu().numpy(),
                     prob[:len(sel)].cpu().numpy()))
    t0 = time.perf_counter()
    scores = np.zeros((T,), np.float64)
    boxes = np.zeros((T, 4), np.float64)
    counts = np.zeros((T,), np.int64)
    for sel, bbox_b, prob_b in outs:
        for bi, frames_of in enumerate(sel):
            for i, f in enumerate(frames_of):
                if counts[f] == 0 or prob_b[bi, i] > scores[f]:
                    scores[f] = prob_b[bi, i]
                    boxes[f] = bbox_b[bi, i]
                counts[f] += 1
    track = predictions_to_response_track(scores, boxes * cfg.clip_size,
                                          query_frame)
    if marks is not None:
        marks.append(("peaks_ms", (time.perf_counter() - t0) * 1e3))
    return track


class VQTaskStream:
    """Category-keyed QIL stream (VQ/dataset/cl_benchmark.py:18-120):
    {task_idx: {category: [sample dicts]}}."""

    def __init__(self, train_tasks: Dict[int, Dict[str, list]],
                 val_tasks: Dict[int, Dict[str, list]]):
        self.task_ids = sorted(train_tasks)
        self.train_tasks = train_tasks
        self.val_tasks = val_tasks

    @property
    def num_tasks(self) -> int:
        return len(self.task_ids)

    def train_class_videos(self, j: int) -> Dict[str, list]:
        return self.train_tasks[self.task_ids[j]]

    def train_videos(self, j: int,
                     memory: Optional[RehearsalMemory] = None) -> List[dict]:
        out = []
        if memory is not None:
            out.extend(memory.videos())
        for samples in self.train_tasks[self.task_ids[j]].values():
            out.extend(dict(s, is_memory=False) for s in samples)
        return _dedup_by_id(out)

    def val_videos_task(self, i: int) -> List[dict]:
        out = []
        for samples in self.val_tasks[self.task_ids[i]].values():
            out.extend(samples)
        return _dedup_by_id(out)

    def memory_quota(self, memory_size: int, n_categories: int) -> int:
        return memory_size // max(n_categories, 1)


def merge_vq_tasks(stream: VQTaskStream) -> VQTaskStream:
    """Collapse all tasks into one: the reference's non-CL trainer
    (VQ/train_anchor.py) upper bound."""

    def merge(tasks):
        cats = {}
        for t in tasks.values():
            for c, samples in t.items():
                cats.setdefault(c, []).extend(samples)
        return {0: cats}

    return VQTaskStream(merge(stream.train_tasks), merge(stream.val_tasks))


class SyntheticVQSource:
    """Renders clips with a moving bright patch; the lit color channel is a
    hash of the sample's category, and the query crop shows the same patch.
    """

    def __init__(self, frame_size: int = 32, noise: float = 0.15):
        self.frame_size = frame_size
        self.noise = noise

    def _chan(self, category: str) -> int:
        return int(hashlib.md5(category.encode()).hexdigest()[:8], 16) % 3

    def clip(self, sample: dict) -> np.ndarray:
        """(T_total, H, W, 3) frames following sample['track'] boxes."""
        seed = int(hashlib.md5(sample["id"].encode()).hexdigest()[8:16], 16)
        rng = np.random.default_rng(seed)
        S = self.frame_size
        T = sample["num_frames"]
        frames = rng.random((T, S, S, 3)).astype(np.float32) * self.noise
        ch = self._chan(sample["category"])
        for fno, box in sample["track"].items():
            x1, y1, x2, y2 = (np.asarray(box) * S).astype(int)
            frames[fno, y1:max(y2, y1 + 1), x1:max(x2, x1 + 1), ch] = 1.0
        return frames

    def query(self, sample: dict) -> np.ndarray:
        S = self.frame_size
        q = np.random.default_rng(0).random((S, S, 3)).astype(
            np.float32
        ) * self.noise
        ch = self._chan(sample["category"])
        c = S // 4
        q[c:-c, c:-c, ch] = 1.0
        return q

    def frames(self, sample: dict, idxs) -> np.ndarray:
        return self.clip(sample)[np.asarray(idxs, np.int64)]


def make_synthetic_vq_split(rng: np.random.Generator, num_tasks: int = 3,
                            cats_per_task: int = 2,
                            samples_per_cat_train: int = 4,
                            samples_per_cat_val: int = 2,
                            num_frames: int = 16, window: int = 4):
    """{task: {category: [samples]}} with box tracks occupying a contiguous
    span of frames before the query frame."""

    def split(n, name):
        tasks = {}
        sid = 0
        for k in range(num_tasks):
            cats = {}
            for ci in range(cats_per_task):
                cat = f"cat_{k * cats_per_task + ci}"
                samples = []
                for _ in range(n):
                    span = int(rng.integers(3, max(4, num_frames // 2)))
                    start = int(rng.integers(0, num_frames - span))
                    cx, cy = rng.uniform(0.3, 0.7, 2)
                    sz = rng.uniform(0.15, 0.3)
                    track = {}
                    for f in range(start, start + span):
                        dx = (f - start) * 0.02
                        track[f] = [
                            float(np.clip(cx - sz / 2 + dx, 0, 1 - sz)),
                            float(np.clip(cy - sz / 2, 0, 1 - sz)),
                            float(np.clip(cx + sz / 2 + dx, sz, 1)),
                            float(np.clip(cy + sz / 2, sz, 1)),
                        ]
                    samples.append({
                        "id": f"{name}_s{sid:05d}",
                        "category": cat,
                        "num_frames": num_frames,
                        "track": track,
                        "query_frame": num_frames - 1,
                        "window": window,
                    })
                    sid += 1
                cats[cat] = samples
            tasks[k] = cats
        return tasks

    return (split(samples_per_cat_train, "train"),
            split(samples_per_cat_val, "val"))


def synthetic_frames(window: int) -> int:
    """The synthetic split's clip length at `window` (SYNTHETIC_FRAMES)."""
    return SYNTHETIC_FRAMES if window <= SYNTHETIC_WINDOW_MAX else 2 * window


def toy_vq_config(window: int = 4, frame_size: int = 32) -> VQConfig:
    """The ClipMatcher JAX's build_clip_matcher builds without a VQCfg (the
    port's ClipMatcher takes the config itself): the CI-sized geometry, 8 x
    8 patches of a 48-wide, 2-deep ViT, a dim-64 matcher over
    frame_size / 8 cells, one spatio-temporal layer."""
    return VQConfig(dim=64, clip_size=frame_size, query_size=frame_size,
                    patch_size=8, vit_dim=48, vit_depth=2, vit_heads=4,
                    resolution_transformer=frame_size // 8,
                    resolution_anchor_feat=frame_size // 8,
                    num_transformer=1, window_transformer=5,
                    num_frames=window)


@TASKS.register("vq")
class VQEpisodeRunner:
    """CL episode engine for VQ (VQ/train_cl.py:51-280; module docstring).
    The keyword arguments are JAX's runner's; with `model_cfg` the window
    and frame size follow it. `device` (the card by default) and
    `compute_dtype` (COMPUTE_DTYPE if None) are the port's."""

    def __init__(self, stream: VQTaskStream, source, workdir: str, *,
                 window: int = 4, frame_size: int = 32,
                 method: str = "naive", memory_size: int = 0,
                 reg_lambda: float = 0.0, epochs: int = 4,
                 batch_size: int = 2, lr: float = 1e-3, seed: int = 0,
                 use_hnm: bool = False, augment: bool = False,
                 eval_windows: int = 8, model_cfg: Optional[VQConfig] = None,
                 vit_ckpt: str = "", weight_decay: float = 1e-4,
                 positive_threshold: float = 0.2, positive_topk: int = 5,
                 accumulation_steps: int = 1, persist_config: bool = True,
                 ckpt_format: str = "npz", grad_max: float = 20.0,
                 lr_milestones: tuple = (7000, 14000, 20000, 25000),
                 lr_gamma: float = 0.3, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None):
        self.stream = stream
        self.source = source
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.device = device_of(device)
        self.method = method
        self.memory_size = memory_size
        self.reg_lambda = reg_lambda
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.augment = augment
        self.ckpt_format = ckpt_format
        self.eval_windows = eval_windows
        self.accumulation_steps = max(accumulation_steps, 1)
        # the augmentation's draws (data/vq_augment.py), on the host
        self._aug_gen = torch.Generator().manual_seed(seed + 99)
        base = model_cfg
        if base is None:
            base = toy_vq_config(window, frame_size)
        # the train step's and optimizer's settings from the keywords
        self.cfg = dataclasses.replace(
            base, batch_size=batch_size, lr=lr, weight_decay=weight_decay,
            use_hnm=use_hnm, augment=augment,
            positive_threshold=positive_threshold,
            positive_topk=positive_topk,
            accumulation_steps=self.accumulation_steps,
            eval_windows=eval_windows, grad_max=grad_max,
            lr_milestones=tuple(lr_milestones), lr_gamma=lr_gamma)
        self.window = self.cfg.num_frames
        self.frame_size = self.cfg.clip_size
        if persist_config:
            # the model-defining settings, so that bin/vq_infer.py (of
            # either package) rebuilds the ClipMatcher from the workdir
            with open(os.path.join(workdir, "vq_config.json"), "w") as f:
                json.dump({
                    "window": self.window,
                    "frame_size": self.frame_size,
                    "model_cfg": (model_cfg.to_dict()
                                  if model_cfg is not None else None),
                }, f, indent=2)
        self.model = ClipMatcher(
            self.cfg, generator=torch.Generator().manual_seed(seed),
            device=self.device, compute_dtype=compute_dtype or COMPUTE_DTYPE)
        if vit_ckpt:
            from vilco_tpu_torch.models.vit import load_torch_vit_checkpoint

            load_torch_vit_checkpoint(self.model.backbone, vit_ckpt)
        self.train_step = make_vq_train_step(self.cfg)
        self.memory = RehearsalMemory(seed=seed)
        self.reg_list: List = []
        self.bwf = BwfTracker()
        # a list, when set, receives predict_track's timing marks
        self.eval_marks: Optional[List] = None

    # --------------------------------------------------------------
    @torch.no_grad()
    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy {name: tensor} into every parameter of the model, in
        place; the names must be the model's, and every one given."""
        own = dict(self.model.named_parameters())
        if set(own) != set(params):
            raise ValueError(
                f"parameters differ: missing {sorted(set(own) - set(params))}"
                f", unexpected {sorted(set(params) - set(own))}")
        for name, p in own.items():
            p.copy_(params[name].to(p.device, p.dtype))

    def params_numpy(self) -> Dict[str, np.ndarray]:
        return {n: p.detach().float().cpu().numpy()
                for n, p in self.model.named_parameters()}

    def _window_indices(self, sample: dict,
                        rng: np.random.Generator) -> np.ndarray:
        """Training-window frame indices: the reference's balanced sampler
        when the sample carries a `valid_range` (real Ego4D annotations),
        else a random contiguous window around the track. A clip shorter
        than the window raises (JAX's start would go below 0 and numpy
        would wrap the frames around)."""
        T = sample["num_frames"]
        w = self.window
        if sample.get("valid_range") is not None:
            from vilco_tpu_torch.data.vq_frames import balanced_frame_indices

            return np.clip(balanced_frame_indices(w, sample, rng),
                           0, max(T - 1, 0))
        if T < w:
            raise ValueError(f"sample {sample['id']}: {T} frames, shorter "
                             f"than the {w}-frame window")
        fnos = sorted(sample["track"])
        center = int(rng.choice(fnos))
        start = int(np.clip(center - rng.integers(0, w), 0, T - w))
        return np.arange(start, start + w)

    def _fetch_frames(self, sample: dict, idxs) -> np.ndarray:
        if hasattr(self.source, "frames"):
            return self.source.frames(sample, idxs)
        return self.source.clip(sample)[np.asarray(idxs, np.int64)]

    def _sample_window(self, sample: dict, rng: np.random.Generator):
        """Random training window around the response track."""
        w = self.window
        idxs = self._window_indices(sample, rng)
        clip = self._fetch_frames(sample, idxs)
        bbox = np.zeros((w, 4), np.float32)
        with_box = np.zeros((w,), np.float32)
        for i, f in enumerate(idxs):
            box = sample["track"].get(int(f))
            if box is not None:
                bbox[i] = box
                with_box[i] = 1.0
        before = (idxs < sample["query_frame"]).astype(np.float32)
        return {
            "clip": clip,
            "query": self.source.query(sample),
            "clip_bbox": bbox,
            "clip_with_bbox": with_box,
            "before_query": before,
        }

    def _train_batches(self, videos, rng, batch_size=None, *,
                       epoch_key: int = 0, last_only: bool = False):
        """Yield per-optimizer-step batches (numpy) as JAX draws them: one
        batch = accumulation_steps micro-batches of batch_size; the
        permutation from `rng`, each position's window from an rng keyed by
        (seed, epoch_key, step, position). `last_only` builds only the
        final step's batch (the keys do not depend on earlier steps)."""
        idx = rng.permutation(len(videos))
        B = batch_size or self.batch_size * self.accumulation_steps
        pool = np.resize(idx, max(len(idx), B))
        n_steps = max(len(idx) // B, 1)
        for b in range(n_steps - 1 if last_only else 0, n_steps):
            sel = pool[b * B:(b + 1) * B]
            parts = []
            for pos in range(B):
                win_rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch_key, b, pos]))
                parts.append(self._sample_window(videos[sel[pos]], win_rng))
            yield {k: np.stack([p[k] for p in parts]) for k in parts[0]}

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _augment(self, batch):
        """The batch augmented on the device by draws from the runner's
        CPU generator (data/vq_augment.py)."""
        from vilco_tpu_torch.data.vq_augment import (
            augment_vq_batch,
            draw_vq_augment,
        )

        draws = draw_vq_augment(self._aug_gen, batch["clip"].shape[0])
        return augment_vq_batch(batch, draws)

    def train_task(self, j: int):
        use_memory = self.memory_size > 0 and j > 0
        videos = self.stream.train_videos(
            j, self.memory if use_memory else None)
        rng = np.random.default_rng(self.seed + j)
        # a fresh optimizer a task: the trainable parameters become views of
        # its flat buffer, their values kept
        state = VQTrainState(
            model=self.model, opt=make_vq_optimizer(self.model, self.cfg),
            generator=torch.Generator(device=self.device).manual_seed(
                self.seed + j))
        reg = None
        if self.method in ("ewc", "mas") and self.reg_list:
            from vilco_tpu_torch.cl.regularizers import RegPenalty

            reg = RegPenalty.for_optimizer(self.reg_list, state.opt,
                                           self.reg_lambda, model=self.model)
        t0 = time.time()
        n = 0
        metrics = {}
        for ep in range(self.epochs):
            for batch in self._train_batches(
                    videos, np.random.default_rng(
                        np.random.SeedSequence([self.seed, j, ep])),
                    epoch_key=(j << 16) | ep):
                batch = self._to_device(batch)
                if self.augment:
                    batch = self._augment(batch)
                metrics = self.train_step(state, batch, reg=reg)
                n += 1
        last = {k: float(v) for k, v in metrics.items()}
        log.info("vq task %d: %d steps, %.1fs, %s", j, n, time.time() - t0,
                 {k: round(v, 4) for k, v in last.items()})

        if self.method in ("ewc", "mas") and j < self.stream.num_tasks - 1:
            self._estimate_importance(videos, rng)
        if self.memory_size > 0:
            n_cats = sum(len(self.stream.train_class_videos(i))
                         for i in range(j + 1))
            m = self.stream.memory_quota(self.memory_size, n_cats)
            self.memory.add_task(self.stream.train_class_videos(j), m)
        return last

    def _estimate_importance(self, videos, rng):
        """The reference's rule (VQ/cl_methods/EWC.py:40 zeroes the
        gradients at the top of every batch): only the last batch's
        gradient becomes the importance, g^2 for EWC and |g| for MAS, so
        only that batch is built, at the micro batch size, with no
        augmentation, no HNM and no dropout. The frozen ViT's importance is
        0 (JAX stops its gradient); optpar copies every leaf."""
        last = None
        for batch in self._train_batches(videos, rng, self.batch_size,
                                         epoch_key=_IMPORTANCE_EPOCH_KEY,
                                         last_only=True):
            last = batch
        if last is None:
            return
        batch = self._to_device(last)
        model = self.model
        was = model.training
        model.eval()
        named = list(model.named_parameters())
        preds = model(batch["clip"], batch["query"])
        loss = vq_losses(preds, {k: batch[k] for k in GT_KEYS})[0]
        train = [p for _, p in named if p.requires_grad]
        got = iter(torch.autograd.grad(loss, train))
        model.train(was)
        f = torch.square if self.method == "ewc" else torch.abs
        imp = {n: (f(next(got).detach().float()) if p.requires_grad
                   else torch.zeros_like(p, dtype=torch.float32))
               for n, p in named}
        optpar = {n: p.detach().float().clone() for n, p in named}
        self.reg_list.append((imp, optpar))

    # --------------------------------------------------------------
    def predict_track(self, sample: dict) -> ResponseTrack:
        """Sliding-window inference over the whole clip (module-level
        `predict_track`), each chunk's frames fetched when it runs, so that
        host memory stays bounded on long clips."""
        S = self.frame_size
        query = torch.from_numpy(self.source.query(sample)).to(self.device)

        def fetch(ix):
            frames = self._fetch_frames(sample, ix.reshape(-1))
            return torch.from_numpy(frames).to(self.device).reshape(
                ix.shape + (S, S, 3))

        return predict_track(self.model, fetch, query, sample["query_frame"],
                             window=self.window,
                             eval_windows=self.eval_windows,
                             marks=self.eval_marks,
                             num_frames=sample["num_frames"])

    def evaluate(self, j: int) -> Dict:
        per_task = []
        per_task_key = {}
        weights = {}
        for i in range(j + 1):
            samples = self.stream.val_videos_task(i)
            gt_rts, pred_rts = [], []
            for s in samples:
                gt_boxes = [
                    BBox(f, *(np.asarray(b) * self.frame_size))
                    for f, b in sorted(s["track"].items())
                ]
                gt_rts.append(ResponseTrack(gt_boxes))
                pred_rts.append([self.predict_track(s)])
            # sliding-window inference scans every pre-query frame, so
            # accessed == total and search efficiency reports 0 (the
            # reference's exhaustive path behaves identically)
            n_frames = [int(s["query_frame"]) for s in samples]
            m = compute_visual_query_metrics(
                pred_rts, gt_rts, accessed_frames=n_frames,
                total_frames=n_frames,
            )
            weights[i] = len(samples)
            per_task_key[i] = m["tAP@0.25"]
            per_task.append({"task": i, **m})
        bwf = self.bwf.update(j, per_task_key, weights)
        avg = lambda key: float(np.average(
            [t[key] for t in per_task],
            weights=[weights[t["task"]] for t in per_task],
        ))
        return {
            "per_task": per_task,
            "avg_tAP25": avg("tAP@0.25"),
            "avg_stAP25": avg("stAP@0.25"),
            "avg_success": avg("Success"),
            "avg_recovery": avg("recovery%"),
            "BwF_tAP25": bwf,
        }

    def run(self) -> Dict:
        results = {"tasks": [], "method": self.method}
        for j in range(self.stream.num_tasks):
            train_stats = self.train_task(j)
            eval_stats = self.evaluate(j)
            log.info("vq task %d eval: tAP25=%.3f stAP25=%.3f succ=%.1f",
                     j, eval_stats["avg_tAP25"], eval_stats["avg_stAP25"],
                     eval_stats["avg_success"])
            save_checkpoint(
                os.path.join(self.workdir, f"vq_task_{j:03d}.ckpt"),
                {"params": self.params_numpy(), "task": j},
                arrays_format=self.ckpt_format,
            )
            results["tasks"].append(
                {"task": j, "train": train_stats, "eval": eval_stats}
            )
        results["final"] = results["tasks"][-1]["eval"]
        return results


def build_vq_submission(runner: VQEpisodeRunner, annotations: dict) -> dict:
    """Official ego4d_vq2d_challenge prediction file.

    Walks the raw Ego4D annotation structure videos -> clips ->
    annotations -> query_sets like the reference's format_predictions
    (VQ/inference_results.py:88-115), predicts a response track for every
    query the runner's stream knows, and emits bboxes converted back to
    ORIGINAL-resolution pixel coordinates (denormalize_track_box; the
    reference's process_bbox_prediction,
    VQ/evaluation/task_inference_predict.py:236-269). Unknown or invalid
    queries get the reference's empty entry {"bboxes": [], "score": 0.0}.
    """
    from vilco_tpu_torch.data.vq_frames import denormalize_track_box

    by_key = {}
    for i in range(runner.stream.num_tasks):
        for s in runner.stream.val_videos_task(i):
            if s.get("annotation_uid") is not None:
                by_key[(s["annotation_uid"], s.get("query_set"))] = s
    fs = float(runner.frame_size)
    results = {"videos": []}
    for v in annotations.get("videos", []):
        vp = {"video_uid": v.get("video_uid"), "clips": []}
        for c in v.get("clips", []):
            cp = {"clip_uid": c.get("clip_uid"), "predictions": []}
            for a in c.get("annotations", []):
                auid = a.get("annotation_uid")
                apred = {"query_sets": {}, "annotation_uid": auid}
                for qid in a.get("query_sets", {}):
                    s = by_key.get((auid, qid))
                    if s is None:
                        apred["query_sets"][qid] = {"bboxes": [],
                                                    "score": 0.0}
                        continue
                    rt = runner.predict_track(s)
                    oh, ow = s["original_hw"]
                    bbs = []
                    for b in rt.bboxes:
                        x1, y1, x2, y2 = denormalize_track_box(
                            [b.x1 / fs, b.y1 / fs, b.x2 / fs, b.y2 / fs],
                            oh, ow,
                        )
                        bbs.append({"fno": int(b.fno),
                                    "x1": int(x1), "x2": int(x2),
                                    "y1": int(y1), "y2": int(y2)})
                    apred["query_sets"][qid] = {
                        "bboxes": bbs,
                        "score": (float(rt.score)
                                  if rt.score is not None else 0.0),
                    }
                cp["predictions"].append(apred)
            vp["clips"].append(cp)
        results["videos"].append(vp)
    return {
        "version": annotations.get("version", "1.0"),
        "challenge": "ego4d_vq2d_challenge",
        "results": results,
    }
