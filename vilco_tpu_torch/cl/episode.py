"""The query-incremental continual-learning episode
(vilco_tpu/cl/episode.py::EpisodeRunner) on the port's model, train and
eval steps, decode and soft-NMS:

  for task j:
    merge rehearsal memory into the task's train set
    (iCaRL/BiC) snapshot pre-task logits for distillation
    train epochs (a fresh FusedAdamW and schedule per task), keeping the
      best epoch's parameters when opt.track_best
    (BiC) stage 2: the task's bias pair on its held-out 10%
    evaluate every seen task cumulatively: ANET mAP, R@k, BwF
    update rehearsal memory (random exemplars, per-class quota)
    re-draw the head rows of the classes not yet seen
    (EWC/MAS) estimate parameter importance on the finished task
    checkpoint {params, memory bank, cl-state} as task_{j:03d}.ckpt

The methods keep the JAX names and order. The parameters live in the
model, and every train_task's FusedAdamW keeps them as views of its flat
buffer (train/optim.py::flat_buffers): restoring a best epoch, a resume,
`--init-from` and the head reset copy values into them, never rebind
them. The loss normaliser is carried across tasks and through the
importance passes and is not checkpointed; the narration-SSL bank is kept
across tasks (the step advances it in place). config.json is JAX's
`Config.to_dict()` layout, so each package's evaluate CLI reads the other's
workdir. The runner runs on `device` (the card unless the caller asks for
the CPU): no card raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vilco_tpu_torch.cl.bic import (
    BicState,
    make_bias_stage2_step,
    split_train_val,
)
from vilco_tpu_torch.cl.icarl import adjust_eval_outputs
from vilco_tpu_torch.cl.regularizers import RegPenalty, estimate_importance
from vilco_tpu_torch.cl.stream import RehearsalMemory, TaskStream, _dedup_by_id
from vilco_tpu_torch.core.checkpoint import (
    load_checkpoint,
    params_of,
    reg_tasks_of,
    save_checkpoint,
)
from vilco_tpu_torch.core.config import Config
from vilco_tpu_torch.core.logging import MetricsLogger
from vilco_tpu_torch.data.pipeline import BatchIterator, ClipDataset
from vilco_tpu_torch.evals.anet_map import ANETDetection, cumulative_cl_gt
from vilco_tpu_torch.evals.retrieval import (
    BwfTracker,
    moment_retrieval_recall,
    retrieval_gt_from_task,
)
from vilco_tpu_torch.models.point_transformer import (
    CLS_PRIOR_BIAS,
    GAUSSIAN_INIT,
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.ops.decode import decode_and_nms_batch
from vilco_tpu_torch.train.engine import (
    CLBatchExtras,
    TrainState,
    init_adapter_ema,
    init_memory_bank,
    make_eval_step,
    make_train_step,
    snapshot_targets,
)
from vilco_tpu_torch.train.optim import FusedAdamW

log = logging.getLogger("vilco.episode")


def device_of(device) -> torch.device:
    """`device` as a torch.device; the card raises when there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the episode runs on the card, and there is none "
                           "(pass device='cpu' to run on the CPU)")
    return dev


class EpisodeRunner:
    def __init__(
        self,
        cfg: Config,
        stream: TaskStream,
        feature_source: Callable,
        workdir: str = "/tmp/vilco_run",
        text_source: Optional[Callable] = None,
        narration_source: Optional[Callable] = None,
        shard: tuple = (0, 1),
        persist_config: bool = True,
        device="cuda",
    ):
        self.cfg = cfg
        self.stream = stream
        self.src = feature_source
        self.text_source = text_source
        self.narration_source = narration_source
        self.workdir = workdir
        # (process_index, process_count): the train data's shard
        self.shard = shard
        self.device = device_of(device)
        os.makedirs(workdir, exist_ok=True)
        if persist_config:
            # the resolved config, so bin/evaluate.py (of either package)
            # rebuilds the model and stream from the workdir alone
            with open(os.path.join(workdir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=2)

        self.compute_dtype = getattr(torch, cfg.model.compute_dtype)
        self.points = torch.from_numpy(generate_points(
            level_lengths(cfg.model), cfg.model.fpn_strides,
            cfg.model.regression_range)).float().to(self.device)
        self.num_classes = cfg.model.num_classes
        self.method = (cfg.cl_cfg.name or "naive").lower()
        self.bic = (BicState(self.num_classes, stream.num_tasks)
                    if self.method == "bic" else None)
        self.memory = RehearsalMemory(seed=cfg.init_rand_seed)
        self.reg_list: List = []
        # carried across tasks and through the EWC/MAS estimation passes;
        # a best-epoch restore does not rewind it
        self.loss_normalizer = float(cfg.train_cfg.init_loss_norm)
        self.bwf_recall = BwfTracker()
        self.bwf_map = BwfTracker()
        self._setup_eval()
        self.memory_bank, self.memory_ptr = None, torch.zeros(
            (), dtype=torch.int64, device=self.device)
        if cfg.cl_cfg.narration_ssl and cfg.cl_cfg.memory_size > 0:
            self.memory_bank, self.memory_ptr = init_memory_bank(
                cfg, self.device)
        self.model = self._init_params()
        self._adapter_ema = None
        self.eval_step = make_eval_step(
            self.model, ensemble_adapters=cfg.cl_cfg.use_adapt,
            compute_dtype=self.compute_dtype)
        self.metrics_log = MetricsLogger(
            os.path.join(workdir, "metrics.jsonl"))
        self.ext_cls_scores = None
        if cfg.test_cfg.ext_score_file:
            from vilco_tpu_torch.ops.ext_scores import load_cls_scores

            self.ext_cls_scores = load_cls_scores(cfg.test_cfg.ext_score_file)

    # ------------------------------------------------------------------
    def _setup_eval(self):
        """Per-task cumulative GT (MQ)."""
        self.cl_gt = cumulative_cl_gt(self.stream.val_tasks)

    def _init_params(self) -> PointTransformer:
        """The model, its parameters drawn from a CPU generator seeded at
        init_rand_seed (the port's own draw: JAX's cannot be reproduced;
        `set_params` of models/convert.py::params_from_jax loads JAX's)."""
        gen = torch.Generator().manual_seed(self.cfg.init_rand_seed)
        return PointTransformer(self.cfg.model, generator=gen,
                                device=self.device, cl=self.cfg.cl_cfg)

    @torch.no_grad()
    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy {name: tensor} into every parameter of the model, in place;
        the names must be the model's, and every one given."""
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

    def _make_dataset(self, videos, is_training):
        return ClipDataset(
            videos, self.cfg, self.src,
            is_training=is_training,
            text_source=self.text_source,
            narration_source=self.narration_source,
        )

    def _eval_loader(self, videos) -> BatchIterator:
        return BatchIterator(self._make_dataset(videos, is_training=False),
                             self.cfg, self.cfg.loader.batch_size,
                             is_training=False,
                             num_workers=self.cfg.loader.num_workers,
                             prefetch=self.cfg.loader.prefetch)

    def _class_mask(self, j: int) -> torch.Tensor:
        mask = torch.zeros((self.num_classes,), dtype=torch.bool)
        mask[self.stream.classes_upto(j)] = True
        return mask.to(self.device)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k != "video_idx"}

    # ------------------------------------------------------------------
    def snapshot_logits(self, videos, n_known: int = 0
                        ) -> Dict[str, torch.Tensor]:
        """Pre-task distillation targets per video, probabilities as the
        reference snapshots them (train/engine.py::snapshot_targets): the
        single forward, no adapter ensemble, as JAX's."""
        out = {}
        for batch, meta in self._eval_loader(videos):
            res = self.eval_step(self._to_device(batch))
            probs = snapshot_targets(res["cls_logits"], self.method, n_known)
            for i, vid in enumerate(meta["video_id"]):
                if not meta["pad"][i]:
                    out[vid] = probs[i]
        return out

    # ------------------------------------------------------------------
    def _fresh_head_rows(self, j: int, shape) -> torch.Tensor:
        """A he-uniform draw of the cls conv's weight (C, Cin, K) for the
        head reset at task j: U(-sqrt(6 / fan_in), sqrt(6 / fan_in)), fan_in
        = Cin x K, from a CPU generator seeded by (init_rand_seed, j) (JAX
        draws from fold_in(PRNGKey(seed), 1000 + j), which torch cannot
        reproduce)."""
        gen = torch.Generator().manual_seed(
            (self.cfg.init_rand_seed << 16) + 1000 + j)
        lim = math.sqrt(6.0 / (shape[1] * shape[2]))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim

    @torch.no_grad()
    def _reset_unseen_classes(self, j: int):
        """The reference's augment_classification for the head allocated at
        its largest: the rows of the classes not seen by task j get a fresh
        he-uniform draw (`_fresh_head_rows`), the prior bias, and the
        per-class Gaussians their first values, in place (vilco_tpu/cl/
        episode.py:301: without it the unseen rows would drift under AdamW's
        decoupled weight decay)."""
        if self.cfg.model.variant == "nlq":
            return
        seen = torch.zeros((self.num_classes,), dtype=torch.bool)
        seen[self.stream.classes_upto(j)] = True
        if bool(seen.all()):
            return
        um = (~seen).to(self.device)
        head = self.model.cls_head.cls
        fresh = self._fresh_head_rows(j, tuple(head.weight.shape))
        head.weight[um] = fresh.to(head.weight)[um]
        head.bias[um] = CLS_PRIOR_BIAS
        for name, val in GAUSSIAN_INIT:
            getattr(self.model, name)[um] = val

    def train_task(self, j: int, n_known: int):
        cfg = self.cfg
        use_memory = cfg.cl_cfg.memory_size > 0 and j > 0
        heldout = None
        if self.bic is not None:
            # BiC: 90/10 split of the current task; stage 2 trains the bias
            # pair on the held-out 10%
            self.bic.register_task(j, self.stream.task_classes(j))
            cur = self.stream.train_videos(j, None)
            tr, heldout = split_train_val(cur, 0.9, cfg.init_rand_seed + j)
            videos = _dedup_by_id(
                (self.memory.videos() if use_memory else []) + tr)
        else:
            videos = self.stream.train_videos(
                j, self.memory if use_memory else None)
        data = self._make_dataset(videos, is_training=True)
        # with accumulation the loader yields K micro-batches of clips a step
        accum = max(cfg.opt.accumulation_steps, 1)
        loader = BatchIterator(
            data, cfg, cfg.loader.batch_size * accum, is_training=True,
            seed=cfg.init_rand_seed,
            shard_id=self.shard[0], num_shards=self.shard[1],
            num_workers=cfg.loader.num_workers,
            prefetch=cfg.loader.prefetch,
        )
        steps_per_epoch = max(len(loader), 1)
        use_distill = self.method in ("icarl", "bic") and n_known > 0
        use_prompt = cfg.cl_cfg.prompt_pool
        use_ssl = cfg.cl_cfg.narration_ssl and self.memory_bank is not None
        use_reg = self.method in ("ewc", "mas") and len(self.reg_list) > 0

        prev_logits_map = (self.snapshot_logits(videos, n_known=n_known)
                           if use_distill else None)
        # a fresh optimizer and schedule: the parameters become views of
        # its flat buffer, their values kept
        opt = FusedAdamW(self.model, steps_per_epoch, cfg.opt)
        step = make_train_step(
            self.points, cfg.train_cfg, compute_dtype=self.compute_dtype,
            cl_cfg=dataclasses.replace(cfg.cl_cfg, name=self.method),
            n_known=n_known, accumulation_steps=accum)
        state = TrainState(
            model=self.model, opt=opt,
            loss_normalizer=torch.tensor(self.loss_normalizer,
                                         dtype=torch.float32,
                                         device=self.device),
            generator=torch.Generator(device=self.device).manual_seed(
                cfg.init_rand_seed + j),
            adapter_ema=(init_adapter_ema(self.model)
                         if cfg.cl_cfg.use_adapt else None))
        penalty = (RegPenalty.for_optimizer(self.reg_list, opt,
                                            cfg.cl_cfg.reg_lambda)
                   if use_reg else None)

        class_mask = self._class_mask(j)
        prompt_arange = None
        if use_prompt:
            start, end = j * cfg.cl_cfg.topk, (j + 1) * cfg.cl_cfg.topk
            if end <= cfg.cl_cfg.pool_size:
                prompt_arange = torch.arange(start, end, device=self.device)
        bias = {}
        if self.bic is not None and n_known > 0:
            a, b = self.bic.per_class(j - 1)
            bias = {"bias_alpha": torch.from_numpy(a).to(self.device),
                    "bias_beta": torch.from_numpy(b).to(self.device)}
        zeros = torch.zeros((self.points.shape[0], self.num_classes),
                            device=self.device)

        t0 = time.time()
        n_steps = 0
        last_metrics = {}
        best_score, best_params = -np.inf, None
        # the reference trains epochs + warmup_epochs a task and evaluates
        # every epoch from int(total x eval_start_ratio) on, keeping the
        # FIRST epoch with the best score (strict >)
        total_epochs = cfg.opt.total_epochs
        eval_start = int(total_epochs * cfg.opt.eval_start_ratio + 1e-9)
        for epoch in range(total_epochs):
            loader.set_epoch(epoch)
            for batch, meta in loader:
                batch = self._to_device(batch)
                if prompt_arange is not None:
                    batch["prompt_mask"] = prompt_arange.expand(
                        len(meta["video_id"]), -1).contiguous()
                prev = None
                if use_distill:
                    prev = torch.stack([prev_logits_map.get(vid, zeros)
                                        for vid in meta["video_id"]])
                cl = CLBatchExtras(
                    class_mask=class_mask,
                    memory_bank=self.memory_bank if use_ssl else None,
                    memory_ptr=self.memory_ptr if use_ssl else None,
                    prev_logits=prev, penalty=penalty, **bias)
                metrics = step(state, batch, cl)
                if use_ssl:
                    # the step replaces the bank and the pointer
                    self.memory_bank, self.memory_ptr = (cl.memory_bank,
                                                         cl.memory_ptr)
                n_steps += 1
            last_metrics = {k: float(v) for k, v in metrics.items()}
            log.info("task %d epoch %d: %s", j, epoch,
                     {k: round(v, 4) for k, v in last_metrics.items()})
            self.metrics_log.log("train_epoch", step=state.step, task=j,
                                 epoch=epoch, **last_metrics)
            if cfg.opt.track_best and epoch >= eval_start:
                self._adapter_ema = state.adapter_ema
                score = self.evaluate(j, update_bwf=False)[
                    cfg.opt.best_metric]
                if score > best_score:
                    best_score = score
                    best_params = {n: p.detach().clone() for n, p in
                                   self.model.named_parameters()}
                    log.info("task %d epoch %d: new best %s=%.4f", j, epoch,
                             cfg.opt.best_metric, score)
        wall = time.time() - t0
        self._adapter_ema = state.adapter_ema
        # the end-of-training normaliser goes on, also when an earlier best
        # epoch is restored
        self.loss_normalizer = float(state.loss_normalizer)
        if best_params is not None:
            # ALWAYS restore the tracked best (the reference reloads
            # best_task_XXX.pth.tar before final_validate): on ties the
            # earlier epoch's weights
            self.set_params(best_params)
            log.info("task %d: restored best epoch (%s=%.4f)", j,
                     cfg.opt.best_metric, best_score)

        if self.bic is not None and heldout:
            self._bic_stage2(j, heldout, class_mask, state.loss_normalizer)
        return {
            "steps": n_steps,
            "wall_s": wall,
            "clips_per_s": (n_steps * cfg.loader.batch_size * accum
                            / max(wall, 1e-9)),
            "last_metrics": last_metrics,
            "loader": loader,
        }

    # ------------------------------------------------------------------
    def _bic_stage2(self, j, heldout, class_mask, loss_norm,
                    epochs: int = 2):
        """Stage 2: train only (alpha_j, beta_j) on the held-out split."""
        cfg = self.cfg
        step2, init2 = make_bias_stage2_step(
            self.model, self.points, cfg.train_cfg, j, self.bic.class_task,
            compute_dtype=self.compute_dtype)
        bias = init2()
        data = self._make_dataset(heldout, is_training=True)
        loader = BatchIterator(data, cfg, cfg.loader.batch_size,
                               is_training=True, seed=cfg.init_rand_seed,
                               num_workers=cfg.loader.num_workers,
                               prefetch=cfg.loader.prefetch)
        a, b = self.bic.per_class(j)
        cl = CLBatchExtras(class_mask=class_mask,
                           bias_alpha=torch.from_numpy(a).to(self.device),
                           bias_beta=torch.from_numpy(b).to(self.device))
        for ep in range(epochs):
            loader.set_epoch(ep)
            for batch, _ in loader:
                bias, _ = step2(bias, self._to_device(batch), cl, loss_norm)
        self.bic.alphas[j] = float(bias["alpha"])
        self.bic.betas[j] = float(bias["beta"])
        log.info("bic stage2 task %d: alpha=%.4f beta=%.4f",
                 j, self.bic.alphas[j], self.bic.betas[j])

    def _decode_batch(self, out, class_mask):
        t = self.cfg.test_cfg
        return decode_and_nms_batch(
            self.points, out["cls_logits"], out["offsets"], out["fpn_mask"],
            class_mask,
            num_classes=self.num_classes,
            pre_nms_topk=t.pre_nms_topk,
            pre_nms_thresh=t.pre_nms_thresh,
            duration_thresh=t.duration_thresh,
            max_seg_num=t.max_seg_num,
            min_score=t.min_score,
            nms_sigma=t.nms_sigma,
            voting_thresh=t.voting_thresh,
        )

    def _collect_fpn_feats(self, videos) -> List[torch.Tensor]:
        """Per-level (n_videos, T_l, D) features of `videos` for the
        exemplar means (the live adapters' forward)."""
        levels = None
        for batch, meta in self._eval_loader(videos):
            out = self.eval_step(self._to_device(batch), self._adapter_ema)
            keep = [i for i, p in enumerate(meta["pad"]) if not p]
            if levels is None:
                levels = [[] for _ in out["fpn_feats"]]
            for li, f in enumerate(out["fpn_feats"]):
                levels[li].append(f[keep])
        return [torch.cat(fs) for fs in levels or []]

    def _refresh_exemplar_means(self):
        """iCaRL's exemplar means from the rehearsal memory."""
        from vilco_tpu_torch.cl.icarl import compute_exemplar_means

        self._icarl_means, self._icarl_valid = compute_exemplar_means(
            self._collect_fpn_feats, self.memory.data, self.num_classes)

    def predict_videos(self, videos, class_mask) -> Dict[str, dict]:
        """Eval forward + decode over videos; segments in seconds."""
        icarl_means = getattr(self, "_icarl_means", None)
        use_icarl_filter = self.method == "icarl" and icarl_means
        bias = None
        if self.bic is not None and self.bic.num_tasks_seen > 0:
            a, b = self.bic.per_class(self.bic.num_tasks_seen - 1)
            bias = (torch.from_numpy(a).to(self.device),
                    torch.from_numpy(b).to(self.device))
        preds = {}
        for batch, meta in self._eval_loader(videos):
            out = self.eval_step(self._to_device(batch), self._adapter_ema)
            out = adjust_eval_outputs(
                out, bias,
                icarl_means if use_icarl_filter else None,
                self._icarl_valid if use_icarl_filter else None)
            det = self._decode_batch(out, class_mask)
            segs = det.segs.cpu().numpy()
            scores = det.scores.cpu().numpy()
            labels = det.labels.cpu().numpy()
            valid = det.valid.cpu().numpy()
            for i, vid in enumerate(meta["video_id"]):
                if meta["pad"][i]:
                    continue
                stride = meta["feat_stride"][i]
                nframes = meta["feat_num_frames"][i]
                fps = meta["fps"][i]
                dur = meta["duration"][i]
                sel = valid[i]
                s = (segs[i][sel] * stride + 0.5 * nframes) / fps
                s = np.clip(s, 0.0, dur)
                preds[vid] = {
                    "segments": s,
                    "scores": scores[i][sel],
                    "labels": labels[i][sel],
                }
        return preds

    def predict_submission(self, j: int) -> dict:
        """Official Ego4D-MQ submission dump: {"version", "external_data",
        "results": {video_id: [{"segment": [s, e], "score", "label"}]}}
        with label names through the task's activity index."""
        if self.method == "icarl" and self.memory.n_known > 0:
            self._refresh_exemplar_means()
        class_mask = self._class_mask(j)
        preds = self.predict_videos(self.stream.val_videos_upto(j),
                                    class_mask)
        inv = {v: k for k, v in self.cl_gt[j]["activity_index"].items()}
        results = {}
        for vid, p in preds.items():
            results[vid] = [
                {"segment": [float(s[0]), float(s[1])],
                 "score": float(sc),
                 "label": str(inv.get(int(lb), int(lb)))}
                for s, sc, lb in zip(p["segments"], p["scores"],
                                     p["labels"])
            ]
        return {"version": "1.0", "external_data": "", "results": results}

    def evaluate(self, j: int, update_bwf: bool = True) -> Dict:
        """Cumulative per-task eval + BwF: per task i <= j, ANET mAP against
        the cumulative GT through task j, R@k against task i's own GT,
        averaged with weights the cumulative class count through task i."""
        if self.method == "icarl" and self.memory.n_known > 0:
            self._refresh_exemplar_means()
        class_mask = self._class_mask(j)
        gt_j = self.cl_gt[j]
        act_idx = gt_j["activity_index"]
        per_task_map, per_task_r1 = {}, {}
        per_task = []
        weights = {}
        for i in range(j + 1):
            videos = self.stream.val_videos_upto(i)
            preds = self.predict_videos(videos, class_mask)
            if self.ext_cls_scores:
                from vilco_tpu_torch.ops.ext_scores import (
                    fuse_external_scores,
                )

                preds = fuse_external_scores(preds, self.ext_cls_scores)
            rec = {"video-id": [], "t-start": [], "t-end": [], "label": [],
                   "score": []}
            for vid, p in preds.items():
                for s, sc, lb in zip(p["segments"], p["scores"], p["labels"]):
                    if int(lb) not in act_idx:
                        continue
                    rec["video-id"].append(vid)
                    rec["t-start"].append(float(s[0]))
                    rec["t-end"].append(float(s[1]))
                    rec["label"].append(act_idx[int(lb)])
                    rec["score"].append(float(sc))
            evaluator = ANETDetection(
                {k: gt_j[k] for k in
                 ("video-id", "t-start", "t-end", "label")})
            mAP, avg_map = evaluator.evaluate(rec)

            task_key = self.stream.task_ids[i]
            gt_ret = retrieval_gt_from_task(self.stream.val_tasks[task_key])
            inv = {v: k for k, v in
                   self.stream.val_tasks[task_key]["label_dict"].items()}
            pred_ret = {}
            for vid, p in preds.items():
                by_class = {}
                for s, sc, lb in zip(p["segments"], p["scores"],
                                     p["labels"]):
                    name = inv.get(int(lb))
                    if name is None:
                        continue
                    by_class.setdefault(name, []).append(
                        [float(s[0]), float(s[1]), float(sc)])
                pred_ret[vid] = by_class
            rec_matrix = moment_retrieval_recall(gt_ret, pred_ret)
            weights[i] = len(self.stream.classes_upto(i))
            per_task_map[i] = avg_map
            per_task_r1[i] = float(rec_matrix[4, 0])  # R@1 tIoU 0.5
            per_task.append({
                "task": i,
                "avg_mAP": avg_map,
                "mAP": mAP.tolist(),
                "recall": rec_matrix.tolist(),
                "R1@0.3": float(rec_matrix[2, 0]),
                "R5@0.3": float(rec_matrix[2, 1]),
                "R1@0.5": float(rec_matrix[4, 0]),
                "R5@0.5": float(rec_matrix[4, 1]),
            })
        if update_bwf:
            bwf_r = self.bwf_recall.update(j, per_task_r1, weights)
            bwf_m = self.bwf_map.update(j, per_task_map, weights)
        else:
            bwf_r, bwf_m = 0.0, 0.0
        avg = lambda key: float(np.average(
            [t[key] for t in per_task],
            weights=[weights[t["task"]] for t in per_task]))
        return {
            "per_task": per_task,
            "avg_mAP": avg("avg_mAP"),
            "avg_R1@0.3": avg("R1@0.3"),
            "avg_R5@0.3": avg("R5@0.3"),
            "avg_R1@0.5": avg("R1@0.5"),
            "avg_R5@0.5": avg("R5@0.5"),
            "BwF_R1@0.5": bwf_r,
            "BwF_mAP": bwf_m,
        }

    # ------------------------------------------------------------------
    def checkpoint_tree(self, j: int, n_known: int) -> dict:
        """task_{j:03d}.ckpt's content, with JAX's keys; the params as the
        port's {name: f32 array}, the EWC/MAS tasks by the same names."""
        numpy = lambda t: {n: v.detach().float().cpu().numpy()
                           for n, v in t.items()}
        return {
            "params": self.params_numpy(),
            "task": j,
            "n_known": n_known,
            "memory_bank": (None if self.memory_bank is None
                            else self.memory_bank.cpu().numpy()),
            "memory_ptr": int(self.memory_ptr),
            "reg_list": [(numpy(imp), numpy(opt))
                         for imp, opt in self.reg_list],
            "bwf_recall": self.bwf_recall.recorded,
            "bwf_map": self.bwf_map.recorded,
            "bic": ({"alphas": self.bic.alphas, "betas": self.bic.betas,
                     "class_task": self.bic.class_task,
                     "num_tasks_seen": self.bic.num_tasks_seen}
                    if self.bic is not None else None),
        }

    def _try_resume(self):
        """Resume from the latest task checkpoint in workdir (a JAX runner's
        too: its Flax trees go through models/convert.py)."""
        ckpts = sorted(glob.glob(os.path.join(self.workdir, "task_*.ckpt")))
        if not ckpts:
            return -1, 0
        tree = load_checkpoint(ckpts[-1])
        self.set_params(params_of(tree))
        if tree.get("memory_bank") is not None:
            self.memory_bank = torch.as_tensor(
                np.asarray(tree["memory_bank"]), dtype=torch.float32,
                device=self.device)
            self.memory_ptr = torch.tensor(int(tree.get("memory_ptr", 0)),
                                           dtype=torch.int64,
                                           device=self.device)
        if tree.get("reg_list"):
            self.reg_list = [
                tuple({n: v.to(self.device) for n, v in t.items()}
                      for t in task)
                for task in reg_tasks_of(tree["reg_list"])]
        if tree.get("bwf_recall"):
            self.bwf_recall.recorded = tree["bwf_recall"]
            self.bwf_map.recorded = tree["bwf_map"]
        if self.bic is not None and tree.get("bic"):
            self.bic.alphas = np.asarray(tree["bic"]["alphas"], np.float32)
            self.bic.betas = np.asarray(tree["bic"]["betas"], np.float32)
            self.bic.class_task = np.asarray(tree["bic"]["class_task"],
                                             np.int64)
            self.bic.num_tasks_seen = int(tree["bic"]["num_tasks_seen"])
        mem_path = os.path.join(self.workdir, self.cfg.cl_cfg.path_memory)
        if os.path.exists(mem_path):
            self.memory.load(mem_path)
        log.info("resumed from %s (task %d)", ckpts[-1], tree["task"])
        return int(tree["task"]), int(tree.get("n_known", 0))

    def run(self, resume: bool = False) -> Dict:
        cfg = self.cfg
        results = {"tasks": [], "method": self.method}
        n_known = 0
        done_task = -1
        if resume:
            done_task, n_known = self._try_resume()
        for j in range(done_task + 1, self.stream.num_tasks):
            log.info("=== task %d/%d (method=%s, n_known=%d) ===",
                     j + 1, self.stream.num_tasks, self.method, n_known)
            train_stats = self.train_task(j, n_known)
            eval_stats = self.evaluate(j)
            log.info("task %d eval: avg_mAP=%.4f R1@0.5=%.4f BwF=%.4f",
                     j, eval_stats["avg_mAP"], eval_stats["avg_R1@0.5"],
                     eval_stats["BwF_R1@0.5"])

            n_seen = len(self.stream.classes_upto(j))
            if cfg.cl_cfg.memory_size > 0:
                m = self.stream.memory_quota(cfg.cl_cfg.memory_size, n_seen)
                self.memory.add_task(self.stream.train_class_videos(j), m)
                n_known = self.memory.n_known
                self.memory.save(
                    os.path.join(self.workdir, cfg.cl_cfg.path_memory))

            if j < self.stream.num_tasks - 1:
                # the reference's augment_classification point: before the
                # EWC/MAS importance, which sees the fresh rows
                self._reset_unseen_classes(j + 1)

            loader = train_stats.pop("loader")
            if self.method in ("ewc", "mas") and j < self.stream.num_tasks - 1:
                # importance after the head grows: the loss at estimation
                # spans the next task's classes too (mask through j + 1)
                loader.set_epoch(0)
                cl = CLBatchExtras(class_mask=self._class_mask(j + 1))
                batches = (self._to_device(b) for b, _ in loader)
                imp, optpar, new_norm = estimate_importance(
                    self.model, self.points, batches, cl,
                    torch.tensor(self.loss_normalizer, dtype=torch.float32,
                                 device=self.device),
                    cfg.train_cfg, mode=self.method,
                    compute_dtype=self.compute_dtype)
                self.loss_normalizer = float(new_norm)
                self.reg_list.append((imp, optpar))

            save_checkpoint(
                os.path.join(self.workdir, f"task_{j:03d}.ckpt"),
                self.checkpoint_tree(j, n_known),
                arrays_format=cfg.ckpt_format)
            self.metrics_log.log(
                "task_eval", step=j, task=j,
                avg_mAP=eval_stats.get("avg_mAP", 0.0),
                R1_05=eval_stats.get("avg_R1@0.5", 0.0),
                bwf=eval_stats.get("BwF_R1@0.5", 0.0),
                clips_per_s=train_stats.get("clips_per_s", 0.0),
            )
            results["tasks"].append({"task": j, "train": train_stats,
                                     "eval": eval_stats})
        results["final"] = results["tasks"][-1]["eval"]
        return results
