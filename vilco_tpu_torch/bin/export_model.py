"""Serving export (vilco_tpu/bin/export_model.py): the model's forward as a
`torch.export` program, saved as a `.pt2` file that a serving process
loads and calls without the model code.

  # export the tiny MQ forward (weights drawn from seed 0)
  python -m vilco_tpu_torch.bin.export_model --out model.pt2 --tiny

  # from a config and a checkpoint (either package's)
  python -m vilco_tpu_torch.bin.export_model --out model.pt2 \\
      --config config.json --ckpt runs/x/task_004.ckpt

  # the VQ window forward of a VQ episode's workdir
  python -m vilco_tpu_torch.bin.export_model --out vq.pt2 --task vq \\
      --workdir runs/vq

`load_exported(path)` loads it back as a callable module. JAX's
`--platforms` is `--device` here: the program is traced on that device
(the card unless the caller asks for the CPU; no card raises) and runs
there.

The program holds plain math and no custom kernel: the export traces the
model inside `kernels.plain_math()`, under which every kernel wrapper
computes its plain version, on the card too. That is JAX's choice, which
exports with `fused_attention=False, fused_conv=False,
attention_impl="xla", fused_xl=False` (vilco_tpu/bin/export_model.py:
35-41; Pallas calls do not serialize across targets), and torch.export
cannot trace the kernels' ctypes calls either. Shapes are static, as
JAX's: B, T, C from the config (the text inputs too with
`dataset.use_text`), the VQ window's frames and size from the matcher.
Outputs are JAX's: MQ/NLQ {cls_logits, offsets}, VQ {bbox, prob}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import torch
from torch import nn

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.kernels import plain_math


class PointForward(nn.Module):
    """`model(feats, mask[, text, text_mask])` at `dtype` ->
    {cls_logits, offsets}."""

    def __init__(self, model, dtype: torch.dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, feats, mask, text=None, text_mask=None):
        out = self.model(feats, mask, text=text, text_mask=text_mask,
                         compute_dtype=self.dtype)
        return {"cls_logits": out["cls_logits"], "offsets": out["offsets"]}


class VQForward(nn.Module):
    """`matcher(clip, query)` -> {bbox (B, T, N, 4) normalized xyxy, prob
    (B, T, N) logits}."""

    def __init__(self, matcher):
        super().__init__()
        self.matcher = matcher

    def forward(self, clip, query):
        out = self.matcher(clip, query)
        return {"bbox": out["bbox"], "prob": out["prob"]}


def _export(module: nn.Module, args) -> torch.export.ExportedProgram:
    module.eval()
    with torch.no_grad(), plain_math():
        return torch.export.export(module, tuple(args), strict=False)


def export_forward(cfg, model, device="cuda") -> torch.export.ExportedProgram:
    """The MQ/NLQ `model` (a PointTransformer of `cfg`) as a program of
    feats (B, T, C) f32 and mask (B, T) bool, plus text (B, L, n_txt_in)
    f32 and text_mask (B, L) bool with `cfg.dataset.use_text`, at
    `cfg.model.compute_dtype`. The program closes over the weights."""
    dev = device_of(device)
    m = cfg.model
    B, T, C = cfg.batch_size, m.max_seq_len, m.input_dim
    args = [torch.zeros((B, T, C), device=dev),
            torch.ones((B, T), dtype=torch.bool, device=dev)]
    if cfg.dataset.use_text:
        L = cfg.max_text_len
        args += [torch.zeros((B, L, m.n_txt_in), device=dev),
                 torch.ones((B, L), dtype=torch.bool, device=dev)]
    return _export(PointForward(model.to(dev), getattr(
        torch, m.compute_dtype)), args)


def export_vq_forward(matcher, batch: int = 1, device="cuda"
                      ) -> torch.export.ExportedProgram:
    """The VQ tracker's window forward: clip (batch, T, S, S, 3) and query
    (batch, S, S, 3) f32 -> {bbox, prob}, the unit that
    tasks/vq.py::predict_track dispatches, at the matcher's compute
    dtype."""
    dev = device_of(device)
    T, S = matcher.cfg.num_frames, matcher.cfg.clip_size
    args = [torch.zeros((batch, T, S, S, 3), device=dev),
            torch.zeros((batch, S, S, 3), device=dev)]
    return _export(VQForward(matcher.to(dev)), args)


def load_exported(path: str) -> nn.Module:
    """A saved program as a callable module (its weights take no
    gradient)."""
    return torch.export.load(path).module().requires_grad_(False)


def _load_params(model: nn.Module, ckpt: str) -> None:
    """A checkpoint's params (either package's) into every leaf of the
    model's state_dict."""
    from vilco_tpu_torch.core.checkpoint import load_checkpoint, params_of

    model.load_state_dict(params_of(load_checkpoint(ckpt)), strict=True)


def _save(ep, args, t0: float) -> None:
    t1 = time.perf_counter()
    torch.export.save(ep, args.out)
    ins = [tuple(s.shape) for s in ep.example_inputs[0]]
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"device={args.device}, in={ins}; export "
          f"{t1 - t0:.2f} s, save {time.perf_counter() - t1:.2f} s")


def _main_vq(args):
    """--task vq: the ClipMatcher window forward. Its geometry comes from
    the run's vq_config.json (--workdir), as bin/vq_infer.py reads it, or
    the CI toy shape; its weights from --ckpt, else the workdir's latest
    vq_task_*.ckpt, else drawn from seed 0."""
    from vilco_tpu_torch.core.config import VQConfig
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.tasks.vq import COMPUTE_DTYPE, toy_vq_config

    cfg = toy_vq_config()
    if args.workdir:
        man_path = os.path.join(args.workdir, "vq_config.json")
        if os.path.exists(man_path):
            with open(man_path) as f:
                man = json.load(f)
            cfg = (VQConfig.from_dict(man["model_cfg"]) if man.get(
                "model_cfg") else toy_vq_config(man["window"],
                                                man["frame_size"]))
    matcher = ClipMatcher(cfg, device="cpu", compute_dtype=COMPUTE_DTYPE)
    ckpt = args.ckpt
    if not ckpt and args.workdir:
        ckpts = sorted(glob.glob(os.path.join(args.workdir,
                                              "vq_task_*.ckpt")))
        ckpt = ckpts[-1] if ckpts else None
    if ckpt:
        _load_params(matcher, ckpt)
    t0 = time.perf_counter()
    _save(export_vq_forward(matcher, device=args.device), args, t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint from train_cl (uses its params)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny synthetic config (smoke)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    p.add_argument("--task", choices=["mq", "nlq", "vq"], default="mq",
                   help="vq exports the ClipMatcher window forward "
                        "(nlq is the mq path with use_text configs)")
    p.add_argument("--workdir", default=None,
                   help="with --task vq: restore geometry from the run's "
                        "vq_config.json and its latest vq_task_*.ckpt")
    args = p.parse_args(argv)
    device_of(args.device)
    if args.task == "vq":
        return _main_vq(args)

    from vilco_tpu_torch.core.config import load_config
    from vilco_tpu_torch.data.synthetic import tiny_config
    from vilco_tpu_torch.models.point_transformer import PointTransformer

    cfg = load_config(args.config) if args.config else tiny_config()
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    if args.ckpt:
        _load_params(model, args.ckpt)
    t0 = time.perf_counter()
    _save(export_forward(cfg, model, device=args.device), args, t0)


if __name__ == "__main__":
    main()
