"""Drive the PyTorch/CUDA port's MQ, NLQ and VQ serving and training paths
once on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --mq-train
    python3 chip_smoke.py --vq-train
    python3 chip_smoke.py --vq-train-parity SEED [SEED ...]
    python3 chip_smoke.py --mq-yaml
    python3 chip_smoke.py --cl-methods
    python3 chip_smoke.py --mq-episode
    python3 chip_smoke.py --nlq-episode
    python3 chip_smoke.py --vq-episode

The second form builds the kernels and runs only the MQ training phases
(7-10); the third only the VQ kernels, the VQ train-step parity and the VQ
train step (phases 16, 18 and 20); the fourth only the VQ train-step
parity (phase 18), once per seed of weights and batch; the fifth only the
phases of the MQ yaml model (10a-10e); the sixth only the CL methods'
f32 steps card against CPU (cl_parity, vq_cl_parity: below, after the
phases); the seventh only the MQ CL episode (10f); the eighth only the
NLQ CL episode (15''); the ninth only the VQ CL episode (20').

Phases, one or more lines each (any failure exits non-zero at once, no CPU
fallback):
  1. device        card name, capability (must be 9.0), nvidia-smi name and
                   power limit
  2. build         nvcc build of every kernel in vilco_tpu_torch/csrc, the
                   files side by side (seconds), registers and spills
  3. kernels       each serving (forward) kernel against its plain PyTorch
                   version at every shape the flagship serves, batch 16,
                   ragged masks plus one fully masked row, bf16 and f32
                   (TF32 off): each output's error beside its own limit,
                   median ms of kernel, plain version and library call,
                   and the bound; K2's forward also queued behind a device
                   sleep (`queued_ms`) and called twice for equal bits
  4. parity        flagship_config() at batch 1 in f32, forward on the card
                   with its kernels against the CPU with the plain versions:
                   max relative error of the head outputs, and a TF32
                   control that must read above the limit
  5. serve         batch 16 in bf16, 2 warm-up and 5 timed requests through
                   forward + decode_and_nms_batch: clips/s, ms per request,
                   peak memory, detections per clip, kernel launch counts
  6. trace         one more request with torch.profiler: forward and
                   decode+NMS each profiled alone, host ms (profiled and
                   unprofiled), device ms, idle share, ms by kernel kind
  7. train_kernels each training kernel (attention, XL and conv backward,
                   XL forward with dropout at rate 0 and 0.1, AdamW) against
                   its plain version at the shapes of the flagship's train
                   step, batch 2, bf16 and f32, plus the XL backward's
                   inverse shift at odd lengths (37, 101, 131; both dtypes
                   and rates): error, tolerance, ms, bound, library ms
                   (AdamW: torch._fused_adamw_); the attention, XL and
                   conv backwards and the XL forward called twice for
                   equal bits, the XL forward and the convs also timed
                   queued
  8. train_parity  one flagship train step at batch 1 in f32 (regularisers
                   off), the card against the CPU from the same weights and
                   batch: loss, clipped grad norm, max relative error of the
                   gradients, updated parameters and AdamW moments, and a
                   TF32 control that must read above the gradient limit;
                   the same step on the card through the plain versions
                   splits the gap into the kernels' share and the
                   libraries' (cuBLAS/cuDNN vs CPU) share; then pairs of
                   steps with the regularisers on from the same state, rng
                   and batch, reported (not checked): equal bits in every
                   updated parameter, or the first leaf that differs, by
                   default, with cudnn.deterministic, and under
                   torch.use_deterministic_algorithms too (the ops it
                   names)
  9. train         the flagship train step in bf16 with f32 masters,
                   drop-path and XL dropout on, batch 2, T=1024, on a fixed
                   batch: 2 warm-up and 10 timed steps, ms per step split
                   into forward / backward / optimizer, steps/s, clips/s,
                   peak memory, every loss, launch counts per kernel
 10. trace         one more train step profiled: device ms by kernel kind,
                   the top kernels and the idle share
 10'. cl_methods   the graft flagship's other CL methods as CL task 1 of 5
                   (n_known 22, classes 0-43), batch 2, bf16, one model
                   trained on: iCaRL (targets from the eval step's logits),
                   BiC (task 0's bias, softmax-T targets) and 3 of its
                   stage-2 steps, the naive step at accumulation 2 (ms/step,
                   every term); one batch-16 request with BiC's bias and
                   iCaRL's filter (means of 2 clips of each of 22 classes;
                   the keep mask of 2 clips against the full direct form,
                   flips counted); launches over the phase
 10a. mq_yaml_kernels  the MQ flagship as configs/mq_vilco.yaml runs it
                   (core/config.py::mq_yaml_config): K1 at the shapes it
                   adds, over the prompted text (Tk = 128 text + 80 prompt
                   tokens = 208): the text stem's self-attention and the
                   branch blocks' cross-attention (Tq 512, 64 .. 2), the
                   forward at batch 16, the backward at batch 2 (query
                   slices in dk/dv, called twice for equal bits), SDPA
                   beside; K3 at T=208 forward and backward; AdamW over its
                   560 leaves; bf16 and f32
 10b. mq_yaml_parity   phase 4 on the yaml model (the adapters' zero fc2
                   redrawn): cls_logits, offsets, reduce_sim,
                   narration_feat and video_feat, with the TF32 control
 10c. mq_yaml_serve    phase 5 through the eval step's adapter ensemble (two
                   forwards, live and EMA adapters), decode + soft-NMS at
                   the yaml's test_cfg (5000 candidates): the two forwards
                   split by CUDA events, launches a request checked against
                   the model (K1 40, K3 26, K2 2), one profiled request
 10d. mq_yaml_train_parity  phase 8 as CL task 1 (L2P with its pull,
                   narration SSL, the AL loss, the adapter EMA at decay
                   0.5), plus each loss term, the memory bank, its pointer
                   and the EMA (against its formula on each side); the
                   gradients also against the same step in f64 on the CPU,
                   the first embedding conv's weight held there
 10e. mq_yaml_train    phase 9 as CL task 1 of 5 (n_known 22, classes 0-43,
                   prompt slots 4-7), dropout 0.1: every term's values,
                   launches a step checked (K1 20 and K1-bwd 20, K3 13 and
                   K3-bwd 13, K2 1, K2-bwd 1, K4 1)
 10f. mq_episode   the MQ CL episode (cl/episode.py): the tiny yaml-method
                   episode (2 tasks) on the card against the CPU, TF32 off,
                   cudnn.deterministic on (the memory equal, the eval series
                   and BwF 1e-4, the final parameters 2e-3 a leaf); then the
                   yaml's method at its published widths through
                   bin/train_cl.main on synthetic sources, cut to 2 of 5
                   tasks, 1 train and 1 val clip a class, 1 epoch and no
                   warmup: ms/step and clips/s a task, eval ms a request
                   and its decode + soft-NMS share, the losses finite, the
                   memory at its quota after task 0, each task checkpoint
                   reloaded bit-equal (save and load seconds), the launches
                   over the run (each of K1, K1-bwd, K2, K2-bwd, K3,
                   K3-bwd, K4 at least once), bin/evaluate.main on the
                   workdir as of task 0; then one yaml step's ms with and
                   without cudnn.deterministic
 11. nlq_kernels   the NLQ flagship's kernels against their plain versions,
                   bf16 and f32: the banded attention forward and its one
                   backward launch (dq, dk, dv; against its plain passes and
                   autograd through the plain forward, queued behind a
                   device sleep), each called twice for equal bits, at
                   batch 16 and 4 for every pyramid length 2560..40, the
                   band wider than T (T=8) and an odd T, then K5's ms summed
                   over an NLQ request's and a step's 10 calls, each at its
                   own length; the dense attention
                   at D=96 as text self-attention (T=32) and video-to-text
                   cross-attention (2560 x 32), forward and backward; the
                   depthwise convs and their backward at C=384 (also timed
                   queued, the backward twice for equal bits); AdamW over
                   the dual tower's 467 leaves (bit-exact). Each output's
                   error beside its own limit, kernel, plain and library
                   ms (SDPA with the band mask) and the bound
 12. nlq_parity    nlq_flagship_config() at batch 1 in f32, the card against
                   the CPU on the head outputs, with a TF32 control
 13. nlq_train_parity  phase 8 on nlq_flagship_config(), with its EWC
                   penalty (lambda 3000) over one task whose importance is
                   the port's estimate over 2 batches, the weights 1e-3
                   from that task's; the penalty card vs CPU
 14. nlq_serve     batch 16 bf16 requests (clip features + query text):
                   forward + decode_and_nms_batch at the NLQ test_cfg,
                   clips/s, ms split, peak memory, launches, one profiled
                   request
 15. nlq_train     12 bf16 steps at batch 4 (f32 masters, drop-path 0.1,
                   label smoothing 0.1, FusedAdamW over 467 leaves): ms
                   split, losses, peak memory, launches, one profiled step
 15'. nlq_train_ewc  the same with the EWC penalty over 12 stacked tasks;
                   first the penalty alone at 1 and 12 tasks (ms, kernel
                   launches a call, bound)
 15''. nlq_episode the NLQ CL episode (tasks/nlq.py): the tiny twin (EWC
                   at lambda 3000, 2 tasks) on the card against the CPU,
                   TF32 off, cudnn.deterministic on (memory equal, eval
                   series and BwF 1e-4, parameters 2e-3 a leaf); then
                   configs/nlq_vilco.yaml's episode at its published widths
                   through bin/train_cl.main on the synthetic split, cut to
                   2 of 13 tasks, 8 train and 3 val queries a template, 1
                   epoch and no warmup: ms/step and clips/s a task (the
                   step alone, synced), eval ms a request split into the
                   forward and decode + soft-NMS, the losses finite, each
                   checkpoint reloaded bit-equal (size, save and load
                   seconds), the launches; bin/evaluate.main --task nlq
                   --submission within 1e-4 of the last eval
 16. vq_kernels    the VQ flagship's kernels against their plain versions,
                   bf16 and f32: the frame-banded attention forward (K1's
                   forward in band mode) at batch 8 and 16 and its
                   backward (delta, dk/dv and dq, K1's passes in band
                   mode) at batch 16 (30 frames of 64 tokens, 8 heads of
                   32, +-2 frames; SDPA with the (L, L) band mask as the
                   library call), and at the edges (the band wider than
                   the clip, odd fr, one frame, a frame longer than a
                   tile); the forward's out and lse against the plain
                   versions, called twice for equal bits, timed queued
                   behind a device sleep and by events, its bf16 ms
                   summed over a VQ request's and an HNM step's calls;
                   the backward against its plain
                   passes and autograd through the plain forward, called
                   twice for equal bits, timed queued behind a device
                   sleep (its three launches take longer on the host than
                   on the card), its passes' device ms by the profiler;
                   the fused MLP at a
                   request's two ViT calls (240 clip frames and 8 query
                   copies of 1025 tokens, C 768, hidden 3072) in bf16 and
                   the query call in f32 (library: two F.linear and the
                   tanh GELU; in bf16 both also split by kernel, K7's two
                   GEMMs, by the profiler); the dense attention at the ViT
                   shape (1025 tokens, 12 heads of 64: both request calls
                   in bf16, the parity's 30 frames in f32) and in the
                   query/frame decoder (1024 tokens, 4 heads of 64:
                   forward at 240 and 480 frames, backward at 480, bf16
                   and f32) beside SDPA;
                   AdamW with f32 moments over the VQ optimizer's 113
                   trainable leaves (bit-exact)
 17. vq_parity     vq_flagship_config() at batch 1, 30 frames, f32, the
                   card against the CPU on the box deltas and the logits
                   (output convs redrawn at a normal scale), with a TF32
                   control
 18. vq_train_parity  one VQ HNM step at batch 2 x 30 frames in f32, the
                   card against the CPU as phase 8, every trainable leaf's
                   gradient; the position table's held to its summation
                   scale (its gradient sums the pairs' gradients at its
                   add) with the per-pair gradient beside it
 19. vq_serve      requests of one 240-frame 448-square bf16 clip + query
                   on the card through tasks/vq.py::predict_track (8
                   windows of 30 in one chunk): 2 warm-up and 5 timed,
                   frames/s, ms split into ViT / matcher / top anchor /
                   peak finding, peak memory, launches against the model's
                   structure, one profiled request, then one request with
                   the ViT MLP on the fused kernel (K7's two GEMMs) after a
                   warm-up, and one more profiled
 20. vq_train      12 bf16 HNM steps at batch 4 (16 pairs, f32 masters,
                   head dropout 0.2, AdamW over the trainable leaves with
                   the frozen ViT outside it): ms split, every loss (finite
                   and falling), peak memory, launches (K6's backward once
                   per spatio-temporal layer a step), the backbone
                   bit-identical, one profiled step
 20'. vq_episode  the VQ CL episode (tasks/vq.py): the tiny twin (EWC,
                   augmentation on, the head's dropout 0, 2 tasks) card vs
                   CPU as 15'' (and task 0's importance 2e-3 a leaf); then
                   configs/vq_vilco.yaml's episode at its published widths
                   (frozen ViT-B/14 at 448, 30-frame windows, HNM and
                   augmentation on, batch 4, naive) through
                   bin/train_cl.main --task vq on the synthetic split, 2
                   tasks of 2 categories, 4 train and 2 val samples a
                   category, 60-frame clips, 1 epoch: ms/step and clips/s a
                   task, eval ms a request split into ViT, matcher and peak
                   finding, checkpoints reloaded bit-equal, the launches;
                   bin/vq_infer.main within 1e-4 of the last eval
 21. attn_impl_kernels  the head-major attention (K1n, forward and backward)
                   and the flash attention (K1f: K1's forward and three-pass
                   backward in flash mode) against their plain versions at
                   the MQ levels that reach them (T 1024, 512, 256, 128; 16
                   heads of 64), forward at batch 16, backward at batch 2,
                   bf16 and f32, ragged masks and one fully masked row (K1n:
                   0, K1f: the mean of v), each backward called twice for
                   equal bits; K1f also at the ViT's two request calls (240
                   and 8 frames of 1025 tokens, 12 x 64, bf16), 30 frames in
                   f32, and its backward at 8 frames. Library: SDPA with
                   the boolean mask on the rows that have a valid key; each
                   backward call queued behind a device sleep (`queued_ms`:
                   through autograd, host-timed, it is the host's)
 22. vq_attn_probe the VQ attention probe's four variants (P2: K1's forward
                   with bound_shift and mxu_sum) at the probe's shape (120 x
                   1152 tokens, 1025 valid, 12 x 64, N(0, 2^2) bf16), each
                   against its plain version, then the probe's JSON lines
 23. mq_flash_parity, mq_naive_parity   phase 4 with attention_impl "flash"
                   and "pallas_naive"
 24. mq_flash_serve, mq_naive_serve     phase 5 under each impl, the launches
                   per request checked (K1f or K1n 5, K1 6)
 25. mq_flash_train, mq_naive_train     phase 9 under each impl, the launches
                   per step checked (K1f-bwd or K1n-bwd 5, K1-bwd 6)
 26. vq_flash_serve phase 19 with vit_attn_impl "flash" (K1f 24, K1 2, K6 3
                   a request), without the fused-MLP request
Every timing line carries the card's name and power limit. Then one JSON
line with the kernels, and as the last line {"ok": true, "device": {...}}.

--cl-methods: cl_parity (the graft flagship's iCaRL and BiC steps at batch
1 and the naive step at accumulation 2 over batch 2, f32, card vs CPU as
phase 8; BiC's stage 2; MAS's importance) and vq_cl_parity (phase 18 at
batch 4 in 2 micro-batches with an EWC penalty over every leaf).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
B_SERVE = 16
B_TRAIN = 2          # the flagship's loader.batch_size
# forward outputs against tol x max(1, max|ref|): f32 summation order and an
# online softmax against a two-pass one; bf16 one rounding of the output
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# f32 on both sides reads ~6e-6 (summation order over ~30 layers; the VQ
# ClipMatcher 4.8e-6); TF32 in the card's GEMMs and convs reads ~1e-3, so
# 2e-5 tells the two apart. The parity phases run that TF32 control and
# fail if the check cannot see it.
PARITY_RTOL = 2e-5


# published dense peaks of one H100 SXM (NVIDIA's data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
CARD = ""            # nvidia-smi's name and power limit, set by phase_device
# timed calls of a kernel check's plain version (10-200x the kernel's time;
# its ms is context, not a gate), after one warm-up call
PLAIN_REPS = 3


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the dtype's peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def say(line: str) -> None:
    """Print a result line with the card's name and power limit beside it."""
    print(line if CARD in line else f"{line} [{CARD}]")


def fail(msg: str) -> None:
    """Print the failure on stdout, among the results, and on stderr, where
    a caller that keeps only the error stream still reads its cause."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# traces taken of one call before a trace with no device time fails: the
# profiler has been seen to drop every device record of a trace of kernels
# that ran and checked out (about once in a default run)
TRACE_TRIES = 3


def device_rows(fn, label: str):
    """Run `fn` under torch.profiler (CPU and CUDA activities) until a trace
    holds device time, at most TRACE_TRIES times: (fn's result, host ms of
    the profiled call, [(device ms, launches, kernel name)])."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            us = getattr(e, "self_device_time_total", None)
            rows.append(((e.self_cuda_time_total if us is None else us)
                         / 1e3, e.count, e.key))
        if sum(r[0] for r in rows) > 0:
            return out, host_ms, rows
        say(f"[profiler] a trace of {label} held no device time; taking it "
            f"again")
    fail(f"{label}: the profiler saw no device time in {TRACE_TRIES} traces")


def device_ms_by_kernel(fn, reps: int = 20, warmup: int = 3) -> dict:
    """The device ms of one call of `fn` by kernel name: each kernel's own
    time in a torch.profiler trace of `reps` calls, over `reps`."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(reps):
            fn()

    _, _, rows = device_rows(calls, "device_ms_by_kernel")
    return {key: ms / reps for ms, _, key in rows}


def short_name(kernel: str) -> str:
    """A profiler kernel name without its return type, anonymous namespace
    and arguments."""
    k = kernel.replace("(anonymous namespace)::", "")
    return k.removeprefix("void ").split("(")[0]


def queued_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """The device ms of one call of `fn` with its host overhead hidden:
    the reps are queued behind a ~0.1 s device-side sleep
    (torch.cuda._sleep), so the card runs them back to back and the events
    around them time the device alone. For calls whose host time exceeds
    their device time, as autograd's backward at small shapes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)       # cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ragged_mask(rng, B: int, T: int, dev) -> torch.Tensor:
    """Lengths drawn from [T/2, T]; the last row fully masked."""
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0
    m = np.arange(T)[None, :] < lens[:, None]
    return torch.from_numpy(m).to(dev)


def zero_row(label, outs):
    """The last batch row (fully masked by ragged_mask) must be exactly 0."""
    if any(x[-1].abs().max().item() != 0 for x in outs):
        fail(f"{label}: the fully masked row is not 0")


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    print(f"[device] {name} capability {cap[0]}.{cap[1]} count "
          f"{torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a")
    return name


def phase_build():
    from vilco_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.load_all()
    say(f"[build] {len(libs)} libraries ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, lib in libs.items():
        when = ("cached" if lib.build_seconds is None
                else f"built in {lib.build_seconds:.2f} s")
        say(f"[build] {name}.cu: {when}")
        for ln in lib.ptxas_log.splitlines():
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln:
                say(f"[build]   {ln.split(':', 1)[-1].strip()}")


def phase_kernels(dev):
    from vilco_tpu_torch.core.config import flagship_config
    from vilco_tpu_torch.kernels.attention import (
        fused_attention_blc,
        fused_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        fused_dwconv_qkv,
        fused_dwconv_qkv_plain,
    )
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_rel_attention,
        xl_rel_attention_plain,
    )

    cfg = flagship_config().model
    T0, C, H = cfg.max_seq_len, cfg.embd_dim, cfg.n_head
    D = C // H
    nb = cfg.num_branch_layers
    rng = np.random.default_rng(SEED)
    chk = KernelChecks("kernels", ("attn", "xl", "dw"))
    out_err = lambda names, got, want, dtype: output_errors(
        names, got, want, FWD_TOL[dtype])

    def randn(*shape, dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    for dtype in (torch.bfloat16, torch.float32):
        top = dtype == torch.bfloat16
        # K1: stem at T0, then each branch block's strided length
        for T in [T0] + [T0 >> (i + 1) for i in range(nb)]:
            q, k, v = (randn(B_SERVE, T, C, dtype=dtype) for _ in range(3))
            m = ragged_mask(rng, B_SERVE, T, dev)
            bh = lambda x: x.reshape(B_SERVE, T, H, D).transpose(1, 2)
            qh, kh, vh = bh(q), bh(k), bh(v)
            am = m[:, None, None, :]
            label = f"fused_attention_blc B={B_SERVE} T={T} C={C} H={H}"
            out = fused_attention_blc(q, k, v, m, H)
            zero_row(label, [out])
            chk.report("attn", label, dtype,
                       out_err(("out",), [out],
                               [fused_attention_blc_plain(q, k, v, m, H)],
                               dtype),
                       lambda: fused_attention_blc(q, k, v, m, H),
                       lambda: fused_attention_blc_plain(q, k, v, m, H),
                       attention_work(T, m, C, dtype, backward=False),
                       lambda: F.scaled_dot_product_attention(
                           qh, kh, vh, attn_mask=am),
                       is_top=top and T == T0)
        # K2: the XL stage at T0
        q, k, v = (randn(B_SERVE, T0, H, D, dtype=dtype) for _ in range(3))
        r = randn(2 * T0, H, D, dtype=dtype)
        rwb, rrb = (randn(H, D, dtype=dtype, scale=0.1) for _ in range(2))
        m = ragged_mask(rng, B_SERVE, T0, dev)
        label = f"xl_rel_attention B={B_SERVE} T={T0} H={H} D={D}"
        out = xl_rel_attention(q, k, v, r, rwb, rrb, m)
        zero_row(label, [out])
        chk.report("xl", label, dtype,
                   out_err(("out",), [out],
                           [xl_rel_attention_plain(q, k, v, r, rwb, rrb, m)],
                           dtype),
                   lambda: xl_rel_attention(q, k, v, r, rwb, rrb, m),
                   lambda: xl_rel_attention_plain(q, k, v, r, rwb, rrb, m),
                   xl_work(T0, m, C, dtype, backward=False), is_top=top,
                   also_queued=True)
        check_repeatable("kernels", f"{label} {str(dtype)[6:]}",
                         lambda: [xl_rel_attention(q, k, v, r, rwb, rrb, m)])
        tiles = F.pad(m, (0, -T0 % 64)).reshape(B_SERVE, -1, 64).any(-1)
        say(f"[kernels] {label}: {int((~tiles).sum())} of {tiles.numel()} "
            "key tiles of 64 hold no valid key (every block walks them)")
        # K3: stride 1 in the stem, stride 2 on each branch block's input
        w = randn(3, 3, C, dtype=dtype, scale=0.3)
        wg = w.float().permute(2, 0, 1).reshape(3 * C, 1, 3).to(dtype)
        for T, s in [(T0, 1)] + [(T0 >> i, 2) for i in range(nb)]:
            x = randn(B_SERVE, T, C, dtype=dtype)
            xt = x.transpose(1, 2)
            chk.report("dw", f"fused_dwconv_qkv B={B_SERVE} T={T} C={C} "
                       f"stride={s}", dtype,
                       out_err(("q", "k", "v"), fused_dwconv_qkv(x, w, s),
                               fused_dwconv_qkv_plain(x, w, s), dtype),
                       lambda: fused_dwconv_qkv(x, w, s),
                       lambda: fused_dwconv_qkv_plain(x, w, s),
                       dwconv_work(B_SERVE, T, C, s, dtype, backward=False),
                       lambda: F.conv1d(xt, wg, stride=s, padding=1,
                                        groups=C),
                       is_top=top and T == T0 and s == 1, also_queued=True)
        del q, k, v, r, x, out
        torch.cuda.empty_cache()
    if not chk.ok:
        fail("a kernel disagrees with its plain version")
    return chk.errs, chk.top


def redraw_adapters(model) -> None:
    """The time adapters' fc2 kernels, zero at init (so their fc1 gets no
    gradient and the adapters add nothing), redrawn from N(0, 0.02^2) with
    a seeded CPU generator: the same values wherever the model lies."""
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("adapter.fc2.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


def phase_parity(dev, tag: str, cfg, inputs, cl=None,
                 keys=("cls_logits", "offsets")):
    """`cfg` (a ModelConfig) with the CL extras of `cl` at batch 1 in f32
    (the adapters redrawn, redraw_adapters): the forward on the card with
    its kernels against the CPU with the plain versions, on the same CPU
    `inputs` (model(*inputs)): max relative error of the outputs `keys`,
    and a TF32 control that must read above the limit."""
    from vilco_tpu_torch.models.point_transformer import PointTransformer

    model = PointTransformer(
        cfg, generator=torch.Generator().manual_seed(SEED),
        device="cpu", cl=cl).eval()
    redraw_adapters(model)
    card = [a.to(dev) for a in inputs]
    with torch.no_grad():
        ref = model(*inputs)
        gpu = copy.deepcopy(model).to(dev)
        out = gpu(*card)
        # control: the same forward with TF32 allowed must read above the
        # tolerance, or the check could not catch a precision fault
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tf32 = gpu(*card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()

    def rel_err(o, r):
        o = o.cpu()
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{tag}: shape {tuple(o.shape)} or non-finite values")
        return ((o - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()

    worst, control = 0.0, 0.0
    for key in keys:
        rel = rel_err(out[key], ref[key])
        worst = max(worst, rel)
        control = max(control, rel_err(tf32[key], ref[key]))
        say(f"[{tag}] {key} {tuple(ref[key].shape)} f32 card vs CPU: max "
            f"rel err {rel:.3e} (tol {PARITY_RTOL:g})")
    say(f"[{tag}] control, TF32 allowed on the card: max rel err "
        f"{control:.3e} (must exceed tol {PARITY_RTOL:g})")
    if not torch.equal(out["fpn_mask"].cpu(), ref["fpn_mask"]):
        fail(f"{tag}: fpn_mask differs")
    if worst > PARITY_RTOL:
        fail(f"{tag}: full-width parity out of tolerance")
    if control <= PARITY_RTOL:
        fail(f"{tag}: the check does not see TF32: tolerance too loose")
    del gpu
    torch.cuda.empty_cache()


def mq_parity_inputs(cfg):
    """The MQ parity's CPU inputs at batch 1: features and a ragged mask."""
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.standard_normal(
        (1, cfg.max_seq_len, cfg.input_dim)).astype(np.float32))
    return x, ragged_mask(rng, 2, cfg.max_seq_len, "cpu")[:1]


def mq_requests(cfg, dev, n: int = 7):
    """`n` MQ serving requests at batch 16 on the card: bf16 features and
    masks with lengths drawn from [T/2, T]."""
    rng = np.random.default_rng(SEED + 2)
    T, requests = cfg.max_seq_len, []
    for _ in range(n):
        feats = rng.standard_normal((B_SERVE, T, cfg.input_dim))
        lens = rng.integers(T // 2, T + 1, size=B_SERVE)
        mask = np.arange(T)[None, :] < lens[:, None]
        requests.append((torch.from_numpy(feats.astype(np.float32)).to(
            dev, torch.bfloat16), torch.from_numpy(mask).to(dev)))
    return requests


SERVE_KEYS = ("feats", "mask", "text", "text_mask")


def phase_serve(dev, tag: str, full, requests, kernels, cl=None):
    """The bf16 model of `full` (a Config) with the CL extras of `cl`
    serving `requests` (tuples of card tensors for model(*request)): 2
    warm-up and the rest timed through forward + decode_and_nms_batch at
    full.test_cfg; clips/s, ms per request split, peak memory, detections,
    the launch counts of `kernels` (set to 0 just before), then one more
    request profiled. With `cl.use_adapt` the forward is the eval step's
    adapter ensemble (train/engine.py::make_eval_step): the live adapters'
    and an EMA's forwards averaged, the EMA drawn as the adapters plus
    N(0, 0.02^2), and the two forwards are split by CUDA events."""
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.ops.decode import decode_and_nms_batch
    from vilco_tpu_torch.train.engine import init_adapter_ema, make_eval_step

    cfg, t = full.model, full.test_cfg
    model = PointTransformer(
        cfg, generator=torch.Generator().manual_seed(SEED),
        device=dev, cl=cl).eval().to(torch.bfloat16)
    ensemble = cl is not None and cl.use_adapt
    if ensemble:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ema = {n: e + 0.02 * torch.randn(e.shape, generator=gen, device=dev,
                                         dtype=e.dtype)
               for n, e in init_adapter_ema(model).items()}
        evaluate = make_eval_step(model, ensemble_adapters=True)
        forward = lambda req, marks=None: evaluate(
            dict(zip(SERVE_KEYS, req)), ema, marks)
    else:
        forward = lambda req, marks=None: model(*req)
    points = torch.from_numpy(generate_points(
        level_lengths(cfg), cfg.fpn_strides, cfg.regression_range)).to(dev)
    class_mask = torch.ones(cfg.num_classes, dtype=torch.bool, device=dev)
    B = requests[0][0].shape[0]

    def postprocess(out):
        return decode_and_nms_batch(
            points, out["cls_logits"], out["offsets"], out["fpn_mask"],
            class_mask, num_classes=cfg.num_classes,
            pre_nms_topk=t.pre_nms_topk, pre_nms_thresh=t.pre_nms_thresh,
            duration_thresh=t.duration_thresh, max_seg_num=t.max_seg_num,
            min_score=t.min_score, nms_sigma=t.nms_sigma,
            voting_thresh=t.voting_thresh)

    splits = []

    def serve(req):
        marks = [] if ensemble else None
        t0 = time.perf_counter()
        out = forward(req, marks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        det = postprocess(out)
        torch.cuda.synchronize()
        if ensemble:
            ev = dict(marks)
            splits.append((ev["start"].elapsed_time(ev["forward"]),
                           ev["forward"].elapsed_time(ev["ema_forward"])))
        return det, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        for req in requests[:2]:
            serve(req)
        fwd, post, dets = [], [], []
        t0 = time.perf_counter()
        for req in requests[2:]:
            det, f_ms, p_ms = serve(req)
            fwd.append(f_ms)
            post.append(p_ms)
            dets.append(det)
        wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    K = t.max_seg_num
    for det in dets:
        if det.segs.shape != (B, K, 2) or det.scores.shape != (B, K):
            fail(f"{tag}: detections have shape {tuple(det.segs.shape)}")
        if not (torch.isfinite(det.segs).all()
                and torch.isfinite(det.scores).all()):
            fail(f"{tag}: non-finite detections")
        s = torch.where(det.valid, det.scores, -1.0)
        if (s[:, 1:] > s[:, :-1]).any():
            fail(f"{tag}: detection scores are not sorted")
    n_valid = torch.stack([d.valid.sum(1) for d in dets]).float()
    n_req = len(dets)
    say(f"[{tag}] {cfg.variant.upper()} batch {B} bf16, T={cfg.max_seq_len},"
        f" {n_req} timed requests: {n_req * B / wall:.3f} clips/s, "
        f"{wall / n_req * 1e3:.3f} ms/request (forward median "
        f"{statistics.median(fwd):.3f} ms, decode+NMS median "
        f"{statistics.median(post):.3f} ms) [{CARD}]")
    if ensemble:
        timed = splits[2:]
        say(f"[{tag}] the ensemble's two forwards by CUDA events, median: "
            f"live adapters {statistics.median(s[0] for s in timed):.3f} "
            f"ms, EMA adapters {statistics.median(s[1] for s in timed):.3f}"
            f" ms; {t.pre_nms_topk} candidates into soft-NMS (sigma "
            f"{t.nms_sigma:g}) [{CARD}]")
        with torch.no_grad():
            live = model(*requests[0])["cls_logits"]
            both = forward(requests[0])["cls_logits"]
        if torch.equal(live, both):
            fail(f"{tag}: the EMA adapters' forward changed nothing")
    say(f"[{tag}] peak memory {peak:.3f} GiB; valid detections per clip "
        f"mean {n_valid.mean().item():.2f} min {n_valid.min().item():.0f}")
    say(f"[{tag}] launches in the {len(requests)} requests: {launches}")
    if min(launches.values()) < 1:
        fail(f"{tag}: a kernel of the path was never launched")
    req = requests[-1]
    with torch.no_grad():
        out = phase_trace(f"{tag} forward", lambda: forward(req),
                          statistics.median(fwd))
        phase_trace(f"{tag} decode+NMS", lambda: postprocess(out),
                    statistics.median(post))
    del model
    torch.cuda.empty_cache()
    return launches


def check_launches(tag: str, launches: dict, want: dict, n: int,
                   unit: str) -> None:
    """Each kernel of `want` (launches per `unit`) must have been launched
    exactly want x n times."""
    for name, per in want.items():
        if launches.get(name) != per * n:
            fail(f"{tag}: {name} launched {launches.get(name)} times in "
                 f"{n} {unit}s, {per} a {unit} expected")
    say(f"[{tag}] launches a {unit} as the model's structure gives them: "
        + ", ".join(f"{k} {v}" for k, v in want.items()))


def attention_work(T, m, C, dtype, backward):
    """(flops, bytes) the attention needs for T queries over the keys of
    the mask m (B, Tk): q.k and p.v for every valid key (x 2.5 for the
    backward: s, dP, dV, dK, dQ), q/k/v/out read or written once (the
    backward also reads out and dout and writes dq/dk/dv)."""
    pairs = T * int(m.sum())
    el = torch.empty((), dtype=dtype).element_size()
    B, Tk = m.shape
    if backward:
        return 10 * C * pairs, 4 * B * (T + Tk) * C * el
    return 4 * C * pairs, 2 * B * (T + Tk) * C * el + m.numel()


def xl_work(T, m, C, dtype, backward):
    """(flops, bytes) of the XL core: content and shifted position scores
    and p.v for every valid key (the backward: scores, dP, dv, dk, both dq
    terms, dr), inputs read and outputs written once."""
    pairs = T * int(m.sum())
    el = torch.empty((), dtype=dtype).element_size()
    B = m.shape[0]
    if backward:
        return 16 * C * pairs, (8 * B * T * C + 4 * T * C) * el
    return 6 * C * pairs, (4 * B * T * C + 2 * T * C) * el + m.numel()


def dwconv_work(B, T, C, s, dtype, backward):
    To = (T - 1) // s + 1
    el = torch.empty((), dtype=dtype).element_size()
    if backward:
        return 36 * B * To * C, (2 * B * T * C + 3 * B * To * C) * el
    return 18 * B * To * C, (B * T * C + 3 * B * To * C) * el


def k3_calls(full) -> list:
    """(T, stride, calls) of K3 in one forward of the flagship `full` (a
    Config): the stem blocks at stride 1 (NLQ: the video stem at
    max_seq_len and the text stem at max_text_len), then branch block i at
    stride 2 on its input of max_seq_len >> i."""
    m = full.model
    T0 = m.max_seq_len
    if m.variant == "nlq":
        stems = [(T0, 1, m.backbone_arch[2]),
                 (full.max_text_len, 1, m.backbone_arch[1])]
    else:
        stems = [(T0, 1, m.backbone_arch[1])]
    return stems + [(T0 >> i, 2, 1) for i in range(m.num_branch_layers)]


def say_k3_sums(tag: str, dw_ms: dict, full, b_serve: int) -> None:
    """K3's bf16 ms summed over a request's calls (forward at b_serve) and a
    train step's (forward and backward at full.batch_size), each call at
    its own length and stride; dw_ms[(part, B, T, stride)] = (ms, bound
    ms)."""
    calls = k3_calls(full)
    for what, B, parts in (("request", b_serve, ("fwd",)),
                           ("train step", full.batch_size, ("fwd", "bwd"))):
        ms, bms = (sum(n * dw_ms[p, B, T, s][j] for T, s, n in calls
                       for p in parts) for j in (0, 1))
        say(f"[{tag}] K3 over a {full.model.variant.upper()} {what}'s "
            f"{sum(n for _, _, n in calls)} calls ("
            + ", ".join(f"{n} x T={T} s{s}" for T, s, n in calls)
            + f"), bf16 batch {B}, {' + '.join(parts)}: {ms:.4f} ms on the "
            f"card (queued behind a sleep), bound {bms:.4f} ms, time - "
            f"bound {ms - bms:.4f} ms [{CARD}]")


def output_errors(names, got, want, tol):
    """One row per output: (name, max abs error, its limit tol x max(1,
    max |reference|)). An output may be a list of tensors (AdamW's p, m or
    v over every leaf), taken as one."""
    rows = []
    for name, a, b in zip(names, got, want):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        err, ref = 0.0, 0.0
        for x, y in zip(a, b):
            x, y = x.float(), y.float()
            if x.shape != y.shape or not torch.isfinite(x).all():
                fail(f"{name}: shape {tuple(x.shape)} vs {tuple(y.shape)} "
                     "or non-finite")
            err = max(err, (x - y).abs().max().item())
            ref = max(ref, y.abs().max().item())
        rows.append((name, err, tol * max(1.0, ref)))
    return rows


class KernelChecks:
    """One phase's kernel checks: each output against its own limit (rows
    from output_errors), then the median ms of the kernel, its plain
    version and the library call, and the bound. `errs[key]` collects each
    check's worst error, `top[key]` the timings at the headline shape, `ok`
    whether every output was inside its limit."""

    def __init__(self, tag: str, keys):
        self.tag, self.errs, self.top, self.ok = tag, {k: [] for k in keys}, \
            {}, True

    def report(self, key, label, dtype, rows, kern, plain, work,
               library=None, is_top=False, reps=10, queued=False,
               also_queued=False):
        """`queued`: time the kernel, the plain version and the library
        call by `queued_ms`, where a host-timed figure would be the host's
        (autograd's backward at small shapes). `also_queued`: time the
        kernel by `queued_ms` too, beside its time by events. Returns the
        kernel's device ms (queued where it was timed so) and the bound."""
        ok = all(err <= lim for _, err, lim in rows)
        self.ok &= ok
        self.errs[key].append(max(err for _, err, _ in rows))
        timer = queued_ms if queued else median_ms
        ms = timer(kern, reps=reps)
        pms = timer(plain, reps=min(reps, PLAIN_REPS), warmup=1)
        lms = timer(library, reps=reps) if library is not None else None
        qms = queued_ms(kern, reps=reps) if also_queued else None
        bms, by = bound(*work, dtype)
        say(f"[{self.tag}] {label} {str(dtype)[6:]}: max_abs_err (limit) "
            + ", ".join(f"{n} {e:.3e} ({lim:.3e})" for n, e, lim in rows)
            + f" {'ok' if ok else 'OUT OF TOLERANCE'}; kernel {ms:.4f} ms"
            f"{'' if qms is None else f' ({qms:.4f} ms queued)'}, "
            f"plain {pms:.4f} ms, library "
            f"{'none' if lms is None else f'{lms:.4f} ms'}"
            f"{' (each queued behind a sleep)' if queued else ''}, bound "
            f"{bms:.4f} ms ({by}) [{CARD}]")
        if is_top:
            self.top[key] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                 bound_ms=bms, bound_by=by)
            if qms is not None:
                self.top[key]["queued_ms"] = qms
        return (ms if qms is None else qms), bms


def grads_of(fn, inputs, g):
    xs = [x.detach().clone().requires_grad_() if x.is_floating_point()
          else x for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, g if isinstance(g, tuple) else (g,))
    return [x.grad for x in xs if x.is_floating_point()]


def backward_timer(fn, inputs, g):
    """A closure running only the backward of fn at inputs (graph kept)."""
    xs = [x.detach().clone().requires_grad_() if x.is_floating_point()
          else x for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    leaves = [x for x in xs if x.is_floating_point()]
    gs = g if isinstance(g, tuple) else (g,)
    return lambda: torch.autograd.grad(outs, leaves, gs, retain_graph=True)


def check_repeatable(tag: str, label: str, fn) -> None:
    """Two calls of `fn` (a kernel's wrapper, returning its outputs as a
    sequence) give equal bits: the kernel sums in a fixed order, with no
    atomics."""
    first, second = fn(), fn()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{tag}: {label}: two calls differ in their bits")
    say(f"[{tag}] {label}: two calls bitwise equal")


# training-kernel tolerances, each output against tol x max(1, its own
# largest reference value): f32 summation order and f32 atomics; bf16
# inputs and outputs rounded and the backward reading the bf16 forward
# output (dw and the XL bias gradients sum over batch and time and are
# ~30-200x larger than dx or dq, so one pooled limit would hide those)
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
XL_GRADS = ("dq", "dk", "dv", "dr", "d_r_w_bias", "d_r_r_bias")


def point_transformer_leaves(cfg, dev, cl=None):
    """(label, leaves, decay flags) of the model of `cfg` (a ModelConfig)
    with the CL extras of `cl`, decay as the MQ/NLQ optimizer's mask
    (train/optim.py::decays)."""
    from vilco_tpu_torch.models.point_transformer import PointTransformer
    from vilco_tpu_torch.train.optim import decays

    model = PointTransformer(cfg, generator=torch.Generator().manual_seed(
        SEED), device=dev, cl=cl)
    named = list(model.named_parameters())
    return (cfg.variant.upper(), [p.data for _, p in named],
            [decays(n, p.dim()) for n, p in named])


def check_adamw(chk, label, ps, decays, mdt, wd=None):
    """K4 over the f32 leaves `ps` in one launch, moments in `mdt`, weight
    decay `wd` (the kernel's default if None), bit-exact against the plain
    version leaf by leaf; PyTorch's fused AdamW timed beside it."""
    from vilco_tpu_torch.kernels.adamw import (
        B1,
        B2,
        EPS,
        WEIGHT_DECAY,
        LeafTable,
        adamw_update_multi,
        adamw_update_plain,
    )

    kw = {} if wd is None else {"wd": wd}
    gr = [torch.randn_like(p) * 1e-3 for p in ps]
    ms = [(torch.randn_like(p) * 1e-3).to(mdt) for p in ps]
    vs = [(torch.randn_like(p) * 1e-3).square().to(mdt) for p in ps]
    coef = torch.tensor([1e-4, 0.271, 0.002997, 0.75], device=ps[0].device)
    want = [adamw_update_plain(p, g, m_, v_, d, *coef, **kw)
            for p, g, m_, v_, d in zip(ps, gr, ms, vs, decays)]
    got = [t.clone() for t in ps], [t.clone() for t in ms], \
        [t.clone() for t in vs]
    table = LeafTable(got[0], gr, got[1], got[2], decays)
    adamw_update_multi(table, coef, **kw)
    n = sum(p.numel() for p in ps)
    el = torch.empty((), dtype=mdt).element_size()
    # the library: PyTorch's fused AdamW over copies of the same leaves, one
    # call per weight-decay group as AdamW(fused=True) steps them; its
    # moments are f32 (it takes one dtype for all its lists) and it rounds
    # b1 m otherwise (ROADMAP §3), so it is timed and not compared
    lib = [[t.clone() for t in ps], gr, [t.float() for t in ms],
           [t.float() for t in vs]]
    steps = [torch.ones((), device=ps[0].device) for _ in ps]
    groups = [(idx, decay) for idx, decay in (
        ([i for i, d in enumerate(decays) if d],
         WEIGHT_DECAY if wd is None else wd),
        ([i for i, d in enumerate(decays) if not d], 0.0)) if idx]

    def library():
        for idx, decay in groups:
            torch._fused_adamw_(
                *([x[i] for i in idx] for x in lib), [],
                [steps[i] for i in idx], lr=1e-4, beta1=B1, beta2=B2,
                weight_decay=decay, eps=EPS, amsgrad=False, maximize=False)

    chk.report("adamw", f"adamw_update_multi {label} {len(ps)} leaves {n} "
               f"params, {str(mdt)[6:]} moments (library: "
               "torch._fused_adamw_, f32 moments)", torch.float32,
               output_errors(("p", "m", "v"), list(got),
                             [list(x) for x in zip(*want)], 0.0),
               lambda: adamw_update_multi(table, coef, **kw),
               lambda: [adamw_update_plain(p, g, m_, v_, d, *coef, **kw)
                        for p, g, m_, v_, d in zip(ps, gr, ms, vs, decays)],
               (16 * n, (12 + 4 * el) * n), library, is_top=True, reps=5)
    del gr, ms, vs, got, want, table, lib
    torch.cuda.empty_cache()


def phase_train_kernels(dev):
    from vilco_tpu_torch.core.config import flagship_config
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        fused_attention_blc,
        fused_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
        fused_dwconv_qkv_plain,
    )
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_fwd_cuda,
        xl_rel_attention,
        xl_rel_attention_plain,
    )

    cfg = flagship_config().model
    T0, C, H = cfg.max_seq_len, cfg.embd_dim, cfg.n_head
    D = C // H
    nb = cfg.num_branch_layers
    B = B_TRAIN
    rng = np.random.default_rng(SEED + 3)
    chk = KernelChecks("train_kernels", ("attn_bwd", "xl_fwd", "xl_bwd",
                                         "dw_bwd", "adamw"))
    out_err = lambda names, got, want, dtype: output_errors(
        names, got, want, TRAIN_TOL[dtype])

    def randn(*shape, dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    for dtype in (torch.bfloat16, torch.float32):
        # K1-bwd: the two stems at T0, then each branch block's length
        for T in [T0] + [T0 >> (i + 1) for i in range(nb)]:
            q, k, v, g = (randn(B, T, C, dtype=dtype) for _ in range(4))
            m = ragged_mask(rng, B, T, dev)
            got = grads_of(lambda *a: fused_attention_blc(*a, m, H),
                           (q, k, v), g)
            if any(x[-1].abs().max().item() != 0 for x in got):
                fail(f"attention backward T={T}: fully masked row not 0")
            want = grads_of(lambda *a: fused_attention_blc_plain(*a, m, H),
                            (q, k, v), g)
            out, lse = attention_fwd_cuda(q, k, v, m, H, with_lse=True)
            if T in (T0, T0 >> 1):     # one query slice, and two
                check_repeatable("train_kernels", f"attention backward B={B} "
                                 f"T={T} {str(dtype)[6:]}",
                                 lambda: attention_bwd_cuda(q, k, v, m, out,
                                                            lse, g, H))
            bh = lambda x: x.reshape(B, T, H, D).transpose(1, 2)
            am = m[:, None, None, :]
            chk.report("attn_bwd", f"attention backward B={B} T={T} C={C} "
                       f"H={H}", dtype,
                       out_err(("dq", "dk", "dv"), got, want, dtype),
                       lambda: attention_bwd_cuda(q, k, v, m, out, lse, g, H),
                       backward_timer(
                           lambda *a: fused_attention_blc_plain(*a, m, H),
                           (q, k, v), g),
                       attention_work(T, m, C, dtype, backward=True),
                       backward_timer(
                           lambda a, b, c: F.scaled_dot_product_attention(
                               bh(a), bh(b), bh(c), attn_mask=am),
                           (q, k, v), bh(g)),
                       is_top=dtype == torch.bfloat16 and T == T0)
        # K2 forward with dropout and K2-bwd at rate 0 and 0.1, T0
        q, k, v, g = (randn(B, T0, H, D, dtype=dtype) for _ in range(4))
        r = randn(2 * T0, H, D, dtype=dtype)
        rwb, rrb = (randn(H, D, dtype=dtype, scale=0.1) for _ in range(2))
        m = ragged_mask(rng, B, T0, dev)
        args = (q, k, v, r, rwb, rrb, m)
        seed = 0x243F6A8885A308D3
        st = torch.tensor([seed], dtype=torch.int64, device=dev)
        for rate in (0.0, 0.1):
            label = f"B={B} T={T0} H={H} D={D} rate {rate}"
            out = xl_rel_attention(*args, seed, rate)
            ref = xl_rel_attention_plain(*args, seed=seed, rate=rate)
            if out[-1].abs().max().item() != 0:
                fail("XL forward: fully masked row not 0")
            chk.report("xl_fwd", f"xl_rel_attention forward {label}", dtype,
                       out_err(("out",), [out], [ref], dtype),
                       lambda: xl_fwd_cuda(args, st, rate, with_lse=False),
                       lambda: xl_rel_attention_plain(*args, seed=seed,
                                                      rate=rate),
                       xl_work(T0, m, C, dtype, backward=False),
                       is_top=dtype == torch.bfloat16 and rate > 0,
                       also_queued=True)
            check_repeatable("train_kernels", f"xl_rel_attention forward "
                             f"{label} {str(dtype)[6:]}",
                             lambda: xl_fwd_cuda(args, st, rate,
                                                 with_lse=True))
            got = grads_of(lambda *a: xl_rel_attention(*a, seed, rate),
                           args, g)
            want = grads_of(lambda *a: xl_rel_attention_plain(
                *a, seed=seed, rate=rate), args, g)
            out, lse = xl_fwd_cuda(args, st, rate, with_lse=True)
            check_repeatable("train_kernels", f"xl_rel_attention backward "
                             f"{label} {str(dtype)[6:]}",
                             lambda: xl_bwd_cuda(args, out, lse, g, st, rate))
            chk.report("xl_bwd", f"xl_rel_attention backward {label}", dtype,
                       out_err(XL_GRADS, got, want, dtype),
                       lambda: xl_bwd_cuda(args, out, lse, g, st, rate),
                       backward_timer(lambda *a: xl_rel_attention_plain(
                           *a, seed=seed, rate=rate), args, g),
                       xl_work(T0, m, C, dtype, backward=True),
                       is_top=dtype == torch.bfloat16 and rate > 0)
            split = device_ms_by_kernel(
                lambda: xl_bwd_cuda(args, out, lse, g, st, rate), reps=10)
            say(f"[train_kernels] xl_rel_attention backward {label} "
                f"{str(dtype)[6:]} by kernel, device ms a call: "
                + ", ".join(f"{short_name(k)} {v:.4f}"
                            for k, v in split.items()))
        del q, k, v, g, r, out, lse, got, want
        # K3-bwd: stride 1 in the stem, stride 2 on each branch's input
        w = randn(3, 3, C, dtype=dtype, scale=0.3)
        wg = w.float().permute(2, 0, 1).reshape(3 * C, 1, 3).to(dtype)
        for T, s in [(T0, 1)] + [(T0 >> i, 2) for i in range(nb)]:
            x = randn(B, T, C, dtype=dtype)
            To = (T - 1) // s + 1
            gs = tuple(randn(B, To, C, dtype=dtype) for _ in range(3))
            got = grads_of(lambda a, b: fused_dwconv_qkv(a, b, s), (x, w), gs)
            want = grads_of(lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                            (x, w), gs)
            # the grouped conv's output interleaves q, k, v per channel
            gcat = torch.stack(gs, -1).reshape(B, To, 3 * C).transpose(1, 2)
            chk.report("dw_bwd", f"dwconv backward B={B} T={T} C={C} "
                       f"stride={s}", dtype,
                       out_err(("dx", "dw"), got, want, dtype),
                       lambda: dwconv_bwd_cuda(x, w, *gs, s),
                       backward_timer(
                           lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                           (x, w), gs),
                       dwconv_work(B, T, C, s, dtype, backward=True),
                       backward_timer(lambda a, b: F.conv1d(
                           a.transpose(1, 2), b, stride=s, padding=1,
                           groups=C), (x, wg), gcat),
                       is_top=dtype == torch.bfloat16 and T == T0 and s == 1,
                       also_queued=True)
            check_repeatable("train_kernels", f"dwconv backward B={B} T={T} "
                             f"C={C} stride={s} {str(dtype)[6:]}",
                             lambda: dwconv_bwd_cuda(x, w, *gs, s))
        torch.cuda.empty_cache()

    # the XL backward's inverse shift (d_raw[i, T + j - i] += d_ac[i, j]) at
    # odd lengths, one to three 64-row tiles: every output against its
    # limit, both dtypes and rates, and two calls bitwise equal
    for T in (37, 101, 131):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (randn(2, T, 4, 64, dtype=dtype) for _ in range(4))
            args = (q, k, v, randn(2 * T, 4, 64, dtype=dtype),
                    randn(4, 64, dtype=dtype, scale=0.1),
                    randn(4, 64, dtype=dtype, scale=0.1),
                    ragged_mask(rng, 2, T, dev))
            for rate in (0.0, 0.1):
                label = (f"xl backward inverse shift T={T} "
                         f"{str(dtype)[6:]} rate {rate}")
                got = grads_of(lambda *a: xl_rel_attention(*a, seed, rate),
                               args, g)
                want = grads_of(lambda *a: xl_rel_attention_plain(
                    *a, seed=seed, rate=rate), args, g)
                rows = out_err(XL_GRADS, got, want, dtype)
                ok = all(err <= lim for _, err, lim in rows)
                chk.ok &= ok
                say(f"[train_kernels] {label}: max_abs_err (limit) "
                    + ", ".join(f"{n} {e:.3e} ({lim:.3e})"
                                for n, e, lim in rows)
                    + f" {'ok' if ok else 'OUT OF TOLERANCE'}")
                out, lse = xl_fwd_cuda(args, st, rate, with_lse=True)
                check_repeatable(
                    "train_kernels", label,
                    lambda: xl_bwd_cuda(args, out, lse, g, st, rate))

    check_adamw(chk, *point_transformer_leaves(cfg, dev), torch.bfloat16)
    if not chk.ok:
        fail("a training kernel disagrees with its plain version")
    return chk.errs, chk.top


# f32 train step, card vs CPU: per-leaf gradient error relative to the
# leaf's largest value (floored at 1e-4 of the largest gradient, for the
# leaves whose exact gradient is 0); a TF32 control must read above it
GRAD_RTOL = 2e-3
PARAM_RTOL = 5e-3
PARITY_STEP = 4      # the schedule step of the parity update: lr at its peak


def leaf_errors(got: dict, want: dict, floor_frac: float) -> dict:
    """max|got - want| / max|want| per leaf, the denominator floored at
    floor_frac of the tree's largest |want| (leaves whose exact gradient is
    0 hold roundoff only)."""
    floor = floor_frac * max(w.float().abs().max().item()
                             for w in want.values())
    return {n: ((got[n].float() - w.float()).abs().max()
                / max(w.float().abs().max().item(), floor, 1e-30)).item()
            for n, w in want.items()}


def rel_by_leaf(got: dict, want: dict, floor_frac: float):
    """The worst of leaf_errors and the three worst leaves."""
    errs = sorted(((e, n) for n, e in leaf_errors(got, want,
                                                  floor_frac).items()),
                  reverse=True)
    return errs[0][0], ", ".join(f"{n} {e:.2e}" for e, n in errs[:3])


@contextlib.contextmanager
def plain_versions():
    """The models' kernel wrappers swapped for their plain versions, where
    each model module imported them (MQ and NLQ blocks, the VQ ClipMatcher
    and ViT): a comparison only, which launches none of the port's
    kernels."""
    from vilco_tpu_torch.kernels.attention import fused_attention_blc_plain
    from vilco_tpu_torch.kernels.banded_attention import (
        banded_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.dwconv import fused_dwconv_qkv_plain
    from vilco_tpu_torch.kernels.frame_band import frame_band_attention_plain
    from vilco_tpu_torch.kernels.xl_attention import xl_rel_attention_plain
    from vilco_tpu_torch.models import clip_matcher, layers, vit

    swap = {"fused_attention_blc": fused_attention_blc_plain,
            "banded_attention_blc": banded_attention_blc_plain,
            "fused_dwconv_qkv": fused_dwconv_qkv_plain,
            "xl_rel_attention": xl_rel_attention_plain,
            "frame_band_attention": frame_band_attention_plain}
    saved = [(mod, n, getattr(mod, n)) for mod in (layers, clip_matcher, vit)
             for n in swap if hasattr(mod, n)]
    for mod, n, _ in saved:
        setattr(mod, n, swap[n])
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


WITNESS_LEAF = "backbone.embd_1.weight"   # MQ's worst gradient leaf


def step_gaps(r, ref):
    """Relative gaps of one train-step result to another: loss, grad norm,
    gradients, updated parameters, mu, nu (each (worst, three worst
    leaves)), and the witness leaf's gradient (None where the model has no
    such leaf)."""
    w = ref["grads"].get(WITNESS_LEAF)
    return dict(
        loss=abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
        gnorm=abs(r["gnorm"] - ref["gnorm"]) / abs(ref["gnorm"]),
        grads=rel_by_leaf(r["grads"], ref["grads"], 1e-4),
        params=rel_by_leaf(r["params"], ref["params"], 1e-4),
        mu=rel_by_leaf(r["mu"], ref["mu"], 1e-4),
        nu=rel_by_leaf(r["nu"], ref["nu"], 1e-4),
        witness=None if w is None else
        ((r["grads"][WITNESS_LEAF].float() - w.float()).abs().max()
         / w.float().abs().max()).item())


def say_gaps(tag, label, r, base, base_label, g):
    witness = ("" if g["witness"] is None
               else f", {WITNESS_LEAF} {g['witness']:.3e}")
    say(f"[{tag}] {label} vs {base_label}: loss {r['loss']:.6f} "
        f"({base['loss']:.6f}, rel {g['loss']:.3e}), clipped grad norm "
        f"{r['gnorm']:.6f} ({base['gnorm']:.6f}, rel {g['gnorm']:.3e}); "
        f"max rel err gradients {g['grads'][0]:.3e} ({g['grads'][1]})"
        f"{witness}; updated params {g['params'][0]:.3e} "
        f"({g['params'][1]}), mu {g['mu'][0]:.3e} ({g['mu'][1]}), nu "
        f"{g['nu'][0]:.3e} ({g['nu'][1]})")


def cl_step_setup(cfg, task, batch_size, device):
    """The CL method of `cfg` (a Config) at task `task` (None: the naive
    method's step over every class): (the model's `cl` argument,
    make_train_step's CL keywords, the step's CLBatchExtras on `device`
    with the memory bank's first value where SSL is on, the batch's
    prompt_mask or None)."""
    from vilco_tpu_torch.data.synthetic import task_extras
    from vilco_tpu_torch.train.engine import CLBatchExtras, init_memory_bank

    c = cfg.cl_cfg
    if task is None:
        return (None, {}, CLBatchExtras(torch.ones(
            cfg.model.num_classes, dtype=torch.bool, device=device)), None)
    ex = task_extras(cfg, task, batch_size)
    bank, ptr = (init_memory_bank(cfg, device) if c.narration_ssl
                 else (None, None))
    return (c, dict(cl_cfg=c, n_known=ex["n_known"]),
            CLBatchExtras(torch.from_numpy(ex["class_mask"]).to(device),
                          bank, ptr), ex["prompt_mask"])


BANK_RTOL = 1e-5     # the memory bank after a step: f32 narration features
PARITY_EMA_DECAY = 0.5   # the CL parity step's adapter EMA (the yaml's 0.999
                         # moves it by 1e-3 of the adapters' step)


def step_gradients(cfg, task, batch, pts, device="cpu",
                   dtype=torch.float64):
    """The CL step's forward, losses and backward, without the optimizer,
    on `device` in `dtype` (the model, batch, memory bank and points in
    `dtype`, regularisers off): (loss, {leaf: gradient in f32 on the
    CPU}). On the CPU in f64 it is the witness of the f32 steps'
    gradients."""
    from vilco_tpu_torch.models.point_transformer import PointTransformer
    from vilco_tpu_torch.train.engine import batch_to, compute_losses

    cl_model, flags, cl, prompt_mask = cl_step_setup(cfg, task, 1, device)
    model = PointTransformer(cfg.model, torch.Generator().manual_seed(SEED),
                             device=device, cl=cl_model)
    redraw_adapters(model)
    model.to(dtype).train()
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch_to(batch, device).items()}
    cl.memory_bank = cl.memory_bank.to(dtype)
    out = model(b["feats"], b["mask"], b["text"], b["text_mask"],
                b["narration"], b["narration_mask"], b["narration_valid"],
                torch.from_numpy(np.ascontiguousarray(prompt_mask)).to(device))
    loss, _, _ = compute_losses(
        out, b, torch.from_numpy(pts).to(device, dtype), cl,
        torch.tensor(cfg.train_cfg.init_loss_norm, dtype=dtype,
                     device=device),
        cfg.train_cfg, flags["n_known"], cfg.cl_cfg.ssl_factor)
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()}


def phase_train_parity(dev, tag="train_parity", full=None, task=None,
                       reg=None):
    """One train step of `full` (a Config; the MQ flagship when None) at
    batch 1 in f32, regularisers off: the card against the CPU, the TF32
    control, and the card through the plain versions (the kernels' share
    and the libraries' share of the gap); then the repeatability pairs.
    With `reg` (finished tasks' [(importance, optpar)] on the CPU, from
    `importance_tasks`), every step carries full's EWC/MAS penalty over
    them, and its value is held card against CPU at 1e-5.
    With `task`, the step is CL task `task` of full's CL method (the clip's
    narration valid, the adapters redrawn, the adapter EMA at
    PARITY_EMA_DECAY), and in place of the repeatability pairs: the same
    step's gradients in f64 on the CPU (step_gradients) as the witness of
    the f32 ones, and the loss terms, the memory bank, its pointer and the
    adapter EMA after the step."""
    from vilco_tpu_torch.core.config import flagship_config
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import (
        batch_to,
        init_train_state,
        make_train_step,
    )

    cfg = full or flagship_config()
    m = cfg.model
    pts = generate_points(level_lengths(m), m.fpn_strides, m.regression_range)
    batch = make_batch(np.random.default_rng(SEED + 4), 1, cfg)
    if "narration_valid" in batch:
        batch["narration_valid"][:] = True

    template = []       # SEED's model, adapters redrawn, on the CPU

    def run(device, tf32: bool, plain: bool = False,
            regularize: bool = False, params_only: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        cl_model, flags, cl, prompt_mask = cl_step_setup(cfg, task, 1,
                                                         device)
        if prompt_mask is not None:
            batch["prompt_mask"] = prompt_mask
        if not template:    # built once: every run starts from its copy
            template.append(PointTransformer(
                m, torch.Generator().manual_seed(SEED), device="cpu",
                cl=cl_model))
            redraw_adapters(template[0])
        model = copy.deepcopy(template[0])
        st = init_train_state(model, cfg, steps_per_epoch=1, seed=SEED,
                              device=device)
        st.opt.count = PARITY_STEP
        ema0 = {n: e.cpu().clone()
                for n, e in (st.adapter_ema or {}).items()}
        if plain:
            st.opt._table = None        # AdamW through its plain version
        if reg is not None:
            from vilco_tpu_torch.cl.regularizers import RegPenalty

            cl.penalty = RegPenalty.for_optimizer(reg, st.opt,
                                                  cfg.cl_cfg.reg_lambda)
            flags = dict(flags, cl_cfg=cfg.cl_cfg)
        step = make_train_step(torch.from_numpy(pts).to(device),
                               cfg.train_cfg, regularize=regularize,
                               ema_decay=PARITY_EMA_DECAY, **flags)
        t0 = time.perf_counter()
        with plain_versions() if plain else contextlib.nullcontext():
            met = step(st, batch_to(batch, device), cl)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        named = list(model.named_parameters())
        if params_only:     # the repeatability pairs read nothing else
            res = dict(params={n: p.detach().cpu() for n, p in named})
            del model, st
            return res
        mu, nu = st.opt.moments()
        res = dict(
            loss=met["final_loss"].item(), gnorm=met["grad_norm"].item(),
            grads={n: p.grad.cpu() for n, p in named},
            params={n: p.detach().cpu() for n, p in named},
            mu={n: t.cpu() for n, t in mu.items()},
            nu={n: t.cpu() for n, t in nu.items()}, secs=secs,
            metrics={k: v.item() for k, v in met.items()},
            bank=None if cl.memory_bank is None else cl.memory_bank.cpu(),
            ptr=None if cl.memory_ptr is None else int(cl.memory_ptr),
            ema={n: e.cpu() for n, e in (st.adapter_ema or {}).items()},
            ema0=ema0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        del model, st
        return res

    ref = run("cpu", False)
    card = run(dev, False)
    plain = run(dev, False, plain=True)
    ctrl = run(dev, True)
    torch.cuda.empty_cache()
    say(f"[{tag}] {m.variant.upper()}: one f32 step at batch 1, "
        f"T={m.max_seq_len}, schedule step {PARITY_STEP}: CPU "
        f"{ref['secs']:.1f} s, card {card['secs']:.3f} s (first call) "
        f"[{CARD}]")
    gaps = {}
    # card kernels vs CPU plain (the check); then the witness: the same
    # step on the card through the plain versions, which splits that gap
    # into the kernels' share (card kernels vs card plain: same GEMMs and
    # convs) and the libraries' share (card plain vs CPU plain)
    for label, r, base, base_label in (
            ("card", card, ref, "CPU"),
            ("TF32 control", ctrl, ref, "CPU"),
            ("kernel gap: card kernels", card, plain, "card plain"),
            ("library gap: card plain", plain, ref, "CPU")):
        g = gaps[label] = step_gaps(r, base)
        say_gaps(tag, label, r, base, base_label, g)
    c = gaps["card"]
    say(f"[{tag}] limits: loss and grad norm 1e-5 relative, "
        f"gradients {GRAD_RTOL:g} (the card, and the kernel gap alone), "
        f"updated params {PARAM_RTOL:g}, moments 2^-6; the TF32 control's "
        f"gradients read {gaps['TF32 control']['grads'][0]:.3e}")
    if c["params"][0] > PARAM_RTOL or max(c["mu"][0], c["nu"][0]) > 2.0 ** -6:
        fail(f"{tag}: updated parameters or moments out of "
             f"tolerance ({PARAM_RTOL:g}; 2^-6, two bf16 steps)")
    errs = leaf_errors(card["grads"], ref["grads"], 1e-4)
    if task is not None:
        for n in check_f64_witness(tag, cfg, task, batch, pts, ref, card,
                                   plain, ctrl):
            del errs[n]
    if max(c["loss"], c["gnorm"]) > 1e-5 or max(errs.values()) > GRAD_RTOL:
        fail(f"{tag}: out of tolerance")
    if gaps["kernel gap: card kernels"]["grads"][0] > GRAD_RTOL:
        fail(f"{tag}: the kernels alone move the gradients past the limit")
    if gaps["TF32 control"]["grads"][0] <= GRAD_RTOL:
        fail(f"{tag}: the check does not see TF32: limit too loose")
    if reg is not None:
        pen = (card["metrics"]["reg_penalty"], ref["metrics"]["reg_penalty"])
        rel = abs(pen[0] - pen[1]) / abs(pen[1])
        say(f"[{tag}] {cfg.cl_cfg.name.upper()} penalty at lambda "
            f"{cfg.cl_cfg.reg_lambda:g} over {len(reg)} task: card "
            f"{pen[0]:.6e}, CPU {pen[1]:.6e} (rel {rel:.3e}, tol 1e-5); the "
            f"step's loss before it {ref['loss']:.6f}")
        if rel > 1e-5 or not pen[1] > 0:
            fail(f"{tag}: the penalty's value out of tolerance")
    if task is not None:
        check_cl_state(tag, card, ref)
        return
    pair = lambda: [run(dev, False, regularize=True, params_only=True)
                    for _ in range(2)]
    say_repeatable(tag, m, "", *pair())
    for algorithms in (False, True):
        with deterministic_algorithms(algorithms) as ops:
            first, second = pair()
        how = (" under torch.use_deterministic_algorithms (warn only; ops "
               f"it names: {'; '.join(ops) if ops else 'none'}) and"
               if algorithms else "")
        say_repeatable(tag, m, f"{how} with cudnn.deterministic", first,
                       second)


def check_f64_witness(tag, cfg, task, batch, pts, ref, card, plain, ctrl):
    """The CL step's f32 gradients against the f64 step (step_gradients):
    each run's three worst leaves, then each leaf of F64_LIMITS, held there
    (the card against the f64 step within its limit, the TF32 control
    above it). Returns those leaves, which the caller leaves out of the
    card-vs-CPU check."""
    t0 = time.perf_counter()
    loss, want = step_gradients(cfg, task, batch, pts)
    say(f"[{tag}] f64 witness: the step's loss and gradients on the CPU in "
        f"f64 ({time.perf_counter() - t0:.1f} s), loss {loss:.9f}")
    runs = (("card", card), ("CPU", ref), ("card plain", plain),
            ("TF32 control", ctrl))
    errs = {label: leaf_errors(r["grads"], want, 1e-4) for label, r in runs}
    for label, r in runs:
        worst = sorted(errs[label].items(), key=lambda kv: -kv[1])[:3]
        say(f"[{tag}] f64 witness: {label} vs f64: loss rel "
            f"{abs(r['loss'] - loss) / abs(loss):.3e}; gradients "
            + ", ".join(f"{n} {e:.3e}" for n, e in worst))
    for n, lim in F64_LIMITS.items():
        say(f"[{tag}] f64 witness: {n} vs f64: "
            + ", ".join(f"{label} {errs[label][n]:.3e}" for label, _ in runs)
            + f"; limit {lim:g} (the card below, TF32 above)")
        if errs["card"][n] > lim:
            fail(f"{tag}: {n}'s gradient out of tolerance of the f64 step")
        if errs["TF32 control"][n] <= lim:
            fail(f"{tag}: {n}'s limit does not see TF32")
    return set(F64_LIMITS)


def ema_spacings(r):
    """Run r's adapter EMA after the step against its formula, e0 + (1 -
    PARITY_EMA_DECAY) (p - e0) from the first values e0 and the updated
    adapters p, in f32 spacings of the EMA's values: (the largest
    difference, the largest move of the formula). At decay 0.5 both
    products are exact and the sum rounds once, so the difference is at
    most half a spacing; most adapter elements move by only a few spacings
    in the parity step (their clipped gradients lie below AdamW's eps)."""
    eps, tiny = torch.finfo(torch.float32).eps, torch.finfo(torch.float32).tiny
    off = moved = 0.0
    for n, e0 in r["ema0"].items():
        spacing = (eps * r["ema"][n].abs()).clamp(min=tiny)
        step = (1.0 - PARITY_EMA_DECAY) * (r["params"][n] - e0)
        off = max(off, (((r["ema"][n] - e0) - step).abs()
                        / spacing).max().item())
        moved = max(moved, (step.abs() / spacing).max().item())
    return off, moved


def check_cl_state(tag, card, ref):
    """The CL step's terms and state, card against CPU: each loss term
    1e-5 relative, the memory bank BANK_RTOL of its largest value, the
    pointer equal, the adapter EMA PARAM_RTOL of each leaf's largest value
    (as the updated parameters); and on each side the EMA against its
    formula to one f32 spacing (ema_spacings), with the CPU's EMA moved by
    8 spacings or more somewhere, so that an EMA not updated, or at another
    decay, shows."""
    terms = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-30)
             for k, v in ref["metrics"].items()
             if k not in ("final_loss", "grad_norm", "num_pos")}
    bank = ((card["bank"] - ref["bank"]).abs().max()
            / ref["bank"].abs().max()).item()
    ema, worst_ema = rel_by_leaf(card["ema"], ref["ema"], 0.0)
    (off_cpu, moved), (off_card, _) = ema_spacings(ref), ema_spacings(card)
    say(f"[{tag}] CL terms card vs CPU: " + ", ".join(
        f"{k} {ref['metrics'][k]:.6f} (rel {e:.3e})"
        for k, e in terms.items())
        + f"; memory bank max rel err {bank:.3e} (tol {BANK_RTOL:g}), "
        f"pointer {card['ptr']} ({ref['ptr']}); adapter EMA at decay "
        f"{PARITY_EMA_DECAY:g} over {len(ref['ema'])} leaves: card vs CPU "
        f"{ema:.3e} ({worst_ema}; tol {PARAM_RTOL:g}); against its formula "
        f"CPU {off_cpu:.3f}, card {off_card:.3f} f32 spacings (tol 1), the "
        f"CPU's largest move {moved:.1f} spacings (at least 8)")
    if max(terms.values()) > 1e-5 or bank > BANK_RTOL or ema > PARAM_RTOL \
            or max(off_cpu, off_card) > 1.0 or moved < 8.0 \
            or card["ptr"] != ref["ptr"]:
        fail(f"{tag}: the CL terms or state out of tolerance")


@contextlib.contextmanager
def deterministic_algorithms(algorithms: bool):
    """cuDNN's deterministic mode and, with `algorithms`, PyTorch's
    deterministic algorithms, where an op with no deterministic CUDA kernel
    warns instead of raising; the list yielded collects those ops' names."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled(), \
        torch.backends.cudnn.deterministic
    ops = []
    torch.use_deterministic_algorithms(algorithms, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield ops
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]
    ops += sorted({("cuBLAS without CUBLAS_WORKSPACE_CONFIG"
                    if "CuBLAS" in str(w.message)
                    else str(w.message).split(" does not have")[0])
                   for w in caught if "determinis" in str(w.message)})


def say_repeatable(tag, m, how, first, second):
    """Report (not check) whether two f32 steps from the same state, rng
    and batch updated every parameter to the same bits (ROADMAP §3, F3)."""
    a, b = first["params"], second["params"]
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    what = "bitwise equal in every leaf"
    if diff:
        gap = (a[diff[0]] - b[diff[0]]).abs().max().item()
        what = (f"differ in {len(diff)} leaves, first {diff[0]} (max abs "
                f"{gap:.3e})")
    say(f"[{tag}] repeatability: two f32 {m.variant.upper()} steps with the "
        f"regularisers on, from the same state, rng and batch{how}: updated "
        f"parameters {what} ({len(a)} leaves)")


def phase_train(dev, tag: str, cfg, kernels, seed: int,
                normalised_must_fall: bool, task=None, reg_k: int = 0):
    """The train step of `cfg` (a Config) in bf16 with f32 masters and the
    regularisers on, at cfg.batch_size on one fixed synthetic batch, as CL
    task `task` of cfg's CL method (None: the naive method): 2 warm-up and
    10 timed steps, ms per step split into forward / backward / optimizer,
    every loss, peak memory, the launch counts of `kernels` (set to 0 just
    before), then one more step profiled. The losses must be finite and
    the loss before the normaliser (the sum the step's gradient follows)
    must fall; with `normalised_must_fall` the normalised loss too (the
    normaliser is an EMA from init_loss_norm toward the batch's positives,
    which can fall as fast as the loss). With `reg_k` > 0 every step
    carries cfg's EWC/MAS penalty over `reg_k` stacked tasks
    (synthetic_reg_tasks), and the penalty alone is timed at reg_k and at 1
    task (say_penalty_cost)."""
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import (
        batch_to,
        init_train_state,
        make_train_step,
    )

    m = cfg.model
    cl_model, flags, cl, prompt_mask = cl_step_setup(cfg, task,
                                                     cfg.batch_size, dev)
    model = PointTransformer(m, torch.Generator().manual_seed(SEED),
                             device=dev, cl=cl_model)
    st = init_train_state(model, cfg, steps_per_epoch=1, seed=SEED,
                          device=dev)
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).to(dev)
    if reg_k:
        from vilco_tpu_torch.cl.regularizers import RegPenalty

        lam = cfg.cl_cfg.reg_lambda
        pens = {k: RegPenalty.for_optimizer(
            synthetic_reg_tasks(model, k, seed), st.opt, lam)
            for k in (1, reg_k)}
        for pen in pens.values():
            say_penalty_cost(tag, pen, st.opt)
        cl.penalty = pens[reg_k]
        del pens
        flags = dict(flags, cl_cfg=cfg.cl_cfg)
        torch.cuda.empty_cache()
    step = make_train_step(pts, cfg.train_cfg, regularize=True,
                           compute_dtype=torch.bfloat16, **flags)
    batch = make_batch(np.random.default_rng(seed), cfg.batch_size, cfg)
    if prompt_mask is not None:
        batch["prompt_mask"] = prompt_mask
    batch = batch_to(batch, dev)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, walls, parts, terms = [], [], [], [], []
    for i in range(12):
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(st, batch, cl, marks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        losses.append(met["final_loss"].item())
        terms.append({k: v.item() for k, v in met.items()})
        norms.append(st.loss_normalizer.item())   # the one this loss used
        if i >= 2:
            walls.append(wall)
            ev = dict(marks)
            parts.append([ev["start"].elapsed_time(ev["forward"]),
                          ev["forward"].elapsed_time(ev["backward"]),
                          ev["backward"].elapsed_time(ev["optimizer"])])
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = [statistics.median(p[j] for p in parts) for j in range(3)]
    B = cfg.batch_size
    secs = sum(walls) / 1e3
    regs = (f"drop-path {m.droppath}"
            + (", XL dropout on" if m.variant == "mq" else "")
            + (f", dropout {m.dropout}" if m.dropout else "")
            + f", label smoothing {cfg.train_cfg.label_smoothing}"
            + ("" if task is None else
               f", CL method {cfg.cl_cfg.name} at task {task} (n_known "
               f"{flags['n_known']})")
            + ("" if not reg_k else
               f", {cfg.cl_cfg.name.upper()} penalty at lambda "
               f"{cfg.cl_cfg.reg_lambda:g} over {reg_k} stacked tasks"))
    say(f"[{tag}] {m.variant.upper()} flagship bf16 (f32 masters), batch "
        f"{B}, T={m.max_seq_len}, {regs}, {len(list(model.parameters()))} "
        f"leaves, {len(walls)} timed steps: {statistics.median(walls):.3f} "
        f"ms/step (median; forward {med[0]:.3f}, backward {med[1]:.3f}, "
        f"optimizer {med[2]:.3f} ms by CUDA events), "
        f"{len(walls) / secs:.3f} steps/s, {B * len(walls) / secs:.3f} "
        f"clips/s; peak memory {peak:.3f} GiB [{CARD}]")
    sums = [x * n for x, n in zip(losses, norms)]
    say(f"[{tag}] losses " + ", ".join(f"{x:.6f}" for x in losses))
    say(f"[{tag}] loss x normaliser (the sum before the normaliser) "
        + ", ".join(f"{x:.4f}" for x in sums))
    say(f"[{tag}] launches in the {len(losses)} steps: {launches}")
    if task is not None or reg_k:
        for k in ("al_loss", "reduce_sim", "ssl_loss", "reg_penalty"):
            if k in terms[0]:
                say(f"[{tag}] {k} " + ", ".join(f"{t[k]:.6f}"
                                                for t in terms))
    if not all(np.isfinite(losses)):
        fail(f"{tag}: a training loss is not finite")
    say(f"[{tag}] loss {losses[0]:.6f} -> {losses[-1]:.6f}; before the "
        f"normaliser (an EMA from {cfg.train_cfg.init_loss_norm:g} toward "
        f"the batch's positives) {sums[0]:.4f} -> {sums[-1]:.4f}")
    if not sums[-1] < sums[0] or (normalised_must_fall
                                  and not losses[-1] < losses[0]):
        fail(f"{tag}: the training loss did not decrease")
    if min(launches.values()) < 1:
        fail(f"{tag}: a kernel of the train path was never launched")
    phase_trace(f"{tag} step", lambda: step(st, batch, cl),
                statistics.median(walls))
    del model, st
    torch.cuda.empty_cache()
    return launches


# ---- the CL methods: EWC/MAS, iCaRL, BiC, gradient accumulation ----------

CL_TASK = 1          # CL task 1 of the graft flagship's 5: n_known 22, 44 seen
CL_STEPS = 6         # bf16 steps a method in cl_methods: 2 warm-up, 4 timed
REG_TASKS = 12       # nlq_train_ewc's stacked tasks: the NLQ yaml's 13th task
EXEMPLARS = 2        # iCaRL's exemplar clips a known class
PRIOR_MOVE = 1e-3    # the finished task's weights: the step's + N(0, 1e-3^2)
# cl_parity's grad norm: at these CL steps it is the norm of stem_0's ln1
# and channel-attention projection biases (1e4-5e4 in L2 at the graft
# flagship's init, sums over every position), card vs CPU 6.2e-6 to 2.0e-5
# (H100 80GB HBM3, 700 W); every leaf is held at GRAD_RTOL beside it
CL_GNORM_RTOL = 1e-4


def importance_tasks(cfg, dev, mode: str, seed: int):
    """One finished task's [(importance, optpar)] on the CPU: the port's
    estimate_importance (`mode`) over two batch-1 batches on `dev`, every
    class seen, from init_loss_norm, of cfg's model drawn from SEED (the
    train parity's) with every weight moved by N(0, PRIOR_MOVE^2) (a seeded
    CPU draw): the step then starts PRIOR_MOVE from the optpar, so that
    the penalty and its gradient are neither 0 nor the whole step's."""
    from vilco_tpu_torch.cl.regularizers import estimate_importance
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import CLBatchExtras, batch_to

    m = cfg.model
    model = PointTransformer(m, torch.Generator().manual_seed(SEED),
                             device="cpu")
    redraw_adapters(model)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * PRIOR_MOVE)
    model.to(dev)
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).to(dev)
    batches = [batch_to(make_batch(np.random.default_rng(seed + i), 1, cfg),
                        dev) for i in range(2)]
    cl = CLBatchExtras(torch.ones(m.num_classes, dtype=torch.bool,
                                  device=dev))
    imp, opt, _ = estimate_importance(
        model, pts, batches, cl,
        torch.tensor(cfg.train_cfg.init_loss_norm, device=dev),
        cfg.train_cfg, mode)
    del model
    return [({n: v.cpu() for n, v in imp.items()},
             {n: v.cpu() for n, v in opt.items()})]


def synthetic_reg_tasks(model, k: int, seed: int):
    """`k` finished tasks' [(importance, optpar)] for the model's every
    state_dict leaf, on its device: importance (1e-3 N(0, 1))^2, optpar the
    leaf + 1e-3 N(0, 1) (a seeded draw)."""
    out = []
    sd = model.state_dict()
    dev = next(iter(sd.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda t: torch.randn(t.shape, generator=gen, device=dev) * 1e-3
    for _ in range(k):
        out.append(({n: rnd(t).square() for n, t in sd.items()},
                    {n: t.detach().float() + rnd(t) for n, t in sd.items()}))
    return out


def say_penalty_cost(tag, pen, opt) -> None:
    """The penalty alone (RegPenalty.apply into a copy of the gradients):
    device ms by events, kernel launches a call (the profiler), and the
    bound of the bytes it must move (A, -B in f64, theta read, the
    gradient read and written in f32: 28 bytes an element)."""
    from torch.profiler import ProfilerActivity, profile

    g = opt.grad_flat.clone()
    fn = lambda: pen.apply(opt.param_flat, g)
    ms = median_ms(fn, reps=10)
    # the largest count of three traces: a trace can lose some or all of
    # its device records (0, 3.3 and 4 of 11 seen in one of two traces)
    reps, n_kernels = 3, 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n_kernels = max(n_kernels, sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / reps)
    if not n_kernels:
        fail(f"{tag}: the profiler saw none of the penalty's kernels")
    n = opt.param_flat.numel()
    bms, _ = bound(0.0, 28.0 * n, torch.float32)
    say(f"[{tag}] the penalty alone over {pen.num_tasks} stacked tasks, "
        f"{len(opt.params)} leaves, {n} elements: {ms:.4f} ms a step by "
        f"events, {n_kernels:g} kernel launches a call, bound {bms:.4f} ms "
        f"(bytes) [{CARD}]")


def cl_config(full, method: str, accumulation_steps: int = 1):
    """`full` (a Config) with CL method `method` and `accumulation_steps`,
    its other cl_cfg fields kept (dist_factor 0.01)."""
    return dataclasses.replace(
        full, cl_cfg=dataclasses.replace(full.cl_cfg, name=method),
        opt=dataclasses.replace(full.opt,
                                accumulation_steps=accumulation_steps))


def cl_task(cfg, dev):
    """(class mask of CL task CL_TASK on `dev`, n_known)."""
    c = cfg.cl_cfg.classes_per_task
    return (torch.arange(cfg.model.num_classes, device=dev)
            < (CL_TASK + 1) * c), CL_TASK * c


def bic_state(cfg):
    """A BicState after task 0 (its pair (0.9, 0.1)) with task CL_TASK
    registered."""
    from vilco_tpu_torch.cl.bic import BicState

    c = cfg.cl_cfg.classes_per_task
    bic = BicState(cfg.model.num_classes, cfg.cl_cfg.num_tasks)
    bic.register_task(0, range(c))
    bic.alphas[0], bic.betas[0] = 0.9, 0.1
    bic.register_task(CL_TASK, range(c, 2 * c))
    return bic


def phase_cl_methods(dev, full, kernels):
    """The graft flagship's other CL methods as CL task CL_TASK (n_known
    22, classes 0-43 seen), batch 2, bf16 with f32 masters, drop-path and
    XL dropout on, one model trained on through the phase: CL_STEPS steps
    (2 warm-up) of iCaRL (targets: snapshot_targets of the serving copy's
    logits on the batch), of BiC (task 0's pair (0.9, 0.1) on classes
    0-21, softmax-T targets) followed by 3 of BiC's stage-2 steps on a
    held-out batch, and of the naive step at accumulation 2; ms per step,
    every term. Then one serving request at batch 16 (a bf16 copy of the
    model, eval step, BiC's bias, iCaRL's filter, decode + soft-NMS):
    exemplar means from EXEMPLARS clips of each known class; the distances
    and keep mask of 2 of the request's clips against the direct form in
    f32 (max rel gap 1e-5, flips counted, at most 1e-4 of the bits), the
    filter holding -1e9 exactly where it drops.
    The launch counts of `kernels` over the phase (set to 0 just before).
    Returns them."""
    from vilco_tpu_torch.cl.bic import make_bias_stage2_step
    from vilco_tpu_torch.cl.icarl import (
        adjust_eval_outputs,
        compute_exemplar_means,
        distance_keep_mask,
        level_distances,
    )
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.ops.decode import decode_and_nms_batch
    from vilco_tpu_torch.train.engine import (
        CLBatchExtras,
        batch_to,
        init_train_state,
        make_eval_step,
        make_train_step,
        snapshot_targets,
    )

    tag = "cl_methods"
    m, t = full.model, full.test_cfg
    C = m.num_classes
    mask, n_known = cl_task(full, dev)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    model = PointTransformer(m, torch.Generator().manual_seed(SEED),
                             device=dev)
    st = init_train_state(model, full, steps_per_epoch=1, seed=SEED,
                          device=dev)
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).to(dev)
    rng = np.random.default_rng(SEED + 20)
    batch = batch_to(make_batch(rng, full.batch_size, full), dev)
    heldout = batch_to(make_batch(rng, full.batch_size, full), dev)

    def serving_copy():
        return copy.deepcopy(model).eval().to(torch.bfloat16)

    def train(label, method, cl, K=1):
        c = cl_config(full, method, K)
        step = make_train_step(pts, c.train_cfg, regularize=True,
                               compute_dtype=torch.bfloat16, cl_cfg=c.cl_cfg,
                               n_known=n_known, accumulation_steps=K)
        walls, terms = [], []
        for i in range(CL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(st, batch, cl)
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
            terms.append({k: v.item() for k, v in met.items()})
        if not all(np.isfinite(v) for tm in terms for v in tm.values()):
            fail(f"{tag}: {label}: a term is not finite")
        keys = [k for k in ("final_loss", "dist_loss", "cls_loss",
                            "grad_norm") if k in terms[0]]
        say(f"[{tag}] {label}: {len(walls)} timed bf16 steps at batch "
            f"{full.batch_size}{f' ({K} micro-batches)' if K > 1 else ''}, "
            f"{statistics.median(walls):.3f} ms/step (median) [{CARD}]")
        for k in keys:
            say(f"[{tag}] {label} {k} " + ", ".join(f"{tm[k]:.6f}"
                                                   for tm in terms))
        return terms

    with torch.no_grad():
        logits = serving_copy()(batch["feats"], batch["mask"])["cls_logits"]
    icarl = train("iCaRL", "icarl", CLBatchExtras(
        mask, prev_logits=snapshot_targets(logits, "icarl", n_known)))
    bic = bic_state(full)
    a, b = (torch.from_numpy(x).to(dev) for x in bic.per_class(0))
    bic_terms = train("BiC", "bic", CLBatchExtras(
        mask, prev_logits=snapshot_targets(logits, "bic", n_known),
        bias_alpha=a, bias_beta=b))
    if min(icarl[0]["dist_loss"], bic_terms[0]["dist_loss"]) <= 0:
        fail(f"{tag}: a distillation term is not positive")
    step2, init2 = make_bias_stage2_step(model, pts, full.train_cfg, CL_TASK,
                                         bic.class_task)
    bias = init2()
    a1, b1 = (torch.from_numpy(x).to(dev) for x in bic.per_class(CL_TASK))
    cl2 = CLBatchExtras(mask, bias_alpha=a1, bias_beta=b1)
    t0 = time.perf_counter()
    for _ in range(3):
        bias, met2 = step2(bias, heldout, cl2, st.loss_normalizer)
    torch.cuda.synchronize()
    s2_ms = (time.perf_counter() - t0) * 1e3 / 3
    bic.alphas[CL_TASK] = bias["alpha"].item()
    bic.betas[CL_TASK] = bias["beta"].item()
    say(f"[{tag}] BiC stage 2: 3 SGD steps (lr 1e-3) on task {CL_TASK}'s "
        f"pair, the model frozen: alpha {bic.alphas[CL_TASK]:.6f}, beta "
        f"{bic.betas[CL_TASK]:.6f}, loss {met2['final_loss'].item():.6f}, "
        f"{s2_ms:.3f} ms/step [{CARD}]")
    if (bic.alphas[CL_TASK], bic.betas[CL_TASK]) == (1.0, 0.0):
        fail(f"{tag}: BiC's stage 2 did not move the pair")
    train("naive at accumulation 2", "naive", CLBatchExtras(mask), K=2)

    # serving: BiC's bias and iCaRL's filter on one request at batch 16
    serve = serving_copy()
    evaluate = make_eval_step(serve)
    ex = np.random.default_rng(SEED + 21).standard_normal(
        (n_known * EXEMPLARS, m.max_seq_len, m.input_dim)).astype(np.float32)
    ex = torch.from_numpy(ex).to(dev, torch.bfloat16)
    full_mask = torch.ones(ex.shape[:2], dtype=torch.bool, device=dev)

    def feats_fn(vids):
        out = evaluate({"feats": ex[vids], "mask": full_mask[vids]})
        return list(out["fpn_feats"])

    t0 = time.perf_counter()
    means, valid = compute_exemplar_means(
        feats_fn, {c: [EXEMPLARS * c + j for j in range(EXEMPLARS)]
                   for c in range(n_known)}, C)
    torch.cuda.synchronize()
    means_s = time.perf_counter() - t0
    feats, fmask = mq_requests(m, dev, 1)[0]
    ab = tuple(torch.from_numpy(x).to(dev)
               for x in bic.per_class(bic.num_tasks_seen - 1))
    marks = []
    with torch.no_grad():
        mark_ev = lambda: marks.append(torch.cuda.Event(enable_timing=True))
        mark_ev()
        marks[-1].record()
        out = evaluate({"feats": feats, "mask": fmask})
        mark_ev()
        marks[-1].record()
        adj = adjust_eval_outputs(out, ab, means, valid)
        mark_ev()
        marks[-1].record()
        det = decode_and_nms_batch(
            pts, adj["cls_logits"], adj["offsets"], adj["fpn_mask"], mask,
            num_classes=C, pre_nms_topk=t.pre_nms_topk,
            pre_nms_thresh=t.pre_nms_thresh,
            duration_thresh=t.duration_thresh, max_seg_num=t.max_seg_num,
            min_score=t.min_score, nms_sigma=t.nms_sigma,
            voting_thresh=t.voting_thresh)
        mark_ev()
        marks[-1].record()
        torch.cuda.synchronize()
        two = [f[:2] for f in out["fpn_feats"]]
        keep = distance_keep_mask(out["fpn_feats"], means, valid)
        direct = distance_keep_mask(two, means, valid, chunk=C)
        gap = max(((level_distances(f, mm)[:2] - d).abs().max() / d.abs()
                   .max()).item() for f, mm, d in zip(
                       out["fpn_feats"], means,
                       (level_distances(f2, mm, C)
                        for f2, mm in zip(two, means))))
    adjust = lambda: adjust_eval_outputs(out, ab, means, valid)
    adj_ms = median_ms(adjust, reps=5)
    by_kernel = device_ms_by_kernel(adjust, reps=3, warmup=1)
    flips = int((keep[:2] != direct).sum())
    want = torch.where(keep, out["cls_logits"] * ab[0] + ab[1],
                       torch.full_like(out["cls_logits"], -1e9))
    filt_ok = torch.equal(adj["cls_logits"], want)
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(3)]
    say(f"[{tag}] serving with BiC's bias and iCaRL's filter, batch "
        f"{feats.shape[0]} bf16, the first request: forward {ms[0]:.3f} ms, "
        f"bias + keep mask {ms[1]:.3f} ms, decode + soft-NMS {ms[2]:.3f} ms "
        f"(CUDA events; bias + keep mask again, warm: {adj_ms:.3f} ms); "
        f"exemplar means of {n_known} classes x {EXEMPLARS} clips in "
        f"{means_s:.3f} s; keep share {keep.float().mean().item():.4f}; "
        f"2 clips against the direct form in f32: distances max rel gap "
        f"{gap:.3e} (tol 1e-5), keep bits flipped {flips} of "
        f"{direct.numel()} (tol 1e-4 of them); filter exact: {filt_ok} "
        f"[{CARD}]")
    say(f"[{tag}] bias + keep mask, {sum(by_kernel.values()):.4f} device "
        "ms; by kernel (profiler): " + ", ".join(
            f"{short_name(k)[:60]} {v:.4f}" for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:5]) + f" [{CARD}]")
    if (gap > 1e-5 or flips > 1e-4 * direct.numel() or not filt_ok
            or not 0 < keep.float().mean().item() < 1):
        fail(f"{tag}: the iCaRL filter or the keep mask is wrong")
    if not (torch.isfinite(det.segs).all() and torch.isfinite(det.scores)
            .all()):
        fail(f"{tag}: non-finite detections")
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say(f"[{tag}] peak memory {peak:.3f} GiB; launches in the phase: "
        f"{launches}")
    if min(launches.values()) < 1:
        fail(f"{tag}: a kernel of the path was never launched")
    del model, st, serve
    torch.cuda.empty_cache()
    return launches


def cl_step_result(device, full, template, method, K, batch, prev=None,
                   bias=None):
    """One f32 train step of `full` under `method` at accumulation K, CL
    task CL_TASK, regularisers off, from a copy of `template` (SEED's
    model on the CPU) at schedule step PARITY_STEP, on `device`: the
    result dict step_gaps reads, plus the metrics."""
    from vilco_tpu_torch.models.point_transformer import level_lengths
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import (
        CLBatchExtras,
        batch_to,
        init_train_state,
        make_train_step,
    )

    m = full.model
    c = cl_config(full, method, K)
    mask, n_known = cl_task(full, device)
    model = copy.deepcopy(template)
    st = init_train_state(model, c, steps_per_epoch=1, seed=SEED,
                          device=device)
    st.opt.count = PARITY_STEP
    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range)).to(device)
    step = make_train_step(pts, c.train_cfg, regularize=False,
                           cl_cfg=c.cl_cfg, n_known=n_known,
                           accumulation_steps=K)
    ab = {} if bias is None else dict(bias_alpha=bias[0].to(device),
                                      bias_beta=bias[1].to(device))
    cl = CLBatchExtras(mask, prev_logits=None if prev is None
                       else prev.to(device), **ab)
    t0 = time.perf_counter()
    met = step(st, batch_to(batch, device), cl)
    secs = time.perf_counter() - t0
    named = list(model.named_parameters())
    mu, nu = st.opt.moments()
    res = dict(loss=met["final_loss"].item(), gnorm=met["grad_norm"].item(),
               grads={n: p.grad.cpu() for n, p in named},
               params={n: p.detach().cpu() for n, p in named},
               mu={n: x.cpu() for n, x in mu.items()},
               nu={n: x.cpu() for n, x in nu.items()}, secs=secs,
               metrics={k: v.item() for k, v in met.items()})
    del model, st
    return res


def phase_cl_parity(dev):
    """--cl-methods: the graft flagship's CL steps in f32 (TF32 off), the
    card against the CPU from the same weights and batch, as CL task
    CL_TASK: iCaRL and BiC at batch 1 (targets from snapshot_targets of
    N(0, 2^2) logits; BiC with task 0's pair), the naive step at
    accumulation 2 over a batch of 2: loss and the method's term 1e-5,
    grad norm CL_GNORM_RTOL, gradients GRAD_RTOL, updated parameters
    PARAM_RTOL, moments 2^-6, the leaves of the largest gradients printed; then BiC's stage 2 (3 steps on task 1's pair; its moves of alpha
    and beta GRAD_RTOL) and MAS's importance over two batch-1 batches
    (GRAD_RTOL a leaf, as gradients; the normaliser 1e-6); then VQ's HNM
    step with an EWC penalty at accumulation 2 (phase_vq_train_parity)."""
    from vilco_tpu_torch.cl.bic import make_bias_stage2_step
    from vilco_tpu_torch.cl.regularizers import estimate_importance
    from vilco_tpu_torch.core.config import flagship_config
    from vilco_tpu_torch.data.synthetic import make_batch
    from vilco_tpu_torch.models.point_transformer import (
        PointTransformer,
        level_lengths,
    )
    from vilco_tpu_torch.ops.assign import generate_points
    from vilco_tpu_torch.train.engine import (
        CLBatchExtras,
        batch_to,
        snapshot_targets,
    )

    tag = "cl_parity"
    full = flagship_config()
    m = full.model
    C, P = m.num_classes, sum(level_lengths(m))
    rng = np.random.default_rng(SEED + 30)
    b2 = make_batch(rng, 2, full)
    b1 = {k: v[:1] for k, v in b2.items()}
    logits = torch.from_numpy(
        (2 * rng.standard_normal((1, P, C))).astype(np.float32))
    _, n_known = cl_task(full, "cpu")
    bic = bic_state(full)
    bias = tuple(torch.from_numpy(x) for x in bic.per_class(0))
    template = PointTransformer(m, torch.Generator().manual_seed(SEED),
                                device="cpu")
    for label, method, K, batch, prev, bb, term in (
            ("iCaRL", "icarl", 1, b1,
             snapshot_targets(logits, "icarl", n_known), None, "dist_loss"),
            ("BiC", "bic", 1, b1, snapshot_targets(logits, "bic", n_known),
             bias, "dist_loss"),
            ("accumulation 2", "naive", 2, b2, None, None, "cls_loss")):
        ref = cl_step_result("cpu", full, template, method, K, batch, prev,
                             bb)
        card = cl_step_result(dev, full, template, method, K, batch, prev,
                              bb)
        g = step_gaps(card, ref)
        say_gaps(tag, f"{label}: card", card, ref, "CPU", g)
        norms = sorted(((w.norm().item(), n) for n, w in ref["grads"].items()),
                       reverse=True)[:3]
        say(f"[{tag}] {label}: the largest gradients (L2 norm, CPU; card's "
            "rel gap): " + ", ".join(
                f"{n} {v:.4e} ({(card['grads'][n] - ref['grads'][n]).norm() / v:.2e})"
                for v, n in norms))
        t_rel = abs(card["metrics"][term] - ref["metrics"][term]) \
            / abs(ref["metrics"][term])
        say(f"[{tag}] {label}: {term} card {card['metrics'][term]:.6f}, CPU "
            f"{ref['metrics'][term]:.6f} (rel {t_rel:.3e}); CPU "
            f"{ref['secs']:.1f} s, card {card['secs']:.3f} s")
        if (max(g["loss"], t_rel) > 1e-5 or g["gnorm"] > CL_GNORM_RTOL
                or g["grads"][0] > GRAD_RTOL or g["params"][0] > PARAM_RTOL
                or max(g["mu"][0], g["nu"][0]) > 2.0 ** -6):
            fail(f"{tag}: {label} out of tolerance")

    pts = torch.from_numpy(generate_points(
        level_lengths(m), m.fpn_strides, m.regression_range))
    moves, imps = {}, {}
    for device in ("cpu", dev):
        model = copy.deepcopy(template).to(device)
        mask = cl_task(full, device)[0]
        step2, init2 = make_bias_stage2_step(
            model, pts.to(device), full.train_cfg, CL_TASK, bic.class_task)
        a1, be1 = (torch.from_numpy(x).to(device)
                   for x in bic.per_class(CL_TASK))
        bias2 = init2()
        for _ in range(3):
            bias2, _ = step2(bias2, batch_to(b1, device),
                             CLBatchExtras(mask, bias_alpha=a1,
                                           bias_beta=be1),
                             torch.tensor(full.train_cfg.init_loss_norm,
                                          device=device))
        moves[str(device)] = (bias2["alpha"].item() - 1.0,
                              bias2["beta"].item())
        batches = [batch_to({k: v[i:i + 1] for k, v in b2.items()}, device)
                   for i in range(2)]
        imp, _, norm = estimate_importance(
            model, pts.to(device), batches,
            CLBatchExtras(torch.ones(C, dtype=torch.bool, device=device)),
            torch.tensor(full.train_cfg.init_loss_norm, device=device),
            full.train_cfg, "mas")
        imps[str(device)] = ({n: v.cpu() for n, v in imp.items()},
                             norm.item())
        del model
    (ca, cb), (ra, rb) = moves[str(dev)], moves["cpu"]
    mv = max(abs(ca - ra) / abs(ra), abs(cb - rb) / abs(rb))
    say(f"[{tag}] BiC stage 2, 3 steps: alpha - 1 card {ca:.6e} CPU "
        f"{ra:.6e}, beta card {cb:.6e} CPU {rb:.6e}: max rel {mv:.3e} (tol "
        f"{GRAD_RTOL:g}) [{CARD}]")
    worst, names = rel_by_leaf(imps[str(dev)][0], imps["cpu"][0], 1e-4)
    nrel = abs(imps[str(dev)][1] - imps["cpu"][1]) / imps["cpu"][1]
    say(f"[{tag}] MAS importance over 2 batches, card vs CPU: max rel err "
        f"{worst:.3e} ({names}; tol {GRAD_RTOL:g}), normaliser "
        f"{imps['cpu'][1]:.6f} (rel {nrel:.3e}, tol 1e-6) [{CARD}]")
    if mv > GRAD_RTOL or worst > GRAD_RTOL or nrel > 1e-6 or ra == 0:
        fail(f"{tag}: BiC's stage 2 or MAS's importance out of tolerance")
    torch.cuda.empty_cache()
    phase_vq_train_parity(dev, SEED, tag="vq_cl_parity",
                          batch_size=2 * VQ_PARITY_BATCH,
                          accumulation_steps=2, reg_k=1)


# ---- the MQ flagship as configs/mq_vilco.yaml runs it --------------------

YAML_TASK = 1        # CL task 1 of 5: n_known 22, the AL, SSL and pull on
YAML_PARITY_KEYS = ("cls_logits", "offsets", "reduce_sim", "narration_feat",
                    "video_feat")
# leaves of the CL step held against the f64 step, with their limits. The
# first embedding conv's weight gradient: the card's f32 forward puts a few
# elements of the two embedding ReLUs' inputs, within 4e-7 of 0, on the
# other side of 0 from the f64 step (the CPU's f32 none), and the ReLU then
# drops or passes the whole gradient there; that leaf's sum cancels to
# ~1e-4 of its terms, so those few elements move it by 2.3e-3 of its
# largest value. vilco_tpu_torch/tools/yaml_grad_probe.py (H100 80GB HBM3,
# 700.00 W) read it at 2.313e-3 to 2.334e-3 against the f64 step with the
# CL terms on (SSL off: 2.6e-4), the CPU at 1.1e-6, and the TF32 control
# at 3.52e-3 to 3.535e-3; every other leaf of the card lies within
# GRAD_RTOL of the CPU
F64_LIMITS = {"backbone.embd_0.weight": 3e-3}


def yaml_calls(full):
    """K1's calls in one forward of the yaml model `full` (a Config), as
    (Tq, Tk, count): the text stem at the prompted text length, the video
    stem, each branch block's strided self-attention, and the branch
    blocks' cross-attention to the text; then K3's (T, stride, count)."""
    from vilco_tpu_torch.models.backbone import CROSS_MODAL_SKIP_LEVELS

    m, c = full.model, full.cl_cfg
    T0, n_stem, nb = m.max_seq_len, m.backbone_arch[1], m.num_branch_layers
    L = full.max_text_len + c.topk * c.length
    k1 = ([(L, L, n_stem), (T0, T0, n_stem)]
          + [(T0 >> (i + 1), T0 >> (i + 1), 1) for i in range(nb)]
          + [(T0 >> (i + 1), L, 1) for i in range(nb)
             if i not in CROSS_MODAL_SKIP_LEVELS])
    k3 = [(L, 1, n_stem), (T0, 1, n_stem)] + [(T0 >> i, 2, 1)
                                               for i in range(nb)]
    return k1, k3


def yaml_text_mask(rng, B, full, dev):
    """The text keys' mask as the yaml model builds it: the prompt pool's
    top_k x length prompts, all valid, then 4..L text tokens (the last row
    only the prompts)."""
    c, L = full.cl_cfg, full.max_text_len
    tl = rng.integers(4, L + 1, size=B)
    tl[-1] = 0
    m = np.concatenate([np.ones((B, c.topk * c.length), bool),
                        np.arange(L)[None, :] < tl[:, None]], 1)
    return torch.from_numpy(m).to(dev)


def phase_yaml_kernels(dev):
    """The kernels at the shapes the yaml model adds to the graft flagship's
    (which phase_kernels and phase_train_kernels check): K1 over the
    prompted text (Tk = 128 + 80 = 208, the last key tile 16 keys) as the
    text stem's self-attention and the branch blocks' cross-attention (Tq
    512 down to 2), forward at batch 16 and backward at batch 2 (its dk/dv
    pass over query slices); K3 at T=208, forward and backward; AdamW over
    the yaml model's 560 leaves. bf16 and f32, each output against its
    limit, SDPA beside K1."""
    from vilco_tpu_torch.core.config import mq_yaml_config
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        dkv_splits,
        fused_attention_blc,
        fused_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
        fused_dwconv_qkv_plain,
    )

    full = mq_yaml_config()
    cfg = full.model
    T0, C, H = cfg.max_seq_len, cfg.embd_dim, cfg.n_head
    D = C // H
    k1, _ = yaml_calls(full)
    L = k1[0][1]
    shapes = [(Tq, Tk) for Tq, Tk, _ in k1 if Tk == L]
    rng = np.random.default_rng(SEED + 10)
    chk = KernelChecks("mq_yaml_kernels", (
        "attn_text", "attn_cross", "attn_bwd_text", "attn_bwd_cross", "dw",
        "dw_bwd", "adamw"))
    bf16 = torch.bfloat16

    def randn(*shape, dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    for dtype in (bf16, torch.float32):
        for B, backward in ((B_SERVE, False), (B_TRAIN, True)):
            for Tq, Tk in shapes:
                what = "text" if Tq == Tk else "cross"
                q, g = (randn(B, Tq, C, dtype=dtype) for _ in range(2))
                k, v = (randn(B, Tk, C, dtype=dtype) for _ in range(2))
                m = yaml_text_mask(rng, B, full, dev)
                bh = lambda x: x.reshape(B, -1, H, D).transpose(1, 2)
                am = m[:, None, None, :]
                sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                    bh(a), bh(b), bh(c), attn_mask=am)
                label = (f"{'text self' if Tq == Tk else 'cross'}-attention"
                         f" B={B} Tq={Tq} Tk={Tk} C={C} H={H}")
                top = dtype == bf16 and Tq in (L, T0 >> 1)
                if not backward:
                    with torch.no_grad():
                        out = fused_attention_blc(q, k, v, m, H)
                        ref = fused_attention_blc_plain(q, k, v, m, H)
                    chk.report(f"attn_{what}", f"attention forward {label}",
                               dtype, output_errors(("out",), [out], [ref],
                                                    FWD_TOL[dtype]),
                               lambda: attention_fwd_cuda(q, k, v, m, H,
                                                          False),
                               lambda: fused_attention_blc_plain(q, k, v, m,
                                                                 H),
                               attention_work(Tq, m, C, dtype, False),
                               lambda: sdpa(q, k, v), is_top=top)
                    continue
                got = grads_of(lambda *a: fused_attention_blc(*a, m, H),
                               (q, k, v), g)
                want = grads_of(
                    lambda *a: fused_attention_blc_plain(*a, m, H),
                    (q, k, v), g)
                o, lse = attention_fwd_cuda(q, k, v, m, H, with_lse=True)
                check_repeatable(
                    "mq_yaml_kernels", f"attention backward {label} "
                    f"{str(dtype)[6:]} ({dkv_splits(B, H, Tq, Tk)} query "
                    "slices)",
                    lambda: attention_bwd_cuda(q, k, v, m, o, lse, g, H))
                chk.report(f"attn_bwd_{what}", f"attention backward {label}",
                           dtype, output_errors(("dq", "dk", "dv"), got,
                                                want, TRAIN_TOL[dtype]),
                           lambda: attention_bwd_cuda(q, k, v, m, o, lse, g,
                                                      H),
                           backward_timer(
                               lambda *a: fused_attention_blc_plain(*a, m,
                                                                    H),
                               (q, k, v), g),
                           attention_work(Tq, m, C, dtype, True),
                           backward_timer(sdpa, (q, k, v), bh(g)),
                           is_top=top, queued=True)
        # K3 at the text stem's T=208, stride 1
        w = randn(3, 3, C, dtype=dtype, scale=0.3)
        wg = w.float().permute(2, 0, 1).reshape(3 * C, 1, 3).to(dtype)
        x = randn(B_SERVE, L, C, dtype=dtype)
        xt = x.transpose(1, 2)
        with torch.no_grad():
            rows = output_errors(("q", "k", "v"), fused_dwconv_qkv(x, w, 1),
                                 fused_dwconv_qkv_plain(x, w, 1),
                                 FWD_TOL[dtype])
        chk.report("dw", f"dwconv forward B={B_SERVE} T={L} C={C} stride=1",
                   dtype, rows, lambda: fused_dwconv_qkv(x, w, 1),
                   lambda: fused_dwconv_qkv_plain(x, w, 1),
                   dwconv_work(B_SERVE, L, C, 1, dtype, backward=False),
                   lambda: F.conv1d(xt, wg, padding=1, groups=C),
                   is_top=dtype == bf16, also_queued=True)
        x = randn(B_TRAIN, L, C, dtype=dtype)
        gs = tuple(randn(B_TRAIN, L, C, dtype=dtype) for _ in range(3))
        got = grads_of(lambda a, b: fused_dwconv_qkv(a, b, 1), (x, w), gs)
        want = grads_of(lambda a, b: fused_dwconv_qkv_plain(a, b, 1), (x, w),
                        gs)
        gcat = torch.stack(gs, -1).reshape(B_TRAIN, L, 3 * C).transpose(1, 2)
        label = f"dwconv backward B={B_TRAIN} T={L} C={C} stride=1"
        check_repeatable("mq_yaml_kernels", f"{label} {str(dtype)[6:]}",
                         lambda: dwconv_bwd_cuda(x, w, *gs, 1))
        chk.report("dw_bwd", label, dtype,
                   output_errors(("dx", "dw"), got, want, TRAIN_TOL[dtype]),
                   lambda: dwconv_bwd_cuda(x, w, *gs, 1),
                   backward_timer(lambda a, b: fused_dwconv_qkv_plain(a, b, 1),
                                  (x, w), gs),
                   dwconv_work(B_TRAIN, L, C, 1, dtype, backward=True),
                   backward_timer(lambda a, b: F.conv1d(
                       a.transpose(1, 2), b, padding=1, groups=C), (x, wg),
                       gcat),
                   is_top=dtype == bf16, also_queued=True)
        torch.cuda.empty_cache()
    check_adamw(chk, *point_transformer_leaves(cfg, dev, full.cl_cfg),
                torch.bfloat16)
    if not chk.ok:
        fail("a kernel disagrees with its plain version at the yaml shapes")
    return chk.errs, chk.top


def mq_yaml_inputs(rng, B, full, dev, dtype):
    """A batch of the yaml model's inputs: features and text as
    nlq_inputs draws them, then narration tokens (1..Ln valid) and every
    clip's narration valid."""
    feats, mask, text, tmask = nlq_inputs(rng, B, full, dev, dtype)
    Ln, c = full.max_narration_len, full.cl_cfg
    nar = rng.standard_normal((B, Ln, c.narration_dim)).astype(np.float32)
    nl = rng.integers(1, Ln + 1, size=B)
    to = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)
    return (feats, mask, text, tmask, to(nar, dtype),
            to(np.arange(Ln)[None, :] < nl[:, None]),
            torch.ones(B, dtype=torch.bool, device=dev))


def mq_yaml(dev, yaml):
    """The yaml model's phases: its kernels' new shapes, parity, serving
    through the adapter ensemble, the train step's parity and training as
    CL task YAML_TASK; each serving request's and train step's launches
    checked against the model's structure. Returns the kernel errors and
    timings and the launch counts."""
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        fused_attention_blc,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
    )
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_rel_attention,
    )

    errs, top = phase_yaml_kernels(dev)
    phase_parity(dev, "mq_yaml_parity", yaml.model,
                 mq_yaml_inputs(np.random.default_rng(SEED + 11), 1, yaml,
                                "cpu", torch.float32),
                 cl=yaml.cl_cfg, keys=YAML_PARITY_KEYS)
    k1, k3 = yaml_calls(yaml)
    per_fwd = {"fused_attention_blc": sum(n for *_, n in k1),
               "fused_dwconv_qkv": sum(n for *_, n in k3),
               "xl_rel_attention": 1}
    rng = np.random.default_rng(SEED + 12)
    requests = [nlq_inputs(rng, B_SERVE, yaml, dev, torch.bfloat16)
                for _ in range(7)]
    serve = phase_serve(dev, "mq_yaml_serve", yaml, requests,
                        (fused_attention_blc, xl_rel_attention,
                         fused_dwconv_qkv), cl=yaml.cl_cfg)
    check_launches("mq_yaml_serve", serve,
                   {k: 2 * n for k, n in per_fwd.items()}, len(requests),
                   "request")
    del requests
    phase_train_parity(dev, "mq_yaml_train_parity", yaml, task=YAML_TASK)
    train = phase_train(
        dev, "mq_yaml_train", yaml,
        (fused_attention_blc, attention_bwd_cuda, xl_rel_attention,
         xl_bwd_cuda, fused_dwconv_qkv, dwconv_bwd_cuda, adamw_update_multi),
        SEED + 13, normalised_must_fall=False, task=YAML_TASK)
    check_launches("mq_yaml_train", train,
                   {**per_fwd, "attention_bwd_cuda": per_fwd[
                       "fused_attention_blc"], "xl_bwd_cuda": 1,
                    "dwconv_bwd_cuda": per_fwd["fused_dwconv_qkv"],
                    "adamw_update_multi": 1}, 12, "step")
    return errs, top, serve, train


# ---- the MQ CL episode (cl/episode.py, bin/train_cl.py, bin/evaluate.py) ---

EPISODE_KERNELS = ("fused_attention_blc", "attention_bwd_cuda",
                   "xl_rel_attention", "xl_bwd_cuda", "fused_dwconv_qkv",
                   "dwconv_bwd_cuda", "adamw_update_multi")
# the tiny episode, card against CPU: 2 tasks of 2 classes, 2 train and 1
# val clips a class, a batch of 8 (an epoch is one step), lr 1e-4, 1 + 2
# epochs, from N(0, 0.02)-perturbed parameters (as the CPU lockstep,
# tests/test_torch_port_episode.py), the XL dropout at 0
EPISODE_VIDEOS = (2, 1)
EPISODE_EVAL_ATOL = 1e-4      # the CPU lockstep's limit on the eval series
EPISODE_PARAM_RTOL = GRAD_RTOL    # the train parity's 2e-3, per leaf
# leaves whose exact gradient is 0 or a cancelling sum of roundoff: AdamW
# moves them by up to lr a step whatever the sign (the CPU lockstep's rule)
ROUNDOFF_GRAD = ("attn.key.bias", "attn.key_norm.bias", "adapter.fc2.bias")
EVAL_KEYS = ("avg_mAP", "avg_R1@0.3", "avg_R5@0.3", "avg_R1@0.5",
             "avg_R5@0.5", "BwF_R1@0.5", "BwF_mAP")
# the full-width episode's cuts
EPISODE_TASKS = 2
EPISODE_FULL_VIDEOS = (1, 1)
DETERMINISM_STEPS = 5         # timed yaml steps a cudnn.deterministic mode
# the synthetic clips' feature grid: 16 frames a feature at 30 fps (the tiny
# config's), so a 60-120 s clip is 112-225 rows, upsampled to T = 1024
EPISODE_SYNTHETIC_GRID = {"feat_stride": 16.0, "num_frames": 16.0}
VQ_YAML_SEED = 42             # configs/vq_vilco.yaml's init_rand_seed


def perturbed(runner, seed: int) -> None:
    """The runner's parameters + N(0, 0.02) drawn on the host from seed."""
    rng = np.random.default_rng(seed)
    runner.set_params({
        n: p.detach().cpu() + 0.02 * torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for n, p in runner.model.named_parameters()})


def twin_gaps(tag, card, cpu, card_res, cpu_res, keys, avg_keys, lr_sum,
              zero_grad=lambda n, shape: None):
    """Card vs CPU: the eval series (each task's `keys`, scalars or lists,
    and the `avg_keys`) within EPISODE_EVAL_ATOL, every parameter leaf within
    EPISODE_PARAM_RTOL of its largest value, the elements whose exact
    gradient is 0 (`zero_grad` gives their slice) within 2 x lr_sum."""
    worst = 0.0
    for a, b in zip(cpu_res["tasks"], card_res["tasks"]):
        gaps = [abs(a["eval"][k] - b["eval"][k]) for k in avg_keys]
        gaps += [float(np.abs(np.subtract(x[k], y[k])).max())
                 for x, y in zip(a["eval"]["per_task"], b["eval"]["per_task"])
                 for k in keys]
        worst = max(worst, *gaps)
    want = dict(cpu.model.named_parameters())
    errs, roundoff = {}, 0.0
    for n, p in card.model.named_parameters():
        d = (p.detach().cpu() - want[n].detach()).abs()
        zero = zero_grad(n, d.shape)
        if zero is not None:
            roundoff = max(roundoff, d[zero].max().item())
            d[zero] = 0.0
        errs[n] = d.max().item() / max(want[n].detach().abs().max().item(),
                                       1e-30)
    top = max(errs, key=errs.get)
    say(f"[{tag}] card vs CPU, f32, cudnn.deterministic: eval series and "
        f"BwF {worst:.3e} (limit {EPISODE_EVAL_ATOL:g}), parameters "
        f"{errs[top]:.3e} at {top} (limit {EPISODE_PARAM_RTOL:g}), "
        f"zero-gradient elements {roundoff:.3e} (limit {2 * lr_sum:.3e})")
    if (worst > EPISODE_EVAL_ATOL or errs[top] > EPISODE_PARAM_RTOL
            or roundoff > 2 * lr_sum):
        fail(f"{tag}: the card's episode is outside its limits")


def tiny_episode(device: str, workdir: str):
    """The tiny yaml-method episode of the port on `device` (module
    constants above), run to its end: (runner, results)."""
    from vilco_tpu_torch.bin.train_cl import synthetic_mq_runner
    from vilco_tpu_torch.core.config import mq_yaml_config

    rep = dataclasses.replace
    cfg = mq_yaml_config(tiny=True)
    cfg = rep(cfg, model=rep(cfg.model, xl_dropout=0.0),
              cl_cfg=rep(cfg.cl_cfg, num_tasks=2, memory_size=20),
              opt=rep(cfg.opt, learning_rate=1e-4, epochs=2,
                      warmup_epochs=1),
              loader=rep(cfg.loader, batch_size=8))
    cfg, runner = synthetic_mq_runner(cfg, workdir, device, EPISODE_VIDEOS)
    perturbed(runner, SEED + 21)
    return runner, runner.run()


def memory_ids(memory) -> dict:
    return {int(c): [v["id"] for v in vs] for c, vs in memory.data.items()}


def episode_parity(dev, tmp: str) -> None:
    """(a) The tiny episode on the card against the same on the CPU, TF32
    off and cudnn.deterministic on: the rehearsal memory equal, the eval
    series and BwF within 1e-4, the final parameters within 2e-3 of each
    leaf's largest value (the roundoff leaves within 2 x the lrs)."""
    from vilco_tpu_torch.train.optim import make_schedule

    with deterministic_algorithms(False):
        card, card_res = tiny_episode(str(dev), f"{tmp}/tiny_card")
    cpu, cpu_res = tiny_episode("cpu", f"{tmp}/tiny_cpu")
    if memory_ids(card.memory) != memory_ids(cpu.memory):
        fail("mq_episode_parity: the rehearsal memory differs card vs CPU")
    sched = make_schedule(cpu.cfg.opt, 1)
    lr_sum = 2 * sum(float(sched(s)) for s in range(cpu.cfg.opt.total_epochs))
    say(f"[mq_episode_parity] the tiny yaml-method episode (2 tasks, "
        f"{sum(r['train']['steps'] for r in card_res['tasks'])} steps): "
        f"memory equal ({sum(map(len, card.memory.data.values()))} clips), "
        f"normaliser {card.loss_normalizer:.6f} vs "
        f"{cpu.loss_normalizer:.6f}")
    twin_gaps("mq_episode_parity", card, cpu, card_res, cpu_res, ("mAP",),
              EVAL_KEYS, lr_sum, lambda n, shape: slice(None)
              if n.endswith(ROUNDOFF_GRAD) else None)


def determinism_cost(dev, runner) -> None:
    """One yaml train step (task 1, batch 2, bf16) timed with cuDNN's
    default algorithms and with cudnn.deterministic, alternating modes
    (ROADMAP §3, F3)."""
    from vilco_tpu_torch.data.pipeline import BatchIterator
    from vilco_tpu_torch.train.engine import (
        CLBatchExtras,
        TrainState,
        init_adapter_ema,
        make_train_step,
    )
    from vilco_tpu_torch.train.optim import FusedAdamW

    cfg = runner.cfg
    videos = runner.stream.train_videos(1, runner.memory)
    batch, _ = next(iter(BatchIterator(runner._make_dataset(videos, True),
                                       cfg, cfg.loader.batch_size, True)))
    batch = runner._to_device(batch)
    topk = cfg.cl_cfg.topk
    batch["prompt_mask"] = torch.arange(topk, 2 * topk, device=dev).expand(
        batch["feats"].shape[0], -1).contiguous()
    state = TrainState(runner.model, FusedAdamW(runner.model, 1, cfg.opt),
                       torch.tensor(100.0, device=dev),
                       torch.Generator(device=dev).manual_seed(SEED),
                       adapter_ema=init_adapter_ema(runner.model))
    step = make_train_step(runner.points, cfg.train_cfg,
                           compute_dtype=torch.bfloat16, cl_cfg=cfg.cl_cfg,
                           n_known=len(runner.stream.classes_upto(0)))
    cl = CLBatchExtras(class_mask=runner._class_mask(1),
                       memory_bank=runner.memory_bank.clone(),
                       memory_ptr=runner.memory_ptr.clone())
    times = {False: [], True: []}
    was = torch.backends.cudnn.deterministic
    try:
        for det in (False, True, False, True):
            torch.backends.cudnn.deterministic = det
            step(state, batch, cl)
            torch.cuda.synchronize()
            for _ in range(DETERMINISM_STEPS):
                t0 = time.perf_counter()
                step(state, batch, cl)
                torch.cuda.synchronize()
                times[det].append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = was
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"[mq_episode] F3: one yaml train step at batch "
        f"{cfg.loader.batch_size}, bf16, task 1: "
        f"{med[False]:.3f} ms by default, {med[True]:.3f} ms with "
        f"cudnn.deterministic ({med[True] / med[False]:.4f}x; medians of "
        f"{2 * DETERMINISM_STEPS} steps each, modes alternated, host clock "
        f"synced)")


def synced(timing: dict, key: str, fn):
    """`fn` timed by the host clock between two synchronizes, its seconds
    added to timing[key] (appended where that is a list)."""
    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if isinstance(timing[key], list):
            timing[key].append(dt)
        else:
            timing[key] += dt
        return out
    return timed


class EpisodeProbe:
    """What `episode_probe` gathers over a run of cl/episode.py's runner:
    `timing` (eval_s, decode_s, fwd_s and requests over predict_videos;
    save_s and step_s lists, each step synced; wall_s), `saved` (path,
    tree, memory ids) of each checkpoint, `launches` of each kernel over
    the run, `runner`."""

    def __init__(self):
        self.timing = {"eval_s": 0.0, "decode_s": 0.0, "fwd_s": 0.0,
                       "requests": 0, "save_s": [], "step_s": [],
                       "wall_s": 0.0}
        self.saved, self.launches, self.runner = [], {}, None


@contextlib.contextmanager
def episode_probe(kernels):
    """Time cl/episode.py's EpisodeRunner (MQ, and NLQ's subclass) inside
    the block: each train step and eval forward synced, the eval requests
    and their decode + soft-NMS, each checkpoint's save; the kernels'
    launch counts set to 0 on entry and read on exit. Yields an
    EpisodeProbe."""
    from vilco_tpu_torch.cl import episode as episode_mod

    probe = EpisodeProbe()
    timing = probe.timing
    cls = episode_mod.EpisodeRunner
    orig = (cls.run, cls.predict_videos, cls._decode_batch,
            episode_mod.save_checkpoint, episode_mod.make_train_step)

    def run(self, resume=False):
        probe.runner = self
        self.eval_step = synced(timing, "fwd_s", self.eval_step)
        return orig[0](self, resume)

    def make_train_step(*a, **k):
        return synced(timing, "step_s", orig[4](*a, **k))

    def predict_videos(self, videos, class_mask):
        timing["requests"] += -(-len(videos) // self.cfg.loader.batch_size)
        return synced(timing, "eval_s", orig[1])(self, videos, class_mask)

    def decode_batch(self, out, class_mask):
        return synced(timing, "decode_s", orig[2])(self, out, class_mask)

    def save(path, tree, arrays_format="npz"):
        synced(timing, "save_s", orig[3])(path, tree, arrays_format)
        probe.saved.append((path, tree, memory_ids(probe.runner.memory)))

    cls.run, cls.predict_videos, cls._decode_batch = (
        run, predict_videos, decode_batch)
    episode_mod.save_checkpoint = save
    episode_mod.make_train_step = make_train_step
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        yield probe
        torch.cuda.synchronize()
        timing["wall_s"] = time.perf_counter() - t0
        probe.launches = {k.__name__: k.launches for k in kernels}
    finally:
        cls.run, cls.predict_videos, cls._decode_batch = orig[:3]
        episode_mod.save_checkpoint, episode_mod.make_train_step = orig[3:]


def say_episode_tasks(tag, results, timing):
    """Each task's steps, ms/step, clips/s, the step alone (synced) and
    its last losses and eval; fails on a loss that is not finite."""
    first = 0
    for r in results["tasks"]:
        tr, ev = r["train"], r["eval"]
        bad = [k for k, v in tr["last_metrics"].items()
               if not np.isfinite(v)]
        if bad:
            fail(f"{tag}: task {r['task']} losses not finite: {bad}")
        steps = timing["step_s"][first:first + tr["steps"]]
        first += tr["steps"]
        say(f"[{tag}] task {r['task']}: {tr['steps']} steps, "
            f"{1e3 * tr['wall_s'] / tr['steps']:.3f} ms/step, "
            f"{tr['clips_per_s']:.3f} clips/s (host clock; the step "
            f"itself, synced, median "
            f"{1e3 * statistics.median(steps):.3f} ms, the rest the "
            f"loader's host work); final_loss "
            f"{tr['last_metrics']['final_loss']:.4f}, ssl "
            f"{tr['last_metrics'].get('ssl_loss', 0.0):.4f}, penalty "
            f"{tr['last_metrics'].get('reg_penalty', 0.0):.4g}; eval "
            + ", ".join(f"{k} {ev[k]:.4f}" for k in ev if k != "per_task")
            + f" [{CARD}]")


def reload_checkpoints(tag, ckpts, keys=()):
    """Load each (path, tree, _) of `ckpts` again: its params and `keys`
    must come back bit-equal; returns the load seconds."""
    from vilco_tpu_torch.core.checkpoint import load_checkpoint

    load_s = []
    for path, tree, _ in ckpts:
        t0 = time.perf_counter()
        back = load_checkpoint(path)
        load_s.append(time.perf_counter() - t0)
        same = (back["params"].keys() == tree["params"].keys()
                and all(np.array_equal(back["params"][k], v)
                        for k, v in tree["params"].items())
                and all(np.array_equal(back[k], tree[k]) for k in keys))
        if not same:
            fail(f"{tag}: {path} does not reload bit-equal")
    return load_s


def phase_mq_episode(dev) -> dict:
    """(a) episode_parity; (b) the full-width episode of the yaml's method
    through bin/train_cl.main on synthetic sources, cut to EPISODE_TASKS
    tasks, EPISODE_FULL_VIDEOS clips a class and one epoch with no warmup:
    finite losses, the memory at its quota after task 0, every task
    checkpoint reloaded bit-equal, bin/evaluate.main on the workdir; its
    timings, the launches of the run (each kernel of the path at least
    once) and the cost of cudnn.deterministic. Returns the launches."""
    import tempfile

    from vilco_tpu_torch.bin import evaluate as evaluate_cli
    from vilco_tpu_torch.bin import train_cl
    from vilco_tpu_torch.core.config import mq_yaml_config
    from vilco_tpu_torch.kernels import adamw, attention, dwconv, \
        xl_attention

    kernels = (attention.fused_attention_blc, attention.attention_bwd_cuda,
               xl_attention.xl_rel_attention, xl_attention.xl_bwd_cuda,
               dwconv.fused_dwconv_qkv, dwconv.dwconv_bwd_cuda,
               adamw.adamw_update_multi)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        episode_parity(dev, tmp)

        yaml = mq_yaml_config()
        cfg = dataclasses.replace(
            yaml, opt=dataclasses.replace(yaml.opt, epochs=1,
                                          warmup_epochs=0),
            dataset=dataclasses.replace(yaml.dataset,
                                        **EPISODE_SYNTHETIC_GRID))
        cfg_path, wd = f"{tmp}/mq_episode.json", f"{tmp}/mq_episode"
        with open(cfg_path, "w") as f:
            json.dump(cfg.to_dict(), f)
        say(f"[mq_episode] cuts of configs/mq_vilco.yaml's episode: "
            f"{EPISODE_TASKS} of the {yaml.cl_cfg.num_tasks} tasks; "
            f"{EPISODE_FULL_VIDEOS[0]} train and {EPISODE_FULL_VIDEOS[1]} "
            f"val video a class; epochs=1, warmup_epochs=0 (was "
            f"{yaml.opt.epochs} + {yaml.opt.warmup_epochs}); the synthetic "
            f"clips at feat_stride and num_frames "
            f"{EPISODE_SYNTHETIC_GRID['feat_stride']:g} (the yaml's "
            f"{yaml.dataset.feat_stride:g}: a 60-120 s synthetic clip would "
            f"span 1800-3600 rows, past the synthetic source's 512-row "
            f"cap, and every GT segment would fall off the grid); published "
            f"widths kept (T {yaml.model.max_seq_len}, width "
            f"{yaml.model.embd_dim}, {yaml.model.n_head} heads, text "
            f"{yaml.max_text_len} x {yaml.model.n_txt_in}, narration "
            f"{yaml.max_narration_len} x {yaml.cl_cfg.narration_dim}, "
            f"{yaml.model.num_classes} classes, L2P, SSL bank "
            f"{yaml.cl_cfg.memory_size}, adapters in "
            f"{list(yaml.cl_cfg.adapt_blocks)})")

        with episode_probe(kernels) as probe:
            results = train_cl.main([
                "--config", cfg_path, "--synthetic", "--workdir", wd,
                "--num-tasks", str(EPISODE_TASKS), "--synthetic-videos",
                *map(str, EPISODE_FULL_VIDEOS), "--device", str(dev)])
        timing, saved, launches = probe.timing, probe.saved, probe.launches
        wall = timing["wall_s"]
        missing = [n for n, v in launches.items() if v == 0]
        if missing:
            fail(f"mq_episode: {missing} never launched in the episode")
        say("[mq_episode] launches over the episode (train_cl.main): "
            + ", ".join(f"{n} {v}" for n, v in launches.items()))
        say_episode_tasks("mq_episode", results, timing)
        n = timing["requests"]
        say(f"[mq_episode] eval: {n} requests of "
            f"{cfg.loader.batch_size} clips through the adapter ensemble, "
            f"{1e3 * timing['eval_s'] / n:.3f} ms a request: the two "
            f"forwards {1e3 * timing['fwd_s'] / n:.3f} ms, decode + "
            f"soft-NMS {1e3 * timing['decode_s'] / n:.3f} ms "
            f"({timing['decode_s'] / timing['eval_s']:.3f}), the rest the "
            f"loader's host work; the episode "
            f"{wall:.1f} s in all, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        runner = probe.runner

        quota = runner.stream.memory_quota(yaml.cl_cfg.memory_size,
                                           len(runner.stream.classes_upto(0)))
        ckpts = [(p, t, m) for p, t, m in saved if p.endswith(".ckpt")]
        mem0 = ckpts[0][2]
        per = runner.stream.train_class_videos(0)
        if (len(mem0) != len(runner.stream.task_classes(0))
                or any(len(v) != min(len(per[c]), quota)
                       for c, v in mem0.items())):
            fail(f"mq_episode: memory after task 0 holds {len(mem0)} "
                 f"classes, not each at min(clips, quota {quota})")
        load_s = reload_checkpoints("mq_episode", ckpts,
                                    ("memory_bank", "memory_ptr"))
        mem_back = runner.memory.__class__()
        mem_back.load(f"{wd}/{cfg.cl_cfg.path_memory}")
        if memory_ids(mem_back) != ckpts[-1][2]:
            fail("mq_episode: the memory file does not reload equal")
        size = os.path.getsize(ckpts[-1][0]) / 2**30
        say(f"[mq_episode] memory after task 0: {len(mem0)} classes at "
            f"min(clips, quota {quota}); checkpoints ({size:.2f} GiB a task, "
            f"{len(ckpts[-1][1]['params'])} leaves) reload bit-equal: save "
            + ", ".join(f"{s:.2f}" for s in timing["save_s"])
            + " s, load " + ", ".join(f"{s:.2f}" for s in load_s) + " s")

        t0 = time.perf_counter()
        ev = evaluate_cli.main(["--workdir", wd, "--synthetic",
                                "--synthetic-videos",
                                *map(str, EPISODE_FULL_VIDEOS),
                                "--task-idx", "0", "--device", str(dev)])
        if len(ev["per_task"]) != 1 or not np.isfinite(ev["avg_mAP"]):
            fail("mq_episode: bin/evaluate.main --task-idx 0 gave "
                 f"{len(ev['per_task'])} tasks, avg mAP {ev['avg_mAP']}")
        say(f"[mq_episode] bin/evaluate.main --task-idx 0 on the workdir "
            f"(params and memory only: the single forward, no text): avg "
            f"mAP {ev['avg_mAP']:.4f} in {time.perf_counter() - t0:.1f} s")
        determinism_cost(dev, runner)
        del runner, probe, saved
    return launches


# ---- the NLQ and VQ CL episodes --------------------------------------------

# the tiny twins, card against CPU, as the MQ episode's: 2 tasks, lr 1e-4,
# from N(0, 0.02)-perturbed parameters; NLQ with the yaml's EWC at lambda
# 3000 over 1 + 2 epochs, VQ with EWC, augmentation on, 1 epoch, the
# head's dropout at 0 (the card's and the CPU's generators draw different
# masks) and f32 forwards
TWIN_LR = 1e-4
TWIN_LAMBDA = 3000.0
NLQ_TWIN_EVAL = ("R1@0.3", "R1@0.5", "R5@0.3", "R5@0.5")
VQ_TWIN_EVAL = ("tAP@0.25", "stAP@0.25", "Success", "recovery%")
# leaves whose exact gradient is 0 (the NLQ twin; tests/test_torch_port_nlq)
NLQ_ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")
# the full-width episodes' cuts: 2 tasks, 1 epoch, no warmup; NLQ's split
# keeps make_synthetic_nlq_split's 8 train and 3 val queries a template,
# VQ's make_synthetic_vq_split's 2 categories a task, 4 train and 2 val
# samples a category (60-frame clips at the 30-frame window)
EPISODE_CHAIN_ATOL = 1e-4     # evaluate / vq_infer against the run's eval


def nlq_twin(device: str, workdir: str):
    """The tiny NLQ episode (EWC at lambda 3000) on `device`, run to its
    end: (runner, results)."""
    from vilco_tpu_torch.bin.train_cl import synthetic_nlq_runner
    from vilco_tpu_torch.tasks.nlq import nlq_tiny_config

    cfg = nlq_tiny_config(
        cl_cfg={"name": "ewc", "reg_lambda": TWIN_LAMBDA, "num_tasks": 2},
        opt={"learning_rate": TWIN_LR, "epochs": 2, "warmup_epochs": 1})
    runner = synthetic_nlq_runner(cfg, workdir, device)
    perturbed(runner, SEED + 31)
    return runner, runner.run()


def nlq_episode_parity(dev, tmp: str) -> None:
    from vilco_tpu_torch.train.optim import make_schedule

    with deterministic_algorithms(False):
        card, card_res = nlq_twin(str(dev), f"{tmp}/nlq_twin_card")
    cpu, cpu_res = nlq_twin("cpu", f"{tmp}/nlq_twin_cpu")
    steps = sum(r["train"]["steps"] for r in cpu_res["tasks"])
    sched = make_schedule(cpu.cfg.opt, steps // 2 // cpu.cfg.opt.total_epochs)
    lr_sum = 2 * sum(float(sched(s)) for s in range(steps // 2))
    say(f"[nlq_episode_parity] the tiny NLQ episode (EWC at lambda "
        f"{TWIN_LAMBDA:g}, 2 tasks, {steps} steps), normaliser "
        f"{card.loss_normalizer:.6f} vs {cpu.loss_normalizer:.6f}, "
        f"memory {memory_ids(card.memory) == memory_ids(cpu.memory)}")
    if memory_ids(card.memory) != memory_ids(cpu.memory):
        fail("nlq_episode_parity: the rehearsal memory differs")
    twin_gaps("nlq_episode_parity", card, cpu, card_res, cpu_res,
              NLQ_TWIN_EVAL, ("avg_R1@0.3", "avg_R5@0.3", "BwF_R1@0.3"),
              lr_sum, lambda n, shape: slice(None)
              if n.endswith(NLQ_ZERO_GRAD) else None)


def phase_nlq_episode(dev) -> dict:
    """(a) the tiny NLQ twin card vs CPU; (b) configs/nlq_vilco.yaml's
    episode (nlq_flagship_config(): EWC at lambda 3000, best_metric
    avg_R1@0.3) through bin/train_cl.main on the synthetic split, cut to
    EPISODE_TASKS tasks and one epoch with no warmup, then
    bin/evaluate.main --task nlq --submission on its workdir: finite
    losses, each checkpoint reloaded bit-equal, evaluate's per-task
    numbers within EPISODE_CHAIN_ATOL of the run's last eval; ms/step,
    clips/s, eval ms a request split into the forward and decode +
    soft-NMS, checkpoint size and seconds, the launches (each kernel of
    the path at least once). Returns the launches."""
    import tempfile

    from vilco_tpu_torch.bin import evaluate as evaluate_cli
    from vilco_tpu_torch.bin import train_cl
    from vilco_tpu_torch.core.config import nlq_flagship_config
    from vilco_tpu_torch.kernels import adamw, attention, \
        banded_attention, dwconv

    kernels = (banded_attention.banded_attention_blc,
               banded_attention.banded_bwd_cuda,
               attention.fused_attention_blc, attention.attention_bwd_cuda,
               dwconv.fused_dwconv_qkv, dwconv.dwconv_bwd_cuda,
               adamw.adamw_update_multi)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        nlq_episode_parity(dev, tmp)

        yaml = nlq_flagship_config()
        cfg = dataclasses.replace(yaml, opt=dataclasses.replace(
            yaml.opt, epochs=1, warmup_epochs=0))
        cfg_path, wd = f"{tmp}/nlq_episode.json", f"{tmp}/nlq_episode"
        with open(cfg_path, "w") as f:
            json.dump(cfg.to_dict(), f)
        say(f"[nlq_episode] cuts of configs/nlq_vilco.yaml's episode: "
            f"{EPISODE_TASKS} of the {yaml.cl_cfg.num_tasks} templates; 8 "
            f"train and 3 val queries a template; epochs=1, "
            f"warmup_epochs=0 (was {yaml.opt.epochs} + "
            f"{yaml.opt.warmup_epochs}); published widths kept (T "
            f"{yaml.model.max_seq_len}, width {yaml.model.embd_dim}, "
            f"{yaml.model.n_head} heads, window "
            f"{yaml.model.n_mha_win_size}, text {yaml.max_text_len} x "
            f"{yaml.model.n_txt_in}, {yaml.cl_cfg.name} at lambda "
            f"{yaml.cl_cfg.reg_lambda:g}, batch {yaml.loader.batch_size})")
        with episode_probe(kernels) as probe:
            results = train_cl.main([
                "--config", cfg_path, "--task", "nlq", "--synthetic",
                "--workdir", wd, "--num-tasks", str(EPISODE_TASKS),
                "--device", str(dev)])
        timing, launches = probe.timing, probe.launches
        missing = [n for n, v in launches.items() if v == 0]
        if missing:
            fail(f"nlq_episode: {missing} never launched in the episode")
        say("[nlq_episode] launches over the episode (train_cl.main): "
            + ", ".join(f"{n} {v}" for n, v in launches.items()))
        say_episode_tasks("nlq_episode", results, timing)
        n = timing["requests"]
        say(f"[nlq_episode] eval: {n} requests of {cfg.loader.batch_size} "
            f"queries, {1e3 * timing['eval_s'] / n:.3f} ms a request: the "
            f"forward {1e3 * timing['fwd_s'] / n:.3f} ms, decode + "
            f"soft-NMS {1e3 * timing['decode_s'] / n:.3f} ms "
            f"({timing['decode_s'] / timing['eval_s']:.3f}), the rest the "
            f"loader's host work; the episode {timing['wall_s']:.1f} s in "
            f"all, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{CARD}]")
        ckpts = [c for c in probe.saved if c[0].endswith(".ckpt")]
        load_s = reload_checkpoints("nlq_episode", ckpts)
        if len(ckpts[0][1]["reg_list"]) != 1:
            fail("nlq_episode: task 0's checkpoint holds no EWC task")
        size = os.path.getsize(ckpts[-1][0]) / 2**20
        say(f"[nlq_episode] checkpoints ({size:.1f} MiB a task with its "
            f"EWC tasks, {len(ckpts[-1][1]['params'])} leaves) reload "
            f"bit-equal: save "
            + ", ".join(f"{s:.2f}" for s in timing["save_s"])
            + " s, load " + ", ".join(f"{s:.2f}" for s in load_s) + " s")

        t0 = time.perf_counter()
        ev = evaluate_cli.main(["--workdir", wd, "--synthetic",
                                "--submission", f"{tmp}/nlq_sub.json",
                                "--device", str(dev)])
        last = results["final"]
        gap = max(abs(a[k] - b[k]) for a, b in zip(ev["per_task"],
                                                   last["per_task"])
                  for k in NLQ_TWIN_EVAL)
        with open(f"{tmp}/nlq_sub.json") as f:
            sub = json.load(f)
        say(f"[nlq_episode] bin/evaluate.main --task nlq --submission on the "
            f"workdir: per-task R1/R5 at 0.3/0.5 {gap:.3e} from the run's "
            f"last eval (limit {EPISODE_CHAIN_ATOL:g}), "
            f"{len(sub['results'])} {sub['challenge']} records, "
            f"{time.perf_counter() - t0:.1f} s")
        if len(ev["per_task"]) != EPISODE_TASKS or gap > EPISODE_CHAIN_ATOL:
            fail("nlq_episode: evaluate does not reproduce the last eval")
        del probe
    torch.cuda.empty_cache()
    return launches


def vq_twin(device: str, workdir: str):
    """The tiny VQ episode (EWC, augmentation on) on `device`, run to its
    end: (runner, results)."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.tasks import vq as vq_mod

    cfg = dataclasses.replace(vq_flagship_config(tiny=True), dropout=0.0)
    tr, va = vq_mod.make_synthetic_vq_split(np.random.default_rng(SEED),
                                            num_tasks=2)
    runner = vq_mod.VQEpisodeRunner(
        vq_mod.VQTaskStream(tr, va), vq_mod.SyntheticVQSource(cfg.clip_size),
        workdir, model_cfg=cfg, method="ewc", reg_lambda=TWIN_LAMBDA,
        epochs=1, batch_size=cfg.batch_size, lr=TWIN_LR,
        weight_decay=cfg.weight_decay, use_hnm=True, augment=True,
        seed=SEED, device=device, compute_dtype=torch.float32)
    perturbed(runner, SEED + 32)
    return runner, runner.run()


def vq_zero_grad(name, shape):
    """The VQ model's elements whose exact gradient is 0: the key biases
    (the decoder's, the middle third of each encoder's fused qkv bias)."""
    if name.endswith(("self_k.bias", "cross_k.bias")):
        return slice(None)
    if name.endswith("qkv.bias") and name.startswith("st_"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    return None


def vq_episode_parity(dev, tmp: str) -> None:
    with deterministic_algorithms(False):
        card, card_res = vq_twin(str(dev), f"{tmp}/vq_twin_card")
    cpu, cpu_res = vq_twin("cpu", f"{tmp}/vq_twin_cpu")
    steps = sum(len(cpu.stream.train_videos(j)) // cpu.batch_size
                for j in range(2))
    (want, _), = cpu.reg_list
    (got, _), = card.reg_list
    imp = max((got[n].cpu() - w).abs().max().item()
              / max(w.abs().max().item(), 1e-30) for n, w in want.items()
              if vq_zero_grad(n, w.shape) is None
              and not n.startswith("backbone."))
    say(f"[vq_episode_parity] the tiny VQ episode (EWC at lambda "
        f"{TWIN_LAMBDA:g}, augmentation on, 2 tasks, {steps} steps): task 0's "
        f"importance {imp:.3e} of each leaf's largest, card vs CPU")
    if imp > EPISODE_PARAM_RTOL:
        fail("vq_episode_parity: the importance differs card vs CPU")
    twin_gaps("vq_episode_parity", card, cpu, card_res, cpu_res,
              VQ_TWIN_EVAL, ("avg_tAP25", "avg_stAP25", "avg_success",
                             "BwF_tAP25"), TWIN_LR * steps, vq_zero_grad)


def phase_vq_episode(dev) -> dict:
    """(a) the tiny VQ twin card vs CPU; (b) configs/vq_vilco.yaml's
    episode (vq_flagship_config(): the frozen ViT-B/14 at 448, 30-frame
    windows, HNM and augmentation on, batch 4; the method the yaml gets
    from the CLI, naive) through bin/train_cl.main --task vq on the
    synthetic split, cut to EPISODE_TASKS tasks and one epoch, then
    bin/vq_infer.main on its workdir: finite losses, each checkpoint
    reloaded bit-equal, vq_infer's numbers within EPISODE_CHAIN_ATOL of
    the run's last eval; ms/step, clips/s, eval ms a request split into
    ViT, matcher and peak finding, checkpoint size and seconds, the
    launches (each kernel of the path at least once). Returns the
    launches."""
    import tempfile

    from vilco_tpu_torch.bin import train_cl, vq_infer
    from vilco_tpu_torch.core.config import Config, vq_flagship_config
    from vilco_tpu_torch.kernels import adamw, attention, frame_band
    from vilco_tpu_torch.tasks import vq as vq_mod

    kernels = (attention.fused_attention_blc, attention.attention_bwd_cuda,
               frame_band.frame_band_attention,
               frame_band.frame_band_bwd_cuda, adamw.adamw_update_multi)
    with tempfile.TemporaryDirectory(dir=".") as tmp:
        vq_episode_parity(dev, tmp)

        vq = vq_flagship_config()
        cfg = Config(task="vq", init_rand_seed=VQ_YAML_SEED, vq=vq)
        cfg_path, wd = f"{tmp}/vq_episode.json", f"{tmp}/vq_episode"
        with open(cfg_path, "w") as f:
            json.dump(cfg.to_dict(), f)
        say(f"[vq_episode] cuts of configs/vq_vilco.yaml's episode: "
            f"{EPISODE_TASKS} tasks of 2 categories (the yaml groups 400), "
            f"4 train and 2 val samples a category, 1 epoch; synthetic "
            f"clips of {vq_mod.synthetic_frames(vq.num_frames)} frames "
            f"(2 x the window; JAX's 16 would wrap the windows around); "
            f"published widths kept (ViT-B/14 at {vq.clip_size}, "
            f"{vq.num_frames}-frame windows, matcher {vq.dim}, "
            f"{vq.num_transformer} layers, HNM {vq.use_hnm}, augmentation "
            f"{vq.augment}, batch {vq.batch_size}, seed {VQ_YAML_SEED})")
        cls = vq_mod.VQEpisodeRunner
        orig = (cls.__init__, cls.train_task, cls.evaluate,
                vq_mod.save_checkpoint)
        timing = {"task_s": [], "step_s": [], "eval_s": 0.0, "requests": 0,
                  "save_s": []}
        saved, marks = [], []
        seen = {}

        def init(self, *a, **k):
            orig[0](self, *a, **k)
            seen["runner"] = self
            self.train_step = synced(timing, "step_s", self.train_step)
            self.eval_marks = marks

        def evaluate(self, j):
            timing["requests"] += sum(len(self.stream.val_videos_task(i))
                                      for i in range(j + 1))
            return synced(timing, "eval_s", orig[2])(self, j)

        def save(path, tree, arrays_format="npz"):
            synced(timing, "save_s", orig[3])(path, tree, arrays_format)
            saved.append((path, tree, None))

        cls.__init__, cls.evaluate = init, evaluate
        cls.train_task = synced(timing, "task_s", orig[1])
        vq_mod.save_checkpoint = save
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            results = train_cl.main([
                "--config", cfg_path, "--task", "vq", "--synthetic",
                "--workdir", wd, "--num-tasks", str(EPISODE_TASKS),
                "--epochs", "1", "--device", str(dev)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
        finally:
            cls.__init__, cls.train_task, cls.evaluate = orig[:3]
            vq_mod.save_checkpoint = orig[3]
        runner = seen["runner"]
        runner.eval_marks = None
        missing = [n for n, v in launches.items() if v == 0]
        if missing:
            fail(f"vq_episode: {missing} never launched in the episode")
        say("[vq_episode] launches over the episode (train_cl.main): "
            + ", ".join(f"{n} {v}" for n, v in launches.items()))
        first = 0
        for r, task_s in zip(results["tasks"], timing["task_s"]):
            tr, ev = r["train"], r["eval"]
            bad = [k for k, v in tr.items() if not np.isfinite(v)]
            if bad:
                fail(f"vq_episode: task {r['task']} losses not finite: {bad}")
            n_steps = len(runner.stream.train_videos(r["task"])) // (
                runner.batch_size)
            steps = timing["step_s"][first:first + n_steps]
            first += n_steps
            say(f"[vq_episode] task {r['task']}: {n_steps} steps, "
                f"{1e3 * task_s / n_steps:.3f} ms/step, "
                f"{n_steps * runner.batch_size / task_s:.3f} clips/s (the "
                f"task's train wall, synced; the step itself median "
                f"{1e3 * statistics.median(steps):.3f} ms, the rest the "
                f"loader's host work: rendering and augmenting the "
                f"windows); final_loss {tr['final_loss']:.4f}, num_pos "
                f"{tr['num_pos']:.0f}; eval "
                + ", ".join(f"{k} {ev[k]:.4f}" for k in ev
                            if k != "per_task") + f" [{CARD}]")
        parts = vq_request_parts(marks)
        n = timing["requests"]
        say(f"[vq_episode] eval: {n} requests (one clip of "
            f"{vq_mod.synthetic_frames(vq.num_frames)} frames + query), "
            f"{1e3 * timing['eval_s'] / n:.3f} ms a request: ViT "
            f"{parts[0] / n:.3f}, matcher {parts[1] / n:.3f}, top anchor "
            f"{parts[2] / n:.3f} ms (CUDA events), peak finding "
            f"{parts[3] / n:.3f} ms (host), the rest the host's frames; the "
            f"episode {wall:.1f} s in all, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
            f"[{CARD}]")
        load_s = reload_checkpoints("vq_episode", saved)
        size = os.path.getsize(saved[-1][0]) / 2**20
        say(f"[vq_episode] checkpoints ({size:.1f} MiB a task, the frozen "
            f"ViT in it, {len(saved[-1][1]['params'])} leaves) reload "
            f"bit-equal: save "
            + ", ".join(f"{s:.2f}" for s in timing["save_s"])
            + " s, load " + ", ".join(f"{s:.2f}" for s in load_s) + " s")

        t0 = time.perf_counter()
        ev = vq_infer.main(["--workdir", wd, "--synthetic", "--num-tasks",
                            str(EPISODE_TASKS), "--seed", str(VQ_YAML_SEED),
                            "--device", str(dev)])
        last = results["final"]
        gap = max([abs(a[k] - b[k]) for a, b in zip(ev["per_task"],
                                                    last["per_task"])
                   for k in VQ_TWIN_EVAL]
                  + [abs(ev[k] - last[k]) for k in ("avg_tAP25",
                                                    "avg_stAP25",
                                                    "avg_success")])
        say(f"[vq_episode] bin/vq_infer.main on the workdir (vq_config.json "
            f"and vq_task_001.ckpt): {gap:.3e} from the run's last eval "
            f"(limit {EPISODE_CHAIN_ATOL:g}), "
            f"{time.perf_counter() - t0:.1f} s")
        if len(ev["per_task"]) != EPISODE_TASKS or gap > EPISODE_CHAIN_ATOL:
            fail("vq_episode: vq_infer does not reproduce the last eval")
        del runner, seen, saved
    torch.cuda.empty_cache()
    return launches


# ---- NLQ: the dual tower with banded attention (K5) -----------------------

B_NLQ_SERVE = 16     # serving batch; training takes the yaml's loader.batch_size


def band_pairs(m, w: int) -> int:
    """Valid (query, key) pairs with |i - j| <= w in [0, T): the band work
    this run's masks need."""
    ones = torch.ones(1, 1, 2 * w + 1, device=m.device)
    seen = F.conv1d(m.float()[:, None], ones, padding=w)[:, 0]
    return int((seen * m.float()).sum().item())


def banded_work(m, C, H, w, dtype, which):
    """(flops, bytes) of K5 on this run's mask: 2 C operations per band
    pair for each product (forward q.k, p.v; backward q.k, dO.v, ds.k,
    ds.q, p.dO) and 2 C per valid query for delta. Bytes: the mask, the
    rows the function needs read once (q, k, v of the valid rows only, a
    masked query or key needing none; the backward also out, dout and lse
    of the valid rows) and each output written in full (a masked row is
    written as 0). `which`: "fwd" or "bwd" (dq, dk and dv)."""
    pairs, nq = band_pairs(m, w), int(m.sum())
    el = torch.empty((), dtype=dtype).element_size()
    B, T = m.shape
    rows, full, lse = nq * C * el, B * T * C * el, 4 * H * nq
    if which == "fwd":
        return 4 * C * pairs, 3 * rows + full + B * T
    return 10 * C * pairs + 2 * C * nq, 5 * rows + 3 * full + lse + B * T


def k5_calls(cfg) -> list:
    """(T, calls) of K5 in one NLQ forward: the video stem's blocks at
    max_seq_len, branch block i (stride 2) at max_seq_len >> (i + 1)."""
    T0, nb = cfg.max_seq_len, cfg.num_branch_layers
    return [(T0, cfg.backbone_arch[2])] + [(T0 >> (i + 1), 1)
                                           for i in range(nb)]


def say_k5_sums(tag: str, band_ms: dict, cfg, b_train: int) -> None:
    """K5's bf16 ms summed over an NLQ request's calls (forward at
    B_NLQ_SERVE) and a train step's (forward and backward at b_train),
    each at its own length; band_ms[(part, B, T)] = (ms, bound ms)."""
    calls = k5_calls(cfg)
    for what, B, parts in (("request", B_NLQ_SERVE, ("fwd",)),
                           ("train step", b_train, ("fwd", "bwd"))):
        ms, bms = (sum(n * band_ms[p, B, T][j] for T, n in calls
                       for p in parts) for j in (0, 1))
        say(f"[{tag}] K5 over an NLQ {what}'s "
            f"{sum(n for _, n in calls)} calls ("
            + ", ".join(f"{n} x T={T}" for T, n in calls)
            + f"), bf16 batch {B}, {' + '.join(parts)}: {ms:.4f} ms on the "
            f"card (queued behind a sleep), bound {bms:.4f} ms, time - "
            f"bound {ms - bms:.4f} ms [{CARD}]")


def band_mask(m, w: int):
    """(B, 1, T, T) bool, the band and the key mask: SDPA's mask for the
    same function."""
    i = torch.arange(m.shape[1], device=m.device)
    band = (i[:, None] - i[None, :]).abs() <= w
    return (band[None] & m[:, None, :])[:, None]


def nlq_inputs(rng, B, full, dev, dtype):
    """A batch of NLQ inputs (and of the MQ yaml model's serving): clip
    features with ragged lengths, text of 4..L tokens."""
    m = full.model
    T, L = m.max_seq_len, full.max_text_len
    feats = rng.standard_normal((B, T, m.input_dim)).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, size=B)
    mask = np.arange(T)[None, :] < lens[:, None]
    text = rng.standard_normal((B, L, m.n_txt_in)).astype(np.float32)
    tl = rng.integers(4, L + 1, size=B)
    tmask = np.arange(L)[None, :] < tl[:, None]
    to = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)
    return to(feats, dtype), to(mask), to(text, dtype), to(tmask)


def phase_nlq_kernels(dev):
    from vilco_tpu_torch.core.config import nlq_flagship_config
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        dkv_splits,
        fused_attention_blc,
        fused_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.banded_attention import (
        banded_attention_blc,
        banded_attention_blc_plain,
        banded_attention_bwd_plain,
        banded_bwd_cuda,
        banded_fwd_cuda,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
        fused_dwconv_qkv_plain,
    )

    full = nlq_flagship_config()
    cfg = full.model
    T0, C, H, w = cfg.max_seq_len, cfg.embd_dim, cfg.n_head, cfg.window
    D, L, nb, B_TR = C // H, full.max_text_len, cfg.num_branch_layers, \
        full.batch_size
    rng = np.random.default_rng(SEED + 6)
    chk = KernelChecks("nlq_kernels", ("band_fwd", "band_bwd", "attn",
                                       "attn_bwd", "dw", "dw_bwd", "adamw"))
    report = chk.report

    def randn(*shape, dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # K5 at every pyramid length, serving and training batch, the band
    # wider than T (T=8) and an odd T; band_ms[(which, B, T)]: bf16 ms and
    # bound, for the sum over the model's calls
    cases = ([(B, T0 >> i) for B in (B_NLQ_SERVE, B_TR)
              for i in range(nb + 1)] + [(B_TR, 8), (B_TR, 37)])
    band_ms = {}
    for dtype in (bf16, f32):
        for B, T in cases:
            q, k, v, g = (randn(B, T, C, dtype=dtype) for _ in range(4))
            m = ragged_mask(rng, B, T, dev)
            with torch.no_grad():
                out = banded_attention_blc(q, k, v, m, H, w)
                ref = banded_attention_blc_plain(q, k, v, m, H, w)
            got = grads_of(lambda *a: banded_attention_blc(*a, m, H, w),
                           (q, k, v), g)
            want = grads_of(
                lambda *a: banded_attention_blc_plain(*a, m, H, w),
                (q, k, v), g)
            torch.cuda.synchronize()
            label = f"B={B} T={T} C={C} H={H} w={w}"
            zero_row(f"banded {label}", [out] + got)
            bm = band_mask(m, w)
            bh = lambda x: x.reshape(B, T, H, D).transpose(1, 2)
            sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                bh(a), bh(b), bh(c), attn_mask=bm)
            check_repeatable(
                "nlq_kernels", f"banded forward {label} {str(dtype)[6:]}",
                lambda: banded_fwd_cuda(q, k, v, m, H, w, True))
            t = report("band_fwd", f"banded forward {label}", dtype,
                       output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
                       lambda: banded_fwd_cuda(q, k, v, m, H, w, False),
                       lambda: banded_attention_blc_plain(q, k, v, m, H, w),
                       banded_work(m, C, H, w, dtype, "fwd"),
                       lambda: sdpa(q, k, v),
                       is_top=dtype == bf16 and (B, T) == (B_NLQ_SERVE, T0),
                       also_queued=True)
            if dtype == bf16:
                band_ms["fwd", B, T] = t
            # the one backward launch on the forward's out and lse, against
            # its plain passes and against autograd through the plain
            # forward; library: SDPA's backward with the band mask
            o, lse = banded_fwd_cuda(q, k, v, m, H, w, True)
            kern = lambda: banded_bwd_cuda(q, k, v, m, o, lse, g, H, w)
            plain = lambda: banded_attention_bwd_plain(q, k, v, m, o, lse, g,
                                                       H, w)
            rows = output_errors(("dq", "dk", "dv"), kern(), plain(),
                                 TRAIN_TOL[dtype]) + output_errors(
                ("dq (autograd)", "dk (autograd)", "dv (autograd)"), got,
                want, TRAIN_TOL[dtype])
            zero_row(f"banded backward {label}", kern())
            check_repeatable("nlq_kernels", f"banded backward {label} "
                             f"{str(dtype)[6:]}", kern)
            t = report("band_bwd", f"banded backward {label} (library: "
                       "SDPA's backward with the band mask)", dtype, rows,
                       kern, plain, banded_work(m, C, H, w, dtype, "bwd"),
                       backward_timer(sdpa, (q, k, v), bh(g)),
                       is_top=dtype == bf16 and (B, T) == (B_TR, T0),
                       queued=True)
            if dtype == bf16:
                band_ms["bwd", B, T] = t
            del q, k, v, g, out, ref, got, want, o, lse, bm
        torch.cuda.empty_cache()

        # K1 at D=96: text self-attention (T=L) and video-to-text
        # cross-attention (Tq=T0, Tk=L), forward and backward
        for B in (B_NLQ_SERVE, B_TR):
            for Tq, what in ((L, "text self-attention"),
                             (T0, "cross-attention")):
                q, g = randn(B, Tq, C, dtype=dtype), randn(B, Tq, C,
                                                           dtype=dtype)
                k, v = (randn(B, L, C, dtype=dtype) for _ in range(2))
                m = ragged_mask(rng, B, L, dev)
                with torch.no_grad():
                    out = fused_attention_blc(q, k, v, m, H)
                    ref = fused_attention_blc_plain(q, k, v, m, H)
                got = grads_of(lambda *a: fused_attention_blc(*a, m, H),
                               (q, k, v), g)
                want = grads_of(
                    lambda *a: fused_attention_blc_plain(*a, m, H),
                    (q, k, v), g)
                torch.cuda.synchronize()
                label = f"{what} B={B} Tq={Tq} Tk={L} C={C} H={H}"
                zero_row(f"attention {label}", [out] + got)
                bhq = lambda x: x.reshape(B, -1, H, D).transpose(1, 2)
                am = m[:, None, None, :]
                sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                    bhq(a), bhq(b), bhq(c), attn_mask=am)
                cross = dtype == bf16 and Tq == T0
                report("attn", f"attention forward {label}", dtype,
                       output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
                       lambda: attention_fwd_cuda(q, k, v, m, H, False),
                       lambda: fused_attention_blc_plain(q, k, v, m, H),
                       attention_work(Tq, m, C, dtype, backward=False),
                       lambda: sdpa(q, k, v),
                       is_top=cross and B == B_NLQ_SERVE)
                o, lse = attention_fwd_cuda(q, k, v, m, H, with_lse=True)
                if B == B_TR and Tq == T0:   # the sliced dk/dv pass
                    check_repeatable(
                        "nlq_kernels", f"attention backward {label} "
                        f"{str(dtype)[6:]} ({dkv_splits(B, H, Tq, L)} query "
                        "slices)",
                        lambda: attention_bwd_cuda(q, k, v, m, o, lse, g, H))
                report("attn_bwd", f"attention backward {label}", dtype,
                       output_errors(("dq", "dk", "dv"), got, want,
                                     TRAIN_TOL[dtype]),
                       lambda: attention_bwd_cuda(q, k, v, m, o, lse, g, H),
                       backward_timer(
                           lambda *a: fused_attention_blc_plain(*a, m, H),
                           (q, k, v), g),
                       attention_work(Tq, m, C, dtype, backward=True),
                       backward_timer(sdpa, (q, k, v), bhq(g)),
                       is_top=cross and B == B_TR)

        # K3 at C=384: stride 1 in the text and video stems, stride 2 on
        # each branch block's input; forward at the serving batch, backward
        # at the training batch
        wt = randn(3, 3, C, dtype=dtype, scale=0.3)
        wg = wt.float().permute(2, 0, 1).reshape(3 * C, 1, 3).to(dtype)
        for T, s in [(T0, 1), (L, 1)] + [(T0 >> i, 2) for i in range(nb)]:
            To = (T - 1) // s + 1
            for B in (B_NLQ_SERVE, B_TR):
                x = randn(B, T, C, dtype=dtype)
                xt = x.transpose(1, 2)
                label = f"B={B} T={T} C={C} stride={s}"
                if B == B_NLQ_SERVE:
                    with torch.no_grad():
                        outs = fused_dwconv_qkv(x, wt, s)
                        refs = fused_dwconv_qkv_plain(x, wt, s)
                    report("dw", f"dwconv forward {label}", dtype,
                           output_errors(("q", "k", "v"), outs, refs,
                                         FWD_TOL[dtype]),
                           lambda: fused_dwconv_qkv(x, wt, s),
                           lambda: fused_dwconv_qkv_plain(x, wt, s),
                           dwconv_work(B, T, C, s, dtype, backward=False),
                           lambda: F.conv1d(xt, wg, stride=s, padding=1,
                                            groups=C), also_queued=True)
                    continue
                gs = tuple(randn(B, To, C, dtype=dtype) for _ in range(3))
                got = grads_of(lambda a, b: fused_dwconv_qkv(a, b, s),
                               (x, wt), gs)
                want = grads_of(lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                                (x, wt), gs)
                gcat = torch.stack(gs, -1).reshape(B, To, 3 * C).transpose(
                    1, 2)
                report("dw_bwd", f"dwconv backward {label}", dtype,
                       output_errors(("dx", "dw"), got, want,
                                     TRAIN_TOL[dtype]),
                       lambda: dwconv_bwd_cuda(x, wt, *gs, s),
                       backward_timer(
                           lambda a, b: fused_dwconv_qkv_plain(a, b, s),
                           (x, wt), gs),
                       dwconv_work(B, T, C, s, dtype, backward=True),
                       backward_timer(lambda a, b: F.conv1d(
                           a.transpose(1, 2), b, stride=s, padding=1,
                           groups=C), (x, wg), gcat), also_queued=True)
                check_repeatable("nlq_kernels", f"dwconv backward {label} "
                                 f"{str(dtype)[6:]}",
                                 lambda: dwconv_bwd_cuda(x, wt, *gs, s))
        torch.cuda.empty_cache()
    say_k5_sums("nlq_kernels", band_ms, cfg, B_TR)
    # K4 over the dual tower's 467 leaves (no Gaussian parameters)
    check_adamw(chk, *point_transformer_leaves(cfg, dev), torch.bfloat16)
    if not chk.ok:
        fail("an NLQ kernel disagrees with its plain version")
    return chk.errs, chk.top


# ---- VQ: the ClipMatcher with frame-banded attention (K6) and the fused
# ViT MLP (K7) ----------------------------------------------------------------

VQ_K6_BATCHES = (8, 16)   # the serving chunk (8 windows) and the HNM pairs


def frame_band_pairs(L: int, fr: int, w: int) -> int:
    """In-band (query, key) pairs of one sequence and head: fr queries a
    frame, each seeing the fr keys of every frame within +-w."""
    nf = L // fr
    return sum(fr * fr * (min(nf - 1, f + w) - max(0, f - w) + 1)
               for f in range(nf))


def frame_band_work(B, L, C, H, fr, w, dtype, which):
    """(flops, bytes) of K6 on B sequences: 2 C operations per band pair
    for each product the function needs (forward q.k, p.v; backward q.k,
    dO.v, p^T dO, dS^T q, dS k) and 2 C per row for delta. Bytes: q, k, v
    (backward: and out, dO) read once, each output written once, lse (f32
    per row and head) read by the backward. `which`: "fwd", "bwd" (the
    call), or one pass of the backward: "dkv" (q.k, dO.v, p^T dO, dS^T q;
    q, k, v, dO, lse and delta read, dk and dv written) or "dq" (q.k,
    dO.v, dS k; the same read, dq written)."""
    pairs = B * frame_band_pairs(L, fr, w)
    el = torch.empty((), dtype=dtype).element_size()
    rows = B * L * C * el
    if which == "fwd":
        return 4 * C * pairs, 4 * rows
    if which == "dkv":
        return 8 * C * pairs, 6 * rows + 8 * B * H * L
    if which == "dq":
        return 6 * C * pairs, 5 * rows + 8 * B * H * L
    return 10 * C * pairs + 2 * B * L * C, 8 * rows + 4 * B * H * L


def say_k6_sums(tag: str, fwd_ms: dict, calls: int) -> None:
    """K6's bf16 forward summed over a VQ request's calls (one per
    spatio-temporal layer at the serving chunk, batch 8) and an HNM step's
    (at its 16 pairs); fwd_ms[B] = (ms queued behind a sleep, bound ms)."""
    for what, B in (("request", min(VQ_K6_BATCHES)),
                    ("HNM step", max(VQ_K6_BATCHES))):
        ms, bms = (calls * x for x in fwd_ms[B])
        say(f"[{tag}] K6's forward over a VQ {what}'s {calls} calls, bf16 "
            f"batch {B}: {ms:.4f} ms on the card (queued behind a sleep), "
            f"bound {bms:.4f} ms, time - bound {ms - bms:.4f} ms [{CARD}]")


def frame_band_mask(L: int, fr: int, w: int, dev):
    """(L, L) bool, True in the band: SDPA's mask for the same function."""
    f = torch.arange(L, device=dev) // fr
    return (f[:, None] - f[None, :]).abs() <= w


def mlp_work(N, C, Hd, dtype):
    el = torch.empty((), dtype=dtype).element_size()
    return 4 * N * C * Hd, (2 * N * C + 2 * C * Hd + Hd + C) * el


def phase_vq_kernels(dev):
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        fused_attention_blc,
        fused_attention_blc_plain,
    )
    from vilco_tpu_torch.kernels.frame_band import (
        frame_band_attention,
        frame_band_attention_plain,
        frame_band_bwd_cuda,
        frame_band_bwd_plain,
        frame_band_fwd_cuda,
        frame_band_lse_plain,
    )
    from vilco_tpu_torch.kernels.mlp import (
        fused_mlp,
        fused_mlp_cuda,
        fused_mlp_plain,
    )
    from vilco_tpu_torch.models.clip_matcher import CQ_HEADS, ClipMatcher
    from vilco_tpu_torch.train.vq_engine import make_vq_optimizer

    cfg = vq_flagship_config()
    R, C, H = cfg.resolution_transformer, cfg.dim, 8
    fr, w, T = R * R, cfg.window_transformer // 2, cfg.num_frames
    rng = np.random.default_rng(SEED + 10)
    chk = KernelChecks("vq_kernels", ("fb_fwd", "fb_bwd", "mlp", "attn",
                                      "attn_cq", "attn_bwd", "adamw"))
    report = chk.report

    def randn(*shape, dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # K6 at the flagship (T frames of R*R tokens, 8 heads of 32, +-2
    # frames) at both batches, then the edges: the band wider than the
    # clip (3 frames), an odd frame length, one frame, a frame longer than
    # a tile; every shape holds its first and last frames
    cases = ([(B, T, fr, w, H, C // H) for B in VQ_K6_BATCHES]
             + [(2, 3, fr, w, H, C // H), (2, 9, 7, w, 3, 24),
                (2, 1, fr, w, H, C // H), (2, 4, 100, 1, 2, 128)])
    fwd_ms = {}
    for dtype in (bf16, f32):
        for B, nf, f_, w_, H_, D_ in cases:
            L, C_ = nf * f_, H_ * D_
            q, k, v, g = (randn(B, L, C_, dtype=dtype) for _ in range(4))
            with torch.no_grad():
                out = frame_band_attention(q, k, v, H_, f_, w_)
                ref = frame_band_attention_plain(q, k, v, H_, f_, w_)
            got = grads_of(lambda *a: frame_band_attention(*a, H_, f_, w_),
                           (q, k, v), g)
            want = grads_of(
                lambda *a: frame_band_attention_plain(*a, H_, f_, w_),
                (q, k, v), g)
            torch.cuda.synchronize()
            label = f"B={B} frames={nf} fr={f_} w={w_} H={H_} D={D_}"
            bm = frame_band_mask(L, f_, w_, dev)
            bh = lambda x: x.reshape(B, L, H_, D_).transpose(1, 2)
            sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                bh(a), bh(b), bh(c), attn_mask=bm)
            flagship = (nf, f_) == (T, fr)
            # the forward: its out, and its lse (f32 in both dtypes) against
            # the plain two-pass one; two calls give equal bits
            o, lse = frame_band_fwd_cuda(q, k, v, H_, f_, w_, True)
            check_repeatable("vq_kernels", f"frame_band forward {label} "
                             f"{str(dtype)[6:]}", lambda: frame_band_fwd_cuda(
                                 q, k, v, H_, f_, w_, True))
            ms = report(
                "fb_fwd", f"frame_band forward {label}", dtype,
                output_errors(("out", "lse"), [out, lse], [
                    ref, frame_band_lse_plain(q, k, H_, f_, w_)],
                    FWD_TOL[dtype]),
                lambda: frame_band_fwd_cuda(q, k, v, H_, f_, w_, False),
                lambda: frame_band_attention_plain(q, k, v, H_, f_, w_),
                frame_band_work(B, L, C_, H_, f_, w_, dtype, "fwd"),
                lambda: sdpa(q, k, v),
                is_top=dtype == bf16 and flagship and B == 8,
                also_queued=True)
            if dtype == bf16 and flagship:
                fwd_ms[B] = ms
            if flagship and B != max(VQ_K6_BATCHES):
                continue          # the backward at the HNM batch only
            # the backward's three passes (delta, dk/dv, dq) on the
            # forward's out and lse, against their plain version and
            # against autograd through the plain forward
            kern = lambda: frame_band_bwd_cuda(q, k, v, o, lse, g, H_, f_,
                                               w_)
            plain = lambda: frame_band_bwd_plain(q, k, v, o, lse, g, H_, f_,
                                                 w_)
            rows = output_errors(("dq", "dk", "dv"), kern(), plain(),
                                 TRAIN_TOL[dtype]) + output_errors(
                ("dq (autograd)", "dk (autograd)", "dv (autograd)"), got,
                want, TRAIN_TOL[dtype])
            check_repeatable("vq_kernels", f"frame_band backward {label} "
                             f"{str(dtype)[6:]}", kern)
            report("fb_bwd", f"frame_band backward {label} (library: SDPA's "
                   "backward with the band mask)", dtype, rows, kern, plain,
                   frame_band_work(B, L, C_, H_, f_, w_, dtype, "bwd"),
                   backward_timer(sdpa, (q, k, v), bh(g)),
                   is_top=dtype == bf16 and flagship, queued=True)
            passes = device_ms_by_kernel(kern, reps=10)
            pb = {p: bound(*frame_band_work(B, L, C_, H_, f_, w_, dtype, p),
                           dtype) for p in ("dq", "dkv")}
            say(f"[vq_kernels] frame_band backward {label} "
                f"{str(dtype)[6:]}, device ms by pass (profiler): "
                + ", ".join(f"{short_name(n)} {t:.4f}"
                            for n, t in passes.items())
                + "; the passes' bounds: " + ", ".join(
                    f"{p} {b[0]:.4f} ms ({b[1]})" for p, b in pb.items())
                + f" [{CARD}]")
            del q, k, v, g, out, ref, got, want, o, lse, bm
        torch.cuda.empty_cache()
    say_k6_sums("vq_kernels", fwd_ms, cfg.num_transformer)

    # K7 at the ViT-B MLP: the two ViT calls of a serving request (the
    # eval_windows x num_frames clip frames and the eval_windows query
    # copies, 1025 tokens each) in bf16, the query call in f32
    Cv, Hd, Lv = cfg.vit_dim, 4 * cfg.vit_dim, \
        (cfg.clip_size // cfg.patch_size) ** 2 + 1
    n_clip, n_query = cfg.eval_windows * T * Lv, cfg.eval_windows * Lv
    w1, b1 = randn(Cv, Hd, dtype=f32, scale=Cv ** -0.5), randn(
        Hd, dtype=f32, scale=0.1)
    w2, b2 = randn(Hd, Cv, dtype=f32, scale=Hd ** -0.5), randn(
        Cv, dtype=f32, scale=0.1)
    for dtype, N in ((bf16, n_clip), (bf16, n_query), (f32, n_query)):
        x = randn(N, Cv, dtype=dtype)
        with torch.no_grad():
            out = fused_mlp(x, w1, b1, w2, b2)
            ref = fused_mlp_plain(x, w1, b1, w2, b2)
        wl = [t.to(dtype) for t in (w1, b1, w2, b2)]
        kern = lambda: fused_mlp_cuda(x, w1, b1, w2, b2)
        lib = lambda: F.linear(F.gelu(F.linear(x, wl[0].t(), wl[1]),
                                      approximate="tanh"), wl[2].t(), wl[3])
        report("mlp", f"fused_mlp N={N} C={Cv} hidden={Hd}", dtype,
               output_errors(("out",), [out], [ref], FWD_TOL[dtype]), kern,
               lambda: fused_mlp_plain(x, w1, b1, w2, b2),
               mlp_work(N, Cv, Hd, dtype), lib,
               is_top=(dtype, N) == (bf16, n_clip), reps=5)
        if dtype == bf16:          # K7's two GEMMs and the library's line
            for what, fn in (("kernel", kern), ("library", lib)):
                split = device_ms_by_kernel(fn, reps=5)
                say(f"[vq_kernels] fused_mlp N={N} {what}, device ms by "
                    "kernel (profiler): " + ", ".join(
                        f"{short_name(k)} {v:.4f}" for k, v in split.items())
                    + f" [{CARD}]")
        del x, out, ref, wl
        torch.cuda.empty_cache()

    # K1 in the ViT (1025 tokens, 12 heads of 64, every key valid): the
    # serving request's clip and query calls in bf16, the f32 parity
    # forward's 30 frames
    Hv = cfg.vit_heads
    for dtype, B in ((bf16, cfg.eval_windows * T), (bf16, cfg.eval_windows),
                     (f32, T)):
        q, k, v = (randn(B, Lv, Cv, dtype=dtype) for _ in range(3))
        m = torch.ones(B, Lv, dtype=torch.bool, device=dev)
        with torch.no_grad():
            out = fused_attention_blc(q, k, v, m, Hv)
            ref = fused_attention_blc_plain(q, k, v, m, Hv)
        bh = lambda x: x.reshape(B, Lv, Hv, Cv // Hv).transpose(1, 2)
        report("attn", f"attention forward (ViT) B={B} T={Lv} C={Cv} H={Hv}",
               dtype, output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
               lambda: attention_fwd_cuda(q, k, v, m, Hv, False),
               lambda: fused_attention_blc_plain(q, k, v, m, Hv),
               attention_work(Lv, m, Cv, dtype, backward=False),
               lambda: F.scaled_dot_product_attention(bh(q), bh(k), bh(v)),
               is_top=(dtype, B) == (bf16, cfg.eval_windows * T), reps=5)
        del q, k, v, m, out, ref
        torch.cuda.empty_cache()

    # K1 in the query/frame decoder (cq_corr: the 32 x 32 patch grid as
    # 1024 tokens, C 256, 4 heads of 64; its self- and cross-attention have
    # the same shape, every key valid): the forward at the serving chunk
    # (240 frames) and the HNM step (16 pairs x 30 frames = 480), the
    # backward at 480
    Lc, Cc = (cfg.clip_size // cfg.patch_size) ** 2, cfg.dim
    Dc = Cc // CQ_HEADS
    b_serve, b_train = cfg.eval_windows * T, cfg.batch_size ** 2 * T
    for dtype in (bf16, f32):
        for B in (b_serve, b_train):
            q, k, v = (randn(B, Lc, Cc, dtype=dtype) for _ in range(3))
            m = torch.ones(B, Lc, dtype=torch.bool, device=dev)
            with torch.no_grad():
                out = fused_attention_blc(q, k, v, m, CQ_HEADS)
                ref = fused_attention_blc_plain(q, k, v, m, CQ_HEADS)
            bh = lambda x: x.reshape(B, Lc, CQ_HEADS, Dc).transpose(1, 2)
            sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                bh(a), bh(b), bh(c))
            label = f"(cq_corr) B={B} T={Lc} C={Cc} H={CQ_HEADS}"
            report("attn_cq", f"attention forward {label}", dtype,
                   output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
                   lambda: attention_fwd_cuda(q, k, v, m, CQ_HEADS, False),
                   lambda: fused_attention_blc_plain(q, k, v, m, CQ_HEADS),
                   attention_work(Lc, m, Cc, dtype, backward=False),
                   lambda: sdpa(q, k, v),
                   is_top=(dtype, B) == (bf16, b_serve), reps=5)
            del out, ref
            if B == b_train:
                g = randn(B, Lc, Cc, dtype=dtype)
                got = grads_of(
                    lambda *a: fused_attention_blc(*a, m, CQ_HEADS),
                    (q, k, v), g)
                want = grads_of(
                    lambda *a: fused_attention_blc_plain(*a, m, CQ_HEADS),
                    (q, k, v), g)
                o, lse = attention_fwd_cuda(q, k, v, m, CQ_HEADS,
                                            with_lse=True)
                rows = output_errors(("dq", "dk", "dv"), got, want,
                                     TRAIN_TOL[dtype])
                del got, want
                check_repeatable(
                    "vq_kernels", f"attention backward {label} "
                    f"{str(dtype)[6:]}",
                    lambda: attention_bwd_cuda(q, k, v, m, o, lse, g,
                                               CQ_HEADS))
                report("attn_bwd", f"attention backward {label}", dtype,
                       rows,
                       lambda: attention_bwd_cuda(q, k, v, m, o, lse, g,
                                                  CQ_HEADS),
                       backward_timer(
                           lambda *a: fused_attention_blc_plain(
                               *a, m, CQ_HEADS), (q, k, v), g),
                       attention_work(Lc, m, Cc, dtype, backward=True),
                       backward_timer(sdpa, (q, k, v), bh(g)),
                       is_top=dtype == bf16, reps=5)
                del g, o, lse
            del q, k, v, m
            torch.cuda.empty_cache()

    # K4 with f32 moments over the VQ optimizer's trainable leaves (the
    # frozen ViT outside it), every leaf decayed at the VQ weight decay
    model = ClipMatcher(cfg, generator=torch.Generator().manual_seed(SEED),
                        device=dev)
    ps = [p.data for p in make_vq_optimizer(model, cfg).params]
    del model
    check_adamw(chk, "VQ", ps, [True] * len(ps), f32, cfg.weight_decay)
    del ps
    if not chk.ok:
        fail("a VQ kernel disagrees with its plain version")
    return chk.errs, chk.top


def redraw_heads(model, seed: int):
    """The two output convs drawn at a normal scale (their N(0, 1e-6) init
    makes every output equal its bias), from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in (model.head.reg_head, model.head.cls_head):
            w = torch.randn(m.weight.shape, generator=gen) \
                * m.weight[0].numel() ** -0.5
            m.weight.copy_(w)
            m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)


def phase_vq_parity(dev):
    """vq_flagship_config() at batch 1 with 30 frames in f32: the card with
    its kernels against the CPU with the plain versions, on the deltas and
    the logits, and a TF32 control that must read above the limit (the
    MQ/NLQ limit holds: f32 reads ~5e-6 here, TF32 ~1.5e-3)."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher

    cfg = vq_flagship_config()
    model = ClipMatcher(cfg, generator=torch.Generator().manual_seed(SEED),
                        device="cpu", compute_dtype=torch.float32).eval()
    redraw_heads(model, SEED + 13)
    rng = np.random.default_rng(SEED + 14)
    S = cfg.clip_size
    clip = torch.from_numpy(rng.random((1, cfg.num_frames, S, S, 3),
                                       np.float32))
    query = torch.from_numpy(rng.random((1, S, S, 3), np.float32))

    def deltas(out):
        refine = torch.cat([out["center"], 2 * out["hw"]], -1).cpu()
        return {"deltas": refine - model.anchors_xyhw,
                "logits": out["prob"].cpu()}

    t0 = time.perf_counter()
    with torch.no_grad():
        ref = deltas(model(clip, query))
        cpu_s = time.perf_counter() - t0
        gpu = copy.deepcopy(model).to(dev)
        out = deltas(gpu(clip.to(dev), query.to(dev)))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tf32 = deltas(gpu(clip.to(dev), query.to(dev)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    worst, control = 0.0, 0.0
    for key, r in ref.items():
        for o in (out[key], tf32[key]):
            if o.shape != r.shape or not torch.isfinite(o).all():
                fail(f"vq_parity: {key} shape {tuple(o.shape)} or non-finite")
        rel = lambda o: ((o - r).abs().max() / r.abs().max()).item()
        worst, control = max(worst, rel(out[key])), max(control,
                                                        rel(tf32[key]))
        say(f"[vq_parity] {key} {tuple(r.shape)} f32 card vs CPU: max rel "
            f"err {rel(out[key]):.3e} (tol {PARITY_RTOL:g}); TF32 "
            f"{rel(tf32[key]):.3e}; max |ref| {r.abs().max().item():.4f}")
    say(f"[vq_parity] CPU forward {cpu_s:.1f} s; control, TF32 allowed on "
        f"the card: max rel err {control:.3e} (must exceed tol "
        f"{PARITY_RTOL:g})")
    if worst > PARITY_RTOL:
        fail("vq_parity: full-width parity out of tolerance")
    if control <= PARITY_RTOL:
        fail("vq_parity: the check does not see TF32: tolerance too loose")
    del gpu, model
    torch.cuda.empty_cache()


VQ_PARITY_BATCH = 2    # 4 HNM pairs: every clip also against a foreign query
VQ_REG_LAMBDA = 3000.0  # the --cl-methods VQ step's penalty weight (NLQ's)
VQ_PE_LEAF = "pe_3d"
# Activation gradients, unlike a weight's gradient not a sum over every
# position: the 3-D position table's (the sum over the pairs of the
# gradient at its add; the pairs do not cancel at its largest element, the
# cancellation ratio reads 1) and that per-pair gradient. Card vs CPU they
# read 2.2e-3 to 5.6e-3 over seeds 0-2, the card through the plain
# versions (cuBLAS/cuDNN, no kernel of the port) 2.4e-3 to 5.7e-3 as well,
# TF32 5.3e-2 to 1.6e-1 (H100 80GB HBM3, 700 W).
ACT_GRAD_RTOL = 1e-2


def vq_grad_gaps(r, base):
    """Gaps of one VQ step result to another: the worst relative gradient
    gap of the leaves but the position table; the position table's,
    relative to its largest |gradient|; the per-pair gradient's at the
    table's add, relative to its largest."""
    pick = lambda x, keep: {n: g for n, g in x["grads"].items()
                            if (n == VQ_PE_LEAF) == keep}
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    return (rel_by_leaf(pick(r, False), pick(base, False), 1e-4)[0],
            rel(r["grads"][VQ_PE_LEAF], base["grads"][VQ_PE_LEAF]),
            rel(r["pe_pairs"], base["pe_pairs"]))


def phase_vq_train_parity(dev, seed: int = SEED, tag="vq_train_parity",
                          batch_size: int = VQ_PARITY_BATCH,
                          accumulation_steps: int = 1, reg_k: int = 0):
    """One VQ HNM train step of vq_flagship_config() in f32 (head dropout
    off) at batch VQ_PARITY_BATCH x 30 frames, full width: the card against
    the CPU from the same weights and batch (drawn from `seed`; output
    convs redrawn at a normal scale), on the loss, the grad norm and every
    trainable leaf's gradient, with the TF32 control and the card through
    the plain versions (the kernels' share of the gap). The limits are the
    MQ step's (torch against torch in f32; the CPU tests hold the port to
    JAX in f64 only because JAX's own f32 GroupNorm gradient is 6.6e-4
    off). The position table's gradient and the per-pair gradient it sums
    (caught by a hook on st_0's input) are activation gradients, held at
    ACT_GRAD_RTOL; the cancellation ratio of that sum (largest |sum| over
    largest sum of |terms|) is printed. Updated parameters and
    moments are printed, not held: the first Adam step moves each weight
    by about lr * sign(g), so a near-zero gradient whose sign differs
    moves a zero-initialised bias by 2 lr against its max of lr. With
    `accumulation_steps` the batch of `batch_size` clips goes in that many
    micro-batches (the per-pair gradient is the first one's); with `reg_k`
    the step carries an EWC penalty at lambda VQ_REG_LAMBDA over `reg_k`
    synthetic tasks of every leaf (the frozen ViT's included), its value
    held card against CPU at 1e-5."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.data.synthetic import make_vq_batch
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.train.engine import batch_to
    from vilco_tpu_torch.train.vq_engine import (
        init_vq_train_state,
        make_vq_train_step,
    )

    cfg = dataclasses.replace(vq_flagship_config(), batch_size=batch_size,
                              accumulation_steps=accumulation_steps)
    batch = make_vq_batch(np.random.default_rng(seed + 18), cfg.batch_size,
                          cfg)

    template = ClipMatcher(cfg, generator=torch.Generator().manual_seed(
        seed), device="cpu", compute_dtype=torch.float32)
    redraw_heads(template, seed + 13)
    reg = None if not reg_k else synthetic_reg_tasks(template, reg_k,
                                                     seed + 19)

    def run(device, tf32: bool, plain: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        model = copy.deepcopy(template)
        st = init_vq_train_state(model, cfg, seed=seed, device=device)
        if plain:
            st.opt._table = None        # AdamW through its plain version
        pairs = []                      # d loss / d (tokens + pe_3d)

        def catch(mod, args):
            args[0].register_hook(pairs.append)
        model.st_0.register_forward_pre_hook(catch)
        step = make_vq_train_step(cfg, deterministic=True)
        pen = None
        if reg is not None:
            from vilco_tpu_torch.cl.regularizers import RegPenalty

            pen = RegPenalty.for_optimizer(reg, st.opt, VQ_REG_LAMBDA,
                                           model=model)
        t0 = time.perf_counter()
        with plain_versions() if plain else contextlib.nullcontext():
            met = step(st, batch_to(batch, device), reg=pen)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        o = st.opt
        res = dict(
            loss=met["final_loss"].item(), gnorm=met["grad_norm"].item(),
            grads={n: p.grad.cpu() for n, p in zip(o.names, o.params)},
            params={n: p.detach().cpu() for n, p in zip(o.names, o.params)},
            mu={n: t.cpu() for n, t in zip(o.names, o.mu)},
            nu={n: t.cpu() for n, t in zip(o.names, o.nu)}, secs=secs,
            pe_pairs=pairs[0].cpu(),
            metrics={k: v.item() for k, v in met.items()})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        del model, st
        return res

    ref = run("cpu", False)
    card = run(dev, False)
    plain = run(dev, False, plain=True)
    ctrl = run(dev, True)
    torch.cuda.empty_cache()
    K = cfg.accumulation_steps
    say(f"[{tag}] VQ, seed {seed}: one f32 HNM step at batch "
        f"{cfg.batch_size} in {K} micro-batch{'es' if K > 1 else ''} "
        f"({K * (cfg.batch_size // K) ** 2} pairs) x {cfg.num_frames} "
        f"frames, {len(ref['grads'])} trainable leaves: CPU "
        f"{ref['secs']:.1f} s, card {card['secs']:.3f} s (first call) "
        f"[{CARD}]")
    gaps = {}
    for label, r, base, base_label in (
            ("card", card, ref, "CPU"),
            ("TF32 control", ctrl, ref, "CPU"),
            ("kernel gap: card kernels", card, plain, "card plain"),
            ("library gap: card plain", plain, ref, "CPU")):
        g = gaps[label] = step_gaps(r, base)
        say_gaps(tag, label, r, base, base_label, g)
    c = gaps["card"]
    pe_max = ref["grads"][VQ_PE_LEAF].abs().max().item()
    pe_terms = ref["pe_pairs"].abs().sum(0).max().item()
    say(f"[{tag}] {VQ_PE_LEAF}: the sum over {ref['pe_pairs'].shape[0]} "
        f"pairs of the gradient at its add; on the CPU max |sum| "
        f"{pe_max:.6e}, max sum |terms| {pe_terms:.6e}, cancellation ratio "
        f"{pe_max / pe_terms:.4f}")
    vg = {}
    for label, r, base in (("card", card, ref), ("kernel gap", card, plain),
                           ("library gap", plain, ref),
                           ("TF32 control", ctrl, ref)):
        g = vg[label] = vq_grad_gaps(r, base)
        say(f"[{tag}] {label}: other leaves {g[0]:.3e}; {VQ_PE_LEAF} "
            f"{g[1]:.3e}; the per-pair gradient at its add {g[2]:.3e}")
    say(f"[{tag}] limits: loss and grad norm 1e-5 relative; gradients "
        f"{GRAD_RTOL:g}, {VQ_PE_LEAF} and the per-pair gradient "
        f"{ACT_GRAD_RTOL:g}; the card and the kernel gap alone; the TF32 "
        f"control must read above each [{CARD}]")
    lims = (GRAD_RTOL, ACT_GRAD_RTOL, ACT_GRAD_RTOL)
    within = lambda g: all(x <= lim for x, lim in zip(g, lims))
    if max(c["loss"], c["gnorm"]) > 1e-5 or not within(vg["card"]):
        fail(f"{tag}: out of tolerance")
    if not within(vg["kernel gap"]):
        fail(f"{tag}: the kernels alone move the gradients past the limit")
    if any(x <= lim for x, lim in zip(vg["TF32 control"], lims)):
        fail(f"{tag}: the check does not see TF32: limit too loose")
    if reg is not None:
        pen = (card["metrics"]["reg_penalty"], ref["metrics"]["reg_penalty"])
        rel = abs(pen[0] - pen[1]) / abs(pen[1])
        say(f"[{tag}] EWC penalty at lambda {VQ_REG_LAMBDA:g} over {reg_k} "
            f"task of every leaf: card {pen[0]:.6e}, CPU {pen[1]:.6e} (rel "
            f"{rel:.3e}, tol 1e-5)")
        if rel > 1e-5:
            fail(f"{tag}: the penalty's value out of tolerance")


def vq_request_parts(marks):
    """ms of (ViT, matcher, top anchor, peak finding) from the marks of one
    or more requests, summed."""
    ev = [e for e in marks if e[0] != "peaks_ms"]
    parts = [0.0, 0.0, 0.0, sum(v for k, v in marks if k == "peaks_ms")]
    for i in range(0, len(ev), 4):
        chunk = dict(ev[i:i + 4])
        parts[0] += chunk["start"].elapsed_time(chunk["vit"])
        parts[1] += chunk["vit"].elapsed_time(chunk["matcher"])
        parts[2] += chunk["matcher"].elapsed_time(chunk["top"])
    return parts


def phase_vq_serve(dev, kernels, mlp_kernel, cfg=None, tag="vq_serve",
                   want=None):
    """Requests of one clip of eval_windows x num_frames frames plus a
    query, 448-square bf16 frames on the card, through predict_track: 2
    warm-up and 5 timed; frames/s, ms per request split into ViT / matcher
    / top anchor / peak finding, peak memory, launches (set to 0 just
    before) against `want` (launches per request by kernel name; the
    default path's when None), one profiled request, then, given
    `mlp_kernel`, one request with the ViT's MLP on the fused kernel.
    `cfg` defaults to vq_flagship_config()."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.tasks.vq import predict_track

    cfg = cfg or vq_flagship_config()

    def build(use_fused_mlp):
        model = ClipMatcher(cfg, use_fused_mlp,
                            torch.Generator().manual_seed(SEED), dev)
        redraw_heads(model, SEED + 15)
        return model

    model = build(False)
    S, T = cfg.clip_size, cfg.eval_windows * cfg.num_frames
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    requests = [(torch.rand((T, S, S, 3), generator=gen, device=dev,
                            dtype=torch.bfloat16),
                 torch.rand((S, S, 3), generator=gen, device=dev,
                            dtype=torch.bfloat16)) for _ in range(7)]
    qf = T - cfg.num_frames // 2

    def serve(req, marks=None):
        t0 = time.perf_counter()
        track = predict_track(model, *req, qf, marks=marks)
        torch.cuda.synchronize()
        return track, (time.perf_counter() - t0) * 1e3

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    for req in requests[:2]:
        serve(req)
    walls, parts, tracks = [], [], []
    for req in requests[2:]:
        marks = []
        track, ms = serve(req, marks)
        walls.append(ms)
        parts.append(vq_request_parts(marks))
        tracks.append(track)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for track in tracks:
        if not track.bboxes or not all(
                0 <= b.fno < T and np.isfinite([b.x1, b.y1, b.x2, b.y2]).all()
                for b in track.bboxes):
            fail(f"{tag}: an empty or non-finite response track")
    med = [statistics.median(p[j] for p in parts) for j in range(4)]
    n_req = len(walls)
    say(f"[{tag}] VQ flagship bf16 (f32 masters), ViT attention "
        f"{cfg.vit_attn_impl!r}, one {T}-frame "
        f"{S}x{S} clip + query per request ({cfg.eval_windows} windows of "
        f"{cfg.num_frames}), {n_req} timed requests: "
        f"{T * n_req / (sum(walls) / 1e3):.3f} frames/s, "
        f"{statistics.median(walls):.3f} ms/request (median; ViT "
        f"{med[0]:.3f}, matcher {med[1]:.3f}, top anchor {med[2]:.3f} ms "
        f"by CUDA events, peak finding {med[3]:.3f} ms host); peak memory "
        f"{peak:.3f} GiB [{CARD}]")
    say(f"[{tag}] track lengths {[t.length for t in tracks]}; launches "
        f"in the {len(requests)} requests: {launches}")
    want = want or {"fused_attention_blc": 2 * cfg.vit_depth + 2,
                    "frame_band_attention": cfg.num_transformer}
    check_launches(tag, launches, want, len(requests), "request")
    phase_trace(f"{tag} request", lambda: serve(requests[-1]),
                statistics.median(walls))

    del model
    if mlp_kernel is None:
        del requests
        torch.cuda.empty_cache()
        return launches, None
    model = build(True)            # the same weights, the MLP on K7
    serve(requests[0])             # warm-up
    for k in kernels + (mlp_kernel,):
        k.launches = 0
    track, ms = serve(requests[-1])
    mlp_launches = {k.__name__: k.launches for k in kernels + (mlp_kernel,)}
    say(f"[vq_serve] one request with the ViT MLP on fused_mlp, after one "
        f"warm-up: {ms:.3f} ms (the default path's median "
        f"{statistics.median(walls):.3f} ms); launches {mlp_launches}; track "
        f"frames {track.temporal_extent} vs {tracks[-1].temporal_extent} "
        f"[{CARD}]")
    if mlp_launches[mlp_kernel.__name__] != 2 * cfg.vit_depth:
        fail("vq_serve: fused_mlp was not launched once per ViT block")
    phase_trace("vq_serve fused-MLP request", lambda: serve(requests[-1]),
                ms)
    del model, requests
    torch.cuda.empty_cache()
    return launches, mlp_launches


def phase_vq_train(dev, kernels):
    """The VQ train step in bf16 with f32 masters, HNM on (batch 4 -> 16
    pairs), head dropout 0.2, on one fixed batch: 2 warm-up and 10 timed
    steps, ms split into forward / backward / optimizer, every loss, peak
    memory, launches (set to 0 just before), the frozen backbone
    bit-identical after the steps, then one step profiled."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.data.synthetic import make_vq_batch
    from vilco_tpu_torch.models.clip_matcher import ClipMatcher
    from vilco_tpu_torch.train.engine import batch_to
    from vilco_tpu_torch.train.vq_engine import (
        init_vq_train_state,
        make_vq_train_step,
    )

    cfg = vq_flagship_config()
    model = ClipMatcher(cfg, generator=torch.Generator().manual_seed(SEED),
                        device=dev)
    st = init_vq_train_state(model, cfg, seed=SEED, device=dev)
    step = make_vq_train_step(cfg)
    batch = batch_to(make_vq_batch(np.random.default_rng(SEED + 17),
                                   cfg.batch_size, cfg), dev)
    backbone0 = [p.detach().clone() for p in model.backbone.parameters()]
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, parts = [], [], []
    for i in range(12):
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(st, batch, marks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        losses.append({k: v.item() for k, v in met.items()})
        if i >= 2:
            walls.append(wall)
            ev = dict(marks)
            parts.append([ev["start"].elapsed_time(ev["forward"]),
                          ev["forward"].elapsed_time(ev["backward"]),
                          ev["backward"].elapsed_time(ev["optimizer"])])
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = [statistics.median(p[j] for p in parts) for j in range(3)]
    B = cfg.batch_size
    secs = sum(walls) / 1e3
    n_train = sum(p.numel() for p in st.opt.params)
    say(f"[vq_train] VQ flagship bf16 (f32 masters), batch {B} x "
        f"{cfg.num_frames} frames, HNM ({B * B} pairs), head dropout "
        f"{cfg.dropout}, {len(st.opt.params)} trainable leaves ({n_train} "
        f"parameters), {len(walls)} timed steps: "
        f"{statistics.median(walls):.3f} ms/step (median; forward "
        f"{med[0]:.3f}, backward {med[1]:.3f}, optimizer {med[2]:.3f} ms by "
        f"CUDA events), {len(walls) / secs:.3f} steps/s, "
        f"{B * len(walls) / secs:.3f} clips/s; peak memory {peak:.3f} GiB "
        f"[{CARD}]")
    for key in ("final_loss", "loss_center", "loss_hw", "loss_giou",
                "loss_prob", "num_pos", "grad_norm"):
        say(f"[vq_train] {key} " + ", ".join(f"{m[key]:.6f}" for m in losses))
    say(f"[vq_train] launches in the {len(losses)} steps: {launches}")
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        fail("vq_train: a loss is not finite")
    if not losses[-1]["final_loss"] < losses[0]["final_loss"]:
        fail("vq_train: the training loss did not decrease")
    if min(launches.values()) < 1:
        fail("vq_train: a kernel of the train path was never launched")
    if launches.get("frame_band_bwd_cuda") != cfg.num_transformer * len(
            losses):
        fail("vq_train: frame_band_bwd_cuda was not launched once per "
             "spatio-temporal layer a step")
    if not all(torch.equal(a, b)
               for a, b in zip(backbone0, model.backbone.parameters())):
        fail("vq_train: the frozen backbone changed")
    say("[vq_train] the backbone's "
        f"{sum(p.numel() for p in backbone0)} parameters are bit-identical "
        "after the steps")
    phase_trace("vq_train step", lambda: step(st, batch),
                statistics.median(walls))
    del model, st, batch
    torch.cuda.empty_cache()
    return launches


# ---- the attention ablations: head-major (K1n) and flash (K1f) attention,
# and the VQ attention probe (P2) ---------------------------------------------


def flash_pairs(T: int, m) -> int:
    """(query, key) pairs K1f weighs for T queries over the mask m (B, T):
    each row's valid keys, or all T keys of a fully masked row (which
    averages v)."""
    n = m.sum(1)
    return T * int(torch.where(n > 0, n, m.shape[1]).sum())


def flash_work(T, m, C, H, dtype, which):
    """(flops, bytes) of K1f: 2 C operations per weighed pair for each
    product the function needs (forward q.k, p.v; backward q.k, dO.v,
    p^T dO, dS^T q, dS k) and 2 C per row for delta. Bytes: the mask, q,
    k, v (and out, dout) read once, each output written once, m and l (f32
    per row and head) read by the backward."""
    pairs = flash_pairs(T, m)
    el = torch.empty((), dtype=dtype).element_size()
    B = m.shape[0]
    rows, stats = B * T * C * el, 8 * B * H * T
    if which == "fwd":
        return 4 * C * pairs, 4 * rows + m.numel()
    return 10 * C * pairs + 2 * B * T * C, 8 * rows + stats + m.numel()


def sdpa_on_valid_rows(m):
    """(SDPA with the boolean key mask m (B, T) on (B', H, T, D) heads,
    the selection of the B' batch rows that have a valid key (SDPA gives
    NaN on the others) from (B, T, H, D) heads). The selection copies, so
    it is made once, outside the timed call."""
    keep = m.any(1)
    am = m[keep][:, None, None, :]
    return (lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=am)), lambda x: x[keep].transpose(1, 2)


def check_masked_row(label, impl, outs, v, tol):
    """The fully masked last row: 0 for K1n (and its gradients), the mean of
    v over every key for K1f's output."""
    if impl == "pallas_naive":
        zero_row(label, outs)
        return
    want = v[-1].float().mean(0, keepdim=True).expand_as(outs[0][-1])
    err = (outs[0][-1].float() - want).abs().max().item()
    if err > tol * max(1.0, want.abs().max().item()):
        fail(f"{label}: the fully masked row is {err:.3e} off the mean of v")


def phase_attn_impl_kernels(dev):
    from vilco_tpu_torch.core.config import (
        flagship_config,
        vq_flagship_config,
    )
    from vilco_tpu_torch.kernels.attention import (
        KERNEL_MIN_T,
        flash_attention,
        flash_attention_plain,
        flash_bwd_cuda,
        flash_fwd_cuda,
        fused_attention,
        fused_attention_bwd_cuda,
        fused_attention_fwd_cuda,
        fused_attention_plain,
    )

    cfg = flagship_config().model
    T0, C, H = cfg.max_seq_len, cfg.embd_dim, cfg.n_head
    D, nb = C // H, cfg.num_branch_layers
    levels = [T for T in [T0] + [T0 >> (i + 1) for i in range(nb)]
              if T >= KERNEL_MIN_T]
    rng = np.random.default_rng(SEED + 18)
    chk = KernelChecks("attn_impl_kernels", ("naive_fwd", "naive_bwd",
                                             "flash_fwd", "flash_bwd",
                                             "flash_vit", "flash_vit_bwd"))
    report = chk.report
    fold = lambda x: x.permute(2, 0, 1, 3).contiguous()
    impls = {"pallas_naive": (fused_attention, fused_attention_plain),
             "flash": (flash_attention, flash_attention_plain)}

    def randn(*shape, dtype):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        for T in levels:
            # forward at the serving batch
            q, k, v = (randn(B_SERVE, T, H, D, dtype=dtype) for _ in range(3))
            m = ragged_mask(rng, B_SERVE, T, dev)
            sdpa, rows = sdpa_on_valid_rows(m)
            qh, kh, vh = rows(q), rows(k), rows(v)
            qf, kf, vf = fold(q), fold(k), fold(v)
            label = f"B={B_SERVE} T={T} H={H} D={D}"
            top = dtype == bf16 and T == T0
            for impl, (fn, plain) in impls.items():
                with torch.no_grad():
                    out = fn(q, k, v, m)
                    ref = plain(q, k, v, m)
                check_masked_row(f"{impl} forward {label}", impl, [out], v,
                                 FWD_TOL[dtype])
                naive = impl == "pallas_naive"
                report("naive_fwd" if naive else "flash_fwd",
                       f"{'K1n' if naive else 'K1f'} forward {label}", dtype,
                       output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
                       (lambda: fused_attention_fwd_cuda(qf, kf, vf, m, False))
                       if naive else (lambda: flash_fwd_cuda(q, k, v, m,
                                                             False)),
                       lambda: plain(q, k, v, m),
                       attention_work(T, m, C, dtype, backward=False) if naive
                       else flash_work(T, m, C, H, dtype, "fwd"),
                       lambda: sdpa(qh, kh, vh), is_top=top)
                del out, ref
            del q, k, v, qf, kf, vf, qh, kh, vh

            # backward at the training batch
            q, k, v, g = (randn(B_TRAIN, T, H, D, dtype=dtype)
                          for _ in range(4))
            m = ragged_mask(rng, B_TRAIN, T, dev)
            sdpa, rows = sdpa_on_valid_rows(m)
            lib_bwd = backward_timer(sdpa, (rows(q), rows(k), rows(v)),
                                     rows(g))
            label = f"B={B_TRAIN} T={T} H={H} D={D}"
            top = dtype == bf16 and T == T0
            for impl, (fn, plain) in impls.items():
                got = grads_of(lambda *a: fn(*a, m), (q, k, v), g)
                want = grads_of(lambda *a: plain(*a, m), (q, k, v), g)
                torch.cuda.synchronize()
                if impl == "pallas_naive":
                    zero_row(f"K1n backward {label}", got)
                plain_bwd = backward_timer(lambda *a: plain(*a, m),
                                           (q, k, v), g)
                if impl == "pallas_naive":
                    qf, kf, vf, gf = fold(q), fold(k), fold(v), fold(g)
                    o, lse = fused_attention_fwd_cuda(qf, kf, vf, m, True)
                    report("naive_bwd", f"K1n backward {label}", dtype,
                           output_errors(("dq", "dk", "dv"), got, want,
                                         TRAIN_TOL[dtype]),
                           lambda: fused_attention_bwd_cuda(
                               qf, kf, vf, m, o, lse, gf),
                           plain_bwd,
                           attention_work(T, m, C, dtype, backward=True),
                           lib_bwd, is_top=top)
                    del qf, kf, vf, gf, o, lse
                else:
                    o, mx, l = flash_fwd_cuda(q, k, v, m, True)
                    args = (q, k, v, m, o, mx, l, g)
                    check_repeatable(
                        "attn_impl_kernels", f"K1f backward {label} "
                        f"{str(dtype)[6:]}", lambda: flash_bwd_cuda(*args))
                    # SDPA's backward through autograd is the host's at
                    # these shapes: each call queued behind a sleep
                    report("flash_bwd", f"K1f backward (delta, dk/dv, dq) "
                           f"{label}", dtype,
                           output_errors(("dq", "dk", "dv"), got, want,
                                         TRAIN_TOL[dtype]),
                           lambda: flash_bwd_cuda(*args), plain_bwd,
                           flash_work(T, m, C, H, dtype, "bwd"), lib_bwd,
                           is_top=top, queued=True)
                    del o, mx, l, args
                del got, want, plain_bwd
            del q, k, v, g, lib_bwd
            torch.cuda.empty_cache()

    # K1f in the ViT (1025 tokens, 12 heads of 64, every key valid): the
    # serving request's clip and query calls in bf16, the f32 parity
    # forward's 30 frames; the backward at the query call's 8 frames (the
    # ViT is frozen on the VQ path: no step runs it)
    vq = vq_flagship_config()
    Lv, Cv, Hv = (vq.clip_size // vq.patch_size) ** 2 + 1, vq.vit_dim, \
        vq.vit_heads
    for dtype, B in ((bf16, vq.eval_windows * vq.num_frames),
                     (bf16, vq.eval_windows), (f32, vq.num_frames)):
        q, k, v = (randn(B, Lv, Hv, Cv // Hv, dtype=dtype) for _ in range(3))
        m = torch.ones(B, Lv, dtype=torch.bool, device=dev)
        with torch.no_grad():
            out = flash_attention(q, k, v, m)
            ref = flash_attention_plain(q, k, v, m)
        report("flash_vit", f"K1f forward (ViT) B={B} T={Lv} H={Hv} "
               f"D={Cv // Hv}", dtype,
               output_errors(("out",), [out], [ref], FWD_TOL[dtype]),
               lambda: flash_fwd_cuda(q, k, v, m, False),
               lambda: flash_attention_plain(q, k, v, m),
               flash_work(Lv, m, Cv, Hv, dtype, "fwd"),
               lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
               is_top=(dtype, B) == (bf16, vq.eval_windows * vq.num_frames),
               reps=5)
        if (dtype, B) == (bf16, vq.eval_windows):
            g = randn(B, Lv, Hv, Cv // Hv, dtype=dtype)
            got = grads_of(lambda *a: flash_attention(*a, m), (q, k, v), g)
            want = grads_of(lambda *a: flash_attention_plain(*a, m),
                            (q, k, v), g)
            o, mx, l = flash_fwd_cuda(q, k, v, m, True)
            args = (q, k, v, m, o, mx, l, g)
            label = f"(ViT) B={B} T={Lv} H={Hv} D={Cv // Hv}"
            check_repeatable("attn_impl_kernels", f"K1f backward {label} "
                             "bfloat16", lambda: flash_bwd_cuda(*args))
            th = lambda x: x.transpose(1, 2)
            report("flash_vit_bwd", f"K1f backward {label}", dtype,
                   output_errors(("dq", "dk", "dv"), got, want,
                                 TRAIN_TOL[dtype]),
                   lambda: flash_bwd_cuda(*args),
                   backward_timer(lambda *a: flash_attention_plain(*a, m),
                                  (q, k, v), g),
                   flash_work(Lv, m, Cv, Hv, dtype, "bwd"),
                   backward_timer(
                       lambda a, b, c: F.scaled_dot_product_attention(
                           th(a), th(b), th(c)), (q, k, v), th(g)),
                   is_top=True, reps=5, queued=True)
            del g, got, want, o, mx, l, args
        del q, k, v, m, out, ref
        torch.cuda.empty_cache()
    if not chk.ok:
        fail("a K1n or K1f kernel disagrees with its plain version")
    return chk.errs, chk.top


def phase_vq_attn_probe(dev):
    """P2: each variant at the probe's shape against its plain version
    (kernel, plain and SDPA ms, the bound), then the probe itself with its
    launches counted: one JSON line per variant."""
    from vilco_tpu_torch.kernels.attention import (
        probe_variant,
        probe_variant_plain,
    )
    from vilco_tpu_torch.tools import probe_vq_attn as probe

    bf16 = torch.bfloat16
    probe_variant.launches = 0
    rows = probe.run(SEED + 19, dev)
    launches = probe_variant.launches
    chk = KernelChecks("vq_attn_probe", [r["variant"] for r in rows])
    q, k, v, m = probe.make_inputs(SEED + 19, dev)
    sdpa, select = sdpa_on_valid_rows(m)
    qh, kh, vh = (select(x.view(probe.B, probe.L, probe.H, probe.D))
                  for x in (q, k, v))
    for row, (name, bs, ms) in zip(rows, probe.VARIANTS):
        print(json.dumps(row))
        chk.report(name, f"probe_variant {name} B={probe.B} T={probe.L} "
                   f"({probe.VALID} valid) C={probe.C} H={probe.H}", bf16,
                   [("out", row["max_abs_err_plain"],
                     FWD_TOL[bf16] * max(1.0, row["max_abs_plain"]))],
                   lambda: probe_variant(q, k, v, m, probe.H, bs, ms),
                   lambda: probe_variant_plain(q, k, v, m, probe.H, bs, ms),
                   attention_work(probe.L, m, probe.C, bf16, backward=False),
                   lambda: sdpa(qh, kh, vh), is_top=True, reps=5)
    say(f"[vq_attn_probe] launches in the probe's run: {launches} "
        f"(each variant: one warm-up, 10 timed, one checked)")
    if launches < len(rows):
        fail("vq_attn_probe: the probe did not launch its kernel")
    if not chk.ok:
        fail("a probe variant disagrees with its plain version")
    del q, k, v, m, qh, kh, vh
    torch.cuda.empty_cache()
    return chk.errs, chk.top, launches


def impl_config(full, impl: str):
    """`full` (a Config) with the model's attention_impl set to `impl`."""
    return dataclasses.replace(full, model=dataclasses.replace(
        full.model, attention_impl=impl))


def attention_ablations(dev, mq):
    """The attention ablations: K1n and K1f against their plain versions,
    the VQ attention probe (P2), then the MQ flagship `mq` under each
    attention_impl (parity, serving, training, each request's and step's
    launches checked) and the VQ flagship with the flash ViT. Returns the
    errors, timings and launch counts for the kernels line."""
    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        KERNEL_MIN_T,
        attention_bwd_cuda,
        flash_attention,
        flash_bwd_cuda,
        fused_attention,
        fused_attention_blc,
        fused_attention_bwd_cuda,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
    )
    from vilco_tpu_torch.kernels.frame_band import frame_band_attention
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_rel_attention,
    )

    aerrs, atop = phase_attn_impl_kernels(dev)
    perrs, ptop, probe_launches = phase_vq_attn_probe(dev)
    # the attention lengths of the stem blocks and the stride-2 branch
    # blocks; from KERNEL_MIN_T on they take the impl's kernel, K1 below
    T0 = mq.model.max_seq_len
    lengths = [T0] * mq.model.backbone_arch[1] + [
        T0 >> (i + 1) for i in range(mq.model.num_branch_layers)]
    n_kernel = sum(T >= KERNEL_MIN_T for T in lengths)
    n_k1 = len(lengths) - n_kernel
    per_impl = {
        "flash": (flash_attention, (flash_bwd_cuda,)),
        "pallas_naive": (fused_attention, (fused_attention_bwd_cuda,))}
    impl_serve, impl_train = {}, {}
    for impl, (fwd, bwds) in per_impl.items():
        tag = "mq_flash" if impl == "flash" else "mq_naive"
        full = impl_config(mq, impl)
        phase_parity(dev, f"{tag}_parity", full.model,
                     mq_parity_inputs(mq.model))
        requests = mq_requests(mq.model, dev)
        launches = impl_serve[impl] = phase_serve(
            dev, f"{tag}_serve", full, requests,
            (fwd, fused_attention_blc, xl_rel_attention, fused_dwconv_qkv))
        check_launches(f"{tag}_serve", launches,
                       {fwd.__name__: n_kernel, "fused_attention_blc": n_k1},
                       len(requests), "request")
        del requests
        launches = impl_train[impl] = phase_train(
            dev, f"{tag}_train", full,
            (fwd, *bwds, fused_attention_blc, attention_bwd_cuda,
             xl_rel_attention, xl_bwd_cuda, fused_dwconv_qkv,
             dwconv_bwd_cuda, adamw_update_multi),
            SEED + 5, normalised_must_fall=True)
        check_launches(f"{tag}_train", launches,
                       {fwd.__name__: n_kernel,
                        **{b.__name__: n_kernel for b in bwds},
                        "fused_attention_blc": n_k1,
                        "attention_bwd_cuda": n_k1},
                       12, "step")
    vq = vq_flagship_config()
    vq_flash, _ = phase_vq_serve(
        dev, (flash_attention, fused_attention_blc, frame_band_attention),
        None, dataclasses.replace(vq, vit_attn_impl="flash"),
        "vq_flash_serve",
        {"flash_attention": 2 * vq.vit_depth, "fused_attention_blc": 2,
         "frame_band_attention": vq.num_transformer})

    return dict(errs=aerrs, top=atop, probe_errs=perrs, probe_top=ptop,
                probe_launches=probe_launches, serve=impl_serve,
                train=impl_train, vq_flash=vq_flash)


def kernel_kind(name: str) -> str:
    if any(k in name for k in ("attention_blc", "xl_rel_attention",
                               "dwconv_qkv", "adamw_kernel", "banded_",
                               "mlp_wgmma", "mlp_simt")):
        return "port kernels"
    if "conv" in name or "cudnn" in name:
        return "cuDNN conv"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "GEMM"
    if any(k in name for k in ("reduce", "norm", "softmax", "sort", "radix",
                               "scan", "topk", "cub")):
        return "reduce/sort"
    if any(k in name for k in ("elementwise", "vectorized", "unrolled",
                               "copy", "Memcpy", "Memset", "fill", "index",
                               "where", "cat")):
        return "elementwise/copy"
    return "other"


def phase_trace(label: str, fn, unprofiled_ms: float):
    """Run `fn` once under torch.profiler. Device time is the sum of the
    kernels' own times in the trace; the idle share compares it with the
    host time of the same profiled call."""
    out, host_ms, rows = device_rows(fn, f"trace {label}")
    dev_ms = sum(r[0] for r in rows)
    say(f"[trace] {label}: host {host_ms:.3f} ms profiled, "
        f"{unprofiled_ms:.3f} ms unprofiled (median of this run); device "
        f"{dev_ms:.3f} ms in {sum(r[1] for r in rows)} kernels; idle "
        f"share {1 - dev_ms / host_ms:.3f} of the profiled call [{CARD}]")
    kinds = {}
    for ms, n, key in rows:
        k = kinds.setdefault(kernel_kind(key), [0.0, 0])
        k[0] += ms
        k[1] += n
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        say(f"[trace] {label}:   {kind}: {ms:.3f} ms, {n} launches")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        say(f"[trace] {label}:   {ms:.3f} ms x{n} {key[:90]}")
    return out


def vq_train_kernels():
    """The kernels of the VQ HNM step whose launches phase_vq_train counts."""
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        fused_attention_blc,
    )
    from vilco_tpu_torch.kernels.frame_band import (
        frame_band_attention,
        frame_band_bwd_cuda,
    )

    return (fused_attention_blc, attention_bwd_cuda, frame_band_attention,
            frame_band_bwd_cuda, adamw_update_multi)


def mq_training(dev, mq):
    """The MQ flagship's training phases: train_kernels, train_parity and
    train; returns the kernel errors, their timings and the step's
    launches."""
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        fused_attention_blc,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
    )
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_rel_attention,
    )

    terrs, ttop = phase_train_kernels(dev)
    phase_train_parity(dev)
    launches = phase_train(
        dev, "train", mq, (fused_attention_blc, attention_bwd_cuda,
                           xl_rel_attention, xl_bwd_cuda, fused_dwconv_qkv,
                           dwconv_bwd_cuda, adamw_update_multi),
        SEED + 5, normalised_must_fall=True)
    return terrs, ttop, launches


def main():
    t_start = last = time.perf_counter()

    def took(what):        # wall seconds of each group of phases
        nonlocal last
        now = time.perf_counter()
        say(f"[time] {what}: {now - last:.1f} s; {now - t_start:.1f} s "
            "since the start")
        last = now

    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    took("device and build")
    from vilco_tpu_torch.core.config import flagship_config, \
        mq_yaml_config, nlq_flagship_config
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        fused_attention_blc,
    )
    from vilco_tpu_torch.kernels.banded_attention import (
        banded_attention_blc,
        banded_bwd_cuda,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
    )
    from vilco_tpu_torch.kernels.frame_band import frame_band_attention
    from vilco_tpu_torch.kernels.mlp import fused_mlp
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_rel_attention,
    )
    # f32 means f32 in every comparison: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mq, nlq, yaml = flagship_config(), nlq_flagship_config(), mq_yaml_config()

    # MQ: the serving kernels, parity, serving, the training kernels, the
    # f32 step's parity, training
    errs, top = phase_kernels(dev)
    phase_parity(dev, "parity", mq.model, mq_parity_inputs(mq.model))
    serve_launches = phase_serve(
        dev, "serve", mq, mq_requests(mq.model, dev),
        (fused_attention_blc, xl_rel_attention, fused_dwconv_qkv))
    terrs, ttop, train_launches = mq_training(dev, mq)
    took("MQ graft: kernels, parity, serve, training")
    # the other CL methods' steps at the graft flagship: iCaRL, BiC with its
    # stage 2, accumulation; serving with BiC's bias and iCaRL's filter
    cl_launches = phase_cl_methods(dev, mq, (
        fused_attention_blc, attention_bwd_cuda, xl_rel_attention,
        xl_bwd_cuda, fused_dwconv_qkv, dwconv_bwd_cuda, adamw_update_multi))
    took("cl_methods")

    # the MQ flagship as configs/mq_vilco.yaml runs it: text tower, branch
    # cross-attention, L2P, time adapters and their ensemble, narration SSL
    yerrs, ytop, yaml_serve, yaml_train = mq_yaml(dev, yaml)
    took("MQ yaml")
    # its CL episode: card against CPU at the tiny twin, then the full-width
    # episode through bin/train_cl.py and bin/evaluate.py
    episode = phase_mq_episode(dev)
    took("mq_episode")

    # NLQ: the same at the dual tower's shapes
    nerrs, ntop = phase_nlq_kernels(dev)
    phase_parity(dev, "nlq_parity", nlq.model,
                 nlq_inputs(np.random.default_rng(SEED + 7), 1, nlq, "cpu",
                            torch.float32))
    phase_train_parity(dev, "nlq_train_parity", nlq,
                       reg=importance_tasks(nlq, dev, nlq.cl_cfg.name,
                                            SEED + 11))
    rng = np.random.default_rng(SEED + 8)
    nlq_serve = phase_serve(
        dev, "nlq_serve", nlq,
        [nlq_inputs(rng, B_NLQ_SERVE, nlq, dev, torch.bfloat16)
         for _ in range(7)],
        (fused_attention_blc, banded_attention_blc, fused_dwconv_qkv))
    nlq_kernels = (banded_attention_blc, banded_bwd_cuda,
                   fused_attention_blc, attention_bwd_cuda,
                   fused_dwconv_qkv, dwconv_bwd_cuda, adamw_update_multi)
    nlq_train = phase_train(dev, "nlq_train", nlq, nlq_kernels, SEED + 9,
                            normalised_must_fall=False)
    # the yaml's own method: EWC at lambda 3000 over 12 stacked tasks
    nlq_ewc = phase_train(dev, "nlq_train_ewc", nlq, nlq_kernels, SEED + 9,
                          normalised_must_fall=False, reg_k=REG_TASKS)
    took("NLQ")
    # its CL episode: the tiny twin card against CPU, then configs/
    # nlq_vilco.yaml's episode through bin/train_cl.py and bin/evaluate.py
    nlq_episode = phase_nlq_episode(dev)
    took("nlq_episode")

    # VQ: the frame-banded and fused-MLP kernels, parity, sliding-window
    # serving (K7 on one extra request), the HNM train step
    verrs, vtop = phase_vq_kernels(dev)
    phase_vq_parity(dev)
    phase_vq_train_parity(dev)
    vq_serve, vq_mlp = phase_vq_serve(
        dev, (fused_attention_blc, frame_band_attention), fused_mlp)
    vq_train = phase_vq_train(dev, vq_train_kernels())
    took("VQ")
    # its CL episode: the tiny twin card against CPU, then configs/
    # vq_vilco.yaml's episode through bin/train_cl.py and bin/vq_infer.py
    vq_episode = phase_vq_episode(dev)
    took("vq_episode")

    ab = attention_ablations(dev, mq)
    took("attention ablations")

    rows = [
        # name, source, replaces, errors, timing, launches (MQ path; the
        # banded kernels: NLQ path)
        ("fused_attention_blc", "vilco_tpu_torch/csrc/attention_blc.cu",
         "vilco_tpu/kernels/attention.py:359", errs["attn"]
         + nerrs["attn"] + verrs["attn"] + verrs["attn_cq"]
         + yerrs["attn_text"] + yerrs["attn_cross"], top["attn"],
         serve_launches["fused_attention_blc"]),
        ("attention_bwd_cuda", "vilco_tpu_torch/csrc/attention_blc_bwd.cu",
         "vilco_tpu/kernels/attention.py:383",
         terrs["attn_bwd"] + nerrs["attn_bwd"] + verrs["attn_bwd"]
         + yerrs["attn_bwd_text"] + yerrs["attn_bwd_cross"],
         ttop["attn_bwd"],
         train_launches["attention_bwd_cuda"]),
        ("xl_rel_attention", "vilco_tpu_torch/csrc/xl_rel_attention.cu",
         "vilco_tpu/kernels/xl_attention.py:260",
         errs["xl"] + terrs["xl_fwd"], top["xl"],
         serve_launches["xl_rel_attention"]),
        ("xl_bwd_cuda", "vilco_tpu_torch/csrc/xl_rel_attention.cu",
         "vilco_tpu/kernels/xl_attention.py:286", terrs["xl_bwd"],
         ttop["xl_bwd"], train_launches["xl_bwd_cuda"]),
        ("fused_dwconv_qkv", "vilco_tpu_torch/csrc/dwconv_qkv.cu",
         "vilco_tpu/kernels/dwconv.py:119", errs["dw"] + nerrs["dw"]
         + yerrs["dw"], top["dw"], serve_launches["fused_dwconv_qkv"]),
        ("dwconv_bwd_cuda", "vilco_tpu_torch/csrc/dwconv_qkv.cu",
         "vilco_tpu/kernels/dwconv.py:136", terrs["dw_bwd"]
         + nerrs["dw_bwd"] + yerrs["dw_bwd"], ttop["dw_bwd"],
         train_launches["dwconv_bwd_cuda"]),
        ("adamw_update_multi", "vilco_tpu_torch/csrc/adamw.cu",
         "vilco_tpu/kernels/adamw.py:97", terrs["adamw"] + nerrs["adamw"]
         + verrs["adamw"] + yerrs["adamw"], ttop["adamw"],
         train_launches["adamw_update_multi"]),
        ("banded_attention_blc", "vilco_tpu_torch/csrc/banded_attention.cu",
         "vilco_tpu/kernels/banded_attention.py:153", nerrs["band_fwd"],
         ntop["band_fwd"], nlq_serve["banded_attention_blc"]),
        ("banded_bwd_cuda", "vilco_tpu_torch/csrc/banded_attention.cu",
         "vilco_tpu/kernels/banded_attention.py:308", nerrs["band_bwd"],
         ntop["band_bwd"], nlq_train["banded_bwd_cuda"]),
        ("frame_band_attention", "vilco_tpu_torch/csrc/attention_blc.cu",
         "vilco_tpu/kernels/frame_band.py:248", verrs["fb_fwd"],
         vtop["fb_fwd"], vq_serve["frame_band_attention"]),
        ("frame_band_bwd_cuda", "vilco_tpu_torch/csrc/attention_blc_bwd.cu",
         "vilco_tpu/kernels/frame_band.py:287", verrs["fb_bwd"],
         vtop["fb_bwd"], vq_train["frame_band_bwd_cuda"]),
        ("fused_mlp", "vilco_tpu_torch/csrc/fused_mlp.cu",
         "vilco_tpu/kernels/mlp.py:79", verrs["mlp"], vtop["mlp"],
         vq_mlp["fused_mlp"]),
        # the ablations (launches: the MQ request or step under the impl)
        ("fused_attention", "vilco_tpu_torch/csrc/attention_blc.cu",
         "vilco_tpu/kernels/attention.py:183", ab["errs"]["naive_fwd"],
         ab["top"]["naive_fwd"],
         ab["serve"]["pallas_naive"]["fused_attention"]),
        ("fused_attention_bwd_cuda",
         "vilco_tpu_torch/csrc/attention_blc_bwd.cu",
         "vilco_tpu/kernels/attention.py:207", ab["errs"]["naive_bwd"],
         ab["top"]["naive_bwd"],
         ab["train"]["pallas_naive"]["fused_attention_bwd_cuda"]),
        ("flash_attention", "vilco_tpu_torch/csrc/attention_blc.cu",
         "vilco_tpu/kernels/attention.py:478",
         ab["errs"]["flash_fwd"] + ab["errs"]["flash_vit"],
         ab["top"]["flash_fwd"],
         ab["serve"]["flash"]["flash_attention"]),
        ("flash_bwd_cuda", "vilco_tpu_torch/csrc/attention_blc_bwd.cu",
         "vilco_tpu/kernels/attention.py:478",
         ab["errs"]["flash_bwd"] + ab["errs"]["flash_vit_bwd"],
         ab["top"]["flash_bwd"], ab["train"]["flash"]["flash_bwd_cuda"]),
        ("probe_variant", "vilco_tpu_torch/csrc/attention_blc.cu",
         "tools/probe_vq_attn.py:106", sum(ab["probe_errs"].values(), []),
         ab["probe_top"]["D_both"], ab["probe_launches"]),
    ]
    also = {"fused_dwconv_qkv": "vilco_tpu/kernels/dwconv.py:267",
            "dwconv_bwd_cuda": "vilco_tpu/kernels/dwconv.py:283",
            "frame_band_bwd_cuda": "vilco_tpu/kernels/frame_band.py:307",
            "banded_bwd_cuda": "vilco_tpu/kernels/banded_attention.py:318"}
    kernels = []
    for fn, src, replaces, err, t, launches in rows:
        entry = {"name": fn, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": max(err), **t}
        if fn in serve_launches:
            entry["launches_train"] = train_launches[fn]
        if fn in yaml_serve:
            entry["launches_mq_yaml_serve"] = yaml_serve[fn]
        if fn in yaml_train:
            entry["launches_mq_yaml_train"] = yaml_train[fn]
        if fn in episode:
            entry["launches_mq_episode"] = episode[fn]
        if fn in nlq_episode:
            entry["launches_nlq_episode"] = nlq_episode[fn]
        if fn in vq_episode:
            entry["launches_vq_episode"] = vq_episode[fn]
        if fn in nlq_serve:
            entry["launches_nlq_serve"] = nlq_serve[fn]
        if fn in nlq_train:
            entry["launches_nlq_train"] = nlq_train[fn]
            entry["launches_nlq_train_ewc"] = nlq_ewc[fn]
        if fn in cl_launches:
            entry["launches_cl_methods"] = cl_launches[fn]
        if fn in vq_serve or fn in vq_mlp:
            entry["launches_vq_serve"] = vq_mlp[fn] if fn == "fused_mlp" \
                else vq_serve[fn]
        if fn in vq_train:
            entry["launches_vq_train"] = vq_train[fn]
        if fn in also:
            entry["also_replaces"] = also[fn]
        if fn == "adamw_update_multi":     # the same kernel over NLQ's,
            entry["nlq"] = ntop["adamw"]   # VQ's and the yaml model's leaves
            entry["vq"] = vtop["adamw"]
            entry["mq_yaml"] = ytop["adamw"]
        if fn in ("fused_attention_blc", "attention_bwd_cuda"):
            part = "attn" if fn == "fused_attention_blc" else "attn_bwd"
            entry["mq_yaml_text"] = ytop[f"{part}_text"]   # Tk = 208
            entry["mq_yaml_cross"] = ytop[f"{part}_cross"]
        if fn in ("fused_dwconv_qkv", "dwconv_bwd_cuda"):
            entry["mq_yaml_text"] = ytop["dw" if fn == "fused_dwconv_qkv"
                                         else "dw_bwd"]
        if fn == "fused_attention_blc":    # at the ViT's and cq_corr's shapes
            entry["vq_vit"] = vtop["attn"]
            entry["vq_cq_corr"] = vtop["attn_cq"]
            entry["nlq_cross"] = ntop["attn"]
        if fn == "attention_bwd_cuda":     # the VQ decoder; NLQ's video-
            entry["vq_cq_corr"] = vtop["attn_bwd"]   # to-text cross-attention
            entry["nlq_cross"] = ntop["attn_bwd"]
        if fn == "fused_attention":
            entry["launches_train"] = ab["train"]["pallas_naive"][fn]
        if fn == "flash_attention":        # the MQ step; the flash ViT
            entry["launches_train"] = ab["train"]["flash"][fn]
            entry["launches_vq_serve"] = ab["vq_flash"][fn]
            entry["vq_vit"] = ab["top"]["flash_vit"]
        if fn == "flash_bwd_cuda":         # at the ViT's query call
            entry["vq_vit"] = ab["top"]["flash_vit_bwd"]
        if fn == "probe_variant":          # variant D; A to C beside it
            entry["variants"] = ab["probe_top"]
        kernels.append(entry)
    print(f"[summary] {CARD}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] in (["--vq-train-parity"], ["--mq-train"],
                         ["--vq-train"], ["--mq-yaml"], ["--cl-methods"],
                         ["--mq-episode"], ["--nlq-episode"],
                         ["--vq-episode"]):
        phase_device()
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        if sys.argv[1] == "--mq-train":
            from vilco_tpu_torch.core.config import flagship_config

            mq_training(dev, flagship_config())
        if sys.argv[1] == "--mq-yaml":
            from vilco_tpu_torch.core.config import mq_yaml_config

            mq_yaml(dev, mq_yaml_config())
        if sys.argv[1] == "--cl-methods":
            phase_cl_parity(dev)
        if sys.argv[1] == "--mq-episode":
            phase_mq_episode(dev)
        if sys.argv[1] == "--nlq-episode":
            phase_nlq_episode(dev)
        if sys.argv[1] == "--vq-episode":
            phase_vq_episode(dev)
        if sys.argv[1] == "--vq-train":
            phase_vq_kernels(dev)
            phase_vq_train_parity(dev)
            phase_vq_train(dev, vq_train_kernels())
        for s in sys.argv[2:]:
            phase_vq_train_parity(dev, int(s))
    else:
        main()
    sys.exit(0)
