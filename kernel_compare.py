"""A kernel of the port in several checkouts of the repo on one card, in
turn: a change against its parent in one call.

    python3 kernel_compare.py k3 TREE [TREE ...]
    python3 kernel_compare.py k5 TREE [TREE ...]
    python3 kernel_compare.py k6 TREE [TREE ...]
    python3 kernel_compare.py sass PARENT CHANGE

Each TREE is a checkout of the repo (the parent: `git archive` unpacked into
a directory that .gitignore lists, such as runs/), run in a process of its
own that imports that tree's vilco_tpu_torch, its kernels built into the
tree's own _build/, and this checkout's chip_smoke.py for the timing, the
masks, the bounds and the serve and train phases. Give the trees in turn
(parent, change, change, parent). Each time below is the median of queued
reps behind a device sleep (`chip_smoke.queued_ms`), the median by CUDA
events beside it.

k3, the depthwise q/k/v convs: K3's forward (`fused_dwconv_qkv`) at the
serving batch (MQ and NLQ 16) and its forward and backward
(`dwconv_bwd_cuda`, every launch of the tree's backward) at the training
batch (MQ 2, NLQ 4), in bf16 at every (T, stride) a request or step calls
K3 with (`chip_smoke.k3_calls`) and in f32 at the top length, beside
conv1d (forward, and backward through autograd) and the bound; K3's bf16 ms
summed over an MQ and an NLQ request and step (`chip_smoke.say_k3_sums`);
then chip_smoke.py's MQ and NLQ serving and train phases (device ms and
the idle share from their traces).

k5, the NLQ banded attention: on random inputs with chip_smoke.py's ragged
masks, K5's forward (`banded_fwd_cuda`, no lse) at the serving batch 16
and its forward and backward at the training batch 4, the backward through
autograd of `banded_attention_blc` (every launch of the tree's backward),
in bf16 at each length an NLQ request or step calls K5 with and in f32 at
the top length, beside SDPA with the band mask (forward, and backward
through autograd) and the bound; K5's bf16 ms summed over an NLQ request's
and step's 10 calls (`chip_smoke.say_k5_sums`); then chip_smoke.py's NLQ
serving and train phases (their traces give device ms and the idle share).

k6, the VQ frame-banded attention: K6's forward (`frame_band_fwd_cuda`, no
lse) at the VQ flagship's shape (30 frames of 64 tokens, 8 heads of 32,
w 2) in bf16 at the serving chunk (batch 8) and the HNM pairs (16), in f32
at 8, beside SDPA with the band mask and the bound; its bf16 ms summed
over a VQ request's and an HNM step's 3 calls (`chip_smoke.say_k6_sums`);
then chip_smoke.py's VQ serving and train phases (device ms and the idle
share from their traces).

sass: the SASS of every kernel of attention_blc.cu and attention_blc_bwd.cu
that both trees compile (each built first where its _build/ lacks it),
matched by name and template arguments (a bool flash switch read as the
mode K1 or Flash), compared instruction by instruction, addresses and
encodings left out: equal, or the count of lines that differ and the
first of them.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def k5(cs, name: str, dev) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import vilco_tpu_torch.kernels.banded_attention as band
    from vilco_tpu_torch.core.config import nlq_flagship_config
    from vilco_tpu_torch.kernels.adamw import adamw_update_multi
    from vilco_tpu_torch.kernels.attention import (
        attention_bwd_cuda,
        fused_attention_blc,
    )
    from vilco_tpu_torch.kernels.dwconv import (
        dwconv_bwd_cuda,
        fused_dwconv_qkv,
    )

    full = nlq_flagship_config()
    cfg = full.model
    T0, C, H, w = cfg.max_seq_len, cfg.embd_dim, cfg.n_head, cfg.window
    D, B_TR = C // H, full.batch_size
    rng = np.random.default_rng(cs.SEED + 6)
    lengths = [T for T, _ in cs.k5_calls(cfg)]
    band_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, parts in ((cs.B_NLQ_SERVE, ("fwd",)), (B_TR, ("fwd", "bwd"))):
            for T in lengths if dtype == torch.bfloat16 else [T0]:
                q, k, v, g = (torch.from_numpy(rng.standard_normal(
                    (B, T, C)).astype(np.float32)).to(dev, dtype)
                    for _ in range(4))
                m = cs.ragged_mask(rng, B, T, dev)
                bm = cs.band_mask(m, w)
                bh = lambda x: x.reshape(B, T, H, D).transpose(1, 2)
                sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                    bh(a), bh(b), bh(c), attn_mask=bm)
                runs = {
                    "fwd": (lambda: band.banded_fwd_cuda(q, k, v, m, H, w,
                                                         False),
                            lambda: sdpa(q, k, v)),
                    "bwd": (cs.backward_timer(
                        lambda *a: band.banded_attention_blc(*a, m, H, w),
                        (q, k, v), g),
                        cs.backward_timer(sdpa, (q, k, v), bh(g)))}
                for p in parts:
                    kern, lib = runs[p]
                    ms = cs.queued_ms(kern)
                    bms, by = cs.bound(*cs.banded_work(m, C, H, w, dtype, p),
                                       dtype)
                    if dtype == torch.bfloat16:
                        band_ms[p, B, T] = ms, bms
                    cs.say(f"[kernel_compare] {name}: K5 {p} "
                           f"{str(dtype)[6:]} B={B} T={T} C={C} H={H} "
                           f"w={w}: {ms:.4f} ms queued "
                           f"({cs.median_ms(kern):.4f} by events), bound "
                           f"{bms:.4f} ({by}); SDPA "
                           f"{cs.queued_ms(lib):.4f} ms queued")
                del q, k, v, g, m, bm, runs
            torch.cuda.empty_cache()
    cs.say_k5_sums(f"kernel_compare {name}", band_ms, cfg, B_TR)

    srng = np.random.default_rng(cs.SEED + 8)
    cs.phase_serve(
        dev, "nlq_serve", full,
        [cs.nlq_inputs(srng, cs.B_NLQ_SERVE, full, dev, torch.bfloat16)
         for _ in range(7)],
        (fused_attention_blc, band.banded_attention_blc, fused_dwconv_qkv))
    cs.phase_train(
        dev, "nlq_train", full, (band.banded_attention_blc,
                                 fused_attention_blc, attention_bwd_cuda,
                                 fused_dwconv_qkv, dwconv_bwd_cuda,
                                 adamw_update_multi),
        cs.SEED + 9, normalised_must_fall=False)


def k6(cs, name: str, dev) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vilco_tpu_torch.core.config import vq_flagship_config
    from vilco_tpu_torch.kernels.attention import fused_attention_blc
    from vilco_tpu_torch.kernels.frame_band import (
        frame_band_attention,
        frame_band_fwd_cuda,
    )

    cfg = vq_flagship_config()
    R, C, H = cfg.resolution_transformer, cfg.dim, 8
    fr, w, nf = R * R, cfg.window_transformer // 2, cfg.num_frames
    L, D = nf * fr, C // H
    rng = np.random.default_rng(cs.SEED + 10)
    bm = cs.frame_band_mask(L, fr, w, dev)
    fwd_ms = {}
    for dtype, batches in ((torch.bfloat16, cs.VQ_K6_BATCHES),
                           (torch.float32, (min(cs.VQ_K6_BATCHES),))):
        for B in batches:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, L, C)).astype(np.float32)).to(dev, dtype)
                for _ in range(3))
            bh = lambda x: x.reshape(B, L, H, D).transpose(1, 2)
            kern = lambda: frame_band_fwd_cuda(q, k, v, H, fr, w, False)
            lib = lambda: F.scaled_dot_product_attention(
                bh(q), bh(k), bh(v), attn_mask=bm)
            ms = cs.queued_ms(kern)
            bms, by = cs.bound(*cs.frame_band_work(B, L, C, H, fr, w, dtype,
                                                   "fwd"), dtype)
            if dtype == torch.bfloat16:
                fwd_ms[B] = ms, bms
            cs.say(f"[kernel_compare] {name}: K6 fwd {str(dtype)[6:]} B={B} "
                   f"frames={nf} fr={fr} w={w} H={H} D={D}: {ms:.4f} ms "
                   f"queued ({cs.median_ms(kern):.4f} by events), bound "
                   f"{bms:.4f} ({by}); SDPA {cs.queued_ms(lib):.4f} ms "
                   f"queued [{cs.CARD}]")
            del q, k, v
        torch.cuda.empty_cache()
    cs.say_k6_sums(f"kernel_compare {name}", fwd_ms, cfg.num_transformer)

    cs.phase_vq_serve(dev, (fused_attention_blc, frame_band_attention), None)
    cs.phase_vq_train(dev, cs.vq_train_kernels())


def k3(cs, name: str, dev) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vilco_tpu_torch.core.config import (
        flagship_config,
        nlq_flagship_config,
    )
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
    from vilco_tpu_torch.kernels.xl_attention import (
        xl_bwd_cuda,
        xl_rel_attention,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(cs.SEED + 12)
    mq, nlq = flagship_config(), nlq_flagship_config()
    for full, b_serve in ((mq, cs.B_SERVE), (nlq, cs.B_NLQ_SERVE)):
        C, b_train, T0 = (full.model.embd_dim, full.batch_size,
                          full.model.max_seq_len)
        dw_ms = {}
        for dtype in (bf16, f32):
            rn = lambda *shape: torch.from_numpy(rng.standard_normal(
                shape).astype(np.float32)).to(dev, dtype)
            w = rn(3, 3, C) * 0.3
            # conv1d's weight: output channel 3c + j is conv j of channel c
            wg = w.float().permute(2, 0, 1).reshape(3 * C, 1, 3).to(dtype)
            for T, s, _ in cs.k3_calls(full):
                if dtype == f32 and T != T0:
                    continue
                To = (T - 1) // s + 1
                cases = ([(b_serve, "fwd"), (b_train, "fwd"),
                          (b_train, "bwd")] if dtype == bf16
                         else [(b_serve, "fwd"), (b_train, "bwd")])
                for B, p in cases:
                    x = rn(B, T, C)
                    if p == "fwd":
                        xt = x.transpose(1, 2)
                        kern = lambda: fused_dwconv_qkv(x, w, s)
                        lib = lambda: F.conv1d(xt, wg, stride=s, padding=1,
                                               groups=C)
                    else:
                        gs = tuple(rn(B, To, C) for _ in range(3))
                        gcat = torch.stack(gs, -1).reshape(
                            B, To, 3 * C).transpose(1, 2)
                        kern = lambda: dwconv_bwd_cuda(x, w, *gs, s)
                        lib = cs.backward_timer(lambda a, b: F.conv1d(
                            a.transpose(1, 2), b, stride=s, padding=1,
                            groups=C), (x, wg), gcat)
                    ms = cs.queued_ms(kern)
                    bms, by = cs.bound(*cs.dwconv_work(
                        B, T, C, s, dtype, backward=p == "bwd"), dtype)
                    if dtype == bf16:
                        dw_ms[p, B, T, s] = ms, bms
                    cs.say(f"[kernel_compare] {name}: K3 {p} "
                           f"{str(dtype)[6:]} {full.model.variant.upper()} "
                           f"B={B} T={T} C={C} stride={s}: {ms:.4f} ms "
                           f"queued ({cs.median_ms(kern):.4f} by events), "
                           f"bound {bms:.4f} ({by}); conv1d "
                           f"{cs.queued_ms(lib):.4f} ms queued")
                    del x, kern, lib
            torch.cuda.empty_cache()
        cs.say_k3_sums(f"kernel_compare {name}", dw_ms, full, b_serve)

    cs.phase_serve(dev, "serve", mq, cs.mq_requests(mq.model, dev),
                   (fused_attention_blc, xl_rel_attention, fused_dwconv_qkv))
    cs.phase_train(dev, "train", mq, (fused_attention_blc, attention_bwd_cuda,
                                      xl_rel_attention, xl_bwd_cuda,
                                      fused_dwconv_qkv, dwconv_bwd_cuda,
                                      adamw_update_multi),
                   cs.SEED + 5, normalised_must_fall=True)
    srng = np.random.default_rng(cs.SEED + 8)
    cs.phase_serve(
        dev, "nlq_serve", nlq,
        [cs.nlq_inputs(srng, cs.B_NLQ_SERVE, nlq, dev, bf16)
         for _ in range(7)],
        (fused_attention_blc, banded_attention_blc, fused_dwconv_qkv))
    cs.phase_train(
        dev, "nlq_train", nlq, (banded_attention_blc, banded_bwd_cuda,
                                fused_attention_blc, attention_bwd_cuda,
                                fused_dwconv_qkv, dwconv_bwd_cuda,
                                adamw_update_multi),
        cs.SEED + 9, normalised_must_fall=False)


def one_tree(kernel: str, tree: str) -> None:
    sys.path[0] = tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    import torch

    cs.phase_device()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"k3": k3, "k5": k5, "k6": k6}[kernel](cs, os.path.basename(tree),
                                           torch.device("cuda", 0))


def _tool(name: str) -> str:
    found = shutil.which(name)
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    return found or cand


def _built(tree: str, src: str) -> str:
    """The path of `tree`'s library for csrc/<src>.cu, built by that tree's
    own _build if missing."""
    code = ("from vilco_tpu_torch.kernels import _build as b\n"
            f"s = b.CSRC / '{src}.cu'\n"
            "if not b._target(s).exists():\n"
            "    b._finish(s, b._start(s))\n"
            "print(b._target(s))")
    return subprocess.run([sys.executable, "-c", code], cwd=tree,
                          check=True, capture_output=True,
                          text=True).stdout.strip()


def _kernels(lib: str) -> dict:
    """{(kernel, template arguments): [instructions]} of a library's SASS;
    a bool flash switch reads as the mode K1 (false) or Flash (true)."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            mangled = line.split("Function : ")[1].strip()
            name = subprocess.run([_tool("cu++filt"), mangled], check=True,
                                  capture_output=True,
                                  text=True).stdout.strip()
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "",
                          name)
            base, _, rest = name.partition("<")
            args = re.sub(r"\(Mode\)([01])\b", r"(bool)\1",
                          rest.split(">(")[0])
            key = (base, args)
            out[key] = []
        elif key is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                out[key].append(m.group(1))
    return out


def sass(parent: str, change: str) -> None:
    for src in ("attention_blc", "attention_blc_bwd"):
        a, b = (_kernels(_built(t, src)) for t in (parent, change))
        for key in sorted(set(a) & set(b)):
            pairs = list(zip(a[key], b[key]))
            diff = [i for i, (x, y) in enumerate(pairs) if x != y]
            if not diff and len(a[key]) == len(b[key]):
                verdict = f"equal, {len(a[key])} instructions"
            elif not diff:
                verdict = (f"{len(a[key])} against {len(b[key])} "
                           "instructions, equal as far as the shorter")
            else:
                verdict = (f"{len(a[key])} against {len(b[key])} "
                           f"instructions, {len(diff)} differ, the first "
                           f"at {diff[0]}: {pairs[diff[0]][0]!r} against "
                           f"{pairs[diff[0]][1]!r}")
            print(f"[kernel_compare] sass {src} {key[0]}<{key[1]}>: "
                  f"{verdict}", flush=True)
        for key in sorted(set(b) - set(a)):
            print(f"[kernel_compare] sass {src} {key[0]}<{key[1]}>: new, "
                  f"{len(b[key])} instructions", flush=True)
        for key in sorted(set(a) - set(b)):
            print(f"[kernel_compare] sass {src} {key[0]}<{key[1]}>: gone",
                  flush=True)


def main(kernel: str, trees) -> None:
    for tree in trees:
        tree = os.path.abspath(tree)
        print(f"[kernel_compare] ---- {kernel} {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one-tree", kernel, tree],
                            cwd=tree).returncode
        if rc != 0:
            print(f"[kernel_compare] {tree}: exit {rc}", flush=True)
            sys.exit(rc)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-tree"]:
        one_tree(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["sass"] and len(sys.argv) == 4:
        sass(*map(os.path.abspath, sys.argv[2:]))
    elif sys.argv[1:2] in (["k3"], ["k5"], ["k6"]) and len(sys.argv) > 2:
        main(sys.argv[1], sys.argv[2:])
    else:
        sys.exit(__doc__)
