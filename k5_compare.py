"""K5, the NLQ banded attention, in several checkouts of the repo on one
card, in turn: a change against its parent in one call.

    python3 k5_compare.py TREE [TREE ...]

Each TREE is a checkout of the repo (the parent: `git archive` unpacked into
a directory that .gitignore lists, such as runs/), run in a process of its
own that imports that tree's vilco_tpu_torch, its kernels built into the
tree's own _build/, and this checkout's chip_smoke.py for the timing, the
masks, the bounds and the NLQ serve and train phases. Give the trees in
turn (parent, change, change, parent).

Per tree, on random inputs with chip_smoke.py's ragged masks, each time the
median of queued reps behind a device sleep (`chip_smoke.queued_ms`), the
median by CUDA events beside it: K5's forward (`banded_fwd_cuda`, no lse)
at the serving batch 16 and its forward and backward at the training batch
4, the backward through autograd of `banded_attention_blc` (every launch of
the tree's backward), in bf16 at each length an NLQ request or step calls
K5 with and in f32 at the top length, beside SDPA with the band mask
(forward, and backward through autograd) and the bound; K5's bf16 ms summed
over an NLQ request's and step's 10 calls (`chip_smoke.say_k5_sums`); then
chip_smoke.py's NLQ serving and train phases (their traces give device ms
and the idle share).
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one_tree(tree: str) -> None:
    sys.path[0] = tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

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

    cs.phase_device()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    full = nlq_flagship_config()
    cfg = full.model
    T0, C, H, w = cfg.max_seq_len, cfg.embd_dim, cfg.n_head, cfg.window
    D, B_TR = C // H, full.batch_size
    name = os.path.basename(tree)
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
                    cs.say(f"[k5_compare] {name}: K5 {p} "
                           f"{str(dtype)[6:]} B={B} T={T} C={C} H={H} "
                           f"w={w}: {ms:.4f} ms queued "
                           f"({cs.median_ms(kern):.4f} by events), bound "
                           f"{bms:.4f} ({by}); SDPA "
                           f"{cs.queued_ms(lib):.4f} ms queued")
                del q, k, v, g, m, bm, runs
            torch.cuda.empty_cache()
    cs.say_k5_sums(f"k5_compare {name}", band_ms, cfg, B_TR)

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


def main(trees) -> None:
    for tree in trees:
        tree = os.path.abspath(tree)
        print(f"[k5_compare] ---- {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one-tree", tree], cwd=tree).returncode
        if rc != 0:
            print(f"[k5_compare] {tree}: exit {rc}", flush=True)
            sys.exit(rc)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-tree"]:
        one_tree(sys.argv[2])
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
