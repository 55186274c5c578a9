"""The VQ task's data and metrics in the port against the JAX package on the
CPU: the copies (data/vq_frames.py, evals/vq_metrics.py), the augmentation
(data/vq_augment.py), the ViT checkpoint import, and the synthetic split's
windows at the flagship window, which wrap around the clip as JAX's do.

Limits: the copies exact; each augmentation apply under JAX's draws
(recomputed here with jax.random from JAX's keys) within 1e-6 of JAX's
output at f32, and the whole normalized batch within 1e-6 / 0.225 (the
normalization divides the frames' roundoff by the smallest ImageNet std);
the imported ViT leaves exact.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_vq_frames import FRAME_SIZE, _write_dataset
from vilco_tpu.data import vq_augment as j_aug
from vilco_tpu.data import vq_frames as j_frames
from vilco_tpu.evals import vq_metrics as j_metrics
from vilco_tpu.models.vit import ViT as JViT
from vilco_tpu.models.vit import load_torch_vit_checkpoint as j_load_vit
from vilco_tpu.tasks import vq as j_vq
from vilco_tpu_torch.core.config import vq_flagship_config
from vilco_tpu_torch.data import vq_augment as t_aug
from vilco_tpu_torch.data import vq_frames as t_frames
from vilco_tpu_torch.evals import vq_metrics as t_metrics
from vilco_tpu_torch.models.convert import params_from_jax
from vilco_tpu_torch.models.vit import ViT
from vilco_tpu_torch.models.vit import load_torch_vit_checkpoint
from vilco_tpu_torch.tasks import vq as t_vq

AUG_ATOL = 1e-6
# the normalized frames: the stages' roundoff over the smallest std
NORM_ATOL = AUG_ATOL / min(t_aug.IMAGENET_STD)


# ----------------------------------------------------------- vq_frames


def test_vq_frames_copy_equals_jax(tmp_path):
    """The annotation adapter, the box geometry, the balanced sampler, the
    category grouping and the frame-folder source on an Ego4D-layout
    dataset written here: every sample, index and pixel equal."""
    anno_path = _write_dataset(tmp_path)[0]
    for clean in (False, True):
        ref = j_frames.load_vq_annotations(str(anno_path), "val", clean)
        got = t_frames.load_vq_annotations(str(anno_path), "val", clean)
        assert got == ref and len(got) == 1
    sample = got[0]
    box = {"x": 3.0, "y": 7.0, "width": 10.0, "height": 5.0,
           "original_width": 64, "original_height": 48}
    assert t_frames.normalize_track_box(box) == (
        j_frames.normalize_track_box(box))
    b = t_frames.normalize_track_box(box)
    assert t_frames.denormalize_track_box(b, 48, 64) == (
        j_frames.denormalize_track_box(b, 48, 64))
    assert t_frames.clean_box_flags(sample["track"], (48, 64)) == (
        j_frames.clean_box_flags(sample["track"], (48, 64)))
    for w in (4, 8, 20):
        for seed in range(3):
            np.testing.assert_array_equal(
                t_frames.balanced_frame_indices(
                    w, sample, np.random.default_rng(seed)),
                j_frames.balanced_frame_indices(
                    w, sample, np.random.default_rng(seed)))
    cats = [dict(sample, id=f"s{i}", category=f"c{i % 5}")
            for i in range(12)]
    assert t_frames.group_by_category(cats, 2, seed=3) == (
        j_frames.group_by_category(cats, 2, seed=3))
    assert t_frames.group_splits(cats[:7], cats[7:], 2) == (
        j_frames.group_splits(cats[:7], cats[7:], 2))
    img = np.random.default_rng(0).random((30, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_frames.square_pad_resize(img, 16),
                                  j_frames.square_pad_resize(img, 16))
    js = j_frames.FrameDirSource(str(tmp_path / "images"),
                                 frame_size=FRAME_SIZE)
    ts = t_frames.FrameDirSource(str(tmp_path / "images"),
                                 frame_size=FRAME_SIZE)
    np.testing.assert_array_equal(ts.frames(sample, [0, 3, 5]),
                                  js.frames(sample, [0, 3, 5]))
    np.testing.assert_array_equal(ts.query(sample), js.query(sample))


def test_frame_sources_name_the_missing_package(monkeypatch, tmp_path):
    """Without cv2 (the card's machine has neither cv2 nor PIL) a real
    frame source raises, naming the package."""
    monkeypatch.setattr(t_frames, "cv2", None)
    for cls in (t_frames.FrameDirSource, t_frames.VideoFrameSource):
        with pytest.raises(ImportError, match="cv2"):
            cls(str(tmp_path))


# ----------------------------------------------------------- vq_metrics


def _track(rng, start, n, shift=0.0, score=None):
    x, y = rng.uniform(10, 60, 2)
    return (j_metrics.ResponseTrack(
        [j_metrics.BBox(start + i, x + shift + i, y, x + shift + i + 20,
                        y + 15) for i in range(n)], score),
        (x, y))


def _metric_inputs(rng, n=8):
    """GT tracks and predictions: perfect, shifted in space and time, and
    empty ones (no predicted track)."""
    gt, preds, crops = [], [], []
    for q in range(n):
        start, length = int(rng.integers(0, 20)), int(rng.integers(3, 12))
        g, (x, y) = _track(np.random.default_rng(q), start, length)
        gt.append(g)
        crops.append(j_metrics.BBox(0, 0, 0, float(rng.uniform(5, 200)),
                                    float(rng.uniform(5, 200))))
        kind = q % 4
        if kind == 0:            # perfect
            preds.append([j_metrics.ResponseTrack(list(g.bboxes), 1.0)])
        elif kind == 1:          # shifted in space
            preds.append([_track(np.random.default_rng(q), start, length,
                                 shift=6.0, score=0.8)[0]])
        elif kind == 2:          # shifted in time, two candidates
            preds.append([_track(np.random.default_rng(q), start + 3,
                                 length, score=0.6)[0],
                          _track(rng, 0, 4, score=0.3)[0]])
        else:                    # empty
            preds.append([])
    return gt, preds, crops


def _port(obj):
    """JAX's metric structures as the port's (equal dataclasses)."""
    if isinstance(obj, list):
        return [_port(x) for x in obj]
    return t_metrics.ResponseTrack(
        [t_metrics.BBox(**vars(b)) for b in obj.bboxes], obj.score)


def test_vq_metrics_copy_equals_jax():
    """Every metric of the aggregator (tAP, stAP over their IoU
    thresholds, Success, recovery, search efficiency) and the paired
    aggregation, and the IoU helpers, on perfect, shifted and empty
    predictions: exact."""
    gt, preds, crops = _metric_inputs(np.random.default_rng(0))
    n_frames = [40] * len(gt)
    accessed = [30] * len(gt)
    ref = j_metrics.compute_visual_query_metrics(preds, gt, accessed,
                                                 n_frames)
    got = t_metrics.compute_visual_query_metrics(_port(preds), _port(gt),
                                                 accessed, n_frames)
    assert got == ref
    assert ref["tAP@0.25"] > 0 and ref["Success"] > 0
    # the reference's pairing, and pairings by the crop's size
    pairings = {**j_metrics.VC_RT_PAIRINGS, "any": ("all", "all"),
                "small": ("small", "all"), "medium": ("medium", "all")}
    ref = j_metrics.compute_visual_query_metrics_paired(
        preds, gt, crops, accessed, n_frames, vc_rt_pairings=pairings)
    got = t_metrics.compute_visual_query_metrics_paired(
        _port(preds), _port(gt), [t_metrics.BBox(**vars(b)) for b in crops],
        accessed, n_frames, vc_rt_pairings=pairings)
    assert got == ref and len(ref) == 3
    a, b = gt[0], preds[1][0]
    assert t_metrics.spatio_temporal_iou(_port(a), _port(b)) == (
        j_metrics.spatio_temporal_iou(a, b))
    assert t_metrics.per_frame_iou_matches(_port(b), _port(a)) == (
        j_metrics.per_frame_iou_matches(b, a))
    assert t_metrics.spatial_iou(_port(a).bboxes[0], _port(b).bboxes[0]) == (
        j_metrics.spatial_iou(a.bboxes[0], b.bboxes[0]))
    cands = np.array([[0, 5], [3, 9], [12, 14]])
    np.testing.assert_array_equal(
        t_metrics.segment_iou_inclusive(np.array([2, 8]), cands),
        j_metrics.segment_iou_inclusive(np.array([2, 8]), cands))


# ----------------------------------------------------------- augmentation


def _jax_draws(key, B):
    """augment_vq_batch's draws as JAX makes them from `key`: the same
    splits and jax.random calls, in the port's draw layout."""
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def jitter(k, n, strength):
        ks = jax.random.split(k, 3)
        return np.stack([np.asarray(jax.random.uniform(
            kk, (n,), minval=1 - s, maxval=1 + s))
            for kk, s in zip(ks, strength)], 1)

    crops = jax.vmap(lambda k: jnp.stack(j_aug._sample_crop(
        k, t_aug.CROP_SCALE, t_aug.CROP_RATIO)))(jax.random.split(k4, B))
    return {"clip_jitter": torch.from_numpy(jitter(k1, B, t_aug.CLIP_JITTER)),
            "query_jitter": torch.from_numpy(
                jitter(k2, B, t_aug.QUERY_JITTER)),
            "flip": torch.from_numpy(np.asarray(
                jax.random.bernoulli(k3, 0.5, (B,)))),
            "crop": torch.from_numpy(np.asarray(crops))}


def _vq_batch(seed, B=3, T=4, S=24):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.6, (B, T, 2)).astype(np.float32)
    bbox = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (B, T, 2))], -1)
    return {"clip": rng.random((B, T, S, S, 3), np.float32),
            "query": rng.random((B, S, S, 3), np.float32),
            "clip_bbox": np.clip(bbox, 0, 1).astype(np.float32),
            "clip_with_bbox": (rng.random((B, T)) < 0.8).astype(np.float32),
            "before_query": np.ones((B, T), np.float32)}


def _close(got, want, atol=AUG_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentation_applies_equal_jax_under_jax_draws(seed):
    """Each apply (jitter, flip, crop-resize with the box remap and
    invalidation, normalization), fed JAX's draws, within 1e-6 of JAX's
    own; the whole batch's normalized frames within NORM_ATOL."""
    key = jax.random.PRNGKey(seed)
    nb = _vq_batch(seed)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    draws = _jax_draws(key, 3)
    ref = j_aug.augment_vq_batch(key, jb)
    got = t_aug.augment_vq_batch(tb, draws)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k],
               NORM_ATOL if k in ("clip", "query") else AUG_ATOL)
    assert torch.equal(got["before_query"], tb["before_query"])
    # each stage alone
    k1, _, k3, k4 = jax.random.split(key, 4)
    _close(t_aug.color_jitter(tb["clip"], draws["clip_jitter"]),
           j_aug.color_jitter(k1, jb["clip"], *t_aug.CLIP_JITTER))
    for got, ref in zip(t_aug.hflip_clip(tb["clip"], tb["clip_bbox"],
                                         draws["flip"]),
                        j_aug.hflip_clip(k3, jb["clip"], jb["clip_bbox"])):
        _close(got, ref)
    for got, ref in zip(
            t_aug.random_resized_crop_clip(tb["clip"], tb["clip_bbox"],
                                           tb["clip_with_bbox"],
                                           draws["crop"]),
            j_aug.random_resized_crop_clip(k4, jb["clip"], jb["clip_bbox"],
                                           jb["clip_with_bbox"])):
        _close(got, ref)
    _close(t_aug.normalize_images(tb["query"]),
           j_aug.normalize_images(jb["query"]))


def test_augmentation_draws_repeat_and_stay_in_range():
    """The same seed gives the same draws; factors, bits and windows stay
    in their ranges; a crop is the first fitting candidate or, with none,
    the full frame; no jitter or crop draws nothing for them."""
    a = t_aug.draw_vq_augment(torch.Generator().manual_seed(7), 64)
    b = t_aug.draw_vq_augment(torch.Generator().manual_seed(7), 64)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k, strength in (("clip_jitter", t_aug.CLIP_JITTER),
                        ("query_jitter", t_aug.QUERY_JITTER)):
        s = torch.tensor(strength)
        assert ((a[k] >= 1 - s) & (a[k] < 1 + s)).all()
    assert a["flip"].dtype == torch.bool and 0 < int(a["flip"].sum()) < 64
    x0, y0, w, h = a["crop"].unbind(1)
    assert ((w > 0) & (w <= 1) & (h > 0) & (h <= 1)).all()
    assert ((x0 >= 0) & (x0 + w <= 1 + 1e-6)).all()
    assert ((y0 >= 0) & (y0 + h <= 1 + 1e-6)).all()
    area = w * h
    assert ((area >= t_aug.CROP_SCALE[0] - 1e-5)
            & (area <= t_aug.CROP_SCALE[1] + 1e-5)).all()
    # the rule: recompute each candidate set from the same stream
    gen = torch.Generator().manual_seed(11)
    ref = torch.Generator().manual_seed(11)
    for _ in range(20):
        x0, y0, w, h = t_aug._sample_crop(gen)
        lo, hi = t_aug.CROP_SCALE
        area = lo + (hi - lo) * torch.rand((8,), generator=ref)
        lr = (math.log(t_aug.CROP_RATIO[0]) + (math.log(t_aug.CROP_RATIO[1])
              - math.log(t_aug.CROP_RATIO[0])) * torch.rand(
            (8,), generator=ref))
        cw = torch.sqrt(area * torch.exp(lr))
        ch = torch.sqrt(area / torch.exp(lr))
        ok = ((cw <= 1) & (ch <= 1)).nonzero()
        want = (cw[ok[0, 0]], ch[ok[0, 0]]) if len(ok) else (1.0, 1.0)
        assert (float(w), float(h)) == (float(want[0]), float(want[1]))
        torch.rand((2,), generator=ref)
    # the fallback: scale above 1 leaves no candidate that fits
    x0, y0, w, h = t_aug._sample_crop(torch.Generator().manual_seed(0),
                                      scale=(1.5, 2.0))
    assert (float(w), float(h), float(x0), float(y0)) == (1.0, 1.0, 0.0,
                                                          0.0)
    off = t_aug.draw_vq_augment(torch.Generator(), 4, jitter=False,
                                crop=False)
    assert off["clip_jitter"] is None and off["crop"] is None


# ----------------------------------------------------------- the ViT import


def test_torch_vit_checkpoint_loads_as_in_jax(tmp_path):
    """A random DINOv2-named state_dict (LayerScale and mask token beside
    the ViT's leaves), under "model": both packages import it, and JAX's
    tree through models/convert.py equals the port's ViT leaf by leaf; a
    missing key raises."""
    dim, depth, heads, patch, size = 48, 2, 4, 8, 32
    rng = np.random.default_rng(0)
    grid = (size // patch) ** 2 + 1
    shapes = {"patch_embed.proj.weight": (dim, 3, patch, patch),
              "patch_embed.proj.bias": (dim,), "cls_token": (1, 1, dim),
              "pos_embed": (1, grid, dim), "mask_token": (1, dim),
              "norm.weight": (dim,), "norm.bias": (dim,)}
    for i in range(depth):
        p = f"blocks.{i}."
        shapes.update({p + "norm1.weight": (dim,), p + "norm1.bias": (dim,),
                       p + "attn.qkv.weight": (3 * dim, dim),
                       p + "attn.qkv.bias": (3 * dim,),
                       p + "attn.proj.weight": (dim, dim),
                       p + "attn.proj.bias": (dim,),
                       p + "ls1.gamma": (dim,), p + "ls2.gamma": (dim,),
                       p + "norm2.weight": (dim,), p + "norm2.bias": (dim,),
                       p + "mlp.fc1.weight": (4 * dim, dim),
                       p + "mlp.fc1.bias": (4 * dim,),
                       p + "mlp.fc2.weight": (dim, 4 * dim),
                       p + "mlp.fc2.bias": (dim,)})
    sd = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    path = str(tmp_path / "dinov2.pth")
    torch.save({"model": sd}, path)
    jvit = JViT(patch, dim, depth, heads)
    jparams = jvit.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, size, size, 3)))["params"]
    want = params_from_jax(jax.tree.map(np.asarray,
                                        j_load_vit(jparams, path)))
    vit = ViT(patch, dim, depth, heads, size)
    load_torch_vit_checkpoint(vit, path)
    got = dict(vit.named_parameters())
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].detach(), want[k]), k
    del sd["blocks.1.mlp.fc2.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        load_torch_vit_checkpoint(ViT(patch, dim, depth, heads, size), path)


# ----------------------------------------------------------- the deviation


def test_synthetic_windows_stay_in_the_clip_at_the_flagship_window():
    """At configs/vq_vilco.yaml's 30-frame window both packages draw JAX's
    16-frame synthetic clips (bin/train_cl.py), so a training window starts
    at frame -14 and numpy wraps its frames around, so every frame of a
    window is still a frame of the clip (index mod 16): the port's window
    indices, frames and labels equal JAX's on every sample of the split,
    the wrapped frames' negative indices finding no box in either; the
    sliding-window eval cuts the clip as JAX's predict_track does."""
    w = vq_flagship_config().num_frames
    assert w == 30 and t_vq.SYNTHETIC_FRAMES == 16
    jtr, _ = j_vq.make_synthetic_vq_split(np.random.default_rng(42),
                                          num_tasks=2)
    ttr, _ = t_vq.make_synthetic_vq_split(np.random.default_rng(42),
                                          num_tasks=2)
    assert ttr == jtr
    S = 32
    runner = object.__new__(j_vq.VQEpisodeRunner)
    port = object.__new__(t_vq.VQEpisodeRunner)
    runner.window = port.window = w
    runner.source = j_vq.SyntheticVQSource(S)
    port.source = t_vq.SyntheticVQSource(S)
    n_wrapped = 0
    for cats in ttr.values():
        for samples in cats.values():
            for s in samples:
                assert s["num_frames"] == 16
                for seed in range(3):
                    want = j_vq.VQEpisodeRunner._sample_window(
                        runner, s, np.random.default_rng(seed))
                    got = port._sample_window(s, np.random.default_rng(seed))
                    idx = port._window_indices(s, np.random.default_rng(seed))
                    np.testing.assert_array_equal(
                        idx, j_vq.VQEpisodeRunner._window_indices(
                            runner, s, np.random.default_rng(seed)))
                    assert idx[0] == 16 - w == -14 and len(idx) == w
                    assert got.keys() == want.keys()
                    for k in want:
                        np.testing.assert_array_equal(got[k], want[k],
                                                      err_msg=k)
                    wrapped = idx < 0
                    assert not got["clip_with_bbox"][wrapped].any()
                    np.testing.assert_array_equal(
                        got["clip"][wrapped],
                        port.source.clip(s)[idx[wrapped] + 16])
                    n_wrapped += int(wrapped.sum())
    assert n_wrapped > 0
    # serving a 16-frame clip: one window, its tail clipped to the last
    # frame, as JAX's predict_track cuts it
    idx, chunk = t_vq.window_chunks(16, w, 8)
    np.testing.assert_array_equal(idx, np.minimum(np.arange(w), 15)[None])
    assert chunk == 1
