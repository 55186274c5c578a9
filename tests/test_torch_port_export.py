"""The port's serving export (vilco_tpu_torch/bin/export_model.py) against
JAX's (vilco_tpu/bin/export_model.py) on the CPU.

The same parameters (JAX's init, carried across with models/convert.py)
go through JAX's `export_forward` / `export_vq_forward` and
`load_exported` on the CPU platform, and through the port's, saved as a
`.pt2` and loaded back; the outputs agree within 1e-5 (f32 on both
sides). The CLIs round-trip too: `--tiny` with a JAX checkpoint through
both packages' CLIs, `--task vq --workdir` through the port's against the
eager matcher on the same checkpoint. `kernels.plain_math()` is scoped:
the wrappers take their plain versions inside it only.
"""

import json
import operator

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu.bin import export_model as j_export
from vilco_tpu.core.checkpoint import save_checkpoint as j_save_checkpoint
from vilco_tpu.data.synthetic import tiny_config as j_tiny_config
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.tasks.nlq import nlq_tiny_config as j_nlq_tiny_config
from vilco_tpu.tasks.vq import build_clip_matcher
from vilco_tpu_torch import kernels
from vilco_tpu_torch.bin import export_model as t_export
from vilco_tpu_torch.core.checkpoint import save_checkpoint
from vilco_tpu_torch.data.synthetic import tiny_config
from vilco_tpu_torch.models.clip_matcher import ClipMatcher
from vilco_tpu_torch.models.convert import load_jax_params
from vilco_tpu_torch.models.point_transformer import PointTransformer
from vilco_tpu_torch.tasks.nlq import nlq_tiny_config
from vilco_tpu_torch.tasks.vq import toy_vq_config

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {"mq": (j_tiny_config, tiny_config),
           "nlq": (j_nlq_tiny_config, nlq_tiny_config)}


def _inputs(jcfg, seed):
    """The exported program's inputs at the config's static shapes:
    feats, a ragged mask, and the text and its mask with use_text."""
    rng = np.random.default_rng(seed)
    B, T, C = (jcfg.loader.batch_size, jcfg.dataset.max_seq_len,
               jcfg.dataset.input_dim)
    xs = [rng.standard_normal((B, T, C)).astype(np.float32),
          np.arange(T)[None] < np.linspace(T, T // 2, B).astype(int)[:, None]]
    if jcfg.dataset.use_text:
        L = jcfg.dataset.max_text_len
        xs += [rng.standard_normal((B, L, jcfg.model.n_txt_in)).astype(
                   np.float32),
               np.arange(L)[None] < np.linspace(L, 2, B).astype(int)[:, None]]
    return xs


def _jax_params(jcfg, xs):
    model = JPT(jcfg.model, jcfg.cl_cfg)
    init = jax.jit(lambda key, *a: model.init(key, *a[:2], *a[2:],
                                              deterministic=True))
    return init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))["params"]


@pytest.fixture(scope="module")
def mq_params():
    return _jax_params(j_tiny_config(), _inputs(j_tiny_config(), 1))


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("task", ["mq", "nlq"])
def test_export_forward_matches_jax(tmp_path, task, mq_params):
    jcfg_fn, cfg_fn = CONFIGS[task]
    jcfg, cfg = jcfg_fn(), cfg_fn()
    xs = _inputs(jcfg, 1)
    params = mq_params if task == "mq" else _jax_params(jcfg, xs)
    exp = j_export.export_forward(jcfg, params, platforms=("cpu",))
    (tmp_path / "m.hlo").write_bytes(exp.serialize())
    want = j_export.load_exported(str(tmp_path / "m.hlo"))(
        *map(jnp.asarray, xs))

    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    load_jax_params(model, params)
    ep = t_export.export_forward(cfg, model, device="cpu")
    torch.export.save(ep, str(tmp_path / "m.pt2"))
    got = t_export.load_exported(str(tmp_path / "m.pt2"))(
        *map(torch.from_numpy, xs))
    assert set(got) == {"cls_logits", "offsets"}
    _close({k: v.numpy() for k, v in got.items()}, want)


def _jax_matcher_params():
    """JAX's toy ClipMatcher in f32, its params with the two output convs
    redrawn at scale 0.05 (their init is N(0, 1e-6))."""
    jm = build_clip_matcher().clone(compute_dtype="float32")
    S = jm.clip_size
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, S, S, 3)),
        jnp.zeros((1, S, S, 3)), deterministic=True)["params"])
    rng = np.random.default_rng(3)
    for name in ("reg_head", "cls_head"):
        for leaf in ("kernel", "bias"):
            a = params["head"][name][leaf]
            params["head"][name][leaf] = (0.05 * rng.standard_normal(
                a.shape)).astype(np.float32)
    return jm, params


def _clip_query(cfg, seed, batch=1):
    rng = np.random.default_rng(seed)
    S, T = cfg.clip_size, cfg.num_frames
    return (rng.random((batch, T, S, S, 3)).astype(np.float32),
            rng.random((batch, S, S, 3)).astype(np.float32))


def test_export_vq_forward_matches_jax(tmp_path):
    jm, params = _jax_matcher_params()
    exp = j_export.export_vq_forward(jm, params, platforms=("cpu",))
    (tmp_path / "vq.hlo").write_bytes(exp.serialize())
    cfg = toy_vq_config()
    xs = _clip_query(cfg, 2)
    want = j_export.load_exported(str(tmp_path / "vq.hlo"))(
        *map(jnp.asarray, xs))

    matcher = ClipMatcher(cfg, device="cpu", compute_dtype=torch.float32)
    load_jax_params(matcher, params)
    ep = t_export.export_vq_forward(matcher, device="cpu")
    torch.export.save(ep, str(tmp_path / "vq.pt2"))
    got = t_export.load_exported(str(tmp_path / "vq.pt2"))(
        *map(torch.from_numpy, xs))
    assert set(got) == {"bbox", "prob"}
    _close({k: v.numpy() for k, v in got.items()}, want)


def test_cli_tiny_round_trip_matches_jax(tmp_path, capsys, mq_params):
    """Both CLIs export the tiny MQ forward from one JAX checkpoint; the
    loaded programs agree."""
    xs = _inputs(j_tiny_config(), 4)
    ckpt = str(tmp_path / "task_000.ckpt")
    j_save_checkpoint(ckpt, {"params": mq_params, "task": 0})
    j_export.main(["--tiny", "--ckpt", ckpt, "--platforms", "cpu",
                   "--out", str(tmp_path / "j.hlo")])
    t_export.main(["--tiny", "--ckpt", ckpt, "--device", "cpu",
                   "--out", str(tmp_path / "t.pt2")])
    out = capsys.readouterr().out.splitlines()[-1]
    assert out.startswith(f"wrote {tmp_path / 't.pt2'}") and "save" in out
    want = j_export.load_exported(str(tmp_path / "j.hlo"))(
        *map(jnp.asarray, xs))
    got = t_export.load_exported(str(tmp_path / "t.pt2"))(
        *map(torch.from_numpy, xs))
    _close({k: v.numpy() for k, v in got.items()}, want)


def test_cli_vq_workdir_round_trip(tmp_path):
    """--task vq --workdir: the geometry from vq_config.json and the
    newest vq_task_*.ckpt; the loaded program against the eager matcher
    (bf16, as the runner computes) with that checkpoint."""
    cfg = toy_vq_config(window=3, frame_size=32)
    with open(tmp_path / "vq_config.json", "w") as f:
        json.dump({"window": 3, "frame_size": 32, "model_cfg": None}, f)
    gen = lambda s: torch.Generator().manual_seed(s)
    old = ClipMatcher(cfg, generator=gen(1), device="cpu")
    new = ClipMatcher(cfg, generator=gen(2), device="cpu")
    for task, m in ((0, old), (1, new)):
        save_checkpoint(str(tmp_path / f"vq_task_{task:03d}.ckpt"), {
            "params": {k: v.numpy() for k, v in m.state_dict().items()},
            "task": task})
    t_export.main(["--task", "vq", "--workdir", str(tmp_path), "--device",
                   "cpu", "--out", str(tmp_path / "v.pt2")])
    xs = [torch.from_numpy(x) for x in _clip_query(cfg, 5)]
    got = t_export.load_exported(str(tmp_path / "v.pt2"))(*xs)
    with torch.no_grad():
        want = new.eval()(*xs)
    for k in ("bbox", "prob"):
        assert got[k].shape == want[k].shape
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_plain_math_is_scoped():
    """The wrappers take their plain versions on CPU tensors always, on
    other devices only inside plain_math(), which resets on exit, an
    exception's too."""
    meta = torch.empty(1, device="meta")
    assert kernels.takes_plain(torch.empty(1))
    assert not kernels.takes_plain(meta)
    with kernels.plain_math():
        assert kernels.takes_plain(meta)
    assert not kernels.takes_plain(meta)
    with pytest.raises(RuntimeError):
        with kernels.plain_math():
            raise RuntimeError
    assert not kernels.takes_plain(meta)


def test_exported_graph_holds_only_aten_ops():
    """Every call in the exported MQ program is an ATen operator (or the
    getitem of a multi-output one): no kernel of the port, no Python
    call."""
    cfg = tiny_config()
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    ep = t_export.export_forward(cfg, model, device="cpu")
    calls = [n.target for n in ep.graph.nodes if n.op == "call_function"
             and n.target is not operator.getitem]
    other = {str(t) for t in calls if getattr(t, "namespace", None) != "aten"}
    assert calls and not other, other
