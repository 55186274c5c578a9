"""The port's multi-GPU training pieces on the CPU (vilco_tpu_torch/parallel/):
the sharding rules against JAX's `_param_spec` / `param_shardings` for
every leaf of the tiny MQ (XL on), the MQ yaml, NLQ and VQ models (through
models/convert.py's names and layouts, the replication fallback included),
make_mesh's two errors, the batch rows a rank holds, the collectives, the
sequence-parallel halo ops over 2 and 4 Gloo ranks against JAX's unsharded
`banded_attention` / `masked_conv1d` (outputs and gradients at 2e-5, the
shapes of tests/test_seq_parallel.py), and train_cl --dp 2 on the CPU
against the one-process episode (MQ at JAX's rtol 5e-2, as
tests/test_seq_parallel.py's episode test, both ranks' results equal).

The ranks are Gloo processes (parallel/launch.py: spawn, a file://
rendezvous under tmp_path), each spawn bounded by SPAWN_TIMEOUT_S.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_mq_yaml import _jax_yaml_shapes
from tests.test_torch_port_nlq import _jax_flagship_shapes
from tests.test_torch_port_vq import _flagship_shapes
from vilco_tpu.ops.attention import banded_attention as j_banded
from vilco_tpu.ops.masked import masked_conv1d as j_conv
from vilco_tpu.parallel import mesh as j_mesh
from vilco_tpu_torch.core.config import flagship_config
from vilco_tpu_torch.models.convert import _layout, port_name
from vilco_tpu_torch.models.point_transformer import PointTransformer
from vilco_tpu_torch.parallel import mesh
from vilco_tpu_torch.parallel.launch import spawn_ranks
from vilco_tpu_torch.parallel.seq import seq_channel_layernorm

SPAWN_TIMEOUT_S = 120
LR = 1e-4            # the distributed episode's (the DP step tests')
RANKS = "tests.test_torch_port_parallel_ranks"    # the ranks' targets
CPU = ["--device", "cpu"]


# ---- the sharding rules -----------------------------------------------------

def _tiny_mq_shapes():
    from __graft_entry__ import _flagship_cfg
    from vilco_tpu.models.point_transformer import PointTransformer as JPT

    cfg = _flagship_cfg(tiny=True)
    m = cfg.model.updated(use_xl=True)
    spec = lambda *s, dt=jnp.float32: jax.ShapeDtypeStruct(s, dt)
    return jax.eval_shape(JPT(m, cfg.cl_cfg).init, jax.random.PRNGKey(0),
                          spec(1, m.max_seq_len, m.input_dim),
                          spec(1, m.max_seq_len, dt=jnp.bool_))["params"]


SHAPES = {"mq_tiny_xl": _tiny_mq_shapes, "mq_yaml": _jax_yaml_shapes,
          "nlq": _jax_flagship_shapes, "vq": _flagship_shapes}
# the models with a ruled dimension that the model axis does not divide:
# the heads with one output channel (NLQ) or 12 classes and 2 offsets
FALLBACK = {2: ("nlq",), 8: ("mq_tiny_xl", "mq_yaml", "nlq")}


def _port_shape(path, shape):
    """The port's shape of a Flax leaf (convert.py's layout, on a view)."""
    view = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           [0] * len(shape))
    return tuple(_layout(path, view).shape)


def _expected(jspec, ndim):
    """JAX's spec of a kernel in the port's layout: the dims reversed (a
    Dense (in, out) is a Linear (out, in); a conv (K, Cin/g, Cout) a
    Conv1d (Cout, Cin/g, K))."""
    spec = tuple(jspec)
    if not spec:
        return ()
    return tuple(reversed(spec + (None,) * (ndim - len(spec))))


@pytest.mark.parametrize("model", sorted(SHAPES))
def test_param_spec_matches_jax(model):
    """Every leaf: the port's rule on its name and shape equals JAX's rule
    on the Flax path, and so do the shardings on (8 / mp, mp) meshes with
    the replication fallback (mp 8 leaves more dimensions undivided)."""
    tree = SHAPES[model]()
    for mp in (2, 8):
        _check_specs(model, tree, mp)


def _check_specs(model, tree, mp):
    jm = j_mesh.make_mesh(8, model_parallel=mp)
    jsh = j_mesh.param_shardings(tree, jm)
    pm = mesh.make_mesh(8, model_parallel=mp,
                        devices=[torch.device("cpu")] * 8)
    named, want_rule, want_sh = [], {}, {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shard_flat = jax.tree_util.tree_leaves(
        jsh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    for (path, leaf), sh in zip(flat, shard_flat):
        keys = tuple(p.key for p in path)
        name = port_name(keys, leaf.ndim)
        shape = _port_shape(keys, leaf.shape)
        named.append((name, shape))
        want_rule[name] = _expected(j_mesh._param_spec(path, leaf),
                                    leaf.ndim)
        want_sh[name] = _expected(sh.spec, leaf.ndim)
    got_rule = {n: mesh.param_spec(n, s) for n, s in named}
    assert got_rule == want_rule
    got_sh = mesh.param_shardings(named, pm)
    assert got_sh == want_sh
    sharded = sum(bool(s) for s in got_sh.values())
    assert 0 < sharded < len(got_sh)
    # where a ruled dimension does not divide, the fallback was taken
    fell = [n for n in got_rule if got_rule[n] and not got_sh[n]]
    assert bool(fell) == (model in FALLBACK.get(mp, ())), fell


def test_param_spec_on_the_port_model():
    """The tiny MQ model with the XL stage: every named parameter has a
    rule, the column- and row-parallel Linear weights and the dense convs
    are sharded, the depthwise convs and the XL's (C, H, D) projections
    not."""
    m = flagship_config(tiny=True).model
    model = PointTransformer(m, device="cpu")
    specs = {n: mesh.param_spec(n, tuple(p.shape))
             for n, p in model.named_parameters()}
    assert specs["backbone.xl_0.ff1.weight"] == ("model", None)
    assert specs["backbone.xl_0.ff2.weight"] == (None, "model")
    assert specs["backbone.xl_0.q"] == ()
    assert any(n.endswith("mlp_fc1.weight") and s == ("model", None)
               for n, s in specs.items())
    dw = [n for n, p in model.named_parameters()
          if p.dim() == 3 and p.shape[1] == 1]
    assert dw and all(specs[n] == () for n in dw)


def test_make_mesh_errors_match_jax():
    cpu = [torch.device("cpu")] * 2
    with pytest.raises(ValueError,
                       match="requested 3 devices but only 2 are available"):
        mesh.make_mesh(3, devices=cpu)
    with pytest.raises(ValueError,
                       match="requested 9 devices but only 8 are available"):
        j_mesh.make_mesh(9)
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "model_parallel=2"):
        mesh.make_mesh(3, model_parallel=2, devices=cpu * 2)
    with pytest.raises(ValueError, match="3 devices not divisible by "
                                         "model_parallel=2"):
        j_mesh.make_mesh(3, model_parallel=2)
    m = mesh.make_mesh(4, model_parallel=2, devices=cpu * 2)
    assert m.shape == {"data": 2, "model": 2} and len(m.devices) == 4
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 1 devices but only "
                                             "0 are available"):
            mesh.make_mesh(1)


@pytest.mark.parametrize("world,micro", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_shard_rows_are_each_micro_batch_share(world, micro):
    """The ranks' rows partition the batch, and rank r's k-th local
    micro-batch is its share of JAX's k-th global micro-batch (rows
    [k n/K, (k+1) n/K))."""
    n = 8
    got = [mesh.shard_rows(n, r, world, micro) for r in range(world)]
    assert sorted(np.concatenate(got).tolist()) == list(range(n))
    m = n // micro
    for r, rows in enumerate(got):
        for k, part in enumerate(np.split(rows, micro)):
            assert set(part) <= set(range(k * m, (k + 1) * m))
            assert part.tolist() == list(range(k * m + r * m // world,
                                               k * m + (r + 1) * m // world))
    batch = {"a": np.arange(n * 2).reshape(n, 2), "b": torch.arange(n)}
    sh = mesh.shard_batch(batch, world - 1, world, micro)
    np.testing.assert_array_equal(sh["a"], batch["a"][got[-1]])
    assert sh["b"].tolist() == got[-1].tolist()
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_rows(6, 0, 4, 1)


def test_row_draws_are_the_global_draws_rows():
    """A RowDraw's rows are the rows of the draw of the global shape from
    the same generator state, and the generator advances alike."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    full = mesh.rand_rows((6, 4), g1, "cpu")
    part = mesh.rand_rows((2, 4), mesh.RowDraw(g2, 6, 2), "cpu")
    assert torch.equal(part, full[2:4])
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))
    r = mesh.RowDraw(g2, 3, 1).rows_of(4)
    assert (r.total, r.start) == (12, 4)
    with pytest.raises(ValueError):
        mesh.rand_rows((3, 1), mesh.RowDraw(g2, 4, 2), "cpu")


def test_collectives_over_gloo(tmp_path):
    """All-reduce, the zero-padded gather (floats, bf16, bools, ints) and
    its backward, the broadcast and the bitwise replication check, over 3
    Gloo ranks."""
    out = spawn_ranks(f"{RANKS}:collectives_rank", ["cpu"] * 3,
                      timeout_s=SPAWN_TIMEOUT_S, tmp_dir=str(tmp_path))
    for r, res in enumerate(out):
        assert res["sum"].tolist() == [6.0, 6.0]
        np.testing.assert_array_equal(
            res["gathered"], np.repeat(np.arange(3.0), 2).reshape(3, 2))
        assert res["bf16"].tolist() == [0.5, 1.5, 2.5]
        assert res["bools"].tolist() == [True, False, True]
        assert res["ints"].tolist() == [0, 10, 20]
        # rank s's loss: (s + 1) sum(gather(x)); the gradient of the sum of
        # the ranks' losses at any rank's x is 1 + 2 + 3
        np.testing.assert_array_equal(res["grad"], np.full(2, 6.0))
        assert res["replicated"] and res["caught"]


# ---- the sequence-parallel halo ops ------------------------------------------

def _ragged_mask(rng, B, T):
    lens = rng.integers(T // 2, T + 1, size=B)
    return np.arange(T)[None, :] < lens[:, None]


def _seq(op_spec, world, tmp_path):
    parts = spawn_ranks(f"{RANKS}:seq_rank",
                        ["cpu"] * world, (op_spec,), timeout_s=SPAWN_TIMEOUT_S,
                        tmp_dir=str(tmp_path))
    out = np.concatenate([p["out"] for p in parts], 1)
    grads = {k: np.concatenate([p["grads"][k] for p in parts], 1)
             for k in parts[0]["grads"]}
    return out, grads


@pytest.mark.parametrize("world", [2, 4])
def test_seq_banded_attention_matches_jax(world, rng, tmp_path):
    """The halo-exchange banded attention over `world` time shards against
    JAX's unsharded banded_attention: output and the gradients of q, k, v
    at 2e-5 (tests/test_seq_parallel.py's shapes: T 256, w 16, a ragged
    mask)."""
    B, T, H, D, w = 2, 256, 2, 8, 16
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = _ragged_mask(rng, B, T)
    out, grads = _seq(dict(op="banded", q=q, k=k, v=v, mask=mask, window=w,
                           gout=g), world, tmp_path)

    def loss(q_, k_, v_):
        o = j_banded(q_, k_, v_, jnp.asarray(mask), w)
        return (o * g).sum(), o

    (_, ref), jg = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=2e-5)
    for name, want in zip("qkv", jg):
        np.testing.assert_allclose(grads[name], np.asarray(want), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("world,stride", [(2, 1), (4, 1), (4, 2)])
def test_seq_masked_conv1d_matches_jax(world, stride, rng, tmp_path):
    """The halo-exchange masked conv over `world` time shards against
    JAX's unsharded masked_conv1d (T 128, K 5 and 3 strided): output, mask
    and the input's gradient at 2e-5."""
    B, T, Cin, Cout, K = (2, 128, 6, 10, 5) if stride == 1 else \
        (2, 128, 4, 4, 3)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    kern = (rng.standard_normal((K, Cin, Cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((Cout,)).astype(np.float32)
    mask = _ragged_mask(rng, B, T)
    g = rng.standard_normal((B, T // stride, Cout)).astype(np.float32)
    out, grads = _seq(dict(op="conv", x=x, mask=mask,
                           weight=kern.transpose(2, 1, 0), bias=bias,
                           stride=stride, gout=g), world, tmp_path)

    def loss(x_):
        o, _ = j_conv(x_, jnp.asarray(mask), jnp.asarray(kern),
                      jnp.asarray(bias), stride=stride)
        return (o * g).sum(), o

    (_, ref), jg = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(grads["x"], np.asarray(jg), atol=2e-5,
                               rtol=2e-5)


def test_seq_channel_layernorm_is_shard_local(rng):
    x = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32))
    whole = seq_channel_layernorm(x)
    parts = torch.cat([seq_channel_layernorm(x[:, :4]),
                       seq_channel_layernorm(x[:, 4:])], 1)
    assert torch.equal(whole, parts)


# ---- train_cl --dp on the CPU --------------------------------------------------

def test_train_cl_dp_matches_one_process(tmp_path, monkeypatch):
    """The MQ episode (2 tasks, 1 epoch) as 2 Gloo ranks against the
    one-process episode: the final mAP and R1@0.5 at JAX's rtol 5e-2
    (tests/test_seq_parallel.py:198-218), both ranks' results equal, and
    rank 0 alone writes the run's files."""
    from vilco_tpu_torch.bin import train_cl

    from tests.test_torch_port_parallel_steps import one_thread

    common = ["--synthetic", "--epochs", "1", "--num-tasks", "2", *CPU]
    with one_thread():
        r1 = train_cl.main([*common, "--workdir", str(tmp_path / "a")])
    monkeypatch.setattr(train_cl, "RUN_TIMEOUT_S", SPAWN_TIMEOUT_S)
    r2 = train_cl.main([*common, "--dp", "2", "--workdir",
                        str(tmp_path / "b")])
    for key in ("avg_mAP", "avg_R1@0.5"):
        assert np.isclose(r1["final"][key], r2["final"][key], rtol=5e-2)
    a, b = r2["rank_finals"]
    assert a == b
    files = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert files == ["config.json", "metrics.jsonl", "results.json",
                     "task_000.ckpt", "task_001.ckpt"]


def test_train_cl_dp_asks_for_cards_that_exist(tmp_path, capsys):
    """--dp on the card asks make_mesh for the cards: more than exist
    exits with JAX's message, and nothing carries on on the CPU."""
    from vilco_tpu_torch.bin import train_cl

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as e:
        train_cl.main(["--synthetic", "--dp", str(n), "--workdir",
                       str(tmp_path)])
    assert e.value.code != 0
    assert (f"requested {n} devices but only {n - 1} are available"
            in capsys.readouterr().err)


def _numbers(x) -> np.ndarray:
    """The numbers of a results tree (dicts by key, lists), in order."""
    if isinstance(x, dict):
        return np.concatenate([_numbers(x[k]) for k in sorted(x)] + [[]])
    if isinstance(x, (list, tuple)):
        return np.concatenate([_numbers(v) for v in x] + [[]])
    return np.asarray([float(x)])


class ConcatShards:
    """The train loader of one process on the concatenated shards: each
    step the batches of `num_shards` sharded loaders, in shard order (the
    host-major global batch of --distributed)."""

    def __init__(self, loaders):
        self.loaders = loaders

    def __len__(self):
        return len(self.loaders[0])

    def set_epoch(self, epoch):
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __iter__(self):
        for parts in zip(*self.loaders):
            batch = {k: np.concatenate([b[k] for b, _ in parts])
                     for k in parts[0][0]}
            meta = {k: sum((list(m[k]) for _, m in parts), [])
                    for k in parts[0][1]}
            yield batch, meta


@pytest.mark.parametrize("task,accum", [
    pytest.param("mq", 1, id="mq"), pytest.param("vq", 1, id="vq"),
    pytest.param("mq", 2, id="mq_accum2")])
def test_train_cl_distributed_two_ranks(task, accum, tmp_path, monkeypatch):
    """`train_cl --distributed` as torchrun launches it, two ranks on the
    CPU (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): each
    trains on its shard (VQ: its slice of the global window batch), DP is
    switched on with JAX's warning, each rank writes its own workdir (rank
    1 under rank1/), and both end with the same results. MQ, at 1 and 2
    micro-batches a step: the ranks equal one process that trains on the
    concatenated shards (micro-batch k JAX's global rows [k b/K, (k+1)
    b/K)) at lr 1e-4, at the DP step tests' limits: the final metrics 1e-5
    relative, the parameters 1e-6 for each step the episode takes (those
    tests' limit for their steps; the episode's roundoff grows with its
    steps: 1.6e-6 after 4 and after 12, against 1.8e-4 when micro-batch k
    is the ranks' local micro-batches k), ZERO_GRAD's leaves 2 x the
    summed lr."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from tests.test_torch_port_parallel_steps import (
        PARAM_ATOL,
        RTOL,
        _check_params,
        one_thread,
    )
    from vilco_tpu_torch.bin import train_cl
    from vilco_tpu_torch.cl import episode
    from vilco_tpu_torch.core.checkpoint import load_checkpoint, params_of
    from vilco_tpu_torch.data.synthetic import tiny_config

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    wd = tmp_path / "w"
    args = ["--synthetic", "--task", task, "--epochs", "1", "--num-tasks",
            "2", *CPU]
    if task == "mq":
        cfg = tmp_path / "config.json"
        cfg.write_text(json.dumps(tiny_config(
            opt={"learning_rate": LR, "accumulation_steps": accum})
            .to_dict()))
        args += ["--config", str(cfg)]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vilco_tpu_torch.bin.train_cl",
             "--distributed", "--workdir", str(wd), *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs[0][-2000:]
    assert "enabling --dp -1" in logs[0]
    finals = [json.loads((d / "results.json").read_text())["final"]
              for d in (wd, wd / "rank1")]
    assert finals[0] == finals[1]
    if task != "mq":
        return
    real = episode.BatchIterator

    def loader(data, cfg, bs, is_training=False, **kw):
        if not is_training:
            return real(data, cfg, bs, is_training=False, **kw)
        kw.pop("shard_id"), kw.pop("num_shards")
        return ConcatShards([real(data, cfg, bs, is_training=True,
                                  shard_id=r, num_shards=2, **kw)
                             for r in range(2)])

    monkeypatch.setattr(episode, "BatchIterator", loader)
    one = tmp_path / "one"
    with one_thread():
        r1 = train_cl.main(["--workdir", str(one), *args])
    a, b = _numbers(finals[0]), _numbers(r1["final"])
    assert len(a) == len(b) and np.all(np.abs(a - b) <= RTOL * np.abs(b))
    steps = sum(t["train"]["steps"] for t in r1["tasks"])
    got = params_of(load_checkpoint(str(wd / "task_001.ckpt")))
    want = params_of(load_checkpoint(str(one / "task_001.ckpt")))
    _check_params({n: t.numpy() for n, t in got.items()},
                  {n: t.numpy().astype(np.float64)
                   for n, t in want.items()},
                  PARAM_ATOL * steps, LR * steps)
