"""The port's MQ flagship as configs/mq_vilco.yaml runs it (text tower,
branch cross-attention, L2P prompt pool, time adapters with their EMA,
narration SSL, the AL loss) against the JAX package on the CPU.

The config equals the yaml as `load_config(...).derived()` reads it, and
the tiny twin equals vilco_tpu/data/synthetic.py::tiny_config() with the
yaml's switches on (and the XL stage, as the port always runs it). The
JAX `PointTransformer` is initialised at the tiny twin in f32; its
parameters, perturbed so that no block is near its init (the adapters'
zero fc2 included), load into the port through `load_jax_params`, and the
same numpy batches go through both. JAX's XL dropout is set to 0 on its
side for the train-mode comparisons and the port's step runs with
regularize=False: the two frameworks' random streams cannot be matched
(dropout and drop-path are 0 at the tiny twin). The full-width tree (560
leaves from `jax.eval_shape`) loads strictly.

Tolerances: the model's outputs, every loss term and the loss 1e-5
relative (max|port - jax| / max|jax|); every gradient leaf 1e-5 with the
denominator floored at 1e-4 of the largest gradient (leaves whose exact
gradient is 0 hold roundoff only), the per-level Scale scalars 3e-5, as
tests/test_torch_port_train.py holds the graft MQ path; the 3-step
lockstep's parameters and adapter EMA within 5e-5 of each leaf's largest
value, the EMA's move from the first adapters (at decay 0.5 on both
sides) within 1e-2 of each leaf's largest move, the memory bank 1e-5 of
its largest value, the pointer exact.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from tests.test_torch_port_model import assert_port_config_equals
from tests.test_torch_port_train import _rel
from vilco_tpu.cl import prompt as j_prompt
from vilco_tpu.core.config import load_config
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.data.synthetic import tiny_config
from vilco_tpu.models import layers as j_layers
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.train import engine as j_engine
from vilco_tpu.train import optim as j_optim
from vilco_tpu_torch.cl.prompt import PromptPool
from vilco_tpu_torch.core.config import CLCfg, mq_yaml_config
from vilco_tpu_torch.data.synthetic import make_batch, task_extras
from vilco_tpu_torch.models import layers as t_layers
from vilco_tpu_torch.models.convert import (
    adapter_ema_from_jax,
    load_jax_params,
    params_from_jax,
    port_name,
)
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.train import engine as t_engine
from vilco_tpu_torch.train import optim as t_optim

YAML = "configs/mq_vilco.yaml"
RTOL = 1e-5
SPE = 1
TASK = 1             # the CL task of the train-step tests: n_known > 0
LOCKSTEP_LR = 1e-4
# the lockstep's adapter EMA decay: at the yaml's 0.999 three steps move the
# EMA ~1e-3 of the adapters' own ~1e-4 steps, under any tolerance on the EMA
# itself; at 0.5 the EMA moves by half the adapters' steps
LOCKSTEP_EMA_DECAY = 0.5
# the EMA's displacement, port against JAX, relative to its largest value:
# AdamW stores its moments in bf16, and a rounding that falls the other way
# on one side moves that element's step by up to 2^-8
EMA_RTOL = 1e-2
INPUTS = ("feats", "mask", "text", "text_mask", "narration",
          "narration_mask", "narration_valid", "prompt_mask")
# 294,892,462 parameters in 560 leaves (jax.eval_shape of the JAX model)
FLAGSHIP_LEAVES, FLAGSHIP_PARAMS = 560, 294_892_462
# leaves whose exact gradient is 0: an attention's key bias and key-norm
# bias shift all of a query row's scores alike, and the softmax ignores
# that; both sides hold only f32 roundoff there
ZERO_GRAD = ("attn.key.bias", "attn.key_norm.bias")
# a time adapter's fc2 bias adds one value to every channel of a time step:
# every LayerNorm removes that shift, so it reaches the loss only through
# the next block's max-pool skip (not at all from the last block); its
# gradient is ~1e-4 of the largest or 0, a cancelling sum of a few bits
SHIFT_GRAD = ZERO_GRAD + ("adapter.fc2.bias",)
OUT_KEYS = ("cls_logits", "offsets", "reduce_sim", "narration_feat",
            "video_feat")


def _jax_tiny(xl_dropout=0.1):
    cfg = tiny_config(
        dataset={"use_text": True, "use_narration": True},
        model={"use_xl": True, "use_cross_modal": True},
        cl_cfg={"name": "l2p", "memory_size": 1010, "prompt_pool": True,
                "narration_ssl": True, "use_adapt": True,
                "adapt_blocks": (0, 1, 2, 3, 4)})
    return cfg.updated(model=cfg.model.updated(xl_dropout=xl_dropout))


def _points(m):
    return generate_points(level_lengths(m), m.fpn_strides,
                           m.regression_range)


def _perturbed(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _batch(rng, cfg, B=2, task=TASK, invalid_narration=True):
    """A batch of the JAX make_batch with the task's prompt slots; with
    `invalid_narration` the first clip's narration marked invalid."""
    b = j_make_batch(rng, B, cfg)
    b["prompt_mask"] = task_extras(mq_yaml_config(tiny=True), task,
                                   B)["prompt_mask"]
    if invalid_narration:
        b["narration_valid"] = b["narration_valid"].copy()
        b["narration_valid"][0] = False
        b["narration_valid"][1] = True
    return b


@pytest.mark.parametrize("tiny", [False, True])
def test_mq_yaml_config_matches_jax(tiny):
    ref = _jax_tiny() if tiny else load_config(YAML).derived()
    port = mq_yaml_config(tiny=tiny)
    assert_port_config_equals(port, ref)
    for f in dataclasses.fields(CLCfg):
        assert getattr(port.cl_cfg, f.name) == getattr(ref.cl_cfg, f.name), \
            f"cl_cfg.{f.name}"
    assert port.max_narration_len == ref.dataset.max_narration_len
    assert ref.dataset.use_text and ref.dataset.use_narration
    m = ref.model
    assert m.use_cross_modal and m.use_xl
    assert tuple(m.cross_modal_skip_levels) == \
        port.model.cross_modal_skip_levels == (1, 2)
    assert m.dropout == ref.train_cfg.dropout
    assert ref.cl_cfg.embed_dim == m.n_txt_in
    if not tiny:
        assert (m.dropout, ref.train_cfg.al_loss_weight) == (0.1, 0.2)
        assert ref.cl_cfg.name == "l2p"


def _jax_yaml_shapes():
    cfg = load_config(YAML).derived()
    m, cl, B = cfg.model, cfg.cl_cfg, 1
    T, L = m.max_seq_len, cfg.dataset.max_text_len
    Ln = cfg.dataset.max_narration_len
    spec = lambda *s, dt=jnp.float32: jax.ShapeDtypeStruct(s, dt)
    tree = jax.eval_shape(
        JPT(m, cl).init, jax.random.PRNGKey(0),
        spec(B, T, m.input_dim), spec(B, T, dt=jnp.bool_),
        spec(B, L, m.n_txt_in), spec(B, L, dt=jnp.bool_),
        spec(B, Ln, cl.narration_dim), spec(B, Ln, dt=jnp.bool_),
        spec(B, dt=jnp.bool_))
    return tree["params"]


def _assert_decay_mask(params, model):
    jmask = j_optim.weight_decay_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = {port_name(tuple(p.key for p in path), len(a.shape)): bool(d)
            for (path, a), d in zip(flat, jax.tree_util.tree_leaves(jmask))}
    got = t_optim.weight_decay_mask(model.named_parameters())
    assert got == want
    for n in ("prompt.prompt", "prompt.prompt_key"):
        assert not got[n], n
    for n in ("narration_encoder.weight",
              "backbone.branch_0.adapter.fc1.weight",
              "backbone.branch_2.adapter.fc2.weight",
              "backbone.branch_0.cross_attn.query.weight"):
        assert got[n], n


def test_mq_yaml_tree_loads_strictly():
    """All 560 leaves of the full-width JAX tree land on the port's
    parameters, the stems carry no cross-attention, the adapters' shapes
    follow their blocks' input lengths, and the decay mask equals
    weight_decay_mask on every leaf."""
    shapes = _jax_yaml_shapes()
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == FLAGSHIP_LEAVES
    assert sum(int(np.prod(a.shape)) for a in leaves) == FLAGSHIP_PARAMS
    cfg = mq_yaml_config()
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    names = dict(model.named_parameters())
    assert len(names) == FLAGSHIP_LEAVES
    assert sum(p.numel() for p in names.values()) == FLAGSHIP_PARAMS
    assert not any(n.startswith(("backbone.stem_", "backbone.txt_stem_"))
                   and ".cross_attn." in n for n in names)
    cross = {int(n.split(".")[1].split("_")[1]) for n in names
             if n.startswith("backbone.branch_") and ".cross_attn." in n}
    assert cross == {0, 3, 4, 5, 6, 7, 8}
    assert tuple(names["backbone.branch_0.adapter.fc1.weight"].shape) == (
        5120, 1024)
    assert tuple(names["backbone.branch_0.adapter.fc2.weight"].shape) == (
        512, 5120)
    assert tuple(names["prompt.prompt"].shape) == (10, 20, 768)
    assert tuple(names["narration_encoder.weight"].shape) == (1024, 512)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    load_jax_params(model, zeros)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in model.parameters())
    _assert_decay_mask(shapes, model)


def test_mq_yaml_make_batch_matches_jax():
    a = j_make_batch(np.random.default_rng(4), 3, _jax_tiny())
    b = make_batch(np.random.default_rng(4), 3, mq_yaml_config(tiny=True))
    assert set(a) == set(b) and {"text", "narration_valid"} <= set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ex = task_extras(mq_yaml_config(), 1, 2)
    assert ex["n_known"] == 22 and ex["class_mask"].sum() == 44
    assert ex["class_mask"][:44].all()
    np.testing.assert_array_equal(ex["prompt_mask"], [[4, 5, 6, 7]] * 2)
    assert task_extras(mq_yaml_config(), 3, 2)["prompt_mask"] is None


def _pool_case(case, rng):
    """(x (B, L, C), keys (pool, C), prompt_mask or None)."""
    B, L, C, pool = 5, 6, 16, 10
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    keys = rng.uniform(-1, 1, (pool, C)).astype(np.float32)
    if case == "tie":
        # one-hot keys; every row ranks ids 2, 4, 6 first, then its own id:
        # 0 for rows 0-1, 1 for rows 2-3, 9 for row 4, so ids 0 and 1 tie
        # at 2 votes for the fourth slot and the lower id must win
        keys = np.eye(pool, C, dtype=np.float32)
        x = np.zeros((B, L, C), np.float32)
        for b, own in enumerate((0, 0, 1, 1, 9)):
            for d, v in zip((2, 4, 6, own), (1.0, 0.9, 0.8, 0.7)):
                x[b, :, d] = v
    mask = (np.array([[1, 3, 5, 7]] * B) if case == "mask" else None)
    return x, keys, mask


@pytest.mark.parametrize("case", ["similarity", "tie", "mask"])
def test_prompt_pool_matches_jax(case):
    """The choice by cosine similarity and the batch's majority vote, a
    vote whose counts tie (JAX's lax.top_k: the lower id first), and a
    given prompt_mask; prompted tokens and reduce_sim 1e-5."""
    rng = np.random.default_rng(11)
    x, keys, mask = _pool_case(case, rng)
    pool, C = keys.shape
    prompts = rng.uniform(-1, 1, (pool, 3, C)).astype(np.float32)
    jpool = j_prompt.PromptPool(pool_size=pool, length=3, embed_dim=C,
                                top_k=4)
    params = {"prompt": prompts, "prompt_key": keys}
    ref = jpool.apply({"params": params}, jnp.asarray(x),
                      prompt_mask=None if mask is None
                      else jnp.asarray(mask))
    tpool = PromptPool(pool, 3, C, 4)
    load_jax_params(tpool, params)
    with torch.no_grad():
        prompted, reduce_sim, idx = tpool(
            torch.from_numpy(x),
            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref["idx"]))
    if case == "tie":
        votes = np.bincount(np.argsort(-(x.mean(1) @ keys.T), 1,
                                       kind="stable")[:, :4].ravel(),
                            minlength=pool)
        assert votes[0] == votes[1] == 2 and idx[0].tolist() == [
            2, 4, 6, 0]
    assert prompted.shape == (x.shape[0], 4 * 3 + x.shape[1], C)
    np.testing.assert_allclose(prompted.numpy(), np.asarray(ref["prompted"]),
                               rtol=RTOL, atol=RTOL)
    assert _rel(reduce_sim.item(), float(ref["reduce_sim"])) <= RTOL


def test_time_adapter_matches_jax(rng):
    B, T, C = 2, 12, 8
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    jad = j_layers.TimeAdapter(T)
    params = jax.jit(jad.init)(jax.random.PRNGKey(0),
                               jnp.asarray(x))["params"]
    assert not np.asarray(params["fc2"]["kernel"]).any()
    params = _perturbed(params, 3, 0.1)
    ref = jad.apply({"params": params}, jnp.asarray(x))
    tad = t_layers.TimeAdapter(T)
    load_jax_params(tad, params)
    with torch.no_grad():
        out = tad(torch.from_numpy(x))
    assert out.shape == (B, T // 2, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=RTOL)
    with pytest.raises(ValueError, match="t_in"):
        tad(torch.from_numpy(x[:, :10]))


@pytest.mark.parametrize("ptr,valid", [
    (3, [True, False, True, True]),        # an invalid row in between
    (6, [True, True, False, True]),        # wraps past the end
    (0, [False, False, False, False]),     # nothing written
])
def test_ring_update_matches_jax(ptr, valid):
    rng = np.random.default_rng(5)
    bank = rng.standard_normal((8, 3)).astype(np.float32)
    feats = rng.standard_normal((4, 3)).astype(np.float32)
    valid = np.array(valid)
    jb, jp = j_engine._ring_update(jnp.asarray(bank), jnp.asarray(ptr),
                                   jnp.asarray(feats), jnp.asarray(valid))
    tb, tp = t_engine.ring_update(torch.from_numpy(bank), torch.tensor(ptr),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(valid))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tp) == int(jp)


@pytest.fixture(scope="module")
def tiny():
    """JAX model (XL dropout 0) and perturbed params at the tiny twin,
    three batches of task 1."""
    jcfg = _jax_tiny(xl_dropout=0.0)
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    rng = np.random.default_rng(0)
    batches = [_batch(rng, jcfg) for _ in range(3)]
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *(jnp.asarray(batches[0][k])
                                 for k in INPUTS))["params"]
    return jcfg, jmodel, _perturbed(params, 7), batches


def _port_model(params):
    cfg = mq_yaml_config(tiny=True)
    model = PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg)
    load_jax_params(model, params)
    return model


def test_mq_yaml_tiny_decay_mask_matches_jax(tiny):
    _, _, params, _ = tiny
    _assert_decay_mask(params, _port_model(params))


@pytest.mark.parametrize("prompted", [False, True])
def test_mq_yaml_model_matches_jax(tiny, prompted):
    """The five outputs, with the pool choosing the prompts (serving) and
    with the task's prompt_mask (training)."""
    _, jmodel, params, batches = tiny
    b = dict(batches[0])
    if not prompted:
        b["prompt_mask"] = None
    jin = [None if b[k] is None else jnp.asarray(b[k]) for k in INPUTS]
    ref = jax.jit(jmodel.apply)({"params": params}, *jin)
    model = _port_model(params).eval()
    with torch.no_grad():
        out = model(*(None if b[k] is None else torch.from_numpy(b[k])
                      for k in INPUTS))
    assert out["level_lengths"] == ref["level_lengths"] == (64, 32, 16, 8)
    np.testing.assert_array_equal(out["fpn_mask"].numpy(),
                                  np.asarray(ref["fpn_mask"]))
    np.testing.assert_array_equal(out["narration_valid"].numpy(),
                                  np.asarray(ref["narration_valid"]))
    for key in OUT_KEYS:
        assert _rel(out[key].numpy(), np.asarray(ref[key])) <= RTOL, key
    # given no text, no text tower and no cross-attention, as in JAX (the
    # evaluate CLI's synthetic path gives the model no text)
    ref = jax.jit(jmodel.apply)({"params": params}, *jin[:2])
    with torch.no_grad():
        out = model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]))
    for key in ("cls_logits", "offsets"):
        assert _rel(out[key].numpy(), np.asarray(ref[key])) <= RTOL, key


def _cl(jax_side, task, bank_ptr):
    bank, ptr = bank_ptr
    mask = task_extras(mq_yaml_config(tiny=True), task, 2)["class_mask"]
    if jax_side:
        return j_engine.CLBatchExtras(
            class_mask=jnp.asarray(mask), memory_bank=jnp.asarray(bank),
            memory_ptr=jnp.asarray(ptr, jnp.int32))
    return t_engine.CLBatchExtras(torch.from_numpy(mask),
                                  torch.from_numpy(bank), torch.tensor(ptr))


def _bank(ptr=1008):
    """The episode's initial bank, its pointer near the end so that the
    lockstep's third write (one valid narration a batch) wraps."""
    bank, _ = t_engine.init_memory_bank(mq_yaml_config(tiny=True), "cpu")
    return bank.numpy(), ptr


def _jax_loss_fn(jcfg, jmodel, jb, task, norm):
    pts = jnp.asarray(_points(mq_yaml_config(tiny=True).model))
    n_known = task_extras(mq_yaml_config(tiny=True), task, 2)["n_known"]
    cl = _cl(True, task, _bank())

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *(jb[k] for k in INPUTS),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        loss, met, _ = j_engine.compute_losses(out, jb, pts, jcfg, cl,
                                               jnp.asarray(norm), "l2p",
                                               n_known)
        return loss, met

    return loss_fn


def _port_loss(model, b, task, norm):
    cfg = mq_yaml_config(tiny=True)
    pts = torch.from_numpy(_points(cfg.model))
    tb = t_engine.batch_to(b, "cpu")
    out = model(*(tb[k] for k in INPUTS))
    n_known = task_extras(cfg, task, 2)["n_known"]
    return t_engine.compute_losses(out, tb, pts, _cl(False, task, _bank()),
                                   torch.tensor(norm), cfg.train_cfg,
                                   n_known, cfg.cl_cfg.ssl_factor)


@pytest.mark.parametrize("task", [0, TASK])
def test_mq_yaml_loss_terms_match_jax(tiny, task):
    """Each term: cls, reg, AL, SSL (against a bank whose write wraps, the
    first clip's narration invalid) and the L2P pull (from n_known > 0)."""
    jcfg, jmodel, params, batches = tiny
    b = dict(batches[0])
    b["prompt_mask"] = task_extras(mq_yaml_config(tiny=True), task,
                                   2)["prompt_mask"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    norm = jcfg.train_cfg.init_loss_norm
    _, jm = jax.jit(_jax_loss_fn(jcfg, jmodel, jb, task, norm))(params)
    _, tm, _ = _port_loss(_port_model(params).train(), b, task, norm)
    want = {"cls_loss", "reg_loss", "al_loss", "ssl_loss", "num_pos",
            "final_loss"} | ({"reduce_sim"} if task else set())
    assert set(jm) == set(tm) == want
    for k in want:
        assert _rel(tm[k].item(), float(jm[k])) <= RTOL, k
    assert float(jm["al_loss"]) > 0 and float(jm["ssl_loss"]) > 0


def test_mq_yaml_gradients_match_jax(tiny):
    jcfg, jmodel, params, batches = tiny
    b = batches[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    norm = jcfg.train_cfg.init_loss_norm
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, jmodel, jb, TASK, norm), has_aux=True))(params)
    model = _port_model(params).train()
    loss, _, _ = _port_loss(model, b, TASK, norm)
    loss.backward()
    assert _rel(loss.item(), float(jloss)) <= RTOL
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in ("prompt.prompt", "backbone.branch_0.adapter.fc1.weight",
              "narration_encoder.weight",
              "backbone.branch_0.cross_attn.value.weight"):
        assert want[n].abs().max() > 0, n
    mx = lambda n: np.abs(want[n].numpy()).max()
    gmax = max(mx(n) for n in want)
    zero = [n for n in want if n.endswith(ZERO_GRAD)]
    # 5 MaskedMHCA (text stem, stem, 3 branches), 1 cross-attention
    assert len(zero) == 2 * 5 + 1
    for n in zero:
        assert max(np.abs(got[n].numpy()).max(), mx(n)) <= 1e-7 * gmax, n
    worst = {n: np.abs(got[n].numpy() - want[n].numpy()).max()
             / max(mx(n), 1e-4 * gmax) for n in want if n not in zero}
    bad = [(n, e) for n, e in worst.items()
           if e > (3e-5 if n.startswith("reg_head.scale_") else RTOL)]
    assert not bad, bad


def _adapter_names(ema: dict):
    """JAX's path-keyed adapter EMA ('backbone/branch_0/adapter/fc1/kernel')
    in the port's names and layouts."""
    return adapter_ema_from_jax(ema)


@pytest.fixture(scope="module")
def lockstep(tiny):
    """Three train steps of task 1 on both sides from the same parameters,
    bank and batches, at the flagship's peak lr 1e-4 (as the NLQ lockstep:
    at the twin's 2e-3, AdamW turns the f32 roundoff of near-zero
    gradients into steps of up to lr, which moves the third step's loss
    past 1e-5): (JAX state, port state, JAX and port extras, per-step
    metrics of both)."""
    jcfg, jmodel, params, batches = tiny
    jcfg = jcfg.updated(opt=jcfg.opt.updated(learning_rate=LOCKSTEP_LR))
    tx, _ = j_optim.make_optimizer(jcfg.opt, params, steps_per_epoch=SPE)
    jparams = jax.tree.map(jnp.asarray, params)
    state = j_engine.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams),
        loss_normalizer=jnp.asarray(jcfg.train_cfg.init_loss_norm),
        rng=jax.random.PRNGKey(1),
        adapter_ema=j_engine.init_adapter_ema(jparams))
    cfg = mq_yaml_config(tiny=True)
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(
        cfg.opt, learning_rate=LOCKSTEP_LR))
    pts = _points(cfg.model)
    n_known = task_extras(cfg, TASK, 2)["n_known"]
    jstep = j_engine.make_train_step(
        jmodel, tx, jnp.asarray(pts), jcfg, cl_method="l2p", use_ssl=True,
        use_prompt=True, n_known=n_known, ema_decay=LOCKSTEP_EMA_DECAY)
    tstate = t_engine.init_train_state(_port_model(params), cfg, SPE,
                                       device="cpu")
    tstep = t_engine.make_train_step(torch.from_numpy(pts), cfg.train_cfg,
                                     regularize=False, cl_cfg=cfg.cl_cfg,
                                     n_known=n_known,
                                     ema_decay=LOCKSTEP_EMA_DECAY)
    jcl, tcl = _cl(True, TASK, _bank()), _cl(False, TASK, _bank())
    mets = []
    for batch in batches:
        state, jm, (bank, ptr) = jstep(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jcl)
        jcl = jcl.replace(memory_bank=bank, memory_ptr=ptr)
        tm = tstep(tstate, t_engine.batch_to(batch, "cpu"), tcl)
        mets.append((jm, tm))
    return state, tstate, jcl, tcl, mets


def test_mq_yaml_three_step_lockstep_matches_jax(lockstep):
    """Loss, grad norm and every metric of each step 1e-5; after step 3
    every parameter and adapter-EMA leaf within 5e-5 of its largest
    value, the bank within 1e-5 of its largest value, the pointer and the
    loss normaliser (1e-7) equal. The leaves whose exact gradient is 0 or
    a cancelling sum near roundoff (SHIFT_GRAD) take AdamW steps of up to
    lr from a few bits of gradient on both sides (AdamW divides by
    sqrt(v)), so they, and their EMA, are held to the steps AdamW can take:
    port and JAX within 2 x the sum of the lrs, as in the NLQ lockstep."""
    state, tstate, jcl, tcl, mets = lockstep
    for jm, tm in mets:
        for k in ("final_loss", "grad_norm", "ssl_loss", "al_loss",
                  "reduce_sim"):
            assert _rel(tm[k], jm[k]) <= RTOL, k
    assert tstate.loss_normalizer.item() == pytest.approx(
        float(state.loss_normalizer), rel=1e-7)
    assert int(tcl.memory_ptr) == int(jcl.memory_ptr) == (1008 + 3) % 1010
    assert _rel(tcl.memory_bank.numpy(), np.asarray(jcl.memory_bank)) \
        <= RTOL
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    ema = _adapter_names(state.adapter_ema)
    assert set(ema) == set(tstate.adapter_ema) and len(ema) == 12
    got = {n: p.detach() for n, p in tstate.model.named_parameters()}
    got.update({"ema:" + n: e for n, e in tstate.adapter_ema.items()})
    want.update({"ema:" + n: e for n, e in ema.items()})
    lr_sum = sum(float(tstate.opt.sched(s)) for s in range(3))
    errs = {}
    for n, g in got.items():
        if n.endswith(SHIFT_GRAD):
            assert np.abs(g.numpy() - want[n].numpy()).max() \
                <= 2 * lr_sum, n
        else:
            errs[n] = _rel(g.numpy(), want[n].numpy())
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= 5e-5, top


def test_mq_yaml_lockstep_adapter_ema_matches_jax(tiny, lockstep):
    """The adapter EMA's displacement from the adapters' first values after
    the lockstep's three steps at decay LOCKSTEP_EMA_DECAY, port against
    JAX: within EMA_RTOL of each leaf's largest displacement (the EMA at
    the wrong decay, or not updated, is ~1 off); the SHIFT_GRAD leaves
    within 2 x the sum of the lrs, as their parameters."""
    params, state, tstate = tiny[2], lockstep[0], lockstep[1]
    init = params_from_jax(params)
    ema = _adapter_names(state.adapter_ema)
    assert set(ema) == set(tstate.adapter_ema) and len(ema) == 12
    lr_sum = sum(float(tstate.opt.sched(s)) for s in range(3))
    errs = {}
    for n, e in ema.items():
        want = (e - init[n]).numpy()
        got = (tstate.adapter_ema[n] - init[n]).numpy()
        if n.endswith(SHIFT_GRAD):
            assert np.abs(got - want).max() <= 2 * lr_sum, n
        else:
            assert np.abs(want).max() > 0.5 * LOCKSTEP_LR, n
            errs[n] = _rel(got, want)
    assert len(errs) == 9
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(errs.values()) <= EMA_RTOL, top


def test_mq_yaml_eval_step_ensemble_matches_jax(tiny, lockstep):
    """JAX's parameters and adapter EMA after the lockstep (the EMA then
    differs from the live adapters) loaded into the port: the ensemble's
    averaged cls_logits and offsets 1e-5, and the ensemble differs from
    the live adapters' forward."""
    jcfg, jmodel, _, batches = tiny
    state = lockstep[0]
    b = batches[2]
    jev = j_engine.make_eval_step(jmodel, jcfg, ensemble_adapters=True)
    ref = jev(state.params, {k: jnp.asarray(v) for k, v in b.items()},
              state.adapter_ema)
    model = _port_model(jax.tree.map(np.asarray, state.params))
    ema = _adapter_names(state.adapter_ema)
    params = dict(model.named_parameters())
    name = "backbone.branch_0.adapter.fc2.weight"
    assert not torch.equal(ema[name], params[name].detach())
    tb = t_engine.batch_to(b, "cpu")
    out = t_engine.make_eval_step(model, ensemble_adapters=True)(tb, ema)
    live = t_engine.make_eval_step(model)(tb, ema)
    for k in ("cls_logits", "offsets"):
        assert _rel(out[k].numpy(), np.asarray(ref[k])) <= RTOL, k
    assert not torch.equal(live["cls_logits"], out["cls_logits"])
    assert torch.equal(params[name], dict(model.named_parameters())[name])


def test_dropout_rate_zero_and_seed():
    """Rate 0 is the identity; one seed gives the same bits; the keep
    share at rate 0.1 lies within 5 binomial sigmas of 0.9, and the kept
    values are x / 0.9."""
    x = torch.randn(64, 257)
    gen = lambda s: torch.Generator().manual_seed(s)
    assert torch.equal(t_layers._dropout(x, 0.0, gen(0)), x)
    assert torch.equal(t_layers._dropout(x, 0.1, None), x)
    a = t_layers._dropout(x, 0.1, gen(3))
    assert torch.equal(a, t_layers._dropout(x, 0.1, gen(3)))
    assert not torch.equal(a, t_layers._dropout(x, 0.1, gen(4)))
    kept = a != 0
    n = x.numel()
    assert abs(kept.sum().item() - 0.9 * n) <= 5 * (n * 0.9 * 0.1) ** 0.5
    torch.testing.assert_close(a[kept], x[kept] / 0.9, rtol=0, atol=0)


def test_block_dropout_is_seeded_and_off_at_zero(rng):
    """A cross-modal block with a time adapter: proj_drop 0 with a
    generator equals the deterministic forward; at 0.1 one seed repeats
    its bits and another seed differs."""
    B, T, L, E = 2, 16, 5, 16
    x = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((B, L, E)).astype(np.float32))
    mask = torch.ones(B, T, dtype=torch.bool)
    ymask = torch.ones(B, L, dtype=torch.bool)
    outs = {}
    for rate in (0.0, 0.1):
        block = t_layers.TransformerBlock(E, 4, n_ds_stride=2,
                                          use_cross_modal=True,
                                          proj_drop=rate, adapter_t_in=T)
        t_layers.init_weights_(block, torch.Generator().manual_seed(0))
        with torch.no_grad():
            run = lambda g: block(x, mask, g, y, ymask)[0]
            outs[rate] = (run(None), run(torch.Generator().manual_seed(1)),
                          run(torch.Generator().manual_seed(1)),
                          run(torch.Generator().manual_seed(2)))
    det, g1, g1b, _ = outs[0.0]
    assert torch.equal(det, g1)
    det, g1, g1b, g2 = outs[0.1]
    assert torch.equal(g1, g1b) and not torch.equal(g1, g2)
    assert not torch.equal(det, g1)


def test_mq_yaml_entry_points_default_to_the_card():
    """The yaml model, its train state and its memory bank go to the card
    unless asked for the CPU; with no card they raise instead of falling
    back."""
    cfg = mq_yaml_config(tiny=True)
    if torch.cuda.is_available():
        model = PointTransformer(cfg.model, cl=cfg.cl_cfg)
        assert next(model.parameters()).is_cuda
        st = t_engine.init_train_state(model, cfg, SPE)
        assert st.loss_normalizer.is_cuda
        assert all(e.is_cuda for e in st.adapter_ema.values())
        assert t_engine.init_memory_bank(cfg)[0].is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        PointTransformer(cfg.model, cl=cfg.cl_cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        t_engine.init_train_state(
            PointTransformer(cfg.model, device="cpu", cl=cfg.cl_cfg), cfg,
            SPE)
    with pytest.raises((RuntimeError, AssertionError)):
        t_engine.init_memory_bank(cfg)
