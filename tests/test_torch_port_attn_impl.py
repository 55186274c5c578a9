"""The port's `flash` and `pallas_naive` attention paths, its ViT on the
flash kernel, and the VQ attention probe's variants, against the JAX
package on the CPU.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode: JAX's own TPU flash-attention kernels
(`flash_attention_jax`, and its gradient) and the probe's `run_variant`
under `force_tpu_interpret_mode()`, `fused_attention` with
`interpret=True`. Inputs are made with numpy, ragged key masks with one
fully masked row (the flash kernel averages v there, the others give 0).
Tolerances: each kernel's output and gradients 1e-5 x max(1, max|ref|)
(f32 on both sides, the softmax summed in another order); the modules and
the tiny models 1e-4 (the model tests' tolerance: f32, but ~10 layers of
matmuls, norms and softmaxes summed in another order). Runs in about a
minute, most of it the interpreted flash kernels.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from tests._torch_threads import torch_one_thread  # noqa: F401
import vilco_tpu.kernels.attention as j_attn
import vilco_tpu.models.backbone as j_backbone
from __graft_entry__ import _flagship_cfg
from tools import probe_vq_attn
from vilco_tpu.data.synthetic import make_batch as j_make_batch
from vilco_tpu.models import layers as j_layers
from vilco_tpu.models.point_transformer import PointTransformer as JPT
from vilco_tpu.models.vit import ViT as JViT
from vilco_tpu.train import engine as j_engine
from vilco_tpu_torch.core.config import (
    ModelConfig,
    VQConfig,
    flagship_config,
)
from vilco_tpu_torch.kernels import attention as t_attn
from vilco_tpu_torch.models import layers as t_layers
from vilco_tpu_torch.models.convert import load_jax_params, params_from_jax
from vilco_tpu_torch.models.point_transformer import (
    PointTransformer,
    level_lengths,
)
from vilco_tpu_torch.models.vit import ViT
from vilco_tpu_torch.ops.assign import generate_points
from vilco_tpu_torch.train import engine as t_engine

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _mask(rng, B, T):
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[-1] = 0                       # one fully masked row
    return np.arange(T)[None, :] < lens[:, None]


def _close(got, ref, tol=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (what, err)


def _port_grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("impl", ["flash", "pallas_naive"])
@pytest.mark.parametrize("T", [64, 128, 256])
def test_attention_impls_match_jax(impl, T):
    """K1f's and K1n's plain versions (the wrappers on CPU tensors; T=64
    takes K1, as JAX takes XLA) against the Pallas kernels: forward and
    jax.vjp."""
    rng = np.random.default_rng(T)
    B, H, D = 3, 2, 32
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = _mask(rng, B, T)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if impl == "flash":
        jfn = lambda a, b, c: j_attn.flash_attention_jax(a, b, c, jm)
        tfn, plain = t_attn.flash_attention, t_attn.flash_attention_plain
    else:
        jfn = lambda a, b, c: j_attn.fused_attention(a, b, c, jm, True)
        tfn, plain = t_attn.fused_attention, t_attn.fused_attention_plain
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        refs = vjp(jnp.asarray(g))
    out, grads = _port_grads(lambda a, b, c: tfn(a, b, c, tm), (q, k, v), g)
    _close(out, ref, what="out")
    for name, got, want in zip("qkv", grads, refs):
        _close(got, want, what=f"d{name}")
    args = [torch.from_numpy(x) for x in (q, k, v)] + [tm]
    assert torch.equal(tfn(*args), plain(*args))
    fully_masked = out[-1]
    if impl == "flash" and T >= 128:      # the library's -0.7 * FLT_MAX
        _close(fully_masked, np.broadcast_to(v[-1].mean(0), (T, H, D)))
    else:
        assert np.all(fully_masked == 0)


@pytest.mark.parametrize("bound_shift,mxu_sum", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_probe_variants_match_run_variant(bound_shift, mxu_sum):
    """P2's plain version against tools/probe_vq_attn.py::run_variant (two
    heads of the probe's D=64) in interpret mode."""
    rng = np.random.default_rng(5)
    B, T, C = 2, 256, 128
    q, k, v = (rng.standard_normal((B, T, C)).astype(np.float32) * 2.0
               for _ in range(3))
    mask = _mask(rng, B, T)
    with pltpu.force_tpu_interpret_mode():
        ref = probe_vq_attn.run_variant(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(mask),
            bound_shift=bound_shift, mxu_sum=mxu_sum)
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    out = t_attn.probe_variant(*args, C // probe_vq_attn.D, bound_shift,
                               mxu_sum)
    _close(out.numpy(), ref, what="probe")
    assert np.all(out[-1].numpy() == 0)
    assert torch.equal(out, t_attn.probe_variant_plain(
        *args, C // probe_vq_attn.D, bound_shift, mxu_sum))


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


@pytest.mark.parametrize("impl", ["flash", "pallas_naive"])
@pytest.mark.parametrize("stride", [1, 2])
def test_masked_mhca_impls_match_jax(impl, stride):
    """MaskedMHCA with `attention_impl` against JAX's, the attention at
    T=128 after the stride."""
    rng = np.random.default_rng(stride)
    B, T, E, H = 2, 128 * stride, 64, 4
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, T // 2 + 3])[:, None]
    jmod = lambda impl: j_layers.MaskedMHCA(
        E, H, n_qx_stride=stride, n_kv_stride=stride, attention_impl=impl)
    # the attention holds no parameters: the XLA form's tree is the same
    params = _perturbed(jmod("xla").init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"],
        stride)
    with pltpu.force_tpu_interpret_mode():
        ref, ref_m = jmod(impl).apply({"params": params}, jnp.asarray(x),
                                      jnp.asarray(mask))
    tmod = t_layers.MaskedMHCA(E, H, stride=stride, attention_impl=impl)
    load_jax_params(tmod, params)
    with torch.no_grad():
        out, out_m = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def _tiny_256(impl):
    """The tiny MQ twin at max_seq_len 256 (levels 256, 128, 64, 32: the
    stem and the first branch block reach the kernels), f32."""
    cfg = _flagship_cfg(tiny=True)
    cfg = cfg.updated(dataset=dataclasses.replace(cfg.dataset,
                                                  max_seq_len=256))
    return cfg.updated(model=cfg.model.updated(
        use_xl=True, compute_dtype="float32", max_seq_len=256,
        attention_impl=impl))


def _port_model(jcfg, params):
    cfg = ModelConfig(**{f.name: getattr(jcfg.model, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    model = PointTransformer(cfg, device="cpu")
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def tiny_mq():
    """Perturbed parameters of the tiny twin at T=256 and one batch."""
    jcfg = _tiny_256("flash")
    batch = j_make_batch(np.random.default_rng(3), 2, jcfg)
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batch["feats"]),
                                  jnp.asarray(batch["mask"]))["params"]
    return _perturbed(params, 7, scale=0.02), batch


@pytest.mark.parametrize("impl", ["flash", "pallas_naive"])
def test_point_transformer_impls_match_jax(tiny_mq, monkeypatch, impl):
    """The tiny MQ model under `attention_impl` (JAX's off-TPU override of
    `_attn_impl` lifted) against the JAX model: the head outputs."""
    monkeypatch.setattr(j_backbone, "_attn_impl",
                        lambda cfg: cfg.attention_impl)
    params, batch = tiny_mq
    jcfg = _tiny_256(impl)
    assert batch["feats"].shape[1] == 256
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(JPT(jcfg.model, jcfg.cl_cfg).apply)(
            {"params": params}, jnp.asarray(batch["feats"]),
            jnp.asarray(batch["mask"]))
    model = _port_model(jcfg, params).eval()
    assert model.cfg.attention_impl == impl
    with torch.no_grad():
        out = model(torch.from_numpy(batch["feats"]),
                    torch.from_numpy(batch["mask"]))
    for key in ("cls_logits", "offsets"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **MODEL_TOL)


def test_flash_train_step_gradients_match_jax(tiny_mq, monkeypatch):
    """One train step's loss and every gradient leaf of the tiny MQ model
    under `attention_impl="flash"` (regularisers off), against
    jax.value_and_grad through the library kernel's backward."""
    monkeypatch.setattr(j_backbone, "_attn_impl",
                        lambda cfg: cfg.attention_impl)
    params, batch = tiny_mq
    jcfg = _tiny_256("flash")
    jmodel = JPT(jcfg.model, jcfg.cl_cfg)
    pts = generate_points(level_lengths(_port_model(jcfg, params).cfg),
                          jcfg.model.fpn_strides,
                          jcfg.model.regression_range)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cl = j_engine.CLBatchExtras(
        class_mask=jnp.ones((jcfg.model.num_classes,), bool))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jb["feats"], jb["mask"])
        return j_engine.compute_losses(out, jb, jnp.asarray(pts), jcfg, cl,
                                       jnp.asarray(100.0), "naive", 0)[0]

    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port_model(jcfg, params)
    tb = t_engine.batch_to(batch, "cpu")
    out = model(tb["feats"], tb["mask"])
    cl = t_engine.CLBatchExtras(
        torch.ones(jcfg.model.num_classes, dtype=torch.bool))
    loss, _, _ = t_engine.compute_losses(out, tb, torch.from_numpy(pts), cl,
                                         torch.tensor(100.0),
                                         flagship_config().train_cfg)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    # per leaf against its largest value, floored at 1e-4 of the largest
    # gradient (the key biases' exact gradient is 0: both sides hold f32
    # roundoff there)
    floor = 1e-4 * max(np.abs(w.numpy()).max() for w in want.values())
    worst = {n: np.abs(got[n] - want[n].numpy()).max()
             / max(np.abs(want[n].numpy()).max(), floor) for n in want}
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


def test_vit_flash_matches_jax():
    """The tiny ViT with attn_impl="flash" on 96-square images (145
    tokens, so the flash kernel runs) against JAX's ViT(use_fused=True,
    attn_impl="flash"), which pads to 256 tokens and masks the pad keys."""
    S, P, dim, depth, heads = 96, 8, 48, 2, 4
    x = np.random.default_rng(9).random((2, S, S, 3), np.float32)
    params = _perturbed(jax.jit(JViT(P, dim, depth, heads).init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2, scale=0.02)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(JViT(P, dim, depth, heads, use_fused=True,
                           attn_impl="flash").apply)({"params": params},
                                                     jnp.asarray(x))
    vit = ViT(P, dim, depth, heads, S, attn_impl="flash")
    load_jax_params(vit, params)
    with torch.no_grad():
        out = vit(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_impl_switches_are_checked():
    assert ModelConfig().attention_impl == "xla"
    assert VQConfig().vit_attn_impl == "pallas"
    for impl in ("xla", "flash", "pallas_naive"):
        assert ModelConfig(attention_impl=impl).attention_impl == impl
    with pytest.raises(ValueError):
        ModelConfig(attention_impl="sdpa")
    with pytest.raises(ValueError):
        VQConfig(vit_attn_impl="xla")
    with pytest.raises(ValueError):
        t_attn.flash_attention(*(torch.zeros(1, 128, 2, 8),) * 2,
                               torch.zeros(1, 64, 2, 8),
                               torch.ones(1, 64, dtype=torch.bool))
