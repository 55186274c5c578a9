"""Load a JAX/Flax parameter tree of the MQ, NLQ or VQ model into the port,
and map gradient trees and AdamW state the same way.

The port names its parameters after the Flax paths
(`backbone.stem_0.attn.query_conv.weight` for
`params["backbone"]["stem_0"]["attn"]["query_conv"]["kernel"]`), so the map
is a rename of the leaf plus a layout change:

  Dense kernel (Cin, Cout)            -> Linear weight (Cout, Cin)
  MaskedConv kernel (K, Cin/g, Cout)  -> Conv1d weight (Cout, Cin/g, K)
  nn.Conv kernel (kh, kw, Cin, Cout)  -> Conv2d weight (Cout, Cin, kh, kw)
  nn.ConvTranspose kernel (kh, kw, Cin, Cout), a module named up_<i>
                                      -> ConvTranspose2d weight (Cin, Cout,
                                         kh, kw), flipped in both spatial
                                         axes (Flax's transposed conv
                                         correlates with the kernel as it
                                         is, PyTorch's with it flipped)
  nn.LayerNorm / nn.GroupNorm scale (C,) -> weight (C,)
  everything else (LayerNormC weight/bias, biases, the XL q/k/v/r/o
  (C, H, D) and r_w/r_r biases, AffineDropPath and Scale `scale`, the
  class Gaussians, the ViT's cls_token and pos_embed, the ClipMatcher's
  pe_3d, the L2P `prompt` and `prompt_key`, unshifted)
                                      -> kept as it is

The time adapters' Dense kernels (t_in, 5 t_in) and (5 t_in, t_in / 2) act
on the time axis; they map as any Dense kernel, and the port's TimeAdapter
applies its Linear layers to the transposed input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def port_name(path, ndim: int) -> str:
    """The port's parameter name for the Flax leaf at `path` (a tuple of
    keys) whose parameter has rank `ndim`."""
    *mods, name = path
    if name == "kernel" and ndim in (2, 3, 4):
        name = "weight"
    elif name == "kernel":
        raise ValueError(f"{'/'.join(path)}: kernel of rank {ndim}")
    elif name == "scale" and ndim == 1:
        name = "weight"
    return ".".join([*mods, name])


def _transposed_conv(path) -> bool:
    return len(path) >= 2 and path[-2].startswith("up_")


def _layout(path, a: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return a
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 4 and _transposed_conv(path):
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays, e.g. numpy) -> a state_dict
    in the port's names and layouts, in f32. Every leaf is mapped. A tree
    of the same structure (gradients, AdamW moments) maps the same way."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(flax_params):
        a = np.asarray(leaf).astype(np.float32)
        key = port_name(path, a.ndim)
        if key in out:
            raise ValueError(f"two Flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(_layout(path, a), order="C"))
    return out


def reg_tasks_from_jax(reg_list) -> List[Tuple[Dict[str, torch.Tensor],
                                               Dict[str, torch.Tensor]]]:
    """JAX's per-task EWC/MAS state, [(importance, optpar), ...] as
    vilco_tpu/cl/regularizers.py::estimate_importance returns each task's
    trees, -> the same list in the port's names and layouts, one task at a
    time. The layout changes are permutations, so an elementwise product
    of importance and optpar maps to the same product. JAX stacks the
    tasks along a leading axis (stack_reg_tasks), which `params_from_jax`
    would read as a kernel's axes: stack on the port's side instead
    (vilco_tpu_torch/cl/regularizers.py::stack_reg_tasks)."""
    return [(params_from_jax(imp), params_from_jax(opt))
            for imp, opt in reg_list]


def adapter_ema_from_jax(ema: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's time-adapter EMA, keyed by Flax path ('backbone/branch_0/
    adapter/fc1/kernel': vilco_tpu/train/engine.py::init_adapter_ema) ->
    {port name: f32 tensor}, the port's TrainState.adapter_ema."""
    tree: Dict[str, Any] = {}
    for path, v in ema.items():
        *mods, leaf = path.split("/")
        d = tree
        for k in mods:
            d = d.setdefault(k, {})
        d[leaf] = np.asarray(v)
    return params_from_jax(tree)


def adam_state_from_jax(count, mu: Mapping[str, Any],
                        nu: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX AdamW state (the step count and the canonical mu and nu trees,
    e.g. `PackedAdamState.count/.mu/.nu` as numpy) -> {"count": int,
    "mu": {name: f32 tensor}, "nu": {name: f32 tensor}} in the port's
    names and layouts; bf16 moments widen to f32 exactly."""
    return {"count": int(np.asarray(count)), "mu": params_from_jax(mu),
            "nu": params_from_jax(nu)}


def load_jax_params(model: nn.Module, flax_params: Mapping[str, Any]) -> None:
    """Load Flax params into `model`, strictly: every Flax leaf must land on
    a port parameter of the same shape and every port parameter must be
    filled. Raises with the names that do not match."""
    sd = params_from_jax(flax_params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = [f"{k}: jax {tuple(sd[k].shape)} vs port {tuple(own[k].shape)}"
              for k in sorted(set(sd) & set(own))
              if sd[k].shape != own[k].shape]
    if missing or unexpected or shapes:
        raise ValueError(
            f"parameter trees differ: missing {missing}, unexpected "
            f"{unexpected}, shape mismatches {shapes}")
    model.load_state_dict(sd, strict=True)
