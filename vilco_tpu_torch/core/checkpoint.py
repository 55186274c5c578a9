"""Checkpoints in the container vilco_tpu/core/checkpoint.py writes, so each
package reads the other's files: a JSON manifest of tagged nodes (dict,
with keys of any of these types; tuple; list; raw scalars and None; array
leaves) plus every array leaf, in one npz (zip) file. No code runs on load
and nothing of JAX, ml_dtypes or orbax is needed: a bf16 leaf is stored as
its uint16 view with `"dt": "bfloat16"` and comes back as a torch.bfloat16
tensor (`Tensor.view`); every other array comes back as numpy. A file that
is not a zip is a legacy pickle, read as such; the orbax layout needs JAX
and is refused.

The episode saves its parameters as the port's flat {name: f32 array}
map. `params_of` also reads a task checkpoint that the JAX package wrote
(a nested Flax tree under "params"), through models/convert.py.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

log = logging.getLogger("vilco.ckpt")


def _array(obj) -> np.ndarray | None:
    """`obj` as a numpy array if it is an array leaf, else None."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj)
    return None


def _encode(obj, arrays: List[np.ndarray]):
    a = _array(obj)
    if a is not None:
        node = {"__t": "arr", "i": len(arrays)}
        if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
            node["dt"] = "bfloat16"
        elif a.dtype.kind == "V":
            raise TypeError(f"checkpoint: array dtype {a.dtype} has no "
                            "npz form")
        arrays.append(a)
        return node
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__t": "raw", "v": obj}
    if isinstance(obj, tuple):
        return {"__t": "tup", "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, list):
        return {"__t": "list", "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"__t": "dict",
                "v": [[_encode(k, arrays), _encode(v, arrays)]
                      for k, v in obj.items()]}
    raise TypeError(
        f"checkpoint: unsupported leaf type {type(obj).__name__}; "
        "convert to arrays / dicts / tuples before saving")


def _decode(node, arrays):
    t = node["__t"]
    if t == "arr":
        a = arrays[node["i"]]
        if "dt" in node:
            if node["dt"] != "bfloat16":
                raise ValueError(f"checkpoint: array dtype {node['dt']!r} "
                                 "is not read by the port")
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return a
    if t == "raw":
        return node["v"]
    if t == "tup":
        return tuple(_decode(x, arrays) for x in node["v"])
    if t == "list":
        return [_decode(x, arrays) for x in node["v"]]
    if t == "dict":
        return {_decode(k, arrays): _decode(v, arrays)
                for k, v in node["v"]}
    raise ValueError(f"checkpoint: unknown node tag {t!r}")


def save_checkpoint(path: str, tree: Dict[str, Any],
                    arrays_format: str = "npz") -> None:
    """Write `tree` to `path` (through a temporary file, renamed at the
    end). Only arrays_format "npz"."""
    if arrays_format != "npz":
        raise ValueError(f"arrays_format {arrays_format!r}: the port writes "
                         "npz only (orbax needs JAX)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: List[np.ndarray] = []
    manifest = _encode(tree, arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __manifest__=np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8),
            **{f"a{i}": a for i, a in enumerate(arrays)})
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":            # not a zip: a legacy pickle checkpoint
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)
    data = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(data["__manifest__"]).decode())
    arrays = {int(k[1:]): data[k] for k in data.files if k != "__manifest__"}
    if not arrays and os.path.isdir(path + ".arrays"):
        raise ValueError(f"{path}: its arrays are in the orbax layout "
                         f"({path}.arrays), which needs JAX")
    return _decode(manifest, arrays)


def _is_flax_tree(tree) -> bool:
    return isinstance(tree, Mapping) and any(
        isinstance(v, Mapping) for v in tree.values())


def params_of(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A checkpoint's params as the port's {name: f32 tensor}: the port's
    flat map as it is, or JAX's nested Flax tree through
    models/convert.py::params_from_jax."""
    from vilco_tpu_torch.models.convert import params_from_jax

    src = tree.get("params", tree)
    if _is_flax_tree(src):
        return params_from_jax(src)
    return {k: torch.as_tensor(np.asarray(v)).float() for k, v in src.items()}


def reg_tasks_of(reg_list) -> list:
    """A checkpoint's EWC/MAS tasks [(importance, optpar), ...] by the
    port's leaf names (JAX's Flax trees through reg_tasks_from_jax)."""
    from vilco_tpu_torch.models.convert import reg_tasks_from_jax

    if reg_list and _is_flax_tree(reg_list[0][0]):
        return reg_tasks_from_jax(reg_list)
    return [tuple({k: torch.as_tensor(np.asarray(v)).float()
                   for k, v in t.items()} for t in task)
            for task in reg_list or []]


@torch.no_grad()
def load_params_into(path: str, model: torch.nn.Module) -> int:
    """Copy a checkpoint's params into `model`'s parameters and persistent
    buffers (the frozen-BN statistics, leaves of JAX's tree) in place
    (their storage, e.g. the optimizer's flat buffer, is kept); a leaf that
    is missing or of another shape keeps its fresh value, as JAX's
    `--init-from` does. Returns the number of leaves loaded."""
    src = params_of(load_checkpoint(path))
    own = model.state_dict(keep_vars=True)
    loaded = 0
    for name, p in own.items():
        cand = src.get(name)
        if cand is not None and tuple(cand.shape) == tuple(p.shape):
            p.copy_(cand.to(p.device, p.dtype))
            loaded += 1
    log.info("init-from %s: %d leaves loaded, %d kept fresh", path, loaded,
             len(own) - loaded)
    return loaded
