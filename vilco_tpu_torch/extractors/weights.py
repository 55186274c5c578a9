"""Weights for the extractor towers (extractors/encoders.py).

- `state_from_flax(params)`: HF's Flax params tree of FlaxCLIPVisionModel,
  FlaxCLIPTextModel or FlaxRobertaModel (numpy or JAX arrays) -> the
  tower's state_dict. The module paths are HF's in both frameworks; a
  Dense kernel (in, out) becomes a Linear weight (out, in), the patch
  conv's HWIO kernel OIHW, a LayerNorm scale its weight, an Embed table
  its weight. The q/k/v projections are separate leaves in both
  (`q_proj`/`k_proj`/`v_proj`, `query`/`key`/`value`).
- `load_hf_dir(path, kind=None, device="cuda")`: a tower from a local HF
  model directory: `config.json` and `pytorch_model.bin` (read with
  `torch.load(weights_only=True)`) or `model.safetensors` (parsed here:
  an 8-byte little-endian header length, the JSON header, the raw
  bytes). JAX's extractors read the same directory's
  `flax_model.msgpack` through `from_pretrained`; the port reads its
  torch files, which a HF model directory carries beside it.

A full CLIPModel directory (`model_type` "clip") holds both towers: its
`vision_config` or `text_config` and the `vision_model.` or `text_model.`
keys are taken; a RoBERTa checkpoint's `roberta.` prefix is dropped.
Keys the tower does not have (the MLM head, the CLIP projections, the old
`position_ids` buffers) are left out; a RoBERTa checkpoint without the
pooler (roberta-base's) keeps the tower's own, as HF initialises it.
Nothing is downloaded and no weights come with the repository.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.extractors.encoders import (
    CLIPTextCfg,
    CLIPTextTower,
    CLIPVisionCfg,
    CLIPVisionTower,
    RobertaCfg,
    RobertaTower,
    cfg_from_dict,
)

TOWERS = {"clip_vision": (CLIPVisionCfg, CLIPVisionTower),
          "clip_text": (CLIPTextCfg, CLIPTextTower),
          "roberta": (RobertaCfg, RobertaTower)}
# config.json's model_type -> the tower
MODEL_TYPES = {"clip_vision_model": "clip_vision",
               "clip_text_model": "clip_text", "roberta": "roberta"}
# a CLIPModel directory: the tower's sub-config and key prefix
CLIP_PARTS = {"clip_vision": ("vision_config", "vision_model."),
              "clip_text": ("text_config", "text_model.")}
# safetensors dtype names
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}
# leaves a tower may lack in a checkpoint: HF initialises them afresh
OPTIONAL = ("pooler.",)


def _flat(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.array(v, dtype=np.float32)


def state_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """HF Flax params (a nested dict) -> the tower's state_dict, f32."""
    out = {}
    for path, a in _flat(params):
        head, leaf = path.rsplit(".", 1)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[f"{head}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: tensor} on the CPU."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        b, e = info["data_offsets"]
        dt = SAFETENSORS_DTYPES[info["dtype"]]
        t = torch.frombuffer(bytearray(body[b:e]), dtype=dt) if e > b \
            else torch.empty(0, dtype=dt)
        out[name] = t.reshape(info["shape"])
    return out


def read_hf_dir(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(config.json as a dict, the checkpoint's state_dict) of a local HF
    model directory; pytorch_model.bin first, else model.safetensors."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    binf = os.path.join(path, "pytorch_model.bin")
    stf = os.path.join(path, "model.safetensors")
    if os.path.exists(binf):
        state = torch.load(binf, map_location="cpu", weights_only=True)
    elif os.path.exists(stf):
        state = read_safetensors(stf)
    else:
        raise FileNotFoundError(
            f"{path}: neither pytorch_model.bin nor model.safetensors (the "
            "port reads a HF directory's torch files, not "
            "flax_model.msgpack)")
    return config, state


def _tower_keys(kind: str, config: dict, state: Mapping[str, torch.Tensor]):
    """(the tower's config dict, its keys of `state`)."""
    if config.get("model_type") == "clip":
        sub, prefix = CLIP_PARTS[kind]
        config = config.get(sub) or {}
        state = {k: v for k, v in state.items() if k.startswith(prefix)}
    if kind == "roberta":
        state = {k.removeprefix("roberta."): v for k, v in state.items()}
    # older BERT-family checkpoints name a LayerNorm's leaves gamma, beta
    return config, {k.replace("LayerNorm.gamma", "LayerNorm.weight")
                    .replace("LayerNorm.beta", "LayerNorm.bias"): v
                    for k, v in state.items()}


def load_hf_dir(path: str, kind: str | None = None, device="cuda"):
    """The tower of `kind` ("clip_vision", "clip_text", "roberta"; from
    config.json's model_type when None) with the directory's weights, on
    `device`, in f32."""
    config, state = read_hf_dir(path)
    if kind is None:
        kind = MODEL_TYPES.get(config.get("model_type"))
        if kind is None:
            raise ValueError(f"{path}: model_type "
                             f"{config.get('model_type')!r}: pass kind, one "
                             f"of {sorted(TOWERS)}")
    cfg_cls, tower_cls = TOWERS[kind]
    config, state = _tower_keys(kind, config, state)
    tower = tower_cls(cfg_from_dict(cfg_cls, config), device="cpu")
    own = tower.state_dict()
    missing = [k for k in own if k not in state
               and not k.startswith(OPTIONAL)]
    if missing:
        raise ValueError(f"{path}: the checkpoint lacks {missing[:8]}"
                         f"{' ...' if len(missing) > 8 else ''}")
    with torch.no_grad():
        for k, p in own.items():
            if k in state:
                if tuple(state[k].shape) != tuple(p.shape):
                    raise ValueError(f"{path}: {k} is {tuple(state[k].shape)}"
                                     f", the tower's {tuple(p.shape)}")
                p.copy_(state[k].float())
    return tower.to(device_of(device))
