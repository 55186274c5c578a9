"""The VQ tracker's Vision Transformer (vilco_tpu/models/vit.py): a pre-LN
ViT with DINO's parameter layout, returning the patch-token grid with the
CLS token dropped and the final LayerNorm applied.

Attention runs through kernels/attention.py with every key valid: the
channels-last kernel K1 (`attn_impl="pallas"`) or the flash kernel K1f
(`"flash"`). The JAX model pads the token axis to a multiple of 128 for its
TPU grid and masks the pad keys; the port's kernels take any length, and on
the valid tokens that is the same function, so there is no pad.
`use_fused_mlp` runs each block's MLP through kernels/mlp.py; otherwise it
is Linear, tanh GELU, Linear in the compute dtype. Images and grids are
channels-last (B, H, W, C), as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vilco_tpu_torch.core.config import VIT_ATTN_IMPLS
from vilco_tpu_torch.kernels.attention import (
    flash_attention,
    fused_attention_blc,
)
from vilco_tpu_torch.kernels.mlp import fused_mlp
from vilco_tpu_torch.models.layers import LayerNorm, Linear
from vilco_tpu_torch.ops import activations

LN_EPS = 1e-6        # Flax's LayerNorm and GroupNorm epsilon


def same_padding(n: int, k: int, s: int):
    """Flax/XLA 'SAME' padding (low, high) of one spatial axis: the output
    is ceil(n / s) and the low side gets the smaller half."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Conv2d on NCHW inputs with Flax's 'SAME' padding (a stride-2 3x3 conv
    of an even input pads (0, 1), not (1, 1)); the parameters are cast to
    the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1):
        super().__init__(cin, cout, kernel_size, stride)

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = same_padding(x.shape[2], kh, sh)
        pw = same_padding(x.shape[3], kw, sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_fused_mlp: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        if attn_impl not in VIT_ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r}: one of "
                             f"{VIT_ATTN_IMPLS}")
        self.num_heads = num_heads
        self.use_fused_mlp = use_fused_mlp
        self.attn_impl = attn_impl
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, kv_mask):
        B, L, C = x.shape
        h = self.norm1(x)
        w, b = self.qkv.weight.to(h.dtype), self.qkv.bias.to(h.dtype)
        q, k, v = (F.linear(h, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
                   for i in range(3))
        if self.attn_impl == "flash":
            heads = lambda t: t.view(B, L, self.num_heads, -1)
            out = flash_attention(heads(q), heads(k), heads(v),
                                  kv_mask).reshape(B, L, C)
        else:
            out = fused_attention_blc(q, k, v, kv_mask, self.num_heads)
        x = x + self.proj(out)
        h = self.norm2(x)
        if self.use_fused_mlp and not activations._EXACT:
            h = fused_mlp(h, self.fc1.weight.t(), self.fc1.bias,
                          self.fc2.weight.t(), self.fc2.bias)
        else:
            h = self.fc2(activations.gelu(self.fc1(h)))
        return x + h


class ViT(nn.Module):
    """images (B, H, W, 3) of side `image_size` -> patch tokens (B, H/p,
    W/p, dim); pos_embed holds (H/p)^2 + 1 positions, as the JAX model
    builds it from its init image. `attn_impl` "pallas" (K1) or "flash"
    (K1f)."""

    def __init__(self, patch_size: int = 14, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, image_size: int = 448,
                 use_fused_mlp: bool = False, attn_impl: str = "pallas"):
        super().__init__()
        self.dim = dim
        self.patch_embed = Conv2dSame(3, dim, patch_size, patch_size)
        grid = -(-image_size // patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(
                dim, num_heads, use_fused_mlp=use_fused_mlp,
                attn_impl=attn_impl))
        self.depth = depth
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, images):
        B = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        hh, ww = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)                      # (B, hh*ww, C)
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.dim)
        x = torch.cat([cls, x], 1) + self.pos_embed.to(x.dtype)
        kv_mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, kv_mask)
        x = self.norm(x)
        return x[:, 1:].reshape(B, hh, ww, self.dim)


# timm / DINO / DINOv2 names of a block's leaves -> the port's
_BLOCK_KEYS = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
               "attn.qkv.weight": "qkv.weight", "attn.qkv.bias": "qkv.bias",
               "attn.proj.weight": "proj.weight",
               "attn.proj.bias": "proj.bias",
               "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
               "mlp.fc1.weight": "fc1.weight", "mlp.fc1.bias": "fc1.bias",
               "mlp.fc2.weight": "fc2.weight", "mlp.fc2.bias": "fc2.bias"}


@torch.no_grad()
def load_torch_vit_checkpoint(vit: ViT, ckpt_path: str) -> None:
    """Load DINO / DINOv2 / MAE ViT weights from a torch checkpoint into
    `vit` in place (vilco_tpu/models/vit.py::load_torch_vit_checkpoint; the
    reference torch.hub-loads these, so the file must be on disk): the
    timm naming patch_embed.proj, cls_token, pos_embed, blocks.N.{norm1,
    attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm, a state_dict or
    one under "model". Torch's layouts are the port's, so the map is a
    rename. Every leaf of `vit` must be found at its shape, else it raises
    naming the key; the checkpoint's other keys (DINOv2's LayerScale and
    mask token) are not read, as in JAX."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    src = {"patch_embed.weight": "patch_embed.proj.weight",
           "patch_embed.bias": "patch_embed.proj.bias",
           "cls_token": "cls_token", "pos_embed": "pos_embed",
           "norm.weight": "norm.weight", "norm.bias": "norm.bias"}
    for i in range(vit.depth):
        for theirs, ours in _BLOCK_KEYS.items():
            src[f"block_{i}.{ours}"] = f"blocks.{i}.{theirs}"
    own = dict(vit.named_parameters())
    if set(own) != set(src):
        raise ValueError(f"ViT leaves without a checkpoint key: "
                         f"{sorted(set(own) - set(src))}")
    for name, key in src.items():
        if key not in sd:
            raise KeyError(f"{ckpt_path}: no {key!r} for the ViT's {name}")
        val = torch.as_tensor(sd[key])
        if tuple(val.shape) != tuple(own[name].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)}, the ViT's "
                             f"{name} is {tuple(own[name].shape)}")
        own[name].copy_(val.to(own[name].device, own[name].dtype))
