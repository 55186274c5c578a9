"""Conv-transformer pyramid backbone, MQ variant with the XL stage
(vilco_tpu/models/backbone.py::ConvTransformerBackbone).

  (conv embed + LN + ReLU) x arch[0] -> + abs PE -> stem TransformerBlock
  x arch[1] -> one XLRelAttention -> branch TransformerBlock x arch[2]
  (stride 2 each)

Returns the (1 + arch[2])-level feature pyramid and its masks; `rng`
switches the blocks' regularisers on (models/layers.py). The text tower
and the cross-attention come in a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from vilco_tpu_torch.core.config import ModelConfig
from vilco_tpu_torch.models.layers import (
    LayerNormC,
    MaskedConv,
    TransformerBlock,
    XLRelAttention,
)
from vilco_tpu_torch.ops.masked import sinusoid_encoding

EMBD_KERNEL_SIZE = 3
XL_D_INNER = 2048


class ConvTransformerBackbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.embd_dim
        n_convs, n_stem, n_branch = (cfg.backbone_arch[0],
                                     cfg.backbone_arch[1],
                                     cfg.backbone_arch[-1])
        cin = cfg.input_dim
        for i in range(n_convs):
            self.add_module(f"embd_{i}", MaskedConv(
                cin, E, EMBD_KERNEL_SIZE, bias=False))
            self.add_module(f"embd_norm_{i}", LayerNormC(E))
            cin = E
        for i in range(n_stem):
            self.add_module(f"stem_{i}", TransformerBlock(E, cfg.n_head))
        self.xl_0 = XLRelAttention(E, cfg.n_head, XL_D_INNER)
        for i in range(n_branch):
            self.add_module(f"branch_{i}", TransformerBlock(
                E, cfg.n_head, n_ds_stride=2))
        pe = sinusoid_encoding(cfg.max_seq_len, E) / E ** 0.5
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        self.n_convs, self.n_stem, self.n_branch = n_convs, n_stem, n_branch

    def forward(self, x, mask, rng=None):
        T = x.shape[1]
        if T > self.cfg.max_seq_len:
            raise ValueError(f"T={T} exceeds max_seq_len="
                             f"{self.cfg.max_seq_len}")
        for i in range(self.n_convs):
            x, mask = getattr(self, f"embd_{i}")(x, mask)
            x = torch.relu(getattr(self, f"embd_norm_{i}")(x))
        x = x + self.pe[None, :T].to(x.dtype) * mask[..., None].to(x.dtype)
        for i in range(self.n_stem):
            x, mask = getattr(self, f"stem_{i}")(x, mask, rng)
        feats, masks = [x], [mask]
        x = self.xl_0(x, mask, rng)
        for i in range(self.n_branch):
            x, mask = getattr(self, f"branch_{i}")(x, mask, rng)
            feats.append(x)
            masks.append(mask)
        return feats, masks
