"""The L2P prompt pool (vilco_tpu/cl/prompt.py::PromptPool).

Prompts are chosen from a learnable pool by the cosine similarity of the
mean text token to learnable keys and prepended to the text tokens; the
pull term `reduce_sim` goes into the loss (train/engine.py: final -= 0.1 x
reduce_sim once classes are known).

The choice is the JAX module's: each row's top_k keys by similarity, then
a majority vote over the batch (the top_k most chosen pool ids), ties
broken toward the lower id in both steps (`lax.top_k`'s order; a stable
descending sort here, since `torch.topk`'s order for equal values is
unspecified). A given `prompt_mask` (B, top_k) of pool ids replaces the
choice. Parameters are stored unshifted: U(-1, 1) at init.

Under data parallelism (`dp`, parallel/mesh.py::DataParallel) the batch is
the global one, as in JAX's SPMD step: the vote's counts are summed over
the ranks before the top-k, so every rank picks the same prompts, and
`reduce_sim` divides by the global batch size (the ranks' terms add up to
the global mean in the gradient's all-reduce).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from vilco_tpu_torch.ops.masked import l2_normalize


def _top_k_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values along the last axis, equal
    values in ascending index order."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


class PromptPool(nn.Module):
    def __init__(self, pool_size: int = 10, length: int = 20,
                 embed_dim: int = 768, top_k: int = 4):
        super().__init__()
        self.pool_size, self.length, self.top_k = pool_size, length, top_k
        self.prompt = nn.Parameter(torch.zeros(pool_size, length, embed_dim))
        self.prompt_key = nn.Parameter(torch.zeros(pool_size, embed_dim))
        self.uniform_init = 1.0     # models/layers.py::init_weights_

    @property
    def total_prompt_len(self) -> int:
        return self.top_k * self.length

    def forward(self, x, prompt_mask=None, dp=None):
        """x (B, L, C) text tokens; prompt_mask (B, top_k) int or None;
        `dp` a data-parallel rank's place (module docstring) or None.
        Returns (prompted (B, top_k * length + L, C), reduce_sim (0-d: this
        rank's term under `dp`), idx (B, top_k)), in x's dtype."""
        if x.shape[-1] != self.prompt.shape[-1]:
            raise ValueError(f"PromptPool embed_dim={self.prompt.shape[-1]} "
                             f"but the text tokens are {x.shape[-1]}-d")
        B = x.shape[0]
        key_norm = l2_normalize(self.prompt_key.to(x.dtype), 1)
        x_norm = l2_normalize(x.mean(1), 1)
        if prompt_mask is None:
            idx = _top_k_ids(x_norm @ key_norm.T, self.top_k)
            counts = F.one_hot(idx.reshape(-1), self.pool_size).sum(0)
            if dp is not None:
                counts = dp.all_reduce_(counts)
            idx = _top_k_ids(counts, self.top_k)[None].expand(B, -1)
        else:
            idx = prompt_mask.long()
        prompts = self.prompt[idx].to(x.dtype).reshape(
            B, self.total_prompt_len, x.shape[-1])
        n = B if dp is None else B * dp.world
        reduce_sim = (key_norm[idx] * x_norm[:, None, :]).sum() / n
        return torch.cat([prompts, x], 1), reduce_sim, idx
