"""The three text and image towers of the feature extractors, in plain
PyTorch, with the math of HuggingFace's Flax models that
vilco_tpu/extractors/ drives (transformers' modeling_flax_clip.py and
modeling_flax_roberta.py):

- `CLIPVisionTower` (FlaxCLIPVisionModel): a patch conv with no bias, the
  class embedding, the position embedding, `pre_layrnorm`, pre-LN blocks
  with quick-GELU; `pooler_output = post_layernorm(h[:, 0])`.
- `CLIPTextTower` (FlaxCLIPTextModel): token and position embeddings
  (positions `arange(L)`), the same blocks under a causal mask and the
  padding mask, `final_layer_norm`; `pooler_output` at the eos token.
- `RobertaTower` (FlaxRobertaModel): word, position and token-type (0)
  embeddings with a LayerNorm, post-LN blocks with exact GELU, a tanh
  pooler on the first token. Position ids follow the input ids, not the
  mask: `cumsum(ids != pad) * (ids != pad) + pad`
  (`create_position_ids_from_input_ids`), so ids that never equal the pad
  id (the hash tokenizer's) count every position, pads too.

Module and parameter names are HuggingFace's PyTorch ones, so a
`pytorch_model.bin` or `model.safetensors` of the same model loads as it
is (extractors/weights.py).

The vision and RoBERTa self-attention run K1 (`fused_attention_blc`,
csrc/attention_blc.cu) on a CUDA tensor, its plain version on a CPU one.
HF adds `finfo(f32).min` to a masked key's score: a row with no valid key
then scores every key alike and gets the mean of v over all keys, where K1
gives 0, so such rows (a text with no token) take that mean here. CLIP's
text attention is causal, which K1 has no mask for; it stays plain torch,
as HF computes it, and so do the GEMMs and the MLPs (quick-GELU and exact
GELU, where K7 is tanh-GELU).

Each tower draws its parameters in f32 from a seeded CPU
`torch.Generator` (seed 0 if none) and places them on `device`, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.kernels.attention import fused_attention_blc

INIT_STD = 0.02


@dataclass(frozen=True)
class CLIPVisionCfg:
    """transformers' CLIPVisionConfig: its fields the tower reads, at its
    defaults (ViT-B/32)."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class CLIPTextCfg:
    """transformers' CLIPTextConfig, at its defaults (ViT-B's text
    tower)."""
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 49406
    eos_token_id: int = 49407


@dataclass(frozen=True)
class RobertaCfg:
    """transformers' RobertaConfig, at its defaults; `roberta_base()` is
    roberta-base's config.json."""
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1


def roberta_base() -> RobertaCfg:
    """roberta-base's published config: 514 positions, one token type, LN
    eps 1e-5."""
    return RobertaCfg(max_position_embeddings=514, type_vocab_size=1,
                      layer_norm_eps=1e-5)


def cfg_from_dict(cls, d: Mapping[str, Any]):
    """A tower config from a config.json dict: the fields `cls` knows,
    the others ignored (as the HF config keeps them and the tower does
    not read them)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def attention_k1(q, k, v, mask, heads: int):
    """Self-attention of channels-last q/k/v (B, L, C) over the keys of
    `mask` (B, L) through K1, with HF's answer for a row with no valid key:
    the mean of v over all L keys."""
    out = fused_attention_blc(q, k, v, mask, heads)
    empty = ~mask.any(1)
    return torch.where(empty[:, None, None], v.mean(1, keepdim=True), out)


def attention_plain(q, k, v, allowed, heads: int):
    """HF's attention in plain torch: q / sqrt(D), q k^T, finfo.min added
    where `allowed` (B, 1 or H, Lq, Lk) is False, softmax, p v."""
    B, Lq, C = q.shape
    D = C // heads
    split = lambda x: x.view(x.shape[0], x.shape[1], heads, D)
    s = torch.einsum("bqhd,bkhd->bhqk", split(q) / math.sqrt(D), split(k))
    s = s + torch.where(allowed, 0.0, torch.finfo(s.dtype).min).to(s.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, split(v)).reshape(B, Lq, C)


class CLIPAttention(nn.Module):
    def __init__(self, C: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.q_proj, self.k_proj = nn.Linear(C, C), nn.Linear(C, C)
        self.v_proj, self.out_proj = nn.Linear(C, C), nn.Linear(C, C)

    def forward(self, x, mask):
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.causal:
            L = x.shape[1]
            tril = torch.ones((L, L), dtype=torch.bool,
                              device=x.device).tril()
            out = attention_plain(q, k, v, mask[:, None, None, :] & tril,
                                  self.heads)
        else:
            out = attention_k1(q, k, v, mask, self.heads)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, C: int, hidden: int, act: str):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1, self.fc2 = nn.Linear(C, hidden), nn.Linear(hidden, C)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg, causal: bool):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(C, cfg.num_attention_heads, causal)
        self.layer_norm1 = nn.LayerNorm(C, eps=eps)
        self.mlp = CLIPMLP(C, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(C, eps=eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg):
        super().__init__()
        C, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(C))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, C, p, stride=p,
                                         bias=False)
        self.position_embedding = nn.Embedding(
            (cfg.image_size // p) ** 2 + 1, C)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], 1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg):
        super().__init__()
        C, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(C, eps=eps)
        self.encoder = CLIPEncoder(cfg, causal=False)
        self.post_layernorm = nn.LayerNorm(C, eps=eps)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextCfg):
        super().__init__()
        C = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, C)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               C)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextCfg):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg, causal=True)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


def init_tower_(model: nn.Module, generator: torch.Generator) -> None:
    """Every weight, embedding and the class embedding from N(0, 0.02^2),
    biases 0, LayerNorms 1 and 0, drawn in f32 on the CPU in the order of
    `named_parameters`."""
    norms = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm)
             for p in m.parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif id(p) in norms:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * INIT_STD)


class _Tower(nn.Module):
    def _place(self, generator, device) -> None:
        init_tower_(self, generator if generator is not None
                    else torch.Generator().manual_seed(0))
        self.to(device_of(device))


class CLIPVisionTower(_Tower):
    """FlaxCLIPVisionModel's forward: pixels (B, 3, H, W) f32 (as HF takes
    them: the extractor passes frames unnormalised, as JAX's does) ->
    {"last_hidden_state" (B, 1 + patches, C), "pooler_output" (B, C)}."""

    def __init__(self, cfg: CLIPVisionCfg = CLIPVisionCfg(), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self._place(generator, device)

    def forward(self, pixel_values) -> Dict[str, torch.Tensor]:
        vm = self.vision_model
        h = vm.pre_layrnorm(vm.embeddings(pixel_values))
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
        h = vm.encoder(h, mask)
        return {"last_hidden_state": h,
                "pooler_output": vm.post_layernorm(h[:, 0])}


class CLIPTextTower(_Tower):
    """FlaxCLIPTextModel's forward: input_ids (B, L) and attention_mask
    (B, L) -> {"last_hidden_state" (B, L, C) after final_layer_norm,
    "pooler_output" (B, C) at the eos token (HF's rule: the largest id
    where eos_token_id is 2, else the first eos id, row 0 of none)}."""

    def __init__(self, cfg: CLIPTextCfg = CLIPTextCfg(), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        self._place(generator, device)

    def forward(self, input_ids, attention_mask) -> Dict[str, torch.Tensor]:
        tm = self.text_model
        L = input_ids.shape[1]
        h = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding.weight[:L]
        h = tm.final_layer_norm(tm.encoder(h, attention_mask.bool()))
        if self.cfg.eos_token_id == 2:
            at = input_ids.argmax(-1)
        else:
            at = (input_ids == self.cfg.eos_token_id).int().argmax(-1)
        rows = torch.arange(h.shape[0], device=h.device)
        return {"last_hidden_state": h, "pooler_output": h[rows, at]}


class RobertaSelfAttention(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.query, self.key = nn.Linear(C, C), nn.Linear(C, C)
        self.value = nn.Linear(C, C)


class RobertaDenseNorm(nn.Module):
    """`dense` then LayerNorm(dense(x) + residual): HF's SelfOutput and
    Output."""

    def __init__(self, cin: int, C: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(cin, C)
        self.LayerNorm = nn.LayerNorm(C, eps=eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class RobertaAttention(nn.Module):
    def __init__(self, cfg: RobertaCfg):
        super().__init__()
        C = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        # HF's name, which the checkpoints carry
        self.self = RobertaSelfAttention(C)
        self.output = RobertaDenseNorm(C, C, cfg.layer_norm_eps)

    def forward(self, x, mask):
        a = self.self
        out = attention_k1(a.query(x), a.key(x), a.value(x), mask,
                           self.heads)
        return self.output(out, x)


class RobertaIntermediate(nn.Module):
    def __init__(self, cfg: RobertaCfg):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


class RobertaLayer(nn.Module):
    """Post-LN: x = LN(x + attn(x)), then LN(x + mlp(x))."""

    def __init__(self, cfg: RobertaCfg):
        super().__init__()
        self.attention = RobertaAttention(cfg)
        self.intermediate = RobertaIntermediate(cfg)
        self.output = RobertaDenseNorm(cfg.intermediate_size,
                                       cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = self.attention(x, mask)
        return self.output(self.intermediate(x), x)


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: RobertaCfg):
        super().__init__()
        C = cfg.hidden_size
        self.pad = cfg.pad_token_id
        self.word_embeddings = nn.Embedding(cfg.vocab_size, C)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                C)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, C)
        self.LayerNorm = nn.LayerNorm(C, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        real = (input_ids != self.pad).long()
        pos = torch.cumsum(real, 1) * real + self.pad
        h = self.word_embeddings(input_ids) \
            + self.token_type_embeddings.weight[0] \
            + self.position_embeddings(pos)
        return self.LayerNorm(h)


class RobertaEncoder(nn.Module):
    def __init__(self, cfg: RobertaCfg):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class RobertaPooler(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.dense = nn.Linear(C, C)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class RobertaTower(_Tower):
    """FlaxRobertaModel's forward (token type 0, positions from the ids):
    input_ids (B, L) and attention_mask (B, L) -> {"last_hidden_state"
    (B, L, C), "pooler_output" (B, C)}."""

    def __init__(self, cfg: RobertaCfg = RobertaCfg(), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = RobertaEmbeddings(cfg)
        self.encoder = RobertaEncoder(cfg)
        self.pooler = RobertaPooler(cfg.hidden_size)
        self._place(generator, device)

    def forward(self, input_ids, attention_mask) -> Dict[str, torch.Tensor]:
        h = self.embeddings(input_ids)
        mask = attention_mask.bool()
        for layer in self.encoder.layer:
            h = layer(h, mask)
        return {"last_hidden_state": h, "pooler_output": self.pooler(h)}
