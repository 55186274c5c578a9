"""CLIP text and RoBERTa token features of queries (vilco_tpu/extractors/
clip_text.py): texts in batches through the CLIP text tower or RoBERTa
(extractors/encoders.py; K1 in RoBERTa's attention on the card), each
text's token features cut to its length, written as one .npz per query
with `token_features` (L, D) and `features` (their mean), the format the
NLQ lmdb loader reads back.

  python -m vilco_tpu_torch.extractors.clip_text --input-jsonl q.jsonl \\
      --out-dir feats/ [--extractor clip|roberta] [--model-path DIR] \\
      [--batch-size 64] [--device cpu]

`--model-path` is a local HF directory with its torch files (config.json,
pytorch_model.bin or model.safetensors, vocab.json and merges.txt;
extractors/weights.py, extractors/tokenizers.py); without one, JAX's
random-init towers from seed 0 of torch's generator (CLIP text: vocab
1000, 512 wide, 4 layers, 8 heads; RoBERTa: vocab 1000, 256 wide, 2
layers, 4 heads) and JAX's hash tokenizer, for pipeline runs. The towers
run on the card (`--device`), which raises where there is none. JAX pads
the last batch with "" to a static shape; the rows are independent, so
the port runs it as it is and writes the same features.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from vilco_tpu_torch.cl.episode import device_of
from vilco_tpu_torch.extractors.encoders import (
    CLIPTextCfg,
    CLIPTextTower,
    RobertaCfg,
    RobertaTower,
)
from vilco_tpu_torch.extractors.tokenizers import BPETokenizer, hash_tokenize


class _TokenExtractor:
    """The batching shared by both extractors: `self.model(ids, mask)`,
    `self.tokenizer` (None: the hash tokenizer), `max_length`,
    `batch_size`, `device`."""

    def _tokenize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if self.tokenizer is not None:
            return self.tokenizer(texts, self.max_length)
        return hash_tokenize(texts, self.max_length)

    @torch.no_grad()
    def extract(self, texts: List[str]) -> List[np.ndarray]:
        """Token features per text, truncated to each text's real length
        (at least 1)."""
        out: List[np.ndarray] = []
        for s in range(0, len(texts), self.batch_size):
            ids, mask = self._tokenize(texts[s:s + self.batch_size])
            feats = self.model(
                torch.from_numpy(ids).long().to(self.device),
                torch.from_numpy(mask).to(self.device)
            )["last_hidden_state"].float().cpu().numpy()
            for i in range(len(ids)):
                out.append(feats[i, :int(mask[i].sum()) or 1])
        return out


class ClipTextExtractor(_TokenExtractor):
    def __init__(self, model_path: Optional[str] = None,
                 max_length: int = 77, batch_size: int = 64,
                 hidden: int = 512, layers: int = 4, device="cuda"):
        self.max_length = max_length
        self.batch_size = batch_size
        self.device = device_of(device)
        if model_path:
            from vilco_tpu_torch.extractors.weights import load_hf_dir

            self.tokenizer = BPETokenizer.from_dir(model_path, "clip")
            self.model = load_hf_dir(model_path, "clip_text", self.device)
        else:
            cfg = CLIPTextCfg(
                vocab_size=1000, hidden_size=hidden,
                intermediate_size=hidden * 4, num_hidden_layers=layers,
                num_attention_heads=8, max_position_embeddings=max_length)
            self.tokenizer = None
            self.model = CLIPTextTower(cfg, device=self.device)
        self.model.eval()


class RobertaTokenExtractor(_TokenExtractor):
    """RoBERTa token features (the reference's
    ego4d_robera_token_extractor.py) with the same batching."""

    def __init__(self, model_path: Optional[str] = None,
                 max_length: int = 128, batch_size: int = 32,
                 device="cuda"):
        self.max_length = max_length
        self.batch_size = batch_size
        self.device = device_of(device)
        if model_path:
            from vilco_tpu_torch.extractors.weights import load_hf_dir

            self.tokenizer = BPETokenizer.from_dir(model_path, "roberta")
            self.model = load_hf_dir(model_path, "roberta", self.device)
        else:
            cfg = RobertaCfg(
                vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=512,
                max_position_embeddings=max_length + 2)
            self.tokenizer = None
            self.model = RobertaTower(cfg, device=self.device)
        self.model.eval()


def write_reference_format(out_dir: str, keys: List[str],
                           feats: List[np.ndarray]):
    """One .npz per key with 'token_features' (+ pooled 'features'), the
    format the reference lmdb/pt loaders consume."""
    os.makedirs(out_dir, exist_ok=True)
    for k, f in zip(keys, feats):
        np.savez(os.path.join(out_dir, f"{k}.npz"),
                 token_features=f, features=f.mean(0))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input-jsonl", required=True,
                   help="records with 'query_id' and 'query' fields")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--extractor", choices=["clip", "roberta"],
                   default="clip")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    with open(args.input_jsonl) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    keys = [r["query_id"] for r in records]
    texts = [r.get("query", "") for r in records]
    cls = ClipTextExtractor if args.extractor == "clip" \
        else RobertaTokenExtractor
    ex = cls(args.model_path, batch_size=args.batch_size, device=args.device)
    write_reference_format(args.out_dir, keys, ex.extract(texts))
    print(f"wrote {len(keys)} feature files to {args.out_dir}")


if __name__ == "__main__":
    main()
