"""Tokenizers of the feature extractors, in plain Python (no `tokenizers`,
`regex` or `transformers` package):

- `hash_tokenize`: JAX's fallback tokenizer, copied from
  vilco_tpu/extractors/clip_text.py::ClipTextExtractor._tokenize: one id
  `hash(w) % 998 + 2` a whitespace-split word, pad 0. `hash` is salted per
  process, so its ids agree with JAX's only in the same process.
- `BPETokenizer`: the byte-level BPE of HF's fast tokenizers as
  `AutoTokenizer.from_pretrained(dir)` builds them from a directory's
  `vocab.json` and `merges.txt` (transformers' convert_slow_tokenizer.py):
  - "roberta" (RobertaConverter): GPT-2's pre-tokenizer pattern
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
    \\s+(?!\\S)|\\s+`, bytes mapped to GPT-2's printable characters, BPE
    with no word suffix, `<s>` ... `</s>`, pad `<pad>`;
  - "clip" (CLIPConverter): NFC, runs of whitespace to one space,
    lowercase; CLIP's pattern `'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|
    [\\p{N}]|[^\\s\\p{L}\\p{N}]+` keeping the matches (whitespace goes);
    the same byte map; BPE with `</w>` on a word's last symbol;
    `<|startoftext|>` ... `<|endoftext|>`, pad `<|endoftext|>` unless
    tokenizer_config.json or special_tokens_map.json names another.
  The classes `\\p{L}`, `\\p{N}` are unicodedata's L* and N* categories and
  `\\s` Unicode's White_Space property, as the Oniguruma patterns of the
  fast tokenizers read them. Merges are ranked in the file's order, read
  as the slow tokenizers read them (RoBERTa: the lines between the
  header and the last newline; CLIP: after the header, at most 48,894).
  `__call__(texts, max_length)` pads and truncates as
  `tokenizer(texts, padding="max_length", truncation=True,
  max_length=max_length)`: the specials kept, the content cut to
  max_length - 2, pads after them, attention mask 1 on the rest.
  Special-token strings inside a text are not split out as specials.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Unicode's White_Space property (Oniguruma's \s)
WHITESPACE = frozenset(map(chr, [
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# the slow CLIP tokenizer's merges: 49152 - 256 - 2 of the file's lines
CLIP_MERGES = 49152 - 256 - 2
SPECIALS = {
    "roberta": {"bos_token": "<s>", "eos_token": "</s>",
                "pad_token": "<pad>", "unk_token": "<unk>"},
    "clip": {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
             "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"},
}


def hash_tokenize(texts: Sequence[str], max_length: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's hash tokenizer: (ids, mask), each (len(texts), max_length)
    int32."""
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        toks = [hash(w) % 998 + 2 for w in t.split()][:max_length]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return ids, mask


def byte_chars() -> Dict[int, str]:
    """GPT-2's bytes_to_unicode: each byte a printable character."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _kind(ch: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' any other character."""
    if ch in WHITESPACE:
        return "s"
    c = unicodedata.category(ch)[0]
    return c if c in "LN" else "o"


def _contraction(text: str, i: int) -> int:
    """The length of a contraction ('s 't 're 've 'm 'll 'd) at i, or 0."""
    if text[i] == "'":
        for c in CONTRACTIONS:
            if text.startswith(c, i + 1):
                return 1 + len(c)
    return 0


def _run(kinds: str, i: int, k: str) -> int:
    """The end of the run of kind k from i."""
    while i < len(kinds) and kinds[i] == k:
        i += 1
    return i


def gpt2_pieces(text: str) -> List[str]:
    """GPT-2's pre-tokenizer pattern, matched left to right."""
    kinds = "".join(map(_kind, text))
    out, i, n = [], 0, len(text)
    while i < n:
        j = i + _contraction(text, i)
        if j == i:
            # ` ?\p{L}+`, ` ?\p{N}+`, ` ?[^\s\p{L}\p{N}]+`: a space joins
            # the run after it
            s = i + (text[i] == " " and i + 1 < n and kinds[i + 1] != "s")
            if kinds[s] != "s":
                j = _run(kinds, s, kinds[s])
            else:
                # `\s+(?!\S)`: a whitespace run but its last character when
                # a non-space follows; else `\s+`
                j = _run(kinds, i, "s")
                if j < n and j - i > 1:
                    j -= 1
        out.append(text[i:j])
        i = j
    return out


def clip_pieces(text: str) -> List[str]:
    """CLIP's pre-tokenizer pattern, its matches kept and the rest (the
    whitespace) dropped."""
    kinds = "".join(map(_kind, text))
    out, i, n = [], 0, len(text)
    while i < n:
        k = kinds[i]
        j = i + _contraction(text, i)
        if j == i:
            if k == "s":
                i += 1
                continue
            j = i + 1 if k == "N" else _run(kinds, i, k)
        out.append(text[i:j])
        i = j
    return out


def clip_normalize(text: str) -> str:
    """NFC, each whitespace run one space, lowercase."""
    text = unicodedata.normalize("NFC", text)
    out, prev = [], False
    for ch in text:
        ws = ch in WHITESPACE
        if not (ws and prev):
            out.append(" " if ws else ch)
        prev = ws
    return "".join(out).lower()


def _special(path: str, name: str, default: str) -> str:
    """A special token's string from special_tokens_map.json, then
    tokenizer_config.json (a string or {"content": ...}), else `default`."""
    for fn in ("special_tokens_map.json", "tokenizer_config.json"):
        f = os.path.join(path, fn)
        if os.path.exists(f):
            with open(f) as fh:
                v = json.load(fh).get(name)
            if isinstance(v, dict):
                v = v.get("content")
            if isinstance(v, str):
                return v
    return default


class BPETokenizer:
    """Byte-level BPE of `kind` "roberta" or "clip" (module docstring) over
    `vocab` {token: id} and `merges` [(a, b)] in rank order."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str,
                 str]], kind: str, specials: Dict[str, str] | None = None):
        if kind not in SPECIALS:
            raise ValueError(f"kind {kind!r}: one of {sorted(SPECIALS)}")
        self.vocab, self.kind = vocab, kind
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        sp = {**SPECIALS[kind], **(specials or {})}
        self.bos, self.eos, self.pad, self.unk = (
            vocab[sp[n]] for n in ("bos_token", "eos_token", "pad_token",
                                   "unk_token"))
        self.suffix = "</w>" if kind == "clip" else ""
        self.chars = byte_chars()
        self.cache: Dict[str, List[int]] = {}

    @classmethod
    def from_dir(cls, path: str, kind: str) -> "BPETokenizer":
        """From a HF directory's vocab.json, merges.txt and special-token
        files."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            raw = f.read()
        lines = (raw.strip().split("\n")[1:CLIP_MERGES + 1] if kind == "clip"
                 else raw.split("\n")[1:-1])
        merges = [tuple(ln.split()) for ln in lines]
        specials = {n: _special(path, n, d)
                    for n, d in SPECIALS[kind].items()}
        return cls(vocab, merges, kind, specials)

    def _bpe(self, word: str) -> List[int]:
        if word in self.cache:
            return self.cache[word]
        syms = list(word)
        syms[-1] += self.suffix
        while len(syms) > 1:
            pairs = {(a, b) for a, b in zip(syms, syms[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) == best:
                    merged.append(syms[i] + syms[i + 1])
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            syms = merged
        ids = [self.vocab.get(s, self.unk) for s in syms]
        self.cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """The content ids of one text, no specials."""
        if self.kind == "clip":
            pieces = clip_pieces(clip_normalize(text))
        else:
            pieces = gpt2_pieces(text)
        ids = []
        for p in pieces:
            ids += self._bpe("".join(self.chars[b]
                                     for b in p.encode("utf-8")))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), each (len(texts), max_length)
        int64: bos, the content cut to max_length - 2, eos, then pads."""
        ids = np.full((len(texts), max_length), self.pad, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = [self.bos, *self.encode(t)[:max_length - 2], self.eos]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask
