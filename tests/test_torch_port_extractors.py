"""The port's feature extractors (vilco_tpu_torch/extractors/) against JAX's
(vilco_tpu/extractors/) and HF's models and tokenizers on the CPU.

- Towers: small HF Flax models built with transformers' own classes (seed
  0), their params carried across with `state_from_flax`; the port's
  towers give the same `last_hidden_state` and `pooler_output` within
  1e-5 (f32), rows with no token and one token included.
- Extractors: JAX's ClipImageExtractor, ClipTextExtractor and
  RobertaTokenExtractor (random init, hash tokenizer) beside the port's,
  in one process (the hash tokenizer's `hash` is salted per process),
  with the JAX model's params loaded into the port's; the features, and
  the files each package's `main` writes, agree within 1e-5.
- `load_hf_dir`: a small tower's HF-layout state_dict written as
  pytorch_model.bin and as a safetensors file (by hand, and by the
  safetensors package where it is installed) loads back bit for bit.
- Tokenizers: a small vocab.json / merges.txt of each BPE, learnt here
  from a few sentences, loaded by HF's `AutoTokenizer` as JAX does; the
  port's ids and mask equal HF's on every query of QUERIES.
"""

import collections
import dataclasses
import json
import os
import struct

import numpy as np
import pytest

import torch

from tests._torch_threads import torch_one_thread  # noqa: F401
from vilco_tpu_torch.extractors import clip_image as t_image
from vilco_tpu_torch.extractors import clip_text as t_text
from vilco_tpu_torch.extractors import encoders as E
from vilco_tpu_torch.extractors.tokenizers import (
    BPETokenizer,
    byte_chars,
    hash_tokenize,
)
from vilco_tpu_torch.extractors.weights import load_hf_dir, state_from_flax

transformers = pytest.importorskip("transformers")

TOL = dict(rtol=1e-5, atol=1e-5)
# token counts of the text rows: full, some, one, none
LENGTHS = (16, 5, 1, 0)
QUERIES = [
    "", "Where Is THE Cup", "put 3 apples 1234 x2", "what?! ... (yes)",
    "don't it's I'll we've they're 'quoted' rock'n'roll",
    "café naïve résumé café", "我的杯子在哪里", "where is 🐶 🍕?",
    "  two  spaces\tand\ttabs\n end ", "word " * 100,
    "He said: \"ok\"; [1/2] ½ ² A B", "The Kitchen's table",
]
CORPUS = ("where is the red cup i put it on the table in the kitchen what "
          "did she say about the old bicycle near the garden door when did "
          "i open the fridge 2023 ok isn't it").split()


def _tower(kind):
    """(HF Flax model, the port's tower with its params) at a small size."""
    from transformers import (
        CLIPTextConfig,
        CLIPVisionConfig,
        FlaxCLIPTextModel,
        FlaxCLIPVisionModel,
        FlaxRobertaModel,
        RobertaConfig,
    )

    if kind == "clip_vision":
        hf = CLIPVisionConfig(hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4,
                              image_size=64, patch_size=32)
        jm, cls, tower = FlaxCLIPVisionModel(hf, seed=0), E.CLIPVisionCfg, \
            E.CLIPVisionTower
    elif kind == "clip_text":
        hf = CLIPTextConfig(vocab_size=1000, hidden_size=64,
                            intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=8, max_position_embeddings=16)
        jm, cls, tower = FlaxCLIPTextModel(hf, seed=0), E.CLIPTextCfg, \
            E.CLIPTextTower
    else:
        hf = RobertaConfig(vocab_size=1000, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=128, max_position_embeddings=18)
        jm, cls, tower = FlaxRobertaModel(hf, seed=0), E.RobertaCfg, \
            E.RobertaTower
    t = tower(E.cfg_from_dict(cls, hf.to_dict()), device="cpu")
    t.load_state_dict(state_from_flax(jm.params))
    return jm, t.eval()


def _text_inputs(seed=1):
    ids = np.random.default_rng(seed).integers(2, 1000, (len(LENGTHS), 16))
    mask = (np.arange(16)[None] < np.array(LENGTHS)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("kind", ["clip_vision", "clip_text", "roberta"])
def test_tower_matches_flax(kind):
    jm, tower = _tower(kind)
    if kind == "clip_vision":
        px = np.random.default_rng(0).random((3, 3, 64, 64)).astype(
            np.float32)
        want = jm(pixel_values=px)
        with torch.no_grad():
            got = tower(torch.from_numpy(px))
    else:
        ids, mask = _text_inputs()
        want = jm(input_ids=ids, attention_mask=mask)
        with torch.no_grad():
            got = tower(torch.from_numpy(ids), torch.from_numpy(mask))
    for k in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_empty_text_takes_the_mean_of_v():
    """K1's plain version gives 0 where no key is valid; the tower's
    attention gives HF's mean of v there and K1's answer elsewhere."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 6, 16, generator=g) for _ in range(3))
    mask = torch.arange(6)[None] < torch.tensor([6, 2, 0])[:, None]
    out = E.attention_k1(q, k, v, mask, 4)
    torch.testing.assert_close(out[2], v[2].mean(0).expand(6, 16))
    allowed = mask[:, None, None, :].expand(3, 1, 6, 6)
    torch.testing.assert_close(out, E.attention_plain(q, k, v, allowed, 4))


def _texts():
    return ["", "one", "pick up the red cup from the table",
            " ".join(f"w{i}" for i in range(40)), "where is it", "a b"]


def _jax_text(kind, **kw):
    from vilco_tpu.extractors import clip_text as j_text

    return (j_text.ClipTextExtractor(**kw) if kind == "clip"
            else j_text.RobertaTokenExtractor(**kw))


def _port_text(kind, jex, **kw):
    ex = (t_text.ClipTextExtractor(device="cpu", **kw) if kind == "clip"
          else t_text.RobertaTokenExtractor(device="cpu", **kw))
    ex.model.load_state_dict(state_from_flax(jex.model.params))
    return ex


def _same_features(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", ["clip", "roberta"])
def test_text_extractor_matches_jax(kind):
    kw = dict(max_length=16, batch_size=4)
    if kind == "clip":
        kw.update(hidden=64, layers=2)
    jex = _jax_text(kind, **kw)
    ex = _port_text(kind, jex, **kw)
    _same_features(ex.extract(_texts()), jex.extract(_texts()))


def test_image_extractor_matches_jax():
    from vilco_tpu.extractors.clip_image import ClipImageExtractor

    jex = ClipImageExtractor(image_size=64, batch_size=4)
    ex = t_image.ClipImageExtractor(image_size=64, batch_size=4,
                                    device="cpu")
    ex.model.load_state_dict(state_from_flax(jex.model.params))
    frames = np.random.default_rng(0).random((6, 64, 64, 3)).astype(
        np.float32)
    _same_features([ex.extract_frames(frames)], [jex.extract_frames(frames)])


def _loading_jax_weights(monkeypatch, module, name, jax_model):
    """Make `module.name` (a tower class) build the tower with the params
    of the JAX extractor's Flax model."""
    cls = getattr(module, name)

    def build(cfg, device="cuda"):
        t = cls(cfg, device=device)
        t.load_state_dict(state_from_flax(jax_model.params))
        return t

    monkeypatch.setattr(module, name, build)


@pytest.mark.parametrize("kind", ["clip", "roberta"])
def test_text_main_files_match_jax(tmp_path, monkeypatch, kind):
    from vilco_tpu.extractors import clip_text as j_text

    recs = [{"query_id": f"q{i}", "query": t} for i, t in enumerate(_texts())]
    recs.append({"query_id": "noquery"})
    src = tmp_path / "q.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    args = ["--input-jsonl", str(src), "--extractor", kind,
            "--batch-size", "4"]
    j_text.main(args + ["--out-dir", str(tmp_path / "j")])
    jex = _jax_text(kind, batch_size=4)    # the same seed-0 Flax model
    _loading_jax_weights(monkeypatch, t_text, "CLIPTextTower" if kind ==
                         "clip" else "RobertaTower", jex.model)
    t_text.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 7
    for n in names:
        a, b = np.load(tmp_path / "t" / n), np.load(tmp_path / "j" / n)
        assert sorted(a.files) == sorted(b.files) == ["features",
                                                      "token_features"]
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_allclose(a[key], b[key], **TOL, err_msg=n)


def test_image_main_file_matches_jax(tmp_path, monkeypatch):
    from vilco_tpu.extractors import clip_image as j_image

    frames = np.random.default_rng(2).random((5, 64, 64, 3)).astype(
        np.float32)
    np.save(tmp_path / "f.npy", frames)
    j_image.main(["--frames-npy", str(tmp_path / "f.npy"),
                  "--out", str(tmp_path / "j.npy")])
    jex = j_image.ClipImageExtractor(image_size=64)
    _loading_jax_weights(monkeypatch, t_image, "CLIPVisionTower", jex.model)
    t_image.main(["--frames-npy", str(tmp_path / "f.npy"), "--out",
                  str(tmp_path / "t.npy"), "--device", "cpu"])
    a, b = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert a.shape == b.shape == (5, 256) and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, **TOL)


def test_hash_tokenizer_is_jax_s():
    from vilco_tpu.extractors.clip_text import ClipTextExtractor

    ids, mask = hash_tokenize(_texts(), 16)
    jids, jmask = ClipTextExtractor._tokenize(
        type("T", (), {"tokenizer": None, "max_length": 16})(), _texts())
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


# ---------------------------------------------------------------- load_hf_dir

TINY = {"clip_vision": E.CLIPVisionCfg(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, image_size=64, patch_size=32),
        "clip_text": E.CLIPTextCfg(
            vocab_size=50, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            max_position_embeddings=8),
        "roberta": E.RobertaCfg(
            vocab_size=50, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=10)}
MODEL_TYPE = {"clip_vision": "clip_vision_model",
              "clip_text": "clip_text_model", "roberta": "roberta"}
ST_NAMES = {torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path, state):
    """The format by hand: an 8-byte little-endian header length, the JSON
    header (dtype, shape, data offsets), the tensors' raw bytes."""
    header, blobs, at = {}, [], 0
    for name, t in state.items():
        b = t.contiguous().numpy().tobytes()
        header[name] = {"dtype": ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _write_dir(d, kind, tower, fmt, prefix=""):
    os.makedirs(d, exist_ok=True)
    cfg = {**dataclasses.asdict(TINY[kind]), "model_type": MODEL_TYPE[kind]}
    state = {prefix + k: v for k, v in tower.state_dict().items()}
    if fmt == "bin":
        torch.save(state, os.path.join(d, "pytorch_model.bin"))
    elif fmt == "safetensors":
        write_safetensors(os.path.join(d, "model.safetensors"), state)
    else:
        from safetensors.torch import save_file

        save_file(state, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "safetensors_pkg"])
@pytest.mark.parametrize("kind", ["clip_vision", "clip_text", "roberta"])
def test_load_hf_dir_is_bitwise(tmp_path, kind, fmt):
    if fmt == "safetensors_pkg":
        pytest.importorskip("safetensors")
    cls = E.CLIPVisionTower if kind == "clip_vision" else (
        E.CLIPTextTower if kind == "clip_text" else E.RobertaTower)
    tower = cls(TINY[kind], device="cpu",
                generator=torch.Generator().manual_seed(7))
    _write_dir(tmp_path, kind, tower, fmt)
    back = load_hf_dir(str(tmp_path), device="cpu")
    assert back.cfg == tower.cfg
    for (ka, a), (kb, b) in zip(tower.state_dict().items(),
                                back.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


def test_load_hf_dir_picks_a_tower_of_a_full_checkpoint(tmp_path):
    """A CLIPModel directory (both towers under vision_model. and
    text_model., a projection the towers lack) and a RoBERTa MLM
    checkpoint (roberta.-prefixed, no pooler, an lm_head)."""
    g = torch.Generator().manual_seed(3)
    vis = E.CLIPVisionTower(TINY["clip_vision"], device="cpu", generator=g)
    txt = E.CLIPTextTower(TINY["clip_text"], device="cpu", generator=g)
    state = {**vis.state_dict(), **txt.state_dict(),
             "visual_projection.weight": torch.zeros(4, 32)}
    torch.save(state, tmp_path / "pytorch_model.bin")
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "clip",
                   "vision_config": dataclasses.asdict(TINY["clip_vision"]),
                   "text_config": dataclasses.asdict(TINY["clip_text"])}, f)
    for kind, tower in (("clip_vision", vis), ("clip_text", txt)):
        back = load_hf_dir(str(tmp_path), kind, device="cpu")
        for k, v in tower.state_dict().items():
            assert torch.equal(v, back.state_dict()[k]), k
    rob = E.RobertaTower(TINY["roberta"], device="cpu", generator=g)
    d = tmp_path / "roberta"
    _write_dir(d, "roberta", rob, "bin", prefix="roberta.")
    state = torch.load(d / "pytorch_model.bin")
    state = {k: v for k, v in state.items() if ".pooler." not in k}
    state["lm_head.bias"] = torch.zeros(50)
    torch.save(state, d / "pytorch_model.bin")
    back = load_hf_dir(str(d), device="cpu")
    for k, v in rob.state_dict().items():
        if not k.startswith("pooler."):
            assert torch.equal(v, back.state_dict()[k]), k


# ---------------------------------------------------------------- tokenizers

def _learn_merges(words, suffix, n):
    """BPE merges learnt from `words`: the most frequent pair, n times."""
    chars = byte_chars()
    corpus = collections.Counter()
    for w in words:
        syms = list("".join(chars[b] for b in w.encode()))
        syms[-1] += suffix
        corpus[tuple(syms)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in corpus.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in corpus.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        corpus = merged
    return merges


@pytest.fixture(scope="module")
def bpe_dirs(tmp_path_factory):
    """A RoBERTa and a CLIP tokenizer directory: every byte symbol (CLIP:
    also with </w>), 80 merges learnt from CORPUS, the specials."""
    dirs = {}
    chars = list(byte_chars().values())
    for kind in ("roberta", "clip"):
        d = tmp_path_factory.mktemp(kind)
        if kind == "roberta":
            words = [(" " + w) if i else w for i, w in enumerate(CORPUS)]
            merges = _learn_merges(words, "", 80)
            toks = ["<s>", "<pad>", "</s>", "<unk>", *chars]
            cls = "RobertaTokenizer"
        else:
            merges = _learn_merges(CORPUS, "</w>", 80)
            toks = [*chars, *(c + "</w>" for c in chars)]
            cls = "CLIPTokenizer"
        toks += [a + b for a, b in merges]
        if kind == "clip":
            toks += ["<|startoftext|>", "<|endoftext|>"]
        vocab = {}
        for t in toks:
            vocab.setdefault(t, len(vocab))
        (d / "vocab.json").write_text(json.dumps(vocab))
        (d / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        (d / "tokenizer_config.json").write_text(
            json.dumps({"tokenizer_class": cls}))
        dirs[kind] = str(d)
    return dirs


@pytest.fixture(scope="module")
def hf_tokenizers(bpe_dirs):
    from transformers import AutoTokenizer

    return {k: AutoTokenizer.from_pretrained(d) for k, d in bpe_dirs.items()}


@pytest.mark.parametrize("query", QUERIES, ids=range(len(QUERIES)))
@pytest.mark.parametrize("kind", ["roberta", "clip"])
def test_tokenizer_matches_hf(bpe_dirs, hf_tokenizers, kind, query):
    enc = hf_tokenizers[kind]([query], padding="max_length", truncation=True,
                              max_length=24, return_tensors="np")
    ids, mask = BPETokenizer.from_dir(bpe_dirs[kind], kind)([query], 24)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


def test_extractor_reads_a_model_directory(bpe_dirs, tmp_path):
    """A RoBERTa directory with the tokenizer files and the weights: the
    extractor tokenizes with BPE (pad 1, so positions from the ids) and
    matches the tower on the tokenizer's ids."""
    d = tmp_path / "rob"
    d.mkdir()
    for fn in ("vocab.json", "merges.txt", "tokenizer_config.json"):
        (d / fn).write_text((open(os.path.join(bpe_dirs["roberta"], fn))
                             .read()))
    n_vocab = len(json.loads((d / "vocab.json").read_text()))
    cfg = dataclasses.replace(TINY["roberta"], vocab_size=n_vocab,
                              max_position_embeddings=20)
    tower = E.RobertaTower(cfg, device="cpu")
    torch.save(tower.state_dict(), d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps(
        {**dataclasses.asdict(cfg), "model_type": "roberta"}))
    ex = t_text.RobertaTokenExtractor(str(d), max_length=18, device="cpu")
    texts = ["where is the red cup", "", "the old bicycle near the door"]
    feats = ex.extract(texts)
    ids, mask = ex.tokenizer(texts, 18)
    assert ids[1].tolist()[:3] == [0, 2, 1] and (ids == 1).any()
    with torch.no_grad():
        want = tower(torch.from_numpy(ids), torch.from_numpy(mask))[
            "last_hidden_state"].numpy()
    for i, f in enumerate(feats):
        np.testing.assert_array_equal(f, want[i, :mask[i].sum()])
