"""CLIP's towers, tokenizer and checkpoint reader in the port
(rapidraw_tpu_torch/ai/clip.py, clip_tokenizer.py, checkpoint.py) against
`transformers`, on the CPU.

The JAX package runs `transformers`' CLIPModel and AutoTokenizer
(rapidraw_tpu/ai/tagging.py:110-130); the card's machine has neither, so
the port has its own. Held here:

  * the tokenizer: input_ids and attention_mask equal to what
    `AutoTokenizer.from_pretrained` (CLIPTokenizerFast, built from the
    slow CLIPTokenizer's save_pretrained output) returns, on a seeded
    byte-level vocabulary (chip_smoke.clip_vocab: 256 byte symbols and
    their </w> forms, 300 merges learnt from TAG_CANDIDATES, the two
    special tokens as the highest ids), for every TAG_CANDIDATES label,
    strings with contractions, punctuation, digits, accents, CJK, emoji,
    whitespace runs and special tokens, a 100-word string cut at 77, and a
    seeded sample of assigned code points;
  * the towers and logits against CLIPModel at tiny widths with every
    weight seeded (both eos pooling branches, quick_gelu and gelu, a
    padded batch), and once at ViT-B/32's published widths: text and image
    embeds, both towers' last_hidden_state and logits_per_image within
    1e-5 of the reference's span;
  * the checkpoint reader on each form save_pretrained writes (single
    safetensors, shards, pytorch_model.bin, float16 and bfloat16 saves)
    equal to from_pretrained's state dict, the carry-over's refusals, and
    the port's safetensors writer read back by the safetensors library.
"""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest
import torch

import chip_smoke
from rapidraw_tpu_torch.ai import checkpoint as ck
from rapidraw_tpu_torch.ai.clip import ClipConfig, ClipModel, load_clip_state, pool_index
from rapidraw_tpu_torch.ai.clip_tokenizer import ClipTokenizer
from rapidraw_tpu_torch.ai.tag_data import TAG_CANDIDATES

# transformers is imported inside the tests (~10 s): a worker that collects
# this file and runs none of it does not pay for it
if importlib.util.find_spec("transformers") is None:
    pytest.skip("the reference needs transformers", allow_module_level=True)

torch.set_num_threads(2)

TOL = 1e-5  # of the reference's span


def span_err(ref, got) -> float:
    ref, got = ref.detach().double(), got.detach().double()
    return float((ref - got).abs().max()) / max(float(ref.max() - ref.min()), 1e-12)


# ------------------------------------------------------------------ tokenizer
@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(the port's ClipTokenizer, transformers' AutoTokenizer) of one
    save_pretrained directory holding the seeded vocabulary."""
    from transformers import AutoTokenizer, CLIPTokenizer

    src = tmp_path_factory.mktemp("vocab")
    chip_smoke.write_clip_tokenizer(src, *chip_smoke.clip_vocab())
    d = tmp_path_factory.mktemp("tokenizer")
    CLIPTokenizer(str(src / "vocab.json"), str(src / "merges.txt")).save_pretrained(d)
    ref = AutoTokenizer.from_pretrained(d)
    assert type(ref).__name__ == "CLIPTokenizerFast"
    return ClipTokenizer.from_dir(d), ref, src


def assert_same_encoding(ours, ref, texts, max_length=77):
    want = ref(texts, padding=True, truncation=True, max_length=max_length, return_tensors="np")
    ids, mask = ours(texts, max_length)
    assert ids.shape == want["input_ids"].shape
    bad = [t for t, a, b in zip(texts, ids, want["input_ids"]) if not np.array_equal(a, b)]
    assert not bad, [(t, ours.encode(t), ref(t)["input_ids"]) for t in bad[:5]]
    np.testing.assert_array_equal(mask, want["attention_mask"])


MIXED = [
    "it's don't we're they've I'm you'll he'd", "''s 'S 'LL a'b", "Hello,   World!!  ...",
    "  leading and trailing  ", "café naïve Ångström coöperate", "ΟΔΟΣ Straße İstanbul",
    "東京タワー 日本語の文", "😀🎉 emoji 👍🏽", "tab\tnew\nline\r\x0b\x0c end",
    "12345 ½ ² Ⅻ ٣ 3.14",
    "a <|endoftext|> b", "<|startoftext|>x<|endoftext|>", "x\x1cy\x1fz\x85w\xa0v　u​t",
    "", "   ", "Golden Hour", "black and white", "close-up", "e-mail@host.com #tag $5",
]


@pytest.mark.parametrize("case", ["labels", "mixed", "truncation", "code points"])
def test_tokenizer_matches_autotokenizer(tokenizers, case):
    ours, ref, _ = tokenizers
    if case == "labels":
        texts = list(TAG_CANDIDATES)
    elif case == "mixed":
        texts = MIXED
    elif case == "truncation":
        texts = [" ".join(f"word{i}" for i in range(100)), "short", "Ünïcödé " * 40]
        assert ours(texts)[0].shape[1] == 77
    else:
        # code points Python's unicodedata (15.0) assigns: the tokenizers
        # library's tables are newer and class some code points 15.0 leaves
        # unassigned (ROADMAP, known differences)
        import unicodedata

        rng = np.random.default_rng(3)
        cps = [c for c in rng.integers(0, 0x30000, 6000).tolist()
               if unicodedata.category(chr(c)) not in ("Cn", "Cs")][:1500]
        texts = [f"a{chr(c)}1{chr(c)}{chr(c)}A {chr(c)}" for c in cps]
    assert_same_encoding(ours, ref, texts)
    assert_same_encoding(ours, ref, texts[:7], max_length=9)  # the cut keeps BOS, EOS last


def test_tokenizer_reads_the_special_tokens(tokenizers, tmp_path):
    """Ids of BOS, EOS and pad come from the files; the port's own writer
    (chip_smoke's checkpoint) reads back as save_pretrained's output does."""
    ours, ref, src = tokenizers
    assert (ours.bos_id, ours.eos_id, ours.pad_id) == (ref.bos_token_id, ref.eos_token_id,
                                                     ref.pad_token_id)
    assert ours.eos_id == max(ours.vocab.values())  # CLIP's layout: the highest id
    mine = ClipTokenizer.from_dir(src)
    for a, b in zip(mine(MIXED), ours(MIXED)):
        np.testing.assert_array_equal(a, b)
    # a pad token of its own (special_tokens_map.json wins)
    doc = json.loads((src / "special_tokens_map.json").read_text())
    (tmp_path / "special_tokens_map.json").write_text(json.dumps(dict(doc, pad_token="!")))
    for name in ("vocab.json", "merges.txt"):
        (tmp_path / name).write_bytes((src / name).read_bytes())
    padded = ClipTokenizer.from_dir(tmp_path)
    ids, mask = padded(["a b c", "a"])
    assert ids[1, -1] == padded.vocab["!"] and mask[1, -1] == 0


def test_slow_tokenizer_differs_on_cjk(tokenizers):
    """transformers' slow CLIPTokenizer (no ftfy here) splits CJK ideographs
    into words of their own; the fast one, and the port, do not."""
    from transformers import CLIPTokenizer

    ours, _, src = tokenizers
    slow = CLIPTokenizer(str(src / "vocab.json"), str(src / "merges.txt"))
    assert slow("dog cat")["input_ids"] == ours(["dog cat"])[0][0].tolist()
    assert slow("日本語")["input_ids"] != ours(["日本語"])[0][0].tolist()


# --------------------------------------------------------------------- towers
def tiny_config(eos: int, act: str, vocab: int = 40):
    from transformers import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    return CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(vocab_size=vocab, hidden_size=32, intermediate_size=48,
                       num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=20,
                       eos_token_id=eos, hidden_act=act, layer_norm_eps=1e-5),
        CLIPVisionConfig(hidden_size=24, intermediate_size=40, num_hidden_layers=2,
                         num_attention_heads=3, image_size=48, patch_size=16, hidden_act=act),
        projection_dim=12, logit_scale_init_value=3.2)


def seeded(model, seed):
    """Every parameter of a transformers model drawn from a seed (biases
    and LayerNorms too, so a swapped or skipped one shows)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "logit_scale":
                continue
            scale = 1.0 / max(p.shape[-1], 1) ** 0.5 if p.ndim >= 2 else 0.2
            p.copy_(torch.randn(p.shape, generator=g) * scale + (1.0 if name.endswith(
                ("layer_norm1.weight", "layer_norm2.weight", "norm.weight", "layrnorm.weight"))
                else 0.0))
    return model.eval()


def port_of(ref) -> ClipModel:
    doc = json.loads(ref.config.to_json_string())
    return load_clip_state(ClipModel(ClipConfig.from_dict(doc)), ref.state_dict()).eval()


def compare(ref, ours, ids, mask, px):
    with torch.no_grad():
        out = ref(input_ids=ids, attention_mask=mask, pixel_values=px)
        text = ref.text_model(input_ids=ids, attention_mask=mask)
        vision = ref.vision_model(pixel_values=px)
    last_t, _ = ours.text_model(ids, mask)
    last_v, _ = ours.vision_model(px)
    errs = {
        "text_embeds": span_err(ref.text_projection(text.pooler_output),
                                ours.text_features(ids, mask)),
        "image_embeds": span_err(ref.visual_projection(vision.pooler_output),
                                 ours.image_features(px)),
        "text last_hidden_state": span_err(text.last_hidden_state, last_t),
        "vision last_hidden_state": span_err(vision.last_hidden_state, last_v),
        "logits_per_image": span_err(out.logits_per_image, ours(px, ids, mask)),
    }
    print(errs)
    assert all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("eos,act", [(2, "quick_gelu"), (39, "gelu"), (49407, "quick_gelu")],
                         ids=["eos 2 largest id", "eos in the vocabulary", "eos never occurs"])
def test_towers_match_clipmodel(eos, act):
    from transformers import CLIPModel

    torch.manual_seed(0)
    ref = seeded(CLIPModel(tiny_config(eos, act)), 1)
    ours = port_of(ref)
    rng = np.random.default_rng(2)
    n, t = 6, 11
    ids = rng.integers(1, 38, (n, t))
    lengths = [11, 7, 4, 11, 2, 9]
    for i, k in enumerate(lengths):  # BOS .. EOS, then pad with EOS as the tokenizer does
        ids[i, 0], ids[i, k - 1], ids[i, k:] = 38 - 1, 39, 39
    ids = torch.from_numpy(ids)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).long()
    px = torch.from_numpy(rng.standard_normal((2, 3, 48, 48)).astype(np.float32))
    compare(ref, ours, ids, mask, px)


def test_pool_index_takes_the_first_of_ties():
    ids = torch.tensor([[5, 9, 9, 9], [9, 1, 2, 3], [1, 2, 3, 4]])
    assert pool_index(ids, 2).tolist() == [1, 0, 3]  # the largest id, first of ties
    assert pool_index(ids, 9).tolist() == [1, 0, 0]  # the first eos, else 0
    assert pool_index(ids, 7).tolist() == [0, 0, 0]


def test_towers_at_published_widths():
    """ViT-B/32: vision 768 wide, 12 layers, 12 heads, patch 32 at 224 px;
    text 512 wide, 12 layers, 8 heads, a 49,408 vocabulary and 77
    positions; projection 512; a handful of labels."""
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(5)
    ref = CLIPModel(CLIPConfig()).eval()
    assert (ref.config.vision_config.hidden_size, ref.config.text_config.vocab_size,
            ref.config.projection_dim) == (768, 49408, 512)
    ours = port_of(ref)
    rng = np.random.default_rng(6)
    lengths = [5, 9, 3, 7]
    ids = rng.integers(0, 49406, (4, 9))
    for i, k in enumerate(lengths):
        ids[i, 0], ids[i, k - 1], ids[i, k:] = 49406, 49407, 49407
    ids = torch.from_numpy(ids)
    mask = (torch.arange(9)[None] < torch.tensor(lengths)[:, None]).long()
    px = torch.from_numpy(rng.standard_normal((1, 3, 224, 224)).astype(np.float32))
    compare(ref, ours, ids, mask, px)


# ----------------------------------------------------------------- checkpoint
@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    from transformers import CLIPModel

    torch.manual_seed(0)
    return seeded(CLIPModel(tiny_config(2, "quick_gelu")), 4), tmp_path_factory


@pytest.mark.parametrize("form", ["safetensors", "sharded", "bin", "sharded bin", "float16",
                                  "bfloat16"])
def test_checkpoint_reads_every_save_pretrained_form(saved, form):
    from transformers import CLIPModel

    model, factory = saved
    d = factory.mktemp(form.replace(" ", "_"))
    kw = {"safe_serialization": "bin" not in form}
    if "sharded" in form:
        kw["max_shard_size"] = "20KB"
    src = model
    if form in ("float16", "bfloat16"):
        src = CLIPModel(model.config)
        src.load_state_dict(model.state_dict())
        src = src.to(getattr(torch, form))
    src.save_pretrained(d, **kw)
    names = sorted(p.name for p in d.iterdir())
    if "sharded" in form:
        assert any(n.endswith(".index.json") for n in names), names
    ref = CLIPModel.from_pretrained(d)
    want = ref.state_dict()
    got = ck.read_state(d)
    assert set(got) == set(want)
    for k, v in want.items():
        assert v.dtype == got[k].dtype == torch.float32, (k, v.dtype, got[k].dtype)
        assert torch.equal(got[k], v), k
    cfg = ClipConfig.from_dict(ck.read_config(d))
    assert cfg.text.eos_token_id == 2 and cfg.vision.patch_size == 16
    load_clip_state(ClipModel(cfg), got)


def test_carry_over_refuses_a_gap_or_a_leftover(saved):
    model, _ = saved
    state = dict(model.state_dict())
    cfg = ClipConfig.from_dict(json.loads(model.config.to_json_string()))
    # the position_ids buffers older .bin files hold are passed over
    legacy = dict(state, **{"text_model.embeddings.position_ids": torch.arange(20)[None],
                            "vision_model.embeddings.position_ids": torch.arange(10)[None]})
    load_clip_state(ClipModel(cfg), legacy)
    gap = {k: v for k, v in state.items() if k != "text_model.final_layer_norm.bias"}
    with pytest.raises(ValueError, match="fills no value"):
        load_clip_state(ClipModel(cfg), gap)
    with pytest.raises(ValueError, match="does not read"):
        load_clip_state(ClipModel(cfg), dict(state, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="has shape"):
        load_clip_state(ClipModel(cfg), dict(state, logit_scale=torch.zeros(2)))


def test_safetensors_writer_read_by_the_library(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(7)
    tensors = {"b.weight": rng.standard_normal((3, 5)).astype(np.float32),
               "a": rng.standard_normal(7).astype(np.float32),
               "scale": np.array(2.5, np.float32)}
    ck.write_safetensors(tmp_path / "x.safetensors", tensors)
    back = load_file(str(tmp_path / "x.safetensors"))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v)
    ours = ck.read_safetensors(tmp_path / "x.safetensors")
    assert all(torch.equal(ours[k], torch.from_numpy(v)) for k, v in tensors.items())
    assert ours["scale"].shape == ()
    # the reader takes the int64 position_ids of older files as they are
    save_file({"ids": np.arange(6, dtype=np.int64)}, str(tmp_path / "ids.safetensors"))
    ids = ck.read_safetensors(tmp_path / "ids.safetensors")["ids"]
    assert ids.dtype == torch.int64 and torch.equal(ids, torch.arange(6))
    with pytest.raises(ValueError, match="float32 only"):
        ck.write_safetensors(tmp_path / "y.safetensors", {"ids": np.arange(6)})
    with pytest.raises(OSError, match="holds none of"):
        ck.read_state(tmp_path)
