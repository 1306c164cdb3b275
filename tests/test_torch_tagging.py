"""CLIP tagging in the port (rapidraw_tpu_torch/ai/tagging.py) against the
JAX package's (rapidraw_tpu/ai/tagging.py), on the CPU.

  * `tag_data` equal to JAX's;
  * the host functions bit for bit: `preprocess_clip_image` (PIL's 8-bit
    BILINEAR resize to fill and the centre crop, through the port's own u8
    resize), `softmax`, `extract_color_tags` (PIL's `thumbnail((100, 100))`)
    on seeded landscape, portrait, small, 224 x 224 and grey images;
  * `generate_tags_with_clip` with the default and a custom list on JAX's
    tiny checkpoint (tests/test_ai_tagging_clip.py's `tiny_clip`) and on a
    seeded checkpoint written by the port's own writers
    (chip_smoke.write_clip_checkpoint: the synthetic vocabulary, logit scale
    ln 100, eos_token_id 2), which JAX's `transformers` reads: the same tags,
    except a label within 1e-6 of a cut (chip_smoke.near_cut; counted and
    printed);
  * `index_folder_tags` over twin folders of JPEG, PNG, TIFF and DNG files,
    one already AI-tagged, one with only `user:`/`color:` tags, one past
    720 px (the downscale) and a `.bmp`: the same sidecars, return value and
    progress calls, the `.bmp` tagged on both; the cancel token; a missing
    checkpoint;
  * `clear_ai_tags` and `clear_all_tags` on twin trees.

JAX runs op by op (`jax.disable_jit`), as the port follows its op-by-op
numerics.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import rapidraw_tpu.ai.tagging as jtg
import rapidraw_tpu_torch.ai.tagging as ttg
from test_ai_tagging_clip import tiny_clip  # noqa: F401 - a fixture

# JAX's tagging imports transformers when it first scores (~10 s), inside
# the tests
if importlib.util.find_spec("transformers") is None:
    pytest.skip("JAX's tagging needs transformers", allow_module_level=True)

torch.set_num_threads(2)


def image(h, w, seed, grey=False):
    """Planar (3, h, w) float32 with values a little past [0, 1] (the clip)."""
    x = np.random.default_rng(seed).uniform(-0.05, 1.05, (1 if grey else 3, h, w))
    return np.repeat(x, 3, 0).astype(np.float32) if grey else x.astype(np.float32)


IMAGES = {"landscape": (90, 160, False), "portrait": (170, 100, False),
          "small": (50, 70, False), "224": (224, 224, False), "grey": (120, 96, True),
          "odd": (301, 227, False)}


def test_tag_data_equals_jax():
    from rapidraw_tpu.ai import tag_data as jdata
    from rapidraw_tpu_torch.ai import tag_data as tdata

    assert tdata.TAG_CANDIDATES == jdata.TAG_CANDIDATES
    assert tdata.TAG_HIERARCHY == jdata.TAG_HIERARCHY


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_host_functions_bit_equal(name):
    h, w, grey = IMAGES[name]
    x = image(h, w, len(name), grey)
    for size in (224, 32):
        want = jtg.preprocess_clip_image(x, size)
        got = ttg.preprocess_clip_image(torch.from_numpy(x), size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert ttg.extract_color_tags(x) == jtg.extract_color_tags(x)
    logits = np.random.default_rng(h).normal(0, 5, (2, 37)).astype(np.float32)
    np.testing.assert_array_equal(ttg.softmax(logits), jtg.softmax(logits))


def test_color_tags_of_flat_images():
    """The grey and black branches, and np.unique's order before the count
    sort on a tie."""
    for rgb in ((0.5, 0.5, 0.5), (0.05, 0.05, 0.05), (0.95, 0.95, 0.95)):
        x = np.broadcast_to(np.asarray(rgb, np.float32)[:, None, None], (3, 40, 60)).copy()
        assert ttg.extract_color_tags(x) == jtg.extract_color_tags(x)
    x = np.zeros((3, 40, 60), np.float32)
    x[0, :, :30] = 0.9  # red | green halves: a tie
    x[1, :, 30:] = 0.9
    assert ttg.extract_color_tags(x) == jtg.extract_color_tags(x) == ["green", "red"]


def both_tags(planar, custom, max_tags):
    """(JAX's tags, the port's tags, the labels near a cut)."""
    from rapidraw_tpu_torch.ai.tag_data import TAG_CANDIDATES

    want = jtg.generate_tags_with_clip(planar, custom, max_tags)
    got = ttg.generate_tags_with_clip(torch.from_numpy(planar), custom, max_tags, device="cpu")
    model, tok = ttg._load_clip("cpu")
    texts = list(custom) if custom else list(TAG_CANDIDATES)
    pix = torch.from_numpy(ttg.preprocess_clip_image(planar, model.cfg.vision.image_size))
    ids, mask = tok(texts, model.cfg.text.max_position_embeddings)
    probs = ttg.softmax(model(pix, torch.from_numpy(ids), torch.from_numpy(mask)).numpy())[0]
    return want, got, chip_smoke.near_cut(texts, probs, max_tags)


def assert_same_tags(want, got, near):
    print(f"tags {len(got)}; labels within {chip_smoke.NEAR_CUT:g} of a cut: {len(near)}")
    assert (set(want) ^ set(got)) <= near, (want, got, near)


def write_small_checkpoint(d: Path) -> Path:
    """A checkpoint the port's writers make (chip_smoke.write_clip_checkpoint)
    at narrow widths, with the synthetic vocabulary and eos_token_id 2: the
    text tower pools at each label's EOS, so labels score apart and pass
    the threshold (JAX's tiny checkpoint pools every label at its BOS, so
    they tie and only colours pass)."""
    doc = {"text_config": dict(chip_smoke.CLIP_B32["text_config"], vocab_size=900,
                               hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4),
           "vision_config": dict(chip_smoke.CLIP_B32["vision_config"], hidden_size=48,
                                 intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=64),
           "projection_dim": 16}
    chip_smoke.write_clip_checkpoint(d, doc, seed=3)
    return d


@pytest.fixture
def seeded_clip(tmp_path, monkeypatch):
    d = write_small_checkpoint(tmp_path / "clip")
    monkeypatch.setenv("RAPIDRAW_CLIP", str(d))
    return d


@pytest.mark.parametrize("custom,max_tags", [(None, 10), (["dog", "person", "sunset"], 2),
                                             (None, 3)])
def test_tags_match_jax_on_its_tiny_checkpoint(tiny_clip, custom, max_tags):  # noqa: F811
    for seed in range(3):
        assert_same_tags(*both_tags(image(48, 64, seed), custom, max_tags))


@pytest.mark.parametrize("custom,max_tags", [(None, 10), (["golden hour", "dog", "sky", "cat",
                                                           "person"], 2), (None, 4)])
def test_tags_match_jax_on_a_seeded_checkpoint(seeded_clip, custom, max_tags):
    from rapidraw_tpu_torch.ai.tag_data import TAG_CANDIDATES

    for seed in range(3):
        want, got, near = both_tags(image(80, 120, seed + 10), custom, max_tags)
        assert_same_tags(want, got, near)
        if custom is None:  # the labels pass the threshold here, not only colours
            assert len(set(got) & set(TAG_CANDIDATES)) >= min(max_tags, 3)


def test_missing_checkpoint_raises_as_jax(tmp_path, monkeypatch):
    from rapidraw_tpu.ai.models import ModelUnavailable as JUnavailable
    from rapidraw_tpu_torch.ai.models import ModelUnavailable

    monkeypatch.setenv("RAPIDRAW_CLIP", str(tmp_path / "nope"))
    with pytest.raises(JUnavailable) as want:
        jtg.generate_tags_with_clip(image(20, 30, 0))
    with pytest.raises(ModelUnavailable) as got:
        ttg.generate_tags_with_clip(image(20, 30, 0), device="cpu")
    assert str(got.value) == str(want.value)
    monkeypatch.delenv("RAPIDRAW_CLIP")
    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path / "models"))
    assert ttg._clip_dir() == jtg._clip_dir() == tmp_path / "models" / "clip"


def test_model_cache_keys_on_files_and_device(seeded_clip):
    a, _ = ttg._load_clip("cpu")
    assert ttg._load_clip("cpu")[0] is a
    cfg = seeded_clip / "config.json"
    cfg.write_text(cfg.read_text())  # a new mtime: read again
    b, _ = ttg._load_clip("cpu")
    assert b is not a and len(ttg._CLIP_CACHE) == 1
    assert ttg._load_clip("meta")[0] is not b and len(ttg._CLIP_CACHE) == 1  # one at a time


# ----------------------------------------------------------------- the walk
def library(root: Path) -> dict:
    """Twin folders, "jax" and "port", of the walk's files."""
    from PIL import Image

    from rapidraw_tpu_torch.library.catalog import add_tags

    base = root / "base"
    base.mkdir()

    def rgb8(h, w, seed):
        return (np.clip(image(h, w, seed), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)

    Image.fromarray(rgb8(40, 56, 0)).save(base / "a.jpg", quality=95)
    Image.fromarray(rgb8(48, 36, 1)).save(base / "b.png")
    Image.fromarray(rgb8(30, 44, 2)).save(base / "c.tif")
    Image.fromarray(rgb8(480, 730, 3)).save(base / "big.jpg", quality=90)
    Image.fromarray(rgb8(32, 40, 4)).save(base / "d.bmp")
    Image.fromarray(rgb8(36, 36, 5)).save(base / "tagged.jpg", quality=95)
    Image.fromarray(rgb8(36, 44, 6)).save(base / "mine.jpg", quality=95)
    cfa = chip_smoke.photo_cfa(64, 96, chip_smoke.RAW_BLACK, chip_smoke.RAW_WHITE, 7)
    (base / "e.dng").write_bytes(chip_smoke.raw_dng_bytes(cfa))
    add_tags(str(base / "tagged.jpg"), ["sunset", "user:trip"])
    add_tags(str(base / "mine.jpg"), ["user:trip", "color:red"])
    return {side: shutil.copytree(base, root / side) for side in ("jax", "port")}


def sidecars(root: Path) -> dict:
    return {p.name: json.loads(p.read_text()) for p in sorted(root.glob("*.rrdata"))}


@pytest.mark.parametrize("checkpoint,custom", [("tiny_clip", None),
                                               ("tiny_clip", ["dog", "person", "sunset"]),
                                               ("seeded_clip", None)])
def test_index_folder_tags_matches_jax(request, tmp_path, checkpoint, custom):
    request.getfixturevalue(checkpoint)
    d = library(tmp_path)
    seen = {"jax": [], "port": []}
    with jax.disable_jit():
        nj = jtg.index_folder_tags(str(d["jax"]), custom, 4,
                                   progress=lambda c, t: seen["jax"].append((c, t)))
    np_ = ttg.index_folder_tags(str(d["port"]), custom, 4,
                                progress=lambda c, t: seen["port"].append((c, t)), device="cpu")
    sj, sp = sidecars(d["jax"]), sidecars(d["port"])
    # the .bmp: JAX's PIL decodes it, and so does the port's loader
    assert "d.bmp.rrdata" in sj and "d.bmp.rrdata" in sp
    assert nj == np_ == 7
    assert seen["port"] == seen["jax"] == [(i, 8) for i in range(1, 9)]
    assert sp.keys() == sj.keys()
    assert sp["tagged.jpg.rrdata"]["tags"] == ["sunset", "user:trip"]  # skipped: it has AI tags
    assert sp["mine.jpg.rrdata"]["tags"][:2] == ["user:trip", "color:red"]
    for name in sp:
        assert sp[name] == sj[name], (name, sp[name], sj[name])
    print({k: v["tags"] for k, v in sp.items()})


def test_index_folder_tags_cancel_and_missing_checkpoint(tiny_clip,  # noqa: F811
                                                         tmp_path, monkeypatch):
    from rapidraw_tpu_torch.ai.models import ModelUnavailable
    from rapidraw_tpu_torch.utils.recovery import CancellationToken

    d = library(tmp_path)["port"]
    token = CancellationToken()
    seen = []

    def progress(c, t):
        seen.append((c, t))
        if c == 2:
            token.cancel()

    assert ttg.index_folder_tags(str(d), progress=progress, cancel=token, device="cpu") == 2
    assert seen == [(1, 8), (2, 8)]  # a.jpg, big.jpg tagged; the walk stopped there
    assert ttg.index_folder_tags(str(d), cancel=token, device="cpu") == 0
    monkeypatch.setenv("RAPIDRAW_CLIP", str(tmp_path / "nope"))
    with pytest.raises(ModelUnavailable):  # the whole walk stops, not one image
        ttg.index_folder_tags(str(d), device="cpu")


def test_clear_tags_match_jax(tmp_path):
    from rapidraw_tpu_torch.library.catalog import add_tags

    base = tmp_path / "base"
    (base / "sub").mkdir(parents=True)
    for name, tags in (("a.jpg", ["dog", "user:x", "color:red", "blue"]), ("b.jpg", ["cat"]),
                       ("sub/c.jpg", ["user:y"]), ("sub/d.jpg", [])):
        (base / name).write_bytes(b"")
        add_tags(str(base / name), tags)
    (base / "bad.jpg.rrdata").write_text("{not json")
    for fn in ("clear_ai_tags", "clear_all_tags"):
        dj, dp = (shutil.copytree(base, tmp_path / fn / side) for side in ("jax", "port"))
        assert getattr(ttg, fn)(str(dp)) == getattr(jtg, fn)(str(dj))
        assert {p.relative_to(dp): p.read_bytes() for p in dp.rglob("*") if p.is_file()} == \
            {p.relative_to(dj): p.read_bytes() for p in dj.rglob("*") if p.is_file()}
    with pytest.raises(FileNotFoundError):
        ttg.clear_ai_tags(str(tmp_path / "nope"))
