"""The port's community presets (rapidraw_tpu_torch/library/community.py)
against the JAX package's: tests/test_community_presets.py's cases on
both, every fetch through an injected fetcher (no test reaches the
network). The stored preset JSON equals JAX's byte for byte (each side's
uuid4 pinned to the same sequence); the preview strips' u8 frames follow
the preview service's rule (tests/test_torch_service.py::_same_frames):
within 1 LSB on <= 0.1% of values of JAX's op-by-op develop, the JPEG
bytes equal where the frames are. The port runs on the CPU.
"""

from __future__ import annotations

import io
import json
import uuid

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.library import community as jcom
from rapidraw_tpu.library import presets as jpresets
from rapidraw_tpu_torch.library import community as pcom
from rapidraw_tpu_torch.library import presets as ppresets

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

MANIFEST = [
    {"name": "Teal Pop", "creator": "ann",
     "adjustments": {"exposure": 0.4, "saturation": 20, "toneMapper": "agx"}},
    {"name": "Mono", "adjustments": {"saturation": -100, "contrast": 25}},
    {"name": "Cropped", "author": "bo",
     "adjustments": {"crop": {"x": 10, "y": 5, "width": 60, "height": 50}, "exposure": -0.2}},
    {"name": "broken-no-adjustments"},
    "not an object",
]


@pytest.mark.parametrize("mod", [jcom, pcom], ids=["jax", "port"])
def test_parse_manifest_skips_malformed(mod):
    presets = mod.parse_manifest(json.dumps(MANIFEST))
    assert [p.name for p in presets] == ["Teal Pop", "Mono", "Cropped"]
    assert presets[0].creator == "ann" and presets[2].creator == "bo"
    with pytest.raises(ValueError):
        mod.parse_manifest(json.dumps({"name": "x"}))


def test_fetch_matches_jax_with_injected_fetcher():
    urls = []

    def fetcher(url):
        urls.append(url)
        return json.dumps(MANIFEST)

    got = pcom.fetch_community_presets(fetcher=fetcher)
    want = jcom.fetch_community_presets(fetcher=fetcher)
    assert [vars(p) for p in got] == [vars(p) for p in want]
    assert urls == [pcom.MANIFEST_URL, jcom.MANIFEST_URL] and pcom.MANIFEST_URL == jcom.MANIFEST_URL


def test_fetch_error_matches_jax():
    def boom(url):
        raise OSError("no egress")

    with pytest.raises(RuntimeError) as want:
        jcom.fetch_community_presets(fetcher=boom)
    with pytest.raises(RuntimeError) as got:
        pcom.fetch_community_presets(fetcher=boom)
    assert str(got.value) == str(want.value) and "manifest" in str(got.value)


@pytest.fixture
def frames(monkeypatch):
    """Each side's preview strips as its JPEG encoder receives them; JAX
    with one device."""
    from rapidraw_tpu.io import encode as jencode
    from rapidraw_tpu_torch.io import encode as pencode

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    got = {"jax": [], "port": []}

    def spy(real, key):
        def encode(planar, *a, **kw):
            got[key].append((np.clip(np.asarray(planar), 0, 1) * 255 + 0.5).astype(np.uint8))
            return real(planar, *a, **kw)
        return encode

    monkeypatch.setattr(jencode, "encode_jpeg_bytes", spy(jencode.encode_jpeg_bytes, "jax"))
    monkeypatch.setattr(pencode, "encode_jpeg_bytes", spy(pencode.encode_jpeg_bytes, "port"))
    return got


def test_previews_match_jax(tmp_path, frames):
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(80, 120, 3), (150, 100, 3)]):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(p, quality=95)
        paths.append(str(p))
    with jax.disable_jit():
        want = jcom.generate_community_previews(paths, jcom.parse_manifest(json.dumps(MANIFEST)),
                                                tile_dim=32)
    got = pcom.generate_community_previews(paths, pcom.parse_manifest(json.dumps(MANIFEST)),
                                           tile_dim=32, device="cpu")
    assert list(got) == list(want) == ["Teal Pop", "Mono", "Cropped"]
    assert len(frames["port"]) == len(frames["jax"]) == 3
    exact = True
    for g, w in zip(frames["port"], frames["jax"]):
        assert g.shape == w.shape
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert int(d.max()) <= 1 and (d > 0).mean() <= 1e-3
        exact = exact and not d.any()
    for name, jpeg in got.items():
        assert jpeg[:2] == b"\xff\xd8" and (jpeg == want[name] or not exact)
        im = Image.open(io.BytesIO(jpeg))
        assert im.size[0] == 2 * im.size[1]
    assert got["Teal Pop"] != got["Mono"]


def _ids(monkeypatch):
    """Both stores' uuid4 from one fresh sequence."""
    seq = iter(uuid.UUID(int=i) for i in range(1, 1000))
    monkeypatch.setattr(uuid, "uuid4", lambda: next(seq))


def test_install_writes_jaxs_bytes(tmp_path, monkeypatch):
    files = {}
    for name, com, presets in (("jax", jcom, jpresets), ("port", pcom, ppresets)):
        _ids(monkeypatch)
        path = tmp_path / name / "presets.json"
        store = presets.PresetStore(path)
        mine = store.add("Portrait", {"exposure": 0.5}, folder=None)
        e1 = com.save_community_preset(store, "Teal Pop", {"exposure": 0.4, "saturation": 20})
        assert e1["folder"] == "Community" and e1["presetType"] == "style"
        com.save_community_preset(store, "Teal Pop", {"exposure": 1.0}, include_masks=True,
                                  preset_type="tool")
        com.save_community_preset(store, "Portrait", {"exposure": -1.0},
                                  include_crop_transform=False)
        assert store.get("Portrait")["id"] == mine["id"]  # the user's wins by order
        comm = [p for p in store.list() if p.get("folder") == "Community"]
        assert [p["name"] for p in comm] == ["Teal Pop", "Portrait"]
        assert presets.PresetStore(path).get("Teal Pop")["adjustments"] == {"exposure": 1.0}
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"]


def test_previews_default_to_the_card(tmp_path):
    """No device: the CUDA device, which this machine lacks; it fails."""
    assert not torch.cuda.is_available()
    p = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(p)
    with pytest.raises((RuntimeError, AssertionError)):
        pcom.generate_community_previews([str(p)], pcom.parse_manifest(json.dumps(MANIFEST)))
