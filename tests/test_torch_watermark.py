"""The export's watermark (pipeline/watermark.py) and the 8-bit Lanczos
under it (geometry/resize.lanczos_resize_u8) against PIL and the JAX
package.

- `lanczos_resize_u8` equals PIL's `resize(..., LANCZOS)` on modes "L" and
  "RGBA", up and down, one axis or both, with alpha 0, 255 and partial.
- `apply_watermark` equals JAX's (PIL's convert("RGBA") and LANCZOS under
  it) bit for bit: the nine anchors, an oversize watermark, opacity 0, 37
  and 100, and watermarks that are RGB, RGBA, grey, grey with alpha,
  palette with tRNS, JPEG and TIFF files.
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from rapidraw_tpu.pipeline import watermark as jwatermark
from rapidraw_tpu_torch.geometry.resize import lanczos_resize_u8
from rapidraw_tpu_torch.pipeline import watermark


def _rgba(h, w, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[: h // 4, :, 3] = 0
    px[h // 4: h // 2, :, 3] = 255
    return px


@pytest.mark.parametrize("mode", ["L", "RGBA"])
@pytest.mark.parametrize("size", [(61, 43), (7, 5), (23, 17), (23, 40), (90, 17), (23, 17 * 3)])
def test_lanczos_u8_matches_pil(mode, size):
    src = _rgba(17, 23, 3)
    if mode == "L":
        src = src[..., 0]
    want = np.asarray(Image.fromarray(src, mode).resize(size, Image.LANCZOS))
    got = lanczos_resize_u8(src, *size)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _sources(tmp_path) -> dict:
    """Watermark files of every kind, written by PIL."""
    rng = np.random.default_rng(7)
    rgba = _rgba(30, 44, 1)
    out = {}
    for name, im in (
        ("rgba.png", Image.fromarray(rgba, "RGBA")),
        ("rgb.png", Image.fromarray(rgba[..., :3], "RGB")),
        ("grey.png", Image.fromarray(rgba[..., 0], "L")),
        ("la.png", Image.fromarray(rgba[..., [0, 3]], "LA")),
        ("rgb.jpg", Image.fromarray(rgba[..., :3], "RGB")),
        ("rgba.tif", Image.fromarray(rgba, "RGBA")),
    ):
        im.save(tmp_path / name)
        out[name] = tmp_path / name
    pal = Image.fromarray(rng.integers(0, 6, (30, 44)).astype(np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 18).tolist())
    pal.save(tmp_path / "pal.png", transparency=bytes([0, 90, 255, 30]))
    out["pal.png"] = tmp_path / "pal.png"
    return out


def _base(h=120, w=90):
    rng = np.random.default_rng(11)
    return rng.random((3, h, w), dtype=np.float32)


def _both(planar, **kw):
    want = jwatermark.apply_watermark(planar, jwatermark.WatermarkSettings(**kw))
    got = watermark.apply_watermark(planar, watermark.WatermarkSettings(**kw))
    return got, want


@pytest.mark.parametrize("anchor", watermark.ANCHORS)
def test_watermark_anchor_matches_jax(anchor, tmp_path):
    path = str(_sources(tmp_path)["rgba.png"])
    got, want = _both(_base(), path=path, anchor=anchor, scale=23.0, spacing=3.0,
                      opacity=80.0)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, _base())


@pytest.mark.parametrize("source", ["rgba.png", "rgb.png", "grey.png", "la.png", "pal.png",
                                    "rgb.jpg", "rgba.tif"])
@pytest.mark.parametrize("opacity", [0.0, 37.0, 100.0])
def test_watermark_source_matches_jax(source, opacity, tmp_path):
    path = str(_sources(tmp_path)[source])
    got, want = _both(_base(77, 130), path=path, anchor="center", scale=31.0,
                      opacity=opacity)
    assert np.array_equal(got, want)


def test_oversize_watermark_matches_jax(tmp_path):
    """Scaled past the image (the centred offset negative): cropped alike."""
    path = str(_sources(tmp_path)["rgba.png"])
    for anchor in ("center", "bottomRight", "topLeft"):
        got, want = _both(_base(40, 64), path=path, anchor=anchor, scale=250.0, spacing=5.0)
        assert np.array_equal(got, want)


def test_watermark_rgba_decode_matches_pil(tmp_path):
    for name, path in _sources(tmp_path).items():
        want = np.asarray(Image.open(path).convert("RGBA"))
        assert np.array_equal(watermark.decode_rgba(path.read_bytes()), want), name
