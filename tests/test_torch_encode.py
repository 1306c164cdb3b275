"""The port's image writers and resizes against PIL, cv2 and the JAX package.

- `native.jpeg_encode` (csrc/host/jpeg_enc.cc) against PIL's
  `Image.save(..., "JPEG", quality=q)` on the same seeded u8 image: the
  files must be byte for byte the same (so the decoded pixels are too);
- PNG and TIFF from `io/encode.encode_image` against the JAX package's
  (TIFF through PIL's IFD writer, 16-bit PNG through cv2): pixels equal as
  cv2 decodes them, TIFF files byte for byte;
- `read_tiff16_rgb` on `write_tiff16`'s files, both packages' either way;
- the Lanczos3 resize against PIL's 'F'-mode resize (bar 1e-5; it is
  exact), `downscale` against JAX's (bar 1e-6);
- JPEG XL without a libjxl raises the JAX package's ValueError (WebP and
  AVIF: tests/test_torch_webp_enc.py, tests/test_torch_avif.py).
"""

from __future__ import annotations

import io
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rapidraw_tpu.geometry import resize as jresize
from rapidraw_tpu.io import encode as jencode
from rapidraw_tpu.io import jxl as jjxl
from rapidraw_tpu.pipeline import export as jexport
from rapidraw_tpu_torch import native
from rapidraw_tpu_torch.geometry import resize
from rapidraw_tpu_torch.io import encode, jxl
from rapidraw_tpu_torch.pipeline import export

jax.config.update("jax_platforms", "cpu")

LANCZOS_TOL = 1e-5  # against PIL 'F' (float64 sums in PIL's order: exact here)
DOWNSCALE_TOL = 1e-6  # against JAX's f32 matmuls (the port sums in float64)


def photo_u8(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) u8: gradients plus seeded noise (smooth and busy blocks)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     (xx + yy) % 256], axis=-1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, q: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=q)
    return buf.getvalue()


def decoded(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int32)


@pytest.mark.parametrize("q", [60, 90, 100])
@pytest.mark.parametrize("shape", [(1024, 1536), (1001, 1503)])
def test_jpeg_encoder_matches_pil(shape, q):
    """The bar is decoded pixels equal on >= 99.9% of values with max |d|
    <= 2; the encoder meets it with the very same file (ragged sizes pad
    partial MCUs as libjpeg does)."""
    img = photo_u8(*shape, seed=q)
    want = pil_jpeg(img, q)
    got = native.jpeg_encode(img, q)
    d = np.abs(decoded(got) - decoded(want))
    assert (d == 0).mean() >= 0.999 and d.max() <= 2
    assert got == want


@pytest.mark.parametrize("q", [1, 10, 49, 50, 75, 95])
@pytest.mark.parametrize("shape", [(1, 1), (8, 8), (17, 9), (15, 33), (64, 96)])
def test_jpeg_encoder_matches_pil_at_every_quality_scaling(shape, q):
    """Both branches of jpeg_quality_scaling (q < 50), the clamp to 255 and
    images smaller than one MCU."""
    img = photo_u8(*shape, seed=7)
    assert native.jpeg_encode(img, q) == pil_jpeg(img, q)


def test_jpeg_encoder_refuses_what_it_cannot_encode():
    # (H, W) grey is encodable since the one-component mode; RGBA is not
    with pytest.raises(ValueError, match="expects"):
        native.jpeg_encode(np.zeros((4, 4, 4), np.uint8), 90)
    with pytest.raises(ValueError, match="expects"):
        native.jpeg_encode(np.zeros((4, 4, 3), np.uint16), 90)
    with pytest.raises(ValueError, match="expects"):
        native.jpeg_encode(np.zeros((4, 4), np.uint16), 90)
    with pytest.raises(ValueError, match="failed"):
        native.jpeg_encode(np.zeros((4, 70000, 3), np.uint8), 90)
    with pytest.raises(ValueError, match="failed"):
        native.jpeg_encode(np.zeros((4, 70000), np.uint8), 90)


def test_jpeg_encoder_builds_from_its_source():
    lib = native.host_library("jpeg_enc")
    assert Path(lib._name).parent == native.BUILD_DIR
    assert Path(lib._name).name.startswith("libjpeg_enc_host_")
    assert hasattr(lib, "jpeg_encode_rgb") and hasattr(lib, "jpeg_fetch")
    assert hasattr(lib, "jpeg_encode_gray")


def test_a_failed_jpeg_encoder_build_raises(tmp_path, monkeypatch):
    """A jpeg_enc.cc that does not compile raises KernelBuildError; no
    library is published and nothing stands in for the encoder."""
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "jpeg_enc.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_host_libs", {})
    with pytest.raises(native.KernelBuildError, match="g\\+\\+ failed on jpeg_enc.cc"):
        native.jpeg_encode(photo_u8(8, 8, 0), 90)
    assert not list((tmp_path / "_build").glob("*.so*"))


def test_jpeg_encoder_threads_encode_in_parallel():
    """The ctypes call releases the GIL: threads' files are each their
    own (the output buffer is per thread)."""
    from concurrent.futures import ThreadPoolExecutor

    imgs = [photo_u8(96, 128, s) for s in range(8)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda a: native.jpeg_encode(a, 85), imgs))
    assert got == [pil_jpeg(a, 85) for a in imgs]


SOURCES = {  # name -> a render as export hands it to encode_image
    "f32": lambda rng: rng.random((3, 37, 53), dtype=np.float32) * 1.2 - 0.1,
    "u8": lambda rng: rng.integers(0, 256, (3, 37, 53), dtype=np.uint8),
    "u16": lambda rng: rng.integers(0, 65536, (3, 37, 53), dtype=np.uint16),
    "u8_hwc": lambda rng: rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
}


@pytest.mark.parametrize("src", sorted(SOURCES))
@pytest.mark.parametrize("fmt", ["png", "tiff", "jpg"])
def test_encode_image_matches_jax(fmt, src, tmp_path):
    """The same pixels and depth as the JAX package's file (16-bit PNG and
    TIFF for float and u16 renders, 8-bit PNG for u8 ones): decoded by cv2
    unchanged, equal; TIFF and JPEG files equal byte for byte."""
    planar = SOURCES[src](np.random.default_rng(3))
    want, got = tmp_path / f"want.{fmt}", tmp_path / f"got.{fmt}"
    jencode.encode_image(planar, want, fmt, 90)
    encode.encode_image(planar, got, fmt, 90)
    a = cv2.imread(str(want), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(got), cv2.IMREAD_UNCHANGED)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)
    if fmt != "png":
        assert got.read_bytes() == want.read_bytes()


def test_encode_jpeg_bytes_matches_jax():
    planar = np.random.default_rng(4).random((3, 40, 61), dtype=np.float32)
    assert encode.encode_jpeg_bytes(planar, 85) == jencode.encode_jpeg_bytes(planar, 85)


def test_tiff16_round_trips_both_ways(tmp_path):
    """read_tiff16_rgb reads write_tiff16's files, with extra tags, and each
    package reads the other's."""
    arr = np.random.default_rng(5).integers(0, 65536, (21, 34, 3), dtype=np.uint16)
    tags = {271: "Maker", 305: "rapidraw", 282: 300.0, 0x0112: 1, 0x9003: "2024:01:02 03:04:05"}
    encode.write_tiff16(tmp_path / "p.tif", arr, extra_tags=tags)
    jencode.write_tiff16(tmp_path / "j.tif", arr, extra_tags=tags)
    assert (tmp_path / "p.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    for name in ("p.tif", "j.tif"):
        assert np.array_equal(encode.read_tiff16_rgb(tmp_path / name), arr)
        assert np.array_equal(jencode.read_tiff16_rgb(tmp_path / name), arr)


def test_read_tiff16_returns_none_for_other_files(tmp_path):
    Image.fromarray(photo_u8(8, 8, 1)).save(tmp_path / "a8.tif")
    (tmp_path / "a.png").write_bytes(encode.png_bytes(photo_u8(8, 8, 1)))
    for name in ("a8.tif", "a.png"):
        assert encode.read_tiff16_rgb(tmp_path / name) is None
        assert jencode.read_tiff16_rgb(tmp_path / name) is None
    (tmp_path / "bad.tif").write_bytes(b"II*\x00\x08\x00\x00\x00\x00\x00")
    with pytest.raises(ValueError):
        encode.read_tiff16_rgb(tmp_path / "bad.tif")
    with pytest.raises(Exception):
        jencode.read_tiff16_rgb(tmp_path / "bad.tif")


def test_jxl_without_libjxl_raises_as_jax(tmp_path, monkeypatch):
    planar = np.zeros((3, 8, 8), np.float32)
    monkeypatch.setattr(jxl, "available", lambda: False)
    monkeypatch.setattr(jjxl, "available", lambda: False)
    with pytest.raises(ValueError, match="format 'jxl' not supported by this PIL build"):
        jencode.encode_image(planar, tmp_path / "j.jxl", "jxl", 90)
    with pytest.raises(ValueError, match="format 'jxl' not supported by this PIL build"):
        encode.encode_image(planar, tmp_path / "p.jxl", "jxl", 90)


@pytest.mark.skipif(not jjxl.available(), reason="no system libjxl on this machine")
@pytest.mark.parametrize("q", [80, 100])
def test_jxl_matches_jax(q, tmp_path):
    planar = np.random.default_rng(6).random((3, 24, 40), dtype=np.float32)
    jencode.encode_image(planar, tmp_path / "j.jxl", "jxl", q)
    encode.encode_image(planar, tmp_path / "p.jxl", "jxl", q)
    assert (tmp_path / "p.jxl").read_bytes() == (tmp_path / "j.jxl").read_bytes()


@pytest.mark.parametrize("size", [(50, 37), (131, 97), (262, 194), (60, 150), (1, 1)],
                         ids=["down", "same_width", "up", "mixed", "to_one"])
def test_lanczos_matches_pil(size):
    """Down (2.6x), one axis only, up (2x), down one way and up the other."""
    img = np.random.default_rng(7).random((3, 97, 131), dtype=np.float32)
    nw, nh = size
    want = np.stack([np.asarray(Image.fromarray(img[c], mode="F").resize(size, Image.LANCZOS))
                     for c in range(3)])
    got = resize.lanczos_resize(torch.from_numpy(img), nw, nh).numpy()
    assert got.shape == want.shape == (3, nh, nw)
    assert float(np.abs(got - want).max()) <= LANCZOS_TOL


@pytest.mark.parametrize("mode", ["longEdge", "shortEdge", "width", "height"])
def test_export_resize_matches_jax(mode):
    """_resize_host: the target size of calculate_resize_target, the
    resample and the clamp, on a u8 readback scaled as export scales it."""
    q = np.random.default_rng(8).integers(0, 256, (3, 90, 140), dtype=np.uint8)
    planar = q.astype(np.float32) / np.float32(255.0)
    for value, enlarge in ((64, False), (200, True), (100, False)):
        jst = jexport.ExportSettings(long_edge=value, resize_mode=mode, dont_enlarge=not enlarge)
        pst = export.ExportSettings(long_edge=value, resize_mode=mode, dont_enlarge=not enlarge)
        want = jexport._resize_host(planar, jst)
        got = export._resize_host(planar, pst)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= LANCZOS_TOL
        assert got.min() >= 0.0 and got.max() <= 1.0


def test_resize_target_matches_jax():
    modes = ["longEdge", "shortEdge", "width", "height", "bogus", None]
    for w, h in [(6144, 4096), (4096, 6144), (1000, 1000), (33, 2000)]:
        for mode in modes:
            for value in (0, 1, 500, 2048, 5000, 9000):
                for enlarge in (False, True):
                    kw = dict(long_edge=value or None, resize_mode=mode, dont_enlarge=not enlarge)
                    assert export.calculate_resize_target(w, h, export.ExportSettings(**kw)) == \
                        jexport.calculate_resize_target(w, h, jexport.ExportSettings(**kw))


@pytest.mark.parametrize("target", [(40, 30), (100, 20), (131, 97), (7, 90), (200, 200)])
def test_downscale_matches_jax(target):
    img = np.random.default_rng(9).random((3, 97, 131), dtype=np.float32)
    want = np.asarray(jresize.downscale(img, *target))
    got = resize.downscale(torch.from_numpy(img), *target).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= DOWNSCALE_TOL


@pytest.mark.parametrize("edge", [50, 97, 131, 500])
def test_downscale_to_long_edge_matches_jax(edge):
    img = np.random.default_rng(10).random((3, 131, 97), dtype=np.float32)
    want = np.asarray(jresize.downscale_to_long_edge(img, edge))
    got = resize.downscale_to_long_edge(torch.from_numpy(img), edge).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= DOWNSCALE_TOL


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "LA", "RGB16"])
def test_png_decoder_reads_like_pil(mode, tmp_path):
    """decode_png_rgb against PIL's open(...).convert('RGB') on PIL's own
    files (its adaptive row filters), every colour type and 16-bit."""
    img = photo_u8(33, 45, seed=11)
    if mode == "RGB16":
        path = tmp_path / "a.png"
        cv2.imwrite(str(path), (img.astype(np.uint16) * 257 + 3)[..., ::-1])
    else:
        im = Image.fromarray(img)
        im = im.convert(mode) if mode != "P" else im.quantize(64)
        path = tmp_path / "a.png"
        im.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(encode.decode_png_rgb(path.read_bytes()), want)


def test_hald_png_lut_parses_as_jax(tmp_path):
    """A HALD LUT read without PIL (the port once imported it for these,
    which the card's machine lacks): the same cube as JAX's parse, from a
    PNG and (since the LDR loader) from a JPEG."""
    from rapidraw_tpu.io import lut as jlut
    from rapidraw_tpu_torch.io import lut

    side = 64  # a 16^3 cube
    hald = (np.arange(side * side * 3) * 37 % 256).astype(np.uint8).reshape(side, side, 3)
    Image.fromarray(hald).save(tmp_path / "look.png")
    assert np.array_equal(lut.parse_lut_file(tmp_path / "look.png"),
                          jlut.parse_lut_file(tmp_path / "look.png"))
    Image.fromarray(hald).save(tmp_path / "look.jpg")
    assert np.array_equal(lut.parse_lut_file(tmp_path / "look.jpg"),
                          jlut.parse_lut_file(tmp_path / "look.jpg"))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "LA"])
def test_mask_data_urls_decode_as_jax(mode):
    """An AI mask's PNG data URL read without PIL, as JAX's convert('L')
    reads it (the port once imported PIL here, which the card's machine
    lacks, so AI masks came out empty there)."""
    import base64

    from rapidraw_tpu.masks import parametric as jparam
    from rapidraw_tpu_torch.masks import parametric

    img = photo_u8(21, 30, seed=12)
    im = Image.fromarray(img)
    im = im.convert(mode) if mode != "P" else im.quantize(32)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    assert np.array_equal(parametric._decode_data_url_gray(url), jparam._decode_data_url_gray(url))
    assert parametric._decode_data_url_gray("data:image/png;base64,!!") is None
    if mode in ("L", "RGB"):
        # the same image as a JPEG data URL (the port once refused these)
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=85)
        url = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()
        got = parametric._decode_data_url_gray(url)
        assert got is not None and np.array_equal(got, jparam._decode_data_url_gray(url))
        cut = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()[:200]).decode()
        assert parametric._decode_data_url_gray(cut) is None is jparam._decode_data_url_gray(cut)


def test_mask_overlay_matches_jax():
    """The overlay's RGBA PNG, decoded, equals JAX's (the port writes it
    with its own PNG writer)."""
    import base64

    from rapidraw_tpu.masks import rasterize as jrast
    from rapidraw_tpu_torch.masks import rasterize

    mask = {"visible": True, "subMasks": [{"type": "radial", "visible": True, "mode": "additive",
            "parameters": {"centerX": 40, "centerY": 30, "radiusX": 25, "radiusY": 15,
                           "rotation": 10, "feather": 0.4}}]}
    urls = [m.generate_mask_overlay(mask, 80, 60) for m in (rasterize, jrast)]
    pixels = [np.asarray(Image.open(io.BytesIO(base64.b64decode(u.split(",", 1)[1]))))
              for u in urls]
    assert pixels[0].shape == (60, 80, 4) and pixels[0][..., 3].max() > 0
    assert np.array_equal(pixels[0], pixels[1])


# ---- PNGs that PIL reads and PIL cannot write: built here with NumPy + zlib

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    import struct
    import zlib

    body = ctype + payload
    return (struct.pack(">I", len(payload)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _packed_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes): big-endian 16-bit, or sub-byte
    samples packed MSB first, each row padded to a whole byte."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.astype(np.int64) << shifts).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a random filter of the five (None, Sub, Up, Average,
    Paeth), so the decoder's every unfilter path runs."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), row])[:row.size]
        c = np.concatenate([np.zeros(bpp, np.int64), prior])[:row.size]
        pa, pb, pc = np.abs(prior - c), np.abs(a - c), np.abs(a + prior - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        ftype = int(rng.integers(0, 5))
        pred = (0, a, prior, (a + prior) // 2, paeth)[ftype]
        out.append(bytes([ftype]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def make_png(samples: np.ndarray, depth: int, ctype: int, interlace: bool, rng,
             plte: bytes | None = None, trns: bytes | None = None) -> bytes:
    """A PNG of (h, w, c) samples at this depth and colour type, plain or
    Adam7 (each non-empty pass filtered and packed on its own)."""
    import struct
    import zlib

    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7] if interlace
              else [samples])
    body = b"".join(_filtered(_packed_rows(p, depth), bpp, rng) for p in passes if p.size)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


def random_png(ctype: int, depth: int, interlace: bool, h: int, w: int, seed: int) -> bytes:
    """Seeded samples of every value the depth holds; a palette of random
    colours that leaves some indices past its end (PIL reads them black);
    16-bit grey with 0, 255, 256 and 65535 among its samples."""
    rng = np.random.default_rng(seed)
    if ctype == 3:
        plte = rng.integers(0, 256, (int(rng.integers(1, 2 ** depth + 1)), 3), np.uint8)
        return make_png(rng.integers(0, 2 ** depth, (h, w, 1)), depth, 3, interlace, rng,
                        plte=plte.tobytes())
    samples = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
    if depth == 16:
        samples[..., 0].flat[:4] = [0, 255, 256, 65535][:samples[..., 0].size]
    return make_png(samples, depth, ctype, interlace, rng)


def assert_reads_as_pil(data: bytes) -> None:
    im = Image.open(io.BytesIO(data))
    for mode, fn in (("RGB", encode.decode_png_rgb), ("L", encode.decode_png_gray)):
        want = np.asarray(im.convert(mode))
        got = fn(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, im.mode)
        assert np.array_equal(got, want), (mode, im.mode)


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
# ragged sizes below one 8 x 8 Adam7 block (some passes empty), then larger
PNG_SIZES = [(1, 1), (1, 7), (3, 5), (5, 2), (7, 9), (13, 17), (40, 33)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS, ids=[f"ct{c}-{d}bit" for c, d in PNG_KINDS])
def test_png_decoder_reads_every_png_as_pil(ctype, depth, interlace):
    """decode_png_rgb / decode_png_gray against PIL's convert('RGB') /
    convert('L') on every colour type at every bit depth it allows, plain
    and Adam7, at ragged sizes: 1/2/4-bit grey scaled to 0..255, 16-bit grey
    (PIL's "I;16") clamped to 255, 16-bit grey with alpha and 16-bit colour
    at their high byte, palette indices of every depth through PLTE."""
    for i, (h, w) in enumerate(PNG_SIZES):
        assert_reads_as_pil(random_png(ctype, depth, interlace, h, w, seed=100 * depth + i))


TRNS_CASES = [(0, 1, b"\x00\x01"), (0, 8, b"\x00\x07"), (0, 16, b"\x01\x00"),
              (2, 8, b"\x00\x01\x00\x02\x00\x03"), (2, 16, b"\x00\x01\x00\x02\x00\x03"),
              (3, 4, b"\x00\x80"), (3, 8, bytes(range(0, 200, 7)))]


@pytest.mark.parametrize("ctype,depth,trns", TRNS_CASES,
                         ids=[f"ct{c}-{d}bit" for c, d, _ in TRNS_CASES])
def test_png_transparency_reads_as_pil(ctype, depth, trns):
    """A tRNS chunk changes none of convert('RGB') / convert('L')'s values."""
    rng = np.random.default_rng(depth)
    if ctype == 3:
        plte = rng.integers(0, 256, (2 ** depth, 3), np.uint8).tobytes()
        data = make_png(rng.integers(0, 2 ** depth, (9, 11, 1)), depth, 3, True, rng,
                        plte=plte, trns=trns)
    else:
        data = make_png(rng.integers(0, 1 << depth, (9, 11, _CHANNELS[ctype])), depth, ctype,
                        False, rng, trns=trns)
    assert_reads_as_pil(data)


def test_invalid_png_raises_value_error():
    """Data that is no valid PNG raises ValueError (PIL refuses each too)."""
    import struct
    import zlib

    good = random_png(2, 8, False, 4, 4, seed=1)
    ihdr_at, idat_at = good.index(b"IHDR") - 4, good.index(b"IDAT") - 4
    iend = good[-12:]

    def with_ihdr(depth, ctype, interlace=0):
        ihdr = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
        return good[:ihdr_at] + _chunk(b"IHDR", ihdr) + good[ihdr_at + 25:]

    def with_rows(raw: bytes):
        return good[:idat_at] + _chunk(b"IDAT", zlib.compress(raw)) + iend

    cases = {
        "signature": b"\x89PNX" + good[4:],
        "no IHDR": good[:8] + good[ihdr_at + 25:],
        "RGB at 4 bits": with_ihdr(4, 2),
        "colour type 5": with_ihdr(8, 5),
        "interlace 2": with_ihdr(8, 2, 2),
        "palette without PLTE": with_ihdr(8, 3),
        "bad zlib": good[:idat_at] + _chunk(b"IDAT", b"\x78\x9c\xff\xff") + iend,
        "truncated rows": with_rows(b"\0" * 9),
        "filter type 7": with_rows(b"\x07" + b"\0" * 51),
    }
    for name, data in cases.items():
        with pytest.raises(ValueError):
            encode.decode_png_rgb(data)
        with pytest.raises(Exception):  # PIL refuses it too
            Image.open(io.BytesIO(data)).convert("RGB")


def test_interlaced_hald_png_lut_parses_as_jax(tmp_path):
    """An Adam7 HALD LUT (PIL writes none) through io/lut.parse_lut_file,
    against the JAX package's parse through PIL."""
    from rapidraw_tpu.io import lut as jlut
    from rapidraw_tpu_torch.io import lut

    side = 64  # a 16^3 cube
    hald = (np.arange(side * side * 3) * 37 % 256).reshape(side, side, 3)
    (tmp_path / "look.png").write_bytes(make_png(hald, 8, 2, True, np.random.default_rng(5)))
    got = lut.parse_lut_file(tmp_path / "look.png")
    assert got.shape == (16, 16, 16, 3)
    assert np.array_equal(got, jlut.parse_lut_file(tmp_path / "look.png"))


@pytest.mark.parametrize("kind", ["grey16", "grey16-alpha", "adam7", "grey2-adam7"])
def test_png_mask_data_urls_decode_as_jax(kind):
    """AI-mask data URLs that the port once refused: 16-bit grey (with and
    without alpha) and interlaced PNGs, against JAX's PIL decode."""
    import base64

    from rapidraw_tpu.masks import parametric as jparam
    from rapidraw_tpu_torch.masks import parametric

    ctype, depth, interlace = {"grey16": (0, 16, False), "grey16-alpha": (4, 16, False),
                               "adam7": (2, 8, True), "grey2-adam7": (0, 2, True)}[kind]
    url = "data:image/png;base64," + base64.b64encode(
        random_png(ctype, depth, interlace, 21, 30, seed=7)).decode()
    got = parametric._decode_data_url_gray(url)
    assert got is not None and got.shape == (21, 30)
    assert np.array_equal(got, jparam._decode_data_url_gray(url))
