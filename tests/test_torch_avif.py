"""The port's AVIF writer (io/avif.py, ctypes to a system libavif) against
PIL 12.1's AVIF plugin (its bundled libavif 1.3.0 with aom 3.12.1), which
the JAX package's export calls.

Both struct layouts are driven here: the system's libavif 0.11.1 (found by
name, as the export finds it) and PIL's bundled 1.3.0 (opened by path with
`load_library`). For each: PIL opens the port's file at the frame's size,
its PSNR is within 0.5 dB of PIL's file at the same quality, the `ispe`,
`pixi`, `av1C` (profile, subsampling) and `colr` nclx boxes equal PIL's,
and q 100 is larger than q 60 (as tests/test_export_pipeline.py expects of
JAX's). With PIL's own libavif the file is PIL's byte for byte. Without a
libavif the port raises the JAX package's ValueError.
"""

from __future__ import annotations

import io
import math
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from rapidraw_tpu.io import encode as jencode
from rapidraw_tpu.io import exif as jexif
from rapidraw_tpu_torch.io import avif, encode, exif
from rapidraw_tpu_torch.io.loader import to_uint8_hwc
from rapidraw_tpu_torch.pipeline import export
from test_torch_encode import photo_u8

jax.config.update("jax_platforms", "cpu")

PSNR_SLACK = 0.5  # dB between the port's file and PIL's at one quality
SYSTEM = "libavif.so.15"  # libavif 0.11.1 (aom 3.6.0), no headers
PIL_LIB = next((Path(Image.__file__).parent.parent / "pillow.libs").glob("libavif-*.so*"), None)
LIBS = {"system-0.11": SYSTEM, "pil-1.3": str(PIL_LIB)}


def pil_avif(img: np.ndarray, q: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", quality=q)
    return buf.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    assert im.format == "AVIF"
    return np.asarray(im.convert("RGB"))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(255.0 ** 2 / mse) if mse else math.inf


def boxes(data: bytes, start: int = 0, end: int | None = None) -> dict:
    """ISOBMFF boxes by type, into meta, iprp and ipco."""
    end = len(data) if end is None else end
    out, pos = {}, start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        size = size or end - pos
        kind = kind.decode("latin-1")
        out[kind] = data[pos + head:pos + size]
        if kind in ("meta", "iprp", "ipco"):
            out.update(boxes(data, pos + head + (4 if kind == "meta" else 0), pos + size))
        pos += size
    return out


def properties(data: bytes) -> dict:
    b = boxes(data)
    av1c = b["av1C"]
    return {"ispe": b["ispe"], "pixi": b["pixi"], "colr": b["colr"],
            "av1C profile": av1c[1] >> 5, "av1C subsampling": (av1c[2] >> 2) & 0x7}


@pytest.fixture(scope="module", params=sorted(LIBS))
def lib(request):
    return avif.load_library(LIBS[request.param])


def test_libraries_load_with_their_layouts(lib):
    want = {"0.11": "0.11.", "1.x": "1."}[lib.layout.name]
    assert lib.version.startswith(want)


@pytest.mark.parametrize("q", [60, 90, 100])
def test_pil_opens_the_port_file_as_its_own(lib, q):
    img = photo_u8(96, 136, seed=q)
    got, want = lib.encode(img, q), pil_avif(img, q)
    px = pil_pixels(got)
    assert px.shape == img.shape
    p_got, p_want = psnr(px, img), psnr(pil_pixels(want), img)
    print(f"libavif {lib.version} q{q}: {len(got)} bytes, PSNR {p_got:.3f}; PIL's {len(want)} "
          f"bytes, {p_want:.3f}")
    assert abs(p_got - p_want) <= PSNR_SLACK
    assert properties(got) == properties(want)
    assert properties(got)["av1C subsampling"] == 0b011  # 4:2:0
    if lib.version == "1.3.0":
        assert got == want  # PIL's own library: the very same file
    assert np.array_equal(lib.decode(got), px)


def test_quality_100_is_larger_than_60(lib):
    img = photo_u8(64, 96, seed=1)
    assert len(lib.encode(img, 100)) > len(lib.encode(img, 60))


@pytest.mark.parametrize("q", [0, 37, 60, 90, 99, 100])
def test_quantizer_mapping_is_libavif_1x(q):
    """0.11 gets min = max quantizer ((100 - q) * 63 + 50) / 100: on 1.3.0,
    those quantizers (quality left unset) write the file `quality` does."""
    lib = avif.load_library(LIBS["pil-1.3"])
    img = photo_u8(48, 64, seed=q)
    assert lib.encode(img, q, quantizer=avif.quality_to_quantizer(q)) == lib.encode(img, q)


def test_encode_image_matches_jax(tmp_path):
    """Both packages' encode_image on one planar render (the port through
    the system libavif, JAX through PIL): same size and properties, PSNR
    within the slack, q 100 above q 60 (test_export_pipeline.py:158)."""
    planar = (chip_smoke.ldr_rgb16(80, 120, 9).transpose(2, 0, 1) / 65535.0).astype(np.float32)
    img = to_uint8_hwc(planar)
    for q in (60, 100):
        jencode.encode_image(planar, tmp_path / f"j{q}.avif", "avif", q)
        encode.encode_image(planar, tmp_path / f"p{q}.avif", "avif", q)
        want, got = (tmp_path / f"j{q}.avif").read_bytes(), (tmp_path / f"p{q}.avif").read_bytes()
        assert properties(got) == properties(want)
        assert abs(psnr(pil_pixels(got), img) - psnr(pil_pixels(want), img)) <= PSNR_SLACK
    assert (tmp_path / "p100.avif").stat().st_size > (tmp_path / "p60.avif").stat().st_size


def test_without_libavif_raises_as_jax(tmp_path, monkeypatch):
    planar = np.zeros((3, 8, 8), np.float32)
    monkeypatch.setattr(avif, "available", lambda: False)
    monkeypatch.delitem(Image.SAVE, "AVIF")
    with pytest.raises(ValueError, match="format 'avif' not supported by this PIL build"):
        jencode.encode_image(planar, tmp_path / "j.avif", "avif", 90)
    with pytest.raises(ValueError, match="format 'avif' not supported by this PIL build"):
        encode.encode_image(planar, tmp_path / "p.avif", "avif", 90)
    assert not (tmp_path / "p.avif").exists()


def test_other_libraries_are_refused(monkeypatch):
    """A library that is not libavif, or a libavif of a version without a
    layout here, does not load; with none found, available() is False."""
    with pytest.raises(OSError):
        avif.load_library("libwebp.so.7")
    with pytest.raises(OSError):
        avif.load_library(str(Path(avif.__file__).with_name("no_such_libavif.so")))
    monkeypatch.setattr(avif.Libavif, "_layout_for", staticmethod(lambda version: None))
    with pytest.raises(OSError, match="no struct layout"):
        avif.load_library(SYSTEM)
    avif._default.cache_clear()
    try:
        assert not avif.available() and avif.version() is None
    finally:
        monkeypatch.undo()
        avif._default.cache_clear()
    assert avif.available()


def test_negative_quality_raises_as_pil(tmp_path):
    planar = np.zeros((3, 8, 8), np.float32)
    with pytest.raises(ValueError) as want:
        jencode.encode_image(planar, tmp_path / "j.avif", "avif", -5)
    with pytest.raises(ValueError) as got:
        encode.encode_image(planar, tmp_path / "p.avif", "avif", -5)
    assert str(got.value) == str(want.value)


def test_estimate_probes_an_avif(tmp_path, monkeypatch):
    """The estimate is its probe's AVIF size times the file count."""
    p = tmp_path / "a.dng"
    p.write_bytes(chip_smoke.raw_dng_bytes(chip_smoke.photo_cfa(64, 96, 64, 16383, 3)))
    probes = []
    real = encode.encode_image

    def spy(planar, path, fmt=None, quality=90):
        probes.append(np.array(planar))
        return real(planar, path, fmt, quality)

    monkeypatch.setattr(encode, "encode_image", spy)
    got = export.estimate_export_sizes([str(p)] * 3, export.ExportSettings(format="avif",
                                                                            quality=70),
                                       device="cpu")
    [planar] = probes
    assert got == len(avif.encode_avif(to_uint8_hwc(planar), 70)) * 3


def test_copy_exif_refuses_the_avif_as_jax(tmp_path):
    src = tmp_path / "shot.dng"
    cfa = np.random.default_rng(1).integers(64, 16383, (32, 48), dtype=np.uint16)
    src.write_bytes(chip_smoke.raw_dng_bytes(cfa, orientation=6, meta=chip_smoke.EXPORT_META))
    planar = np.random.default_rng(2).random((3, 20, 30), dtype=np.float32)
    jencode.encode_image(planar, tmp_path / "j.avif", "avif", 90)
    encode.encode_image(planar, tmp_path / "p.avif", "avif", 90)
    before = (tmp_path / "p.avif").read_bytes()
    assert exif.copy_exif(src, tmp_path / "p.avif") is False
    assert jexif.copy_exif(src, tmp_path / "j.avif") is False
    assert (tmp_path / "p.avif").read_bytes() == before


def test_cli_export_writes_an_avif_pil_opens(tmp_path):
    """`python -m rapidraw_tpu_torch export --format avif` on the CPU."""
    from rapidraw_tpu_torch import cli

    src = tmp_path / "a.dng"
    src.write_bytes(chip_smoke.raw_dng_bytes(chip_smoke.photo_cfa(64, 96, 64, 16383, 4)))
    assert cli.main(["export", str(src), "-o", str(tmp_path / "out"), "--format", "avif",
                     "--device", "cpu"]) in (0, None)
    [out] = sorted((tmp_path / "out").glob("*.avif"))
    assert Image.open(out).size == (96, 64)
    assert properties(out.read_bytes())["colr"] == bytes.fromhex("6e636c780001000d000680")
