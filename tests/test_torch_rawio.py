"""The port's RAW file input (rapidraw_tpu_torch.io, .utils.settings,
the host LJPEG decoder) against the JAX package's, on the CPU.

Host decode: `parse_dng` / `parse_raw` of the port and of the JAX package
on the same bytes, field for field, the CFA bit-equal (uncompressed 8- and
16-bit in both byte orders, bit-packed 10/12/14-bit, strips and tiles,
lossless-JPEG tiles and strips, LinearRaw with 1, 3 and 4 samples, RAF
with and without an X-Trans record and with an embedded TIFF). Minimal
vendor files and the JAX package's refusals behave in the port as in the
JAX package; arbitrary bytes (mutated DNG, RAF and vendor seeds) decode or
raise ValueError, as the JAX package's `parse_raw` does on the same bytes. The device half (`load_raw_file`,
`load_image`) on the CPU against the JAX package's run op by op:
max |d| <= 1e-5, the enhance pass's gate-moved values counted and bounded
by 0.1%.
"""

from __future__ import annotations

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given
from hypothesis import settings as hsettings
from hypothesis import strategies as st

import chip_smoke
from rapidraw_tpu.io import containers as jcontainers
from rapidraw_tpu.io import dng as jdng
from rapidraw_tpu.io import loader as jloader
from rapidraw_tpu.io import sidecar as jsidecar
from rapidraw_tpu.native import ljpeg_decode as j_ljpeg_decode
from rapidraw_tpu.raw.xtrans import DEFAULT_XTRANS
from rapidraw_tpu.utils import settings as jsettings
from rapidraw_tpu_torch import native
from rapidraw_tpu_torch.io import containers, dng, loader, sidecar
from rapidraw_tpu_torch.utils import settings
from test_native_ljpeg import encode_ljpeg
from test_raw_fuzz import _seeds as raw_fuzz_seeds
from test_raw_containers import Ifd, _build_raf, _build_raf_embedded_tiff, _pack_msb, build_tiff

torch.set_num_threads(2)

TOL = 1e-5
RAW_FIELDS = ("cfa", "pattern", "black_level", "white_level", "wb", "xyz_to_cam",
              "orientation", "is_linear", "tags", "xtrans")


def assert_same_rawfile(got, want) -> None:
    for f in RAW_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def _cfa_ifd(w, h, bits, payload, endian="<", extra=()):
    ifd = Ifd([(256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [1]),
               (262, 3, [32803]), (277, 3, [1]), (273, 4, ("blob", payload)),
               (278, 4, [h]), (279, 4, [len(payload)]), (33422, 1, bytes([1, 0, 2, 1]))])
    for e in extra:
        ifd.add(*e)
    return ifd


def _neutral(*vals):
    return (50728, 5, b"".join(struct.pack("<II", int(v * 1000), 1000) for v in vals))


def dng_cases() -> dict:
    rng = np.random.default_rng(21)
    h, w = 13, 20
    cases = {}
    for bits, endian in ((16, "<"), (16, ">"), (8, "<"), (8, ">")):
        cfa = rng.integers(0, 1 << bits, (h, w), dtype=np.uint16 if bits == 16 else np.uint8)
        payload = cfa.astype(endian + ("u2" if bits == 16 else "u1")).tobytes()
        ifd = _cfa_ifd(w, h, bits, payload, extra=[(274, 3, [3]), (50714, 3, [10, 12, 11, 9])])
        cases[f"u{bits}{'le' if endian == '<' else 'be'}"] = build_tiff([ifd], endian=endian)
    for bits in (10, 12, 14):
        cfa = rng.integers(0, 1 << bits, (h, w), dtype=np.uint16)
        cases[f"packed{bits}"] = build_tiff([_cfa_ifd(w, h, bits, _pack_msb(cfa, bits),
                                                      extra=[_neutral(0.5, 1.0, 0.7)])])
    # two strips of 8 and 5 rows
    cfa = rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
    ifd = Ifd([(256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]),
               (262, 3, [32803]), (278, 4, [8]),
               (273, 4, [0, 0]), (279, 4, [8 * w * 2, 5 * w * 2])])
    data = bytearray(build_tiff([ifd]))
    offs = (len(data), len(data) + 8 * w * 2)
    data += cfa.astype("<u2").tobytes()
    pos = data.index(struct.pack("<HHI", 273, 4, 2))
    (table,) = struct.unpack_from("<I", data, pos + 8)
    struct.pack_into("<II", data, table, *offs)
    cases["strips"] = bytes(data)
    # 16x16 tiles over 40x24, uncompressed and lossless-JPEG
    th = tw = 16
    H, Wd = 24, 40
    cfa = rng.integers(0, 1 << 14, (2 * th, 3 * tw), dtype=np.uint16)
    for name, comp, enc in (("tiles", 1, lambda t: t.astype("<u2").tobytes()),
                            ("ljpeg_tiles", 7, lambda t: encode_ljpeg(t, precision=14))):
        tiles = [enc(np.ascontiguousarray(cfa[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]))
                 for ty in range(2) for tx in range(3)]
        blob = b"".join(tiles)
        ifd = Ifd([(256, 4, [Wd]), (257, 4, [H]), (258, 3, [14 if comp == 7 else 16]),
                   (259, 3, [comp]), (262, 3, [32803]), (322, 4, [tw]), (323, 4, [th]),
                   (324, 4, [0] * 6), (325, 4, [len(t) for t in tiles]),
                   (50717, 4, [16383])])
        data = bytearray(build_tiff([ifd]))
        base = len(data)
        data += blob
        pos = data.index(struct.pack("<HHI", 324, 4, 6))
        (table,) = struct.unpack_from("<I", data, pos + 8)
        offs = np.cumsum([0] + [len(t) for t in tiles[:-1]]) + base
        struct.pack_into("<6I", data, table, *offs.tolist())
        cases[name] = bytes(data)
    strip = rng.integers(0, 1 << 12, (h, w), dtype=np.uint16)
    payload = encode_ljpeg(strip, precision=12, ncomp=2)
    ifd = _cfa_ifd(w, h, 12, payload)
    ifd.entries = [e for e in ifd.entries if e[0] != 259] + [(259, 3, [7])]
    cases["ljpeg_strip"] = build_tiff([ifd])
    for spp in (1, 3, 4):
        plane = rng.integers(0, 1 << 16, (h, w * spp), dtype=np.uint16)
        ifd = Ifd([(256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]),
                   (262, 3, [34892]), (277, 3, [spp]), (273, 4, ("blob", plane.tobytes())),
                   (278, 4, [h]), (279, 4, [plane.size * 2]), (50717, 4, [65535]),
                   _neutral(0.45, 1.0, 0.62)])
        cases[f"linear_spp{spp}"] = build_tiff([ifd])
    cfa = rng.integers(64, 16383, (12, 16), dtype=np.uint16)
    cases["config2_u16"] = chip_smoke.raw_dng_bytes(cfa)
    cases["config2_packed14_orient6"] = chip_smoke.raw_dng_bytes(cfa, bits=14, orientation=6)
    cases["config2_ljpeg_tiles"] = chip_smoke.raw_dng_bytes(np.tile(cfa[:8, :8], (2, 3)),
                                                            ljpeg_tile=8)
    return cases


CASES = dng_cases()


def raf_cases() -> dict:
    rng = np.random.default_rng(22)
    cfa = rng.integers(0, 1 << 14, (12, 18), dtype=np.uint16)
    return {"xtrans_record": _build_raf(cfa, xtrans=np.roll(DEFAULT_XTRANS, 1, 0)),
            "default_xtrans": _build_raf(cfa),
            "embedded_tiff": _build_raf_embedded_tiff(cfa),
            "config2_xtrans": chip_smoke.raw_raf_bytes(cfa, DEFAULT_XTRANS)}


RAFS = raf_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_dng_matches_jax(name):
    got, want = dng.parse_dng(CASES[name]), jdng.parse_dng(CASES[name])
    assert_same_rawfile(got, want)
    assert containers.parse_raw(CASES[name], "dng").cfa.shape == want.cfa.shape


@pytest.mark.parametrize("name", sorted(RAFS))
def test_parse_raf_matches_jax(name):
    data = RAFS[name]
    assert containers.sniff_container(data, "raf") == "raf"
    got, want = containers.parse_raw(data, "raf"), jcontainers.parse_raw(data, "raf")
    assert got.xtrans is not None
    assert_same_rawfile(got, want)


def test_ljpeg_decoder_builds_from_its_source_and_matches_jax():
    samples = np.random.default_rng(23).integers(0, 1 << 16, (9, 14), dtype=np.uint16)
    stream = encode_ljpeg(samples, precision=16, predictor=6)
    got = native.ljpeg_decode(stream)
    assert np.array_equal(got, samples) and np.array_equal(got, j_ljpeg_decode(stream))
    lib = native.host_library("ljpeg")
    assert lib._name.startswith(str(native.BUILD_DIR / "libljpeg_host_"))
    with pytest.raises(ValueError, match="ljpeg decode failed"):
        native.ljpeg_decode(b"\xff\xd8\xff\xd9")


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 16)])
def test_chip_smoke_ljpeg_encoder_is_the_test_encoder(shape):
    """chip_smoke.py writes its lossless-JPEG DNG with a vectorized encoder:
    byte for byte the stream of the repo's sample-by-sample test encoder."""
    tile = np.random.default_rng(25).integers(0, 1 << 16, shape, dtype=np.uint16)
    stream = chip_smoke.ljpeg_encode(tile)
    assert stream == encode_ljpeg(tile, precision=16)
    assert np.array_equal(native.ljpeg_decode(stream), tile)


def test_chip_smoke_raf_writer_is_the_test_writer():
    """chip_smoke.py writes its X-Trans RAF byte for byte as the repo's test
    writer does with the layout in record 0x0131."""
    cfa = np.random.default_rng(26).integers(0, 1 << 14, (12, 18), dtype=np.uint16)
    pattern = np.roll(DEFAULT_XTRANS, 2, 1)
    assert chip_smoke.raw_raf_bytes(cfa, pattern) == _build_raf(cfa, xtrans=pattern)


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(native.KernelBuildError, match="g\\+\\+ failed"):
        native.host_library("broken")
    assert not list((tmp_path / "_build").glob("*.so*"))


def _tiff_with_make(make: str, magic_extra: bytes = b"") -> bytes:
    return build_tiff([Ifd([(271, 2, make), (256, 4, [8]), (257, 4, [8])])],
                      magic_extra=magic_extra)


# one minimal file of each vendor container: a TIFF with only a Make tag
# (and CR2's magic), or a bare magic
MINIMAL_VENDOR = {
    "cr2": (_tiff_with_make("Canon", b"CR\x02\x00\0\0\0\0"), "cr2"),
    "nef": (_tiff_with_make("NIKON CORPORATION"), "nef"),
    "arw": (_tiff_with_make("SONY"), "arw"),
    "pef": (_tiff_with_make("PENTAX"), "pef"),
    "tiffcfa": (_tiff_with_make("SAMSUNG"), "srw"),
    "iiq": (_tiff_with_make("Phase One"), "iiq"),
    "orf": (b"IIRO\x08\0\0\0" + b"\x4f" * 56, "orf"),
    "rw2": (b"IIU\0\x18\0\0\0" + b"\x55" * 56, "rw2"),
    "cr3": (b"\0\0\0\x18ftypcrx \0\0\0\x01crx isom" + b"\x33" * 40, "cr3"),
    "mrw": (b"\x00MRM\0\0\0\x08" + b"\0" * 56, "mrw"),
}


@pytest.mark.parametrize("kind", sorted(MINIMAL_VENDOR))
def test_minimal_vendor_files_behave_as_jax(kind):
    """Each vendor container is routed to its parser and fails (or decodes)
    as the JAX package's: the same error type and message."""
    data, ext = MINIMAL_VENDOR[kind]
    assert containers.sniff_container(data, ext) == jcontainers.sniff_container(data, ext) == kind
    try:
        want = jcontainers.parse_raw(data, ext)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            containers.parse_raw(data, ext)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e) and "not yet ported" not in str(e)
        return
    assert_same_rawfile(containers.parse_raw(data, ext), want)


@pytest.mark.parametrize("data,ext", [
    (b"FOVb" + b"\x01\0\0\0" + b"\x99" * 56, "x3f"),
    (b"II\x1a\0\0\0HEAPCCDR" + b"\x11" * 48, "crw"),
    (b"ARRI" + b"\0" * 16 + struct.pack("<II", 2880, 1620) + b"\0" * 36, "ari"),
    (b"\x01" * 64, "k25"),
    (b"\x01" * 64, "xyz"),
])
def test_refusals_are_the_jax_packages(data, ext):
    with pytest.raises(ValueError) as want:
        jcontainers.parse_raw(data, ext)
    with pytest.raises(ValueError) as got:
        containers.parse_raw(data, ext)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value).split("; supported")[0] == str(want.value).split("; supported")[0]


# (bytes, extension): DNG and RAF, then the vendor seeds of
# tests/test_raw_fuzz.py (magic prefixes of every container, a structured
# MRW, vendor TIFF-CFA and IIQ), which it parses without an extension
SEEDS = ([(CASES["config2_u16"], "dng"), (CASES["linear_spp3"], "dng"),
          (CASES["ljpeg_tiles"], "dng"), (RAFS["xtrans_record"], "raf"),
          (RAFS["embedded_tiff"], "raf"), (b"II*\0" + struct.pack("<I", 8) + b"\1" * 40, "dng")]
         + [(seed, "") for seed in raw_fuzz_seeds()])


@hsettings(max_examples=80, deadline=None, database=None,
           suppress_health_check=list(HealthCheck))
@given(seed=st.sampled_from(range(len(SEEDS))),
       edits=st.lists(st.tuples(st.integers(0, 4095), st.integers(0, 255)), max_size=8),
       cut=st.integers(16, 1 << 16))
def test_parse_raw_decodes_or_raises_value_error(seed, edits, cut):
    """Mutated and cut files decode or raise ValueError, the JAX package's
    outcome on the same bytes."""
    blob, ext = SEEDS[seed]
    data = bytearray(blob[:cut])
    for pos, val in edits:
        if pos < len(data):
            data[pos] = val
    try:
        want = jcontainers.parse_raw(bytes(data), ext)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            containers.parse_raw(bytes(data), ext)
        assert str(got.value) == str(e)
        return
    raw = containers.parse_raw(bytes(data), ext)
    assert raw.cfa.ndim in (2, 3)
    assert_same_rawfile(raw, want)


def test_upload_keeps_the_dtype_and_copies_views():
    """u16 goes up as u16; a strided LinearRaw view, a read-only RAF block
    and a big-endian array arrive as the same values."""
    lin = containers.parse_raw(CASES["linear_spp4"], "dng")
    assert not lin.cfa.flags.c_contiguous
    t = dng.upload_cfa(lin, "cpu")
    assert t.dtype == torch.uint16 and np.array_equal(t.numpy(), lin.cfa)
    raf = containers.parse_raw(RAFS["default_xtrans"], "raf")
    assert not raf.cfa.flags.writeable
    assert np.array_equal(dng.upload_cfa(raf, "cpu").numpy(), raf.cfa)
    be = dataclass_replace(raf, cfa=raf.cfa.astype(">u2"))
    assert np.array_equal(dng.upload_cfa(be, "cpu").numpy(), raf.cfa)
    u8 = containers.parse_raw(CASES["u8le"], "dng")
    assert dng.upload_cfa(u8, "cpu").dtype == torch.uint8


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def test_load_defaults_to_the_card(tmp_path):
    """The CPU only on request: without `device=`, the CFA goes to CUDA (on
    a machine without a card, that refuses rather than falling back)."""
    p = tmp_path / "a.dng"
    p.write_bytes(CASES["config2_u16"])
    if torch.cuda.is_available():
        assert loader.load_image(p)[0].device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        dng.load_raw_file(p)
    with pytest.raises((AssertionError, RuntimeError)):
        loader.load_image(p)


LOADS = {  # name -> (bytes, extension, load_raw_file kwargs)
    "bayer_malvar": (CASES["config2_u16"], "dng", {}),
    "bayer_packed14_orient6": (CASES["config2_packed14_orient6"], "dng", {}),
    "bayer_fast": (CASES["config2_u16"], "dng", {"fast": True}),
    "bayer_hc4": (CASES["packed12"], "dng", {"highlight_compression": 4.0}),
    "xtrans": (RAFS["xtrans_record"], "raf", {}),
    "linear_gamma": (CASES["linear_spp3"], "dng", {"linear_mode": "gamma"}),
    "linear_mono": (CASES["linear_spp1"], "dng", {"linear_mode": "skip_calib"}),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_raw_file_matches_jax(name, tmp_path):
    data, ext, kw = LOADS[name]
    p = tmp_path / f"img.{ext}"
    p.write_bytes(data)
    with jax.disable_jit():
        want = np.asarray(jdng.load_raw_file(p, **kw))
    got = dng.load_raw_file(p, device="cpu", **kw)
    assert got.device.type == "cpu" and got.is_contiguous()
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("fast", [False, True])
def test_load_image_matches_jax(fast, tmp_path):
    """Through the enhance pass (on by default; off on the fast path),
    from a virtual-copy path."""
    rng = np.random.default_rng(24)
    p = tmp_path / "shot.dng"
    p.write_bytes(chip_smoke.raw_dng_bytes(rng.integers(64, 16383, (96, 144), dtype=np.uint16),
                                           bits=14))
    with jax.disable_jit():
        want, want_raw = jloader.load_image(f"{p}?vc=2", fast=fast)
        want = np.asarray(want)
    got, is_raw = loader.load_image(f"{p}?vc=2", fast=fast, device="cpu")
    assert is_raw and want_raw
    got = got.numpy()
    assert got.shape == want.shape == ((3, 48, 72) if fast else (3, 96, 144))
    off = np.abs(got - want) > TOL
    print(f"load_image fast={fast}: {int(off.sum())} of {off.size} values moved by a gate")
    assert off.mean() <= 1e-3


def test_load_image_refuses_ldr_files_until_a10(tmp_path):
    """The LDR formats the port does not decode yet (A.10c) raise; a BMP
    that JAX's PIL opens among them."""
    from PIL import Image

    Image.new("RGB", (4, 3)).save(tmp_path / "photo.bmp")
    with pytest.raises(NotImplementedError, match="A.10c"):
        loader.load_image(tmp_path / "photo.bmp", device="cpu")
    assert loader.RAW_EXTENSIONS == jloader.RAW_EXTENSIONS
    for path in ("a.DNG", "b.raf?vc=3", "c.jpg", "d.tif"):
        assert loader.is_raw_file(loader.parse_virtual_path(path)[0]) == \
            jloader.is_raw_file(jloader.parse_virtual_path(path)[0])


def test_to_uint8_hwc_matches_jax():
    x = np.linspace(-0.1, 1.1, 3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    assert np.array_equal(loader.to_uint8_hwc(torch.from_numpy(x)), jloader.to_uint8_hwc(x))
    u8 = (x.clip(0, 1) * 255).astype(np.uint8)
    assert np.array_equal(loader.to_uint8_hwc(u8), jloader.to_uint8_hwc(u8))


@pytest.mark.parametrize("doc", [
    {}, {"rawPreprocessingColorNr": 0.0, "rawPreprocessingSharpening": 0.0},
    {"rawPreprocessingColorNr": 0.003, "rawHighlightCompression": 0, "linearRawMode": "gamma"},
    {"rawPreprocessingColorNr": 1.0, "tonemapperOverrideEnabled": True,
     "defaultRawTonemapper": "basic"},
])
def test_settings_match_jax(doc):
    got = settings.AppSettings(settings.DEFAULTS, **doc)
    want = jsettings.AppSettings(jsettings.DEFAULTS, **doc)
    assert dict(got) == dict(want)
    assert got.preprocessing_amounts() == want.preprocessing_amounts()
    for name in ("raw_highlight_compression", "linear_raw_mode", "raw_preprocessing_color_nr",
                 "raw_preprocessing_sharpening"):
        assert getattr(got, name) == getattr(want, name)
    for is_raw in (False, True):
        assert got.tonemapper_override(is_raw) == want.tonemapper_override(is_raw)
    assert settings.AppSettings(settings.DEFAULTS)["rootFolders"] is not settings.DEFAULTS[
        "rootFolders"]


def test_sidecars_read_like_jax(tmp_path):
    img = tmp_path / "shot.dng"
    meta = {"version": 1, "rating": 3, "adjustments": chip_smoke.CONFIG3_DOC,
            "exif": {"Make": "X" * 900, "Model": "Y"}}
    (tmp_path / "shot.dng.rrdata").write_text(json.dumps(meta))
    (tmp_path / "shot.dng.2.rrdata").write_text("not json")
    for path in (img, f"{img}?vc=2", tmp_path / "missing.dng"):
        assert sidecar.sidecar_path(path) == jsidecar.sidecar_path(path)
        assert sidecar.load_sidecar(path) == jsidecar.load_sidecar(path)
        assert sidecar.load_adjustments(path) == jsidecar.load_adjustments(path)
    assert sidecar.load_adjustments(img) == chip_smoke.CONFIG3_DOC
