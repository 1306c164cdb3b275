"""The port's EXIF engine (io/exif.py) against the JAX package's, which
reads and rewrites EXIF through PIL.

- the tag tables the port keeps as data equal PIL's;
- read_exif_tags, read_exif_bytes and get_creation_date give what JAX's
  give on every RAW container the tests build (DNG, CR2, NEF, ARW, CR3,
  PEF, RAF, ORF, RW2), each with Make, Model, DateTime, an Exif IFD
  (DateTimeOriginal, exposure) and a GPS IFD added where the container
  holds a TIFF IFD, and on first frames PIL opens or refuses, with odd
  types and broken pointers;
- copy_exif's JPEG, PNG and TIFF outputs read back by PIL give the same
  tags as JAX's (GPS stripped, Orientation 1), JPEG and TIFF byte for byte,
  also with sidecar-edited EXIF and a Software tag.
"""

from __future__ import annotations

import datetime
import json
import struct

import numpy as np
import pytest
from PIL import ExifTags, Image, TiffImagePlugin, TiffTags

import chip_smoke
from rapidraw_tpu.io import encode as jencode
from rapidraw_tpu.io import exif as jexif
from rapidraw_tpu_torch.io import encode, exif, exif_tags
from test_raw_containers import _build_raf

META = chip_smoke.EXPORT_META


def test_tag_tables_are_pils():
    assert exif_tags.EXIF_TAGS == ExifTags.TAGS
    assert exif_tags.GPS_TAGS == ExifTags.GPSTAGS
    assert exif_tags.TAG_INFO == {t: (i.type, i.length) for t, i in TiffTags.TAGS_V2.items()}
    assert exif_tags.TAG_ENUMS == {t: i.enum for t, i in TiffTags.TAGS_V2.items() if i.enum}
    assert exif_tags.GROUP_INFO == {g: {t: (i.type, i.length) for t, i in v.items()}
                                    for g, v in TiffTags.TAGS_V2_GROUPS.items()}
    assert not any(i.enum for v in TiffTags.TAGS_V2_GROUPS.values() for i in v.values())
    assert exif_tags.OPEN_MODES == TiffImagePlugin.OPEN_INFO
    assert exif_tags.COMPRESSIONS == set(TiffImagePlugin.COMPRESSION_INFO)


def _merge_meta(ifd0: list) -> list:
    """IFD0 entries with META's added: Make and Model replaced, the Exif
    IFD's entries added to an existing Exif IFD."""
    extra = chip_smoke.exif_entries(META)
    out = [e for e in ifd0 if e[0] not in (271, 272)]
    have = {e[0]: e for e in out}
    for tag, typ, value in extra:
        if tag == 34665 and tag in have:
            have[tag][2][1].extend(value[1])
        elif tag not in have:
            out.append((tag, typ, value))
    return out


def vendor_with_meta(kind: str, monkeypatch) -> bytes:
    """chip_smoke's writer for `kind` with META added to the first IFD it
    writes (the CMT1 block of a CR3)."""
    real = chip_smoke.tiff_bytes
    calls = []

    def tiff_bytes(chain, *a, **k):
        if not calls:
            chain = [_merge_meta(list(chain[0]))] + list(chain[1:])
        calls.append(1)
        return real(chain, *a, **k)

    monkeypatch.setattr(chip_smoke, "tiff_bytes", tiff_bytes)
    shape = {"rw2": (18, 28), "orf_predictive": (8, 16)}.get(kind, (16, 32))
    data, _ = chip_smoke.vendor_file(kind, *shape, 1)
    monkeypatch.setattr(chip_smoke, "tiff_bytes", real)
    return data


RAW_KINDS = {"cr2": "cr2", "nef": "nef", "arw": "arw", "cr3": "cr3", "pef": "pef",
             "orf_packed": "orf", "rw2": "rw2"}


def _raw_file(name, tmp_path, monkeypatch):
    cfa = np.random.default_rng(1).integers(64, 16383, (32, 48), dtype=np.uint16)
    if name == "dng_meta":
        data, ext = chip_smoke.raw_dng_bytes(cfa, orientation=6, meta=META), "dng"
    elif name == "dng_plain":
        data, ext = chip_smoke.raw_dng_bytes(cfa), "dng"
    elif name == "raf":
        data, ext = _build_raf(cfa), "raf"
    else:
        data, ext = vendor_with_meta(name, monkeypatch), RAW_KINDS[name]
    path = tmp_path / f"shot.{ext}"
    path.write_bytes(data)
    return path


def assert_reads_like_jax(path) -> dict:
    tags = jexif.read_exif_tags(path)
    assert exif.read_exif_tags(path) == tags
    assert exif.read_exif_bytes(path) == jexif.read_exif_bytes(path)
    assert exif.get_creation_date(path) == jexif.get_creation_date(path)
    return tags


@pytest.mark.parametrize("name", ["dng_meta", "dng_plain", "raf", *sorted(RAW_KINDS)])
def test_raw_containers_read_like_jax(name, tmp_path, monkeypatch):
    """PIL opens the DNG with a preview IFD0 (its metadata and GPS come
    through); the synthetic vendor files' IFD0s hold no image PIL can open,
    and RAF, ORF ('IIRO') and RW2 ('IIU') are no TIFF to PIL, so JAX reads
    no EXIF from them and neither does the port; CR3 reads through its
    container parser."""
    path = _raw_file(name, tmp_path, monkeypatch)
    tags = assert_reads_like_jax(path)
    if name == "dng_meta":
        assert tags["Make"] == META["make"] and tags["DateTimeOriginal"] == META["taken"]
        assert tags["GPSGPSLatitude"] == "52.0, 31.0, 12.34" and tags["ExposureTime"] == "0.008"
        assert exif.get_creation_date(path) == datetime.datetime(2024, 5, 17, 9, 41, 7)
    elif name == "cr3":
        assert tags["Make"] == META["make"]
    else:
        assert tags == {}


def _tiff(ifd0, endian="<", **kw) -> bytes:
    return chip_smoke.tiff_bytes([ifd0], endian=endian, **kw)


def _image(w=4, h=3, photo=2, bps=(8, 8, 8), spp=3, compression=1, extra=()):
    n = w * h * spp * max(bps) // 8
    return [(256, 4, [w]), (257, 4, [h]), (258, 3, list(bps)), (259, 3, [compression]),
            (262, 3, [photo]), (277, 3, [spp]), (273, 4, ("blob", bytes(n))),
            (279, 4, [n]), *extra]


def _packed(endian, fmt, *vals) -> bytes:
    return struct.pack(endian + fmt, *vals)


FIRST_FRAMES = {  # name -> TIFF bytes; PIL opens some and refuses the others
    "rgb8": _tiff(_image(extra=[(271, 2, "Cam"), (306, 2, "2023:01:02 03:04:05")])),
    "rgb8_be": _tiff(_image(extra=[(271, 2, "Cam")]), endian=">"),
    "gray16": _tiff(_image(photo=1, bps=(16,), spp=1, extra=[(271, 2, "Cam")])),
    "old_jpeg": _tiff([e for e in _image(compression=6, extra=[(271, 2, "Cam")])
                       if e[0] != 277]),
    "cfa16": _tiff(_image(photo=32803, bps=(16,), spp=1, extra=[(271, 2, "Cam")])),
    "nikon_compression": _tiff(_image(compression=34713, extra=[(271, 2, "Cam")])),
    "no_strips": _tiff([e for e in _image(extra=[(271, 2, "Cam")]) if e[0] != 273]),
    "no_width": _tiff([e for e in _image(extra=[(271, 2, "Cam")]) if e[0] != 256]),
    "rational_width": _tiff([(256, 5, _packed("<", "2L", 4, 1))]
                            + [e for e in _image() if e[0] != 256]),
    "fillorder2": _tiff(_image(photo=1, bps=(8,), spp=1, extra=[(266, 3, [2])])),
    "odd_types": _tiff(_image(extra=[
        (271, 2, "Cam\x00era\x00"), (305, 6, _packed("<", "3b", -1, 2, -3)),
        (40000, 8, _packed("<", "2h", -5, 7)), (40001, 9, _packed("<", "i", -70000)),
        (40002, 11, _packed("<", "2f", 1.5, -2.25)), (40003, 12, _packed("<", "d", 3.125)),
        (40004, 10, _packed("<", "4i", -1, 3, 5, 0)), (40005, 5, _packed("<", "4I", 30, 10, 1, 0)),
        (40006, 7, b"\x01\x02\x03\x04\x05"), (40007, 1, bytes(range(9))),
        (40008, 99, b"\x00\x00\x00\x00"), (40009, 3, [1, 2, 3]), (282, 5, _packed("<", "2I", 72, 1)),
    ])),
    "broken_pointers": _tiff(_image(extra=[
        (271, 2, "Cam"), (34665, 4, [1 << 20]), (34853, 3, [8, 9])])),
    "exif_and_gps": _tiff(_image(extra=chip_smoke.exif_entries(META))),
    "exif_and_gps_be": _tiff(_image(extra=chip_smoke.exif_entries(META)), endian=">"),
}


@pytest.mark.parametrize("name", sorted(FIRST_FRAMES))
def test_first_frames_read_like_jax(name, tmp_path):
    """Which first frames open (PIL's layouts, compressions, dimensions,
    strips) and what every entry type, a truncated value, an unknown type
    and broken sub-IFD pointers read as."""
    path = tmp_path / "a.tif"
    path.write_bytes(FIRST_FRAMES[name])
    tags = assert_reads_like_jax(path)
    opens = name not in ("cfa16", "nikon_compression", "no_strips", "no_width",
                         "rational_width")
    assert bool(tags) == opens
    payload = exif.read_exif_bytes(path)
    if payload:
        assert exif.strip_gps(payload[6:]) == jexif.strip_gps(payload[6:])


def test_jpeg_png_and_webp_sources_read_like_jax(tmp_path):
    """A JPEG's first APP1 Exif block and a PNG's eXIf chunk as stored;
    PIL writes the WebP."""
    payload = exif.read_exif_bytes(_write(tmp_path / "m.tif", FIRST_FRAMES["exif_and_gps"]))
    img = np.full((8, 12, 3), 90, np.uint8)
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=90, exif=payload)
    Image.fromarray(img).save(tmp_path / "a.png", exif=payload)
    Image.fromarray(img).save(tmp_path / "a.webp", exif=payload)
    Image.fromarray(img).save(tmp_path / "plain.jpg", quality=90)
    for name in ("a.jpg", "a.png", "a.webp", "plain.jpg"):
        tags = assert_reads_like_jax(tmp_path / name)
        assert bool(tags) == (name != "plain.jpg")
    (tmp_path / "junk.bin").write_bytes(b"not an image")
    assert_reads_like_jax(tmp_path / "junk.bin")


def _write(path, data):
    path.write_bytes(data)
    return path


def _export_pair(tmp_path, fmt, planar):
    want, got = tmp_path / f"jax.{fmt}", tmp_path / f"port.{fmt}"
    jencode.encode_image(planar, want, fmt, 90)
    encode.encode_image(planar, got, fmt, 90)
    return want, got


@pytest.mark.parametrize("fmt", ["jpg", "png", "tif"])
def test_copy_exif_matches_jax(fmt, tmp_path, monkeypatch):
    """The DNG's IFD0 (Orientation 6), Exif and GPS IFDs onto each output:
    read back by PIL, the same tags as JAX's output, GPS gone and
    Orientation 1; the TIFF's tags flattened into its IFD0."""
    src = _raw_file("dng_meta", tmp_path, monkeypatch)
    planar = np.random.default_rng(2).random((3, 20, 30), dtype=np.float32)
    want, got = _export_pair(tmp_path, fmt, planar)
    assert jexif.copy_exif(src, want) and exif.copy_exif(src, got)
    tags = jexif.read_exif_tags(got)
    assert tags == jexif.read_exif_tags(want)
    assert exif.read_exif_tags(got) == tags
    assert not any(k.startswith("GPS") for k in tags) and tags["Orientation"] == "1"
    assert tags["Model"] == META["model"] and tags["DateTimeOriginal"] == META["taken"]
    if fmt != "png":
        assert got.read_bytes() == want.read_bytes()
    # and with the GPS kept, and a Software tag
    want2, got2 = _export_pair(tmp_path / ".." / tmp_path.name, fmt, planar)
    assert jexif.copy_exif(src, want2, strip_gps_data=False, software="rr 1.0")
    assert exif.copy_exif(src, got2, strip_gps_data=False, software="rr 1.0")
    assert jexif.read_exif_tags(got2) == jexif.read_exif_tags(want2)


def test_sidecar_edited_exif_matches_jax(tmp_path, monkeypatch):
    """Edited tags in the sidecar win over the file's own, coerced back to
    their declared types; an untypable value drops only its tag."""
    src = _raw_file("dng_meta", tmp_path, monkeypatch)
    edited = dict(jexif.read_exif_tags(src), Artist="Someone", ExposureTime="1/250",
                  ISOSpeedRatings="800", XResolution="oops", FNumber="4",
                  ColorMatrix2="1, 2/3, -0.5")
    (tmp_path / "shot.dng.rrdata").write_text(json.dumps({"exif": edited}))
    assert exif.effective_exif_tags(src) == jexif.effective_exif_tags(src)
    planar = np.random.default_rng(3).random((3, 16, 24), dtype=np.float32)
    for fmt in ("jpg", "tif"):
        want, got = _export_pair(tmp_path, fmt, planar)
        assert jexif.copy_exif(src, want) and exif.copy_exif(src, got)
        assert got.read_bytes() == want.read_bytes()
        assert jexif.read_exif_tags(got)["Artist"] == "Someone"


@pytest.mark.parametrize("fmt", ["avif", "jxl", "bmp"])
def test_copy_exif_refuses_formats_without_a_writer(fmt, tmp_path, monkeypatch):
    src = _raw_file("dng_meta", tmp_path, monkeypatch)
    dst = tmp_path / f"out.{fmt}"
    dst.write_bytes(b"anything")
    assert exif.copy_exif(src, dst) is jexif.copy_exif(src, dst) is False


def test_copy_exif_without_source_exif(tmp_path, monkeypatch):
    src = _raw_file("dng_plain", tmp_path, monkeypatch)
    want, got = _export_pair(tmp_path, "jpg", np.zeros((3, 8, 8), np.float32))
    assert exif.copy_exif(src, got) is jexif.copy_exif(src, want) is False
    assert got.read_bytes() == want.read_bytes()


def test_payload_helpers_match_jax(tmp_path):
    payload = exif.read_exif_bytes(_write(tmp_path / "m.tif", FIRST_FRAMES["exif_and_gps_be"]))
    raw = payload[6:]
    assert exif.strip_gps(raw) == jexif.strip_gps(raw)
    assert exif._reset_orientation(raw) == jexif._reset_orientation(raw)
    plain = exif.read_exif_bytes(_write(tmp_path / "p.tif", FIRST_FRAMES["rgb8"]))[6:]
    assert exif.strip_gps(plain) is plain  # GPS-less payloads come back unchanged
    assert exif.strip_gps(b"junk") == jexif.strip_gps(b"junk") == b"junk"
    tags = {"Make": "A", "ExposureTime": "1/60", "Orientation": "6", "Bogus": "x",
            "ExifOffset": "12", "GPSInfo": "x", "UserComment": "hello"}
    assert exif._payload_from_tag_dict(tags) == jexif._payload_from_tag_dict(tags)
    assert exif._payload_from_tag_dict({"Bogus": 1}) is jexif._payload_from_tag_dict({"Bogus": 1})


def test_rationals_print_as_pil():
    for n, d in [(1, 3), (30, 10), (0, 5), (7, 0), (2**32 - 1, 3)]:
        assert str(exif.Rational(n, d)) == str(TiffImagePlugin.IFDRational(n, d))
    assert str(exif.Rational(2.5)) == str(TiffImagePlugin.IFDRational(2.5))
