"""The port's lossy WebP writer (csrc/host/webp_enc.cc through io/webp.py)
against PIL 12.1's libwebp 1.6.0 and the JAX package's export.

The encoder is the port's own, so its bytes are not libwebp's; the bars
are on what a user gets:
- validity: PIL opens every file, and PIL's pixels, the port's decoder's
  and the encoder's own reconstruction are the same bytes; a side past
  16383 pixels raises PIL's ValueError with its message;
- rate and distortion against PIL's files at q 50-95 (libwebp's method 4):
  the Bjontegaard delta rate on RGB PSNR at most +15%, the bits per pixel
  within [0.67, 1.5] x PIL's at every quality (so a quality means to a port
  user what it means to a JAX user), and at q 100 a PSNR at least PIL's
  less 0.5 dB; the same bars for `encode_image` in both packages;
- the bytes of chip_smoke's seeded frames, pinned (the card's phase 23
  checks the same digests), whatever the thread count;
- `estimate_export_sizes` sizes a real WebP, and `copy_exif` splices EXIF
  into the port's file as JAX's does into PIL's.
"""

from __future__ import annotations

import hashlib
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
from rapidraw_tpu.pipeline import export as jexport
from rapidraw_tpu_torch.io import encode, exif, webp
from rapidraw_tpu_torch.io.loader import to_uint8_hwc
from rapidraw_tpu_torch.pipeline import export
from test_torch_encode import photo_u8
from test_torch_export import op_by_op

jax.config.update("jax_platforms", "cpu")

QUALITIES = (50, 60, 70, 80, 90, 95)
BD_RATE_MAX = 15.0  # percent, against PIL's libwebp
BPP_RATIO = (0.67, 1.5)  # the port's bits per pixel over PIL's, at every quality
Q100_SLACK = 0.5  # dB below PIL's PSNR at q 100
# chip_smoke.WEBP_DIGESTS, pinned here: (h, w, seed, quality) -> SHA-256
PINNED = {
    (64, 96, 23, 90): "ef5d22d4715398d279e6c5989b862a433f3425207855951d3c0357846601812d",
    (37, 53, 24, 75): "e70004131f477df5d08e20bb2064c891bf2641281e1de3af859c0b5749a344ac",
    (256, 384, 25, 50): "9fea6f4e09013c24364fdb25a48f6e7cc93f81f990747550793467f0ddb04518",
}


def pil_webp(img: np.ndarray, q) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", quality=q)
    return buf.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    assert im.format == "WEBP" and im.mode == "RGB"
    return np.asarray(im)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(255.0 ** 2 / mse) if mse else math.inf


def bd_rate(ref_bpp, ref_psnr, bpp, dist) -> float:
    """Bjontegaard's delta rate (percent) of (bpp, dist) against (ref_bpp,
    ref_psnr): cubic fits of log rate on PSNR, averaged over the PSNR range
    both curves cover."""
    lo, hi = max(min(ref_psnr), min(dist)), min(max(ref_psnr), max(dist))
    area = []
    for r, p in ((ref_bpp, ref_psnr), (bpp, dist)):
        integral = np.polyint(np.polyfit(p, np.log(r), 3))
        area.append((np.polyval(integral, hi) - np.polyval(integral, lo)) / (hi - lo))
    return (math.exp(area[1] - area[0]) - 1) * 100


def rd_curve(files: dict, img: np.ndarray) -> tuple[list, list]:
    px = img.shape[0] * img.shape[1]
    return ([len(files[q]) * 8 / px for q in QUALITIES],
            [psnr(pil_pixels(files[q]), img) for q in QUALITIES])


def assert_rd_bars(label: str, ref: dict, got: dict, img: np.ndarray) -> None:
    """`got`'s files against `ref`'s: keyed by quality, QUALITIES and 100."""
    r0, p0 = rd_curve(ref, img)
    r1, p1 = rd_curve(got, img)
    bd = bd_rate(r0, p0, r1, p1)
    ratios = [b / a for a, b in zip(r0, r1)]
    top = psnr(pil_pixels(ref[100]), img), psnr(pil_pixels(got[100]), img)
    print(f"{label}: BD-rate {bd:+.2f}%, bpp ratios {[round(x, 3) for x in ratios]}, "
          f"PSNR deltas {[round(b - a, 2) for a, b in zip(p0, p1)]}, q100 PSNR {top[1]:.2f} "
          f"against {top[0]:.2f}")
    assert bd <= BD_RATE_MAX
    assert all(BPP_RATIO[0] <= x <= BPP_RATIO[1] for x in ratios)
    assert top[1] >= top[0] - Q100_SLACK


@pytest.fixture(scope="module")
def frames(tmp_path_factory) -> dict:
    """`photo_u8` and config 3 on a photograph-like DNG, developed by the
    JAX package's export chunk (jitted), both 256 x 384 u8."""
    import jax.numpy as jnp

    from rapidraw_tpu.io.loader import load_image as jload_image
    from rapidraw_tpu.params.parse import parse_adjustments as jparse
    from rapidraw_tpu.pipeline.batch import stack_params as jstack

    path = tmp_path_factory.mktemp("webp") / "photo.dng"
    path.write_bytes(chip_smoke.raw_dng_bytes(chip_smoke.photo_cfa(256, 384, 64, 16383, 31)))
    img, _ = jload_image(str(path))
    sp, sc = jstack(*[[v] for v in jparse(dict(chip_smoke.CONFIG3_DOC, showClipping=False),
                                           is_raw=True)])
    frame = np.asarray(jexport._render_chunk(jnp.asarray(img)[None], sp, None, None, sc)[0])
    return {"photo": photo_u8(256, 384, 1), "config3": np.ascontiguousarray(frame.transpose(1, 2, 0))}


@pytest.mark.parametrize("q", [0, 1, 50, 80, 100])
@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (33, 17), (16, 16)])
def test_pil_opens_small_frames_as_reconstructed(shape, q):
    img = photo_u8(*shape, seed=sum(shape) + q)
    data, recon = webp.webp_reconstruction(img, q)
    assert data == webp.encode_webp(img, q)
    assert Image.open(io.BytesIO(data)).size == shape[::-1]
    assert np.array_equal(pil_pixels(data), recon)
    got, mode = webp.decode_webp(data)
    assert mode == "RGB" and np.array_equal(got, recon)


@pytest.mark.parametrize("shape", [(1024, 1536), (16, 16383), (16383, 16)])
def test_pil_opens_large_frames_as_reconstructed(shape):
    img = photo_u8(*shape, seed=7)
    data, recon = webp.webp_reconstruction(img, 75)
    assert np.array_equal(pil_pixels(data), recon)
    assert np.array_equal(webp.decode_webp(data)[0], recon)
    # the simple format, as libwebp writes it for PIL: RIFF, WEBP, one "VP8 "
    riff, chunk = struct.unpack_from("<I", data, 4)[0], struct.unpack_from("<I", data, 16)[0]
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8 "
    assert riff == len(data) - 8 == 12 + chunk + (chunk & 1)
    assert pil_webp(img, 75)[8:16] == b"WEBPVP8 "


@pytest.mark.parametrize("shape", [(16, 16384), (16384, 16)])
def test_over_16383_pixels_raises_as_pil(shape, tmp_path):
    img = np.zeros((*shape, 3), np.uint8)
    with pytest.raises(ValueError) as want:
        pil_webp(img, 80)
    with pytest.raises(ValueError) as got:
        webp.encode_webp(img, 80)
    assert str(got.value) == str(want.value)
    planar = np.zeros((3, *shape), np.float32)
    with pytest.raises(ValueError) as jax_export:
        jencode.encode_image(planar, tmp_path / "j.webp", "webp", 80)
    with pytest.raises(ValueError) as port_export:
        encode.encode_image(planar, tmp_path / "p.webp", "webp", 80)
    assert str(port_export.value) == str(jax_export.value) == str(want.value)
    assert not (tmp_path / "p.webp").exists()


@pytest.mark.parametrize("q", [-1, 101])
def test_quality_outside_0_100_raises_as_pil(q):
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError) as want:
        pil_webp(img, q)
    with pytest.raises(ValueError) as got:
        webp.encode_webp(img, q)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["photo", "config3"])
def test_rate_distortion_against_pil(frames, name):
    img = frames[name]
    ref = {q: pil_webp(img, q) for q in (*QUALITIES, 100)}
    got = {q: webp.encode_webp(img, q) for q in (*QUALITIES, 100)}
    assert_rd_bars(name, ref, got, img)


def test_encode_image_meets_the_bars_against_jax(tmp_path):
    """The same planar float render through both packages' encode_image."""
    planar = (chip_smoke.ldr_rgb16(192, 288, 5).transpose(2, 0, 1) / 65535.0).astype(np.float32)
    ref, got = {}, {}
    for q in (*QUALITIES, 100):
        jencode.encode_image(planar, tmp_path / f"j{q}.webp", "webp", q)
        encode.encode_image(planar, tmp_path / f"p{q}.webp", "webp", q)
        ref[q] = (tmp_path / f"j{q}.webp").read_bytes()
        got[q] = (tmp_path / f"p{q}.webp").read_bytes()
    assert_rd_bars("encode_image", ref, got, to_uint8_hwc(planar))


@pytest.mark.parametrize("case", sorted(PINNED))
def test_seeded_frames_bytes_are_pinned(case, monkeypatch):
    """chip_smoke's phase 23 checks these digests on the card's machine;
    the bytes do not depend on the number of threads."""
    assert chip_smoke.WEBP_DIGESTS == PINNED
    h, w, seed, q = case
    frame = chip_smoke.webp_digest_frame(h, w, seed)
    assert hashlib.sha256(webp.encode_webp(frame, q)).hexdigest() == PINNED[case]
    monkeypatch.setattr(webp.os, "cpu_count", lambda: 1)
    assert hashlib.sha256(webp.encode_webp(frame, q)).hexdigest() == PINNED[case]


def test_quality_table_lies_within_pils_segments(frames):
    """QUALITY_TO_INDEX[q] lies between the least and the greatest of the
    quantizer indices of PIL's segments at every quality, on both frames
    (read by the port's own header parser)."""
    for img in (frames["photo"][:64, :96], frames["config3"][:64, :96]):
        for q in range(101):
            head = webp.vp8_frame_header(pil_webp(img, q)[20:])
            seg = head["segments"]
            qs = seg["quant"] if seg["enabled"] else [head["quant"]["y_ac"]]
            assert min(qs) <= webp.QUALITY_TO_INDEX[q] <= max(qs), (q, qs)


def test_frame_header_reads_the_encoders_fields():
    head = webp.vp8_frame_header(webp.encode_webp(photo_u8(40, 56, 3), 80)[20:])
    assert (head["width"], head["height"]) == (56, 40)
    assert head["quant"]["y_ac"] == webp.QUALITY_TO_INDEX[80]
    assert (head["quant"]["uv_dc"], head["quant"]["uv_ac"]) == (-2, -4)
    assert not head["segments"]["enabled"] and head["partitions"] == 1
    assert head["filter"]["simple"] == 0 and head["filter"]["sharpness"] == 0


def _dngs(root, n=2) -> list[str]:
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"img_{i}.dng"
        p.write_bytes(chip_smoke.raw_dng_bytes(chip_smoke.photo_cfa(64, 96, 64, 16383, 40 + i)))
        p.with_name(p.name + ".rrdata").write_text('{"version": 1, "adjustments": '
                                                   '{"exposure": 0.4}}')
        paths.append(str(p))
    return paths


def test_estimate_probes_a_webp(tmp_path, monkeypatch):
    """The port's estimate is its own probe's WebP size times the pixel
    ratio (1 here) times the file count, and lies within BPP_RATIO of
    JAX's, which sizes PIL's WebP."""
    paths = _dngs(tmp_path / "src")
    probes = []
    real = encode.encode_image

    def spy(planar, path, fmt=None, quality=90):
        probes.append((np.array(planar), fmt, quality))
        return real(planar, path, fmt, quality)

    monkeypatch.setattr(encode, "encode_image", spy)
    got = export.estimate_export_sizes(paths, export.ExportSettings(format="webp", quality=80),
                                       device="cpu")
    [(planar, fmt, q)] = probes
    assert (fmt, q) == ("webp", 80)
    assert got == len(webp.encode_webp(to_uint8_hwc(planar), 80)) * len(paths)
    with op_by_op(monkeypatch):
        want = jexport.estimate_export_sizes(paths, jexport.ExportSettings(format="webp",
                                                                           quality=80))
    print(f"estimate: port {got}, JAX {want}")
    assert BPP_RATIO[0] <= got / want <= BPP_RATIO[1]


def _vp8_payload(data: bytes) -> bytes:
    pos = 12
    while pos + 8 <= len(data):
        tag, (size,) = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)
        if tag == b"VP8 ":
            return data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    raise AssertionError("no VP8 chunk")


def test_copy_exif_onto_the_port_webp(tmp_path):
    """The DNG's IFD0 (Orientation 6), Exif and GPS IFDs spliced into each
    package's WebP: the same tags read back, the port's VP8 chunk
    untouched."""
    src = tmp_path / "shot.dng"
    cfa = np.random.default_rng(1).integers(64, 16383, (32, 48), dtype=np.uint16)
    src.write_bytes(chip_smoke.raw_dng_bytes(cfa, orientation=6, meta=chip_smoke.EXPORT_META))
    planar = np.random.default_rng(2).random((3, 20, 30), dtype=np.float32)
    want, got = tmp_path / "jax.webp", tmp_path / "port.webp"
    jencode.encode_image(planar, want, "webp", 90)
    encode.encode_image(planar, got, "webp", 90)
    before = _vp8_payload(got.read_bytes())
    assert jexif.copy_exif(src, want) and exif.copy_exif(src, got)
    tags = jexif.read_exif_tags(got)
    assert tags and tags == jexif.read_exif_tags(want)
    assert exif.read_exif_tags(got) == tags
    assert _vp8_payload(got.read_bytes()) == before
    assert Image.open(got).size == (30, 20)


def test_cli_export_writes_a_webp_pil_opens(tmp_path):
    """`python -m rapidraw_tpu_torch export --format webp` on the CPU."""
    from rapidraw_tpu_torch import cli

    [src] = _dngs(tmp_path / "src", n=1)
    assert cli.main(["export", src, "-o", str(tmp_path / "out"), "--format", "webp",
                     "--quality", "85", "--device", "cpu"]) in (0, None)
    [out] = sorted((tmp_path / "out").glob("*.webp"))
    data = out.read_bytes()
    assert Image.open(out).size == (96, 64)
    assert np.array_equal(pil_pixels(data), webp.decode_webp(data)[0])
    assert webp.vp8_frame_header(data[20:])["quant"]["y_ac"] == webp.QUALITY_TO_INDEX[85]


def test_shared_header_is_in_the_build_hash(tmp_path, monkeypatch):
    """A host library is named by its source and the local headers it
    includes: editing vp8_common.h builds the WebP libraries anew."""
    from rapidraw_tpu_torch import native

    host = tmp_path / "host"
    host.mkdir()
    (host / "shared.h").write_text("inline int answer() { return 41; }\n")
    (host / "probe.cc").write_text('#include "shared.h"\n'
                                   'extern "C" int probe() { return answer(); }\n')
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_host_libs", {})
    assert native.host_library("probe").probe() == 41
    (host / "shared.h").write_text("inline int answer() { return 42; }\n")
    monkeypatch.setattr(native, "_host_libs", {})
    assert native.host_library("probe").probe() == 42
    assert len(list((tmp_path / "build").glob("libprobe_host_*.so"))) == 2
    shipped = Path(webp.__file__).resolve().parent.parent / "csrc" / "host"
    for name in ("webp_enc.cc", "webp_dec.cc"):
        assert native._local_headers(shipped / name) == [shipped / "vp8_common.h"]
