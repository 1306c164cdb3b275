"""Write the LDR-format fixtures of this folder with PIL 12.1 (libwebp
1.6.0, libtiff 4.7.1, libjpeg-turbo), and digests.json: each file's size
and the SHA-256 of PIL's `Image.open(f).convert(mode)` bytes for "RGB",
"RGBA" and "L" (where PIL converts: not LAB to L); for the JPEG and TIFF
variants also PIL's mode and the SHA-256 of its samples (`np.asarray`).

    PYTHONPATH=. python tests/fixtures/ldr/make_fixtures.py

The files: a 1024 x 1536 lossy WebP (q75) of chip_smoke.ldr_rgb16's
photograph, a lossy WebP with a lossy alpha plane, BC3 and BC7 DDS files
of seeded random blocks (PIL decodes any block), and a GIF with a
transparency index; the variants of ROADMAP A.10d: a CMYK JPEG with an
Adobe marker and its YCCK copy (the marker's transform set to 2), TIFFs in
CCITT Modified Huffman, T.4 2-D and T.6, a JPEG-compressed CMYK TIFF, a
YCbCr 2x2 LZW TIFF (written here: PIL writes no subsampled YCbCr) and a
Lab TIFF. The port reads them without PIL (chip_smoke phases 21 and 22,
tests/test_torch_ldr_formats.py, tests/test_torch_ldr_variants.py)."""

from __future__ import annotations

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def dds_header(w: int, h: int, dxgi: int | None, fourcc: bytes) -> bytes:
    hdr = bytearray(128)
    hdr[:4] = b"DDS "
    struct.pack_into("<IIII", hdr, 4, 124, 0x81007, h, w)
    struct.pack_into("<II", hdr, 76, 32, 0x4)
    hdr[84:88] = fourcc
    ext = struct.pack("<IIIII", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return bytes(hdr) + ext


def fixtures() -> dict[str, bytes]:
    import chip_smoke

    rng = np.random.default_rng(2026)
    out = {}
    rgb8 = (chip_smoke.ldr_rgb16(1024, 1536, 7) >> 8).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb8).save(buf, "WEBP", quality=75)
    out["lossy.webp"] = buf.getvalue()
    small = (chip_smoke.ldr_rgb16(96, 144, 8) >> 8).astype(np.uint8)
    y, x = np.mgrid[0:96, 0:144]
    alpha = np.clip((x * 2 + y) % 300 - 20, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([small, alpha[..., None]], -1), "RGBA").save(
        buf, "WEBP", quality=60, alpha_quality=40)
    out["alpha.webp"] = buf.getvalue()
    out["bc3.dds"] = dds_header(64, 48, None, b"DXT5") + rng.bytes(16 * 16 * 12)
    out["bc7.dds"] = dds_header(64, 48, 98, b"DX10") + rng.bytes(16 * 16 * 12)
    idx = (small[..., 0] // 32) * 8 + small[..., 1] // 32  # 64 colours
    pal_img = Image.fromarray(idx.astype(np.uint8), "P")
    pal_img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    buf = io.BytesIO()
    pal_img.save(buf, "GIF", transparency=int(idx[40, 70]), optimize=False)
    out["transparent.gif"] = buf.getvalue()
    out.update(variants())
    out.update(variants_b())
    return out


def save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def variants() -> dict[str, bytes]:
    import chip_smoke
    from chip_smoke import tiff_chunks as make_tiff, ycbcr_blocks
    from tests.test_torch_ldr import lzw_encode
    from tests.test_torch_ldr_variants import with_adobe

    rgb = (chip_smoke.ldr_rgb16(48, 64, 9) >> 8).astype(np.uint8)
    cmyk = Image.fromarray(np.concatenate([255 - rgb, rgb[..., 1:2] // 3], -1), "CMYK")
    out = {"cmyk_adobe.jpg": save(cmyk, "JPEG", quality=85)}
    out["ycck.jpg"] = with_adobe(out["cmyk_adobe.jpg"], 2)
    bits = Image.fromarray(rgb[..., 0] > 120)
    out["mh.tif"] = save(bits, "TIFF", compression="tiff_ccitt")
    out["g3_2d.tif"] = save(bits, "TIFF", compression="group3", tiffinfo={292: 1})
    out["g4.tif"] = save(bits, "TIFF", compression="group4")
    out["jpeg_cmyk.tif"] = save(cmyk, "TIFF", compression="jpeg")
    out["ycbcr22_lzw.tif"] = make_tiff(64, 48, [lzw_encode(ycbcr_blocks(
        rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2], 2, 2))],
        {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]), 530: (3, [2, 2])})
    out["lab.tif"] = save(Image.frombytes("LAB", (64, 48), rgb.tobytes()), "TIFF",
                          compression="tiff_adobe_deflate")
    return out


# Annex K's tables at quality 85 (libjpeg's scaling)
K_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
          57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
          55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
          100, 103, 99]
K_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99,
            99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32


def q85(table: list) -> np.ndarray:
    return np.clip((np.asarray(table) * 30 + 50) // 100, 1, 255)


def variants_b() -> dict[str, bytes]:
    import chip_smoke
    from chip_smoke import tiff_chunks as make_tiff, ycbcr_blocks
    from tests.test_torch_ldr import lzw_encode
    from tests.test_torch_ldr_variants_b import (arith_jpeg, coefficients, pack12, _hdiff,
                                                 _jpeg12, _thunder, ojpeg_file)

    w = chip_smoke.LDR_B_WIDTH
    rgb = (chip_smoke.ldr_rgb16(16, w, 24) >> 8).astype(np.uint8)
    quant = [q85(K_LUMA), q85(K_CHROMA)]
    samp = [(2, 2), (1, 1), (1, 1)]
    co = coefficients(rgb, samp, quant)
    mcus, yblocks = w // 16, (w // 8) * 2
    out = {"arith_seq.jpg": arith_jpeg(co, w, 16, samp, quant, restart=mcus)}
    script = [((0, 1, 2), 0, 0, 0, 1, mcus), ((0,), 1, 5, 0, 2, yblocks),
              ((1,), 1, 63, 0, 1, mcus), ((2,), 1, 63, 0, 1, mcus),
              ((0,), 6, 63, 0, 2, yblocks), ((0,), 1, 63, 2, 1, yblocks),
              ((1,), 1, 63, 1, 0, mcus), ((2,), 1, 63, 1, 0, mcus),
              ((0,), 1, 63, 1, 0, yblocks), ((0, 1, 2), 0, 0, 1, 0, mcus)]
    out["arith_prog.jpg"] = arith_jpeg(co, w, 16, samp, quant, scans=script, progressive=True)
    out["zstd_pred2.tif"] = save(Image.fromarray(np.ascontiguousarray(rgb[:8])), "TIFF",
                                 compression="zstd", tiffinfo={317: 2, 278: 8})
    small = (chip_smoke.ldr_rgb16(48, 64, 25) >> 8).astype(np.uint8)
    out["rlew.tif"] = save(Image.fromarray(small[..., 1] > 120), "TIFF",
                           compression="tiff_raw_16")
    out["thunder.tif"] = _thunder(48, 64, rows=16)
    grey12 = small[..., 0].astype(np.uint16) * 16 + small[..., 1] // 16
    out["twelve.tif"] = make_tiff(64, 48, [lzw_encode(pack12(grey12))],
                                  {258: (3, [12]), 259: (3, [5]), 262: (3, [1]), 277: (3, [1])})
    out["jpeg12.tif"] = make_tiff(64, 48, [_jpeg12(grey12.astype(np.float64), "prog")],
                                  {258: (3, [12]), 259: (3, [7]), 262: (3, [1]),
                                   277: (3, [1])})
    out["ycbcr_pred.tif"] = make_tiff(64, 48, [lzw_encode(_hdiff(ycbcr_blocks(
        small[..., 0], small[::2, ::2, 1], small[::2, ::2, 2], 2, 2), 96))],
        {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [6]), 277: (3, [3]),
         530: (3, [2, 2]), 317: (3, [2])})
    out["ojpeg.tif"] = ojpeg_file(48, 64, "4:2:0", "tables", restarts=True, seed=26)
    return out


def digests(files: dict[str, bytes]) -> dict:
    out = {}
    for name, data in sorted(files.items()):
        im = Image.open(io.BytesIO(data))
        out[name] = {"size": list(im.size)}
        if name.endswith((".jpg", ".tif")):
            out[name]["mode"] = im.mode
            px = np.ascontiguousarray(np.asarray(im))
            if im.mode == "1":  # PIL's bool array holds 0 and 255: hash 0 and 1
                px = (px != 0).astype(np.uint8)
            out[name]["samples"] = hashlib.sha256(px.tobytes()).hexdigest()
        for mode in ("RGB", "RGBA", "L"):
            if im.mode == "LAB" and mode == "L":
                continue  # PIL has no LAB -> L conversion
            px = np.ascontiguousarray(np.asarray(im.convert(mode)))
            out[name][mode] = hashlib.sha256(px.tobytes()).hexdigest()
    return out


if __name__ == "__main__":
    files = fixtures()
    for name, data in files.items():
        (HERE / name).write_bytes(data)
    (HERE / "digests.json").write_text(json.dumps(digests(files), indent=1) + "\n")
    print({n: len(d) for n, d in files.items()})
