"""Write the LDR-format fixtures of this folder with PIL 12.1 (libwebp
1.6.0), and digests.json: each file's size and the SHA-256 of PIL's
`Image.open(f).convert(mode)` bytes for "RGB", "RGBA" and "L".

    PYTHONPATH=. python tests/fixtures/ldr/make_fixtures.py

The files: a 1024 x 1536 lossy WebP (q75) of chip_smoke.ldr_rgb16's
photograph, a lossy WebP with a lossy alpha plane, BC3 and BC7 DDS files
of seeded random blocks (PIL decodes any block), and a GIF with a
transparency index. The port reads them without PIL (chip_smoke phase 21,
tests/test_torch_ldr_formats.py)."""

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
    return out


def digests(files: dict[str, bytes]) -> dict:
    out = {}
    for name, data in sorted(files.items()):
        im = Image.open(io.BytesIO(data))
        out[name] = {"size": list(im.size)}
        for mode in ("RGB", "RGBA", "L"):
            px = np.ascontiguousarray(np.asarray(im.convert(mode)))
            out[name][mode] = hashlib.sha256(px.tobytes()).hexdigest()
    return out


if __name__ == "__main__":
    files = fixtures()
    for name, data in files.items():
        (HERE / name).write_bytes(data)
    (HERE / "digests.json").write_text(json.dumps(digests(files), indent=1) + "\n")
    print({n: len(d) for n, d in files.items()})
