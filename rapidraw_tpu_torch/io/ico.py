"""ICO decoding as PIL 12.1's IcoImagePlugin does it: the entry PIL picks
(the largest square, the lowest colour depth among equals), a PNG entry
through io/encode.py's PNG views, a BMP entry through io/bmp.py with its
height halved and its mask turned into alpha (the 32-bit entry's fourth
bytes, else the 1-bit AND mask, set bits transparent). `.size` is the
decoded entry's, as PIL settles it once loaded."""

from __future__ import annotations

import struct
from math import ceil, log

import numpy as np

from rapidraw_tpu_torch.io.image_decode import Frame, Unidentified, unpack_bits


def _entries(data: bytes) -> list[dict]:
    if len(data) < 6 or data[:4] != b"\x00\x00\x01\x00":
        raise Unidentified()
    (count,) = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise Unidentified()
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        (bpp,) = struct.unpack_from("<H", s, 6)
        size, offset = struct.unpack_from("<II", s, 8)
        depth = bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
        out.append(dict(dim=(width, height), square=width * height, bpp=bpp, size=size,
                        offset=offset, depth=depth))
    if not out:
        raise Unidentified()
    out.sort(key=lambda e: e["depth"])
    out.sort(key=lambda e: e["square"], reverse=True)
    return out


def _without_trns(png: bytes) -> bytes:
    out, pos = [png[:8]], 8
    while pos + 8 <= len(png):
        (ln,) = struct.unpack_from(">I", png, pos)
        chunk = png[pos:pos + 12 + ln]
        if png[pos + 4:pos + 8] != b"tRNS":
            out.append(chunk)
        if png[pos + 4:pos + 8] == b"IEND":
            break
        pos += 12 + ln
    return b"".join(out)


def decode_ico(data: bytes) -> Frame:
    from rapidraw_tpu_torch.io.bmp import decode_dib
    from rapidraw_tpu_torch.io.image_decode import png_frame

    data = bytes(data)
    e = _entries(data)[0]
    at = e["offset"]
    if data[at:at + 8] == b"\x89PNG\r\n\x1a\n":
        # the icon keeps the PNG's pixels and palette but not its info:
        # a tRNS chunk's transparency is lost
        frame = png_frame(_without_trns(data[at:]))
        frame.orientation = 1
        return frame
    frame, rows_at = decode_dib(data, at)
    w, h = frame.size
    if e["bpp"] == 32:
        a = np.frombuffer(data[rows_at:rows_at + w * h * 4], np.uint8)[3::4]
        if len(a) < w * h:
            raise ValueError("not enough image data")
        alpha = a.reshape(h, w)[::-1]
    else:
        mw = w + (32 - w % 32) % 32
        total = mw * h // 8
        mask_at = at + e["size"] - total
        m = np.frombuffer(data[max(mask_at, 0):max(mask_at, 0) + total], np.uint8)
        if mask_at < 0 or len(m) < total:
            raise ValueError("not enough image data")
        bits = unpack_bits(m.reshape(h, mw // 8), w, 1)[::-1]
        alpha = np.where(bits, 0, 255).astype(np.uint8)
    rgba = frame.convert("RGBA").copy()
    rgba[..., 3] = alpha
    return Frame("RGBA", rgba)
