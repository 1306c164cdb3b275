"""WebP decoding: the RIFF container in Python, the bitstreams in
csrc/host/webp_dec.cc over ctypes.

`decode_webp` gives the frame PIL 12.1 gives through libwebp 1.6.0's
WebPAnimDecoder: mode "RGBA" when WebPGetFeatures reports alpha (a VP8X
file's alpha flag or ALPH chunk, a VP8L header's alpha hint; an animation's
VP8X flag alone), else "RGB"; an animation shows its first frame on a
canvas cleared to transparent black. RGB under alpha 0 is kept, as libwebp
does not premultiply. A container or bitstream libwebp refuses raises
OSError, as PIL's decoder object does. The library builds with g++ at
first use (`native.host_library`); a failed build raises KernelBuildError.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_ALPHA_FLAG, _ANIM_FLAG = 0x10, 0x02


def _lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("webp_dec")
    if not getattr(lib, "_rr_typed", False):
        for name in ("webp_vp8l_decode", "webp_alph_decode", "webp_vp8_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int]
        lib._rr_typed = True
    return lib


def _chunks(data: bytes, start: int, end: int) -> list[tuple[bytes, bytes]]:
    """(fourcc, payload) of each chunk in data[start:end]; a chunk that
    runs past `end` is an error, as the demuxer finds it."""
    out, pos = [], start
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise OSError("could not create decoder object")
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _vp8l_size(payload: bytes) -> tuple[int, int, bool]:
    if len(payload) < 5 or payload[0] != 0x2F:
        raise OSError("could not create decoder object")
    (bits,) = struct.unpack_from("<I", payload, 1)
    if bits >> 29:
        raise OSError("could not create decoder object")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def _vp8_size(payload: bytes, whole: bool = True) -> tuple[int, int]:
    """(width, height) of a VP8 key frame; `whole`: the payload is all
    there, so its first partition must fit in it."""
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise OSError("could not create decoder object")
    bits = payload[0] | payload[1] << 8 | payload[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise OSError("could not create decoder object")
    if whole and (bits >> 5) >= len(payload):
        raise OSError("could not create decoder object")
    w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
    if not w or not h:
        raise OSError("could not create decoder object")
    return w, h


def _check(rc: int) -> None:
    if rc:
        raise OSError("failed to read next frame")


def _decode_frame(chunks: list[tuple[bytes, bytes]], w: int, h: int) -> np.ndarray:
    """(h, w, 4) RGBA of a frame's ALPH + VP8 or VP8L chunks."""
    lib = _lib()
    alph = next((p for t, p in chunks if t == b"ALPH"), None)
    for tag, payload in chunks:
        if tag == b"VP8L":
            if _vp8l_size(payload)[:2] != (w, h):
                raise OSError("could not create decoder object")
            argb = np.empty(w * h, np.uint32)
            _check(lib.webp_vp8l_decode(payload, len(payload), argb.ctypes.data, w, h))
            b = argb.view(np.uint8).reshape(h, w, 4)  # little-endian B, G, R, A
            return np.ascontiguousarray(b[..., [2, 1, 0, 3]])
        if tag == b"VP8 ":
            if _vp8_size(payload) != (w, h):
                raise OSError("could not create decoder object")
            rgba = np.empty((h, w, 4), np.uint8)
            _check(lib.webp_vp8_decode(payload, len(payload), rgba.ctypes.data, w, h))
            if alph is not None:
                a = np.empty((h, w), np.uint8)
                _check(lib.webp_alph_decode(alph, len(alph), a.ctypes.data, w, h))
                rgba[..., 3] = a
            return rgba
    raise OSError("could not create decoder object")


def webp_size(head: bytes) -> tuple[int, int]:
    """(width, height) from the first chunk of a file's first bytes, as
    PIL's `.size`: a VP8X file's canvas, else its VP8L or VP8 frame."""
    if len(head) < 20 or head[:4] != b"RIFF" or head[8:12] != b"WEBP":
        raise OSError("could not create decoder object")
    tag, payload = head[12:16], head[20:]
    if tag == b"VP8X" and len(payload) >= 10:
        return (1 + (payload[4] | payload[5] << 8 | payload[6] << 16),
                1 + (payload[7] | payload[8] << 8 | payload[9] << 16))
    if tag == b"VP8L":
        return _vp8l_size(payload)[:2]
    if tag == b"VP8 ":
        return _vp8_size(payload, whole=False)
    raise OSError("could not create decoder object")


def _parse(data: bytes):
    """(width, height, has alpha as WebPGetFeatures reports it, the frame's
    chunks, the first animation frame's rectangle or None)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise OSError("could not create decoder object")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or riff + 8 > len(data):
        raise OSError("could not create decoder object")
    chunks = _chunks(data, 12, riff + 8)
    if not chunks:
        raise OSError("could not create decoder object")
    tag, payload = chunks[0]
    if tag == b"VP8L":
        w, h, alpha = _vp8l_size(payload)
        return w, h, alpha, [chunks[0]], None
    if tag == b"VP8 ":
        w, h = _vp8_size(payload)
        return w, h, False, [chunks[0]], None
    if tag != b"VP8X" or len(payload) < 10:
        raise OSError("could not create decoder object")
    flags = payload[0]
    cw = 1 + (payload[4] | payload[5] << 8 | payload[6] << 16)
    ch = 1 + (payload[7] | payload[8] << 8 | payload[9] << 16)
    if flags & _ANIM_FLAG:
        anmf = next((p for t, p in chunks if t == b"ANMF"), None)
        if anmf is None or len(anmf) < 16:
            raise OSError("could not create decoder object")
        x0 = 2 * (anmf[0] | anmf[1] << 8 | anmf[2] << 16)
        y0 = 2 * (anmf[3] | anmf[4] << 8 | anmf[5] << 16)
        fw = 1 + (anmf[6] | anmf[7] << 8 | anmf[8] << 16)
        fh = 1 + (anmf[9] | anmf[10] << 8 | anmf[11] << 16)
        if x0 + fw > cw or y0 + fh > ch:
            raise OSError("could not create decoder object")
        frame = _chunks(anmf, 16, len(anmf))
        return cw, ch, bool(flags & _ALPHA_FLAG), frame, (x0, y0, fw, fh)
    image = [(t, p) for t, p in chunks[1:] if t in (b"ALPH", b"VP8 ", b"VP8L")]
    body = next(((t, p) for t, p in image if t != b"ALPH"), None)
    if body is None:
        raise OSError("could not create decoder object")
    if body[0] == b"VP8L":
        w, h, alpha = _vp8l_size(body[1])
    else:
        w, h = _vp8_size(body[1])
        alpha = bool(flags & _ALPHA_FLAG) or any(t == b"ALPH" for t, _ in image)
    if (w, h) != (cw, ch):
        raise OSError("could not create decoder object")
    return w, h, alpha, image, None


def decode_webp(data: bytes) -> tuple[np.ndarray, str]:
    """A WebP file -> ((H, W, 3 or 4) uint8, "RGB" or "RGBA"), as PIL opens
    it (the first frame of an animation)."""
    data = bytes(data)
    w, h, alpha, frame, rect = _parse(data)
    if rect is None:
        rgba = _decode_frame(frame, w, h)
    else:
        x0, y0, fw, fh = rect
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[y0:y0 + fh, x0:x0 + fw] = _decode_frame(frame, fw, fh)
    if alpha:
        return rgba, "RGBA"
    return np.ascontiguousarray(rgba[..., :3]), "RGB"
