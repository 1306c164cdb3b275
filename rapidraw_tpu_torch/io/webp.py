"""WebP decoding and lossy encoding: the RIFF container in Python, the
bitstreams in csrc/host/webp_dec.cc and csrc/host/webp_enc.cc over ctypes.

`decode_webp` gives the frame PIL 12.1 gives through libwebp 1.6.0's
WebPAnimDecoder: mode "RGBA" when WebPGetFeatures reports alpha (a VP8X
file's alpha flag or ALPH chunk, a VP8L header's alpha hint; an animation's
VP8X flag alone), else "RGB"; an animation shows its first frame on a
canvas cleared to transparent black. RGB under alpha 0 is kept, as libwebp
does not premultiply. A container or bitstream libwebp refuses raises
OSError, as PIL's decoder object does.

`encode_webp` writes what the JAX package's export writes through PIL
(`Image.save(..., "WEBP", quality=q)`): a lossy VP8 key frame in the simple
RIFF / WEBP / "VP8 " layout, at the quantizer index libwebp gives that
quality (`QUALITY_TO_INDEX`). The encoder is the port's own
(csrc/host/webp_enc.cc); its bytes are not libwebp's, its decoded pixels
are its own reconstruction (`webp_reconstruction`). Both libraries build
with g++ at first use (`native.host_library`); a failed build raises
KernelBuildError.
"""

from __future__ import annotations

import ctypes
import os
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


# libwebp 1.6's quantizer index for each quality 0..100 at a segment of
# middling activity (QualityToCompression with alpha 0: 127 * (1 - c), c =
# (2q/3 below 0.75, else 2q - 1) ** (1/3), truncated); PIL's files carry it
# between their segments' quantizers (tests/test_torch_webp_enc.py)
QUALITY_TO_INDEX = (
    127, 103, 96, 92, 89, 86, 83, 81, 79, 77, 75, 73, 72, 70, 69, 68, 66, 65, 64, 63, 62,
    61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 51, 50, 49, 48, 48, 47, 46, 45, 45, 44,
    43, 43, 42, 41, 41, 40, 40, 39, 38, 38, 37, 37, 36, 36, 35, 35, 34, 33, 33, 32, 32,
    31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26, 26, 24, 23, 22, 21, 19, 18, 17, 16,
    15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 0,
)
MAX_SIDE = 16383  # VP8's 14-bit frame size
_TOO_LARGE = "encoding error 5: Image size exceeds WebP limit of 16383 pixels"


def _enc_lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("webp_enc")
    if not getattr(lib, "_rr_typed", False):
        lib.webp_encode.restype = ctypes.c_long
        lib.webp_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        lib.webp_enc_free.restype = None
        lib.webp_enc_free.argtypes = [ctypes.c_void_p]
        lib._rr_typed = True
    return lib


def _encode(rgb: np.ndarray, quality, recon: bool) -> tuple[bytes, np.ndarray | None]:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    if not 0 <= quality <= 100:
        raise ValueError("invalid configuration")  # libwebp's WebPValidateConfig, as PIL says
    h, w = rgb.shape[:2]
    if w > MAX_SIDE or h > MAX_SIDE:
        raise ValueError(_TOO_LARGE)
    lib = _enc_lib()
    frame = np.empty((h, w, 4), np.uint8) if recon else None
    out = ctypes.c_void_p()
    n = lib.webp_encode(rgb.ctypes.data, w, h, w * 3, QUALITY_TO_INDEX[int(quality)],
                        os.cpu_count() or 1, ctypes.byref(out),
                        frame.ctypes.data if recon else None)
    if n < 0:  # libwebp's error numbers, as PIL reports them
        raise ValueError(f"encoding error {-n}")
    try:
        data = ctypes.string_at(out, n)
    finally:
        lib.webp_enc_free(out)
    return data, (np.ascontiguousarray(frame[..., :3]) if recon else None)


def encode_webp(rgb_u8_hwc: np.ndarray, quality) -> bytes:
    """(H, W, 3) uint8 -> a lossy WebP file at `quality` (0..100), as the
    JAX package's PIL save writes one: a side past 16383 pixels raises
    PIL's ValueError."""
    return _encode(rgb_u8_hwc, quality, False)[0]


def webp_reconstruction(rgb_u8_hwc: np.ndarray, quality) -> tuple[bytes, np.ndarray]:
    """`encode_webp`'s file and the (H, W, 3) uint8 frame the encoder
    reconstructs for it, loop filter and upsampling applied: what any VP8
    decoder gives for the file."""
    data, frame = _encode(rgb_u8_hwc, quality, True)
    return data, frame


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


class _BoolReader:
    """RFC 6386's boolean decoder (section 7.3), for the frame header."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8 | data[1]) if len(data) >= 2 else 0
        self.range, self.count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            out = 1
        else:
            self.range = split
            out = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0


def vp8_frame_header(payload: bytes) -> dict:
    """The first fields of a VP8 key frame's header (RFC 6386 section
    9.2-9.6): the segment map's quantizers and filter levels, the loop
    filter, the token partitions and the quantizer indices."""
    w, h = _vp8_size(payload)
    br = _BoolReader(payload[10:])
    br.literal(2)  # colour space, clamping type
    seg = {"enabled": bool(br.bit(128)), "update_map": False, "absolute": True,
           "quant": [0] * 4, "filter": [0] * 4}
    if seg["enabled"]:
        seg["update_map"] = bool(br.bit(128))
        if br.bit(128):
            seg["absolute"] = bool(br.bit(128))
            seg["quant"] = [br.optional_signed(7) for _ in range(4)]
            seg["filter"] = [br.optional_signed(6) for _ in range(4)]
        if seg["update_map"]:
            for _ in range(3):
                if br.bit(128):
                    br.literal(8)
    filt = {"simple": br.bit(128), "level": br.literal(6), "sharpness": br.literal(3),
            "deltas": None}
    if br.bit(128) and br.bit(128):
        filt["deltas"] = ([br.optional_signed(6) for _ in range(4)],
                          [br.optional_signed(6) for _ in range(4)])
    partitions = 1 << br.literal(2)
    quant = {"y_ac": br.literal(7)}
    for name in ("y_dc", "y2_dc", "y2_ac", "uv_dc", "uv_ac"):
        quant[name] = br.optional_signed(4)
    return {"width": w, "height": h, "segments": seg, "filter": filt,
            "partitions": partitions, "quant": quant}
