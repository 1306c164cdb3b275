"""The port's JPEG decoder: csrc/host/jpeg_dec.cc over ctypes.

`decode_jpeg` gives the samples libjpeg-turbo gives PIL's `Image.open`
(mode "L" for one component, "RGB" for three); `decode_jpeg_rgb` and
`decode_jpeg_gray` add PIL's `convert("RGB")` and `convert("L")`. The
library builds with g++ at first use (`native.host_library`); a failed
build raises, and nothing stands in for it. The calls release the GIL, so
the export's prepare threads decode at once.

Refused with NotImplementedError (ROADMAP A.10c): arithmetic coding,
12-bit samples, lossless JPEG and CMYK / YCCK. A truncated file raises
OSError, as PIL does ("image file is truncated"); so does corrupt
entropy-coded data, which libjpeg decodes with a warning.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rapidraw_tpu_torch.io.encode import rgb_to_l

_TRUNCATED, _CORRUPT, _UNSUPPORTED = -2, -3, -4


def _lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("jpeg_dec")
    if not getattr(lib, "_rr_typed", False):
        lib.jpeg_dec_info.restype = ctypes.c_int
        lib.jpeg_dec_info.argtypes = [ctypes.c_char_p, ctypes.c_long] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.jpeg_dec_decode.restype = ctypes.c_int
        lib.jpeg_dec_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long]
        lib.jpeg_dec_error.restype = ctypes.c_char_p
        lib._rr_typed = True
    return lib


def _raise(lib, rc: int):
    msg = lib.jpeg_dec_error().decode(errors="replace")
    if rc == _UNSUPPORTED:
        raise NotImplementedError(
            f"rapidraw_tpu_torch does not decode {msg} yet (ROADMAP A.10c)")
    if rc in (_TRUNCATED, _CORRUPT):
        raise OSError(msg)
    raise ValueError(f"jpeg decode failed (code {rc})")


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(width, height, channels) of a JPEG: channels 1 (grey) or 3."""
    lib = _lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_dec_info(bytes(data), len(data), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c))
    if rc:
        _raise(lib, rc)
    return w.value, h.value, c.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W) grey or (H, W, 3) RGB uint8, as PIL opens it."""
    data = bytes(data)
    lib = _lib()
    w, h, c = jpeg_info(data)
    out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
    rc = lib.jpeg_dec_decode(data, len(data), out.ctypes.data, out.size)
    if rc:
        _raise(lib, rc)
    return out


def decode_jpeg_rgb(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W, 3) uint8, as PIL's convert("RGB") gives it."""
    px = decode_jpeg(data)
    return np.repeat(px[..., None], 3, axis=2) if px.ndim == 2 else px


def decode_jpeg_gray(data: bytes) -> np.ndarray:
    """A JPEG -> (H, W) uint8, as PIL's convert("L") gives it."""
    px = decode_jpeg(data)
    return px if px.ndim == 2 else rgb_to_l(px)
