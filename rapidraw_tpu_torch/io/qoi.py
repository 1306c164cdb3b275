"""QOI decoding as PIL 12.1's QoiImagePlugin does it, with the pixel loop
in csrc/host/ldr_dec.cc: mode "RGB" for 3 channels, "RGBA" for any other
count; a header PIL cannot read raises OSError (PIL's
UnidentifiedImageError), data that runs out raises the IndexError or
ValueError PIL's decoder raises."""

from __future__ import annotations

import struct

import numpy as np

from rapidraw_tpu_torch.io.image_decode import Frame, Unidentified, ldr_lib, raise_status


def qoi_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the header, as PIL's `.size`."""
    if len(data) < 14 or data[:4] != b"qoif":
        raise Unidentified()
    w, h = struct.unpack_from(">II", data, 4)
    if w == 0 or h == 0:
        raise Unidentified()
    return w, h


def decode_qoi(data: bytes) -> Frame:
    data = bytes(data)
    w, h = qoi_size(data)
    channels = 3 if data[12] == 3 else 4
    out = np.empty((h, w, channels), np.uint8)
    raise_status(ldr_lib().qoi_decode(data[14:], len(data) - 14, out.ctypes.data, w, h, channels))
    return Frame("RGB" if channels == 3 else "RGBA", out)
