"""The port's `Image.open`: one sniffing dispatcher over its own decoders.

`open_image(data)` identifies the bytes as PIL 12.1 does (by magic; TGA,
which has none, by its header, last, when nothing else matches) and gives
a `Frame`: the mode, samples and palette PIL holds once the image is
loaded, its `.size` and the EXIF orientation PIL's `getexif()` finds.
`Frame.convert(mode)` and `decode_image(data, mode)` give what
`Image.open(BytesIO(data)).convert(mode)` gives for "RGB", "RGBA" and "L",
in PIL's own arithmetic:

  * P -> RGB / RGBA through the 256-entry palette (entries a file does not
    set are black), the `transparency` index at alpha 0 in RGBA;
  * L, LA, 1 and P -> RGB replicate or look up; I, I;16 and F clip to
    0..255 (F truncated toward zero);
  * CMYK -> RGB as Convert.c's cmyk2rgb; LAB -> RGB through littlecms's
    Lab to sRGB transform (io/lab.py), and no LAB -> L, as in PIL;
  * RGB / RGBA / P -> L: (r*19595 + g*38470 + b*7471 + 0x8000) >> 16;
  * RGBA -> RGB drops alpha; L with a transparent value -> RGBA gives that
    value alpha 0.

JPEG, PNG and TIFF go to io/jpeg.py, io/encode.py and io/tiff.py; WebP,
GIF, BMP, TGA, ICO, DDS, QOI and PNM (P1-P6) to the modules beside this
one. Bytes nothing identifies raise OSError, as PIL's
UnidentifiedImageError (an OSError) does; a file PIL opens but fails to
load raises the exception class PIL raises. `image_size(head, read_all)`
gives PIL's `.size` from the header alone, where the format allows it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from rapidraw_tpu_torch.io.encode import cmyk_to_rgb, rgb_to_l

MODES = ("RGB", "RGBA", "L")


class Unidentified(OSError):
    """A header the format's PIL reader turns away while opening (its
    SyntaxError, IndexError, struct.error or EOFError): PIL then tries the
    readers after it, TGA among them, before it gives up with
    UnidentifiedImageError."""

    def __init__(self, msg: str = "cannot identify image file"):
        super().__init__(msg)


def palette_from(colors: np.ndarray, alpha: bool = False) -> np.ndarray:
    """(256, 4) palette with the first len(colors) entries set from (N, 3)
    or (N, 4) colours, the rest black, as PIL pads a short palette; alpha
    255 unless the palette carries its own."""
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    n = min(len(colors), 256)
    if n:
        pal[:n, :3] = colors[:n, :3]
        if alpha and colors.shape[1] == 4:
            pal[:n, 3] = colors[:n, 3]
    return pal


@dataclass
class Frame:
    """An image as PIL holds it once loaded."""

    mode: str  # "1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "LAB", "I", "I;16" or "F"
    px: np.ndarray | None  # (H, W) or (H, W, C); int32 "I", u16 "I;16", float32 "F"
    palette: np.ndarray | None = None  # (256, 4) u8 for "P"
    transparency: int | None = None  # P index or L value, alpha 0 in RGBA
    orientation: int = 1
    size_: tuple[int, int] | None = None
    converter: Callable[[str], np.ndarray] | None = field(default=None, repr=False)

    @property
    def size(self) -> tuple[int, int]:
        """(width, height), as PIL's `.size`."""
        if self.size_ is not None:
            return self.size_
        return int(self.px.shape[1]), int(self.px.shape[0])

    def convert(self, mode: str) -> np.ndarray:
        if mode not in MODES:
            raise ValueError(f"conversion to {mode} is not supported")
        if self.converter is not None:
            return self.converter(mode)
        px, m = self.px, self.mode
        if m in ("I", "I;16", "I;16B"):
            g = np.clip(px, 0, 255).astype(np.uint8)
            if mode == "L":
                return g
            rgb = np.repeat(g[..., None], 3, axis=2)
            return rgb if mode == "RGB" else _with_alpha(rgb, None)
        if m in ("1", "L"):
            if mode == "L":
                return np.ascontiguousarray(px)
            rgb = np.repeat(px[..., None], 3, axis=2)
            if mode == "RGB":
                return rgb
            alpha = None
            if self.transparency is not None:
                alpha = np.where(px == self.transparency, 0, 255).astype(np.uint8)
            return _with_alpha(rgb, alpha)
        if m == "LA":
            if mode == "L":
                return np.ascontiguousarray(px[..., 0])
            rgb = np.repeat(px[..., :1], 3, axis=2)
            return rgb if mode == "RGB" else _with_alpha(rgb, px[..., 1])
        if m == "P":
            pal = self.palette
            if mode == "L":
                return rgb_to_l(pal[:, :3])[px]
            if mode == "RGB":
                return pal[:, :3][px]
            pal = pal.copy()
            if self.transparency is not None and 0 <= self.transparency < 256:
                pal[self.transparency, 3] = 0
            return pal[px]
        if m == "RGB":
            if mode == "RGB":
                return np.ascontiguousarray(px)
            return rgb_to_l(px) if mode == "L" else _with_alpha(px, None)
        if m == "RGBA":
            if mode == "RGBA":
                return np.ascontiguousarray(px)
            return rgb_to_l(px[..., :3]) if mode == "L" else np.ascontiguousarray(px[..., :3])
        if m in ("CMYK", "LAB"):
            if m == "CMYK":
                rgb = cmyk_to_rgb(px)
            elif mode == "L":  # PIL has no LAB -> L conversion
                raise ValueError("conversion from LAB to L not supported")
            else:  # ImageCms, Lab to sRGB (io/lab.py)
                from rapidraw_tpu_torch.io.lab import lab_to_srgb

                rgb = lab_to_srgb(px)
            if mode == "RGB":
                return rgb
            return rgb_to_l(rgb) if mode == "L" else _with_alpha(rgb, None)
        if m == "F":
            g = float_to_l(px)
            if mode == "L":
                return g
            rgb = np.repeat(g[..., None], 3, axis=2)
            return rgb if mode == "RGB" else _with_alpha(rgb, None)
        raise ValueError(f"unknown mode {m}")


def float_to_l(px: np.ndarray) -> np.ndarray:
    """PIL's "F" -> "L" (Convert.c f2l): 0 at or below 0, 255 at or above
    255, else truncated toward zero."""
    f = np.asarray(px, np.float32)
    g = np.clip(f, np.float32(0.0), np.float32(255.0))
    g[np.isnan(g)] = 0  # a NaN of either sign gives 0, as in PIL
    return g.astype(np.uint8)


def _with_alpha(rgb: np.ndarray, alpha: np.ndarray | None) -> np.ndarray:
    a = np.full(rgb.shape[:2], 255, np.uint8) if alpha is None else alpha
    return np.concatenate([rgb, a[..., None]], axis=-1)


def png_frame(data: bytes) -> Frame:
    """A PNG through io/encode.py's views, which give PIL's conversions."""
    import struct

    from rapidraw_tpu_torch.io.encode import decode_png_gray, decode_png_rgb, decode_png_rgba
    from rapidraw_tpu_torch.io.exif import image_orientation

    views = {"RGB": decode_png_rgb, "RGBA": decode_png_rgba, "L": decode_png_gray}
    w, h = struct.unpack_from(">II", data, 16) if len(data) >= 24 else (0, 0)
    mode = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}.get(data[25] if len(data) > 25 else -1,
                                                              "RGB")
    return Frame(mode, None, orientation=image_orientation(data), size_=(w, h),
                 converter=lambda m: views[m](data))


def _jpeg_frame(data: bytes) -> Frame:
    from rapidraw_tpu_torch.io.exif import image_orientation
    from rapidraw_tpu_torch.io.jpeg import decode_jpeg

    px = decode_jpeg(data)
    mode = "L" if px.ndim == 2 else "RGB" if px.shape[2] == 3 else "CMYK"
    return Frame(mode, px, orientation=image_orientation(data))


def _tiff_frame(data: bytes) -> Frame:
    from rapidraw_tpu_torch.io.exif import image_orientation
    from rapidraw_tpu_torch.io.tiff import decode_tiff

    # PIL's TIFF load turns the pixels by IFD0's Orientation, and getexif()
    # still reports it: the JAX loader turns them again
    px, mode = decode_tiff(data)
    return Frame(mode, px, orientation=image_orientation(data))


def _is_pnm(head: bytes) -> bool:
    return len(head) >= 2 and head[:1] == b"P" and head[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                                                b"6")


def identify(data: bytes) -> str | None:
    """The format PIL would open the bytes as, of those the port decodes
    ("jpeg", "png", "tiff", "webp", "gif", "bmp", "ico", "dds", "qoi",
    "pnm", "tga"), or None."""
    head = bytes(data[:16])
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:4] in (b"MM\x00\x2a", b"II\x2a\x00"):
        return "tiff"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP" and head[12:16] in (b"VP8 ", b"VP8L",
                                                                         b"VP8X"):
        return "webp"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if head[:2] == b"BM":
        return "bmp"
    if head[:4] == b"\x00\x00\x01\x00":
        return "ico"
    if head[:4] == b"DDS ":
        return "dds"
    if head[:4] == b"qoif":
        return "qoi"
    if _is_pnm(head):
        return "pnm"
    from rapidraw_tpu_torch.io.tga import looks_like_tga

    return "tga" if looks_like_tga(data) else None


def _sniffed(data: bytes, fn: Callable[[bytes, str], object]):
    """fn(data, format) for the format `identify` finds; where that
    format's reader turns the header away, TGA's reader, as PIL tries the
    readers after it."""
    from rapidraw_tpu_torch.io.tga import looks_like_tga

    fmt = identify(data)
    if fmt is None:
        raise OSError("cannot identify image file")
    try:
        return fn(data, fmt)
    except Unidentified:
        if fmt != "tga" and looks_like_tga(data):
            return fn(data, "tga")
        raise


def open_image(data: bytes) -> Frame:
    """Identify and decode `data` as PIL's `Image.open(...)` + `load()`."""
    return _sniffed(bytes(data), _open)


def image_size(head: bytes, read_all: Callable[[], bytes]) -> tuple[int, int]:
    """(width, height) as PIL's `Image.open(...).size`, from a file's first
    bytes (64 KB hold any header but JPEG's, TIFF's and an icon's).
    `read_all()` gives the whole file where the size needs more: a JPEG's
    SOF may follow large APP segments, a TIFF's IFD lies anywhere, PIL
    settles an icon's size by loading its chosen entry, and a GIF's first
    frame, which can grow the size, may follow large extensions."""
    return _sniffed(bytes(head), lambda data, fmt: _size(data, fmt, read_all))


def _size(head: bytes, fmt: str, read_all: Callable[[], bytes]) -> tuple[int, int]:
    import struct

    if fmt == "jpeg":
        from rapidraw_tpu_torch.io.jpeg import jpeg_info

        return tuple(jpeg_info(read_all())[:2])
    if fmt == "png":
        return struct.unpack_from(">II", head, 16)
    if fmt == "tiff":
        from rapidraw_tpu_torch.io.tiff import Frame as TiffFrame

        fr = TiffFrame(read_all())
        return fr.width, fr.height
    if fmt == "ico":
        from rapidraw_tpu_torch.io.ico import decode_ico

        return decode_ico(read_all()).size
    if fmt == "webp":
        from rapidraw_tpu_torch.io.webp import webp_size

        return webp_size(head)
    if fmt == "gif":  # the first frame's descriptor may lie past the head
        from rapidraw_tpu_torch.io.gif import gif_size

        try:
            return gif_size(head)
        except Unidentified:
            return gif_size(read_all())
    if fmt == "bmp":
        from rapidraw_tpu_torch.io.bmp import bmp_size

        return bmp_size(head)
    if fmt == "dds":
        from rapidraw_tpu_torch.io.dds import dds_header

        return dds_header(head)
    if fmt == "qoi":
        from rapidraw_tpu_torch.io.qoi import qoi_size

        return qoi_size(head)
    if fmt == "pnm":
        from rapidraw_tpu_torch.io.pnm import pnm_size

        return pnm_size(head)
    from rapidraw_tpu_torch.io.tga import tga_size

    return tga_size(head)


def _open(data: bytes, fmt: str) -> Frame:
    if fmt == "jpeg":
        return _jpeg_frame(data)
    if fmt == "png":
        return png_frame(data)
    if fmt == "tiff":
        return _tiff_frame(data)
    if fmt == "webp":
        from rapidraw_tpu_torch.io.exif import image_orientation
        from rapidraw_tpu_torch.io.webp import decode_webp

        px, mode = decode_webp(data)
        return Frame(mode, px, orientation=image_orientation(data))
    if fmt == "gif":
        from rapidraw_tpu_torch.io.gif import decode_gif

        return decode_gif(data)
    if fmt == "bmp":
        from rapidraw_tpu_torch.io.bmp import decode_bmp

        return decode_bmp(data)
    if fmt == "ico":
        from rapidraw_tpu_torch.io.ico import decode_ico

        return decode_ico(data)
    if fmt == "dds":
        from rapidraw_tpu_torch.io.dds import decode_dds

        return decode_dds(data)
    if fmt == "qoi":
        from rapidraw_tpu_torch.io.qoi import decode_qoi

        return decode_qoi(data)
    if fmt == "pnm":
        from rapidraw_tpu_torch.io.pnm import decode_pnm

        return decode_pnm(data)
    from rapidraw_tpu_torch.io.tga import decode_tga

    return decode_tga(data)


def decode_image(data: bytes, mode: str = "RGB") -> np.ndarray:
    """(H, W, 3) "RGB", (H, W, 4) "RGBA" or (H, W) "L" u8 of any image the
    port decodes, as `Image.open(BytesIO(data)).convert(mode)` gives it."""
    return open_image(data).convert(mode)


def ldr_lib():
    """csrc/host/ldr_dec.cc: the GIF, QOI, TGA and BMP pixel loops."""
    import ctypes

    from rapidraw_tpu_torch.native import host_library

    lib = host_library("ldr_dec")
    if not getattr(lib, "_rr_typed", False):
        c_int, c_long, c_ptr = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
        lib.gif_lzw_decode.argtypes = [ctypes.c_char_p, c_long, c_int, c_int, c_ptr, c_int, c_int,
                                       c_int, c_int, c_int]
        lib.qoi_decode.argtypes = [ctypes.c_char_p, c_long, c_ptr, c_int, c_int, c_int]
        lib.tga_rle_decode.argtypes = [ctypes.c_char_p, c_long, c_ptr, c_int, c_int, c_int]
        lib.bmp_rle_decode.argtypes = [ctypes.c_char_p, c_long, c_long, c_int, c_int, c_int, c_ptr,
                                       ctypes.POINTER(c_long)]
        for fn in (lib.gif_lzw_decode, lib.qoi_decode, lib.tga_rle_decode, lib.bmp_rle_decode):
            fn.restype = c_int
        lib._rr_typed = True
    return lib


TRUNCATED, BROKEN, INDEX_ERROR, VALUE_ERROR = -2, -3, -4, -5


def raise_status(rc: int) -> None:
    """The exception PIL raises for a pixel loop's failure code."""
    if rc == TRUNCATED:
        raise OSError("image file is truncated")
    if rc == BROKEN:
        raise OSError("broken data stream when reading image file")
    if rc == INDEX_ERROR:
        raise IndexError("index out of range")
    if rc == VALUE_ERROR:
        raise ValueError("not enough image data")
    if rc:
        raise ValueError(f"decoder failed (code {rc})")


def unpack_raw(data: bytes, offset: int, w: int, h: int, bits: int, stride: int = 0,
               bottom_up: bool = False) -> np.ndarray:
    """(h, stride) bytes of raw rows from data[offset:] (stride 0: packed
    (w*bits+7)//8), bottom-up rows turned top-down. Short data raises
    OSError, as PIL's raw decoder reports a truncated file."""
    row = (w * bits + 7) // 8
    stride = stride or row
    need = stride * (h - 1) + row
    if offset < 0 or len(data) - offset < need:
        raise OSError("image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=need, offset=offset)
    if stride * h > need:
        buf = np.concatenate([buf, np.zeros(stride * h - need, np.uint8)])
    rows = buf.reshape(h, stride)[:, :row]
    return rows[::-1] if bottom_up else rows


def unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """1-, 2- or 4-bit samples, most significant first, of (h, row) bytes."""
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w].astype(np.uint8)
