"""The TIFF frames PIL does not read through an unpacker of libtiff's
samples (io/tiff.py reads the rest):

  * `ycbcr_rgb`: a YCbCr frame (photometric 6) that is not JPEG-compressed
    in one plane. libtiff's RGBA interface reads a compressed one for PIL
    (TiffDecode.c's readAsRGBA): chroma subsampled 4x4, 4x2, 4x1, 2x2,
    2x1, 1x2 or 1x1 in sampling blocks (Y of the block, then Cb and Cr),
    each pixel given its block's chroma, converted with tif_color.c's
    TIFFYCbCrToRGBInit tables from ReferenceBlackWhite and
    YCbCrCoefficients (single-precision float, as libtiff computes them);
    two planes only at 1x1. PIL reads an uncompressed one with its raw mode
    "RGBX": four bytes a pixel from each strip's offset, Y, Cb and Cr
    given as R, G and B, past the strip if the file goes on, "image file is
    truncated" where it does not.
  * `raw_planar`: an uncompressed planar frame, which PIL's raw decoder
    reads plane by plane with the layer's one-letter raw mode ("RGB;16L"
    gives "R", "G", "B": each plane's bytes read as 8-bit samples), a raw
    mode its unpackers lack raising ValueError.
"""

from __future__ import annotations

import numpy as np

from rapidraw_tpu_torch.io.tiff import (_BANDS, NONE, REVERSED, Frame, _decompress, _deferred,
                                        _PREDICTED, _tuple)

# libtiff's putcontig8bitYCbCr*tile routines
_SUBSAMPLINGS = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}


def _fix(x: np.float32) -> int:
    """tif_color.c FIX: (int32_t)(x * (1L << 16) + 0.5), the product in
    float, the sum in double."""
    return int(float(np.float32(x) * np.float32(65536.0)) + 0.5)


def _clamp(f: np.float32, lo: float, hi: float) -> np.float32:
    return np.float32(lo) if not f >= lo else np.float32(hi) if f > hi else f


def _code2v(c: np.ndarray, rb: np.float32, rw: np.float32, cr: int) -> np.ndarray:
    """tif_color.c Code2V on int32 codes: ((c - (int32_t)RB) * (float)CR) /
    (float)(RW - RB or 1), in float."""
    span = np.float32(rw - rb) if rw - rb != 0 else np.float32(1.0)
    v = (c - np.int32(np.trunc(rb))).astype(np.float32) * np.float32(cr) / span
    return np.trunc(np.clip(v, np.float32(-4096.0), np.float32(4096.0))).astype(np.int64)


def ycbcr_tables(refbw=None, luma=None) -> tuple:
    """TIFFYCbCrToRGBInit's tables (Y, Cr->R, Cb->B, Cr->G, Cb->G), each
    indexed by the 8-bit sample."""
    luma = (0.299, 0.587, 0.114) if luma is None else luma
    refbw = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0) if refbw is None else refbw
    lr, lg, lb = (np.float32(v) for v in luma)
    rbw = [np.float32(v) for v in refbw]
    f1 = np.float32(2) - np.float32(2) * lr
    d1 = _fix(_clamp(f1, 0.0, 2.0))
    d2 = -_fix(_clamp(np.float32(lr * f1 / lg), 0.0, 2.0))
    f3 = np.float32(2) - np.float32(2) * lb
    d3 = _fix(_clamp(f3, 0.0, 2.0))
    d4 = -_fix(_clamp(np.float32(lb * f3 / lg), 0.0, 2.0))
    x = np.arange(-128, 128, dtype=np.int64)
    half = np.float32(128.0)
    cr = _code2v(x, rbw[4] - half, rbw[5] - half, 127)
    cb = _code2v(x, rbw[2] - half, rbw[3] - half, 127)
    y = _code2v(x + 128, rbw[0], rbw[1], 255)
    one_half = 1 << 15
    cr_r = (d1 * cr + one_half) >> 16
    cb_b = (d3 * cb + one_half) >> 16
    return y, cr_r, cb_b, d2 * cr, d4 * cb + one_half


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """TIFFYCbCrtoRGB on u8 samples -> (..., 3) u8; `cb` and `cr` may be
    coarser, broadcasting over `y` (a block's chroma for each of its Y)."""
    ty, cr_r, cb_b, cr_g, cb_g = tables
    yy = ty.astype(np.int32)[y]
    out = np.empty(yy.shape + (3,), np.uint8)
    tmp = np.empty(yy.shape, np.int32)
    g = ((cb_g[cb] + cr_g[cr]) >> 16).astype(np.int32)
    for k, term in enumerate((cr_r[cr].astype(np.int32), g, cb_b[cb].astype(np.int32))):
        np.add(yy, term, out=tmp)
        np.clip(tmp, 0, 255, out=tmp)
        out[..., k] = tmp
    return out


def ycbcr_rgb(f: Frame, data) -> np.ndarray:
    """(H, W, 3) u8 of a YCbCr frame as PIL gives it (mode "RGB")."""
    if f.compression == NONE:
        if f.planar == 2:
            return raw_planar(f, data)[0]
        return _raw_tiles(f, data)[0]
    t = f.tags
    tables = ycbcr_tables(_tuple(t.get(532)) or None, _tuple(t.get(529)) or None)
    if f.planar == 2:
        if f.sub != (1, 1):
            raise OSError("libtiff reads planar YCbCr only without subsampling")
        px = f.samples(data)
        return ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], tables)
    hs, vs = f.sub
    if (hs, vs) not in _SUBSAMPLINGS:
        raise OSError(f"libtiff cannot read YCbCr subsampled {hs}x{vs}")
    predict = f.predictor if f.compression in _PREDICTED else 1
    if predict != 1 and (hs, vs) != (1, 1):
        raise _deferred("a subsampled YCbCr TIFF with a predictor")
    if (hs, vs) == (1, 1):
        px = f.samples(data)
        return ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], tables)
    out = np.empty((f.height, f.width, 3), np.uint8)
    unit = hs * vs + 2
    tiled = 322 in t and 324 in t
    for _, y0, x0, rows, keep, tw, off, cnt in f.chunks():
        bh, bv = -(-tw // hs), -(-rows // vs)
        size = bv * bh * unit
        if not tiled:
            # gtStripContig reads rows x TIFFScanlineSize, which divides a
            # row of blocks by the vertical subsampling (4x4: 18 bytes a
            # block, the last bytes of an odd count of blocks are lost) and
            # leaves the rest of its zeroed buffer
            size = bv * vs * (bh * unit // vs)
        chunk = bytes(data[off:off + cnt])
        if f.fill_order == 2:
            chunk = REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        raw = np.zeros(bv * bh * unit, np.uint8)
        raw[:size] = _decompress(chunk, f.compression, size)[:size]
        blocks = raw.reshape(bv, bh, unit)
        # each block's Y with its chroma, then the blocks' rows laid out
        y = blocks[..., :hs * vs].reshape(bv, bh, vs, hs)
        rgb = ycbcr_to_rgb(y, blocks[..., -2, None, None], blocks[..., -1, None, None], tables)
        rgb = rgb.transpose(0, 2, 1, 3, 4).reshape(bv * vs, bh * hs, 3)
        nx = min(tw, f.width - x0)
        out[y0:y0 + keep, x0:x0 + nx] = rgb[:keep, :nx]
    return out


# PIL's raw-mode unpackers of one band (Unpack.c): (mode, raw mode) ->
# (bits, band)
_BAND_UNPACKERS = {("RGB", c): (8, i) for i, c in enumerate("RGB")}
_BAND_UNPACKERS.update({("RGBA", c): (8, i) for i, c in enumerate("RGBA")})
_BAND_UNPACKERS.update({("CMYK", c): (8, i) for i, c in enumerate("CMYK")})
_BAND_UNPACKERS.update({("LAB", c): (8, i) for i, c in enumerate("LAB")})


def _pil_tiles(f: Frame):
    """TiffImagePlugin._setup's tiles of an uncompressed frame: (box,
    offset, raw mode, stride)."""
    t = f.tags
    xsize, ysize = f.width, f.height
    if 273 in t:
        offsets, h, w = _tuple(t[273]), int(t.get(278, ysize)), xsize
    else:
        offsets, w, h = _tuple(t[324]), int(t[322]), int(t[323])
    if w == xsize and h == ysize and f.planar != 2:
        offsets = offsets[-1:]
    count = {2: 3, 6: 3, 8: 3, 5: 4}.get(f.photo, 1) + len(f.extra)
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(f.bps) / 8 if x + w > xsize else 0
        rawmode = f.rawmode
        if f.planar == 2:
            rawmode = rawmode[layer]
            stride /= count
        yield (x, y, min(x + w, xsize), min(y + h, ysize)), int(offset), rawmode, int(stride)
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1


def _raw_tiles(f: Frame, data) -> tuple[np.ndarray, str]:
    """PIL's raw decoder over every tile: (H, W, bands) u8 and the mode."""
    mode = f.mode
    out = np.zeros((f.height, f.width, _BANDS.get(mode, 1)), np.uint8)
    for (x0, y0, x1, y1), offset, rawmode, stride in _pil_tiles(f):
        if mode == "RGB" and rawmode == "RGBX":
            bits, bands = 32, [0, 1, 2]
        elif (mode, rawmode) in _BAND_UNPACKERS:
            bits, band = _BAND_UNPACKERS[(mode, rawmode)]
            bands = [band]
        else:
            raise ValueError("unknown raw mode for given image mode")
        w, rows = x1 - x0, y1 - y0
        row_bytes = (w * bits + 7) // 8
        skip = stride - row_bytes if stride else 0
        if skip < 0:
            raise OSError("decoder error -8")
        pitch = row_bytes + skip
        need = rows * row_bytes + (rows - 1) * skip
        if rows <= 0 or w <= 0:
            continue
        if offset < 0 or len(data) - offset < need:
            raise OSError("image file is truncated")
        buf = np.frombuffer(bytes(data[offset:offset + rows * pitch]).ljust(rows * pitch, b"\0"),
                            np.uint8).reshape(rows, pitch)[:, :row_bytes]
        if f.fill_order == 2:
            buf = REVERSED[buf]
        px = buf.reshape(rows, w, bits // 8)
        for k, band in enumerate(bands):
            out[y0:y1, x0:x1, band] = px[..., k]
    if mode == "LAB":  # the one-band "A" and "B" unpackers: a and b unsigned
        out[..., 1:] ^= 128
    return out, mode


def raw_planar(f: Frame, data) -> tuple[np.ndarray, str]:
    """An uncompressed planar frame as PIL's raw decoder reads it: (the
    pixels, the mode)."""
    return _raw_tiles(f, data)
