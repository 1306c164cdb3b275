"""The TIFF frames PIL does not read through an unpacker of libtiff's
samples (io/tiff.py reads the rest):

  * `ycbcr_rgb`: a YCbCr frame (photometric 6) that is not JPEG-compressed
    in one plane. libtiff's RGBA interface reads a compressed one for PIL
    (TiffDecode.c's readAsRGBA): chroma subsampled 4x4, 4x2, 4x1, 2x2,
    2x1, 1x2 or 1x1 in sampling blocks (Y of the block, then Cb and Cr),
    each pixel given its block's chroma, converted with tif_color.c's
    TIFFYCbCrToRGBInit tables from ReferenceBlackWhite and
    YCbCrCoefficients (single-precision float, as libtiff computes them);
    two planes only at 1x1. Predictor 2 runs over the blocks in libtiff's
    "rows" (`_blocks_predictor`), and where libtiff refuses the layout the
    reader goes on without it (PIL's RGBA reader does not stop on errors);
    a 4x4 tile cut at the right edge is read with libtiff's 10-byte skew
    (`_skewed_44`). PIL reads an uncompressed one with its raw mode
    "RGBX": four bytes a pixel from each strip's offset, Y, Cb and Cr
    given as R, G and B, past the strip if the file goes on, "image file is
    truncated" where it does not.
  * `ojpeg`: an old-style JPEG frame (compression 6), as libtiff's
    tif_ojpeg.c hands it to the RGBA interface: one JPEG stream for the
    frame (the JPEGInterchangeFormat stream when it holds the scan; else
    its header, or one written from the JPEGQTables, JPEGDCTables,
    JPEGACTables and JPEGRestartInterval tags, then the strips' data with
    a restart marker between strips; without a restart interval, each
    strip a libjpeg session of its own; tiles and planes stay refused,
    ROADMAP A.10d-c), decoded to
    libjpeg's raw component
    samples (no upsampling) and converted in sampling blocks as a
    subsampled YCbCr frame is, the subsampling from the stream's SOF.
  * `raw_planar`: an uncompressed planar frame, which PIL's raw decoder
    reads plane by plane with the layer's one-letter raw mode ("RGB;16L"
    gives "R", "G", "B": each plane's bytes read as 8-bit samples), a raw
    mode its unpackers lack raising ValueError.
"""

from __future__ import annotations

import numpy as np

from rapidraw_tpu_torch.io.tiff import (_BANDS, NONE, REVERSED, Frame, _decompress, _PREDICTED,
                                        _tuple, check_codec)

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
    check_codec(f)
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
        if predict == 2:
            _blocks_predictor(raw[:size], size // (bv * vs) if not tiled else tw * 3)
        nx = min(tw, f.width - x0)
        if tiled and (hs, vs) == (4, 4) and nx < tw:
            raw = _skewed_44(raw, bv, bh, -(-nx // 4), (tw - nx) // 4)
        blocks = raw.reshape(bv, bh, unit)
        # each block's Y with its chroma, then the blocks' rows laid out
        y = blocks[..., :hs * vs].reshape(bv, bh, vs, hs)
        rgb = ycbcr_to_rgb(y, blocks[..., -2, None, None], blocks[..., -1, None, None], tables)
        rgb = rgb.transpose(0, 2, 1, 3, 4).reshape(bv * vs, bh * hs, 3)
        out[y0:y0 + keep, x0:x0 + nx] = rgb[:keep, :nx]
    return out


def _segments(stream: bytes):
    """(marker, start, end) of a JPEG's marker segments up to its SOS."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        end = pos + 2 + ((stream[pos + 2] << 8) | stream[pos + 3])
        yield marker, pos, end
        if marker == 0xDA:
            return
        pos = end


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(f"rapidraw_tpu_torch does not decode {what} yet (ROADMAP A.10d-c)")


def _ojpeg_header(f: Frame, data) -> bytes:
    """OJPEGWriteHeaderInfo from the tables in the tags: SOI, each
    component's DQT and DHTs, DRI, SOF0 (the first component sampled as
    YCbCrSubsampling says), SOS."""
    t = f.tags
    n = f.spp
    if f.bits != 8 or int(t.get(512, 1)) != 1:  # JPEGProc 1: baseline
        raise OSError("old-style JPEG other than 8-bit baseline")

    def table(tag, k, size):
        offs = _tuple(t.get(tag))
        if len(offs) < n:
            raise OSError(f"old-style JPEG without tag {tag} for every component")
        raw = bytes(data[int(offs[k]):int(offs[k]) + size])
        if size == 16:  # a Huffman table: its counts, then as many values
            raw = bytes(data[int(offs[k]):int(offs[k]) + 16 + sum(raw)])
        return raw

    def seg(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = bytearray(b"\xff\xd8")
    for k in range(n):
        out += seg(0xDB, bytes([k]) + table(519, k, 64))
        out += seg(0xC4, bytes([k]) + table(520, k, 16))
        out += seg(0xC4, bytes([0x10 | k]) + table(521, k, 16))
    if int(t.get(515, 0)):
        out += seg(0xDD, int(t[515]).to_bytes(2, "big"))
    hs, vs = f.sub if n == 3 else (1, 1)
    out += seg(0xC0, bytes([8]) + f.height.to_bytes(2, "big") + f.width.to_bytes(2, "big") +
               bytes([n]) + b"".join(bytes([k + 1, (hs << 4 | vs) if k == 0 else 0x11, k])
                                     for k in range(n)))
    out += seg(0xDA, bytes([n]) + b"".join(bytes([k + 1, k << 4 | k]) for k in range(n)) +
               b"\x00\x3f\x00")
    return bytes(out)


def ojpeg_streams(f: Frame, data) -> list[tuple[bytes, int]]:
    """The JPEG streams libtiff's old-style JPEG codec hands libjpeg, each
    with the rows of the frame it gives (from its top): one stream, or,
    where the strips' data follow a header without a restart interval, one
    libjpeg session a strip."""
    t = f.tags
    if 322 in t and 324 in t:
        raise _deferred("a tiled old-style JPEG TIFF")
    if f.planar == 2 and f.spp > 1:
        raise _deferred("a planar old-style JPEG TIFF")
    chunks = [(bytes(data[off:off + cnt]), keep) for _, _, _, _, keep, _, off, cnt in f.chunks()]
    if 513 in t:
        off = int(t[513])
        jif = bytes(data[off:off + int(t.get(514, len(data) - off))])
        sos = [end for marker, _, end in _segments(jif) if marker == 0xDA]
        if not jif.startswith(b"\xff\xd8") or not sos:
            raise _deferred("an old-style JPEG TIFF whose JPEGInterchangeFormat holds no SOS")
        if len(jif) > sos[0]:  # the scan is in the interchange stream
            return [(jif, f.height)]
        header = jif
    elif 519 in t:
        header = _ojpeg_header(f, data)
    elif len(chunks) == 1:
        return [(chunks[0][0], f.height)]
    else:
        raise _deferred("an old-style JPEG TIFF of several strips without tables")
    if not any(marker == 0xDD for marker, _, _ in _segments(header)):
        return [(header + chunk + b"\xff\xd9", keep) for chunk, keep in chunks]
    # OJPEGWriteStreamCompressed writes a restart marker between strips
    body = bytearray()
    for k, (chunk, _) in enumerate(chunks):
        if k:
            body += bytes([0xFF, 0xD0 + (k - 1) % 8])
        body += chunk
    return [(header + bytes(body) + b"\xff\xd9", f.height)]


def ojpeg(f: Frame, data) -> tuple[np.ndarray, str]:
    """An old-style JPEG frame as PIL reads it: (pixels, mode "RGB" or
    "L")."""
    from rapidraw_tpu_torch.io import jpeg

    bands = []
    for stream, rows in ojpeg_streams(f, data):
        factors = jpeg.sampling_factors(stream)
        if not factors or stream[:2] != b"\xff\xd8":
            raise OSError("old-style JPEG stream without a frame header")
        sofs = [m for m, _, _ in _segments(stream)
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC)]
        if sofs[:1] not in ([0xC0], [0xC1]):  # tif_ojpeg.c reads baseline and extended Huffman
            raise OSError("old-style JPEG other than baseline or extended sequential")
        hs, vs = factors[0]
        if rows != f.height and int(f.tags.get(278, f.height)) % (8 * vs):
            raise _deferred("old-style JPEG strips that do not hold whole MCU rows")
        planes = jpeg.jpeg_planes(stream)
        if len(planes) != f.spp or planes[0].shape[0] < rows or planes[0].shape[1] < f.width:
            raise OSError("old-style JPEG stream that does not fit the frame")
        if f.spp == 3 and (factors[1:] != [(1, 1), (1, 1)] or (hs, vs) not in _SUBSAMPLINGS):
            raise OSError(f"old-style JPEG subsampled {factors}")
        bands.append((planes, rows, hs, vs))
    w = f.width
    if f.spp == 1:
        return np.ascontiguousarray(np.concatenate([p[0][:r, :w] for p, r, _, _ in bands])), "L"
    tables = ycbcr_tables(_tuple(f.tags.get(532)) or None, _tuple(f.tags.get(529)) or None)
    out = []
    for (y, cb, cr), rows, hs, vs in bands:
        iy, ix = (np.arange(rows) // vs)[:, None], (np.arange(w) // hs)[None, :]
        out.append(ycbcr_to_rgb(y[:rows, :w], cb[iy, ix], cr[iy, ix], tables))
    return np.concatenate(out), "RGB"


def _skewed_44(raw: np.ndarray, bv: int, bh: int, used: int, skipped: int) -> np.ndarray:
    """The blocks putcontig8bitYCbCr44tile reads from a tile cut at the
    image's right edge: after each row of `used` 18-byte blocks it skips
    `skipped` blocks of 10 bytes ((fromskew / 4) * (4 * 2 + 2)), so the rows
    after the first start early; past the tile's data it reads zeros."""
    src = np.concatenate([raw, np.zeros(bv * bh * 18, np.uint8)])
    out = np.zeros((bv, bh, 18), np.uint8)
    pitch = used * 18 + skipped * 10
    for r in range(bv):
        out[r, :used] = src[r * pitch:r * pitch + used * 18].reshape(used, 18)
    return out.reshape(-1)


def _blocks_predictor(raw: np.ndarray, rowsize: int) -> None:
    """libtiff's PredictorDecodeTile over a chunk of sampling blocks, in
    place: horAcc8 with a stride of 3 samples over "rows" of `rowsize`
    bytes (a strip's TIFFScanlineSize, a row of blocks divided by the
    vertical subsampling; a tile's TIFFTileRowSize, its width times 3),
    which split and straddle the blocks. Where libtiff refuses the layout
    ("occ0%rowsize != 0", "(cc%stride)!=0") the RGBA reader PIL runs
    (stoponerr 0) goes on with the chunk as the codec left it."""
    if rowsize <= 0 or raw.size % rowsize or rowsize % 3:
        return
    rows = raw.reshape(-1, rowsize // 3, 3)
    rows[:] = np.cumsum(rows, axis=1, dtype=np.uint8)


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
