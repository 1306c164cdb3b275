"""PNM decoding (P1-P6) as PIL 12.1's PpmImagePlugin does it: header
tokens of at most 10 characters with "#" comments, raw and plain data,
PBM's inverted bits (1 is black), maxval other than 255 scaled by
round(v / maxval * 255) (Python's rounding: half to even), grey above 255
held as mode "I" (scaled to 65535, or as stored at 65535) which convert()
clips to 0..255, colour above 255 scaled to 8 bits. The exceptions are
PIL's: ValueError for bad tokens and short data, OSError for a truncated
raw file."""

from __future__ import annotations

import numpy as np

from rapidraw_tpu_torch.io.image_decode import Frame, Unidentified, unpack_bits, unpack_raw

_WS = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}


class _Reader:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def token(self) -> bytes:
        """PIL's PpmImageFile._read_token."""
        token = b""
        while len(token) <= 10:
            c = self.read1()
            if not c:
                break
            if c in _WS:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError("Reached EOF while reading header")
        if len(token) > 10:
            raise ValueError(b"Token too long in file header: %s" % token)
        return token


def _strip_comments(block: bytes) -> bytes:
    """Plain data with PIL's comment removal (to the next CR or LF)."""
    out, pos = [], 0
    while True:
        k = block.find(b"#", pos)
        if k < 0:
            out.append(block[pos:])
            return b"".join(out)
        out.append(block[pos:k])
        ends = [e for e in (block.find(b"\n", k), block.find(b"\r", k)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


_SAFEBLOCK = 65536


def _plain_bits(data: bytes, pos: int, total: int) -> np.ndarray:
    """PIL's PpmPlainDecoder._decode_bitonal: blocks of 64 KiB, comments
    dropped (one may span blocks), every token of a block read checked."""
    out = b""
    spans = False
    while len(out) != total:
        block = data[pos:pos + _SAFEBLOCK]
        pos += len(block)
        if not block:
            break
        while spans and block:
            ends = [e for e in (block.find(b"\n"), block.find(b"\r")) if e >= 0]
            if ends:
                block = block[min(ends) + 1:]
                spans = False
            else:
                block = data[pos:pos + _SAFEBLOCK]
                pos += len(block)
        spans = False
        k = block.find(b"#")
        if k >= 0 and not [e for e in (block.find(b"\n", k), block.find(b"\r", k)) if e >= 0]:
            spans = True
        block = _strip_comments(block)
        tokens = b"".join(block.split())
        for t in tokens:
            if t not in (48, 49):
                raise ValueError(b"Invalid token for this mode: %s" % bytes([t]))
        out = (out + tokens)[:total]
    if len(out) < total:
        raise ValueError("not enough image data")
    return np.where(np.frombuffer(out, np.uint8) == 48, 255, 0).astype(np.uint8)


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max) in float64, ties to even, as Python's
    round."""
    return np.rint(values.astype(np.float64) / maxval * out_max).astype(np.int64)


def _header(data: bytes) -> tuple[bytes, _Reader, int, int]:
    """The magic, a reader past the height, the width and the height."""
    magic = b""
    pos = 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in _WS:
            break
        magic += c
    if magic not in _MODES:
        raise Unidentified()
    r = _Reader(data, pos)
    w, h = int(r.token()), int(r.token())
    if w <= 0 or h <= 0:
        raise Unidentified()
    return magic, r, w, h


def pnm_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the header, as PIL's `.size`."""
    return _header(bytes(data))[2:]


def decode_pnm(data: bytes) -> Frame:
    data = bytes(data)
    magic, r, w, h = _header(data)
    mode = _MODES[magic]
    plain = magic in (b"P1", b"P2", b"P3")
    bands = 3 if mode == "RGB" else 1
    if mode == "1":
        if plain:
            return Frame("1", _plain_bits(data, r.pos, w * h).reshape(h, w))
        rows = unpack_raw(data, r.pos, w, h, 1)
        return Frame("1", (1 - unpack_bits(rows, w, 1)) * np.uint8(255))
    maxval = int(r.token())
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    out_max = 65535 if mode == "I" else 255
    n = w * h * bands
    if plain:
        toks = _strip_comments(data[r.pos:]).split()
        vals = []
        for t in toks:
            if len(t) > 10:
                raise ValueError(b"Token too long found in data: %s" % t[:11])
            v = int(t)
            if v < 0:
                raise ValueError(f"Channel value is negative: {v}")
            if v > maxval:
                raise ValueError(f"Channel value too large for this mode: {v}")
            vals.append(v)
            if len(vals) == n:
                break
        if len(vals) < n:
            raise ValueError("not enough image data")
        px = _scale(np.array(vals, np.int64), maxval, out_max)
    elif maxval == 255:
        px = unpack_raw(data, r.pos, w * bands, h, 8).astype(np.int64)
    elif maxval == 65535 and mode == "I":
        px = unpack_raw(data, r.pos, w, h, 16).view(">u2").astype(np.int64)
    else:
        nb = 1 if maxval < 256 else 2
        raw = np.frombuffer(data[r.pos:r.pos + n * nb], np.uint8)
        if len(raw) < n * nb:
            raise ValueError("not enough image data")
        v = raw if nb == 1 else raw.view(">u2")
        px = np.minimum(out_max, _scale(v, maxval, out_max))
    px = px.reshape(h, w, bands) if bands == 3 else px.reshape(h, w)
    if mode == "I":
        return Frame("I", px.astype(np.int32))
    return Frame(mode, px.astype(np.uint8))
