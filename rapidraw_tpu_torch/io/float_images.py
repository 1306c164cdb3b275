"""Decoders for the non-PIL tail of the reference's LDR format list (a
copy of `rapidraw_tpu/io/float_images.py`, which imports no JAX; the port
keeps its own).

The reference loads every NON_RAW_EXTENSIONS entry (formats.rs:73-79)
through the Rust `image` crate; PIL covers most of them, but not Radiance
HDR (.hdr), OpenEXR (.exr), farbfeld (.ff) or Netpbm PAM (.pam). These are
fresh implementations of the published format specs:

  * Radiance RGBE: Ward's spec (old-style flat + new-style per-component
    RLE scanlines), exponent conversion c * 2^(e-136).
  * OpenEXR: single-part scanline files, compression NONE/ZIPS/ZIP,
    HALF/FLOAT/UINT channels, zlib + delta/interleave reconstruction.
    Tiled/multipart/PIZ refuse precisely.
  * farbfeld: 8-byte magic + BE u32 dims + BE u16 RGBA.
  * PAM (P7): WIDTH/HEIGHT/DEPTH/MAXVAL/ENDHDR header + big-endian raster.

All return (H, W, 3) float32. HDR/EXR values are scene-linear and NOT
clamped — the HDR merge path wants the dynamic range; `load_ldr` clamps to
[0,1] to match the reference's DynamicImage->RGB8 conversion for ordinary
editing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


class FloatImageError(ValueError):
    pass


# ------------------------------------------------------------ Radiance HDR


def load_hdr(data: bytes) -> np.ndarray:
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise FloatImageError("not a Radiance HDR file")
    pos = 0
    fmt_ok = False
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise FloatImageError("truncated HDR header")
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() in (b"FORMAT=32-bit_rle_rgbe", b"FORMAT=32-bit_rle_xyze")
        if line == b"":
            break
    if not fmt_ok:
        raise FloatImageError("HDR missing 32-bit_rle_rgbe FORMAT")
    nl = data.find(b"\n", pos)
    if nl < 0:
        raise FloatImageError("truncated HDR resolution line")
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise FloatImageError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    if not (0 < w <= 65535 and 0 < h <= 65535) or w * h > 1 << 28:
        raise FloatImageError(f"implausible HDR dimensions {w}x{h}")

    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if pos + 4 > len(data):
            raise FloatImageError("truncated HDR scanlines")
        # new-style RLE marker: 0x02 0x02 then 16-bit width
        if w >= 8 and data[pos] == 2 and data[pos + 1] == 2 and (
            (data[pos + 2] << 8) | data[pos + 3]
        ) == w:
            pos += 4
            for c in range(4):
                x = 0
                row = rgbe[y, :, c]
                while x < w:
                    if pos >= len(data):
                        raise FloatImageError("truncated HDR RLE run")
                    code = data[pos]
                    pos += 1
                    if code > 128:  # run
                        n = code - 128
                        if pos >= len(data) or x + n > w:
                            raise FloatImageError("bad HDR RLE run")
                        row[x : x + n] = data[pos]
                        pos += 1
                    else:  # literal
                        n = code
                        if n == 0 or x + n > w or pos + n > len(data):
                            raise FloatImageError("bad HDR literal run")
                        row[x : x + n] = np.frombuffer(data, np.uint8, n, pos)
                        pos += n
                    x += n
        else:
            # old-format scanline (Radiance color.c oldreadcolrs): flat
            # RGBE groups, where (1,1,1,count) repeats the previous pixel
            # count<<rshift times (consecutive markers raise rshift by 8).
            # Fast path: no marker groups in the next w pixels -> memcpy.
            need = w * 4
            flat = (
                np.frombuffer(data, np.uint8, need, pos).reshape(w, 4)
                if pos + need <= len(data)
                else None
            )
            if flat is not None and not np.any(
                (flat[:, 0] == 1) & (flat[:, 1] == 1) & (flat[:, 2] == 1)
            ):
                rgbe[y] = flat
                pos += need
                continue
            x = 0
            rshift = 0
            while x < w:
                if pos + 4 > len(data):
                    raise FloatImageError("truncated HDR old-format scanline")
                r, g, b, e = data[pos : pos + 4]
                pos += 4
                if r == 1 and g == 1 and b == 1:
                    if x == 0:
                        raise FloatImageError("HDR repeat run with no prior pixel")
                    count = e << rshift
                    if count <= 0 or x + count > w:
                        raise FloatImageError("bad HDR old-format repeat run")
                    rgbe[y, x : x + count] = rgbe[y, x - 1]
                    x += count
                    rshift += 8
                else:
                    rgbe[y, x] = (r, g, b, e)
                    x += 1
                    rshift = 0

    mant = rgbe[:, :, :3].astype(np.float32)
    e = rgbe[:, :, 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    out = mant * scale[:, :, None]
    out[e == 0] = 0.0
    return out


def write_hdr(img: np.ndarray) -> bytes:
    """Flat-scanline Radiance HDR writer (round-trip tests + HDR export)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    m = img.max(axis=2)
    e = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    e[nz] = np.floor(np.log2(m[nz])).astype(np.int32) + 1
    # decode is c * 2^(e_stored-136) with e_stored = e+128, so the encode
    # scale is 2^(136-(e+128)) = 2^(8-e)
    scale = np.ldexp(np.float32(1.0), 8 - e).astype(np.float32)
    mant = np.clip(img * scale[:, :, None] + 0.5, 0, 255).astype(np.uint8)
    rgbe = np.concatenate([mant, np.where(nz, e + 128, 0)[..., None].astype(np.uint8)], axis=2)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return head + rgbe.tobytes()


# --------------------------------------------------------------- farbfeld


def load_farbfeld(data: bytes) -> np.ndarray:
    if data[:8] != b"farbfeld":
        raise FloatImageError("not a farbfeld file")
    w, h = struct.unpack_from(">II", data, 8)
    if not (0 < w <= 65535 and 0 < h <= 65535) or w * h > 1 << 28:
        raise FloatImageError(f"implausible farbfeld dimensions {w}x{h}")
    need = w * h * 8
    if len(data) < 16 + need:
        raise FloatImageError("truncated farbfeld raster")
    px = np.frombuffer(data, ">u2", count=w * h * 4, offset=16).reshape(h, w, 4)
    return (px[:, :, :3].astype(np.float32) / 65535.0)


# --------------------------------------------------------------- PAM (P7)


def load_pam(data: bytes) -> np.ndarray:
    if not data.startswith(b"P7"):
        raise FloatImageError("not a PAM file")
    pos = data.find(b"\n") + 1
    hdr: dict[bytes, bytes] = {}
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise FloatImageError("truncated PAM header")
        line = data[pos:nl].strip()
        pos = nl + 1
        if line == b"ENDHDR":
            break
        if not line or line.startswith(b"#"):
            continue
        parts = line.split(None, 1)
        if len(parts) == 2:
            hdr[parts[0]] = parts[1]
    try:
        w = int(hdr[b"WIDTH"])
        h = int(hdr[b"HEIGHT"])
        depth = int(hdr[b"DEPTH"])
        maxval = int(hdr[b"MAXVAL"])
    except (KeyError, ValueError) as e:
        raise FloatImageError(f"bad PAM header: {e}") from e
    if not (0 < w <= 65535 and 0 < h <= 65535 and 0 < depth <= 4 and 0 < maxval <= 65535):
        raise FloatImageError("implausible PAM header values")
    dt = ">u2" if maxval > 255 else "u1"
    count = w * h * depth
    itemsize = 2 if maxval > 255 else 1
    if len(data) - pos < count * itemsize:
        # pre-check: np.frombuffer raises a generic ValueError on short
        # buffers before any size comparison could run
        raise FloatImageError("truncated PAM raster")
    arr = np.frombuffer(data, dt, count=count, offset=pos)
    arr = arr.reshape(h, w, depth).astype(np.float32) / float(maxval)
    if depth == 1:
        return np.repeat(arr, 3, axis=2)
    if depth == 2:  # gray + alpha
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return arr[:, :, :3]


# ----------------------------------------------------------------- OpenEXR

_EXR_MAGIC = 0x01312F76
_EXR_PT = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _exr_cstr(data: bytes, pos: int) -> tuple[bytes, int]:
    end = data.find(b"\0", pos)
    if end < 0 or end - pos > 255:
        raise FloatImageError("bad EXR string")
    return data[pos:end], end + 1


def load_exr(data: bytes) -> np.ndarray:
    if len(data) < 8 or struct.unpack_from("<I", data, 0)[0] != _EXR_MAGIC:
        raise FloatImageError("not an OpenEXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0x200:
        raise FloatImageError("tiled EXR not supported")
    if version & (0x1000 | 0x800):
        raise FloatImageError("multipart/deep EXR not supported")

    pos = 8
    channels: list[tuple[str, int]] = []
    compression = None
    data_window = None
    while True:
        name, pos = _exr_cstr(data, pos)
        if name == b"":
            break
        _typ, pos = _exr_cstr(data, pos)
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        body = data[pos : pos + size]
        if len(body) < size:
            raise FloatImageError("truncated EXR attribute")
        pos += size
        if name == b"channels":
            cp = 0
            while cp < len(body) and body[cp] != 0:
                cname, cp = _exr_cstr(body, cp)
                if cp + 16 > len(body):
                    raise FloatImageError("truncated EXR chlist")
                (ptype,) = struct.unpack_from("<I", body, cp)
                cp += 16  # type + pLinear/reserved + xSampling + ySampling
                if ptype not in _EXR_PT:
                    raise FloatImageError(f"unknown EXR pixel type {ptype}")
                channels.append((cname.decode(errors="replace"), ptype))
        elif name == b"compression":
            compression = body[0]
        elif name == b"dataWindow":
            data_window = struct.unpack("<4i", body)
    if compression is None or data_window is None or not channels:
        raise FloatImageError("EXR missing required headers")
    if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise FloatImageError(
            f"EXR compression {compression} not supported (NONE/ZIPS/ZIP only)"
        )
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if not (0 < w <= 65535 and 0 < h <= 65535) or w * h > 1 << 28:
        raise FloatImageError(f"implausible EXR dimensions {w}x{h}")

    lines_per_block = 16 if compression == 3 else 1
    n_blocks = -(-h // lines_per_block)
    if pos + 8 * n_blocks > len(data):
        raise FloatImageError("truncated EXR offset table")
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    # per-scanline byte layout: channels in file order (sorted by name),
    # each contributing w * sizeof(type) bytes
    ch_sizes = [w * _EXR_PT[t].itemsize for _, t in channels]
    line_bytes = sum(ch_sizes)
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}

    for off in offsets:
        if off + 8 > len(data):
            raise FloatImageError("bad EXR block offset")
        by, bsize = struct.unpack_from("<ii", data, off)
        row0 = by - y0
        n_lines = min(lines_per_block, h - row0)
        if row0 < 0 or n_lines <= 0 or off + 8 + bsize > len(data):
            raise FloatImageError("bad EXR block geometry")
        raw = data[off + 8 : off + 8 + bsize]
        expect = line_bytes * n_lines
        if compression in (2, 3) and bsize < expect:
            try:
                dec = zlib.decompress(raw)
            except zlib.error as e:
                raise FloatImageError(f"bad EXR zlib block: {e}") from e
            if len(dec) != expect:
                raise FloatImageError("EXR block decompressed to wrong size")
            # reconstruct: delta-decode t[i] = t[i-1] + d[i] - 128 (mod 256)
            # as a cumsum, then de-interleave the two halves
            d = np.frombuffer(dec, np.uint8).astype(np.int64)
            acc = np.cumsum(np.concatenate([d[:1], d[1:] - 128]))
            d = (acc & 0xFF).astype(np.uint8)
            half = (d.size + 1) // 2
            merged = np.empty(d.size, np.uint8)
            merged[0::2] = d[:half]
            merged[1::2] = d[half:]
            raw = merged.tobytes()
        elif bsize != expect:
            raise FloatImageError("EXR uncompressed block has wrong size")
        for li in range(n_lines):
            base = li * line_bytes
            cpos = base
            for (cname, ptype), csz in zip(channels, ch_sizes):
                seg = raw[cpos : cpos + csz]
                planes[cname][row0 + li] = np.frombuffer(seg, _EXR_PT[ptype]).astype(
                    np.float32
                )
                cpos += csz
    names = {c.upper(): c for c, _ in channels}
    if all(k in names for k in ("R", "G", "B")):
        return np.stack(
            [planes[names["R"]], planes[names["G"]], planes[names["B"]]], axis=2
        )
    if "Y" in names:
        return np.repeat(planes[names["Y"]][:, :, None], 3, axis=2)
    first = channels[0][0]
    return np.repeat(planes[first][:, :, None], 3, axis=2)


# --------------------------------------------------------------- dispatch

_FLOAT_EXTS = {"hdr", "exr", "ff", "pam"}


def load_float_image(path_or_bytes, ext: str = "") -> np.ndarray:
    """(H, W, 3) float32; HDR/EXR scene-linear unclamped."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        from pathlib import Path

        p = Path(path_or_bytes)
        ext = ext or p.suffix
        data = p.read_bytes()
    ext = ext.lower().lstrip(".")
    try:
        if ext == "hdr" or data[:2] == b"#?":
            return load_hdr(data)
        if ext == "exr" or data[:4] == b"\x76\x2f\x31\x01":
            return load_exr(data)
        if ext == "ff" or data[:8] == b"farbfeld":
            return load_farbfeld(data)
        if ext == "pam" or data[:3] == b"P7\n":
            return load_pam(data)
    except (struct.error, IndexError, OverflowError, KeyError) as e:
        # same malformed-input contract as io/containers.parse_raw:
        # arbitrary bytes either decode or raise ValueError
        raise FloatImageError(f"malformed {ext or 'float'} image: {e}") from e
    raise FloatImageError(f"unrecognized float-image format (ext {ext or '?'})")
