"""Vendor TIFF-family RAW parsers: CR2 (Canon), NEF (Nikon), PEF (Pentax),
ARW (Sony), ORF, RW2, MRW and the generic vendor TIFF-CFA tail.

A copy of `rapidraw_tpu/io/makers.py`; the C++ decoders are the port's
copies in csrc/host/, built by `rapidraw_tpu_torch.native.host_library`.

The reference gets the whole camera matrix from the rawler crate
(raw_processing.rs:15-30); these are fresh host-side decoders for the
TIFF-family subset, reusing the generic IFD machinery in io/dng.py, the
native lossless-JPEG decoder (csrc/host/ljpeg.cc, CR2) and the native
vendor-Huffman decoder (csrc/host/vendor_huff.cc, NEF-compressed + PEF).
Metadata handling (WB / black level / active area) is best-effort from the
maker notes; missing fields fall back to neutral defaults.
"""

from __future__ import annotations

import struct

import numpy as np

from rapidraw_tpu_torch.io.dng import (
    DngError,
    RawFile,
    _collect_ifds,
    _read_ifd,
    _first,
    _unpack_12le,
    _unpack_msb,
    _T,
)

_TAG_MAKE = 271
_TAG_EXIF_IFD = 34665
_TAG_MAKERNOTE = 37500
_TAG_CFA_REPEAT = 33421
_TAG_CFA_PATTERN = 33422


def _chained_ifds(data: bytes, endian: str) -> list[dict]:
    """IFD0 chain only (no SubIFD recursion), in file order."""
    ifds = []
    try:
        _, first = struct.unpack_from(endian + "HI", data, 2)
    except struct.error as e:
        raise DngError("truncated TIFF header") from e
    off = first
    seen = set()
    while off and off not in seen and off < len(data):
        seen.add(off)
        try:
            entries, off = _read_ifd(data, off, endian)
        except struct.error:
            break
        ifds.append(entries)
    return ifds


def _shift_pattern(pattern: str, top: int, left: int) -> str:
    """2x2 CFA pattern after cropping `top` rows / `left` cols."""
    rows = [pattern[0:2], pattern[2:4]]
    return (
        rows[top & 1][left & 1]
        + rows[top & 1][(left + 1) & 1]
        + rows[(top + 1) & 1][left & 1]
        + rows[(top + 1) & 1][(left + 1) & 1]
    )




# --------------------------------------------------------------- CR2 (Canon)

def _sof3_precision(stream: bytes) -> int:
    """Sample precision from the SOF3 marker of a lossless-JPEG stream
    (0 if not found). This is the authoritative bit depth — inferring it
    from pixel content misreads dark/clipped 14-bit frames as 12-bit."""
    pos = 2  # skip SOI
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            pos += 1
            continue
        marker = stream[pos + 1]
        if marker == 0xC3:
            return stream[pos + 4]
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
            pos += 2 if marker != 0xFF else 1
            continue
        if marker == 0xDA:  # entropy-coded data follows; SOF3 must precede
            return 0
        try:
            (ln,) = struct.unpack_from(">H", stream, pos + 2)
        except struct.error:
            return 0
        pos += 2 + ln
    return 0


# Canon ColorData (makernote 0x4001) as-shot WB_RGGB offset in SHORTs,
# keyed by the tag's element count (exiftool Canon::ColorData* versions);
# unknown sizes use the modern default 63.
_CANON_WB_OFFSET = {582: 25, 653: 34, 796: 63, 674: 63, 692: 63, 702: 63}


def _canon_makernote(data: bytes, endian: str, ifds: list[dict]) -> dict:
    """Canon maker note is a bare IFD; value offsets are file-absolute."""
    exif_off = _first(ifds, _TAG_EXIF_IFD)
    if not exif_off:
        return {}
    try:
        exif, _ = _read_ifd(data, exif_off[0], endian)
    except struct.error:
        return {}
    mn = exif.get(_TAG_MAKERNOTE)
    if mn is None:
        return {}
    # _read_ifd already decoded it as a byte list; we need its file offset —
    # re-scan the EXIF IFD entry table for the makernote entry's offset
    try:
        (count,) = struct.unpack_from(endian + "H", data, exif_off[0])
        pos = exif_off[0] + 2
        for _ in range(count):
            tag, typ, n = struct.unpack_from(endian + "HHI", data, pos)
            if tag == _TAG_MAKERNOTE:
                # UNDEFINED blob (n = byte length, real CR2s) or a LONG
                # pointer: both store the file-absolute IFD offset in the
                # value slot once the payload exceeds 4 bytes
                if typ == 4 or n > 4:
                    (mn_off,) = struct.unpack_from(endian + "I", data, pos + 8)
                else:
                    mn_off = pos + 8
                entries, _ = _read_ifd(data, mn_off, endian)
                return entries
            pos += 12
    except struct.error:
        pass
    return {}


def parse_cr2(data: bytes) -> RawFile:
    """Canon CR2: lossless-JPEG RAW in the last chained IFD, re-sliced by
    tag 0xc640 (cr2_slice); WB from ColorData (makernote 0x4001), black
    level from the masked sensor border (makernote 0xe0 SensorInfo)."""
    if data[:2] != b"II":
        raise DngError("CR2 must be little-endian TIFF")
    endian = "<"
    ifds = _chained_ifds(data, endian)
    raw_ifds = [
        i for i in ifds
        if i.get(_T["Compression"], [0])[0] == 7 and _T["StripOffsets"] in i
    ]
    if not raw_ifds:
        raise DngError("no lossless-JPEG RAW IFD in CR2")
    ifd = raw_ifds[-1]

    from rapidraw_tpu_torch.native import ljpeg_decode

    off = ifd[_T["StripOffsets"]][0]
    cnt = ifd.get(_T["StripByteCounts"], [len(data) - off])[0]
    stream = bytes(data[off : off + cnt])
    decoded = ljpeg_decode(stream)  # (sof_h, sof_w*ncomp)
    h, w = decoded.shape

    slices = ifd.get(0xC640)  # [count, width, last_width] in sensor columns
    if slices and len(slices) >= 3 and slices[0] > 0:
        widths = [slices[1]] * slices[0] + [slices[2]]
        if sum(widths) != w:
            raise DngError(f"CR2 slice widths {widths} != sensor width {w}")
        flat = decoded.reshape(-1)
        plane = np.empty((h, w), np.uint16)
        col = 0
        pos = 0
        for sw in widths:
            n = sw * h
            plane[:, col : col + sw] = flat[pos : pos + n].reshape(h, sw)
            col += sw
            pos += n
    else:
        plane = decoded

    mn = _canon_makernote(data, endian, ifds)

    # active area + black level from SensorInfo (exiftool Canon:0xe0:
    # [_, width, height, _, _, left, top, right, bottom, ...])
    top = left = 0
    black = 0.0
    si = mn.get(0xE0)
    if si and len(si) >= 9:
        left, top, right, bottom = si[5], si[6], si[7], si[8]
        if 0 < left < w and 0 < top < h and left >= 4:
            black = float(np.mean(plane[top:, : left - 2]))
        if 0 < right <= w and 0 < bottom <= h and right > left and bottom > top:
            plane = plane[top : bottom + 1, left : right + 1]
        else:
            # crop did not execute: the CFA pattern must not shift either
            # (an odd top/left would swap R/B against the uncropped plane)
            top = left = 0

    # as-shot WB from ColorData
    wb = np.ones(3, np.float32)
    cd = mn.get(0x4001)
    if cd:
        woff = _CANON_WB_OFFSET.get(len(cd), 63)
        if woff + 4 <= len(cd):
            r, g1, g2, b = (float(v) for v in cd[woff : woff + 4])
            g = (g1 + g2) / 2.0 or 1.0
            wb = np.array([r / g, 1.0, b / g], np.float32)

    bits = _sof3_precision(stream) or (14 if plane.max(initial=0) > 4095 else 12)
    return RawFile(
        cfa=plane,
        pattern=_shift_pattern("RGGB", top, left),
        black_level=black,
        white_level=float((1 << bits) - 1),
        wb=wb,
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


# --------------------------------------------------------------- NEF (Nikon)


def _nikon_makernote(data: bytes, endian: str, ifds: list[dict]):
    """Nikon maker note: 'Nikon\\0' header + version, then an embedded TIFF
    whose value offsets are relative to that embedded header. Returns
    (entries, base_offset, byte_order) or ({}, 0, '<'). Real Nikon
    makernotes are big-endian ('MM') regardless of the outer TIFF order —
    the returned order must be used for all makernote payload unpacks
    (e.g. the LinearizationTable shorts)."""
    exif_off = _first(ifds, _TAG_EXIF_IFD)
    if not exif_off:
        return {}, 0, "<"
    try:
        (count,) = struct.unpack_from(endian + "H", data, exif_off[0])
        pos = exif_off[0] + 2
        for _ in range(count):
            tag, typ, n = struct.unpack_from(endian + "HHI", data, pos)
            if tag == _TAG_MAKERNOTE:
                (mn_off,) = struct.unpack_from(endian + "I", data, pos + 8)
                if data[mn_off : mn_off + 5] != b"Nikon":
                    return {}, 0, "<"
                base = mn_off + 10  # 'Nikon\0' + 4 version bytes
                sub = data[base:]
                e2 = "<" if sub[:2] == b"II" else ">"
                _, first = struct.unpack_from(e2 + "HI", sub, 2)
                entries, _ = _read_ifd(sub, first, e2)
                return entries, base, e2
            pos += 12
    except (struct.error, IndexError):
        pass
    return {}, 0, "<"


def _nef_wb(mn: dict) -> np.ndarray:
    # WB_RBLevels (tag 0x0c): rationals [R, B, G-ish, G-ish]
    v = mn.get(0x0C)
    if v and len(v) >= 2 and v[0] > 0 and v[1] > 0:
        return np.array([float(v[0]), 1.0, float(v[1])], np.float32)
    return np.ones(3, np.float32)


def parse_nef(data: bytes) -> RawFile:
    """Nikon NEF: RAW lives in a SubIFD (photometric CFA). Supported
    encodings: uncompressed 16-bit, packed MSB-first 12/14-bit (dcraw
    packed_load_raw assembles bitbuf MSB-first; rawler decode_12be), and
    Nikon-compressed (34713) via csrc/host/vendor_huff.cc with the
    curve/vpred/split from LinearizationTable (makernote 0x96)."""
    endian = "<" if data[:2] == b"II" else ">"
    ifds = _collect_ifds(data, endian, struct.unpack_from(endian + "HI", data, 2)[1])
    raw_ifds = [i for i in ifds if i.get(_T["Photometric"], [0])[0] == 32803]
    if not raw_ifds:
        raise DngError("no CFA IFD found in NEF")
    ifd = max(
        raw_ifds,
        key=lambda i: i.get(_T["ImageWidth"], [0])[0] * i.get(_T["ImageLength"], [0])[0],
    )
    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    bits = ifd.get(_T["BitsPerSample"], [16])[0]
    compression = ifd.get(_T["Compression"], [1])[0]
    off = ifd[_T["StripOffsets"]][0]
    cnt = sum(ifd.get(_T["StripByteCounts"], [len(data) - off]))

    mn, _base, mn_order = _nikon_makernote(data, endian, ifds)

    if compression == 1:
        if bits == 16:
            plane = np.frombuffer(
                data, endian + "u2", count=width * height, offset=off
            ).reshape(height, width)
        elif bits in (12, 14):
            plane = _unpack_msb(data[off : off + cnt], bits, width, height)
        else:
            raise DngError(f"unsupported NEF bit depth {bits}")
        white = float((1 << bits) - 1)
    elif compression == 34713:
        plane, white = _nef_decompress(
            data[off : off + cnt], width, height, bits, mn, mn_order
        )
    else:
        raise DngError(f"unsupported NEF compression {compression}")

    pat = ifd.get(_TAG_CFA_PATTERN)
    pattern = (
        "".join({0: "R", 1: "G", 2: "B"}.get(v, "G") for v in pat[:4])
        if pat
        else "RGGB"
    )
    return RawFile(
        cfa=plane.astype(np.uint16, copy=False),
        pattern=pattern,
        black_level=0.0,
        white_level=white,
        wb=_nef_wb(mn),
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


def _nef_decompress(
    stream: bytes, width: int, height: int, bits: int, mn: dict,
    order: str = "<",
) -> tuple[np.ndarray, float]:
    """Nikon compression 34713 via csrc/host/vendor_huff.cc. Returns
    (plane, white_level) — for the stepped lossy curve the effective white
    is the curve's top entry (dcraw sets maximum = curve[max-1]), not the
    nominal bit depth.

    LinearizationTable (makernote 0x96) layout (documented in
    dcraw/exiftool): ver0, ver1 bytes; [2110 skip bytes for ver 0x49/0x58
    (dcraw nikon_load_raw)]; 2x2 SHORT vertical predictors; SHORT curve
    size; then either a stepped curve (lossy type 2, ver0=0x44 ver1 0x20 /
    0x40 — the 0x40 variant rescales step and max by 4 into the quarter
    domain (LibRaw), split row at byte 562) or a direct curve (<= 0x4001
    entries); lossless (ver0=0x46) keeps an identity curve. All shorts are
    in the makernote's byte order (`order` — big-endian on real Nikon
    files). Tree: 12-bit lossy 0 / lossless 2; +3 for 14-bit; post-split
    trees are tree+1 (handled natively).
    """
    lt = mn.get(0x96)
    if not lt:
        raise DngError("NEF compressed without LinearizationTable (0x96)")
    raw = bytes(lt)
    if len(raw) < 12:
        raise DngError("NEF LinearizationTable too short")
    v0, v1 = raw[0], raw[1]
    pos = 2
    if v0 == 0x49 or v1 == 0x58:
        pos += 2110
    vpred = struct.unpack_from(order + "4H", raw, pos)
    pos += 8
    (csize,) = struct.unpack_from(order + "H", raw, pos)
    pos += 2

    max_v = 1 << bits
    step = max_v // (csize - 1) if csize > 1 else 0
    lut = np.arange(max_v, dtype=np.uint16)
    split = 0
    white = float(max_v - 1)
    if v0 == 0x44 and v1 in (0x20, 0x40) and step > 0:
        max_eff = max_v
        if v1 == 0x40:  # coded values occupy the quarter domain (LibRaw)
            step //= 4
            max_eff //= 4
        knots = np.array(
            struct.unpack_from(order + f"{csize}H", raw, pos), np.float64
        )
        xs = np.arange(csize) * step
        lut[:max_eff] = np.interp(
            np.arange(max_eff), xs, knots
        ).astype(np.uint16)
        # entries >= max_eff keep identity (dcraw's curve[] starts identity)
        white = float(lut[max_eff - 1])
        if len(raw) >= 564:
            (split,) = struct.unpack_from(order + "H", raw, 562)
    elif v0 != 0x46 and csize <= 0x4001:
        n = min(csize, (len(raw) - pos) // 2, max_v)
        vals = np.array(
            struct.unpack_from(order + f"{n}H", raw, pos), np.uint16
        )
        lut[: vals.size] = vals
        if vals.size:
            lut[vals.size :] = vals[-1]
            white = float(vals[-1])

    tree = (2 if v0 == 0x46 else 0) + (3 if bits == 14 else 0)

    from rapidraw_tpu_torch.native import nikon_decode

    vals = nikon_decode(stream, width, height, tree, split, vpred, bits)
    return lut[np.minimum(vals, lut.size - 1)], white


# --------------------------------------------------------------- PEF (Pentax)


def _pentax_huff_table(data: bytes, endian: str, ifds: list[dict]):
    """Huffman table from Pentax makernote tag 0x220 (dcraw pentax_load_raw
    reads it unconditionally: u16 v -> dep=(v+12)&15 entries, 12 skip
    bytes, dep u16 left-aligned-in-12-bit code values, dep length bytes).
    Returns (codes, lens, syms) or None (use the default table)."""
    exif_off = _first(ifds, _TAG_EXIF_IFD)
    if not exif_off:
        return None
    try:
        (count,) = struct.unpack_from(endian + "H", data, exif_off[0])
        pos = exif_off[0] + 2
        mn_off = None
        for _ in range(count):
            tag, typ, n = struct.unpack_from(endian + "HHI", data, pos)
            if tag == _TAG_MAKERNOTE:
                if typ == 4 or n > 4:
                    (mn_off,) = struct.unpack_from(endian + "I", data, pos + 8)
                else:
                    mn_off = pos + 8
                break
            pos += 12
        if mn_off is None:
            return None
        # Pentax makernote: 'AOC\0' + 2-byte order marker, entries with
        # file-absolute offsets (exiftool Pentax.pm)
        e2 = endian
        if data[mn_off : mn_off + 4] == b"AOC\0":
            e2 = "<" if data[mn_off + 4 : mn_off + 6] == b"II" else ">"
            mn_off += 6
        entries, _ = _read_ifd(data, mn_off, e2)
        t = entries.get(0x220)
        if not t or len(t) < 14:
            return None
        raw220 = bytes(t)
        (v,) = struct.unpack_from(e2 + "H", raw220, 0)
        dep = (v + 12) & 15
        if dep == 0 or len(raw220) < 14 + dep * 3:
            return None
        codes12 = struct.unpack_from(e2 + f"{dep}H", raw220, 14)
        lens = raw220[14 + dep * 2 : 14 + dep * 3]
        if any(not (1 <= ln <= 12) for ln in lens):
            return None
        codes = [codes12[c] >> (12 - lens[c]) for c in range(dep)]
        return codes, list(lens), list(range(dep))
    except (struct.error, IndexError):
        return None


def parse_pef(data: bytes) -> RawFile:
    """Pentax PEF: CFA IFD with Compression 1 (16-bit / packed MSB 12-bit)
    or 65535 (Pentax Huffman, csrc/host/vendor_huff.cc)."""
    endian = "<" if data[:2] == b"II" else ">"
    ifds = _collect_ifds(data, endian, struct.unpack_from(endian + "HI", data, 2)[1])
    raw_ifds = [i for i in ifds if i.get(_T["Photometric"], [0])[0] == 32803]
    if not raw_ifds:
        raise DngError("no CFA IFD found in PEF")
    ifd = max(
        raw_ifds,
        key=lambda i: i.get(_T["ImageWidth"], [0])[0] * i.get(_T["ImageLength"], [0])[0],
    )
    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    bits = ifd.get(_T["BitsPerSample"], [16])[0]
    compression = ifd.get(_T["Compression"], [1])[0]
    off = ifd[_T["StripOffsets"]][0]
    cnt = sum(ifd.get(_T["StripByteCounts"], [len(data) - off]))

    if compression == 1:
        if bits == 16:
            plane = np.frombuffer(
                data, endian + "u2", count=width * height, offset=off
            ).reshape(height, width)
        else:
            plane = _unpack_msb(data[off : off + cnt], bits, width, height)
    elif compression == 65535:
        from rapidraw_tpu_torch.native import pentax_decode

        table = _pentax_huff_table(data, endian, ifds)
        plane = pentax_decode(
            bytes(data[off : off + cnt]), width, height, bits, table=table
        )
    else:
        raise DngError(f"unsupported PEF compression {compression}")

    pat = ifd.get(_TAG_CFA_PATTERN)
    pattern = (
        "".join({0: "R", 1: "G", 2: "B"}.get(v, "G") for v in pat[:4])
        if pat
        else "RGGB"
    )
    return RawFile(
        cfa=plane.astype(np.uint16, copy=False),
        pattern=pattern,
        black_level=0.0,
        white_level=float((1 << bits) - 1),
        wb=np.ones(3, np.float32),
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


# --------------------------------------------------------------- ARW (Sony)

# Sony ARW2 tone curve breakpoints (dcraw sony_arw2_load_raw): output =
# piecewise-linear expansion of the 11-bit coded value. The SonyToneCurve
# tag (0x7010) stores raw values 0x800/0x1400/0x2000/0x2C00 which dcraw
# shifts >>2 into the 12-bit index space of `pix << 1` before building the
# curve — these are the shifted defaults.
_ARW2_CURVE_X = (0, 0x200, 0x500, 0x800, 0xB00)
_ARW2_CURVE_STEP = (1, 2, 4, 8, 16)


def _arw2_curve() -> np.ndarray:
    lut = np.zeros(0x1000, np.uint32)
    v = 0
    for i in range(1, 0x1000):
        seg = 0
        for k, x in enumerate(_ARW2_CURVE_X):
            if i > x:
                seg = k
        v += _ARW2_CURVE_STEP[seg]
        lut[i] = v
    return lut


def _arw2_decode(raw: bytes, width: int, height: int) -> np.ndarray:
    """Sony ARW2 compressed (32767): 16 bytes encode 16 pixels of one CFA
    color covering 32 interleaved columns — 11-bit max/min, 4-bit their
    positions, 14 7-bit deltas shifted by the dynamic range (dcraw
    sony_arw2_load_raw), then the Sony tone curve."""
    row_bytes = width  # 8 bits/pixel average: width bytes per row
    buf = np.frombuffer(raw, np.uint8, count=row_bytes * height)
    # dcraw decodes full 32-column block pairs while col < raw_width-30;
    # a width that is not a multiple of 32 leaves the trailing columns
    # black rather than failing the file
    pairs = width // 32
    if pairs == 0:
        raise DngError(f"ARW2 width {width} below one 32-column block pair")
    blocks = buf.reshape(height, width)[:, : pairs * 32].reshape(-1, 16)
    nb = blocks.shape[0]

    lo = blocks[:, :8].copy().view("<u8").reshape(nb).astype(np.uint64)
    hi = blocks[:, 8:].copy().view("<u8").reshape(nb).astype(np.uint64)

    def bitfield(pos: int, nbits: int) -> np.ndarray:
        mask = np.uint64((1 << nbits) - 1)
        if pos + nbits <= 64:
            return (lo >> np.uint64(pos)) & mask
        if pos >= 64:
            return (hi >> np.uint64(pos - 64)) & mask
        lo_part = lo >> np.uint64(pos)
        hi_part = (hi << np.uint64(64 - pos)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        return (lo_part | hi_part) & mask

    vmax = bitfield(0, 11).astype(np.int32)
    vmin = bitfield(11, 11).astype(np.int32)
    imax = bitfield(22, 4).astype(np.int64)
    imin = bitfield(26, 4).astype(np.int64)

    # smallest sh (capped at 4) such that (max-min) >> sh < 0x80
    rng = np.maximum(vmax - vmin, 0)
    sh = np.zeros(nb, np.int32)
    for s in range(4):
        sh = np.where((0x80 << s) <= rng, s + 1, sh)

    # init to vmin so every slot is defined even when imax == imin (then
    # only 15 slots receive explicit writes)
    vals = np.empty((nb, 16), np.int32)
    vals[:] = vmin[:, None]
    vals[np.arange(nb), imin] = vmin
    vals[np.arange(nb), imax] = vmax  # max wins an imax==imin tie
    others = np.zeros((nb, 14), np.int32)
    for k in range(14):
        others[:, k] = bitfield(30 + 7 * k, 7).astype(np.int32)
    # scatter the 14 deltas into the non-max/min slots
    slot_idx = np.argsort(
        np.where(
            (np.arange(16)[None, :] == imax[:, None])
            | (np.arange(16)[None, :] == imin[:, None]),
            99,
            np.arange(16)[None, :],
        ),
        axis=1,
        kind="stable",
    )[:, :14]
    np.put_along_axis(
        vals, slot_idx, vmin[:, None] + (others << sh[:, None]), axis=1
    )
    vals = np.clip(vals, 0, 0x7FF)

    curve = _arw2_curve()
    decoded = curve[np.minimum(vals << 1, curve.size - 1)].astype(np.uint16)

    # blocks tile each row: 2 blocks (32 pixels) cover 32 consecutive
    # columns of alternating CFA colors — pixels of one block land on
    # every OTHER column (dcraw: "col = x*2 + ..." interleave)
    out = np.zeros((height, width), np.uint16)
    dec = decoded.reshape(height, pairs, 2, 16)
    inter = np.empty((height, pairs, 32), np.uint16)
    inter[:, :, 0::2] = dec[:, :, 0, :]
    inter[:, :, 1::2] = dec[:, :, 1, :]
    out[:, : pairs * 32] = inter.reshape(height, pairs * 32)
    return out


def parse_arw(data: bytes) -> RawFile:
    """Sony ARW: CFA IFD with Compression 1 (16-bit or packed MSB) or
    32767 (ARW2 block compression, decoded vectorized in numpy)."""
    endian = "<" if data[:2] == b"II" else ">"
    ifds = _collect_ifds(data, endian, struct.unpack_from(endian + "HI", data, 2)[1])
    raw_ifds = [i for i in ifds if i.get(_T["Photometric"], [0])[0] == 32803]
    if not raw_ifds:
        raise DngError("no CFA IFD found in ARW")
    ifd = max(
        raw_ifds,
        key=lambda i: i.get(_T["ImageWidth"], [0])[0] * i.get(_T["ImageLength"], [0])[0],
    )
    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    bits = ifd.get(_T["BitsPerSample"], [16])[0]
    compression = ifd.get(_T["Compression"], [1])[0]
    off = ifd[_T["StripOffsets"]][0]
    cnt = sum(ifd.get(_T["StripByteCounts"], [len(data) - off]))

    if compression == 1:
        if bits == 16:
            plane = np.frombuffer(
                data, endian + "u2", count=width * height, offset=off
            ).reshape(height, width)
        else:
            plane = _unpack_msb(data[off : off + cnt], bits, width, height)
        white = float((1 << bits) - 1)
    elif compression == 32767:
        plane = _arw2_decode(data[off : off + cnt], width, height)
        # the tone curve's actual ceiling (coded 0x7FF << 1), not 65535
        white = float(_arw2_curve()[0xFFE])
    else:
        raise DngError(f"unsupported ARW compression {compression}")

    # Sony stores black in SR2SubIFD BlackLevel (0x7310) when reachable;
    # ARW2 data otherwise retains the sensor pedestal dcraw models as
    # 128 << (bps-12) — x4 in this module's un-shifted curve space = 512
    # (dcraw applies >> 2 to curve values; this decoder keeps them whole)
    blk = _first(ifds, _T["BlackLevel"]) or _first(ifds, 0x7310)
    if blk:
        black = float(np.mean(blk))
    elif compression == 32767:
        black = 512.0
    else:
        black = 0.0
    wb = np.ones(3, np.float32)
    neutral = _first(ifds, _T["AsShotNeutral"])
    if neutral and len(neutral) >= 3:
        n = np.asarray(neutral[:3], np.float64)
        n[n <= 0] = 1.0
        wb = (1.0 / n / (1.0 / n[1])).astype(np.float32)

    pat = ifd.get(_TAG_CFA_PATTERN)
    pattern = (
        "".join({0: "R", 1: "G", 2: "B"}.get(v, "G") for v in pat[:4])
        if pat
        else "RGGB"
    )
    return RawFile(
        cfa=plane,
        pattern=pattern,
        black_level=black,
        white_level=white,
        wb=wb,
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


# ----------------------------------------------------------- RW2 (Panasonic)

# PanasonicRaw IFD0 tags (exiftool PanasonicRaw::Main)
_RW2_SENSOR_W = 0x0002
_RW2_SENSOR_H = 0x0003
_RW2_BORDERS = (0x0004, 0x0005, 0x0006, 0x0007)  # top, left, bottom, right
_RW2_CFA = 0x0009
_RW2_BPS = 0x000A
_RW2_RED_BAL = 0x0011
_RW2_BLUE_BAL = 0x0012
_RW2_BLACKS = (0x001C, 0x001D, 0x001E)
_RW2_WB_LEVELS = (0x0024, 0x0025, 0x0026)  # red, green, blue
_RW2_RAW_OFFSET = 0x0118

# CFAPattern tag 0x0009 is 1-BASED (exiftool PanasonicRaw: 1=[Red,Green]
# [Green,Blue], 2=[Green,Red][Blue,Green], 3=[Green,Blue][Red,Green],
# 4=[Blue,Green][Green,Red]); real RW2 files nearly always write 1 (RGGB)
_RW2_PATTERNS = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}


def parse_rw2(data: bytes) -> RawFile:
    """Panasonic RW2: TIFF-family container with magic 85 ('IIU\\0') and
    vendor tags in IFD0. Strip layouts: uncompressed 16-bit, packed
    little-endian 12-bit, or the Panasonic 12-bit bitstream
    (csrc/host/pana_oly.cc, dcraw panasonic_load_raw semantics), detected by
    strip size per pixel. Crop borders come from SensorTop/Left/Bottom/
    RightBorder; WB from WBRed/Green/BlueLevel."""
    if data[:4] != b"IIU\0":
        raise DngError("not an RW2 file")
    endian = "<"
    ifds = _chained_ifds(data, endian)
    ifd = None
    for i in ifds:
        if _RW2_SENSOR_W in i and _RW2_RAW_OFFSET in i:
            ifd = i
            break
    if ifd is None:
        raise DngError("no Panasonic raw IFD in RW2")

    raw_w = ifd[_RW2_SENSOR_W][0]
    raw_h = ifd[_RW2_SENSOR_H][0]
    bits = ifd.get(_RW2_BPS, [12])[0]
    off = ifd[_RW2_RAW_OFFSET][0]
    cnt = len(data) - off
    if off <= 0 or off >= len(data) or raw_w <= 0 or raw_h <= 0:
        raise DngError("malformed RW2 raw pointers")

    # layout detection must be exact-size: the compressed bitstream is
    # padded to 0x4000-byte sections, so a >= heuristic misroutes it
    if 0 <= cnt - raw_w * raw_h * 2 < 64:
        plane = np.frombuffer(
            data, "<u2", count=raw_w * raw_h, offset=off
        ).reshape(raw_h, raw_w)
    elif 0 <= cnt - (raw_w * raw_h * 3 + 1) // 2 < 64 and bits == 12:
        plane = _unpack_12le(data[off : off + cnt], raw_w, raw_h)
    else:
        from rapidraw_tpu_torch.native import panasonic_decode

        plane = panasonic_decode(bytes(data[off:]), raw_w, raw_h)

    top = ifd.get(_RW2_BORDERS[0], [0])[0]
    left = ifd.get(_RW2_BORDERS[1], [0])[0]
    bottom = ifd.get(_RW2_BORDERS[2], [raw_h])[0]
    right = ifd.get(_RW2_BORDERS[3], [raw_w])[0]
    if 0 <= top < bottom <= raw_h and 0 <= left < right <= raw_w:
        plane = plane[top:bottom, left:right]

    blacks = [float(ifd[t][0]) for t in _RW2_BLACKS if t in ifd and ifd[t]]
    black = float(np.mean(blacks)) if blacks else 0.0

    wb = np.ones(3, np.float32)
    levels = [ifd.get(t) for t in _RW2_WB_LEVELS]
    if all(v and v[0] > 0 for v in levels):
        r, g, b = (float(v[0]) for v in levels)
        wb = np.array([r / g, 1.0, b / g], np.float32)
    elif _RW2_RED_BAL in ifd and _RW2_BLUE_BAL in ifd:
        # older models: balances are x256 multipliers relative to green
        wb = np.array(
            [ifd[_RW2_RED_BAL][0] / 256.0, 1.0, ifd[_RW2_BLUE_BAL][0] / 256.0],
            np.float32,
        )

    pat = _RW2_PATTERNS.get(int(ifd.get(_RW2_CFA, [1])[0]), "RGGB")
    return RawFile(
        cfa=plane.astype(np.uint16, copy=False),
        pattern=_shift_pattern(pat, top, left),
        black_level=black,
        white_level=float((1 << bits) - 1),
        wb=wb,
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


# ------------------------------------------------------------ ORF (Olympus)


def parse_orf(data: bytes) -> RawFile:
    """Olympus ORF: a TIFF container whose magic is 'RO'/'SR' instead of 42
    (rawler orf.rs; magics IIRO / IIRS / MMOR). The IFD chain is standard
    TIFF. Layout is detected by strip size per pixel, since Olympus writes
    Compression 1 even for its predictive codec: 16-bit LE, the literal
    12-bit little-endian packing (2 px / 3 bytes, same scheme as NEF
    packed), or the Olympus predictive codec (csrc/host/pana_oly.cc).
    """
    endian = "<" if data[:2] == b"II" else ">"
    first = struct.unpack_from(endian + "HI", data, 2)[1]
    ifds = _collect_ifds(data, endian, first)
    cands = [i for i in ifds if _T["StripOffsets"] in i and _T["ImageWidth"] in i]
    if not cands:
        raise DngError("no raw IFD found in ORF")
    ifd = max(
        cands,
        key=lambda i: i.get(_T["ImageWidth"], [0])[0] * i.get(_T["ImageLength"], [0])[0],
    )
    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    bits = ifd.get(_T["BitsPerSample"], [12])[0]
    off = ifd[_T["StripOffsets"]][0]
    cnt = sum(ifd.get(_T["StripByteCounts"], [len(data) - off]))

    if cnt >= width * height * 2:
        plane = np.frombuffer(
            data, endian + "u2", count=width * height, offset=off
        ).reshape(height, width)
        bits = max(bits, 12)
    elif cnt >= (width * height * 3 + 1) // 2:
        plane = _unpack_12le(data[off : off + cnt], width, height)
        bits = 12
    else:
        # Olympus predictive codec (dcraw olympus_load_raw semantics):
        # 3-bit sign+low, unary-class Huffman high, W/N/NW gradient
        # predictor — decoded by csrc/host/pana_oly.cc
        from rapidraw_tpu_torch.native import olympus_decode

        plane = olympus_decode(data[off:], width, width, height)
        bits = 12

    pat = ifd.get(_TAG_CFA_PATTERN)
    pattern = (
        "".join({0: "R", 1: "G", 2: "B"}.get(v, "G") for v in pat[:4])
        if pat
        else "RGGB"
    )
    return RawFile(
        cfa=plane.astype(np.uint16, copy=False),
        pattern=pattern,
        black_level=0.0,
        white_level=float((1 << bits) - 1),
        wb=np.ones(3, np.float32),
        xyz_to_cam=None,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )


# ----------------------------------------------------------- MRW (Minolta)

_MRW_PATTERNS = {0x0001: "RGGB", 0x0004: "GBRG"}


def _unpack_12be(raw: bytes, row_samples: int, n_rows: int) -> np.ndarray:
    """Big-endian (MSB-first) 12-bit packing (rawler decode_12be) — for the
    even sensor widths MRW uses this is exactly dng._unpack_msb."""
    return _unpack_msb(raw, 12, row_samples, n_rows)


def parse_mrw(data: bytes) -> RawFile:
    """Minolta MRW: '\\0MRM' + big-endian block chain ('\\0PRD' sensor
    descriptor, '\\0WBG' white-balance gains, '\\0TTW' embedded TIFF EXIF)
    followed by the CFA plane — 12-bit big-endian packed (storage 0x59) or
    16-bit big-endian words (0x52). Semantics from the publicly documented
    MRW layout (D. Jelinek's spec / dcraw's minolta handling, as with the
    ARW2 curve); 12-bit range, white level 4095.

    The reference decodes MRW via rawler (Cargo.toml:27)."""
    if data[:4] != b"\x00MRM" or len(data) < 16:
        raise DngError("not an MRW file")
    (hdr_len,) = struct.unpack_from(">I", data, 4)
    raw_off = 8 + hdr_len
    if raw_off <= 8 or raw_off >= len(data):
        raise DngError("malformed MRW header length")

    prd = None
    wbg = None
    pos = 8
    while pos + 8 <= raw_off:
        name = data[pos : pos + 4]
        (blen,) = struct.unpack_from(">I", data, pos + 4)
        body_at = pos + 8
        if blen < 0 or body_at + blen > len(data):
            raise DngError("malformed MRW block chain")
        if name == b"\x00PRD":
            prd = data[body_at : body_at + blen]
        elif name == b"\x00WBG":
            wbg = data[body_at : body_at + blen]
        pos = body_at + blen
    if prd is None or len(prd) < 24:
        raise DngError("MRW missing PRD sensor descriptor")

    ccd_h, ccd_w, img_h, img_w = struct.unpack_from(">HHHH", prd, 8)
    datasize = prd[16]
    storage = prd[18]
    (bayer,) = struct.unpack_from(">H", prd, 22)
    if ccd_h <= 0 or ccd_w <= 0 or ccd_h * ccd_w > 120_000_000:
        raise DngError("implausible MRW sensor dimensions")

    raw = data[raw_off:]
    if storage == 0x59 and datasize == 12:
        plane = _unpack_12be(raw, ccd_w, ccd_h)
    elif storage == 0x52:
        need = ccd_w * ccd_h
        if len(raw) < need * 2:
            raise DngError("truncated MRW 16-bit plane")
        plane = np.frombuffer(raw, ">u2", count=need).reshape(ccd_h, ccd_w)
    else:
        raise DngError(f"unsupported MRW storage method 0x{storage:02x}")

    if 0 < img_h <= ccd_h and 0 < img_w <= ccd_w:
        plane = plane[:img_h, :img_w]

    wb = np.ones(3, np.float32)
    if wbg is not None and len(wbg) >= 12:
        denoms = [64 << wbg[i] for i in range(4)]
        gains = struct.unpack_from(">HHHH", wbg, 4)
        norm = [g / d for g, d in zip(gains, denoms)]
        pattern0 = _MRW_PATTERNS.get(bayer, "RGGB")
        # gain order follows the bayer pattern's channel order
        by_chan = {"R": [], "G": [], "B": []}
        for ch, g in zip(pattern0, norm):
            by_chan[ch].append(g)
        if by_chan["R"] and by_chan["G"] and by_chan["B"]:
            r = by_chan["R"][0]
            g = float(np.mean(by_chan["G"]))
            b = by_chan["B"][0]
            if g > 0:
                wb = np.array([r / g, 1.0, b / g], np.float32)

    return RawFile(
        cfa=np.ascontiguousarray(plane.astype(np.uint16, copy=False)),
        pattern=_MRW_PATTERNS.get(bayer, "RGGB"),
        black_level=0.0,
        white_level=4095.0,
        wb=wb,
        xyz_to_cam=None,
    )


# ------------------------------------ generic vendor TIFF-CFA (the long tail)

# Epson ERF, Mamiya MEF, Leaf MOS, Hasselblad FFF/3FR, Kodak KDC/DCR/DCS and
# Samsung SRW are TIFF-family containers whose raw plane is stored with
# Compression=1: plain 16-bit words or TIFF 6.0 MSB-first packed 12/14-bit
# strips. The reference decodes all of them via rawler (Cargo.toml:27).
# Vendor-specific metadata handled here: Samsung as-shot WB levels (tags
# 0xa021 gains / 0xa028 black offsets, dcraw's samsung parsing) and
# DNG-style AsShotNeutral when present (Kodak DCS writes it).

_SAMSUNG_WB = 0xA021
_SAMSUNG_WB_BLACK = 0xA028


def parse_tiff_cfa(data: bytes) -> RawFile:
    """Decode a vendor TIFF whose largest 1-sample strip IFD is the CFA.

    Thumbnails/previews in these containers are RGB (SamplesPerPixel=3) or
    8-bit, so the raw plane is the largest IFD with SamplesPerPixel=1 and
    BitsPerSample in {12, 14, 16}. Compressed dialects (Hasselblad 3FR
    entropy coding, Kodak DCR bitstreams, Samsung SRW v2 compressed) refuse
    precisely rather than mis-decode."""
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise DngError("not a TIFF-family file")
    first = struct.unpack_from(endian + "HI", data, 2)[1]
    ifds = _collect_ifds(data, endian, first)
    make = str(_first(ifds, _TAG_MAKE) or "").strip()

    cands = []
    for i in ifds:
        if _T["StripOffsets"] not in i:
            continue
        spp = i.get(_T["SamplesPerPixel"], [1])[0]
        bits = i.get(_T["BitsPerSample"], [16])[0]
        w = i.get(_T["ImageWidth"], [0])[0]
        h = i.get(_T["ImageLength"], [0])[0]
        if spp != 1 or bits not in (12, 14, 16) or w <= 0 or h <= 0:
            continue
        cands.append((w * h, i))
    if not cands:
        raise DngError(f"no raw CFA IFD found in {make or 'vendor'} TIFF")
    ifd = max(cands, key=lambda t: t[0])[1]

    width = ifd[_T["ImageWidth"]][0]
    height = ifd[_T["ImageLength"]][0]
    if width * height > 1 << 28:
        raise DngError(f"implausible raw dimensions {width}x{height}")
    bits = ifd.get(_T["BitsPerSample"], [16])[0]
    compression = ifd.get(_T["Compression"], [1])[0]
    if compression != 1:
        raise DngError(
            f"unsupported {make or 'vendor'} TIFF compression {compression}"
        )

    offsets = ifd[_T["StripOffsets"]]
    counts = ifd.get(_T["StripByteCounts"], [len(data) - offsets[0]])
    rps = ifd.get(_T["RowsPerStrip"], [height])[0]
    if rps <= 0:
        raise DngError("implausible RowsPerStrip")
    plane = np.zeros((height, width), np.uint16)
    row = 0
    for off, cnt in zip(offsets, counts):
        n_rows = min(rps, height - row)
        if n_rows <= 0:
            break
        if bits == 16:
            need = n_rows * width * 2
            if off + need > len(data) or cnt < need:
                raise DngError("truncated 16-bit strip")
            strip = np.frombuffer(
                data, endian + "u2", count=n_rows * width, offset=off
            ).reshape(n_rows, width)
        else:
            need = ((width * bits + 7) // 8) * n_rows
            if off + need > len(data) or cnt < need:
                raise DngError(f"truncated packed {bits}-bit strip")
            strip = _unpack_msb(data[off : off + need], bits, width, n_rows)
        plane[row : row + n_rows] = strip
        row += n_rows
    if row < height:
        raise DngError("strips cover fewer rows than ImageLength")

    black = float(np.mean(ifd.get(_T["BlackLevel"], [0])))
    white = float(ifd.get(_T["WhiteLevel"], [(1 << bits) - 1])[0])

    wb = np.ones(3, np.float32)
    neutral = _first(ifds, _T["AsShotNeutral"])
    gains = _first(ifds, _SAMSUNG_WB)
    if gains and len(gains) >= 4:
        # dcraw samsung: cam_mul[c ^ (c >> 1)] = levels[c] - blacks[c]
        # -> file order (R, G, B, G2) lands on cam_mul (R, G, G2, B)
        blacks = _first(ifds, _SAMSUNG_WB_BLACK) or [0, 0, 0, 0]
        lv = [float(g) - float(b) for g, b in zip(gains[:4], blacks[:4])]
        r, g, b = lv[0], lv[1], lv[2]
        if g > 0 and r > 0 and b > 0:
            wb = np.array([r / g, 1.0, b / g], np.float32)
    elif neutral and len(neutral) >= 3:
        n = np.asarray(neutral[:3], np.float64)
        n[n <= 0] = 1.0
        inv = 1.0 / n
        wb = (inv / inv[1]).astype(np.float32)

    pat = ifd.get(_TAG_CFA_PATTERN) or _first(ifds, _TAG_CFA_PATTERN)
    pattern = (
        "".join({0: "R", 1: "G", 2: "B"}.get(v, "G") for v in pat[:4])
        if pat
        else "RGGB"
    )
    cm = _first(ifds, _T["ColorMatrix2"]) or _first(ifds, _T["ColorMatrix1"])
    xyz_to_cam = (
        np.asarray(cm, np.float32).reshape(3, 3) if cm and len(cm) >= 9 else None
    )
    return RawFile(
        cfa=plane,
        pattern=pattern,
        black_level=black,
        white_level=white,
        wb=wb,
        xyz_to_cam=xyz_to_cam,
        orientation=int((_first(ifds, _T["Orientation"]) or [1])[0]),
    )
