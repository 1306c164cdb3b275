"""Phase One IIQ container parser (a copy of `rapidraw_tpu/io/iiq.py`).

An IIQ file is a TIFF wrapper (thumbnail/EXIF IFDs) whose raw payload is
addressed by a proprietary directory: the magic "IIII" (little-endian) or
"MMMM" (big-endian) within the first 32 bytes, a 'Raw' signature word, and
a 16-byte-entry directory of (tag, type, len, data) u32s. Semantics are
implemented from the publicly documented dcraw layout (parse_phase_one /
phase_one_load_raw[_c]); the reference app decodes IIQ via the rawler
crate (src-tauri/Cargo.toml:27, raw_processing.rs:15-30).

Formats: 0/1/2 are plain 16-bit planes (1/2 with the two-key XOR
scramble); 3/4/5/8 are the per-row compressed bitstream decoded by
csrc/host/phase_one.cc (format 5 applies the small-value gamma ramp, format
8 skips the final <<2). Other format codes refuse precisely.

The 0x110 meta-directory sensor corrections (dcraw's phase_one_correct)
are applied: polynomial gain curves (0x419/0x41A), the sensor-defect
list (0x400: bad pixels, bad columns), quadrant multipliers (0x41E),
flat-field grids (0x401 float / 0x410+0x416 u16 all-color / 0x40B u16
red+blue), quadrant linearizations (0x41F and the combined 0x431, both
natural-cubic-spline code curves) and the value-dependent row-gradient
gain (0x412, entry selected by minimal |tag-0x21A| distance). All are
implemented from the publicly documented dcraw/libraw
`phase_one_correct` semantics; malformed correction payloads degrade to
the uncorrected plane (corrections are refinement, not decode).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from rapidraw_tpu_torch.io.dng import DngError, RawFile

# ProPhoto (ROMM) -> linear sRGB, the constant dcraw composes the IIQ
# color-matrix tag with (romm_coeff).
_RGB_FROM_ROMM = np.array(
    [
        [2.034193, -0.727420, -0.306766],
        [-0.228811, 1.231729, -0.002922],
        [-0.008565, -0.153273, 1.161839],
    ],
    np.float64,
)

# dcraw maps tag 0x100 (flip) through "0653"[data & 3]; dcraw flip codes
# correspond to EXIF orientations 1/6/8/3.
_FLIP_TO_ORIENTATION = {0: 1, 6: 6, 5: 8, 3: 3}


def _find_base(data: bytes) -> tuple[int, bool]:
    head = data[:32]
    for magic, big in ((b"MMMM", True), (b"IIII", False)):
        idx = head.find(magic)
        if idx >= 0:
            return idx, big
    raise DngError("not an IIQ file (no Phase One magic)")


def _parse_dir(data: bytes, base: int, big: bool) -> dict:
    """tag -> (type, length, data_word, file_pos_of_data_word)."""
    e = ">" if big else "<"
    if len(data) < base + 16:
        raise DngError("truncated IIQ header")
    (sig,) = struct.unpack_from(e + "I", data, base + 4)
    if (sig >> 8) != 0x526177:  # 'Raw'
        raise DngError("IIQ missing Raw signature")
    (dir_off,) = struct.unpack_from(e + "I", data, base + 8)
    pos = base + dir_off
    if pos + 8 > len(data):
        raise DngError("IIQ directory offset out of range")
    (entries,) = struct.unpack_from(e + "I", data, pos)
    pos += 8
    if entries > 4096 or pos + 16 * entries > len(data):
        raise DngError("implausible IIQ directory")
    out = {}
    for _ in range(entries):
        tag, typ, length, word = struct.unpack_from(e + "IIII", data, pos)
        out[tag] = (typ, length, word, pos + 12)
        pos += 16
    return out


def _floats(data: bytes, base: int, big: bool, entry, n: int) -> np.ndarray:
    _, length, word, _ = entry
    off = base + word
    if length < 4 * n or off + 4 * n > len(data):
        raise DngError("truncated IIQ float tag")
    e = ">" if big else "<"
    return np.array(struct.unpack_from(e + f"{n}f", data, off), np.float64)


def iiq_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) of the active area from directory metadata only."""
    base, big = _find_base(data)
    d = _parse_dir(data, base, big)
    w = d.get(0x10C, (0, 0, 0, 0))[2] or d.get(0x108, (0, 0, 0, 0))[2]
    h = d.get(0x10D, (0, 0, 0, 0))[2] or d.get(0x109, (0, 0, 0, 0))[2]
    if not (w and h):
        raise DngError("IIQ missing dimensions")
    return int(w), int(h)


# dcraw phase_one_correct neighbor table: 4 diagonals, 4 straight-2s,
# 4 diagonal-2s.
_DEFECT_DIRS = (
    (-1, -1), (-1, 1), (1, -1), (1, 1),
    (-2, 0), (0, -2), (0, 2), (2, 0),
    (-2, -2), (-2, 2), (2, -2), (2, 2),
)


def _neighbor_col(plane: np.ndarray, rows: np.ndarray, col: int, dr: int, dc: int) -> np.ndarray:
    """Zero-padded neighbor read of one column's worth of rows (dcraw's
    bounds-checked `raw(row,col)` accessor returns 0 out of range)."""
    h, w = plane.shape
    c = col + dc
    out = np.zeros(rows.shape[0], np.float64)
    if 0 <= c < w:
        r = rows + dr
        ok = (r >= 0) & (r < h)
        out[ok] = plane[r[ok], c]
    return out


def _fix_bad_column(plane: np.ndarray, col: int, top: int, left: int) -> None:
    """Defect types 131/137: re-estimate every pixel of one column.

    Green sites (RGGB FC==1): average of the 4 diagonal neighbors with the
    single largest-deviation tap rejected. Non-green sites: dcraw's fixed
    blend of the four ±2 diagonals (0.0732233 each) and the same-row ±2
    horizontal pair (0.3535534 each).
    """
    h, w = plane.shape
    rows = np.arange(h)
    green = ((rows - top) + (col - left)) % 2 == 1

    vals = np.stack([_neighbor_col(plane, rows, col, dr, dc) for dr, dc in _DEFECT_DIRS[:4]])
    s = vals.sum(axis=0)
    dev = np.abs(4.0 * vals - s)
    mx = np.argmax(dev, axis=0)  # first max, like dcraw's strict-> scan
    g_fix = (s - vals[mx, rows]) / 3.0 + 0.5

    s8 = sum(_neighbor_col(plane, rows, col, dr, dc) for dr, dc in _DEFECT_DIRS[8:12])
    horiz = _neighbor_col(plane, rows, col, 0, -2) + _neighbor_col(plane, rows, col, 0, 2)
    ng_fix = 0.5 + s8 * 0.0732233 + horiz * 0.3535534

    fixed = np.where(green, g_fix, ng_fix)
    plane[:, col] = np.clip(fixed, 0, 65535).astype(np.uint16)  # trunc like C cast


def _fix_bad_pixel(plane: np.ndarray, row: int, col: int, top: int, left: int) -> None:
    """Defect type 129: 8-neighbor integer mean; the neighbor set starts at
    the diagonals for green sites and at the straight-2s otherwise."""
    h, w = plane.shape
    j = 0 if ((row - top) + (col - left)) % 2 == 1 else 4
    total = 0
    for dr, dc in _DEFECT_DIRS[j : j + 8]:
        r, c = row + dr, col + dc
        if 0 <= r < h and 0 <= c < w:
            total += int(plane[r, c])
    plane[row, col] = (total + 4) >> 3


def _cubic_spline_curve(cx: np.ndarray, cf: np.ndarray) -> np.ndarray | None:
    """dcraw `cubic_spline`: a natural cubic spline through the knots
    (cx, cf)/65535, sampled at every 16-bit code value and rounded
    half-up. Returns None (no correction) for non-increasing knots,
    where the reference's linear solve would be degenerate."""
    x = np.asarray(cx, np.float64) / 65535.0
    y = np.asarray(cf, np.float64) / 65535.0
    n = x.shape[0]
    h = np.diff(x)
    if n < 2 or np.any(h <= 0):
        return None
    c2 = np.zeros(n, np.float64)  # second derivatives, natural ends
    if n > 2:
        slopes = np.diff(y) / h
        A = np.zeros((n - 2, n - 2), np.float64)
        rhs = 6.0 * np.diff(slopes)
        for i in range(n - 2):
            A[i, i] = 2.0 * (h[i] + h[i + 1])
            if i:
                A[i, i - 1] = A[i - 1, i] = h[i]
        try:
            c2[1:-1] = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:
            return None
    t = np.arange(65536, dtype=np.float64) / 65535.0
    seg = np.clip(np.searchsorted(x, t, side="right") - 1, 0, n - 2)
    v = t - x[seg]
    hs = h[seg]
    out = (
        y[seg]
        + ((y[seg + 1] - y[seg]) / hs - hs * (2.0 * c2[seg] + c2[seg + 1]) / 6.0) * v
        + 0.5 * c2[seg] * v * v
        + (c2[seg + 1] - c2[seg]) / (6.0 * hs) * v * v * v
    )
    return np.clip(np.floor(out * 65535.0 + 0.5), 0, 65535).astype(np.uint16)


def _quadrant_slices(split_row: int, split_col: int, qr: int, qc: int):
    rs = slice(split_row, None) if qr else slice(0, split_row)
    cs = slice(split_col, None) if qc else slice(0, split_col)
    return rs, cs


def _flat_field(
    plane: np.ndarray,
    data: bytes,
    p: int,
    me: str,
    is_float: bool,
    nc: int,
    top: int,
    left: int,
) -> None:
    """dcraw `phase_one_flat_field(is_float, nc)`, in place.

    Layout: 8 u16 header (col0, row0, width, height, col_cell, row_cell,
    _, _) then a (rows, cols, nc/2)-ordered grid of gains — float32 when
    is_float else u16/32768. Gains are bilinearly interpolated over each
    (row_cell x col_cell) grid cell and multiply the plane (truncating
    int store, clipped to u16). nc==2 applies one gain everywhere; nc==4
    carries separate red/blue gains applied at FC==0/FC==2 sites only.
    """
    if p + 16 > len(data):
        return
    head = struct.unpack_from(me + "8H", data, p)
    p += 16
    if head[2] * head[3] * head[4] * head[5] == 0:
        return
    wide = -(-head[2] // head[4])
    high = -(-head[3] // head[5])
    pairs = nc // 2
    count = high * wide * pairs
    if is_float:
        if p + 4 * count > len(data):
            return
        vals = np.frombuffer(data, me + "f4", count=count, offset=p).astype(np.float64)
    else:
        if p + 2 * count > len(data):
            return
        vals = (
            np.frombuffer(data, me + "u2", count=count, offset=p).astype(np.float64)
            / 32768.0
        )
    if not np.all(np.isfinite(vals)):
        return
    grid = vals.reshape(high, wide, pairs)
    h, w = plane.shape
    row_hi = min(h, head[1] + head[3] - head[5])
    col_hi = min(w, head[0] + head[2] - head[4])
    for y in range(1, high):
        r0 = head[1] + (y - 1) * head[5]
        r1 = min(head[1] + y * head[5], row_hi)
        if r1 <= r0:
            continue
        rr = np.arange(r0, r1)
        ry = ((rr - r0) / float(head[5]))[:, None, None]
        # per-row interpolated grid row: (rows, wide, pairs)
        grow = grid[y - 1][None, :, :] + (grid[y][None, :, :] - grid[y - 1][None, :, :]) * ry
        for x in range(1, wide):
            c0 = head[0] + (x - 1) * head[4]
            c1 = min(head[0] + x * head[4], col_hi)
            if c1 <= c0:
                continue
            cc = np.arange(c0, c1)
            cxf = ((cc - c0) / float(head[4]))[None, :, None]
            gain = (
                grow[:, x - 1 : x, :]
                + (grow[:, x : x + 1, :] - grow[:, x - 1 : x, :]) * cxf
            )  # (rows, cols, pairs)
            block = plane[r0:r1, c0:c1].astype(np.float64)
            if nc > 2:
                rpar = ((rr - top) & 1)[:, None]
                cpar = ((cc - left) & 1)[None, :]
                red = (rpar == 0) & (cpar == 0)  # FC==0 sites
                blue = (rpar == 1) & (cpar == 1)  # FC==2 sites
                out = block.copy()
                out[red] = np.trunc(block[red] * gain[:, :, 0][red])
                out[blue] = np.trunc(block[blue] * gain[:, :, 1][blue])
            else:
                out = np.trunc(block * gain[:, :, 0])
            plane[r0:r1, c0:c1] = np.clip(out, 0, 65535).astype(np.uint16)


def _apply_spatial_gain_412(
    plane: np.ndarray,
    data: bytes,
    p: int,
    me: str,
) -> np.ndarray:
    """dcraw's tag-0x412 correction: a value-dependent row-gradient gain.

    Layout at p: 9 u32 (masked to 15 bits) header, 2 pad bytes, then two
    tables laid out contiguously — head[1]*head[3] float32 y-values plus
    head[2]*head[4] more, followed by the same counts of u16 x-knots.
    Per pixel: num = raw/2; for the pixel's column strip i (and i+1) the
    x-knots of strip i are scanned for the first knot > num, the y-table
    is linearly interpolated at num, the two strip multipliers blend by
    the REDUCED fractional strip position (dcraw's ``cfrac -= cip =
    cfrac`` idiom: cfrac is the in-strip fraction, not the unreduced
    strip coordinate), and raw' = trunc((mult*row + num)*2) clipped to
    u16. The reference's strip-overrun read for the last
    column strip lands in table 1 because the tables are contiguous —
    reproduced here by indexing the concatenated tables.
    """
    if p + 38 > len(data):
        return plane
    head = [struct.unpack_from(me + "I", data, p + 4 * i)[0] & 0x7FFF for i in range(9)]
    n0 = head[1] * head[3]
    n1 = head[2] * head[4]
    nstrip = head[1]
    if not n0 or not nstrip:
        return plane
    q = p + 38
    if q + 6 * (n0 + n1) > len(data):
        return plane
    yval = np.frombuffer(data, me + "f4", count=n0 + n1, offset=q).astype(np.float64)
    xval = np.frombuffer(
        data, me + "u2", count=n0 + n1, offset=q + 4 * (n0 + n1)
    ).astype(np.float64)
    if not np.all(np.isfinite(yval)):
        return plane
    h, w = plane.shape
    # Per-strip value LUTs: num = raw/2 for every 16-bit code.
    num = np.arange(65536, dtype=np.float64) * 0.5
    luts: dict[int, np.ndarray | None] = {}

    def strip_lut(i: int) -> np.ndarray | None:
        if i in luts:
            return luts[i]
        lo = nstrip * i
        hi = lo + nstrip
        if lo < 0 or hi > n0 + n1:
            luts[i] = None
            return None
        xs = xval[lo:hi]
        ys = yval[lo:hi]
        if np.any(np.diff(xs) < 0):
            # dcraw's linear scan assumes ascending knots; refuse the
            # correction rather than diverge on malformed tables
            luts[i] = None
            return None
        jj = np.searchsorted(xs, num, side="right")
        k = np.minimum(jj, nstrip - 1)
        prev = np.maximum(k - 1, 0)
        denom = xs[k] - xs[prev]
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(
                (jj == 0) | (jj == nstrip) | (denom == 0),
                0.0,
                (xs[k] - num) / np.where(denom == 0, 1.0, denom),
            )
        luts[i] = ys[prev] * frac + ys[k] * (1.0 - frac)
        return luts[i]

    out = plane.astype(np.float64)
    rows = np.arange(h, dtype=np.float64)[:, None]
    cfrac_all = (
        np.arange(w, dtype=np.float32) * np.float32(head[3]) / np.float32(w)
    ).astype(np.float64)
    cip_all = cfrac_all.astype(np.int64)
    for i in np.unique(cip_all):
        lut0 = strip_lut(int(i))
        lut1 = strip_lut(int(i) + 1)
        if lut0 is None or lut1 is None:
            return plane
        sel = cip_all == i
        cf = (cfrac_all[sel] - i)[None, :]
        block = plane[:, sel]
        m0 = lut0[block]
        m1 = lut1[block]
        out[:, sel] = np.trunc(
            ((m0 * (1.0 - cf) + m1 * cf) * rows + block * 0.5) * 2.0
        )
    return np.clip(out, 0, 65535).astype(np.uint16)


def _apply_phase_one_corrections(
    plane: np.ndarray,
    data: bytes,
    base: int,
    big: bool,
    d: dict,
    split_col: int,
    split_row: int,
    top: int,
    left: int,
) -> np.ndarray:
    """dcraw `phase_one_correct` over the full-sensor plane.

    Implemented from the publicly documented dcraw semantics (the
    reference app's rawler path, raw_processing.rs:15-30, inherits the
    same stage from its decoder): polynomial gain curves (0x419 applies
    right of split_col, 0x41A whole-frame), the sensor-defect list
    (0x400), quadrant multipliers (0x41E), flat-field grids
    (0x401/0x410/0x416/0x40B), quadrant linearizations (0x41F/0x431)
    and the value-dependent row-gradient gain (0x412, applied last from
    the entry nearest tag 0x21A). Malformed correction data degrades to
    the uncorrected plane rather than refusing the file — corrections
    are refinement, not decode.
    """
    if 0x110 not in d:
        return plane
    _, meta_len, word, _ = d[0x110]
    meta = base + word
    if not meta_len or meta + 16 > len(data):
        return plane
    me = ">" if data[meta : meta + 2] == b"MM" else "<"

    def u32(pos: int) -> int:
        return struct.unpack_from(me + "I", data, pos)[0]

    def f32(pos: int) -> float:
        return struct.unpack_from(me + "f", data, pos)[0]

    try:
        dir_pos = meta + u32(meta + 8)
        entries = u32(dir_pos)
        if entries > 4096 or dir_pos + 8 + 12 * entries > len(data):
            return plane
    except struct.error:
        return plane

    # tag 0x210 (a float in the MAIN directory's data word) feeds the
    # 0x419 curve's constant-term adjustment
    tag_210 = 0.0
    if 0x210 in d:
        tag_210 = float(
            struct.unpack(
                (">" if big else "<") + "f",
                struct.pack((">" if big else "<") + "I", d[0x210][2]),
            )[0]
        )

    tag_21a = int(d[0x21A][2]) if 0x21A in d else 0

    plane = np.ascontiguousarray(plane)
    qmult_applied = False
    qlin_applied = False
    best_412: int | None = None
    best_412_diff = 1 << 62
    pos = dir_pos + 8
    for _ in range(entries):
        tag, length, off_word = (
            u32(pos),
            u32(pos + 4),
            u32(pos + 8),
        )
        pos += 12
        p = meta + off_word
        try:
            if tag == 0x419:  # polynomial curve, right half (col >= split_col)
                if p + 4 + 32 > len(data):
                    continue
                poly = [f32(p + 4 + 4 * i) for i in range(8)]
                if not all(math.isfinite(c) for c in poly):
                    continue
                p3 = poly[3] + (tag_210 - poly[7]) * poly[6] + 1.0
                i = np.arange(65536, dtype=np.float64)
                curve = np.clip((poly[5] * i + p3) * i + poly[1], 0, 65535).astype(np.uint16)
                plane[:, split_col:] = curve[plane[:, split_col:]]
            elif tag == 0x41A:  # polynomial curve, whole frame
                if p + 16 > len(data):
                    continue
                poly = [f32(p + 4 * i) for i in range(4)]
                if not all(math.isfinite(c) for c in poly):
                    continue
                i = np.arange(65536, dtype=np.float64)
                num = np.zeros_like(i)
                for c in reversed(poly):
                    num = num * i + c
                curve = np.clip(num + i, 0, 65535).astype(np.uint16)
                plane[:, :] = curve[plane]
            elif tag == 0x400:  # sensor defects: 8-byte (col, row, type, _)
                n = max(int(length), 0) // 8
                if p + 8 * n > len(data):
                    continue
                for k in range(n):
                    col, row, typ = struct.unpack_from(me + "HHH", data, p + 8 * k)
                    if col >= plane.shape[1]:
                        continue
                    if typ in (131, 137):
                        _fix_bad_column(plane, col, top, left)
                    elif typ == 129:
                        if row < plane.shape[0]:
                            _fix_bad_pixel(plane, row, col, top, left)
            elif tag == 0x41E and not qmult_applied:  # quadrant multipliers
                # dcraw's documented word layout: 4 skip words, q00,
                # 5 skip, q01, 3 skip, q10, 3 skip, q11 (floats, +1.0)
                idx = [4, 10, 14, 18]
                if p + 19 * 4 > len(data):
                    continue
                q = [1.0 + f32(p + 4 * i) for i in idx]
                if not all(math.isfinite(v) for v in q):
                    continue
                qm = np.empty(plane.shape, np.float64)
                qm[:split_row, :split_col] = q[0]
                qm[:split_row, split_col:] = q[1]
                qm[split_row:, :split_col] = q[2]
                qm[split_row:, split_col:] = q[3]
                plane = np.clip(plane * qm, 0, 65535).astype(np.uint16)
                # dcraw's phase_one_correct marks BOTH flags when 0x41E
                # applies, so a later 0x41F entry must be skipped too.
                qmult_applied = True
                qlin_applied = True
            elif tag == 0x401:  # all-color flat field, float gains
                _flat_field(plane, data, p, me, True, 2, top, left)
            elif tag in (0x410, 0x416):  # all-color flat field, u16 gains
                _flat_field(plane, data, p, me, False, 2, top, left)
            elif tag == 0x40B:  # red+blue flat field, u16 gains
                _flat_field(plane, data, p, me, False, 4, top, left)
            elif tag == 0x41F and not qlin_applied:  # quadrant linearization
                if p + 4 * 28 > len(data):
                    continue
                lc = (
                    np.frombuffer(data, me + "u4", count=28, offset=p).astype(np.int64)
                    & 0xFFFF
                ).reshape(2, 2, 7)
                ref = (lc.sum(axis=(0, 1)) + 2) >> 2
                for qr in range(2):
                    for qc in range(2):
                        curve = _cubic_spline_curve(
                            np.concatenate(([0], lc[qr, qc], [65535])),
                            np.concatenate(([0], ref, [65535])),
                        )
                        if curve is None:
                            continue
                        rs, cs = _quadrant_slices(split_row, split_col, qr, qc)
                        plane[rs, cs] = curve[plane[rs, cs]]
                qlin_applied = True
            elif tag == 0x431 and not qmult_applied:  # quadrant combined
                if p + 4 * 35 > len(data):
                    continue
                words = (
                    np.frombuffer(data, me + "u4", count=35, offset=p).astype(np.int64)
                    & 0xFFFF
                )
                ref = words[:7]
                lc = words[7:].reshape(2, 2, 7)
                for qr in range(2):
                    for qc in range(2):
                        curve = _cubic_spline_curve(
                            np.concatenate(([0], ref, [65535])),
                            np.concatenate(([0], lc[qr, qc], [65535])),
                        )
                        if curve is None:
                            continue
                        rs, cs = _quadrant_slices(split_row, split_col, qr, qc)
                        plane[rs, cs] = curve[plane[rs, cs]]
                qmult_applied = True
                qlin_applied = True
            elif tag == 0x412:
                # choose the 0x412 entry whose discriminator u16 (at
                # byte 36 of the payload) is nearest main-dir tag 0x21A
                if p + 38 > len(data):
                    continue
                disc = struct.unpack_from(me + "H", data, p + 36)[0]
                diff = abs(disc - tag_21a)
                if diff < best_412_diff:
                    best_412_diff = diff
                    best_412 = p
        except (struct.error, IndexError):
            continue
    if best_412 is not None:
        plane = _apply_spatial_gain_412(plane, data, best_412, me)
    return plane


def parse_iiq(data: bytes) -> RawFile:
    from rapidraw_tpu_torch.io.makers import _shift_pattern

    base, big = _find_base(data)
    d = _parse_dir(data, base, big)
    e = ">" if big else "<"

    def scalar(tag: int, default: int = 0) -> int:
        return int(d[tag][2]) if tag in d else default

    raw_width = scalar(0x108)
    raw_height = scalar(0x109)
    if not (0 < raw_width <= 32768 and 0 < raw_height <= 32768):
        raise DngError("implausible IIQ sensor dimensions")
    if raw_width * raw_height > 150_000_000:
        raise DngError("implausible IIQ sensor size")
    left = scalar(0x10A)
    top = scalar(0x10B)
    width = scalar(0x10C)
    height = scalar(0x10D)
    fmt = scalar(0x10E)
    if 0x10F not in d:
        raise DngError("IIQ missing raw data offset")
    data_offset = base + scalar(0x10F)
    black = scalar(0x21D)
    split_col = scalar(0x222)
    split_row = scalar(0x224)

    if data_offset < 0 or data_offset >= len(data):
        raise DngError("IIQ raw data offset out of range")

    if fmt < 3:
        need = raw_width * raw_height
        region = data[data_offset : data_offset + need * 2]
        if len(region) < need * 2:
            raise DngError("truncated IIQ 16-bit plane")
        plane = np.frombuffer(region, e + "u2", count=need).astype(np.uint16)
        if fmt:
            # two-key XOR scramble over column pairs (dcraw
            # phase_one_load_raw): keys live in tag 0x112's data word
            if 0x112 not in d:
                raise DngError("scrambled IIQ missing key tag 0x112")
            key_pos = d[0x112][3]
            akey, bkey = struct.unpack_from(e + "HH", data, key_pos)
            mask = 0x5555 if fmt == 1 else 0x1354
            inv = ~mask & 0xFFFF
            a = plane[0::2] ^ akey
            b = plane[1::2] ^ bkey
            plane = plane.copy()
            plane[0::2] = (a & mask) | (b & inv)
            plane[1::2] = (b & mask) | (a & inv)
        plane = plane.reshape(raw_height, raw_width)
        black_level = float(black)
        white_level = 65535.0
    elif fmt in (3, 4, 5, 8):
        from rapidraw_tpu_torch.native import phase_one_decode

        if 0x21C not in d:
            raise DngError("compressed IIQ missing strip-offset tag")
        strip_off = base + scalar(0x21C)
        if strip_off + 4 * raw_height > len(data):
            raise DngError("IIQ strip offsets out of range")
        offsets = np.frombuffer(
            data, e + "u4", count=raw_height, offset=strip_off
        ).astype(np.uint32)
        pix = phase_one_decode(
            data[data_offset:], offsets, raw_width, raw_height, fmt, big
        )

        def black_field(tag: int, n: int) -> np.ndarray:
            if tag not in d:
                return np.zeros((n, 2), np.int32)
            off = base + d[tag][2]
            if off + 4 * n > len(data):
                raise DngError("IIQ black-field offset out of range")
            return (
                np.frombuffer(data, e + "u2", count=2 * n, offset=off)
                .astype(np.int16)
                .reshape(n, 2)
                .astype(np.int32)
            )

        cblack = black_field(0x223, raw_height)  # per-row pair, split by col
        rblack = black_field(0x225, raw_width)  # per-col pair, split by row
        shift = 2 if fmt != 8 else 0
        cols = np.arange(raw_width)
        rows = np.arange(raw_height)
        v = (pix.astype(np.int32) << shift) - black
        v = v + cblack[rows[:, None], (cols[None, :] >= split_col).astype(np.int32)]
        v = v + rblack[cols[None, :], (rows[:, None] >= split_row).astype(np.int32)]
        plane = np.clip(v, 0, 65535).astype(np.uint16)
        black_level = 0.0
        white_level = float(0xFFFC - black)
    else:
        from rapidraw_tpu_torch.io.containers import UnsupportedRawFormat

        raise UnsupportedRawFormat("iiq", f"IIQ format code {fmt}")

    plane = _apply_phase_one_corrections(
        plane, data, base, big, d, split_col, split_row, top, left
    )

    pattern = "RGGB"
    if 0 < width <= raw_width - left and 0 < height <= raw_height - top:
        plane = plane[top : top + height, left : left + width]
        pattern = _shift_pattern(pattern, top & 1, left & 1)

    wb = np.ones(3, np.float32)
    if 0x107 in d:
        mul = _floats(data, base, big, d[0x107], 3)
        if np.all(np.isfinite(mul)) and mul[1] > 0:
            wb = (mul / mul[1]).astype(np.float32)

    xyz_to_cam = None
    if 0x106 in d:
        romm_cam = _floats(data, base, big, d[0x106], 9).reshape(3, 3)
        if np.all(np.isfinite(romm_cam)):
            # dcraw romm_coeff: cmatrix = romm_cam @ (sRGB <- ROMM) is the
            # camera -> sRGB matrix; our RawFile carries XYZ -> camera
            from rapidraw_tpu_torch.raw.color import SRGB_TO_XYZ

            cmatrix = romm_cam @ _RGB_FROM_ROMM
            try:
                xyz_to_cam = (
                    np.linalg.inv(cmatrix) @ np.linalg.inv(SRGB_TO_XYZ)
                ).astype(np.float32)
            except np.linalg.LinAlgError:
                xyz_to_cam = None

    flip_code = int("0653"[scalar(0x100) & 3])
    return RawFile(
        cfa=np.ascontiguousarray(plane),
        pattern=pattern,
        black_level=black_level,
        white_level=white_level,
        wb=wb,
        xyz_to_cam=xyz_to_cam,
        orientation=_FLIP_TO_ORIENTATION.get(flip_code, 1),
    )
