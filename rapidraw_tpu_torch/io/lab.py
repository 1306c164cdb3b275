"""PIL's convert("RGB") of a CIELab ("LAB") image, on the host, byte for
byte.

`Image.convert` runs ImageCms for it (PIL/Image.py:1108-1121): littlecms
transforms TYPE_Lab_8 pixels from PIL's built-in Lab profile (D50) to its
sRGB profile at the perceptual intent (for a matrix-shaper output, the
colorimetric transform). littlecms does not evaluate that transform per
pixel: for 8-bit data it samples it once on a 33 x 33 x 33 grid of 16-bit
inputs (OptimizeByResampling) and interpolates the grid per pixel in 16-bit
fixed point (TetrahedralInterp16). This module does both as littlecms does:

  * the grid: each node's 16-bit Lab (i * 65535 / 32, rounded) through the
    pipeline's stages with their single-precision outputs (cmsLab2XYZ at
    D50 scaled by littlecms's XYZ encoding; the inverse of the sRGB
    colorants, the sRGB primaries adapted from D65 to D50 by Bradford as
    cmsCreate_sRGBProfile adapts them; the inverted sRGB parametric curve,
    type -4), saturated to 16 bits;
  * the pixel: its bytes widened to 16 bits (x * 257), the grid cell and
    the fractions from _cmsToFixedDomain, the tetrahedron of the sorted
    fractions, the weighted sum rounded as littlecms rounds it, and the
    16-bit result cut to 8 bits as littlecms packs it.

PIL holds a LAB image's a and b with 128 added and gives its bytes (and a
TIFF stores them) signed, so `lab_to_srgb` takes the bytes as
`np.asarray(image)` gives them. Checked against PIL 12.1 (littlecms 2.17)
on all 2^24 values.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_D50 = (0.9642, 1.0, 0.8249)
_D65_XY = (0.3127, 0.3290)
_PRIMARIES_XY = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                      [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]])
# sRGB's curve as littlecms builds it: Y = (a X + b)^g | X >= d, c X below
_SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_XYZ_ENCODING = 1.0 + 32767.0 / 32768.0  # MAX_ENCODEABLE_XYZ
GRID = 33
_OPTA = (3, 3 * GRID, 3 * GRID * GRID)  # strides of the z, y and x axes


def _xyz(xy) -> np.ndarray:
    x, y = xy
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _srgb_to_xyz_d50() -> np.ndarray:
    """cmsCreate_sRGBProfile's colorants: the RGB -> XYZ matrix of the sRGB
    primaries and D65 white, chromatically adapted to D50 (Bradford)."""
    prim = np.stack([_xyz(p) for p in _PRIMARIES_XY], axis=1)
    white = _xyz(_D65_XY)
    m = prim * np.linalg.solve(prim, white)
    adapt = (np.linalg.inv(_BRADFORD) @ np.diag((_BRADFORD @ np.array(_D50))
                                                / (_BRADFORD @ white)) @ _BRADFORD)
    return adapt @ m


def _lab16_to_rgb16(words: np.ndarray) -> np.ndarray:
    """(N, 3) 16-bit Lab (v4 encoding) -> (N, 3) 16-bit sRGB through the
    pipeline's stages, each stage's output held in single precision."""
    f32 = np.float32
    v = (words.astype(f32) / f32(65535.0)).astype(np.float64)
    lum, a, b = v[:, 0] * 100.0, v[:, 1] * 255.0 - 128.0, v[:, 2] * 255.0 - 128.0
    fy = (lum + 16.0) / 116.0
    t = np.stack([fy + 0.002 * a, fy, fy - 0.005 * b], axis=-1)
    t = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)
    xyz = (t * np.array(_D50) / _XYZ_ENCODING).astype(f32).astype(np.float64)
    matrix = np.linalg.inv(_srgb_to_xyz_d50()) * _XYZ_ENCODING
    rgb = (xyz @ matrix.T).astype(f32).astype(np.float64)
    g, ca, cb, cc, cd = _SRGB_CURVE
    disc = (ca * cd + cb) ** g
    with np.errstate(invalid="ignore"):
        enc = np.where(rgb >= disc, (np.power(np.maximum(rgb, 0.0), 1.0 / g) - cb) / ca,
                       rgb / cc)
    enc = enc.astype(f32).astype(np.float64)
    return np.clip(np.floor(enc * 65535.0 + 0.5), 0, 65535).astype(np.int64)


@lru_cache(maxsize=1)
def grid_table() -> np.ndarray:
    """The sampled transform: GRID^3 nodes x 3 outputs, flat, x slowest."""
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), axis=-1).reshape(-1, 3)
    return _lab16_to_rgb16(nodes).reshape(-1).astype(np.int32)


@lru_cache(maxsize=1)
def _axes() -> tuple[np.ndarray, np.ndarray]:
    """Per byte of an axis (widened to x * 257): its node's offset in the
    grid along that axis and its 16-bit fraction, by _cmsToFixedDomain."""
    w = np.arange(256, dtype=np.int64) * 257 * (GRID - 1)
    f = w + (w + 0x7FFF) // 0xFFFF
    return (f >> 16).astype(np.int32), (f & 0xFFFF).astype(np.int32)


def _interp(px: np.ndarray, table: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of (N, 3) bytes (widened to x * 257) -> (N, 3)
    16-bit outputs."""
    cell, frac = _axes()
    ix, iy, iz = (cell[px[:, k]] for k in range(3))
    rx, ry, rz = (frac[px[:, k]] for k in range(3))
    base = ix * _OPTA[2] + iy * _OPTA[1] + iz * _OPTA[0]
    # a byte of 255 (input 0xFFFF) sits on the last node: no step along it
    sx, sy, sz = (np.where(px[:, k] == 255, 0, _OPTA[2 - k]).astype(np.int32)
                  for k in range(3))
    # the tetrahedron: the axes in order of their fractions, largest first
    # (at a tie either order gives the same sum)
    xy, yz, xz = rx >= ry, ry >= rz, rx >= rz
    first = np.where(xy & xz, sx, np.where(yz, sy, sz))
    last = np.where(yz & xz, sz, np.where(xy, sy, sx))
    r1 = np.maximum(np.maximum(rx, ry), rz)
    r3 = np.minimum(np.minimum(rx, ry), rz)
    r2 = rx + ry + rz - r1 - r3
    o1, o3 = first, sx + sy + sz
    o2 = o3 - last
    out = np.empty(px.shape, np.int32)
    for c in range(3):
        v0 = table[base + c]
        v1, v2, v3 = table[base + o1 + c], table[base + o2 + c], table[base + o3 + c]
        # int32 throughout, wrapping as littlecms's cmsS15Fixed16Number does
        rest = (v1 - v0) * r1 + (v2 - v1) * r2 + (v3 - v2) * r3 + np.int32(0x8001)
        out[:, c] = (v0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return out


def _transform(flat: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """(N, 3) u8 LAB -> (N, 3) u8 sRGB, in chunks."""
    table = grid_table()
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, flat.shape[0], chunk):
        px = flat[s:s + chunk].copy()
        px[:, 1:] ^= 128  # littlecms reads the a and b PIL holds, 128 added
        rgb16 = _interp(px, table).astype(np.int64)
        out[s:s + chunk] = (rgb16 * 65281 + 8388608) >> 24  # FROM_16_TO_8
    return out


@lru_cache(maxsize=1)
def every_value() -> np.ndarray:
    """(2^24, 4) u8: the transform of every LAB value (R, G, B and a 0),
    indexed L << 16 | a << 8 | b (64 MiB, a few seconds once per
    process)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    out = np.zeros((1 << 24, 4), np.uint8)
    out[:, :3] = _transform(lab)
    return out


# past this many pixels, one lookup in every_value() is cheaper than the
# interpolation: a 24 MP image costs about a third of the table's build
_TABLE_PIXELS = 1 << 23


def lab_to_srgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) u8 LAB as PIL's LAB images give it (a and b signed) ->
    (..., 3) u8 sRGB, as PIL's convert("RGB") gives it."""
    lab = np.asarray(lab, np.uint8)
    flat = lab.reshape(-1, 3)
    if flat.shape[0] < _TABLE_PIXELS and every_value.cache_info().currsize == 0:
        return _transform(flat).reshape(lab.shape)
    key = flat[:, 0].astype(np.uint32) << 16 | flat[:, 1].astype(np.uint32) << 8 | flat[:, 2]
    rows = every_value().view(np.uint32).reshape(-1)[key]  # a 4-byte row per value
    return np.ascontiguousarray(rows.view(np.uint8).reshape(-1, 4)[:, :3]).reshape(lab.shape)
