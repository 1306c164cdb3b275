"""Straightening guides of the geometry preview (lib.rs:1031-1081).

Port of `_draw_straightening_guides` (rapidraw_tpu/pipeline/service.py:
535-571), which calls cv2; the card's machine has no cv2, so the port
computes the same overlay itself, bit for bit:
  * grey: cv2's fixed-point RGB2GRAY, (9798 R + 19235 G + 3735 B + 2^14)
    >> 15 (`rgb_to_gray`);
  * edges: cv2.Canny(gray, 50, 100), lines: cv2.HoughLines(edges, 1,
    pi/180, 0.24 * min dim), drawing: cv2.line(..., thickness 1), in C++
    (csrc/host/guides.cc, g++ at first use through `native.host_library`;
    the calls release the GIL);
  * the 15 px / 15 degree suppression of nearby detections and the colour
    rule (green within 0.5 degrees of 0/90, red otherwise), copied.
"""

from __future__ import annotations

import ctypes

import numpy as np

CANNY_LOW, CANNY_HIGH = 50, 100


def _lib():
    from rapidraw_tpu_torch.native import host_library

    lib = host_library("guides")
    if not getattr(lib, "_rr_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.guides_canny.restype = ctypes.c_int
        lib.guides_canny.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, u8p]
        lib.guides_hough.restype = ctypes.c_long
        lib.guides_hough.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.guides_line.restype = ctypes.c_int
        lib.guides_line.argtypes = [u8p, ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * 7
        lib._rr_typed = True
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 RGB -> (H, W) u8 as cv2.cvtColor(COLOR_RGB2GRAY)."""
    px = rgb.astype(np.uint32)
    return ((px[..., 0] * 9798 + px[..., 1] * 19235 + px[..., 2] * 3735 + (1 << 14))
            >> 15).astype(np.uint8)


def canny(gray: np.ndarray, low: int = CANNY_LOW, high: int = CANNY_HIGH) -> np.ndarray:
    """(H, W) u8 -> (H, W) u8 edge map (0 / 255), as cv2.Canny(gray, low,
    high) with aperture 3 and the L1 gradient."""
    g = np.ascontiguousarray(gray, np.uint8)
    h, w = g.shape
    out = np.empty((h, w), np.uint8)
    _lib().guides_canny(_u8p(g), h, w, int(low), int(high), _u8p(out))
    return out


def hough_lines(edges: np.ndarray, rho: float, theta: float, threshold: int) -> np.ndarray | None:
    """(N, 1, 2) float32 (rho, theta) as cv2.HoughLines(edges, rho, theta,
    threshold) returns them (strongest first), or None when it finds none."""
    e = np.ascontiguousarray(edges, np.uint8)
    h, w = e.shape
    lib = _lib()
    cap = 256
    while True:
        out = np.empty((cap, 2), np.float32)
        n = lib.guides_hough(_u8p(e), h, w, float(rho), float(theta), int(threshold),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
        if n <= cap:
            break
        cap = int(n)
    return out[:n, None, :].copy() if n else None


def draw_line(rgb: np.ndarray, p1: tuple[int, int], p2: tuple[int, int],
              color: tuple[int, int, int]) -> None:
    """cv2.line(rgb, p1, p2, color, 1) in place on (H, W, 3) u8 C-contiguous."""
    if not (rgb.flags.c_contiguous and rgb.dtype == np.uint8 and rgb.ndim == 3):
        raise ValueError("draw_line needs a C-contiguous (H, W, 3) uint8 image")
    h, w, _ = rgb.shape
    _lib().guides_line(_u8p(rgb), h, w, int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                       *(int(c) for c in color))


def draw_straightening_guides(planar: np.ndarray) -> np.ndarray:
    """Canny + Hough guide overlay (lib.rs:1031-1081): lines within 0.5 deg
    of 0/90 draw green, others red. Vote threshold = 0.24 * min dim; nearby
    detections suppressed like imageproc's suppression_radius=15. Planar
    (3, H, W) u8 (or float [0, 1]) in, planar u8 out."""
    if planar.dtype == np.uint8:
        rgb = planar.transpose(1, 2, 0)
    else:
        rgb = (np.clip(planar, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)
    gray = rgb_to_gray(rgb)
    edges = canny(gray, CANNY_LOW, CANNY_HIGH)
    h, w = gray.shape
    votes = max(int(min(h, w) * 0.24), 1)
    lines = hough_lines(edges, 1, np.pi / 180.0, votes)
    vis = np.array(rgb, order="C")  # a copy: the input is never drawn on
    kept: list[tuple[float, float]] = []
    if lines is not None:
        for line in lines[:, 0, :]:
            r, theta = float(line[0]), float(line[1])
            if any(abs(r - kr) < 15 and abs(theta - kt) < np.radians(15) for kr, kt in kept):
                continue
            kept.append((r, theta))
            angle_deg = np.degrees(theta) % 180.0
            aligned = (
                angle_deg < 0.5 or angle_deg > 179.5 or abs(angle_deg - 90.0) < 0.5
            )
            color = (0, 255, 0) if aligned else (255, 0, 0)
            a, b = np.cos(theta), np.sin(theta)
            x0, y0 = a * r, b * r
            dist = float(max(h, w) * 2)
            p1 = (int(x0 + dist * -b), int(y0 + dist * a))
            p2 = (int(x0 - dist * -b), int(y0 - dist * a))
            draw_line(vis, p1, p2, color)
    # planar u8 out: encode_jpeg_bytes passes u8 through untouched, so the
    # overlay costs no float round-trip on the interactive geometry path
    return np.ascontiguousarray(vis.transpose(2, 0, 1))
