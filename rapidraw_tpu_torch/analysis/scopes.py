"""Histogram, waveform, RGB parade and vectorscope.

A copy of the JAX package's `rapidraw_tpu/analysis/scopes.py` (NumPy on
the host, which ports image_processing.rs:2553-2998); a torch tensor is
read back first. Operates on the rendered output
image. Integer math (the >>10 luma, u8 binning, log LUT) matches the
reference exactly; histograms sample every other pixel (:2580) and are
Gaussian-smoothed (sigma 2) then normalized to the 99th percentile.
"""

from __future__ import annotations

import numpy as np
import torch

SCOPE_W = 256
SCOPE_H = 256


def _as_u8_pixels(image: np.ndarray) -> np.ndarray:
    """Planar (3, H, W) float [0,1] or u8 -> (H, W, 3) u8 (truncating cast,
    like the reference's `as u8` on clamped*255)."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    if image.dtype == np.uint8:
        return image.transpose(1, 2, 0)
    x = np.clip(image, 0.0, 1.0) * 255.0
    return x.astype(np.uint8).transpose(1, 2, 0)


def _int_luma(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r*218 + g*732 + b*74) >> 10, capped at 255 (:2589-2590)."""
    l = (r.astype(np.uint32) * 218 + g.astype(np.uint32) * 732 + b.astype(np.uint32) * 74) >> 10
    return np.minimum(l, 255)


def _gaussian_smooth(hist: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Clamped-edge 1-D Gaussian smoothing (:2643-2684)."""
    radius = int(np.ceil(sigma * 3.0))
    if radius == 0 or radius >= hist.size:
        return hist
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k /= k.sum()
    idx = np.clip(np.arange(hist.size)[:, None] + np.arange(-radius, radius + 1)[None, :], 0, hist.size - 1)
    return (hist[idx] * k[None, :]).sum(axis=1).astype(np.float32)


def _normalize_range(hist: np.ndarray, percentile_clip: float = 0.99) -> np.ndarray:
    """Normalize to the percentile-clipped max, capping at 1 (:2686-2707)."""
    s = np.sort(hist)
    # f32 .round() (half away from zero), like the reference's clip_index
    clip_index = int(np.floor(np.float32(s.size - 1) * np.float32(percentile_clip) + 0.5))
    max_val = s[min(clip_index, s.size - 1)]
    if max_val > 1e-6:
        return np.minimum(hist / max_val, 1.0).astype(np.float32)
    return np.zeros_like(hist)


def calculate_histogram(image: np.ndarray) -> dict[str, np.ndarray]:
    """256-bin RGB + luma histograms of planar (3, H, W) (:2561-2641).

    Samples every other pixel in flattened order, smooths, normalizes.
    """
    px = _as_u8_pixels(image).reshape(-1, 3)[::2]
    r, g, b = px[:, 0], px[:, 1], px[:, 2]
    l = _int_luma(r, g, b)
    out = {}
    for name, v in (("red", r), ("green", g), ("blue", b), ("luma", l)):
        h = np.bincount(v.astype(np.int64), minlength=256)[:256].astype(np.float32)
        out[name] = _normalize_range(_gaussian_smooth(h))
    return out


def _log_lut_apply(bins: np.ndarray) -> np.ndarray:
    """Log-scaled brightness LUT (:2834-2853): v -> ln(1+v)*255/ln(1+max)."""
    max_val = bins.max()
    if max_val == 0:
        return np.zeros_like(bins, np.uint8)
    scale = 255.0 / np.log(1.0 + np.float32(max_val))
    out = (np.log1p(bins.astype(np.float32)) * scale).astype(np.uint8)
    out[bins == 0] = 0
    return out


def calculate_waveform(image: np.ndarray, active_channel: str | None = None) -> dict:
    """Waveform / parade / vectorscope bins + RGBA renders (:2720-2998).

    Returns dict with 'rgb', 'luma', 'parade', 'vectorscope' as
    (256, 256, 4) u8 RGBA arrays (empty key -> None), plus 'width'/'height'.
    """
    do_rgb = active_channel in (None, "rgb")
    do_luma = active_channel in (None, "luma", "rgb")
    do_parade = active_channel in (None, "parade")
    do_vector = active_channel in (None, "vectorscope")

    px = _as_u8_pixels(image)
    h, w, _ = px.shape
    r = px[..., 0].astype(np.int64)
    g = px[..., 1].astype(np.int64)
    b = px[..., 2].astype(np.int64)

    xs = np.arange(w)
    # f32 bucket math, exactly like the reference (:2750-2757): x_scale is
    # an f32 ratio and the product truncates; f64 here can flip a boundary
    # column into the neighboring bucket on large widths
    x_scale = np.float32(SCOPE_W) / np.float32(w)
    x_bucket = np.minimum(
        (xs.astype(np.float32) * x_scale).astype(np.int64), SCOPE_W - 1
    )
    xb = np.broadcast_to(x_bucket, (h, w))

    W = SCOPE_W

    def bins2d(row_idx, col_idx):
        flat = row_idx.reshape(-1) * W + col_idx.reshape(-1)
        return np.bincount(flat, minlength=W * SCOPE_H)[: W * SCOPE_H].reshape(SCOPE_H, W)

    out: dict = {"width": SCOPE_W, "height": SCOPE_H}

    if do_rgb:
        rb = bins2d(255 - r, xb)
        gb = bins2d(255 - g, xb)
        bb = bins2d(255 - b, xb)
        lr, lg, lb = _log_lut_apply(rb), _log_lut_apply(gb), _log_lut_apply(bb)
        rgba = np.zeros((SCOPE_H, W, 4), np.uint8)
        rgba[..., 0], rgba[..., 1], rgba[..., 2] = lr, lg, lb
        rgba[..., 3] = np.maximum(np.maximum(lr, lg), lb)
        out["rgb"] = rgba
    else:
        out["rgb"] = None

    if do_luma:
        l = _int_luma(r, g, b)
        lbins = bins2d(255 - l, xb)
        ll = _log_lut_apply(lbins)
        rgba = np.zeros((SCOPE_H, W, 4), np.uint8)
        on = lbins > 0
        rgba[..., 0][on] = 255
        rgba[..., 1][on] = 255
        rgba[..., 2][on] = 255
        rgba[..., 3] = np.where(on, ll, 0)
        out["luma"] = rgba
    else:
        out["luma"] = None

    if do_parade:
        rel = (
            (xs.astype(np.float32) / np.float32(w)) * np.float32(82.0)
        ).astype(np.int64) % 82
        pr = np.broadcast_to(rel, (h, w))
        pg = np.broadcast_to(87 + rel, (h, w))
        pb = np.broadcast_to(174 + rel, (h, w))
        pbins = bins2d(255 - r, pr) + bins2d(255 - g, pg) + bins2d(255 - b, pb)
        lp = _log_lut_apply(pbins)
        rgba = np.zeros((SCOPE_H, W, 4), np.uint8)
        on = pbins > 0
        col = np.arange(W)[None, :]
        red_cols = col < 82
        green_cols = (col >= 87) & (col < 169)
        blue_cols = col >= 174
        rgba[..., 0] = np.where(on & red_cols, 255, 0)
        rgba[..., 1] = np.where(on & green_cols, 255, 0)
        rgba[..., 2] = np.where(on & blue_cols, 255, 0)
        rgba[..., 3] = np.where(on & (red_cols | green_cols | blue_cols), lp, 0)
        out["parade"] = rgba
    else:
        out["parade"] = None

    if do_vector:
        rf, gf, bf = (v.astype(np.float32) for v in (r, g, b))
        cb = (-0.1146 * rf - 0.3854 * gf + 0.5 * bf) * 0.836
        cr = (0.5 * rf - 0.4542 * gf - 0.0458 * bf) * 0.836
        dist_sq = cb * cb + cr * cr
        over = dist_sq > 16129.0
        scale = np.where(over, 127.0 / np.sqrt(np.maximum(dist_sq, 1e-9)), 1.0)
        cb *= scale
        cr *= scale
        vx = np.clip(cb + 128.0, 0.0, 255.0).astype(np.int64)
        vy = np.clip(128.0 - cr, 0.0, 255.0).astype(np.int64)
        vbins = bins2d(vy, vx)
        lv = _log_lut_apply(vbins)

        rgba = np.zeros((SCOPE_H, W, 4), np.uint8)
        ygrid, xgrid = np.mgrid[0:SCOPE_H, 0:W].astype(np.float32)
        dx = xgrid - 128.0
        dy = 128.0 - ygrid
        min_d = np.minimum(np.abs(dx), np.abs(dy))
        dist = np.sqrt(dx * dx + dy * dy)
        on = vbins > 0
        # chroma color of occupied cells (:2948-2953)
        rr = np.clip(128.0 + 1.402 * (dy / 0.836), 0.0, 255.0).astype(np.uint8)
        gg = np.clip(128.0 - 0.344136 * (dx / 0.836) - 0.714136 * (dy / 0.836), 0.0, 255.0).astype(np.uint8)
        bb2 = np.clip(128.0 + 1.772 * (dx / 0.836), 0.0, 255.0).astype(np.uint8)
        rgba[..., 0] = np.where(on, rr, 0)
        rgba[..., 1] = np.where(on, gg, 0)
        rgba[..., 2] = np.where(on, bb2, 0)
        rgba[..., 3] = np.where(on, lv, 0)
        # graticule: axes cross, 75%/skin lines, rings (:2954-2970)
        axes = (~on) & (min_d <= 1.0)
        alpha_axes = np.clip(40.0 - min_d * 30.0, 0.0, 255.0).astype(np.uint8)
        rings = (~on) & ~axes & ((np.abs(dist - 127.0) < 0.8) | (np.abs(dist - 64.0) < 0.8))
        skin = (~on) & ~axes & ~rings & (dx < 0.0) & (dy > 0.0) & (np.abs(dy + 1.53 * dx) < 1.0)
        for mask_, rgbv, a in ((axes, (255, 255, 255), None), (rings, (255, 255, 255), 15), (skin, (255, 200, 150), 120)):
            rgba[..., 0][mask_] = rgbv[0]
            rgba[..., 1][mask_] = rgbv[1]
            rgba[..., 2][mask_] = rgbv[2]
            rgba[..., 3][mask_] = alpha_axes[mask_] if a is None else a
        out["vectorscope"] = rgba
    else:
        out["vectorscope"] = None

    return out
