"""Auto-adjust heuristics.

Port of the JAX package's `rapidraw_tpu/analysis/auto_adjust.py`: the
<=1024 px downscale runs with the port's `geometry/resize.downscale` on
the image's device, the rest in NumPy on the host as in JAX. It ports
perform_auto_analysis (image_processing.rs:3000-3262): percentile
luma statistics on a <=1024px preview, highlight/shadow/clipping percents,
mean saturation, center-vs-edge vignette detection, and a second pass that
re-histograms after the proposed exposure/contrast to derive blacks/whites/
brightness. Returns the adjustment-JSON fragment the reference emits
(auto_results_to_json, :3223-3244).
"""

from __future__ import annotations

import numpy as np
import torch

_LUMA = (0.2126, 0.7152, 0.0722)


def _round_half_up(x: np.ndarray) -> np.ndarray:
    """Rust's f32/f64 `.round()` rounds halves AWAY from zero; np.round
    rounds half-to-even. All inputs here are >= 0, so floor(x+0.5) matches
    the reference exactly on the .5 boundary bins."""
    return np.floor(x + 0.5)


def _percentile(hist: np.ndarray, total: float, p: float) -> int:
    target = int(total * p)
    c = np.cumsum(hist)
    idx = np.nonzero(c >= target)[0]
    return int(idx[0]) if idx.size else 255


def perform_auto_analysis(image) -> dict[str, float]:
    """image: planar (3, H, W) float [0,1] (or u8), a tensor on any
    device or a NumPy array. Returns raw results."""
    from rapidraw_tpu_torch.geometry.resize import downscale

    x = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image))
    # normalize dtype FIRST: downscale returns float32, and a u8 image
    # downscaled to 0-255 floats would saturate the [0,1] clip below. The
    # division runs in NumPy: CUDA divides by a scalar through its rounded
    # reciprocal
    if x.dtype == torch.uint8:
        x = torch.from_numpy(x.cpu().numpy().astype(np.float32) / 255.0).to(x.device)
    _, h, w = x.shape
    if max(h, w) > 1024:
        x = downscale(x.to(torch.float32), 1024, 1024)
    image = x.cpu().numpy()

    # reference runs on rgb8 via DynamicImage::to_rgb8 (image_processing.rs
    # :3051): the image crate's f32->u8 component conversion ROUNDS
    # ((x.clamp(0,1)*255).round()), unlike the scopes' Rgb32F branch which
    # truncates with `as usize` (:2581-2583) — so round here, truncate there
    px = np.clip(image.astype(np.float32), 0.0, 1.0) * 255.0
    px = _round_half_up(px).astype(np.uint8).astype(np.float32)

    _, h, w = px.shape
    total = float(h * w)
    r, g, b = px[0], px[1], px[2]
    luma_f = _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b
    luma_hist = np.bincount(
        np.minimum(_round_half_up(luma_f).astype(np.int64), 255).reshape(-1), minlength=256
    )[:256]

    rn, gn, bn = r / 255.0, g / 255.0, b / 255.0
    max_c = np.maximum(rn, np.maximum(gn, bn))
    min_c = np.minimum(rn, np.minimum(gn, bn))
    sat = np.where(max_c > 0.0, (max_c - min_c) / np.where(max_c > 0, max_c, 1.0), 0.0)
    mean_saturation = float(sat.sum() / total)

    cx0, cx1 = int(w * 0.25), int(w * 0.75)
    cy0, cy1 = int(h * 0.25), int(h * 0.75)
    luma_norm = luma_f / 255.0
    center_mask = np.zeros((h, w), bool)
    center_mask[cy0:cy1, cx0:cx1] = True
    center_n = int(center_mask.sum())
    edge_n = int(h * w - center_n)
    c_avg = float(luma_norm[center_mask].mean()) if center_n else 0.0
    e_avg = float(luma_norm[~center_mask].mean()) if edge_n else 0.0

    p50 = _percentile(luma_hist, total, 0.50)
    p99 = _percentile(luma_hist, total, 0.99)
    p1 = _percentile(luma_hist, total, 0.01)
    black_point, white_point = p1, p99
    rng = max(float(white_point - black_point), 1.0)

    highlight_percent = float(luma_hist[240:].sum()) / total
    clipped_percent = float(luma_hist[250:].sum()) / total

    exposure = (128.0 - p50) * 0.125
    if white_point > 245 or highlight_percent > 0.02 or clipped_percent > 0.005:
        exposure = min(exposure, 0.0)
    if white_point + exposure > 250.0:
        exposure = 250.0 - white_point

    contrast = 0.0
    if rng < 220.0:
        contrast = ((220.0 / rng) - 1.0) * 10.0
    if highlight_percent > 0.02:
        contrast *= 0.5

    shadow_percent = float(luma_hist[:32].sum()) / total
    shadows = min(shadow_percent * 40.0, 50.0) if shadow_percent > 0.05 else 0.0
    highlights = -min(highlight_percent * 120.0, 70.0) if highlight_percent > 0.02 else 0.0
    vibrancy = (0.2 - mean_saturation) * 120.0 if mean_saturation < 0.2 else 0.0
    dehaze = (1.0 - rng / 120.0) * 35.0 if (rng < 120.0 and mean_saturation < 0.15) else 0.0
    clarity = (1.0 - rng / 180.0) * 50.0 if rng < 180.0 else 0.0

    vignette_amount = 0.0
    centre = 0.0
    if center_n > 0 and edge_n > 0 and e_avg < c_avg:
        diff = c_avg - e_avg
        vignette_amount = -(diff * 100.0)
        if diff > 0.05:
            centre = min(diff * 100.0, 60.0)

    # second pass: simulate exposure+contrast and re-derive the endpoints.
    # NOTE the UNCLAMPED contrast here is reference-faithful: the reference
    # simulates with the raw value (image_processing.rs:3194) and clamps
    # only the emitted adjustment (:3208), so near-flat images derive their
    # blacks/whites from a steeper curve than will be applied.
    luma2 = _LUMA[0] * r.astype(np.float64) + _LUMA[1] * g.astype(np.float64) + _LUMA[2] * b.astype(np.float64)
    luma2 = luma2 + exposure
    luma2 = (luma2 - 128.0) * (1.0 + contrast / 100.0) + 128.0
    adj_hist = np.bincount(
        _round_half_up(np.clip(luma2, 0.0, 255.0)).astype(np.int64).reshape(-1), minlength=256
    )[:256]
    adj_p1 = _percentile(adj_hist, total, 0.01)
    adj_p50 = _percentile(adj_hist, total, 0.50)
    adj_p99 = _percentile(adj_hist, total, 0.99)
    blacks = -(adj_p1 * 0.5)
    whites = (adj_p99 - 255.0) * 0.2
    brightness = (128.0 - adj_p50) * 0.007

    clamp = lambda v, lo, hi: float(min(max(v, lo), hi))
    return {
        "exposure": clamp(exposure / 20.0, -5.0, 5.0),
        "brightness": clamp(brightness, -5.0, 5.0),
        "contrast": clamp(contrast, -100.0, 100.0),
        "highlights": clamp(highlights, -100.0, 100.0),
        "shadows": clamp(shadows, -100.0, 100.0),
        "vibrancy": clamp(vibrancy, -100.0, 100.0),
        "vignette_amount": clamp(vignette_amount, -100.0, 100.0),
        "temperature": 0.0,
        "tint": 0.0,
        "dehaze": clamp(dehaze, -100.0, 100.0),
        "clarity": clamp(clarity, -100.0, 100.0),
        "centre": clamp(centre, -100.0, 100.0),
        "whites": clamp(whites, -100.0, 100.0),
        "blacks": clamp(blacks, -100.0, 100.0),
    }


def auto_results_to_json(results: dict[str, float]) -> dict:
    """Adjustment-JSON fragment (image_processing.rs:3223-3244)."""
    return {
        "exposure": results["exposure"],
        "brightness": results["brightness"],
        "contrast": results["contrast"],
        "highlights": results["highlights"],
        "shadows": results["shadows"],
        "vibrance": results["vibrancy"],
        "vignetteAmount": results["vignette_amount"],
        "clarity": results["clarity"],
        "centré": results["centre"],
        "dehaze": results["dehaze"],
        "sectionVisibility": {"basic": True, "color": True, "effects": True},
        "whites": results["whites"],
        "blacks": results["blacks"],
    }


def calculate_auto_adjustments(image: np.ndarray) -> dict:
    return auto_results_to_json(perform_auto_analysis(image))
