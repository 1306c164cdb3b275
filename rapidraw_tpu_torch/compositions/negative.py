"""Film negative -> positive conversion.

Port of `rapidraw_tpu/compositions/negative.py` (negative_conversion.rs):
per-channel -log10 density (:116-119), percentile bounds from the centre
76% of a <=1080px reference (:49-105, NumPy on the host), normalized
sigmoid tone curve with exposure/contrast (:129-155), channel weights,
highlight desaturation rolloff (:161-171), gamma 1/2.2 output (:173-175).
The per-pixel part runs as torch on the image's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NegativeConversionParams:
    red_weight: float = 1.0
    green_weight: float = 1.0
    blue_weight: float = 1.0
    exposure: float = 0.0
    contrast: float = 1.0


def analyze_bounds(log_rgb: np.ndarray) -> np.ndarray:
    """Density bounds per channel (negative_conversion.rs:49-105).

    log_rgb: planar (3, H, W) of -log10 densities (host numpy).
    Returns (3, 2) [min, max]. Sampling: skip a 12% margin, every 3rd row,
    column stride targeting ~40k samples; 0.1%/99.9% percentiles.
    """
    _, h, w = log_rgb.shape
    mx = int(w * 0.12)
    my = int(h * 0.12)
    est = max((w - mx * 2), 0) * max((h - my * 2), 0)
    step = max(est // 40_000, 1)
    out = np.zeros((3, 2), np.float32)
    for c in range(3):
        vals = log_rgb[c, my : h - my : 3, mx : w - mx : step].reshape(-1)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            out[c] = (0.0, 1.0)
            continue
        vals = np.sort(vals)
        n = float(vals.size)
        mn = vals[min(int(n * 0.001), vals.size - 1)]
        mxv = vals[min(int(n * 0.999), vals.size - 1)]
        if mxv <= mn + 0.0001:
            mxv = mn + 1.0
        out[c] = (mn, mxv)
    return out


_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


def _neg_log10(image: torch.Tensor) -> torch.Tensor:
    """-log10 of the clipped image as XLA computes it, log(x) * f32(1 /
    ln 10), the log taken in float64 and rounded once."""
    x = torch.clamp(image, 1e-6, 1.0).to(torch.float64)
    return -(torch.log(x).to(torch.float32) * _INV_LN10)


def run_pipeline(image: torch.Tensor,
                 params: NegativeConversionParams = NegativeConversionParams(),
                 bounds: np.ndarray | None = None) -> torch.Tensor:
    """Convert planar (3, H, W) [0,1] negative to positive (rs:107-180)."""
    log_px = _neg_log10(image)
    if bounds is None:
        bounds = analyze_bounds(log_px.cpu().numpy())
    b = np.asarray(bounds, np.float32)

    k = 4.0 * max(params.contrast, 0.1)
    x0 = 0.6 - params.exposure * 0.25
    y0 = float(1.0 / (1.0 + np.exp(k * x0)))
    y1 = float(1.0 / (1.0 + np.exp(-k * (1.0 - x0))))
    scale = 1.0 / (y1 - y0)

    dev = image.device
    mins = torch.from_numpy(b[:, 0].copy()).to(dev).reshape(3, 1, 1)
    ranges = torch.from_numpy(b[:, 1] - b[:, 0]).to(dev).reshape(3, 1, 1)
    weights = torch.tensor([params.red_weight, params.green_weight, params.blue_weight],
                           dtype=torch.float32, device=dev).reshape(3, 1, 1)
    n = torch.clamp_min((log_px - mins) / ranges, 0.0) * weights

    sigmoid = 1.0 / (1.0 + torch.exp(-k * (n - x0)))
    curved = torch.clamp((sigmoid - y0) * scale, 0.0, 1.0)

    r, g, bl = curved[0], curved[1], curved[2]
    luma = 0.2126 * r + 0.7152 * g + 0.0722 * bl
    max_ch = torch.amax(curved, dim=0)
    overflow = torch.clamp((max_ch - 0.9) * 10.0, 0.0, 1.0)
    sat_reduction = torch.where(max_ch > 0.9, overflow * overflow, 0.0)
    desat = curved + (luma - curved) * sat_reduction
    return torch.pow(torch.clamp(desat, 0.0, 1.0), 1.0 / 2.2)


def convert_negative(image: torch.Tensor,
                     params: NegativeConversionParams = NegativeConversionParams()
                     ) -> torch.Tensor:
    """Batch-path conversion: bounds from a <=1080px area-downscaled
    reference (negative_conversion.rs:316-326), applied to the full image."""
    from rapidraw_tpu_torch.geometry.resize import downscale

    ref = downscale(image, 1080, 1080)
    bounds = analyze_bounds(_neg_log10(ref).cpu().numpy())
    return run_pipeline(image, params, bounds)
