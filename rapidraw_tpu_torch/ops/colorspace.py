"""Transfer functions and RGB<->HSV conversion (planar (3, ...) layout).

Port of `rapidraw_tpu/ops/colorspace.py` (shader.wgsl:220-286).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops.common import fpow_lt1, fpow_static


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """shader.wgsl:220-226. Elementwise on any shape."""
    higher = fpow_static(torch.abs(c + 0.055) / 1.055, 2.4)
    lower = c / 12.92
    return torch.where(c <= 0.04045, lower, higher)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """shader.wgsl:228-235 — clamps input to [0,1] first."""
    c = torch.clamp(c, 0.0, 1.0)
    higher = 1.055 * fpow_lt1(c, 1.0 / 2.4) - 0.055
    lower = c * 12.92
    return torch.where(c <= 0.0031308, lower, higher)


def linear_to_srgb_extended(c: torch.Tensor) -> torch.Tensor:
    """shader.wgsl:237-244 — no upper clamp."""
    c = torch.clamp_min(c, 0.0)
    higher = 1.055 * fpow_lt1(c, 1.0 / 2.4) - 0.055
    lower = c * 12.92
    return torch.where(c <= 0.0031308, lower, higher)


def rgb_to_hsv(rgb: torch.Tensor):
    """shader.wgsl:246-259. rgb (3, ...) -> (h_degrees, s, v) each (...)."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    c_max = torch.maximum(r, torch.maximum(g, b))
    c_min = torch.minimum(r, torch.minimum(g, b))
    delta = c_max - c_min
    safe_delta = torch.where(delta > 0.0, delta, 1.0)
    inv_delta = 1.0 / safe_delta
    h_r = 60.0 * ((g - b) * inv_delta)
    h_g = 60.0 * ((b - r) * inv_delta + 2.0)
    h_b = 60.0 * ((r - g) * inv_delta + 4.0)
    h = torch.where(c_max == r, h_r, torch.where(c_max == g, h_g, h_b))
    h = torch.where(delta > 0.0, h, 0.0)
    h = torch.where(h < 0.0, h + 360.0, h)
    s = torch.where(c_max > 0.0, delta / torch.where(c_max > 0.0, c_max, 1.0), 0.0)
    return h, s, c_max


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    """shader.wgsl:261-274. h in degrees; returns (3, ...)."""
    r, g, b = hsv_to_rgb_channels(h, s, v)
    return torch.stack([r, g, b])


def hsv_to_rgb_channels(h, s, v):
    """hsv_to_rgb as a (r, g, b) tuple (also for 0-d inputs)."""
    c = v * s
    u = h * (1.0 / 60.0)
    x = c * (1.0 - torch.abs(u - 2.0 * torch.floor(u * 0.5) - 1.0))
    z = torch.zeros_like(c)
    conds_trips = [
        ((h < 60.0), (c, x, z)),
        ((h >= 60.0) & (h < 120.0), (x, c, z)),
        ((h >= 120.0) & (h < 180.0), (z, c, x)),
        ((h >= 180.0) & (h < 240.0), (z, x, c)),
        ((h >= 240.0) & (h < 300.0), (x, z, c)),
    ]
    rp, gp, bp = c, z, x  # default: h >= 300
    for cond, (tr, tg, tb) in reversed(conds_trips):
        rp = torch.where(cond, tr, rp)
        gp = torch.where(cond, tg, gp)
        bp = torch.where(cond, tb, bp)
    m = v - c
    return rp + m, gp + m, bp + m
