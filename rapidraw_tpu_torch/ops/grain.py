"""Film grain, hash noise and output dither (PyTorch).

Port of `rapidraw_tpu/ops/grain.py` (shader.wgsl:295-325, :1704-1717).
Grain and dither are pure functions of absolute pixel coordinates, so they
need no random generator and every device computes the same values.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops.common import fract, luma, mix, smoothstep


def hash2(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """fract-sin-free 2D hash (shader.wgsl:295-299)."""
    p3x = fract(px * 0.1031)
    p3y = fract(py * 0.1031)
    p3z = fract(px * 0.1031)
    d = p3x * (p3y + 33.33) + p3y * (p3z + 33.33) + p3z * (p3x + 33.33)
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return fract((p3x + p3y) * p3z)


def gradient_noise(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """2D Perlin-style gradient noise with quintic fade (shader.wgsl:301-320)."""
    ix, iy = torch.floor(px), torch.floor(py)
    fx, fy = px - ix, py - iy
    ux = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    uy = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)

    def grad_dot(ox, oy):
        gx = hash2(ix + ox, iy + oy) * 2.0 - 1.0
        gy = hash2(ix + ox + 11.0, iy + oy + 37.0) * 2.0 - 1.0
        return gx * (fx - ox) + gy * (fy - oy)

    d00 = grad_dot(0.0, 0.0)
    d10 = grad_dot(1.0, 0.0)
    d01 = grad_dot(0.0, 1.0)
    d11 = grad_dot(1.0, 1.0)
    bottom = mix(d00, d10, ux)
    top = mix(d01, d11, ux)
    return mix(bottom, top, uy)


def dither_from_coords(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Screen-space hash dither in [-0.5, 0.5) (the grain hash; see the JAX
    module for why it replaces the shader's sin hash)."""
    return hash2(xs, ys) - 0.5


def apply_grain(rgb: torch.Tensor, amount, size, roughness, scale: float, xs, ys) -> torch.Tensor:
    """Luma-masked gradient-noise grain (shader.wgsl:1704-1717).

    `scale` is the resolution scale min(W,H)/1080; xs/ys are absolute pixel
    coordinate maps.
    """
    amt = amount * 0.5
    freq = (1.0 / torch.clamp_min(size, 0.1)) / scale
    l = torch.clamp_min(luma(rgb), 0.0)
    luma_mask = smoothstep(0.0, 0.15, l) * (1.0 - smoothstep(0.6, 1.0, l))
    noise_base = gradient_noise(xs * freq, ys * freq)
    noise_rough = gradient_noise(xs * freq * 0.6 + 5.2, ys * freq * 0.6 + 1.3)
    noise_val = mix(noise_base, noise_rough, roughness)
    return rgb + noise_val * amt * luma_mask
