"""Shared numeric helpers matching WGSL built-in semantics (PyTorch).

Port of `rapidraw_tpu/ops/common.py`. Images are PLANAR (3, H, W); params
are 0-d tensors, Python floats or (H, W) maps that broadcast.
"""

from __future__ import annotations

import torch

# Rec.709 luma coefficients (shader.wgsl:214).
LUMA_COEFF = (0.2126, 0.7152, 0.0722)


def as_t(v, ref: torch.Tensor) -> torch.Tensor:
    """`v` as a float32 tensor on `ref`'s device (the jnp.asarray analog)."""
    return torch.as_tensor(v, dtype=torch.float32, device=ref.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. PyTorch's vectorized CPU sqrt is off
    by an ulp on ~0.6% of inputs (NumPy, XLA and CUDA round correctly); a
    float32 value's sqrt taken in float64 rounds back exactly."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as a true float32 division on every device. PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal instead,
    which moves a coordinate by an ulp now and then; a divisor tensor on
    the same device divides. The divisor is filled on the device, so no
    host-to-device copy stalls the stream."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def coord_maps(h: int, w: int, device, offset=(0, 0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-coordinate maps (xs, ys), each (H, W) float32: arange in
    float32 plus the (x, y) `offset` of a tile's origin in its image, as JAX
    builds them (exact below 2^24)."""
    x_off, y_off = offset
    ys = (torch.arange(h, dtype=torch.float32, device=device) + float(y_off))[:, None].expand(h, w)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + float(x_off))[None, :].expand(h, w)
    return xs, ys


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """dot(c, LUMA_COEFF) (shader.wgsl:216-218). rgb: (3, ...) -> (...)."""
    return rgb[0] * LUMA_COEFF[0] + rgb[1] * LUMA_COEFF[1] + rgb[2] * LUMA_COEFF[2]


def mix(a, b, t):
    """WGSL mix: a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def smoothstep(e0, e1, x):
    """WGSL smoothstep with a step-function fallback when e0 == e1.

    Static (Python float) edges fold the divide into a host reciprocal,
    exactly as the JAX op does.
    """
    if isinstance(e0, (int, float)) and isinstance(e1, (int, float)):
        d = e1 - e0
        inv = 1.0 / d if d != 0.0 else 1e20
        t = torch.clamp((x - e0) * inv, 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)
    d = e1 - e0
    d = torch.where(d == 0.0, 1e-20, d)
    t = torch.clamp((x - e0) / d, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fract(x):
    return x - torch.floor(x)


def fpow(x, y):
    """pow for non-negative bases via exp2/log2 + one Newton refinement of
    the log (the JAX formula, kept so both sides compute the same thing)."""
    safe = torch.clamp_min(x, 1e-37)
    l = torch.log2(safe)
    e = torch.exp2(l)
    l = l + (safe - e) / (e * 0.6931471805599453)
    return torch.exp2(y * l)


def fpow_lt1(x, y):
    """fpow for exponents |y| <= 1: the raw exp2(y * log2(x)) identity."""
    safe = torch.clamp_min(x, 1e-37)
    return torch.exp2(y * torch.log2(safe))


def fpow_static(x, y: float):
    """fpow for a static exponent y >= 1: x^floor(y) by repeated
    multiplication times x^frac(y) via fpow_lt1."""
    if not (isinstance(y, (int, float)) and y >= 1.0):
        raise ValueError("fpow_static takes a static exponent >= 1")
    n = int(y)
    f = y - n
    acc = fpow_lt1(x, f) if f else None
    for _ in range(n):
        acc = x if acc is None else acc * x
    return acc


def wgsl_mod(x, y):
    """WGSL % on floats: truncation-based remainder (sign follows x)."""
    return torch.fmod(x, y)


def bcast3(v, rgb: torch.Tensor) -> torch.Tensor:
    """A 3-vector broadcast along the channel axis of rgb."""
    return as_t(v, rgb).reshape((3,) + (1,) * (rgb.ndim - 1))


def mat3_apply(m, rgb: torch.Tensor) -> torch.Tensor:
    """out = M @ rgb per pixel, as unrolled float32 products."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    return torch.stack(
        [
            m[0][0] * r + m[0][1] * g + m[0][2] * b,
            m[1][0] * r + m[1][1] * g + m[1][2] * b,
            m[2][0] * r + m[2][1] * g + m[2][2] * b,
        ]
    )
