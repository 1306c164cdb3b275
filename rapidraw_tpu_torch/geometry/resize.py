"""Image resizing: the energy-preserving area downscale and the Lanczos3
resample of the export.

`downscale` and `downscale_to_long_edge` port `rapidraw_tpu/geometry/
resize.py` (downscale_f32_image, image_processing.rs:197-354): area
weights on SQUARED pixel values with a square root at the end, aspect kept
via ratio = min(nw/W, nh/H) and rounded output sizes. The separable weight
tables are built on the host exactly like the reference's loops; the two
products run in plain PyTorch on the image's device, in float64.

`lanczos_resize` is the export's output resize (export_processing.rs:
194-211), which the JAX package runs through PIL's 'F'-mode
`resize(..., LANCZOS)`: PIL's coefficients (precompute_coeffs: support
3 * max(scale, 1), centre (i + 0.5) * scale, weights normalized, in float64)
and its two passes, horizontal then vertical, each summed tap by tap in
float64 and stored as float32. `lanczos_resize_u8` is PIL's 8-bit
LANCZOS on modes "L", "RGB" and "RGBA" (the watermark and the mask alpha
PNGs of the export, the AI patches' colour and mask images): the same
coefficients as integers at 22 fraction bits, the
intermediate clipped to 8 bits, RGBA resampled premultiplied.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) normalized overlap weights (image_processing.rs:226-299)."""
    ratio = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for i_out in range(n_out):
        start = i_out * ratio
        end = (i_out + 1) * ratio
        i0 = int(np.floor(start))
        i1 = min(int(np.ceil(end)), n_in)
        total = 0.0
        for i_in in range(i0, i1):
            ov = max(min(end, i_in + 1) - max(start, i_in), 0.0)
            if ov > 0:
                w[i_out, i_in] = ov
                total += ov
        if total > 0:
            w[i_out] /= total
    return w


def downscale(image: torch.Tensor, nwidth: int, nheight: int) -> torch.Tensor:
    """Downscale planar (3, H, W) to fit (nwidth, nheight), keeping aspect."""
    _, h, w = image.shape
    if nwidth <= 0 or nheight <= 0 or (nwidth >= w and nheight >= h):
        return image
    ratio = min(nwidth / w, nheight / h)
    new_w = int(round(w * ratio))
    new_h = int(round(h * ratio))
    if new_w == 0 or new_h == 0:
        return image
    dev = image.device
    wy = torch.from_numpy(_area_weights(h, new_h)).to(dev, torch.float64)
    wx = torch.from_numpy(_area_weights(w, new_w)).to(dev, torch.float64)
    sq = torch.square(torch.clamp(image, min=0.0)).to(torch.float64)
    out = torch.matmul(torch.matmul(wy, sq), wx.T).to(torch.float32)
    return torch.sqrt(torch.clamp(out, min=0.0))


def downscale_to_long_edge(image: torch.Tensor, long_edge: int) -> torch.Tensor:
    """Fit the longest side to `long_edge` (preview/thumbnail sizing)."""
    _, h, w = image.shape
    if max(h, w) <= long_edge:
        return image
    if w >= h:
        return downscale(image, long_edge, max(1, int(round(h * long_edge / w))))
    return downscale(image, max(1, int(round(w * long_edge / h))), long_edge)


def _lanczos3(x: float) -> float:
    """PIL's lanczos_filter: sinc(x) * sinc(x / 3) on [-3, 3)."""
    if -3.0 <= x < 3.0:
        a = 1.0 if x == 0.0 else math.sin(x * math.pi) / (x * math.pi)
        y = x / 3
        b = 1.0 if y == 0.0 else math.sin(y * math.pi) / (y * math.pi)
        return a * b
    return 0.0


@functools.lru_cache(maxsize=16)
def lanczos_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs over the whole input: (first input index
    (out_size,) int64, weights (out_size, ksize) float64, zero past each
    output's taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos3((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        kk[xx, :xmax] = k
        first[xx] = xmin
    return first, kk


def _resample_last(x: torch.Tensor, out_size: int, rows: int = 256) -> torch.Tensor:
    """One PIL pass along the last axis of (C, R, N) float32: float64 sums
    tap by tap in PIL's order, stored as float32."""
    c, r, n = x.shape
    first, kk = lanczos_coeffs(n, out_size)
    ksize = kk.shape[1]
    idx = torch.from_numpy(np.minimum(first[:, None] + np.arange(ksize), n - 1)).to(x.device)
    k = torch.from_numpy(kk).to(x.device)
    out = torch.empty((c, r, out_size), dtype=torch.float32, device=x.device)
    for r0 in range(0, r, rows):
        src = x[:, r0:r0 + rows].to(torch.float64)
        acc = torch.zeros((c, src.shape[1], out_size), dtype=torch.float64, device=x.device)
        for t in range(ksize):
            acc += src[..., idx[:, t]] * k[:, t]
        out[:, r0:r0 + rows] = acc.to(torch.float32)
    return out


def lanczos_resize(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Planar (C, H, W) float32 -> (C, height, width), as PIL's 'F'-mode
    resize((width, height), LANCZOS) of each channel (no clamp)."""
    _, h, w = image.shape
    out = image.to(torch.float32)
    if width != w:
        out = _resample_last(out, width)
    if height != h:
        out = _resample_last(out.transpose(1, 2), height).transpose(1, 2)
    return out.contiguous()


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


@functools.lru_cache(maxsize=16)
def _coeffs_8bpc(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's normalize_coeffs_8bpc of `lanczos_coeffs`: (tap index (out,
    ksize) clamped into the input, int64 weights at 22 fraction bits,
    rounded half away from zero)."""
    first, kk = lanczos_coeffs(in_size, out_size)
    scaled = kk * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(kk < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    return idx, k


def _resample_u8_last(x: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit PIL pass (ImagingResampleHorizontal_8bpc) along the last
    axis of (..., N) uint8: integer taps summed from a half, shifted down
    by 22 bits and clipped to [0, 255]."""
    idx, k = _coeffs_8bpc(x.shape[-1], out_size)
    acc = np.full(x.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        acc += x[..., idx[:, t]].astype(np.int64) * k[:, t]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_planes_u8(planes: np.ndarray, width: int, height: int) -> np.ndarray:
    """(C, H, W) uint8 -> (C, height, width): the horizontal pass, then the
    vertical one on the clipped 8-bit intermediate; a pass whose size does
    not change is skipped, as PIL skips it."""
    out = planes
    if width != out.shape[2]:
        out = _resample_u8_last(out, width)
    if height != out.shape[1]:
        out = _resample_u8_last(out.transpose(0, 2, 1), height).transpose(0, 2, 1)
    return np.ascontiguousarray(out)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.uint32) * b + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def lanczos_resize_u8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.resize((width, height), Image.LANCZOS)` of an 8-bit
    image: (H, W) mode "L", (H, W, 3) mode "RGB" (band by band, as PIL
    resamples its 4-byte RGBX pixels) or (H, W, 4) mode "RGBA". RGBA resamples as
    premultiplied "RGBa" (PIL's rgbA2rgba, a * c / 255 rounded with its
    MULDIV255) and converts back with rgba2rgbA (255 * c // a clipped,
    colour kept where a is 0 or 255). The same size returns a copy."""
    if image.shape[:2] == (height, width):
        return image.copy()
    if image.ndim == 2:
        return _resize_planes_u8(image[None], width, height)[0]
    if image.shape[2] == 3:
        return np.ascontiguousarray(
            _resize_planes_u8(image.transpose(2, 0, 1), width, height).transpose(1, 2, 0))
    a = image[..., 3]
    premul = np.concatenate([_muldiv255(image[..., :3], a[..., None]), a[..., None]], axis=-1)
    out = _resize_planes_u8(premul.transpose(2, 0, 1), width, height).transpose(1, 2, 0)
    rgb, alpha = out[..., :3].astype(np.int32), out[..., 3:4].astype(np.int32)
    straight = np.minimum(255 * rgb // np.maximum(alpha, 1), 255)
    rgb = np.where((alpha == 0) | (alpha == 255), rgb, straight)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
