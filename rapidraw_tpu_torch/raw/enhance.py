"""RAW post-demosaic artifact suppression and gentle detail enhance.

Port of `rapidraw_tpu/raw/enhance.py` (remove_raw_artifacts_and_enhance,
image_processing.rs:2347-2551) as plain PyTorch on the image's device, op
for op:
  * chroma pass: a YCbCr bilateral over a sparse 3x3 grid of offsets
    {-5, -1, +3} with luma-difference range weights and a chroma-magnitude
    clamp that prevents colour bleed (:2370-2452); taps outside the image
    are skipped, not clamped;
  * luma pass: a 5x5 box-blur unsharp mask with an edge-adaptive gain and
    a clipping-safe rescale of the boost (:2461-2551).

Both passes have discontinuous gates (|detail| > 0.1, over & under,
need_clamp, ok), so a last-ulp difference upstream can move an output
value by a step; the tests count such values instead of widening a bound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.ops.common import sqrt_rn, true_div

_OFFSETS = (-5, -1, 3)
_OFFSET_SQ = {-5: 25.0, -1: 1.0, 3: 9.0}
_REACH = max(abs(o) for o in _OFFSETS)


def _rgb_to_ycc(rgb):
    r, g, b = rgb[0], rgb[1], rgb[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def _ycc_to_rgb(y, cb, cr):
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b])


def remove_raw_artifacts_and_enhance(
    image: torch.Tensor, color_nr_inv_sigma: float, sharpening_amount: float
) -> torch.Tensor:
    """image: planar (3, H, W) linear, about [0, 1]. Both passes optional."""
    y, cb, cr = _rgb_to_ycc(image)
    out = image
    h, w = y.shape

    if color_nr_inv_sigma > 0.0:
        # plane[y + dy, x + dx], zero outside: one zero-padded copy per
        # plane; vy is 1 where the tap lies inside the image (:2394-2410)
        pad = (_REACH, _REACH, _REACH, _REACH)
        yp, cbp, crp = (F.pad(p[None], pad)[0] for p in (y, cb, cr))
        rows = torch.arange(h, device=y.device)
        cols = torch.arange(w, device=y.device)

        def tap(p, dy, dx):
            return p[_REACH + dy : _REACH + dy + h, _REACH + dx : _REACH + dx + w]

        cb_sum = torch.zeros_like(cb)
        cr_sum = torch.zeros_like(cr)
        w_sum = torch.zeros_like(y)
        for ky in _OFFSETS:
            ky_term = _OFFSET_SQ[ky] * 0.02
            row_ok = ((rows + ky >= 0) & (rows + ky < h))[:, None]
            for kx in _OFFSETS:
                col_ok = ((cols + kx >= 0) & (cols + kx < w))[None, :]
                vy = (row_ok & col_ok).to(y.dtype)
                y_diff = torch.abs(y - tap(yp, ky, kx))
                val = y_diff * color_nr_inv_sigma
                spatial_penalty = _OFFSET_SQ[kx] * 0.02 + ky_term
                weight = vy / (1.0 + val * val + spatial_penalty)
                cb_sum = cb_sum + tap(cbp, ky, kx) * weight
                cr_sum = cr_sum + tap(crp, ky, kx) * weight
                w_sum = w_sum + weight
        del yp, cbp, crp

        inv_w = 1.0 / torch.clamp_min(w_sum, 1e-12)
        f_cb = cb_sum * inv_w
        f_cr = cr_sum * inv_w
        orig_mag_sq = cb * cb + cr * cr
        filt_mag_sq = f_cb * f_cb + f_cr * f_cr
        clamp_scale = sqrt_rn(
            orig_mag_sq / torch.where(filt_mag_sq > 0.0, filt_mag_sq, 1.0)
        )
        need_clamp = (filt_mag_sq > orig_mag_sq) & (orig_mag_sq > 1e-12)
        out_cb = torch.where(need_clamp, f_cb * clamp_scale, f_cb)
        out_cr = torch.where(need_clamp, f_cr * clamp_scale, f_cr)
        ok = w_sum > 1e-4
        out_cb = torch.where(ok, out_cb, cb)
        out_cr = torch.where(ok, out_cr, cr)
        out = torch.clamp(_ycc_to_rgb(y, out_cb, out_cr), 0.0, 1.0)

    if sharpening_amount > 0.0:
        out = _gentle_detail_enhance(out, y, sharpening_amount)
    return out


def _box_blur_1d(plane: torch.Tensor, axis: int, radius: int = 2) -> torch.Tensor:
    """Edge-clamped 1-D box mean (the USM blur, :2470-2504)."""
    pad = (0, 0, radius, radius) if axis == 0 else (radius, radius, 0, 0)
    p = F.pad(plane[None], pad, mode="replicate")[0]
    h, w = plane.shape
    acc = None
    for k in range(2 * radius + 1):
        v = p[k : k + h] if axis == 0 else p[:, k : k + w]
        acc = v.clone() if acc is None else acc.add_(v)
    return true_div(acc, 2 * radius + 1)


def _gentle_detail_enhance(rgb: torch.Tensor, luma_source: torch.Tensor,
                           amount: float) -> torch.Tensor:
    blurred = _box_blur_1d(_box_blur_1d(luma_source, 1), 0)
    detail = luma_source - blurred
    adaptive = torch.where(torch.abs(detail) > 0.1, amount * 0.3, amount)
    boost = detail * adaptive

    r, g, b = rgb[0], rgb[1], rgb[2]
    max_rgb = torch.maximum(torch.maximum(r, g), b)
    min_rgb = torch.minimum(torch.minimum(r, g), b)
    over = max_rgb + boost > 1.0
    under = min_rgb + boost < 0.0
    scale = torch.where(
        over & under,
        0.0,
        torch.where(
            over,
            (1.0 - max_rgb) / torch.clamp_min(boost, 0.001),
            torch.where(under, min_rgb / torch.clamp_min(-boost, 0.001), 1.0),
        ),
    )
    safe_boost = boost * torch.clamp(scale, 0.0, 1.0)
    return torch.clamp(rgb + safe_boost, 0.0, 1.0)
