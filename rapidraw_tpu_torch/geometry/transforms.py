"""Orientation steps, flips, fine rotation, crop, and the composed
transform pipeline (adjustment_utils.rs:93-120, image_processing.rs:1063-1144).

Port of `rapidraw_tpu/geometry/transforms.py`. Functions take and return
planar (..., 3, H, W) tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidraw_tpu_torch.geometry.params import geometry_params_from_json, is_geometry_identity
from rapidraw_tpu_torch.geometry.warp import warp_image_geometry
from rapidraw_tpu_torch.geometry.warp_fast import warp_image_fast


def apply_coarse_rotation(image: torch.Tensor, steps: int) -> torch.Tensor:
    """90-degree steps clockwise (image_processing.rs:1063-1074). steps: 0..3."""
    steps = int(steps) % 4
    if steps == 0:
        return image
    return torch.rot90(image, k=-steps, dims=(-2, -1))


def apply_flip(image: torch.Tensor, horizontal: bool, vertical: bool) -> torch.Tensor:
    if horizontal:
        image = torch.flip(image, dims=(-1,))
    if vertical:
        image = torch.flip(image, dims=(-2,))
    return image


def apply_rotation(image: torch.Tensor, degrees: float) -> torch.Tensor:
    """Fine rotation about the centre, bilinear, same-size canvas, black
    fill (imageproc rotate_about_center; image_processing.rs:1076-1094)."""
    if float(degrees) % 360.0 == 0.0:
        return image
    h, w = image.shape[-2:]
    theta = np.deg2rad(degrees)
    c, s = float(np.cos(theta)), float(np.sin(theta))
    cx, cy = w / 2.0, h / 2.0
    dev = image.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) - cx
    # inverse rotation of output coords into source space
    src_x = cx + xs * c + ys * s
    src_y = cy - xs * s + ys * c
    valid = (src_x >= 0) & (src_y >= 0) & (src_x <= w - 1) & (src_y <= h - 1)
    xs0 = torch.clamp(torch.floor(src_x), 0, w - 2).to(torch.int64)
    ys0 = torch.clamp(torch.floor(src_y), 0, h - 2).to(torch.int64)
    wx = torch.clamp(src_x, 0, w - 1) - xs0
    wy = torch.clamp(src_y, 0, h - 1) - ys0
    flat = image.reshape(*image.shape[:-2], h * w)

    def g(yy, xx):
        return flat[..., (yy * w + xx).reshape(-1)].reshape(*image.shape[:-2], h, w)

    top = g(ys0, xs0) * (1 - wx) + g(ys0, xs0 + 1) * wx
    bot = g(ys0 + 1, xs0) * (1 - wx) + g(ys0 + 1, xs0 + 1) * wx
    return torch.where(valid, top * (1 - wy) + bot * wy, 0.0)


def apply_crop(image: torch.Tensor, crop: dict | None) -> torch.Tensor:
    """Crop rect in current-image pixels (image_processing.rs:1096-1124)."""
    if not isinstance(crop, dict):
        return image
    img_h, img_w = image.shape[-2:]
    x = int(round(float(crop.get("x", 0))))
    y = int(round(float(crop.get("y", 0))))
    cw = int(round(float(crop.get("width", 0))))
    ch = int(round(float(crop.get("height", 0))))
    if cw <= 0 or ch <= 0 or x >= img_w or y >= img_h or x < 0 or y < 0:
        return image
    nw = min(img_w - x, cw)
    nh = min(img_h - y, ch)
    if nw <= 0 or nh <= 0:
        return image
    if x == 0 and y == 0 and nw == img_w and nh == img_h:
        return image
    return image[..., y : y + nh, x : x + nw]


def apply_all_transformations(
    image: torch.Tensor, adjustments: dict, patch_scale: float = 1.0
) -> tuple[torch.Tensor, tuple[float, float]]:
    """AI patches -> warp -> coarse rotate -> flip -> fine rotate -> crop
    (lib.rs:198-217 + adjustment_utils.rs:93-120). Returns (image,
    unscaled crop offset). patch_scale: image resolution relative to
    full-res subMask coordinates (downscaled-preview callers). A CUDA image
    takes the planned two-pass warp (exact path where the planner refuses
    the map), a CPU image the exact path, as the JAX package routes TPU
    and CPU."""
    if adjustments.get("aiPatches"):
        from rapidraw_tpu_torch.masks.patches import composite_patches_on_image

        image = composite_patches_on_image(image, adjustments, scale=patch_scale)
    p = geometry_params_from_json(adjustments)
    if not is_geometry_identity(p):
        if image.device.type == "cuda":
            image = warp_image_fast(image, p)
        else:
            image = warp_image_geometry(image, p)

    image = apply_coarse_rotation(image, int(adjustments.get("orientationSteps", 0) or 0))
    image = apply_flip(
        image,
        bool(adjustments.get("flipHorizontal", False)),
        bool(adjustments.get("flipVertical", False)),
    )
    image = apply_rotation(image, float(adjustments.get("rotation", 0.0) or 0.0))

    crop = adjustments.get("crop")
    pre_shape = image.shape
    image = apply_crop(image, crop if isinstance(crop, dict) else None)
    offset = (0.0, 0.0)
    # a rejected or identity crop must not report a phantom offset
    if isinstance(crop, dict) and image.shape != pre_shape:
        offset = (float(crop.get("x", 0.0)), float(crop.get("y", 0.0)))
    return image, offset
