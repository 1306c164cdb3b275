"""Mask bitmap generation — port of src-tauri/src/mask_generation.rs.

A NumPy copy of `rapidraw_tpu/masks/rasterize.py` (importing that module
pulls in the JAX package through `rapidraw_tpu/__init__.py`); only
`resolve_warped_image` differs: it warps with the port's exact
`geometry/warp.warp_image_geometry` in PyTorch.

Masks are rasterized host-side in vectorized NumPy (the reference also
rasterizes on CPU with rayon) and shipped to the device as an (N, H, W)
float32 array; the grade kernel blends per-mask adjustments by these
influences (shader.wgsl:1498-1536).

Faithfulness notes:
  * All compositing happens in the u8 domain exactly like the reference
    (GrayImage): additive = max, subtractive = saturating sub, intersect =
    min (mask_generation.rs:1351-1370); sub-mask invert/opacity and
    mask-level invert/opacity quantize to u8 at each step (:1332-1346,
    1373-1383).
  * Brush strokes: per-line segment-SDF rasterization with smoothstep
    feather (:385-537), screen-blended (`a + b - ab`) into the line
    accumulator; eraser lines multiply by (1 - v) (:510-521).
  * Flow strokes add a per-stroke flow fraction with the same screen blend
    (:704-773).
  * Radial/linear are closed-form (:539-635).
Color/luminance-range and AI masks need the warped full-res image /
decoded AI bitmaps — supplied via optional arguments.
"""

from __future__ import annotations

import numpy as np



def _smoothstep(t: np.ndarray) -> np.ndarray:
    return t * t * (3.0 - 2.0 * t)


def generate_radial(params: dict, width: int, height: int, scale: float, crop_offset) -> np.ndarray:
    """Rotated ellipse with feather (mask_generation.rs:539-581). Returns u8."""
    cx = float(params.get("centerX", 0.0)) * scale - crop_offset[0]
    cy = float(params.get("centerY", 0.0)) * scale - crop_offset[1]
    rx = max(float(params.get("radiusX", 0.0)) * scale, 0.01)
    ry = max(float(params.get("radiusY", 0.0)) * scale, 0.01)
    rot = np.deg2rad(float(params.get("rotation", 0.0)))
    feather = min(max(float(params.get("feather", 0.0)), 0.0), 1.0)

    # the reference truncates the scaled center to i32 (:552-553)
    cx, cy = float(int(cx)), float(int(cy))
    ys = np.arange(height, dtype=np.float32)[:, None] - cy
    xs = np.arange(width, dtype=np.float32)[None, :] - cx
    c, s = np.cos(rot, dtype=np.float32), np.sin(rot, dtype=np.float32)
    rot_dx = xs * c + ys * s
    rot_dy = -xs * s + ys * c
    dist = np.sqrt((rot_dx / rx) ** 2 + (rot_dy / ry) ** 2)
    inner = 1.0 - feather
    intensity = 1.0 - (dist - inner) / max(1.0 - inner, 0.01)
    # reference casts with truncation (:576)
    return (np.clip(intensity, 0.0, 1.0) * 255.0).astype(np.uint8)


def generate_linear(params: dict, width: int, height: int, scale: float, crop_offset) -> np.ndarray:
    """Linear gradient perpendicular to the drawn line (:583-635). Returns u8."""
    sx = float(params.get("startX", 0.0)) * scale - crop_offset[0]
    sy = float(params.get("startY", 0.0)) * scale - crop_offset[1]
    ex = float(params.get("endX", 0.0)) * scale - crop_offset[0]
    ey = float(params.get("endY", 0.0)) * scale - crop_offset[1]
    rng = float(params.get("range", 50.0)) * scale

    vx, vy = ex - sx, ey - sy
    len_sq = vx * vx + vy * vy
    if len_sq < 0.01:
        return np.zeros((height, width), np.uint8)
    inv_len = 1.0 / np.sqrt(len_sq)
    px, py = -vy * inv_len, vx * inv_len
    half_width = max(rng, 0.01)

    ys = np.arange(height, dtype=np.float32)[:, None] - sy
    xs = np.arange(width, dtype=np.float32)[None, :] - sx
    dist_perp = xs * px + ys * py
    intensity = 0.5 - (dist_perp / half_width) * 0.5
    return (np.clip(intensity, 0.0, 1.0) * 255.0).astype(np.uint8)


def _stroke_distance_sq(
    points: np.ndarray, bb: tuple[int, int, int, int]
) -> np.ndarray:
    """Min squared distance from each bbox pixel to the polyline (:465-534).

    The segment axis is CHUNKED with a running min: materializing all
    (h, w, segments) temporaries at once costs ~multi-GB for a long stroke
    over a full-res frame (the reference iterates per pixel)."""
    x0, y0, x1, y1 = bb
    h, w = y1 - y0 + 1, x1 - x0 + 1
    ys = np.arange(y0, y1 + 1, dtype=np.float32)[:, None, None]
    xs = np.arange(x0, x1 + 1, dtype=np.float32)[None, :, None]
    if len(points) == 1:
        p = points[0]
        return ((xs[..., 0] - p[0]) ** 2 + (ys[..., 0] - p[1]) ** 2).reshape(h, w)
    a_all = points[:-1]  # (S, 2)
    d_all = points[1:] - a_all  # (S, 2)
    # cap live temporaries at ~4 * h*w*chunk floats (~128 MB at 24MP)
    chunk = max(1, int(8e6 // max(h * w, 1)) or 1)
    best = np.full((h, w), np.inf, np.float32)
    for s0 in range(0, len(a_all), chunk):
        a = a_all[s0 : s0 + chunk]
        d = d_all[s0 : s0 + chunk]
        len_sq = (d * d).sum(-1)
        safe = np.where(len_sq < 1e-4, 1.0, len_sq)
        t = ((xs - a[:, 0]) * d[:, 0] + (ys - a[:, 1]) * d[:, 1]) / safe
        t = np.clip(np.where(len_sq < 1e-4, 0.0, t), 0.0, 1.0)
        projx = a[:, 0] + t * d[:, 0]
        projy = a[:, 1] + t * d[:, 1]
        dist_sq = (xs - projx) ** 2 + (ys - projy) ** 2
        np.minimum(best, dist_sq.min(-1), out=best)
    return best


def _render_stroke(points, radius, feather, width, height, scale, crop_offset):
    """One stroke layer as float [0,1] over the full frame (:385-537)."""
    pts = np.asarray(
        [[p["x"] * scale - crop_offset[0], p["y"] * scale - crop_offset[1]] for p in points],
        np.float32,
    )
    if len(pts) == 0 or radius <= 0.0:
        return None
    r_pad = np.ceil(radius) + 2
    x0 = int(max(np.floor(pts[:, 0].min() - r_pad), 0))
    y0 = int(max(np.floor(pts[:, 1].min() - r_pad), 0))
    x1 = int(min(np.ceil(pts[:, 0].max() + r_pad), width - 1))
    y1 = int(min(np.ceil(pts[:, 1].max() + r_pad), height - 1))
    if x0 > x1 or y0 > y1:
        return None

    dist_sq = _stroke_distance_sq(pts, (x0, y0, x1, y1))
    feather = min(max(feather, 0.0), 1.0)
    inner = radius * (1.0 - feather)
    feather_range = max(radius - inner, 0.01)
    intensity = np.where(
        dist_sq <= inner * inner,
        1.0,
        1.0 - _smoothstep(np.clip((np.sqrt(dist_sq) - inner) / feather_range, 0.0, 1.0)),
    )
    intensity = np.where(dist_sq <= radius * radius, intensity, 0.0)
    # the stroke layer is quantized to u8 before blending (:529-533)
    layer = np.round(intensity * 255.0) / 255.0
    return (x0, y0, x1, y1), layer.astype(np.float32)


def generate_brush(params: dict, width: int, height: int, scale: float, crop_offset) -> np.ndarray:
    """Brush strokes, screen-blended per line (:641-702). Returns u8."""
    acc = np.zeros((height, width), np.float32)
    for line in params.get("lines", []) or []:
        pts = line.get("points") or []
        if not pts:
            continue
        radius = max(float(line.get("brushSize", 0.0)) * scale / 2.0, 0.0)
        res = _render_stroke(
            pts, radius, float(line.get("feather", 0.5)), width, height, scale, crop_offset
        )
        if res is None:
            continue
        (x0, y0, x1, y1), layer = res
        dst = acc[y0 : y1 + 1, x0 : x1 + 1]
        if line.get("tool") == "eraser":
            blended = dst * (1.0 - layer)
        else:
            blended = dst + layer - dst * layer
        upd = np.round(np.clip(blended, 0.0, 1.0) * 255.0) / 255.0
        acc[y0 : y1 + 1, x0 : x1 + 1] = np.where(layer > 0.0, upd, dst)
    return np.round(acc * 255.0).astype(np.uint8)


def generate_flow(params: dict, width: int, height: int, scale: float, crop_offset) -> np.ndarray:
    """Flow brush: per-stroke opacity accumulation (:704-773). Returns u8."""
    acc = np.zeros((height, width), np.float32)  # holds u8-quantized values
    for line in params.get("lines", []) or []:
        pts = line.get("points") or []
        if not pts:
            continue
        radius = max(float(line.get("brushSize", 0.0)) * scale / 2.0, 0.0)
        flow = min(max(float(line.get("flow", 10.0)), 0.0), 100.0) / 100.0 * 255.0
        res = _render_stroke(
            pts, radius, float(line.get("feather", 0.5)), width, height, scale, crop_offset
        )
        if res is None:
            continue
        (x0, y0, x1, y1), layer = res
        dst = acc[y0 : y1 + 1, x0 : x1 + 1]
        delta = np.round(layer * flow)
        d_norm = np.clip(delta / 255.0, 0.0, 1.0)
        if line.get("tool") == "eraser":
            nxt = dst * (1.0 - d_norm)
        else:
            nxt = dst + d_norm - dst * d_norm
        upd = np.round(np.clip(nxt, 0.0, 1.0) * 255.0) / 255.0
        acc[y0 : y1 + 1, x0 : x1 + 1] = np.where(layer * 255.0 > 0.0, upd, dst)
    return np.round(acc * 255.0).astype(np.uint8)


def generate_all(width: int, height: int) -> np.ndarray:
    return np.full((height, width), 255, np.uint8)


_GENERATORS = {
    "radial": generate_radial,
    "linear": generate_linear,
    "brush": generate_brush,
    "flow": generate_flow,
}


def generate_sub_mask(
    sub: dict,
    width: int,
    height: int,
    scale: float,
    crop_offset,
    warped_image: np.ndarray | None = None,
) -> np.ndarray | None:
    """Dispatch one sub-mask (:1246-1318).

    warped_image: (H, W, 3) u8 of the warped full-res image — required by
    color/luminance range masks (mask_generation.rs resolve_warped_image).
    """
    if not sub.get("visible", False):
        return None
    t = sub.get("type")
    params = sub.get("parameters") or {}
    if t == "all":
        return generate_all(width, height)
    gen = _GENERATORS.get(t)
    if gen is not None:
        return gen(params, width, height, scale, crop_offset)

    from rapidraw_tpu_torch.masks import parametric as pm

    if t == "color":
        return pm.generate_color_range(params, width, height, scale, crop_offset, warped_image)
    if t == "luminance":
        return pm.generate_luminance_range(params, width, height, scale, crop_offset, warped_image)
    if t in ("ai-subject", "ai-foreground", "ai-sky", "quick-eraser"):
        return pm.generate_ai_mask(params, width, height, scale, crop_offset)
    if t == "ai-depth":
        return pm.generate_ai_depth(params, width, height, scale, crop_offset)
    return None


def generate_mask_bitmap(
    mask_def: dict,
    width: int,
    height: int,
    scale: float = 1.0,
    crop_offset=(0.0, 0.0),
    warped_image: np.ndarray | None = None,
) -> np.ndarray | None:
    """Composite one MaskDefinition to a u8 (H, W) bitmap (:1320-1388)."""
    if not mask_def.get("visible", False) or not mask_def.get("subMasks"):
        return None
    final = np.zeros((height, width), np.uint8)
    for sub in mask_def["subMasks"]:
        bitmap = generate_sub_mask(sub, width, height, scale, crop_offset, warped_image)
        if bitmap is None:
            continue
        if sub.get("invert", False):
            bitmap = (255 - bitmap.astype(np.int16)).astype(np.uint8)
        opacity = min(max(float(sub.get("opacity", 100.0)) / 100.0, 0.0), 1.0)
        if opacity < 1.0:
            bitmap = (bitmap.astype(np.float32) * opacity).astype(np.uint8)
        mode = sub.get("mode", "additive")
        if mode == "additive":
            final = np.maximum(final, bitmap)
        elif mode == "subtractive":
            final = np.maximum(final.astype(np.int16) - bitmap.astype(np.int16), 0).astype(np.uint8)
        elif mode == "intersect":
            final = np.minimum(final, bitmap)
    if mask_def.get("invert", False):
        final = (255 - final.astype(np.int16)).astype(np.uint8)
    opacity = min(max(float(mask_def.get("opacity", 100.0)) / 100.0, 0.0), 1.0)
    if opacity < 1.0:
        final = (final.astype(np.float32) * opacity).astype(np.uint8)
    return final


def rasterize_masks(
    adjustments: dict,
    width: int,
    height: int,
    scale: float = 1.0,
    crop_offset=(0.0, 0.0),
    warped_image: np.ndarray | None = None,
) -> np.ndarray | None:
    """All visible masks of an adjustment doc -> (N, H, W) float32 in [0,1].

    Order matches parse_adjustments' mask stacking (visible masks, in
    document order, capped at MAX_MASKS) so influence index n aligns with
    mask params index n.
    """
    from rapidraw_tpu_torch.params.scales import MAX_MASKS

    masks_json = adjustments.get("masks")
    if not isinstance(masks_json, list):
        return None
    out = []
    for m in masks_json:
        if not isinstance(m, dict) or not m.get("visible", False):
            continue
        if len(out) >= MAX_MASKS:
            break
        bitmap = generate_mask_bitmap(m, width, height, scale, crop_offset, warped_image)
        if bitmap is None:
            bitmap = np.zeros((height, width), np.uint8)
        out.append(bitmap.astype(np.float32) / 255.0)
    if not out:
        return None
    return np.stack(out)


def requires_warped_image(adjustments: dict) -> bool:
    """Does any visible sub-mask sample image content?
    (MaskDefinition::requires_warped_image, mask_generation.rs:1452)."""
    for m in adjustments.get("masks") or []:
        if not isinstance(m, dict) or not m.get("visible", False):
            continue
        for sub in m.get("subMasks") or []:
            # visible defaults False, matching generate_sub_mask — a
            # sub-mask that won't render must not trigger the full-res warp
            if isinstance(sub, dict) and sub.get("visible", False) and \
                    sub.get("type") in ("color", "luminance"):
                return True
    return False


def resolve_warped_image(
    image, adjustments: dict, is_raw: bool = False, force: bool = False
) -> np.ndarray | None:
    """The geometry-warped (pre-crop, pre-rotation) full image as (H, W, 3)
    u8 for color/luminance range masks (lib.rs get_cached_full_warped_image
    :260-288: warp only; RAW gets the default gamma/contrast look first).
    Returns None when no mask in `adjustments` needs it — pass force=True
    when rendering a mask_def NOT present in the document (the overlay of
    a newly drawn/unsaved range mask)."""
    if not force and not requires_warped_image(adjustments):
        return None
    import torch

    from rapidraw_tpu_torch.geometry.params import (
        geometry_params_from_json, is_geometry_identity,
    )
    from rapidraw_tpu_torch.geometry.warp import warp_image_geometry

    x = image if isinstance(image, torch.Tensor) else torch.as_tensor(np.asarray(image, np.float32))
    if is_raw:
        g = torch.pow(torch.clamp_min(x, 0.0), 1.0 / 2.38)
        x = torch.clamp((g - 0.5) * 1.28 + 0.5, 0.0, 1.0)
    gp = geometry_params_from_json(adjustments)
    if not is_geometry_identity(gp):
        x = warp_image_geometry(x, gp)
    arr = torch.clamp(x, 0.0, 1.0).cpu().numpy()
    return (arr * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)


def generate_mask_overlay(
    mask_def: dict,
    width: int,
    height: int,
    scale: float = 1.0,
    crop_offset=(0.0, 0.0),
    adjustments: dict | None = None,
    image=None,
    is_raw: bool = False,
) -> str:
    """Red half-transparent RGBA PNG of one MaskDefinition, returned as a
    data URL for the editor overlay (mask_generation.rs:1391-1445): alpha =
    intensity * 0.5, color (255, 0, 0). Returns "" when the mask renders
    empty. `image` feeds the warped-image resolve for color/luminance range
    sub-masks; pass `is_raw` so the overlay samples the SAME tonemapped
    warped image the develop-time mask samples."""
    import base64

    warped = None
    if adjustments is not None and image is not None:
        if any(_sub_needs_warp(s) for s in mask_def.get("subMasks") or []):
            # force: the mask_def being overlaid may not (yet) exist in the
            # adjustments document, whose gate would return None
            warped = resolve_warped_image(image, adjustments, is_raw, force=True)

    scaled_offset = (crop_offset[0] * scale, crop_offset[1] * scale)
    gray = generate_mask_bitmap(mask_def, width, height, scale, scaled_offset, warped)
    if gray is None:
        return ""
    from rapidraw_tpu_torch.io.encode import png_bytes

    rgba = np.zeros((height, width, 4), np.uint8)
    rgba[..., 0] = 255
    rgba[..., 3] = (gray.astype(np.uint16) // 2).astype(np.uint8)
    return "data:image/png;base64," + base64.b64encode(png_bytes(rgba)).decode()


def _sub_needs_warp(sub: dict) -> bool:
    return sub.get("type") in ("color", "luminance") and sub.get("visible", False)
