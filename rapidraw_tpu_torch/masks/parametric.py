"""Image-dependent and AI mask generators + grow/feather.

Ports from mask_generation.rs:
  * apply_grow_and_feather (:313-339): separable grayscale dilate/erode
    sized from the short edge, then gaussian feather.
  * color-range (:1040-1139) and luminance-range (:1141-1239) masks: sample
    the *warped full-res* image at a target pixel, build a tolerance falloff
    mask, un-transforming preview coordinates through crop/rotation/flips/
    orientation to full-res space.
  * AI masks (:786-1038): decode a base64 full-res mask PNG and reproject it
    through the same inverse transform; depth masks add a band-pass over
    depth percent (:906-968).

All generators return u8 (H, W) like the reference's GrayImage.

A copy of `rapidraw_tpu/masks/parametric.py` (NumPy and SciPy; PIL only
inside the AI-bitmap decode, which the develop path never reaches).
"""

from __future__ import annotations

import base64

import numpy as np


def _maximum_filter_1d(arr: np.ndarray, r: int, axis: int, minimum=False) -> np.ndarray:
    from scipy.ndimage import maximum_filter1d, minimum_filter1d

    f = minimum_filter1d if minimum else maximum_filter1d
    return f(arr, size=2 * r + 1, axis=axis, mode="nearest")


def grayscale_dilate(mask: np.ndarray, r: int) -> np.ndarray:
    if r <= 0:
        return mask
    return _maximum_filter_1d(_maximum_filter_1d(mask, r, 1), r, 0)


def grayscale_erode(mask: np.ndarray, r: int) -> np.ndarray:
    if r <= 0:
        return mask
    return _maximum_filter_1d(_maximum_filter_1d(mask, r, 1, True), r, 0, True)


def apply_grow_and_feather(mask: np.ndarray, grow: float, feather: float) -> np.ndarray:
    """(:313-339): grow in % of short edge (max 1%), feather sigma in % of
    short edge (max 0.5%)."""
    h, w = mask.shape
    base = float(min(w, h))
    if abs(grow) > 0.01:
        grow_pixels = (grow / 100.0) * base * 0.01
        amount = int(round(abs(grow_pixels)))
        if amount > 0:
            mask = grayscale_dilate(mask, amount) if grow_pixels > 0 else grayscale_erode(mask, amount)
    if feather > 0.0:
        sigma = (feather / 100.0) * base * 0.005
        if sigma > 0.01:
            from scipy.ndimage import gaussian_filter

            mask = np.clip(
                gaussian_filter(mask.astype(np.float32), sigma, mode="nearest"), 0, 255
            ).astype(np.uint8)
    return mask


def _inverse_transform_coords(
    width: int,
    height: int,
    full_w: int,
    full_h: int,
    scale: float,
    crop_offset,
    rotation: float,
    flip_horizontal: bool,
    flip_vertical: bool,
    orientation_steps: int,
):
    """Preview-space -> full-res source coords (truncating sample), exactly
    the unrotate/unflip/un-coarse chain of :793-855 / :1061-1125.

    Returns (x_src, y_src, valid) integer maps.
    """
    angle = np.deg2rad(rotation)
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    if orientation_steps % 2 == 1:
        crw, crh = full_h, full_w
    else:
        crw, crh = full_w, full_h
    scrw = crw * scale
    scrh = crh * scale
    cx, cy = scrw / 2.0, scrh / 2.0

    x_out = np.arange(width, dtype=np.float32)[None, :] + crop_offset[0]
    y_out = np.arange(height, dtype=np.float32)[:, None] + crop_offset[1]
    xc = x_out - cx
    yc = y_out - cy
    x_unrot = xc * cos_a + yc * sin_a + cx
    y_unrot = -xc * sin_a + yc * cos_a + cy

    # NOTE `scrw - x` (not scrw-1-x) is the reference's own convention
    # (mask_generation.rs:819-845): coordinates are treated as pixel EDGES
    # and truncated at sample time, which shifts pure flips by up to 1px —
    # reproduced verbatim so masks land exactly where the reference puts
    # them (sam.unproject_prompt_rect mirrors the same math).
    x_unf = scrw - x_unrot if flip_horizontal else x_unrot
    y_unf = scrh - y_unrot if flip_vertical else y_unrot

    if orientation_steps == 1:
        xu, yu = y_unf, scrw - x_unf
    elif orientation_steps == 2:
        xu, yu = scrw - x_unf, scrh - y_unf
    elif orientation_steps == 3:
        xu, yu = scrh - y_unf, x_unf
    else:
        xu, yu = x_unf, y_unf

    x_src = xu / scale
    y_src = yu / scale
    valid = (x_src >= 0) & (y_src >= 0) & (x_src < full_w) & (y_src < full_h)
    xi = np.clip(x_src, 0, full_w - 1).astype(np.int64)
    yi = np.clip(y_src, 0, full_h - 1).astype(np.int64)
    return xi, yi, valid


def _range_mask(params: dict, width, height, scale, crop_offset, warped_u8, mode: str):
    """Shared color/luminance range logic. warped_u8: (H, W, 3) u8."""
    if warped_u8 is None:
        return None
    full_h, full_w = warped_u8.shape[:2]
    tx = int(round(float(params.get("targetX") or 0.0)))
    ty = int(round(float(params.get("targetY") or 0.0)))
    if tx < 0 or ty < 0 or tx >= full_w or ty >= full_h:
        return None
    t_raw = params.get("tolerance")
    tolerance = float(20.0 if t_raw is None else t_raw)
    xi, yi, valid = _inverse_transform_coords(
        width, height, full_w, full_h, scale, crop_offset,
        float(params.get("rotation") or 0.0),
        bool(params.get("flipHorizontal", False)),
        bool(params.get("flipVertical", False)),
        int(params.get("orientationSteps", 0) or 0),
    )
    px = warped_u8[yi, xi].astype(np.float32)  # (H, W, 3)
    ref = warped_u8[ty, tx].astype(np.float32)

    if mode == "color":
        tol_sq = max(tolerance * 2.55, 1.0) ** 2 * 3.0
        dist_sq = ((px - ref) ** 2).sum(-1)
    else:
        # luminance (:1191-1214): integer >>-style luma over u8 values
        luma = 0.2126 * px[..., 0] + 0.7152 * px[..., 1] + 0.0722 * px[..., 2]
        ref_l = 0.2126 * ref[0] + 0.7152 * ref[1] + 0.0722 * ref[2]
        tol = max(tolerance * 2.55, 1.0)
        tol_sq = tol * tol
        dist_sq = (luma - ref_l) ** 2

    inside = (dist_sq <= tol_sq) & valid
    intensity = np.where(inside, 1.0 - np.sqrt(dist_sq) / np.sqrt(tol_sq), 0.0)
    mask = (np.clip(intensity, 0, 1) * 255.0).astype(np.uint8)
    # feather default is 0.0 for BOTH range modes: the reference's
    # ParametricMaskParameters uses the serde FIELD default (0.0,
    # mask_generation.rs:199-200); the 35.0 in impl Default is never
    # reached on the :1048/:1149 parse paths
    return apply_grow_and_feather(
        mask, float(params.get("grow") or 0.0), float(params.get("feather") or 0.0)
    )


def generate_color_range(params, width, height, scale, crop_offset, warped_u8):
    return _range_mask(params, width, height, scale, crop_offset, warped_u8, "color")


def generate_luminance_range(params, width, height, scale, crop_offset, warped_u8):
    return _range_mask(params, width, height, scale, crop_offset, warped_u8, "luminance")


def _decode_data_url_gray(data_url: str) -> np.ndarray | None:
    """A data URL of any image the port decodes -> (H, W) u8, as PIL's
    convert("L") gives it (io/image_decode.py); None for data that does
    not decode, where the JAX package's PIL fails. A decoder that does not
    build raises."""
    from rapidraw_tpu_torch.io.image_decode import decode_image
    from rapidraw_tpu_torch.native import KernelBuildError

    b64 = data_url.split(",", 1)[1] if "," in data_url else data_url
    try:
        return decode_image(base64.b64decode(b64), mode="L")
    except KernelBuildError:
        raise
    except Exception:
        return None


def generate_ai_mask(params: dict, width, height, scale, crop_offset) -> np.ndarray | None:
    """subject/foreground/sky/quick-eraser: reproject the decoded full-res
    mask through the inverse transform (:786-905)."""
    data_url = params.get("maskDataBase64")
    if not isinstance(data_url, str):
        return None
    full = _decode_data_url_gray(data_url)
    if full is None:
        return None
    fh, fw = full.shape
    xi, yi, valid = _inverse_transform_coords(
        width, height, fw, fh, scale, crop_offset,
        float(params.get("rotation", 0.0) or 0.0),
        bool(params.get("flipHorizontal", False)),
        bool(params.get("flipVertical", False)),
        int(params.get("orientationSteps", 0) or 0),
    )
    mask = np.where(valid, full[yi, xi], 0).astype(np.uint8)
    return apply_grow_and_feather(
        mask, float(params.get("grow", 0.0) or 0.0), float(params.get("feather", 0.0) or 0.0)
    )


def generate_ai_depth(params: dict, width, height, scale, crop_offset) -> np.ndarray | None:
    """Depth band-pass mask (:906-968)."""
    depth = generate_ai_mask({**params, "grow": 0.0, "feather": 0.0}, width, height, scale, crop_offset)
    if depth is None:
        return None

    def smoothstep(e0, e1, x):
        t = np.clip((x - e0) / np.maximum(e1 - e0, 0.0001), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    val_pct = depth.astype(np.float32) / 255.0 * 100.0
    min_depth = float(params.get("minDepth") or 0.0)
    md = params.get("maxDepth")
    max_depth = float(100.0 if md is None else md)
    min_fade = float(params.get("minFade") or 0.0)
    max_fade = float(params.get("maxFade") or 0.0)
    lower = smoothstep(min_depth - min_fade, min_depth, val_pct)
    upper = 1.0 - smoothstep(max_depth, max_depth + max_fade, val_pct)
    intensity = lower * upper * (val_pct / 100.0)
    mask = (intensity * 255.0).astype(np.uint8)

    # the reference blurs TWICE with the same "feather" JSON field:
    # params.feather*0.1 inline (mask_generation.rs:955-957) and again in
    # apply_grow_and_feather via GrowFeatherParameters (:958-964) — both
    # structs deserialize the same key. Intentional parity, not a bug.
    feather = float(params.get("feather", 0.0) or 0.0)
    if feather > 0.0:
        from scipy.ndimage import gaussian_filter

        mask = np.clip(
            gaussian_filter(mask.astype(np.float32), feather * 0.1, mode="nearest"), 0, 255
        ).astype(np.uint8)
    return apply_grow_and_feather(
        mask, float(params.get("grow", 0.0) or 0.0), float(params.get("feather", 0.0) or 0.0)
    )
