"""Blur-pyramid-driven local ops (PyTorch): sharpen/clarity/structure local
contrast, centre effect, dehaze, glow/bloom, halation.

Port of `rapidraw_tpu/ops/local.py` (shader.wgsl:719-887, :1313-1436).
Every blur argument is the LINEAR pyramid level: the pipeline linearizes
each level once (the JAX callers pass blur_is_linear=True everywhere).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops import tone
from rapidraw_tpu_torch.ops.color import apply_creative_color
from rapidraw_tpu_torch.ops.common import (
    as_t, bcast3, fpow_lt1, luma, mix, smoothstep, sqrt_rn,
)


def apply_local_contrast(
    rgb: torch.Tensor, blurred_linear: torch.Tensor, amount, is_raw: bool,
    mode: int, threshold,
) -> torch.Tensor:
    """Log-ratio local contrast (shader.wgsl:719-778).

    mode 0 = sharpness (edge-masked, threshold knob); mode 1 = clarity /
    structure. Negative amounts blend toward the blur.
    """
    amount = as_t(amount, rgb)
    blur_amount = -amount * (0.5 if mode == 0 else 1.0)
    neg_result = mix(rgb, blurred_linear, blur_amount)

    center_luma = luma(rgb)
    shadow_threshold = 0.1 if is_raw else 0.03
    shadow_protection = smoothstep(0.0, shadow_threshold, center_luma)
    highlight_protection = 1.0 - smoothstep(0.9, 1.0, center_luma)
    midtone_mask = shadow_protection * highlight_protection

    blurred_luma = luma(blurred_linear)
    safe_center = torch.clamp_min(center_luma, 0.0001)
    safe_blurred = torch.clamp_min(blurred_luma, 0.0001)
    log_ratio = torch.log2(safe_center / safe_blurred)

    if mode == 0:
        threshold = as_t(threshold, rgb)
        edge_magnitude = torch.abs(log_ratio)
        normalized_edge = torch.clamp(edge_magnitude / 3.0, 0.0, 1.0)
        edge_dampener = 1.0 - sqrt_rn(normalized_edge)
        edge_mask = smoothstep(threshold * 0.5, threshold * 1.5, edge_magnitude)
        effective_amount = amount * edge_dampener * edge_mask * 0.8
    else:
        effective_amount = amount * torch.ones_like(log_ratio)

    contrast_factor = torch.exp2(log_ratio * effective_amount)
    boosted = rgb * contrast_factor
    pos_result = mix(rgb, boosted, midtone_mask)
    pos_result = torch.where(midtone_mask < 0.001, rgb, pos_result)

    out = torch.where(amount < 0.0, neg_result, pos_result)
    return torch.where(amount == 0.0, rgb, out)


def centre_mask_from_coords(xs, ys, w_full: int, h_full: int) -> torch.Tensor:
    """Radial centre weight (shader.wgsl:790-798) from absolute pixel
    coordinate maps."""
    un = (xs / w_full - 0.5) * 2.0
    vn = (ys / h_full - 0.5) * 2.0
    aspect = h_full / w_full
    d = sqrt_rn(un * un + (vn * aspect) ** 2) * 0.5
    vignette_mask = smoothstep(0.4 - 0.375, 0.4 + 0.375, d)
    return 1.0 - vignette_mask


def apply_centre_local_contrast(
    rgb: torch.Tensor, centre_amount, blurred_linear: torch.Tensor, is_raw: bool,
    centre_mask: torch.Tensor,
) -> torch.Tensor:
    """Centre-weighted clarity (shader.wgsl:780-809). Uses the clarity blur."""
    centre_amount = as_t(centre_amount, rgb)
    clarity_strength = centre_amount * (2.0 * centre_mask - 1.0) * 0.9
    out = apply_local_contrast(rgb, blurred_linear, clarity_strength, is_raw, 1, 0.0)
    out = torch.where(torch.abs(clarity_strength) > 0.001, out, rgb)
    return torch.where(centre_amount == 0.0, rgb, out)


def apply_centre_tonal_and_color(
    rgb: torch.Tensor, centre_amount, centre_mask: torch.Tensor
) -> torch.Tensor:
    """Centre-weighted exposure/vibrance/saturation (shader.wgsl:811-846)."""
    centre_amount = as_t(centre_amount, rgb)
    exposure_boost = centre_mask * centre_amount * 0.5
    out = tone.apply_filmic_exposure(rgb, exposure_boost)
    vib_boost = centre_mask * centre_amount * 0.4
    sat_centre = centre_mask * centre_amount * 0.3
    sat_edge = -(1.0 - centre_mask) * centre_amount * 0.8
    out = apply_creative_color(out, sat_centre + sat_edge, vib_boost)
    return torch.where(centre_amount == 0.0, rgb, out)


def apply_dehaze(
    rgb: torch.Tensor, blurred_linear: torch.Tensor, amount
) -> torch.Tensor:
    """Dark-channel-prior dehaze / haze add (shader.wgsl:848-887)."""
    amount = as_t(amount, rgb)
    atmospheric_light = bcast3((0.95, 0.97, 1.0), rgb)

    pixel_dark = torch.amin(rgb, dim=0)
    regional_dark = torch.amin(blurred_linear, dim=0)
    pixel_luma = luma(torch.clamp_min(rgb, 0.0))
    blurred_luma = luma(torch.clamp_min(blurred_linear, 0.0))
    edge_diff = torch.abs(
        sqrt_rn(torch.clamp_min(pixel_luma, 0.0))
        - sqrt_rn(torch.clamp_min(blurred_luma, 0.0))
    )
    halo_protection = smoothstep(0.02, 0.15, edge_diff)
    spatial_dark = mix(regional_dark, pixel_dark, halo_protection)
    safe_dark = torch.clamp_min(spatial_dark - 0.02, 0.0)
    mapped_haze = safe_dark / (safe_dark + 0.2)
    t = torch.clamp_min(1.0 - amount * mapped_haze * 0.85, 0.15)
    recovered = (rgb - atmospheric_light) / t + atmospheric_light
    rec_luma = luma(torch.clamp_min(recovered, 0.0))
    shadow_lift = smoothstep(0.1, 0.0, rec_luma) * (1.0 - t) * 0.15
    recovered = recovered + shadow_lift
    sat_boost = (1.0 - t) * 0.5
    final_luma = luma(torch.clamp_min(recovered, 0.0))
    recovered = mix(final_luma, recovered, 1.0 + sat_boost)
    pos_result = torch.clamp_min(recovered, 0.0)

    safe_dark_n = torch.clamp_min(regional_dark - 0.02, 0.0)
    mapped_depth = safe_dark_n / (safe_dark_n + 0.2)
    depth_factor = mix(0.4, 1.0, mapped_depth)
    neg_result = mix(rgb, atmospheric_light, torch.abs(amount) * 0.7 * depth_factor)

    out = torch.where(amount > 0.0, pos_result, neg_result)
    return torch.where(amount == 0.0, rgb, out)


def _perceptual_luma(linear_luma: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 with linear extension above 1.0 (shader.wgsl:1337-1343)."""
    lo = fpow_lt1(torch.clamp_min(linear_luma, 0.0), 1.0 / 2.2)
    hi = 1.0 + fpow_lt1(torch.clamp_min(linear_luma - 1.0, 0.0), 1.0 / 2.2)
    return torch.where(linear_luma <= 1.0, lo, hi)


def _graded_blur(blurred_linear: torch.Tensor, exp, bright, wh) -> torch.Tensor:
    """Shared glow/halation source: the blur level pushed through the same
    exposure/brightness/whites chain as the main pixel (shader.wgsl:1324-1335)."""
    blurred_linear = tone.apply_linear_exposure(blurred_linear, exp)
    blurred_linear = tone.apply_filmic_exposure(blurred_linear, bright)
    return tone.apply_tonal_adjustments(
        blurred_linear, blurred_linear, 0.0, 0.0, wh, 0.0
    )


def apply_glow_bloom(
    rgb: torch.Tensor, blurred_linear: torch.Tensor, amount, exp, bright, wh
) -> torch.Tensor:
    """Soft bloom from the structure blur (shader.wgsl:1313-1381)."""
    amount = as_t(amount, rgb)
    blurred_linear = _graded_blur(blurred_linear, exp, bright, wh)
    linear_luma = luma(torch.clamp_min(blurred_linear, 0.0))
    perceptual_luma = _perceptual_luma(linear_luma)

    luma_cutoff = mix(0.75, 0.08, torch.clamp(amount, 0.0, 1.0))
    cutoff_fade = smoothstep(luma_cutoff, luma_cutoff + 0.15, perceptual_luma)
    excess = torch.clamp_min(perceptual_luma - luma_cutoff, 0.0)
    bloom_intensity = fpow_lt1(smoothstep(0.0, 1.0, excess / 5.5), 0.45)

    color_ratio = blurred_linear / torch.where(linear_luma > 0.01, linear_luma, 1.0)
    warm = bcast3((1.03, 1.0, 0.97), rgb)
    dark_default = bcast3((1.0, 0.99, 0.98), rgb)
    bloom_color = torch.where(linear_luma > 0.01, color_ratio * warm, dark_default)

    luma_factor = fpow_lt1(torch.clamp_min(linear_luma, 0.0), 0.6)
    black_gate = sqrt_rn(smoothstep(0.0, 0.5, linear_luma))
    bloom_color = bloom_color * (bloom_intensity * luma_factor * cutoff_fade * black_gate)

    current_luma = luma(torch.clamp_min(rgb, 0.0))
    protection = 1.0 - smoothstep(1.0, 2.2, current_luma)
    out = rgb + bloom_color * (amount * 3.8 * protection)
    return torch.where(amount <= 0.0, rgb, out)


def apply_halation(
    rgb: torch.Tensor, blurred_linear: torch.Tensor, amount, exp, bright, wh
) -> torch.Tensor:
    """Red-orange film halation from the clarity blur (shader.wgsl:1383-1436)."""
    amount = as_t(amount, rgb)
    blurred_linear = _graded_blur(blurred_linear, exp, bright, wh)
    linear_luma = luma(torch.clamp_min(blurred_linear, 0.0))
    perceptual_luma = _perceptual_luma(linear_luma)

    luma_cutoff = mix(0.85, 0.1, torch.clamp(amount, 0.0, 1.0))
    excess = perceptual_luma - luma_cutoff
    rng = torch.clamp_min(1.5 - luma_cutoff, 0.1)
    halation_mask = smoothstep(0.0, rng * 0.6, excess)

    core = bcast3((1.0, 0.15, 0.03), rgb)
    fringe = bcast3((1.0, 0.32, 0.10), rgb)
    intensity_blend = smoothstep(0.0, 0.7, halation_mask)
    halation_tint = mix(fringe, core, intensity_blend)
    glow_intensity = halation_mask * linear_luma
    halation_glow = halation_tint * glow_intensity

    color_luma = luma(torch.clamp_min(rgb, 0.0))
    desat_strength = halation_mask * 0.12
    affected = mix(rgb, color_luma, desat_strength)
    contrast_reduced = mix(0.5, affected, 1.0 - halation_mask * 0.06)
    out = contrast_reduced + halation_glow * amount * 2.5

    skip = (amount <= 0.0) | (perceptual_luma <= luma_cutoff)
    return torch.where(skip, rgb, out)
