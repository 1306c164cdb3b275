"""Tonal adjustments and the output tonemappers (PyTorch).

Port of `rapidraw_tpu/ops/tone.py`: exposure, filmic brightness, contrast /
shadows / whites / blacks, highlights, AgX / RAW emulation
(shader.wgsl:380-547, :1107-1191, :1664-1676). Params may be 0-d tensors,
Python floats or (H, W) maps.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.common import (
    as_t,
    fpow,
    fpow_lt1,
    fpow_static,
    luma,
    mat3_apply,
    mix,
    smoothstep,
    sqrt_rn,
)
from rapidraw_tpu_torch.params import agx as agx_c


def apply_linear_exposure(rgb: torch.Tensor, exposure) -> torch.Tensor:
    """rgb * 2^exposure, identity at 0 (shader.wgsl:511-516)."""
    exposure = as_t(exposure, rgb)
    out = rgb * torch.exp2(exposure)
    return torch.where(exposure == 0.0, rgb, out)


def apply_filmic_exposure(rgb: torch.Tensor, brightness) -> torch.Tensor:
    """Luma-shaped midtone brightness with chroma rolloff (shader.wgsl:518-547)."""
    brightness = as_t(brightness, rgb)
    rational_curve_mix = 0.95
    midtone_strength = 1.2
    top_anchor = 1.06

    original_luma = luma(rgb)
    direct_adj = brightness * (1.0 - rational_curve_mix)
    rational_adj = brightness * rational_curve_mix
    scale = torch.exp2(direct_adj)
    k = torch.exp2(-rational_adj * midtone_strength)

    luma_abs = torch.abs(original_luma)
    luma_floor = torch.floor(luma_abs / top_anchor) * top_anchor
    luma_norm = (luma_abs - luma_floor) / top_anchor
    shaped_norm = luma_norm / (luma_norm + (1.0 - luma_norm) * k)
    shaped_luma_abs = luma_floor + shaped_norm * top_anchor
    new_luma = torch.sign(original_luma) * shaped_luma_abs * scale

    chroma = rgb - original_luma
    safe_orig = torch.where(torch.abs(original_luma) < 1e-20, 1.0, original_luma)
    total_luma_scale = new_luma / safe_orig
    luma_weight = torch.clamp(new_luma, 0.0, 2.0) * 0.5
    dynamic_exp = mix(0.95, 0.65, luma_weight)
    base_chroma_scale = fpow_lt1(torch.clamp_min(total_luma_scale, 0.0), dynamic_exp)
    highlight_rolloff = 1.0 / (1.0 + torch.clamp_min(new_luma - 0.9, 0.0) * 2.0)
    chroma_scale = base_chroma_scale * highlight_rolloff

    out = new_luma + chroma * chroma_scale
    skip = (brightness == 0.0) | (torch.abs(original_luma) < 0.00001)
    return torch.where(skip, rgb, out)


def get_shadow_mult(l, sh, bl):
    """Shadow/black lift multiplier (shader.wgsl:380-403)."""
    safe_luma = torch.clamp_min(l, 0.0001)
    mult = torch.ones_like(safe_luma)

    x = safe_luma / 0.05
    m = (1.0 - x) * (1.0 - x)
    factor = torch.clamp_max(torch.exp2(bl * 0.75), 3.9)
    bl_mult = mix(1.0, factor, m)
    mult = mult * torch.where((bl != 0.0) & (safe_luma < 0.05), bl_mult, 1.0)

    x = safe_luma / 0.1
    m = (1.0 - x) * (1.0 - x)
    factor = torch.clamp_max(torch.exp2(sh * 1.5), 3.9)
    sh_mult = mix(1.0, factor, m)
    mult = mult * torch.where((sh != 0.0) & (safe_luma < 0.1), sh_mult, 1.0)
    return mult


def apply_tonal_adjustments(
    rgb: torch.Tensor,
    blurred_linear: torch.Tensor,
    con,
    sh,
    wh,
    bl,
    shadow_path: bool = True,
) -> torch.Tensor:
    """Contrast / shadows / whites / blacks (shader.wgsl:405-464).

    `blurred_linear` is the LINEAR tonal blur level (the pipeline
    linearizes each level once). `shadow_path=False` skips the
    blur-consuming shadows/blacks block (shadows and blacks are zero).
    """
    con, sh, wh, bl = (as_t(v, rgb) for v in (con, sh, wh, bl))
    white_level = 1.0 - wh * 0.25
    w_mult = 1.0 / torch.clamp_min(white_level, 0.01)
    w_on = wh != 0.0
    rgb = torch.where(w_on, rgb * w_mult, rgb)

    if shadow_path:
        blurred_linear = torch.where(w_on, blurred_linear * w_mult, blurred_linear)

        pixel_luma = luma(torch.clamp_min(rgb, 0.0))
        blurred_luma = luma(torch.clamp_min(blurred_linear, 0.0))
        safe_pixel_luma = torch.clamp_min(pixel_luma, 0.0001)
        safe_blurred_luma = torch.clamp_min(blurred_luma, 0.0001)

        perc_pixel = sqrt_rn(safe_pixel_luma)
        perc_blurred = sqrt_rn(safe_blurred_luma)
        halo_protection = smoothstep(0.05, 0.25, torch.abs(perc_pixel - perc_blurred))

        spatial_mult = get_shadow_mult(safe_blurred_luma, sh, bl)
        pixel_mult = get_shadow_mult(safe_pixel_luma, sh, bl)
        final_mult = mix(spatial_mult, pixel_mult, halo_protection)
        sb_on = (sh != 0.0) | (bl != 0.0)
        rgb = torch.where(sb_on, rgb * final_mult, rgb)

    g = 2.2
    safe_rgb = torch.clamp_min(rgb, 0.0)
    perceptual = fpow_lt1(safe_rgb, 1.0 / g)
    clamped_perceptual = torch.clamp(perceptual, 0.0, 1.0)
    strength = torch.exp2(con * 1.25)
    lo = clamped_perceptual < 0.5
    base = torch.where(lo, 2.0 * clamped_perceptual, 2.0 * (1.0 - clamped_perceptual))
    powed = 0.5 * fpow(base, strength)
    curved = torch.where(lo, powed, 1.0 - powed)
    contrast_adjusted = fpow_static(curved, g)
    mix_factor = smoothstep(1.0, 1.01, safe_rgb)
    contrasted = mix(contrast_adjusted, rgb, mix_factor)
    return torch.where(con != 0.0, contrasted, rgb)


def apply_highlights(rgb: torch.Tensor, highlights_adj) -> torch.Tensor:
    """Highlight recovery / boost (shader.wgsl:466-509)."""
    highlights_adj = as_t(highlights_adj, rgb)
    pixel_luma = luma(torch.clamp_min(rgb, 0.0))
    safe_pixel_luma = torch.clamp_min(pixel_luma, 0.0001)
    pixel_mask_input = torch.tanh(safe_pixel_luma * 1.5)
    highlight_mask = smoothstep(0.3, 0.95, pixel_mask_input)

    l = pixel_luma
    gamma = 1.0 - highlights_adj * 1.75
    new_luma_lo = fpow(torch.clamp_min(l, 0.0), gamma)
    luma_excess = l - 1.0
    compression_strength = -highlights_adj * 6.0
    compressed_excess = luma_excess / (1.0 + torch.clamp_min(luma_excess, 0.0) * compression_strength)
    new_luma_hi = 1.0 + compressed_excess
    new_luma = torch.where(l <= 1.0, new_luma_lo, new_luma_hi)
    tonally_adjusted = rgb * (new_luma / torch.clamp_min(l, 0.0001))
    desat = smoothstep(1.0, 10.0, l)
    neg_result = mix(tonally_adjusted, new_luma, desat)

    factor = torch.exp2(highlights_adj * 1.75)
    pos_result = rgb * factor

    adjusted = torch.where(highlights_adj < 0.0, neg_result, pos_result)
    out = mix(rgb, adjusted, highlight_mask)
    skip = (highlights_adj == 0.0) | (highlight_mask < 0.001)
    return torch.where(skip, rgb, out)


def _horner(u, coef):
    acc = coef[-1] * torch.ones_like(u)
    for c in coef[-2::-1]:
        acc = acc * u + c
    return acc


def _agx_curve_channel(x):
    """AgX toe/shoulder curve via the branch polynomials of params/agx.py."""
    tx = agx_c.AGX_TOE_TRANSITION_X
    t_coef, t_mid, t_inv_half = agx_c.AGX_TOE_POLY
    s_coef, s_mid, s_inv_half = agx_c.AGX_SHOULDER_POLY
    ut = (torch.clamp(x, agx_c.AGX_CURVE_M0, tx) - t_mid) * t_inv_half
    us = (torch.clamp(x, tx, agx_c.AGX_CURVE_M1) - s_mid) * s_inv_half
    result = torch.where(x < tx, _horner(ut, t_coef), _horner(us, s_coef))
    return torch.clamp(result, 0.0, 1.0)


def agx_tonemap(rgb: torch.Tensor, p2r, r2p) -> torch.Tensor:
    """Full AgX transform (shader.wgsl:1145-1174)."""
    min_c = torch.amin(rgb, dim=0)
    compressed = torch.where(min_c < 0.0, rgb - min_c, rgb)
    in_agx = mat3_apply(p2r, compressed)
    x_rel = torch.clamp_min(in_agx / 0.18, agx_c.AGX_EPSILON)
    log_encoded = (torch.log2(x_rel) - agx_c.AGX_MIN_EV) / agx_c.AGX_RANGE_EV
    mapped = torch.clamp(log_encoded, 0.0, 1.0)
    curved = _agx_curve_channel(mapped)
    final = fpow_static(torch.clamp_min(curved, 0.0), agx_c.AGX_GAMMA)
    return mat3_apply(r2p, final)


def raw_srgb_emulation(rgb_linear: torch.Tensor) -> torch.Tensor:
    """RAW 'basic' tonemap (shader.wgsl:1667-1673)."""
    srgb = cs.linear_to_srgb(rgb_linear)
    srgb = fpow_lt1(torch.clamp_min(srgb, 0.0), 1.0 / 1.1)
    contrast_curve = srgb * srgb * (3.0 - 2.0 * srgb)
    return mix(srgb, contrast_curve, 0.75)
