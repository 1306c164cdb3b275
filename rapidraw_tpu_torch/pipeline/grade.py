"""The per-pixel grade chain as plain PyTorch — the plain version of the
CUDA grade kernel (csrc/grade.cu).

Port of `rapidraw_tpu/pipeline/grade.py` for documents without masks or
flare (those are later slices). Stage order is shader.wgsl main
(:1555-1734). Spatially-dependent stages (centre, vignette, grain, dither)
take absolute pixel-coordinate maps.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops import color as color_ops
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops import curves as curve_ops
from rapidraw_tpu_torch.ops import local as local_ops
from rapidraw_tpu_torch.ops import tone as tone_ops
from rapidraw_tpu_torch.ops.common import as_t, fpow, mix, smoothstep
from rapidraw_tpu_torch.ops.grain import apply_grain, dither_from_coords
from rapidraw_tpu_torch.params.parse import DevelopConfig


def apply_vignette(rgb, xs, ys, w_full, h_full, amount, midpoint, roundness, feather):
    """Post-grade vignette (shader.wgsl:1645-1662)."""
    amount = as_t(amount, rgb)
    v_round = 1.0 - roundness
    v_feather = feather * 0.5
    un = (xs / w_full - 0.5) * 2.0
    vn = (ys / h_full - 0.5) * 2.0
    aspect = h_full / w_full
    ux = torch.sign(un) * fpow(torch.abs(un), v_round)
    uy = torch.sign(vn) * fpow(torch.abs(vn), v_round)
    d = torch.sqrt(ux * ux + (uy * aspect) ** 2) * 0.5
    vmask = smoothstep(midpoint - v_feather, midpoint + v_feather, d)
    darken = rgb * (1.0 + amount * vmask)
    lighten = mix(rgb, 1.0, amount * vmask)
    return torch.where(amount < 0.0, darken, lighten)


def grade_chain(
    initial_linear: torch.Tensor,
    sharp_blur,
    tonal_blur,
    clarity_blur,
    structure_blur,
    g: dict,
    cfg: DevelopConfig,
    xs: torch.Tensor,
    ys: torch.Tensor,
    w_full: int,
    h_full: int,
) -> torch.Tensor:
    """Linear input -> post-curves sRGB (shader.wgsl:1555-1697).

    Blur inputs are LINEAR pyramid levels (None when the config needs none);
    g holds one document's global params as tensors.
    """
    is_raw = cfg.is_raw
    centre_mask = None
    if cfg.centre_active:
        centre_mask = local_ops.centre_mask_from_coords(xs, ys, w_full, h_full)

    rgb = initial_linear
    if cfg.sharpness_active:
        rgb = local_ops.apply_local_contrast(
            rgb, sharp_blur, g["sharpness"], is_raw, 0, g["sharpness_threshold"]
        )
    if cfg.clarity_active:
        rgb = local_ops.apply_local_contrast(rgb, clarity_blur, g["clarity"], is_raw, 1, 0.0)
    if cfg.structure_active:
        rgb = local_ops.apply_local_contrast(rgb, structure_blur, g["structure"], is_raw, 1, 0.0)
    if cfg.centre_active:
        rgb = local_ops.apply_centre_local_contrast(
            rgb, g["centre"], clarity_blur, is_raw, centre_mask
        )

    if cfg.exposure_active:
        rgb = tone_ops.apply_linear_exposure(rgb, g["exposure"])
    if cfg.glow_active:
        rgb = local_ops.apply_glow_bloom(
            rgb, structure_blur, g["glow"], g["exposure"], g["brightness"], g["whites"]
        )
    if cfg.halation_active:
        rgb = local_ops.apply_halation(
            rgb, clarity_blur, g["halation"], g["exposure"], g["brightness"], g["whites"]
        )
    if cfg.dehaze_active:
        rgb = local_ops.apply_dehaze(rgb, structure_blur, g["dehaze"])
    if cfg.centre_active:
        rgb = local_ops.apply_centre_tonal_and_color(rgb, g["centre"], centre_mask)

    if cfg.wb_active:
        rgb = color_ops.apply_white_balance(rgb, g["temperature"], g["tint"])
    if cfg.brightness_active:
        rgb = tone_ops.apply_filmic_exposure(rgb, g["brightness"])
    if cfg.tonal_active:
        rgb = tone_ops.apply_tonal_adjustments(
            rgb, tonal_blur if tonal_blur is not None else rgb,
            g["contrast"], g["shadows"], g["whites"], g["blacks"],
            shadow_path=tonal_blur is not None,
        )
    if cfg.highlights_active:
        rgb = tone_ops.apply_highlights(rgb, g["highlights"])
    if cfg.calibration_active:
        rgb = color_ops.apply_color_calibration(rgb, g["calibration"])
    if cfg.hsl_active:
        rgb = color_ops.apply_hsl_panel(rgb, g["hsl"], band_active=cfg.hsl_band_active)
    if cfg.hue_active:
        rgb = color_ops.apply_hue_shift(rgb, g["hue"])
    if cfg.creative_active:
        rgb = color_ops.apply_creative_color(rgb, g["saturation"], g["vibrance"])
    if cfg.cg_active:
        rgb = color_ops.apply_color_grading(rgb, g["cg"], g["cg_blending"], g["cg_balance"])

    if cfg.vignette_active:
        rgb = apply_vignette(
            rgb, xs, ys, w_full, h_full,
            g["vignette_amount"], g["vignette_midpoint"],
            g["vignette_roundness"], g["vignette_feather"],
        )

    if cfg.tonemapper_agx:
        final = tone_ops.agx_tonemap(rgb, g["agx_p2r"], g["agx_r2p"])
    elif is_raw:
        final = tone_ops.raw_srgb_emulation(rgb)
    else:
        final = cs.linear_to_srgb(rgb)

    if cfg.curves_active:
        final = curve_ops.apply_all_curves(
            final, g["curves"], cfg.curve_segments, cfg.rgb_curves_maybe_active
        )
    return final


def finish_chain(final: torch.Tensor, g: dict, cfg: DevelopConfig, xs, ys, scale: float):
    """Grain -> clipping -> dither -> clamp (shader.wgsl:1699-1734)."""
    if cfg.grain_active:
        final = apply_grain(
            final, g["grain_amount"], g["grain_size"], g["grain_roughness"], scale, xs, ys
        )
    if cfg.show_clipping:
        hi = torch.any(final > 0.998, dim=0)
        lo = torch.any(final < 0.002, dim=0)
        zero = torch.zeros_like(final[0])
        one = torch.ones_like(final[0])
        final = torch.stack(
            [
                torch.where(hi, one, torch.where(lo, zero, final[0])),
                torch.where(hi, zero, torch.where(lo, zero, final[1])),
                torch.where(hi, zero, torch.where(lo, one, final[2])),
            ]
        )
    if cfg.dither_active:
        final = final + dither_from_coords(xs, ys) * (1.0 / 255.0)
    return torch.clamp(final, 0.0, 1.0)
