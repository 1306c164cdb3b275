"""The per-pixel grade chain as plain PyTorch — the plain version of the
CUDA grade kernel (csrc/grade.cu).

Port of `rapidraw_tpu/pipeline/grade.py`, lens flare and the 3D LUT
included. Stage order is shader.wgsl main (:1555-1734).
Spatially-dependent stages (centre, vignette, grain, dither) take absolute
pixel-coordinate maps. With masks, each field of `EFF_FIELDS` that a mask
sets becomes a per-pixel map (global + sum of mask value x influence), and
the mask stages (sharpness delta, HSL, colour grading, curves) blend each
mask's own result by its influence.
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops import color as color_ops
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops import curves as curve_ops
from rapidraw_tpu_torch.ops import local as local_ops
from rapidraw_tpu_torch.ops import tone as tone_ops
from rapidraw_tpu_torch.ops.common import as_t, fpow, luma, mix, smoothstep
from rapidraw_tpu_torch.ops.grain import apply_grain, dither_from_coords
from rapidraw_tpu_torch.ops.lut3d import apply_lut
from rapidraw_tpu_torch.params.parse import DevelopConfig

# fields blended per-pixel by mask influence (shader.wgsl:1503-1525)
EFF_FIELDS = (
    "exposure", "brightness", "contrast", "highlights", "shadows", "whites",
    "blacks", "saturation", "temperature", "tint", "vibrance", "luma_nr",
    "color_nr", "clarity", "dehaze", "structure", "glow", "halation",
    "flare", "hue",
)


def blend_mask_indices(cfg: DevelopConfig, f: str) -> tuple:
    """The masks whose value for field f is non-zero, in mask order (the
    other masks' terms are exactly zero and are skipped)."""
    if f not in cfg.mask_blend_fields:
        return ()
    i = cfg.mask_blend_fields.index(f)
    if i < len(cfg.mask_blend_masks):
        return cfg.mask_blend_masks[i]
    return tuple(range(cfg.mask_count))  # configs without the per-field sets: blend all


def effective_params(g: dict, m: dict | None, gated_infl, cfg: DevelopConfig) -> dict:
    """t_x = global.x + sum_i mask_i.x * influence_i (shader.wgsl:1498-1536),
    summed in mask order."""
    eff = {}
    for f in EFF_FIELDS:
        v = g[f]
        if cfg.mask_count > 0:
            for n in blend_mask_indices(cfg, f):
                v = v + gated_infl[n] * m[f][n]
        eff[f] = v
    return eff


def _mask_curve_set(mask_curves: dict, n: int) -> dict:
    return {k: v[n] for k, v in mask_curves.items()}


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
    m: dict | None = None,
    gated_infl: torch.Tensor | None = None,
    flare_rgb: torch.Tensor | None = None,
) -> torch.Tensor:
    """Linear input -> post-curves sRGB (shader.wgsl:1555-1697).

    Blur inputs are LINEAR pyramid levels (None when the config needs none);
    g holds one document's global params as tensors, m its per-mask params
    (leaves with a leading mask axis) and gated_infl the (N, H, W) mask
    influences, zero below 0.001 (both None without masks); flare_rgb the
    (3, H, W) flare contribution, sampled and squared (ops/flare.py
    `sample_flare`), or None.
    """
    is_raw = cfg.is_raw
    eff = effective_params(g, m, gated_infl, cfg)
    centre_mask = None
    if cfg.centre_active:
        centre_mask = local_ops.centre_mask_from_coords(xs, ys, w_full, h_full)

    rgb = initial_linear
    if cfg.sharpness_active:
        rgb = local_ops.apply_local_contrast(
            rgb, sharp_blur, g["sharpness"], is_raw, 0, g["sharpness_threshold"]
        )
    if cfg.mask_sharpness_active:
        delta = torch.zeros_like(rgb)
        for n in range(cfg.mask_count):
            res = local_ops.apply_local_contrast(
                initial_linear, sharp_blur, m["sharpness"][n], is_raw, 0,
                m["sharpness_threshold"][n],
            )
            contrib = (res - initial_linear) * gated_infl[n]
            delta = delta + torch.where(torch.abs(m["sharpness"][n]) > 0.001, contrib, 0.0)
        rgb = rgb + delta
    if cfg.clarity_active:
        rgb = local_ops.apply_local_contrast(rgb, clarity_blur, eff["clarity"], is_raw, 1, 0.0)
    if cfg.structure_active:
        rgb = local_ops.apply_local_contrast(rgb, structure_blur, eff["structure"], is_raw, 1, 0.0)
    if cfg.centre_active:
        rgb = local_ops.apply_centre_local_contrast(
            rgb, g["centre"], clarity_blur, is_raw, centre_mask
        )

    if cfg.exposure_active:
        rgb = tone_ops.apply_linear_exposure(rgb, eff["exposure"])
    if cfg.glow_active:
        rgb = local_ops.apply_glow_bloom(
            rgb, structure_blur, eff["glow"], eff["exposure"], eff["brightness"], eff["whites"]
        )
    if cfg.halation_active:
        rgb = local_ops.apply_halation(
            rgb, clarity_blur, eff["halation"], eff["exposure"], eff["brightness"],
            eff["whites"],
        )
    if cfg.flare_active and flare_rgb is not None:
        # shader.wgsl:1596-1610 (flare_rgb already * 1.4 and squared)
        linear_luma = luma(torch.clamp_min(rgb, 0.0))
        perceptual = local_ops._perceptual_luma(linear_luma)
        protection = 1.0 - smoothstep(0.7, 1.8, perceptual)
        contrib = flare_rgb * eff["flare"] * protection
        rgb = torch.where(as_t(eff["flare"], rgb) > 0.0, rgb + contrib, rgb)
    if cfg.dehaze_active:
        rgb = local_ops.apply_dehaze(rgb, structure_blur, eff["dehaze"])
    if cfg.centre_active:
        rgb = local_ops.apply_centre_tonal_and_color(rgb, g["centre"], centre_mask)

    if cfg.wb_active:
        rgb = color_ops.apply_white_balance(rgb, eff["temperature"], eff["tint"])
    if cfg.brightness_active:
        rgb = tone_ops.apply_filmic_exposure(rgb, eff["brightness"])
    if cfg.tonal_active:
        rgb = tone_ops.apply_tonal_adjustments(
            rgb, tonal_blur if tonal_blur is not None else rgb,
            eff["contrast"], eff["shadows"], eff["whites"], eff["blacks"],
            shadow_path=tonal_blur is not None,
        )
    if cfg.highlights_active:
        rgb = tone_ops.apply_highlights(rgb, eff["highlights"])
    if cfg.calibration_active:
        rgb = color_ops.apply_color_calibration(rgb, g["calibration"])
    if cfg.hsl_active:
        mask_hsl = cfg.mask_hsl_active and cfg.mask_count > 0
        rgb = color_ops.apply_hsl_panel(
            rgb, g["hsl"], m["hsl"] if mask_hsl else None,
            gated_infl if mask_hsl else None, band_active=cfg.hsl_band_active,
        )
    if cfg.hue_active:
        rgb = color_ops.apply_hue_shift(rgb, eff["hue"])
    if cfg.creative_active:
        rgb = color_ops.apply_creative_color(rgb, eff["saturation"], eff["vibrance"])
    if cfg.cg_active:
        rgb = color_ops.apply_color_grading(rgb, g["cg"], g["cg_blending"], g["cg_balance"])
    if cfg.mask_cg_active:
        for n in range(cfg.mask_count):
            graded = color_ops.apply_color_grading(
                rgb, m["cg"][n], m["cg_blending"][n], m["cg_balance"][n]
            )
            rgb = mix(rgb, graded, gated_infl[n])

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
    if cfg.mask_curves_active:
        for n in range(cfg.mask_count):
            curved = curve_ops.apply_all_curves(
                final, _mask_curve_set(m["curves"], n), cfg.curve_segments,
                cfg.rgb_curves_maybe_active,
            )
            final = mix(final, curved, gated_infl[n])
    return final


def finish_chain(final: torch.Tensor, g: dict, cfg: DevelopConfig, xs, ys, scale: float,
                 lut: torch.Tensor | None = None):
    """3D LUT -> grain -> clipping -> dither -> clamp (shader.wgsl:1699-1734).
    Without a cube (`lut` None) the LUT stage is skipped, as in JAX."""
    if cfg.has_lut and lut is not None:
        final = apply_lut(final, lut, g["lut_intensity"])
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
