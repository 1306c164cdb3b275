"""Color adjustments (PyTorch): white balance, saturation/vibrance, hue
shift, HSL 8-band mixer, 3-way color grading, color calibration.

Port of `rapidraw_tpu/ops/color.py` (shader.wgsl:276-293, :549-717).
"""

from __future__ import annotations

import torch

from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.common import as_t, luma, mix, smoothstep, wgsl_mod

# (center_degrees, width) per band: Red, Orange, Yellow, Green, Aqua, Blue,
# Purple, Magenta (shader.wgsl:186-195).
HSL_RANGES = (
    (358.0, 35.0),
    (25.0, 45.0),
    (60.0, 40.0),
    (115.0, 90.0),
    (180.0, 60.0),
    (225.0, 60.0),
    (280.0, 55.0),
    (330.0, 50.0),
)


def apply_white_balance(rgb: torch.Tensor, temp, tint) -> torch.Tensor:
    """Per-channel temperature/tint gains (shader.wgsl:587-593)."""
    t, n = temp, tint
    r = rgb[0] * ((1.0 + t * 0.2) * (1.0 + n * 0.25))
    g = rgb[1] * ((1.0 + t * 0.05) * (1.0 - n * 0.25))
    b = rgb[2] * ((1.0 - t * 0.2) * (1.0 + n * 0.25))
    return torch.stack([r, g, b])


def apply_creative_color(rgb: torch.Tensor, sat, vib) -> torch.Tensor:
    """Saturation + selective vibrance with skin protection (shader.wgsl:595-626)."""
    sat, vib = as_t(sat, rgb), as_t(vib, rgb)
    l = luma(rgb)
    processed = torch.where(sat != 0.0, mix(l, rgb, 1.0 + sat), rgb)

    c_max = torch.amax(processed, dim=0)
    c_min = torch.amin(processed, dim=0)
    delta = c_max - c_min
    current_sat = delta / torch.clamp_min(c_max, 0.001)

    sat_mask = 1.0 - smoothstep(0.4, 0.9, current_sat)
    h, _, _ = cs.rgb_to_hsv(processed)
    hue_dist = torch.minimum(torch.abs(h - 25.0), 360.0 - torch.abs(h - 25.0))
    is_skin = smoothstep(35.0, 10.0, hue_dist)
    skin_dampener = mix(1.0, 0.6, is_skin)
    amount_pos = vib * sat_mask * skin_dampener * 3.0

    desat_mask = 1.0 - smoothstep(0.2, 0.8, current_sat)
    amount_neg = vib * desat_mask

    amount = torch.where(vib > 0.0, amount_pos, amount_neg)
    vibed = mix(l, processed, 1.0 + amount)
    skip = (vib == 0.0) | (delta < 0.02)
    return torch.where(skip, processed, vibed)


def apply_hue_shift(rgb: torch.Tensor, shift_degrees) -> torch.Tensor:
    """Global hue rotation via extended-sRGB HSV (shader.wgsl:276-286)."""
    shift_degrees = as_t(shift_degrees, rgb)
    srgb = cs.linear_to_srgb_extended(rgb)
    h, s, v = cs.rgb_to_hsv(srgb)
    shifted_h = wgsl_mod(h + shift_degrees + 360.0, 360.0)
    shifted = cs.hsv_to_rgb(shifted_h, s, v)
    out = cs.srgb_to_linear(shifted)
    return torch.where(torch.abs(shift_degrees) < 0.01, rgb, out)


def _raw_hsl_influence(hue, center, width):
    """Wrapped-gaussian band influence (shader.wgsl:288-293)."""
    dist = torch.minimum(torch.abs(hue - center), 360.0 - torch.abs(hue - center))
    falloff = dist * (2.0 / width)
    return torch.exp(-1.5 * falloff * falloff)


def apply_hsl_panel(
    rgb: torch.Tensor, hsl, mask_hsl=None, mask_influence=None,
    band_active: tuple | None = None,
) -> torch.Tensor:
    """8-band hue/sat/luma mixer (shader.wgsl:628-684).

    hsl: (8, 3) band params [hue, sat, lum]; mask_hsl: optional (N, 8, 3)
    per-mask band params, mask_influence their (N, ...) influence maps.
    `band_active` (static, from DevelopConfig.hsl_band_active, the union
    over the global and the mask params) skips bands whose params are all
    zero: their terms are exactly zero. The normalizer still sums all 8
    bands. The shader sums global + mask band params per pixel before the
    weighted totals; both reductions are linear, so the band weights are
    contracted against the global and each mask's params separately, in
    that order, as the JAX op does.
    """
    safe = torch.clamp_min(rgb, 0.0)
    h, s, v = cs.rgb_to_hsv(safe)
    original_luma = luma(safe)

    saturation_mask = smoothstep(0.05, 0.20, s)
    luminance_weight = smoothstep(0.0, 1.0, s)

    active = band_active if band_active is not None else (True,) * 8
    raw_inf = [_raw_hsl_influence(h, c, w) for c, w in HSL_RANGES]
    total_raw = raw_inf[0]
    for r in raw_inf[1:]:
        total_raw = total_raw + r
    inv_total = 1.0 / total_raw

    def totals(band_params):  # (8, 3) -> three (...) maps
        th = ts = tl = 0.0
        for i in range(8):
            if not active[i]:
                continue
            ni = raw_inf[i] * inv_total
            th = th + band_params[i][0] * 2.0 * ni
            ts = ts + band_params[i][1] * ni
            tl = tl + band_params[i][2] * ni
        return th * saturation_mask, ts * saturation_mask, tl * luminance_weight

    total_hue, total_sat, total_lum = totals(hsl)
    if mask_hsl is not None:
        for n in range(len(mask_hsl)):
            mh, ms, ml = totals(mask_hsl[n])
            total_hue = total_hue + mask_influence[n] * mh
            total_sat = total_sat + mask_influence[n] * ms
            total_lum = total_lum + mask_influence[n] * ml

    new_sat_raw = s * (1.0 + total_sat)
    desat_val = original_luma * (1.0 + total_lum)

    new_h = wgsl_mod(h + total_hue + 360.0, 360.0)
    new_s = torch.clamp(new_sat_raw, 0.0, 1.0)
    hs_shifted = cs.hsv_to_rgb(new_h, new_s, v)
    new_luma = luma(hs_shifted)
    target_luma = original_luma * (1.0 + total_lum)
    scaled = hs_shifted * (target_luma / torch.where(new_luma < 0.0001, 1.0, new_luma))
    result = torch.where(new_luma < 0.0001, torch.clamp_min(target_luma, 0.0), scaled)
    result = torch.where(new_sat_raw < 0.0001, desat_val, result)

    gray = (torch.abs(safe[0] - safe[1]) < 0.001) & (torch.abs(safe[1] - safe[2]) < 0.001)
    zero_w = (saturation_mask < 0.001) & (luminance_weight < 0.001)
    return torch.where(gray | zero_w, safe, result)


def apply_color_grading(rgb: torch.Tensor, cg, blending, balance) -> torch.Tensor:
    """3-way (+global) additive color grading (shader.wgsl:686-717).

    cg: (4, 3) rows = shadows, midtones, highlights, global of [hue, sat, lum].
    """
    l = luma(torch.clamp_min(rgb, 0.0))
    shadow_crossover = 0.1 + torch.clamp_min(-balance, 0.0) * 0.5
    highlight_crossover = 0.5 - torch.clamp_min(balance, 0.0) * 0.5
    feather = 0.2 * blending
    final_shadow_crossover = torch.minimum(shadow_crossover, highlight_crossover - 0.01)
    shadow_mask = 1.0 - smoothstep(
        final_shadow_crossover - feather, final_shadow_crossover + feather, l
    )
    highlight_mask = smoothstep(highlight_crossover - feather, highlight_crossover + feather, l)
    midtone_mask = torch.clamp_min(1.0 - shadow_mask - highlight_mask, 0.0)

    strengths = ((0.3, 0.5), (0.6, 0.8), (0.8, 1.0), (1.0, 1.0))
    masks = (shadow_mask, midtone_mask, highlight_mask, torch.ones_like(l))
    graded = rgb
    for i, ((sat_str, lum_str), m) in enumerate(zip(strengths, masks)):
        hue, sat, lum = cg[i][0], cg[i][1], cg[i][2]
        one = torch.ones_like(hue)
        tr, tg, tb = cs.hsv_to_rgb_channels(hue, one, one)
        amt = (sat * sat_str) * m
        contrib = torch.stack([(tr - 0.5) * amt, (tg - 0.5) * amt, (tb - 0.5) * amt])
        graded = graded + torch.where(sat > 0.001, contrib, 0.0)
        graded = graded + (lum * lum_str) * m
    return graded


def apply_color_calibration(rgb: torch.Tensor, cal) -> torch.Tensor:
    """Primary-hue skew + per-primary saturation + shadow tint
    (shader.wgsl:549-585). cal: (7,) = [shadows_tint, r_hue, r_sat, g_hue,
    g_sat, b_hue, b_sat]."""
    st, h_r, s_r, h_g, s_g, h_b, s_b = (cal[i] for i in range(7))
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    r_prime = (1.0 - torch.abs(h_r), torch.maximum(zero, h_r), torch.maximum(zero, -h_r))
    g_prime = (torch.maximum(zero, -h_g), 1.0 - torch.abs(h_g), torch.maximum(zero, h_g))
    b_prime = (torch.maximum(zero, h_b), torch.maximum(zero, -h_b), 1.0 - torch.abs(h_b))
    c = torch.stack(
        [
            r_prime[0] * rgb[0] + g_prime[0] * rgb[1] + b_prime[0] * rgb[2],
            r_prime[1] * rgb[0] + g_prime[1] * rgb[1] + b_prime[1] * rgb[2],
            r_prime[2] * rgb[0] + g_prime[2] * rgb[1] + b_prime[2] * rgb[2],
        ]
    )

    l = luma(torch.clamp_min(c, 0.0))
    sat_vector = c - l
    color_sum = torch.sum(c, dim=0)
    masks = torch.where(
        color_sum > 0.001, c / torch.where(color_sum == 0.0, 1.0, color_sum), 0.0
    )
    total_sat_adj = masks[0] * s_r + masks[1] * s_g + masks[2] * s_b
    c = c + sat_vector * total_sat_adj

    shadow_luma = luma(torch.clamp_min(c, 0.0))
    m = 1.0 - smoothstep(0.0, 0.3, shadow_luma)
    tinted = torch.stack(
        [
            mix(c[0], c[0] * (1.0 + st * 0.25), m),
            mix(c[1], c[1] * (1.0 - st * 0.25), m),
            mix(c[2], c[2] * (1.0 + st * 0.25), m),
        ]
    )
    return torch.where(torch.abs(st) > 0.001, tinted, c)
