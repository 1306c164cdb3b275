"""Lightroom XMP preset -> RapidRAW preset converter.

Copy of `rapidraw_tpu/library/preset_converter.py` (host Python).

Port of preset_converter.rs: crs: attribute extraction, value rescaling
(shadows x1.5, sharpness /150, mired-space temperature, HSL hue x0.75),
split-toning/color-grade mapping, and PV2012 tone-curve transcription
with the shadow-lift dampening ramp (:45-92).
"""

from __future__ import annotations

import re
import uuid

_MAPPINGS = (
    ("Exposure2012", "exposure"),
    ("Contrast2012", "contrast"),
    ("Highlights2012", "highlights"),
    ("Whites2012", "whites"),
    ("Blacks2012", "blacks"),
    ("Clarity2012", "clarity"),
    ("Dehaze", "dehaze"),
    ("Vibrance", "vibrance"),
    ("Saturation", "saturation"),
    ("Texture", "structure"),
    ("SharpenRadius", "sharpenRadius"),
    ("SharpenDetail", "sharpenDetail"),
    ("SharpenEdgeMasking", "sharpenMasking"),
    ("LuminanceSmoothing", "lumaNoiseReduction"),
    ("ColorNoiseReduction", "colorNoiseReduction"),
    ("ColorNoiseReductionDetail", "colorNoiseDetail"),
    ("ColorNoiseReductionSmoothness", "colorNoiseSmoothness"),
    ("ChromaticAberrationRedCyan", "chromaticAberrationRedCyan"),
    ("ChromaticAberrationBlueYellow", "chromaticAberrationBlueYellow"),
    ("PostCropVignetteAmount", "vignetteAmount"),
    ("PostCropVignetteMidpoint", "vignetteMidpoint"),
    ("PostCropVignetteFeather", "vignetteFeather"),
    ("PostCropVignetteRoundness", "vignetteRoundness"),
    ("GrainAmount", "grainAmount"),
    ("GrainSize", "grainSize"),
    ("GrainFrequency", "grainRoughness"),
)

_HSL_BANDS = (
    ("Red", "reds"), ("Orange", "oranges"), ("Yellow", "yellows"),
    ("Green", "greens"), ("Aqua", "aquas"), ("Blue", "blues"),
    ("Purple", "purples"), ("Magenta", "magentas"),
)

_CG_ATTRS = (
    ("SplitToningShadowHue", "shadows", "hue"),
    ("ColorGradeMidtoneHue", "midtones", "hue"),
    ("SplitToningHighlightHue", "highlights", "hue"),
    ("SplitToningShadowSaturation", "shadows", "saturation"),
    ("ColorGradeMidtoneSat", "midtones", "saturation"),
    ("SplitToningHighlightSaturation", "highlights", "saturation"),
    ("ColorGradeShadowLum", "shadows", "luminance"),
    ("ColorGradeMidtoneLum", "midtones", "luminance"),
    ("ColorGradeHighlightLum", "highlights", "luminance"),
    ("ColorGradeGlobalHue", "global", "hue"),
    ("ColorGradeGlobalSat", "global", "saturation"),
    ("ColorGradeGlobalLum", "global", "luminance"),
)

_CURVES = (
    ("ToneCurvePV2012", "luma"),
    ("ToneCurvePV2012Red", "red"),
    ("ToneCurvePV2012Green", "green"),
    ("ToneCurvePV2012Blue", "blue"),
)


def _parse_num(s: str):
    """Integer-preserving numeric parse (preset_converter.rs:9-29)."""
    s = s.lstrip("+")
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return None


def _attr_f64(attrs: dict, key: str):
    v = attrs.get(key)
    if v is None:
        return None
    try:
        return float(v.lstrip("+"))
    except ValueError:
        return None


def _extract_name(xmp: str):
    m = re.search(
        r"<crs:Name>.*?<rdf:Alt>.*?<rdf:li[^>]*>([^<]+)</rdf:li>.*?</crs:Name>",
        xmp, re.S,
    )
    return m.group(1).strip() if m else None


def _extract_curve(xmp: str, curve_name: str):
    m = re.search(
        rf"<crs:{curve_name}>\s*<rdf:Seq>(.*?)</rdf:Seq>\s*</crs:{curve_name}>",
        xmp, re.S,
    )
    if not m:
        return None
    points = []
    for pm in re.finditer(r"<rdf:li>(\d+),\s*(\d+)</rdf:li>", m.group(1)):
        x, y = int(pm.group(1)), int(pm.group(2))
        final_y = y
        if curve_name == "ToneCurvePV2012" and y > x and x < 64:
            # dampen shadow lifts: LR's PV2012 shadow response is softer
            # than a raw point curve (preset_converter.rs:63-81)
            lift = float(y - x)
            progress = x / 64.0
            damp = 0.8 + 0.2 * progress
            final_y = int(round(min(max(x + lift * damp, 0.0), 255.0)))
        points.append({"x": x, "y": final_y})
    return points or None


def convert_xmp_to_preset(xmp_content: str) -> dict:
    """XMP text -> preset dict (preset_converter.rs:93-351)."""
    one_line = " ".join(xmp_content.split("\n"))
    attrs = dict(re.findall(r'crs:([A-Za-z0-9]+)="([^"]*)"', one_line))

    adjustments: dict = {}
    color_grading: dict = {}

    for xmp_key, rr_key in _MAPPINGS:
        raw = attrs.get(xmp_key)
        if raw is None:
            continue
        num = _parse_num(raw)
        if num is not None:
            adjustments[rr_key] = num
    raw = attrs.get("ColorGradeBlending")
    if raw is not None and (num := _parse_num(raw)) is not None:
        color_grading["blending"] = num

    if (v := _attr_f64(attrs, "Shadows2012")) is not None:
        adjustments["shadows"] = min(max(v * 1.5, -100.0), 100.0)
    if (v := _attr_f64(attrs, "Sharpness")) is not None:
        adjustments["sharpness"] = min(max(v / 150.0 * 100.0, 0.0), 100.0)
    if (v := _attr_f64(attrs, "Temperature")) is not None and v > 0:
        # v == 0 appears in non-raw presets (slider semantics, not Kelvin)
        as_shot = _attr_f64(attrs, "AsShotTemperature") or 5500.0
        mired_delta = 1e6 / v - 1e6 / max(as_shot, 1.0)
        adjustments["temperature"] = min(max(-mired_delta / 150.0 * 100.0, -100.0), 100.0)
    if (v := _attr_f64(attrs, "Tint")) is not None:
        adjustments["tint"] = min(max(v / 150.0 * 100.0, -100.0), 100.0)

    hsl = {}
    for src, dst in _HSL_BANDS:
        band = {}
        if (raw := attrs.get(f"HueAdjustment{src}")) is not None:
            num = _parse_num(raw)
            if num is not None:
                band["hue"] = float(num) * 0.75
        if (raw := attrs.get(f"SaturationAdjustment{src}")) is not None:
            num = _parse_num(raw)
            if num is not None:
                band["saturation"] = num
        if (raw := attrs.get(f"LuminanceAdjustment{src}")) is not None:
            num = _parse_num(raw)
            if num is not None:
                band["luminance"] = num
        if band:
            hsl[dst] = band
    if hsl:
        adjustments["hsl"] = hsl

    ranges: dict = {}
    for xmp_key, rng, field in _CG_ATTRS:
        raw = attrs.get(xmp_key)
        if raw is not None and (num := _parse_num(raw)) is not None:
            ranges.setdefault(rng, {})[field] = num
    if (raw := attrs.get("SplitToningBalance")) is not None:
        num = _parse_num(raw)
        if num is not None:
            color_grading["balance"] = num
    color_grading.update(ranges)
    if color_grading:
        adjustments["colorGrading"] = color_grading

    curves = {}
    for xmp_curve, rr_curve in _CURVES:
        pts = _extract_curve(xmp_content, xmp_curve)
        if pts:
            curves[rr_curve] = pts
    if curves:
        adjustments["curves"] = curves

    return {
        "id": str(uuid.uuid4()),
        "name": _extract_name(xmp_content) or "Imported Preset",
        "adjustments": adjustments,
        "includeMasks": False,
        "includeCropTransform": False,
        "presetType": "style",
    }
