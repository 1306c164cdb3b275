"""Adjustment-JSON -> device parameters + static specialization config.

Port of the reference's semantic contract `get_all_adjustments_from_json`
(src-tauri/src/image_processing.rs:2289-2321) and its helpers
(:1869-2287): UI slider values normalized through SCALES, per-section
`sectionVisibility` gating (:1874-1895), curve point packing (:1551-1564),
mask adjustment stacks (:2158-2287, max 32 visible masks :2303-2311).

A NumPy-only copy of `rapidraw_tpu.params.parse` (importing that module
pulls in the JAX package through `rapidraw_tpu/__init__.py`). It emits
  * `DevelopParams` — a tree of numpy arrays carrying every *value*, and
  * `DevelopConfig` — a hashable dataclass of activity flags. The plain
    PyTorch chain skips provably-identity stages with them; the CUDA grade
    kernel reads them as a uniform runtime bitmask, the analog of the
    shader's `if (param != 0)` early-outs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from rapidraw_tpu_torch.params import scales
from rapidraw_tpu_torch.params.agx import AGX_PIPE_TO_RENDERING, AGX_RENDERING_TO_PIPE
from rapidraw_tpu_torch.params.curves import (
    bake_curve_set,
    curve_set_is_identity,
    used_segments,
)

# HSL band order (image_processing.rs:1510-1519).
HSL_BANDS = ("reds", "oranges", "yellows", "greens", "aquas", "blues", "purples", "magentas")

# Color-grading band order used in the (4,3) `cg` array.
CG_BANDS = ("shadows", "midtones", "highlights", "global")

# Scalar fields shared by the global and per-mask adjustment sets:
# (json_key, param_key, section, scale, default_slider_value)
_SHARED_FIELDS = (
    ("exposure", "exposure", "basic", scales.EXPOSURE, 0.0),
    ("brightness", "brightness", "basic", scales.BRIGHTNESS, 0.0),
    ("contrast", "contrast", "basic", scales.CONTRAST, 0.0),
    ("highlights", "highlights", "basic", scales.HIGHLIGHTS, 0.0),
    ("shadows", "shadows", "basic", scales.SHADOWS, 0.0),
    ("whites", "whites", "basic", scales.WHITES, 0.0),
    ("blacks", "blacks", "basic", scales.BLACKS, 0.0),
    ("saturation", "saturation", "color", scales.SATURATION, 0.0),
    ("temperature", "temperature", "color", scales.TEMPERATURE, 0.0),
    ("tint", "tint", "color", scales.TINT, 0.0),
    ("vibrance", "vibrance", "color", scales.VIBRANCE, 0.0),
    ("hue", "hue", "color", 1.0, 0.0),
    ("sharpness", "sharpness", "details", scales.SHARPNESS, 0.0),
    ("lumaNoiseReduction", "luma_nr", "details", scales.LUMA_NOISE_REDUCTION, 0.0),
    ("colorNoiseReduction", "color_nr", "details", scales.COLOR_NOISE_REDUCTION, 0.0),
    ("clarity", "clarity", "details", scales.CLARITY, 0.0),
    ("dehaze", "dehaze", "details", scales.DEHAZE, 0.0),
    ("structure", "structure", "details", scales.STRUCTURE, 0.0),
    ("glowAmount", "glow", "effects", scales.GLOW, 0.0),
    ("halationAmount", "halation", "effects", scales.HALATION, 0.0),
    ("flareAmount", "flare", "effects", scales.FLARES, 0.0),
)

# Fields per-pixel blended by mask influence into the effective parameter
# maps (shader.wgsl:1503-1525). sharpness / sharpness_threshold are NOT
# blended — mask sharpening is applied as an output delta (:1562-1576).
BLEND_FIELDS = (
    "exposure",
    "brightness",
    "contrast",
    "highlights",
    "shadows",
    "whites",
    "blacks",
    "saturation",
    "temperature",
    "tint",
    "vibrance",
    "luma_nr",
    "color_nr",
    "clarity",
    "dehaze",
    "structure",
    "glow",
    "halation",
    "flare",
    "hue",
)

DevelopParams = dict[str, Any]  # {'glob': {...}, 'mask': {...} | None}


@dataclass(frozen=True)
class DevelopConfig:
    """Activity flags of a document or a batch. Hashable. The plain chain
    skips provably-identity stages with them; the CUDA grade kernel reads
    them as a runtime bitmask (pipeline/fused.py FLAGS).

    Flags are *conservative over the batch*: a stage is skipped only when it
    is identity for every image the compiled function will see. Per-pixel
    exactness within an active stage is preserved with masked (where) math.
    """

    is_raw: bool = False
    tonemapper_agx: bool = False
    show_clipping: bool = False
    mask_count: int = 0
    has_lut: bool = False

    ca_active: bool = False
    nr_active: bool = False
    # STATIC NR amounts (None => masked/per-pixel amounts: the exact gather
    # path). Amounts come from the document, so for unmasked NR the tap
    # grid is known when tracing and the TPU path uses static edge-clamped
    # shifts (jitter dropped — see ops/nr.py) instead of gathers, which
    # cost seconds per 24MP frame on TPU.
    nr_static_luma: float | None = None
    nr_static_color: float | None = None
    # CA shifts are global-only, so always doc-static: the separable
    # constant-index resample replaces the 2D gather (437 ms -> 6 ms @24MP)
    ca_static_rc: float = 0.0
    ca_static_by: float = 0.0
    sharpness_active: bool = False
    mask_sharpness_active: bool = False
    clarity_active: bool = False
    structure_active: bool = False
    centre_active: bool = False
    exposure_active: bool = False
    glow_active: bool = False
    halation_active: bool = False
    flare_active: bool = False
    dehaze_active: bool = False
    wb_active: bool = False
    brightness_active: bool = False
    tonal_active: bool = False  # contrast/shadows/whites/blacks
    tonal_blur_needed: bool = False  # shadows/blacks (spatial mult input)
    highlights_active: bool = False
    calibration_active: bool = False
    hsl_active: bool = False
    hue_active: bool = False
    creative_active: bool = False  # saturation / vibrance
    cg_active: bool = False  # global color grading
    mask_cg_active: bool = False
    mask_hsl_active: bool = False
    # per-band static activity of the HSL mixer, GLOBAL ∪ MASK params:
    # a band whose hue/sat/lum are all zero in the doc contributes exactly
    # zero to the weighted totals (the influence normalizer still sums all
    # 8 bands) — its contraction terms compile out (~8 vector ops/px each)
    hsl_band_active: tuple = (True,) * 8
    # blendable fields with a non-zero value in at least one mask — only
    # these get per-pixel effective-parameter maps (others stay scalars)
    mask_blend_fields: tuple = ()
    # per entry of mask_blend_fields: the mask indices whose value for that
    # field is non-zero — the blend loop skips the rest (a typical 3-mask
    # doc touches 2-3 fields per mask, so this cuts the per-pixel
    # influence-FMA count ~2-3x inside the megakernel)
    mask_blend_masks: tuple = ()
    # blur-pyramid levels whose consumers' GLOBAL amounts are all statically
    # zero (only masks drive them): ((level_key, contributing_mask_indices),
    # ...). Outside those masks' support the effective amount is exactly 0
    # and every consumer is exactly identity, so the level only needs to be
    # computed over the masks' row band (pipeline.bands.blur_band_rows) —
    # the TPU analog of the reference only paying for blur texels a mask
    # actually reads (shader.wgsl consumers are amount-gated per pixel).
    blur_band_masks: tuple = ()
    vignette_active: bool = False
    curves_active: bool = False
    mask_curves_active: bool = False
    # static segment-row count for curve eval (most curves use 1-4 of the
    # 15 slots; trimming cuts the branch-free eval cost proportionally)
    curve_segments: int = 15
    # union flag: any document in the batch has non-default R/G/B curves
    # (the luma-preserving rgb path compiles out when False)
    rgb_curves_maybe_active: bool = False
    grain_active: bool = False
    dither_active: bool = True

    @property
    def sharpness_blur_needed(self) -> bool:
        return self.sharpness_active or self.mask_sharpness_active

    @property
    def clarity_blur_needed(self) -> bool:
        # clarity blur feeds clarity, centre local contrast and halation
        # (gpu_processing.rs:1404 binding; shader.wgsl:1578,1580,1591).
        return self.clarity_active or self.centre_active or self.halation_active

    @property
    def structure_blur_needed(self) -> bool:
        # structure blur feeds structure, dehaze and glow
        # (shader.wgsl:1579,1585,1612).
        return self.structure_active or self.dehaze_active or self.glow_active


def _get(js: dict, key: str, default: float) -> float:
    v = js.get(key)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return default


def _visible(js: dict, section: str) -> bool:
    vis = js.get("sectionVisibility")
    if isinstance(vis, dict):
        v = vis.get(section)
        if isinstance(v, bool):
            return v
    return True


def _parse_hsl(js: dict) -> np.ndarray:
    """(8,3) [hue, saturation, luminance] per band (image_processing.rs:1507-1535)."""
    out = np.zeros((8, 3), np.float32)
    hsl = js.get("hsl")
    if isinstance(hsl, dict):
        for i, band in enumerate(HSL_BANDS):
            c = hsl.get(band)
            if isinstance(c, dict):
                out[i, 0] = _get(c, "hue", 0.0) * scales.HSL_HUE_MULTIPLIER
                out[i, 1] = _get(c, "saturation", 0.0) / scales.HSL_SATURATION
                out[i, 2] = _get(c, "luminance", 0.0) / scales.HSL_LUMINANCE
    return out


def _parse_color_grading(js: dict) -> tuple[np.ndarray, float, float]:
    """(4,3) [hue, sat, lum] per band + (blending, balance).

    image_processing.rs:1537-1549, 2093-2122. hue is in degrees (unscaled).
    """
    cg = js.get("colorGrading")
    cg = cg if isinstance(cg, dict) else {}
    out = np.zeros((4, 3), np.float32)
    for i, band in enumerate(CG_BANDS):
        b = cg.get(band)
        if isinstance(b, dict):
            out[i, 0] = _get(b, "hue", 0.0)
            out[i, 1] = _get(b, "saturation", 0.0) / scales.COLOR_GRADING_SATURATION
            out[i, 2] = _get(b, "luminance", 0.0) / scales.COLOR_GRADING_LUMINANCE
    blending = _get(cg, "blending", 50.0) / scales.COLOR_GRADING_BLENDING
    balance = _get(cg, "balance", 0.0) / scales.COLOR_GRADING_BALANCE
    return out, blending, balance


def _parse_curves(js: dict) -> dict[str, np.ndarray]:
    """Bake curves honoring section visibility (image_processing.rs:1900-1939).

    Hidden curves section -> zero-point curves (identity at eval, and the
    shader's rgb_active classification of empty curves is reproduced by
    bake_curve_set).
    """
    if _visible(js, "curves"):
        curves = js.get("curves")
        curves = curves if isinstance(curves, dict) else None
        return bake_curve_set(curves)
    return bake_curve_set({"luma": [], "red": [], "green": [], "blue": []})


def _shared_set(js: dict, hue_visible_section: str = "color") -> dict[str, Any]:
    """Parse the scalar fields + hsl + cg + curves shared by global & masks."""
    out: dict[str, Any] = {}
    for json_key, param_key, section, scale, default in _SHARED_FIELDS:
        if _visible(js, section):
            out[param_key] = np.float32(_get(js, json_key, default) / scale)
        else:
            out[param_key] = np.float32(0.0)
    # sharpness_threshold has a non-zero default of 15 (image_processing.rs:
    # 2149-2154 global; :2231 mask uses plain get_val -> 0 when hidden).
    if _visible(js, "details"):
        out["sharpness_threshold"] = np.float32(
            _get(js, "sharpnessThreshold", 15.0) / scales.SHARPNESS_THRESHOLD
        )
    else:
        out["sharpness_threshold"] = np.float32(0.15)
    if _visible(js, "color"):
        out["hsl"] = _parse_hsl(js)
        cg, blend, bal = _parse_color_grading(js)
    else:
        out["hsl"] = np.zeros((8, 3), np.float32)
        cg, blend, bal = np.zeros((4, 3), np.float32), 0.5, 0.0
    out["cg"] = cg
    out["cg_blending"] = np.float32(blend)
    out["cg_balance"] = np.float32(bal)
    out["curves"] = _parse_curves(js)
    return out


def _parse_calibration(js: dict) -> np.ndarray:
    """(7,) [shadows_tint, red_hue, red_sat, green_hue, green_sat, blue_hue,
    blue_sat] (image_processing.rs:1951-1971)."""
    out = np.zeros(7, np.float32)
    if not _visible(js, "color"):
        return out
    cal = js.get("colorCalibration")
    cal = cal if isinstance(cal, dict) else {}
    h, s = scales.COLOR_CALIBRATION_HUE, scales.COLOR_CALIBRATION_SATURATION
    out[0] = _get(cal, "shadowsTint", 0.0) / h
    out[1] = _get(cal, "redHue", 0.0) / h
    out[2] = _get(cal, "redSaturation", 0.0) / s
    out[3] = _get(cal, "greenHue", 0.0) / h
    out[4] = _get(cal, "greenSaturation", 0.0) / s
    out[5] = _get(cal, "blueHue", 0.0) / h
    out[6] = _get(cal, "blueSaturation", 0.0) / s
    return out


def _parse_global(
    js: dict, is_raw: bool, tonemapper_override: int | None
) -> tuple[dict[str, Any], dict[str, Any]]:
    g = _shared_set(js)

    # details-section extras (image_processing.rs:2024, 2053-2064)
    if _visible(js, "details"):
        g["centre"] = np.float32(_get(js, "centré", 0.0) / scales.CENTRE)
        g["ca_rc"] = np.float32(
            _get(js, "chromaticAberrationRedCyan", 0.0) / scales.CHROMATIC_ABERRATION
        )
        g["ca_by"] = np.float32(
            _get(js, "chromaticAberrationBlueYellow", 0.0) / scales.CHROMATIC_ABERRATION
        )
    else:
        g["centre"] = np.float32(0.0)
        g["ca_rc"] = np.float32(0.0)
        g["ca_by"] = np.float32(0.0)

    # effects-section extras with non-zero defaults (:2025-2051)
    eff = _visible(js, "effects")

    def eff_val(key: str, scale: float, default: float) -> np.float32:
        if eff:
            return np.float32(_get(js, key, default) / scale)
        return np.float32(default / scale)

    g["vignette_amount"] = eff_val("vignetteAmount", scales.VIGNETTE_AMOUNT, 0.0)
    g["vignette_midpoint"] = eff_val("vignetteMidpoint", scales.VIGNETTE_MIDPOINT, 50.0)
    g["vignette_roundness"] = eff_val("vignetteRoundness", scales.VIGNETTE_ROUNDNESS, 0.0)
    g["vignette_feather"] = eff_val("vignetteFeather", scales.VIGNETTE_FEATHER, 50.0)
    g["grain_amount"] = eff_val("grainAmount", scales.GRAIN_AMOUNT, 0.0)
    g["grain_size"] = eff_val("grainSize", scales.GRAIN_SIZE, 25.0)
    g["grain_roughness"] = eff_val("grainRoughness", scales.GRAIN_ROUGHNESS, 50.0)

    # LUT (:1976-1987): hidden effects -> (off, 1.0)
    if eff:
        g["lut_intensity"] = np.float32(_get(js, "lutIntensity", 100.0) / 100.0)
        has_lut = isinstance(js.get("lutPath"), str)
    else:
        g["lut_intensity"] = np.float32(1.0)
        has_lut = False

    g["calibration"] = _parse_calibration(js)
    g["agx_p2r"] = AGX_PIPE_TO_RENDERING.copy()
    g["agx_r2p"] = AGX_RENDERING_TO_PIPE.copy()

    tone_mapper = js.get("toneMapper", "basic")
    if tonemapper_override is not None:
        tm_agx = tonemapper_override == 1
    else:
        tm_agx = tone_mapper == "agx"

    meta = {
        "has_lut": has_lut,
        "tonemapper_agx": tm_agx,
        "show_clipping": bool(js.get("showClipping", False)),
        "is_raw": is_raw,
    }
    return g, meta


def _stack_sets(sets: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack N parsed adjustment sets into arrays with a leading (N,) dim."""
    out: dict[str, Any] = {}
    for key in sets[0]:
        if key == "curves":
            out["curves"] = {
                k: np.stack([s["curves"][k] for s in sets]) for k in sets[0]["curves"]
            }
        else:
            out[key] = np.stack([np.asarray(s[key]) for s in sets])
    return out


def _nz(*vals: float) -> bool:
    return any(abs(float(v)) > 0.0 for v in vals)


def parse_adjustments(
    js: dict | None,
    is_raw: bool = False,
    tonemapper_override: int | None = None,
) -> tuple[DevelopParams, DevelopConfig]:
    """Parse one adjustment document.

    Returns (params, config). `params` is a numpy tree (the pipeline moves
    it to the image's device); `config` the activity flags for
    this document alone — batch several documents with `merge_configs` +
    `stack_params`.
    """
    js = js or {}
    g, meta = _parse_global(js, is_raw, tonemapper_override)

    mask_sets: list[dict[str, Any]] = []
    masks_json = js.get("masks")
    if isinstance(masks_json, list):
        for m in masks_json:
            if not isinstance(m, dict) or not m.get("visible", False):
                continue
            if len(mask_sets) >= scales.MAX_MASKS:
                break
            adj = m.get("adjustments")
            mask_sets.append(_shared_set(adj if isinstance(adj, dict) else {}))

    params: DevelopParams = {
        "glob": g,
        "mask": _stack_sets(mask_sets) if mask_sets else None,
    }

    def any_field(key: str) -> bool:
        vals = [g[key]] + [m[key] for m in mask_sets]
        return _nz(*vals)

    def any_pos(key: str) -> bool:
        # stages gated on amount > 0 can still fire with a negative global
        # plus mask influence sums — treat any non-zero as potentially active
        return any_field(key)

    mask_curves_active = any(not curve_set_is_identity(m["curves"]) for m in mask_sets)
    mask_cg_active = any(
        (np.abs(m["cg"][:, 1:]) > 1e-12).any() for m in mask_sets
    )
    mask_blend_fields = tuple(
        f for f in BLEND_FIELDS if any(_nz(m[f]) for m in mask_sets)
    )
    mask_blend_masks = tuple(
        tuple(n for n, m in enumerate(mask_sets) if _nz(m[f]))
        for f in mask_blend_fields
    )
    mask_hsl_active = any((np.abs(m["hsl"]) > 0).any() for m in mask_sets)

    # band-restrictable blur levels: the level's global consumers are ALL
    # statically zero and at least one mask drives a consumer field.
    # Per-level consumers follow the *_blur_needed properties:
    #   sharp     <- sharpness (global + mask)
    #   tonal     <- shadows/blacks spatial multiplier
    #   clarity   <- clarity, centre (global-only), halation
    #   structure <- structure, dehaze, glow
    def _contrib(*keys):
        return tuple(sorted({
            n for k in keys for n, mset in enumerate(mask_sets) if _nz(mset[k])
        }))

    blur_band_masks = []
    for level, gkeys, mkeys in (
        ("sharp", ("sharpness",), ("sharpness",)),
        ("tonal", ("shadows", "blacks"), ("shadows", "blacks")),
        ("clarity", ("clarity", "centre", "halation"), ("clarity", "halation")),
        ("structure", ("structure", "dehaze", "glow"),
         ("structure", "dehaze", "glow")),
    ):
        idx = _contrib(*mkeys)
        if idx and not _nz(*[g[k] for k in gkeys]):
            blur_band_masks.append((level, idx))

    cfg = DevelopConfig(
        is_raw=is_raw,
        tonemapper_agx=meta["tonemapper_agx"],
        show_clipping=meta["show_clipping"],
        mask_count=len(mask_sets),
        has_lut=meta["has_lut"],
        ca_active=_nz(g["ca_rc"], g["ca_by"]),
        ca_static_rc=float(g["ca_rc"]),
        ca_static_by=float(g["ca_by"]),
        nr_active=any_field("luma_nr") or any_field("color_nr"),
        nr_static_luma=(
            float(np.clip(g["luma_nr"], 0.0, 1.0))
            if not any(_nz(m["luma_nr"]) for m in mask_sets) else None
        ),
        nr_static_color=(
            float(np.clip(g["color_nr"], 0.0, 1.0))
            if not any(_nz(m["color_nr"]) for m in mask_sets) else None
        ),
        sharpness_active=_nz(g["sharpness"]),
        mask_sharpness_active=any(_nz(m["sharpness"]) for m in mask_sets),
        clarity_active=any_field("clarity"),
        structure_active=any_field("structure"),
        centre_active=_nz(g["centre"]),
        exposure_active=any_field("exposure"),
        glow_active=any_pos("glow"),
        halation_active=any_pos("halation"),
        flare_active=any_pos("flare"),
        dehaze_active=any_field("dehaze"),
        wb_active=any_field("temperature") or any_field("tint"),
        brightness_active=any_field("brightness"),
        tonal_active=(
            any_field("contrast")
            or any_field("shadows")
            or any_field("whites")
            or any_field("blacks")
        ),
        tonal_blur_needed=any_field("shadows") or any_field("blacks"),
        highlights_active=any_field("highlights"),
        calibration_active=bool((np.abs(g["calibration"]) > 0).any()),
        hsl_active=bool(
            (np.abs(g["hsl"]) > 0).any()
            or any((np.abs(m["hsl"]) > 0).any() for m in mask_sets)
        ),
        hue_active=any_field("hue"),
        creative_active=any_field("saturation") or any_field("vibrance"),
        cg_active=bool((np.abs(g["cg"][:, 1:]) > 1e-12).any()),
        mask_cg_active=mask_cg_active,
        mask_hsl_active=mask_hsl_active,
        hsl_band_active=tuple(
            bool(
                (np.abs(g["hsl"][band]) > 0).any()
                or any((np.abs(m["hsl"][band]) > 0).any() for m in mask_sets)
            )
            for band in range(8)
        ),
        mask_blend_fields=mask_blend_fields,
        mask_blend_masks=mask_blend_masks,
        blur_band_masks=tuple(blur_band_masks),
        vignette_active=_nz(g["vignette_amount"]),
        curves_active=not curve_set_is_identity(g["curves"]),
        mask_curves_active=mask_curves_active,
        curve_segments=max(
            [used_segments(g["curves"])] + [used_segments(m["curves"]) for m in mask_sets]
        ),
        rgb_curves_maybe_active=bool(
            float(g["curves"]["rgb_active"]) != 0.0
            or any(float(m["curves"]["rgb_active"]) != 0.0 for m in mask_sets)
        ),
        grain_active=float(g["grain_amount"]) > 0.0,
    )
    return params, cfg


def merge_configs(configs: list[DevelopConfig]) -> DevelopConfig:
    """Union of activity across a batch (all images share one compilation)."""
    if not configs:
        return DevelopConfig()
    fields = {}
    for name in DevelopConfig.__dataclass_fields__:
        vals = [getattr(c, name) for c in configs]
        if name in ("mask_count", "curve_segments"):
            fields[name] = max(vals)
        elif name == "mask_blend_fields":
            fields[name] = tuple(f for f in BLEND_FIELDS if any(f in v for v in vals))
        elif name == "mask_blend_masks":
            merged_fields = tuple(
                f for f in BLEND_FIELDS
                if any(f in c.mask_blend_fields for c in configs)
            )
            def _masks_for(c, f):
                # mirror grade.blend_mask_indices: configs whose
                # mask_blend_masks is shorter than mask_blend_fields
                # (pre-gating caches / hand-built configs) blend all masks
                i = c.mask_blend_fields.index(f)
                if i < len(c.mask_blend_masks):
                    return c.mask_blend_masks[i]
                return tuple(range(c.mask_count))

            fields[name] = tuple(
                tuple(sorted({
                    n
                    for c in configs
                    if f in c.mask_blend_fields
                    for n in _masks_for(c, f)
                }))
                for f in merged_fields
            )
        elif name == "blur_band_masks":
            # a level stays band-restricted only if EVERY doc that needs it
            # is band-eligible (one global consumer anywhere forces the full
            # level); contributing mask indices union across docs
            needed = {
                "sharp": lambda c: c.sharpness_blur_needed,
                "tonal": lambda c: c.tonal_blur_needed,
                "clarity": lambda c: c.clarity_blur_needed,
                "structure": lambda c: c.structure_blur_needed,
            }
            merged = []
            for key in ("sharp", "tonal", "clarity", "structure"):
                per_doc = [dict(c.blur_band_masks).get(key) for c in configs]
                if any(d is not None for d in per_doc) and all(
                    d is not None or not needed[key](c)
                    for c, d in zip(configs, per_doc)
                ):
                    merged.append((key, tuple(sorted(
                        {n for d in per_doc if d for n in d}
                    ))))
            fields[name] = tuple(merged)
        elif name in ("is_raw", "tonemapper_agx"):
            if len(set(vals)) > 1:
                raise ValueError(f"cannot batch mixed {name!r} documents in one compile")
            fields[name] = vals[0]
        elif name in ("nr_static_luma", "nr_static_color"):
            # static only if identical across the batch; else per-pixel path
            fields[name] = vals[0] if len(set(vals)) == 1 else None
        elif name == "hsl_band_active":
            fields[name] = tuple(
                any(v[band] for v in vals) for band in range(8)
            )
        elif name in ("ca_static_rc", "ca_static_by"):
            if len(set(vals)) > 1:
                raise ValueError(
                    "cannot batch documents with different chromatic-"
                    "aberration amounts in one compile (bucket by config)"
                )
            fields[name] = vals[0]
        else:
            fields[name] = any(vals)
    return DevelopConfig(**fields)


def is_image_edited(
    adjustments: dict | None,
    is_raw: bool = False,
    tonemapper_override: int | None = None,
) -> bool:
    """Does this document change the image at all?
    (image_processing.rs:1797-1867: structural checks, then a bit-compare
    of parsed params against the defaults — here a tree-equality of the
    parsed pytree plus the static config.)

    Used by thumbnails to skip the develop pipeline for unedited files.
    """
    if not isinstance(adjustments, dict) or not adjustments:
        return False
    if adjustments.get("aiPatches"):
        return True
    if adjustments.get("masks"):
        return True
    crop = adjustments.get("crop")
    if isinstance(crop, dict) and (
        abs(float(crop.get("x", 0.0))) > 0.1 or abs(float(crop.get("y", 0.0))) > 0.1
    ):
        # deliberately x/y-only, matching image_processing.rs:1817-1823:
        # without the image dims a width/height check can't distinguish a
        # real crop from the full-size crop rect the frontend writes for
        # uncropped images — an origin-anchored crop is the accepted miss.
        return True
    if int(adjustments.get("orientationSteps", 0) or 0) != 0:
        return True
    if abs(float(adjustments.get("rotation", 0.0) or 0.0)) > 0.001:
        return True
    if adjustments.get("flipHorizontal") or adjustments.get("flipVertical"):
        return True

    from rapidraw_tpu_torch.geometry.params import (
        geometry_params_from_json,
        is_geometry_identity,
    )

    if not is_geometry_identity(geometry_params_from_json(adjustments)):
        return True

    cur_p, cur_c = parse_adjustments(adjustments, is_raw, tonemapper_override)
    def_p, def_c = parse_adjustments({}, is_raw, tonemapper_override)
    if cur_c != def_c:
        return True
    return not _trees_equal(cur_p, def_p)


def _trees_equal(a, b) -> bool:
    """Structural equality of two parsed param trees (dicts of arrays/None)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or a.keys() != b.keys():
            return False
        return all(_trees_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))
