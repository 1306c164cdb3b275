"""Adjustment normalization scales.

Port of the `SCALES: AdjustmentScales` table the reference uses to map UI
slider values (typically -100..100) to shader-space parameters
(src-tauri/src/image_processing.rs:1458-1505). Slider values are DIVIDED by
these, except HSL hue which is MULTIPLIED by `HSL_HUE_MULTIPLIER`
(image_processing.rs:1523-1524).
"""

EXPOSURE = 0.8
BRIGHTNESS = 0.8
CONTRAST = 100.0
HIGHLIGHTS = 120.0
SHADOWS = 120.0
WHITES = 30.0
BLACKS = 70.0
SATURATION = 100.0
TEMPERATURE = 25.0
TINT = 100.0
VIBRANCE = 100.0

SHARPNESS = 50.0
SHARPNESS_THRESHOLD = 100.0
LUMA_NOISE_REDUCTION = 100.0
COLOR_NOISE_REDUCTION = 100.0
CLARITY = 200.0
DEHAZE = 750.0
STRUCTURE = 200.0
CENTRE = 250.0

VIGNETTE_AMOUNT = 100.0
VIGNETTE_MIDPOINT = 100.0
VIGNETTE_ROUNDNESS = 100.0
VIGNETTE_FEATHER = 100.0
GRAIN_AMOUNT = 200.0
GRAIN_SIZE = 50.0
GRAIN_ROUGHNESS = 100.0

CHROMATIC_ABERRATION = 10000.0

HSL_HUE_MULTIPLIER = 0.3  # multiplied, not divided
HSL_SATURATION = 100.0
HSL_LUMINANCE = 100.0

COLOR_GRADING_SATURATION = 500.0
COLOR_GRADING_LUMINANCE = 500.0
COLOR_GRADING_BLENDING = 100.0
COLOR_GRADING_BALANCE = 200.0

COLOR_CALIBRATION_HUE = 400.0
COLOR_CALIBRATION_SATURATION = 120.0

GLOW = 100.0
HALATION = 100.0
FLARES = 100.0

# Maximum simultaneously-active masks (image_processing.rs:1396).
MAX_MASKS = 32

# Resolution all spatially-scaled parameters are referenced to
# (shader.wgsl:1443): blur radii, NR stride and grain frequency scale by
# min(W, H) / REFERENCE_DIMENSION, floored at 0.1.
REFERENCE_DIMENSION = 1080.0

# Base Gaussian blur radii of the four-level blur pyramid, multiplied by the
# resolution scale at dispatch time (gpu_processing.rs:1402-1405).
BLUR_RADIUS_SHARPNESS = 1.0
BLUR_RADIUS_TONAL = 3.5
BLUR_RADIUS_CLARITY = 8.0
BLUR_RADIUS_STRUCTURE = 40.0


def resolution_scale(width: int, height: int) -> float:
    """min(W,H)/1080 floored at 0.1 (shader.wgsl:1443-1446)."""
    return max(0.1, min(width, height) / REFERENCE_DIMENSION)


def blur_radius(base_radius: float, scale: float) -> int:
    """Integer pyramid radius: ceil(base*scale), min 1 (gpu_processing.rs:1327)."""
    import math

    return max(1, int(math.ceil(base_radius * scale)))
