"""Geometry parameter parsing (image_processing.rs:139-196 + :1146-1175)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GeometryParams:
    distortion: float = 0.0
    vertical: float = 0.0
    horizontal: float = 0.0
    rotate: float = 0.0
    aspect: float = 0.0
    scale: float = 100.0
    x_offset: float = 0.0
    y_offset: float = 0.0
    lens_distortion_amount: float = 1.0
    lens_vignette_amount: float = 1.0
    lens_tca_amount: float = 1.0
    lens_distortion_enabled: bool = True
    lens_tca_enabled: bool = True
    lens_vignette_enabled: bool = True
    lens_dist_k1: float = 0.0
    lens_dist_k2: float = 0.0
    lens_dist_k3: float = 0.0
    lens_model: int = 0  # 0 = poly3/5-style, 1 = ptlens
    tca_vr: float = 1.0
    tca_vb: float = 1.0
    vig_k1: float = 0.0
    vig_k2: float = 0.0
    vig_k3: float = 0.0


def _f(js: dict, key: str, default: float) -> float:
    v = js.get(key)
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default


def geometry_params_from_json(js: dict) -> GeometryParams:
    """Port of get_geometry_params_from_json (image_processing.rs:139-196)."""
    lens = js.get("lensDistortionParams")
    lens = lens if isinstance(lens, dict) else {}
    return GeometryParams(
        distortion=_f(js, "transformDistortion", 0.0),
        vertical=_f(js, "transformVertical", 0.0),
        horizontal=_f(js, "transformHorizontal", 0.0),
        rotate=_f(js, "transformRotate", 0.0),
        aspect=_f(js, "transformAspect", 0.0),
        scale=_f(js, "transformScale", 100.0),
        x_offset=_f(js, "transformXOffset", 0.0),
        y_offset=_f(js, "transformYOffset", 0.0),
        lens_distortion_amount=_f(js, "lensDistortionAmount", 100.0) / 100.0,
        lens_vignette_amount=_f(js, "lensVignetteAmount", 100.0) / 100.0,
        lens_tca_amount=_f(js, "lensTcaAmount", 100.0) / 100.0,
        lens_distortion_enabled=bool(js.get("lensDistortionEnabled", True)),
        lens_tca_enabled=bool(js.get("lensTcaEnabled", True)),
        lens_vignette_enabled=bool(js.get("lensVignetteEnabled", True)),
        lens_dist_k1=_f(lens, "k1", 0.0),
        lens_dist_k2=_f(lens, "k2", 0.0),
        lens_dist_k3=_f(lens, "k3", 0.0),
        lens_model=int(lens.get("model", 0) or 0),
        tca_vr=_f(lens, "tca_vr", 1.0),
        tca_vb=_f(lens, "tca_vb", 1.0),
        vig_k1=_f(lens, "vig_k1", 0.0),
        vig_k2=_f(lens, "vig_k2", 0.0),
        vig_k3=_f(lens, "vig_k3", 0.0),
    )


def is_geometry_identity(p: GeometryParams) -> bool:
    """Port of is_geometry_identity (image_processing.rs:1146-1175)."""
    dist_identity = (not p.lens_distortion_enabled) or (
        abs(p.lens_distortion_amount - 1.0) < 1e-4
        and abs(p.lens_dist_k1) < 1e-6
        and abs(p.lens_dist_k2) < 1e-6
        and abs(p.lens_dist_k3) < 1e-6
    )
    tca_identity = (not p.lens_tca_enabled) or (
        abs(p.lens_tca_amount - 1.0) < 1e-4
        and abs(p.tca_vr - 1.0) < 1e-6
        and abs(p.tca_vb - 1.0) < 1e-6
    )
    vig_identity = (not p.lens_vignette_enabled) or (
        abs(p.lens_vignette_amount - 1.0) < 1e-4
        and abs(p.vig_k1) < 1e-6
        and abs(p.vig_k2) < 1e-6
        and abs(p.vig_k3) < 1e-6
    )
    return (
        p.distortion == 0.0
        and p.vertical == 0.0
        and p.horizontal == 0.0
        and p.rotate == 0.0
        and p.aspect == 0.0
        and p.scale == 100.0
        and p.x_offset == 0.0
        and p.y_offset == 0.0
        and dist_identity
        and tca_identity
        and vig_identity
    )
