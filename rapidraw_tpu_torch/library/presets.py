"""Adjustment presets.

Copy of `rapidraw_tpu/library/presets.py` (host Python); the auto
adjustments load each image through the port's `load_image` on the
caller's device (the CUDA device unless asked) and analyse it there.

Port of the reference preset store (file_management.rs:2521-2757): named
adjustment documents (optionally organized in folders), stored as JSON;
`apply_preset` merges a preset's adjustments over an image's current ones
respecting the copy/paste-style section granularity. Community presets are
the same format imported from arbitrary JSON files.
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path

# top-level adjustment keys per section (mirrors the frontend's Sections map)
SECTION_KEYS = {
    "basic": (
        "exposure", "brightness", "contrast", "highlights", "shadows",
        "whites", "blacks",
    ),
    "color": (
        "saturation", "temperature", "tint", "vibrance", "hue", "hsl",
        "colorGrading", "colorCalibration",
    ),
    "curves": ("curves", "pointCurves", "parametricCurve", "curveMode"),
    "details": (
        "sharpness", "sharpnessThreshold", "lumaNoiseReduction",
        "colorNoiseReduction", "clarity", "dehaze", "structure", "centré",
        "chromaticAberrationRedCyan", "chromaticAberrationBlueYellow",
    ),
    "effects": (
        "vignetteAmount", "vignetteMidpoint", "vignetteRoundness",
        "vignetteFeather", "grainAmount", "grainSize", "grainRoughness",
        "glowAmount", "halationAmount", "flareAmount", "lutPath",
        "lutIntensity", "toneMapper",
    ),
}


class PresetStore:
    """JSON-file preset store: [{id, name, folder, adjustments}]."""

    def __init__(self, store_path: str | Path):
        self.store_path = Path(store_path)
        self._presets: list[dict] = []
        if self.store_path.exists():
            try:
                data = json.loads(self.store_path.read_text())
                if isinstance(data, list):
                    self._presets = data
            except (OSError, json.JSONDecodeError):
                pass

    def _save(self) -> None:
        self.store_path.parent.mkdir(parents=True, exist_ok=True)
        self.store_path.write_text(json.dumps(self._presets, indent=2, ensure_ascii=False))

    def list(self) -> list[dict]:
        return list(self._presets)

    def get(self, name: str) -> dict | None:
        for p in self._presets:
            if p.get("name") == name:
                return p
        return None

    # sentinel: delete() matches any folder unless one is named
    _ANY_FOLDER = object()

    def add(self, name: str, adjustments: dict, folder: str | None = None) -> dict:
        preset = {
            "id": str(uuid.uuid4()),
            "name": name,
            "folder": folder,
            "adjustments": adjustments,
        }
        # same-named presets in OTHER folders coexist (the reference keys
        # presets by id within folders); only the (name, folder) pair is
        # replaced
        self._presets = [
            p for p in self._presets
            if not (p.get("name") == name and p.get("folder") == folder)
        ]
        self._presets.append(preset)
        self._save()
        return preset

    def delete(self, name: str, folder=_ANY_FOLDER) -> bool:
        before = len(self._presets)
        self._presets = [
            p for p in self._presets
            if p.get("name") != name
            or (folder is not self._ANY_FOLDER and p.get("folder") != folder)
        ]
        self._save()
        return len(self._presets) != before

    def import_file(self, path: str | Path) -> list[dict]:
        """Community/legacy preset import (file_management.rs:2643-2757):
        accepts a single preset object, a list, or a Lightroom .xmp preset
        (converted via library.preset_converter)."""
        if str(path).lower().endswith(".xmp"):
            from rapidraw_tpu_torch.library.preset_converter import convert_xmp_to_preset

            p = convert_xmp_to_preset(Path(path).read_text())
            return [self.add(p["name"], p["adjustments"])]
        data = json.loads(Path(path).read_text())
        if isinstance(data, dict) and isinstance(data.get("presets"), list):
            # the wrapper export_presets_to_file writes — unwrap so the
            # export/import round-trip works
            data = data["presets"]
        items = data if isinstance(data, list) else [data]
        imported = []
        for item in items:
            if not isinstance(item, dict):
                continue
            adjustments = item.get("adjustments")
            name = item.get("name") or Path(path).stem
            if isinstance(adjustments, dict):
                imported.append(self.add(name, adjustments, item.get("folder")))
        return imported


def apply_preset(
    current: dict, preset_adjustments: dict, sections: list[str] | None = None
) -> dict:
    """Merge preset adjustments over current ones.

    sections: restrict to these sections (copy/paste granularity,
    app_settings.rs CopyPasteSettings); None = all preset keys.
    """
    out = dict(current)
    if sections is None:
        out.update(preset_adjustments)
        return out
    allowed = set()
    for s in sections:
        allowed.update(SECTION_KEYS.get(s, ()))
    for k, v in preset_adjustments.items():
        if k in allowed:
            out[k] = v
    return out


def export_presets_to_file(presets: list[dict], file_path: str | Path) -> None:
    """Write a shareable preset file: {"creator": ..., "presets": [...]}
    (file_management.rs:2688-2700). Input items are PresetStore entries
    (name/adjustments/folder/id)."""
    doc = {"creator": "Anonymous", "presets": presets}
    Path(file_path).write_text(json.dumps(doc, indent=2, ensure_ascii=False))


# ------------------------------------------------- batch sidecar operations


def apply_adjustments_to_paths(paths: list[str], adjustments: dict,
                               lens_db=None) -> None:
    """Paste adjustments onto each image's sidecar: shallow key-merge over
    the existing document, then per-image lens-param resolution when a DB
    is supplied (file_management.rs:2147-2200)."""
    from rapidraw_tpu_torch.io.sidecar import load_sidecar, save_sidecar

    for path in paths:
        meta = load_sidecar(path)
        merged = dict(meta.get("adjustments") or {})
        merged.update(adjustments)
        if lens_db is not None:
            _resolve_lens_in_adjustments(merged, meta.get("exif"), lens_db)
        meta["adjustments"] = merged
        save_sidecar(path, meta)


def reset_adjustments_for_paths(paths: list[str]) -> None:
    """Reset each sidecar's adjustments to {} (file_management.rs:2246-2267)."""
    from rapidraw_tpu_torch.io.sidecar import load_sidecar, save_sidecar

    for path in paths:
        meta = load_sidecar(path)
        meta["adjustments"] = {}
        save_sidecar(path, meta)


def apply_auto_adjustments_to_paths(paths: list[str], device=None) -> None:
    """Compute the auto heuristic per image and merge it over the sidecar
    adjustments (file_management.rs:2318-2420); per-image isolation. Each
    image loads on `device` (the CUDA device unless asked)."""
    from rapidraw_tpu_torch.analysis.auto_adjust import calculate_auto_adjustments
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.io.sidecar import load_sidecar, save_sidecar

    for path in paths:
        try:
            planar, _ = load_image(path, device=device)
            auto = calculate_auto_adjustments(planar)
        except Exception:
            continue
        meta = load_sidecar(path)
        merged = dict(meta.get("adjustments") or {})
        merged.update(auto)
        meta["adjustments"] = merged
        save_sidecar(path, meta)


def _resolve_lens_in_adjustments(adjustments: dict, exif: dict | None,
                                 lens_db) -> None:
    """When the pasted doc enables an 'Auto'-style lens correction, refresh
    distortion params from this image's EXIF lens/focal (the paste target
    may be a different lens than the copy source,
    file_management.rs resolve_lens_params_in_adjustments)."""
    if not exif or not adjustments.get("lensDistortionAmount"):
        return
    model = exif.get("LensModel") or exif.get("Lens")
    maker = exif.get("LensMake") or exif.get("Make")
    focal = exif.get("FocalLength")
    if not (model and maker and focal):
        return
    try:
        tok = str(focal).split()[0]
        if "/" in tok:  # rational "467/10" = 46.7mm — divide, don't truncate
            num, den = tok.split("/", 1)
            focal_v = float(num) / float(den)
        else:
            focal_v = float(tok)
    except (ValueError, ZeroDivisionError):
        return
    from rapidraw_tpu_torch.lens.db import resolve_lens_params

    params = resolve_lens_params(lens_db, str(maker), str(model), focal_v)
    if params:
        adjustments["lensDistortionParams"] = params
