"""Application settings.

Port of `rapidraw_tpu/utils/settings.py` (app_settings.rs, AppSettings
:329-612): a JSON settings document with the defaults the reference
ships, its load and save, the per-user app-data directory, and the typed
accessors of the engine knobs (RAW develop, preview size and quality,
cache size). UI-only knobs are carried as opaque fields, so settings files
are interchangeable; unknown keys round-trip untouched.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Any

DEFAULTS: dict[str, Any] = {
    "lastRootPath": None,
    "rootFolders": [],
    "pinnedFolders": [],
    "thumbnailResolution": 720,
    "editorPreviewResolution": 1920,
    "enableZoomHifi": True,
    "useFullDpiRendering": False,
    "enableLivePreviews": True,
    "livePreviewQuality": "high",
    "theme": "dark",
    "enableAiTagging": False,
    "taggingThreadCount": 3,
    "aiTagCount": 10,
    "thumbnailSize": "medium",
    "adjustmentVisibility": {},
    "rawHighlightCompression": 2.5,
    "processingBackend": None,
    "exportPresets": [],
    "linearRawMode": "default",
    "imageCacheSize": 5,
    "tonemapperOverrideEnabled": False,
    "defaultRawTonemapper": "agx",
    "defaultNonRawTonemapper": "basic",
    "rawPreprocessingColorNr": 0.5,  # app_settings.rs:517
    "rawPreprocessingSharpening": 0.35,  # app_settings.rs:518
    "applyPreprocessingToNonRaws": False,
    "language": None,
}


# live_preview_quality -> (downscale divisor, jpeg quality), lib.rs:364-368
LIVE_PREVIEW_QUALITY = {
    "full": (1.0, 94),
    "high": (1.0, 88),
    "balanced": (1.5, 80),
    "performance": (2.0, 65),
}


def app_data_dir() -> Path:
    """Per-user app-data directory (the reference resolves Tauri's
    app_data_dir, lib.rs; override with RAPIDRAW_DATA_DIR)."""
    env = os.environ.get("RAPIDRAW_DATA_DIR")
    if env:
        d = Path(env)
    else:
        xdg = os.environ.get("XDG_DATA_HOME")
        base = Path(xdg) if xdg else Path.home() / ".local" / "share"
        d = base / "rapidraw_tpu"
    d.mkdir(parents=True, exist_ok=True)
    return d


class AppSettings(dict):
    """Settings document with defaults; unknown keys round-trip untouched."""

    def __init__(self, *args, **kwargs):
        # deep-copy nested defaults: AppSettings(DEFAULTS) must not share
        # the module-global mutable lists/dicts across instances
        super().__init__()
        for a in args:
            self.update(copy.deepcopy(a))
        self.update(copy.deepcopy(kwargs))

    @classmethod
    def load(cls, path: str | Path) -> "AppSettings":
        s = cls(DEFAULTS)
        p = Path(path)
        if p.exists():
            try:
                data = json.loads(p.read_text())
                if isinstance(data, dict):
                    s.update(data)
            except (OSError, json.JSONDecodeError):
                pass
        return s

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self, indent=2, ensure_ascii=False))

    @property
    def editor_preview_resolution(self) -> int:
        return int(self.get("editorPreviewResolution") or 1920)

    @property
    def thumbnail_resolution(self) -> int:
        return int(self.get("thumbnailResolution") or 720)

    @property
    def image_cache_size(self) -> int:
        return int(self.get("imageCacheSize") or 5)

    @property
    def raw_highlight_compression(self) -> float:
        return float(self.get("rawHighlightCompression") or 2.5)

    @property
    def linear_raw_mode(self) -> str:
        return str(self.get("linearRawMode") or "default")

    @property
    def raw_preprocessing_color_nr(self) -> float:
        """RAW chroma-NR strength 0..1 (app_settings.rs:426,517)."""
        v = self.get("rawPreprocessingColorNr")
        return 0.5 if v is None else float(v)

    @property
    def raw_preprocessing_sharpening(self) -> float:
        """RAW post-develop sharpening (app_settings.rs:428,518)."""
        v = self.get("rawPreprocessingSharpening")
        return 0.35 if v is None else float(v)

    @property
    def apply_preprocessing_to_non_raws(self) -> bool:
        return bool(self.get("applyPreprocessingToNonRaws") or False)

    def preprocessing_amounts(self) -> tuple[float, float]:
        """(color_nr_inv_sigma, sharpening) for raw.enhance: the setting's
        0..1 slider maps to an inverse sigma via 12/x - 10
        (image_loader.rs:71-78)."""
        s = self.raw_preprocessing_color_nr
        if s <= 0.0:
            nr = 0.0
        else:
            x = min(max(s, 0.01), 1.0)
            nr = max(12.0 / x - 10.0, 0.1)
        return nr, self.raw_preprocessing_sharpening

    def tonemapper_override(self, is_raw: bool) -> int | None:
        """resolve_tonemapper_override (image_processing.rs:1663-1684)."""
        if not self.get("tonemapperOverrideEnabled"):
            return None
        tm = (
            self.get("defaultRawTonemapper") or "agx"
            if is_raw
            else self.get("defaultNonRawTonemapper") or "basic"
        )
        return 1 if tm == "agx" else 0

    def preview_quality(self, interactive: bool) -> tuple[float, int]:
        """(downscale divisor, JPEG quality) of a preview reply: full size
        at q94 when settled, the livePreviewQuality entry while
        interactive (lib.rs:364-368)."""
        q = str(self.get("livePreviewQuality") or "high")
        if not interactive:
            return (1.0, 94)
        return LIVE_PREVIEW_QUALITY.get(q, LIVE_PREVIEW_QUALITY["high"])
