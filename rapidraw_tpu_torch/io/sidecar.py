"""Non-destructive edit sidecars (a copy of the JAX package's
`rapidraw_tpu/io/sidecar.py`).

The reference's checkpoint system (SURVEY.md §5.4): a `.rrdata` JSON file
per image holding ImageMetadata {version, rating, adjustments, tags, exif}
(image_processing.rs:51-72; load exif_processing.rs:40-70 with auto-healing
of bloated EXIF values; save file_management.rs:1091). The contract is kept
verbatim so sidecars are interchangeable with the reference.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

SIDECAR_EXT = ".rrdata"
CURRENT_VERSION = 1
_MAX_EXIF_VALUE_LEN = 500  # exif auto-heal threshold (exif_processing.rs:16)


def sidecar_path(image_path: str | Path) -> Path:
    """Sidecar for a real or virtual path: 'a.jpg' -> 'a.jpg.rrdata',
    'a.jpg?vc=2' -> 'a.jpg.2.rrdata' (file_management.rs:165-196)."""
    from rapidraw_tpu_torch.io.loader import parse_virtual_path

    base, vc = parse_virtual_path(str(image_path))
    p = Path(base)
    suffix = f".{vc}{SIDECAR_EXT}" if vc is not None else SIDECAR_EXT
    return p.with_name(p.name + suffix)


def default_metadata() -> dict[str, Any]:
    return {
        "version": CURRENT_VERSION,
        "rating": 0,
        "adjustments": None,
        "tags": [],
        "exif": None,
    }


def load_sidecar(image_path: str | Path) -> dict[str, Any]:
    """Load (or default) the sidecar; heals oversized EXIF values
    (exif_processing.rs:40-70)."""
    sp = sidecar_path(image_path)
    if not sp.exists():
        return default_metadata()
    try:
        meta = json.loads(sp.read_text())
    except (OSError, json.JSONDecodeError):
        return default_metadata()
    if not isinstance(meta, dict):
        return default_metadata()
    exif = meta.get("exif")
    if isinstance(exif, dict):
        meta["exif"] = {
            k: (v if not (isinstance(v, str) and len(v) > _MAX_EXIF_VALUE_LEN) else v[:_MAX_EXIF_VALUE_LEN])
            for k, v in exif.items()
        }
    out = default_metadata()
    out.update(meta)
    return out


def save_sidecar(image_path: str | Path, metadata: dict[str, Any]) -> None:
    sp = sidecar_path(image_path)
    meta = dict(metadata)
    meta.setdefault("version", CURRENT_VERSION)
    # atomic replace: a crash mid-write must not leave truncated JSON that
    # load_sidecar would silently replace with defaults (losing all edits);
    # the name is unique per thread, as the preview workers may persist
    # the same source's EXIF at once
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=sp.parent, prefix=f"{sp.name}.", suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(json.dumps(meta, indent=2))
    os.replace(tmp, sp)


def load_adjustments(image_path: str | Path) -> dict:
    adj = load_sidecar(image_path).get("adjustments")
    return adj if isinstance(adj, dict) else {}
