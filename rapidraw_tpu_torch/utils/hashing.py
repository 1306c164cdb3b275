"""Cache-key hashing over adjustment documents.

A copy of the JAX package's `rapidraw_tpu/utils/hashing.py` (plain
Python), which ports cache_utils.rs:8-157: the *key structure* (which adjustment fields
feed which cache) is preserved exactly; the hash function itself is
blake2b-64 instead of Rust's SipHash (values are process-local cache keys,
never persisted by the reference either).

  geometry hash   — warp-relevant keys + aiPatches + orientationSteps
                    (keys :8-26, fn :28-45); keys the full-res warped cache.
  visual hash     — path + everything EXCEPT geometry/crop/rotate/flip
                    (:47-68); identifies "same grade, any geometry".
  transform hash  — orientation/rotation/flips/crop + geometry keys +
                    aiPatches identity digest (:70-150); keys the
                    transformed-image cache.
  full job hash   — path + whole document (:152-157).
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any

GEOMETRY_KEYS = (
    "transformDistortion",
    "transformVertical",
    "transformHorizontal",
    "transformRotate",
    "transformAspect",
    "transformScale",
    "transformXOffset",
    "transformYOffset",
    "lensDistortionAmount",
    "lensVignetteAmount",
    "lensTcaAmount",
    "lensDistortionParams",
    "lensMaker",
    "lensModel",
    "lensDistortionEnabled",
    "lensTcaEnabled",
    "lensVignetteEnabled",
)


class _H:
    def __init__(self):
        self._h = hashlib.blake2b(digest_size=8)

    def update(self, value: Any) -> None:
        self._h.update(repr(value).encode())

    def finish(self) -> int:
        return int.from_bytes(self._h.digest(), "little")


def _json_str(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"), sort_keys=False, ensure_ascii=False)


def calculate_geometry_hash(adjustments: dict) -> int:
    h = _H()
    if "aiPatches" in adjustments:
        h.update(_json_str(adjustments["aiPatches"]))
    # normalized like calculate_transform_hash: missing/None == 0, so the
    # warped-image cache and the transform cache agree on geometry identity
    h.update(int(adjustments.get("orientationSteps") or 0))
    for key in GEOMETRY_KEYS:
        if key in adjustments:
            h.update(key)
            h.update(_json_str(adjustments[key]))
    return h.finish()


def calculate_visual_hash(path: str, adjustments: dict) -> int:
    h = _H()
    h.update(path)
    skip = set(GEOMETRY_KEYS) | {
        "crop", "rotation", "orientationSteps", "flipHorizontal", "flipVertical",
    }
    # sorted: semantically identical documents must hash equal regardless
    # of JSON key order (sidecars written by the reference vs this port)
    for key in sorted(adjustments):
        if key in skip:
            continue
        h.update(key)
        h.update(_json_str(adjustments[key]))
    return h.finish()


def calculate_transform_hash(adjustments: dict) -> int:
    h = _H()
    h.update(int(adjustments.get("orientationSteps") or 0))
    h.update(float(adjustments.get("rotation") or 0.0))
    h.update(bool(adjustments.get("flipHorizontal", False)))
    h.update(bool(adjustments.get("flipVertical", False)))
    crop = adjustments.get("crop")
    if crop is not None:
        h.update(_json_str(crop))
    for key in GEOMETRY_KEYS:
        if key in adjustments:
            h.update(key)
            h.update(_json_str(adjustments[key]))
    patches = adjustments.get("aiPatches")
    if isinstance(patches, list):
        h.update(len(patches))
        for patch in patches:
            h.update(patch.get("id", ""))
            h.update(bool(patch.get("visible", True)))
            pd = patch.get("patchData")
            if isinstance(pd, dict):
                h.update(len(pd.get("color") or ""))
                h.update(len(pd.get("mask") or ""))
            else:
                h.update(len(patch.get("patchDataBase64") or ""))
            if "subMasks" in patch:
                h.update(_json_str(patch["subMasks"]))
            h.update(bool(patch.get("invert", False)))
    return h.finish()


def calculate_full_job_hash(path: str, adjustments: dict) -> int:
    h = _H()
    h.update(path)
    h.update(_json_str(adjustments))
    return h.finish()


class LruCache:
    """Simple bounded LRU (cache_utils.rs DecodedImageCache, :159-207).
    The preview service's caller and its workers share one, so each
    operation holds a lock (JAX's relies on the GIL's atomic dict steps;
    the pop-then-insert of `get` is two)."""

    def __init__(self, capacity: int = 5):
        self.capacity = max(1, capacity)
        self._d: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._d:
                v = self._d.pop(key)
                self._d[key] = v
                return v
            return None

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._d:
                self._d.pop(key)
            elif len(self._d) >= self.capacity:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
