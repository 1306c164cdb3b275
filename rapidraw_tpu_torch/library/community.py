"""Community presets: manifest fetch, preview rendering, install.

Port of `rapidraw_tpu/library/community.py` (lib.rs:1191-1330
`fetch_community_presets` / `generate_all_community_previews`,
file_management.rs:2703-2757 `save_community_preset`): a hosted
manifest.json lists presets {name, adjustments, creator?}; the app renders
a small preview strip per preset on the device and installs chosen ones
under a "Community" folder of the preset store. The network half is behind
an injectable `fetcher`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Iterable

import torch

MANIFEST_URL = (
    "https://raw.githubusercontent.com/CyberTimon/RapidRAW-Presets/main/manifest.json"
)
PREVIEW_TILE_DIM = 360  # lib.rs:1226 TILE_DIM
COMMUNITY_FOLDER = "Community"


@dataclasses.dataclass
class CommunityPreset:
    name: str
    adjustments: dict
    creator: str | None = None

    @classmethod
    def from_json(cls, obj: dict) -> "CommunityPreset":
        if not isinstance(obj, dict) or "name" not in obj:
            raise ValueError("community preset entries need a 'name'")
        adj = obj.get("adjustments")
        if not isinstance(adj, dict):
            raise ValueError(f"preset {obj.get('name')!r} has no adjustments object")
        return cls(name=str(obj["name"]), adjustments=adj,
                   creator=obj.get("creator") or obj.get("author"))


def _default_fetcher(url: str) -> str:
    import urllib.request

    req = urllib.request.Request(url, headers={"User-Agent": "RapidRAW-App"})
    with urllib.request.urlopen(req, timeout=20) as resp:  # noqa: S310
        return resp.read().decode("utf-8")


def fetch_community_presets(fetcher: Callable[[str], str] | None = None,
                            url: str = MANIFEST_URL) -> list[CommunityPreset]:
    """Fetch + parse the community manifest (lib.rs:1191-1213);
    `fetcher(url) -> text` is injectable."""
    fetcher = fetcher or _default_fetcher
    try:
        text = fetcher(url)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"failed to fetch community manifest from {url}: {e} "
            "(no network egress? pass a fetcher or a local manifest)"
        ) from e
    return parse_manifest(text)


def parse_manifest(text: str) -> list[CommunityPreset]:
    data = json.loads(text)
    if not isinstance(data, list):
        raise ValueError("community manifest must be a JSON array")
    out = []
    for entry in data:
        try:
            out.append(CommunityPreset.from_json(entry))
        except ValueError:
            continue  # skip malformed entries, keep the rest usable
    return out


def generate_community_previews(image_paths: Iterable[str], presets: Iterable[CommunityPreset],
                                tile_dim: int = PREVIEW_TILE_DIM,
                                device=None) -> dict[str, bytes]:
    """Render a JPEG preview strip per preset (lib.rs:1216-1330) on
    `device` (the CUDA device unless the caller asks for another).

    Each source is area-downscaled to ~2x tile_dim, developed with the
    preset's adjustments (masks included; crop coordinates scaled to the
    preview resolution), cut to a square centre tile, and the tiles are
    joined side by side into one q80 JPEG.
    """
    from rapidraw_tpu_torch.geometry.resize import downscale
    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
    from rapidraw_tpu_torch.io.loader import load_image, parse_virtual_path
    from rapidraw_tpu_torch.masks.rasterize import rasterize_masks
    from rapidraw_tpu_torch.params.parse import parse_adjustments
    from rapidraw_tpu_torch.pipeline.export import develop_single

    device = torch.device(device if device is not None else "cuda")
    processing_dim = tile_dim * 2
    bases: list[tuple[torch.Tensor, bool, float]] = []
    for path in image_paths:
        real, _ = parse_virtual_path(str(path))
        img, is_raw = load_image(real, device=device)
        _, h, w = img.shape
        scale = 1.0
        if max(h, w) > processing_dim:
            scale = processing_dim / max(h, w)
            img = downscale(img, max(1, round(w * scale)), max(1, round(h * scale)))
        bases.append((img, is_raw, scale))

    results: dict[str, bytes] = {}
    for preset in presets:
        tiles = []
        for base, is_raw, scale in bases:
            adj = dict(preset.adjustments)
            crop = adj.get("crop")
            if isinstance(crop, dict):
                adj["crop"] = {k: float(v) * scale for k, v in crop.items()}
            adj["showClipping"] = False
            timg, crop_offset = apply_all_transformations(base, adj, patch_scale=scale)
            _, th, tw = timg.shape
            masks = rasterize_masks(adj, tw, th, scale=scale, crop_offset=crop_offset)
            params, cfg = parse_adjustments(adj, is_raw=is_raw)
            lut = None
            if cfg.has_lut and isinstance(adj.get("lutPath"), str):
                from rapidraw_tpu_torch.io.lut import parse_lut_file

                try:
                    lut = torch.as_tensor(parse_lut_file(adj["lutPath"]), device=device)
                except Exception:  # noqa: BLE001
                    cfg = dataclasses.replace(cfg, has_lut=False)
            out = develop_single(timg, params, cfg, masks=masks, lut=lut)
            _, oh, ow = out.shape
            side = min(oh, ow, tile_dim)
            y0 = (oh - side) // 2
            x0 = (ow - side) // 2
            tiles.append(out[:, y0: y0 + side, x0: x0 + side])
        if not tiles:
            continue
        side = min(t.shape[1] for t in tiles)
        strip = torch.cat([t[:, :side, :side] for t in tiles], dim=2)
        results[preset.name] = encode_jpeg_bytes(strip.cpu().numpy(), quality=80)
    return results


def save_community_preset(store, name: str, adjustments: dict, include_masks: bool | None = None,
                          include_crop_transform: bool | None = None,
                          preset_type: str | None = None) -> dict:
    """Install one community preset under the 'Community' folder of a
    PresetStore, replacing any same-named entry there
    (file_management.rs:2703-2757)."""
    entry = store.add(name, adjustments, folder=COMMUNITY_FOLDER)
    entry["includeMasks"] = include_masks
    entry["includeCropTransform"] = include_crop_transform
    entry["presetType"] = preset_type or "style"
    store._save()
    return entry
