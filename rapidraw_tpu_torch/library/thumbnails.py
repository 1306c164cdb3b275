"""Thumbnail service: content+adjustment-hashed disk cache of small renders.

Port of `rapidraw_tpu/library/thumbnails.py` (file_management.rs:1070-1439):
cache key = blake2b-16 of path + mtime + resolution + adjustments (+ the
develop-relevant app settings), render = fast RAW load -> geometry
transform at the loaded scale -> area downscale to the thumbnail size ->
the develop chain on the device -> u8 on the device -> q85 JPEG. Same-shape
develops of a folder go through `develop_batch` in fixed chunks of
`_THUMB_BATCH`, the worker pool's batched analog (:1440-1568). Everything
runs on `device`, the CUDA device unless the caller asks for another.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from collections import defaultdict
from pathlib import Path

import torch

# fixed develop-batch chunk for thumbnail buckets, the JAX package's (one
# launch shape serves every chunk; 4 matches the export default batch_size)
_THUMB_BATCH = int(os.environ.get("RAPIDRAW_THUMB_BATCH", "4"))


def thumbnail_cache_key(path: str, adjustments: dict, resolution: int = 720,
                        app_settings=None) -> str:
    """The JAX package's key: the real file's mtime (a virtual '?vc=N' path
    stats its file), the resolution and the develop-relevant app settings
    are part of the identity."""
    from rapidraw_tpu_torch.io.loader import parse_virtual_path

    p = Path(parse_virtual_path(str(path))[0])
    try:
        mtime = p.stat().st_mtime_ns
    except OSError:
        mtime = 0
    h = hashlib.blake2b(digest_size=16)
    h.update(str(path).encode())
    h.update(str(mtime).encode())
    h.update(str(int(resolution)).encode())
    h.update(json.dumps(adjustments, sort_keys=True, default=str).encode())
    if app_settings is not None:
        h.update(json.dumps([
            app_settings.preprocessing_amounts(),
            app_settings.raw_highlight_compression,
            app_settings.linear_raw_mode,
            app_settings.apply_preprocessing_to_non_raws,
            app_settings.tonemapper_override(True),
            app_settings.tonemapper_override(False),
            str(app_settings.get("defaultRawTonemapper") or "agx"),
            str(app_settings.get("defaultNonRawTonemapper") or "basic"),
        ], default=str).encode())
    return h.hexdigest()


def _container_preview_jpeg(path: str) -> bytes | None:
    """Embedded preview JPEG from a container whose RAW payload refuses:
    CR3 PRVW box, X3F IMAG section, CRW CIFF JpgFromRaw record."""
    low = path.lower()
    try:
        data = Path(path).read_bytes()
        if low.endswith(".cr3"):
            from rapidraw_tpu_torch.io.cr3 import parse_cr3_info

            return parse_cr3_info(data).preview_jpeg
        if low.endswith(".x3f"):
            from rapidraw_tpu_torch.io.x3f import parse_x3f_info

            return parse_x3f_info(data).preview_jpeg
        if low.endswith(".crw"):
            from rapidraw_tpu_torch.io.ciff import parse_crw_info

            info = parse_crw_info(data)
            return info.preview_jpeg or info.thumbnail_jpeg
    except Exception:  # noqa: BLE001
        return None
    return None


def _preview_fallback_thumbnail(path: str, resolution: int) -> bytes | None:
    """q85 JPEG of a refused container's embedded preview, shrunk as PIL's
    `thumbnail((resolution, resolution))` shrinks it."""
    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.geometry.resize import thumbnail_u8
    from rapidraw_tpu_torch.io.jpeg import decode_jpeg_rgb

    preview = _container_preview_jpeg(path)
    if not preview:
        return None
    rgb = thumbnail_u8(decode_jpeg_rgb(preview), (resolution, resolution))
    return native.jpeg_encode(rgb, 85)


def _write_cache(cache_file: Path | None, data: bytes) -> bytes:
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_bytes(data)
    return data


def _prep_thumbnail(path: str, resolution: int = 720, cache_dir: str | Path | None = None,
                    app_settings=None, device=None):
    """Host-side half of a thumbnail render: finished JPEG `bytes` (cache
    hit, preview fallback, unedited-LDR downscale) or a dict {x, masks,
    params, cfg, lut, cache_file} ready for the develop chain, x and masks
    on the device."""
    from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
    from rapidraw_tpu_torch.io.loader import load_image, parse_virtual_path
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.masks.rasterize import (
        rasterize_masks, requires_warped_image, resolve_warped_image,
    )
    from rapidraw_tpu_torch.params.parse import is_image_edited, parse_adjustments

    if app_settings is None:
        from rapidraw_tpu_torch.utils.settings import AppSettings, app_data_dir

        app_settings = AppSettings.load(app_data_dir() / "settings.json")
    device = torch.device(device if device is not None else "cuda")

    adjustments = load_adjustments(path)
    key = thumbnail_cache_key(path, adjustments, resolution, app_settings)
    cache_file = None
    if cache_dir is not None:
        cache_file = Path(cache_dir) / f"{key}.jpg"
        if cache_file.exists():
            return cache_file.read_bytes()

    # fast = the reference's use_fast_raw_dev thumbnail path (half-size
    # speed demosaic, no enhance); colour/luminance range masks sample the
    # full-size warped image, so those documents take the full-size load
    fast = not requires_warped_image(adjustments)
    try:
        img, is_raw = load_image(path, app_settings=app_settings, fast=fast, device=device)
    except Exception as e:  # noqa: BLE001
        from rapidraw_tpu_torch.io.containers import UnsupportedRawFormat

        real_path = parse_virtual_path(str(path))[0]
        if isinstance(e, UnsupportedRawFormat) and real_path.lower().endswith(
                (".cr3", ".x3f", ".crw")):
            # a refused RAW payload whose container carries a preview
            data = _preview_fallback_thumbnail(real_path, resolution)
            if data is not None:
                return _write_cache(cache_file, data)
        raise
    x = img

    if not is_raw and not is_image_edited(adjustments, is_raw):
        # unedited LDR: plain downscale, no develop (file_management.rs:1134-1152)
        small = downscale_to_long_edge(x, resolution)
        return _write_cache(cache_file, encode_jpeg_bytes(small.cpu().numpy(), quality=85))

    # the fast RAW decode is 2x2-binned: bucket the measured size ratio
    # (raw_processing.rs:233-254) and scale every full-size coordinate
    load_scale = 1.0
    if is_raw and fast:
        try:
            from rapidraw_tpu_torch.library.catalog import get_image_dimensions

            fw, fh = get_image_dimensions(path)
            full_max = max(fw, fh)
            ratio = max(img.shape[2], img.shape[1]) / full_max if full_max else 1.0
            if 0.1 < ratio < 0.35:
                load_scale = 0.25
            elif 0.35 <= ratio < 0.75:
                load_scale = 0.5
        except Exception:  # dims unavailable: reload full size (coords exact)
            img, is_raw = load_image(path, app_settings=app_settings, device=device)
            x = img

    adj_t = adjustments
    if load_scale != 1.0:
        adj_t = dict(adjustments)
        crop = adjustments.get("crop")
        if isinstance(crop, dict):
            adj_t["crop"] = {k: float(v) * load_scale for k, v in crop.items()}

    x, crop_offset = apply_all_transformations(x, adj_t, patch_scale=load_scale)
    full_h = int(x.shape[1])  # mask coordinates live in the transformed frame
    x = downscale_to_long_edge(x, resolution)
    _, h, w = x.shape
    ds = h / full_h if full_h else 1.0
    warped = (resolve_warped_image(img, adjustments, is_raw)
              if requires_warped_image(adjustments) else None)
    masks = rasterize_masks(adjustments, w, h, scale=ds * load_scale,
                            crop_offset=(crop_offset[0] * ds, crop_offset[1] * ds),
                            warped_image=warped)
    # edited documents follow the override; unedited ones force the
    # settings' default (file_management.rs:1346-1363)
    if adjustments:
        tm_override = app_settings.tonemapper_override(is_raw)
    else:
        tm_key = "defaultRawTonemapper" if is_raw else "defaultNonRawTonemapper"
        tm_default = "agx" if is_raw else "basic"
        tm_override = 1 if (app_settings.get(tm_key) or tm_default) == "agx" else 0
    params, cfg = parse_adjustments(adjustments, is_raw=is_raw, tonemapper_override=tm_override)
    lut = None
    if cfg.has_lut and isinstance(adjustments.get("lutPath"), str):
        from rapidraw_tpu_torch.io.lut import parse_lut_file

        try:
            lut = torch.as_tensor(parse_lut_file(adjustments["lutPath"]), device=device)
        except Exception:  # noqa: BLE001
            cfg = dataclasses.replace(cfg, has_lut=False)
    return {
        "x": x,
        "masks": torch.as_tensor(masks, device=device) if masks is not None else None,
        "params": params,
        "cfg": cfg,
        "lut": lut,
        "cache_file": cache_file,
    }


def _finish_thumbnail(out, cache_file) -> bytes:
    """u8 on the device (batched callers pass u8 host slices), then q85."""
    from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
    from rapidraw_tpu_torch.pipeline.export import device_u8

    if isinstance(out, torch.Tensor):
        out = device_u8(out).cpu().numpy()
    return _write_cache(cache_file, encode_jpeg_bytes(out, quality=85))


def _develop_one(prep) -> bytes:
    from rapidraw_tpu_torch.pipeline.develop import develop

    out = develop(prep["x"], prep["params"], prep["cfg"], masks=prep["masks"], lut=prep["lut"])
    return _finish_thumbnail(out, prep["cache_file"])


def generate_thumbnail(path: str, resolution: int = 720, cache_dir: str | Path | None = None,
                       app_settings=None, device=None) -> bytes:
    """Render one thumbnail JPEG (bytes), using the disk cache when valid
    (generate_thumbnail_data, file_management.rs:1070-1367): edited images
    run the develop chain at thumbnail scale, unedited LDRs are plain
    downscales, unedited RAWs get the default RAW tonemap. app_settings=None
    loads settings.json from the app data dir."""
    prep = _prep_thumbnail(path, resolution, cache_dir, app_settings, device)
    if isinstance(prep, bytes):
        return prep
    return _develop_one(prep)


def _bucket_key(prep) -> tuple:
    """Same-shape develops that share one merged config (the JAX package's
    key): mixed NR amounts would merge to the per-pixel path, so they keep
    their own buckets."""
    cfg = prep["cfg"]
    return (
        tuple(prep["x"].shape),
        None if prep["masks"] is None else int(prep["masks"].shape[0]),
        cfg.is_raw,
        cfg.tonemapper_agx,
        float(cfg.ca_static_rc),
        float(cfg.ca_static_by),
        cfg.nr_static_luma,
        cfg.nr_static_color,
    )


def generate_thumbnails(paths: list[str], resolution: int = 720,
                        cache_dir: str | Path | None = None, cancel=None, progress=None,
                        app_settings=None, device=None) -> dict[str, bytes]:
    """Batch thumbnail generation (the worker-pool equivalent).

    The walk stops at the next item (or the next device chunk) when
    `cancel` (utils.recovery.CancellationToken) fires, returning what
    completed. `progress(done, total, path)` fires after each COMPLETED
    thumbnail, plus one terminal (total, total, "") call. Failures are
    isolated per bucket, then per image.
    """
    from rapidraw_tpu_torch.pipeline.batch import develop_batch, stack_params
    from rapidraw_tpu_torch.pipeline.export import device_u8
    from rapidraw_tpu_torch.utils.trace import log

    if app_settings is None:
        from rapidraw_tpu_torch.utils.settings import AppSettings, app_data_dir

        app_settings = AppSettings.load(app_data_dir() / "settings.json")
    device = torch.device(device if device is not None else "cuda")

    out: dict[str, bytes] = {}
    pending: list[tuple[str, dict]] = []
    cancelled = False
    total = len(paths)

    def done(p):
        if progress:
            progress(len(out), total, p)

    def stop() -> bool:
        nonlocal cancelled
        if cancel is not None and cancel.cancelled:
            cancelled = True
        return cancelled

    for p in paths:
        if stop():
            break
        try:
            prep = _prep_thumbnail(p, resolution, cache_dir, app_settings, device)
        except Exception as e:  # noqa: BLE001
            log.warning("thumbnail failed for %s: %s", p, e)
            continue
        if isinstance(prep, bytes):
            out[p] = prep
            done(p)
        else:
            pending.append((p, prep))

    # same-shape develops share one launch per chunk; LUT documents stay
    # single (the LUT operand is per document)
    buckets: dict = defaultdict(list)
    for p, prep in pending:
        if stop():
            break
        key = ("single", p) if prep["lut"] is not None else _bucket_key(prep)
        buckets[key].append((p, prep))

    for key, group in buckets.items():
        if stop():
            break
        try:
            if key[0] == "single" or len(group) == 1:
                for p, prep in group:
                    if stop():
                        break
                    out[p] = _develop_one(prep)
                    done(p)
                continue
            # merge the group's activity once: every chunk shares it, the
            # last chunk pads by repeating its final entry
            _, cfg_b = stack_params([prep["params"] for _, prep in group],
                                    [prep["cfg"] for _, prep in group], device=device)
            n_masks = cfg_b.mask_count
            z = (torch.zeros((n_masks,) + tuple(group[0][1]["x"].shape[1:]),
                             dtype=torch.float32, device=device) if n_masks > 0 else None)

            def pad_masks(mk):
                if mk is None:
                    return z
                n = int(mk.shape[0])
                return mk if n == n_masks else torch.cat([mk, z[: n_masks - n]])

            for c0 in range(0, len(group), _THUMB_BATCH):
                if stop():
                    break
                chunk = group[c0: c0 + _THUMB_BATCH]
                padded = chunk + [chunk[-1]] * (_THUMB_BATCH - len(chunk))
                params_b, _ = stack_params([prep["params"] for _, prep in padded],
                                           [prep["cfg"] for _, prep in padded],
                                           cfg=cfg_b, device=device)
                imgs = torch.stack([prep["x"] for _, prep in padded])
                masks_b = (torch.stack([pad_masks(prep["masks"]) for _, prep in padded])
                           if n_masks > 0 else None)
                frames = device_u8(develop_batch(imgs, params_b, cfg_b, masks=masks_b))
                frames = frames[: len(chunk)].cpu().numpy()
                for (p, prep), o in zip(chunk, frames):
                    out[p] = _finish_thumbnail(o, prep["cache_file"])
                    done(p)
        except Exception as e:  # noqa: BLE001 — per bucket, then per image
            log.warning("thumbnail bucket failed (%s): %s — retrying singly", key, e)
            for p, prep in group:
                if p in out:  # chunks before the failure already finished
                    continue
                if stop():
                    break
                try:
                    out[p] = _develop_one(prep)
                    done(p)
                except Exception as e2:  # noqa: BLE001
                    log.warning("thumbnail failed for %s: %s", p, e2)

    if progress and paths and not cancelled:
        progress(len(paths), len(paths), "")  # terminal signal
    return out


def clear_thumbnail_cache(cache_dir: str) -> None:
    """Wipe and recreate the hash-keyed thumbnail cache directory
    (file_management.rs:1035-1054)."""
    d = Path(cache_dir)
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True, exist_ok=True)
