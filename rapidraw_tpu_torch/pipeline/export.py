"""Batch export: RAW files and their sidecars to JPEG, PNG, TIFF or JPEG XL.

Port of `rapidraw_tpu/pipeline/export.py` (export_processing.rs:637-1004):
per image, load + sidecar adjustments -> full-res geometry transform ->
masks at scale 1.0 -> develop on the device -> quantize on the device ->
readback -> optional Lanczos3 resize -> encode -> EXIF copy -> timestamps.
Images are bucketed by (shape, unmergeable config fields, LUT content) and
each bucket renders in chunks of `batch_size` through `develop_batch`: the
blur kernel (csrc/blur.cu) and the grade kernel (csrc/grade.cu) on a CUDA
device, with NR, flare and the LUT as documents ask; their plain versions
on the CPU. Host work (decode, transforms, masks) runs in a prepare pool
through a bounded window, and an encode pool drains rendered frames while
the next chunk renders.

The device quantizers (`device_u8`, `device_u16`) round as the host encode
does: clip(y, 0, 1) * max + 0.5, then truncate. One device only (the JAX
package's mesh branch waits for slice A.14). Sources are RAW and LDR files
(io/loader.py); a watermark composites on the host after the resize
(pipeline/watermark.py), and `export_masks` writes each visible mask's
image and alpha PNG (`_export_masks_for_image`).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from rapidraw_tpu_torch.params.parse import DevelopConfig
from rapidraw_tpu_torch.pipeline.bands import blur_band_rows
from rapidraw_tpu_torch.pipeline.batch import develop_batch, stack_params
from rapidraw_tpu_torch.pipeline.watermark import WatermarkSettings, apply_watermark


def device_u8(x: torch.Tensor) -> torch.Tensor:
    """Quantize [0, 1] float to uint8 on the tensor's device."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def device_u16(x: torch.Tensor) -> torch.Tensor:
    """Quantize [0, 1] float to uint16 on the tensor's device."""
    return (torch.clamp(x, 0.0, 1.0) * 65535.0 + 0.5).to(torch.uint16)


def develop_single(image: torch.Tensor, params: dict, cfg: DevelopConfig,
                   masks=None, lut=None, flare=None) -> torch.Tensor:
    """One (3, H, W) image (and its (N, H, W) mask influences, LUT cube
    and flare map, as `develop`) through the same batch-of-1 entry an
    export chunk renders with, so single renders match batch renders
    exactly; mask-only blur levels are band-restricted as the JAX entry
    does."""
    sp, scfg = stack_params([params], [cfg], device=image.device)
    bands = blur_band_rows(scfg, masks) if masks is not None else None
    mk = torch.as_tensor(masks, device=image.device)[None] if masks is not None else None
    return develop_batch(image[None], sp, scfg, masks=mk, lut=lut, flare=flare,
                         blur_bands=bands)[0]


# the JAX package's name for the single-image render entry
develop_single_compiled = develop_single


@dataclasses.dataclass
class ExportSettings:
    format: str = "jpeg"
    quality: int = 90
    long_edge: int | None = None  # resize value (None = resize disabled)
    resize_mode: str = "longEdge"  # longEdge | shortEdge | width | height (rs:42-47)
    dont_enlarge: bool = True  # skip resize when the mode's edge already fits (rs:165-175)
    filename_template: str = "{original_filename}_edited"
    batch_size: int = 4
    watermark: "WatermarkSettings | None" = None
    copy_exif: bool = True  # EXIF write-through with GPS strip (rs:297-303)
    strip_gps: bool = True
    preserve_folders: bool = False  # recreate source tree under output dir (rs:789-822)
    base_origin_folders: tuple = ()  # roots relative to which the tree is kept
    preserve_timestamps: bool = False  # stamp outputs with EXIF capture time (rs:272-281)
    export_masks: bool = False  # also emit per-mask image+alpha pairs (rs:471-585)


def settings_from_preset(preset: dict) -> ExportSettings:
    """Build ExportSettings from a saved export preset (app_settings.rs
    ExportPreset :218-292; presets live under settings['exportPresets'])."""
    watermark = None
    if preset.get("enable_watermark") and preset.get("watermark_path"):
        def _num(key, default):
            # frontend presets carry explicit nulls for unset keys, but 0
            # is a meaningful value (spacing 0, opacity 0): only None falls back
            v = preset.get(key)
            return float(default if v is None else v)

        watermark = WatermarkSettings(
            path=preset["watermark_path"],
            anchor=preset.get("watermark_anchor") or "bottomRight",
            scale=_num("watermark_scale", 15),
            spacing=_num("watermark_spacing", 2),
            opacity=_num("watermark_opacity", 100),
        )
    long_edge = None
    if preset.get("enable_resize") and preset.get("resize_value"):
        long_edge = int(preset["resize_value"])
    return ExportSettings(
        resize_mode=preset.get("resize_mode") or "longEdge",
        # plain bool in the schema (app_settings.rs:226); explicit null
        # reads like a missing key, and the frontend default is True
        dont_enlarge=bool(
            True if preset.get("dont_enlarge") is None else preset["dont_enlarge"]
        ),
        format=str(preset.get("file_format") or "jpeg").lower(),
        quality=int(preset.get("jpeg_quality") or 90),
        long_edge=long_edge,
        filename_template=preset.get("filename_template") or "{original_filename}_edited",
        watermark=watermark,
        # an explicit null must NOT read as False (it would silently
        # disable GPS stripping / drop all EXIF)
        copy_exif=bool(
            True if preset.get("keep_metadata") is None
            else preset["keep_metadata"]
        ),
        strip_gps=bool(
            True if preset.get("strip_gps") is None else preset["strip_gps"]
        ),
        preserve_folders=bool(preset.get("preserve_folders") or False),
        preserve_timestamps=bool(preset.get("preserve_timestamps") or False),
        export_masks=bool(preset.get("export_masks") or False),
    )


@dataclasses.dataclass
class ExportResult:
    source: str
    output: str | None
    ok: bool
    error: str | None = None
    seconds: float = 0.0


def _render_chunk(imgs: torch.Tensor, params, masks, lut, cfg: DevelopConfig,
                  blur_bands=None, out_dtype: str = "u8") -> np.ndarray:
    """Develop one export chunk on its device and read it back quantized:
    (B, 3, H, W) uint8, or uint16 for the 16-bit targets (PNG from float
    renders, TIFF)."""
    quant = device_u16 if out_dtype == "u16" else device_u8
    out = develop_batch(imgs, params, cfg, masks=masks, lut=lut, blur_bands=blur_bands)
    return quant(out).cpu().numpy()


def _prepare_one(path: str, settings: ExportSettings, app_settings=None, device=None):
    """Load + transform one image; returns its develop inputs. The image
    stays on `device` from the upload on.

    app_settings: the app-level AppSettings (RAW develop knobs + tonemapper
    override) — the export renders with the same settings the preview
    honoured (export_processing.rs:637-1004)."""
    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.masks.rasterize import rasterize_masks, resolve_warped_image
    from rapidraw_tpu_torch.params.parse import parse_adjustments

    t0 = time.perf_counter()
    img, is_raw = load_image(path, app_settings=app_settings, device=device)
    t1 = time.perf_counter()
    _stat_add("decode_s", t1 - t0)
    adj = dict(load_adjustments(path))
    adj["showClipping"] = False  # forced off for export (export_processing.rs:250)

    timg, crop_offset = apply_all_transformations(img, adj)
    _, h, w = timg.shape
    masks = rasterize_masks(adj, w, h, scale=1.0, crop_offset=crop_offset,
                            warped_image=resolve_warped_image(img, adj, is_raw))
    tonemapper_override = (
        app_settings.tonemapper_override(is_raw) if app_settings is not None else None
    )
    params, cfg = parse_adjustments(adj, is_raw=is_raw, tonemapper_override=tonemapper_override)

    lut = None
    if cfg.has_lut:
        from rapidraw_tpu_torch.io.lut import parse_lut_file

        try:
            lut = np.asarray(parse_lut_file(adj["lutPath"]), np.float32)
        except NotImplementedError:
            raise  # a LUT the port cannot read yet fails the image, never silently
        except Exception:
            cfg = dataclasses.replace(cfg, has_lut=False)
    _stat_add("prepare_s", time.perf_counter() - t1)
    return timg, masks, params, cfg, lut


def generate_filename_from_template(
    template: str, original_path: str | Path, sequence: int, total: int, file_date
) -> str:
    """{original_filename} {sequence} {YYYY} {MM} {DD} {hh} {mm}
    (file_management.rs:3264-3292). {sequence} is zero-padded to the width
    of `total`. {filename} is accepted as an alias of {original_filename}."""
    stem = Path(original_path).stem or "image"
    width = max(len(str(total)), 1)
    out = template
    out = out.replace("{original_filename}", stem).replace("{filename}", stem)
    out = out.replace("{sequence}", str(sequence).zfill(width))
    out = out.replace("{YYYY}", f"{file_date:%Y}").replace("{MM}", f"{file_date:%m}")
    out = out.replace("{DD}", f"{file_date:%d}").replace("{hh}", f"{file_date:%H}")
    out = out.replace("{mm}", f"{file_date:%M}")
    return out


def _output_path(
    source: str,
    out_dir: Path,
    settings: ExportSettings,
    seq: int,
    total: int = 1,
    vc: int | None = None,
    appearance: int = 0,
    created=None,
) -> Path:
    """Template + virtual-copy suffix + optional source-tree preservation
    (export_processing.rs:767-822). `created` lets callers reuse one EXIF
    read for both the filename template and timestamp restore."""
    if created is None:
        from rapidraw_tpu_torch.io.exif import get_creation_date

        created = get_creation_date(source)
    src = Path(source)
    name = generate_filename_from_template(
        settings.filename_template, src, seq, total, created
    )
    if vc is not None:
        name = f"{name}_VC{vc:02d}"
    elif appearance > 1:
        name = f"{name}_VC{appearance - 1:02d}"
    ext = "jpg" if settings.format in ("jpeg", "jpg") else settings.format

    target_dir = out_dir
    if settings.preserve_folders:
        for base in settings.base_origin_folders:
            basep = Path(base)
            try:
                rel = src.resolve().relative_to(basep.resolve())
            except (ValueError, OSError):
                continue
            rel_dir = rel.parent
            # refuse path traversal out of the output tree
            if any(part == ".." for part in rel_dir.parts):
                break
            target_dir = out_dir / rel_dir
            target_dir.mkdir(parents=True, exist_ok=True)
            break
    return target_dir / f"{name}.{ext}"


def _restore_timestamps(source: str, dst: Path, created=None) -> None:
    """Stamp the output with the source's EXIF capture time (rs:272-281)."""
    if created is None:
        from rapidraw_tpu_torch.io.exif import get_creation_date

        created = get_creation_date(source)
    t = created.timestamp()
    try:
        os.utime(dst, (t, t))
    except OSError:
        pass


def calculate_resize_target(
    w: int, h: int, settings: ExportSettings
) -> tuple[int, int] | None:
    """Final output dims for the export resize, or None if no resize applies.

    Both stages of the reference (export_processing.rs:160-211): the
    mode-fixed edge (longEdge/shortEdge/width/height, f32 ratio + .round())
    after the dont_enlarge early-out, then the image crate's aspect fit
    (f64 min-ratio, .round(), floor at 1) — resize with dont_enlarge=False
    can ENLARGE."""
    if not settings.long_edge:
        return None
    value = int(settings.long_edge)
    mode = settings.resize_mode or "longEdge"
    if settings.dont_enlarge:
        exceeds = {
            "longEdge": max(w, h) > value,
            "shortEdge": min(w, h) > value,
            "width": w > value,
            "height": h > value,
        }.get(mode, max(w, h) > value)
        if not exceeds:
            return None
    fix_width = {
        "longEdge": w >= h,
        "shortEdge": w <= h,
        "width": True,
        "height": False,
    }.get(mode, w >= h)
    if fix_width:
        tw = value
        th = int(np.floor(np.float32(value) * (np.float32(h) / np.float32(w)) + 0.5))
    else:
        tw = int(np.floor(np.float32(value) * (np.float32(w) / np.float32(h)) + 0.5))
        th = value
    if (tw, th) == (w, h):
        return None
    ratio = min(tw / w, th / h)
    nw = max(1, int(np.floor(w * ratio + 0.5)))
    nh = max(1, int(np.floor(h * ratio + 0.5)))
    if (nw, nh) == (w, h):
        return None
    return nw, nh


def _resize_host(planar: np.ndarray, settings: ExportSettings) -> np.ndarray:
    """Lanczos3 output resize on the host (export_processing.rs:194-211),
    in float like the reference's DynamicImage::resize on an Rgb32F, so
    precision survives into the 16-bit encodes; Lanczos overshoots, and the
    result is clamped to [0, 1] as the JAX package clamps it."""
    from rapidraw_tpu_torch.geometry.resize import lanczos_resize

    _, h, w = planar.shape
    tgt = calculate_resize_target(w, h, settings)
    if tgt is None:
        return planar
    nw, nh = tgt
    out = lanczos_resize(torch.from_numpy(np.ascontiguousarray(planar, np.float32)), nw, nh)
    return np.clip(out.numpy(), 0.0, 1.0)


def _available_ram_bytes() -> int:
    """MemAvailable from /proc/meminfo (8 GB fallback off-Linux)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def host_worker_budget() -> int:
    """Prepare/encode concurrency = min(cores, freeRAM/2.5 GB, 16) —
    the reference's export thread budget (export_processing.rs:661-683)."""
    cores = os.cpu_count() or 1
    by_ram = max(1, int(_available_ram_bytes() / (2.5 * (1 << 30))))
    return max(1, min(cores, by_ram, 16))


def prepare_window(batch_size: int, n_workers: int) -> int:
    """Max prepared-but-unrendered images in flight: enough to keep one
    device chunk ahead of the render loop. Prepared frames are DEVICE
    tensors (the load -> develop chain never leaves the card), so the cap
    is sized for device memory: worst-case live frames ≈ 2x this window
    (pend + accumulating chunks), each 24 MP frame ~300 MB f32. Host RAM
    still bounds it on RAM-starved hosts (masks + encode queue)."""
    want = max(batch_size + n_workers, 2 * batch_size, 2)
    return max(2, min(want, 8, max(2, int(_available_ram_bytes() / (2.5 * (1 << 30))))))


# test hook: tracks the peak number of live prepared-but-unencoded images
# (the RAM-bound invariant; multiplied by per-image bytes it bounds RSS)
_live_prepared = 0
_peak_prepared = 0
_live_lock = threading.Lock()

# per-stage wall-time accounting (stages overlap across threads, so the
# sums are seconds per stage, not a wall-clock decomposition):
#   decode_s    host container decode + device front-end DISPATCH (async)
#   prepare_s   transforms + mask rasterization (device work dispatched)
#   render_s    device develop + readback (the .cpu() sync point)
#   encode_s    host resize + encode + EXIF splice
STAGE_STATS = {
    "decode_s": 0.0, "prepare_s": 0.0, "render_s": 0.0, "encode_s": 0.0,
    "frames": 0,
}
_stats_lock = threading.Lock()


def reset_stage_stats() -> None:
    with _stats_lock:
        for k in STAGE_STATS:
            STAGE_STATS[k] = 0.0 if k != "frames" else 0


def _stat_add(key: str, value) -> None:
    with _stats_lock:
        STAGE_STATS[key] += value


def _track_prepared(delta: int) -> None:
    global _live_prepared, _peak_prepared
    with _live_lock:
        _live_prepared += delta
        _peak_prepared = max(_peak_prepared, _live_prepared)


def _lut_fingerprint(lut) -> int | None:
    if lut is None:
        return None
    import zlib

    return zlib.adler32(np.ascontiguousarray(lut).tobytes())


def _cfg_key(cfg: DevelopConfig) -> tuple:
    # has_lut is part of the key: buckets split by LUT content, and a no-LUT
    # bucket seeded from a union that absorbed a LUT document would carry
    # has_lut=True for LUT-less images
    return (cfg.is_raw, cfg.tonemapper_agx, cfg.ca_static_rc, cfg.ca_static_by, cfg.has_lut)


def export_images(
    paths: Iterable[str],
    output_dir: str | Path,
    settings: ExportSettings | None = None,
    progress: Callable[[int, int, str], None] | None = None,
    cancel=None,  # anything with a `cancelled` flag (export_processing.rs:1006-1018)
    app_settings=None,  # AppSettings: RAW develop knobs + tonemapper override
    device=None,
) -> list[ExportResult]:
    """Export a list of image paths using their sidecar adjustments, on
    `device` (the CUDA device unless the caller asks for another).

    A thread pool prepares images (decode + transform + masks) through a
    BOUNDED window, the render loop groups them into structural buckets and
    develops whole chunks on the device, and an encode pool drains rendered
    frames (resize + encode + EXIF + timestamps) while the next chunk
    renders. Live prepared frames are bounded by prepare_window() in the
    prepare stage plus the accumulating chunk and the encode queue
    (≈ 2*window + 2*n_enc worst case); the whole job is never materialized.
    Failures are isolated per image (prepare, encode) and per bucket
    (render).
    """
    from concurrent.futures import ThreadPoolExecutor

    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.exif import copy_exif, get_creation_date
    from rapidraw_tpu_torch.io.loader import is_raw_file, parse_virtual_path
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.params.parse import merge_configs, parse_adjustments

    settings = settings or ExportSettings()
    device = torch.device(device if device is not None else "cuda")
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    paths = list(paths)
    total = len(paths)
    results: dict[int, ExportResult] = {}
    res_lock = threading.Lock()
    global _peak_prepared, _live_prepared
    _peak_prepared = _live_prepared = 0

    n_workers = host_worker_budget()
    window = prepare_window(settings.batch_size, n_workers)
    n_enc = max(1, min(n_workers, 8))
    out_dtype = "u16" if settings.format.lower() in ("png", "tif", "tiff") else "u8"

    def prep_safe(idx: int, p: str):
        t0 = time.perf_counter()
        try:
            prep = _prepare_one(p, settings, app_settings=app_settings, device=device)
            _track_prepared(+1)
            return idx, p, prep, time.perf_counter() - t0, None
        except Exception as e:  # noqa: BLE001 — per-image isolation
            return idx, p, None, time.perf_counter() - t0, f"prepare failed: {e}"

    # encode side: bounded in-flight frames (each holds one full-res image)
    enc_sem = threading.BoundedSemaphore(n_enc * 2)
    claimed_paths: set = set()

    # {sequence} and virtual-copy appearance numbers follow INPUT order
    # (file_management.rs:3264-3292 numbers the request list), not bucket
    # flush order, so re-exports of the same list name files the same way
    appearance_by_idx: dict[int, int] = {}
    occ: dict[str, int] = {}
    for i, p in enumerate(paths):
        real, _ = parse_virtual_path(p)
        occ[real] = occ.get(real, 0) + 1
        appearance_by_idx[i] = occ[real]

    def encode_one(idx, p, planar, dt, n_in_chunk, mask_prep=None):
        # output paths are claimed here, in the render loop (one thread), so
        # two sources that template to the same name can't overwrite each
        # other (2023/IMG_0001.CR2 + 2024/IMG_0001.CR2 without
        # preserve_folders both map to IMG_0001_edited.jpg)
        real, vc = parse_virtual_path(p)
        try:
            created = get_creation_date(real)  # one EXIF read: name + utime
        except Exception:  # noqa: BLE001 — missing/unreadable source EXIF
            import datetime as _dt

            created = _dt.datetime.now()
        dst = _output_path(real, out_dir, settings, idx + 1, total=total, vc=vc,
                           appearance=appearance_by_idx[idx], created=created)
        n_dup = 1
        while str(dst) in claimed_paths:
            dst = dst.with_name(f"{dst.stem}-{n_dup}{dst.suffix}")
            n_dup += 1
        claimed_paths.add(str(dst))

        def task():
            t_enc = time.perf_counter()
            try:
                out = planar
                if settings.long_edge or settings.watermark is not None:
                    scale = 255.0 if out.dtype == np.uint8 else 65535.0
                    out = out.astype(np.float32) / np.float32(scale)
                if settings.long_edge:
                    out = _resize_host(out, settings)
                if settings.watermark is not None:
                    out = apply_watermark(out, settings.watermark)
                encode_image(out, dst, settings.format, settings.quality)
                if settings.copy_exif:
                    copy_exif(real, dst, strip_gps_data=settings.strip_gps)
                if settings.preserve_timestamps:
                    _restore_timestamps(real, dst, created=created)
                if settings.export_masks:
                    # the render loop's decoded image and mask bitmaps: no
                    # second decode of the source
                    _export_masks_for_image(p, dst, settings, app_settings,
                                            prepared=mask_prep, device=device)
                r = ExportResult(p, str(dst), True, seconds=dt / n_in_chunk)
            except Exception as e:  # noqa: BLE001
                r = ExportResult(p, None, False, f"encode failed: {e}")
            finally:
                _stat_add("encode_s", time.perf_counter() - t_enc)
                _track_prepared(-1)
                enc_sem.release()
            with res_lock:
                results[idx] = r

        return task

    # PRE-SCAN sidecars (JSON only — no pixel IO) so each structural
    # bucket's config union is known before the first chunk renders:
    # chunks of a bucket then share one merged config instead of growing it
    pre_union: dict = {}
    for p in paths:
        try:
            adj = dict(load_adjustments(p))
            adj["showClipping"] = False
            is_raw = is_raw_file(parse_virtual_path(p)[0])
            # the same tonemapper override as _prepare_one: it flips
            # cfg.tonemapper_agx, which is part of the bucket key
            _, pcfg = parse_adjustments(
                adj, is_raw=is_raw,
                tonemapper_override=(
                    app_settings.tonemapper_override(is_raw)
                    if app_settings is not None else None
                ),
            )
            k = _cfg_key(pcfg)
            pre_union[k] = merge_configs([pre_union[k], pcfg]) if k in pre_union else pcfg
        except Exception:  # noqa: BLE001 — the prescan is advisory
            continue

    # chunk accumulation by structural bucket (shape + unmergeable config
    # fields + LUT content); a bucket's union starts from the prescan
    chunks: dict = {}
    union_cfg: dict = {}

    def render_chunk(key):
        # device-side failures are isolated per BUCKET, as prepare/encode
        # failures are per image: one bad bucket must not abort the batch
        chunk = chunks.pop(key)
        try:
            _render_chunk_inner(key, chunk)
        except Exception as e:  # noqa: BLE001
            for c in chunk:
                _track_prepared(-1)
                with res_lock:
                    results[c["idx"]] = ExportResult(c["path"], None, False,
                                                     f"render failed: {e}")

    def _render_chunk_inner(key, chunk):
        t0 = time.perf_counter()
        imgs = torch.stack([c["timg"] for c in chunk])
        params, cfg = stack_params([c["params"] for c in chunk], [c["cfg"] for c in chunk],
                                   cfg=union_cfg[key], device=imgs.device)
        masks = None
        blur_bands = None
        if cfg.mask_count > 0:
            n = cfg.mask_count
            h, w = imgs.shape[-2:]
            mstack = []
            for c in chunk:
                m = c["masks"] if c["masks"] is not None else np.zeros((0, h, w), np.float32)
                if m.shape[0] < n:
                    m = np.concatenate([m, np.zeros((n - m.shape[0], h, w), np.float32)])
                mstack.append(m[:n])
            mnp = np.stack(mstack)
            blur_bands = blur_band_rows(cfg, mnp)
            masks = torch.from_numpy(mnp).to(imgs.device)
        lut = (torch.from_numpy(chunk[0]["lut"]).to(imgs.device)
               if chunk[0]["lut"] is not None else None)
        out = _render_chunk(imgs, params, masks, lut, cfg, blur_bands=blur_bands,
                            out_dtype=out_dtype)
        dt = time.perf_counter() - t0
        _stat_add("render_s", dt)
        _stat_add("frames", len(chunk))
        tasks = [encode_one(c["idx"], c["path"], out[b], dt, len(chunk),
                            mask_prep=(c["timg"], c["masks"]) if settings.export_masks else None)
                 for b, c in enumerate(chunk)]
        for t in tasks:
            enc_sem.acquire()
            enc_pool.submit(t)

    with ThreadPoolExecutor(n_workers) as prep_pool, ThreadPoolExecutor(n_enc) as enc_pool:
        path_iter = iter(enumerate(paths))
        pend: collections.deque = collections.deque()

        def submit_more():
            while len(pend) < window:
                try:
                    i, p = next(path_iter)
                except StopIteration:
                    return
                if cancel is not None and cancel.cancelled:
                    with res_lock:
                        results[i] = ExportResult(p, None, False, "cancelled")
                    continue
                pend.append(prep_pool.submit(prep_safe, i, p))

        done_in = 0
        submit_more()
        while pend:
            idx, p, prep, _tprep, err = pend.popleft().result()
            done_in += 1
            if progress:
                progress(done_in - 1, total, p)
            if cancel is not None and cancel.cancelled and prep is not None:
                _track_prepared(-1)
                prep = None
                err = "cancelled"
            if err is not None:
                with res_lock:
                    results[idx] = ExportResult(p, None, False, err)
            else:
                timg, masks, params, cfg, lut = prep
                key = (tuple(timg.shape), cfg.is_raw, cfg.tonemapper_agx, cfg.ca_static_rc,
                       cfg.ca_static_by, _lut_fingerprint(lut))
                chunks.setdefault(key, []).append({
                    "idx": idx, "path": p, "timg": timg, "masks": masks,
                    "params": params, "cfg": cfg, "lut": lut,
                })
                try:
                    seed = ([union_cfg[key]] if key in union_cfg
                            else [pre_union[_cfg_key(cfg)]] if _cfg_key(cfg) in pre_union
                            else [])
                    union_cfg[key] = merge_configs(seed + [cfg])
                except ValueError:
                    # unmergeable despite the structural key: render what
                    # accumulated under the old union, restart the bucket
                    full = chunks.pop(key)
                    chunks[key] = full[:-1]
                    if chunks[key]:
                        render_chunk(key)
                    else:
                        chunks.pop(key)
                    chunks[key] = [full[-1]]
                    union_cfg[key] = cfg
                if len(chunks.get(key, ())) >= settings.batch_size:
                    render_chunk(key)
                elif sum(len(v) for v in chunks.values()) >= window:
                    # bound accumulated chunks too: flush the fullest bucket
                    render_chunk(max(chunks, key=lambda k: len(chunks[k])))
            submit_more()

        for key in list(chunks):
            if cancel is not None and cancel.cancelled:
                for c in chunks.pop(key):
                    _track_prepared(-1)
                    with res_lock:
                        results[c["idx"]] = ExportResult(c["path"], None, False, "cancelled")
                continue
            render_chunk(key)

    if progress:
        progress(total, total, "")
    return [results[i] for i in sorted(results)]


def _export_masks_for_image(path: str, main_output: Path, settings: ExportSettings,
                            app_settings=None, prepared=None, device=None) -> None:
    """Per-mask image + alpha export (export_processing.rs:471-585), as JAX
    `_export_masks_for_image` (export.py:826-924).

    `prepared`: (timg, bitmaps) handed over from the render loop, which has
    already decoded, transformed and rasterized this image; otherwise they
    are made here on `device`. For each visible mask: the image rendered
    with only that mask's adjustments, applied everywhere (a white
    influence map), resized, watermarked and encoded as
    `{stem}_mask_{i}_image.{ext}` with EXIF and timestamps, and the mask's
    bitmap as an 8-bit grey `{stem}_mask_{i}_alpha.png`, resized to the
    image's size with PIL's 8-bit LANCZOS (`lanczos_resize_u8`)."""
    from rapidraw_tpu_torch.geometry.resize import lanczos_resize_u8
    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.encode import encode_image, png_bytes
    from rapidraw_tpu_torch.io.exif import copy_exif
    from rapidraw_tpu_torch.io.loader import is_raw_file, load_image, parse_virtual_path
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.masks.rasterize import rasterize_masks, resolve_warped_image
    from rapidraw_tpu_torch.params.parse import parse_adjustments

    real, _vc = parse_virtual_path(path)
    is_raw = is_raw_file(real)
    adj = dict(load_adjustments(path))
    adj["showClipping"] = False
    masks_json = [m for m in (adj.get("masks") or [])
                  if isinstance(m, dict) and m.get("visible", False)]
    if not masks_json:
        return
    if prepared is not None:
        timg, bitmaps = prepared
    else:
        img, is_raw = load_image(path, app_settings=app_settings, device=device)
        timg, crop_offset = apply_all_transformations(img, adj)
        _, h, w = timg.shape
        bitmaps = rasterize_masks(adj, w, h, scale=1.0, crop_offset=crop_offset,
                                  warped_image=resolve_warped_image(img, adj, is_raw))
    if bitmaps is None:
        return
    _, h, w = timg.shape
    white = np.ones((1, h, w), np.float32)
    out_dir, stem = main_output.parent, main_output.stem
    ext = main_output.suffix.lstrip(".")
    tm = app_settings.tonemapper_override(is_raw) if app_settings is not None else None
    # rasterize_masks caps bitmaps at MAX_MASKS: export the same subset
    for i, mdef in enumerate(masks_json[: bitmaps.shape[0]]):
        single = dict(adj)
        single["masks"] = [mdef]
        params, cfg = parse_adjustments(single, is_raw=is_raw, tonemapper_override=tm)
        out = develop_single(timg, params, cfg, masks=white).cpu().numpy()
        if settings.long_edge:
            out = _resize_host(out, settings)
        if settings.watermark is not None:
            out = apply_watermark(out, settings.watermark)
        img_path = out_dir / f"{stem}_mask_{i}_image.{ext}"
        encode_image(out, img_path, settings.format, settings.quality)
        if settings.copy_exif:
            # the real file: a virtual '?vc=N' path reads no EXIF
            copy_exif(real, img_path, strip_gps_data=settings.strip_gps)
        if settings.preserve_timestamps:
            _restore_timestamps(real, img_path)
        _, oh, ow = out.shape
        alpha = (np.clip(bitmaps[i], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        (out_dir / f"{stem}_mask_{i}_alpha.png").write_bytes(
            png_bytes(lanczos_resize_u8(alpha, ow, oh)))


_ESTIMATE_DIM = 1280  # export_processing.rs:1118


def estimate_export_sizes(
    paths: list[str], settings: ExportSettings | None = None, app_settings=None,
    device=None,
) -> int:
    """Estimated total output bytes (export_processing.rs:1020-1210).

    Renders the FIRST image at <=1280 px on `device` (the card unless
    asked), encodes it with the requested format and quality, and
    extrapolates by the output-pixel ratio x len(paths). `.cube` exports
    are a flat ~1.05 MB each. The probe renders under the same app
    settings as export_images (export_processing.rs:1113)."""
    settings = settings or ExportSettings()
    if settings.format.lower() == "cube":
        return 1_050_000 * len(paths)
    if not paths:
        return 0

    import tempfile

    from rapidraw_tpu_torch.geometry.resize import downscale
    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.encode import encode_image, png_bytes
    from rapidraw_tpu_torch.io.loader import load_image, to_uint8_hwc
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.masks.rasterize import (
        rasterize_masks, requires_warped_image, resolve_warped_image,
    )
    from rapidraw_tpu_torch.params.parse import parse_adjustments

    device = torch.device(device if device is not None else "cuda")
    img, is_raw = load_image(paths[0], app_settings=app_settings, device=device)
    adj = dict(load_adjustments(paths[0]))
    adj["showClipping"] = False
    timg, crop_offset = apply_all_transformations(img, adj)
    _, fh, fw = timg.shape

    scale = min(1.0, _ESTIMATE_DIM / max(fh, fw))
    if scale < 1.0:
        ph, pw = max(1, round(fh * scale)), max(1, round(fw * scale))
        preview = downscale(timg, pw, ph)
    else:
        ph, pw = fh, fw
        preview = timg
    masks = rasterize_masks(
        adj, pw, ph, scale=scale,
        crop_offset=(crop_offset[0] * scale, crop_offset[1] * scale),
        # colour/luminance range masks need the warped source
        warped_image=(resolve_warped_image(img, adj, is_raw)
                      if requires_warped_image(adj) else None),
    )
    tm_override = app_settings.tonemapper_override(is_raw) if app_settings is not None else None
    params, cfg = parse_adjustments(adj, is_raw=is_raw, tonemapper_override=tm_override)
    lut = None
    if cfg.has_lut and isinstance(adj.get("lutPath"), str):
        # the probe applies the document LUT as the export will
        from rapidraw_tpu_torch.io.lut import parse_lut_file

        try:
            lut = torch.from_numpy(np.asarray(parse_lut_file(adj["lutPath"]), np.float32))
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001
            cfg = dataclasses.replace(cfg, has_lut=False)
    out = develop_single(preview, params, cfg, masks=masks, lut=lut).cpu().numpy()

    # probe through the REAL encoder (the reference sizes the preview with
    # encode_image_to_bytes, export_processing.rs:1138-1143)
    try:
        with tempfile.NamedTemporaryFile(suffix=f".{settings.format.lower()}",
                                         delete=False) as tf:
            probe_path = tf.name
        try:
            encode_image(out, probe_path, settings.format, settings.quality)
            preview_bytes = os.path.getsize(probe_path)
        finally:
            try:
                os.unlink(probe_path)
            except OSError:
                pass
    except ValueError:
        preview_bytes = len(png_bytes(np.ascontiguousarray(to_uint8_hwc(out))))

    out_h, out_w = fh, fw
    tgt = calculate_resize_target(fw, fh, settings)
    if tgt is not None:
        out_w, out_h = tgt
    ratio = (out_h * out_w) / float(ph * pw)
    return int(preview_bytes * ratio) * len(paths)
