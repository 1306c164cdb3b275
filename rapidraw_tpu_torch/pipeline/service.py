"""Interactive render service — the headless equivalent of the reference's
preview worker (lib.rs:330-721).

Port of `rapidraw_tpu/pipeline/service.py`. The flow, on the card unless
the caller asks for another device:
  * decoded-image LRU keyed by path (cache_utils.rs DecodedImageCache),
    holding the image on the device;
  * transformed-preview cache keyed by the transform hash
    (lib.rs:156-217 + cache_utils.rs:70-150), holding the DEVICE tensor;
  * mask bitmap cache keyed by (definition, size, scale, crop) hash
    (mask_generation.rs:1459-1511), bitmaps on the host;
  * interactive quality divisor + JPEG quality from settings
    (lib.rs:364-368);
  * optional ROI rendering (gpu_processing.rs Roi): the ROI is cut from the
    transformed preview before develop, like the tile path, and made
    contiguous once (the kernels' wrappers refuse strided views).

Each render is one call of the port's `develop` (the blur, NR, flare and
grade kernels on a CUDA tensor), quantized on the device (`device_u8`),
read back and encoded by the port's JPEG encoder (csrc/host/jpeg_enc.cc,
PIL's bytes). `PreviewWorker` coalesces preview jobs on a worker thread
(drain-to-latest) and `AnalyticsWorker` computes the scopes off the render
path; callers may also use the synchronous API (`render_preview`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from rapidraw_tpu_torch.utils.hashing import LruCache, calculate_transform_hash
from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings
from rapidraw_tpu_torch.utils.trace import Stages, mark_stage


@dataclasses.dataclass
class PreviewResult:
    jpeg: bytes
    width: int
    height: int
    full_width: int
    full_height: int
    roi: tuple[int, int, int, int] | None
    seconds: float
    histogram: dict | None = None
    waveform: dict | None = None
    # with RenderService.time_stages: host ms per stage of this render (a
    # device synchronize at each boundary) and, on a CUDA device, the
    # develop's device ms from CUDA events; None otherwise
    stages: dict | None = None

    def to_binary(self) -> bytes:
        """The reference's interactive reply framing (lib.rs:575-582):
        six little-endian u32 [x, y, w, h, fullW, fullH] + the JPEG bytes.
        ROI-less renders use x=y=0 with the full preview dims."""
        x, y = (self.roi[0], self.roi[1]) if self.roi else (0, 0)
        header = struct.pack(
            "<6I", x, y, self.width, self.height, self.full_width, self.full_height
        )
        return header + self.jpeg


class RenderService:
    """Previews of one editing session. `device`: where images, previews
    and LUT cubes live and develop runs — the CUDA device unless the caller
    asks for another (the tests pass "cpu"). `time_stages=True` splits each
    render_preview's time by stage into PreviewResult.stages (a synchronize
    per stage on the card); off, a render takes no marks and no events."""

    def __init__(self, settings: AppSettings | None = None, device=None,
                 time_stages: bool = False):
        if settings is None:
            settings = AppSettings(DEFAULTS)
        self.settings = settings
        self.device = torch.device(device if device is not None else "cuda")
        self.time_stages = time_stages
        self._decoded = LruCache(self.settings.image_cache_size)
        self._transformed = LruCache(8)
        self._mask_cache = LruCache(50)  # cap like mask_generation.rs:1503
        self._geometry_base = LruCache(6)  # graded geometry-preview base (lib.rs:1007)
        self._warped_cache = LruCache(1)  # full warped image (lib.rs:260-288)
        self._lut_cache = LruCache(4)  # parsed + device-resident 3D LUTs

    # -- loading ----------------------------------------------------------
    def load(self, path: str) -> tuple[torch.Tensor, bool]:
        hit = self._decoded.get(path)
        if hit is not None:
            return hit
        from rapidraw_tpu_torch.io.exif import persist_exif_if_missing
        from rapidraw_tpu_torch.io.loader import load_image

        # preserve the source EXIF into the sidecar on first load
        # (image_loader.rs:81 persist_exif_if_missing)
        persist_exif_if_missing(path)
        img, is_raw = load_image(path, app_settings=self.settings, device=self.device)
        self._decoded.put(path, (img, is_raw))
        return img, is_raw

    # -- caches -----------------------------------------------------------
    def _transformed_preview(self, path: str, adjustments: dict, long_edge: int,
                             stages: Stages | None = None):
        from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
        from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations

        key = (path, calculate_transform_hash(adjustments), long_edge)
        hit = self._transformed.get(key)
        if hit is not None:
            return hit
        img, is_raw = self.load(path)
        mark_stage(stages, "load")
        x, crop_offset = apply_all_transformations(img, adjustments)
        full_h, full_w = int(x.shape[1]), int(x.shape[2])
        # the DEVICE tensor is cached: a host copy would re-upload the f32
        # preview (~28 MB at 1920 long edge) on every cache-hit frame. A
        # crop is a strided view: made contiguous once here
        x = downscale_to_long_edge(x, long_edge).contiguous()
        entry = (x, crop_offset, (full_w, full_h), is_raw)
        self._transformed.put(key, entry)
        mark_stage(stages, "transform")
        return entry

    def _warped_for_masks(self, path: str, adjustments: dict):
        """Geometry-warped full image for color/luminance masks, cached by
        (path, geometry hash) like lib.rs:260-288."""
        from rapidraw_tpu_torch.masks.rasterize import (
            requires_warped_image, resolve_warped_image,
        )
        from rapidraw_tpu_torch.utils.hashing import calculate_geometry_hash

        if not requires_warped_image(adjustments):
            return None
        key = (path, calculate_geometry_hash(adjustments))
        hit = self._warped_cache.get(key)
        if hit is not None:
            return hit
        img, is_raw = self.load(path)
        warped = resolve_warped_image(img, adjustments, is_raw)
        self._warped_cache.put(key, warped)
        return warped

    def _masks(
        self, path: str, adjustments: dict, w: int, h: int, scale: float,
        crop_offset, warped_image=None,
    ):
        from rapidraw_tpu_torch.utils.hashing import calculate_geometry_hash

        mask_defs = adjustments.get("masks")
        # keyed by image identity + geometry hash as well: color/luminance
        # masks sample the warped IMAGE, so same-shaped defs on a different
        # photo (or after a geometry change) must not hit the same bitmaps
        # (mask_generation.rs:1459-1511 hashes per image render job).
        # Each mask's grading "adjustments" are NOT part of the key — the
        # rasterizer never reads them, and keying on them re-rasterized
        # every bitmap on every masked-slider scrub frame.
        key_defs = [
            {k: v for k, v in m.items() if k != "adjustments"}
            if isinstance(m, dict) else m
            for m in (mask_defs or [])
        ] or None
        key_src = json.dumps(
            {"p": path, "g": calculate_geometry_hash(adjustments),
             "m": key_defs, "w": w, "h": h, "s": scale, "c": crop_offset},
            sort_keys=True, default=str,
        )
        key = hashlib.blake2b(key_src.encode(), digest_size=8).hexdigest()
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        from rapidraw_tpu_torch.masks import rasterize

        masks = rasterize.rasterize_masks(
            adjustments, w, h, scale=scale,
            crop_offset=(crop_offset[0] * scale, crop_offset[1] * scale),
            warped_image=warped_image,
        )
        self._mask_cache.put(key, masks)
        return masks

    def _develop(self, x: torch.Tensor, adjustments: dict, is_raw: bool, masks,
                 stages: Stages | None = None) -> np.ndarray:
        """parse -> LUT -> develop on x's device -> device_u8 -> host
        (3, H, W) u8. masks: host (N, H, W) bitmaps, uploaded once."""
        from rapidraw_tpu_torch.params.parse import parse_adjustments
        from rapidraw_tpu_torch.pipeline.develop import develop
        from rapidraw_tpu_torch.pipeline.export import device_u8

        tonemapper_override = self.settings.tonemapper_override(is_raw)
        params, cfg = parse_adjustments(adjustments, is_raw, tonemapper_override)
        lut = self._load_lut(adjustments, cfg)
        if lut is None and cfg.has_lut:
            cfg = dataclasses.replace(cfg, has_lut=False)
        mk = None
        if masks is not None:
            mk = torch.from_numpy(np.ascontiguousarray(masks, np.float32)).to(x.device)
        mark_stage(stages, "parse")
        events = None
        if stages is not None and x.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        y = device_u8(develop(x, params, cfg, masks=mk, lut=lut))
        if events is not None:
            events[1].record()
        mark_stage(stages, "develop")
        out = y.cpu().numpy()
        mark_stage(stages, "readback")
        if events is not None:
            stages.ms["develop_device"] = events[0].elapsed_time(events[1])
        return out

    # -- main entry (process_preview_job, lib.rs:330-614) ------------------
    def render_preview(
        self,
        path: str,
        adjustments: dict | None = None,
        interactive: bool = False,
        roi: tuple[float, float, float, float] | None = None,
        compute_histogram: bool = False,
        compute_waveform: bool = False,
    ) -> PreviewResult:
        from rapidraw_tpu_torch.geometry.resize import downscale
        from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
        from rapidraw_tpu_torch.io.sidecar import load_adjustments

        t0 = time.perf_counter()
        stages = Stages(self.device) if self.time_stages else None
        adjustments = adjustments if adjustments is not None else load_adjustments(path)

        long_edge = self.settings.editor_preview_resolution
        x, crop_offset, (full_w, full_h), is_raw = self._transformed_preview(
            path, adjustments, long_edge, stages
        )
        divisor, quality = self.settings.preview_quality(interactive)

        _, h, w = x.shape
        scale = h / full_h if full_h else 1.0
        warped = self._warped_for_masks(path, adjustments)
        masks = self._masks(
            path, adjustments, w, h, scale, crop_offset, warped_image=warped
        )
        mark_stage(stages, "masks")

        # the reference applies the interactive quality divisor BEFORE ROI
        # normalization (lib.rs:430-457): ROI x/y/w/h, the render, and the
        # reply's full dims all live in ONE (possibly divisor-downscaled)
        # preview coordinate space
        xj = x
        if divisor > 1.0:
            xj = downscale(
                xj, max(int(xj.shape[2] / divisor), 1), max(int(xj.shape[1] / divisor), 1)
            )
            if masks is not None:
                # nearest-index resampling on the host: the bitmaps upload once
                h2, w2 = int(xj.shape[1]), int(xj.shape[2])
                iy = (np.arange(h2) * masks.shape[1] / h2).astype(np.int64)
                ix = (np.arange(w2) * masks.shape[2] / w2).astype(np.int64)
                masks = masks[:, iy[:, None], ix[None, :]]
        ph, pw = int(xj.shape[1]), int(xj.shape[2])

        roi_px = None
        if isinstance(roi, dict):
            # the reference wire format is the 4-array [x, y, w, h]
            # (useImageProcessing.ts:116), but its Rust-side Roi struct
            # names the fields (gpu_processing.rs:17-22) — accept that
            # spelling too instead of a KeyError
            try:
                roi = (roi["x"], roi["y"],
                       roi["width"] if "width" in roi else roi["w"],
                       roi["height"] if "height" in roi else roi["h"])
            except KeyError as e:
                raise ValueError(
                    "roi dict needs x/y/width/height keys (or pass the "
                    "normalized 4-sequence [x, y, w, h])"
                ) from e
        if roi is not None:
            # normalized ROI (lib.rs:448-457) clamped into the preview;
            # rx/ry cap at dim-1 so the crop is never empty
            rx = min(int(max(0.0, min(roi[0], 1.0)) * pw), pw - 1)
            ry = min(int(max(0.0, min(roi[1], 1.0)) * ph), ph - 1)
            rw = min(max(int(roi[2] * pw), 1), pw - rx)
            rh = min(max(int(roi[3] * ph), 1), ph - ry)
            roi_px = (rx, ry, rw, rh)
            xj = xj[:, ry : ry + rh, rx : rx + rw].contiguous()
            if masks is not None:
                masks = masks[:, ry : ry + rh, rx : rx + rw]
        mark_stage(stages, "divisor_roi")

        out = self._develop(xj, adjustments, is_raw, masks, stages)

        histogram = waveform = None
        if compute_histogram or compute_waveform:
            from rapidraw_tpu_torch.analysis.scopes import calculate_histogram, calculate_waveform

            if compute_histogram:
                histogram = calculate_histogram(out)
            if compute_waveform:
                waveform = calculate_waveform(out)
            mark_stage(stages, "scopes")

        jpeg = encode_jpeg_bytes(out, quality=quality)
        mark_stage(stages, "encode")
        return PreviewResult(
            jpeg=jpeg,
            width=out.shape[2],
            height=out.shape[1],
            # the reply's full dims are the PROCESSING preview's (the same
            # coordinate space as x/y/w/h), matching the reference's
            # preview_width/preview_height framing (lib.rs:575-582)
            full_width=pw,
            full_height=ph,
            roi=roi_px,
            seconds=time.perf_counter() - t0,
            histogram=histogram,
            waveform=waveform,
            stages=stages.ms if stages is not None else None,
        )

    def auto_adjustments(self, path: str) -> dict[str, Any]:
        from rapidraw_tpu_torch.analysis.auto_adjust import calculate_auto_adjustments

        img, _ = self.load(path)
        return calculate_auto_adjustments(img)

    # -- secondary previews (lib.rs:723-1099) -------------------------------
    def render_uncropped_preview(self, path: str, adjustments: dict | None = None) -> bytes:
        """Crop-less render for the crop tool (lib.rs:723-853): geometry warp
        + 90-degree steps + flips are applied, but NOT crop or fine rotation;
        masks are generated at the uncropped size with zero crop offset."""
        from rapidraw_tpu_torch.geometry.params import (
            geometry_params_from_json, is_geometry_identity,
        )
        from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
        from rapidraw_tpu_torch.geometry.transforms import apply_coarse_rotation, apply_flip
        from rapidraw_tpu_torch.geometry.warp import warp_image_geometry
        from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
        from rapidraw_tpu_torch.io.sidecar import load_adjustments
        from rapidraw_tpu_torch.masks.patches import composite_patches_on_image

        adjustments = adjustments if adjustments is not None else load_adjustments(path)
        x, is_raw = self.load(path)
        if adjustments.get("aiPatches"):
            x = composite_patches_on_image(x, adjustments)
        gp = geometry_params_from_json(adjustments)
        if not is_geometry_identity(gp):
            x = warp_image_geometry(x, gp)
        x = apply_coarse_rotation(x, int(adjustments.get("orientationSteps") or 0))
        x = apply_flip(
            x,
            bool(adjustments.get("flipHorizontal")),
            bool(adjustments.get("flipVertical")),
        )
        pre_h, pre_w = int(x.shape[1]), int(x.shape[2])
        x = downscale_to_long_edge(x, self.settings.editor_preview_resolution).contiguous()
        _, h, w = x.shape
        scale = w / pre_w if pre_w else 1.0
        warped = self._warped_for_masks(path, adjustments)
        masks = self._masks(path, adjustments, w, h, scale, (0.0, 0.0), warped_image=warped)
        out = self._develop(x, adjustments, is_raw, masks)
        return encode_jpeg_bytes(out, quality=80)

    def render_original_preview(
        self, path: str, adjustments: dict | None = None, target_resolution: int | None = None
    ) -> bytes:
        """Before/after view (lib.rs:855-901): full geometry transforms,
        NO grade. RAW sources get the default gamma-2.38/contrast-1.28 look
        (image_processing.rs:940-961)."""
        from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
        from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
        from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
        from rapidraw_tpu_torch.io.sidecar import load_adjustments
        from rapidraw_tpu_torch.pipeline.export import device_u8

        adjustments = adjustments if adjustments is not None else load_adjustments(path)
        x, is_raw = self.load(path)
        if is_raw:
            g = torch.pow(torch.clamp_min(x, 0.0), 1.0 / 2.38)
            x = torch.clamp((g - 0.5) * 1.28 + 0.5, 0.0, 1.0)
        x, _ = apply_all_transformations(x, adjustments)
        dim = target_resolution or self.settings.editor_preview_resolution
        x = downscale_to_long_edge(x, dim)
        return encode_jpeg_bytes(device_u8(x).cpu().numpy(), quality=80)

    def preview_geometry_transform(
        self,
        path: str,
        geometry: Any,
        adjustments: dict | None = None,
        show_lines: bool = False,
    ) -> bytes:
        """Interactive geometry preview (lib.rs:903-1099): a cached GRADED
        base (geometry neutralized, on the device) is re-warped with the
        live parameters; optionally overlays Canny+Hough straightening
        guides (green when aligned to 0/90 degrees within 0.5, red
        otherwise; pipeline/guides.py)."""
        from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
        from rapidraw_tpu_torch.geometry.transforms import apply_coarse_rotation, apply_flip
        from rapidraw_tpu_torch.geometry.warp import warp_image_geometry
        from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes
        from rapidraw_tpu_torch.io.sidecar import load_adjustments
        from rapidraw_tpu_torch.params.parse import parse_adjustments
        from rapidraw_tpu_torch.pipeline.develop import develop
        from rapidraw_tpu_torch.pipeline.export import device_u8
        from rapidraw_tpu_torch.utils.hashing import GEOMETRY_KEYS, calculate_visual_hash

        adjustments = adjustments if adjustments is not None else load_adjustments(path)
        vh = calculate_visual_hash(path, adjustments)
        base = self._geometry_base.get(vh)
        img, is_raw = self.load(path)
        if base is None:
            dim = int(self.settings.editor_preview_resolution / 1.5)
            x = downscale_to_long_edge(img, dim).contiguous()
            neutral = dict(adjustments)
            neutral["crop"] = None
            # the geometry/crop base renders WITHOUT mask gradings (their
            # bitmaps are rasterized in crop space, which this view is
            # changing; develop would refuse a mask count without bitmaps)
            neutral["masks"] = []
            neutral["rotation"] = 0.0
            neutral["orientationSteps"] = 0
            neutral["flipHorizontal"] = False
            neutral["flipVertical"] = False
            for key in GEOMETRY_KEYS:
                if key in ("transformScale", "lensDistortionAmount",
                           "lensVignetteAmount", "lensTcaAmount"):
                    neutral[key] = 100.0
                elif key in ("lensDistortionParams", "lensMaker", "lensModel"):
                    neutral[key] = None
                elif key in ("lensDistortionEnabled", "lensTcaEnabled", "lensVignetteEnabled"):
                    neutral[key] = True
                else:
                    neutral[key] = 0.0
            tonemapper_override = self.settings.tonemapper_override(is_raw)
            params, cfg = parse_adjustments(neutral, is_raw, tonemapper_override)
            lut = self._load_lut(neutral, cfg)
            if lut is None and cfg.has_lut:
                cfg = dataclasses.replace(cfg, has_lut=False)
            base = develop(x, params, cfg, lut=lut)
            if len(self._geometry_base) > 5:  # cap like lib.rs:1007-1010
                self._geometry_base.clear()
            self._geometry_base.put(vh, base)

        geometry = dataclasses.replace(
            geometry,
            lens_vignette_amount=geometry.lens_vignette_amount * (0.4 if is_raw else 0.8),
        )
        warped = warp_image_geometry(base, geometry)
        warped = apply_coarse_rotation(warped, int(adjustments.get("orientationSteps") or 0))
        warped = apply_flip(
            warped,
            bool(adjustments.get("flipHorizontal")),
            bool(adjustments.get("flipVertical")),
        )
        out = device_u8(warped).cpu().numpy()
        if show_lines:
            from rapidraw_tpu_torch.pipeline.guides import draw_straightening_guides

            out = draw_straightening_guides(out)
        return encode_jpeg_bytes(out, quality=75)

    def render_preset_preview(self, path: str, adjustments: dict) -> bytes:
        """400px preset thumbnail render (lib.rs:1114-1213)."""
        from rapidraw_tpu_torch.io.encode import encode_jpeg_bytes

        x, crop_offset, (full_w, full_h), is_raw = self._transformed_preview(
            path, adjustments, 400
        )
        _, h, w = x.shape
        scale = h / full_h if full_h else 1.0
        warped = self._warped_for_masks(path, adjustments)
        masks = self._masks(path, adjustments, w, h, scale, crop_offset, warped_image=warped)
        out = self._develop(x, adjustments, is_raw, masks)
        return encode_jpeg_bytes(out, quality=80)

    def _load_lut(self, adjustments: dict, cfg):
        if not (cfg.has_lut and isinstance(adjustments.get("lutPath"), str)):
            return None
        from rapidraw_tpu_torch.io import lut as lutmod
        from rapidraw_tpu_torch.native import KernelBuildError

        path = adjustments["lutPath"]
        try:
            # keyed by (path, mtime): re-parsing a 65³ .cube is hundreds of
            # thousands of text lines and a fresh device upload — paying
            # that per interactive frame dwarfed the develop itself
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            mtime = None
        key = (path, mtime)
        hit = self._lut_cache.get(key)
        if hit is not None:
            return hit
        try:
            cube = np.asarray(lutmod.parse_lut_file(path), np.float32)
        except KernelBuildError:  # a HALD image's decoder that does not build
            raise
        except Exception:  # noqa: BLE001 - an unreadable LUT is skipped, as in JAX
            return None
        lut = torch.from_numpy(np.ascontiguousarray(cube)).to(self.device)
        self._lut_cache.put(key, lut)
        return lut

    def clear_caches(self) -> None:
        self._decoded.clear()
        self._transformed.clear()
        self._mask_cache.clear()
        self._geometry_base.clear()
        self._warped_cache.clear()
        self._lut_cache.clear()

    def is_image_cached(self, path: str) -> bool:
        """Whether the decoded full image is resident (lib.rs
        is_image_cached): a hit means switching to this photo skips the
        decode."""
        return self._decoded.get(path) is not None


def _safe_callback(cb, arg) -> None:
    """Deliver a worker result without letting a raising embedder callback
    kill the worker thread (the reference's workers loop forever,
    lib.rs:650-683 / gpu_processing.rs:1882-1948)."""
    try:
        cb(arg)
    except Exception:  # noqa: BLE001
        from rapidraw_tpu_torch.utils.trace import log

        log.exception("worker callback raised")


class _LatestWorker:
    """One background thread over a single-slot latest-job queue:
    submitting while a job runs REPLACES the pending one (drain-to-latest).
    Results arrive on `callback(result)`; exceptions on `callback(exc)`."""

    def __init__(self, callback):
        self._callback = callback
        self._cond = threading.Condition()
        self._pending = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, job) -> None:
        with self._cond:
            self._pending = job  # replace, never queue
            self._cond.notify()

    def _work(self, job):
        raise NotImplementedError

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                job = self._pending
                self._pending = None
            try:
                result = self._work(job)
            except Exception as e:  # surfaced to the embedder, worker survives
                _safe_callback(self._callback, e)
                continue
            # a raising embedder callback must not kill the worker thread:
            # the reference's preview worker loops forever (lib.rs:650-683)
            _safe_callback(self._callback, result)

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=10)


class PreviewWorker(_LatestWorker):
    """Coalescing preview worker (lib.rs:650-683): slider scrubs render
    only the newest state. The worker thread launches on the service's
    device; its first job may build the kernel libraries (native.py builds
    each once per process, whichever thread asks first)."""

    def __init__(self, service: RenderService, callback):
        self._service = service
        super().__init__(callback)

    def submit(self, path: str, adjustments: dict | None = None, **kwargs) -> None:
        self._put((path, adjustments, kwargs))

    def _work(self, job):
        path, adjustments, kwargs = job
        return self._service.render_preview(path, adjustments, **kwargs)


class AnalyticsWorker(_LatestWorker):
    """Off-thread histogram/waveform computation
    (gpu_processing.rs:1882-1948: the async analytics readback thread) —
    scopes never block the interactive render path. Latest-wins like
    PreviewWorker."""

    def submit(self, planar) -> None:
        self._put(planar)

    def _work(self, planar):
        from rapidraw_tpu_torch.analysis.scopes import calculate_histogram, calculate_waveform

        return {
            "histogram": calculate_histogram(planar),
            "waveform": calculate_waveform(planar),
        }
