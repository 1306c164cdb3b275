"""Command-line interface of the port.

Port of `rapidraw_tpu/cli.py`, the headless user surface (the reference's
Tauri command layer for batch use), on the port's own modules:

  python -m rapidraw_tpu_torch develop IMG [-a adjustments.json] [-o out.jpg]
  python -m rapidraw_tpu_torch export IMG... -o DIR [--format jpeg] [--long-edge N]
  python -m rapidraw_tpu_torch auto IMG            # auto-adjust JSON to stdout
  python -m rapidraw_tpu_torch histogram IMG       # scope stats to stdout
  python -m rapidraw_tpu_torch lut-export -a adj.json -o grade.cube
  python -m rapidraw_tpu_torch lib|exif|preset ...
  python -m rapidraw_tpu_torch negative IMG | cull IMG... | hdr IMG... |
      denoise IMG | panorama IMG...                # the compositions

Every verb that develops or analyses an image runs on `--device`, the CUDA
device unless the caller asks for another (`--device cpu`): without a card
such a verb fails, it never carries on on the CPU. `develop` of an image
whose long edge passes 8192 px goes through the tiled develop
(pipeline/tiled.py); a smaller one through the export's single-image entry,
so `develop X` and `export X` write the same pixels. `denoise --method ai`
runs the UtNet denoiser (ai/denoise.py) on `--device`; the tagging verbs
(`tag`, `lib clear-ai-tags`) wait for slice A.13b (CLIP): they take JAX's
arguments and exit with status 2.
JAX's persistent compile cache has no counterpart: native.py keeps the
built kernels on disk.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_EXPORT_FORMATS = ("jpeg", "jpg", "png", "tiff", "tif", "webp", "avif", "jxl")
# JAX's threshold (the reference's texture cap): past it a develop's output
# is the tiled one, whose seams JAX's output has too (pipeline/tiled.py)
TILED_ABOVE = 8192
# the verbs that wait for a later slice -> that slice
_LATER = {"tag": "A.13b", "clear-ai-tags": "A.13b"}


def _require_file(path: str) -> None:
    # virtual-copy paths ('img.jpg?vc=2') are first-class CLI arguments
    # (export_processing.rs:699-718): check the real file
    from rapidraw_tpu_torch.io.loader import parse_virtual_path

    if not Path(parse_virtual_path(str(path))[0]).is_file():
        raise SystemExit(f"error: no such file: {path}")


def _default_output(image: str, tag: str, ext: str) -> str:
    """'<real stem>[_vcN]_<tag>.<ext>' beside the source."""
    from rapidraw_tpu_torch.io.loader import parse_virtual_path

    real, vc = parse_virtual_path(str(image))
    p = Path(real)
    stem = p.with_suffix("").name + (f"_vc{vc}" if vc else "")
    return str(p.parent / f"{stem}_{tag}.{ext}")


def _app_settings():
    """The app-level settings every image-loading verb shares: the RAW
    develop knobs and the tonemapper override."""
    from rapidraw_tpu_torch.utils.settings import AppSettings, app_data_dir

    return AppSettings.load(app_data_dir() / "settings.json")


def _device(args):
    """The verb's device; a CUDA device that is not there is an error."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    return dev


def _stages(args, dev):
    """The verb's stage timer (utils/trace.Stages) under --timings, else
    None: without --timings a verb takes no marks and no synchronizes."""
    from rapidraw_tpu_torch.utils.trace import Stages

    return Stages(dev) if args.timings else None


def _report(stages, main_at: float, **extra) -> None:
    """--timings: one JSON line on stderr, the epoch second the verb
    started (`main_at`), each stage's ms and `extra`."""
    if stages is not None:
        print(json.dumps({"timings": {"main_at": main_at, "stages_ms": stages.ms, **extra}}),
              file=sys.stderr)


def _launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    from rapidraw_tpu_torch.geometry import warp_fast
    from rapidraw_tpu_torch.ops import blur, flare, nr
    from rapidraw_tpu_torch.pipeline import fused

    return {"blur": blur.gaussian_blur_multi.launches, "grade": fused.grade.launches,
            "nr": nr.nr_static.launches, "nr_dynamic": nr.nr_dynamic.launches,
            "flare": flare.flare_maps.launches, "resample": warp_fast.warp_with_plan.launches}


def _cmd_develop(args) -> int:
    import dataclasses

    import torch

    from rapidraw_tpu_torch.geometry.transforms import apply_all_transformations
    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.io.sidecar import load_adjustments
    from rapidraw_tpu_torch.masks.rasterize import rasterize_masks, resolve_warped_image
    from rapidraw_tpu_torch.params.parse import parse_adjustments
    from rapidraw_tpu_torch.pipeline.export import device_u8, device_u16
    from rapidraw_tpu_torch.utils.trace import mark_stage

    _require_file(args.image)
    if args.adjustments:  # validate before the load
        _require_file(args.adjustments)
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    if stages is not None and dev.type == "cuda":
        # the develop kernels' first use: load (or build) their libraries
        from rapidraw_tpu_torch.ops import blur, flare, nr
        from rapidraw_tpu_torch.pipeline import fused

        for kernel in (blur._KERNEL, fused._KERNEL, nr._KERNEL, flare._KERNEL):
            kernel.lib()
        mark_stage(stages, "libraries")
    app_settings = _app_settings()
    img, is_raw = load_image(args.image, app_settings=app_settings, device=dev)
    mark_stage(stages, "load")
    if args.adjustments:
        adj = json.loads(Path(args.adjustments).read_text())
        if isinstance(adj.get("adjustments"), dict):
            # a full sidecar (.rrdata ImageMetadata): unwrap it
            adj = adj["adjustments"]
    else:
        adj = load_adjustments(args.image)
    # develop writes a final file: the clipping overlay is an editor aid
    # (export_processing.rs:250 forces show_clipping=0)
    adj = dict(adj)
    adj["showClipping"] = False

    timg, crop_offset = apply_all_transformations(img, adj)
    _, h, w = timg.shape
    masks = rasterize_masks(adj, w, h, scale=1.0, crop_offset=crop_offset,
                            warped_image=resolve_warped_image(img, adj, is_raw))
    params, cfg = parse_adjustments(
        adj, is_raw=is_raw, tonemapper_override=app_settings.tonemapper_override(is_raw))
    lut = None
    if cfg.has_lut:
        from rapidraw_tpu_torch.io.lut import parse_lut_file

        try:
            lut = parse_lut_file(adj["lutPath"])
        except Exception as e:  # degrade as the export's prepare does
            print(f"warning: LUT unavailable ({e}); developing without it", file=sys.stderr)
            cfg = dataclasses.replace(cfg, has_lut=False)
    mark_stage(stages, "prepare")
    if max(h, w) > TILED_ABOVE:
        from rapidraw_tpu_torch.pipeline.tiled import develop_tiled

        out = develop_tiled(timg, params, cfg, masks=masks, lut=lut)
    else:
        # the export's single-image entry: `develop X` and `export X` agree
        from rapidraw_tpu_torch.pipeline.export import develop_single

        out = develop_single(timg, params, cfg, masks=masks, lut=lut)
    mark_stage(stages, "develop")
    dst = args.output or _default_output(args.image, "edited", "jpg")
    # quantized on the device as the host encode would (16-bit for PNG and
    # TIFF from a float render): the same bytes, a quarter or half the readback
    deep = Path(dst).suffix.lower() in (".png", ".tif", ".tiff")
    frame = (device_u16 if deep else device_u8)(out).cpu().numpy()
    mark_stage(stages, "readback")
    encode_image(frame, dst, quality=args.quality)
    mark_stage(stages, "encode")
    extra = {"launches": _launches()}
    if dev.type == "cuda":
        extra["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    _report(stages, main_at, **extra)
    print(dst)
    return 0


def _cmd_export(args) -> int:
    from rapidraw_tpu_torch.pipeline.export import ExportSettings, export_images
    from rapidraw_tpu_torch.utils.trace import mark_stage

    if args.format.lower() not in _EXPORT_FORMATS:
        raise SystemExit(f"error: unsupported format {args.format!r} "
                         f"(choose from {', '.join(_EXPORT_FORMATS)})")
    for p in args.images:
        _require_file(p)
    watermark = None
    if args.watermark:
        from rapidraw_tpu_torch.pipeline.watermark import WatermarkSettings

        _require_file(args.watermark)
        watermark = WatermarkSettings(
            path=args.watermark, anchor=args.watermark_anchor, scale=args.watermark_scale,
            spacing=args.watermark_spacing, opacity=args.watermark_opacity,
        )
    settings = ExportSettings(
        format=args.format,
        quality=args.quality,
        long_edge=args.long_edge,
        resize_mode=args.resize_mode,
        dont_enlarge=not args.allow_enlarge,
        batch_size=args.batch_size,
        watermark=watermark,
        filename_template=args.template,
        preserve_folders=args.preserve_folders,
        base_origin_folders=tuple(args.base_folder),
        preserve_timestamps=args.preserve_timestamps,
        export_masks=args.export_masks,
    )
    dev = _device(args)
    # app-level settings, so the export matches the preview the user tuned
    app_settings = _app_settings()
    if args.estimate_size:
        from rapidraw_tpu_torch.pipeline.export import estimate_export_sizes

        print(estimate_export_sizes(args.images, settings, app_settings, device=dev))
        return 0

    def progress(i, n, p):
        if p:
            print(f"[{i + 1}/{n}] {p}", file=sys.stderr)

    main_at, stages = time.time(), _stages(args, dev)
    results = export_images(args.images, args.output, settings, progress,
                            app_settings=app_settings, device=dev)
    mark_stage(stages, "export")
    _report(stages, main_at, launches=_launches())
    for r in results:
        if r.ok:
            print(r.output)
        else:
            print(f"FAILED {r.source}: {r.error}", file=sys.stderr)
    return 1 if any(not r.ok for r in results) else 0


def _cmd_auto(args) -> int:
    from rapidraw_tpu_torch.analysis.auto_adjust import calculate_auto_adjustments
    from rapidraw_tpu_torch.io.loader import load_image

    _require_file(args.image)
    img, _ = load_image(args.image, app_settings=_app_settings(), device=_device(args))
    print(json.dumps(calculate_auto_adjustments(img), indent=2, ensure_ascii=False))
    return 0


def _cmd_negative(args) -> int:
    from rapidraw_tpu_torch.compositions.negative import (
        NegativeConversionParams, convert_negative,
    )
    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.utils.trace import mark_stage

    _require_file(args.image)
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    img, _ = load_image(args.image, app_settings=_app_settings(), device=dev)
    mark_stage(stages, "load")
    params = NegativeConversionParams(
        red_weight=args.red, green_weight=args.green, blue_weight=args.blue,
        exposure=args.exposure, contrast=args.contrast,
    )
    out = convert_negative(img, params).cpu().numpy()
    mark_stage(stages, "convert")
    dst = args.output or _default_output(args.image, "Positive", "tiff")
    encode_image(out, dst, quality=95)
    mark_stage(stages, "encode")
    _report(stages, main_at)
    print(dst)
    return 0


def _cmd_cull(args) -> int:
    from rapidraw_tpu_torch.compositions.culling import cull_images
    from rapidraw_tpu_torch.utils.trace import mark_stage

    for p in args.images:
        _require_file(p)
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    res = cull_images(args.images, group_similar_images=not args.no_group, device=dev)
    mark_stage(stages, "cull")
    out = {
        "groups": [
            [
                {
                    "path": a.path,
                    "qualityScore": round(a.quality_score, 4),
                    "sharpness": round(a.sharpness_metric, 2),
                    "exposure": round(a.exposure_metric, 4),
                }
                for a in g
            ]
            for g in res["groups"]
        ],
        "best": res["best"],
        "failed": res["failed"],
    }
    _report(stages, main_at)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_hdr(args) -> int:
    from rapidraw_tpu_torch.compositions.hdr import merge_hdr, read_exif_exposure
    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.ops.colorspace import linear_to_srgb, srgb_to_linear
    from rapidraw_tpu_torch.utils.trace import mark_stage

    if len(args.images) < 2:
        raise SystemExit("error: need at least two images to merge")
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    imgs, exps, isos = [], [], []
    app_settings = _app_settings()
    for p in args.images:
        _require_file(p)
        img, is_raw = load_image(p, app_settings=app_settings, device=dev)
        if not is_raw:
            img = srgb_to_linear(img)  # lib.rs:1433-1435
        exp, iso = read_exif_exposure(p)
        if exp is None or iso is None:
            raise SystemExit(f"error: {p} is missing ExposureTime/ISO EXIF data")
        imgs.append(img)
        exps.append(exp)
        isos.append(iso)
    mark_stage(stages, "load")
    out = linear_to_srgb(merge_hdr(imgs, exps, isos)).cpu().numpy()
    mark_stage(stages, "merge")
    dst = args.output or "hdr_merged.png"
    encode_image(out, dst)
    mark_stage(stages, "encode")
    _report(stages, main_at)
    print(dst)
    return 0


def _cmd_denoise(args) -> int:
    from rapidraw_tpu_torch.compositions.bm3d import run_bm3d
    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.utils.trace import mark_stage

    _require_file(args.image)
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    img, _ = load_image(args.image, app_settings=_app_settings(), device=dev)
    mark_stage(stages, "load")
    if args.method == "ai":
        from rapidraw_tpu_torch.ai.denoise import denoise_ai
        from rapidraw_tpu_torch.ai.models import ModelUnavailable

        try:
            out = denoise_ai(img, quality=args.intensity, device=dev)
        except ModelUnavailable as e:
            raise SystemExit(f"error: {e}")
        mark_stage(stages, "denoise_ai")
        out = out.cpu().numpy()
        mark_stage(stages, "readback")
    else:
        out = run_bm3d(img.cpu().numpy(), intensity=args.intensity)  # NumPy on the host
        mark_stage(stages, "bm3d")
    dst = args.output or _default_output(args.image, "denoised", "png")
    encode_image(out, dst)
    mark_stage(stages, "encode")
    _report(stages, main_at)
    print(dst)
    return 0


def _cmd_panorama(args) -> int:
    from rapidraw_tpu_torch.compositions.panorama import PanoramaError, stitch_panorama
    from rapidraw_tpu_torch.io.encode import encode_image
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.utils.trace import mark_stage

    app_settings = _app_settings()
    for p in args.images:
        _require_file(p)
    dev = _device(args)
    main_at, stages = time.time(), _stages(args, dev)
    imgs = [load_image(p, app_settings=app_settings, device=dev)[0] for p in args.images]
    mark_stage(stages, "load")
    try:
        pano = stitch_panorama(imgs)
    except PanoramaError as e:
        raise SystemExit(f"error: {e}") from e
    mark_stage(stages, "stitch")
    pano = pano.cpu().numpy()
    dst = args.output or "panorama.png"
    encode_image(pano, dst)
    mark_stage(stages, "encode")
    _report(stages, main_at, size=[int(pano.shape[2]), int(pano.shape[1])])
    print(dst)
    return 0


def _cmd_lut_export(args) -> int:
    from rapidraw_tpu_torch.pipeline.watermark import export_adjustments_as_lut

    if args.adjustments:
        _require_file(args.adjustments)
        adj = json.loads(Path(args.adjustments).read_text())
    elif args.image:
        from rapidraw_tpu_torch.io.sidecar import load_adjustments

        _require_file(args.image)  # a mistyped path would bake an identity LUT
        adj = load_adjustments(args.image)
    else:
        raise SystemExit("error: provide --adjustments or --image")
    cube = export_adjustments_as_lut(adj, lut_size=args.size, device=_device(args))
    dst = args.output or "grade.cube"
    Path(dst).write_text(cube)
    print(dst)
    return 0


def _cmd_histogram(args) -> int:
    from rapidraw_tpu_torch.analysis.scopes import calculate_histogram
    from rapidraw_tpu_torch.io.loader import load_image

    _require_file(args.image)
    img, _ = load_image(args.image, app_settings=_app_settings(), device=_device(args))
    hist = calculate_histogram(img)
    print(json.dumps({k: [round(float(x), 4) for x in v] for k, v in hist.items()}))
    return 0


def _cmd_later(args) -> int:
    verb = args.op if args.cmd == "lib" else args.cmd
    print(f"error: '{verb}' is not ported yet; it waits for slice {_LATER[verb]}",
          file=sys.stderr)
    return 2


def _cmd_lib(args) -> int:
    """Library and file-management verbs."""
    from rapidraw_tpu_torch.library import catalog

    op = args.op
    if op == "ls":
        for p in catalog.list_images(args.path, recursive=args.recursive):
            print(p)
    elif op == "rate":
        for p in args.paths:
            catalog.set_rating(p, args.value)
    elif op == "label":
        for p in args.paths:
            catalog.set_color_label(p, args.value or None)
    elif op == "tag-add":
        for p in args.paths:
            catalog.add_tags(p, [f"user:{t}" for t in args.tags])
    elif op == "tag-remove":
        for p in args.paths:
            catalog.remove_tags(p, args.tags + [f"user:{t}" for t in args.tags])
    elif op == "clear-ai-tags":
        return _cmd_later(args)
    elif op == "clear-sidecars":
        print(catalog.clear_all_sidecars(args.path))
    elif op == "types":
        print(json.dumps(catalog.get_supported_file_types()))
    elif op == "dims":
        for p in args.paths:
            w, h = catalog.get_image_dimensions(p)
            print(f"{p}: {w}x{h}")
    return 0


def _cmd_exif(args) -> int:
    # the effective tags (the sidecar's exif block first, where --set
    # persists and what exports write through), not just the file's bytes
    from rapidraw_tpu_torch.io.exif import effective_exif_tags, update_exif_fields

    if args.set:
        for kv in args.set:
            if "=" not in kv:
                raise SystemExit(f"error: --set expects TAG=VALUE, got {kv!r}")
        update_exif_fields(args.paths, dict(kv.split("=", 1) for kv in args.set))
    for p in args.paths:
        print(json.dumps({p: effective_exif_tags(p)}, ensure_ascii=False))
    return 0


def _cmd_preset(args) -> int:
    from rapidraw_tpu_torch.library.presets import (
        PresetStore,
        apply_adjustments_to_paths,
        export_presets_to_file,
        reset_adjustments_for_paths,
    )

    store = PresetStore(args.store)
    if args.op == "list":
        for p in store.list():
            print(p["name"])
    elif args.op == "import":
        for p in store.import_file(args.file):
            print(f"imported {p['name']}")
    elif args.op == "export":
        export_presets_to_file(store.list(), args.file)
    elif args.op == "apply":
        preset = store.get(args.name)
        if preset is None:
            print(f"no preset named {args.name!r}", file=sys.stderr)
            return 1
        apply_adjustments_to_paths(args.paths, preset["adjustments"])
    elif args.op == "reset":
        reset_adjustments_for_paths(args.paths)
    elif args.op == "show":
        preset = store.get(args.name)
        if preset is None:
            return 1
        print(json.dumps(preset["adjustments"], indent=2, ensure_ascii=False))
    return 0


def main(argv=None) -> int:
    # --device and --timings are accepted before the verb or after it (a
    # verb's parser leaves them unset unless given there)
    def options(defaults: bool) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("--device", default="cuda" if defaults else argparse.SUPPRESS,
                       help="torch device of the develop (default: cuda)")
        p.add_argument("--timings", action="store_true",
                       default=False if defaults else argparse.SUPPRESS,
                       help="print each stage's ms, the kernels' launches and the memory "
                            "peak to stderr as one JSON line")
        return p

    common = options(False)
    ap = argparse.ArgumentParser(prog="rapidraw_tpu_torch", parents=[options(True)])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def verb(parent, name, fn, **kw):
        p = parent.add_parser(name, parents=[common], **kw)
        p.set_defaults(fn=fn)
        return p

    d = verb(sub, "develop", _cmd_develop, help="develop one image")
    d.add_argument("image")
    d.add_argument("-a", "--adjustments", help="adjustment JSON file (default: sidecar)")
    d.add_argument("-o", "--output")
    d.add_argument("-q", "--quality", type=int, default=90)

    e = verb(sub, "export", _cmd_export, help="batch export")
    e.add_argument("images", nargs="+")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("--format", default="jpeg")
    e.add_argument("-q", "--quality", type=int, default=90)
    e.add_argument("--long-edge", type=int, dest="long_edge",
                   help="resize value (edge picked by --resize-mode)")
    e.add_argument("--resize-mode", default="longEdge",
                   choices=["longEdge", "shortEdge", "width", "height"])
    e.add_argument("--allow-enlarge", action="store_true",
                   help="also upscale images smaller than the resize value")
    e.add_argument("--batch-size", type=int, default=4)
    e.add_argument("--watermark", help="watermark image path")
    e.add_argument("--watermark-anchor", default="bottomRight")
    e.add_argument("--watermark-scale", type=float, default=15.0)
    e.add_argument("--watermark-spacing", type=float, default=2.0)
    e.add_argument("--watermark-opacity", type=float, default=100.0)
    e.add_argument("--template", default="{original_filename}_edited",
                   help="filename template: {original_filename} {sequence} {YYYY} {MM} "
                        "{DD} {hh} {mm}")
    e.add_argument("--preserve-folders", action="store_true",
                   help="recreate the source folder tree under the output dir")
    e.add_argument("--base-folder", action="append", default=[],
                   help="root(s) relative to which --preserve-folders keeps the tree")
    e.add_argument("--preserve-timestamps", action="store_true",
                   help="stamp outputs with the source capture time")
    e.add_argument("--export-masks", action="store_true",
                   help="also write per-mask image+alpha pairs")
    e.add_argument("--estimate-size", action="store_true",
                   help="print the estimated total output bytes and exit")

    verb(sub, "auto", _cmd_auto, help="compute auto adjustments").add_argument("image")

    n = verb(sub, "negative", _cmd_negative, help="convert film negative to positive")
    n.add_argument("image")
    n.add_argument("-o", "--output")
    for c in ("red", "green", "blue"):
        n.add_argument(f"--{c}", type=float, default=1.0)
    n.add_argument("--exposure", type=float, default=0.0)
    n.add_argument("--contrast", type=float, default=1.0)

    verb(sub, "histogram", _cmd_histogram, help="print histogram JSON").add_argument("image")

    c = verb(sub, "cull", _cmd_cull, help="group similar images and rank quality")
    c.add_argument("images", nargs="+")
    c.add_argument("--no-group", action="store_true")

    m = verb(sub, "hdr", _cmd_hdr, help="merge bracketed exposures")
    m.add_argument("images", nargs="+")
    m.add_argument("-o", "--output")

    dn = verb(sub, "denoise", _cmd_denoise, help="denoise an image: BM3D, or the UtNet network")
    dn.add_argument("image")
    dn.add_argument("-o", "--output")
    dn.add_argument("--intensity", type=float, default=0.5)
    dn.add_argument("--method", choices=("bm3d", "ai"), default="bm3d")

    pa = verb(sub, "panorama", _cmd_panorama, help="stitch overlapping frames")
    pa.add_argument("images", nargs="+")
    pa.add_argument("-o", "--output")

    le = verb(sub, "lut-export", _cmd_lut_export, help="bake a grade into a .cube LUT")
    le.add_argument("-a", "--adjustments")
    le.add_argument("--image", help="take adjustments from this image's sidecar")
    le.add_argument("-o", "--output")
    le.add_argument("--size", type=int, default=33)

    tg = verb(sub, "tag", _cmd_later, help="CLIP-tag a folder into sidecars (A.13b)")
    tg.add_argument("folder")
    tg.add_argument("--custom", nargs="*", help="score only these labels")
    tg.add_argument("--max-tags", type=int, default=10)

    lb = sub.add_parser("lib", parents=[common], help="library/file-management operations")
    lsub = lb.add_subparsers(dest="op", required=True)
    p_ls = verb(lsub, "ls", _cmd_lib, help="list images (incl. virtual copies)")
    p_ls.add_argument("path")
    p_ls.add_argument("-r", "--recursive", action="store_true")
    p_rate = verb(lsub, "rate", _cmd_lib, help="set star rating on sidecars")
    p_rate.add_argument("value", type=int)
    p_rate.add_argument("paths", nargs="+")
    p_lab = verb(lsub, "label", _cmd_lib, help="set color label ('' clears)")
    p_lab.add_argument("value")
    p_lab.add_argument("paths", nargs="+")
    for name, help_ in (("tag-add", "add user: tags"), ("tag-remove", "remove tags")):
        p_t = verb(lsub, name, _cmd_lib, help=help_)
        p_t.add_argument("--tags", required=True, type=lambda s: s.split(","),
                         help="comma-separated tag list")
        p_t.add_argument("paths", nargs="+")
    verb(lsub, "clear-ai-tags", _cmd_lib, help="strip AI tags under a root (A.13b)").add_argument(
        "path")
    verb(lsub, "clear-sidecars", _cmd_lib, help="delete all sidecars under a root").add_argument(
        "path")
    verb(lsub, "types", _cmd_lib, help="print supported file types JSON")
    verb(lsub, "dims", _cmd_lib, help="print image dimensions (no decode)").add_argument(
        "paths", nargs="+")

    ex = verb(sub, "exif", _cmd_exif, help="read/update EXIF via sidecars")
    ex.add_argument("paths", nargs="+")
    ex.add_argument("--set", nargs="*", metavar="KEY=VALUE",
                    help="field updates (empty value deletes the key)")

    pr = sub.add_parser("preset", parents=[common], help="preset store operations")
    pr.add_argument("--store", default="presets.json",
                    help="preset store JSON (default ./presets.json)")
    psub = pr.add_subparsers(dest="op", required=True)
    verb(psub, "list", _cmd_preset)
    verb(psub, "import", _cmd_preset,
         help="import presets (.json or Lightroom .xmp)").add_argument("file")
    verb(psub, "export", _cmd_preset, help="export all presets to a share file").add_argument(
        "file")
    p_app = verb(psub, "apply", _cmd_preset, help="paste a preset onto image sidecars")
    p_app.add_argument("name")
    p_app.add_argument("paths", nargs="+")
    verb(psub, "reset", _cmd_preset, help="reset sidecar adjustments to {}").add_argument(
        "paths", nargs="+")
    verb(psub, "show", _cmd_preset, help="print a preset's adjustments JSON").add_argument("name")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
