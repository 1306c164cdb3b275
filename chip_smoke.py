"""Drive the PyTorch port's develop main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out DIR] [--profile]

Phases: (1) the card's name and power limit; (2) build both CUDA kernels
from rapidraw_tpu_torch/csrc; (3) the blur kernel against its plain
PyTorch version at 24 MP; (4) the grade kernel against its plain version
at 24 MP, B = 1 and 2, on five documents; (5) end to end: adjustment JSON
-> stack_params -> develop_batch -> device_u8 -> host numpy, with the
kernels' launch counters reset just before and read just after, plus a
small-input check against the plain CPU path. It prints a kernels JSON
line, then as its last line {"ok": true, "device": {...}}. Any failed
check raises, so the process exits non-zero; without a CUDA device it
exits non-zero before printing any result.

--quick runs phases 3-5 at 1024x1536 with fewer repetitions (a first
check of a new kernel). --out DIR writes the nvcc/ptxas logs there.
--profile adds a torch.profiler pass over the config-3 main path: kernel
time by name and the device busy share (and a chrome trace in --out).
Imports torch, numpy and rapidraw_tpu_torch only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 4096, 6144  # 24 MP, the repo's canonical develop shape

# BASELINE config 1: sRGB develop — exposure + contrast + saturation + curve.
CONFIG1_DOC = {
    "exposure": 0.3,
    "contrast": 20,
    "saturation": 10,
    "curves": {
        "luma": [{"x": 0, "y": 6}, {"x": 128, "y": 120}, {"x": 255, "y": 250}],
        "red": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "green": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "blue": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
    },
    "toneMapper": "basic",
}

# BASELINE config 3: full color grade — HSL + hue + curves + vignette.
CONFIG3_DOC = {
    "exposure": 0.3,
    "contrast": 20,
    "highlights": -25,
    "shadows": 20,
    "saturation": 10,
    "vibrance": 18,
    "temperature": 5,
    "hue": 5,
    "vignetteAmount": -35,
    "hsl": {
        "reds": {"hue": 6, "saturation": 10, "luminance": 0},
        "greens": {"hue": -4, "saturation": 8, "luminance": 2},
        "blues": {"hue": -8, "saturation": 14, "luminance": -6},
    },
    "curves": {
        "luma": [{"x": 0, "y": 4}, {"x": 110, "y": 96}, {"x": 255, "y": 252}],
        "red": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "green": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "blue": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
    },
    "toneMapper": "agx",
}

# Every local-contrast level (sharp, tonal, clarity, structure) + AgX.
FULL_DOC = {
    "exposure": 0.4, "contrast": 18, "highlights": -30, "shadows": 22,
    "whites": 10, "blacks": -6, "saturation": 12, "vibrance": 15,
    "temperature": 8, "tint": -4, "hue": 6, "clarity": 15, "structure": 10,
    "sharpness": 25, "dehaze": 8, "vignetteAmount": -30, "grainAmount": 0,
    "hsl": {
        "reds": {"hue": 5, "saturation": 8, "luminance": -2},
        "blues": {"hue": -6, "saturation": 10, "luminance": 4},
    },
    "curves": {
        "luma": [{"x": 0, "y": 6}, {"x": 128, "y": 120}, {"x": 255, "y": 250}],
    },
    "toneMapper": "agx",
}

# Grain + the centre, glow, halation, calibration and colour-grading stages.
GRAIN_DOC = {
    "grainAmount": 40, "grainSize": 30, "grainRoughness": 60,
    "exposure": 0.2, "centré": 30, "glowAmount": 30, "halationAmount": 25,
    "colorCalibration": {"shadowsTint": 10, "redHue": 20, "blueSaturation": 15},
    "colorGrading": {"shadows": {"hue": 200, "saturation": 30, "luminance": 5},
                     "highlights": {"hue": 40, "saturation": 20}, "balance": 10},
    "curves": {"red": [{"x": 0, "y": 0}, {"x": 100, "y": 120}, {"x": 255, "y": 255}]},
}

# Scene-linear RAW input through the RAW sRGB emulation tonemap.
RAW_DOC = dict(FULL_DOC, toneMapper="basic")

DOCS = {"config1": (CONFIG1_DOC, False), "config3": (CONFIG3_DOC, False),
        "full": (FULL_DOC, False), "grain": (GRAIN_DOC, False), "raw": (RAW_DOC, True)}

BLUR_TOL = 1e-5          # fp32 both sides; only the summation order differs
GRADE_TOL = 2e-4         # dither off: the JAX fused-vs-XLA bound (test_fused.py)
# dither on: a last-ulp difference in the hash's fract can move one dither
# value by up to 1/255, so the bound adds one quantization step
GRADE_DITHER_TOL = 2e-4 + 1.0 / 255.0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median ms per call over `reps` timed calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def profile_main_path(doc, images, out_dir, card) -> None:
    """Kernel time by name and the device busy share over three e2e runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rapidraw_tpu_torch import develop_batch, device_u8, parse_adjustments, stack_params

    def run():
        parsed = [parse_adjustments(doc) for _ in range(images.shape[0])]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed],
                               device=images.device)
        device_u8(develop_batch(images, sp, cfg)).cpu()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side op rows repeat their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    log(f"[profile] config3 B={images.shape[0]} x3: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100.0 * busy / wall_us:.1f}%), of which copies "
        f"{copies / 1e3:.2f} ms, kernels {(busy - copies) / 1e3:.2f} ms "
        f"({100.0 * (busy - copies) / wall_us:.1f}%) [{card}]")
    for dev_us, key, count in rows[:8]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<3d} {key[:90]}")
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(out_dir) / "trace_config3.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="1024x1536, fewer repetitions")
    ap.add_argument("--out", default=None, help="directory for the nvcc/ptxas logs")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler over the config-3 B=2 main path")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from rapidraw_tpu_torch import develop_batch, device_u8, parse_adjustments, stack_params
    from rapidraw_tpu_torch.ops import blur
    from rapidraw_tpu_torch.pipeline import fused

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    h, w = (1024, 1536) if args.quick else (H, W)
    reps = 3 if args.quick else 5

    # ---- 1. device ---------------------------------------------------------
    card = gpu_line()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    for name, kl in (("blur", blur._KERNEL), ("grade", fused._KERNEL)):
        t0 = time.perf_counter()
        kl.lib()
        log(f"[build] {name}: {time.perf_counter() - t0:.1f} s (nvcc {kl.build_seconds:.1f} s)")
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / f"nvcc_{name}.log").write_text(kl.build_log)
        for line in kl.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name} ptxas: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- 3. blur kernel vs plain ----------------------------------------------
    blur_err, blur_main = 0.0, None
    for label, c, radii in (("B1 r=14", 3, (14,)), ("B2 radii 4/14/31/152", 3, (4, 14, 31, 152)),
                            ("batched C=6 r=14", 6, (14,))):
        x = torch.rand((c, h, w), generator=gen, device=dev)
        got = blur.gaussian_blur_multi(x, radii)
        ref = blur.gaussian_blur_multi_plain(x, radii)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        blur_err = max(blur_err, err)
        ms = time_ms(lambda: blur.gaussian_blur_multi(x, radii), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(x, radii), reps)
        log(f"[blur] {label} ({c},{h},{w}): max|d| {err:.3e} (bound {BLUR_TOL:g}) "
            f"kernel {ms:.3f} ms plain {pms:.3f} ms [{card}]")
        if err > BLUR_TOL:
            raise AssertionError(f"blur {label}: max|d| {err} > {BLUR_TOL}")
        if label.startswith("batched"):
            blur_main = (ms, pms)
        del x, got, ref

    # ---- 4. grade kernel vs plain ---------------------------------------------
    grade_err, grade_main = 0.0, None
    for b in (1, 2):
        images = torch.rand((b, 3, h, w), generator=gen, device=dev)
        for name, (doc, is_raw) in DOCS.items():
            p, cfg = parse_adjustments(doc, is_raw=is_raw)
            sp, cfg = stack_params([p] * b, [cfg] * b, device=dev)
            pmat = fused.pack_rows(sp["glob"])
            levels = fused.blur_levels(images, cfg)
            for dither in (False, True):
                c = dataclasses.replace(cfg, dither_active=dither)
                got = fused.grade(images, levels, pmat, c)
                ref = fused.grade_plain(images, levels, pmat, c)
                torch.cuda.synchronize()
                d = (got - ref).abs()
                err, share = float(d.max()), float((d > GRADE_TOL).float().mean())
                tol = GRADE_DITHER_TOL if dither else GRADE_TOL
                line = (f"[grade] B={b} {name} dither={'on' if dither else 'off'}: "
                        f"max|d| {err:.3e} (bound {tol:.3e}), share>{GRADE_TOL:g} {share:.2e}")
                if not dither:
                    ms = time_ms(lambda: fused.grade(images, levels, pmat, c), reps)
                    pms = time_ms(lambda: fused.grade_plain(images, levels, pmat, c), reps)
                    line += f" kernel {ms:.3f} ms plain {pms:.3f} ms [{card}]"
                    if b == 2 and name == "config3":
                        grade_main = (ms, pms)
                log(line)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"grade {name}: non-finite output")
                if err > tol:
                    raise AssertionError(f"grade B={b} {name}: max|d| {err} > {tol}")
                grade_err = max(grade_err, err if not dither else 0.0)
                del got, ref
            del levels
        del images

    # ---- 5. end to end ----------------------------------------------------------
    def run_e2e(doc, b, images):
        parsed = [parse_adjustments(doc) for _ in range(b)]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=images.device)
        out = develop_batch(images, sp, cfg)
        return out, device_u8(out).cpu().numpy()

    img2 = torch.rand((2, 3, h, w), generator=gen, device=dev)
    blur.gaussian_blur_multi.launches = 0
    fused.grade.launches = 0
    out, u8 = run_e2e(CONFIG3_DOC, 2, img2)
    torch.cuda.synchronize()
    launches = {"blur": blur.gaussian_blur_multi.launches, "grade": fused.grade.launches}
    log(f"[e2e] config3 B=2 launches {launches} u8 {u8.shape} {u8.dtype}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not bool(torch.isfinite(out).all()) or u8.shape != (2, 3, h, w) or u8.min() == u8.max():
        raise AssertionError("e2e output is non-finite, misshapen or constant")

    # small input: the CUDA path against the plain CPU path, same JSON
    small = torch.rand((2, 3, 384, 512), generator=gen, device=dev)
    _, u8_gpu = run_e2e(CONFIG3_DOC, 2, small)
    _, u8_cpu = run_e2e(CONFIG3_DOC, 2, small.cpu())
    du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
    log(f"[e2e] small 2x3x384x512 CUDA vs plain CPU u8: max {int(du.max())} LSB, "
        f"share>0 {float((du > 0).mean()):.2e}")
    if du.max() > 1 or (du > 0).mean() > 1e-3:
        raise AssertionError("e2e CUDA output disagrees with the plain CPU path")

    for doc_name, doc in (("config1", CONFIG1_DOC), ("config3", CONFIG3_DOC)):
        for b in (1, 2):
            imgs = img2[:b].contiguous()
            run_e2e(doc, b, imgs)
            times, readback = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_e2e(doc, b, imgs)
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
            # the device part alone: params resident, JSON parsed once
            parsed = [parse_adjustments(doc) for _ in range(b)]
            sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=dev)
            dev_ms = time_ms(lambda: device_u8(develop_batch(imgs, sp, cfg)), reps)
            q = device_u8(develop_batch(imgs, sp, cfg))
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                q.cpu()
                readback.append(time.perf_counter() - t0)
            log(f"[e2e] {doc_name} B={b}: {dt * 1e3 / b:.2f} ms/image, "
                f"{b * h * w / dt / 1e6:.1f} MPix/s (JSON->u8 on host); device part "
                f"{dev_ms / b:.2f} ms/image ({b * h * w / dev_ms / 1e3:.1f} MPix/s), "
                f"u8 readback {statistics.median(readback) * 1e3 / b:.2f} ms/image [{card}]")

    if args.profile:
        profile_main_path(CONFIG3_DOC, img2, args.out, card)

    kernels = {"kernels": [
        {"name": "blur", "route": "cuda", "source": "rapidraw_tpu_torch/csrc/blur.cu",
         "replaces": "rapidraw_tpu/ops/blur.py:242", "launches": launches["blur"],
         "max_abs_err": blur_err, "ms": blur_main[0], "plain_ms": blur_main[1]},
        {"name": "grade", "route": "cuda", "source": "rapidraw_tpu_torch/csrc/grade.cu",
         "replaces": "rapidraw_tpu/pipeline/fused.py:298", "launches": launches["grade"],
         "max_abs_err": grade_err, "ms": grade_main[0], "plain_ms": grade_main[1]},
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
