"""Design trials of the per-pixel NR kernel, the flare kernel and probe P2's
tap-sum kernel on one card.

Each variant is the shipped source (csrc/nr.cu, csrc/flare.cu,
csrc/nr_slices.cu) with one design step undone or changed by a text
substitution, built under its own name with the same flags; P2's band
variants run the shipped build at half and twice the plan's band, its
block variants narrower blocks (the wrapper's plan following), and its two
floors (no taps; no staging after the first ring) are wrong by design and
bound what the design can reach. With
--parent, a checkout's own sources and flare and P2 wrappers run beside
them. Every variant is held against the plain version on chip_smoke.py's
phase-13 inputs (24 MP and 1000 x 1503, B = 2: the masked and the mixed NR
documents, FLARE_LUT_DOC's bright-spot batch) and P2's on random (3, H, W)
images at both sizes, then each is timed at 24 MP in five rounds of
shuffled order (median of 5 CUDA-event timings a round; the median of the
rounds is printed with its range). ptxas's registers and spill bytes of
every build come first.

    python -m rapidraw_tpu_torch.tools.kernel_variants [--parent DIR] [--quick]

(from the repository's root; DIR is a checkout of the repository, e.g. a
`git archive` of the parent commit; --quick runs at 1024 x 1536.)
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import importlib.util
import random
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rapidraw_tpu_torch.tools import OFFSETS

ROOT = Path(__file__).resolve().parents[2]

NR_BOUND = "__launch_bounds__(BX* BY, 3)\n    nr_dynamic_kernel"
FLARE_BOUND = "__launch_bounds__(BX* BY, 8)\n    composite_kernel"
# variant -> its substitutions (shipped text, replacement) of the source
NR_STEPS = {
    "shipped": [],
    "ieee_division": [("  const float q = __fmaf_rn(x, rd, 0.0f);\n"
                       "  return __fmaf_rn(rd, __fmaf_rn(-d, q, x), q);", "  return x / d;")],
    "two_blocks": [(NR_BOUND, NR_BOUND.replace(", 3)", ")"))],
    "four_blocks": [(NR_BOUND, NR_BOUND.replace(", 3)", ", 4)"))],
}
# P2: the taps' reads of the window, and the window's five 16-byte loads
P2_TAPS = "  (tap<J, K>(acc, win, w), ...);"
P2_WINDOW = """    const float4 q = *reinterpret_cast<const float4*>(row + 4 * m);
    win[4 * m] = q.x;
    win[4 * m + 1] = q.y;
    win[4 * m + 2] = q.z;
    win[4 * m + 3] = q.w;"""
P2_STEPS = {
    "shipped": [],
    # the x offsets read at run time (from constant memory): no tap can be
    # mapped onto the window, so each is a 4-byte shared load at a run-time
    # offset
    "runtime_taps": [
        ("constexpr int HALO = 7;",
         "__constant__ int RUNTIME_DX[NTAPS] = {%s};\nconstexpr int HALO = 7;"
         % ", ".join(str(dx) for dx, _ in OFFSETS)),
        ("  constexpr int dx = TAP_DX[K], dy = TAP_DY[K];",
         "  const int dx = RUNTIME_DX[K];\n  constexpr int dy = TAP_DY[K];"),
        (P2_TAPS, "  (tap<J, K>(acc, row, w), ...);")],
    # 4-byte copies of every staged value, and the window as 20 4-byte loads
    "scalar_loads": [
        ("  b.inner = b.vec && b.x0 >= PAD && b.x0 + ROWF - PAD <= W;", "  b.inner = false;"),
        ("    if (b.vec && g >= 0 && g + 4 <= b.W) {", "    if (false) {"),
        (P2_WINDOW, "    for (int e = 0; e < 4; ++e)\n"
                    "      win[4 * m + e] = ((const volatile float*)row)[4 * m + e];")],
    # no reuse of the window in registers: one 4-byte shared load per tap
    "one_load_per_tap": [(P2_TAPS, "  (tap<J, K>(acc, (const volatile float*)row, w), ...);")],
    # wait for every staged row before each step: no load in flight over the arithmetic
    "no_overlap": [("  cp_wait<IN_FLIGHT>();", "  cp_wait<0>();")],
    # narrower blocks (2 KB or 4 KB of a row per block and step), more of them an SM
    "block_256": [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
                  ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
    "block_128": [("constexpr int THREADS = 512;", "constexpr int THREADS = 128;"),
                  ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 4)")],
    # floors, wrong by design: the staging and stores without the taps, and
    # the taps without staging rows after the first ring
    "floor_no_taps": [("  scatter<J>(acc, row, w, std::make_integer_sequence<int, NTAPS>{});", "")],
    "floor_no_staging": [("  if (u + RING - 1 < b.steps) stage_row(", "  if (false) stage_row(")],
}
P2_BANDS = {"band_half": 0.5, "band_double": 2.0}  # the shipped build, other bands
P2_THREADS = {"block_256": 256, "block_128": 128}  # the wrapper's plan follows the block
FLARE_STEPS = {
    "shipped": [],
    "floorf": [("  const float t = __fadd_rd(x, 12582912.0f);\n"
                "  const float x0 = t - 12582912.0f;\n"
                "  return {(unsigned)max(__float_as_int(t) - 0x4B400000, 0), x - x0};",
                "  const float x0 = floorf(x);\n  return {(unsigned)max((int)x0, 0), x - x0};")],
    "not_opaque": [('asm("mov.b64 %0, %0;" : "+l"(p));', "")],
    # twice the threads a block, half the blocks an SM: the same registers
    "block_32x8": [("constexpr int BX = 32, BY = 4;", "constexpr int BX = 32, BY = 8;"),
                   (FLARE_BOUND, FLARE_BOUND.replace(", 8)", ", 4)"))],
    "one_row": [("constexpr int ROWS = 2;", "constexpr int ROWS = 1;")],
    "no_min_blocks": [(FLARE_BOUND, FLARE_BOUND.replace(", 8)", ")"))],
}


def variant_sources(src: str, steps: dict) -> dict:
    out = {}
    for name, subs in steps.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout whose kernels run beside these")
    ap.add_argument("--quick", action="store_true", help="1024 x 1536 instead of 24 MP")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rapidraw_tpu_torch import native, parse_adjustments, rasterize_masks, stack_params
    from rapidraw_tpu_torch.ops import flare, nr
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import card_line, require_cuda
    from rapidraw_tpu_torch.tools import prof_nr_slices as tps

    dev = require_cuda()
    h, w = (1024, 1536) if args.quick else (4096, 6144)
    print(f"[card] {card_line()}", flush=True)

    csrc = ROOT / "rapidraw_tpu_torch" / "csrc"
    texts = {f"nr_{k}": v for k, v in variant_sources(
        (csrc / "nr.cu").read_text(), NR_STEPS).items()}
    texts.update({f"flare_{k}": v for k, v in variant_sources(
        (csrc / "flare.cu").read_text(), FLARE_STEPS).items()})
    shapes = {f"flare_{k}": (1 if k == "one_row" else flare.FLARE_ROWS,
                             8 if k == "block_32x8" else flare.FLARE_BLOCK[1])
              for k in FLARE_STEPS}
    texts.update({f"p2_{k}": v for k, v in variant_sources(
        (csrc / "nr_slices.cu").read_text(), P2_STEPS).items()})
    if args.parent:
        texts["nr_parent"] = (args.parent / "rapidraw_tpu_torch/csrc/nr.cu").read_text()
        texts["flare_parent"] = (args.parent / "rapidraw_tpu_torch/csrc/flare.cu").read_text()
        texts["p2_parent"] = (args.parent / "rapidraw_tpu_torch/csrc/nr_slices.cu").read_text()
    vdir = native.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (vdir / f"{name}.cu").write_text(text)
    libs = {name: native.KernelLibrary(name, extra_flags=("--fmad=false",)) for name in texts}
    shipped_csrc, native.CSRC = native.CSRC, vdir  # one build per variant, all at once
    try:
        with cf.ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.lib(), libs.values()))
    finally:
        native.CSRC = shipped_csrc
    for name, lib in libs.items():
        for entry, (regs, spill) in cs.ptxas_entries(lib.build_log).items():
            if "dynamic" in entry or "composite" in entry or "slices" in entry:
                print(f"[regs] {name} {entry}: {regs} registers, {spill} bytes spilled")

    parent_flare = parent_p2 = None
    if args.parent:
        parent_flare = load_module("parent_flare",
                                   args.parent / "rapidraw_tpu_torch/ops/flare.py")
        parent_flare._KERNEL = libs["flare_parent"]
        parent_p2 = load_module("parent_p2",
                                args.parent / "rapidraw_tpu_torch/tools/prof_nr_slices.py")
        parent_p2._KERNEL = libs["p2_parent"]

    def nr_variant(name):
        def run(*a):
            nr._KERNEL = libs[name]
            return nr.nr_dynamic(*a)
        return run

    def flare_variant(name):
        if name == "flare_parent":
            return parent_flare.flare_maps
        rows, by = shapes[name]

        def run(*a):
            flare._KERNEL, flare.FLARE_ROWS, flare.FLARE_BLOCK = libs[name], rows, (32, by)
            return flare.flare_maps(*a)
        return run

    p2_names = [n for n in libs if n.startswith("p2_")] + [f"p2_{k}" for k in P2_BANDS]
    shipped_threads = tps.THREADS

    def p2_variant(name):
        if name == "p2_parent":  # the parent's best tile, 32 x 32
            return lambda x: parent_p2.slices(x, 32)
        lib = libs.get(name, libs["p2_shipped"])
        scale = P2_BANDS.get(name.removeprefix("p2_"), 1.0)
        threads = P2_THREADS.get(name.removeprefix("p2_"), shipped_threads)

        def run(x):
            tps._KERNEL, tps.THREADS, tps.BLOCK_COLS = lib, threads, threads * tps.COLS
            band = tps.slices_launch_plan(*x.shape, tps._slots(lib.lib(), x.device))["band_rows"]
            return tps.slices(x, max(1, round(band * scale)))
        return run

    def stacked(docs):
        parsed = [parse_adjustments(d) for d in docs]
        return stack_params([q for q, _ in parsed], [c for _, c in parsed], device=dev)

    gen = torch.Generator(device=dev).manual_seed(13)
    timed = []
    for hh, ww in ((h, w), cs.RAGGED):
        images = torch.rand((2, 3, hh, ww), generator=gen, device=dev)
        center = srgb_to_linear(images).contiguous()
        planes = nr.nr_planes(images, False).contiguous()
        ndoc = cs.masked_nr_doc(hh, ww)
        mk = torch.from_numpy(np.repeat(rasterize_masks(ndoc, ww, hh, scale=1.0)[None], 2,
                                        0)).to(dev)
        cases = []
        for label, docs, masks in (("masked", [ndoc, ndoc], mk),
                                   ("mixed", list(cs.MIXED_NR_DOCS), None)):
            sp, cfg = stacked(docs)
            la, ca = fused.nr_amounts(sp, cfg, masks, dev)
            a = (center, planes, la, ca, scales.resolution_scale(ww, hh))
            cases.append((f"nr {label}", a, nr.nr_dynamic_plain(*a), "nr_", nr_variant))
        bright = torch.rand((2, 3, hh, ww), generator=gen, device=dev) * 0.7
        yy, xx = torch.arange(hh, device=dev)[:, None], torch.arange(ww, device=dev)[None, :]
        for cy, cx in ((0.3, 0.25), (0.6, 0.7), (0.5, 0.98)):
            bright[:, :, (yy - cy * hh) ** 2 + (xx - cx * ww) ** 2 <= (0.03 * hh) ** 2] = 1.0
        sp, cfg = stacked([cs.FLARE_LUT_DOC, dict(cs.FLARE_LUT_DOC, exposure=-0.3,
                                                   flareAmount=70)])
        fp = fused.pack_rows(sp["glob"])[:, [fused.OFFSETS[k] for k in flare.FLARE_PARAMS]]
        a = (bright, fp.contiguous(), cfg.is_raw)
        cases.append(("flare", a, flare.flare_maps_plain(*a), "flare_", flare_variant))
        x2 = torch.rand((3, hh, ww), generator=gen, device=dev)
        cases.append(("p2", (x2,), tps.slices_plain(x2), "p2_", p2_variant))
        for label, a, ref, prefix, make in cases:
            names = p2_names if prefix == "p2_" else [n for n in libs if n.startswith(prefix)]
            for name in names:
                fn = make(name)
                got = fn(*a)
                torch.cuda.synchronize()
                d = (got - ref).abs()
                err = float((d / ref.abs().clamp(min=1.0)).max() if prefix == "flare_"
                            else d.max())
                print(f"[check] {label} ({hh},{ww}) {name}: max err {err:.3e}, values that "
                      f"differ {float((d > 0).float().mean()):.3e}", flush=True)
                if (hh, ww) == (h, w):
                    timed.append((f"{label} ({hh},{ww})", name, fn, a))

    times = {(c, v): [] for c, v, _, _ in timed}
    for rnd in range(5):
        order = list(timed)
        random.Random(rnd).shuffle(order)
        for case, name, fn, a in order:
            times[case, name].append(cs.time_ms(lambda: fn(*a), 5))
    for (case, name), ts in times.items():
        print(f"[time] {case} {name}: {statistics.median(ts):.3f} ms (rounds "
              f"{min(ts):.3f}-{max(ts):.3f})", flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] end: {clocks.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
