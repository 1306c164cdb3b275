"""Times one kernel of two or more checkouts of the repository on one card,
alternating between them.

--kernel grade (the default): the grade kernel on chip_smoke.py's phase-4
and phase-10 cases at 24 MP, B = 2, dither off: config 3, config 5 (its
image already linear, as NR leaves it) and config 4 with its three masks on
their band levels.

--kernel warp: the planned geometry warp, `warp_fast.warp_with_plan` with
all it does between its input and its output (one launch of the fused
kernel; in a checkout before it, two resample launches a channel set and
the pad, transposes, `cat` and crop around them), on a plan `plan_warp`
makes at each shape the port's paths warp at: config 5 at 24 MP, B = 2
(phase 8's `warp_ms`: config 5, the preview service, the CLI), the TCA plan
(three channel sets) on the same batch, config 5 on one (3, 2048, 3072)
image (the thumbnails' half-size RAW frame) and on one (3, 480, 720) image
(the community previews). At the two small shapes also the host's mean
time to dispatch one call (chip_smoke.host_ms: 1000 calls, no sync).

Each run is a child process that imports one checkout's package, builds (or
loads) that checkout's kernel, makes the inputs from one seed and times
each case in --rounds rounds (the median of 20 CUDA-event timings after a
warm-up each; the cases in a shuffled order each round). The documents,
geometries and timers are this repository's chip_smoke.py, so every
checkout runs on the same inputs. The runs go through the checkouts
forward, then backward, ... for --pairs passes (parent, change, change,
parent, ... for two), so a drift of the card's clock over the call falls on
every side. The summary gives the registers and spills of every build of
the kernel's source in each checkout, every run's median per case, and per
case each checkout's median over its runs with the range and its ratio to
the first checkout's.

    python3 rapidraw_tpu_torch/tools/kernel_ab.py PARENT_DIR CHANGE_DIR [MORE_DIR...] \\
        [--kernel grade|warp] [--pairs 6]

(the directories are checkouts of the repository, e.g. `git archive`s of
two commits, or a copy with one edit to a kernel's source; the card's name,
power limit and SM clock are printed before and after.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WARP_SHAPES = {  # case -> (chip_smoke geometry, batch, height, width)
    "config5_24mp": ("CONFIG5_GEOMETRY", 2, 4096, 6144),
    "tca_24mp": ("TCA_GEOMETRY", 2, 4096, 6144),
    "thumbs_2048": ("CONFIG5_GEOMETRY", 1, 2048, 3072),
    "community_480": ("CONFIG5_GEOMETRY", 1, 480, 720),
}
HOST_SHAPES = ("thumbs_2048", "community_480")


def grade_cases(cs, dev, seed):
    """The grade kernel on the three documents: (cases, host ms, library)."""
    import dataclasses

    import numpy as np
    import torch

    from rapidraw_tpu_torch import blur_band_rows, parse_adjustments, rasterize_masks
    from rapidraw_tpu_torch import stack_params
    from rapidraw_tpu_torch.pipeline import fused

    fused._KERNEL.lib()
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((2, 3, cs.H, cs.W), generator=gen, device=dev)
    cases = {}

    def case(pmat, levels, cfg, **kw):
        return lambda: fused.grade(images, levels, pmat, cfg, **kw)

    for name, doc in (("config3", cs.CONFIG3_DOC), ("config5", cs.CONFIG5_DOC)):
        p, c = parse_adjustments(doc)
        sp, cfg = stack_params([p] * 2, [c] * 2, device=dev)
        cfg = dataclasses.replace(cfg, dither_active=False)
        cases[name] = case(fused.pack_rows(sp["glob"]), fused.blur_levels(images, cfg), cfg,
                           image_linear=name == "config5")
    doc = cs.config4_doc(cs.H, cs.W)
    bitmaps = rasterize_masks(doc, cs.W, cs.H, scale=1.0)
    p, c = parse_adjustments(doc)
    sp, cfg = stack_params([p] * 2, [c] * 2, device=dev)
    cfg = dataclasses.replace(cfg, dither_active=False)
    masks = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(bitmaps, (2,) + bitmaps.shape)))
    cases["config4"] = case(fused.pack_rows(sp["glob"]),
                            fused.blur_levels(images, cfg, blur_band_rows(cfg, bitmaps)), cfg,
                            masks=masks.to(dev), mmat=fused.pack_mask_rows(sp["mask"]))
    return cases, {}, fused._KERNEL


def warp_cases(cs, dev, seed):
    """The whole warp at the four shapes: (cases, host ms, library)."""
    import torch

    from rapidraw_tpu_torch.geometry import warp_fast
    from rapidraw_tpu_torch.geometry.params import geometry_params_from_json

    warp_fast._KERNEL.lib()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = {}
    for name, (geom, b, h, w) in WARP_SHAPES.items():
        plan = warp_fast.plan_warp(geometry_params_from_json(getattr(cs, geom)), h, w,
                                   device=dev)
        if plan is None:
            raise SystemExit(f"kernel_ab: the planner refused {name}")
        x = torch.rand((b, 3, h, w), generator=gen, device=dev)
        cases[name] = lambda x=x, plan=plan: warp_fast.warp_with_plan(x, plan.arrays,
                                                                      plan.static)
    host = {name: cs.host_ms(cases[name]) for name in HOST_SHAPES}
    return cases, host, warp_fast._KERNEL


KERNELS = {"grade": grade_cases, "warp": warp_cases}


def child(tree: str, kernel: str, rounds: int, seed: int) -> None:
    """One run: this checkout's kernel on the cases, timed by this
    repository's chip_smoke.py."""
    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cases, host, lib = KERNELS[kernel](cs, torch.device("cuda", 0), seed)
    ms = {name: [] for name in cases}
    order = list(cases)
    rng = random.Random(seed)
    for _ in range(rounds):
        rng.shuffle(order)
        for name in order:
            ms[name].append(cs.time_ms(cases[name], 20))
    ptxas = {k: list(v) for k, v in cs.ptxas_entries(lib.build_log).items()}
    print(json.dumps({"ms": {k: statistics.median(v) for k, v in ms.items()}, "host_ms": host,
                      "ptxas": ptxas}))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def spread(name: str, vals: list) -> str:
    m = statistics.median(vals)
    return f"{name} median {m:.4f} ms ({min(vals):.4f}-{max(vals):.4f})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts, the first the reference")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="grade")
    ap.add_argument("--pairs", type=int, default=6, help="passes over the checkouts")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--child", action="store_true", help="(internal) one run of one checkout")
    args = ap.parse_args()
    if args.child:
        child(str(Path(args.trees[0]).resolve()), args.kernel, args.rounds, args.seed)
        return 0
    trees = {Path(t).name: str(Path(t).resolve()) for t in args.trees}
    if len(trees) < 2:
        raise SystemExit("kernel_ab: give two or more checkouts with different names")
    print(f"[card] before: {card()}", flush=True)
    runs = {tag: [] for tag in trees}
    host = {tag: [] for tag in trees}
    ptxas = {}
    for i in range(args.pairs):
        for tag in (list(trees) if i % 2 == 0 else list(trees)[::-1]):
            proc = subprocess.run([sys.executable, __file__, trees[tag], "--child", "--kernel",
                                   args.kernel, "--rounds", str(args.rounds), "--seed",
                                   str(args.seed)],
                                  cwd=trees[tag], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"kernel_ab: the {tag} run {i} exited {proc.returncode}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tag].append(out["ms"])
            host[tag].append(out["host_ms"])
            ptxas[tag] = out["ptxas"]
            print(f"[run] pass {i} {tag}: "
                  + ", ".join(f"{d} {v:.4f} ms" for d, v in out["ms"].items())
                  + "".join(f"; {d} host dispatch {v:.4f} ms/call"
                            for d, v in out["host_ms"].items()), flush=True)
    print(f"[card] after: {card()}")
    for tag in runs:
        for entry, (regs, spill) in sorted(ptxas[tag].items()):
            print(f"[build] {tag} {entry}: {regs} registers, {spill} bytes spilled")
    first = next(iter(trees))
    for d in runs[first][0]:
        p = [r[d] for r in runs[first]]
        line = f"[ab] {args.kernel} {d}: {spread(first, p)}"
        for tag in list(trees)[1:]:
            c = [r[d] for r in runs[tag]]
            line += (f"; {spread(tag, c)}, /{first} "
                     f"{statistics.median(c) / statistics.median(p):.4f}, slower in "
                     f"{sum(x > y for x, y in zip(c, p))} of {len(p)}")
        print(line)
        if d in host[first][0]:
            print(f"[ab] {args.kernel} {d} host dispatch: " + "; ".join(
                spread(tag, [h[d] for h in host[tag]]) for tag in trees))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
