"""Times the grade kernel of two or more checkouts of the repository on one
card, alternating between them.

The documents are chip_smoke.py's phase-4 and phase-10 cases at 24 MP,
B = 2, dither off: config 3, config 5 (its image already linear, as NR
leaves it) and config 4 with its three masks on their band levels. Each run
is a child process that imports one checkout's package and chip_smoke.py,
builds (or loads) that checkout's csrc/grade.cu, makes the inputs from one
seed and times each document in --rounds rounds (the median of 20
CUDA-event timings after a warm-up each; the documents in a shuffled order
each round). The runs go through the checkouts forward, then backward, ...
for --pairs passes (parent, change, change, parent, ... for two), so a
drift of the card's clock over the call falls on every side. The summary
gives the registers and spills of every grade build of each checkout,
every run's median per document, and per document each checkout's median
over its runs with the range and its ratio to the first checkout's.

    python3 rapidraw_tpu_torch/tools/grade_ab.py PARENT_DIR CHANGE_DIR [MORE_DIR...] [--pairs 6]

(the directories are checkouts of the repository, e.g. `git archive`s of
two commits, or a copy with one edit to csrc/grade.cu; the card's name and
power limit are printed before and after.)
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

DOCS = ("config3", "config5", "config4")


def child(tree: str, rounds: int, seed: int) -> None:
    """One run: this checkout's grade kernel on the three documents."""
    sys.path.insert(0, tree)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from rapidraw_tpu_torch import blur_band_rows, parse_adjustments, rasterize_masks
    from rapidraw_tpu_torch import stack_params
    from rapidraw_tpu_torch.pipeline import fused

    dev = torch.device("cuda", 0)
    fused._KERNEL.lib()
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((2, 3, cs.H, cs.W), generator=gen, device=dev)
    cases = {}
    for name, doc in (("config3", cs.CONFIG3_DOC), ("config5", cs.CONFIG5_DOC)):
        p, c = parse_adjustments(doc)
        sp, cfg = stack_params([p] * 2, [c] * 2, device=dev)
        cfg = dataclasses.replace(cfg, dither_active=False)
        cases[name] = (fused.pack_rows(sp["glob"]), fused.blur_levels(images, cfg), cfg,
                       {"image_linear": name == "config5"})
    doc = cs.config4_doc(cs.H, cs.W)
    bitmaps = rasterize_masks(doc, cs.W, cs.H, scale=1.0)
    p, c = parse_adjustments(doc)
    sp, cfg = stack_params([p] * 2, [c] * 2, device=dev)
    cfg = dataclasses.replace(cfg, dither_active=False)
    masks = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(bitmaps, (2,) + bitmaps.shape)))
    cases["config4"] = (fused.pack_rows(sp["glob"]),
                        fused.blur_levels(images, cfg, blur_band_rows(cfg, bitmaps)), cfg,
                        {"masks": masks.to(dev), "mmat": fused.pack_mask_rows(sp["mask"])})
    ms = {name: [] for name in cases}
    order = list(cases)
    rng = random.Random(seed)
    for _ in range(rounds):
        rng.shuffle(order)
        for name in order:
            pmat, levels, cfg, kw = cases[name]
            ms[name].append(cs.time_ms(lambda: fused.grade(images, levels, pmat, cfg, **kw), 20))
    ptxas = {k: list(v) for k, v in cs.ptxas_entries(fused._KERNEL.build_log).items()}
    print(json.dumps({"ms": {k: statistics.median(v) for k, v in ms.items()}, "ptxas": ptxas}))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts, the first the reference")
    ap.add_argument("--pairs", type=int, default=6, help="passes over the checkouts")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--child", action="store_true", help="(internal) one run of one checkout")
    args = ap.parse_args()
    if args.child:
        child(str(Path(args.trees[0]).resolve()), args.rounds, args.seed)
        return 0
    trees = {Path(t).name: str(Path(t).resolve()) for t in args.trees}
    if len(trees) < 2:
        raise SystemExit("grade_ab: give two or more checkouts with different names")
    print(f"[card] before: {card()}", flush=True)
    runs = {tag: [] for tag in trees}
    ptxas = {}
    for i in range(args.pairs):
        for tag in (list(trees) if i % 2 == 0 else list(trees)[::-1]):
            proc = subprocess.run([sys.executable, __file__, trees[tag], "--child", "--rounds",
                                   str(args.rounds), "--seed", str(args.seed)],
                                  cwd=trees[tag], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"grade_ab: the {tag} run {i} exited {proc.returncode}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tag].append(out["ms"])
            ptxas[tag] = out["ptxas"]
            print(f"[run] pass {i} {tag}: "
                  + ", ".join(f"{d} {out['ms'][d]:.4f} ms" for d in DOCS), flush=True)
    print(f"[card] after: {card()}")
    for tag in runs:
        for entry, (regs, spill) in sorted(ptxas[tag].items()):
            print(f"[build] {tag} {entry}: {regs} registers, {spill} bytes spilled")
    first = next(iter(trees))
    for d in DOCS:
        p = [r[d] for r in runs[first]]
        mp = statistics.median(p)
        line = f"[grade-ab] {d} B=2 24 MP: {first} median {mp:.4f} ms ({min(p):.4f}-{max(p):.4f})"
        for tag in list(trees)[1:]:
            c = [r[d] for r in runs[tag]]
            mc = statistics.median(c)
            line += (f"; {tag} median {mc:.4f} ms ({min(c):.4f}-{max(c):.4f}), /{first} "
                     f"{mc / mp:.4f}, slower in {sum(x > y for x, y in zip(c, p))} of {len(p)}")
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
