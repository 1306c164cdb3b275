"""How often the first vector-math call of a fresh process on the CPU goes
wrong, by function, precision and set-up call.

PyTorch's CPU exp, log, log2, sqrt, sin, cos, tanh and erf call MKL's
vector math (VML); exp2, pow, atan2 and sigmoid do not. Each case runs
in a fresh interpreter that imports only NumPy and PyTorch (not this
package, whose import makes the set-up call), sets two intra-op threads,
makes the set-up call if the case has one, then forks TRIALS processes
before any other op: each calls the function twice on 4096 values (two
chunks, one per thread) and counts as a miss where the two results
differ. The set-ups: "none", a one-element float32 sqrt (a VML call on
this thread alone, as `rapidraw_tpu_torch/__init__.py` makes) and a
one-element sigmoid (no VML call).

    python -m rapidraw_tpu_torch.tools.vml_first_call [--trials 96] [--jobs 4]

prints one line per case, "function dtype set-up: misses/trials", and the
largest error of a missed first call against float64.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r'''
import os, sys
import numpy as np
import torch
fn, dtype, setup, trials = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
torch.set_num_threads(2)
ops = {"sqrt": torch.sqrt, "log": torch.log, "log2": torch.log2,
       "exp": lambda t: torch.exp(-t), "sin": torch.sin, "cos": torch.cos,
       "tanh": torch.tanh, "erf": torch.erf, "exp2": lambda t: torch.exp2(-t),
       "pow": lambda t: torch.pow(t, 1 / 2.2), "sigmoid": torch.sigmoid,
       "atan2": lambda t: torch.atan2(t - 2.0, torch.flip(t, [0]) - 2.0)}
x = torch.from_numpy(np.random.default_rng(3).random(4096) * 4 + 1e-3).to(getattr(torch, dtype))
misses, worst = 0, 0.0
for _ in range(trials):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        if setup == "sqrt":
            torch.sqrt(torch.ones(1))
        elif setup == "sigmoid":
            torch.sigmoid(torch.ones(1))
        first, second = ops[fn](x), ops[fn](x)
        err = float((first.double() - ops[fn](x.double())).abs().max())
        os.write(w, f"{int(not torch.equal(first, second))} {err}".encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        miss, err = f.read().split()
    os.waitpid(pid, 0)
    misses += int(miss)
    worst = max(worst, float(err)) if int(miss) else worst
print(f"{fn} {dtype} {setup}: {misses}/{trials} (missed first call max |err| {worst:.2e})")
'''

VML = ("sqrt", "log", "log2", "exp", "sin", "cos", "tanh", "erf")
OTHER = ("exp2", "pow", "atan2", "sigmoid")
CASES = ([(f, "float32", "none") for f in VML + OTHER]
         + [(f, "float64", "none") for f in ("sqrt", "log", "exp")]
         + [(f, "float32", "sqrt") for f in VML]
         + [(f, "float64", "sqrt") for f in ("sqrt", "log", "exp")]
         + [("exp", "float32", "sigmoid")])


def run_case(case, trials: int) -> str:
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", CHILD, *case, str(trials)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=96)
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args()
    with ThreadPoolExecutor(args.jobs) as pool:
        for line in pool.map(lambda c: run_case(c, args.trials), CASES):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
