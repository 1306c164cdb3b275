"""The first vector-math call of a fresh process on the CPU.

MKL's vector math (PyTorch's CPU exp, log, log2, sqrt, sin, cos, tanh,
erf) sets itself up on its first call in a process; when that call is
split over two intra-op threads, one thread's share comes out up to ~3e-4
off that one time. Importing the port makes one single-threaded call
first (`rapidraw_tpu_torch/__init__.py`). Each child here starts as a
pytest worker does (JAX imported first, two threads), imports the port,
then forks TRIALS processes before any op of its own: each makes one site
its first float op, runs it again, then runs the downscale. The site's
first result must equal its second bit for bit, and the area downscale of
`test_torch_encode.py::test_downscale_matches_jax[target0]` (seed 9,
40 x 30) must stay within that test's 1e-6 of JAX's. Without the set-up
call, a process alone misses 3 to 12% of the time, depending on the
function, but under this test's load (twelve children at once) about one
trial in 240 misses: the 1,800 trials would pass without it about once in
two thousand runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = 12  # started together
TRIALS = 150  # forked processes per child, each with a first call of its own
DOWNSCALE_TOL = 1e-6

# the port's sites, then single vector-math calls of 4096 values (split
# over both threads): the ones a missing set-up call shows in
SITES = ["downscale", "local_contrast", "centre_mask", "dehaze", "glow", "tonal",
         "vignette", "fpow", "negative", "hdr", "atan2", "cos", "sin", "tanh", "exp", "log",
         "log2", "sqrt", "exp64", "log64"]

CHILD = r'''
import json, os, signal, sys
import jax
import numpy as np
import torch
torch.set_num_threads(2)
from rapidraw_tpu_torch.compositions import hdr, negative
from rapidraw_tpu_torch.geometry import resize
from rapidraw_tpu_torch.ops import common, local, tone
from rapidraw_tpu_torch.pipeline import grade

child, trials = int(sys.argv[1]), int(sys.argv[2])
sites = json.loads(sys.argv[3])
want = np.load(sys.argv[4])
rng = np.random.default_rng(3)
rgb = torch.from_numpy(rng.random((3, 48, 64), dtype=np.float32))
blur = torch.from_numpy(rng.random((3, 48, 64), dtype=np.float32))
xs, ys = common.coord_maps(48, 64, "cpu")
img9 = np.random.default_rng(9).random((3, 97, 131), dtype=np.float32)
pos = torch.from_numpy(rng.random(4096, dtype=np.float32) * 4 + 1e-3)
frames = [torch.from_numpy(rng.random((3, 32, 48), dtype=np.float32)) for _ in range(3)]
neg = negative.NegativeConversionParams()
run = {
    "downscale": lambda: resize.downscale(torch.from_numpy(img9), 40, 30),
    "local_contrast": lambda: local.apply_local_contrast(rgb, blur, 0.6, False, 0, 0.3),
    "centre_mask": lambda: local.centre_mask_from_coords(xs, ys, 64, 48),
    "dehaze": lambda: local.apply_dehaze(rgb, blur, 0.4),
    "glow": lambda: local.apply_glow_bloom(rgb, blur, 0.5, 0.0, 0.0, 0.0),
    "tonal": lambda: tone.apply_tonal_adjustments(rgb, blur, 0.3, 0.4, 0.2, 0.1),
    "vignette": lambda: grade.apply_vignette(rgb, xs, ys, 64, 48, -0.5, 0.5, 0.2, 0.5),
    "fpow": lambda: common.fpow(pos, 2.4),  # exp2 and log2
    "negative": lambda: negative.run_pipeline(rgb, neg),  # log, exp, pow
    "hdr": lambda: hdr.merge_hdr(frames, [1 / 500, 1 / 125, 1 / 30], [100, 100, 200]),
    "atan2": lambda: torch.atan2(pos - 2.0, torch.flip(pos, [0]) - 2.0),  # the flare map
    "cos": lambda: torch.cos(pos),  # the flare map's rings
    "sin": lambda: torch.sin(pos),
    "tanh": lambda: torch.tanh(pos),
    "exp": lambda: torch.exp(-pos),
    "log": lambda: torch.log(pos),
    "log2": lambda: torch.log2(pos),
    "sqrt": lambda: torch.sqrt(pos),
    "exp64": lambda: torch.exp(-pos.double()),
    "log64": lambda: torch.log(pos.double()),
}


def trial(first):
    name = sites[first]
    got, again = run[name](), run[name]()
    down = got if name == "downscale" else run["downscale"]()
    return {"first": name, "downscale_err": float(np.abs(down.numpy() - want).max()),
            "equal": bool(torch.equal(got, again))}


results = []
for k in range(trials):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # a fresh process: no op has run in it or in its parent
        os.close(r)
        signal.alarm(120)
        os.write(w, json.dumps(trial((child * trials + k) % len(sites))).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        out = f.read()
    _, status = os.waitpid(pid, 0)
    results.append(json.loads(out) if os.waitstatus_to_exitcode(status) == 0
                   else {"failed": status})
print(json.dumps(results))
'''


def test_first_calls_in_fresh_processes(tmp_path):
    import numpy as np

    from rapidraw_tpu.geometry import resize as jresize

    img9 = np.random.default_rng(9).random((3, 97, 131), dtype=np.float32)
    want = tmp_path / "want.npy"
    np.save(want, np.asarray(jresize.downscale(img9, 40, 30)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-W", "ignore::DeprecationWarning", "-c", CHILD,
                          str(i), str(TRIALS), json.dumps(SITES), str(want)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                         cwd=str(ROOT))
        for i in range(CHILDREN)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        results += json.loads(out.strip().splitlines()[-1])
    assert len(results) == CHILDREN * TRIALS
    assert not [r for r in results if "failed" in r], results
    assert {r["first"] for r in results} == set(SITES)
    errs = [r["downscale_err"] for r in results]
    assert max(errs) <= DOWNSCALE_TOL, errs
    missed = [r["first"] for r in results if not r["equal"]]
    assert not missed, missed


@pytest.mark.parametrize("fn", ["sqrt_rn"])
def test_float64_route_is_correctly_rounded(fn):
    """sqrt_rn rounds the float64 root once: it equals NumPy's correctly
    rounded float32 sqrt."""
    import numpy as np
    import torch

    from rapidraw_tpu_torch.ops import common

    x = np.random.default_rng(5).random(20000, dtype=np.float32) * 100 + 1e-6
    got = getattr(common, fn)(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sqrt(x))
