"""Profiling probes of the port, the counterparts of the repo's `tools/`
probes P1 (`tools/prof_chunked.py`) and P2 (`tools/prof_nr_slices.py`).

Each probe module holds a hand-written CUDA kernel (csrc/chunked.cu,
csrc/nr_slices.cu), its plain PyTorch version, a wrapper that picks one by
the tensor's device, and a `main()` that times them at 24 MP on the card:

    python -m rapidraw_tpu_torch.tools.prof_chunked
    python -m rapidraw_tpu_torch.tools.prof_nr_slices

This package keeps its own copies of the probes' constants, and the
measurement helpers the probes and chip_smoke.py share (the card line, the
bound, repeated chained CUDA-event timing). It imports torch and numpy only.
"""

from __future__ import annotations

import subprocess

import torch

H, W = 4096, 6144  # 24 MP, the probes' image

# P1: the elementwise chain, N_OPS // 6 rounds of 13 operations each
N_OPS = 48
CHAIN_ROUNDS = N_OPS // 6
CHAIN_OPS_PER_ELEMENT = 13 * CHAIN_ROUNDS  # 104

# P2: the 24 taps of a 5x5 grid without its centre, at a fixed stride
TAPS = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3) if (dx, dy) != (0, 0)]
STRIDE = 7
OFFSETS = [(round(dx * STRIDE / 2), round(dy * STRIDE / 2)) for dx, dy in TAPS]
HALO = max(max(abs(a), abs(b)) for a, b in OFFSETS)  # 7
SLICES_OPS_PER_ELEMENT = 1 + 2 * len(TAPS)  # 49

# each kernel against its plain version: the same operations in the same
# order, so bit-identical output is expected; the bound allows a last ulp
PROBE_TOL = 1e-6

# H100 SXM peaks (NVIDIA data sheet) at the full 700 W power limit: HBM3
# bytes/s and dense float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# chained measurements per timed case; a case's time is their median, and
# their range is printed beside it
REPEATS = 5


def require_cuda() -> torch.device:
    """The card the probes measure on; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure on a CUDA device; torch.cuda.is_available() "
                           "is False")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 peak, whichever is larger (ms, name)."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_chained(fn, x: torch.Tensor, base: int, iters: int,
                 repeats: int = REPEATS) -> tuple[list[float], torch.Tensor]:
    """(ms per call of each of `repeats` measurements, fn(x)) of `fn`, each
    call fed the previous output (the probes' scheme): one measurement is the
    CUDA-event time of base + iters chained calls less that of base calls,
    over iters. fn(x) is the warm-up call's output."""

    def run(n: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = x
        for _ in range(n):
            y = fn(y)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    first = fn(x)  # warm-up: the build and the first launch
    torch.cuda.synchronize()
    return [(run(base + iters) - run(base)) / iters for _ in range(repeats)], first
