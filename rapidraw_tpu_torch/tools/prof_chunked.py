"""Probe P1: does a long elementwise chain run at its memory bound, and does
giving each thread several rows beat one element per thread?

Counterpart of `tools/prof_chunked.py`, whose TPU kernel ran `chain` on
256x512 tiles whole or as a loop over CH-row slices. Here `chain` on a CUDA
tensor is one launch of csrc/chunked.cu: `rows=1` is one thread per
element (the "whole" variant), `rows=CH` gives each thread CH rows of one
column, coalesced across the warp (the CH-row chunk: more independent work
per thread instead of more threads). On a CPU tensor it is `chain_plain`.

    python -m rapidraw_tpu_torch.tools.prof_chunked

times every variant at 24 MP on the card (CUDA events, chained calls; the
median of REPEATS measurements, their range beside it) and prints each
beside the plain version and the bound. It raises without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.tools import (
    CHAIN_OPS_PER_ELEMENT, CHAIN_ROUNDS, H, PROBE_TOL, W, bound_ms, card_line, require_cuda,
    time_chained)

ITERS = 8
VARIANTS = (1, 8, 16, 32, 64)  # rows per thread: whole, then the probe's CH values
MAX_ROWS = 64

# --fmad=false: each multiply and add rounds on its own, as the plain
# version's separate PyTorch ops do
_KERNEL = KernelLibrary("chunked", extra_flags=("--fmad=false",))


def chain_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe's chain, op for op: a mix resembling the grade chain
    (mul-add, max 0, smoothstep, a select, one exp2) repeated 8 times."""
    for _ in range(CHAIN_ROUNDS):
        x = x * 1.0001 + 0.0001
        x = torch.clamp_min(x, 0.0)
        x = x * x * (3.0 - 2.0 * x)
        x = torch.where(x > 0.5, x * 0.999, x)
        x = torch.exp2(x * 0.1) * 0.933
    return x


def _chain_cuda(x: torch.Tensor, rows: int) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("chain kernel takes a contiguous tensor")
    width = x.shape[-1]
    nrows = x.numel() // width
    groups = -(-nrows // rows)
    if groups >= 65536:
        raise ValueError(f"chain kernel takes fewer than 65536 groups of {rows} rows, "
                         f"got {groups}")
    out = torch.empty_like(x)
    fn = _KERNEL.lib().rr_chain
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _KERNEL.check(fn(x.data_ptr(), out.data_ptr(), nrows, width, rows, stream), "rr_chain")
    chain.launches += 1
    return out


def chain(x: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """The chain over a float32 (..., W) tensor: the kernel wrapper.

    CPU tensor -> `chain_plain`; CUDA tensor -> one launch of
    csrc/chunked.cu, `rows` rows of one column per thread (1..64).
    """
    if x.dtype != torch.float32 or x.ndim < 2:
        raise ValueError(f"chain takes a float32 (..., W) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"chain takes 1..{MAX_ROWS} rows per thread, got {rows}")
    if x.device.type == "cpu":
        return chain_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"chain runs on CPU or CUDA tensors, got {x.device}")
    return _chain_cuda(x, rows)


# launch count of the chain kernel: one per rr_chain call
chain.launches = 0


def main() -> list[dict]:
    """Time every variant at 24 MP on the card and hold each against the
    plain version (raises on a mismatch); returns one row per variant."""
    dev = require_cuda()
    card = card_line()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev)
    bms, bby = bound_ms(2 * img.numel() * 4, CHAIN_OPS_PER_ELEMENT * img.numel())
    pts, ref = time_chained(chain_plain, img, 2, ITERS)
    pms = statistics.median(pts)
    print(f"[P1] (3, {H}, {W}) f32, {CHAIN_OPS_PER_ELEMENT} ops/element: plain {pms:.3f} ms, "
          f"bound {bms:.3f} ms ({bby}) [{card}]", flush=True)
    rows = []
    for r in VARIANTS:
        ts, out = time_chained(lambda y, r=r: chain(y, r), img, 2, ITERS)
        ms = statistics.median(ts)
        err = float((out - ref).abs().max())
        name = "whole" if r == 1 else f"rows{r}"
        print(f"[P1] {name:6s} {ms:7.3f} ms ({min(ts):.3f}-{max(ts):.3f} over {len(ts)}), "
              f"roofline share {bms / ms:.0%}, max|d| {err:.1e} [{card}]", flush=True)
        if err > PROBE_TOL:
            raise AssertionError(f"P1 {name}: max|d| {err} > {PROBE_TOL}")
        rows.append(dict(variant=name, ms=ms, ms_range=[min(ts), max(ts)], plain_ms=pms,
                         bound_ms=bms, bound_by=bby, library_ms=None, max_abs_err=err))
    return rows


if __name__ == "__main__":
    main()
