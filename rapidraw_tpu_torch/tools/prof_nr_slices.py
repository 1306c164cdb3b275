"""Probe P2: what does a 24-tap read of static 2-D offsets cost when it is
staged with a clamp-to-edge halo? NR's access pattern without NR's gates.

Counterpart of `tools/prof_nr_slices.py`, whose TPU kernel (`pallas_nr`)
accumulated 24 shifted slices of 64-row tiles with 16-row halo strips:
out = 0.5 x + sum_k f32(0.01 (k + 1)) x[c, clamp(y + dy_k), clamp(x + dx_k)]
over the 5x5 grid without its centre at stride 7 (offsets 0, +-4, +-7).
`slices` on a CUDA tensor is one launch of csrc/nr_slices.cu, whose blocks
stage a 32-column tile of `tile_rows` rows plus the halo in shared memory,
as csrc/nr.cu does; on a CPU tensor it is `slices_plain`, the probe's own
reference (`xla_nr`).

    python -m rapidraw_tpu_torch.tools.prof_nr_slices

times the kernel at nr.cu's 32x8 tile and at a 32x32 tile, the plain
version and one depthwise conv2d (the library yardstick) at 24 MP on the
card (CUDA events, chained calls; the median of REPEATS measurements). It raises without a CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.tools import (
    HALO, H, OFFSETS, PROBE_TOL, SLICES_OPS_PER_ELEMENT, W, bound_ms, card_line, require_cuda,
    time_chained)

ITERS = 6
TILE_ROWS = (8, 32)  # nr.cu's 32x8 tile, and a taller one
MAX_TILE_ROWS = 128
NTAPS = len(OFFSETS)

# --fmad=false: each product and sum rounds on its own, as in the plain version
_KERNEL = KernelLibrary("nr_slices", extra_flags=("--fmad=false",))


def _weight(k: int) -> float:
    return 0.01 * (k + 1)


def slices_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe's reference on (C, H, W): edge-pad by the largest offset,
    then add the weighted shifted slices in tap order to 0.5 x."""
    h, w = x.shape[-2:]
    m = HALO
    xp = F.pad(x[None], (m, m, m, m), mode="replicate")[0]
    acc = x * 0.5
    for k, (dx, dy) in enumerate(OFFSETS):
        acc = acc + xp[:, m + dy : m + dy + h, m + dx : m + dx + w] * _weight(k)
    return acc


def conv_yardstick(x: torch.Tensor):
    """The library call that computes the same function: one depthwise
    conv2d with a (2 HALO + 1)^2 kernel holding the 25 weights, over the
    edge-padded input. Returns (padded input, weights); not used by the port."""
    c = x.shape[0]
    k = torch.zeros((2 * HALO + 1, 2 * HALO + 1), dtype=torch.float32)
    k[HALO, HALO] = 0.5
    for i, (dx, dy) in enumerate(OFFSETS):
        k[HALO + dy, HALO + dx] = _weight(i)
    xp = F.pad(x[None], (HALO,) * 4, mode="replicate")
    return xp, k.to(x.device).expand(c, 1, *k.shape).contiguous()


class _Taps(ctypes.Structure):
    _fields_ = [("dx", ctypes.c_int * NTAPS), ("dy", ctypes.c_int * NTAPS),
                ("w", ctypes.c_float * NTAPS)]


def _taps() -> _Taps:
    taps = _Taps()
    for k, (dx, dy) in enumerate(OFFSETS):
        taps.dx[k], taps.dy[k], taps.w[k] = dx, dy, _weight(k)
    return taps


def _slices_cuda(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("slices kernel takes a contiguous tensor")
    c, h, w = x.shape
    if -(-h // tile_rows) >= 65536 or c >= 65536:
        raise ValueError(f"slices kernel takes fewer than 65536 tiles per column and planes, "
                         f"got {tuple(x.shape)} with {tile_rows}-row tiles")
    out = torch.empty_like(x)
    fn = _KERNEL.lib().rr_nr_slices
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(_Taps)] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(_taps()), HALO, tile_rows, c, h, w,
                stream)
    _KERNEL.check(status, "rr_nr_slices")
    slices.launches += 1
    return out


def slices(x: torch.Tensor, tile_rows: int = 8) -> torch.Tensor:
    """The 24-tap weighted sum of a float32 (C, H, W) tensor: the kernel wrapper.

    CPU tensor -> `slices_plain`; CUDA tensor -> one launch of
    csrc/nr_slices.cu with 32 x `tile_rows` tiles (a multiple of 8, <= 128).
    """
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"slices takes a float32 (C, H, W) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if tile_rows % 8 or not 8 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"slices takes tiles of 8..{MAX_TILE_ROWS} rows in steps of 8, "
                         f"got {tile_rows}")
    if x.device.type == "cpu":
        return slices_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"slices runs on CPU or CUDA tensors, got {x.device}")
    return _slices_cuda(x, tile_rows)


# launch count of the slices kernel: one per rr_nr_slices call
slices.launches = 0


def main() -> list[dict]:
    """Time both tiles, the plain version and the conv2d at 24 MP on the
    card and hold each tile against the plain version (raises on a
    mismatch); returns one row per tile."""
    dev = require_cuda()
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev)
    bms, bby = bound_ms(2 * img.numel() * 4, SLICES_OPS_PER_ELEMENT * img.numel())
    pts, ref = time_chained(slices_plain, img, 2, ITERS)
    pms = statistics.median(pts)
    xp, k = conv_yardstick(img)
    lts, conv = time_chained(lambda _: F.conv2d(xp, k, groups=img.shape[0])[0], img, 2, ITERS)
    lms = statistics.median(lts)
    print(f"[P2] (3, {H}, {W}) f32, {NTAPS} taps, halo {HALO}: plain {pms:.3f} ms, "
          f"bound {bms:.3f} ms ({bby}); one depthwise conv2d {lms:.3f} ms, max|d| "
          f"{float((conv - ref).abs().max()):.1e} [{card}]", flush=True)
    del xp, k, conv
    rows = []
    for tr in TILE_ROWS:
        ts, out = time_chained(lambda y, tr=tr: slices(y, tr), img, 2, ITERS)
        ms = statistics.median(ts)
        err = float((out - ref).abs().max())
        staged = (32 + 2 * HALO) * (tr + 2 * HALO) / (32 * tr)
        print(f"[P2] tile 32x{tr}: {ms:.3f} ms ({min(ts):.3f}-{max(ts):.3f} over {len(ts)}), "
              f"roofline share {bms / ms:.0%}, {staged:.2f} staged values per output, "
              f"max|d| {err:.1e} [{card}]", flush=True)
        if err > PROBE_TOL:
            raise AssertionError(f"P2 tile 32x{tr}: max|d| {err} > {PROBE_TOL}")
        rows.append(dict(variant=f"tile32x{tr}", ms=ms, ms_range=[min(ts), max(ts)],
                         plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=lms,
                         max_abs_err=err))
    return rows


if __name__ == "__main__":
    main()
