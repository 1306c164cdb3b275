"""Probe P2: what does a 24-tap read of static 2-D offsets cost when it is
staged with a clamp-to-edge halo? NR's access pattern without NR's gates.

Counterpart of `tools/prof_nr_slices.py`, whose TPU kernel (`pallas_nr`)
accumulated 24 shifted slices of 64-row tiles with 16-row halo strips:
out = 0.5 x + sum_k f32(0.01 (k + 1)) x[c, clamp(y + dy_k), clamp(x + dx_k)]
over the 5x5 grid without its centre at stride 7 (offsets 0, +-4, +-7).
`slices` on a CUDA tensor is one launch of csrc/nr_slices.cu: each thread
owns 4 adjacent columns of a band of rows, reads each input row of the band
(plus the halo) once from a ring of rows staged in shared memory, and
scatters it into a ring of 15 output rows of accumulators in tap order; the
band height is the work split (`slices_launch_plan`). On a CPU tensor it is
`slices_plain`, the probe's own reference (`xla_nr`).

    python -m rapidraw_tpu_torch.tools.prof_nr_slices

times the kernel at the plan's band (one wave of resident blocks) and at
half of it (two waves), the plain version and one depthwise conv2d (the
library yardstick) at 24 MP on the card (CUDA events, chained calls; the
median of REPEATS measurements), and holds each band bit for bit against
the plain version. It raises without a CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.tools import (
    HALO, H, OFFSETS, SLICES_OPS_PER_ELEMENT, W, bound_ms, card_line, require_cuda,
    time_chained)

ITERS = 6
WAVES = (1, 2)  # the plan's band fills the resident blocks once; half of it, twice
NTAPS = len(OFFSETS)
# csrc/nr_slices.cu's block: threads, and the adjacent columns each one owns
THREADS, COLS = 512, 4
BLOCK_COLS = THREADS * COLS
PAD = 8  # staged columns on each side of a block: HALO in whole 16-byte vectors
MAX_GRID = 65536  # bands per column and planes: below CUDA's grid y / z limit

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


def _check_band_rows(band_rows) -> None:
    if band_rows is not None and (type(band_rows) is not int or band_rows < 1):
        raise ValueError(f"slices takes bands of at least one row (an int), got {band_rows!r}")


def slices_launch_plan(c: int, h: int, w: int, slots: int, band_rows: int | None = None,
                       aligned: bool = True) -> dict:
    """The kernel's launch on a (c, h, w) tensor when `slots` blocks fit on
    the card at once: blocks of BLOCK_COLS columns, each a band of
    `band_rows` rows (by default the shortest band whose grid fits in one
    wave of `slots`), its input rows the band plus HALO on each side.
    "vector": 16-byte copies and stores (w % 4 == 0 and `aligned` pointers),
    else the edge path of 4-byte copies of clamped columns everywhere;
    "edge_blocks": the column blocks whose staged halo crosses the image's
    left or right edge and takes the edge path's copies there.
    rr_nr_slices refuses a grid past MAX_GRID bands or planes."""
    _check_band_rows(band_rows)
    if min(c, h, w) < 1:
        raise ValueError(f"slices kernel takes a non-empty tensor, got {(c, h, w)}")
    col_blocks = -(-w // BLOCK_COLS)
    if band_rows is None:
        band_rows = -(-h // max(1, slots // (col_blocks * c)))
    bands = -(-h // band_rows)
    if bands >= MAX_GRID or c >= MAX_GRID:
        raise ValueError(f"slices kernel takes fewer than {MAX_GRID} bands per column and "
                         f"planes, got {(c, h, w)} with {band_rows}-row bands")
    blocks = col_blocks * bands * c
    return {
        "band_rows": band_rows, "steps": band_rows + 2 * HALO, "grid": (col_blocks, bands, c),
        "waves": -(-blocks // max(slots, 1)), "vector": aligned and w % 4 == 0,
        "edge_blocks": [i for i in range(col_blocks)
                        if i * BLOCK_COLS - PAD < 0 or (i + 1) * BLOCK_COLS + PAD > w],
    }


class _Weights(ctypes.Structure):
    _fields_ = [("w", ctypes.c_float * NTAPS)]


def _weights() -> _Weights:
    weights = _Weights()
    for k in range(NTAPS):
        weights.w[k] = _weight(k)
    return weights


# libraries whose compiled tap table matched OFFSETS; held weakly, so a
# freed library's id, reused by another object, is never taken as checked
_CHECKED: weakref.WeakSet = weakref.WeakSet()


def check_tap_table(lib) -> None:
    """Raise unless the library's compiled tap table (rr_nr_slices_taps) is
    OFFSETS, in table order; checked once per library."""
    if lib in _CHECKED:
        return
    dx, dy = (ctypes.c_int * NTAPS)(), (ctypes.c_int * NTAPS)()
    n = lib.rr_nr_slices_taps(dx, dy)
    table = list(zip(dx[:n], dy[:n]))
    if table != OFFSETS:
        raise ValueError(f"csrc/nr_slices.cu's compiled taps {table} are not OFFSETS {OFFSETS}")
    _CHECKED.add(lib)


# library -> {device index: resident blocks on the card}, held weakly as _CHECKED
_SLOTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _slots(lib, device: torch.device) -> int:
    slots = _SLOTS.setdefault(lib, {})
    if device.index not in slots:
        per_sm = ctypes.c_int()
        _KERNEL.check(lib.rr_nr_slices_blocks_per_sm(ctypes.byref(per_sm)),
                      "rr_nr_slices_blocks_per_sm")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        slots[device.index] = sms * per_sm.value
    return slots[device.index]


def _slices_cuda(x: torch.Tensor, band_rows: int | None) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("slices kernel takes a contiguous tensor")
    c, h, w = x.shape
    lib = _KERNEL.lib()
    check_tap_table(lib)
    out = torch.empty_like(x)
    plan = slices_launch_plan(c, h, w, _slots(lib, x.device), band_rows,
                              aligned=x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = lib.rr_nr_slices
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(_Weights)] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(_weights()), plan["band_rows"], c, h,
                w, int(plan["vector"]), stream)
    _KERNEL.check(status, "rr_nr_slices")
    slices.launches += 1
    return out


def slices(x: torch.Tensor, band_rows: int | None = None) -> torch.Tensor:
    """The 24-tap weighted sum of a float32 (C, H, W) tensor: the kernel wrapper.

    CPU tensor -> `slices_plain`; CUDA tensor -> one launch of
    csrc/nr_slices.cu in bands of `band_rows` rows (by default the plan's:
    one wave of resident blocks).
    """
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"slices takes a float32 (C, H, W) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_band_rows(band_rows)
    if x.device.type == "cpu":
        return slices_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"slices runs on CPU or CUDA tensors, got {x.device}")
    return _slices_cuda(x, band_rows)


# launch count of the slices kernel: one per rr_nr_slices call
slices.launches = 0


def main() -> list[dict]:
    """Time the kernel at the plan's band and at its half, the plain version
    and the conv2d at 24 MP on the card, and hold each band bit for bit
    against the plain version (raises on any difference); returns one row
    per band."""
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
    slots = _slots(_KERNEL.lib(), dev)
    full = slices_launch_plan(*img.shape, slots)["band_rows"]
    rows = []
    for waves in WAVES:
        band = -(-full // waves)
        plan = slices_launch_plan(*img.shape, slots, band)
        ts, out = time_chained(lambda y, band=band: slices(y, band), img, 2, ITERS)
        ms = statistics.median(ts)
        d = (out - ref).abs()
        err, ndiff = float(d.max()), int((d > 0).sum())
        print(f"[P2] band {band} rows ({plan['waves']} wave(s) of {slots} resident blocks, "
              f"grid {plan['grid']}, {plan['steps'] / band:.3f} input rows per output row): "
              f"{ms:.3f} ms ({min(ts):.3f}-{max(ts):.3f} over {len(ts)}), roofline share "
              f"{bms / ms:.0%}, max|d| {err:.1e}, {ndiff} values differ [{card}]", flush=True)
        if ndiff:
            raise AssertionError(f"P2 band {band}: {ndiff} values differ from the plain "
                                 f"version, max|d| {err}")
        rows.append(dict(variant=f"band{band}", ms=ms, ms_range=[min(ts), max(ts)],
                         plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=lms,
                         max_abs_err=err))
    return rows


if __name__ == "__main__":
    main()
