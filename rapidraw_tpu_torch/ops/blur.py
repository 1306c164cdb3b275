"""Separable Gaussian blur pyramid (PyTorch + the CUDA kernel csrc/blur.cu).

Port of `rapidraw_tpu/ops/blur.py`. Semantics from blur.wgsl: truncated
Gaussian with sigma = radius/2, taps [-radius, radius], clamp-to-edge
sampling, normalized by the full weight sum; input samples clamped to
[0, F16_MAX] (the reference pyramid lives in rgba16f textures).

`gaussian_blur_multi` is the kernel wrapper: a CPU tensor goes to the plain
version (`gaussian_blur_multi_plain`, depthwise convolutions), a CUDA
tensor to the hand-written kernel, which replaces the TPU kernels B1
(`_blur_axis`) and B2 (`_blur_axis_multi`), on the launch plan
`blur_launch_plan` computes from the radii and the shape. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.native import KernelLibrary

F16_MAX = 65504.0
MAX_LEVELS = 4

_KERNEL = KernelLibrary("blur")


@functools.lru_cache(maxsize=64)
def _gauss_weights(radius: int) -> np.ndarray:
    sigma = radius / 2.0
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    w = np.exp(-(x * x) / np.float32(2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def _conv1d(img: torch.Tensor, weights: torch.Tensor, axis: int) -> torch.Tensor:
    """Depthwise 1-D 'valid' convolution of planar (C, H, W) along `axis`
    (0 -> H, 1 -> W)."""
    c = img.shape[0]
    k = weights.numel()
    shape = (c, 1, 1, k) if axis == 1 else (c, 1, k, 1)
    kernel = weights.reshape(1, 1, *shape[2:]).expand(shape)
    return F.conv2d(img[None], kernel, groups=c)[0]


def gaussian_blur_reference(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain blur of planar (C, H, W): clamp, edge-pad, H conv, V conv.

    On the GPU, cuDNN runs float32 convolutions in TF32 unless
    `torch.backends.cudnn.allow_tf32` is False; a comparison must set it.
    """
    x = torch.clamp(img, 0.0, F16_MAX)
    weights = torch.from_numpy(_gauss_weights(radius)).to(img.device)
    xp = F.pad(x[None], (radius, radius, 0, 0), mode="replicate")[0]
    x = _conv1d(xp, weights, axis=1)
    xp = F.pad(x[None], (0, 0, radius, radius), mode="replicate")[0]
    return _conv1d(xp, weights, axis=0)


def gaussian_blur_multi_plain(img: torch.Tensor, radii: tuple) -> list:
    """Plain version of the blur kernel: one reference blur per radius."""
    return [gaussian_blur_reference(img, r) for r in radii]


def _check_input(img: torch.Tensor, radii: tuple) -> None:
    if img.dtype != torch.float32 or img.ndim != 3:
        raise ValueError(f"blur takes a float32 (C, H, W) tensor, got {img.dtype} {tuple(img.shape)}")
    if not 1 <= len(radii) <= MAX_LEVELS or min(radii) < 1:
        raise ValueError(f"blur takes 1..{MAX_LEVELS} radii >= 1, got {radii}")


# The kernel's fixed shapes (csrc/blur.cu): KB outputs per thread and taps
# per chunk, 256 threads, FX columns per block (one KB column block per
# warp). Fused: the source streams in steps of F_STEP rows, copied in
# 4-column chunks, through a stage at most F_STAGE_W wide. Two-pass: H
# tiles of H_ROWS rows, V strips of V_COLS columns stepping V_STEP rows (KB
# per warp) through the ring.
KB = 16
FX = 128
F_STEP = 32
F_STAGE_W = 255
H_ROWS = 32
V_COLS = 32
V_STEP = 128
SMEM_LIMIT = 232448  # bytes one block may use on sm_90; rr_blur refuses more

# Levels with r <= FUSED_MAX_RADIUS take the fused regime, the others two
# passes; the output rows of a fused strip and of a V strip (PERF.md, PR 5).
FUSED_MAX_RADIUS = 16
FUSED_STRIP = 512
V_STRIP = 512


def padded_taps(r: int) -> int:
    """2r+1 taps rounded up to whole chunks of KB (the padding weighs 0)."""
    return -(-(2 * r + 1) // KB) * KB


def fused_ring(r: int, rmax: int) -> tuple[int, int]:
    """(ring rows, delay in steps) of a fused level of radius r beside a
    largest fused radius rmax. Ring entry e holds the H row of source row
    ys - r + e; step st computes the H rows of source rows ys - rmax + st *
    F_STEP + [0, F_STEP), then the V pass of output block st - delay, which
    reads entries up to its last row + padded_taps(r) - 1. The ring keeps
    every entry that V pass reads while the same step's H pass writes; its
    size is a power of two, so the kernel wraps an entry with a mask."""
    off, tp = rmax - r, padded_taps(r)
    delay = -(-(tp - 1 + off) // F_STEP)
    need = (delay + 1) * F_STEP - off
    return 1 << (need - 1).bit_length(), delay


def col_halo(rmax: int) -> int:
    """Columns a fused stage holds left of its tile: rmax rounded up to a
    multiple of 4, so the stage's 4-column chunks are 16-byte aligned."""
    return -(-rmax // 4) * 4


def _fused_part(c: int, n: int, m: int, radii: tuple, fused: list) -> dict:
    """The fused regime's part of the plan for the levels `fused`."""
    if not fused:
        return {}
    rmax = max(radii[g] for g in fused)
    tpmax = max(padded_taps(radii[g]) for g in fused)
    rings, delays = zip(*(fused_ring(radii[g], rmax) for g in fused))
    # widest column an H chunk reads, made odd for conflict-free rows; the
    # landing rows the copies fill are that rounded up to whole chunks
    sw = max(col_halo(rmax) - radii[g] + padded_taps(radii[g]) for g in fused) + FX - 1
    sw |= 1
    if sw > F_STAGE_W:
        raise ValueError(f"blur radii {radii}: fused stage {sw} wider than {F_STAGE_W}")
    land = -(-sw // 4) * 4
    return dict(fused_tile=(FUSED_STRIP, FX), fused_stage_w=sw, fused_rings=rings,
                fused_delays=delays,
                fused_smem=4 * (len(fused) * tpmax + F_STEP * (land + sw)
                                + sum(rings) * (FX + 1)),
                fused_grid=(-(-m // FX), -(-n // FUSED_STRIP), c))


def blur_launch_plan(c: int, n: int, m: int, radii: tuple) -> dict:
    """The blur kernel's launch on a (c, n, m) source and 1..4 radii.

    Levels with r <= FUSED_MAX_RADIUS go to the fused regime (`fused`: one
    launch; a block streams the source rows of a `fused_tile` strip through
    a stage `fused_stage_w` wide, `col_halo` columns left of the tile, and
    keeps each level's H rows in a ring of `fused_rings` rows), the others
    to the two-pass regime (`two_pass`: an H launch over H_ROWS x FX tiles,
    then a V launch over `v_tile` strips through a ring of `v_ring` rows).
    Where the fused levels' rings would not fit in a block's shared memory
    (several levels near the threshold), the largest of them takes two
    passes instead. Grids and shared-memory bytes are the kernels' own;
    rr_blur recomputes them and refuses a plan that differs or passes
    SMEM_LIMIT, and this function raises first."""
    radii = tuple(int(r) for r in radii)
    # candidates by radius: while the fused stage does not fit, the largest
    # of them takes two passes
    small = sorted((g for g, r in enumerate(radii) if r <= FUSED_MAX_RADIUS),
                   key=lambda g: radii[g])
    fused = sorted(small)
    part = _fused_part(c, n, m, radii, fused)
    while part and part["fused_smem"] > SMEM_LIMIT:
        small.pop()
        fused = sorted(small)
        part = _fused_part(c, n, m, radii, fused)
    two = [g for g in range(len(radii)) if g not in fused]
    plan = {"radii": radii, "fused": fused, "two_pass": two, **part}
    if two:
        tpmax = max(padded_taps(radii[g]) for g in two)
        ring = 2 * V_STEP + tpmax
        plan.update(h_tile=(H_ROWS, FX), h_smem=4 * (tpmax + H_ROWS * (FX + tpmax - 1)),
                    h_grid=(-(-m // FX), -(-n // H_ROWS), len(two) * c),
                    v_tile=(V_STRIP, V_COLS), v_ring=ring, v_smem=4 * (tpmax + ring * V_COLS),
                    v_grid=(-(-m // V_COLS), -(-n // V_STRIP), len(two) * c))
    for key in ("fused_smem", "h_smem", "v_smem"):
        if plan.get(key, 0) > SMEM_LIMIT:
            raise ValueError(f"blur radii {radii}: {key} {plan[key]} B passes {SMEM_LIMIT}")
    return plan


class _Plan(ctypes.Structure):
    """csrc/blur.cu's BlurPlan, field for field."""

    _fields_ = (
        [("nf", ctypes.c_int)]
        + [(k, ctypes.c_int * MAX_LEVELS) for k in ("fr", "fslot", "fring", "fdelay")]
        + [(k, ctypes.c_int) for k in ("fstrip", "sw", "fgx", "fgy", "fsmem")]
        + [("n2", ctypes.c_int), ("tr", ctypes.c_int * MAX_LEVELS),
           ("tslot", ctypes.c_int * MAX_LEVELS)]
        + [(k, ctypes.c_int) for k in ("hgx", "hgy", "hsmem", "strip", "ring", "vgx", "vgy",
                                       "vsmem")]
    )


def _pack_plan(plan: dict) -> _Plan:
    radii = plan["radii"]
    p = _Plan()
    p.nf, p.n2 = len(plan["fused"]), len(plan["two_pass"])
    for i, g in enumerate(plan["fused"]):
        p.fr[i], p.fslot[i] = radii[g], g
        p.fring[i], p.fdelay[i] = plan["fused_rings"][i], plan["fused_delays"][i]
    for i, g in enumerate(plan["two_pass"]):
        p.tr[i], p.tslot[i] = radii[g], g
    if p.nf:
        p.fstrip, p.sw = plan["fused_tile"][0], plan["fused_stage_w"]
        p.fsmem = plan["fused_smem"]
        p.fgx, p.fgy = plan["fused_grid"][:2]
    if p.n2:
        p.hgx, p.hgy = plan["h_grid"][:2]
        p.hsmem, p.strip, p.ring = plan["h_smem"], plan["v_tile"][0], plan["v_ring"]
        p.vgx, p.vgy = plan["v_grid"][:2]
        p.vsmem = plan["v_smem"]
    return p


@functools.lru_cache(maxsize=64)
def _packed_plan(c: int, n: int, m: int, radii: tuple) -> tuple[dict, _Plan]:
    """The plan of a shape and its C struct, built once per shape: a call
    costs ~25 us of host time otherwise, next to a ~0.5 ms kernel."""
    plan = blur_launch_plan(c, n, m, radii)
    return plan, _pack_plan(plan)


def _blur_multi_cuda(img: torch.Tensor, radii: tuple) -> list:
    c, n, m = img.shape
    if not img.is_contiguous():
        raise ValueError("blur kernel takes a contiguous tensor")
    plan, packed = _packed_plan(c, n, m, radii)
    levels = len(radii)
    out = torch.empty((levels * c, n, m), dtype=torch.float32, device=img.device)
    n2 = len(plan["two_pass"])
    tmp = torch.empty((n2 * c, n, m), dtype=torch.float32, device=img.device) if n2 else None
    wstride = 2 * max(radii) + 1
    wbuf = torch.empty((levels, wstride), dtype=torch.float32, device=img.device)
    rs = list(radii) + [0] * (MAX_LEVELS - levels)
    fn = _KERNEL.lib().rr_blur
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.POINTER(_Plan)]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(img.device).cuda_stream
    status = fn(
        img.data_ptr(), tmp.data_ptr() if n2 else None, out.data_ptr(), wbuf.data_ptr(),
        wstride, *rs, levels, c, n, m, ctypes.byref(packed), stream,
    )
    _KERNEL.check(status, "rr_blur")
    gaussian_blur_multi.launches += 1
    return [out[g * c : (g + 1) * c] for g in range(levels)]


def gaussian_blur_multi(img: torch.Tensor, radii: tuple) -> list:
    """All blur-pyramid levels of one (C, H, W) source.

    CPU tensor -> plain depthwise convolutions; CUDA tensor -> one call of
    csrc/blur.cu on `blur_launch_plan` (the small radii in one fused pass,
    the large ones in an H and a V pass).
    Returns a list of (C, H, W) levels, one per radius.
    """
    radii = tuple(int(r) for r in radii)
    _check_input(img, radii)
    if img.device.type == "cpu":
        return gaussian_blur_multi_plain(img, radii)
    if img.device.type != "cuda":
        raise ValueError(f"blur runs on CPU or CUDA tensors, got {img.device}")
    return _blur_multi_cuda(img, radii)


# launch count of the blur kernel: one per rr_blur call (the weight prep,
# the fused pass and the two-pass H and V passes of every level of one source)
gaussian_blur_multi.launches = 0


def gaussian_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """One blur level of planar (C, H, W) — the single-radius case (B1)."""
    return gaussian_blur_multi(img, (radius,))[0]
