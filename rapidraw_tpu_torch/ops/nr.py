"""Noise reduction (PyTorch + csrc/nr.cu).

Port of `rapidraw_tpu/ops/nr.py:apply_noise_reduction` (shader.wgsl:
889-1075): a 5x5 sampling window whose stride grows with the amount and
the resolution; a two-pass robust (bisquare) weighted luma mean; a joint
spatial/luma/chroma bilateral filter on the R-Y / B-Y planes. With
document-constant amounts (every single document without NR masks) the
tap offsets are fixed, so each tap is an edge-clamped shift (`nr_static`).
With per-pixel amounts (NR that a mask drives, or a batch whose documents
carry different amounts) the taps are hash-jittered per pixel and gathered
(`nr_dynamic`, JAX nr.py:108-254).

The centre value is the CA-corrected, linearized pixel, while the neighbour
taps read the *original* input, linearized (shader.wgsl:951, 1040):
`nr_planes` makes those three neighbour planes (luma, R-Y, B-Y).

`nr_static` and `nr_dynamic` are the kernel wrappers: a CPU tensor runs
the plain version, a CUDA tensor launches csrc/nr.cu (`rr_nr_static`,
which replaces the TPU kernel B5 `_apply_nr_static_pallas`, and
`rr_nr_dynamic`, JAX's per-pixel gather path, which has no TPU kernel).
`nr_static_plain` follows that Pallas kernel body at float32 (not the XLA
formulation `_apply_nr_static`): the equal/not-equal edge-gate select, the
hoisted smoothstep reciprocal, gates pre-masked at 1e-4 for the robust
pass, the centre tap's gate g_eq, one exp per chroma tap.
`nr_dynamic_plain` follows JAX's gather path op for op. Each kernel
repeats its plain version's operations in the same order.

The exact-jitter mode (RAPIDRAW_NR_EXACT_JITTER) is not ported.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.common import (
    LUMA_COEFF,
    as_t,
    coord_maps,
    luma,
    mix,
    smoothstep,
    sqrt_rn,
)
from rapidraw_tpu_torch.ops.grain import hash2

_OFFSETS = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3) if not (dx == 0 and dy == 0)]
NTAPS = len(_OFFSETS)
NR_HALO = 16  # the largest tap offset the kernel's shared-memory tile holds

# --fmad=false: every product and sum rounds on its own, as in the plain
# version — the knife-edge gates (w > 1e-4, w_b > 0.01, the edge side)
# flip a whole pixel on a last-ulp difference
_KERNEL = KernelLibrary("nr", extra_flags=("--fmad=false",))


def _smoothstep_f(e0: float, e1: float, x: float) -> float:
    t = min(max((x - e0) / (e1 - e0), 0.0), 1.0)
    return t * t * (3.0 - 2.0 * t)


def nr_static_meta(luma_a: float, color_a: float, scale: float) -> dict:
    """Static tap grids and gate constants (JAX `_nr_static_meta`):
    24 (dx, dy, spatial weight) luma taps and 24 chroma taps."""
    res_factor = float(min(max(scale**0.5, 0.5), 2.0))
    l_curve = math.sqrt(luma_a)
    stride_f = (1.0 + _smoothstep_f(0.45, 0.95, luma_a)) * res_factor
    extra = min(max(stride_f - 1.0, 0.0), 1.0)
    c_curve = math.sqrt(color_a)
    c_stride = (2.0 + 1.5 * c_curve) * res_factor
    luma_taps = []
    for dx, dy in _OFFSETS:
        ring = max(abs(dx), abs(dy))
        grow = 1.0 + extra * (1.0 if ring == 2 else 0.5)
        l_spatial = 1.0 + 0.5 * l_curve
        l_spat_n = -1.0 / max(2.0 * l_spatial * l_spatial, 1e-6)
        luma_taps.append(
            (int(round(dx * grow)), int(round(dy * grow)),
             math.exp(float(dx * dx + dy * dy) * l_spat_n))
        )
    chroma_taps = []
    c_spatial = 2.0 + 1.5 * c_curve
    c_spat_n = -1.0 / max(2.0 * c_spatial * c_spatial, 1e-6)
    for dx, dy in _OFFSETS:
        chroma_taps.append(
            (int(round(dx * c_stride)), int(round(dy * c_stride)),
             math.exp(float(dx * dx + dy * dy) * c_spat_n))
        )
    return {
        "l_curve": l_curve,
        "c_curve": c_curve,
        "luma_taps": luma_taps,
        "chroma_taps": chroma_taps,
    }


def _consts(luma_a: float, color_a: float, scale: float) -> dict:
    """Clipped amounts, tap tables, the largest offset and the scalar
    constants both versions use (Python doubles; float32 where JAX holds a
    float32 value)."""
    luma_a = min(max(float(luma_a), 0.0), 1.0)
    color_a = min(max(float(color_a), 0.0), 1.0)
    meta = nr_static_meta(luma_a, color_a, scale)
    luma_on, color_on = luma_a > 0.001, color_a > 0.001
    offs = []
    if luma_on:
        offs += [abs(o) for t in meta["luma_taps"] for o in t[:2]]
    if color_on:
        offs += [abs(o) for t in meta["chroma_taps"] for o in t[:2]]
    max_off = max(offs) if offs else 0
    assert max_off <= NR_HALO, f"NR tap offset {max_off} exceeds halo {NR_HALO}"
    l_curve, c_curve = meta["l_curve"], meta["c_curve"]
    luma_tol = 0.12 + (0.04 - 0.12) * c_curve
    chroma_tol = 0.20 + (0.08 - 0.20) * c_curve
    ca32 = np.float32(color_a)
    return dict(
        meta, luma_a=luma_a, color_a=color_a, luma_on=luma_on, color_on=color_on,
        max_off=max_off,
        tol_flat=mix(0.025, 0.075, l_curve), tol_edge=mix(0.010, 0.025, l_curve),
        luma_n=-1.0 / max(2.0 * luma_tol * luma_tol, 1e-6),
        chroma_n=-1.0 / max(2.0 * chroma_tol * chroma_tol, 1e-6),
        # JAX mixes with color_a as a float32 array: 1 - ca rounds in f32
        ca32=float(ca32), one_minus_ca32=float(np.float32(1.0) - ca32),
    )


def nr_planes(input_rgb: torch.Tensor, is_raw: bool) -> torch.Tensor:
    """(..., 3, H, W) neighbour planes: luma, R-Y and B-Y of the linearized
    original input (JAX nr.py:771-775)."""
    lin = input_rgb if is_raw else cs.srgb_to_linear(input_rgb)
    lin = lin.movedim(-3, 0)
    n_luma = luma(torch.clamp_min(lin, 0.0))
    return torch.stack([n_luma, lin[0] - n_luma, lin[2] - n_luma], dim=-3)


def _nr_one(center: torch.Tensor, planes: torch.Tensor, k: dict) -> torch.Tensor:
    """The Pallas kernel body at float32 on one (3, H, W) image."""
    _, h, w = center.shape
    pad = max(k["max_off"], 1)
    padded = F.pad(planes[None], (pad, pad, pad, pad), mode="replicate")[0]

    def tap(plane: int, dx: int, dy: int) -> torch.Tensor:
        return padded[plane, pad + dy : pad + dy + h, pad + dx : pad + dx + w]

    center_luma = luma(torch.clamp_min(center, 0.0))
    new_luma = center_luma
    if k["luma_on"]:
        lt = k["luma_taps"]
        lmin = center_luma
        lmax = center_luma
        for dx, dy, _spat in lt:
            s = tap(0, dx, dy)
            lmin = torch.minimum(lmin, s)
            lmax = torch.maximum(lmax, s)
        edge_strength = smoothstep(0.04, 0.20, lmax - lmin)
        edge_midpoint = (lmin + lmax) * 0.5
        center_side = center_luma > edge_midpoint
        l_range_tol = mix(k["tol_flat"], k["tol_edge"], edge_strength)
        g_e0 = l_range_tol * 0.6
        g_inv = torch.reciprocal(l_range_tol * 0.4)
        # mix(1, side_eq, es) is (1 - es) + g * es: select between the two
        g_ne = 1.0 - edge_strength
        g_eq = g_ne + edge_strength

        # pass A: gated mean; each tap's gate, pre-masked at 1e-4, is kept
        # for pass B (the centre tap's gate is exactly g_eq)
        sum_a = center_luma * g_eq
        w_a = g_eq
        gates = []
        for dx, dy, spat in lt:
            s = tap(0, dx, dy)
            diff = torch.abs(s - center_luma)
            t = torch.clamp((diff - g_e0) * g_inv, 0.0, 1.0)
            g_range = 1.0 - t * t * (3.0 - 2.0 * t)
            g_edge = torch.where((s > edge_midpoint) == center_side, g_eq, g_ne)
            wgt = spat * g_range * g_edge
            gates.append(torch.where(wgt > 0.0001, wgt, 0.0))
            sum_a = sum_a + s * wgt
            w_a = w_a + wgt
        initial_mean = sum_a / torch.clamp_min(w_a, 1e-4)

        # pass B: bisquare-robust mean around the gated mean
        inv_outlier = torch.reciprocal(mix(0.07, 0.025, edge_strength))

        def bisq2(s):
            r = torch.abs(s - initial_mean) * inv_outlier
            bisq = torch.clamp_min(1.0 - r * r, 0.0)
            return bisq * bisq

        w_c0 = torch.where(g_eq > 0.0001, g_eq, 0.0) * bisq2(center_luma)
        sum_b = center_luma * w_c0
        w_b = w_c0
        for (dx, dy, _spat), gate in zip(lt, gates):
            s = tap(0, dx, dy)
            wgt = gate * bisq2(s)
            sum_b = sum_b + s * wgt
            w_b = w_b + wgt
        robust = torch.where(w_b > 0.01, sum_b / torch.clamp_min(w_b, 1e-6), initial_mean)
        strength = k["luma_a"] * mix(1.0, 0.6, edge_strength)
        new_luma = mix(center_luma, robust, strength)

    cr = center[0] - center_luma
    cg = center[1] - center_luma
    cb = center[2] - center_luma
    if k["color_on"]:
        ln, cn = k["luma_n"], k["chroma_n"]
        sum_r = cr
        sum_bv = cb
        w_sum = torch.ones_like(cr)
        for dx, dy, w_s in k["chroma_taps"]:
            s_luma, s_r_y, s_b_y = tap(0, dx, dy), tap(1, dx, dy), tap(2, dx, dy)
            dl = s_luma - center_luma
            dr = s_r_y - cr
            db = s_b_y - cb
            # one exp for both gates: exp(a) * exp(b) == exp(a + b)
            wgt = w_s * torch.exp(dl * dl * ln + (dr * dr + db * db) * cn)
            sum_r = sum_r + s_r_y * wgt
            sum_bv = sum_bv + s_b_y * wgt
            w_sum = w_sum + wgt
        inv_w = torch.reciprocal(torch.clamp_min(w_sum, 1e-6))
        cr = cr * k["one_minus_ca32"] + (sum_r * inv_w) * k["ca32"]
        cb = cb * k["one_minus_ca32"] + (sum_bv * inv_w) * k["ca32"]
        cg = -(LUMA_COEFF[0] * cr + LUMA_COEFF[2] * cb) / LUMA_COEFF[1]
    return torch.stack([new_luma + cr, new_luma + cg, new_luma + cb])


def _check(center: torch.Tensor, planes: torch.Tensor) -> None:
    if center.ndim not in (3, 4) or center.shape[-3] != 3:
        raise ValueError(f"NR takes (3, H, W) or (B, 3, H, W) images, got {tuple(center.shape)}")
    if planes.shape != center.shape:
        raise ValueError(f"NR planes shape {tuple(planes.shape)} != image {tuple(center.shape)}")
    if center.dtype != torch.float32 or planes.dtype != torch.float32:
        raise ValueError("NR takes float32 tensors")


def nr_static_plain(center: torch.Tensor, planes: torch.Tensor, luma_a: float,
                    color_a: float, scale: float) -> torch.Tensor:
    """Plain version of the NR kernel: center (..., 3, H, W) linear pixels,
    planes (..., 3, H, W) from `nr_planes`."""
    _check(center, planes)
    k = _consts(luma_a, color_a, scale)
    if center.ndim == 3:
        return _nr_one(center, planes, k)
    return torch.stack([_nr_one(c, p, k) for c, p in zip(center, planes)])


# The kernel's launch shape (csrc/nr.cu): 32 x 8 threads per block, each
# thread `NR_ROWS` output rows of one column, so a block owns a 32 x 32 tile.
NR_BLOCK = (32, 8)
NR_ROWS = 4
NR_SMEM_LIMIT = 48 * 1024  # the default dynamic shared-memory limit


def nr_launch_plan(b: int, h: int, w: int, halo: int) -> dict:
    """The NR kernel's launch on a (b, 3, h, w) batch: grid, rows per
    thread, tile, staged tile (tile plus `halo` on every side, three planes)
    and its shared-memory bytes. rr_nr_static refuses a plan whose grid
    leaves a pixel out or whose staged tile passes `NR_SMEM_LIMIT`."""
    bx, by = NR_BLOCK
    tile_h, tile_w = by * NR_ROWS, bx
    stage_h, stage_w = tile_h + 2 * halo, tile_w + 2 * halo
    return {
        "block": NR_BLOCK, "rows": NR_ROWS, "tile": (tile_h, tile_w), "halo": halo,
        "stage": (stage_h, stage_w), "smem": 3 * stage_h * stage_w * 4,
        "grid": (-(-w // tile_w), -(-h // tile_h), b),
    }


class _Taps(ctypes.Structure):
    _fields_ = [(n, t * NTAPS) for n, t in (
        ("loff", ctypes.c_int), ("lsp", ctypes.c_float),
        ("coff", ctypes.c_int), ("csp", ctypes.c_float))]


def _nr_cuda(center: torch.Tensor, planes: torch.Tensor, k: dict) -> torch.Tensor:
    for name, t in (("image", center), ("planes", planes)):
        if not t.is_contiguous():
            raise ValueError(f"NR kernel: {name} must be contiguous")
        if t.device != center.device:
            raise ValueError(f"NR kernel: {name} must be on {center.device}")
    b = center.shape[0] if center.ndim == 4 else 1
    h, w = center.shape[-2:]
    plan = nr_launch_plan(b, h, w, max(k["max_off"], 1))
    sw = plan["stage"][1]
    out = torch.empty_like(center)
    taps = _Taps()
    for i, ((ldx, ldy, lsp), (cdx, cdy, csp)) in enumerate(zip(k["luma_taps"], k["chroma_taps"])):
        taps.loff[i], taps.lsp[i] = ldy * sw + ldx, lsp
        taps.coff[i], taps.csp[i] = cdy * sw + cdx, csp
    fn = _KERNEL.lib().rr_nr_static
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(_Taps)] + [ctypes.c_int] * 6
        + [ctypes.c_size_t] + [ctypes.c_int] * 3 + [ctypes.c_float] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(center.device).cuda_stream
    gx, gy, _ = plan["grid"]
    status = fn(
        center.data_ptr(), planes.data_ptr(), out.data_ptr(), ctypes.byref(taps),
        int(k["luma_on"]), int(k["color_on"]), plan["halo"], plan["rows"], gx, gy,
        plan["smem"], b, h, w,
        k["luma_a"], k["tol_flat"], k["tol_edge"], k["luma_n"], k["chroma_n"],
        k["ca32"], k["one_minus_ca32"], stream,
    )
    _KERNEL.check(status, "rr_nr_static")
    nr_static.launches += 1
    return out


def nr_static(center: torch.Tensor, planes: torch.Tensor, luma_a: float,
              color_a: float, scale: float) -> torch.Tensor:
    """Static-grid NR of (3, H, W) or (B, 3, H, W): the kernel wrapper.

    CPU tensor -> `nr_static_plain`; CUDA tensor -> one launch of
    csrc/nr.cu for the whole batch.
    """
    _check(center, planes)
    if center.device.type == "cpu":
        return nr_static_plain(center, planes, luma_a, color_a, scale)
    if center.device.type != "cuda":
        raise ValueError(f"NR runs on CPU or CUDA tensors, got {center.device}")
    return _nr_cuda(center, planes, _consts(luma_a, color_a, scale))


# launch count of the NR kernel: one per rr_nr_static call
nr_static.launches = 0


def _nr_dynamic_one(center: torch.Tensor, planes: torch.Tensor, luma_amount, color_amount,
                    scale: float, tile_offset=(0, 0)) -> torch.Tensor:
    """JAX's per-pixel gather path (nr.py:108-254) on one (3, H, W) image:
    amounts 0-d or (H, W), taps hash-jittered per pixel (the hash reads
    absolute coordinates: the tile's origin `tile_offset` added), gathered
    from the neighbour planes with the indices clamped to the image."""
    _, h, w = center.shape
    luma_a = torch.clamp(as_t(luma_amount, center), 0.0, 1.0)
    color_a = torch.clamp(as_t(color_amount, center), 0.0, 1.0)
    flat = planes.reshape(3, -1)
    center_luma = luma(torch.clamp_min(center, 0.0))
    center_chroma = center - center_luma
    res_factor = float(min(max(scale**0.5, 0.5), 2.0))
    xs, ys = coord_maps(h, w, center.device)
    xi, yi = xs.to(torch.int64), ys.to(torch.int64)
    # hash coordinates are absolute (JAX nr.py:130-133); the gather stays local
    xs, ys = coord_maps(h, w, center.device, tile_offset)

    def index(dx: int, dy: int, stride, jx, jy) -> torch.Tensor:
        off_x = torch.round(dx * stride + jx).to(torch.int64)
        off_y = torch.round(dy * stride + jy).to(torch.int64)
        return torch.clamp(yi + off_y, 0, h - 1) * w + torch.clamp(xi + off_x, 0, w - 1)

    # ---- luma pass
    l_curve = sqrt_rn(luma_a)
    stride_f = mix(1.0, 2.0, smoothstep(0.45, 0.95, luma_a)) * res_factor
    extra = torch.clamp(stride_f - 1.0, 0.0, 1.0)
    l_spatial = mix(1.0, 1.5, l_curve)
    l_spat_n = -1.0 / torch.clamp_min(2.0 * l_spatial * l_spatial, 1e-6)
    jx = (hash2(xs, ys) - 0.5) * 2.0 * extra
    jy = (hash2(xs + 17.31, ys + 71.13) - 0.5) * 2.0 * extra

    samp_luma = [center_luma]
    samp_spat = [torch.ones_like(center_luma)]
    lmin = lmax = center_luma
    for dx, dy in _OFFSETS:
        grow = 1.0 + extra * (1.0 if max(abs(dx), abs(dy)) == 2 else 0.5)
        s_luma = flat[0][index(dx, dy, grow, jx, jy)]
        samp_luma.append(s_luma)
        samp_spat.append(torch.exp(float(dx * dx + dy * dy) * l_spat_n))
        lmin = torch.minimum(lmin, s_luma)
        lmax = torch.maximum(lmax, s_luma)
    edge_strength = smoothstep(0.04, 0.20, lmax - lmin)
    edge_midpoint = (lmin + lmax) * 0.5
    center_side = center_luma > edge_midpoint
    l_range_tol = mix(mix(0.025, 0.075, l_curve), mix(0.010, 0.025, l_curve), edge_strength)

    sum_a = torch.zeros_like(center_luma)
    w_a = torch.zeros_like(center_luma)
    gates = []
    for s_luma, s_spat in zip(samp_luma, samp_spat):
        diff = torch.abs(s_luma - center_luma)
        g_range = 1.0 - smoothstep(l_range_tol * 0.6, l_range_tol, diff)
        g_side = torch.where((s_luma > edge_midpoint) == center_side, 1.0, 0.0)
        g_edge = mix(1.0, g_side, edge_strength)
        wgt = s_spat * g_range * g_edge
        gates.append(wgt)
        sum_a = sum_a + s_luma * wgt
        w_a = w_a + wgt
    initial_mean = sum_a / torch.clamp_min(w_a, 1e-4)

    outlier_tol = mix(0.07, 0.025, edge_strength)
    sum_b = torch.zeros_like(center_luma)
    w_b = torch.zeros_like(center_luma)
    for s_luma, init_w in zip(samp_luma, gates):
        r = torch.abs(s_luma - initial_mean) / outlier_tol
        bisq = torch.clamp_min(1.0 - r * r, 0.0)
        wgt = torch.where(init_w > 0.0001, init_w * bisq * bisq, 0.0)
        sum_b = sum_b + s_luma * wgt
        w_b = w_b + wgt
    robust = torch.where(w_b > 0.01, sum_b / torch.clamp_min(w_b, 1e-6), initial_mean)
    strength = luma_a * mix(1.0, 0.6, edge_strength)
    new_luma = torch.where(luma_a > 0.001, mix(center_luma, robust, strength), center_luma)

    # ---- colour pass
    center_r_y = center[0] - center_luma
    center_b_y = center[2] - center_luma
    c_curve = sqrt_rn(color_a)
    c_stride = mix(2.0, 3.5, c_curve) * res_factor
    c_spatial = mix(2.0, 3.5, c_curve)
    c_spat_n = -1.0 / torch.clamp_min(2.0 * c_spatial * c_spatial, 1e-6)
    luma_tol = mix(0.12, 0.04, c_curve)
    luma_n = -1.0 / torch.clamp_min(2.0 * luma_tol * luma_tol, 1e-6)
    chroma_tol = mix(0.20, 0.08, c_curve)
    chroma_n = -1.0 / torch.clamp_min(2.0 * chroma_tol * chroma_tol, 1e-6)
    cjx = (hash2(xs + 43.7, ys + 91.1) - 0.5) * c_stride * 0.5
    cjy = (hash2(xs + 73.3, ys + 17.9) - 0.5) * c_stride * 0.5

    sum_r = center_r_y
    sum_bv = center_b_y
    w_sum = torch.ones_like(center_r_y)
    for dx, dy in _OFFSETS:
        s_luma, s_r_y, s_b_y = flat[:, index(dx, dy, c_stride, cjx, cjy)]
        w_s = torch.exp(float(dx * dx + dy * dy) * c_spat_n)
        dl = s_luma - center_luma
        w_l = torch.exp(dl * dl * luma_n)
        dr = s_r_y - center_r_y
        db = s_b_y - center_b_y
        w_c = torch.exp((dr * dr + db * db) * chroma_n)
        wgt = w_s * w_l * w_c
        sum_r = sum_r + s_r_y * wgt
        sum_bv = sum_bv + s_b_y * wgt
        w_sum = w_sum + wgt
    new_r_y = mix(center_r_y, sum_r / torch.clamp_min(w_sum, 1e-6), color_a)
    new_b_y = mix(center_b_y, sum_bv / torch.clamp_min(w_sum, 1e-6), color_a)
    new_g_y = -(LUMA_COEFF[0] * new_r_y + LUMA_COEFF[2] * new_b_y) / LUMA_COEFF[1]
    new_chroma = torch.where(color_a > 0.001, torch.stack([new_r_y, new_g_y, new_b_y]),
                             center_chroma)
    out = new_luma + new_chroma
    skip = (luma_a < 0.001) & (color_a < 0.001)
    return torch.where(skip, center, out)


def _amounts(a, b: int, h: int, w: int, device) -> torch.Tensor:
    """An NR amount of a (B, 3, H, W) batch as (B,) per-image scalars or
    (B, H, W) maps, float32 on `device`."""
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    if t.ndim == 0:
        t = t.expand(b)
    if tuple(t.shape) not in ((b,), (b, h, w)):
        raise ValueError(f"NR amount shape {tuple(t.shape)}: want ({b},) or ({b}, {h}, {w})")
    return t.contiguous()


def nr_dynamic_plain(center: torch.Tensor, planes: torch.Tensor, luma_amount, color_amount,
                     scale: float, tile_offset=(0, 0)) -> torch.Tensor:
    """Plain version of the per-pixel NR kernel: center (B, 3, H, W) linear
    pixels, planes (B, 3, H, W) from `nr_planes`, amounts (B,) per image
    or (B, H, W) per pixel (for a (3, H, W) image: 0-d or (H, W));
    `tile_offset` the (x, y) origin of a tile in its image."""
    _check(center, planes)
    if center.ndim == 3:
        return _nr_dynamic_one(center, planes, luma_amount, color_amount, scale, tile_offset)
    b, _, h, w = center.shape
    la = _amounts(luma_amount, b, h, w, center.device)
    ca = _amounts(color_amount, b, h, w, center.device)
    return torch.stack([_nr_dynamic_one(c, p, la[i], ca[i], scale, tile_offset)
                        for i, (c, p) in enumerate(zip(center, planes))])


def _nr_dynamic_cuda(center: torch.Tensor, planes: torch.Tensor, luma_amount, color_amount,
                     scale: float, tile_offset) -> torch.Tensor:
    one = center.ndim == 3
    if one:
        center, planes = center[None], planes[None]
        luma_amount, color_amount = (torch.as_tensor(a)[None] for a in (luma_amount,
                                                                        color_amount))
    b, _, h, w = center.shape
    la = _amounts(luma_amount, b, h, w, center.device)
    ca = _amounts(color_amount, b, h, w, center.device)
    for name, t in (("image", center), ("planes", planes)):
        if not t.is_contiguous():
            raise ValueError(f"NR kernel: {name} must be contiguous")
        if t.device != center.device:
            raise ValueError(f"NR kernel: {name} must be on {center.device}")
    plan = nr_launch_plan(b, h, w, NR_HALO)
    out = torch.empty_like(center)
    fn = _KERNEL.lib().rr_nr_dynamic
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_size_t]
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(center.device).cuda_stream
    gx, gy, _ = plan["grid"]
    status = fn(
        center.data_ptr(), planes.data_ptr(), la.data_ptr(), ca.data_ptr(), out.data_ptr(),
        int(la.ndim == 3), int(ca.ndim == 3), plan["halo"], plan["rows"], gx, gy,
        plan["smem"], b, h, w, *tile_offset, float(min(max(scale**0.5, 0.5), 2.0)), stream,
    )
    _KERNEL.check(status, "rr_nr_dynamic")
    nr_dynamic.launches += 1
    return out[0] if one else out


def nr_dynamic(center: torch.Tensor, planes: torch.Tensor, luma_amount, color_amount,
               scale: float, tile_offset=(0, 0)) -> torch.Tensor:
    """NR with per-pixel amounts and hash-jittered taps of (3, H, W) or
    (B, 3, H, W): the kernel wrapper. Amounts: per image ((B,) or a float)
    or per pixel ((B, H, W)). `scale` is the full image's resolution scale;
    a tile of a larger image gives its origin `tile_offset` (x, y), which
    the jitter's hash coordinates add (JAX nr.py:131-133).

    CPU tensor -> `nr_dynamic_plain`; CUDA tensor -> one launch of
    csrc/nr.cu's `rr_nr_dynamic` for the whole batch.
    """
    _check(center, planes)
    x_off, y_off = (int(v) for v in tile_offset)
    if x_off < 0 or y_off < 0 or max(x_off + center.shape[-1],
                                     y_off + center.shape[-2]) > 1 << 24:
        raise ValueError(f"NR: tile offset {tuple(tile_offset)} outside [0, 2^24)")
    if center.device.type == "cpu":
        return nr_dynamic_plain(center, planes, luma_amount, color_amount, scale,
                                (x_off, y_off))
    if center.device.type != "cuda":
        raise ValueError(f"NR runs on CPU or CUDA tensors, got {center.device}")
    return _nr_dynamic_cuda(center, planes, luma_amount, color_amount, scale, (x_off, y_off))


# launch count of the per-pixel NR kernel: one per rr_nr_dynamic call
nr_dynamic.launches = 0


def apply_noise_reduction(center_linear: torch.Tensor, input_rgb: torch.Tensor,
                          scale: float, is_raw: bool, static_luma: float | None,
                          static_color: float | None, luma_amount=None,
                          color_amount=None, tile_offset=(0, 0)) -> torch.Tensor:
    """NR of (..., 3, H, W) linear pixels, neighbours from the input-space
    `input_rgb`, routed as JAX routes it (nr.py:73-108): document-static
    amounts (both `static_*` set) take the static grid; otherwise the
    per-pixel path takes `luma_amount` / `color_amount`, per image or per
    pixel. The static grid reads no coordinate; the per-pixel path's
    jitter takes a tile's origin `tile_offset`."""
    planes = nr_planes(input_rgb, is_raw).contiguous()
    if static_luma is not None and static_color is not None:
        return nr_static(center_linear.contiguous(), planes, static_luma, static_color, scale)
    if luma_amount is None or color_amount is None:
        raise ValueError("NR with per-pixel amounts takes luma_amount and color_amount")
    return nr_dynamic(center_linear.contiguous(), planes, luma_amount, color_amount, scale,
                      tile_offset)
