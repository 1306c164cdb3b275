"""Lens flare: the 512 x 512 flare map and its sample at each pixel.

Port of `rapidraw_tpu/ops/flare.py` (flare.wgsl): a soft-knee bright-pass
of the image (`flare_threshold_map`) feeds a composite (`generate_flare_map`)
of a 6-spike starburst, an inner burst, a radial glow, iris rings, 7
inverted-UV ghosts, 3 halos and a 64-tap anamorphic streak, each tap a
bilinear sample of the threshold map. The map is a fixed 512^2
(gpu_processing.rs:552); the grade samples it back at each pixel
(`sample_flare`, JAX develop.py:36-67 and :198-217; in the grade kernel,
csrc/grade.cu, per pixel).

Every tap's offset, falloff and weight is a Python float (double) in JAX,
rounded once to float32 where it meets a float32 array; `flare_taps` makes
that table once per aspect ratio, and both the plain version and the
kernel read it.

`flare_maps` is the kernel wrapper: a CPU tensor runs the plain version
image by image, a CUDA tensor launches csrc/flare.cu (threshold pass, then
composite pass) for the whole batch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.common import (
    as_t, coord_maps, luma, mix, smoothstep, sqrt_rn, true_div,
)

FLARE_MAP_SIZE = 512
# the global params a flare map is made from, in the order the kernel reads
# them from each image's row of the (B, 4) matrix
FLARE_PARAMS = ("flare", "exposure", "brightness", "whites")

_KERNEL = KernelLibrary("flare", extra_flags=("--fmad=false",))

# starburst / inner burst / glow / streak geometry (flare.wgsl:137-407)
_ROT = 0.5236
_SPREAD = 0.01
N_SPIKES = 6
N_STAR = 24
N_INNER = 16
N_RINGS = 3
N_RING_TAPS = 12
N_STREAK = 64
_IRIS = ((0.15, 0.02, 0.4), (0.25, 0.025, 0.3), (0.35, 0.03, 0.2), (0.48, 0.035, 0.15))
# (inverted uv, scale, vignette edges, tint, mult, gated by the strict bounds)
_GHOSTS = (
    (True, 0.75, (0.15, 0.6), (1.0, 0.92, 0.85), 0.05, False),
    (True, 0.4, (0.1, 0.45), (0.92, 1.0, 0.95), 0.07, False),
    (True, 0.2, (0.08, 0.35), (0.95, 0.97, 1.0), 0.08, False),
    (True, 0.12, (0.05, 0.25), (1.0, 1.0, 0.97), 0.07, False),
    (False, 1.8, (0.25, 0.75), (0.85, 0.9, 1.0), 0.03, True),
    (True, 1.3, (0.2, 0.55), (1.0, 0.9, 0.95), 0.03, True),
    (True, 0.55, (0.2, 0.5), (0.97, 0.95, 1.0), 0.04, False),
)
_HALOS = (
    (0.4, 0.05, (0.85, 0.92, 1.0), 0.07),
    (0.22, 0.035, (0.92, 0.88, 1.0), 0.05),
    (0.55, 0.06, (0.85, 0.95, 0.97), 0.03),
)
_TINT_STAR = (1.0, 0.95, 0.85)
_TINT_INNER = (1.0, 0.9, 0.8)
_TINT_GLOW = (1.0, 0.95, 0.9)
_TINT_IRIS = (0.7, 0.8, 1.0)
_TINT_STREAK = (0.85, 0.92, 1.0)


def _spike_dirs(aspect: float):
    """Unit direction of each spike, the x axis divided by the aspect."""
    out = []
    for spike in range(N_SPIKES):
        angle = spike * np.pi / 6 + _ROT
        dx, dy = np.cos(angle), np.sin(angle)
        dx /= aspect
        norm = np.hypot(dx, dy)
        out.append((dx / norm, dy / norm))
    return out


@functools.lru_cache(maxsize=16)
def flare_taps(aspect: float) -> dict:
    """Every tap's constants as JAX computes them, in double.

    star: (spike, i, sign) -> (green dx, green dy, red dx, red dy, blue dx,
    blue dy, falloff); inner: (spike, i, sign) -> (dx, dy, falloff); glow:
    (ring, tap) -> (dx, dy, weight); streak: tap -> (green du, red du,
    blue du, weight), and its weight total.
    """
    dirs = _spike_dirs(aspect)
    star, inner = [], []
    for dx, dy in dirs:
        for i in range(1, N_STAR + 1):
            t = i / 24.0
            dist = t * t * 0.65
            falloff = float(np.exp(-dist * 2.5) + 0.4 * np.exp(-dist * 0.8))
            for sgn in (1.0, -1.0):
                star.append((sgn * dx * dist, sgn * dy * dist,
                             sgn * dx * dist * (1.0 + _SPREAD), sgn * dy * dist * (1.0 + _SPREAD),
                             sgn * dx * dist * (1.0 - _SPREAD), sgn * dy * dist * (1.0 - _SPREAD),
                             falloff))
        for i in range(1, N_INNER + 1):
            dist = (i / 16.0) * 0.2
            falloff = float(np.exp(-dist * 8.0))
            for sgn in (1.0, -1.0):
                inner.append((sgn * dx * dist, sgn * dy * dist, falloff))
    glow = []
    for ring in range(1, N_RINGS + 1):
        radius = ring / 3.0 * 0.08
        ring_weight = float(np.exp(-radius * radius * 200.0))
        for s in range(N_RING_TAPS):
            angle = s * 6.28318 / 12.0 + ring * 0.5
            glow.append((np.cos(angle) * radius / aspect, np.sin(angle) * radius, ring_weight))
    streak_len = 0.4 / aspect
    streak, total_w = [], 0.0
    for i in range(N_STREAK):
        t = (i / 63.0) * 2.0 - 1.0
        offset = t * streak_len
        weight = float(np.exp(-t * t * 3.5))
        total_w += weight
        streak.append((offset, offset * 1.015, offset * 0.985, weight))
    return {"star": tuple(tuple(map(float, r)) for r in star),
            "inner": tuple(tuple(map(float, r)) for r in inner),
            "glow": tuple(tuple(map(float, r)) for r in glow),
            "streak": tuple(streak), "total_w": total_w}


def _filmic_exposure_flare(rgb: torch.Tensor, brightness) -> torch.Tensor:
    """flare.wgsl:37-61, the simpler variant of the develop chain's."""
    brightness = as_t(brightness, rgb)
    original_luma = luma(rgb)
    direct = brightness * 0.05
    rational = brightness * 0.95
    scale = torch.exp2(direct)
    k = torch.exp2(-rational * 1.2)
    la = torch.abs(original_luma)
    lf = torch.floor(la)
    fr = la - lf
    shaped = fr / (fr + (1.0 - fr) * k)
    new_luma = torch.sign(original_luma) * (lf + shaped) * scale
    chroma = rgb - original_luma
    safe = torch.where(torch.abs(original_luma) < 1e-20, 1.0, original_luma)
    chroma_scale = torch.pow(torch.clamp_min(new_luma / safe, 0.0), 0.8)
    out = new_luma + chroma * chroma_scale
    skip = (brightness == 0.0) | (torch.abs(original_luma) < 0.00001)
    return torch.where(skip, rgb, out)


def _bilinear_uv(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 ch: int | None = None) -> torch.Tensor:
    """Clamped bilinear sample of planar (3, H, W) at uv in [0, 1]
    (flare.wgsl:121-135): (3, ...) or, given `ch`, that channel's (...)."""
    _, h, w = tex.shape
    uc = torch.clamp(u, 0.0, 1.0)
    vc = torch.clamp(v, 0.0, 1.0)
    x = uc * w - 0.5
    y = vc * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    yi0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    xi1 = torch.clamp(xi0 + 1, 0, w - 1)
    yi1 = torch.clamp(yi0 + 1, 0, h - 1)
    flat = tex.reshape(3, -1) if ch is None else tex[ch].reshape(-1)

    def g(yy, xx):
        return flat[..., yy * w + xx]

    top = mix(g(yi0, xi0), g(yi0, xi1), fx)
    bot = mix(g(yi1, xi0), g(yi1, xi1), fx)
    return mix(top, bot, fy)


def _map_uv(device) -> tuple[torch.Tensor, torch.Tensor]:
    n = FLARE_MAP_SIZE
    uv = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    return uv[None, :].expand(n, n), uv[:, None].expand(n, n)


def flare_threshold_map(image: torch.Tensor, amount, exposure, brightness, whites,
                        is_raw: bool) -> torch.Tensor:
    """Soft-knee bright extraction at 512^2 (flare.wgsl:73-116): (3, 512, 512)."""
    u, v = _map_uv(image.device)
    raw_sample = _bilinear_uv(image, u, v)
    exposure, whites, amount = (as_t(x, image) for x in (exposure, whites, amount))
    lin = raw_sample if is_raw else cs.srgb_to_linear(raw_sample)
    lin = torch.where(exposure != 0.0, lin * torch.exp2(exposure), lin)
    lin = _filmic_exposure_flare(lin, brightness)
    white_level = 1.0 - whites * 0.25
    lin = torch.where(whites != 0.0, lin / torch.clamp_min(white_level, 0.01), lin)

    true_luma = luma(lin)
    lt = torch.clamp_max(true_luma, 1.0)
    threshold = mix(0.88, 0.50, torch.clamp(amount, 0.0, 1.0))
    knee = 0.15
    x = lt - threshold + knee
    contrib = torch.where(
        x <= 0.0, 0.0, torch.where(x < knee * 2.0, (x * x) / (knee * 4.0), x - knee))
    return lin * (contrib / torch.clamp_min(true_luma, 0.001))


def _tint(t, ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(t, dtype=torch.float32, device=ref.device).reshape(3, 1, 1)


def generate_flare_map(image: torch.Tensor, amount, exposure, brightness, whites,
                       is_raw: bool) -> torch.Tensor:
    """The flare map of one (3, H, W) image: (512, 512, 3), as the develop
    chain samples it. Plain PyTorch, one op per JAX op."""
    _, h, w = image.shape
    aspect = w / h  # FlareParams.aspect_ratio
    taps = flare_taps(aspect)
    thr = flare_threshold_map(image, amount, exposure, brightness, whites, is_raw)
    u, v = _map_uv(image.device)
    fu = 1.0 - u
    fv = 1.0 - v

    def sample(uu, vv, ch=None):
        return _bilinear_uv(thr, uu, vv, ch)

    def in_bounds(uu, vv):
        return (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (vv <= 1.0)

    # ---- 6-spike starburst (:137-192)
    per_spike = 2 * N_STAR
    star = torch.zeros((3,) + u.shape, device=u.device)
    for spike in range(N_SPIKES):
        acc = torch.zeros_like(star)
        wsum = torch.zeros_like(u)
        for gx, gy, rx, ry, bx, by, falloff in taps["star"][spike * per_spike:
                                                            (spike + 1) * per_spike]:
            uu, vv = u + gx, v + gy
            ok = in_bounds(uu, vv)
            tap = torch.stack([sample(u + rx, v + ry, 0), sample(uu, vv, 1),
                               sample(u + bx, v + by, 2)])
            acc = acc + torch.where(ok, tap * falloff, 0.0)
            wsum = wsum + torch.where(ok, falloff, 0.0)
        star = star + torch.where(wsum > 0.0, acc / torch.clamp_min(wsum, 1e-9), 0.0)
    star = star / 6.0 * 3.0
    flare = star * _tint(_TINT_STAR, u) * 3.5

    # ---- inner starburst (:194-235)
    per_spike = 2 * N_INNER
    inner = torch.zeros_like(star)
    for spike in range(N_SPIKES):
        acc = torch.zeros_like(star)
        wsum = torch.zeros_like(u)
        for dx, dy, falloff in taps["inner"][spike * per_spike:(spike + 1) * per_spike]:
            uu, vv = u + dx, v + dy
            ok = in_bounds(uu, vv)
            acc = acc + torch.where(ok, sample(uu, vv) * falloff, 0.0)
            wsum = wsum + torch.where(ok, falloff, 0.0)
        inner = inner + torch.where(wsum > 0.0, acc / torch.clamp_min(wsum, 1e-9), 0.0)
    inner = inner / 6.0 * 2.0
    flare = flare + inner * _tint(_TINT_INNER, u) * 1.5

    # ---- radial glow (:237-267)
    glow = sample(u, v) * 2.0
    gw = torch.full_like(u, 2.0)
    for ox, oy, ring_weight in taps["glow"]:
        uu, vv = u + ox, v + oy
        ok = in_bounds(uu, vv)
        glow = glow + torch.where(ok, sample(uu, vv) * ring_weight, 0.0)
        gw = gw + torch.where(ok, ring_weight, 0.0)
    flare = flare + (glow / gw) * _tint(_TINT_GLOW, u) * 0.4

    # ---- iris rings (:269-289)
    center_dist = sqrt_rn(((u - 0.5) * aspect) ** 2 + (v - 0.5) ** 2)
    src = sample(fu, fv)
    angle = torch.atan2(v - 0.5, (u - 0.5) * aspect)
    hex_mod = 0.9 + 0.1 * torch.pow(torch.abs(torch.cos(angle * 3.0)), 4.0)
    iris = torch.zeros_like(star)
    for rr, wd, inten in _IRIS:
        ring_factor = torch.exp(-(((center_dist - rr) / wd) ** 2))
        iris = iris + src * ring_factor * inten * hex_mod
    flare = flare + iris * _tint(_TINT_IRIS, u) * 0.2

    # ---- ghosts (:315-364)
    for inverted, sc, (e0, e1), tint, mult, gated in _GHOSTS:
        gu, gv = (fu, fv) if inverted else (u, v)
        gx = 0.5 + (gu - 0.5) * sc
        gy = 0.5 + (gv - 0.5) * sc
        ghost = sample(gx, gy)
        dist = sqrt_rn(((gx - 0.5) * aspect) ** 2 + (gy - 0.5) ** 2)
        vig = 1.0 - smoothstep(e0, e1, dist)
        term = ghost * _tint(tint, u) * mult * vig
        if gated:
            ok = (gx > 0.0) & (gx < 1.0) & (gy > 0.0) & (gy < 1.0)
            term = torch.where(ok, term, 0.0)
        flare = flare + term

    # ---- halos (:366-382)
    for radius, wd, tint, mult in _HALOS:
        hf = torch.exp(-(((center_dist - radius) / wd) ** 2))
        flare = flare + src * _tint(tint, u) * hf * mult

    # ---- anamorphic streak (:384-407)
    acc = torch.zeros_like(star)
    for off, off_r, off_b, weight in taps["streak"]:
        su = u + off
        ok = (su > 0.0) & (su < 1.0)
        tap = torch.stack([sample(u + off_r, v, 0), sample(su, v, 1), sample(u + off_b, v, 2)])
        acc = acc + torch.where(ok, tap * weight, 0.0)
    streak = acc / taps["total_w"]
    flare = flare + streak * _tint(_TINT_STREAK, u) * 1.0

    out = flare * as_t(amount, u) * 1.5
    return out.movedim(0, -1).contiguous()  # (512, 512, 3): the develop chain binds a texture


def sample_flare(fmap: torch.Tensor, h: int, w: int, tile_offset=(0, 0),
                 full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """The flare contribution of each pixel of an (h, w) image from its
    (512, 512, 3) map: a clamp-to-edge bilinear sample at u = x / w,
    v = y / h (uv not clamped), times 1.4, squared (JAX develop.py:36-67,
    :207-217). For one tile of a larger image, x and y are absolute (the
    tile's `tile_offset` added) and w, h the `full_size` (w, h). Returns
    (3, h, w)."""
    ht, wt, nc = fmap.shape
    w_full, h_full = full_size if full_size is not None else (w, h)
    xs, ys = coord_maps(h, w, fmap.device, tile_offset)
    ys = true_div(ys, h_full)
    xs = true_div(xs, w_full)
    x = xs * wt - 0.5
    y = ys * ht - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = torch.clamp(x0.to(torch.int64), 0, wt - 1)
    yi0 = torch.clamp(y0.to(torch.int64), 0, ht - 1)
    xi1 = torch.clamp(xi0 + 1, 0, wt - 1)
    yi1 = torch.clamp(yi0 + 1, 0, ht - 1)
    flat = fmap.reshape(-1, nc)

    def fetch(yy, xx):
        return flat[yy * wt + xx].movedim(-1, 0)

    c00, c10 = fetch(yi0, xi0), fetch(yi0, xi1)
    c01, c11 = fetch(yi1, xi0), fetch(yi1, xi1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    flare_rgb = (top * (1.0 - fy) + bot * fy) * 1.4
    return flare_rgb * flare_rgb


def flare_maps_plain(images: torch.Tensor, fparams: torch.Tensor, is_raw: bool) -> torch.Tensor:
    """Plain version of the flare kernel: (B, 3, H, W) images and their
    (B, 4) params (FLARE_PARAMS) -> (B, 512, 512, 3) maps."""
    return torch.stack([generate_flare_map(img, *row.unbind(), is_raw)
                        for img, row in zip(images, fparams)])


def _check(images: torch.Tensor, fparams: torch.Tensor) -> None:
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"flare maps take (B, 3, H, W) images, got {tuple(images.shape)}")
    if tuple(fparams.shape) != (images.shape[0], len(FLARE_PARAMS)):
        raise ValueError(f"flare params shape {tuple(fparams.shape)}, want "
                         f"{(images.shape[0], len(FLARE_PARAMS))}")
    if images.dtype != torch.float32 or fparams.dtype != torch.float32:
        raise ValueError("flare maps take float32 tensors")


class _Taps(ctypes.Structure):
    """csrc/flare.cu's FlareTaps: every tap's float32 constants, each tap's
    row padded to 16 bytes (star 8 floats, inner and glow 4), so the kernel
    reads a tap with one or two vector loads."""

    _fields_ = [("star", ctypes.c_float * (N_SPIKES * 2 * N_STAR * 8)),
                ("inner", ctypes.c_float * (N_SPIKES * 2 * N_INNER * 4)),
                ("glow", ctypes.c_float * (N_RINGS * N_RING_TAPS * 4)),
                ("streak", ctypes.c_float * (N_STREAK * 4)),
                ("aspect", ctypes.c_float), ("total_w_inv", ctypes.c_float),
                ("pad", ctypes.c_float * 2)]


def _taps_struct(aspect: float) -> _Taps:
    taps = flare_taps(aspect)
    s = _Taps()
    for name, width in (("star", 8), ("inner", 4), ("glow", 4), ("streak", 4)):
        rows = np.asarray(taps[name], np.float64).astype(np.float32)
        padded = np.zeros((rows.shape[0], width), np.float32)
        padded[:, :rows.shape[1]] = rows
        getattr(s, name)[:] = padded.reshape(-1).tolist()
    s.aspect = aspect
    # the streak's `acc / total_w`: PyTorch's CUDA division by a Python
    # scalar multiplies by the reciprocal taken in double, rounded to f32
    s.total_w_inv = 1.0 / taps["total_w"]
    return s


@functools.lru_cache(maxsize=16)
def flare_table(aspect: float, device: torch.device) -> torch.Tensor:
    """The tap table of one aspect ratio on `device`, as the kernel reads
    it: uploaded once per aspect and device, then read by every call on any
    stream."""
    return torch.frombuffer(bytearray(_taps_struct(aspect)), dtype=torch.uint8).to(device)


# The composite kernel's launch (csrc/flare.cu): 32 x 4 threads, each making
# FLARE_ROWS map pixels of one column; the threshold map is padded by one
# texel on the right and below (repeating the last ones) to a row stride of
# FLARE_STRIDE texels.
FLARE_BLOCK = (32, 4)
FLARE_ROWS = 2
FLARE_STRIDE = FLARE_MAP_SIZE + 4


def flare_launch_plan(b: int) -> dict:
    """The flare kernels' launch on a batch of b images: the composite grid
    (FLARE_BLOCK threads, FLARE_ROWS map rows each: a block makes 32 x 8 map
    pixels) and the padded threshold map's shape, planar and as float4
    texels. rr_flare refuses rows or a grid that are not its build's."""
    n, (bx, by) = FLARE_MAP_SIZE, FLARE_BLOCK
    return {"block": FLARE_BLOCK, "rows": FLARE_ROWS,
            "grid": (n // bx, n // (by * FLARE_ROWS), b),
            "thr": (b, 3, n + 1, FLARE_STRIDE), "thr4": (b, n + 1, FLARE_STRIDE, 4)}


def _flare_cuda(images: torch.Tensor, fparams: torch.Tensor, is_raw: bool) -> torch.Tensor:
    for name, t in (("images", images), ("params", fparams)):
        if not t.is_contiguous():
            raise ValueError(f"flare kernel: {name} must be contiguous")
        if t.device != images.device:
            raise ValueError(f"flare kernel: {name} must be on {images.device}")
    b, _, h, w = images.shape
    n = FLARE_MAP_SIZE
    plan = flare_launch_plan(b)
    thr = torch.empty(plan["thr"], dtype=torch.float32, device=images.device)
    thr4 = torch.empty(plan["thr4"], dtype=torch.float32, device=images.device)
    out = torch.empty((b, n, n, 3), dtype=torch.float32, device=images.device)
    table = flare_table(w / h, images.device)
    fn = _KERNEL.lib().rr_flare
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = fn(images.data_ptr(), fparams.data_ptr(), thr.data_ptr(), thr4.data_ptr(),
                out.data_ptr(), table.data_ptr(), int(is_raw), plan["rows"], plan["grid"][1],
                b, h, w, stream)
    _KERNEL.check(status, "rr_flare")
    flare_maps.launches += 1
    return out


def flare_maps(images: torch.Tensor, fparams: torch.Tensor, is_raw: bool) -> torch.Tensor:
    """The flare maps of a (B, 3, H, W) batch in input space: the kernel
    wrapper. fparams: (B, 4) float32, each image's FLARE_PARAMS.

    CPU tensor -> `flare_maps_plain`; CUDA tensor -> one call of
    csrc/flare.cu for the whole batch (a threshold pass, then the
    composite). Returns (B, 512, 512, 3)."""
    _check(images, fparams)
    if images.device.type == "cpu":
        return flare_maps_plain(images, fparams, is_raw)
    if images.device.type != "cuda":
        raise ValueError(f"flare maps run on CPU or CUDA tensors, got {images.device}")
    return _flare_cuda(images, fparams, is_raw)


# launch count of the flare kernel: one per rr_flare call
flare_maps.launches = 0
