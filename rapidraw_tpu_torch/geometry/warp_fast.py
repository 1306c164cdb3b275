"""Planned two-pass geometry warp (PyTorch + the CUDA kernel csrc/resample.cu).

Port of `rapidraw_tpu/geometry/warp_fast.py`. The inverse map is a pure
function of GeometryParams and the shape, so a planner decomposes the warp
into a vertical resample followed by a horizontal one (Catmull-Smith
two-pass: the vertical pass samples the source at (Yv(y, c), c) with
Yv(y, .) = Y(y, X^-1(y, .)) from a per-row Newton inversion). Each pass is
a 1-D row resample: every output pixel lerps two neighbouring source rows
at a per-pixel offset `e` from a per-half-tile base. The horizontal pass
runs the same resample on the transposed intermediate. Degenerate maps
(folds, spans past MAX_SPAN, too much shear) make the planner return None
and callers take the exact path (geometry/warp.py).

The planner runs in PyTorch on the image's device and brings only the
per-tile minima and maxima to the host. The plan layout is the JAX
package's (TH x TW tiles, bases per TW/2-wide half tile, stored / 8), so a
JAX plan carries across unchanged (`plan_from_arrays`).

`warp_with_plan` is the kernel wrapper: a CPU tensor runs
`warp_with_plan_plain` (pad, a `resample_rows_plain` gather plus lerp per
pass, the transposes between them, the channel-set order, the crop and the
post gain), a CUDA tensor makes one launch of csrc/resample.cu, which
replaces the TPU kernel B6 (`_resample_rows`, both passes) and that glue
for every channel set and the whole batch, on `warp_launch_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from rapidraw_tpu_torch.geometry.params import GeometryParams
from rapidraw_tpu_torch.geometry.warp import (
    geometry_values,
    source_coords_values,
    warp_image_geometry,
)
from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.ops.common import coord_maps, true_div

TH = 32
TW = 256
TWH = TW // 2  # bases are planned per half tile
MAX_SPAN = 128  # fall back to the exact path past this per-tile span
SENTINEL = -1e6

# The warp kernel's launch (csrc/resample.cu holds the same constants and
# checks each plan against them): output rows of a block, the most planes
# a block resamples, the channel sets of a plan, a block's shared-memory
# limit on sm_90.
WARP_ROWS = 32
WARP_GROUP = 3
MAX_SETS = 3
SMEM_LIMIT = 232448

# --fmad=false: the lerp s0 + frac * (s1 - s0) rounds its product and its
# sum apart, as the plain version's PyTorch ops do
_KERNEL = KernelLibrary("resample", extra_flags=("--fmad=false",))


@dataclass(frozen=True)
class PassStatic:
    span: int  # largest in-tile extent of e, in rows
    band: int  # source rows one tile may touch
    pad_lo: int  # zero rows before the source along the resample axis
    extent: int  # total padded source extent along the resample axis
    nty: int
    ntx: int


@dataclass(frozen=True)
class WarpStatic:
    p: GeometryParams
    h: int
    w: int
    hp: int
    wp: int
    modes: tuple  # per channel set: (channels tuple, PassStatic v, PassStatic h)
    has_post: bool = False  # arrays carry an (h, w) post multiplier


@dataclass
class WarpPlan:
    static: WarpStatic
    # name -> tensor on the image's device: ev<i>/eh<i> (f32 e-maps),
    # bv<i>/bh<i> (int32 half-tile bases / 8), optional post (h, w)
    arrays: dict


def _invert_stage(vals: dict, tca_v: float, h: int, w: int, hp: int, wp: int,
                  lens_model: int, mode: str, device):
    """Evaluate the map, Newton-invert each row, and build the two passes'
    coordinate fields: (coord_v, coord_h_t, mono_bad, shear)."""
    cx, cy = w / 2.0, h / 2.0
    cols2d, rows2d = coord_maps(h, w, device)
    tca = float(np.float32(tca_v))

    def eval_xy(xh):
        sx, sy, zk = source_coords_values(vals, h, w, xh, rows2d, lens_model)
        # TCA channel scale (an exact *1.0 for the plain set)
        return cx + (sx - cx) * tca, cy + (sy - cy) * tca, zk

    X, Y, z_ok = eval_xy(cols2d)
    in_frame = (
        z_ok & (X >= 0.0) & (Y >= 0.0) & (X < w - 1.0) & (Y < h - 1.0)
        & torch.isfinite(X) & torch.isfinite(Y)
    )
    if mode == "clamp":
        X = torch.clamp(torch.nan_to_num(X), 0.0, w - 1.0)
        Y = torch.clamp(torch.nan_to_num(Y), 0.0, h - 1.0)
        valid = torch.ones((h, w), dtype=torch.bool, device=device)
    else:
        valid = in_frame
        X = torch.where(valid, X, 0.0)
        Y = torch.where(valid, Y, 0.0)
    # fold detection over pairs where both pixels land in frame on the raw
    # map (the out-of-frame band and the clamp plateaus are not folds)
    pair_ok = in_frame[:, 1:] & in_frame[:, :-1]
    bad = ((torch.diff(X, dim=1) <= 0) & pair_ok).sum()
    mono_bad = float(bad) / max(int(pair_ok.sum()), 1)

    # per-row Newton on the analytic map: X(y, xhat) = c, Yv = Y(y, xhat)
    slope = eval_xy(cols2d + 0.5)[0] - eval_xy(cols2d - 0.5)[0]
    slope = torch.where(torch.abs(slope) > 0.05, slope, 0.05)
    xhat = cols2d
    for _ in range(8):
        xhat = xhat - (eval_xy(xhat)[0] - cols2d) / slope
    Yv = eval_xy(xhat)[1]
    # the vertical-pass shear bounds the two-pass decomposition's error
    shear = float(torch.max(torch.where(pair_ok, torch.abs(torch.diff(Yv, dim=1)), 0.0)))

    def padded(a):
        return torch.nn.functional.pad(a, (0, wp - w, 0, hp - h), value=SENTINEL)

    # vertical coords always sample clamped; invalidity rides the
    # horizontal pass so the intermediate stays finite where X points
    coord_v = padded(torch.clamp(torch.nan_to_num(Yv), 0.0, h - 1.0))
    x_for_h = torch.where(valid, X, SENTINEL) if mode == "zero" else X
    coord_h_t = padded(x_for_h).T.contiguous()
    return coord_v, coord_h_t, mono_bad, shear


def _post_stage(vals: dict, p: GeometryParams, h: int, w: int, has_vig: bool, device):
    """(h, w) post multiplier: the z_ok gate times the lens-vignette gain,
    baked into the plan (geometry/warp.py apply_lens_vignette)."""
    cols2d, rows2d = coord_maps(h, w, device)
    src_x, src_y, z_ok = source_coords_values(vals, h, w, cols2d, rows2d, p.lens_model)
    post = z_ok.to(torch.float32)
    if has_vig:
        cx, cy = w / 2.0, h / 2.0
        half_diag2 = cx * cx + cy * cy
        dx = src_x - cx
        dy = src_y - cy
        ru_norm2 = true_div(dx * dx + dy * dy, half_diag2)
        k1, k2, k3, amt = (float(np.float32(v)) for v in
                           (p.vig_k1, p.vig_k2, p.vig_k3, p.lens_vignette_amount * 0.8))
        v = 1.0 + k1 * ru_norm2 + k2 * ru_norm2**2 + k3 * ru_norm2**3
        gain = 1.0 + (1.0 / torch.where(v > 1e-6, v, 1.0) - 1.0) * amt
        post = post * torch.where(v > 1e-6, gain, 1.0)
    return post


def _tile_minmax(coord: torch.Tensor):
    hp, wp = coord.shape
    nty, nhx = hp // TH, wp // TWH
    axis = torch.arange(hp, dtype=torch.float32, device=coord.device)[:, None]
    valid = coord > SENTINEL / 2
    big = torch.where(valid, coord - axis, float("inf"))
    small = torch.where(valid, coord - axis, float("-inf"))
    return (
        big.reshape(nty, TH, nhx, TWH).amin(dim=(1, 3)),
        small.reshape(nty, TH, nhx, TWH).amax(dim=(1, 3)),
        bool(valid.any()),
    )


def _emap(coord: torch.Tensor, bases_f32: torch.Tensor, pad_lo: float):
    hp, wp = coord.shape
    in_tile = (torch.arange(hp, dtype=torch.int32, device=coord.device) % TH).to(torch.float32)
    valid = coord > SENTINEL / 2
    rep = bases_f32.repeat_interleave(TH, dim=0).repeat_interleave(TWH, dim=1)
    e = torch.where(valid, coord + pad_lo - rep - in_tile[:, None], SENTINEL)
    emin = float(torch.where(valid, e, float("inf")).min())
    emax = float(torch.where(valid, e, float("-inf")).max())
    return e, emin, emax


def _plan_pass(coord: torch.Tensor, nty: int, ntx: int):
    """Plan one vertical (row-axis) resample pass; the horizontal pass
    plans the transposed coordinates the same way.

    coord: (hp, wp) absolute source row per output pixel, SENTINEL where
    the pixel comes out black. Returns (e, bases, PassStatic) or None when
    the in-tile span exceeds MAX_SPAN. For each half tile, base = floor of
    the least displacement rounded down to a multiple of 8, so the local
    offset e = coord + pad_lo - base - row_in_tile lies in [0, span); the
    source is zero-padded by pad_lo rows so every base is >= 0.
    """
    t_min, t_max, any_valid = _tile_minmax(coord)
    if not any_valid:
        return None
    dmin = t_min.cpu().numpy().astype(np.float64)
    dmax = t_max.cpu().numpy().astype(np.float64)
    empty = ~np.isfinite(dmin)
    dmin = np.where(empty, 0.0, dmin)
    dmax = np.where(empty, 0.0, dmax)

    # 8-aligned bases: the quantization adds up to 7 to the span
    span = int(np.max(np.ceil(dmax) - np.floor(dmin))) + 1 + 7
    if span > MAX_SPAN:
        return None
    first = (np.arange(nty) * TH)[:, None]
    base_unc = (np.floor(first + dmin).astype(np.int64) // 8) * 8
    pad_lo = int(max(0, -base_unc.min()))
    pad_lo = -(-pad_lo // 8) * 8
    bases = base_unc + pad_lo
    band = -(-(TH + span + 9) // 8) * 8
    extent = int(bases.max()) + band

    e, emin, emax = _emap(coord, torch.as_tensor(bases, dtype=torch.float32,
                                                 device=coord.device), float(pad_lo))
    assert emin >= 0.0 and emax < span, (emin, emax, span)
    return (
        e,
        torch.as_tensor((bases // 8).astype(np.int32).reshape(-1), device=coord.device),
        PassStatic(span=span, band=band, pad_lo=pad_lo, extent=extent, nty=nty, ntx=ntx),
    )


def plan_warp(p: GeometryParams, h: int, w: int, device="cuda") -> WarpPlan | None:
    """Plan the two-pass warp on `device`. None => use the exact path."""
    # both dims padded to 256: each is the TW axis in one pass and the
    # TH-row axis in the other (the horizontal pass runs transposed)
    hp = -(-h // 256) * 256
    wp = -(-w // 256) * 256
    nty, ntx = hp // TH, wp // TW
    device = torch.device(device)
    gv = geometry_values(p, h, w)

    vr, vb = float(gv["vr"]), float(gv["vb"])
    has_tca = p.lens_tca_enabled and (abs(vr - 1.0) > 1e-5 or abs(vb - 1.0) > 1e-5)
    if has_tca:
        sets = [((0,), "clamp", vr), ((1,), "clamp", 1.0), ((2,), "clamp", vb)]
    else:
        sets = [((0, 1, 2), "zero", 1.0)]

    arrays: dict = {}
    modes = []
    for si, (channels, mode, tca_v) in enumerate(sets):
        coord_v, coord_h_t, mono_bad, shear = _invert_stage(
            gv, tca_v, h, w, hp, wp, p.lens_model, mode, device)
        if mono_bad > 0.01:
            return None  # folded map (strong perspective)
        if shear > 0.55:
            return None  # past the two-pass quality envelope
        v = _plan_pass(coord_v, nty, ntx)
        if v is None:
            return None
        hplan = _plan_pass(coord_h_t, wp // TH, hp // TW)
        if hplan is None:
            return None
        arrays[f"ev{si}"], arrays[f"bv{si}"], vstat = v
        arrays[f"eh{si}"], arrays[f"bh{si}"], hstat = hplan
        modes.append((tuple(channels), vstat, hstat))

    lens_vig_amt = p.lens_vignette_amount * 0.8
    has_vig = (
        p.lens_vignette_enabled
        and (abs(p.vig_k1) > 1e-6 or abs(p.vig_k2) > 1e-6 or abs(p.vig_k3) > 1e-6)
        and lens_vig_amt > 0.01
    )
    has_persp = (
        abs(float(gv["inv"][2, 0])) > 0.0
        or abs(float(gv["inv"][2, 1])) > 0.0
        or abs(float(gv["inv"][2, 2])) <= 1e-6  # z_ok false everywhere
    )
    has_post = has_vig or has_persp
    if has_post:
        arrays["post"] = _post_stage(gv, p, h, w, has_vig, device)
    return WarpPlan(
        static=WarpStatic(p=p, h=h, w=w, hp=hp, wp=wp, modes=tuple(modes), has_post=has_post),
        arrays=arrays,
    )


def plan_from_arrays(static: dict, arrays: dict, device) -> WarpPlan:
    """A WarpPlan from another planner's fields, as plain values: `static`
    holds WarpStatic's fields (p as a dict of GeometryParams fields, each
    mode as (channels, PassStatic fields, PassStatic fields)), `arrays` maps
    the plan's names to NumPy arrays. Mosaic trip counts (gv<i>, gh<i>) are
    not needed and are dropped."""
    def pstat(d):
        return PassStatic(**{f: int(d[f]) for f in PassStatic.__dataclass_fields__})

    ws = WarpStatic(
        p=GeometryParams(**static["p"]),
        h=int(static["h"]), w=int(static["w"]), hp=int(static["hp"]), wp=int(static["wp"]),
        modes=tuple((tuple(int(c) for c in ch), pstat(v), pstat(hh))
                    for ch, v, hh in static["modes"]),
        has_post=bool(static.get("has_post", False)),
    )
    keep = {}
    for name, arr in arrays.items():
        if name.startswith(("gv", "gh")):
            continue
        dtype = torch.int32 if name.startswith(("bv", "bh")) else torch.float32
        keep[name] = torch.as_tensor(np.array(arr), dtype=dtype, device=device)
    return WarpPlan(static=ws, arrays=keep)


def _check_resample(img, e_arr, bases, st: PassStatic) -> None:
    if img.ndim != 3 or img.dtype != torch.float32:
        raise ValueError(f"resample takes a float32 (C, R, L) tensor, got {img.dtype} {tuple(img.shape)}")
    want = (st.nty * TH, st.ntx * TW)
    if tuple(e_arr.shape) != want or tuple(img.shape[2:]) != (want[1],):
        raise ValueError(f"resample: e {tuple(e_arr.shape)} / image {tuple(img.shape)} vs plan {want}")
    if bases.numel() != st.nty * st.ntx * 2:
        raise ValueError(f"resample: {bases.numel()} bases, plan wants {st.nty * st.ntx * 2}")


def resample_rows_plain(img: torch.Tensor, e_arr: torch.Tensor, bases: torch.Tensor,
                        st: PassStatic) -> torch.Tensor:
    """Plain version of the resample kernel: out[c, r, x] = s0 + frac *
    (s1 - s0) of source rows k = base - pad_lo + (r mod TH) + floor(e) and
    k + 1, rows outside [0, R) reading 0 (the sentinel e gives 0)."""
    _check_resample(img, e_arr, bases, st)
    c, nrows, ncols = img.shape
    hp, wp = e_arr.shape
    base = bases.to(torch.int64).reshape(st.nty, 2 * st.ntx) * 8 - st.pad_lo
    base = base.repeat_interleave(TH, dim=0).repeat_interleave(TWH, dim=1)
    in_tile = (torch.arange(hp, device=img.device) % TH)[:, None]
    e0 = torch.floor(e_arr)
    frac = e_arr - e0
    k0 = base + in_tile + e0.to(torch.int64)

    def rows(k):
        ok = (k >= 0) & (k < nrows)
        idx = torch.clamp(k, 0, nrows - 1).expand(c, hp, wp)
        return torch.where(ok, torch.gather(img, 1, idx), 0.0)

    s0 = rows(k0)
    s1 = rows(k0 + 1)
    return s0 + frac * (s1 - s0)


def warp_with_plan_plain(image: torch.Tensor, arrays: dict, static: WarpStatic) -> torch.Tensor:
    """Plain version of the warp kernel: the planned two-pass warp of (3, H,
    W) or a batch (B, 3, H, W), as JAX's `warp_with_plan` runs it. A batch
    folds into the resample's leading channel axis."""
    batched = image.ndim == 4
    imgs = image if batched else image[None]
    b = imgs.shape[0]
    h, w, hp, wp = static.h, static.w, static.hp, static.wp
    imgs = torch.nn.functional.pad(imgs, (0, wp - w, 0, hp - h))

    outs = []
    order = []
    for si, (channels, vstat, hstat) in enumerate(static.modes):
        part = imgs[:, list(channels)] if len(channels) < 3 else imgs
        nc = part.shape[1]
        part = part.reshape(b * nc, hp, wp).contiguous()
        tmp = resample_rows_plain(part, arrays[f"ev{si}"], arrays[f"bv{si}"], vstat)
        # the horizontal pass runs on the transposed intermediate
        tmp_t = tmp.transpose(1, 2).contiguous()
        res_t = resample_rows_plain(tmp_t, arrays[f"eh{si}"], arrays[f"bh{si}"], hstat)
        outs.append(res_t.transpose(1, 2).reshape(b, nc, hp, wp))
        order.extend(channels)
    out = torch.cat(outs, dim=1)
    if order != [0, 1, 2]:
        out = out[:, [int(i) for i in np.argsort(order)]]
    out = out[:, :, :h, :w]
    if static.has_post:
        # z_ok is exactly 0/1, so the product is where(z_ok, out * gain, 0)
        out = out * arrays["post"]
    out = out.contiguous()
    return out if batched else out[0]


def warp_launch_plan(static: WarpStatic, n_channels: int) -> dict:
    """The warp kernel's launch on a batch of n_channels planes (3 per
    image). A block writes a TH-column by WARP_ROWS-row output tile, which
    lies in one horizontal half tile and so shares one base, for a group of
    up to WARP_GROUP planes of one channel set: it stages the vertical pass
    at the intermediate columns its tile's lanes read, at most `sw` = TH +
    span of them, in shared memory beside the tile's e. Each set splits its
    planes (images x its channels) into `ngroups` groups of `group` planes
    or fewer, as even as they come. Grid: x = column tiles x the most
    groups of any set, y = row tiles, z = sets. rr_warp recomputes every
    count and size from the fields and refuses a plan that differs or
    passes SMEM_LIMIT; this function raises first."""
    if n_channels < 3 or n_channels % 3:
        raise ValueError(f"the warp takes 3 planes per image, got {n_channels}")
    if not 1 <= len(static.modes) <= MAX_SETS:
        raise ValueError(f"the warp takes 1 to {MAX_SETS} channel sets, got {len(static.modes)}")
    images = n_channels // 3
    sets = []
    for channels, vstat, hstat in static.modes:
        if not 1 <= hstat.span <= MAX_SPAN:
            raise ValueError(f"the warp's span {hstat.span} lies outside [1, {MAX_SPAN}]")
        planes = images * len(channels)
        ngroups = -(-planes // WARP_GROUP)
        group = -(-planes // ngroups)
        sets.append(dict(planes=planes, nc=len(channels), ch=tuple(channels),
                         pad_v=vstat.pad_lo, pad_h=hstat.pad_lo, span_h=hstat.span,
                         sw=TH + hstat.span, group=group, ngroups=ngroups))
    group = max(st["group"] for st in sets)
    ngroups = max(st["ngroups"] for st in sets)
    sw_max = max(st["sw"] for st in sets)
    smem = 4 * (TH * (WARP_ROWS + 1) + group * WARP_ROWS * sw_max)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the warp's staged tile takes {smem} B, past {SMEM_LIMIT}")
    grid = (-(-static.w // TH) * ngroups, -(-static.h // WARP_ROWS), len(sets))
    return dict(sets=sets, group=group, ngroups=ngroups, rows=WARP_ROWS, sw_max=sw_max,
                smem=smem, grid=grid)


class _Set(ctypes.Structure):
    """csrc/resample.cu's WarpSet, field for field."""

    _fields_ = ([(k, ctypes.c_int) for k in ("planes", "nc")] + [("ch", ctypes.c_int * 3)]
                + [(k, ctypes.c_int) for k in ("group", "ngroups", "pad_v", "pad_h", "span_h",
                                                "sw")])


class _Plan(ctypes.Structure):
    """csrc/resample.cu's WarpPlan, field for field."""

    _fields_ = ([(k, ctypes.c_int) for k in ("nsets", "group", "ngroups", "rows", "sw_max",
                                             "smem", "gx", "gy", "gz", "b", "h", "w", "hp",
                                             "wp")]
                + [("set", _Set * MAX_SETS)])


class _Ptrs(ctypes.Structure):
    """csrc/resample.cu's WarpPtrs: each set's e-maps and bases."""

    _fields_ = [(k, ctypes.c_void_p * MAX_SETS) for k in ("ev", "bv", "eh", "bh")]


@functools.lru_cache(maxsize=64)
def _packed_plan(static: WarpStatic, n_channels: int) -> _Plan:
    """The launch plan of a warp and batch as rr_warp's struct, built once."""
    plan = warp_launch_plan(static, n_channels)
    packed = _Plan(nsets=len(plan["sets"]), group=plan["group"], ngroups=plan["ngroups"],
                   rows=plan["rows"], sw_max=plan["sw_max"], smem=plan["smem"],
                   b=n_channels // 3, h=static.h, w=static.w, hp=static.hp, wp=static.wp)
    packed.gx, packed.gy, packed.gz = plan["grid"]
    for i, st in enumerate(plan["sets"]):
        packed.set[i] = _Set(planes=st["planes"], nc=st["nc"], group=st["group"],
                             ngroups=st["ngroups"], pad_v=st["pad_v"], pad_h=st["pad_h"],
                             span_h=st["span_h"], sw=st["sw"])
        for j, c in enumerate(st["ch"]):
            packed.set[i].ch[j] = c
    return packed


def _warp_args(image: torch.Tensor, arrays: dict, static: WarpStatic):
    """rr_warp's arguments for a (3, H, W) or (B, 3, H, W) float32 image:
    the batch (contiguous), the packed launch plan, each set's e-map and
    base pointers and the post gain (or None), every array checked against
    the plan on the image's device. It touches no device memory, so the
    CPU tests run it on the paths' own inputs."""
    imgs = image if image.ndim == 4 else image[None]
    if imgs.ndim != 4 or tuple(imgs.shape[1:]) != (3, static.h, static.w) \
            or imgs.dtype != torch.float32:
        raise ValueError(f"the warp takes a float32 (B, 3, {static.h}, {static.w}) or "
                         f"(3, {static.h}, {static.w}) image, got {image.dtype} "
                         f"{tuple(image.shape)}")
    dev = imgs.device
    ptrs = _Ptrs()
    hp, wp = static.hp, static.wp
    for si in range(len(static.modes)):
        # e-maps by shape, bases by count (a plan may keep them 1-D or 2-D)
        for key, shape, dtype in (("ev", (hp, wp), torch.float32),
                                  ("bv", hp // TH * (wp // TWH), torch.int32),
                                  ("eh", (wp, hp), torch.float32),
                                  ("bh", wp // TH * (hp // TWH), torch.int32)):
            t = arrays[f"{key}{si}"]
            if t.device != dev or t.dtype != dtype or not t.is_contiguous() or (
                    tuple(t.shape) != shape if dtype == torch.float32 else t.numel() != shape):
                raise ValueError(f"warp kernel: {key}{si} must be a contiguous {dtype} tensor "
                                 f"of {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
            getattr(ptrs, key)[si] = t.data_ptr()
    post = None
    if static.has_post:
        post = arrays["post"]
        if post.device != dev or post.dtype != torch.float32 or not post.is_contiguous() \
                or tuple(post.shape) != (static.h, static.w):
            raise ValueError(f"warp kernel: post must be a contiguous float32 "
                             f"({static.h}, {static.w}) tensor on {dev}")
    return imgs.contiguous(), _packed_plan(static, 3 * imgs.shape[0]), ptrs, post


@functools.cache
def _rr_warp():
    """The kernel's entry point, its ctypes signature set once at load."""
    fn = _KERNEL.lib().rr_warp
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def warp_with_plan(image: torch.Tensor, arrays: dict, static: WarpStatic) -> torch.Tensor:
    """Apply a planned two-pass warp to (3, H, W) or a batch (B, 3, H, W):
    the kernel wrapper. CPU tensor -> `warp_with_plan_plain`; CUDA tensor ->
    one launch of csrc/resample.cu for every channel set and the whole
    batch (a float32 image, the plan's arrays on its device)."""
    if image.device.type == "cpu":
        return warp_with_plan_plain(image, arrays, static)
    if image.device.type != "cuda":
        raise ValueError(f"the warp runs on CPU or CUDA tensors, got {image.device}")
    imgs, packed, ptrs, post = _warp_args(image, arrays, static)
    out = torch.empty_like(imgs)
    status = _rr_warp()(imgs.data_ptr(), post.data_ptr() if post is not None else None,
                        out.data_ptr(), ctypes.byref(packed), ctypes.byref(ptrs),
                        torch.cuda.current_stream(imgs.device).cuda_stream)
    _KERNEL.check(status, "rr_warp")
    warp_with_plan.launches += 1
    return out if image.ndim == 4 else out[0]


# launch count of the warp kernel: one per rr_warp call (every channel set
# and the whole batch of one warp)
warp_with_plan.launches = 0


@functools.lru_cache(maxsize=4)
def _cached_plan(p: GeometryParams, h: int, w: int, device: str):
    # a 24 MP plan holds ~200 MB (plain) to ~600 MB (TCA) of e-maps on the
    # device; four slider positions is the working set
    return plan_warp(p, h, w, device)


def warp_image_fast(image: torch.Tensor, p: GeometryParams) -> torch.Tensor:
    """The planned two-pass warp of (3, H, W) or (B, 3, H, W), with the
    exact path where the planner refuses the map."""
    h, w = image.shape[-2:]
    plan = _cached_plan(p, int(h), int(w), str(image.device))
    if plan is None:
        return warp_image_geometry(image, p)
    return warp_with_plan(image, plan.arrays, plan.static)
