"""The grade kernel: the whole per-pixel chain in one CUDA launch.

Port of `rapidraw_tpu/pipeline/fused.py`. The CUDA kernel csrc/grade.cu
replaces the TPU megakernel B3 (`develop_fused`, `_make_dev_kernel`) and
its batched form B4 (`develop_fused_batch`): a thread computes 4 or 8
pixels of one column (`grade_launch_plan`), the batch on the grid's z axis,
each image's params in one row of a (B, K) float32 matrix.

Lens flare: the TPU megakernel streams a full-size (3, H, W) flare tile
that XLA sampled from the 512^2 map (JAX develop.py:197-217); here the
kernel takes each image's (512, 512, 3) map (`ops/flare.flare_maps`, made
from the original image and the global params) and samples it per pixel,
so no full-size flare tensor exists. The 3D LUT: the TPU kernel stops
after the curves when the document has one and XLA runs the finish (JAX
fused.py:277, :320-327); here the LUT stage stays in the kernel, before
grain, on a cube shared by the batch.

Param layout: JAX packs the param pytree by sorted dict keys and trimmed
curve shapes, which the CUDA side cannot know. Here one FIXED layout
(`LAYOUT`, untrimmed 15-slot curves) defines every offset, and a second
one (`MASK_LAYOUT`) every offset of one mask's param set, a row of the
(B, N, KM) mask-param tensor; the build emits both into a generated header
(`grade_gen.h`) together with the DevelopConfig flag bits and the AgX
curve constants, so the kernel never guesses an offset.

Masks: the kernel takes the (B, N, H, W) influences as the caller gives
them and gates them on load (`x > 0.001 ? x : 0`, JAX develop.py:120), the
mask params, and which masks each field of `EFF_FIELDS` blends
(`blend_bits`). Blur levels that only masks read may be computed over row
bands (`blur_levels`, JAX develop.py:164-195).

`grade` is the kernel wrapper: a CPU tensor runs `grade_plain` (the plain
PyTorch chain of pipeline/grade.py), a CUDA tensor launches the kernel.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.blur import gaussian_blur_multi
from rapidraw_tpu_torch.ops.ca import apply_ca_correction
from rapidraw_tpu_torch.ops.common import coord_maps
from rapidraw_tpu_torch.ops.flare import FLARE_MAP_SIZE, FLARE_PARAMS, flare_maps, sample_flare
from rapidraw_tpu_torch.ops.nr import apply_noise_reduction
from rapidraw_tpu_torch.params import agx as agx_c
from rapidraw_tpu_torch.params import scales
from rapidraw_tpu_torch.params.curves import MAX_SEGMENTS
from rapidraw_tpu_torch.params.parse import DevelopConfig
from rapidraw_tpu_torch.pipeline.grade import (
    EFF_FIELDS,
    blend_mask_indices,
    finish_chain,
    grade_chain,
)

BLUR_KEYS = ("sharp", "tonal", "clarity", "structure")

# (path, shape) of every leaf of params["glob"], in packing order.
LAYOUT = (
    ("exposure", ()), ("brightness", ()), ("contrast", ()), ("highlights", ()),
    ("shadows", ()), ("whites", ()), ("blacks", ()), ("saturation", ()),
    ("temperature", ()), ("tint", ()), ("vibrance", ()), ("hue", ()),
    ("sharpness", ()), ("luma_nr", ()), ("color_nr", ()), ("clarity", ()),
    ("dehaze", ()), ("structure", ()), ("glow", ()), ("halation", ()),
    ("flare", ()), ("sharpness_threshold", ()), ("cg_blending", ()),
    ("cg_balance", ()), ("centre", ()), ("ca_rc", ()), ("ca_by", ()),
    ("vignette_amount", ()), ("vignette_midpoint", ()),
    ("vignette_roundness", ()), ("vignette_feather", ()),
    ("grain_amount", ()), ("grain_size", ()), ("grain_roughness", ()),
    ("lut_intensity", ()),
    ("hsl", (8, 3)), ("cg", (4, 3)), ("calibration", (7,)),
    ("agx_p2r", (3, 3)), ("agx_r2p", (3, 3)),
    ("curves/seg", (4, MAX_SEGMENTS, 7)), ("curves/ends", (4, 4)),
    ("curves/enabled", (4,)), ("curves/rgb_active", ()),
)


def _offsets(layout):
    out, off = {}, 0
    for path, shape in layout:
        out[path] = off
        off += math.prod(shape)
    return out, off


OFFSETS, K = _offsets(LAYOUT)

# One mask's param set, a row of the (B, N, KM) mask-param tensor: the
# fields EFF_FIELDS blends (in that order, so a field's offset is also its
# index in `blend_bits`), then the scalars the mask stages read; these
# MASK_SCALARS lead the row and are the part the kernel stages in shared
# memory. HSL, colour grading and curves follow.
MASK_SCALARS = EFF_FIELDS + ("sharpness", "sharpness_threshold", "cg_blending", "cg_balance")
MASK_LAYOUT = tuple((f, ()) for f in MASK_SCALARS) + (
    ("hsl", (8, 3)), ("cg", (4, 3)),
    ("curves/seg", (4, MAX_SEGMENTS, 7)), ("curves/ends", (4, 4)),
    ("curves/enabled", (4,)), ("curves/rgb_active", ()),
)
M_OFFSETS, KM = _offsets(MASK_LAYOUT)

# DevelopConfig booleans the kernel reads, in bit order.
FLAGS = (
    "is_raw", "tonemapper_agx", "show_clipping", "sharpness_active",
    "clarity_active", "structure_active", "centre_active", "exposure_active",
    "glow_active", "halation_active", "dehaze_active", "wb_active",
    "brightness_active", "tonal_active", "highlights_active",
    "calibration_active", "hsl_active", "hue_active", "creative_active",
    "cg_active", "vignette_active", "curves_active",
    "rgb_curves_maybe_active", "grain_active", "dither_active",
    "mask_sharpness_active", "mask_hsl_active", "mask_cg_active", "mask_curves_active",
    "flare_active", "has_lut",
)
# Not a DevelopConfig field: the wrapper sets it when the image it hands
# the kernel is already linear (NR ran first), so the kernel skips the
# sRGB linearization of the image (JAX fused.py:243-249).
IMAGE_LINEAR_BIT = 1 << len(FLAGS)


def _leaf(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _pack(stacked: dict, layout, lead: int) -> torch.Tensor:
    cols = []
    for path, shape in layout:
        leaf = torch.as_tensor(_leaf(stacked, path), dtype=torch.float32)
        if tuple(leaf.shape[lead:]) != shape:
            raise ValueError(f"param {path!r}: shape {tuple(leaf.shape[lead:])}, layout {shape}")
        cols.append(leaf.reshape(*leaf.shape[:lead], -1))
    return torch.cat(cols, dim=lead).contiguous()


def pack_rows(glob_stacked: dict) -> torch.Tensor:
    """(B, K) float32 matrix: image b's global params in row b, in LAYOUT
    order, on the leaves' device. Leaves carry a leading batch axis
    (stack_params output)."""
    return _pack(glob_stacked, LAYOUT, 1)


def pack_mask_rows(mask_stacked: dict) -> torch.Tensor:
    """(B, N, KM) float32 tensor: image b's mask n's params in row [b, n],
    in MASK_LAYOUT order. Leaves carry leading batch and mask axes
    (stack_params output)."""
    return _pack(mask_stacked, MASK_LAYOUT, 2)


def _unpack(row: torch.Tensor, layout, offsets) -> dict:
    g: dict = {}
    for path, shape in layout:
        off = offsets[path]
        leaf = row[..., off : off + math.prod(shape)].reshape(tuple(row.shape[:-1]) + shape)
        node = g
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return g


def unpack_row(row: torch.Tensor) -> dict:
    """Rebuild one document's glob dict (tensor views) from a K-vector."""
    return _unpack(row, LAYOUT, OFFSETS)


def unpack_mask_rows(rows: torch.Tensor) -> dict:
    """Rebuild one document's mask dict (leaves with a leading mask axis)
    from its (N, KM) mask-param rows."""
    return _unpack(rows, MASK_LAYOUT, M_OFFSETS)


def blend_bits(cfg: DevelopConfig) -> tuple:
    """Per field of EFF_FIELDS, the set of masks it blends as a 32-bit mask
    (bit n: mask n). The kernel adds the terms in ascending mask order, the
    order of `blend_mask_indices`, so a set in any other order is refused."""
    bits = []
    for f in EFF_FIELDS:
        idx = tuple(blend_mask_indices(cfg, f))
        if list(idx) != sorted(set(idx)) or any(not 0 <= n < cfg.mask_count for n in idx):
            raise ValueError(f"field {f!r}: blend masks {idx} not ascending within "
                             f"{cfg.mask_count} masks")
        bits.append(sum(1 << n for n in idx))
    return tuple(bits)


def flag_bits(cfg: DevelopConfig, image_linear: bool = False) -> int:
    bits = sum(1 << i for i, name in enumerate(FLAGS) if getattr(cfg, name))
    return bits | (IMAGE_LINEAR_BIT if image_linear else 0)


def _c_float(v: float) -> str:
    """A C float initializer that rounds the exact Python double once."""
    return f"((float)({float(v)!r}))"


def generated_header() -> str:
    """grade_gen.h: param offsets, flag bits and AgX curve constants."""
    lines = ["// generated by rapidraw_tpu_torch/pipeline/fused.py — do not edit",
             "#pragma once", f"#define P_K {K}"]
    for path, _ in LAYOUT:
        lines.append(f"#define P_{path.replace('/', '_').upper()} {OFFSETS[path]}")
    lines += [f"#define M_K {KM}", f"#define M_SCALARS {len(MASK_SCALARS)}",
              f"#define M_BLEND {len(EFF_FIELDS)}", f"#define MAX_MASKS {scales.MAX_MASKS}"]
    for path, _ in MASK_LAYOUT:
        lines.append(f"#define M_{path.replace('/', '_').upper()} {M_OFFSETS[path]}")
    lines.append(f"#define MAX_SEGMENTS {MAX_SEGMENTS}")
    for i, name in enumerate(FLAGS):
        lines.append(f"#define F_{name.upper()} (1u << {i})")
    lines.append(f"#define F_IMAGE_LINEAR (1u << {len(FLAGS)})")
    t_coef, t_mid, t_inv = agx_c.AGX_TOE_POLY
    s_coef, s_mid, s_inv = agx_c.AGX_SHOULDER_POLY
    consts = {
        "AGX_EPSILON": agx_c.AGX_EPSILON, "AGX_MIN_EV": agx_c.AGX_MIN_EV,
        "AGX_TX": agx_c.AGX_TOE_TRANSITION_X,
        "AGX_M0": agx_c.AGX_CURVE_M0, "AGX_M1": agx_c.AGX_CURVE_M1,
        "AGX_T_MID": t_mid, "AGX_T_INV_HALF": t_inv,
        "AGX_S_MID": s_mid, "AGX_S_INV_HALF": s_inv,
    }
    for name, v in consts.items():
        lines.append(f"#define {name} {_c_float(v)}")
    # a divisor, kept in double (see divs in grade.cu)
    lines.append(f"#define AGX_RANGE_EV ({float(agx_c.AGX_RANGE_EV)!r})")
    lines.append(f"#define AGX_NCOEF {len(t_coef)}")
    for name, coef in (("AGX_TOE_COEF", t_coef), ("AGX_SHOULDER_COEF", s_coef)):
        body = ", ".join(_c_float(c) for c in coef)
        lines.append(f"__device__ const float {name}[AGX_NCOEF] = {{{body}}};")
    return "\n".join(lines) + "\n"


# --fmad=false: every product and sum rounds on its own, as in the plain
# PyTorch chain — the grain/dither hash (fract of large products) would
# otherwise flip whole dither values where a multiply-add contracts
_KERNEL = KernelLibrary("grade", header=generated_header(), extra_flags=("--fmad=false",))


# The kernel's launch shape (csrc/grade.cu): 32 x 8 threads per block, each
# thread `rows` rows of one column, 8 rows apart. A document with at least
# LONG_CHAIN stages on is issue-bound: it takes the build for 4 blocks per SM
# (up to 64 registers) and 4 rows per thread. A shorter chain waits on
# memory: it takes the build for 6 blocks per SM (40 registers, more warps)
# and 8 rows per thread. Measured on an H100 (PERF.md): config 3
# (9 stages) 4.99 ms at 64 registers vs 5.31 at 40; config 5's linear image
# (2 stages) 1.47 ms at 40 registers vs 1.59 at 64. A document with masks
# takes the mask build (`masks`), at 4 blocks per SM and 4 rows whatever
# its stage count (the blend and the mask stages need the registers); it
# stages each mask's MASK_SCALARS in `mask_smem` bytes of shared memory.
GRADE_BLOCK = (32, 8)
LONG_CHAIN = 6
# DevelopConfig flags that are not stages of the chain
_NOT_STAGES = ("is_raw", "tonemapper_agx", "show_clipping", "rgb_curves_maybe_active",
               "dither_active")


def grade_stages(cfg: DevelopConfig) -> int:
    """How many stages of the grade chain the document turns on (the four
    mask stages among them), plus one for the per-pixel blend of the mask
    fields when the document has masks."""
    stages = sum(bool(getattr(cfg, f)) for f in FLAGS if f not in _NOT_STAGES)
    return stages + (cfg.mask_count > 0)


def grade_launch_plan(b: int, h: int, w: int, cfg: DevelopConfig) -> dict:
    """The grade kernel's launch on a (b, 3, h, w) batch: the build (blocks
    per SM, masks or not), grid, rows per thread, the tile a block owns and
    the shared memory of its mask scalars. rr_grade refuses a grid that
    leaves a pixel out, and a plan whose shared memory differs or passes a
    block's 48 KB."""
    bx, by = GRADE_BLOCK
    long_chain = grade_stages(cfg) >= LONG_CHAIN or cfg.mask_count > 0
    rows = 4 if long_chain else 8
    tile_h = by * rows
    if cfg.mask_count > scales.MAX_MASKS:
        raise ValueError(f"grade: {cfg.mask_count} masks, at most {scales.MAX_MASKS}")
    mask_smem = 4 * len(MASK_SCALARS) * cfg.mask_count
    return {"block": GRADE_BLOCK, "min_blocks": 4 if long_chain else 6, "rows": rows,
            "tile": (tile_h, bx), "grid": (-(-w // bx), -(-h // tile_h), b),
            "masks": cfg.mask_count, "mask_smem": mask_smem}


def blur_radii(cfg: DevelopConfig, w: int, h: int) -> dict:
    """{level key: radius} of the pyramid levels this config reads."""
    scale = scales.resolution_scale(w, h)
    need = (
        ("sharp", cfg.sharpness_blur_needed, scales.BLUR_RADIUS_SHARPNESS),
        ("tonal", cfg.tonal_blur_needed, scales.BLUR_RADIUS_TONAL),
        ("clarity", cfg.clarity_blur_needed, scales.BLUR_RADIUS_CLARITY),
        ("structure", cfg.structure_blur_needed, scales.BLUR_RADIUS_STRUCTURE),
    )
    return {k: scales.blur_radius(base, scale) for k, flag, base in need if flag}


def check_placement(tile_offset, full_size, w: int, h: int) -> tuple:
    """((x, y), (w_full, h_full)) of a (h, w) tile: its origin and its
    image's size, (0, 0) and (w, h) for a whole image. The tile must lie
    inside the image, whose coordinates float32 holds exactly."""
    x_off, y_off = (int(v) for v in tile_offset)
    w_full, h_full = (int(v) for v in full_size) if full_size is not None else (w, h)
    if (x_off < 0 or y_off < 0 or x_off + w > w_full or y_off + h > h_full
            or max(w_full, h_full) > 1 << 24):
        raise ValueError(f"a {w}x{h} tile at {(x_off, y_off)} does not lie inside a "
                         f"{w_full}x{h_full} image")
    return (x_off, y_off), (w_full, h_full)


def gate_influences(masks: torch.Tensor) -> torch.Tensor:
    """Mask influences below the support threshold become exactly 0 (JAX
    develop.py:120); the kernel does the same on load."""
    return torch.where(masks > 0.001, masks, 0.0)


def grade_plain(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
                cfg: DevelopConfig, image_linear: bool = False,
                masks: torch.Tensor | None = None,
                mmat: torch.Tensor | None = None,
                flare: torch.Tensor | None = None,
                lut: torch.Tensor | None = None,
                tile_offset=(0, 0), full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of the grade kernel, on the kernel's own inputs.

    images: (B, 3, H, W) in input space (sRGB, or linear when RAW), or
    linear when `image_linear`; levels: {key: (B, 3, H, W)} blur levels in
    input space; pmat: (B, K); with masks, masks: (B, N, H, W) influences
    (gated here) and mmat: (B, N, KM) mask params; with flare, flare:
    (B, 512, 512, 3) maps; with a LUT, lut: the (L, L, L, 3) cube. A tile
    of a larger image gives its origin `tile_offset` (x, y) and the image's
    `full_size` (w, h): the spatial stages read absolute coordinates.
    """
    b, _, h, w = images.shape
    w_full, h_full = full_size if full_size is not None else (w, h)
    scale = scales.resolution_scale(w_full, h_full)
    xs, ys = coord_maps(h, w, images.device, tile_offset)
    gated = gate_influences(masks) if cfg.mask_count > 0 else None

    def lin(x):
        return x if cfg.is_raw else cs.srgb_to_linear(x)

    outs = []
    for i in range(b):
        g = unpack_row(pmat[i])
        m = unpack_mask_rows(mmat[i]) if gated is not None else None
        blurs = {k: lin(levels[k][i]) if k in levels else None for k in BLUR_KEYS}
        image = images[i] if image_linear else lin(images[i])
        final = grade_chain(
            image, blurs["sharp"], blurs["tonal"], blurs["clarity"],
            blurs["structure"], g, cfg, xs, ys, w_full, h_full,
            m=m, gated_infl=gated[i] if gated is not None else None,
            flare_rgb=(sample_flare(flare[i], h, w, tile_offset, (w_full, h_full))
                       if flare is not None else None),
        )
        outs.append(finish_chain(final, g, cfg, xs, ys, scale, lut=lut))
    return torch.stack(outs)


class _Blend(ctypes.Structure):
    """csrc/grade.cu's MaskBlend: per field of EFF_FIELDS, its masks' bits."""

    _fields_ = [("bits", ctypes.c_uint * len(EFF_FIELDS))]


def _grade_cuda(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
                cfg: DevelopConfig, image_linear: bool, masks, mmat, flare,
                lut, tile_offset, full_size) -> torch.Tensor:
    b, c, h, w = images.shape
    w_full, h_full = full_size
    extra = [("masks", masks), ("mask params", mmat)] if cfg.mask_count > 0 else []
    extra += [(name, t) for name, t in (("flare maps", flare), ("LUT", lut)) if t is not None]
    for name, t in [("images", images), ("params", pmat), *levels.items(), *extra]:
        if not t.is_contiguous():
            raise ValueError(f"grade kernel: {name} must be contiguous")
        if t.dtype != torch.float32 or t.device != images.device:
            raise ValueError(f"grade kernel: {name} must be float32 on {images.device}")
    for k, t in levels.items():
        if tuple(t.shape) != (b, 3, h, w):
            raise ValueError(f"grade kernel: level {k} shape {tuple(t.shape)}")
    if tuple(pmat.shape) != (b, K):
        raise ValueError(f"grade kernel: params shape {tuple(pmat.shape)}, want {(b, K)}")
    out = torch.empty_like(images)
    ptrs = [levels[k].data_ptr() if k in levels else None for k in BLUR_KEYS]
    plan = grade_launch_plan(b, h, w, cfg)
    blend = _Blend()
    if cfg.mask_count > 0:
        blend.bits[:] = blend_bits(cfg)
    lib = _KERNEL.lib()
    fn = lib.rr_grade
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        + [ctypes.c_int] * 11
        + [ctypes.c_float] * 4
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Blend), ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    band_bits = sum(1 << i for i, on in enumerate(cfg.hsl_band_active) if on)
    gx, gy, _ = plan["grid"]
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = fn(
        images.data_ptr(), *ptrs, pmat.data_ptr(), out.data_ptr(),
        flag_bits(cfg, image_linear), max(cfg.curve_segments, 1), band_bits,
        plan["min_blocks"], plan["rows"], gx, gy,
        # reciprocals taken in double, as PyTorch's CUDA division by a Python
        # scalar does in the plain chain
        b, h, w, *tile_offset, w_full, h_full,
        1.0 / w_full, 1.0 / h_full, 1.0 / scales.resolution_scale(w_full, h_full),
        h_full / w_full,
        masks.data_ptr() if cfg.mask_count > 0 else None,
        mmat.data_ptr() if cfg.mask_count > 0 else None,
        plan["masks"], ctypes.byref(blend), plan["mask_smem"],
        flare.data_ptr() if flare is not None else None,
        lut.data_ptr() if lut is not None else None,
        lut.shape[0] if lut is not None else 0, stream,
    )
    _KERNEL.check(status, "rr_grade")
    grade.launches += 1
    return out


def grade(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
          cfg: DevelopConfig, image_linear: bool = False,
          masks: torch.Tensor | None = None, mmat: torch.Tensor | None = None,
          flare: torch.Tensor | None = None, lut: torch.Tensor | None = None,
          tile_offset=(0, 0), full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """Grade + finish chain of a (B, 3, H, W) batch: the kernel wrapper.

    CPU tensor -> `grade_plain`; CUDA tensor -> one launch of
    csrc/grade.cu on `grade_launch_plan`, the batch on the grid. `image_linear`: the image is
    already linear (NR ran first); the blur levels stay in input space.
    A document with masks also takes the (B, N, H, W) influences `masks`
    (N = cfg.mask_count; gated by the kernel) and the (B, N, KM) mask
    params `mmat`; one with flare the (B, 512, 512, 3) maps `flare`
    (`ops/flare.flare_maps`); one with a LUT the (L, L, L, 3) cube `lut`
    (without it the LUT stage is skipped, as in JAX). A batch that is one
    tile of a larger image gives the tile's origin `tile_offset` (x, y) and
    the image's `full_size` (w, h) (JAX fused.py:224-256): vignette, the
    centre mask, grain, dither and the flare sample read absolute
    coordinates, and the resolution scale is the full image's.
    """
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"grade takes (B, 3, H, W) images, got {tuple(images.shape)}")
    b, _, h, w = images.shape
    tile_offset, full_size = check_placement(tile_offset, full_size, w, h)
    want = set(blur_radii(cfg, w, h))
    if set(levels) != want:
        raise ValueError(f"grade: config reads blur levels {sorted(want)}, got {sorted(levels)}")
    if cfg.mask_count > 0:
        n = cfg.mask_count
        if masks is None or tuple(masks.shape) != (b, n, h, w):
            raise ValueError(f"grade: a config with {n} masks takes (B, N, H, W) = "
                             f"{(b, n, h, w)} influences, got "
                             f"{None if masks is None else tuple(masks.shape)}")
        if mmat is None or tuple(mmat.shape) != (b, n, KM):
            raise ValueError(f"grade: mask params shape "
                             f"{None if mmat is None else tuple(mmat.shape)}, want {(b, n, KM)}")
    n = FLARE_MAP_SIZE
    if cfg.flare_active and (flare is None or tuple(flare.shape) != (b, n, n, 3)):
        raise ValueError(f"grade: a config with flare takes (B, {n}, {n}, 3) maps, got "
                         f"{None if flare is None else tuple(flare.shape)}")
    if cfg.has_lut and lut is None:
        cfg = dataclasses.replace(cfg, has_lut=False)  # no cube: the stage is skipped
    if lut is not None and (lut.ndim != 4 or lut.shape[3] != 3 or
                            not lut.shape[0] == lut.shape[1] == lut.shape[2] >= 2):
        raise ValueError(f"grade: a LUT is (L, L, L, 3) with L >= 2, got {tuple(lut.shape)}")
    if images.device.type == "cpu":
        return grade_plain(images, levels, pmat, cfg, image_linear, masks, mmat, flare, lut,
                           tile_offset, full_size)
    if images.device.type != "cuda":
        raise ValueError(f"grade runs on CPU or CUDA tensors, got {images.device}")
    return _grade_cuda(images, levels, pmat, cfg, image_linear, masks, mmat, flare, lut,
                       tile_offset, full_size)


# launch count of the grade kernel: one per rr_grade call
grade.launches = 0


def blur_levels(images: torch.Tensor, cfg: DevelopConfig, blur_bands=None,
                full_size: tuple[int, int] | None = None) -> dict:
    """The pyramid levels of a (B, 3, H, W) batch in input space, batched
    by folding B into the channel axis: one blur launch for the full-height
    levels, and one per band group.

    A level listed in `blur_bands` (only masks read it) is blurred over
    its band [y0, y1) plus a halo of the group's largest radius, so its
    band rows equal the full-image blur (the edge clamp only ever lands in
    the halo); its other rows are zeros, which the amount-gated consumers
    never select. Levels share a launch only where their bands coincide
    (JAX develop.py:172-195). On one tile of a larger image (`full_size`,
    the image's (w, h), not the tile's) the radii are the full image's and
    no band applies: bands are rows of the full image (JAX develop.py:91).
    """
    b, c, h, w = images.shape
    w_full, h_full = full_size if full_size is not None else (w, h)
    radii = blur_radii(cfg, w_full, h_full)
    if not radii:
        return {}
    # the bands that apply: levels this config reads, inside the image and
    # shorter than it (JAX develop.py:164-171)
    bands = {k: (y0, y1) for k, y0, y1 in (blur_bands or ())
             if k in radii and 0 <= y0 < y1 <= h and (y1 - y0) < h
             and (w_full, h_full) == (w, h)}
    flat = images.reshape(b * c, h, w)
    out = {}
    full = [k for k in radii if k not in bands]
    if full:
        out.update(zip(full, gaussian_blur_multi(flat, tuple(radii[k] for k in full))))
    groups: dict = {}
    for k in radii:
        if k in bands:
            groups.setdefault(bands[k], []).append(k)
    for (y0, y1), keys in groups.items():
        rmax = max(radii[k] for k in keys)
        lo, hi = max(0, y0 - rmax), min(h, y1 + rmax)
        # the blur kernel takes a contiguous source: the slab is copied
        slab = flat[:, lo:hi].contiguous()
        for k, lv in zip(keys, gaussian_blur_multi(slab, tuple(radii[k] for k in keys))):
            level = torch.empty_like(flat)
            level[:, :y0] = 0.0
            level[:, y1:] = 0.0
            level[:, y0:y1] = lv[:, y0 - lo : y1 - lo]
            out[k] = level
    return {k: out[k].reshape(b, c, h, w) for k in radii}


def nr_amounts(params: dict, cfg: DevelopConfig, masks: torch.Tensor | None, device):
    """Each image's luma and colour NR amounts (JAX develop.py:124-141): a
    field that a mask blends becomes a (B, H, W) map, global + gated
    influence x mask value in mask order; a field no mask blends stays a
    (B,) vector of per-image scalars (a batch of mixed amounts)."""
    out = []
    for f in ("luma_nr", "color_nr"):
        v = torch.as_tensor(params["glob"][f], dtype=torch.float32, device=device)
        idx = blend_mask_indices(cfg, f) if cfg.mask_count > 0 else ()
        if idx:
            mvals = torch.as_tensor(params["mask"][f], dtype=torch.float32, device=device)
            v = v[:, None, None]
            for n in idx:
                v = v + gate_influences(masks[:, n]) * mvals[:, n, None, None]
        out.append(v)
    return tuple(out)


def prepare_inputs(images: torch.Tensor, cfg: DevelopConfig, params: dict | None = None,
                   masks: torch.Tensor | None = None, tile_offset=(0, 0),
                   full_size: tuple[int, int] | None = None) -> tuple[torch.Tensor, bool]:
    """Front half of the chain for a (B, 3, H, W) batch in input space:
    CA, then linearize and NR when NR is active (JAX develop.py:101-141).

    Returns (image, image_linear). Without NR the image stays in input
    space and the grade step linearizes it, as the JAX megakernel does; with
    NR it is the linear, noise-reduced image. NR's neighbour taps read the
    original `images` (linearized), its centre the CA-corrected pixel. The
    blur levels (`blur_levels`) are taken from the original `images` too,
    not from this result. NR with per-pixel amounts (`cfg.nr_static_*`
    None) takes them from the stacked `params` and the (B, N, H, W)
    influences `masks` (`nr_amounts`). One tile of a larger image gives its
    origin `tile_offset` (x, y) and the image's `full_size` (w, h): CA
    centres on the full image, NR's resolution scale is the full image's
    and its jitter hashes read absolute coordinates.
    """
    h, w = images.shape[-2:]
    w_full, h_full = full_size if full_size is not None else (w, h)
    image = images
    if cfg.ca_active:
        image = apply_ca_correction(image, cfg.ca_static_rc, cfg.ca_static_by,
                                    tile_offset=tile_offset, full_size=(w_full, h_full))
    if not cfg.nr_active:
        return image, False
    linear = image if cfg.is_raw else cs.srgb_to_linear(image)
    amounts = (None, None)
    if cfg.nr_static_luma is None or cfg.nr_static_color is None:
        if params is None:
            raise ValueError("NR with per-pixel amounts needs the stacked params")
        amounts = nr_amounts(params, cfg, masks, images.device)
    nr = apply_noise_reduction(
        linear, images, scales.resolution_scale(w_full, h_full), cfg.is_raw,
        cfg.nr_static_luma, cfg.nr_static_color, *amounts, tile_offset=tile_offset,
    )
    return nr, True


def flare_inputs(images: torch.Tensor, pmat: torch.Tensor, cfg: DevelopConfig,
                 flare=None) -> torch.Tensor:
    """The (B, 512, 512, 3) flare maps of a batch: the caller's map (one
    (512, 512, 3) map for the whole batch, as JAX's develop_batch shares
    it, or one per image), else one per image made from the ORIGINAL images
    (before CA) and the global params, unblended (JAX develop.py:197-206)."""
    b = images.shape[0]
    n = FLARE_MAP_SIZE
    if flare is None:
        cols = [OFFSETS[k] for k in FLARE_PARAMS]
        return flare_maps(images, pmat[:, cols].contiguous(), cfg.is_raw)
    fm = torch.as_tensor(flare, dtype=torch.float32, device=images.device)
    if tuple(fm.shape) == (n, n, 3):
        fm = fm.expand(b, n, n, 3)
    if tuple(fm.shape) != (b, n, n, 3):
        raise ValueError(f"a flare map is ({n}, {n}, 3) or ({b}, {n}, {n}, 3), got "
                         f"{tuple(fm.shape)}")
    return fm.contiguous()


def develop_fused_batch(images: torch.Tensor, params: dict, cfg: DevelopConfig,
                        masks: torch.Tensor | None = None, blur_bands=None,
                        lut=None, flare=None, tile_offset=(0, 0),
                        full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """Develop a (B, 3, H, W) batch: CA and NR (`prepare_inputs`), the
    blur pyramid of the original images (band-restricted levels per
    `blur_bands`), the flare maps (`flare_inputs`), one grade launch.

    params: stacked params (stack_params), leaves with a leading B axis.
    masks: (B, N, H, W) mask influences when cfg.mask_count = N > 0 (an
    image with fewer masks has zero influence in the rest: exact no-ops).
    lut: the (L, L, L, 3) cube shared by the batch (a document with a LUT
    and no cube skips the stage, as in JAX); flare: a (512, 512, 3) map for
    the batch or (B, 512, 512, 3) maps, made here when None.
    The JAX package develops a CA, NR, LUT or flare batch image by image
    (`fusable_batched`); the params are per row here, so one launch of
    each kernel serves the whole batch with the same per-image results.
    A batch that is one tile of a larger image gives the tile's origin
    `tile_offset` (x, y) and the image's `full_size` (w, h) (JAX
    develop.py:70-140): pass its flare map too, made from the whole image
    (pipeline/tiled.py). A strided view (a crop) is copied once: the
    kernels take contiguous tensors.
    """
    images = images.contiguous()
    h, w = images.shape[-2:]
    tile_offset, full_size = check_placement(tile_offset, full_size, w, h)
    pmat = pack_rows(params["glob"]).to(images.device)
    mmat = None
    if cfg.mask_count > 0:
        if masks is None or params["mask"] is None:
            raise ValueError(f"a config with {cfg.mask_count} masks needs their influences "
                             "and stacked mask params")
        mmat = pack_mask_rows(params["mask"]).to(images.device)
        masks = torch.as_tensor(masks, dtype=torch.float32, device=images.device).contiguous()
    image, linear = prepare_inputs(images, cfg, params, masks, tile_offset, full_size)
    levels = blur_levels(images, cfg, blur_bands, full_size)
    fmaps = flare_inputs(images, pmat, cfg, flare) if cfg.flare_active else None
    cube = None
    if cfg.has_lut and lut is not None:
        cube = torch.as_tensor(lut, dtype=torch.float32, device=images.device).contiguous()
    return grade(image, levels, pmat, cfg, image_linear=linear, masks=masks, mmat=mmat,
                 flare=fmaps, lut=cube, tile_offset=tile_offset, full_size=full_size)


def develop_fused(image: torch.Tensor, params: dict, cfg: DevelopConfig,
                  masks: torch.Tensor | None = None, blur_bands=None,
                  lut=None, flare=None, tile_offset=(0, 0),
                  full_size: tuple[int, int] | None = None) -> torch.Tensor:
    """One (3, H, W) image (masks (N, H, W)) through the batched path with
    B = 1; a tile of a larger image as `develop_fused_batch` takes it."""
    batched = {"glob": _add_batch_axis(params["glob"]),
               "mask": None if params["mask"] is None else _add_batch_axis(params["mask"])}
    mk = None if masks is None else torch.as_tensor(masks)[None]
    return develop_fused_batch(image[None], batched, cfg, masks=mk, blur_bands=blur_bands,
                               lut=lut, flare=flare, tile_offset=tile_offset,
                               full_size=full_size)[0]


def _add_batch_axis(tree):
    if isinstance(tree, dict):
        return {k: _add_batch_axis(v) for k, v in tree.items()}
    return torch.as_tensor(tree)[None]
