"""The grade kernel: the whole per-pixel chain in one CUDA launch.

Port of `rapidraw_tpu/pipeline/fused.py`. The CUDA kernel csrc/grade.cu
replaces the TPU megakernel B3 (`develop_fused`, `_make_dev_kernel`) and
its batched form B4 (`develop_fused_batch`): a thread computes 4 or 8
pixels of one column (`grade_launch_plan`), the batch on the grid's z axis,
each image's params in one row of a (B, K) float32 matrix.

Param layout: JAX packs the param pytree by sorted dict keys and trimmed
curve shapes, which the CUDA side cannot know. Here one FIXED layout
(`LAYOUT`, untrimmed 15-slot curves) defines every offset; the build emits
them into a generated header (`grade_gen.h`) together with the
DevelopConfig flag bits and the AgX curve constants, so the kernel never
guesses an offset.

`grade` is the kernel wrapper: a CPU tensor runs `grade_plain` (the plain
PyTorch chain of pipeline/grade.py), a CUDA tensor launches the kernel.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rapidraw_tpu_torch.native import KernelLibrary
from rapidraw_tpu_torch.ops import colorspace as cs
from rapidraw_tpu_torch.ops.blur import gaussian_blur_multi
from rapidraw_tpu_torch.ops.ca import apply_ca_correction
from rapidraw_tpu_torch.ops.common import coord_maps
from rapidraw_tpu_torch.ops.nr import apply_noise_reduction
from rapidraw_tpu_torch.params import agx as agx_c
from rapidraw_tpu_torch.params import scales
from rapidraw_tpu_torch.params.curves import MAX_SEGMENTS
from rapidraw_tpu_torch.params.parse import DevelopConfig
from rapidraw_tpu_torch.pipeline.grade import finish_chain, grade_chain

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


def _offsets():
    out, off = {}, 0
    for path, shape in LAYOUT:
        out[path] = off
        off += math.prod(shape)
    return out, off


OFFSETS, K = _offsets()

# DevelopConfig booleans the kernel reads, in bit order.
FLAGS = (
    "is_raw", "tonemapper_agx", "show_clipping", "sharpness_active",
    "clarity_active", "structure_active", "centre_active", "exposure_active",
    "glow_active", "halation_active", "dehaze_active", "wb_active",
    "brightness_active", "tonal_active", "highlights_active",
    "calibration_active", "hsl_active", "hue_active", "creative_active",
    "cg_active", "vignette_active", "curves_active",
    "rgb_curves_maybe_active", "grain_active", "dither_active",
)
# Not a DevelopConfig field: the wrapper sets it when the image it hands
# the kernel is already linear (NR ran first), so the kernel skips the
# sRGB linearization of the image (JAX fused.py:243-249).
IMAGE_LINEAR_BIT = 1 << len(FLAGS)


def _leaf(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def pack_rows(glob_stacked: dict) -> torch.Tensor:
    """(B, K) float32 matrix: image b's global params in row b, in LAYOUT
    order, on the leaves' device. Leaves carry a leading batch axis
    (stack_params output)."""
    cols = []
    for path, shape in LAYOUT:
        leaf = torch.as_tensor(_leaf(glob_stacked, path), dtype=torch.float32)
        if tuple(leaf.shape[1:]) != shape:
            raise ValueError(f"param {path!r}: shape {tuple(leaf.shape[1:])}, layout {shape}")
        cols.append(leaf.reshape(leaf.shape[0], -1))
    return torch.cat(cols, dim=1).contiguous()


def unpack_row(row: torch.Tensor) -> dict:
    """Rebuild one document's glob dict (tensor views) from a K-vector."""
    g: dict = {}
    for path, shape in LAYOUT:
        off = OFFSETS[path]
        leaf = row[off : off + math.prod(shape)].reshape(shape)
        node = g
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return g


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
# (2 stages) 1.47 ms at 40 registers vs 1.59 at 64.
GRADE_BLOCK = (32, 8)
LONG_CHAIN = 6
# DevelopConfig flags that are not stages of the chain
_NOT_STAGES = ("is_raw", "tonemapper_agx", "show_clipping", "rgb_curves_maybe_active",
               "dither_active")


def grade_stages(cfg: DevelopConfig) -> int:
    """How many stages of the grade chain the document turns on."""
    return sum(bool(getattr(cfg, f)) for f in FLAGS if f not in _NOT_STAGES)


def grade_launch_plan(b: int, h: int, w: int, cfg: DevelopConfig) -> dict:
    """The grade kernel's launch on a (b, 3, h, w) batch: the build (blocks
    per SM), grid, rows per thread and the tile a block owns. rr_grade
    refuses a grid that leaves a pixel out."""
    bx, by = GRADE_BLOCK
    long_chain = grade_stages(cfg) >= LONG_CHAIN
    rows = 4 if long_chain else 8
    tile_h = by * rows
    return {"block": GRADE_BLOCK, "min_blocks": 4 if long_chain else 6, "rows": rows,
            "tile": (tile_h, bx), "grid": (-(-w // bx), -(-h // tile_h), b)}


def check_supported(cfg: DevelopConfig) -> None:
    """Raise NotImplementedError for documents outside this slice."""
    later = (
        (cfg.mask_count > 0, "local masks (slice A.6)"),
        (cfg.has_lut, "the 3D LUT (slice A.8)"),
        (cfg.nr_active and (cfg.nr_static_luma is None or cfg.nr_static_color is None),
         "noise reduction with per-pixel amounts (slice A.8)"),
        (cfg.flare_active, "lens flare (slice A.8)"),
    )
    for hit, what in later:
        if hit:
            raise NotImplementedError(f"the PyTorch port does not develop {what} yet")


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


def grade_plain(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
                cfg: DevelopConfig, image_linear: bool = False) -> torch.Tensor:
    """Plain version of the grade kernel, on the kernel's own inputs.

    images: (B, 3, H, W) in input space (sRGB, or linear when RAW), or
    linear when `image_linear`; levels: {key: (B, 3, H, W)} blur levels in
    input space; pmat: (B, K).
    """
    b, _, h, w = images.shape
    scale = scales.resolution_scale(w, h)
    xs, ys = coord_maps(h, w, images.device)

    def lin(x):
        return x if cfg.is_raw else cs.srgb_to_linear(x)

    outs = []
    for i in range(b):
        g = unpack_row(pmat[i])
        blurs = {k: lin(levels[k][i]) if k in levels else None for k in BLUR_KEYS}
        image = images[i] if image_linear else lin(images[i])
        final = grade_chain(
            image, blurs["sharp"], blurs["tonal"], blurs["clarity"],
            blurs["structure"], g, cfg, xs, ys, w, h,
        )
        outs.append(finish_chain(final, g, cfg, xs, ys, scale))
    return torch.stack(outs)


def _grade_cuda(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
                cfg: DevelopConfig, image_linear: bool) -> torch.Tensor:
    b, c, h, w = images.shape
    for name, t in [("images", images), ("params", pmat), *levels.items()]:
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
    lib = _KERNEL.lib()
    fn = lib.rr_grade
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    band_bits = sum(1 << i for i, on in enumerate(cfg.hsl_band_active) if on)
    plan = grade_launch_plan(b, h, w, cfg)
    gx, gy, _ = plan["grid"]
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = fn(
        images.data_ptr(), *ptrs, pmat.data_ptr(), out.data_ptr(),
        flag_bits(cfg, image_linear), max(cfg.curve_segments, 1), band_bits,
        plan["min_blocks"], plan["rows"], gx, gy,
        # reciprocals taken in double, as PyTorch's CUDA division by a Python
        # scalar does in the plain chain
        b, h, w, 1.0 / w, 1.0 / h, 1.0 / scales.resolution_scale(w, h), h / w, stream,
    )
    _KERNEL.check(status, "rr_grade")
    grade.launches += 1
    return out


def grade(images: torch.Tensor, levels: dict, pmat: torch.Tensor,
          cfg: DevelopConfig, image_linear: bool = False) -> torch.Tensor:
    """Grade + finish chain of a (B, 3, H, W) batch: the kernel wrapper.

    CPU tensor -> `grade_plain`; CUDA tensor -> one launch of
    csrc/grade.cu on `grade_launch_plan`, the batch on the grid. `image_linear`: the image is
    already linear (NR ran first); the blur levels stay in input space.
    """
    check_supported(cfg)
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"grade takes (B, 3, H, W) images, got {tuple(images.shape)}")
    want = set(blur_radii(cfg, images.shape[3], images.shape[2]))
    if set(levels) != want:
        raise ValueError(f"grade: config reads blur levels {sorted(want)}, got {sorted(levels)}")
    if images.device.type == "cpu":
        return grade_plain(images, levels, pmat, cfg, image_linear)
    if images.device.type != "cuda":
        raise ValueError(f"grade runs on CPU or CUDA tensors, got {images.device}")
    return _grade_cuda(images, levels, pmat, cfg, image_linear)


# launch count of the grade kernel: one per rr_grade call
grade.launches = 0


def blur_levels(images: torch.Tensor, cfg: DevelopConfig) -> dict:
    """The pyramid levels of a (B, 3, H, W) batch in input space, batched
    by folding B into the channel axis: one blur launch for all levels."""
    b, c, h, w = images.shape
    radii = blur_radii(cfg, w, h)
    if not radii:
        return {}
    flat = images.reshape(b * c, h, w)
    out = gaussian_blur_multi(flat, tuple(radii.values()))
    return {k: lv.reshape(b, c, h, w) for k, lv in zip(radii, out)}


def prepare_inputs(images: torch.Tensor, cfg: DevelopConfig) -> tuple[torch.Tensor, bool]:
    """Front half of the chain for a (B, 3, H, W) batch in input space:
    CA, then linearize and NR when NR is active (JAX develop.py:101-141).

    Returns (image, image_linear). Without NR the image stays in input
    space and the grade step linearizes it, as the JAX megakernel does; with
    NR it is the linear, noise-reduced image. NR's neighbour taps read the
    original `images` (linearized), its centre the CA-corrected pixel. The
    blur levels (`blur_levels`) are taken from the original `images` too,
    not from this result.
    """
    h, w = images.shape[-2:]
    image = images
    if cfg.ca_active:
        image = apply_ca_correction(image, cfg.ca_static_rc, cfg.ca_static_by)
    if not cfg.nr_active:
        return image, False
    linear = image if cfg.is_raw else cs.srgb_to_linear(image)
    nr = apply_noise_reduction(
        linear, images, scales.resolution_scale(w, h), cfg.is_raw,
        cfg.nr_static_luma, cfg.nr_static_color,
    )
    return nr, True


def develop_fused_batch(images: torch.Tensor, params: dict, cfg: DevelopConfig) -> torch.Tensor:
    """Develop a (B, 3, H, W) batch: CA and NR (`prepare_inputs`), the
    blur pyramid of the original images, one grade launch.

    params: stacked params (stack_params), leaves with a leading B axis.
    The JAX package develops a CA or NR batch image by image
    (`fusable_batched`); the params are per row here, so one launch of
    each kernel serves the whole batch with the same per-image results.
    """
    check_supported(cfg)
    pmat = pack_rows(params["glob"]).to(images.device)
    image, linear = prepare_inputs(images, cfg)
    return grade(image, blur_levels(images, cfg), pmat, cfg, image_linear=linear)


def develop_fused(image: torch.Tensor, params: dict, cfg: DevelopConfig) -> torch.Tensor:
    """One (3, H, W) image through the batched path with B = 1."""
    glob = {"glob": _add_batch_axis(params["glob"])}
    return develop_fused_batch(image[None], glob, cfg)[0]


def _add_batch_axis(tree):
    if isinstance(tree, dict):
        return {k: _add_batch_axis(v) for k, v in tree.items()}
    return torch.as_tensor(tree)[None]
