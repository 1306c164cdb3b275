"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--quick] [--out DIR] [--profile] [--seed N]

Phases: (1) the card's name and power limit; (2) build the seven CUDA
sources of rapidraw_tpu_torch/csrc, one nvcc each, the seven host decoders
(csrc/host/: lossless JPEG, Nikon/Pentax Huffman, Panasonic/Olympus, crx,
Phase One, the LDR loader's JPEG decoder and TIFF LZW/PackBits) and the
export's JPEG encoder (csrc/host/jpeg_enc.cc), g++ each, all started
together;
(3) the blur kernel against its plain PyTorch version at 24 MP, with a
case at each main path's shapes, one in each of its two regimes (the
launch plan fuses small radii into one pass and gives larger ones two),
two at a ragged size and one on values outside [0, 65504]; (4) the grade
kernel against its plain
version at 24 MP, B = 1 and 2, on six documents, and at a ragged size
(1000 x 1503, a multiple of neither kernel's tile), B = 2; (5) the develop path end
to end: adjustment JSON -> stack_params -> develop_batch -> device_u8 ->
host numpy (configs 1 and 3), with the kernels' launch counters reset just
before and read just after, plus a small-input check against the plain CPU
path; (6) the NR kernel against its plain version on a 24 MP B = 2 batch,
as config 5 runs it, and at the ragged size; (7) the resample kernel against its plain version on
the 24 MP config-5 and TCA plans; (8) the stencil export path end to end
(config 5): JSON + geometry -> plan_warp -> warp_with_plan ->
develop_batch -> device_u8 -> host numpy, counters reset and read around
it, plus its small-input check; (9) the profiling probes P1 and P2
(rapidraw_tpu_torch/tools): their entry points' main() at 24 MP, counters
reset just before and read just after; each times its variants (P1 at 1,
8, 16, 32 and 64 rows per thread, P2 at its plan's band of one wave of
resident blocks and at half of it; each the median of 5 chained
measurements), holds them against its plain version and raises on a
mismatch (P2 on any differing value); then P2 bit for bit against its
plain version at 1000 x 1503, at (3, 5, 9), at a short band and at a
16-byte-misaligned 1000 x 1504 (its edge path); (10) local masks, the
config-4 path: the config-4 masks rasterized once on the host (timed), the
grade kernel with masks against its plain version at 24 MP, B = 2, and at
1000 x 1503 on config 4 and on a five-mask document that turns on every mask stage
(dither off and on), config 4's band-restricted blur levels against the
plain blur of the whole frame, and JSON -> rasterize_masks ->
blur_band_rows -> stack_params -> develop_batch -> device_u8 -> host numpy
for B = 1 and 2 (counters reset and read around it; the mask upload, the
device part and the readback timed apart), plus its small-input check;
(11) config 2, RAW: an RGGB DNG of random u16 samples from a seed (with a
colour matrix and as-shot white balance), a 14-bit bit-packed copy, an
Orientation = 6 copy and a lossless-JPEG tiled file, written to a
temporary directory; the host parse of
each, the u16 upload, the front end (normalize .. orientation) and the
enhance pass timed apart with their bounds; the blur and grade kernels
against their plain versions on the RAW images (is_raw), the blur also
against one depthwise conv2d per radius; DNG ->
load_image -> parse_adjustments(is_raw=True) -> stack_params ->
develop_batch -> device_u8 -> host numpy for B = 1 and 2 on `{}` (grade
only) and CONFIG3_DOC (blur + grade) and the fast thumbnail path, counters
reset and read around each (grade once per develop call, blur once with
CONFIG3_DOC and never with `{}`); e2e ms/image and MPix/s beside the
develop device part and the readback; a 1024 x 1536 file on the card
against the plain CPU path (the front end bit for bit, u8 within 1 LSB on
<= 0.1% of values, the enhance gate flips counted); and an X-Trans RAF at
the same size: its host parse, the front end's first frame (site masks
built) and later frames (masks resident, the cache checked), the
CONFIG3_DOC path from the file with its launches counted, and a
1024 x 1536 RAF on the card against the plain CPU path; (12) config 2
from the vendor containers: 24 MP CR2 (sliced lossless JPEG, 14-bit, a
masked border), NEF (compression 34713, lossless 12-bit), ARW (ARW2) and
CR3 (crx lossless 14-bit) files of photograph-like content from --seed,
each with its host parse (the CFA must equal what was encoded), u16
upload, front end and file -> load_image -> develop_batch(CONFIG3_DOC) ->
u8 for B = 1 and 2 (grade and blur each launched once per call), and every
vendor format (those four, PEF, ORF packed and predictive, RW2, MRW, SRW,
IIQ format 5) at 1024 x 1536 (the ORF predictive stream, written sample
by sample, at 512 x 768) on the card against the plain CPU path; (13) the
rest of the develop document (`phase_doc`): the flare kernel against its
plain version on a B = 2 batch of bright-spot images (24 MP and the ragged
size, with the share of values that differ), the grade kernel
with flare and a 33^3 .cube LUT (written here, parsed by
io/lut.parse_lut_file) against its plain version, timed beside config 3's
grade, in its masks build with a flare mask and at the ragged size, the
per-pixel NR kernel against its plain version on config 5 with an NR mask
(amount maps) and on a batch of mixed NR amounts (per-image amounts), at
24 MP (timed) and the ragged size, then
JSON -> develop_batch -> device_u8 -> host numpy for those documents at
B = 1 and 2 (the mixed batch at B = 2), counters reset and read around
each (flare, grade and blur, or NR, grade and blur, once per call), and
each at 1024 x 1536 on the card against the plain CPU path; (14) batch
export (`phase_export`, `[export]` lines): 8 DNGs of photograph-like
content from --seed with capture metadata and a GPS IFD (raw_dng_bytes
with EXPORT_META), 6 with CONFIG3_DOC and 2 with `{}` in their sidecars,
plus a virtual copy, through export_images on the card: JPEG q90 with the
default settings, TIFF and PNG on two files, JPEG with long_edge 2048 on
two, counters reset and read around each (grade once per chunk, blur once
per CONFIG3_DOC chunk), images/s, the stage split, the device memory peak
and the JPEG encoder alone on one frame; every result ok, the file names
as _output_path gives them, the JPEG markers in order with the EXIF APP1
and no GPS tag, a TIFF read back equal to its chunk's device_u16 frame,
and a 1024 x 1536 export on the card against the plain CPU path; (15) LDR
inputs and the rest of export (`phase_ldr`, `[ldr]` and `[ldr-export]`
lines): a baseline 4:2:0 JPEG q90 with an Orientation = 6 APP1, a 16-bit
PNG, a 16-bit TIFF and an 8-bit LZW TIFF from --seed, written with the
port's own writers; the JPEG's host decode timed; each file's load_image
on the card held to device="cpu" (max |d| 0); the blur and grade kernels
against their plain versions on the loaded JPEG (is_raw False); export
with CONFIG3_DOC sidecars to JPEG q90 (grade and blur once per chunk),
then with long_edge 2048, an RGBA watermark and export_masks on a fifth
file with a config-4 document (grade once per chunk and per mask image),
images/s, stage seconds and the device memory peak of each; the outputs
decoded and checked; and a 1024 x 1536 JPEG export with the watermark and
masks on the card against the plain CPU path; (16) the preview service
(`phase_preview`, `[preview]` and `[preview-kernel]` lines): a 16-bit DNG
and a q90 JPEG (Orientation 6) from --seed through RenderService on the
card at its default settings (1920 long edge): the cold render split by
stage with the device memory peak, warm frames with the exposure changed,
the interactive 'performance' frame, an odd ROI, the scopes, config 4's
masks (a mask-cache hit), config 5 with its geometry, FLARE_LUT_DOC and
masked_nr_doc, the uncropped, original, preset and geometry previews
with the straightening guides, auto adjust, PreviewWorker on a burst of
30 documents and AnalyticsWorker, each render with its launches (every
develop kernel must run in the phase); the blur, grade, NR, resample
and flare kernels against their plain versions at the preview's shape and
the ROI's; and a 1024 x 1536 DNG through the service on the card against
device="cpu" (u8 within 1 LSB); its resample rows at the preview's shapes
time a shape no caller runs (the service warps at the source's size: phase
7's case is the preview path's); (17) the CLI and the tiled develop
(`phase_cli`, `[tiled-kernel]`, `[tiled]` and `[cli]` lines): the grade
and per-pixel NR kernels on a 2304 x 2304 tile at (4096, 2048) of a
12000 x 8000 image against their plain versions (config 3, FULL_DOC with
grain and flare, FLARE_LUT_DOC; masked_nr_doc's amounts), a 96 MP 16-bit
TIFF from --seed through `python -m rapidraw_tpu_torch develop` in a child
process (24 tiles; stages, per-tile ms, launches, memory peak), the same
image through develop_tiled in this process (host-device copies counted)
against the whole-image develop (tile interiors within 1e-5), a 24 MP DNG
through the CLI's develop and export (the same bytes), and auto,
histogram, lut-export (card against CPU), lib dims on the RAW layouts,
preset import and exif --set.
Each kernel line carries its time, its plain version's time and its bound
(bytes over the HBM rate or operations over the float32 peak, whichever is
larger). It prints a kernels JSON line (top level: each kernel's numbers
on the path that runs it, config 5 for the four kernels of the develop
paths, the probes for the probes' two; per path its launch count and that
path's case; with each source's registers and spill bytes from ptxas),
then as its last line {"ok": true, "device": {...}}.
Any failed check raises, so the process exits non-zero; without a CUDA
device it exits non-zero before printing any result.

--quick runs phases 3-8 and 10-16 at 1024x1536 with fewer repetitions (a
first check of a new kernel). --out DIR writes the nvcc/ptxas logs there.
--profile adds a torch.profiler pass over the config-3, config-5,
config-4 and config-2 main paths (config 2 from a DNG and from a NEF):
kernel time by name and the device busy share (and chrome traces in
--out). Imports torch, numpy and
rapidraw_tpu_torch only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

H, W = 4096, 6144  # 24 MP, the repo's canonical develop shape
RAGGED = (1000, 1503)  # a multiple of neither the grade nor the NR tile

# BASELINE config 1: sRGB develop — exposure + contrast + saturation + curve.
CONFIG1_DOC = {
    "exposure": 0.3,
    "contrast": 20,
    "saturation": 10,
    "curves": {
        "luma": [{"x": 0, "y": 6}, {"x": 128, "y": 120}, {"x": 255, "y": 250}],
        "red": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "green": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "blue": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
    },
    "toneMapper": "basic",
}

# BASELINE config 3: full color grade — HSL + hue + curves + vignette.
CONFIG3_DOC = {
    "exposure": 0.3,
    "contrast": 20,
    "highlights": -25,
    "shadows": 20,
    "saturation": 10,
    "vibrance": 18,
    "temperature": 5,
    "hue": 5,
    "vignetteAmount": -35,
    "hsl": {
        "reds": {"hue": 6, "saturation": 10, "luminance": 0},
        "greens": {"hue": -4, "saturation": 8, "luminance": 2},
        "blues": {"hue": -8, "saturation": 14, "luminance": -6},
    },
    "curves": {
        "luma": [{"x": 0, "y": 4}, {"x": 110, "y": 96}, {"x": 255, "y": 252}],
        "red": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "green": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
        "blue": [{"x": 0, "y": 0}, {"x": 255, "y": 255}],
    },
    "toneMapper": "agx",
}

# Every local-contrast level (sharp, tonal, clarity, structure) + AgX.
FULL_DOC = {
    "exposure": 0.4, "contrast": 18, "highlights": -30, "shadows": 22,
    "whites": 10, "blacks": -6, "saturation": 12, "vibrance": 15,
    "temperature": 8, "tint": -4, "hue": 6, "clarity": 15, "structure": 10,
    "sharpness": 25, "dehaze": 8, "vignetteAmount": -30, "grainAmount": 0,
    "hsl": {
        "reds": {"hue": 5, "saturation": 8, "luminance": -2},
        "blues": {"hue": -6, "saturation": 10, "luminance": 4},
    },
    "curves": {
        "luma": [{"x": 0, "y": 6}, {"x": 128, "y": 120}, {"x": 255, "y": 250}],
    },
    "toneMapper": "agx",
}

# Grain + the centre, glow, halation, calibration and colour-grading stages.
GRAIN_DOC = {
    "grainAmount": 40, "grainSize": 30, "grainRoughness": 60,
    "exposure": 0.2, "centré": 30, "glowAmount": 30, "halationAmount": 25,
    "colorCalibration": {"shadowsTint": 10, "redHue": 20, "blueSaturation": 15},
    "colorGrading": {"shadows": {"hue": 200, "saturation": 30, "luminance": 5},
                     "highlights": {"hue": 40, "saturation": 20}, "balance": 10},
    "curves": {"red": [{"x": 0, "y": 0}, {"x": 100, "y": 120}, {"x": 255, "y": 255}]},
}

# Scene-linear RAW input through the RAW sRGB emulation tonemap.
RAW_DOC = dict(FULL_DOC, toneMapper="basic")

# BASELINE config 5: the stencil-heavy batch-export document — sharpen +
# luma/chroma NR + CA, rendered after a lens-distortion + rotation warp.
CONFIG5_DOC = {
    "exposure": 0.2,
    "sharpness": 40,
    "lumaNoiseReduction": 30,
    "colorNoiseReduction": 25,
    "chromaticAberrationRedCyan": 12,
    "chromaticAberrationBlueYellow": -8,
    "toneMapper": "agx",
}
CONFIG5_GEOMETRY = {
    "transformRotate": 1.5,
    "lensDistortionParams": {"k1": -0.08, "k2": 0.02, "model": 0, "vig_k1": -0.3},
    "lensDistortionAmount": 100.0,
    "lensVignetteAmount": 100.0,
}
# TCA + rotation: three clamp-mode channel sets, six resample launches.
TCA_GEOMETRY = {
    "transformRotate": 2.0,
    "lensDistortionParams": {"k1": -0.05, "tca_vr": 1.002, "tca_vb": 0.998},
}
# NR strong enough to reach the largest tap offsets at 24 MP.
NR_STRONG = (0.8, 0.6)


# Phase 13 (the rest of the develop document): config 3 with lens flare
# and a 33^3 .cube LUT that the script writes (`write_cube`) and parses
# through io/lut.parse_lut_file.
FLARE_LUT_DOC = dict(CONFIG3_DOC, flareAmount=50, lutPath="phase13.cube", lutIntensity=80)
LUT_SIZE = 33
# config 5 at two NR strengths: a batch of mixed amounts takes the
# per-pixel NR path (per-image scalars)
MIXED_NR_DOCS = (CONFIG5_DOC, dict(CONFIG5_DOC, lumaNoiseReduction=60, colorNoiseReduction=45))


def write_cube(path, size: int = LUT_SIZE) -> None:
    """A .cube film look: a warm split tone and a soft S-curve on a
    size^3 lattice (red fastest, six decimals), from a fixed formula."""
    ax = np.linspace(0.0, 1.0, size)
    b, g, r = np.meshgrid(ax, ax, ax, indexing="ij")  # .cube order: r fastest
    lum = 0.2126 * r + 0.7152 * g + 0.0722 * b
    s = lum + 0.12 * np.sin(2.0 * np.pi * lum) / (2.0 * np.pi)
    out = np.stack([r + 0.06 * (1.0 - lum) * lum + (s - lum),
                    g + 0.01 * np.sin(3.0 * b) + (s - lum),
                    b - 0.05 * lum + (s - lum)], -1).reshape(-1, 3)
    lines = [f"TITLE \"phase 13 look\"", f"LUT_3D_SIZE {size}"]
    lines += [f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in np.clip(out, 0.0, 1.0)]
    Path(path).write_text("\n".join(lines) + "\n")


def _radial(h: int, w: int, adjustments: dict) -> dict:
    return {"visible": True, "adjustments": adjustments, "subMasks": [{
        "type": "radial", "visible": True, "mode": "additive",
        "parameters": {"centerX": w * 0.45, "centerY": h * 0.5, "radiusX": w * 0.22,
                       "radiusY": h * 0.28, "rotation": 15.0, "feather": 0.6}}]}


def masked_nr_doc(h: int, w: int) -> dict:
    """Config 5 with a radial mask that carries its own NR: the amounts
    become per-pixel maps (the per-pixel NR path)."""
    return dict(CONFIG5_DOC, masks=[_radial(h, w, {"lumaNoiseReduction": 60,
                                                   "colorNoiseReduction": 50})])


def flare_mask_doc(h: int, w: int) -> dict:
    """FLARE_LUT_DOC with a radial mask that adds flare (and exposure)."""
    return dict(FLARE_LUT_DOC, masks=[_radial(h, w, {"flareAmount": 40, "exposure": 0.2})])


def config4_doc(h: int = 4096, w: int = 6144) -> dict:
    """BASELINE config 4 (`bench.py`'s `_CONFIG4_DOC`): local adjustments —
    radial + linear + brush masks, each with its own adjustment stack, over
    a light global grade. At 4096 x 6144 it is bench.py's literal; at other
    sizes the mask geometry scales with the frame (the brush size and the
    gradient's range with its width)."""
    k = w / 6144
    return {
        "exposure": 0.2,
        "contrast": 10,
        "toneMapper": "agx",
        "masks": [
            {
                "name": "sky", "visible": True,
                "adjustments": {"exposure": -0.8, "saturation": 15, "contrast": 10},
                "subMasks": [{
                    "type": "linear", "visible": True, "mode": "additive",
                    "parameters": {"startX": 0, "startY": 0, "endX": 0,
                                   "endY": h * 0.45, "range": 40 * k},
                }],
            },
            {
                "name": "face", "visible": True,
                "adjustments": {"exposure": 0.6, "shadows": 20},
                "subMasks": [{
                    "type": "radial", "visible": True, "mode": "additive",
                    "parameters": {"centerX": w * 0.6, "centerY": h * 0.55,
                                   "radiusX": w * 0.12, "radiusY": h * 0.16,
                                   "rotation": 10.0, "feather": 0.5},
                }],
            },
            {
                "name": "dodge", "visible": True,
                "adjustments": {"exposure": 0.4, "clarity": 20},
                "subMasks": [{
                    "type": "brush", "visible": True, "mode": "additive",
                    "parameters": {"lines": [{
                        "points": [{"x": w * 0.2, "y": h * 0.7},
                                   {"x": w * 0.35, "y": h * 0.75},
                                   {"x": w * 0.5, "y": h * 0.72}],
                        "brushSize": 600.0 * k, "feather": 0.5,
                    }]},
                }],
            },
        ],
    }


CONFIG4_DOC = config4_doc()


def mask_stage_doc(h: int, w: int) -> dict:
    """Five masks that turn on every mask stage of the grade: sharpness (one
    mask sharpens, one softens), HSL, colour grading and curves, and blend
    every field the grade reads (exposure ... hue). Their shapes cover
    radial, linear, brush and "all" sub-masks, the additive, subtractive
    and intersect modes, an inverted subtractive sub-mask, an inverted mask
    and opacities."""

    def radial(cx, cy, rx, ry, **kw):
        return {"type": "radial", "visible": True, "mode": "additive",
                "parameters": {"centerX": w * cx, "centerY": h * cy, "radiusX": w * rx,
                               "radiusY": h * ry, "rotation": 20.0, "feather": 0.6}, **kw}

    def linear(y0, y1, **kw):
        return {"type": "linear", "visible": True, "mode": "additive",
                "parameters": {"startX": 0, "startY": h * y0, "endX": w * 0.1,
                               "endY": h * y1, "range": w * 0.05}, **kw}

    curve = [{"x": 0, "y": 12}, {"x": 96, "y": 80}, {"x": 200, "y": 220}, {"x": 255, "y": 245}]
    return {
        "exposure": 0.1, "contrast": 8, "toneMapper": "agx",
        "masks": [
            {"visible": True, "opacity": 90,
             "adjustments": {"sharpness": 45, "exposure": 0.3, "highlights": -30,
                             "whites": 12, "blacks": -10, "temperature": 12, "tint": -6},
             "subMasks": [radial(0.5, 0.5, 0.3, 0.35)]},
            {"visible": True,
             "adjustments": {"hsl": {"reds": {"hue": 12, "saturation": 25, "luminance": -8},
                                     "blues": {"hue": -10, "saturation": 15, "luminance": 6}},
                             "brightness": 18, "vibrance": 25, "hue": 9, "sharpness": -30},
             "subMasks": [linear(0.0, 0.5),
                          radial(0.3, 0.3, 0.1, 0.1, mode="subtractive", invert=True,
                                 opacity=60)]},
            {"visible": True,
             "adjustments": {"colorGrading": {
                 "shadows": {"hue": 210, "saturation": 40, "luminance": 6},
                 "highlights": {"hue": 40, "saturation": 30, "luminance": -4},
                 "balance": 15, "blending": 60},
                 "dehaze": 12, "structure": 18, "glowAmount": 25, "contrast": 12},
             "subMasks": [{"type": "all", "visible": True, "mode": "additive"},
                          radial(0.7, 0.6, 0.15, 0.2, mode="subtractive")]},
            {"visible": True, "invert": True,
             "adjustments": {"curves": {"luma": curve, "red": curve[::2] + curve[-1:]},
                             "halationAmount": 30, "shadows": 30, "saturation": -15},
             "subMasks": [radial(0.4, 0.6, 0.25, 0.2)]},
            {"visible": True,
             "adjustments": {"clarity": 25, "exposure": -0.25, "saturation": 20,
                             "curves": {"luma": curve[::-1][:2] + curve[2:]}},
             "subMasks": [
                 {"type": "brush", "visible": True, "mode": "additive",
                  "parameters": {"lines": [
                      {"points": [{"x": w * 0.1, "y": h * 0.8}, {"x": w * 0.6, "y": h * 0.85}],
                       "brushSize": w * 0.08, "feather": 0.5},
                      {"points": [{"x": w * 0.3, "y": h * 0.82}], "brushSize": w * 0.03,
                       "feather": 0.3, "tool": "eraser"}]}},
                 linear(0.6, 1.0, mode="intersect")]},
        ],
    }

# BASELINE config 2: Bayer RAW develop, RGGB, black 64, white 16383
# (bench.py's _minimal_dng), with bench.py's _bench_raw colour matrix
# (XYZ -> camera) and as-shot white balance, so that neither is the identity.
RAW_XYZ_TO_CAM = ((9000, -3000, -500), (-4000, 12000, 2000), (-500, 2000, 6500))  # / 10000
RAW_AS_SHOT_NEUTRAL = ((10, 21), (1, 1), (20, 31))  # 1 / (2.1, 1.0, 1.55)
RAW_BLACK, RAW_WHITE = 64, 16383


# Phase 14's capture metadata (the export copies it, GPS stripped): IFD0's
# Make, Model and DateTime, the Exif IFD's DateTimeOriginal and exposure,
# and a GPS IFD.
EXPORT_META = {"make": "RapidRAW", "model": "Synthetic H100", "taken": "2024:05:17 09:41:07",
               "lat": (52, 31, 1234), "lon": (13, 24, 5678)}


def exif_entries(meta: dict) -> list:
    """IFD0 entries (tiff_bytes' form) of `meta`: Make, Model, DateTime, an
    Exif IFD (DateTimeOriginal, ExposureTime 1/125, FNumber 2.8, ISO 400)
    and a GPS IFD (version 2.3, latitude, longitude, altitude 34.5 m)."""
    import struct

    def rat(*pairs):
        return b"".join(struct.pack("<II", a, b) for a, b in pairs)

    def dms(d, m, s100):
        return rat((d, 1), (m, 1), (s100, 100))

    exif = [(36867, 2, meta["taken"]), (33434, 5, rat((1, 125))), (33437, 5, rat((28, 10))),
            (34855, 3, [400])]
    gps = [(0, 1, bytes([2, 3, 0, 0])), (1, 2, "N"), (2, 5, dms(*meta["lat"])), (3, 2, "E"),
           (4, 5, dms(*meta["lon"])), (6, 5, rat((345, 10)))]
    return [(271, 2, meta["make"]), (272, 2, meta["model"]), (306, 2, meta["taken"]),
            (34665, 4, ("ifd", exif)), (34853, 4, ("ifd", gps))]


def pack_msb(cfa: np.ndarray, bits: int) -> bytes:
    """MSB-first bit packing of (H, W) samples, rows padded to a byte (TIFF
    6.0, as DNG packs 10/12/14-bit CFAs), vectorized: a group of g samples
    fills g * bits / 8 whole bytes."""
    g = {10: 4, 12: 2, 14: 4, 16: 1}[bits]
    h, w = cfa.shape
    if w % g:
        raise ValueError(f"width {w} is not a multiple of {g}")
    v = np.zeros((h, w // g), np.uint64)
    for k in range(g):
        v = (v << np.uint64(bits)) | cfa[:, k::g].astype(np.uint64)
    nbytes = g * bits // 8
    out = np.stack([(v >> np.uint64(8 * (nbytes - 1 - i))) & np.uint64(0xFF)
                    for i in range(nbytes)], axis=-1)
    return out.astype(np.uint8).tobytes()


def raw_dng_bytes(cfa: np.ndarray, bits: int = 16, orientation: int = 1,
                  ljpeg_tile: int = 0, meta: dict | None = None) -> bytes:
    """A single-IFD RGGB CFA DNG: bench.py's _minimal_dng (black 64, white
    16383) plus ColorMatrix2, AsShotNeutral and Orientation. Uncompressed
    in one strip (`bits` 16: little-endian u16; 10/12/14: bit-packed), or
    with `ljpeg_tile` = t lossless-JPEG t x t tiles (Compression 7), which
    needs a CFA that repeats its top-left tile: every TileOffsets entry
    points at that tile's one stream. With `meta` (EXPORT_META's keys), a
    camera's layout instead: IFD0 an 8-bit RGB preview with the capture
    metadata (`exif_entries`) and the raw IFD a SubIFD of it (strips only)."""
    import struct

    h, w = cfa.shape
    if meta is not None:
        if ljpeg_tile:
            raise ValueError("a DNG with capture metadata is written in strips")
        payload = cfa.astype("<u2").tobytes() if bits == 16 else pack_msb(cfa, bits)
        raw = [(254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [1]),
               (262, 3, [32803]), (273, 4, ("blob", payload)), (277, 3, [1]), (278, 4, [h]),
               (279, 4, [len(payload)]), (33422, 1, bytes([0, 1, 1, 2])),
               (50714, 3, [RAW_BLACK]), (50717, 4, [RAW_WHITE])]
        th, tw = max(1, h // 64), max(1, w // 64)
        thumb = (cfa[::h // th, ::w // tw][:th, :tw, None] >> 6).clip(0, 255).astype(np.uint8)
        thumb = np.repeat(thumb, 3, axis=2).tobytes()
        srational = b"".join(struct.pack("<ii", v, 10000) for row in RAW_XYZ_TO_CAM for v in row)
        rational = b"".join(struct.pack("<II", a, b) for a, b in RAW_AS_SHOT_NEUTRAL)
        ifd0 = [(254, 4, [1]), (256, 4, [tw]), (257, 4, [th]), (258, 3, [8, 8, 8]),
                (259, 3, [1]), (262, 3, [2]), (273, 4, ("blob", thumb)), (274, 3, [orientation]),
                (277, 3, [3]), (278, 4, [th]), (279, 4, [len(thumb)]), (284, 3, [1]),
                (330, 4, ("ifd", raw)), (50706, 1, bytes([1, 4, 0, 0])),
                (50722, 10, srational), (50728, 5, rational), *exif_entries(meta)]
        return tiff_bytes([ifd0])
    if ljpeg_tile:
        t = ljpeg_tile
        n = (h // t) * (w // t)
        if h % t or w % t or not np.array_equal(np.tile(cfa[:t, :t], (h // t, w // t)), cfa):
            raise ValueError(f"an LJPEG DNG here repeats one {t}x{t} tile over the frame")
        payload = ljpeg_encode(cfa[:t, :t])
        layout = [(258, 3, 1, 16), (259, 3, 1, 7), (322, 3, 1, t), (323, 3, 1, t),
                  (324, 4, n, "data"), (325, 4, n, struct.pack(f"<{n}I", *[len(payload)] * n))]
    else:
        n = 1
        payload = cfa.astype("<u2").tobytes() if bits == 16 else pack_msb(cfa, bits)
        layout = [(258, 3, 1, bits), (259, 3, 1, 1), (273, 4, 1, "data"), (278, 4, 1, h),
                  (279, 4, 1, len(payload))]
    srational = b"".join(struct.pack("<ii", v, 10000) for row in RAW_XYZ_TO_CAM for v in row)
    rational = b"".join(struct.pack("<II", a, b) for a, b in RAW_AS_SHOT_NEUTRAL)
    entries = sorted(layout + [  # (tag, type, count, value: int, bytes or "data")
        (256, 4, 1, w), (257, 4, 1, h), (262, 3, 1, 32803), (274, 3, 1, orientation),
        (277, 3, 1, 1), (33422, 1, 4, bytes([0, 1, 1, 2])), (50706, 1, 4, bytes([1, 4, 0, 0])),
        (50714, 3, 1, RAW_BLACK), (50717, 4, 1, RAW_WHITE),
        (50722, 10, 9, srational), (50728, 5, 3, rational),
    ])
    ifd_end = 8 + 2 + 12 * len(entries) + 4
    extra_len = sum(4 * cnt if val == "data" else len(val) for _, _, cnt, val in entries
                    if (val == "data" and cnt > 1) or (isinstance(val, bytes) and len(val) > 4))
    data_off = ifd_end + extra_len
    out = bytearray(b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", len(entries)))
    extra = bytearray()
    for tag, typ, cnt, val in entries:
        if val == "data":
            val = struct.pack(f"<{cnt}I", *[data_off] * cnt) if cnt > 1 else data_off
        if isinstance(val, bytes) and len(val) > 4:
            out += struct.pack("<HHII", tag, typ, cnt, ifd_end + len(extra))
            extra += val
        elif isinstance(val, bytes):
            out += struct.pack("<HHI", tag, typ, cnt) + val.ljust(4, b"\0")
        else:
            out += struct.pack("<HHI", tag, typ, cnt) + struct.pack(
                "<H" if typ == 3 else "<I", val).ljust(4, b"\0")
    out += struct.pack("<I", 0) + extra + payload
    return bytes(out)


def raw_raf_bytes(cfa: np.ndarray, xtrans: np.ndarray, wb_grb=(300, 450, 520)) -> bytes:
    """An uncompressed Fujifilm RAF: the magic, the directory, a CFA header
    of records 0x0100 (height, width), 0x0131 (the 6 x 6 X-Trans layout)
    and 0x2FF0 (white balance, G R B), then the bare little-endian 16-bit
    CFA block (libopenraw's layout; the parser reads 14-bit white)."""
    import struct

    h, w = cfa.shape
    recs = [(0x0100, struct.pack(">HH", h, w)),
            (0x0131, bytes(int(v) for v in np.asarray(xtrans).reshape(-1))),
            (0x2FF0, struct.pack(">HHHH", *wb_grb, 0))]
    hdr = struct.pack(">I", len(recs)) + b"".join(
        struct.pack(">HH", tag, len(rec)) + rec for tag, rec in recs)
    payload = cfa.astype("<u2").tobytes()
    cfa_hdr_off = 0x6C
    pre = (b"FUJIFILMCCD-RAW 0201" + b"\0" * (0x54 - 20) + struct.pack(">II", 0, 0)
           + struct.pack(">II", cfa_hdr_off, len(hdr))
           + struct.pack(">II", cfa_hdr_off + len(hdr), len(payload)))
    return pre + hdr + payload


# ---- vendor RAW files (phase 12) ---------------------------------------------
# Writers of the vendor containers the port decodes. The four 24 MP files'
# bitstreams (CR2's lossless JPEG, NEF 34713, ARW2, CR3's crx) and PEF's,
# ORF's and MRW's are written vectorized, each byte for byte as the repo's
# test encoder (tests/test_raw_containers.py, tests/test_native_ljpeg.py)
# writes it sample by sample; the ORF predictive, Panasonic and Phase One
# row streams are sequential codecs written sample by sample, as the test
# encoders do, at a reduced size.


def photo_cfa(h: int, w: int, lo: float, hi: float, seed: int, noise: float = 3.0) -> np.ndarray:
    """A (h, w) u16 CFA with a photograph's statistics: a smooth field from
    `seed` (four low-frequency waves and three soft highlights) spanning
    [lo, hi], a different gain on each Bayer channel, plus Gaussian noise of
    `noise` DN."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    f = np.zeros((h, w), np.float32)
    for _ in range(4):
        fy, fx, py, px, a = rng.uniform((0.5, 0.5, 0, 0, 0.3), (3, 3, 2 * np.pi, 2 * np.pi, 1))
        f += np.float32(a) * (np.sin(np.float32(2 * np.pi * fy) * y + np.float32(py))
                              * np.cos(np.float32(2 * np.pi * fx) * x + np.float32(px)))
    for _ in range(3):
        cy, cx, s, a = rng.uniform((0.1, 0.1, 0.05, 0.5), (0.9, 0.9, 0.2, 1.5))
        f += np.float32(a) * np.exp(((y - np.float32(cy)) ** 2 + (x - np.float32(cx)) ** 2)
                                    * np.float32(-0.5 / (s * s)))
    f = (f - f.min()) / (f.max() - f.min())
    g = rng.uniform(0.45, 1.0, 3).astype(np.float32)  # R, G, B
    gain = np.array([[g[0], g[1]], [g[1], g[2]]], np.float32)  # RGGB sites
    f *= np.tile(gain, (h // 2 + 1, w // 2 + 1))[:h, :w]
    f = np.float32(lo) + np.float32(hi - lo) * f
    f += np.float32(noise) * rng.standard_normal((h, w), dtype=np.float32)
    return np.clip(np.rint(f), 0, 65535).astype(np.uint16)


def pack_bits(words: np.ndarray, nbits: np.ndarray, pad: int = 1) -> bytes:
    """words[i] in nbits[i] bits each, MSB first, concatenated and padded to
    a whole byte with `pad` bits (vectorized in chunks of 1 M words)."""
    words = np.asarray(words, np.int64).reshape(-1)
    nbits = np.asarray(nbits, np.int64).reshape(-1)
    j = np.arange(int(nbits.max(initial=1)))
    chunks = []
    for s in range(0, words.size, 1 << 20):
        wv, nb = words[s:s + (1 << 20), None], nbits[s:s + (1 << 20), None]
        bits = (wv >> np.maximum(nb - 1 - j, 0)) & 1
        chunks.append(bits[j < nb].astype(np.uint8))
    total = sum(c.size for c in chunks)
    chunks.append(np.full((-total) % 8, pad, np.uint8))
    return np.packbits(np.concatenate(chunks)).tobytes()


def category_words(diff: np.ndarray, code: np.ndarray, length: np.ndarray):
    """JPEG-style entropy words of signed differences: the Huffman code of
    the difference's bit length ssss, then ssss bits of the difference
    (negative ones as diff + 2**ssss - 1). Returns (words, nbits)."""
    diff = diff.astype(np.int64).reshape(-1)
    ssss = np.ceil(np.log2(np.abs(diff) + 1)).astype(np.int64)
    value = np.where(diff >= 0, diff, diff + (1 << ssss) - 1)
    return (code[ssss] << ssss) | np.where(ssss > 0, value, 0), length[ssss] + ssss


def canonical_codes(counts, values):
    """(code, length) per symbol of a canonical Huffman table (JPEG DHT
    order: `counts` codes of each length 1..16 for `values` in order)."""
    code_of = np.zeros(17, np.int64)
    len_of = np.zeros(17, np.int64)
    code = k = 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code_of[values[k]], len_of[values[k]] = code, n
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# NEF 34713 lossless 12-bit (tree 2) and PEF 65535 default tables
NIKON_LOSSLESS12 = ([0, 1, 4, 2, 3, 1, 2] + [0] * 9, [5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12])
PENTAX_DEFAULT = ([0, 2, 3, 1, 1, 1, 1, 1, 1, 2] + [0] * 6, [3, 4, 2, 5, 1, 6, 0, 7, 8, 9, 10, 11,
                                                              12])


def vendor_huffman(cfa: np.ndarray, table) -> bytes:
    """The Nikon / Pentax Huffman stream of a CFA (initial vertical
    predictors 0): the first two columns predict from the same column two
    rows up, later ones from two columns left; padded with 1s."""
    s = cfa.astype(np.int64)
    pred = np.zeros_like(s)
    pred[:, 2:] = s[:, :-2]
    pred[2:, :2] = s[:-2, :2]
    return pack_bits(*category_words(s - pred, *canonical_codes(*table)))


def ljpeg_encode(samples: np.ndarray, precision: int = 16, ncomp: int = 1) -> bytes:
    """One lossless-JPEG (SOF3) stream of (H, W * ncomp) u16 samples,
    `ncomp` interleaved components, predictor 1, 17 Huffman symbols of 5
    bits each (code = category), vectorized. The repo's test encoder
    (tests/test_native_ljpeg.py) writes the same stream sample by sample."""
    import struct

    h, wn = samples.shape
    w = wn // ncomp
    s = samples.astype(np.int64).reshape(h, w, ncomp)
    pred = np.empty_like(s)
    pred[:, 1:] = s[:, :-1]
    pred[1:, 0] = s[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    diff = (s - pred) & 0xFFFF
    diff = np.where(diff >= 0x8000, diff - 0x10000, diff)
    # an ssss = 16 difference (-32768) also writes 16 bits, as the test encoder does
    data = np.frombuffer(pack_bits(*category_words(diff, np.arange(17), np.full(17, 5))), np.uint8)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0)  # byte stuffing

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    dht = bytes([0x00] + [0, 0, 0, 0, 17] + [0] * 11 + list(range(17)))
    sof = struct.pack(">BHHB", precision, h, w, ncomp) + b"".join(
        bytes([c, 0x11, 0]) for c in range(ncomp))
    sos = bytes([ncomp]) + b"".join(bytes([c, 0]) for c in range(ncomp)) + bytes([1, 0, 0])
    return (b"\xff\xd8" + seg(0xFFC4, dht) + seg(0xFFC3, sof) + seg(0xFFDA, sos)
            + data.tobytes() + b"\xff\xd9")


def arw2_encode(plane: np.ndarray):
    """Sony ARW2 blocks of (H, W) 11-bit coded samples, W a multiple of 32:
    16 bytes per 16 same-colour pixels of 32 interleaved columns (11-bit
    max and min, their 4-bit positions, 14 7-bit deltas shifted by the
    block's range). Returns (stream, the quantized plane the decoder
    reconstructs). The min's position is the first minimum other than the
    max's, as the test encoder's sort gives it."""
    h, w = plane.shape
    pix = plane.astype(np.int64).reshape(h, w // 32, 16, 2).transpose(0, 1, 3, 2).reshape(-1, 16)
    nb = pix.shape[0]
    idx = np.arange(16)
    imax = pix.argmax(1)
    imin = np.where(idx == imax[:, None], 1 << 20, pix).argmin(1)
    r = np.arange(nb)
    vmax, vmin = pix[r, imax], pix[r, imin]
    sh = sum(((0x80 << s) <= vmax - vmin).astype(np.int64) for s in range(4))
    delta = (pix - vmin[:, None]) >> sh[:, None]
    quant = vmin[:, None] + (delta << sh[:, None])
    quant[r, imin], quant[r, imax] = vmin, vmax
    other = (idx != imax[:, None]) & (idx != imin[:, None])
    deltas = delta[other].reshape(nb, 14)
    bits = np.zeros((nb, 128), np.uint8)
    fields = [(vmax, 0, 11), (vmin, 11, 11), (imax, 22, 4), (imin, 26, 4)] + [
        (deltas[:, k], 30 + 7 * k, 7) for k in range(14)]
    for val, pos, n in fields:
        for i in range(n):
            bits[:, pos + i] = (val >> i) & 1
    stream = np.packbits(bits, axis=1, bitorder="little").tobytes()
    quant = quant.reshape(h, w // 32, 2, 16).transpose(0, 1, 3, 2).reshape(h, w)
    return stream, quant.astype(np.uint16)


def tiff_bytes(chain: list, endian: str = "<", magic_extra: bytes = b"") -> bytes:
    """A TIFF of chained IFDs. An IFD is a list of (tag, type, value):
    value a list of ints (types 1, 3, 4), bytes (stored as given, of any
    type; count in units of the type), a str (type 2), ("ifd", IFD) for a nested IFD's
    offset or ("blob", bytes) for a LONG offset to the bytes."""
    import struct

    ifds = []

    def collect(ifd):
        ifds.append(ifd)
        for _, _, v in ifd:
            if isinstance(v, tuple) and v[0] == "ifd":
                collect(v[1])

    for ifd in chain:
        collect(ifd)
    offs, pos = {}, 8 + len(magic_extra)
    for ifd in ifds:
        offs[id(ifd)] = pos
        pos += 2 + 12 * len(ifd) + 4
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
    head = bytearray((b"II" if endian == "<" else b"MM") + struct.pack(endian + "HI", 42, 8 + len(
        magic_extra)) + magic_extra)
    extra = bytearray()
    for ifd in ifds:
        head += struct.pack(endian + "H", len(ifd))
        for tag, typ, v in sorted(ifd, key=lambda e: e[0]):
            if isinstance(v, tuple):
                if v[0] == "ifd":
                    ref = offs[id(v[1])]
                else:
                    ref = pos + len(extra)
                    extra += v[1]
                head += struct.pack(endian + "HHII", tag, 4, 1, ref)
                continue
            if isinstance(v, str):
                raw = v.encode() + b"\0"
            elif isinstance(v, bytes):
                raw = v
            else:
                raw = b"".join(struct.pack(endian + {1: "B", 3: "H", 4: "I", 7: "B"}[typ], x)
                               for x in v)
            count = len(raw) // size.get(typ, 1)
            if len(raw) > 4:
                head += struct.pack(endian + "HHII", tag, typ, count, pos + len(extra))
                extra += raw
            else:
                head += struct.pack(endian + "HHI", tag, typ, count) + raw.ljust(4, b"\0")
        nxt = chain[chain.index(ifd) + 1] if ifd in chain[:-1] else None
        head += struct.pack(endian + "I", offs[id(nxt)] if nxt is not None else 0)
    return bytes(head + extra)


def rationals(*vals) -> bytes:
    import struct

    return b"".join(struct.pack("<II", round(v * 10000), 10000) for v in vals)


def cfa_ifd(w: int, h: int, bits: int, compression: int, payload: bytes, pattern=(0, 1, 1, 2)):
    """A raw CFA IFD (one strip), as the vendor TIFF containers hold it."""
    return [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits]), (259, 3, [compression]),
            (262, 3, [32803]), (277, 3, [1]), (273, 4, ("blob", payload)), (278, 4, [h]),
            (279, 4, [len(payload)]), (33422, 1, bytes(pattern))]


def canon_makernote(wb_rggb, sensor_info) -> list:
    """Canon makernote IFD: SensorInfo (0xe0: [_, w, h, _, _, left, top,
    right, bottom]) and ColorData (0x4001, 796 shorts, as-shot WB RGGB at 63)."""
    cd = [0] * 796
    cd[63:67] = list(wb_rggb)
    return [(0xE0, 3, list(sensor_info)), (0x4001, 3, cd)]


def cr2_bytes(sensor: np.ndarray, crop, slices=3, wb_rggb=(2150, 1024, 1024, 1590)) -> bytes:
    """Canon CR2: IFD0 (Make, Exif -> makernote) chained to the raw IFD, a
    lossless-JPEG strip of two interleaved 14-bit components holding the
    sensor as `slices` vertical slices one after another (tag 0xc640:
    n - 1 slices of one width and a last one). `crop` = (top, left, bottom,
    right) of the active area in SensorInfo; the masked columns left of
    it give the black level."""
    h, w = sensor.shape
    last = w - (slices - 1) * (-(-w // slices) & ~1)
    width = (w - last) // (slices - 1)
    flat = np.concatenate([sensor[:, c:c + sw].reshape(-1) for c, sw in zip(
        range(0, w, width), [width] * (slices - 1) + [last])])
    stream = ljpeg_encode(flat.reshape(h, w), precision=14, ncomp=2)
    top, left, bottom, right = crop
    mn = canon_makernote(wb_rggb, [0, w, h, 0, 0, left, top, right, bottom])
    exif = [(37500, 4, ("ifd", mn))]
    ifd0 = [(271, 2, "Canon"), (272, 2, "EOS R"), (274, 3, [1]), (34665, 4, ("ifd", exif))]
    raw = [(259, 3, [7]), (273, 4, ("blob", stream)), (279, 4, [len(stream)]),
           (0xC640, 3, [slices - 1, width, last])]
    return tiff_bytes([ifd0, raw], magic_extra=b"CR\x02\x00\0\0\0\0")


def nef_bytes(cfa: np.ndarray, wb=(2.1, 1.55)) -> bytes:
    """Nikon NEF, compression 34713, lossless 12-bit: IFD0 (Make, SubIFD
    -> the raw IFD, Exif -> the 'Nikon' makernote holding an embedded
    big-endian TIFF with LinearizationTable 0x96 (ver 0x46 0x14, vertical
    predictors 0, no curve) and WB_RBLevels 0x0c)."""
    import struct

    h, w = cfa.shape
    stream = vendor_huffman(cfa, NIKON_LOSSLESS12)
    lt = bytes([0x46, 0x14]) + struct.pack(">4H", 0, 0, 0, 0) + struct.pack(">H", 0)
    wbl = b"".join(struct.pack(">II", round(v * 10000), 10000) for v in (*wb, 1.0, 1.0))
    inner = tiff_bytes([[(0x96, 7, lt), (0x0C, 5, wbl)]], endian=">")
    exif = [(37500, 7, b"Nikon\x00\x02\x10\x00\x00" + inner)]
    sub = cfa_ifd(w, h, 12, 34713, stream)
    ifd0 = [(271, 2, "NIKON CORPORATION"), (272, 2, "NIKON Z 6"), (330, 4, ("ifd", sub)),
            (34665, 4, ("ifd", exif))]
    return tiff_bytes([ifd0])


def arw_bytes(coded: np.ndarray, neutral=(1 / 2.1, 1.0, 1 / 1.55)):
    """Sony ARW, ARW2 block compression of 11-bit coded samples (the Sony
    tone curve expands them on decode; black 512 in that space). Returns
    (file, the CFA the decoder must give: the curve of the quantized
    plane)."""
    from rapidraw_tpu_torch.io.makers import _arw2_curve

    h, w = coded.shape
    stream, quant = arw2_encode(coded)
    ifd0 = [(271, 2, "SONY"), (272, 2, "ILCE-7M3"), (50728, 5, rationals(*neutral))]
    data = tiff_bytes([ifd0, cfa_ifd(w, h, 8, 32767, stream)])
    return data, _arw2_curve()[quant.astype(np.int64) << 1].astype(np.uint16)


def cr3_bytes(sensor: np.ndarray, crop, wb_rggb=(2150, 1024, 1024, 1590)) -> bytes:
    """Canon CR3 (ISO BMFF): ftyp 'crx ', moov [ Canon uuid [CMT1 (IFD0),
    CMT3 (makernote: SensorInfo with `crop`, ColorData)], trak [stsd (CRAW
    + CMP1), stsz, stco] ], mdat with the crx lossless 14-bit sample."""
    import struct

    from rapidraw_tpu_torch.io import crx
    from rapidraw_tpu_torch.io.cr3 import CANON_UUID

    def box(btype, payload):
        return struct.pack(">I", 8 + len(payload)) + btype + payload

    h, w = sensor.shape
    sample, cmp1 = crx.encode_raw(sensor, n_bits=14, cfa_layout=0)
    top, left, bottom, right = crop
    cmt1 = tiff_bytes([[(271, 2, "Canon"), (272, 2, "EOS R6"), (274, 3, [1])]])
    cmt3 = tiff_bytes([canon_makernote(wb_rggb, [0, w, h, 0, 0, left, top, right, bottom])])
    cmp1_box = box(b"CMP1", crx.build_cmp1(cmp1))
    entry = struct.pack(">I", 0x56 + len(cmp1_box)) + b"CRAW" + b"\0" * 6
    entry += struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HH", w, h)
    entry = entry.ljust(0x56, b"\0") + cmp1_box
    stsd = box(b"stsd", struct.pack(">II", 0, 1) + entry)
    stsz = box(b"stsz", struct.pack(">III", 0, len(sample), 1))
    canon = box(b"uuid", CANON_UUID + box(b"CMT1", cmt1) + box(b"CMT3", cmt3))
    ftyp = box(b"ftyp", b"crx " + b"\0\0\0\x01" + b"crx isom")

    def head(mdat_at):
        stco = box(b"stco", struct.pack(">III", 0, 1, mdat_at))
        trak = box(b"trak", box(b"mdia", box(b"minf", box(b"stbl", stsd + stsz + stco))))
        return ftyp + box(b"moov", canon + trak)

    at = len(head(0)) + 8  # the sample starts after the mdat box header
    return head(at) + box(b"mdat", sample)


def pef_bytes(cfa: np.ndarray) -> bytes:
    """Pentax PEF, compression 65535 (Pentax Huffman, default table), 12-bit."""
    h, w = cfa.shape
    return tiff_bytes([[(271, 2, "PENTAX Corporation")],
                       cfa_ifd(w, h, 12, 65535, vendor_huffman(cfa, PENTAX_DEFAULT))])


def pack_12le(cfa: np.ndarray) -> bytes:
    """Little-endian 12-bit packing, 2 samples in 3 bytes (Olympus, Nikon)."""
    a = cfa[:, 0::2].astype(np.uint16)
    b = cfa[:, 1::2].astype(np.uint16)
    return np.stack([a & 0xFF, ((a >> 8) & 0xF) | ((b & 0xF) << 4), b >> 4],
                    axis=-1).astype(np.uint8).tobytes()


def orf_bytes(cfa: np.ndarray, payload: bytes | None = None) -> bytes:
    """Olympus ORF ('IIRO' magic): one CFA IFD; the strip is the 12-bit
    little-endian packing of `cfa`, or `payload` (a predictive stream)."""
    h, w = cfa.shape
    data = bytearray(tiff_bytes([cfa_ifd(w, h, 12, 1, pack_12le(cfa) if payload is None
                                         else payload)]))
    data[2:4] = b"RO"
    return bytes(data)


def orf_predictive(h: int, w: int, rng):
    """The Olympus predictive stream of a (h, w) frame the stream itself
    drives (random low bits and signs from `rng`, as the test encoder
    draws them), sample by sample. Returns (stream, expected plane)."""
    bits = []
    expected = np.zeros((h, w), np.int64)
    for row in range(h):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(w):
            carry = acarry[col & 1]
            i = 2 * (carry[2] < 3)
            nbits = 2 + i
            while (carry[0] & 0xFFFF) >> (nbits + i):
                nbits += 1
            if row < 2 and col < 2:
                pred = 0
            elif row < 2:
                pred = int(expected[row, col - 2])
            elif col < 2:
                pred = int(expected[row - 2, col])
            else:
                wv, nv, nw = (int(expected[row, col - 2]), int(expected[row - 2, col]),
                              int(expected[row - 2, col - 2]))
                if (wv < nw < nv) or (nv < nw < wv):
                    pred = wv + nv - nw if abs(wv - nw) > 32 or abs(nv - nw) > 32 \
                        else (wv + nv) >> 1
                else:
                    pred = wv if abs(wv - nw) > abs(nv - nw) else nv
            low = int(rng.integers(0, 4))
            for _ in range(50):
                c0 = int(rng.integers(0, min(48, (12 << nbits) - 1)))
                sign_bit = int(rng.integers(0, 2))
                diff = (c0 ^ -sign_bit) + carry[1]
                pix = pred + ((diff << 2) | low)
                if 0 <= pix < (1 << 12):
                    break
            else:
                sign_bit, c0, diff = 0, 0, carry[1]
                pix = min(max(pred + ((diff << 2) | low), 0), (1 << 12) - 1)
            high = c0 >> nbits
            for v, n in ((sign_bit << 2 | low, 3), (1, high + 1),
                         (c0 & ((1 << nbits) - 1), nbits)):
                bits.extend((v >> k) & 1 for k in range(n - 1, -1, -1))
            carry[0] = c0
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if carry[0] > 16 else carry[2] + 1
            expected[row, col] = pix
    bits.extend([0] * (-len(bits) % 8))
    return b"\0" * 7 + np.packbits(np.array(bits, np.uint8)).tobytes(), \
        expected.astype(np.uint16)


def rw2_stream(h: int, w: int, rng):
    """The Panasonic 12-bit bitstream of a (h, w) frame the stream drives
    (random seeds and deltas from `rng`, as the test encoder draws them),
    sample by sample: LSB-first bits at a down-counting cursor in
    0x4000-byte sections, each stored with its halves swapped. Every
    14-pixel block takes 128 bits, so `w` is a multiple of 14 and blocks
    never straddle a section. Returns (stream, expected plane)."""
    if w % 14:
        raise ValueError(f"width {w} is not a multiple of 14")
    sections = [bytearray(0x4001)]
    a = [0x20000]

    def put(v, n):
        if a[0] == 0:  # the next section: 1024 blocks of 128 bits fill one
            sections.append(bytearray(0x4001))
            a[0] = 0x20000
        a[0] -= n
        buf = sections[-1]
        idx = (a[0] // 8) ^ 0x3FF0
        word = (buf[idx] | (buf[idx + 1] << 8)) | ((v & ((1 << n) - 1)) << (a[0] % 8))
        buf[idx], buf[idx + 1] = word & 0xFF, (word >> 8) & 0xFF

    expected = np.zeros((h, w), np.uint16)
    for row in range(h):
        pred, nonz, sh = [0, 0], [0, 0], 0
        for col in range(w):
            i = col % 14
            if i == 0:
                pred, nonz = [0, 0], [0, 0]
            if i % 3 == 2:
                b = int(rng.integers(0, 4))
                put(b, 2)
                sh = 4 >> (3 - b)
            if nonz[i & 1]:
                j = int(rng.integers(0, 256))
                put(j, 8)
                if j:
                    pred[i & 1] -= 0x80 << sh
                    if pred[i & 1] < 0 or sh == 4:
                        pred[i & 1] &= ~(-1 << sh)
                    pred[i & 1] += j << sh
            else:
                nz = int(rng.integers(1, 256))
                put(nz, 8)
                nonz[i & 1] = nz
                lo = int(rng.integers(0, 16))
                put(lo, 4)
                pred[i & 1] = nz << 4 | lo
            expected[row, col] = pred[col & 1] & 0xFFFF
    return b"".join(bytes(s[0x2008:0x4000]) + bytes(s[0:0x2008]) for s in sections), expected


def rw2_bytes(stream: bytes, h: int, w: int, crop=(2, 4), black=143, wb=(520, 263, 410)) -> bytes:
    """Panasonic RW2 ('IIU\\0' magic): IFD0 with the PanasonicRaw sensor
    tags (size, borders cropping `crop` rows / columns, RGGB, 12 bits,
    black, WB levels) and the offset of the bitstream."""
    top, left = crop
    ifd = [(0x0001, 1, bytes([4, 0, 0, 0])), (0x0002, 3, [w]), (0x0003, 3, [h]),
           (0x0004, 3, [top]), (0x0005, 3, [left]), (0x0006, 3, [h]), (0x0007, 3, [w]),
           (0x0009, 3, [1]), (0x000A, 3, [12]), (0x001C, 3, [black]), (0x001D, 3, [black]),
           (0x001E, 3, [black]), (0x0024, 3, [wb[0]]), (0x0025, 3, [wb[1]]),
           (0x0026, 3, [wb[2]]), (0x0118, 4, ("blob", stream))]
    data = bytearray(tiff_bytes([ifd]))
    data[2:4] = b"U\0"
    return bytes(data)


def mrw_bytes(cfa: np.ndarray, gains=(320, 256, 256, 448)) -> bytes:
    """Minolta MRW: the PRD (sensor) and WBG (gains) blocks, then the CFA
    packed 12-bit big-endian, RGGB."""
    import struct

    h, w = cfa.shape
    prd = (b"27730001" + struct.pack(">HHHH", h, w, h, w) + bytes([12, 12, 0x59, 0])
           + struct.pack(">HH", 0, 0x0001))
    wbg = bytes([0, 0, 0, 0]) + struct.pack(">HHHH", *gains)
    blocks = (b"\x00PRD" + struct.pack(">I", len(prd)) + prd
              + b"\x00WBG" + struct.pack(">I", len(wbg)) + wbg)
    return b"\x00MRM" + struct.pack(">I", len(blocks)) + blocks + pack_msb(cfa, 12)


def srw_bytes(cfa: np.ndarray) -> bytes:
    """Samsung SRW on the generic TIFF-CFA path: IFD0 an RGB preview with
    Make and the Samsung WB levels 0xa021 and black 0xa028, chained to a
    16-bit raw IFD without a CFA tag (RGGB)."""
    h, w = cfa.shape
    ifd0 = [(256, 3, [64]), (257, 3, [48]), (258, 3, [8, 8, 8]), (277, 3, [3]), (259, 3, [1]),
            (273, 4, ("blob", bytes(64 * 48 * 3))), (279, 4, [64 * 48 * 3]),
            (271, 2, "SAMSUNG"), (0xA021, 4, [1150, 512, 512, 900]), (0xA028, 4, [128, 0, 0, 0])]
    raw = [(256, 3, [w]), (257, 3, [h]), (258, 3, [16]), (277, 3, [1]), (259, 3, [1]),
           (273, 4, ("blob", cfa.astype("<u2").tobytes())), (279, 4, [cfa.size * 2])]
    return tiff_bytes([ifd0, raw])


# Phase One length codes: length -> (index j, extra bit); j < 4 is written
# as j + 1 zeros and a one, j = 4 as five zeros and no one (the reader's
# unary scan stops at 5)
IIQ_LEN_CODE = {8: (0, 0), 7: (0, 1), 6: (1, 0), 9: (1, 1), 11: (2, 0), 10: (2, 1), 5: (3, 0),
                12: (3, 1), 14: (4, 0), 13: (4, 1)}
IIQ_LENS = sorted(k for k in IIQ_LEN_CODE if k != 14)


def iiq_row(values: np.ndarray, lens: list) -> bytes:
    """One Phase One compressed row, little-endian words, sample by sample
    (the test encoder's `_encode_row`): per group of 8, per column parity
    the shortest code length covering its differences (a 1 bit when it
    repeats the parity's last one, which carries over rows), then the 8
    samples as offset differences, or raw 16 bits at length 14."""
    out = []

    def put(v, n):
        if n:
            out.append(format(v & ((1 << n) - 1), f"0{n}b"))

    width = len(values)
    tail = width & ~7
    pred = [0, 0]
    for g0 in range(0, tail, 8):
        for i in (0, 1):
            p, need = pred[i], 5
            for v in values[g0 + i:g0 + 8:2]:
                d = int(v) - p
                p = int(v)
                while need < 14 and not (1 - (1 << (need - 1)) <= d <= (1 << (need - 1))):
                    need = next((n for n in IIQ_LENS if n > need), 14)
            if need == lens[i]:
                put(1, 1)
            else:
                zeros, bit = IIQ_LEN_CODE[need]
                if zeros < 4:
                    put(0, zeros + 1)
                    put(1, 1)
                else:
                    put(0, 5)
                put(bit, 1)
                lens[i] = need
        for col in range(g0, g0 + 8):
            i = col & 1
            v = int(values[col])
            put(v, 16) if lens[i] == 14 else put(v - pred[i] - 1 + (1 << (lens[i] - 1)), lens[i])
            pred[i] = v
    for col in range(tail, width):
        put(int(values[col]), 16)
    if tail < width:
        lens[0] = lens[1] = 14
    bits = "".join(out)
    bits += "0" * (-len(bits) % 32)
    return b"".join(int(bits[i:i + 32], 2).to_bytes(4, "little") for i in range(0, len(bits), 32))


def iiq_bytes(pred: np.ndarray, black: int = 64, wb=(2.25, 1.0, 1.4375), romm=None) -> bytes:
    """Phase One IIQ, format 5, little-endian: the 'IIII' raw directory
    (sensor size, format, black, WB floats, optional ROMM matrix, row
    offsets, the XOR keys) over the compressed rows, wrapped in a TIFF whose
    IFD0 holds the Make. The layout of the test writer `_build_iiq`."""
    import struct

    raw_h, raw_w = pred.shape
    payload = bytearray()

    def add(b: bytes) -> int:
        off = 12 + len(payload)
        payload.extend(b)
        return off

    wb_off = add(struct.pack("<3f", *wb))
    romm_off = add(struct.pack("<9f", *np.asarray(romm, np.float64).ravel())) if romm is not None \
        else 0
    lens = [0, 0]
    rows = [iiq_row(pred[r], lens) for r in range(raw_h)]
    strip_off = add(np.cumsum([0] + [len(b) for b in rows[:-1]]).astype("<u4").tobytes())
    data_off = add(b"".join(rows))
    entries = [(0x108, 4, raw_w), (0x109, 4, raw_h), (0x10A, 4, 0), (0x10B, 4, 0),
               (0x10C, 4, raw_w), (0x10D, 4, raw_h), (0x10E, 4, 5), (0x10F, 4, data_off),
               (0x21D, 4, black), (0x107, 12, wb_off)]
    if romm_off:
        entries.append((0x106, 36, romm_off))
    entries += [(0x21C, 4 * raw_h, strip_off), (0x222, 4, 0), (0x224, 4, 0),
                (0x112, 4, struct.unpack("<I", struct.pack("<HH", 0xA5A5, 0x3C3C))[0])]
    blob = (b"IIII" + struct.pack("<I", (0x526177 << 8) | 0x55)
            + struct.pack("<I", 12 + len(payload)) + payload
            + struct.pack("<II", len(entries), 0)
            + b"".join(struct.pack("<IIII", tag, 4, n, word) for tag, n, word in entries))
    ifd0_off = 8 + len(blob)
    make = b"Phase One A/S\0"
    return (b"II*\0" + struct.pack("<I", ifd0_off) + blob + struct.pack("<H", 1)
            + struct.pack("<HHII", 271, 2, len(make), ifd0_off + 2 + 12 + 4)
            + struct.pack("<I", 0) + make)

DOCS = {"config1": (CONFIG1_DOC, False), "config3": (CONFIG3_DOC, False),
        "full": (FULL_DOC, False), "grain": (GRAIN_DOC, False), "raw": (RAW_DOC, True)}

BLUR_TOL = 1e-5          # fp32 both sides; only the summation order differs
GRADE_TOL = 2e-4         # dither off: the JAX fused-vs-XLA bound (test_fused.py)
# dither on: a last-ulp difference in the hash's fract can move one dither
# value by up to 1/255, so the bound adds one quantization step
GRADE_DITHER_TOL = 2e-4 + 1.0 / 255.0
NR_TOL = 2e-4            # the JAX kernel-vs-XLA bound; a gate can flip on one ulp
RESAMPLE_TOL = 1e-6      # the same lerp of the same two rows
XTRANS_TOL = 1e-5        # the X-Trans front end's module tolerance (tests/test_torch_raw.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median ms per call over `reps` timed calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# aten ops that only move, view or make data: not counted as operations
_MOVES = ("view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "select",
          "slice", "unsqueeze", "squeeze", "as_strided", "alias", "detach", "clone", "copy_",
          "_to_copy", "contiguous", "empty", "empty_like", "empty_strided", "zeros",
          "zeros_like", "ones", "ones_like", "full", "full_like", "fill_", "arange", "stack",
          "cat", "constant_pad_nd", "replication_pad2d", "pad", "index", "index_select",
          "gather", "repeat_interleave", "lift_fresh", "_local_scalar_dense", "unbind",
          "split", "flip", "rot90", "lift_fresh_copy", "scalar_tensor", "_reshape_alias")


def count_ops(fn):
    """(result, operations) of a plain PyTorch version: the output elements
    of every arithmetic aten op it runs on these inputs (a comparison, a
    select and an exp each count as one), and 2 * taps per output of a
    convolution. Data movement (views, copies, pads, gathers) counts zero."""
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name in ("convolution", "conv2d", "cudnn_convolution"):
                taps = args[1].shape[2] * args[1].shape[3]
                total[0] += 2 * out.numel() * taps
            elif name in ("amin", "amax", "sum", "min", "max", "any", "all") and args:
                total[0] += args[0].numel()
            elif name not in _MOVES and isinstance(out, torch.Tensor):
                total[0] += out.numel()
            return out

    with Counter():
        res = fn()
    return res, total[0]


def ptxas_usage(log: str) -> tuple:
    """(registers, spill bytes) of one source from nvcc -Xptxas -v: the most
    registers any of its kernels uses, and their spill stores and loads summed."""
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return max(regs, default=None), sum(int(a) + int(b) for a, b in spills)


def ptxas_entries(log: str) -> dict:
    """{kernel: (registers, spill bytes)} of one source from nvcc -Xptxas -v,
    each entry by its name (a template's arguments mangled after it: grade
    build `grade_kernelILi4ELb1E`), spill stores and loads summed."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        pos, name = (3 if mangled.startswith("_ZN") else 2), mangled
        while pos < len(mangled) and mangled[pos].isdigit():
            n = re.match(r"\d+", mangled[pos:]).group()
            pos += len(n)
            name, pos = mangled[pos:pos + int(n)], pos + int(n)
        if mangled[pos:pos + 1] == "I":
            name += mangled[pos:mangled.index("EE", pos) + 1]
        out[name] = (int(regs.group(1)) if regs else None,
                     sum(map(int, spills.groups())) if spills else 0)
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_run(label, run, out_dir, card) -> None:
    """Kernel time by name and the device busy share over three runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side op rows repeat their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
    log(f"[profile] {label} x3: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100.0 * busy / wall_us:.1f}%), of which copies "
        f"{copies / 1e3:.2f} ms, kernels {(busy - copies) / 1e3:.2f} ms "
        f"({100.0 * (busy - copies) / wall_us:.1f}%) [{card}]")
    for dev_us, key, count in rows[:10]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<3d} {key[:90]}")
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(out_dir) / f"trace_{label.split()[0]}.json"))


def median_host_ms(fn, reps: int) -> float:
    """Median host-clock ms of `reps` calls of fn, each ended by a device sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_raw(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 11, config 2: a RAW file through the port's entry points.

    Writes an RGGB DNG of random u16 samples from a seed (bench.py's range
    64..16383), a 14-bit bit-packed copy, an Orientation = 6 copy and a
    lossless-JPEG tiled file, then load_image (host parse, u16 upload,
    front end, enhance on the card) -> parse_adjustments(is_raw=True) ->
    stack_params -> develop_batch -> device_u8 -> host numpy for B = 1, 2
    on `{}` and CONFIG3_DOC, and the fast thumbnail path, counters reset
    and read around each. Times each stage apart, holds the blur and grade
    kernels against their plain versions on the RAW images, and checks a
    1024 x 1536 file on the card against the plain CPU path. Then the same
    for an X-Trans RAF. Returns ({path: launches}, {(kernel, path):
    numbers})."""
    import tempfile

    from rapidraw_tpu_torch import (
        develop_batch,
        device_u8,
        load_image,
        parse_adjustments,
        parse_raw,
        stack_params,
    )
    from rapidraw_tpu_torch.io import dng as dng_io
    from rapidraw_tpu_torch.ops import blur
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.raw import demosaic, xtrans
    from rapidraw_tpu_torch.raw.enhance import remove_raw_artifacts_and_enhance
    from rapidraw_tpu_torch.tools import PEAK_BYTES, bound_ms
    from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings

    nr_amount, sharpening = AppSettings(DEFAULTS).preprocessing_amounts()
    docs = {"empty": {}, "config3": CONFIG3_DOC}
    rng = np.random.default_rng(2)
    launches, report = {}, {}

    def run2(doc, paths, device=dev, fast=False):
        """The config-2 main path: files -> u8 on the host."""
        images = torch.stack([load_image(p, fast=fast, device=device)[0] for p in paths])
        parsed = [parse_adjustments(doc, is_raw=True) for _ in paths]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=device)
        out = develop_batch(images, sp, cfg)
        return out, device_u8(out).cpu().numpy()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as tmp:
        cfa = rng.integers(RAW_BLACK, RAW_WHITE, (h, w), dtype=np.uint16)
        # the lossless-JPEG file repeats one random 256 x 256 tile (its
        # stream encoded once); the host still decodes every tile
        cfas = {"u16": cfa, "packed14": cfa, "orient6": cfa,
                "ljpeg": np.tile(cfa[:256, :256], (h // 256, w // 256))}
        files = {"u16": (16, 1, 0), "packed14": (14, 1, 0), "orient6": (16, 6, 0),
                 "ljpeg": (16, 1, 256)}
        paths = {}
        for name, (bits, orientation, tile) in files.items():
            t0 = time.perf_counter()
            data = raw_dng_bytes(cfas[name], bits=bits, orientation=orientation, ljpeg_tile=tile)
            paths[name] = Path(tmp) / f"{name}.dng"
            paths[name].write_bytes(data)
            log(f"[raw] wrote {name} {cfas[name].shape} {bits}-bit orientation {orientation}"
                f"{f' lossless-JPEG {tile}x{tile} tiles' if tile else ''}: "
                f"{len(data) / 1e6:.1f} MB in {(time.perf_counter() - t0) * 1e3:.0f} ms")

        # host parse per file (the bytes read and decoded, as export pays)
        raws = {}
        for name, p in paths.items():
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                raws[name] = parse_raw(p.read_bytes(), ext=p.suffix)
                times.append((time.perf_counter() - t0) * 1e3)
            log(f"[raw] host parse {name}: {statistics.median(times):.1f} ms "
                f"(read + decode, median of 3)")
            if not np.array_equal(raws[name].cfa, cfas[name]):
                raise AssertionError(f"the {name} DNG decodes to another CFA")
        raw = raws["u16"]
        if raws["orient6"].orientation != 6 or list(raw.wb) == [1.0, 1.0, 1.0]:
            raise AssertionError("orientation or white balance lost in the DNG")

        # the u16 upload, then the front end and enhance on the card
        up_ms = median_host_ms(lambda: dng_io.upload_cfa(raw, dev), reps)
        cfa_dev = dng_io.upload_cfa(raw, dev)
        if cfa_dev.dtype != torch.uint16 or not torch.equal(cfa_dev.cpu(), torch.from_numpy(cfa)):
            raise AssertionError(f"the upload changed the CFA ({cfa_dev.dtype})")
        lin, front_ops = count_ops(lambda: dng_io.develop_raw(cfa_dev, raw))
        front_ms = time_ms(lambda: dng_io.develop_raw(cfa_dev, raw), reps)
        _, enh_ops = count_ops(lambda: remove_raw_artifacts_and_enhance(lin, nr_amount,
                                                                         sharpening))
        enh_ms = time_ms(lambda: remove_raw_artifacts_and_enhance(lin, nr_amount, sharpening),
                         reps)
        # the library yardstick of the demosaic stencils: one conv2d of the
        # four Malvar 5x5 kernels over the edge-padded plane
        import torch.nn.functional as F

        k4 = torch.from_numpy(np.stack([demosaic._MALVAR[k] for k in (
            "g_at_rb", "rb_at_g_rrow", "rb_at_g_brow", "rb_at_br")])[:, None]).to(dev)
        xp = demosaic.pad_edge(cfa_dev.to(torch.float32), 2)[None, None]
        conv_ms = time_ms(lambda: F.conv2d(xp, k4), reps)
        del xp, k4
        front_b = 2 * h * w + 12 * h * w  # read the u16 CFA once, write (3, H, W) f32
        enh_b = 24 * h * w
        fb, fby = bound_ms(front_b, front_ops)
        eb, eby = bound_ms(enh_b, enh_ops)
        over = float((lin.amax(0) >= 1.0).float().mean())
        log(f"[raw] u16 upload ({h},{w}) {2 * h * w / 1e6:.1f} MB: {up_ms:.2f} ms (host clock, "
            f"pageable); front end (normalize..orientation, malvar) {front_ms:.2f} ms, bound "
            f"{fb:.3f} ms ({fby}; bytes alone {front_b / PEAK_BYTES * 1e3:.3f}, "
            f"{front_ops / (h * w):.0f} ops/pixel); Malvar stencils as one conv2d {conv_ms:.3f} "
            f"ms; enhance (nr {nr_amount:g}, sharpen {sharpening:g}) {enh_ms:.2f} ms, bound "
            f"{eb:.3f} ms ({eby}; bytes alone {enh_b / PEAK_BYTES * 1e3:.3f}, "
            f"{enh_ops / (h * w):.0f} ops/pixel); share of pixels at or past 1.0 after "
            f"highlight compression {over:.3f} [{card}]")

        # the three files develop alike: packed = u16, orient6 = the rotation
        same = torch.equal(dng_io.load_raw_file(paths["packed14"], device=dev), lin)
        rot = torch.equal(dng_io.load_raw_file(paths["orient6"], device=dev),
                          torch.rot90(lin, -1, (1, 2)))
        if not (same and rot):
            raise AssertionError(f"packed14 equal {same}, orientation 6 equal {rot}")
        if load_image(paths["u16"])[0].device.type != "cuda":
            raise AssertionError("load_image without device= left the card")
        log("[raw] the 14-bit packed file develops bit for bit as the 16-bit one; "
            "orientation 6 gives its rot90; load_image without device= returns a CUDA tensor")
        del lin, cfa_dev

        # blur and grade against their plain versions on config 2's inputs
        images = torch.stack([load_image(paths["u16"], device=dev)[0]] * 2)
        p, c = parse_adjustments(CONFIG3_DOC, is_raw=True)
        sp, cfg = stack_params([p] * 2, [c] * 2, device=dev)
        radii = tuple(fused.blur_radii(cfg, w, h).values())
        flat = images.reshape(6, h, w)
        got = blur.gaussian_blur_multi(flat, radii)
        ref, ops = count_ops(lambda: blur.gaussian_blur_multi_plain(flat, radii))
        err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(got, ref))
        ms = time_ms(lambda: blur.gaussian_blur_multi(flat, radii), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(flat, radii), reps)
        bms, bby = bound_ms(nbytes(flat) * (1 + len(radii)), ops)
        # the library yardstick, as in phase 3: per radius one depthwise 2-D
        # conv2d with the Gaussian on the edge-padded RAW images
        convs = []
        for r in radii:
            k1 = torch.from_numpy(blur._gauss_weights(r)).to(dev)
            k2 = (k1[:, None] * k1[None, :]).expand(6, 1, 2 * r + 1, 2 * r + 1).contiguous()
            convs.append((F.pad(flat[None], (r, r, r, r), mode="replicate"), k2))
        lms = time_ms(lambda: [F.conv2d(xp, k2, groups=6) for xp, k2 in convs], reps)
        del convs
        report["blur", "config2"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                         library_ms=lms, max_abs_err=err)
        log(f"[raw] blur on the RAW B=2 images C=6 r={radii}: max|d|/max(1,|ref|) {err:.3e} "
            f"(bound {BLUR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
            f"({bby}); library: one depthwise 2-D conv2d per radius {lms:.3f} ms [{card}]")
        if err > BLUR_TOL:
            raise AssertionError(f"blur on config 2: max|d| {err} > {BLUR_TOL}")
        del got, ref
        pmat = fused.pack_rows(sp["glob"])
        levels = fused.blur_levels(images, cfg)
        for dither in (False, True):
            cd = dataclasses.replace(cfg, dither_active=dither)
            got = fused.grade(images, levels, pmat, cd)
            ref, ops = count_ops(lambda: fused.grade_plain(images, levels, pmat, cd))
            err = float((got - ref).abs().max())
            tol = GRADE_DITHER_TOL if dither else GRADE_TOL
            line = (f"[raw] grade is_raw B=2 config3 dither={'on' if dither else 'off'}: "
                    f"max|d| {err:.3e} (bound {tol:.3e})")
            if not dither:
                ms = time_ms(lambda: fused.grade(images, levels, pmat, cd), reps)
                pms = time_ms(lambda: fused.grade_plain(images, levels, pmat, cd), reps)
                bms, bby = bound_ms(nbytes(images, pmat, *levels.values()) + nbytes(images), ops)
                report["grade", "config2"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                  bound_by=bby, library_ms=None, max_abs_err=err)
                line += (f" kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms ({bby}) "
                         f"[{card}]")
            log(line)
            if not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(f"grade on config 2: max|d| {err} > {tol} or non-finite")
            del got, ref
        del levels

        # the main path, counters reset just before and read just after
        for doc_name, doc in docs.items():
            for b in (1, 2):
                reset_counts()
                out, u8 = run2(doc, [paths["u16"]] * b)
                torch.cuda.synchronize()
                n = read_counts()
                key = "config2" if doc_name == "config3" else "config2_empty"
                if b == 2:
                    launches[key] = n
                want_blur = 1 if doc_name == "config3" else 0
                log(f"[e2e2] config2 {doc_name} B={b}: launches blur {n['blur']} grade "
                    f"{n['grade']} (all {n}) u8 {u8.shape}")
                if n["grade"] != 1 or n["blur"] != want_blur:
                    raise AssertionError(f"config 2 {doc_name} B={b}: grade {n['grade']} "
                                         f"(want 1), blur {n['blur']} (want {want_blur})")
                if not bool(torch.isfinite(out).all()) or u8.shape != (b, 3, h, w) \
                        or u8.min() == u8.max():
                    raise AssertionError("config-2 e2e output is non-finite, misshapen or "
                                         "constant")
                del out, u8
        reset_counts()
        out, u8 = run2({}, [paths["u16"]], fast=True)
        n = read_counts()
        log(f"[e2e2] config2 fast thumbnail B=1: {tuple(out.shape)} launches blur {n['blur']} "
            f"grade {n['grade']}")
        if out.shape != (1, 3, h // 2, w // 2) or n["grade"] != 1:
            raise AssertionError("the fast RAW path is misshapen or skipped the grade kernel")
        fast_ms = median_host_ms(lambda: run2({}, [paths["u16"]], fast=True), reps)
        del out, u8

        # small input: the card against the plain CPU path, same file
        sh, sw = 1024, 1536
        small = Path(tmp) / "small.dng"
        small.write_bytes(raw_dng_bytes(rng.integers(RAW_BLACK, RAW_WHITE, (sh, sw),
                                                     dtype=np.uint16)))
        lin_gpu = dng_io.load_raw_file(small, device=dev)
        lin_cpu = dng_io.load_raw_file(small, device="cpu")
        front_d = float((lin_gpu.cpu() - lin_cpu).abs().max())
        enh_gpu = remove_raw_artifacts_and_enhance(lin_cpu.to(dev), nr_amount, sharpening)
        enh_cpu = remove_raw_artifacts_and_enhance(lin_cpu, nr_amount, sharpening)
        flips = int(((enh_gpu.cpu() - enh_cpu).abs() > 1e-5).sum())
        _, u8_gpu = run2(CONFIG3_DOC, [small])
        _, u8_cpu = run2(CONFIG3_DOC, [small], device="cpu")
        du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
        log(f"[e2e2] small {sh}x{sw} CUDA vs plain CPU: front end max|d| {front_d:.3e}; enhance "
            f"on the same input: {flips} of {enh_cpu.numel()} values past 1e-5 (gate flips); "
            f"u8 max {int(du.max())} LSB, share>0 {float((du > 0).mean()):.2e}")
        if front_d > 0 or du.max() > 1 or (du > 0).mean() > 1e-3 \
                or flips > 1e-3 * enh_cpu.numel():
            raise AssertionError("config-2 CUDA output disagrees with the plain CPU path "
                                 "(the front end is held bit for bit)")

        # X-Trans: a 24 MP RAF through the same entry points; the site masks
        # are built on the first frame and stay resident for the next
        xcfa = rng.integers(0, 1 << 14, (h, w), dtype=np.uint16)
        raf_path = Path(tmp) / "xtrans.raf"
        raf_path.write_bytes(raw_raf_bytes(xcfa, xtrans.DEFAULT_XTRANS))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            xraw = parse_raw(raf_path.read_bytes(), ext=".raf")
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(xraw.cfa, xcfa) \
                or not np.array_equal(xraw.xtrans, xtrans.DEFAULT_XTRANS):
            raise AssertionError("the RAF decodes to another CFA or X-Trans layout")
        xdev = dng_io.upload_cfa(xraw, dev)
        xtrans._site_masks.cache_clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dng_io.develop_raw(xdev, xraw)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        _, xfront_ops = count_ops(lambda: dng_io.develop_raw(xdev, xraw))
        xfront_ms = time_ms(lambda: dng_io.develop_raw(xdev, xraw), reps)
        info = xtrans._site_masks.cache_info()
        if info.misses != 1 or info.hits < reps:
            raise AssertionError(f"the X-Trans site masks were rebuilt: {info}")
        xb, xby = bound_ms(front_b, xfront_ops)
        reset_counts()
        out, u8 = run2(CONFIG3_DOC, [raf_path])
        torch.cuda.synchronize()
        n = read_counts()
        launches["config2_xtrans"] = n
        if n["grade"] != 1 or n["blur"] != 1 or not bool(torch.isfinite(out).all()) \
                or u8.shape != (1, 3, h, w) or u8.min() == u8.max():
            raise AssertionError(f"config 2 X-Trans: launches {n}, or the output is "
                                 "non-finite, misshapen or constant")
        del out, u8, xdev
        xe2e_ms = median_host_ms(lambda: run2(CONFIG3_DOC, [raf_path]), reps)
        log(f"[raw] X-Trans RAF ({h},{w}): host parse {statistics.median(times):.1f} ms (read "
            f"+ decode, median of 3); front end (normalize..orientation, X-Trans) first frame "
            f"{first_ms:.2f} ms (host clock, site masks built and uploaded), then "
            f"{xfront_ms:.2f} ms (masks resident: {info.hits} cache hits, {info.misses} "
            f"build), bound {xb:.3f} ms ({xby}; {xfront_ops / (h * w):.0f} ops/pixel)")
        log(f"[e2e2] config2 X-Trans config3 B=1: launches blur {n['blur']} grade "
            f"{n['grade']}; {xe2e_ms:.2f} ms/image, {h * w / xe2e_ms / 1e3:.1f} MPix/s (RAF "
            f"file -> u8 on the host) [{card}]")
        small_raf = Path(tmp) / "small.raf"
        small_raf.write_bytes(raw_raf_bytes(rng.integers(0, 1 << 14, (sh, sw), dtype=np.uint16),
                                            xtrans.DEFAULT_XTRANS))
        xfront_d = float((dng_io.load_raw_file(small_raf, device=dev).cpu()
                          - dng_io.load_raw_file(small_raf, device="cpu")).abs().max())
        _, u8_gpu = run2(CONFIG3_DOC, [small_raf])
        _, u8_cpu = run2(CONFIG3_DOC, [small_raf], device="cpu")
        du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
        log(f"[e2e2] small X-Trans {sh}x{sw} CUDA vs plain CPU: front end max|d| "
            f"{xfront_d:.3e} (bound {XTRANS_TOL:g}); u8 max {int(du.max())} LSB, share>0 "
            f"{float((du > 0).mean()):.2e}")
        if xfront_d > XTRANS_TOL or du.max() > 1 or (du > 0).mean() > 1e-3:
            raise AssertionError("config-2 X-Trans CUDA output disagrees with the plain CPU path")
        del u8_gpu, u8_cpu

        # e2e times: file -> u8 on the host, and its stages apart
        for doc_name, doc in docs.items():
            for b in (1, 2):
                dt = median_host_ms(lambda: run2(doc, [paths["u16"]] * b), reps)
                p, c = parse_adjustments(doc, is_raw=True)
                sp, cfg = stack_params([p] * b, [c] * b, device=dev)
                imgs = images[:b].contiguous()
                dev_ms = time_ms(lambda: device_u8(develop_batch(imgs, sp, cfg)), reps)
                q = device_u8(develop_batch(imgs, sp, cfg))
                rb_ms = median_host_ms(lambda: q.cpu(), reps)
                log(f"[e2e2] config2 {doc_name} B={b}: {dt / b:.2f} ms/image, "
                    f"{b * h * w / dt / 1e3:.1f} MPix/s (DNG file -> u8 on the host); per "
                    f"image: host parse + u16 upload + front end + enhance (above), develop "
                    f"device part {dev_ms / b:.2f} ms ({b * h * w / dev_ms / 1e3:.1f} MPix/s), "
                    f"u8 readback {rb_ms / b:.2f} ms; front end + enhance share of e2e "
                    f"{(front_ms + enh_ms) * b / dt:.3f} [{card}]")
                del q
        for name in ("packed14", "ljpeg"):
            dt = median_host_ms(lambda: run2(CONFIG3_DOC, [paths[name]]), reps)
            log(f"[e2e2] config2 config3 B=1 from the {name} file: {dt:.2f} ms/image, "
                f"{h * w / dt / 1e3:.1f} MPix/s [{card}]")
        log(f"[e2e2] config2 fast thumbnail ({h // 2}x{w // 2}) B=1: {fast_ms:.2f} ms/image "
            f"[{card}]")
        if args.profile:
            profile_run("config2 B=2", lambda: run2(CONFIG3_DOC, [paths["u16"]] * 2), args.out,
                        card)
        del images
    return launches, report


# phase 12's 24 MP files: the four commonest vendor containers
VENDOR_MAIN = ("cr2", "nef", "arw", "cr3")
# the other vendor formats, checked on the card against the CPU: name ->
# (extension, (rows, columns) of the written frame)
VENDOR_OTHER = {"pef": ("pef", (1024, 1536)), "orf_packed": ("orf", (1024, 1536)),
                "orf_predictive": ("orf", (512, 768)), "rw2": ("rw2", (1026, 1540)),
                "mrw": ("mrw", (1024, 1536)), "srw": ("srw", (1024, 1536)),
                "iiq5": ("iiq", (1024, 1536))}
CANON_MASK = (2, 64)  # CR2 / CR3: masked rows above and columns left of the active area


def vendor_file(kind: str, h: int, w: int, seed: int):
    """(file bytes, the CFA it decodes to) of one vendor container with an
    (h, w) active area (VENDOR_MAIN), or of (h, w) frames of the other
    formats (VENDOR_OTHER). The main four and the PEF, ORF-packed, MRW,
    SRW and IIQ frames hold photo_cfa content: CR2 / CR3 a 14-bit sensor
    with a 2048 pedestal and masked columns (the black level) around the
    active area, NEF / PEF / ORF / MRW 12-bit, SRW 14-bit in 16, ARW2 11-bit
    coded samples (the decoded CFA is the Sony curve of the plane the
    encoder quantized); the ORF predictive and Panasonic streams drive their
    own random frames, as their test encoders do."""
    rng = np.random.default_rng(seed)
    if kind in ("cr2", "cr3"):
        top, left = CANON_MASK
        sensor = photo_cfa(h + 2 * top, w + left, 2048, 15000, seed)
        sensor[:, :left] = photo_cfa(h + 2 * top, left, 2048, 2048, seed + 1)
        crop = (top, left, top + h - 1, left + w - 1)
        data = cr2_bytes(sensor, crop) if kind == "cr2" else cr3_bytes(sensor, crop)
        return data, sensor[top:top + h, left:]
    if kind == "arw":
        return arw_bytes(photo_cfa(h, w, 256, 1900, seed))
    if kind == "orf_predictive":
        stream, cfa = orf_predictive(h, w, rng)
        return orf_bytes(cfa, stream), cfa
    if kind == "rw2":
        stream, plane = rw2_stream(h, w, rng)
        return rw2_bytes(stream, h, w), plane[2:, 4:]
    if kind == "iiq5":
        pred = photo_cfa(h, w, 200, 15000, seed)
        black = 64
        v = np.where(pred < 256, (pred.astype(np.float64) ** 2 / 3.969 + 0.5).astype(np.int64),
                     pred.astype(np.int64))  # the format-5 small-value ramp, << 2, - black
        return iiq_bytes(pred, black), np.clip((v << 2) - black, 0, 65535).astype(np.uint16)
    cfa = photo_cfa(h, w, 0, 16000 if kind == "srw" else 4000, seed)
    writer = {"nef": nef_bytes, "pef": pef_bytes, "orf_packed": orf_bytes, "mrw": mrw_bytes,
              "srw": srw_bytes}[kind]
    return writer(cfa), cfa


def phase_vendor(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 12, config 2 from the vendor containers: 24 MP CR2 (sliced
    lossless JPEG, 14-bit, masked border), NEF (34713 lossless 12-bit), ARW
    (ARW2) and CR3 (crx lossless 14-bit) files written from `--seed` into a
    temporary directory; per file the host parse (median
    of 3; the CFA must equal what was encoded), the u16 upload, the front
    end, and file -> load_image -> develop_batch(CONFIG3_DOC) -> u8 for
    B = 1, 2 with the counters read around each call (grade 1, blur 1);
    then every vendor format at 1024 x 1536 (the ORF predictive stream at
    512 x 768: its encoder is sequential) on the card against the CPU:
    front end bit for bit, u8 within 1 LSB on <= 0.1%. Returns {path:
    launches}."""
    import tempfile

    from rapidraw_tpu_torch import develop_batch, device_u8, load_image, parse_adjustments, \
        parse_raw, stack_params
    from rapidraw_tpu_torch.io import dng as dng_io

    e2e_reps = min(reps, 3)
    launches = {}

    def run2(paths, device=dev):
        images = torch.stack([load_image(p, device=device)[0] for p in paths])
        parsed = [parse_adjustments(CONFIG3_DOC, is_raw=True) for _ in paths]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=device)
        out = develop_batch(images, sp, cfg)
        return out, device_u8(out).cpu().numpy()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vendor_") as tmp:
        paths = {}
        for i, kind in enumerate(VENDOR_MAIN):
            t0 = time.perf_counter()
            data, want = vendor_file(kind, h, w, args.seed + i)
            paths[kind] = Path(tmp) / f"shot.{kind}"
            paths[kind].write_bytes(data)
            write_ms = (time.perf_counter() - t0) * 1e3
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                raw = parse_raw(paths[kind].read_bytes(), ext=paths[kind].suffix)
                times.append((time.perf_counter() - t0) * 1e3)
            parse_ms = statistics.median(times)
            if raw.cfa.dtype != np.uint16 or not np.array_equal(raw.cfa, want):
                raise AssertionError(f"the {kind} file decodes to another CFA")
            up_ms = median_host_ms(lambda: dng_io.upload_cfa(raw, dev), reps)
            cfa_dev = dng_io.upload_cfa(raw, dev)
            front_ms = time_ms(lambda: dng_io.develop_raw(cfa_dev, raw), reps)
            del cfa_dev
            log(f"[vendor] {kind} ({h},{w}): wrote {len(data) / 1e6:.1f} MB in {write_ms:.0f} ms; "
                f"host parse {parse_ms:.1f} ms (read + decode, median of 3; the CFA equals the "
                f"encoded one: pattern {raw.pattern}, black {raw.black_level:g}, white "
                f"{raw.white_level:g}, wb {np.round(raw.wb, 4).tolist()}, matrix "
                f"{raw.xyz_to_cam is not None}); u16 upload {up_ms:.2f} ms (host clock); front end "
                f"{front_ms:.2f} ms [{card}]")
            for b in (1, 2):
                reset_counts()
                out, u8 = run2([paths[kind]] * b)
                torch.cuda.synchronize()
                n = read_counts()
                if b == 2:
                    launches[f"config2_{kind}"] = n
                if n["grade"] != 1 or n["blur"] != 1:
                    raise AssertionError(f"{kind} B={b}: launches {n} (want grade 1, blur 1)")
                if not bool(torch.isfinite(out).all()) or u8.shape != (b, 3, h, w) \
                        or u8.min() == u8.max():
                    raise AssertionError(f"{kind} B={b}: output non-finite, misshapen or constant")
                del out, u8
                # each e2e run right after a parse of the same file: the host
                # parse's share of e2e is the median of the pairs' ratios
                pts, dts = [], []
                for _ in range(e2e_reps):
                    t0 = time.perf_counter()
                    parse_raw(paths[kind].read_bytes(), ext=paths[kind].suffix)
                    pts.append((time.perf_counter() - t0) * 1e3)
                    dts.append(median_host_ms(lambda: run2([paths[kind]] * b), 1))
                dt = statistics.median(dts)
                share = statistics.median(pt * b / d for pt, d in zip(pts, dts))
                log(f"[vendor] e2e {kind} config3 B={b}: launches blur {n['blur']} grade "
                    f"{n['grade']}; {dt / b:.2f} ms/image, {b * h * w / dt / 1e3:.1f} MPix/s "
                    f"({kind} file -> u8 on the host, median of {e2e_reps}; range "
                    f"{min(dts) / b:.2f}-{max(dts) / b:.2f}); host parse share {share:.3f} "
                    f"(parse {min(pts):.1f}-{max(pts):.1f} ms beside it) [{card}]")
        if args.profile:
            profile_run("config2_nef B=2", lambda: run2([paths["nef"]] * 2), args.out, card)

        # every vendor format on the card against the plain CPU path
        sh, sw = 1024, 1536
        small = {kind: (kind, (sh, sw)) for kind in VENDOR_MAIN} | VENDOR_OTHER
        for i, (kind, (ext, (fh, fw))) in enumerate(small.items()):
            t0 = time.perf_counter()
            data, want = vendor_file(kind, fh, fw, args.seed + 20 + i)
            write_ms = (time.perf_counter() - t0) * 1e3
            p = Path(tmp) / f"small_{kind}.{ext}"
            p.write_bytes(data)
            raw = parse_raw(data, ext=ext)
            if not np.array_equal(raw.cfa, want):
                raise AssertionError(f"the small {kind} file decodes to another CFA")
            lin_gpu = dng_io.load_raw_file(p, device=dev)
            lin_cpu = dng_io.load_raw_file(p, device="cpu")
            front_d = float((lin_gpu.cpu() - lin_cpu).abs().max())
            _, u8_gpu = run2([p])
            _, u8_cpu = run2([p], device="cpu")
            du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
            log(f"[vendor] small {kind} {tuple(raw.cfa.shape)} (written in {write_ms:.0f} ms) "
                f"CUDA vs plain CPU: front end max|d| {front_d:.3e}; u8 max {int(du.max())} LSB, "
                f"share>0 {float((du > 0).mean()):.2e}")
            if front_d > 0 or du.max() > 1 or (du > 0).mean() > 1e-3:
                raise AssertionError(f"the {kind} file on the card disagrees with the CPU")
    return launches


FLARE_TOL = 1e-5  # x max(1, |ref|): the flare map's module tolerance (tests/test_torch_flare.py)
CPU_CHECK = (1024, 1536)  # phase 13's size for the card against the plain CPU path


def phase_doc(h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 13, the rest of the develop document: lens flare, the 3D LUT
    and NR with per-pixel amounts.

    (a) the flare kernel against its plain version on a B = 2 batch of
    bright-spot images; (b) the grade kernel with flare and the LUT
    (FLARE_LUT_DOC, a 33^3 .cube written here and parsed by
    io/lut.parse_lut_file) against grade_plain, timed beside config 3's
    grade in the same call, then the masks build with a radial mask that
    carries flare, and a ragged size (the flare map there too); (c) the
    per-pixel NR kernel against its plain version on config 5's document
    with an NR mask (amount maps) and on the mixed-amount batch
    MIXED_NR_DOCS (per-image amounts), at 24 MP and the ragged size; (d) JSON ->
    develop_batch -> device_u8 -> host numpy for (b)'s document and (c)'s
    masked one at B = 1 and 2 and the mixed batch at B = 2, counters reset
    and read around each main-path call, the flare map's share of the
    device time; and each document at 1024 x 1536 on the card against the
    plain CPU path. Returns ({path: launches}, {(kernel, path): numbers})."""
    import tempfile

    import torch.nn.functional as F

    from rapidraw_tpu_torch import (
        blur_band_rows,
        develop_batch,
        device_u8,
        parse_adjustments,
        rasterize_masks,
        stack_params,
    )
    from rapidraw_tpu_torch.io.lut import parse_lut_file
    from rapidraw_tpu_torch.ops import flare, nr
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import bound_ms

    gen = torch.Generator(device=dev).manual_seed(13)
    launches, report = {}, {}

    def bright(b, hh, ww):
        """Random pixels with saturated discs: the flare's bright sources."""
        x = torch.rand((b, 3, hh, ww), generator=gen, device=dev) * 0.7
        yy = torch.arange(hh, device=dev)[:, None]
        xx = torch.arange(ww, device=dev)[None, :]
        for cy, cx in ((0.3, 0.25), (0.6, 0.7), (0.5, 0.98)):
            x[:, :, (yy - cy * hh) ** 2 + (xx - cx * ww) ** 2 <= (0.03 * hh) ** 2] = 1.0
        return x

    def stacked(docs, device=dev):
        parsed = [parse_adjustments(d) for d in docs]
        return stack_params([q for q, _ in parsed], [c for _, c in parsed], device=device)

    def flare_params(sp):
        pmat = fused.pack_rows(sp["glob"])
        return pmat[:, [fused.OFFSETS[k] for k in flare.FLARE_PARAMS]].contiguous()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lut_"))
    write_cube(tmp / "phase13.cube")
    cube_np = parse_lut_file(tmp / "phase13.cube")
    cube = torch.from_numpy(cube_np).to(dev)
    log(f"[doc] wrote and parsed a {cube_np.shape[0]}^3 .cube: {tuple(cube_np.shape)}")

    # ---- (a) the flare kernel against its plain version ----------------------
    images = bright(2, h, w)
    sp, cfg = stacked([FLARE_LUT_DOC, dict(FLARE_LUT_DOC, exposure=-0.3, flareAmount=70)])
    fp = flare_params(sp)
    got = flare.flare_maps(images, fp, cfg.is_raw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = flare.flare_maps_plain(images, fp, cfg.is_raw)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3  # one run: ~30,000 launches per image
    _, ops = count_ops(lambda: flare.flare_maps_plain(images, fp, cfg.is_raw))
    err = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    share = float((got != ref).float().mean())
    ms = time_ms(lambda: flare.flare_maps(images, fp, cfg.is_raw), reps)
    n = flare.FLARE_MAP_SIZE
    # bytes: each map pixel's 2 x 2 input texels and its 3 MB map (the
    # threshold map and its taps stay on chip), the params
    bms, bby = bound_ms(2 * n * n * (4 * 3 * 4 + 3 * 4) + nbytes(fp), ops)
    log(f"[flare] B=2 ({h},{w}) -> (2,{n},{n},3): max|d|/max(1,|ref|) {err:.3e} (bound "
        f"{FLARE_TOL:g}), values that differ {share:.2e}, max|ref| "
        f"{float(ref.abs().max()):.3f}; kernel {ms:.3f} ms, plain "
        f"{pms:.1f} ms (one run), bound {bms:.3f} ms ({bby}, {ops / 1e9:.2f} G ops) [{card}]")
    if not bool(torch.isfinite(got).all()) or err > FLARE_TOL:
        raise AssertionError(f"flare map: max|d| {err} > {FLARE_TOL} or non-finite")
    report["flare", "flare_lut"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                        library_ms=None, max_abs_err=err)
    fmaps = got
    del ref

    # ---- (b) the grade kernel with flare and the LUT ---------------------------
    pmat = fused.pack_rows(sp["glob"])
    levels = fused.blur_levels(images, cfg)
    sp3, cfg3 = stacked([CONFIG3_DOC, dict(CONFIG3_DOC, exposure=-0.3)])
    pmat3 = fused.pack_rows(sp3["glob"])
    for dither in (False, True):
        c = dataclasses.replace(cfg, dither_active=dither)
        got = fused.grade(images, levels, pmat, c, flare=fmaps, lut=cube)
        ref, ops = count_ops(lambda: fused.grade_plain(images, levels, pmat, c, flare=fmaps,
                                                       lut=cube))
        torch.cuda.synchronize()
        d = (got - ref).abs()
        err, share = float(d.max()), float((d > GRADE_TOL).float().mean())
        tol = GRADE_DITHER_TOL if dither else GRADE_TOL
        line = (f"[grade-doc] B=2 flare+LUT stages {fused.grade_stages(c)} build "
                f"{fused.grade_launch_plan(2, h, w, c)['min_blocks']} dither="
                f"{'on' if dither else 'off'}: max|d| {err:.3e} (bound {tol:.3e}), "
                f"share>{GRADE_TOL:g} {share:.2e}")
        if not dither:
            # config 3's grade and this one, interleaved in one call
            t3, tf = [], []
            for _ in range(2):
                t3.append(time_ms(lambda: fused.grade(images, levels, pmat3, cfg3), reps))
                tf.append(time_ms(lambda: fused.grade(images, levels, pmat, c, flare=fmaps,
                                                      lut=cube), reps))
            ms, ms3 = statistics.median(tf), statistics.median(t3)
            pms = time_ms(lambda: fused.grade_plain(images, levels, pmat, c, flare=fmaps,
                                                    lut=cube), 1)
            bms, bby = bound_ms(nbytes(images, pmat, fmaps, cube, *levels.values())
                                + nbytes(images), ops)
            # the library yardstick of the flare input: one bilinear
            # grid_sample of the maps at every pixel (border clamp)
            gy = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h * 2.0 - 1.0
            gx = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w * 2.0 - 1.0
            grid = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), -1)[None].expand(
                2, h, w, 2).contiguous()
            fm = fmaps.permute(0, 3, 1, 2).contiguous()
            lms = time_ms(lambda: F.grid_sample(fm, grid, mode="bilinear",
                                                padding_mode="border", align_corners=False),
                          reps)
            del grid, fm
            line += (f" kernel {ms:.3f} ms (config 3's grade {ms3:.3f} ms, +{ms - ms3:.3f}) "
                     f"plain {pms:.3f} ms bound {bms:.3f} ms ({bby}, "
                     f"{ops / (2 * h * w):.0f} ops/pixel); flare sample alone as one "
                     f"grid_sample {lms:.3f} ms [{card}]")
            report["grade", "flare_lut"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                                library_ms=lms, max_abs_err=err,
                                                config3_ms=ms3)
        log(line)
        if not bool(torch.isfinite(got).all()) or err > tol:
            raise AssertionError(f"grade flare+LUT: max|d| {err} > {tol} or non-finite")
        del got, ref
    del levels, pmat3

    # the masks build: a radial mask that adds flare, B = 2 at this size
    t0 = time.perf_counter()
    mdoc = flare_mask_doc(h, w)
    bm = rasterize_masks(mdoc, w, h, scale=1.0)
    raster_ms = (time.perf_counter() - t0) * 1e3
    spm, cfgm = stacked([mdoc, dict(mdoc, exposure=0.1)])
    mk = torch.from_numpy(np.repeat(bm[None], 2, 0)).to(dev)
    pm, mm = fused.pack_rows(spm["glob"]), fused.pack_mask_rows(spm["mask"])
    levels = fused.blur_levels(images, cfgm, blur_band_rows(cfgm, bm))
    fm = flare.flare_maps(images, flare_params(spm), False)
    c = dataclasses.replace(cfgm, dither_active=False)
    got = fused.grade(images, levels, pm, c, masks=mk, mmat=mm, flare=fm, lut=cube)
    ref = fused.grade_plain(images, levels, pm, c, masks=mk, mmat=mm, flare=fm, lut=cube)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ms = time_ms(lambda: fused.grade(images, levels, pm, c, masks=mk, mmat=mm, flare=fm,
                                     lut=cube), reps)
    log(f"[grade-doc] B=2 masks build, a flare mask (rasterized in {raster_ms:.0f} ms): "
        f"max|d| {err:.3e} (bound {GRADE_TOL:g}) kernel {ms:.3f} ms [{card}]")
    if not bool(torch.isfinite(got).all()) or err > GRADE_TOL:
        raise AssertionError(f"grade with a flare mask: max|d| {err} > {GRADE_TOL}")
    del got, ref, levels, mk, fm, images

    # a size that is a multiple of neither tile, with its own flare maps
    rimg = bright(2, *RAGGED)
    rmaps = flare.flare_maps(rimg, fp, False)
    rref = flare.flare_maps_plain(rimg, fp, False)
    torch.cuda.synchronize()
    ferr = float(((rmaps - rref).abs() / rref.abs().clamp(min=1.0)).max())
    log(f"[flare] ragged B=2 {RAGGED[0]}x{RAGGED[1]}: max|d|/max(1,|ref|) {ferr:.3e} (bound "
        f"{FLARE_TOL:g}), values that differ {float((rmaps != rref).float().mean()):.2e}")
    if ferr > FLARE_TOL or not bool(torch.isfinite(rmaps).all()):
        raise AssertionError(f"ragged flare map: max|d| {ferr} > {FLARE_TOL} or non-finite")
    rlv = fused.blur_levels(rimg, cfg)
    for dither in (False, True):
        c = dataclasses.replace(cfg, dither_active=dither)
        got = fused.grade(rimg, rlv, pmat, c, flare=rmaps, lut=cube)
        ref = fused.grade_plain(rimg, rlv, pmat, c, flare=rmaps, lut=cube)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = GRADE_DITHER_TOL if dither else GRADE_TOL
        log(f"[grade-doc] ragged B=2 {RAGGED[0]}x{RAGGED[1]} flare+LUT dither="
            f"{'on' if dither else 'off'}: max|d| {err:.3e} (bound {tol:.3e})")
        if err > tol or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ragged flare+LUT: max|d| {err}")
        del got, ref
    del rimg, rmaps, rref, rlv

    # ---- (c) NR with per-pixel amounts, at 24 MP (timed) and the ragged size ------
    for hh, ww in ((h, w), RAGGED):
        scale = scales.resolution_scale(ww, hh)
        images = torch.rand((2, 3, hh, ww), generator=gen, device=dev)
        center = srgb_to_linear(images).contiguous()
        planes = nr.nr_planes(images, False).contiguous()
        ndoc = masked_nr_doc(hh, ww)
        nbm_s = rasterize_masks(ndoc, ww, hh, scale=1.0)
        if (hh, ww) == (h, w):
            nbm = nbm_s  # (d) reuses the 24 MP mask
        nmk = torch.from_numpy(np.repeat(nbm_s[None], 2, 0)).to(dev)
        for label, docs, mk in (("masked", [ndoc, ndoc], nmk),
                                ("mixed", list(MIXED_NR_DOCS), None)):
            spn, cfgn = stacked(docs)
            la, ca = fused.nr_amounts(spn, cfgn, mk, dev)
            got = nr.nr_dynamic(center, planes, la, ca, scale)
            ref, ops = count_ops(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale))
            torch.cuda.synchronize()
            d = (got - ref).abs()
            err, share = float(d.max()), float((d > 0).float().mean())
            line = (f"[nr-dyn] {label} B=2 ({hh},{ww}) amounts "
                    f"{'maps' if la.ndim == 3 else 'per image'} {tuple(la.shape)}: max|d| "
                    f"{err:.3e} (bound {NR_TOL:g}), values that differ {share:.2e}")
            if (hh, ww) == (h, w):
                ms = time_ms(lambda: nr.nr_dynamic(center, planes, la, ca, scale), reps)
                pms = time_ms(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale), 1)
                bms, bby = bound_ms(nbytes(center, planes, la, ca) + nbytes(center), ops)
                line += (f"; kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms ({bby}, "
                         f"{ops / 1e9:.1f} G ops, {ops / (2 * hh * ww):.0f} per pixel) [{card}]")
                report["nr_dynamic", f"{label}_nr"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                           bound_by=bby, library_ms=None,
                                                           max_abs_err=err)
            log(line)
            if not bool(torch.isfinite(got).all()) or err > NR_TOL:
                raise AssertionError(f"nr_dynamic {label} ({hh},{ww}): max|d| {err} > {NR_TOL} "
                                     "or non-finite")
            del got, ref, la, ca
        del center, planes, nmk

    # ---- (d) end to end: JSON -> develop_batch -> device_u8 -> host numpy --------
    def inputs(kind, b, imgs):
        """(stacked params, config, influences, cube) of a path's b images."""
        hh, ww = imgs.shape[2:]
        mk, lut = None, None
        if kind == "flare_lut":
            docs = [FLARE_LUT_DOC] * b
            lut = cube.to(imgs.device)
        elif kind == "masked_nr":
            docs = [masked_nr_doc(hh, ww)] * b
            bmk = nbm if (hh, ww) == (h, w) else rasterize_masks(docs[0], ww, hh, scale=1.0)
            mk = torch.from_numpy(np.repeat(bmk[None], b, 0))
            mk = mk.to(imgs.device)
        else:
            docs = list(MIXED_NR_DOCS)[:b]
        sp, c = stacked(docs, imgs.device)
        return sp, c, mk, lut

    def run(kind, b, imgs):
        sp, c, mk, lut = inputs(kind, b, imgs)
        out = develop_batch(imgs, sp, c, masks=mk, lut=lut)
        return out, device_u8(out).cpu().numpy()

    img2 = bright(2, h, w)
    expect = {"flare_lut": ("flare", "grade", "blur"), "masked_nr": ("nr_dynamic", "grade", "blur"),
              "mixed_nr": ("nr_dynamic", "grade", "blur")}
    for kind, need in expect.items():
        for b in ((2,) if kind == "mixed_nr" else (1, 2)):
            imgs = img2[:b].contiguous()
            reset_counts()
            out, u8 = run(kind, b, imgs)
            torch.cuda.synchronize()
            counts = read_counts()
            if b == 2:
                launches[kind] = counts
            if min(counts[k] for k in need) < 1:
                raise AssertionError(f"a kernel of the {kind} path never launched: {counts}")
            if not bool(torch.isfinite(out).all()) or u8.shape != (b, 3, h, w) \
                    or u8.min() == u8.max():
                raise AssertionError(f"{kind} e2e output is non-finite, misshapen or constant")
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(kind, b, imgs)
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
            sp, c, mk, lut = inputs(kind, b, imgs)
            dev_ms = time_ms(lambda: device_u8(develop_batch(imgs, sp, c, masks=mk, lut=lut)),
                             reps)
            fshare = ""
            if kind == "flare_lut":
                spf, cf = stacked([FLARE_LUT_DOC] * b)
                fms = time_ms(lambda: flare.flare_maps(imgs, flare_params(spf), False), reps)
                fshare = (f"; flare maps {fms:.3f} ms, {100.0 * fms / dev_ms:.1f}% of the "
                          f"device part")
            log(f"[e2e-doc] {kind} B={b}: {dt * 1e3 / b:.2f} ms/image, "
                f"{b * h * w / dt / 1e6:.1f} MPix/s (JSON -> u8 on host); device part "
                f"{dev_ms / b:.2f} ms/image ({b * h * w / dev_ms / 1e3:.1f} MPix/s){fshare}; "
                f"launches per call { {k: v for k, v in counts.items() if v} } [{card}]")
            del out, u8

    # each document at 1024 x 1536 on the card against the plain CPU path
    small = bright(2, *CPU_CHECK)
    for kind in expect:
        b = 2 if kind == "mixed_nr" else 1
        _, u8_gpu = run(kind, b, small[:b].contiguous())
        _, u8_cpu = run(kind, b, small[:b].cpu())
        du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
        log(f"[e2e-doc] {kind} {b}x3x{CPU_CHECK[0]}x{CPU_CHECK[1]} CUDA vs plain CPU u8: max "
            f"{int(du.max())} LSB, "
            f"share>0 {float((du > 0).mean()):.2e}")
        if du.max() > 1 or (du > 0).mean() > 1e-3:
            raise AssertionError(f"{kind}: the CUDA output disagrees with the plain CPU path")
    return launches, report


EXPORT_FILES = 8  # phase 14's DNGs: 6 with CONFIG3_DOC, 2 with `{}`, and one virtual copy


def jpeg_markers(data: bytes) -> list:
    """The marker codes of a JPEG file up to its scan, then EOI if it ends so."""
    import struct

    out, pos = [data[:2].hex()], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        out.append(f"ff{marker:02x}")
        if marker == 0xDA:
            break
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    if data[-2:] == b"\xff\xd9":
        out.append("ffd9")
    return out


def phase_export(args, h, w, card, dev, reset_counts, read_counts):
    """Phase 14, batch export (A.10): EXPORT_FILES 16-bit DNGs of
    photograph-like content from --seed (raw_dng_bytes with EXPORT_META:
    a preview IFD0 with Make, Model, DateTime, an Exif IFD and a GPS IFD;
    the raw IFD a SubIFD), six with CONFIG3_DOC and two with `{}` in their
    sidecars, and a virtual copy of the first with `{}` (two buckets), then
    export_images on the card: JPEG q90 with the default settings (batch 4,
    EXIF copied, GPS stripped), TIFF and PNG on two files, JPEG with
    long_edge 2048 on two. Counters are reset and read around each run:
    grade once per chunk, blur once per CONFIG3_DOC chunk and never for
    `{}`. Prints images/s, s/image, the stage split, the device memory
    peak, the encoder alone on one frame; checks every result, the file
    names against _output_path, the JPEG markers, the copied EXIF (GPS
    gone, Orientation 1), a TIFF against its chunk's device_u16 frame, and
    a 1024 x 1536 export on the card against the plain CPU path. Returns
    the launches of the default JPEG run."""
    import tempfile

    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.io import encode, exif
    from rapidraw_tpu_torch.io.loader import parse_virtual_path
    from rapidraw_tpu_torch.pipeline import export as ex

    frames = []  # (chunk shape, is CONFIG3, the quantized frames read back)
    real_render = ex._render_chunk

    def spy(imgs, params, masks, lut, cfg, *a, **k):
        out = real_render(imgs, params, masks, lut, cfg, *a, **k)
        frames.append((tuple(imgs.shape), cfg.tonemapper_agx, out))
        return out

    def run(paths, out_dir, device=dev, **kw):
        """export_images with counters reset just before and read just after."""
        frames.clear()
        ex.reset_stage_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = ex.export_images(paths, out_dir, ex.ExportSettings(**kw), device=device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        bad = [(r.source, r.error) for r in res if not r.ok]
        if bad:
            raise RuntimeError(f"export failed: {bad}")
        return res, counts, wall

    def check_launches(label, counts):
        n3 = sum(1 for _, agx, _ in frames if agx)
        n0 = len(frames) - n3
        want = {"grade": len(frames), "blur": n3}
        got = {k: counts[k] for k in want}
        others = {k: v for k, v in counts.items() if k not in want and v}
        log(f"[export] {label}: chunks {[s for s, _, _ in frames]}, launches {counts} "
            f"(CONFIG3_DOC chunks {n3}, `{{}}` chunks {n0})")
        if got != want or others or not n3 or not n0:
            raise RuntimeError(f"{label}: launches {counts}, expected {want} and no other")

    def report(label, res, wall):
        st = dict(ex.STAGE_STATS)
        n = len(res)
        log(f"[export] {label}: {n} images in {wall:.3f} s = {n / wall:.3f} images/s, "
            f"{wall / n:.3f} s/image; stage seconds (summed over threads) decode "
            f"{st['decode_s']:.3f}, prepare {st['prepare_s']:.3f}, render {st['render_s']:.3f}, "
            f"encode {st['encode_s']:.3f} ({st['encode_s'] / n:.3f} s/image), frames "
            f"{st['frames']}; device memory peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        bases = [photo_cfa(h, w, RAW_BLACK, RAW_WHITE, args.seed + k) for k in range(2)]
        paths = []
        for i in range(EXPORT_FILES):
            cfa = np.roll(bases[i % 2], (int(rng.integers(0, h // 2)) * 2,
                                         int(rng.integers(0, w // 2)) * 2), axis=(0, 1))
            p = tmp / "src" / f"shot_{i:02d}.dng"
            p.parent.mkdir(exist_ok=True)
            p.write_bytes(raw_dng_bytes(cfa, meta=EXPORT_META))
            doc = CONFIG3_DOC if i < 6 else {}
            p.with_name(p.name + ".rrdata").write_text(json.dumps({"adjustments": doc}))
            paths.append(str(p))
        vc = paths[0] + "?vc=2"  # a virtual copy: its own sidecar, shot_00.dng.2.rrdata
        Path(paths[0] + ".2.rrdata").write_text(json.dumps({"adjustments": {}}))
        paths.append(vc)
        log(f"[export] wrote {EXPORT_FILES} DNGs {h}x{w} (+ a virtual copy) in "
            f"{time.perf_counter() - t0:.1f} s")
        ex._render_chunk = spy
        try:
            # the default settings: JPEG q90, batch 4, EXIF copied, GPS stripped
            res, launches, wall = run(paths, tmp / "jpeg")
            report("JPEG q90 (defaults)", res, wall)
            check_launches("JPEG q90", launches)
            created = {p: exif.get_creation_date(parse_virtual_path(p)[0]) for p in paths}
            settings = ex.ExportSettings()
            appearance = {}
            for i, (p, r) in enumerate(zip(paths, res)):
                real, vcn = parse_virtual_path(p)
                appearance[real] = appearance.get(real, 0) + 1
                want = ex._output_path(real, tmp / "jpeg", settings, i + 1, total=len(paths),
                                       vc=vcn, appearance=appearance[real], created=created[p])
                if r.output != str(want):
                    raise RuntimeError(f"{p}: wrote {r.output}, _output_path gives {want}")
            data = Path(res[0].output).read_bytes()
            markers = jpeg_markers(data)
            expect = ["ffd8", "ffe1", "ffe0", "ffdb", "ffdb", "ffc0", "ffc4", "ffc4", "ffc4",
                      "ffc4", "ffda", "ffd9"]
            tags = exif.read_exif_tags(res[0].output)
            log(f"[export] {Path(res[0].output).name}: {len(data)} bytes, markers "
                f"{' '.join(markers)}; EXIF Make {tags.get('Make')!r}, DateTimeOriginal "
                f"{tags.get('DateTimeOriginal')!r}, Orientation {tags.get('Orientation')}, "
                f"GPS tags {sorted(k for k in tags if k.startswith('GPS'))}")
            if (markers != expect or tags.get("Make") != EXPORT_META["make"]
                    or tags.get("DateTimeOriginal") != EXPORT_META["taken"]
                    or tags.get("Orientation") != "1" or any(k.startswith("GPS") for k in tags)):
                raise RuntimeError(f"JPEG {res[0].output}: markers {markers}, tags {tags}")
            if created[paths[0]].strftime("%Y:%m:%d %H:%M:%S") != EXPORT_META["taken"]:
                raise RuntimeError(f"capture date {created[paths[0]]} is not the EXIF's")

            # the encoder alone on one frame of the run
            frame = np.ascontiguousarray(frames[0][2][0].transpose(1, 2, 0))
            t0 = time.perf_counter()
            enc = native.jpeg_encode(frame, 90)
            log(f"[export] jpeg_enc alone: {frame.shape[1]}x{frame.shape[0]} q90 "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms on one host thread, "
                f"{len(enc)} bytes [{card}]")

            two = [paths[0], paths[6]]  # one of each bucket
            for fmt in ("tiff", "png"):
                res, counts, wall = run(two, tmp / fmt, format=fmt)
                report(f"{fmt.upper()} 16-bit", res, wall)
                check_launches(fmt, counts)
            # the TIFF of the first file against its chunk's device_u16 frame
            res, counts, wall = run(two[:1], tmp / "tiff1", format="tiff")
            back = encode.read_tiff16_rgb(res[0].output)
            want = frames[0][2][0].transpose(1, 2, 0)
            if back is None or not np.array_equal(back, want):
                raise RuntimeError("TIFF read back differs from its device_u16 frame")
            tiff_tags = exif.read_exif_tags(res[0].output)
            log(f"[export] TIFF read back by read_tiff16_rgb equals the device_u16 frame "
                f"{want.shape}; merged IFD0 Make {tiff_tags.get('Make')!r}, "
                f"DateTimeOriginal {tiff_tags.get('DateTimeOriginal')!r}")
            res, counts, wall = run(two, tmp / "resized", long_edge=2048)
            report("JPEG q90, long_edge 2048", res, wall)
            check_launches("long_edge 2048", counts)
        finally:
            ex._render_chunk = real_render

        # a 1024 x 1536 file on the card and on the plain CPU path
        ch, cw = CPU_CHECK
        p = tmp / "small" / "check.dng"
        p.parent.mkdir()
        p.write_bytes(raw_dng_bytes(photo_cfa(ch, cw, RAW_BLACK, RAW_WHITE, args.seed + 7),
                                    meta=EXPORT_META))
        p.with_name(p.name + ".rrdata").write_text(json.dumps({"adjustments": CONFIG3_DOC}))
        got = {}
        ex._render_chunk = spy
        try:
            for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
                frames.clear()
                res = ex.export_images([str(p)], tmp / f"small_{name}", ex.ExportSettings(),
                                       device=device)
                if not res[0].ok:
                    raise RuntimeError(f"{name} export: {res[0].error}")
                got[name] = (frames[0][2][0], Path(res[0].output).read_bytes())
        finally:
            ex._render_chunk = real_render
        d = np.abs(got["cuda"][0].astype(np.int16) - got["cpu"][0].astype(np.int16))
        same_bytes = got["cuda"][1] == got["cpu"][1]
        log(f"[export] {ch}x{cw} card vs CPU: u8 frames max|d| {int(d.max())}, values off "
            f"{(d > 0).mean():.2e}; JPEG files {'equal' if same_bytes else 'differ'}")
        if d.max() > 1 or (d > 0).mean() > 1e-3 or (not d.any() and not same_bytes):
            raise RuntimeError("the card's export differs from the CPU's")
        enc = native.jpeg_encode(np.ascontiguousarray(got["cuda"][0].transpose(1, 2, 0)), 90)
        if not got["cuda"][1].endswith(enc[2:]):  # the EXIF segment sits after SOI
            raise RuntimeError("the card's JPEG is not the encoder's file of its frame")
    return launches


LDR_SOURCES = ("shot.jpg", "deep.png", "deep.tif", "lzw.tif")  # phase 15's files


def lzw_literal(data: bytes) -> bytes:
    """TIFF LZW of `data` in 9-bit literal codes: a Clear code before every
    253 bytes keeps the decoder's table under 511 entries, so no code
    widens; an EndOfInformation code ends it. A valid stream that any TIFF
    LZW decoder reads, written with NumPy alone (it compresses nothing)."""
    d = np.frombuffer(data, np.uint8)
    per, block = 253, 253 * 32768  # 32768 groups of 254 codes: whole bytes
    shifts = np.arange(8, -1, -1, dtype=np.uint16)
    out = []
    for s0 in range(0, d.size, block):
        chunk = d[s0:s0 + block]
        groups = -(-chunk.size // per)
        last = s0 + block >= d.size
        codes = np.empty(chunk.size + groups + int(last), np.uint16)
        i = np.arange(chunk.size)
        codes[i + i // per + 1] = chunk
        codes[np.arange(groups) * (per + 1)] = 256
        if last:
            codes[-1] = 257
            codes = np.concatenate([codes, np.zeros((-codes.size) % 8, np.uint16)])
        out.append(np.packbits(((codes[:, None] >> shifts) & 1).astype(np.uint8)).tobytes())
    return b"".join(out)


def ldr_rgb16(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) u16 of a photograph's statistics (three `photo_cfa` fields
    over the full range)."""
    return np.stack([photo_cfa(h, w, 0, 65535, seed + k, noise=300.0) for k in range(3)], -1)


def write_oriented_jpeg(path: Path, rgb8: np.ndarray, orientation: int = 6) -> None:
    """A baseline 4:2:0 JPEG q90 (jpeg_enc.cc) of (H, W, 3) u8 with an
    EXIF APP1 holding only its Orientation."""
    import struct

    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.io import exif

    path.write_bytes(native.jpeg_encode(rgb8, 90))
    ifd = exif.TiffDir("<")
    ifd[274] = orientation
    exif.splice_exif_into_jpeg(path, b"Exif\x00\x00II*\x00" + struct.pack("<I", 8)
                               + ifd.tobytes(8))


def write_ldr_sources(root: Path, h: int, w: int, seed: int) -> dict:
    """Phase 15's files, written with the port's own writers: a baseline
    4:2:0 JPEG q90 (jpeg_enc.cc) with an Orientation = 6 EXIF APP1, a
    16-bit PNG (png_bytes), a 16-bit TIFF (write_tiff16) and an 8-bit LZW
    TIFF (`lzw_literal`, one strip)."""
    from rapidraw_tpu_torch.io import encode

    rgb16 = ldr_rgb16(h, w, seed)
    rgb8 = (rgb16 >> 8).astype(np.uint8)
    root.mkdir(parents=True, exist_ok=True)
    paths = {name: root / name for name in LDR_SOURCES}
    write_oriented_jpeg(paths["shot.jpg"], rgb8)
    paths["deep.png"].write_bytes(encode.png_bytes(rgb16))
    encode.write_tiff16(paths["deep.tif"], rgb16)
    strip = lzw_literal(rgb8.tobytes())
    paths["lzw.tif"].write_bytes(tiff_bytes([[
        (256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [2]),
        (273, 4, ("blob", strip)), (277, 3, [3]), (278, 4, [h]), (279, 4, [len(strip)])]]))
    return paths


def phase_ldr(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 15, LDR inputs and the rest of export (A.10b): the four
    LDR_SOURCES at h x w from --seed (`write_ldr_sources`); the JPEG's host
    decode timed (io/jpeg.py, median of 3); each file's load_image on the
    card held to load_image(device="cpu") (max |d| 0); the blur and grade
    kernels against their plain versions on the loaded JPEG (is_raw False,
    CONFIG3_DOC); export_images on the card with CONFIG3_DOC sidecars,
    JPEG q90, then long_edge 2048, an RGBA watermark PNG and export_masks
    with a fifth file holding a config-4 document, counters reset and read
    around each run (grade and blur once per CONFIG3_DOC chunk in the
    first); images/s, STAGE_STATS seconds and the device memory peak; the
    outputs decoded and checked; and a 1024 x 1536 JPEG export with the
    watermark and masks on the card against the plain CPU path. Returns
    (the launches of the first export run, {(kernel, path): numbers})."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from rapidraw_tpu_torch import load_image, parse_adjustments, stack_params
    from rapidraw_tpu_torch.io import encode, jpeg
    from rapidraw_tpu_torch.ops import blur
    from rapidraw_tpu_torch.pipeline import export as ex
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import bound_ms

    report = {}
    frames = []
    real_render = ex._render_chunk

    def spy(imgs, params, masks, lut, cfg, *a, **k):
        out = real_render(imgs, params, masks, lut, cfg, *a, **k)
        frames.append((tuple(imgs.shape), out))
        return out

    def run(paths, out_dir, device=dev, **kw):
        frames.clear()
        ex.reset_stage_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = ex.export_images(paths, out_dir, ex.ExportSettings(**kw), device=device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        bad = [(r.source, r.error) for r in res if not r.ok]
        if bad:
            raise RuntimeError(f"LDR export failed: {bad}")
        st = dict(ex.STAGE_STATS)
        n = len(res)
        return res, counts, (f"{n} images in {wall:.3f} s = {n / wall:.3f} images/s; stage "
                             f"seconds (summed over threads) decode {st['decode_s']:.3f}, "
                             f"prepare {st['prepare_s']:.3f}, render {st['render_s']:.3f}, "
                             f"encode {st['encode_s']:.3f}; frames {st['frames']}; device "
                             f"memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ldr_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        paths = write_ldr_sources(tmp / "src", h, w, args.seed + 15)
        log(f"[ldr] wrote {', '.join(f'{n} {p.stat().st_size / 2**20:.1f} MiB' for n, p in paths.items())} "
            f"({h}x{w}) in {time.perf_counter() - t0:.1f} s")

        data = paths["shot.jpg"].read_bytes()
        dts = []
        for _ in range(3):
            t0 = time.perf_counter()
            px = jpeg.decode_jpeg(data)
            dts.append(time.perf_counter() - t0)
        log(f"[ldr] JPEG decode (csrc/host/jpeg_dec.cc, one host thread) {h}x{w} 4:2:0 q90: "
            f"{statistics.median(dts) * 1e3:.1f} ms (median of 3, {min(dts) * 1e3:.1f}-"
            f"{max(dts) * 1e3:.1f}) [{card}]")
        if px.shape != (h, w, 3):
            raise RuntimeError(f"decoded JPEG shape {px.shape}")
        del px

        # each file on the card against the plain CPU path
        images = {}
        for name, p in paths.items():
            t0 = time.perf_counter()
            got, is_raw = load_image(p, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            want, _ = load_image(p, device="cpu")
            d = float((got.cpu() - want).abs().max())
            log(f"[ldr] {name}: load_image on the card {dt * 1e3:.1f} ms, shape "
                f"{tuple(got.shape)}, max|d| vs device='cpu' {d:g}")
            if is_raw or d != 0.0 or got.device.type != "cuda" or got.dtype != torch.float32:
                raise AssertionError(f"{name}: the card's load differs from the CPU's ({d})")
            images[name] = got
        if tuple(images["shot.jpg"].shape) != (3, w, h):
            raise AssertionError("the JPEG's Orientation = 6 was not applied")

        # the blur and grade kernels on the LDR image against their plain versions
        x = images["shot.jpg"][None]
        del images
        p, c = parse_adjustments(CONFIG3_DOC, is_raw=False)
        sp, cfg = stack_params([p], [c], device=dev)
        radii = tuple(fused.blur_radii(cfg, h, w).values())
        flat = x.reshape(3, w, h)
        got = blur.gaussian_blur_multi(flat, radii)
        ref, ops = count_ops(lambda: blur.gaussian_blur_multi_plain(flat, radii))
        err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(got, ref))
        ms = time_ms(lambda: blur.gaussian_blur_multi(flat, radii), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(flat, radii), reps)
        bms, bby = bound_ms(nbytes(flat) * (1 + len(radii)), ops)
        convs = []
        for r in radii:
            k1 = torch.from_numpy(blur._gauss_weights(r)).to(dev)
            k2 = (k1[:, None] * k1[None, :]).expand(3, 1, 2 * r + 1, 2 * r + 1).contiguous()
            convs.append((F.pad(flat[None], (r, r, r, r), mode="replicate"), k2))
        lms = time_ms(lambda: [F.conv2d(xp, k2, groups=3) for xp, k2 in convs], reps)
        del convs, got, ref
        report["blur", "ldr_export"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                            library_ms=lms, max_abs_err=err)
        log(f"[ldr] blur on the JPEG's image (3, {w}, {h}) r={radii}: max|d|/max(1,|ref|) "
            f"{err:.3e} (bound {BLUR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound "
            f"{bms:.3f} ms ({bby}); library: one depthwise conv2d per radius {lms:.3f} ms "
            f"[{card}]")
        if err > BLUR_TOL:
            raise AssertionError(f"blur on the LDR path: max|d| {err} > {BLUR_TOL}")
        pmat = fused.pack_rows(sp["glob"])
        levels = fused.blur_levels(x, cfg)
        for dither in (False, True):
            cd = dataclasses.replace(cfg, dither_active=dither)
            got = fused.grade(x, levels, pmat, cd)
            ref, ops = count_ops(lambda: fused.grade_plain(x, levels, pmat, cd))
            err = float((got - ref).abs().max())
            tol = GRADE_DITHER_TOL if dither else GRADE_TOL
            line = (f"[ldr] grade B=1 config3 (is_raw False) dither={'on' if dither else 'off'}: "
                    f"max|d| {err:.3e} (bound {tol:.3e})")
            if not dither:
                ms = time_ms(lambda: fused.grade(x, levels, pmat, cd), reps)
                pms = time_ms(lambda: fused.grade_plain(x, levels, pmat, cd), reps)
                bms, bby = bound_ms(nbytes(x, pmat, *levels.values()) + nbytes(x), ops)
                report["grade", "ldr_export"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                     bound_by=bby, library_ms=None,
                                                     max_abs_err=err)
                line += f" kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms ({bby}) [{card}]"
            log(line)
            if not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(f"grade on the LDR path: max|d| {err} > {tol}")
            del got, ref
        del levels, x, flat

        # export: CONFIG3_DOC sidecars, JPEG q90
        srcs = [str(q) for q in paths.values()]
        for q in srcs:
            Path(q + ".rrdata").write_text(json.dumps({"adjustments": CONFIG3_DOC}))
        ex._render_chunk = spy
        try:
            res, launches, line = run(srcs, tmp / "jpeg")
            log(f"[ldr-export] JPEG q90: {line} [{card}]")
            want = {"grade": len(frames), "blur": len(frames)}
            others = {k: v for k, v in launches.items() if k not in want and v}
            log(f"[ldr-export] chunks {[s for s, _ in frames]}, launches {launches}")
            if {k: launches[k] for k in want} != want or others:
                raise RuntimeError(f"LDR export launches {launches}, expected {want} and no other")
            for r in res:
                out = jpeg.decode_jpeg(Path(r.output).read_bytes())
                if out.shape not in ((h, w, 3), (w, h, 3)):
                    raise RuntimeError(f"{r.output}: decoded shape {out.shape}")

            # long_edge 2048, an RGBA watermark and the per-mask exports
            logo = np.zeros((h // 16, w // 8, 4), np.uint8)
            logo[..., 0], logo[..., 1] = 240, 200
            logo[..., 3] = np.linspace(0, 255, logo.shape[1], dtype=np.uint8)
            (tmp / "logo.png").write_bytes(encode.png_bytes(logo))
            masked = tmp / "src" / "masks.png"
            shutil.copy(paths["deep.png"], masked)
            Path(str(masked) + ".rrdata").write_text(
                json.dumps({"adjustments": config4_doc(h, w)}))
            wm = ex.WatermarkSettings(path=str(tmp / "logo.png"), anchor="bottomRight",
                                      scale=20.0, opacity=80.0)
            res2, counts2, line = run(srcs + [str(masked)], tmp / "wm", long_edge=2048,
                                      watermark=wm, export_masks=True)
            log(f"[ldr-export] JPEG q90, long_edge 2048, watermark, export_masks: {line}; "
                f"launches {counts2} (chunks {len(frames)}, plus one develop per mask "
                f"image) [{card}]")
            if counts2["grade"] != len(frames) + 3:
                raise RuntimeError(f"watermark/masks run: launches {counts2}")
            edge = 2048 if max(h, w) > 2048 else max(h, w)  # dont_enlarge
            stem = Path(res2[-1].output).stem
            for i in range(3):
                img = jpeg.decode_jpeg((tmp / "wm" / f"{stem}_mask_{i}_image.jpg").read_bytes())
                alpha = encode.decode_png_gray((tmp / "wm" / f"{stem}_mask_{i}_alpha.png")
                                               .read_bytes())
                if img.shape[:2] != alpha.shape or max(alpha.shape) != edge:
                    raise RuntimeError(f"mask {i}: image {img.shape}, alpha {alpha.shape}")
            for r in res2:
                out = jpeg.decode_jpeg(Path(r.output).read_bytes())
                if max(out.shape[:2]) != edge:
                    raise RuntimeError(f"{r.output}: decoded shape {out.shape}")
            log(f"[ldr-export] outputs: {len(res2)} JPEGs at long edge {edge} and "
                f"{stem}_mask_0..2_image.jpg / _alpha.png, decoded and checked")
        finally:
            ex._render_chunk = real_render

        # a small JPEG with the watermark and masks: the card against the CPU
        ch, cw = CPU_CHECK
        small = write_ldr_sources(tmp / "small", ch, cw, args.seed + 16)["shot.jpg"]
        Path(str(small) + ".rrdata").write_text(json.dumps({"adjustments": config4_doc(ch, cw)}))
        got = {}
        ex._render_chunk = spy
        try:
            for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
                frames.clear()
                res = ex.export_images([str(small)], tmp / f"small_{name}", ex.ExportSettings(
                    watermark=wm, export_masks=True), device=device)
                if not res[0].ok:
                    raise RuntimeError(f"{name} LDR export: {res[0].error}")
                out = Path(res[0].output)
                got[name] = (frames[0][1][0], [encode.decode_png_gray(
                    (out.parent / f"{out.stem}_mask_{i}_alpha.png").read_bytes())
                    for i in range(3)])
        finally:
            ex._render_chunk = real_render
        d = np.abs(got["cuda"][0].astype(np.int16) - got["cpu"][0].astype(np.int16))
        same_alpha = all(np.array_equal(a, b) for a, b in zip(got["cuda"][1], got["cpu"][1]))
        log(f"[ldr-export] {ch}x{cw} JPEG + watermark + masks, card vs CPU: u8 frames max|d| "
            f"{int(d.max())}, values off {(d > 0).mean():.2e}; alpha PNGs "
            f"{'equal' if same_alpha else 'differ'}")
        if d.max() > 1 or (d > 0).mean() > 1e-3 or not same_alpha:
            raise RuntimeError("the card's LDR export differs from the CPU's")
    return launches, report


PREVIEW_ROI = (0.31, 0.22, 0.37, 0.41)  # phase 16's ROI: an odd crop of the preview
PREVIEW_KERNELS = ("blur", "grade", "nr", "nr_dynamic", "flare", "resample")
WORKER_JOBS = 30  # phase 16's PreviewWorker burst, one job every 5 ms


def guide_scene(h: int, w: int, seed: int) -> np.ndarray:
    """(3, h, w) u8 with straight edges for the guides: a horizon, a
    vertical post, a slope tilted ~15 degrees, uniform noise."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 90, np.int64)
    img[h // 3:, :] = 170
    img[:, w // 2: w // 2 + 5] = 30
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy - 0.27 * xx) > h * 0.55] = 220
    img = np.clip(img + rng.integers(-10, 11, img.shape), 0, 255).astype(np.uint8)
    return np.repeat(img[None], 3, 0)


def resample_library_ms(src, e_arr, bases, stat, reps):
    """The resample kernel's library yardstick: ms of one bilinear
    grid_sample of the same source rows at the same (column, row + e)
    points (zeros outside, as the kernel's sentinel)."""
    import torch.nn.functional as F

    from rapidraw_tpu_torch.geometry import warp_fast

    hp, wp = e_arr.shape
    rr = torch.arange(hp, device=src.device)[:, None]
    base = bases.to(torch.int64).reshape(stat.nty, -1) * 8 - stat.pad_lo
    base = base.repeat_interleave(warp_fast.TH, 0).repeat_interleave(warp_fast.TWH, 1)
    row = (base + rr % warp_fast.TH).to(torch.float32) + e_arr
    col = torch.arange(wp, device=src.device, dtype=torch.float32)[None].expand_as(row)
    grid = torch.stack([col * (2.0 / (src.shape[2] - 1)) - 1.0,
                        row * (2.0 / (src.shape[1] - 1)) - 1.0], -1)[None]
    return time_ms(lambda: F.grid_sample(src[None], grid, mode="bilinear",
                                         padding_mode="zeros", align_corners=True), reps)


def blur_library_ms(flat, radii, reps) -> float:
    """The blur's library yardstick: ms of one depthwise 2-D conv2d per
    radius of the same (N, H, W) planes, edge-replicated."""
    import torch.nn.functional as F

    from rapidraw_tpu_torch.ops import blur

    n = flat.shape[0]
    convs = []
    for r in radii:
        k1 = torch.from_numpy(blur._gauss_weights(r)).to(flat.device)
        k2 = (k1[:, None] * k1[None, :]).expand(n, 1, 2 * r + 1, 2 * r + 1).contiguous()
        convs.append((F.pad(flat[None], (r, r, r, r), mode="replicate"), k2))
    return time_ms(lambda: [F.conv2d(xp, k2, groups=n) for xp, k2 in convs], reps)


def preview_kernels_vs_plain(cases, reps, card, dev, gen):
    """The develop kernels against their plain versions on random images:
    blur (every level of FULL_DOC), grade (config 3, and its masks build
    with config 4's masks), NR (config 5's amounts, and masked_nr_doc's
    amount maps), the resample passes of config 5's warp plan and the
    flare maps, each at the (h, w) of every case of `cases`, a list of
    ((h, w), path, kept): the numbers of the kernels in `kept` are
    returned as {(kernel, path): numbers}."""
    import torch.nn.functional as F

    from rapidraw_tpu_torch import blur_band_rows, parse_adjustments, rasterize_masks, stack_params
    from rapidraw_tpu_torch.geometry import warp_fast
    from rapidraw_tpu_torch.geometry.params import geometry_params_from_json
    from rapidraw_tpu_torch.ops import blur, flare, nr
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import bound_ms

    report = {}
    for (sh, sw), path, kept in cases:
        x = torch.rand((1, 3, sh, sw), generator=gen, device=dev)
        tag = f"[{path or 'preview'}-kernel]"

        def keep(name, **numbers):
            if name in kept:
                report[name, path] = numbers

        # blur: every level FULL_DOC takes at this size, one launch
        radii = tuple(fused.blur_radii(parse_adjustments(FULL_DOC)[1], sh, sw).values())
        flat = x[0]
        got = blur.gaussian_blur_multi(flat, radii)
        ref, ops = count_ops(lambda: blur.gaussian_blur_multi_plain(flat, radii))
        err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(got, ref))
        ms = time_ms(lambda: blur.gaussian_blur_multi(flat, radii), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(flat, radii), reps)
        bms, bby = bound_ms(nbytes(flat) * (1 + len(radii)), ops)
        lms = blur_library_ms(flat, radii, reps)
        keep("blur", ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=lms,
             max_abs_err=err)
        log(f"{tag} blur (3,{sh},{sw}) r={radii}: max|d|/max(1,|ref|) {err:.3e} "
            f"(bound {BLUR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
            f"({bby}); library: one depthwise conv2d per radius {lms:.3f} ms [{card}]")
        if err > BLUR_TOL:
            raise AssertionError(f"blur at ({sh},{sw}): max|d| {err}")
        del got, ref

        # grade: config 3 (no masks) and config 4 (the masks build), B = 1
        docs = (("config3", CONFIG3_DOC, None), ("config4 masks", config4_doc(sh, sw), True))
        for label, doc, with_masks in docs:
            p, c = parse_adjustments(doc)
            sp, cfg = stack_params([p], [c], device=dev)
            cfg = dataclasses.replace(cfg, dither_active=False)
            pmat = fused.pack_rows(sp["glob"])
            mk = mm = None
            bands = None
            extra = ()
            if with_masks:
                bm = rasterize_masks(doc, sw, sh, scale=1.0)
                mk = torch.from_numpy(bm[None]).to(dev)
                mm = fused.pack_mask_rows(sp["mask"])
                bands = blur_band_rows(cfg, bm)
                extra = (mk, mm)
            levels = fused.blur_levels(x, cfg, bands)
            got = fused.grade(x, levels, pmat, cfg, masks=mk, mmat=mm)
            ref, ops = count_ops(lambda: fused.grade_plain(x, levels, pmat, cfg, masks=mk,
                                                           mmat=mm))
            err = float((got - ref).abs().max())
            ms = time_ms(lambda: fused.grade(x, levels, pmat, cfg, masks=mk, mmat=mm), reps)
            pms = time_ms(lambda: fused.grade_plain(x, levels, pmat, cfg, masks=mk, mmat=mm),
                          reps)
            bms, bby = bound_ms(nbytes(x, pmat, *levels.values(), *extra) + nbytes(x), ops)
            if label == "config3":
                keep("grade", ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=None,
                     max_abs_err=err)
            log(f"{tag} grade {label} B=1 (3,{sh},{sw}): max|d| {err:.3e} (bound "
                f"{GRADE_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
                f"({bby}) [{card}]")
            if not bool(torch.isfinite(got).all()) or err > GRADE_TOL:
                raise AssertionError(f"grade {label} at ({sh},{sw}): max|d| {err}")
            del got, ref, levels

        # NR at config 5's amounts and this size's resolution scale
        p5, _ = parse_adjustments(CONFIG5_DOC)
        la, ca = float(p5["glob"]["luma_nr"]), float(p5["glob"]["color_nr"])
        scale = scales.resolution_scale(sw, sh)
        center = srgb_to_linear(x).contiguous()
        planes = nr.nr_planes(x, False).contiguous()
        got = nr.nr_static(center, planes, la, ca, scale)
        ref, ops = count_ops(lambda: nr.nr_static_plain(center, planes, la, ca, scale))
        err = float((got - ref).abs().max())
        ms = time_ms(lambda: nr.nr_static(center, planes, la, ca, scale), reps)
        pms = time_ms(lambda: nr.nr_static_plain(center, planes, la, ca, scale), reps)
        bms, bby = bound_ms(nbytes(center, planes) + nbytes(center), ops)
        keep("nr", ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=None,
             max_abs_err=err)
        log(f"{tag} nr config5 B=1 (3,{sh},{sw}) max offset "
            f"{nr._consts(la, ca, scale)['max_off']}: max|d| {err:.3e} (bound {NR_TOL:g}) "
            f"kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms ({bby}) [{card}]")
        if not bool(torch.isfinite(got).all()) or err > NR_TOL:
            raise AssertionError(f"nr at ({sh},{sw}): max|d| {err}")
        del got, ref

        # per-pixel NR: masked_nr_doc's amount maps at this size
        ndoc = masked_nr_doc(sh, sw)
        p, c = parse_adjustments(ndoc)
        spn, cfgn = stack_params([p], [c], device=dev)
        nmk = torch.from_numpy(rasterize_masks(ndoc, sw, sh, scale=1.0)[None]).to(dev)
        la, ca = fused.nr_amounts(spn, cfgn, nmk, dev)
        got = nr.nr_dynamic(center, planes, la, ca, scale)
        ref, ops = count_ops(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale))
        err = float((got - ref).abs().max())
        ms = time_ms(lambda: nr.nr_dynamic(center, planes, la, ca, scale), reps)
        pms = time_ms(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale), 1)
        bms, bby = bound_ms(nbytes(center, planes, la, ca) + nbytes(center), ops)
        keep("nr_dynamic", ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=None,
             max_abs_err=err)
        log(f"{tag} nr_dynamic masked_nr_doc B=1 (3,{sh},{sw}) amount maps: max|d| "
            f"{err:.3e} (bound {NR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound "
            f"{bms:.3f} ms ({bby}) [{card}]")
        if not bool(torch.isfinite(got).all()) or err > NR_TOL:
            raise AssertionError(f"nr_dynamic at ({sh},{sw}): max|d| {err}")
        del got, ref, center, planes, la, ca, nmk

        # resample: every pass of config 5's warp plan at this size
        plan = warp_fast.plan_warp(geometry_params_from_json(CONFIG5_GEOMETRY), sh, sw,
                                   device=dev)
        if plan is None:
            raise AssertionError(f"the planner refused config 5's geometry at ({sh},{sw})")
        st = plan.static
        xp = F.pad(x, (0, st.wp - sw, 0, st.hp - sh))
        rerr, rms, rpms, rlms, rbytes, rops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for mi, (channels, vstat, hstat) in enumerate(st.modes):
            part = xp[:, list(channels)].reshape(-1, st.hp, st.wp).contiguous()
            tmp_v = warp_fast.resample_rows(part, plan.arrays[f"ev{mi}"], plan.arrays[f"bv{mi}"],
                                            vstat)
            tmp_t = tmp_v.transpose(1, 2).contiguous()
            for key, src, stat in (("v", part, vstat), ("h", tmp_t, hstat)):
                e_arr, bases = plan.arrays[f"e{key}{mi}"], plan.arrays[f"b{key}{mi}"]
                got = warp_fast.resample_rows(src, e_arr, bases, stat)
                ref, ops = count_ops(lambda: warp_fast.resample_rows_plain(src, e_arr, bases,
                                                                           stat))
                rerr = max(rerr, float((got - ref).abs().max()))
                rms += time_ms(lambda: warp_fast.resample_rows(src, e_arr, bases, stat), reps)
                rpms += time_ms(lambda: warp_fast.resample_rows_plain(src, e_arr, bases, stat),
                                reps)
                rlms += resample_library_ms(src, e_arr, bases, stat, reps)
                rbytes += nbytes(src, e_arr, bases, got)
                rops += ops
                del got, ref
        rbms, rbby = bound_ms(rbytes, rops)
        keep("resample", ms=rms, plain_ms=rpms, bound_ms=rbms, bound_by=rbby, library_ms=rlms,
             max_abs_err=rerr)
        log(f"{tag} resample config5 plan ({sh},{sw}), {2 * len(st.modes)} passes summed: "
            f"max|d| {rerr:.3e} (bound {RESAMPLE_TOL:g}) kernel {rms:.3f} ms plain "
            f"{rpms:.3f} ms bound {rbms:.3f} ms ({rbby}); library: one grid_sample per pass "
            f"{rlms:.3f} ms; kernel/library {rms / rlms:.2f} [{card}]")
        if rerr > RESAMPLE_TOL:
            raise AssertionError(f"resample at ({sh},{sw}): max|d| {rerr}")
        del xp, plan

        # flare maps of one bright image at this size
        b = x.clone() * 0.7
        yy = torch.arange(sh, device=dev)[:, None]
        xx = torch.arange(sw, device=dev)[None, :]
        for cy, cx in ((0.3, 0.25), (0.6, 0.7)):
            b[:, :, (yy - cy * sh) ** 2 + (xx - cx * sw) ** 2 <= (0.03 * sh) ** 2] = 1.0
        spf, _ = stack_params([parse_adjustments(FLARE_LUT_DOC)[0]], [parse_adjustments(
            FLARE_LUT_DOC)[1]], device=dev)
        fp = fused.pack_rows(spf["glob"])[:, [fused.OFFSETS[k] for k in flare.FLARE_PARAMS]]
        fp = fp.contiguous()
        got = flare.flare_maps(b, fp, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = flare.flare_maps_plain(b, fp, False)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        _, ops = count_ops(lambda: flare.flare_maps_plain(b, fp, False))
        err = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
        ms = time_ms(lambda: flare.flare_maps(b, fp, False), reps)
        n = flare.FLARE_MAP_SIZE
        bms, bby = bound_ms(n * n * (4 * 3 * 4 + 3 * 4) + nbytes(fp), ops)
        keep("flare", ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, library_ms=None,
             max_abs_err=err)
        log(f"{tag} flare B=1 ({sh},{sw}) -> (1,{n},{n},3): max|d|/max(1,|ref|) "
            f"{err:.3e} (bound {FLARE_TOL:g}) kernel {ms:.3f} ms plain {pms:.1f} ms (one run) "
            f"bound {bms:.3f} ms ({bby}) [{card}]")
        if err > FLARE_TOL:
            raise AssertionError(f"flare at ({sh},{sw}): max|d| {err}")
        del got, ref, b, x
    return report


def phase_preview(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 16, the preview service (A.11a): a 16-bit DNG (photograph-like,
    with capture metadata) and a q90 JPEG (Orientation 6) at h x w from
    --seed, in a temporary directory, through RenderService on the card
    (default settings: 1920 long edge, quality "high"): the cold render
    split by stage (decode + EXIF persist, transform + downscale, masks,
    develop with its device ms from CUDA events, readback, encode) with the
    device memory peak, warm frames with the exposure changed (median of
    10), the interactive 'performance' frame (divisor 2, q65), PREVIEW_ROI,
    the scopes, config 4's masks (a mask-cache hit on the second frame),
    config 5 with its geometry (NR and the resample kernel), FLARE_LUT_DOC
    (flare and the LUT) and masked_nr_doc (per-pixel NR); the uncropped,
    original, preset and geometry previews, the guides, auto adjust;
    PreviewWorker on a burst of WORKER_JOBS documents and AnalyticsWorker;
    the kernels against their plain versions at the preview's shapes
    (`preview_kernels_vs_plain`); a 1024 x 1536 source through the service
    on the card against device="cpu". The counters are reset before the
    renders and read after them: every kernel of PREVIEW_KERNELS must have
    run. Returns (launches, {(kernel, "preview"): numbers})."""
    import tempfile

    from rapidraw_tpu_torch import AnalyticsWorker, PreviewWorker, RenderService
    from rapidraw_tpu_torch.geometry.params import GeometryParams
    from rapidraw_tpu_torch.io import jpeg
    from rapidraw_tpu_torch.io.sidecar import load_sidecar
    from rapidraw_tpu_torch.masks import rasterize as rz
    from rapidraw_tpu_torch.pipeline import export as ex
    from rapidraw_tpu_torch.pipeline import guides
    from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings

    gen = torch.Generator(device=dev).manual_seed(16)
    seed = args.seed + 16
    total = {}

    def delta(before, after):
        return {k: after[k] - before[k] for k in after if after[k] - before[k]}

    def timed(label, fn, expect=None):
        """One render: host ms to the result, the launches it made."""
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        made = delta(before, read_counts())
        if expect is not None and {k: made.get(k, 0) for k in expect} != expect:
            raise RuntimeError(f"[preview] {label}: launches {made}, expected {expect}")
        return out, dt, made

    def stages_line(res):
        st = res.stages or {}
        return ", ".join(f"{k} {v:.2f}" for k, v in st.items())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_preview_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        dng = tmp / "shot.dng"
        dng.write_bytes(raw_dng_bytes(photo_cfa(h, w, 64, 16383, seed), meta=EXPORT_META))
        jpg = tmp / "shot.jpg"
        write_oriented_jpeg(jpg, (ldr_rgb16(h, w, seed) >> 8).astype(np.uint8))
        write_cube(tmp / "p16.cube")
        log(f"[preview] wrote {dng.name} {dng.stat().st_size / 2**20:.1f} MiB and {jpg.name} "
            f"{jpg.stat().st_size / 2**20:.1f} MiB ({h}x{w}) in {time.perf_counter() - t0:.1f} s")

        svc = RenderService(device=dev, time_stages=True)
        reset_counts()
        start = read_counts()

        # 1. cold: decode + EXIF persist, transform + downscale, develop, encode
        dims = {}
        for src in (dng, jpg):
            torch.cuda.reset_peak_memory_stats()
            res, ms, made = timed(f"cold {src.name}", lambda: svc.render_preview(
                str(src), CONFIG3_DOC), {"grade": 1, "blur": 1})
            log(f"[preview] cold {src.name} CONFIG3_DOC -> {res.width}x{res.height} JPEG q94 "
                f"{len(res.jpeg) / 1024:.0f} KiB: {ms:.1f} ms; stage ms: {stages_line(res)}; "
                f"launches {made}; device memory peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
            if max(res.width, res.height) != min(1920, max(h, w)):
                raise RuntimeError(f"cold preview size {res.width}x{res.height}")
            exif = load_sidecar(str(src)).get("exif") or {}
            if src == dng and exif.get("Make") != EXPORT_META["make"]:
                raise RuntimeError(f"the DNG's EXIF was not persisted: {exif}")
            if src == jpg and res.height < res.width:
                raise RuntimeError("the JPEG's Orientation = 6 was not applied")
            dims[src] = (res.height, res.width)
        p = str(dng)
        ph, pw = dims[dng]

        # 2. warm: the exposure changes, the transformed preview is cached
        svc.time_stages = False
        times = []
        for i in range(10):
            r, ms, made = timed("warm", lambda: svc.render_preview(
                p, dict(CONFIG3_DOC, exposure=0.05 * i)), {"grade": 1, "blur": 1})
            times.append(ms)
        svc.time_stages = True
        r, _, _ = timed("warm split", lambda: svc.render_preview(p, dict(CONFIG3_DOC,
                                                                       exposure=0.61)))
        log(f"[preview] warm {r.width}x{r.height} CONFIG3_DOC, exposure changed: median "
            f"{statistics.median(times):.2f} ms of 10 ({min(times):.2f}-{max(times):.2f}); one "
            f"more frame's stage ms: {stages_line(r)}; launches per frame grade 1, blur 1 "
            f"[{card}]")

        # 3. interactive under 'performance': divisor 2, q65
        svc.settings["livePreviewQuality"] = "performance"
        times = []
        for i in range(10):
            r, ms, _ = timed("interactive", lambda: svc.render_preview(
                p, dict(CONFIG3_DOC, exposure=0.05 * i), interactive=True))
            times.append(ms)
        log(f"[preview] interactive 'performance' {r.width}x{r.height} q65: median "
            f"{statistics.median(times):.2f} ms of 10 ({min(times):.2f}-{max(times):.2f}); "
            f"stage ms: {stages_line(r)} [{card}]")
        if (r.full_width, r.full_height) != (max(int(pw / 2), 1), max(int(ph / 2), 1)):
            raise RuntimeError(f"interactive dims {r.full_width}x{r.full_height}")
        svc.settings["livePreviewQuality"] = "high"

        # 4. ROI; 5. scopes
        times = []
        for i in range(10):
            r, ms, _ = timed("roi", lambda: svc.render_preview(
                p, dict(CONFIG3_DOC, exposure=0.05 * i), roi=PREVIEW_ROI))
            times.append(ms)
        want_roi = (int(0.31 * pw), int(0.22 * ph), int(0.37 * pw), int(0.41 * ph))
        log(f"[preview] ROI {PREVIEW_ROI} -> {r.roi}: median {statistics.median(times):.2f} ms "
            f"of 10; stage ms: {stages_line(r)}; binary header {r.to_binary()[:24].hex()} "
            f"[{card}]")
        if r.roi != want_roi or (r.width, r.height) != want_roi[2:]:
            raise RuntimeError(f"ROI {r.roi}, expected {want_roi}")
        roi_shape = (r.height, r.width)
        times = []
        for i in range(5):
            r, ms, _ = timed("scopes", lambda: svc.render_preview(
                p, dict(CONFIG3_DOC, exposure=0.05 * i), compute_histogram=True,
                compute_waveform=True))
            times.append(ms)
        if len(r.histogram["luma"]) != 256 or r.waveform["rgb"].shape != (256, 256, 4):
            raise RuntimeError("scopes missing")
        log(f"[preview] with histogram + waveform: median {statistics.median(times):.2f} ms of 5; "
            f"stage ms: {stages_line(r)} [{card}]")

        # 6. per document
        calls = {"n": 0}
        real_raster = rz.rasterize_masks

        def counting(*a, **k):
            calls["n"] += 1
            return real_raster(*a, **k)

        rz.rasterize_masks = counting
        try:
            d4 = config4_doc(h, w)
            r1, ms1, made1 = timed("config4", lambda: svc.render_preview(p, d4),
                                   {"grade": 1})
            d4b = json.loads(json.dumps(d4))
            d4b["masks"][0]["adjustments"]["exposure"] = 0.7
            r2, ms2, made2 = timed("config4 warm", lambda: svc.render_preview(p, d4b),
                                   {"grade": 1})
        finally:
            rz.rasterize_masks = real_raster
        log(f"[preview] config 4 masks: first frame {ms1:.1f} ms (masks rasterized, stage ms: "
            f"{stages_line(r1)}), a mask's grade changed {ms2:.1f} ms (stage ms: "
            f"{stages_line(r2)}); rasterizations {calls['n']}; launches {made1}, {made2} "
            f"[{card}]")
        if calls["n"] != 1:
            raise RuntimeError(f"the mask cache missed: {calls['n']} rasterizations")
        docs = (("config5 + geometry", dict(CONFIG5_DOC, **CONFIG5_GEOMETRY),
                 {"nr": 1, "grade": 1, "blur": 1}),
                ("FLARE_LUT_DOC", dict(FLARE_LUT_DOC, lutPath=str(tmp / "p16.cube")),
                 {"flare": 1, "grade": 1, "blur": 1}),
                ("masked_nr_doc", masked_nr_doc(h, w), {"nr_dynamic": 1, "grade": 1}))
        for label, doc, expect in docs:
            r, ms, made = timed(label, lambda: svc.render_preview(p, doc), expect)
            r2, ms2, made2 = timed(label, lambda: svc.render_preview(
                p, dict(doc, exposure=0.41)), expect)
            if label.startswith("config5") and made.get("resample", 0) < 2:
                raise RuntimeError(f"config 5's preview did not resample: {made}")
            log(f"[preview] {label}: first frame {ms:.1f} ms (stage ms: {stages_line(r)}; "
                f"launches {made}), exposure changed {ms2:.1f} ms (stage ms: "
                f"{stages_line(r2)}; launches {made2}) [{card}]")

        # 7. the secondary previews
        out, ms, made = timed("uncropped", lambda: svc.render_uncropped_preview(
            p, dict(CONFIG3_DOC, crop={"x": 10, "y": 20, "width": w // 2, "height": h // 2})))
        log(f"[preview] uncropped (crop ignored) {ms:.1f} ms, {len(out) / 1024:.0f} KiB; "
            f"launches {made} [{card}]")
        out, ms, made = timed("original", lambda: svc.render_original_preview(
            p, dict(CONFIG3_DOC, rotation=2.0)))
        log(f"[preview] original (RAW look, no grade) {ms:.1f} ms; launches {made} [{card}]")
        out, ms, made = timed("preset", lambda: svc.render_preset_preview(p, CONFIG1_DOC),
                              {"grade": 1})
        dec = jpeg.decode_jpeg(out)
        log(f"[preview] preset thumbnail {dec.shape[1]}x{dec.shape[0]} {ms:.1f} ms cold, "
            f"launches {made} [{card}]")
        if not 398 <= max(dec.shape[:2]) <= 400:  # the area downscale's rounded ratio
            raise RuntimeError(f"preset thumbnail {dec.shape}")
        gp = GeometryParams(rotate=2.5, vertical=8.0)
        for lines in (False, True, False):
            out, ms, made = timed("geometry", lambda: svc.preview_geometry_transform(
                p, gp, CONFIG3_DOC, show_lines=lines))
            log(f"[preview] geometry preview rotate 2.5, vertical 8, guides {lines}: "
                f"{ms:.1f} ms; launches {made} [{card}]")
        frame = np.ascontiguousarray(jpeg.decode_jpeg(out).transpose(2, 0, 1))
        fh, fw = frame.shape[1:]
        for label, f in (("the preview", frame), ("a scene with straight edges",
                                                  guide_scene(fh, fw, seed))):
            gms = median_host_ms(lambda: guides.draw_straightening_guides(f), 3)
            drawn = int((guides.draw_straightening_guides(f) != f).any(0).sum())
            log(f"[preview] straightening guides alone on {label} ({fw}x{fh}): {gms:.1f} ms "
                f"host (median of 3), {drawn} pixels drawn [{card}]")
            if label != "the preview" and not drawn:
                raise RuntimeError("the guides found no line in the scene")

        # 8. auto adjust
        adj, ms, _ = timed("auto", lambda: svc.auto_adjustments(p))
        log(f"[preview] auto_adjustments {ms:.1f} ms: exposure {adj['exposure']:.3f}, "
            f"contrast {adj['contrast']:.2f}, whites {adj['whites']:.2f} [{card}]")

        # 9. the workers: a burst of documents, then the scopes of the last frame
        svc.time_stages = False
        got = []
        done = {"t": None}
        last_doc = dict(CONFIG3_DOC, exposure=0.02 * (WORKER_JOBS - 1))

        def on_result(res):
            got.append(res)
            done["t"] = time.perf_counter()

        worker = PreviewWorker(svc, on_result)
        try:
            for i in range(WORKER_JOBS):
                t_last = time.perf_counter()
                worker.submit(p, dict(CONFIG3_DOC, exposure=0.02 * i))
                time.sleep(0.005)
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                time.sleep(0.01)
                with worker._cond:
                    idle = worker._pending is None
                if idle and done["t"] is not None and done["t"] > t_last and len(got) and \
                        time.perf_counter() - done["t"] > 0.3:
                    break
        finally:
            worker.close()
        bad = [g for g in got if isinstance(g, Exception)]
        if bad or not got:
            raise RuntimeError(f"PreviewWorker: {bad or 'no result'}")
        direct = svc.render_preview(p, last_doc)
        if got[-1].jpeg != direct.jpeg:
            raise RuntimeError("the worker's last result is not the last document's render")
        log(f"[preview] PreviewWorker: {WORKER_JOBS} documents submitted 5 ms apart, "
            f"{len(got)} rendered (coalesced {WORKER_JOBS - len(got)}), the last one last; "
            f"last submit to its callback {(done['t'] - t_last) * 1e3:.1f} ms [{card}]")
        planar = np.ascontiguousarray(jpeg.decode_jpeg(direct.jpeg).transpose(2, 0, 1))
        scopes = []
        ev = {"t": None}

        def on_scopes(s):
            scopes.append(s)
            ev["t"] = time.perf_counter()

        aw = AnalyticsWorker(on_scopes)
        try:
            t0 = time.perf_counter()
            aw.submit(planar)
            while ev["t"] is None and time.perf_counter() - t0 < 30:
                time.sleep(0.002)
        finally:
            aw.close()
        if not scopes or isinstance(scopes[0], Exception) or "waveform" not in scopes[0]:
            raise RuntimeError(f"AnalyticsWorker: {scopes}")
        log(f"[preview] AnalyticsWorker on the last frame ({planar.shape[2]}x{planar.shape[1]}): "
            f"histogram + waveform in {(ev['t'] - t0) * 1e3:.1f} ms [{card}]")

        launches = delta(start, read_counts())
        launches = {k: launches.get(k, 0) for k in read_counts()}
        missing = [k for k in PREVIEW_KERNELS if not launches[k]]
        log(f"[preview] launches over the phase's renders {launches}")
        if missing:
            raise RuntimeError(f"the preview path never launched {missing}")

        # the kernels against their plain versions at the preview's shapes
        # the service warps at the source's size (phase 7's shape), so the
        # resample rows at these shapes are held but are not the preview's
        report = preview_kernels_vs_plain(
            [((ph, pw), "preview", ("blur", "grade", "nr", "nr_dynamic", "flare")),
             (roi_shape, None, ())], reps, card, dev, gen)

        # the card against the CPU at 1024 x 1536
        ch, cw = CPU_CHECK
        small = tmp / "small.dng"
        small.write_bytes(raw_dng_bytes(photo_cfa(ch, cw, 64, 16383, seed + 1),
                                        meta=EXPORT_META))
        frames = {"card": [], "cpu": []}
        real_u8 = ex.device_u8
        side = ["card"]

        def spy(x):
            out = real_u8(x)
            frames[side[0]].append(out.cpu().numpy())
            return out

        ex.device_u8 = spy
        try:
            for side[0], device in (("card", dev), ("cpu", torch.device("cpu"))):
                s2 = RenderService(AppSettings(DEFAULTS), device=device)
                s2.render_preview(str(small), CONFIG3_DOC)
                s2.render_preview(str(small), config4_doc(ch, cw), roi=PREVIEW_ROI)
                s2.render_preview(str(small), dict(CONFIG5_DOC, **CONFIG5_GEOMETRY),
                                  interactive=True)
        finally:
            ex.device_u8 = real_u8
        if len(frames["card"]) != len(frames["cpu"]) or not frames["cpu"]:
            raise RuntimeError(f"card vs CPU: {len(frames['card'])} and {len(frames['cpu'])} frames")
        for i, (a, b) in enumerate(zip(frames["card"], frames["cpu"])):
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            log(f"[preview] {ch}x{cw} card vs CPU, render {i} {a.shape}: u8 max|d| "
                f"{int(d.max())}, values off {(d > 0).mean():.2e}")
            if a.shape != b.shape or d.max() > 1:
                raise RuntimeError("the card's preview differs from the CPU's")
    return launches, report


# ---- phase 17: the CLI and the tiled develop ---------------------------------

TILED_SHAPE = (8000, 12000)  # 96 MP: a stitched panorama's size
TILE_ORIGIN = (4096, 2048)  # (x, y) of the tile the kernel checks place
TILE_SHAPE = (2304, 2304)  # a tile of 2048 with its 128-pixel halo on both sides
TILED_TOL = 1e-5  # tiled against whole in the tile interiors (tests/test_tiled.py)
PRESET_XMP = """<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF
 xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
 <rdf:Description xmlns:crs="http://ns.adobe.com/camera-raw-settings/1.0/"
  crs:Exposure2012="+0.50" crs:Contrast2012="+15" crs:Shadows2012="+20" crs:Vibrance="+10">
  <crs:Name><rdf:Alt><rdf:li xml:lang="x-default">Phase 17</rdf:li></rdf:Alt></crs:Name>
 </rdf:Description></rdf:RDF></x:xmpmeta>"""


def photo_rgb16(h: int, w: int, seed: int, dev) -> np.ndarray:
    """(h, w, 3) u16 of photograph-like content, made on the card from
    `seed`: per channel four low-frequency waves and three soft highlights
    over the full range, plus noise of 300 DN (`photo_cfa`'s recipe)."""
    g = torch.Generator().manual_seed(seed)
    gd = torch.Generator(device=dev).manual_seed(seed)
    y = torch.linspace(0.0, 1.0, h, device=dev)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=dev)[None, :]
    out = torch.empty((h, w, 3), dtype=torch.int32, device=dev)

    def uniform(lo, hi):
        lo, hi = torch.tensor(lo), torch.tensor(hi)
        return (lo + (hi - lo) * torch.rand(len(lo), generator=g, dtype=torch.float64)).tolist()

    for c in range(3):
        f = torch.zeros((h, w), device=dev)
        for _ in range(4):
            fy, fx, py, px, a = uniform((0.5, 0.5, 0, 0, 0.3), (3, 3, 2 * np.pi, 2 * np.pi, 1))
            f += a * torch.sin(2 * np.pi * fy * y + py) * torch.cos(2 * np.pi * fx * x + px)
        for _ in range(3):
            cy, cx, s, a = uniform((0.1, 0.1, 0.05, 0.5), (0.9, 0.9, 0.2, 1.5))
            f += a * torch.exp(((y - cy) ** 2 + (x - cx) ** 2) * (-0.5 / (s * s)))
        f = (f - f.min()) / (f.max() - f.min()) * 65535.0
        f += 300.0 * torch.randn((h, w), generator=gd, device=dev)
        out[..., c] = torch.clamp(torch.round(f), 0, 65535).to(torch.int32)
    return out.cpu().numpy().astype(np.uint16)


def run_cli(argv: list, label: str) -> tuple[dict, float, float]:
    """`python -m rapidraw_tpu_torch <argv> --timings` as a child process
    from the repository's root: (its --timings JSON, wall seconds, seconds
    from the spawn to the verb's start: process start and imports). A
    failed verb fails the phase."""
    import subprocess

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "rapidraw_tpu_torch", *argv, "--timings"],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {label} exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith('{"timings"')]
    if len(lines) != 1:
        raise AssertionError(f"CLI {label}: no --timings line in {proc.stderr[-2000:]}")
    timings = json.loads(lines[0])["timings"]
    return timings, wall, timings["main_at"] - t0


def phase_cli(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 17, the CLI and the tiled develop (A.11b): (a) tile placement,
    the grade kernel (config 3, FULL_DOC with grain and flare,
    FLARE_LUT_DOC with its map and cube, config 4's masks at the tile's
    size with vignette and grain through the masks build; dither off and
    on) and the
    per-pixel NR kernel (masked_nr_doc's amount maps) on a TILE_SHAPE tile
    at TILE_ORIGIN of a TILED_SHAPE image against their plain versions,
    timed beside their bounds; (b) a TILED_SHAPE 16-bit TIFF of
    photograph-like content from --seed (`photo_rgb16`, the port's
    write_tiff16) through `python -m rapidraw_tpu_torch develop` in a child
    process (config 3: tiles of 2048 with a 128-pixel halo), its stages,
    launches and device memory peak; then in this process develop_tiled on
    the same loaded image (counters reset and read around it, host-device
    copies counted by torch.profiler; each tile's develop between two CUDA
    events; its memory peak above the image) against the whole-image
    develop (the same): max |d| overall and in the tile interiors (pixels
    farther than the largest blur radius from a seam, held to TILED_TOL);
    (c) a 24 MP DNG with a config-3 sidecar through the CLI's `develop` and
    `export` in child processes, the files equal byte for byte (the DNG
    carries no EXIF for the export to copy), the develop's wall time split
    by stage; (d) the
    other verbs once each in this process: auto, histogram, lut-export
    (L = 33, on the card and on the CPU, held to GRADE_TOL), `lib dims` on
    every RAW layout phases 11-12 write (small frames; the CR2 writer's
    file has no dimensioned IFD, which JAX refuses too), `preset import` of
    an XMP and `exif --set` read back. Returns ({path: launches},
    {(kernel, "tiled"): numbers})."""
    import contextlib
    import io
    import tempfile

    from rapidraw_tpu_torch import cli, load_image, parse_adjustments, rasterize_masks
    from rapidraw_tpu_torch import stack_params
    from rapidraw_tpu_torch.io import encode
    from rapidraw_tpu_torch.io.lut import parse_cube, parse_lut_file
    from rapidraw_tpu_torch.io.sidecar import save_sidecar
    from rapidraw_tpu_torch.ops import flare, nr
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import develop as develop_module
    from rapidraw_tpu_torch.pipeline import fused, tiled
    from rapidraw_tpu_torch.pipeline.develop import develop
    from rapidraw_tpu_torch.raw.xtrans import DEFAULT_XTRANS
    from rapidraw_tpu_torch.tools import bound_ms

    report, launches = {}, {}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # --quick: a 600 x 8200 image (still past the CLI's 8192) and a 512 tile
    full_h, full_w = (600, 8200) if args.quick else TILED_SHAPE
    th, tw = (512, 512) if args.quick else TILE_SHAPE
    ox, oy = (4096, 64) if args.quick else TILE_ORIGIN
    place = {"tile_offset": (ox, oy), "full_size": (full_w, full_h)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))

    # ---- (a) tile placement: grade and per-pixel NR, kernel vs plain
    x = torch.rand((1, 3, th, tw), generator=gen, device=dev)
    write_cube(tmp / "phase13.cube")
    cube = torch.from_numpy(parse_lut_file(tmp / "phase13.cube")).to(dev)
    # FLARE_LUT_DOC's map from a bright-spot proxy of the full image
    ph, pw = max(1, round(1024 * full_h / full_w)), 1024
    proxy = torch.rand((1, 3, ph, pw), generator=gen, device=dev) * 0.7
    yy, xx = torch.arange(ph, device=dev)[:, None], torch.arange(pw, device=dev)[None]
    for cy, cx in ((0.3, 0.25), (0.6, 0.7)):
        proxy[:, :, (yy - cy * ph) ** 2 + (xx - cx * pw) ** 2 <= (0.03 * ph) ** 2] = 1.0
    spf, _ = stack_params([parse_adjustments(FLARE_LUT_DOC)[0]], [parse_adjustments(
        FLARE_LUT_DOC)[1]], device=dev)
    fp = fused.pack_rows(spf["glob"])[:, [fused.OFFSETS[k] for k in flare.FLARE_PARAMS]]
    fmap = flare.flare_maps(proxy, fp.contiguous(), False)
    docs = (("config3", CONFIG3_DOC), ("FULL_DOC+grain+flare",
                                       dict(FULL_DOC, grainAmount=30, flareAmount=50)),
            ("FLARE_LUT_DOC", FLARE_LUT_DOC),
            # config 4 reads no coordinate: vignette and grain make the placement show
            ("config4 masks+vignette+grain",
             dict(config4_doc(th, tw), vignetteAmount=-30, grainAmount=25)))
    for label, doc in docs:
        p, c = parse_adjustments(doc)
        sp, cfg = stack_params([p], [c], device=dev)
        pmat = fused.pack_rows(sp["glob"])
        levels = fused.blur_levels(x, cfg, full_size=(full_w, full_h))
        kw = dict(place, flare=fmap if cfg.flare_active else None,
                  lut=cube if cfg.has_lut else None)
        if cfg.mask_count:  # the tile's own influences and the mask params
            bitmaps = rasterize_masks(doc, tw, th, scale=1.0)
            kw.update(masks=torch.from_numpy(bitmaps[None]).to(dev),
                      mmat=fused.pack_mask_rows(sp["mask"]))
        for dither in (False, True):
            cd = dataclasses.replace(cfg, dither_active=dither)
            got = fused.grade(x, levels, pmat, cd, **kw)
            ref, ops = count_ops(lambda: fused.grade_plain(x, levels, pmat, cd, **kw))
            d = (got - ref).abs()
            err, share = float(d.max()), float((d > GRADE_TOL).float().mean())
            tol = GRADE_DITHER_TOL if dither else GRADE_TOL
            line = (f"[tiled-kernel] grade {label} tile (3,{th},{tw}) at {(ox, oy)} of "
                    f"{full_w}x{full_h} dither={'on' if dither else 'off'}: max|d| {err:.3e} "
                    f"(bound {tol:.3e}), share>{GRADE_TOL:g} {share:.2e}")
            if not dither:
                at_zero = fused.grade(x, levels, pmat, cd,
                                      **{k: v for k, v in kw.items() if k not in place})
                moved = float((at_zero - got).abs().max())
                ms = time_ms(lambda: fused.grade(x, levels, pmat, cd, **kw), reps)
                pms = time_ms(lambda: fused.grade_plain(x, levels, pmat, cd, **kw), 1)
                extra = [kw[k] for k in ("flare", "lut", "masks", "mmat")
                         if kw.get(k) is not None]
                bms, bby = bound_ms(nbytes(x, pmat, *levels.values(), *extra) + nbytes(x), ops)
                line += (f"; the placement moves the output by {moved:.3e}; kernel {ms:.3f} ms "
                         f"plain {pms:.3f} ms bound {bms:.3f} ms ({bby}) [{card}]")
                if moved == 0.0:
                    raise AssertionError(f"grade {label}: the tile offset changed nothing")
                if label == "config3":
                    report["grade", "tiled"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                    bound_by=bby, library_ms=None,
                                                    max_abs_err=err)
            log(line)
            if not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(f"grade {label} at a tile offset: max|d| {err} > {tol}")
            del got, ref
        del levels, kw
    ndoc = masked_nr_doc(th, tw)
    p, c = parse_adjustments(ndoc)
    spn, cfgn = stack_params([p], [c], device=dev)
    nmk = torch.from_numpy(rasterize_masks(ndoc, tw, th, scale=1.0)[None]).to(dev)
    la, ca = fused.nr_amounts(spn, cfgn, nmk, dev)
    center, planes = srgb_to_linear(x).contiguous(), nr.nr_planes(x, False).contiguous()
    scale = scales.resolution_scale(full_w, full_h)
    nkw = {"tile_offset": (ox, oy)}
    got = nr.nr_dynamic(center, planes, la, ca, scale, **nkw)
    ref, ops = count_ops(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale, **nkw))
    err = float((got - ref).abs().max())
    moved = float((nr.nr_dynamic(center, planes, la, ca, scale) - got).abs().max())
    ms = time_ms(lambda: nr.nr_dynamic(center, planes, la, ca, scale, **nkw), reps)
    pms = time_ms(lambda: nr.nr_dynamic_plain(center, planes, la, ca, scale, **nkw), 1)
    bms, bby = bound_ms(nbytes(center, planes, la, ca) + nbytes(center), ops)
    report["nr_dynamic", "tiled"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                         library_ms=None, max_abs_err=err)
    log(f"[tiled-kernel] nr_dynamic masked_nr_doc tile (3,{th},{tw}) at {(ox, oy)}: max|d| "
        f"{err:.3e} (bound {NR_TOL:g}); the placement moves the output by {moved:.3e}; kernel "
        f"{ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms ({bby}) [{card}]")
    if not bool(torch.isfinite(got).all()) or err > NR_TOL or moved == 0.0:
        raise AssertionError(f"nr_dynamic at a tile offset: max|d| {err}, moved {moved}")
    del x, got, ref, center, planes, la, ca, nmk, proxy

    # ---- (b) the tiled develop: the CLI on a 96 MP 16-bit TIFF
    t0 = time.perf_counter()
    tif = tmp / "panorama.tif"
    encode.write_tiff16(tif, photo_rgb16(full_h, full_w, args.seed, dev))
    log(f"[tiled] wrote {tif.name} {full_w}x{full_h} 16-bit: {tif.stat().st_size / 1e6:.0f} MB "
        f"in {time.perf_counter() - t0:.1f} s")
    adj = tmp / "config3.json"
    adj.write_text(json.dumps(CONFIG3_DOC))
    tm, wall, start = run_cli(["develop", str(tif), "-a", str(adj), "-o", str(tmp / "pano.jpg")],
                              "develop (tiled)")
    n_tiles = len(tiled.tile_windows(full_h, full_w))
    launches["tiled_cli"] = dict.fromkeys(read_counts(), 0) | tm["launches"]
    stages = ", ".join(f"{k} {v / 1e3:.2f} s" for k, v in tm["stages_ms"].items())
    log(f"[tiled] CLI develop {full_w}x{full_h} TIFF: wall {wall:.2f} s (process start and "
        f"imports {start:.2f} s; {stages}); {n_tiles} tiles; device memory peak "
        f"{tm.get('peak_bytes', 0) / 2**30:.2f} GiB; launches {tm['launches']} [{card}]")
    if tm["launches"]["grade"] != n_tiles or tm["launches"]["blur"] != n_tiles:
        raise AssertionError(f"the CLI's tiled develop launched {tm['launches']} for "
                             f"{n_tiles} tiles")
    img, _ = load_image(tif, device=dev)
    p, c = parse_adjustments(CONFIG3_DOC)
    torch.cuda.synchronize()
    reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out_t = tiled.develop_tiled(img, p, c)
        torch.cuda.synchronize()
    launches["tiled"] = read_counts()
    copies = {}
    for ev in prof.key_averages():
        for kind in ("HtoD", "DtoH"):
            if f"Memcpy {kind}" in ev.key:
                copies[kind] = copies.get(kind, 0) + ev.count
    # each tile's develop between two CUDA events (recorded, not waited on)
    events = []

    def develop_between_events(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = develop(*a, **kw)
        ev[1].record()
        events.append(ev)
        return res

    del out_t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    develop_module.develop = develop_between_events
    try:
        t0 = time.perf_counter()
        out_t = tiled.develop_tiled(img, p, c)
        torch.cuda.synchronize()
        tiled_s = time.perf_counter() - t0
    finally:
        develop_module.develop = develop
    tiled_peak = torch.cuda.max_memory_allocated(dev) - base
    tile_ms = [a.elapsed_time(b) for a, b in events]
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out_w = develop(img, p, c)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    whole_peak = torch.cuda.max_memory_allocated(dev) - base
    d = (out_t - out_w).abs().amax(0)
    rmax = max(fused.blur_radii(c, full_w, full_h).values())

    def clear_of_seams(n):
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        for seam in range(tiled.TILE_SIZE, n, tiled.TILE_SIZE):
            keep[max(0, seam - rmax):seam + rmax] = False
        return keep

    interior = clear_of_seams(full_h)[:, None] & clear_of_seams(full_w)[None]
    dmax, dint = float(d.max()), float(d[interior].max())
    log(f"[tiled] develop_tiled in-process {full_w}x{full_h} config 3: {tiled_s * 1e3:.1f} ms, "
        f"{len(tile_ms)} tiles between CUDA events median {statistics.median(tile_ms):.3f} ms "
        f"(min {min(tile_ms):.3f}, max {max(tile_ms):.3f}, sum {sum(tile_ms):.1f}), its memory "
        f"peak above the image {tiled_peak / 2**30:.2f} GiB, launches {launches['tiled']}, "
        f"host-device copies during it {copies}; whole-image develop {whole_s * 1e3:.1f} ms, "
        f"its memory peak above the image {whole_peak / 2**30:.2f} GiB; tiled vs whole max|d| "
        f"{dmax:.3e} overall, "
        f"{dint:.3e} in the tile interiors (> r={rmax} from a seam; bound {TILED_TOL:g}) "
        f"[{card}]")
    if not bool(torch.isfinite(out_t).all()) or dint > TILED_TOL:
        raise AssertionError(f"tiled develop: interior max|d| {dint} > {TILED_TOL}")
    if launches["tiled"]["grade"] != n_tiles or len(tile_ms) != n_tiles:
        raise AssertionError(f"develop_tiled launched {launches['tiled']} in {len(tile_ms)} "
                             f"tile develops for {n_tiles} tiles")
    del img, out_t, out_w, d, interior
    tif.unlink()

    # ---- (c) a 24 MP DNG: `develop X` equals `export X`
    dng = tmp / "shot.dng"
    dng.write_bytes(raw_dng_bytes(photo_cfa(h, w, 0, 16000, args.seed)))
    save_sidecar(dng, {"adjustments": CONFIG3_DOC})
    tm, wall, start = run_cli(["develop", str(dng), "-o", str(tmp / "dev.jpg")], "develop")
    launches["cli_develop"] = dict.fromkeys(read_counts(), 0) | tm["launches"]
    stages = ", ".join(f"{k} {v:.0f} ms" for k, v in tm["stages_ms"].items())
    log(f"[cli] develop {w}x{h} DNG: wall {wall:.2f} s (process start and imports {start:.2f} s; "
        f"{stages}); launches {tm['launches']} [{card}]")
    ex_out = tmp / "export"
    _, ex_wall, ex_start = run_cli(["export", str(dng), "-o", str(ex_out)], "export")
    dev_jpg, exp_jpg = (tmp / "dev.jpg").read_bytes(), (ex_out / "shot_edited.jpg").read_bytes()
    same = dev_jpg == exp_jpg
    log(f"[cli] export of the same DNG: wall {ex_wall:.2f} s (start {ex_start:.2f} s); develop "
        f"{len(dev_jpg)} bytes, export {len(exp_jpg)} bytes, equal byte for byte: {same}")
    if not same or tm["launches"]["grade"] != 1 or tm["launches"]["blur"] != 1:
        raise AssertionError(f"develop and export disagree ({same}) or launches {tm['launches']}")

    # ---- (d) the other verbs, once each, in this process
    def verb(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"CLI {argv[:2]} exited {rc}")
        return out.getvalue()

    t0 = time.perf_counter()
    auto = json.loads(verb(["auto", str(dng)]))
    hist = json.loads(verb(["histogram", str(dng)]))
    if "exposure" not in auto or sorted(hist) != ["blue", "green", "luma", "red"] or \
            any(len(v) != 256 for v in hist.values()):
        raise AssertionError("auto or histogram gave a malformed JSON")
    log(f"[cli] auto and histogram on the DNG: {time.perf_counter() - t0:.2f} s, auto "
        f"{ {k: auto[k] for k in ('exposure', 'contrast') if k in auto} }")
    reset_counts()
    t0 = time.perf_counter()
    verb(["lut-export", "-a", str(adj), "--size", "33", "-o", str(tmp / "card.cube")])
    torch.cuda.synchronize()
    lut_s = time.perf_counter() - t0
    launches["lut_export"] = read_counts()
    verb(["lut-export", "-a", str(adj), "--size", "33", "-o", str(tmp / "cpu.cube"),
          "--device", "cpu"])
    lc = parse_cube((tmp / "card.cube").read_text())
    lp = parse_cube((tmp / "cpu.cube").read_text())
    lerr = float(np.abs(lc - lp).max())
    log(f"[cli] lut-export L=33 on the card {lut_s * 1e3:.0f} ms, launches "
        f"{launches['lut_export']}; card vs CPU max|d| {lerr:.3e} (bound {GRADE_TOL:g})")
    if lc.shape != (33, 33, 33, 3) or lerr > GRADE_TOL or launches["lut_export"]["grade"] != 1:
        raise AssertionError(f"lut-export: shape {lc.shape}, card vs CPU {lerr}")
    raws = {"dng16": raw_dng_bytes(photo_cfa(256, 384, 0, 16000, 1)),
            "dng14": raw_dng_bytes(photo_cfa(256, 384, 0, 16000, 1), bits=14),
            "dng_orient6": raw_dng_bytes(photo_cfa(256, 384, 0, 16000, 1), orientation=6),
            "dng_ljpeg": raw_dng_bytes(np.tile(photo_cfa(128, 128, 0, 16000, 1), (2, 3)),
                                       ljpeg_tile=128),
            "raf": raw_raf_bytes(photo_cfa(256, 384, 0, 4000, 2), DEFAULT_XTRANS)}
    for kind in ("cr2", *VENDOR_MAIN[1:], *VENDOR_OTHER):
        size = {"orf_predictive": (128, 192), "rw2": (256, 378)}.get(kind, (256, 384))
        raws[kind] = vendor_file(kind, *size, args.seed)[0]
    ext = {**{k: k for k in VENDOR_MAIN}, **{k: e for k, (e, _) in VENDOR_OTHER.items()},
           "dng16": "dng", "dng14": "dng", "dng_orient6": "dng", "dng_ljpeg": "dng",
           "raf": "raf"}
    paths = []
    for name, data in raws.items():
        paths.append(tmp / f"{name}.{ext[name]}")
        paths[-1].write_bytes(data)
    dims = verb(["lib", "dims", *[str(q) for q in paths if q.stem != "cr2"]]).splitlines()
    with contextlib.suppress(ValueError):  # JAX refuses this CR2 the same way
        cr2 = verb(["lib", "dims", str(tmp / "cr2.cr2")])
        raise AssertionError(f"lib dims read the CR2 writer's file: {cr2}")
    log(f"[cli] lib dims on {len(dims)} RAW layouts: "
        + "; ".join(line.rsplit("/", 1)[1] for line in dims) + " (cr2: no dimensioned IFD)")
    if len(dims) != len(paths) - 1:
        raise AssertionError(f"lib dims printed {dims}")
    store = tmp / "presets.json"
    (tmp / "look.xmp").write_text(PRESET_XMP)
    verb(["preset", "--store", str(store), "import", str(tmp / "look.xmp")])
    shown = json.loads(verb(["preset", "--store", str(store), "show", "Phase 17"]))
    verb(["exif", str(dng), "--set", "Artist=Phase 17", "Copyright=CC0"])
    tags = json.loads(verb(["exif", str(dng)]))[str(dng)]
    log(f"[cli] preset import of an XMP: {shown}; exif --set read back: "
        f"{ {k: tags.get(k) for k in ('Artist', 'Copyright')} }")
    if shown.get("contrast") != 15 or tags.get("Artist") != "Phase 17":
        raise AssertionError("preset import or exif --set did not read back")
    import shutil

    shutil.rmtree(tmp)
    return launches, report


# ---- phase 18: thumbnails, community previews and the compositions -----------

THUMB_RES = 720  # the thumbnail resolution (the library's default)
COMMUNITY_TILE = 360  # PREVIEW_TILE_DIM: sources developed at 2 x 360 = 720 px
PANO_CROP = (3000, 4200)  # each panorama frame, 12.6 MP
PANO_STEP = 2400  # columns between the frames' origins: 1800 px of overlap
BM3D_SHAPES = ((4096, 6144), (2828, 4243), (2000, 3000), (1024, 1024), (512, 512))
BM3D_BUDGET_S = 60.0
COMMUNITY_PRESETS = [
    {"name": "Config 3", "adjustments": CONFIG3_DOC},
    {"name": "Config 5", "adjustments": dict(CONFIG5_DOC, **CONFIG5_GEOMETRY)},
    {"name": "Cropped", "adjustments": dict(FULL_DOC, crop={"x": 600, "y": 400,
                                                          "width": 3600, "height": 2400})},
]


def write_exif_jpeg(path: Path, rgb8: np.ndarray, exposure: tuple, iso: int) -> None:
    """A baseline 4:2:0 JPEG q95 (jpeg_enc.cc) whose EXIF APP1 holds an
    Exif IFD with ExposureTime (num, den) and ISOSpeedRatings."""
    import struct

    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.io import exif

    path.write_bytes(native.jpeg_encode(rgb8, 95))
    ifd = exif.TiffDir("<")
    ifd[34665] = {33434: exif.Rational(*exposure), 34855: iso}
    exif.splice_exif_into_jpeg(path, b"Exif\x00\x00II*\x00" + struct.pack("<I", 8)
                               + ifd.tobytes(8))


def textured_scene(h: int, w: int, seed: int, dev) -> np.ndarray:
    """(h, w, 3) u8: `photo_rgb16`'s content plus a texture of 12-px cells
    of random brightness (+-45 levels), made on the card: corners for the
    panorama's features at every scale it detects on."""
    base = torch.from_numpy(photo_rgb16(h, w, seed, dev).astype(np.float32) / 257.0).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cells = torch.rand((h // 12 + 1, w // 12 + 1), generator=g, device=dev) * 90.0 - 45.0
    tex = cells.repeat_interleave(12, 0)[:h].repeat_interleave(12, 1)[:, :w]
    return torch.clamp(base * 0.7 + 38.0 + tex[..., None], 0, 255).to(torch.uint8).cpu().numpy()


def develop_calls_vs_plain(calls, path, reps, card) -> dict:
    """Every develop_fused_batch call a path made, replayed kernel by kernel
    on its own inputs: the blur (every level of its config, one launch),
    NR (static amounts) and the grade (dither off), each against its plain
    version (BLUR_TOL, NR_TOL, GRADE_TOL) and timed beside its bound; the
    numbers of the first call that runs each kernel are returned as
    {(kernel, path): numbers}. Phase 18's documents have no masks, flare,
    LUT or per-pixel NR; a call with one is refused."""
    from rapidraw_tpu_torch.ops import blur, nr
    from rapidraw_tpu_torch.ops.ca import apply_ca_correction
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import bound_ms

    report = {}

    def check(name, label, run, plain, nbytes_io, tol, rel=False, library=None):
        got = run()
        ref, ops = count_ops(plain)
        got, ref = (got, ref) if isinstance(got, (list, tuple)) else ([got], [ref])
        err = max(float(((a - b).abs() / (b.abs().clamp(min=1.0) if rel else 1.0)).max())
                  for a, b in zip(got, ref))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        ms, pms = time_ms(run, reps), time_ms(plain, reps)
        bms, bby = bound_ms(nbytes_io, ops)
        lms = library() if library is not None else None
        report.setdefault((name, path), dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                             library_ms=lms, max_abs_err=err))
        log(f"[{path}-kernel] {name} {label}: max|d|{'/max(1,|ref|)' if rel else ''} "
            f"{err:.3e} (bound {tol:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} "
            f"ms ({bby})" + (f"; library {lms:.3f} ms" if lms is not None else "")
            + f" [{card}]")
        if not finite or err > tol:
            raise AssertionError(f"{name} on the {path} path, {label}: max|d| {err}")

    for ci, (args, kw) in enumerate(calls):
        images, params, cfg = args[0].contiguous(), args[1], args[2]
        b, _, h, w = images.shape
        label = f"call {ci} B={b} (3,{h},{w})"
        if cfg.mask_count or cfg.flare_active or cfg.has_lut or \
                (cfg.nr_active and cfg.nr_static_luma is None):
            raise AssertionError(f"{path} {label}: masks, flare, a LUT or per-pixel NR")
        pmat = fused.pack_rows(params["glob"]).to(images.device)

        radii = tuple(fused.blur_radii(cfg, w, h).values())
        if radii:
            flat = images.reshape(-1, h, w)
            check("blur", f"{label} r={radii}",
                  lambda: blur.gaussian_blur_multi(flat, radii),
                  lambda: blur.gaussian_blur_multi_plain(flat, radii),
                  nbytes(flat) * (1 + len(radii)), BLUR_TOL, rel=True,
                  library=lambda: blur_library_ms(flat, radii, reps))

        if cfg.nr_active:
            image = images
            if cfg.ca_active:
                image = apply_ca_correction(images, cfg.ca_static_rc, cfg.ca_static_by,
                                            full_size=(w, h))
            center = (image if cfg.is_raw else srgb_to_linear(image)).contiguous()
            planes = nr.nr_planes(images, cfg.is_raw).contiguous()
            scale = scales.resolution_scale(w, h)
            la, ca = cfg.nr_static_luma, cfg.nr_static_color
            check("nr", f"{label} amounts {la:g}/{ca:g}",
                  lambda: nr.nr_static(center, planes, la, ca, scale),
                  lambda: nr.nr_static_plain(center, planes, la, ca, scale),
                  nbytes(center, planes) + nbytes(center), NR_TOL)

        image, linear = fused.prepare_inputs(images, cfg, params)
        levels = fused.blur_levels(images, cfg)
        gcfg = dataclasses.replace(cfg, dither_active=False)
        check("grade", label,
              lambda: fused.grade(image, levels, pmat, gcfg, image_linear=linear),
              lambda: fused.grade_plain(image, levels, pmat, gcfg, image_linear=linear),
              nbytes(image, pmat, *levels.values()) + nbytes(image), GRADE_TOL)
    return report


def phase_library(args, h, w, reps, card, dev, reset_counts, read_counts):
    """Phase 18, the rest of the library and the compositions (A.11c,
    A.12): (a) generate_thumbnails at THUMB_RES over 8 files of (h, w) from
    --seed: 16-bit DNGs (the fast RAW path: half-size speed demosaic) and
    q95 JPEGs, edited (CONFIG3_DOC; config 5's document with its geometry,
    which warps at the loaded size and runs NR) and unedited, timed per
    thumbnail as prep (load, transform, downscale, masks), develop and
    encode, with the launches of blur, grade, NR and resample (each must
    run) and the device memory peak; the batched results equal to one
    generate_thumbnail per file byte for byte, or, for a document whose
    bucket merges its config with another's, to a serial develop under
    the merged config; (b) the kernels against their plain versions at
    this slice's shapes: each batched develop of (a) replayed kernel by
    kernel on its own inputs (blur, NR, grade), and every kernel on random
    images at the fast RAW path's half-size frame, where thumbnails warp
    (the resample numbers kept), and at the community previews' 720 px;
    (c) generate_community_previews of COMMUNITY_PRESETS over a DNG and a
    JPEG with their launches, each develop then replayed as in (b); (d) the
    compositions through `python -m rapidraw_tpu_torch` in child processes
    with --timings: hdr of three bracketed JPEGs carrying ExposureTime and
    ISO, negative, cull over (a)'s files, panorama of three overlapping
    PANO_CROP crops of one textured scene (the output's size checked), and
    denoise (BM3D, NumPy on the host) at the largest of BM3D_SHAPES that
    the rate of a 512 x 512 run says finishes within BM3D_BUDGET_S. Returns
    ({"thumbnails", "community"}: launches, {(kernel, path): numbers})."""
    import shutil
    import tempfile

    from rapidraw_tpu_torch.io.sidecar import save_sidecar
    from rapidraw_tpu_torch.library import community, thumbnails
    from rapidraw_tpu_torch.pipeline import batch, develop as develop_mod
    from rapidraw_tpu_torch.utils.settings import DEFAULTS, AppSettings

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    launches, report = {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_library_"))
    settings = AppSettings(DEFAULTS)

    # ---- (a) thumbnails of 8 files
    t0 = time.perf_counter()
    cfa = [photo_cfa(h, w, RAW_BLACK, RAW_WHITE, args.seed + k) for k in range(2)]
    rgb = [(photo_rgb16(h, w, args.seed + 10 + k, dev) >> 8).astype(np.uint8) for k in range(2)]
    geo5 = dict(CONFIG5_DOC, **CONFIG5_GEOMETRY)
    files = [("r_c3.dng", CONFIG3_DOC), ("r_plain.dng", {}), ("r_c5a.dng", geo5),
             ("r_c5b.dng", geo5), ("j_c3.jpg", CONFIG3_DOC), ("j_plain.jpg", {}),
             ("j_c5.jpg", geo5), ("j_c3b.jpg", dict(CONFIG3_DOC, exposure=0.6))]
    paths = []
    from rapidraw_tpu_torch import native

    for i, (name, doc) in enumerate(files):
        p = tmp / name
        if name.endswith(".dng"):
            p.write_bytes(raw_dng_bytes(np.roll(cfa[i % 2], 2 * i, axis=1)))
        else:
            p.write_bytes(native.jpeg_encode(np.ascontiguousarray(np.roll(rgb[i % 2], i, 1)), 95))
        if doc:
            save_sidecar(p, {"adjustments": doc})
        paths.append(str(p))
    log(f"[thumbs] wrote {len(paths)} files of {h}x{w} (4 DNG, 4 JPEG q95) in "
        f"{time.perf_counter() - t0:.1f} s")

    spent = {"prep": 0.0, "develop": 0.0, "encode": 0.0}
    real = {"prep": thumbnails._prep_thumbnail, "finish": thumbnails._finish_thumbnail,
            "batch": batch.develop_batch, "develop": develop_mod.develop}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return run

    # each develop_fused_batch call a path makes, kept to replay its kernels
    # against their plain versions on the same inputs after the run
    calls = {"thumbnails": [], "community": []}
    into = calls["thumbnails"]
    real_fused = batch.develop_fused_batch

    def record(*a, **k):
        into.append((a, k))
        return real_fused(*a, **k)

    thumbnails._prep_thumbnail = timed("prep", real["prep"])
    thumbnails._finish_thumbnail = timed("encode", real["finish"])
    batch.develop_batch = timed("develop", real["batch"])
    develop_mod.develop = timed("develop", real["develop"])
    batch.develop_fused_batch = record
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        thumbs = thumbnails.generate_thumbnails(paths, THUMB_RES, app_settings=settings,
                                                device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["thumbnails"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        thumbnails._prep_thumbnail, thumbnails._finish_thumbnail = real["prep"], real["finish"]
        batch.develop_batch, develop_mod.develop = real["batch"], real["develop"]
        batch.develop_fused_batch = real_fused
    n = len(paths)
    log(f"[thumbs] generate_thumbnails of {n} files at {THUMB_RES}: wall {wall:.2f} s, "
        f"{wall / n * 1e3:.1f} ms/thumbnail = prep {spent['prep'] / n * 1e3:.1f} + develop "
        f"{spent['develop'] / n * 1e3:.1f} + encode {spent['encode'] / n * 1e3:.1f} (+ the "
        f"batches' u8 and readback); launches {launches['thumbnails']}; device memory peak "
        f"{peak / 2**30:.2f} GiB [{card}]")
    lt = launches["thumbnails"]
    if set(thumbs) != set(paths) or min(lt["blur"], lt["grade"], lt["nr"], lt["resample"]) < 1:
        raise AssertionError(f"thumbnails: {sorted(thumbs)} launches {lt}")
    t0 = time.perf_counter()
    serial = {p: thumbnails.generate_thumbnail(p, THUMB_RES, app_settings=settings, device=dev)
              for p in paths}
    same = [p for p in paths if serial[p] == thumbs[p]]
    sizes = {Path(p).name: len(thumbs[p]) for p in paths}
    log(f"[thumbs] serial generate_thumbnail x{n}: {time.perf_counter() - t0:.2f} s; batched "
        f"equal to serial byte for byte on {len(same)} of {n}; JPEG bytes {sizes}")
    # a bucket develops its documents under their merged config (as JAX
    # does): a stage another member turns on runs with neutral values,
    # which is exact only up to an ulp. A batched thumbnail that differs
    # from its serial one must equal a serial develop under its bucket's
    # merged config byte for byte; its u8 distance from its own is reported
    from rapidraw_tpu_torch.pipeline.export import device_u8

    preps = {p: real["prep"](p, THUMB_RES, app_settings=settings, device=dev) for p in paths}
    buckets = {}
    for p, pr in preps.items():
        if not isinstance(pr, bytes):
            buckets.setdefault(thumbnails._bucket_key(pr), []).append(p)
    for p in sorted(set(paths) - set(same)):
        pr, group = preps[p], next(g for g in buckets.values() if p in g)
        _, merged = batch.stack_params([preps[q]["params"] for q in group],
                                       [preps[q]["cfg"] for q in group], device=dev)
        if len(group) == 1 or merged == pr["cfg"] or pr["masks"] is not None:
            raise AssertionError(f"batched thumbnail of {p} differs from its serial one")
        under = develop_mod.develop(pr["x"], pr["params"], merged)
        own = develop_mod.develop(pr["x"], pr["params"], pr["cfg"])
        d = (device_u8(under).int() - device_u8(own).int()).abs()
        equal = thumbnails._finish_thumbnail(under, None) == thumbs[p]
        log(f"[thumbs] {Path(p).name} shares a bucket with "
            f"{[Path(q).name for q in group if q != p]}: batched equal to a serial develop "
            f"under the merged config byte for byte: {equal}; against its own config the u8 "
            f"frames differ by max {int(d.max())} LSB on {float((d > 0).float().mean()):.2e}")
        if not equal:
            raise AssertionError(f"batched thumbnail of {p} differs from a serial develop "
                                 "under its bucket's config")

    # ---- (b) the kernels at this slice's shapes against their plain versions
    # the thumbnails' batched develops (chunks of 4 at 720 px) on their
    # own inputs; every kernel at the fast RAW path's half-size frame, where
    # thumbnails warp, and at the community previews' 720 px
    report.update(develop_calls_vs_plain(calls["thumbnails"], "thumbnails", reps, card))
    half = (h // 2, w // 2)
    small = (round(h * 2 * COMMUNITY_TILE / max(h, w)), 2 * COMMUNITY_TILE)
    report.update(preview_kernels_vs_plain(
        [(half, "thumbnails", ("resample",)), (small, "community", ("resample",))],
        reps, card, dev, gen))

    # ---- (c) community previews: 3 presets over a DNG and a JPEG
    presets = community.parse_manifest(json.dumps(COMMUNITY_PRESETS))
    into = calls["community"]
    batch.develop_fused_batch = record
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        previews = community.generate_community_previews([paths[1], paths[5]], presets,
                                                         device=dev)
        torch.cuda.synchronize()
        cwall = time.perf_counter() - t0
        launches["community"] = read_counts()
    finally:
        batch.develop_fused_batch = real_fused
    lc = launches["community"]
    log(f"[community] {len(presets)} presets x 2 sources of {h}x{w} (tile {COMMUNITY_TILE}): "
        f"wall {cwall:.2f} s; launches {lc}; strips "
        f"{ {k: len(v) for k, v in previews.items()} } bytes [{card}]")
    if sorted(previews) != sorted(p.name for p in presets) or \
            min(lc["blur"], lc["grade"], lc["nr"], lc["resample"]) < 1 or \
            any(v[:2] != b"\xff\xd8" for v in previews.values()):
        raise AssertionError(f"community previews: {sorted(previews)}, launches {lc}")
    report.update(develop_calls_vs_plain(calls["community"], "community", reps, card))
    del calls

    # ---- (d) the compositions through the CLI, each in a child process
    def cli(argv, label):
        timings, wall, start = run_cli(argv, label)
        stages = " ".join(f"{k} {v / 1e3:.2f}" for k, v in timings["stages_ms"].items())
        log(f"[compositions] {label}: wall {wall:.2f} s = start and imports {start:.2f} s + "
            f"{stages} (s) [{card}]")
        return timings

    rng = np.random.default_rng(args.seed)
    scene = photo_rgb16(h, w, args.seed + 20, dev).astype(np.float64) / 65535.0
    lin = scene ** 2.2
    bracket = []
    for i, (den, iso) in enumerate([(500, 100), (125, 100), (30, 200)]):
        expo = np.clip(lin * (iso / 100) * 60.0 / den, 0, 1) ** (1 / 2.2)
        rgb8 = np.clip(expo * 255 + rng.normal(0, 1.0, expo.shape), 0, 255).astype(np.uint8)
        p = tmp / f"bracket_{i}.jpg"
        write_exif_jpeg(p, rgb8, (1, den), iso)
        bracket.append(str(p))
    cli(["hdr", *bracket, "-o", str(tmp / "merged.png")], f"hdr (3 x {h}x{w} JPEG)")
    cli(["negative", paths[5], "-o", str(tmp / "positive.tiff")], f"negative ({h}x{w} JPEG)")
    import subprocess

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "rapidraw_tpu_torch", "cull", *paths,
                           "--timings"], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"CLI cull exited {proc.returncode}: {proc.stderr[-2000:]}")
    culled = json.loads(proc.stdout)
    timings = next(json.loads(ln)["timings"] for ln in proc.stderr.splitlines()
                   if ln.startswith('{"timings"'))
    log(f"[compositions] cull of (a)'s {n} files: wall {time.time() - t0:.2f} s = start and "
        f"imports {timings['main_at'] - t0:.2f} s + cull {timings['stages_ms']['cull'] / 1e3:.2f}"
        f" (s); {len(culled['groups'])} groups, best "
        f"{[Path(b).name for b in culled['best']]}, failed {culled['failed']} [{card}]")
    if culled["failed"] or sum(len(g) for g in culled["groups"]) != n:
        raise AssertionError(f"cull: {culled}")
    ph, pw = PANO_CROP
    if args.quick:
        ph, pw = h, w * 2 // 3
    step = pw * 4 // 7
    big = textured_scene(ph, step * 2 + pw, args.seed + 30, dev)
    crops = []
    for i in range(3):
        p = tmp / f"pano_{i}.jpg"
        p.write_bytes(native.jpeg_encode(np.ascontiguousarray(big[:, i * step:i * step + pw]), 95))
        crops.append(str(p))
    tm = cli(["panorama", *crops, "-o", str(tmp / "pano.png")],
             f"panorama (3 x {ph}x{pw} JPEG, {step} px apart)")
    pw_out, ph_out = tm["size"]
    want_w = step * 2 + pw
    log(f"[compositions] panorama output {pw_out}x{ph_out} (the scene: {want_w}x{ph})")
    if abs(pw_out - want_w) > 4 or abs(ph_out - ph) > 4:
        raise AssertionError(f"panorama size {pw_out}x{ph_out}, the scene {want_w}x{ph}")
    # BM3D runs on the host: time a 512 x 512 frame, then the largest shape
    # its rate says fits the budget
    def denoise(shape):
        src = tmp / f"noisy_{shape[0]}x{shape[1]}.jpg"
        crop = rgb[0][: shape[0], : shape[1]]
        src.write_bytes(native.jpeg_encode(np.ascontiguousarray(crop), 90))
        return cli(["denoise", str(src), "-o", str(tmp / "denoised.png")],
                   f"denoise BM3D {shape[0]}x{shape[1]}")["stages_ms"]["bm3d"] / 1e3
    small_s = denoise((512, 512))
    rate = small_s / (512 * 512)
    fits = [s for s in BM3D_SHAPES if s[0] * s[1] * rate <= BM3D_BUDGET_S and
            s[0] <= h and s[1] <= w]
    log(f"[compositions] BM3D rate {rate * 1e6:.1f} s/MP: 24 MP would take "
        f"{rate * h * w:.0f} s; the largest of {BM3D_SHAPES} within {BM3D_BUDGET_S:.0f} s: "
        f"{fits[0] if fits else 'none'}")
    if fits and fits[0] != (512, 512):
        denoise(fits[0])
    shutil.rmtree(tmp)
    return launches, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="1024x1536, fewer repetitions")
    ap.add_argument("--out", default=None, help="directory for the nvcc/ptxas logs")
    ap.add_argument("--seed", type=int, default=12,
                    help="seed of phase 12's vendor files (their content and streams)")
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler over the config-3, -5, -4 and -2 B=2 main paths")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch import (
        blur_band_rows,
        develop_batch,
        device_u8,
        parse_adjustments,
        rasterize_masks,
        stack_params,
    )
    from rapidraw_tpu_torch.geometry import warp_fast
    from rapidraw_tpu_torch.geometry.params import geometry_params_from_json
    from rapidraw_tpu_torch.ops import blur, flare, nr
    from rapidraw_tpu_torch.ops.colorspace import srgb_to_linear
    from rapidraw_tpu_torch.params import scales
    from rapidraw_tpu_torch.pipeline import fused
    from rapidraw_tpu_torch.tools import bound_ms, card_line, prof_chunked, prof_nr_slices

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    h, w = (1024, 1536) if args.quick else (H, W)
    reps = 3 if args.quick else 5
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name}: {now - t_phase[0]:.1f} s (total {now - t_start:.1f} s)")
        t_phase[0] = now

    # ---- 1. device ---------------------------------------------------------
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build: one nvcc per source, all started together ---------------------
    from concurrent.futures import ThreadPoolExecutor

    libs = {"blur": blur._KERNEL, "grade": fused._KERNEL, "nr": nr._KERNEL,
            "resample": warp_fast._KERNEL, "chunked": prof_chunked._KERNEL,
            "nr_slices": prof_nr_slices._KERNEL, "flare": flare._KERNEL}
    def build_host(name):
        t0 = time.perf_counter()
        native.host_library(name)
        return time.perf_counter() - t0

    # the host decoders and the export's JPEG encoder
    hosts = ("ljpeg", "vendor_huff", "pana_oly", "crx", "phase_one", "jpeg_enc", "jpeg_dec",
             "tiff_codec", "guides")
    with ThreadPoolExecutor(len(libs) + len(hosts)) as pool:
        host = {name: pool.submit(build_host, name) for name in hosts}
        list(pool.map(lambda kl: kl.lib(), libs.values()))
        for name, fut in host.items():
            log(f"[build] {name} (host code, g++): {fut.result():.1f} s")
    usage = {name: ptxas_usage(kl.build_log) for name, kl in libs.items()}
    for name, kl in libs.items():
        log(f"[build] {name}: nvcc {kl.build_seconds:.1f} s, registers {usage[name][0]}, "
            f"spill bytes {usage[name][1]}")
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / f"nvcc_{name}.log").write_text(kl.build_log)
        for line in kl.build_log.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name} ptxas: {line.strip()}")
        for entry, (regs, spill) in ptxas_entries(kl.build_log).items():
            log(f"[build] {name} {entry}: {regs} registers, {spill} bytes spilled")
    phase_done("build")

    gen = torch.Generator(device=dev).manual_seed(0)
    # (kernel name, main path) -> the numbers of the case at that path's shape
    report = {}

    def path_radii(doc) -> tuple:
        return tuple(fused.blur_radii(parse_adjustments(doc)[1], w, h).values())

    # ---- 3. blur kernel vs plain ----------------------------------------------
    blur_err = 0.0
    r3, r5 = path_radii(CONFIG3_DOC), path_radii(CONFIG5_DOC)
    r_two = blur.FUSED_MAX_RADIUS + 1  # the smallest radius of the two-pass regime
    blur_cases = [  # (label, channels, radii, main path, (rows, cols), value range)
        ("B1 r=14", 3, (14,), None, (h, w), (0.0, 1.0)),
        ("B2 radii 4/14/31/152", 3, (4, 14, 31, 152), None, (h, w), (0.0, 1.0)),
        (f"config3 B=2 C=6 r={r3}", 6, r3, "config3", (h, w), (0.0, 1.0)),
        (f"config5 B=2 C=6 r={r5}", 6, r5, "config5", (h, w), (0.0, 1.0)),
        (f"two-pass C=6 r={r_two}", 6, (r_two,), None, (h, w), (0.0, 1.0)),
        ("ragged fused C=6 r=14", 6, (14,), None, RAGGED, (0.0, 1.0)),
        ("ragged two-pass C=3 r=31", 3, (31,), None, RAGGED, (0.0, 1.0)),
        # linear RAW or HDR input: negatives and values past 65504, which
        # the kernel clamps on load as the plain version does
        ("out-of-range radii 4/14/31/152", 3, (4, 14, 31, 152), None, (h, w),
         (-0.5e5, 1.5e5)),
    ]
    for label, c, radii, path, (bh, bw), (lo, hi) in blur_cases:
        plan = blur.blur_launch_plan(c, bh, bw, radii)
        x = torch.rand((c, bh, bw), generator=gen, device=dev) * (hi - lo) + lo
        got = blur.gaussian_blur_multi(x, radii)
        ref, ops = count_ops(lambda: blur.gaussian_blur_multi_plain(x, radii))
        torch.cuda.synchronize()
        # relative to max(1, |ref|): outputs reach 65504 on out-of-range
        # input, where an fp32 sum's rounding is ~4e-3 absolute; on [0, 1]
        # input this is the absolute error
        err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                  for a, b in zip(got, ref))
        blur_err = max(blur_err, err)
        ms = time_ms(lambda: blur.gaussian_blur_multi(x, radii), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(x, radii), reps)
        bms, bby = bound_ms(nbytes(x) * (1 + len(radii)), ops)
        regimes = "+".join(f"{k} {[radii[g] for g in plan[k]]}" for k in ("fused", "two_pass")
                           if plan[k])
        log(f"[blur] {label} ({c},{bh},{bw}) {regimes}: max|d|/max(1,|ref|) {err:.3e} "
            f"(bound {BLUR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
            f"({bby}) [{card}]")
        if err > BLUR_TOL or not all(bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"blur {label}: max|d| {err} > {BLUR_TOL} or non-finite")
        if len(radii) == 1 and (bh, bw) == (h, w):
            # the library yardstick: one cuDNN depthwise convolution with the
            # 2-D Gaussian on the edge-padded input (the same function)
            import torch.nn.functional as F

            (r,) = radii
            k1 = torch.from_numpy(blur._gauss_weights(r)).to(dev)
            k2 = (k1[:, None] * k1[None, :]).expand(c, 1, 2 * r + 1, 2 * r + 1).contiguous()
            xp = F.pad(x[None], (r, r, r, r), mode="replicate")
            lms = time_ms(lambda: F.conv2d(xp, k2, groups=c), reps)
            if path is not None:
                report["blur", path] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                            library_ms=lms, max_abs_err=err)
            log(f"[blur] library: one depthwise 2-D conv2d {lms:.3f} ms [{card}]")
            del xp, k2
        del x, got, ref
    log(f"[blur] max|d|/max(1,|ref|) over every case {blur_err:.3e}")
    phase_done("blur")

    # ---- 4. grade kernel vs plain ---------------------------------------------
    grade_err = 0.0
    grade_docs = dict(DOCS, config5_linear=(CONFIG5_DOC, False))
    for b in (1, 2):
        images = torch.rand((b, 3, h, w), generator=gen, device=dev)
        for name, (doc, is_raw) in grade_docs.items():
            p, cfg = parse_adjustments(doc, is_raw=is_raw)
            sp, cfg = stack_params([p] * b, [cfg] * b, device=dev)
            pmat = fused.pack_rows(sp["glob"])
            levels = fused.blur_levels(images, cfg)
            # config 5's image reaches the grade already linear (NR ran first)
            lin = name == "config5_linear"
            for dither in (False, True):
                c = dataclasses.replace(cfg, dither_active=dither)
                got = fused.grade(images, levels, pmat, c, image_linear=lin)
                ref, ops = count_ops(lambda: fused.grade_plain(images, levels, pmat, c, lin))
                torch.cuda.synchronize()
                d = (got - ref).abs()
                err, share = float(d.max()), float((d > GRADE_TOL).float().mean())
                tol = GRADE_DITHER_TOL if dither else GRADE_TOL
                line = (f"[grade] B={b} {name} dither={'on' if dither else 'off'}: "
                        f"max|d| {err:.3e} (bound {tol:.3e}), share>{GRADE_TOL:g} {share:.2e}")
                if not dither:
                    ms = time_ms(lambda: fused.grade(images, levels, pmat, c, lin), reps)
                    pms = time_ms(lambda: fused.grade_plain(images, levels, pmat, c, lin), reps)
                    bms, bby = bound_ms(nbytes(images, pmat, *levels.values()) + nbytes(images), ops)
                    line += (f" kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
                             f"({bby}) [{card}]")
                    path = {"config3": "config3", "config5_linear": "config5"}.get(name)
                    if b == 2 and path is not None:
                        report["grade", path] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                     bound_by=bby, library_ms=None,
                                                     max_abs_err=err)
                log(line)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"grade {name}: non-finite output")
                if err > tol:
                    raise AssertionError(f"grade B={b} {name}: max|d| {err} > {tol}")
                grade_err = max(grade_err, err if not dither else 0.0)
                del got, ref
            del levels
        del images
    # a size that is a multiple of neither tile: every edge block is partial
    images = torch.rand((2, 3, *RAGGED), generator=gen, device=dev)
    for name, (doc, is_raw) in grade_docs.items():
        p, cfg = parse_adjustments(doc, is_raw=is_raw)
        sp, cfg = stack_params([p] * 2, [cfg] * 2, device=dev)
        pmat = fused.pack_rows(sp["glob"])
        levels = fused.blur_levels(images, cfg)
        lin = name == "config5_linear"
        for dither in (False, True):
            c = dataclasses.replace(cfg, dither_active=dither)
            got = fused.grade(images, levels, pmat, c, image_linear=lin)
            ref = fused.grade_plain(images, levels, pmat, c, lin)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = GRADE_DITHER_TOL if dither else GRADE_TOL
            log(f"[grade] ragged B=2 {RAGGED[0]}x{RAGGED[1]} {name} "
                f"dither={'on' if dither else 'off'}: max|d| {err:.3e} (bound {tol:.3e})")
            if not bool(torch.isfinite(got).all()) or err > tol:
                raise AssertionError(f"grade ragged {name}: max|d| {err} > {tol} or non-finite")
            grade_err = max(grade_err, err if not dither else 0.0)
            del got, ref
        del levels
    del images
    log(f"[grade] max|d| over every dither-off case {grade_err:.3e}")
    phase_done("grade")

    # ---- 5. end to end, the develop main path (configs 1 and 3) -------------------
    def run_e2e(doc, b, images):
        parsed = [parse_adjustments(doc) for _ in range(b)]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=images.device)
        out = develop_batch(images, sp, cfg)
        return out, device_u8(out).cpu().numpy()

    def reset_counts() -> None:
        blur.gaussian_blur_multi.launches = 0
        fused.grade.launches = 0
        nr.nr_static.launches = 0
        warp_fast.resample_rows.launches = 0
        prof_chunked.chain.launches = 0
        prof_nr_slices.slices.launches = 0
        flare.flare_maps.launches = 0
        nr.nr_dynamic.launches = 0

    def read_counts() -> dict:
        return {"blur": blur.gaussian_blur_multi.launches, "grade": fused.grade.launches,
                "nr": nr.nr_static.launches, "resample": warp_fast.resample_rows.launches,
                "chunked": prof_chunked.chain.launches,
                "nr_slices": prof_nr_slices.slices.launches,
                "flare": flare.flare_maps.launches, "nr_dynamic": nr.nr_dynamic.launches}

    img2 = torch.rand((2, 3, h, w), generator=gen, device=dev)
    reset_counts()
    out, u8 = run_e2e(CONFIG3_DOC, 2, img2)
    torch.cuda.synchronize()
    launches3 = read_counts()
    log(f"[e2e] config3 B=2 launches {launches3} u8 {u8.shape} {u8.dtype}")
    if min(launches3["blur"], launches3["grade"]) < 1:
        raise AssertionError(f"a kernel of the develop main path never launched: {launches3}")
    if not bool(torch.isfinite(out).all()) or u8.shape != (2, 3, h, w) or u8.min() == u8.max():
        raise AssertionError("e2e output is non-finite, misshapen or constant")

    # small input: the CUDA path against the plain CPU path, same JSON
    small = torch.rand((2, 3, 384, 512), generator=gen, device=dev)
    _, u8_gpu = run_e2e(CONFIG3_DOC, 2, small)
    _, u8_cpu = run_e2e(CONFIG3_DOC, 2, small.cpu())
    du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
    log(f"[e2e] small 2x3x384x512 CUDA vs plain CPU u8: max {int(du.max())} LSB, "
        f"share>0 {float((du > 0).mean()):.2e}")
    if du.max() > 1 or (du > 0).mean() > 1e-3:
        raise AssertionError("e2e CUDA output disagrees with the plain CPU path")

    for doc_name, doc in (("config1", CONFIG1_DOC), ("config3", CONFIG3_DOC)):
        for b in (1, 2):
            imgs = img2[:b].contiguous()
            run_e2e(doc, b, imgs)
            times, readback = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_e2e(doc, b, imgs)
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
            # the device part alone: params resident, JSON parsed once
            parsed = [parse_adjustments(doc) for _ in range(b)]
            sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=dev)
            dev_ms = time_ms(lambda: device_u8(develop_batch(imgs, sp, cfg)), reps)
            q = device_u8(develop_batch(imgs, sp, cfg))
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                q.cpu()
                readback.append(time.perf_counter() - t0)
            log(f"[e2e] {doc_name} B={b}: {dt * 1e3 / b:.2f} ms/image, "
                f"{b * h * w / dt / 1e6:.1f} MPix/s (JSON->u8 on host); device part "
                f"{dev_ms / b:.2f} ms/image ({b * h * w / dev_ms / 1e3:.1f} MPix/s), "
                f"u8 readback {statistics.median(readback) * 1e3 / b:.2f} ms/image [{card}]")
    del out, u8, small
    phase_done("e2e configs 1 and 3")

    # ---- 6. NR kernel vs plain ---------------------------------------------------
    scale = scales.resolution_scale(w, h)
    nr_err = 0.0
    # config 5 hands NR the whole B = 2 batch in one launch
    center = srgb_to_linear(img2).contiguous()
    planes = nr.nr_planes(img2, False).contiguous()
    p5, _ = parse_adjustments(CONFIG5_DOC)
    nr5 = (float(p5["glob"]["luma_nr"]), float(p5["glob"]["color_nr"]))
    for label, (la, ca) in (("config5", nr5), ("strong", NR_STRONG)):
        got = nr.nr_static(center, planes, la, ca, scale)
        ref, ops = count_ops(lambda: nr.nr_static_plain(center, planes, la, ca, scale))
        torch.cuda.synchronize()
        d = (got - ref).abs()
        err, share = float(d.max()), float((d > 1e-6).float().mean())
        nr_err = max(nr_err, err)
        ms = time_ms(lambda: nr.nr_static(center, planes, la, ca, scale), reps)
        pms = time_ms(lambda: nr.nr_static_plain(center, planes, la, ca, scale), reps)
        bms, bby = bound_ms(nbytes(center, planes) + nbytes(center), ops)
        log(f"[nr] {label} amounts {la:.2f}/{ca:.2f} B=2 (2,3,{h},{w}) max offset "
            f"{nr._consts(la, ca, scale)['max_off']}: max|d| {err:.3e} (bound {NR_TOL:g}), "
            f"share>1e-6 {share:.2e}, kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
            f"({bby}, {ops / 1e9:.1f} G ops) [{card}]")
        if not bool(torch.isfinite(got).all()) or err > NR_TOL:
            raise AssertionError(f"nr {label}: max|d| {err} > {NR_TOL} or non-finite")
        if label == "config5":
            report["nr", "config5"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                           library_ms=None, max_abs_err=err)
        del got, ref
    del center, planes
    ragged = torch.rand((2, 3, *RAGGED), generator=gen, device=dev)
    center = srgb_to_linear(ragged).contiguous()
    planes = nr.nr_planes(ragged, False).contiguous()
    rscale = scales.resolution_scale(RAGGED[1], RAGGED[0])
    for label, (la, ca) in (("config5", nr5), ("strong", NR_STRONG)):
        got = nr.nr_static(center, planes, la, ca, rscale)
        ref = nr.nr_static_plain(center, planes, la, ca, rscale)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        nr_err = max(nr_err, err)
        log(f"[nr] ragged B=2 {RAGGED[0]}x{RAGGED[1]} {label} max offset "
            f"{nr._consts(la, ca, rscale)['max_off']}: max|d| {err:.3e} (bound {NR_TOL:g})")
        if not bool(torch.isfinite(got).all()) or err > NR_TOL:
            raise AssertionError(f"nr ragged {label}: max|d| {err} > {NR_TOL} or non-finite")
        del got, ref
    log(f"[nr] max|d| over both documents and both sizes {nr_err:.3e}")
    del center, planes, ragged
    phase_done("nr")

    # ---- 7. resample kernel vs plain ------------------------------------------
    rs_err = {}  # plan -> max|d| over its passes
    for gname, geom in (("config5", CONFIG5_GEOMETRY), ("tca_rotate", TCA_GEOMETRY)):
        plan = warp_fast.plan_warp(geometry_params_from_json(geom), h, w, device=dev)
        if plan is None:
            raise AssertionError(f"the planner refused the {gname} geometry")
        st = plan.static
        x = torch.nn.functional.pad(img2, (0, st.wp - w, 0, st.hp - h))
        for si, (channels, vstat, hstat) in enumerate(st.modes):
            part = x[:, list(channels)].reshape(-1, st.hp, st.wp).contiguous()
            tmp = warp_fast.resample_rows(part, plan.arrays[f"ev{si}"], plan.arrays[f"bv{si}"],
                                          vstat)
            tr_ms = time_ms(lambda: tmp.transpose(1, 2).contiguous(), reps)
            tmp_t = tmp.transpose(1, 2).contiguous()
            for pname, src, key, stat in (("v", part, "v", vstat), ("h", tmp_t, "h", hstat)):
                e_arr, bases = plan.arrays[f"e{key}{si}"], plan.arrays[f"b{key}{si}"]
                got = warp_fast.resample_rows(src, e_arr, bases, stat)
                ref, ops = count_ops(lambda: warp_fast.resample_rows_plain(src, e_arr, bases,
                                                                           stat))
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rs_err[gname] = max(rs_err.get(gname, 0.0), err)
                ms = time_ms(lambda: warp_fast.resample_rows(src, e_arr, bases, stat), reps)
                pms = time_ms(lambda: warp_fast.resample_rows_plain(src, e_arr, bases, stat),
                              reps)
                bms, bby = bound_ms(nbytes(src, e_arr, bases, got), ops)
                log(f"[resample] {gname} set {si} {channels} pass {pname} "
                    f"({src.shape[0]},{src.shape[1]},{src.shape[2]}) span {stat.span}: "
                    f"max|d| {err:.3e} (bound {RESAMPLE_TOL:g}) kernel {ms:.3f} ms plain "
                    f"{pms:.3f} ms bound {bms:.3f} ms ({bby}) [{card}]")
                if err > RESAMPLE_TOL:
                    raise AssertionError(f"resample {gname} {pname}: max|d| {err}")
                if gname == "config5" and pname == "v":
                    lms = resample_library_ms(src, e_arr, bases, stat, reps)
                    report["resample", "config5"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                         bound_by=bby, library_ms=lms)
                    log(f"[resample] library: one grid_sample {lms:.3f} ms [{card}]")
                del got, ref
            log(f"[resample] {gname} set {si}: transpose of the intermediate "
                f"{tr_ms:.3f} ms (x2 per set) [{card}]")
            del part, tmp, tmp_t
        del x, plan
    report["resample", "config5"]["max_abs_err"] = rs_err["config5"]
    log(f"[resample] max|d| over every pass {max(rs_err.values()):.3e}")
    phase_done("resample")

    # ---- 8. end to end, the stencil export path (config 5) ------------------------
    gp = geometry_params_from_json(CONFIG5_GEOMETRY)

    def run5(images, plan=None):
        if plan is None:
            plan = warp_fast.plan_warp(gp, images.shape[2], images.shape[3], device=images.device)
            if plan is None:
                raise AssertionError("the planner sent config 5 to the exact path")
        parsed = [parse_adjustments(CONFIG5_DOC) for _ in range(images.shape[0])]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed],
                               device=images.device)
        warped = warp_fast.warp_with_plan(images, plan.arrays, plan.static)
        out = develop_batch(warped, sp, cfg)
        return out, device_u8(out).cpu().numpy()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan5 = warp_fast.plan_warp(gp, h, w, device=dev)
    torch.cuda.synchronize()
    plan_cold = time.perf_counter() - t0
    if plan5 is None:
        raise AssertionError("the planner sent config 5 to the exact path")
    warp_fast._cached_plan.cache_clear()
    warp_fast._cached_plan(gp, h, w, str(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = warp_fast._cached_plan(gp, h, w, str(dev))
    plan_cached = time.perf_counter() - t0
    assert cached is not None

    reset_counts()
    out5, u85 = run5(img2)
    torch.cuda.synchronize()
    launches5 = read_counts()
    log(f"[e2e5] config5 B=2 launches {launches5} u8 {u85.shape} {u85.dtype}")
    if min(launches5["blur"], launches5["grade"], launches5["nr"]) < 1 \
            or launches5["resample"] < 2:
        raise AssertionError(f"a kernel of the stencil path never launched: {launches5}")
    if not bool(torch.isfinite(out5).all()) or u85.shape != (2, 3, h, w) \
            or u85.min() == u85.max():
        raise AssertionError("config-5 e2e output is non-finite, misshapen or constant")
    del out5, u85

    small = torch.rand((2, 3, 256, 1024), generator=gen, device=dev)
    _, u8_gpu = run5(small)
    _, u8_cpu = run5(small.cpu())
    du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
    log(f"[e2e5] small 2x3x256x1024 CUDA vs plain CPU u8: max {int(du.max())} LSB, "
        f"share>0 {float((du > 0).mean()):.2e}")
    if du.max() > 1 or (du > 0).mean() > 1e-3:
        raise AssertionError("config-5 CUDA output disagrees with the plain CPU path")

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run5(img2, warp_fast._cached_plan(gp, h, w, str(dev)))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    parsed = [parse_adjustments(CONFIG5_DOC) for _ in range(2)]
    sp5, cfg5 = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=dev)
    dev_ms = time_ms(lambda: device_u8(develop_batch(
        warp_fast.warp_with_plan(img2, plan5.arrays, plan5.static), sp5, cfg5)), reps)
    warp_ms = time_ms(lambda: warp_fast.warp_with_plan(img2, plan5.arrays, plan5.static),
                      reps)
    q = device_u8(develop_batch(img2, sp5, cfg5))
    readback = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q.cpu()
        readback.append(time.perf_counter() - t0)
    log(f"[e2e5] config5 B=2: {dt * 1e3 / 2:.2f} ms/image, {2 * h * w / dt / 1e6:.1f} MPix/s "
        f"(JSON + cached plan -> u8 on host); device part {dev_ms / 2:.2f} ms/image "
        f"({2 * h * w / dev_ms / 1e3:.1f} MPix/s), of which the warp {warp_ms / 2:.2f} "
        f"ms/image; u8 readback {statistics.median(readback) * 1e3 / 2:.2f} ms/image; "
        f"planner {plan_cold * 1e3:.1f} ms cold, {plan_cached * 1e3:.3f} ms cached [{card}]")
    phase_done("e2e config 5")

    if args.profile:
        profile_run("config3 B=2", lambda: run_e2e(CONFIG3_DOC, 2, img2), args.out, card)
        profile_run("config5 B=2", lambda: run5(img2, plan5), args.out, card)
        phase_done("profile")

    # ---- 9. the profiling probes P1 and P2 -------------------------------------------
    # their entry points, as a user runs them (python -m ...), always at
    # 24 MP: each times its variants, holds each against its plain version
    # (raising on a mismatch) and prints each line with the card's name
    reset_counts()
    probe_rows = {"chunked": prof_chunked.main(), "nr_slices": prof_nr_slices.main()}
    torch.cuda.synchronize()
    launches_probes = read_counts()
    log(f"[probes] launches {launches_probes}")
    if min(launches_probes["chunked"], launches_probes["nr_slices"]) < 1:
        raise AssertionError(f"a probe kernel never launched: {launches_probes}")
    for name, rows in probe_rows.items():
        report[name, "probes"] = dict(
            min(rows, key=lambda r: r["ms"]),
            variants=[{k: r[k] for k in ("variant", "ms", "ms_range", "max_abs_err")}
                      for r in rows])
    # P2 at the shapes its plan treats apart: a width that is no multiple of
    # 4 (the edge path), an image smaller than the halo, a band shorter than
    # the ring, and an aligned width read through a misaligned pointer
    for shape, band, offset in (((3, RAGGED[0], RAGGED[1]), None, 0), ((3, 5, 9), None, 0),
                                ((3, RAGGED[0], RAGGED[1]), 7, 0),
                                ((3, RAGGED[0], RAGGED[1] + 1), None, 1)):
        n = shape[0] * shape[1] * shape[2]
        x = torch.rand(n + offset, generator=gen, device=dev)[offset:].view(shape)
        d = (prof_nr_slices.slices(x, band) - prof_nr_slices.slices_plain(x)).abs()
        ndiff = int((d > 0).sum())
        log(f"[P2] {shape} band {band or 'planned'}{' misaligned' if offset else ''}: max|d| "
            f"{float(d.max()):.1e}, {ndiff} values differ from the plain version [{card}]")
        if ndiff:
            raise AssertionError(f"P2 kernel differs from its plain version at {shape}, band "
                                 f"{band}, offset {offset}: {ndiff} values")
    phase_done("probes")

    # ---- 10. local masks, the config-4 path ------------------------------------
    # host rasterization, once per document and size; its bitmaps are reused
    t0 = time.perf_counter()
    masks4 = rasterize_masks(config4_doc(h, w), w, h, scale=1.0)
    raster_ms = (time.perf_counter() - t0) * 1e3
    p4, c4 = parse_adjustments(config4_doc(h, w))
    bands4 = blur_band_rows(c4, masks4)
    log(f"[masks] config4 rasterize {masks4.shape} on the host: {raster_ms:.1f} ms; support "
        f"{[round(float((m > 0).mean()), 4) for m in masks4]}; blur bands {bands4} [{card}]")
    mdocs = {"config4": (config4_doc, masks4), "mask_stages": (mask_stage_doc, None)}

    def mask_inputs(doc_fn, b, hh, ww, bitmaps=None):
        """(stacked params, cfg, host bitmaps, (b, N, hh, ww) influences on the card)."""
        doc = doc_fn(hh, ww)
        bm = rasterize_masks(doc, ww, hh, scale=1.0) if bitmaps is None else bitmaps
        q, c = parse_adjustments(doc)
        sp, cfg = stack_params([q] * b, [c] * b, device=dev)
        mk = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(bm, (b,) + bm.shape)))
        return sp, cfg, bm, mk.to(dev)

    # the grade kernel with masks against its plain version, on full-frame
    # levels and, where the document has bands, on the band levels the main
    # path gives it (zeros outside each band); the band case is the one timed
    mask_err = 0.0
    for (bb, hh, ww) in ((2, h, w), (2, *RAGGED)):
        images = torch.rand((bb, 3, hh, ww), generator=gen, device=dev)
        for name, (doc_fn, bitmaps) in mdocs.items():
            sp, cfg, bm, mk = mask_inputs(doc_fn, bb, hh, ww,
                                          bitmaps if (hh, ww) == (h, w) else None)
            pmat, mmat = fused.pack_rows(sp["glob"]), fused.pack_mask_rows(sp["mask"])
            plan = fused.grade_launch_plan(bb, hh, ww, cfg)
            bands = blur_band_rows(cfg, bm)
            for level_bands in ((None, bands) if bands else (None,)):
                levels = fused.blur_levels(images, cfg, level_bands)
                timed = level_bands is bands and (hh, ww) == (h, w)
                for dither in (False, True):
                    c = dataclasses.replace(cfg, dither_active=dither)
                    got = fused.grade(images, levels, pmat, c, masks=mk, mmat=mmat)
                    ref, ops = count_ops(lambda: fused.grade_plain(images, levels, pmat, c,
                                                                   masks=mk, mmat=mmat))
                    torch.cuda.synchronize()
                    d = (got - ref).abs()
                    err, share = float(d.max()), float((d > GRADE_TOL).float().mean())
                    tol = GRADE_DITHER_TOL if dither else GRADE_TOL
                    line = (f"[grade-masks] B={bb} {hh}x{ww} {name} N={cfg.mask_count} "
                            f"levels {level_bands or 'full'} stages {fused.grade_stages(cfg)} "
                            f"build {plan['min_blocks']}/masks dither={'on' if dither else 'off'}: "
                            f"max|d| {err:.3e} (bound {tol:.3e}), share>{GRADE_TOL:g} {share:.2e}")
                    if timed and not dither:
                        ms = time_ms(lambda: fused.grade(images, levels, pmat, c, masks=mk,
                                                         mmat=mmat), reps)
                        pms = time_ms(lambda: fused.grade_plain(images, levels, pmat, c,
                                                                masks=mk, mmat=mmat), reps)
                        # bytes: image, levels, influences, params read once, output written
                        bms, bby = bound_ms(nbytes(images, pmat, mmat, mk, *levels.values())
                                            + nbytes(images), ops)
                        line += (f" kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
                                 f"({bby}, {ops / (bb * hh * ww):.0f} ops/pixel) [{card}]")
                        if name == "config4":
                            report["grade", "config4"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                              bound_by=bby, library_ms=None,
                                                              max_abs_err=err)
                    log(line)
                    if not bool(torch.isfinite(got).all()) or err > tol:
                        raise AssertionError(f"grade with masks {name} B={bb} {hh}x{ww} levels "
                                             f"{level_bands or 'full'}: max|d| {err} > {tol} "
                                             f"or non-finite")
                    mask_err = max(mask_err, err if not dither else 0.0)
                    del got, ref
                del levels
            del mk
        del images
    log(f"[grade-masks] max|d| over every dither-off case {mask_err:.3e}")

    # config 4's band-restricted blur levels against the plain blur of the
    # whole frame: the band rows equal it, the rows outside are zeros
    band_levels = fused.blur_levels(img2, c4, bands4)
    radii4 = fused.blur_radii(c4, w, h)
    # the path's numbers: each band group's launch, summed; the bound's term
    # is the larger group's
    band_err, blur4, top = 0.0, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0), 0.0
    for key, y0, y1 in bands4:
        full = blur.gaussian_blur_multi_plain(img2.reshape(6, h, w), (radii4[key],))[0]
        got = band_levels[key].reshape(6, h, w)
        torch.cuda.synchronize()
        err = float(((got[:, y0:y1] - full[:, y0:y1]).abs()
                     / full[:, y0:y1].abs().clamp(min=1.0)).max())
        outside = float(torch.cat([got[:, :y0], got[:, y1:]], 1).abs().max())
        band_err = max(band_err, err, outside)
        lo, hi = max(0, y0 - radii4[key]), min(h, y1 + radii4[key])
        slab = img2.reshape(6, h, w)[:, lo:hi].contiguous()
        plan = blur.blur_launch_plan(6, hi - lo, w, (radii4[key],))
        _, ops = count_ops(lambda: blur.gaussian_blur_multi_plain(slab, (radii4[key],)))
        ms = time_ms(lambda: blur.gaussian_blur_multi(slab, (radii4[key],)), reps)
        pms = time_ms(lambda: blur.gaussian_blur_multi_plain(slab, (radii4[key],)), reps)
        bms, bby = bound_ms(2 * nbytes(slab), ops)
        blur4["ms"] += ms
        blur4["plain_ms"] += pms
        blur4["bound_ms"] += bms
        if bms > top:
            top, blur4["bound_by"] = bms, bby
        regime = "fused" if plan["fused"] else "two-pass"
        log(f"[blur-bands] config4 {key} r={radii4[key]} rows {y0}-{y1} slab (6,{hi - lo},{w}) "
            f"{regime}: max|d|/max(1,|ref|) {err:.3e}, outside the band max {outside:.1e} "
            f"(bound {BLUR_TOL:g}) kernel {ms:.3f} ms plain {pms:.3f} ms bound {bms:.3f} ms "
            f"({bby}) [{card}]")
        del full, got, slab
    if band_err > BLUR_TOL:
        raise AssertionError(f"banded blur levels: max|d| {band_err} > {BLUR_TOL}")
    report["blur", "config4"] = dict(blur4, library_ms=None, max_abs_err=band_err)
    del band_levels

    # config 4 end to end: JSON -> rasterize_masks -> blur_band_rows ->
    # stack_params -> develop_batch -> device_u8 -> host numpy
    def upload(b, bitmaps, device):
        """The (b, N, H, W) influences on `device`: each image's bitmaps
        copied in (the batch here shares one document's masks)."""
        mk = torch.empty((b,) + bitmaps.shape, dtype=torch.float32, device=device)
        for i in range(b):
            mk[i].copy_(torch.from_numpy(bitmaps))
        return mk

    def run4(b, images, bitmaps):
        doc = config4_doc(images.shape[2], images.shape[3])
        parsed = [parse_adjustments(doc) for _ in range(b)]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed],
                               device=images.device)
        bands = blur_band_rows(cfg, bitmaps)
        out = develop_batch(images, sp, cfg, masks=upload(b, bitmaps, images.device),
                            blur_bands=bands)
        return out, device_u8(out).cpu().numpy()

    # the influences the kernel reads are the host's f32 u8/255 values, the
    # same as JAX's, bit for bit (an f32 upload copies them)
    if not torch.equal(upload(1, masks4, dev)[0].cpu(), torch.from_numpy(masks4)):
        raise AssertionError("the uploaded influences differ from the host bitmaps")
    log("[masks] uploaded f32 influences equal the host bitmaps bit for bit")

    reset_counts()
    out4, u84 = run4(2, img2, masks4)
    torch.cuda.synchronize()
    launches4 = read_counts()
    log(f"[e2e4] config4 B=2 launches {launches4} u8 {u84.shape} {u84.dtype}")
    if min(launches4["blur"], launches4["grade"]) < 1:
        raise AssertionError(f"a kernel of the config-4 path never launched: {launches4}")
    if not bool(torch.isfinite(out4).all()) or u84.shape != (2, 3, h, w) \
            or u84.min() == u84.max():
        raise AssertionError("config-4 e2e output is non-finite, misshapen or constant")
    del out4, u84

    small = torch.rand((2, 3, 384, 512), generator=gen, device=dev)
    small_masks = rasterize_masks(config4_doc(384, 512), 512, 384, scale=1.0)
    _, u8_gpu = run4(2, small, small_masks)
    _, u8_cpu = run4(2, small.cpu(), small_masks)
    du = np.abs(u8_gpu.astype(np.int16) - u8_cpu.astype(np.int16))
    log(f"[e2e4] small 2x3x384x512 CUDA vs plain CPU u8: max {int(du.max())} LSB, "
        f"share>0 {float((du > 0).mean()):.2e}")
    if du.max() > 1 or (du > 0).mean() > 1e-3:
        raise AssertionError("config-4 CUDA output disagrees with the plain CPU path")

    for b in (1, 2):
        imgs = img2[:b].contiguous()
        run4(b, imgs, masks4)
        times, uploads, readback = [], [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run4(b, imgs, masks4)
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            upload(b, masks4, dev)
            torch.cuda.synchronize()
            uploads.append(time.perf_counter() - t0)
        dt = statistics.median(times)
        parsed = [parse_adjustments(config4_doc(h, w)) for _ in range(b)]
        sp, cfg = stack_params([q for q, _ in parsed], [c for _, c in parsed], device=dev)
        mk_dev = upload(b, masks4, dev)
        bands = blur_band_rows(cfg, masks4)
        dev_ms = time_ms(lambda: device_u8(develop_batch(imgs, sp, cfg, masks=mk_dev,
                                                         blur_bands=bands)), reps)
        q = device_u8(develop_batch(imgs, sp, cfg, masks=mk_dev, blur_bands=bands))
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.cpu()
            readback.append(time.perf_counter() - t0)
        log(f"[e2e4] config4 B={b}: {dt * 1e3 / b:.2f} ms/image, {b * h * w / dt / 1e6:.1f} "
            f"MPix/s (JSON + bitmaps -> u8 on host); host rasterization {raster_ms:.1f} ms "
            f"per document (once, not in e2e); mask upload ({b},{masks4.shape[0]},{h},{w}) "
            f"f32 {statistics.median(uploads) * 1e3 / b:.2f} ms/image; device part "
            f"{dev_ms / b:.2f} ms/image ({b * h * w / dev_ms / 1e3:.1f} MPix/s); u8 readback "
            f"{statistics.median(readback) * 1e3 / b:.2f} ms/image [{card}]")
        del mk_dev, q
    if args.profile:
        profile_run("config4 B=2", lambda: run4(2, img2, masks4), args.out, card)
    phase_done("config 4")
    del img2

    # ---- 11. config 2 (RAW): DNG -> load_image -> develop_batch -> u8 ----------
    launches2, raw_report = phase_raw(args, h, w, reps, card, dev, reset_counts, read_counts)
    report.update(raw_report)
    phase_done("config 2 (RAW)")

    # ---- 12. config 2 from the vendor containers: CR2, NEF, ARW, CR3 -> u8 -------
    launches12 = phase_vendor(args, h, w, reps, card, dev, reset_counts, read_counts)
    phase_done("config 2 vendor RAW")

    # ---- 13. flare, the 3D LUT and NR with per-pixel amounts -> u8 -------------
    launches13, doc_report = phase_doc(h, w, reps, card, dev, reset_counts, read_counts)
    report.update(doc_report)
    phase_done("flare, LUT, per-pixel NR")

    # ---- 14. batch export: DNG files -> JPEG / TIFF / PNG with EXIF ------------
    launches14 = phase_export(args, h, w, card, dev, reset_counts, read_counts)
    phase_done("batch export")

    # ---- 15. LDR inputs and export with a watermark and per-mask files ---------
    launches15, ldr_report = phase_ldr(args, h, w, reps, card, dev, reset_counts, read_counts)
    report.update(ldr_report)
    phase_done("LDR inputs and export")

    # ---- 16. the preview service: RenderService, its workers, on the card -------
    launches16, preview_report = phase_preview(args, h, w, reps, card, dev, reset_counts,
                                               read_counts)
    report.update(preview_report)
    # the service warps at the source's size (phase 7's 24 MP case), never
    # at the preview's: phase 16's resample rows time a shape no caller runs
    report["resample", "preview"] = report["resample", "config5"]
    phase_done("preview service")

    # ---- 17. the CLI and the tiled develop ------------------------------------
    launches17, cli_report = phase_cli(args, h, w, reps, card, dev, reset_counts, read_counts)
    report.update(cli_report)
    phase_done("CLI and tiled develop")

    # ---- 18. thumbnails, community previews and the compositions -------------
    launches18, library_report = phase_library(args, h, w, reps, card, dev, reset_counts,
                                               read_counts)
    report.update(library_report)
    phase_done("thumbnails, community, compositions")

    sources = {  # name -> (source, the TPU kernel it replaces, the path that runs it)
        "blur": ("rapidraw_tpu_torch/csrc/blur.cu", "rapidraw_tpu/ops/blur.py:242", "config5"),
        "grade": ("rapidraw_tpu_torch/csrc/grade.cu", "rapidraw_tpu/pipeline/fused.py:298",
                  "config5"),
        "nr": ("rapidraw_tpu_torch/csrc/nr.cu", "rapidraw_tpu/ops/nr.py:1005", "config5"),
        # no TPU kernel: JAX runs these with XLA (the flare map's taps, the
        # per-pixel NR path's gathers)
        "flare": ("rapidraw_tpu_torch/csrc/flare.cu",
                  "rapidraw_tpu/ops/flare.py:101 (XLA, no Pallas kernel)", "flare_lut"),
        "nr_dynamic": ("rapidraw_tpu_torch/csrc/nr.cu",
                       "rapidraw_tpu/ops/nr.py:108 (XLA gathers, no Pallas kernel)", "masked_nr"),
        "resample": ("rapidraw_tpu_torch/csrc/resample.cu",
                     "rapidraw_tpu/geometry/warp_fast.py:473", "config5"),
        "chunked": ("rapidraw_tpu_torch/csrc/chunked.cu", "tools/prof_chunked.py:60", "probes"),
        "nr_slices": ("rapidraw_tpu_torch/csrc/nr_slices.cu", "tools/prof_nr_slices.py:68",
                      "probes"),
    }
    # top level: the path that runs the kernel (config 5 runs the develop
    # paths' four; a probe's variant with the lowest median is named, and
    # every variant's median and range is under paths.probes); "paths": each path's
    # own launch count and, where it runs the kernel, the numbers of the case
    # at that path's shapes
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    counts = {"config3": launches3, "config5": launches5, "probes": launches_probes,
              "config4": launches4, **launches2, **launches12, **launches13,
              "export": launches14, "ldr_export": launches15, "preview": launches16,
              **launches17, **launches18}
    library = {"nr_dynamic": "nr"}  # the kernels that share a source with another
    # a kernel that shares its source: its own entry's registers and spills
    entry = {"nr": "nr_kernel", "nr_dynamic": "nr_dynamic_kernel"}

    def regs_spills(name):
        if name in entry:
            return ptxas_entries(libs[library.get(name, name)].build_log)[entry[name]]
        return usage[name]

    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[top][name], **{k: report[name, top][k] for k in fields},
         "regs": regs_spills(name)[0], "spills": regs_spills(name)[1],
         **({"variant": report[name, top]["variant"]} if top == "probes" else {}),
         "paths": {path: {"launches": n[name], **report.get((name, path), {})}
                   for path, n in counts.items()}}
        for name, (src, rep, top) in sources.items()
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
