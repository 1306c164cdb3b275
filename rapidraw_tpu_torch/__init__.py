"""rapidraw_tpu_torch — the PyTorch / CUDA port of rapidraw_tpu for one
NVIDIA H100.

The develop main path: one adjustment document applied to planar
(3, H, W) float32 images, then quantized on the device. RAW files load
through `load_image` (DNG, RAF and the vendor containers CR2, CR3, NEF,
PEF, ARW, ORF, RW2, MRW, IIQ and the TIFF-CFA tail decoded on the host,
then demosaic, colour, highlight compression and the RAW enhance pass on
the device).
Local masks are rasterized on the host (rasterize_masks, blur_band_rows)
and blended in the grade; a 3D LUT is parsed on the host (io/lut.py) and
applied in the grade; lens flare is a 512^2 map per image sampled in the
grade. Batch export (`export_images`) writes JPEG (csrc/host/jpeg_enc.cc),
PNG, TIFF or JPEG XL files with their EXIF copied (io/encode.py,
io/exif.py). The preview service (`RenderService`: previews, ROI, the
interactive divisor, scopes, auto adjust, the crop, original, geometry and
preset previews with their caches; `PreviewWorker` and `AnalyticsWorker`
on their own threads) renders through the same develop; AI patches
composite before the transforms (masks/patches.py). The CLI
(`python -m rapidraw_tpu_torch`, cli.py) develops, exports, analyses and
manages a library of files; an image past 8192 px develops tile by tile
(pipeline/tiled.py). On CUDA tensors it runs hand-written Hopper kernels (csrc/blur.cu
for the blur pyramid, csrc/nr.cu for noise reduction, csrc/flare.cu for
the flare maps, csrc/grade.cu for the whole per-pixel grade chain,
csrc/resample.cu for the warp); on CPU tensors it runs their plain PyTorch
versions. The JAX package `rapidraw_tpu` stays the reference; this
package never imports it or JAX.
"""

__version__ = "0.1.0"

import torch

# MKL's vector math, behind PyTorch's CPU exp, log, log2, sqrt, sin, cos,
# tanh and erf in float32 and float64, sets itself up on its first call in
# a process. When that first call is split over intra-op threads, the
# threads that did not set it up return their share up to ~3e-4 off, that
# one time. One call of one element runs on this thread alone and sets it
# up before any of the port's CPU ops run.
torch.sqrt(torch.ones(1))

from rapidraw_tpu_torch.io.containers import parse_raw  # noqa: F401
from rapidraw_tpu_torch.io.loader import load_image  # noqa: F401
from rapidraw_tpu_torch.masks.rasterize import rasterize_masks  # noqa: F401
from rapidraw_tpu_torch.params.parse import (  # noqa: F401
    DevelopConfig,
    DevelopParams,
    merge_configs,
    parse_adjustments,
)
from rapidraw_tpu_torch.pipeline.bands import blur_band_rows  # noqa: F401
from rapidraw_tpu_torch.pipeline.batch import develop_batch, stack_params  # noqa: F401
from rapidraw_tpu_torch.pipeline.develop import develop  # noqa: F401
from rapidraw_tpu_torch.pipeline.service import (  # noqa: F401
    AnalyticsWorker,
    PreviewResult,
    PreviewWorker,
    RenderService,
)
from rapidraw_tpu_torch.pipeline.export import (  # noqa: F401
    ExportResult,
    ExportSettings,
    develop_single,
    device_u8,
    device_u16,
    estimate_export_sizes,
    export_images,
)
