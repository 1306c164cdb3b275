"""Separable Gaussian blur pyramid (PyTorch + the CUDA kernel csrc/blur.cu).

Port of `rapidraw_tpu/ops/blur.py`. Semantics from blur.wgsl: truncated
Gaussian with sigma = radius/2, taps [-radius, radius], clamp-to-edge
sampling, normalized by the full weight sum; input samples clamped to
[0, F16_MAX] (the reference pyramid lives in rgba16f textures).

`gaussian_blur_multi` is the kernel wrapper: a CPU tensor goes to the plain
version (`gaussian_blur_multi_plain`, depthwise convolutions), a CUDA
tensor to the hand-written kernel, which replaces the TPU kernels B1
(`_blur_axis`) and B2 (`_blur_axis_multi`). There is no fallback between
the two.
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


def _blur_multi_cuda(img: torch.Tensor, radii: tuple) -> list:
    c, n, m = img.shape
    if not img.is_contiguous():
        raise ValueError("blur kernel takes a contiguous tensor")
    if n >= 65536:
        raise ValueError(f"blur kernel takes fewer than 65536 rows, got {n}")
    levels = len(radii)
    tmp = torch.empty((levels * c, n, m), dtype=torch.float32, device=img.device)
    out = torch.empty_like(tmp)
    wstride = 2 * max(radii) + 1
    wbuf = torch.empty((levels, wstride), dtype=torch.float32, device=img.device)
    rs = list(radii) + [0] * (MAX_LEVELS - levels)
    lib = _KERNEL.lib()
    fn = lib.rr_blur_multi
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(img.device).cuda_stream
    status = fn(
        img.data_ptr(), tmp.data_ptr(), out.data_ptr(), wbuf.data_ptr(),
        wstride, *rs, levels, c, n, m, stream,
    )
    _KERNEL.check(status, "rr_blur_multi")
    gaussian_blur_multi.launches += 1
    return [out[g * c : (g + 1) * c] for g in range(levels)]


def gaussian_blur_multi(img: torch.Tensor, radii: tuple) -> list:
    """All blur-pyramid levels of one (C, H, W) source.

    CPU tensor -> plain depthwise convolutions; CUDA tensor -> one launch
    of csrc/blur.cu (H pass fanned out to every level, then V pass).
    Returns a list of (C, H, W) levels, one per radius.
    """
    radii = tuple(int(r) for r in radii)
    _check_input(img, radii)
    if img.device.type == "cpu":
        return gaussian_blur_multi_plain(img, radii)
    if img.device.type != "cuda":
        raise ValueError(f"blur runs on CPU or CUDA tensors, got {img.device}")
    return _blur_multi_cuda(img, radii)


# launch count of the blur kernel: one per rr_blur_multi call (the weight
# prep, the H pass and the V pass of every level of one source)
gaussian_blur_multi.launches = 0


def gaussian_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """One blur level of planar (C, H, W) — the single-radius case (B1)."""
    return gaussian_blur_multi(img, (radius,))[0]
