"""Image resizing: the energy-preserving area downscale and the Lanczos3
resample of the export.

`downscale` and `downscale_to_long_edge` port `rapidraw_tpu/geometry/
resize.py` (downscale_f32_image, image_processing.rs:197-354): area
weights on SQUARED pixel values with a square root at the end, aspect kept
via ratio = min(nw/W, nh/H) and rounded output sizes. The separable weight
tables are built on the host exactly like the reference's loops; the two
products run in plain PyTorch on the image's device, in float64.

`lanczos_resize` is the export's output resize (export_processing.rs:
194-211), which the JAX package runs through PIL's 'F'-mode
`resize(..., LANCZOS)`: PIL's coefficients (precompute_coeffs: support
3 * max(scale, 1), centre (i + 0.5) * scale, weights normalized, in float64)
and its two passes, horizontal then vertical, each summed tap by tap in
float64 and stored as float32. `lanczos_resize_u8` is PIL's 8-bit
LANCZOS on modes "L", "RGB" and "RGBA" (the watermark and the mask alpha
PNGs of the export, the AI patches' colour and mask images): the same
coefficients as integers at 22 fraction bits, the
intermediate clipped to 8 bits, RGBA resampled premultiplied.
`resize_u8` is PIL's 8-bit resize with BILINEAR, BICUBIC or LANCZOS over a
box, `reduce_u8` its `Image.reduce` and `thumbnail_u8` its
`Image.thumbnail` (reduce, then BICUBIC over the reduced box): the JAX
package's thumbnails, embedded previews and culling hashes, byte for byte.

`resize_bilinear` is `jax.image.resize(x, shape, "bilinear")`, which every
AI entry resizes with: per axis whose size changes, a weight matrix of
the triangle kernel at half-pixel centres, widened by the scale when it
downscales (the antialias `F.interpolate(mode="bilinear")` lacks),
renormalized where the kernel leaves the input, zero for a sample outside
it; built in float32 as JAX builds it, the axes contracted in order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rapidraw_tpu_torch.ops.common import sqrt_rn


@functools.lru_cache(maxsize=32)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) normalized overlap weights (image_processing.rs:226-299)."""
    ratio = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for i_out in range(n_out):
        start = i_out * ratio
        end = (i_out + 1) * ratio
        i0 = int(np.floor(start))
        i1 = min(int(np.ceil(end)), n_in)
        total = 0.0
        for i_in in range(i0, i1):
            ov = max(min(end, i_in + 1) - max(start, i_in), 0.0)
            if ov > 0:
                w[i_out, i_in] = ov
                total += ov
        if total > 0:
            w[i_out] /= total
    return w


def downscale(image: torch.Tensor, nwidth: int, nheight: int) -> torch.Tensor:
    """Downscale planar (3, H, W) to fit (nwidth, nheight), keeping aspect."""
    _, h, w = image.shape
    if nwidth <= 0 or nheight <= 0 or (nwidth >= w and nheight >= h):
        return image
    ratio = min(nwidth / w, nheight / h)
    new_w = int(round(w * ratio))
    new_h = int(round(h * ratio))
    if new_w == 0 or new_h == 0:
        return image
    dev = image.device
    wy = torch.from_numpy(_area_weights(h, new_h)).to(dev, torch.float64)
    wx = torch.from_numpy(_area_weights(w, new_w)).to(dev, torch.float64)
    sq = torch.square(torch.clamp(image, min=0.0)).to(torch.float64)
    out = torch.matmul(torch.matmul(wy, sq), wx.T).to(torch.float32)
    return sqrt_rn(torch.clamp(out, min=0.0))


def downscale_to_long_edge(image: torch.Tensor, long_edge: int) -> torch.Tensor:
    """Fit the longest side to `long_edge` (preview/thumbnail sizing)."""
    _, h, w = image.shape
    if max(h, w) <= long_edge:
        return image
    if w >= h:
        return downscale(image, long_edge, max(1, int(round(h * long_edge / w))))
    return downscale(image, max(1, int(round(w * long_edge / h))), long_edge)


@functools.lru_cache(maxsize=64)
def bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image's compute_weight_mat for
    the triangle kernel with antialiasing, scale n_out / n_in."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.0)
    sample = sample - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """`jax.image.resize(x, shape, "bilinear")` on x's device in float32:
    each axis whose size changes is contracted with its weight matrix, in
    axis order (TF32 off)."""
    from rapidraw_tpu_torch.ai.layers import exact_fp32

    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize_bilinear: shape {shape} does not match rank of {tuple(x.shape)}")
    x = x.to(torch.float32)
    with exact_fp32():
        for d, n in enumerate(shape):
            if x.shape[d] == n:
                continue
            w = torch.from_numpy(bilinear_weights(x.shape[d], n)).to(x.device)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x.contiguous()


def _lanczos3(x: float) -> float:
    """PIL's lanczos_filter: sinc(x) * sinc(x / 3) on [-3, 3)."""
    if -3.0 <= x < 3.0:
        a = 1.0 if x == 0.0 else math.sin(x * math.pi) / (x * math.pi)
        y = x / 3
        b = 1.0 if y == 0.0 else math.sin(y * math.pi) / (y * math.pi)
        return a * b
    return 0.0


def _bilinear(x: float) -> float:
    """PIL's bilinear_filter: the triangle on (-1, 1)."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    """PIL's bicubic_filter: Keys' cubic convolution with a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# PIL's filters and their supports (Resample.c)
FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
           "lanczos": (_lanczos3, 3.0)}


@functools.lru_cache(maxsize=64)
def filter_coeffs(in_size: int, out_size: int, name: str = "lanczos", in0: float = 0.0,
                  in1: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs of filter `name` over the input span [in0,
    in1) (the whole input by default): (first input index (out_size,)
    int64, weights (out_size, ksize) float64, zero past each output's
    taps)."""
    filt, filter_support = FILTERS[name]
    in1 = float(in_size) if in1 is None else in1
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        kk[xx, :xmax] = k
        first[xx] = xmin
    return first, kk


def _resample_last(x: torch.Tensor, out_size: int, rows: int = 256) -> torch.Tensor:
    """One PIL pass along the last axis of (C, R, N) float32: float64 sums
    tap by tap in PIL's order, stored as float32."""
    c, r, n = x.shape
    first, kk = filter_coeffs(n, out_size)
    ksize = kk.shape[1]
    idx = torch.from_numpy(np.minimum(first[:, None] + np.arange(ksize), n - 1)).to(x.device)
    k = torch.from_numpy(kk).to(x.device)
    out = torch.empty((c, r, out_size), dtype=torch.float32, device=x.device)
    for r0 in range(0, r, rows):
        src = x[:, r0:r0 + rows].to(torch.float64)
        acc = torch.zeros((c, src.shape[1], out_size), dtype=torch.float64, device=x.device)
        for t in range(ksize):
            acc += src[..., idx[:, t]] * k[:, t]
        out[:, r0:r0 + rows] = acc.to(torch.float32)
    return out


def lanczos_resize(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Planar (C, H, W) float32 -> (C, height, width), as PIL's 'F'-mode
    resize((width, height), LANCZOS) of each channel (no clamp)."""
    _, h, w = image.shape
    out = image.to(torch.float32)
    if width != w:
        out = _resample_last(out, width)
    if height != h:
        out = _resample_last(out.transpose(1, 2), height).transpose(1, 2)
    return out.contiguous()


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


@functools.lru_cache(maxsize=64)
def _coeffs_8bpc(in_size: int, out_size: int, name: str = "lanczos", in0: float = 0.0,
                 in1: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """PIL's normalize_coeffs_8bpc of `filter_coeffs`: (tap index (out,
    ksize) clamped into the input, int64 weights at 22 fraction bits,
    rounded half away from zero)."""
    first, kk = filter_coeffs(in_size, out_size, name, in0, in1)
    scaled = kk * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(kk < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    return idx, k


def _resample_u8_last(x: np.ndarray, out_size: int, name: str = "lanczos",
                      span: tuple[float, float] | None = None) -> np.ndarray:
    """One 8-bit PIL pass (ImagingResampleHorizontal_8bpc) along the last
    axis of (..., N) uint8: integer taps summed from a half, shifted down
    by 22 bits and clipped to [0, 255]."""
    in0, in1 = span if span is not None else (0.0, None)
    idx, k = _coeffs_8bpc(x.shape[-1], out_size, name, in0, in1)
    acc = np.full(x.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        acc += x[..., idx[:, t]].astype(np.int64) * k[:, t]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_planes_u8(planes: np.ndarray, width: int, height: int, name: str = "lanczos",
                      box: tuple[float, float, float, float] | None = None) -> np.ndarray:
    """(C, H, W) uint8 -> (C, height, width) over `box` (x0, y0, x1, y1;
    the whole image by default): the horizontal pass, then the vertical one
    on the clipped 8-bit intermediate. A pass is skipped where PIL skips it
    (ImagingResample's need_horizontal / need_vertical), and a box of
    integer corners the output's size is PIL's crop."""
    _, h, w = planes.shape
    x0, y0, x1, y1 = box if box is not None else (0, 0, w, h)
    if (x0 == int(x0) and y0 == int(y0) and x1 - x0 == width and y1 - y0 == height):
        return np.ascontiguousarray(planes[:, int(y0):int(y0) + height, int(x0):int(x0) + width])
    out = planes
    if width != w or x0 or x1 != width:
        out = _resample_u8_last(out, width, name, (float(x0), float(x1)))
    if height != h or y0 or y1 != height:
        out = _resample_u8_last(out.transpose(0, 2, 1), height, name,
                                (float(y0), float(y1))).transpose(0, 2, 1)
    return np.ascontiguousarray(out)


def _planes(image: np.ndarray) -> np.ndarray:
    """(H, W) mode "L" or (H, W, 3) mode "RGB" -> (C, H, W)."""
    if image.ndim == 2:
        return image[None]
    if image.ndim == 3 and image.shape[2] == 3:
        return image.transpose(2, 0, 1)
    raise ValueError(f"modes L (H, W) and RGB (H, W, 3) only, got {image.shape}")


def _unplanes(planes: np.ndarray, like: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(planes[0] if like.ndim == 2 else planes.transpose(1, 2, 0))


def resize_u8(image: np.ndarray, width: int, height: int, name: str = "bicubic",
              box: tuple[float, float, float, float] | None = None) -> np.ndarray:
    """PIL's `Image.resize((width, height), filter, box)` (no reducing gap)
    of mode "L" (H, W) or "RGB" (H, W, 3) uint8, filter `name` one of
    "bilinear", "bicubic", "lanczos". The same size over the whole image
    returns a copy."""
    h, w = image.shape[:2]
    if (h, w) == (height, width) and box in (None, (0, 0, w, h)):
        return image.copy()
    return _unplanes(_resize_planes_u8(_planes(image), width, height, name, box), image)


def _reduce_multiplier(n: np.ndarray) -> np.ndarray:
    """PIL's division_UINT32(n, 8): float32 2^32 / (256 n), truncated."""
    return (np.float32(4294967296.0) / (n * 256).astype(np.float32)).astype(np.int64)


def reduce_u8(image: np.ndarray, fx: int, fy: int | None = None) -> np.ndarray:
    """PIL's `Image.reduce((fx, fy))` of mode "L" or "RGB" uint8: the mean
    of each fx x fy box (the last row and column of boxes cut by the
    image's edge average what they hold), output ceil(W / fx) x
    ceil(H / fy). Each mean is ((sum + n // 2) * division_UINT32(n, 8)) >>
    24 for a box of n pixels, as Reduce.c computes it."""
    fy = fx if fy is None else fy
    if (fx, fy) == (1, 1):
        return image.copy()
    planes = _planes(image)
    c, h, w = planes.shape
    ho, wo = -(-h // fy), -(-w // fx)
    padded = np.zeros((c, ho * fy, wo * fx), np.uint16 if fx * fy <= 257 else np.uint32)
    padded[:, :h, :w] = planes
    sums = padded.reshape(c, ho, fy, wo, fx).sum(axis=(2, 4), dtype=np.int64)
    ny = np.minimum(fy, h - np.arange(ho) * fy)
    nx = np.minimum(fx, w - np.arange(wo) * fx)
    n = ny[:, None] * nx[None, :]
    out = ((sums + n // 2) * _reduce_multiplier(n)) >> 24
    return _unplanes(out.astype(np.uint8), image)


def thumbnail_size(width: int, height: int, size: tuple[float, float]) -> tuple[int, int] | None:
    """The size PIL's `Image.thumbnail(size)` gives a width x height image
    (its preserve_aspect_ratio), or None where it leaves the image as it is."""
    x, y = (math.floor(v) for v in size)
    if x >= width and y >= height:
        return None

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail_u8(image: np.ndarray, size: tuple[float, float]) -> np.ndarray:
    """PIL's `Image.thumbnail(size)` of mode "L" or "RGB" uint8 (an image
    from memory, so no draft) with its defaults, BICUBIC and a reducing gap
    of 2: the aspect-kept size of `thumbnail_size`, then a `reduce_u8` by
    int(span / size / 2) per axis first, where that is above 1, and BICUBIC
    over the reduced image's share of the box."""
    h, w = image.shape[:2]
    final = thumbnail_size(w, h, size)
    if final is None or final == (w, h):
        return image.copy()
    tw, th = final
    box = (0, 0, w, h)
    fx = int(w / tw / 2.0) or 1
    fy = int(h / th / 2.0) or 1
    if fx > 1 or fy > 1:
        # the safe box of a whole-image box is the whole image
        image = reduce_u8(image, fx, fy)
        box = (0.0, 0.0, w / fx, h / fy)
    return resize_u8(image, tw, th, "bicubic", box)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.uint32) * b + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def lanczos_resize_u8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.resize((width, height), Image.LANCZOS)` of an 8-bit
    image: (H, W) mode "L", (H, W, 3) mode "RGB" (band by band, as PIL
    resamples its 4-byte RGBX pixels) or (H, W, 4) mode "RGBA". RGBA resamples as
    premultiplied "RGBa" (PIL's rgbA2rgba, a * c / 255 rounded with its
    MULDIV255) and converts back with rgba2rgbA (255 * c // a clipped,
    colour kept where a is 0 or 255). The same size returns a copy."""
    if image.ndim == 2 or image.shape[2] == 3:
        return resize_u8(image, width, height, "lanczos")
    if image.shape[:2] == (height, width):
        return image.copy()
    a = image[..., 3]
    premul = np.concatenate([_muldiv255(image[..., :3], a[..., None]), a[..., None]], axis=-1)
    out = _resize_planes_u8(premul.transpose(2, 0, 1), width, height).transpose(1, 2, 0)
    rgb, alpha = out[..., :3].astype(np.int32), out[..., 3:4].astype(np.int32)
    straight = np.minimum(255 * rgb // np.maximum(alpha, 1), 255)
    rgb = np.where((alpha == 0) | (alpha == 255), rgb, straight)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
