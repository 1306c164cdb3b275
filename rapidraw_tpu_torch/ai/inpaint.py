"""LaMa inpainting (Fast Fourier Convolutions) and the generative-replace
patch.

Port of `rapidraw_tpu/ai/inpaint.py` (ai_processing.rs:781-917): crop a
1.5x-padded window around the mask bbox, downscale to <=768, edge-pad to a
64-aligned square, run the model (image in [0,1] + binary mask -> RGB in
[0,255]), then alpha-blend the result back through the mask. The generator
(Suvorov et al., "Resolution-robust Large Mask Inpainting with Fourier
Convolutions", WACV 2022):

  * stem: reflection-padded 7x7 conv on (masked image, mask) -> 64ch;
  * 3 stride-2 downsamples to 512ch, the last one splitting channels
    into a 25% local / 75% global FFC pair;
  * 9 FFC residual blocks: local<->global convs plus a spectral
    transform on the global half (rfft2 -> 1x1 conv over stacked
    real/imag -> irfft2, norm "ortho" over H and W);
  * 3 transposed-conv upsamples back to 64ch, 7x7 out conv, sigmoid.

Weights load from `lama.npz` in the models directory (ai/masks.py);
ModelUnavailable otherwise. The patch's two JPEGs (q92, PIL's "RGB" and
"L") come from the port's encoder (csrc/host/jpeg_enc.cc), byte for byte.
"""

from __future__ import annotations

import base64
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.ai.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Named,
    exact_fp32,
    fp32_forward,
)
from rapidraw_tpu_torch.ai.masks import _load_variables, as_image, lama_weights
from rapidraw_tpu_torch.geometry.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    ngf: int = 64
    n_blocks: int = 9
    global_ratio: float = 0.75


LAMA = LamaConfig()  # what run_lama_inpainting runs
MAX_DIM = 768  # inference size cap (ai_processing.rs:825)
ALIGN = 64  # tensor padded to a 64-aligned square (:845-851)


class BN(Named):
    def __init__(self, ch):
        super().__init__()
        self.auto("BatchNorm", BatchNorm(ch))

    def forward(self, x):
        return self.BatchNorm_0(x)


def refl_pad(x, p):
    return F.pad(x, (p, p, p, p), mode="reflect")


class FourierUnit(torch.nn.Module):
    def __init__(self, cin, ch):
        super().__init__()
        self.conv = Conv(2 * cin, 2 * ch, 1, bias=False)
        self.bn = BN(2 * ch)

    def forward(self, x):  # (B, C, H, W)
        H, W = x.shape[2], x.shape[3]
        f = torch.fft.rfft2(x, dim=(2, 3), norm="ortho")
        f = torch.cat([f.real, f.imag], dim=1)  # (B, 2C, H, W/2+1)
        f = torch.relu(self.bn(self.conv(f)))
        re, im = torch.chunk(f, 2, dim=1)
        return torch.fft.irfft2(torch.complex(re, im), s=(H, W), dim=(2, 3), norm="ortho")


class SpectralTransform(torch.nn.Module):
    def __init__(self, cin, ch):
        super().__init__()
        self.conv1 = Conv(cin, ch // 2, 1, bias=False)
        self.bn1 = BN(ch // 2)
        self.fu = FourierUnit(ch // 2, ch // 2)
        self.conv2 = Conv(ch // 2, ch, 1, bias=False)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        y = self.fu(x)
        return self.conv2(x + y)


class FFC(torch.nn.Module):
    """Split-channel conv: local/global in -> local/global out; absent
    paths (the all-local stem and downsamples) have no weights."""

    def __init__(self, in_l, in_g, out_ch, kernel, ratio_gout, stride=1):
        super().__init__()
        out_g = int(out_ch * ratio_gout)
        out_l = out_ch - out_g
        self.out_l, self.out_g, self.k, self.pad = out_l, out_g, kernel, kernel // 2

        def conv(cin, ch):
            return Conv(cin, ch, kernel, stride=stride, padding="VALID", bias=False)

        if out_l:
            self.l2l = conv(in_l, out_l)
            if in_g:
                self.g2l = conv(in_g, out_l)
        if out_g:
            self.l2g = conv(in_l, out_g)
            if in_g:
                self.g2g = SpectralTransform(in_g, out_g)

    def _prep(self, x):
        return refl_pad(x, self.pad) if self.pad else x

    def forward(self, xl, xg):
        yl = yg = None
        if self.out_l:
            yl = self.l2l(self._prep(xl))
            if xg is not None:
                yl = yl + self.g2l(self._prep(xg))
        if self.out_g:
            yg = self.l2g(self._prep(xl))
            if xg is not None:
                yg = yg + self.g2g(xg)
        return yl, yg


class FFCBlockActNorm(torch.nn.Module):
    def __init__(self, in_l, in_g, out_ch, kernel, ratio_gout, stride=1):
        super().__init__()
        self.ffc = FFC(in_l, in_g, out_ch, kernel, ratio_gout, stride)
        if self.ffc.out_l:
            self.bn_l = BN(self.ffc.out_l)
        if self.ffc.out_g:
            self.bn_g = BN(self.ffc.out_g)

    def forward(self, xl, xg):
        yl, yg = self.ffc(xl, xg)
        if yl is not None:
            yl = torch.relu(self.bn_l(yl))
        if yg is not None:
            yg = torch.relu(self.bn_g(yg))
        return yl, yg


class FFCResnetBlock(torch.nn.Module):
    def __init__(self, ch, ratio):
        super().__init__()
        g = int(ch * ratio)
        self.conv1 = FFCBlockActNorm(ch - g, g, ch, 3, ratio)
        self.conv2 = FFCBlockActNorm(ch - g, g, ch, 3, ratio)

    def forward(self, xl, xg):
        yl, yg = self.conv1(xl, xg)
        yl, yg = self.conv2(yl, yg)
        return xl + yl, xg + yg


class LamaGenerator(torch.nn.Module):
    """image (B, 3, S, S) in [0,1], mask (B, 1, S, S) in {0,1} ->
    (B, 3, S', S') in [0, 255] (the ONNX contract the reference consumes,
    ai_processing.rs:884-893); S' = S + 8, the caller crops."""

    def __init__(self, config: LamaConfig = LAMA):
        super().__init__()
        c = self.config = config
        self.stem = FFCBlockActNorm(4, 0, c.ngf, 7, 0.0)
        ch, in_l = c.ngf, c.ngf
        for i in range(3):
            ch *= 2
            gout = c.global_ratio if i == 2 else 0.0
            self.add_module(f"down{i}", FFCBlockActNorm(in_l, 0, ch, 3, gout, stride=2))
            in_l = ch
        for i in range(c.n_blocks):
            self.add_module(f"block{i}", FFCResnetBlock(ch, c.global_ratio))
        for i in range(3):
            # torch ConvTranspose2d(k=3, s=2, padding=1, output_padding=1)
            # == flax ConvTranspose with explicit ((1,2),(1,2)) padding
            self.add_module(f"up{i}", ConvTranspose(ch, ch // 2, 3, 2, padding=((1, 2), (1, 2))))
            ch //= 2
            self.add_module(f"up_bn{i}", BN(ch))
        self.out = Conv(ch, 3, 7, padding="VALID")

    @fp32_forward
    def forward(self, image, mask):
        x = torch.cat([image * (1.0 - mask), mask], dim=1)
        x = refl_pad(x, 3)
        xl, _ = self.stem(x, None)
        xg = None
        for i in range(3):
            xl, xg = getattr(self, f"down{i}")(xl, xg)
        for i in range(self.config.n_blocks):
            xl, xg = getattr(self, f"block{i}")(xl, xg)
        x = torch.cat([xl, xg], dim=1)
        for i in range(3):
            x = torch.relu(getattr(self, f"up_bn{i}")(getattr(self, f"up{i}")(x)))
        x = refl_pad(x, 3)
        x = self.out(x)
        return torch.sigmoid(x) * 255.0


def run_lama_inpainting(planar, mask: np.ndarray, device="cuda") -> torch.Tensor:
    """Inpaint planar (3, H, W) f32 [0,1] where mask (H, W) > 0, on `device`.

    Host orchestration mirrors run_lama_inpainting
    (ai_processing.rs:781-917): mask-bbox crop with 1.5x padding,
    downscale to MAX_DIM, edge-clamped pad to an ALIGN-aligned square,
    inference, bilinear resize back, alpha-blend by the mask value / 255.
    Returns a new (3, H, W) f32 tensor on `device`.
    """
    dev = torch.device(device)
    config = LAMA
    model = _load_variables("lama.npz", "LaMa", lambda f: lama_weights(f, config), dev, config)
    image = as_image(planar, dev)
    mask = np.asarray(mask)
    _, h, w = image.shape
    ys, xs = np.nonzero(mask > 0)
    if ys.size == 0:
        return image.clone()
    min_x, max_x = int(xs.min()), int(xs.max())
    min_y, max_y = int(ys.min()), int(ys.max())

    pad_x = max(128, int((max_x - min_x + 1) * 1.5))
    pad_y = max(128, int((max_y - min_y + 1) * 1.5))
    x0 = max(0, min_x - pad_x)
    y0 = max(0, min_y - pad_y)
    x1 = min(max_x + pad_x, w - 1)
    y1 = min(max_y + pad_y, h - 1)
    cw, ch_ = x1 - x0 + 1, y1 - y0 + 1

    crop = image[:, y0 : y1 + 1, x0 : x1 + 1]
    mcrop = mask[y0 : y1 + 1, x0 : x1 + 1]

    if max(cw, ch_) > MAX_DIM:
        scale = MAX_DIM / max(cw, ch_)
        fw = max(1, round(cw * scale))
        fh = max(1, round(ch_ * scale))
    else:
        fw, fh = cw, ch_

    dim = max(fw, fh)
    dim = ((dim + ALIGN - 1) // ALIGN) * ALIGN

    with exact_fp32():
        img = resize_bilinear(crop, (3, fh, fw))
        mbin = torch.from_numpy((mcrop > 0).astype(np.float32)).to(dev)
        msk = resize_bilinear(mbin, (fh, fw))
        # edge-clamp pad to the aligned square (:855-860 clamps sx/sy)
        img = F.pad(img[None], (0, dim - fw, 0, dim - fh), mode="replicate")
        msk = F.pad(msk[None, None], (0, dim - fw, 0, dim - fh), mode="replicate")
        msk = (msk > 0.0).to(torch.float32)

        out = model(img, msk)[0]  # (3, dim', dim') in [0, 255]
        out = torch.clamp(out, 0.0, 255.0) / 255.0
        out = out[:, :fh, :fw]
        out = resize_bilinear(out, (3, ch_, cw))

        alpha = (torch.from_numpy(mcrop.astype(np.float32)).to(dev) / 255.0)[None]
        blended = out * alpha + crop * (1.0 - alpha)
        result = image.clone()
        result[:, y0 : y1 + 1, x0 : x1 + 1] = blended
    return result


def generate_replace_patch(
    image_planar,
    patch_definition: dict,
    warped_image: np.ndarray | None = None,
    use_fast_inpaint: bool = True,
    connector_url: str | None = None,
    source_path: str = "",
    device="cuda",
) -> dict:
    """Generative-replace command (ai_commands.rs:400-580): rasterize the
    patch's sub-masks to a bitmap, inpaint with LaMa (`use_fast_inpaint`)
    on `device` or through the HTTP connector, and return the aiPatches
    `patchData` payload: {"color": b64 JPEG of the masked result (black
    outside), "mask": b64 JPEG of the mask}, both at source resolution,
    quality 92.
    """
    from rapidraw_tpu_torch import native
    from rapidraw_tpu_torch.masks.rasterize import generate_mask_bitmap

    dev = torch.device(device)
    image = as_image(image_planar, dev)
    _, h, w = image.shape
    mask_def = {
        "visible": patch_definition.get("visible", True),
        "invert": bool(patch_definition.get("invert", False)),
        "opacity": 100.0,
        "subMasks": patch_definition.get("subMasks") or [],
    }
    mask = generate_mask_bitmap(mask_def, w, h, 1.0, (0.0, 0.0), warped_image)
    if mask is None:
        raise ValueError("patch definition produced no mask bitmap")

    if use_fast_inpaint:
        result = run_lama_inpainting(image, mask, dev)
    elif connector_url:
        from rapidraw_tpu_torch.ai.connector import process_inpainting

        rgba = process_inpainting(
            connector_url, source_path, image,
            mask,  # (H, W) gray — the connector encodes it as a grey PNG
            str(patch_definition.get("prompt") or ""),
        )
        rgba = torch.from_numpy(rgba).to(dev)
        a = rgba[3].to(torch.float32) / 255.0
        result = rgba[:3].to(torch.float32) / 255.0 * a + image * (1 - a)
    else:
        raise ValueError(
            "no generative backend configured: pass use_fast_inpaint=True "
            "or a connector_url"
        )

    color = (torch.clamp(result, 0, 1) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    color = np.where(mask[None] > 0, color, 0).astype(np.uint8)  # black outside (:539-550)

    def jpeg_b64(arr):
        return base64.b64encode(native.jpeg_encode(np.ascontiguousarray(arr), 92)).decode()

    return {
        "color": jpeg_b64(color.transpose(1, 2, 0)),
        "mask": jpeg_b64(mask),
    }
