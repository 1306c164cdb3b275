"""Monocular depth estimation: Depth-Anything-v2 ViT-S (DINOv2 + DPT).

Port of `rapidraw_tpu/ai/depth.py` (ai_processing.rs:1355-1510): the
relative-depth map behind the depth band-pass mask
(masks/parametric.generate_ai_depth). Weights load from
depth_anything_v2_vits.npz in the models directory (ai/masks.py);
ModelUnavailable otherwise.

Structure (Yang et al., "Depth Anything V2", 2024; backbone DINOv2 ViT-S):
  * patch-14 embedding, cls token, learned position embeddings, 12
    transformer blocks (6 heads, dim 384, LayerScale), features tapped
    after blocks (2, 5, 8, 11), each tap normalized by the backbone's ONE
    shared final LayerNorm;
  * DPT reassemble: per-tap 1x1 projection to (48, 96, 192, 384) channels
    then a learned resample — ConvTranspose k4/s4, ConvTranspose k2/s2,
    identity, Conv k3/s2/p1 — followed by a bias-free 3x3 to the fusion
    width (64);
  * refinenet fusion with pre-activation residual units, upsampling to the
    next tap's grid with align_corners=True bilinear, 1x1 projection;
  * head: 3x3 conv to 32, align-corners upsample to patch_grid*14, 3x3
    conv + ReLU, 1x1 conv + ReLU; min-max normalized to [0, 1].
The attention is flax's `MultiHeadDotProductAttention` as written:
softmax(q / sqrt(d) . k^T) . v.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rapidraw_tpu_torch.ai.layers import (
    Conv,
    ConvTranspose,
    Dense,
    DenseGeneral,
    LayerNorm,
    Named,
    exact_fp32,
    fp32_forward,
    gelu,
)
from rapidraw_tpu_torch.ai.masks import _load_variables, as_image, depth_weights
from rapidraw_tpu_torch.geometry.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    input: int = 518  # 37 * 14: Depth-Anything-v2 default inference size
    embed: int = 384
    heads: int = 6
    layers: int = 12
    taps: tuple = (2, 5, 8, 11)
    dpt_feat: int = 64
    dpt_ch: tuple = (48, 96, 192, 384)


DEPTH = DepthConfig()  # what generate_depth_map runs


@functools.lru_cache(maxsize=32)
def _ac_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix with align_corners=True
    semantics (torch F.interpolate(..., align_corners=True)): output i
    samples input at i*(n_in-1)/(n_out-1)."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        A[:, 0] = 1.0
        return A
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    f = pos - i0
    A[np.arange(n_out), i0] = (1.0 - f).astype(np.float32)
    A[np.arange(n_out), i0 + 1] += f.astype(np.float32)
    return A


def _resize_ac(x, nh: int, nw: int):
    """NCHW bilinear resize with align_corners=True, as two small matmuls
    (JAX's einsums over H, then over W)."""
    _, _, h, w = x.shape
    if (h, w) == (nh, nw):
        return x
    Ah = torch.from_numpy(_ac_weights(h, nh)).to(x.device, x.dtype)
    Aw = torch.from_numpy(_ac_weights(w, nw)).to(x.device, x.dtype)
    x = torch.einsum("oh,bchw->bcow", Ah, x)
    return torch.einsum("ow,bchw->bcho", Aw, x)


class MultiHeadDotProductAttention(Named):
    """flax's self-attention with DenseGeneral q/k/v/out projections."""

    def __init__(self, dim, heads):
        super().__init__()
        hd = dim // heads
        self.heads, self.hd = heads, hd
        self.query = DenseGeneral((dim,), (heads, hd))
        self.key = DenseGeneral((dim,), (heads, hd))
        self.value = DenseGeneral((dim,), (heads, hd))
        self.out = DenseGeneral((heads, hd), (dim,))

    def forward(self, x):  # (B, N, C)
        B, N, _ = x.shape
        q = self.query(x).reshape(B, N, self.heads, self.hd)
        k = self.key(x).reshape(B, N, self.heads, self.hd)
        v = self.value(x).reshape(B, N, self.heads, self.hd)
        q = q / torch.sqrt(torch.tensor(float(self.hd), dtype=q.dtype))
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(out.reshape(B, N, self.heads * self.hd))


class Block(Named):
    def __init__(self, c: DepthConfig):
        super().__init__()
        e = c.embed
        self.auto("LayerNorm", LayerNorm(e))
        self.auto("MultiHeadDotProductAttention", MultiHeadDotProductAttention(e, c.heads))
        self.ls1 = torch.nn.Parameter(torch.ones(e))
        self.auto("LayerNorm", LayerNorm(e))
        self.auto("Dense", Dense(e, 4 * e))
        self.auto("Dense", Dense(4 * e, e))
        self.ls2 = torch.nn.Parameter(torch.ones(e))

    def forward(self, x):
        h = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        x = x + h * self.ls1
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + h * self.ls2


class ResidualUnit(Named):
    """DPT pre-activation residual conv unit: relu-conv-relu-conv + x."""

    def __init__(self, f):
        super().__init__()
        self.conv1 = Conv(f, f, 3)
        self.conv2 = Conv(f, f, 3)

    def forward(self, x):
        r = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return x + r


class FeatureFusion(Named):
    """DPT refinenet block: optional skip through residual unit 1, residual
    unit 2, align-corners upsample to `out_size` (or 2x), 1x1 projection."""

    def __init__(self, f, skip: bool):
        super().__init__()
        if skip:
            self.rcu1 = ResidualUnit(f)
        self.rcu2 = ResidualUnit(f)
        self.project = Conv(f, f, 1)

    def forward(self, x, skip=None, out_size=None):
        if skip is not None:
            if x.shape[2:] != skip.shape[2:]:
                # the reference resizes the RESIDUAL onto the fused grid
                # (align_corners=False) on mismatch
                skip = resize_bilinear(skip, (skip.shape[0], skip.shape[1], x.shape[2],
                                              x.shape[3]))
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        nh, nw = out_size if out_size is not None else (x.shape[2] * 2, x.shape[3] * 2)
        x = _resize_ac(x, nh, nw)
        return self.project(x)


class DepthAnythingV2S(Named):
    """(B, 3, H, W) normalized pixels, H = W = input -> (B, H, W) depth."""

    def __init__(self, config: DepthConfig = DEPTH):
        super().__init__()
        c = self.config = config
        e, f = c.embed, c.dpt_feat
        self.patch_embed = Conv(3, e, 14, stride=14)
        g = c.input // 14
        self.cls_token = torch.nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = torch.nn.Parameter(torch.zeros(1, g * g + 1, e))
        self.norm = LayerNorm(e)
        for i in range(c.layers):
            self.add_module(f"block{i}", Block(c))
        for i, ch in enumerate(c.dpt_ch):
            self.add_module(f"proj{i}", Conv(e, ch, 1))
            if i == 0:
                self.auto("ConvTranspose", ConvTranspose(ch, ch, 4, 4))
            elif i == 1:
                self.auto("ConvTranspose", ConvTranspose(ch, ch, 2, 2))
            elif i == 3:
                self.resize3 = Conv(ch, ch, 3, stride=2, padding=1)
            self.add_module(f"layer_rn{i}", Conv(ch, f, 3, bias=False))
        self.fusion4 = FeatureFusion(f, skip=False)
        self.fusion3 = FeatureFusion(f, skip=True)
        self.fusion2 = FeatureFusion(f, skip=True)
        self.fusion1 = FeatureFusion(f, skip=True)
        self.head1 = Conv(f, f // 2, 3)
        self.head2 = Conv(f // 2, 32, 3)
        self.head3 = Conv(32, 1, 1)

    @fp32_forward
    def forward(self, x):
        c = self.config
        B, _, H, W = x.shape
        gh, gw = H // 14, W // 14
        t = self.patch_embed(x).permute(0, 2, 3, 1).reshape(B, gh * gw, c.embed)
        t = torch.cat([self.cls_token.expand(B, 1, c.embed), t], 1) + self.pos_embed
        feats = []
        for i in range(c.layers):
            t = getattr(self, f"block{i}")(t)
            if i in c.taps:
                feats.append(self.norm(t))
        pyramid = []
        for i, f in enumerate(feats):
            g = f[:, 1:, :].reshape(B, gh, gw, c.embed).permute(0, 3, 1, 2)
            g = getattr(self, f"proj{i}")(g)
            if i == 0:
                g = self.ConvTranspose_0(g)
            elif i == 1:
                g = self.ConvTranspose_1(g)
            elif i == 3:
                g = self.resize3(g)
            pyramid.append(getattr(self, f"layer_rn{i}")(g))
        p1, p2, p3, p4 = pyramid  # 4x, 2x, 1x, 0.5x of the 1/14 grid
        y = self.fusion4(p4, out_size=p3.shape[2:])
        y = self.fusion3(y, p3, out_size=p2.shape[2:])
        y = self.fusion2(y, p2, out_size=p1.shape[2:])
        y = self.fusion1(y, p1)  # final: plain 2x
        y = self.head1(y)
        y = _resize_ac(y, gh * 14, gw * 14)
        y = torch.relu(self.head2(y))
        y = torch.relu(self.head3(y))
        return y[:, 0]


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def generate_depth_map(image, device="cuda") -> np.ndarray:
    """Relative depth for planar (3, H, W) f32 [0,1] -> (H, W) u8 where 255
    is NEAR (matching the band-pass semantics in generate_ai_depth)."""
    dev = torch.device(device)
    config = DEPTH
    model = _load_variables("depth_anything_v2_vits.npz", "Depth-Anything-v2-ViT-S",
                            lambda f: depth_weights(f, config), dev, config)
    with exact_fp32():
        x = as_image(image, dev)[None]
        _, _, h, w = x.shape
        x = resize_bilinear(x, (1, 3, config.input, config.input)).permute(0, 2, 3, 1)
        mean = torch.tensor(_MEAN, device=dev)
        std = torch.tensor(_STD, device=dev)
        x = (x - mean) / std
        depth = model(x.permute(0, 3, 1, 2))[0]
        depth = resize_bilinear(depth, (h, w))
        lo, hi = torch.min(depth), torch.max(depth)
        depth = (depth - lo) / torch.clamp(hi - lo, min=1e-6)
        return torch.clamp(depth * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
