"""Segment-Anything (SAM ViT-B) subject masks.

Port of `rapidraw_tpu/ai/sam.py` (ai_processing.rs:918-1062: 1024-long-side
resize, 2-iteration decoder loop feeding the low-res mask back, final mask
thresholded at 0), from the published architecture (Kirillov et al.,
"Segment Anything", 2023):

  * image encoder: ViT-B/16 — 12 blocks, dim 768, 12 heads, 14x14
    windowed attention with global attention at blocks {2, 5, 8, 11},
    decomposed relative position bias, absolute pos embed, conv neck to
    a (256, 64, 64) embedding;
  * prompt encoder: random-Fourier positional encoding, per-label point
    embeddings (neg / pos / box-corner-1 / box-corner-2), a no-mask
    embedding, and a small conv net for dense (mask) prompts;
  * mask decoder: IoU + 4 mask tokens, a depth-2 two-way transformer
    (token self-attn, token->image and image->token cross-attn with
    128-dim attention downsampling), 4x transposed-conv upscaling, and
    per-token hypernetwork MLPs.

The widths are `SamConfig`'s (the published ones by default); the
attention is JAX's explicit softmax(q . k^T + bias) . v. Weights load
from `sam_vit_b_encoder.npz` / `sam_vit_b_decoder.npz` in the models
directory (ai/masks.py); ModelUnavailable otherwise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rapidraw_tpu_torch.ai.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    Named,
    exact_fp32,
    fp32_forward,
    gelu,
)
from rapidraw_tpu_torch.ai.masks import (
    _load_variables,
    as_image,
    sam_decoder_weights,
    sam_encoder_weights,
)
from rapidraw_tpu_torch.geometry.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class SamConfig:
    input: int = 1024  # encoder square side (ai_processing.rs:25)
    patch: int = 16
    embed: int = 768
    heads: int = 12
    layers: int = 12
    window: int = 14
    global_blocks: tuple = (2, 5, 8, 11)
    prompt_dim: int = 256


SAM = SamConfig()  # what generate_image_embeddings and run_sam_decoder run


class LayerNorm2d(torch.nn.Module):
    """Channel-wise LN over channel axis 1 (SAM's LayerNorm2d, eps 1e-6):
    (x - mu) / sqrt(var + eps) * w + b."""

    def __init__(self, ch):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(ch))
        self.bias = torch.nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        return ((x - mu) / torch.sqrt(var + 1e-6) * self.weight[:, None, None]
                + self.bias[:, None, None])


def _rel_bias(q, rel_h, rel_w, h, w):
    """Decomposed relative position: attn += q·Rh + q·Rw, with the
    (2s-1)-row tables indexed by coordinate difference."""
    dev = q.device
    idx = torch.arange(h, device=dev)[:, None] - torch.arange(h, device=dev)[None, :] + (h - 1)
    Rh = rel_h[idx]  # (h, h, head_dim)
    idxw = torch.arange(w, device=dev)[:, None] - torch.arange(w, device=dev)[None, :] + (w - 1)
    Rw = rel_w[idxw]  # (w, w, head_dim)
    r = q.reshape(*q.shape[:-2], h, w, q.shape[-1])
    bh = torch.einsum("...hwc,hkc->...hwk", r, Rh)
    bw = torch.einsum("...hwc,wkc->...hwk", r, Rw)
    return (bh[..., :, :, :, None] + bw[..., :, None, :]).reshape(*q.shape[:-2], h * w, h * w)


class Attention(torch.nn.Module):
    def __init__(self, c: SamConfig, rel_size: int):
        super().__init__()
        self.heads, self.hd = c.heads, c.embed // c.heads
        self.qkv = Dense(c.embed, 3 * c.embed)
        self.proj = Dense(c.embed, c.embed)
        self.rel_pos_h = torch.nn.Parameter(torch.zeros(2 * rel_size - 1, self.hd))
        self.rel_pos_w = torch.nn.Parameter(torch.zeros(2 * rel_size - 1, self.hd))

    def forward(self, x, h, w):  # (B, N=h*w, C)
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, self.hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
        attn = (q * self.hd ** -0.5) @ k.transpose(-1, -2)
        attn = attn + _rel_bias(q, self.rel_pos_h[: 2 * h - 1], self.rel_pos_w[: 2 * w - 1], h, w)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Block(torch.nn.Module):
    def __init__(self, c: SamConfig, windowed: bool):
        super().__init__()
        self.c, self.windowed = c, windowed
        g = c.input // c.patch
        self.norm1 = LayerNorm(c.embed)
        self.attn = Attention(c, min(c.window, g) if windowed else g)
        self.norm2 = LayerNorm(c.embed)
        self.mlp_lin1 = Dense(c.embed, 4 * c.embed)
        self.mlp_lin2 = Dense(4 * c.embed, c.embed)

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        shortcut = x
        x = self.norm1(x)
        if self.windowed:
            ws = min(self.c.window, max(H, W))
            ph, pw = (-H) % ws, (-W) % ws
            xp = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            win = xp.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
            win = win.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
            win = self.attn(win, ws, ws)
            win = win.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
            xp = win.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
            x = xp[:, :H, :W]
        else:
            x = self.attn(x.reshape(B, H * W, C), H, W).reshape(B, H, W, C)
        x = shortcut + x
        h = self.mlp_lin2(gelu(self.mlp_lin1(self.norm2(x))))
        return x + h


class SamEncoder(torch.nn.Module):
    """(B, 3, S, S) normalized pixels -> (B, S/16, S/16, 256) embeddings."""

    def __init__(self, config: SamConfig = SAM):
        super().__init__()
        c = self.config = config
        g = c.input // c.patch
        self.patch_embed = Conv(3, c.embed, c.patch, stride=c.patch)
        self.pos_embed = torch.nn.Parameter(torch.zeros(1, g, g, c.embed))
        for i in range(c.layers):
            self.add_module(f"block{i}", Block(c, windowed=i not in c.global_blocks))
        self.neck0 = Conv(c.embed, c.prompt_dim, 1, bias=False)
        self.neck1 = LayerNorm2d(c.prompt_dim)
        self.neck2 = Conv(c.prompt_dim, c.prompt_dim, 3, padding=1, bias=False)
        self.neck3 = LayerNorm2d(c.prompt_dim)

    @fp32_forward
    def forward(self, x):
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for i in range(self.config.layers):
            x = getattr(self, f"block{i}")(x)
        x = x.permute(0, 3, 1, 2)
        x = self.neck3(self.neck2(self.neck1(self.neck0(x))))
        return x.permute(0, 2, 3, 1)


class DecoderAttention(torch.nn.Module):
    """Plain multi-head attention with optional internal downsampling
    (the two-way transformer's 128-dim cross-attention)."""

    def __init__(self, dim, heads, down=1):
        super().__init__()
        inner = dim // down
        self.heads, self.inner, self.hd = heads, inner, inner // heads
        self.q = Dense(dim, inner)
        self.k = Dense(dim, inner)
        self.v = Dense(dim, inner)
        self.out = Dense(inner, dim)

    def _split(self, t):
        return t.reshape(*t.shape[:-1], self.heads, self.hd).transpose(-2, -3)

    def forward(self, q, k, v):
        qh, kh, vh = self._split(self.q(q)), self._split(self.k(k)), self._split(self.v(v))
        attn = torch.softmax((qh * self.hd ** -0.5) @ kh.transpose(-1, -2), -1)
        out = (attn @ vh).transpose(-2, -3)
        return self.out(out.reshape(*out.shape[:-2], self.inner))


class TwoWayBlock(torch.nn.Module):
    def __init__(self, dim, skip_first_pe):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention(dim, 8)
        self.norm1 = LayerNorm(dim)
        self.cross_t2i = DecoderAttention(dim, 8, 2)
        self.norm2 = LayerNorm(dim)
        self.mlp_lin1 = Dense(dim, 2048)
        self.mlp_lin2 = Dense(2048, dim)
        self.norm3 = LayerNorm(dim)
        self.cross_i2t = DecoderAttention(dim, 8, 2)
        self.norm4 = LayerNorm(dim)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_t2i(q, k, keys)
        queries = self.norm2(queries)
        h = self.mlp_lin1(queries)
        queries = queries + self.mlp_lin2(torch.relu(h))
        queries = self.norm3(queries)
        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_i2t(k, q, queries)
        keys = self.norm4(keys)
        return queries, keys


class MLP3(torch.nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.lin0 = Dense(dim, dim)
        self.lin1 = Dense(dim, dim)
        self.lin2 = Dense(dim, out)

    def forward(self, x):
        x = torch.relu(self.lin0(x))
        x = torch.relu(self.lin1(x))
        return self.lin2(x)


class SamDecoder(Named):
    """Prompt encoder + mask decoder.

    Inputs:
      emb        (B, g, g, 256)  image embedding from SamEncoder
      coords     (B, P, 2)       prompt points in SAM input pixel space
      labels     (B, P)          -1 pad / 0 neg / 1 pos / 2,3 box corners
      mask_in    (B, 4g, 4g, 1)  previous low-res mask logits
      has_mask   ()              0.0 or 1.0
    Returns (masks (B, 4, 4g, 4g) logits, iou (B, 4)).
    """

    def __init__(self, config: SamConfig = SAM):
        super().__init__()
        c = self.config = config
        d = c.prompt_dim
        self.pe_gaussian = torch.nn.Parameter(torch.zeros(2, d // 2))
        self.point_embeddings = torch.nn.Parameter(torch.zeros(4, d))
        self.not_a_point_embed = torch.nn.Parameter(torch.zeros(d))
        self.no_mask_embed = torch.nn.Parameter(torch.zeros(d))
        self.mask_down0 = Conv(1, 4, 2, stride=2)
        self.mask_ln0 = LayerNorm2d(4)
        self.mask_down1 = Conv(4, 16, 2, stride=2)
        self.mask_ln1 = LayerNorm2d(16)
        self.mask_down2 = Conv(16, d, 1)
        self.iou_token = torch.nn.Parameter(torch.zeros(1, d))
        self.mask_tokens = torch.nn.Parameter(torch.zeros(4, d))
        self.layer0 = TwoWayBlock(d, skip_first_pe=True)
        self.layer1 = TwoWayBlock(d, skip_first_pe=False)
        self.final_t2i = DecoderAttention(d, 8, 2)
        self.final_norm = LayerNorm(d)
        self.iou_head = MLP3(d, 4)
        self.upscale0 = ConvTranspose(d, d // 4, 2, 2)
        self.upscale_ln = LayerNorm2d(d // 4)
        self.upscale1 = ConvTranspose(d // 4, d // 8, 2, 2)
        for i in range(4):
            self.add_module(f"hyper{i}", MLP3(d, d // 8))

    def _pe_encode(self, c):  # c in [0,1] -> (..., 256)
        proj = (2.0 * c - 1.0) @ self.pe_gaussian * (2.0 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)

    @fp32_forward
    def forward(self, emb, coords, labels, mask_in, has_mask):
        c = self.config
        d = c.prompt_dim
        B, g = emb.shape[0], emb.shape[1]
        dev = emb.device

        # --- prompt encoder ---
        gy = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack(torch.meshgrid(gy, gy, indexing="ij"), -1).flip(-1)  # (x, y)
        image_pe = self._pe_encode(grid)[None]  # (1, g, g, 256)

        cc = (coords + 0.5) / float(c.input)
        sparse = self._pe_encode(cc)  # (B, P, 256)
        lab = labels[..., None]
        sparse = torch.where(lab == -1, self.not_a_point_embed, sparse)
        for i in range(4):
            sparse = sparse + torch.where(lab == i, self.point_embeddings[i],
                                          torch.zeros((), device=dev))

        m = self.mask_down0(mask_in.permute(0, 3, 1, 2))
        m = gelu(self.mask_ln0(m))
        m = self.mask_down1(m)
        m = gelu(self.mask_ln1(m))
        m = self.mask_down2(m).permute(0, 2, 3, 1)
        dense = has_mask * m + (1.0 - has_mask) * self.no_mask_embed

        # --- mask decoder ---
        tokens = torch.cat([self.iou_token.expand(B, 1, d), self.mask_tokens.expand(B, 4, d),
                            sparse], dim=1)
        src = (emb + dense).reshape(B, g * g, d)
        pos_src = image_pe.reshape(1, g * g, d).expand(src.shape)
        q, k = tokens, src
        q, k = self.layer0(q, k, tokens, pos_src)
        q, k = self.layer1(q, k, tokens, pos_src)
        q = q + self.final_t2i(q + tokens, k + pos_src, k)
        q = self.final_norm(q)

        iou_out = self.iou_head(q[:, 0])
        mtok = q[:, 1:5]  # (B, 4, 256)

        up = k.reshape(B, g, g, d).permute(0, 3, 1, 2)
        up = gelu(self.upscale_ln(self.upscale0(up)))
        up = gelu(self.upscale1(up))  # (B, 32, 4g, 4g)

        hyper = torch.stack([getattr(self, f"hyper{i}")(mtok[:, i]) for i in range(4)], dim=1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper, up)
        return masks, iou_out


@dataclass
class ImageEmbeddings:
    """Mirror of ai_processing.rs ImageEmbeddings: the cached encoder
    output keyed by image, reused across decoder clicks."""

    embeddings: torch.Tensor  # (1, g, g, 256) NHWC, on the encoder's device
    original_size: tuple  # (width, height)


_PIXEL_MEAN = (123.675, 116.28, 103.53)
_PIXEL_STD = (58.395, 57.12, 57.375)


def generate_image_embeddings(image, device="cuda") -> ImageEmbeddings:
    """Encode planar (3, H, W) f32 [0,1] -> cached SAM embeddings.

    Matches generate_image_embeddings (ai_processing.rs:918-960): resize so
    the long side is the input side, zero-pad bottom/right to the square,
    then the standard SAM pixel normalization (x*255 minus ImageNet
    mean/std in pixel units).
    """
    dev = torch.device(device)
    config = SAM
    model = _load_variables("sam_vit_b_encoder.npz", "SAM ViT-B encoder",
                            lambda f: sam_encoder_weights(f, config), dev, config)
    S = config.input
    with exact_fp32():
        x = as_image(image, dev)[None]
        _, _, h, w = x.shape
        scale = S / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        x = resize_bilinear(x, (1, 3, nh, nw))
        x = torch.nn.functional.pad(x, (0, S - nw, 0, S - nh))
        x = x.permute(0, 2, 3, 1) * 255.0
        mean = torch.tensor(_PIXEL_MEAN, device=dev)
        std = torch.tensor(_PIXEL_STD, device=dev)
        emb = model(((x - mean) / std).permute(0, 3, 1, 2))
    return ImageEmbeddings(embeddings=emb, original_size=(w, h))


def sam_mask_logits(
    emb: ImageEmbeddings,
    start_point: tuple,
    end_point: tuple,
    iters: int = 2,
) -> tuple[torch.Tensor, list]:
    """The decoder loop of run_sam_decoder up to its threshold: the picked
    mask's logits at the original size (H, W) on the embeddings' device,
    and the IoU token picked at each iteration."""
    e = emb.embeddings
    if not isinstance(e, torch.Tensor):
        e = torch.from_numpy(np.ascontiguousarray(e, dtype=np.float32))
    dev = e.device
    config = SAM
    model = _load_variables("sam_vit_b_decoder.npz", "SAM ViT-B decoder",
                            lambda f: sam_decoder_weights(f, config), dev, config)
    S = config.input
    w, h = emb.original_size
    scale = S / max(h, w)

    sx, sy = start_point
    ex, ey = end_point
    if abs(sx - ex) < 1e-6 and abs(sy - ey) < 1e-6:
        coords = [(sx * scale, sy * scale), (0.0, 0.0)]
        labels = [1.0, -1.0]  # pad point, per the published ONNX contract
    else:
        x1, x2 = sorted((sx * scale, ex * scale))
        y1, y2 = sorted((sy * scale, ey * scale))
        coords = [(x1, y1), (x2, y2)]
        labels = [2.0, 3.0]

    picks = []
    with exact_fp32():
        g = e.shape[1]
        coords_a = torch.tensor([coords], dtype=torch.float32, device=dev)
        labels_a = torch.tensor([labels], dtype=torch.float32, device=dev)
        mask_in = torch.zeros((1, 4 * g, 4 * g, 1), dtype=torch.float32, device=dev)
        has_mask = torch.tensor(0.0, device=dev)
        best = None
        for _ in range(max(1, iters)):
            masks, iou = model(e, coords_a, labels_a, mask_in, has_mask)
            # multimask tokens are 1..3; token 0 is the single-mask output
            pick = 1 + torch.argmax(iou[0, 1:])
            picks.append(pick)
            best = masks[0, pick]
            mask_in = best[None, :, :, None]
            has_mask = torch.tensor(1.0, device=dev)

        # low-res logits -> SAM square -> un-pad -> original size (the ONNX
        # model's mask_postprocessing)
        full = resize_bilinear(best, (S, S))
        nh, nw = round(h * scale), round(w * scale)
        full = resize_bilinear(full[:nh, :nw], (h, w))
    return full, [int(p) for p in picks]


def run_sam_decoder(
    emb: ImageEmbeddings,
    start_point: tuple,
    end_point: tuple,
    iters: int = 2,
) -> np.ndarray:
    """Click/drag prompt -> (H, W) u8 {0,255} mask, on the embeddings' device.

    Mirrors run_sam_decoder (ai_processing.rs:962-1062): a degenerate drag
    is a single positive point, otherwise the two corners become box
    prompts (labels 2/3); the decoder runs `iters` times feeding the
    low-res mask logits back (has_mask=1 after the first pass); the final
    mask is thresholded at 0 and resized to the original image.
    """
    full, _ = sam_mask_logits(emb, start_point, end_point, iters)
    return (full > 0.0).to(torch.uint8).cpu().numpy() * 255


def unproject_prompt_rect(
    start_point: tuple,
    end_point: tuple,
    img_w: float,
    img_h: float,
    rotation: float = 0.0,
    flip_horizontal: bool = False,
    flip_vertical: bool = False,
    orientation_steps: int = 0,
) -> tuple:
    """Map a prompt rectangle from TRANSFORMED display space back to the
    un-transformed image the embeddings were computed on — the corner
    un-rotate / un-flip / un-coarse-rotate + bbox of
    generate_ai_subject_mask (ai_commands.rs:248-317). Returns
    ((min_x, min_y), (max_x, max_y))."""
    if orientation_steps % 2 == 1:
        crw, crh = float(img_h), float(img_w)
    else:
        crw, crh = float(img_w), float(img_h)
    cx, cy = crw / 2.0, crh / 2.0
    a = np.radians(rotation)
    ca, sa = np.cos(a), np.sin(a)

    corners = [
        start_point,
        (start_point[0], end_point[1]),
        end_point,
        (end_point[0], start_point[1]),
    ]

    out = []
    for px, py in corners:
        dx, dy = px - cx, py - cy
        ux = dx * ca + dy * sa + cx
        uy = -dx * sa + dy * ca + cy
        if flip_horizontal:
            ux = crw - ux
        if flip_vertical:
            uy = crh - uy
        if orientation_steps == 1:
            ux, uy = uy, img_h - ux
        elif orientation_steps == 2:
            ux, uy = img_w - ux, img_h - uy
        elif orientation_steps == 3:
            ux, uy = img_w - uy, ux
        out.append((ux, uy))

    xs = [p[0] for p in out]
    ys = [p[1] for p in out]
    return (min(xs), min(ys)), (max(xs), max(ys))
