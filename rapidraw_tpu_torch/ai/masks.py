"""AI mask inference: U2-Net saliency (foreground and sky), the flat-npz
weights loader with the carry-over of each network's weights, the
precompute of an editor's AI sub-masks and the euclidean-distance mask ops.

Port of `rapidraw_tpu/ai/masks.py` (ai_processing.rs: U2-Net foreground
:1274, skyseg :1193, EDT mask ops :97-164). The networks run on `device`
(the CUDA device unless the caller asks for another) in float32 with TF32
off; the weights are the JAX package's flat npz files in the same
directory (RAPIDRAW_MODELS, then RAPIDRAW_MODELS_DIR, then
~/.cache/rapidraw_tpu/models), and a missing file raises the same
ModelUnavailable. The produced masks become base64 PNG data URLs
(`mask_to_data_url`, the port's PNG writer: other bytes than PIL's, the
same decoded mask) that masks/parametric.generate_ai_mask reads.

U2-Net (Qin et al., "U2-Net: Going Deeper with Nested U-Structure for
Salient Object Detection", Pattern Recognition 2020): six RSU encoder stages, five RSU
decoder stages, six side outputs fused by a 1x1 conv.
"""

from __future__ import annotations

import base64
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from rapidraw_tpu_torch.ai.layers import (
    BatchNorm,
    Conv,
    Named,
    exact_fp32,
    fp32_forward,
    load_flat,
    max_pool_same,
)
from rapidraw_tpu_torch.ai.models import ModelUnavailable
from rapidraw_tpu_torch.geometry.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class U2NetConfig:
    """U2-Net's widths and input side: `small` gives u2netp's channels."""

    small: bool = False
    input: int = 320  # ai_processing.rs U2-Net preprocessing size

    @property
    def mids(self):
        if self.small:
            return [16] * 11
        return [32, 32, 64, 128, 256, 256, 256, 128, 64, 32, 16]

    @property
    def outs(self):
        if self.small:
            return [64] * 11
        return [64, 128, 256, 512, 512, 512, 512, 256, 128, 64, 64]


U2NET = U2NetConfig()  # what generate_foreground_mask and generate_sky_mask run


def as_image(image, device) -> torch.Tensor:
    """Planar (3, H, W) float32 on `device` from a NumPy array or a tensor."""
    if isinstance(image, torch.Tensor):
        return image.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32)).to(device)


# ------------------------------------------------------------- U2-Net
class REBNCONV(Named):
    def __init__(self, cin, cout, dirate=1):
        super().__init__()
        self.auto("Conv", Conv(cin, cout, 3, padding=dirate, dilation=dirate))
        self.auto("BatchNorm", BatchNorm(cout))

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


def upsample_to(x, ref):
    return resize_bilinear(x, (x.shape[0], x.shape[1], ref.shape[2], ref.shape[3]))


class RSU(Named):
    """RSU-L: height-L nested U-block."""

    def __init__(self, height, cin, mid, out):
        super().__init__()
        self.height = height
        c = [self.auto("REBNCONV", REBNCONV(cin, out)), self.auto("REBNCONV", REBNCONV(out, mid))]
        for _ in range(height - 2):
            c.append(self.auto("REBNCONV", REBNCONV(mid, mid)))
        c.append(self.auto("REBNCONV", REBNCONV(mid, mid, dirate=2)))
        for _ in range(height - 2):
            c.append(self.auto("REBNCONV", REBNCONV(2 * mid, mid)))
        c.append(self.auto("REBNCONV", REBNCONV(2 * mid, out)))
        self._convs = c

    def forward(self, x):
        c = iter(self._convs)
        hxin = next(c)(x)
        enc = [next(c)(hxin)]
        h = enc[0]
        for _ in range(self.height - 2):
            h = next(c)(max_pool_same(h))
            enc.append(h)
        d = next(c)(h)
        for i in range(self.height - 2, 0, -1):
            d = next(c)(torch.cat([d, enc[i]], 1))
            d = upsample_to(d, enc[i - 1])
        d = next(c)(torch.cat([d, enc[0]], 1))
        return d + hxin


class RSU4F(Named):
    """Dilated RSU (no pooling)."""

    def __init__(self, cin, mid, out):
        super().__init__()
        specs = [(cin, out, 1), (out, mid, 1), (mid, mid, 2), (mid, mid, 4), (mid, mid, 8),
                 (2 * mid, mid, 4), (2 * mid, mid, 2), (2 * mid, out, 1)]
        self._convs = [self.auto("REBNCONV", REBNCONV(a, b, d)) for a, b, d in specs]

    def forward(self, x):
        c = self._convs
        hxin = c[0](x)
        h1 = c[1](hxin)
        h2 = c[2](h1)
        h3 = c[3](h2)
        h4 = c[4](h3)
        d3 = c[5](torch.cat([h4, h3], 1))
        d2 = c[6](torch.cat([d3, h2], 1))
        d1 = c[7](torch.cat([d2, h1], 1))
        return d1 + hxin


class U2Net(Named):
    """Full U2-Net: (B, 3, H, W) normalized pixels -> (B, 1, H, W) sigmoid."""

    def __init__(self, config: U2NetConfig = U2NET):
        super().__init__()
        m, o = config.mids, config.outs
        self.e = [self.auto("RSU", RSU(7, 3, m[0], o[0])),
                  self.auto("RSU", RSU(6, o[0], m[1], o[1])),
                  self.auto("RSU", RSU(5, o[1], m[2], o[2])),
                  self.auto("RSU", RSU(4, o[2], m[3], o[3])),
                  self.auto("RSU4F", RSU4F(o[3], m[4], o[4])),
                  self.auto("RSU4F", RSU4F(o[4], m[5], o[5]))]
        self.d = [self.auto("RSU4F", RSU4F(o[5] + o[4], m[6], o[6])),
                  self.auto("RSU", RSU(4, o[6] + o[3], m[7], o[7])),
                  self.auto("RSU", RSU(5, o[7] + o[2], m[8], o[8])),
                  self.auto("RSU", RSU(6, o[8] + o[1], m[9], o[9])),
                  self.auto("RSU", RSU(7, o[9] + o[0], m[10], o[10]))]
        side_in = (o[10], o[9], o[8], o[7], o[6], o[5])
        self.sides = [self.auto("Conv", Conv(c, 1, 3, padding=1)) for c in side_in]
        self.auto("Conv", Conv(6, 1, 1))

    @fp32_forward
    def forward(self, x):
        e1 = self.e[0](x)
        e2 = self.e[1](max_pool_same(e1))
        e3 = self.e[2](max_pool_same(e2))
        e4 = self.e[3](max_pool_same(e3))
        e5 = self.e[4](max_pool_same(e4))
        e6 = self.e[5](max_pool_same(e5))
        d5 = self.d[0](torch.cat([upsample_to(e6, e5), e5], 1))
        d4 = self.d[1](torch.cat([upsample_to(d5, e4), e4], 1))
        d3 = self.d[2](torch.cat([upsample_to(d4, e3), e3], 1))
        d2 = self.d[3](torch.cat([upsample_to(d3, e2), e2], 1))
        d1 = self.d[4](torch.cat([upsample_to(d2, e1), e1], 1))
        sides = [upsample_to(conv(d), d1)
                 for conv, d in zip(self.sides, (d1, d2, d3, d4, d5, e6))]
        return torch.sigmoid(self.Conv_6(torch.cat(sides, 1)))


# ----------------------------------------------------- weights and carry-over
def _models_dir() -> Path:
    return Path(
        os.environ.get(
            "RAPIDRAW_MODELS",
            os.environ.get(
                "RAPIDRAW_MODELS_DIR",
                str(Path.home() / ".cache" / "rapidraw_tpu" / "models"),
            ),
        )
    )


_weights_cache: dict = {}


def _load_variables(filename: str, model_name: str, build, device, config=None):
    """The network `build(flat)` makes from a flat npz, on `device`.

    Cached in an LRU of five entries keyed by the file's (path, mtime), and
    by the device and widths it was built for: interactive masking calls
    inference per click, and re-reading a ~170 MB npz each time dwarfs the
    forward pass (the AiState session cache, ai_processing.rs:88-95)."""
    p = _models_dir() / filename
    if not p.exists():
        raise ModelUnavailable(
            f"{model_name} weights not found at {p}. This build has no "
            "network egress; convert the published checkpoint to a flat npz "
            "and place it there, or set RAPIDRAW_MODELS_DIR."
        )
    key = (str(p), p.stat().st_mtime_ns, str(torch.device(device)), config)
    hit = _weights_cache.get(key)
    if hit is not None:
        # LRU, not FIFO: a batch cycling through SAM enc+dec plus
        # fg/sky/depth (5 weight sets) must not evict the still-hot
        # entry it is about to reuse on the next image
        _weights_cache[key] = _weights_cache.pop(key)
        return hit
    with np.load(p) as z:
        flat = {k: z[k] for k in z.files}
    model = build(flat).to(device).eval()
    if len(_weights_cache) >= 5:  # bound device memory (all five mask nets)
        _weights_cache.pop(next(iter(_weights_cache)))
    _weights_cache[key] = model
    return model


def save_variables_npz(variables, path) -> None:
    """Flatten a flax variables tree to the flat npz layout _load_variables
    reads ('params/.../kernel' keys) — the conversion target for published
    checkpoints."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    walk(variables, "")
    np.savez(path, **flat)


# One function per network: the flat npz (flax layout: HWIO conv kernels,
# (in, out) dense kernels, (kh, kw, in, out) transposed-conv kernels,
# BatchNorm running statistics under batch_stats/) -> the module with every
# tensor filled; each raises on a key it leaves or a tensor it cannot fill.
def u2net_weights(flat: dict, config: U2NetConfig = U2NET) -> U2Net:
    return load_flat(U2Net(config), flat, "U2-Net")


def depth_weights(flat: dict, config=None):
    from rapidraw_tpu_torch.ai import depth

    return load_flat(depth.DepthAnythingV2S(config or depth.DEPTH), flat,
                     "Depth-Anything-v2-ViT-S")


def sam_encoder_weights(flat: dict, config=None):
    from rapidraw_tpu_torch.ai import sam

    return load_flat(sam.SamEncoder(config or sam.SAM), flat, "SAM ViT-B encoder")


def sam_decoder_weights(flat: dict, config=None):
    from rapidraw_tpu_torch.ai import sam

    return load_flat(sam.SamDecoder(config or sam.SAM), flat, "SAM ViT-B decoder")


def utnet_weights(flat: dict, config=None):
    from rapidraw_tpu_torch.ai import denoise

    # both layouts: bare param paths ('Conv_0/kernel') or the full
    # variables tree ('params/Conv_0/kernel', the converter-tool output)
    if not any(k.startswith("params/") for k in flat):
        flat = {f"params/{k}": v for k, v in flat.items()}
    return load_flat(denoise.UtNet(config or denoise.UTNET), flat, "NIND UtNet")


def lama_weights(flat: dict, config=None):
    from rapidraw_tpu_torch.ai import inpaint

    return load_flat(inpaint.LamaGenerator(config or inpaint.LAMA), flat, "LaMa")


# ------------------------------------------------------------- saliency
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _saliency(image, weights_file: str, device, config: U2NetConfig) -> np.ndarray:
    """Run U2-Net on planar (3, H, W) float32 [0,1]; returns (H, W) u8.

    Preprocessing matches the reference (ai_processing.rs U2-Net path):
    resize to the input side, normalize by max then ImageNet mean/std; the
    fused sigmoid output is min-max normalized and scaled to u8 at full res.
    """
    dev = torch.device(device)
    model = _load_variables(weights_file, "U2-Net", lambda f: u2net_weights(f, config), dev,
                            config)
    with exact_fp32():
        x = as_image(image, dev)[None]
        _, _, h, w = x.shape
        x = resize_bilinear(x, (1, 3, config.input, config.input)).permute(0, 2, 3, 1)
        mx = torch.clamp(torch.max(x), min=1e-6)
        mean = torch.tensor(_MEAN, device=dev)
        std = torch.tensor(_STD, device=dev)
        x = (x / mx - mean) / std
        pred = model(x.permute(0, 3, 1, 2))[0, 0]
        pred = resize_bilinear(pred, (h, w))
        lo, hi = torch.min(pred), torch.max(pred)
        pred = (pred - lo) / torch.clamp(hi - lo, min=1e-6)
        return torch.clamp(pred * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


def generate_foreground_mask(image, device="cuda") -> np.ndarray:
    """U2-Net foreground saliency (ai_processing.rs:1274-1354). (H, W) u8."""
    return _saliency(image, "u2net.npz", device, U2NET)


def generate_sky_mask(image, device="cuda") -> np.ndarray:
    """Sky segmentation with the skyseg U2-Net (ai_processing.rs:1193-1272)."""
    return _saliency(image, "skyseg.npz", device, U2NET)


def mask_to_data_url(mask: np.ndarray) -> str:
    """Encode an (H, W) u8 mask as the base64 PNG data URL the adjustment
    schema carries (maskDataBase64), so inferred masks flow through
    masks/parametric.generate_ai_mask exactly like reference-precomputed
    ones. The PNG is the port's own (io/encode.png_bytes): its bytes
    differ from PIL's, its decoded mask does not."""
    from rapidraw_tpu_torch.io.encode import png_bytes

    data = png_bytes(np.ascontiguousarray(mask, dtype=np.uint8))
    return "data:image/png;base64," + base64.b64encode(data).decode()


def precompute_ai_submasks(adjustments: dict, image, device="cuda") -> dict:
    """Fill missing maskDataBase64 on AI sub-masks by running inference —
    the analog of the reference's precompute commands (ai_commands.rs),
    which embed the mask PNG into the doc so the rasterizer (and the
    frontend patch-dedup cache) can reuse it.

    ai-foreground / quick-eraser -> U2-Net; ai-sky -> skyseg U2-Net;
    ai-depth -> Depth-Anything map; ai-subject -> SAM with the sub-mask's
    startX/endX drag prompt (un-transformed back through
    rotation/flip/orientation like ai_commands.rs:248-317; the SAM
    embeddings are computed once and reused across sub-masks). `image` is
    planar (3, H, W) float32, a NumPy array or a tensor; the networks run
    on `device`. Returns a NEW adjustments dict.
    """
    sam_embeddings = None  # lazy; shared by every ai-subject sub-mask
    memo: dict = {}  # fg/sky/depth are prompt-free: one inference per image
    out = dict(adjustments)
    masks_json = [dict(m) if isinstance(m, dict) else m for m in (out.get("masks") or [])]
    for m in masks_json:
        if not isinstance(m, dict):
            continue
        subs = [dict(s) if isinstance(s, dict) else s for s in (m.get("subMasks") or [])]
        for s in subs:
            if not isinstance(s, dict):
                continue
            params = dict(s.get("parameters") or {})
            if params.get("maskDataBase64"):
                continue
            t = s.get("type")
            if t in ("ai-foreground", "quick-eraser"):
                if "fg" not in memo:
                    memo["fg"] = generate_foreground_mask(image, device)
                mask = memo["fg"]
            elif t == "ai-sky":
                if "sky" not in memo:
                    memo["sky"] = generate_sky_mask(image, device)
                mask = memo["sky"]
            elif t == "ai-depth":
                from rapidraw_tpu_torch.ai.depth import generate_depth_map

                if "depth" not in memo:
                    memo["depth"] = generate_depth_map(image, device)
                mask = memo["depth"]
            elif t == "ai-subject":
                from rapidraw_tpu_torch.ai import sam

                if sam_embeddings is None:
                    sam_embeddings = sam.generate_image_embeddings(image, device)
                ih, iw = image.shape[1], image.shape[2]
                sp, ep = sam.unproject_prompt_rect(
                    (float(params.get("startX", 0.0)), float(params.get("startY", 0.0))),
                    (float(params.get("endX", 0.0)), float(params.get("endY", 0.0))),
                    iw, ih,
                    rotation=float(params.get("rotation", 0.0) or 0.0),
                    flip_horizontal=bool(params.get("flipHorizontal", False)),
                    flip_vertical=bool(params.get("flipVertical", False)),
                    orientation_steps=int(params.get("orientationSteps", 0) or 0),
                )
                mask = sam.run_sam_decoder(sam_embeddings, sp, ep)
            else:
                continue
            params["maskDataBase64"] = mask_to_data_url(mask)
            s["parameters"] = params
        m["subMasks"] = subs
    out["masks"] = masks_json
    return out


# ----------------------------------------------- euclidean distance transform
def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb-Huttenlocher 1D squared distance transform along the
    last axis (vectorized over leading axes per-row loop)."""
    n = f.shape[-1]
    out = np.empty_like(f)
    for idx in np.ndindex(f.shape[:-1]):
        row = f[idx]
        v = np.zeros(n, np.int64)  # parabola locations
        z = np.full(n + 1, 0.0)
        z[0], z[1] = -np.inf, np.inf
        k = 0
        for q in range(1, n):
            s = ((row[q] + q * q) - (row[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
            while s <= z[k]:
                k -= 1
                s = ((row[q] + q * q) - (row[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
            k += 1
            v[k] = q
            z[k] = s
            z[k + 1] = np.inf
        k = 0
        d = np.empty(n)
        for q in range(n):
            while z[k + 1] < q:
                k += 1
            d[q] = (q - v[k]) ** 2 + row[v[k]]
        out[idx] = d
    return out


def euclidean_distance_transform(binary: np.ndarray) -> np.ndarray:
    """Exact euclidean distance (float32) from each zero pixel to the
    nearest non-zero pixel (ai_processing.rs:97-164). Non-zero pixels get 0.
    """
    try:
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(binary == 0).astype(np.float32)
    except ImportError:
        inf = 1e12
        f = np.where(binary != 0, 0.0, inf)
        d = _edt_1d_sq(f)
        d = _edt_1d_sq(np.ascontiguousarray(d.T)).T
        return np.sqrt(d).astype(np.float32)


def grow_mask(mask: np.ndarray, pixels: float, threshold: int = 127) -> np.ndarray:
    """Grow (pixels > 0) or shrink (< 0) a u8 mask by a euclidean radius —
    the AI-mask grow op (ai_processing.rs:97-164), distinct from the
    percentage-based dilate/erode in masks/parametric."""
    if pixels == 0:
        return mask
    binary = mask > threshold
    if pixels > 0:
        dist = euclidean_distance_transform(binary.astype(np.uint8))
        return np.where(binary | (dist <= pixels), 255, 0).astype(np.uint8)
    dist = euclidean_distance_transform((~binary).astype(np.uint8))
    return np.where(binary & (dist > -pixels), 255, 0).astype(np.uint8)
