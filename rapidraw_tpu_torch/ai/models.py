"""AI model registry.

Port of `rapidraw_tpu/ai/models.py` (the ai_processing.rs model table,
:21-57, and its sha256-verified lookup, :165-228), with the same
environment variables and default directory, so one converted checkpoint
serves both packages. Every network is a native torch port that loads the
flat npz named by `weights_file` (ai/masks._load_variables); the ONNX
file name and URL stay as provisioning documentation.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from pathlib import Path


class ModelUnavailable(RuntimeError):
    pass


@dataclass(frozen=True)
class ModelSpec:
    name: str
    filename: str
    url: str  # documentation only; no egress in this environment
    sha256: str | None = None
    weights_file: str | None = None  # flat-npz the native flax port loads
    native: str | None = None  # module implementing the native port


# the reference's model set (ai_processing.rs:21-57)
MODELS = {
    "sam_encoder": ModelSpec(
        "SAM ViT-B encoder", "sam_vit_b_encoder.onnx",
        "https://huggingface.co/.../sam_vit_b_01ec64.encoder.onnx",
        weights_file="sam_vit_b_encoder.npz", native="rapidraw_tpu_torch.ai.sam",
    ),
    "sam_decoder": ModelSpec(
        "SAM ViT-B decoder", "sam_vit_b_decoder.onnx",
        "https://huggingface.co/.../sam_vit_b_01ec64.decoder.onnx",
        weights_file="sam_vit_b_decoder.npz", native="rapidraw_tpu_torch.ai.sam",
    ),
    "u2net_foreground": ModelSpec(
        "U2-Net foreground", "u2net.onnx", "https://huggingface.co/.../u2net.onnx",
        weights_file="u2net.npz", native="rapidraw_tpu_torch.ai.masks",
    ),
    "skyseg": ModelSpec(
        "Sky segmentation U2-Net", "skyseg.onnx", "https://huggingface.co/.../skyseg.onnx",
        weights_file="skyseg.npz", native="rapidraw_tpu_torch.ai.masks",
    ),
    "depth_anything_v2": ModelSpec(
        "Depth-Anything v2 ViT-S", "depth_anything_v2_vits.onnx",
        "https://huggingface.co/.../depth_anything_v2_vits.onnx",
        weights_file="depth_anything_v2_vits.npz", native="rapidraw_tpu_torch.ai.depth",
    ),
    "nind_denoise": ModelSpec(
        "NIND UtNet denoiser", "nind_utnet.onnx", "https://huggingface.co/.../utnet.onnx",
        weights_file="utnet.npz", native="rapidraw_tpu_torch.ai.denoise",
    ),
    "lama_inpaint": ModelSpec(
        "LaMa inpainting fp16", "lama_fp16.onnx", "https://huggingface.co/.../lama_fp16.onnx",
        weights_file="lama.npz", native="rapidraw_tpu_torch.ai.inpaint",
    ),
    "clip": ModelSpec(
        "CLIP ViT-B/32", "clip_vit_b32.onnx", "https://huggingface.co/.../clip.onnx",
        weights_file="clip/ (transformers save_pretrained dir)",
        native="rapidraw_tpu_torch.ai.tagging",
    ),
}


def models_dir() -> Path:
    return Path(
        os.environ.get("RAPIDRAW_MODELS_DIR", os.path.expanduser("~/.cache/rapidraw_tpu/models"))
    )


def model_path(key: str, verify: bool = True) -> Path:
    spec = MODELS.get(key)
    if spec is None:
        raise KeyError(f"unknown model {key!r}")
    p = models_dir() / spec.filename
    if not p.exists():
        raise ModelUnavailable(
            f"{spec.name} not found at {p}. This build has no network egress; "
            f"download it manually (reference source: {spec.url}) and place it there, "
            f"or set RAPIDRAW_MODELS_DIR."
        )
    if verify and spec.sha256:
        digest = hashlib.sha256(p.read_bytes()).hexdigest()
        if digest != spec.sha256:
            raise ModelUnavailable(f"{spec.name} at {p} failed sha256 verification")
    return p


def get_session(key: str):
    """The JAX package's ONNX session cache (ai_processing.rs:88-95) has no
    counterpart: the port imports no onnxruntime, so for a model file that is
    there this raises ModelUnavailable with the message JAX gives where
    onnxruntime is missing. Every network is a native torch port that reads
    its flat npz (`weights_file`) instead."""
    p = model_path(key)
    raise ModelUnavailable(
        f"onnxruntime is not available in this environment; cannot load {p.name}"
    )
