"""Image tagging: HSV colour tags, CLIP zero-shot scoring, folder indexing.

Port of `rapidraw_tpu/ai/tagging.py` (tagging.rs): the colour-tag
extractor and CLIP's preprocessing run on the host in NumPy, PIL-exact
through the port's own u8 resizes (geometry/resize.py); CLIP's two towers
(ai/clip.py) run on `device`, the CUDA device unless the caller asks for
another, with the checkpoint read by ai/checkpoint.py and the text
tokenized by ai/clip_tokenizer.py (the card's machine has neither
`transformers` nor `tokenizers`). `index_folder_tags` is the background
indexer (tagging.rs:251-434), `clear_ai_tags` / `clear_all_tags` the
sidecar sweeps (:469-540).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from rapidraw_tpu_torch.utils.trace import mark_stage

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.2613026, 0.2757771)


def _host_u8(planar) -> np.ndarray:
    """(H, W, 3) u8 of planar (3, H, W) f32 [0, 1]: PIL's fromarray of
    JAX's `(clip * 255).astype(uint8)`, truncating in float32."""
    if isinstance(planar, torch.Tensor):
        planar = planar.detach().cpu().numpy()
    return np.ascontiguousarray((np.clip(planar, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0))


def preprocess_clip_image(planar, input_size: int = 224) -> np.ndarray:
    """Resize-to-fill + CLIP normalization (tagging.rs:26-42): PIL's 8-bit
    BILINEAR resize to max(round(side * scale), S) a side, the centre crop,
    then (x / 255 - mean) / std. Returns (1, 3, S, S) float32."""
    from rapidraw_tpu_torch.geometry.resize import resize_u8

    arr = _host_u8(planar)
    h, w = arr.shape[:2]
    scale = max(input_size / w, input_size / h)
    nw, nh = max(round(w * scale), input_size), max(round(h * scale), input_size)
    im = resize_u8(arr, nw, nh, "bilinear")
    left = (nw - input_size) // 2
    top = (nh - input_size) // 2
    im = im[top:top + input_size, left:left + input_size]
    x = im.astype(np.float32) / 255.0
    x = (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return x.transpose(2, 0, 1)[None]


def softmax(x: np.ndarray) -> np.ndarray:
    """(tagging.rs:43-54)."""
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    s = e.sum(axis=-1, keepdims=True)
    return np.where(s > 0, e / np.where(s > 0, s, 1.0), e)


def extract_color_tags(planar) -> list[str]:
    """Dominant-colour tags (tagging.rs:87-144) of PIL's `thumbnail((100,
    100))` of the u8 image."""
    from rapidraw_tpu_torch.geometry.resize import thumbnail_u8

    px = thumbnail_u8(_host_u8(planar), (100, 100)).astype(np.float32) / 255.0

    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    mx = px.max(-1)
    mn = px.min(-1)
    delta = mx - mn
    safe = np.where(delta > 0, delta, 1.0)
    h = np.where(
        delta == 0, 0.0,
        np.where(
            mx == r, 60.0 * np.mod((g - b) / safe, 6.0),
            np.where(mx == g, 60.0 * ((b - r) / safe + 2.0), 60.0 * ((r - g) / safe + 4.0)),
        ),
    )
    h = np.where(h < 0, h + 360.0, h)
    s = np.where(mx > 0, delta / np.where(mx > 0, mx, 1.0), 0.0)
    v = mx

    names = np.full(h.shape, "unknown", dtype="<U8")
    names[(h < 20) | (h >= 340)] = "red"
    names[(h >= 20) & (h < 45)] = "orange"
    names[(h >= 45) & (h < 70)] = "yellow"
    names[(h >= 70) & (h < 160)] = "green"
    names[(h >= 160) & (h < 260)] = "blue"
    names[(h >= 260) & (h < 340)] = "purple"
    brown = ((names == "orange") | (names == "red")) & (v < 0.6) & (s < 0.7)
    names[brown] = "brown"
    names[(v >= 0.2) & (s < 0.1) & (v > 0.8)] = "white"
    names[(v >= 0.2) & (s < 0.1) & (v <= 0.8)] = "gray"
    names[v < 0.2] = "black"

    # np.unique's (sorted) order before the stable count sort decides ties
    uniq, counts = np.unique(names, return_counts=True)
    tally = dict(zip(uniq.tolist(), counts.tolist()))
    colorful = sorted(
        ((n, c) for n, c in tally.items() if n not in ("black", "white", "gray")),
        key=lambda t: -t[1],
    )
    if colorful:
        return [n for n, _ in colorful[:2]]
    if tally:
        return [max(tally.items(), key=lambda t: t[1])[0]]
    return []


# --------------------------------------------------------------- CLIP scoring
def _clip_dir() -> Path:
    """Local CLIP checkpoint directory (transformers save_pretrained layout:
    config + weights + tokenizer files): `RAPIDRAW_CLIP`, else `clip/` in
    the models directory. No network egress: the user supplies it, like
    every model in ai/models.py."""
    from rapidraw_tpu_torch.ai.masks import _models_dir

    return Path(os.environ.get("RAPIDRAW_CLIP", str(_models_dir() / "clip")))


_CLIP_CACHE: dict = {}


def _load_clip(device="cuda"):
    """(ClipModel on `device`, ClipTokenizer) of the checkpoint at
    `_clip_dir()`. One checkpoint is resident at a time, keyed by the
    directory, its files' mtimes and the device."""
    from rapidraw_tpu_torch.ai.checkpoint import read_config, read_state
    from rapidraw_tpu_torch.ai.clip import ClipConfig, ClipModel, load_clip_state
    from rapidraw_tpu_torch.ai.clip_tokenizer import ClipTokenizer
    from rapidraw_tpu_torch.ai.models import ModelUnavailable

    d = _clip_dir()
    if not d.is_dir():
        raise ModelUnavailable(
            f"CLIP checkpoint not found at {d}. Place a transformers "
            "save_pretrained() CLIP directory there or set RAPIDRAW_CLIP."
        )
    stamp = tuple(sorted((f.name, f.stat().st_mtime_ns) for f in d.iterdir() if f.is_file()))
    key = (str(d), stamp, str(torch.device(device)))
    hit = _CLIP_CACHE.get(key)
    if hit is not None:
        return hit
    model = ClipModel(ClipConfig.from_dict(read_config(d)))
    load_clip_state(model, read_state(d))
    model = model.to(device).eval()
    tokenizer = ClipTokenizer.from_dir(d)
    _CLIP_CACHE.clear()  # one checkpoint resident at a time
    _CLIP_CACHE[key] = (model, tokenizer)
    return model, tokenizer


def generate_tags_with_clip(
    planar,
    custom_tags: list[str] | None = None,
    max_tags: int = 10,
    device="cuda",
    stages=None,
) -> list[str]:
    """Zero-shot tags for planar (3, H, W) f32 [0,1], an array or a tensor
    (tagging.rs:145-249).

    Scores the image against TAG_CANDIDATES (or the user's custom list) by
    CLIP's logits_per_image -> softmax on `device`, keeps probabilities >
    0.005, takes the top `max_tags`, then (for the default list only)
    unions in the dominant colour tags and every hierarchy parent of a kept
    tag. `stages` (utils/trace.Stages) takes the marks "model" (the
    checkpoint's first read), "preprocess" and "towers".
    """
    from rapidraw_tpu_torch.ai.tag_data import TAG_CANDIDATES, TAG_HIERARCHY

    model, tokenizer = _load_clip(device)
    mark_stage(stages, "model")
    is_custom = bool(custom_tags)
    texts = list(custom_tags) if is_custom else list(TAG_CANDIDATES)

    pixels = torch.from_numpy(preprocess_clip_image(planar, model.cfg.vision.image_size))
    # bare colour names, NOT "color:"-prefixed: the reference's
    # extract_color_tags also returns bare names (tagging.rs:86-144,
    # insert at :232-235) — generated colour tags are AI tags and are
    # wiped by clear_ai_tags there too
    colors = [] if is_custom else extract_color_tags(planar)
    ids, mask = tokenizer(texts, max_length=model.cfg.text.max_position_embeddings)
    mark_stage(stages, "preprocess")
    dev = torch.device(device)
    logits = model(pixels.to(dev), torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    probs = softmax(logits[0].cpu().numpy()[None])[0]
    mark_stage(stages, "towers")

    scored = [(texts[i], float(p)) for i, p in enumerate(probs) if p > 0.005]
    scored.sort(key=lambda t: -t[1])
    initial = [t for t, _ in scored[:max_tags]]

    final = set(initial)
    if not is_custom:
        final.update(colors)
        for t in initial:
            final.update(TAG_HIERARCHY.get(t, ()))
    return sorted(final)


COLOR_TAG_PREFIX = "color:"
USER_TAG_PREFIX = "user:"


def index_folder_tags(
    folder: str,
    custom_tags: list[str] | None = None,
    max_tags: int = 10,
    progress=None,
    cancel=None,
    device="cuda",
    stages=None,
) -> int:
    """Background-indexing analog (tagging.rs:251-434): CLIP-tag every
    supported image in `folder` that has no AI tags yet (color:/user:
    prefixed tags don't count), union with existing sidecar tags, sorted.

    `progress(current, total)` mirrors the indexing-progress event;
    `cancel` is an optional CancellationToken. Returns images processed.
    A missing checkpoint (ModelUnavailable) or a kernel or decoder that
    does not build (KernelBuildError) stops the walk; any other error
    skips its image, as in the reference.
    `stages` takes the marks "load", "downscale", "model", "preprocess",
    "towers" and "sidecars" per image.
    """
    from rapidraw_tpu_torch.ai.models import ModelUnavailable
    from rapidraw_tpu_torch.geometry.resize import downscale_to_long_edge
    from rapidraw_tpu_torch.io.loader import load_image
    from rapidraw_tpu_torch.library.catalog import add_tags, get_tags, list_images
    from rapidraw_tpu_torch.native import KernelBuildError

    paths = list_images(folder)
    done = 0
    for i, p in enumerate(paths):
        if cancel is not None and cancel.cancelled:
            break
        existing = get_tags(p)
        has_ai = any(
            not t.startswith(COLOR_TAG_PREFIX) and not t.startswith(USER_TAG_PREFIX)
            for t in existing
        )
        if not has_ai:
            try:
                # fast (thumbnail) load: the reference scores CACHED
                # THUMBNAILS (tagging.rs:345-350), and CLIP resizes to 224
                # anyway — a full-quality RAW develop here is pure waste
                planar, _ = load_image(p, fast=True, device=device)
                mark_stage(stages, "load")
                # thumbnail-scale the scoring input like the reference's
                # cached thumbnail path; downscale once on the long edge
                if max(planar.shape[1:]) > 720:
                    planar = downscale_to_long_edge(planar, 720)
                mark_stage(stages, "downscale")
                tags = generate_tags_with_clip(planar, custom_tags, max_tags, device, stages)
                add_tags(p, tags)
                mark_stage(stages, "sidecars")
                done += 1
            except (ModelUnavailable, KernelBuildError):
                # a missing checkpoint or build is a configuration error for
                # the WHOLE walk, not a per-image decode failure — surface it
                raise
            except Exception:
                pass  # per-image isolation, like the reference's logged skip
        if progress is not None:
            progress(i + 1, len(paths))
    return done


def clear_ai_tags(root_path: str) -> int:
    """Walk root for .rrdata sidecars and strip AI tags, keeping color:/
    user: prefixed ones; returns the number of sidecars updated
    (tagging.rs:469-504)."""
    return _sweep_tags(
        root_path,
        keep=lambda t: t.startswith(COLOR_TAG_PREFIX) or t.startswith(USER_TAG_PREFIX),
    )


def clear_all_tags(root_path: str) -> int:
    """Remove every tag from every .rrdata under root (tagging.rs:506-540)."""
    return _sweep_tags(root_path, keep=lambda t: False)


def _sweep_tags(root_path: str, keep) -> int:
    import json

    root = Path(root_path)
    if not root.exists():
        raise FileNotFoundError(f"Root path does not exist: {root_path}")
    updated = 0
    for p in root.rglob("*.rrdata"):
        try:
            meta = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        tags = meta.get("tags")
        if not isinstance(tags, list) or not tags:
            continue
        kept = [t for t in tags if isinstance(t, str) and keep(t)]
        if len(kept) < len(tags):
            meta["tags"] = kept or None
            try:
                p.write_text(json.dumps(meta, indent=2))
                updated += 1
            except OSError:
                pass
    return updated
