"""Generative-replace connector — client for a local inpainting middleware.

Port of `rapidraw_tpu/ai/connector.py` (ai_connector.rs: the reference
proxies "generative replace" to an external ComfyUI-style HTTP service on
localhost): health check at GET /health, POST /inpaint with {source_id,
prompt, negative_prompt, mask_image_base64, seed}; a 404 means the service
hasn't seen the source yet, so the client uploads it (multipart to
/upload_source) and retries. The response {x, y, color(base64 PNG)} is
composited onto a transparent full-size canvas.

Standard library (urllib) only; the images go out through the port's PNG
and JPEG writers and the reply comes back through its PNG decoder in place
of PIL's.
"""

from __future__ import annotations

import base64
import hashlib
import json
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np


def generate_source_id(path: str) -> str:
    """blake-style content id: path + mtime (ai_connector.rs:28-41)."""
    try:
        mtime = int(Path(path).stat().st_mtime)
    except OSError:
        mtime = 0
    h = hashlib.blake2b(digest_size=32)
    h.update(path.encode())
    h.update(mtime.to_bytes(8, "little"))
    return h.hexdigest()


def check_status(address: str, timeout: float = 3.0) -> bool:
    """GET http://{address}/health (ai_connector.rs:109-116)."""
    try:
        with urllib.request.urlopen(f"http://{address}/health", timeout=timeout):
            return True
    except (urllib.error.URLError, OSError):
        return False


def _png_b64(planar_or_gray) -> str:
    """Base64 PNG of a planar image or an (H, W) mask; u8 as it is, floats
    clipped to [0, 1] and rounded. The port's PNG writer: other bytes than
    PIL's, the same pixels."""
    from rapidraw_tpu_torch.io.encode import png_bytes

    arr = _host(planar_or_gray)
    if arr.ndim == 3 and arr.shape[0] in (3, 4):
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return base64.b64encode(png_bytes(np.ascontiguousarray(arr))).decode()


def _jpeg_bytes(planar, quality: int = 95) -> bytes:
    """JPEG of a planar RGB image (or an (H, W) grey one) as PIL writes it
    (csrc/host/jpeg_enc.cc)."""
    from rapidraw_tpu_torch import native

    planar = _host(planar)
    arr = planar.transpose(1, 2, 0) if planar.ndim == 3 and planar.shape[0] == 3 else planar
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return native.jpeg_encode(np.ascontiguousarray(arr), quality)


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _decode_rgba(data: bytes) -> np.ndarray:
    """(H, W, 4) u8 of the reply's PNG, as PIL's convert("RGBA")."""
    from rapidraw_tpu_torch.io.encode import decode_png_rgba

    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise RuntimeError("AI generation failed: the reply's image is not a PNG")
    return decode_png_rgba(data)


def _post_json(url: str, payload: dict, token: str | None, timeout: float):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urllib.request.urlopen(req, timeout=timeout)


def _upload_source(base_url: str, source_id: str, image,
                   token: str | None, timeout: float) -> None:
    boundary = uuid.uuid4().hex
    jpeg = _jpeg_bytes(image)
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="source_id"\r\n\r\n{source_id}\r\n'
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; filename="source.jpg"\r\n'
        f"Content-Type: image/jpeg\r\n\r\n"
    ).encode() + jpeg + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"{base_url}/upload_source", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=timeout) as res:
        if res.status // 100 != 2:
            raise RuntimeError(f"upload failed: HTTP {res.status}")


def process_inpainting(
    base_url: str,
    source_path: str,
    full_source_image,
    mask_image: np.ndarray,
    prompt: str,
    token: str | None = None,
    timeout: float = 120.0,
) -> np.ndarray:
    """Run generative replace; returns a full-size RGBA (4, H, W) uint8
    patch layer (transparent outside the generated crop), like the
    reference's composite_full_res (ai_connector.rs:90-107)."""
    _, h, w = full_source_image.shape
    source_id = generate_source_id(source_path)
    payload = {
        "source_id": source_id,
        "prompt": prompt,
        "negative_prompt": "blur, low quality, distortion, watermark",
        "mask_image_base64": _png_b64(mask_image),
        "seed": 0,
    }
    url = f"{base_url}/inpaint"
    try:
        res = _post_json(url, payload, token, timeout)
        data = json.loads(res.read())
    except urllib.error.HTTPError as e:
        if e.code != 404:
            raise RuntimeError(f"AI generation failed: {e.read()[:500]}") from e
        # unknown source: upload it and retry once — both steps keep the
        # RuntimeError contract (the retry is where generation errors land)
        try:
            _upload_source(base_url, source_id, full_source_image, token, timeout)
            res = _post_json(url, payload, token, timeout)
            data = json.loads(res.read())
        except urllib.error.HTTPError as e2:
            raise RuntimeError(f"AI generation failed: {e2.read()[:500]}") from e2

    crop = _decode_rgba(base64.b64decode(data["color"]))
    # PIL's Image.paste of the RGBA crop onto a transparent canvas: the
    # crop's pixels replace the canvas's, clipped to it
    canvas = np.zeros((h, w, 4), np.uint8)
    x, y = int(data["x"]), int(data["y"])
    ch, cw = crop.shape[:2]
    ty0, tx0 = max(y, 0), max(x, 0)
    ty1, tx1 = min(y + ch, h), min(x + cw, w)
    if ty1 > ty0 and tx1 > tx0:
        canvas[ty0:ty1, tx0:tx1] = crop[ty0 - y:ty1 - y, tx0 - x:tx1 - x]
    return canvas.transpose(2, 0, 1)
