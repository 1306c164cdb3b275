"""Failure detection / recovery (SURVEY §5.3).

Port of `rapidraw_tpu/utils/recovery.py`, which mirrors the reference's
mechanisms:
  * crash flag around the device runtime's initialization — the reference
    writes a flag file before requesting the wgpu adapter and falls back
    to the GL backend if the flag survives a crash
    (gpu_processing.rs:158-165,236-238). The JAX package pins the CPU when
    it finds the flag. The port does not fall back: a run that finds the
    flag raises and names the file, unless its caller asked for the CPU,
    so a wedged card is never hidden behind a slow CPU render;
  * generation-token cancellation — image loads / thumbnail walks /
    exports check a token and stop early (image_loader.rs:352-463,
    lib.rs:239-258, export_processing.rs:1006-1018).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path


class BackendCrashFlag(RuntimeError):
    """A previous run died while it initialized the CUDA runtime."""


def _flag_path() -> Path:
    env = os.environ.get("RAPIDRAW_CACHE_DIR")
    if env and env.lower() == "none":
        # the documented disable-the-cache sentinel is not a literal path;
        # the crash flag falls back to the home cache dir
        env = None
    d = Path(env) if env else Path.home() / ".cache" / "rapidraw_tpu_torch"
    d.mkdir(parents=True, exist_ok=True)
    return d / "backend_crash_flag"


def guarded_backend_init(device=None) -> str:
    """Initialize the CUDA runtime behind a crash flag; returns the
    platform initialized ("cuda", or "cpu" when `device` asks for it).

    The flag is written before the first CUDA call and removed once it
    returns. If the flag is already there, a previous initialization never
    completed: this raises BackendCrashFlag naming the file (remove it to
    try the card again) instead of falling back to the CPU as the JAX
    package does. device="cpu" never touches CUDA or the flag."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    flag = _flag_path()
    if flag.exists():
        raise BackendCrashFlag(
            f"a previous run died while initializing CUDA (crash flag {flag}); "
            "check the card, then remove the flag to try it again, or pass device='cpu'")
    try:
        flag.write_text("init")
    except OSError:
        flag = None
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is False)")
        torch.cuda.init()
        torch.cuda.get_device_name(0)
    finally:
        if flag is not None:
            try:
                flag.unlink()
            except OSError:
                pass
    return "cuda"


class CancellationToken:
    """Cooperative cancellation shared across threads."""

    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()
