"""Logging + per-stage timing, the analog of the reference's fern/log setup
and its ad-hoc Instant timers (lib.rs:1692-1762 setup_logging; per-render
FPS gpu_processing.rs:1990-2014; per-job timing lib.rs:584-601).

Port of `rapidraw_tpu/utils/trace.py`. The deep profile comes from
`torch.profiler` (`profiler_trace`: CPU and CUDA activity around a
workload, written as a chrome trace); this module also covers the
always-on lightweight layer: stage timers that log at debug level, the
per-stage split of a preview render or a CLI verb (`Stages`), and a render
FPS line at info level.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

log = logging.getLogger("rapidraw_tpu_torch")


def setup_logging(
    level: str = "info", log_file: str | Path | None = None
) -> None:
    """stdout (+ optional file) handlers, level from settings
    (settings key 'logLevel', file 'logFile')."""
    lvl = getattr(logging, str(level).upper(), logging.INFO)
    log.setLevel(lvl)
    log.propagate = False  # records would also print via a configured root
    log.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    log.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(str(log_file))
        fh.setFormatter(fmt)
        log.addHandler(fh)


@contextlib.contextmanager
def stage_timer(name: str):
    """Log a stage duration at debug level; yields a dict with 'seconds'."""
    out = {"seconds": 0.0}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0
        log.debug("%s: %.1f ms", name, out["seconds"] * 1e3)


class Stages:
    """Host ms between marks, summed per stage name in `ms`; on a CUDA
    device each mark first synchronizes (so device work is charged to the
    stage that queued it)."""

    def __init__(self, device):
        self.sync = device.type == "cuda"
        self.ms: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.sync:
            import torch

            torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t) * 1e3
        self._t = now


def mark_stage(stages: Stages | None, name: str) -> None:
    """`stages.mark(name)` where the caller times its stages (`stages` is
    None where it does not: no mark, no synchronize)."""
    if stages is not None:
        stages.mark(name)


_fps_state = {"count": 0, "t0": None, "acc": 0.0}


def log_render_fps(seconds: float, label: str = "render") -> None:
    """Rolling per-render FPS line (gpu_processing.rs:1990-2014 logs one
    per render with a smoothed FPS)."""
    st = _fps_state
    st["count"] += 1
    st["acc"] += seconds
    if st["count"] % 10 == 0 and st["acc"] > 0:
        log.info("%s: %.1f ms avg, %.1f fps", label, st["acc"] / 10 * 1e3, 10 / st["acc"])
        st["acc"] = 0.0


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path):
    """torch.profiler scope over the host and, where the card is present,
    CUDA activity; writes `<log_dir>/trace.json` (chrome://tracing or
    Perfetto) when the scope ends and yields the profiler (its
    `key_averages()` tabulates time by operation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(d / "trace.json"))
