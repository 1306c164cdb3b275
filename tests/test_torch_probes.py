"""The port's profiling probes P1 and P2 (plain versions of csrc/chunked.cu
and csrc/nr_slices.cu) against the repo's JAX probes.

P1: the JAX probe `tools/prof_chunked.py` runs its Pallas kernel in
interpret mode on the CPU, whole-tile and chunked, at 512x1024 (its
module-level 24 MP shape is patched for the test); each mode against
`chain` on a CPU tensor, bound 1e-6 (the same 104 float32 operations in
the same order). P2: `tools/prof_nr_slices.py` builds its kernel
(`pallas_nr`) and its XLA reference (`xla_nr`) inside `main()`; the test
captures both from `jax.jit` and runs them at 128x256 and at 100x200 (not
a multiple of the probe's 64-row tile). `slices` matches `xla_nr` run op
by op exactly (the same products and sums in the same order), and
`pallas_nr` and the jitted `xla_nr` to 1e-6: compiled for the CPU, XLA
contracts a product and a sum into one fused multiply-add, which moves a
third of the values by an ulp. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import rapidraw_tpu.cli  # noqa: F401  (imported before jax.jit is patched below)
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from rapidraw_tpu_torch.tools import CHAIN_OPS_PER_ELEMENT, SLICES_OPS_PER_ELEMENT
from rapidraw_tpu_torch.tools import prof_chunked as tpc
from rapidraw_tpu_torch.tools import prof_nr_slices as tps

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def load_probe(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def image(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((3, h, w), dtype=np.float32)


@pytest.mark.parametrize("mode,ch", [("whole", 0), ("chunk", 8), ("chunk", 64)])
def test_chain_matches_jax_probe(monkeypatch, mode, ch):
    probe = load_probe("prof_chunked")
    monkeypatch.setattr(probe, "H", 512)
    monkeypatch.setattr(probe, "W", 1024)
    x = image(512, 1024, seed=ch)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.make_fn(mode, ch or 8)(jnp.asarray(x)))
    got = tpc.chain(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _Captured(Exception):
    pass


def capture_nr_probe(monkeypatch, h: int, w: int) -> dict:
    """`pallas_nr` and `xla_nr` from the probe's main(), at (3, h, w):
    recorded as main() hands them to jax.jit, before any timing runs."""
    probe = load_probe("prof_nr_slices")
    monkeypatch.setattr(probe, "H", h)
    monkeypatch.setattr(probe, "W", w)
    monkeypatch.setattr(rapidraw_tpu.cli, "_enable_persistent_jit_cache", lambda: None)
    real_jit = jax.jit
    fns = {}

    def recording_jit(fn, *args, **kwargs):
        fns[fn.__name__] = fn
        if {"pallas_nr", "xla_nr"} <= fns.keys():
            raise _Captured
        return real_jit(fn, *args, **kwargs)

    monkeypatch.setattr(jax, "jit", recording_jit)
    with pytest.raises(_Captured):
        probe.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    return fns


@pytest.mark.parametrize("h,w", [(128, 256), (100, 200)])
def test_slices_matches_jax_probe(monkeypatch, h, w):
    fns = capture_nr_probe(monkeypatch, h, w)
    x = image(h, w, seed=h)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax.jit(fns["pallas_nr"])(jnp.asarray(x)))
    with jax.disable_jit():
        xla = np.asarray(fns["xla_nr"](jnp.asarray(x)))
    xla_fused = np.asarray(jax.jit(fns["xla_nr"])(jnp.asarray(x)))
    got = tps.slices(torch.from_numpy(x)).numpy()
    assert got.shape == pallas.shape == xla.shape == x.shape
    assert np.array_equal(got, xla)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla_fused, rtol=0, atol=1e-6)


def test_slices_plain_is_the_conv_yardstick():
    """The library call chip_smoke.py times computes the same function."""
    x = torch.from_numpy(image(40, 72, seed=3))
    xp, k = tps.conv_yardstick(x)
    conv = torch.nn.functional.conv2d(xp, k, groups=3)[0]
    np.testing.assert_allclose(conv.numpy(), tps.slices_plain(x).numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("probe", ["chain", "slices"])
def test_probe_wrappers_take_the_plain_path_on_the_cpu(probe):
    wrapper, plain = {"chain": (tpc.chain, tpc.chain_plain),
                      "slices": (tps.slices, tps.slices_plain)}[probe]
    x = torch.from_numpy(image(24, 40, seed=5))
    before = wrapper.launches
    assert torch.equal(wrapper(x), plain(x))
    assert wrapper.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(torch.empty((3, 24, 40), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        wrapper(x.double())


def test_probe_wrappers_reject_bad_work_splits():
    x = torch.zeros((3, 16, 32))
    for rows in (0, 65):
        with pytest.raises(ValueError, match="rows per thread"):
            tpc.chain(x, rows)
    for tile_rows in (0, 12, 136):
        with pytest.raises(ValueError, match="tiles of"):
            tps.slices(x, tile_rows)


def test_probe_op_counts():
    """chip_smoke.count_ops gives the probes' bounds: 104 operations per
    element for P1, 49 for P2 (each output read and written once)."""
    x = torch.from_numpy(image(16, 24, seed=7))
    _, ops = chip_smoke.count_ops(lambda: tpc.chain_plain(x))
    assert ops == CHAIN_OPS_PER_ELEMENT * x.numel() == 104 * x.numel()
    _, ops = chip_smoke.count_ops(lambda: tps.slices_plain(x))
    assert ops == SLICES_OPS_PER_ELEMENT * x.numel() == 49 * x.numel()


@pytest.mark.parametrize("module", [tpc, tps])
def test_probe_main_refuses_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main()
