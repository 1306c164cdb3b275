"""Host-side parts of the redesigned grade and NR kernels that only the
card would otherwise check: their launch plans and the exact libm rewrite.

- The launch plans (`fused.grade_launch_plan`, `nr.nr_launch_plan`), each
  computed in Python beside its wrapper and passed to the C entry point
  as it is (for grade, the build for the document's chain length too): the kernels' own index mapping, mirrored here in numpy, covers
  every pixel of ragged sizes exactly once; every tap of NR's tables lands
  inside the staged tile; the staged tile's shared memory stays within
  the limit rr_nr_static checks at every halo from 1 to 16.
- `mod360` in csrc/grade.cu replaces `fmodf(x, 360)` by exact subtractions
  on [0, 1080) and keeps `fmodf` elsewhere: a numpy mirror of it equals
  the plain chain's `torch.fmod` bit for bit on every float32 of that
  range and on values outside it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from rapidraw_tpu_torch import parse_adjustments
from rapidraw_tpu_torch.native import CSRC
from rapidraw_tpu_torch.ops import nr
from rapidraw_tpu_torch.params import scales
from rapidraw_tpu_torch.pipeline import fused

RAGGED = [(1, 1), (1, 2, 3), (2, 1000, 1503), (1, 31, 33), (1, 32, 32), (3, 65, 97),
          (1, 257, 31)]
RAGGED = [s if len(s) == 3 else (1, *s) for s in RAGGED]


def covered(plan: dict, h: int, w: int) -> np.ndarray:
    """How often the kernel's mapping visits each pixel of one image: block
    (bx, by), thread (tx, ty) and row step r reach column bx * 32 + tx and
    row by * tile_h + ty + 8 * r, kept where inside the image."""
    gx, gy, _ = plan["grid"]
    bxs, bys = plan["block"]
    tile_h = plan["tile"][0]
    assert plan["tile"] == (bys * plan["rows"], bxs)
    x = (np.arange(gx)[:, None] * bxs + np.arange(bxs)[None]).ravel()
    r = np.arange(plan["rows"])
    y = (np.arange(gy)[:, None, None] * tile_h + np.arange(bys)[None, :, None]
         + bys * r[None, None]).ravel()
    counts = np.zeros((h, w), np.int64)
    ys, xs = y[y < h], x[x < w]
    np.add.at(counts, (ys[:, None], xs[None]), 1)
    return counts


SHORT_CHAIN = {"exposure": 0.3, "sharpness": 20}
LONG_CHAIN = dict(chip_smoke.CONFIG3_DOC)


@pytest.mark.parametrize("b,h,w", RAGGED)
@pytest.mark.parametrize("doc", [SHORT_CHAIN, LONG_CHAIN], ids=["short", "long"])
def test_grade_plan_covers_every_pixel_once(b, h, w, doc):
    plan = fused.grade_launch_plan(b, h, w, parse_adjustments(doc)[1])
    assert plan["grid"][2] == b
    assert plan["grid"][1] <= 65535
    np.testing.assert_array_equal(covered(plan, h, w), 1)


def test_grade_plan_picks_the_build_by_chain_length():
    """A long chain takes the 64-register build (4 blocks per SM) and 4 rows
    per thread, a short one the 40-register build (6 blocks) and 8 rows;
    rr_grade has exactly these two builds and at most 16 rows per thread."""
    short = parse_adjustments(SHORT_CHAIN)[1]
    long_ = parse_adjustments(LONG_CHAIN)[1]
    assert fused.grade_stages(short) < fused.LONG_CHAIN <= fused.grade_stages(long_)
    assert fused.grade_stages(parse_adjustments(chip_smoke.CONFIG5_DOC)[1]) < fused.LONG_CHAIN
    plans = [fused.grade_launch_plan(2, 4096, 6144, c) for c in (short, long_)]
    assert [(p["min_blocks"], p["rows"]) for p in plans] == [(6, 8), (4, 4)]
    src = (CSRC / "grade.cu").read_text()
    assert "min_blocks != 4 && min_blocks != 6" in src and "MAX_ROWS = 16" in src


@pytest.mark.parametrize("b,h,w", RAGGED)
@pytest.mark.parametrize("halo", [1, 11, 16])
def test_nr_plan_covers_every_pixel_once(b, h, w, halo):
    plan = nr.nr_launch_plan(b, h, w, halo)
    assert plan["grid"][2] == b and plan["halo"] == halo
    np.testing.assert_array_equal(covered(plan, h, w), 1)


def test_nr_plan_smem_within_limit_at_every_halo():
    for halo in range(1, nr.NR_HALO + 1):
        plan = nr.nr_launch_plan(2, 4096, 6144, halo)
        sh, sw = plan["stage"]
        assert (sh, sw) == (plan["tile"][0] + 2 * halo, plan["tile"][1] + 2 * halo)
        assert sw <= 64  # the kernel stages at most two columns per lane
        assert plan["smem"] == 3 * sh * sw * 4 <= nr.NR_SMEM_LIMIT
    # the largest halo fills the limit exactly: a taller tile would not launch
    assert nr.nr_launch_plan(1, 64, 64, nr.NR_HALO)["smem"] == nr.NR_SMEM_LIMIT


@pytest.mark.parametrize("amounts", [(0.30, 0.25), (0.8, 0.6), (1.0, 1.0), (0.05, 0.0)])
def test_nr_tap_offsets_stay_inside_the_staged_tile(amounts):
    """Each tap's flat offset (dy * staged width + dx, as the wrapper packs
    it) read from every pixel of the tile is the staged position of that
    pixel moved by (dx, dy), inside the staged tile (the taps of the passes
    the amounts turn on: the halo is the largest of their offsets)."""
    k = nr._consts(*amounts, scales.resolution_scale(6144, 4096))
    plan = nr.nr_launch_plan(2, 4096, 6144, max(k["max_off"], 1))
    (sh, sw), halo = plan["stage"], plan["halo"]
    th, tw = plan["tile"]
    ty, tx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    c0 = (ty + halo) * sw + tx + halo
    taps = (k["luma_taps"] if k["luma_on"] else []) + (k["chroma_taps"] if k["color_on"] else [])
    assert taps
    for dx, dy, _ in taps:
        pos = c0 + (dy * sw + dx)
        np.testing.assert_array_equal(pos // sw, ty + halo + dy)
        np.testing.assert_array_equal(pos % sw, tx + halo + dx)
        assert pos.min() >= 0 and pos.max() < sh * sw


def mod360(x: np.ndarray) -> np.ndarray:
    """numpy mirror of `mod360` in csrc/grade.cu, in float32: x on [0, 360),
    x - 360 on [360, 720), x - 720 on [720, 1080), fmod elsewhere."""
    x = np.asarray(x, np.float32)
    fast = (x >= np.float32(0.0)) & (x < np.float32(1080.0))
    out = np.fmod(x, np.float32(360.0), where=~fast, out=np.empty_like(x))
    np.copyto(out, x, where=fast)
    np.subtract(x, np.float32(360.0), out=out, where=fast & (x >= np.float32(360.0)))
    np.subtract(x, np.float32(720.0), out=out, where=fast & (x >= np.float32(720.0)))
    return out


def fmod360(x: np.ndarray) -> np.ndarray:
    """The original: the plain chain's torch.fmod(x, 360) in float32."""
    return torch.fmod(torch.from_numpy(x), 360.0).numpy()


def test_mod360_equals_fmod_on_every_float_of_its_fast_range():
    """Every float32 in [0, 1080), in 2^24-value chunks of the bit pattern."""
    lo = int(np.float32(0.0).view(np.uint32))
    hi = int(np.float32(1080.0).view(np.uint32))
    step = 1 << 24
    for a in range(lo, hi, step):
        x = np.arange(a, min(a + step, hi), dtype=np.uint32).view(np.float32)
        np.testing.assert_array_equal(mod360(x).view(np.uint32), fmod360(x).view(np.uint32))


def test_mod360_falls_back_to_fmod_outside_it():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1e6, 0.0, 4096), rng.uniform(1080.0, 1e7, 4096),
        np.array([-0.0, -360.0, -1080.0, 1080.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan]),
    ]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        got = mod360(x)
    np.testing.assert_array_equal(got.view(np.uint32), fmod360(x).view(np.uint32))


def test_mod360_mirrors_the_kernel_source():
    """The mirror above is of the code that ships: the kernel's mod360 has
    the same bounds and the same fallback, and replaces every fmodf."""
    src = (CSRC / "grade.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    body = code[code.index("float mod360("):]
    body = body[:body.index("\n}\n")]
    for piece in ("x >= 0.0f && x < 1080.0f", "x >= 720.0f ? x - 720.0f",
                  "x >= 360.0f ? x - 360.0f : x", "fmodf(x, 360.0f)"):
        assert piece in body, piece
    assert code.count("fmodf(") == 1 and code.count("mod360(") == 3
