"""Host-side parts of the redesigned blur, grade and NR kernels that only
the card would otherwise check: their launch plans, the blur kernel's
tiling, and the exact libm rewrite.

- The launch plans (`fused.grade_launch_plan`, `nr.nr_launch_plan`), each
  computed in Python beside its wrapper and passed to the C entry point
  as it is (for grade, the build for the document's chain length too): the kernels' own index mapping, mirrored here in numpy, covers
  every pixel of ragged sizes exactly once; every tap of NR's tables lands
  inside the staged tile; the staged tile's shared memory stays within
  the limit rr_nr_static checks at every halo from 1 to 16.
- The blur plan (`blur.blur_launch_plan`): every output pixel of every
  level is written exactly once (fused regime, two-pass V) and every
  scratch pixel once (two-pass H), at ragged sizes; the staged tile and
  the intermediate cover every tap a chunk reads; shared memory stays
  within the limit rr_blur checks at every radius from 1 to 300; the plan
  mirrors the kernel's constants and its BlurPlan struct. A CPU emulation
  of the kernel's tiling (fused: stream the clamped strip with its halo
  step by step, H into each level's ring, min(., 65504), V from the ring,
  crop; two-pass: H tiles, then the V ring with the next step's rows
  loaded before each step computes) equals `gaussian_blur_multi_plain`.
- The per-pixel NR kernel's fixed 16-pixel halo holds every offset the
  plain version takes at the largest amounts and resolution factor, and
  its folded tap tables (two rings, five distances) mirror `_OFFSETS`.
- The flare kernel's launch plan (`flare.flare_launch_plan`) covers the
  map once and mirrors the kernel's constants; its tap table is made once
  per aspect and device and holds `flare_taps` rounded to float32; a
  mirror of its padded map and index rule (one low clamp, the padding for
  the high one, floor by a round-down add) samples as `_bilinear_uv` does,
  bit for bit.
- `mod360` in csrc/grade.cu replaces `fmodf(x, 360)` by exact subtractions
  on [0, 1080) and keeps `fmodf` elsewhere: a numpy mirror of it equals
  the plain chain's `torch.fmod` bit for bit on every float32 of that
  range and on values outside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from rapidraw_tpu_torch import parse_adjustments
from rapidraw_tpu_torch.geometry import warp_fast as twf
from rapidraw_tpu_torch.geometry.params import geometry_params_from_json as tgeom
from rapidraw_tpu_torch.native import CSRC
from rapidraw_tpu_torch.ops import blur, flare, nr
from rapidraw_tpu_torch.ops.common import mix
from rapidraw_tpu_torch.params import scales
from rapidraw_tpu_torch.pipeline import fused

RAGGED = [(1, 1), (1, 2, 3), (2, 1000, 1503), (1, 31, 33), (1, 32, 32), (3, 65, 97),
          (1, 257, 31)]
# the preview service's shapes: 1920 long edge, the 'performance' divisor,
# a 400 px preset thumbnail, an odd ROI
SERVICE = [(1280, 1920), (640, 960), (267, 400), (421, 593)]
RAGGED = [s if len(s) == 3 else (1, *s) for s in RAGGED] + [(1, h, w) for h, w in SERVICE]


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
MASKED = chip_smoke.config4_doc(64, 96)


@pytest.mark.parametrize("b,h,w", RAGGED)
@pytest.mark.parametrize("doc", [SHORT_CHAIN, LONG_CHAIN, MASKED], ids=["short", "long", "masks"])
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


def test_grade_plan_gives_masks_their_build():
    """A document with masks takes the mask build at 4 blocks per SM and 4
    rows per thread whatever its stage count, with 4 bytes per staged mask
    scalar of shared memory; rr_grade refuses any other size, a short
    budget with masks and more than MAX_MASKS masks; the plan refuses more
    masks first."""
    cfg = parse_adjustments(MASKED)[1]
    assert fused.grade_stages(cfg) < fused.LONG_CHAIN
    plan = fused.grade_launch_plan(2, 4096, 6144, cfg)
    assert (plan["min_blocks"], plan["rows"], plan["masks"]) == (4, 4, 3)
    assert plan["mask_smem"] == 3 * len(fused.MASK_SCALARS) * 4
    assert fused.grade_launch_plan(2, 64, 96, parse_adjustments(SHORT_CHAIN)[1])["mask_smem"] == 0
    src = (CSRC / "grade.cu").read_text()
    assert "mask_smem != nmask * M_SCALARS * (int)sizeof(float)" in src
    assert "nmask > MAX_MASKS" in src and "min_blocks != 4)))" in src
    assert "attr.sharedSizeBytes + (size_t)mask_smem > 48 * 1024" in src
    too_many = dataclasses.replace(cfg, mask_count=fused.scales.MAX_MASKS + 1)
    with pytest.raises(ValueError, match="masks"):
        fused.grade_launch_plan(1, 8, 8, too_many)


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


def _check_nr_taps(amounts, h: int, w: int) -> None:
    """Each tap's flat offset (dy * staged width + dx, as the wrapper packs
    it) read from every pixel of the tile is the staged position of that
    pixel moved by (dx, dy), inside the staged tile (the taps of the passes
    the amounts turn on: the halo is the largest of their offsets)."""
    k = nr._consts(*amounts, scales.resolution_scale(w, h))
    plan = nr.nr_launch_plan(2, h, w, max(k["max_off"], 1))
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


@pytest.mark.parametrize("amounts", [(0.30, 0.25), (0.8, 0.6), (1.0, 1.0), (0.05, 0.0)])
def test_nr_tap_offsets_stay_inside_the_staged_tile(amounts):
    _check_nr_taps(amounts, 4096, 6144)


def test_nr_dynamic_offsets_stay_inside_the_fixed_halo(monkeypatch):
    """The per-pixel kernel stages a fixed 16-pixel halo: every tap offset
    nr_dynamic_plain rounds (recorded from its own torch.round calls) at the
    largest amounts and the largest resolution factor fits it, and the
    largest reaches it (chroma: 2 * 3.5 * 2 + 1.75 rounds to 16)."""
    offsets = []
    real_round = torch.round

    def recording_round(x, *a, **k):
        out = real_round(x, *a, **k)
        offsets.append(out.abs().max().item())
        return out

    g = torch.Generator().manual_seed(4)
    img = torch.rand((3, 96, 128), generator=g)
    center = torch.rand((3, 96, 128), generator=g)
    monkeypatch.setattr(torch, "round", recording_round)
    scale = 4.0  # resolution factor clip(sqrt(4), 0.5, 2) = 2
    nr.nr_dynamic_plain(center, nr.nr_planes(img, False), torch.ones(96, 128),
                        torch.ones(96, 128), scale)
    assert len(offsets) == 4 * nr.NTAPS  # x and y of every luma and chroma tap
    assert max(offsets) == nr.NR_HALO
    src = (CSRC / "nr.cu").read_text()
    assert f"constexpr int MAX_HALO = {nr.NR_HALO};" in src
    assert f"constexpr int DYN_ROWS = {nr.NR_ROWS};" in src


def test_nr_dynamic_tap_folding_mirrors_the_offsets():
    """The kernel folds the 24 taps to two rings (the outer one has a
    coordinate at +-2) and five squared distances (1, 2, 4, 5, 8): a mirror
    of its constexpr tables, in tap order, equals nr._OFFSETS."""
    def tap_dx(t):
        return (t + (t >= 12)) % 5 - 2

    def tap_dy(t):
        return (t + (t >= 12)) // 5 - 2

    dist2 = [1, 2, 4, 5, 8]
    for t, (dx, dy) in enumerate(nr._OFFSETS):
        assert (tap_dx(t), tap_dy(t)) == (dx, dy)
        assert (2 in (abs(dx), abs(dy))) == (max(abs(dx), abs(dy)) == 2)
        assert dx * dx + dy * dy in dist2
    assert sorted({dx * dx + dy * dy for dx, dy in nr._OFFSETS}) == dist2
    src = (CSRC / "nr.cu").read_text()
    for piece in ("return (t + (t >= 12)) % 5 - 2;", "return (t + (t >= 12)) / 5 - 2;",
                  "return d < 2 ? d + 1 : d < 4 ? d + 2 : 8;"):
        assert piece in src, piece
    assert [d + 1 if d < 2 else d + 2 if d < 4 else 8 for d in range(5)] == dist2


# ---- flare ---------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 3])
def test_flare_plan_covers_the_map_once(b):
    """The composite grid's threads, each FLARE_ROWS rows of one column,
    make every map pixel of every image once."""
    plan = flare.flare_launch_plan(b)
    n = flare.FLARE_MAP_SIZE
    (bx, by), rows = plan["block"], plan["rows"]
    gx, gy, gz = plan["grid"]
    seen = np.zeros((gz, n, n), np.int64)
    for z in range(gz):
        for bi in range(gy):
            for ty in range(by):
                for r in range(rows):
                    i = (bi * by + ty) * rows + r
                    seen[z, i, :gx * bx] += 1
    np.testing.assert_array_equal(seen, 1)
    assert plan["thr"] == (b, 3, n + 1, flare.FLARE_STRIDE)
    assert plan["thr4"] == (b, n + 1, flare.FLARE_STRIDE, 4)
    assert flare.FLARE_STRIDE % 4 == 0 and flare.FLARE_STRIDE >= n + 1  # 16-byte rows


def test_flare_plan_mirrors_the_kernel_source():
    src = (CSRC / "flare.cu").read_text()
    (bx, by), rows = flare.FLARE_BLOCK, flare.FLARE_ROWS
    assert f"constexpr int BX = {bx}, BY = {by};" in src
    assert f"constexpr int ROWS = {rows};" in src
    assert f"constexpr int N = {flare.FLARE_MAP_SIZE};" in src
    assert f"constexpr int S = N + {flare.FLARE_STRIDE - flare.FLARE_MAP_SIZE};" in src


def test_flare_table_is_made_once_per_aspect_and_device():
    """One device copy per (aspect, device), reused by every call; its
    bytes are the kernel's FlareTaps: each tap's row of flare_taps rounded
    once to float32, padded with zeros to 16 bytes."""
    import ctypes

    cpu = torch.device("cpu")
    a = flare.flare_table(1.5, cpu)
    assert flare.flare_table(1.5, cpu) is a
    assert flare.flare_table(4 / 3, cpu) is not a
    assert a.numel() == ctypes.sizeof(flare._Taps) and a.numel() % 16 == 0
    vals = a.numpy().view(np.float32)
    taps = flare.flare_taps(1.5)
    at = 0
    for name, width in (("star", 8), ("inner", 4), ("glow", 4), ("streak", 4)):
        rows = np.asarray(taps[name], np.float64).astype(np.float32)
        got = vals[at:at + rows.shape[0] * width].reshape(-1, width)
        np.testing.assert_array_equal(got[:, :rows.shape[1]], rows)
        np.testing.assert_array_equal(got[:, rows.shape[1]:], 0.0)
        assert getattr(flare._Taps, name).offset == 4 * at
        at += rows.shape[0] * width
    assert vals[at] == np.float32(1.5)
    assert vals[at + 1] == np.float32(1.0 / taps["total_w"])


def padded_map(thr: torch.Tensor) -> torch.Tensor:
    """The threshold map as the kernel stores it: (3, N + 1, FLARE_STRIDE),
    column N and row N repeating the last ones."""
    n = thr.shape[-1]
    out = thr.new_zeros((3, n + 1, flare.FLARE_STRIDE))
    out[:, :n, :n] = thr
    out[:, :n, n] = thr[:, :, n - 1]
    out[:, n, :n + 1] = out[:, n - 1, :n + 1]
    return out


def kernel_floor(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """csrc/flare.cu `axis`'s floor: t = x + 1.5 * 2^23 rounded down, then
    (t - 1.5 * 2^23, bits(t) - bits(1.5 * 2^23)); the round-down add is
    taken exactly (x is float32, the sum's ulp is 1)."""
    magic = np.float32(12582912.0)
    t = (np.floor(x.astype(np.float64)) + 12582912.0).astype(np.float32)
    return t - magic, t.view(np.int32) - magic.view(np.int32)


def test_kernel_floor_is_floor_on_the_axis_range():
    """On [-0.5, N - 0.5], where `axis` takes it, the bit trick gives
    floor(x) as a float and as an integer: at every integer and its
    neighbouring floats, and at random points."""
    n = flare.FLARE_MAP_SIZE
    k = np.arange(-1, n + 1, dtype=np.float32)
    x = np.concatenate([k, np.nextafter(k, np.float32(-1e9)), np.nextafter(k, np.float32(1e9)),
                        np.random.default_rng(0).uniform(-0.5, n - 0.5, 100000).astype(np.float32),
                        np.float32([-0.5, -2.0 ** -25, 0.0, 2.0 ** -25, n - 0.5])])
    x = x[(x >= -0.5) & (x <= n - 0.5)]
    x0, xi = kernel_floor(x)
    np.testing.assert_array_equal(x0, np.floor(x))
    np.testing.assert_array_equal(xi, np.floor(x).astype(np.int64))


def test_padded_map_taps_sample_as_the_plain_version():
    """A mirror of the kernel's tap (saturated uv, one fma to texel space,
    the floor above, the low index clamp only, the four texels of the padded
    map) equals `_bilinear_uv` bit for bit, uv inside and outside [0, 1]:
    at x0 = -1 both read texels 0 and 1 (JAX's rule), at the right and
    bottom edges the padding repeats the last texel."""
    g = torch.Generator().manual_seed(0)
    n = flare.FLARE_MAP_SIZE
    thr = torch.rand((3, n, n), generator=g)
    u = torch.rand(200000, generator=g) * 1.4 - 0.2
    v = torch.rand(200000, generator=g) * 1.4 - 0.2
    edge = torch.tensor([0.0, 1.0, 0.5 / n, 0.99 / n, 511.6 / n, 1.0 - 1e-7])
    u = torch.cat([u, edge, edge.flip(0)])
    v = torch.cat([v, edge.flip(0), edge])
    want = flare._bilinear_uv(thr, u, v)

    def axis(c: torch.Tensor):
        x = (torch.clamp(c, 0.0, 1.0) * n - 0.5).numpy()  # the fma: c * 512 is exact
        x0, xi = kernel_floor(x)
        return torch.from_numpy(np.maximum(xi, 0)), torch.from_numpy(x - x0)

    (xi, fx), (yi, fy) = axis(u), axis(v)
    flat = padded_map(thr).reshape(3, -1)

    def tex(dy, dx):
        return flat[:, (yi + dy) * flare.FLARE_STRIDE + xi + dx]

    got = mix(mix(tex(0, 0), tex(0, 1), fx), mix(tex(1, 0), tex(1, 1), fx), fy)
    assert torch.equal(got, want)


# ---- grade: mod360 --------------------------------------------------------

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


# ---- blur ----------------------------------------------------------------

BLUR_SIZES = [(1000, 1503), (17, 1025), (5, 7), (1, 1), (63, 127), (129, 33)]
BLUR_RADII = [(4, 14, 31, 152), (14,), (4,), (1, 2, 3, 16), (17,), (6, 21, 47, 237)]


def blur_written(plan: dict, n: int, m: int) -> dict:
    """{level: how often the kernels' index mapping writes each (row, col)}:
    fused blocks (bx, by) write rows ys + ob * F_STEP + rg * KB + k, columns
    bx * FX + col, for each output block ob of their strip; two-pass V
    blocks write rows ys + st * V_STEP + warp * KB + k, column bx * V_COLS +
    lane, for each step of their strip."""
    counts = {g: np.zeros((n, m), np.int64) for g in range(len(plan["radii"]))}

    def add(g, ys, xs):
        ys, xs = ys[ys < n], xs[xs < m]
        np.add.at(counts[g], (ys[:, None], xs[None]), 1)

    kb = blur.KB
    if plan["fused"]:
        strip, tx = plan["fused_tile"]
        gx, gy, _ = plan["fused_grid"]
        for by in range(gy):
            ys = by * strip
            nob = -(-min(strip, n - ys) // blur.F_STEP)
            rows = (ys + np.arange(nob)[:, None, None] * blur.F_STEP
                    + np.arange(blur.F_STEP // kb)[None, :, None] * kb + np.arange(kb)).ravel()
            for g in plan["fused"]:
                add(g, rows, np.arange(gx * tx))
    if plan["two_pass"]:
        strip, vc = plan["v_tile"]
        gx, gy, _ = plan["v_grid"]
        for by in range(gy):
            ys = by * strip
            steps = -(-min(strip, n - ys) // blur.V_STEP)
            rows = (ys + np.arange(steps)[:, None, None] * blur.V_STEP
                    + np.arange(blur.V_STEP // kb)[None, :, None] * kb + np.arange(kb)).ravel()
            for g in plan["two_pass"]:
                add(g, rows, np.arange(gx * vc))
    return counts


@pytest.mark.parametrize("n,m", BLUR_SIZES)
@pytest.mark.parametrize("radii", BLUR_RADII, ids=lambda r: "-".join(map(str, r)))
def test_blur_plan_writes_every_pixel_of_every_level_once(n, m, radii):
    plan = blur.blur_launch_plan(3, n, m, radii)
    assert sorted(plan["fused"] + plan["two_pass"]) == list(range(len(radii)))
    for g, counts in blur_written(plan, n, m).items():
        np.testing.assert_array_equal(counts, 1, err_msg=f"level {g} r={radii[g]}")
    if plan["two_pass"]:
        # the H pass writes each scratch pixel of each two-pass plane once
        th, tw = plan["h_tile"]
        gx, gy, gz = plan["h_grid"]
        assert gz == 3 * len(plan["two_pass"])
        assert (gx * tw >= m > (gx - 1) * tw) and (gy * th >= n > (gy - 1) * th)


def test_blur_plan_smem_within_limit_at_every_radius():
    """Radii 1..300 as the largest of 1-4 levels, the others fused (the
    most weight rows the fused stage holds)."""
    for r in range(1, 301):
        for levels in range(1, 5):
            radii = (r,) + tuple(range(1, levels))
            plan = blur.blur_launch_plan(6, 4096, 6144, radii)
            for key in ("fused_smem", "h_smem", "v_smem"):
                assert plan.get(key, 0) <= blur.SMEM_LIMIT, (radii, key)
    # four levels at the threshold would pass the limit fused: the plan
    # gives some of them two passes, and the others fit
    big = blur.blur_launch_plan(6, 4096, 6144, (blur.FUSED_MAX_RADIUS,) * 4)
    assert big["fused"] and big["two_pass"]
    assert big["fused_smem"] <= blur.SMEM_LIMIT


def test_blur_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="passes"):
        blur.blur_launch_plan(3, 4096, 6144, (2000,))


@pytest.mark.parametrize("radii", BLUR_RADII + [(1,), (8,), (9,), (16, 1), (16,) * 4],
                         ids=lambda r: "-".join(map(str, r)))
def test_blur_fused_stage_covers_every_tap(radii):
    _check_fused_stage(radii)


def _check_fused_stage(radii, n: int = 300, m: int = 400) -> None:
    """Each fused level's H chunks read stage columns off .. off + FX + tp - 1
    (the zero-weight padding included), off = col_halo(R) - r, and stage
    rows R - r on; its V pass of output
    block ob runs `delay` steps after the step that staged the block's first
    source rows, when H has written every ring entry it reads, and its ring
    still holds them (the same step's H pass writes F_STEP entries ahead)."""
    plan = blur.blur_launch_plan(3, n, m, radii)
    for g in plan["two_pass"]:
        assert plan["v_ring"] >= 2 * blur.V_STEP + blur.padded_taps(radii[g])
    if not plan["fused"]:
        return
    strip, tx = plan["fused_tile"]
    sw = plan["fused_stage_w"]
    big_r = max(radii[g] for g in plan["fused"])
    assert strip % blur.F_STEP == 0 and tx == blur.FX and sw % 2 == 1
    assert sw <= blur.F_STAGE_W
    for i, g in enumerate(plan["fused"]):
        r, tp = radii[g], blur.padded_taps(radii[g])
        ring, delay = plan["fused_rings"][i], plan["fused_delays"][i]
        assert r <= blur.FUSED_MAX_RADIUS and tp >= 2 * r + 1 and tp % blur.KB == 0
        off = big_r - r
        # the last chunk's 2KB-1 inputs of the last warp's column block
        coff = blur.col_halo(big_r) - r
        assert coff >= 0 and blur.col_halo(big_r) % 4 == 0
        assert coff + (tx - blur.KB) + (tp - blur.KB) + 2 * blur.KB - 1 <= sw
        for ob in range(4):
            st = ob + delay
            written = (st + 1) * blur.F_STEP - off  # entries [0, written) after step st
            need_lo, need_hi = ob * blur.F_STEP, ob * blur.F_STEP + blur.F_STEP + tp - 1
            assert need_hi <= written
            assert written - ring <= need_lo  # nothing V reads is overwritten yet
        assert ring >= blur.KB and ring & (ring - 1) == 0
    if len(radii) == 4 and len(set(radii)) == 1:
        assert plan["two_pass"], "four levels at the threshold do not fit fused"


def test_blur_plan_splits_the_24mp_pyramid_as_perf_md_says():
    """24 MP documents: sharpness, tonal, clarity, structure = 4, 14, 31,
    152. The small two fuse, the large two take two passes; config 3's
    tonal level and config 5's sharpness level are fused alone."""
    plan = blur.blur_launch_plan(3, 4096, 6144, (4, 14, 31, 152))
    assert (plan["fused"], plan["two_pass"]) == ([0, 1], [2, 3])
    assert plan["fused_tile"] == (blur.FUSED_STRIP, 128) and plan["v_tile"] == (512, 32)
    for doc, want in ((chip_smoke.CONFIG3_DOC, (14,)), (chip_smoke.CONFIG5_DOC, (4,))):
        radii = tuple(fused.blur_radii(parse_adjustments(doc)[1], 6144, 4096).values())
        assert radii == want
        assert blur.blur_launch_plan(6, 4096, 6144, radii)["two_pass"] == []


def test_blur_plan_mirrors_the_kernel_source():
    """blur.py's shape constants are blur.cu's, and ctypes' _Plan lists
    BlurPlan's fields in the same order."""
    import re

    src = (CSRC / "blur.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["KB"] == str(blur.KB) and consts["SMEM_MAX"] == str(blur.SMEM_LIMIT)
    nt, nw = int(consts["NT"]), int(consts["NT"]) // 32
    assert blur.FX == nw * blur.KB and blur.V_STEP == nw * blur.KB and nt == 256
    assert consts["HROWS"] == str(blur.H_ROWS) and consts["VC"] == str(blur.V_COLS)
    assert consts["FSTEP"] == str(blur.F_STEP) and blur.F_STEP % nw == 0
    assert 32 * 4 * int(consts["FCH"]) - 1 == blur.F_STAGE_W
    body = src[src.index("struct BlurPlan {"):]
    body = "\n".join(line.split("//")[0] for line in body[:body.index("};")].splitlines()[1:])
    fields = re.findall(r"(\w+)(?:\[MAX_LEVELS\])?\s*[,;]", body)
    assert fields == [f for f, _ in blur._Plan._fields_]


def _conv_valid(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """'Valid' 1-D convolution of (C, H, W) along axis 0 (H) or 1 (W) with
    the (tp,) weights, taps in order, in float64."""
    c = x.shape[0]
    shape = (c, 1, 1, -1) if axis == 1 else (c, 1, -1, 1)
    k = w.reshape(1, 1, *shape[2:]).expand(c, 1, *w.reshape(shape[2:]).shape)
    return torch.nn.functional.conv2d(x[None].double(), k.double(), groups=c)[0]


def _weights(r: int) -> torch.Tensor:
    w = torch.zeros(blur.padded_taps(r), dtype=torch.float64)
    w[: 2 * r + 1] = torch.from_numpy(blur._gauss_weights(r)).double()
    return w


def emulate_blur(x: torch.Tensor, plan: dict) -> list:
    """The kernel's tiling on the CPU, from the plan alone."""
    c, n, m = x.shape
    radii, kb, fmax = plan["radii"], blur.KB, blur.F16_MAX
    out = [torch.full((c, n, m), float("nan"), dtype=torch.float64) for _ in radii]

    def put(g, ys, xs, val):
        ky, kx = ys < n, xs < m
        dst = out[g][:, ys[ky]][:, :, xs[kx]]
        assert torch.isnan(dst).all(), "a pixel written twice"
        rows = val[:, ky][:, :, kx]
        out[g][:, ys[ky][:, None], xs[kx][None]] = rows

    def ring_conv(buf, a, ring, w, tp):
        """KB rows from `a` of a ring (entries on axis 1), as the kernel's
        `conv` walks it: chunks of KB taps, two runs of entries each."""
        acc = torch.zeros((c, kb, buf.shape[2]), dtype=torch.float64)
        i0 = a % ring
        for t0 in range(0, tp, kb):
            i1 = i0 + kb - ring if i0 + kb >= ring else i0 + kb
            v = torch.cat([buf[:, i0 : i0 + kb], buf[:, i1 : i1 + kb - 1]], 1)
            for kk in range(kb):
                acc += w[t0 + kk] * v[:, kk : kk + kb]
            i0 = i1
        return acc

    if plan["fused"]:
        strip, tx = plan["fused_tile"]
        sw, fs = plan["fused_stage_w"], blur.F_STEP
        gx, gy, _ = plan["fused_grid"]
        big_r = max(radii[g] for g in plan["fused"])
        for by in range(gy):
            for bx in range(gx):
                ys, x0 = by * strip, bx * tx
                cols = torch.clamp(x0 - blur.col_halo(big_r) + torch.arange(sw), 0, m - 1)
                rings = {g: torch.full((c, plan["fused_rings"][i], tx), float("nan"),
                                       dtype=torch.float64)
                         for i, g in enumerate(plan["fused"])}
                nob = -(-min(strip, n - ys) // fs)
                for st in range(nob + max(plan["fused_delays"])):
                    rows = torch.clamp(ys - big_r + st * fs + torch.arange(fs), 0, n - 1)
                    stage = x[:, rows][:, :, cols].clamp(0.0, fmax).double()
                    for i, g in enumerate(plan["fused"]):
                        r, tp, ring = radii[g], blur.padded_taps(radii[g]), plan["fused_rings"][i]
                        off, coff = big_r - r, blur.col_halo(big_r) - r
                        win = stage[:, :, coff : coff + tx + tp - 1]
                        assert win.shape[2] == tx + tp - 1
                        h = torch.clamp(_conv_valid(win, _weights(r), 1), max=fmax)
                        e = st * fs + torch.arange(fs) - off
                        keep = e >= 0
                        rings[g][:, e[keep] % ring] = h[:, keep]
                    for i, g in enumerate(plan["fused"]):
                        ob = st - plan["fused_delays"][i]
                        if 0 <= ob < nob:
                            for rg in range(fs // kb):
                                a = ob * fs + rg * kb
                                acc = ring_conv(rings[g], a, plan["fused_rings"][i],
                                                _weights(radii[g]), blur.padded_taps(radii[g]))
                                put(g, ys + a + torch.arange(kb), x0 + torch.arange(tx), acc)
    if plan["two_pass"]:
        th, tw = plan["h_tile"]
        strip, vc = plan["v_tile"]
        ring = plan["v_ring"]
        for g in plan["two_pass"]:
            r, tp = radii[g], blur.padded_taps(radii[g])
            w = _weights(r)
            tmp = torch.full((c, n, m), float("nan"), dtype=torch.float64)
            gx, gy, _ = plan["h_grid"]
            for by in range(gy):
                for bx in range(gx):
                    y0, x0 = by * th, bx * tw
                    rows = torch.clamp(y0 + torch.arange(th), 0, n - 1)
                    cols = torch.clamp(x0 - r + torch.arange(tw + tp - 1), 0, m - 1)
                    s = x[:, rows][:, :, cols].clamp(0.0, fmax).double()
                    h = torch.clamp(_conv_valid(s, w, 1), max=fmax)
                    ys, xs = y0 + torch.arange(th), x0 + torch.arange(tw)
                    ky, kx = ys < n, xs < m
                    tmp[:, ys[ky][:, None], xs[kx][None]] = h[:, ky][:, :, kx]
            assert not torch.isnan(tmp).any()
            gx, gy, _ = plan["v_grid"]
            for by in range(gy):
                for bx in range(gx):
                    ys, x0 = by * strip, bx * vc
                    cols = torch.clamp(x0 + torch.arange(vc), 0, m - 1)
                    buf = torch.full((c, ring, vc), float("nan"), dtype=torch.float64)

                    def load(i0, i1):
                        i = torch.arange(i0, i1)
                        src = torch.clamp(ys - r + i, 0, n - 1)
                        buf[:, i % ring] = tmp[:, src][:, :, cols]

                    steps = -(-min(strip, n - ys) // blur.V_STEP)
                    load(0, blur.V_STEP + tp - 1)
                    for st in range(steps):
                        # the next step's rows may land before this step reads
                        if st + 1 < steps:
                            load((st + 1) * blur.V_STEP + tp - 1, (st + 2) * blur.V_STEP + tp - 1)
                        for wp in range(blur.V_STEP // kb):
                            a = st * blur.V_STEP + wp * kb
                            put(g, ys + a + torch.arange(kb), x0 + torch.arange(vc),
                                ring_conv(buf, a, ring, w, tp))
    return out


@pytest.mark.parametrize("shape,radii,tile", [
    ((3, 70, 90), (1, 3, 7), (64, 32)),
    ((2, 45, 300), (2, 5, 16, 17), None),
    ((1, 300, 70), (20, 33), None),
    ((1, 9, 11), (3, 40), None),
    ((1, 200, 40), (16, 16, 16, 16), (96, 32)),
])
def test_blur_emulated_tiling_equals_the_plain_version(monkeypatch, shape, radii, tile):
    """The kernel's tiling from the plan, with values outside [0, 65504]
    so the staging clamp matters. `tile` forces a short fused strip and a
    narrow block (the kernel's FX is 128; the emulation takes both from
    the plan), so strips and column blocks meet inside the image; V strips
    of 3 steps let the two-pass ring wrap within a strip."""
    if tile is not None:
        monkeypatch.setattr(blur, "FUSED_STRIP", tile[0])
        monkeypatch.setattr(blur, "FX", tile[1])
    monkeypatch.setattr(blur, "V_STRIP", 3 * blur.V_STEP)
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.random(shape) * 2.0 - 0.5).astype(np.float32))
    x[0, 0, 0], x[-1, shape[1] // 2, shape[2] // 2] = 9.0e4, -7.0
    plan = blur.blur_launch_plan(*shape, radii)
    if tile is not None:
        assert plan["fused_tile"] == tile and len(plan["fused"]) >= 3
    got = emulate_blur(x, plan)
    want = blur.gaussian_blur_multi_plain(x, radii)
    for r, a, b in zip(radii, got, want):
        assert not torch.isnan(a).any(), f"r={r}: a pixel never written"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=f"r={r}")


@pytest.mark.parametrize("h,w", SERVICE)
def test_plans_at_the_service_shapes(h, w):
    """The preview service's shapes (the grade and NR plans' coverage runs
    over them in the RAGGED cases above): NR's taps inside the staged tile
    at their resolution scale, and the blur plan of the radii each
    document takes there (config 3, config 5, every level) writing every
    pixel of every level once, within shared memory, its fused stage
    covering every tap."""
    for amounts in ((0.30, 0.25), (0.8, 0.6), (1.0, 1.0)):
        _check_nr_taps(amounts, h, w)
    for doc in (chip_smoke.CONFIG3_DOC, chip_smoke.CONFIG5_DOC, chip_smoke.FULL_DOC):
        radii = tuple(fused.blur_radii(parse_adjustments(doc)[1], h, w).values())
        for c in (3, 6):
            plan = blur.blur_launch_plan(c, h, w, radii)
            for key in ("fused_smem", "h_smem", "v_smem"):
                assert plan.get(key, 0) <= blur.SMEM_LIMIT
        plan = blur.blur_launch_plan(3, h, w, radii)
        for g, counts in blur_written(plan, h, w).items():
            np.testing.assert_array_equal(counts, 1, err_msg=f"level {g} r={radii[g]}")
        _check_fused_stage(radii, h, w)


# ---- the warp ------------------------------------------------------------

WARP_GEOMS = {
    "config5": chip_smoke.CONFIG5_GEOMETRY,
    "tca_rotate": chip_smoke.TCA_GEOMETRY,
    "perspective": {"transformVertical": 40.0, "transformHorizontal": -25.0,
                    "transformScale": 90.0, "transformAspect": -10.0},
}


def _vertical(src, ev, bv, pad_v, ys, ks, h, w):
    """The kernel's vertical pass at intermediate pixels (ys, ks) of the
    (P, h, w) planes `src`, in its float32 operations: 0 outside the
    source's columns and at rows y >= h (never read)."""
    ok = (ys < h) & (ks >= 0) & (ks < w)
    yc, kc = ys.clamp(0, h - 1), ks.clamp(0, w - 1)
    e = ev[yc, kc]
    e0 = torch.floor(e)
    frac = e - e0
    k0 = bv[yc // twf.TH, kc // twf.TWH].to(torch.int64) * 8 - pad_v + yc % twf.TH \
        + e0.clamp(-2.0**30, 2.0**30).to(torch.int64)

    def rows(k):
        return torch.where(ok & (k >= 0) & (k < h), src[:, k.clamp(0, h - 1), kc], 0.0)

    s0, s1 = rows(k0), rows(k0 + 1)
    return torch.where(ok, s0 + frac * (s1 - s0), 0.0)


def emulate_warp(imgs: torch.Tensor, arrays: dict, static, plan: dict):
    """The warp kernel's blocks on the CPU, from the plan: block (bx, by, z)
    takes set z's plane group bx mod ngroups and the TH-column tile bx div
    ngroups, stages the vertical pass at its rows and at the window of
    intermediate columns its lanes read (from its tile's e: within the
    set's `sw` columns from kb, its half tile's base), lerps the tile's
    outputs from the stage (a column outside it from the source), applies
    the post gain and writes its pixels of its group's planes. Returns the
    output and how often each value was written."""
    b, _, h, w = imgs.shape
    hp, wp = static.hp, static.wp
    rows, ngroups = plan["rows"], plan["ngroups"]
    gx, gy, gz = plan["grid"]
    assert gz == len(static.modes) == len(plan["sets"])
    src = imgs.reshape(b * 3, h, w)
    out = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int64)
    for z, st in enumerate(plan["sets"]):
        assert st["ch"] == static.modes[z][0] and st["sw"] == twf.TH + static.modes[z][2].span
        assert st["group"] <= plan["group"] and st["sw"] <= plan["sw_max"]
        ev, eh = arrays[f"ev{z}"], arrays[f"eh{z}"]
        bv = arrays[f"bv{z}"].reshape(hp // twf.TH, wp // twf.TWH)
        bh = arrays[f"bh{z}"].reshape(wp // twf.TH, hp // twf.TWH)
        for bx in range(gx):
            grp, xt = bx % ngroups, bx // ngroups
            if grp >= st["ngroups"]:
                continue
            first = grp * st["group"]
            cgs = range(first, min(first + st["group"], st["planes"]))
            planes = torch.tensor([cg // st["nc"] * 3 + st["ch"][cg % st["nc"]] for cg in cgs])
            psrc = src[planes]
            lanes = torch.arange(twf.TH)
            xs = xt * twf.TH + lanes
            for by in range(gy):
                y0 = by * rows
                ys = y0 + torch.arange(rows)
                kb = int(bh[xt, y0 // twf.TWH]) * 8 - st["pad_h"]
                ky, kx = ys < h, xs < w
                yy, xx = ys[ky][:, None], xs[kx][None, :]
                e = eh[xx, yy]
                e0 = torch.floor(e)
                frac = e - e0
                lc = lanes[kx][None, :] + e0.clamp(-2.0**30, 2.0**30).to(torch.int64)
                # the window: the staged columns (from kb) the tile's lanes
                # read, within the plan's sw
                band = (lc >= 0) & (lc + 1 < st["sw"])
                lo = int(lc[band].min()) if band.any() else 0
                hi = int(lc[band].max()) if band.any() else -1
                assert hi + 2 - lo <= st["sw"]
                # (two columns at least, read only where `staged`)
                stage = _vertical(psrc, ev, bv, st["pad_v"], ys[:, None],
                                  kb + lo + torch.arange(max(hi + 2 - lo, 2))[None, :], h, w)
                staged = (lc >= lo) & (lc <= hi)
                assert torch.equal(staged, band)
                yl, li = (yy - y0).expand_as(lc), (lc - lo).clamp(0, max(hi - lo, 0))

                def col(d):
                    return torch.where(staged, stage[:, yl, li + d],
                                       _vertical(psrc, ev, bv, st["pad_v"], yy.expand_as(lc),
                                                 kb + lc + d, h, w))

                t0, t1 = col(0), col(1)
                r = t0 + frac * (t1 - t0)
                if static.has_post:
                    r = r * arrays["post"][yy, xx]
                idx = (planes[:, None, None], yy[None], xx[None])
                out[idx] = r
                count[idx] += 1
    return out.reshape(imgs.shape), count.reshape(imgs.shape)


@pytest.mark.parametrize("geom,h,w,b", [
    ("config5", 64, 1024, 2), ("tca_rotate", 64, 1024, 2), ("config5", 100, 300, 1),
    ("perspective", 100, 300, 2), ("config5", 64, 1024, 4), ("tca_rotate", 100, 300, 5),
    ("config5", 512, 768, 1), ("config5", 480, 720, 1),
])
def test_warp_emulated_tiling_equals_the_plain_version(geom, h, w, b):
    """The kernel's tiling from warp_launch_plan writes every output value
    once and equals warp_with_plan_plain bit for bit: config 5's plan and
    the TCA plan (three sets), a ragged 100 x 300 (the pad and the crop),
    a perspective plan with its post gain, B = 4 (four groups of three
    planes), five TCA images a set (groups of three and two), and the
    thumbnails' and community previews' own warps: one image of config 5's
    geometry at the half-size frame of a 1024 x 1536 RAW file (no pad) and
    at 480 x 720."""
    plan = twf.plan_warp(tgeom(WARP_GEOMS[geom]), h, w, device="cpu")
    assert plan is not None
    st = plan.static
    assert st.has_post or geom != "perspective"
    x = torch.from_numpy(np.random.default_rng(h + w + b).random((b, 3, h, w), np.float32))
    lp = twf.warp_launch_plan(st, 3 * b)
    assert lp["group"] == min(3 * b // len(st.modes), twf.WARP_GROUP)
    got, count = emulate_warp(x, plan.arrays, st, lp)
    np.testing.assert_array_equal(count.numpy(), 1)
    want = twf.warp_with_plan_plain(x, plan.arrays, st)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _plan_ok(p) -> bool:
    """csrc/resample.cu's plan_ok, statement for statement: the plan the
    entry point accepts."""
    if not (1 <= p.nsets <= twf.MAX_SETS and 1 <= p.group <= twf.WARP_GROUP):
        return False
    if p.rows != twf.WARP_ROWS:
        return False
    if p.b < 1 or p.h < 1 or p.w < 1 or p.hp % 256 or p.wp % 256 or p.h > p.hp or p.w > p.wp:
        return False
    group = ngroups = sw_max = 0
    for s in p.set[:p.nsets]:
        if not 1 <= s.nc <= 3 or s.planes != p.b * s.nc or s.group < 1:
            return False
        if any(not 0 <= s.ch[j] <= 2 for j in range(s.nc)):
            return False
        if s.ngroups != -(-s.planes // s.group):
            return False
        if not 1 <= s.span_h <= twf.MAX_SPAN or s.sw != twf.TH + s.span_h:
            return False
        if s.pad_v < 0 or s.pad_h < 0:
            return False
        group, ngroups, sw_max = max(group, s.group), max(ngroups, s.ngroups), max(sw_max, s.sw)
    smem = 4 * (twf.TH * (p.rows + 1) + group * p.rows * sw_max)
    return (group == p.group and ngroups == p.ngroups and sw_max == p.sw_max and smem == p.smem
            and smem <= twf.SMEM_LIMIT and p.gx == -(-p.w // twf.TH) * ngroups
            and p.gy == -(-p.h // p.rows) and p.gz == p.nsets)


@pytest.mark.parametrize("geom,h,w,b", [
    ("config5", 512, 768, 0), ("config5", 1024, 1536, 0), ("config5", 480, 720, 0),
    ("config5", 524, 710, 1), ("tca_rotate", 100, 300, 5), ("perspective", 100, 300, 2),
])
def test_warp_args_are_a_plan_the_kernel_accepts(geom, h, w, b):
    """The wrapper's host side (`_warp_args`: everything warp_with_plan does
    before the launch) on the paths' own inputs: the thumbnails' and
    community previews' one (3, H, W) image (b = 0) of config 5's geometry
    at the half-size frame and the whole frame of a 1024 x 1536 file and
    at 480 x 720, phase 16's 524 x 710 preview, five TCA images, a
    perspective plan with its post gain. The packed plan is
    warp_launch_plan's and one the entry point's checks (`_plan_ok`)
    accept, every pointer is its array's, and a wrong image raises."""
    plan = twf.plan_warp(tgeom(WARP_GEOMS[geom]), h, w, device="cpu")
    assert plan is not None
    st = plan.static
    shape = (3, h, w) if b == 0 else (b, 3, h, w)
    x = torch.from_numpy(np.random.default_rng(h + w).random(shape, np.float32))
    imgs, packed, ptrs, post = twf._warp_args(x, plan.arrays, st)
    assert imgs.shape == (max(b, 1), 3, h, w) and imgs.is_contiguous()
    assert torch.equal(imgs.reshape(shape), x)
    assert _plan_ok(packed)
    lp = twf.warp_launch_plan(st, 3 * max(b, 1))
    assert (packed.nsets, packed.group, packed.ngroups, packed.rows, packed.sw_max,
            packed.smem) == (len(lp["sets"]), lp["group"], lp["ngroups"], lp["rows"],
                             lp["sw_max"], lp["smem"])
    assert (packed.gx, packed.gy, packed.gz) == lp["grid"]
    assert (packed.b, packed.h, packed.w, packed.hp, packed.wp) == (max(b, 1), h, w, st.hp,
                                                                   st.wp)
    for si, s in enumerate(lp["sets"]):
        got = packed.set[si]
        assert tuple(got.ch[:s["nc"]]) == s["ch"]
        for k in ("planes", "nc", "group", "ngroups", "pad_v", "pad_h", "span_h", "sw"):
            assert getattr(got, k) == s[k], k
        for k in ("ev", "bv", "eh", "bh"):
            assert getattr(ptrs, k)[si] == plan.arrays[f"{k}{si}"].data_ptr()
    assert (post is plan.arrays["post"]) if st.has_post else post is None
    with pytest.raises(ValueError, match="float32"):
        twf._warp_args(x.double(), plan.arrays, st)
    with pytest.raises(ValueError, match="float32"):
        twf._warp_args(x[..., :-1], plan.arrays, st)


def test_warp_plan_smem_within_limit_at_every_span():
    """Every span the planner admits (1 to MAX_SPAN) in either pass, one
    set of three channels or three TCA sets of one, 1 to 12 images (1 to
    36 planes a set): the staged tile fits SMEM_LIMIT, and the grid covers
    every column and row tile once per group."""
    for span in range(1, twf.MAX_SPAN + 1):
        for sv, sh in ((span, 8), (8, span)):
            pv, ph = (twf.PassStatic(span=s, band=-(-(twf.TH + s + 9) // 8) * 8, pad_lo=8,
                                     extent=4096, nty=128, ntx=24) for s in (sv, sh))
            for modes in ((((0, 1, 2), pv, ph),), tuple(((c,), pv, ph) for c in range(3))):
                st = twf.WarpStatic(p=None, h=4096, w=6144, hp=4096, wp=6144, modes=modes)
                for images in range(1, 13):
                    lp = twf.warp_launch_plan(st, 3 * images)
                    assert lp["smem"] <= twf.SMEM_LIMIT
                    assert lp["sw_max"] == twf.TH + sh and lp["group"] <= twf.WARP_GROUP
                    assert lp["grid"] == (192 * lp["ngroups"], 4096 // twf.WARP_ROWS, len(modes))
                    for s in lp["sets"]:
                        assert s["ngroups"] * s["group"] >= s["planes"] > (s["ngroups"] - 1) \
                            * s["group"]
    with pytest.raises(ValueError, match="3 planes"):
        twf.warp_launch_plan(st, 4)


def test_warp_plan_at_the_paths_shapes():
    """24 MP, B = 2 (config 5): two groups of three planes a tile; the TCA
    plan: one group of the two images a set; the community previews' 480 x
    720: one group, 345 blocks for the 132 streaming multiprocessors."""
    def plan(modes, h, w, images):
        ps = twf.PassStatic(span=33, band=80, pad_lo=8, extent=4096, nty=1, ntx=1)
        st = twf.WarpStatic(p=None, h=h, w=w, hp=-(-h // 256) * 256, wp=-(-w // 256) * 256,
                            modes=tuple((m, ps, ps) for m in modes))
        return twf.warp_launch_plan(st, 3 * images)

    big = plan([(0, 1, 2)], 4096, 6144, 2)
    assert (big["group"], big["ngroups"], big["grid"]) == (3, 2, (384, 128, 1))
    tca = plan([(0,), (1,), (2,)], 4096, 6144, 2)
    assert (tca["group"], tca["ngroups"], tca["grid"]) == (2, 1, (192, 128, 3))
    small = plan([(0, 1, 2)], 480, 720, 1)
    assert (small["group"], small["ngroups"], small["grid"]) == (3, 1, (23, 15, 1))
    assert small["smem"] == 4 * (twf.TH * (twf.WARP_ROWS + 1) + 3 * twf.WARP_ROWS * (twf.TH + 33))


def test_warp_plan_mirrors_the_kernel_source():
    """warp_fast's constants are resample.cu's, ctypes' structs list
    WarpSet's, WarpPlan's and WarpPtrs' fields in the same order, and the
    entry point checks the plan's sizes with the formulas warp_launch_plan
    uses."""
    import re

    src = (CSRC / "resample.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["TH"] == str(twf.TH) and consts["TWH"] == str(twf.TWH)
    assert consts["MAX_SPAN"] == str(twf.MAX_SPAN) and consts["MAX_SETS"] == str(twf.MAX_SETS)
    assert consts["MAX_GROUP"] == str(twf.WARP_GROUP)
    assert consts["SMEM_MAX"] == str(twf.SMEM_LIMIT)
    assert consts["ROWS"] == str(twf.WARP_ROWS) and twf.TWH % twf.WARP_ROWS == 0
    assert twf.TH * twf.WARP_ROWS % int(consts["NT"]) == 0  # the e tile's load steps

    def fields(name):
        body = src[src.index(f"struct {name} {{"):]
        body = "\n".join(line.split("//")[0] for line in body[:body.index("};")].splitlines()[1:])
        return re.findall(r"(\w+)(?:\[\w+\])?\s*;", body)

    assert fields("WarpSet") == [f for f, _ in twf._Set._fields_]
    assert fields("WarpPlan") == [f for f, _ in twf._Plan._fields_]
    assert fields("WarpPtrs") == [f for f, _ in twf._Ptrs._fields_]
    assert "4L * (TH * (p.rows + 1) + (long)group * p.rows * sw_max)" in src
    assert "s.sw != TH + s.span_h" in src and "p.gx == (p.w + TH - 1) / TH * ngroups" in src
