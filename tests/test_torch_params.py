"""The port's NumPy parameter layer against the JAX package's.

parse_adjustments / merge_configs / is_image_edited must return the same
trees and configs, and the fixed param layout that the CUDA grade kernel
reads must cover every leaf of the parsed global params and round-trip.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from rapidraw_tpu.params import parse as jparse
from rapidraw_tpu_torch.params import parse as tparse
from rapidraw_tpu_torch.pipeline import fused

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def bench_docs() -> dict:
    """bench.py's _CONFIG*_DOC literals, evaluated without importing bench
    (its import renices the process)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    env = {"H": 4096, "W": 6144}
    docs = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", "")
            if name.startswith("_CONFIG") and name.endswith("_DOC"):
                docs[name] = eval(compile(ast.Expression(node.value), "bench.py", "eval"), env)
    return docs


BENCH = bench_docs()

MASK_DOC = {
    "exposure": 0.2,
    "masks": [
        {"visible": True, "adjustments": {"exposure": 0.5, "shadows": 10,
                                          "hsl": {"reds": {"hue": 4}}}},
        {"visible": False, "adjustments": {"clarity": 30}},
        {"visible": True, "adjustments": {"clarity": 20, "curves": {
            "luma": [{"x": 0, "y": 10}, {"x": 255, "y": 240}]}}},
    ],
}
HIDDEN_DOC = dict(chip_smoke.FULL_DOC, sectionVisibility={"color": False, "curves": False,
                                                         "details": False, "effects": False})

PARSE_CASES = {
    "config1": (BENCH["_CONFIG1_DOC"], False),
    "config3": (BENCH["_CONFIG3_DOC"], False),
    "config4": (BENCH["_CONFIG4_DOC"], False),
    "config5": (BENCH["_CONFIG5_DOC"], False),
    "full": (chip_smoke.FULL_DOC, False),
    "grain": (chip_smoke.GRAIN_DOC, False),
    "raw": (chip_smoke.RAW_DOC, True),
    "masks": (MASK_DOC, False),
    "hidden": (HIDDEN_DOC, False),
    "empty": ({}, False),
}


def trees_equal(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(trees_equal(a[k], b[k]) for k in a))
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.shape(v)


def test_chip_smoke_docs_are_the_bench_and_test_docs():
    from test_fused import FULL_DOC

    assert chip_smoke.CONFIG1_DOC == BENCH["_CONFIG1_DOC"]
    assert chip_smoke.CONFIG3_DOC == BENCH["_CONFIG3_DOC"]
    assert chip_smoke.CONFIG4_DOC == BENCH["_CONFIG4_DOC"]
    assert chip_smoke.FULL_DOC == FULL_DOC


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_matches_jax(case):
    doc, is_raw = PARSE_CASES[case]
    tp, tc = tparse.parse_adjustments(doc, is_raw=is_raw)
    jp, jc = jparse.parse_adjustments(doc, is_raw=is_raw)
    assert trees_equal(tp, jp)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize(
    "names",
    [("config3", "full"), ("config1", "grain"), ("config4", "config3", "hidden"),
     ("masks", "config1", "grain"), ("empty",)],
)
def test_merge_configs_matches_jax(names):
    tcs = [tparse.parse_adjustments(*PARSE_CASES[n])[1] for n in names]
    jcs = [jparse.parse_adjustments(*PARSE_CASES[n])[1] for n in names]
    assert dataclasses.asdict(tparse.merge_configs(tcs)) == dataclasses.asdict(
        jparse.merge_configs(jcs)
    )


def test_merge_configs_rejects_mixed_tonemappers_like_jax():
    docs = [BENCH["_CONFIG1_DOC"], BENCH["_CONFIG3_DOC"]]
    for mod in (tparse, jparse):
        with pytest.raises(ValueError):
            mod.merge_configs([mod.parse_adjustments(d)[1] for d in docs])


@pytest.mark.parametrize("doc", [
    None, {}, {"exposure": 0}, {"exposure": 0.5}, {"crop": {"x": 10, "y": 0}},
    {"transformRotate": 2.0}, {"masks": [{"visible": True}]}, {"toneMapper": "agx"},
    {"sectionVisibility": {"basic": False}, "exposure": 1.0},
])
def test_is_image_edited_matches_jax(doc):
    assert tparse.is_image_edited(doc) == jparse.is_image_edited(doc)


def test_layout_covers_every_global_leaf():
    want = dict(leaves(tparse.parse_adjustments(chip_smoke.FULL_DOC)[0]["glob"]))
    got = {path: shape for path, shape in fused.LAYOUT}
    assert got == want
    assert fused.K == sum(int(np.prod(s)) for s in want.values())


def test_param_bridge_round_trips():
    docs = [chip_smoke.FULL_DOC, chip_smoke.GRAIN_DOC, BENCH["_CONFIG3_DOC"]]
    parsed = [tparse.parse_adjustments(d) for d in docs]
    globs = [p["glob"] for p, _ in parsed]
    stacked = {path: np.stack([np.asarray(fused._leaf(g, path)) for g in globs])
               for path, _ in fused.LAYOUT}
    nested: dict = {}
    for path, v in stacked.items():
        node = nested
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(v)
    pmat = fused.pack_rows(nested)
    assert pmat.shape == (3, fused.K) and pmat.dtype == torch.float32
    for i, g in enumerate(globs):
        back = fused.unpack_row(pmat[i])
        assert trees_equal({k: v.numpy() for k, v in leaves_tensors(back)},
                           {k: np.asarray(v, np.float32) for k, v in leaves_tensors(g)})


def leaves_tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_tensors(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_generated_header_names_every_offset_and_flag():
    header = fused.generated_header()
    for path, _ in fused.LAYOUT:
        name = "P_" + path.replace("/", "_").upper()
        assert f"#define {name} {fused.OFFSETS[path]}\n" in header
    for i, flag in enumerate(fused.FLAGS):
        assert f"#define F_{flag.upper()} (1u << {i})\n" in header
        assert isinstance(getattr(tparse.DevelopConfig(), flag), bool)
    assert f"#define P_K {fused.K}\n" in header


def test_flag_bits_follow_the_config():
    _, cfg = tparse.parse_adjustments(BENCH["_CONFIG3_DOC"])
    bits = fused.flag_bits(cfg)
    for i, flag in enumerate(fused.FLAGS):
        assert bool(bits >> i & 1) == getattr(cfg, flag)
