"""The port's AI entries on the vendored goldens (tests/fixtures/ai_vendored),
at the published widths.

Each case installs the JAX package's deterministic vendored weights
(tools/make_vendored_goldens.install_vendored_weights: flax's seeded init
through the checkpoint converter into the flat npz), runs the port's
public entry on the fixed input of `make_vendored_goldens.runners()` on
the CPU, and holds the summary statistics and the strided sample to the
committed golden with tests/test_ai_vendored.py's own tolerance. Each case
spends most of its 20-45 s in flax's init of the published widths.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TOOLS = Path(__file__).resolve().parent.parent / "tools"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "ai_vendored"
sys.path.insert(0, str(TOOLS))

torch.set_num_threads(4)


def port_runners(mv):
    """make_vendored_goldens.runners() on the port's entries."""
    from rapidraw_tpu_torch.ai import denoise, depth, inpaint, masks, sam

    def sam_decoder():
        rng = np.random.default_rng(5)
        emb = rng.normal(0, 1, (1, 64, 64, 256)).astype(np.float32)
        e = sam.ImageEmbeddings(embeddings=torch.from_numpy(emb), original_size=(128, 128))
        return {"mask": sam.run_sam_decoder(e, (30, 40), (90, 100))}

    def lama():
        img = mv._input_image(6)
        mask = np.zeros(img.shape[1:], np.float32)
        mask[30:60, 40:80] = 1.0
        return {"out": inpaint.run_lama_inpainting(img, mask, device="cpu").numpy()}

    return {
        "nind_denoise": lambda: {"out": denoise.denoise_ai(mv._input_image(1), quality=0.5,
                                                           device="cpu").numpy()},
        "u2net_foreground": lambda: {"mask": masks.generate_foreground_mask(mv._input_image(2),
                                                                            device="cpu")},
        "sam_decoder": sam_decoder,
        "lama_inpaint": lama,
        "depth_anything_v2": lambda: {"depth": depth.generate_depth_map(mv._input_image(4),
                                                                        device="cpu")},
    }


@pytest.mark.parametrize("model", sorted(p.stem for p in FIXTURES.glob("*.json")))
def test_port_vendored_parity(model, tmp_path, monkeypatch):
    import make_vendored_goldens as mv

    from rapidraw_tpu_torch.ai import masks

    monkeypatch.setenv("RAPIDRAW_MODELS", str(tmp_path))
    monkeypatch.setenv("RAPIDRAW_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(masks, "_weights_cache", {})
    mv.install_vendored_weights(model, tmp_path)
    got = {k: mv.golden_for(v) for k, v in port_runners(mv)[model]().items()}
    want = json.loads((FIXTURES / f"{model}.json").read_text())
    assert set(got) == set(want), model
    for key in want:
        g, w = got[key], want[key]
        assert g["shape"] == w["shape"], (model, key)
        assert g["dtype"] == w["dtype"], (model, key)
        # tests/test_ai_vendored.py's tolerance
        span = max(abs(w["q99"] - w["q01"]), 1e-3)
        tol = max(2e-3 * span, 2e-4)
        for stat in ("mean", "std", "q01", "q99"):
            assert abs(g[stat] - w[stat]) <= tol, (model, key, stat, g[stat], w[stat])
        gs = np.asarray(g["sample"], np.float64)
        ws = np.asarray(w["sample"], np.float64)
        assert gs.shape == ws.shape, (model, key)
        d = np.abs(gs - ws)
        assert np.quantile(d, 0.95) <= tol, (model, key, float(d.max()))
        assert d.max() <= max(0.02 * span, 5e-3), (model, key, float(d.max()))
