"""Shared fixtures of the AI port's tests: flax weights from the JAX
package's own init at narrow widths, every leaf moved by seeded noise (so
a swapped bias, a transposed table or a misread BatchNorm statistic shows
instead of hiding behind flax's zero and one inits), saved as the flat npz
both packages read."""

from __future__ import annotations

import numpy as np


def perturb(tree, seed: int):
    """A copy of a flax variables tree with every leaf moved by seeded
    noise: kernels by a tenth of their own spread, zero-initialized leaves
    (biases, position tables, BatchNorm means) by N(0, 0.05^2), norm scales
    and LayerScale by a tenth around their value, BatchNorm variances
    scaled by U(0.5, 1.5) (kept positive)."""
    rng = np.random.default_rng(seed)

    def go(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: go(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        spread = float(a.std()) if a.size > 1 else 0.0
        if spread > 0:
            return (a + 0.1 * spread * rng.standard_normal(a.shape)).astype(np.float32)
        if np.all(a == 0):
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        return (a + 0.1 * np.abs(a).mean() * rng.standard_normal(a.shape)).astype(np.float32)

    return go(tree, ())


# the leaves flax draws from N(0, 1) (SAM's prompt encoder and tokens)
NORMAL_INIT = ("pe_gaussian", "point_embeddings", "not_a_point_embed", "no_mask_embed",
               "iou_token", "mask_tokens")


def seeded_tree(shapes, seed: int):
    """Seeded weights on a tree of shapes (jax.eval_shape of an init) for
    a network whose init is too slow to compile in a test: kernels from
    N(0, 1) / sqrt(fan-in), other vectors and tables as `perturb` moves
    flax's zero and one inits."""
    rng = np.random.default_rng(seed)

    def go(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: go(v, path + (k,)) for k, v in node.items()}
        shape, leaf = tuple(node.shape), path[-1]
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "scale" or (leaf == "weight" and len(shape) == 1):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf in ("ls1", "ls2"):
            a = 0.5 + 0.1 * rng.standard_normal(shape)
        elif leaf in NORMAL_INIT:
            a = rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return go(shapes, ())


def flatten(tree) -> dict:
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node, np.float32)

    walk(tree, "")
    return flat


def flatten_shapes(tree) -> dict:
    """{'params/...': leaf} of a tree whose leaves are shape structs."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = node

    walk(tree, "")
    return flat


def save(tree, path) -> dict:
    """Save a variables tree as the flat npz both packages load; returns
    the flat dict."""
    flat = flatten(tree)
    np.savez(path, **flat)
    return flat


def rand_image(h=40, w=56, seed=0):
    return np.random.default_rng(seed).random((3, h, w)).astype(np.float32)


def max_rel(ref, got) -> float:
    """max |ref - got| over the reference's span."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    span = max(float(ref.max() - ref.min()), 1e-12)
    return float(np.abs(ref - got).max()) / span


def u8_close(ref, got, share: float = 1e-3) -> None:
    """u8 images within 1 LSB on at most `share` of the values."""
    ref = np.asarray(ref).astype(np.int16)
    got = np.asarray(got).astype(np.int16)
    assert ref.shape == got.shape
    d = np.abs(ref - got)
    assert d.max() <= 1, int(d.max())
    assert (d > 0).mean() <= share, float((d > 0).mean())
