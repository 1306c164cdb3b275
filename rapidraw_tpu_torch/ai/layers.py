"""The flax layers the AI networks are built from, in plain PyTorch, and
the name table that carries the JAX package's flat-npz weights into them.

Each layer computes what its flax counterpart computes, in the same order
of operations, on NCHW tensors:

  * `Conv`: `nn.Conv` (padding 'SAME' as lax pads it, 'VALID', an int or
    explicit pairs; dilation; bias);
  * `ConvTranspose`: `nn.ConvTranspose` with `transpose_kernel=False`,
    which convolves the zero-dilated input with the kernel as stored; torch
    keeps the kernel with its taps flipped, (in, out, kh, kw);
  * `Dense` and `DenseGeneral`: `nn.Dense` and the multi-axis projections
    of `nn.MultiHeadDotProductAttention`;
  * `BatchNorm`: inference from running statistics,
    (x - mean) * (rsqrt(var + eps) * scale) + bias;
  * `LayerNorm`: flax's fast variance, E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias, epsilon 1e-6 by default
    (torch's is 1e-5).

Flax names a submodule it was not given a name for by its class and call
order (`Conv_0`, `REBNCONV_3`); the networks give their torch submodules
those same names, so the weights map by name. `flax_slots` lists every
npz key a module reads with its flax shape (the table a weights writer
keys its files by); `load_flat` consumes a flat
{'params/...': array, 'batch_stats/...': array} dict into a module and
raises on a key it does not consume and on a parameter it does not fill.

`exact_fp32` runs a forward with TF32 off for matmuls and cuDNN
convolutions (PyTorch runs cuDNN convolutions in TF32 by default) and
restores both flags after it.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def exact_fp32():
    """Float32 matmuls and convolutions without TF32, and no autograd; the
    process's flags are as they were after the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def fp32_forward(fn):
    """Decorate a network's forward: it runs under `exact_fp32`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with exact_fp32():
            return fn(*args, **kwargs)

    return wrapped


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(n: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """lax's 'SAME' padding of one axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv` on NCHW ('SAME', 'VALID' or an int padding);
    `weight` is (out, in, kh, kw)."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME", dilation=1, bias=True):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def _pads(self, h, w):
        p = self.padding
        if p == "VALID":
            return (0, 0), (0, 0)
        if p == "SAME":
            return (same_pads(h, self.kernel[0], self.stride[0], self.dilation[0]),
                    same_pads(w, self.kernel[1], self.stride[1], self.dilation[1]))
        return (p, p), (p, p)

    def forward(self, x):
        (t, b), (l, r) = self._pads(x.shape[-2], x.shape[-1])
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
            pad = 0
        return F.conv2d(x, self.weight, self.bias, self.stride, pad, self.dilation)

    def flax(self):
        return {"kernel": ("params", "weight", "conv")}


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (transpose_kernel=False) on NCHW: the input
    dilated by the stride, padded by `padding` ('SAME' or explicit (low,
    high) pairs, as lax pads it) and convolved with the flax kernel.
    torch's transposed convolution applies the kernel flipped, so `weight`
    holds it flipped, (in, out, kh, kw), and the pads become torch's
    padding k - 1 - low and output padding high - low."""

    def __init__(self, cin, cout, kernel, stride, padding="SAME", bias=True):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        pads = []
        for k, s, p in zip(self.kernel, self.stride,
                           padding if isinstance(padding, (tuple, list)) else (padding,) * 2):
            if p == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else -(-total // 2)
                p = (lo, total - lo)
            lo, hi = p
            if not (0 <= k - 1 - lo and 0 <= hi - lo < s):
                raise ValueError(f"ConvTranspose padding {p} has no torch form for k={k}, s={s}")
            pads.append((k - 1 - lo, hi - lo))
        self.torch_padding = tuple(p for p, _ in pads)
        self.output_padding = tuple(o for _, o in pads)
        self.weight = nn.Parameter(torch.zeros(cin, cout, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.torch_padding,
                                  self.output_padding)

    def flax(self):
        return {"kernel": ("params", "weight", "conv_transpose")}


class Dense(nn.Module):
    """flax `nn.Dense`; `weight` is (out, in)."""

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def flax(self):
        return {"kernel": ("params", "weight", "dense")}


class DenseGeneral(Dense):
    """flax `nn.DenseGeneral` between flattened axes: a kernel of shape
    in_shape + out_shape read as (prod(in), prod(out)), the bias of shape
    out_shape."""

    def __init__(self, in_shape, out_shape):
        super().__init__(math.prod(in_shape), math.prod(out_shape))
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)

    def flax(self):
        return {"kernel": ("params", "weight", "dense_general"),
                "bias": ("params", "bias", "dense_general_bias")}


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_running_average=True)` over channel axis 1."""

    def __init__(self, ch, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.var + self.eps) * self.weight
        return (x - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def flax(self):
        return {"scale": ("params", "weight", "copy"), "bias": ("params", "bias", "copy"),
                "mean": ("batch_stats", "mean", "copy"), "var": ("batch_stats", "var", "copy")}


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (fast variance)."""

    def __init__(self, ch, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    def flax(self):
        return {"scale": ("params", "weight", "copy"), "bias": ("params", "bias", "copy")}


def max_pool_same(x):
    """flax `max_pool((2, 2), strides=(2, 2), padding='SAME')`: an odd side
    pads at its end, so the output side is ceil(n / 2)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def gelu(x):
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Named(nn.Module):
    """A module whose unnamed children take flax's automatic names: the
    class name and the count of that class's children so far."""

    def auto(self, cls_name: str, module: nn.Module) -> nn.Module:
        counts = self.__dict__.setdefault("_flax_counts", {})
        n = counts.get(cls_name, 0)
        counts[cls_name] = n + 1
        self.add_module(f"{cls_name}_{n}", module)
        return module


# ---------------------------------------------------------------- carry-over
def _to_torch(kind: str, a: np.ndarray, leaf: nn.Module) -> np.ndarray:
    if kind == "conv":  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if kind == "conv_transpose":  # (kh, kw, in, out) -> (in, out, kh, kw), taps flipped
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "dense":  # (in, out) -> (out, in)
        return a.T
    if kind == "dense_general":
        return a.reshape(math.prod(leaf.in_shape), math.prod(leaf.out_shape)).T
    if kind == "dense_general_bias":
        return a.reshape(-1)
    return a


def _to_flax(kind: str, t: np.ndarray, leaf: nn.Module) -> np.ndarray:
    if kind == "conv":
        return t.transpose(2, 3, 1, 0)
    if kind == "conv_transpose":
        return t.transpose(2, 3, 0, 1)[::-1, ::-1]
    if kind == "dense":
        return t.T
    if kind == "dense_general":
        return t.T.reshape(leaf.in_shape + leaf.out_shape)
    if kind == "dense_general_bias":
        return t.reshape(leaf.out_shape)
    return t


def flax_slots(model: nn.Module) -> list:
    """Every npz key `model` reads: [(key, flax shape, module, attribute,
    kind)], in the module's own order."""
    slots = []
    for path, mod in model.named_modules():
        prefix = path.replace(".", "/")
        table = mod.flax() if hasattr(mod, "flax") else {}
        by_attr = {attr: (leaf, col, kind) for leaf, (col, attr, kind) in table.items()}
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for attr, t in tensors:
            if t is None:
                continue
            leaf, col, kind = by_attr.get(attr, (attr, "params", "copy"))
            shape = _to_flax(kind, np.zeros(tuple(t.shape), np.float32), mod).shape
            key = f"{col}/{prefix}/{leaf}" if prefix else f"{col}/{leaf}"
            slots.append((key, tuple(shape), mod, attr, kind))
    return slots


def load_flat(model: nn.Module, flat: dict, what: str) -> nn.Module:
    """Fill every parameter and buffer of `model` from the flat npz dict
    `flat`; raises ValueError on a key left over or a tensor not filled."""
    left = dict(flat)
    missing = []
    for key, shape, mod, attr, kind in flax_slots(model):
        if key not in left:
            missing.append(key)
            continue
        a = np.asarray(left.pop(key), np.float32)
        if a.shape != shape:
            raise ValueError(f"{what}: {key} has shape {a.shape}, the network wants {shape}")
        t = torch.from_numpy(np.ascontiguousarray(_to_torch(kind, a, mod)))
        getattr(mod, attr).data.copy_(t)
    if missing:
        raise ValueError(f"{what}: the weights fill no value for {len(missing)} tensors of the "
                         f"network: {missing[:8]}")
    if left:
        raise ValueError(f"{what}: the weights hold {len(left)} keys the network does not read: "
                         f"{sorted(left)[:8]}")
    return model
