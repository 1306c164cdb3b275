"""Reading a `transformers` `save_pretrained` directory without
`transformers` or `safetensors`, and writing the safetensors format.

A CLIP checkpoint directory holds:

  * `config.json`: `text_config`, `vision_config` and `projection_dim`
    (the towers' widths; `read_config`);
  * the weights, in one of the forms `save_pretrained` writes
    (`read_state`): `model.safetensors`; shards named by
    `model.safetensors.index.json`; `pytorch_model.bin` (read with
    `torch.load(weights_only=True)`) or shards named by
    `pytorch_model.bin.index.json`;
  * the tokenizer's `vocab.json`, `merges.txt`, `tokenizer_config.json`
    and `special_tokens_map.json` (ai/clip_tokenizer.py reads them).

A safetensors file is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}} and the tensors' little-endian bytes, offsets counted from the end
of the header. F32, F16 and BF16 tensors come up as float32, as
`CLIPModel.from_pretrained` without `torch_dtype` computes; I64 tensors
(the `position_ids` buffers of older checkpoints) stay int64.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
TORCH_BIN_INDEX = "pytorch_model.bin.index.json"

# safetensors dtype -> little-endian numpy dtype of the stored bytes
_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8"}


def read_config(d: str | Path) -> dict:
    """The checkpoint's `config.json` as a dict."""
    return json.loads((Path(d) / "config.json").read_text())


def _as_float32(raw: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "BF16":  # the high half of a float32
        wide = raw.astype(np.uint32)
        wide <<= 16  # in place: a 0-d array stays an array
        return wide.view(np.float32)
    return raw.astype(np.float32)


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, floating ones as float32."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: safetensors header runs past the end of the file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {dtype}, which is not read here")
        begin, end = info["data_offsets"]
        np_dtype = np.dtype(_DTYPES[dtype])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or end > len(body):
            raise ValueError(f"{path}: tensor {name}'s offsets do not fit its shape")
        raw = np.frombuffer(body, np_dtype, count, begin).reshape(shape)
        arr = raw.astype(np.int64) if dtype == "I64" else _as_float32(raw, dtype)
        out[name] = torch.from_numpy(arr)  # astype copied it out of the file's bytes
    return out


def write_safetensors(path: str | Path, tensors: dict) -> None:
    """Write `tensors` ({name: float32 array or tensor}) as one safetensors
    file: the header padded with spaces to 8 bytes, then the tensors back to
    back by name, as the safetensors library lays them out."""
    arrays = {}
    for name, t in tensors.items():
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if a.dtype != np.float32:
            raise ValueError(f"tensor {name}: dtype {a.dtype} is not written here (float32 only)")
        arrays[name] = a
    header: dict = {"__metadata__": {"format": "pt"}}
    chunks, offset = [], 0
    for name in sorted(arrays):
        b = np.ascontiguousarray(arrays[name], "<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(arrays[name].shape),
                        "data_offsets": [offset, offset + len(b)]}
        chunks.append(b)
        offset += len(b)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for c in chunks:
            f.write(c)


def _read_bin(path: Path) -> dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.is_floating_point() else v) for k, v in state.items()}


def _shards(d: Path, index: str) -> list[Path]:
    weight_map = json.loads((d / index).read_text())["weight_map"]
    return [d / f for f in sorted(set(weight_map.values()))]


def read_state(d: str | Path) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors by their `transformers` names, floating ones
    as float32, from whichever weights form the directory holds (single
    safetensors first, as `from_pretrained` prefers it)."""
    d = Path(d)
    if (d / SAFETENSORS).is_file():
        return read_safetensors(d / SAFETENSORS)
    if (d / SAFETENSORS_INDEX).is_file():
        state = {}
        for shard in _shards(d, SAFETENSORS_INDEX):
            state.update(read_safetensors(shard))
        return state
    if (d / TORCH_BIN).is_file():
        return _read_bin(d / TORCH_BIN)
    if (d / TORCH_BIN_INDEX).is_file():
        state = {}
        for shard in _shards(d, TORCH_BIN_INDEX):
            state.update(_read_bin(shard))
        return state
    raise OSError(f"{d} holds none of {SAFETENSORS}, {SAFETENSORS_INDEX}, {TORCH_BIN}, "
                  f"{TORCH_BIN_INDEX}")
