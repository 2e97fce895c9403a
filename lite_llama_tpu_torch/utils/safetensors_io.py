"""A safetensors reader and writer of the port's own (the card's installation
has no ``safetensors`` package, and ``safetensors.numpy`` has no bf16).

The format: 8 bytes, a little-endian u64 N; N bytes of JSON,
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings, padded with spaces to a multiple of
8; then the tensors' raw little-endian bytes, offsets counted from the end
of the header.

:func:`load_file` memory-maps the file and returns tensors in their stored
dtype (bf16 stays bf16, ``F8_E4M3`` is ``torch.float8_e4m3fn``); on the CPU
they alias the mapping (copy on write), on another device each is copied
there. :func:`save_file` writes what ``safetensors.torch.save_file`` writes,
byte for byte: tensors ordered by dtype size, then name. :func:`save_sharded`
writes HF's shards and ``model.safetensors.index.json``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# Stored name -> (torch dtype, numpy view of the same width). In the
# safetensors writer's order: tensors of a later entry come first.
_DTYPES = {
    "BOOL": (torch.bool, np.bool_),
    "U8": (torch.uint8, np.uint8),
    "I8": (torch.int8, np.int8),
    "F8_E5M2": (torch.float8_e5m2, np.uint8),
    "F8_E4M3": (torch.float8_e4m3fn, np.uint8),
    "I16": (torch.int16, np.int16),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I32": (torch.int32, np.int32),
    "F32": (torch.float32, np.float32),
    "F64": (torch.float64, np.float64),
    "I64": (torch.int64, np.int64),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}
INDEX_FILE = "model.safetensors.index.json"
HF_METADATA = {"format": "pt"}  # what HF's save_pretrained writes


def read_header(path: str):
    """(header dict without ``__metadata__``, metadata or None, data start)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, in its stored dtype, on
    ``device``."""
    header, _, start = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({', '.join(_DTYPES)})")
        tdt, ndt = _DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        raw = mm[start + b:start + e]
        if (start + b) % np.dtype(ndt).itemsize:
            raw = raw.copy()  # an unaligned tensor: numpy views need alignment
        t = torch.from_numpy(raw.view(ndt)).view(tdt).reshape(info["shape"])
        out[name] = t if torch.device(device).type == "cpu" else t.to(device)
    return out


def _raw_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"safetensors has no dtype for {t.dtype}")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device) to one safetensors file."""
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]], k))
    header, off = {}, 0
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    sizes = []
    for k in order:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        sizes.append(n)
        off += n
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            f.write(_raw_bytes(tensors[k]))


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir: str,
                 max_shard_bytes: int = 5 * 10**9) -> list:
    """Write ``tensors`` as HF does: one ``model.safetensors`` if they fit in
    ``max_shard_bytes``, else ``model-0000i-of-0000n.safetensors`` shards
    (tensors in the mapping's order, a shard closed before it would pass the
    limit) and ``model.safetensors.index.json``. Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    shards, cur, cur_bytes = [], {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        if cur and cur_bytes + n > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = t
        cur_bytes += n
    shards.append(cur)
    if len(shards) == 1:
        names = ["model.safetensors"]
    else:
        names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
                 for i in range(len(shards))]
    for name, shard in zip(names, shards):
        save_file(shard, os.path.join(out_dir, name), HF_METADATA)
    if len(shards) > 1:
        total = sum(t.numel() * t.element_size() for t in tensors.values())
        index = {"metadata": {"total_size": total},
                 "weight_map": {k: name for name, s in zip(names, shards) for k in s}}
        with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
            json.dump(index, f, indent=2)
    return [os.path.join(out_dir, n) for n in names]
