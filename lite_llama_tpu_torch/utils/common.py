"""Device, memory and model introspection helpers (port of
``lite_llama_tpu/utils/common.py``): ``detect_device``, ``device_info``,
``get_device_memory`` (from ``torch.cuda.mem_get_info``), ``count_tokens``
and ``get_model_type``."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

_MODEL_TYPES = ("llava", "qwen3", "qwen2", "llama")


def detect_device() -> str:
    """'gpu' when a CUDA device is present, else 'cpu'."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def device_info() -> List[Dict]:
    """Per-device kind and memory (bytes): in use (total minus free, every
    process's) and the device's total."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "kind": torch.cuda.get_device_name(i), "platform": "gpu",
                    "bytes_in_use": total - free, "bytes_limit": total})
    return out


def get_device_memory(device_index: int = 0) -> Optional[Dict[str, float]]:
    """{"used_gb", "total_gb"} of one card, or None without it."""
    infos = device_info()
    if device_index >= len(infos):
        return None
    info = infos[device_index]
    gb = 1024.0**3
    return {"used_gb": info["bytes_in_use"] / gb, "total_gb": info["bytes_limit"] / gb}


def count_tokens(texts: List[str], tokenizer) -> int:
    """Total tokens across texts."""
    return sum(len(tokenizer(t, add_special_tokens=False)["input_ids"]) for t in texts)


def get_model_type(model_path: Optional[str]) -> str:
    """Sniff the architecture family from a checkpoint path, falling back to
    config.json's model_type."""
    if not model_path:
        return "llama"
    lowered = os.path.basename(os.path.normpath(model_path)).lower()
    for t in _MODEL_TYPES:
        if t in lowered:
            return t
    cfg_path = os.path.join(model_path, "config.json")
    if os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                mt = json.load(f).get("model_type", "")
        except (OSError, ValueError):
            mt = ""
        for t in _MODEL_TYPES:
            if t in mt.lower():
                return t
    for t in _MODEL_TYPES:
        if t in model_path.lower():
            return t
    return "llama"
