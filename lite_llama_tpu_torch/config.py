"""Model configuration dataclasses (port of ``lite_llama_tpu/config.py``).

HF ``config.json`` ingestion with field-alias maps, derived fields in
``__post_init__``, and a model_type -> config-class registry. ``dtype`` is a
torch dtype (bf16 by default). LLaVA is not ported yet: asking for it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Type

import torch


@dataclass
class BaseConfig:
    """Common decoder-transformer fields, named in HF style."""

    model_type: str = "llama"
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    vocab_size: int = 128256
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    hidden_act: str = "silu"
    bos_token_id: Optional[int] = None
    eos_token_id: Any = None  # int or list[int]
    pad_token_id: Optional[int] = None

    # Engine-shape knobs
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16

    # Field aliases seen in HF configs -> our field names.
    _ALIASES = {
        "n_layers": "num_hidden_layers",
        "n_heads": "num_attention_heads",
        "n_kv_heads": "num_key_value_heads",
        "max_seq_length": "max_seq_len",
    }

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    # -- derived ----------------------------------------------------------
    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def eos_token_ids(self):
        e = self.eos_token_id
        if e is None:
            return []
        return list(e) if isinstance(e, (list, tuple)) else [e]

    # -- construction -----------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides) -> "BaseConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for k, v in d.items():
            k = cls._ALIASES.get(k, k)
            if k in names and not k.startswith("_"):
                kwargs[k] = v
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "BaseConfig":
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_dict(json.load(f), **overrides)


@dataclass
class LlamaConfig(BaseConfig):
    model_type: str = "llama"


@dataclass
class Qwen2Config(BaseConfig):
    """Qwen2/2.5: q/k/v projection biases."""

    model_type: str = "qwen2"
    attention_bias: bool = True
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False


@dataclass
class Qwen3Config(BaseConfig):
    """Qwen3: per-head q/k RMSNorm before RoPE, no attention bias, and
    head_dim decoupled from hidden_size."""

    model_type: str = "qwen3"
    attention_bias: bool = False
    qk_norm: bool = True
    rope_theta: float = 1000000.0


CONFIG_CLASS_MAP: Dict[str, Type[BaseConfig]] = {
    "llama": LlamaConfig,
    "qwen2": Qwen2Config,
    "qwen3": Qwen3Config,
}


def load_config(path_or_dict, **overrides) -> BaseConfig:
    """Load a config from an HF checkpoint dir / config.json / dict,
    dispatching on ``model_type`` (unknown types read as llama)."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        p = path_or_dict
        if os.path.isdir(p):
            p = os.path.join(p, "config.json")
        with open(p) as f:
            d = json.load(f)
    model_type = d.get("model_type", "llama")
    if model_type == "llava":
        raise NotImplementedError("LLaVA is not ported to lite_llama_tpu_torch yet")
    cls = CONFIG_CLASS_MAP.get(model_type, LlamaConfig)
    return cls.from_dict(d, **overrides)
