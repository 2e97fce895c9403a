"""Model configuration dataclasses (port of ``lite_llama_tpu/config.py``).

HF ``config.json`` ingestion with field-alias maps, derived fields in
``__post_init__``, and a model_type -> config-class registry. ``dtype`` is a
torch dtype (bf16 by default).

``LlavaConfig`` reads an HF LLaVA ``config.json`` as transformers reads it:
a ``text_config`` dict fills the fields it omits from HF's ``LlamaConfig``
defaults (Vicuna-7B's shape: hidden 4096, 32 layers, rope_theta 10000), a
``vision_config`` dict from ``CLIPVisionConfig``'s (ViT-B/32's), and an
absent ``vision_config`` is LLaVA-1.5's CLIP-L/14-336 tower. The JAX package
fills both from its own defaults instead.
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


# transformers' defaults for the fields an HF LLaVA config.json may omit:
# LlamaConfig's for ``text_config`` (kv heads default to the heads, head_dim
# to hidden / heads), CLIPVisionConfig's for ``vision_config``.
HF_LLAMA_DEFAULTS = dict(
    hidden_size=4096, intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
    vocab_size=32000, rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=2048,
    tie_word_embeddings=False,
)
HF_CLIP_VISION_DEFAULTS = dict(
    hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
    image_size=224, patch_size=32, projection_dim=512, layer_norm_eps=1e-5, num_channels=3,
)


@dataclass
class VisionConfig:
    """CLIP vision tower shape; the defaults are LLaVA-1.5's CLIP-L/14-336."""

    hidden_size: int = 1024
    image_size: int = 336
    patch_size: int = 14
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    num_channels: int = 3
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VisionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# The text fields a LlavaConfig mirrors from its text config, so that the
# LM stack runs on the LlavaConfig itself.
_TEXT_FIELDS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "head_dim", "vocab_size", "rms_norm_eps", "rope_theta",
                "rope_scaling", "tie_word_embeddings")


@dataclass
class LlavaConfig(BaseConfig):
    """LLaVA-1.5 = CLIP tower + projector + Llama LM. ``vision_config`` and
    ``text_config`` are dataclasses, or dicts in HF's form (filled from
    transformers' defaults, see the module docstring)."""

    model_type: str = "llava"
    vision_config: Optional[VisionConfig] = None
    text_config: Optional[LlamaConfig] = None
    image_token_index: int = 32000
    projector_hidden_act: str = "gelu"
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"

    def __post_init__(self):
        if isinstance(self.vision_config, dict):
            self.vision_config = VisionConfig.from_dict(
                {**HF_CLIP_VISION_DEFAULTS, **self.vision_config})
        if self.vision_config is None:
            self.vision_config = VisionConfig()
        if self.text_config is None:
            self.text_config = {}
        if isinstance(self.text_config, dict):
            self.text_config = LlamaConfig.from_dict({**HF_LLAMA_DEFAULTS, **self.text_config})
        t = self.text_config
        for f in _TEXT_FIELDS:
            setattr(self, f, getattr(t, f))
        super().__post_init__()
        t.max_seq_len = self.max_seq_len
        t.dtype = self.dtype

    @property
    def num_image_patches(self) -> int:
        return self.vision_config.num_patches


CONFIG_CLASS_MAP: Dict[str, Type[BaseConfig]] = {
    "llama": LlamaConfig,
    "qwen2": Qwen2Config,
    "qwen3": Qwen3Config,
    "llava": LlavaConfig,
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
    cls = CONFIG_CLASS_MAP.get(d.get("model_type", "llama"), LlamaConfig)
    return cls.from_dict(d, **overrides)
