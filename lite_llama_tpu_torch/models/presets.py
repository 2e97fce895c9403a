"""Known model configurations (public model-card shapes) for running the real
architectures without a checkpoint download. Values match the HF config.json
of each model (port of ``lite_llama_tpu/models/presets.py``).
"""

from __future__ import annotations

from ..config import LlamaConfig, LlavaConfig, Qwen2Config, Qwen3Config

_LLAMA32_ROPE = {
    "rope_type": "llama3",
    "factor": 32.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}


def llama32_1b(**kw) -> LlamaConfig:
    return LlamaConfig(
        hidden_size=2048,
        intermediate_size=8192,
        num_hidden_layers=16,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=64,
        vocab_size=128256,
        rope_theta=500000.0,
        rope_scaling=dict(_LLAMA32_ROPE),
        tie_word_embeddings=True,
        eos_token_id=[128001, 128008, 128009],
        **kw,
    )


def llama32_3b(**kw) -> LlamaConfig:
    return LlamaConfig(
        hidden_size=3072,
        intermediate_size=8192,
        num_hidden_layers=28,
        num_attention_heads=24,
        num_key_value_heads=8,
        head_dim=128,
        vocab_size=128256,
        rope_theta=500000.0,
        rope_scaling=dict(_LLAMA32_ROPE),
        tie_word_embeddings=True,
        eos_token_id=[128001, 128008, 128009],
        **kw,
    )


def qwen25_3b(**kw) -> Qwen2Config:
    return Qwen2Config(
        hidden_size=2048,
        intermediate_size=11008,
        num_hidden_layers=36,
        num_attention_heads=16,
        num_key_value_heads=2,
        vocab_size=151936,
        rope_theta=1000000.0,
        tie_word_embeddings=True,
        eos_token_id=151643,
        **kw,
    )


def qwen3_4b(**kw) -> Qwen3Config:
    return Qwen3Config(
        hidden_size=2560,
        intermediate_size=9728,
        num_hidden_layers=36,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        vocab_size=151936,
        rope_theta=1000000.0,
        tie_word_embeddings=True,
        eos_token_id=151645,
        **kw,
    )


def llava15_7b(**kw) -> LlavaConfig:
    """llava-1.5-7b-hf: CLIP-L/14-336 tower + Vicuna-7B LM."""
    text = LlamaConfig(
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        vocab_size=32064,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        eos_token_id=2,
        rms_norm_eps=1e-5,
    )
    return LlavaConfig(text_config=text, **kw)


PRESETS = {
    "llama-3.2-1b": llama32_1b,
    "llama-3.2-3b": llama32_3b,
    "qwen2.5-3b": qwen25_3b,
    "qwen3-4b": qwen3_4b,
    "llava-1.5-7b": llava15_7b,
}


def get_preset(name: str, **kw):
    return PRESETS[name](**kw)
