"""RoPE frequency generation (numpy; the port's own copy of
``lite_llama_tpu/models/rotary.py``, which it may not import).

Default inverse-frequency generation plus the llama3 wavelength-banded,
yarn, dynamic-NTK and longrope scalings, selected by
``rope_scaling.rope_type`` via a registry. This is a pure function of the
config producing a static fp32 ``inv_freq`` table (+ scalar attention
scaling); cos/sin for the actual positions are computed per step
(ops/ref.py:rope_cos_sin), so long-context scaling is a config choice, not
runtime state.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _default_inv_freq(base: float, head_dim: int) -> np.ndarray:
    return 1.0 / (
        base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )


def compute_inv_freq(config) -> Tuple[np.ndarray, float]:
    """Returns (inv_freq fp32 [head_dim//2], attention_scaling scalar).

    Unknown ``rope_type`` values raise instead of silently degrading to the
    default frequencies (a checkpoint that asks for a scaling scheme we
    don't implement must not produce quietly-wrong long-context logits)."""
    head_dim = config.head_dim
    base = config.rope_theta
    scaling = config.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    if rope_type not in _ROPE_INIT:
        raise ValueError(
            f"unsupported rope_scaling type {rope_type!r}; "
            f"implemented: {sorted(_ROPE_INIT)}"
        )
    inv_freq, att_scale = _ROPE_INIT[rope_type](base, head_dim, scaling, config)
    return inv_freq.astype(np.float32), float(att_scale)


def _rope_default(base, head_dim, scaling, config):
    return _default_inv_freq(base, head_dim), 1.0


def _rope_linear(base, head_dim, scaling, config):
    factor = scaling.get("factor", 1.0)
    return _default_inv_freq(base, head_dim) / factor, 1.0


def _rope_llama3(base, head_dim, scaling, config):
    """Llama-3.x wavelength-banded NTK scaling: low-frequency bands divided
    by ``factor``,
    high-frequency bands untouched, smooth interpolation between."""
    inv_freq = _default_inv_freq(base, head_dim)
    factor = scaling.get("factor", 8.0)
    low_factor = scaling.get("low_freq_factor", 1.0)
    high_factor = scaling.get("high_freq_factor", 4.0)
    old_ctx = scaling.get("original_max_position_embeddings", 8192)

    low_wavelen = old_ctx / low_factor
    high_wavelen = old_ctx / high_factor
    wavelen = 2 * math.pi / inv_freq

    scaled = inv_freq / factor
    smooth = (old_ctx / wavelen - low_factor) / (high_factor - low_factor)
    smoothed = (1 - smooth) * scaled + smooth * inv_freq
    out = np.where(
        wavelen > low_wavelen,
        scaled,
        np.where(wavelen < high_wavelen, inv_freq, smoothed),
    )
    return out, 1.0


def _rope_yarn(base, head_dim, scaling, config):
    """YaRN scaling (per-band interpolation + sqrt attention temperature)."""
    inv_freq = _default_inv_freq(base, head_dim)
    factor = scaling.get("factor", 1.0)
    beta_fast = scaling.get("beta_fast", 32.0)
    beta_slow = scaling.get("beta_slow", 1.0)
    old_ctx = scaling.get(
        "original_max_position_embeddings", config.max_position_embeddings
    )
    att_scale = scaling.get(
        "attention_factor", 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    )

    def correction_dim(num_rot):
        return (head_dim * math.log(old_ctx / (num_rot * 2 * math.pi))) / (
            2 * math.log(base)
        )

    low = math.floor(correction_dim(beta_fast))
    high = math.ceil(correction_dim(beta_slow))
    low, high = max(low, 0), min(high, head_dim // 2 - 1)
    if high == low:
        high = low + 1e-3
    d = np.arange(head_dim // 2, dtype=np.float64)
    ramp = np.clip((d - low) / (high - low), 0.0, 1.0)
    # ramp=0 -> interpolate (divide by factor); ramp=1 -> extrapolate (keep)
    out = inv_freq / factor * (1 - ramp) + inv_freq * ramp
    return out, att_scale


def _rope_dynamic(base, head_dim, scaling, config):
    """Dynamic NTK scaling (HF ``_compute_dynamic_ntk_parameters``). HF
    keeps the ORIGINAL base until the live sequence exceeds ``max_position_embeddings`` and then
    recomputes for the observed length. Frequencies here are static per
    build, so this returns the base NTK-scaled for the engine's
    ``max_seq_len`` (the longest sequence this instance will ever see); the
    forward selects PER REQUEST between this long table and the unscaled
    short table from :func:`compute_inv_freq_dual` at the
    ``max_position_embeddings`` threshold — matching HF exactly at both ends.
    Remaining divergence (documented, accepted): for live lengths strictly
    between ``max_position_embeddings`` and ``max_seq_len`` HF scales for the
    current length while this engine already uses the max_seq_len-scaled
    table (slightly more conservative extrapolation, monotone in the same
    direction)."""
    factor = scaling.get("factor", 1.0)
    mpe = config.max_position_embeddings
    seq_len = max(getattr(config, "max_seq_len", mpe), mpe)
    base = base * ((factor * seq_len / mpe) - (factor - 1)) ** (
        head_dim / (head_dim - 2)
    )
    return _default_inv_freq(base, head_dim), 1.0


def _rope_longrope(base, head_dim, scaling, config):
    """LongRoPE (HF ``_compute_longrope_parameters``): per-band short/long
    rescale factors with a sqrt-log attention temperature. The short/long
    choice keys off the engine's max_seq_len vs the pretrained context."""
    long_factor = np.asarray(scaling["long_factor"], np.float64)
    short_factor = np.asarray(scaling["short_factor"], np.float64)
    orig = getattr(config, "original_max_position_embeddings", None)
    if orig:
        factor = config.max_position_embeddings / orig
    else:
        orig = config.max_position_embeddings
        factor = scaling.get("factor", 1.0)
    att = scaling.get("attention_factor")
    if att is None:
        att = (
            1.0 if factor <= 1.0
            else math.sqrt(1 + math.log(factor) / math.log(orig))
        )
    seq_len = max(getattr(config, "max_seq_len", orig), 1)
    ext = long_factor if seq_len > orig else short_factor
    exps = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return 1.0 / (ext * base**exps), att


def compute_inv_freq_dual(config):
    """(inv_freq, short_inv_freq_or_None, select_threshold, att_scale).

    For ``rope_type == 'dynamic'`` the second table holds the UNSCALED
    original-base frequencies and ``select_threshold`` is
    ``max_position_embeddings``: requests whose live sequence length is <=
    the threshold must use the short table (HF keeps the original base until
    the sequence exceeds the pretrained context; baking the scaled base for
    every request degrades short-prompt logits against HF). For
    every other rope type the short table is None and callers use the single
    static table."""
    inv_freq, att_scale = compute_inv_freq(config)
    scaling = config.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    if rope_type != "dynamic":
        return inv_freq, None, 0, att_scale
    short = _default_inv_freq(config.rope_theta, config.head_dim).astype(
        np.float32
    )
    if np.allclose(short, inv_freq):  # max_seq_len <= mpe: formula is identity
        return inv_freq, None, 0, att_scale
    return inv_freq, short, config.max_position_embeddings, att_scale


_ROPE_INIT = {
    "default": _rope_default,
    "linear": _rope_linear,
    "llama3": _rope_llama3,
    "yarn": _rope_yarn,
    "dynamic": _rope_dynamic,
    "longrope": _rope_longrope,
}
