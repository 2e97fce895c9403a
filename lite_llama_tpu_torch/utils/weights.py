"""HF checkpoint -> engine parameter tree (port of
``lite_llama_tpu/utils/weights.py``, ``convert_hf_state_dict``), plus
:func:`params_from_numpy`, which turns a numpy tree in the layout of
``models/decoder.py`` (the JAX package's layout) into the port's tensors.

Output weights are stored ``[in, out]`` (ready for ``x @ W``; HF stores
``[out, in]``), K+V fused into ``wkv`` and gate+up into ``gate_up_proj``,
stacked across layers ``[L, ...]``:

  embed [V, H]; layers/attn_norm, mlp_norm [L, H]; layers/wq [L, H, Nq, D];
  layers/wkv [L, H, 2, Nkv, D]; layers/q_bias [L, Nq, D] and
  layers/kv_bias [L, 2, Nkv, D] (qwen2); layers/q_norm, k_norm [L, D]
  (qwen3); layers/o_proj [L, Nq, D, H]; layers/gate_up_proj [L, 2, H, I];
  layers/down_proj [L, I, H]; final_norm [H]; lm_head [H, V] (untied only).

Loading safetensors checkpoints is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from ..quant.qtensor import QTensor


def _get(sd: Mapping, key: str) -> np.ndarray:
    t = sd[key]
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t, dtype=np.float32)


def params_from_numpy(tree, cfg, device="cuda"):
    """A nested dict of array-likes (numpy, or anything ``np.asarray`` reads,
    bf16 included) -> the same dict of ``cfg.dtype`` tensors on ``device``.

    Quantized leaves come as ``QTensor``s whose ``q`` and ``scale`` are numpy
    arrays (the JAX quantizer's output, with its static fields): ``q`` int8
    stays int8, ``q`` uint8 is the bit pattern of float8_e4m3fn (numpy has
    no fp8 type), scales stay fp32. Riffle blocks for tensor parallelism
    (``riffle_groups > 1``) are refused."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, cfg, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        if tree.riffle_groups > 1 or tree.fused_tp > 1:
            raise NotImplementedError("tensor-parallel riffle/fused layouts wait for multi-GPU")
        q = np.ascontiguousarray(tree.q)
        if q.dtype == np.uint8:
            qt = torch.from_numpy(q).to(device).view(torch.float8_e4m3fn)
        elif q.dtype == np.int8:
            qt = torch.from_numpy(q).to(device)
        else:
            raise ValueError(f"quantized q must be int8, or uint8 fp8 bits; got {q.dtype}")
        scale = torch.from_numpy(np.ascontiguousarray(tree.scale, dtype=np.float32)).to(device)
        return dataclasses.replace(tree, q=qt, scale=scale, layer=None)
    arr = np.ascontiguousarray(np.asarray(tree, dtype=np.float32))
    return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)


def convert_hf_state_dict(sd: Mapping, cfg, prefix: str = "model.", device="cuda") -> dict:
    """Convert an HF llama/qwen2/qwen3 state dict (numpy arrays or torch
    tensors) to the engine tree of ``cfg.dtype`` tensors on ``device``.
    Computes in fp32 and casts at the end."""
    L, H, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    Nq, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def stack(fn: Callable[[int], np.ndarray]) -> np.ndarray:
        return np.stack([fn(i) for i in range(L)])

    def lw(i: int, name: str) -> np.ndarray:
        return _get(sd, f"{prefix}layers.{i}.{name}")

    def wq(i: int) -> np.ndarray:
        # HF q_proj.weight is [Nq*D, H], head-major rows -> [H, Nq, D]
        return lw(i, "self_attn.q_proj.weight").T.reshape(H, Nq, D)

    def wkv(i: int) -> np.ndarray:
        k = lw(i, "self_attn.k_proj.weight").T.reshape(H, Nkv, D)
        v = lw(i, "self_attn.v_proj.weight").T.reshape(H, Nkv, D)
        return np.stack([k, v], axis=1)  # [H, 2, Nkv, D]

    layers = {
        "attn_norm": stack(lambda i: lw(i, "input_layernorm.weight")),
        "wq": stack(wq),
        "wkv": stack(wkv),
        # HF o_proj.weight is [H, Nq*D] -> [Nq, D, H]
        "o_proj": stack(lambda i: lw(i, "self_attn.o_proj.weight").T.reshape(Nq, D, H)),
        "mlp_norm": stack(lambda i: lw(i, "post_attention_layernorm.weight")),
        "gate_up_proj": stack(
            lambda i: np.stack(
                [lw(i, "mlp.gate_proj.weight").T, lw(i, "mlp.up_proj.weight").T], axis=0
            )  # [2, H, I] (axis0: 0=gate, 1=up)
        ),
        "down_proj": stack(lambda i: lw(i, "mlp.down_proj.weight").T),
    }
    if cfg.attention_bias:
        layers["q_bias"] = stack(lambda i: lw(i, "self_attn.q_proj.bias").reshape(Nq, D))
        layers["kv_bias"] = stack(
            lambda i: np.stack(
                [
                    lw(i, "self_attn.k_proj.bias").reshape(Nkv, D),
                    lw(i, "self_attn.v_proj.bias").reshape(Nkv, D),
                ]
            )
        )
    if getattr(cfg, "qk_norm", False):
        layers["q_norm"] = stack(lambda i: lw(i, "self_attn.q_norm.weight"))
        layers["k_norm"] = stack(lambda i: lw(i, "self_attn.k_norm.weight"))
    params = {
        "embed": _get(sd, f"{prefix}embed_tokens.weight"),
        "layers": layers,
        "final_norm": _get(sd, f"{prefix}norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _get(sd, "lm_head.weight").T
    return params_from_numpy(params, cfg, device)
