"""HF checkpoints -> engine parameter tree, and the offline converted format
(port of ``lite_llama_tpu/utils/weights.py``), plus :func:`params_from_numpy`,
which turns a numpy tree in the layout of ``models/decoder.py`` (the JAX
package's layout) into the port's tensors.

Output weights are stored ``[in, out]`` (ready for ``x @ W``; HF stores
``[out, in]``), K+V fused into ``wkv`` and gate+up into ``gate_up_proj``,
stacked across layers ``[L, ...]``:

  embed [V, H]; layers/attn_norm, mlp_norm [L, H]; layers/wq [L, H, Nq, D];
  layers/wkv [L, H, 2, Nkv, D]; layers/q_bias [L, Nq, D] and
  layers/kv_bias [L, 2, Nkv, D] (qwen2); layers/q_norm, k_norm [L, D]
  (qwen3); layers/o_proj [L, Nq, D, H]; layers/gate_up_proj [L, 2, H, I];
  layers/down_proj [L, I, H]; final_norm [H]; lm_head [H, V] (untied only).

Checkpoints are read by the port's own safetensors reader
(``utils/safetensors_io.py``) in their stored dtype, straight to the target
device, where the transposes and fusions run as torch ops; each leaf is cast
to ``cfg.dtype`` once, so a bf16 checkpoint never passes through fp32 on the
host. The converted format is the JAX package's: ``engine.safetensors``
(keys "embed", "layers/wq", ...) beside a ``config.json`` of the config's
fields and the source's tokenizer files.

LLaVA checkpoints (``convert_hf_llava_state_dict``) become the tree
{"lm": <the tree above>, "vision": <models/vision.py's>, "projector": {w1,
b1, w2, b2}}. A converted LLaVA's ``config.json`` keeps its vision and text
configs as dicts, so it reloads as the same model (the JAX package's
converter drops them, and its reload falls back to default shapes).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable, Dict, Iterable, Mapping

import numpy as np
import torch

from ..quant.qtensor import QTensor
from .safetensors_io import INDEX_FILE, load_file, save_file

CONVERTED_FILE = "engine.safetensors"


def _tensor(t) -> torch.Tensor:
    """A checkpoint leaf as a torch tensor in its stored dtype (numpy types
    torch lacks, such as ml_dtypes' bf16, become fp32, which is exact)."""
    if isinstance(t, torch.Tensor):
        return t.detach()
    a = np.asarray(t)
    if a.dtype.kind not in "biuf" or a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    # fp64 rounds to fp32 first, as the fp32 path always did.
    return (t.float() if t.dtype == torch.float64 else t).to(dtype)


def params_from_numpy(tree, cfg, device="cuda"):
    """A nested dict of array-likes (numpy, anything ``np.asarray`` reads,
    bf16 included, or torch tensors) -> the same dict of ``cfg.dtype``
    tensors on ``device``. Torch tensors are cast on ``device`` from their
    own dtype; numpy arrays go through fp32.

    Quantized leaves come as ``QTensor``s whose ``q`` and ``scale`` are numpy
    arrays (the JAX quantizer's output, with its static fields): ``q`` int8
    stays int8, ``q`` uint8 is the bit pattern of float8_e4m3fn (numpy has
    no fp8 type), scales stay fp32. The static fields carry across as they
    are, the tensor-parallel layouts (riffle blocks, the shard-periodic
    fused wqkv, σ-FFN blocks) included."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, cfg, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        q = np.ascontiguousarray(tree.q)
        if q.dtype == np.uint8:
            qt = torch.from_numpy(q).to(device).view(torch.float8_e4m3fn)
        elif q.dtype == np.int8:
            qt = torch.from_numpy(q).to(device)
        else:
            raise ValueError(f"quantized q must be int8, or uint8 fp8 bits; got {q.dtype}")
        scale = torch.from_numpy(np.ascontiguousarray(tree.scale, dtype=np.float32)).to(device)
        return dataclasses.replace(tree, q=qt, scale=scale, layer=None)
    if isinstance(tree, torch.Tensor):
        return _cast(tree.detach().to(device), cfg.dtype)
    arr = np.ascontiguousarray(np.asarray(tree, dtype=np.float32))
    return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)


def _getter(sd: Mapping, device):
    """key -> the tensor on ``device`` in its stored dtype (fp64 as fp32)."""
    def get(key: str) -> torch.Tensor:
        t = _tensor(sd[key]).to(device)
        return t.float() if t.dtype == torch.float64 else t

    return get


def _whole(get, dtype, device):
    """key (, view) -> a fresh ``dtype`` tensor of ``view(get(key))``: one
    cast, as a cast from fp32 rounds."""
    def whole(key: str, view=lambda w: w) -> torch.Tensor:
        w = view(get(key))
        return torch.empty(w.shape, dtype=dtype, device=device).copy_(w)

    return whole


def convert_hf_state_dict(sd: Mapping, cfg, prefix: str = "model.", device="cuda") -> dict:
    """Convert an HF llama/qwen2/qwen3 state dict (torch tensors in any
    dtype, or numpy arrays) to the engine tree of ``cfg.dtype`` tensors on
    ``device``. Each source tensor moves to ``device`` in its own dtype and
    is transposed and stacked there; the one cast to ``cfg.dtype`` rounds as
    a cast from fp32 would (bf16 and fp16 widen to fp32 exactly)."""
    L, H, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    Nq, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    I = cfg.intermediate_size

    get = _getter(sd, device)
    whole = _whole(get, cfg.dtype, device)

    def lw(i: int, name: str) -> torch.Tensor:
        return get(f"{prefix}layers.{i}.{name}")

    def stacked(shape, fill: Callable[[torch.Tensor, int], None]) -> torch.Tensor:
        out = torch.empty((L, *shape), dtype=cfg.dtype, device=device)
        for i in range(L):
            fill(out[i], i)
        return out

    def each(name: str, view=lambda w: w):
        return lambda dst, i: dst.copy_(view(lw(i, name)))

    def wkv(dst, i):
        for j, name in enumerate(("k_proj", "v_proj")):
            dst[:, j].copy_(lw(i, f"self_attn.{name}.weight").T.reshape(H, Nkv, D))

    def gate_up(dst, i):
        dst[0].copy_(lw(i, "mlp.gate_proj.weight").T)
        dst[1].copy_(lw(i, "mlp.up_proj.weight").T)

    def kv_bias(dst, i):
        dst[0].copy_(lw(i, "self_attn.k_proj.bias").reshape(Nkv, D))
        dst[1].copy_(lw(i, "self_attn.v_proj.bias").reshape(Nkv, D))

    layers = {
        "attn_norm": stacked((H,), each("input_layernorm.weight")),
        # HF q_proj.weight is [Nq*D, H], head-major rows -> [H, Nq, D]
        "wq": stacked((H, Nq, D), each("self_attn.q_proj.weight",
                                       lambda w: w.T.reshape(H, Nq, D))),
        "wkv": stacked((H, 2, Nkv, D), wkv),
        # HF o_proj.weight is [H, Nq*D] -> [Nq, D, H]
        "o_proj": stacked((Nq, D, H), each("self_attn.o_proj.weight",
                                           lambda w: w.T.reshape(Nq, D, H))),
        "mlp_norm": stacked((H,), each("post_attention_layernorm.weight")),
        "gate_up_proj": stacked((2, H, I), gate_up),  # axis 1: 0=gate, 1=up
        "down_proj": stacked((I, H), each("mlp.down_proj.weight", lambda w: w.T)),
    }
    if cfg.attention_bias:
        layers["q_bias"] = stacked((Nq, D), each("self_attn.q_proj.bias",
                                                 lambda w: w.reshape(Nq, D)))
        layers["kv_bias"] = stacked((2, Nkv, D), kv_bias)
    if getattr(cfg, "qk_norm", False):
        layers["q_norm"] = stacked((D,), each("self_attn.q_norm.weight"))
        layers["k_norm"] = stacked((D,), each("self_attn.k_norm.weight"))
    params = {
        "embed": whole(f"{prefix}embed_tokens.weight"),
        "layers": layers,
        "final_norm": whole(f"{prefix}norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = whole("lm_head.weight", lambda w: w.T)
    return params


# ---------------------------------------------------------------------------
# LLaVA (CLIP tower + projector + Llama LM)


def convert_hf_llava_state_dict(sd: Mapping, cfg, device="cuda") -> dict:
    """An HF ``LlavaForConditionalGeneration`` state dict -> the engine tree
    {"lm", "vision", "projector"} of ``cfg.dtype`` tensors on ``device``,
    converted there from the stored dtype as :func:`convert_hf_state_dict`
    does. Takes both key styles: ``language_model.model.*`` /
    ``vision_tower.*`` and ``model.language_model.*`` /
    ``model.vision_tower.*``, and either place of the LM head."""
    norm = {}
    for k, v in sd.items():
        k2 = k[len("model."):] if k.startswith("model.") else k
        k2 = k2.replace("language_model.model.", "language_model.")
        if k2 == "language_model.lm_head.weight":
            k2 = "lm_head.weight"
        norm[k2] = v
    lm = convert_hf_state_dict(norm, cfg, prefix="language_model.", device=device)

    vcfg = cfg.vision_config
    Hv, Lv = vcfg.hidden_size, vcfg.num_hidden_layers
    vp = "vision_tower.vision_model."
    get = _getter(norm, device)
    whole = _whole(get, cfg.dtype, device)

    def vstack(name: str, view=lambda w: w) -> torch.Tensor:
        first = view(get(f"{vp}encoder.layers.0.{name}"))
        out = torch.empty((Lv, *first.shape), dtype=cfg.dtype, device=device)
        for i in range(Lv):
            out[i].copy_(view(get(f"{vp}encoder.layers.{i}.{name}")))
        return out

    def T(w):
        return w.T

    vision = {
        # the conv weight [Hv, C, p, p] as the unfold-matmul's [C*p*p, Hv]
        "patch_embed": whole(vp + "embeddings.patch_embedding.weight",
                             lambda w: w.reshape(Hv, -1).T),
        "class_embed": whole(vp + "embeddings.class_embedding"),
        "pos_embed": whole(vp + "embeddings.position_embedding.weight"),
        "pre_ln_scale": whole(vp + "pre_layrnorm.weight"),
        "pre_ln_bias": whole(vp + "pre_layrnorm.bias"),
        "layers": {
            "ln1_scale": vstack("layer_norm1.weight"),
            "ln1_bias": vstack("layer_norm1.bias"),
            "wq": vstack("self_attn.q_proj.weight", T),
            "wk": vstack("self_attn.k_proj.weight", T),
            "wv": vstack("self_attn.v_proj.weight", T),
            "wo": vstack("self_attn.out_proj.weight", T),
            "bq": vstack("self_attn.q_proj.bias"),
            "bk": vstack("self_attn.k_proj.bias"),
            "bv": vstack("self_attn.v_proj.bias"),
            "bo": vstack("self_attn.out_proj.bias"),
            "ln2_scale": vstack("layer_norm2.weight"),
            "ln2_bias": vstack("layer_norm2.bias"),
            "fc1_w": vstack("mlp.fc1.weight", T),
            "fc1_b": vstack("mlp.fc1.bias"),
            "fc2_w": vstack("mlp.fc2.weight", T),
            "fc2_b": vstack("mlp.fc2.bias"),
        },
    }
    mp = "multi_modal_projector."
    projector = {
        "w1": whole(mp + "linear_1.weight", T), "b1": whole(mp + "linear_1.bias"),
        "w2": whole(mp + "linear_2.weight", T), "b2": whole(mp + "linear_2.bias"),
    }
    return {"lm": lm, "vision": vision, "projector": projector}


# ---------------------------------------------------------------------------
# Safetensors checkpoint loading (sharded HF dirs)


def _iter_safetensor_files(ckpt_dir: str) -> Iterable[str]:
    idx = os.path.join(ckpt_dir, INDEX_FILE)
    if os.path.exists(idx):
        with open(idx) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(ckpt_dir, f) for f in files]
    return sorted(
        os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir) if f.endswith(".safetensors")
    )


def load_hf_safetensors(ckpt_dir: str, device="cuda") -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint dir (one file, or the shards its
    index names), in its stored dtype, on ``device``."""
    sd: Dict[str, torch.Tensor] = {}
    for path in _iter_safetensor_files(ckpt_dir):
        sd.update(load_file(path, device))
    return sd


def params_from_hf_state_dict(sd: Mapping, cfg, device="cuda") -> dict:
    """An HF state dict, keys with or without the ``model.`` prefix, -> the
    engine tree (:func:`convert_hf_state_dict`, or
    :func:`convert_hf_llava_state_dict` for a LLaVA config)."""
    if getattr(cfg, "model_type", "") == "llava":
        return convert_hf_llava_state_dict(sd, cfg, device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    return convert_hf_state_dict(sd, cfg, prefix=prefix, device=device)


def load_hf_checkpoint(ckpt_dir: str, cfg, device="cuda") -> dict:
    """HF checkpoint dir -> engine parameter tree on ``device``."""
    return params_from_hf_state_dict(load_hf_safetensors(ckpt_dir, device), cfg, device)


# ---------------------------------------------------------------------------
# Offline converted format (fused engine-native safetensors)


def flatten_params(params: dict, sep: str = "/") -> Dict[str, torch.Tensor]:
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, path + [k])
        else:
            out[sep.join(path)] = _tensor(node)

    rec(params, [])
    return out


def unflatten_params(flat: Mapping[str, torch.Tensor], sep: str = "/") -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_converted(params: dict, cfg, out_dir: str, src_dir: str | None = None):
    """Write the fused engine checkpoint: one safetensors file + config.json
    (+ tokenizer files copied from the source)."""
    os.makedirs(out_dir, exist_ok=True)
    save_file(flatten_params(params), os.path.join(out_dir, CONVERTED_FILE))
    cfg_dict = {}
    for k, v in vars(cfg).items():
        if dataclasses.is_dataclass(v):  # a LLaVA's vision and text configs
            v = {f: x for f, x in vars(v).items() if f != "dtype"}
        if (not k.startswith("_") and k != "dtype"
                and isinstance(v, (int, float, str, bool, list, dict, type(None)))):
            cfg_dict[k] = v
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    if src_dir:
        for name in os.listdir(src_dir):
            if name.startswith("tokenizer") or name in (
                "special_tokens_map.json",
                "generation_config.json",
                "vocab.json",
                "merges.txt",
            ):
                shutil.copy2(os.path.join(src_dir, name), os.path.join(out_dir, name))


def params_from_converted(flat: Mapping[str, torch.Tensor], dtype=None) -> dict:
    """The flat tensors of ``engine.safetensors`` -> the engine tree, each
    leaf cast to ``dtype`` where one is given."""
    if dtype is not None:
        flat = {k: _cast(v, dtype) for k, v in flat.items()}
    return unflatten_params(flat)


def load_converted(ckpt_dir: str, dtype=None, device="cuda") -> dict:
    flat = load_file(os.path.join(ckpt_dir, CONVERTED_FILE), device)
    return params_from_converted(flat, dtype)


def is_converted_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, CONVERTED_FILE))
