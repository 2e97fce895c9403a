"""CLIP ViT vision tower (port of ``lite_llama_tpu/models/vision.py``).

HF ``CLIPVisionModel`` semantics at CLIP-L/14-336's shape: the patch conv as
an unfold and a matmul, the CLS token and learned position embeddings, the
pre-LayerNorm, then pre-LN transformer blocks with bidirectional multi-head
attention and a quick_gelu MLP. Returns the hidden state LLaVA asks for
(``vision_feature_layer`` -2: the output of the second-to-last block), so
only the blocks before it run.

The tower has no Pallas kernel in the JAX package (XLA runs it), so it is
plain PyTorch here, on the card too. Attention keeps the JAX package's math
rather than ``F.scaled_dot_product_attention``, so that rounding follows
it: fp32 logits (the products of q and k accumulated and returned in fp32),
an fp32 softmax, the probabilities cast to the activation dtype before the
product with v.
"""

from __future__ import annotations

import torch

from ..ops.activations import quick_gelu


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm in fp32 (population variance), cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def init_vision_params(vcfg, generator: torch.Generator, dtype=torch.float32,
                       scale: float = 0.02) -> dict:
    """Random tower parameters drawn from ``generator`` on its device:
    N(0, scale) weights and embeddings, unit LayerNorm scales, zero biases.
    Weights are stored ``[in, out]``, stacked ``[L, ...]``."""
    device = generator.device
    H, L, I = vcfg.hidden_size, vcfg.num_hidden_layers, vcfg.intermediate_size
    C, p = vcfg.num_channels, vcfg.patch_size
    n_pos = vcfg.num_patches + 1

    def init(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, scale,
                                                                       generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "ln1_scale": ones(L, H), "ln1_bias": zeros(L, H),
        "wq": init(L, H, H), "wk": init(L, H, H), "wv": init(L, H, H), "wo": init(L, H, H),
        "bq": zeros(L, H), "bk": zeros(L, H), "bv": zeros(L, H), "bo": zeros(L, H),
        "ln2_scale": ones(L, H), "ln2_bias": zeros(L, H),
        "fc1_w": init(L, H, I), "fc1_b": zeros(L, I),
        "fc2_w": init(L, I, H), "fc2_b": zeros(L, H),
    }
    return {
        "patch_embed": init(C * p * p, H),  # the conv as an unfold and a matmul
        "class_embed": init(H),
        "pos_embed": init(n_pos, H),
        "pre_ln_scale": ones(H),
        "pre_ln_bias": zeros(H),
        "layers": layers,
    }


def _patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, n_patches, C*patch*patch], channel-major within a
    patch (HF's Conv2d weight layout [out, C, ph, pw])."""
    B, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, ph, pw]
    return x.reshape(B, gh * gw, C * patch * patch)


def _block(x, lp, Hn, eps):
    B, N, H = x.shape
    D = H // Hn
    residual = x
    y = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], eps)
    q, k, v = ((y @ lp[w] + lp[b]).view(B, N, Hn, D).transpose(1, 2)
               for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    # bf16 products are exact in fp32: fp32 operands give the fp32
    # accumulation and output of JAX's preferred_element_type=float32.
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / D**0.5)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, H)
    x = residual + attn @ lp["wo"] + lp["bo"]
    residual = x
    y = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], eps)
    y = quick_gelu(y @ lp["fc1_w"] + lp["fc1_b"])
    return residual + y @ lp["fc2_w"] + lp["fc2_b"]


def vision_forward(params: dict, vcfg, pixel_values: torch.Tensor,
                   feature_layer: int = -2) -> torch.Tensor:
    """pixel_values [B, C, S, S] -> hidden states [B, 1 + num_patches, H]
    of the selected layer (HF's ``hidden_states[feature_layer]``: the input
    of block ``feature_layer % (L + 1)``, so only the blocks before it
    run)."""
    L, eps = vcfg.num_hidden_layers, vcfg.layer_norm_eps
    patches = _patchify(pixel_values.to(params["patch_embed"].dtype), vcfg.patch_size)
    h = patches @ params["patch_embed"]  # [B, N, H]
    B, _, H = h.shape
    cls = params["class_embed"].expand(B, 1, H)
    h = torch.cat([cls, h], dim=1) + params["pos_embed"]
    x = layer_norm(h, params["pre_ln_scale"], params["pre_ln_bias"], eps)
    layers = params["layers"]
    for i in range(feature_layer % (L + 1)):
        x = _block(x, {k: w[i] for k, w in layers.items()}, vcfg.num_attention_heads, eps)
    return x
