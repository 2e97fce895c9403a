"""LLaVA-1.5: CLIP tower + projector + Llama LM (port of
``lite_llama_tpu/models/llava.py``).

- ``init_llava_params``: a random tree from a generator (the JAX tree's
  keys, shapes and dtypes).
- ``encode_images``: the tower's layer -2, the CLS row dropped ("default"
  select strategy), then the projector Linear -> GELU (erf, fp32) ->
  Linear.
- Image-token expansion: each ``<image>`` placeholder becomes the image's
  num_patches rows (576 for LLaVA-1.5). The host computes the expanded
  lengths (``expand_image_tokens_host``); ``merge_image_features`` builds
  the expanded embeddings by the exclusive-cumsum position remap.
- ``llava_prefill``: encode -> merge -> ``decoder_prefill`` with
  ``inputs_embeds``. Decode steps are plain LM steps.

Where the port differs from the JAX package (each has a test):

- One image per request, and a row with two placeholders raises
  ``ValueError`` (JAX sums both starts into one wrong offset).
- The tower runs only on the rows that have an image: ``pixel_values`` and
  ``image_features`` hold one entry per such row, in row order (JAX runs a
  blank image through the tower for every other row).
- The merge writes into an ``S_out + 1`` buffer whose last row takes what
  JAX's scatter drops out of bounds, and slices it off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.activations import gelu
from .decoder import _embed, decoder_prefill, init_decoder_params
from .vision import init_vision_params, vision_forward


def init_llava_params(cfg, generator: torch.Generator, dtype=None) -> dict:
    """Random LLaVA tree ``{"lm", "vision", "projector"}`` drawn from
    ``generator`` on its device, with the JAX package's keys, shapes and
    dtypes: the LM as ``init_decoder_params`` makes it (``cfg.dtype``), the
    tower as ``init_vision_params`` in ``dtype`` (default ``cfg.dtype``), the
    projector's weights ``[in, out]`` N(0, 0.02) drawn in fp32 and cast,
    its biases zero. The draws are not JAX's (a generator is not a key)."""
    dtype = dtype or cfg.dtype
    H_v, H_t = cfg.vision_config.hidden_size, cfg.hidden_size
    device = generator.device
    lm = init_decoder_params(cfg, generator)
    vision = init_vision_params(cfg.vision_config, generator, dtype=dtype)

    def init(*shape, scale=0.02):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, scale, generator=generator).to(dtype)

    projector = {
        "w1": init(H_v, H_t),
        "b1": torch.zeros(H_t, dtype=dtype, device=device),
        "w2": init(H_t, H_t),
        "b2": torch.zeros(H_t, dtype=dtype, device=device),
    }
    return {"lm": lm, "vision": vision, "projector": projector}


def encode_images(params: dict, cfg, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values [N_img, C, S, S] -> patch embeddings [N_img, P, H_text]."""
    hidden = vision_forward(params["vision"], cfg.vision_config, pixel_values,
                            cfg.vision_feature_layer)
    feats = hidden[:, 1:]  # drop CLS ("default" select strategy)
    pr = params["projector"]
    return gelu(feats @ pr["w1"] + pr["b1"]) @ pr["w2"] + pr["b2"]


def expand_image_tokens_host(input_ids: Sequence[Sequence[int]], image_token: int,
                             num_patches: int):
    """Each row's length after expansion (host lists). A row holds at most
    one image placeholder: more raise ValueError."""
    out = []
    for i, row in enumerate(input_ids):
        n_img = sum(1 for t in row if t == image_token)
        if n_img > 1:
            raise ValueError(f"request {i} holds {n_img} image placeholders; LLaVA-1.5 takes "
                             "one image per request")
        out.append(len(row) + n_img * (num_patches - 1))
    return out


def merge_image_features(
    input_ids: torch.Tensor,  # [B, S] (padded)
    lens: torch.Tensor,  # int [B]: valid tokens in input_ids
    image_features: torch.Tensor,  # [N_img, P, H]: one per row with has_image, in order
    has_image: torch.Tensor,  # bool [B]
    embed_table: torch.Tensor,  # [V, H]
    image_token: int,
    S_out: int,
    shard=None,
) -> torch.Tensor:
    """Expand each row's ``<image>`` token into its patch embeddings.
    Returns inputs_embeds [B, S_out, H]; positions past a row's new length
    (``expand_image_tokens_host``) hold zeros. JAX also returns the new
    lengths and arange(S_out) positions, which the prefill does not need.
    Under tensor parallelism (``shard``) ``embed_table`` is the rank's vocab
    rows and the text rows come from the decoder's masked gather and
    all-reduce."""
    B, S = input_ids.shape
    P = image_features.shape[1]
    H = embed_table.shape[1]
    dev = input_ids.device
    s = torch.arange(S, device=dev)
    valid = s[None, :] < lens[:, None]
    is_img = (input_ids == image_token) & valid & has_image[:, None]
    if bool((is_img.sum(1) > 1).any()):
        raise ValueError("a request holds more than one image placeholder; LLaVA-1.5 takes "
                         "one image per request")
    # Each image token occupies P positions, a text token one.
    sizes = torch.where(is_img, P, 1) * valid
    starts = torch.cumsum(sizes, dim=1) - sizes  # exclusive cumsum [B, S]

    # Row S_out takes every write JAX drops (out of bounds) and is cut off.
    out = torch.zeros((B, S_out + 1, H), dtype=embed_table.dtype, device=dev)
    text_dst = torch.where(valid & ~is_img, starts, S_out).clamp(max=S_out)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    text = (embed_table[input_ids] if shard is None or shard.tp == 1
            else _embed({"embed": embed_table}, input_ids, shard))
    out[bidx, text_dst] = text
    # Image i's patch p goes to its placeholder's start + p.
    img_rows = torch.nonzero(has_image).flatten()
    img_start = torch.where(is_img, starts, 0).sum(1)[img_rows]  # [N_img]
    patch_dst = (img_start[:, None] + torch.arange(P, device=dev)).clamp(max=S_out)
    out[img_rows[:, None].expand(-1, P), patch_dst] = image_features.to(embed_table.dtype)
    return out[:, :S_out]


def llava_prefill(params: dict, cfg, kv_pages, ctx, input_ids: torch.Tensor,
                  pixel_values: Optional[torch.Tensor] = None,
                  has_image: Optional[torch.Tensor] = None,
                  raw_lens: Optional[torch.Tensor] = None, last_only: bool = False,
                  shard=None):
    """Multimodal prefill: encode -> merge -> LM prefill with inputs_embeds.
    ``input_ids`` [B, S_out] hold the raw (unexpanded) ids, ``raw_lens`` of
    them per row, padded to the expanded width S_out; ``pixel_values``
    [N_img, C, S, S] one image per row where ``has_image`` (every row when
    it is None). ``ctx`` is allocated for the expanded lengths. Returns
    (logits, kv_pages) as ``decoder_prefill`` does. ``shard``: the LM's
    tensor-parallel policy; the tower and the projector are whole on every
    rank."""
    lm = params["lm"]
    if pixel_values is None:
        return decoder_prefill(lm, cfg, kv_pages, ctx, input_ids, last_only=last_only,
                               shard=shard)
    B = input_ids.shape[0]
    if has_image is None:
        has_image = torch.ones(B, dtype=torch.bool, device=input_ids.device)
    feats = encode_images(params, cfg, pixel_values)
    embeds = merge_image_features(input_ids, raw_lens, feats, has_image, lm["embed"],
                                  cfg.image_token_index, input_ids.shape[1], shard)
    return decoder_prefill(lm, cfg, kv_pages, ctx, inputs_embeds=embeds, last_only=last_only,
                           shard=shard)
