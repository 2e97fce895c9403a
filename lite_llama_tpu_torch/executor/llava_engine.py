"""LLaVA engine (port of ``lite_llama_tpu/executor/llava_engine.py``).

``LlavaEngine`` is an ``InferenceEngine`` over the LM (``params["lm"]``)
that keeps the CLIP tower and the projector beside it and adds an
image-aware prefill: the tower, the projector, the image-token merge and
the LM prefill, as one fresh prefill at the exact expanded lengths (each
``<image>`` becomes num_patches rows; the host computes the lengths first).
That prefill never chunks, whatever ``prefill_chunk`` is, as the JAX
engine's multimodal step never does: on the card it runs K2 over the whole
expanded prompt. Text-only prompts take the base engine's prefill, and
decode is the base engine's (the replayed CUDA graph on the card).

Where the port differs from the JAX engine: no power-of-two bucketing of
rows or lengths, so the tower runs only on the rows that have an image (JAX
runs a blank image through it for its pad rows); a row holds at most one
image placeholder. On a tensor-parallel mesh the LM shards and the tower
and the projector are whole on every rank, as in the JAX engine; like it,
the engine refuses data parallelism (the multimodal prefill runs the whole
batch, with no group layout).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..generation.sampling import SamplingParams, log_softmax_gather, sample
from ..models.decoder import AttnContext
from ..models.llava import expand_image_tokens_host, llava_prefill
from .engine import InferenceEngine, _PrefillBundle
from .kv_cache import alloc_prefill


class LlavaEngine(InferenceEngine):
    """Owns a LLaVA tree {"lm", "vision", "projector"} and the LM's paged KV
    cache on one device."""

    def __init__(self, config, params: dict, **kw):
        super().__init__(config, params["lm"], **kw)
        if self.dp > 1:
            raise NotImplementedError(
                "LlavaEngine does not support data parallelism (dp > 1): the multimodal "
                "prefill runs the whole batch on every rank, with no group layout. Use a "
                "tp-only mesh or the text-only InferenceEngine.")
        self.vision = params["vision"]
        self.projector = params["projector"]

    def expanded_lens(self, token_lists: Sequence[Sequence[int]]) -> List[int]:
        """Each prompt's length in the KV pool, its image placeholder
        expanded (ValueError for more than one)."""
        return expand_image_tokens_host(token_lists, self.config.image_token_index,
                                        self.config.num_image_patches)

    def prefill_multimodal(self, token_lists: Sequence[Sequence[int]],
                           pixel_values: Optional[np.ndarray], sampling: SamplingParams, slots,
                           return_logits: bool = False):
        """Blocking multimodal prefill: dispatch + collect. Returns
        (first_tokens [B] np, expanded_lens [B] np, last_logits [B, V] np or
        None, logprobs [B] np)."""
        return self.prefill_collect(self.prefill_multimodal_async(
            token_lists, pixel_values, sampling, slots, return_logits=return_logits))

    @torch.inference_mode()
    def prefill_multimodal_async(self, token_lists: Sequence[Sequence[int]],
                                 pixel_values: Optional[np.ndarray], sampling: SamplingParams,
                                 slots, return_logits: bool = False) -> _PrefillBundle:
        """Dispatch the multimodal prefill of raw prompts (at most one
        ``<image>`` each) into their slots and the first-token sampling.
        ``pixel_values`` [B, C, S, S] holds one image per prompt (rows of
        prompts without a placeholder are not read) or is None when no
        prompt has one. The bundle's ``lens`` are the expanded lengths,
        what the pool holds, so the scheduler splices image requests into a
        session as it does text requests."""
        self.stats.calls += 1
        B = len(token_lists)
        raw = np.asarray([len(t) for t in token_lists], np.int32)
        exp = np.asarray(self.expanded_lens(token_lists), np.int32)
        if int(exp.max()) > self.config.max_seq_len:
            raise ValueError(f"prompt of {int(exp.max())} tokens with its image expanded "
                             f"exceeds max_seq_len={self.config.max_seq_len}")
        has_image = exp != raw
        if has_image.any() and pixel_values is None:
            raise ValueError("a prompt holds an image placeholder but no pixel values were "
                             "given")
        mode = self._samp_mode(sampling)
        samp = self._dev_sampling(sampling)
        req_ids = self._ids(slots)
        lens = self._ids(exp)
        ids = np.full((B, int(exp.max())), self.pad_id, np.int32)
        for i, t in enumerate(token_lists):
            ids[i, : len(t)] = t
        px = None
        if has_image.any():
            px = self._upload(torch.from_numpy(np.ascontiguousarray(
                np.asarray(pixel_values, np.float32)[has_image])))
        alloc_prefill(self.cache, req_ids, lens)
        ctx = AttnContext(table_rows=self.cache.page_table[req_ids.long()], seq_lens=lens,
                          start_pos=torch.zeros_like(lens), chunk_lens=lens)
        params = {"lm": self.params, "vision": self.vision, "projector": self.projector}
        last, _ = llava_prefill(params, self.config, self.cache.kv_pages, ctx,
                                self._ids(ids, torch.long), pixel_values=px,
                                has_image=self._ids(has_image, torch.bool),
                                raw_lens=self._ids(raw), last_only=True, shard=self.shard)
        tok = sample(last, self._gen, samp, mode=mode)
        lp = log_softmax_gather(last, tok)
        self.stats.prefill_tokens += int(exp.sum())
        self._slot_filled.update(slots)
        packed = torch.stack([tok.to(torch.int32), lp.float().view(torch.int32)])
        return _PrefillBundle(packed=self._to_host(packed), tok_dev=tok, lens=exp,
                              last=last if return_logits else None)
