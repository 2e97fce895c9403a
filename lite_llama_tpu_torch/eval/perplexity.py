"""Corpus perplexity through the engine's own forward path (port of
``lite_llama_tpu/eval/perplexity.py``).

``corpus_perplexity`` scores token sequences with the code generation uses,
chunked prefill through the paged pool, so a quantized-weight tree runs the
quantized matmuls and a quantized KV pool the dequantizing history reads (on
the card: K5 / K5q, K3, K4, and K6 where a chunk has at most 256 rows). It
is the measurement half of the quantization gate (``validate.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


@torch.inference_mode()
def corpus_perplexity(
    cfg,
    params: dict,
    seqs: Sequence[Sequence[int]],
    *,
    kv_quant=False,  # False | True/'int8' | 'fp8': the pool the history rides
    batch_size: int = 4,
    chunk: int = 256,
    page_size: int = 16,
    device="cuda",
    keep_last_logits: bool = False,
) -> dict:
    """Next-token perplexity of ``seqs`` under the decoder, on ``device``
    (where ``params`` live).

    Each batch runs as a fresh paged-cache session: successive ``chunk``-
    sized windows prefill through ``decoder_prefill(chunked=True)``, so
    positions past the first window attend pool history, the read path
    (and kernel) long-prompt serving uses, quantized pools included. Each
    chunk's fp32 logits are reduced to its summed log-probability on the
    device and dropped. Returns ``{"perplexity", "nll", "tokens"}`` with
    natural-log NLL per predicted token; ``keep_last_logits`` adds the last
    chunk's logits ([B, chunk, V], on the device) as ``"last_logits"``.
    """
    from ..executor.engine import require_device
    from ..executor.kv_cache import alloc_prefill, cdiv, create_kv_cache
    from ..models.decoder import AttnContext, decoder_prefill

    dev = require_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, the run on {dev}")
    seqs = [list(s) for s in seqs if len(s) >= 2]
    if not seqs:
        raise ValueError("perplexity needs sequences of >= 2 tokens")
    chunk_sums = []  # fp32 sum of each chunk's log-probabilities, on the device
    total_n = 0
    logits = None
    for b0 in range(0, len(seqs), batch_size):
        batch = seqs[b0:b0 + batch_size]
        B = len(batch)
        lens = np.asarray([len(s) for s in batch], np.int32)
        S = cdiv(int(lens.max()), chunk) * chunk
        toks = np.zeros((B, S + 1), np.int64)
        for i, s in enumerate(batch):
            toks[i, :len(s)] = s
        cache = create_kv_cache(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
            num_pages=B * cdiv(S, page_size) + 2, page_size=page_size, max_reqs=B,
            max_seq_len=max(S, chunk), dtype=cfg.dtype, device=dev, quantized=kv_quant,
        )
        req = torch.arange(B, dtype=torch.int32, device=dev)
        lens_d = torch.from_numpy(lens).to(dev)
        alloc_prefill(cache, req, lens_d)
        table_rows = cache.page_table[req.long()]
        toks_d = torch.from_numpy(toks).to(dev)
        for c0 in range(0, S, chunk):
            chunk_lens = np.clip(lens - c0, 0, chunk).astype(np.int32)
            if not chunk_lens.any():
                break
            cl = torch.from_numpy(chunk_lens).to(dev)
            ctx = AttnContext(table_rows=table_rows, seq_lens=lens_d,
                              start_pos=torch.full_like(lens_d, c0), chunk_lens=cl,
                              active=cl > 0)
            # No request has more pool history than c0: the plain CPU form
            # gathers only that much.
            hist_bound = min(cdiv(c0, page_size), cache.pages_per_req) * page_size
            logits, _ = decoder_prefill(params, cfg, cache.kv_pages, ctx,
                                        toks_d[:, c0:c0 + chunk], chunked=True,
                                        hist_bound=hist_bound)
            # logits[:, j] predict the token at global position c0 + j + 1.
            next_ids = toks_d[:, c0 + 1:c0 + chunk + 1]
            valid = (c0 + np.arange(chunk)[None, :] + 1) < lens[:, None]
            tok_lp = torch.log_softmax(logits, dim=-1).gather(-1, next_ids[..., None])[..., 0]
            tok_lp = torch.where(torch.from_numpy(valid).to(dev), tok_lp, 0.0)
            chunk_sums.append(tok_lp.sum())
            total_n += int(valid.sum())
            if not keep_last_logits:
                logits = None
    total_lp = float(torch.stack(chunk_sums).double().sum())
    nll = -total_lp / max(total_n, 1)
    out = {"perplexity": math.exp(nll), "nll": nll, "tokens": total_n}
    if keep_last_logits:
        out["last_logits"] = logits
    return out
