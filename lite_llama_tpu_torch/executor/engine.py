"""InferenceEngine: the executor facade, for one device (port of
``lite_llama_tpu/executor/engine.py``).

Owns the parameters, the paged KV cache and the host-side admission
accounting, and runs prefill and decode:

- prefill: one padded [B, S_max] batch through ``decoder_prefill`` with
  ``last_only``, then the first token is sampled. Prompts longer than
  ``prefill_chunk`` (the chunked path) are not ported yet and raise.
- decode: a Python loop over steps (allocate -> forward -> sample -> eos
  bookkeeping, all on the device) that syncs with the host once per
  ``decode_chunk`` steps, as the JAX engine's scanned chunk does.
- a host-side capacity guard refuses admission when the page pool could be
  exhausted (the device-side allocator is masked arithmetic and cannot
  raise).

The JAX engine pads batch and prompt widths to power-of-two buckets to bound
XLA recompiles. PyTorch compiles nothing per shape, so the port runs every
batch at its own width and drops the bucketing (and with it the sentinel
rows of padded batches).

Not ported yet, and refused: the chunked prefill path, the prefix cache,
quantized KV pools, speculative decoding, serving sessions and data
parallelism.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import BaseConfig
from ..generation.sampling import SamplingParams, log_softmax_gather, needs_exact_sampling, sample
from ..models.decoder import AttnContext, decoder_decode, decoder_prefill
from .kv_cache import (
    alloc_decode,
    alloc_prefill,
    cdiv,
    create_kv_cache,
    free_requests,
    kv_cache_bytes,
)


class InferenceEngine:
    """Owns params + paged KV cache for one model on one device."""

    def __init__(
        self,
        config: BaseConfig,
        params: dict,
        *,
        device="cuda",
        page_size: int = 16,
        max_reqs: int = 64,
        num_pages: Optional[int] = None,
        hbm_util: float = 0.9,
        decode_chunk: int = 32,
        prefill_chunk: int = 2048,
        kv_quant=False,
        prefix_cache: bool = False,
        mesh=None,
        seed: int = 0,
    ):
        if kv_quant:
            raise NotImplementedError("quantized KV pools are not ported yet")
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch path"
            )
        emb = params["embed"]
        if emb.dtype != config.dtype:
            raise ValueError(
                f"params dtype {emb.dtype} != config.dtype {config.dtype}: cast the "
                "weights or the config (activations follow config.dtype)"
            )
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine on {self.device}")
        self.config = config
        self.params = params
        self.page_size = page_size
        self.max_reqs = max_reqs
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk
        if num_pages is None:
            num_pages = self._auto_num_pages(hbm_util)
        self.num_pages = num_pages
        self.cache = create_kv_cache(
            config.num_hidden_layers, config.num_key_value_heads, config.head_dim,
            num_pages=num_pages, page_size=page_size, max_reqs=max_reqs,
            max_seq_len=config.max_seq_len, dtype=config.dtype, device=self.device,
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._free_slots = list(range(max_reqs))
        self._host_free_pages = num_pages
        self.pad_id = config.pad_token_id if config.pad_token_id is not None else 0
        self.set_eos(config.eos_token_ids)
        # Host-side slot/page accounting is guarded by one lock so concurrent
        # submitters can admit and release safely.
        self._admission_lock = threading.RLock()

    def set_eos(self, eos_ids: Sequence[int]) -> None:
        """Token ids that end a request during decode."""
        ids = list(eos_ids) or [-1]
        self._eos = torch.tensor(ids, dtype=torch.int32, device=self.device)

    # -- host capacity accounting -----------------------------------------
    def admit_feasible(self, total_len: int) -> bool:
        """Could a request of ``total_len`` tokens EVER be admitted (with an
        idle engine)? False means waiting is pointless."""
        return (
            0 < total_len <= self.config.max_seq_len
            and cdiv(total_len, self.page_size) <= self.num_pages
        )

    def try_admit(self, total_len: int):
        """Reserve a slot and the pages for ``total_len`` tokens; returns the
        slot, or None when either is short."""
        with self._admission_lock:
            need = cdiv(total_len, self.page_size)
            if not self._free_slots or self._host_free_pages < need:
                return None
            self._host_free_pages -= need
            return self._free_slots.pop(0)

    def admit_requests(self, total_lens: Sequence[int]) -> List[int]:
        """try_admit for a whole batch; raises (and rolls back) if any
        request cannot be placed."""
        with self._admission_lock:
            slots: List[int] = []
            for n in total_lens:
                s = self.try_admit(n)
                if s is None:
                    self.release_slots(slots, total_lens[: len(slots)])
                    raise RuntimeError(
                        f"KV capacity exhausted: {len(slots)}/{len(total_lens)} requests "
                        f"placed (free pages: {self._host_free_pages}, free slots: "
                        f"{len(self._free_slots)})"
                    )
                slots.append(s)
            return slots

    def release_slots(self, slots: Sequence[int], lens: Sequence[int]):
        with self._admission_lock:
            if not slots:
                return
            free_requests(self.cache, self._ids(slots))
            for s, n in zip(slots, lens):
                self._host_free_pages += cdiv(n, self.page_size)
                self._free_slots.append(s)

    def _auto_num_pages(self, hbm_util: float) -> int:
        """Size the KV pool from free device memory. On the CPU (tests) there
        is no device budget: the pool holds every slot at max_seq_len."""
        cfg = self.config
        want = self.max_reqs * cdiv(cfg.max_seq_len, self.page_size)
        if self.device.type != "cuda":
            return want
        per_page = kv_cache_bytes(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 1,
            self.page_size, cfg.dtype,
        )
        free, total = torch.cuda.mem_get_info(self.device)
        budget = total * hbm_util - (total - free)
        fit = int(budget // per_page)
        return max(64, min(want, fit))

    # -- steps --------------------------------------------------------------
    def _ids(self, xs, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(xs), dtype=dtype).to(self.device)

    def _samp_mode(self, sampling: SamplingParams) -> str:
        """Host-side static sampling mode: "greedy" when every request is
        greedy (no candidate search, no random draw), else exact/approx as
        ``needs_exact_sampling`` decides."""
        t = sampling.temperature.cpu().numpy()
        if np.all(t <= 0.0):
            return "greedy"
        return "exact" if needs_exact_sampling(
            t, sampling.top_p.cpu().numpy(), sampling.top_k.cpu().numpy()
        ) else "approx"

    def _prefill_step(self, ids, lens, req_ids, sampling, mode):
        alloc_prefill(self.cache, req_ids, lens)
        ctx = AttnContext(
            table_rows=self.cache.page_table[req_ids.long()],
            seq_lens=lens,
            start_pos=torch.zeros_like(lens),
            chunk_lens=lens,
        )
        last, _ = decoder_prefill(
            self.params, self.config, self.cache.kv_pages, ctx, ids, last_only=True
        )
        tok = sample(last, self._gen, sampling, mode=mode)
        return tok, last, log_softmax_gather(last, tok)

    @torch.inference_mode()
    def prefill(self, token_lists: Sequence[Sequence[int]], sampling: SamplingParams,
                slots, return_logits: bool = False):
        """Prefill a batch of prompts into their slots. Returns
        (first_tokens [B] np, lens [B] np, last_logits [B, V] np or None,
        logprobs [B] np)."""
        lens_h = np.asarray([len(t) for t in token_lists], np.int32)
        S = int(lens_h.max())
        if S > self.prefill_chunk:
            raise NotImplementedError(
                f"prompt of {S} tokens exceeds prefill_chunk={self.prefill_chunk}: "
                "chunked prefill is not ported yet"
            )
        ids = np.full((len(token_lists), S), self.pad_id, np.int32)
        for i, t in enumerate(token_lists):
            ids[i, : len(t)] = t
        tok, last, lp = self._prefill_step(
            self._ids(ids, torch.long), self._ids(lens_h), self._ids(slots), sampling,
            self._samp_mode(sampling),
        )
        return (
            tok.cpu().numpy(),
            lens_h,
            last.cpu().numpy() if return_logits else None,
            lp.cpu().numpy(),
        )

    def _decode_step(self, req_ids, tok, done, stop, sampling, mode):
        active = ~done
        alloc_decode(self.cache, req_ids, active)
        seq = self.cache.seq_lens[req_ids.long()]
        pos = seq - 1
        ctx = AttnContext(
            table_rows=self.cache.page_table[req_ids.long()],
            seq_lens=seq,
            start_pos=pos,
            chunk_lens=torch.ones_like(pos),
            active=active,
        )
        logits, _ = decoder_decode(
            self.params, self.config, self.cache.kv_pages, ctx, tok.long()
        )
        next_tok = sample(logits, self._gen, sampling, mode=mode)
        emit = torch.where(done, torch.full_like(next_tok, self.pad_id), next_tok)
        emit_lp = torch.where(done, torch.zeros_like(logits[:, 0]),
                              log_softmax_gather(logits, next_tok))
        hit_eos = torch.isin(next_tok, self._eos)
        done = done | hit_eos | (seq >= stop)
        return next_tok, done, emit, emit_lp

    @torch.inference_mode()
    def decode(self, slots, tok, done, stop_lens, sampling: SamplingParams, n_steps: int):
        """Run up to ``n_steps`` decode steps for the requests in ``slots``.
        Returns (tok [B] tensor, done [B] tensor, tokens [n, B] np.int32
        pad-filled after each row's eos, logprobs [n, B] np.float32). The host
        syncs once per ``decode_chunk`` steps and stops early once every row
        is done."""
        B = len(slots)
        req_ids = self._ids(slots)
        tok = torch.as_tensor(tok).to(self.device, torch.int32)
        done = torch.as_tensor(done).to(self.device, torch.bool)
        stop = self._ids(stop_lens)
        mode = self._samp_mode(sampling)
        all_toks, all_lps = [], []
        remaining = n_steps
        while remaining > 0:
            n = min(remaining, self.decode_chunk)
            toks, lps = [], []
            for _ in range(n):
                tok, done, emit, emit_lp = self._decode_step(
                    req_ids, tok, done, stop, sampling, mode
                )
                toks.append(emit)
                lps.append(emit_lp)
            done_h = done.cpu().numpy()  # the chunk's one host sync
            all_toks.append(torch.stack(toks).cpu().numpy())
            all_lps.append(torch.stack(lps).cpu().numpy())
            remaining -= n
            if bool(done_h.all()):
                break
        if not all_toks:
            return tok, done, np.zeros((0, B), np.int32), np.zeros((0, B), np.float32)
        return tok, done, np.concatenate(all_toks), np.concatenate(all_lps)
