"""Greedy speculative decoding with prompt-lookup (n-gram) drafts (port of
``lite_llama_tpu/generation/speculative.py``).

No draft model: drafts come from matching a request's last n-gram against
its own prompt + generation history. Where the continuation already appears
in the context (extraction, summarisation, code edits) several tokens
verify per forward; on novel text acceptance drops to zero and a step
emits the one token the model would have decoded anyway.

A verify step (``InferenceEngine.spec_verify``) allocates pages for the
optimistic chunk ``[current token | drafts]``, runs one chunked prefill over
it against the paged pool (K5 on the card), keeps the longest draft prefix
that matches the model's argmax, emits it with the model's bonus token and
rewinds the lengths and pages past it (``kv_cache.rewind_requests``). Every
emitted token is the argmax of a forward over its true prefix, so the stream
is a greedy decode by construction; under the same arithmetic it equals
``TextGenerator``'s greedy stream token for token (the CPU tests hold both
against the JAX package). In bf16 on the card the verify chunk's attention
(K5) and decode's (K1) round differently, so the two streams may part at a
near tie; the spec stream stays self-consistent.

Two modes:

- chunked (``chunk_steps > 0``, the default): drafting runs on the device
  (``device_prompt_lookup`` over a device-resident history) and
  ``chunk_steps`` verify iterations run per dispatch
  (``InferenceEngine.spec_decode_chunk``; on the card a replayed CUDA
  graph), so the host syncs once a chunk;
- per step (``chunk_steps=0``): the host drafts (``prompt_lookup_draft``)
  and each ``spec_verify`` costs one host copy.

Greedy only: ``temperature != 0`` raises, as sampling would need rejection
resampling to keep its distribution.

On a mesh it runs at tp and cp, every rank making the same calls (the
verify step eager there: it holds collectives), and refuses dp, as the JAX
generator does: the verify chunk has no data-group layout.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..executor.engine import InferenceEngine
from .generate import CompletionOutput, TextGenerator
from .sampling import SamplingParams


def device_prompt_lookup(history: torch.Tensor, hist_len: torch.Tensor, k: int,
                         ngram: int = 3, min_ngram: int = 1):
    """Batched prompt-lookup drafting on the device, with no host sync:
    ``prompt_lookup_draft``'s policy (longest n first, the most recent
    earlier occurrence of the row's last n-gram wins, the continuation
    clamped to the valid history) over ``history`` int32 [B, S], row b valid
    in [0, hist_len[b]). Returns (drafts [B, k] int32, zero past d[b]; d [B]
    int32, the tokens row b proposes)."""
    B, S = history.shape
    dev = history.device
    i32 = dict(dtype=torch.int32, device=dev)
    pos = torch.arange(S, **i32)
    hist_len = hist_len.to(torch.int32)
    best_s = torch.full((B,), -1, **i32)
    best_n = torch.zeros((B,), **i32)
    for n in range(ngram, min_ngram - 1, -1):
        # tail[b, i] = history[b, hist_len[b] - n + i]
        ti = hist_len[:, None] - n + torch.arange(n, **i32)[None, :]
        tail = torch.gather(history, 1, ti.clamp(min=0).long())
        m = torch.ones((B, S), dtype=torch.bool, device=dev)
        for i in range(n):
            # history[b, s + i] for every s: the wrapped entries sit at
            # s > hist_len - n - 1 and are masked below.
            m &= torch.roll(history, -i, dims=1) == tail[:, i:i + 1]
        m &= pos[None, :] <= hist_len[:, None] - n - 1
        m &= hist_len[:, None] > n
        s_n = torch.where(m, pos[None, :], -1).amax(dim=1)
        take = (best_n == 0) & (s_n >= 0)
        best_s = torch.where(take, s_n, best_s)
        best_n = torch.where(take, n, best_n)
    start = best_s + best_n  # first continuation position
    di = start[:, None] + torch.arange(k, **i32)[None, :]
    drafts = torch.gather(history, 1, di.clamp(0, S - 1).long())
    d = torch.where(best_n > 0, (hist_len - start).clamp(0, k), 0).to(torch.int32)
    drafts = torch.where(torch.arange(k, **i32)[None, :] < d[:, None], drafts, 0)
    return drafts.to(torch.int32), d


def prompt_lookup_draft(history: Sequence[int], k: int, ngram: int = 3,
                        min_ngram: int = 1) -> List[int]:
    """Propose up to ``k`` tokens by matching the last n-gram of ``history``
    against its earlier occurrences (longest n first, most recent match
    wins). Returns [] when nothing matches."""
    h = list(history)
    n_hist = len(h)
    for n in range(ngram, min_ngram - 1, -1):
        if n_hist <= n:
            continue
        tail = h[-n:]
        for s in range(n_hist - n - 1, -1, -1):  # most recent earlier occurrence
            if h[s:s + n] == tail:
                cont = h[s + n:s + n + k]
                if cont:
                    return cont
                break
    return []


class SpeculativeTextGenerator:
    """Greedy batch completion with prompt-lookup speculative decoding: the
    contract of ``TextGenerator.generate_tokens(temperature=0)``, with
    repetitive or extractive prompts decoding several tokens per forward."""

    def __init__(self, engine: InferenceEngine, tokenizer=None, draft_len: int = 4,
                 ngram: int = 3, chunk_steps: int = 8):
        """``chunk_steps > 0``: device drafting and ``chunk_steps`` verify
        steps per dispatch (one host sync a chunk); ``chunk_steps=0``: host
        drafting and one ``spec_verify`` (one host copy) a step."""
        engine.refuse_dp()
        self.engine = engine
        self.tokenizer = tokenizer
        self.draft_len = draft_len
        self.ngram = ngram
        self.chunk_steps = chunk_steps
        self._tg = TextGenerator(engine, tokenizer)  # eos wiring and decoding
        self.eos_ids = self._tg.eos_ids

    def generate_tokens(self, prompt_tokens: Sequence[Sequence[int]], max_gen_len: int = 128,
                        temperature: float = 0.0, echo: bool = False) -> List[CompletionOutput]:
        if temperature != 0.0:
            raise ValueError("speculative decoding is greedy only (temperature=0): sampling "
                             "would need rejection resampling, which is not implemented")
        eng = self.engine
        B = len(prompt_tokens)
        lens = [len(t) for t in prompt_tokens]
        max_total = [min(n + max_gen_len, eng.config.max_seq_len) for n in lens]
        slots = eng.admit_requests(max_total, prompts=prompt_tokens)
        try:
            sampling = SamplingParams.make(B, temperature=0.0, device="cpu")
            first_tok = eng.prefill(prompt_tokens, sampling, slots)[0]
            if self.chunk_steps > 0:
                out = self._run_chunked(prompt_tokens, first_tok, slots, max_total)
            else:
                out = self._run_per_step(prompt_tokens, first_tok, slots, max_total)
        finally:
            eng.release_slots(slots, max_total)
        return self._finish(prompt_tokens, lens, max_total, echo, out)

    def _run_per_step(self, prompt_tokens, first_tok, slots, max_total):
        """Host-drafted loop: one ``spec_verify`` (one host copy) a step."""
        eng = self.engine
        B = len(prompt_tokens)
        K = self.draft_len + 1  # chunk = [current token | drafts]
        history = [list(p) + [int(first_tok[i])] for i, p in enumerate(prompt_tokens)]
        out_tokens = [[int(first_tok[i])] for i in range(B)]
        cur = [int(t) for t in first_tok]  # each row's current next token
        done = [cur[i] in self.eos_ids or len(history[i]) >= max_total[i] for i in range(B)]
        while not all(done):
            chunk = np.zeros((B, K), np.int32)
            chunk_lens = np.zeros((B,), np.int32)
            for i in range(B):
                if done[i]:
                    continue
                # A step emits up to len(drafts) + 1 tokens: never past the budget.
                room = max_total[i] - len(history[i])
                drafts = prompt_lookup_draft(history[i], min(self.draft_len, room - 1),
                                             self.ngram)
                chunk[i, 0] = cur[i]
                chunk[i, 1:1 + len(drafts)] = drafts
                chunk_lens[i] = 1 + len(drafts)
            emit, n_emit, next_tok = eng.spec_verify(slots, chunk, chunk_lens)
            for i in range(B):
                if chunk_lens[i] == 0:
                    continue
                for t in emit[i, :int(n_emit[i])]:
                    out_tokens[i].append(int(t))
                    history[i].append(int(t))
                    if int(t) in self.eos_ids or len(history[i]) >= max_total[i]:
                        done[i] = True
                        break
                cur[i] = int(next_tok[i])
        return out_tokens

    def _run_chunked(self, prompt_tokens, first_tok, slots, max_total):
        """Device-drafted loop: history, drafting, verify and termination
        stay on the device; the host reads each chunk's tokens once."""
        eng = self.engine
        B = len(prompt_tokens)
        S = eng.config.max_seq_len
        hist = np.zeros((B, S), np.int32)
        hl = np.zeros((B,), np.int32)
        for i, p in enumerate(prompt_tokens):
            hist[i, :len(p)] = p
            hist[i, len(p)] = int(first_tok[i])
            hl[i] = len(p) + 1
        cur = np.asarray(first_tok, np.int32)
        done = np.asarray([int(cur[i]) in self.eos_ids or hl[i] >= max_total[i]
                           for i in range(B)])
        out_tokens = [[int(first_tok[i])] for i in range(B)]
        state = (eng._ids(hist), eng._ids(hl), eng._ids(cur), eng._ids(done, torch.bool))
        while not done.all():
            *state, emits, keeps, done = eng.spec_decode_chunk(
                slots, *state, max_total, n_steps=self.chunk_steps,
                draft_len=self.draft_len, ngram=self.ngram)
            for s in range(emits.shape[0]):
                for i in range(B):
                    out_tokens[i].extend(int(t) for t in emits[s, i, :int(keeps[s, i])])
        return out_tokens

    def _finish(self, prompt_tokens, lens, max_total, echo, out_tokens):
        results = []
        for i in range(len(prompt_tokens)):
            toks = self._tg._truncate_at_eos(out_tokens[i][:max_total[i] - lens[i]])
            finish = "stop" if (toks and toks[-1] in self.eos_ids) else "length"
            ids = (list(prompt_tokens[i]) if echo else []) + toks
            results.append(CompletionOutput(token_ids=ids, text=self._tg._decode(ids),
                                            finish_reason=finish))
        return results
