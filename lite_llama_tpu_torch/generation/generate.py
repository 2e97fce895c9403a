"""Batch and streaming generation over an InferenceEngine (port of
``lite_llama_tpu/generation/generate.py``, ``TextGenerator.generate_tokens``
and ``stream_tokens``).

Generation runs through the engine's chunked decode (one host sync per
chunk); the streaming API trades chunk size down (default 4) for latency.
Prompts are handed to admission, so a prefix-cache engine registers and hits
shared prompt prefixes here too. Token ids are enough; the tokenizer is
optional and only turns the result into text. The chat front end waits for
the prompt templates (``utils/prompts.py``), which wait for a tokenizer in
the repository.
"""

from __future__ import annotations

import dataclasses
from typing import Generator, List, Optional, Sequence

import numpy as np

from ..executor.engine import InferenceEngine
from .sampling import SamplingParams


@dataclasses.dataclass
class CompletionOutput:
    token_ids: List[int]
    text: Optional[str] = None
    logprobs: Optional[List[float]] = None
    finish_reason: str = "length"  # or "stop"


class TextGenerator:
    """Batch and streaming completion over an InferenceEngine."""

    def __init__(self, engine: InferenceEngine, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        eos = engine.config.eos_token_ids
        if not eos and tokenizer is not None and tokenizer.eos_token_id is not None:
            eos = [tokenizer.eos_token_id]
            engine.set_eos(eos)
        self.eos_ids = set(eos or [])

    def _admit(self, prompt_tokens, max_gen_len, temperature, top_p, top_k):
        eng = self.engine
        lens = [len(t) for t in prompt_tokens]
        max_total = [min(n + max_gen_len, eng.config.max_seq_len) for n in lens]
        slots = eng.admit_requests(max_total, prompts=prompt_tokens)
        # Host-side parameters: the engine uploads them without a sync.
        sampling = SamplingParams.make(len(prompt_tokens), temperature=temperature,
                                       top_p=top_p, top_k=top_k, device="cpu")
        return lens, max_total, slots, sampling

    def generate_tokens(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        max_gen_len: int = 128,
        temperature: float = 0.6,
        top_p: float = 0.9,
        top_k: int = 0,
        echo: bool = False,
        logprobs: bool = False,
    ) -> List[CompletionOutput]:
        """Non-streaming batch completion with optional per-token logprobs."""
        eng = self.engine
        B = len(prompt_tokens)
        lens, max_total, slots, sampling = self._admit(prompt_tokens, max_gen_len, temperature,
                                                       top_p, top_k)
        try:
            first_tok, _, _, lp0 = eng.prefill(prompt_tokens, sampling, slots)
            out_tokens = [[int(first_tok[i])] for i in range(B)]
            out_lps = [[float(lp0[i])] for i in range(B)]
            done_host = np.asarray(
                [t in self.eos_ids or lens[i] + 1 >= max_total[i]
                 for i, t in enumerate(first_tok)]
            )
            steps_left = max(mt - n - 1 for mt, n in zip(max_total, lens))
            if steps_left > 0 and not bool(done_host.all()):
                _, _, toks, lps = eng.decode(
                    slots, first_tok, done_host, max_total, sampling, n_steps=steps_left
                )
                for i in range(B):
                    if not done_host[i]:
                        out_tokens[i].extend(int(t) for t in toks[:, i])
                        out_lps[i].extend(float(v) for v in lps[:, i])
        finally:
            eng.release_slots(slots, max_total)
        results = []
        for i in range(B):
            # Trim steps past each request's budget, then cut at eos.
            toks_i = self._truncate_at_eos(out_tokens[i][: max_total[i] - lens[i]])
            finish = "stop" if (toks_i and toks_i[-1] in self.eos_ids) else "length"
            ids = (list(prompt_tokens[i]) if echo else []) + toks_i
            lps_i = None
            if logprobs:
                lps_i = out_lps[i][: len(toks_i)]
                if echo:
                    lps_i = [None] * len(prompt_tokens[i]) + lps_i
            results.append(CompletionOutput(
                token_ids=ids, text=self._decode(ids), logprobs=lps_i, finish_reason=finish,
            ))
        return results

    def stream_tokens(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        max_gen_len: int = 128,
        temperature: float = 0.6,
        top_p: float = 0.9,
        top_k: int = 0,
        chunk: int = 4,
    ) -> Generator[List[List[int]], None, None]:
        """Streaming: yields the newly generated token ids per request after
        the prefill and after every ``chunk`` decode steps."""
        eng = self.engine
        B = len(prompt_tokens)
        lens, max_total, slots, sampling = self._admit(prompt_tokens, max_gen_len, temperature,
                                                       top_p, top_k)
        try:
            first_tok, _, _, _ = eng.prefill(prompt_tokens, sampling, slots)
            done_host = np.asarray(
                [t in self.eos_ids or lens[i] + 1 >= max_total[i]
                 for i, t in enumerate(first_tok)]
            )
            produced = [1] * B
            yield [[int(first_tok[i])] for i in range(B)]
            tok, done = first_tok, done_host
            steps_left = max(mt - n - 1 for mt, n in zip(max_total, lens))
            while steps_left > 0 and not bool(done_host.all()):
                n = min(chunk, steps_left)
                tok, done, toks, _ = eng.decode(slots, tok, done, max_total, sampling,
                                                n_steps=n)
                new_done = done.cpu().numpy()
                out = []
                for i in range(B):
                    if done_host[i]:
                        out.append([])
                    else:
                        remaining = max_total[i] - lens[i] - produced[i]
                        row = self._truncate_at_eos([int(t) for t in toks[:, i]][:remaining])
                        produced[i] += len(row)
                        out.append(row)
                done_host = new_done
                steps_left -= n
                yield out
        finally:
            eng.release_slots(slots, max_total)

    def _truncate_at_eos(self, ids: List[int]) -> List[int]:
        for j, t in enumerate(ids):
            if t in self.eos_ids:
                return ids[: j + 1]
        return ids

    def _decode(self, ids: List[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.decode([t for t in ids if t not in self.eos_ids])
