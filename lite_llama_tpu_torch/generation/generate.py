"""Batch generation over an InferenceEngine (port of
``lite_llama_tpu/generation/generate.py``, ``TextGenerator.generate_tokens``).

Generation runs through the engine's chunked decode (one host sync per
chunk). Token ids are enough; the tokenizer is optional and only turns the
result into text. Streaming and the chat/text front ends are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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
    """Batch completion over an InferenceEngine."""

    def __init__(self, engine: InferenceEngine, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        eos = engine.config.eos_token_ids
        if not eos and tokenizer is not None and tokenizer.eos_token_id is not None:
            eos = [tokenizer.eos_token_id]
            engine.set_eos(eos)
        self.eos_ids = set(eos or [])

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
        lens = [len(t) for t in prompt_tokens]
        max_total = [min(n + max_gen_len, eng.config.max_seq_len) for n in lens]
        slots = eng.admit_requests(max_total)
        try:
            sampling = SamplingParams.make(
                B, temperature=temperature, top_p=top_p, top_k=top_k, device=eng.device
            )
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

    def _truncate_at_eos(self, ids: List[int]) -> List[int]:
        for j, t in enumerate(ids):
            if t in self.eos_ids:
                return ids[: j + 1]
        return ids

    def _decode(self, ids: List[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.decode([t for t in ids if t not in self.eos_ids])
