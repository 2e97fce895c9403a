"""Batch, streaming, text and chat generation over an InferenceEngine (port
of ``lite_llama_tpu/generation/generate.py``).

Generation runs through the engine's chunked decode (one host sync per
chunk); the streaming API trades chunk size down (default 4) for latency.
Prompts are handed to admission, so a prefix-cache engine registers and hits
shared prompt prefixes here too. The token-level APIs (``generate_tokens``,
``stream_tokens``) need no tokenizer; the text level (``text_completion``,
``text_completion_stream``, which holds back incomplete UTF-8, and
``chat_completion``, rendered through the tokenizer's chat template or the
family prompter of ``utils/prompts.py``) takes any object with ``encode`` /
``decode``.
"""

from __future__ import annotations

import dataclasses
from typing import Generator, List, Optional, Sequence

import numpy as np

from ..executor.engine import InferenceEngine
from ..utils.prompts import get_prompter
from .sampling import SamplingParams


@dataclasses.dataclass
class CompletionOutput:
    token_ids: List[int]
    text: Optional[str] = None
    logprobs: Optional[List[float]] = None
    finish_reason: str = "length"  # or "stop"


# Special tags never allowed inside user-supplied chat content.
SPECIAL_TAGS = ["[INST]", "[/INST]", "<<SYS>>", "<</SYS>>"]
UNSAFE_ERROR = "Error: special tags are not allowed as part of the prompt."


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
        lens, max_total, slots, sampling = self._admit(prompt_tokens, max_gen_len, temperature,
                                                       top_p, top_k)
        yield from self._stream(lambda: self.engine.prefill(prompt_tokens, sampling, slots),
                                lens, max_total, slots, sampling, chunk)

    def _stream(self, prefill, lens, max_total, slots, sampling, chunk):
        """The streaming loop over admitted ``slots`` (prompt ``lens`` in the
        pool, budgets ``max_total``): ``prefill()`` returns the prefill's
        outputs, first tokens first; the slots are released at the end."""
        eng = self.engine
        B = len(slots)
        try:
            first_tok = prefill()[0]
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

    # -- text-level -------------------------------------------------------
    def _require_tokenizer(self):
        if self.tokenizer is None:
            raise ValueError("the text API requires a tokenizer")

    def text_completion(self, prompts: Sequence[str], **kw) -> List[CompletionOutput]:
        self._require_tokenizer()
        toks = [self.tokenizer.encode(p) for p in prompts]
        return self.generate_tokens(toks, **kw)

    def chat_completion(
        self,
        dialogs: Sequence[Sequence[dict]],
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = None,
        logprobs: bool = False,
    ) -> List[dict]:
        """Multi-turn chat completion.

        Each dialog is a list of {"role": system|user|assistant,
        "content": str} messages; roles must alternate user/assistant after
        an optional leading system message and end with a user turn. Prompts
        render through the tokenizer's chat template when it has one, else
        through the model-family prompter. Returns ChatPrediction dicts:
        {"generation": {"role", "content"}, "tokens"?, "logprobs"?}; a dialog
        holding a special tag gets ``UNSAFE_ERROR`` as its content.
        """
        self._require_tokenizer()
        if max_gen_len is None:
            max_gen_len = self.engine.config.max_seq_len - 1
        unsafe = [any(tag in m["content"] for tag in SPECIAL_TAGS for m in d) for d in dialogs]
        prompt_tokens = []
        for dialog in dialogs:
            if not dialog or dialog[-1]["role"] != "user":
                raise ValueError("last message must be from the user")
            body = dialog[1:] if dialog[0]["role"] == "system" else dialog
            if not (all(m["role"] == "user" for m in body[::2])
                    and all(m["role"] == "assistant" for m in body[1::2])):
                raise ValueError("roles must alternate user/assistant")
            if getattr(self.tokenizer, "chat_template", None):
                ids = self.tokenizer.apply_chat_template(list(dialog), add_generation_prompt=True)
            else:
                prompter = get_prompter(self.engine.config.model_type)
                if dialog[0]["role"] == "system":
                    prompter.system_prompt = dialog[0]["content"]
                for user_msg, reply in zip(body[::2], body[1::2]):
                    prompter.insert_prompt(user_msg["content"])
                    prompter.update_last_reply(reply["content"])
                ids = self.tokenizer.encode(prompter.insert_prompt(body[-1]["content"]))
            prompt_tokens.append(ids)
        outs = self.generate_tokens(prompt_tokens, max_gen_len=max_gen_len,
                                    temperature=temperature, top_p=top_p, logprobs=logprobs)
        preds = []
        for out, is_unsafe in zip(outs, unsafe):
            pred = {"generation": {"role": "assistant",
                                   "content": UNSAFE_ERROR if is_unsafe else (out.text or "")}}
            if logprobs:
                pred["tokens"] = [self.tokenizer.decode([t]) for t in out.token_ids]
                pred["logprobs"] = out.logprobs
            preds.append(pred)
        return preds

    def text_completion_stream(self, prompts: Sequence[str], **kw
                               ) -> Generator[List[str], None, None]:
        """Yields per-request newly decoded text fragments."""
        self._require_tokenizer()
        toks = [self.tokenizer.encode(p) for p in prompts]
        yield from self._text_fragments(self.stream_tokens(toks, **kw), len(prompts))

    def _text_fragments(self, token_stream, n: int) -> Generator[List[str], None, None]:
        """Decoded text fragments of a token stream of ``n`` requests."""
        pending: List[List[int]] = [[] for _ in range(n)]
        for new in token_stream:
            frags = []
            for i, ids in enumerate(new):
                pending[i].extend(ids)
                text = self.tokenizer.decode(pending[i])
                # Hold back incomplete UTF-8 (replacement char at the tail).
                if text and not text.endswith("\ufffd"):
                    frags.append(text)
                    pending[i] = []
                else:
                    frags.append("")
            yield frags

    # -- helpers ----------------------------------------------------------
    def _truncate_at_eos(self, ids: List[int]) -> List[int]:
        for j, t in enumerate(ids):
            if t in self.eos_ids:
                return ids[: j + 1]
        return ids

    def _decode(self, ids: List[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.decode([t for t in ids if t not in self.eos_ids])
