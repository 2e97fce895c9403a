"""Multimodal (LLaVA) generation (port of
``lite_llama_tpu/generation/llava_generate.py``).

``tokenizer_image_token`` tokenizes the text around ``<image>`` placeholders
and splices the image token id in; ``LlavaTextGenerator`` preprocesses the
images, runs the engine's multimodal prefill and streams the decode through
``engine.decode``, whose lengths are the expanded ones.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Sequence

import numpy as np

from ..utils.image import process_images
from .generate import TextGenerator
from .sampling import SamplingParams


def tokenizer_image_token(prompt: str, tokenizer, image_token_id: int,
                          placeholder: str = "<image>") -> List[int]:
    """Token ids of ``prompt`` with ``image_token_id`` in place of each
    placeholder; special tokens (bos) only before the first text chunk."""
    chunks = prompt.split(placeholder)
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        ids.extend(tokenizer.encode(chunk, add_special_tokens=(i == 0)))
        if i < len(chunks) - 1:
            ids.append(image_token_id)
    return ids


class LlavaTextGenerator(TextGenerator):
    """Streaming completion over a ``LlavaEngine`` with image inputs."""

    def stream_tokens_multimodal(
        self,
        prompt_tokens: Sequence[Sequence[int]],  # raw, at most one <image> each
        pixel_values: Optional[np.ndarray],  # [B, C, S, S] or None
        max_gen_len: int = 128,
        temperature: float = 0.6,
        top_p: float = 0.9,
        top_k: int = 0,
        chunk: int = 4,
    ) -> Generator[List[List[int]], None, None]:
        """Yields the newly generated token ids per request after the
        prefill and after every ``chunk`` decode steps."""
        eng = self.engine
        exp_lens = eng.expanded_lens(prompt_tokens)
        max_total = [min(n + max_gen_len, eng.config.max_seq_len) for n in exp_lens]
        slots = eng.admit_requests(max_total)
        sampling = SamplingParams.make(len(prompt_tokens), temperature=temperature, top_p=top_p,
                                       top_k=top_k, device="cpu")
        yield from self._stream(
            lambda: eng.prefill_multimodal(prompt_tokens, pixel_values, sampling, slots),
            exp_lens, max_total, slots, sampling, chunk)

    def text_completion_stream_mm(self, prompts: Sequence[str], image_items: Sequence,
                                  **kw) -> Generator[List[str], None, None]:
        """Yields per-request newly decoded text fragments; ``image_items``
        (paths, PIL images or base64 data URLs) one per prompt, each of
        which must hold one ``<image>``: ValueError otherwise, where the
        image would go unread."""
        self._require_tokenizer()
        img_id = self.engine.config.image_token_index
        toks = [tokenizer_image_token(p, self.tokenizer, img_id) for p in prompts]
        if image_items and any(img_id not in t for t in toks):
            raise ValueError("an image was given with a prompt that holds no <image> "
                             "placeholder")
        px = (process_images(image_items, self.engine.config.vision_config.image_size)
              if image_items else None)
        yield from self._text_fragments(self.stream_tokens_multimodal(toks, px, **kw),
                                        len(prompts))
