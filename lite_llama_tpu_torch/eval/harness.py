"""Timed inference wrapper for the accuracy evaluator (port of
``lite_llama_tpu/eval/harness.py``): a generator (the engine-backed
``TextGenerator``, built from a checkpoint dir or handed in already built)
with a warm-up pass, timed batch completion, output-token counting, and
model-type sniffing + prompt templating from the checkpoint path.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

from ..utils.common import get_model_type
from ..utils.logger import get_logger
from ..utils.prompts import get_prompter

logger = get_logger()


class InferenceHarness:
    """Warm-up + timed text completion over a TextGenerator."""

    def __init__(
        self,
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_seq_len: int = 2048,
        max_gen_len: Optional[int] = 64,
        checkpoint_dir: Optional[str] = None,
        generator=None,
        apply_template: bool = True,
        device="cuda",
    ):
        self.temperature = temperature
        self.top_p = top_p
        self.max_seq_len = max_seq_len
        self.max_gen_len = max_gen_len
        self.checkpoint_dir = checkpoint_dir
        self._generator = generator
        self.apply_template = apply_template and checkpoint_dir is not None
        self.device = device

    def load_generator(self):
        """Build engine + generator from the checkpoint dir, on the card
        unless the harness was given ``device="cpu"``."""
        if self._generator is not None:
            return self._generator
        import torch
        from transformers import AutoTokenizer

        from ..executor.engine import InferenceEngine
        from ..generation.generate import TextGenerator

        engine = InferenceEngine.build(self.checkpoint_dir, dtype=torch.bfloat16,
                                       max_seq_len=self.max_seq_len, device=self.device)
        tokenizer = AutoTokenizer.from_pretrained(self.checkpoint_dir)
        self._generator = TextGenerator(engine, tokenizer)
        return self._generator

    @staticmethod
    def count_tokens(texts: Sequence[str], tokenizer) -> int:
        return sum(
            len(tokenizer(t, add_special_tokens=False)["input_ids"]) for t in texts
        )

    def inference(
        self, generator, prompts: Sequence[str]
    ) -> Tuple[List[str], float, int]:
        """Warm-up then timed completion; returns (texts, seconds, tokens)."""
        warm = ["Hello World"] * min(4, max(len(prompts), 1))
        generator.text_completion(
            warm, temperature=self.temperature, top_p=self.top_p, max_gen_len=5
        )

        start = time.perf_counter()
        outs = generator.text_completion(
            list(prompts),
            temperature=self.temperature,
            top_p=self.top_p,
            max_gen_len=self.max_gen_len,
        )
        elapsed = time.perf_counter() - start

        texts = [o.text if o.text is not None else "" for o in outs]
        if generator.tokenizer is not None:
            total_tokens = self.count_tokens(texts, generator.tokenizer)
        else:
            total_tokens = sum(len(o.token_ids) for o in outs)
        return texts, elapsed, total_tokens

    def process(self, prompts: Sequence[str]) -> List[str]:
        """Template the prompts per model type, run timed inference, return
        the generated texts."""
        if self.apply_template:
            model_type = get_model_type(self.checkpoint_dir)
            prompter = get_prompter(model_type, self.checkpoint_dir or "")
            templated = []
            for p in prompts:
                templated.append(prompter.insert_prompt(p))
                prompter.reset()
            prompts = templated
        generator = self.load_generator()
        texts, elapsed, tokens = self.inference(generator, prompts)
        logger.info(
            f"eval inference: {tokens} tokens in {elapsed:.2f}s "
            f"({tokens / max(elapsed, 1e-9):.1f} tokens/s)"
        )
        return texts


def run_eval(
    dataset,
    harness: InferenceHarness,
) -> dict:
    """Parse a dataset, run the harness, score predictions."""
    ground_truth, prompts, options = dataset.parse_data()
    predictions = harness.process(prompts)
    if getattr(dataset, "data_type", "qa") == "mcq":
        scores = dataset.evaluate(predictions, ground_truth, options)
    else:
        scores = dataset.evaluate(predictions, ground_truth)
    logger.info(f"eval result ({dataset.data_type}): {scores}")
    return scores
