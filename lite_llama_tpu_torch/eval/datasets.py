"""Evaluation dataset adapters: HotpotQA and HellaSwag (port of
``lite_llama_tpu/eval/datasets.py``, plain Python): parse the public dataset
files into (prompt, answer) pairs and score model predictions with the
shared metric suite. Dataset files are user-supplied; nothing is downloaded.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import extract_final_choice, match_mc_option, score_all


def read_json(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def read_jsonl(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _sample_pairs(items: List[dict], n: Optional[int], seed: int = 0):
    if n is None or n >= len(items):
        return items
    rng = random.Random(seed)
    return rng.sample(items, n)


class HotpotQA:
    """Distractor-setting HotpotQA: prompt = supporting facts + question."""

    data_type = "qa"

    def __init__(self, data_path: str, data_batch: Optional[int] = None, seed: int = 0):
        self.data_path = data_path
        self.data_batch = data_batch
        self.seed = seed

    @staticmethod
    def extract_supporting_context(data: dict) -> str:
        context = dict(data["context"])
        lines = []
        for title, sent_idx in data["supporting_facts"]:
            sentences = context.get(title)
            if sentences is not None and sent_idx < len(sentences):
                lines.append(sentences[sent_idx])
        return "\n".join(lines)

    def build_prompt(self, data: dict) -> str:
        context = self.extract_supporting_context(data)
        return (
            f"Context:\n{context}\n\n"
            f"Question:\n{data['question']}\n\n"
            "Answer:"
        )

    def parse_data(self) -> Tuple[List[str], List[str], List[Any]]:
        items = [
            {"prompt": self.build_prompt(d), "answer": d["answer"].strip().lower()}
            for d in read_json(self.data_path)
        ]
        items = _sample_pairs(items, self.data_batch, self.seed)
        return (
            [d["answer"] for d in items],
            [d["prompt"] for d in items],
            [],
        )

    def evaluate(self, predictions: Sequence[str], ground_truth: Sequence[str]) -> Dict:
        scores = score_all(list(predictions), list(ground_truth))
        return scores


class HellaSwag:
    """HellaSwag sentence-completion as 4-way multiple choice."""

    data_type = "mcq"
    choices = ["A", "B", "C", "D"]

    def __init__(self, data_path: str, data_batch: Optional[int] = None, seed: int = 0):
        self.data_path = data_path
        self.data_batch = data_batch
        self.seed = seed

    def format_prompt(self, ctx: str, endings: Sequence[str]) -> str:
        lines = [
            f"Context: {ctx}",
            "",
            "Which of the following is the most plausible continuation?",
        ]
        for letter, end in zip(self.choices, endings):
            lines.append(f"{letter}) {end.strip()}")
        lines.append("")
        lines.append("Answer:")
        return "\n".join(lines)

    def parse_data(self) -> Tuple[List[str], List[str], List[Any]]:
        items = []
        for content in read_jsonl(self.data_path):
            endings = content["endings"]
            items.append(
                {
                    "prompt": self.format_prompt(content["ctx"], endings),
                    "answer": self.choices[int(content["label"])],
                    "options": list(zip(self.choices, endings)),
                }
            )
        items = _sample_pairs(items, self.data_batch, self.seed)
        return (
            [d["answer"] for d in items],
            [d["prompt"] for d in items],
            [d["options"] for d in items],
        )

    def evaluate(
        self,
        predictions: Sequence[str],
        ground_truth: Sequence[str],
        options: Sequence[Sequence[Tuple[str, str]]],
    ) -> Dict:
        resolved = []
        for pred, opts in zip(predictions, options):
            choice = extract_final_choice(pred)
            if not choice:
                choice, _ = match_mc_option(pred, opts)
            resolved.append(str(choice))
        return score_all(resolved, list(ground_truth))


DATASETS = {"hotpotqa": HotpotQA, "hellaswag": HellaSwag}
