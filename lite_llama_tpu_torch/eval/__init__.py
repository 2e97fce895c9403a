"""Accuracy and perplexity evaluation (port of ``lite_llama_tpu/eval``)."""

from .datasets import DATASETS, HellaSwag, HotpotQA
from .harness import InferenceHarness, run_eval
from .perplexity import corpus_perplexity
from .metrics import (
    embedding_similarity,
    exact_match,
    extract_final_choice,
    jaccard_similarity,
    match_mc_option,
    normalize_answer,
    penalized_f1,
    score_all,
)

__all__ = [
    "DATASETS",
    "HellaSwag",
    "HotpotQA",
    "InferenceHarness",
    "run_eval",
    "corpus_perplexity",
    "embedding_similarity",
    "exact_match",
    "extract_final_choice",
    "jaccard_similarity",
    "match_mc_option",
    "normalize_answer",
    "penalized_f1",
    "score_all",
]
