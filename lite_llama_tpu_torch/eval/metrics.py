"""Accuracy metrics for the evaluation harness (port of
``lite_llama_tpu/eval/metrics.py``, numpy only): answer normalization, exact
match, length-penalized token F1, Jaccard set similarity, and an embedding
cosine similarity over a deterministic hashed bag-of-words embedder (the
only embedder here: a semantic one would need a model download).
"""

from __future__ import annotations

import re
import string
from typing import List, Optional, Sequence, Tuple

import numpy as np

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNC_TABLE = str.maketrans("", "", string.punctuation)


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra spaces, and collapse
    consecutive duplicate words."""
    s = _ARTICLES.sub(" ", s.lower().translate(_PUNC_TABLE))
    words = s.split()
    out: List[str] = []
    for w in words:
        if not out or out[-1] != w:
            out.append(w)
    return " ".join(out)


def exact_match(pred: str, gt: str) -> float:
    return float(normalize_answer(pred) == normalize_answer(gt))


def penalized_f1(
    pred: str, gt: str, max_len_ratio: float = 3.0, penalty_factor: float = 0.5
) -> float:
    """Token-overlap F1, penalized when the prediction rambles past
    ``max_len_ratio``x the ground-truth length."""
    pred_tokens = normalize_answer(pred).split()
    gt_tokens = normalize_answer(gt).split()
    common = set(pred_tokens) & set(gt_tokens)
    if not common:
        return 0.0
    precision = len(common) / len(pred_tokens)
    recall = len(common) / len(gt_tokens)
    f1 = 2 * precision * recall / (precision + recall)
    if len(pred_tokens) > len(gt_tokens) * max_len_ratio:
        f1 *= penalty_factor
    return f1


def jaccard_similarity(pred: str, gt: str) -> float:
    pred_tokens = set(normalize_answer(pred).split())
    gt_tokens = set(normalize_answer(gt).split())
    if not pred_tokens or not gt_tokens:
        return 0.0
    return len(pred_tokens & gt_tokens) / len(pred_tokens | gt_tokens)


class _HashedBowEmbedder:
    """Deterministic hashed bag-of-words embedder."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        import zlib

        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            for w in normalize_answer(t).split():
                # crc32, NOT builtin hash(): hash() is salted per process
                # (PYTHONHASHSEED), which would make eval scores vary run
                # to run despite the "deterministic" contract.
                h = zlib.crc32(w.encode("utf-8"))
                out[i, h % self.dim] += 1.0 if (h >> 16) & 1 else -1.0
        return out


_EMBEDDER = _HashedBowEmbedder()


def embedding_similarity(pred: str, gt: str) -> float:
    emb = _EMBEDDER.encode([pred, gt])
    a, b = emb[0], emb[1]
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    # Cosine lands in [-1, 1]; negative similarity carries no more signal
    # than zero for answer scoring, and clamping keeps every reported
    # metric in [0, 1] (random tiny-model outputs in tests occasionally
    # anti-correlate under the hashed-BoW embedder).
    return float(max(0.0, np.dot(a, b) / (na * nb)))


_CHOICE_PATTERNS = [
    r"answer\s*[:\-]?\s*([a-d])\b",
    r"option\s*([a-d])\b",
    r"\b([a-d])\b\s+is\s+(?:correct|the answer)",
    r"\b([a-d])[\).]",
    r"choice\s*[:\-]?\s*([a-d])\b",
]


def extract_final_choice(text: str) -> Optional[str]:
    """Pull an explicit A-D answer out of free-form model output. Matches on
    raw lowercased text: normalizing first would strip the punctuation the
    "A)" / "b." patterns need."""
    text = text.lower()
    for pat in _CHOICE_PATTERNS:
        m = re.search(pat, text, re.IGNORECASE)
        if m:
            return m.group(1).upper()
    return None


def match_mc_option(
    pred: str, options: Sequence[Tuple[str, str]]
) -> Tuple[str, List[float]]:
    """Fallback multiple-choice matching by embedding similarity to each
    option text."""
    emb = _EMBEDDER
    pred_vec = emb.encode([normalize_answer(pred)])[0]
    opt_vecs = emb.encode([text for _, text in options])
    sims: List[float] = []
    for v in opt_vecs:
        denom = np.linalg.norm(pred_vec) * np.linalg.norm(v)
        sims.append(float(np.dot(pred_vec, v) / denom) if denom else 0.0)
    best = int(np.argmax(np.asarray(sims)))
    return options[best][0], sims


def score_all(preds: Sequence[str], gts: Sequence[str]) -> dict:
    """Aggregate the four metrics over a prediction set."""
    if len(preds) != len(gts):
        raise ValueError("prediction/ground-truth length mismatch")
    n = max(len(preds), 1)
    return {
        "EM": sum(exact_match(p, g) for p, g in zip(preds, gts)) / n,
        "F1 (penalized)": sum(penalized_f1(p, g) for p, g in zip(preds, gts)) / n,
        "Jaccard": sum(jaccard_similarity(p, g) for p, g in zip(preds, gts)) / n,
        "Embedding Sim": sum(
            embedding_similarity(p, g) for p, g in zip(preds, gts)
        )
        / n,
    }
