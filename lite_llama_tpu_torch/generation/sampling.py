"""Sampling: temperature / top-p / top-k / greedy on the device (port of
``lite_llama_tpu/generation/sampling.py``).

Per-request parameter vectors, so one batch can mix settings. The common
path draws from the top ``nucleus_k`` candidates (``torch.topk`` in place of
the TPU's ``approx_max_k``) with a top-p cutoff against the TRUE
probabilities (full-vocab logsumexp); the exact full-sort path serves the
regimes :func:`needs_exact_sampling` names. The categorical draw is a
Gumbel-max over uniforms from an explicit ``torch.Generator`` (the same
distribution as ``jax.random.categorical``, different numbers), with no
host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SamplingParams(NamedTuple):
    """Per-request sampling knobs, each [B]."""

    temperature: torch.Tensor  # fp32; <= 0 means greedy
    top_p: torch.Tensor  # fp32; 1.0 disables
    top_k: torch.Tensor  # int32; 0 disables

    @staticmethod
    def make(batch: int, temperature=0.6, top_p=0.9, top_k=0, device="cuda"):
        return SamplingParams(
            temperature=torch.full((batch,), float(temperature), dtype=torch.float32,
                                   device=device),
            top_p=torch.full((batch,), float(top_p), dtype=torch.float32, device=device),
            top_k=torch.full((batch,), int(top_k), dtype=torch.int32, device=device),
        )


NUCLEUS_K = 64  # candidate pool for top-p/top-k sampling


def top_p_mask(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Mask (with -inf) tokens outside the top-p nucleus (exact, full sort).
    Keeps tokens whose preceding cumulative mass is < top_p (always the
    argmax); the cutoff is the smallest kept logit."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p[:, None]
    n_keep = keep.sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits >= cutoff, logits, torch.full_like(logits, float("-inf")))


def top_k_mask(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask tokens outside the per-request top-k; top_k 0 = off."""
    V = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, torch.clamp(top_k, max=V), torch.full_like(top_k, V))
    cutoff = torch.gather(sorted_logits, -1, (k.long() - 1)[:, None])
    return torch.where(logits >= cutoff, logits, torch.full_like(logits, float("-inf")))


def needs_exact_sampling(temperature, top_p, top_k, nucleus_k: int = NUCLEUS_K) -> bool:
    """Host-side predicate: do these sampling params need the exact
    full-sort path? Exact when any request asks for ``top_k > nucleus_k``,
    an effectively untruncated distribution (``top_p >= 0.99`` with top_k
    off) at any temperature > 0, or a flattened one (``temperature > 1`` with
    ``top_p > 0.9`` and top_k off), where the rank-``nucleus_k`` candidate
    set could drop real tail mass."""
    t = np.asarray(temperature)
    p = np.asarray(top_p)
    k = np.asarray(top_k)
    return bool(
        np.any(k > nucleus_k)
        | np.any((t > 0.0) & (p >= 0.99) & (k == 0))
        | np.any((t > 1.0) & (p > 0.9) & (k == 0))
    )


def _categorical(masked: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(masked) by Gumbel-max."""
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator, params: SamplingParams,
           nucleus_k: int = NUCLEUS_K, mode: str = "approx") -> torch.Tensor:
    """Next tokens [B] int32 from fp32 logits [B, V]; greedy where
    temperature <= 0. ``mode``: "approx" (top-``nucleus_k`` candidates),
    "exact" (full sort), or "greedy" (the caller knows every request is
    greedy; no random numbers are drawn)."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if mode == "greedy":
        return greedy_tok
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp
    if mode == "approx":
        k_cand = min(nucleus_k, scaled.shape[-1])
        vals, idxs = torch.topk(scaled, k_cand, dim=-1)  # [B, k] descending
        j = torch.arange(k_cand, device=scaled.device)[None, :]
        k = torch.where(params.top_k > 0, torch.clamp(params.top_k, max=k_cand),
                        torch.full_like(params.top_k, k_cand))
        keep = j < k[:, None]
        lse_full = torch.logsumexp(scaled, dim=-1, keepdim=True)
        probs = torch.where(keep, torch.exp(vals - lse_full), torch.zeros_like(vals))
        csum = torch.cumsum(probs, dim=-1)
        keep = keep & ((csum - probs) < params.top_p[:, None])
        masked = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
        choice = _categorical(masked, generator)
        sampled = torch.gather(idxs, -1, choice[:, None])[:, 0]
    elif mode == "exact":
        masked = top_p_mask(top_k_mask(scaled, params.top_k), params.top_p)
        sampled = _categorical(masked, generator)
    else:
        raise ValueError(f"unknown sampling mode {mode!r}")
    return torch.where(params.temperature <= 0.0, greedy_tok, sampled.to(torch.int32))


def log_softmax_gather(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-token logprobs [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[:, None])[:, 0]
