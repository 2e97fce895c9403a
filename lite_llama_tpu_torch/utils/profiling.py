"""Serving throughput accounting (port of ``steady_state_tps`` from
``lite_llama_tpu/utils/profiling.py``; the JAX trace helpers have no
counterpart here: ``torch.profiler`` serves directly)."""

from __future__ import annotations

from typing import Optional


def steady_state_tps(chunk_log, full_occupancy: int, min_frac: float = 1.0) -> Optional[dict]:
    """Steady-state serving throughput from a scheduler's ``chunk_log``.

    A burst's aggregate tokens/s blends the ramp-up (queue filling,
    prefills), the steady window (every slot live) and the drain tail (the
    last requests finishing at falling occupancy); this reports the steady
    window separately.

    Args:
      chunk_log: list of {"t", "occupancy", "tokens", "steps"} dicts, one
        per processed decode chunk (ContinuousBatchingScheduler.chunk_log).
      full_occupancy: the slot count that counts as full.
      min_frac: the fraction of ``full_occupancy`` a chunk needs to count as
        steady; 1.0 means strictly full.

    Returns the steady window's tokens/s, its span, and the
    occupancy-weighted tokens/s over the whole run (tokens per slot-second
    times ``full_occupancy``), or None without a steady window. Chunk
    durations are completion-to-completion deltas, so the first chunk,
    which has no predecessor, is dropped.
    """
    if len(chunk_log) < 2:
        return None
    thr = full_occupancy * min_frac
    steady_tok = steady_dt = 0.0
    w_occ_dt = tot_tok = tot_dt = 0.0
    n_steady = 0
    for prev, cur in zip(chunk_log, chunk_log[1:]):
        dt = cur["t"] - prev["t"]
        if dt <= 0:
            continue
        tot_tok += cur["tokens"]
        tot_dt += dt
        w_occ_dt += cur["occupancy"] * dt
        if cur["occupancy"] >= thr:
            steady_tok += cur["tokens"]
            steady_dt += dt
            n_steady += 1
    if steady_dt <= 0 or tot_dt <= 0:
        return None
    return {
        "steady_tokens_per_s": round(steady_tok / steady_dt, 1),
        "steady_window_s": round(steady_dt, 2),
        "steady_chunks": n_steady,
        "total_chunks": len(chunk_log) - 1,
        "occupancy_weighted_tokens_per_s": round(
            tot_tok / w_occ_dt * full_occupancy, 1
        ) if w_occ_dt > 0 else None,
        "mean_occupancy": round(w_occ_dt / tot_dt, 2),
    }
