"""Tracing, profiling and metrics utilities (port of
``lite_llama_tpu/utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace (CPU and CUDA activities)
  of everything run inside, written to ``logdir`` as a Chrome trace.
- ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``).
- ``steady_state_tps``: serving throughput over a scheduler's chunk log.
- ``MetricsLogger``: throughput lines from an engine's ``EngineStats``, one
  JSON object a line.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace.json`` (Chrome trace
    format, readable by Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named span for the profiler timeline."""
    return torch.profiler.record_function(name)


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


class MetricsLogger:
    """Engine throughput metrics as JSON lines.

    Usage:
        metrics = MetricsLogger(engine, interval_s=5.0)
        ... generation loop ...
        metrics.maybe_emit()       # prints at most once per interval
        metrics.emit()             # force a line
    """

    def __init__(self, engine, interval_s: float = 5.0, sink=print):
        self.engine = engine
        self.interval_s = interval_s
        self.sink = sink
        self._t0 = time.perf_counter()
        self._last_emit = self._t0
        self._last_decode = 0
        self._last_prefill = 0

    def snapshot(self) -> dict:
        now = time.perf_counter()
        s = self.engine.stats
        dt = max(now - self._last_emit, 1e-9)
        d_dec = s.decode_tokens - self._last_decode
        d_pre = s.prefill_tokens - self._last_prefill
        return {
            "ts": round(now - self._t0, 3),
            "decode_tokens": s.decode_tokens,
            "prefill_tokens": s.prefill_tokens,
            "chunks": s.chunks,
            "decode_tokens_per_s": round(d_dec / dt, 1),
            "prefill_tokens_per_s": round(d_pre / dt, 1),
            "free_pages": getattr(self.engine, "_host_free_pages", None),
            "free_slots": len(getattr(self.engine, "_free_slots", [])),
        }

    def emit(self) -> dict:
        snap = self.snapshot()
        s = self.engine.stats
        self._last_emit = time.perf_counter()
        self._last_decode = s.decode_tokens
        self._last_prefill = s.prefill_tokens
        self.sink(json.dumps({"engine_metrics": snap}))
        return snap

    def maybe_emit(self) -> Optional[dict]:
        if time.perf_counter() - self._last_emit >= self.interval_s:
            return self.emit()
        return None
