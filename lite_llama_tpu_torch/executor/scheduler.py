"""Continuous batching scheduler (port of
``lite_llama_tpu/executor/scheduler.py``).

- admits requests into engine slots as they arrive (admission control is
  the engine's host-side page/slot capacity guard, with prefix-cache hits),
- decodes at a FIXED batch width (max_reqs) through one resident
  ``DecodeSession`` with finished and empty slots masked done,
- prefills new arrivals in small batches between decode chunks and splices
  them into the session on the device, with no host round trip,
- pipelines: chunk k is dispatched before chunk k-1's results are
  processed, so the host's bookkeeping overlaps the device's work,
- frees pages and slots on completion and refills from the queue.

It is host-side Python that runs once per decode chunk.

Image requests (``pixel_values``) ride the same session on a ``LlavaEngine``:
their pool length is the expanded one (the ``<image>`` placeholder becomes
num_patches rows), they never take or register a prefix-cache entry (their
KV depends on the image), and each admission dispatches its text and image
requests as two prefills (the base engine's, and the multimodal one) that
splice into the one session. A text engine rejects them
(``rejected_multimodal_unsupported``); a LLaVA engine rejects one whose
prompt holds no placeholder (``rejected_missing_image_placeholder``) or more
than one (``rejected_multiple_images``).

On a mesh of more than one rank (tp, dp, cp, or dp x tp) every rank runs
its own scheduler over its share of the engine, and the SPMD contract
holds as for the engine's batch calls: driven by the same ``submit`` calls,
in the same order, at the same ``step`` calls, the schedulers make the
same admissions, dispatches and releases on every rank. Nothing here
branches on time or on device completion: the accounting reads only the
gathered tokens, which are the same on every rank (``submitted_at``,
``first_token_at`` and ``chunk_log`` are rank-local and decide nothing).
``server.py`` feeds the ranks from rank 0; :meth:`digest` summarises the
accounting the ranks compare before each iteration.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..generation.sampling import SamplingParams
from .engine import InferenceEngine


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_tokens: List[int]
    max_gen_len: int
    temperature: float = 0.6
    top_p: float = 0.9
    top_k: int = 0
    # Multimodal: one image [3, S, S] (LlavaEngine only); prompt_tokens then
    # hold one <image> placeholder.
    pixel_values: Optional[object] = None
    # Prompt length in the KV pool: the expanded length for image requests,
    # len(prompt_tokens) otherwise. Set at admission; all room and stop
    # accounting uses it.
    eff_prompt_len: int = 0
    # runtime state
    slot: Optional[int] = None
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    state: str = "waiting"  # waiting | running | done
    finish_reason: Optional[str] = None
    max_total: int = 0
    # crc32 of the prompt, the knobs and the image: the serving digest
    # tells requests apart by it, not only by their ids.
    fingerprint: int = 0
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def result(self) -> dict:
        """The request's outcome, as the JAX scheduler reports it."""
        return {
            "req_id": self.req_id,
            "tokens": self.output_tokens,
            "logprobs": self.output_logprobs,
            "finish_reason": self.finish_reason,
        }


def _host_sampling(temperature, top_p, top_k) -> SamplingParams:
    """Sampling rows as host tensors (copies): the engine uploads them
    without waiting for the device."""
    return SamplingParams(
        temperature=torch.tensor(np.asarray(temperature), dtype=torch.float32),
        top_p=torch.tensor(np.asarray(top_p), dtype=torch.float32),
        top_k=torch.tensor(np.asarray(top_k), dtype=torch.int32),
    )


class ContinuousBatchingScheduler:
    """Keeps the engine's decode batch full from a request queue."""

    def __init__(
        self,
        engine: InferenceEngine,
        max_prefill_batch: int = 8,
        chunk_steps: Optional[int] = None,
        admit_every: int = 1,
    ):
        self.engine = engine
        self.max_prefill_batch = max_prefill_batch
        # The full-chunk steps of long prompts, one per admission width,
        # made before any traffic (captured on the card, eager at tp > 1 and
        # cp > 1): no request waits for their capture.
        for width in range(1, max_prefill_batch + 1):
            engine.chunk_step_for(width, engine.prefill_chunk)
        self.chunk_steps = chunk_steps or engine.decode_chunk
        # Admission cadence: with admit_every=N > 1 waiting requests are
        # admitted at most every N decode chunks (unless the engine is
        # idle), so completions batch into one prefill.
        self.admit_every = max(1, admit_every)
        self._chunks_since_admit = 0
        self.waiting: deque[Request] = deque()
        self.running: Dict[int, Request] = {}  # slot -> request
        self.done: List[Request] = []
        self._ids = itertools.count()
        M = engine.max_reqs
        # Host copy of each slot's sampling knobs: the session's sampling
        # mode follows the live rows. Tokens, done flags and stop lengths
        # live on the device only.
        self._samp_host = {
            "temperature": np.full((M,), 0.6, np.float32),
            "top_p": np.full((M,), 0.9, np.float32),
            "top_k": np.zeros((M,), np.int32),
        }
        # One full-width session, built once and never rebuilt: admissions
        # splice rows in on the device, completions advance done flags there.
        self._session = None
        self._session_live: List[int] = []
        self._inflight = None  # (bundle, {slot: Request}) of the dispatched chunk
        # Dispatched, uncollected prefills: (requests, bundle). Collected at
        # the next drain, after the following decode chunk is dispatched.
        self._pending_prefills: List[tuple] = []
        self._eos = set(engine.eos_ids)
        # One record per processed decode chunk: completion time, occupancy
        # at dispatch and tokens credited (utils/profiling.steady_state_tps).
        self.chunk_log: List[dict] = []

    # -- API ----------------------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_gen_len: int = 128,
               temperature: float = 0.6, top_p: float = 0.9, top_k: int = 0,
               pixel_values=None) -> int:
        r = Request(
            req_id=next(self._ids),
            prompt_tokens=list(prompt_tokens),
            max_gen_len=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            top_k=top_k,
            pixel_values=pixel_values,
            submitted_at=time.perf_counter(),
        )
        knobs = repr((max_gen_len, float(temperature), float(top_p), int(top_k))).encode()
        r.fingerprint = zlib.crc32(np.asarray(r.prompt_tokens, np.int64).tobytes() + knobs)
        if pixel_values is not None:
            r.fingerprint = zlib.crc32(np.ascontiguousarray(pixel_values).tobytes(), r.fingerprint)
        self.waiting.append(r)
        return r.req_id

    def digest(self) -> bytes:
        """16 bytes summarising the accounting every rank of a mesh must
        share: the waiting and running requests (id, fingerprint, tokens
        so far, slot), each data group's free slots and pages, and the
        engine's call count."""
        eng = self.engine
        state = (
            [(r.req_id, r.fingerprint) for r in self.waiting],
            [(s, r.req_id, r.fingerprint, len(r.output_tokens))
             for s, r in sorted(self.running.items())],
            eng._slots_by_group, eng._pages_by_group, eng.stats.calls,
        )
        return hashlib.sha256(repr(state).encode()).digest()[:16]

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def run(self, on_tokens: Optional[Callable] = None) -> List[Request]:
        """Drive until all submitted requests complete. ``on_tokens(req,
        new_token_ids)`` streams per-chunk output."""
        while self.has_work():
            self.step(on_tokens)
        self._drain(on_tokens)
        out = self.done
        self.done = []
        return out

    # -- one scheduler iteration ---------------------------------------------
    def step(self, on_tokens: Optional[Callable] = None) -> None:
        """Pipelined iteration: dispatch decode chunk k, process chunk k-1's
        results while the device runs k, then admit waiting requests (after
        the drain, so the accounting is fresh). Admitted requests' prefill
        and session splice queue behind chunk k on the device and their rows
        decode from chunk k+1."""
        if not self.running and self.waiting:
            # Cold start (or fully drained engine): admit before dispatch.
            if not self._admit() and (self._inflight or self._pending_prefills):
                self._drain(on_tokens)  # learn frees, then retry
                self._admit()
        if self.running:
            self._decode_chunk(on_tokens)  # dispatch k; drain k-1 overlapped
            self._chunks_since_admit += 1
            if self.waiting and self._chunks_since_admit >= self.admit_every:
                self._admit()
        elif self._inflight is not None or self._pending_prefills:
            self._drain(on_tokens)

    def _drain(self, on_tokens=None) -> None:
        """Collect pending prefills (first tokens), then the in-flight decode
        chunk's results, in device-completion order."""
        self._collect_prefills(on_tokens)
        if self._inflight is None:
            return
        bundle, snapshot = self._inflight
        self._inflight = None
        self._process_chunk(*self.engine.collect_decode_chunk(bundle), snapshot=snapshot,
                            on_tokens=on_tokens, occupancy=len(snapshot))

    # -- internals ------------------------------------------------------------
    def _reject(self, r: Request, reason: str) -> None:
        r.state = "done"
        r.finish_reason = reason
        r.finished_at = time.perf_counter()
        self.done.append(r)

    def _admit(self) -> bool:
        """Admit up to max_prefill_batch waiting requests without blocking:
        dispatch their prefill, splice their rows into the session on the
        device, and queue the bundle for first-token collection at the next
        drain. Returns whether anything was admitted."""
        self._chunks_since_admit = 0
        eng = self.engine
        batch: List[Request] = []
        while self.waiting and len(batch) < self.max_prefill_batch:
            r = self.waiting[0]
            eff = len(r.prompt_tokens)
            if r.pixel_values is not None:
                if not hasattr(eng, "expanded_lens"):
                    self.waiting.popleft()
                    self._reject(r, "rejected_multimodal_unsupported")
                    continue
                if eng.config.image_token_index not in r.prompt_tokens:
                    self.waiting.popleft()  # the image would go unread
                    self._reject(r, "rejected_missing_image_placeholder")
                    continue
                try:
                    eff = eng.expanded_lens([r.prompt_tokens])[0]
                except ValueError:
                    self.waiting.popleft()
                    self._reject(r, "rejected_multiple_images")
                    continue
            # Reject impossible requests up front instead of waiting forever
            # for room that can never exist.
            max_total = min(eff + r.max_gen_len, eng.config.max_seq_len)
            if eff >= eng.config.max_seq_len or not eng.admit_feasible(max_total):
                self.waiting.popleft()
                self._reject(r, "rejected_too_long")
                continue
            # Prefix caching keys on token ids: not for image requests.
            slot = eng.try_admit(max_total, r.prompt_tokens if r.pixel_values is None else None)
            if slot is None:
                break  # not enough KV room yet; wait for completions
            r.max_total = max_total
            r.eff_prompt_len = eff
            r.slot = slot
            self.waiting.popleft()
            batch.append(r)
        if not batch:
            return False
        self._ensure_session()
        for sub in ([r for r in batch if r.pixel_values is None],
                    [r for r in batch if r.pixel_values is not None]):
            if sub:
                self._dispatch(sub)
        # The sampling mode is static per chunk: it follows the live rows
        # (exact is always correct, just slower).
        self._session.mode = self._live_mode()
        return True

    def _dispatch(self, batch: List[Request]) -> None:
        """Dispatch one prefill batch, all text or all image requests, and
        splice its rows into the resident session; first tokens flow
        prefill -> session on the device."""
        slots = [r.slot for r in batch]
        temps = [r.temperature for r in batch]
        tps = [r.top_p for r in batch]
        tks = [r.top_k for r in batch]
        prompts = [r.prompt_tokens for r in batch]
        sampling = _host_sampling(temps, tps, tks)
        if batch[0].pixel_values is None:
            bundle = self.engine.prefill_async(prompts, sampling, slots)
        else:
            bundle = self.engine.prefill_multimodal_async(
                prompts, np.stack([np.asarray(r.pixel_values) for r in batch]), sampling, slots)
        for r in batch:
            r.state = "running"
            self.running[r.slot] = r
            self._samp_host["temperature"][r.slot] = r.temperature
            self._samp_host["top_p"][r.slot] = r.top_p
            self._samp_host["top_k"][r.slot] = r.top_k
        self.engine.update_session_rows(
            self._session, slots, bundle, [r.eff_prompt_len for r in batch],
            [r.max_total for r in batch], temps, tps, tks,
        )
        self._pending_prefills.append((batch, bundle))

    def _live_mode(self) -> str:
        live = np.asarray(sorted(self.running), np.int64)
        if live.size == 0:
            return "approx"
        return self.engine._mode_of(self._samp_host["temperature"][live],
                                    self._samp_host["top_p"][live],
                                    self._samp_host["top_k"][live])

    def _ensure_session(self) -> None:
        """Build the resident full-width session once: every slot rides in
        it, empty rows masked done."""
        if self._session is not None:
            return
        M = self.engine.max_reqs
        live = list(range(M))
        self._session = self.engine.start_decode_session(
            live, np.zeros((M,), np.int32), np.ones((M,), bool), np.zeros((M,), np.int32),
            _host_sampling(self._samp_host["temperature"], self._samp_host["top_p"],
                           self._samp_host["top_k"]),
        )
        self._session_live = live

    def _collect_prefills(self, on_tokens=None) -> None:
        """Fetch the first tokens of dispatched prefills (the device has
        finished them: the following decode chunk was dispatched first) and
        run the bookkeeping that admission deferred."""
        if not self._pending_prefills:
            return
        pending, self._pending_prefills = self._pending_prefills, []
        for batch, bundle in pending:
            first_tok, _, _, lp0 = self.engine.prefill_collect(bundle)
            now = time.perf_counter()
            for i, r in enumerate(batch):
                if r.state != "running":
                    continue
                r.first_token_at = now
                tok = int(first_tok[i])
                r.output_tokens.append(tok)
                r.output_logprobs.append(float(lp0[i]))
                if on_tokens:
                    on_tokens(r, [tok])
                if tok in self._eos or r.eff_prompt_len + 1 >= r.max_total:
                    self._finish(r, "stop" if tok in self._eos else "length")

    def _decode_chunk(self, on_tokens) -> None:
        """Dispatch one decode chunk against the full-width session, then
        process the previous chunk's results (pipelined). The snapshot of
        the slots' occupants at dispatch keeps results from leaking into a
        request that reuses a slot before they are processed."""
        self._ensure_session()
        nxt = self.engine.dispatch_decode_chunk(self._session, self.chunk_steps)
        snapshot = dict(self.running)
        self._drain(on_tokens)
        self._inflight = (nxt, snapshot)

    def _process_chunk(self, toks, lps, new_done, snapshot=None, on_tokens=None,
                       occupancy=None) -> None:
        src = snapshot if snapshot is not None else self.running
        finished: List[Request] = []
        emitted_total = 0
        for col, slot in enumerate(self._session_live):
            r = src.get(slot)
            if r is None or r.state != "running":
                continue  # empty slot, or occupant changed/finished
            room = r.max_total - r.eff_prompt_len - len(r.output_tokens)
            emitted = []
            for t in (int(t) for t in toks[:, col][: max(room, 0)]):
                emitted.append(t)
                if t in self._eos:
                    break
            r.output_tokens.extend(emitted)
            emitted_total += len(emitted)
            r.output_logprobs.extend(float(v) for v in lps[: len(emitted), col])
            if on_tokens and emitted:
                on_tokens(r, emitted)
            hit_eos = bool(emitted and emitted[-1] in self._eos)
            out_len = r.eff_prompt_len + len(r.output_tokens)
            if hit_eos or out_len >= r.max_total or new_done[col]:
                finished.append(r)
        for r in finished:
            self._finish(r, "stop" if r.output_tokens and r.output_tokens[-1] in self._eos
                         else "length")
        self.chunk_log.append({
            "t": time.perf_counter(),
            "occupancy": occupancy if occupancy is not None else len(src),
            "tokens": emitted_total,
            "steps": int(toks.shape[0]),
        })

    def _finish(self, r: Request, reason: str) -> None:
        r.state = "done"
        r.finish_reason = reason
        r.finished_at = time.perf_counter()
        if r.slot is not None and r.slot in self.running:
            del self.running[r.slot]
            self.engine.release_slots([r.slot], [r.max_total])
        self.done.append(r)
