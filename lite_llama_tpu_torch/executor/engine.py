"""InferenceEngine: the executor facade, for one device (port of
``lite_llama_tpu/executor/engine.py``).

Owns the parameters, the paged KV cache, the host-side admission accounting
and the prefix cache, and runs prefill and decode:

- prefill (``prefill_async`` / ``prefill_collect``): prompts up to
  ``prefill_chunk`` with no prefix-cache hit go as one padded [B, S_max]
  batch through ``decoder_prefill`` with ``last_only`` (K2 on the card).
  Longer prompts and prefix-cache hits go chunk by chunk through the
  paged-history path (``ChunkStep``, K5), each request starting after its
  cached pages; on the card a full chunk is a replayed CUDA graph, so a
  long prompt's prefill returns at dispatch. The first token is sampled on the device, and the
  host-bound outputs are copied back without blocking the dispatch.
- decode: a ``DecodeSession`` holds one batch's slots, tokens, done flags,
  stop lengths and sampling rows on the device. ``dispatch_decode_chunk``
  enqueues up to ``decode_chunk`` steps (allocate -> forward -> sample ->
  eos bookkeeping) without a host sync; ``collect_decode_chunk`` waits once
  for that chunk's packed output. ``decode`` is a one-shot session;
  serving (executor/scheduler.py) keeps one session for its whole run and
  splices admitted requests in with ``update_session_rows``.
- the decode step (``DecodeStep``), the counterpart of the JAX engine's
  jitted ``lax.scan`` chunk: one step over static buffers, kept per
  (session width, sampling mode). On the card it is captured once as a CUDA
  graph, after one eager warm-up on a stream of its own, and a chunk
  replays it n times; on the CPU the same body runs eagerly. Every graph
  shares one memory pool and draws from the engine's generator, which each
  graph registers, so every replay draws fresh numbers.
- speculative decoding (greedy verify of prompt-lookup drafts, driven by
  ``generation/speculative.py``): ``spec_verify`` runs one verify step
  eagerly (allocate the optimistic chunk, a chunked prefill over it with
  all logits, K5 on the card, accept the longest matching draft prefix,
  rewind the rest) with one host copy; ``spec_decode_chunk`` replays a
  ``SpecStep``, one iteration of the JAX engine's ``_spec_chunk`` scan
  (device drafting, verify, eos and budget truncation, the history update)
  over static buffers, captured like the decode steps, so a chunk of
  verify steps costs one host sync.
- prefix cache: a host-side registry of page-aligned prompt prefixes whose
  KV pages stay in the pool after their request ends (``PrefixCache``); a
  later prompt that starts with one splices those pages into its table and
  computes only the rest.
- a host-side capacity guard refuses admission when the page pool could be
  exhausted (the device-side allocator is masked arithmetic and cannot
  raise).

The JAX engine pads batch and prompt widths to buckets to bound XLA
recompiles. PyTorch compiles nothing per shape, so every batch runs at its
own width (no sentinel rows).

Quantized weights (``quant/qtensor.py``) and int8 / fp8 KV pools
(``kv_quant``) run through the same paths; packed int4 wq/wkv are fused into
one wqkv at build time, as the JAX engine does.

Tensor parallelism (``mesh=parallel.shardings.make_mesh(tp)``, one process
per rank): every rank builds the engine from the same whole tree and keeps
its shard (wq/wkv fused shard-periodically first, as the JAX engine fuses
at tp > 1) and a pool of its kv heads. Every rank keeps the same host
accounting, as the JAX package's SPMD host replication does: the caller
issues the same requests in the same order on every rank, and the seeded
generator samples the same token on each from the gathered logits. At tp >
1 the decode steps run eagerly (no CUDA graph: a gloo collective cannot be
captured, and a captured NCCL step needs a card per rank to be checked).

Data parallelism (a mesh with dp > 1), as the JAX engine's SPMD host
replication runs it: every rank issues the same calls and keeps the host
accounting of every data group (``dp`` groups of ``max_reqs / dp`` slots
and ``num_pages / dp`` pages, a prefix registry each), so admission places
each request in the group with the longest prefix hit, then the most free
pages, alike on every rank. A rank holds the device state of its own group
only: a pool of the group's pages with local slot and page ids. Each
prefill or decode call runs the group's rows of the batch, and one
all-gather over the data groups puts the sampled tokens and logprobs in the
caller's order on every rank (JAX's ``_fetch``); every rank knows each
group's rows, so the gather needs no size exchange, and a group with no row
in a call joins it with zeros. Each rank's generator folds in its group
index (JAX's ``_dp_key``). At tp 1 a rank's decode step stays a replayed
CUDA graph: the gather comes after the chunk.

Context parallelism (cp > 1; it composes with neither dp nor tp, as in the
JAX engine): the weights and the host state are whole on every rank, the
pool holds the rank's share of the pages (``parallel/context_parallel.py``),
and the steps run eagerly (each layer holds a collective).

The scheduler and the server run on every mesh through the same calls
(``start_decode_session``, ``update_session_rows``, ``dispatch_decode_chunk``
/ ``collect_decode_chunk``, ``prefill_async`` / ``prefill_collect``,
``try_admit`` / ``release_slots``, ``chunk_step_for``): the server's rank 0
broadcasts its requests so that every rank makes them alike (``server.py``),
and ``stats.calls`` counts the calls, which the ranks compare each
iteration. Speculative decoding runs at tp and cp (its verify step eager
there); at dp it is refused, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import BaseConfig
from ..generation.sampling import SamplingParams, log_softmax_gather, needs_exact_sampling, sample
from ..models.decoder import AttnContext, decoder_decode, decoder_prefill, fuse_qkv_params
from ..ops import add_launches, launch_counts
from ..parallel import distributed
from ..parallel.shardings import ShardingPolicy
from ..quant.qtensor import QTensor
from .kv_cache import (
    alloc_decode,
    alloc_prefill,
    cdiv,
    create_kv_cache,
    free_requests,
    kv_cache_bytes,
    push_pages,
    rewind_requests,
)


@dataclasses.dataclass
class DecodeSession:
    """Device-resident decode state for one batch of slots, in caller
    order: token, done flag, stop length and sampling row per slot. Decode
    chunks run against it with no uploads; the scheduler changes rows in
    place (``update_session_rows``) instead of rebuilding it."""

    slots: tuple
    req_ids: torch.Tensor
    tok: torch.Tensor
    done: torch.Tensor
    stop: torch.Tensor
    samp: SamplingParams
    mode: str
    # Data parallelism: the caller's rows of each data group, in order; the
    # tensors above hold this rank's group's rows only (local slot ids).
    layout: Optional[tuple] = None


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (there is no
    quiet fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "InferenceEngine runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return device


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def capture_graph(fn, generator: torch.Generator, pool, stream: torch.cuda.Stream):
    """Capture ``fn()`` as a CUDA graph on ``stream`` into the memory pool
    ``pool``; returns (graph, capture ms, launches a replay makes). One
    eager call on ``stream`` first creates, outside the capture, what the
    kernels keep per stream (K1's and K6's split workspaces, cuBLAS's handle
    and workspace). ``generator`` is registered with the graph, so each
    replay draws fresh numbers from it. Errors are checked per thread: the
    server's frontend thread runs beside the one that captures. The capture
    launches nothing, so the kernel wrappers' counts made during it are
    taken back out of the counters and returned ({name: launches}) for the
    replayer to add (:func:`ops.add_launches`)."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    before = launch_counts()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        fn()
    capture_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    add_launches(launches, -1)
    current.wait_stream(stream)
    return graph, capture_ms, launches


class _ReplayedStep:
    """A step over static buffers that the card captures once as a CUDA
    graph and replays (:meth:`capture`, :meth:`run`); until then, and on
    the CPU, :meth:`run` calls ``body`` eagerly. Its warm-up, inside
    :func:`capture_graph`, runs with every row done (the buffers' initial
    state), so it allocates no page and changes no length or KV row."""

    def __init__(self, engine: "InferenceEngine"):
        self.engine = engine
        self.graph = None
        self.capture_ms = None
        self.launches = {}  # kernel launches a replay makes, by launch counter

    def body(self) -> None:
        raise NotImplementedError

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        """Record the body as a CUDA graph (:func:`capture_graph`)."""
        self.graph, self.capture_ms, self.launches = capture_graph(
            self.body, self.engine._gen, pool, stream)

    @torch.inference_mode()
    def run(self, n: int) -> None:
        """``n`` steps: replays of the graph (counted as the kernels they
        launch), or eager calls of the body (on the CPU, and on the card
        until it is captured)."""
        if self.graph is None:
            for _ in range(n):
                self.body()
            return
        for _ in range(n):
            self.graph.replay()
        add_launches(self.launches, n)


class DecodeStep(_ReplayedStep):
    """One decode step of a session width B and a sampling mode, over static
    buffers: allocate -> forward -> sample -> eos bookkeeping, the body of
    the JAX engine's ``lax.scan`` chunk. It reads and writes only its own
    buffers (slots, tokens, done flags, stop lengths, sampling rows, a step
    counter, and [decode_chunk, B] emitted tokens and logprobs, written at
    the counter's row) and the engine's cache, parameters and generator,
    all at fixed addresses. So on the card :meth:`capture` records it once
    as a CUDA graph and :meth:`run` replays it; until then (and on the CPU)
    :meth:`run` calls the same body eagerly."""

    def __init__(self, engine: "InferenceEngine", width: int, mode: str):
        dev = engine.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        super().__init__(engine)
        self.mode = mode
        self.req_ids = torch.zeros(width, **i32)
        self.tok = torch.zeros(width, **i32)
        self.done = torch.ones(width, dtype=torch.bool, device=dev)
        self.stop = torch.zeros(width, **i32)
        self.samp = SamplingParams(torch.zeros(width, **f32), torch.ones(width, **f32),
                                   torch.zeros(width, **i32))
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.toks = torch.zeros((engine.decode_chunk, width), **i32)
        self.lps = torch.zeros((engine.decode_chunk, width), **f32)

    @torch.inference_mode()
    def load(self, s: DecodeSession) -> None:
        """Copy a session's state into the buffers and restart the counter."""
        for dst, src in ((self.req_ids, s.req_ids), (self.tok, s.tok), (self.done, s.done),
                         (self.stop, s.stop), *zip(self.samp, s.samp)):
            dst.copy_(src)
        self.step.zero_()

    def forward(self):
        """Allocate the live rows' next positions and run the decoder:
        (lengths [B] after the allocation, logits [B, V])."""
        e, cache, active = self.engine, self.engine.cache, ~self.done
        alloc_decode(cache, self.req_ids, active)
        req = self.req_ids.long()
        seq = cache.seq_lens[req]
        pos = seq - 1
        ctx = AttnContext(table_rows=cache.page_table[req], seq_lens=seq, start_pos=pos,
                          chunk_lens=torch.ones_like(pos), active=active)
        logits, _ = decoder_decode(e.params, e.config, cache.kv_pages, ctx, self.tok.long(),
                                   shard=e.shard)
        return seq, logits

    def body(self) -> None:
        e, done = self.engine, self.done
        seq, logits = self.forward()
        next_tok = sample(logits, e._gen, self.samp, mode=self.mode)
        emit = torch.where(done, torch.full_like(next_tok, e.pad_id), next_tok)
        emit_lp = torch.where(done, torch.zeros_like(logits[:, 0]),
                              log_softmax_gather(logits, next_tok))
        self.toks.index_copy_(0, self.step, emit[None])
        self.lps.index_copy_(0, self.step, emit_lp[None])
        self.done.copy_(done | torch.isin(next_tok, e._eos) | (seq >= self.stop))
        self.tok.copy_(next_tok)
        self.step.add_(1)


class ChunkStep(_ReplayedStep):
    """One chunk of a chunked prefill (long prompts, prefix hits) of B
    requests and chunk width W, over static buffers: the chunk's ids, each
    request's length and chunk start, its table row, and the running
    last-position logits. Positions [start[b], start[b] + W) of request b
    run, with min(start[b], lens[b]) tokens of history in the pool (a
    request already consumed runs an empty chunk); the logits of a request
    whose prompt ends in the chunk replace its running row, and ``start``
    advances by W. On the card a full chunk's step is captured and replayed
    once a chunk (``InferenceEngine.chunk_step_for``): an eager chunk of a
    28-layer model launches ~1,700 kernels, and CUDA holds about 1,024
    launches in flight, so where the device ran longer than the host took
    to launch, the caller's thread waited for the device through the
    prefill; replayed, a prefill enqueues a few launches a chunk and
    returns at dispatch. Its warm-up runs with every length 0: no KV row
    changes, and the logits stay as they are.
    ``hist_bound`` bounds the history the plain CPU form gathers (the
    kernel walks each request's own pages)."""

    def __init__(self, engine: "InferenceEngine", width: int, W: int):
        dev = engine.device
        i32 = dict(dtype=torch.int32, device=dev)
        super().__init__(engine)
        self.W = W
        self.hist_bound = None
        self.ids = torch.zeros((width, W), dtype=torch.long, device=dev)
        self.lens = torch.zeros(width, **i32)
        self.start = torch.zeros(width, **i32)
        self.table = torch.zeros((width, engine.cache.pages_per_req), **i32)
        self.last = torch.zeros((width, engine.config.vocab_size), dtype=torch.float32,
                                device=dev)

    @torch.inference_mode()
    def load(self, lens, start, table) -> None:
        """A prefill's lengths, first chunk starts (its cached tokens) and
        table rows; the running logits zeroed."""
        for dst, src in ((self.lens, lens), (self.start, start), (self.table, table)):
            dst.copy_(src)
        self.last.zero_()

    def body(self) -> None:
        e, W, lens, start = self.engine, self.W, self.lens, self.start
        ctx = AttnContext(table_rows=self.table, seq_lens=lens,
                          start_pos=torch.minimum(lens, start),  # history per request
                          chunk_lens=(lens - start).clamp(0, W))
        logits, _ = decoder_prefill(e.params, e.config, e.cache.kv_pages, ctx, self.ids,
                                    last_only=True, chunked=True, hist_bound=self.hist_bound,
                                    shard=e.shard)
        ends_here = (lens > start) & (lens <= start + W)
        self.last.copy_(torch.where(ends_here[:, None], logits, self.last))
        self.start.add_(W)


def accepted_drafts(chunk: torch.Tensor, chunk_lens: torch.Tensor,
                    pred: torch.Tensor) -> torch.Tensor:
    """The longest accepted draft prefix a [B] of a verify chunk: draft i
    (column i + 1) is accepted iff every draft before it is, it is the
    model's greedy prediction ``pred`` after the token before it, and it
    lies inside the valid chunk (``chunk_lens``)."""
    K = chunk.shape[1]
    idx = torch.arange(1, K, dtype=torch.int32, device=chunk.device)
    ok = (chunk[:, 1:] == pred[:, :-1]) & (idx[None, :] < chunk_lens[:, None])
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)


class SpecStep(_ReplayedStep):
    """One speculative verify step of a session width B, chunk width K
    (draft length + 1), n-gram order and history length S, over static
    buffers: one iteration of the JAX engine's ``_spec_chunk`` scan. Device
    drafting from the history, the budget clamp, the verify
    (``InferenceEngine._spec_verify_body``), truncation at eos and at the
    budget, the history append and the done update. It reads and writes
    only its own buffers (slots, history [B, S], hist_len, cur, done,
    max_total, a step counter, and [n_steps, B, K] emitted tokens and
    [n_steps, B] kept counts written at the counter's row) and the engine's
    cache, parameters and eos ids, all at fixed addresses, so on the card it
    is captured and replayed as :class:`DecodeStep` is. With every row done
    its chunk is empty: it allocates no page, writes back the one KV row it
    reads and rewinds nothing."""

    def __init__(self, engine: "InferenceEngine", width: int, K: int, ngram: int, S: int,
                 n_steps: int):
        dev = engine.device
        i32 = dict(dtype=torch.int32, device=dev)
        super().__init__(engine)
        self.K, self.ngram = K, ngram
        self.req_ids = torch.zeros(width, **i32)
        # One dump slot past the history: the append's dropped writes land there.
        self._hist_flat = torch.zeros(width * S + 1, **i32)
        self.history = self._hist_flat[:width * S].view(width, S)
        self.hist_len = torch.zeros(width, **i32)
        self.cur = torch.zeros(width, **i32)
        self.done = torch.ones(width, dtype=torch.bool, device=dev)
        self.max_total = torch.zeros(width, **i32)
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.emits = torch.zeros((n_steps, width, K), **i32)
        self.keeps = torch.zeros((n_steps, width), **i32)

    @torch.inference_mode()
    def load(self, req_ids, history, hist_len, cur, done, max_total) -> None:
        """Copy a chunk's state into the buffers and restart the counter."""
        for dst, src in ((self.req_ids, req_ids), (self.history, history),
                         (self.hist_len, hist_len), (self.cur, cur), (self.done, done),
                         (self.max_total, max_total)):
            dst.copy_(src)
        self.step.zero_()

    def body(self) -> None:
        from ..generation.speculative import device_prompt_lookup

        e, K = self.engine, self.K
        B, S = self.history.shape
        kidx = torch.arange(K, dtype=torch.int32, device=e.device)
        rows = torch.arange(B, dtype=torch.int32, device=e.device)
        done, hist_len = self.done, self.hist_len
        room = self.max_total - hist_len
        active = ~done & (room > 0)
        drafts, d = device_prompt_lookup(self.history, hist_len, K - 1, self.ngram)
        d = torch.minimum(d, (room - 1).clamp(min=0))  # never emit past the budget
        chunk = torch.cat([self.cur[:, None], drafts], dim=1)
        chunk_lens = torch.where(active, 1 + d, 0).to(torch.int32)
        emit, n_emit, next_tok = e._spec_verify_body(self.req_ids, chunk, chunk_lens)
        # Keep up to and including the first eos, within the budget.
        is_eos = torch.isin(emit, e._eos) & (kidx[None, :] < n_emit[:, None])
        first_eos = torch.where(is_eos, kidx[None, :], K).amin(dim=1)
        n_keep = torch.minimum(torch.minimum(n_emit, first_eos + 1), room)
        n_keep = torch.where(active, n_keep, 0).to(torch.int32)
        wpos = hist_len[:, None] + kidx[None, :]
        valid = (kidx[None, :] < n_keep[:, None]) & (wpos < S)
        tgt = torch.where(valid, rows[:, None] * S + wpos, B * S)
        self._hist_flat[tgt.reshape(-1).long()] = emit.reshape(-1)
        hist_len.add_(n_keep)
        self.done.copy_(done | (first_eos < n_keep) | (hist_len >= self.max_total))
        self.cur.copy_(torch.where(active, next_tok, self.cur))
        self.emits.index_copy_(0, self.step, emit[None])
        self.keeps.index_copy_(0, self.step, n_keep[None])
        self.step.add_(1)


@dataclasses.dataclass
class _HostCopy:
    """A device -> host copy in flight: ``host`` is valid once ``ready``
    (a CUDA event, None on the CPU) has completed."""

    host: torch.Tensor
    ready: Optional[torch.cuda.Event]

    def wait(self) -> np.ndarray:
        if self.ready is not None:
            self.ready.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class _PrefillBundle:
    """A dispatched, uncollected prefill (``prefill_async``). ``packed`` is
    the host-bound [first token | logprob bits] copy; ``tok_dev`` is the
    first tokens on the device, which ``update_session_rows`` splices into a
    session with no host round trip."""

    packed: _HostCopy
    tok_dev: torch.Tensor
    lens: np.ndarray
    last: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _ChunkBundle:
    """A dispatched, uncollected decode chunk of ``n`` steps: packed
    [tokens n | logprob bits n | done 1] x B, a tensor of its own."""

    packed: _HostCopy
    n: int


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    chunks: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    # Engine calls that change the accounting or queue device work: every
    # rank of a mesh makes the same ones (the serving digest compares them).
    calls: int = 0


class PrefixCache:
    """Host-side registry of shared prompt prefixes.

    Entries are whole page-aligned prompt prefixes: key = chained sha256
    over page-sized token blocks, value = the page ids holding that
    prefix's KV plus a reference count. The device side stays simple:
    ``alloc_prefill`` splices shared pages into a table, ``free_requests``
    keeps them, ``push_pages`` evicts them; all sharing policy lives here."""

    def __init__(self):
        self.entries = {}  # key -> [n_pages, page_ids, refs, lru tick]
        self._tick = 0

    @staticmethod
    def chain_keys(tokens, page_size):
        """Chained per-page digests: keys[k-1] covers the first k pages, and
        equals a stored key iff that entry's k pages hold exactly those
        tokens."""
        keys = []
        h = hashlib.sha256()
        for k in range(len(tokens) // page_size):
            h.update(np.asarray(tokens[k * page_size:(k + 1) * page_size], np.int32).tobytes())
            keys.append(h.digest())
        return keys

    def lookup(self, keys):
        """Longest stored prefix among the chain keys: (key, n_pages,
        page_ids) or None. Takes no reference."""
        for k in range(len(keys), 0, -1):
            e = self.entries.get(keys[k - 1])
            if e is not None:
                return keys[k - 1], e[0], e[1]
        return None

    def acquire(self, key):
        self._tick += 1
        e = self.entries[key]
        e[2] += 1
        e[3] = self._tick

    def release(self, key):
        self.entries[key][2] -= 1

    def register(self, key, page_ids):
        if key in self.entries:
            return False
        self._tick += 1
        self.entries[key] = [len(page_ids), list(page_ids), 0, self._tick]
        return True

    def evictable(self):
        """(key, n_pages) pairs with no reference, least recently used first."""
        return sorted(((k, e[0]) for k, e in self.entries.items() if e[2] == 0),
                      key=lambda it: self.entries[it[0]][3])

    def pop(self, key):
        return self.entries.pop(key)[1]


class InferenceEngine:
    """Owns params + paged KV cache for one model: on one device, or one
    rank's share of them on a mesh (module docstring)."""

    def __init__(
        self,
        config: BaseConfig,
        params: dict,
        *,
        device="cuda",
        page_size: int = 16,
        max_reqs: int = 64,
        num_pages: Optional[int] = None,
        hbm_util: float = 0.9,
        decode_chunk: int = 32,
        prefill_chunk: int = 2048,
        kv_quant=False,  # False | True/'int8' | 'fp8'
        prefix_cache: bool = False,
        mesh=None,
        seed: int = 0,
    ):
        self.shard = ShardingPolicy(mesh=mesh)
        self.dp, self.cp = self.shard.dp, self.shard.cp
        if self.cp > 1 and (self.dp > 1 or self.shard.tp > 1):
            raise ValueError(
                "context parallelism (cp mesh axis) composes with neither dp nor tp inside the "
                "engine, as in the JAX engine: build the mesh with cp alone (make_mesh(cp=N))")
        if max_reqs % self.dp:
            raise ValueError(f"dp={self.dp} does not divide max_reqs={max_reqs}")
        self.device = require_device(device)
        if "lm" in params:
            raise ValueError("a LLaVA parameter tree: build a LlavaEngine "
                             "(executor/llava_engine.py)")
        emb = params["embed"]
        if emb.dtype != config.dtype:
            raise ValueError(
                f"params dtype {emb.dtype} != config.dtype {config.dtype}: cast the "
                "weights or the config (activations follow config.dtype)"
            )
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine on {self.device}")
        wq = params["layers"].get("wq")
        if self.shard.tp > 1 or (isinstance(wq, QTensor) and wq.packed):
            # One packed matmul per layer instead of two, as the JAX engine
            # fuses by default on one device, and at tp > 1 one clean
            # sharded matmul (shard-periodic head order).
            params = fuse_qkv_params(params, self.shard.tp)
        self.config = config
        self.params = self.shard.shard_params(config, params)
        self.kv_quant = kv_quant
        self.page_size = page_size
        self.max_reqs = max_reqs
        self.M_local = max_reqs // self.dp  # slots of one data group
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk
        if num_pages is None:
            num_pages = self._auto_num_pages(hbm_util)
        # Equal pools per data group, equal shares per context rank.
        num_pages -= num_pages % (self.dp * self.cp)
        self.num_pages = num_pages
        group_pages = num_pages // self.dp
        kv_heads, head_offset = self.shard.local_kv_heads(config.num_key_value_heads)
        # This rank's device state: its data group's pool (local slot and
        # page ids), its context rank's share of the pages.
        self.cache = create_kv_cache(
            config.num_hidden_layers, kv_heads, config.head_dim,
            num_pages=group_pages, page_size=page_size, max_reqs=self.M_local,
            max_seq_len=config.max_seq_len, dtype=config.dtype, device=self.device,
            quantized=kv_quant, head_offset=head_offset, cp=(self.shard.cp_rank, self.cp),
        )
        self._gen = torch.Generator(device=self.device)
        if self.dp > 1:  # each group draws its own numbers (JAX's _dp_key)
            seed = int(np.random.SeedSequence([seed, self.shard.dp_rank]).generate_state(1)[0])
        self._gen.manual_seed(seed)
        # Host accounting of every data group, identical on every rank.
        self._slots_by_group = [list(range(g * self.M_local, (g + 1) * self.M_local))
                                for g in range(self.dp)]
        self._pages_by_group = [group_pages] * self.dp
        self._group_pages_total = group_pages
        self.stats = EngineStats()
        self.prefixes = [PrefixCache() for _ in range(self.dp)] if prefix_cache else None
        self._slot_prefix = {}  # slot -> (group, key, n_pages, page_ids) of its prefix hit
        self._slot_prompt = {}  # slot -> prompt tokens (registered on release)
        # Slots that actually ran prefill: only these may donate pages on
        # release (a rolled-back admission's table rows are zeros or stale).
        self._slot_filled = set()
        self.pad_id = config.pad_token_id if config.pad_token_id is not None else 0
        # Decode steps by (session width, sampling mode); on the card each is
        # a captured graph, all in one memory pool, captured on one stream.
        self._steps = {}
        # Speculative verify steps by (width, K, ngram, history length, steps).
        self._spec_steps = {}
        # Chunked-prefill steps by (batch width, chunk width).
        self._chunk_steps = {}
        self._graph_pool = None
        self._graph_stream = None
        self._eos_list = None
        self.set_eos(config.eos_token_ids)
        # Host-side slot/page/prefix accounting is guarded by one lock so
        # concurrent submitters can admit and release safely.
        self._admission_lock = threading.RLock()

    def set_eos(self, eos_ids: Sequence[int]) -> None:
        """Token ids that end a request during decode. The decode and
        speculative steps read the id tensor, so new ids drop them (once the
        device has finished with them); the next chunk builds them again."""
        ids = [int(t) for t in eos_ids] or [-1]
        if ids == self._eos_list:
            return
        if (self._steps or self._spec_steps) and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._steps.clear()
        self._spec_steps.clear()
        self._eos_list = ids
        self.eos_ids = [t for t in ids if t >= 0]
        self._eos = torch.tensor(ids, dtype=torch.int32, device=self.device)

    # -- host capacity accounting (per data group) -------------------------
    @property
    def prefix(self) -> Optional[PrefixCache]:
        """The prefix registry of data group 0: the engine's only one at dp
        1 (None without the prefix cache); ``prefixes`` holds every group's."""
        return self.prefixes[0] if self.prefixes else None

    @property
    def _free_slots(self) -> List[int]:
        return [s for g in self._slots_by_group for s in g]

    @property
    def _host_free_pages(self) -> int:
        return sum(self._pages_by_group)

    def group_of(self, slot: int) -> int:
        """The data group that owns a slot."""
        return slot // self.M_local

    def _mine(self, slot: int) -> bool:
        return self.group_of(slot) == self.shard.dp_rank

    def admit_feasible(self, total_len: int) -> bool:
        """Could a request of ``total_len`` tokens EVER be admitted (with an
        idle engine)? False means waiting is pointless."""
        return (
            0 < total_len <= self.config.max_seq_len
            and cdiv(total_len, self.page_size) <= self._group_pages_total
        )

    def try_admit(self, total_len: int, prompt_tokens=None):
        """Place one request: the data group with the longest prefix hit of
        ``prompt_tokens`` (with the prefix cache), ties broken by the most
        free pages, among the groups with a free slot and the pages for
        ``total_len`` tokens beyond the hit (counting the entries it could
        evict); evict there only, reserve the pages and return the slot, or
        None. A hit takes a reference on its entry and records the splice
        for prefill."""
        with self._admission_lock:
            return self._try_admit_locked(total_len, prompt_tokens)

    def _try_admit_locked(self, total_len: int, prompt_tokens=None):
        self.stats.calls += 1
        total_pages = cdiv(total_len, self.page_size)
        hits = [None] * self.dp
        if self.prefixes is not None and prompt_tokens is not None:
            keys = PrefixCache.chain_keys(prompt_tokens, self.page_size)
            # Never reuse the whole prompt: its last token is recomputed so
            # that the logits for the first output token exist.
            max_use = (len(prompt_tokens) - 1) // self.page_size
            for g, reg in enumerate(self.prefixes):
                h = reg.lookup(keys)
                if h is not None and min(h[1], max_use) > 0:
                    k_use = min(h[1], max_use)
                    hits[g] = (h[0], k_use, h[2][:k_use])
        best, best_rank = None, None
        for g in range(self.dp):
            if not self._slots_by_group[g]:
                continue
            k = hits[g][1] if hits[g] else 0
            protect = hits[g][0] if hits[g] else None
            # Rank on the capacity the group could free; only the winner evicts.
            evictable = (sum(n for key, n in self.prefixes[g].evictable() if key != protect)
                         if self.prefixes is not None else 0)
            if self._pages_by_group[g] + evictable < total_pages - k:
                continue
            rank = (k, self._pages_by_group[g])
            if best is None or rank > best_rank:
                best, best_rank = g, rank
        if best is None:
            return None
        hit = hits[best]
        need = total_pages - (hit[1] if hit else 0)
        if self._pages_by_group[best] < need:
            self._evict_for(best, need, hit[0] if hit else None)
        if self._pages_by_group[best] < need:
            return None  # fail closed rather than oversubscribe
        self._pages_by_group[best] -= need
        slot = self._slots_by_group[best].pop(0)
        if hit:
            key, k_use, pages = hit
            self.prefixes[best].acquire(key)
            self._slot_prefix[slot] = (best, key, k_use, pages)
            self.stats.prefix_hits += 1
            self.stats.prefix_tokens_reused += k_use * self.page_size
        if self.prefixes is not None and prompt_tokens is not None:
            self._slot_prompt[slot] = list(prompt_tokens)
        return slot

    def admit_requests(self, total_lens: Sequence[int], prompts=None) -> List[int]:
        """try_admit for a whole batch; raises (and rolls back) if any
        request cannot be placed."""
        with self._admission_lock:
            slots: List[int] = []
            for i, n in enumerate(total_lens):
                s = self.try_admit(n, prompts[i] if prompts is not None else None)
                if s is None:
                    self.release_slots(slots, total_lens[: len(slots)])
                    raise RuntimeError(
                        f"KV capacity exhausted: {len(slots)}/{len(total_lens)} requests "
                        f"placed (free pages per group: {self._pages_by_group}, free slots per "
                        f"group: {[len(g) for g in self._slots_by_group]})"
                    )
                slots.append(s)
            return slots

    def acquire_slots(self, n: int) -> List[int]:
        """Slots alone, round-robin over the data groups, with no pages
        reserved (JAX's legacy ``acquire_slots``; ``admit_requests`` also
        reserves each request's pages in its group)."""
        with self._admission_lock:
            if len(self._free_slots) < n:
                raise RuntimeError(f"request slots exhausted: want {n}, free "
                                   f"{len(self._free_slots)}")
            out, g = [], 0
            while len(out) < n:
                if self._slots_by_group[g % self.dp]:
                    out.append(self._slots_by_group[g % self.dp].pop(0))
                g += 1
            return out

    def _evict_for(self, g: int, need: int, protect=None) -> None:
        """Evict data group ``g``'s unreferenced prefix entries, least
        recently used first, until ``need`` pages are free or nothing
        evictable remains. ``protect`` shields the entry the caller is about
        to splice in. Only the group's own rank holds the pages."""
        for key, _ in self.prefixes[g].evictable():
            if self._pages_by_group[g] >= need:
                return
            if key == protect:
                continue
            pages = self.prefixes[g].pop(key)
            if g == self.shard.dp_rank:
                with torch.inference_mode():
                    push_pages(self.cache, self._ids(pages),
                               torch.ones(len(pages), dtype=torch.bool, device=self.device))
            self._pages_by_group[g] += len(pages)

    @torch.inference_mode()
    def release_slots(self, slots: Sequence[int], lens: Sequence[int]):
        """Free finished requests' slots and pages. With the prefix cache, a
        request that hit keeps its shared pages (they belong to the entry;
        its reference is dropped), and one that prefilled without a hit
        donates its prompt's full pages as a new entry of its group (their
        ids are known on the group's own rank only, which alone uses them)."""
        with self._admission_lock:
            if not slots:
                return
            self.stats.calls += 1
            keep = [0] * len(slots)
            returned = [cdiv(n, self.page_size) for n in lens]
            if self.prefixes is not None:
                table_host = None
                for i, s in enumerate(slots):
                    g = self.group_of(s)
                    used = self._slot_prefix.pop(s, None)
                    prompt = self._slot_prompt.pop(s, None)
                    filled = s in self._slot_filled
                    self._slot_filled.discard(s)
                    if used is not None:
                        _, key, n_pages, _ = used
                        self.prefixes[g].release(key)
                        keep[i] = n_pages
                        returned[i] -= n_pages
                    elif filled and prompt is not None and len(prompt) >= self.page_size:
                        keys = PrefixCache.chain_keys(prompt, self.page_size)
                        if keys[-1] not in self.prefixes[g].entries:
                            pages = [-1] * len(keys)
                            if self._mine(s):
                                if table_host is None:
                                    table_host = self.cache.page_table.cpu().numpy()
                                pages = table_host[s % self.M_local, :len(keys)].tolist()
                            self.prefixes[g].register(keys[-1], pages)
                            keep[i] = len(keys)
                            returned[i] -= len(keys)
            mine = [i for i, s in enumerate(slots) if self._mine(s)]
            if mine:
                free_requests(self.cache, self._ids([slots[i] % self.M_local for i in mine]),
                              self._ids([keep[i] for i in mine]))
            for s, n in zip(slots, returned):
                g = self.group_of(s)
                self._pages_by_group[g] += n
                self._slots_by_group[g].append(s)

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, ckpt_dir: str, dtype=torch.bfloat16, max_seq_len=None, device="cuda",
              **kw) -> "InferenceEngine":
        """Load config + weights from an HF or engine-converted checkpoint dir
        onto ``device`` and build the engine (``kw`` goes to ``__init__``).
        ``engine.load_stats`` records the load: seconds to read the files
        onto the device (``read_s``) and to a ready engine (``ready_s``), and
        the bytes read."""
        from ..config import load_config
        from ..utils.safetensors_io import load_file
        from ..utils.weights import (
            CONVERTED_FILE,
            is_converted_checkpoint,
            load_hf_safetensors,
            params_from_converted,
            params_from_hf_state_dict,
        )

        require_device(device)
        t0 = time.perf_counter()
        overrides = {"dtype": dtype}
        if max_seq_len is not None:
            overrides["max_seq_len"] = max_seq_len
        config = load_config(ckpt_dir, **overrides)
        converted = is_converted_checkpoint(ckpt_dir)
        if converted:
            tensors = load_file(os.path.join(ckpt_dir, CONVERTED_FILE), device)
        else:
            tensors = load_hf_safetensors(ckpt_dir, device)
        _synchronize(device)
        read_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size() for t in tensors.values())
        if converted:
            params = params_from_converted(tensors, dtype)
        else:
            params = params_from_hf_state_dict(tensors, config, device)
        del tensors
        engine = cls(config, params, device=device, **kw)
        _synchronize(device)
        engine.load_stats = dict(converted=converted, bytes=n_bytes, read_s=read_s,
                                 ready_s=time.perf_counter() - t0)
        return engine

    def _auto_num_pages(self, hbm_util: float) -> int:
        """Size the KV pool from free device memory. On the CPU (tests) there
        is no device budget: the pool holds every slot at max_seq_len. A page
        counts ``cfg.dtype`` bytes whatever the pool's type, as in the JAX
        engine, so admission decisions stay equal. At tp > 1 a rank holds
        1/tp of the weights (its shard is on the device already, as the JAX
        engine counts param_bytes / tp) and a page of its kv heads, and the
        ranks take the least of their budgets, so every rank's accounting is
        the same. A dp or cp rank holds 1/dp or 1/cp of the pages, so the
        pool is its budget times dp * cp. Ranks sharing one card must pass
        ``num_pages``."""
        cfg = self.config
        want = self.max_reqs * cdiv(cfg.max_seq_len, self.page_size)
        if self.device.type != "cuda":
            return want
        per_page = kv_cache_bytes(
            cfg.num_hidden_layers, self.shard.local_kv_heads(cfg.num_key_value_heads)[0],
            cfg.head_dim, 1, self.page_size, cfg.dtype,
        )
        free, total = torch.cuda.mem_get_info(self.device)
        budget = total * hbm_util - (total - free)
        fit = max(64, min(want, int(budget // per_page) * self.dp * self.cp))
        if self.shard.size > 1:
            group = self.shard.group if self.shard.size == self.shard.tp else None
            fit = distributed.all_reduce_min_int(fit, self.device, group)
        return fit

    # -- host <-> device ------------------------------------------------------
    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device. On the card the copy goes
        through pinned memory without blocking, so it queues behind the
        device's work instead of waiting for it."""
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _ids(self, xs, dtype=torch.int32) -> torch.Tensor:
        """``xs`` (a tensor, or array-like copied so that later host writes
        never reach it) on the device as ``dtype``."""
        if isinstance(xs, torch.Tensor):
            return self._upload(xs).to(dtype)
        return self._upload(torch.tensor(np.asarray(xs), dtype=dtype))

    def _to_host(self, x: torch.Tensor) -> _HostCopy:
        """Start copying ``x`` to the host; ``.wait()`` returns it."""
        if x.device.type != "cuda":
            return _HostCopy(x, None)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        return _HostCopy(host, ready)

    def _dev_sampling(self, sampling: SamplingParams) -> SamplingParams:
        return SamplingParams(*(self._upload(t) for t in sampling))

    @staticmethod
    def _mode_of(temperature, top_p, top_k) -> str:
        """Static sampling mode from host arrays: "greedy" when every request
        is greedy (no candidate search, no random draw), else exact/approx
        as ``needs_exact_sampling`` decides."""
        t = np.asarray(temperature)
        if np.all(t <= 0.0):
            return "greedy"
        return "exact" if needs_exact_sampling(t, np.asarray(top_p), np.asarray(top_k)) else "approx"

    def _samp_mode(self, sampling: SamplingParams) -> str:
        """:meth:`_mode_of` for a SamplingParams (a device copy syncs)."""
        return self._mode_of(*(t.cpu().numpy() for t in sampling))

    # -- prefill --------------------------------------------------------------
    def _prefill_step(self, ids, lens, req_ids, sampling, mode):
        alloc_prefill(self.cache, req_ids, lens)
        ctx = AttnContext(
            table_rows=self.cache.page_table[req_ids.long()],
            seq_lens=lens,
            start_pos=torch.zeros_like(lens),
            chunk_lens=lens,
        )
        last, _ = decoder_prefill(
            self.params, self.config, self.cache.kv_pages, ctx, ids, last_only=True,
            shard=self.shard,
        )
        tok = sample(last, self._gen, sampling, mode=mode)
        return tok, last, log_softmax_gather(last, tok)

    def prefill(self, token_lists: Sequence[Sequence[int]], sampling: SamplingParams,
                slots, return_logits: bool = False):
        """Blocking prefill: dispatch + collect. Returns (first_tokens [B] np,
        lens [B] np, last_logits [B, V] np or None, logprobs [B] np)."""
        return self.prefill_collect(
            self.prefill_async(token_lists, sampling, slots, return_logits=return_logits))

    @torch.inference_mode()
    def prefill_async(self, token_lists: Sequence[Sequence[int]], sampling: SamplingParams,
                      slots, return_logits: bool = False) -> _PrefillBundle:
        """Dispatch the prefill of a batch of prompts into their slots and the
        first-token sampling; returns a bundle for :meth:`prefill_collect`
        (or for ``update_session_rows``, which reads its device-side first
        tokens). At dp > 1 this rank prefills its data group's rows and the
        outputs are gathered into the caller's order (module docstring)."""
        self.stats.calls += 1
        lens = np.asarray([len(t) for t in token_lists], np.int32)
        if int(lens.max()) > self.config.max_seq_len:
            raise ValueError(f"prompt of {int(lens.max())} tokens exceeds max_seq_len="
                             f"{self.config.max_seq_len}")
        mode = self._samp_mode(sampling)
        cached = np.asarray([self._slot_prefix[s][2] * self.page_size
                             if s in self._slot_prefix else 0 for s in slots], np.int32)
        # The whole batch decides the path and the chunk width, as in the
        # JAX engine: a data group's rows take the batch's.
        resid = lens - cached
        W = None
        if lens.max() > self.prefill_chunk or cached.any():
            W = min(self.prefill_chunk, max(int(resid.max()), 1))
        layout = self._layout(slots)
        mine = list(range(len(slots))) if layout is None else layout[self.shard.dp_rank]
        rows = (token_lists, sampling, list(slots)) if layout is None else (
            [token_lists[i] for i in mine], SamplingParams(*(t[mine] for t in sampling)),
            [slots[i] for i in mine])
        tok = lp = last = None
        if mine:
            tok, lp, last = self._prefill_rows(*rows, mode, W)
        if layout is not None:
            tok, lp, last = self._gathered(layout, tok, lp, last, return_logits)
        self.stats.prefill_tokens += int(resid.sum())
        self._slot_filled.update(slots)
        packed = torch.stack([tok.to(torch.int32), lp.float().view(torch.int32)])
        return _PrefillBundle(packed=self._to_host(packed), tok_dev=tok, lens=lens,
                              last=last if return_logits else None)

    def _prefill_rows(self, token_lists, sampling: SamplingParams, slots, mode, W):
        """The prefill of rows of this rank's data group (all rows at dp 1),
        in one shot or (``W``: the chunk width) chunk by chunk: (first
        tokens [n], their logprobs [n], last logits [n, V]) on the device."""
        B = len(token_lists)
        lens = np.asarray([len(t) for t in token_lists], np.int32)
        samp = self._dev_sampling(sampling)
        req_ids = self._ids([s % self.M_local for s in slots])
        ps = self.page_size
        ppr = self.cache.pages_per_req
        # Prefix-cache splice info (slot state set by try_admit).
        cached = np.zeros((B,), np.int32)  # cached tokens per request
        prefix_rows = np.zeros((B, ppr), np.int32)
        prefix_pages = np.zeros((B,), np.int32)
        for i, s in enumerate(slots):
            hit = self._slot_prefix.get(s)
            if hit is not None:
                _, _, n_use, pages = hit
                cached[i] = n_use * ps
                prefix_pages[i] = n_use
                prefix_rows[i, :n_use] = pages

        if W is not None:
            # Chunked path: chunks of W tokens through the paged-history
            # attention, each request starting after its cached pages.
            resid = lens - cached
            n_chunks = max(cdiv(int(resid.max()), W), 1)
            ids = np.full((B, n_chunks * W), self.pad_id, np.int32)
            for i, t in enumerate(token_lists):
                ids[i, : len(t) - cached[i]] = t[cached[i]:]
            lens_d = self._ids(lens)
            alloc_prefill(self.cache, req_ids, lens_d, self._ids(prefix_rows),
                          self._ids(prefix_pages))
            step = self.chunk_step_for(B, W)
            step.load(lens_d, self._ids(cached), self.cache.page_table[req_ids.long()])
            ids_d = self._ids(ids, torch.long)
            for ci in range(n_chunks):
                # No request has more pool history than this chunk's bound:
                # the plain CPU form gathers only that much.
                hist_tok = min(int(cached.max()) + ci * W, int(lens.max()))
                step.hist_bound = min(cdiv(hist_tok, ps), ppr) * ps
                step.ids.copy_(ids_d[:, ci * W:(ci + 1) * W])
                step.run(1)
            last = step.last.clone()  # the step's buffer serves the next prefill
            tok = sample(last, self._gen, samp, mode=mode)
            return tok, log_softmax_gather(last, tok), last
        ids = np.full((B, int(lens.max())), self.pad_id, np.int32)
        for i, t in enumerate(token_lists):
            ids[i, : len(t)] = t
        tok, last, lp = self._prefill_step(self._ids(ids, torch.long), self._ids(lens), req_ids,
                                           samp, mode)
        return tok, lp, last

    # -- data parallelism ---------------------------------------------------
    def _layout(self, slots) -> Optional[tuple]:
        """At dp > 1, the caller's rows of each data group, in order (None at
        dp 1: every row is this rank's)."""
        if self.dp == 1:
            return None
        rows = tuple([] for _ in range(self.dp))
        for i, s in enumerate(slots):
            rows[self.group_of(s)].append(i)
        return rows

    def _gather_rows(self, layout, x: Optional[torch.Tensor], cols: int) -> torch.Tensor:
        """Every data group's rows of an int32 [n, cols] (this rank's:
        ``x``, None when it has none) in the caller's order, [B, cols] on
        every rank: one all-gather over the data groups, padded to the
        widest group (each group's width is known from ``layout``)."""
        if x is None:
            x = torch.zeros((0, cols), dtype=torch.int32, device=self.device)
        width = max(len(r) for r in layout)
        parts = distributed.all_gather_padded(x, width, self.shard.mesh.dp_group)
        out = torch.empty((sum(len(r) for r in layout), cols), dtype=x.dtype, device=x.device)
        for rows, part in zip(layout, parts):
            if rows:
                out[self._ids(rows, torch.long)] = part[:len(rows)]
        return out

    def _gathered(self, layout, tok, lp, last, with_last: bool):
        """A prefill's (first tokens, logprobs, last logits if ``with_last``)
        of every data group in the caller's order, from this rank's rows
        (None where it has none)."""
        cols = 2 + (self.config.vocab_size if with_last else 0)
        x = None
        if tok is not None:
            parts = [tok.to(torch.int32)[:, None], lp.float().view(torch.int32)[:, None]]
            if with_last:
                parts.append(last.float().view(torch.int32))
            x = torch.cat(parts, dim=1)
        out = self._gather_rows(layout, x, cols)
        return (out[:, 0].contiguous(), out[:, 1].contiguous().view(torch.float32),
                out[:, 2:].contiguous().view(torch.float32) if with_last else None)

    def prefill_collect(self, bundle: _PrefillBundle):
        """Wait for a dispatched prefill's host-bound outputs. Returns
        (first_tokens [B] np, lens [B] np, last_logits [B, V] np or None,
        logprobs [B] np)."""
        ph = bundle.packed.wait()
        last = None if bundle.last is None else bundle.last.cpu().numpy()
        return ph[0].copy(), bundle.lens, last, ph[1].view(np.float32).copy()

    # -- decode ---------------------------------------------------------------
    @torch.inference_mode()
    def start_decode_session(self, slots, tok, done, stop_lens,
                             sampling: SamplingParams) -> DecodeSession:
        """Upload one batch's decode state once; decode chunks then run
        against it with no further uploads. The session owns its token and
        done tensors (chunks update them in place). At dp > 1 it holds this
        rank's data group's rows (``layout``)."""
        self.stats.calls += 1
        mode = self._samp_mode(sampling)
        layout = self._layout(slots)
        if layout is not None:
            mine = layout[self.shard.dp_rank]

            def rows(x):
                return x[mine] if isinstance(x, torch.Tensor) else np.asarray(x)[mine]

            slots = [slots[i] % self.M_local for i in mine]
            tok, done, stop_lens = rows(tok), rows(done), rows(stop_lens)
            sampling = SamplingParams(*(t[mine] for t in sampling))
        return DecodeSession(
            slots=tuple(slots),
            req_ids=self._ids(slots),
            tok=self._ids(tok).clone(),
            done=self._ids(done, torch.bool).clone(),
            stop=self._ids(stop_lens),
            samp=self._dev_sampling(sampling),
            mode=mode,
            layout=layout,
        )

    @torch.inference_mode()
    def update_session_rows(self, s: DecodeSession, rows, bundle: _PrefillBundle, prompt_lens,
                            stop_lens, temperature, top_p, top_k) -> None:
        """Splice freshly prefilled requests into a resident session in
        place: the prefill's device-side first tokens go into session rows
        ``rows`` (host indices, one per request of the prefill, in its
        order), with the host-known stop and sampling values, and each new
        row's done flag is computed on the device (the first token is eos,
        or the prompt already fills its budget). Nothing waits for the
        prefill. Rows >= max_reqs are dropped, as JAX drops out-of-bounds
        scatter rows. At dp > 1 the session holds this rank's data group's
        rows only: a row of the group is written at its local position,
        and the other groups' rows are left to their ranks."""
        self.stats.calls += 1
        rows = np.asarray(rows, np.int64)
        keep = np.flatnonzero(rows < self.max_reqs)  # the prefill's requests that land
        dst = rows[keep]
        if s.layout is not None:
            local = {row: j for j, row in enumerate(s.layout[self.shard.dp_rank])}
            keep = np.asarray([k for k in keep if rows[k] in local], np.int64)
            dst = np.asarray([local[rows[k]] for k in keep], np.int64)
        if not keep.size:
            return
        r = self._ids(dst, torch.long)
        newtok = bundle.tok_dev[self._ids(keep, torch.long)]
        stop_new = self._ids(np.asarray(stop_lens)[keep])
        plens = self._ids(np.asarray(prompt_lens)[keep])
        s.tok[r] = newtok.to(s.tok.dtype)
        s.done[r] = torch.isin(newtok, self._eos) | (plens + 1 >= stop_new)
        s.stop[r] = stop_new
        s.samp.temperature[r] = self._ids(np.asarray(temperature)[keep], torch.float32)
        s.samp.top_p[r] = self._ids(np.asarray(top_p)[keep], torch.float32)
        s.samp.top_k[r] = self._ids(np.asarray(top_k)[keep], torch.int32)

    @torch.inference_mode()
    def dispatch_decode_chunk(self, s: DecodeSession, n: int) -> _ChunkBundle:
        """Enqueue one decode chunk of ``min(n, decode_chunk)`` steps against
        a session without waiting for the device: a pipelining caller
        processes the previous chunk's results while this one runs. The
        chunk's packed output is a tensor of its own, copied to the host
        asynchronously."""
        n = min(n, self.decode_chunk)
        if n < 1:
            raise ValueError("a decode chunk needs at least one step")
        self.stats.calls += 1
        packed = None
        if s.slots:
            step = self.decode_step_for(len(s.slots), s.mode)
            step.load(s)
            step.run(n)
            s.tok.copy_(step.tok)
            s.done.copy_(step.done)
            packed = torch.cat([
                step.toks[:n],
                step.lps[:n].view(torch.int32),
                step.done.to(torch.int32)[None],
            ])
        if s.layout is not None:  # every data group's rows, in the caller's order
            packed = self._gather_rows(s.layout, None if packed is None else packed.t(),
                                       2 * n + 1).t()
        self.stats.chunks += 1
        return _ChunkBundle(packed=self._to_host(packed.contiguous()), n=n)

    @torch.inference_mode()
    def decode_step_for(self, width: int, mode: str) -> DecodeStep:
        """The decode step of a session width and sampling mode, made at
        first use; on the card it is captured then (a serving caller may
        call this before its traffic, so that no request waits for it)."""
        key = (width, mode)
        step = self._steps.get(key)
        if step is None:
            step = self._captured(DecodeStep(self, width, mode))
            self._steps[key] = step
        return step

    @torch.inference_mode()
    def chunk_step_for(self, width: int, W: int) -> ChunkStep:
        """The chunked-prefill step of a batch width and chunk width. Full
        chunks (W = ``prefill_chunk``: long prompts, where the device runs
        longer than the host takes to launch a chunk) are made once and
        captured on the card; a narrower chunk (the tail after a prefix hit,
        a prompt that fits one chunk) gets an eager step of its own, as
        its widths vary from call to call and a capture costs more than
        its launches."""
        key = (width, W)
        step = self._chunk_steps.get(key)
        if step is None:
            step = ChunkStep(self, width, W)
            if W == self.prefill_chunk:
                self._chunk_steps[key] = self._captured(step)
        return step

    def _captured(self, step):
        """``step`` captured on the card (every graph in one memory pool, on
        one stream); on the CPU, and at tp > 1 or cp > 1 (whose steps hold
        collectives), it stays eager."""
        if self.device.type == "cuda" and self.shard.tp == 1 and self.cp == 1:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            step.capture(self._graph_pool, self._graph_stream)
        return step

    def collect_decode_chunk(self, bundle: _ChunkBundle):
        """Wait for a dispatched chunk. Returns (tokens [n, B] np.int32,
        logprobs [n, B] np.float32, done [B] bool) in the session's order."""
        ph = bundle.packed.wait()
        n = bundle.n
        toks = ph[:n].copy()
        lps = ph[n:2 * n].view(np.float32).copy()
        done_h = ph[-1].astype(bool)
        # Rows still live at the chunk's end (full-width serving sessions
        # carry done and empty rows); rows finishing mid-chunk undercount.
        self.stats.decode_tokens += n * int((~done_h).sum())
        return toks, lps, done_h

    def decode_session(self, s: DecodeSession, n_steps: int):
        """Run ``n_steps`` decode steps against a session, one chunk at a
        time, stopping early once every row is done. Returns (tokens
        [n, B], logprobs [n, B], done [B] bool), pad-filled after each row's
        eos."""
        if n_steps <= 0:  # degenerate budget: report state, emit nothing
            done = s.done.to(torch.int32)[:, None]
            if s.layout is not None:
                done = self._gather_rows(s.layout, done if s.slots else None, 1)
            B = done.shape[0]
            return (np.zeros((0, B), np.int32), np.zeros((0, B), np.float32),
                    done[:, 0].cpu().numpy().astype(bool))
        all_toks, all_lps = [], []
        remaining = n_steps
        while remaining > 0:
            n = min(remaining, self.decode_chunk)
            toks, lps, done_h = self.collect_decode_chunk(self.dispatch_decode_chunk(s, n))
            all_toks.append(toks)
            all_lps.append(lps)
            remaining -= n
            if remaining > 0 and bool(done_h.all()):
                break
        return np.concatenate(all_toks), np.concatenate(all_lps), done_h

    def decode(self, slots, tok, done, stop_lens, sampling: SamplingParams, n_steps: int):
        """Run up to ``n_steps`` decode steps for the requests in ``slots``
        through a one-shot session. Returns (tok [B] tensor, done [B] tensor,
        tokens [n, B] np.int32 pad-filled after each row's eos, logprobs
        [n, B] np.float32). The host syncs once per ``decode_chunk``
        steps."""
        s = self.start_decode_session(slots, tok, done, stop_lens, sampling)
        toks, lps, done_h = self.decode_session(s, n_steps)
        if s.layout is None:
            return s.tok, s.done, toks, lps
        # At dp > 1 the session holds one group's rows: the caller's next
        # tokens are the last step's (a row done before it emitted pad,
        # and is done).
        tok = torch.from_numpy(toks[-1].copy()) if len(toks) else torch.as_tensor(np.asarray(tok))
        return tok, torch.from_numpy(done_h), toks, lps

    def refuse_dp(self) -> None:
        """Speculative decoding has no data-group layout of its verify chunk:
        refused at dp > 1 with the JAX engine's message."""
        if self.dp > 1:
            raise NotImplementedError("speculative decoding: dp meshes unsupported")

    # -- speculative decoding (greedy verify) ------------------------------------
    def _spec_verify_body(self, req_ids, chunk, chunk_lens):
        """One greedy verify step on the device, with no host sync.
        ``chunk`` [B, K] int32: column 0 is each request's current next token
        (sampled but not in the pool: the virtual-token protocol), columns
        1..c-1 its drafts; ``chunk_lens`` [B] the valid width c (0: the row
        sits out). Allocates pages for ``L + c`` tokens, runs a chunked
        prefill over the chunk with every position's logits (its KV lands in
        the pool), accepts the longest draft prefix that matches the model's
        argmax, and rewinds each request to ``L + a + 1`` (the current token
        and the accepted drafts; the bonus token stays virtual). Returns
        (emit [B, K]: the accepted drafts, then the bonus token, pad after;
        n_emit [B] = a + 1; next_tok [B], the bonus token). The plain CPU
        attention reads the whole page-table span of history. At tp > 1
        the vocab-sharded logits are all-gathered, so every rank reads the
        whole [B, K, V]."""
        self.refuse_dp()
        cache, ps = self.cache, self.page_size
        K = chunk.shape[1]
        req = req_ids.long()
        L = cache.seq_lens[req]
        new_total = L + chunk_lens
        alloc_prefill(cache, req_ids, new_total, prefix_rows=cache.page_table[req],
                      prefix_pages=(L + ps - 1) // ps)
        ctx = AttnContext(table_rows=cache.page_table[req], seq_lens=new_total, start_pos=L,
                          chunk_lens=chunk_lens)
        logits, _ = decoder_prefill(self.params, self.config, cache.kv_pages, ctx,
                                    chunk.long(), chunked=True, shard=self.shard)
        pred = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, K]
        a = accepted_drafts(chunk, chunk_lens, pred)
        next_tok = torch.gather(pred, 1, a[:, None].long())  # [B, 1]
        kidx = torch.arange(K, dtype=torch.int32, device=chunk.device)
        drafts = torch.cat([chunk[:, 1:], torch.zeros_like(chunk[:, :1])], dim=1)
        emit = torch.where(kidx[None, :] < a[:, None], drafts, self.pad_id).to(torch.int32)
        emit.scatter_(1, a[:, None].long(), next_tok)
        rewind_requests(cache, req_ids, L + a + 1)
        return emit, a + 1, next_tok[:, 0]

    @torch.inference_mode()
    def spec_verify(self, slots, chunk_tokens, chunk_lens):
        """One greedy speculative verify step for the requests in ``slots``
        (``_spec_verify_body``), run eagerly. ``chunk_tokens`` [B, K] and
        ``chunk_lens`` [B] are host arrays. Returns (emit [B, K], n_emit [B],
        next_tok [B]) as numpy int32, from one host copy."""
        self.stats.calls += 1
        chunk = np.asarray(chunk_tokens, np.int32)
        K = chunk.shape[1]
        emit, n_emit, next_tok = self._spec_verify_body(
            self._ids(slots), self._ids(chunk), self._ids(np.asarray(chunk_lens, np.int32)))
        packed = torch.cat([emit, n_emit[:, None], next_tok[:, None]], dim=1)
        ph = self._to_host(packed).wait()
        return ph[:, :K].copy(), ph[:, K].copy(), ph[:, K + 1].copy()

    @torch.inference_mode()
    def spec_step_for(self, width: int, K: int, ngram: int, S: int, n_steps: int) -> SpecStep:
        """The speculative step of a (width, chunk width, n-gram order,
        history length, chunk depth), made at first use and captured on the
        card then."""
        key = (width, K, ngram, S, n_steps)
        step = self._spec_steps.get(key)
        if step is None:
            step = self._captured(SpecStep(self, width, K, ngram, S, n_steps))
            self._spec_steps[key] = step
        return step

    @torch.inference_mode()
    def spec_decode_chunk(self, slots, history, hist_len, cur, done, max_total,
                          n_steps: int = 8, draft_len: int = 4, ngram: int = 3):
        """``n_steps`` speculative steps with drafting on the device
        (``SpecStep``, replayed on the card), then one host copy. State, on
        the device: ``history`` int32 [B, S], row b valid in [0,
        hist_len[b]) and ending with the current next token ``cur[b]``;
        ``done`` bool [B]; ``max_total`` [B] (prompt + generation budget, a
        host list). The state tensors are updated in place and returned:
        (history, hist_len, cur, done, emits [n_steps, B, K] np, keeps
        [n_steps, B] np, done [B] np bool); step s of row b emitted
        ``keeps[s, b]`` tokens, eos- and budget-truncated."""
        self.refuse_dp()
        self.stats.calls += 1
        B = len(slots)
        K = draft_len + 1
        step = self.spec_step_for(B, K, ngram, history.shape[1], n_steps)
        step.load(self._ids(slots), history, hist_len, cur, done, self._ids(max_total))
        step.run(n_steps)
        for dst, src in ((history, step.history), (hist_len, step.hist_len), (cur, step.cur),
                         (done, step.done)):
            dst.copy_(src)
        packed = torch.cat([step.emits.reshape(-1), step.keeps.reshape(-1),
                            step.done.to(torch.int32)])
        ph = self._to_host(packed).wait()
        emits = ph[:n_steps * B * K].reshape(n_steps, B, K).copy()
        keeps = ph[n_steps * B * K:n_steps * B * (K + 1)].reshape(n_steps, B).copy()
        return history, hist_len, cur, done, emits, keeps, ph[-B:].astype(bool)
