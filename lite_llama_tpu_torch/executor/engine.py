"""InferenceEngine: the executor facade, for one device (port of
``lite_llama_tpu/executor/engine.py``).

Owns the parameters, the paged KV cache, the host-side admission accounting
and the prefix cache, and runs prefill and decode:

- prefill (``prefill_async`` / ``prefill_collect``): prompts up to
  ``prefill_chunk`` with no prefix-cache hit go as one padded [B, S_max]
  batch through ``decoder_prefill`` with ``last_only`` (K2 on the card).
  Longer prompts and prefix-cache hits go chunk by chunk through the
  paged-history path (``_prefill_chunk_step``, K5), each request starting
  after its cached pages. The first token is sampled on the device, and the
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
- prefix cache: a host-side registry of page-aligned prompt prefixes whose
  KV pages stay in the pool after their request ends (``PrefixCache``); a
  later prompt that starts with one splices those pages into its table and
  computes only the rest.
- a host-side capacity guard refuses admission when the page pool could be
  exhausted (the device-side allocator is masked arithmetic and cannot
  raise).

The JAX engine pads batch and prompt widths to buckets to bound XLA
recompiles and lays batches out in data-parallel groups. PyTorch compiles
nothing per shape and the port has one device, so every batch runs at its
own width in caller order (no sentinel rows, no group layout).

Quantized weights (``quant/qtensor.py``) and int8 / fp8 KV pools
(``kv_quant``) run through the same paths; packed int4 wq/wkv are fused into
one wqkv at build time, as the JAX engine does.

Not ported yet, and refused: speculative decoding and data parallelism.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import BaseConfig
from ..generation.sampling import SamplingParams, log_softmax_gather, needs_exact_sampling, sample
from ..models.decoder import AttnContext, decoder_decode, decoder_prefill, fuse_qkv_params
from ..ops import add_launches, launch_counts
from ..quant.qtensor import QTensor
from .kv_cache import (
    alloc_decode,
    alloc_prefill,
    cdiv,
    create_kv_cache,
    free_requests,
    kv_cache_bytes,
    push_pages,
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


class DecodeStep:
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
        self.engine, self.mode = engine, mode
        self.req_ids = torch.zeros(width, **i32)
        self.tok = torch.zeros(width, **i32)
        self.done = torch.ones(width, dtype=torch.bool, device=dev)
        self.stop = torch.zeros(width, **i32)
        self.samp = SamplingParams(torch.zeros(width, **f32), torch.ones(width, **f32),
                                   torch.zeros(width, **i32))
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.toks = torch.zeros((engine.decode_chunk, width), **i32)
        self.lps = torch.zeros((engine.decode_chunk, width), **f32)
        self.graph = None
        self.capture_ms = None
        self.launches = {}  # kernel launches a replay makes, by launch counter

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
        logits, _ = decoder_decode(e.params, e.config, cache.kv_pages, ctx, self.tok.long())
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

    def capture(self, pool, stream: torch.cuda.Stream) -> None:
        """Record the body as a CUDA graph (:func:`capture_graph`). Its
        warm-up runs with every row done (the buffers' initial state), so it
        allocates no page and changes no length or KV row."""
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
    """Owns params + paged KV cache for one model on one device."""

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
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch path"
            )
        emb = params["embed"]
        if emb.dtype != config.dtype:
            raise ValueError(
                f"params dtype {emb.dtype} != config.dtype {config.dtype}: cast the "
                "weights or the config (activations follow config.dtype)"
            )
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine on {self.device}")
        wq = params["layers"].get("wq")
        if isinstance(wq, QTensor) and wq.packed:
            # One packed matmul per layer instead of two, as the JAX engine
            # fuses by default on one device.
            params = fuse_qkv_params(params)
        self.config = config
        self.params = params
        self.kv_quant = kv_quant
        self.page_size = page_size
        self.max_reqs = max_reqs
        self.decode_chunk = decode_chunk
        self.prefill_chunk = prefill_chunk
        if num_pages is None:
            num_pages = self._auto_num_pages(hbm_util)
        self.num_pages = num_pages
        self.cache = create_kv_cache(
            config.num_hidden_layers, config.num_key_value_heads, config.head_dim,
            num_pages=num_pages, page_size=page_size, max_reqs=max_reqs,
            max_seq_len=config.max_seq_len, dtype=config.dtype, device=self.device,
            quantized=kv_quant,
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._free_slots = list(range(max_reqs))
        self._host_free_pages = num_pages
        self.stats = EngineStats()
        self.prefix = PrefixCache() if prefix_cache else None
        self._slot_prefix = {}  # slot -> (key, n_pages, page_ids) of its prefix hit
        self._slot_prompt = {}  # slot -> prompt tokens (registered on release)
        # Slots that actually ran prefill: only these may donate pages on
        # release (a rolled-back admission's table rows are zeros or stale).
        self._slot_filled = set()
        self.pad_id = config.pad_token_id if config.pad_token_id is not None else 0
        # Decode steps by (session width, sampling mode); on the card each is
        # a captured graph, all in one memory pool, captured on one stream.
        self._steps = {}
        self._graph_pool = None
        self._graph_stream = None
        self._eos_list = None
        self.set_eos(config.eos_token_ids)
        # Host-side slot/page/prefix accounting is guarded by one lock so
        # concurrent submitters can admit and release safely.
        self._admission_lock = threading.RLock()

    def set_eos(self, eos_ids: Sequence[int]) -> None:
        """Token ids that end a request during decode. The decode steps read
        the id tensor, so new ids drop them (once the device has finished
        with them); the next chunk builds them again."""
        ids = [int(t) for t in eos_ids] or [-1]
        if ids == self._eos_list:
            return
        if self._steps and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._steps.clear()
        self._eos_list = ids
        self.eos_ids = [t for t in ids if t >= 0]
        self._eos = torch.tensor(ids, dtype=torch.int32, device=self.device)

    # -- host capacity accounting -----------------------------------------
    def admit_feasible(self, total_len: int) -> bool:
        """Could a request of ``total_len`` tokens EVER be admitted (with an
        idle engine)? False means waiting is pointless."""
        return (
            0 < total_len <= self.config.max_seq_len
            and cdiv(total_len, self.page_size) <= self.num_pages
        )

    def try_admit(self, total_len: int, prompt_tokens=None):
        """Reserve a slot and the pages for ``total_len`` tokens beyond any
        cached prefix of ``prompt_tokens``; returns the slot, or None when
        either is short even after evicting unreferenced prefix entries. A
        hit takes a reference on its entry and records the splice for
        prefill."""
        with self._admission_lock:
            total_pages = cdiv(total_len, self.page_size)
            hit = None
            if self.prefix is not None and prompt_tokens is not None:
                keys = PrefixCache.chain_keys(prompt_tokens, self.page_size)
                # Never reuse the whole prompt: its last token is recomputed
                # so that the logits for the first output token exist.
                max_use = (len(prompt_tokens) - 1) // self.page_size
                h = self.prefix.lookup(keys)
                if h is not None and min(h[1], max_use) > 0:
                    k_use = min(h[1], max_use)
                    hit = (h[0], k_use, h[2][:k_use])
            if not self._free_slots:
                return None
            need = total_pages - (hit[1] if hit else 0)
            protect = hit[0] if hit else None
            evictable = (sum(n for key, n in self.prefix.evictable() if key != protect)
                         if self.prefix is not None else 0)
            if self._host_free_pages + evictable < need:
                return None
            if self._host_free_pages < need:
                self._evict_for(need, protect)
            if self._host_free_pages < need:
                return None  # fail closed rather than oversubscribe
            self._host_free_pages -= need
            slot = self._free_slots.pop(0)
            if hit:
                key, k_use, pages = hit
                self.prefix.acquire(key)
                self._slot_prefix[slot] = hit
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_reused += k_use * self.page_size
            if self.prefix is not None and prompt_tokens is not None:
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
                        f"placed (free pages: {self._host_free_pages}, free slots: "
                        f"{len(self._free_slots)})"
                    )
                slots.append(s)
            return slots

    def _evict_for(self, need: int, protect=None) -> None:
        """Evict unreferenced prefix entries, least recently used first,
        until ``need`` pages are free or nothing evictable remains.
        ``protect`` shields the entry the caller is about to splice in."""
        for key, _ in self.prefix.evictable():
            if self._host_free_pages >= need:
                return
            if key == protect:
                continue
            pages = self.prefix.pop(key)
            with torch.inference_mode():
                push_pages(self.cache, self._ids(pages),
                           torch.ones(len(pages), dtype=torch.bool, device=self.device))
            self._host_free_pages += len(pages)

    @torch.inference_mode()
    def release_slots(self, slots: Sequence[int], lens: Sequence[int]):
        """Free finished requests' slots and pages. With the prefix cache, a
        request that hit keeps its shared pages (they belong to the entry;
        its reference is dropped), and one that prefilled without a hit
        donates its prompt's full pages as a new entry."""
        with self._admission_lock:
            if not slots:
                return
            keep = [0] * len(slots)
            returned = [cdiv(n, self.page_size) for n in lens]
            if self.prefix is not None:
                table_host = None
                for i, s in enumerate(slots):
                    used = self._slot_prefix.pop(s, None)
                    prompt = self._slot_prompt.pop(s, None)
                    filled = s in self._slot_filled
                    self._slot_filled.discard(s)
                    if used is not None:
                        key, n_pages, _ = used
                        self.prefix.release(key)
                        keep[i] = n_pages
                        returned[i] -= n_pages
                    elif filled and prompt is not None and len(prompt) >= self.page_size:
                        keys = PrefixCache.chain_keys(prompt, self.page_size)
                        if keys[-1] not in self.prefix.entries:
                            if table_host is None:
                                table_host = self.cache.page_table.cpu().numpy()
                            self.prefix.register(keys[-1], table_host[s, :len(keys)].tolist())
                            keep[i] = len(keys)
                            returned[i] -= len(keys)
            free_requests(self.cache, self._ids(slots), self._ids(keep))
            for s, n in zip(slots, returned):
                self._host_free_pages += n
                self._free_slots.append(s)

    def _auto_num_pages(self, hbm_util: float) -> int:
        """Size the KV pool from free device memory. On the CPU (tests) there
        is no device budget: the pool holds every slot at max_seq_len. A page
        counts ``cfg.dtype`` bytes whatever the pool's type, as in the JAX
        engine, so admission decisions stay equal."""
        cfg = self.config
        want = self.max_reqs * cdiv(cfg.max_seq_len, self.page_size)
        if self.device.type != "cuda":
            return want
        per_page = kv_cache_bytes(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 1,
            self.page_size, cfg.dtype,
        )
        free, total = torch.cuda.mem_get_info(self.device)
        budget = total * hbm_util - (total - free)
        fit = int(budget // per_page)
        return max(64, min(want, fit))

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
            self.params, self.config, self.cache.kv_pages, ctx, ids, last_only=True
        )
        tok = sample(last, self._gen, sampling, mode=mode)
        return tok, last, log_softmax_gather(last, tok)

    def _prefill_chunk_step(self, ids_chunk, lens, start, table, last_logits, hist_bound):
        """One chunk of long or prefix-cached prompts: positions
        [start[b], start[b] + W) of every request, with ``start[b]`` tokens
        already in the pool (``lens`` and ``start`` are host arrays; requests
        already fully consumed run with an empty chunk). Carries the running
        last-position logits, so sampling happens once after the last
        chunk."""
        W = ids_chunk.shape[1]
        ctx = AttnContext(
            table_rows=table,
            seq_lens=self._ids(lens),
            start_pos=self._ids(np.minimum(lens, start)),  # history per request
            chunk_lens=self._ids(np.clip(lens - start, 0, W)),
        )
        logits, _ = decoder_prefill(
            self.params, self.config, self.cache.kv_pages, ctx, ids_chunk, last_only=True,
            chunked=True, hist_bound=hist_bound,
        )
        ends_here = self._ids((lens > start) & (lens <= start + W), torch.bool)
        return torch.where(ends_here[:, None], logits, last_logits)

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
        tokens)."""
        B = len(token_lists)
        lens = np.asarray([len(t) for t in token_lists], np.int32)
        if int(lens.max()) > self.config.max_seq_len:
            raise ValueError(f"prompt of {int(lens.max())} tokens exceeds max_seq_len="
                             f"{self.config.max_seq_len}")
        mode = self._samp_mode(sampling)
        samp = self._dev_sampling(sampling)
        req_ids = self._ids(slots)
        ps = self.page_size
        ppr = self.cache.pages_per_req
        # Prefix-cache splice info (slot state set by try_admit).
        cached = np.zeros((B,), np.int32)  # cached tokens per request
        prefix_rows = np.zeros((B, ppr), np.int32)
        prefix_pages = np.zeros((B,), np.int32)
        for i, s in enumerate(slots):
            hit = self._slot_prefix.get(s)
            if hit is not None:
                _, n_use, pages = hit
                cached[i] = n_use * ps
                prefix_pages[i] = n_use
                prefix_rows[i, :n_use] = pages

        if lens.max() > self.prefill_chunk or cached.any():
            # Chunked path: chunks of W tokens through the paged-history
            # attention, each request starting after its cached pages.
            resid = lens - cached
            W = min(self.prefill_chunk, max(int(resid.max()), 1))
            n_chunks = cdiv(int(resid.max()), W)
            ids = np.full((B, n_chunks * W), self.pad_id, np.int32)
            for i, t in enumerate(token_lists):
                ids[i, : len(t) - cached[i]] = t[cached[i]:]
            alloc_prefill(self.cache, req_ids, self._ids(lens), self._ids(prefix_rows),
                          self._ids(prefix_pages))
            table = self.cache.page_table[req_ids.long()]
            ids_d = self._ids(ids, torch.long)
            last = torch.zeros((B, self.config.vocab_size), dtype=torch.float32,
                               device=self.device)
            for ci in range(n_chunks):
                # No request has more pool history than this chunk's bound:
                # the plain CPU form gathers only that much.
                hist_tok = min(int(cached.max()) + ci * W, int(lens.max()))
                hist_bound = min(cdiv(hist_tok, ps), ppr) * ps
                last = self._prefill_chunk_step(ids_d[:, ci * W:(ci + 1) * W], lens,
                                                cached + ci * W, table, last, hist_bound)
            tok = sample(last, self._gen, samp, mode=mode)
            lp = log_softmax_gather(last, tok)
            self.stats.prefill_tokens += int(resid.sum())
        else:
            ids = np.full((B, int(lens.max())), self.pad_id, np.int32)
            for i, t in enumerate(token_lists):
                ids[i, : len(t)] = t
            tok, last, lp = self._prefill_step(self._ids(ids, torch.long), self._ids(lens),
                                               req_ids, samp, mode)
            self.stats.prefill_tokens += int(lens.sum())
        self._slot_filled.update(slots)
        packed = torch.stack([tok.to(torch.int32), lp.float().view(torch.int32)])
        return _PrefillBundle(packed=self._to_host(packed), tok_dev=tok, lens=lens,
                              last=last if return_logits else None)

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
        done tensors (chunks update them in place)."""
        return DecodeSession(
            slots=tuple(slots),
            req_ids=self._ids(slots),
            tok=self._ids(tok).clone(),
            done=self._ids(done, torch.bool).clone(),
            stop=self._ids(stop_lens),
            samp=self._dev_sampling(sampling),
            mode=self._samp_mode(sampling),
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
        scatter rows."""
        rows = np.asarray(rows, np.int64)
        keep = rows < self.max_reqs
        if not keep.any():
            return
        r = self._ids(rows[keep], torch.long)
        newtok = bundle.tok_dev[self._ids(np.flatnonzero(keep), torch.long)]
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
        self.stats.chunks += 1
        return _ChunkBundle(packed=self._to_host(packed), n=n)

    @torch.inference_mode()
    def decode_step_for(self, width: int, mode: str) -> DecodeStep:
        """The decode step of a session width and sampling mode, made at
        first use; on the card it is captured then (a serving caller may
        call this before its traffic, so that no request waits for it)."""
        key = (width, mode)
        step = self._steps.get(key)
        if step is None:
            step = DecodeStep(self, width, mode)
            if self.device.type == "cuda":
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                    self._graph_stream = torch.cuda.Stream(self.device)
                step.capture(self._graph_pool, self._graph_stream)
            self._steps[key] = step
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
        B = len(s.slots)
        if n_steps <= 0:  # degenerate budget: report state, emit nothing
            return (np.zeros((0, B), np.int32), np.zeros((0, B), np.float32),
                    s.done.cpu().numpy())
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
        toks, lps, _ = self.decode_session(s, n_steps)
        return s.tok, s.done, toks, lps
