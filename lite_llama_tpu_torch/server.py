"""Streaming serving front end over the continuous-batching scheduler (port
of ``lite_llama_tpu/server.py``). Two layers:

- ``ServingFrontend``: thread-safe submit/stream API. One background thread
  drives ``ContinuousBatchingScheduler.step()``, so the device's work queue
  has one producer; any number of caller threads submit requests and read
  their own per-request token queues. Engine admission accounting is
  lock-guarded on its own (executor/engine.py ``_admission_lock``).
- ``serve()`` / ``serve_background()``: a stdlib ThreadingHTTPServer with

    POST /generate   {"tokens": [...], "max_gen_len": N, "temperature": T,
                      "top_p": P, "top_k": K, "stream": bool}

  Streaming responses are JSON lines ({"tokens": [...]} chunks, then
  {"done": true, "finish_reason": ...}); a non-streaming response is one
  JSON object. GET /health and GET /stats report liveness and engine
  counters.

The engine's methods each enter ``torch.inference_mode()`` themselves
(inference mode is per thread) and use the engine's explicit device, so the
scheduler runs the same on the background thread as on the main one.

On a mesh of more than one rank (``engine.shard.mesh``: tp, dp, cp, or
dp x tp; one process per rank) every rank makes the same ``serve(...)`` /
``serve_background(...)`` call. Rank 0 (the mesh's leader) binds HTTP; its
handler threads put requests into a lock-guarded outbox and read their own
streams, and only its scheduler thread runs collectives. Each loop turn,
idle turns too, that thread sends one ``ControlMessage`` (the outbox's
requests in submit order, whether to step, whether to stop) to every rank
over the mesh's control group, and the ranks agree on their accounting
digest before anyone steps (``parallel/distributed.py``). Every other rank
runs a ``MeshFollower``: no socket; it submits each message's requests to
its own scheduler and steps when told, so every rank makes the same engine
calls. ``shutdown()`` on rank 0 sends stop, and every rank's loop ends. A
loop that fails (a digest that differs, a collective that fails) wakes its
readers, and ``stream`` / ``result`` raise.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch.distributed

from .executor.scheduler import ContinuousBatchingScheduler
from .parallel import distributed

_SENTINEL = object()


@dataclass
class _Stream:
    q: "queue.Queue" = field(default_factory=queue.Queue)
    finish_reason: Optional[str] = None
    tokens: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    ttft_s: Optional[float] = None  # submission to first token


def _mesh_channel(engine) -> Optional["distributed.ControlChannel"]:
    """The control channel of an engine on a mesh of more than one rank."""
    mesh = engine.shard.mesh
    return distributed.ControlChannel(mesh) if mesh is not None and mesh.size > 1 else None


def _apply_submits(sched: ContinuousBatchingScheduler, submits) -> bool:
    """Submit a control message's requests in its order; returns whether
    each took the id rank 0 gave it (``ControlChannel.agree`` raises on
    every rank if not)."""
    same = True
    for q in submits:
        rid = sched.submit(q["prompt_tokens"], max_gen_len=q["max_gen_len"],
                           temperature=q["temperature"], top_p=q["top_p"], top_k=q["top_k"],
                           pixel_values=q["pixel_values"])
        same &= rid == q["rid"]
    return same


class ServingFrontend:
    """Thread-safe streaming facade over one scheduler. The scheduler (and
    through it the engine) runs on one background thread; caller threads
    touch only the waiting queue (lock-guarded; on a mesh, the outbox that
    the thread broadcasts) and their own output queues. On a mesh it runs
    on rank 0; the other ranks run a ``MeshFollower``."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, idle_sleep_s: float = 0.002):
        self.sched = scheduler
        self._channel = _mesh_channel(scheduler.engine)
        if self._channel is not None and not self._channel.is_leader:
            raise ValueError("on a mesh only rank 0 serves requests; the other ranks run a "
                             "MeshFollower (serve / serve_background start the right one)")
        self._lock = threading.RLock()
        self._streams: Dict[int, _Stream] = {}
        self._stop = threading.Event()
        self._idle_sleep_s = idle_sleep_s
        self._outbox: List[tuple] = []  # (request dict, submit time) of the next message
        self._next_rid = 0
        self.turns = 0  # control messages sent (on a mesh)
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name="llt-serve-loop", daemon=True)
        self._thread.start()

    # -- caller-thread API --------------------------------------------------
    def submit(self, tokens: Sequence[int], max_gen_len: int = 128, temperature: float = 0.6,
               top_p: float = 0.9, top_k: int = 0, pixel_values=None) -> int:
        with self._lock:
            if self._channel is None:
                rid = self.sched.submit(tokens, max_gen_len=max_gen_len,
                                        temperature=temperature, top_p=top_p, top_k=top_k,
                                        pixel_values=pixel_values)
            else:  # the scheduler thread submits it, with the message that carries it
                rid, self._next_rid = self._next_rid, self._next_rid + 1
                self._outbox.append((dict(
                    rid=rid, prompt_tokens=[int(t) for t in tokens], max_gen_len=max_gen_len,
                    temperature=temperature, top_p=top_p, top_k=top_k,
                    pixel_values=pixel_values), time.perf_counter()))
            # The scheduler thread may already have created the stream.
            self._streams.setdefault(rid, _Stream())
        return rid

    def _ensure_stream(self, rid: int) -> _Stream:
        st = self._streams.get(rid)
        if st is None:
            st = self._streams.setdefault(rid, _Stream())
        return st

    def stream(self, rid: int, timeout: float = 600.0):
        """Yield token-id lists as they arrive; returns on completion."""
        st = self._streams[rid]
        deadline = time.monotonic() + timeout
        while True:
            item = st.q.get(timeout=max(0.0, deadline - time.monotonic()))
            if item is _SENTINEL:
                if self.error is not None:
                    raise RuntimeError(f"the serving loop failed: {self.error!r}") from self.error
                return
            yield item

    def result(self, rid: int, timeout: float = 600.0) -> dict:
        """Block until the request finishes; returns its tokens, logprobs,
        finish_reason and time to first token (seconds from submission)."""
        for _ in self.stream(rid, timeout=timeout):
            pass
        st = self._streams.pop(rid)
        return {"req_id": rid, "tokens": st.tokens, "logprobs": st.logprobs,
                "finish_reason": st.finish_reason, "ttft_s": st.ttft_s}

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    # -- scheduler thread -----------------------------------------------------
    def _on_tokens(self, req, toks) -> None:
        st = self._ensure_stream(req.req_id)
        st.tokens.extend(int(t) for t in toks)
        st.q.put([int(t) for t in toks])

    def _loop(self) -> None:
        try:
            if self._channel is None:
                self._serve_alone()
            else:
                self._serve_mesh()
        except BaseException as e:  # the readers raise it (stream / result)
            self.error = e
        finally:
            # Wake blocked readers on shutdown.
            for st in list(self._streams.values()):
                st.q.put(_SENTINEL)

    def _serve_alone(self) -> None:
        sched = self.sched
        while not self._stop.is_set():
            with self._lock:
                has = sched.has_work()
            if not has:
                time.sleep(self._idle_sleep_s)
                continue
            sched.step(self._on_tokens)
            self._publish_done()

    def _serve_mesh(self) -> None:
        """Rank 0's turns: one control message each (module docstring)."""
        sched, channel = self.sched, self._channel
        while True:
            stop = self._stop.is_set()
            before = sched.digest()
            with self._lock:
                subs, self._outbox = self._outbox, []
            same = _apply_submits(sched, [q for q, _ in subs])
            for r, (_, t) in zip(list(sched.waiting)[len(sched.waiting) - len(subs):], subs):
                r.submitted_at = t  # when its handler took it, for ttft_s
            step = not stop and sched.has_work()
            channel.exchange(distributed.ControlMessage(
                submits=[q for q, _ in subs], step=step, stop=stop, digest=before))
            channel.agree(sched.digest(), same)
            self.turns += 1
            if stop:
                return
            if step:
                sched.step(self._on_tokens)
                self._publish_done()
            else:
                time.sleep(self._idle_sleep_s)

    def _publish_done(self) -> None:
        sched = self.sched
        done_now, sched.done = sched.done, []
        for r in done_now:
            st = self._ensure_stream(r.req_id)
            st.finish_reason = r.finish_reason
            st.logprobs = list(r.output_logprobs)
            if r.first_token_at is not None:
                st.ttft_s = r.first_token_at - r.submitted_at
            st.q.put(_SENTINEL)


class MeshFollower:
    """A follower rank's serving loop (every rank of a mesh but rank 0): no
    socket; each turn it receives rank 0's control message, submits its
    requests to this rank's scheduler in order, agrees on the accounting
    digest with every rank, and steps when told, until stop. ``run``
    blocks; ``start`` runs it on a thread and ``join`` waits for it (and
    raises what ended it)."""

    def __init__(self, scheduler: ContinuousBatchingScheduler):
        self.sched = scheduler
        self._channel = _mesh_channel(scheduler.engine)
        if self._channel is None or self._channel.is_leader:
            raise ValueError("a MeshFollower runs on a rank of a mesh other than rank 0")
        self.turns = self.steps = 0
        self.error: Optional[BaseException] = None
        self._thread = None

    def _apply(self, submits) -> bool:
        return _apply_submits(self.sched, submits)

    def run(self) -> "MeshFollower":
        sched, channel = self.sched, self._channel
        while True:
            before = sched.digest()
            msg = channel.exchange()
            same = self._apply(msg.submits)
            channel.agree(sched.digest(), same and before == msg.digest)
            self.turns += 1
            if msg.stop:
                return self
            if msg.step:
                sched.step()
                sched.done = []  # rank 0 reports the requests
                self.steps += 1

    def start(self) -> "MeshFollower":
        def body():
            try:
                self.run()
            except BaseException as e:  # join raises it
                self.error = e

        self._thread = threading.Thread(target=body, name="llt-serve-follower", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> "MeshFollower":
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError("the follower's serving loop is still running")
        if self.error is not None:
            raise self.error
        return self


def _follows(engine) -> bool:
    """Whether this process is a follower rank of the engine's mesh."""
    mesh = engine.shard.mesh
    return mesh is not None and mesh.size > 1 and torch.distributed.get_rank() != mesh.leader


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          scheduler_kw: Optional[dict] = None):
    """Start an HTTP server and block; ``serve_background`` returns instead.
    On a mesh's follower rank: run its ``MeshFollower`` until rank 0 stops
    it, and return (None, follower)."""
    if _follows(engine):
        sched = ContinuousBatchingScheduler(engine, **(scheduler_kw or {}))
        return None, MeshFollower(sched).run()
    httpd, fe = serve_background(engine, host, port, scheduler_kw)
    try:
        httpd.serve_forever()
    finally:
        fe.shutdown()
    return httpd, fe


def serve_background(engine, host: str = "127.0.0.1", port: int = 0,
                     scheduler_kw: Optional[dict] = None):
    """Start the HTTP server on a daemon thread; returns (httpd, frontend).
    ``port=0`` picks a free port (``httpd.server_address[1]``). On a mesh's
    follower rank: start its ``MeshFollower`` on a thread and return (None,
    follower), with no socket."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    sched = ContinuousBatchingScheduler(engine, **(scheduler_kw or {}))
    if _follows(engine):
        return None, MeshFollower(sched).start()
    fe = ServingFrontend(sched)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send_json({"status": "ok"})
            elif self.path == "/stats":
                st = engine.stats
                self._send_json({
                    "prefill_tokens": st.prefill_tokens,
                    "decode_tokens": st.decode_tokens,
                    "chunks": st.chunks,
                    "prefix_hits": st.prefix_hits,
                    "running": len(fe.sched.running),
                    "waiting": len(fe.sched.waiting),
                })
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                tokens = [int(t) for t in req["tokens"]]
                kw = dict(max_gen_len=int(req.get("max_gen_len", 128)),
                          temperature=float(req.get("temperature", 0.6)),
                          top_p=float(req.get("top_p", 0.9)),
                          top_k=int(req.get("top_k", 0)))
            except (ValueError, KeyError, TypeError) as e:
                self.send_error(400, str(e))
                return
            rid = fe.submit(tokens, **kw)
            if not req.get("stream"):
                self._send_json(fe.result(rid))
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonl")
            self.end_headers()
            for toks in fe.stream(rid):
                self.wfile.write((json.dumps({"tokens": toks}) + "\n").encode())
                self.wfile.flush()
            st = fe._streams.pop(rid)
            self.wfile.write((json.dumps({"done": True, "finish_reason": st.finish_reason})
                              + "\n").encode())

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, fe
