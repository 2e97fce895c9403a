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
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .executor.scheduler import ContinuousBatchingScheduler

_SENTINEL = object()


@dataclass
class _Stream:
    q: "queue.Queue" = field(default_factory=queue.Queue)
    finish_reason: Optional[str] = None
    tokens: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    ttft_s: Optional[float] = None  # submission to first token


class ServingFrontend:
    """Thread-safe streaming facade over one scheduler. The scheduler (and
    through it the engine) runs on one background thread; caller threads
    touch only the waiting queue (lock-guarded) and their own output
    queues."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, idle_sleep_s: float = 0.002):
        self.sched = scheduler
        self._lock = threading.Lock()
        self._streams: Dict[int, _Stream] = {}
        self._stop = threading.Event()
        self._idle_sleep_s = idle_sleep_s
        self._thread = threading.Thread(target=self._loop, name="llt-serve-loop", daemon=True)
        self._thread.start()

    # -- caller-thread API --------------------------------------------------
    def submit(self, tokens: Sequence[int], max_gen_len: int = 128, temperature: float = 0.6,
               top_p: float = 0.9, top_k: int = 0, pixel_values=None) -> int:
        with self._lock:
            rid = self.sched.submit(tokens, max_gen_len=max_gen_len, temperature=temperature,
                                    top_p=top_p, top_k=top_k, pixel_values=pixel_values)
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
        sched = self.sched
        while not self._stop.is_set():
            with self._lock:
                has = sched.has_work()
            if not has:
                time.sleep(self._idle_sleep_s)
                continue
            sched.step(self._on_tokens)
            done_now, sched.done = sched.done, []
            for r in done_now:
                st = self._ensure_stream(r.req_id)
                st.finish_reason = r.finish_reason
                st.logprobs = list(r.output_logprobs)
                if r.first_token_at is not None:
                    st.ttft_s = r.first_token_at - r.submitted_at
                st.q.put(_SENTINEL)
        # Wake blocked readers on shutdown.
        for st in list(self._streams.values()):
            st.q.put(_SENTINEL)


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          scheduler_kw: Optional[dict] = None):
    """Start an HTTP server and block; ``serve_background`` returns instead."""
    httpd, fe = serve_background(engine, host, port, scheduler_kw)
    try:
        httpd.serve_forever()
    finally:
        fe.shutdown()
    return httpd, fe


def serve_background(engine, host: str = "127.0.0.1", port: int = 0,
                     scheduler_kw: Optional[dict] = None):
    """Start the HTTP server on a daemon thread; returns (httpd, frontend).
    ``port=0`` picks a free port (``httpd.server_address[1]``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    fe = ServingFrontend(ContinuousBatchingScheduler(engine, **(scheduler_kw or {})))

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
