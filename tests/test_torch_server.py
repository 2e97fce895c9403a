"""The port's serving front end on the CPU (``device="cpu"``): concurrent
submission from more threads than slots while the scheduler thread drives
the engine, and the HTTP generate / stream / stats API on loopback (the
cases of tests/test_server.py). Greedy outputs equal the port's isolated
batch generation, and the engine's accounting drains to full capacity."""

import http.client
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lite_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.server import ServingFrontend, serve_background  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import numpy_params  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=97, max_seq_len=32, eos_token_id=96)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_engine(max_reqs=4, num_pages=48):
    cfg = LlamaConfig(dtype=torch.float32, **CFG)
    params = params_from_numpy(numpy_params(cfg, seed=41), cfg, device="cpu")
    return InferenceEngine(cfg, params, device="cpu", page_size=4, max_reqs=max_reqs,
                           num_pages=num_pages, decode_chunk=4)


def _drained(engine):
    assert len(engine._free_slots) == engine.max_reqs
    assert engine._host_free_pages == engine.num_pages == int(engine.cache.free_top)


def test_concurrent_submit_stress():
    """Six threads (more than the four slots) submit at once under a short
    switch interval: every request completes with its isolated greedy
    output, and the slot/page accounting drains exactly."""
    engine = make_engine()
    fe = ServingFrontend(ContinuousBatchingScheduler(engine, max_prefill_batch=2))
    rng = np.random.default_rng(0)
    prompts = {(t, j): rng.integers(0, 96, size=2 + (t + j) % 4).tolist()
               for t in range(6) for j in range(3)}
    results, errs = {}, []

    def client(tid):
        try:
            for j in range(3):
                rid = fe.submit(prompts[(tid, j)], max_gen_len=5, temperature=0.0)
                results[(tid, j)] = fe.result(rid, timeout=300)
        except Exception as e:  # reported by the assertion below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        fe.shutdown()
    assert not fe._thread.is_alive()
    assert not errs, errs
    assert len(results) == 18
    gen = TextGenerator(engine)
    for key, r in results.items():
        want = gen.generate_tokens([prompts[key]], max_gen_len=5, temperature=0.0)[0]
        assert r["tokens"] == want.token_ids, key
        assert len(r["logprobs"]) == len(r["tokens"])
        assert all(np.isfinite(r["logprobs"])) and r["ttft_s"] >= 0
        assert r["finish_reason"] == want.finish_reason
    _drained(engine)


def test_http_generate_and_stream():
    engine = make_engine()
    httpd, fe = serve_background(engine, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read())["status"] == "ok"
        conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [1, 2, 3], "max_gen_len": 5, "temperature": 0.0}),
            headers={"Content-Type": "application/json"})
        out = json.loads(conn.getresponse().read())
        assert 1 <= len(out["tokens"]) <= 5
        assert out["finish_reason"] in ("stop", "length")
        want = TextGenerator(make_engine()).generate_tokens([[4, 5]], max_gen_len=4,
                                                            temperature=0.0)[0].token_ids
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [4, 5], "max_gen_len": 4, "temperature": 0.0, "stream": True}))
        lines = [json.loads(x) for x in conn.getresponse().read().decode().splitlines()]
        assert lines[-1]["done"] is True
        assert [t for x in lines[:-1] for t in x["tokens"]] == want
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("POST", "/generate", body=b"{not json")
        assert conn.getresponse().status == 400
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["prefill_tokens"] > 0 and stats["decode_tokens"] >= 0
    finally:
        httpd.shutdown()
        fe.shutdown()
    _drained(engine)
