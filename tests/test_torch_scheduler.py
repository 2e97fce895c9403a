"""The port's continuous-batching scheduler on the CPU: the cases of
tests/test_scheduler.py, with every request's greedy output identical to
the JAX scheduler's on the same numpy fp32 weights (a request's greedy
output does not depend on what it is batched with, so one JAX run over all
the requests is the reference for every case)."""

import unittest.mock as mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.executor.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler as JScheduler,
)
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.utils.profiling import steady_state_tps  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=97, max_seq_len=32, eos_token_id=96)
_rng = np.random.default_rng(0)
MANY = [(_rng.integers(0, 96, size=_rng.integers(2, 6)).tolist(), 6) for _ in range(10)]
ISOLATED = [(p, 7) for p in ([1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [10, 20], [30], [4, 2])]
REUSE = list(zip([[7, 8, 9], [3, 4], [11, 12, 13], [5], [2, 9], [14, 3, 1]], [3, 9, 5, 7, 4, 6]))
REBUILD = [([1 + i, 2, 3], 4 + i % 3) for i in range(7)]
LOG = [([1 + i, 2, 3], 8) for i in range(5)]
SMALL = [([3, 1, 4, 1, 5], 5), ([1, 2, 3], 8), ([1, 2, 3], 6), ([1, 2, 3], 4)]
ALL = MANY + ISOLATED + REUSE + REBUILD + LOG + SMALL


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg = JLlama(dtype=jnp.float32, **CFG)
    tcfg = TLlama(dtype=torch.float32, **CFG)
    npp = numpy_params(jcfg, seed=31)
    return jcfg, _jax_tree(npp), tcfg, params_from_numpy(npp, tcfg, device="cpu")


@pytest.fixture(scope="module")
def jax_outputs(weights):
    """{(prompt, max_gen_len): greedy tokens} from one JAX scheduler run."""
    jcfg, jp, _, _ = weights
    eng = JEngine(jcfg, jp, page_size=4, max_reqs=8, num_pages=64, decode_chunk=4)
    sched = JScheduler(eng, max_prefill_batch=4)
    keys = sorted({(tuple(p), g) for p, g in ALL})
    ids = {sched.submit(list(p), max_gen_len=g, temperature=0.0): (p, g) for p, g in keys}
    return {ids[r.req_id]: r.output_tokens for r in sched.run()}


def make_engine(weights, max_reqs=4, num_pages=32):
    _, _, tcfg, tp = weights
    return InferenceEngine(tcfg, tp, device="cpu", page_size=4, max_reqs=max_reqs,
                           num_pages=num_pages, decode_chunk=4)


def _run_greedy(sched, reqs):
    ids = [sched.submit(p, max_gen_len=g, temperature=0.0) for p, g in reqs]
    results = {r.req_id: r for r in sched.run()}
    return [results[i] for i in ids]


def _drained(engine):
    assert len(engine._free_slots) == engine.max_reqs
    assert engine._host_free_pages == engine.num_pages == int(engine.cache.free_top)


def test_more_requests_than_slots_all_complete(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=4, num_pages=32)
    got = _run_greedy(ContinuousBatchingScheduler(engine, max_prefill_batch=2), MANY)
    for r, (p, g) in zip(got, MANY):
        assert r.state == "done" and 1 <= len(r.output_tokens) <= g
        assert r.output_tokens == jax_outputs[(tuple(p), g)]
    _drained(engine)


def test_scheduler_greedy_matches_isolated_and_jax(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=4, num_pages=48)
    got = _run_greedy(ContinuousBatchingScheduler(engine, max_prefill_batch=3), ISOLATED)
    for r, (p, g) in zip(got, ISOLATED):
        want = TextGenerator(make_engine(weights, num_pages=48)).generate_tokens(
            [p], max_gen_len=g, temperature=0.0)[0].token_ids
        assert r.output_tokens == want == jax_outputs[(tuple(p), g)], p


def test_streaming_callback(weights, jax_outputs):
    sched = ContinuousBatchingScheduler(make_engine(weights))
    rid = sched.submit([3, 1, 4, 1, 5], max_gen_len=5, temperature=0.0)
    streamed = []
    results = sched.run(on_tokens=lambda r, toks: streamed.extend(toks))
    full = {r.req_id: r for r in results}[rid].output_tokens
    # Every output token streams, the prefill-sampled first one included.
    assert full == streamed == jax_outputs[((3, 1, 4, 1, 5), 5)]


def test_admission_respects_capacity(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=4, num_pages=12)  # tight pool
    got = _run_greedy(ContinuousBatchingScheduler(engine), [([1, 2, 3], 8)] * 6)
    assert len(got) == 6
    assert all(r.output_tokens == jax_outputs[((1, 2, 3), 8)] for r in got)
    _drained(engine)


def test_decode_session_reuploads_only_on_membership_change(weights):
    engine = make_engine(weights, max_reqs=4, num_pages=32)
    sched = ContinuousBatchingScheduler(engine)
    for _ in range(2):
        sched.submit([1, 2, 3], max_gen_len=25, temperature=0.6, top_p=0.9)
    with mock.patch.object(engine, "start_decode_session",
                           side_effect=engine.start_decode_session) as spy:
        for _ in range(4):
            sched.step()
        assert spy.call_count == 1, spy.call_count
        while sched.has_work():
            sched.step()
    sched._drain()
    assert len(sched.done) == 2
    assert all(len(r.output_tokens) >= 1 for r in sched.done)
    assert all(0 <= t < CFG["vocab_size"] for r in sched.done for t in r.output_tokens)


def test_admit_every_batches_admissions(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=2, num_pages=32)
    sched = ContinuousBatchingScheduler(engine, admit_every=3, max_prefill_batch=2)
    with mock.patch.object(engine, "prefill_async", side_effect=engine.prefill_async) as spy:
        got = _run_greedy(sched, [([1, 2, 3], 6)] * 6)
    assert all(r.output_tokens == jax_outputs[((1, 2, 3), 6)] for r in got)
    # 6 requests, 2 slots, batches of <= 2: at least 3 prefills, and fewer
    # than one per request.
    assert 3 <= spy.call_count < 6, spy.call_count


def test_impossible_requests_rejected_not_spun(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=2, num_pages=8)
    sched = ContinuousBatchingScheduler(engine)
    too_long = sched.submit(list(range(40)), max_gen_len=4)  # > max_seq_len (32)
    image = sched.submit([1, 2, 3], max_gen_len=4, pixel_values=np.zeros((3, 8, 8)))
    ok = sched.submit([1, 2, 3], max_gen_len=4, temperature=0.0)
    results = {r.req_id: r for r in sched.run()}
    assert results[too_long].finish_reason == "rejected_too_long"
    assert results[too_long].output_tokens == []
    assert results[image].finish_reason == "rejected_multimodal_unsupported"
    assert results[ok].output_tokens == jax_outputs[((1, 2, 3), 4)]


def test_session_never_rebuilt_across_admissions(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=2, num_pages=32)
    sched = ContinuousBatchingScheduler(engine, max_prefill_batch=2)
    with mock.patch.object(engine, "start_decode_session",
                           side_effect=engine.start_decode_session) as build_spy, \
            mock.patch.object(engine, "update_session_rows",
                              side_effect=engine.update_session_rows) as splice_spy:
        got = _run_greedy(sched, REBUILD)
    assert build_spy.call_count == 1, build_spy.call_count
    assert splice_spy.call_count >= 4, splice_spy.call_count  # 7 requests, 2 slots
    for r, (p, g) in zip(got, REBUILD):
        assert r.output_tokens == jax_outputs[(tuple(p), g)]


def test_slot_reuse_no_output_leak(weights, jax_outputs):
    """Chunk results apply through the snapshot taken at dispatch: a slot
    freed and re-admitted at once never receives the stale chunk's tokens."""
    engine = make_engine(weights, max_reqs=2, num_pages=32)
    got = _run_greedy(ContinuousBatchingScheduler(engine, max_prefill_batch=2), REUSE)
    for r, (p, g) in zip(got, REUSE):
        want = TextGenerator(engine).generate_tokens([p], max_gen_len=g,
                                                     temperature=0.0)[0].token_ids
        assert r.output_tokens == want == jax_outputs[(tuple(p), g)], p
    _drained(engine)


def test_chunk_log_and_steady_state_accounting(weights, jax_outputs):
    engine = make_engine(weights, max_reqs=2, num_pages=32)
    sched = ContinuousBatchingScheduler(engine, max_prefill_batch=2)
    got = _run_greedy(sched, LOG)
    for r, (p, g) in zip(got, LOG):
        assert r.output_tokens == jax_outputs[(tuple(p), g)]
    log = sched.chunk_log
    assert log and all({"t", "occupancy", "tokens", "steps"} <= set(c) for c in log)
    assert sum(c["tokens"] for c in log) > 0
    assert max(c["occupancy"] for c in log) == 2  # both slots were live at some point

    # Synthetic log: exact arithmetic of the steady window.
    synth = [
        {"t": 0.0, "occupancy": 1, "tokens": 4, "steps": 4},  # ramp (no predecessor)
        {"t": 1.0, "occupancy": 2, "tokens": 8, "steps": 4},  # steady: 8 tok / 1 s
        {"t": 2.0, "occupancy": 2, "tokens": 8, "steps": 4},  # steady: 8 tok / 1 s
        {"t": 4.0, "occupancy": 1, "tokens": 4, "steps": 4},  # drain: 4 tok / 2 s
    ]
    s = steady_state_tps(synth, full_occupancy=2)
    assert s["steady_tokens_per_s"] == 8.0
    assert s["steady_window_s"] == 2.0
    assert s["steady_chunks"] == 2 and s["total_chunks"] == 3
    # 20 tokens / (2*1 + 2*1 + 1*2 = 6 slot-s) * 2 slots
    assert abs(s["occupancy_weighted_tokens_per_s"] - 20 / 6 * 2) < 0.05
    assert s["mean_occupancy"] == 1.5
    assert steady_state_tps(synth[:1], full_occupancy=2) is None
