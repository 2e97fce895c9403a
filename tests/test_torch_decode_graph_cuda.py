"""The engine's decode step as a replayed CUDA graph, on the card: chunks
replayed from the captured step equal the same step run eagerly, bit for
bit, on a bf16 pool, on an int8 pool with int4 weights (K6 fed K3 / K4's
int8 rows) and on an fp8 pool; each session width captures a graph of its
own; rows spliced into a resident session between chunks reach the next
replay; a released and re-admitted slot reads no stale pages; sampled
replays draw fresh numbers from the engine's generator and follow the
sampler's distribution, through ``capture_graph`` alone and through the
engine's own sampled step; each replay counts the kernel launches it makes.
The eager reference is an engine built alike whose decode step is never
captured (``tests/torch_decode_steps.py`` ``eager_step``). This file
imports no JAX, so it runs on a machine with a card and without JAX:

    python -m pytest --noconftest tests/test_torch_decode_graph_cuda.py
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lite_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from lite_llama_tpu_torch.executor import engine as engine_mod  # noqa: E402
from lite_llama_tpu_torch.executor.engine import (  # noqa: E402
    DecodeStep,
    InferenceEngine,
    capture_graph,
)
from lite_llama_tpu_torch.generation import sampling as tsamp  # noqa: E402
from lite_llama_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from lite_llama_tpu_torch.ops import attention_decode  # noqa: E402
from lite_llama_tpu_torch.quant.qtensor import quantize_decoder_params  # noqa: E402
from tests.torch_decode_steps import eager_step  # noqa: E402

# D 64, G 2; every int4 projection and the tied head at a width K6 takes.
CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=512, max_seq_len=256, eos_token_id=511)
ENGINE = dict(page_size=16, max_reqs=8, num_pages=96, decode_chunk=8)
PROMPTS = [[1, 2, 3, 4, 5], list(range(10, 47)), [7, 8, 9]]
POOLS = {"bf16": ("bf16", False), "int4 + int8 pool": ("int4", "int8"),
         "bf16 + fp8 pool": ("bf16", "fp8")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode graph is captured on the card only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(dev, weights="bf16"):
    cfg = LlamaConfig(dtype=torch.bfloat16, **CFG)
    params = init_decoder_params(cfg, torch.Generator(device=dev).manual_seed(0), scale=0.05)
    if weights == "int4":
        params = quantize_decoder_params(params, "int4", group_size=64, riffle=True)
    return cfg, params


def _engine(dev, cfg, params, **kw):
    return InferenceEngine(cfg, params, device=dev, **dict(ENGINE, **kw))


def _chunks(eng, prompts, totals, schedule, **samp):
    """Admit and prefill ``prompts`` (greedy), then decode one session chunk
    by chunk with the sampling knobs ``samp`` (greedy by default); returns
    the first tokens and each chunk's (tokens, logprob bits, done).
    Released at the end."""
    slots = eng.admit_requests(totals)
    try:
        greedy = tsamp.SamplingParams.make(len(prompts), temperature=0.0, device="cpu")
        first, lens, _, _ = eng.prefill(prompts, greedy, slots)
        done = np.asarray([n + 1 >= t for n, t in zip(lens, totals)])
        sampling = tsamp.SamplingParams.make(len(prompts), **{"temperature": 0.0, **samp},
                                             device="cpu")
        s = eng.start_decode_session(slots, first, done, totals, sampling)
        out = []
        for n in schedule:
            toks, lps, done_h = eng.collect_decode_chunk(eng.dispatch_decode_chunk(s, n))
            out.append((toks, lps.view(np.int32), done_h))
        return first, out
    finally:
        eng.release_slots(slots, totals)


def _assert_same(got, want):
    (gf, gc), (wf, wc) = got, want
    np.testing.assert_array_equal(gf, wf)
    assert len(gc) == len(wc)
    for i, (g, w) in enumerate(zip(gc, wc)):
        for a, b, what in zip(g, w, ("tokens", "logprob bits", "done")):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {i}: {what}")


@pytest.mark.parametrize("pool", list(POOLS))
def test_replayed_chunks_equal_the_eager_step(cuda, pool):
    weights, kv_quant = POOLS[pool]
    cfg, params = _params(cuda, weights)
    totals = [len(PROMPTS[0]) + 20, len(PROMPTS[1]) + 1 + 5, len(PROMPTS[2]) + 20]
    schedule = (8, 3, 8)
    graph = _engine(cuda, cfg, params, kv_quant=kv_quant)
    eager = _engine(cuda, cfg, params, kv_quant=kv_quant)
    name, launcher = {
        False: ("paged_flash_decode", attention_decode.launch_paged_decode),
        "int8": ("paged_flash_decode_int8", attention_decode.launch_paged_decode_int8),
        "fp8": ("paged_flash_decode_fp8", attention_decode.launch_paged_decode_fp8)}[kv_quant]
    got = _chunks(graph, PROMPTS, totals, schedule)
    step = graph._steps[(3, "greedy")]
    assert step.graph is not None and step.capture_ms > 0
    assert step.launches[name] == cfg.num_hidden_layers  # K1 once a layer per replay
    before = launcher.launches
    again = _chunks(graph, PROMPTS, totals, schedule)
    replayed = launcher.launches - before
    with eager_step(eager, 3) as ref:
        before = launcher.launches
        want = _chunks(eager, PROMPTS, totals, schedule)
        assert ref.graph is None
    # The replays count the launches the eager steps make, one per layer a step.
    assert replayed == launcher.launches - before == sum(schedule) * cfg.num_hidden_layers
    _assert_same(got, want)
    _assert_same(again, want)
    assert got[1][0][2][1] and not got[1][0][2][2]  # row 1 stopped by its length mid-chunk


def test_each_width_captures_its_own_graph(cuda):
    cfg, params = _params(cuda)
    graph, eager = _engine(cuda, cfg, params), _engine(cuda, cfg, params)
    for prompts in (PROMPTS[:2], PROMPTS, PROMPTS[:2]):
        totals = [len(p) + 12 for p in prompts]
        with eager_step(eager, len(prompts)):
            want = _chunks(eager, prompts, totals, (8, 3))
        _assert_same(_chunks(graph, prompts, totals, (8, 3)), want)
    assert sorted(graph._steps) == [(2, "greedy"), (3, "greedy")]
    g2, g3 = graph._steps[(2, "greedy")].graph, graph._steps[(3, "greedy")].graph
    assert g2 is not None and g3 is not None and g2 is not g3


def _serve(eng, M):
    """A full-width resident session, as the scheduler keeps one: a chunk
    with every row empty, two requests spliced into rows 0 and 1, a chunk,
    a third request spliced into row 2, a chunk."""
    s = eng.start_decode_session(list(range(M)), np.zeros(M, np.int32), np.ones(M, bool),
                                 np.zeros(M, np.int32),
                                 tsamp.SamplingParams.make(M, temperature=0.0, device="cpu"))
    out = [eng.collect_decode_chunk(eng.dispatch_decode_chunk(s, 4))]
    for prompts, rows in (([PROMPTS[0], PROMPTS[1]], [0, 1]), ([PROMPTS[2]], [2])):
        totals = [len(p) + 30 for p in prompts]
        slots = eng.admit_requests(totals)
        assert slots == rows
        samp = tsamp.SamplingParams.make(len(prompts), temperature=0.0, device="cpu")
        bundle = eng.prefill_async(prompts, samp, slots)
        n = len(prompts)
        eng.update_session_rows(s, rows, bundle, [len(p) for p in prompts], totals,
                                [0.0] * n, [0.9] * n, [0] * n)
        out.append(eng.collect_decode_chunk(eng.dispatch_decode_chunk(s, 8)))
    return [(t, lp.view(np.int32), d) for t, lp, d in out]


def test_rows_spliced_between_chunks_reach_the_next_replay(cuda):
    cfg, params = _params(cuda)
    M = ENGINE["max_reqs"]
    graph, eager = _engine(cuda, cfg, params), _engine(cuda, cfg, params)
    got = _serve(graph, M)
    with eager_step(eager, M):
        want = _serve(eager, M)
    _assert_same((None, got), (None, want))
    pad = cfg.pad_token_id or 0
    assert (got[0][0] == pad).all() and got[0][2].all()  # nothing live yet
    assert not got[1][2][[0, 1]].any() and got[1][2][2]  # rows 0, 1 live; 2 not yet
    assert not got[2][2][[0, 1, 2]].any() and (got[2][0][:, 2] != pad).all()
    assert graph._steps[(M, "greedy")].graph is not None


def test_a_readmitted_slot_reads_no_stale_pages(cuda):
    """One slot: a long request decodes and is released, then a short one
    takes the same slot and pages the first wrote; its chunks equal those of
    the same request on a fresh engine."""
    cfg, params = _params(cuda)
    used = _engine(cuda, cfg, params, max_reqs=1)
    long = list(range(100, 190))
    _chunks(used, [long], [len(long) + 20], (8, 8))
    short = PROMPTS[0]
    got = _chunks(used, [short], [len(short) + 20], (8, 8))
    want = _chunks(_engine(cuda, cfg, params, max_reqs=1), [short], [len(short) + 20], (8, 8))
    _assert_same(got, want)
    assert int(used.cache.free_top) == used.num_pages


def test_sampled_replays_draw_fresh_numbers_and_follow_the_mask(cuda):
    """The card twin of the CPU sampler's distribution test, through
    ``capture_graph`` with the generator registered as the engine registers
    it: each replay draws new numbers (successive replays differ), and the
    draws over all replays follow softmax over the top-p nucleus."""
    V, N, R = 40, 2000, 8
    rng = np.random.default_rng(1)
    logits = torch.from_numpy((rng.standard_normal(V) * 2).astype(np.float32)).to(cuda)
    rows = logits[None].repeat(N, 1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for mode in ("approx", "exact"):
        params = tsamp.SamplingParams.make(N, temperature=0.8, top_p=0.8, top_k=0, device=cuda)
        out = torch.zeros(N, dtype=torch.int32, device=cuda)
        graph, _, _ = capture_graph(lambda: out.copy_(tsamp.sample(rows, gen, params, mode=mode)),
                                 gen, torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda))
        draws = []
        for _ in range(R):
            graph.replay()
            draws.append(out.cpu().numpy().copy())
        assert all((a != b).any() for a, b in zip(draws, draws[1:])), mode
        masked = tsamp.top_p_mask(tsamp.top_k_mask(rows[:1] / 0.8, params.top_k[:1]),
                                  params.top_p[:1])
        p = torch.softmax(masked[0], -1).cpu().numpy()
        freq = np.bincount(np.concatenate(draws), minlength=V) / (N * R)
        assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p)), mode
        np.testing.assert_allclose(freq, p, atol=0.02, err_msg=mode)


class _RecordingStep(DecodeStep):
    """The engine's decode step, also writing each step's logits (those the
    sampler draws from) to [decode_chunk, B, V] rows at the step counter."""

    def __init__(self, engine, width, mode):
        super().__init__(engine, width, mode)
        self.logits = torch.zeros((engine.decode_chunk, width, engine.config.vocab_size),
                                  dtype=torch.float32, device=engine.device)

    def forward(self):
        seq, logits = super().forward()
        self.logits.index_copy_(0, self.step, logits.float()[None])
        return seq, logits


@pytest.mark.parametrize("mode, samp", [
    ("approx", dict(temperature=0.3, top_p=0.8, top_k=0)),
    ("exact", dict(temperature=0.3, top_p=0.97, top_k=65)),
])
def test_sampled_engine_replays_draw_anew_within_the_nucleus(cuda, mode, samp):
    """The engine's own sampled step (made and captured by
    ``decode_step_for``, the engine's generator registered): two chunks from
    the same prefilled state draw different tokens, and every token a live
    row emits lies in the top-k / top-p nucleus of the logits it was drawn
    from at the temperature, with its logprob taken from those logits."""
    cfg, params = _params(cuda)
    eng = _engine(cuda, cfg, params)
    totals = [len(p) + 20 for p in PROMPTS]
    runs = []
    with mock.patch.object(engine_mod, "DecodeStep", _RecordingStep):
        for _ in range(2):
            first, [(toks, lp_bits, _)] = _chunks(eng, PROMPTS, totals, (8,), **samp)
            step = eng._steps[(len(PROMPTS), mode)]
            runs.append((first, toks, lp_bits.view(np.float32), step.logits.cpu().double()))
    assert isinstance(step, _RecordingStep) and step.graph is not None
    np.testing.assert_array_equal(runs[0][0], runs[1][0])  # greedy prefill: the same state
    assert (runs[0][1] != runs[1][1]).any()  # the second chunk's replays drew anew
    T, P, K = samp["temperature"], samp["top_p"], samp["top_k"]
    for first, toks, lps, logits in runs:
        for b in range(len(PROMPTS)):
            if first[b] == cfg.eos_token_id:
                continue  # done before the chunk
            for t in range(toks.shape[0]):
                row, tok = logits[t, b], int(toks[t, b])
                p = torch.softmax(row / T, -1)
                above = p > p[tok]
                assert K == 0 or int(above.sum()) < K, (t, b)
                assert float(p[above].sum()) < P + 1e-4, (t, b)
                assert lps[t, b] == pytest.approx(float(torch.log_softmax(row, -1)[tok]),
                                                  abs=1e-4)
                if tok == cfg.eos_token_id:
                    break  # the row is done: pad from here
