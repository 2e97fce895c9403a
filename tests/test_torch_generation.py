"""The port's engine, TextGenerator and sampler against the JAX package on
the CPU: greedy generation through InferenceEngine + TextGenerator gives the
JAX engine's tokens on a tiny fp32 config (same numpy weights); the sampling
predicates and masks agree; sampled draws follow the masked distribution.
The two frameworks draw different random numbers from one seed, so sampled
paths are compared by distribution, as tests/test_sampling_dist.py does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation import sampling as jsamp  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation import sampling as tsamp  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=97, max_seq_len=64, eos_token_id=96)
ENGINE = dict(page_size=8, max_reqs=8, num_pages=64, decode_chunk=8)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    jcfg = JLlama(dtype=jnp.float32, **CFG)
    tcfg = TLlama(dtype=torch.float32, **CFG)
    npp = numpy_params(jcfg, seed=11)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in npp.items()}
    jeng = JEngine(jcfg, jp, **ENGINE)
    teng = InferenceEngine(tcfg, params_from_numpy(npp, tcfg, device="cpu"), device="cpu",
                           **ENGINE)
    return jeng, teng


@pytest.mark.parametrize("max_gen_len", [1, 13, 30])
def test_greedy_tokens_match_jax_engine(engines, max_gen_len):
    jeng, teng = engines
    want = JGen(jeng).generate_tokens(PROMPTS, max_gen_len=max_gen_len, temperature=0.0,
                                      logprobs=True)
    got = TextGenerator(teng).generate_tokens(PROMPTS, max_gen_len=max_gen_len,
                                              temperature=0.0, logprobs=True)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)
    # Every slot and page came back.
    assert len(teng._free_slots) == ENGINE["max_reqs"]
    assert teng._host_free_pages == ENGINE["num_pages"] == int(teng.cache.free_top)


def test_sampled_generation_and_admission(engines):
    _, teng = engines
    gen = TextGenerator(teng)
    outs = gen.generate_tokens(PROMPTS, max_gen_len=10, temperature=0.9, top_p=0.9, top_k=20)
    for o in outs:
        assert 1 <= len(o.token_ids) <= 10
        assert all(0 <= t < CFG["vocab_size"] for t in o.token_ids)
    assert not teng.admit_feasible(CFG["max_seq_len"] + 1)
    with pytest.raises(RuntimeError, match="KV capacity exhausted"):
        teng.admit_requests([64] * 9)
    assert len(teng._free_slots) == ENGINE["max_reqs"]
    # Long prompts are chunked now; one past max_seq_len cannot fit a table row.
    with pytest.raises(ValueError, match="max_seq_len"):
        teng.prefill([[1] * 3000], tsamp.SamplingParams.make(1, device="cpu"), [0])


def test_sampling_predicates_and_masks_match_jax():
    grid = [(t, p, k) for t in (0.0, 0.7, 1.5) for p in (0.5, 0.95, 1.0) for k in (0, 8, 100)]
    for t, p, k in grid:
        args = (np.asarray([t, 0.7]), np.asarray([p, 0.9]), np.asarray([k, 0]))
        assert tsamp.needs_exact_sampling(*args) == jsamp.needs_exact_sampling(*args)
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 50)) * 3).astype(np.float32)
    top_p = np.asarray([0.1, 0.5, 0.9, 1.0], np.float32)
    top_k = np.asarray([0, 1, 5, 60], np.int32)
    tl = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        tsamp.top_p_mask(tl, torch.from_numpy(top_p)).numpy(),
        np.asarray(jsamp.top_p_mask(jnp.asarray(logits), jnp.asarray(top_p))))
    np.testing.assert_array_equal(
        tsamp.top_k_mask(tl, torch.from_numpy(top_k)).numpy(),
        np.asarray(jsamp.top_k_mask(jnp.asarray(logits), jnp.asarray(top_k))))
    toks = np.asarray([3, 7, 0, 49])
    np.testing.assert_allclose(
        tsamp.log_softmax_gather(tl, torch.from_numpy(toks)).numpy(),
        np.asarray(jsamp.log_softmax_gather(jnp.asarray(logits), jnp.asarray(toks))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["approx", "exact"])
def test_sampled_distribution_follows_the_mask(mode):
    """Draws from one row follow softmax over the top-p nucleus (the JAX
    sampler's distribution; with top_k off both paths keep the same set);
    greedy rows return the argmax."""
    V, N = 40, 4000
    rng = np.random.default_rng(1)
    logits = torch.from_numpy((rng.standard_normal(V) * 2).astype(np.float32))
    rows = logits[None].repeat(N, 1)
    params = tsamp.SamplingParams.make(N, temperature=0.8, top_p=0.8, top_k=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = tsamp.sample(rows, g, params, mode=mode)
    masked = tsamp.top_p_mask(tsamp.top_k_mask(rows[:1] / 0.8, params.top_k[:1]),
                              params.top_p[:1])
    p = torch.softmax(masked[0], -1).numpy()
    freq = np.bincount(toks.numpy(), minlength=V) / N
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p))
    np.testing.assert_allclose(freq, p, atol=0.03)
    greedy = tsamp.SamplingParams.make(2, temperature=0.0, device="cpu")
    assert tsamp.sample(rows[:2], g, greedy, mode=mode).tolist() == [int(logits.argmax())] * 2


def _session_chunks(eng, make, prompts, totals, schedule):
    """Admit and greedily prefill ``prompts``, then run one decode session
    chunk by chunk (``schedule`` steps each); returns the first tokens and
    each chunk's (tokens [n, B], logprobs [n, B], done [B])."""
    slots = eng.admit_requests(totals)
    try:
        sampling = make(len(prompts), temperature=0.0)
        first, lens, _, _ = eng.prefill(prompts, sampling, slots)
        done = np.asarray([n + 1 >= t for n, t in zip(lens, totals)])
        s = eng.start_decode_session(slots, first, done, totals, sampling)
        return first, [eng.collect_decode_chunk(eng.dispatch_decode_chunk(s, n))
                       for n in schedule]
    finally:
        eng.release_slots(slots, totals)


def _cpu_make(batch, **kw):
    return tsamp.SamplingParams.make(batch, device="cpu", **kw)


@pytest.mark.parametrize("schedule", [(8, 8, 8), (3, 5, 8, 2)])
def test_decode_step_body_matches_jax_decode_chunk(schedule):
    """The port's decode step (on the CPU, its body called once a step over
    the static buffers a graph replays on the card) against JAX's jitted
    ``_decode_chunk``: the same tokens, logprobs and done flags chunk by
    chunk, with chunks shorter than ``decode_chunk`` (JAX runs them masked
    at a power-of-two width), a row stopped by its length mid-chunk and a
    row stopped by eos mid-chunk."""
    # Layers three times as strong as the fixture's, so that greedy tokens
    # vary from step to step (the fixture's model repeats the last token).
    npp = numpy_params(JLlama(dtype=jnp.float32, **CFG), seed=11)
    for k in ("wq", "wkv", "o_proj", "gate_up_proj", "down_proj"):
        npp["layers"][k] *= 3.0

    def pair(eos):
        cfg = dict(CFG, eos_token_id=eos)
        tcfg = TLlama(dtype=torch.float32, **cfg)
        return (JEngine(JLlama(dtype=jnp.float32, **cfg), _jax_tree(npp), **ENGINE),
                InferenceEngine(tcfg, params_from_numpy(npp, tcfg, device="cpu"), device="cpu",
                                **ENGINE))

    # eos: the token row 0 emits at its fifth decode step, new to it there.
    ref = JGen(pair(CFG["eos_token_id"])[0]).generate_tokens(
        PROMPTS[:1], max_gen_len=12, temperature=0.0)[0].token_ids
    eos = next(t for i, t in enumerate(ref) if i >= 5 and t not in ref[:i])
    j, t = pair(eos)
    totals = [len(PROMPTS[0]) + 30, len(PROMPTS[1]) + 1 + 6, len(PROMPTS[2]) + 30]
    jfirst, jout = _session_chunks(j, jsamp.SamplingParams.make, PROMPTS, totals, schedule)
    tfirst, tout = _session_chunks(t, _cpu_make, PROMPTS, totals, schedule)
    np.testing.assert_array_equal(tfirst, jfirst)
    stopped = np.zeros(3, bool)
    for c, ((jt, jl, jd), (tt, tl, td)) in enumerate(zip(jout, tout)):
        np.testing.assert_array_equal(tt, jt, err_msg=f"chunk {c}")
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4, err_msg=f"chunk {c}")
        np.testing.assert_array_equal(td, jd, err_msg=f"chunk {c}")
        stopped |= td
    # Row 0 met eos and row 1 its length, each inside a chunk.
    assert stopped[:2].all() and not stopped[2]
    assert eos in np.concatenate([tt[:, 0] for tt, _, _ in tout])
    assert list(t._steps) == [(len(PROMPTS), "greedy")]


def test_decode_state_stays_in_place(engines):
    """Every state tensor a replayed decode step reads keeps its address
    through admission, prefill, decode chunks, release and re-admission:
    the cache's pool, table, lengths and free stack with its top, the
    session's tensors and the decode step's buffers."""
    _, teng = engines
    c = teng.cache

    def cache_state():
        return [c.kv_pages.pages, c.page_table, c.seq_lens, c.free_stack, c.free_top]

    state = cache_state()
    ptrs = [x.data_ptr() for x in state]
    gen = TextGenerator(teng)
    gen.generate_tokens(PROMPTS, max_gen_len=13, temperature=0.0)
    step = teng._steps[(len(PROMPTS), "greedy")]
    bufs = dict(req_ids=step.req_ids, tok=step.tok, done=step.done, stop=step.stop,
                toks=step.toks, lps=step.lps, step=step.step,
                **{f"samp{i}": x for i, x in enumerate(step.samp)})
    bptrs = {k: v.data_ptr() for k, v in bufs.items()}
    slots = teng.admit_requests([20, 20, 20])
    try:
        sampling = _cpu_make(3, temperature=0.0)
        first, _, _, _ = teng.prefill(PROMPTS, sampling, slots)
        s = teng.start_decode_session(slots, first, np.zeros(3, bool), [20] * 3, sampling)
        sptrs = [x.data_ptr() for x in (s.req_ids, s.tok, s.done, s.stop, *s.samp)]
        for n in (8, 3):
            teng.collect_decode_chunk(teng.dispatch_decode_chunk(s, n))
        assert [x.data_ptr() for x in (s.req_ids, s.tok, s.done, s.stop, *s.samp)] == sptrs
    finally:
        teng.release_slots(slots, [20] * 3)
    gen.generate_tokens(PROMPTS[::-1], max_gen_len=9, temperature=0.0)
    assert teng._steps[(len(PROMPTS), "greedy")] is step
    assert {k: v.data_ptr() for k, v in bufs.items()} == bptrs
    assert all(a is b for a, b in zip(cache_state(), state))
    assert [x.data_ptr() for x in cache_state()] == ptrs
    assert teng._host_free_pages == ENGINE["num_pages"] == int(c.free_top)


def test_new_eos_ids_drop_the_decode_steps(engines):
    """A decode step (a captured graph on the card) reads the engine's eos
    tensor: setting the same ids keeps the steps, new ids drop them, and the
    next chunk builds a step that stops at the new id."""
    _, teng = engines
    gen = TextGenerator(teng)
    out = gen.generate_tokens(PROMPTS[:2], max_gen_len=6, temperature=0.0)
    step = teng._steps[(2, "greedy")]
    teng.set_eos([CFG["eos_token_id"]])
    assert teng._steps[(2, "greedy")] is step
    eos = out[0].token_ids[1]  # row 0's first decode token
    slots = teng.admit_requests([20])
    try:
        teng.set_eos([eos])
        assert not teng._steps
        samp = _cpu_make(1, temperature=0.0)
        first, _, _, _ = teng.prefill(PROMPTS[:1], samp, slots)
        s = teng.start_decode_session(slots, first, np.zeros(1, bool), [20], samp)
        toks, _, done = teng.collect_decode_chunk(teng.dispatch_decode_chunk(s, 4))
        assert done[0] and toks[0, 0] == eos and (toks[1:, 0] == teng.pad_id).all()
    finally:
        teng.release_slots(slots, [20])
        teng.set_eos([CFG["eos_token_id"]])
    assert teng._host_free_pages == ENGINE["num_pages"] == int(teng.cache.free_top)
