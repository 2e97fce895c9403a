"""The port's speculative decoding against the JAX package on the CPU, with
tiny fp32 models and the same weights in both: the drafting policies, the
allocator's rewind, one verify step, the chunked step's body, and whole
streams in both modes (host-drafted per step, device-drafted chunks) equal
to JAX's spec streams and to the port's plain greedy streams, with every
page back after draining. Mirrors tests/test_speculative.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation import speculative as jspec  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.models.decoder import init_decoder_params as j_init  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu_torch import ops as tops  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation import speculative as tspec  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.generation.sampling import SamplingParams  # noqa: E402
from lite_llama_tpu_torch.ops.attention_prefill import flash_prefill_chunked  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=97, eos_token_id=96)
ENGINE = dict(page_size=4, max_reqs=4, num_pages=48, decode_chunk=4)
PROMPTS = [
    [5, 6, 7, 5, 6, 7, 5, 6],  # periodic: the lookup hits
    [1, 2, 3],  # nothing to match
    [9, 9, 9, 9, 9],  # degenerate repeats
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(max_seq=96, **kw):
    """A JAX engine and the port's, on the same weights (JAX's seeded init,
    as tests/test_speculative.py makes them)."""
    jcfg = JLlama(dtype=jnp.float32, max_seq_len=max_seq, **CFG)
    tcfg = TLlama(dtype=torch.float32, max_seq_len=max_seq, **CFG)
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    eng_kw = dict(ENGINE, **kw)
    jeng = JEngine(jcfg, jp, **eng_kw)
    teng = InferenceEngine(tcfg, params_from_numpy(npp, tcfg, device="cpu"), device="cpu",
                           **eng_kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _pair()


def _same_allocator(jc, tc):
    np.testing.assert_array_equal(np.asarray(jc.page_table), tc.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(jc.seq_lens), tc.seq_lens.numpy())
    np.testing.assert_array_equal(np.asarray(jc.free_stack), tc.free_stack.numpy())
    assert int(np.asarray(jc.free_top).sum()) == int(tc.free_top)


def _drained(eng):
    assert eng._host_free_pages == eng.num_pages == int(eng.cache.free_top)
    assert len(eng._free_slots) == eng.max_reqs


def _low_entropy_histories(seed, trials=30, B=3, S=48):
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        lens = rng.integers(2, S, size=B).astype(np.int32)
        hist = np.zeros((B, S), np.int32)
        for b, n in enumerate(lens):
            hist[b, :n] = rng.integers(0, 5, size=int(n))  # small alphabet: matches occur
        yield hist, lens


def test_prompt_lookup_draft_matches_jax():
    h = [1, 2, 3, 4, 5, 1, 2, 3]
    assert tspec.prompt_lookup_draft(h, 2, ngram=3) == [4, 5]
    assert tspec.prompt_lookup_draft(h, 4, ngram=3) == [4, 5, 1, 2]
    assert tspec.prompt_lookup_draft([7, 8, 9], 3, ngram=3) == []
    assert tspec.prompt_lookup_draft([5, 1, 9, 1], 1, ngram=3) == [9]
    for hist, lens in _low_entropy_histories(3):
        for b, n in enumerate(lens):
            row = hist[b, :n].tolist()
            for k in (0, 1, 4):
                assert (tspec.prompt_lookup_draft(row, k, ngram=3)
                        == jspec.prompt_lookup_draft(row, k, ngram=3))


@pytest.mark.parametrize("ngram", [1, 3])
def test_device_prompt_lookup_matches_jax_and_the_host_policy(ngram):
    K = 4
    for trial, (hist, lens) in enumerate(_low_entropy_histories(7)):
        jd, jn = jspec.device_prompt_lookup(jnp.asarray(hist), jnp.asarray(lens), K, ngram=ngram)
        td, tn = tspec.device_prompt_lookup(torch.from_numpy(hist), torch.from_numpy(lens), K,
                                            ngram=ngram)
        assert td.dtype == tn.dtype == torch.int32
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for b, n in enumerate(lens):
            want = tspec.prompt_lookup_draft(hist[b, :n].tolist(), K, ngram=ngram)
            assert td[b, :int(tn[b])].tolist() == want, (trial, b)


def test_rewind_requests_matches_jax():
    """Alloc, optimistic extension past a page boundary, and rewinds (one
    returning the boundary page, one that would grow a request, a sentinel
    slot): page tables, lengths, free stack and top bit-equal to JAX's, and
    the port's state tensors keep their storage."""
    L, HKV, D, P, PS, M = 1, 2, 16, 8, 4, 3
    jc = jkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M, max_seq_len=32,
                             dtype=jnp.float32)
    tc = tkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M, max_seq_len=32,
                             dtype=torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in (tc.page_table, tc.seq_lens, tc.free_stack, tc.free_top)]

    def both(fn, *arrays, **kw):
        nonlocal jc
        jc = getattr(jkv, fn)(jc, *(jnp.asarray(a) for a in arrays),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        getattr(tkv, fn)(tc, *(torch.from_numpy(np.asarray(a)) for a in arrays),
                         **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
        _same_allocator(jc, tc)

    req = np.asarray([0, 2], np.int32)
    both("alloc_prefill", req, np.asarray([6, 3], np.int32))
    assert int(tc.free_top) == P - 3
    # Extend optimistically (slot 0 to 11 tokens, 3 pages; slot 2 to 5, 2 pages).
    lens = tc.seq_lens[torch.from_numpy(req).long()].numpy()
    both("alloc_prefill", req, np.asarray([11, 5], np.int32),
         prefix_rows=tc.page_table[torch.from_numpy(req).long()].numpy(),
         prefix_pages=((lens + PS - 1) // PS).astype(np.int32))
    assert int(tc.free_top) == P - 5
    # Rewind slot 0 to 7 tokens (its boundary page returns), slot 2 to 4
    # (its second page returns), and a sentinel slot that must change nothing.
    both("rewind_requests", np.asarray([0, 2, M], np.int32), np.asarray([7, 4, 1], np.int32))
    assert tc.seq_lens.tolist()[:3] == [7, 0, 4]
    assert int(tc.free_top) == P - 3
    # A rewind never grows a request.
    both("rewind_requests", np.asarray([0], np.int32), np.asarray([30], np.int32))
    assert int(tc.seq_lens[0]) == 7
    both("free_requests", req)
    assert int(tc.free_top) == P
    now = [t.data_ptr() for t in (tc.page_table, tc.seq_lens, tc.free_stack, tc.free_top)]
    assert now == ptrs


def _kv_write_both(rng, jpool, tpool, table, start, lens, S):
    HKV, D = tpool.num_kv_heads, tpool.head_dim
    for layer in range(tpool.pages.shape[0]):
        k = rng.standard_normal((len(lens), S, HKV, D)).astype(np.float32)
        v = rng.standard_normal((len(lens), S, HKV, D)).astype(np.float32)
        jpool = jkv.kv_write_prefill(jpool, layer, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(table), jnp.asarray(start), jnp.asarray(lens))
        tkv.kv_write_prefill(tpool, layer, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(table), torch.from_numpy(start),
                             torch.from_numpy(lens))
    return jpool


@pytest.mark.parametrize("quantized", [False, "int8"])
def test_dropped_positions_never_overwrite_a_live_write(quantized):
    """The sync-free KV write: request 1's dropped positions map through
    table entries that point at request 0's pages (stale entries), onto rows
    request 0 writes in the same call; the pool must equal JAX's, which
    drops them. A call with no live position changes nothing."""
    L, HKV, D, PS = 2, 2, 8, 4
    jc = jkv.create_kv_cache(L, HKV, D, 8, page_size=PS, max_reqs=2, max_seq_len=32,
                             dtype=jnp.float32, quantized=bool(quantized))
    tc = tkv.create_kv_cache(L, HKV, D, 8, page_size=PS, max_reqs=2, max_seq_len=32,
                             dtype=torch.float32, device="cpu", quantized=quantized)
    rng = np.random.default_rng(4)
    table = np.asarray([[3, 5, 0, 0, 0, 0, 0, 0], [6, 3, 5, 0, 0, 0, 0, 0]], np.int32)
    start = np.asarray([0, 2], np.int32)
    lens = np.asarray([8, 1], np.int32)  # request 1's positions 3..9 are dropped
    jpool = _kv_write_both(rng, jc.kv_pages, tc.kv_pages, table, start, lens, 8)
    np.testing.assert_array_equal(np.asarray(jpool.pages), tc.kv_pages.pages.numpy())
    if quantized:
        np.testing.assert_array_equal(np.asarray(jpool.scales).view(np.uint16),
                                      tc.kv_pages.scales.view(torch.int16).numpy()
                                      .view(np.uint16))
    before = tc.kv_pages.pages.clone()
    _kv_write_both(rng, jpool, tc.kv_pages, table, start, np.zeros(2, np.int32), 8)
    assert torch.equal(before, tc.kv_pages.pages)


def _greedy_stream(teng, prompts, n):
    return [o.token_ids for o in TextGenerator(teng).generate_tokens(
        prompts, max_gen_len=n, temperature=0.0)]


def test_spec_verify_matches_jax(engines):
    """One verify step: row 0 accepts two of four drafts over a page
    boundary, row 1 sits out (chunk_lens 0), row 2 accepts all three drafts
    across a boundary: emit, n_emit, next_tok and the allocator state
    bit-equal to JAX's, the pools within 1e-5."""
    jeng, teng = engines
    stream = _greedy_stream(teng, PROMPTS, 6)
    assert stream == [o.token_ids for o in JGen(jeng).generate_tokens(
        PROMPTS, max_gen_len=6, temperature=0.0)]
    max_total = [len(p) + 16 for p in PROMPTS]
    jslots = jeng.admit_requests(max_total, prompts=PROMPTS)
    tslots = teng.admit_requests(max_total, prompts=PROMPTS)
    assert jslots == tslots
    from lite_llama_tpu.generation.generate import _make_sampling
    jfirst = jeng.prefill(PROMPTS, _make_sampling(3, 0.0, 1.0, 0), jslots)[0]
    tfirst = teng.prefill(PROMPTS, SamplingParams.make(3, temperature=0.0, device="cpu"),
                          tslots)[0]
    np.testing.assert_array_equal(np.asarray(jfirst), tfirst)
    wrong = (stream[0][3] + 1) % CFG["vocab_size"]
    chunk = np.asarray([
        [stream[0][0], stream[0][1], stream[0][2], wrong, 0],
        [stream[1][0], 0, 0, 0, 0],
        [stream[2][0], stream[2][1], stream[2][2], stream[2][3], 0],
    ], np.int32)
    chunk_lens = np.asarray([5, 0, 4], np.int32)
    want = jeng.spec_verify(jslots, chunk, chunk_lens)
    got = teng.spec_verify(tslots, chunk, chunk_lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[1].tolist() == [3, 1, 4]
    assert got[0][0, :3].tolist() == stream[0][1:4]
    _same_allocator(jeng.cache, teng.cache)
    np.testing.assert_allclose(teng.cache.kv_pages.pages.numpy(),
                               np.asarray(jeng.cache.kv_pages.pages), rtol=1e-5, atol=1e-5)
    jeng.release_slots(jslots, max_total)
    teng.release_slots(tslots, max_total)
    _drained(teng)


@pytest.mark.parametrize("chunk_steps", [0, 6], ids=["per-step", "chunked"])
@pytest.mark.parametrize("gen_len", [5, 23])
def test_spec_streams_match_jax_and_plain_greedy(engines, gen_len, chunk_steps):
    jeng, teng = engines
    want = [o.token_ids for o in jspec.SpeculativeTextGenerator(
        jeng, draft_len=4, chunk_steps=chunk_steps).generate_tokens(PROMPTS, max_gen_len=gen_len)]
    spec = tspec.SpeculativeTextGenerator(teng, draft_len=4, chunk_steps=chunk_steps)
    outs = spec.generate_tokens(PROMPTS, max_gen_len=gen_len)
    assert [o.token_ids for o in outs] == want
    assert [o.token_ids for o in outs] == _greedy_stream(teng, PROMPTS, gen_len)
    _drained(teng)


@pytest.mark.parametrize("chunk_steps", [0, 5], ids=["per-step", "chunked"])
def test_spec_takes_fewer_forwards_than_plain_decoding_on_repetition(chunk_steps):
    """On a periodic prompt one forward verifies several tokens: fewer
    verify forwards than plain decoding's steps, and the same stream."""
    _, teng = _pair(max_seq=128)
    prompts = [[3, 4, 5] * 6]
    spec = tspec.SpeculativeTextGenerator(teng, draft_len=4, chunk_steps=chunk_steps)
    name = "spec_decode_chunk" if chunk_steps else "spec_verify"
    calls = []
    real = getattr(teng, name)

    def probe(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(teng, name, probe)
    out = spec.generate_tokens(prompts, max_gen_len=24)[0].token_ids
    delattr(teng, name)
    forwards = len(calls) * max(chunk_steps, 1)
    assert forwards < len(out) - 1, (forwards, len(out))
    assert out == _greedy_stream(teng, prompts, 24)[0]
    _drained(teng)


def test_spec_chunk_body_matches_jax_spec_chunk():
    """One chunk of the eager SpecStep body against JAX's ``_spec_chunk``
    from the same state: emitted tokens, kept counts, history, lengths,
    current tokens, done flags and the allocator state."""
    jeng, teng = _pair()
    max_total = [len(p) + 20 for p in PROMPTS]
    slots = jeng.admit_requests(max_total, prompts=PROMPTS)
    assert teng.admit_requests(max_total, prompts=PROMPTS) == slots
    from lite_llama_tpu.generation.generate import _make_sampling
    first = np.asarray(jeng.prefill(PROMPTS, _make_sampling(3, 0.0, 1.0, 0), slots)[0])
    teng.prefill(PROMPTS, SamplingParams.make(3, temperature=0.0, device="cpu"), slots)
    S = 96  # max_seq_len, the history the generator keeps
    hist = np.zeros((3, S), np.int32)
    hl = np.asarray([len(p) + 1 for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        hist[i, :len(p)] = p
        hist[i, len(p)] = first[i]
    done = np.zeros(3, bool)
    want = jeng.spec_decode_chunk(slots, jnp.asarray(hist), jnp.asarray(hl), jnp.asarray(first),
                                  jnp.asarray(done), max_total, n_steps=4, draft_len=4, ngram=3)
    got = teng.spec_decode_chunk(slots, torch.from_numpy(hist.copy()), torch.from_numpy(hl),
                                 torch.from_numpy(first.astype(np.int32)),
                                 torch.from_numpy(done), max_total, n_steps=4, draft_len=4,
                                 ngram=3)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[5].sum() > 4 * 2  # drafts were accepted inside the chunk
    _same_allocator(jeng.cache, teng.cache)
    jeng.release_slots(slots, max_total)
    teng.release_slots(slots, max_total)
    _drained(teng)


@pytest.mark.parametrize("kw", [dict(kv_quant="int8"), dict(prefix_cache=True)],
                         ids=["int8-pool", "prefix-cache"])
def test_spec_streams_match_jax_with_an_int8_pool_or_prefix_hits(kw):
    jeng, teng = _pair(**kw)
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 11], [5, 6, 7, 5, 6, 7, 5, 6, 9, 9]]  # share 2 pages
    for _ in range(2):  # with the prefix cache, the second round hits
        want = [o.token_ids for o in jspec.SpeculativeTextGenerator(
            jeng, draft_len=3, chunk_steps=4).generate_tokens(prompts, max_gen_len=17)]
        got = [o.token_ids for o in tspec.SpeculativeTextGenerator(
            teng, draft_len=3, chunk_steps=4).generate_tokens(prompts, max_gen_len=17)]
        assert got == want
    if kw.get("prefix_cache"):
        assert teng.stats.prefix_hits == jeng.stats.prefix_hits > 0
    else:
        _drained(teng)
    assert got == _greedy_stream(teng, prompts, 17)


def test_spec_refuses_sampling(engines):
    with pytest.raises(ValueError, match="greedy only"):
        tspec.SpeculativeTextGenerator(engines[1]).generate_tokens(PROMPTS, temperature=0.7)


def test_narrow_chunk_attention_matches_jax_reference_path():
    """A verify chunk narrower than a page: the JAX dispatcher sends it to
    its XLA reference (``q.shape[1] >= page_size`` fails), the port to K5,
    whose plain version must give the same function within 2e-5, at a
    start position that is not page-aligned and a chunk that crosses a page
    boundary."""
    from lite_llama_tpu import ops as jops

    rng = np.random.default_rng(5)
    B, S, Nq, Hkv, D, PS, P = 3, 5, 4, 2, 16, 8, 12
    ppr = 4
    jc = jkv.create_kv_cache(1, Hkv, D, P, page_size=PS, max_reqs=B, max_seq_len=ppr * PS,
                             dtype=jnp.float32)
    pages = rng.standard_normal(tuple(jc.kv_pages.pages.shape)).astype(np.float32)
    jpool = jkv.KVPool(pages=jnp.asarray(pages), scales=None, page_size=PS, num_kv_heads=Hkv,
                       head_dim=D)
    tpool = tkv.KVPool(pages=torch.from_numpy(pages), page_size=PS, num_kv_heads=Hkv, head_dim=D)
    table = rng.permutation(P)[:B * ppr].reshape(B, ppr).astype(np.int32)
    start = np.asarray([13, 6, 21], np.int32)
    clens = np.asarray([5, 0, 3], np.int32)
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jops.set_backend("pallas")
    try:
        want = np.asarray(jops.chunked_prefill_attention(
            *(jnp.asarray(a) for a in (q, k, v, clens, start)), jpool, 0, jnp.asarray(table)))
    finally:
        jops.set_backend("auto")
    ref = np.asarray(jref.chunked_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, clens, start)), jpool, 0, jnp.asarray(table)))
    np.testing.assert_array_equal(want, ref)  # the JAX dispatcher took its reference
    targs = (*(torch.from_numpy(a) for a in (q, k, v, clens, start)), tpool, 0,
             torch.from_numpy(table))
    live = clens[:, None] > np.arange(S)[None, :]
    for got in (flash_prefill_chunked(*targs), tops.chunked_prefill_attention(*targs)):
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=2e-5, atol=2e-5)
