"""The port's prompt-prefix cache on the CPU: the single-group cases of
tests/test_prefix_cache.py, with generations through a prefix-cache engine
token-identical to the JAX engine's and to an engine without the cache
(same numpy fp32 weights), equal hit statistics, and page accounting that
balances across reuse, donation, eviction and rolled-back admissions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=151, max_seq_len=128)
SYS = list(range(40, 60))  # 20 tokens = 2 full pages (page_size 8) + tail


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg = JLlama(dtype=jnp.float32, **CFG)
    tcfg = TLlama(dtype=torch.float32, **CFG)
    npp = numpy_params(jcfg, seed=21)
    return jcfg, _jax_tree(npp), tcfg, params_from_numpy(npp, tcfg, device="cpu")


def _kw(kw):
    for k, v in dict(page_size=8, max_reqs=4, num_pages=48, decode_chunk=4).items():
        kw.setdefault(k, v)
    return kw


def _engine(weights, prefix=True, **kw):
    _, _, tcfg, tp = weights
    return InferenceEngine(tcfg, tp, device="cpu", prefix_cache=prefix, **_kw(kw))


def _jax_engine(weights, prefix=True, **kw):
    jcfg, jp, _, _ = weights
    return JEngine(jcfg, jp, prefix_cache=prefix, **_kw(kw))


def _greedy(gen, prompts, n):
    return [o.token_ids for o in gen.generate_tokens(prompts, max_gen_len=n, temperature=0.0)]


def _stats(eng):
    s = eng.stats
    return s.prefix_hits, s.prefix_tokens_reused, s.prefill_tokens


def test_prefix_reuse_is_token_identical_to_jax(weights):
    eng, jeng = _engine(weights), _jax_engine(weights)
    ref_gen = TextGenerator(_engine(weights, prefix=False))
    gen, jgen = TextGenerator(eng), JGen(jeng)
    p1, p2 = SYS + [7, 8, 9], SYS + [11, 12]
    # First pass: no hit; the prompt's full pages are donated on release.
    got1, want1 = _greedy(gen, [p1], 6), _greedy(jgen, [p1], 6)
    assert got1 == want1 == _greedy(ref_gen, [p1], 6)
    assert eng.stats.prefix_hits == 0
    pt_first = eng.stats.prefill_tokens
    # Second pass shares the system prefix: it hits and stays identical.
    got2, want2 = _greedy(gen, [p2], 6), _greedy(jgen, [p2], 6)
    assert got2 == want2 == _greedy(ref_gen, [p2], 6)
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefix_tokens_reused == 16  # 2 pages * 8 tokens
    assert eng.stats.prefill_tokens - pt_first < len(p2)
    assert _stats(eng) == _stats(jeng)


def test_batch_with_hits_and_misses_matches_jax(weights):
    """A batch in which some prompts hit two different cached prefixes and
    one misses: tokens and hit statistics equal the JAX engine's."""
    eng, jeng = _engine(weights, max_reqs=4, num_pages=64), _jax_engine(weights, max_reqs=4,
                                                                        num_pages=64)
    other = list(range(90, 107))  # 17 tokens: 2 full pages
    warm = [SYS + [1], other]
    batch = [SYS + [5, 6, 7], other + [3], list(range(1, 12)), SYS[:9] + [2]]
    gen, jgen = TextGenerator(eng), JGen(jeng)
    assert _greedy(gen, warm, 3) == _greedy(jgen, warm, 3)
    assert _greedy(gen, batch, 5) == _greedy(jgen, batch, 5)
    assert eng.stats.prefix_hits == jeng.stats.prefix_hits == 2
    assert _stats(eng) == _stats(jeng)
    want = _greedy(TextGenerator(_engine(weights, prefix=False)), batch, 5)
    assert _greedy(gen, batch, 5) == want


def test_exact_prompt_rerun_recomputes_last_token(weights):
    """A prompt that IS a cached prefix (all full pages) still samples
    correctly: its last token is always recomputed."""
    eng, jeng = _engine(weights), _jax_engine(weights)
    p = SYS[:16]  # exactly 2 pages
    gen, jgen = TextGenerator(eng), JGen(jeng)
    a, b = _greedy(gen, [p], 5), _greedy(gen, [p], 5)
    assert eng.stats.prefix_hits == 1
    assert a == b == _greedy(jgen, [p], 5) == _greedy(jgen, [p], 5)
    assert _stats(eng) == _stats(jeng)


def _balanced(eng):
    held = sum(e[0] for e in eng.prefix.entries.values())
    assert eng._host_free_pages + held == eng.num_pages
    assert int(eng.cache.free_top) == eng._host_free_pages


def test_page_accounting_balances(weights):
    eng = _engine(weights)
    gen = TextGenerator(eng)
    for tail in ([1], [2, 3], [4, 5, 6]):
        gen.generate_tokens([SYS + tail], max_gen_len=4, temperature=0.0)
    _balanced(eng)
    assert all(e[2] == 0 for e in eng.prefix.entries.values())  # no references left


def test_eviction_frees_pages_under_pressure(weights):
    eng = _engine(weights, num_pages=16)  # tight pool
    gen = TextGenerator(eng)
    for base in (0, 30, 60):  # three distinct 2-page prefixes -> 3 entries, 6 pages
        gen.generate_tokens([list(range(base, base + 17))], max_gen_len=3, temperature=0.0)
    keys_before = set(eng.prefix.entries)
    assert sum(e[0] for e in eng.prefix.entries.values()) == 6 and len(keys_before) == 3
    # 10 pages free; a request needing 13 forces eviction, least recent first.
    out = gen.generate_tokens([list(range(90, 130))], max_gen_len=60, temperature=0.0)
    assert out[0].token_ids
    assert keys_before - set(eng.prefix.entries)
    _balanced(eng)


def test_rolled_back_admission_never_donates(weights):
    """Slots of an admission that rolls back were never prefilled: their
    table rows must not be registered as prefix entries."""
    eng = _engine(weights, num_pages=16, max_reqs=4)
    gen = TextGenerator(eng)
    long_prompt = list(range(40))
    with pytest.raises(RuntimeError):
        # Two 100-token budgets cannot fit a 16-page pool -> rollback.
        gen.generate_tokens([long_prompt, long_prompt[::-1]], max_gen_len=60, temperature=0.0)
    assert eng.prefix.entries == {}
    assert eng._host_free_pages == eng.num_pages
    assert not eng._slot_prompt and not eng._slot_prefix
    assert gen.generate_tokens([long_prompt], max_gen_len=4, temperature=0.0)[0].token_ids


def test_eviction_never_frees_the_entry_being_acquired(weights):
    """A hit whose entry is also the only evictable one survives the
    eviction its own admission triggers."""
    eng = _engine(weights, num_pages=16, max_reqs=4)
    gen = TextGenerator(eng)
    sys_prompt = list(range(60, 77))  # 2 full pages, cached on release
    gen.generate_tokens([sys_prompt], max_gen_len=3, temperature=0.0)
    assert len(eng.prefix.entries) == 1
    out = gen.generate_tokens([sys_prompt + [1, 2, 3]], max_gen_len=80, temperature=0.0)
    assert out[0].token_ids
    assert eng.stats.prefix_hits == 1
    _balanced(eng)
