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
from tests.test_torch_decoder import numpy_params  # noqa: E402

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
