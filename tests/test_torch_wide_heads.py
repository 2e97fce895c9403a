"""Head dim 256 (Falcon3) and up to 16 query heads per kv head (Mistral-Large-2,
Llama-3.1-405B at 8 kv heads; one kv head a rank at tp 8), on the CPU,
against the JAX package with the same numpy inputs:

1. K1's plain path with the newest-token fold against JAX
   ``paged_flash_decode(interpret=True)`` at D 256 (6 query heads over 2 kv
   heads) and at G 12 and 16 (one kv head), on bf16 and int8 pools;
2. K2's plain version (``ops.prefill_attention`` on CPU tensors) against
   JAX ``flash_prefill(interpret=True)`` at D 256, which takes the streamed
   ``_flash_prefill_impl`` and never ``_flash_prefill_vmem`` (a spy checks
   both); on the card D 256 launches K2, not K8;
3. K5 and K5q's plain version against JAX ``flash_prefill_chunked
   (interpret=True)`` at D 256 and at G 16, on bf16 and int8 pools;
4. greedy tokens and logprobs of a two-layer D 256 model and a two-layer
   G 12 model through the port's engine against the JAX engine under both
   of its backends (XLA, and Pallas in interpret mode), one shot and in
   chunks of 8 tokens.

Tolerances: 2e-5 for fp32 ops (different summation orders; 1e-4 on m,
|m| ~ 10), 1e-4 for logprobs; greedy tokens equal. The card's side of the
same shapes is in tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.ops import attention_prefill as jap  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.ops import _build  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import paged_flash_decode  # noqa: E402
from lite_llama_tpu_torch.ops.attention_prefill import (  # noqa: E402
    K2_HEAD_DIMS,
    flash_prefill_chunked,
)
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402
from tests.test_torch_kv_quant import _pools  # noqa: E402
from tests.test_torch_ops import _paged_inputs  # noqa: E402

TOL = 2e-5
# (pool, D, Nq, Hkv): Falcon3's head dim with G 3, and one kv head of G 12
# (Mistral-Large-2 at tp 8) and of G 16 (Llama-3.1-405B at tp 8).
KERNEL_CASES = [(kv, D, Nq, Hkv) for kv in (None, "int8")
                for D, Nq, Hkv in ((256, 6, 2), (128, 12, 1), (128, 16, 1))]
ENGINE = dict(page_size=8, max_reqs=4, num_pages=32, decode_chunk=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17, 18, 19]]
CHUNK_PROMPTS = [list(range(20, 39)), [5, 6, 7]]
# Two-layer models: head dim 256 (2 query heads over one kv head, as
# Falcon3's 12 over 4 keep 3 a group), and 12 query heads over one kv head.
MODELS = {
    "D256": dict(hidden_size=512, intermediate_size=160, num_hidden_layers=2,
                 num_attention_heads=2, num_key_value_heads=1, vocab_size=97, max_seq_len=64,
                 eos_token_id=96),
    "G12": dict(hidden_size=192, intermediate_size=160, num_hidden_layers=2,
                num_attention_heads=12, num_key_value_heads=1, vocab_size=97, max_seq_len=64,
                eos_token_id=96),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, **kw)


def test_the_wrappers_take_head_dim_256_and_16_query_heads_per_kv_head():
    """The card's wrappers accept exactly these shapes beyond the narrow
    ones: D 256 (K2, not K8) and G up to 16; D 130-254 and odd D stay out."""
    assert 256 in _build.HEAD_DIMS and 256 in K2_HEAD_DIMS and _build.MAX_GROUP == 16
    assert not any(D in _build.HEAD_DIMS for D in (99, 130, 192, 254, 258))


@pytest.mark.parametrize("kv,D,Nq,Hkv", KERNEL_CASES)
def test_k1_plain_with_fold_matches_jax_kernel(kv, D, Nq, Hkv):
    """K1 / K1q's CPU path (the plain version plus the newest-token fold)
    against the JAX decode kernel in interpret mode: out, m and l over the
    pool, and the output with the new token folded in; lens hold an empty
    request and a page edge."""
    B, ps, lens = 3, 8, [17, 0, 8]
    rng = np.random.default_rng(D + Nq)
    if kv is None:
        jpool, tpool, table, q, kn, vn = _paged_inputs(rng, B, Nq, Hkv, D, ps, lens)
    else:
        P, ppr = 24, 6
        jpool, tpool = _pools(kv, rng, 2, Hkv, D, ps, P)
        table = rng.permutation(P)[: B * ppr].reshape(B, ppr).astype(np.int32)
        q = rng.standard_normal((B, Nq, D)).astype(np.float32)
        kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
        vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    live = sl > 0
    jq, jt, jkn, jvn = map(jnp.asarray, (q, table, kn, vn))
    tq, tt, tkn, tvn = map(_t, (q, table, kn, vn))
    layer = 1
    out, m, l = paged_flash_decode(tq, tpool, layer, tt, _t(sl), return_state=True)
    jo, jm, jl = j_decode(jq, jpool, layer, jt, jnp.asarray(sl), interpret=True,
                          return_state=True)
    _close(out[live], np.asarray(jo)[live])
    _close(m[live], np.asarray(jm)[live], tol=1e-4)  # |m| ~ 10: 2e-5 relative
    _close(l, jl)
    assert torch.all(m[~live] == -1e30) and torch.all(l[~live] == 0)
    sl1 = sl + 1
    got = paged_flash_decode(tq, tpool, layer, tt, _t(sl1), k_new=tkn, v_new=tvn)
    want = j_decode(jq, jpool, layer, jt, jnp.asarray(sl1), interpret=True, k_new=jkn,
                    v_new=jvn)
    _close(got, want)


@pytest.mark.parametrize("Nq,Hkv", [(6, 2), (16, 1)])
def test_k2_plain_matches_jax_streamed_kernel_at_head_dim_256(monkeypatch, Nq, Hkv):
    """JAX sends D 256 (a multiple of 128) to the streamed kernel,
    ``_flash_prefill_impl``, and never to ``_flash_prefill_vmem``; the port's
    plain version of K2 computes the same function on every valid row."""
    calls = {"impl": 0, "vmem": 0}
    impl, vmem = jap._flash_prefill_impl, jap._flash_prefill_vmem

    def spy_impl(*a, **kw):
        calls["impl"] += 1
        return impl(*a, **kw)

    def spy_vmem(*a, **kw):
        calls["vmem"] += 1
        return vmem(*a, **kw)

    monkeypatch.setattr(jap, "_flash_prefill_impl", spy_impl)
    monkeypatch.setattr(jap, "_flash_prefill_vmem", spy_vmem)
    # A fresh jit of the same function: its cache is empty, so it traces
    # (and reaches the spies) whatever other tests traced before.
    j_prefill = jax.jit(jap.flash_prefill.__wrapped__,
                        static_argnames=("sm_scale", "interpret", "block_q", "block_k"))
    D, B, S = 256, 3, 32
    lens = [32, 13, 1]
    rng = np.random.default_rng(Nq)
    q = rng.standard_normal((B, S, Nq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    sl = np.asarray(lens, np.int32)
    want = j_prefill(*map(jnp.asarray, (q, k, v, sl)), interpret=True, block_q=16, block_k=16)
    assert calls == {"impl": 1, "vmem": 0}
    got = ops.prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    for b, n in enumerate(lens):  # pad rows are never read
        _close(got[b, :n], np.asarray(want)[b, :n], err_msg=f"b={b}")


@pytest.mark.parametrize("kv,D,Nq,Hkv", [c for c in KERNEL_CASES if c[1:] != (128, 12, 1)])
def test_k5_plain_matches_jax_chunked_kernel(kv, D, Nq, Hkv):
    """K5 / K5q's CPU path against the Pallas chunked kernel in interpret
    mode, with the state: histories of 32 and 25 tokens (mid-page), a
    history-only walk and an empty request."""
    from lite_llama_tpu.ops.attention_prefill import flash_prefill_chunked as j_chunked

    rng = np.random.default_rng(D + Nq + 7)
    P, ppr, S, ps = 24, 6, 16, 8
    if kv is None:
        jpool, tpool, _, _, _, _ = _paged_inputs(rng, 1, Nq, Hkv, D, ps, [8], P=P, ppr=ppr)
    else:
        jpool, tpool = _pools(kv, rng, 2, Hkv, D, ps, P)
    hist = np.asarray([32, 25, 0, 0], np.int32)
    clen = np.asarray([16, 0, 9, 0], np.int32)
    B = len(hist)
    table = rng.permutation(P)[: B * ppr].reshape(B, ppr).astype(np.int32)
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    layer = 1
    out, m, l = flash_prefill_chunked(*map(_t, (q, k, v, clen, hist)), tpool, layer, _t(table),
                                      return_state=True)
    jo, jm, jl = j_chunked(*map(jnp.asarray, (q, k, v, clen, hist)), jpool, layer,
                           jnp.asarray(table), interpret=True, block_q=16, block_k=16,
                           return_state=True)
    _close(out, jo)
    _close(m, jm, tol=1e-4)
    _close(l, jl)
    assert torch.all(m[-1] == -1e30) and torch.all(l[-1] == 0) and torch.all(out[-1] == 0)


@pytest.fixture(scope="module", params=list(MODELS))
def weights(request):
    cfg = MODELS[request.param]
    jcfg = JLlama(dtype=jnp.float32, **cfg)
    tcfg = TLlama(dtype=torch.float32, **cfg)
    assert jcfg.head_dim == tcfg.head_dim
    assert (tcfg.head_dim, tcfg.num_kv_groups) in ((256, 2), (16, 12))
    npp = numpy_params(jcfg, seed=43)
    return jcfg, _jax_tree(npp), tcfg, params_from_numpy(npp, tcfg, device="cpu")


@pytest.mark.parametrize("chunk", [None, 8], ids=["one_shot", "chunks_of_8"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_engine_matches_jax(weights, backend, chunk):
    """Greedy generation, 12 new tokens with logprobs, through both engines:
    one shot (fresh prefill: K2 at D 256) or a 19-token prompt in chunks of
    8 (K5 over the pool)."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(ENGINE, **({} if chunk is None else dict(prefill_chunk=chunk)))
    prompts = PROMPTS if chunk is None else CHUNK_PROMPTS
    prev = jops._BACKEND
    jops.set_backend(backend)
    try:
        want = JGen(JEngine(jcfg, jp, **kw)).generate_tokens(
            prompts, max_gen_len=12, temperature=0.0, logprobs=True)
    finally:
        jops.set_backend(prev)
    got = TextGenerator(InferenceEngine(tcfg, tp, device="cpu", **kw)).generate_tokens(
        prompts, max_gen_len=12, temperature=0.0, logprobs=True)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)
