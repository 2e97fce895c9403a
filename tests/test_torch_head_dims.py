"""Head dims the TPU cannot pack into 128 lanes (D = 40, 100, and D = 64
with one kv head), on the CPU, against the JAX package with the same numpy
inputs:

1. K8's plain version (``ops.prefill_attention`` on CPU tensors) against
   JAX ``flash_prefill(interpret=True)``, which at these shapes takes
   ``_flash_prefill_vmem`` (a spy checks it);
2. K1's plain path with the newest-token fold against JAX
   ``paged_flash_decode(interpret=True)``, whose wide form takes any D;
3. greedy generation of a tiny D = 40 model through the port's engine
   against the JAX engine under both of its backends (XLA, and Pallas in
   interpret mode, where fresh prefill runs ``_flash_prefill_vmem``), one
   shot and in chunks of 8 tokens.

Tolerances: 2e-5 for fp32 ops (different summation orders), 1e-4 for
logprobs; greedy tokens equal. The card's side of the same head dims is in
tests/test_torch_kernels_cuda.py.
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
from lite_llama_tpu_torch.ops.attention_decode import paged_flash_decode  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402
from tests.test_torch_ops import _paged_inputs  # noqa: E402

TOL = 2e-5
# A tiny Llama with head dim 40 (hidden 120 over 3 query heads, one kv head).
CFG = dict(hidden_size=120, intermediate_size=160, num_hidden_layers=2, num_attention_heads=3,
           num_key_value_heads=1, vocab_size=97, max_seq_len=64, eos_token_id=96)
ENGINE = dict(page_size=8, max_reqs=4, num_pages=32, decode_chunk=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17, 18, 19]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol, **kw)


@pytest.mark.parametrize("D,Hkv,Nq", [(40, 2, 4), (64, 1, 3), (100, 2, 2)])
def test_k8_plain_matches_jax_vmem_kernel(monkeypatch, D, Hkv, Nq):
    """The JAX dispatcher sends these shapes to _flash_prefill_vmem (D does
    not divide 128, or D = 64 with a kv head count that does not pair up);
    the port's plain version of K8 computes the same function."""
    calls = []
    vmem = jap._flash_prefill_vmem

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return vmem(*a, **kw)

    monkeypatch.setattr(jap, "_flash_prefill_vmem", spy)
    # A fresh jit of the same function: its cache is empty, so it traces
    # (and reaches the spy) whatever other tests traced before.
    j_prefill = jax.jit(jap.flash_prefill.__wrapped__,
                        static_argnames=("sm_scale", "interpret", "block_q", "block_k"))
    rng = np.random.default_rng(D)
    B, S = 2, 32
    lens = [32, 13]
    q = rng.standard_normal((B, S, Nq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    sl = np.asarray(lens, np.int32)
    want = j_prefill(*map(jnp.asarray, (q, k, v, sl)), interpret=True)
    assert calls == [(B, S, Nq, D)]
    got = ops.prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    for b, n in enumerate(lens):  # pad rows are never read
        _close(got[b, :n], np.asarray(want)[b, :n], err_msg=f"b={b}")


@pytest.mark.parametrize("D", [40, 100])
def test_k1_plain_with_fold_matches_jax_kernel(D):
    """K1's CPU path (the plain version plus the newest-token fold) against
    the JAX decode kernel in interpret mode, with and without the new token
    and with the online-softmax state."""
    B, Nq, Hkv, ps, lens = 3, 4, 2, 8, [17, 0, 8]
    rng = np.random.default_rng(D + 1)
    jpool, tpool, table, q, kn, vn = _paged_inputs(rng, B, Nq, Hkv, D, ps, lens)
    sl = np.asarray(lens, np.int32)
    live = sl > 0
    jq, jt, jkn, jvn = map(jnp.asarray, (q, table, kn, vn))
    tq, tt, tkn, tvn = map(_t, (q, table, kn, vn))
    for layer in (0, 1):
        out, m, l = paged_flash_decode(tq, tpool, layer, tt, _t(sl), return_state=True)
        jo, jm, jl = j_decode(jq, jpool, layer, jt, jnp.asarray(sl), interpret=True,
                              return_state=True)
        _close(out[live], np.asarray(jo)[live])
        _close(m[live], np.asarray(jm)[live], tol=1e-4)  # |m| ~ 10: 2e-5 relative
        _close(l, jl)
        sl1 = sl + 1
        got = paged_flash_decode(tq, tpool, layer, tt, _t(sl1), k_new=tkn, v_new=tvn)
        want = j_decode(jq, jpool, layer, jt, jnp.asarray(sl1), interpret=True,
                        k_new=jkn, v_new=jvn)
        _close(got, want)


@pytest.fixture(scope="module")
def weights():
    jcfg = JLlama(dtype=jnp.float32, **CFG)
    tcfg = TLlama(dtype=torch.float32, **CFG)
    assert jcfg.head_dim == tcfg.head_dim == 40
    npp = numpy_params(jcfg, seed=41)
    return jcfg, _jax_tree(npp), tcfg, params_from_numpy(npp, tcfg, device="cpu")


def _generate(weights, backend, prompts=PROMPTS, **engine_kw):
    """(JAX outputs under ``backend``, the port's outputs) for ``prompts``,
    greedy, 12 new tokens, with logprobs."""
    jcfg, jp, tcfg, tp = weights
    kw = dict(ENGINE, **engine_kw)
    prev = jops._BACKEND
    jops.set_backend(backend)
    try:
        want = JGen(JEngine(jcfg, jp, **kw)).generate_tokens(
            prompts, max_gen_len=12, temperature=0.0, logprobs=True)
    finally:
        jops.set_backend(prev)
    got = TextGenerator(InferenceEngine(tcfg, tp, device="cpu", **kw)).generate_tokens(
        prompts, max_gen_len=12, temperature=0.0, logprobs=True)
    return want, got


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_head_dim_40_engine_matches_jax(weights, backend, monkeypatch):
    calls = []
    vmem = jap._flash_prefill_vmem
    monkeypatch.setattr(jap, "_flash_prefill_vmem",
                        lambda *a, **kw: calls.append(a[0].shape) or vmem(*a, **kw))
    want, got = _generate(weights, backend)
    assert bool(calls) == (backend == "pallas")  # JAX's prefill took the VMEM kernel
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)


def test_head_dim_40_chunked_prefill_matches_jax(weights):
    """A 19-token prompt in chunks of 8 (the port's chunked path, K5's plain
    version at D = 40; the JAX package's XLA reference, to which its
    dispatcher sends an unpackable chunk) against the JAX engine."""
    want, got = _generate(weights, "xla", [list(range(20, 39)), [5, 6, 7]], prefill_chunk=8)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)
