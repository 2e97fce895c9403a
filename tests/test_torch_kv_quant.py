"""int8 and fp8 KV pools in the port against the JAX package on the CPU:

1. ``_quantize_kv``, ``kv_write_prefill`` and ``kv_write_decode_all`` leave
   pools and scale slabs bit-equal to JAX's after the same writes (the JAX
   writes run under jit, as in its engine);
2. K1q's plain version (``paged_decode_state_plain`` on an int8 pool, the
   score-domain dequant) against ``paged_flash_decode(interpret=True)``,
   out, m and l, at D=16 and 64, and on an fp8 pool;
3. K5q's plain version (``chunked_prefill_state_plain`` on an int8 pool,
   whole-row history dequant) against ``flash_prefill_chunked
   (interpret=True)`` at D=16 and 64; on an fp8 pool against JAX's
   reference, where the JAX dispatcher sends fp8 pools;
4. the plain reference forms (``ops/ref.py``, the CPU path of the engine)
   against JAX's references on int8 and fp8 pools.

Tolerance 2e-5 in fp32 (summation order), 1e-4 on m (|m| ~ 10), as for the
bf16 pools in tests/test_torch_ops.py; bit-equal for pool contents.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu.ops.attention_prefill import (  # noqa: E402
    flash_prefill_chunked as j_chunked,
)
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.ops import ref  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    launch_paged_decode_int8,
    paged_flash_decode,
)
from lite_llama_tpu_torch.ops.attention_prefill import (  # noqa: E402
    flash_prefill_chunked,
    launch_flash_prefill_chunked_int8,
)

TOL = 2e-5
JPOOL = {"int8": True, "fp8": "fp8"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, **kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _tbits(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def _same_pools(tpool, jpool):
    np.testing.assert_array_equal(_tbits(tpool.pages), _bits(jpool.pages))
    if jpool.scales is None:
        assert tpool.scales is None
    else:
        np.testing.assert_array_equal(tpool.scales.float().numpy(),
                                      np.asarray(jpool.scales, np.float32))


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 4, 16)).astype(np.float32) * 2
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-6 floor
    jqv, jsc = jax.jit(jkv._quantize_kv)(jnp.asarray(x))
    tqv, tsc = tkv._quantize_kv(_t(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.float().numpy(), np.asarray(jsc, np.float32))
    assert tsc.dtype == torch.bfloat16


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_kv_writes_are_bit_equal_to_jax(kv):
    L, Hkv, D, P, ps = 2, 2, 16, 12, 4
    rng = np.random.default_rng(1)
    jc = jkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=4, max_seq_len=16,
                             quantized=JPOOL[kv])
    tc = tkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=4, max_seq_len=16,
                             device="cpu", quantized=kv)
    _same_pools(tc.kv_pages, jc.kv_pages)
    assert tc.kv_pages.quantized == jc.kv_pages.quantized
    table = rng.permutation(P)[:8].reshape(2, 4).astype(np.int32)
    # fp8: values past +-448 saturate; int8: any magnitude
    k = (rng.standard_normal((2, 6, Hkv, D)) * 300).astype(np.float32)
    v = rng.standard_normal((2, 6, Hkv, D)).astype(np.float32)
    start, lens = np.asarray([0, 5], np.int32), np.asarray([6, 3], np.int32)
    jp = jc.kv_pages
    for layer in (0, 1):
        jp = jax.jit(jkv.kv_write_prefill, static_argnums=1)(
            jp, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(start),
            jnp.asarray(lens))
        tkv.kv_write_prefill(tc.kv_pages, layer, _t(k), _t(v), _t(table), _t(start), _t(lens))
        _same_pools(tc.kv_pages, jp)
    ka = (rng.standard_normal((L, 2, Hkv, D)) * 500).astype(np.float32)
    va = rng.standard_normal((L, 2, Hkv, D)).astype(np.float32)
    pos = np.asarray([6, 9], np.int32)
    for active in (None, np.asarray([True, False])):
        ja = None if active is None else jnp.asarray(active)
        jp = jax.jit(jkv.kv_write_decode_all)(jp, jnp.asarray(ka), jnp.asarray(va),
                                              jnp.asarray(table), jnp.asarray(pos), ja)
        tkv.kv_write_decode_all(tc.kv_pages, _t(ka), _t(va), _t(table), _t(pos),
                                None if active is None else _t(active))
        _same_pools(tc.kv_pages, jp)
        ka, pos = ka * 0.5, pos + 1


def test_int8_pool_refuses_wide_mha():
    with pytest.raises(ValueError, match="num_kv_heads"):
        tkv.create_kv_cache(1, 65, 16, 4, page_size=4, device="cpu", quantized="int8")
    with pytest.raises(ValueError):
        tkv.create_kv_cache(1, 2, 16, 4, page_size=4, device="cpu", quantized="int4")


def _pools(kv, rng, L, Hkv, D, ps, P):
    """A pool written through both frameworks' prefill writes (so the int8
    values and scales are real quantizer output), random page order."""
    jc = jkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=P, max_seq_len=P * ps,
                             quantized=JPOOL[kv])
    tc = tkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=P, max_seq_len=P * ps,
                             device="cpu", quantized=kv)
    table = rng.permutation(P).reshape(1, P).astype(np.int32)
    k = rng.standard_normal((1, P * ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((1, P * ps, Hkv, D)).astype(np.float32)
    z, n = np.zeros(1, np.int32), np.asarray([P * ps], np.int32)
    jp = jc.kv_pages
    for layer in range(L):
        jp = jax.jit(jkv.kv_write_prefill, static_argnums=1)(
            jp, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(z),
            jnp.asarray(n))
        tkv.kv_write_prefill(tc.kv_pages, layer, _t(k), _t(v), _t(table), _t(z), _t(n))
    _same_pools(tc.kv_pages, jp)
    return jp, tc.kv_pages


DECODE_CASES = [  # (kv, B, Nq, Hkv, D, page_size, lens)
    ("int8", 4, 8, 2, 16, 4, [17, 0, 8, 1]),
    ("int8", 3, 8, 4, 64, 8, [33, 1, 0]),
    ("fp8", 3, 8, 2, 64, 8, [20, 9, 0]),
]


@pytest.mark.parametrize("kv,B,Nq,Hkv,D,ps,lens", DECODE_CASES)
def test_k1q_plain_matches_jax_kernel_and_ref(kv, B, Nq, Hkv, D, ps, lens):
    rng = np.random.default_rng(4)
    P = 24
    jpool, tpool = _pools(kv, rng, 2, Hkv, D, ps, P)
    ppr = 6
    table = rng.permutation(P)[: B * ppr].reshape(B, ppr).astype(np.int32)
    q = rng.standard_normal((B, Nq, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    jq, jt, jsl = map(jnp.asarray, (q, table, sl))
    tq, tt, tsl = map(_t, (q, table, sl))
    live = sl > 0
    layer = 1
    out, m, l = paged_flash_decode(tq, tpool, layer, tt, tsl, return_state=True)
    jo, jm, jl = j_decode(jq, jpool, layer, jt, jsl, interpret=True, return_state=True)
    _close(out[live], np.asarray(jo)[live])
    _close(m[live], np.asarray(jm)[live], tol=1e-4)
    _close(l, jl)
    assert torch.all(m[~live] == -1e30) and torch.all(l[~live] == 0)
    assert torch.all(out[~live] == 0)
    # The newest token folded in at full precision, as the kernel does.
    sl1 = sl + 1
    got = paged_flash_decode(tq, tpool, layer, tt, _t(sl1), k_new=_t(kn), v_new=_t(vn))
    want = j_decode(jq, jpool, layer, jt, jnp.asarray(sl1), interpret=True,
                    k_new=jnp.asarray(kn), v_new=jnp.asarray(vn))
    _close(got, want)
    # The plain reference form (gather, dequantize, mask) against JAX's.
    got = ref.paged_decode_attention(tq, tpool, layer, tt, tsl)
    want = jref.paged_decode_attention(jq, jpool, layer, jt, jsl)
    _close(got[live], np.asarray(want)[live])


CHUNK_CASES = [  # (kv, Nq, Hkv, D, page_size)
    ("int8", 8, 8, 16, 16),  # D=16 packs 8 heads per 128 lanes in the TPU kernel
    ("int8", 4, 2, 64, 16),
    ("fp8", 4, 2, 64, 16),
]


@pytest.mark.parametrize("kv,Nq,Hkv,D,ps", CHUNK_CASES)
def test_k5q_plain_matches_jax_kernel_and_ref(kv, Nq, Hkv, D, ps):
    rng = np.random.default_rng(5)
    P, ppr, S = 24, 6, 16
    jpool, tpool = _pools(kv, rng, 2, Hkv, D, ps, P)
    hist = np.asarray([32, 25, 0, 0], np.int32)
    clen = np.asarray([16, 0, 9, 0], np.int32)  # a history-only walk, an empty request
    B = len(hist)
    table = rng.permutation(P)[: B * ppr].reshape(B, ppr).astype(np.int32)
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    args_j = (*map(jnp.asarray, (q, k, v, clen, hist)), jpool)
    args_t = (*map(_t, (q, k, v, clen, hist)), tpool)
    live = (hist + clen) > 0
    layer = 1
    out, m, l = flash_prefill_chunked(*args_t, layer, _t(table), return_state=True)
    want = jref.chunked_prefill_attention(*args_j, layer, jnp.asarray(table))
    _close(out[live], np.asarray(want)[live])
    assert torch.all(m[-1] == -1e30) and torch.all(l[-1] == 0) and torch.all(out[-1] == 0)
    if kv == "int8":  # the JAX dispatcher sends fp8 pools to its reference, above
        jo, jm, jl = j_chunked(*args_j, layer, jnp.asarray(table), interpret=True, block_q=16,
                               block_k=16, return_state=True)
        _close(out, jo)
        _close(m, jm, tol=1e-4)
        _close(l, jl)
    got = ref.chunked_prefill_attention(*args_t, layer, _t(table))
    _close(got[live], np.asarray(want)[live])


def test_quantized_pools_on_the_cpu_launch_nothing():
    rng = np.random.default_rng(6)
    _, tpool = _pools("int8", rng, 1, 2, 16, 4, 8)
    before = (launch_paged_decode_int8.launches, launch_flash_prefill_chunked_int8.launches)
    table = _t(np.arange(8, dtype=np.int32).reshape(1, 8))
    paged_flash_decode(torch.randn(1, 4, 16), tpool, 0, table, _t(np.asarray([9], np.int32)))
    one = _t(np.asarray([4], np.int32))
    flash_prefill_chunked(torch.randn(1, 4, 4, 16), torch.randn(1, 4, 2, 16),
                          torch.randn(1, 4, 2, 16), one, one, tpool, 0, table)
    assert (launch_paged_decode_int8.launches,
            launch_flash_prefill_chunked_int8.launches) == before
