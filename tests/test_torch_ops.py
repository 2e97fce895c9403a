"""The port's ops (lite_llama_tpu_torch.ops) against the JAX package: the
plain PyTorch versions against ``lite_llama_tpu.ops.ref`` and against the
Pallas kernels in interpret mode, on the CPU, with the same numpy inputs.

fp32 tolerance 2e-5, as tests/test_attention_kernels.py uses for kernels
against their references (different summation orders). The kernels
themselves run only on the card: tests/test_torch_kernels_cuda.py and
chip_smoke.py hold them against these plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor.kv_cache import KVPool as JKVPool  # noqa: E402
from lite_llama_tpu.ops import norms as jnorms  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_decode import (  # noqa: E402
    fold_new_token as j_fold,
    paged_flash_decode as j_decode,
)
from lite_llama_tpu.ops.attention_prefill import flash_prefill as j_prefill  # noqa: E402
from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.executor.kv_cache import KVPool  # noqa: E402
from lite_llama_tpu_torch.ops import norms, ref  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    paged_flash_decode,
)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, **kw)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Norms and SwiGLU (K3, K4 plain versions)


@pytest.mark.parametrize("shape", [(4, 7, 128), (37, 96)])
def test_norms_and_swiglu_match_jax(shape):
    rng = np.random.default_rng(0)
    x, r, g, u = (rng.standard_normal(shape, np.float32) for _ in range(4))
    w = rng.standard_normal(shape[-1:], np.float32)
    jx, jr, jw, jg, ju = map(jnp.asarray, (x, r, w, g, u))

    got = ops.rms_norm(_t(x), _t(w), 1e-5)
    _close(got, jref.rms_norm(jx, jw, 1e-5))
    _close(got, jnorms.rms_norm(jx, jw, 1e-5, interpret=True))

    n, s = ops.skip_rms_norm(_t(x), _t(r), _t(w), 1e-5)
    jn, js = jref.skip_rms_norm(jx, jr, jw, 1e-5)
    _close(n, jn)
    _close(s, js)
    pn, ps_ = jnorms.skip_rms_norm(jx, jr, jw, 1e-5, interpret=True)
    _close(n, pn)
    _close(s, ps_)

    n0, s0 = ops.skip_rms_norm(_t(x), None, _t(w), 1e-5)
    _close(n0, jnorms.rms_norm(jx, jw, 1e-5, interpret=True))
    assert torch.equal(s0, _t(x))

    got = ops.swiglu(_t(g), _t(u))
    _close(got, jref.swiglu(jg, ju))
    _close(got, jnorms.swiglu(jg, ju, interpret=True))


def test_skip_rms_norm_bf16_rounds_the_sum_like_the_reference():
    """In bf16 the port follows ops/ref.py (what the JAX main path runs):
    the residual sum is rounded to bf16 and that rounded sum is normalised.
    The Pallas kernel normalises the unrounded fp32 sum; the two differ by
    that rounding only, well inside one bf16 step of the output."""
    rng = np.random.default_rng(1)
    x, r = (rng.standard_normal((16, 256), np.float32) for _ in range(2))
    w = rng.standard_normal((256,), np.float32)
    bf = jnp.bfloat16
    jx, jr, jw = (jnp.asarray(a, bf) for a in (x, r, w))
    tx, tr, tw = (_t(a).to(torch.bfloat16) for a in (x, r, w))
    n, s = ops.skip_rms_norm(tx, tr, tw, 1e-5)
    jn, js = jref.skip_rms_norm(jx, jr, jw, 1e-5)
    np.testing.assert_array_equal(_np(s.float()), _np(js))
    # Same math, torch vs XLA on the CPU: within one bf16 rounding step.
    _close(n.float(), jn.astype(jnp.float32), tol=8e-3)
    pn, ps_ = jnorms.skip_rms_norm(jx, jr, jw, 1e-5, interpret=True)
    np.testing.assert_array_equal(_np(s.float()), _np(ps_))
    _close(n.float(), pn.astype(jnp.float32), tol=1.6e-2)


# ---------------------------------------------------------------------------
# RoPE


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 5, 3, 16
    pos = rng.integers(0, 1000, (B, S)).astype(np.int32)
    inv = (1.0 / 10000 ** (np.arange(0, D, 2) / D)).astype(np.float32)
    inv_b = np.stack([inv, inv * 0.5]).astype(np.float32)  # per-request tables
    x = rng.standard_normal((B, S, H, D), np.float32)
    for table in (inv, inv_b):
        c, s = ref.rope_cos_sin(_t(pos), _t(table), 1.25)
        jc, js = jref.rope_cos_sin(jnp.asarray(pos), jnp.asarray(table), 1.25)
        _close(c, jc)
        _close(s, js)
        _close(ref.apply_rope(_t(x), c, s), jref.apply_rope(jnp.asarray(x), jc, js))


# ---------------------------------------------------------------------------
# Prefill attention (K2 plain version)


@pytest.mark.parametrize(
    "B,S,Nq,Hkv,D,lens",
    [(3, 32, 4, 2, 128, [32, 9, 0]), (2, 64, 8, 2, 64, [40, 64])],
)
def test_prefill_attention_matches_jax(B, S, Nq, Hkv, D, lens):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, Nq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    sl = np.asarray(lens, np.int32)
    got = ops.prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    want = jref.prefill_attention(*map(jnp.asarray, (q, k, v, sl)))
    kern = j_prefill(*map(jnp.asarray, (q, k, v, sl)), interpret=True)
    for b in range(B):  # pad rows are never read
        n = lens[b]
        _close(got[b, :n], want[b, :n], err_msg=f"ref b={b}")
        _close(got[b, :n], kern[b, :n], err_msg=f"pallas b={b}")


# ---------------------------------------------------------------------------
# Paged decode attention (K1 plain version) and the new-token fold


def _paged_inputs(rng, B, Nq, Hkv, D, ps, lens, L=2, P=24, ppr=6):
    pool = rng.standard_normal((L, 2, P * ps, Hkv * D), np.float32)
    perm = rng.permutation(P)
    table = np.zeros((B, ppr), np.int32)
    idx = 0
    for b in range(B):
        n = -(-int(lens[b]) // ps)
        table[b, :n] = perm[idx: idx + n]
        idx += n
    q = rng.standard_normal((B, Nq, D), np.float32)
    k_new = rng.standard_normal((B, Hkv, D), np.float32)
    v_new = rng.standard_normal((B, Hkv, D), np.float32)
    meta = dict(page_size=ps, num_kv_heads=Hkv, head_dim=D)
    jpool = JKVPool(pages=jnp.asarray(pool), scales=None, **meta)
    tpool = KVPool(pages=_t(pool), **meta)
    return jpool, tpool, table, q, k_new, v_new


@pytest.mark.parametrize(
    "B,Nq,Hkv,D,ps,lens",
    [(4, 8, 2, 128, 8, [17, 0, 8, 1]), (3, 12, 4, 64, 16, [33, 1, 0])],
)
def test_paged_decode_matches_jax(B, Nq, Hkv, D, ps, lens):
    """Against the Pallas kernel (interpret) with and without the new-token
    fold and with return_state, and against the JAX reference; lens include
    an empty slot, a one-token request and a page boundary."""
    rng = np.random.default_rng(4)
    jpool, tpool, table, q, kn, vn = _paged_inputs(rng, B, Nq, Hkv, D, ps, lens)
    sl = np.asarray(lens, np.int32)
    jq, jt, jsl, jkn, jvn = map(jnp.asarray, (q, table, sl, kn, vn))
    tq, tt, tsl, tkn, tvn = map(_t, (q, table, sl, kn, vn))
    for layer in (0, 1):
        # Pool-only attention with the online-softmax state.
        out, m, l = paged_flash_decode(tq, tpool, layer, tt, tsl, return_state=True)
        jo, jm, jl = j_decode(jq, jpool, layer, jt, jsl, interpret=True, return_state=True)
        live = sl > 0
        _close(out[live], np.asarray(jo)[live])
        _close(m[live], np.asarray(jm)[live], tol=1e-4)  # |m| ~ 10: 2e-5 relative
        _close(l, jl)
        empty = ~live
        assert torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
        assert torch.all(out[empty] == 0)
        _close(paged_flash_decode(tq, tpool, layer, tt, tsl), jo)
        _close(out[live], np.asarray(jref.paged_decode_attention(jq, jpool, layer, jt, jsl))[live])
        # Virtual-page protocol: seq_lens include the new token.
        sl1 = sl + 1
        got = paged_flash_decode(tq, tpool, layer, tt, _t(sl1), k_new=tkn, v_new=tvn)
        kern = j_decode(jq, jpool, layer, jt, jnp.asarray(sl1), interpret=True,
                        k_new=jkn, v_new=jvn)
        want = jref.paged_decode_attention(jq, jpool, layer, jt, jnp.asarray(sl1),
                                           k_new=jkn, v_new=jvn)
        _close(got, kern)
        _close(got, want)


@pytest.mark.parametrize(
    "B,Nq,Hkv,D,ps,lens",
    [(4, 8, 2, 128, 8, [17, 0, 8, 1]), (3, 12, 4, 64, 16, [33, 1, 0])],
)
def test_ref_paged_decode_attention_matches_jax_and_k1_plain(B, Nq, Hkv, D, ps, lens):
    """The port's gather-then-mask reference (ops/ref.py) against the JAX
    reference and against the K1 path's plain version (online-softmax state
    plus the new-token fold), with and without the new token."""
    rng = np.random.default_rng(8)
    jpool, tpool, table, q, kn, vn = _paged_inputs(rng, B, Nq, Hkv, D, ps, lens)
    sl = np.asarray(lens, np.int32)
    live = sl > 0  # an empty slot has no key to attend without the new token
    jq, jt, jkn, jvn = map(jnp.asarray, (q, table, kn, vn))
    tq, tt, tkn, tvn = map(_t, (q, table, kn, vn))
    for layer in (0, 1):
        got = ref.paged_decode_attention(tq, tpool, layer, tt, _t(sl))
        want = jref.paged_decode_attention(jq, jpool, layer, jt, jnp.asarray(sl))
        _close(got[live], np.asarray(want)[live])
        _close(got[live], paged_flash_decode(tq, tpool, layer, tt, _t(sl))[live])
        sl1 = sl + 1
        got = ref.paged_decode_attention(tq, tpool, layer, tt, _t(sl1), sm_scale=0.3,
                                         k_new=tkn, v_new=tvn)
        want = jref.paged_decode_attention(jq, jpool, layer, jt, jnp.asarray(sl1),
                                           sm_scale=0.3, k_new=jkn, v_new=jvn)
        _close(got, want)
        _close(got, paged_flash_decode(tq, tpool, layer, tt, _t(sl1), 0.3,
                                       k_new=tkn, v_new=tvn))


def test_fold_new_token_matches_jax_and_returns_v_for_empty_state():
    rng = np.random.default_rng(5)
    B, Nq, Hkv, D = 3, 6, 2, 16
    out = rng.standard_normal((B, Nq, D), np.float32)
    m = rng.standard_normal((B, Nq), np.float32) * 3
    l = rng.uniform(0.5, 4.0, (B, Nq)).astype(np.float32)
    m[0], l[0] = -1e30, 0.0  # empty partial
    q = rng.standard_normal((B, Nq, D), np.float32)
    kn = rng.standard_normal((B, Hkv, D), np.float32)
    vn = rng.standard_normal((B, Hkv, D), np.float32)
    got = ref.fold_new_token(*map(_t, (out, m, l, q, kn, vn)), 0.25)
    want = j_fold(*map(jnp.asarray, (out, m, l, q, kn, vn)), 0.25)
    _close(got, want)
    np.testing.assert_array_equal(got[0].numpy(), np.repeat(vn[0], Nq // Hkv, axis=0))


def test_gather_kv_pages_matches_jax():
    rng = np.random.default_rng(6)
    jpool, tpool, table, *_ = _paged_inputs(rng, 2, 4, 2, 16, 4, [9, 5])
    for layer in (0, 1):
        k, v = ref.gather_kv_pages(tpool, layer, _t(table), 12)
        jk, jv = jref.gather_kv_pages(jpool, layer, jnp.asarray(table), 12)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counters stay put."""
    from lite_llama_tpu_torch.ops.attention_decode import launch_paged_decode
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill

    before = (launch_paged_decode.launches, launch_flash_prefill.launches,
              norms.launch_rms_norm.launches, norms.launch_swiglu.launches)
    rng = np.random.default_rng(7)
    jpool, tpool, table, q, kn, vn = _paged_inputs(rng, 2, 4, 2, 64, 8, [5, 9])
    paged_flash_decode(_t(q), tpool, 0, _t(table), _t(np.asarray([6, 10], np.int32)),
                       k_new=_t(kn), v_new=_t(vn))
    x = torch.randn(3, 8, 4, 64)
    ops.prefill_attention(x, x[:, :, :2], x[:, :, :2], torch.tensor([8, 3, 1]))
    ops.skip_rms_norm(x, x, torch.ones(64))
    ops.swiglu(x, x)
    after = (launch_paged_decode.launches, launch_flash_prefill.launches,
             norms.launch_rms_norm.launches, norms.launch_swiglu.launches)
    assert after == before


def test_launch_counters_name_every_wrapper_and_add_a_replays_launches():
    """``ops.launch_counters`` covers each kernel wrapper's counter, and
    ``add_launches`` (a replayed graph's count) adds launches x replays to
    exactly the counters named."""
    from lite_llama_tpu_torch.ops import add_launches, launch_counters, launch_counts
    from lite_llama_tpu_torch.ops.attention_decode import launch_paged_decode

    counters = launch_counters()
    assert counters["paged_flash_decode"] == (launch_paged_decode, "launches")
    assert counters["rms_norm_int8_rows"] == (norms.launch_rms_norm, "int8_launches")
    assert counters["rms_norm_no_residual"] == (norms.launch_rms_norm, "no_residual_launches")
    assert len({(id(fn), attr) for fn, attr in counters.values()}) == len(counters)
    before = launch_counts()
    try:
        add_launches({"paged_flash_decode": 2, "swiglu_int8_rows": 1}, 3)
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "paged_flash_decode": 6, "swiglu_int8_rows": 3}
    finally:
        add_launches({"paged_flash_decode": 2, "swiglu_int8_rows": 1}, -3)
    assert launch_counts() == before
