"""Chunked prefill in the port against the JAX package on the CPU, with the
same numpy inputs:

1. the port's plain ``chunked_prefill_attention`` (ops/ref.py) against
   JAX's, in its dense form and in the form that streams the history in
   blocks, and against full-sequence attention;
2. the CPU path of K5 (``flash_prefill_chunked``, its plain version with
   the online-softmax state) against the JAX Pallas kernel in interpret
   mode, out and (m, l), D=64 with Hkv=2, including a request that lies
   wholly inside its history (chunk_lens = 0) and an empty one;
3. the KV cache's prefix-splicing allocation, keep-pages free and page
   pushes, bit-equal to JAX's on the same call sequence;
4. ``decoder_prefill`` in chunks against the JAX decoder in chunks and
   against one single-shot call.

Tolerances: 2e-5 for fp32 ops (different summation orders), 1e-4 for
decoder logits, bit-equal for cache state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_prefill import (  # noqa: E402
    flash_prefill_chunked as j_chunked,
)
from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.ops import ref  # noqa: E402
from lite_llama_tpu_torch.ops.attention_prefill import (  # noqa: E402
    flash_prefill_chunked,
    launch_flash_prefill_chunked,
)
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _configs, _jax_tree, numpy_params  # noqa: E402

TOL = 2e-5
CASES = [  # (total lengths, tokens already in the pool per request, chunk width)
    ([40, 25], [32, 25], 16),   # both have history; the second is wholly inside it
    ([40, 10], [32, 10], 16),   # a short request wholly inside its history
    ([33, 48, 16], [32, 32, 0], 16),  # a fresh request beside two with history
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, **kw)


def _inputs(seed, lens_total, hist, S_c, Nq=4, Hkv=2, D=64, ps=16, L=2, P=24, ppr=6):
    """A random pool whose pages are handed out in shuffled order, a chunk of
    queries/keys/values per request, and both frameworks' pool objects."""
    rng = np.random.default_rng(seed)
    B = len(lens_total)
    pool = rng.standard_normal((L, 2, P * ps, Hkv * D)).astype(np.float32)
    table = rng.permutation(P)[: B * ppr].reshape(B, ppr).astype(np.int32)
    q = rng.standard_normal((B, S_c, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S_c, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S_c, Hkv, D)).astype(np.float32)
    start = np.asarray(hist, np.int32)
    clen = np.clip(np.asarray(lens_total) - start, 0, S_c).astype(np.int32)
    meta = dict(page_size=ps, num_kv_heads=Hkv, head_dim=D)
    jpool = jkv.KVPool(pages=jnp.asarray(pool), scales=None, **meta)
    tpool = tkv.KVPool(pages=_t(pool), **meta)
    return jpool, tpool, table, q, k, v, clen, start


@pytest.mark.parametrize("lens_total,hist,S_c", CASES)
@pytest.mark.parametrize("max_hist_len", [None, 4096], ids=["dense", "streamed"])
def test_ref_chunked_matches_jax_ref(lens_total, hist, S_c, max_hist_len):
    """Both forms of the plain version against JAX's: ``None`` gathers the
    whole page-table span densely, 4096 (> HIST_BLOCK) streams two blocks."""
    jpool, tpool, table, q, k, v, clen, start = _inputs(0, lens_total, hist, S_c)
    for layer in (0, 1):
        got = ref.chunked_prefill_attention(*map(_t, (q, k, v, clen, start)), tpool, layer,
                                            _t(table), max_hist_len=max_hist_len)
        want = jref.chunked_prefill_attention(*map(jnp.asarray, (q, k, v, clen, start)),
                                              jpool, layer, jnp.asarray(table),
                                              max_hist_len=max_hist_len)
        _close(got, want, err_msg=f"layer {layer}")
        _close(got, ops.chunked_prefill_attention(*map(_t, (q, k, v, clen, start)), tpool,
                                                  layer, _t(table)))


def test_ref_chunked_equals_full_attention():
    """Ground truth: the history written through the port's cache, then a
    chunk over it, equals ragged causal attention over the whole sequence
    (mirrors tests/test_chunked_prefill.py)."""
    rng = np.random.default_rng(1)
    B, S_hist, S_c, Hkv, Nq, D, ps = 2, 32, 16, 2, 4, 64, 16
    lens = np.asarray([40, 25], np.int32)
    cache = tkv.create_kv_cache(1, Hkv, D, 64, page_size=ps, max_reqs=B,
                                max_seq_len=S_hist + S_c, dtype=torch.float32, device="cpu")
    req = torch.arange(B, dtype=torch.int32)
    tkv.alloc_prefill(cache, req, _t(lens))
    qf, kf, vf = (rng.standard_normal((B, S_hist + S_c, n, D)).astype(np.float32)
                  for n in (Nq, Hkv, Hkv))
    hist = np.minimum(lens, S_hist)
    table = cache.page_table[req.long()]
    tkv.kv_write_prefill(cache.kv_pages, 0, _t(kf[:, :S_hist]), _t(vf[:, :S_hist]), table,
                         torch.zeros(B, dtype=torch.int32), _t(hist))
    clen = np.clip(lens - S_hist, 0, S_c)
    got = ref.chunked_prefill_attention(_t(qf[:, S_hist:]), _t(kf[:, S_hist:]),
                                        _t(vf[:, S_hist:]), _t(clen), _t(hist),
                                        cache.kv_pages, 0, table)
    want = ref.prefill_attention(_t(qf), _t(kf), _t(vf), _t(lens))
    for b in range(B):
        n = int(clen[b])
        _close(got[b, :n], want[b, hist[b]: hist[b] + n], err_msg=f"b={b}")


@pytest.mark.parametrize("lens_total,hist,S_c", CASES)
def test_k5_plain_matches_jax_pallas_kernel(lens_total, hist, S_c):
    """K5's CPU path (the plain version the card's kernel is held against)
    against the Pallas kernel in interpret mode, with return_state: out,
    m and l on every row, empty requests included."""
    lens_total = list(lens_total) + [0]  # an empty request: no history, no chunk
    hist = list(hist) + [0]
    jpool, tpool, table, q, k, v, clen, start = _inputs(2, lens_total, hist, S_c)
    for layer in (0, 1):
        out, m, l = flash_prefill_chunked(*map(_t, (q, k, v, clen, start)), tpool, layer,
                                          _t(table), return_state=True)
        jo, jm, jl = j_chunked(*map(jnp.asarray, (q, k, v, clen, start)), jpool, layer,
                               jnp.asarray(table), interpret=True, block_q=16, block_k=16,
                               return_state=True)
        _close(out, jo, err_msg=f"out layer {layer}")
        _close(m, jm, tol=1e-4, err_msg=f"m layer {layer}")  # |m| ~ 10: 1e-5 relative
        _close(l, jl, err_msg=f"l layer {layer}")
        assert torch.all(m[-1] == -1e30) and torch.all(l[-1] == 0) and torch.all(out[-1] == 0)
        _close(flash_prefill_chunked(*map(_t, (q, k, v, clen, start)), tpool, layer,
                                     _t(table)), jo)
        # The chunk-free row of a request with history walks the history only.
        live = np.asarray(lens_total) > 0
        _close(out[live], ref.chunked_prefill_attention(
            *map(_t, (q, k, v, clen, start)), tpool, layer, _t(table))[live])


def test_k5_cpu_tensors_take_the_plain_version():
    before = launch_flash_prefill_chunked.launches
    jpool, tpool, table, q, k, v, clen, start = _inputs(3, [20, 5], [16, 5], 8)
    ops.chunked_prefill_attention(*map(_t, (q, k, v, clen, start)), tpool, 0, _t(table))
    flash_prefill_chunked(*map(_t, (q, k, v, clen, start)), tpool, 0, _t(table))
    assert launch_flash_prefill_chunked.launches == before


def _same_cache(j, t):
    np.testing.assert_array_equal(np.asarray(j.page_table), t.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(j.seq_lens), t.seq_lens.numpy())
    np.testing.assert_array_equal(np.asarray(j.free_stack), t.free_stack.numpy())
    assert int(j.free_top) == int(t.free_top)


def test_prefix_alloc_keep_free_and_push_match_jax():
    """Splice shared pages into new requests, free with kept leading pages,
    evict the kept pages with push_pages, reuse: bit-equal cache state."""
    L, Hkv, D, P, ps, M, max_seq = 1, 2, 8, 32, 4, 4, 32
    j = jkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=M, max_seq_len=max_seq,
                            dtype=jnp.float32)
    t = tkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=M, max_seq_len=max_seq,
                            dtype=torch.float32, device="cpu")

    def both(*a, dtype=np.int32):
        x = np.asarray(a, dtype)
        return jnp.asarray(x), torch.from_numpy(x)

    ppr = max_seq // ps
    jr, tr = both(0, 1)
    jl, tl = both(13, 6)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    _same_cache(j, t)
    shared = t.page_table[0, :3].numpy().copy()
    # Slot 0 ends keeping its 3 full pages (a donated prefix); slot 1 frees all.
    jk, tk = both(3, 0)
    j = jkv.free_requests(j, jr, jk)
    tkv.free_requests(t, tr, tk)
    _same_cache(j, t)
    # Two requests splice the three shared pages, a third has none.
    rows = np.zeros((3, ppr), np.int32)
    rows[0, :3] = shared
    rows[1, :2] = shared[:2]
    jr, tr = both(2, 3, 0)
    jl, tl = both(20, 9, 5)
    jpp, tpp = both(3, 2, 0)
    j = jkv.alloc_prefill(j, jr, jl, jnp.asarray(rows), jpp)
    tkv.alloc_prefill(t, tr, tl, torch.from_numpy(rows), tpp)
    _same_cache(j, t)
    # Free them keeping the shared pages, then evict those pages.
    j = jkv.free_requests(j, jr, jpp)
    tkv.free_requests(t, tr, tpp)
    _same_cache(j, t)
    pages = np.concatenate([shared, np.zeros(2, np.int32)])
    valid = np.asarray([True, True, True, False, False])
    j = jkv.push_pages(j, jnp.asarray(pages), jnp.asarray(valid))
    tkv.push_pages(t, torch.from_numpy(pages), torch.from_numpy(valid))
    _same_cache(j, t)
    assert int(t.free_top) == P


@pytest.mark.parametrize("name", ["llama_untied", "llama_d64"])
def test_decoder_prefill_in_chunks_matches_jax_and_single_shot(name):
    """Three chunks of width 8 over prompts of 21 and 9 tokens (the second
    is wholly consumed by the second chunk): each chunk's last-position
    logits against the JAX decoder's, the pools after every chunk, and the
    final logits against one single-shot prefill."""
    jcfg, tcfg = _configs(name)
    npp = numpy_params(jcfg, seed=5)
    jp, tp = _jax_tree(npp), params_from_numpy(npp, tcfg, device="cpu")
    D, W, ps = jcfg.head_dim, 8, 4
    lens = np.asarray([21, 9], np.int32)
    ids = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    slots = np.asarray([2, 0], np.int32)

    def caches():
        j = jkv.create_kv_cache(2, 2, D, 40, page_size=ps, max_reqs=4, max_seq_len=32,
                                dtype=jnp.float32)
        t = tkv.create_kv_cache(2, 2, D, 40, page_size=ps, max_reqs=4, max_seq_len=32,
                                dtype=torch.float32, device="cpu")
        j = jkv.alloc_prefill(j, jnp.asarray(slots), jnp.asarray(lens))
        tkv.alloc_prefill(t, torch.from_numpy(slots), torch.from_numpy(lens))
        return j, t

    jc, tc = caches()
    jtab, ttab = jc.page_table[jnp.asarray(slots)], tc.page_table[torch.from_numpy(slots).long()]
    last = np.zeros((2, jcfg.vocab_size), np.float32)
    for ci in range(3):
        start = np.full(2, ci * W, np.int32)
        hist = np.minimum(lens, start)
        clen = np.clip(lens - start, 0, W).astype(np.int32)
        bound = int(min(-(-int(hist.max()) // ps), 8) * ps)
        chunk = ids[:, ci * W:(ci + 1) * W]
        jctx = jdec.AttnContext(jtab, jnp.asarray(lens), jnp.asarray(hist), jnp.asarray(clen))
        tctx = tdec.AttnContext(ttab, _t(lens), _t(hist), _t(clen))
        jl, jpool = jdec.decoder_prefill(jp, jcfg, jc.kv_pages, jctx, input_ids=jnp.asarray(chunk),
                                         chunked=True, last_only=True, hist_bound=bound)
        tl, _ = tdec.decoder_prefill(tp, tcfg, tc.kv_pages, tctx, _t(chunk).long(),
                                     last_only=True, chunked=True, hist_bound=bound)
        jc = type(jc)(kv_pages=jpool, page_table=jc.page_table, seq_lens=jc.seq_lens,
                      free_stack=jc.free_stack, free_top=jc.free_top)
        live = clen > 0
        _close(tl[live], np.asarray(jl)[live], tol=1e-4, err_msg=f"chunk {ci}")
        _close(tc.kv_pages.pages, jc.kv_pages.pages, tol=1e-4)
        ends = (lens > start) & (lens <= start + W)
        last[ends] = tl.numpy()[ends]
    _, tc1 = caches()
    ctx = tdec.AttnContext(tc1.page_table[torch.from_numpy(slots).long()], _t(lens),
                           torch.zeros(2, dtype=torch.int32), _t(lens))
    single, _ = tdec.decoder_prefill(tp, tcfg, tc1.kv_pages, ctx, _t(ids[:, :21]).long(),
                                     last_only=True)
    _close(last, single, tol=1e-4)
