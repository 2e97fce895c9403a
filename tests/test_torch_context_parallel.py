"""The port's context parallelism on the CPU against the JAX package, on the
same numpy inputs (mirrors tests/test_context_parallel.py).

The pool's token rows are sharded over the context ranks; each rank runs the
plain K1 / K5 over its own pages and the ranks' states are combined
(``parallel/context_parallel.py``). The ranks run as gloo processes
(``tests/torch_tp_worker.py``, which imports no JAX): one spawn of 4 ranks
(cp 4) runs the attention cases and two engine cases, one of 2 ranks (cp 2)
an engine case with an int8 pool, chunked prefill and prefix hits; both
start before the JAX side is computed. Gates, fp32:

- decode through the sharded pool equals JAX's reference on the whole pool
  within 1e-4 (and the port's own whole-pool call), on an fp32 and an int8
  pool, a narrow head on an int8 pool, with the virtual newest token, and
  with empty shards and a request on one shard;
- chunked prefill through the sharded pool equals the whole pool's, fp32
  and int8, and with no history;
- the engine at cp 4 and cp 2 gives the greedy tokens of JAX's one-device
  engine (logprobs and first-token logits within 1e-4 of the largest
  logit), its chunked prefill through ``cp_flash_prefill_chunked`` and its
  decode through ``cp_paged_flash_decode``, and the ranks' pools together
  hold JAX's K/V rows of every request;
- in-process: ``local_page_view`` bit-equal to JAX's ``_local_page_view``;
  two halves' states combined equal the whole; the engine refuses cp with
  dp or tp, and the attention a pool that is not the rank's share.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops.ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu.parallel.context_parallel import _local_page_view  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.executor.kv_cache import KVPool  # noqa: E402
from lite_llama_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    combine_decode_splits,
    paged_flash_decode,
)
from lite_llama_tpu_torch.ops.attention_prefill import flash_prefill_chunked  # noqa: E402
from lite_llama_tpu_torch.parallel import context_parallel as cpm  # noqa: E402
from lite_llama_tpu_torch.parallel.shardings import Mesh, ShardingPolicy  # noqa: E402
from tests.test_attention_kernels import build_paged_kv  # noqa: E402
from tests.test_context_parallel import _chunk_history_fixture  # noqa: E402
from tests.test_torch_dp import collect_ranks, jax_reference, spawn_mesh, worker_case  # noqa
from tests.test_torch_tp import TOL, same_stream  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

CP_CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, vocab_size=97, max_seq_len=128,
              eos_token_id=96)
CP_ENGINE = dict(page_size=8, max_reqs=2, num_pages=64, decode_chunk=4)
_rng = np.random.default_rng(7)
SHORT = [_rng.integers(0, 96, size=n).tolist() for n in (37, 22)]
LONG = [_rng.integers(0, 96, size=n).tolist() for n in (70, 45)]
SYS = _rng.integers(0, 96, size=24).tolist()  # three pages of 8
PREFIX_ROUNDS = [[SYS + [1, 2, 3]], [SYS + [4, 5, 6, 7], SYS + [9]]]
# case -> (config class, fields, seed, quantize kwargs, engine kwargs, prompts, rounds); the
# engine keywords extend CP_ENGINE.
CP4 = {
    "cp4": ("LlamaConfig", CP_CFG, 0, None, {}, SHORT, 1),
    "cp4_chunked": ("LlamaConfig", CP_CFG, 1, None, dict(prefill_chunk=32), LONG, 1),
}
CP2 = {"cp2_int8_prefix": ("LlamaConfig", CP_CFG, 2, None,
                           dict(kv_quant="int8", prefill_chunk=16, prefix_cache=True),
                           PREFIX_ROUNDS[0], PREFIX_ROUNDS)}
TOL_ATTN = 1e-4


def _engine_spec(spec):
    cls, fields, seed, quant, ekw, prompts, rounds = spec
    return (cls, fields, seed, quant, dict(CP_ENGINE, **ekw), prompts, rounds)


# ---------------------------------------------------------------------------
# Attention cases: numpy inputs, JAX's reference on the whole pool


def _np_pool(pool):
    """A JAX KVPool's arrays as numpy (fp32 pages, or int8 + fp32 scales)."""
    pages = np.asarray(pool.pages)
    pages = pages if pages.dtype == np.int8 else pages.astype(np.float32)
    return pages, None if pool.scales is None else np.asarray(pool.scales, np.float32)


def decode_ops():
    """{name: (op description, arrays, JAX reference [layers, B, Nq, D])}."""
    ops = {}

    def add(name, key, B, Nq, Hkv, D, ps, L, Pg, ppr, lens, quantized=False, table=None,
            virtual=False):
        pool, tbl = build_paged_kv(jax.random.PRNGKey(key), L, Hkv, Pg, ps, D, B, ppr, lens,
                                   quantized=quantized)
        if table is not None:
            tbl = jnp.asarray(table, jnp.int32)
        lens_a = jnp.asarray(lens, jnp.int32)
        q = jax.random.normal(jax.random.PRNGKey(key + 1), (B, Nq, D), jnp.float32)
        arrays = {"q": np.asarray(q), "table": np.asarray(tbl), "lens": np.asarray(lens_a)}
        arrays["pages"], scales = _np_pool(pool)
        if scales is not None:
            arrays["scales"] = scales
        layers = list(range(L))
        if virtual:
            kn = jax.random.normal(jax.random.PRNGKey(key + 2), (B, Hkv, D), jnp.float32)
            vn = jax.random.normal(jax.random.PRNGKey(key + 3), (B, Hkv, D), jnp.float32)
            arrays["k_new"], arrays["v_new"] = np.asarray(kn), np.asarray(vn)
            want = [j_decode(q, pool, li, tbl, lens_a, interpret=True, k_new=kn, v_new=vn)
                    for li in layers]
        else:
            want = [jref.paged_decode_attention(q, pool, li, tbl, lens_a, ppr * ps)
                    for li in layers]
        op = dict(name=name, kind="decode", page_size=ps, hkv=Hkv, d=D, layers=layers,
                  quantized=bool(quantized), virtual=virtual)
        ops[name] = (op, arrays, np.stack([np.asarray(w) for w in want]))

    # Pages spread over the 4 shards (the table is a permutation); a one-token
    # and a page-boundary request.
    add("decode_fp32", 0, 3, 8, 2, 128, 16, 2, 32, 8, [33, 1, 48])
    add("decode_int8", 10, 3, 8, 2, 128, 16, 2, 32, 8, [33, 1, 48], quantized=True)
    add("decode_int8_narrow", 20, 2, 8, 2, 64, 16, 2, 32, 8, [47, 16], quantized=True)
    add("decode_virtual", 30, 2, 8, 2, 128, 16, 2, 32, 8, [34, 17], virtual=True)
    # Request 0 on shard 0 alone, request 1 empty: three empty shards each.
    add("decode_empty_shards", 40, 2, 4, 2, 128, 16, 1, 8, 4, [32, 0],
        table=[[0, 1, 0, 0], [0, 0, 0, 0]])
    return ops


def chunked_ops():
    ops = {}

    def add(name, key, lens_total, S_hist, S_c, quantized=False):
        B, Hkv, D, ps, Pg = 2, 2, 128, 16, 32
        cache, req, q, k_c, v_c, chunk_lens, hist_lens = _chunk_history_fixture(
            jax.random.PRNGKey(key), B, Hkv, D, ps, Pg, lens_total, S_hist, S_c,
            quantized=quantized)
        table = cache.page_table[req]
        want = [jref.chunked_prefill_attention(q, k_c, v_c, chunk_lens, hist_lens,
                                               cache.kv_pages, li, table) for li in (0, 1)]
        arrays = {"q": np.asarray(q), "k": np.asarray(k_c), "v": np.asarray(v_c),
                  "chunk_lens": np.asarray(chunk_lens), "start_pos": np.asarray(hist_lens),
                  "table": np.asarray(table)}
        arrays["pages"], scales = _np_pool(cache.kv_pages)
        if scales is not None:
            arrays["scales"] = scales
        op = dict(name=name, kind="chunked", page_size=ps, hkv=Hkv, d=D, layers=[0, 1],
                  quantized=bool(quantized))
        ops[name] = (op, arrays, np.stack([np.asarray(w) for w in want]))

    # One request wholly in its history (an empty chunk).
    add("chunked_fp32", 0, [40, 25], 32, 16)
    add("chunked_int8", 5, [40, 25], 32, 16, quantized=True)
    add("chunked_no_history", 3, [20, 32], 0, 32)
    return ops


def _port_pool(op, arrays):
    pages = torch.from_numpy(arrays["pages"])
    scales = torch.from_numpy(arrays["scales"]).to(torch.bfloat16) if op["quantized"] else None
    return KVPool(pages=pages, page_size=op["page_size"], num_kv_heads=op["hkv"],
                  head_dim=op["d"], scales=scales)


def whole_pool(op, arrays):
    """The port's own call on the whole pool (one device)."""
    t = {k: torch.from_numpy(v) for k, v in arrays.items() if k not in ("pages", "scales")}
    pool = _port_pool(op, arrays)
    res = []
    for li in op["layers"]:
        if op["kind"] == "decode":
            kw = dict(k_new=t["k_new"], v_new=t["v_new"]) if op.get("virtual") else {}
            res.append(paged_flash_decode(t["q"], pool, li, t["table"], t["lens"], **kw))
        else:
            res.append(flash_prefill_chunked(t["q"], t["k"], t["v"], t["chunk_lens"],
                                             t["start_pos"], pool, li, t["table"]))
    return torch.stack(res).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (reference, [rank outputs])} for the attention and engine cases."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("cp")
    ops = {**decode_ops(), **chunked_ops()}
    np.savez(tmp / "ops.npz", **{f"{n}/{k}": a for n, (_, arrs, _) in ops.items()
                                 for k, a in arrs.items()})
    specs4 = {"ops": dict(kind="cp_ops", inputs=str(tmp / "ops.npz"),
                          ops=[op for op, _, _ in ops.values()])}
    jax_side = {}
    for name, spec in CP4.items():
        specs4[name], *jax_side[name] = worker_case(tmp, name, _engine_spec(spec))
    specs2 = {}
    for name, spec in CP2.items():
        specs2[name], *jax_side[name] = worker_case(tmp, name, _engine_spec(spec))
    started = [spawn_mesh(tmp, "cp4", 4, specs4, {"cp": 4}),
               spawn_mesh(tmp, "cp2", 2, specs2, {"cp": 2})]
    want = {"ops": {n: (op, arrs, ref) for n, (op, arrs, ref) in ops.items()}}
    for name, spec in {**CP4, **CP2}.items():
        jcfg, jtree = jax_side[name]
        want[name] = jax_reference(_engine_spec(spec), jtree, jcfg)
    got = collect_ranks(*started[0], ["ops", *CP4])
    got.update(collect_ranks(*started[1], list(CP2)))
    return {k: (want[k], got[k]) for k in want}


@pytest.mark.parametrize("name", ["decode_fp32", "decode_int8", "decode_int8_narrow",
                                  "decode_virtual", "decode_empty_shards", "chunked_fp32",
                                  "chunked_int8", "chunked_no_history"])
def test_cp_attention_matches_the_whole_pool(runs, name):
    """Every rank holds the same combined result (the combine runs in rank
    order on every rank), within 1e-4 of JAX's reference on the whole pool
    and of the port's own whole-pool call; finite, also for the empty
    request (m = -1e30, l = 0 on every rank)."""
    want, ranks = runs["ops"]
    op, arrays, ref = want[name]
    got = [d[name] for d in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert np.isfinite(got[0]).all()
    whole = whole_pool(op, arrays)
    np.testing.assert_allclose(got[0], whole, rtol=TOL_ATTN, atol=TOL_ATTN)
    # JAX's reference is NaN for an empty request (its own test skips it);
    # the port's whole-pool call above holds it.
    rows = arrays["lens"] > 0 if op["kind"] == "decode" else slice(None)
    np.testing.assert_allclose(got[0][:, rows], ref[:, rows], rtol=TOL_ATTN, atol=TOL_ATTN)


@pytest.mark.parametrize("name", ["cp4", "cp4_chunked", "cp2_int8_prefix"])
def test_engine_at_cp_matches_jax(runs, name):
    """Greedy tokens of JAX's one-device engine, logprobs and first-token
    logits within TOL; the decoder went through the context-parallel
    attention (decode always, chunked prefill where a prompt chunks or hits
    a prefix); the ranks' pools together hold JAX's K/V rows of every
    request, each rank pages of every request (the allocator deals them
    round-robin), and every rank's table is the same."""
    want, ranks = runs[name]
    spec = {**CP4, **CP2}[name]
    rounds = spec[6]
    same_stream(want, ranks, rounds=len(rounds) if isinstance(rounds, list) else rounds)
    cp = len(ranks)
    ps = CP_ENGINE["page_size"]

    def rows_of(pages, table, slots, seq_lens):  # each request's K/V rows, in order
        return np.concatenate([pages[:, :, [table[s, t // ps] * ps + t % ps
                                            for t in range(seq_lens[s])]]
                               for s in slots], axis=2)

    whole_pool = np.concatenate([d["prefill_pages"] for d in ranks], axis=2)
    assert whole_pool.shape == want["prefill_pages"].shape
    d0 = ranks[0]
    whole = rows_of(whole_pool, d0["prefill_table"], [int(s) for s in d0["admitted"][0]],
                    d0["prefill_seq_lens"])
    want_rows = rows_of(want["prefill_pages"], want["prefill_table"], want["admitted"][0],
                        want["prefill_seq_lens"])
    for c, d in enumerate(ranks):
        assert tuple(d["place"][[1, 4]]) == (c, cp)
        decode_calls, chunked_calls = (int(n) for n in d["cp_calls"])
        assert decode_calls > 0
        assert (chunked_calls > 0) == (name != "cp4")
    for d in ranks:  # the allocator is whole on every rank; each rank holds pages of each
        np.testing.assert_array_equal(d["prefill_table"], d0["prefill_table"])
    owner = d0["prefill_table"] // (CP_ENGINE["num_pages"] // cp)
    for s in (int(s) for s in d0["admitted"][0]):
        n = -(-int(d0["prefill_seq_lens"][s]) // ps)
        assert len(set(owner[s, :n].tolist())) == min(n, cp)
    if spec[4].get("kv_quant"):
        assert np.abs(whole - want_rows).max() <= 1  # an int8 rounding step
        assert int(ranks[0]["prefix_hits"]) == want["prefix_hits"] >= 2
    else:
        np.testing.assert_allclose(whole, want_rows, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# In-process


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_page_view_is_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    B, ppr, ps, P, N = 5, 8, 16, 32, 4
    table = np.stack([rng.permutation(P)[:ppr] for _ in range(B)]).astype(np.int32)
    lens = rng.integers(0, ppr * ps + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 0, ps * 3  # an empty request and a full tail page
    for idx in range(N):
        jt, jl = _local_page_view(jnp.asarray(table), jnp.asarray(lens), ps, P // N, idx)
        tt, tl = cpm.local_page_view(torch.from_numpy(table), torch.from_numpy(lens), ps,
                                     P // N, idx)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    total = sum(cpm.local_page_view(torch.from_numpy(table), torch.from_numpy(lens), ps,
                                    P // N, i)[1] for i in range(N))
    np.testing.assert_array_equal(total.numpy(), lens)  # the shares make up each length


def test_two_halves_combined_equal_the_whole():
    """K1's plain state over each half's compacted view, combined in order,
    is the whole pool's result; a rank owning none of a request's pages
    contributes nothing (and no NaN)."""
    torch.set_num_threads(1)
    pool, table = build_paged_kv(jax.random.PRNGKey(3), 1, 2, 16, 16, 64, 3, 4, [50, 7, 0])
    pages, _ = _np_pool(pool)
    tpool = KVPool(pages=torch.from_numpy(pages), page_size=16, num_kv_heads=2, head_dim=64)
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4, 64)).astype(np.float32))
    tbl = torch.from_numpy(np.asarray(table))
    lens = torch.tensor([50, 7, 0], dtype=torch.int32)
    want = paged_flash_decode(q, tpool, 0, tbl, lens, return_state=True)
    states = []
    for c in range(2):
        half = KVPool(pages=tpool.pages[:, :, c * 128:(c + 1) * 128].contiguous(), page_size=16,
                      num_kv_heads=2, head_dim=64, page_offset=c * 8, total_pages=16)
        pt, ln = cpm.local_page_view(tbl, lens, 16, 8, c)
        states.append(paged_flash_decode(q, half, 0, pt, ln, return_state=True))
    out, m, l = combine_decode_splits(states)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[:2].numpy(), want[0][:2].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), want[2].numpy(), rtol=1e-5, atol=1e-6)
    assert not out[2].any() and not l[2].any()


def test_cp_refuses_a_pool_that_is_not_the_rank_s_share():
    """A whole pool, or another rank's share, given to a context rank raises
    before any collective (JAX's placement check)."""
    pool, table = build_paged_kv(jax.random.PRNGKey(0), 1, 2, 16, 16, 128, 2, 4, [33, 9])
    pages, _ = _np_pool(pool)
    whole = KVPool(pages=torch.from_numpy(pages), page_size=16, num_kv_heads=2, head_dim=128)
    q = torch.zeros((2, 8, 128))
    lens = torch.tensor([33, 9], dtype=torch.int32)
    shard = ShardingPolicy(Mesh(cp=4, cp_rank=1))
    with pytest.raises(ValueError, match="context rank 1 of 4"):
        cpm.cp_paged_flash_decode(q, whole, 0, torch.from_numpy(np.asarray(table)), lens, shard)
    other = KVPool(pages=whole.pages[:, :, :64].contiguous(), page_size=16, num_kv_heads=2,
                   head_dim=128, page_offset=0, total_pages=16)  # rank 0's share
    with pytest.raises(ValueError, match="must hold pages \\[4, 8\\)"):
        cpm.cp_flash_prefill_chunked(torch.zeros((2, 4, 8, 128)), torch.zeros((2, 4, 2, 128)),
                                     torch.zeros((2, 4, 2, 128)), lens, lens, other, 0,
                                     torch.from_numpy(np.asarray(table)), shard)


@pytest.mark.parametrize("mesh", [Mesh(cp=2, dp=2), Mesh(cp=2, tp=2)], ids=["dp", "tp"])
def test_cp_engine_refuses_dp_and_tp(mesh):
    cfg = tconfig.LlamaConfig(dtype=torch.float32, **CP_CFG)
    params = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cp mesh axis"):
        InferenceEngine(cfg, params, device="cpu", mesh=mesh, **CP_ENGINE)
