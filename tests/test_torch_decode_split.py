"""The split plan of K1 / K1q (flash decoding, csrc/paged_decode.cu) on the
CPU: ``plan_decode_splits`` from static shapes, ``decode_spans`` (the split
the kernel decides from kv_len on the device), and the split algebra — the
plain version run on each split's span, its partials combined in split
order by ``combine_decode_splits``, equals the unsplit plain version within
1e-6 in fp32 (the same exp2-domain sums, regrouped) and the JAX package's
``paged_flash_decode`` (Pallas, interpret mode) and reference within the
2e-5 that tests/test_torch_ops.py holds the port's ops to. The kernel itself
runs only on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor.kv_cache import KVPool as JKVPool  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    DECODE_MAX_SPLITS,
    combine_decode_splits,
    decode_spans,
    paged_decode_state_plain,
    plan_decode_splits,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("table_width,page_size", [
    (128, 16),  # the engine's table at Llama-3.2-3B's 2048 positions, pages of 16
    (8, 7),  # a page size that does not divide the least span
    (300, 80),
    (1, 16),  # a table of one page
])
@pytest.mark.parametrize("slots", [1, 50, 200])
def test_spans_cover_every_token_once_in_whole_pages(table_width, page_size, slots):
    """Every kv_len the table can reach, beside a long and an empty request:
    each request's live splits are at most s_max and no more than spans of
    min_span pages need, start on page boundaries, are non-empty and cover
    [0, kv_len) exactly once, in order; the items fit the grid's slots
    unless every request has only one."""
    plan = plan_decode_splits(table_width, page_size)
    assert 1 <= plan.s_max <= DECODE_MAX_SPLITS and plan.min_span >= 1
    reach = table_width * page_size
    for kv_len in range(0, reach + 1, max(1, reach // 400)):
        lens = [kv_len, reach, 0]
        all_spans = decode_spans(lens, page_size, plan.s_max, plan.min_span, slots)
        assert all_spans[2] == []
        for n, spans in zip(lens, all_spans):
            assert len(spans) <= min(plan.s_max, _cdiv(_cdiv(n, page_size), plan.min_span))
            ends = [0] + [t1 for _, t1 in spans]
            assert ends[-1] == n, n  # contiguous from 0 to kv_len: each token once
            for (t0, t1), start in zip(spans, ends):
                assert t0 == start and t0 % page_size == 0 and t1 > t0
        n_items = sum(len(sp) for sp in all_spans)
        assert n_items <= max(slots, sum(1 for n in lens if n))


def test_plan_reads_no_tensor_value():
    """The plan takes ints (shapes); handed the shapes of tensors on the
    meta device, which hold no values, it gives the same plan."""
    table = torch.empty((64, 128), dtype=torch.int32, device="meta")
    plan = plan_decode_splits(table.shape[1], 16)
    assert plan == plan_decode_splits(128, 16)
    assert plan.s_max > 1  # a long request splits
    assert plan_decode_splits(8, 16).s_max == 1  # a reach of one least span never does


def test_spans_at_the_decode_batch_and_serving_width():
    """12 x 88 tokens take one split each (a split would cost a combine and
    gain nothing at 6 pages); serving's 8 x 1,820 tokens among 64 slots
    share the grid's 50 slots (an H100's at D 128), 6 splits each."""
    plan = plan_decode_splits(128, 16)
    assert decode_spans([88] * 12, 16, plan.s_max, plan.min_span, 50) == [[(0, 88)]] * 12
    spans = decode_spans([1820] * 8 + [0] * 56, 16, plan.s_max, plan.min_span, 50)
    assert [len(sp) for sp in spans] == [6] * 8 + [0] * 56
    assert spans[0][-1][1] == 1820


def _pool(rng, B, Hkv, D, ps, lens, ppr, P):
    pool = rng.standard_normal((2, 2, P * ps, Hkv * D), np.float32)
    perm = rng.permutation(P)
    table = np.zeros((B, ppr), np.int32)
    idx = 0
    for b in range(B):
        n = _cdiv(int(lens[b]), ps)
        table[b, :n] = perm[idx: idx + n]
        idx += n
    return pool, table


def _split_plain(q, pages, ps, layer, table, lens, scale, s_max, min_span, slots):
    """The plain version on each split's span (the table from its first
    page), combined in split order; an empty request keeps the empty state."""
    outs, ms, ls = [], [], []
    all_spans = decode_spans(lens.tolist(), ps, s_max, min_span, slots)
    for b, spans in enumerate(all_spans):
        parts = []
        for t0, t1 in spans:
            parts.append(paged_decode_state_plain(
                q[b:b + 1], pages, ps, layer, table[b:b + 1, t0 // ps:].contiguous(),
                torch.tensor([t1 - t0], dtype=torch.int32), scale))
        if not parts:
            parts = [paged_decode_state_plain(q[b:b + 1], pages, ps, layer, table[b:b + 1],
                                              torch.zeros(1, dtype=torch.int32), scale)]
        o, m, l = combine_decode_splits(parts)
        outs.append(o)
        ms.append(m)
        ls.append(l)
    return torch.cat(outs), torch.cat(ms), torch.cat(ls)


@pytest.mark.parametrize("B,Nq,Hkv,D,ps,lens,plan", [
    (4, 8, 2, 128, 8, [17, 0, 8, 1], (3, 1, 50)),  # one-page spans, an empty request
    (3, 12, 4, 64, 16, [100, 1, 0], (4, 2, 50)),  # 100 tokens: 4 splits of 2 pages, the last short
    (3, 6, 3, 100, 7, [50, 14, 6], (16, 1, 4)),  # D 100, pages of 7, the slots' share binds
])
def test_split_algebra_equals_unsplit_plain_and_jax(B, Nq, Hkv, D, ps, lens, plan):
    rng = np.random.default_rng(21)
    ppr = max(_cdiv(n, ps) for n in lens) + 2
    P = sum(_cdiv(n, ps) for n in lens) + 3
    pool, table = _pool(rng, B, Hkv, D, ps, lens, ppr, P)
    q = rng.standard_normal((B, Nq, D), np.float32)
    sl = np.asarray(lens, np.int32)
    tq, tp, tt, tl = (torch.from_numpy(x) for x in (q, pool, table, sl))
    scale = D**-0.5
    assert any(len(sp) > 1 for sp in decode_spans(lens, ps, *plan))
    for layer in (0, 1):
        got = _split_plain(tq, tp, ps, layer, tt, tl, scale, *plan)
        want = paged_decode_state_plain(tq, tp, ps, layer, tt, tl, scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
        meta = dict(page_size=ps, num_kv_heads=Hkv, head_dim=D)
        jpool = JKVPool(pages=jnp.asarray(pool), scales=None, **meta)
        jo, jm, jl = j_decode(*map(jnp.asarray, (q,)), jpool, layer, jnp.asarray(table),
                              jnp.asarray(sl), interpret=True, return_state=True)
        live = sl > 0
        np.testing.assert_allclose(got[0].numpy()[live], np.asarray(jo)[live], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy()[live], np.asarray(jm)[live], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
        jr = jref.paged_decode_attention(jnp.asarray(q), jpool, layer, jnp.asarray(table),
                                         jnp.asarray(sl))
        np.testing.assert_allclose(got[0].numpy()[live], np.asarray(jr)[live], rtol=2e-5,
                                   atol=2e-5)
        assert torch.all(got[1][~torch.from_numpy(live)] == -1e30)
        assert torch.all(got[2][~torch.from_numpy(live)] == 0)
