"""The port's paged KV cache against the JAX package's: the same
alloc / write / free sequence gives identical page tables, lengths, free
stacks, stack tops and pool contents, including the sentinel-slot and
out-of-bounds cases that JAX drops or clamps and PyTorch would raise on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402

L, HKV, D, P, PS, M, MAX_SEQ = 2, 2, 8, 16, 4, 4, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fresh():
    j = jkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M,
                            max_seq_len=MAX_SEQ, dtype=jnp.float32)
    t = tkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M,
                            max_seq_len=MAX_SEQ, dtype=torch.float32, device="cpu")
    return j, t


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j.page_table), t.page_table.numpy())
    np.testing.assert_array_equal(np.asarray(j.seq_lens), t.seq_lens.numpy())
    np.testing.assert_array_equal(np.asarray(j.free_stack), t.free_stack.numpy())
    assert int(j.free_top) == int(t.free_top)
    np.testing.assert_array_equal(np.asarray(j.kv_pages.pages), t.kv_pages.pages.numpy())


def _i32(*xs):
    a = np.asarray(xs, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _kv(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_alloc_write_free_sequence_matches_jax():
    rng = np.random.default_rng(0)
    j, t = _fresh()
    _same(j, t)

    # Prefill three requests plus a sentinel slot (== max_reqs): JAX pops its
    # pages and drops its table writes.
    jr, tr = _i32(0, 2, M, 1)
    jl, tl = _i32(5, 9, 3, 4)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    _same(j, t)

    # Prefill K/V for the live rows, with pad positions past each length.
    rows_j, rows_t = _i32(0, 2, 1)
    lens_j, lens_t = _i32(5, 9, 4)
    S = 12
    for layer in range(L):
        jk, tk = _kv(rng, 3, S, HKV, D)
        jv, tv = _kv(rng, 3, S, HKV, D)
        j = type(j)(
            kv_pages=jkv.kv_write_prefill(j.kv_pages, layer, jk, jv, j.page_table[rows_j],
                                          jnp.zeros(3, jnp.int32), lens_j),
            page_table=j.page_table, seq_lens=j.seq_lens, free_stack=j.free_stack,
            free_top=j.free_top,
        )
        tkv.kv_write_prefill(t.kv_pages, layer, tk, tv, t.page_table[rows_t.long()],
                             torch.zeros(3, dtype=torch.int32), lens_t)
    _same(j, t)

    # Decode steps crossing page boundaries; slot 2 goes inactive midway,
    # and its rows of the deferred write are dropped.
    dr_j, dr_t = _i32(0, 2, 1)
    for step in range(6):
        act = np.asarray([True, step < 3, True])
        j = jkv.alloc_decode(j, dr_j, jnp.asarray(act))
        tkv.alloc_decode(t, dr_t, torch.from_numpy(act))
        _same(j, t)
        pos = np.asarray(j.seq_lens)[[0, 2, 1]] - 1
        jk, tk = _kv(rng, L, 3, HKV, D)
        jv, tv = _kv(rng, L, 3, HKV, D)
        jpos, tpos = _i32(*pos)
        j = type(j)(
            kv_pages=jkv.kv_write_decode_all(j.kv_pages, jk, jv, j.page_table[dr_j], jpos,
                                             jnp.asarray(act)),
            page_table=j.page_table, seq_lens=j.seq_lens, free_stack=j.free_stack,
            free_top=j.free_top,
        )
        tkv.kv_write_decode_all(t.kv_pages, tk, tv, t.page_table[dr_t.long()], tpos,
                                torch.from_numpy(act))
        _same(j, t)

    # Free two requests and a sentinel; reuse the pages.
    fr_j, fr_t = _i32(2, M, 0)
    j = jkv.free_requests(j, fr_j)
    tkv.free_requests(t, fr_t)
    _same(j, t)
    jr, tr = _i32(3, 0)
    jl, tl = _i32(7, 13)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    _same(j, t)


def test_finished_request_at_its_last_page():
    """A request whose length fills its whole table row indexes slot == ppr
    in alloc_decode: JAX clamps the read and drops the write."""
    j, t = _fresh()
    full = MAX_SEQ  # ppr * page_size
    jr, tr = _i32(1, 3)
    jl, tl = _i32(full, 6)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    act = np.asarray([False, True])
    for _ in range(3):
        j = jkv.alloc_decode(j, jr, jnp.asarray(act))
        tkv.alloc_decode(t, tr, torch.from_numpy(act))
        _same(j, t)
    # Deferred write at the finished request's position past its last row.
    rng = np.random.default_rng(1)
    jk, tk = _kv(rng, L, 2, HKV, D)
    jv, tv = _kv(rng, L, 2, HKV, D)
    pos = np.asarray(j.seq_lens)[[1, 3]] - 1
    jpos, tpos = _i32(*pos)
    jkvp = jkv.kv_write_decode_all(j.kv_pages, jk, jv, j.page_table[jr], jpos, jnp.asarray(act))
    tkv.kv_write_decode_all(t.kv_pages, tk, tv, t.page_table[tr.long()], tpos,
                            torch.from_numpy(act))
    np.testing.assert_array_equal(np.asarray(jkvp.pages), t.kv_pages.pages.numpy())


def test_kv_cache_bytes_matches_jax():
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        assert jkv.kv_cache_bytes(28, 8, 128, 10, 16, dt_j) == tkv.kv_cache_bytes(
            28, 8, 128, 10, 16, dt_t)


@pytest.mark.parametrize("quantized", [False, "int8"])
def test_allocator_and_writes_keep_every_state_tensor_in_place(quantized):
    """A CUDA graph keeps the addresses it captured, so no update may rebind
    a state tensor: the free-stack top, the stack, the table, the lengths,
    the pool's pages and its scales keep their storage through prefill and
    decode allocation, KV writes, frees, page pushes and re-allocation, with
    the stack top still the JAX allocator's."""
    j = jkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M, max_seq_len=MAX_SEQ,
                            dtype=jnp.float32)
    t = tkv.create_kv_cache(L, HKV, D, P, page_size=PS, max_reqs=M, max_seq_len=MAX_SEQ,
                            dtype=torch.float32, device="cpu", quantized=quantized)
    state = [t.free_top, t.free_stack, t.page_table, t.seq_lens, t.kv_pages.pages]
    if quantized:
        state.append(t.kv_pages.scales)
    ptrs = [x.data_ptr() for x in state]

    def same_state():
        now = [t.free_top, t.free_stack, t.page_table, t.seq_lens, t.kv_pages.pages]
        if quantized:
            now.append(t.kv_pages.scales)
        assert all(a is b for a, b in zip(now, state))
        assert [x.data_ptr() for x in now] == ptrs
        assert int(t.free_top) == int(j.free_top)

    rng = np.random.default_rng(2)
    jr, tr = _i32(0, 2, 1)
    jl, tl = _i32(5, 9, 4)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    same_state()
    for layer in range(L):
        _, tk = _kv(rng, 3, 12, HKV, D)
        _, tv = _kv(rng, 3, 12, HKV, D)
        tkv.kv_write_prefill(t.kv_pages, layer, tk, tv, t.page_table[tr.long()],
                             torch.zeros(3, dtype=torch.int32), tl)
    same_state()
    for step in range(5):
        act = np.asarray([True, step < 2, True])
        j = jkv.alloc_decode(j, jr, jnp.asarray(act))
        tkv.alloc_decode(t, tr, torch.from_numpy(act))
        _, tk = _kv(rng, L, 3, HKV, D)
        _, tv = _kv(rng, L, 3, HKV, D)
        pos = t.seq_lens[tr.long()] - 1
        tkv.kv_write_decode_all(t.kv_pages, tk, tv, t.page_table[tr.long()], pos,
                                torch.from_numpy(act))
        same_state()
    j = jkv.free_requests(j, jr[:2], jnp.asarray([1, 0], jnp.int32))
    tkv.free_requests(t, tr[:2], torch.tensor([1, 0], dtype=torch.int32))
    same_state()
    j = jkv.push_pages(j, jnp.asarray([3, 7], jnp.int32), jnp.asarray([True, False]))
    tkv.push_pages(t, torch.tensor([3, 7], dtype=torch.int32), torch.tensor([True, False]))
    same_state()
    jr, tr = _i32(3)
    jl, tl = _i32(13)
    j = jkv.alloc_prefill(j, jr, jl)
    tkv.alloc_prefill(t, tr, tl)
    same_state()
    np.testing.assert_array_equal(np.asarray(j.free_stack), t.free_stack.numpy())
    np.testing.assert_array_equal(np.asarray(j.page_table), t.page_table.numpy())
