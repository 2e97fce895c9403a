"""Context parallelism: the paged KV pool's token rows sharded over the cp
ranks (port of ``lite_llama_tpu/parallel/context_parallel.py``).

Tensor parallelism splits attention by kv head, which caps at
``num_key_value_heads`` ranks and leaves each rank reading the whole
sequence; context parallelism splits the pool itself, so each rank reads
only the pages it owns: 1/cp of a long context's KV bytes.

- Context rank c holds pages ``[c * P/cp, (c+1) * P/cp)`` of the global
  page ids (its ``KVPool`` has ``page_offset = c * P/cp`` and
  ``total_pages = P``); the page table, the lengths and the allocator stay
  whole and identical on every rank, so page ids stay global and the
  allocator is unchanged. The KV writes drop the rows of other ranks
  (``executor/kv_cache.py``).
- Online softmax does not care about the order of the tokens, so each rank
  runs the unchanged one-device kernel (K1 / K1q, K5 / K5q) with
  ``return_state`` over a compacted view of its own pages
  (:func:`local_page_view`): a request's owned full pages first, then its
  tail page, with a local length of ``ps * full + tail count`` (the tail's
  count only where the rank owns the tail), so the kernel's length mask
  hides exactly the tail's padding.
- The ranks' states ``(out, m, l)`` meet in one all-gather of their bytes
  per call and every rank combines them in rank order (``combine_decode_splits``), so
  every rank holds bit-identical results (the host replication of the
  sampled tokens relies on it). JAX combines with a pmax and two psums; the
  algebra is the same. A rank that owns none of a request's pages holds
  ``m = -1e30, l = 0``: a term of weight 0.
- Decode's newest token is not in the pool (the virtual-token protocol):
  it is folded in after the combine (``fold_new_token``). Chunked prefill
  scores the chunk's own keys on rank 0 only; the others pass
  ``chunk_lens = 0``, which makes their call a walk over their history
  (K5's header).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..executor.kv_cache import KVPool
from ..ops.attention_decode import combine_decode_splits, paged_flash_decode
from ..ops.attention_prefill import flash_prefill_chunked
from ..ops.ref import fold_new_token
from . import distributed


def local_page_view(page_table: torch.Tensor, kv_lens: torch.Tensor, page_size: int,
                    pages_loc: int, idx: int):
    """(local table [B, ppr] int32, local lengths [B] int32) of context rank
    ``idx``, which owns global pages ``[idx * pages_loc, (idx+1) *
    pages_loc)``: each request's owned pages among its first
    ``cdiv(kv_lens, ps)``, full pages first and the tail page last, rebased
    to local page ids; entries past them are clamped into range, and the
    kernel reads none of them."""
    B, ppr = page_table.shape
    ps = page_size
    lo = idx * pages_loc
    kv_lens = kv_lens.to(torch.int32)
    n_pages = (kv_lens + ps - 1) // ps
    j = torch.arange(ppr, dtype=torch.int32, device=page_table.device)[None, :]
    valid = j < n_pages[:, None]
    owned = valid & (page_table >= lo) & (page_table < lo + pages_loc)
    is_tail = j == (n_pages - 1)[:, None]
    full = owned & ~is_tail
    tail_owned = owned & is_tail
    # Ascending keys: full pages in order, then the tail, then the rest.
    key = torch.where(full, j, torch.where(tail_owned, ppr + j, 2 * ppr + j))
    order = torch.argsort(key, dim=1)
    local_pt = torch.gather(page_table, 1, order) - lo
    local_pt = local_pt.clamp(0, pages_loc - 1).to(torch.int32)
    tail_count = kv_lens - (n_pages - 1) * ps  # ps where the length fills its last page
    local_len = (full.sum(dim=1, dtype=torch.int32) * ps
                 + torch.where(tail_owned.any(dim=1), tail_count, torch.zeros_like(tail_count)))
    return local_pt, local_len.to(torch.int32)


def rank_share(kv_pool: KVPool, shard) -> int:
    """The pages a context rank holds, after checking that ``kv_pool`` is
    exactly this rank's share of the whole pool (the counterpart of JAX's
    placement check): a whole pool, or another rank's, would give a wrong
    result with no error."""
    ps = kv_pool.page_size
    total = kv_pool.total_pages or kv_pool.num_tokens // ps
    n, c = shard.cp, shard.cp_rank
    loc = total // n
    if total % n or kv_pool.num_tokens != loc * ps or kv_pool.page_offset != c * loc:
        raise ValueError(
            f"the pool holds {kv_pool.num_tokens // ps} pages from page {kv_pool.page_offset} "
            f"of {total}: context rank {c} of {n} must hold pages [{c * loc}, "
            f"{(c + 1) * loc}) (create_kv_cache(..., cp=(rank, size)))")
    return loc


def combine_ranks(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor, shard):
    """The LSE combine of every context rank's state ``(out, m, l)`` in rank
    order, after one all-gather of their bytes (out in its own dtype, m and
    l in fp32): bit-identical on every rank."""
    if shard.cp == 1:
        return out, m, l
    tensors = (out, m, l)
    packed = torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in tensors])
    parts = distributed.all_gather_stack(packed, shard.mesh.cp_group)
    states = []
    for p in parts:
        state, at = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            state.append(p[at:at + n].view(t.dtype).view(t.shape))
            at += n
        states.append(tuple(state))
    return combine_decode_splits(states)


def cp_paged_flash_decode(q, kv_pool: KVPool, layer, page_table, seq_lens, shard,
                          sm_scale: Optional[float] = None, k_new=None, v_new=None):
    """Decode attention with the pool's rows sharded over the context ranks:
    q [B, Nq, D] (the same on every rank), ``page_table`` [B, ppr] of global
    page ids. Each rank runs K1 / K1q over its own pages, the states are
    combined, then ``k_new`` / ``v_new`` [B, Hkv, D], the newest token (the
    pool holds ``seq_lens - 1`` tokens), are folded in."""
    loc = rank_share(kv_pool, shard)
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    kv_lens = seq_lens if k_new is None else torch.clamp(seq_lens - 1, min=0)
    local_pt, local_len = local_page_view(page_table, kv_lens, kv_pool.page_size, loc,
                                          shard.cp_rank)
    out, m, l = paged_flash_decode(q, kv_pool, layer, local_pt, local_len, sm_scale,
                                   return_state=True)
    out, m, l = combine_ranks(out, m, l, shard)
    if k_new is None:
        return out
    return fold_new_token(out, m, l, q, k_new, v_new, sm_scale)


def cp_flash_prefill_chunked(q, k, v, chunk_lens, start_pos, kv_pool: KVPool, layer,
                             table_rows, shard, sm_scale: Optional[float] = None):
    """Chunked prefill with the pool's rows sharded over the context ranks:
    the chunk's queries q [B, S, Nq, D] and keys k / v [B, S, Hkv, D] are
    the same on every rank; a query attends the pool history [0,
    start_pos) and the causal chunk prefix. Each rank walks its own history
    pages (K5 / K5q with ``return_state``), rank 0 alone scores the chunk,
    and the states are combined."""
    loc = rank_share(kv_pool, shard)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    local_pt, local_hist = local_page_view(table_rows, start_pos, kv_pool.page_size, loc,
                                           shard.cp_rank)
    own_chunk = chunk_lens if shard.cp_rank == 0 else torch.zeros_like(chunk_lens)
    out, m, l = flash_prefill_chunked(q, k, v, own_chunk, local_hist, kv_pool, layer, local_pt,
                                      sm_scale, return_state=True)
    return combine_ranks(out, m, l, shard)[0]
