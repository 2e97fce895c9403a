"""Tensor-parallel attention (port of ``lite_llama_tpu/parallel/tp_attention.py``).

In the JAX package a bare ``pallas_call`` is opaque to GSPMD, so these
wrappers run the single-chip kernels inside a manual-tp ``shard_map`` on
each shard's heads. Here each rank already holds its heads: its queries'
Nq/tp heads and a pool of its Hkv/tp kv heads (``shardings.py``), so every
wrapper is a thin local call of the one-device kernel, with no collective;
shard s's Nq/tp query heads attend exactly its Hkv/tp kv heads, so GQA's
groups stay within the shard. (JAX's ``tp_supported`` chooses between these
wrappers and a fallback; the port has no fallback, and
``ShardingPolicy.param_specs`` refuses heads that do not split.)

An int8 pool's scale slab stays whole, its lanes indexing GLOBAL heads
([0, Hkv) and [64, 64 + Hkv)), as in the JAX pool: each rank passes
``head_offset = rank * Hkv/tp`` into K1q / K5q, which shift their scale
lanes to the shard's global heads. bf16 and fp8 pools ignore it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..executor.kv_cache import KVPool
from ..ops import attention_decode, attention_prefill


def _local_pool(kv_pool: KVPool, num_kv_heads: int, shard) -> KVPool:
    """The rank's pool as the kernels take it: its Hkv/tp kv heads, the
    first of them global head ``rank * Hkv/tp``, where an int8 pool's
    scale lanes start."""
    hl = num_kv_heads // shard.tp
    if kv_pool.pages.shape[-1] != hl * kv_pool.head_dim:
        raise ValueError(f"rank {shard.rank}'s pool holds {kv_pool.pages.shape[-1]} channels, "
                         f"not the {hl} kv heads of a tp={shard.tp} shard")
    return dataclasses.replace(kv_pool, num_kv_heads=hl, head_offset=shard.rank * hl)


def tp_paged_flash_decode(q, kv_pool: KVPool, layer, page_table, seq_lens, shard,
                          num_kv_heads: int, sm_scale: Optional[float] = None, k_new=None,
                          v_new=None):
    """Decode attention of this rank's heads: q [B, Nq/tp, D], k_new / v_new
    [B, Hkv/tp, D], its pool (K1 / K1q on the card)."""
    pool = _local_pool(kv_pool, num_kv_heads, shard)
    return attention_decode.paged_flash_decode(
        q, pool, layer, page_table, seq_lens, sm_scale, k_new=k_new, v_new=v_new,
        head_offset=pool.head_offset)


def tp_flash_prefill(q, k, v, seq_lens, sm_scale: Optional[float] = None):
    """Fresh prefill of this rank's heads: q [B, S, Nq/tp, D], k / v
    [B, S, Hkv/tp, D] (K2 / K8 on the card; no pool, no offset)."""
    return attention_prefill.flash_prefill(q, k, v, seq_lens, sm_scale)


def tp_flash_prefill_chunked(q, k, v, chunk_lens, start_pos, kv_pool: KVPool, layer,
                             table_rows, shard, num_kv_heads: int,
                             sm_scale: Optional[float] = None, max_hist_len=None):
    """A chunk over this rank's pool history (K5 / K5q on the card; on the
    CPU the plain form bounded by ``max_hist_len``)."""
    from .. import ops

    pool = _local_pool(kv_pool, num_kv_heads, shard)
    return ops.chunked_prefill_attention(q, k, v, chunk_lens, start_pos, pool, layer,
                                         table_rows, sm_scale, max_hist_len=max_hist_len,
                                         head_offset=pool.head_offset)
