"""Paged KV cache and its allocator (port of
``lite_llama_tpu/executor/kv_cache.py``).

- Pool layout ``[L, 2, T, Hkv*D]`` as in the JAX package: K/V planes, a
  flat token axis (row = page_id * page_size + offset) and flat head-major
  channels, so the two pools compare element for element.
- Pools hold bf16/fp32, int8 with per-(token, head) bf16 scales in a merged
  ``[L, T, SCALE_LANES]`` slab (K scales in lanes [0, Hkv), V scales in
  [64, 64 + Hkv)), or fp8 e4m3 with no scales (values clipped at +-448).
- A free-page stack plus a stack top: popping N pages reads
  ``free_stack[free_top - 1 - rank]``, with ranks from a cumsum over the
  need mask, so allocation is a few tensor ops on the device with no host
  round trip.

Unlike the JAX functions, which return new immutable caches, these functions
update the cache's tensors IN PLACE (and return the cache for symmetry):
every write goes into the tensors ``create_kv_cache`` made, ``free_top``
included, and none is ever rebound, so a CUDA graph that captured their
addresses (the engine's decode step) reads the current state at each replay.

JAX clamps out-of-bounds gathers and drops out-of-bounds scatters; PyTorch
raises, or asserts on the device. Every such site below clamps its gather
indices and filters or neutralises its scatter rows explicitly.

The in-graph allocator has no exhaustion guard: popping more pages than are
free drives ``free_top`` negative and hands out colliding pages. The host
checks capacity first (engine ``admit_feasible`` / ``try_admit``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.ref import SCALE_HALF, SCALE_LANES, byte_view
from ..ops.ref import cdiv_int as cdiv


@dataclass
class KVPool:
    """The paged K/V storage: pages [L, 2, T, Hkv*D], plus the merged scale
    slab [L, T, SCALE_LANES] bf16 of an int8 pool (None otherwise)."""

    pages: torch.Tensor
    page_size: int = 64
    num_kv_heads: int = 8
    head_dim: int = 128
    scales: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def num_tokens(self) -> int:
        return self.pages.shape[2]


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 per-(token, head) quantization over the D axis. The
    scale (amax times fp32(1/127), as XLA computes a division by a constant)
    is rounded to bf16 BEFORE the divide, so the stored bf16 scale
    dequantizes the stored values exactly."""
    xf = x.float()
    scale = (torch.clamp(xf.abs().amax(dim=-1), min=1e-6) * (1.0 / 127.0)).to(torch.bfloat16)
    q = torch.round(xf / scale.float()[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _cast_kv(x: torch.Tensor, dtype) -> torch.Tensor:
    """K/V values in the pool dtype (as bits for fp8, see ``byte_view``);
    fp8 saturates at the e4m3 maximum."""
    if dtype == torch.float8_e4m3fn:
        x = torch.clamp(x.float(), -448.0, 448.0)
    return byte_view(x.to(dtype))


def _scale_rows(ksc: torch.Tensor, vsc: torch.Tensor) -> torch.Tensor:
    """Per-(token, head) K and V scales [..., Hkv] -> merged bf16 rows
    [..., SCALE_LANES] (unused lanes zero, as in the JAX pool)."""
    Hkv = ksc.shape[-1]
    rows = torch.zeros((*ksc.shape[:-1], SCALE_LANES), dtype=torch.bfloat16, device=ksc.device)
    rows[..., :Hkv] = ksc
    rows[..., SCALE_HALF:SCALE_HALF + Hkv] = vsc
    return rows


@dataclass
class PagedKVCache:
    """Paged KV pool + request table + allocator state.

      kv_pages   : KVPool(pages [L, 2, P*ps, Hkv*D])
      page_table : int32 [max_reqs, pages_per_req]
      seq_lens   : int32 [max_reqs] (tokens currently stored per slot)
      free_stack : int32 [P] (free page ids; the top ``free_top`` are free)
      free_top   : int32 [] (a 0-d tensor on the cache's device)
    """

    kv_pages: KVPool
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.kv_pages.page_size

    @property
    def pages_per_req(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_reqs(self) -> int:
        return self.page_table.shape[0]


def create_kv_cache(num_layers, num_kv_heads, head_dim, num_pages, page_size=64,
                    max_reqs=64, max_seq_len=2048, dtype=torch.bfloat16,
                    device="cuda", quantized=False) -> PagedKVCache:
    """``quantized``: False (a ``dtype`` pool), True or "int8" (int8 values
    + merged per-(token, head) bf16 scales), or "fp8" (float8_e4m3fn, no
    scales)."""
    if quantized not in (False, True, "int8", "fp8"):
        raise ValueError(f"quantized must be False, True, 'int8' or 'fp8', got {quantized!r}")
    ppr = cdiv(max_seq_len, page_size)
    T = num_pages * page_size
    shape = (num_layers, 2, T, num_kv_heads * head_dim)
    scales = None
    if quantized == "fp8":
        dtype = torch.float8_e4m3fn
    elif quantized:
        if num_kv_heads > SCALE_HALF:
            raise ValueError(
                f"int8 KV cache supports num_kv_heads <= {SCALE_HALF}: the merged scale rows "
                f"pack K and V scales into one {SCALE_LANES}-lane slab. Use bf16 KV for "
                "wider-MHA models.")
        dtype = torch.int8
        scales = torch.zeros((num_layers, T, SCALE_LANES), dtype=torch.bfloat16, device=device)
    pool = KVPool(pages=torch.zeros(shape, dtype=dtype, device=device), page_size=page_size,
                  num_kv_heads=num_kv_heads, head_dim=head_dim, scales=scales)
    return PagedKVCache(
        kv_pages=pool,
        page_table=torch.zeros((max_reqs, ppr), dtype=torch.int32, device=device),
        seq_lens=torch.zeros((max_reqs,), dtype=torch.int32, device=device),
        free_stack=torch.arange(num_pages, dtype=torch.int32, device=device),
        free_top=torch.tensor(num_pages, dtype=torch.int32, device=device),
    )


def kv_cache_bytes(num_layers, num_kv_heads, head_dim, num_pages, page_size,
                   dtype=torch.bfloat16) -> int:
    per = num_layers * num_kv_heads * num_pages * page_size * head_dim
    return 2 * per * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# Allocation (all on the device; masked instead of data-dependent shapes)


def _pop_pages(cache: PagedKVCache, need: torch.Tensor):
    """Pop pages for a flat boolean ``need`` mask. Returns (page_ids,
    new_free_top): page_ids[i] is a fresh page where need[i], else an
    arbitrary id the caller must mask out."""
    need = need.to(torch.int32)
    rank = torch.cumsum(need, 0, dtype=torch.int32) - need
    total = need.sum(dtype=torch.int32)
    idx = (cache.free_top - 1 - rank).clamp(0, cache.free_stack.shape[0] - 1)
    return cache.free_stack[idx.long()], cache.free_top - total


def _valid_slots(cache: PagedKVCache, req_ids: torch.Tensor) -> torch.Tensor:
    """Slot ids >= max_reqs are sentinels whose writes JAX drops."""
    return req_ids < cache.max_reqs


def alloc_prefill(cache: PagedKVCache, req_ids: torch.Tensor, lens: torch.Tensor,
                  prefix_rows: Optional[torch.Tensor] = None,
                  prefix_pages: Optional[torch.Tensor] = None):
    """Allocate pages for ``lens[b]`` tokens in slot ``req_ids[b]`` and set
    those slots' lengths. Sentinel slots (>= max_reqs) pop their pages like
    JAX does but write nothing.

    Prefix caching: where ``prefix_pages[b] > 0`` the first table entries
    point at shared, already-filled pages from ``prefix_rows`` [B, ppr] and
    only the pages after them are popped. The host owns sharing and
    reference counts (engine ``PrefixCache``); this only splices the table."""
    B = req_ids.shape[0]
    ppr = cache.pages_per_req
    lens = lens.to(torch.int32)
    pages_needed = (lens + cache.page_size - 1) // cache.page_size
    j = torch.arange(ppr, dtype=torch.int32, device=lens.device)
    start = (torch.zeros_like(lens) if prefix_pages is None
             else prefix_pages.to(torch.int32))
    need = ((j[None, :] >= start[:, None]) & (j[None, :] < pages_needed[:, None])).reshape(-1)
    page_ids, new_top = _pop_pages(cache, need)
    rows = torch.where(need, page_ids, torch.zeros_like(page_ids)).reshape(B, ppr)
    if prefix_rows is not None:
        rows = torch.where(j[None, :] < start[:, None], prefix_rows.to(torch.int32), rows)
    ok = _valid_slots(cache, req_ids)
    slots = req_ids[ok].long()
    cache.page_table[slots] = rows[ok]
    cache.seq_lens[slots] = lens[ok]
    cache.free_top.copy_(new_top)
    return cache


def alloc_decode(cache: PagedKVCache, req_ids: torch.Tensor,
                 active: Optional[torch.Tensor] = None):
    """Make room for one more token in each active slot: pop a page where the
    current length lands on a page boundary and bump the length. Inactive
    slots are untouched. Runs without a host sync: the table write uses
    clamped indices and writes back the current entry where nothing changes
    (a finished request at its last page would index slot == ppr); the slots
    of one call are distinct, so no two rows of the write collide. Unlike
    alloc_prefill and free_requests it takes no sentinel slots: the port's
    decode batches hold live slots only."""
    ppr = cache.pages_per_req
    req = req_ids.long().clamp(max=cache.max_reqs - 1)
    old_len = cache.seq_lens[req]
    need = (old_len % cache.page_size) == 0
    if active is not None:
        need = need & active
    page_ids, new_top = _pop_pages(cache, need)
    slot = (old_len // cache.page_size).long()
    slot_c = slot.clamp(max=ppr - 1)
    cur = cache.page_table[req, slot_c]
    rows = torch.where(need & (slot < ppr), page_ids, cur)
    cache.page_table[req, slot_c] = rows
    new_len = old_len + 1 if active is None else old_len + active.to(torch.int32)
    cache.seq_lens[req] = new_len
    cache.free_top.copy_(new_top)
    return cache


def _push(cache: PagedKVCache, pages: torch.Tensor, mask: torch.Tensor):
    """Push ``pages[mask]`` onto the free stack in order (pushes past the
    stack's end are dropped, as JAX drops them)."""
    m = mask.to(torch.int32)
    rank = torch.cumsum(m, 0, dtype=torch.int32) - m
    dst = (cache.free_top + rank).long()
    push = mask & (dst < cache.free_stack.shape[0])
    cache.free_stack[dst[push]] = pages[push].to(torch.int32)
    cache.free_top.add_(m.sum(dtype=torch.int32))


def free_requests(cache: PagedKVCache, req_ids: torch.Tensor,
                  keep_pages: Optional[torch.Tensor] = None):
    """Push every page owned by the given slots back onto the free stack and
    zero their lengths and table rows. Sentinel slots are ignored.
    ``keep_pages[b]`` leading pages stay allocated: shared-prefix pages that
    the host's PrefixCache owns after the release."""
    ppr = cache.pages_per_req
    ok = _valid_slots(cache, req_ids)
    req = req_ids.long().clamp(max=cache.max_reqs - 1)
    used = (cache.seq_lens[req] + cache.page_size - 1) // cache.page_size
    used = torch.where(ok, used, torch.zeros_like(used))
    keep = (torch.zeros_like(used) if keep_pages is None
            else keep_pages.to(device=used.device, dtype=used.dtype))
    j = torch.arange(ppr, dtype=torch.int32, device=req_ids.device)
    mask = ((j[None, :] >= keep[:, None]) & (j[None, :] < used[:, None])).reshape(-1)
    _push(cache, cache.page_table[req].reshape(-1), mask)
    slots = req_ids[ok].long()
    cache.page_table[slots] = 0
    cache.seq_lens[slots] = 0
    return cache


def push_pages(cache: PagedKVCache, pages: torch.Tensor, valid: torch.Tensor):
    """Return arbitrary page ids to the free stack: the eviction path for
    the host-owned shared-prefix pages."""
    _push(cache, pages, valid)
    return cache


# ---------------------------------------------------------------------------
# KV writes


def kv_write_prefill(kv: KVPool, layer: int, k_new, v_new, table_rows, start_pos, lens):
    """Scatter a prefill chunk's K/V [B, S, Hkv, D] into the pool in place.
    Pad positions (s >= lens[b]) are dropped. An int8 pool quantizes per
    (token, head) on the way in."""
    B, S = k_new.shape[0], k_new.shape[1]
    ps = kv.page_size
    ppr = table_rows.shape[1]
    s = torch.arange(S, device=k_new.device)
    pos = start_pos.long()[:, None] + s[None, :]
    page = torch.gather(table_rows.long(), 1, (pos // ps).clamp(0, ppr - 1))
    rows = page * ps + pos % ps
    valid = (s[None, :] < lens[:, None]) & (rows < kv.num_tokens)
    HD = kv.pages.shape[-1]
    r = rows[valid]
    k, v = k_new[valid], v_new[valid]  # [N, Hkv, D]
    if kv.quantized:
        (k, ksc), (v, vsc) = _quantize_kv(k), _quantize_kv(v)
        kv.scales[layer, r] = _scale_rows(ksc, vsc)
    pages = byte_view(kv.pages)
    pages[layer, 0, r] = _cast_kv(k.reshape(-1, HD), kv.pages.dtype)
    pages[layer, 1, r] = _cast_kv(v.reshape(-1, HD), kv.pages.dtype)
    return kv


def kv_write_decode_all(kv: KVPool, k_all, v_all, table_rows, pos, active=None):
    """Write every layer's new K/V [L, B, Hkv, D] for one decode step into
    the pool in place, after the layer loop (the pool stays read-only while
    the layers run). Rows of inactive requests are dropped. Without a host
    sync: a dropped row is written back with the value it already holds; the
    rows of distinct live requests are distinct, and a dropped request's row
    is its own last token, so no two writes of one call collide."""
    ps = kv.page_size
    ppr = table_rows.shape[1]
    B = table_rows.shape[0]
    T = kv.num_tokens
    L = k_all.shape[0]
    HD = kv.pages.shape[-1]
    pos = pos.long()
    page = table_rows.long()[torch.arange(B, device=pos.device), (pos // ps).clamp(0, ppr - 1)]
    rows = page * ps + pos % ps
    keep = (rows >= 0) & (rows < T)
    if active is not None:
        keep = keep & active
    rows_c = rows.clamp(0, T - 1)
    keep3 = keep[None, :, None]
    if kv.quantized:
        (k_all, ksc), (v_all, vsc) = _quantize_kv(k_all), _quantize_kv(v_all)
        kv.scales[:, rows_c] = torch.where(keep3, _scale_rows(ksc, vsc), kv.scales[:, rows_c])
    pages = byte_view(kv.pages)
    for half, val in ((0, k_all), (1, v_all)):
        old = pages[:, half, rows_c]
        new = _cast_kv(val.reshape(L, B, HD), kv.pages.dtype)
        pages[:, half, rows_c] = torch.where(keep3, new, old)
    return kv
