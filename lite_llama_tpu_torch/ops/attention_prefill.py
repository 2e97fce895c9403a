"""Ragged causal flash attention for prefill, fresh and chunked over the
paged pool's history (port of ``lite_llama_tpu/ops/attention_prefill.py``,
the ``flash_prefill`` and ``flash_prefill_chunked`` entries, bf16, int8 and fp8
pools).

The TPU runs its streamed forms through one kernel, ``_prefill_kernel``,
and unpackable head dims through ``_flash_prefill_vmem``. The port runs all
of them through one template, ``csrc/flash_prefill_chunked.cu`` (its header
says what bounds it and how it is laid out): packed GQA rows (128 (position,
query head) pairs of one kv head per q tile), a producer warpgroup filling
a ring of K/V tiles by cp.async, and two consumer warpgroups reading the
tiles through wgmma descriptors. Its instances:

- K5 (``flash_prefill_chunked``) and K5q, its int8 and fp8 pool instances
  (one launcher and launch count each): a chunk over the pool's history,
  on a persistent grid.
- Fresh prefill, the instance with no history and no pool (chunk_lens =
  seq_lens), one block per (request, kv head, q tile): K2 (``flash_prefill``
  -> ``_flash_prefill_impl``, head dims 64, 128 and 256, those the TPU
  streams unpadded) and K8 (``flash_prefill`` -> ``_flash_prefill_vmem``,
  every other even head dim from 16 to 128, padded to the mma k-step), one
  launcher and launch count each, both launching the same instances.

Every instance takes up to 16 query heads per kv head.

A wrapper handed a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version: ``ops/ref.py`` ``prefill_attention`` for K2 and K8,
:func:`chunked_prefill_state_plain` for K5. Pad query rows of K2 and K8
(s >= seq_lens[b]) are never read: the plain version computes them, the
kernel leaves them as they were.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .ref import LOG2E, NEG_INF, SCALE_HALF, cdiv_int, pool_rows

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_CHUNKED_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _check_qkv(what, q, k, v):
    B, S, Nq, D = q.shape
    Hkv = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{what} kernel takes bf16 q/k/v")
    if (D not in _build.HEAD_DIMS or k.shape != (B, S, Hkv, D) or v.shape != k.shape
            or Nq % Hkv or Nq // Hkv > _build.MAX_GROUP):
        raise ValueError(f"{what} kernel: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} (head dims: even, 16 to 128, or 256; at most "
                         f"{_build.MAX_GROUP} query heads per kv head)")


def _fresh_launcher(entry, what, head_dims):
    """K2 (``flash_prefill_bf16``, head dims 64, 128 and 256) or K8
    (``flash_prefill_vmem_bf16``, any head dim of ``_build.HEAD_DIMS``): the
    fresh instance of ``csrc/flash_prefill_chunked.cu``."""

    def launch(q, k, v, seq_lens, sm_scale):
        B, S, Nq, D = q.shape
        Hkv = k.shape[2]
        if not all(t.is_cuda and t.device == q.device for t in (q, k, v, seq_lens)):
            raise ValueError(f"{what} kernel: all tensors must be on one CUDA device")
        _check_qkv(what, q, k, v)
        if D not in head_dims:
            raise ValueError(f"{what} kernel: head dim {D} is not one of its instances")
        if seq_lens.dtype != torch.int32 or seq_lens.shape != (B,):
            raise ValueError(f"{what} kernel takes int32 seq_lens [B]")
        q, k, v, seq_lens = (t.contiguous() for t in (q, k, v, seq_lens))
        out = torch.empty_like(q)
        if B and S:
            lib = _build.library("flash_prefill_chunked", entry, _ARGTYPES)
            code = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                B, S, Nq, Hkv, D, float(sm_scale * LOG2E),
                _build.current_stream(q.device),
            )
            _build.check(lib, code, what)
            launch.launches += 1
        return out

    launch.__name__ = f"launch_{what}"
    launch.__doc__ = (f"{what} on the card: q [B, S, Nq, D], k/v [B, S, Hkv, D] bf16, "
                      "seq_lens [B] int32 -> [B, S, Nq, D] bf16.")
    launch.launches = 0
    return launch


# K2 takes the head dims the TPU streams unpadded (D % 128 == 0, or 64); K8
# every one of HEAD_DIMS (the router sends it all but those).
K2_HEAD_DIMS = (64, 128, 256)
launch_flash_prefill = _fresh_launcher("flash_prefill_bf16", "flash_prefill", K2_HEAD_DIMS)
launch_flash_prefill_vmem = _fresh_launcher("flash_prefill_vmem_bf16", "flash_prefill_vmem",
                                            _build.HEAD_DIMS)


def flash_prefill(q, k, v, seq_lens, sm_scale=None):
    """Fresh prefill: causal ragged GQA attention over one padded chunk. On
    the card head dims 64, 128 and 256 take K2 (the TPU's
    ``_flash_prefill_impl``), every other even one up to 128 K8 (the TPU's
    ``_flash_prefill_vmem``); anything else raises."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        launch = launch_flash_prefill if q.shape[-1] in K2_HEAD_DIMS else launch_flash_prefill_vmem
        return launch(q, k, v, seq_lens.to(torch.int32), sm_scale)
    return ref.prefill_attention(q, k, v, seq_lens, sm_scale)


# ---------------------------------------------------------------------------
# K5: a chunk over the pool's history


def chunked_prefill_state_plain(q, k, v, chunk_lens, start_pos, pages, page_size, layer,
                                table_rows, sm_scale, scales=None, head_offset=0):
    """Plain version of K5 and K5q: (out [B, S, Nq, D] in q's dtype, m, l
    [B, S, Nq] fp32). Row s of request b attends the pool history
    [L, 2, T, Hkv*D], then the chunk's keys p <= s, p < chunk_lens[b]. Exp2
    domain: the fp32 scores are scaled by sm_scale*log2(e), as the kernel
    scales them (the TPU kernel rounds a scaled q to bf16 instead); P is
    rounded to bf16 before its product when q is bf16. An int8
    pool's history rows (``scales`` [L, T, 128]) are dequantized whole,
    value times scale rounded once to q's matmul dtype, kv head h reading
    scale lanes ``head_offset + h`` (the first global kv head of a
    tensor-parallel shard's pool); fp8 converts exactly. A row with nothing
    to attend gives out = 0, m = -1e30, l = 0."""
    B, S, Nq, D = q.shape
    Hkv = k.shape[2]
    G = Nq // Hkv
    T = pages.shape[2]
    ps = page_size
    dev = q.device
    mat = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    start_pos = start_pos.to(dev)
    chunk_lens = chunk_lens.to(dev)
    qs = q.float().reshape(B, S, Hkv, G, D)
    n_pages = cdiv_int(int(start_pos.max()), ps) if B else 0
    off = torch.arange(ps, device=dev)
    rows = (table_rows[:, :n_pages].long()[:, :, None] * ps + off).reshape(B, -1)
    rows = rows.clamp(0, T - 1)
    Th = rows.shape[1]
    hist = pool_rows(pages, layer, rows).float().reshape(2, B, Th, Hkv, D)
    if scales is not None:
        srow = scales[layer][rows].float()  # [B, Th, SCALE_LANES]
        h0 = head_offset
        sc = torch.stack([srow[..., h0:h0 + Hkv], srow[..., SCALE_HALF + h0:SCALE_HALF + h0 + Hkv]])
        hist = (hist * sc[..., None]).to(mat).float()
    keys = torch.cat([hist[0], k.float()], dim=1)  # [B, Th + S, Hkv, D]
    vals = torch.cat([hist[1], v.float()], dim=1)
    s = torch.einsum("bshgd,bthd->bhgst", qs, keys) * (sm_scale * LOG2E)
    t_h = torch.arange(Th, device=dev)
    t_c = torch.arange(S, device=dev)
    valid_h = (t_h[None, :] < start_pos[:, None])[:, None, :].expand(B, S, Th)
    valid_c = (t_c[None, :] <= t_c[:, None])[None] & (t_c[None, None, :] < chunk_lens[:, None, None])
    valid = torch.cat([valid_h, valid_c], dim=-1)[:, None, None]  # [B, 1, 1, S, Th + S]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.einsum("bhgst,bthd->bhgsd", p.to(mat).float(), vals)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Nq, D).to(q.dtype)
    return out, m.permute(0, 3, 1, 2).reshape(B, S, Nq), l.permute(0, 3, 1, 2).reshape(B, S, Nq)


# Pool dtype -> the history instance (C entry) that reads it.
_CHUNKED_ENTRIES = {torch.bfloat16: "flash_prefill_chunked_bf16",
                    torch.int8: "flash_prefill_chunked_int8",
                    torch.float8_e4m3fn: "flash_prefill_chunked_fp8"}


def _chunked_launcher(pool_dtype):
    entry = _CHUNKED_ENTRIES[pool_dtype]

    def launch(q, k, v, chunk_lens, start_pos, pages, page_size, layer, table_rows, sm_scale,
               scales=None, head_offset=0, return_state=False):
        B, S, Nq, D = q.shape
        Hkv = k.shape[2]
        if not all(t.is_cuda and t.device == q.device
                   for t in (q, k, v, chunk_lens, start_pos, pages, table_rows)):
            raise ValueError("flash_prefill_chunked kernel: all tensors must be on one CUDA "
                             "device")
        _check_qkv("flash_prefill_chunked", q, k, v)
        L, two, T, HD = pages.shape
        if pages.dtype != pool_dtype or two != 2 or HD != Hkv * D:
            raise ValueError(f"{entry} kernel: {pool_dtype} pool [L, 2, T, {Hkv * D}] "
                             f"required, got {pages.dtype} {tuple(pages.shape)}")
        if (chunk_lens.dtype != torch.int32 or start_pos.dtype != torch.int32
                or table_rows.dtype != torch.int32 or chunk_lens.shape != (B,)
                or start_pos.shape != (B,) or table_rows.dim() != 2
                or table_rows.shape[0] != B):
            raise ValueError("flash_prefill_chunked kernel: int32 chunk_lens [B], start_pos "
                             "[B] and table_rows [B, ppr] required")
        if not 0 <= int(layer) < L or page_size <= 0:
            raise ValueError(f"flash_prefill_chunked kernel: layer {layer} or page_size "
                             f"{page_size} out of range")
        if not pages.is_contiguous():
            raise ValueError("flash_prefill_chunked kernel: the pool must be contiguous")
        if (scales is not None) != (pool_dtype == torch.int8):
            raise ValueError("flash_prefill_chunked kernel: an int8 pool needs its scales, "
                             "other pools have none")
        if scales is not None and (scales.shape != (L, T, 2 * SCALE_HALF)
                                   or scales.dtype != torch.bfloat16
                                   or not scales.is_contiguous() or scales.device != q.device):
            raise ValueError(f"flash_prefill_chunked kernel: scales must be bf16 [{L}, {T}, "
                             f"{2 * SCALE_HALF}], got {scales.dtype} {tuple(scales.shape)}")
        if scales is not None and not 0 <= head_offset <= SCALE_HALF - Hkv:
            raise ValueError(f"flash_prefill_chunked kernel: head_offset {head_offset} puts "
                             f"the scale lanes of {Hkv} kv heads past {SCALE_HALF}")
        q, k, v, chunk_lens, start_pos, table_rows = (
            t.contiguous() for t in (q, k, v, chunk_lens, start_pos, table_rows))
        out = torch.empty_like(q)
        m = l = None
        if return_state:
            m = torch.empty((B, S, Nq), dtype=torch.float32, device=q.device)
            l = torch.empty((B, S, Nq), dtype=torch.float32, device=q.device)
        if B and S:
            lib = _build.library("flash_prefill_chunked", entry, _CHUNKED_ARGTYPES)
            code = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), chunk_lens.data_ptr(),
                start_pos.data_ptr(), pages.data_ptr(),
                None if scales is None else scales.data_ptr(), table_rows.data_ptr(),
                out.data_ptr(), None if m is None else m.data_ptr(),
                None if l is None else l.data_ptr(), B, S, Nq, Hkv, D,
                float(sm_scale * LOG2E), T, int(layer), page_size, table_rows.shape[1],
                int(head_offset), _build.current_stream(q.device),
            )
            _build.check(lib, code, entry)
            launch.launches += 1
        return out, m, l

    launch.__name__ = f"launch_{entry}"
    launch.__doc__ = (f"K5{'' if pool_dtype == torch.bfloat16 else 'q'} on the card for a "
                      f"{pool_dtype} pool: (out, m, l) as :func:`chunked_prefill_state_plain`, "
                      "with m and l None unless ``return_state``.")
    launch.launches = 0
    return launch


launch_flash_prefill_chunked = _chunked_launcher(torch.bfloat16)
launch_flash_prefill_chunked_int8 = _chunked_launcher(torch.int8)
launch_flash_prefill_chunked_fp8 = _chunked_launcher(torch.float8_e4m3fn)
_CHUNKED_LAUNCHERS = {torch.bfloat16: launch_flash_prefill_chunked,
                      torch.int8: launch_flash_prefill_chunked_int8,
                      torch.float8_e4m3fn: launch_flash_prefill_chunked_fp8}


def flash_prefill_chunked(q, k, v, chunk_lens, start_pos, kv_pool, layer, table_rows,
                          sm_scale=None, return_state=False, head_offset=None):
    """Chunked prefill: each query attends the request's pool history
    [0, start_pos) plus the causal prefix of the current chunk. q
    [B, S_c, Nq, D], k/v [B, S_c, Hkv, D] (the chunk's own keys, also
    written to the pool by the caller), chunk_lens / start_pos [B],
    table_rows [B, ppr]. ``return_state=True`` also returns the per-query
    online-softmax state (m, l) [B, S_c, Nq] in the exp2 domain, for an LSE
    combine across partial results; ``chunk_lens = 0`` makes the call a walk
    over the history only. ``head_offset`` (default the pool's own): the
    first global kv head of a tensor-parallel shard's pool, where an int8
    pool's scale lanes start; bf16 and fp8 pools ignore it."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if head_offset is None:
        head_offset = kv_pool.head_offset
    args = (q, k, v, chunk_lens.to(torch.int32), start_pos.to(torch.int32), kv_pool.pages,
            kv_pool.page_size, layer, table_rows.to(torch.int32), sm_scale, kv_pool.scales,
            head_offset if kv_pool.quantized else 0)
    if q.is_cuda:
        launch = _CHUNKED_LAUNCHERS.get(kv_pool.pages.dtype)
        if launch is None:
            raise ValueError(f"flash_prefill_chunked kernel: no instance for a "
                             f"{kv_pool.pages.dtype} pool")
        out, m, l = launch(*args, return_state=return_state)
    else:
        out, m, l = chunked_prefill_state_plain(*args)
    return (out, m, l) if return_state else out
