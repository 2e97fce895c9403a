"""Paged flash-decode attention (port of ``lite_llama_tpu/ops/attention_decode.py``).

K1 replaces the TPU kernel ``paged_flash_decode`` / ``_decode_kernel`` with
the CUDA kernel ``csrc/paged_decode.cu`` (its header says what bounds it and
how it is laid out), at every even head dim from 16 to 128, as the TPU
kernel's wide form takes any; K1q, its int8 and fp8 pool instances, replace
the kernel's quantized-pool branches (one launcher and launch count each).
The kernel reads K/V through the page table straight
out of the pool ``[L, 2, T, Hkv*D]`` and returns ``out`` with the
online-softmax state ``(m, l)``; the newest token of a decode step is not in
the pool yet and is folded in outside the kernel (``ref.fold_new_token``),
so the pool stays read-only while the layers run.

The kernel splits each request's KV walk across blocks (flash decoding).
:func:`plan_decode_splits` fixes, from static shapes only, the most splits a
request may take and the least span of one; the kernel decides each
request's split on the device from all kv_lens and its grid's slots, as
:func:`decode_spans` does here, and combines the splits' partials in split
order as :func:`combine_decode_splits` does. The partials go through a
workspace kept per (device, stream), so a launch reads no device value on
the host and can be captured in a CUDA graph.

A wrapper handed a CUDA tensor launches the kernel (or raises); a CPU tensor
takes :func:`paged_decode_state_plain`, which computes the same function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from . import _build
from .ref import LOG2E, NEG_INF, SCALE_HALF, cdiv_int, fold_new_token, pool_rows

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# Pool dtype -> the kernel instance (C entry) that reads it.
_ENTRIES = {torch.bfloat16: "paged_decode_bf16", torch.int8: "paged_decode_int8",
            torch.float8_e4m3fn: "paged_decode_fp8"}

# The split plan's rules: the least span of a split (tokens, rounded up to
# whole pages) and the most splits of one request (csrc/paged_decode.cu
# MAX_SPLITS).
DECODE_MIN_SPAN_TOKENS = 128
DECODE_MAX_SPLITS = 16


class DecodePlan(NamedTuple):
    s_max: int     # the most splits of one request
    min_span: int  # pages: the least span of a split


@functools.lru_cache(maxsize=None)  # once per shape: the launch path is host-bound
def plan_decode_splits(table_width: int, page_size: int) -> DecodePlan:
    """The split plan of a K1 / K1q launch, from static shapes only (no
    tensor value): a request may take up to ``s_max`` splits, as many as its
    table's reach (``table_width`` pages) holds spans of ``min_span`` pages
    and at most DECODE_MAX_SPLITS. The device decides the rest from kv_lens
    (:func:`decode_spans`)."""
    min_span = max(1, cdiv_int(DECODE_MIN_SPAN_TOKENS, page_size))
    return DecodePlan(max(1, min(DECODE_MAX_SPLITS, cdiv_int(table_width, min_span))), min_span)


def decode_spans(kv_lens: Sequence[int], page_size: int, s_max: int, min_span: int,
                 slots: int) -> List[List[Tuple[int, int]]]:
    """The token spans [t0, t1) of each request's live splits, in split
    order, as the kernel decides them on the device from all kv_lens, its
    grid holding ``slots`` items per wave: a request of n pages among the
    launch's N takes its share of the slots, floor(slots * n / N), at least
    1, at most s_max and at most one per min_span pages, as spans of
    cdiv(n, live) whole pages, the last one shorter (none for an empty
    request)."""
    pages = [cdiv_int(n, page_size) for n in kv_lens]
    total = sum(pages)
    out = []
    for n_tok, n in zip(kv_lens, pages):
        if n == 0:
            out.append([])
            continue
        live = min(max(1, slots * n // total), s_max, cdiv_int(n, min_span))
        span = cdiv_int(n, live) * page_size
        out.append([(t0, min(n_tok, t0 + span)) for t0 in range(0, n_tok, span)])
    return out


def combine_decode_splits(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
    """The LSE combine of split partials ``(out, m, l)`` (out normalised, m
    and l in the exp2 domain), in split order, as the kernel's last block
    combines its splits and as ``fold_new_token`` folds one token: m = max
    m_s, l = sum l_s 2^(m_s - m), out = sum out_s l_s 2^(m_s - m) / l."""
    m = parts[0][1]
    for _, ms, _ in parts[1:]:
        m = torch.maximum(m, ms)
    l = torch.zeros_like(m)
    num = torch.zeros_like(parts[0][0], dtype=torch.float32)
    for out, ms, ls in parts:
        w = ls * torch.exp2(ms - m)
        l = l + w
        num = num + out.float() * w[..., None]
    return (num / torch.clamp(l, min=1e-30)[..., None]).to(parts[0][0].dtype), m, l


def paged_decode_state_plain(q, pages, page_size, layer, page_table, kv_lens, sm_scale,
                             scales=None):
    """Plain version of K1 and K1q: (out [B, Nq, D] in q's dtype, m, l
    [B, Nq] fp32), exp2 domain with sm_scale*log2(e) folded into q, q and P
    rounded to bf16 before their products when q is bf16 (as the TPU kernel
    does). kv_lens == 0 gives m = -1e30, l = 0, out = 0. An int8 pool
    (``scales`` [L, T, 128]) is dequantized in the score domain: the K scale
    multiplies the score, l sums the unscaled P, and P times the V scale
    (rounded like P) meets the integer V values. fp8 values convert
    exactly."""
    B, Nq, D = q.shape
    T, HD = pages.shape[2], pages.shape[3]
    Hkv = HD // D
    G = Nq // Hkv
    ps = page_size
    mat = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qs = (q.float() * (sm_scale * LOG2E)).to(mat).float().reshape(B, Hkv, G, D)
    n_pages = max(cdiv_int(int(kv_lens.max()), ps), 1) if B else 1
    pt = page_table[:, :n_pages].long()
    off = torch.arange(ps, device=pages.device)
    rows = (pt[:, :, None] * ps + off).reshape(B, n_pages * ps).clamp(0, T - 1)
    S = rows.shape[1]
    kv = pool_rows(pages, layer, rows).float().reshape(2, B, S, Hkv, D)
    s = torch.einsum("bhgd,bshd->bhgs", qs, kv[0])
    if scales is not None:
        sc = scales[layer][rows].float()  # [B, S, 128]
        ksc = sc[..., :Hkv].permute(0, 2, 1)[:, :, None, :]  # [B, Hkv, 1, S]
        vsc = sc[..., SCALE_HALF:SCALE_HALF + Hkv].permute(0, 2, 1)[:, :, None, :]
        s = s * ksc
    valid = (torch.arange(S, device=q.device)[None, :] < kv_lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    pv = p * vsc if scales is not None else p
    out = torch.einsum("bhgs,bshd->bhgd", pv.to(mat).float(), kv[1])
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Nq, D).to(q.dtype), m.reshape(B, Nq), l.reshape(B, Nq)


_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_outgrown: List[Tuple[torch.Tensor, torch.Tensor]] = []


def _workspace(device: torch.device, stream: int, floats: int, counters: int):
    """The split workspace of (device, stream): fp32 partials and one counter
    per (request, kv head), the counters allocated zeroed and never cleared
    again (the last split of each sets its counter back to 0). It grows when
    a launch needs more; an outgrown one is kept, since a captured CUDA graph
    may still point at it."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < counters:
        if ws is not None:
            _outgrown.append(ws)
            floats, counters = max(floats, ws[0].numel()), max(counters, ws[1].numel())
        ws = (torch.empty(floats, dtype=torch.float32, device=device),
              torch.zeros(counters, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


_KV_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


@functools.lru_cache(maxsize=None)
def decode_grid_slots(head_dim: int, pool_dtype, batch: int, kv_heads: int, s_max: int) -> int:
    """The items per wave of a launch on the current card (the grid's y:
    the instance's resident blocks per SM times the SMs over the kv heads,
    at most batch * s_max), which :func:`decode_spans` takes as ``slots``."""
    lib = _build.library("paged_decode", "paged_decode_grid_y", [ctypes.c_int] * 5)
    slots = lib.paged_decode_grid_y(head_dim, _KV_CODES[pool_dtype], batch, kv_heads, s_max)
    if slots < 1:
        raise RuntimeError("paged_decode_grid_y: no grid for this launch")
    return slots


def _decode_launcher(pool_dtype):
    entry = _ENTRIES[pool_dtype]

    def launch(q, pages, page_size, layer, page_table, kv_lens, sm_scale, scales=None):
        B, Nq, D = q.shape
        L, two, T, HD = pages.shape
        if not (q.is_cuda and pages.device == q.device and page_table.device == q.device
                and kv_lens.device == q.device):
            raise ValueError("paged_decode kernel: all tensors must be on one CUDA device")
        if q.dtype != torch.bfloat16 or pages.dtype != pool_dtype:
            raise ValueError(f"{entry} kernel takes a bf16 query and a {pool_dtype} pool, got "
                             f"{q.dtype} and {pages.dtype}")
        if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
            raise ValueError("paged_decode kernel: page_table and kv_lens must be int32")
        if (D not in _build.HEAD_DIMS or two != 2 or HD % D or Nq % (HD // D)
                or Nq // (HD // D) > 8):
            raise ValueError(f"paged_decode kernel: unsupported shape q={tuple(q.shape)} "
                             f"pool={tuple(pages.shape)} (head dims: even, 16 to 128; at most "
                             "8 query heads per kv head)")
        if not (q.is_contiguous() and pages.is_contiguous() and page_table.is_contiguous()
                and kv_lens.is_contiguous()) or page_table.shape[0] != B or kv_lens.shape != (B,):
            raise ValueError("paged_decode kernel: contiguous q [B,Nq,D], page_table [B,ppr], "
                             "kv_lens [B] required")
        if not 0 <= int(layer) < L:
            raise ValueError(f"paged_decode kernel: layer {layer} out of range")
        if (scales is not None) != (pool_dtype == torch.int8):
            raise ValueError("paged_decode kernel: an int8 pool needs its scales, other pools "
                             "have none")
        if scales is not None and (scales.shape != (L, T, 2 * SCALE_HALF)
                                   or scales.dtype != torch.bfloat16
                                   or not scales.is_contiguous() or scales.device != q.device):
            raise ValueError(f"paged_decode kernel: scales must be bf16 [{L}, {T}, "
                             f"{2 * SCALE_HALF}], got {scales.dtype} {tuple(scales.shape)}")
        out = torch.empty_like(q)
        m = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
        if B:
            Hkv, ppr = HD // D, page_table.shape[1]
            plan = plan_decode_splits(ppr, page_size)
            stream = _build.current_stream(q.device)
            ws = counters = None
            if plan.s_max > 1:
                # a split's partial: acc [G, D] padded to 4 floats, then 16 floats of (m, l)
                sw = -(-(Nq // Hkv * D) // 4) * 4 + 16
                ws, counters = _workspace(q.device, stream, B * Hkv * plan.s_max * sw, B * Hkv)
            lib = _build.library("paged_decode", entry, _ARGTYPES)
            code = getattr(lib, entry)(
                q.data_ptr(), pages.data_ptr(), None if scales is None else scales.data_ptr(),
                page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), m.data_ptr(),
                l.data_ptr(), None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), B, Nq, Hkv, D, T,
                int(layer), page_size, ppr, float(sm_scale * LOG2E), plan.s_max, plan.min_span,
                stream,
            )
            _build.check(lib, code, entry)
            launch.launches += 1
        return out, m, l

    launch.__name__ = f"launch_{entry}"
    launch.__doc__ = (f"K1{'' if pool_dtype == torch.bfloat16 else 'q'} on the card for a "
                      f"{pool_dtype} pool: (out, m, l) as :func:`paged_decode_state_plain`.")
    launch.launches = 0
    return launch


launch_paged_decode = _decode_launcher(torch.bfloat16)
launch_paged_decode_int8 = _decode_launcher(torch.int8)
launch_paged_decode_fp8 = _decode_launcher(torch.float8_e4m3fn)
_LAUNCHERS = {torch.bfloat16: launch_paged_decode, torch.int8: launch_paged_decode_int8,
              torch.float8_e4m3fn: launch_paged_decode_fp8}


def paged_flash_decode(q, kv_pool, layer, page_table, seq_lens, sm_scale=None,
                       k_new=None, v_new=None, return_state=False):
    """Decode attention, one query per request: q [B, Nq, D] against the
    pool's ``layer`` (bf16, int8 with scales, or fp8) through ``page_table``
    [B, ppr] int32, bounded by
    ``seq_lens`` [B]. With ``k_new``/``v_new`` [B, Hkv, D] the pool holds
    seq_lens - 1 tokens and the newest token is folded in exactly.
    ``return_state`` returns (out, m, l) instead (no new token)."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    kv_lens = seq_lens if k_new is None else torch.clamp(seq_lens - 1, min=0)
    kv_lens = kv_lens.to(torch.int32)
    args = (q, kv_pool.pages, kv_pool.page_size, layer, page_table, kv_lens, sm_scale,
            kv_pool.scales)
    if q.is_cuda:
        launch = _LAUNCHERS.get(kv_pool.pages.dtype)
        if launch is None:
            raise ValueError(f"paged_decode kernel: no instance for a {kv_pool.pages.dtype} pool")
        out, m, l = launch(*args)
    else:
        out, m, l = paged_decode_state_plain(*args)
    if return_state:
        if k_new is not None:
            raise ValueError("return_state excludes the new-token fold")
        return out, m, l
    if k_new is None:
        return out
    return fold_new_token(out, m, l, q, k_new, v_new, sm_scale)
