"""Paged flash-decode attention (port of ``lite_llama_tpu/ops/attention_decode.py``).

K1 replaces the TPU kernel ``paged_flash_decode`` / ``_decode_kernel`` with
the CUDA kernel ``csrc/paged_decode.cu`` (its header says what bounds it and
how it is laid out). The kernel reads K/V through the page table straight
out of the pool ``[L, 2, T, Hkv*D]`` and returns ``out`` with the
online-softmax state ``(m, l)``; the newest token of a decode step is not in
the pool yet and is folded in outside the kernel (``ref.fold_new_token``),
so the pool stays read-only while the layers run.

A wrapper handed a CUDA tensor launches the kernel (or raises); a CPU tensor
takes :func:`paged_decode_state_plain`, which computes the same function.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import LOG2E, NEG_INF, cdiv_int, fold_new_token

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
]


def paged_decode_state_plain(q, pages, page_size, layer, page_table, kv_lens, sm_scale):
    """Plain version of K1: (out [B, Nq, D] in q's dtype, m, l [B, Nq] fp32),
    exp2 domain with sm_scale*log2(e) folded into q, q and P rounded to bf16
    before their products when q is bf16 (as the TPU kernel does). kv_lens
    == 0 gives m = -1e30, l = 0, out = 0."""
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
    kv = pages[layer][:, rows].float().reshape(2, B, S, Hkv, D)
    s = torch.einsum("bhgd,bshd->bhgs", qs, kv[0])
    valid = (torch.arange(S, device=q.device)[None, :] < kv_lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(mat).float(), kv[1])
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Nq, D).to(q.dtype), m.reshape(B, Nq), l.reshape(B, Nq)


def launch_paged_decode(q, pages, page_size, layer, page_table, kv_lens, sm_scale):
    """K1 on the card: (out, m, l) as :func:`paged_decode_state_plain`."""
    B, Nq, D = q.shape
    L, two, T, HD = pages.shape
    if not (q.is_cuda and pages.device == q.device and page_table.device == q.device
            and kv_lens.device == q.device):
        raise ValueError("paged_decode kernel: all tensors must be on one CUDA device")
    if q.dtype != torch.bfloat16 or pages.dtype != torch.bfloat16:
        raise ValueError("paged_decode kernel takes a bf16 query and a bf16 pool")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError("paged_decode kernel: page_table and kv_lens must be int32")
    if D not in (64, 128) or two != 2 or HD % D or Nq % (HD // D) or Nq // (HD // D) > 8:
        raise ValueError(f"paged_decode kernel: unsupported shape q={tuple(q.shape)} "
                         f"pool={tuple(pages.shape)}")
    if not (q.is_contiguous() and pages.is_contiguous() and page_table.is_contiguous()
            and kv_lens.is_contiguous()) or page_table.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("paged_decode kernel: contiguous q [B,Nq,D], page_table [B,ppr], "
                         "kv_lens [B] required")
    if not 0 <= int(layer) < L:
        raise ValueError(f"paged_decode kernel: layer {layer} out of range")
    out = torch.empty_like(q)
    m = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
    if B:
        lib = _build.library("paged_decode", "paged_decode_bf16", _ARGTYPES)
        code = lib.paged_decode_bf16(
            q.data_ptr(), pages.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, Nq, HD // D, D, T, int(layer), page_size, page_table.shape[1],
            float(sm_scale * LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, code, "paged_decode")
        launch_paged_decode.launches += 1
    return out, m, l


launch_paged_decode.launches = 0


def paged_flash_decode(q, kv_pool, layer, page_table, seq_lens, sm_scale=None,
                       k_new=None, v_new=None, return_state=False):
    """Decode attention, one query per request: q [B, Nq, D] against the
    pool's ``layer`` through ``page_table`` [B, ppr] int32, bounded by
    ``seq_lens`` [B]. With ``k_new``/``v_new`` [B, Hkv, D] the pool holds
    seq_lens - 1 tokens and the newest token is folded in exactly.
    ``return_state`` returns (out, m, l) instead (no new token)."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    kv_lens = seq_lens if k_new is None else torch.clamp(seq_lens - 1, min=0)
    kv_lens = kv_lens.to(torch.int32)
    args = (q, kv_pool.pages, kv_pool.page_size, layer, page_table, kv_lens, sm_scale)
    if q.is_cuda:
        out, m, l = launch_paged_decode(*args)
    else:
        out, m, l = paged_decode_state_plain(*args)
    if return_state:
        if k_new is not None:
            raise ValueError("return_state excludes the new-token fold")
        return out, m, l
    if k_new is None:
        return out
    return fold_new_token(out, m, l, q, k_new, v_new, sm_scale)
