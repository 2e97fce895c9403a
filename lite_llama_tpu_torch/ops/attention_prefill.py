"""Ragged causal flash attention for prefill (port of
``lite_llama_tpu/ops/attention_prefill.py``, the ``flash_prefill`` entry).

K2 replaces the TPU kernel ``flash_prefill`` -> ``_flash_prefill_impl`` /
``_prefill_kernel`` (``has_history=False``) with the CUDA kernel
``csrc/flash_prefill.cu`` (its header says what bounds it and how it is laid
out). The chunked form with pool history (``flash_prefill_chunked``) is not
ported yet.

A wrapper handed a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version, ``ops/ref.py`` ``prefill_attention``. Pad query
rows (s >= seq_lens[b]) hold garbage in both and are never read.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .ref import LOG2E

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def launch_flash_prefill(q, k, v, seq_lens, sm_scale):
    """K2 on the card: q [B, S, Nq, D], k/v [B, S, Hkv, D] bf16,
    seq_lens [B] int32 -> [B, S, Nq, D] bf16."""
    B, S, Nq, D = q.shape
    Hkv = k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, seq_lens)):
        raise ValueError("flash_prefill kernel: all tensors must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or seq_lens.dtype != torch.int32:
        raise ValueError("flash_prefill kernel takes bf16 q/k/v and int32 seq_lens")
    if (D not in (64, 128) or k.shape != (B, S, Hkv, D) or v.shape != k.shape
            or Nq % Hkv or Nq // Hkv > 8 or seq_lens.shape != (B,)):
        raise ValueError(f"flash_prefill kernel: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    q, k, v, seq_lens = (t.contiguous() for t in (q, k, v, seq_lens))
    out = torch.empty_like(q)
    if B and S:
        lib = _build.library("flash_prefill", "flash_prefill_bf16", _ARGTYPES)
        code = lib.flash_prefill_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, S, Nq, Hkv, D, float(sm_scale * LOG2E),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(lib, code, "flash_prefill")
        launch_flash_prefill.launches += 1
    return out


launch_flash_prefill.launches = 0


def flash_prefill(q, k, v, seq_lens, sm_scale=None):
    """Fresh prefill: causal ragged GQA attention over one padded chunk."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return launch_flash_prefill(q, k, v, seq_lens.to(torch.int32), sm_scale)
    return ref.prefill_attention(q, k, v, seq_lens, sm_scale)
