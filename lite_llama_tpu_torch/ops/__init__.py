"""Op dispatch layer (port of ``lite_llama_tpu/ops/__init__.py``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the op's hand-written kernel or raises, a CPU tensor takes the plain version
in ``ref.py``. There is no backend switch and no environment variable, so
nothing can quietly send the card to the plain code. RoPE stays plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses

from . import ref
from .attention_decode import paged_flash_decode
from .attention_prefill import flash_prefill, flash_prefill_chunked
from .norms import rms_norm, skip_rms_norm, swiglu
from .ref import apply_rope, rope_cos_sin, softmax_split

# The JAX package's dispatch names for the attention ops.
prefill_attention = flash_prefill
paged_decode_attention = paged_flash_decode


def chunked_prefill_attention(q, k, v, chunk_lens, start_pos, kv_pool, layer, page_table,
                              sm_scale=None, max_hist_len=None, head_offset=None):
    """Chunk queries attend pool history [0, start_pos) + the causal chunk
    prefix. On the card K5 walks each request's pages up to its own
    start_pos; on the CPU the plain form gathers ``max_hist_len`` tokens of
    history (the caller's page-rounded bound), streaming it in blocks past
    ``ref.HIST_BLOCK``, as the JAX package's fallback does. ``head_offset``
    (default the pool's own): a tensor-parallel shard's first global kv
    head, where an int8 pool's scale lanes start."""
    if q.is_cuda:
        return flash_prefill_chunked(q, k, v, chunk_lens, start_pos, kv_pool, layer,
                                     page_table, sm_scale, head_offset=head_offset)
    if head_offset is not None and head_offset != kv_pool.head_offset:
        kv_pool = dataclasses.replace(kv_pool, head_offset=head_offset)
    return ref.chunked_prefill_attention(q, k, v, chunk_lens, start_pos, kv_pool, layer,
                                         page_table, sm_scale, max_hist_len=max_hist_len)


def launch_counters() -> dict:
    """{name: (launcher, counter attribute)} of every kernel wrapper: each
    adds one to its counter where it launches its kernel. K3 / K4 count
    apart the launches that also write K6's int8 rows, and K3 those with no
    residual (``rms_norm``: qwen3's per-head q / k norms)."""
    from . import attention_decode, attention_prefill, norms, qmatmul

    launchers = {
        "paged_flash_decode": attention_decode.launch_paged_decode,
        "flash_prefill": attention_prefill.launch_flash_prefill,
        "rms_norm": norms.launch_rms_norm,
        "swiglu": norms.launch_swiglu,
        "flash_prefill_chunked": attention_prefill.launch_flash_prefill_chunked,
        "quantized_matmul_packed": qmatmul.launch_quantized_matmul_packed,
        "quantized_matmul_int8": qmatmul.launch_quantized_matmul_int8,
        "quantized_matmul_w4a16": qmatmul.launch_quantized_matmul_w4a16,
        "paged_flash_decode_int8": attention_decode.launch_paged_decode_int8,
        "paged_flash_decode_fp8": attention_decode.launch_paged_decode_fp8,
        "flash_prefill_chunked_int8": attention_prefill.launch_flash_prefill_chunked_int8,
        "flash_prefill_chunked_fp8": attention_prefill.launch_flash_prefill_chunked_fp8,
        "flash_prefill_vmem": attention_prefill.launch_flash_prefill_vmem,
        "quantize_rows": qmatmul.launch_quantize_rows,
    }
    out = {k: (fn, "launches") for k, fn in launchers.items()}
    out["rms_norm_int8_rows"] = (norms.launch_rms_norm, "int8_launches")
    out["swiglu_int8_rows"] = (norms.launch_swiglu, "int8_launches")
    out["rms_norm_no_residual"] = (norms.launch_rms_norm, "no_residual_launches")
    return out


def launch_counts() -> dict:
    """{name: launches so far} of :func:`launch_counters`."""
    return {k: getattr(fn, attr) for k, (fn, attr) in launch_counters().items()}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` ({name: launches}) to the counters: a
    replayed CUDA graph launches its kernels with no wrapper running, so its
    replayer counts them for it."""
    for k, (fn, attr) in launch_counters().items():
        if counts.get(k):
            setattr(fn, attr, getattr(fn, attr) + counts[k] * times)


__all__ = [
    "apply_rope", "rope_cos_sin", "rms_norm", "skip_rms_norm", "swiglu",
    "prefill_attention", "chunked_prefill_attention", "paged_decode_attention", "ref",
    "launch_counters", "launch_counts", "add_launches", "softmax_split",
]
