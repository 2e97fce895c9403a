"""Op dispatch layer (port of ``lite_llama_tpu/ops/__init__.py``).

Dispatch is by the tensor's device and nothing else: a CUDA tensor launches
the op's hand-written kernel or raises, a CPU tensor takes the plain version
in ``ref.py``. There is no backend switch and no environment variable, so
nothing can quietly send the card to the plain code. RoPE stays plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from . import ref
from .attention_decode import paged_flash_decode
from .attention_prefill import flash_prefill, flash_prefill_chunked
from .norms import rms_norm, skip_rms_norm, swiglu
from .ref import apply_rope, rope_cos_sin

# The JAX package's dispatch names for the attention ops.
prefill_attention = flash_prefill
paged_decode_attention = paged_flash_decode


def chunked_prefill_attention(q, k, v, chunk_lens, start_pos, kv_pool, layer, page_table,
                              sm_scale=None, max_hist_len=None):
    """Chunk queries attend pool history [0, start_pos) + the causal chunk
    prefix. On the card K5 walks each request's pages up to its own
    start_pos; on the CPU the plain form gathers ``max_hist_len`` tokens of
    history (the caller's page-rounded bound), streaming it in blocks past
    ``ref.HIST_BLOCK``, as the JAX package's fallback does."""
    if q.is_cuda:
        return flash_prefill_chunked(q, k, v, chunk_lens, start_pos, kv_pool, layer,
                                     page_table, sm_scale)
    return ref.chunked_prefill_attention(q, k, v, chunk_lens, start_pos, kv_pool, layer,
                                         page_table, sm_scale, max_hist_len=max_hist_len)


__all__ = [
    "apply_rope", "rope_cos_sin", "rms_norm", "skip_rms_norm", "swiglu",
    "prefill_attention", "chunked_prefill_attention", "paged_decode_attention", "ref",
]
