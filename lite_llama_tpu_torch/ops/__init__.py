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
from .attention_prefill import flash_prefill
from .norms import rms_norm, skip_rms_norm, swiglu
from .ref import apply_rope, rope_cos_sin

# The JAX package's dispatch names for the two attention ops.
prefill_attention = flash_prefill
paged_decode_attention = paged_flash_decode

__all__ = [
    "apply_rope", "rope_cos_sin", "rms_norm", "skip_rms_norm", "swiglu",
    "prefill_attention", "paged_decode_attention", "ref",
]
