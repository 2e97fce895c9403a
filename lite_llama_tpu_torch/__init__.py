"""lite_llama_tpu_torch: the PyTorch + CUDA port of lite_llama_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``lite_llama_tpu`` is the reference; module names here follow
it one to one. Every Pallas kernel on the ported path is a hand-written
Hopper kernel (CUDA C++ under ``csrc/``, or Triton), built at first use; a
CPU tensor takes the plain PyTorch version of each kernel instead. This
package imports neither JAX nor ``lite_llama_tpu``.
"""

from .config import BaseConfig, LlamaConfig, Qwen2Config, Qwen3Config, load_config

__all__ = ["BaseConfig", "LlamaConfig", "Qwen2Config", "Qwen3Config", "load_config"]
