"""Activation functions (port of ``lite_llama_tpu/ops/activations.py``).

Plain PyTorch on purpose, on the card too: in the JAX package these are XLA
ops, not Pallas kernels (XLA fuses them into the matmuls around them). The
CLIP tower uses ``quick_gelu``, the LLaVA projector the erf GELU.

Every function computes in fp32 and casts back to the input dtype.
"""

from __future__ import annotations

import math

import torch


def _fp32(fn):
    def wrapped(x: torch.Tensor, *a, **kw) -> torch.Tensor:
        return fn(x.float(), *a, **kw).to(x.dtype)

    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


@_fp32
def gelu(x):
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


@_fp32
def gelu_tanh(x):
    """tanh-approximated GELU (HF 'gelu_new' / 'gelu_pytorch_tanh')."""
    return torch.nn.functional.gelu(x, approximate="tanh")


@_fp32
def quick_gelu(x):
    """x * sigmoid(1.702 x), the CLIP tower's activation."""
    return x * torch.sigmoid(1.702 * x)


@_fp32
def relu(x):
    return torch.clamp(x, min=0.0)


@_fp32
def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@_fp32
def tanh(x):
    return torch.tanh(x)


@_fp32
def silu(x):
    return x * torch.sigmoid(x)


# HF config ``hidden_act`` name -> function.
ACT2FN = {
    "gelu": gelu,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": relu,
    "leaky_relu": leaky_relu,
    "tanh": tanh,
    "silu": silu,
    "swish": silu,
}
