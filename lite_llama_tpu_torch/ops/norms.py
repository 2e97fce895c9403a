"""Fused residual-add + RMSNorm and SwiGLU (port of
``lite_llama_tpu/ops/norms.py``).

K3 replaces the TPU kernels ``rms_norm`` / ``_rms_kernel`` and
``skip_rms_norm`` / ``_skip_rms_kernel``, K4 ``swiglu`` / ``_swiglu_kernel``:
CUDA kernels of ``csrc/norms.cu`` (its header says what bounds them at decode
and prefill widths and how they are laid out), built by ``ops/_build.py``
and launched through ``ctypes``. The JAX model path leaves these ops to XLA, which fuses them;
eager PyTorch fuses nothing, so in the port they are on the main path (two
skip-norms per layer plus the final norm, one SwiGLU per layer, the qk-norms
of qwen3).

Numerics (K3) follow ``ops/ref.py``, which is what the JAX main path runs:
``x + residual`` is rounded to the activation dtype, and that rounded sum is
both the new residual and what is normalised. The TPU kernel normalises the
unrounded fp32 sum instead; the two agree exactly in fp32 and differ by the
bf16 rounding of the sum in bf16.

``int8_rows=True`` asks K3 / K4 to also write the per-row int8 rows and row
scales that the W4A8 matmul K6 takes, computed from their own rounded output
in the same pass (``ops/qmatmul.py`` ``QuantizedRows``): the decoder asks for
them where the next projection runs on K6, which then launches no quantizer
of its own. The plain versions return ``_quantize_rows`` of their output, so
K6's result is the same either way, bit for bit.

A wrapper handed a CUDA tensor launches its kernel (or raises); a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref
from .qmatmul import QuantizedRows, _quantize_rows

_RMS_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_SWIGLU_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_SHAPE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)])
_DTYPES = (torch.bfloat16, torch.float32)


def _with_rows(out2d: torch.Tensor, shape) -> QuantizedRows:
    return QuantizedRows(out2d.view(shape), *_quantize_rows(out2d))


def _int8_outputs(M: int, H: int, device):
    return (torch.empty((M, H), dtype=torch.int8, device=device),
            torch.empty((M,), dtype=torch.float32, device=device))


_ENTRIES = {}  # C entry name -> (library, function): the launch path is host-bound


def _entry(name: str, argtypes):
    found = _ENTRIES.get(name)
    if found is None:
        lib = _build.library("norms", name, argtypes)
        found = _ENTRIES[name] = (lib, getattr(lib, name))
    return found


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def launch_rms_norm(x, residual, weight, eps, int8_rows=False):
    """K3 on the card: returns (normed, new_residual); new_residual is x
    itself when ``residual`` is None; normed is :class:`QuantizedRows` with
    ``int8_rows``."""
    H = x.shape[-1]
    if not (x.is_cuda and weight.is_cuda and weight.shape == (H,)):
        raise ValueError("rms_norm kernel: x and weight [H] must be CUDA tensors")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"rms_norm kernel takes bf16 or fp32, not {x.dtype} / {weight.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("rms_norm kernel: residual must match x in shape and dtype")
    fp32 = x.dtype == torch.float32
    if fp32 and weight.dtype != torch.float32:
        weight = weight.float()  # exact; the fp32 kernel reads fp32 weights
    xc = _dense(x)
    M = xc.numel() // H
    out = torch.empty_like(xc)
    res = r = None
    if residual is not None:
        r = _dense(residual)
        res = torch.empty_like(xc)
    xi, xs = _int8_outputs(M, H, x.device) if int8_rows else (None, None)
    if M:
        lib, fn = _entry("norms_rms", _RMS_ARGTYPES)
        code = fn(xc.data_ptr(), _ptr(r), _dense(weight).data_ptr(), out.data_ptr(), _ptr(res),
                  _ptr(xi), _ptr(xs), M, H, eps, fp32, weight.dtype == torch.float32,
                  _build.current_stream(x.device))
        _build.check(lib, code, "norms_rms")
        launch_rms_norm.launches += 1
        launch_rms_norm.int8_launches += int8_rows
    return (out if xi is None else QuantizedRows(out, xi, xs)), (x if res is None else res)


launch_rms_norm.launches = 0
launch_rms_norm.int8_launches = 0  # those of them that wrote int8 rows too


def launch_swiglu(gate, up, int8_rows=False):
    """K4 on the card: silu(gate) * up in fp32, out in gate's dtype
    (:class:`QuantizedRows` with ``int8_rows``). gate and up may be
    row-strided views with a unit last stride."""
    if not (gate.is_cuda and up.is_cuda):
        raise ValueError("swiglu kernel: gate and up must be CUDA tensors")
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError("swiglu kernel: gate and up must match in shape and dtype")
    if gate.dtype not in _DTYPES:
        raise ValueError(f"swiglu kernel takes bf16 or fp32, not {gate.dtype}")
    I = gate.shape[-1]
    g2 = gate if gate.dim() == 2 else gate.reshape(-1, I)
    u2 = up if up.dim() == 2 else up.reshape(-1, I)
    if g2.stride(-1) != 1:
        g2 = g2.contiguous()
    if u2.stride(-1) != 1:
        u2 = u2.contiguous()
    M = g2.shape[0]
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    xi, xs = _int8_outputs(M, I, gate.device) if int8_rows else (None, None)
    if M:
        lib, fn = _entry("norms_swiglu", _SWIGLU_ARGTYPES)
        code = fn(g2.data_ptr(), u2.data_ptr(), out.data_ptr(), _ptr(xi), _ptr(xs), M, I,
                  g2.stride(0), u2.stride(0), gate.dtype == torch.float32,
                  _build.current_stream(gate.device))
        _build.check(lib, code, "norms_swiglu")
        launch_swiglu.launches += 1
        launch_swiglu.int8_launches += int8_rows
    return out if xi is None else QuantizedRows(out, xi, xs)


launch_swiglu.launches = 0
launch_swiglu.int8_launches = 0


def launch_shape(op: str, a, b=None, w=None, int8_rows=False):
    """The launch K3 (``op`` "rms", a = x, b = residual or None, w = weight)
    or K4 ("swiglu", a = gate, b = up) makes on these tensors: vector bytes,
    vectors per thread (0: the loop over a wide row), block, grid and
    cluster size."""
    H = a.shape[-1]
    a2 = a.reshape(-1, H)
    b2 = b.reshape(-1, H) if b is not None else None
    shape = (ctypes.c_int * 7)()
    lib = _build.library("norms", "norms_launch_shape", _SHAPE_ARGTYPES)
    lib.norms_launch_shape(
        int(op == "swiglu"), a2.data_ptr(), None if b2 is None else b2.data_ptr(),
        None if w is None else w.data_ptr(), a2.data_ptr(), int(int8_rows), a2.shape[0], H,
        a2.stride(0), b2.stride(0) if b2 is not None else H, int(a.dtype == torch.float32),
        int(w is not None and w.dtype == torch.float32), shape)
    return dict(vector_bytes=shape[0], vectors_per_thread=shape[1],
                block=[shape[2], shape[3]], grid=[shape[4], shape[5]], cluster=shape[6])


def launch_empty(blocks: int, threads: int, pdl: bool, src=None, dst=None) -> None:
    """An empty kernel of ``csrc/norms.cu`` (the PDL handshake only),
    launched as K3 / K4 are: the floor of one launch (chip_smoke.py). With
    ``src`` / ``dst`` (16 bytes a thread) it also copies one to the other
    after the handshake."""
    lib = _build.library("norms", "norms_empty", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    stream = _build.current_stream(torch.device("cuda", torch.cuda.current_device()))
    _build.check(lib, lib.norms_empty(blocks, threads, int(pdl), _ptr(src), _ptr(dst), stream),
                 "norms_empty")


def skip_rms_norm_plain(x, residual, weight, eps=1e-5, int8_rows=False):
    """Plain version of K3 (``ops/ref.py``), with its int8 rows."""
    normed, res = ref.skip_rms_norm(x, residual, weight, eps)
    if int8_rows:
        normed = _with_rows(normed.reshape(-1, normed.shape[-1]), normed.shape)
    return normed, res


def swiglu_plain(gate, up, int8_rows=False):
    """Plain version of K4 (``ops/ref.py``), with its int8 rows."""
    out = ref.swiglu(gate, up)
    return _with_rows(out.reshape(-1, out.shape[-1]), out.shape) if int8_rows else out


def rms_norm(x, weight, eps=1e-5):
    if x.is_cuda:
        return launch_rms_norm(x, None, weight, eps)[0]
    return ref.rms_norm(x, weight, eps)


def skip_rms_norm(x, residual, weight, eps=1e-5, int8_rows=False):
    """Returns ``(rms_norm(x + residual) * weight, x + residual)``;
    ``residual=None`` returns ``(rms_norm(x), x)``. With ``int8_rows`` the
    first is :class:`QuantizedRows` (the int8 rows K6 takes beside it)."""
    if x.is_cuda:
        return launch_rms_norm(x, residual, weight, eps, int8_rows)
    return skip_rms_norm_plain(x, residual, weight, eps, int8_rows)


def swiglu(gate, up, int8_rows=False):
    """``silu(gate) * up``; with ``int8_rows`` as :class:`QuantizedRows`."""
    if gate.is_cuda:
        return launch_swiglu(gate, up, int8_rows)
    return swiglu_plain(gate, up, int8_rows)
