"""Fused residual-add + RMSNorm and SwiGLU: Triton kernels for Hopper
(port of ``lite_llama_tpu/ops/norms.py``).

K3 replaces the TPU kernels ``rms_norm`` / ``_rms_kernel`` and
``skip_rms_norm`` / ``_skip_rms_kernel`` with ONE Triton kernel and a
``HAS_RESIDUAL`` constexpr; K4 replaces ``swiglu`` / ``_swiglu_kernel``.
The JAX model path leaves these to XLA, which fuses them; eager PyTorch
fuses nothing, so in the port they are on the main path (two skip-norms per
layer plus the final norm, one SwiGLU per layer, the qk-norms of qwen3).

What bounds them: device-memory bytes. Both are one pass over their rows
with a handful of FLOPs per element; the kernels read every input once and
write every output once, with the residual add, the fp32 reduction, the
normalisation and the weight product fused into that pass. Triton is enough:
there is no tensor-core work and no shared-memory staging to hide.

Numerics (K3) follow ``ops/ref.py``, which is what the JAX main path runs:
``x + residual`` is rounded to the activation dtype, and that rounded sum is
both the new residual and what is normalised. The TPU kernel normalises the
unrounded fp32 sum instead; the two agree exactly in fp32 and differ by the
bf16 rounding of the sum in bf16.

A wrapper handed a CUDA tensor launches its kernel (or raises); a CPU tensor
takes the plain version in ``ops/ref.py``. Triton is imported, and the
kernels are compiled, at the first launch, so this module imports without it.
"""

from __future__ import annotations

import torch

from . import ref

tl = None  # triton.language, bound at the first launch
_JIT = {}
MAX_RMS_BLOCK = 4096
SWIGLU_BLOCK = 1024


def _rms_kernel(X, R, W, OUT, RES, H, eps,
                HAS_RESIDUAL: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < H
    x = tl.load(X + row * H + cols, mask=mask, other=0.0)
    if HAS_RESIDUAL:
        r = tl.load(R + row * H + cols, mask=mask, other=0.0)
        s = (x.to(tl.float32) + r.to(tl.float32)).to(x.dtype)
        tl.store(RES + row * H + cols, s, mask=mask)
        xf = s.to(tl.float32)
    else:
        xf = x.to(tl.float32)
    var = tl.sum(xf * xf, axis=0) / H
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    y = xf * tl.rsqrt(var + eps) * w
    tl.store(OUT + row * H + cols, y.to(OUT.dtype.element_ty), mask=mask)


def _swiglu_kernel(G, U, OUT, n_cols, g_stride, u_stride, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < n_cols
    g = tl.load(G + row * g_stride + cols, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(U + row * u_stride + cols, mask=mask, other=0.0).to(tl.float32)
    y = g * tl.sigmoid(g) * u
    tl.store(OUT + row * n_cols + cols, y.to(OUT.dtype.element_ty), mask=mask)


def _jit(name: str):
    kernel = _JIT.get(name)
    if kernel is None:
        global tl
        import triton
        import triton.language

        tl = triton.language
        kernel = triton.jit({"rms": _rms_kernel, "swiglu": _swiglu_kernel}[name])
        _JIT[name] = kernel
    return kernel


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1, x.shape[-1])


def launch_rms_norm(x, residual, weight, eps):
    """K3 on the card: returns (normed, new_residual); new_residual is x
    itself when ``residual`` is None."""
    H = x.shape[-1]
    if not (x.is_cuda and weight.is_cuda and weight.shape == (H,)):
        raise ValueError("rms_norm kernel: x and weight [H] must be CUDA tensors")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("rms_norm kernel: residual must match x in shape and dtype")
    block = _next_pow2(H)
    if block > MAX_RMS_BLOCK:
        raise ValueError(f"rms_norm kernel: H={H} exceeds {MAX_RMS_BLOCK}")
    x2 = _rows(x)
    out = torch.empty_like(x2)
    res = torch.empty_like(x2) if residual is not None else out
    r2 = _rows(residual) if residual is not None else x2
    n_rows = x2.shape[0]
    if n_rows:
        _jit("rms")[(n_rows,)](
            x2, r2, weight.contiguous(), out, res, H, float(eps),
            HAS_RESIDUAL=residual is not None, BLOCK=block,
            num_warps=4 if block <= 1024 else 8,
        )
        launch_rms_norm.launches += 1
    new_res = res.view(x.shape) if residual is not None else x
    return out.view(x.shape), new_res


launch_rms_norm.launches = 0


def launch_swiglu(gate, up):
    """K4 on the card: silu(gate) * up in fp32, out in gate's dtype. gate and
    up may be row-strided views with a unit last stride."""
    if not (gate.is_cuda and up.is_cuda):
        raise ValueError("swiglu kernel: gate and up must be CUDA tensors")
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError("swiglu kernel: gate and up must match in shape and dtype")
    I = gate.shape[-1]
    g2 = gate.reshape(-1, I)
    u2 = up.reshape(-1, I)
    if g2.stride(-1) != 1:
        g2 = g2.contiguous()
    if u2.stride(-1) != 1:
        u2 = u2.contiguous()
    out = torch.empty(g2.shape, dtype=gate.dtype, device=gate.device)
    n_rows = g2.shape[0]
    if n_rows:
        grid = (n_rows, -(-I // SWIGLU_BLOCK))
        _jit("swiglu")[grid](
            g2, u2, out, I, g2.stride(0), u2.stride(0),
            BLOCK=SWIGLU_BLOCK, num_warps=4,
        )
        launch_swiglu.launches += 1
    return out.view(gate.shape)


launch_swiglu.launches = 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def rms_norm(x, weight, eps=1e-5):
    if x.is_cuda:
        return launch_rms_norm(x, None, weight, eps)[0]
    return ref.rms_norm(x, weight, eps)


def skip_rms_norm(x, residual, weight, eps=1e-5):
    """Returns ``(rms_norm(x + residual) * weight, x + residual)``;
    ``residual=None`` returns ``(rms_norm(x), x)``."""
    if x.is_cuda:
        return launch_rms_norm(x, residual, weight, eps)
    return ref.skip_rms_norm(x, residual, weight, eps)


def swiglu(gate, up):
    if gate.is_cuda:
        return launch_swiglu(gate, up)
    return ref.swiglu(gate, up)
