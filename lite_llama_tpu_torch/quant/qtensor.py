"""Weight-only quantization: int8 / fp8 e4m3 / packed-int4 tensors with
per-channel or C-grouped scales (port of ``lite_llama_tpu/quant/qtensor.py``).

The byte layouts are the JAX package's, so the port loads the JAX
quantizer's output and quantizes the same weights to the same bytes:

- ``QTensor.q`` is ``[*stack, C, O]`` (contraction dims flattened to C,
  output dims to O), ``scale`` fp32 ``[*stack, O]`` or C-grouped
  ``[*stack, nG, O]``.
- Packed int4 (``packed=True``) stores two nibbles per byte along the output
  axis, ``byte = 16*hi + (lo + 8)`` with hi, lo in [-7, 7], and PAIRED
  scales ``[*stack, (nG,) O/2]`` (one per byte column). Classic order packs
  output columns (2j, 2j+1); riffle order (``riffle_groups=1``) packs
  (j, j + O/2), so the W4A8 kernel's [evens | odds] output is already in
  canonical column order.
- Wide output axes of >= 8192 columns whose packed width is not a multiple
  of 512 are padded to a multiple of 1024 (the 128256-wide llama vocab);
  consumers slice back to the logical width.

``qeinsum`` routes a layer-indexed packed weight to the W4A8 kernel
(``ops/qmatmul.py``, K6) when ``qmm_supported`` holds, and otherwise runs the
W4A16 dual dot in plain PyTorch, as the JAX package leaves it to XLA. Its
activations may come as ``QuantizedRows`` (their int8 rows made by the norm
that wrote them, ``ops/norms.py``): K6 takes those rows, every other route
the activations (``takes_int8_rows`` says which route a weight takes).

Refused with NotImplementedError, until multi-GPU: the σ-FFN layouts
(``sigma_ffn``, ``sigma_tp``) and riffle blocks for tensor parallelism
(``riffle_tp > 1``, ``riffle_blocks > 1``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.qmatmul import QuantizedRows, qmm_supported, quantized_matmul_packed


def qdtype_name(qdtype) -> str:
    """The JAX package's name for a quantized dtype: "int8", "int4" or
    "float8_e4m3fn". Torch has no int4 dtype, so packed int4 is named."""
    if qdtype is torch.int8 or qdtype == "int8":
        return "int8"
    if qdtype is torch.float8_e4m3fn or qdtype in ("fp8", "float8_e4m3fn"):
        return "float8_e4m3fn"
    if qdtype == "int4":
        return "int4"
    raise ValueError(f"unsupported quantized dtype {qdtype!r}: use 'int8', 'fp8' or 'int4'")


@dataclass
class QTensor:
    """Quantized weight + per-output-channel (or grouped) scale; see the
    module docstring for the layouts. ``unit_shape`` is the logical
    per-layer shape (contract dims + out dims), ``out_shape`` the logical
    output dims. ``layer`` set means q/scale stay layer-stacked and the
    matmul reads layer ``layer`` of them (no per-layer copy)."""

    q: torch.Tensor
    scale: torch.Tensor
    unit_shape: Tuple[int, ...] = ()
    out_shape: Tuple[int, ...] = ()
    packed: bool = False
    riffle_groups: int = 0
    fused_tp: int = 0
    layer: Optional[int] = None

    @property
    def shape(self):
        return self.q.shape

    @property
    def n_stack(self) -> int:
        return self.q.ndim - 2

    @property
    def grouped(self) -> bool:
        return self.scale.ndim == self.n_stack + 2

    def at_layer(self, layer: int) -> "QTensor":
        return dataclasses.replace(self, layer=layer)

    def unpack_halves(self):
        """(even, odd) int8 nibble halves [*stack, C, O/2]: the low nibble
        (stored with its +8 bias) and the signed high nibble."""
        b = self.q
        return (b & 15) - 8, b >> 4

    def unpack(self) -> torch.Tensor:
        """[*stack, C, O] integer view (values in [-7, 7] for packed int4)."""
        if not self.packed:
            return self.q
        even, odd = self.unpack_halves()
        return torch.stack([even, odd], dim=-1).reshape(*self.q.shape[:-1], 2 * self.q.shape[-1])

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        if self.riffle_groups:
            even, odd = self.unpack_halves()
            w = torch.cat([even.float(), odd.float()], dim=-1)
            scale = torch.cat([self.scale, self.scale], dim=-1)
        else:
            w = self.unpack().float()
            scale = self.scale.repeat_interleave(2, dim=-1) if self.packed else self.scale
        C, O = w.shape[-2], w.shape[-1]
        if self.grouped:
            nG = scale.shape[-2]
            w = (w.reshape(*w.shape[:-2], nG, C // nG, O) * scale[..., :, None, :]).reshape(
                *w.shape[:-2], C, O)
        else:
            w = w * scale[..., None, :]
        w = w[..., : math.prod(self.unit_shape) // C]  # drop lane-alignment padding
        return w.reshape(*w.shape[:-2], *self.unit_shape).to(dtype)


def quantize(w: torch.Tensor, contract_axes, qdtype="int8", group_size: Optional[int] = None,
             riffle_blocks: int = 0) -> QTensor:
    """Symmetric per-output-channel quantization over ``contract_axes``
    (contiguous, preceded only by stack axes and followed only by output
    axes), stored flattened to [*stack, C, O]. ``group_size`` (dividing C)
    switches to C-grouped scales; ``qdtype="int4"`` stores packed nibble
    pairs, ``riffle_blocks=1`` in riffle column order. Quantizes one stack
    slice at a time, so the fp32 transient is one layer's worth."""
    name = qdtype_name(qdtype)
    axes = contract_axes if isinstance(contract_axes, (tuple, list)) else (contract_axes,)
    axes = tuple(sorted(ax % w.ndim for ax in axes))
    first, last = axes[0], axes[-1]
    if axes != tuple(range(first, last + 1)):
        raise ValueError(f"contract axes must be contiguous, got {axes}")
    stack = tuple(w.shape[:first])
    C = math.prod(w.shape[first:last + 1])
    out_shape = tuple(w.shape[last + 1:])
    O = math.prod(out_shape)
    pad_to = 0
    if riffle_blocks > 1:
        raise NotImplementedError("riffle blocks for tensor parallelism wait for multi-GPU")
    if name == "int4":
        if O % 2:
            raise ValueError(f"int4 packing needs an even output width, got {O}")
        if O >= 8192 and (O // 2) % 512:
            pad_to = -(-O // 1024) * 1024
    elif riffle_blocks:
        raise ValueError("riffle_blocks is int4-packing-only")
    if group_size is not None and C % group_size:
        raise ValueError(f"group_size {group_size} does not divide C={C}")
    q, scale = _quantize_2d_stacked(w.reshape(*stack, C, O), name, group_size, pad_to,
                                    riffle_blocks)
    return QTensor(q=q, scale=scale, unit_shape=tuple(w.shape[first:]), out_shape=out_shape,
                   packed=name == "int4", riffle_groups=int(riffle_blocks))


def _quantize_one(w, name, group_size, pad_to, riffle_blocks):
    """One [C, O] slice -> (q [C, O or O/2], scale [(nG,) O or O/2]). The
    scale multiplies by the fp32 reciprocal of 127 / 7 / 448, as XLA
    computes a division by a constant; the weight is then divided by the
    scale."""
    if pad_to > w.shape[-1]:
        w = torch.nn.functional.pad(w, (0, pad_to - w.shape[-1]))
    if riffle_blocks:
        # Permuted col 2j = block col j, col 2j+1 = block col j + O/2: the
        # classic pair packing of the permuted matrix gives the riffle bytes
        # and correctly paired scales.
        half = w.shape[-1] // 2
        perm = np.stack([np.arange(half), half + np.arange(half)], axis=-1).reshape(-1)
        w = w.index_select(-1, torch.as_tensor(perm, device=w.device))
    C, O = w.shape
    wf = w.float()
    if group_size is not None:
        wf = wf.reshape(C // group_size, group_size, O)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    if name == "int8":
        scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
        q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8).reshape(C, O)
    elif name == "int4":
        amax2 = amax.reshape(*amax.shape[:-1], O // 2, 2).amax(dim=-1)
        scale = torch.clamp(amax2, min=1e-8) * (1.0 / 7.0)
        q4 = torch.round(wf / scale.repeat_interleave(2, dim=-1)).clamp(-7, 7).to(torch.int16)
        q4 = q4.reshape(C, O // 2, 2)
        q = (q4[..., 1] * 16 + q4[..., 0] + 8).to(torch.int8)
    else:
        scale = torch.clamp(amax, min=1e-8) * (1.0 / 448.0)
        q = (wf / scale).to(torch.float8_e4m3fn).reshape(C, O)
    return q, scale.squeeze(-2)


def _quantize_2d_stacked(w2, name, group_size, pad_to=0, riffle_blocks=0):
    flat = w2.reshape(-1, *w2.shape[-2:])
    qs, ss = None, None
    for i in range(flat.shape[0]):
        q, s = _quantize_one(flat[i], name, group_size, pad_to, riffle_blocks)
        if qs is None:
            qs = torch.empty((flat.shape[0], *q.shape), dtype=q.dtype, device=q.device)
            ss = torch.empty((flat.shape[0], *s.shape), dtype=s.dtype, device=s.device)
        qs[i] = q
        ss[i] = s
    stack = w2.shape[:-2]
    return qs.reshape(*stack, *qs.shape[1:]), ss.reshape(*stack, *ss.shape[1:])


# ---------------------------------------------------------------------------
# Matmul


def _contract_ndims(x: torch.Tensor, C: int) -> int:
    """How many trailing dims of x flatten to the contraction width C."""
    k, prod = 0, 1
    while prod != C:
        k += 1
        if k > x.ndim:
            raise ValueError(f"trailing dims of {tuple(x.shape)} do not flatten to {C}")
        prod *= x.shape[-k]
    return k


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, C] @ b [C, N] accumulated and returned in fp32 (the JAX
    package's preferred_element_type=float32); an fp32 operand promotes the
    product to fp32, as in JAX."""
    if a.is_cuda and a.dtype == b.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def takes_int8_rows(w, M: int) -> bool:
    """Whether ``qeinsum`` runs M rows against ``w`` on K6, so that the
    kernel writing those rows may hand K6 their int8 form as well: a packed
    QTensor read at a layer, or an unstacked one (the packed head, which
    ``models/decoder.py`` reads as layer 0 of a 1-deep stack), at a shape
    ``qmm_supported`` takes."""
    if not (isinstance(w, QTensor) and w.packed and (w.layer is not None or w.n_stack == 0)):
        return False
    nG = w.scale.shape[-2] if w.grouped else None
    return qmm_supported(w.q.shape[-2], w.q.shape[-1], nG, M)


def _qeinsum_layered(x, w: QTensor, out_dtype):
    """A layer-stacked QTensor used at ``w.layer``: packed int4 at shapes
    the kernel takes rides K6 against the stacked storage (on the int8 rows
    of a ``QuantizedRows`` x where it has them); every other case slices the
    layer and takes the plain path."""
    rows = x if isinstance(x, QuantizedRows) else None
    x = x.x if rows is not None else x
    dt = out_dtype or x.dtype
    C, Os = w.q.shape[-2], w.q.shape[-1]
    rest = tuple(w.q.shape[1:-2])  # stack dims after the layer axis
    n_rest = math.prod(rest)
    xr = x.reshape(-1, C)
    nG = w.scale.shape[-2] if w.grouped else None
    if w.packed and qmm_supported(C, Os, nG, xr.shape[0]):
        qf = w.q.reshape(-1, C, Os)
        sf = w.scale.reshape(-1, *w.scale.shape[1 + len(rest):])
        width = math.prod(w.out_shape)
        xk = xr if rows is None else QuantizedRows(xr, rows.xi, rows.xs)
        outs = [quantized_matmul_packed(xk, qf, sf, w.layer * n_rest + j, out_dtype=dt,
                                        interleave=not w.riffle_groups, out_width=width)
                for j in range(n_rest)]
        y = outs[0] if not rest else torch.stack(outs, dim=1)
        batch = x.shape[: x.ndim - _contract_ndims(x, C)]
        return y.reshape(*batch, *rest, *w.out_shape).to(dt)
    sliced = dataclasses.replace(w, q=w.q[w.layer], scale=w.scale[w.layer], layer=None)
    return qeinsum(None, x, sliced, out_dtype)


def qeinsum(pattern, x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """einsum that also takes a QTensor for ``w``. For a QTensor the pattern
    is ignored: x's trailing dims collapse to the stored contraction width
    C, the dot runs on the quantized values and the scale multiplies the
    result; the output takes the weight's logical out dims. Packed int4
    runs two dots on the nibble halves (W4A16) and recombines the small
    results, never the weight. ``x`` may be ``QuantizedRows``: K6 takes its
    int8 rows, every other route its activations."""
    if isinstance(w, QTensor) and w.layer is not None:
        return _qeinsum_layered(x, w, out_dtype)
    if isinstance(x, QuantizedRows):
        x = x.x
    if not isinstance(w, QTensor):
        return torch.einsum(pattern, x, w)
    dt = out_dtype or x.dtype
    C, Os = w.q.shape[-2], w.q.shape[-1]
    batch = x.shape[: x.ndim - _contract_ndims(x, C)]
    xr = x.reshape(-1, C)
    M = xr.shape[0]
    stack = tuple(w.q.shape[:-2])
    S = math.prod(stack)
    halves = w.unpack_halves() if w.packed else (w.q,)
    ys = []
    for h in halves:
        h = h.reshape(S, C, Os)
        if w.grouped:
            nG = w.scale.shape[-2]
            sg = w.scale.reshape(S, nG, Os)
            hg = h.reshape(S, nG, C // nG, Os)
            if M >= 512:
                # Wide batches (prefill): dequantize the half once in the
                # activation dtype, then one dot.
                wd = (hg.float() * sg[:, :, None, :]).to(dt).reshape(S, C, Os)
                y = torch.stack([_dot_f32(xr, wd[s]) for s in range(S)], dim=1)
            else:
                # Per-group dots, x the per-(group, channel) scale, summed
                # over the groups (fp32: the products of x and the integer
                # weights are exact there).
                xg = xr.float().reshape(M, nG, C // nG).transpose(0, 1)  # [nG, M, Gs]
                y = torch.stack([(torch.bmm(xg, hg[s].to(x.dtype).float()) * sg[s][:, None, :])
                                 .sum(0) for s in range(S)], dim=1)
        else:
            sc = w.scale.reshape(S, Os)
            y = torch.stack([_dot_f32(xr, h[s].to(dt)) * sc[s] for s in range(S)], dim=1)
        ys.append(y)  # [M, S, Os] fp32
    width = math.prod(w.out_shape)
    if len(ys) == 1:
        y = ys[0][..., :width]
    elif w.riffle_groups:
        y = torch.cat(ys, dim=-1)[..., :width]
    else:
        y = torch.stack(ys, dim=-1).reshape(M, S, 2 * Os)[..., :width]
    return y.reshape(*batch, *stack, *w.out_shape).to(dt)


# ---------------------------------------------------------------------------
# Decoder trees

# Decoder-layer weights to quantize, with the contraction axes of the
# stacked [L, ...] arrays (models/decoder.py layout).
_LAYER_QUANT_AXES = {
    "wq": (1,),  # [L, H, Nq, D]
    "wkv": (1,),  # [L, H, 2, Nkv, D]
    "wqkv": (1,),  # [L, H, Ntot, D] (fused)
    "o_proj": (1, 2),  # [L, Nq, D, H]
    "gate_up_proj": (2,),  # [L, 2, H, I] (stack (L, 2), contract H)
    "down_proj": (1,),  # [L, I, H]
}


def quantize_decoder_params(params: dict, qdtype="int8", group_size: Optional[int] = None,
                            sigma_ffn: bool = False, sigma_tp: int = 1, riffle: bool = False,
                            riffle_tp: int = 1) -> dict:
    """Quantize the projection matrices of a decoder tree (returns a new
    tree; norms, biases and the embedding stay). ``riffle=True`` (packed
    int4) fuses wq/wkv into wqkv before
    packing, flattens gate_up to one [L, H, 2I] matmul laid out [gate | up],
    and stores every packed weight in riffle order. A tied embedding gets a
    quantized head built from ``embed.T`` (the bf16 table stays for the
    input gather), unless int4 meets an odd vocabulary."""
    name = qdtype_name(qdtype)
    is4 = name == "int4"
    if sigma_ffn and is4:
        raise NotImplementedError("σ-FFN layouts (sigma_ffn, sigma_tp) are not ported: riffle "
                                  "supersedes them on one device")
    riff = riffle and is4
    if riff and riffle_tp > 1:
        raise NotImplementedError("riffle_tp > 1 (tensor-parallel riffle blocks) waits for "
                                  "multi-GPU")
    fused_tp = 0
    if riff and "wq" in params.get("layers", {}):
        from ..models.decoder import fuse_qkv_params

        params = fuse_qkv_params(params)
        fused_tp = 1
    out = dict(params)
    layers = dict(params["layers"])
    for key, axes in _LAYER_QUANT_AXES.items():
        if key not in layers:
            continue
        w = layers[key]
        if riff and key == "gate_up_proj":
            L_, _, H_, I_ = w.shape
            w = w.permute(0, 2, 1, 3).reshape(L_, H_, 2 * I_)  # [gate | up]
            axes = (1,)
        qt = quantize(w, axes, name, group_size=group_size, riffle_blocks=1 if riff else 0)
        if key == "wqkv" and fused_tp:
            qt = dataclasses.replace(qt, fused_tp=fused_tp)
        if riff and key == "gate_up_proj" and 2 * qt.q.shape[-1] != w.shape[-1]:
            raise ValueError("riffle gate_up hit the lane-alignment padding: unsupported")
        layers[key] = qt
    out["layers"] = layers
    riffle_blocks = 1 if riff else 0
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], (0,), name, group_size=group_size,
                                  riffle_blocks=riffle_blocks)
    elif "embed" in params and not (is4 and params["embed"].shape[0] % 2):
        out["lm_head"] = quantize(params["embed"].t(), (0,), name, group_size=group_size,
                                  riffle_blocks=riffle_blocks)
    return out


def dequantize_tree(params, dtype=torch.bfloat16):
    """Every QTensor replaced by its dequantized tensor in the model's
    original layout (a flat riffle gate_up folds back to [L, 2, H, I])."""

    def walk(node, key=None):
        if isinstance(node, QTensor):
            w = node.dequant(dtype)
            if key == "gate_up_proj" and w.ndim == 3 and node.riffle_groups:
                L_, H_, I2 = w.shape
                w = w.reshape(L_, H_, 2, I2 // 2).permute(0, 2, 1, 3).contiguous()
            return w
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)
