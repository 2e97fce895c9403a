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
  output columns (2j, 2j+1); riffle order (``riffle_groups=N``) packs, in
  each of N blocks of the output axis, block columns (j, j + Wb/2), so the
  W4A8 kernel's [evens | odds] output of one block is already in canonical
  column order. N = tp makes one tensor-parallel shard of the byte axis one
  block.
- σ-FFN (``sigma_ffn``): gate/up flattened to [L, H, 2I], per σ block
  [gate_b | up_b], its output left in the kernel's [evens | odds] order, and
  down_proj's contraction rows pre-permuted to match (``sigma_in``);
  ``sigma_groups`` = the tp the blocks were laid out for.
- Wide output axes of >= 8192 columns whose packed width is not a multiple
  of 512 are padded to a multiple of 1024 (the 128256-wide llama vocab);
  consumers slice back to the logical width.

``qeinsum`` routes a layer-indexed packed weight to the W4A8 kernel
(``ops/qmatmul.py``, K6) when ``qmm_supported`` holds, and otherwise runs the
W4A16 dual dot, as the JAX package leaves it to XLA: with grouped scales
under 512 rows through K9 (``quantized_matmul_w4a16``, which reads each
packed byte once for both halves), at 512 rows and more by dequantizing
each half once into a cuBLAS product, per-channel in plain PyTorch. Its
activations may come as ``QuantizedRows`` (their int8 rows made by the norm
that wrote them, ``ops/norms.py``): K6 takes those rows, every other route
the activations (``takes_int8_rows`` says which route a weight takes).
Under tensor parallelism (``shard`` with tp > 1) each rank holds its shard
of the weight (``parallel/shardings.py``) and ``tp_kind`` names the layout:
"out" (the rank's output columns) or "contract" (the rank's contraction
rows, whose fp32 partials are all-reduced), as JAX's manual-tp kernel
wrapper runs them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.qmatmul import (
    QuantizedRows,
    grouped_dot_plain,
    qmm_supported,
    qmm_tp_supported,
    quantized_matmul_packed,
    quantized_matmul_packed_tp,
    quantized_matmul_w4a16,
)


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
    sigma_out: bool = False
    sigma_in: bool = False
    sigma_groups: int = 1
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
            N = self.riffle_groups
            w = sigma_concat(even.float(), odd.float(), N)
            scale = sigma_concat(self.scale, self.scale, N)
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
        if self.sigma_in:
            # Stored row i holds canonical row sigma(i) (per σ block: evens,
            # then odds): undo it after the scales, which were fit in stored
            # order.
            N = self.sigma_groups
            W = C // N
            half = W // 2
            blk = np.stack([np.arange(half), half + np.arange(half)], axis=-1).reshape(-1)
            inv = (np.arange(N)[:, None] * W + blk[None, :]).reshape(-1)
            w = w.index_select(-2, torch.as_tensor(inv, device=w.device))
        w = w[..., : math.prod(self.unit_shape) // C]  # drop lane-alignment padding
        return w.reshape(*w.shape[:-2], *self.unit_shape).to(dtype)


def sigma_concat(even: torch.Tensor, odd: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., h] even / odd halves -> [..., 2h] whose block b (of ``groups``)
    is [evens_b | odds_b]: the per-block concat that riffle and σ layouts of
    N blocks take (groups 1: [evens | odds])."""
    if groups == 1:
        return torch.cat([even, odd], dim=-1)
    h = even.shape[-1]
    e = even.reshape(*even.shape[:-1], groups, h // groups)
    o = odd.reshape(*odd.shape[:-1], groups, h // groups)
    return torch.cat([e, o], dim=-1).reshape(*even.shape[:-1], 2 * h)


def quantize(w: torch.Tensor, contract_axes, qdtype="int8", group_size: Optional[int] = None,
             riffle_blocks: int = 0) -> QTensor:
    """Symmetric per-output-channel quantization over ``contract_axes``
    (contiguous, preceded only by stack axes and followed only by output
    axes), stored flattened to [*stack, C, O]. ``group_size`` (dividing C)
    switches to C-grouped scales; ``qdtype="int4"`` stores packed nibble
    pairs, ``riffle_blocks=N`` in the riffle column order of N blocks.
    Quantizes one stack slice at a time, so the fp32 transient is one
    layer's worth."""
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
    if name == "int4":
        if O % 2:
            raise ValueError(f"int4 packing needs an even output width, got {O}")
        if O >= 8192 and (O // 2) % 512:
            pad_to = -(-O // 1024) * 1024
        O_p = pad_to or O
        if riffle_blocks and (O_p % riffle_blocks or (O_p // riffle_blocks) % 2):
            raise ValueError(f"riffle_blocks={riffle_blocks} needs blocks of an even width "
                             f"dividing the stored output axis {O_p}")
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
        # Permuted col 2j = block col j, col 2j+1 = block col j + Wb/2 (per
        # block of Wb columns): the classic pair packing of the permuted
        # matrix gives the riffle bytes and correctly paired scales.
        N = riffle_blocks
        Wb = w.shape[-1] // N
        half = Wb // 2
        blk = np.stack([np.arange(half), half + np.arange(half)], axis=-1).reshape(-1)
        perm = (np.arange(N)[:, None] * Wb + blk[None, :]).reshape(-1)
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


def _qeinsum_layered(x, w: QTensor, out_dtype, shard=None, tp_kind=None):
    """A layer-stacked QTensor used at ``w.layer``: packed int4 at shapes
    the kernel takes rides K6 against the stacked storage (on the int8 rows
    of a ``QuantizedRows`` x where it has them); every other case slices the
    layer and takes the plain path. Under tensor parallelism (``shard.tp >
    1`` and a ``tp_kind``) the kernel runs on this rank's shard through
    ``quantized_matmul_packed_tp`` where ``qmm_tp_supported`` holds at the
    whole weight's shapes, as the JAX package routes it."""
    rows = x if isinstance(x, QuantizedRows) else None
    x = x.x if rows is not None else x
    dt = out_dtype or x.dtype
    C, Os = w.q.shape[-2], w.q.shape[-1]
    rest = tuple(w.q.shape[1:-2])  # stack dims after the layer axis
    n_rest = math.prod(rest)
    xr = x.reshape(-1, C)
    M = xr.shape[0]
    nG = w.scale.shape[-2] if w.grouped else None
    tp = shard.tp if shard is not None else 1
    if tp > 1 and tp_kind is not None:
        whole = ((C * tp, Os, nG and nG * tp) if tp_kind == "contract"
                 else (C, Os * tp, nG))
        use = w.packed and qmm_tp_supported(tp_kind, *whole, M, tp)
    else:
        use = w.packed and qmm_supported(C, Os, nG, M)
    if use:
        qf = w.q.reshape(-1, C, Os)
        sf = w.scale.reshape(-1, *w.scale.shape[1 + len(rest):])
        xk = xr if rows is None else QuantizedRows(xr, rows.xi, rows.xs)
        interleave = not (w.sigma_out or w.riffle_groups)
        width = math.prod(w.out_shape)
        # Riffle and σ outputs come as whole-axis [evens | odds]: N > 1
        # blocks (a tensor-parallel layout run on one device) take every
        # column and re-block, padding (at the canonical end) dropped after.
        n = w.sigma_groups if w.sigma_out else w.riffle_groups
        outs = []
        for j in range(n_rest):
            li = w.layer * n_rest + j
            if tp > 1 and tp_kind is not None:
                y = quantized_matmul_packed_tp(xk, qf, sf, li, shard, tp_kind, out_dtype=dt,
                                               interleave=interleave,
                                               out_width=None if n > 1 else width)
            else:
                y = quantized_matmul_packed(xk, qf, sf, li, out_dtype=dt, interleave=interleave,
                                            out_width=None if n > 1 else width)
            if n > 1:
                y = sigma_concat(y[:, :Os], y[:, Os:], n)[:, :width]
            outs.append(y)
        y = outs[0] if not rest else torch.stack(outs, dim=1)
        batch = x.shape[: x.ndim - _contract_ndims(x, C)]
        return y.reshape(*batch, *rest, *w.out_shape).to(dt)
    sliced = dataclasses.replace(w, q=w.q[w.layer], scale=w.scale[w.layer], layer=None)
    return qeinsum(None, x, sliced, out_dtype, shard=shard, tp_kind=tp_kind)


def qeinsum(pattern, x: torch.Tensor, w, out_dtype=None, shard=None,
            tp_kind=None) -> torch.Tensor:
    """einsum that also takes a QTensor for ``w``. For a QTensor the pattern
    is ignored: x's trailing dims collapse to the stored contraction width
    C, the dot runs on the quantized values and the scale multiplies the
    result; the output takes the weight's logical out dims. Packed int4
    runs two dots on the nibble halves (W4A16: K9 with grouped scales
    under 512 rows) and recombines the small results, never the weight.
    ``x`` may be ``QuantizedRows``: K6 takes its int8 rows, every other
    route its activations.

    ``shard`` (a ``parallel.shardings.ShardingPolicy``) with tp > 1 and
    ``tp_kind`` "contract": ``w`` and x's trailing dims are this rank's
    contraction slice, and the fp32 partial products are all-reduced over
    the tp group before the cast. "out": this rank's output columns, no
    collective."""
    if isinstance(w, QTensor) and w.layer is not None:
        return _qeinsum_layered(x, w, out_dtype, shard, tp_kind)
    if isinstance(x, QuantizedRows):
        x = x.x
    if not isinstance(w, QTensor):
        return torch.einsum(pattern, x, w)
    dt = out_dtype or x.dtype
    if shard is not None and shard.tp > 1 and tp_kind == "contract":
        return shard.all_reduce(qeinsum(pattern, x, w, torch.float32)).to(dt)
    C, Os = w.q.shape[-2], w.q.shape[-1]
    batch = x.shape[: x.ndim - _contract_ndims(x, C)]
    xr = x.reshape(-1, C)
    M = xr.shape[0]
    stack = tuple(w.q.shape[:-2])
    S = math.prod(stack)
    nG = w.scale.shape[-2] if w.grouped else 1
    if w.packed and w.grouped and M < 512:
        # K9: per-group dots, x the per-(group, channel) scale, summed over
        # the groups, both halves from one pass over the packed bytes.
        y = quantized_matmul_w4a16(xr, w.q.reshape(S, C, Os), w.scale.reshape(S, nG, Os))
        ys = [y[:, :, 0], y[:, :, 1]]
    else:
        ys = []
        for h in (w.unpack_halves() if w.packed else (w.q,)):
            h = h.reshape(S, C, Os)
            if w.grouped and M >= 512:
                # Wide batches (prefill): dequantize the half once in the
                # activation dtype, then one dot.
                sg = w.scale.reshape(S, nG, Os)
                wd = (h.reshape(S, nG, C // nG, Os).float() * sg[:, :, None, :]).to(dt)
                y = torch.stack([_dot_f32(xr, wd[s].reshape(C, Os)) for s in range(S)], dim=1)
            elif w.grouped:  # int8 weights under 512 rows: the same per-group dots
                y = grouped_dot_plain(xr, h, w.scale.reshape(S, nG, Os))
            else:
                sc = w.scale.reshape(S, Os)
                y = torch.stack([_dot_f32(xr, h[s].to(dt)) * sc[s] for s in range(S)], dim=1)
            ys.append(y)  # [M, S, Os] fp32
    width = math.prod(w.out_shape)
    if len(ys) == 1:
        y = ys[0][..., :width]
    elif w.sigma_out:  # σ order: each half sliced to its own width, then per block
        h = width // 2
        y = sigma_concat(ys[0][..., :h], ys[1][..., :h], w.sigma_groups)
    elif w.riffle_groups:
        y = sigma_concat(ys[0], ys[1], w.riffle_groups)[..., :width]
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
    tree; norms, biases and the embedding stay), in the JAX quantizer's
    layouts bit for bit:

    - ``riffle=True`` (packed int4) fuses wq/wkv into wqkv before packing
      (shard-periodic for ``riffle_tp``), flattens gate_up to one [L, H, 2I]
      matmul laid out [gate_b | up_b] per block, and stores every packed
      weight in riffle order: ``riffle_tp`` blocks for the weights whose
      output axis tensor parallelism shards (wqkv, gate_up, the head), one
      for o_proj and down, whose contraction it shards.
    - ``sigma_ffn=True`` (packed int4) flattens gate_up the same way, per σ
      block of ``sigma_tp``, leaves its output in the kernel's [evens |
      odds] order and pre-permutes down_proj's contraction rows to match.

    A tied embedding gets a quantized head built from ``embed.T`` (the bf16
    table stays for the input gather), unless int4 meets an odd vocabulary."""
    name = qdtype_name(qdtype)
    is4 = name == "int4"
    sigma = sigma_ffn and is4
    riff = riffle and is4
    if sigma and riff:
        raise ValueError("sigma_ffn and riffle are mutually exclusive packing layouts")
    N = max(int(sigma_tp), 1)
    Nr = max(int(riffle_tp), 1) if riff else 0
    fused_tp = 0
    if riff and "wq" in params.get("layers", {}):
        from ..models.decoder import fuse_qkv_params

        params = fuse_qkv_params(params, tp=Nr)
        fused_tp = Nr
    out = dict(params)
    layers = dict(params["layers"])
    for key, axes in _LAYER_QUANT_AXES.items():
        if key not in layers:
            continue
        w = layers[key]
        if sigma and key == "down_proj":
            # Stored row i <- canonical row sigma(i): per σ block, evens then
            # odds, the order of the σ gate/up output it consumes.
            I_ = w.shape[1]
            W = I_ // N
            if I_ % N or W % 2:
                raise ValueError(f"sigma_tp={N} needs even blocks of the ffn width {I_}")
            blk = np.concatenate([np.arange(0, W, 2), np.arange(1, W, 2)])
            perm = (np.arange(N)[:, None] * W + blk[None, :]).reshape(-1)
            w = w.index_select(1, torch.as_tensor(perm, device=w.device))
        if (riff or sigma) and key == "gate_up_proj":
            n = Nr if riff else N
            L_, _, H_, I_ = w.shape
            if I_ % n or (I_ // n) % 2:
                raise ValueError(f"{n} blocks need even blocks of the ffn width {I_}")
            w = w.reshape(L_, 2, H_, n, I_ // n).permute(0, 2, 3, 1, 4).reshape(L_, H_, 2 * I_)
            axes = (1,)
        nr_key = 0 if not riff else (Nr if key in ("wq", "wkv", "wqkv", "gate_up_proj") else 1)
        qt = quantize(w, axes, name, group_size=group_size, riffle_blocks=nr_key)
        if key == "wqkv" and fused_tp:
            qt = dataclasses.replace(qt, fused_tp=fused_tp)
        if (riff or sigma) and key == "gate_up_proj" and 2 * qt.q.shape[-1] != w.shape[-1]:
            raise ValueError("a flat gate_up hit the lane-alignment padding: unsupported")
        if sigma and key in ("gate_up_proj", "down_proj"):
            qt = dataclasses.replace(qt, sigma_groups=N, **{
                "sigma_out" if key == "gate_up_proj" else "sigma_in": True})
        layers[key] = qt
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], (0,), name, group_size=group_size,
                                  riffle_blocks=Nr)
    elif "embed" in params and not (is4 and params["embed"].shape[0] % 2):
        out["lm_head"] = quantize(params["embed"].t(), (0,), name, group_size=group_size,
                                  riffle_blocks=Nr)
    return out


def dequantize_tree(params, dtype=torch.bfloat16):
    """Every QTensor replaced by its dequantized tensor in the model's
    original layout (a flat riffle or σ gate_up folds back to [L, 2, H, I])."""

    def walk(node, key=None):
        if isinstance(node, QTensor):
            w = node.dequant(dtype)
            if key == "gate_up_proj" and w.ndim == 3 and (node.sigma_out or node.riffle_groups):
                n = node.sigma_groups if node.sigma_out else node.riffle_groups
                L_, H_, I2 = w.shape
                w = w.reshape(L_, H_, n, 2, I2 // (2 * n)).permute(0, 3, 1, 2, 4).reshape(
                    L_, 2, H_, I2 // 2).contiguous()
            return w
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)
