"""W4A8 and W8A8 weight matmuls (port of ``lite_llama_tpu/ops/qmatmul.py``).

K6 replaces the TPU kernel ``quantized_matmul_packed`` / ``_qmm_kernel`` and
K7 ``quantized_matmul_int8`` / ``_qmm8_kernel``, two CUDA kernels of
``csrc/qmatmul.cu`` (its header says what bounds them and how each is laid
out).
Activations are quantized per row to int8 (``quantize_activations``, which
the JAX package leaves to XLA: plain PyTorch on the CPU, one small kernel of
the same source on the card, which the plain version's arithmetic pins), or
arrive quantized beside the activations (:class:`QuantizedRows`, from the
norm or SwiGLU that wrote them: ``ops/norms.py``); the kernels then run
exact integer dots on the raw weight bytes:

- W4A8 (packed int4, ``byte = 16*hi + (lo + 8)``): ``g0 = x.b``,
  ``g1 = x.(b & 15)`` per scale group, then ``lo = g1 - 8*sum(x_g)`` and
  ``hi = (g0 - g1)/16`` folded into fp32 accumulators with the group scale.
- W8A8 (int8 weights): one int8 dot per scale group, x the group scale.

Both fold the int32 partials at every scale group, and per-channel weights
at every ``_pick_bc`` contraction block, in the TPU kernel's order, then
multiply by the row scale. The plain versions here repeat that arithmetic
with exact float64 dots, so kernel and plain version agree bit for bit.

A wrapper handed a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version. The routing predicate ``qmm_supported`` is the JAX
package's at its default caps; its ``LITE_LLAMA_TPU_QMM_*`` switches are not
ported. On the card the kernels take scale groups (and fold spans) of any
multiple of 8 rows and C a multiple of 32.

Where the output tiles alone leave SMs idle, the kernels split C across
blocks and fold the splits' fp32 terms in order: K6 (:func:`plan_splits`)
through a small workspace kept per (device, stream) (:func:`_workspace`),
whose counters return to 0 at the end of every launch, so it needs no clear
and a CUDA graph can capture and replay the launch; K7 (:func:`plan_w8a8`)
inside a thread-block cluster per output tile, with nothing kept between
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build

_BO_MAX = 512  # output-block ceiling of the TPU kernel
_BC_MAX = 4096  # contraction-block ceiling of the TPU kernel

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + [ctypes.c_void_p] * 3)
_W8A8_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                  + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
_QUANTIZE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _pick_block(n: int, candidates=(512, 256, 128)) -> Optional[int]:
    for b in candidates:
        if b <= _BO_MAX and n % b == 0:
            return b
    return None


def _pick_bc(C: int, n_groups: Optional[int]) -> Optional[int]:
    """The TPU kernel's contraction block: per-channel scales take the
    largest power-of-two block up to 4096 that divides C; grouped scales
    the largest multiple of 8 groups that divides C under the cap, else
    the whole C up to 4096."""
    if n_groups is None or n_groups == 1:
        return _pick_block(C, (4096, 2048, 1024, 512, 256, 128))
    gs = C // n_groups
    if gs == 0 or C % gs != 0:
        return None
    base = 8 * gs
    if C % base == 0:
        best = base
        m = 2
        while m * base <= min(C, _BC_MAX):
            if C % (m * base) == 0:
                best = m * base
            m += 1
        return best
    if C <= 4096:
        return C
    return None


def qmm_supported(C: int, Oh: int, n_groups: Optional[int], M: int) -> bool:
    """Shapes the packed kernel takes (the JAX routing rule): at most 256
    rows, a legal contraction block and a stored width that is a multiple of
    128. Other shapes take the W4A16 dual dot."""
    if M > 256:
        return False
    if _pick_bc(C, n_groups) is None:
        return False
    return Oh % 128 == 0


def _fold_span(C: int, nG: int) -> int:
    """Contraction rows between two folds of the int32 partials: a scale
    group, or a per-channel weight's contraction block."""
    if nG > 1:
        return C // nG
    return _pick_bc(C, None) or C


# K6's blocks and shared memory (csrc/qmatmul.cu qmm_kernel), for its planner.
_THREADS = 128
_BN = 32  # byte columns per block
_KC = 256  # contraction rows per shared-memory chunk
_STAGES = 3  # cp.async ring stages
_MAX_SPLITS = 16
_SMEM_PER_SM = 233472  # H100: 228 KB per SM, 1 KB of it reserved per block
_SMEM_PER_BLOCK = 232448  # the most dynamic shared memory one block may take
_BLOCKS_BY_REGISTERS = 2  # __launch_bounds__(128, 2): at least 2 blocks fit

# K7's blocks (csrc/qmatmul.cu w8a8_kernel), for its planner: strips of 128
# byte columns, a producer warp and 4 * kw consumer warps (kw k-warps per
# column, each taking 128 rows of every chunk).
_W8_BN = 128
_W8_RANGE = 128
_W8_MAX_SPLITS = 8  # a tile's splits are one cluster (8 blocks: portable)
_W8_SPLIT_SHARE = 0.75  # of the SMs a split grid may take


def _kstep(F: int) -> int:
    """Rows between fold checks: 32 (m16n8k32 steps), 16 (m16n8k16) or 8
    (m16n8k16 with half the A lanes zeroed)."""
    return 32 if F % 32 == 0 else 16 if F % 16 == 0 else 8


def _smem_bytes(MT: int, kstep: int, nspan: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source):
    the ring, each stage a weight chunk, an activation chunk and the chunk's
    fold scales, and the fp32 terms of ``nspan`` held fold spans."""
    stage = _KC * _BN + 16 * MT * (_KC + 16) + (_KC // kstep) * _BN * 4
    return _STAGES * stage + nspan * MT * 8 * _THREADS * 4


def _w8_stages(kw: int) -> int:
    return 4 if kw == 1 else 3


def _w8_smem_bytes(MT: int, kstep: int, kw: int, nspan: int) -> int:
    """Dynamic shared memory of one K7 block (``w8_smem_bytes`` in the
    source): 1 KB to align the tiles and the split hand-over's barrier; per
    ring stage the weight tile (128 * kw rows of 128 bytes), kw activation
    tiles (16 * MT rows of 128 bytes), the fold-scale slots and two
    barriers; the k-warps' int32 exchange (two slots at two k-warps), the
    slot the previous split's sums arrive in and ``nspan`` held fold spans,
    each slot one fragment set of the 128 accumulator threads (16 * MT words
    each)."""
    kc = _W8_RANGE * kw
    stage = kc * _W8_BN + kw * 16 * MT * _W8_BN + (kc // kstep) * _W8_BN * 4 + 16
    return (1024 + 16 + _w8_stages(kw) * stage
            + (2 * (kw - 1) + 1 + nspan) * 16 * MT * _W8_BN * 4)


def _w8_split_rows(C: int, F: int, S: int, kw: int) -> List[int]:
    """K7's splits: whole chunks of 128 * kw rows of whole fold spans
    (units of lcm(F, 32, 128 * kw) rows), as even as the units allow, in
    order; the last ends at C."""
    unit = math.lcm(F, 32, _W8_RANGE * kw)
    n = C // unit
    return [s * n // S * unit for s in range(S)] + [C]


def _w8_kwarps(F: int) -> List[int]:
    """k-warps per column K7 can run at fold span F: 1 always; 2 (each
    taking 128 rows of a chunk) where the spans are whole 128-row runs."""
    return [1] + ([2] if F % _W8_RANGE == 0 else [])


def _row_tiles(M: int) -> Tuple[int, int]:
    """(MT, row tiles): 16*MT activation rows per block."""
    MT = min(4, -(-M // 16))
    return MT, -(-M // (16 * MT))


def _split_rows(C: int, F: int, S: int) -> List[int]:
    """Contraction rows of S splits: whole fold spans on 32-row steps (units
    of lcm(F, 32) rows), as even as the units allow, in order."""
    unit = math.lcm(F, 32)
    n = C // unit
    return [s * n // S * unit for s in range(S + 1)]


def _held_spans(rows, F: int) -> int:
    """The most fold spans one split s > 0 holds as terms."""
    return max((b - a for a, b in zip(rows[1:], rows[2:])), default=0) // F


def allowed_splits(C: int, nG: int, Wn: int, M: int, sm_count: int) -> List[int]:
    """Split counts the kernels take at this shape: at most one split per
    unit of rows and ``_MAX_SPLITS``, and a grid that is co-resident on
    ``sm_count`` SMs (a split waits for its predecessor), by the shared
    memory each block needs."""
    F = _fold_span(C, nG)
    MT, rt = _row_tiles(M)
    tiles = Wn // _BN * rt
    out = [1]
    for S in range(2, min(C // math.lcm(F, 32), _MAX_SPLITS) + 1):
        nspan = _held_spans(_split_rows(C, F, S), F)
        per_sm = min(_BLOCKS_BY_REGISTERS,
                     _SMEM_PER_SM // (_smem_bytes(MT, _kstep(F), nspan) + 1024))
        if per_sm * sm_count >= tiles * S:
            out.append(S)
    return out


@functools.lru_cache(maxsize=None)  # once per shape: the launch path is host-bound
def plan_splits(C: int, nG: int, Wn: int, M: int, sm_count: int,
                splits: Optional[int] = None) -> Tuple[int, Tuple[int, ...]]:
    """(S, rows): the split of C the kernels run, split s owning contraction
    rows [rows[s], rows[s+1]). S is the smallest allowed count whose grid
    covers the SMs (1 where the column and row tiles already do), else the
    largest allowed one. ``splits`` forces a count (tests; it must be
    allowed)."""
    allowed = allowed_splits(C, nG, Wn, M, sm_count)
    if splits is not None:
        if splits not in allowed:
            raise ValueError(f"qmm: {splits} splits not allowed at C={C} nG={nG} Wn={Wn} "
                             f"M={M} (allowed {allowed})")
        S = splits
    else:
        tiles = Wn // _BN * _row_tiles(M)[1]
        S = next((s for s in allowed if tiles * s >= sm_count), allowed[-1])
    return S, tuple(_split_rows(C, _fold_span(C, nG), S))


def w8a8_allowed_plans(C: int, nG: int, Wn: int, M: int, sm_count: int) -> List[Tuple[int, int]]:
    """(kw, S) pairs K7 takes at this shape, by kw then S: k-warps the fold
    span allows (:func:`_w8_kwarps`), at most one split per unit of rows
    (:func:`_w8_split_rows`) and ``_W8_MAX_SPLITS``, and shared memory within
    a block's. A split grid (its tiles' splits are clusters, one block per
    SM) stays within ``_W8_SPLIT_SHARE`` of the SMs: beyond it the clusters
    measured a second wave on an H100 (the SMs left in each GPC do not take
    another cluster)."""
    F = _fold_span(C, nG)
    MT, rt = _row_tiles(M)
    if Wn % _W8_BN:
        return []
    tiles = Wn // _W8_BN * rt
    out = []
    for kw in _w8_kwarps(F):
        for S in range(1, max(1, min(C // math.lcm(F, 32, _W8_RANGE * kw), _W8_MAX_SPLITS)) + 1):
            rows = _w8_split_rows(C, F, S, kw)
            smem = _w8_smem_bytes(MT, _kstep(F), kw, _held_spans(rows, F))
            if smem <= _SMEM_PER_BLOCK and (S == 1 or tiles * S <= _W8_SPLIT_SHARE * sm_count):
                out.append((kw, S))
    return out


@functools.lru_cache(maxsize=None)  # once per shape: the launch path is host-bound
def plan_w8a8(C: int, nG: int, Wn: int, M: int, sm_count: int,
              splits: Optional[int] = None) -> Tuple[int, int, Tuple[int, ...]]:
    """(kw, S, rows): K7's k-warps per column and split of C, split s owning
    contraction rows [rows[s], rows[s+1]). The plan is the allowed one with
    the most blocks; of two with as many, 2 k-warps where the grid is one
    block per SM at most, else 1 (two blocks share an SM). ``splits`` forces
    the split count (tests; it must be allowed)."""
    plans = [p for p in w8a8_allowed_plans(C, nG, Wn, M, sm_count)
             if splits is None or p[1] == splits]
    if not plans:
        raise ValueError(f"quantized_matmul_int8: {splits} splits not allowed at "
                         f"C={C} nG={nG} Wn={Wn} M={M}")
    tiles = Wn // _W8_BN * _row_tiles(M)[1]

    def key(p):
        blocks = tiles * p[1]
        return blocks, p[0] if blocks <= sm_count else -p[0]

    pick = max(plans, key=key)
    return pick[0], pick[1], tuple(_w8_split_rows(C, _fold_span(C, nG), pick[1], pick[0]))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int):
    """K6's split workspace of (device, stream): running fp32 sums [tiles,
    MT*8, 128] and one counter per tile, allocated zeroed once and never
    cleared again (the last split of each tile sets its counter back to 0).
    A split grid is co-resident, at most ``_BLOCKS_BY_REGISTERS`` blocks per
    SM, so with S >= 2 it has at most one tile per SM, of at most 4 row
    tiles. (K7's splits hand their sums over inside a cluster.)"""
    key = (device.index, stream)
    if key not in _workspaces:
        sms = _sm_count(device.index)
        _workspaces[key] = (
            torch.zeros(sms * 4 * 8 * _THREADS, dtype=torch.float32, device=device),
            torch.zeros(sms, dtype=torch.int32, device=device))
    return _workspaces[key]


class QuantizedRows(NamedTuple):
    """Activations x [..., C] beside their per-row int8 form: xi [M, C]
    int8 and xs [M] fp32 row scales, M the product of x's leading dims, equal
    to :func:`_quantize_rows` of x.reshape(M, C). K6 takes xi / xs as they
    are (no quantizer launch); every other consumer takes x."""

    x: torch.Tensor
    xi: torch.Tensor
    xs: torch.Tensor


def activations(x) -> torch.Tensor:
    """The activation tensor of ``x`` (a tensor or :class:`QuantizedRows`)."""
    return x.x if isinstance(x, QuantizedRows) else x


def _quantize_rows(x: torch.Tensor):
    # The row scale multiplies by fp32(1/127), as XLA computes a division by
    # a constant; x is then divided by it.
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=1), min=1e-30) * (1.0 / 127.0)
    return torch.round(xf / xs[:, None]).clamp_(-127, 127).to(torch.int8), xs


def quantize_activations(x: torch.Tensor, n_groups: int):
    """Per-row symmetric int8 activations: (x_i8 [M, C], x_scale fp32 [M],
    sumx fp32 [M, n_groups]), sumx[m, g] the integer sum of row m over scale
    group g (the kernels sum the rows themselves)."""
    M, C = x.shape
    xi, xs = _quantize_rows(x)
    sumx = xi.view(M, n_groups, C // n_groups).sum(dim=2, dtype=torch.int32).float()
    return xi, xs, sumx


def _scales3(scale):
    return scale[:, None, :] if scale.ndim == 2 else scale


def _fold_loop(x, q, scale, layer, packed):
    """The kernels' arithmetic: fp32 accumulators of the folded exact
    integer dots, folded one span after another in order. Returns (acc_e,
    acc_o or None, xs)."""
    xi, xs = (x.xi, x.xs) if isinstance(x, QuantizedRows) else _quantize_rows(x)
    M, C = xi.shape
    nG = scale.shape[1]
    F = _fold_span(C, nG)
    nF = C // F
    b = q[layer]
    Wn = b.shape[1]
    xr = xi.double().view(M, nF, F).transpose(0, 1)  # [nF, M, F]
    g0 = torch.bmm(xr, b.double().view(nF, F, Wn))  # exact: |sum| < 2^53
    sg = scale[layer][torch.arange(nF, device=xi.device) * F // (C // nG)]  # [nF, Wn]
    if packed:
        g1 = torch.bmm(xr, (b & 15).double().view(nF, F, Wn))
        xsum = xr.sum(dim=-1, keepdim=True)
        part = torch.stack([g1 - 8 * xsum, g0 - g1]).float()  # [2, nF, M, Wn]
        sg = torch.stack([sg, sg * 0.0625])[:, :, None, :]
    else:
        part = g0.float()[None]
        sg = sg[None, :, None, :]
    acc = torch.zeros((part.shape[0], M, Wn), dtype=torch.float32, device=xi.device)
    for f in range(nF):
        acc = acc + part[:, f] * sg[:, f]
    return acc[0], (acc[1] if packed else None), xs


def _place(ye, yo, interleave, width):
    Wn = ye.shape[1]
    if interleave:
        y = torch.stack([ye, yo], dim=-1).reshape(ye.shape[0], 2 * Wn)
    else:
        y = torch.cat([ye, yo], dim=-1)
    return y[:, :width]


def quantized_matmul_packed_plain(x, q, scale, layer, out_dtype=None, interleave=True,
                                  out_width=None):
    """Plain version of K6 (see :func:`quantized_matmul_packed`)."""
    out_dtype = out_dtype or activations(x).dtype
    scale = _scales3(scale)
    acc_e, acc_o, xs = _fold_loop(x, q, scale, layer, packed=True)
    ye = (acc_e * xs[:, None]).to(out_dtype)
    yo = (acc_o * xs[:, None]).to(out_dtype)
    return _place(ye, yo, interleave, out_width or 2 * q.shape[-1])


def _check_cuda(what, x, q, scale):
    if not (x.is_cuda and q.device == x.device and scale.device == x.device):
        raise ValueError(f"{what} kernel: all tensors must be on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8:
        raise ValueError(f"{what} kernel takes bf16/fp32 activations and int8 weight bytes")
    if scale.dtype != torch.float32 or not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous weights and fp32 scales")


def launch_quantize_rows(x: torch.Tensor):
    """K6's activation quantizer on the card: (xi [M, C] int8, xs [M] fp32)
    of x [M, C] bf16 / fp32, C a multiple of 32 (:func:`_quantize_rows`)."""
    M, C = x.shape
    if x.data_ptr() % 32:  # the quantizer reads 16- / 32-byte vectors
        x = x.clone()
    xi = torch.empty((M, C), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib = _build.library("qmatmul", "qmm_quantize_rows", _QUANTIZE_ARGTYPES)
    code = lib.qmm_quantize_rows(x.data_ptr(), int(x.dtype == torch.float32), xi.data_ptr(),
                                 xs.data_ptr(), M, C,
                                 _build.current_stream(x.device))
    _build.check(lib, code, "qmm_quantize_rows")
    launch_quantize_rows.launches += 1
    return xi, xs


launch_quantize_rows.launches = 0


def _launch(entry, x, q, scale, layer, out_dtype, out_width, riffle=False, splits=None,
            x_int8=None):
    """``x_int8``: the int8 rows (xi, xs) of x, already made (no quantizer
    launch)."""
    M, C = x.shape
    Lf, Cq, Wn = q.shape
    nG = scale.shape[1]
    F = _fold_span(C, nG)
    if (Cq != C or scale.shape != (Lf, nG, Wn) or not 1 <= M <= 256 or C % 32 or C % nG
            or (C // nG) % 8 or F % 8 or C % F or Wn % 32 or not 0 <= int(layer) < Lf):
        raise ValueError(f"{entry} kernel: unsupported shape x={tuple(x.shape)} "
                         f"q={tuple(q.shape)} scale={tuple(scale.shape)} layer={layer} "
                         "(needs M <= 256, scale groups a multiple of 8 rows, C a multiple "
                         "of 32, a stored width that is a multiple of 32)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{entry} kernel writes bf16 or fp32, not {out_dtype}")
    sms = _sm_count(x.device.index)
    if entry == "qmm_w8a8":
        kw, S, rows = plan_w8a8(C, nG, Wn, M, sms, splits)
    else:
        S, rows = plan_splits(C, nG, Wn, M, sms, splits)
    stream = _build.current_stream(x.device)
    if x_int8 is None:
        xi, xs = launch_quantize_rows(x)
    else:
        xi, xs = x_int8
        if not (xi.shape == (M, C) and xi.dtype == torch.int8 and xi.is_contiguous()
                and xs.shape == (M,) and xs.dtype == torch.float32 and xi.device == x.device
                and xs.device == x.device):
            raise ValueError(f"{entry} kernel: int8 rows must be [M, C] int8 and [M] fp32 "
                             f"beside x [{M}, {C}] on its device")
    out = torch.empty((M, out_width), dtype=out_dtype, device=x.device)
    args = (xi.data_ptr(), xs.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), M, C, Wn, nG, F, int(layer))
    rows_c = (ctypes.c_int * (S + 1))(*rows)
    if entry == "qmm_w8a8":
        lib = _build.library("qmatmul", entry, _W8A8_ARGTYPES)
        code = lib.qmm_w8a8(*args, kw, rows_c, S, stream)
    else:
        ws, counters = _workspace(x.device, stream) if S > 1 else (None, None)
        lib = _build.library("qmatmul", entry, _ARGTYPES)
        code = lib.qmm_w4a8(*args, out_width, out_width, int(riffle), rows_c, S,
                            None if ws is None else ws.data_ptr(),
                            None if counters is None else counters.data_ptr(), stream)
    _build.check(lib, code, entry)
    return out


def launch_quantized_matmul_packed(x, q, scale, layer, out_dtype=None, interleave=True,
                                   out_width=None, _splits=None):
    """K6 on the card: [M, out_width] as :func:`quantized_matmul_packed_plain`.
    ``_splits`` forces the split count (tests)."""
    x_int8 = (x.xi, x.xs) if isinstance(x, QuantizedRows) else None
    x = activations(x)
    _check_cuda("quantized_matmul_packed", x, q, scale)
    scale = _scales3(scale)
    width = out_width or 2 * q.shape[-1]
    if not 0 < width <= 2 * q.shape[-1]:
        raise ValueError(f"quantized_matmul_packed kernel: out_width {width} out of range")
    out = _launch("qmm_w4a8", x.contiguous(), q, scale, layer, out_dtype or x.dtype, width,
                  not interleave, _splits, x_int8)
    launch_quantized_matmul_packed.launches += 1
    return out


launch_quantized_matmul_packed.launches = 0


def quantized_matmul_packed(x, q, scale, layer, out_dtype=None, interleave=True,
                            out_width=None):
    """W4A8 matmul: x [M, C] bf16/fp32 against layer ``layer`` of the
    stacked packed weight q [Lf, C, Oh] with paired scales [Lf, (nG,) Oh].
    Returns [M, out_width] (default 2*Oh) in ``out_dtype`` (default x's):
    canonical column order when ``interleave`` (classic packing), the
    [evens | odds] halves otherwise (riffle packing: also canonical). Output
    columns past ``out_width`` (lane-alignment padding) are not written.
    ``x`` may be :class:`QuantizedRows`: its int8 rows are used as they are."""
    if activations(x).is_cuda:
        return launch_quantized_matmul_packed(x, q, scale, layer, out_dtype, interleave,
                                              out_width)
    return quantized_matmul_packed_plain(x, q, scale, layer, out_dtype, interleave, out_width)


def _check_int8_shape(x, q, scale):
    M, C = x.shape
    O = q.shape[-1]
    nG = _scales3(scale).shape[1]
    if not qmm_supported(C, O, nG, M) or O % 128:
        raise ValueError(f"quantized_matmul_int8: unsupported shape C={C}, O={O}, nG={nG}, "
                         f"M={M} (needs O%128==0, a legal C block, M<=256)")


def quantized_matmul_int8_plain(x, q, scale, layer, out_dtype=None):
    """Plain version of K7 (see :func:`quantized_matmul_int8`)."""
    _check_int8_shape(x, q, scale)
    acc, _, xs = _fold_loop(x, q, _scales3(scale), layer, packed=False)
    return (acc * xs[:, None]).to(out_dtype or x.dtype)


def launch_quantized_matmul_int8(x, q, scale, layer, out_dtype=None, _splits=None):
    """K7 on the card: [M, O] as :func:`quantized_matmul_int8_plain`.
    ``_splits`` forces the split count (tests)."""
    _check_cuda("quantized_matmul_int8", x, q, scale)
    _check_int8_shape(x, q, scale)
    out = _launch("qmm_w8a8", x.contiguous(), q, _scales3(scale), layer,
                  out_dtype or x.dtype, q.shape[-1], splits=_splits)
    launch_quantized_matmul_int8.launches += 1
    return out


launch_quantized_matmul_int8.launches = 0


def quantized_matmul_int8(x, q, scale, layer, out_dtype=None):
    """W8A8 matmul: x [M, C] against layer ``layer`` of int8 weights
    q [Lf, C, O] with scales [Lf, (nG,) O]. As in the JAX package, no model
    path routes to it: int8 weight-only matmuls dequantize into a plain
    dot."""
    if x.is_cuda:
        return launch_quantized_matmul_int8(x, q, scale, layer, out_dtype)
    return quantized_matmul_int8_plain(x, q, scale, layer, out_dtype)
