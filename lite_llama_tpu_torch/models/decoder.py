"""Generic decoder-only transformer, Llama-3.x / Qwen2.5 / Qwen3 (port of
``lite_llama_tpu/models/decoder.py``).

The architectural deltas are config flags: q/k/v biases (qwen2,
``cfg.attention_bias``), per-head q/k RMSNorm before RoPE (qwen3,
``cfg.qk_norm``), tied or untied lm_head. Parameters are a dict of stacked
per-layer tensors with the JAX package's layout (wq [L, H, Nq, D],
wkv [L, H, 2, Nkv, D], o_proj [L, Nq, D, H], gate_up_proj [L, 2, H, I],
down_proj [L, I, H], ...), so a JAX tree converts one to one
(utils/weights.py params_from_numpy). The layers run as a Python loop.

KV lands in the paged pool (executor/kv_cache.py) and attention reads it
through the page table. Decode keeps the virtual-page protocol: each layer's
new K/V goes into attention beside the pool, and all layers are written to
the pool once after the loop. The projections are plain matrix products
(``torch.matmul``), as the JAX package leaves them to XLA; norms, SwiGLU and
attention go through ``ops`` (the hand-written kernels on the card).

Quantized weights (``quant/qtensor.py`` QTensor leaves, from
``quantize_decoder_params``) go through ``qeinsum`` on every projection:
each layer reads its slice of the stacked QTensor by index, so packed int4
rides the W4A8 kernel (K6) without a per-layer copy. A fused ``wqkv``
(``fuse_qkv_params``) and the flat riffle ``gate_up_proj`` [L, H, 2I] are
taken as the JAX decoder takes them. Where a projection runs on K6, the
norm or SwiGLU before it also writes the int8 rows K6 takes
(``_int8_rows``), so K6 launches no quantizer of its own; o_proj's input is
attention's output, and keeps K6's quantizer.

``decoder_prefill`` also takes ``inputs_embeds`` in place of token ids, as
LLaVA's prefill hands it the merged text and image rows
(``models/llava.py``).

Tensor parallelism (``shard``, a ``parallel.shardings.ShardingPolicy`` with
tp > 1): each rank runs its shard of the tree (``shard_params``) as a
one-device tree of its Nq/tp query heads, Hkv/tp kv heads, I/tp ffn columns
and V/tp vocab rows, against its own pool, with the collectives the JAX
package's GSPMD inserts made explicit: a masked embedding gather and an
all-reduce, the tp attention wrappers on the local heads
(``parallel/tp_attention.py``), an all-reduce of o_proj's and of down's
fp32 partials, and an all-gather of the vocab-sharded logits. With no
policy (tp 1) the one-device path runs as it always did.

Context parallelism (``shard`` with cp > 1; it composes with neither tp nor
dp): the weights are whole on every rank and the pool holds the rank's share
of the pages (``parallel/context_parallel.py``). Fresh prefill runs whole on
every rank (K2) and only its KV write splits; chunked prefill and prefix
hits go through ``cp_flash_prefill_chunked``, decode through
``cp_paged_flash_decode``: each rank's kernels walk its own pages, and one
all-gather of their states a layer combines them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..executor.kv_cache import KVPool, kv_write_decode_all, kv_write_prefill
from ..ops.qmatmul import activations
from ..parallel import context_parallel, tp_attention
from ..parallel.shardings import ShardingPolicy
from ..quant.qtensor import QTensor, qeinsum, takes_int8_rows
from .rotary import compute_inv_freq_dual

_NOSHARD = ShardingPolicy()


class AttnContext(NamedTuple):
    """Per-step attention metadata."""

    table_rows: torch.Tensor  # int32 [B, pages_per_req] page-table rows
    seq_lens: torch.Tensor  # int32 [B] stored tokens incl. this step
    start_pos: torch.Tensor  # int32 [B] first position written this step
    chunk_lens: torch.Tensor  # int32 [B] valid tokens in this chunk (prefill)
    active: Optional[torch.Tensor] = None  # bool [B] decode: still generating


# ---------------------------------------------------------------------------
# Param init (random; real weights come through utils/weights.py)


def init_decoder_params(cfg, generator: torch.Generator, scale: float = 0.02) -> dict:
    """Random parameter tree: N(0, scale) weights, unit norms, zero biases,
    drawn from ``generator`` on its device."""
    device = generator.device
    L, H, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    Nq, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    I, V = cfg.intermediate_size, cfg.vocab_size
    dt = cfg.dtype

    def init(*shape):
        w = torch.empty(shape, dtype=dt, device=device)
        return w.normal_(0.0, scale, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, H),
        "wq": init(L, H, Nq, D),
        "wkv": init(L, H, 2, Nkv, D),
        "o_proj": init(L, Nq, D, H),
        "mlp_norm": ones(L, H),
        "gate_up_proj": init(L, 2, H, I),
        "down_proj": init(L, I, H),
    }
    if cfg.attention_bias:
        layers["q_bias"] = zeros(L, Nq, D)
        layers["kv_bias"] = zeros(L, 2, Nkv, D)
    if getattr(cfg, "qk_norm", False):
        layers["q_norm"] = ones(L, D)
        layers["k_norm"] = ones(L, D)
    params = {"embed": init(V, H), "layers": layers, "final_norm": ones(H)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(H, V)
    return params


def fuse_qkv_params(params: dict, tp: int = 1) -> dict:
    """Fuse wq + wkv into one ``wqkv [L, H, Nq+2*Nkv, D]`` weight (and the
    biases into ``qkv_bias``): one projection per layer instead of two.

    The head order is SHARD-PERIODIC for the tensor-parallel degree ``tp``,
    as the JAX package lays it out: [q(0) k(0) v(0) | q(1) k(1) v(1) | ...],
    (s) being shard s's contiguous slice of each projection, so a contiguous
    tp shard of the fused head axis is exactly one shard's (q, k, v) group
    (tp 1: [q | k | v]). Works on plain tensors and on QTensors, whose bytes
    and (paired) scales reorder along the flat output axis; riffle-packed
    QTensors cannot be byte-fused (``quantize_decoder_params(riffle=True)``
    fuses before packing). Returns a new tree; a no-op if already fused."""
    if "wqkv" in params["layers"] or "wq" not in params["layers"]:
        return params
    layers = dict(params["layers"])
    wq, wkv = layers.pop("wq"), layers.pop("wkv")
    Nq, Nkv = (wq.out_shape[0], wkv.out_shape[-2]) if isinstance(wq, QTensor) else (
        wq.shape[2], wkv.shape[3])
    if Nq % tp or Nkv % tp:
        raise ValueError(f"tp={tp} does not divide the {Nq} query and {Nkv} kv heads")
    if isinstance(wq, QTensor):
        if wq.riffle_groups or wkv.riffle_groups:
            raise ValueError("cannot byte-fuse riffle-packed wq/wkv: quantize_decoder_params"
                             "(riffle=True) fuses the weights before packing instead")
        L, H = wq.q.shape[0], wq.q.shape[1]
        Nq, D = wq.out_shape
        Nkv = wkv.out_shape[-2]
        # Packed int4 halves the stored O axis; every shard boundary below is
        # a multiple of D (even), so no nibble pair is split.
        pk = 2 if wq.packed else 1

        def periodic(a, b, lead):
            qs = a.reshape(*lead, tp, (Nq // tp) * D // pk)
            kv = b.reshape(*lead, 2, tp, (Nkv // tp) * D // pk)
            return torch.cat([qs, kv[..., 0, :, :], kv[..., 1, :, :]], dim=-1).reshape(
                *lead, tp * ((Nq + 2 * Nkv) // tp) * D // pk)

        layers["wqkv"] = QTensor(
            q=periodic(wq.q, wkv.q, (L, H)),
            scale=periodic(wq.scale, wkv.scale, tuple(wq.scale.shape[:-1])),
            unit_shape=(H, Nq + 2 * Nkv, D), out_shape=(Nq + 2 * Nkv, D), packed=wq.packed)
    else:
        L, H, Nq, D = wq.shape
        Nkv = wkv.shape[3]
        qs = wq.reshape(L, H, tp, Nq // tp, D)
        ks = wkv[:, :, 0].reshape(L, H, tp, Nkv // tp, D)
        vs = wkv[:, :, 1].reshape(L, H, tp, Nkv // tp, D)
        layers["wqkv"] = torch.cat([qs, ks, vs], dim=3).reshape(L, H, Nq + 2 * Nkv, D)
    if "q_bias" in layers:
        qb, kvb = layers.pop("q_bias"), layers.pop("kv_bias")
        L, Nq, D = qb.shape
        Nkv = kvb.shape[2]
        qbs = qb.reshape(L, tp, Nq // tp, D)
        kbs = kvb[:, 0].reshape(L, tp, Nkv // tp, D)
        vbs = kvb[:, 1].reshape(L, tp, Nkv // tp, D)
        layers["qkv_bias"] = torch.cat([qbs, kbs, vbs], dim=2).reshape(L, Nq + 2 * Nkv, D)
    return dict(params, layers=layers)


def _unstack_layers(params: dict):
    """Per-layer views of the stacked weights: one ``unbind`` per plain key,
    and each QTensor at its layer index (still stacked, no copy)."""
    layers = params["layers"]
    plain = [k for k in layers if not isinstance(layers[k], QTensor)]
    quant = [k for k in layers if isinstance(layers[k], QTensor)]
    cols = [torch.unbind(layers[k], 0) for k in plain]
    L = layers[(plain or quant)[0]].shape[0]
    out = [dict(zip(plain, vals)) for vals in zip(*cols)] if plain else [{} for _ in range(L)]
    for li, lp in enumerate(out):
        for k in quant:
            lp[k] = layers[k].at_layer(li)
    return out


# ---------------------------------------------------------------------------
# Shared layer math


def _project_qkv(cfg, lp, x, shard=_NOSHARD):
    """x [..., H] (or its ``QuantizedRows``, for QTensor weights) -> q [...,
    Nq, D], k/v [..., Nkv, D], from wq + wkv or the fused wqkv; under
    tensor parallelism the rank's Nq/tp and Nkv/tp heads (its shard of the
    weights holds only those)."""
    Nq, Nkv = cfg.num_attention_heads // shard.tp, cfg.num_key_value_heads // shard.tp
    D = cfg.head_dim
    xt = activations(x)
    H = xt.shape[-1]
    batch = xt.shape[:-1]
    if "wqkv" in lp:
        w = lp["wqkv"]
        if isinstance(w, QTensor):
            qkv = qeinsum("...h,hnd->...nd", x, w, shard=shard, tp_kind="out")
        else:
            qkv = torch.matmul(xt, w.reshape(H, -1)).view(*batch, Nq + 2 * Nkv, D)
        if "qkv_bias" in lp:
            qkv = qkv + lp["qkv_bias"]
        # Unfuse with the tp the head order was built for: a quantizer-fused
        # tree records it; a rank's shard is one canonical (q, k, v) group.
        t = getattr(w, "fused_tp", 0) or 1
        g = qkv.reshape(*batch, t, (Nq + 2 * Nkv) // t, D)
        nq, nkv = Nq // t, Nkv // t
        q = g[..., :nq, :].reshape(*batch, Nq, D)
        k = g[..., nq:nq + nkv, :].reshape(*batch, Nkv, D)
        v = g[..., nq + nkv:, :].reshape(*batch, Nkv, D)
    else:
        wq, wkv = lp["wq"], lp["wkv"]
        if isinstance(wq, QTensor):
            q = qeinsum("...h,hnd->...nd", x, wq, shard=shard, tp_kind="out")
        else:
            q = torch.matmul(xt, wq.reshape(H, Nq * D)).view(*batch, Nq, D)
        if isinstance(wkv, QTensor):
            kv = qeinsum("...h,hcnd->...cnd", x, wkv)
        else:
            kv = torch.matmul(xt, wkv.reshape(H, 2 * Nkv * D)).view(*batch, 2, Nkv, D)
        if "q_bias" in lp:
            q = q + lp["q_bias"]
            kv = kv + lp["kv_bias"]
        k = kv[..., 0, :, :]
        v = kv[..., 1, :, :]
    if "q_norm" in lp:
        q = ops.rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = ops.rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return q, k, v


def _int8_rows(params: dict, M: int):
    """Which kernels of a forward over M rows also write the int8 rows K6
    takes (``ops.skip_rms_norm`` / ``ops.swiglu`` with ``int8_rows``): the
    attention norm, the MLP norm, SwiGLU and the final norm, each where
    every projection it feeds is a QTensor and one of them runs on K6 at M
    rows (``takes_int8_rows``). Every layer has the same shapes, so layer
    0 decides for all."""
    layers = params["layers"]

    def feeds(*keys):
        ws = [layers[k] for k in keys if k in layers]
        return (bool(ws) and all(isinstance(w, QTensor) for w in ws)
                and any(takes_int8_rows(w.at_layer(0), M) for w in ws))

    qkv = ("wqkv",) if "wqkv" in layers else ("wq", "wkv")
    return (feeds(*qkv), feeds("gate_up_proj"), feeds("down_proj"),
            takes_int8_rows(params.get("lm_head"), M))


def _contract(x: torch.Tensor, w: torch.Tensor, shard) -> torch.Tensor:
    """x [M, C] @ w [C, O] of a weight whose contraction tp shards: the
    rank's fp32 partial product, all-reduced, in x's dtype (one device: the
    product as it always was)."""
    if shard.tp == 1:
        return torch.matmul(x, w)
    if x.is_cuda and x.dtype == w.dtype != torch.float32:
        part = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    else:
        part = x.reshape(-1, x.shape[-1]).float() @ w.float()
    return shard.all_reduce(part).to(x.dtype).view(*x.shape[:-1], w.shape[-1])


def _blocked_swiglu(y, blocks: int, quarters: bool, int8_rows: bool):
    """SwiGLU of a flat gate_up output in its block layout: per block b,
    [gate_b | up_b] (riffle), or the σ quarters [ge_b | ue_b | go_b | uo_b]
    whose products land in the σ row order down_proj was quantized for.
    One K4 call on the gathered gate and up columns."""
    if quarters:
        q = y.shape[-1] // (4 * blocks)
        y5 = y.reshape(*y.shape[:-1], blocks, 2, 2, q)  # (block, even|odd, gate|up, q)
        gate, up = y5[..., 0, :], y5[..., 1, :]
    else:
        q = y.shape[-1] // (2 * blocks)
        y4 = y.reshape(*y.shape[:-1], blocks, 2, q)  # (block, gate|up, q)
        gate, up = y4[..., 0, :], y4[..., 1, :]
    width = y.shape[-1] // 2
    if blocks == 1 and not quarters:
        return ops.swiglu(gate.reshape(*y.shape[:-1], width), up.reshape(*y.shape[:-1], width),
                          int8_rows=int8_rows)
    return ops.swiglu(gate.reshape(*y.shape[:-1], width).contiguous(),
                      up.reshape(*y.shape[:-1], width).contiguous(), int8_rows=int8_rows)


def _mlp(lp, x, int8_rows=False, shard=_NOSHARD):
    """SwiGLU MLP of x (or of ``QuantizedRows``, for a packed gate_up);
    ``int8_rows``: SwiGLU also writes the int8 rows of down's input. Under
    tensor parallelism the rank's ffn slice, down's partials all-reduced."""
    w = lp["gate_up_proj"]  # [2, H, I]; quantized riffle / σ: flat [H, 2I], in blocks
    if isinstance(w, QTensor) and w.n_stack == 1:
        y = qeinsum("...h,hj->...j", x, w, shard=shard, tp_kind="out")
        if w.sigma_out:
            out = _blocked_swiglu(y, w.sigma_groups, True, int8_rows)
        else:
            out = _blocked_swiglu(y, max(w.riffle_groups, 1), False, int8_rows)
    elif isinstance(w, QTensor):
        gu = qeinsum("...h,chi->...ci", x, w, shard=shard, tp_kind="out")
        out = ops.swiglu(gu[..., 0, :], gu[..., 1, :], int8_rows=int8_rows)
    else:
        out = ops.swiglu(torch.matmul(x, w[0]), torch.matmul(x, w[1]))
    down = lp["down_proj"]
    if isinstance(down, QTensor):
        return qeinsum("...i,ih->...h", out, down, shard=shard, tp_kind="contract")
    return _contract(out, down, shard)


def _attn_out(lp, attn, shard=_NOSHARD):
    w = lp["o_proj"]
    if isinstance(w, QTensor):
        return qeinsum("...nd,ndh->...h", attn, w, shard=shard, tp_kind="contract")
    flat = attn.reshape(*attn.shape[:-2], -1)
    return _contract(flat, w.reshape(flat.shape[-1], -1), shard)


def _embed(params, input_ids, shard=_NOSHARD):
    """The ids' embedding rows. Under tensor parallelism each rank holds
    V/tp rows: it gathers the ids in its range (zeros elsewhere) and the
    all-reduce sums one row and zeros, exactly."""
    emb = params["embed"]
    if shard.tp == 1:
        return emb[input_ids]
    n = emb.shape[0]
    local = input_ids - shard.rank * n
    ok = (local >= 0) & (local < n)
    rows = emb[local.clamp(0, n - 1)] * ok[..., None].to(emb.dtype)
    return shard.all_reduce(rows)


def _unembed(params, cfg, normed, shard=_NOSHARD):
    """fp32 logits, as the JAX package computes them. A quantized head:
    qeinsum with fp32 output. Untied: the product in
    the activation dtype, then fp32 (the JAX einsum returns the activation
    dtype). Tied: fp32 accumulation AND fp32 output, with no bf16 rounding
    of the logits (cuBLAS's ``out_dtype`` on the card; an fp32 product on the
    CPU, where only the tests run). Under tensor parallelism each rank
    computes its vocab slice and the slices are gathered (and cut back to
    the vocabulary, past a quantized head's padding)."""
    w = params.get("lm_head")
    if isinstance(w, QTensor):
        if w.packed and w.layer is None:
            # The packed head runs as layer 0 of a 1-deep stack: the
            # largest matmul of the step streams through K6 too.
            w = dataclasses.replace(w, q=w.q[None], scale=w.scale[None], layer=0)
        out = qeinsum("...h,hv->...v", normed, w, out_dtype=torch.float32, shard=shard,
                      tp_kind="out")
    elif w is not None:
        out = torch.matmul(normed, w).float()
    else:
        emb_t = params["embed"].t()
        flat = normed.reshape(-1, normed.shape[-1])
        if flat.dtype == torch.float32:
            out = torch.mm(flat, emb_t)
        elif flat.is_cuda:
            out = torch.mm(flat, emb_t, out_dtype=torch.float32)
        else:
            out = torch.mm(flat.float(), emb_t.float())
        out = out.view(*normed.shape[:-1], -1)
    if shard.tp == 1:
        return out
    return shard.all_gather_last(out)[..., :cfg.vocab_size]


_ROPE_TABLES = {}  # (rope fields, device) -> (inv_freq, short-or-None, threshold, scale)


def _inv_freq_tables(cfg, device):
    """compute_inv_freq_dual on ``device``, cached: a fresh host->device copy
    every decode step would make the host wait for the device."""
    key = (cfg.head_dim, cfg.rope_theta, repr(cfg.rope_scaling),
           cfg.max_position_embeddings, cfg.max_seq_len, str(device))
    tables = _ROPE_TABLES.get(key)
    if tables is None:
        inv_freq, short, threshold, att_scale = compute_inv_freq_dual(cfg)
        tables = (
            torch.as_tensor(inv_freq, device=device),
            None if short is None else torch.as_tensor(short, device=device),
            threshold,
            att_scale,
        )
        _ROPE_TABLES[key] = tables
    return tables


def _rope_tables(cfg, positions, seq_lens=None):
    """cos/sin for the step's positions; dynamic-NTK checkpoints select the
    table per request by live sequence length (models/rotary.py)."""
    long_t, short_t, threshold, att_scale = _inv_freq_tables(cfg, positions.device)
    if short_t is not None and seq_lens is not None:
        per_req = torch.where((seq_lens > threshold)[:, None], long_t[None], short_t[None])
        return ops.rope_cos_sin(positions, per_req, att_scale)
    return ops.rope_cos_sin(positions, long_t, att_scale)


# ---------------------------------------------------------------------------
# Prefill forward: [B, S] tokens -> logits


def decoder_prefill(params: dict, cfg, kv_pages: KVPool, ctx: AttnContext,
                    input_ids: Optional[torch.Tensor] = None, last_only: bool = False,
                    chunked: bool = False, hist_bound: Optional[int] = None, shard=None,
                    inputs_embeds: Optional[torch.Tensor] = None):
    """Returns (logits, kv_pages): logits [B, S, V] fp32, or [B, V] for each
    request's last valid position with ``last_only``. Writes the chunk's K/V
    into the pool in place.

    ``chunked=True``: this call is one chunk of a longer prompt (or the tail
    after a prefix-cache hit): ``ctx.start_pos`` tokens per request are
    already in the pool, and attention covers [pool history | causal chunk
    prefix] (K5 on the card). ``hist_bound`` bounds the history the plain
    CPU form gathers; the kernel walks each request's own pages.

    ``inputs_embeds`` [B, S, H] (cast to ``cfg.dtype``) replace the ids'
    embedding rows. ``shard``: the tensor-parallel policy (module
    docstring); ``params`` and ``kv_pages`` are then this rank's shards."""
    shard = shard or _NOSHARD
    if inputs_embeds is None:
        h = _embed(params, input_ids, shard)
    else:
        h = inputs_embeds.to(cfg.dtype)
    B, S, _ = h.shape
    positions = ctx.start_pos.long()[:, None] + torch.arange(S, device=h.device)
    cos, sin = _rope_tables(cfg, positions, ctx.seq_lens)
    sm_scale = 1.0 / (cfg.head_dim**0.5)
    eps = cfg.rms_norm_eps
    x, residual = h, torch.zeros_like(h)
    rows_attn, rows_mlp, rows_down, _ = _int8_rows(params, B * S)
    for li, lp in enumerate(_unstack_layers(params)):
        normed, residual = ops.skip_rms_norm(x, residual, lp["attn_norm"], eps,
                                             int8_rows=rows_attn)
        q, k, v = _project_qkv(cfg, lp, normed, shard)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        kv_write_prefill(kv_pages, li, k, v, ctx.table_rows, ctx.start_pos, ctx.chunk_lens)
        if shard.cp > 1 and chunked:
            attn = context_parallel.cp_flash_prefill_chunked(
                q, k, v, ctx.chunk_lens, ctx.start_pos, kv_pages, li, ctx.table_rows, shard,
                sm_scale)
        elif shard.tp > 1 and chunked:
            attn = tp_attention.tp_flash_prefill_chunked(
                q, k, v, ctx.chunk_lens, ctx.start_pos, kv_pages, li, ctx.table_rows, shard,
                cfg.num_key_value_heads, sm_scale, max_hist_len=hist_bound)
        elif shard.tp > 1:
            attn = tp_attention.tp_flash_prefill(q, k, v, ctx.chunk_lens, sm_scale)
        elif chunked:
            attn = ops.chunked_prefill_attention(
                q, k, v, ctx.chunk_lens, ctx.start_pos, kv_pages, li, ctx.table_rows,
                sm_scale, max_hist_len=hist_bound,
            )
        else:
            attn = ops.prefill_attention(q, k, v, ctx.chunk_lens, sm_scale)
        normed2, residual = ops.skip_rms_norm(
            _attn_out(lp, attn, shard), residual, lp["mlp_norm"], eps, int8_rows=rows_mlp
        )
        x = _mlp(lp, normed2, rows_down, shard)
    if last_only:  # the norm is per row: normalise only the rows the head reads
        last = torch.clamp(ctx.chunk_lens.long() - 1, min=0)
        rows = torch.arange(B, device=h.device)
        x, residual = x[rows, last], residual[rows, last]
    normed, _ = ops.skip_rms_norm(x, residual, params["final_norm"], eps,
                                  int8_rows=_int8_rows(params, x.numel() // x.shape[-1])[3])
    return _unembed(params, cfg, normed, shard), kv_pages


# ---------------------------------------------------------------------------
# Decode forward: one token per request -> next-token logits


def decoder_decode(params: dict, cfg, kv_pages: KVPool, ctx: AttnContext,
                   input_ids: torch.Tensor, shard=None):
    """Returns (logits [B, V] fp32, kv_pages). ``ctx.start_pos`` is the
    position being written (seq_len - 1 after allocation); ``ctx.seq_lens``
    includes the new token. ``shard``: the tensor-parallel policy (module
    docstring)."""
    shard = shard or _NOSHARD
    h = _embed(params, input_ids, shard)  # [B, H]
    cos, sin = _rope_tables(cfg, ctx.start_pos, ctx.seq_lens)  # [B, D/2]
    sm_scale = 1.0 / (cfg.head_dim**0.5)
    eps = cfg.rms_norm_eps
    x, residual = h, torch.zeros_like(h)
    ks, vs = [], []
    rows_attn, rows_mlp, rows_down, rows_head = _int8_rows(params, h.shape[0])
    for li, lp in enumerate(_unstack_layers(params)):
        normed, residual = ops.skip_rms_norm(x, residual, lp["attn_norm"], eps,
                                             int8_rows=rows_attn)
        q, k, v = _project_qkv(cfg, lp, normed, shard)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        if shard.cp > 1:
            attn = context_parallel.cp_paged_flash_decode(
                q, kv_pages, li, ctx.table_rows, ctx.seq_lens, shard, sm_scale, k_new=k, v_new=v)
        elif shard.tp > 1:
            attn = tp_attention.tp_paged_flash_decode(
                q, kv_pages, li, ctx.table_rows, ctx.seq_lens, shard, cfg.num_key_value_heads,
                sm_scale, k_new=k, v_new=v)
        else:
            attn = ops.paged_decode_attention(
                q, kv_pages, li, ctx.table_rows, ctx.seq_lens, sm_scale, k_new=k, v_new=v
            )
        normed2, residual = ops.skip_rms_norm(
            _attn_out(lp, attn, shard), residual, lp["mlp_norm"], eps, int8_rows=rows_mlp
        )
        x = _mlp(lp, normed2, rows_down, shard)
        ks.append(k)
        vs.append(v)
    kv_write_decode_all(
        kv_pages, torch.stack(ks), torch.stack(vs), ctx.table_rows, ctx.start_pos, ctx.active
    )
    normed, _ = ops.skip_rms_norm(x, residual, params["final_norm"], eps, int8_rows=rows_head)
    return _unembed(params, cfg, normed, shard), kv_pages
