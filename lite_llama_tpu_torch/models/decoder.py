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

Not ported yet, and refused with NotImplementedError: sharding (tp/cp/dp)
and ``inputs_embeds`` (LLaVA).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..executor.kv_cache import KVPool, kv_write_decode_all, kv_write_prefill
from ..ops.qmatmul import activations
from ..quant.qtensor import QTensor, qeinsum, takes_int8_rows
from .rotary import compute_inv_freq_dual


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


def fuse_qkv_params(params: dict) -> dict:
    """Fuse wq + wkv into one ``wqkv [L, H, Nq+2*Nkv, D]`` weight (and the
    biases into ``qkv_bias``): one projection per layer instead of two.
    Works on plain tensors and on QTensors, whose bytes and (paired) scales
    concatenate along the flat output axis; riffle-packed QTensors cannot be
    byte-fused (``quantize_decoder_params(riffle=True)`` fuses before
    packing). Returns a new tree; a no-op if already fused. The JAX
    package's one-device order (tp = 1); its shard-periodic order for tensor
    parallelism waits for multi-GPU."""
    if "wqkv" in params["layers"] or "wq" not in params["layers"]:
        return params
    layers = dict(params["layers"])
    wq, wkv = layers.pop("wq"), layers.pop("wkv")
    if isinstance(wq, QTensor):
        if wq.riffle_groups or wkv.riffle_groups:
            raise ValueError("cannot byte-fuse riffle-packed wq/wkv: quantize_decoder_params"
                             "(riffle=True) fuses the weights before packing instead")
        H = wq.q.shape[1]
        Nq, D = wq.out_shape
        Nkv = wkv.out_shape[-2]
        layers["wqkv"] = QTensor(
            q=torch.cat([wq.q, wkv.q], dim=-1), scale=torch.cat([wq.scale, wkv.scale], dim=-1),
            unit_shape=(H, Nq + 2 * Nkv, D), out_shape=(Nq + 2 * Nkv, D), packed=wq.packed)
    else:
        L, H, Nq, D = wq.shape
        Nkv = wkv.shape[3]
        layers["wqkv"] = torch.cat([wq, wkv.reshape(L, H, 2 * Nkv, D)], dim=2)
    if "q_bias" in layers:
        qb, kvb = layers.pop("q_bias"), layers.pop("kv_bias")
        layers["qkv_bias"] = torch.cat([qb, kvb.reshape(kvb.shape[0], -1, kvb.shape[-1])], dim=1)
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


def _project_qkv(cfg, lp, x):
    """x [..., H] (or its ``QuantizedRows``, for QTensor weights) -> q [...,
    Nq, D], k/v [..., Nkv, D], from wq + wkv or the fused wqkv."""
    Nq, Nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    xt = activations(x)
    H = xt.shape[-1]
    batch = xt.shape[:-1]
    if "wqkv" in lp:
        w = lp["wqkv"]
        if isinstance(w, QTensor):
            qkv = qeinsum("...h,hnd->...nd", x, w)
        else:
            qkv = torch.matmul(xt, w.reshape(H, -1)).view(*batch, Nq + 2 * Nkv, D)
        if "qkv_bias" in lp:
            qkv = qkv + lp["qkv_bias"]
        q, k, v = qkv[..., :Nq, :], qkv[..., Nq:Nq + Nkv, :], qkv[..., Nq + Nkv:, :]
    else:
        wq, wkv = lp["wq"], lp["wkv"]
        if isinstance(wq, QTensor):
            q = qeinsum("...h,hnd->...nd", x, wq)
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


def _mlp(lp, x, int8_rows=False):
    """SwiGLU MLP of x (or of ``QuantizedRows``, for a packed gate_up);
    ``int8_rows``: SwiGLU also writes the int8 rows of down's input."""
    w = lp["gate_up_proj"]  # [2, H, I]; quantized riffle: flat [H, 2I] = [gate | up]
    if isinstance(w, QTensor) and w.n_stack == 1:
        y = qeinsum("...h,hj->...j", x, w)
        half = y.shape[-1] // 2
        out = ops.swiglu(y[..., :half], y[..., half:], int8_rows=int8_rows)
    elif isinstance(w, QTensor):
        gu = qeinsum("...h,chi->...ci", x, w)
        out = ops.swiglu(gu[..., 0, :], gu[..., 1, :], int8_rows=int8_rows)
    else:
        out = ops.swiglu(torch.matmul(x, w[0]), torch.matmul(x, w[1]))
    down = lp["down_proj"]
    if isinstance(down, QTensor):
        return qeinsum("...i,ih->...h", out, down)
    return torch.matmul(out, down)


def _attn_out(lp, attn):
    w = lp["o_proj"]
    if isinstance(w, QTensor):
        return qeinsum("...nd,ndh->...h", attn, w)
    flat = attn.reshape(*attn.shape[:-2], -1)
    return torch.matmul(flat, w.reshape(flat.shape[-1], -1))


def _unembed(params, cfg, normed):
    """fp32 logits, as the JAX package computes them. A quantized head:
    qeinsum with fp32 output. Untied: the product in
    the activation dtype, then fp32 (the JAX einsum returns the activation
    dtype). Tied: fp32 accumulation AND fp32 output, with no bf16 rounding
    of the logits (cuBLAS's ``out_dtype`` on the card; an fp32 product on the
    CPU, where only the tests run)."""
    w = params.get("lm_head")
    if isinstance(w, QTensor):
        if w.packed and w.layer is None:
            # The packed head runs as layer 0 of a 1-deep stack: the
            # largest matmul of the step streams through K6 too.
            w = dataclasses.replace(w, q=w.q[None], scale=w.scale[None], layer=0)
        return qeinsum("...h,hv->...v", normed, w, out_dtype=torch.float32)
    if w is not None:
        return torch.matmul(normed, w).float()
    emb_t = params["embed"].t()
    flat = normed.reshape(-1, normed.shape[-1])
    if flat.dtype == torch.float32:
        out = torch.mm(flat, emb_t)
    elif flat.is_cuda:
        out = torch.mm(flat, emb_t, out_dtype=torch.float32)
    else:
        out = torch.mm(flat.float(), emb_t.float())
    return out.view(*normed.shape[:-1], -1)


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


def _refuse(shard=None, inputs_embeds=None):
    if shard is not None:
        raise NotImplementedError("sharded (tp/cp/dp) decoding is not ported yet")
    if inputs_embeds is not None:
        raise NotImplementedError("inputs_embeds (LLaVA) is not ported yet")


# ---------------------------------------------------------------------------
# Prefill forward: [B, S] tokens -> logits


def decoder_prefill(params: dict, cfg, kv_pages: KVPool, ctx: AttnContext,
                    input_ids: torch.Tensor, last_only: bool = False, chunked: bool = False,
                    hist_bound: Optional[int] = None, shard=None, inputs_embeds=None):
    """Returns (logits, kv_pages): logits [B, S, V] fp32, or [B, V] for each
    request's last valid position with ``last_only``. Writes the chunk's K/V
    into the pool in place.

    ``chunked=True``: this call is one chunk of a longer prompt (or the tail
    after a prefix-cache hit): ``ctx.start_pos`` tokens per request are
    already in the pool, and attention covers [pool history | causal chunk
    prefix] (K5 on the card). ``hist_bound`` bounds the history the plain
    CPU form gathers; the kernel walks each request's own pages."""
    _refuse(shard, inputs_embeds)
    h = params["embed"][input_ids]
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
        q, k, v = _project_qkv(cfg, lp, normed)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        kv_write_prefill(kv_pages, li, k, v, ctx.table_rows, ctx.start_pos, ctx.chunk_lens)
        if chunked:
            attn = ops.chunked_prefill_attention(
                q, k, v, ctx.chunk_lens, ctx.start_pos, kv_pages, li, ctx.table_rows,
                sm_scale, max_hist_len=hist_bound,
            )
        else:
            attn = ops.prefill_attention(q, k, v, ctx.chunk_lens, sm_scale)
        normed2, residual = ops.skip_rms_norm(
            _attn_out(lp, attn), residual, lp["mlp_norm"], eps, int8_rows=rows_mlp
        )
        x = _mlp(lp, normed2, rows_down)
    if last_only:  # the norm is per row: normalise only the rows the head reads
        last = torch.clamp(ctx.chunk_lens.long() - 1, min=0)
        rows = torch.arange(B, device=h.device)
        x, residual = x[rows, last], residual[rows, last]
    normed, _ = ops.skip_rms_norm(x, residual, params["final_norm"], eps,
                                  int8_rows=_int8_rows(params, x.numel() // x.shape[-1])[3])
    return _unembed(params, cfg, normed), kv_pages


# ---------------------------------------------------------------------------
# Decode forward: one token per request -> next-token logits


def decoder_decode(params: dict, cfg, kv_pages: KVPool, ctx: AttnContext,
                   input_ids: torch.Tensor, shard=None):
    """Returns (logits [B, V] fp32, kv_pages). ``ctx.start_pos`` is the
    position being written (seq_len - 1 after allocation); ``ctx.seq_lens``
    includes the new token."""
    _refuse(shard)
    h = params["embed"][input_ids]  # [B, H]
    cos, sin = _rope_tables(cfg, ctx.start_pos, ctx.seq_lens)  # [B, D/2]
    sm_scale = 1.0 / (cfg.head_dim**0.5)
    eps = cfg.rms_norm_eps
    x, residual = h, torch.zeros_like(h)
    ks, vs = [], []
    rows_attn, rows_mlp, rows_down, rows_head = _int8_rows(params, h.shape[0])
    for li, lp in enumerate(_unstack_layers(params)):
        normed, residual = ops.skip_rms_norm(x, residual, lp["attn_norm"], eps,
                                             int8_rows=rows_attn)
        q, k, v = _project_qkv(cfg, lp, normed)
        q = ops.apply_rope(q, cos, sin)
        k = ops.apply_rope(k, cos, sin)
        attn = ops.paged_decode_attention(
            q, kv_pages, li, ctx.table_rows, ctx.seq_lens, sm_scale, k_new=k, v_new=v
        )
        normed2, residual = ops.skip_rms_norm(
            _attn_out(lp, attn), residual, lp["mlp_norm"], eps, int8_rows=rows_mlp
        )
        x = _mlp(lp, normed2, rows_down)
        ks.append(k)
        vs.append(v)
    kv_write_decode_all(
        kv_pages, torch.stack(ks), torch.stack(vs), ctx.table_rows, ctx.start_pos, ctx.active
    )
    normed, _ = ops.skip_rms_norm(x, residual, params["final_norm"], eps, int8_rows=rows_head)
    return _unembed(params, cfg, normed), kv_pages
