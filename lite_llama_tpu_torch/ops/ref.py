"""Plain PyTorch versions of every compute op (port of
``lite_llama_tpu/ops/ref.py``).

They define the numerical contract of the port's kernels: each kernel in
``ops/norms.py``, ``ops/attention_decode.py`` and ``ops/attention_prefill.py``
is held against the function here, and a wrapper that is handed a CPU tensor
runs the function here instead of its kernel. All softmax/normalization math
is fp32 regardless of input dtype.
"""

from __future__ import annotations

import math

import torch

LOG2E = math.log2(math.e)
# Large-negative instead of -inf in the online-softmax state: exp2 flushes it
# to 0 and (unlike -inf) it never makes NaN through inf - inf.
NEG_INF = -1e30
# History-block width of the streamed chunked-prefill form: above it the
# dense [B, Hq, S_c, T_h] scores are replaced by an online softmax over
# HIST_BLOCK-token blocks (memory ~ S_c * HIST_BLOCK instead of S_c * T_h).
HIST_BLOCK = 2048
# An int8 KV pool's scales: one merged bf16 row of SCALE_LANES per (layer,
# token), K scales in lanes [0, Hkv), V scales in [SCALE_HALF, SCALE_HALF + Hkv).
SCALE_LANES = 128
SCALE_HALF = SCALE_LANES // 2


def cdiv_int(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def skip_rms_norm(x, residual, weight, eps: float = 1e-5):
    """Fused residual-add + RMSNorm. Returns ``(normed, new_residual)`` with
    ``new_residual = x + residual`` rounded to x's dtype (the sum that is
    normalised is that rounded sum). ``residual=None`` means plain RMSNorm."""
    if residual is not None:
        x = x + residual
    return rms_norm(x, weight, eps), x


# ---------------------------------------------------------------------------
# MLP


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 attention_scaling: float = 1.0):
    """fp32 (cos, sin) of shape positions.shape + [head_dim//2]. ``inv_freq``
    is [head_dim//2] or per-request [B, head_dim//2]."""
    if inv_freq.ndim == 2:
        inv_freq = inv_freq.reshape(
            inv_freq.shape[0], *([1] * (positions.ndim - 1)), -1
        )
    freqs = positions.float()[..., None] * inv_freq
    return torch.cos(freqs) * attention_scaling, torch.sin(freqs) * attention_scaling


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: [..., heads, head_dim]; cos/sin: [..., head_dim//2]
    (broadcast over the heads axis)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention


def prefill_attention(q, k, v, seq_lens, sm_scale=None):
    """Causal GQA self-attention over a padded batch with per-request lengths.
    q [B, S, Hq, D], k/v [B, S, Hkv, D], seq_lens int32 [B]. Query head n
    attends kv head n // G. Pad rows (s >= seq_lens[b]) are garbage that no
    caller reads."""
    B, S, Hq, D = q.shape
    groups = Hq // k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kf) * sm_scale
    pos = torch.arange(S, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    valid = pos[None, :] < seq_lens[:, None].to(q.device)  # [B, S(t)]
    mask = causal[None, None] & valid[:, None, None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(q.dtype).float(), vf)
    return out.to(q.dtype)


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its uint8 bits (indexing and selects run on those on
    every device), any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def pool_rows(pages: torch.Tensor, layer: int, rows: torch.Tensor) -> torch.Tensor:
    """``pages[layer][:, rows]``: both planes' token rows of one layer."""
    return byte_view(pages)[layer][:, rows].view(pages.dtype)


def gather_kv_pages(kv_pool, layer: int, page_table: torch.Tensor, max_seq_len: int):
    """Gather one layer's K/V rows for each request out of the paged pool into
    dense [B, Hkv, max_seq_len, D] views, in the pool's dtype, or dequantized
    to fp32 for an int8 pool. Page ids past a request's live pages may be
    anything; they are clamped into the pool (the callers mask those
    positions)."""
    pages = kv_pool.pages
    L, _, T, HD = pages.shape
    Hkv, D = kv_pool.num_kv_heads, kv_pool.head_dim
    ps = kv_pool.page_size
    n = max_seq_len // ps
    pt = page_table[:, :n].long()
    off = torch.arange(ps, device=pages.device)
    rows = (pt[:, :, None] * ps + off).reshape(pt.shape[0], n * ps).clamp(0, T - 1)
    B, S = rows.shape
    kv = pool_rows(pages, layer, rows).reshape(2, B, S, Hkv, D)
    if kv_pool.scales is not None:
        srow = kv_pool.scales[layer][rows]  # [B, S, SCALE_LANES]
        sc = torch.stack([srow[..., :Hkv], srow[..., SCALE_HALF:SCALE_HALF + Hkv]])
        kv = kv.float() * sc.float()[..., None]
    kv = kv.transpose(2, 3)
    return kv[0], kv[1]


def paged_decode_attention(q, kv_pool, layer, page_table, seq_lens,
                           max_seq_len=None, sm_scale=None, k_new=None, v_new=None):
    """Decode-step attention reading K/V through the page table (gather then
    mask). q [B, Hq, D]; seq_lens include the new token. When (k_new, v_new)
    are given, the pool holds seq_lens-1 tokens and the newest token is
    spliced into the gathered view at position seq_lens-1."""
    B, Hq, D = q.shape
    Hkv = kv_pool.num_kv_heads
    ps = kv_pool.page_size
    if max_seq_len is None:
        max_seq_len = page_table.shape[1] * ps
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    k, v = gather_kv_pages(kv_pool, layer, page_table, max_seq_len)
    k, v = k.to(q.dtype), v.to(q.dtype)
    if k_new is not None:
        bidx = torch.arange(B, device=q.device)
        pos_new = seq_lens.long() - 1
        k = k.clone()
        v = v.clone()
        k[bidx, :, pos_new, :] = k_new.to(k.dtype)
        v[bidx, :, pos_new, :] = v_new.to(v.dtype)
    groups = Hq // Hkv
    qg = q.reshape(B, Hkv, groups, D)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k.float()) * sm_scale
    t = torch.arange(max_seq_len, device=q.device)
    mask = t[None, :] < seq_lens[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", probs.to(q.dtype).float(), v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def chunked_prefill_attention(q, k, v, chunk_lens, start_pos, kv_pool, layer, page_table,
                              sm_scale=None, max_hist_len=None):
    """Chunked-prefill attention: every chunk query attends the request's
    pool history [0, start_pos) plus the causal prefix of the current chunk
    (keys p <= s, p < chunk_lens). q [B, S_c, Hq, D], k/v [B, S_c, Hkv, D],
    chunk_lens / start_pos int32 [B]. ``max_hist_len`` bounds the history
    span read (default: the whole page-table span). Up to HIST_BLOCK tokens
    of history are gathered densely with one joint softmax; beyond that the
    history streams in HIST_BLOCK-token blocks with an online softmax, so
    [B, Hq, S_c, T_h] scores are never materialised."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    ps = kv_pool.page_size
    if max_hist_len is None:
        max_hist_len = page_table.shape[1] * ps
    if sm_scale is None:
        sm_scale = 1.0 / (D**0.5)
    dev = q.device
    start_pos = start_pos.to(dev)
    chunk_lens = chunk_lens.to(dev)
    qh = q.float().transpose(1, 2)  # [B, Hq, S, D]
    kc = k.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    vc = v.float().transpose(1, 2).repeat_interleave(groups, dim=1)
    t_c = torch.arange(S, device=dev)
    causal = t_c[:, None] >= t_c[None, :]  # [S(q), S(k)]
    mask_c = causal[None] & (t_c[None, None, :] < chunk_lens[:, None, None])  # [B, S, S]

    if max_hist_len <= HIST_BLOCK:
        k_h, v_h = gather_kv_pages(kv_pool, layer, page_table, max_hist_len)
        kh = k_h.to(q.dtype).float().repeat_interleave(groups, dim=1)  # [B, Hq, T_h, D]
        vh = v_h.to(q.dtype).float().repeat_interleave(groups, dim=1)
        s_hist = torch.einsum("bhsd,bhtd->bhst", qh, kh) * sm_scale
        s_chunk = torch.einsum("bhsd,bhtd->bhst", qh, kc) * sm_scale
        t_h = torch.arange(max_hist_len, device=dev)
        mask_h = t_h[None, :] < start_pos[:, None]  # [B, T_h]
        s_hist = s_hist.masked_fill(~mask_h[:, None, None, :], float("-inf"))
        s_chunk = s_chunk.masked_fill(~mask_c[:, None], float("-inf"))
        p = torch.softmax(torch.cat([s_hist, s_chunk], dim=-1), dim=-1)
        p_h, p_c = p[..., :max_hist_len], p[..., max_hist_len:]
        out = (torch.einsum("bhst,bhtd->bshd", p_h.to(q.dtype).float(), vh)
               + torch.einsum("bhst,bhtd->bshd", p_c.to(q.dtype).float(), vc))
        return out.to(q.dtype)

    # Long history: stream it block by block with an online softmax.
    TB = HIST_BLOCK
    if TB % ps:
        raise ValueError(f"page_size {ps} must divide the history block {TB}")
    bp = TB // ps
    n_blocks = cdiv_int(max_hist_len, TB)
    need = n_blocks * bp
    pt = page_table
    if pt.shape[1] < need:  # pad pages gather garbage rows that the mask removes
        pt = torch.nn.functional.pad(pt, (0, need - pt.shape[1]))
    m = torch.full((B, Hq, S, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hq, S, 1), device=dev)
    acc = torch.zeros((B, Hq, S, D), device=dev)
    for i in range(n_blocks):
        k_h, v_h = gather_kv_pages(kv_pool, layer, pt[:, i * bp:(i + 1) * bp], TB)
        kh = k_h.to(q.dtype).float().repeat_interleave(groups, dim=1)
        vh = v_h.to(q.dtype).float().repeat_interleave(groups, dim=1)
        s = torch.einsum("bhsd,bhtd->bhst", qh, kh) * sm_scale
        t_abs = i * TB + torch.arange(TB, device=dev)
        mask = t_abs[None, :] < start_pos[:, None]  # [B, TB]
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.where(m > 0.5 * NEG_INF, torch.exp(m - m_new), torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhst,bhtd->bhsd", p.to(q.dtype).float(), vh)
        m = m_new

    # The chunk part (dense [S, S], bounded by the engine's prefill_chunk),
    # then the two-part LSE combine.
    s_c = torch.einsum("bhsd,bhtd->bhst", qh, kc) * sm_scale
    s_c = s_c.masked_fill(~mask_c[:, None], NEG_INF)
    m_c = s_c.amax(dim=-1, keepdim=True)
    p_c = torch.where(s_c > 0.5 * NEG_INF, torch.exp(s_c - m_c), torch.zeros_like(s_c))
    l_c = p_c.sum(dim=-1, keepdim=True)
    o_c = torch.einsum("bhst,bhtd->bhsd", p_c.to(q.dtype).float(), vc)
    m_t = torch.maximum(m, m_c)
    a = torch.where(m > 0.5 * NEG_INF, torch.exp(m - m_t), torch.zeros_like(m))
    b = torch.where(m_c > 0.5 * NEG_INF, torch.exp(m_c - m_t), torch.zeros_like(m_c))
    out = (acc * a + o_c * b) / torch.clamp(l * a + l_c * b, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def fold_new_token(out, m1, l1, q, k_new, v_new, sm_scale):
    """Exact LSE combine of a normalized partial attention result ``out``
    [B, Nq, D] with its online-softmax state ``(m1, l1)`` [B, Nq] (exp2
    domain, sm_scale*log2(e) folded into the scores) and one extra K/V token
    ``k_new``/``v_new`` [B, Hkv, D]. An empty partial (m1 = -1e30, l1 = 0)
    returns ``v_new`` exactly."""
    B, Nq, D = q.shape
    Hkv = k_new.shape[1]
    G = Nq // Hkv
    qg = (q.float() * (sm_scale * LOG2E)).reshape(B, Hkv, G, D)
    s2 = torch.einsum("bhgd,bhd->bhg", qg, k_new.float()).reshape(B, Nq)
    m_out = torch.maximum(m1, s2)
    c1 = torch.exp2(m1 - m_out)  # pool-side correction
    c2 = torch.exp2(s2 - m_out)  # new-token weight
    l_out = l1 * c1 + c2
    v2 = v_new.float()[:, :, None, :].expand(B, Hkv, G, D).reshape(B, Nq, D)
    num = out.float() * (l1 * c1)[..., None] + v2 * c2[..., None]
    return (num / torch.clamp(l_out, min=1e-30)[..., None]).to(q.dtype)
