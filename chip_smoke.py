#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lite_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no final "ok" line

Phases, in order; any failure exits non-zero:
1. Device: refuse to run without CUDA (there is no CPU fallback); print the
   card's name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from csrc/ with nvcc for sm_90a (one
   nvcc per source, in parallel) and the Triton kernels at their first launch.
3. Kernels: each kernel's wrapper against its plain PyTorch version on the
   card in bf16, at the main-path shapes of Llama-3.2-3B (D=128, Nq=24,
   Hkv=8) and Llama-3.2-1B (D=64, Nq=32, Hkv=8): max abs error against the
   stated tolerance, device time from CUDA events with the inputs rotated
   through HBM (and, beside it, replayed warm in L2), the least time the
   card could take (bytes over 3.35 TB/s or bf16 operations over 989
   TFLOP/s), the plain version's time and one PyTorch library call's time
   where one computes the same function (timed here only; the port never
   calls it).
4. Batch slice: Llama-3.2-3B at full width and depth with random bf16
   weights from a seeded generator; InferenceEngine +
   TextGenerator.generate_tokens on 12 prompts of 25 random ids, greedy,
   max_gen_len 128. Every kernel of that path must launch in that run; the
   run is repeated for the median time. Decode through the paged cache must
   agree with re-prefilling prompt + generated tokens in a fresh cache,
   within a limit set between the plain versions' reading and that of
   faults planted in K1's inputs; the script plants them and fails if the
   limit misses one.
5. Serving: the same model and weights through ServingFrontend ->
   ContinuousBatchingScheduler -> engine sessions with the prefix cache on
   (prefill_chunk 512, page 16, 64 slots, decode_chunk 32), from 4
   submitting threads, in two waves (serving_phase); K5 must launch in each
   wave and the prefix cache must hit at least 16 times. Then two prefill
   invariants (prefill_invariants): chunked (K5) against single-shot (K2)
   prefill of 1500-token prompts, and prefix-hit against uncached prefill,
   read through the kernels, the plain versions and faults planted in K5's
   inputs.
6. Summary: one JSON line with every kernel, then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores
L2_BYTES = 50 * 2**20  # H100 SXM L2
COLD_BYTES = 4 * L2_BYTES  # inputs one timed pass rotates through
ATOL, RTOL = 1e-2, 1e-2  # bf16 outputs: one bf16 step is 2^-8 relative
# Decode vs re-prefill after 127 steps: relative RMS of the logit difference
# and max |difference| over max |logit|. On an H100 (PERF.md) the plain
# versions in bf16 read 0.038 / 0.044 and the kernels 0.043 / 0.048; the
# smallest planted fault (two pages swapped) reads 0.156 / 0.151. The limits
# sit near the geometric mean, ~1.8x from either side.
INVARIANT_REL_RMS = 0.08
INVARIANT_MAX_ABS = 0.08
# Chunked or prefix-hit prefill against a single-shot prefill of the same
# prompts (first-token logits): relative RMS of the difference and max
# |difference| over max |logit|. On an H100 (PERF.md) the kernels read 0 /
# 0 (K5 walks the same 64-key tiles in the same order as K2), the plain
# versions 0.030 / 0.033, the smallest planted fault (start_pos one page
# short) 0.452 / 0.510. The limits sit near the geometric mean of the last
# two, ~4x from either side.
PREFILL_REL_RMS = 0.12
PREFILL_MAX_ABS = 0.12
WAVE_GEN = 64  # max_gen_len of every serving request
GEN_REPEATS = 3  # generate_tokens runs timed (host time varies run to run)
SPLIT_REPEATS = 5  # prefill + decode runs timed apart
SEED = 0

NORM_NO_RESIDUAL = 3  # index of K3's no-residual case in kernel_phase()
KERNELS = {
    "paged_flash_decode": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/paged_decode.cu",
        replaces="lite_llama_tpu/ops/attention_decode.py:345"),
    "flash_prefill": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:614"),
    "rms_norm": dict(
        route="triton", source="lite_llama_tpu_torch/ops/norms.py",
        replaces="lite_llama_tpu/ops/norms.py:83",
        also_replaces="lite_llama_tpu/ops/norms.py:61"),
    "swiglu": dict(
        route="triton", source="lite_llama_tpu_torch/ops/norms.py",
        replaces="lite_llama_tpu/ops/norms.py:115"),
    "flash_prefill_chunked": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:650"),
}
# The kernels each main path must launch: batch generation of short prompts
# (phase 4) and serving (phase 5; K2 runs there only for a prompt batch
# that is neither long nor a prefix hit, which the admission order decides).
BATCH_PATH = ("paged_flash_decode", "flash_prefill", "rms_norm", "swiglu")
SERVING_PATH = ("paged_flash_decode", "rms_norm", "swiglu", "flash_prefill_chunked")
MODELS = {  # head_dim, query heads, kv heads, hidden, intermediate
    "llama-3.2-3b": dict(D=128, Nq=24, Hkv=8, H=3072, I=8192),
    "llama-3.2-1b": dict(D=64, Nq=32, Hkv=8, H=2048, I=8192),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def input_copies(args, touched_bytes):
    """``args`` followed by clones of its tensors, enough that one pass over
    the copies touches COLD_BYTES: a timed call then finds its inputs in HBM,
    not in the L2 the previous call left them in."""
    n = min(max(1, math.ceil(COLD_BYTES / max(touched_bytes, 1))), 2048)
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(n - 1)]


def cuda_ms(fn, copies, iters=50, warmup=3):
    """Mean milliseconds per eager call from CUDA events around ``iters``
    calls, cycling over the input copies."""
    for _ in range(warmup):
        fn(*copies[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*copies[i % len(copies)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, copies, min_calls=20):
    """Device milliseconds per call: one call per input copy (repeated to at
    least ``min_calls``) captured back to back in one CUDA graph and replayed
    between CUDA events, so the host's launch overhead is not in the number
    (eager calls of these small kernels measure the host, not the card)."""
    calls = copies * math.ceil(min_calls / len(copies))
    reps = max(3, math.ceil(200 / len(calls)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*copies[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in calls:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def timings(kernel, plain, args, touched_bytes, library=None, plain_in_graph=True):
    """ms, eager_ms, plain_ms and library_ms on inputs rotated through HBM
    (see input_copies); l2_warm_ms is the kernel on one input set replayed,
    which stays in L2. ``kernel`` and ``plain`` take ``args``; ``library`` is
    (fn, its own args, the bytes it touches) or None."""
    copies = input_copies(args, touched_bytes)
    t = dict(
        ms=graph_ms(kernel, copies),
        l2_warm_ms=graph_ms(kernel, copies[:1]),
        eager_ms=cuda_ms(kernel, copies),
        plain_ms=(graph_ms(plain, copies) if plain_in_graph
                  else cuda_ms(plain, copies, iters=max(10, len(copies)), warmup=1)),
        library_ms=None,
        copies=len(copies),
    )
    del copies
    if library is not None:
        fn, lib_args, lib_bytes = library
        t["library_ms"] = graph_ms(fn, input_copies(lib_args, lib_bytes))
    return t


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want):
    """(max abs error, within ATOL + RTOL*|want| everywhere?)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.all(diff <= ATOL + RTOL * w.abs())) and bool(torch.isfinite(g).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


class Failure(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions


def decode_case(model, lens, ps=16):
    from lite_llama_tpu_torch.executor.kv_cache import KVPool
    from lite_llama_tpu_torch.ops.attention_decode import (
        paged_decode_state_plain, paged_flash_decode)

    m = MODELS[model]
    D, Nq, Hkv = m["D"], m["Nq"], m["Hkv"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    B = len(lens)
    ppr = max(1, math.ceil(max(lens) / ps))
    P = B * ppr
    pages = torch.randn((2, 2, P * ps, Hkv * D), generator=g, device=dev).bfloat16()
    table = torch.randperm(P, generator=g, device=dev).view(B, ppr).int()  # shuffled
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, Nq, D), generator=g, device=dev).bfloat16()
    scale = D**-0.5

    def kernel(q, pages, table, kv_lens):
        pool = KVPool(pages, ps, Hkv, D)
        return paged_flash_decode(q, pool, 1, table, kv_lens, scale, return_state=True)

    def plain(q, pages, table, kv_lens):
        return paged_decode_state_plain(q, pages, ps, 1, table, kv_lens, scale)

    args = (q, pages, table, kv_lens)
    out, mm, ll = kernel(*args)
    po, pm, pl = plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, po)
    m_ok = bool(torch.all((mm - pm).abs() <= 1e-3 * torch.clamp(pm.abs(), min=1.0)))
    l_ok = bool(torch.all((ll - pl).abs() <= 1e-3 * pl.abs() + 1e-6))
    tokens = sum(lens)
    bytes_moved = (tokens * 2 * Hkv * D * 2 + 2 * B * Nq * D * 2 + B * Nq * 8
                   + B * 4 + sum(math.ceil(n / ps) for n in lens) * 4)
    t_bound, by = bound(bytes_moved, 4 * tokens * Nq * D)
    # Library yardstick: SDPA on the same K/V gathered dense (gather untimed).
    rows = (table.long()[:, :, None] * ps + torch.arange(ps, device=dev)).view(B, -1)
    kd = pages[1, 0][rows].view(B, -1, Hkv, D).transpose(1, 2).repeat_interleave(Nq // Hkv, 1)
    vd = pages[1, 1][rows].view(B, -1, Hkv, D).transpose(1, 2).repeat_interleave(Nq // Hkv, 1)
    mask = (torch.arange(rows.shape[1], device=dev)[None] < kv_lens[:, None])[:, None, None]
    lib_args = (q[:, :, None], kd, vd, mask)
    t = timings(
        kernel,
        plain,  # reads max(kv_lens) on the host: timed eagerly
        args, bytes_moved,
        (lambda qd, kd, vd, mask: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
         lib_args, sum(a.numel() * a.element_size() for a in lib_args)),
        plain_in_graph=False,
    )
    return dict(model=model, shape=f"B={B} Nq={Nq} Hkv={Hkv} D={D} page_size={ps} "
                                   f"kv_lens={lens}",
                max_abs_err=err, ok=ok and m_ok and l_ok, **t,
                bound_ms=t_bound, bound_by=by,
                library="F.scaled_dot_product_attention (dense K/V, boolean mask)")


def prefill_case(model, B, S, lens):
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import ref

    m = MODELS[model]
    D, Nq, Hkv = m["D"], m["Nq"], m["Hkv"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.prefill_attention(q, k, v, sl)
    want = ref.prefill_attention(q, k, v, sl)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for b, n in enumerate(lens):  # pad rows are never read
        e, o = max_err(got[b, :n], want[b, :n])
        err, ok = max(err, e), ok and o
    pairs = sum(n * (n + 1) // 2 for n in lens)
    # Rows past seq_lens[b] are neither read nor needed: q, out, k and v
    # count only each request's own rows.
    bytes_moved = sum(lens) * (2 * Nq * D * 2 + 2 * Hkv * D * 2) + B * 4
    t_bound, by = bound(bytes_moved, 4 * Nq * D * pairs)
    lib_args = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(Nq // Hkv, 1),
                v.transpose(1, 2).repeat_interleave(Nq // Hkv, 1))
    t = timings(ops.prefill_attention, ref.prefill_attention, (q, k, v, sl), bytes_moved,
                (lambda qt, kt, vt: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                 lib_args, sum(a.numel() * a.element_size() for a in lib_args)))
    return dict(model=model, shape=f"B={B} S={S} Nq={Nq} Hkv={Hkv} D={D} lens={lens}",
                max_abs_err=err, ok=ok, **t, bound_ms=t_bound, bound_by=by,
                library="F.scaled_dot_product_attention (is_causal, full length S)")


def norm_case(rows, H, residual):
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn((rows, H), generator=g, device=dev).bfloat16()
    r = torch.randn((rows, H), generator=g, device=dev).bfloat16() if residual else None
    w = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).bfloat16()
    n, s = ops.skip_rms_norm(x, r, w)
    pn, ps_ = ref.skip_rms_norm(x, r, w)
    torch.cuda.synchronize()
    err, ok = max_err(n, pn)
    ok = ok and bool(torch.equal(s, ps_))  # the rounded residual sum is exact
    n_io = (4 if residual else 2) * rows * H * 2 + H * 2
    t_bound, by = bound(n_io, 4 * rows * H)
    t = timings(ops.skip_rms_norm, ref.skip_rms_norm, (x, r, w), n_io,
                (lambda x, w: F.rms_norm(x, (H,), w, 1e-5), (x, w), 2 * rows * H * 2 + H * 2))
    return dict(shape=f"[{rows}, {H}] residual={residual}", max_abs_err=err, ok=ok, **t,
                bound_ms=t_bound, bound_by=by,
                library="F.rms_norm (normalisation alone, no residual add)")


def chunked_case(model, starts, clens, S=512, ps=16, return_state=False):
    """K5 on one chunk of S query rows per request over a paged history of
    ``starts[b]`` tokens (page ids shuffled) plus the chunk's own
    ``clens[b]`` keys, against its plain version on out (and m, l)."""
    from lite_llama_tpu_torch.executor.kv_cache import KVPool
    from lite_llama_tpu_torch.ops.attention_prefill import (
        chunked_prefill_state_plain, flash_prefill_chunked)

    m = MODELS[model]
    D, Nq, Hkv = m["D"], m["Nq"], m["Hkv"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    B = len(starts)
    ppr = max(1, math.ceil((max(starts) + S) / ps))
    P = B * ppr
    pages = torch.randn((2, 2, P * ps, Hkv * D), generator=g, device=dev).bfloat16()
    table = torch.randperm(P, generator=g, device=dev).view(B, ppr).int()  # shuffled
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    sp = torch.tensor(starts, dtype=torch.int32, device=dev)
    cl = torch.tensor(clens, dtype=torch.int32, device=dev)
    scale = D**-0.5

    def kernel(q, k, v, cl, sp, pages, table):
        return flash_prefill_chunked(q, k, v, cl, sp, KVPool(pages, ps, Hkv, D), 1, table,
                                     scale, return_state=return_state)

    def plain(q, k, v, cl, sp, pages, table):
        return chunked_prefill_state_plain(q, k, v, cl, sp, pages, ps, 1, table, scale)

    args = (q, k, v, cl, sp, pages, table)
    got = kernel(*args)
    out = got[0] if return_state else got
    po, pm, pl = plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, po)  # every row: pad rows attend the whole chunk, as on the TPU
    if return_state:
        mm, ll = got[1], got[2]
        ok = ok and bool(torch.all((mm - pm).abs() <= 1e-3 * torch.clamp(pm.abs(), min=1.0)))
        ok = ok and bool(torch.all((ll - pl).abs() <= 1e-3 * pl.abs() + 1e-6))
    hist_tok = sum(starts)
    rows = sum(clens)
    bytes_moved = (2 * hist_tok * Hkv * D * 2 + rows * (2 * Nq * D * 2 + 2 * Hkv * D * 2)
                   + (rows * Nq * 8 if return_state else 0) + 2 * B * 4
                   + sum(math.ceil(s / ps) for s in starts) * 4)
    flops = 4 * Nq * D * sum(c * s + c * c / 2 for c, s in zip(clens, starts))
    t_bound, by = bound(bytes_moved, flops)
    # Library yardstick: SDPA on the history gathered dense beside the
    # chunk's keys, with the same mask (the gather is not timed).
    Th = max(1, math.ceil(max(starts) / ps)) * ps
    hrows = (table.long()[:, : Th // ps, None] * ps + torch.arange(ps, device=dev)).view(B, Th)
    G = Nq // Hkv
    kd = torch.cat([pages[1, 0][hrows].view(B, Th, Hkv, D), k], 1)
    vd = torch.cat([pages[1, 1][hrows].view(B, Th, Hkv, D), v], 1)
    kd, vd = (x.transpose(1, 2).repeat_interleave(G, 1).contiguous() for x in (kd, vd))
    t_h = torch.arange(Th, device=dev)
    t_c = torch.arange(S, device=dev)
    mask = torch.cat([(t_h[None] < sp[:, None])[:, None, :].expand(B, S, Th),
                      (t_c[None, :] <= t_c[:, None])[None] & (t_c[None, None] < cl[:, None, None])],
                     -1)[:, None]
    lib_args = (q.transpose(1, 2).contiguous(), kd, vd, mask)
    t = timings(
        kernel, plain, args, bytes_moved,
        (lambda qd, kd, vd, mask: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
         lib_args, sum(a.numel() * a.element_size() for a in lib_args)),
        plain_in_graph=False,  # the plain version reads max(start_pos) on the host
    )
    return dict(model=model, shape=f"B={B} S={S} Nq={Nq} Hkv={Hkv} D={D} page_size={ps} "
                                   f"start_pos={list(starts)} chunk_lens={list(clens)} "
                                   f"return_state={return_state}",
                max_abs_err=err, ok=ok, **t, bound_ms=t_bound, bound_by=by,
                library="F.scaled_dot_product_attention (history gathered dense + chunk, "
                        "boolean mask)")


def swiglu_case(rows, I):
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    gate = torch.randn((rows, I), generator=g, device=dev).bfloat16()
    up = torch.randn((rows, I), generator=g, device=dev).bfloat16()
    got = ops.swiglu(gate, up)
    want = ref.swiglu(gate, up)
    torch.cuda.synchronize()
    err, ok = max_err(got, want)
    t_bound, by = bound(3 * rows * I * 2, 5 * rows * I)
    t = timings(ops.swiglu, ref.swiglu, (gate, up), 3 * rows * I * 2)
    return dict(shape=f"[{rows}, {I}]", max_abs_err=err, ok=ok, **t,
                bound_ms=t_bound, bound_by=by, library=None)


def kernel_phase():
    """Returns {kernel: [cases]}; the first case of each is the main path's
    own shape (Llama-3.2-3B decode step, its 12 x 25-token prefill, or the
    serving phase's middle chunk of eight 1500-token prompts for K5). K3's
    case ``NORM_NO_RESIDUAL`` is its no-residual form at Qwen3-4B's q-norm
    shape (12 rows x 32 heads, width 128), reported on its own."""
    ragged = [0, 1, 15, 16, 17, 100, 255, 256, 511, 1000, 1537, 2048]  # B=12
    cases = {
        "paged_flash_decode": [
            decode_case("llama-3.2-3b", [88] * 12),
            decode_case("llama-3.2-3b", ragged),
            decode_case("llama-3.2-1b", ragged),
        ],
        "flash_prefill": [
            prefill_case("llama-3.2-3b", 12, 25, [25] * 12),
            *(prefill_case(model, 4, S, [S, 3 * S // 4 + 5, 37, 1])
              for model in MODELS for S in (128, 512)),
        ],
        "rms_norm": [
            norm_case(12, 3072, True),
            norm_case(300, 3072, True),
            norm_case(300, 3072, False),
            norm_case(12 * 32, 128, False),  # NORM_NO_RESIDUAL: Qwen3-4B q-norm rows
            norm_case(300 * 32, 128, True),
        ],
        "swiglu": [swiglu_case(12, 8192), swiglu_case(300, 8192)],
        "flash_prefill_chunked": [
            chunked_case("llama-3.2-3b", [512] * 8, [512] * 8),
            *(chunked_case(model, [0, 16, 500, 1536], [512, 300, 0, 512], return_state=rs)
              for model in MODELS for rs in (False, True)),
        ],
    }
    for name, cs in cases.items():
        for c in cs:
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.5f}"
            log(f"  {name:18s} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} "
                f"ok={c['ok']} ms={c['ms']:.5f} l2_warm_ms={c['l2_warm_ms']:.5f} "
                f"eager_ms={c['eager_ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) library_ms={lib} "
                f"copies={c['copies']}")
    bad = [(n, c["shape"]) for n, cs in cases.items() for c in cs if not c["ok"]]
    require(not bad, f"kernels disagree with their plain versions beyond tolerance: {bad}")
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the slice


def counters():
    from lite_llama_tpu_torch.ops import attention_decode, attention_prefill, norms

    return {
        "paged_flash_decode": attention_decode.launch_paged_decode,
        "flash_prefill": attention_prefill.launch_flash_prefill,
        "rms_norm": norms.launch_rms_norm,
        "swiglu": norms.launch_swiglu,
        "flash_prefill_chunked": attention_prefill.launch_flash_prefill_chunked,
    }


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def plain_ops():
    """The decoder's kernel ops replaced by their plain versions in ops/ref.py
    (patched into ``lite_llama_tpu_torch.ops`` by this script only): the
    invariant's reading when no kernel runs, the floor its limit sits above."""
    from lite_llama_tpu_torch.ops import ref

    def decode(q, pool, layer, table, seq_lens, sm_scale=None, k_new=None, v_new=None):
        return ref.paged_decode_attention(q, pool, layer, table, seq_lens, sm_scale=sm_scale,
                                          k_new=k_new, v_new=v_new)

    return dict(prefill_attention=ref.prefill_attention, paged_decode_attention=decode,
                chunked_prefill_attention=ref.chunked_prefill_attention,
                rms_norm=ref.rms_norm, skip_rms_norm=ref.skip_rms_norm, swiglu=ref.swiglu)


def planted_faults():
    """K1 handed a wrong kv_len or page table: faults the invariant's limit
    must catch, each as a replacement of ops.paged_decode_attention."""
    from lite_llama_tpu_torch.ops.attention_decode import paged_flash_decode as k1

    def one_short(q, pool, layer, table, seq_lens, sm_scale=None, **kw):
        return k1(q, pool, layer, table, torch.clamp(seq_lens - 1, min=1), sm_scale, **kw)

    def pages_swapped(q, pool, layer, table, seq_lens, sm_scale=None, **kw):
        order = [1, 0, *range(2, table.shape[1])]
        return k1(q, pool, layer, table[:, order], seq_lens, sm_scale, **kw)

    def other_request(q, pool, layer, table, seq_lens, sm_scale=None, **kw):
        return k1(q, pool, layer, table.flip(0), seq_lens, sm_scale, **kw)

    return {"kv_len one short": one_short, "first two pages swapped": pages_swapped,
            "the other request's pages": other_request}


def decode_vs_reprefill(dev, cfg, params, prompts, generated, patch=None):
    """The repository's key invariant at full size: decode the engine's
    greedy tokens through the paged cache (K1 on every layer), then
    re-prefill prompt + generated tokens in a fresh cache (K2); the
    last-position logits agree. ``patch`` replaces ops of
    ``lite_llama_tpu_torch.ops`` for the whole reading."""
    from unittest import mock

    from lite_llama_tpu_torch import ops

    with mock.patch.multiple(ops, **patch) if patch else contextlib.nullcontext():
        return _decode_vs_reprefill(dev, cfg, params, prompts, generated)


def invariant_holds(inv):
    return (inv["rel_rms_diff"] <= INVARIANT_REL_RMS
            and inv["max_abs_diff"] <= INVARIANT_MAX_ABS * inv["max_abs_logit"]
            and inv["top1_decode"] == inv["top1_reprefill"] == inv["engine_tokens"])


def _decode_vs_reprefill(dev, cfg, params, prompts, generated):
    from lite_llama_tpu_torch.executor import kv_cache as kvc
    from lite_llama_tpu_torch.models.decoder import AttnContext, decoder_decode, decoder_prefill

    B = len(prompts)
    n_steps = min(len(g) for g in generated) - 1
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim

    def fresh():
        return kvc.create_kv_cache(L, Hkv, D, num_pages=64, page_size=16, max_reqs=B,
                                   max_seq_len=cfg.max_seq_len, dtype=cfg.dtype, device=dev)

    def prefill(cache, rows):
        n = torch.tensor([len(r) for r in rows], dtype=torch.int32, device=dev)
        ids = torch.tensor(rows, dtype=torch.long, device=dev)
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        kvc.alloc_prefill(cache, slots, n)
        ctx = AttnContext(cache.page_table[slots.long()], n, torch.zeros_like(n), n)
        return decoder_prefill(params, cfg, cache.kv_pages, ctx, ids, last_only=True)[0]

    with torch.inference_mode():
        cache = fresh()
        logits = prefill(cache, [list(p) for p in prompts])
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        for step in range(n_steps):
            tok = torch.tensor([g[step] for g in generated], dtype=torch.long, device=dev)
            kvc.alloc_decode(cache, slots)
            sl = cache.seq_lens[slots.long()]
            ctx = AttnContext(cache.page_table[slots.long()], sl, sl - 1, torch.ones_like(sl))
            logits = decoder_decode(params, cfg, cache.kv_pages, ctx, tok)[0]
        want = prefill(fresh(), [list(p) + list(g[:n_steps]) for p, g in zip(prompts, generated)])
    d = logits - want
    return dict(
        steps=n_steps, max_abs_diff=float(d.abs().max()),
        max_abs_logit=float(want.abs().max()),
        rel_rms_diff=float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
        top1_decode=logits.argmax(-1).tolist(), top1_reprefill=want.argmax(-1).tolist(),
        engine_tokens=[g[n_steps] for g in generated],
    )


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_decode(engine, prompts, steps=16):
    """torch.profiler over ``steps`` greedy decode steps after a prefill:
    device busy share of the wall time and device time by kernel name.
    Kernel rows are the profiler's device-side events; "not measured" (None)
    when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    dev = engine.device
    B = len(prompts)
    total = [len(p) + steps + 1 for p in prompts]
    sampling = SamplingParams.make(B, temperature=0.0, device=dev)
    slots = engine.admit_requests(total)
    try:
        first, _, _, _ = engine.prefill(prompts, sampling, slots)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.decode(slots, first, np.zeros(B, bool), total, sampling, n_steps=steps)
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        engine.release_slots(slots, total)
    # Device-side rows only: a CPU op's row repeats its kernels' device time.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return dict(
        steps=steps, profiled_wall_ms=wall_us / 1e3,
        device_ms=device_us / 1e3 if device_us else None,
        device_busy_share_profiled=device_us / wall_us if device_us else None,
        top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n) for k, us, n in top],
    )


def slice_phase(dev, cfg, params, B=12, P=25, G=128):
    """Llama-3.2-3B (``cfg``, ``params``) through InferenceEngine +
    TextGenerator on ``dev``: B prompts of P random ids, greedy,
    max_gen_len G."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.generate import TextGenerator
    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, params, device=dev)
    sync(dev)
    setup_s = time.perf_counter() - t0
    gen = TextGenerator(engine)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).tolist()
    gen.generate_tokens(prompts, max_gen_len=4, temperature=0.0)  # warm-up

    reset_counts()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    outs = gen.generate_tokens(prompts, max_gen_len=G, temperature=0.0, logprobs=True)
    sync(dev)
    gen_s = [time.perf_counter() - t0]
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    log(f"  generate_tokens: {sum(len(o.token_ids) for o in outs)} tokens in {gen_s[0]:.3f} s; "
        f"launches {launches}")
    missing = [k for k in BATCH_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the batch path: {missing}")
    for o in outs:
        require(1 <= len(o.token_ids) <= G, "output length out of range")
        require(all(0 <= t < cfg.vocab_size for t in o.token_ids), "token id out of range")
        require(all(math.isfinite(v) for v in o.logprobs), "non-finite logprob")
    n_tokens = sum(len(o.token_ids) for o in outs)
    for _ in range(GEN_REPEATS - 1):  # the host's share varies: repeat, report the median
        t0 = time.perf_counter()
        again = gen.generate_tokens(prompts, max_gen_len=G, temperature=0.0)
        sync(dev)
        gen_s.append(time.perf_counter() - t0)
        require([o.token_ids for o in again] == [o.token_ids for o in outs],
                "greedy generation is not repeatable")

    # Prefill and decode timed apart through the engine's own API, repeated;
    # the launch counts per prefill and per decode step come from the first.
    sampling = SamplingParams.make(B, temperature=0.0, device=dev)
    max_total = [P + G] * B
    prefill_ms, decode_ms = [], []
    for rep in range(SPLIT_REPEATS):
        slots = engine.admit_requests(max_total)
        try:
            c0 = read_counts()
            sync(dev)
            t0 = time.perf_counter()
            first, _, _, _ = engine.prefill(prompts, sampling, slots)
            sync(dev)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            c1 = read_counts()
            t0 = time.perf_counter()
            _, _, toks, _ = engine.decode(slots, first, np.zeros(B, bool), max_total, sampling,
                                          n_steps=G - 1)
            sync(dev)
            steps = toks.shape[0]
            decode_ms.append((time.perf_counter() - t0) * 1e3 / max(steps, 1))
            c2 = read_counts()
        finally:
            engine.release_slots(slots, max_total)
        if rep == 0:
            per_prefill = {k: c1[k] - c0[k] for k in c0}
            per_step = {k: (c2[k] - c1[k]) / max(steps, 1) for k in c0}
    decode_ms_per_step = float(np.median(decode_ms))
    # generate_tokens is one prefill and G - 1 decode steps: its own step time
    implied_ms = [(s * 1e3 - float(np.median(prefill_ms))) / (G - 1) for s in gen_s]
    log(f"  generate_tokens s {gen_s}; prefill ms {prefill_ms}; decode ms/step {decode_ms}; "
        f"decode ms/step implied by generate_tokens {implied_ms}")

    prof = profile_decode(engine, prompts)
    log(f"  profile of {prof['steps']} decode steps: {json.dumps(prof)}")
    if prof["device_ms"] is not None:  # against the decode steps timed without the profiler
        prof["device_busy_share"] = prof["device_ms"] / prof["steps"] / decode_ms_per_step

    inv = check_invariant(dev, cfg, params, prompts[:2], [o.token_ids for o in outs[:2]])
    return dict(
        model=f"{cfg.model_type} H={cfg.hidden_size} L={cfg.num_hidden_layers} "
              f"(random {str(cfg.dtype).split('.')[-1]} weights, seed {SEED})", batch=B, prompt_len=P,
        max_gen_len=G, tokens=n_tokens, generate_s=gen_s,
        tokens_per_s=n_tokens / float(np.median(gen_s)),
        tokens_per_s_runs=[n_tokens / s for s in gen_s],
        prefill_ms=float(np.median(prefill_ms)), prefill_ms_runs=prefill_ms,
        decode_ms_per_step=decode_ms_per_step, decode_ms_per_step_runs=decode_ms,
        generate_implied_decode_ms_per_step=implied_ms,
        decode_steps=steps, peak_mem_gb=peak_gb, setup_s=setup_s, launches=launches,
        launches_per_prefill=per_prefill, launches_per_decode_step=per_step,
        decode_vs_reprefill=inv, decode_profile=prof,
    ), launches


def check_invariant(dev, cfg, params, prompts, generated):
    """Decode vs re-prefill through the kernels, through the plain versions,
    and with each planted fault in K1's inputs. The kernels must hold the
    limit; every planted fault must break it."""
    inv = decode_vs_reprefill(dev, cfg, params, prompts, generated)
    log(f"  decode vs re-prefill, kernels: {inv}")
    inv["plain"] = decode_vs_reprefill(dev, cfg, params, prompts, generated, plain_ops())
    log(f"  decode vs re-prefill, plain versions: {inv['plain']}")
    inv["faults"] = {}
    for name, fault in planted_faults().items():
        inv["faults"][name] = r = decode_vs_reprefill(
            dev, cfg, params, prompts, generated, dict(paged_decode_attention=fault))
        log(f"  decode vs re-prefill, planted fault ({name}): {r}")
    inv["limit"] = dict(rel_rms=INVARIANT_REL_RMS, max_abs_of_max_logit=INVARIANT_MAX_ABS)
    require(invariant_holds(inv), f"decode and re-prefill disagree: {inv}")
    require(invariant_holds(inv["plain"]), f"plain decode and re-prefill disagree: {inv}")
    caught = {n: not invariant_holds(r) for n, r in inv["faults"].items()}
    log(f"  planted faults caught: {caught}")
    require(all(caught.values()), f"the invariant misses a planted fault: {caught}")
    return inv


# ---------------------------------------------------------------------------
# Phase 5: serving


def run_wave(fe, reqs, threads=4):
    """Submit ``reqs`` to the ServingFrontend from ``threads`` threads (each
    submits its share, then waits for each result); returns the results in
    request order and the wall time."""
    import threading

    results = [None] * len(reqs)
    errors = []

    def client(t):
        try:
            mine = list(range(t, len(reqs), threads))
            rids = [fe.submit(reqs[i]["tokens"], max_gen_len=WAVE_GEN,
                              temperature=reqs[i]["temperature"], top_p=0.9) for i in mine]
            for i, rid in zip(mine, rids):
                results[i] = fe.result(rid, timeout=600)
        except Exception as e:  # reported below; the script fails on it
            errors.append(repr(e))

    t0 = time.perf_counter()
    pool = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    for p in pool:
        p.start()
    for p in pool:
        p.join(timeout=900)
    wall = time.perf_counter() - t0
    require(not errors and not any(p.is_alive() for p in pool),
            f"serving clients failed: {errors}")
    return results, wall


def serving_phase(dev, cfg, params):
    """Llama-3.2-3B through ServingFrontend -> ContinuousBatchingScheduler
    -> engine sessions, with the prefix cache on. Wave 1: eight prompts of
    1500 random ids (three K5 chunks each at prefill_chunk 512) and one
    prompt of a 256-token shared prefix plus 8 tokens, whose 16 full pages
    (the prefix exactly) are registered when it finishes. Wave 2, after
    wave 1: sixteen prompts of the same prefix plus their own 48 tokens,
    each a prefix hit (K5 over 256 cached tokens); twelve greedy, four
    sampled (T 0.6, top_p 0.9)."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler
    from lite_llama_tpu_torch.server import ServingFrontend
    from lite_llama_tpu_torch.utils.profiling import steady_state_tps

    engine = InferenceEngine(cfg, params, device=dev, prefix_cache=True, prefill_chunk=512,
                             page_size=16, max_reqs=64, decode_chunk=32)
    prompts = serving_prompts(cfg)
    waves = [
        [dict(tokens=p, temperature=0.0) for p in prompts["long"]]
        + [dict(tokens=prompts["prefix"] + prompts["tail"], temperature=0.0)],
        [dict(tokens=prompts["prefix"] + s, temperature=0.0 if i < 12 else 0.6)
         for i, s in enumerate(prompts["suffixes"])],
    ]
    fe = ServingFrontend(ContinuousBatchingScheduler(engine))
    out, launches = [], {k: 0 for k in KERNELS}
    try:
        for w, reqs in enumerate(waves, 1):
            reset_counts()
            hits0 = engine.stats.prefix_hits
            log0 = len(fe.sched.chunk_log)
            sync(dev)
            results, wall = run_wave(fe, reqs)
            sync(dev)
            counts = read_counts()
            for k in launches:
                launches[k] += counts[k]
            toks = [r["tokens"] for r in results]
            for r in results:
                require(r["finish_reason"] in ("stop", "length"), f"wave {w}: {r}")
                require(1 <= len(r["tokens"]) <= WAVE_GEN, f"wave {w}: output length")
                require(all(0 <= t < cfg.vocab_size for t in r["tokens"]),
                        f"wave {w}: token id out of range")
                require(len(r["logprobs"]) == len(r["tokens"])
                        and all(math.isfinite(v) for v in r["logprobs"]),
                        f"wave {w}: non-finite or missing logprobs")
            ttft = sorted(r["ttft_s"] for r in results)
            n_tok = sum(len(t) for t in toks)
            rec = dict(
                wave=w, requests=len(reqs), prompt_tokens=sum(len(r["tokens"]) for r in reqs),
                tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                ttft_p50_s=float(np.percentile(ttft, 50)),
                ttft_p90_s=float(np.percentile(ttft, 90)),
                steady_state=steady_state_tps(fe.sched.chunk_log[log0:],
                                              full_occupancy=len(reqs)),
                prefix_hits=engine.stats.prefix_hits - hits0, launches=counts,
                outputs_head=[t[:4] for t in toks[:3]],
            )
            log(f"  serving wave {w}: {json.dumps(rec)}")
            require(counts["flash_prefill_chunked"] > 0, f"wave {w}: K5 never launched")
            out.append(rec)
        profile = profile_wave(fe, waves[1])
        log(f"  serving wave 2 again, profiled: {json.dumps(profile)}")
    finally:
        fe.shutdown()
    missing = [k for k in SERVING_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the serving path: {missing}")
    require(engine.stats.prefix_hits >= 16,
            f"prefix hits {engine.stats.prefix_hits} < 16 in the serving phase")
    return dict(waves=out, wave2_profile=profile, prefix_hits=engine.stats.prefix_hits,
                prefill_tokens=engine.stats.prefill_tokens,
                decode_tokens=engine.stats.decode_tokens, chunks=engine.stats.chunks), launches


def profile_wave(fe, reqs):
    """One wave under torch.profiler: the device's busy share of the wave's
    wall time and device time by kernel name (device-side events of the
    whole process, the serving thread's included). "not measured" (None)
    when the profiler records no device time. Launch counts of this run are
    not part of any wave's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_wave(fe, reqs)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return dict(wall_s=wall, device_ms=device_us / 1e3 if device_us else None,
                device_busy_share=device_us / 1e6 / wall if device_us else None,
                top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n) for k, us, n in top])


def serving_prompts(cfg):
    """The serving phase's prompts, random ids from the seed."""
    rng = np.random.default_rng(SEED + 5)
    ids = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()  # noqa: E731
    return dict(long=[ids(1500) for _ in range(8)], prefix=ids(256), tail=ids(8),
                suffixes=[ids(48) for _ in range(16)], prefix2=ids(256))


def planted_k5_faults():
    """K5 handed a history one page short, or another request's table row:
    faults the prefill invariants' limit must catch, each a replacement of
    ops.chunked_prefill_attention (the same set of keys in another order
    is not a fault: after RoPE the softmax does not see the order)."""
    from lite_llama_tpu_torch.ops.attention_prefill import flash_prefill_chunked as k5

    def one_page_short(q, k, v, chunk_lens, start_pos, pool, layer, table, sm_scale=None,
                       max_hist_len=None):
        return k5(q, k, v, chunk_lens, torch.clamp(start_pos - pool.page_size, min=0), pool,
                  layer, table, sm_scale)

    def other_request(q, k, v, chunk_lens, start_pos, pool, layer, table, sm_scale=None,
                      max_hist_len=None):
        return k5(q, k, v, chunk_lens, start_pos, pool, layer, table.roll(1, 0), sm_scale)

    return {"start_pos one page short": one_page_short,
            "another request's table row": other_request}


def compare_logits(got, want):
    d = got - want
    return dict(
        max_abs_diff=float(d.abs().max()), max_abs_logit=float(want.abs().max()),
        rel_rms_diff=float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
        top1_equal=int((got.argmax(-1) == want.argmax(-1)).sum()), rows=int(got.shape[0]),
    )


def prefill_holds(r):
    return (r["rel_rms_diff"] <= PREFILL_REL_RMS
            and r["max_abs_diff"] <= PREFILL_MAX_ABS * r["max_abs_logit"])


def _last_logits(engine, prompts, prefix_prompts=()):
    """First-token logits of ``prompts`` prefilled together; with
    ``prefix_prompts`` they are run (and released) first, so that their full
    pages are cached for the prompts to hit."""
    from lite_llama_tpu_torch.generation.generate import TextGenerator
    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    if prefix_prompts:
        TextGenerator(engine).generate_tokens(list(prefix_prompts), max_gen_len=1,
                                              temperature=0.0)
    hits0 = engine.stats.prefix_hits
    total = [len(p) + 1 for p in prompts]
    slots = engine.admit_requests(total, prompts=prompts)
    try:
        sampling = SamplingParams.make(len(prompts), temperature=0.0, device="cpu")
        _, _, last, _ = engine.prefill(prompts, sampling, slots, return_logits=True)
    finally:
        engine.release_slots(slots, total)
    return torch.from_numpy(last), engine.stats.prefix_hits - hits0


def prefill_invariants(dev, cfg, params):
    """(a) the last logits of the 1500-token prompts chunked through K5
    (prefill_chunk 512) against one single-shot K2 prefill; (b) the first
    logits of prefix-hit prefills (K5 over 256 cached tokens) against the
    same prompts with the prefix cache off. Each read through the kernels,
    through the plain versions patched in, and with faults planted in K5's
    inputs; the kernels must hold the limit, every fault must break it."""
    from unittest import mock

    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.executor.engine import InferenceEngine

    p = serving_prompts(cfg)
    longs = p["long"]
    hit = [p["prefix"] + p["suffixes"][0], p["prefix2"] + p["suffixes"][1]]
    warm = [p["prefix"] + p["tail"], p["prefix2"] + p["tail"]]

    def engine(**kw):  # explicit small pools: these engines hold a few prompts
        return InferenceEngine(cfg, params, device=dev, page_size=16, max_reqs=8,
                               num_pages=8 * 100, decode_chunk=32, **kw)

    def read(patch):
        with mock.patch.multiple(ops, **patch) if patch else contextlib.nullcontext():
            chunked, _ = _last_logits(engine(prefill_chunk=512), longs)
            single, _ = _last_logits(engine(prefill_chunk=2048), longs)
            cached, hits = _last_logits(engine(prefill_chunk=512, prefix_cache=True), hit,
                                        prefix_prompts=warm)
            uncached, _ = _last_logits(engine(prefill_chunk=512), hit)
        require(hits == len(hit), f"prefix-hit reading hit {hits} of {len(hit)} prompts")
        return dict(a=compare_logits(chunked, single), b=compare_logits(cached, uncached))

    inv = {"kernels": read(None), "plain": read(plain_ops())}
    inv["faults"] = {name: read(dict(chunked_prefill_attention=f))
                     for name, f in planted_k5_faults().items()}
    inv["limit"] = dict(rel_rms=PREFILL_REL_RMS, max_abs_of_max_logit=PREFILL_MAX_ABS)
    for name, r in [("kernels", inv["kernels"]), ("plain", inv["plain"]),
                    *inv["faults"].items()]:
        log(f"  prefill invariants, {name}: {json.dumps(r)}")
    for side in ("a", "b"):
        require(prefill_holds(inv["kernels"][side]), f"invariant ({side}) fails: {inv}")
        require(prefill_holds(inv["plain"][side]), f"plain invariant ({side}) fails: {inv}")
        caught = {n: not prefill_holds(r[side]) for n, r in inv["faults"].items()}
        log(f"  invariant ({side}) planted faults caught: {caught}")
        require(all(caught.values()), f"invariant ({side}) misses a planted fault: {caught}")
    return inv


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase (no slice, no final ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the card only",
              file=sys.stderr)
        return 1
    from lite_llama_tpu_torch.ops import _build, norms

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    log("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    for name in _build.SOURCES:
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    x = torch.ones((2, 128), dtype=torch.bfloat16, device="cuda")
    norms.launch_rms_norm(x, x, x[0], 1e-5)  # Triton compiles at the first launch
    norms.launch_swiglu(x, x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  nvcc builds {built}; all kernels ready in {build_s:.1f} s")

    log("phase 3: kernels against their plain versions (bf16)")
    cases = kernel_phase()
    by_path = {"batch": {k: None for k in KERNELS}, "serving": {k: None for k in KERNELS}}
    if not args.kernels_only:
        from lite_llama_tpu_torch.models.decoder import init_decoder_params
        from lite_llama_tpu_torch.models.presets import llama32_3b

        dev = torch.device("cuda")
        cfg = llama32_3b(dtype=torch.bfloat16)
        params = init_decoder_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        log("phase 4: slice (batch generation)")
        summary, by_path["batch"] = slice_phase(dev, cfg, params)
        log("slice: " + json.dumps(summary))
        log("phase 5: serving")
        t0 = time.perf_counter()
        serving, by_path["serving"] = serving_phase(dev, cfg, params)
        serving["prefill_invariants"] = prefill_invariants(dev, cfg, params)
        serving["seconds"] = time.perf_counter() - t0
        log("serving: " + json.dumps(serving))

    kernels = []
    for name, meta in KERNELS.items():
        cs = cases[name]
        main_case = cs[0]
        runs = {path: counts[name] for path, counts in by_path.items()}
        entry = dict(
            name=name, **meta,
            launches=None if args.kernels_only else sum(runs.values()),
            launches_by_path=runs,
            max_abs_err=max(c["max_abs_err"] for c in cs),
            tolerance=f"|err| <= {ATOL} + {RTOL}*|plain|",
            ms=main_case["ms"], l2_warm_ms=main_case["l2_warm_ms"],
            eager_ms=main_case["eager_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], library=main_case["library"],
            shape=main_case["shape"], cases=cs,
        )
        if name == "rms_norm":
            c = cs[NORM_NO_RESIDUAL]
            entry["no_residual"] = {k: c[k] for k in (
                "shape", "max_abs_err", "ms", "l2_warm_ms", "eager_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library")}
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    if args.kernels_only:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
