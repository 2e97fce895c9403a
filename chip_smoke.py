#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (lite_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only   # phases 1-3 only, no final "ok" line

Phases, in order; any failure exits non-zero:
1. Device: refuse to run without CUDA (there is no CPU fallback); print the
   card's name and power limit from nvidia-smi.
2. Build: compile the CUDA kernels from csrc/ with nvcc for sm_90a (one
   nvcc per source, in parallel; each source with the headers it includes,
   csrc/common.cuh).
3. Kernels: each kernel's wrapper against its plain PyTorch version on the
   card in bf16, at the main-path shapes of Llama-3.2-3B (D=128, Nq=24,
   Hkv=8), Llama-3.2-1B (D=64, Nq=32, Hkv=8), OpenLLaMA-3B v2 (D=100,
   Nq=Hkv=32) and SmolLM2-360M (D=64, Nq=15, Hkv=5), and at D=80 and D=96
   with four query heads per kv head: max abs error against the
   stated tolerance, device time from CUDA events with the inputs rotated
   through HBM (and, beside it, replayed warm in L2), the least time the
   card could take (bytes over 3.35 TB/s or bf16 operations over 989
   TFLOP/s), the plain version's time and one PyTorch library call's time
   where one computes the same function (timed here only; the port never
   calls it), with the device kernels that call ran (which SDPA backend);
   K2 / K8 / K5 / K5q cases also print TFLOP/s beside the library call's,
   and phase 2 prints each source's build seconds and each prefill instance's
   registers, spills and dynamic shared memory (K2 / K8 are the fresh
   instances of csrc/flash_prefill_chunked.cu).
4. Batch slice: Llama-3.2-3B at full width and depth with random bf16
   weights from a seeded generator; InferenceEngine +
   TextGenerator.generate_tokens on 12 prompts of 25 random ids, greedy,
   max_gen_len 128. The engine's decode step is a CUDA graph, captured in
   the warm-up before that run (its capture in capture_ms); every kernel of
   the path must launch in the run, each replay counting the launches of
   the kernels it holds; the run is repeated for the median time. Decode
   ms per step is timed through the replayed graph and, in the same call,
   with the step run eagerly; a profiled decode gives the device time, the
   busy share and each decode kernel's launches per step from the device's
   own events (every decode kernel of the path must be among them, and the
   launch counters must read the same per step). The graph-vs-eager gate
   (graph_gate) decodes one batch through the graph and through the eager
   step from the same cache state: tokens and logprobs must be bit-equal,
   and a planted stale-token replay must be caught. Decode through the
   paged cache must agree with re-prefilling prompt + generated tokens in a fresh cache,
   within a limit set between the plain versions' reading and that of
   faults planted in K1's inputs; the script plants them and fails if the
   limit misses one.
5. Serving: the same model and weights through ServingFrontend ->
   ContinuousBatchingScheduler -> engine sessions with the prefix cache on
   (prefill_chunk 512, page 16, 64 slots, decode_chunk 32), from 4
   submitting threads, in two waves (serving_phase; the session's decode
   graphs of width 64 are captured before the timed waves); K5 must launch in each
   wave and the prefix cache must hit at least 16 times. Then two prefill
   invariants (prefill_invariants): chunked (K5) against single-shot (K2)
   prefill of 1500-token prompts, and prefix-hit against uncached prefill,
   read through the kernels, the plain versions and faults planted in K5's
   inputs.
6. Quantized slice (quantized_phase): the same seeded Llama-3.2-3B weights
   at full width and depth, quantized by the port to int4 (group 128,
   riffle), with an int8 KV pool: the phase-4 batch path (K6, K1q-int8, K2,
   K3, K4 must launch), decode through the int8 pool against a re-prefill
   with faults planted in K1q's scale inputs, last-token logits through the
   kernels against the plain versions with faults planted in K6's inputs,
   phase 5's serving waves (K5q-int8 must launch) and prefill invariants
   under the int8 pool; before those, a short fp8-KV run with the bf16
   weights (K5q-fp8 and K1q-fp8 must launch) with its own graph-vs-eager
   gate. Phase 6 reads 28 quantizer, 57 K3 int8-row and 28 K4 int8-row
   launches per int4 decode step from the device events.
7. OpenLLaMA-3B v2 (open_llama_phase): head dim 100, which the TPU package
   sends to _flash_prefill_vmem (K8 here), at full width and depth with
   random bf16 weights from the seed: the phase-4 batch run (K8, K1, K3, K4
   must launch, K2 must not; its graph-vs-eager gate) with its
   decode-vs-re-prefill invariant and K1
   faults, one serving wave (8 x 1500 ids and the shared-prefix prompt,
   prefix cache on; K5 must launch) and the chunked-vs-single-shot prefill
   invariant with K5 faults.
8. Summary: one JSON line with every kernel, then the last line
   {"ok": true, "device": {...}}.

Phase 3 times K3 / K4 (csrc/norms.cu) at decode widths (12 and 64 rows),
at the prefill widths of serving's chunk step (8 x 512 rows) and of a 4 x
2048 prefill, and K3 at H 8192; the forms that also write K6's int8 rows
where phase 6 runs them. A case is ``ok`` only if the residual sum and the
int8 rows are bit-equal (to qmm_quantize_rows of the kernel's own output),
K6 fed by those rows equals K6 fed by the output bit for bit, and, at the
main case, a planted fault (the weight shifted one column) fails the
tolerance. Beside them: the floor of one launch (an empty kernel through
ctypes, with and without PDL, in the same graph harness), the host time one
eager call takes to enqueue (``host_us``), the chain case: one 3B decode
layer's sequence from o_proj to the next layer's norm (o_proj, K3,
gate/up, K4, down, K3) captured in one graph over eight layers' weights,
in bf16 and int4 (``chain``). Phase 4-7's decode profiles split K3, K4,
K6 and K6's quantizer out of each step's device time; phase 6 requires K3 / K4
to write the int8 rows of wqkv, gate_up, down and the head, so the
quantizer runs once per layer (o_proj) and per step.

Phase 3 also holds the quantized kernels against their plain versions: K6
(W4A8) and K7 (W8A8) at the 3B projection shapes (scale groups of 128, 48,
16 and 8 rows, and per-channel), an fp32 output (and every K7 output)
equal to the plain version's bit for bit, with faults planted in their
inputs that must fail the tolerance, and K1q / K5q on int8 and fp8 pools
at K1's and K5's main shapes. K6 / K7 count their integer operations
against the int8 peak (1,979 TOP/s). Each K6 / K7 case prints its split of
C (and K7's k-warps), grid, shared memory and ptxas line (``launch``); the
timed K6 split cases also time every split count the planner allows
(``ms_by_splits``), the timed K7 cases above 16 rows ``torch._int_mm`` on
the same int8 bytes (``int8_library_ms``). Phase 6's decode profile gives
K6's device time per step (``quantized_matmul_packed_device_ms_per_step``,
its quantizer apart).
K1 / K1q run on the
engine's page-table width (2048 positions) at the decode batch, ragged
batches and serving's width (64 slots, 8 of 1,820 tokens); each case prints
its split plan, live splits per request, grid, shared memory and ptxas line
(``launch``). Phase 4's decode profile gives K1's device time per step
(``paged_flash_decode_device_ms_per_step``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores (K6 / K7's integer dots)
L2_BYTES = 50 * 2**20  # H100 SXM L2
COLD_BYTES = 4 * L2_BYTES  # inputs one timed pass rotates through
WARM_MS = 20.0  # device time a timed graph runs before, and at least while, it is timed
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
# 0: single-shot prefill (K2 / K8) is the no-history instance of K5's
# template, and each row walks the same 64-key tiles (chunks start at
# multiples of 512) in the same order with the same arithmetic, so the
# logits agree bit for bit by construction.
# The plain versions read 0.030 / 0.033, the smallest planted fault
# (start_pos one page short) 0.452 / 0.510. The limits sit near the
# geometric mean of the last two, ~4x from either side.
PREFILL_REL_RMS = 0.12
PREFILL_MAX_ABS = 0.12
WAVE_GEN = 64  # max_gen_len of every serving request
GEN_REPEATS = 3  # generate_tokens runs timed (host time varies run to run)
SPLIT_REPEATS = 5  # prefill + decode runs timed apart
EAGER_REPEATS = 2  # the same decode runs with the step eager (not replayed)
OPEN_LLAMA_REPEATS = (2, 3, 1)  # phase 7's, cut to keep the script near half its time limit
SEED = 0

NORM_NO_RESIDUAL = 3  # index of K3's no-residual case in kernel_phase()
# The launch counters (read_counts()) of the kernels a decode step runs,
# each with a pattern of its device kernels' names: launches per step are
# read from the profiler's device events of the replayed steps
# (profile_decode), which the counters must equal.
# K1 / K1q by pool (paged_decode_kernel<DP, KV>); K3 (rows_kernel<0>,
# rows_loop_kernel<0>) and, apart, its launches that write K6's int8 rows
# (EMIT, rows_kernel's last template flag); K4 (swiglu_kernel, and
# rows_kernel<1> whenever it writes int8 rows); K6's matmul (no model path
# runs K7) and its activation quantizer.
DEVICE_KERNELS = {
    "paged_flash_decode": r"paged_decode_kernel<\d+, 0>",
    "paged_flash_decode_int8": r"paged_decode_kernel<\d+, 1>",
    "paged_flash_decode_fp8": r"paged_decode_kernel<\d+, 2>",
    "rms_norm": r"rows(_loop)?_kernel<0,",
    "rms_norm_int8_rows": r"rows_kernel<0,[^>]*, true>",
    "swiglu": r"swiglu_kernel|rows(_loop)?_kernel<1,",
    "swiglu_int8_rows": r"rows(_loop)?_kernel<1,",
    "quantized_matmul_packed": r"qmm_kernel",
    "quantize_rows": r"quantize_rows_kernel",
}
KERNELS = {
    "paged_flash_decode": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/paged_decode.cu",
        replaces="lite_llama_tpu/ops/attention_decode.py:345"),
    "flash_prefill": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill_chunked.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:614"),
    "rms_norm": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/norms.cu",
        replaces="lite_llama_tpu/ops/norms.py:83",
        also_replaces="lite_llama_tpu/ops/norms.py:61"),
    "swiglu": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/norms.cu",
        replaces="lite_llama_tpu/ops/norms.py:115"),
    "flash_prefill_chunked": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill_chunked.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:650"),
    "quantized_matmul_packed": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/qmatmul.cu",
        replaces="lite_llama_tpu/ops/qmatmul.py:435"),
    "quantized_matmul_int8": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/qmatmul.cu",
        replaces="lite_llama_tpu/ops/qmatmul.py:289"),
    "paged_flash_decode_int8": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/paged_decode.cu",
        replaces="lite_llama_tpu/ops/attention_decode.py:345",
        branch="lite_llama_tpu/ops/attention_decode.py:272-299 (quantized=True)"),
    "paged_flash_decode_fp8": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/paged_decode.cu",
        replaces="lite_llama_tpu/ops/attention_decode.py:345",
        branch="lite_llama_tpu/ops/attention_decode.py:300-311 (fp8 page tiles)"),
    "flash_prefill_chunked_int8": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill_chunked.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:650",
        branch="lite_llama_tpu/ops/attention_prefill.py:200-245 (quantized=True)"),
    "flash_prefill_chunked_fp8": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill_chunked.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:650",
        branch="fp8 pools: the JAX dispatcher's reference (ops/__init__.py:96-117)"),
    "flash_prefill_vmem": dict(
        route="cuda", source="lite_llama_tpu_torch/csrc/flash_prefill_chunked.cu",
        replaces="lite_llama_tpu/ops/attention_prefill.py:376",
        branch="head dims that do not pack into 128 lanes (flash_prefill, :628-637)"),
}
# The kernels each main path must launch: batch generation of short prompts
# (phase 4) and serving (phase 5; K2 runs there only for a prompt batch
# that is neither long nor a prefix hit, which the admission order decides).
BATCH_PATH = ("paged_flash_decode", "flash_prefill", "rms_norm", "swiglu")
SERVING_PATH = ("paged_flash_decode", "rms_norm", "swiglu", "flash_prefill_chunked")
# Phase 6: int4 weights with an int8 pool (batch, then serving), and bf16
# weights with an fp8 pool. K7 runs in phase 3 only: as in the JAX package,
# no model path routes to it.
QUANT_BATCH_PATH = ("quantized_matmul_packed", "paged_flash_decode_int8", "flash_prefill",
                    "rms_norm", "swiglu")
QUANT_SERVING_PATH = ("quantized_matmul_packed", "paged_flash_decode_int8", "rms_norm", "swiglu",
                      "flash_prefill_chunked_int8")
FP8_KV_PATH = ("flash_prefill_chunked_fp8", "paged_flash_decode_fp8")
# Phase 7, head dim 100: fresh prefill takes K8, never K2.
OPEN_LLAMA_BATCH_PATH = ("paged_flash_decode", "flash_prefill_vmem", "rms_norm", "swiglu")
# The 3B projections K6 serves at decode: (C, logical O, fp32 output).
QMM_SHAPES = {
    "gate_up": (3072, 16384, False),
    "wqkv": (3072, 5120, False),
    "o_proj": (3072, 3072, False),
    "down": (8192, 3072, False),
    "lm_head": (3072, 128256, True),  # stored 129024 wide (lane-alignment pad)
}
# Phase-6 limits, relative RMS of a logit difference and max |difference|
# over max |logit|, each set between the plain versions' reading and the
# smallest planted fault, as read on an H100 (PERF.md):
# decode through the int8 pool vs a re-prefill after 127 steps (K1q faults):
# kernels 0.203 / 0.204, plain 0.186 / 0.199, smallest fault 1.10 / 1.10
# (int4 activations round to int8 per row; in 28 random layers one
# flipped rounding spreads, so the noise is 5x bf16's and top-1 is not
# compared);
QUANT_INVARIANT_REL_RMS = 0.45
QUANT_INVARIANT_MAX_ABS = 0.45
# last-token logits of the int4 model, kernels vs plain versions (K6
# faults): plain 0.167 / 0.149, smallest fault 1.16 / 1.20 (K6
# equals its plain version, but K2's and K3's bf16 roundings flip int8
# activation roundings that 28 layers spread);
QLOGITS_REL_RMS = 0.45
QLOGITS_MAX_ABS = 0.45
# chunked vs single-shot and prefix-hit vs uncached prefill under the int8
# pool (K5q faults): kernels (a) 0.064 / 0.067, (b) 0.181 / 0.174 (the
# redesigned K5q reads the same), plain (a) 0.065 / 0.065, (b) 0.174 /
# 0.175, smallest fault (a) 0.460 / 0.554 ((b) compares a W4A8 tail of 96
# rows with a W4A16 prefill of 608).
QPREFILL_REL_RMS = 0.3
QPREFILL_MAX_ABS = 0.3
# Phase-7 limits (OpenLLaMA-3B, bf16), relative RMS and max |difference| over
# max |logit|, between the plain versions' reading and the smallest planted
# fault, as read on an H100 (PERF.md): decode vs re-prefill after 127 steps
# (K1 faults), plain 0.036 / 0.031, kernels 0.045 / 0.040, smallest fault
# (two pages swapped) 0.153 / 0.151; chunked (K5) vs single-shot (K8)
# prefill of the 1500-token prompts (K5 faults), kernels 0 / 0 (as for K2
# at 3B: the same tiles in the same order), plain 0.030 / 0.034, smallest
# fault 0.479 / 0.721. Phase 4's and 5's limits sit
# between both pairs too.
OPEN_LLAMA_INVARIANT = (INVARIANT_REL_RMS, INVARIANT_MAX_ABS)
OPEN_LLAMA_PREFILL = (PREFILL_REL_RMS, PREFILL_MAX_ABS)
MODELS = {  # head_dim, query heads, kv heads (attention shapes of phase 3)
    "llama-3.2-3b": dict(D=128, Nq=24, Hkv=8),
    "llama-3.2-1b": dict(D=64, Nq=32, Hkv=8),
    "open-llama-3b-v2": dict(D=100, Nq=32, Hkv=32),
    "smollm2-360m": dict(D=64, Nq=15, Hkv=5),  # odd Hkv: the TPU cannot pack D=64
    "D=80 G=4": dict(D=80, Nq=32, Hkv=8),  # head dims that do not divide 128,
    "D=96 G=4": dict(D=96, Nq=32, Hkv=8),  # with grouped queries
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
    (eager calls of these small kernels measure the host, not the card). The
    graph runs for ``WARM_MS`` before the timed replays, which last as long
    at least (a 5 ms window read most K6 / K7 cases 1-5 % higher)."""
    calls = copies * math.ceil(min_calls / len(copies))
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    per_replay = max(start.elapsed_time(end), 1e-3)
    for _ in range(math.ceil(WARM_MS / per_replay)):
        graph.replay()
    reps = max(3, math.ceil(200 / len(calls)), math.ceil(WARM_MS / per_replay))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def device_kernels(fn, args):
    """Names of the device kernels one call of ``fn`` runs (for SDPA: which
    backend it took); empty when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({e.key[:70] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0})


def timings(kernel, plain, args, touched_bytes, library=None, plain_in_graph=True):
    """ms, eager_ms, plain_ms and library_ms on inputs rotated through HBM
    (see input_copies); l2_warm_ms is the kernel on one input set replayed,
    which stays in L2. ``kernel`` and ``plain`` take ``args``; ``library`` is
    (fn, its own args, the bytes it touches) or None; an SDPA library call's
    device kernels are recorded too (``library_kernels``)."""
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
        if getattr(fn, "sdpa", False):
            t["library_kernels"] = device_kernels(fn, lib_args)
    return t


def sdpa(**kw):
    """F.scaled_dot_product_attention with ``kw``, marked for timings() to
    record which backend it ran."""
    def call(q, k, v, mask=None):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)

    call.sdpa = True
    return call


def chunked_smem(D, kv):
    """Dynamic shared memory of the K5 / K5q instance for head dim D and
    pool type ``kv`` (0 bf16, 1 int8, 2 fp8), or of the fresh K2 / K8
    instance (3), from the built library."""
    import ctypes

    from lite_llama_tpu_torch.ops import _build

    lib = _build.library("flash_prefill_chunked", "flash_prefill_chunked_smem",
                         [ctypes.c_int, ctypes.c_int])
    return lib.flash_prefill_chunked_smem(D, kv)


def bound(bytes_moved, flops, ops_per_s=BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
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


def quantized_pages(pages, kv, Hkv):
    """A bf16 pool [L, 2, T, Hkv*D] as an int8 pool with its merged scale
    slab [L, T, 128] (the port's own KV quantizer), an fp8 pool, or as it is;
    returns (pages, scales or None, the dequantized bf16 pool)."""
    from lite_llama_tpu_torch.executor import kv_cache as kvc

    if kv is None:
        return pages, None, pages
    L, _, T, HD = pages.shape
    if kv == "fp8":
        q = kvc._cast_kv(pages, torch.float8_e4m3fn).view(torch.float8_e4m3fn)
        return q, None, q.bfloat16()
    qv, sc = kvc._quantize_kv(pages.view(L, 2, T, Hkv, -1))
    deq = (qv.float() * sc.float()[..., None]).bfloat16().view(L, 2, T, HD)
    return qv.view(L, 2, T, HD), kvc._scale_rows(sc[:, 0], sc[:, 1]), deq


def decode_launch_info(B, Hkv, D, ps, ppr, lens, kv):
    """K1 / K1q's launch at this shape: the split plan (S_max, the least
    span), each request's live splits as the device decides them, the
    blocks with an item, the grid (one wave of resident blocks at most),
    dynamic shared memory and the instance's ptxas report."""
    import ctypes

    from lite_llama_tpu_torch.ops import _build
    from lite_llama_tpu_torch.ops import attention_decode as ad

    plan = ad.plan_decode_splits(ppr, ps)
    dtype = {None: torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]
    slots = ad.decode_grid_slots(D, dtype, B, Hkv, plan.s_max)
    live = [len(sp) for sp in ad.decode_spans(lens, ps, plan.s_max, plan.min_span, slots)]
    lib = _build.library("paged_decode", "paged_decode_smem", [ctypes.c_int] * 2)
    dp = -(-D // (16 if kv is None else 32)) * (16 if kv is None else 32)
    inst = f"paged_decode_kernelILi{dp}ELi{ad._KV_CODES[dtype]}E"  # mangled <DP, KV>
    ptxas = [v for k, v in ptxas_report("paged_decode").items() if inst in k]
    return dict(s_max=plan.s_max, min_span_pages=plan.min_span,
                live_splits=live, blocks_with_an_item=Hkv * sum(live), grid=[Hkv, slots],
                smem_bytes=lib.paged_decode_smem(D, ad._KV_CODES[dtype]),
                ptxas=ptxas[0] if ptxas else "not found")


def decode_case(model, lens, ps=16, kv=None, max_seq_len=2048):
    """K1 (bf16 pool) or K1q (``kv`` "int8" / "fp8") at ``lens`` tokens per
    request against its plain version, through a page table as wide as the
    engine gives it (``max_seq_len`` / ``ps`` pages; zeros past a request's
    pages, shuffled page ids before)."""
    from lite_llama_tpu_torch.executor.kv_cache import KVPool
    from lite_llama_tpu_torch.ops.attention_decode import (
        paged_decode_state_plain, paged_flash_decode)

    m = MODELS[model]
    D, Nq, Hkv = m["D"], m["Nq"], m["Hkv"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    B = len(lens)
    ppr = math.ceil(max_seq_len / ps)
    used = [math.ceil(n / ps) for n in lens]
    P = sum(used) + 1
    pages = torch.randn((2, 2, P * ps, Hkv * D), generator=g, device=dev).bfloat16()
    pages, scales, deq = quantized_pages(pages, kv, Hkv)
    perm = torch.randperm(P, generator=g, device=dev).int()
    table = torch.zeros((B, ppr), dtype=torch.int32, device=dev)
    for b, n in enumerate(used):
        table[b, :n] = perm[sum(used[:b]): sum(used[:b]) + n]
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, Nq, D), generator=g, device=dev).bfloat16()
    scale = D**-0.5

    def kernel(q, pages, scales, table, kv_lens):
        pool = KVPool(pages, ps, Hkv, D, scales)
        return paged_flash_decode(q, pool, 1, table, kv_lens, scale, return_state=True)

    def plain(q, pages, scales, table, kv_lens):
        return paged_decode_state_plain(q, pages, ps, 1, table, kv_lens, scale, scales)

    args = (q, pages, scales, table, kv_lens)
    out, mm, ll = kernel(*args)
    po, pm, pl = plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(out, po)
    m_ok = bool(torch.all((mm - pm).abs() <= 1e-3 * torch.clamp(pm.abs(), min=1.0)))
    l_ok = bool(torch.all((ll - pl).abs() <= 1e-3 * pl.abs() + 1e-6))
    tokens = sum(lens)
    value_bytes = pages.element_size()
    scale_bytes = tokens * 2 * Hkv * 2 if scales is not None else 0  # the lanes read
    bytes_moved = (tokens * 2 * Hkv * D * value_bytes + scale_bytes + 2 * B * Nq * D * 2
                   + B * Nq * 8 + B * 4 + sum(used) * 4)
    t_bound, by = bound(bytes_moved, 4 * tokens * Nq * D)
    # Library yardstick: SDPA on the same K/V gathered dense up to the
    # longest request (gather and dequantization untimed).
    n_cols = max(1, max(used))
    rows = (table[:, :n_cols].long()[:, :, None] * ps + torch.arange(ps, device=dev)).view(B, -1)
    kd = deq[1, 0][rows].view(B, -1, Hkv, D).transpose(1, 2).repeat_interleave(Nq // Hkv, 1)
    vd = deq[1, 1][rows].view(B, -1, Hkv, D).transpose(1, 2).repeat_interleave(Nq // Hkv, 1)
    mask = (torch.arange(rows.shape[1], device=dev)[None] < kv_lens[:, None])[:, None, None]
    lib_args = (q[:, :, None], kd, vd, mask)
    t = timings(
        kernel,
        plain,  # reads max(kv_lens) on the host: timed eagerly
        args, bytes_moved,
        (sdpa(), lib_args, sum(a.numel() * a.element_size() for a in lib_args)),
        plain_in_graph=False,
    )
    del lib_args, kd, vd
    return dict(model=model, shape=f"B={B} Nq={Nq} Hkv={Hkv} D={D} page_size={ps} "
                                   f"table={ppr} pages kv_lens={compact_lens(lens)} "
                                   f"pool={kv or 'bf16'}",
                max_abs_err=err, ok=ok and m_ok and l_ok, **t,
                bound_ms=t_bound, bound_by=by,
                launch=decode_launch_info(B, Hkv, D, ps, ppr, lens, kv),
                library="F.scaled_dot_product_attention (dense K/V, boolean mask"
                        + (", dequantized to bf16)" if kv else ")"))


def compact_lens(lens):
    """``lens`` with runs written n x len: [1820, 1820, 0] -> "2 x 1820 + 1 x 0"."""
    runs = []
    for n in lens:
        if runs and runs[-1][1] == n:
            runs[-1][0] += 1
        else:
            runs.append([1, n])
    if len(runs) == len(lens):
        return str(list(lens))
    return " + ".join(f"{c} x {n}" for c, n in runs)


def prefill_case(model, B, S, lens):
    """ops.prefill_attention (K2 at head dims 64 and 128, K8 at the others)
    against its plain version; ``ran`` names the kernel that launched."""
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import attention_prefill as ap
    from lite_llama_tpu_torch.ops import ref

    m = MODELS[model]
    D, Nq, Hkv = m["D"], m["Nq"], m["Hkv"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    launchers = {"flash_prefill": ap.launch_flash_prefill,
                 "flash_prefill_vmem": ap.launch_flash_prefill_vmem}
    before = {n: f.launches for n, f in launchers.items()}
    got = ops.prefill_attention(q, k, v, sl)
    ran = [n for n, f in launchers.items() if f.launches != before[n]]
    want = ref.prefill_attention(q, k, v, sl)
    torch.cuda.synchronize()
    # The kernels round sm_scale*log2(e)*q to bf16; the plain version and the
    # TPU's _flash_prefill_vmem keep it in fp32. The plain version on that
    # rounded q (natural-domain scale 1/log2(e)) isolates the rounding.
    q_r = (q.float() * (D**-0.5 * ref.LOG2E)).bfloat16()
    want_r = ref.prefill_attention(q_r, k, v, sl, sm_scale=1.0 / ref.LOG2E)
    torch.cuda.synchronize()
    err, ok, err_r, gap = 0.0, True, 0.0, 0.0
    for b, n in enumerate(lens):  # pad rows are never read
        e, o = max_err(got[b, :n], want[b, :n])
        err, ok = max(err, e), ok and o
        err_r = max(err_r, max_err(got[b, :n], want_r[b, :n])[0])
        gap = max(gap, max_err(want_r[b, :n], want[b, :n])[0])
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = 4 * Nq * D * pairs
    # Rows past seq_lens[b] are neither read nor needed: q, out, k and v
    # count only each request's own rows.
    bytes_moved = sum(lens) * (2 * Nq * D * 2 + 2 * Hkv * D * 2) + B * 4
    t_bound, by = bound(bytes_moved, flops)
    lib_args = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(Nq // Hkv, 1),
                v.transpose(1, 2).repeat_interleave(Nq // Hkv, 1))
    t = timings(ops.prefill_attention, ref.prefill_attention, (q, k, v, sl), bytes_moved,
                (sdpa(is_causal=True), lib_args,
                 sum(a.numel() * a.element_size() for a in lib_args)))
    return dict(model=model, shape=f"B={B} S={S} Nq={Nq} Hkv={Hkv} D={D} lens={lens}",
                ran=ran[0] if len(ran) == 1 else ran,
                max_abs_err=err, ok=ok, max_abs_err_q_rounded=err_r, q_rounding_gap=gap,
                **t, bound_ms=t_bound, bound_by=by,
                tflops=flops / t["ms"] / 1e9, library_tflops=flops / t["library_ms"] / 1e9,
                library="F.scaled_dot_product_attention (is_causal, full length S)")


# K6 weights the int8-row cases feed, one per contraction width, made once.
_K6_FOR_ROWS = {}


def k6_on_rows(rows):
    """K6 (a 2-layer int4 g128 riffle stack, 1024 columns) fed by the int8
    rows of ``rows`` (ops/qmatmul.py QuantizedRows) and fed by its
    activations: True where the fp32 outputs are bit-equal."""
    from lite_llama_tpu_torch.ops import qmatmul as qmm
    from lite_llama_tpu_torch.quant.qtensor import quantize

    x2 = rows.x.reshape(-1, rows.x.shape[-1])
    C = x2.shape[1]
    if C not in _K6_FOR_ROWS:
        g = torch.Generator(device=x2.device).manual_seed(SEED + 8)
        w = torch.randn((2, C, 1024), generator=g, device=x2.device).mul_(0.02).bfloat16()
        _K6_FOR_ROWS[C] = quantize(w, (1,), "int4", group_size=128, riffle_blocks=1)
    qt = _K6_FOR_ROWS[C]
    fed = qmm.quantized_matmul_packed(qmm.QuantizedRows(x2, rows.xi, rows.xs), qt.q, qt.scale,
                                      1, torch.float32, False)
    own = qmm.quantized_matmul_packed(x2, qt.q, qt.scale, 1, torch.float32, False)
    return bool(torch.equal(fed, own))


def int8_rows_checks(rows):
    """The int8 rows a K3 / K4 call wrote beside its output: equal to K6's
    own quantizer (qmm_quantize_rows) on that output, and K6 fed by them
    equal to K6 fed by the output, bit for bit."""
    from lite_llama_tpu_torch.ops import qmatmul as qmm

    xi, xs = qmm.launch_quantize_rows(rows.x.reshape(-1, rows.x.shape[-1]))
    return dict(int8_rows_bit_equal=bool(torch.equal(rows.xi, xi) and torch.equal(rows.xs, xs)),
                k6_on_rows_bit_equal=k6_on_rows(rows))


def norm_case(rows, H, residual, int8=False, fault=False):
    """K3 (skip_rms_norm; rms_norm without ``residual``) at [rows, H]
    against its plain version; the rounded residual sum must be exact.
    ``int8``: the form that also writes K6's int8 rows (int8_rows_checks).
    ``fault``: the weight shifted one column must fail the tolerance."""
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import norms, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn((rows, H), generator=g, device=dev).bfloat16()
    r = torch.randn((rows, H), generator=g, device=dev).bfloat16() if residual else None
    w = (1 + 0.1 * torch.randn((H,), generator=g, device=dev)).bfloat16()

    def kernel(x, r, w):
        return ops.skip_rms_norm(x, r, w, int8_rows=int8)

    def plain(x, r, w):
        return norms.skip_rms_norm_plain(x, r, w, int8_rows=int8)

    n, s = kernel(x, r, w)
    pn, ps_ = ref.skip_rms_norm(x, r, w)
    torch.cuda.synchronize()
    err, ok = max_err(n.x if int8 else n, pn)
    rec = dict(residual_bit_equal=bool(torch.equal(s, ps_)))  # the rounded sum is exact
    if int8:
        rec.update(int8_rows_checks(n))
    if fault:
        ferr, fok = max_err(ops.skip_rms_norm(x, r, w.roll(1))[0], pn)
        rec["faults"] = {"weight shifted one column": dict(max_abs_err=ferr, caught=not fok)}
    ok = (ok and all(v for k, v in rec.items() if k.endswith("bit_equal"))
          and all(f["caught"] for f in rec.get("faults", {}).values()))
    n_io = (4 if residual else 2) * rows * H * 2 + H * 2 + (rows * (H + 4) if int8 else 0)
    t_bound, by = bound(n_io, 4 * rows * H)
    t = timings(kernel, plain, (x, r, w), n_io,
                (lambda x, w: F.rms_norm(x, (H,), w, 1e-5), (x, w), 2 * rows * H * 2 + H * 2))
    return dict(shape=f"[{rows}, {H}] residual={residual}" + (" int8_rows" if int8 else ""),
                max_abs_err=err, ok=ok, **rec, **t, bound_ms=t_bound, bound_by=by,
                launch=norms.launch_shape("rms", x, r, w),
                library="F.rms_norm (normalisation alone, no residual add)")


def chunked_case(model, starts, clens, S=512, ps=16, return_state=False, kv=None):
    """K5 (bf16 pool) or K5q (``kv`` "int8" / "fp8") on one chunk of S query
    rows per request over a paged history of ``starts[b]`` tokens (page ids
    shuffled) plus the chunk's own ``clens[b]`` keys, against its plain
    version on out (and m, l)."""
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
    pages, scales, deq = quantized_pages(pages, kv, Hkv)
    table = torch.randperm(P, generator=g, device=dev).view(B, ppr).int()  # shuffled
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).bfloat16()
    sp = torch.tensor(starts, dtype=torch.int32, device=dev)
    cl = torch.tensor(clens, dtype=torch.int32, device=dev)
    scale = D**-0.5

    def kernel(q, k, v, cl, sp, pages, scales, table):
        return flash_prefill_chunked(q, k, v, cl, sp, KVPool(pages, ps, Hkv, D, scales), 1,
                                     table, scale, return_state=return_state)

    def plain(q, k, v, cl, sp, pages, scales, table):
        return chunked_prefill_state_plain(q, k, v, cl, sp, pages, ps, 1, table, scale, scales)

    args = (q, k, v, cl, sp, pages, scales, table)
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
    scale_bytes = 2 * hist_tok * Hkv * 2 if scales is not None else 0  # the lanes read
    bytes_moved = (2 * hist_tok * Hkv * D * pages.element_size() + scale_bytes
                   + rows * (2 * Nq * D * 2 + 2 * Hkv * D * 2)
                   + (rows * Nq * 8 if return_state else 0) + 2 * B * 4
                   + sum(math.ceil(s / ps) for s in starts) * 4)
    flops = 4 * Nq * D * sum(c * s + c * c / 2 for c, s in zip(clens, starts))
    t_bound, by = bound(bytes_moved, flops)
    # Library yardstick: SDPA on the history gathered dense beside the
    # chunk's keys, with the same mask (the gather is not timed).
    Th = max(1, math.ceil(max(starts) / ps)) * ps
    hrows = (table.long()[:, : Th // ps, None] * ps + torch.arange(ps, device=dev)).view(B, Th)
    G = Nq // Hkv
    kd = torch.cat([deq[1, 0][hrows].view(B, Th, Hkv, D), k], 1)
    vd = torch.cat([deq[1, 1][hrows].view(B, Th, Hkv, D), v], 1)
    kd, vd = (x.transpose(1, 2).repeat_interleave(G, 1).contiguous() for x in (kd, vd))
    t_h = torch.arange(Th, device=dev)
    t_c = torch.arange(S, device=dev)
    mask = torch.cat([(t_h[None] < sp[:, None])[:, None, :].expand(B, S, Th),
                      (t_c[None, :] <= t_c[:, None])[None] & (t_c[None, None] < cl[:, None, None])],
                     -1)[:, None]
    lib_args = (q.transpose(1, 2).contiguous(), kd, vd, mask)
    t = timings(
        kernel, plain, args, bytes_moved,
        (sdpa(), lib_args, sum(a.numel() * a.element_size() for a in lib_args)),
        plain_in_graph=False,  # the plain version reads max(start_pos) on the host
    )
    starts_s = list(starts) if len(set(starts)) > 1 else f"{starts[0]} x {B}"
    clens_s = list(clens) if len(set(clens)) > 1 else f"{clens[0]} x {B}"
    return dict(model=model, shape=f"B={B} S={S} Nq={Nq} Hkv={Hkv} D={D} page_size={ps} "
                                   f"start_pos={starts_s} chunk_lens={clens_s} "
                                   f"return_state={return_state} pool={kv or 'bf16'}",
                max_abs_err=err, ok=ok, **t, bound_ms=t_bound, bound_by=by,
                tflops=flops / t["ms"] / 1e9, library_tflops=flops / t["library_ms"] / 1e9,
                library="F.scaled_dot_product_attention (history gathered dense"
                        + (" and dequantized to bf16" if kv else "") + " + chunk, boolean mask)")


def swiglu_case(rows, I, int8=False):
    """K4 at [rows, I] against its plain version. ``int8``: on the row-strided
    halves of one [rows, 2I] product (the int4 path's riffle gate_up), also
    writing K6's int8 rows (int8_rows_checks)."""
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import norms, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    if int8:
        args = (torch.randn((rows, 2 * I), generator=g, device=dev).bfloat16(),)

        def kernel(y):
            return ops.swiglu(y[:, :I], y[:, I:], int8_rows=True)

        def plain(y):
            return norms.swiglu_plain(y[:, :I], y[:, I:], int8_rows=True)

        gate, up = args[0][:, :I], args[0][:, I:]
    else:
        args = gate, up = (torch.randn((rows, I), generator=g, device=dev).bfloat16(),
                           torch.randn((rows, I), generator=g, device=dev).bfloat16())
        kernel, plain = ops.swiglu, norms.swiglu_plain
    got = kernel(*args)
    want = ref.swiglu(gate, up)
    torch.cuda.synchronize()
    err, ok = max_err(got.x if int8 else got, want)
    rec = int8_rows_checks(got) if int8 else {}
    ok = ok and all(rec.values())
    n_io = 3 * rows * I * 2 + (rows * (I + 4) if int8 else 0)
    t_bound, by = bound(n_io, 5 * rows * I)
    t = timings(kernel, plain, args, n_io)
    return dict(shape=f"[{rows}, {I}]" + (" int8_rows (riffle halves)" if int8 else ""),
                max_abs_err=err, ok=ok, **rec, **t, bound_ms=t_bound, bound_by=by,
                launch=norms.launch_shape("swiglu", gate, up, int8_rows=int8), library=None)


CHAIN_LAYERS = 8  # a chain graph walks 8 layers' weights: 1.4 GB bf16, 0.34 GB int4


def chain_case(quantized):
    """One Llama-3.2-3B decode layer's sequence from o_proj to the next
    layer's attention norm at 12 rows, as decoder_decode runs it: o_proj,
    K3 (the MLP norm), gate/up, K4, down, K3 (the next attention norm); in
    bf16 (cuBLAS projections) or, with ``quantized``, int4 g128 riffle (K6,
    fed the int8 rows K3 / K4 write where the decoder asks for them).
    Captured in one graph over CHAIN_LAYERS layers' weights (rotated through
    HBM). Returns ms per layer and the launches of one layer."""
    import dataclasses

    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.models import decoder as dec
    from lite_llama_tpu_torch.models.presets import llama32_3b
    from lite_llama_tpu_torch.quant.qtensor import quantize_decoder_params

    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama32_3b(dtype=torch.bfloat16), num_hidden_layers=CHAIN_LAYERS)
    params = {"layers": dec.init_decoder_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED))["layers"]}
    if quantized:
        params = quantize_decoder_params(params, "int4", group_size=128, riffle=True)
    layers = dec._unstack_layers(params)
    rows_attn, rows_mlp, rows_down, _ = dec._int8_rows(params, 12)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    attn = torch.randn((12, cfg.num_attention_heads, cfg.head_dim), generator=g,
                       device=dev).bfloat16()
    residual = torch.randn((12, cfg.hidden_size), generator=g, device=dev).bfloat16()
    eps = cfg.rms_norm_eps

    def chain():
        res = residual
        for li, lp in enumerate(layers):
            normed2, res = ops.skip_rms_norm(dec._attn_out(lp, attn), res, lp["mlp_norm"], eps,
                                             int8_rows=rows_mlp)
            x = dec._mlp(lp, normed2, rows_down)
            nxt = layers[(li + 1) % len(layers)]
            ops.skip_rms_norm(x, res, nxt["attn_norm"], eps, int8_rows=rows_attn)

    reset_counts()
    chain()
    launches = {k: v / CHAIN_LAYERS for k, v in read_counts().items() if v}
    ms = graph_ms(chain, [()], min_calls=1) / CHAIN_LAYERS
    del params, layers
    free_device()
    return dict(weights="int4 g128 riffle" if quantized else "bf16", rows=12, ms_per_layer=ms,
                launches_per_layer=launches)


def launch_floor():
    """Device ms per launch of an empty kernel of csrc/norms.cu (the PDL
    handshake K3 / K4 make, nothing else) launched through ctypes as they
    are, back to back in graph_ms, without and with PDL: at K3's decode
    launch (12 blocks of 384 threads) and as one block; and with PDL at
    K3's launch copying 16 bytes a thread after the handshake (K3's rows,
    12 x 3072 bf16, rotated through HBM: the dependent load and store every
    K3 / K4 makes)."""
    from lite_llama_tpu_torch.ops import norms

    out = {f"{blocks}x{threads} pdl={pdl}": graph_ms(
        lambda b=blocks, t=threads, p=pdl: norms.launch_empty(b, t, p), [()])
        for blocks, threads in ((12, 384), (1, 32)) for pdl in (False, True)}
    src = torch.zeros((12 * 384, 8), dtype=torch.int16, device="cuda")
    out["12x384 pdl=True copy"] = graph_ms(
        lambda s, d: norms.launch_empty(12, 384, True, s, d),
        input_copies((src, torch.empty_like(src)), 2 * src.numel() * 2))
    return out


def host_us(fn, args, calls=3000, warmup=200):
    """Host microseconds one eager call of ``fn`` takes to enqueue its work
    (no synchronize inside the timed loop), over ``calls`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_costs():
    """host_us of K3 and K4 at the 3B decode shapes (and their int8 forms),
    beside one eager PyTorch add of the same rows, and of the two ways to
    get the stream handle a launch passes."""
    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.ops import _build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x, r = (torch.randn((12, 3072), generator=g, device=dev).bfloat16() for _ in range(2))
    w = torch.ones((3072,), device=dev).bfloat16()
    y = torch.randn((12, 2 * 8192), generator=g, device=dev).bfloat16()
    return {
        "K3 skip_rms_norm [12, 3072]": host_us(ops.skip_rms_norm, (x, r, w)),
        "K3 int8_rows": host_us(lambda: ops.skip_rms_norm(x, r, w, int8_rows=True), ()),
        "K4 swiglu [12, 8192] halves": host_us(ops.swiglu, (y[:, :8192], y[:, 8192:])),
        "K4 int8_rows": host_us(lambda g, u: ops.swiglu(g, u, int8_rows=True),
                                (y[:, :8192], y[:, 8192:])),
        "torch.add [12, 3072] (eager PyTorch)": host_us(torch.add, (x, r)),
        "stream handle, torch.cuda.current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, ()),
        "stream handle, _build.current_stream(dev)": host_us(_build.current_stream, (x.device,)),
    }


def norm_extras():
    """Phase 3's K3 / K4 measurements beside the cases: the launch floor,
    the chain in bf16 and int4, and the host cost of one eager call."""
    return dict(launch_floor_ms=launch_floor(), chain=[chain_case(False), chain_case(True)],
                host_us=host_costs())


def planted_k7_faults(x):
    """K7 handed its weight with the scale rows shifted one group, each
    column the neighbouring column's scale, or the sign bit of one k-row's
    weights flipped (the row where x peaks, so the fault shows in every
    case): (q, scale) -> faulty (q, scale) of one layer."""
    k = int(x.float().abs().amax(dim=0).argmax())

    def shifted(q, s):
        return q, s.roll(1, dims=-2)

    def neighbour(q, s):
        return q, s.roll(1, dims=-1)

    def sign_flipped(q, s):
        q = q.clone()
        q[..., k, :] ^= -128
        return q, s

    return {"scale rows shifted one group": shifted, "the neighbouring column's scale": neighbour,
            f"sign bit of k-row {k} flipped": sign_flipped}


def planted_k6_faults():
    """K6 handed its weight with the scale rows shifted one group, the two
    nibbles of every byte swapped, or each byte column the neighbouring
    pair's scale: (q, scale) -> faulty (q, scale) of one layer."""
    def shifted(q, s):
        return q, s.roll(1, dims=-2)

    def swapped(q, s):
        from lite_llama_tpu_torch.quant.qtensor import QTensor

        even, odd = QTensor(q, s, packed=True).unpack_halves()
        return (even.to(torch.int16) * 16 + odd + 8).to(torch.int8), s

    def neighbour(q, s):
        return q, s.roll(1, dims=-1)

    return {"scale rows shifted one group": shifted, "nibble halves swapped": swapped,
            "the neighbouring pair's scale": neighbour}


def ptxas_report(name):
    """{entry function: its ptxas lines (registers, spills)} from the build
    log of csrc/<name>.cu."""
    from lite_llama_tpu_torch.ops import _build

    report, fn = {}, None
    log_file = _build.BUILD_DIR / f"{name}.log"
    for line in (log_file.read_text().splitlines() if log_file.exists() else ()):
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and ("registers" in line or "spill" in line):
            report.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return report


def qmm_launch_info(C, nG, Wn, M, packed, fp32):
    """K6 / K7's launch at this shape: split count (and K7's k-warps per
    column), grid, dynamic shared memory (from the built library) and the
    instance's ptxas report."""
    import ctypes

    from lite_llama_tpu_torch.ops import _build
    from lite_llama_tpu_torch.ops import qmatmul as qmm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    F = qmm._fold_span(C, nG)
    MT, rt = qmm._row_tiles(M)
    out = "f" if fp32 else "13__nv_bfloat16"
    if packed:
        S, rows = qmm.plan_splits(C, nG, Wn, M, sms)
        lib = _build.library("qmatmul", "qmm_smem_bytes", [ctypes.c_int] * 3)
        smem = lib.qmm_smem_bytes(MT, F, qmm._held_spans(rows, F))
        grid = [Wn // 32, rt, S]
        # Itanium mangling of qmm_kernel<MT, KSTEP, OutT>
        inst, plan = f"qmm_kernelILi{MT}ELi{qmm._kstep(F)}E{out}E", {}
    else:
        kw, S, rows = qmm.plan_w8a8(C, nG, Wn, M, sms)
        lib = _build.library("qmatmul", "qmm_w8a8_smem_bytes", [ctypes.c_int] * 4)
        smem = lib.qmm_w8a8_smem_bytes(MT, F, kw, qmm._held_spans(rows, F))
        grid = [rt, Wn // 128, S]
        # w8a8_kernel<MT, KSTEP, KW, OutT>
        inst, plan = f"w8a8_kernelILi{MT}ELi{qmm._kstep(F)}ELi{kw}E{out}E", dict(kw=kw)
    ptxas = [v for k, v in ptxas_report("qmatmul").items() if inst in k]
    return dict(splits=S, rows=rows, **plan, grid=grid, smem_bytes=smem,
                ptxas=ptxas[0] if ptxas else "not found")


def qmm_case(name, M, riffle=True, packed=True, timed=True, gs=128):
    """K6 (``packed``) or K7 on the 3B projection ``name`` at M rows: a
    two-layer stack quantized by the port from seeded bf16 weights, layer 1
    read by index. An fp32 output, and any output of K7 (whose bf16 rounds
    the same fp32 product as the plain version's), must equal the plain
    version's bit for bit, and every planted fault must fail the tolerance.
    Timed K7 cases above 16 rows also time ``torch._int_mm`` on the same
    int8 bytes (``int8_library_ms``)."""
    from lite_llama_tpu_torch.ops import qmatmul as qmm
    from lite_llama_tpu_torch.quant.qtensor import quantize

    C, O, fp32 = QMM_SHAPES[name]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    w = torch.randn((2, C, O), generator=g, device=dev).mul_(0.02).bfloat16()
    qt = quantize(w, (1,), "int4" if packed else "int8", group_size=gs,
                  riffle_blocks=1 if packed and riffle else 0)
    del w
    x = torch.randn((M, C), generator=g, device=dev).bfloat16()
    out_dtype = torch.float32 if fp32 else torch.bfloat16
    if packed:
        def kernel(x, q, s):
            return qmm.quantized_matmul_packed(x, q, s, 1, out_dtype, not riffle, O)

        def plain(x, q, s):
            return qmm.quantized_matmul_packed_plain(x, q, s, 1, out_dtype, not riffle, O)
    else:
        def kernel(x, q, s):
            return qmm.quantized_matmul_int8(x, q, s, 1, out_dtype)

        def plain(x, q, s):
            return qmm.quantized_matmul_int8_plain(x, q, s, 1, out_dtype)

    args = (x, qt.q, qt.scale)
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err, ok = max_err(got, want)
    bit_equal = bool(torch.equal(got, want))
    nG = qt.scale.shape[-2] if qt.scale.ndim == 3 else 1
    rec = dict(shape=f"{name} M={M} C={C} O={O} stored={qt.q.shape[-1]} group={gs} "
                     f"{'int4 ' + ('riffle' if riffle else 'classic') if packed else 'int8'} "
                     f"out={str(out_dtype).split('.')[-1]}",
               max_abs_err=err, ok=ok and (bit_equal or (packed and not fp32)),
               bit_equal=bit_equal,
               launch=qmm_launch_info(C, nG, qt.q.shape[-1], M, packed, fp32))
    rec["faults"] = {}
    faults = planted_k6_faults() if packed else planted_k7_faults(x)
    for fname, fault in faults.items():
        if gs is None and "group" in fname:
            continue  # per-channel scales have one group
        fq, fs = fault(qt.q[1:2], qt.scale[1:2])
        if packed:
            bad = qmm.quantized_matmul_packed(x, fq, fs, 0, out_dtype, not riffle, O)
        else:
            bad = qmm.quantized_matmul_int8(x, fq, fs, 0, out_dtype)
        ferr, fok = max_err(bad, want)
        rec["faults"][fname] = dict(max_abs_err=ferr, caught=not fok)
        rec["ok"] = rec["ok"] and not fok
    if not timed:
        return rec
    layer_bytes = qt.q[1].numel() + qt.scale[1].numel() * 4
    bytes_moved = M * C * 2 + layer_bytes + M * O * got.element_size()
    t_bound, by = bound(bytes_moved, 2 * M * C * O, INT8_OPS_PER_S)
    wd = qt.dequant(torch.bfloat16)[1].reshape(C, O)  # the bf16 product it replaces
    t = timings(kernel, plain, args, bytes_moved,
                (lambda x, w: x @ w, (x, wd), M * C * 2 + C * O * 2 + M * O * 2),
                plain_in_graph=False)
    del wd
    if packed and rec["launch"]["splits"] > 1:  # the split rule's evidence: every allowed S
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        copies = input_copies(args, bytes_moved)
        rec["ms_by_splits"] = {
            S: graph_ms(lambda x, q, s, S=S: qmm.launch_quantized_matmul_packed(
                x, q, s, 1, out_dtype, not riffle, O, _splits=S), copies)
            for S in qmm.allowed_splits(C, nG, qt.q.shape[-1], M, sms)}
        del copies
    if not packed and M > 16:  # torch._int_mm takes more than 16 rows
        xi = qmm.quantize_activations(x, 1)[0]
        t["int8_library_ms"] = graph_ms(torch._int_mm, input_copies(
            (xi, qt.q[1]), M * C + C * O + M * O * 4))
        t["int8_library"] = "torch._int_mm on the quantized rows and int8 weight (int32 out)"
    return dict(rec, model="llama-3.2-3b", **t, bound_ms=t_bound, bound_by=by,
                library="torch.matmul in bf16 on the dequantized weight (cuBLAS; the "
                        "bf16 product the quantization replaces)")


def kernel_phase():
    """Returns {kernel: [cases]}; the first case of each is the main path's
    own shape (Llama-3.2-3B decode step, its 12 x 25-token prefill, or the
    serving phase's middle chunk of eight 1500-token prompts for K5; for K8
    OpenLLaMA-3B's 12 x 25-token prefill). The head-dim-100 cases of K1,
    K1q, K5 and K5q follow the head-dim-128 and -64 cases of each. K3's
    case ``NORM_NO_RESIDUAL`` is its no-residual form at Qwen3-4B's q-norm
    shape (12 rows x 32 heads, width 128), reported on its own. K1 and K1q
    also run at serving's width (64 slots: 8 of 1,820 tokens, 56 empty)."""
    ragged = [0, 1, 15, 16, 17, 100, 255, 256, 511, 1000, 1537, 2048]  # B=12
    serving = [1820] * 8 + [0] * 56  # phase 5's wave 1 at decode, all 64 slots
    cases = {
        "paged_flash_decode": [
            decode_case("llama-3.2-3b", [88] * 12),
            decode_case("llama-3.2-3b", ragged),
            decode_case("llama-3.2-1b", ragged),
            decode_case("open-llama-3b-v2", [88] * 12),  # D=100: the padded instances
            decode_case("open-llama-3b-v2", ragged),
            decode_case("llama-3.2-3b", serving),
        ],
        "flash_prefill": [
            prefill_case("llama-3.2-3b", 12, 25, [25] * 12),
            *(prefill_case(model, 4, S, [S, 3 * S // 4 + 5, 37, 1])
              for model in ("llama-3.2-3b", "llama-3.2-1b") for S in (128, 512)),
            # the engine's default prefill_chunk: a 2048-token prompt batch
            prefill_case("llama-3.2-3b", 4, 2048, [2048, 1541, 37, 1]),
            # D=64 with five kv heads: the TPU's K8 case, K2 in the port
            prefill_case("smollm2-360m", 4, 512, [512, 389, 37, 1]),
        ],
        "flash_prefill_vmem": [  # K8: OpenLLaMA-3B's batch shape first
            prefill_case("open-llama-3b-v2", 12, 25, [25] * 12),
            prefill_case("open-llama-3b-v2", 4, 1024, [1024, 773, 37, 1]),
            prefill_case("D=80 G=4", 4, 512, [512, 389, 37, 1]),
            prefill_case("D=96 G=4", 4, 512, [512, 389, 37, 1]),
        ],
        "rms_norm": [
            norm_case(12, 3072, True, fault=True),
            norm_case(300, 3072, True),
            norm_case(300, 3072, False),
            norm_case(12 * 32, 128, False),  # NORM_NO_RESIDUAL: Qwen3-4B q-norm rows
            norm_case(300 * 32, 128, True),
            norm_case(4096, 3072, True),  # serving's chunk step, 8 x 512 rows
            norm_case(8192, 3072, True),  # a 4 x 2048 prefill
            norm_case(12, 8192, True),  # a width the Triton K3 refused
            norm_case(12, 3072, True, int8=True),  # phase 6's decode step
            norm_case(64, 3072, True, int8=True),  # phase 6's serving width
        ],
        "swiglu": [swiglu_case(12, 8192), swiglu_case(300, 8192), swiglu_case(4096, 8192),
                   swiglu_case(8192, 8192), swiglu_case(12, 8192, int8=True),
                   swiglu_case(64, 8192, int8=True)],
        "flash_prefill_chunked": [
            chunked_case("llama-3.2-3b", [512] * 8, [512] * 8),
            chunked_case("llama-3.2-3b", [256] * 16, [8] * 16, S=8),  # phase 5's wave 2
            *(chunked_case(model, [0, 16, 500, 1536], [512, 300, 0, 512], return_state=rs)
              for model in ("llama-3.2-3b", "llama-3.2-1b") for rs in (False, True)),
            chunked_case("open-llama-3b-v2", [512] * 8, [512] * 8),
            chunked_case("open-llama-3b-v2", [0, 16, 500, 1536], [512, 300, 0, 512],
                         return_state=True),
        ],
        "quantized_matmul_packed": [
            *(qmm_case(n, 12) for n in QMM_SHAPES),  # gate_up first: the main case
            qmm_case("gate_up", 64),
            *(qmm_case(n, 64, timed=False) for n in QMM_SHAPES if n != "gate_up"),
            *(qmm_case(n, M, riffle=False, timed=False) for n in QMM_SHAPES for M in (12, 64)),
            qmm_case("down", 12, gs=None, timed=False),  # per-channel scales
            qmm_case("down", 12, gs=16, timed=False),  # m16n8k16 steps
            qmm_case("down", 12, gs=8, timed=False),  # half-masked m16n8k16 passes
        ],
        "quantized_matmul_int8": [
            *(qmm_case(n, 12, packed=False) for n in QMM_SHAPES),  # gate_up first: the main case
            qmm_case("gate_up", 64, packed=False),
            qmm_case("gate_up", 256, packed=False),  # large M: the int8 operations near the bytes
            *(qmm_case(n, 64, packed=False, timed=False) for n in QMM_SHAPES if n != "gate_up"),
            qmm_case("down", 12, packed=False, gs=None, timed=False),  # per-channel scales
            qmm_case("down", 12, packed=False, gs=16, timed=False),  # m16n8k16 steps
            qmm_case("down", 12, packed=False, gs=8, timed=False),  # half-masked k16 passes
            qmm_case("o_proj", 12, packed=False, gs=48, timed=False),
        ],
    }
    for kv in ("int8", "fp8"):
        cases[f"paged_flash_decode_{kv}"] = [
            decode_case("llama-3.2-3b", [88] * 12, kv=kv),
            decode_case("llama-3.2-1b", ragged, kv=kv),
            decode_case("open-llama-3b-v2", [88] * 12, kv=kv),
            decode_case("llama-3.2-3b", serving, kv=kv),
        ]
        cases[f"flash_prefill_chunked_{kv}"] = [
            chunked_case("llama-3.2-3b", [512] * 8, [512] * 8, kv=kv),
            chunked_case("llama-3.2-3b", [256] * 16, [8] * 16, S=8, kv=kv),
            chunked_case("llama-3.2-1b", [0, 16, 500, 1536], [512, 300, 0, 512],
                         return_state=True, kv=kv),
            chunked_case("open-llama-3b-v2", [512] * 8, [512] * 8, kv=kv),
        ]
    for name, cs in cases.items():
        for c in cs:
            if c.get("ran", name) != name:
                c["ok"] = False  # the router sent the case to another kernel
            line = f"  {name:18s} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} ok={c['ok']}"
            if "ms" in c:
                lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.5f}"
                line += (f" ms={c['ms']:.5f} l2_warm_ms={c['l2_warm_ms']:.5f} "
                         f"eager_ms={c['eager_ms']:.5f} plain_ms={c['plain_ms']:.5f} "
                         f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']}) library_ms={lib} "
                         f"copies={c['copies']}")
            if "tflops" in c:
                line += f" TFLOP/s={c['tflops']:.1f} library_TFLOP/s={c['library_tflops']:.1f}"
            if "library_kernels" in c:
                line += f" library_kernels={c['library_kernels']}"
            for k in (k for k in c if k.endswith("bit_equal")):
                line += f" {k}={c[k]}"
            if "faults" in c:
                line += f" faults={json.dumps(c['faults'])}"
            if "launch" in c:
                line += f" launch={json.dumps(c['launch'])}"
            if "ms_by_splits" in c:
                line += f" ms_by_splits={json.dumps(c['ms_by_splits'])}"
            if "int8_library_ms" in c:
                line += f" int8_library_ms={c['int8_library_ms']:.5f}"
            log(line)
    bad = [(n, c["shape"]) for n, cs in cases.items() for c in cs if not c["ok"]]
    require(not bad, f"kernels disagree with their plain versions beyond tolerance: {bad}")
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the slice


def read_counts():
    """{name: launches} of every kernel of KERNELS, and beside them K3 /
    K4's launches that also wrote K6's int8 rows and the launches of K6's
    own activation quantizer. A replayed decode graph adds the launches of
    its kernels at each replay (``DecodeStep.run``); its capture adds none."""
    from lite_llama_tpu_torch.ops import launch_counts

    return launch_counts()


def reset_counts():
    from lite_llama_tpu_torch.ops import launch_counters

    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def plain_ops():
    """The decoder's kernel ops replaced by their plain versions (ops/ref.py,
    and K6's in ops/qmatmul.py), patched in by this script only: the
    invariants' reading when no kernel runs, the floor their limits sit
    above."""
    from lite_llama_tpu_torch.ops import norms, qmatmul, ref

    def decode(q, pool, layer, table, seq_lens, sm_scale=None, k_new=None, v_new=None):
        return ref.paged_decode_attention(q, pool, layer, table, seq_lens, sm_scale=sm_scale,
                                          k_new=k_new, v_new=v_new)

    return dict(prefill_attention=ref.prefill_attention, paged_decode_attention=decode,
                chunked_prefill_attention=ref.chunked_prefill_attention,
                rms_norm=ref.rms_norm, skip_rms_norm=norms.skip_rms_norm_plain,
                swiglu=norms.swiglu_plain,
                quantized_matmul_packed=qmatmul.quantized_matmul_packed_plain)


@contextlib.contextmanager
def patched(patch):
    """Replace ops of ``lite_llama_tpu_torch.ops`` (and the W4A8 matmul that
    ``quant/qtensor.py`` routes to) for the duration; ``None`` patches
    nothing. A decode graph captured before the patch keeps the kernels it
    captured: patched readings run eager code only (``_decode_vs_reprefill``,
    prefills)."""
    from unittest import mock

    from lite_llama_tpu_torch import ops
    from lite_llama_tpu_torch.quant import qtensor

    patch = dict(patch or {})
    qmm = {k: patch.pop(k) for k in ("quantized_matmul_packed",) if k in patch}
    with contextlib.ExitStack() as stack:
        if patch:
            stack.enter_context(mock.patch.multiple(ops, **patch))
        if qmm:
            stack.enter_context(mock.patch.multiple(qtensor, **qmm))
        yield


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


def decode_vs_reprefill(dev, cfg, params, prompts, generated, patch=None, kv_quant=False):
    """The repository's key invariant at full size: decode the engine's
    greedy tokens through the paged cache (K1, or K1q on a ``kv_quant``
    pool, on every layer), then re-prefill prompt + generated tokens in a
    fresh cache (K2); the last-position logits agree. ``patch`` replaces
    kernel ops for the whole reading (see ``patched``)."""
    with patched(patch):
        return _decode_vs_reprefill(dev, cfg, params, prompts, generated, kv_quant)


def invariant_holds(inv, limits=(INVARIANT_REL_RMS, INVARIANT_MAX_ABS), top1=True,
                    reprefill_ties=False):
    """The limits on the logit difference and (``top1``) the greedy tokens.

    Decode's argmax equals the engine's token, but at a tie: the engine
    chose its tokens in a batch of all the prompts and the rest of the model
    is not batch-invariant, so where the two part, decode's logit at the
    engine's token lies within twice the measured max-abs difference of its
    top logit (``engine_margin``). Decode's argmax equals re-prefill's;
    with ``reprefill_ties`` (the plain reading) they may part where
    re-prefill's logits at the two lie within twice the measured difference
    (``reprefill_margin``), which is all that a parting under that
    difference can leave, so there the clause is the max-abs limit's own."""
    rel_rms, max_abs = limits
    if not (inv["rel_rms_diff"] <= rel_rms
            and inv["max_abs_diff"] <= max_abs * inv["max_abs_logit"]):
        return False
    if not top1:
        return True
    tie = 2 * inv["max_abs_diff"]
    return all(
        (d == e or em <= tie) and (d == r or (reprefill_ties and rm <= tie))
        for d, e, r, em, rm in zip(inv["top1_decode"], inv["engine_tokens"],
                                   inv["top1_reprefill"], inv["engine_margin"],
                                   inv["reprefill_margin"]))


def fresh_cache(dev, cfg, B, kv_quant=False, num_pages=64):
    from lite_llama_tpu_torch.executor import kv_cache as kvc

    return kvc.create_kv_cache(cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
                               num_pages=num_pages, page_size=16, max_reqs=B,
                               max_seq_len=cfg.max_seq_len, dtype=cfg.dtype, device=dev,
                               quantized=kv_quant)


def prefill_last_logits(dev, cfg, params, cache, rows):
    """Last-position logits of ``rows`` prefilled together into slots 0..B-1
    of ``cache`` (one decoder_prefill call, no engine)."""
    from lite_llama_tpu_torch.executor import kv_cache as kvc
    from lite_llama_tpu_torch.models.decoder import AttnContext, decoder_prefill

    B = len(rows)
    n = torch.tensor([len(r) for r in rows], dtype=torch.int32, device=dev)
    ids = torch.tensor(rows, dtype=torch.long, device=dev)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    kvc.alloc_prefill(cache, slots, n)
    ctx = AttnContext(cache.page_table[slots.long()], n, torch.zeros_like(n), n)
    return decoder_prefill(params, cfg, cache.kv_pages, ctx, ids, last_only=True)[0]


def _decode_vs_reprefill(dev, cfg, params, prompts, generated, kv_quant=False):
    # decoder_decode is called here directly, step by step and eagerly, never
    # through the engine's captured decode graph: a patch of ``ops`` (the
    # plain versions, the planted faults) would not reach a graph captured
    # before it, and here it reaches every call.
    from lite_llama_tpu_torch.executor import kv_cache as kvc
    from lite_llama_tpu_torch.models.decoder import AttnContext, decoder_decode

    B = len(prompts)
    n_steps = min(len(g) for g in generated) - 1
    with torch.inference_mode():
        cache = fresh_cache(dev, cfg, B, kv_quant)
        logits = prefill_last_logits(dev, cfg, params, cache, [list(p) for p in prompts])
        slots = torch.arange(B, dtype=torch.int32, device=dev)
        for step in range(n_steps):
            tok = torch.tensor([g[step] for g in generated], dtype=torch.long, device=dev)
            kvc.alloc_decode(cache, slots)
            sl = cache.seq_lens[slots.long()]
            ctx = AttnContext(cache.page_table[slots.long()], sl, sl - 1, torch.ones_like(sl))
            logits = decoder_decode(params, cfg, cache.kv_pages, ctx, tok)[0]
        want = prefill_last_logits(dev, cfg, params, fresh_cache(dev, cfg, B, kv_quant),
                                   [list(p) + list(g[:n_steps]) for p, g in zip(prompts, generated)])
    d = logits - want
    top1 = logits.argmax(-1)
    engine = torch.tensor([g[n_steps] for g in generated], device=dev)
    return dict(
        steps=n_steps, max_abs_diff=float(d.abs().max()),
        max_abs_logit=float(want.abs().max()),
        rel_rms_diff=float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
        top1_decode=top1.tolist(), top1_reprefill=want.argmax(-1).tolist(),
        # re-prefill's top logit minus its logit at decode's argmax (0 where they agree)
        reprefill_margin=(want.max(-1).values - want.gather(-1, top1[:, None])[:, 0]).tolist(),
        engine_tokens=engine.tolist(),
        # decode's top logit minus its logit at the engine's token (0 where they agree)
        engine_margin=(logits.max(-1).values - logits.gather(-1, engine[:, None])[:, 0]).tolist(),
    )


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_decode(engine, prompts, steps=16):
    """torch.profiler over ``steps`` greedy decode steps after a prefill
    (replays of the engine's captured step): device busy share of the wall
    time, device time by kernel name, and device time and launches per step
    of each kernel of DEVICE_KERNELS. Kernel rows are the profiler's
    device-side events; "not measured" (None) when the profiler records no
    device time. Where it does, the launch counters' per-step reading of
    each DEVICE_KERNELS kernel must equal its device events'."""
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
        c0 = read_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.decode(slots, first, np.zeros(B, bool), total, sampling, n_steps=steps)
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        c1 = read_counts()
    finally:
        engine.release_slots(slots, total)
    # Device-side rows only: a CPU op's row repeats its kernels' device time.
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:12]
    per_step = {}
    for name, pattern in DEVICE_KERNELS.items():
        mine = [(us, n) for k, us, n in rows if re.search(pattern, k)]
        us = sum(u for u, _ in mine)
        per_step[f"{name}_device_ms_per_step"] = us / 1e3 / steps if us else None
        per_step[f"{name}_launches_per_step"] = sum(n for _, n in mine) / steps
    counted = {k: (c1[k] - c0[k]) / steps for k in DEVICE_KERNELS}
    if device_us:
        seen = {k: per_step[f"{k}_launches_per_step"] for k in DEVICE_KERNELS}
        require(counted == seen, f"launch counters per decode step {counted} differ from "
                                 f"the device events' {seen}")
    return dict(
        counted_launches_per_step=counted,
        steps=steps, profiled_wall_ms=wall_us / 1e3,
        device_ms=device_us / 1e3 if device_us else None,
        device_ms_per_step=device_us / 1e3 / steps if device_us else None,
        **per_step,
        device_busy_share_profiled=device_us / wall_us if device_us else None,
        top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n) for k, us, n in top],
    )


def batch_prompts(cfg, B=12, P=25):
    """The batch slice's prompts, random ids from the seed."""
    return np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, P)).tolist()


def graph_gate(engine, prompts, steps=75):
    """The graph-vs-eager gate. One admitted batch decodes ``steps`` greedy
    steps (whole chunks and a short one) through the replayed graph and
    through the same step run eagerly (``eager_step``), each from the state
    the prefill left: the allocator, table and lengths are a clone restored
    in place before each run (the KV rows past the prompts need none: each
    step writes its row before any step reads it). Tokens and logprobs must
    be bit-equal. A planted fault must break that: a replay whose session
    tokens were never copied in, its buffers holding those of a run with the
    batch's rows rolled."""
    from unittest import mock

    from lite_llama_tpu_torch.generation.sampling import SamplingParams
    from tests.torch_decode_steps import eager_step

    B = len(prompts)
    total = [len(p) + steps + 1 for p in prompts]
    sampling = SamplingParams.make(B, temperature=0.0, device=engine.device)
    c = engine.cache
    state = (c.page_table, c.seq_lens, c.free_stack, c.free_top)
    slots = engine.admit_requests(total)
    try:
        first, _, _, _ = engine.prefill(prompts, sampling, slots)
        saved = [t.clone() for t in state]

        def decode(tok, n_steps=steps):
            for t, v in zip(state, saved):
                t.copy_(v)
            s = engine.start_decode_session(slots, tok, np.zeros(B, bool), total, sampling)
            toks, lps, left = [], [], n_steps
            while left:
                n = min(left, engine.decode_chunk)
                t, lp, _ = engine.collect_decode_chunk(engine.dispatch_decode_chunk(s, n))
                toks.append(t)
                lps.append(lp.view(np.int32))
                left -= n
            return np.concatenate(toks), np.concatenate(lps)

        t0 = time.perf_counter()
        graph = decode(first)
        graph_s = time.perf_counter() - t0
        with eager_step(engine, B):
            t0 = time.perf_counter()
            eager = decode(first)
            eager_s = time.perf_counter() - t0
        step = engine._steps[(B, "greedy")]
        decode(np.roll(first, 1), engine.decode_chunk)
        load = step.load

        def stale(s):  # the fault: every buffer but the tokens is loaded
            load(dataclasses.replace(s, tok=step.tok.clone()))

        with mock.patch.object(step, "load", stale):
            fault = decode(first)
    finally:
        engine.release_slots(slots, total)

    def same(a, b):
        return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))

    rec = dict(batch=B, steps=steps, chunk=engine.decode_chunk, bit_equal=same(graph, eager),
               tokens_differing=int((graph[0] != eager[0]).sum()),
               logprobs_differing=int((graph[1] != eager[1]).sum()),
               planted_fault_caught=not same(fault, graph),
               fault_tokens_differing=int((fault[0] != graph[0]).sum()),
               graph_ms_per_step=graph_s * 1e3 / steps, eager_ms_per_step=eager_s * 1e3 / steps)
    log(f"  graph-vs-eager gate: {json.dumps(rec)}")
    require(rec["bit_equal"], f"replayed decode differs from the eager step: {rec}")
    require(rec["planted_fault_caught"], f"the graph gate misses a stale-token replay: {rec}")
    return rec


def replay_costs(engine, width, n=16):
    """Where a replayed step's time goes: the host's time to enqueue one
    replay (n replays with no wait), and the device's time for one, from
    CUDA events around n replays that the host enqueued while the device
    slept (so no host gap is timed). The step runs with every row done, so
    the replays change no cache state; K1 then reads the rows its buffers
    last named."""
    step = engine._steps[(width, "greedy")]
    dev = engine.device
    n = min(n, engine.decode_chunk)  # the step counter indexes [decode_chunk, B] rows
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():  # the engine's buffers are inference tensors
        step.done.fill_(True)
        step.step.zero_()
        sync(dev)
        t0 = time.perf_counter()
        step.run(n)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / n
        sync(dev)
        step.step.zero_()
        torch.cuda._sleep(int(2e8 + 2e6 * n * enqueue_ms))  # cycles: longer than the enqueue
        start.record()
        step.run(n)
        end.record()
        sync(dev)
    return dict(enqueue_ms_per_replay=enqueue_ms, device_ms_per_replay=start.elapsed_time(end) / n)


def timed_decode(engine, prompts, sampling, max_total, G):
    """Prefill ``prompts`` and decode up to G - 1 greedy steps through the
    engine's API, each timed to a synchronize; returns (prefill ms, decode
    ms per step, steps, launch counts before the prefill, after it)."""
    dev = engine.device
    slots = engine.admit_requests(max_total)
    try:
        c0 = read_counts()
        sync(dev)
        t0 = time.perf_counter()
        first, _, _, _ = engine.prefill(prompts, sampling, slots)
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        c1 = read_counts()
        t0 = time.perf_counter()
        _, _, toks, _ = engine.decode(slots, first, np.zeros(len(prompts), bool), max_total,
                                      sampling, n_steps=G - 1)
        sync(dev)
        steps = toks.shape[0]
        decode_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    finally:
        engine.release_slots(slots, max_total)
    return prefill_ms, decode_ms, steps, c0, c1


def slice_phase(dev, cfg, params, B=12, P=25, G=128, engine_kw=None, path=BATCH_PATH,
                invariant=None, absent=(), repeats=(GEN_REPEATS, SPLIT_REPEATS, EAGER_REPEATS)):
    """Llama-3.2-3B (or another ``cfg``, ``params``) through InferenceEngine +
    TextGenerator on ``dev``: B prompts of P random ids, greedy,
    max_gen_len G. ``engine_kw`` goes to the engine (a quantized pool),
    ``path`` names the kernels that must launch and ``absent`` those that
    must not, ``invariant(prompts, outputs)`` reads the decode invariant
    (default: bf16 decode vs re-prefill with faults in K1's inputs);
    ``repeats`` counts the timed generate_tokens runs, the prefill + decode
    runs and the runs of the same decode with the step eager.

    The warm-up, at the batch's width, captures its decode graph (timed
    apart, ``capture_ms``), so no timed run holds the capture. The counted
    generate_tokens run holds the prefill's launches and each replay's;
    launches per decode step come from the device events of a profiled
    decode (which the counters must equal), and every decode kernel of
    ``path`` must be among them."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.generate import TextGenerator
    from lite_llama_tpu_torch.generation.sampling import SamplingParams
    from tests.torch_decode_steps import eager_step

    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, params, device=dev, **(engine_kw or {}))
    sync(dev)
    setup_s = time.perf_counter() - t0
    gen = TextGenerator(engine)
    prompts = batch_prompts(cfg, B, P)
    gen.generate_tokens(prompts, max_gen_len=4, temperature=0.0)  # warm-up: the capture
    capture_ms = {f"{w} {m}": st.capture_ms for (w, m), st in engine._steps.items()}

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
    log(f"  generate_tokens: {sum(len(o.token_ids) for o in outs)} tokens in {gen_s[0]:.3f} s "
        f"(the decode graph captured before it: {capture_ms} ms); launches {launches}")
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"kernels never launched on the batch path: {missing}")
    stray = [k for k in absent if launches[k] != 0]
    require(not stray, f"kernels launched that this path must not run: {stray}")
    for o in outs:
        require(1 <= len(o.token_ids) <= G, "output length out of range")
        require(all(0 <= t < cfg.vocab_size for t in o.token_ids), "token id out of range")
        require(all(math.isfinite(v) for v in o.logprobs), "non-finite logprob")
    n_tokens = sum(len(o.token_ids) for o in outs)
    for _ in range(repeats[0] - 1):  # the host's share varies: repeat, report the median
        t0 = time.perf_counter()
        again = gen.generate_tokens(prompts, max_gen_len=G, temperature=0.0)
        sync(dev)
        gen_s.append(time.perf_counter() - t0)
        require([o.token_ids for o in again] == [o.token_ids for o in outs],
                "greedy generation is not repeatable")

    # Prefill and decode timed apart through the engine's own API, repeated;
    # the launch counts per prefill come from the first. Then the same
    # decode with the step run eagerly, for the graph's gain in this call.
    sampling = SamplingParams.make(B, temperature=0.0, device=dev)
    max_total = [P + G] * B
    prefill_ms, decode_ms, eager_ms = [], [], []
    for rep in range(repeats[1]):
        p_ms, d_ms, steps, c0, c1 = timed_decode(engine, prompts, sampling, max_total, G)
        prefill_ms.append(p_ms)
        decode_ms.append(d_ms)
        if rep == 0:
            per_prefill = {k: c1[k] - c0[k] for k in c0}
    with eager_step(engine, B):
        for _ in range(repeats[2]):
            eager_ms.append(timed_decode(engine, prompts, sampling, max_total, G)[1])
    decode_ms_per_step = float(np.median(decode_ms))
    # generate_tokens is one prefill and G - 1 decode steps: its own step time
    implied_ms = [(s * 1e3 - float(np.median(prefill_ms))) / (G - 1) for s in gen_s]
    log(f"  generate_tokens s {gen_s}; prefill ms {prefill_ms}; decode ms/step {decode_ms}, "
        f"eager step {eager_ms}; decode ms/step implied by generate_tokens {implied_ms}")

    prof = profile_decode(engine, prompts)
    log(f"  profile of {prof['steps']} decode steps: {json.dumps(prof)}")
    per_step = {k: prof[f"{k}_launches_per_step"] for k in DEVICE_KERNELS}
    for name in DEVICE_KERNELS:
        ms = prof[f"{name}_device_ms_per_step"]
        if ms is not None:
            log(f"  {name} device ms per decode step ({prof['steps']} steps profiled): "
                f"{ms:.4f} of {prof['device_ms_per_step']:.4f}, {per_step[name]:.2f} launches")
    if prof["device_ms"] is not None:  # against the decode steps timed without the profiler
        prof["device_busy_share"] = prof["device_ms"] / prof["steps"] / decode_ms_per_step
    unseen = [k for k in path if k in DEVICE_KERNELS and not per_step[k]]
    require(not unseen, f"decode kernels absent from the replayed steps' device events: {unseen}")

    replay = replay_costs(engine, B)
    log(f"  one replayed step: {json.dumps(replay)}")
    gate = graph_gate(engine, prompts)
    if invariant is None:
        inv = check_invariant(dev, cfg, params, prompts[:2], [o.token_ids for o in outs[:2]])
    else:
        inv = invariant(prompts, outs)
    return dict(
        model=f"{cfg.model_type} H={cfg.hidden_size} L={cfg.num_hidden_layers} "
              f"(random {str(cfg.dtype).split('.')[-1]} weights, seed {SEED})", batch=B, prompt_len=P,
        max_gen_len=G, tokens=n_tokens, generate_s=gen_s,
        tokens_per_s=n_tokens / float(np.median(gen_s)),
        tokens_per_s_runs=[n_tokens / s for s in gen_s],
        prefill_ms=float(np.median(prefill_ms)), prefill_ms_runs=prefill_ms,
        decode_ms_per_step=decode_ms_per_step, decode_ms_per_step_runs=decode_ms,
        eager_decode_ms_per_step=float(np.median(eager_ms)),
        eager_decode_ms_per_step_runs=eager_ms,
        generate_implied_decode_ms_per_step=implied_ms,
        decode_steps=steps, peak_mem_gb=peak_gb, capture_ms=capture_ms, replay=replay,
        setup_s=setup_s,
        launches=launches, launches_per_prefill=per_prefill, launches_per_decode_step=per_step,
        graph_gate=gate, decode_vs_reprefill=inv, decode_profile=prof,
    ), launches


def check_invariant(dev, cfg, params, prompts, generated, kv_quant=False, faults=None,
                    limits=(INVARIANT_REL_RMS, INVARIANT_MAX_ABS), top1=True):
    """Decode vs re-prefill through the kernels, through the plain versions,
    and with each planted fault (default: in K1's inputs). The kernels must
    hold the limit; every planted fault must break it."""
    def holds(r):
        return invariant_holds(r, limits, top1)

    inv = decode_vs_reprefill(dev, cfg, params, prompts, generated, kv_quant=kv_quant)
    log(f"  decode vs re-prefill, kernels: {inv}")
    inv["plain"] = decode_vs_reprefill(dev, cfg, params, prompts, generated, plain_ops(),
                                       kv_quant)
    log(f"  decode vs re-prefill, plain versions: {inv['plain']}")
    inv["faults"] = {}
    for name, fault in (faults or planted_faults()).items():
        inv["faults"][name] = r = decode_vs_reprefill(
            dev, cfg, params, prompts, generated, dict(paged_decode_attention=fault), kv_quant)
        log(f"  decode vs re-prefill, planted fault ({name}): {r}")
    inv["limit"] = dict(rel_rms=limits[0], max_abs_of_max_logit=limits[1])
    require(holds(inv), f"decode and re-prefill disagree: {inv}")
    require(invariant_holds(inv["plain"], limits, top1, reprefill_ties=True),
            f"plain decode and re-prefill disagree: {inv}")
    caught = {n: not holds(r) for n, r in inv["faults"].items()}
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


def serving_phase(dev, cfg, params, engine_kw=None, path=SERVING_PATH,
                  chunk_kernel="flash_prefill_chunked", profile=True, n_waves=2):
    """Llama-3.2-3B through ServingFrontend -> ContinuousBatchingScheduler
    -> engine sessions, with the prefix cache on. Wave 1: eight prompts of
    1500 random ids (three K5 chunks each at prefill_chunk 512) and one
    prompt of a 256-token shared prefix plus 8 tokens, whose 16 full pages
    (the prefix exactly) are registered when it finishes. Wave 2, after
    wave 1: sixteen prompts of the same prefix plus their own 48 tokens,
    each a prefix hit (K5 over 256 cached tokens); twelve greedy, four
    sampled (T 0.6, top_p 0.9). ``engine_kw`` goes to the engine,
    ``path`` names the kernels that must launch and ``chunk_kernel`` the
    chunked-prefill instance every wave must launch; ``profile`` runs each
    wave again under the profiler (wave 1's repeat finds its prompts' full
    pages in the prefix cache, so its chunk steps are prefix hits);
    ``n_waves=1`` runs wave 1 only (no prefix hit is then required)."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.executor.scheduler import ContinuousBatchingScheduler
    from lite_llama_tpu_torch.server import ServingFrontend
    from lite_llama_tpu_torch.utils.profiling import steady_state_tps

    engine = InferenceEngine(cfg, params, device=dev, prefix_cache=True, prefill_chunk=512,
                             page_size=16, max_reqs=64, decode_chunk=32, **(engine_kw or {}))
    prompts = serving_prompts(cfg)
    waves = [
        [dict(tokens=p, temperature=0.0) for p in prompts["long"]]
        + [dict(tokens=prompts["prefix"] + prompts["tail"], temperature=0.0)],
        [dict(tokens=prompts["prefix"] + s, temperature=0.0 if i < 12 else 0.6)
         for i, s in enumerate(prompts["suffixes"])],
    ][:n_waves]
    fe = ServingFrontend(ContinuousBatchingScheduler(engine))
    # The full-width session's decode graphs (greedy, and sampled where a
    # wave has sampled requests) are captured before the timed waves, as a
    # server captures before it takes traffic; the path's launch counts run
    # from before the captures (their eager warm-ups count, the captures
    # do not) to the end of the last wave.
    modes = ["greedy"] + (["approx"] if any(r["temperature"] > 0 for wv in waves for r in wv)
                          else [])
    reset_counts()
    capture_ms = {m: engine.decode_step_for(engine.max_reqs, m).capture_ms for m in modes}
    log(f"  decode graphs of width {engine.max_reqs} captured: {capture_ms} ms")
    out = []
    try:
        for w, reqs in enumerate(waves, 1):
            c0 = read_counts()
            hits0 = engine.stats.prefix_hits
            log0 = len(fe.sched.chunk_log)
            sync(dev)
            results, wall = run_wave(fe, reqs)
            sync(dev)
            c1 = read_counts()
            counts = {k: c1[k] - c0[k] for k in c1}
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
            require(counts[chunk_kernel] > 0, f"wave {w}: {chunk_kernel} never launched")
            out.append(rec)
        launches = read_counts()
        profiles = {}
        for w, reqs in enumerate(waves if profile else (), 1):
            profiles[f"wave{w}_profile"] = prof = profile_wave(fe, reqs)
            log(f"  serving wave {w} again, profiled: {json.dumps(prof)}")
            require(prof["paged_decode"]["launches"] > 0,
                    f"wave {w}: K1 absent from the replayed steps' device events")
    finally:
        fe.shutdown()
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"kernels never launched on the serving path: {missing}")
    if n_waves > 1:
        require(engine.stats.prefix_hits >= 16,
                f"prefix hits {engine.stats.prefix_hits} < 16 in the serving phase")
    return dict(waves=out, capture_ms=capture_ms, **profiles, prefix_hits=engine.stats.prefix_hits,
                prefill_tokens=engine.stats.prefill_tokens,
                decode_tokens=engine.stats.decode_tokens, chunks=engine.stats.chunks), launches


def profile_wave(fe, reqs):
    """One wave under torch.profiler: the device's busy share of the wave's
    wall time and device time by kernel name (device-side events of the
    whole process, the serving thread's included). "not measured" (None)
    when the profiler records no device time; ``chunked_prefill`` sums the
    rows of K5 / K5q (device ms and launches), ``paged_decode`` those of K1
    / K1q (in the replayed decode steps). Launch counts of this run are not
    part of any wave's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_wave(fe, reqs)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[1])[:12]
    chunked = [(us, n) for k, us, n in rows if "chunked_prefill_kernel" in k]
    decode = [(us, n) for k, us, n in rows if "paged_decode_kernel" in k]
    return dict(wall_s=wall, device_ms=device_us / 1e3 if device_us else None,
                device_busy_share=device_us / 1e6 / wall if device_us else None,
                chunked_prefill=dict(ms=sum(us for us, _ in chunked) / 1e3,
                                     launches=sum(n for _, n in chunked)),
                paged_decode=dict(ms=sum(us for us, _ in decode) / 1e3,
                                  launches=sum(n for _, n in decode)),
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


def prefill_holds(r, limits=(PREFILL_REL_RMS, PREFILL_MAX_ABS)):
    return (r["rel_rms_diff"] <= limits[0]
            and r["max_abs_diff"] <= limits[1] * r["max_abs_logit"])


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


def prefill_invariants(dev, cfg, params, engine_kw=None,
                       limits=(PREFILL_REL_RMS, PREFILL_MAX_ABS), sides=("a", "b")):
    """(a) the last logits of the 1500-token prompts chunked through K5
    (prefill_chunk 512) against one single-shot K2 (or K8) prefill; (b) the
    first logits of prefix-hit prefills (K5 over 256 cached tokens) against
    the same prompts with the prefix cache off. Each read through the
    kernels, through the plain versions patched in, and with faults planted
    in K5's inputs; the kernels must hold the limit, every fault must break
    it. ``engine_kw`` goes to every engine (a quantized pool); ``sides``
    picks the invariants read."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine

    p = serving_prompts(cfg)
    longs = p["long"]
    hit = [p["prefix"] + p["suffixes"][0], p["prefix2"] + p["suffixes"][1]]
    warm = [p["prefix"] + p["tail"], p["prefix2"] + p["tail"]]

    def engine(**kw):  # explicit small pools: these engines hold a few prompts
        return InferenceEngine(cfg, params, device=dev, page_size=16, max_reqs=8,
                               num_pages=8 * 100, decode_chunk=32, **kw, **(engine_kw or {}))

    def read(patch):
        r = {}
        with patched(patch):
            if "a" in sides:
                chunked, _ = _last_logits(engine(prefill_chunk=512), longs)
                single, _ = _last_logits(engine(prefill_chunk=2048), longs)
                r["a"] = compare_logits(chunked, single)
            if "b" in sides:
                cached, hits = _last_logits(engine(prefill_chunk=512, prefix_cache=True), hit,
                                            prefix_prompts=warm)
                uncached, _ = _last_logits(engine(prefill_chunk=512), hit)
                require(hits == len(hit), f"prefix-hit reading hit {hits} of {len(hit)} prompts")
                r["b"] = compare_logits(cached, uncached)
        return r

    inv = {"kernels": read(None), "plain": read(plain_ops())}
    inv["faults"] = {name: read(dict(chunked_prefill_attention=f))
                     for name, f in planted_k5_faults().items()}
    inv["limit"] = dict(rel_rms=limits[0], max_abs_of_max_logit=limits[1])
    for name, r in [("kernels", inv["kernels"]), ("plain", inv["plain"]),
                    *inv["faults"].items()]:
        log(f"  prefill invariants, {name}: {json.dumps(r)}")
    for side in sides:
        require(prefill_holds(inv["kernels"][side], limits), f"invariant ({side}) fails: {inv}")
        require(prefill_holds(inv["plain"][side], limits),
                f"plain invariant ({side}) fails: {inv}")
        caught = {n: not prefill_holds(r[side], limits) for n, r in inv["faults"].items()}
        log(f"  invariant ({side}) planted faults caught: {caught}")
        require(all(caught.values()), f"invariant ({side}) misses a planted fault: {caught}")
    return inv


# ---------------------------------------------------------------------------
# Phase 6: the quantized slice


def planted_k1q_faults():
    """K1q handed an int8 pool whose scale slab has the K and V lanes
    swapped, or every head reading its neighbour's scale: faults the
    quantized decode invariant must catch, each a replacement of
    ops.paged_decode_attention."""
    from lite_llama_tpu_torch.ops.attention_decode import paged_flash_decode as k1

    def lanes_swapped(q, pool, layer, table, seq_lens, sm_scale=None, **kw):
        s = pool.scales
        half = s.shape[-1] // 2
        return k1(q, dataclasses.replace(pool, scales=torch.cat([s[..., half:], s[..., :half]], -1)),
                  layer, table, seq_lens, sm_scale, **kw)

    def neighbour_head(q, pool, layer, table, seq_lens, sm_scale=None, **kw):
        return k1(q, dataclasses.replace(pool, scales=pool.scales.roll(-1, dims=-1)), layer,
                  table, seq_lens, sm_scale, **kw)

    return {"K and V scale lanes swapped": lanes_swapped,
            "the neighbouring head's scale": neighbour_head}


def planted_k6_patches():
    """Each planted K6 fault as a replacement of the W4A8 matmul that
    qeinsum routes to: the fault applied to the layer the call reads."""
    from lite_llama_tpu_torch.ops.qmatmul import quantized_matmul_packed as k6

    def make(fault):
        def run(x, q, scale, layer, *a, **kw):
            fq, fs = fault(q[layer:layer + 1], (scale[:, None] if scale.ndim == 2 else scale)
                           [layer:layer + 1])
            return k6(x, fq, fs, 0, *a, **kw)
        return run

    return {name: dict(quantized_matmul_packed=make(f)) for name, f in planted_k6_faults().items()}


def logits_invariant(dev, cfg, qparams, prompts, bf16_logits):
    """Last-token logits of the int4 model (every projection through K6:
    the prompts are at most 256 rows) through the kernels against the plain
    versions; the kernels must hold the limit, every K6 fault must break
    it. The distance to the bf16 model's logits is reported, with no limit
    (random weights say little about quantization error)."""
    def read(patch):
        with patched(patch), torch.inference_mode():
            return prefill_last_logits(dev, cfg, qparams,
                                       fresh_cache(dev, cfg, len(prompts), "int8"),
                                       prompts).float().cpu()

    kernels = read(None)
    inv = dict(plain=compare_logits(kernels, read(plain_ops())),
               faults={n: compare_logits(read(p), kernels) for n, p in planted_k6_patches().items()},
               vs_bf16_model=compare_logits(kernels, bf16_logits),
               limit=dict(rel_rms=QLOGITS_REL_RMS, max_abs_of_max_logit=QLOGITS_MAX_ABS))
    log(f"  int4 last-token logits: {json.dumps(inv)}")
    limits = (QLOGITS_REL_RMS, QLOGITS_MAX_ABS)
    require(prefill_holds(inv["plain"], limits), f"kernels and plain versions disagree: {inv}")
    caught = {n: not prefill_holds(r, limits) for n, r in inv["faults"].items()}
    log(f"  K6 planted faults caught: {caught}")
    require(all(caught.values()), f"the logits invariant misses a planted K6 fault: {caught}")
    return inv


def weight_bytes(tree):
    from lite_llama_tpu_torch.quant.qtensor import QTensor

    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return weight_bytes(tree.q) + weight_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def quantized_phase(dev, cfg, qparams, bf16_logits):
    """Llama-3.2-3B int4 (g128, riffle) with an int8 KV pool: the batch
    slice (decode invariant with K1q faults), the logits invariant (K6
    faults), serving and the prefill invariants under the int8 pool.
    Returns (summary, launches on this path)."""
    problems = []

    def attempt(what, fn, *a, **kw):
        """An invariant whose failure is reported after the phase's other
        readings are taken (the phase still fails)."""
        try:
            return fn(*a, **kw)
        except Failure as e:
            problems.append(f"{what}: {e}")
            log(f"  FAILED ({what}): {e}")
            return None

    def invariant(prompts, outs):
        # One request: its 152-row re-prefill takes W4A8 like the decode
        # steps (more than 256 rows take W4A16, a difference of its own).
        gen = [outs[0].token_ids]
        inv = attempt("quantized decode invariant", check_invariant, dev, cfg, qparams,
                      prompts[:1], gen, kv_quant="int8", faults=planted_k1q_faults(),
                      limits=(QUANT_INVARIANT_REL_RMS, QUANT_INVARIANT_MAX_ABS), top1=False)
        # Where the noise comes from: the same reading on a bf16 pool.
        r = decode_vs_reprefill(dev, cfg, qparams, prompts[:1], gen)
        log(f"  decode vs re-prefill, int4 weights on a bf16 pool: {r}")
        return dict(inv or {}, bf16_pool=r)

    out = {}
    out["batch"], batch = slice_phase(dev, cfg, qparams, engine_kw=dict(kv_quant="int8"),
                                      path=QUANT_BATCH_PATH, invariant=invariant)
    log("quantized slice: " + json.dumps(out["batch"]))
    # K3 / K4 write the int8 rows of wqkv, gate_up, down and the head; K6's
    # own quantizer runs for o_proj alone. Counted from the device events of
    # the profiled replays (slice_phase).
    L = cfg.num_hidden_layers
    step = out["batch"]["launches_per_decode_step"]
    want = dict(quantize_rows=L, rms_norm_int8_rows=2 * L + 1, swiglu_int8_rows=L)
    got = {k: step[k] for k in want}
    log(f"  launches per int4 decode step: {got} (want {want})")
    require(got == want, f"int8-row launches per int4 decode step {got}, want {want}")
    out["logits"] = attempt("int4 logits invariant", logits_invariant, dev, cfg, qparams,
                            batch_prompts(cfg)[:8], bf16_logits)
    t0 = time.perf_counter()
    out["serving"], serving = serving_phase(
        dev, cfg, qparams, engine_kw=dict(kv_quant="int8"), path=QUANT_SERVING_PATH,
        chunk_kernel="flash_prefill_chunked_int8", profile=False)
    out["serving"]["prefill_invariants"] = attempt(
        "int8-pool prefill invariants", prefill_invariants, dev, cfg, qparams,
        engine_kw=dict(kv_quant="int8"), limits=(QPREFILL_REL_RMS, QPREFILL_MAX_ABS))
    out["serving"]["seconds"] = time.perf_counter() - t0
    log("quantized serving: " + json.dumps(out["serving"]))
    require(not problems, f"phase 6 invariants failed: {problems}")
    return out, {k: batch[k] + serving[k] for k in KERNELS}


def fp8_kv_phase(dev, cfg, params, n=4, P=1500, steps=32):
    """bf16 weights with an fp8 KV pool: ``n`` prompts of ``P`` random ids
    prefilled in 512-token chunks (K5q-fp8), then ``steps`` greedy decode
    steps (K1q-fp8, replays of the decode graph captured before the timed
    and counted run; its capture apart, ``capture_ms``). Then a profiled
    decode of ``n`` short prompts (K1q-fp8 must be among the replays'
    device events) and the graph-vs-eager gate on them. First-token logits
    against the same prompts on a bf16 pool are reported, with no limit."""
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.sampling import SamplingParams

    prompts = serving_prompts(cfg)["long"][:n]
    total = [P + steps + 1] * n

    def engine(kv_quant):
        return InferenceEngine(cfg, params, device=dev, kv_quant=kv_quant, prefill_chunk=512,
                               page_size=16, max_reqs=n, num_pages=n * 100, decode_chunk=steps)

    eng = engine("fp8")
    sampling = SamplingParams.make(n, temperature=0.0, device=dev)
    eng.decode_step_for(n, "greedy")
    capture_ms = {f"{w} {m}": st.capture_ms for (w, m), st in eng._steps.items()}
    reset_counts()
    sync(dev)
    slots = eng.admit_requests(total)
    try:
        t0 = time.perf_counter()
        first, _, last, _ = eng.prefill(prompts, sampling, slots, return_logits=True)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, toks, lps = eng.decode(slots, first, np.zeros(n, bool), total, sampling,
                                     n_steps=steps)
        sync(dev)
        decode_s = time.perf_counter() - t0
    finally:
        eng.release_slots(slots, total)
    launches = read_counts()
    missing = [k for k in FP8_KV_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the fp8-KV path: {missing}")
    require(toks.shape == (steps, n) and np.all((toks >= 0) & (toks < cfg.vocab_size)),
            "fp8-KV decode tokens out of range")
    require(np.all(np.isfinite(lps)) and np.all(np.isfinite(last)), "fp8-KV: non-finite output")
    short = batch_prompts(cfg, n)
    prof = profile_decode(eng, short)
    require(prof["paged_flash_decode_fp8_launches_per_step"] > 0,
            f"K1q-fp8 absent from the replayed steps' device events: {prof}")
    gate = graph_gate(eng, short)
    del eng
    bf16_last, _ = _last_logits(engine(False), prompts)
    rec = dict(prompts=n, prompt_len=P, decode_steps=steps, prefill_s=prefill_s,
               decode_ms_per_step=decode_s * 1e3 / steps, capture_ms=capture_ms,
               graph_gate=gate, decode_profile=prof, launches=launches,
               first_logits_vs_bf16_pool=compare_logits(torch.from_numpy(last), bf16_last))
    log("fp8 KV: " + json.dumps(rec))
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 7: OpenLLaMA-3B v2, head dim 100


def open_llama_3b_v2():
    """OpenLLaMA-3B v2 as the published config.json of
    openlm-research/open_llama_3b_v2 gives it: LlamaForCausalLM, hidden 3200,
    intermediate 8640, 26 layers, 32 heads and 32 kv heads (head dim 100),
    vocab 32000, rms_norm_eps 1e-6, 2048 positions, untied embeddings, bos 1,
    eos 2, pad 0. The file names no rope_theta: the Llama default, 10000."""
    from lite_llama_tpu_torch.config import load_config

    return load_config(dict(
        architectures=["LlamaForCausalLM"], model_type="llama", hidden_size=3200,
        intermediate_size=8640, num_hidden_layers=26, num_attention_heads=32,
        num_key_value_heads=32, vocab_size=32000, rms_norm_eps=1e-6, rope_theta=10000.0,
        max_position_embeddings=2048, tie_word_embeddings=False, hidden_act="silu",
        bos_token_id=1, eos_token_id=2, pad_token_id=0), dtype=torch.bfloat16)


def free_device():
    gc.collect()
    torch.cuda.empty_cache()


def open_llama_phase(dev):
    """OpenLLaMA-3B v2 at full width and depth, random bf16 weights from the
    seed: the phase-4 batch run (K8 for fresh prefill, never K2) with the
    decode-vs-re-prefill invariant and K1 faults, one serving wave (wave 1
    of phase 5; K5 at head dim 100) and the chunked-vs-single-shot prefill
    invariant (single shot through K8) with K5 faults. Returns (summary,
    launches on this path)."""
    from lite_llama_tpu_torch.models.decoder import init_decoder_params

    t0 = time.perf_counter()
    cfg = open_llama_3b_v2()
    params = init_decoder_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"], params["final_norm"],
                                        *params["layers"].values()])
    log(f"  {n_params / 1e9:.3f} G parameters, {weight_bytes(params) / 1e9:.3f} GB in bf16; "
        f"head_dim {cfg.head_dim}")

    def invariant(prompts, outs):
        return check_invariant(dev, cfg, params, prompts[:2], [o.token_ids for o in outs[:2]],
                               limits=OPEN_LLAMA_INVARIANT)

    out = dict(params=n_params)
    out["batch"], batch = slice_phase(dev, cfg, params, path=OPEN_LLAMA_BATCH_PATH,
                                      invariant=invariant, absent=("flash_prefill",),
                                      repeats=OPEN_LLAMA_REPEATS)
    log("OpenLLaMA batch: " + json.dumps(out["batch"]))
    free_device()
    out["serving"], serving = serving_phase(dev, cfg, params, profile=False, n_waves=1)
    free_device()
    out["serving"]["prefill_invariants"] = prefill_invariants(
        dev, cfg, params, limits=OPEN_LLAMA_PREFILL, sides=("a",))
    out["seconds"] = time.perf_counter() - t0
    log("OpenLLaMA serving: " + json.dumps(out["serving"]))
    return out, {k: batch[k] + serving[k] for k in KERNELS}


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
    from lite_llama_tpu_torch.ops import _build

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
            fn = ""
            for line in report.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1] if "'" in line else line
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name} ...{fn[-40:]}: {line.strip()}")
    log("  flash_prefill_chunked dynamic shared memory (bytes): " + json.dumps(
        {f"D={D} {kv}": chunked_smem(D, i) for D in (64, 100, 128)
         for i, kv in enumerate(("bf16", "int8", "fp8", "fresh"))}))
    build_s = time.perf_counter() - t0
    log(f"  nvcc builds {built}; all kernels ready in {build_s:.1f} s")

    log("phase 3: kernels against their plain versions (bf16)")
    t0 = time.perf_counter()
    cases = kernel_phase()
    log("  K3 / K4 launch floor, chain and host cost: " + json.dumps(norm_extras()))
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    by_path = {p: {k: None for k in KERNELS}
               for p in ("batch", "serving", "quantized", "fp8_kv", "open_llama")}
    if not args.kernels_only:
        from lite_llama_tpu_torch.models.decoder import init_decoder_params
        from lite_llama_tpu_torch.models.presets import llama32_3b
        from lite_llama_tpu_torch.quant.qtensor import quantize_decoder_params

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

        log("phase 6: quantized slice (int4 g128 riffle weights, int8 KV)")
        t0 = time.perf_counter()
        with torch.inference_mode():
            bf16_logits = prefill_last_logits(dev, cfg, params, fresh_cache(dev, cfg, 8),
                                              batch_prompts(cfg)[:8]).float().cpu()
        bf16_bytes = weight_bytes(params)
        # Where the quantized decode invariant's noise comes from: bf16
        # weights on an int8 pool (teacher-forced on seeded random tokens).
        forced = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, (1, 128)).tolist()
        r = decode_vs_reprefill(dev, cfg, params, batch_prompts(cfg)[:1], forced,
                                kv_quant="int8")
        log(f"  decode vs re-prefill, bf16 weights on an int8 pool: {r}")
        _, by_path["fp8_kv"] = fp8_kv_phase(dev, cfg, params)
        t1 = time.perf_counter()
        qparams = quantize_decoder_params(params, "int4", group_size=128, riffle=True)
        sync(dev)
        log(f"  quantized in {time.perf_counter() - t1:.2f} s: weights {bf16_bytes / 1e9:.3f} GB "
            f"bf16 -> {weight_bytes(qparams) / 1e9:.3f} GB")
        del params  # the bf16 weights leave the device before the quantized runs
        torch.cuda.empty_cache()
        _, by_path["quantized"] = quantized_phase(dev, cfg, qparams, bf16_logits)
        log(f"  phase 6 took {time.perf_counter() - t0:.1f} s")
        del qparams  # phase 7 needs the card's memory
        free_device()
        log("phase 7: OpenLLaMA-3B v2 (head dim 100)")
        summary, by_path["open_llama"] = open_llama_phase(dev)
        log(f"  phase 7 took {summary['seconds']:.1f} s")

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
