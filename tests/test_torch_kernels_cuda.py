"""The port's hand-written kernels against their plain PyTorch versions on
the card, in bf16, at Llama-3.2-3B (D=128, Nq=24, Hkv=8) and Llama-3.2-1B
(D=64, Nq=32, Hkv=8) head shapes, the quantized kernels (K6 W4A8, K7 W8A8,
K1q / K5q on int8 and fp8 pools) included, the attention kernels at the
other head dims (K8, and K1 / K1q / K5 / K5q at D = 16 ... 112 and 256 with
1 to 16 query heads per kv head), fresh prefill (K2 / K8, the no-history
instance of K5's template; K2 at D 256) at every G from 1 to 8, 12 and 16
and S up to 2048 and against K5 with no history, K5 / K5q over page sizes 7
to 80 and at the prefix-hit shape, K1 / K1q's split KV walk (flash
decoding) at kv_lens around every page and split edge, at every G from 1 to
8 and at serving's width, bit for
bit across launches and under CUDA-graph replay, K7 at Llama-3.2-3B's five
projections from 1 to 256 rows, at every scale-group size and split, bit
for bit in fp32 and bf16, K3 / K4 (csrc/norms.cu) from 1 to 4096 rows at
widths from 96 to 40000, off the 16-byte grid and on strided views, their
residual sums and int8 rows bit for bit (K6 fed by the rows equal to K6
fed by the activations) and under CUDA-graph replay, K1q / K5q on a
tensor-parallel shard's int8 pool at a head_offset (its global scale
lanes), K9 (the W4A16 grouped matmul under 512 rows) at the down
projections qeinsum keeps off K6 and at 257-511 rows, bit for bit across
launches and under CUDA-graph replay, plus the refusals that keep the card
off the plain code. This file imports no JAX, so it
runs on a machine with a card and without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerance on the card: |kernel - plain| <= 1e-2 + 1e-2 * |plain| for bf16
outputs (one bf16 step is 2^-8 relative; the kernels and the plain versions
round q, P and the output at different points). K6 and K7 with fp32 output
are held to equality: both sides run exact integer dots and the same fp32
folds in the same order. chip_smoke.py runs the same
comparisons at the main path's full shapes.
"""

import contextlib
import dataclasses
import math
import shutil

import pytest

torch = pytest.importorskip("torch")

from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.executor.kv_cache import KVPool  # noqa: E402
from lite_llama_tpu_torch.ops import _build, norms, ref  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    decode_grid_slots,
    decode_spans,
    launch_paged_decode,
    paged_decode_state_plain,
    paged_flash_decode,
    plan_decode_splits,
)
from lite_llama_tpu_torch.ops.attention_prefill import (  # noqa: E402
    K2_HEAD_DIMS,
    chunked_prefill_state_plain,
    flash_prefill_chunked,
    launch_flash_prefill,
    launch_flash_prefill_chunked,
)
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.ops import qmatmul as qmm  # noqa: E402
from lite_llama_tpu_torch.quant.qtensor import quantize  # noqa: E402


def _within(got, want):
    g, w = got.float(), want.float()
    return bool(torch.all((g - w).abs() <= 1e-2 + 1e-2 * w.abs()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_launchers_refuse_cpu_tensors():
    """A launcher never runs a plain version: handed CPU tensors it raises."""
    x = torch.zeros(2, 4, 64)
    pages = torch.zeros(1, 2, 16, 128)
    with pytest.raises(ValueError, match="CUDA"):
        launch_paged_decode(x, pages, 8, 0, torch.zeros(2, 2, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32), 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        launch_flash_prefill(x[None], x[None], x[None], torch.ones(1, dtype=torch.int32), 0.1)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        launch_flash_prefill_chunked(x[None], x[None], x[None], one, one, pages, 8, 0,
                                     torch.zeros(1, 2, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        norms.launch_rms_norm(x, None, torch.ones(64), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        norms.launch_swiglu(x, x)


def test_w4a16_launcher_refuses_cpu_tensors():
    """K9's launcher never runs its plain version: handed CPU tensors it
    raises; the dispatcher gives them the plain version."""
    x = torch.zeros(4, 64).bfloat16()
    q = torch.zeros(1, 64, 16, dtype=torch.int8)
    scale = torch.ones(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        qmm.launch_quantized_matmul_w4a16(x, q, scale)
    assert qmm.quantized_matmul_w4a16(x, q, scale).shape == (4, 1, 2, 16)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No CUDA toolkit means an error at build time, not a quiet fallback."""
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here; the refusal needs its absence")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_library_declares_each_entry_of_a_source(monkeypatch, tmp_path):
    """Two C entries of one source each get their own signature (builds
    nothing: the shared library is a stub)."""
    import ctypes

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    fake = tmp_path / "libfake.so"
    fake.write_bytes(b"")
    monkeypatch.setattr(_build, "_lib_path", lambda name: fake)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_declared", set())
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    a = [ctypes.c_void_p, ctypes.c_int]
    b = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    lib = _build.library("flash_prefill_chunked", "entry_a", a)
    assert _build.library("flash_prefill_chunked", "entry_b", b) is lib
    assert lib.entry_a.argtypes == a and lib.entry_b.argtypes == b
    assert lib.entry_a.restype is ctypes.c_int and lib.entry_b.restype is ctypes.c_int
    assert lib.error_string.restype is ctypes.c_char_p
    _build.library("flash_prefill_chunked", "entry_a", b)  # declared once, not redeclared
    assert lib.entry_a.argtypes == a


@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8)])
def test_decode_kernel_matches_plain(cuda, D, Nq, Hkv):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, ps, P, ppr = 5, 16, 64, 8
    lens = torch.tensor([0, 1, 16, 77, 128], dtype=torch.int32, device=cuda)
    pages = torch.randn((2, 2, P * ps, Hkv * D), generator=g, device=cuda).bfloat16()
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, Nq, D), generator=g, device=cuda).bfloat16()
    out, m, l = paged_flash_decode(q, KVPool(pages, ps, Hkv, D), 1, table, lens,
                                   return_state=True)
    po, pm, pl = paged_decode_state_plain(q, pages, ps, 1, table, lens, D**-0.5)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(out[0] == 0)


@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8)])
def test_prefill_kernel_matches_plain(cuda, D, Nq, Hkv):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S = 4, 80
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    lens = [80, 1, 33, 0]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, sl)
    want = ref.prefill_attention(q, k, v, sl)
    for b, n in enumerate(lens):  # pad rows are never read
        assert _within(got[b, :n], want[b, :n]), b


@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8)])
@pytest.mark.parametrize("S,page_size", [(512, 16), (80, 7)])
def test_chunked_prefill_kernel_matches_plain(cuda, D, Nq, Hkv, S, page_size):
    """K5 against its plain version on out, m and l for every row: history
    lengths 0, 16, 500 and 1536 under shuffled page ids, a chunk of 0 rows
    (a history-only walk) and an empty request (no history, no chunk)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, ppr = 5, 230  # ppr * page_size covers the 1536-token history
    P = B * ppr
    start = torch.tensor([0, 16, 500, 1536, 0], dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, S * 3 // 5, 0, S, 0], dtype=torch.int32, device=cuda)
    pages = torch.randn((2, 2, P * page_size, Hkv * D), generator=g, device=cuda).bfloat16()
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    pool = KVPool(pages, page_size, Hkv, D)
    out, m, l = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    assert torch.equal(flash_prefill_chunked(q, k, v, clen, start, pool, 1, table), out)
    po, pm, pl = chunked_prefill_state_plain(q, k, v, clen, start, pages, page_size, 1, table,
                                             D**-0.5)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    assert torch.all(m[4] == -1e30) and torch.all(l[4] == 0) and torch.all(out[4] == 0)


@pytest.mark.parametrize("S", [5, 9])
def test_chunked_prefill_kernel_at_the_verify_shape(cuda, S):
    """K5 at a speculative verify chunk (Llama-3.2-3B heads, 12 requests of
    S = draft length + 1 rows with ragged widths from 0, histories of 25-399
    tokens that end mid-page, page 16) against its plain version on every
    live row, and the same launch captured in a CUDA graph and replayed on
    new inputs bit for bit (the verify step replays it so)."""
    D, Nq, Hkv, ps = 128, 24, 8, 16
    g = torch.Generator(device=cuda).manual_seed(11)
    start = torch.tensor([25, 38, 57, 90, 129, 150, 201, 255, 281, 313, 377, 399],
                         dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, 0, 1, 2, 3, S - 1, S, S, 2, 1, S, S // 2], dtype=torch.int32,
                        device=cuda)
    B, ppr = 12, 28  # ppr * ps covers 399 + 3 * 7 + 9 positions
    P = B * ppr
    pages = torch.randn((2, 2, P * ps, Hkv * D), generator=g, device=cuda).bfloat16()
    table = torch.randperm(P, generator=g, device=cuda).view(B, ppr).int()
    q, k, v = (torch.randn((B, S, n, D), generator=g, device=cuda).bfloat16()
               for n in (Nq, Hkv, Hkv))
    pool = KVPool(pages, ps, Hkv, D)
    out = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table)
    po, _, _ = chunked_prefill_state_plain(q, k, v, clen, start, pages, ps, 1, table, D**-0.5)
    live = torch.arange(S, device=cuda)[None, :] < clen[:, None]
    assert _within(out[live], po[live])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefill_chunked(q, k, v, clen, start, pool, 1, table)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table)
    for seed in range(3):
        gen = torch.Generator(device=cuda).manual_seed(20 + seed)
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda).bfloat16())
        start.add_(7)  # later positions, still mid-page for most rows
        graph.replay()
        want = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table)
        torch.cuda.synchronize()
        assert torch.equal(got, want), seed


@pytest.mark.parametrize("rows,H,residual", [(12, 3072, True), (300, 3072, False),
                                             (288, 128, False)])
def test_norm_kernel_matches_plain(cuda, rows, H, residual):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((rows, H), generator=g, device=cuda).bfloat16()
    r = torch.randn((rows, H), generator=g, device=cuda).bfloat16() if residual else None
    w = torch.randn((H,), generator=g, device=cuda).bfloat16()
    n, s = ops.skip_rms_norm(x, r, w)
    pn, ps_ = ref.skip_rms_norm(x, r, w)
    assert torch.equal(s, ps_)  # the rounded residual sum is exact
    assert _within(n, pn)


def test_swiglu_kernel_matches_plain_on_strided_views(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    gu = torch.randn((12, 2, 8192), generator=g, device=cuda).bfloat16()
    gate, up = gu[:, 0], gu[:, 1]  # row-strided views
    assert _within(ops.swiglu(gate, up), ref.swiglu(gate, up))


# K3 / K4 (csrc/norms.cu): decode and prefill row counts; widths of 3B,
# OpenLLaMA, Qwen3's qk-norm, odd and unaligned ones, and rows wider than the
# registers hold (the loop kernel).
NORM_ROWS = [1, 12, 64, 4096]
NORM_WIDTHS = [8192, 3200, 3072, 128, 100, 96, 97]


def _norm_inputs(dev, rows, H, dtype=torch.bfloat16, seed=8, offset=0):
    """x, residual, weight; ``offset`` elements into their buffers (rows
    then start off the 16-byte grid)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape):
        n = math.prod(shape)
        return torch.randn((n + offset,), generator=g, device=dev).to(dtype)[offset:].view(shape)

    return t(rows, H), t(rows, H), (1 + 0.1 * t(H).float()).to(dtype)


def _int8_rows_of(out):
    """K6's own quantizer on the card (C a multiple of 32), else the plain
    quantizer: both must equal what K3 / K4 wrote beside ``out``."""
    o2 = out.reshape(-1, out.shape[-1])
    return qmm.launch_quantize_rows(o2) if o2.shape[1] % 32 == 0 else qmm._quantize_rows(o2)


@pytest.mark.parametrize("rows", NORM_ROWS)
@pytest.mark.parametrize("H", NORM_WIDTHS)
def test_norm_kernels_match_plain_at_every_width(cuda, rows, H):
    """K3 with and without residual and K4, against their plain versions;
    the residual sum and the int8 rows bit for bit."""
    x, r, w = _norm_inputs(cuda, rows, H)
    for residual in (r, None):
        n, s = ops.skip_rms_norm(x, residual, w)
        pn, ps_ = ref.skip_rms_norm(x, residual, w)
        assert torch.equal(s, ps_) and _within(n, pn)
        rows8, s8 = ops.skip_rms_norm(x, residual, w, int8_rows=True)
        assert torch.equal(rows8.x, n) and torch.equal(s8, s)
        xi, xs = _int8_rows_of(rows8.x)
        assert torch.equal(rows8.xi, xi) and torch.equal(rows8.xs, xs)
    out = ops.swiglu(x, r)
    assert _within(out, ref.swiglu(x, r))
    rows8 = ops.swiglu(x, r, int8_rows=True)
    assert torch.equal(rows8.x, out)
    xi, xs = _int8_rows_of(out)
    assert torch.equal(rows8.xi, xi) and torch.equal(rows8.xs, xs)


@pytest.mark.parametrize("H,dtype,offset", [(3072, torch.bfloat16, 1), (3072, torch.bfloat16, 2),
                                            (3072, torch.bfloat16, 4), (3072, torch.float32, 1),
                                            (3072, torch.float32, 0), (100, torch.float32, 0),
                                            (40000, torch.bfloat16, 0), (20000, torch.float32, 0),
                                            (40000, torch.bfloat16, 1)])
def test_norm_kernels_match_plain_off_the_16_byte_grid_and_past_the_registers(
        cuda, H, dtype, offset):
    """Unaligned rows take 8-, 4- or 2-byte vectors; rows of more than 4096
    vectors the loop kernel; fp32 takes its own instances."""
    x, r, w = _norm_inputs(cuda, 12, H, dtype, offset=offset)
    shape = norms.launch_shape("rms", x, r, w)
    assert shape["vector_bytes"] == (16 if offset % 8 == 0 else 2 * (offset & -offset)
                                     if dtype == torch.bfloat16 else 4)
    assert (shape["vectors_per_thread"] == 0) == (H * x.element_size() // shape["vector_bytes"]
                                                  > 4096)
    n, s = ops.skip_rms_norm(x, r, w, int8_rows=True)
    pn, ps_ = ref.skip_rms_norm(x, r, w)
    assert torch.equal(s, ps_) and _within(n.x, pn)
    xi, xs = qmm._quantize_rows(n.x)
    assert torch.equal(n.xi, xi) and torch.equal(n.xs, xs)
    assert _within(ops.rms_norm(x, w), ref.rms_norm(x, w))
    out = ops.swiglu(x, r, int8_rows=True)
    assert _within(out.x, ref.swiglu(x, r)) and torch.equal(out.xi, qmm._quantize_rows(out.x)[0])


def test_norm_kernel_takes_an_fp32_weight_beside_bf16_rows(cuda):
    x, r, w = _norm_inputs(cuda, 12, 3072)
    w32 = w.float() * 1.001
    n, s = ops.skip_rms_norm(x, r, w32)
    pn, ps_ = ref.skip_rms_norm(x, r, w32)
    assert torch.equal(s, ps_) and _within(n, pn)
    x32, r32 = x.float(), r.float()
    n, s = ops.skip_rms_norm(x32, r32, w)  # fp32 rows, bf16 weight
    pn, ps_ = ref.skip_rms_norm(x32, r32, w)
    assert torch.equal(s, ps_) and _within(n, pn)


@pytest.mark.parametrize("rows,I", [(12, 8192), (64, 8640), (4096, 8192)])
def test_swiglu_kernel_matches_plain_on_strided_views_with_int8_rows(cuda, rows, I):
    g = torch.Generator(device=cuda).manual_seed(9)
    y = torch.randn((rows, 2 * I), generator=g, device=cuda).bfloat16()  # riffle [gate | up]
    gate, up = y[:, :I], y[:, I:]
    out = ops.swiglu(gate, up, int8_rows=True)
    assert _within(out.x, ref.swiglu(gate, up))
    xi, xs = qmm.launch_quantize_rows(out.x)
    assert torch.equal(out.xi, xi) and torch.equal(out.xs, xs)


@pytest.mark.parametrize("M,name", [(12, "wqkv"), (12, "gate_up"), (64, "gate_up"),
                                    (12, "lm_head")])
def test_w4a8_on_the_norms_int8_rows_equals_w4a8_on_its_bf16_rows(cuda, M, name):
    """K6 fed by K3's (xi, xs) is K6 fed by K3's bf16 rows, bit for bit
    (fp32 and bf16 out), split grids included."""
    C, O = 3072, {"wqkv": 5120, "gate_up": 16384, "lm_head": 8192}[name]
    qt = _qmm_weights(cuda, "int4", C, O, 128, True)
    x, r, w = _norm_inputs(cuda, M, C)
    rows, _ = ops.skip_rms_norm(x, r, w, int8_rows=True)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = qmm.launch_quantized_matmul_packed.launches
        got = qmm.quantized_matmul_packed(rows, qt.q, qt.scale, 1, out_dtype, False, O)
        want = qmm.quantized_matmul_packed(rows.x, qt.q, qt.scale, 1, out_dtype, False, O)
        assert qmm.launch_quantized_matmul_packed.launches == before + 2
        assert torch.equal(got, want)
    plain = qmm.quantized_matmul_packed_plain(rows, qt.q, qt.scale, 1, torch.float32, False, O)
    assert torch.equal(qmm.quantized_matmul_packed(rows, qt.q, qt.scale, 1, torch.float32,
                                                   False, O), plain)


def test_norm_kernels_replay_in_a_cuda_graph(cuda):
    """K3 (with int8 rows) then K4 captured once and replayed three times on
    new inputs: each replay is bit-equal to eager launches."""
    x, r, w = _norm_inputs(cuda, 12, 3072)
    gu = torch.randn((12, 2, 8192), device=cuda).bfloat16()

    def step():
        n, s = ops.skip_rms_norm(x, r, w, int8_rows=True)
        return n, s, ops.swiglu(gu[:, 0], gu[:, 1]), ops.swiglu(gu[:, 0], gu[:, 1], int8_rows=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    for seed in range(3):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        for t in (x, r, gu):
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda).bfloat16())
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        (n, s, o, q), (wn, ws, wo, wq) = got, want
        assert all(torch.equal(a, b) for a, b in zip((*n, s, o, *q), (*wn, ws, wo, *wq))), seed


def test_norm_launchers_refuse_what_they_do_not_take(cuda):
    x, r, w = _norm_inputs(cuda, 4, 256)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ops.skip_rms_norm(x.half(), r.half(), w.half())
    with pytest.raises(ValueError, match="residual"):
        ops.skip_rms_norm(x, r[:2], w)
    with pytest.raises(ValueError, match="CUDA"):
        ops.skip_rms_norm(x, r, w.cpu())
    with pytest.raises(ValueError, match="match"):
        ops.swiglu(x, r.float())


def test_build_hashes_the_headers_a_source_includes(monkeypatch, tmp_path):
    """An edited header gives its sources a new library name (no stale
    build), and a header's own edit is all it takes (builds nothing)."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "h.cuh"\nint h = 1;\n')
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build._lib_path("a")
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "h.cuh"\nint h = 2;\n')
    assert _build._lib_path("a") != first
    assert "common.cuh" in (_build.PKG_DIR / "csrc" / "norms.cu").read_text()


def _qmm_weights(dev, qdtype, C, O, gs, riffle, Lf=2, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((Lf, C, O), generator=g, device=dev).mul_(0.02).bfloat16()
    return quantize(w, (1,), qdtype, group_size=gs, riffle_blocks=1 if riffle else 0)


@pytest.mark.parametrize("M", [12, 64, 200])
@pytest.mark.parametrize("C,O,gs,riffle", [(3072, 1024, 128, True), (3072, 1024, 128, False),
                                           (8192, 512, None, True), (1024, 8448, 128, True),
                                           (1024, 8448, 64, False)])
def test_w4a8_kernel_matches_plain(cuda, M, C, O, gs, riffle):
    qt = _qmm_weights(cuda, "int4", C, O, gs, riffle)
    x = torch.randn((M, C), device=cuda).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = qmm.quantized_matmul_packed(x, qt.q, qt.scale, 1, out_dtype, not riffle, O)
        want = qmm.quantized_matmul_packed_plain(x, qt.q, qt.scale, 1, out_dtype, not riffle, O)
        assert got.shape == (M, O) and got.dtype == out_dtype
        if out_dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            assert _within(got, want)


@pytest.mark.parametrize("M,C,O,gs", [(12, 3072, 1024, 128), (64, 8192, 512, None),
                                      (200, 1024, 512, 64)])
def test_w8a8_kernel_matches_plain(cuda, M, C, O, gs):
    qt = _qmm_weights(cuda, "int8", C, O, gs, False)
    x = torch.randn((M, C), device=cuda).bfloat16()
    got = qmm.quantized_matmul_int8(x, qt.q, qt.scale, 1, torch.float32)
    assert torch.equal(got, qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 1, torch.float32))
    got = qmm.quantized_matmul_int8(x, qt.q, qt.scale, 0)
    assert _within(got, qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 0))


def test_quantized_matmul_kernels_refuse_what_they_do_not_take(cuda):
    qt = _qmm_weights(cuda, "int4", 256, 256, 16, True)  # 16-row groups: m16n8k16 steps
    x = torch.randn((4, 256), device=cuda).bfloat16()
    got = qmm.quantized_matmul_packed(x, qt.q, qt.scale, 0, torch.float32, False)
    assert torch.equal(got, qmm.quantized_matmul_packed_plain(x, qt.q, qt.scale, 0,
                                                              torch.float32, False))
    qt = _qmm_weights(cuda, "int4", 256, 256, 4, True)  # 4-row groups: no mma k-step
    with pytest.raises(ValueError, match="unsupported"):
        qmm.quantized_matmul_packed(x, qt.q, qt.scale, 0, interleave=False)
    qt = _qmm_weights(cuda, "int4", 256, 256, 32, True)
    with pytest.raises(ValueError, match="unsupported"):
        qmm.quantized_matmul_packed(torch.randn((300, 256), device=cuda).bfloat16(), qt.q,
                                    qt.scale, 0, interleave=False)
    with pytest.raises(ValueError, match="CUDA"):
        qmm.quantized_matmul_packed(x, qt.q.cpu(), qt.scale.cpu(), 0)


@pytest.mark.parametrize("M", [12, 64])
@pytest.mark.parametrize("gs,riffle", [(8, True), (16, False), (48, True), (16, True)])
def test_w4a8_kernel_matches_plain_at_small_groups(cuda, M, gs, riffle):
    """Scale groups that are not a multiple of 32 rows: m16n8k16 steps, and
    for 8 and 48 rows (odd multiples of 8) half-masked k16 passes."""
    C, O = 3072, 1024
    qt = _qmm_weights(cuda, "int4", C, O, gs, riffle)
    x = torch.randn((M, C), device=cuda).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = qmm.quantized_matmul_packed(x, qt.q, qt.scale, 1, out_dtype, not riffle, O)
        want = qmm.quantized_matmul_packed_plain(x, qt.q, qt.scale, 1, out_dtype, not riffle, O)
        if out_dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            assert _within(got, want)


def test_w8a8_kernel_matches_plain_at_16_row_groups(cuda):
    qt = _qmm_weights(cuda, "int8", 1024, 512, 16, False)
    x = torch.randn((12, 1024), device=cuda).bfloat16()
    got = qmm.quantized_matmul_int8(x, qt.q, qt.scale, 1, torch.float32)
    assert torch.equal(got, qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 1, torch.float32))


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("M", [12, 64])
@pytest.mark.parametrize("gs", [128, None])
def test_w4a8_kernel_matches_plain_at_every_split(cuda, M, gs):
    """Llama-3.2-3B's down projection (C 8192, O 3072) at every split count
    the planner allows, K7 beside it: the in-order fold across splits keeps
    the fp32 output bit-equal."""
    C, O = 8192, 3072
    qt = _qmm_weights(cuda, "int4", C, O, gs, True)
    q8 = _qmm_weights(cuda, "int8", C, O, gs, False)
    x = torch.randn((M, C), device=cuda).bfloat16()
    nG = qt.scale.shape[-2] if qt.scale.ndim == 3 else 1
    want = qmm.quantized_matmul_packed_plain(x, qt.q, qt.scale, 1, torch.float32, False, O)
    want8 = qmm.quantized_matmul_int8_plain(x, q8.q, q8.scale, 1, torch.float32)
    allowed = qmm.allowed_splits(C, nG, O // 2, M, _sms(cuda))
    assert qmm.plan_splits(C, nG, O // 2, M, _sms(cuda))[0] in allowed
    for S in allowed:
        got = qmm.launch_quantized_matmul_packed(x, qt.q, qt.scale, 1, torch.float32, False, O,
                                                 _splits=S)
        assert torch.equal(got, want), S
        if S in qmm.allowed_splits(C, nG, O, M, _sms(cuda)):
            got8 = qmm.launch_quantized_matmul_int8(x, q8.q, q8.scale, 1, torch.float32,
                                                    _splits=S)
            assert torch.equal(got8, want8), S


# Llama-3.2-3B's projections (C, O), as K7 takes them.
_K7_SHAPES = {"gate_up": (3072, 16384), "wqkv": (3072, 5120), "o_proj": (3072, 3072),
              "down": (8192, 3072), "lm_head": (3072, 128256)}
_k7_cache = {}


def _k7_weights(dev, C, O, gs):
    """A two-layer int8 stack, the last one asked for kept (lm_head's is
    0.8 GB)."""
    key = (C, O, gs)
    if key not in _k7_cache:
        _k7_cache.clear()
        _k7_cache[key] = _qmm_weights(dev, "int8", C, O, gs, False)
    return _k7_cache[key]


def _k7_matches_plain(x, qt, **plan):
    """K7 launched (the counter moves) equals its plain version bit for bit,
    in fp32 and in bf16 (both round the same fp32 product once)."""
    n = qmm.launch_quantized_matmul_int8.launches
    got = qmm.launch_quantized_matmul_int8(x, qt.q, qt.scale, 1, torch.float32, **plan)
    assert qmm.launch_quantized_matmul_int8.launches == n + 1
    want = qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 1, torch.float32)
    assert got.shape == want.shape and torch.equal(got, want), plan
    got = qmm.launch_quantized_matmul_int8(x, qt.q, qt.scale, 0, **plan)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 0)), plan


@pytest.mark.parametrize("M", [1, 12, 17, 64, 256])
@pytest.mark.parametrize("name", list(_K7_SHAPES))
def test_w8a8_kernel_matches_plain_at_3b_projections(cuda, name, M):
    C, O = _K7_SHAPES[name]
    qt = _k7_weights(cuda, C, O, 128)
    x = torch.randn((M, C), device=cuda, generator=torch.Generator(device=cuda).manual_seed(M))
    _k7_matches_plain(x.bfloat16(), qt)


@pytest.mark.parametrize("M", [12, 64])
@pytest.mark.parametrize("gs", [8, 16, 48, 128, None])
def test_w8a8_kernel_matches_plain_at_every_group_size_and_k_warp_count(cuda, gs, M):
    """Groups of 8 (half-masked k16 passes), 16, 48 (k16 steps), 128 and
    per-channel, as planned and unsplit. Unsplit at 12 rows, spans of 128
    rows take two k-warps per column (summing their int32 dots before each
    fold); smaller spans, and 64 rows (no room), take one."""
    C, O = 3072, 1024
    qt = _qmm_weights(cuda, "int8", C, O, gs, False)
    x = torch.randn((M, C), device=cuda).bfloat16()
    nG = qt.scale.shape[-2] if qt.scale.ndim == 3 else 1
    kw = qmm.plan_w8a8(C, nG, O, M, _sms(cuda), 1)[0]
    assert kw == (2 if gs in (128, None) and M == 12 else 1)
    _k7_matches_plain(x, qt)
    _k7_matches_plain(x, qt, _splits=1)


@pytest.mark.parametrize("M", [12, 64])
@pytest.mark.parametrize("gs", [128, None])
def test_w8a8_kernel_matches_plain_at_every_split(cuda, M, gs):
    """Llama-3.2-3B's down projection (C 8192, O 3072) at every split count
    the planner allows: the in-order fold across splits keeps the output
    bit-equal."""
    C, O = _K7_SHAPES["down"]
    qt = _k7_weights(cuda, C, O, gs)
    x = torch.randn((M, C), device=cuda).bfloat16()
    nG = qt.scale.shape[-2] if qt.scale.ndim == 3 else 1
    splits = sorted({S for _, S in qmm.w8a8_allowed_plans(C, nG, O, M, _sms(cuda))})
    assert (len(splits) > 1) == (M == 12)  # at 64 rows held spans leave no room
    for S in splits:
        _k7_matches_plain(x, qt, _splits=S)


def test_w8a8_split_kernel_replays_in_a_cuda_graph(cuda):
    """K7 split over C, captured once and replayed three times on new
    inputs: each replay equals the plain version bit for bit."""
    C, O = _K7_SHAPES["o_proj"]
    qt = _k7_weights(cuda, C, O, 128)
    assert qmm.plan_w8a8(C, C // 128, O, 12, _sms(cuda))[1] > 1
    x = torch.randn((12, C), device=cuda).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmm.quantized_matmul_int8(x, qt.q, qt.scale, 1, torch.float32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmm.quantized_matmul_int8(x, qt.q, qt.scale, 1, torch.float32)
    for seed in range(3):
        x.copy_(torch.randn((12, C), device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed)).bfloat16())
        graph.replay()
        want = qmm.quantized_matmul_int8_plain(x, qt.q, qt.scale, 1, torch.float32)
        assert torch.equal(out, want), seed


def test_w8a8_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn((4, 256), device=cuda).bfloat16()
    qt = _qmm_weights(cuda, "int8", 256, 256, 4, False)  # 4-row groups: no mma k-step
    with pytest.raises(ValueError, match="unsupported"):
        qmm.quantized_matmul_int8(x, qt.q, qt.scale, 0)
    qt = _qmm_weights(cuda, "int8", 256, 256, 32, False)
    with pytest.raises(ValueError, match="unsupported"):
        qmm.quantized_matmul_int8(torch.randn((300, 256), device=cuda).bfloat16(), qt.q,
                                  qt.scale, 0)
    with pytest.raises(ValueError, match="CUDA"):
        qmm.quantized_matmul_int8(x, qt.q.cpu(), qt.scale.cpu(), 0)
    with pytest.raises(ValueError, match="not allowed"):  # one split per 128 rows at most
        qmm.launch_quantized_matmul_int8(x, qt.q, qt.scale, 0, _splits=3)


def test_w4a8_split_kernel_replays_in_a_cuda_graph(cuda):
    """K6 split over C, captured once and replayed three times on new
    inputs: each replay equals the plain version, so the counters the last
    split resets are ready for the next replay."""
    C, O = 8192, 3072
    qt = _qmm_weights(cuda, "int4", C, O, 128, True)
    assert qmm.plan_splits(C, C // 128, O // 2, 12, _sms(cuda))[0] > 1
    x = torch.randn((12, C), device=cuda).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmm.quantized_matmul_packed(x, qt.q, qt.scale, 1, torch.float32, False, O)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmm.quantized_matmul_packed(x, qt.q, qt.scale, 1, torch.float32, False, O)
    for seed in range(3):
        x.copy_(torch.randn((12, C), device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed)).bfloat16())
        graph.replay()
        want = qmm.quantized_matmul_packed_plain(x, qt.q, qt.scale, 1, torch.float32, False, O)
        assert torch.equal(out, want), seed


def test_w4a8_split_kernel_back_to_back_on_one_stream(cuda):
    """Two split launches queued with no synchronisation between them share
    the stream's workspace; each must see the counters the other left at 0."""
    C, O = 3072, 3072  # o_proj: three splits
    qt = _qmm_weights(cuda, "int4", C, O, 128, True)
    xa = torch.randn((12, C), device=cuda).bfloat16()
    xb = torch.randn((12, C), device=cuda).bfloat16()
    a = qmm.quantized_matmul_packed(xa, qt.q, qt.scale, 0, torch.float32, False, O)
    b = qmm.quantized_matmul_packed(xb, qt.q, qt.scale, 1, torch.float32, False, O)
    assert torch.equal(a, qmm.quantized_matmul_packed_plain(xa, qt.q, qt.scale, 0,
                                                            torch.float32, False, O))
    assert torch.equal(b, qmm.quantized_matmul_packed_plain(xb, qt.q, qt.scale, 1,
                                                            torch.float32, False, O))


# K9's shapes (chip_smoke.py phase 3): (C, O, group size, stacks, rows).
# The four down projections the routing rule keeps off K6 at decode (86, 76,
# 180, 86 groups), Llama-3.2-3B's flat gate_up at its 12 x 25 prefill, a tp 2
# rank's down shard at that prefill, and an interleaved gate_up (two stacks).
W4A16_SHAPES = {
    "qwen2.5-3b down": (11008, 2048, 128, 1, 12),
    "qwen3-4b down": (9728, 2560, 128, 1, 12),
    "falcon3-7b down": (23040, 3072, 128, 1, 12),
    "vicuna-7b down": (11008, 4096, 128, 1, 12),
    "llama-3.2-3b gate_up M300": (3072, 16384, 128, 1, 300),
    "llama-3.2-3b down tp2 M300": (4096, 3072, 128, 1, 300),
    "qwen2.5-3b gate_up interleaved M300": (2048, 11008, 128, 2, 300),
}


def _w4a16_case(dev, C, O, gs, stacks, M, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((stacks, C, O), generator=g, device=dev).mul_(0.02).bfloat16()
    qt = quantize(w, (1,), "int4", group_size=gs)
    x = torch.randn((M, C), generator=g, device=dev).bfloat16()
    return x, qt.q, qt.scale


def _w4a16_holds(got, want):
    """fp32: the same exact products summed in another order, within 1e-5
    of the largest output; after the cast to bf16, the repository's bf16
    limit."""
    rel = float((got - want).abs().max() / want.abs().max())
    return rel <= 1e-5 and _within(got.bfloat16(), want.bfloat16()), rel


@pytest.mark.parametrize("name", list(W4A16_SHAPES))
def test_w4a16_kernel_matches_plain(cuda, name):
    x, q, scale = _w4a16_case(cuda, *W4A16_SHAPES[name])
    before = qmm.launch_quantized_matmul_w4a16.launches
    got = qmm.quantized_matmul_w4a16(x, q, scale)
    again = qmm.quantized_matmul_w4a16(x, q, scale)
    assert qmm.launch_quantized_matmul_w4a16.launches == before + 2
    want = qmm.quantized_matmul_w4a16_plain(x, q, scale)
    assert got.shape == want.shape == (x.shape[0], q.shape[0], 2, q.shape[-1])
    ok, rel = _w4a16_holds(got, want)
    assert ok, rel
    assert torch.equal(got, again)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 33, 511])
@pytest.mark.parametrize("gs", [16, 48, 128])
def test_w4a16_kernel_matches_plain_at_every_row_count_and_group_size(cuda, M, gs):
    """Row tiles of 16 and 32, a partial last tile, groups of 16 (four in a
    chunk), 48 (chunks that start mid-group) and 128 rows; a stored width
    that is not a multiple of the block's 64 columns."""
    x, q, scale = _w4a16_case(cuda, 48 * gs, 1120, gs, 1, M)
    ok, rel = _w4a16_holds(qmm.quantized_matmul_w4a16(x, q, scale),
                           qmm.quantized_matmul_w4a16_plain(x, q, scale))
    assert ok, rel


def test_w4a16_kernel_replays_in_a_cuda_graph(cuda):
    """K9 split into clusters, captured once and replayed on new inputs:
    each replay gives the eager launch's bits."""
    C, O = 11008, 2048
    x, q, scale = _w4a16_case(cuda, C, O, 128, 1, 12)
    assert qmm.plan_w4a16(C, C // 128, O // 2, 1, 12, _sms(cuda))[1] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qmm.quantized_matmul_w4a16(x, q, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qmm.quantized_matmul_w4a16(x, q, scale)
    for seed in range(3):
        x.copy_(torch.randn((12, C), device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed)).bfloat16())
        graph.replay()
        assert torch.equal(out, qmm.quantized_matmul_w4a16(x, q, scale)), seed


def test_qeinsum_runs_w4a16_on_the_card_at_257_to_511_rows(cuda):
    """A layered packed weight at 300 rows (off K6) launches K9 once and
    equals the plain route's product in bf16."""
    from lite_llama_tpu_torch.quant import qtensor as tq

    qt = _qmm_weights(cuda, "int4", 1024, 1024, 128, False)
    x = torch.randn((300, 1024), device=cuda).bfloat16()
    k6, k9 = (qmm.launch_quantized_matmul_packed.launches,
              qmm.launch_quantized_matmul_w4a16.launches)
    got = tq.qeinsum(None, x, qt.at_layer(1))
    assert qmm.launch_quantized_matmul_w4a16.launches == k9 + 1
    assert qmm.launch_quantized_matmul_packed.launches == k6
    want = tq.qeinsum(None, x.cpu(), dataclasses.replace(qt, q=qt.q.cpu(), scale=qt.scale.cpu()
                                                         ).at_layer(1))
    assert _within(got.cpu(), want)


def test_w4a16_kernel_refuses_what_it_does_not_take(cuda):
    x, q, scale = _w4a16_case(cuda, 1024, 256, 16, 1, 12)
    with pytest.raises(ValueError, match="unsupported"):  # 512 rows: the dequantizing branch
        qmm.quantized_matmul_w4a16(torch.randn((512, 1024), device=cuda).bfloat16(), q, scale)
    with pytest.raises(ValueError, match="unsupported"):  # 8-row groups: no mma k-step
        _, q8, s8 = _w4a16_case(cuda, 1024, 256, 8, 1, 12)
        qmm.quantized_matmul_w4a16(x, q8, s8)
    with pytest.raises(ValueError, match="unsupported"):  # 120 byte columns: not 16-byte rows
        _, qo, so = _w4a16_case(cuda, 1024, 240, 16, 1, 12)
        qmm.quantized_matmul_w4a16(x, qo, so)
    with pytest.raises(ValueError, match="bf16"):
        qmm.quantized_matmul_w4a16(x.float(), q, scale)


def _quant_pool(dev, kv, Hkv, D, P, ps, seed=6):
    """A pool of two layers filled through the port's own prefill writes
    (real int8 values and scales, or saturated fp8), page ids shuffled."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = tkv.create_kv_cache(2, Hkv, D, P, page_size=ps, max_reqs=1, max_seq_len=P * ps,
                                device=dev, quantized=kv)
    table = torch.randperm(P, generator=g, device=dev).view(1, P).int()
    n = torch.tensor([P * ps], dtype=torch.int32, device=dev)
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    for layer in range(2):
        k = torch.randn((1, P * ps, Hkv, D), generator=g, device=dev).bfloat16()
        v = torch.randn((1, P * ps, Hkv, D), generator=g, device=dev).bfloat16()
        tkv.kv_write_prefill(cache.kv_pages, layer, k, v, table, z, n)
    return cache.kv_pages


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8)])
def test_quantized_pool_decode_kernel_matches_plain(cuda, kv, D, Nq, Hkv):
    g = torch.Generator(device=cuda).manual_seed(7)
    B, ps, P, ppr = 5, 16, 64, 8
    pool = _quant_pool(cuda, kv, Hkv, D, P, ps)
    lens = torch.tensor([0, 1, 16, 77, 128], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, Nq, D), generator=g, device=cuda).bfloat16()
    out, m, l = paged_flash_decode(q, pool, 1, table, lens, return_state=True)
    po, pm, pl = paged_decode_state_plain(q, pool.pages, ps, 1, table, lens, D**-0.5,
                                          pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(out[0] == 0)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8)])
def test_quantized_pool_chunked_prefill_kernel_matches_plain(cuda, kv, D, Nq, Hkv):
    g = torch.Generator(device=cuda).manual_seed(8)
    B, S, ps, P = 4, 128, 16, 200
    pool = _quant_pool(cuda, kv, Hkv, D, P, ps)
    ppr = 50
    start = torch.tensor([0, 16, 500, 700], dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, 70, 0, S], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    out, m, l = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    po, pm, pl = chunked_prefill_state_plain(q, k, v, clen, start, pool.pages, ps, 1, table,
                                             D**-0.5, pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)


def _shard_of(pool, hoff, hl):
    """Global kv heads [hoff, hoff + hl) of a whole int8 pool as a tp shard's
    pool: their channels, the whole scale slab (global lanes)."""
    D = pool.head_dim
    return KVPool(pool.pages[..., hoff * D:(hoff + hl) * D].contiguous(), pool.page_size, hl, D,
                  pool.scales, head_offset=hoff)


SHARDS = [(1, 2), (4, 4), (6, 2)]  # (head_offset, kv heads) of a shard of 8 kv heads


@pytest.mark.parametrize("hoff,hl", SHARDS)
def test_int8_pool_decode_kernel_at_a_head_offset_matches_plain(cuda, hoff, hl):
    """K1q on a tp shard of 2 or 4 of 8 kv heads (an odd offset splits the
    slab's aligned bf16 lane pair): the shard's heads read through their
    global scale lanes, as the plain version and the whole pool's kernel
    read them; the mirrored offset reads other lanes."""
    g = torch.Generator(device=cuda).manual_seed(17)
    B, ps, P, ppr, D = 5, 16, 64, 8, 128
    whole = _quant_pool(cuda, "int8", 8, D, P, ps)
    pool = _shard_of(whole, hoff, hl)
    lens = torch.tensor([0, 1, 16, 77, 128], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, 3 * 8, D), generator=g, device=cuda).bfloat16()
    ql = q[:, 3 * hoff:3 * (hoff + hl)].contiguous()
    out, m, l = paged_flash_decode(ql, pool, 1, table, lens, return_state=True)
    po, pm, pl = paged_decode_state_plain(ql, pool.pages, ps, 1, table, lens, D**-0.5,
                                          pool.scales, hoff)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    full = paged_flash_decode(q, whole, 1, table, lens)
    assert _within(out[1:], full[1:, 3 * hoff:3 * (hoff + hl)])
    wrong = paged_flash_decode(ql, pool, 1, table, lens, head_offset=(hoff + hl) % 8)
    assert not _within(wrong[1:], po[1:])


@pytest.mark.parametrize("hoff,hl", SHARDS)
def test_int8_pool_chunked_prefill_kernel_at_a_head_offset_matches_plain(cuda, hoff, hl):
    g = torch.Generator(device=cuda).manual_seed(18)
    B, S, ps, P, D = 4, 128, 16, 200, 128
    whole = _quant_pool(cuda, "int8", 8, D, P, ps)
    pool = _shard_of(whole, hoff, hl)
    ppr = 50
    start = torch.tensor([0, 16, 500, 700], dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, 70, 0, S], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, S, 3 * hl, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, hl, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, hl, D), generator=g, device=cuda).bfloat16()
    out, m, l = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    po, pm, pl = chunked_prefill_state_plain(q, k, v, clen, start, pool.pages, ps, 1, table,
                                             D**-0.5, pool.scales, hoff)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    wrong = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table,
                                  head_offset=(hoff + hl) % 8)
    assert not _within(wrong[2:], po[2:])


def test_int8_pool_kernels_refuse_scale_lanes_past_the_slab(cuda):
    whole = _quant_pool(cuda, "int8", 8, 128, 4, 16)
    pool = _shard_of(whole, 4, 4)
    q = torch.zeros((1, 12, 128), device=cuda).bfloat16()
    t = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_offset"):
        paged_flash_decode(q, pool, 0, t, one, head_offset=61)
    with pytest.raises(ValueError, match="head_offset"):
        flash_prefill_chunked(q[None], q[None, :, :4], q[None, :, :4], one, one, pool, 0, t,
                              head_offset=-1)


def test_quantized_pool_kernels_refuse_a_pool_without_its_scales(cuda):
    from lite_llama_tpu_torch.ops.attention_decode import launch_paged_decode_int8
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill_chunked_int8

    pool = _quant_pool(cuda, "int8", 8, 128, 4, 16)
    q = torch.zeros((1, 24, 128), device=cuda).bfloat16()
    t = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        launch_paged_decode_int8(q, pool.pages, 16, 0, t, one, 0.1)
    with pytest.raises(ValueError, match="scales"):
        launch_flash_prefill_chunked_int8(q[None], q[None, :, :8], q[None, :, :8], one, one,
                                          pool.pages, 16, 0, t, 0.1)
    with pytest.raises(ValueError, match="bf16"):  # a bf16 launcher handed an int8 pool
        launch_paged_decode(q, pool.pages, 16, 0, t, one, 0.1)


# ---------------------------------------------------------------------------
# Head dims other than 64 and 128: K8, and the padded K1 / K5 instances; and
# head dim 256 (Falcon3: K2, and K1 / K5's DP 256 instances)

HEAD_DIMS = [16, 40, 80, 96, 100, 112, 256]
GROUPS = [1, 3, 4, 8, 12, 16]  # 12 and 16: two n8 tiles of heads in K1
HKV = 3  # kv heads 0, 1, 2: an odd head starts at a 2 * D-byte offset


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_prefill_kernel_matches_plain(cuda, D, G):
    """K8 (ops.prefill_attention routes every head dim but 64, 128 and 256
    to it; 256 to K2) against its plain version on every valid row of
    ragged requests."""
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill_vmem

    g = torch.Generator(device=cuda).manual_seed(9)
    B, S, Nq = 3, 150, G * HKV
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, HKV, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, HKV, D), generator=g, device=cuda).bfloat16()
    lens = [150, 67, 1]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    k8, k2 = launch_flash_prefill_vmem.launches, launch_flash_prefill.launches
    got = ops.prefill_attention(q, k, v, sl)
    ran = (0, 1) if D in K2_HEAD_DIMS else (1, 0)
    assert (launch_flash_prefill_vmem.launches, launch_flash_prefill.launches) == (
        k8 + ran[0], k2 + ran[1])
    want = ref.prefill_attention(q, k, v, sl)
    for b, n in enumerate(lens):  # pad rows are never read
        assert _within(got[b, :n], want[b, :n]), b


@pytest.mark.parametrize("D,Nq,Hkv", [(128, 24, 8), (64, 32, 8), (64, 15, 5)])
def test_padded_prefill_template_equals_k2_where_nothing_is_padded(cuda, D, Nq, Hkv):
    """K8's launcher at D = 64 and 128 computes what K2's does, bit for bit
    (both launch the fresh instance of one template)."""
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill_vmem

    g = torch.Generator(device=cuda).manual_seed(10)
    B, S = 2, 100
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda).bfloat16()
    sl = torch.tensor([100, 37], dtype=torch.int32, device=cuda)
    a = launch_flash_prefill_vmem(q, k, v, sl, D**-0.5)
    b = launch_flash_prefill(q, k, v, sl, D**-0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1, :37], b[1, :37])


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_decode_kernel_matches_plain(cuda, kv, D, G):
    g = torch.Generator(device=cuda).manual_seed(11)
    B, ps, P, ppr = 5, 16, 48, 8
    pool = _quant_pool(cuda, kv, HKV, D, P, ps)
    lens = torch.tensor([0, 1, 16, 77, 128], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    q = torch.randn((B, G * HKV, D), generator=g, device=cuda).bfloat16()
    out, m, l = paged_flash_decode(q, pool, 1, table, lens, return_state=True)
    po, pm, pl = paged_decode_state_plain(q, pool.pages, ps, 1, table, lens, D**-0.5,
                                          pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(out[0] == 0)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_chunked_prefill_kernel_matches_plain(cuda, kv, D, G):
    """K5 / K5q at the padded head dims on out, m and l: histories of 0, 16,
    500 and 700 tokens under shuffled pages, a history-only walk and a
    request with neither history nor chunk."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, S, ps, P, ppr = 5, 96, 16, 240, 48
    pool = _quant_pool(cuda, kv, HKV, D, P, ps)
    start = torch.tensor([0, 16, 500, 700, 0], dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, 70, 0, S, 0], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: B * ppr].view(B, ppr).int()
    Nq = G * HKV
    q = torch.randn((B, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, S, HKV, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, S, HKV, D), generator=g, device=cuda).bfloat16()
    out, m, l = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    po, pm, pl = chunked_prefill_state_plain(q, k, v, clen, start, pool.pages, ps, 1, table,
                                             D**-0.5, pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    assert torch.all(m[4] == -1e30) and torch.all(l[4] == 0) and torch.all(out[4] == 0)


# Fresh prefill (K2 / K8): the no-history instance of K5's template

FRESH_DIMS = [16, 40, 64, 80, 96, 100, 128, 256]


def _fresh_inputs(dev, D, G, S, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Nq = len(lens), G * HKV
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, HKV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, HKV, D), generator=g, device=dev).bfloat16()
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("S", [1, 63, 65, 2048])
@pytest.mark.parametrize("G", [*range(1, 9), 12, 16])
@pytest.mark.parametrize("D", FRESH_DIMS)
def test_fresh_prefill_kernel_matches_plain(cuda, D, G, S):
    """ops.prefill_attention (K2 at D 64 / 128 / 256, K8 at the others)
    against its plain version on every valid row: requests of S tokens, of
    about 3/4 of S, of one token and of none; two calls give equal bytes."""
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill_vmem

    lens = [S, S * 3 // 4 + 1, 1, 0]
    q, k, v, sl = _fresh_inputs(cuda, D, G, S, lens, 15)
    fresh = launch_flash_prefill if D in K2_HEAD_DIMS else launch_flash_prefill_vmem
    before = fresh.launches
    got = ops.prefill_attention(q, k, v, sl)
    assert fresh.launches == before + 1
    again = ops.prefill_attention(q, k, v, sl)
    want = ref.prefill_attention(q, k, v, sl)
    for b, n in enumerate(lens):  # pad rows are never read
        assert _within(got[b, :n], want[b, :n]), b
        assert torch.equal(got[b, :n], again[b, :n]), b


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", [64, 100, 128, 256])
def test_fresh_prefill_equals_chunked_prefill_with_no_history(cuda, D, G):
    """Fresh prefill (K2 / K8) equals K5 on the same batch with start_pos = 0
    over a pool of random pages, bit for bit on every valid row: chunked and
    single-shot prefill agree by construction."""
    S, ps = 300, 16
    lens = [300, 129, 64, 1, 0]
    q, k, v, sl = _fresh_inputs(cuda, D, G, S, lens, 16)
    B = len(lens)
    P = 8 * B
    pages = torch.randn((2, 2, P * ps, HKV * D), device=cuda).bfloat16()
    table = torch.randperm(P, device=cuda).view(B, 8).int()
    zero = torch.zeros(B, dtype=torch.int32, device=cuda)
    got = ops.prefill_attention(q, k, v, sl)
    want, _, _ = launch_flash_prefill_chunked(q, k, v, sl, zero, pages, ps, 1, table, D**-0.5)
    for b, n in enumerate(lens):
        assert torch.equal(got[b, :n], want[b, :n]), b


# K5 / K5q: packed GQA rows over the K/V ring (csrc/flash_prefill_chunked.cu)

CHUNK_DIMS = [64, 100, 128, 256]


def _chunked_against_plain(dev, kv, D, G, S, starts, clens, page_size, seed):
    """K5 / K5q on random q, k, v over a pool of HKV kv heads with shuffled
    page ids, against its plain version on out, m and l for every row; two
    calls give equal bytes (no atomics). Returns (out, m, l)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(starts)
    ppr = -(-(max(starts) + S) // page_size)
    P = B * ppr
    pool = _quant_pool(dev, kv, HKV, D, P, page_size)
    table = torch.randperm(P, generator=g, device=dev).view(B, ppr).int()
    Nq = G * HKV
    q = torch.randn((B, S, Nq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, HKV, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, HKV, D), generator=g, device=dev).bfloat16()
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    clen = torch.tensor(clens, dtype=torch.int32, device=dev)
    out, m, l = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    again = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    assert all(torch.equal(x, y) for x, y in zip(again, (out, m, l)))
    po, pm, pl = chunked_prefill_state_plain(q, k, v, clen, start, pool.pages, page_size, 1,
                                             table, D**-0.5, pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    return out, m, l


@pytest.mark.parametrize("page_size", [7, 16, 80])
@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", CHUNK_DIMS)
def test_chunked_prefill_kernel_matches_plain_over_groups_and_pages(cuda, D, G, kv, page_size):
    """Histories of 0, 16, 500 and 1536 tokens through pages of 7, 16 and 80
    tokens (one larger than a 64-key tile); a 75-position chunk, so the
    last q tile of 128 packed rows straddles the chunk's end, of lengths 75,
    45 (not a multiple of a q tile) and 0 (a history-only walk); and a
    request with neither history nor chunk."""
    out, m, l = _chunked_against_plain(cuda, kv, D, G, 75, [0, 16, 500, 1536, 0],
                                       [75, 45, 0, 75, 0], page_size, 13)
    assert torch.all(m[4] == -1e30) and torch.all(l[4] == 0) and torch.all(out[4] == 0)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", CHUNK_DIMS)
def test_chunked_prefill_kernel_matches_plain_at_the_prefix_hit_shape(cuda, D, G, kv, rows):
    """A 1- or 8-row chunk over histories of 1536, 256 and 16 tokens (a
    prefix hit), beside an empty request."""
    out, m, l = _chunked_against_plain(cuda, kv, D, G, rows, [1536, 256, 16, 0],
                                       [rows, rows, rows, 0], 16, 14)
    assert torch.all(m[3] == -1e30) and torch.all(l[3] == 0) and torch.all(out[3] == 0)


@pytest.mark.parametrize("D,G", [(99, 2), (130, 2), (8, 2), (254, 2), (258, 2), (128, 17),
                                 (256, 17)])
def test_attention_kernels_refuse_head_dims_they_do_not_take(cuda, D, G):
    """Odd, too wide (130 to 254, past 256) or too narrow head dims, and
    more than 16 query heads per kv head, raise on the card: nothing falls
    back to a plain version."""
    q = torch.zeros((1, 4, G, D), device=cuda).bfloat16()
    kv = torch.zeros((1, 4, 1, D), device=cuda).bfloat16()
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        ops.prefill_attention(q, kv, kv, one)
    pool = KVPool(torch.zeros((1, 2, 16, D), device=cuda).bfloat16(), 16, 1, D)
    t = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        paged_flash_decode(q[:, 0], pool, 0, t, one)
    with pytest.raises(ValueError, match="unsupported"):
        flash_prefill_chunked(q, kv, kv, one, one, pool, 0, t)


def test_prefill_at_head_dim_100_runs_k8_and_never_the_plain_version(cuda, monkeypatch):
    from lite_llama_tpu_torch.ops.attention_prefill import launch_flash_prefill_vmem

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "prefill_attention", no_plain)
    q = torch.randn((2, 40, 32, 100), device=cuda).bfloat16()
    kv = torch.randn((2, 40, 32, 100), device=cuda).bfloat16()
    before = launch_flash_prefill_vmem.launches
    out = ops.prefill_attention(q, kv, kv, torch.tensor([40, 9], device=cuda))
    torch.cuda.synchronize()
    assert launch_flash_prefill_vmem.launches == before + 1
    assert out.shape == q.shape and bool(torch.isfinite(out[1, :9]).all())


# ---------------------------------------------------------------------------
# K1 / K1q's split KV walk: lengths around every page and split edge, page
# sizes that divide no span, G 1-8, serving's width, determinism and graphs


def _decode_against_plain(dev, kv, D, G, lens, ps, ppr, seed, Hkv=HKV):
    """K1 / K1q on a table ``ppr`` pages wide (zeros past each request's
    pages, as the engine leaves them) against the plain version; returns
    (out, m, l) and the inputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    used = [-(-n // ps) for n in lens]
    P = sum(used) + 1
    pool = _quant_pool(dev, kv, Hkv, D, P, ps, seed)
    perm = torch.randperm(P, generator=g, device=dev).int()
    table = torch.zeros((B, ppr), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(used):
        table[b, :n] = perm[at: at + n]
        at += n
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, G * Hkv, D), generator=g, device=dev).bfloat16()
    out, m, l = paged_flash_decode(q, pool, 1, table, kv_lens, return_state=True)
    po, pm, pl = paged_decode_state_plain(q, pool.pages, ps, 1, table, kv_lens, D**-0.5,
                                          pool.scales)
    assert _within(out, po)
    assert torch.allclose(m, pm, rtol=1e-3, atol=1e-3)
    assert torch.allclose(l, pl, rtol=1e-3, atol=1e-6)
    empty = kv_lens == 0
    assert torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
    assert torch.all(out[empty] == 0)
    return (out, m, l), (q, pool, table, kv_lens)


def _edge_lens(ps, ppr):
    """0, 1, around one page, around the edges of the least span (where a
    request's split count changes) and its multiples up to s_max of them,
    around s_max spans plus a page, and the table's reach."""
    plan = plan_decode_splits(ppr, ps)
    reach = ppr * ps
    span = plan.min_span * ps
    edges = {0, 1, ps - 1, ps, ps + 1, reach - 1, reach}
    for k in (1, 2, 3, plan.s_max - 1, plan.s_max):
        edges.update(k * span + d for d in (-1, 0, 1))
    edges.update(plan.s_max * span + ps + d for d in (-1, 0, 1))
    return sorted(n for n in edges if 0 <= n <= reach)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("ps", [16, 7])
@pytest.mark.parametrize("D,G", [(128, 3), (100, 1), (64, 4), (256, 3), (128, 12)])
def test_decode_kernel_matches_plain_around_page_and_split_edges(cuda, D, G, ps, kv):
    """The engine's table width (2048 tokens), a request at each edge
    length, in one batch (where the slots' shares set the long requests'
    splits) and each alone (where the least span sets them); page size 7
    divides no span of the plan."""
    ppr = -(-2048 // ps)
    lens = _edge_lens(ps, ppr)
    plan = plan_decode_splits(ppr, ps)
    dtype = {False: torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]
    slots = decode_grid_slots(D, dtype, len(lens), HKV, plan.s_max, G)
    spans = decode_spans(lens, ps, plan.s_max, plan.min_span, slots)
    assert max(len(s) for s in spans) > 2  # the walk really splits
    _decode_against_plain(cuda, kv, D, G, lens, ps, ppr, 15)
    for n in lens:
        _decode_against_plain(cuda, kv, D, G, [n], ps, ppr, 15)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("G", [*range(1, 9), 12, 16])
@pytest.mark.parametrize("D", [16, 64, 80, 98, 100, 128, 256])
def test_decode_kernel_matches_plain_at_every_group_and_head_dim(cuda, D, G, kv):
    """One-token, one-page, split and empty requests on a 1024-token table."""
    _decode_against_plain(cuda, kv, D, G, [0, 1, 16, 77, 300, 1000], 16, 64, 16)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
def test_decode_kernel_matches_plain_at_serving_width(cuda, kv):
    """Serving decodes all 64 slots: 8 of 1,820 tokens, 56 empty
    (Llama-3.2-3B's heads)."""
    lens = [1820] * 8 + [0] * 56
    _decode_against_plain(cuda, kv, 128, 3, lens, 16, 128, 17, Hkv=8)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("ps,ppr", [(16, 8), (16, 4), (7, 2), (80, 1), (16, 9), (80, 3)])
def test_decode_kernel_matches_plain_on_narrow_tables(cuda, ps, ppr, kv):
    """Tables that reach one least span or less never split (s_max 1),
    down to a reach shorter than one chunk of the ring; nine pages of 16 is
    the narrowest table that splits, and three pages of 80 split into spans
    of three chunks (the ring refills)."""
    reach = ps * ppr
    plan = plan_decode_splits(ppr, ps)
    assert (plan.s_max == 1) == (ppr <= plan.min_span)
    lens = sorted({0, 1, ps - 1, ps, ps + 1, reach // 2, reach - 1, reach} & set(range(reach + 1)))
    _decode_against_plain(cuda, kv, 128, 3, lens, ps, ppr, 18)
    for n in lens:
        _decode_against_plain(cuda, kv, 128, 3, [n], ps, ppr, 18)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
@pytest.mark.parametrize("B", [257, 600])
def test_decode_kernel_matches_plain_past_one_scan_group(cuda, B, kv):
    """Batches past the item scan's group of 256 requests (the engine's
    ``max_reqs`` may be set that high): long, short and empty requests in
    every group, so the item list and the empty requests cross groups."""
    lens = [(0, 1, 300, 17, 0, 1000, 64)[b % 7] for b in range(B)]
    _decode_against_plain(cuda, kv, 64, 2, lens, 16, 64, 22, Hkv=2)


@pytest.mark.parametrize("kv", [False, "int8", "fp8"])
def test_decode_kernel_result_of_a_request_holds_when_its_batch_changes(cuda, kv):
    """The device splits a request by its share of the launch's pages, so
    the last bits of its result depend on the other lengths of its batch:
    its out, m and l stay within the plain version's tolerance of their
    values with the request alone, beside short requests, beside long ones
    that take most of the grid, and at serving's width."""
    ps, ppr, Hkv, D, G = 16, 128, 8, 128, 3
    P = 8 * ppr
    pool = _quant_pool(cuda, kv, Hkv, D, P, ps, seed=23)
    g = torch.Generator(device=cuda).manual_seed(23)
    table = torch.randperm(P, generator=g, device=cuda).int().view(8, ppr)
    q = torch.randn((8, G * Hkv, D), generator=g, device=cuda).bfloat16()
    alone = None
    for others in ([], [88] * 11, [2048] * 7, [1820] * 7 + [0] * 56):
        B = 1 + len(others)
        rows = torch.arange(B, device=cuda) % 8
        kv_lens = torch.tensor([1820] + others, dtype=torch.int32, device=cuda)
        got = paged_flash_decode(q[rows], pool, 1, table[rows].contiguous(), kv_lens,
                                 return_state=True)
        got = tuple(x[:1] for x in got)
        if alone is None:
            alone = got
            want = paged_decode_state_plain(q[:1], pool.pages, ps, 1, table[:1], kv_lens[:1],
                                            D**-0.5, pool.scales)
            assert _within(got[0], want[0])
        assert _within(got[0], alone[0]), others
        assert torch.allclose(got[1], alone[1], rtol=1e-3, atol=1e-3)
        assert torch.allclose(got[2], alone[2], rtol=1e-3, atol=1e-6)


def test_decode_kernel_is_bit_identical_across_launches(cuda):
    (out, m, l), (q, pool, table, kv_lens) = _decode_against_plain(
        cuda, False, 128, 3, [1820] * 4 + [0, 5, 88, 2048], 16, 128, 19, Hkv=8)
    for _ in range(2):
        o2, m2, l2 = paged_flash_decode(q, pool, 1, table, kv_lens, return_state=True)
        assert torch.equal(out, o2) and torch.equal(m, m2) and torch.equal(l, l2)


def test_decode_kernel_replays_in_a_cuda_graph(cuda):
    """K1 split over blocks, captured once and replayed three times on new
    queries: each replay is bit-equal to an eager launch, so the counters
    the last split resets are ready for the next replay."""
    _, (q, pool, table, kv_lens) = _decode_against_plain(
        cuda, False, 128, 3, [1820] * 8 + [0] * 8, 16, 128, 20, Hkv=8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_flash_decode(q, pool, 1, table, kv_lens, return_state=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, m, l = paged_flash_decode(q, pool, 1, table, kv_lens, return_state=True)
    for seed in range(3):
        q.copy_(torch.randn(q.shape, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed)).bfloat16())
        graph.replay()
        want = paged_flash_decode(q, pool, 1, table, kv_lens, return_state=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((out, m, l), want)), seed


# ---------------------------------------------------------------------------
# Context parallelism: each rank runs K1 / K5 over its half of the pool
# (parallel/context_parallel.py); the halves' states combine to the whole.


def _cp_halves(pool, P):
    """The two halves of a pool as two context ranks hold them."""
    from dataclasses import replace

    ps, loc = pool.page_size, P // 2
    return [replace(pool, pages=pool.pages[:, :, c * loc * ps:(c + 1) * loc * ps].contiguous(),
                    scales=None if pool.scales is None
                    else pool.scales[:, c * loc * ps:(c + 1) * loc * ps].contiguous(),
                    page_offset=c * loc, total_pages=P) for c in (0, 1)]


def _tail_on_both(table, lens, ps, loc, c):
    """A planted fault: rank c's view with the tail page counted whether it
    owns it or not (a page of its own read in its place)."""
    from lite_llama_tpu_torch.parallel.context_parallel import local_page_view

    pt, ln = local_page_view(table, lens, ps, loc, c)
    n = (lens + ps - 1) // ps
    tail = table.gather(1, (n - 1).clamp(min=0).long()[:, None])[:, 0]
    foreign = (n > 0) & ((tail < c * loc) | (tail >= (c + 1) * loc))
    slot = (ln // ps).long()
    pt = pt.clone()
    pt.scatter_(1, slot[:, None].clamp(max=pt.shape[1] - 1),
                (tail - c * loc).clamp(0, loc - 1)[:, None].int())
    extra = lens - (n - 1) * ps
    return pt, torch.where(foreign, ln + extra, ln).int()


@pytest.mark.parametrize("kv", [False, "int8"])
def test_cp_halves_of_a_pool_combine_to_the_whole_decode(cuda, kv):
    """K1 / K1q with ``return_state`` on each half's compacted view, under a
    split plan (a 64-page table), with a request whose pages all lie in half
    0 (kv_len 0 on half 1) and an empty one: each half matches its plain
    version, the combined halves match the whole pool's call, and the tail
    page counted on both halves does not."""
    from lite_llama_tpu_torch.ops.attention_decode import combine_decode_splits
    from lite_llama_tpu_torch.parallel.context_parallel import local_page_view

    g = torch.Generator(device=cuda).manual_seed(31)
    D, Nq, Hkv, ps, P, ppr = 128, 24, 8, 16, 192, 64
    pool = _quant_pool(cuda, kv, Hkv, D, P, ps)
    lens = torch.tensor([1000, 999, 600, 40, 0], dtype=torch.int32, device=cuda)
    perm = torch.randperm(P, generator=g, device=cuda).int()
    table = torch.zeros((5, ppr), dtype=torch.int32, device=cuda)
    low = perm[perm < P // 2]
    table[3, :3] = low[:3]  # request 3 in half 0 only
    rest = perm[~torch.isin(perm, low[:3])]
    for b, n in enumerate([63, 63, 38]):
        table[b, :n] = rest[:n]
        rest = rest[n:]
    q = torch.randn((5, Nq, D), generator=g, device=cuda).bfloat16()
    whole = paged_flash_decode(q, pool, 1, table, lens, return_state=True)
    states, faulty = [], []
    for c, half in enumerate(_cp_halves(pool, P)):
        pt, ln = local_page_view(table, lens, ps, P // 2, c)
        st = paged_flash_decode(q, half, 1, pt, ln, return_state=True)
        po, pm, pl = paged_decode_state_plain(q, half.pages, ps, 1, pt, ln, D**-0.5, half.scales)
        assert _within(st[0], po) and torch.allclose(st[2], pl, rtol=1e-3, atol=1e-6)
        states.append(st)
        faulty.append(paged_flash_decode(q, half, 1, *_tail_on_both(table, lens, ps, P // 2, c),
                                         return_state=True))
    assert int(local_page_view(table, lens, ps, P // 2, 1)[1][3]) == 0
    out, m, l = combine_decode_splits(states)
    assert torch.isfinite(out).all() and _within(out, whole[0])
    assert torch.allclose(l, whole[2], rtol=1e-3, atol=1e-6)
    assert not _within(combine_decode_splits(faulty)[0], whole[0])


@pytest.mark.parametrize("kv", [False, "int8"])
def test_cp_halves_of_a_pool_combine_to_the_whole_chunked_prefill(cuda, kv):
    """K5 / K5q with ``return_state``: half 0 scores the chunk over its
    history, half 1 walks its history at chunk_lens 0; combined they match
    the whole pool's call, and the chunk scored on both halves does not."""
    from lite_llama_tpu_torch.ops.attention_decode import combine_decode_splits
    from lite_llama_tpu_torch.parallel.context_parallel import local_page_view

    g = torch.Generator(device=cuda).manual_seed(32)
    D, Nq, Hkv, ps, P, S = 128, 24, 8, 16, 200, 128
    pool = _quant_pool(cuda, kv, Hkv, D, P, ps)
    start = torch.tensor([0, 16, 700, 790], dtype=torch.int32, device=cuda)
    clen = torch.tensor([S, 70, 0, S], dtype=torch.int32, device=cuda)
    table = torch.randperm(P, generator=g, device=cuda)[: 4 * 50].view(4, 50).int()
    q = torch.randn((4, S, Nq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((4, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((4, S, Hkv, D), generator=g, device=cuda).bfloat16()
    whole = flash_prefill_chunked(q, k, v, clen, start, pool, 1, table, return_state=True)
    halves = _cp_halves(pool, P)
    states = []
    for c, half in enumerate(halves):
        pt, hist = local_page_view(table, start, ps, P // 2, c)
        cl = clen if c == 0 else torch.zeros_like(clen)
        st = flash_prefill_chunked(q, k, v, cl, hist, half, 1, pt, return_state=True)
        po, _, pl = chunked_prefill_state_plain(q, k, v, cl, hist, half.pages, ps, 1, pt,
                                                D**-0.5, half.scales)
        assert _within(st[0], po) and torch.allclose(st[2], pl, rtol=1e-3, atol=1e-6)
        states.append(st)
    out, _, _ = combine_decode_splits(states)
    assert torch.isfinite(out).all() and _within(out, whole[0])
    pt, hist = local_page_view(table, start, ps, P // 2, 1)
    twice = flash_prefill_chunked(q, k, v, clen, hist, halves[1], 1, pt, return_state=True)
    assert not _within(combine_decode_splits([states[0], twice])[0], whole[0])


def test_prefill_async_returns_before_its_device_work_ends(cuda):
    """C5: with the device held by a sleep kernel queued first, a prefill of
    prompts longer than prefill_chunk (three full chunks, their step made
    first, as the scheduler makes it) returns at dispatch (an event
    recorded after the sleep not yet complete), and its first tokens and
    logprobs equal those of an engine whose chunk steps run eagerly."""
    import numpy as np

    from lite_llama_tpu_torch.config import LlamaConfig
    from lite_llama_tpu_torch.executor.engine import InferenceEngine
    from lite_llama_tpu_torch.generation.sampling import SamplingParams
    from lite_llama_tpu_torch.models.decoder import init_decoder_params
    from tests.torch_decode_steps import eager_chunk_steps

    cfg = LlamaConfig(hidden_size=512, intermediate_size=1024, num_hidden_layers=4,
                      num_attention_heads=8, num_key_value_heads=2, head_dim=64,
                      vocab_size=1024, max_seq_len=1024, dtype=torch.bfloat16)
    params = init_decoder_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = [rng.integers(0, 1024, 300).tolist() for _ in range(4)]
    lens = [len(p) + 1 for p in batch]
    samp = SamplingParams.make(4, temperature=0.0, device="cpu")
    outs = []
    for eager in (True, False):
        eng = InferenceEngine(cfg, params, device=cuda, prefill_chunk=128, page_size=16,
                              max_reqs=8, num_pages=256)
        eng.chunk_step_for(4, 128)
        with eager_chunk_steps(eng) if eager else contextlib.nullcontext():
            slots = eng.admit_requests(lens)
            torch.cuda.synchronize()
            busy = None
            if not eager:
                torch.cuda._sleep(int(2e9))
                slept = torch.cuda.Event()
                slept.record()
            bundle = eng.prefill_async(batch, samp, slots)
            if not eager:
                busy = not slept.query()
            tok, _, _, lp = eng.prefill_collect(bundle)
            eng.release_slots(slots, lens)
        outs.append((tok, lp.view(np.int32), busy))
    (t0, l0, _), (t1, l1, busy) = outs
    assert busy, "prefill_async waited for the device"
    assert np.array_equal(t0, t1) and np.array_equal(l0, l1)
