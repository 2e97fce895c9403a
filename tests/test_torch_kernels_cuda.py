"""The port's hand-written kernels against their plain PyTorch versions on
the card, in bf16, at Llama-3.2-3B (D=128, Nq=24, Hkv=8) and Llama-3.2-1B
(D=64, Nq=32, Hkv=8) head shapes, plus the refusals that keep the card off
the plain code. This file imports no JAX, so it runs on a machine with a
card and without JAX:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerance on the card: |kernel - plain| <= 1e-2 + 1e-2 * |plain| for bf16
outputs (one bf16 step is 2^-8 relative; the kernels and the plain versions
round q, P and the output at different points). chip_smoke.py runs the same
comparisons at the main path's full shapes.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")

from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.executor.kv_cache import KVPool  # noqa: E402
from lite_llama_tpu_torch.ops import _build, norms, ref  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import (  # noqa: E402
    launch_paged_decode,
    paged_decode_state_plain,
    paged_flash_decode,
)
from lite_llama_tpu_torch.ops.attention_prefill import (  # noqa: E402
    chunked_prefill_state_plain,
    flash_prefill_chunked,
    launch_flash_prefill,
    launch_flash_prefill_chunked,
)


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
    lib = _build.library("flash_prefill", "entry_a", a)
    assert _build.library("flash_prefill", "entry_b", b) is lib
    assert lib.entry_a.argtypes == a and lib.entry_b.argtypes == b
    assert lib.entry_a.restype is ctypes.c_int and lib.entry_b.restype is ctypes.c_int
    assert lib.error_string.restype is ctypes.c_char_p
    _build.library("flash_prefill", "entry_a", b)  # declared once, not redeclared
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
