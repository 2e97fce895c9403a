"""K3 (``rms_norm`` / ``skip_rms_norm``) and K4 (``swiglu``) of the port on
the CPU, where every wrapper runs its plain version, against the JAX
package with the same numpy inputs, and the int8 rows the two hand to K6:

1. the plain versions against ``lite_llama_tpu/ops/norms.py`` in interpret
   mode and ``lite_llama_tpu/ops/ref.py`` at widths the card's Triton K3
   refused (H > 4096) and at odd widths (fp32, tolerance 2e-5, as
   ``test_torch_ops.py::test_norms_and_swiglu_match_jax``);
2. their int8 rows equal ``_quantize_rows`` of their own output bit for
   bit, and ``qeinsum`` handed ``QuantizedRows`` equals ``qeinsum`` handed
   the activations bit for bit (K6's plain version on both);
3. the one-layer int4 decoder, whose norms now hand K6 their int8 rows,
   still matches JAX's kernel path at 1e-5; it sends int8 rows to wqkv,
   gate_up, down and the head, and plain rows to o_proj.

The kernels themselves run only on the card:
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold them
against these plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.ops import norms as jnorms  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.ops.qmatmul import QuantizedRows, _quantize_rows  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402
from tests.test_torch_quant import _decode_steps  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# 1. The plain versions against JAX


@pytest.mark.parametrize("shape", [(3, 8192), (2, 5000), (5, 100), (2, 3, 97), (4, 24)])
def test_norms_and_swiglu_match_jax_at_wide_and_odd_widths(shape):
    rng = np.random.default_rng(3)
    x, r, g, u = (rng.standard_normal(shape, np.float32) for _ in range(4))
    w = rng.standard_normal(shape[-1:], np.float32)
    jx, jr, jw, jg, ju = map(jnp.asarray, (x, r, w, g, u))

    got = ops.rms_norm(_t(x), _t(w), 1e-5)
    _close(got, jref.rms_norm(jx, jw, 1e-5))
    _close(got, jnorms.rms_norm(jx, jw, 1e-5, interpret=True))

    n, s = ops.skip_rms_norm(_t(x), _t(r), _t(w), 1e-5)
    jn, js = jnorms.skip_rms_norm(jx, jr, jw, 1e-5, interpret=True)
    _close(n, jn)
    _close(s, js)
    _close(n, jref.skip_rms_norm(jx, jr, jw, 1e-5)[0])

    got = ops.swiglu(_t(g), _t(u))
    _close(got, jref.swiglu(jg, ju))
    _close(got, jnorms.swiglu(jg, ju, interpret=True))


# ---------------------------------------------------------------------------
# 2. The int8 rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(12, 3072), (2, 3, 256), (5, 96)])
def test_int8_rows_are_quantize_rows_of_the_output(dtype, shape):
    g = torch.Generator().manual_seed(4)
    x, r, gate, up = (torch.randn(shape, generator=g).to(dtype) for _ in range(4))
    w = (1 + 0.1 * torch.randn(shape[-1:], generator=g)).to(dtype)
    H = shape[-1]
    for residual in (r, None):
        plain, res = ops.skip_rms_norm(x, residual, w, 1e-5)
        rows, res8 = ops.skip_rms_norm(x, residual, w, 1e-5, int8_rows=True)
        assert isinstance(rows, QuantizedRows) and torch.equal(res8, res)
        assert torch.equal(rows.x, plain)
        xi, xs = _quantize_rows(plain.reshape(-1, H))
        assert torch.equal(rows.xi, xi) and torch.equal(rows.xs, xs)
    plain = ops.swiglu(gate, up)
    rows = ops.swiglu(gate, up, int8_rows=True)
    assert torch.equal(rows.x, plain)
    xi, xs = _quantize_rows(plain.reshape(-1, H))
    assert torch.equal(rows.xi, xi) and torch.equal(rows.xs, xs)
    assert rows.xi.dtype == torch.int8 and rows.xs.dtype == torch.float32


def _packed(C, O, L=2, gs=32, riffle=True, seed=6):  # a stack of L layers
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((L, C, O), generator=g) * 0.05
    return tq.quantize(w, (1,), "int4", group_size=gs, riffle_blocks=int(riffle))


@pytest.mark.parametrize("M", [1, 12, 300])
@pytest.mark.parametrize("riffle", [True, False])
def test_qeinsum_of_quantized_rows_equals_qeinsum_of_the_activations(M, riffle):
    """At M <= 256 K6's plain version takes the int8 rows as they are; at
    300 rows the W4A16 dual dot takes the activations. Bit for bit either
    way."""
    qt = _packed(256, 512, riffle=riffle)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((M, 256), generator=g)
    normed, _ = ops.skip_rms_norm(x, None, torch.ones(256), int8_rows=True)
    assert tq.takes_int8_rows(qt.at_layer(1), M) == (M <= 256)
    for out_dtype in (None, torch.float32):
        want = tq.qeinsum(None, normed.x, qt.at_layer(1), out_dtype)
        got = tq.qeinsum(None, normed, qt.at_layer(1), out_dtype)
        assert torch.equal(got, want)
    # an unstacked packed head is read as layer 0 of a 1-deep stack
    head = tq.quantize(torch.randn((256, 512), generator=g) * 0.05, (0,), "int4",
                       group_size=32, riffle_blocks=1)
    assert head.n_stack == 0 and tq.takes_int8_rows(head, 12)
    assert not tq.takes_int8_rows(qt, 12)  # stacked and not read at a layer: W4A16
    assert not tq.takes_int8_rows(torch.zeros(256, 512), 12)


# ---------------------------------------------------------------------------
# 3. The decoder

W4A8_BASE = dict(hidden_size=256, intermediate_size=128, num_hidden_layers=1,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=256,
                 max_seq_len=32, tie_word_embeddings=True)


def _w4a8_trees(seed=5):
    jcfg, tcfg = JLlama(dtype=jnp.float32, **W4A8_BASE), TLlama(dtype=torch.float32, **W4A8_BASE)
    npp = numpy_params(jcfg, seed=seed)
    jp = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=32, riffle=True)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), "int4",
                                    group_size=32, riffle=True)
    return jcfg, tcfg, jp, tp


def _record_k6(monkeypatch, tp):
    """Every K6 call as (weight name, whether x came as QuantizedRows)."""
    names = {tp["lm_head"].q.data_ptr(): "lm_head"}
    names.update({w.q.data_ptr(): k for k, w in tp["layers"].items()
                  if isinstance(w, tq.QTensor)})
    calls = []
    real = tq.quantized_matmul_packed

    def spy(x, q, *a, **kw):
        calls.append((names[q.data_ptr()], isinstance(x, QuantizedRows)))
        return real(x, q, *a, **kw)

    monkeypatch.setattr(tq, "quantized_matmul_packed", spy)
    return calls


def test_w4a8_decoder_with_int8_rows_matches_jax_kernel_path(monkeypatch):
    """The one-layer W4A8 model of
    ``test_torch_quant.py::test_w4a8_decoder_matches_jax_kernel_path`` with
    its norms handing K6 their int8 rows: JAX's Pallas kernels (interpret
    mode) at 1e-5, prefill and two decode steps."""
    jcfg, tcfg, jp, tp = _w4a8_trees()
    calls = _record_k6(monkeypatch, tp)
    for name in ("prefill_attention", "chunked_prefill_attention"):
        monkeypatch.setattr(jops, name, getattr(jref, name))
    monkeypatch.setattr(jops, "paged_decode_attention", jref.paged_decode_attention)
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        _decode_steps(jp, tp, jcfg, tcfg, "int8", tol=1e-5, steps=2)
    finally:
        jops.set_backend(prev)
    assert len(calls) == 3 * 5 and sum(rows for _, rows in calls) == 3 * 4


def test_decoder_hands_int8_rows_to_wqkv_gate_up_down_and_the_head(monkeypatch):
    """A decode step and a prefill of the int4 riffle model: wqkv, gate_up,
    down and the head get the int8 rows of the norm or SwiGLU before them;
    o_proj, whose input is attention's output, gets plain rows (K6 quantizes
    them itself)."""
    _, tcfg, _, tp = _w4a8_trees()
    calls = _record_k6(monkeypatch, tp)
    cache = tkv.create_kv_cache(1, 2, 64, 16, page_size=4, max_reqs=2, max_seq_len=32,
                                dtype=torch.float32, device="cpu", quantized="int8")
    slots = torch.tensor([0, 1], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    tkv.alloc_prefill(cache, slots, lens)
    ids = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 0, 0]])
    ctx = tdec.AttnContext(cache.page_table[slots.long()], lens, torch.zeros_like(lens), lens)
    tdec.decoder_prefill(tp, tcfg, cache.kv_pages, ctx, ids, last_only=True)
    want = {"wqkv": True, "o_proj": False, "gate_up_proj": True, "down_proj": True,
            "lm_head": True}
    assert dict(calls) == want and len(calls) == 5
    calls.clear()
    tkv.alloc_decode(cache, slots)
    sl = cache.seq_lens[slots.long()]
    ctx = tdec.AttnContext(cache.page_table[slots.long()], sl, sl - 1, torch.ones_like(sl))
    tdec.decoder_decode(tp, tcfg, cache.kv_pages, ctx, torch.tensor([9, 10]))
    assert dict(calls) == want and len(calls) == 5


def test_decoder_asks_for_int8_rows_only_where_k6_runs():
    """bf16-style weights and W4A16 widths (over 256 rows) get no int8
    rows; the W4A8 model gets them at decode widths."""
    _, tcfg, _, tp = _w4a8_trees()
    assert tdec._int8_rows(tp, 12) == (True, True, True, True)
    assert tdec._int8_rows(tp, 300) == (False, False, False, False)
    plain = params_from_numpy(numpy_params(tcfg, seed=5), tcfg, device="cpu")
    assert tdec._int8_rows(plain, 12) == (False, False, False, False)
    int8 = tq.quantize_decoder_params(plain, "int8", group_size=32)
    assert tdec._int8_rows(int8, 12) == (False, False, False, False)
