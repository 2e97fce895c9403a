"""The port's quantization (lite_llama_tpu_torch/quant/qtensor.py) against
the JAX package on the CPU, with the same numpy weights:

1. ``quantize`` gives the JAX quantizer's bytes and scales bit for bit
   (int8, fp8 e4m3, packed int4 per-channel and grouped, riffle and
   classic, the lane-alignment pad of a wide output), and ``dequant`` the
   same values; ``quantize_decoder_params`` the same tree, riffle fusion and
   the quantized tied head included, and a JAX tree carried across through
   ``params_from_numpy`` equals the port's own quantization;
2. ``qeinsum``: the W4A16 dual dot (small-M grouped, M >= 512 grouped,
   per-channel) against JAX's, and the layered routing at M <= 256 (the
   plain W4A8, K6's CPU path) against JAX's Pallas kernel in interpret mode;
3. decoder logits of quantized models (llama tied and untied, qwen2; int4
   riffle, int4 classic fused by the engine, int8 and fp8 weights) with
   int8 and fp8 KV pools against the JAX decoder, and one W4A8 model whose
   every projection rides K6's plain version against JAX's kernel path;
4. greedy tokens of the port's engine against the JAX engine with int4
   riffle g16 weights and an int8 KV pool, in fp32.

Tolerances: bit-equal for bytes, scales and dequantized weights; 1e-5 for
fp32 matmuls (summation order); 1e-4 of the largest logit for W4A16 and
weight-only decoder logits, as for the unquantized decoder; 1e-5 for the
one-layer W4A8 model (see its test for why one layer: its activations are
quantized to int8 per row, and an activation that differs by one fp32 ulp
between the frameworks can flip one int8 rounding).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama  # noqa: E402
from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.ops import ref as jref  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.ops.qmatmul import activations  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _configs, _jax_tree, numpy_params  # noqa: E402

JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "int4": jnp.int4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _tbits(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def _same_qtensor(t, j):
    np.testing.assert_array_equal(_tbits(t.q), _bits(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.unit_shape, t.out_shape, t.packed, t.riffle_groups, t.fused_tp) == (
        tuple(j.unit_shape), tuple(j.out_shape), j.packed, j.riffle_groups, j.fused_tp)


def _numpy_qtree(jtree):
    """A JAX tree as numpy, its QTensors as the port's QTensor with numpy
    fields (fp8 q as its uint8 bits): what params_from_numpy takes."""
    if isinstance(jtree, jq.QTensor):
        return tq.QTensor(q=_bits(jtree.q), scale=np.asarray(jtree.scale),
                          unit_shape=tuple(jtree.unit_shape), out_shape=tuple(jtree.out_shape),
                          packed=jtree.packed, riffle_groups=jtree.riffle_groups,
                          fused_tp=jtree.fused_tp)
    if isinstance(jtree, dict):
        return {k: _numpy_qtree(v) for k, v in jtree.items()}
    return np.asarray(jtree)


# ---------------------------------------------------------------------------
# 1. Bytes and scales


QUANT_CASES = [  # (shape, contract axes, qdtype, group_size, riffle_blocks)
    ((3, 64, 4, 8), (1,), "int8", None, 0),
    ((3, 64, 4, 8), (1,), "fp8", None, 0),
    ((3, 64, 4, 8), (1,), "int4", None, 0),
    ((3, 64, 4, 8), (1,), "int4", 16, 0),
    ((3, 64, 4, 8), (1,), "int4", 16, 1),
    ((2, 4, 16, 32), (1, 2), "int8", 16, 0),
    ((64, 8448), (0,), "int4", 32, 1),  # padded: 4224 bytes -> 4608
    ((64, 8448), (0,), "int4", 16, 0),
]


@pytest.mark.parametrize("shape,axes,qdtype,gs,rb", QUANT_CASES)
def test_quantize_is_bit_equal_to_jax(shape, axes, qdtype, gs, rb):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(np.float32)
    j = jq.quantize(jnp.asarray(w), axes, JDT[qdtype], group_size=gs, riffle_blocks=rb)
    t = tq.quantize(torch.from_numpy(w), axes, qdtype, group_size=gs, riffle_blocks=rb)
    _same_qtensor(t, j)
    np.testing.assert_array_equal(t.dequant(torch.float32).numpy(),
                                  np.asarray(j.dequant(jnp.float32)))
    np.testing.assert_array_equal(_tbits(t.unpack()), _bits(j.unpack()))


def test_quantize_takes_torch_dtypes_and_refuses_tp_layouts():
    w = torch.randn(2, 32, 16)
    a = tq.quantize(w, (1,), torch.int8)
    b = tq.quantize(w, (1,), "int8")
    assert torch.equal(a.q, b.q) and a.q.dtype == torch.int8
    assert tq.quantize(w, (1,), torch.float8_e4m3fn).q.dtype == torch.float8_e4m3fn
    with pytest.raises(NotImplementedError):
        tq.quantize(w, (1,), "int4", riffle_blocks=2)
    with pytest.raises(ValueError):
        tq.quantize(w, (1,), "int5")
    p = {"layers": {"wq": w}, "embed": torch.randn(8, 4)}
    with pytest.raises(NotImplementedError):
        tq.quantize_decoder_params(p, "int4", sigma_ffn=True)
    with pytest.raises(NotImplementedError):
        tq.quantize_decoder_params(p, "int4", riffle=True, riffle_tp=2)


TREE_CASES = {  # name -> (config case, vocab, quantize_decoder_params kwargs)
    "llama_tied-int4-riffle-g16": ("llama_tied", 128, dict(qdtype="int4", group_size=16,
                                                           riffle=True)),
    "llama_untied-int4-g16": ("llama_untied", 128, dict(qdtype="int4", group_size=16)),
    "qwen2-int8": ("qwen2", 101, dict(qdtype="int8")),
    "llama_tied-fp8": ("llama_tied", 101, dict(qdtype="fp8")),
    "llama_tied-int4-odd-vocab": ("llama_tied", 101, dict(qdtype="int4", riffle=True)),
}


def _quantized_trees(name, seed=0):
    case, vocab, kw = TREE_CASES[name]
    jcfg, tcfg = _configs(case)
    jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    tcfg = dataclasses.replace(tcfg, vocab_size=vocab)
    npp = numpy_params(jcfg, seed=seed)
    jkw = dict(kw, qdtype=JDT[kw["qdtype"]])
    jp = jq.quantize_decoder_params(_jax_tree(npp), **jkw)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), **kw)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", list(TREE_CASES))
def test_quantize_decoder_params_matches_jax(name):
    _, tcfg, jp, tp = _quantized_trees(name)
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for key in ("lm_head",) if "lm_head" in jp else ():
        _same_qtensor(tp[key], jp[key])
    for k, jv in jp["layers"].items():
        if isinstance(jv, jq.QTensor):
            _same_qtensor(tp["layers"][k], jv)
        else:
            np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(jv))
    td, jd = tq.dequantize_tree(tp, torch.float32), jq.dequantize_tree(jp, jnp.float32)
    for k, jv in jd["layers"].items():
        np.testing.assert_array_equal(td["layers"][k].numpy(), np.asarray(jv), err_msg=k)
    # A JAX tree carried across equals the port's own quantization.
    carried = params_from_numpy(_numpy_qtree(jp), tcfg, device="cpu")
    for k, v in carried["layers"].items():
        if isinstance(v, tq.QTensor):
            _same_qtensor(v, jp["layers"][k])
            assert v.q.dtype == tp["layers"][k].q.dtype
        else:
            assert torch.equal(v, tp["layers"][k])
    if "lm_head" in jp:
        _same_qtensor(carried["lm_head"], jp["lm_head"])


def test_params_from_numpy_refuses_tp_layouts():
    _, tcfg = _configs("llama_tied")
    leaf = tq.QTensor(q=np.zeros((2, 4, 4), np.int8), scale=np.ones((2, 4), np.float32),
                      unit_shape=(4, 8), out_shape=(8,), packed=True, riffle_groups=2)
    with pytest.raises(NotImplementedError):
        params_from_numpy({"lm_head": leaf}, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# 2. qeinsum


def _qeinsum_case(M, C, O, gs, rb, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((2, C, O)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, C)).astype(np.float32)
    j = jq.quantize(jnp.asarray(w), (1,), jnp.int4, group_size=gs, riffle_blocks=rb)
    t = tq.quantize(torch.from_numpy(w), (1,), "int4", group_size=gs, riffle_blocks=rb)
    return x, j, t


@pytest.mark.parametrize("M", [3, 300, 600], ids=["M3", "M300-grouped-dots", "M600-dequant"])
@pytest.mark.parametrize("gs,rb", [(32, 0), (32, 1), (None, 1)])
def test_qeinsum_w4a16_matches_jax(M, gs, rb):
    """The unlayered dual dot (JAX's XLA path): grouped M < 512 (per-group
    dots), grouped M >= 512 (dequantize, one dot), per-channel."""
    x, j, t = _qeinsum_case(M, 128, 256, gs, rb)
    jw = jax.tree_util.tree_map(lambda a: a[1], j)
    tw = dataclasses.replace(t, q=t.q[1], scale=t.scale[1])
    want = jq.qeinsum("mc,co->mo", jnp.asarray(x), jw)
    got = tq.qeinsum("mc,co->mo", torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [4, 256, 300])
@pytest.mark.parametrize("gs,rb,O", [(32, 1, 256), (32, 0, 256), (None, 0, 256),
                                     (32, 1, 8448)])
def test_qeinsum_layered_routing_matches_jax(M, gs, rb, O):
    """Layer-indexed packed weights: M <= 256 at kernel shapes runs W4A8
    (the plain K6 here, JAX's Pallas kernel in interpret mode there), else
    the W4A16 dual dot on the sliced layer in both. O=8448 pads the stored
    width, which the kernel path must not write."""
    x, j, t = _qeinsum_case(M, 128, O, gs, rb, seed=M)
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        want = jq.qeinsum("mc,co->mo", jnp.asarray(x),
                          dataclasses.replace(j, layer=jnp.asarray(1, jnp.int32)))
    finally:
        jops.set_backend(prev)
    got = tq.qeinsum("mc,co->mo", torch.from_numpy(x), t.at_layer(1))
    assert got.shape == (M, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. Decoder logits


def _kernel_decode(q, kv_pool, layer, page_table, seq_lens, max_seq_len=None, sm_scale=None,
                   k_new=None, v_new=None):
    """JAX's decode dispatch with the Pallas kernel (interpret): the TPU path,
    which folds the newest token in at full precision (JAX's XLA reference
    rounds it into an fp8 pool's type first)."""
    return j_decode(q, kv_pool, layer, page_table, seq_lens, sm_scale, interpret=True,
                    k_new=k_new, v_new=v_new)


def _decode_steps(jp, tp, jcfg, tcfg, kv, tol, steps=3):
    """Prefill two prompts, then greedy-decode ``steps`` tokens through both
    decoders on ``kv`` pools; logits within ``tol`` of the largest, pools
    bit-equal after every write."""
    L, Hkv, D = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    PS, NP, MR = 4, 40, 4
    jc = jkv.create_kv_cache(L, Hkv, D, NP, page_size=PS, max_reqs=MR, max_seq_len=32,
                             dtype=jnp.float32, quantized=kv)
    tc = tkv.create_kv_cache(L, Hkv, D, NP, page_size=PS, max_reqs=MR, max_seq_len=32,
                             dtype=torch.float32, device="cpu", quantized=kv)
    rng = np.random.default_rng(1)
    lens = np.asarray([7, 12], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    slots = np.asarray([1, 3], np.int32)
    jc = jkv.alloc_prefill(jc, jnp.asarray(slots), jnp.asarray(lens))
    tkv.alloc_prefill(tc, torch.from_numpy(slots), torch.from_numpy(lens))

    def close(tl, jl, what):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=tol * np.abs(jl).max(),
                                   err_msg=what)

    def same_pool(jpool):
        np.testing.assert_array_equal(_tbits(tc.kv_pages.pages), _bits(jpool.pages))
        if kv == "int8":
            np.testing.assert_array_equal(tc.kv_pages.scales.float().numpy(),
                                          np.asarray(jpool.scales, np.float32))

    jctx = jdec.AttnContext(jc.page_table[jnp.asarray(slots)], jnp.asarray(lens),
                            jnp.zeros(2, jnp.int32), jnp.asarray(lens))
    tctx = tdec.AttnContext(tc.page_table[torch.from_numpy(slots).long()],
                            torch.from_numpy(lens), torch.zeros(2, dtype=torch.int32),
                            torch.from_numpy(lens))
    jl, jpool = jdec.decoder_prefill(jp, jcfg, jc.kv_pages, jctx, input_ids=jnp.asarray(ids),
                                     last_only=True)
    tl, _ = tdec.decoder_prefill(tp, tcfg, tc.kv_pages, tctx, torch.from_numpy(ids).long(),
                                 last_only=True)
    close(tl, jl, "prefill")
    same_pool(jpool)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jslots, tslots = jnp.asarray(slots), torch.from_numpy(slots)
    for step in range(steps):
        jc = dataclasses.replace(jc, kv_pages=jpool)
        jc = jkv.alloc_decode(jc, jslots)
        tkv.alloc_decode(tc, tslots)
        seq = np.asarray(jc.seq_lens)[slots]
        jctx = jdec.AttnContext(jc.page_table[jslots], jnp.asarray(seq), jnp.asarray(seq - 1),
                                jnp.ones(2, jnp.int32))
        tctx = tdec.AttnContext(tc.page_table[tslots.long()], torch.from_numpy(seq),
                                torch.from_numpy(seq - 1), torch.ones(2, dtype=torch.int32))
        jl, jpool = jdec.decoder_decode(jp, jcfg, jc.kv_pages, jctx, jnp.asarray(tok))
        tl, _ = tdec.decoder_decode(tp, tcfg, tc.kv_pages, tctx, torch.from_numpy(tok).long())
        close(tl, jl, f"decode step {step}")
        same_pool(jpool)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


DECODER_CASES = [  # (tree case, engine-style QKV fusion, KV pool)
    ("llama_tied-int4-riffle-g16", False, "int8"),
    ("llama_untied-int4-g16", True, "int8"),
    ("qwen2-int8", False, "fp8"),
    ("llama_tied-fp8", False, "int8"),
]


@pytest.mark.parametrize("name,fuse,kv", DECODER_CASES)
def test_quantized_decoder_logits_match_jax(name, fuse, kv, monkeypatch):
    jcfg, tcfg, jp, tp = _quantized_trees(name, seed=2)
    if fuse:  # the engine's build-time fusion of packed wq/wkv
        jp, tp = jdec.fuse_qkv_params(jp), tdec.fuse_qkv_params(tp)
        _same_qtensor(tp["layers"]["wqkv"], jp["layers"]["wqkv"])
    if kv == "fp8":
        monkeypatch.setattr(jops, "paged_decode_attention", _kernel_decode)
    _decode_steps(jp, tp, jcfg, tcfg, kv, tol=1e-4)


def test_w4a8_decoder_matches_jax_kernel_path(monkeypatch):
    """Shapes at which every projection and the head take the W4A8 route
    (stored widths multiples of 128): the port's plain K6 against JAX's
    Pallas kernel in interpret mode; attention through both references.
    One layer: from the second layer on, one int8 activation rounding that
    flips on a 1-ulp difference moves this random model's logits by ~1 %
    (JAX's own W4A8 path moves 0.33 of 31 when its embedding is perturbed
    by 1e-6), which says nothing about the port."""
    base = dict(hidden_size=256, intermediate_size=128, num_hidden_layers=1,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=256,
                max_seq_len=32, tie_word_embeddings=True)
    jcfg, tcfg = JLlama(dtype=jnp.float32, **base), TLlama(dtype=torch.float32, **base)
    npp = numpy_params(jcfg, seed=5)
    jp = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=32, riffle=True)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), "int4",
                                    group_size=32, riffle=True)
    calls = []
    real = tq.quantized_matmul_packed
    monkeypatch.setattr(tq, "quantized_matmul_packed",  # x, or the norm's QuantizedRows
                        lambda *a, **k: calls.append(activations(a[0]).shape) or real(*a, **k))
    for name in ("prefill_attention", "chunked_prefill_attention"):
        monkeypatch.setattr(jops, name, getattr(jref, name))
    monkeypatch.setattr(jops, "paged_decode_attention", jref.paged_decode_attention)
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        _decode_steps(jp, tp, jcfg, tcfg, "int8", tol=1e-5, steps=2)
    finally:
        jops.set_backend(prev)
    # wqkv, o_proj, gate_up, down per layer and the head, prefill + 2 steps
    assert len(calls) == 3 * (4 * jcfg.num_hidden_layers + 1)


# ---------------------------------------------------------------------------
# 4. Engine


ENGINE_CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, vocab_size=97, max_seq_len=64,
                  eos_token_id=96)
ENGINE = dict(page_size=8, max_reqs=8, num_pages=64, decode_chunk=8)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19]]


def test_int4_riffle_int8kv_engine_greedy_matches_jax():
    """The JAX engine on its kernel path (Pallas in interpret mode: W4A8 for
    the gate_up matmul, whose stored width is 128, and the int8-pool
    attention kernels), as on the TPU; the port's CPU path is the kernels'
    plain versions, so it routes the same way."""
    jcfg = JLlama(dtype=jnp.float32, **ENGINE_CFG)
    tcfg = TLlama(dtype=torch.float32, **ENGINE_CFG)
    npp = numpy_params(jcfg, seed=11)
    jp = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=16, riffle=True)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), "int4",
                                    group_size=16, riffle=True)
    teng = InferenceEngine(tcfg, tp, device="cpu", kv_quant="int8", **ENGINE)
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        jeng = JEngine(jcfg, jp, kv_quant="int8", **ENGINE)
        want = JGen(jeng).generate_tokens(PROMPTS, max_gen_len=12, temperature=0.0,
                                          logprobs=True)
    finally:
        jops.set_backend(prev)
    assert teng.cache.kv_pages.quantized and teng.num_pages == jeng.num_pages
    got = TextGenerator(teng).generate_tokens(PROMPTS, max_gen_len=12, temperature=0.0,
                                              logprobs=True)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)


def test_engine_fuses_packed_qkv_and_takes_fp8_kv():
    tcfg = TLlama(dtype=torch.float32, **ENGINE_CFG)
    npp = numpy_params(tcfg, seed=3)
    tp = tq.quantize_decoder_params(params_from_numpy(npp, tcfg, device="cpu"), "int4",
                                    group_size=16)
    assert "wq" in tp["layers"]
    eng = InferenceEngine(tcfg, tp, device="cpu", kv_quant="fp8", **ENGINE)
    assert "wqkv" in eng.params["layers"] and "wq" not in eng.params["layers"]
    assert eng.cache.kv_pages.pages.dtype == torch.float8_e4m3fn
    assert eng.cache.kv_pages.scales is None
    outs = TextGenerator(eng).generate_tokens(PROMPTS, max_gen_len=6, temperature=0.0)
    assert all(1 <= len(o.token_ids) <= 6 for o in outs)
