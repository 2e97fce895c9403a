"""The port's tensor-parallel layouts and shards against the JAX package's,
on the CPU, on the same numpy weights:

1. ``fuse_qkv_params(tp=2)`` (plain, int8 and classic int4 QTensors, Qwen2's
   biases), ``quantize_decoder_params(riffle_tp=2)`` and ``(sigma_ffn,
   sigma_tp=2)`` are bit-equal to JAX's, dequantized trees too, and JAX's
   trees carried across by ``params_from_numpy`` are JAX's bits;
2. ``ShardingPolicy.shard_params`` gives each rank exactly the data of JAX's
   shard on the device of that rank (``make_mesh(tp=2)``), and a rank's
   pool holds its kv heads' channels and their global scale lanes;
3. every JAX refusal (a σ or riffle block count that is not the mesh's, a
   quantized unfused wkv, heads that do not divide) raises in the port;
4. the plain K1q / K5q at ``head_offset`` 4 (a shard of 4 of 8 kv heads,
   the other shard's scale lanes holding other values) against JAX's
   kernels in interpret mode;
5. tp-layout trees (riffle_tp=2, sigma_tp=2) run on one device give JAX's
   one-device tokens and logits;
6. the int4 g32 ``riffle_tp=2`` engine at tp 2 (two gloo ranks,
   tests/torch_tp_worker.py) on the W4A8 route (one layer, shapes at which
   every projection takes the kernel per shard) against JAX's manual-tp
   kernel wrapper (``ops.set_backend("pallas")``, interpret mode).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu.config import LlamaConfig as JLlama, Qwen2Config as JQwen2  # noqa: E402
from lite_llama_tpu.executor import kv_cache as jkv  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.ops.attention_decode import paged_flash_decode as j_decode  # noqa: E402
from lite_llama_tpu.ops.attention_prefill import flash_prefill_chunked as j_chunked  # noqa: E402
from lite_llama_tpu.parallel.shardings import ShardingPolicy as JPolicy  # noqa: E402
from lite_llama_tpu.parallel.shardings import make_mesh as j_make_mesh  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch.config import LlamaConfig as TLlama, Qwen2Config as TQwen2  # noqa: E402
from lite_llama_tpu_torch.executor import kv_cache as tkv  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.ops.attention_decode import paged_decode_state_plain  # noqa: E402
from lite_llama_tpu_torch.ops.attention_prefill import chunked_prefill_state_plain  # noqa: E402
from lite_llama_tpu_torch.parallel.shardings import Mesh, ShardingPolicy  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402
from tests.test_torch_tp import ENGINE, GEN, PROMPTS, collect, engine_case, jax_run  # noqa: E402
from tests.test_torch_tp import same_stream, spawn  # noqa: E402
from tests.torch_tp_worker import QT_FIELDS, load_tree, save_tree  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 (virtual) devices")

CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, vocab_size=96, max_seq_len=64, eos_token_id=95)
W4A8 = dict(hidden_size=256, intermediate_size=256, num_hidden_layers=1,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=512,
            max_seq_len=64, eos_token_id=511, tie_word_embeddings=True)
W4A8_CASE = ("LlamaConfig", W4A8, 4, dict(group_size=32, riffle=True, riffle_tp=2),
             dict(kv_quant="int8"), PROMPTS, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def w4a8_run(tmp_path_factory):
    """The W4A8 tp 2 engine case: two ranks started first, JAX's side while
    they run."""
    tmp = tmp_path_factory.mktemp("tp_w4a8")
    spec, jcfg, jtree = engine_case(tmp, "w4a8", W4A8_CASE)
    procs, out = spawn(tmp, 2, {"w4a8": spec})
    want = jax_run(W4A8_CASE, 2, jtree, jcfg)
    return want, collect(procs, out, ["w4a8"])["w4a8"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _same(t, j, what=""):
    """A port leaf (tensor or QTensor) equals a JAX one bit for bit, static
    fields included."""
    if isinstance(t, tq.QTensor):
        np.testing.assert_array_equal(_bits(t.q.numpy() if t.q.dtype != torch.float8_e4m3fn
                                            else t.q.view(torch.uint8).numpy()), _bits(j.q),
                                      err_msg=what)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale), err_msg=what)
        for f in QT_FIELDS:
            assert getattr(t, f) == (tuple(getattr(j, f)) if isinstance(getattr(j, f), tuple)
                                     else getattr(j, f)), (what, f)
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _same_tree(t, j, path=""):
    assert set(t) == set(j), (path, set(t), set(j))
    for k in j:
        if isinstance(j[k], dict):
            _same_tree(t[k], j[k], f"{path}/{k}")
        else:
            _same(t[k], j[k], f"{path}/{k}")


def _numpy_tree(j):
    """A JAX tree as numpy, its QTensors as the port's with numpy fields
    (what ``params_from_numpy`` takes)."""
    if isinstance(j, dict):
        return {k: _numpy_tree(v) for k, v in j.items()}
    if isinstance(j, jq.QTensor):
        return tq.QTensor(q=_bits(j.q), scale=np.asarray(j.scale),
                          **{f: tuple(getattr(j, f)) if isinstance(getattr(j, f), tuple)
                             else getattr(j, f) for f in QT_FIELDS})
    return np.asarray(j)


def _trees(cls="LlamaConfig", seed=0, **over):
    fields = dict(CFG, **over)
    jcfg = (JQwen2 if cls == "Qwen2Config" else JLlama)(dtype=jnp.float32, **fields)
    tcfg = (TQwen2 if cls == "Qwen2Config" else TLlama)(dtype=torch.float32, **fields)
    npp = numpy_params(jcfg, seed=seed)
    return jcfg, tcfg, _jax_tree(npp), params_from_numpy(npp, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# 1. Layouts


FUSE_CASES = {  # name -> (config class, quantize kwargs or None)
    "plain": ("LlamaConfig", None),
    "qwen2_bias": ("Qwen2Config", None),
    "int8": ("LlamaConfig", dict(qdtype="int8")),
    "int4_classic_g16": ("LlamaConfig", dict(qdtype="int4", group_size=16)),
}


@pytest.mark.parametrize("name", list(FUSE_CASES))
def test_fuse_qkv_params_tp2_is_bit_equal_to_jax(name):
    cls, quant = FUSE_CASES[name]
    _, _, jp, tp = _trees(cls, seed=1)
    if quant:
        jdt = {"int8": jnp.int8, "int4": jnp.int4}[quant["qdtype"]]
        jp = jq.quantize_decoder_params(jp, jdt, group_size=quant.get("group_size"))
        tp = tq.quantize_decoder_params(tp, quant["qdtype"], group_size=quant.get("group_size"))
    jf, tf = jdec.fuse_qkv_params(jp, tp=2), tdec.fuse_qkv_params(tp, tp=2)
    _same_tree(tf, jf)
    assert "wqkv" in tf["layers"] and ("qkv_bias" in tf["layers"]) == (cls == "Qwen2Config")


LAYOUTS = {  # name -> quantize_decoder_params kwargs (int4, g16)
    "riffle_tp2": dict(riffle=True, riffle_tp=2),
    "sigma_tp2": dict(sigma_ffn=True, sigma_tp=2),
    "sigma_tp1": dict(sigma_ffn=True),  # the validation recipe's int4 row
}


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_tp_quantized_layouts_are_bit_equal_to_jax(name, tied):
    _, tcfg, jp, tp = _trees(seed=2, tie_word_embeddings=tied)
    kw = LAYOUTS[name]
    jt = jq.quantize_decoder_params(jp, jnp.int4, group_size=16, **kw)
    tt = tq.quantize_decoder_params(tp, "int4", group_size=16, **kw)
    _same_tree(tt, jt)
    td, jd = tq.dequantize_tree(tt, torch.float32), jq.dequantize_tree(jt, jnp.float32)
    _same_tree(td, jd)
    # JAX's tree carried across is JAX's bits (what the tp tests feed both packages).
    _same_tree(params_from_numpy(_numpy_tree(jt), tcfg, device="cpu"), jt)


def test_save_tree_round_trip_keeps_every_field(tmp_path):
    _, tcfg, jp, _ = _trees(seed=3)
    jt = jq.quantize_decoder_params(jp, jnp.int4, group_size=16, sigma_ffn=True, sigma_tp=2)
    save_tree(str(tmp_path / "t.npz"), jt)
    _same_tree(params_from_numpy(load_tree(str(tmp_path / "t.npz")), tcfg, device="cpu"), jt)


# ---------------------------------------------------------------------------
# 2. Shards


def _jax_shard(leaf, device):
    """The data of ``leaf``'s shard on ``device``."""
    return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == device)


SHARD_CASES = {  # name -> (config overrides, quantize kwargs or None, fuse tp)
    "plain_fused": (dict(), None, 2),
    "plain_unfused_untied": (dict(tie_word_embeddings=False), None, 0),
    "qwen2_fused": (dict(cls="Qwen2Config"), None, 2),
    "int8_fused": (dict(), dict(qdtype="int8"), 2),
    "int4_riffle_tp2": (dict(), dict(qdtype="int4", group_size=16, riffle=True, riffle_tp=2), 0),
    "int4_sigma_tp2_untied": (dict(tie_word_embeddings=False),
                              dict(qdtype="int4", group_size=16, sigma_ffn=True, sigma_tp=2), 2),
}


@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_shard_params_gives_each_rank_jax_s_shard(name):
    over, quant, fuse = SHARD_CASES[name]
    over = dict(over)
    cls = over.pop("cls", "LlamaConfig")
    jcfg, tcfg, jp, tp = _trees(cls, seed=4, **over)
    if quant:
        kw = {k: v for k, v in quant.items() if k != "qdtype"}
        jp = jq.quantize_decoder_params(jp, {"int8": jnp.int8, "int4": jnp.int4}[quant["qdtype"]],
                                        **kw)
        tp = tq.quantize_decoder_params(tp, quant["qdtype"], **kw)
    if fuse:
        jp, tp = jdec.fuse_qkv_params(jp, tp=fuse), tdec.fuse_qkv_params(tp, tp=fuse)
    mesh = j_make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    js = JPolicy(mesh=mesh).shard_params(jcfg, jp)
    for rank, device in enumerate(mesh.devices.flat):
        local = ShardingPolicy(Mesh(tp=2, rank=rank)).shard_params(tcfg, tp)

        def walk(t, j, path):
            if isinstance(j, dict):
                assert set(t) == set(j), path
                for k in j:
                    walk(t[k], j[k], f"{path}/{k}")
            elif isinstance(j, jq.QTensor):
                q = t.q.view(torch.uint8).numpy() if t.q.dtype == torch.float8_e4m3fn else t.q
                np.testing.assert_array_equal(_bits(np.asarray(q)), _bits(_jax_shard(j.q, device)),
                                              err_msg=path)
                np.testing.assert_array_equal(t.scale.numpy(), _jax_shard(j.scale, device),
                                              err_msg=path)
                # The local shard is a one-device tree of its heads: one block,
                # its logical shape the shard's.
                assert t.riffle_groups in (0, 1) and t.sigma_groups == 1 and t.fused_tp == 0
                w = t.dequant(torch.float32)
                assert tuple(w.shape) == (*t.q.shape[:t.n_stack], *t.unit_shape), path
            else:
                np.testing.assert_array_equal(t.numpy(), _jax_shard(j, device), err_msg=path)

        walk(local, js, name)


def test_a_rank_s_pool_holds_its_kv_heads_and_writes_their_global_scale_lanes():
    """The counterpart of JAX's ``shard_cache``: rank 1 of tp 2 over 8 kv
    heads holds heads 4-7; an int8 write lands its channels as the whole
    pool's write lands heads 4-7, and its scales in lanes 4-7 / 68-71 of the
    whole slab (the other lanes unused); an offset past the slab raises."""
    assert ShardingPolicy(Mesh(tp=2, rank=1)).local_kv_heads(8) == (4, 4)
    with pytest.raises(ValueError):
        ShardingPolicy(Mesh(tp=2, rank=1)).local_kv_heads(3)
    whole = tkv.create_kv_cache(1, 8, 16, 4, page_size=4, device="cpu", quantized="int8")
    local = tkv.create_kv_cache(1, 4, 16, 4, page_size=4, device="cpu", quantized="int8",
                                head_offset=4)
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(1, 6, 8, 16, generator=g), torch.randn(1, 6, 8, 16, generator=g)
    table = torch.tensor([[2, 0]], dtype=torch.int32)
    z, n = torch.zeros(1, dtype=torch.int32), torch.tensor([6], dtype=torch.int32)
    tkv.kv_write_prefill(whole.kv_pages, 0, k, v, table, z, n)
    tkv.kv_write_prefill(local.kv_pages, 0, k[:, :, 4:], v[:, :, 4:], table, z, n)
    assert torch.equal(local.kv_pages.pages, whole.kv_pages.pages[..., 64:])
    lanes = torch.zeros(128, dtype=torch.bool)
    lanes[4:8] = lanes[68:72] = True
    assert torch.equal(local.kv_pages.scales[..., lanes], whole.kv_pages.scales[..., lanes])
    assert not local.kv_pages.scales[..., ~lanes].any()
    with pytest.raises(ValueError, match="num_kv_heads"):
        tkv.create_kv_cache(1, 4, 16, 4, page_size=4, device="cpu", quantized="int8",
                            head_offset=61)


# ---------------------------------------------------------------------------
# 3. Refusals


def _both_refuse(jcfg, tcfg, jp, tp, tp_degree=2):
    mesh = j_make_mesh(tp=tp_degree, dp=1, devices=jax.devices()[:tp_degree])
    with pytest.raises((ValueError, AssertionError)):
        JPolicy(mesh=mesh).shard_params(jcfg, jp)
    with pytest.raises(ValueError):
        ShardingPolicy(Mesh(tp=tp_degree, rank=0)).shard_params(tcfg, tp)


@pytest.mark.parametrize("case", ["sigma_groups", "riffle_groups", "unfused_int8_wkv",
                                  "indivisible_kv_heads"])
def test_jax_refusals_raise_in_the_port(case):
    if case == "indivisible_kv_heads":
        jcfg, tcfg, jp, tp = _trees(seed=5, num_attention_heads=3, num_key_value_heads=3)
        _both_refuse(jcfg, tcfg, jp, tp)
        return
    jcfg, tcfg, jp, tp = _trees(seed=5)
    if case == "sigma_groups":  # a one-device σ tree on a tp 2 mesh
        jp = jq.quantize_decoder_params(jp, jnp.int4, group_size=16, sigma_ffn=True)
        tp = tq.quantize_decoder_params(tp, "int4", group_size=16, sigma_ffn=True)
        jp, tp = jdec.fuse_qkv_params(jp, tp=2), tdec.fuse_qkv_params(tp, tp=2)
    elif case == "riffle_groups":  # a one-device riffle tree on a tp 2 mesh
        jp = jq.quantize_decoder_params(jp, jnp.int4, group_size=16, riffle=True)
        tp = tq.quantize_decoder_params(tp, "int4", group_size=16, riffle=True)
    else:
        jp = jq.quantize_decoder_params(jp, jnp.int8)
        tp = tq.quantize_decoder_params(tp, "int8")
    _both_refuse(jcfg, tcfg, jp, tp)


@pytest.mark.parametrize("kw", [dict(sigma_ffn=True, sigma_tp=3), dict(riffle=True, riffle_tp=3),
                                dict(sigma_ffn=True, riffle=True)],
                         ids=["sigma_tp3", "riffle_tp3", "sigma_and_riffle"])
def test_jax_quantizer_refusals_raise_in_the_port(kw):
    """Blocks that do not divide the ffn axis (128 / 3), and the two
    layouts at once."""
    _, _, jp, tp = _trees(seed=5)
    with pytest.raises((AssertionError, TypeError)):  # riffle_tp=3: JAX's fused reshape fails
        jq.quantize_decoder_params(jp, jnp.int4, **kw)
    with pytest.raises(ValueError):
        tq.quantize_decoder_params(tp, "int4", **kw)


# ---------------------------------------------------------------------------
# 4. K1q / K5q at a shard's head offset


def _shard_pool(rng, L=2, Hkv=8, D=16, ps=4, P=16):
    """An int8 pool of 8 kv heads written by both packages' prefill writes;
    returns (JAX pool, port pool) as whole pools (the shard views are cut
    from them)."""
    jc = jkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=P, max_seq_len=P * ps,
                             quantized="int8")
    tc = tkv.create_kv_cache(L, Hkv, D, P, page_size=ps, max_reqs=P, max_seq_len=P * ps,
                             device="cpu", quantized="int8")
    table = rng.permutation(P).reshape(1, P).astype(np.int32)
    k = rng.standard_normal((1, P * ps, Hkv, D)).astype(np.float32)
    v = (rng.standard_normal((1, P * ps, Hkv, D)) * 3).astype(np.float32)
    z, n = np.zeros(1, np.int32), np.asarray([P * ps], np.int32)
    jp = jc.kv_pages
    t = torch.from_numpy
    for layer in range(L):
        jp = jax.jit(jkv.kv_write_prefill, static_argnums=1)(
            jp, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(z),
            jnp.asarray(n))
        tkv.kv_write_prefill(tc.kv_pages, layer, t(k), t(v), t(table), t(z), t(n))
    np.testing.assert_array_equal(tc.kv_pages.scales.float().numpy(),
                                  np.asarray(jp.scales, np.float32))
    return jp, tc.kv_pages


def _views(jpool, tpool, hoff, hl=4):
    D = tpool.head_dim
    jl = jkv.KVPool(pages=jpool.pages[..., hoff * D:(hoff + hl) * D], scales=jpool.scales,
                    page_size=jpool.page_size, num_kv_heads=hl, head_dim=D)
    tl = dataclasses.replace(tpool, pages=tpool.pages[..., hoff * D:(hoff + hl) * D].contiguous(),
                             num_kv_heads=hl, head_offset=hoff)
    return jl, tl


@pytest.mark.parametrize("hoff", [0, 4])
def test_k1q_plain_at_a_head_offset_matches_jax_kernel(hoff):
    rng = np.random.default_rng(6)
    jpool, tpool = _shard_pool(rng)
    jl, tl = _views(jpool, tpool, hoff)
    B, Nq, D = 3, 8, 16
    table = rng.permutation(16)[:B * 4].reshape(B, 4).astype(np.int32)
    q = rng.standard_normal((B, Nq, D)).astype(np.float32)
    lens = np.asarray([13, 16, 1], np.int32)
    jo, jm, jl_ = j_decode(jnp.asarray(q), jl, 1, jnp.asarray(table), jnp.asarray(lens),
                           interpret=True, return_state=True, head_offset=hoff)
    args = (torch.from_numpy(q), tl.pages, 4, 1, torch.from_numpy(table),
            torch.from_numpy(lens), D**-0.5, tl.scales)
    out, m, l = paged_decode_state_plain(*args, head_offset=hoff)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl_), rtol=1e-4, atol=1e-4)
    # The other shard's lanes hold other scales: a wrong offset reads them.
    wrong, _, _ = paged_decode_state_plain(*args, head_offset=4 - hoff)
    assert np.abs(wrong.numpy() - np.asarray(jo)).max() > 1e-2


@pytest.mark.parametrize("hoff", [0, 4])
def test_k5q_plain_at_a_head_offset_matches_jax_kernel(hoff):
    rng = np.random.default_rng(7)
    jpool, tpool = _shard_pool(rng, D=32, ps=16, P=12)  # 4 heads of 32 pack 128 lanes in JAX
    jl, tl = _views(jpool, tpool, hoff)
    B, S, Nq, D = 3, 16, 8, 32
    table = rng.permutation(12)[:B * 3].reshape(B, 3).astype(np.int32)
    hist = np.asarray([32, 19, 0], np.int32)
    clen = np.asarray([16, 5, 9], np.int32)
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, 4, D)).astype(np.float32)
    v = rng.standard_normal((B, S, 4, D)).astype(np.float32)
    jo = j_chunked(*map(jnp.asarray, (q, k, v, clen, hist)), jl, 1, jnp.asarray(table),
                   interpret=True, block_q=16, block_k=16, head_offset=hoff)
    t = torch.from_numpy
    args = (t(q), t(k), t(v), t(clen), t(hist), tl.pages, 16, 1, t(table), D**-0.5, tl.scales)
    out, _, _ = chunked_prefill_state_plain(*args, head_offset=hoff)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    wrong, _, _ = chunked_prefill_state_plain(*args, head_offset=4 - hoff)
    assert np.abs(wrong.numpy() - np.asarray(jo)).max() > 1e-2


# ---------------------------------------------------------------------------
# 5. tp layouts on one device


@pytest.mark.parametrize("name", ["riffle_tp2", "sigma_tp2"])
def test_tp_layout_trees_on_one_device_match_jax(name):
    """What phase 11's tp 1 reference runs: a tree laid out for tp 2 on one
    device (the fused head order unfused with its fused_tp, the kernel's
    whole-axis output re-blocked). JAX on its W4A8 route (``pallas``)."""
    fields = dict(W4A8)
    jcfg, tcfg = JLlama(dtype=jnp.float32, **fields), TLlama(dtype=torch.float32, **fields)
    npp = numpy_params(jcfg, seed=8)
    jt = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=32, **LAYOUTS[name])
    tt = params_from_numpy(_numpy_tree(jt), tcfg, device="cpu")
    prev = jops._BACKEND
    jops.set_backend("pallas")
    try:
        jeng = JEngine(jcfg, jt, kv_quant="int8", **ENGINE)
        want = JGen(jeng).generate_tokens(PROMPTS, max_gen_len=GEN, temperature=0.0,
                                          logprobs=True)
    finally:
        jops.set_backend(prev)
    teng = InferenceEngine(tcfg, tt, device="cpu", kv_quant="int8", **ENGINE)
    got = TextGenerator(teng).generate_tokens(PROMPTS, max_gen_len=GEN, temperature=0.0,
                                              logprobs=True)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# 6. W4A8 at tp 2


def test_w4a8_riffle_tp2_engine_matches_jax_manual_tp_kernel(w4a8_run):
    """One layer (a 1-ulp difference can flip one int8 activation rounding
    per later layer, tests/test_torch_quant.py); an int8 pool, so K1q / K5q
    run at both ranks' head offsets."""
    want, ranks = w4a8_run
    same_stream(want, ranks)
    assert [int(d["head_offset"]) for d in ranks] == [0, 1]
