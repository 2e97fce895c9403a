"""The int4 routing of the decoder families that ``chip_smoke.py``'s phase 17
runs at full width (Llama-3.2-1B, Qwen2.5-3B, Qwen3-4B, and Llama-3.2-3B
beside them), against the JAX package on the CPU:

1. every int4 g128 projection's stored shape, the port's ``qmm_supported``
   and ``_pick_bc`` equal JAX's at 12, 108 and 300 rows (the shapes come
   from each package's own quantizer, run on shapes alone: meta tensors
   here, ``jax.eval_shape`` there), and the two Qwen ``down`` projections
   take the W4A16 dual dot: a full-width layer of each runs off the packed
   kernel and equals JAX's product;
2. riffle int4 refuses Qwen2.5-3B's ffn width 11008 in both packages, and
   the interleaved layout gives the same bytes and scales in both;
3. ``chip_smoke.decode_floor_ms`` counts a tied model's table once (its
   head reads it whole every step) and leaves an untied model's out.

Tolerances: shapes, predicates, bytes and scales equal; 1e-5 for the fp32
W4A16 products (summation order).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.models import presets as jpresets  # noqa: E402
from lite_llama_tpu.ops import qmatmul as jqmm  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch.config import Qwen2Config  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.models import presets as tpresets  # noqa: E402
from lite_llama_tpu_torch.ops import qmatmul as tqmm  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402

# preset -> riffle packing of its int4 run (chip_smoke.FAMILIES, and the 3B's)
LAYOUTS = {"llama32_1b": True, "llama32_3b": True, "qwen25_3b": False, "qwen3_4b": True}
PROJECTIONS = ("wqkv", "o_proj", "gate_up_proj", "down_proj", "lm_head")
ROWS = (12, 108, 300)  # a decode batch, a verify step, a prefill past K6's 256 rows
OFF_K6 = {("qwen25_3b", "down_proj"), ("qwen3_4b", "down_proj")}  # 86 and 76 groups


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _shapes(cfg, layers=1):
    """Leaf shapes of a decoder tree (models/decoder.py layout), tied head."""
    H, D, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    Nq, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    L = layers
    return {"embed": (V, H), "layers": {
        "wq": (L, H, Nq, D), "wkv": (L, H, 2, Nkv, D), "o_proj": (L, Nq, D, H),
        "gate_up_proj": (L, 2, H, I), "down_proj": (L, I, H)}}


def _stored(tree):
    """{projection: (C, stored O, scale groups)} of a quantized tree."""
    leaves = dict(tree["layers"], lm_head=tree["lm_head"])
    return {k: (int(leaves[k].q.shape[-2]), int(leaves[k].q.shape[-1]),
                int(leaves[k].scale.shape[-2])) for k in PROJECTIONS}


@functools.lru_cache(maxsize=None)
def _both(preset):
    """The int4 g128 tree of ``preset`` at full width (one layer: the
    routing reads a layer's shapes), as the engine holds it (packed wq / wkv
    fused), from each package's quantizer on shapes alone."""
    riffle = LAYOUTS[preset]
    shapes = _shapes(getattr(tpresets, preset)())
    meta = {"embed": torch.empty(shapes["embed"], device="meta"),
            "layers": {k: torch.empty(s, device="meta") for k, s in shapes["layers"].items()}}
    port = tdec.fuse_qkv_params(tq.quantize_decoder_params(meta, "int4", group_size=128,
                                                           riffle=riffle))
    spec = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    jax_tree = jax.eval_shape(lambda p: jdec.fuse_qkv_params(jq.quantize_decoder_params(
        p, jnp.int4, group_size=128, riffle=riffle)), spec)
    return _stored(port), _stored(jax_tree)


def test_presets_are_the_jax_package_s():
    for preset in LAYOUTS:
        t, j = getattr(tpresets, preset)(), getattr(jpresets, preset)()
        for f in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "head_dim", "vocab_size", "tie_word_embeddings",
                  "attention_bias", "model_type"):
            assert getattr(t, f) == getattr(j, f), (preset, f)
        assert getattr(t, "qk_norm", False) == getattr(j, "qk_norm", False)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("preset", list(LAYOUTS))
def test_int4_routing_matches_jax(preset, proj, M):
    port, jax_shapes = _both(preset)
    assert port[proj] == jax_shapes[proj]
    C, Os, nG = port[proj]
    assert C // nG == 128
    assert tqmm._pick_bc(C, nG) == jqmm._pick_bc(C, nG)
    on_k6 = tqmm.qmm_supported(C, Os, nG, M)
    assert on_k6 == jqmm.qmm_supported(C, Os, nG, M)
    assert on_k6 == (M <= 256 and (preset, proj) not in OFF_K6)
    if (preset, proj) in OFF_K6:
        assert tqmm._pick_bc(C, nG) is None  # no multiple of 8 groups divides C > 4096


def test_the_k6_blocks_of_the_qwen_presets():
    """The contraction blocks the table of phase 17 names: Qwen2.5-3B's
    four K6 projections one whole-C block of 2048; Qwen3-4B's C 2560 one
    block of 20 groups (not a multiple of 8), its o_proj one of 4096."""
    q25, q3 = _both("qwen25_3b")[0], _both("qwen3_4b")[0]
    assert {k: tqmm._pick_bc(C, nG) for k, (C, _, nG) in q25.items()} == dict(
        wqkv=2048, o_proj=2048, gate_up_proj=2048, down_proj=None, lm_head=2048)
    assert {k: tqmm._pick_bc(C, nG) for k, (C, _, nG) in q3.items()} == dict(
        wqkv=2560, o_proj=4096, gate_up_proj=2560, down_proj=None, lm_head=2560)
    assert q25["gate_up_proj"][1] * 2 == 11264 and q3["lm_head"][1] * 2 == 152576  # padded


@pytest.mark.parametrize("preset", ["qwen25_3b", "qwen3_4b"])
def test_qwen_down_projection_takes_the_w4a16_route(preset, monkeypatch):
    """One full-width down layer of each Qwen at a decode batch: qeinsum
    never calls the packed kernel (nor would the norm before it write int8
    rows), and its product equals JAX's on the same bytes."""
    cfg = getattr(tpresets, preset)()
    I, H = cfg.intermediate_size, cfg.hidden_size
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((1, I, H)) * 0.02).astype(np.float32)
    x = rng.standard_normal((12, I)).astype(np.float32)
    rb = int(LAYOUTS[preset])  # down keeps one riffle block; interleaved none
    t = tq.quantize(torch.from_numpy(w), (1,), "int4", group_size=128, riffle_blocks=rb)
    j = jq.quantize(jnp.asarray(w), (1,), jnp.int4, group_size=128, riffle_blocks=rb)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    assert not tq.takes_int8_rows(t.at_layer(0), 12)

    def refuse(*a, **k):
        raise AssertionError("the packed kernel ran on a W4A16 shape")

    monkeypatch.setattr(tq, "quantized_matmul_packed", refuse)
    got = tq.qeinsum("mi,ih->mh", torch.from_numpy(x), t.at_layer(0))
    want = jq.qeinsum("mi,ih->mh", jnp.asarray(x),
                      dataclasses.replace(j, layer=jnp.asarray(0, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _qwen2_narrow(I=11008):
    """Qwen2.5-3B's ffn width under a narrow hidden width (one layer)."""
    return Qwen2Config(hidden_size=128, intermediate_size=I, num_hidden_layers=1,
                       num_attention_heads=2, num_key_value_heads=1, vocab_size=256,
                       dtype=torch.float32, tie_word_embeddings=True)


def test_riffle_refuses_qwen25_3b_ffn_width_in_both_packages():
    """A flat riffle gate_up of 2 x 11008 columns hits the lane-alignment pad
    (11008 packed columns are not a multiple of 512) in both quantizers."""
    cfg = _qwen2_narrow()
    npp = numpy_params(cfg, seed=3)
    with pytest.raises(ValueError, match="lane-alignment"):
        tq.quantize_decoder_params(params_from_numpy(npp, cfg, device="cpu"), "int4",
                                   group_size=128, riffle=True)
    with pytest.raises(AssertionError, match="lane-alignment"):
        jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=128, riffle=True)


def test_interleaved_int4_of_qwen25_3b_ffn_width_matches_jax_bytes():
    """Interleaved int4 g128 of the same tree: every packed weight's bytes
    and scales equal JAX's, the padded gate_up and the tied head included,
    and so do the engine's fused wqkv."""
    cfg = _qwen2_narrow()
    npp = numpy_params(cfg, seed=3)
    t = tq.quantize_decoder_params(params_from_numpy(npp, cfg, device="cpu"), "int4",
                                   group_size=128)
    j = jq.quantize_decoder_params(_jax_tree(npp), jnp.int4, group_size=128)
    assert t["layers"]["gate_up_proj"].q.shape[-1] == 5632  # 11008 padded to 11264
    for tree_t, tree_j in ((t, j), (tdec.fuse_qkv_params(t), jdec.fuse_qkv_params(j))):
        leaves_t = dict(tree_t["layers"], lm_head=tree_t["lm_head"])
        leaves_j = dict(tree_j["layers"], lm_head=tree_j["lm_head"])
        for k, jv in leaves_j.items():
            if isinstance(jv, jq.QTensor):
                np.testing.assert_array_equal(leaves_t[k].q.numpy(), np.asarray(jv.q), err_msg=k)
                np.testing.assert_array_equal(leaves_t[k].scale.numpy(), np.asarray(jv.scale),
                                              err_msg=k)
                assert leaves_t[k].out_shape == tuple(jv.out_shape)


def _meta_tree(cfg, tied):
    shapes = _shapes(cfg, cfg.num_hidden_layers)
    tree = {"embed": torch.empty(shapes["embed"], dtype=torch.bfloat16, device="meta"),
            "final_norm": torch.empty((cfg.hidden_size,), dtype=torch.bfloat16, device="meta"),
            "layers": {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
                       for k, s in shapes["layers"].items()}}
    for k in ("attn_norm", "mlp_norm"):
        tree["layers"][k] = torch.empty((cfg.num_hidden_layers, cfg.hidden_size),
                                        dtype=torch.bfloat16, device="meta")
    if not tied:
        tree["lm_head"] = torch.empty(shapes["embed"][::-1], dtype=torch.bfloat16, device="meta")
    return tree


@pytest.mark.parametrize("preset,floor_ms", [("llama32_1b", 0.738), ("llama32_3b", 1.918),
                                             ("qwen25_3b", 1.842), ("qwen3_4b", 2.401)])
def test_decode_floor_counts_a_tied_table_once(preset, floor_ms):
    """Tied presets: every weight once, the table included (their head reads
    it whole); the same widths untied leave the table out, as Falcon3-7B's
    floor has always done."""
    cfg = getattr(tpresets, preset)()
    tied = _meta_tree(cfg, tied=True)
    assert chip_smoke.decode_floor_ms(tied) == pytest.approx(floor_ms, abs=5e-4)
    untied = _meta_tree(cfg, tied=False)
    table = cfg.vocab_size * cfg.hidden_size * 2
    assert chip_smoke.decode_floor_ms(untied) == pytest.approx(
        (chip_smoke.weight_bytes(untied) - table) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert chip_smoke.param_count(tied) * 2 == chip_smoke.weight_bytes(tied)
