"""K9's route, the W4A16 grouped matmul under 512 rows (``ops/qmatmul.py``
``quantized_matmul_w4a16``, ``quant/qtensor.py`` ``qeinsum``), against the
JAX package on the CPU, where the wrapper takes its plain version:

1. ``qeinsum`` on packed int4 weights with grouped scales at 1, 12 and 300
   rows against JAX's small-M grouped branch (its XLA dot over groups), at
   group counts that no block of 8k whole groups divides (86, 76 and 180,
   as Qwen2.5-3B's, Qwen3-4B's and Falcon3-7B's down projections have,
   here with 16-row groups), in riffle, interleaved and σ layouts, one and
   two stacked weights;
2. every such call goes through the wrapper, and on the CPU through its
   plain version (no launch counted); 512 rows and more, per-channel scales
   and int8 weights do not; a tensor-parallel "contract" shard runs it on
   the shard before the all-reduce;
3. K6's routing decision (``qmm_supported``, ``takes_int8_rows``) equals
   JAX's at every projection of every preset (and Falcon3-7B's), from 1 to
   512 rows: K9 changed no route;
4. K9's split plan: whole groups, ragged where S does not divide nG, from
   shapes alone.

Tolerances: 2e-5 for the fp32 products (the same exact products summed in
another order); predicates and plans equal.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.models import decoder as jdec  # noqa: E402
from lite_llama_tpu.models import presets as jpresets  # noqa: E402
from lite_llama_tpu.ops import qmatmul as jqmm  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.models import decoder as tdec  # noqa: E402
from lite_llama_tpu_torch.models import presets as tpresets  # noqa: E402
from lite_llama_tpu_torch.ops import qmatmul as tqmm  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402

GS = 16  # narrow groups keep the group counts of the full-width projections
GROUPS = (86, 76, 180)
ROWS = (1, 12, 300)
LAYOUTS = ("riffle", "interleaved", "sigma")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(nG, O, layout, stacks, seed):
    """The same int4 g16 weight [stacks, C, O] quantized by both packages
    in ``layout`` (σ: the classic bytes with their output left in [evens |
    odds] order)."""
    C = nG * GS
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((stacks, C, O)) * 0.1).astype(np.float32)
    rb = int(layout == "riffle")
    t = tq.quantize(torch.from_numpy(w), (1,), "int4", group_size=GS, riffle_blocks=rb)
    j = jq.quantize(jnp.asarray(w), (1,), jnp.int4, group_size=GS, riffle_blocks=rb)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    if layout == "sigma":
        t = dataclasses.replace(t, sigma_out=True, sigma_groups=1)
        j = dataclasses.replace(j, sigma_out=True, sigma_groups=1)
    return t, j, rng


@pytest.mark.parametrize("stacks", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("nG", GROUPS)
def test_w4a16_plain_matches_jax_small_m_grouped_branch(nG, M, layout, stacks):
    t, j, rng = _pair(nG, 96, layout, stacks, seed=nG + M)
    x = rng.standard_normal((M, nG * GS)).astype(np.float32)
    want = jq.qeinsum("mc,sco->mso", jnp.asarray(x), j)
    got = tq.qeinsum("mc,sco->mso", torch.from_numpy(x), t)
    assert got.shape == (M, stacks, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nG", GROUPS)
def test_w4a16_plain_halves_are_the_per_group_dots(nG):
    """The plain version's [M, S, 2, Os]: half 0 the low nibbles' product,
    half 1 the high nibbles', each the scaled sum of per-group dots, against
    a float64 reference of that sum."""
    t, _, rng = _pair(nG, 64, "interleaved", 2, seed=nG)
    x = torch.from_numpy(rng.standard_normal((12, nG * GS)).astype(np.float32))
    got = tqmm.quantized_matmul_w4a16_plain(x, t.q, t.scale)
    assert got.shape == (12, 2, 2, 32) and got.dtype == torch.float32
    for h, half in enumerate(t.unpack_halves()):
        hg = half.double().reshape(2, nG, GS, 32)
        xg = x.double().reshape(12, nG, GS)
        want = torch.einsum("mgc,sgco,sgo->mso", xg, hg, t.scale.double())
        np.testing.assert_allclose(got[:, :, h].numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def _spy(monkeypatch):
    calls = []
    real = tq.quantized_matmul_w4a16
    monkeypatch.setattr(tq, "quantized_matmul_w4a16",
                        lambda x, q, s: calls.append((tuple(x.shape), tuple(q.shape),
                                                      tuple(s.shape))) or real(x, q, s))
    plain = []
    real_plain = tqmm.quantized_matmul_w4a16_plain
    monkeypatch.setattr(tqmm, "quantized_matmul_w4a16_plain",
                        lambda *a: plain.append(1) or real_plain(*a))
    return calls, plain


@pytest.mark.parametrize("M", [1, 12, 257, 300, 511])
def test_w4a16_calls_under_512_rows_go_through_the_wrapper(M, monkeypatch):
    """A layered packed weight at a shape K6 refuses (a stored width of 96
    bytes), and one K6 takes at M <= 256: the W4A16 calls reach the wrapper
    with [S, C, Os] bytes and scales, and on the CPU its plain version; no
    launch counts."""
    calls, plain = _spy(monkeypatch)
    launches = tqmm.launch_quantized_matmul_w4a16.launches
    t, _, rng = _pair(86, 192, "riffle", 2, seed=M)
    x = torch.from_numpy(rng.standard_normal((M, 86 * GS)).astype(np.float32))
    y = tq.qeinsum(None, x, t.at_layer(1))
    assert y.shape == (M, 192)
    assert calls == [((M, 86 * GS), (1, 86 * GS, 96), (1, 86, 96))] and plain == [1]
    calls.clear(), plain.clear()
    on_k6, _, _ = _pair(8, 256, "riffle", 2, seed=M)  # C 128: one whole-C block
    tq.qeinsum(None, x[:, :128], on_k6.at_layer(0))
    assert bool(calls) == (M > 256) and len(plain) == len(calls)
    assert tqmm.launch_quantized_matmul_w4a16.launches == launches


def test_w4a16_wrapper_takes_no_other_route(monkeypatch):
    """512 rows (dequantize once, one dot), per-channel packed scales and
    grouped int8 weights under 512 rows (plain per-group dots, on the card
    too) never reach the wrapper."""
    calls, _ = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32))
    for qt, rows in ((tq.quantize(w, (0,), "int4", group_size=GS), 512),
                     (tq.quantize(w, (0,), "int4"), 12),
                     (tq.quantize(w, (0,), "int8", group_size=GS), 12)):
        tq.qeinsum(None, x[:rows], qt)
    assert calls == []


def test_w4a16_runs_on_a_contract_shard_before_the_all_reduce(monkeypatch):
    """Under tensor parallelism a "contract" weight (down, o_proj) off K6 runs
    the wrapper on this rank's contraction rows, in fp32, then all-reduces."""
    calls, _ = _spy(monkeypatch)
    reduced = []
    shard = types.SimpleNamespace(tp=2, all_reduce=lambda y: reduced.append(y.dtype) or y * 2)
    t, j, rng = _pair(43, 64, "riffle", 2, seed=3)  # a rank's 43 of 86 groups
    x = rng.standard_normal((300, 43 * GS)).astype(np.float32)
    got = tq.qeinsum(None, torch.from_numpy(x), t.at_layer(0), shard=shard, tp_kind="contract")
    assert calls == [((300, 43 * GS), (1, 43 * GS, 32), (1, 43, 32))]
    assert reduced == [torch.float32]
    want = jq.qeinsum("mc,co->mo", jnp.asarray(x), jax.tree_util.tree_map(lambda a: a[0], j))
    np.testing.assert_allclose(got.numpy(), 2 * np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# 3. K6's routing decision at every preset's projections

PROJECTIONS = ("wqkv", "o_proj", "gate_up_proj", "down_proj", "lm_head")
ROUTE_ROWS = (1, 5, 12, 64, 108, 256, 257, 300, 511, 512)
FALCON3_7B = dict(  # tiiuae/Falcon3-7B-Base's config.json (chip_smoke.py phase 15)
    architectures=["LlamaForCausalLM"], model_type="llama", hidden_size=3072,
    intermediate_size=23040, num_hidden_layers=28, num_attention_heads=12,
    num_key_value_heads=4, head_dim=256, vocab_size=131072, rms_norm_eps=1e-6,
    rope_theta=1000042.0, max_position_embeddings=32768, tie_word_embeddings=False)
# model -> (port config, JAX config, riffle): LLaVA-1.5-7B's Vicuna LM and
# Qwen2.5-3B take the interleaved layout (riffle refuses their ffn width 11008)
MODELS = {
    "llama32_1b": (tpresets.llama32_1b, jpresets.llama32_1b, True),
    "llama32_3b": (tpresets.llama32_3b, jpresets.llama32_3b, True),
    "qwen25_3b": (tpresets.qwen25_3b, jpresets.qwen25_3b, False),
    "qwen3_4b": (tpresets.qwen3_4b, jpresets.qwen3_4b, True),
    "llava15_7b": (tpresets.llava15_7b, jpresets.llava15_7b, False),
    "falcon3_7b": (functools.partial(tconfig.load_config, FALCON3_7B),
                   functools.partial(jconfig.load_config, FALCON3_7B), True),
}
# The projections the routing rule keeps off K6 at every row count: C above
# 4096 rows that no multiple of 8 groups of 128 divides
OFF_K6 = {("qwen25_3b", "down_proj"), ("qwen3_4b", "down_proj"),
          ("llava15_7b", "down_proj"), ("falcon3_7b", "down_proj")}


def _shapes(cfg):
    """One layer's leaf shapes (models/decoder.py layout) and the head."""
    H, D, I, V = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size
    Nq, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    out = {"embed": (V, H), "layers": {
        "wq": (1, H, Nq, D), "wkv": (1, H, 2, Nkv, D), "o_proj": (1, Nq, D, H),
        "gate_up_proj": (1, 2, H, I), "down_proj": (1, I, H)}}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (H, V)
    return out


@functools.lru_cache(maxsize=None)
def _trees(model):
    """Each package's int4 g128 tree of ``model`` at full width, as the
    engine holds it (packed wq / wkv fused), quantized on shapes alone."""
    tcfg, jcfg, riffle = MODELS[model]
    tcfg, jcfg = tcfg(), jcfg()
    shapes = _shapes(tcfg)
    assert shapes == _shapes(jcfg)
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s, device="meta"), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    port = tdec.fuse_qkv_params(tq.quantize_decoder_params(meta, "int4", group_size=128,
                                                           riffle=riffle))
    spec = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    jtree = jax.eval_shape(lambda p: jdec.fuse_qkv_params(jq.quantize_decoder_params(
        p, jnp.int4, group_size=128, riffle=riffle)), spec)
    return dict(port["layers"], lm_head=port["lm_head"]), dict(jtree["layers"],
                                                              lm_head=jtree["lm_head"])


@pytest.mark.parametrize("proj", PROJECTIONS)
@pytest.mark.parametrize("model", list(MODELS))
def test_k6_routing_is_unchanged_at_every_preset_projection(model, proj):
    port, jtree = _trees(model)
    t, j = port[proj], jtree[proj]
    C, Os, nG = t.q.shape[-2], t.q.shape[-1], t.scale.shape[-2]
    assert (C, Os, nG) == (j.q.shape[-2], j.q.shape[-1], j.scale.shape[-2])
    w = t.at_layer(0) if t.n_stack else t
    for M in ROUTE_ROWS:
        on_k6 = tqmm.qmm_supported(C, Os, nG, M)
        assert on_k6 == jqmm.qmm_supported(C, Os, nG, M), M
        assert on_k6 == (M <= 256 and (model, proj) not in OFF_K6), M
        assert tq.takes_int8_rows(w, M) == on_k6, M


@pytest.mark.parametrize("model,M,want", [
    ("falcon3_7b", 12, 28), ("qwen25_3b", 12, 36), ("qwen3_4b", 12, 36),
    ("llava15_7b", 5, 32), ("llama32_1b", 12, 0), ("llama32_3b", 12, 0),
])
def test_k9_launches_a_step_as_chip_smoke_counts_them(model, M, want):
    """chip_smoke.k9_per_step, which phases 6, 9, 15 and 17 hold the captured
    decode step's K9 nodes to, on each model's int4 g128 tree at full width
    and depth (quantized on shapes alone)."""
    import chip_smoke

    tcfg, _, riffle = MODELS[model]
    tcfg = tcfg()
    shapes = _shapes(tcfg)
    L = tcfg.num_hidden_layers
    shapes["layers"] = {k: (L, *s[1:]) for k, s in shapes["layers"].items()}
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s, device="meta"), shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))
    tree = tq.quantize_decoder_params(meta, "int4", group_size=128, riffle=riffle)
    assert chip_smoke.k9_per_step(tree, M) == want


# ---------------------------------------------------------------------------
# 4. The split plan


@pytest.mark.parametrize("C,O,stacks,M,want", [
    (11008, 2048, 1, 12, (1, 8)),  # Qwen2.5-3B down: 16 column tiles
    (9728, 2560, 1, 12, (1, 8)),  # Qwen3-4B down: 20
    (23040, 3072, 1, 12, (1, 8)),  # Falcon3-7B down: 24
    (11008, 4096, 1, 12, (1, 8)),  # Vicuna-7B down: 32
    (3072, 16384, 1, 300, (2, 1)),  # Llama-3.2-3B gate_up at its 12 x 25 prefill
    (4096, 3072, 1, 300, (2, 1)),  # a tp 2 rank's down shard there
    (384, 128, 2, 5, (1, 3)),  # three groups: at most one split each
])
def test_w4a16_plan(C, O, stacks, M, want):
    assert tqmm.plan_w4a16(C, C // 128, O // 2, stacks, M, 132) == want


def test_w4a16_splits_are_whole_ragged_groups():
    assert tqmm.w4a16_split_groups(86, 8) == [0, 10, 21, 32, 43, 53, 64, 75, 86]
    assert tqmm.w4a16_split_groups(76, 8) == [0, 9, 19, 28, 38, 47, 57, 66, 76]
    assert tqmm.w4a16_split_groups(180, 8) == [0, 22, 45, 67, 90, 112, 135, 157, 180]
    for nG in range(1, 200):
        for S in range(1, min(8, nG) + 1):
            spans = np.diff(tqmm.w4a16_split_groups(nG, S))
            assert spans.sum() == nG and spans.min() >= 1 and spans.max() - spans.min() <= 1
