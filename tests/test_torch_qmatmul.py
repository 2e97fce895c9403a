"""K6 (W4A8, ``quantized_matmul_packed``) and K7 (W8A8,
``quantized_matmul_int8``): their plain versions (the CPU path, and what the
CUDA kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode, on the CPU, with the same numpy inputs; the
activation quantizer and the routing predicate against JAX's.

Tolerance: 1e-5 relative to the largest output, fp32. The integer dots are
exact on both sides and the folds run in the same order; what remains is
fp32 rounding where XLA contracts a multiply and an add, or multiplies by a
reciprocal, and the port does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.ops import qmatmul as jm  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch.ops import qmatmul as tm  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _weights(qdtype, C, O, gs, rb=0, seed=0, Lf=3):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((Lf, C, O)) * 0.05).astype(np.float32)
    j = jq.quantize(jnp.asarray(w), (1,), {"int4": jnp.int4, "int8": jnp.int8}[qdtype],
                    group_size=gs, riffle_blocks=rb)
    t = tq.quantize(torch.from_numpy(w), (1,), qdtype, group_size=gs, riffle_blocks=rb)
    return j, t


W4A8_CASES = [  # (M, C, O, group_size, riffle)
    (12, 256, 512, 32, 1),
    (12, 256, 512, 32, 0),
    (5, 256, 256, None, 0),   # per-channel: one fold per C block
    (3, 3072, 256, None, 1),  # per-channel, three 1024-row C blocks
    (64, 512, 256, 128, 0),
    (7, 128, 8448, 32, 1),    # padded stored width
    (12, 256, 512, 16, 1),    # groups of 16 and 8 rows: m16n8k16 steps on the card
    (12, 384, 512, 48, 0),
    (12, 256, 512, 8, 1),
]


@pytest.mark.parametrize("M,C,O,gs,rb", W4A8_CASES)
def test_w4a8_plain_matches_jax_kernel(M, C, O, gs, rb):
    j, t = _weights("int4", C, O, gs, rb, seed=M)
    x = np.random.default_rng(M + 1).standard_normal((M, C)).astype(np.float32)
    for layer in (0, 2):
        want = jm.quantized_matmul_packed(jnp.asarray(x), j.q, j.scale, layer, interpret=True,
                                          out_dtype=jnp.float32, interleave=not rb)
        got = tm.quantized_matmul_packed(torch.from_numpy(x), t.q, t.scale, layer,
                                         out_dtype=torch.float32, interleave=not rb)
        assert got.shape == want.shape
        _close(got, want)
        # Written straight to the logical width: the pad columns are dropped.
        part = tm.quantized_matmul_packed(torch.from_numpy(x), t.q, t.scale, layer,
                                          out_dtype=torch.float32, interleave=not rb,
                                          out_width=O)
        assert torch.equal(part, got[:, :O])


@pytest.mark.parametrize("M,C,O,gs", [(12, 256, 256, 32), (5, 256, 128, None),
                                      (3, 3072, 128, None), (64, 512, 256, 128)])
def test_w8a8_plain_matches_jax_kernel(M, C, O, gs):
    j, t = _weights("int8", C, O, gs, seed=M)
    x = np.random.default_rng(M + 2).standard_normal((M, C)).astype(np.float32)
    for layer in (0, 1):
        want = jm.quantized_matmul_int8(jnp.asarray(x), j.q, j.scale, layer, interpret=True,
                                        out_dtype=jnp.float32)
        got = tm.quantized_matmul_int8(torch.from_numpy(x), t.q, t.scale, layer,
                                       out_dtype=torch.float32)
        _close(got, want)


def test_w8a8_refuses_unsupported_shapes():
    _, t = _weights("int8", 256, 200, None)  # O % 128 != 0
    with pytest.raises(ValueError, match="unsupported"):
        tm.quantized_matmul_int8(torch.zeros(2, 256), t.q, t.scale, 0)


def test_activation_quantizer_matches_jax():
    """As the kernels' wrappers run it, inside jit (XLA turns the division
    by 127 into a product with its fp32 reciprocal there)."""
    x = np.random.default_rng(3).standard_normal((9, 256)).astype(np.float32) * 3
    jxi, jxs, jsx = jax.jit(jm.quantize_activations, static_argnums=1)(jnp.asarray(x), 8)
    txi, txs, tsx = tm.quantize_activations(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(txi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


def test_routing_predicate_matches_jax():
    for C in (64, 128, 256, 3072, 4096, 8192, 12288, 96 * 64):
        for ng in (None, 1, 2, C // 128 if C >= 128 else None, C // 32, C // 16):
            assert tm._pick_bc(C, ng) == jm._pick_bc(C, ng), (C, ng)
            for Oh in (64, 128, 2560, 4224, 64512):
                for M in (1, 12, 256, 257):
                    assert tm.qmm_supported(C, Oh, ng, M) == jm.qmm_supported(C, Oh, ng, M)


def test_cpu_tensors_take_the_plain_versions():
    _, t4 = _weights("int4", 256, 256, 32, 1)
    _, t8 = _weights("int8", 256, 256, 32)
    before = (tm.launch_quantized_matmul_packed.launches,
              tm.launch_quantized_matmul_int8.launches)
    x = torch.randn(4, 256)
    tm.quantized_matmul_packed(x, t4.q, t4.scale, 1, interleave=False)
    tm.quantized_matmul_int8(x, t8.q, t8.scale, 1)
    assert (tm.launch_quantized_matmul_packed.launches,
            tm.launch_quantized_matmul_int8.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tm.launch_quantized_matmul_packed(x, t4.q, t4.scale, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tm.launch_quantized_matmul_int8(x, t8.q, t8.scale, 0)


# 3B projections at decode (C, stored width Wn, M): the split each gets.
_SPLIT_SHAPES = {"gate_up": (3072, 8192), "wqkv": (3072, 2560), "o_proj": (3072, 1536),
                 "down": (8192, 1536), "lm_head": (3072, 64512)}


@pytest.mark.parametrize("C,gs,Wn,M", [
    (3072, 128, 8192, 12), (3072, 128, 2560, 12), (3072, 128, 1536, 12), (8192, 128, 1536, 12),
    (3072, 128, 64512, 12), (8192, 128, 1536, 64), (8192, None, 1536, 12), (8192, 16, 1536, 12),
    (384, 48, 256, 12), (256, 8, 256, 12), (256, 16, 256, 3),
])
def test_split_planner_covers_every_span_once_in_order(C, gs, Wn, M):
    nG = C // gs if gs else 1
    F = tm._fold_span(C, nG)
    for S in tm.allowed_splits(C, nG, Wn, M, 132):
        got_S, rows = tm.plan_splits(C, nG, Wn, M, 132, splits=S)
        assert got_S == S and len(rows) == S + 1
        assert rows[0] == 0 and rows[-1] == C
        assert all(a < b for a, b in zip(rows, rows[1:]))  # in order, none empty
        assert all(r % F == 0 and r % 32 == 0 for r in rows)  # whole spans, 32-row steps
        assert S <= C // F
    S, _ = tm.plan_splits(C, nG, Wn, M, 132)
    assert S in tm.allowed_splits(C, nG, Wn, M, 132)
    with pytest.raises(ValueError, match="not allowed"):
        tm.plan_splits(C, nG, Wn, M, 132, splits=tm._MAX_SPLITS + 1)


def test_split_planner_picks_the_predicted_counts():
    """Llama-3.2-3B at M 12 on 132 SMs: no split where the tiles already
    fill the card (gate_up 256 tiles, lm_head 2016), else the smallest count
    whose grid covers the SMs and stays co-resident (down: 3 splits would
    hold 22 spans of terms beside the ring, one block per SM, 144 blocks)."""
    want = {"gate_up": 1, "lm_head": 1, "wqkv": 2, "o_proj": 3, "down": 4}
    for name, (C, Wn) in _SPLIT_SHAPES.items():
        S, rows = tm.plan_splits(C, C // 128, Wn, 12, 132)
        assert S == want[name], name
    # 64 rows: four row tiles of terms do not fit beside a split grid.
    assert tm.plan_splits(8192, 64, 1536, 64, 132)[0] == 1
    # down at S 4: 16 scale groups each.
    assert tm.plan_splits(8192, 64, 1536, 12, 132)[1] == (0, 2048, 4096, 6144, 8192)


@pytest.mark.parametrize("gs", [8, 16, 48])
def test_split_planner_takes_spans_of_8_16_and_48_rows(gs):
    C = 96 * 32  # a multiple of 8, 16, 48 and 32 rows
    for S in tm.allowed_splits(C, C // gs, 128, 12, 132):
        _, rows = tm.plan_splits(C, C // gs, 128, 12, 132, splits=S)
        assert all(r % gs == 0 and r % 32 == 0 for r in rows)
    assert tm._kstep(gs) == {8: 8, 16: 16, 48: 16}[gs]


@pytest.mark.parametrize("M,C,O,gs", [(12, 256, 256, 8), (12, 256, 256, 16), (12, 384, 256, 48),
                                      (1, 256, 256, 32), (1, 3072, 128, None)])
def test_w8a8_plain_matches_jax_kernel_at_small_groups_and_one_row(M, C, O, gs):
    """Groups of 8, 16 and 48 rows (K7's k16 steps on the card) and a
    single activation row."""
    j, t = _weights("int8", C, O, gs, seed=M + C)
    x = np.random.default_rng(M + 3).standard_normal((M, C)).astype(np.float32)
    for layer in (0, 2):
        want = jm.quantized_matmul_int8(jnp.asarray(x), j.q, j.scale, layer, interpret=True,
                                        out_dtype=jnp.float32)
        got = tm.quantized_matmul_int8(torch.from_numpy(x), t.q, t.scale, layer,
                                       out_dtype=torch.float32)
        assert got.shape == want.shape
        _close(got, want)


# K7 (int8, stored width = O) at Llama-3.2-3B's projections: (C, Wn).
_W8_SHAPES = {"gate_up": (3072, 16384), "wqkv": (3072, 5120), "o_proj": (3072, 3072),
              "down": (8192, 3072), "lm_head": (3072, 128256)}


@pytest.mark.parametrize("C,gs,Wn,M", [
    *((C, 128, Wn, M) for C, Wn in _W8_SHAPES.values() for M in (1, 12, 64, 256)),
    (8192, None, 3072, 12), (8192, None, 3072, 64), (3072, None, 3072, 12),
    (8192, 16, 3072, 12), (3072, 48, 3072, 12), (3072, 8, 1024, 64), (1024, 64, 512, 17),
])
def test_w8a8_planner_covers_every_span_once_in_order(C, gs, Wn, M):
    """Every plan K7 allows: splits of whole fold spans in whole chunks (128
    rows a k-warp), in order and none empty, the last ending at C; shared
    memory within a block's; a split grid of one wave (a block per SM) and
    splits of one cluster."""
    nG = C // gs if gs else 1
    F = tm._fold_span(C, nG)
    MT, rt = tm._row_tiles(M)
    plans = tm.w8a8_allowed_plans(C, nG, Wn, M, 132)
    assert (1, 1) in plans
    for kw, S in plans:
        assert kw in tm._w8_kwarps(F)
        kw_s, S_s, rows_s = tm.plan_w8a8(C, nG, Wn, M, 132, splits=S)
        assert S_s == S and (kw_s, S) in plans and rows_s == tuple(tm._w8_split_rows(C, F, S, kw_s))
        rows = tm._w8_split_rows(C, F, S, kw)
        assert len(rows) == S + 1
        assert rows[0] == 0 and rows[-1] == C
        assert all(a < b for a, b in zip(rows, rows[1:]))
        assert all(r % F == 0 and r % 32 == 0 and r % (128 * kw) == 0 for r in rows[:-1])
        smem = tm._w8_smem_bytes(MT, tm._kstep(F), kw, tm._held_spans(rows, F))
        assert smem <= tm._SMEM_PER_BLOCK
        if S > 1:
            assert Wn // 128 * rt * S <= 132 and S <= tm._W8_MAX_SPLITS
    assert tm.plan_w8a8(C, nG, Wn, M, 132)[:2] in plans


def test_w8a8_planner_takes_two_k_warps_only_where_spans_allow():
    """Two k-warps per column (each taking 128 rows of a chunk) need fold
    spans of whole 128-row runs; a split count it does not allow raises."""
    assert tm._w8_kwarps(128) == tm._w8_kwarps(4096) == [1, 2]
    assert tm._w8_kwarps(64) == tm._w8_kwarps(48) == tm._w8_kwarps(16) == [1]
    assert {kw for kw, _ in tm.w8a8_allowed_plans(3072, 3072 // 32, 3072, 12, 132)} == {1}
    assert {kw for kw, _ in tm.w8a8_allowed_plans(3072, 3072 // 128, 3072, 12, 132)} == {1, 2}
    with pytest.raises(ValueError, match="not allowed"):
        tm.plan_w8a8(3072, 24, 3072, 12, 132, splits=tm._W8_MAX_SPLITS + 1)


def test_k6_plan_is_unchanged_beside_k7s():
    """K7's planner is its own: K6's plans at the 3B projections (packed
    widths) stay as they were before K7 had one."""
    packed = {"gate_up": (3072, 8192), "wqkv": (3072, 2560), "o_proj": (3072, 1536),
              "down": (8192, 1536), "lm_head": (3072, 64512)}
    want = {12: {"gate_up": 1, "wqkv": 2, "o_proj": 3, "down": 4, "lm_head": 1},
            64: {"gate_up": 1, "wqkv": 1, "o_proj": 1, "down": 1, "lm_head": 1}}
    for M, counts in want.items():
        for name, (C, Wn) in packed.items():
            assert tm.plan_splits(C, C // 128, Wn, M, 132)[0] == counts[name], (name, M)
    assert tm._smem_bytes(1, 32, 0) == 3 * (256 * 32 + 16 * 272 + 8 * 32 * 4)


def test_w8a8_planner_picks_the_predicted_plans():
    """Llama-3.2-3B at 132 SMs, (k-warps, splits): at 12 rows the tiles of
    gate_up (128) and lm_head (1002) fill the card unsplit, two k-warps
    where a block has its SM to itself; wqkv (40 tiles), o_proj and down
    (24) split into clusters of up to three quarters of the SMs. At 64 rows
    four row tiles of terms leave no room for a split or a second k-warp."""
    want = {12: {"gate_up": (2, 1), "wqkv": (1, 2), "o_proj": (2, 4), "down": (1, 4),
                 "lm_head": (1, 1)},
            64: {"gate_up": (1, 1), "wqkv": (1, 1), "o_proj": (1, 1), "down": (1, 1),
                 "lm_head": (1, 1)}}
    for M, plans in want.items():
        for name, (C, Wn) in _W8_SHAPES.items():
            assert tm.plan_w8a8(C, C // 128, Wn, M, 132)[:2] == plans[name], (name, M)
    # down at S 4: whole chunks of 16 scale groups each.
    assert tm.plan_w8a8(8192, 64, 3072, 12, 132)[2] == (0, 2048, 4096, 6144, 8192)
