"""LLaVA with int4 LM weights and an int8 KV pool, and ``init_llava_params``,
against the JAX package on the CPU at a tiny size (the shapes of
tests/test_torch_llava_generate.py, an untied head):

1. ``models/llava.py`` ``init_llava_params`` gives the JAX tree's keys,
   shapes and dtypes (the tower and projector in the given dtype, the LM
   in the config's), its projector N(0, 0.02) with zero biases, and the
   same tree from the same seed;
2. the LM quantized to int4 g16 in the interleaved layout (as LLaVA-1.5-7B
   runs it: riffle refuses Vicuna's ffn width in both packages) gives JAX's
   bytes and scales bit for bit, the tower and projector staying as they
   are; ``LlavaEngine`` on that tree and an int8 pool gives JAX's
   ``LlavaEngine``'s first-token logits of a multimodal prefill and its
   greedy tokens for image and text requests through
   ``LlavaTextGenerator``; at these widths every projection takes the W4A16
   route (K9's plain version), in both packages.

Tolerances: bit-equal bytes and scales; 1e-4 of the largest logit, as for
the quantized decoder tests (fp32 sums in another order); tokens equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.config import LlavaConfig as JLlava  # noqa: E402
from lite_llama_tpu.executor.llava_engine import LlavaEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.llava_generate import LlavaTextGenerator as JGen  # noqa: E402
from lite_llama_tpu.generation.sampling import SamplingParams as JSampling  # noqa: E402
from lite_llama_tpu.models import llava as jllava  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch.config import LlavaConfig  # noqa: E402
from lite_llama_tpu_torch.executor.llava_engine import LlavaEngine  # noqa: E402
from lite_llama_tpu_torch.generation.llava_generate import LlavaTextGenerator  # noqa: E402
from lite_llama_tpu_torch.generation.sampling import SamplingParams  # noqa: E402
from lite_llama_tpu_torch.models import llava as tllava  # noqa: E402
from lite_llama_tpu_torch.ops import qmatmul as tqmm  # noqa: E402
from lite_llama_tpu_torch.quant import qtensor as tq  # noqa: E402
from lite_llama_tpu_torch.utils.weights import params_from_numpy  # noqa: E402

IMG_TOK = 120
CFG = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, image_size=28, patch_size=14),
    text_config=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                     rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False),
    image_token_index=IMG_TOK, max_seq_len=64, eos_token_id=127,
)
ENGINE = dict(page_size=8, max_reqs=4, num_pages=48, decode_chunk=4, kv_quant="int8")
MM_PROMPTS = [[5, IMG_TOK, 9, 17], [3, IMG_TOK, 4], [1, 2, 3, 4, 5]]  # the last: no image
GS = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_init_llava_params_tree_matches_jax(dtype):
    jcfg = JLlava(dtype=jnp.float32, **CFG)
    tcfg = LlavaConfig(dtype=torch.float32, **CFG)
    want = _leaves(jax.eval_shape(lambda k: jllava.init_llava_params(
        jcfg, k, dtype=dtype and jnp.dtype(dtype)), jax.random.PRNGKey(0)))
    got = _leaves(tllava.init_llava_params(tcfg, torch.Generator().manual_seed(0),
                                           dtype=dtype and getattr(torch, dtype)))
    assert set(got) == set(want) and "lm/lm_head" in got
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k


def test_init_llava_params_draws():
    tcfg = LlavaConfig(dtype=torch.float32, **CFG)
    a = tllava.init_llava_params(tcfg, torch.Generator().manual_seed(3))
    b = tllava.init_llava_params(tcfg, torch.Generator().manual_seed(3))
    c = tllava.init_llava_params(tcfg, torch.Generator().manual_seed(4))
    la, lb, lc = _leaves(a), _leaves(b), _leaves(c)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["projector/w1"], lc["projector/w1"])
    pr = a["projector"]
    assert torch.count_nonzero(pr["b1"]) == 0 and torch.count_nonzero(pr["b2"]) == 0
    w = torch.cat([pr["w1"].reshape(-1), pr["w2"].reshape(-1)])
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 0.002


@pytest.fixture(scope="module")
def quantized():
    """(JAX config, JAX tree, port config, port tree): one fp32 LLaVA tree,
    its LM quantized to int4 g16 interleaved by each package."""
    jcfg = JLlava(dtype=jnp.float32, **CFG)
    tcfg = LlavaConfig(dtype=torch.float32, **CFG)
    tree = jax.tree_util.tree_map(np.asarray, jllava.init_llava_params(jcfg,
                                                                       jax.random.PRNGKey(1)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp["lm"] = jq.quantize_decoder_params(jp["lm"], jnp.int4, group_size=GS)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    tp["lm"] = tq.quantize_decoder_params(tp["lm"], "int4", group_size=GS)
    return jcfg, jp, tcfg, tp


def test_int4_lm_bytes_and_scales_match_jax(quantized):
    _, jp, _, tp = quantized
    jl, tl = _leaves(jp["lm"]), _leaves(tp["lm"])
    assert set(jl) == set(tl)
    packed = 0
    for k, j in jl.items():
        t = tl[k]
        if isinstance(j, jq.QTensor):
            assert isinstance(t, tq.QTensor) and t.packed and not t.riffle_groups, k
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), err_msg=k)
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale), err_msg=k)
            packed += 1
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)
    assert packed == 6  # wq, wkv, o_proj, gate_up, down and the head
    for part in ("vision", "projector"):
        assert not any(isinstance(v, tq.QTensor) for v in _leaves(tp[part]).values())


def _pixels(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3, 28, 28)).astype(np.float32)


def _engines(quantized):
    jcfg, jp, tcfg, tp = quantized
    return JEngine(jcfg, jp, **ENGINE), LlavaEngine(tcfg, tp, device="cpu", **ENGINE)


def test_int4_int8_pool_multimodal_prefill_logits_match_jax(quantized, monkeypatch):
    jeng, teng = _engines(quantized)
    assert teng.cache.kv_pages.quantized
    calls = []
    real = tq.quantized_matmul_w4a16
    monkeypatch.setattr(tq, "quantized_matmul_w4a16", lambda *a: calls.append(1) or real(*a))
    px = _pixels(3, seed=5)
    want = jeng.prefill_multimodal(MM_PROMPTS, px, JSampling.make(3, temperature=0.0),
                                   jeng.admit_requests([20] * 3))
    got = teng.prefill_multimodal(MM_PROMPTS, px,
                                  SamplingParams.make(3, temperature=0.0, device="cpu"),
                                  teng.admit_requests([20] * 3), return_logits=True)
    logits = np.asarray(want[2])[:3]
    np.testing.assert_array_equal(got[0], np.asarray(want[0])[:3])
    np.testing.assert_allclose(got[2], logits, rtol=0, atol=1e-4 * np.abs(logits).max())
    # wq and wkv fused, o_proj, gate_up (two stacked halves: one call), down, the head
    assert len(calls) == 4 * 2 + 1


def test_int4_int8_pool_greedy_tokens_match_jax(quantized):
    jeng, teng = _engines(quantized)
    px = _pixels(3, seed=7)

    def streamed(gen):
        out = [[] for _ in MM_PROMPTS]
        for new in gen.stream_tokens_multimodal(MM_PROMPTS, px, max_gen_len=10,
                                                temperature=0.0):
            for i, ids in enumerate(new):
                out[i].extend(ids)
        return out

    launches = tqmm.launch_quantized_matmul_w4a16.launches
    got = streamed(LlavaTextGenerator(teng))
    assert got == streamed(JGen(jeng))
    assert all(1 <= len(t) <= 10 for t in got)
    assert tqmm.launch_quantized_matmul_w4a16.launches == launches  # the CPU: plain version


def test_llava_engine_builds_from_init_llava_params_with_int4_lm():
    """A random tree straight from ``init_llava_params``, its LM quantized,
    serves an image request on an int8 pool."""
    tcfg = LlavaConfig(dtype=torch.float32, **CFG)
    tree = tllava.init_llava_params(tcfg, torch.Generator().manual_seed(0))
    tree = dict(tree, lm=tq.quantize_decoder_params(tree["lm"], "int4", group_size=GS))
    eng = LlavaEngine(tcfg, tree, device="cpu", **ENGINE)
    out = []
    for new in LlavaTextGenerator(eng).stream_tokens_multimodal(
            MM_PROMPTS[:1], _pixels(1), max_gen_len=6, temperature=0.0):
        out.extend(new[0])
    assert 1 <= len(out) <= 6 and all(0 <= t < tcfg.vocab_size for t in out)
    assert isinstance(eng.params["layers"]["down_proj"], tq.QTensor)
