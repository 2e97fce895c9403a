"""The port at tensor parallelism on the CPU against the JAX engine on
``make_mesh(tp=N)`` (8 virtual devices), on the same numpy weights.

The port's side runs as gloo processes (``tests/torch_tp_worker.py``, which
imports no JAX), rendezvous through a FileStore under the test's tmp
directory: one spawn of 2 ranks runs every tp 2 case and one spawn of 4 the
tp 4 case, started before the JAX references are computed, so the two run
side by side. Gates, fp32 throughout: the greedy tokens equal, logprobs and
the first-token logits within 1e-4 of the largest logit (``TOL``), for

- fp32 weights (tp 2 and tp 4), an int8 pool (its local pages and global
  scale lanes against JAX's pool), Qwen2's biases (the shard-periodic
  ``qkv_bias``), chunked prefill with a prefix-cache hit;
- LLaVA with its LM sharded (the tower and the projector whole).

The int4 W4A8 case runs in tests/test_torch_sharding.py (a spawn of its
own, so the two files share the time). The tp 1 path stays the one-device
path (no spawn).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lite_llama_tpu.ops as jops  # noqa: E402
from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.executor.llava_engine import LlavaEngine as JLlavaEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.generation.llava_generate import LlavaTextGenerator as JLlavaGen  # noqa: E402
from lite_llama_tpu.generation.sampling import SamplingParams as JSampling  # noqa: E402
from lite_llama_tpu.models.llava import init_llava_params  # noqa: E402
from lite_llama_tpu.parallel.shardings import make_mesh as j_make_mesh  # noqa: E402
from lite_llama_tpu.quant import qtensor as jq  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.generation.generate import TextGenerator  # noqa: E402
from lite_llama_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from lite_llama_tpu_torch.parallel.shardings import make_mesh  # noqa: E402
from tests.test_torch_decoder import _jax_tree, numpy_params  # noqa: E402
from tests.torch_tp_worker import save_tree  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_tp_worker.py"
TOL = 1e-4
BASE = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=96, max_seq_len=64,
            eos_token_id=95)
ENGINE = dict(page_size=8, max_reqs=4, num_pages=32, decode_chunk=4)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]]
SHARED = list(range(30, 46))  # two pages of 8: the prefix case's shared prompt head
PREFIX_PROMPTS = [SHARED + [3, 4, 5], SHARED + [7, 8, 9, 10, 11], SHARED + [12]]
LLAVA_TOK = 120
LLAVA = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, image_size=28, patch_size=14),
    text_config=dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                     rms_norm_eps=1e-5, rope_theta=10000.0),
    image_token_index=LLAVA_TOK, max_seq_len=64, eos_token_id=127,
)
LLAVA_PROMPTS = [[5, LLAVA_TOK, 9, 17], [3, LLAVA_TOK, 4], [1, 2, 3, 4, 5]]

# case -> (config class, fields, seed, quantize kwargs, engine kwargs, prompts, rounds)
CASES = {
    "fp32": ("LlamaConfig", BASE, 0, None, {}, PROMPTS, 1),
    "int8_pool": ("LlamaConfig", BASE, 1, None, dict(kv_quant="int8"), PROMPTS, 1),
    "qwen2_bias": ("Qwen2Config", BASE, 2, None, {}, PROMPTS, 1),
    "chunked_prefix": ("LlamaConfig", BASE, 3, None, dict(prefix_cache=True, prefill_chunk=8),
                       PREFIX_PROMPTS, 2),
}
TP4 = {"fp32_tp4": ("LlamaConfig", dict(BASE, num_key_value_heads=4), 5, None, {}, PROMPTS, 1)}
GEN = 8


def _jax_tree_of(spec):
    """(JAX config, JAX tree) of a case: numpy weights from its seed,
    quantized by the JAX quantizer where the case asks (int4)."""
    cls, fields, seed, quant, *_ = spec
    jcfg = getattr(jconfig, cls)(dtype=jnp.float32, **fields)
    tree = _jax_tree(numpy_params(jcfg, seed=seed))
    if quant:
        tree = jq.quantize_decoder_params(tree, jnp.int4, **quant)
    return jcfg, tree


def engine_case(tmp: Path, name, spec) -> dict:
    """The worker's spec of an engine case, its tree written to ``tmp``;
    returns (spec, JAX config, JAX tree)."""
    jcfg, jtree = _jax_tree_of(spec)
    save_tree(str(tmp / f"{name}.npz"), jtree)
    cls, fields, _, _, ekw, prompts, rounds = spec
    return (dict(kind="engine", cfg={"class": cls, "fields": fields},
                 tree=str(tmp / f"{name}.npz"), engine=dict(ENGINE, **ekw), prompts=prompts,
                 gen=GEN, rounds=rounds), jcfg, jtree)


def spawn(tmp: Path, world: int, cases: dict):
    """Start ``world`` worker ranks over ``cases`` (their trees written
    first); returns (processes, output directory)."""
    out = tmp / f"out{world}"
    out.mkdir()
    spec = {"world": world, "init": f"file://{tmp / f'rendezvous{world}'}", "out": str(out),
            "cases": cases}
    path = tmp / f"spec{world}.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(path), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, out


def collect(procs, out: Path, names):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=420)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    world = len(procs)
    res = {}
    for name in names:
        ranks = [dict(np.load(out / f"{name}.rank{r}.npz", allow_pickle=True))
                 for r in range(world)]
        for r, d in enumerate(ranks):
            assert "error" not in d, f"{name} rank {r}:\n{d.get('error')}"
        res[name] = ranks
    return res


def jax_run(spec, world, jtree, jcfg):
    _, _, _, quant, ekw, prompts, rounds = spec
    prev = jops._BACKEND
    if quant:
        jops.set_backend("pallas")  # the manual-tp W4A8 wrapper, interpret mode on the CPU
    try:
        eng = JEngine(jcfg, jtree, mesh=j_make_mesh(tp=world, dp=1), **ENGINE, **ekw)
        slots = eng.admit_requests([len(p) + 1 for p in prompts])
        _, lens, last, _ = eng.prefill(prompts, JSampling.make(len(prompts), temperature=0.0),
                                       slots, return_logits=True)
        eng.release_slots(slots, lens)
        out = {"prefill_logits": np.asarray(last)}
        gen = JGen(eng)
        for r in range(rounds):
            res = gen.generate_tokens(prompts, max_gen_len=GEN, temperature=0.0, logprobs=True)
            out[f"tokens{r}"] = [o.token_ids for o in res]
            out[f"logprobs{r}"] = [o.logprobs for o in res]
        out["prefix_hits"] = eng.stats.prefix_hits
        pool = eng.cache.kv_pages
        out["pages"] = np.asarray(pool.pages)
        out["scales"] = None if pool.scales is None else np.asarray(pool.scales, np.float32)
        return out
    finally:
        jops.set_backend(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case: {case: (JAX outputs, [rank outputs])}."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_side, specs = {}, {}
    for group in (CASES, TP4):
        specs[id(group)] = {}
        for name, spec in group.items():
            specs[id(group)][name], *jax_side[name] = engine_case(tmp, name, spec)
    # LLaVA: the JAX initialiser's tree, carried as numpy.
    jl = jconfig.LlavaConfig(dtype=jnp.float32, **LLAVA)
    ltree = jax.tree_util.tree_map(np.asarray, init_llava_params(jl, jax.random.PRNGKey(0)))
    save_tree(str(tmp / "llava.npz"), ltree)
    px = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
    np.save(tmp / "pixels.npy", px)
    specs[id(CASES)]["llava"] = dict(kind="llava", cfg={"fields": LLAVA},
                                     tree=str(tmp / "llava.npz"), engine=ENGINE,
                                     prompts=LLAVA_PROMPTS, gen=GEN,
                                     pixels=str(tmp / "pixels.npy"))
    p2, out2 = spawn(tmp, 2, specs[id(CASES)])
    p4, out4 = spawn(tmp, 4, specs[id(TP4)])
    want = {}
    for group, world in ((CASES, 2), (TP4, 4)):
        for name, spec in group.items():
            jcfg, jtree = jax_side[name]
            want[name] = jax_run(spec, world, jtree, jcfg)
    jeng = JLlavaEngine(jl, jax.tree_util.tree_map(jnp.asarray, ltree),
                        mesh=j_make_mesh(tp=2, dp=1), **ENGINE)
    toks = [[] for _ in LLAVA_PROMPTS]
    for new in JLlavaGen(jeng).stream_tokens_multimodal(LLAVA_PROMPTS, px, max_gen_len=GEN,
                                                        temperature=0.0):
        for i, ids in enumerate(new):
            toks[i].extend(ids)
    want["llava"] = {"tokens0": toks}
    got = collect(p2, out2, list(CASES) + ["llava"])
    got.update(collect(p4, out4, list(TP4)))
    return {k: (want[k], got[k]) for k in want}


def same_stream(want, ranks, rounds=1):
    top = np.abs(want["prefill_logits"]).max()
    for r in ranks:  # every rank samples the same tokens from the gathered logits
        np.testing.assert_allclose(r["prefill_logits"], want["prefill_logits"], rtol=0,
                                   atol=TOL * top)
        for i in range(rounds):
            assert [list(t) for t in r[f"tokens{i}"]] == want[f"tokens{i}"]
            for g, w in zip(r[f"logprobs{i}"], want[f"logprobs{i}"]):
                np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["fp32", "qwen2_bias", "fp32_tp4"])
def test_engine_at_tp_matches_jax_mesh(runs, name):
    want, ranks = runs[name]
    same_stream(want, ranks)
    world = len(ranks)
    cfg = (CASES | TP4)[name][1]
    ntot = cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"]
    for r, d in enumerate(ranks):
        assert int(d["head_offset"]) == r * cfg["num_key_value_heads"] // world
        assert tuple(d["local_wqkv_shape"])[2] == ntot // world  # the fused head axis shards


def test_int8_pool_at_tp_matches_jax_pool(runs):
    """Tokens and logits as above; each rank's pages are JAX's channel slice
    of its kv heads, and its scale lanes JAX's lanes of those global heads
    (the other lanes of its slab unused: zero)."""
    want, ranks = runs["int8_pool"]
    same_stream(want, ranks)
    Hkv, D = BASE["num_key_value_heads"], BASE["head_dim"]
    hl = Hkv // 2
    for r, d in enumerate(ranks):
        jp = want["pages"][..., r * hl * D:(r + 1) * hl * D].astype(np.int32)
        assert np.abs(d["pages"].astype(np.int32) - jp).max() <= 1  # an int8 rounding step
        for half in (0, 64):
            lanes = slice(half + r * hl, half + (r + 1) * hl)
            np.testing.assert_allclose(d["scales"][..., lanes], want["scales"][..., lanes],
                                       rtol=1e-2, atol=1e-6)
        others = np.ones(128, bool)
        others[r * hl:(r + 1) * hl] = others[64 + r * hl:64 + (r + 1) * hl] = False
        assert not d["scales"][..., others].any()


def test_chunked_prefill_with_a_prefix_hit_at_tp_matches_jax(runs):
    want, ranks = runs["chunked_prefix"]
    same_stream(want, ranks, rounds=2)
    assert want["prefix_hits"] >= 3
    assert all(int(d["prefix_hits"]) == want["prefix_hits"] for d in ranks)


def test_llava_with_a_tp_sharded_lm_matches_jax(runs):
    want, ranks = runs["llava"]
    for d in ranks:
        assert [list(t) for t in d["tokens0"]] == want["tokens0"]
    assert all(1 <= len(t) <= GEN for t in want["tokens0"])


def test_tp1_mesh_is_the_one_device_path():
    """``make_mesh(1)`` (and a tp 1 policy) runs exactly the code of no
    mesh: the same tokens and logits bit for bit, no process group."""
    torch.set_num_threads(1)
    cfg = tconfig.LlamaConfig(dtype=torch.float32, **BASE)
    params = init_decoder_params(cfg, torch.Generator().manual_seed(0), 0.1)
    outs = []
    for mesh in (None, make_mesh(tp=1)):
        eng = InferenceEngine(cfg, params, device="cpu", mesh=mesh, **ENGINE)
        assert "wq" in eng.params["layers"]  # no fusion at tp 1 for plain weights
        res = TextGenerator(eng).generate_tokens(PROMPTS, max_gen_len=GEN, temperature=0.0,
                                                 logprobs=True)
        outs.append([(o.token_ids, o.logprobs) for o in res])
    assert outs[0] == outs[1]
    with pytest.raises(RuntimeError, match="torch.distributed"):  # dp, cp: ranks of a group
        make_mesh(tp=1, dp=2)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(tp=1, cp=2)
