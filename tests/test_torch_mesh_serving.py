"""The port's scheduler, HTTP server and speculative decoding on a mesh, on
the CPU, against the JAX package's own objects on the same virtual-device
mesh and the same numpy weights: JAX's ``ContinuousBatchingScheduler``,
``ServingFrontend`` and ``SpeculativeTextGenerator``.

The port's side runs as gloo processes (``tests/torch_tp_worker.py``, which
imports no JAX), started before the JAX references are computed: one spawn
of 2 ranks at tp 2 (the scheduler, the server, speculative decoding, LLaVA
image and text requests through the scheduler), one of 2 ranks at dp 2 (the
scheduler with the prefix cache, the server, the planted follower fault),
one of 2 ranks at cp 2 (the scheduler, speculative decoding), and one of 4
ranks started from the ``LLT_*`` environment on ``make_multihost_mesh(tp=2)``
(dp 2 x tp 2: the scheduler). This file runs the tp 2 and cp 2 spawns;
tests/test_torch_mesh_serving_dp.py the dp ones and the in-process tests, so
the two share the time. Gates, fp32: greedy tokens equal, logprobs
within 1e-4 (``TOL``); the finish reasons equal, a rejected request among
them; at dp every admission's slot equals JAX's placement; every rank's
outputs and engine call counts equal; slots and pages come back.

The server case posts its requests over real HTTP to rank 0 from several
client threads in two waves with an idle gap, while the other ranks follow
rank 0's control messages; ``shutdown`` ends every rank's loop. The planted
fault (a follower applying a message's two submits in reverse order) must
make every rank raise the digest mismatch on that turn, before any step,
within seconds. In-process: ``update_session_rows`` at dp 2 writes a spliced
row at its local position on the rank of its group and leaves the others
alone.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu import config as jconfig  # noqa: E402
from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.executor.llava_engine import LlavaEngine as JLlavaEngine  # noqa: E402
from lite_llama_tpu.executor.scheduler import ContinuousBatchingScheduler as JSched  # noqa
from lite_llama_tpu.generation.speculative import SpeculativeTextGenerator as JSpec  # noqa
from lite_llama_tpu.models.llava import init_llava_params  # noqa: E402
from lite_llama_tpu.parallel.shardings import make_mesh as j_make_mesh  # noqa: E402
from lite_llama_tpu.server import ServingFrontend as JFrontend  # noqa: E402
from tests.test_torch_dp import collect_ranks, spawn_mesh  # noqa: E402
from tests.test_torch_tp import BASE, ENGINE, LLAVA, LLAVA_TOK, TOL, _jax_tree_of  # noqa: E402
from tests.torch_tp_worker import save_tree  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

_rng = np.random.default_rng(18)


def _ids(n):
    return _rng.integers(0, 95, size=n).tolist()


# [prompt, max_gen_len, image row]: more requests than slots, one too long.
REQUESTS = [[_ids(n), g, None] for n, g in ((5, 6), (3, 9), (11, 4), (7, 7), (2, 10), (9, 5),
                                            (4, 8))]
REQUESTS.insert(3, [_ids(64), 4, None])  # fills max_seq_len: rejected_too_long
SYS = _ids(16)  # two pages of 8: the dp prefix case's shared head
PREFIX_REQUESTS = [[SYS + _ids(n), g, None] for n, g in ((2, 6), (5, 5), (1, 7))] + [
    [_ids(6), 5, None], [SYS + _ids(3), 6, None], [SYS + _ids(4), 4, None], [_ids(9), 6, None],
    [SYS + _ids(2), 5, None]]
WAVES = [[0, 1, 2, 3, 4], [5, 6, 7, 8]]
SERVER_REQUESTS = [[_ids(n), g, None] for n, g in ((4, 6), (7, 5), (3, 8), (10, 4), (5, 7),
                                                   (6, 6), (2, 5), (8, 7), (5, 4))]
SPEC_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3], [9, 9, 9, 9, 9],
                [4, 8, 15, 16, 23, 42, 4, 8, 15]]
SPEC_GEN, SPEC_DRAFT, SPEC_MODES = 12, 3, (0, 4)
LLAVA_REQUESTS = [[[5, LLAVA_TOK, 9, 17], 6, 0], [[1, 2, 3, 4, 5], 5, None],
                  [[3, LLAVA_TOK, 4], 7, 1], [[8, 9], 4, None], [[2, LLAVA_TOK, 6, 6], 5, 2]]
SCHED_KW = dict(max_prefill_batch=2)

# case -> (kind, mesh tag, seed, engine kwargs, case fields)
CASES = {
    "sched_tp2": ("sched", "tp2", 10, {}, dict(requests=REQUESTS)),
    "server_tp2": ("server", "tp2", 11, {}, dict(requests=SERVER_REQUESTS)),
    "spec_tp2": ("spec", "tp2", 12, {}, {}),
    "llava_sched_tp2": ("sched", "tp2", 13, {}, dict(requests=LLAVA_REQUESTS, llava=True)),
    "sched_dp2_prefix": ("sched", "dp2", 14, dict(prefix_cache=True),
                         dict(requests=PREFIX_REQUESTS)),
    "server_dp2": ("server", "dp2", 15, dict(prefix_cache=True),
                   dict(requests=SERVER_REQUESTS, background=True)),
    "fault_dp2": ("fault", "dp2", 16, {}, dict(requests=SERVER_REQUESTS[:2])),
    "sched_cp2": ("sched", "cp2", 17, {}, dict(requests=REQUESTS)),
    "spec_cp2": ("spec", "cp2", 18, {}, {}),
    "sched_dp2_tp2": ("sched", "dp2_tp2", 19, {}, dict(requests=REQUESTS)),
}
MESHES = {"tp2": (2, dict(tp=2), False), "dp2": (2, dict(dp=2), False),
          "cp2": (2, dict(cp=2), False), "dp2_tp2": (4, dict(tp=2), True)}
JAX_MESHES = {"tp2": dict(tp=2), "dp2": dict(dp=2), "cp2": dict(cp=2),
              "dp2_tp2": dict(tp=2, dp=2)}


def _llava_tree(tmp: Path):
    jl = jconfig.LlavaConfig(dtype=jnp.float32, **LLAVA)
    ltree = jax.tree_util.tree_map(np.asarray, init_llava_params(jl, jax.random.PRNGKey(1)))
    save_tree(str(tmp / "llava.npz"), ltree)
    px = np.random.default_rng(1).normal(size=(3, 3, 28, 28)).astype(np.float32)
    np.save(tmp / "pixels.npy", px)
    return jl, jax.tree_util.tree_map(jnp.asarray, ltree), px


def worker_spec(tmp: Path, name, llava):
    """(the worker's spec of a case, JAX config, JAX tree)."""
    kind, _, seed, ekw, fields = CASES[name]
    spec = dict(kind=kind, engine=dict(ENGINE, **ekw), sched=SCHED_KW, pixels=str(
        tmp / "pixels.npy"), waves=WAVES, idle_s=0.5, threads=3, prompts=SPEC_PROMPTS,
        gen=SPEC_GEN, draft_len=SPEC_DRAFT, modes=list(SPEC_MODES), **fields)
    if fields.get("llava"):
        jl, jtree, _ = llava
        spec.update(cfg={"fields": LLAVA}, tree=str(tmp / "llava.npz"))
        return spec, jl, jtree
    jcfg, jtree = _jax_tree_of(("LlamaConfig", BASE, seed, None))
    save_tree(str(tmp / f"{name}.npz"), jtree)
    spec.update(cfg={"class": "LlamaConfig", "fields": BASE}, tree=str(tmp / f"{name}.npz"))
    return spec, jcfg, jtree


def _jax_engine(name, jcfg, jtree):
    _, tag, _, ekw, fields = CASES[name]
    cls = JLlavaEngine if fields.get("llava") else JEngine
    return cls(jcfg, jtree, mesh=j_make_mesh(**JAX_MESHES[tag]), **dict(ENGINE, **ekw))


def _recording(sched):
    """Every request JAX's scheduler finishes or rejects, by id."""
    seen = {}
    for attr in ("_finish", "_reject"):
        real = getattr(sched, attr)

        def rec(r, reason, _real=real):
            _real(r, reason)
            seen[r.req_id] = r

        setattr(sched, attr, rec)
    return seen


def jax_sched(name, jcfg, jtree, px):
    eng = _jax_engine(name, jcfg, jtree)
    sched = JSched(eng, **SCHED_KW)
    ids = [sched.submit(p, max_gen_len=g, temperature=0.0,
                        pixel_values=None if im is None else px[im])
           for p, g, im in CASES[name][4]["requests"]]
    done = {r.req_id: r for r in sched.run()}
    res = [done[i] for i in ids]
    return {"tokens0": [r.output_tokens for r in res],
            "logprobs0": [r.output_logprobs for r in res],
            "finish": [r.finish_reason for r in res],
            "slots": [-1 if r.slot is None else int(r.slot) for r in res],
            "prefix_hits": eng.stats.prefix_hits}


def jax_server(name, jcfg, jtree):
    """JAX's ServingFrontend over the same requests, submitted from client
    threads in the same waves with an idle gap."""
    sched = JSched(_jax_engine(name, jcfg, jtree), **SCHED_KW)
    seen = _recording(sched)
    fe = JFrontend(sched)
    reqs, got = CASES[name][4]["requests"], {}

    def client(mine):
        rids = [(i, fe.submit(reqs[i][0], max_gen_len=reqs[i][1], temperature=0.0))
                for i in mine]
        for i, rid in rids:
            got[i] = (rid, fe.result(rid, timeout=300))

    try:
        for w, wave in enumerate(WAVES):
            if w:
                time.sleep(0.5)
            pool = [threading.Thread(target=client, args=(wave[t::3],)) for t in range(3)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=300)
    finally:
        fe.shutdown()
    order = range(len(reqs))
    return {"tokens0": [got[i][1]["tokens"] for i in order],
            "logprobs0": [seen[got[i][0]].output_logprobs for i in order],
            "finish": [got[i][1]["finish_reason"] for i in order]}


def jax_spec(name, jcfg, jtree):
    eng = _jax_engine(name, jcfg, jtree)
    out = {}
    for chunk_steps in SPEC_MODES:
        res = JSpec(eng, draft_len=SPEC_DRAFT, ngram=3, chunk_steps=chunk_steps).generate_tokens(
            SPEC_PROMPTS, max_gen_len=SPEC_GEN)
        out[f"tokens_{chunk_steps}"] = [o.token_ids for o in res]
        out[f"finish_{chunk_steps}"] = [o.finish_reason for o in res]
    return out


def mesh_runs(tmp: Path, tags):
    """{case: (JAX outputs, [rank outputs])} of the cases on the meshes
    ``tags``: their spawns start first, the JAX side runs while they do."""
    llava = _llava_tree(tmp)
    jax_side, started = {}, []
    for tag in tags:
        world, mesh, env = MESHES[tag]
        specs = {}
        for name in [n for n, c in CASES.items() if c[1] == tag]:
            specs[name], *jax_side[name] = worker_spec(tmp, name, llava)
        started.append((spawn_mesh(tmp, tag, world, specs, mesh, env), list(specs)))
    want = {}
    for name, (jcfg, jtree) in jax_side.items():
        kind = CASES[name][0]
        if kind == "sched":
            want[name] = jax_sched(name, jcfg, jtree, llava[2])
        elif kind == "server":
            want[name] = jax_server(name, jcfg, jtree)
        elif kind == "spec":
            want[name] = jax_spec(name, jcfg, jtree)
        else:
            want[name] = None
    got = {}
    for (procs, out), names in started:
        got.update(collect_ranks(procs, out, names))
    return {k: (want[k], got[k]) for k in want}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This file's meshes, tp 2 and cp 2 (dp: test_torch_mesh_serving_dp.py)."""
    return mesh_runs(tmp_path_factory.mktemp("mesh_serving"), ("tp2", "cp2"))


def same_requests(want, ranks):
    """Every rank's tokens and finish reasons equal JAX's; logprobs (where
    the rank has them: streamed requests carry none) within TOL."""
    for d in ranks:
        assert [list(t) for t in d["tokens0"]] == want["tokens0"]
        assert list(d["finish"]) == want["finish"]
        for g, w in zip(d["logprobs0"], want["logprobs0"]):
            if len(g):
                np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=TOL, atol=TOL)


def check_scheduler(want, ranks, name):
    """Per-request greedy tokens, logprobs and finish reasons equal JAX's
    scheduler on the same mesh on every rank (a request rejected as too
    long among them); at dp every admission takes JAX's slot; every rank
    made the same engine calls, and every slot and page came back."""
    same_requests(want, ranks)
    if name != "llava_sched_tp2":
        assert "rejected_too_long" in want["finish"] or name == "sched_dp2_prefix"
    if "dp2" in name:
        for d in ranks:
            assert d["slots"].tolist() == want["slots"]
    assert len({int(d["calls"]) for d in ranks}) == 1
    assert all(bool(d["drained"]) for d in ranks)


def check_server(want, ranks):
    """Rank 0's HTTP results and streams (two waves from client threads,
    an idle gap between them) equal JAX's ServingFrontend on the same mesh;
    the followers took as many turns as rank 0 (the digests never
    differed: a difference raises), stepped, made rank 0's engine calls,
    and their loops ended at shutdown; every slot and page came back."""
    same_requests(want, ranks[:1])
    assert any(len(g) for g in ranks[0]["logprobs0"])
    turns = {int(d["turns"]) for d in ranks}
    assert len(turns) == 1 and turns.pop() > len(SERVER_REQUESTS)
    assert all(int(d["steps"]) > 0 for d in ranks[1:])
    assert len({int(d["calls"]) for d in ranks}) == 1
    assert all(bool(d["drained"]) for d in ranks)


@pytest.mark.parametrize("name", ["sched_tp2", "sched_cp2", "llava_sched_tp2"])
def test_scheduler_on_a_mesh_matches_jax_scheduler(runs, name):
    """tp 2, cp 2, and LLaVA image and text requests at tp 2
    (``check_scheduler``)."""
    check_scheduler(*runs[name], name)


def test_server_at_tp_matches_jax_frontend(runs):
    """The HTTP server at tp 2 (``check_server``)."""
    check_server(*runs["server_tp2"])


@pytest.mark.parametrize("name", ["spec_tp2", "spec_cp2"])
def test_speculative_decoding_on_a_mesh_matches_jax(runs, name):
    """Per-step and chunked streams equal JAX's SpeculativeTextGenerator on
    the same mesh on every rank, with every page back after the rewinds;
    the verify step ran eagerly."""
    want, ranks = runs[name]
    for d in ranks:
        for m in SPEC_MODES:
            assert [list(t) for t in d[f"tokens_{m}"]] == want[f"tokens_{m}"]
            assert list(d[f"finish_{m}"]) == want[f"finish_{m}"]
            assert bool(d[f"drained_{m}"])
        assert not d["spec_graphs"].any()  # eager on the CPU, and at tp / cp on the card
    assert want["tokens_0"] == want["tokens_4"]
