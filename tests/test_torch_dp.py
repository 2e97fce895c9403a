"""The port at data parallelism on the CPU against the JAX engine on its 8
virtual devices, on the same numpy weights (mirrors tests/test_sharding.py,
tests/test_prefix_cache.py's dp case and tests/test_multihost.py).

The port's side runs as gloo processes (``tests/torch_tp_worker.py``, which
imports no JAX), rendezvous through a FileStore under the test's tmp
directory, or through a localhost TCP coordinator from the ``LLT_*``
environment: one spawn of 2 ranks (tp 1, dp 2) runs its cases, one of 4
ranks (tp 2, dp 2) its case, and one of 4 ranks started from the ``LLT_*``
environment on ``make_multihost_mesh(tp=2)`` (dp 2 x tp 2) the multihost
case, all started before the JAX references are computed. Gates, fp32:

- the greedy tokens equal JAX's on the same mesh, logprobs and first-token
  logits within 1e-4 of the largest logit (``TOL``), with an int8 pool and
  chunked prefill too;
- disjoint requests: each rank's pool holds its group's requests only, and
  the two groups' pools differ; dp divides the work: each rank prefills
  and decodes at its group's width;
- admission: the port's slots equal JAX's ``try_admit`` placements, slot
  for slot, and a prefix hit lands in the group that holds the entry;
- the multihost mesh: every rank's tokens equal, greedy parity with JAX's
  one-device engine, logprobs within JAX's 1e-3.

The refusals that remain at dp (LLaVA, speculative decoding) run
in-process: they raise before any collective.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.executor.engine import InferenceEngine as JEngine  # noqa: E402
from lite_llama_tpu.generation.generate import TextGenerator as JGen  # noqa: E402
from lite_llama_tpu.generation.sampling import SamplingParams as JSampling  # noqa: E402
from lite_llama_tpu.parallel.shardings import make_mesh as j_make_mesh  # noqa: E402
from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine  # noqa: E402
from lite_llama_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from lite_llama_tpu_torch.parallel.shardings import Mesh  # noqa: E402
from tests.test_torch_tp import BASE, ENGINE, GEN, TOL, WORKER, _jax_tree_of  # noqa: E402
from tests.test_torch_tp import same_stream  # noqa: E402
from tests.torch_tp_worker import save_tree  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

REPO = Path(__file__).resolve().parent.parent
PROMPTS4 = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1], [5, 5, 5, 5, 6, 7]]
LONG4 = [[1, 2, 3, 4, 5], list(range(10, 30)), [3, 1], list(range(40, 53))]
SYS = list(range(60, 76))  # two pages of 8: the prefix cases' shared head
P1, P2, P3 = SYS + [7, 8], SYS + [9, 10, 11], [20, 21, 22]
PREFIX_ROUNDS = [[P1], [P2], [P3, P1, P2]]

# case -> (config class, fields, seed, quantize kwargs, engine kwargs, prompts, rounds)
DP2 = {
    "dp2": ("LlamaConfig", BASE, 0, None, {}, PROMPTS4, 1),
    "dp2_int8_chunked": ("LlamaConfig", BASE, 1, None, dict(kv_quant="int8", prefill_chunk=8),
                         LONG4, 1),
    "dp2_prefix": ("LlamaConfig", BASE, 2, None, dict(prefix_cache=True), [P1],
                   PREFIX_ROUNDS),
}
DP2_TP2 = {"dp2_tp2": ("LlamaConfig", BASE, 3, None, {}, PROMPTS4, 1)}
MULTIHOST = {"multihost": ("LlamaConfig", BASE, 4, None, {}, PROMPTS4, 1)}
MESHES = {"dp2": dict(tp=1, dp=2), "dp2_tp2": dict(tp=2, dp=2)}
# JAX's dp engine parts from its own one-device engine with an int8 pool and
# chunked prefill (1.7 of the first-token logits on the chunked rows; fp32
# pools agree): that case is held against JAX's one-device engine.
ONE_DEVICE_REFERENCE = ("dp2_int8_chunked", "multihost")


def worker_case(tmp: Path, name, spec):
    """(the worker's spec of an engine case, its tree written to ``tmp``,
    JAX config, JAX tree)."""
    jcfg, jtree = _jax_tree_of(spec)
    save_tree(str(tmp / f"{name}.npz"), jtree)
    cls, fields, _, _, ekw, prompts, rounds = spec
    return (dict(kind="engine", cfg={"class": cls, "fields": fields},
                 tree=str(tmp / f"{name}.npz"), engine=dict(ENGINE, **ekw), prompts=prompts,
                 gen=GEN, rounds=rounds), jcfg, jtree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_mesh(tmp: Path, tag: str, world: int, cases: dict, mesh=None, env=False):
    """Start ``world`` worker ranks over ``cases`` on ``mesh`` (make_mesh
    keywords; with ``env``, ranks started from the ``LLT_*`` environment on
    ``make_multihost_mesh(tp=mesh["tp"])``). Returns (processes, out dir)."""
    out = tmp / f"out_{tag}"
    out.mkdir()
    spec = {"world": world, "init": f"file://{tmp / f'rendezvous_{tag}'}", "out": str(out),
            "cases": cases, "mesh": mesh or {"tp": world}, "env": env}
    path = tmp / f"spec_{tag}.json"
    path.write_text(json.dumps(spec))
    base = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    if env:
        port = _free_port()
        envs = [dict(base, LLT_DIST="1", LLT_COORD=f"localhost:{port}",
                     LLT_NUM_PROCS=str(world), LLT_PROC_ID=str(r)) for r in range(world)]
    else:
        envs = [base] * world
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(path), str(r)], env=envs[r],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, out


def collect_ranks(procs, out: Path, names):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=420)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = {}
    for name in names:
        ranks = [dict(np.load(out / f"{name}.rank{r}.npz", allow_pickle=True))
                 for r in range(len(procs))]
        for r, d in enumerate(ranks):
            assert "error" not in d, f"{name} rank {r}:\n{d.get('error')}"
        res[name] = ranks
    return res


def jax_reference(spec, jtree, jcfg, mesh_kw=None):
    """The JAX engine's outputs of a case, on ``make_mesh(**mesh_kw)`` (None:
    one device), with the slots of every admission."""
    _, _, _, _, ekw, prompts, rounds = spec
    eng = JEngine(jcfg, jtree, mesh=None if mesh_kw is None else j_make_mesh(**mesh_kw),
                  **dict(ENGINE, **ekw))
    admitted, real = [], eng.admit_requests

    def admit(*a, **k):
        admitted.append(real(*a, **k))
        return admitted[-1]

    eng.admit_requests = admit
    lists = rounds if isinstance(rounds, list) else [prompts] * rounds
    first = lists[0]
    slots = eng.admit_requests([len(p) + 1 for p in first])
    _, lens, last, _ = eng.prefill(first, JSampling.make(len(first), temperature=0.0), slots,
                                   return_logits=True)
    out = {"prefill_logits": np.asarray(last),
           "prefill_pages": np.asarray(eng.cache.kv_pages.pages, np.float32),
           "prefill_table": np.asarray(eng.cache.page_table),
           "prefill_seq_lens": np.asarray(eng.cache.seq_lens)}
    eng.release_slots(slots, lens)
    gen = JGen(eng)
    for r, ps in enumerate(lists):
        res = gen.generate_tokens(ps, max_gen_len=GEN, temperature=0.0, logprobs=True)
        out[f"tokens{r}"] = [o.token_ids for o in res]
        out[f"logprobs{r}"] = [o.logprobs for o in res]
    out["prefix_hits"] = eng.stats.prefix_hits
    out["admitted"] = [list(map(int, a)) for a in admitted]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX outputs, [rank outputs])}: the three spawns start first,
    the JAX side runs while they do."""
    tmp = tmp_path_factory.mktemp("dp")
    groups = (("dp2", 2, DP2, MESHES["dp2"], False),
              ("dp2_tp2", 4, DP2_TP2, MESHES["dp2_tp2"], False),
              ("multihost", 4, MULTIHOST, {"tp": 2}, True))
    jax_side, started = {}, []
    for tag, world, cases, mesh, env in groups:
        specs = {}
        for name, spec in cases.items():
            specs[name], *jax_side[name] = worker_case(tmp, name, spec)
        started.append((spawn_mesh(tmp, tag, world, specs, mesh, env), list(cases)))
    want = {}
    for tag, world, cases, mesh, env in groups:
        for name, spec in cases.items():
            jcfg, jtree = jax_side[name]
            want[name] = jax_reference(spec, jtree, jcfg,
                                       None if name in ONE_DEVICE_REFERENCE else mesh)
    got = {}
    for (procs, out), names in started:
        got.update(collect_ranks(procs, out, names))
    return {k: (want[k], got[k]) for k in want}


def _groups(admitted_first, m_local):
    return [s // m_local for s in admitted_first]


@pytest.mark.parametrize("name", ["dp2", "dp2_int8_chunked", "dp2_tp2"])
def test_engine_at_dp_matches_jax_mesh(runs, name):
    """Greedy tokens equal, logprobs and first-token logits within TOL, on
    every rank (against JAX's mesh, or its one-device engine where JAX's
    mesh parts from it: ``ONE_DEVICE_REFERENCE``); the port placed each
    request where JAX did."""
    want, ranks = runs[name]
    same_stream(want, ranks)
    if name not in ONE_DEVICE_REFERENCE:
        for d in ranks:
            assert [list(a) for a in d["admitted"]] == want["admitted"]


@pytest.mark.parametrize("name", ["dp2", "dp2_tp2"])
def test_dp_groups_hold_disjoint_requests_and_divide_the_work(runs, name):
    """Each rank's pool holds exactly its group's requests after the first
    prefill (admission balanced the groups), the groups' pools differ (no
    replication), and each rank ran its prefills and decode steps at its
    group's width alone."""
    want, ranks = runs[name]
    m_local = ENGINE["max_reqs"] // 2
    first = [int(s) for s in ranks[0]["admitted"][0]]
    per_group = np.bincount(_groups(first, m_local), minlength=2)
    assert per_group.tolist() == [2, 2], first
    by_group = {}
    for d in ranks:
        dp_rank, _, tp_rank, dp, _, tp = (int(x) for x in d["place"])
        assert dp == 2 and tp == MESHES[name]["tp"]
        live = d["prefill_seq_lens"] > 0
        assert int(live.sum()) == per_group[dp_rank]
        lens = sorted(int(n) for n in d["prefill_seq_lens"][live])
        mine = [len(PROMPTS4[i]) for i, s in enumerate(first) if s // m_local == dp_rank]
        assert lens == sorted(mine)
        assert d["prefill_widths"].tolist() == [per_group[dp_rank]] * 2
        assert d["step_widths"].tolist() == [per_group[dp_rank]]
        by_group.setdefault(dp_rank, []).append(d["prefill_pages"])
    for pools in by_group.values():  # the tp ranks of one group hold its pages' heads
        assert all(p.shape == pools[0].shape for p in pools)
    assert not np.array_equal(by_group[0][0], by_group[1][0])


def test_prefix_hits_land_in_the_entry_s_group_as_jax_places_them(runs):
    """tests/test_prefix_cache.py's dp case: the entry registered by the
    first prompt's group takes the later prompts that share its pages, even
    where the other group has more free pages; placements, hits and tokens
    equal JAX's."""
    want, ranks = runs["dp2_prefix"]
    same_stream(want, ranks, rounds=len(PREFIX_ROUNDS))
    m_local = ENGINE["max_reqs"] // 2
    for d in ranks:
        admitted = [[int(s) for s in a] for a in d["admitted"]]
        assert admitted == want["admitted"]
        assert int(d["prefix_hits"]) == want["prefix_hits"] >= 3
        entry_group = admitted[0][0] // m_local
        assert admitted[2][0] // m_local == entry_group  # P2 hit P1's pages
        last = admitted[3]  # P3 (no hit), P1, P2 (hits)
        assert last[1] // m_local == entry_group and last[2] // m_local == entry_group


def test_multihost_mesh_from_the_llt_environment(runs):
    """4 ranks started from the LLT_* environment alone on
    make_multihost_mesh(tp=2): dp 2 x tp 2, every rank's tokens equal,
    greedy parity with JAX's one-device engine, logprobs within 1e-3."""
    want, ranks = runs["multihost"]
    places = sorted(tuple(int(x) for x in d["place"][[0, 2]]) for d in ranks)
    assert places == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(tuple(d["place"][3:]) == (2, 1, 2) for d in ranks)
    for d in ranks:
        assert [list(t) for t in d["tokens0"]] == want["tokens0"]
        worst = max(abs(a - b) for g, w in zip(d["logprobs0"], want["logprobs0"])
                    for a, b in zip(g, w))
        assert worst < 1e-3


def _tiny_engine(mesh, **kw):
    torch.set_num_threads(1)
    cfg = tconfig.LlamaConfig(dtype=torch.float32, **BASE)
    params = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    return InferenceEngine(cfg, params, device="cpu", mesh=mesh, **ENGINE, **kw)


@pytest.mark.parametrize("what", ["generator", "spec_verify", "spec_decode_chunk"])
def test_speculative_decoding_refuses_dp_with_jax_s_message(what):
    """What still refuses a mesh: speculative decoding at dp 2, on both
    ranks, with the JAX engine's message, before any collective (its
    verify chunk has no data-group layout; the scheduler, the server and
    speculative decoding at tp and cp run: tests/test_torch_mesh_serving.py;
    LlavaEngine's dp refusal: the test below)."""
    from lite_llama_tpu_torch.generation.speculative import SpeculativeTextGenerator

    for dp_rank in (0, 1):
        eng = _tiny_engine(Mesh(dp=2, dp_rank=dp_rank))
        with pytest.raises(NotImplementedError,
                           match="speculative decoding: dp meshes unsupported"):
            if what == "generator":
                SpeculativeTextGenerator(eng)
            elif what == "spec_verify":
                eng.spec_verify([0], [[1, 2]], [2])
            else:
                one = torch.ones(1, dtype=torch.int32)
                eng.spec_decode_chunk([0], torch.zeros((1, 64), dtype=torch.int32), one, one,
                                      torch.zeros(1, dtype=torch.bool), [8])


def test_dp_engine_keeps_every_group_s_accounting():
    """A dp 2 rank holds its group's pool (M_local slots, num_pages / dp
    pages) and the host accounting of both groups; admission alternates
    between equal groups, and LlavaEngine refuses the mesh."""
    from lite_llama_tpu_torch.config import LlavaConfig
    from lite_llama_tpu_torch.executor.llava_engine import LlavaEngine

    eng = _tiny_engine(Mesh(dp=2, dp_rank=1))
    assert eng.cache.max_reqs == ENGINE["max_reqs"] // 2
    assert int(eng.cache.free_top) == ENGINE["num_pages"] // 2
    assert eng._pages_by_group == [ENGINE["num_pages"] // 2] * 2
    slots = eng.admit_requests([9, 9, 9])
    assert [eng.group_of(s) for s in slots] == [0, 1, 0]
    assert eng._pages_by_group == [16 - 4, 16 - 2]
    eng.release_slots(slots, [9, 9, 9])  # only group 1's slot has device state here
    assert eng._pages_by_group == [16, 16] and int(eng.cache.free_top) == 16
    assert sorted(eng._free_slots) == list(range(ENGINE["max_reqs"]))
    assert sorted(eng.acquire_slots(4)) == [0, 1, 2, 3]
    lcfg = LlavaConfig(dtype=torch.float32, text_config=dict(
        hidden_size=48, intermediate_size=96, num_hidden_layers=1, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=128), max_seq_len=64)
    lm = init_decoder_params(lcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="data parallelism"):
        LlavaEngine(lcfg, {"lm": lm, "vision": {}, "projector": {}}, device="cpu",
                    mesh=Mesh(dp=2), **ENGINE)
