"""The port's scheduler and HTTP server at dp 2 and dp 2 x tp 2 against the
JAX package's on the same virtual-device mesh, the planted follower fault,
and ``update_session_rows`` at dp 2 (the cases and their gates:
tests/test_torch_mesh_serving.py, which runs the tp 2 and cp 2 spawns).

Spawns: 2 gloo ranks at dp 2 (the scheduler with the prefix cache, prompts
sharing a two-page head; the server; the fault), and 4 ranks started from
the ``LLT_*`` environment on ``make_multihost_mesh(tp=2)`` (dp 2 x tp 2:
the scheduler), both started before the JAX side is computed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from lite_llama_tpu_torch import config as tconfig  # noqa: E402
from lite_llama_tpu_torch.executor.engine import InferenceEngine, _PrefillBundle  # noqa: E402
from lite_llama_tpu_torch.generation.sampling import SamplingParams  # noqa: E402
from lite_llama_tpu_torch.models.decoder import init_decoder_params  # noqa: E402
from lite_llama_tpu_torch.parallel.shardings import Mesh  # noqa: E402
from tests.test_torch_mesh_serving import (  # noqa: E402
    PREFIX_REQUESTS,
    SYS,
    check_scheduler,
    check_server,
    mesh_runs,
)
from tests.test_torch_tp import BASE, ENGINE  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh_serving_dp"), ("dp2", "dp2_tp2"))


@pytest.mark.parametrize("name", ["sched_dp2_prefix", "sched_dp2_tp2"])
def test_scheduler_at_dp_matches_jax_scheduler(runs, name):
    """dp 2 with the prefix cache, and dp 2 x tp 2 from the LLT_*
    environment: every admission's slot is JAX's (``check_scheduler``)."""
    check_scheduler(*runs[name], name)


def test_dp_scheduler_hits_the_prefix_cache_as_jax_does(runs):
    """The prefix case's requests that share the two-page head hit the
    groups' entries as often as JAX's, and each hit lands in a group that
    holds the head's entry (its first request there registered it)."""
    want, ranks = runs["sched_dp2_prefix"]
    assert want["prefix_hits"] >= 2
    assert all(int(d["prefix_hits"]) == want["prefix_hits"] for d in ranks)
    m_local = ENGINE["max_reqs"] // 2
    shared = [i for i, r in enumerate(PREFIX_REQUESTS) if r[0][:16] == SYS]
    groups = [want["slots"][i] // m_local for i in shared]
    first_of = {g: shared[groups.index(g)] for g in set(groups)}
    assert len(first_of) < len(shared)  # some share a group after its entry


def test_server_at_dp_matches_jax_frontend(runs):
    """The HTTP server at dp 2 with the prefix cache (``check_server``)."""
    check_server(*runs["server_dp2"])


def test_a_follower_that_reorders_submits_fails_every_rank_at_once(runs):
    """The planted follower applies a message's two submits in reverse
    order: both ranks raise the digest mismatch on that turn (no engine
    call made), within seconds, and rank 0's loop has ended."""
    _, ranks = runs["fault_dp2"]
    for d in ranks:
        assert "raised" in d, "the planted fault was not caught"
        assert "ControlMismatch" in str(d["raised"]) and "after this message" in str(d["raised"])
        assert int(d["calls"]) == 0
        assert float(d["seconds"]) < 20
    assert bool(ranks[0]["loop_ended"])


def _tiny_engine(mesh, **kw):
    torch.set_num_threads(1)
    cfg = tconfig.LlamaConfig(dtype=torch.float32, **BASE)
    params = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    return InferenceEngine(cfg, params, device="cpu", mesh=mesh, **dict(ENGINE, **kw))


@pytest.mark.parametrize("dp_rank", [0, 1])
def test_update_session_rows_writes_local_rows_at_dp(dp_rank):
    """A full-width session at dp 2 (slots 0..3, two per group) holds this
    rank's group's rows at local positions; splicing rows 1 (group 0) and
    2 (group 1) writes each on its group's rank at its local position and
    leaves every other row alone."""
    eng = _tiny_engine(Mesh(dp=2, dp_rank=dp_rank))
    M = ENGINE["max_reqs"]
    samp = SamplingParams.make(M, temperature=0.0, device="cpu")
    s = eng.start_decode_session(list(range(M)), np.arange(M, dtype=np.int32) + 10,
                                 np.ones(M, bool), np.full(M, 30, np.int32), samp)
    assert s.tok.tolist() == [10 + 2 * dp_rank, 11 + 2 * dp_rank]
    bundle = _PrefillBundle(packed=None, tok_dev=torch.tensor([71, 72]), lens=np.asarray([3, 4]))
    eng.update_session_rows(s, [1, 2], bundle, [3, 4], [20, 21], [0.5, 0.7], [0.9, 0.8], [0, 5])
    pos, tok, stop, temp, top_p, top_k = {0: (1, 71, 20, 0.5, 0.9, 0),
                                          1: (0, 72, 21, 0.7, 0.8, 5)}[dp_rank]
    want_tok = [10 + 2 * dp_rank, 11 + 2 * dp_rank]
    want_tok[pos] = tok
    assert s.tok.tolist() == want_tok
    assert s.done.tolist() == [j != pos for j in range(2)]
    assert s.stop.tolist() == [stop if j == pos else 30 for j in range(2)]
    assert s.samp.temperature[pos].item() == pytest.approx(temp)
    assert s.samp.top_p[pos].item() == pytest.approx(top_p)
    assert int(s.samp.top_k[pos]) == top_k
    assert s.samp.temperature[1 - pos].item() == 0.0
