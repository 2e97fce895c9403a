"""Fresh prefill (K2 / K8) on the CPU, against K5's plain version and the
JAX package, with the same numpy inputs:

1. the identity the port's one prefill template rests on: K2 / K8's plain
   version (``ref.prefill_attention``) equals K5's
   (``chunked_prefill_state_plain``) with start_pos = 0 over an empty pool,
   on every row below lens[b]. On the card K2 and K8 are the no-history
   instance of K5's kernel;
2. both against JAX ``flash_prefill(interpret=True)``, which takes
   ``_flash_prefill_vmem`` where the head dim does not pack (D 80 and 100,
   checked with a spy) and the streamed ``_prefill_kernel`` otherwise, with
   64-row blocks so that its kernel walks two key tiles.

Cases: head dims 64, 80, 100 and 128 x 1, 3, 4 and 8 query heads per kv
head, lengths 128 (= S), 100 (not a multiple of 64), 1 and 0. Tolerance
2e-5 in fp32 (different summation orders), as for the other ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lite_llama_tpu.ops import attention_prefill as jap  # noqa: E402
from lite_llama_tpu_torch import ops  # noqa: E402
from lite_llama_tpu_torch.ops.attention_prefill import chunked_prefill_state_plain  # noqa: E402

TOL = 2e-5
HKV = 2
S = 128
LENS = [128, 100, 1, 0]
CASES = [(D, G) for D in (64, 80, 100, 128) for G in (1, 3, 4, 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(D, G):
    rng = np.random.default_rng(D * 10 + G)
    B, Nq = len(LENS), G * HKV
    q = rng.standard_normal((B, S, Nq, D), np.float32)
    k = rng.standard_normal((B, S, HKV, D), np.float32)
    v = rng.standard_normal((B, S, HKV, D), np.float32)
    return q, k, v, np.asarray(LENS, np.int32)


def _close(got, want, what):
    for b, n in enumerate(LENS):  # pad rows are never read
        np.testing.assert_allclose(np.asarray(got)[b, :n], np.asarray(want)[b, :n], rtol=TOL,
                                   atol=TOL, err_msg=f"{what} b={b}")


def _chunked_plain(q, k, v, lens):
    """K5's plain version with no history: start_pos 0, an empty one-page pool."""
    B, _, _, D = q.shape
    pages = torch.zeros((1, 2, 8, HKV * D))
    table = torch.zeros((B, 1), dtype=torch.int32)
    out, _, _ = chunked_prefill_state_plain(q, k, v, lens, torch.zeros(B, dtype=torch.int32),
                                            pages, 8, 0, table, D**-0.5)
    return out


@pytest.mark.parametrize("D,G", CASES)
def test_fresh_prefill_is_chunked_prefill_with_no_history(D, G):
    q, k, v, lens = map(torch.from_numpy, _inputs(D, G))
    _close(ops.prefill_attention(q, k, v, lens), _chunked_plain(q, k, v, lens),
           "fresh vs chunked")


@pytest.mark.parametrize("D,G", CASES)
def test_fresh_prefill_matches_jax_kernel(monkeypatch, D, G):
    calls = []
    vmem = jap._flash_prefill_vmem

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return vmem(*a, **kw)

    monkeypatch.setattr(jap, "_flash_prefill_vmem", spy)
    # A fresh jit of the same function: its cache is empty, so it traces
    # (and reaches the spy) whatever other tests traced before.
    j_prefill = jax.jit(jap.flash_prefill.__wrapped__,
                        static_argnames=("sm_scale", "interpret", "block_q", "block_k"))
    arrays = _inputs(D, G)
    want = j_prefill(*map(jnp.asarray, arrays), interpret=True, block_q=64, block_k=64)
    packs = D % 128 == 0 or jap.pack_factor(D, HKV) > 0
    assert calls == ([] if packs else [arrays[0].shape])
    q, k, v, lens = map(torch.from_numpy, arrays)
    _close(ops.prefill_attention(q, k, v, lens), want, "K2 / K8 plain vs JAX")
    _close(_chunked_plain(q, k, v, lens), want, "K5 plain, no history, vs JAX")
