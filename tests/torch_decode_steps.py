"""The eager reference of the engine's replayed decode step, shared by the
card tests (``test_torch_decode_graph_cuda.py``) and ``chip_smoke.py``:
for the duration, the engine's step of one (session width, sampling mode)
is a ``DecodeStep`` that is never captured, so each chunk calls its body
once a step. Imports no JAX."""

import contextlib


@contextlib.contextmanager
def eager_step(engine, width, mode="greedy"):
    """Put an uncaptured step of (``width``, ``mode``) in place of the
    engine's own for the duration; yields it. The engine's step (captured or
    not yet made) is put back afterwards."""
    from lite_llama_tpu_torch.executor.engine import DecodeStep

    key = (width, mode)
    own = engine._steps.pop(key, None)
    engine._steps[key] = step = DecodeStep(engine, width, mode)
    try:
        yield step
    finally:
        del engine._steps[key]
        if own is not None:
            engine._steps[key] = own
