"""The eager references of the engine's replayed decode, speculative and
chunked-prefill steps, shared by the card tests
(``test_torch_decode_graph_cuda.py``, ``test_torch_kernels_cuda.py``) and
``chip_smoke.py``: for the duration, the engine's step of one key is a
``DecodeStep`` (``SpecStep``, ``ChunkStep``) that is never captured, so
each call runs its body once. Imports no JAX."""

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


@contextlib.contextmanager
def eager_spec_step(engine, width, K, ngram, S, n_steps):
    """The speculative counterpart of :func:`eager_step`: an uncaptured
    ``SpecStep`` of (``width``, ``K``, ``ngram``, ``S``, ``n_steps``) in
    place of the engine's own for the duration; yields it."""
    from lite_llama_tpu_torch.executor.engine import SpecStep

    key = (width, K, ngram, S, n_steps)
    own = engine._spec_steps.pop(key, None)
    engine._spec_steps[key] = step = SpecStep(engine, *key)
    try:
        yield step
    finally:
        del engine._spec_steps[key]
        if own is not None:
            engine._spec_steps[key] = own


@contextlib.contextmanager
def eager_chunk_steps(engine):
    """Every chunked-prefill step the engine uses for the duration is a new
    ``ChunkStep`` that is never captured (one eager chunk a call)."""
    from lite_llama_tpu_torch.executor.engine import ChunkStep

    engine.chunk_step_for = lambda width, W: ChunkStep(engine, width, W)
    try:
        yield
    finally:
        del engine.chunk_step_for  # the class's method again
