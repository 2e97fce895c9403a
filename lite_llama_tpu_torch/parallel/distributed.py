"""Process-group start-up and the collectives of tensor parallelism (port of
``lite_llama_tpu/parallel/distributed.py``).

The JAX package runs tensor parallelism as one SPMD program (GSPMD inserts
the collectives); the port runs one process per tp rank over
``torch.distributed`` and makes the collectives explicit: an all-reduce
after o_proj and after down, one after the masked embedding gather, and an
all-gather of the vocab-sharded logits (``models/decoder.py``).

Execution contract, as in the JAX package, SPMD host replication: every
rank runs the same host program and issues identical engine calls (same
requests, same order, same seed), so the host accounting (slots, pages,
prefix entries, the sampler's generator) stays identical on every rank
with no coordination messages, and every rank samples the same token from
the gathered logits. Start it from the ``LLT_*`` environment:

    LLT_DIST=1 LLT_COORD=localhost:8476 LLT_NUM_PROCS=2 LLT_PROC_ID=0 python ...

(``LLT_BACKEND=gloo`` for the gloo backend), or by hand:
``init_distributed("localhost:8476", 2, rank, backend="nccl")``.

The backend is explicit: NCCL by default on CUDA, gloo when asked for (the
CPU tests; two ranks sharing one card, which NCCL refuses). Every group gets
a timeout, so a collective that never completes fails the run. The
collectives run in fp32 (the partial sums, the embedding rows, the logits):
an exact sum of one row and zeros for the embedding, the JAX kernel
wrapper's fp32 psum for the matmuls. gloo takes the CUDA tensors as they
are (torch 2.11 on an H100: no staging through host memory).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: Optional[str] = None) -> bool:
    """Start ``torch.distributed`` from the arguments or the ``LLT_*``
    environment; returns True when a process group is up (False, a no-op,
    when neither configures one). ``coordinator_address`` is "host:port"
    of rank 0 (``tcp://`` rendezvous); ``init_method`` (a ``file://`` path,
    say) replaces it. ``backend``: "nccl" by default where CUDA is
    available, else "gloo"."""
    if coordinator_address is None and init_method is None:
        if os.environ.get("LLT_DIST") != "1":
            return False
        coordinator_address = os.environ["LLT_COORD"]
        num_processes = int(os.environ["LLT_NUM_PROCS"])
        process_id = int(os.environ["LLT_PROC_ID"])
        backend = backend or os.environ.get("LLT_BACKEND")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, in fp32, returned in x's dtype."""
    t = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.to(x.dtype)


def all_gather_last(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated on the last axis in rank order, in
    x's dtype (gathered in fp32)."""
    t = x.float().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1).to(x.dtype)


def all_reduce_min_int(value: int, device, group=None) -> int:
    """The least of an int over the group (the engine's page budget: every
    rank must size its pool alike)."""
    dev = torch.device(device)
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())
