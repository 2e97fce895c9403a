"""Process-group start-up, the multi-process mesh and the collectives (port
of ``lite_llama_tpu/parallel/distributed.py``).

The JAX package runs its mesh as one SPMD program (GSPMD inserts the
collectives); the port runs one process per rank over ``torch.distributed``
and makes the collectives explicit. tp: an all-reduce after o_proj and after
down, one after the masked embedding gather, and an all-gather of the
vocab-sharded logits (``models/decoder.py``). dp: one all-gather of each
call's sampled tokens and logprobs over the data groups (the JAX engine's
``_fetch``; ``executor/engine.py``). cp: one all-gather of each attention
call's online-softmax states over the context ranks
(``parallel/context_parallel.py``).

Execution contract, as in the JAX package, SPMD host replication: every
rank runs the same host program and issues identical engine calls (same
requests, same order, same seed), so the host accounting (slots, pages,
prefix entries, the sampler's generator) stays identical on every rank
with no coordination messages, and every rank samples the same token from
the gathered logits. Serving keeps the contract with one message a
scheduler iteration (``ControlChannel``): the requests reach rank 0 only,
so rank 0 broadcasts them, in submit order, to every rank over a CPU gloo
group of the whole mesh that the mesh makes for it, apart from the step's
collectives; every rank then submits and steps alike, and the ranks agree
on a digest of their accounting before any of them steps. Start it from
the ``LLT_*`` environment:

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

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)  # init_distributed's, for new groups


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
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=_timeout)
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


def all_gather_padded(x: torch.Tensor, width: int, group=None) -> list:
    """Each rank's ``x`` [n_r, ...] in rank order, as [width, ...] tensors:
    the rows padded with zeros to ``width`` (>= every n_r, the same on every
    rank) and gathered in one call; the caller knows each n_r."""
    pad = torch.zeros((width - x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return all_gather_stack(torch.cat([x, pad]), group)


def all_gather_stack(x: torch.Tensor, group=None) -> list:
    """The group's ``x`` (one shape on every rank), in rank order."""
    t = x.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _host_grid(tp: Optional[int] = None, group=None):
    """The ('dp', 'cp', 'tp') rank grid of :func:`make_multihost_mesh` and
    this process's index among its host's ranks: the ranks grouped by host
    (in order of each host's first rank), rank-major within a host, tp
    ranks on one host and dp across hosts (JAX's fallback, which groups
    devices by process). ``tp`` defaults to the ranks of one host."""
    import socket

    import numpy as np

    world = dist.get_world_size(group)
    if torch.cuda.is_available():  # NCCL gathers objects through the current card
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(world))
    order = []
    for h in hosts:
        if h not in order:
            order.append(h)
    by_host = [[r for r, h in zip(ranks, hosts) if h == name] for name in order]
    n_local = len(by_host[0])
    if any(len(b) != n_local for b in by_host):
        raise ValueError(f"hosts hold unequal rank counts: {[len(b) for b in by_host]}")
    tp = tp or n_local
    if n_local % tp:
        raise ValueError(f"tp={tp} does not divide the {n_local} ranks of a host")
    me = dist.get_rank()
    local = next(b.index(me) for b in by_host if me in b)
    grid = np.asarray([r for b in by_host for r in b]).reshape(-1, 1, tp)
    return grid, local


def make_multihost_mesh(tp: Optional[int] = None, group=None):
    """The ('dp', 'tp') mesh over every rank (counterpart of JAX's
    ``make_multihost_mesh``): tp = ``tp`` ranks of one host (default all of
    them), dp = the hosts times the tp groups a host holds (:func:`_host_grid`).
    Each rank takes the card ``cuda:(its index on the host % cards)`` where
    CUDA is available (several ranks share a card when a host runs more
    ranks than it has cards). Every rank must call it."""
    from .shardings import mesh_from_grid

    grid, local = _host_grid(tp, group)
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    return mesh_from_grid(grid, group)


def all_reduce_min_int(value: int, device, group=None) -> int:
    """The least of an int over the group (the engine's page budget: every
    rank must size its pool alike)."""
    dev = torch.device(device)
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


# ---------------------------------------------------------------------------
# The serving control channel: rank 0's requests, broadcast to every rank


def control_group(ranks):
    """A CPU gloo group over ``ranks`` (the whole mesh) for the control
    messages, with the process group's timeout: its messages never share a
    communicator or a stream with the steps' collectives. Every rank of
    the world must call it, in the same order as its other group-making
    calls (``shardings.mesh_from_grid`` does)."""
    return dist.new_group([int(r) for r in ranks], backend="gloo", timeout=_timeout)


@dataclasses.dataclass
class ControlMessage:
    """One scheduler iteration's orders from rank 0: the requests submitted
    since the last message, in submit order (dicts of ``rid``,
    ``prompt_tokens``, ``max_gen_len``, ``temperature``, ``top_p``,
    ``top_k``, ``pixel_values``), whether the iteration steps, whether the
    server stops, and rank 0's accounting digest after the previous
    iteration (``ContinuousBatchingScheduler.digest``)."""

    submits: list
    step: bool
    stop: bool
    digest: bytes


class ControlMismatch(RuntimeError):
    """The ranks' scheduler accounting differs: a rank would compute on
    another batch than rank 0's. Raised on every rank at once."""


class ControlChannel:
    """Rank 0's side and a follower's of the control messages over the
    mesh's control group (``Mesh.control``; leader ``Mesh.leader``). Each
    turn: :meth:`exchange` broadcasts rank 0's ``ControlMessage``, and,
    once every rank has applied it, :meth:`agree` all-gathers each rank's
    digest with a flag saying whether its accounting equalled the
    message's before it and its requests took rank 0's ids; any difference
    raises ``ControlMismatch`` on every rank before any of them steps, so
    none computes on a wrong batch and none waits for a rank that left."""

    def __init__(self, mesh):
        if mesh.control is None:
            raise RuntimeError(
                "serving on a mesh of more than one rank needs the mesh's control group: build "
                "the mesh with parallel.shardings.make_mesh or "
                "parallel.distributed.make_multihost_mesh")
        self.group, self.leader = mesh.control, mesh.leader
        self.ranks = dist.get_process_group_ranks(self.group)
        self.is_leader = dist.get_rank() == self.leader

    def exchange(self, msg: Optional[ControlMessage] = None) -> ControlMessage:
        """Rank 0 passes its message; every rank returns it."""
        box = [msg]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]

    def agree(self, digest: bytes, matched: bool = True) -> None:
        """Every rank's ``digest`` (after applying the message) and whether
        it ``matched`` rank 0 in applying it (its accounting equalled the
        message's digest before, its requests took rank 0's ids); raises
        ``ControlMismatch`` on every rank if any rank differs from rank 0."""
        mine = torch.tensor([int(matched), *digest], dtype=torch.uint8)
        parts = all_gather_stack(mine, self.group)
        lead = parts[self.ranks.index(self.leader)]
        before = [r for r, p in zip(self.ranks, parts) if not int(p[0])]
        after = [r for r, p in zip(self.ranks, parts) if not torch.equal(p[1:], lead[1:])]
        if before or after:
            raise ControlMismatch(
                f"serving control: rank(s) {before} differed from rank {self.leader} in "
                "applying this message (their accounting after the previous iteration, or "
                f"the ids their requests took), rank(s) {after} after this message's "
                "submits; no rank steps on it")
