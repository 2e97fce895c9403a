"""The ('dp', 'cp', 'tp') mesh and the sharding policy (port of
``lite_llama_tpu/parallel/shardings.py``).

One process per rank of ``torch.distributed``, in JAX's device order: rank
``r = (d * cp + c) * tp + t`` holds tp rank t of context rank c of data
group d.

- tp shards the weights on the head axis (wq / wkv / the fused wqkv, and
  the contraction of o_proj) and the ffn axis (gate_up's output, down's
  contraction), so decode attention is rank-local: each rank owns Hkv/tp kv
  heads and its own pool of them. The embedding and the head shard on the
  vocab axis. Where the JAX package lays these out as ``NamedSharding``s of
  one SPMD program, here each rank holds only its shard (``shard_params``
  slices the whole tree) and the decoder runs it as a one-device tree of its
  local heads, with the collectives made explicit (``models/decoder.py``).
- dp replicates the weights and divides the requests: each data group owns
  ``max_reqs / dp`` slots and ``num_pages / dp`` pages, and a rank holds the
  device state of its group only (``executor/engine.py``).
- cp replicates the weights and shards the paged pool's token rows: context
  rank c holds pages ``[c * P/cp, (c+1) * P/cp)`` (``parallel/
  context_parallel.py``).

Requires tp | num_key_value_heads, tp | num_attention_heads, tp | ffn and
tp | vocab. The JAX package's layouts and refusals hold: a σ-FFN tree must
have ``sigma_groups == tp``; riffle trees need ``riffle_groups == tp`` on
the weights whose output axis shards (wqkv / wq, gate_up, the head) and 1 on
o_proj and down; a quantized unfused ``wkv`` cannot shard (a contiguous
shard of its flat output axis crosses the K | V boundary: fuse QKV first).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..quant.qtensor import QTensor
from . import distributed


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ('dp', 'cp', 'tp') mesh of
    ``torch.distributed`` ranks: tp rank ``rank`` of ``tp`` in ``group``,
    context rank ``cp_rank`` of ``cp`` in ``cp_group``, data group
    ``dp_rank`` of ``dp`` (``dp_group``: the ranks of the other groups that
    share this rank's tp and cp ranks). A group is None where its axis is 1
    (or where it is the whole world). ``control``: a CPU gloo group of every
    rank of the mesh, for the serving loop's messages from rank ``leader``
    (the mesh's first rank; ``distributed.ControlChannel``)."""

    tp: int = 1
    rank: int = 0
    group: Any = None
    dp: int = 1
    dp_rank: int = 0
    dp_group: Any = None
    cp: int = 1
    cp_rank: int = 0
    cp_group: Any = None
    control: Any = None
    leader: int = 0

    @property
    def size(self) -> int:
        return self.dp * self.cp * self.tp


def make_mesh(tp: int = 1, dp: int = 1, cp: int = 1, group=None) -> Mesh:
    """The ('dp', 'cp', 'tp') mesh of this process over ``group`` (default
    the whole world, which must hold exactly dp * cp * tp ranks;
    ``parallel/distributed.py`` starts it), in JAX's device order (module
    docstring). Every rank must call it, and in the same order as its other
    group-making calls: it makes the subgroups with ``dist.new_group``.
    A mesh of one rank needs no process group."""
    for name, n in (("tp", tp), ("dp", dp), ("cp", cp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if dp * cp * tp == 1:
        return Mesh()
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {dp * cp * tp} ranks needs torch.distributed started "
                           "(parallel/distributed.py init_distributed)")
    ranks = dist.get_process_group_ranks(group) if group is not None else list(
        range(dist.get_world_size()))
    if len(ranks) != dp * cp * tp:
        raise ValueError(f"the process group holds {len(ranks)} ranks, the mesh asks "
                         f"dp={dp} x cp={cp} x tp={tp}")
    return mesh_from_grid(np.asarray(ranks).reshape(dp, cp, tp), group)


def mesh_from_grid(grid: np.ndarray, group=None) -> Mesh:
    """The Mesh of this process from ``grid`` [dp, cp, tp], the global rank
    at each mesh position. Makes every subgroup of every axis above 1 on
    every rank, in one order (tp, then cp, then dp groups, each in mesh
    order, then the control group of the whole mesh), as NCCL requires; an
    axis that spans all of ``group`` takes ``group`` itself."""
    import torch.distributed as dist

    dp, cp, tp = grid.shape
    me = dist.get_rank()
    where = np.argwhere(grid == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} is not once in the mesh {grid.tolist()}")
    d, c, t = (int(i) for i in where[0])
    whole = grid.size

    def groups(axis_len, lines):
        if axis_len == 1:
            return None
        if axis_len == whole:
            return group
        mine = None
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine = g
        return mine

    tp_group = groups(tp, [grid[i, j, :] for i in range(dp) for j in range(cp)])
    cp_group = groups(cp, [grid[i, :, k] for i in range(dp) for k in range(tp)])
    dp_group = groups(dp, [grid[:, j, k] for j in range(cp) for k in range(tp)])
    control = distributed.control_group(grid.reshape(-1)) if whole > 1 else None
    return Mesh(tp=tp, rank=t, group=tp_group, dp=dp, dp_rank=d, dp_group=dp_group,
                cp=cp, cp_rank=c, cp_group=cp_group, control=control,
                leader=int(grid.reshape(-1)[0]))


# Which axis of each decoder leaf tp shards (plain tensors), as the JAX
# specs lay them out; QTensors shard their stored [*stack, C, O] by kind.
_PLAIN_AXES = {
    "wq": 2,  # [L, H, Nq, D]
    "wkv": 3,  # [L, H, 2, Nkv, D]
    "wqkv": 2,  # [L, H, Ntot, D], shard-periodic head order
    "o_proj": 1,  # [L, Nq, D, H]
    "gate_up_proj": 3,  # [L, 2, H, I]
    "down_proj": 1,  # [L, I, H]
    "q_bias": 1,  # [L, Nq, D]
    "kv_bias": 2,  # [L, 2, Nkv, D]
    "qkv_bias": 1,  # [L, Ntot, D]
}
_OUT_KIND = ("wq", "wkv", "wqkv", "gate_up_proj")  # QTensor 'out' kind; the rest 'contract'


@dataclass(frozen=True)
class ShardingPolicy:
    """Where each leaf of the engine's trees shards, and this rank's share
    of them; ``mesh=None`` (or tp 1) keeps every leaf whole (dp and cp
    replicate the weights)."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise NotImplementedError(
                "the port takes its own mesh (parallel.shardings.make_mesh or "
                "parallel.distributed.make_multihost_mesh)")

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else self.mesh.tp

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.group

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    @property
    def dp_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.dp_rank

    @property
    def cp(self) -> int:
        return 1 if self.mesh is None else self.mesh.cp

    @property
    def cp_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.cp_rank

    @property
    def size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    # -- collectives (identities at tp 1) ------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else distributed.all_reduce_sum(x, self.group)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else distributed.all_gather_last(x, self.group)

    # -- parameter tree ----------------------------------------------------
    def param_specs(self, cfg, params: dict) -> dict:
        """The tree's shard axes: a plain leaf maps to the axis tp splits
        (None: replicated), a QTensor to (q axis, scale axis). Raises the
        JAX package's refusals for layouts that do not fit this tp. (LLaVA:
        ``LlavaEngine`` shards its LM's tree; the tower and the projector
        stay whole on every rank.)"""
        tp = self.tp
        if tp > 1:
            for what, n in (("num_attention_heads", cfg.num_attention_heads),
                            ("num_key_value_heads", cfg.num_key_value_heads),
                            ("intermediate_size", cfg.intermediate_size),
                            ("vocab_size", cfg.vocab_size)):
                if n % tp:
                    raise ValueError(f"tp={tp} does not divide {what}={n}")

        def pick(name, leaf):
            if isinstance(leaf, QTensor):
                return self._qtensor_spec(name, leaf)
            return _PLAIN_AXES.get(name)

        specs = {"embed": 0, "final_norm": None,
                 "layers": {k: pick(k, v) for k, v in params["layers"].items()}}
        if "lm_head" in params:
            lm = params["lm_head"]
            if isinstance(lm, QTensor):
                if tp > 1 and lm.riffle_groups and lm.riffle_groups != tp:
                    raise ValueError(
                        f"riffle-packed lm_head was laid out for riffle_groups="
                        f"{lm.riffle_groups} but its vocab axis shards over tp={tp}: "
                        "quantize with riffle_tp=<mesh tp>.")
                specs["lm_head"] = (-1, -1)
            else:
                specs["lm_head"] = 1  # [H, V]
        return specs

    def _qtensor_spec(self, name, leaf: QTensor):
        tp = self.tp
        if tp > 1 and (leaf.sigma_out or leaf.sigma_in) and leaf.sigma_groups != tp:
            raise ValueError(
                f"σ-shuffled quantized '{name}' was laid out for sigma_groups="
                f"{leaf.sigma_groups} but the mesh has tp={tp}: one tp shard must be exactly "
                "one σ block. Quantize with sigma_tp=<mesh tp> "
                "(quant/qtensor.quantize_decoder_params) or with sigma_ffn=False.")
        if tp > 1 and leaf.riffle_groups:
            want = tp if name in ("wq", "wqkv", "gate_up_proj") else 1
            if leaf.riffle_groups != want:
                raise ValueError(
                    f"riffle-packed quantized '{name}' was laid out for riffle_groups="
                    f"{leaf.riffle_groups} but the tp={tp} mesh needs {want}. Quantize with "
                    "riffle_tp=<mesh tp> (quant/qtensor.quantize_decoder_params) or with "
                    "riffle=False.")
        if name == "wkv" and tp > 1:
            raise ValueError(
                f"quantized '{name}' cannot be tensor-parallel sharded (a contiguous shard of "
                "its flat output axis crosses the K|V boundary) — fuse QKV first "
                "(models/decoder.py fuse_qkv_params)")
        if name in _OUT_KIND:
            return (-1, -1)
        return (-2, -2 if leaf.grouped else None)

    def shard_params(self, cfg, params: dict) -> dict:
        """This rank's shard of the tree (a new tree; leaves of other ranks
        never kept): a one-device tree of the rank's local heads, ffn slice
        and vocab rows. Quantized leaves slice q and scale alike (grouped
        scales on their group axis where the contraction shards); a
        shard's riffle or σ block is the whole local axis, so its local
        block count is 1, and a fused wqkv shard is one canonical (q, k, v)
        group."""
        if self.tp == 1:
            return params
        specs = self.param_specs(cfg, params)
        tp, rank = self.tp, self.rank

        def apply(node, spec, name=None):
            if isinstance(node, dict):
                return {k: apply(v, spec[k], k) for k, v in node.items()}
            if isinstance(node, QTensor):
                return _shard_qtensor(node, spec, name, tp, rank)
            if spec is None or not isinstance(node, torch.Tensor):
                return node
            return _take(node, spec, tp, rank)

        return apply(params, specs)

    # -- KV cache ----------------------------------------------------------
    def local_kv_heads(self, num_kv_heads: int):
        """(kv heads of this rank's pool, the global index of its first): the
        counterpart of JAX's ``shard_cache``. The engine makes the rank's pool
        of these heads directly (``create_kv_cache(..., head_offset=)``),
        never the whole one; an int8 pool's scale slab stays whole, its lanes
        indexing global heads."""
        if num_kv_heads % self.tp:
            raise ValueError(f"tp={self.tp} does not divide num_key_value_heads={num_kv_heads}")
        n = num_kv_heads // self.tp
        return n, self.rank * n


def _take(t: torch.Tensor, axis: int, tp: int, rank: int) -> torch.Tensor:
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"tp={tp} does not divide axis {axis} of shape {tuple(t.shape)}")
    return t.narrow(axis, rank * (n // tp), n // tp).contiguous()


def _shard_qtensor(qt: QTensor, spec, name, tp: int, rank: int) -> QTensor:
    q_axis, s_axis = spec
    q = _take(qt.q, q_axis, tp, rank)
    scale = qt.scale if s_axis is None else _take(qt.scale, s_axis, tp, rank)
    unit, out = list(qt.unit_shape), list(qt.out_shape)
    if q_axis == -1:
        # 'out': the rank's output columns (padding included: the head's
        # gathered logits are sliced back to the vocab).
        stored = q.shape[-1] * (2 if qt.packed else 1)
        if len(out) == 1:
            out = [stored]
        else:
            out[0] //= tp
        unit = unit[:len(unit) - len(qt.out_shape)] + out
    else:
        # 'contract': the first contraction dim (heads of o_proj, ffn of down).
        unit[0] //= tp
    return dataclasses.replace(
        qt, q=q, scale=scale, unit_shape=tuple(unit), out_shape=tuple(out),
        riffle_groups=1 if qt.riffle_groups else 0, fused_tp=0,
        sigma_groups=1, layer=None)
