"""The (dp, mp) grid of ranks and the collectives over it.

The counterpart of ``fumi_tpu/core/mesh.py``. One rank is one device
(``core/distributed.py``), so a mesh is the world's first ``dp · mp`` ranks
laid out row-major as a (dp, mp) grid: rank ``d · mp + m`` sits at
``(d, m)``. Axis ``dp`` shards the meta-batch's tasks (episode data
parallelism) and a batched request's episodes (``serve.py``,
:func:`episode_shard`), axis ``mp`` the input columns of wide weights
(``parallel/pjit_engine.py``). :func:`make_mesh` builds the process groups
of every mp row (the ranks that hold one dp shard) and every dp column
(the ranks that hold one mp slice); all ranks of the world must call it
together, in the same order.

Collectives stage through the host where the backend lacks them for CUDA
tensors: gloo all-reduces and broadcasts CUDA tensors, but has no
all-gather for them, so :func:`all_gather_cat` copies to the CPU, gathers
there and copies back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from fumi_tpu_torch.core.distributed import world_size

DP_AXIS = "dp"
MP_AXIS = "mp"


def largest_divisor_leq(m: int, cap: int) -> int:
    """Largest d <= cap with m % d == 0 (>= 1)."""
    for d in range(min(cap, m), 0, -1):
        if m % d == 0:
            return d
    return 1


def auto_dp(batch_size: int, n_devices: Optional[int] = None) -> int:
    """The largest rank count that divides the meta-batch (tasks split
    evenly over the shards); ``n_devices`` defaults to the world's ranks."""
    if n_devices is None:
        n_devices = world_size()
    return largest_divisor_leq(batch_size, n_devices)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (dp, mp) grid of ranks. ``dp_group`` joins the
    ranks of this rank's dp column (same mp index), ``mp_group`` those of
    its mp row (same dp index), ``group`` the whole grid; a group of one
    rank is None and its collectives are skipped."""
    dp: int
    mp: int
    rank: int
    dp_group: Optional[object]
    mp_group: Optional[object]
    group: Optional[object]
    gloo: bool

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, MP_AXIS: self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def member(self) -> bool:
        """Whether this rank is on the grid (ranks past ``dp · mp`` idle)."""
        return self.rank < self.size

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp


def make_mesh(dp: int = 0, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh over the world's first ``dp · mp`` ranks; ``dp ==
    0`` means "all ranks / mp". Raises ``ValueError`` when the grid needs
    more ranks than the world has."""
    world = world_size()
    if dp <= 0:
        dp = max(1, world // mp)
    n = dp * mp
    if n > world:
        raise ValueError(f"mesh ({dp}x{mp}) needs {n} devices, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world == 1:
        return Mesh(dp, mp, rank, None, None, None, False)

    def group(ranks: List[int]):
        # every rank of the world creates every group of two or more
        # ranks, in the same order
        if len(ranks) == 1:
            return None
        g = dist.new_group(ranks) if len(ranks) < world else dist.group.WORLD
        return g if rank in ranks else None

    mp_group = dp_group = None
    for d in range(dp):
        g = group([d * mp + m for m in range(mp)])
        if rank // mp == d and rank < n:
            mp_group = g
    for m in range(mp):
        g = group([d * mp + m for d in range(dp)])
        if rank % mp == m and rank < n:
            dp_group = g
    grid = group(list(range(n)))
    return Mesh(dp, mp, rank, dp_group, mp_group, grid if rank < n else None,
                dist.get_backend() == "gloo")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce over ``group`` (no-op for None)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0,
                   gloo: bool = False) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (``t``
    for a None group). Under gloo a CUDA tensor is staged through the
    CPU."""
    if group is None:
        return t
    src = t.contiguous()
    stage = gloo and src.is_cuda
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if stage else out


def put_replicated(tree, mesh: Mesh):
    """Every tensor of ``tree`` broadcast from the grid's first rank, in
    place (the JAX package's replicated placement)."""
    if mesh.group is None:
        return tree
    src = 0  # the grid's first rank is world rank 0
    for t in _tensors(tree):
        dist.broadcast(t, src, group=mesh.group)
    return tree


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _shard(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.dp:
        raise ValueError(f"{what} {n} not divisible by dp={mesh.dp}")
    k = n // mesh.dp
    return slice(mesh.dp_index * k, (mesh.dp_index + 1) * k)


def episode_shard(mesh: Mesh, r_pad: int) -> slice:
    """This rank's rows of a batched request padded to ``r_pad`` episodes:
    shard ``dp_index`` of ``dp`` (the JAX package's ``episode_sharding``).
    The ranks of an mp row share a dp index, so they hold the same rows.
    Raises ``ValueError`` when dp does not divide ``r_pad``."""
    return _shard(mesh, r_pad, "padded episode count")


def put_episode(episode, mesh: Mesh):
    """This rank's slice of the episode's task axis: shard ``dp_index`` of
    ``dp`` (views, no copy)."""
    if mesh.dp == 1:
        return episode
    part = _shard(mesh, episode.support_im.shape[0], "batch_size")
    return type(episode)(*(None if x is None else x[part] for x in episode))


def host_fetch(x: torch.Tensor, mesh: Optional[Mesh] = None,
               sharded: bool = False) -> torch.Tensor:
    """The whole tensor: an all-gather over the mp row of an mp-sharded
    leaf (its input columns, the last axis), ``x`` itself for a replicated
    one."""
    if not sharded or mesh is None:
        return x
    return all_gather_cat(x, mesh.mp_group, dim=-1, gloo=mesh.gloo)
