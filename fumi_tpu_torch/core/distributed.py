"""Process groups and process roles for the multi-device engines.

The counterpart of ``fumi_tpu/core/distributed.py``. A JAX process holds
every device of its host and ``jax.distributed`` joins the hosts; here
**one rank is one device**: a CUDA card, or a CPU rank under
``--disable_cuda``. What ``shard_map`` and ``pjit`` do between the devices
of one JAX program is an explicit collective between ranks here
(``core/mesh.py``, ``parallel/engine.py``, ``parallel/pjit_engine.py``).

A world forms in one of three ways:

- ``--tpu_dist_coordinator/--tpu_dist_num_processes/--tpu_dist_process_id``
  (:func:`initialize_from_config`): each process of the run is one rank,
  rendezvous over ``tcp://<coordinator>``;
- ``torchrun`` (no flags): :func:`initialize` reads ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``/
  ``LOCAL_WORLD_SIZE``, the counterpart of JAX's pod auto-detection;
- ``parallel/launch.py:spawn_world``: one process starts the ranks itself
  (the driver's single-process ``--tpu_mesh_dp N``/``--tpu_mesh_mp M``),
  rendezvous over a ``file://`` store.

Backend rule (no flag): NCCL when every rank of a host has a card of its
own; gloo when ranks share a card (two ranks on one card, which NCCL
refuses) or run on the CPU. A rank's device is ``cuda:(local_rank %
device_count)``, made current with ``torch.cuda.set_device`` before
``core/runtime.py:resolve_device`` resolves it. A rank that finds no card
raises unless the CPU was asked for.

Artifact policy, the JAX package's: every process of a ``--tpu_dist_*``
world writes its own run dir with the suffix :func:`process_tag`
(``-p<rank>``) and its own complete checkpoint; only the primary
(:func:`is_primary`) logs to wandb. The ranks a single process spawned act
as that one process: rank 0 alone writes the run dir (:func:`writes_run`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from fumi_tpu_torch.core.runtime import resolve_device

# a rank that waits longer than this in a collective fails the run
TIMEOUT = datetime.timedelta(seconds=600)
_LOOPBACK = ("localhost", "127.0.0.1", "::1", "[::1]")

# this process's rank: device, backend, local layout, and whether a
# single process spawned the world (parallel/launch.py)
_STATE: dict = {}


def _local_layout(rank: int, world_size: int, coordinator: Optional[str],
                  local_rank: Optional[int], local_world: Optional[int]):
    """``(local_rank, local_world_size)``: given, or torchrun's
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, or the whole world on this host
    when the coordinator is a loopback address, else one rank a host."""
    if local_rank is not None and local_world is not None:
        return local_rank, local_world
    if "LOCAL_WORLD_SIZE" in os.environ:
        return (int(os.environ.get("LOCAL_RANK", 0)),
                int(os.environ["LOCAL_WORLD_SIZE"]))
    host = (coordinator or "localhost").rsplit(":", 1)[0]
    if host in _LOOPBACK:
        return rank, world_size
    return 0, 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               use_cuda: bool = True, init_method: Optional[str] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               spawned: bool = False) -> torch.device:
    """Join the world as rank ``process_id`` of ``num_processes`` and
    return the rank's device. Unset arguments come from torchrun's
    environment; ``init_method`` (a ``file://`` store) replaces
    ``tcp://<coordinator>``."""
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', 29500)}")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("a multi-process run needs a coordinator "
                             "address (--tpu_dist_coordinator host:port)")
        init_method = f"tcp://{coordinator_address}"
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    local_rank, local_world = _local_layout(
        rank, world, coordinator_address, local_rank, local_world_size)
    if use_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank}: CUDA is not available; pass --disable_cuda "
                "to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % n_cards)
        device = resolve_device("cuda")
        backend = "nccl" if local_world <= n_cards else "gloo"
    else:
        n_cards, device, backend = 0, resolve_device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    _STATE.clear()
    _STATE.update(device=device, backend=backend, local_rank=local_rank,
                  local_world=local_world, n_cards=n_cards,
                  spawned=spawned)
    return device


def initialize_from_config(cfg) -> bool:
    """Join the world the ``--tpu_dist_*`` flags (or torchrun's
    environment) describe. Returns True when a multi-process world was
    requested and joined; must run before the driver picks its device."""
    flags = cfg.dist_coordinator is not None or cfg.dist_num_processes > 0
    if not flags and int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return False
    initialize(
        coordinator_address=cfg.dist_coordinator,
        num_processes=(cfg.dist_num_processes
                       if cfg.dist_num_processes > 0 else None),
        process_id=(cfg.dist_process_id
                    if cfg.dist_process_id >= 0 else None),
        use_cuda=not cfg.disable_cuda)
    return True


def shutdown(wait: bool = False) -> None:
    """Leave the world (a no-op outside one); ``wait`` first waits for
    every rank, so rank 0's store outlives the others' last use of it."""
    if dist.is_initialized():
        if wait:
            dist.barrier()
        dist.destroy_process_group()
    _STATE.clear()


def is_initialized() -> bool:
    return dist.is_initialized()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself outside a world)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> Optional[torch.device]:
    """The device :func:`initialize` chose, None outside a world."""
    return _STATE.get("device")


def backend() -> Optional[str]:
    return _STATE.get("backend")


def spawned() -> bool:
    """True on a rank of a world one process spawned."""
    return dist.is_initialized() and _STATE.get("spawned", False)


def is_multihost() -> bool:
    """True in a world of several processes that each own their artifacts
    (``--tpu_dist_*`` or torchrun); ranks one process spawned act as that
    process."""
    return world_size() > 1 and not _STATE.get("spawned", False)


def is_primary() -> bool:
    """True for the rank that owns singleton side effects (wandb)."""
    return rank() == 0


def writes_run() -> bool:
    """True for a rank that writes a run dir, logs and checkpoints: every
    process of a ``--tpu_dist_*`` world, rank 0 of a spawned one."""
    return is_multihost() or is_primary()


def run_barrier() -> None:
    """Wait for every rank of a spawned world, whose ranks read what rank
    0 writes (a no-op elsewhere)."""
    if dist.is_initialized() and _STATE.get("spawned", False):
        dist.barrier()


def process_tag() -> str:
    """Per-process artifact suffix: '' for one process (spawned ranks
    included), '-p<rank>' in a ``--tpu_dist_*`` world."""
    return f"-p{rank()}" if is_multihost() else ""


def describe() -> str:
    """The rank, the backend and any sharing of a card, for the driver's
    ``running on`` line; '' outside a world."""
    if not dist.is_initialized():
        return ""
    s = _STATE
    out = f", rank {rank()}/{world_size()}, backend {s.get('backend')}"
    if s.get("n_cards") and s["local_world"] > s["n_cards"]:
        out += (f" ({s['local_world']} ranks share {s['n_cards']} "
                f"card{'s' if s['n_cards'] > 1 else ''})")
    if s.get("spawned"):
        out += ", spawned"
    return out
