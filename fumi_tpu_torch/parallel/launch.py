"""Start a world of ranks from one process.

A JAX process holds every device of its host, so one JAX program runs a
mesh; here one rank is one device (``core/distributed.py``), so a single
process that wants a mesh starts the ranks itself. :func:`spawn_world`
runs ``fn(rank, *args)`` in ``world_size`` new processes (the ``spawn``
start method: CUDA cannot be forked), joined by a ``file://`` store in a
directory the caller gives (parallel test workers would collide on TCP
ports), and hands each rank's return value back with the kernel launches
that rank made (``ops/kernels.py``'s counters). ``fn`` must be a
module-level function; values travel by pickle, tensors as CPU copies.

The driver uses it for its single-process ``--tpu_mesh_dp N``/
``--tpu_mesh_mp M`` form (``cli/main.py``); the tests use it to run the
engines, on CPU ranks over gloo and, on a card, a one-rank NCCL world
(``tests/test_torch_cuda.py``).

A rank that raises, or dies, fails the whole world: the other ranks are
stopped and :func:`spawn_world` raises ``RuntimeError`` with the rank's
traceback. Every process it starts is stopped before it returns.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.multiprocessing as mp


class RankResult(NamedTuple):
    """What one rank handed back: ``fn``'s return value and the launches of
    each kernel wrapper the rank made."""
    value: Any
    launches: Dict[str, int]


def kernel_launches() -> Dict[str, int]:
    """The launch counters of ``ops/kernels.py``'s wrappers."""
    from fumi_tpu_torch.ops import kernels
    return {name: int(fn.launches) for name, fn in vars(kernels).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}


def to_cpu(tree):
    """``tree`` with every tensor copied to the CPU (dicts, lists, tuples
    and named tuples walked)."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _rank_main(rank: int, world_size: int, store: str, use_cuda: bool,
               threads: Optional[int], results) -> None:
    from fumi_tpu_torch.core import distributed
    if threads:
        torch.set_num_threads(threads)
    try:
        with open(store + ".call", "rb") as f:
            fn, args = pickle.load(f)
        distributed.initialize(
            num_processes=world_size, process_id=rank, use_cuda=use_cuda,
            init_method=f"file://{store}", local_rank=rank,
            local_world_size=world_size, spawned=True)
        value = fn(rank, *args)
        # plain pickle bytes: torch's queue would share the tensors'
        # storage with the parent, and the rank exits before it reads
        payload = pickle.dumps(RankResult(to_cpu(value), kernel_launches()))
        distributed.shutdown(wait=True)
        results.put((rank, True, payload))
    except BaseException:  # every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def spawn_world(fn: Callable, world_size: int, *args,
                store_dir: Optional[str] = None, use_cuda: bool = True,
                threads: Optional[int] = None,
                timeout: float = 1800.0) -> List[RankResult]:
    """Run ``fn(rank, *args)`` on ranks ``0 .. world_size-1``, each in a
    process of its own that has joined the world (CUDA ranks on
    ``cuda:(rank % device_count)``, CPU ranks under ``use_cuda=False``;
    ``threads`` sets each rank's intra-op threads). Returns the ranks'
    :class:`RankResult` in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="rendezvous-") if own_dir \
        else store_dir
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    # the call travels by file: a large argument written down each rank's
    # start-up pipe would start the ranks one after another
    with open(store + ".call", "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store, use_cuda, threads,
                               results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, RankResult] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size and error is None:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    error = (f"rank {dead[0]} died with exit code "
                             f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    error = f"the world did not finish in {timeout:.0f} s"
                continue
            if ok:
                got[rank] = pickle.loads(payload)
            else:
                error = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        for leftover in (store, store + ".call"):
            if os.path.exists(leftover):
                os.remove(leftover)
        if own_dir:
            try:
                os.rmdir(store_dir)
            except OSError:
                pass
    if error is not None:
        raise RuntimeError(f"spawn_world({getattr(fn, '__name__', fn)}, "
                           f"{world_size}): {error}")
    return [got[r] for r in range(world_size)]
