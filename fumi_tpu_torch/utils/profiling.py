"""Device-memory metrics, the episodes/s counter and the trace switch.

The counterpart of ``fumi_tpu/utils/profiling.py``:

- :func:`hbm_stats`: ``mem/*`` metrics for the eval-boundary logs, from
  ``torch.cuda.memory_stats`` under the JAX package's names;
- :class:`Throughput`: episodes/s with exponential smoothing, fed by the
  training loop;
- :func:`profile_trace`: ``--tpu_profile_dir`` wrote a ``jax.profiler``
  trace; a ``torch.profiler`` counterpart is ROADMAP.md Queue 1, item 9,
  so a non-empty directory raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """No-op without ``log_dir``; raises with one (not ported yet)."""
    if log_dir:
        raise NotImplementedError(
            "--tpu_profile_dir is not ported to the PyTorch package yet "
            "(ROADMAP.md Queue 1, item 9: scale-out extensions and "
            "utils/profiling.py)")
    yield


def hbm_stats(device: Optional[torch.device] = None) -> dict:
    """``mem/bytes_in_use``, ``mem/peak_bytes_in_use``,
    ``mem/bytes_reserved`` and ``mem/bytes_limit`` of a CUDA device's
    allocator; ``{}`` for the CPU or without CUDA (callers merge it)."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    names = {"bytes_in_use": "allocated_bytes.all.current",
             "peak_bytes_in_use": "allocated_bytes.all.peak",
             "bytes_reserved": "reserved_bytes.all.current"}
    out = {f"mem/{k}": float(stats[v]) for k, v in names.items()
           if v in stats}
    out["mem/bytes_limit"] = float(
        torch.cuda.get_device_properties(device).total_memory)
    return out


class Throughput:
    """Episodes/sec counter with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last_t: Optional[float] = None
        self._last_count = 0
        self.rate = 0.0
        self.total_episodes = 0

    def update(self, episodes_done: int) -> float:
        """Record the cumulative episode count; returns smoothed eps/sec."""
        now = time.perf_counter()
        if self._last_t is not None and episodes_done > self._last_count:
            inst = (episodes_done - self._last_count) / (now - self._last_t)
            self.rate = (inst if self.rate == 0.0
                         else self.alpha * inst +
                         (1 - self.alpha) * self.rate)
        self._last_t = now
        self._last_count = episodes_done
        self.total_episodes = episodes_done
        return self.rate
