"""Device-memory metrics, the episodes/s counter and the trace switch.

The counterpart of ``fumi_tpu/utils/profiling.py``:

- :func:`hbm_stats`: ``mem/*`` metrics for the eval-boundary logs, from
  ``torch.cuda.memory_stats`` under the JAX package's names;
- :class:`Throughput`: episodes/s with exponential smoothing, fed by the
  training loop;
- :func:`profile_trace`: ``--tpu_profile_dir``, a ``torch.profiler``
  trace of the run's CPU and (on a card) CUDA activity, written as a
  Chrome trace JSON into the directory (open it in Perfetto or
  ``chrome://tracing``). The kernel wrappers of ``ops/kernels.py`` open a
  range named after themselves while a profiler runs, so the timeline
  names ``gather_episode_rows``, ``fused_adapt`` and the others above the
  CUDA kernels they launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the block into ``log_dir/trace_<pid>_<ms>.pt.trace.json`` (CPU
    activity, and CUDA activity where a card is present); a no-op without
    ``log_dir``. Yields the profiler (None without one)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"trace_{os.getpid()}_"
                            f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"profile trace: {path}")


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
