"""Device-memory metrics, the episodes/s counter, the trace switch and the
spans that name the port's phases on a trace.

The counterpart of ``fumi_tpu/utils/profiling.py``:

- :func:`hbm_stats`: ``mem/*`` metrics for the eval-boundary logs, from
  ``torch.cuda.memory_stats`` under the JAX package's names;
- :class:`Throughput`: episodes/s with exponential smoothing, fed by the
  training loop;
- :func:`device_sync`: a value's first element on the host, which waits
  for the work that produced it;
- :func:`profile_trace`: ``--tpu_profile_dir``, a ``torch.profiler``
  trace of the run's CPU and (on a card) CUDA activity, written as a
  Chrome trace JSON into the directory (open it in Perfetto or
  ``chrome://tracing``);
- :func:`span` and :func:`spanned`: a ``torch.profiler.record_function``
  range while a profiler runs, and nothing but one flag read otherwise.
  A range lands on the profiler's host timeline, which the profiler
  aligns with the device's activity, so a trace puts each kernel and each
  idle stretch of the card under the phase that was running on the host.
  Spans read no flag, variable or option of their own: they are on
  exactly while a profiler runs, and they change no computation.

The spans, by name (nesting gives the parent):

- ``serve.request``: one ``FewShotClassifier.episode_logits`` or
  ``episode_logits_batch`` call, the root of a request;
- ``serve.checks``: the request's validation and shaping, the label
  check, the array coercions, the text, the power-of-two query (and
  episode) padding;
- ``serve.to_device``: the request's host-to-device copies, made before
  the episode function runs;
- ``hypernet``: ``FUMI.get_hyper_params``, the text hypernetwork (served
  and trained);
- ``serve.adapt``, ``serve.classify``: the autograd engine's adaptation
  and classification, where the fused kernel does not serve;
- ``serve.to_host``: the logits' wait and copy back to the host;
- ``train.step``: one step of ``train/steps.py:make_chunked_train``, the
  root of a step;
- ``train.sample``: the step's episode from the sampler;
- ``train.loss``: the family's training loss, the forward of the step;
- ``inner.step``: one inner SGD step of ``metalearn/inner_loop.py:adapt``
  (forward, inner gradient, update), with or without an outer graph;
- ``inner.recompute``: one recompute of a checkpointed inner step
  (``--tpu_remat``, ``metalearn/inner_loop.py``) inside the outer
  backward: the step's forward and inner gradient built again;
- ``inner.query``: the query forward and the outer loss after the inner
  loop;
- ``train.meta_grad``: the outer backward, ``torch.autograd.grad`` of the
  loss;
- ``train.update``: the optimizer's update and its application;
- ``train.step_metrics``: the step's metrics (loss, accuracy, the
  gradient norms);
- each kernel wrapper of ``ops/kernels.py`` (``fused_adapt``,
  ``fused_maml_adapt_batched``, ``gather_rows``, ``augment_embeddings``,
  ``gather_augment_rows``, ``gather_episode_rows``, ``norm_relu_pool``,
  ``norm_leaky_relu``, ``norm_residual_pool``), by :func:`spanned`, above
  the CUDA kernel it launches (the forward's, for the norm ops: their
  backward and double backward run in autograd's engine, under
  ``train.meta_grad`` or ``inner.step``).

:func:`count_memory` is a counter beside the spans: the CUDA device's live
memory at a point of the step, as a zero-length range named
``mem.<point>=<bytes>``, on exactly while a profiler runs, as a span is.
The points:

- ``train.loss``: the end of the training loss, where the second-order
  graph is held for the outer backward;
- ``train.meta_grad``: the end of the outer backward, the graph freed and
  the gradients held;
- ``inner.recompute``: the end of each recompute of a checkpointed inner
  step, its graph rebuilt beside what the outer backward still holds.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


# what span returns while no profiler runs: one object, built once
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs (a
    ``torch.profiler.record_function``); otherwise one shared null
    context, so a span costs one flag read and builds nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count_memory(point: str) -> None:
    """While a profiler runs, a zero-length range ``mem.<point>=<bytes>``
    with the bytes the caching allocator holds live on the current CUDA
    device (``torch.cuda.memory_allocated``: its own count, on the host,
    with no synchronisation and the peak statistics left alone); nothing
    without a profiler or before CUDA is initialised (the CPU)."""
    if torch.autograd._profiler_enabled() and torch.cuda.is_initialized():
        name = f"mem.{point}={torch.cuda.memory_allocated()}"
        with torch.profiler.record_function(name):
            pass


def spanned(fn: Callable) -> Callable:
    """``fn`` inside a :func:`span` of its own name."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return wrapper


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


def device_sync(value) -> float:
    """The first element of ``value`` as a Python float: a tensor on any
    device (fetching it waits for its card), or anything ``np.asarray``
    takes."""
    if torch.is_tensor(value):
        return float(value.detach().reshape(-1)[0].item())
    return float(np.asarray(value).reshape(-1)[0])


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
