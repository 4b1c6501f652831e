"""What the per-layer metrics of the program's own spans share.

The port opens a profiler range for each phase of a request and of a
training step (``fumi_tpu_torch/utils/profiling.py:span``). A profiled
stretch holds them among its host events, on the profiler's clock, so a
phase's time is read from its ranges and an idle stretch of the device
from the range that was open on the host. A program without these spans
(an older one) gives no ranges: the readers then return None.

Durations are host time under a profiler that records every operator, so
they carry the profiler's cost per operator; parent and change are
profiled alike.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional

from benchmark import stats

REQUEST = "serve.request"
TO_HOST = "serve.to_host"
FUSED_KERNEL = "(anonymous namespace)::fused_adapt_kernel<"


def _within(events, a: float, b: float):
    return [e for e in events if a <= e.start and e.end <= b]


def per_request_ms(tr, name: str) -> List[float]:
    """For each ``serve.request`` range, the time in which a ``name``
    range inside it was open (their union), in ms; empty where the trace
    holds no request range or no ``name`` range."""
    requests, spans = tr.ranges(REQUEST), tr.ranges(name)
    if not requests or not spans:
        return []
    return [stats.covered((e.start, e.end)
                          for e in _within(spans, r.start, r.end)) / 1e3
            for r in requests]


def median_per_request_ms(tr, name: str) -> Optional[float]:
    """The median over requests of :func:`per_request_ms`."""
    ms = per_request_ms(tr, name) if tr is not None else []
    return statistics.median(ms) if ms else None


def per_step_ms(rec, name: str) -> Optional[float]:
    """The time in which a ``name`` range was open over the profiled
    training steps (their union), in ms a step; None without one."""
    tr = rec.get("trace")
    if tr is None or not rec.get("trace_steps"):
        return None
    spans = tr.ranges(name)
    if not spans:
        return None
    return stats.covered((e.start, e.end) for e in spans) / 1e3 \
        / rec["trace_steps"]


def answer_tails_ms(tr) -> List[float]:
    """For each request that launched ``fused_adapt``: the end of its
    ``serve.to_host`` range minus the end of its last fused kernel on the
    device, in ms, the time the answer takes to reach the caller once the
    card has it. A kernel belongs to the request in whose range it
    starts."""
    kernels = tr.kernels(FUSED_KERNEL)
    hosts = tr.ranges(TO_HOST)
    out = []
    for r in tr.ranges(REQUEST):
        ks = [k for k in kernels if r.start <= k.start <= r.end]
        back = _within(hosts, r.start, r.end)
        if ks and back:
            out.append((max(h.end for h in back)
                        - max(k.end for k in ks)) / 1e3)
    return out


def unnamed(name: str) -> bool:
    """A host event that names no phase: the benchmark's own ranges, a bare
    CUDA runtime call."""
    return name.startswith(("bench.", "cuda"))


def unnamed_idle_share(tr) -> Optional[float]:
    """The share (%) of the stretch's device idle time at whose middle no
    host event that names a phase is open: no range of the program and no
    operator, only what :func:`unnamed` passes over or nothing. Every
    event counts, however long ago it opened (``Trace._host_at`` looks
    back over the last few hundred host events only, fewer than an inner
    step or the outer backward records)."""
    if tr is None or not tr.device:
        return None
    idle = stats.gaps(((e.start, e.end) for e in tr.device), tr.lo, tr.hi)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    named = stats.union((e.start, e.end) for e in tr.host
                        if not unnamed(e.name))
    starts = [a for a, _ in named]

    def is_named(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and named[i][1] >= t

    lost = sum(b - a for a, b in idle if not is_named((a + b) / 2))
    return 100.0 * lost / total
