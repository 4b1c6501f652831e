"""A profiled stretch and what the per-layer metrics read from it.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activity) inside a range named ``bench.stretch``, and returns a
:class:`Trace`: the device's operations (kernels, copies, sets) as
intervals, the host's operations and ranges as intervals, all on the
profiler's clock, and the stretch's own range. Shares of time are taken
against that range: the device is busy where at least one operation ran,
the union of the intervals, never their sum.

``device_seconds(fn)`` runs ``fn`` under the profiler with the device's
activity alone and returns the seconds in which at least one device
operation ran: the card's own clock, which the host's stalls do not move.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from benchmark import stats

STRETCH = "bench.stretch"
TOP = 10


class Event(NamedTuple):
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


class Trace:
    def __init__(self, device: List[Event], host: List[Event],
                 host_window_s: float):
        self.device = sorted(device, key=lambda e: e.start)
        self.host = sorted(host, key=lambda e: e.start)
        self.host_window_s = host_window_s
        stretch = [e for e in self.host if e.name == STRETCH]
        if stretch:
            self.lo, self.hi = stretch[0].start, stretch[0].end
        elif self.host:
            self.lo = self.host[0].start
            self.hi = max(e.end for e in self.host)
        else:
            self.lo = self.hi = 0.0
        self._starts = [e.start for e in self.host]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return stats.covered(((e.start, e.end) for e in self.device),
                             self.lo, self.hi) / 1e6

    def idle_share(self) -> Optional[float]:
        """1 - busy / window, or None without device operations."""
        if not self.device or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, part: str) -> List[Event]:
        """Device operations whose name holds ``part``, in start order."""
        return [e for e in self.device if part in e.name]

    def ranges(self, name: str) -> List[Event]:
        """Host events of exactly this name, in start order."""
        return [e for e in self.host if e.name == name]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` (CUDA runtime
        calls and the stretch's own range only where nothing else is)."""
        i = bisect.bisect_right(self._starts, t)
        best, best_rt = None, None
        for e in reversed(self.host[max(0, i - 400):i]):
            if e.end < t:
                continue
            runtime = e.name.startswith("cuda") or e.name == STRETCH
            slot = best_rt if runtime else best
            if slot is None or e.end - e.start < slot.end - slot.start:
                if runtime:
                    best_rt = e
                else:
                    best = e
        pick = best or best_rt
        return pick.name if pick is not None else "(no host operation)"

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps'
        time by what the host was doing, in seconds; at most ``TOP``
        each."""
        by_op: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by_op[e.name[:120]] += (e.end - e.start) / 1e6
        by_host: Dict[str, float] = defaultdict(float)
        for a, b in stats.gaps(((e.start, e.end) for e in self.device),
                               self.lo, self.hi):
            by_host[self._host_at((a + b) / 2)[:120]] += (b - a) / 1e6

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def from_profiler(prof, host_window_s: float) -> Trace:
    """The profiler's events as a :class:`Trace`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        r = e.time_range
        ev = Event(e.name, float(r.start), float(r.end))
        if e.device_type != cuda:
            host.append(ev)
        elif r.end > r.start and not getattr(e, "is_user_annotation", False):
            device.append(ev)
    # a profiler range (record_function) is also drawn on the device's
    # timeline; it is no operation of the device
    ranges = {e.name for e in host}
    return Trace([e for e in device if e.name not in ranges], host,
                 host_window_s)


def profiled(fn: Callable[[], object], sync: Callable[[], None]
             ) -> Tuple[Trace, object]:
    """Run ``fn`` under the profiler, ending in ``sync``; returns the trace
    and what ``fn`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(STRETCH):
            out = fn()
            sync()
        host_s = time.perf_counter() - t0
    return from_profiler(prof, host_s), out


def device_seconds(fn: Callable[[], object], sync: Callable[[], None]
                   ) -> Tuple[float, object]:
    """Run ``fn`` under the profiler (the device's activity alone), ending
    in ``sync``; returns the union of the device operations' intervals, in
    seconds, and what ``fn`` returned. Profiler ranges drawn on the device's
    timeline are no operation of the device and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a, d = e.start_ns(), e.duration_ns()
        if d > 0:
            spans.append((float(a), float(a + d)))
    return stats.covered(spans) / 1e9, out
