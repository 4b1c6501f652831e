"""The share of the profiled stretch's device idle time that nothing of
the program names: at the gap's middle no operator and no range of the
program is open on the host, only the benchmark's own ranges, a bare
CUDA runtime call or nothing (``benchmark/spans.py``)."""

from benchmark.spans import unnamed_idle_share


def read(ctx, rec):
    return unnamed_idle_share(rec.get("trace"))
