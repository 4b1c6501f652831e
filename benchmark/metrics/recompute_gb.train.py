"""The device's live memory at the end of each recompute of a
checkpointed inner step, its graph rebuilt beside what the outer backward
still holds: the program's ``mem.inner.recompute`` counter, the most it
read over the profiled steps, in GB. ``graph_gb.train`` and
``meta_grad_gb.train`` are read at span ends outside the outer backward
and do not see it. None where no step was checkpointed, or on a program
without the counter."""

from benchmark.counters import memory_bytes


def read(ctx, rec):
    n = memory_bytes(rec.get("trace"), "inner.recompute")
    return None if n is None else n / 1e9
