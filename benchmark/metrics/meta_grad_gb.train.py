"""The device's live memory at the end of the outer backward, the graph
freed and the gradients held: the program's ``mem.train.meta_grad``
counter, the most it read over the profiled steps, in GB."""

from benchmark.counters import memory_bytes


def read(ctx, rec):
    n = memory_bytes(rec.get("trace"), "train.meta_grad")
    return None if n is None else n / 1e9
