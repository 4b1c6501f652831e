"""The device's live memory at the end of the training loss, where the
second-order graph is held for the outer backward: the program's
``mem.train.loss`` counter, the most it read over the profiled steps, in
GB."""

from benchmark.counters import memory_bytes


def read(ctx, rec):
    n = memory_bytes(rec.get("trace"), "train.loss")
    return None if n is None else n / 1e9
