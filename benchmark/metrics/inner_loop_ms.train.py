"""The inner loop (forward, inner gradient and update of each inner
step): the time an ``inner.step`` range was open over the profiled
steps, in ms a step (host clock, under the profiler)."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "inner.step")
