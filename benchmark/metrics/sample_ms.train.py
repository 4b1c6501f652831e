"""The step's episode from the sampler: the time a ``train.sample`` range
was open over the profiled steps, in ms a step (host clock, under the
profiler)."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "train.sample")
