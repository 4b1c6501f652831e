"""The optimizer's update and its application: the time a
``train.update`` range was open over the profiled steps, in ms a step
(host clock, under the profiler)."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "train.update")
