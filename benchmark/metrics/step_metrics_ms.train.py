"""The step's metrics (loss, accuracy, the gradient norms): the time a
``train.step_metrics`` range was open over the profiled steps, in ms a
step (host clock, under the profiler)."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "train.step_metrics")
