"""The recomputes of checkpointed inner steps (``--tpu_remat``): the time
an ``inner.recompute`` range was open over the profiled steps, in ms a
step (host clock, under the profiler). Each is one inner step's forward
and inner gradient built again inside the outer backward; None where no
step was checkpointed, or on a program without the span."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "inner.recompute")
