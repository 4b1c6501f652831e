"""The outer backward (``torch.autograd.grad`` of the loss): the time a
``train.meta_grad`` range was open over the profiled steps, in ms a step
(host clock, under the profiler)."""

from benchmark.spans import per_step_ms


def read(ctx, rec):
    return per_step_ms(rec, "train.meta_grad")
