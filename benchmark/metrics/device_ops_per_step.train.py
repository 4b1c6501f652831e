"""Device operations (kernels, copies, sets) a training step, over the
profiled steps: the count a CUDA graph of the step or fewer launches would
lower."""


def read(ctx, rec):
    tr = rec.get("trace")
    if tr is None or not tr.device:
        return None
    return len(tr.device) / rec["trace_steps"]
