"""The request path's own time: the median over the profiled requests of
the harness's span around ``episode_logits`` minus the device time of
that request's ``fused_adapt`` kernel (validation, bucketing, copies to
and from the card, the hypernetwork, the launch)."""

import statistics

KERNEL = "(anonymous namespace)::fused_adapt_kernel<"


def read(ctx, rec):
    tr = rec.get("trace")
    spans = rec.get("trace_spans") or []
    if tr is None:
        return None
    kernels = tr.kernels(KERNEL)
    if not kernels or len(kernels) != len(spans):
        return None
    return statistics.median(1e3 * s - (k.end - k.start) / 1e3
                             for s, k in zip(spans, kernels))
