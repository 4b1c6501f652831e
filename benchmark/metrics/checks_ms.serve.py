"""The request's validation and shaping (the label check, the array
coercions, the text, the query padding): the median over the profiled
requests of the time a ``serve.checks`` range was open inside the
request's ``serve.request`` (host clock, under the profiler)."""

from benchmark.spans import median_per_request_ms


def read(ctx, rec):
    return median_per_request_ms(rec.get("trace"), "serve.checks")
