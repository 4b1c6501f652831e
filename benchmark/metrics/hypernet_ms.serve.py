"""The request's text hypernetwork (``FUMI.get_hyper_params``): the
median over the profiled requests of the time a ``hypernet`` range was
open inside the request's ``serve.request`` (host clock, under the
profiler)."""

from benchmark.spans import median_per_request_ms


def read(ctx, rec):
    return median_per_request_ms(rec.get("trace"), "hypernet")
