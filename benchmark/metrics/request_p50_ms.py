"""The median latency of every request of the window, client-timed; a
failed request counts as never answered."""

import math

from benchmark.stats import percentile


def read(ctx, rec):
    ms = [r["ms"] if r["ok"] else math.inf for r in rec["requests"]]
    return percentile(ms, 50) if ms else None
