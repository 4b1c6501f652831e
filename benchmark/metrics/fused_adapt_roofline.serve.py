"""``fused_adapt``'s share of its roofline: the least time the card could
take for each profiled request's adaptation (its operations over the fp32
peak or its bytes over the bandwidth, counted from the request's shapes
with its true query count), summed, over the kernel's device time."""

from benchmark.costs.kernels import fused_adapt_cost
from benchmark.costs.peaks import least_seconds

KERNEL = "(anonymous namespace)::fused_adapt_kernel<"


def read(ctx, rec):
    tr = rec.get("trace")
    queries = rec.get("trace_queries") or []
    if tr is None:
        return None
    kernels = tr.kernels(KERNEL)
    if not kernels or len(kernels) != len(queries):
        return None
    w, ep = ctx.config["widths"], ctx.config["episode"]
    h1, h2 = w["im_hid_dim"]
    s = ep["num_ways"] * ep["num_shots"]
    least = sum(least_seconds(*fused_adapt_cost(
        1, s, m, w["im_emb_dim"], h1, h2, w["num_ways"],
        ctx.config["serve"]["test_adapt_steps"])) for m in queries)
    busy = sum(k.end - k.start for k in kernels) / 1e6
    return 100.0 * least / busy
