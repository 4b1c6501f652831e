"""The whole request's share of the card's fp32 peak: the model operations
of the window's answered requests, from the configuration's shapes
(``benchmark/costs``), over the window's time."""

from benchmark.costs.peaks import PEAK_FP32_FLOPS


def read(ctx, rec):
    if not rec.get("window_s") or not ctx.cuda:
        return None
    flops = sum(ctx.costs.request_flops(ctx.config, r["req"].m)
                for r in rec["requests"] if r["ok"])
    return 100.0 * flops / (rec["window_s"] * PEAK_FP32_FLOPS)
