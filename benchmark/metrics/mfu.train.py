"""The whole step's share of the card's fp32 peak: a step's model
operations from the configuration's shapes (``benchmark/costs``: forward,
inner backward, the second-order outer backward, each counted once) times
the window's steps, over the window's time."""

from benchmark.costs.peaks import PEAK_FP32_FLOPS


def read(ctx, rec):
    if not rec.get("window_s") or not ctx.cuda:
        return None
    flops = ctx.costs.step_flops(ctx.config) * rec["steps"]
    return 100.0 * flops / (rec["window_s"] * PEAK_FP32_FLOPS)
