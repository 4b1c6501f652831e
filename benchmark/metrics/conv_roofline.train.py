"""The convolutions' share of their roofline: the convolution products'
operations of the profiled steps (``costs``' ``conv_flops``, each product
counted once as the algorithm needs it) at the card's fp32 peak, over the
time in which a convolution kernel ran (``benchmark/convs.py``)."""

from benchmark.convs import conv_busy_s
from benchmark.costs.peaks import PEAK_FP32_FLOPS


def read(ctx, rec):
    conv_flops = getattr(ctx.costs, "conv_flops", None)
    busy = conv_busy_s(rec.get("trace"))
    if conv_flops is None or busy is None or not rec.get("trace_steps"):
        return None
    least = conv_flops(ctx.config) * rec["trace_steps"] / PEAK_FP32_FLOPS
    return 100.0 * least / busy
