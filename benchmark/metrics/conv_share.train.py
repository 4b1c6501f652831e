"""The convolution kernels' share of the device's busy time over the
profiled steps (the union of each set of intervals,
``benchmark/convs.py``): how much of a step the convolutions and their
first and second backward are."""

from benchmark.convs import conv_busy_s


def read(ctx, rec):
    tr = rec.get("trace")
    conv = conv_busy_s(tr)
    if conv is None or tr.busy_s <= 0:
        return None
    return 100.0 * conv / tr.busy_s
