"""conv4's norm, ReLU and pool's share of the device's busy time over the
profiled steps: the union of the intervals of the device operations whose
name holds ``norm_relu_pool`` (``csrc/norm_relu_pool.cu``'s kernels, the
forward, backward and double backward) over the union of all of them; None
where the stretch ran none (a program that writes the chain out)."""

from benchmark import stats

PART = "norm_relu_pool"


def read(ctx, rec):
    tr = rec.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    spans = [(e.start, e.end) for e in tr.kernels(PART)]
    if not spans:
        return None
    return 100.0 * stats.covered(spans, tr.lo, tr.hi) / 1e6 / tr.busy_s
