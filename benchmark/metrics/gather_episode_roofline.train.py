"""``gather_episode_rows``' share of its roofline: the bytes a step's
episode must move (every row read once in the table's type, written once
in fp32, the int32 indices; ``costs.kernels.widen_bytes``) over the
bandwidth, against the kernel's device time a launch."""

import math

from benchmark.costs.kernels import widen_bytes
from benchmark.costs.peaks import PEAK_BYTES_PER_S

KERNEL = "(anonymous namespace)::gather_kernel<"
ELEM = {"float32": 4, "bfloat16": 2, "uint8": 1}


def read(ctx, rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    kernels = tr.kernels(KERNEL)
    if not kernels:
        return None
    cfg = ctx.config
    ep, data = cfg["episode"], cfg["data"]
    m = (cfg["train"]["batch_size"] * ep["num_ways"]
         * (ep["num_shots"] + ep["num_query_train"]))
    least = widen_bytes(m, math.prod(data["row_shape"]),
                        ELEM[data["table_dtype"]]) / PEAK_BYTES_PER_S
    busy = sum(k.end - k.start for k in kernels) / 1e6
    return 100.0 * least * len(kernels) / busy
