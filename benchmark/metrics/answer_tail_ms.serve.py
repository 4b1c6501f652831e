"""How long the answer takes once the card has it: the median over the
profiled requests of the end of the request's ``serve.to_host`` range
minus the end of its ``fused_adapt`` kernel on the device, both on the
profiler's clock. The card's part (the copy back of a few KB) is small;
most of it is the host's: its return from the blocking copy and the
operators that make the array, each with the profiler's cost."""

import statistics

from benchmark.spans import answer_tails_ms


def read(ctx, rec):
    tr = rec.get("trace")
    tails = answer_tails_ms(tr) if tr is not None else []
    return statistics.median(tails) if tails else None
