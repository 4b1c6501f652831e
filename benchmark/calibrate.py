"""The readings the ``correct`` limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: the program's reading of each number
compared (sound runs: the lower reading), the control's (the plain
reference computed in TF32, the precision below the configuration's, put
in the program's place: the upper reading), and for a training cell the
reading of a fault planted in the reference (half of each batch left out,
the mean taken over the rest). A serving cell reads a short window of
``check.sample`` requests at the cell's own load. Each seed's
readings are a JSON line on standard error; the last line on standard
output sums them up: per number, the largest program reading and the
smallest control and fault readings. The benchmark's own runs do not run
this.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# sides whose smallest reading is the upper reading of a limit; the
# program's (and the fp64 witness's) largest is the lower one
LOWER_IS_UPPER = ("control", "half_batch")


def summarize(rows):
    out = {}
    for row in rows:
        for side, numbers in row.items():
            for name, v in numbers.items():
                if not isinstance(v, (int, float)):
                    continue
                slot = out.setdefault(side, {}).setdefault(name, [])
                slot.append(v)
    return {side: {name: (min(vs) if side in LOWER_IS_UPPER else max(vs))
                   for name, vs in numbers.items()}
            for side, numbers in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import cache_env
    cache_env(ROOT)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        ctx = harness.Context(ROOT, args.workload, seed, 0.0, False,
                              torch.device("cuda", 0), time.perf_counter())
        driver = ctx.module("drivers", ctx.workload["driver"])
        rows.append(driver.calibrate(ctx))
        del ctx, driver
        torch.cuda.empty_cache()
    summary = summarize(rows)
    print(json.dumps({"calibrate": args.workload, "seeds": args.seeds,
                      **summary}, default=lambda v: None
                     if isinstance(v, float) and math.isnan(v) else v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
