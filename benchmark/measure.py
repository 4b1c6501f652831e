"""Runs of one cell, each a process of its own, and the spreads the bounds
are set from.

    python3 benchmark/measure.py --workload <cell> --seeds 11 12 13 \
        --sets 2 [--trace 0|1] [--seconds S] [--out DIR]

Runs ``benchmark/run.py`` once per seed in each of ``--sets`` sets (the
same seeds in every set), one after another, and prints, per end-to-end
metric, each set's median and spread (the distance between the first and
third quartiles over the median, ``statistics.quantiles(n=4)``), and
whether every run was ``correct``. Each run's last output lines go to
``DIR/<cell>.<set>.<seed>.json``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=os.path.join(ROOT, ".bench_cache",
                                                 "measure"))
    args = p.parse_args(argv)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    seconds = args.seconds or bench["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    sets = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            t0 = time.time()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=1200)
            wall = time.time() - t0
            lines = proc.stdout.strip().splitlines()
            result = None
            if proc.returncode == 0 and lines:
                result = json.loads(lines[-1])
            with open(os.path.join(args.out, f"{args.workload}.{s}.{seed}"
                                   f".t{args.trace}.json"), "w") as f:
                json.dump({"rc": proc.returncode, "wall_s": wall,
                           "result": result,
                           "stderr_tail": proc.stderr[-6000:]}, f, indent=1)
            runs.append(result)
            brief = None if result is None else {
                "correct": result["correct"],
                **{k: v["value"] for k, v in result["metrics"].items()}}
            print(f"set {s} seed {seed} rc {proc.returncode} wall "
                  f"{wall:.1f}s {json.dumps(brief)}", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], flush=True)
        sets.append(runs)
    for s, runs in enumerate(sets):
        ok = [r for r in runs if r is not None]
        names = sorted({k for r in ok for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            line = (f"set {s} {name}: median {statistics.median(vals)!r}")
            if len(vals) >= 2:
                q1, q2, q3 = statistics.quantiles(vals, n=4)
                line += f" spread {(q3 - q1) / q2!r}"
            print(line + f" values {vals}", flush=True)
        print(f"set {s} correct: {[r['correct'] if r else None for r in runs]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
