"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's files are found by name (see
``benchmark/harness.py``). The run needs as many CUDA cards as the cell
asks for and exits non-zero, printing no result, where they are missing,
or where JAX or the JAX package was loaded. Its last lines on standard
error are the numbers that decide ``correct``, each beside its limit; its
last line on standard output is the result as one JSON object.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "fumi_tpu")


def cache_env(root: str) -> None:
    """Kernel caches at fixed places inside the checkout, and no JAX pulled
    in by a library that would load it on its own. (The port's own CUDA
    kernels build into ``fumi_tpu_torch/build/``, inside the checkout.)"""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark import check, harness
    wl = harness.load_json(os.path.join(ROOT, "benchmark", "workloads",
                                        args.workload + ".json"))
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"run: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    check.print_lines(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
