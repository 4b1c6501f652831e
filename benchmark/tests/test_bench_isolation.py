"""A run loads neither JAX nor the JAX package, by whole top-level name
(``fumi_tpu_torch`` is the program and is allowed), and a run without its
card or without the program prints no result."""

import json
import os
import shutil
import subprocess
import sys

from conftest import REPO, make_tiny_root

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness, run
result = harness.run_cell({root!r}, {cell!r}, 3, 0.2, {trace}, torch.device("cpu"),
                          time.perf_counter())
print(json.dumps({{"correct": result["correct"],
                  "bad": run.forbidden_modules(),
                  "port": "fumi_tpu_torch" in sys.modules}}))
"""


def clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO  # the program; the benchmark comes from root
    return env


def test_running_a_cell_loads_no_jax_nor_the_jax_package(tmp_path):
    root = make_tiny_root(str(tmp_path))
    for cell, trace in (("tiny.train", True), ("tiny.serve", False)):
        code = RUN_TINY.format(root=root, cell=cell, trace=trace)
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             env=clean_env(), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == {"correct": True, "bad": [], "port": True}


def test_forbidden_names_are_whole_top_level_names():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules["fumi_tpu_torch_x"] = sys
        sys.modules["jaxfoo"] = sys
        assert "fumi_tpu" not in run.forbidden_modules() or \
            "fumi_tpu" in saved
        sys.modules["flax.core"] = sys
        assert "flax" in run.forbidden_modules()
    finally:
        for k in ("fumi_tpu_torch_x", "jaxfoo", "flax.core"):
            sys.modules.pop(k, None)


def test_no_card_or_no_program_prints_no_result(tmp_path):
    bare = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(bare, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for root in (REPO, bare):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "fumi.serve",
             "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
