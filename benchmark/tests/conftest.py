"""A tiny copy of the benchmark for the CPU tests: the harness and its
files, with tiny configurations and cells written as new files beside
them, driven on the CPU (the harness's look for a card is skipped).

The tests that need a card are marked ``cuda`` and decide inside the
``card`` fixture, never while a module is imported.
"""

import json
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FUMI = {
    "name": "tiny-fumi", "source": "test", "family": "fumi",
    "dtype": "float32", "tf32": False,
    "widths": {"im_emb_dim": 24, "im_hid_dim": [12, 6], "text_emb_dim": 10,
               "text_hid_dim": 8, "num_ways": 3},
    "episode": {"num_ways": 3, "num_shots": 2, "num_query_train": 4},
    "train": {"batch_size": 2, "inner_steps": 2, "step_size": 0.1,
              "optim": "adam", "adam_betas": [0.9, 0.999],
              "adam_eps": 1e-08, "lr": 0.001, "weight_decay": 0.0005,
              "dropout": 0.25, "gather": "kernel"},
    "serve": {"test_adapt_steps": 5, "step_size": 0.1},
    "data": {"classes": 15, "rows": 300, "split": [0.6, 0.2, 0.2],
             "row_shape": [24], "table_dtype": "float32",
             "table_values": "uniform01", "text_dim": 10},
    "port": {"model": "fumi", "dataset": "synthetic", "text_encoder": "BERT",
             "im_encoder": "precomputed", "im_emb_dim": 24,
             "im_hid_dim": [12, 6], "text_emb_dim": 10, "text_hid_dim": 8,
             "num_ways": 3, "num_shots": 2, "num_shots_test": 4,
             "batch_size": 2, "num_train_adapt_steps": 2,
             "num_test_adapt_steps": 5, "step_size": 0.1, "optim": "adam",
             "lr": 0.001, "weight_decay": 0.0005, "dropout": 0.25,
             "pallas_gather": True, "compute_dtype": "float32"},
    "reduced": [], "assumed": {}}

SERVE_TRAFFIC = {"split": "test", "loop": "closed", "clients": 1,
                 "queries": [3, 5, 7, 9]}
# limits for the tiny sizes on the CPU, where program and reference agree
# to fp32 rounding (the card's limits are the cells' own)
TRAIN_LIMITS = {"loss_gap_first": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3,
                "episode_gap": 0, "episode_bad": 0}
CELLS = {
    "tiny.serve": {
        "config": "tiny-fumi", "driver": "serve_inproc", "chips": 1,
        "why": "tiny", "traffic": dict(SERVE_TRAFFIC, name="tiny-serve"),
        "trace": {"requests": 4},
        "check": {"sample": 1000, "off_gap": 1e-3},
        "limits": {"logit_gap_median": 1e-4, "off_share": 0.1,
                   "failed_answers": 0}},
    "tiny.train": {
        "config": "tiny-fumi", "driver": "train", "chips": 1, "why": "tiny",
        "traffic": {"name": "tiny-train", "split": "train", "chunk": 3,
                    "warm_steps": 1},
        "trace": {"steps": 2}, "check": {"steps": 3},
        "limits": TRAIN_LIMITS},
}


def make_tiny_root(dest: str, cells=CELLS, extra_per_layer=()) -> str:
    """``dest`` holding a copy of the benchmark, the tiny configurations
    and cells as new files, and a BENCHMARK.json that names them."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    configs = []
    for cfg in (FUMI,):
        path = f"benchmark/configs/{cfg['name']}.json"
        with open(os.path.join(dest, path), "w") as f:
            json.dump(cfg, f)
        configs.append({"name": cfg["name"], "source": "test", "file": path,
                        "reduced": [], "why": "tiny"})
    workloads = []
    for name, cell in cells.items():
        with open(os.path.join(dest, "benchmark", "workloads",
                               name + ".json"), "w") as f:
            json.dump(dict(cell, name=name), f)
        workloads.append({"name": name, "config": cell["config"],
                          "traffic": cell["traffic"]["name"], "chips": 1,
                          "why": "tiny"})
    serve = [n for n, c in cells.items() if c["driver"] != "train"]
    train = [n for n, c in cells.items() if c["driver"] == "train"]

    def retarget(entry):
        w = entry.get("workloads")
        if w is None:
            return entry
        return dict(entry, workloads=train if "fumi.train" in w else serve)
    bench["configs"] = configs
    bench["workloads"] = workloads
    bench["end_to_end"] = [retarget(e) for e in bench["end_to_end"]]
    bench["per_layer"] = [retarget(e) for e in bench["per_layer"]] + list(
        extra_per_layer)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


def run_cpu(root: str, cell: str, trace: bool = False, seed: int = 5,
            seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU, through everything but the look
    for a card."""
    import torch
    from benchmark import harness
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
