"""The control on the card: the plain reference computed in TF32 (the
precision below the configurations' IEEE fp32), put in the program's
place, fails at least one of each cell's limits, on three seeds at the
cell's own size, while the program passes them all. Fault planted in the
reference for the training cells: half of each batch left out.

Run on the card: ``python -m pytest benchmark/tests -m cuda``."""

import json
import os
import time

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.load(open(os.path.join(
    REPO, "BENCHMARK.json")))["workloads"]]
SEEDS = (9101, 9102, 9103)


def fails(numbers, limits):
    return [k for k in numbers if k in limits and not numbers[k] <= limits[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_and_the_program_passes(card, cell):
    import torch
    from benchmark import harness
    for seed in SEEDS:
        ctx = harness.Context(REPO, cell, seed, 0.0, False, card,
                              time.perf_counter())
        limits = ctx.workload["limits"]
        out = ctx.module("drivers", ctx.workload["driver"]).calibrate(ctx)
        assert not fails(out["program"], limits), out["program"]
        assert set(limits) - {"failed_answers", "episode_gap",
                              "episode_bad"} <= set(out["program"])
        assert fails(out["control"], limits), out["control"]
        if "half_batch" in out:
            assert fails(out["half_batch"], limits), out["half_batch"]
        del ctx
        torch.cuda.empty_cache()
