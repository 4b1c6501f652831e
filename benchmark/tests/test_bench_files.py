"""The benchmark is driven by data: every configuration, cell, driver,
metric and reference is a file of its own, found by name, and a new cell
or metric is picked up from new files alone."""

import json
import os
import re

import pytest

from conftest import REPO, make_tiny_root, run_cpu

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def entries():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(REPO, BENCH["command"][1]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_is_a_file_of_its_own(entry):
    assert NAME.match(entry["name"])
    path = os.path.join(REPO, entry["file"])
    cfg = json.load(open(path))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    for kind in ("reference", "costs"):
        assert os.path.isfile(os.path.join(REPO, "benchmark", kind,
                                           cfg["family"] + ".py"))
    # the program runs the widths the configuration states
    port, w = cfg["port"], cfg["widths"]
    for key in ("im_emb_dim", "text_emb_dim", "text_hid_dim", "num_ways",
                "im_size", "im_channels"):
        if key in w and key in port:
            assert port[key] == w[key], key
    assert port["num_ways"] == cfg["episode"]["num_ways"]
    assert port["num_shots"] == cfg["episode"]["num_shots"]
    assert port["num_shots_test"] == cfg["episode"]["num_query_train"]
    for key, pkey in (("batch_size", "batch_size"),
                      ("inner_steps", "num_train_adapt_steps"),
                      ("step_size", "step_size"), ("lr", "lr"),
                      ("weight_decay", "weight_decay"),
                      ("dropout", "dropout")):
        assert port[pkey] == cfg["train"][key], key
    assert port["compute_dtype"] == cfg["dtype"] == "float32"


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=lambda e: e["name"])
def test_each_cell_is_a_file_of_its_own(entry):
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    cell = json.load(open(os.path.join(REPO, "benchmark", "workloads",
                                       entry["name"] + ".json")))
    assert cell["name"] == entry["name"]
    assert cell["config"] == entry["config"]
    assert cell["traffic"]["name"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] == 1
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert os.path.isfile(os.path.join(REPO, "benchmark", "drivers",
                                       cell["driver"] + ".py"))
    reported = [e for e in BENCH["end_to_end"]
                if "workloads" not in e or entry["name"] in e["workloads"]]
    assert "setup_s" in [e["name"] for e in reported] and len(reported) >= 2
    assert any(entry["name"] in e.get("workloads", [entry["name"]])
               for e in BENCH["per_layer"])


@pytest.mark.parametrize("entry", entries(), ids=lambda e: e["name"])
def test_each_metric_is_a_reader_of_its_own(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert os.path.isfile(os.path.join(REPO, "benchmark", "metrics",
                                       entry["name"] + ".py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if entry in BENCH["per_layer"]:
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert entry["moves"] in e2e
        # each cell that reads it reports the metric it moves
        moved = e2e[entry["moves"]].get("workloads", cells)
        assert set(entry["workloads"]) <= set(moved)
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_layer_names_agree_within_a_layer():
    layers = {}
    for e in BENCH["per_layer"]:
        layers.setdefault(e["name"].split(".")[0].rsplit("_", 1)[-1],
                          set()).add(e["layer"])
    assert len({e["layer"] for e in BENCH["per_layer"]
                if e["name"].startswith("idle_share")}) == 1
    assert len({e["layer"] for e in BENCH["per_layer"]
                if e["name"].endswith(("roofline.serve",
                                       "roofline.train"))}) == 1


DUMMY_METRIC = '''
"""A dummy per-layer metric: the profiled stretch's device window."""


def read(ctx, rec):
    return 1.0 if rec.get("trace") is not None else None
'''


def test_a_new_cell_and_metric_are_picked_up_from_new_files(tmp_path):
    """A cell and a metric added as new files, and named in
    BENCHMARK.json, run with no edit of any file that was there."""
    from conftest import CELLS
    cells = {"dummy.train": dict(CELLS["tiny.train"],
                                 traffic=dict(CELLS["tiny.train"]["traffic"],
                                              name="dummy-train"))}
    extra = [{"name": "dummy_count.train", "unit": "ops", "better": "lower",
              "source": "device_trace", "layer": "device",
              "moves": "train_device_ms_per_episode",
              "workloads": ["dummy.train"]}]
    root = make_tiny_root(str(tmp_path), cells, extra)
    with open(os.path.join(root, "benchmark", "metrics",
                           "dummy_count.train.py"), "w") as f:
        f.write(DUMMY_METRIC)
    result = run_cpu(root, "dummy.train", trace=True)
    assert result["correct"]
    assert result["metrics"]["dummy_count.train"] == {"value": 1.0,
                                                      "unit": "ops"}
    assert list(result)[-1] == "checks"
