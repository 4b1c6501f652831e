"""One run of one cell: find its files by name, set it up, drive the window,
read its metrics, decide ``correct``.

Everything that belongs to one configuration, cell, driver, metric or
family is a file of its own, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json`` (the path ``BENCHMARK.json`` gives);
- ``benchmark/workloads/<cell>.json``: the configuration's name, the
  ``driver``, the ``traffic`` parameters, the check's ``limits``;
- ``benchmark/drivers/<driver>.py``: ``run(ctx) -> dict`` of records;
- ``benchmark/metrics/<metric>.py``: ``read(ctx, records)`` -> a number,
  or None where the run has nothing to read;
- ``benchmark/reference/<family>.py`` and ``benchmark/costs/<family>.py``
  for the configuration's ``family``.

A metric is read in a cell when ``BENCHMARK.json`` lists the cell under
the metric's ``workloads``, or gives the metric no ``workloads``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, Optional

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module at ``path`` (a file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Context:
    """What a driver and a metric reader get: the cell's files, the run's
    arguments, the device, and the set-up clock."""

    def __init__(self, root: str, cell: str, seed: int, seconds: float,
                 trace: bool, device, started: float):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        self.cell = cell
        self.workload = load_json(os.path.join(
            root, "benchmark", "workloads", cell + ".json"))
        cell_entry = next(w for w in self.bench["workloads"]
                          if w["name"] == cell)
        if cell_entry["traffic"] != self.workload["traffic"]["name"]:
            raise ValueError(f"{cell}: BENCHMARK.json names the traffic "
                             f"{cell_entry['traffic']!r}, the cell's file "
                             f"{self.workload['traffic']['name']!r}")
        entry = next(c for c in self.bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config = load_json(os.path.join(root, entry["file"]))
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.started = started
        self.parts: Dict[str, float] = {}
        self._last = started
        self.setup_s: Optional[float] = None
        family = self.config["family"]
        self.reference = self.module("reference", family)
        self.costs = self.module("costs", family)

    def module(self, kind: str, name: str):
        return load_module(
            os.path.join(self.root, "benchmark", kind, name + ".py"),
            f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_"))

    def mark(self, part: str) -> None:
        """Close the set-up part ``part`` at this moment."""
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self._last
        self._last = now

    def setup_done(self) -> None:
        """The end of set-up: the first timed unit starts now."""
        self.mark("warmup")
        self.setup_s = time.perf_counter() - self.started
        print("setup_s " + " ".join(f"{k}={v:.3f}"
                                    for k, v in self.parts.items())
              + f" total={self.setup_s:.3f}", file=sys.stderr, flush=True)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    @property
    def reference_dtype(self):
        """The plain reference's type: the configuration's own ``dtype``
        (the control runs one precision below it)."""
        import torch
        return getattr(torch, self.config["dtype"])

    @contextlib.contextmanager
    def window(self):
        """The measured window: Python's collector runs before it, and
        not inside it, over the objects set-up left."""
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            yield
        finally:
            gc.enable()
            gc.unfreeze()

    def program_config(self):
        """The program's own configuration object for this configuration."""
        from fumi_tpu_torch.core.config import Config
        port = dict(self.config["port"])
        if "im_hid_dim" in port:
            port["im_hid_dim"] = tuple(port["im_hid_dim"])
        return Config(**port)


def read_metrics(ctx: Context, records: dict, kind: str) -> Dict[str, dict]:
    out = {}
    for entry in ctx.bench[kind]:
        if not applies(entry, ctx.cell):
            continue
        reader = ctx.module("metrics", entry["name"])
        value = reader.read(ctx, records)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def device_info(ctx: Context, records: dict) -> dict:
    import torch
    if ctx.cuda:
        kind = torch.cuda.get_device_name(ctx.device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind,
            "count": int(ctx.workload.get("chips", 1)),
            "memory_peak_bytes": int(records.get("memory_peak_bytes", 0))}
    tr = records.get("trace")
    if ctx.trace and tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             device, started: float) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last)."""
    from benchmark import check
    ctx = Context(root, cell, seed, seconds, trace, device, started)
    driver = ctx.module("drivers", ctx.workload["driver"])
    records = driver.run(ctx)
    records["setup_s"] = ctx.setup_s
    correct, checks = check.verdict(records["numbers"],
                                    ctx.workload["limits"])
    result = {"correct": correct, "attempted": int(records["attempted"]),
              "failed": int(records["failed"]),
              "metrics": read_metrics(ctx, records,
                                      "per_layer" if trace else "end_to_end"),
              "device": device_info(ctx, records)}
    if trace and records.get("trace") is not None:
        result["breakdown"] = records["trace"].breakdown()
    result["checks"] = checks
    return result
