"""Metric writer and running average.

The counterpart of ``fumi_tpu/train/logging.py``: a ``log(dict, step)``
surface that writes a JSONL file per run (``<log_dir>/<run>.metrics.jsonl``)
and keeps a summary, and also logs to wandb where it is installed and the
run is not ``--wandb_offline``. wandb is optional: where it cannot start,
one warning says so and the run logs to JSONL only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    """wandb-compatible metric writer with a JSONL record."""

    def __init__(self, log_dir: str, run_name: Optional[str] = None,
                 use_wandb: bool = True, wandb_kwargs: Optional[dict] = None,
                 offline: bool = False, run_suffix: str = ""):
        self.run_name = (run_name or f"run_{int(time.time())}") + run_suffix
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._wandb = None
        if use_wandb and not offline:
            try:
                import wandb  # optional dependency
                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
                if wandb.run is not None and wandb.run.name:
                    self.run_name = wandb.run.name + run_suffix
            except Exception as e:  # any failure of an optional service
                print(f"warning: wandb unavailable "
                      f"({type(e).__name__}: {e}); logging to JSONL only")
                self._wandb = None
        self._jsonl = open(
            os.path.join(log_dir, f"{self.run_name}.metrics.jsonl"), "a")
        self.summary: Dict[str, float] = {}
        self._since_flush = 0

    @property
    def run_dir(self) -> str:
        """The live wandb run's directory, else ``log_dir``."""
        if self._wandb is not None and self._wandb.run is not None:
            return self._wandb.run.dir
        return self.log_dir

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if _is_scalar(v)}
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        rec = dict(scalars)
        if step is not None:
            rec["_step"] = step
        self._jsonl.write(json.dumps(rec) + "\n")
        # flush in batches: per-step training logs arrive a chunk at a time
        self._since_flush += 1
        if self._since_flush >= 100:
            self._jsonl.flush()
            self._since_flush = 0
        self.summary.update(scalars)

    def log_arrays(self, arrays: Dict, step: Optional[int] = None) -> None:
        """Log a record of lists (``--tpu_watch``'s count vectors and
        bucket labels): one JSONL row, and ``wandb.Histogram`` objects of
        the count vectors on a live wandb run."""
        rec = {k: v.tolist() if hasattr(v, "tolist") else v
               for k, v in arrays.items()}
        if self._wandb is not None:
            wb = {k: self._wandb.Histogram(
                np_histogram=(v, list(range(len(v) + 1))))
                for k, v in rec.items() if isinstance(v, list) and v
                and isinstance(v[0], (int, float))}
            if wb:
                self._wandb.log(wb, step=step)
        if step is not None:
            rec["_step"] = step
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def flush(self) -> None:
        self._jsonl.flush()
        self._since_flush = 0

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        self._jsonl.flush()
        self._jsonl.close()


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError, RuntimeError):
        return False


class AverageMeter:
    """Running average (the reference's ``utils/average_meter.py``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
