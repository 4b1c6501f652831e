"""``--tpu_watch``: histograms of the params and of the meta-gradients.

The counterpart of ``fumi_tpu/train/watch.py``, with its fixed buckets and
its row names:

- **Fixed buckets**, shared by every component and every step: exact zeros,
  signed log-magnitudes ±[1e-10, 1e2) in half-decades (finite values below
  1e-10 fold into the smallest, above 1e2 into the largest), and a last
  bucket for NaN and ±Inf. Fixed buckets make the counts sum across steps,
  chunks and runs.
- Counts are made **on the device**: the bucket index of every element
  (``log10 |x|`` as the JAX package computes it) and one ``index_add_`` of
  ones into ``NUM_BUCKETS`` int64 counters. ``torch.bincount`` would read
  the largest index back to the host to size its output, a sync a step;
  ``index_add_`` into a fixed size makes none.
- :func:`grad_histogram_metrics` runs inside ``make_chunked_train(watch=
  True)`` on the meta-gradient of every :data:`WATCH_STRIDE`-th step, so
  the counts are a systematic sample of the gradients the run trains on;
  the loop fetches them once a chunk (:func:`split_watch_counts`), sums
  them, and writes them at each ``--eval_freq`` boundary with the params'
  own histograms (:func:`watch_record`, :func:`log_watch`) as the JSONL
  rows ``watch/params/<component>``, ``watch/grads/<component>`` and
  ``watch/grad_steps``; the bucket labels (``watch/buckets``) once a run.

The episode-parallel engine (``parallel/engine.py``) histograms the
meta-gradient after its all-reduce, the same on every rank, so a dp run's
counts are of the gradient the run applies; the 2-D engine takes one
point sample a boundary (``train/loop.py``).

Components are ``train/steps.py:component_partition``'s, the names of the
``grad_norm/<component>`` metrics, so the two join on the same keys. The
port's state dicts are flat, so every function here takes the family's
name as well.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# index 0 counts exact zeros; 1.._N_MAG the negatives, largest magnitude
# first; _N_MAG+1..2*_N_MAG the positives; the last bucket non-finite values
_LOG_LO, _LOG_HI, _PER_DECADE = -10.0, 2.0, 2
_N_MAG = int((_LOG_HI - _LOG_LO) * _PER_DECADE)
NUM_BUCKETS = 2 + 2 * _N_MAG
WATCH_METRIC_PREFIX = "watch_counts/"
# the chunked driver histograms one meta-gradient every WATCH_STRIDE steps
# (the last step of each block of that many), as the JAX package samples
WATCH_STRIDE = 8


def bucket_labels():
    """The buckets' labels: ``zero``, the negatives from the largest
    magnitude down, the positives up, ``nonfinite``."""
    mags = [f"1e{_LOG_LO + i / _PER_DECADE:+.1f}" for i in range(_N_MAG)]
    return (["zero"] + [f"-{m}" for m in reversed(mags)]
            + [f"+{m}" for m in mags] + ["nonfinite"])


def bucket_index(x: torch.Tensor) -> torch.Tensor:
    """The bucket of every element of ``x``, flattened, as int64."""
    x = x.reshape(-1)
    finite = torch.isfinite(x)
    ax = torch.where(finite, x.abs(), torch.ones_like(x))
    mag = torch.clamp(
        torch.floor((torch.log10(torch.clamp(ax, min=1e-30)) - _LOG_LO)
                    * _PER_DECADE), 0, _N_MAG - 1).to(torch.int64)
    idx = torch.where(x < 0, _N_MAG - mag, 1 + _N_MAG + mag)
    idx = torch.where(x == 0, torch.zeros_like(idx), idx)
    return torch.where(finite, idx, torch.full_like(idx, NUM_BUCKETS - 1))


def bucketize(x: torch.Tensor) -> torch.Tensor:
    """(NUM_BUCKETS,) int64 counts of ``x``'s elements, on its device."""
    idx = bucket_index(x)
    return torch.zeros(NUM_BUCKETS, dtype=torch.int64,
                       device=x.device).index_add_(0, idx,
                                                   torch.ones_like(idx))


def _component_counts(tree: Dict[str, torch.Tensor], family: str
                      ) -> Dict[str, torch.Tensor]:
    from fumi_tpu_torch.train.steps import component_partition
    return {name: bucketize(torch.cat([v.detach().reshape(-1)
                                       for v in comp.values()]))
            for name, comp in component_partition(tree, family).items()}


def component_histograms(tree: Dict[str, torch.Tensor], family: str
                         ) -> Dict[str, np.ndarray]:
    """{component: (NUM_BUCKETS,) counts} of a params or gradient state
    dict, fetched to the host."""
    return {k: v.cpu().numpy()
            for k, v in _component_counts(tree, family).items()}


def grad_histogram_metrics(grads: Dict[str, torch.Tensor], family: str
                           ) -> Dict[str, torch.Tensor]:
    """``{watch_counts/<component>: (NUM_BUCKETS,)}`` of one step's
    meta-gradient, left on the device for the chunk's metrics."""
    return {WATCH_METRIC_PREFIX + k: v
            for k, v in _component_counts(grads, family).items()}


def split_watch_counts(ms: Dict) -> Tuple[Dict, Dict[str, np.ndarray], int]:
    """A chunk's metrics -> (the other metrics, the watch counts summed
    over the chunk's sampled steps, the number of sampled steps: the rows
    that counted anything)."""
    plain = {k: v for k, v in ms.items()
             if not k.startswith(WATCH_METRIC_PREFIX)}
    counts, steps = {}, 0
    for k, v in ms.items():
        if not k.startswith(WATCH_METRIC_PREFIX):
            continue
        rows = np.asarray(v.cpu() if torch.is_tensor(v) else v,
                          dtype=np.int64)
        counts[k[len(WATCH_METRIC_PREFIX):]] = rows.sum(axis=0)
        steps = max(steps, int((rows.sum(axis=1) > 0).sum()))
    return plain, counts, steps


def watch_record(params: Dict[str, torch.Tensor], family: str,
                 grads: Optional[Dict[str, torch.Tensor]] = None,
                 grad_counts: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
    """One boundary's record: the params' histograms, and the gradients'
    from ``grad_counts`` (summed by the chunked driver) or else from one
    ``grads`` state dict (the host-sampler path's point sample)."""
    rec = {f"watch/params/{k}": v
           for k, v in component_histograms(params, family).items()}
    if grad_counts:
        rec.update({f"watch/grads/{k}": v for k, v in grad_counts.items()})
    elif grads is not None:
        rec.update({f"watch/grads/{k}": v for k, v in
                    component_histograms(grads, family).items()})
    return rec


def log_watch(writer, rec: Dict[str, np.ndarray],
              step: Optional[int] = None) -> None:
    """Write a record as one JSONL row, with the bucket labels the first
    time for this writer."""
    if not getattr(writer, "_watch_buckets_logged", False):
        rec = dict(rec, **{"watch/buckets": bucket_labels()})
        writer._watch_buckets_logged = True
    writer.log_arrays(rec, step=step)
