"""The general generator of episode requests, read from a cell's traffic.

A cell's ``traffic`` block (``benchmark/workloads/<cell>.json``) holds
parameters only:

- ``split``: the classes requests draw from (``train``, ``val``,
  ``test``);
- ``queries``: the query counts a request may have. Each block of
  ``len(queries)`` consecutive requests holds every count once, in an
  order drawn from the seed, so every seed sends the same work; seeds
  change which rows and classes are sent and in what order.

A request is N distinct classes of the split, K distinct support rows a
class (class-major labels 0..N-1), and M query rows spread evenly over
those N classes (M // N a class, the first M % N classes one more, in
seed-drawn slots), distinct from the support rows. The generator hands
out row indices and class ids; the driver turns them into what the
client sends.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from benchmark.data import Tables


class Request(NamedTuple):
    index: int  # place in the stream
    classes: np.ndarray  # (N,) class ids
    support_rows: np.ndarray  # (N*K,) int64, class-major
    support_y: np.ndarray  # (N*K,) int32
    query_rows: np.ndarray  # (M,) int64
    query_y: np.ndarray  # (M,) int32, the class slot of each query

    @property
    def m(self) -> int:
        return int(self.query_rows.shape[0])


class EpisodeTraffic:
    """Requests of a cell, drawn from ``seed`` on the host."""

    def __init__(self, traffic: dict, episode: dict, tables: Tables,
                 seed: int):
        self.n = int(episode["num_ways"])
        self.k = int(episode["num_shots"])
        self.classes = tables.split_classes[traffic["split"]]
        self.bounds = tables.bounds
        self.sizes = [int(m) for m in traffic["queries"]]
        self.rng = np.random.default_rng(int(seed))
        self.order: List[int] = []
        self.count = 0

    def draw(self, index: int, m: int) -> Request:
        """Request ``index`` with ``m`` queries, drawn from the stream."""
        rng, n, k = self.rng, self.n, self.k
        classes = rng.choice(self.classes, n, replace=False)
        per_class = np.bincount(rng.permutation(np.arange(m) % n),
                                minlength=n)
        s_rows, q_rows, q_y = [], [], []
        for slot, c in enumerate(classes):
            lo, hi = self.bounds[c], self.bounds[c + 1]
            picked = lo + rng.permutation(hi - lo)[:k + per_class[slot]]
            s_rows.append(picked[:k])
            q_rows.append(picked[k:])
            q_y.append(np.full(per_class[slot], slot, np.int32))
        q_rows, q_y = np.concatenate(q_rows), np.concatenate(q_y)
        shuffle = rng.permutation(m)
        return Request(index=index, classes=classes,
                       support_rows=np.concatenate(s_rows),
                       support_y=np.repeat(np.arange(n), k).astype(np.int32),
                       query_rows=q_rows[shuffle], query_y=q_y[shuffle])

    def next(self) -> Request:
        """The next request of the stream."""
        if not self.order:
            self.order = list(self.rng.permutation(len(self.sizes)))
        j = self.order.pop()
        i, self.count = self.count, self.count + 1
        return self.draw(i, self.sizes[j])
