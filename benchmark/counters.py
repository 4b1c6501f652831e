"""The program's counters in a profiled stretch.

The port records its device's live memory at points of a training step as
zero-length ranges named ``mem.<point>=<bytes>``
(``fumi_tpu_torch/utils/profiling.py:count_memory``). A program without
the counter gives no such range: the readers then return None.
"""

from __future__ import annotations

from typing import Optional


def memory_bytes(tr, point: str) -> Optional[int]:
    """The most bytes ``point``'s counter read over the stretch; None
    without a reading."""
    if tr is None:
        return None
    head = f"mem.{point}="
    values = [int(e.name[len(head):]) for e in tr.host
              if e.name.startswith(head) and e.name[len(head):].isdigit()]
    return max(values) if values else None
