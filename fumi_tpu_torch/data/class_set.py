"""ClassSet — one meta-split flattened into dense tables.

A copy of ``fumi_tpu/data/class_set.py``, which is pure numpy: the port
keeps its own because importing anything under ``fumi_tpu`` pulls in JAX.
``tests/test_torch_sampler.py`` holds the copy equal to the original.

A split is three tables: an image-embedding table shared by all splits
(rows keyed by global image id), a padded per-class row table
``(C, max_count)`` with its counts, and a per-class text-feature table.
Episode sampling is then index math and gathers
(``fumi_tpu_torch/data/sampler.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ClassSet:
    """One meta-split's classes, padded to rectangular tables."""

    categories: np.ndarray  # (C,) global category ids (split order)
    class_image_rows: np.ndarray  # (C, max_count) int32 rows into image table
    class_counts: np.ndarray  # (C,) int32 images per class
    text_features: np.ndarray  # (C, E) float32 or (C, T) int32 tokens
    text_mask: Optional[np.ndarray] = None  # (C, T) for token text
    descriptions: Optional[list] = None  # raw description strings

    @property
    def num_classes(self) -> int:
        return int(self.categories.shape[0])

    @property
    def max_count(self) -> int:
        return int(self.class_image_rows.shape[1])

    @property
    def text_is_tokens(self) -> bool:
        return np.issubdtype(self.text_features.dtype, np.integer)

    def validate_episode(self, num_shots: int, num_query: int) -> None:
        """Fail fast if any class is too small for K support + Q query
        (the device sampler would silently sample with replacement)."""
        need = num_shots + num_query
        too_small = self.class_counts < need
        if np.any(too_small):
            raise ValueError(
                f"{int(too_small.sum())}/{self.num_classes} classes have "
                f"fewer than {need} images (min "
                f"{int(self.class_counts.min())})")


def build_class_tables(categories: np.ndarray,
                       category_to_image_ids: dict) -> tuple:
    """Pad per-class image-id lists into (C, max_count) + counts."""
    counts = np.array([len(category_to_image_ids[c]) for c in categories],
                      dtype=np.int32)
    max_count = int(counts.max()) if len(counts) else 0
    rows = np.zeros((len(categories), max_count), dtype=np.int32)
    for i, c in enumerate(categories):
        ids = np.asarray(category_to_image_ids[c], dtype=np.int32)
        rows[i, :len(ids)] = ids
        # pad with the first image id; padding slots are never selected
        # (masked out / count-bounded)
        if len(ids) and len(ids) < max_count:
            rows[i, len(ids):] = ids[0]
    return rows, counts
