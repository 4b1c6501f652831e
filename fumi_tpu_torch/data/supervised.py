"""Supervised (non-episodic) dataset for the CLIP path.

A copy of ``fumi_tpu/data/supervised.py``, which is pure numpy: the port
keeps its own because importing anything under ``fumi_tpu`` pulls in JAX.
``tests/test_torch_isolation.py`` holds the copy equal to the original.

Flat ``(image_embedding, class_text_embedding, category_id)`` triplets
over a split: three dense tables and an epoch iterator that yields padded
fixed-shape batches, with a validity count for the final partial batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from fumi_tpu_torch.data.class_set import ClassSet


@dataclasses.dataclass
class SupervisedSet:
    """One split's flat supervised view."""
    image_rows: np.ndarray  # (M,) rows into the image table
    category_ids: np.ndarray  # (M,) global category id per image
    class_index: np.ndarray  # (M,) index into text_features per image
    text_features: np.ndarray  # (C, E) per-class text embeddings

    @property
    def num_items(self) -> int:
        return int(self.image_rows.shape[0])


def supervised_from_class_set(cs: ClassSet) -> SupervisedSet:
    """Flatten a ClassSet into per-image triplet tables."""
    rows, cats, cls_idx = [], [], []
    for ci in range(cs.num_classes):
        cnt = int(cs.class_counts[ci])
        rows.append(cs.class_image_rows[ci, :cnt])
        cats.append(np.full(cnt, cs.categories[ci], dtype=np.int64))
        cls_idx.append(np.full(cnt, ci, dtype=np.int64))
    return SupervisedSet(
        image_rows=np.concatenate(rows),
        category_ids=np.concatenate(cats),
        class_index=np.concatenate(cls_idx),
        text_features=np.asarray(cs.text_features, dtype=np.float32),
    )


def epoch_batches(ds: SupervisedSet, image_table: np.ndarray,
                  batch_size: int, rng: np.random.RandomState,
                  shuffle: bool = True
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      int]]:
    """Yield (image (B,Di), text (B,Dt), category_ids (B,), valid_n).

    Batches are padded to ``batch_size`` (repeating row 0) with ``valid_n``
    giving the true length: the torch DataLoader's final partial batch in
    static-shape form.
    """
    order = np.arange(ds.num_items)
    if shuffle:
        rng.shuffle(order)
    for s in range(0, ds.num_items, batch_size):
        idx = order[s:s + batch_size]
        valid_n = len(idx)
        if valid_n < batch_size:
            idx = np.concatenate(
                [idx, np.repeat(idx[:1], batch_size - valid_n)])
        yield (image_table[ds.image_rows[idx]],
               ds.text_features[ds.class_index[idx]],
               ds.category_ids[idx],
               valid_n)
