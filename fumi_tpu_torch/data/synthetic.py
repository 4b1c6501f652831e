"""Synthetic episodic data for tests and benchmarks.

A copy of ``fumi_tpu/data/synthetic.py`` (pure numpy;
``tests/test_torch_sampler.py``, ``tests/test_torch_text_encoders.py`` and
``tests/test_torch_raw_data.py`` hold it bitwise equal to the original).
Class-clustered Gaussian image embeddings with text features correlated
to the class mean (or random token ids), or raw NHWC images of smoothed
class patterns plus noise, so few-shot learners have real signal to adapt
to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fumi_tpu_torch.data.class_set import ClassSet


def synthetic_class_set(num_classes: int = 20,
                        images_per_class: int = 40,
                        im_dim: int = 64,
                        text_dim: int = 32,
                        text_tokens: bool = False,
                        vocab_size: int = 128,
                        text_len: int = 12,
                        noise: float = 0.5,
                        seed: int = 0) -> Tuple[ClassSet, np.ndarray,
                                                np.ndarray]:
    """Returns (class_set, image_table, image_ids).

    Image embeddings: class mean ~ N(0, I), samples mean + noise·N(0, I).
    Text features: a linear projection of the class mean (+ small noise), or
    random token ids when ``text_tokens``.
    """
    rng = np.random.RandomState(seed)
    C, M = num_classes, images_per_class
    means = rng.randn(C, im_dim).astype(np.float32)
    image_table = (means[:, None, :] +
                   noise * rng.randn(C, M, im_dim)).astype(np.float32)
    image_table = image_table.reshape(C * M, im_dim)
    image_ids = np.arange(C * M, dtype=np.int32)

    proj = rng.randn(im_dim, text_dim).astype(np.float32) / np.sqrt(im_dim)
    if text_tokens:
        text = rng.randint(1, vocab_size, size=(C, text_len)).astype(np.int32)
        text_mask = np.ones((C, text_len), dtype=np.int32)
    else:
        text = (means @ proj +
                0.1 * rng.randn(C, text_dim)).astype(np.float32)
        text_mask = None

    rows = np.arange(C * M, dtype=np.int32).reshape(C, M)
    counts = np.full((C,), M, dtype=np.int32)
    cs = ClassSet(
        categories=np.arange(C),
        class_image_rows=rows,
        class_counts=counts,
        text_features=text,
        text_mask=text_mask,
        descriptions=[f"synthetic class {i}" for i in range(C)],
    )
    return cs, image_table, image_ids


def synthetic_raw_image_set(num_classes: int = 10,
                            images_per_class: int = 20,
                            im_size: int = 28, channels: int = 3,
                            text_dim: int = 16, noise: float = 0.4,
                            seed: int = 0):
    """Raw-image ClassSet: class-specific blob patterns + noise, NHWC; the
    image "table" is (num_images, H, W, C) fp32."""
    rng = np.random.RandomState(seed)
    C, M, S = num_classes, images_per_class, im_size
    # each class: a smooth random pattern; samples add pixel noise
    base = rng.randn(C, S, S, channels).astype(np.float32)
    # smooth with a separable box filter for spatial structure
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, base)
    base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 2, base)
    imgs = (base[:, None] +
            noise * rng.randn(C, M, S, S, channels)).astype(np.float32)
    image_table = imgs.reshape(C * M, S, S, channels)
    image_ids = np.arange(C * M, dtype=np.int32)
    rows = np.arange(C * M, dtype=np.int32).reshape(C, M)
    cs = ClassSet(
        categories=np.arange(C),
        class_image_rows=rows,
        class_counts=np.full((C,), M, dtype=np.int32),
        text_features=rng.randn(C, text_dim).astype(np.float32),
        text_mask=None,
        descriptions=[f"raw class {i}" for i in range(C)],
    )
    return cs, image_table, image_ids


def synthetic_dictionary(vocab_size: int = 128):
    """Token dictionary for synthetic token-text datasets (PAD = 0)."""
    d = {"<PAD>": 0}
    for i in range(1, vocab_size):
        d[f"w{i}"] = i
    return d


def synthetic_splits(num_classes: int = 32, images_per_class: int = 64,
                     im_dim: int = 2048, text_dim: int = 768,
                     seed: int = 0, raw_images: bool = False,
                     im_size: int = 84, channels: int = 3, **kw):
    """Three disjoint 60/20/20 class splits over ONE shared image table
    (``raw_images``: an NHWC raw-image table of ``im_size``).
    Returns ``({"train", "val", "test"} -> ClassSet, table, ids)``."""
    if raw_images:
        cs, table, ids = synthetic_raw_image_set(
            num_classes=num_classes, images_per_class=images_per_class,
            im_size=im_size, channels=channels, text_dim=text_dim,
            seed=seed)
    else:
        cs, table, ids = synthetic_class_set(
            num_classes=num_classes, images_per_class=images_per_class,
            im_dim=im_dim, text_dim=text_dim, seed=seed, **kw)
    rng = np.random.RandomState(0)
    order = np.arange(num_classes)
    rng.shuffle(order)
    cuts = {"train": order[:int(0.6 * num_classes)],
            "val": order[int(0.6 * num_classes):int(0.8 * num_classes)],
            "test": order[int(0.8 * num_classes):]}
    splits = {}
    for name, idx in cuts.items():
        splits[name] = ClassSet(
            categories=cs.categories[idx],
            class_image_rows=cs.class_image_rows[idx],
            class_counts=cs.class_counts[idx],
            text_features=cs.text_features[idx],
            text_mask=(cs.text_mask[idx]
                       if cs.text_mask is not None else None),
            descriptions=[cs.descriptions[i] for i in idx],
        )
    return splits, table, ids
