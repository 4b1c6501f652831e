"""The cell's data, made on the device from the seed.

A configuration's ``data`` block fixes the table: ``rows`` image rows of
``row_shape`` in ``table_dtype`` over ``classes`` classes, the classes
split by ``split`` shares in order (train, val, test), and a class-text
table ``classes x text_dim``. Rows are dealt to classes in contiguous
blocks of ``rows // classes`` or one more, so every seed gets the same
layout and only the values change. The values come from one
``torch.Generator`` on the device, in one call per table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SPLITS = ("train", "val", "test")


class Tables(NamedTuple):
    image: torch.Tensor  # (rows, *row_shape), table_dtype, on the device
    text: torch.Tensor  # (classes, text_dim) fp32, on the device
    bounds: np.ndarray  # (classes + 1,) int64: class c holds rows [b[c], b[c+1])
    split_classes: dict  # split name -> np.ndarray of class ids

    def row_class(self) -> np.ndarray:
        """(rows,) the class of every row."""
        counts = np.diff(self.bounds)
        return np.repeat(np.arange(len(counts)), counts)


def class_bounds(rows: int, classes: int) -> np.ndarray:
    """Row bounds of ``classes`` contiguous blocks of ``rows // classes``
    or one more (the first ``rows % classes`` classes hold one more)."""
    counts = np.full(classes, rows // classes, np.int64)
    counts[:rows % classes] += 1
    return np.concatenate([[0], np.cumsum(counts)])


def split_classes(classes: int, shares) -> dict:
    """Class ids of each split, in order: the first ``int(shares[0] *
    classes)`` train, the next ``int((shares[0] + shares[1]) * classes)``
    val, the rest test (the reference's 60/20/20 rule)."""
    a = int(shares[0] * classes)
    b = int((shares[0] + shares[1]) * classes)
    ids = np.arange(classes)
    return {"train": ids[:a], "val": ids[a:b], "test": ids[b:]}


def make_tables(data: dict, seed: int, device) -> Tables:
    """The configuration's tables from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shape = (int(data["rows"]),) + tuple(int(s) for s in data["row_shape"])
    kind = data["table_values"]
    if kind == "uniform01":
        image = torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float32)
    elif kind == "uniform_uint8":
        image = torch.randint(0, 256, shape, generator=gen, device=device,
                              dtype=torch.uint8)
    else:
        raise ValueError(f"unknown table_values {kind!r}")
    text = torch.randn((int(data["classes"]), int(data["text_dim"])),
                       generator=gen, device=device, dtype=torch.float32)
    return Tables(image=image, text=text,
                  bounds=class_bounds(shape[0], int(data["classes"])),
                  split_classes=split_classes(int(data["classes"]),
                                              data["split"]))


def widen(rows: torch.Tensor) -> torch.Tensor:
    """Table rows as the model reads them: fp32; uint8 pixels times 1/255
    rounded to fp32, one rounded product (the JAX package's
    ``pixels_to_float``, so the widened rows compare exactly)."""
    if rows.dtype == torch.uint8:
        return rows.to(torch.float32) * (1.0 / 255.0)
    return rows.to(torch.float32)
