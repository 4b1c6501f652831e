"""CUB dataset support (text-less stub, matching the reference's scope).

A copy of ``fumi_tpu/data/cub.py``, which is numpy and host code: the port
keeps its own because importing anything under ``fumi_tpu`` pulls in JAX.
``tests/test_torch_data.py`` holds the copy equal to the original.
``PIL`` is imported only inside :func:`convert_cub`.

The reference wires torchmeta's CUB helper with an empty dictionary and no
text features ("Need to fix to get text as well", ref:
fumi/dataset/data.py:191-217). This loader consumes a pre-converted
artifact directory:

    <data_dir>/CUB/
      image_embeddings.npy   (num_images, D) float32
      class_image_rows.npz   per-split padded class tables
        {train,val,test}_rows, {train,val,test}_counts,
        {train,val,test}_categories

Conversion from the raw CUB_200_2011 release is a one-off offline step
(images → frozen-encoder embeddings, ``python -m
fumi_tpu_torch.data.prepare cub``), mirroring how iNat-Anim ships
precomputed resnet embeddings. Text features are zeros (the reference's CUB
path is image-only too).

Documented deviation: the reference's CUB helper sizes val/test query sets
as ``int(100 / num_shots)`` (ref: data.py:204,211) — almost certainly a bug
(every other path uses ``int(100 / num_ways)``, ref: data.py:165,182). This
package applies the standard ``int(100 / num_ways)`` eval protocol to CUB
as well.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from fumi_tpu_torch.data.class_set import ClassSet


def load_cub(data_dir: str) -> Tuple[Dict[str, ClassSet], np.ndarray,
                                     np.ndarray]:
    """Load converted CUB tables. Returns (splits, image_table, image_ids)."""
    root = os.path.join(data_dir, "CUB")
    emb_path = os.path.join(root, "image_embeddings.npy")
    tab_path = os.path.join(root, "class_image_rows.npz")
    if not (os.path.exists(emb_path) and os.path.exists(tab_path)):
        raise FileNotFoundError(
            f"CUB artifacts not found under {root}. Run the offline "
            "conversion (images -> encoder embeddings -> "
            "image_embeddings.npy + class_image_rows.npz) first.")
    image_table = np.load(emb_path)
    tabs = np.load(tab_path)
    splits = {}
    for split in ("train", "val", "test"):
        rows = tabs[f"{split}_rows"]
        counts = tabs[f"{split}_counts"]
        cats = tabs[f"{split}_categories"]
        splits[split] = ClassSet(
            categories=cats,
            class_image_rows=rows.astype(np.int32),
            class_counts=counts.astype(np.int32),
            # image-only dataset: zero text features (ref CUB has none)
            text_features=np.zeros((len(cats), 1), dtype=np.float32),
            text_mask=None,
            descriptions=["" for _ in cats],
        )
    image_ids = np.arange(image_table.shape[0], dtype=np.int32)
    return splits, image_table, image_ids


# ---------------------------------------------------------------------------
# Offline conversion: raw CUB_200_2011 release -> artifacts for load_cub
# ---------------------------------------------------------------------------

# Meta-split policy. The reference wires torchmeta's CUB helper, whose
# 100/50/50 class membership comes from the Hilliard-et-al. lists shipped
# as torchmeta asset files (ref: fumi/dataset/data.py:191-217). Conversion
# therefore resolves the split from, in order:
#   1. an explicit ``split_lists`` directory holding train/val/test.json
#      (torchmeta's asset format: a JSON list of class directory names) —
#      byte-identical split membership to any torchmeta run;
#   2. an installed torchmeta package's own asset files;
#   3. the 100/50/50 PROPORTIONS over classes.txt order (the fallback when
#      neither is available — split membership then DIFFERS from
#      torchmeta's, so results are not comparable across the two; the
#      chosen source is recorded in the artifact as ``split_source``).
SPLIT_FRACTIONS = {"train": 0.5, "val": 0.25, "test": 0.25}


def _load_split_lists(split_lists, classes):
    """Resolve the class meta-split. Returns (split_classes dict keyed by
    split name with (class_id, class_name) lists, source string)."""
    import json

    name_to_pair = {name: (cid, name) for cid, name in classes}

    def from_dir(d, source):
        out = {}
        for split in ("train", "val", "test"):
            path = os.path.join(d, f"{split}.json")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"split-list directory {d} has no {split}.json "
                    "(expected torchmeta's cub asset format: a JSON list "
                    "of class directory names)")
            with open(path) as f:
                names = json.load(f)
            missing = [n for n in names if n not in name_to_pair]
            if missing:
                raise ValueError(
                    f"{path} names classes absent from classes.txt: "
                    f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
            out[split] = [name_to_pair[n] for n in names]
        all_ids = [cid for cls in out.values() for cid, _ in cls]
        if len(set(all_ids)) != len(all_ids):
            raise ValueError(f"split lists under {d} overlap")
        return out, source

    if split_lists is not None:
        return from_dir(split_lists, f"lists:{split_lists}")
    try:  # torchmeta installed: use its exact Hilliard asset files
        import torchmeta  # noqa: F401 — optional, never a hard dep
        assets = os.path.join(os.path.dirname(torchmeta.__file__),
                              "datasets", "assets", "cub")
        if os.path.isdir(assets):
            try:
                return from_dir(assets, "torchmeta-assets")
            except FileNotFoundError as e:
                # partial/pruned torchmeta install: the assets dir exists
                # but lacks a split file — that is "unavailable", so fall
                # through to the documented proportional fallback loudly
                # (a ValueError — overlap or classes absent from
                # classes.txt — still raises: torchmeta's real lists
                # disagreeing with the user's data is a data problem)
                print(f"cub: torchmeta assets incomplete ({e}); "
                      "falling back")
    except ImportError:
        pass
    n_cls = len(classes)
    n_train = int(SPLIT_FRACTIONS["train"] * n_cls)
    n_val = int(SPLIT_FRACTIONS["val"] * n_cls)
    print("cub: torchmeta split lists unavailable — using 100/50/50 "
          "proportions over classes.txt order (membership differs from "
          "torchmeta's; pass --splits <dir> with train/val/test.json "
          "for exact identity)")
    return {
        "train": classes[:n_train],
        "val": classes[n_train:n_train + n_val],
        "test": classes[n_train + n_val:],
    }, "proportional-classes.txt-order"


def _read_pairs(path: str):
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((int(parts[0]), parts[1]))
    return out


def pixels_embed_fn(images: "np.ndarray") -> "np.ndarray":
    """Trivial 'encoder': flattened resized pixels. Pairs with the conv4
    raw-image backbone (``--im_encoder conv4``, the reference's TODO at
    am3.py:44-46) or plain MLP heads on raw pixels."""
    return images.reshape(images.shape[0], -1).astype(np.float32)


def convert_cub(raw_dir: str, data_dir: str, embed_fn=None,
                image_size: int = 84, batch_size: int = 64,
                split_lists: str = None) -> str:
    """Convert a raw CUB_200_2011 directory into load_cub's artifacts.

    ``raw_dir`` must contain ``images.txt``, ``image_class_labels.txt``,
    ``classes.txt`` and the ``images/`` tree (the standard CUB release
    layout). ``embed_fn(images: (B, S, S, 3) float32 in [0,1]) -> (B, D)``
    is the frozen encoder — pluggable so tests/custom encoders can inject
    one; default is :func:`pixels_embed_fn` (raw pixels; mirrors how
    iNat-Anim ships precomputed resnet embeddings, which here would be an
    injected torchvision encoder). ``split_lists`` points at a
    directory with torchmeta's ``train/val/test.json`` class lists for
    exact Hilliard split identity (see ``_load_split_lists`` for the
    auto-resolution order; the chosen source is stored in the artifact).

    Returns the artifact directory ``<data_dir>/CUB``.
    """
    from PIL import Image

    if embed_fn is None:
        embed_fn = pixels_embed_fn

    images = _read_pairs(os.path.join(raw_dir, "images.txt"))
    labels = {i: int(c) for i, c in
              _read_pairs(os.path.join(raw_dir, "image_class_labels.txt"))}
    classes = _read_pairs(os.path.join(raw_dir, "classes.txt"))
    if not images or not classes:
        raise FileNotFoundError(
            f"{raw_dir} does not look like a CUB_200_2011 release "
            "(need images.txt / image_class_labels.txt / classes.txt)")

    # embed every image, row index = order in images.txt
    rows_per_class: Dict[int, list] = {cid: [] for cid, _ in classes}
    table_chunks = []
    batch = []
    for row, (img_id, rel) in enumerate(images):
        with Image.open(os.path.join(raw_dir, "images", rel)) as im:
            im = im.convert("RGB").resize((image_size, image_size),
                                          Image.BILINEAR)
            batch.append(np.asarray(im, dtype=np.float32) / 255.0)
        rows_per_class[labels[img_id]].append(row)
        if len(batch) == batch_size:
            table_chunks.append(embed_fn(np.stack(batch)))
            batch = []
    if batch:
        table_chunks.append(embed_fn(np.stack(batch)))
    image_table = np.concatenate(table_chunks, axis=0).astype(np.float32)

    split_classes, split_source = _load_split_lists(split_lists, classes)
    print(f"cub: split source = {split_source}")

    out_root = os.path.join(data_dir, "CUB")
    os.makedirs(out_root, exist_ok=True)
    arrays = {}
    for split, cls in split_classes.items():
        counts = np.array([len(rows_per_class[cid]) for cid, _ in cls],
                          dtype=np.int32)
        width = max(1, int(counts.max()) if len(counts) else 1)
        rows = np.zeros((len(cls), width), dtype=np.int32)
        for i, (cid, _) in enumerate(cls):
            r = rows_per_class[cid]
            rows[i, :len(r)] = r
        arrays[f"{split}_rows"] = rows
        arrays[f"{split}_counts"] = counts
        arrays[f"{split}_categories"] = np.array([cid for cid, _ in cls],
                                                 dtype=np.int32)
    arrays["split_source"] = np.array(split_source)  # provenance
    np.save(os.path.join(out_root, "image_embeddings.npy"), image_table)
    np.savez(os.path.join(out_root, "class_image_rows.npz"), **arrays)
    return out_root
