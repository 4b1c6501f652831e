"""``prepare verify``: the iNat-Anim artifact contract, checked up front.

A copy of ``fumi_tpu/data/verify.py``, which is numpy and host code: the
port keeps its own because importing anything under ``fumi_tpu`` pulls in
JAX. ``tests/test_torch_data.py`` holds its report equal to the
original's. ``h5py`` is imported only inside the checks that read HDF5.

First contact with the real Zenodo dataset should fail LOUDLY at load
time, not subtly at accuracy. This module validates the exact on-disk
layout the loaders assume — the same contract the reference's data layer
assumes silently (ref: fumi/dataset/data.py:373-430 json parsing + hdf5
tables; data.py:377-393 the seed-0 split) — and prints a one-page
pass/fail report:

- ``inat_anim.json`` schema: categories (positional id, the text keys
  every ``--text_type`` mode composes from), images, per-image-id
  annotations with in-range ``category_id``;
- image-id ↔ row alignment: the loaders key every table by IMAGE ID AS
  ROW INDEX (``inat_anim_from_annotations``'s ``np.arange``), so ids
  must be exactly 0..M−1 in order;
- ``image_embeddings_<model>.hdf5``: ``images`` key, 2-D float, one row
  per image id, the embedding width the CLI's arg validation pins
  (resnet-152→2048, resnet-34→512; ref main.py:41-44);
- ``low-res-images.hdf5`` (raw conv path): ``images`` key, uint8,
  (M, H, W[, C]), one row per image id, spatial extent surviving the
  backbones' four 2×2 pools;
- ``text_embeddings_bert_*.npy``: one row per CATEGORY, finite f32;
- class geometry: every split class must hold ≥ K + int(100/N) images
  for the eval ClassSplitter (ref data.py:165,182) — reported for the
  flagship 5-way 5-shot protocol;
- split reproducibility: the seed-0 60/20/20 category split is
  recomputed and fingerprinted (sha256 over the concatenated index
  bytes) so two machines can compare one hash line.

Exit code 0 iff no FAIL. WARNs flag legal-but-suspect layouts.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np

# embedding widths the CLI validates against (core/config.py:validate,
# mirroring ref main.py:41-44)
EMBED_DIMS = {"resnet-152": 2048, "resnet-34": 512}
TEXT_KEYS = ("description", "name", "common_name")
FLAGSHIP_N, FLAGSHIP_K = 5, 5  # the protocol the report sizes against


class Report:
    def __init__(self):
        self.rows: List[Tuple[str, str, str]] = []

    def add(self, status: str, name: str, detail: str = ""):
        self.rows.append((status, name, detail))

    ok = lambda self, name, detail="": self.add("PASS", name, detail)
    warn = lambda self, name, detail="": self.add("WARN", name, detail)
    fail = lambda self, name, detail="": self.add("FAIL", name, detail)

    @property
    def failed(self) -> bool:
        return any(s == "FAIL" for s, _, _ in self.rows)

    def render(self) -> str:
        out = []
        for s, n, d in self.rows:
            out.append(f"  [{s}] {n}" + (f" — {d}" if d else ""))
        n_fail = sum(1 for s, _, _ in self.rows if s == "FAIL")
        n_warn = sum(1 for s, _, _ in self.rows if s == "WARN")
        out.append(
            f"verify: {'FAIL' if n_fail else 'PASS'} "
            f"({len(self.rows)} checks, {n_fail} failed, {n_warn} warnings)")
        return "\n".join(out)


def _check_json(root: str, rep: Report) -> Optional[dict]:
    path = os.path.join(root, "inat_anim.json")
    if not os.path.exists(path):
        rep.fail("inat_anim.json", f"missing: {path}")
        return None
    try:
        with open(path) as f:
            ann = json.load(f)
    except Exception as e:
        rep.fail("inat_anim.json", f"unparseable: {e}")
        return None
    missing = [k for k in ("categories", "images", "annotations")
               if k not in ann]
    if missing:
        rep.fail("inat_anim.json", f"missing top-level keys: {missing}")
        return None
    rep.ok("inat_anim.json",
           f"{len(ann['categories'])} categories, "
           f"{len(ann['images'])} images")

    # categories are indexed POSITIONALLY everywhere the loaders (and
    # the reference) compose text — position must equal id
    bad_pos = [i for i, c in enumerate(ann["categories"])
               if c.get("id") != i]
    if bad_pos:
        rep.fail("category ids positional",
                 f"categories[{bad_pos[0]}]['id'] != {bad_pos[0]} "
                 f"(+{len(bad_pos) - 1} more) — text composition and "
                 "split indexing key categories by POSITION")
    else:
        rep.ok("category ids positional", "categories[i]['id'] == i")
    no_text = [i for i, c in enumerate(ann["categories"])
               if not all(k in c for k in TEXT_KEYS)]
    if no_text:
        rep.fail("category text keys",
                 f"{len(no_text)} categories missing one of {TEXT_KEYS} "
                 f"(first: id {no_text[0]}) — every --text_type needs its "
                 "key")
    else:
        rep.ok("category text keys", f"all of {TEXT_KEYS} present")

    # image ids ARE row indices (inat_anim.py): exactly 0..M-1
    ids = [img.get("id") for img in ann["images"]]
    M = len(ids)
    if ids != list(range(M)):
        rep.fail("image ids are row indices",
                 "images[i]['id'] != i somewhere — every table "
                 "(embeddings, raw pixels) is keyed by image id AS ROW "
                 "INDEX; a permuted or sparse id space silently gathers "
                 "the wrong rows")
    else:
        rep.ok("image ids are row indices", f"ids == arange({M})")

    # per-image-id annotations with in-range category_id
    C = len(ann["categories"])
    anns = ann["annotations"]
    if len(anns) < M:
        rep.fail("annotations per image id",
                 f"{len(anns)} annotations < {M} images — "
                 "annotations[img_id] lookup would be out of range")
    else:
        if isinstance(anns, dict):
            # json round-trips dict keys as strings; the loaders index
            # with INT image ids — a dict layout would KeyError at load
            rep.fail("annotations layout",
                     "annotations is a dict; loaders index "
                     "annotations[image_id] with int ids (list layout)")
        else:
            bad = [i for i in range(M)
                   if not (0 <= anns[i].get("category_id", -1) < C)]
            if bad:
                rep.fail("annotation category ids",
                         f"{len(bad)} images with category_id outside "
                         f"[0, {C}) (first: image {bad[0]})")
            else:
                rep.ok("annotation category ids", f"all in [0, {C})")
    return ann


def _check_embeddings(root: str, M: Optional[int], rep: Report) -> None:
    import h5py
    found = [m for m in EMBED_DIMS
             if os.path.exists(os.path.join(
                 root, f"image_embeddings_{m}.hdf5"))]
    if not found:
        rep.warn("image embedding tables",
                 "no image_embeddings_*.hdf5 — only the raw-image "
                 "(--im_encoder conv4|resnet12) path can run")
        return
    for model in found:
        name = f"image_embeddings_{model}.hdf5"
        path = os.path.join(root, name)
        try:
            with h5py.File(path, "r") as f:
                if "images" not in f:
                    rep.fail(name, f"no 'images' key (has {list(f)})")
                    continue
                shape, dtype = f["images"].shape, f["images"].dtype
        except Exception as e:
            rep.fail(name, f"unreadable: {e}")
            continue
        if len(shape) != 2:
            rep.fail(name, f"expected (num_images, D), got {shape}")
            continue
        if M is not None and shape[0] != M:
            rep.fail(name, f"{shape[0]} rows != {M} image ids — the "
                     "row↔id keying is broken")
            continue
        if shape[1] != EMBED_DIMS[model]:
            rep.fail(name, f"width {shape[1]} != {EMBED_DIMS[model]} "
                     f"(the dim the CLI pins for {model})")
            continue
        if not np.issubdtype(dtype, np.floating):
            rep.warn(name, f"dtype {dtype} (loaders cast to f32)")
        rep.ok(name, f"shape {tuple(shape)}, dtype {dtype}")


def _check_raw(root: str, M: Optional[int], rep: Report) -> None:
    import h5py
    path = os.path.join(root, "low-res-images.hdf5")
    if not os.path.exists(path):
        rep.warn("low-res-images.hdf5",
                 "absent — raw conv4/resnet12 training unavailable "
                 "(Zenodo record 6703088 ships it)")
        return
    try:
        with h5py.File(path, "r") as f:
            if "images" not in f:
                rep.fail("low-res-images.hdf5",
                         f"no 'images' key (has {list(f)})")
                return
            shape, dtype = f["images"].shape, f["images"].dtype
    except Exception as e:
        rep.fail("low-res-images.hdf5", f"unreadable: {e}")
        return
    if len(shape) not in (3, 4):
        rep.fail("low-res-images.hdf5",
                 f"expected (M, H, W[, C]), got {shape}")
        return
    if M is not None and shape[0] != M:
        rep.fail("low-res-images.hdf5",
                 f"{shape[0]} rows != {M} image ids")
        return
    if dtype != np.uint8:
        rep.warn("low-res-images.hdf5",
                 f"dtype {dtype}, expected uint8 (pixels_to_float "
                 "normalizes uint8 by /255; other dtypes pass through)")
    h, w = shape[1], shape[2]
    if min(h, w) < 16:
        rep.fail("raw image geometry",
                 f"{h}x{w} collapses to zero extent before the "
                 "backbones' four 2x2 pools (need >= 16)")
    else:
        rep.ok("low-res-images.hdf5",
               f"shape {tuple(shape)}, dtype {dtype}")


def _check_text_artifacts(root: str, C: Optional[int], rep: Report) -> None:
    import glob
    hits = sorted(glob.glob(os.path.join(root, "text_embeddings_bert_*.npy")))
    if not hits:
        rep.warn("BERT text artifacts",
                 "none found — the BERT path will try a live precompute "
                 "(needs cached HF weights); run `prepare bert` offline "
                 "once")
        return
    for path in hits:
        name = os.path.basename(path)
        try:
            emb = np.load(path)
        except Exception as e:
            rep.fail(name, f"unreadable: {e}")
            continue
        if emb.ndim != 2:
            rep.fail(name, f"expected (num_categories, H), got {emb.shape}")
            continue
        if C is not None and emb.shape[0] != C:
            rep.fail(name, f"{emb.shape[0]} rows != {C} categories — "
                     "text features would be gathered for the wrong "
                     "classes")
            continue
        if not np.isfinite(emb).all():
            rep.fail(name, "non-finite values")
            continue
        detail = f"shape {emb.shape}, dtype {emb.dtype}"
        if emb.shape[1] != 768:
            detail += " (width != 768: fine if not bert-base, but " \
                      "--text_emb_dim must match)"
        rep.ok(name, detail)


def _check_splits(ann: dict, rep: Report) -> None:
    from fumi_tpu_torch.data.inat_anim import (category_image_map,
                                               split_categories)

    C = len(ann["categories"])
    # the smallest fold is 20% of C, so N-way episodes in every fold
    # need C >= 5N (C=20 splits 12/4/4 — val/test cannot host a 5-way
    # episode even though each fold is non-empty)
    if C < FLAGSHIP_N * 5:
        rep.warn("split geometry",
                 f"{C} categories — the 20% val/test folds hold "
                 f"{int(0.8 * C) - int(0.6 * C)}/{C - int(0.8 * C)} "
                 f"classes; {FLAGSHIP_N}-way episodes need >= "
                 f"{FLAGSHIP_N * 5} categories")
    parts, digest = {}, hashlib.sha256()
    for split in ("train", "val", "test"):
        cats = split_categories(C, split)
        parts[split] = cats
        digest.update(cats.astype(np.int64).tobytes())
    allcats = np.concatenate(list(parts.values()))
    if len(np.unique(allcats)) != C or len(allcats) != C:
        rep.fail("seed-0 split partition",
                 "splits overlap or drop categories")  # pragma: no cover
    else:
        sizes = "/".join(str(len(parts[s])) for s in ("train", "val",
                                                      "test"))
        rep.ok("seed-0 split partition",
               f"sizes {sizes}, fingerprint "
               f"{digest.hexdigest()[:16]} (compare across machines)")

    # per-class image counts vs the eval ClassSplitter's fixed query
    # size int(100/N) (ref data.py:165,182)
    need = FLAGSHIP_K + 100 // FLAGSHIP_N
    for split, cats in parts.items():
        cmap = category_image_map(ann, cats)
        counts = [len(cmap[int(c)]) for c in cats]
        if not counts:
            continue
        thin = sum(1 for c in counts if c < need)
        if min(counts) == 0:
            rep.fail(f"{split} class occupancy",
                     f"{sum(1 for c in counts if c == 0)} classes with "
                     "ZERO images")
        elif thin:
            rep.warn(f"{split} class occupancy",
                     f"{thin}/{len(counts)} classes hold < {need} images "
                     f"(K={FLAGSHIP_K} + int(100/{FLAGSHIP_N}) query) — "
                     "episode sampling will fail fast on them")
        else:
            rep.ok(f"{split} class occupancy",
                   f"min {min(counts)} images/class (need {need})")


def verify_dataset(data_dir: str) -> Report:
    """Run every check; returns the report (callers decide exit code).

    The split/occupancy checks INDEX the annotations the way the
    loaders do, so they only run when the json checks passed — on a
    malformed file they would crash with the very traceback this
    command exists to replace. A defensive catch turns any residual
    surprise into a FAIL row rather than a crash."""
    from fumi_tpu_torch.data.inat_anim import dataset_root
    root = dataset_root(data_dir)
    rep = Report()
    rep.add("INFO", "dataset root", root)
    json_fails_before = sum(1 for s, _, _ in rep.rows if s == "FAIL")
    ann = _check_json(root, rep)
    json_ok = ann is not None and not any(
        s == "FAIL" for s, _, _ in rep.rows[json_fails_before:])
    M = len(ann["images"]) if ann else None
    C = len(ann["categories"]) if ann else None
    _check_embeddings(root, M, rep)
    _check_raw(root, M, rep)
    _check_text_artifacts(root, C, rep)
    if ann and json_ok:
        try:
            _check_splits(ann, rep)
        except Exception as e:  # pragma: no cover — belt and braces
            rep.fail("split checks", f"crashed: {type(e).__name__}: {e}")
    elif ann:
        rep.add("SKIP", "split checks",
                "skipped: the json checks above failed, and the split "
                "walk indexes annotations the way the loaders do")
    return rep
