"""iNat-Anim dataset pipeline (host side).

A copy of ``fumi_tpu/data/inat_anim.py``, which is numpy and host code:
the port keeps its own because importing anything under ``fumi_tpu``
pulls in JAX. ``tests/test_torch_data.py`` holds the copy equal to the
original on the same files. It re-implements the reference's data layer
(ref: fumi/dataset/data.py) as a flat, table-producing pipeline:

- ``inat_anim.json`` annotations parsing (ref: data.py:373-375);
- the meta-split policy: ``np.random.seed(0)`` then a shuffled
  ``np.arange(N)`` sliced 60/20/20 train/val/test (ref: data.py:320-322,
  377-386). The reference calls ``np.sort`` and DISCARDS the result
  (ref: data.py:393), so categories stay in shuffled order — reproduced
  here for split-identity parity;
- image-id → category maps (ref: data.py:395-414);
- class description composition from the ``description``/``name``/
  ``common_name`` keys concatenated in ``--text_type`` order
  (ref: data.py:497-512);
- optional stop-word removal (ref: data.py:433-439);
- tokenisation: BERT (transformers tokenizer) or standard gensim-style with
  ``<PAD>`` padding and a dictionary over ALL folds (ref: data.py:441-469);
- BERT text-embedding precompute: mean-pooled last_hidden_state
  (ref: data.py:472-495), run OFFLINE once and cached as an `.npy` artifact
  next to the dataset, so the frozen encoder stays out of training.

The HDF5 image-embedding table is keyed by global image id
(ref: data.py:429-430,545), loaded once; splits only carry index tables.
:func:`load_inat_anim` is two parts in turn: :func:`read_image_table`,
the HDF5 read (``h5py`` is imported in :func:`_hdf5_images` and nowhere
else in this module), and :func:`inat_anim_from_annotations`, which builds
the splits from the parsed annotations and any numpy table. ``h5py`` and
``transformers`` are imported only inside the functions that need them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fumi_tpu_torch.data import vocab
from fumi_tpu_torch.data.class_set import ClassSet, build_class_tables

DESCRIPTION_KEYS = {
    "description": "description",
    "label": "name",
    "common_name": "common_name",
}
SPLITS = ("train", "val", "test")


def dataset_root(data_dir: str) -> str:
    """Resolve a --data_dir that either IS the dataset dir or contains an
    ``iNat-Anim/`` subdirectory (both layouts appear in the wild)."""
    nested = os.path.join(data_dir, "iNat-Anim")
    return nested if os.path.isdir(nested) else data_dir


def split_categories(num_categories: int, split: str,
                     seed: int = 0) -> np.ndarray:
    """The reference's category split (ref: data.py:377-393).

    Seeded shuffle of ``arange(N)``, sliced 60/20/20. The result is NOT
    sorted (the reference's ``np.sort`` return value is discarded)."""
    rng = np.random.RandomState(seed)
    cats = np.arange(num_categories)
    rng.shuffle(cats)
    n = num_categories
    if split == "train":
        return cats[:int(0.6 * n)]
    if split == "val":
        return cats[int(0.6 * n):int(0.8 * n)]
    if split == "test":
        return cats[int(0.8 * n):]
    raise ValueError(f"unknown split {split!r}")


def compose_descriptions(annotations: dict, categories: np.ndarray,
                         text_type: Sequence[str]) -> List[str]:
    """Concatenate the selected text fields per category
    (ref: data.py:497-512)."""
    keys = [DESCRIPTION_KEYS[t] for t in text_type]
    return [" ".join(annotations["categories"][int(i)][k] for k in keys)
            for i in categories]


def category_image_map(annotations: dict,
                       categories: np.ndarray) -> Dict[int, List[int]]:
    """category id -> list of image ids, in annotation order
    (ref: data.py:395-414)."""
    cat_set = set(int(c) for c in categories)
    out: Dict[int, List[int]] = {int(c): [] for c in categories}
    for img in annotations["images"]:
        img_id = img["id"]
        cat = annotations["annotations"][img_id]["category_id"]
        if cat in cat_set:
            out[cat].append(img_id)
    return out


@dataclasses.dataclass
class InatAnimData:
    """All three meta-splits + the shared image table."""
    splits: Dict[str, ClassSet]
    image_table: np.ndarray  # (num_images, D) keyed by image id
    image_ids: np.ndarray  # (num_images,) == arange
    dictionary: Optional[vocab.Dictionary]  # token2id for word encoders


def _bert_artifact_path(data_dir: str, text_type: Sequence[str],
                        remove_stop: bool) -> str:
    tag = "-".join(text_type) + ("-nostop" if remove_stop else "")
    return os.path.join(data_dir, f"text_embeddings_bert_{tag}.npy")


def precompute_bert_embeddings(descriptions: List[str],
                               batch_size: int = 64) -> np.ndarray:
    """Mean-pooled bert-base-uncased last_hidden_state (ref: data.py:472-495).

    Requires locally cached HF weights; runs on the CPU once, offline.
    """
    import torch
    from transformers import BertModel, BertTokenizer

    tokenizer = BertTokenizer.from_pretrained("bert-base-uncased")
    model = BertModel.from_pretrained("bert-base-uncased")
    model.eval()
    toks = tokenizer(descriptions, return_token_type_ids=False,
                     return_tensors="pt", padding=True, truncation=True)
    out = np.zeros((len(descriptions), model.config.hidden_size),
                   dtype=np.float32)
    with torch.no_grad():
        for s in range(0, len(descriptions), batch_size):
            e = min(len(descriptions), s + batch_size)
            h = model(input_ids=toks["input_ids"][s:e],
                      attention_mask=toks["attention_mask"][s:e]
                      ).last_hidden_state
            out[s:e] = torch.mean(h, dim=1).numpy()
    return out


def bert_tokenize(descriptions: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """BERT token ids + attention mask (ref: data.py:441-449)."""
    from transformers import BertTokenizer
    tokenizer = BertTokenizer.from_pretrained("bert-base-uncased")
    toks = tokenizer(descriptions, return_token_type_ids=False,
                     padding=True, truncation=True)
    return (np.asarray(toks["input_ids"], dtype=np.int32),
            np.asarray(toks["attention_mask"], dtype=np.int32))


RAW_IMAGES_FILE = "low-res-images.hdf5"


def _hdf5_images(path: str, dtype=None) -> np.ndarray:
    """The ``images`` dataset of an HDF5 file as one numpy array (in
    ``dtype`` when given, else its stored dtype)."""
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f["images"], dtype=dtype)


def load_raw_image_table(root: str,
                         file_name: str = RAW_IMAGES_FILE) -> np.ndarray:
    """The Zenodo raw-image table (``low-res-images.hdf5``, key
    ``images``, row index = image id — the same ordering as the
    embeddings file; see notebooks/DatasetDemo.ipynb in the reference,
    which browses ``h5_file['images'][image_index]``).

    Kept in its stored integer dtype (uint8 NHWC): the sampler gathers
    raw rows on the device and widens them to fp32 [0, 1] at gather time
    (``data/sampler.py``), so the table costs a quarter of fp32. Grayscale
    ``(M, H, W)`` tables gain a trailing channel axis.
    """
    path = os.path.join(root, file_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"raw-image mode (--im_encoder conv4|resnet12) needs {path} — "
            "the Zenodo artifact the reference's dataset notebook "
            "downloads (record 6703088, low-res-images.hdf5)")
    table = _hdf5_images(path)
    if table.ndim == 3:
        table = table[..., None]
    if table.ndim != 4:
        raise ValueError(
            f"{path}: expected (num_images, H, W[, C]) images, got shape "
            f"{table.shape}")
    return table


def read_image_table(root: str, image_embedding_model: str = "resnet-152",
                     image_dtype=np.float32) -> np.ndarray:
    """The image-embedding table ``image_embeddings_<model>.hdf5`` of a
    dataset root (ref: data.py:420-430), row index = image id."""
    return _hdf5_images(os.path.join(
        root, f"image_embeddings_{image_embedding_model}.hdf5"), image_dtype)


def inat_anim_from_annotations(annotations: dict, image_table,
                               data_dir: str,
                               text_encoder: str = "BERT",
                               text_type: Sequence[str] = ("description",),
                               remove_stop_words: bool = False
                               ) -> InatAnimData:
    """Build all three splits from parsed ``inat_anim.json`` annotations
    and an image table keyed by image id. ``data_dir`` is where the BERT
    artifact is looked up (its :func:`dataset_root`)."""
    root = dataset_root(data_dir)
    num_categories = len(annotations["categories"])
    image_ids = np.arange(image_table.shape[0], dtype=np.int32)

    # dictionary over ALL folds for standard tokenisation
    # (ref: data.py:461-466)
    dictionary = None
    if text_encoder not in ("BERT", "precomputed"):
        all_desc = compose_descriptions(annotations,
                                        np.arange(num_categories), text_type)
        if remove_stop_words:
            all_desc = [vocab.remove_stop_words(d) for d in all_desc]
        dictionary = vocab.Dictionary(
            [vocab.tokenize(d.lower()) for d in all_desc])
        dictionary.add_document([vocab.PAD_WORD])

    splits: Dict[str, ClassSet] = {}
    for split in SPLITS:
        cats = split_categories(num_categories, split)
        cat_map = category_image_map(annotations, cats)
        rows, counts = build_class_tables(cats, cat_map)
        desc = compose_descriptions(annotations, cats, text_type)
        if remove_stop_words:
            desc = [vocab.remove_stop_words(d) for d in desc]

        text_mask = None
        if text_encoder in ("BERT", "precomputed"):
            # offline-precomputed text embeddings artifact
            art = _bert_artifact_path(root, text_type, remove_stop_words)
            if os.path.exists(art):
                all_emb = np.load(art)
                text = all_emb[cats]
            else:
                try:
                    text = precompute_bert_embeddings(desc)
                except Exception as e:
                    raise RuntimeError(
                        f"BERT text embeddings unavailable: no artifact at "
                        f"{art} and live precompute failed ({e}). Run "
                        "`python -m fumi_tpu_torch.data.prepare bert "
                        f"--data_dir {data_dir}` once (requires locally "
                        "cached bert-base-uncased weights), or ship the "
                        "artifact with the dataset.") from e
        else:
            text, text_mask = vocab.encode_padded(desc, dictionary)

        splits[split] = ClassSet(
            categories=cats,
            class_image_rows=rows,
            class_counts=counts,
            text_features=text,
            text_mask=text_mask,
            descriptions=desc,
        )
    return InatAnimData(splits=splits, image_table=image_table,
                        image_ids=image_ids, dictionary=dictionary)


def load_inat_anim(data_dir: str,
                   json_name: str = "inat_anim.json",
                   text_encoder: str = "BERT",
                   text_type: Sequence[str] = ("description",),
                   remove_stop_words: bool = False,
                   image_embedding_model: str = "resnet-152",
                   image_dtype=np.float32,
                   raw_images: bool = False) -> InatAnimData:
    """Build all three splits. One pass; returns dense tables.

    ``raw_images=True`` loads the raw low-res image table instead of the
    precomputed-embedding table, for the raw-image backbones
    (``--im_encoder conv4|resnet12``)."""
    root = dataset_root(data_dir)
    with open(os.path.join(root, json_name)) as f:
        annotations = json.load(f)
    if raw_images:
        image_table = load_raw_image_table(root)
    else:
        image_table = read_image_table(root, image_embedding_model,
                                       image_dtype)
    return inat_anim_from_annotations(annotations, image_table, data_dir,
                                      text_encoder, text_type,
                                      remove_stop_words)


def build_bert_artifact(data_dir: str,
                        json_name: str = "inat_anim.json",
                        text_type: Sequence[str] = ("description",),
                        remove_stop_words: bool = False) -> str:
    """Offline step: precompute + cache BERT text embeddings for ALL
    categories. Returns the artifact path."""
    root = dataset_root(data_dir)
    with open(os.path.join(root, json_name)) as f:
        annotations = json.load(f)
    cats = np.arange(len(annotations["categories"]))
    desc = compose_descriptions(annotations, cats, text_type)
    if remove_stop_words:
        desc = [vocab.remove_stop_words(d) for d in desc]
    emb = precompute_bert_embeddings(desc)
    path = _bert_artifact_path(root, text_type, remove_stop_words)
    np.save(path, emb)
    return path
