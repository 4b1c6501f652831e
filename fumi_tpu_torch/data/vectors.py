"""Pretrained word-vector artifacts for the glove / w2v / RNN text encoders.

A copy of ``fumi_tpu/data/vectors.py``, which is numpy and host code: the
port keeps its own because importing anything under ``fumi_tpu`` pulls in
JAX. ``tests/test_torch_data.py`` holds the copy equal to the original.

The reference's word encoders load pretrained gensim vector sets at model
construction — ``glove-wiki-gigaword-300`` for ``glove``/``RNN``/``RNNhid``
and ``word2vec-google-news-300`` for ``w2v`` (ref:
fumi/models/common.py:164-196, fumi/models/am3.py:58-66,
fumi/models/fumi.py:54-62). Those are network downloads, so a LOCAL vector
file is ingested once, offline, into a compact ``.npz`` artifact filtered
to the dataset vocabulary:

    python -m fumi_tpu_torch.data.prepare vectors \
        --src /path/to/glove.840B.300d.txt --kind glove --data_dir ./data

At train time the driver attaches the artifact to the token dictionary
(:class:`Vocabulary`) and the encoder factory builds the embedding matrix
with the reference's exact OOV/PAD semantics (known words → pretrained
vector; OOV → uniform(−1,1); PAD row zeroed — ref: common.py:180-194,
``fumi_tpu_torch.models.text_encoders.embedding_weights``).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Set

import numpy as np

from fumi_tpu_torch.data.inat_anim import DESCRIPTION_KEYS, dataset_root

# encoder kind -> vector set tag. RNN/RNNhid use glove vectors in the
# reference (am3.py:63, fumi.py:59); only ``w2v`` uses word2vec.
KIND_FOR_ENCODER = {"glove": "glove", "w2v": "w2v",
                    "RNN": "glove", "RNNhid": "glove"}


class Vocabulary(dict):
    """token2id mapping that also carries optional pretrained vectors.

    A plain ``dict`` subclass so it flows through every existing
    ``dictionary`` parameter unchanged; ``.vectors`` (word -> np vector)
    rides along for the encoder factory.
    """

    def __init__(self, token2id: Mapping[str, int],
                 vectors: Optional[Mapping[str, np.ndarray]] = None):
        super().__init__(token2id)
        self.vectors = vectors


def artifact_path(data_dir: str, kind: str) -> str:
    """Artifact location next to the dataset (like the BERT artifact)."""
    return os.path.join(data_dir, f"word_vectors_{kind}.npz")


def parse_vector_file(path: str,
                      keep: Optional[Set[str]] = None
                      ) -> Dict[str, np.ndarray]:
    """Parse a GloVe-text or word2vec-text vector file.

    - word2vec text format: first line is a ``<count> <dim>`` header
      (ref vector set: word2vec-google-news-300, common.py:171).
    - GloVe text format: no header, each line ``word v1 ... vD``
      (ref vector set: glove-wiki-gigaword-300, common.py:168).

    ``keep`` filters to a word set (the dataset vocabulary) so the
    artifact stays small. Malformed lines are skipped.
    """
    out: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline()
        parts = first.rstrip("\n").split(" ")
        is_w2v_header = len(parts) == 2 and all(
            p.isdigit() for p in parts)
        if not is_w2v_header:
            _ingest_line(first, out, keep)
        for line in f:
            _ingest_line(line, out, keep)
    return out


def _ingest_line(line: str, out: Dict[str, np.ndarray],
                 keep: Optional[Set[str]]) -> None:
    parts = line.rstrip("\n").split(" ")
    if len(parts) < 3:
        return
    word = parts[0]
    if keep is not None and word not in keep:
        return
    try:
        out[word] = np.asarray(parts[1:], dtype=np.float32)
    except ValueError:
        return


def dataset_word_set(data_dir: str,
                     json_name: str = "inat_anim.json") -> Set[str]:
    """Every token any config could need: all categories × all text fields,
    lowercased, WITHOUT stop-word filtering (filtering only removes words,
    so this superset covers every --text_type/--remove_stop_words combo)."""
    import json

    from fumi_tpu_torch.data import vocab

    root = dataset_root(data_dir)
    with open(os.path.join(root, json_name)) as f:
        annotations = json.load(f)
    words: Set[str] = set()
    for cat in annotations["categories"]:
        for key in DESCRIPTION_KEYS.values():
            words.update(vocab.tokenize(str(cat.get(key, "")).lower()))
    return words


def build_vectors_artifact(src: str, kind: str, data_dir: str,
                           json_name: str = "inat_anim.json",
                           filter_to_dataset: bool = True) -> str:
    """Ingest a local vector file into ``word_vectors_<kind>.npz``."""
    if kind not in ("glove", "w2v"):
        raise ValueError(f"kind must be glove or w2v, got {kind!r}")
    keep = None
    if filter_to_dataset:
        keep = dataset_word_set(data_dir, json_name)
    vecs = parse_vector_file(src, keep)
    if not vecs:
        raise ValueError(
            f"no vectors parsed from {src} (wrong format, or none of its "
            "words appear in the dataset vocabulary)")
    path = artifact_path(dataset_root(data_dir), kind)
    words = np.asarray(list(vecs.keys()))
    matrix = np.stack([vecs[w] for w in words]).astype(np.float32)
    np.savez_compressed(path, words=words, vectors=matrix)
    return path


def load_vectors_artifact(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path, allow_pickle=False)
    words, matrix = data["words"], data["vectors"]
    return {str(w): matrix[i] for i, w in enumerate(words)}


def vectors_for_encoder(text_encoder: str, data_dir: str,
                        required: bool = True
                        ) -> Optional[Dict[str, np.ndarray]]:
    """Load the vector artifact a word encoder needs, or raise an
    actionable error (mirrors the BERT-artifact error,
    fumi_tpu_torch/data/inat_anim.py)."""
    kind = KIND_FOR_ENCODER.get(text_encoder)
    if kind is None:
        return None
    path = artifact_path(dataset_root(data_dir), kind)
    if not os.path.exists(path):
        if not required:
            return None
        tag = ("glove-wiki-gigaword-300" if kind == "glove"
               else "word2vec-google-news-300")
        raise RuntimeError(
            f"--text_encoder {text_encoder} needs pretrained {kind} "
            f"vectors but no artifact exists at {path}. Ingest a local "
            f"copy of {tag} (text format) once:\n"
            f"  python -m fumi_tpu_torch.data.prepare vectors --src "
            f"/path/to/{kind}.txt --kind {kind} --data_dir {data_dir}")
    return load_vectors_artifact(path)
