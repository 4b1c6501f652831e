"""Offline data-preparation CLI: ``python -m fumi_tpu_torch.data.prepare``.

A copy of ``fumi_tpu/data/prepare.py``'s subcommands over the port's own
data modules (``tests/test_torch_data.py`` holds each subcommand's exit
code and outputs equal to the original's). The reference recomputes
frozen-encoder text embeddings at every dataset construction (BERT
mean-pool in batches of 64, ref: fumi/dataset/data.py:472-495); this
module runs heavyweight frozen encoders OFFLINE once and writes artifacts.

Usage:
  # cache BERT text embeddings for all categories (needs local HF weights)
  python -m fumi_tpu_torch.data.prepare bert --data_dir ./data \
      --text_type description [--remove_stop_words]

  # ingest local pretrained word vectors (GloVe/word2vec text format)
  python -m fumi_tpu_torch.data.prepare vectors --src /path/to/glove.txt \
      --kind glove --data_dir ./data

  # convert a raw CUB_200_2011 release (needs PIL)
  python -m fumi_tpu_torch.data.prepare cub --raw_dir /path/to/CUB_200_2011 \
      --data_dir ./data

  # inspect a dataset directory (splits, class sizes, artifact status)
  python -m fumi_tpu_torch.data.prepare inspect --data_dir ./data

  # validate the artifact CONTRACT before a first real-data run
  # (schema/keys/geometry/id-alignment/split fingerprint; exit 0 = pass)
  python -m fumi_tpu_torch.data.prepare verify --data_dir ./data
"""

from __future__ import annotations

import argparse
import os
import sys


def cmd_bert(args) -> int:
    from fumi_tpu_torch.data.inat_anim import build_bert_artifact
    path = build_bert_artifact(args.data_dir,
                               text_type=tuple(args.text_type),
                               remove_stop_words=args.remove_stop_words)
    print(f"wrote {path}")
    return 0


def cmd_vectors(args) -> int:
    from fumi_tpu_torch.data.vectors import build_vectors_artifact
    path = build_vectors_artifact(
        args.src, args.kind, args.data_dir, json_name=args.json_name,
        filter_to_dataset=not args.no_filter)
    import numpy as np
    n = len(np.load(path)["words"])
    print(f"wrote {path} ({n} words)")
    return 0


def cmd_cub(args) -> int:
    from fumi_tpu_torch.data.cub import convert_cub
    out = convert_cub(args.raw_dir, args.data_dir,
                      image_size=args.image_size,
                      split_lists=args.splits)
    print(f"wrote CUB artifacts under {out}")
    return 0


def cmd_inspect(args) -> int:
    import json

    import numpy as np

    from fumi_tpu_torch.data.inat_anim import (category_image_map,
                                               dataset_root,
                                               split_categories)
    root = dataset_root(args.data_dir)
    json_path = os.path.join(root, "inat_anim.json")
    if not os.path.exists(json_path):
        print(f"no inat_anim.json under {root}")
        return 1
    with open(json_path) as f:
        ann = json.load(f)
    n_cat = len(ann["categories"])
    n_img = len(ann["images"])
    print(f"categories: {n_cat}, images: {n_img}")
    for split in ("train", "val", "test"):
        cats = split_categories(n_cat, split)
        cmap = category_image_map(ann, cats)
        counts = np.array([len(v) for v in cmap.values()])
        print(f"  {split}: {len(cats)} classes, images/class "
              f"min={counts.min()} median={int(np.median(counts))} "
              f"max={counts.max()}")
    for f in sorted(os.listdir(root)):
        if f.startswith("text_embeddings") or f.startswith(
                "image_embeddings") or f == "low-res-images.hdf5":
            print(f"  artifact: {f}")
    return 0


def cmd_verify(args) -> int:
    from fumi_tpu_torch.data.verify import verify_dataset
    rep = verify_dataset(args.data_dir)
    print(rep.render())
    return 1 if rep.failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="fumi_tpu_torch offline data prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bert", help="precompute BERT text embeddings")
    b.add_argument("--data_dir", type=str, default="./data")
    b.add_argument("--text_type", type=str, nargs="+",
                   default=["description"])
    b.add_argument("--remove_stop_words", action="store_true")
    b.set_defaults(fn=cmd_bert)

    v = sub.add_parser("vectors",
                       help="ingest pretrained word vectors (text format)")
    v.add_argument("--src", type=str, required=True,
                   help="local GloVe-text or word2vec-text vector file")
    v.add_argument("--kind", type=str, choices=("glove", "w2v"),
                   required=True)
    v.add_argument("--data_dir", type=str, default="./data")
    v.add_argument("--json_name", type=str, default="inat_anim.json")
    v.add_argument("--no_filter", action="store_true",
                   help="keep ALL words (skip dataset-vocabulary filtering)")
    v.set_defaults(fn=cmd_vectors)

    c = sub.add_parser("cub",
                       help="convert a raw CUB_200_2011 dir to artifacts")
    c.add_argument("--raw_dir", type=str, required=True,
                   help="path to the extracted CUB_200_2011 release")
    c.add_argument("--data_dir", type=str, default="./data")
    c.add_argument("--image_size", type=int, default=84)
    c.add_argument("--splits", type=str, default=None,
                   help="directory with torchmeta's train/val/test.json "
                        "class lists (exact Hilliard split identity); "
                        "default: torchmeta's own assets if installed, "
                        "else 100/50/50 proportions over classes.txt")
    c.set_defaults(fn=cmd_cub)

    i = sub.add_parser("inspect", help="inspect dataset dir")
    i.add_argument("--data_dir", type=str, default="./data")
    i.set_defaults(fn=cmd_inspect)

    vf = sub.add_parser(
        "verify",
        help="validate the dataset artifact contract (schema, hdf5 keys, "
             "id↔row alignment, geometry, split fingerprint); exit 0 iff "
             "every check passes")
    vf.add_argument("--data_dir", type=str, default="./data")
    vf.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
