"""The port's host data code against the JAX package's, on the CPU, on the
same files (written here with h5py, numpy and PIL; nothing is downloaded).

- ``data/vocab.py``: tokenizer, stop words, ``Dictionary`` and
  ``encode_padded``, bitwise;
- ``data/inat_anim.py``: the seed-0 split, the class tables, text
  features, token ids and masks, descriptions (``text_type`` order, stop
  words) and dictionary ``token2id``, bitwise; its two parts (the HDF5
  read, the table building) give ``load_inat_anim``'s result; the BERT
  path without an artifact or cached weights raises naming ``python -m
  fumi_tpu_torch.data.prepare bert``;
- ``data/vectors.py``: both text formats, the word set and the
  artifact's bytes;
- ``data/cub.py``: ``load_cub`` and ``convert_cub`` with each split
  source (lists, torchmeta's assets, the proportional fallback), the
  artifacts bitwise;
- ``data/verify.py``: the report on a sound and on broken fixtures;
- ``data/prepare.py``: each subcommand's exit code and output.

The driver on these datasets is ``tests/test_torch_data_driver.py``.
"""

import dataclasses
import glob
import json
import os
import sys
import types

import h5py
import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from ref_oracle.dataset_gen import build  # noqa: E402

from fumi_tpu.data import cub as jax_cub  # noqa: E402
from fumi_tpu.data import inat_anim as jax_inat  # noqa: E402
from fumi_tpu.data import prepare as jax_prepare  # noqa: E402
from fumi_tpu.data import vectors as jax_vectors  # noqa: E402
from fumi_tpu.data import verify as jax_verify  # noqa: E402
from fumi_tpu.data import vocab as jax_vocab  # noqa: E402
from fumi_tpu_torch.data import (cub, inat_anim, prepare, vectors,  # noqa
                                 verify, vocab)

C, PER = 25, 24  # 15/5/5 classes; 24 images each


@pytest.fixture(scope="module")
def inat_dir(tmp_path_factory):
    """A reference-format iNat-Anim directory (resnet-34 width 512) with
    BERT artifacts of width 16 for two ``text_type``/stop-word tags and a
    glove artifact of 300-wide vectors over most of the vocabulary."""
    root = str(tmp_path_factory.mktemp("inat"))
    data_dir = build(root, num_classes=C, images_per_class=PER)
    rng = np.random.RandomState(0)
    for tag in ("description", "label-common_name-nostop"):
        np.save(os.path.join(data_dir, f"text_embeddings_bert_{tag}.npy"),
                rng.randn(C, 16).astype(np.float32))
    words = sorted(jax_vectors.dataset_word_set(data_dir))
    src = os.path.join(root, "glove.txt")
    with open(src, "w") as f:
        for w in words[:-3]:  # the last three stay out of vocabulary
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.randn(300))
                    + "\n")
    assert prepare.main(["vectors", "--src", src, "--kind", "glove",
                         "--data_dir", data_dir]) == 0
    return data_dir


def same_class_set(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "descriptions" or y is None:
            assert x == y, f.name
        else:
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


# ---------------------------------------------------------------------------
# vocab and the iNat-Anim loader
# ---------------------------------------------------------------------------

def test_vocab_copy_equals_the_original():
    text = ("The 2nd animal's call: it isn't loud, but ITS mate's is — "
            "über-loud at dusk_time, we don't know why x2y")
    for lower in (False, True):
        assert vocab.tokenize(text, lower) == jax_vocab.tokenize(text, lower)
    assert vocab.STOP_WORDS == jax_vocab.STOP_WORDS
    assert len(vocab.STOP_WORDS) == 179
    assert vocab.remove_stop_words(text) == jax_vocab.remove_stop_words(text)
    docs = [vocab.tokenize(d.lower()) for d in (text, "a b c a", "z y")]
    ours, theirs = vocab.Dictionary(docs), jax_vocab.Dictionary(docs)
    ours.add_document([vocab.PAD_WORD])
    theirs.add_document([jax_vocab.PAD_WORD])
    assert ours.token2id == theirs.token2id
    descs = [text, "a b", "c"]
    for a, b in zip(vocab.encode_padded(descs, ours),
                    jax_vocab.encode_padded(descs, theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [5, 20, 25, 673])
def test_split_categories_equal(n):
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(inat_anim.split_categories(n, split),
                                      jax_inat.split_categories(n, split))


@pytest.mark.parametrize("kw", [
    dict(text_encoder="BERT"),
    dict(text_encoder="precomputed", text_type=("label", "common_name"),
         remove_stop_words=True),
    dict(text_encoder="glove"),
    dict(text_encoder="RNN", text_type=("common_name", "description"),
         remove_stop_words=True),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_load_inat_anim_equals_the_jax_loader(inat_dir, kw):
    ours = inat_anim.load_inat_anim(inat_dir, image_embedding_model=
                                    "resnet-34", **kw)
    theirs = jax_inat.load_inat_anim(inat_dir, image_embedding_model=
                                     "resnet-34", **kw)
    assert set(ours.splits) == set(theirs.splits) == {"train", "val",
                                                     "test"}
    for s in theirs.splits:
        same_class_set(ours.splits[s], theirs.splits[s])
    assert ours.image_table.dtype == theirs.image_table.dtype == np.float32
    np.testing.assert_array_equal(ours.image_table, theirs.image_table)
    np.testing.assert_array_equal(ours.image_ids, theirs.image_ids)
    if theirs.dictionary is None:
        assert ours.dictionary is None
    else:
        assert ours.dictionary.token2id == theirs.dictionary.token2id
        assert list(ours.dictionary.token2id) == \
            list(theirs.dictionary.token2id)


def test_the_loaders_two_parts_give_its_result(inat_dir):
    """The HDF5 read and the table building are two functions; the second
    takes any numpy table (the card's machine has no h5py)."""
    with open(os.path.join(inat_dir, "inat_anim.json")) as f:
        ann = json.load(f)
    table = inat_anim.read_image_table(inat_dir, "resnet-34")
    with h5py.File(os.path.join(inat_dir, "image_embeddings_resnet-34.hdf5"),
                   "r") as f:
        np.testing.assert_array_equal(table, f["images"][...])
    for enc in ("BERT", "glove"):
        built = inat_anim.inat_anim_from_annotations(ann, table, inat_dir,
                                                     text_encoder=enc)
        whole = inat_anim.load_inat_anim(inat_dir, text_encoder=enc,
                                         image_embedding_model="resnet-34")
        for s in whole.splits:
            same_class_set(built.splits[s], whole.splits[s])
    assert built.dictionary.token2id == whole.dictionary.token2id


def test_bert_without_artifact_or_weights_names_the_prepare_command(
        inat_dir, monkeypatch):
    """No artifact for this tag and no loadable BERT (``transformers``
    blocked here, as on a machine without it): both loaders raise a
    RuntimeError naming their own prepare command."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    kw = dict(text_encoder="BERT", text_type=("label",),
              image_embedding_model="resnet-34")
    with pytest.raises(RuntimeError,
                       match="python -m fumi_tpu_torch.data.prepare bert"):
        inat_anim.load_inat_anim(inat_dir, **kw)
    with pytest.raises(RuntimeError, match="python -m fumi_tpu.data"):
        jax_inat.load_inat_anim(inat_dir, **kw)
    for mod in (prepare, jax_prepare):
        with pytest.raises(ImportError):
            mod.main(["bert", "--data_dir", inat_dir])


def test_raw_image_table_equals_the_jax_loader(tmp_path):
    rng = np.random.RandomState(1)
    with h5py.File(tmp_path / "low-res-images.hdf5", "w") as f:
        f.create_dataset("images", data=rng.randint(
            0, 255, (6, 16, 16), dtype=np.uint8))
    ours = inat_anim.load_raw_image_table(str(tmp_path))
    theirs = jax_inat.load_raw_image_table(str(tmp_path))
    assert ours.shape == (6, 16, 16, 1) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(FileNotFoundError, match="6703088"):
        inat_anim.load_raw_image_table(str(tmp_path / "nope"))


# ---------------------------------------------------------------------------
# pretrained vectors
# ---------------------------------------------------------------------------

def test_vector_files_parse_as_the_jax_package_parses(tmp_path):
    glove = tmp_path / "glove.txt"
    glove.write_text("animal 0.1 0.2 0.3\nlives 1 2 3\nbad x y z\n"
                     "short 1\nhabitat -1.5 2.25 0\n")
    w2v = tmp_path / "w2v.txt"
    w2v.write_text("3 2\nanimal 0.5 0.25\nlives 1 2\nzebra 3 4\n")
    for path in (glove, w2v):
        for keep in (None, {"animal", "zebra", "habitat"}):
            ours = vectors.parse_vector_file(str(path), keep)
            theirs = jax_vectors.parse_vector_file(str(path), keep)
            assert list(ours) == list(theirs)
            for w in theirs:
                assert ours[w].dtype == theirs[w].dtype
                np.testing.assert_array_equal(ours[w], theirs[w])


def test_vectors_artifact_bytes_equal(inat_dir, tmp_path):
    assert vectors.dataset_word_set(inat_dir) == \
        jax_vectors.dataset_word_set(inat_dir)
    ours = os.path.join(inat_dir, "word_vectors_glove.npz")
    with open(ours, "rb") as f:
        our_bytes = f.read()
    src = str(tmp_path / "w2v.txt")
    words = sorted(vectors.dataset_word_set(inat_dir))
    rng = np.random.RandomState(2)
    with open(src, "w") as f:
        f.write(f"{len(words)} 4\n")
        for w in words:
            f.write(w + " " + " ".join(f"{v:.3f}" for v in rng.randn(4))
                    + "\n")
    copy = tmp_path / "copy"
    copy.mkdir()
    for name in ("inat_anim.json",):
        with open(os.path.join(inat_dir, name)) as a, \
                open(copy / name, "w") as b:
            b.write(a.read())
    # the glove artifact the fixture wrote with the port, rewritten by JAX
    glove_src = os.path.join(os.path.dirname(inat_dir), "glove.txt")
    theirs = jax_vectors.build_vectors_artifact(glove_src, "glove",
                                                str(copy))
    with open(theirs, "rb") as f:
        assert f.read() == our_bytes
    for mod in (vectors, jax_vectors):
        mod.build_vectors_artifact(src, "w2v", str(copy))
        with open(copy / "word_vectors_w2v.npz", "rb") as f:
            if mod is vectors:
                mine = f.read()
            else:
                assert f.read() == mine
    ours_v = vectors.load_vectors_artifact(str(copy / "word_vectors_w2v.npz"))
    theirs_v = jax_vectors.load_vectors_artifact(
        str(copy / "word_vectors_w2v.npz"))
    assert list(ours_v) == list(theirs_v) == words
    for mod in (vectors, jax_vectors):
        with pytest.raises(ValueError, match="kind"):
            mod.build_vectors_artifact(src, "fasttext", str(copy))


def test_vectors_for_encoder(inat_dir, tmp_path):
    for enc in ("glove", "RNN", "RNNhid"):
        ours = vectors.vectors_for_encoder(enc, inat_dir)
        theirs = jax_vectors.vectors_for_encoder(enc, inat_dir)
        assert list(ours) == list(theirs)
        assert all(np.array_equal(ours[w], theirs[w]) for w in theirs)
    assert vectors.vectors_for_encoder("BERT", inat_dir) is None
    assert vectors.vectors_for_encoder("w2v", str(tmp_path),
                                       required=False) is None
    with pytest.raises(RuntimeError,
                       match="python -m fumi_tpu_torch.data.prepare vectors"):
        vectors.vectors_for_encoder("w2v", str(tmp_path))
    voc = vectors.Vocabulary({"a": 0}, {"a": np.zeros(3)})
    assert dict(voc) == {"a": 0} and isinstance(voc, dict)
    assert voc.vectors["a"].shape == (3,)


# ---------------------------------------------------------------------------
# CUB
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_cub_dir(tmp_path_factory):
    """A tiny CUB_200_2011 release: 8 classes x 5 PIL-written images."""
    from PIL import Image

    root = tmp_path_factory.mktemp("CUB_200_2011")
    (root / "images").mkdir()
    rng = np.random.RandomState(0)
    images, labels, classes = [], [], []
    img_id = 1
    for cid in range(1, 9):
        cname = f"{cid:03d}.Bird_{cid}"
        classes.append(f"{cid} {cname}")
        (root / "images" / cname).mkdir()
        for j in range(5):
            Image.fromarray(rng.randint(0, 255, (20, 24, 3),
                                        dtype=np.uint8)).save(
                root / "images" / cname / f"img_{j}.jpg")
            images.append(f"{img_id} {cname}/img_{j}.jpg")
            labels.append(f"{img_id} {cid}")
            img_id += 1
    (root / "images.txt").write_text("\n".join(images))
    (root / "image_class_labels.txt").write_text("\n".join(labels))
    (root / "classes.txt").write_text("\n".join(classes))
    return str(root)


def _fake_torchmeta(monkeypatch, tmp_path, assign):
    pkg = tmp_path / "torchmeta_pkg"
    assets = pkg / "datasets" / "assets" / "cub"
    assets.mkdir(parents=True)
    for split, names in assign.items():
        (assets / f"{split}.json").write_text(json.dumps(names))
    fake = types.ModuleType("torchmeta")
    fake.__file__ = str(pkg / "__init__.py")
    monkeypatch.setitem(sys.modules, "torchmeta", fake)


ASSIGN = {"train": ["007.Bird_7", "002.Bird_2", "005.Bird_5"],
          "val": ["001.Bird_1", "008.Bird_8"],
          "test": ["004.Bird_4", "003.Bird_3", "006.Bird_6"]}


@pytest.mark.parametrize("source", ["lists", "torchmeta", "proportional"])
def test_convert_cub_equals_the_jax_conversion(raw_cub_dir, tmp_path,
                                               monkeypatch, capsys, source):
    """Each split source gives the same artifacts, bit for bit, and the
    same log lines; ``load_cub`` reads them as the JAX loader does."""
    kw = dict(image_size=8)
    if source == "lists":
        lists = tmp_path / "lists"
        lists.mkdir()
        for split, names in ASSIGN.items():
            (lists / f"{split}.json").write_text(json.dumps(names))
        kw["split_lists"] = str(lists)
    elif source == "torchmeta":
        _fake_torchmeta(monkeypatch, tmp_path, ASSIGN)
    else:
        monkeypatch.setitem(sys.modules, "torchmeta", None)
    outs, logs = [], []
    for mod, name in ((cub, "ours"), (jax_cub, "theirs")):
        outs.append(mod.convert_cub(raw_cub_dir, str(tmp_path / name), **kw))
        logs.append(capsys.readouterr().out)
    assert logs[0] == logs[1] and "split source" in logs[0]
    for f in ("image_embeddings.npy", "class_image_rows.npz"):
        a = np.load(os.path.join(outs[0], f))
        b = np.load(os.path.join(outs[1], f))
        if f.endswith(".npz"):
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a.dtype == b.dtype == np.float32 and a.shape == (40, 192)
            np.testing.assert_array_equal(a, b)
    ours = cub.load_cub(str(tmp_path / "ours"))
    theirs = jax_cub.load_cub(str(tmp_path / "ours"))
    for s in ("train", "val", "test"):
        same_class_set(ours[0][s], theirs[0][s])
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])
    if source != "proportional":
        np.testing.assert_array_equal(ours[0]["train"].categories, [7, 2, 5])


def test_convert_cub_with_an_injected_encoder_and_its_errors(raw_cub_dir,
                                                             tmp_path):
    def embed(imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :12].astype(np.float32)
    for mod, name in ((cub, "a"), (jax_cub, "b")):
        mod.convert_cub(raw_cub_dir, str(tmp_path / name), embed_fn=embed,
                        image_size=8, batch_size=3)
    np.testing.assert_array_equal(
        np.load(tmp_path / "a" / "CUB" / "image_embeddings.npy"),
        np.load(tmp_path / "b" / "CUB" / "image_embeddings.npy"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="images.txt"):
        cub.convert_cub(str(empty), str(tmp_path))
    for f in ("images.txt", "image_class_labels.txt", "classes.txt"):
        (empty / f).write_text("")
    with pytest.raises(FileNotFoundError, match="CUB_200_2011"):
        cub.convert_cub(str(empty), str(tmp_path))
    with pytest.raises(FileNotFoundError, match="CUB artifacts"):
        cub.load_cub(str(empty))


# ---------------------------------------------------------------------------
# verify and prepare
# ---------------------------------------------------------------------------

BREAKAGES = {
    "sound": None,
    "permuted-ids": lambda d: _edit_json(
        d, lambda a: a["images"].reverse()),
    "category-out-of-range": lambda d: _edit_json(
        d, lambda a: a["annotations"][0].update(category_id=999)),
    "missing-text-key": lambda d: _edit_json(
        d, lambda a: a["categories"][0].pop("common_name")),
    "wrong-width": lambda d: _rewrite_h5(d, np.zeros((C * PER, 64),
                                                     np.float32)),
    "nonfinite-text": lambda d: np.save(
        os.path.join(d, "text_embeddings_bert_description.npy"),
        np.full((C, 16), np.nan, np.float32)),
    "no-json": lambda d: os.remove(os.path.join(d, "inat_anim.json")),
}


def _edit_json(d, fn):
    path = os.path.join(d, "inat_anim.json")
    with open(path) as f:
        ann = json.load(f)
    fn(ann)
    with open(path, "w") as f:
        json.dump(ann, f)


def _rewrite_h5(d, table):
    with h5py.File(os.path.join(d, "image_embeddings_resnet-34.hdf5"),
                   "w") as f:
        f.create_dataset("images", data=table)


@pytest.mark.parametrize("case", list(BREAKAGES))
def test_verify_reports_as_the_jax_package(tmp_path, case, capsys):
    """``prepare verify``: the same report lines and exit code on a sound
    fixture and on each breakage."""
    data_dir = build(str(tmp_path), num_classes=C, images_per_class=PER)
    np.save(os.path.join(data_dir, "text_embeddings_bert_description.npy"),
            np.ones((C, 16), np.float32))
    if BREAKAGES[case] is not None:
        BREAKAGES[case](data_dir)
    ours, theirs = (verify.verify_dataset(data_dir),
                    jax_verify.verify_dataset(data_dir))
    assert ours.rows == theirs.rows
    assert ours.render() == theirs.render()
    assert ours.failed == (case != "sound")
    rcs, outs = [], []
    for mod in (prepare, jax_prepare):
        rcs.append(mod.main(["verify", "--data_dir", data_dir]))
        outs.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] == (0 if case == "sound" else 1)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("argv", [
    ["inspect"], ["inspect", "--data_dir", "{empty}"],
    ["vectors", "--src", "{src}", "--kind", "w2v", "--no_filter"],
    ["vectors", "--src", "{src}", "--kind", "glove"],
    ["cub", "--raw_dir", "{raw}", "--image_size", "6"],
], ids=["inspect", "inspect-missing", "vectors-w2v", "vectors-glove",
        "cub"])
def test_prepare_subcommands_as_the_jax_package(inat_dir, raw_cub_dir,
                                                tmp_path, capsys,
                                                monkeypatch, argv):
    """Exit code, printed lines (paths aside) and written files."""
    monkeypatch.setitem(sys.modules, "torchmeta", None)
    src = tmp_path / "vec.txt"
    src.write_text("2 3\nanimal 1 2 3\ndusk 4 5 6\n")
    (tmp_path / "empty").mkdir()
    outs = []
    for mod, name in ((prepare, "ours"), (jax_prepare, "theirs")):
        d = tmp_path / name
        d.mkdir()
        with open(os.path.join(inat_dir, "inat_anim.json")) as a, \
                open(d / "inat_anim.json", "w") as b:
            b.write(a.read())
        for f in glob.glob(os.path.join(inat_dir, "text_embeddings_*")):
            os.symlink(f, d / os.path.basename(f))
        args = [a.format(src=src, raw=raw_cub_dir, empty=tmp_path / "empty")
                for a in argv]
        if "--data_dir" not in args:
            args += ["--data_dir", str(d)]
        rc = mod.main(args)
        outs.append((rc, capsys.readouterr().out.replace(str(d), "<dir>"),
                     sorted(os.listdir(d))))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if argv[-1] == "{empty}" else 0)
