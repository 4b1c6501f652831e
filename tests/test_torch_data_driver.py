"""The port's driver on the real datasets' layouts, beside the JAX
package's driver on the same fixture, on the CPU: ``--dataset inat-anim``
(FuMI with BERT artifacts, AM3 with pretrained glove vectors),
``supervised-inat-anim`` (CLIP) and ``cub`` (MAML, ProtoNet). Each run is
held to the JAX run on the ``TEST`` line's keys, the prediction CSV's
header and row count, and the split its query rows come from; the CSV's
bytes equal the JAX package's writer's on the port's test metrics. The
two packages' random streams differ, so the metric values are not
compared (``tests/test_torch_loop.py`` holds the loops on replayed
episodes).
"""

import dataclasses
import glob
import json
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from ref_oracle.dataset_gen import build  # noqa: E402

import fumi_tpu.cli.main as jax_cli  # noqa: E402
import fumi_tpu.core.config as jax_config  # noqa: E402
from fumi_tpu_torch.cli import main as cli_main  # noqa: E402
from fumi_tpu_torch.core import config  # noqa: E402
from fumi_tpu_torch.data import cub, inat_anim, prepare, vectors  # noqa

C, PER = 25, 24  # 15/5/5 classes; 24 images each


@pytest.fixture(scope="module")
def inat_dir(tmp_path_factory):
    """A reference-format iNat-Anim directory (resnet-34 width 512) with a
    BERT artifact of width 16 and a glove artifact of 300-wide vectors."""
    root = str(tmp_path_factory.mktemp("inat"))
    data_dir = build(root, num_classes=C, images_per_class=PER)
    rng = np.random.RandomState(0)
    np.save(os.path.join(data_dir, "text_embeddings_bert_description.npy"),
            rng.randn(C, 16).astype(np.float32))
    src = os.path.join(root, "glove.txt")
    with open(src, "w") as f:
        for w in sorted(vectors.dataset_word_set(data_dir)):
            f.write(w + " " + " ".join(f"{v:.5f}" for v in rng.randn(300))
                    + "\n")
    assert prepare.main(["vectors", "--src", src, "--kind", "glove",
                         "--data_dir", data_dir]) == 0
    return data_dir


# ---------------------------------------------------------------------------
# the driver on each dataset
# ---------------------------------------------------------------------------

EPISODIC = ["--im_emb_dim", "512", "--image_embedding_model", "resnet-34",
            "--im_hid_dim", "16", "8", "--text_hid_dim", "8",
            "--num_ways", "5", "--num_shots", "2", "--num_shots_test", "2",
            "--num_train_adapt_steps", "1", "--num_test_adapt_steps", "3",
            "--batch_size", "2", "--num_ep_test", "4", "--epochs", "4",
            "--eval_freq", "2", "--lr", "0.01", "--step_size", "0.1",
            "--dropout", "0", "--seed", "0", "--wandb_offline"]


@pytest.fixture(scope="module")
def cub_dir(tmp_path_factory):
    """Converted CUB artifacts: 24 classes (12/6/6) of 22 rows, width 32."""
    root = tmp_path_factory.mktemp("cubdata")
    out = root / "CUB"
    out.mkdir()
    rng = np.random.RandomState(4)
    np.save(out / "image_embeddings.npy",
            rng.randn(24 * 22, 32).astype(np.float32))
    order = rng.permutation(24)
    tabs = {}
    for split, cls in (("train", order[:12]), ("val", order[12:18]),
                       ("test", order[18:])):
        tabs[f"{split}_rows"] = np.stack([np.arange(c * 22, c * 22 + 22)
                                          for c in cls]).astype(np.int32)
        tabs[f"{split}_counts"] = np.full(len(cls), 22, np.int32)
        tabs[f"{split}_categories"] = cls.astype(np.int32)
    np.savez(out / "class_image_rows.npz", **tabs)
    return str(root)


def _both_drivers(tmp_path, argv, monkeypatch):
    """The port's and the JAX package's ``main`` on one argv; returns
    ((test dict, CSV path, port test metrics) for each, in that order)."""
    seen = []
    orig = cli_main._save_predictions_csv

    def spy(cfg, writer, results_path, test_m):
        seen.append((cfg, writer, test_m))
        return orig(cfg, writer, results_path, test_m)
    monkeypatch.setattr(cli_main, "_save_predictions_csv", spy)
    out = []
    for mod, name in ((cli_main, "ours"), (jax_cli, "theirs")):
        log_dir = str(tmp_path / name)
        args = argv + ["--log_dir", log_dir]
        if mod is cli_main:
            res = mod.main(config.config_from_args(args + ["--disable_cuda"]))
        else:
            res = mod.main(jax_config.config_from_args(args))
        out.append((res, glob.glob(os.path.join(log_dir, "results",
                                                "run_*.csv"))))
    return out, seen


def _csv_rows(path):
    import csv
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("dataset,model,extra", [
    ("inat-anim", "fumi", ["--text_encoder", "BERT", "--text_emb_dim", "16",
                           "--augment", "--tpu_pallas_gather",
                           "--tpu_pallas_fused_eval"]),
    ("inat-anim", "am3", ["--text_encoder", "glove", "--prototype_dim",
                          "8"]),
    ("cub", "maml", ["--im_emb_dim", "32", "--tpu_pallas_fused_eval"]),
    ("cub", "protonet", ["--im_emb_dim", "32", "--prototype_dim", "8"]),
], ids=["inat-fumi-bert", "inat-am3-glove", "cub-maml", "cub-protonet"])
def test_the_driver_runs_each_dataset_beside_the_jax_driver(
        inat_dir, cub_dir, tmp_path, monkeypatch, dataset, model, extra):
    data_dir = cub_dir if dataset == "cub" else inat_dir
    argv = EPISODIC + ["--dataset", dataset, "--data_dir", data_dir,
                       "--model", model] + extra
    ((ours, our_csv), (theirs, their_csv)), seen = _both_drivers(
        tmp_path, argv, monkeypatch)
    assert set(ours) == set(theirs)
    assert all(np.isfinite(v) for v in ours.values())
    assert 0.0 <= ours["test/acc"] <= 1.0
    (our_csv,), (their_csv,) = our_csv, their_csv
    a, b = _csv_rows(our_csv), _csv_rows(their_csv)
    assert a[0] == b[0] and len(a) == len(b)
    # the query rows come from the test split's images on both sides
    if dataset == "cub":
        rows = cub.load_cub(data_dir)[0]["test"].class_image_rows
    else:
        rows = inat_anim.load_inat_anim(
            data_dir, image_embedding_model="resnet-34",
            text_encoder="BERT").splits["test"].class_image_rows
    col = a[0].index("query_idx")
    for table in (a, b):
        ids = {i for r in table[1:] for i in json.loads(r[col])}
        assert ids <= set(rows.ravel().tolist())
    # the CSV's bytes are the JAX package's writer's on the same metrics
    (cfg, writer, test_m), = seen
    jax_dir = tmp_path / "jax_writer"
    jax_dir.mkdir()
    path = jax_cli._save_predictions_csv(
        jax_config.Config(**dataclasses.asdict(cfg)),
        types.SimpleNamespace(run_name=writer.run_name), str(jax_dir),
        test_m)
    with open(our_csv, "rb") as x, open(path, "rb") as y:
        assert x.read() == y.read()
    if model == "am3":  # the token run ships its dictionary
        (run,) = glob.glob(str(tmp_path / "ours" / "runs" / "*"))
        with open(os.path.join(run, "vocab.json")) as f:
            assert json.load(f) == inat_anim.load_inat_anim(
                data_dir, text_encoder="glove",
                image_embedding_model="resnet-34").dictionary.token2id


def test_clip_on_supervised_inat_anim_beside_the_jax_driver(inat_dir,
                                                            tmp_path,
                                                            monkeypatch):
    argv = ["--model", "clip", "--dataset", "supervised-inat-anim",
            "--data_dir", inat_dir, "--im_emb_dim", "512",
            "--image_embedding_model", "resnet-34", "--text_emb_dim", "16",
            "--clip_latent_dim", "8", "--batch_size", "16", "--epochs", "1",
            "--lr", "0.001", "--seed", "0", "--wandb_offline"]
    ((ours, _), (theirs, _)), _ = _both_drivers(tmp_path, argv, monkeypatch)
    assert set(ours) == set(theirs) == {"test/acc"}
    assert 0.0 <= ours["test/acc"] <= 1.0
    for bad in (["--text_encoder", "precomputed"], ["--dataset", "cub"]):
        with pytest.raises(NotImplementedError):
            cli_main.main(config.config_from_args(
                argv + bad + ["--disable_cuda", "--log_dir",
                              str(tmp_path / "bad")]))
