"""Raw-image data in the port against the JAX package's, on the CPU: bf16
table storage, the raw synthetic set, the flip-and-crop augmentation on
JAX's draws, raw episodes on JAX's noise, the raw iNat-Anim loader on an
HDF5 fixture, and the driver (``cli.main``) end to end with a conv
backbone and with the bf16 policy.

Everything here is bitwise: storage, sampling, gathering and the
augmentation move and widen values without arithmetic (bf16 storage is
one rounding on both sides). The driver runs are held to their outputs'
form (a finite ``TEST`` line, accuracies in [0, 1], the CSV and the
checkpoints).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import inat_anim as jax_inat
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data import synthetic as jax_synthetic
from torch_raw_helpers import few_threads  # noqa: F401
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import config_from_args
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import inat_anim, sampler, synthetic
from fumi_tpu_torch.ops import kernels

from ref_oracle.dataset_gen import build

B, N, K, Q, S, C = 2, 3, 2, 2, 10, 3


def to_torch(a):
    """numpy or JAX array (bf16 included) -> torch, bitwise."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_table_storage(dtype, policy):
    """bf16 storage of a floating table under the bf16 policy (one
    rounding, bitwise JAX's); uint8 pixels and the fp32 policy untouched."""
    rng = np.random.RandomState(0)
    table = (rng.randint(0, 256, (7, 5)).astype(np.uint8) if dtype == "uint8"
             else rng.randn(7, 5).astype(np.float32))
    want = jax_sampler.table_storage(jnp.asarray(table), policy)
    got = sampler.table_storage(torch.from_numpy(table), policy)
    assert got.dtype == to_torch(want).dtype
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(), dict(num_classes=4,
                                             images_per_class=3, im_size=9,
                                             channels=1, text_dim=5,
                                             noise=0.1, seed=2)])
def test_raw_synthetic_set_equals_original(kw):
    ours = synthetic.synthetic_raw_image_set(**kw)
    theirs = jax_synthetic.synthetic_raw_image_set(**kw)
    for a, b in zip(ours[1:], theirs[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in ("categories", "class_image_rows", "class_counts",
              "text_features"):
        np.testing.assert_array_equal(getattr(ours[0], f),
                                      getattr(theirs[0], f))
    assert ours[0].descriptions == theirs[0].descriptions


def jax_raw_draws(key, m, pad=4):
    """The flip bits and crop offsets JAX's ``augment_raw_images`` draws
    from ``key`` (sampler.py:78-100), as torch tensors."""
    k_flip, k_y, k_x = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k_flip, 0.5, (m,))
    oy = jax.random.randint(k_y, (m,), 0, 2 * pad + 1)
    ox = jax.random.randint(k_x, (m,), 0, 2 * pad + 1)
    return tuple(torch.from_numpy(np.array(a)) for a in (flip, oy, ox))


@pytest.mark.parametrize("shape", [(6, 12, 12, 3), (5, 9, 7, 1)])
def test_augment_raw_images_on_jax_draws(shape):
    """The flip and the edge-padded crop, bitwise JAX's on its draws."""
    images = np.random.RandomState(1).rand(*shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_sampler.augment_raw_images(key, jnp.asarray(images))
    flip, oy, ox = jax_raw_draws(key, shape[0])
    assert flip.any() and not flip.all()
    got = sampler.augment_raw_images(torch.from_numpy(images), flip, oy, ox)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def raw_tables(dtype):
    """The same raw tables for both packages: (jax tables, port tables)."""
    cs, table, ids = jax_synthetic.synthetic_raw_image_set(
        num_classes=5, images_per_class=6, im_size=S, channels=C,
        text_dim=4)
    if dtype == "uint8":
        table = (np.clip(table, -2, 2) * 60 + 128).astype(np.uint8)
    j_table = (jnp.asarray(table) if dtype == "uint8" else
               jax_sampler.table_storage(jnp.asarray(table), dtype))
    args = (jnp.asarray(ids), jnp.asarray(cs.class_image_rows),
            jnp.asarray(cs.class_counts), jnp.asarray(cs.text_features))
    j = jax_sampler.SamplerTables(j_table, *args)
    t = sampler.SamplerTables(to_torch(j_table),
                              *(to_torch(a) for a in args))
    return j, t


@pytest.mark.parametrize("gather", [False, True], ids=["library", "kernel"])
@pytest.mark.parametrize("augment", [0.0, 0.1], ids=["plain", "augment"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_raw_episode_on_jax_noise(dtype, augment, gather):
    """A raw episode (B, N·K, H, W, C) fp32 from JAX's noise, bitwise JAX's
    ``sample_episode``: the gather through the (R, H·W·C) view (the
    kernel's route runs its plain version on the CPU), the widening, and
    under ``--augment`` the flip and crop of the support images only."""
    j, t = raw_tables(dtype)
    key = jax.random.PRNGKey(7)
    want = jax_sampler.sample_episode(j, JaxSpec(B, N, K, Q, S, 4), key,
                                      augment_scale=augment)
    k_cls, k_img, k_aug = jax.random.split(key, 3)
    cls_noise = jax.random.uniform(k_cls, (B, 5))
    img_noise = jax.random.uniform(k_img, (B, N, 6))
    raw_aug = jax_raw_draws(k_aug, B * N * K) if augment else None
    got = sampler.episode_from_noise(
        t, EpisodeSpec(B, N, K, Q, S, 4), to_torch(cls_noise),
        to_torch(img_noise), use_pallas_gather=gather, raw_aug=raw_aug)
    assert got.support_im.shape == (B, N * K, S, S, C)
    assert got.support_im.dtype == torch.float32
    for f in ("support_im", "query_im", "support_y", "query_y",
              "support_ids", "query_ids", "support_text"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_raw_tables_refuse_the_embedding_jitter():
    _, t = raw_tables("float32")
    spec = EpisodeSpec(B, N, K, Q, S, 4)
    with pytest.raises(ValueError, match="flip and crop"):
        sampler.episode_from_noise(t, spec, torch.rand(B, 5),
                                   torch.rand(B, N, 6),
                                   aug_seed=torch.zeros(1, dtype=torch.int64),
                                   augment_scale=0.1)


def test_gather_episode_rows_takes_the_raw_view():
    """``gather_episode_rows`` on the contiguous (R, H·W·C) view of a uint8
    NHWC table is the NHWC gather, widened."""
    table = torch.randint(0, 256, (9, 5, 5, 3), dtype=torch.uint8)
    rows = torch.randint(0, 9, (2, 3, 4), dtype=torch.int32)
    sup, qry = kernels.gather_episode_rows(table.view(9, -1), rows, 1)
    want = kernels.pixels_to_float(table[rows.long()])
    np.testing.assert_array_equal(
        sup.reshape(2, 3, 1, 5, 5, 3).numpy(), want[:, :, :1].numpy())
    np.testing.assert_array_equal(
        qry.reshape(2, 3, 3, 5, 5, 3).numpy(), want[:, :, 1:].numpy())


def test_raw_inat_anim_equals_the_jax_loader(tmp_path, monkeypatch):
    """``load_inat_anim(raw_images=True)`` on a fixture with
    ``low-res-images.hdf5`` and a BERT artifact (nothing is fetched): the
    uint8 NHWC table and the splits."""
    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        monkeypatch.setenv(var, "1")
    data_dir = build(str(tmp_path), num_classes=15, images_per_class=6,
                     raw_image_size=12)
    np.save(os.path.join(data_dir, "text_embeddings_bert_description.npy"),
            np.random.RandomState(0).randn(15, 8).astype(np.float32))
    kw = dict(text_encoder="BERT", raw_images=True)
    ours = inat_anim.load_inat_anim(data_dir, **kw)
    theirs = jax_inat.load_inat_anim(data_dir, **kw)
    assert ours.image_table.dtype == np.uint8
    assert ours.image_table.shape[1:] == (12, 12, 3)
    np.testing.assert_array_equal(ours.image_table, theirs.image_table)
    np.testing.assert_array_equal(ours.image_ids, theirs.image_ids)
    for s in theirs.splits:
        np.testing.assert_array_equal(ours.splits[s].class_image_rows,
                                      theirs.splits[s].class_image_rows)
        np.testing.assert_array_equal(ours.splits[s].text_features,
                                      theirs.splits[s].text_features)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def driver(tmp_path, model, *extra):
    argv = ["--model", model, "--dataset", "synthetic", "--disable_cuda",
            "--im_encoder", "conv4", "--tpu_im_size", "16",
            "--text_emb_dim", "16", "--prototype_dim", "8",
            "--text_hid_dim", "8", "--num_shots", "2", "--num_shots_test",
            "2", "--batch_size", "2", "--epochs", "4", "--eval_freq", "2",
            "--num_ep_test", "4", "--num_train_adapt_steps", "1",
            "--num_test_adapt_steps", "2", "--tpu_chunk", "2",
            "--log_dir", str(tmp_path), "--wandb_offline", *extra]
    return cli_main.main(config_from_args(argv))


@pytest.mark.parametrize("model,extra", [
    ("maml", ["--augment", "--tpu_pallas_gather"]),
    ("fumi", ["--tpu_compute_dtype", "bfloat16"]),
    ("protonet", ["--im_encoder", "resnet12", "--tpu_resnet12_channels",
                  "4", "6", "8", "8", "--tpu_remat", "on"]),
], ids=["maml-conv4-augment", "fumi-conv4-bf16", "protonet-resnet12"])
def test_driver_end_to_end(tmp_path, model, extra):
    out = driver(tmp_path, model, *extra)
    assert np.isfinite(out["test/loss"]) and 0 <= out["test/acc"] <= 1
    run = glob.glob(os.path.join(str(tmp_path), "runs", "*"))[0]
    assert os.path.isdir(os.path.join(run, "ckpt"))
    with open(os.path.join(run, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["im_size"] == 16
    assert glob.glob(os.path.join(str(tmp_path), "results", "run_*.csv"))


def test_driver_adopts_the_raw_tables_geometry(capsys):
    """A raw table's stored size and channels, not the flags, set the
    backbone's geometry; non-square tables are refused."""
    cfg = config_from_args(["--model", "maml", "--im_encoder", "conv4",
                            "--dataset", "synthetic"])
    got = cli_main.adopt_raw_geometry(cfg, np.zeros((2, 12, 12, 1)))
    assert (got.im_size, got.im_channels) == (12, 1)
    assert "adopting stored geometry 12x12x1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="square"):
        cli_main.adopt_raw_geometry(cfg, np.zeros((2, 12, 10, 3)))
    flat = cfg.replace(im_encoder="precomputed")
    assert cli_main.adopt_raw_geometry(flat, np.zeros((2, 12, 12, 1))) \
        is flat
