"""The token text encoders in the port against the JAX package's, on the
CPU: word-embedding pooling (glove / w2v) and the masked biLSTM (RNN /
RNNhid), alone and inside FuMI's and AM3's episodes.

Widths: a vocabulary of 32, pretrained vectors of width 16 for part of it
(handed over as ``dictionary.vectors``, the duck typing both factories
read), biLSTM encodings of 16 (8 a direction), T ≤ 7 tokens with PAD
suffixes of every length from T−1 down to 0; B=2 tasks of 3 ways, 2 shots,
4 queries, image 40, hid (16, 8), text_hid 8. Weights are bridged from the
JAX side; dropout is 0.

Tolerances: the embedding table is numpy on both sides, bitwise. Pooling is
one gather and one sum or max: 1e-6. The biLSTM is 7 dependent cell steps
of fp32 matmuls summed in other orders (the port folds both biases into
one input projection up front): 1e-5. An episode's loss and gradients add
FuMI's second-order inner loop or AM3's prototypes: 1e-4, as three
optimizer steps are held. Without ``--fine_tune`` the encoder's params
stay bitwise where they started.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fumi_tpu.cli.main as jax_cli
from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data import synthetic as jax_synthetic
from fumi_tpu.models import text_encoders as jax_te
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler, synthetic
from fumi_tpu_torch.models import text_encoders
from fumi_tpu_torch.train import steps

B, N, K, Q, D, V, W, T = 2, 3, 2, 4, 40, 32, 16, 7
TOL = dict(rtol=1e-4, atol=1e-4)
ENCODERS = ["glove", "w2v", "RNN", "RNNhid"]


class Vocab(dict):
    """A token dictionary carrying pretrained vectors, as the JAX
    package's ``data/vectors.py:Vocabulary`` does."""
    vectors = None


def vocab(with_vectors=True):
    d = Vocab(synthetic.synthetic_dictionary(V))
    if with_vectors:
        rng = np.random.RandomState(7)
        d.vectors = {f"w{i}": rng.randn(W).astype(np.float32)
                     for i in range(1, V, 2)}
    return d


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def padded_tokens(rng, rows, T=T):
    """(rows, T) token ids whose lengths run T, T-1, ..., 1, T, ... with
    PAD (0) suffixes."""
    toks = rng.randint(1, V, size=(rows, T)).astype(np.int32)
    for r in range(rows):
        toks[r, T - r % T:] = 0
    return toks


def cfg_kw(model, encoder, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=W,
             im_hid_dim=(16, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
             num_train_adapt_steps=2, num_test_adapt_steps=3, step_size=0.1,
             dropout=0.0, optim="adam", lr=1e-2, text_encoder=encoder,
             seed=0)
    d.update(kw)
    return d


def families(model, encoder, **kw):
    """(JAX config, JAX family, port config, port family) on the same
    weights and dictionary."""
    d = vocab()
    jcfg = JaxConfig(**cfg_kw(model, encoder, **kw))
    jfam = jax_steps.build_family(jcfg, jax.random.PRNGKey(0), d)
    cfg = Config(**cfg_kw(model, encoder, **kw))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0), d)
    fam = fam._replace(params=bridge.params_from_jax(
        np_tree(jfam.params), model, device="cpu"))
    return jcfg, jfam, cfg, fam


@pytest.fixture(scope="module")
def episodes():
    """Three JAX token meta-batches whose class descriptions are padded to
    mixed lengths (1..T tokens), and the same in the port's form."""
    cs, table, ids = jax_synthetic.synthetic_class_set(
        num_classes=10, images_per_class=12, im_dim=D, text_tokens=True,
        vocab_size=V, text_len=T)
    cs.text_features = padded_tokens(np.random.RandomState(3), 10)
    smp = jax_sampler.DeviceEpisodeSampler(
        jnp.asarray(table), jnp.asarray(ids), cs,
        JaxSpec(B, N, K, Q, D, T, text_is_tokens=True))
    eps = [smp.sample(jax.random.PRNGKey(i)) for i in range(3)]
    return [(ep, bridge.episode_from_numpy(np_tree(ep), device="cpu"))
            for ep in eps]


# ---------------------------------------------------------------------------
# the encoders alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["synthetic", "vectors", "PAD-word"])
def test_embedding_weights_bitwise(case):
    d = {"synthetic": lambda: synthetic.synthetic_dictionary(V),
         "vectors": vocab,
         "PAD-word": lambda: {"PAD": 2, "a": 0, "b": 1, "c": 3}}[case]()
    vec = getattr(d, "vectors", None)
    got = text_encoders.embedding_weights(d, vec)
    want = jax_te.embedding_weights(d, vec)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert synthetic.synthetic_dictionary(V) == \
        jax_synthetic.synthetic_dictionary(V)
    assert text_encoders.pad_id(d) == (2 if case == "PAD-word" else 0)


@pytest.mark.parametrize("strat", ["mean", "max"])
def test_word_embedding_pooling(strat):
    """Mean pooling sums every position (PAD rows are zero) over the
    non-PAD count; max pooling is unmasked. 1e-6."""
    d = vocab()
    jenc = jax_te.make_text_encoder("glove", jax.random.PRNGKey(0), W, d,
                                    pooling_strat=strat)
    tenc = text_encoders.make_text_encoder(
        "glove", torch.Generator().manual_seed(0), W, d,
        pooling_strat=strat)
    toks = padded_tokens(np.random.RandomState(0), 2 * T).reshape(2, T, T)
    want = np.asarray(jenc.apply(jenc.params, jnp.asarray(toks)))
    got = tenc.apply({text_encoders.EMBED: torch.from_numpy(
        np.asarray(jenc.params["embed"]))}, torch.from_numpy(toks))
    assert got.shape == want.shape == (2, T, W) and tenc.out_dim == W
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_all_pad_mean_is_nan_in_both():
    """An all-PAD row pools to 0/0 = NaN in both packages (kept, not
    "fixed")."""
    d = vocab(with_vectors=False)
    emb = torch.from_numpy(text_encoders.embedding_weights(d))
    toks = np.zeros((1, 4), np.int32)
    got = text_encoders.word_embedding_apply(emb, torch.from_numpy(toks), 0)
    want = jax_te.word_embedding_apply({"embed": jnp.asarray(emb.numpy())},
                                       jnp.asarray(toks), 0)
    assert torch.isnan(got).all() and np.isnan(np.asarray(want)).all()
    assert got.shape == (1, 300)  # no vectors: the default width


@pytest.mark.parametrize("encoder", ["RNN", "RNNhid"])
def test_bilstm_on_padded_batches(encoder):
    """The masked biLSTM on a batch whose lengths run from 1 to T, against
    ``rnn_encoder_apply``: 1e-5. A sequence's encoding does not depend on
    the PAD columns appended after it."""
    _, jfam, _, fam = families("fumi", encoder)
    jenc, tenc = jfam.model.text_encoder, fam.model.text_encoder
    toks = padded_tokens(np.random.RandomState(1), 3 * T)
    want = np.asarray(jenc.apply(jfam.params["text_encoder"],
                                 jnp.asarray(toks)))
    got = tenc.apply(fam.params, torch.from_numpy(toks))
    assert got.shape == want.shape == (3 * T, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    longer = np.concatenate([toks, np.zeros((3 * T, 3), np.int32)], -1)
    np.testing.assert_allclose(
        tenc.apply(fam.params, torch.from_numpy(longer)).numpy(),
        got.numpy(), rtol=1e-6, atol=1e-6)
    lead = tenc.apply(fam.params, torch.from_numpy(toks.reshape(3, T, T)))
    np.testing.assert_array_equal(lead.reshape(3 * T, W).numpy(),
                                  got.numpy())


def test_lstm_init_layout():
    """torch's LSTM layout and init bound: weights (4H, in) and (4H, H),
    biases (4H,), all in [-1/sqrt(H), 1/sqrt(H)]."""
    p = text_encoders.lstm_init(torch.Generator().manual_seed(0), 5, 4)
    lstm = torch.nn.LSTM(5, 4, bidirectional=True)
    assert {"text_encoder.rnn." + k for k, _ in lstm.named_parameters()} \
        == set(p)
    for k, v in lstm.named_parameters():
        assert p["text_encoder.rnn." + k].shape == v.shape
    assert all(float(v.abs().max()) <= 0.5 for v in p.values())


# ---------------------------------------------------------------------------
# FuMI and AM3 episodes with token text
# ---------------------------------------------------------------------------

FAMILY_CASES = [(m, e) for m in ("fumi", "am3") for e in ENCODERS]


@pytest.mark.parametrize("model,encoder", FAMILY_CASES,
                         ids=[f"{m}-{e}" for m, e in FAMILY_CASES])
def test_episode_loss_and_gradients(episodes, model, encoder):
    """One train episode's loss and every gradient, 1e-4; the frozen
    encoder's gradients are zero on both sides."""
    _, jfam, _, fam = families(model, encoder)
    jep, tep = episodes[0]
    (jl, _), jg = jax.value_and_grad(jfam.train_loss, has_aux=True)(
        jfam.params, jep, jax.random.PRNGKey(0))
    (tl, _), tg = steps.value_and_grad(fam, fam.params, tep, None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    got, want = bridge.params_to_numpy(tg, model), np_tree(jg)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, **TOL)
    assert all(float(tg[k].abs().max()) == 0.0 for k in tg
               if k.startswith("text_encoder."))
    raw_j = jfam.eval_raw(jfam.params, jep, jax.random.PRNGKey(0))
    raw_t = fam.eval_raw(fam.params, tep, None)
    np.testing.assert_allclose(float(raw_t["loss"]), float(raw_j["loss"]),
                               **TOL)
    np.testing.assert_array_equal(raw_t["preds"].numpy(),
                                  np.asarray(raw_j["preds"]))


@pytest.mark.parametrize("model,encoder,fine_tune", [
    ("fumi", "RNN", False), ("fumi", "RNN", True), ("am3", "glove", False),
    ("am3", "glove", True)])
def test_frozen_and_fine_tuned_after_three_steps(episodes, model, encoder,
                                                 fine_tune):
    """3 Adam steps (coupled L2) on the same episodes: params within 1e-4
    of JAX's. Without ``--fine_tune`` the embedding table and the LSTM
    weights are bitwise where they started; with it they moved."""
    jcfg, jfam, cfg, fam = families(model, encoder, fine_tune=fine_tune)
    j_steps = jax_steps.steps_from_family(jfam, jax_steps.make_opt(jcfg))
    t_steps = steps.steps_from_family(fam, steps.make_opt(cfg))
    assert steps.frozen_text_encoder(cfg) == (not fine_tune)
    jp, js = j_steps.params, j_steps.opt.init(j_steps.params)
    tp, ts = t_steps.params, t_steps.opt.init(t_steps.params)
    for i, (jep, tep) in enumerate(episodes):
        jp, js, jm = j_steps.train_step(jp, js, jep, jax.random.PRNGKey(i))
        tp, ts, tm = t_steps.train_step(tp, ts, tep, None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.params_to_numpy(
            tp, model)), jax.tree_util.tree_leaves(np_tree(jp))):
        np.testing.assert_allclose(a, b, **TOL)
    enc = [k for k in tp if k.startswith("text_encoder.")]
    assert text_encoders.EMBED in enc
    same = [torch.equal(tp[k], fam.params[k]) for k in enc]
    assert all(same) if not fine_tune else not any(same)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_bridge_round_trip(encoder):
    for model in ("fumi", "am3"):
        _, jfam, _, fam = families(model, encoder)
        tree = np_tree(jfam.params)
        back = bridge.params_to_numpy(fam.params, model)
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        assert set(fam.params) == set(fam.model.text_encoder.params) | {
            k for k in fam.params if not k.startswith("text_encoder.")}


# ---------------------------------------------------------------------------
# the device sampler, the chunked drivers and the driver with tokens
# ---------------------------------------------------------------------------

def test_sampler_carries_int32_token_text():
    """(B, N·K, T) int32 text, each support row its class's tokens; the
    chunked train and eval run on it with the kernel gather flag."""
    cs, table, ids = synthetic.synthetic_class_set(
        num_classes=10, images_per_class=12, im_dim=D, text_tokens=True,
        vocab_size=V, text_len=T)
    spec = EpisodeSpec(B, N, K, Q, D, T, text_is_tokens=True)
    smp = sampler.DeviceEpisodeSampler(table, ids, cs, spec,
                                       use_pallas_gather=True, device="cpu")
    ep = smp.sample(smp.generator(0))
    assert ep.support_text.dtype == torch.int32
    assert tuple(ep.support_text.shape) == (B, N * K, T)
    rows = ep.support_ids.long() // 12  # the class of each support image
    np.testing.assert_array_equal(
        ep.support_text.numpy(), cs.text_features[rows.numpy()])
    cfg = Config(**cfg_kw("fumi", "RNN", pallas_gather=True))
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), "cpu",
                          dictionary=vocab())
    _, _, gen, m = steps.make_chunked_train(st.family, st.opt, smp, 2)(
        st.params, st.opt.init(st.params), smp.generator(1))
    assert bool(torch.isfinite(m["loss"]).all())
    _, e = steps.make_chunked_eval(st.family, smp)(st.params, gen, 2)
    assert e["loss"].shape == (2,)


def test_driver_data_equals_the_jax_drivers():
    """``_load_data`` with a token encoder: the same splits, token tables
    and dictionary as the JAX driver's."""
    kw = dict(model="fumi", dataset="synthetic", im_emb_dim=D,
              text_encoder="RNN", seed=3)
    got = cli_main._load_data(Config(**kw))
    want = jax_cli._load_data(JaxConfig(**kw))
    assert got[3] == want[3] == synthetic.synthetic_dictionary(128)
    np.testing.assert_array_equal(got[1], want[1])
    for name in ("train", "val", "test"):
        a, b = got[0][name], want[0][name]
        assert a.text_features.dtype == np.int32 and a.text_is_tokens
        np.testing.assert_array_equal(a.text_features, b.text_features)
        np.testing.assert_array_equal(a.class_image_rows,
                                      b.class_image_rows)


@pytest.mark.parametrize("model,encoder", [("fumi", "RNN"),
                                           ("am3", "glove")])
def test_driver_runs_token_encoders_on_the_cpu(tmp_path, model, encoder):
    """``cli.main`` end to end: a finite TEST line, ``vocab.json`` beside
    ``config.json`` (the synthetic dictionary), and ``--evaluate
    --checkpoint`` reproducing the test metrics."""
    import glob
    import os
    argv = ["--model", model, "--dataset", "synthetic", "--text_encoder",
            encoder, "--im_emb_dim", str(D), "--text_emb_dim", str(W),
            "--im_hid_dim", "16", "8", "--text_hid_dim", "8",
            "--prototype_dim", "8", "--num_ways", str(N), "--batch_size",
            "2", "--epochs", "2", "--eval_freq", "1", "--num_ep_test", "4",
            "--num_train_adapt_steps", "1", "--num_test_adapt_steps", "2",
            "--seed", "0", "--wandb_offline", "--disable_cuda"]
    out = cli_main.cli(argv + ["--log_dir", str(tmp_path / "a")])
    assert all(np.isfinite(v) for v in out.values())
    (run,) = glob.glob(str(tmp_path / "a" / "runs" / "*"))
    with open(os.path.join(run, "vocab.json")) as f:
        assert json.load(f) == synthetic.synthetic_dictionary(128)
    again = cli_main.cli(argv + ["--log_dir", str(tmp_path / "b"),
                                 "--evaluate", "--checkpoint", run])
    assert again == out
