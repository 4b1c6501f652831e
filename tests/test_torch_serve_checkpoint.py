"""Serving from a checkpoint, and the prototype families' serving, on the
CPU.

- ``FewShotClassifier.from_checkpoint`` on a run dir the port's driver
  wrote (``cli.main --disable_cuda``, each of the five families) answers
  with exactly the logits of a classifier built on ``load_checkpoint``'s
  params; ``reload(run, best=False)`` swaps in ``ckpt/`` without a rebuild
  and drops the adapted state, so ``classify`` raises until ``adapt``.
- AM3, ProtoNet and MatchingNet served by the port against
  ``fumi_tpu.serve.FewShotClassifier`` on bridged weights: every request
  path within 1e-4 with the same argmax (fp32 on both sides, summed in
  other orders). AM3 serves with BERT (identity) text, and with the
  ``rand`` encoder at λ fixed to 1, where its noise does not enter.
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.data.synthetic import synthetic_dictionary
from fumi_tpu_torch.serve import FewShotClassifier, serving_dictionary
from fumi_tpu_torch.train import checkpoint, steps

N, K, Q, D, E = 3, 2, 5, 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)
ALL = ["fumi", "maml", "am3", "protonet", "matchingnet"]


def driver_argv(log_dir, model):
    return ["--model", model, "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--prototype_dim", "8",
            "--im_hid_dim", "8", "4", "--text_hid_dim", "8", "--num_ways",
            str(N), "--num_shots", str(K), "--num_shots_test", "3",
            "--batch_size", "2", "--num_ep_test", "4", "--epochs", "4",
            "--eval_freq", "2", "--num_train_adapt_steps", "2",
            "--num_test_adapt_steps", "5", "--lr", "0.05", "--step_size",
            "0.1", "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--log_dir", str(log_dir)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """model -> (config, run dir) of a run the port's driver wrote."""
    out = {}
    for model in ALL:
        log_dir = tmp_path_factory.mktemp(model)
        argv = driver_argv(log_dir, model)
        cli_main.cli(argv)
        (run,) = glob.glob(os.path.join(str(log_dir), "runs", "*"))
        out[model] = (config_from_args(argv), run)
    return out


def request(seed, text=True):
    rng = np.random.RandomState(seed)
    s_im = rng.randn(N * K, D).astype(np.float32)
    s_tx = rng.randn(N * K, E).astype(np.float32) if text else None
    s_y = rng.permutation(np.repeat(np.arange(N), K)).astype(np.int32)
    q_im = rng.randn(Q, D).astype(np.float32)
    return s_im, s_y, q_im, s_tx


def loaded_params(cfg, run, best):
    """The params ``load_checkpoint`` restores, on a fresh template."""
    st = steps.make_steps(cfg, torch.Generator().manual_seed(cfg.seed),
                          device="cpu")
    params, _, _ = checkpoint.load_checkpoint(run, st.params,
                                              st.opt.init(st.params),
                                              best=best)
    return params


@pytest.mark.parametrize("model", ALL)
def test_from_checkpoint_serves_the_loaded_params(runs, model):
    cfg, run = runs[model]
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    ref = FewShotClassifier(cfg, loaded_params(cfg, run, best=True),
                            device="cpu")
    fresh = FewShotClassifier(cfg, device="cpu")
    assert any(not torch.equal(clf.params[k], fresh.params[k])
               for k in clf.params)  # trained, not the seeded init
    s_im, s_y, q_im, s_tx = request(0)
    got = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    np.testing.assert_array_equal(
        got, ref.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    assert got.shape == (Q, N) and np.isfinite(got).all()
    batch = clf.episode_logits_batch(*(np.stack([a, a]) for a in
                                       (s_im, s_y, q_im, s_tx)))
    np.testing.assert_allclose(batch[1], got, rtol=1e-6, atol=1e-6)
    clf.adapt(s_im, s_tx, s_y)
    np.testing.assert_allclose(clf.logits(q_im), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ALL)
def test_reload_swaps_the_weights_and_drops_the_state(runs, model):
    cfg, run = runs[model]
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    s_im, s_y, q_im, s_tx = request(1)
    clf.adapt(s_im, s_tx, s_y)
    fn = clf._episode_fn
    clf.reload(run, best=False)
    with pytest.raises(RuntimeError, match="adapt"):
        clf.classify(q_im)
    ref = FewShotClassifier(cfg, loaded_params(cfg, run, best=False),
                            device="cpu")
    np.testing.assert_array_equal(
        clf.episode_logits(s_im, s_y, q_im, support_text=s_tx),
        ref.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    assert fn is None or clf._episode_fn is fn  # no rebuild
    clf.adapt(s_im, s_tx, s_y)
    assert clf.classify(q_im).shape == (Q,)


def test_reload_and_from_checkpoint_reject_what_is_not_ported(runs,
                                                              tmp_path):
    cfg, run = runs["fumi"]
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    ref = tmp_path / "best.pth.tar"
    ref.write_bytes(b"x")
    with pytest.raises(NotImplementedError, match="item 4b"):
        clf.reload(str(ref))
    with pytest.raises(ValueError, match="cannot restore"):
        clf.reload(str(tmp_path))  # no ckpt/ or best/
    assert serving_dictionary(cfg) is None
    # a token model's dictionary comes from vocab.json or the driver's
    # dataset; a dataset whose files are absent names them
    assert serving_dictionary(cfg.replace(text_encoder="glove"), run) == \
        synthetic_dictionary(128)
    with pytest.raises(FileNotFoundError, match="CUB"):
        serving_dictionary(cfg.replace(text_encoder="glove", dataset="cub",
                                       data_dir=str(tmp_path)))
    other = cfg.replace(im_hid_dim=(8, 8))  # the run was written at (8, 4)
    with pytest.raises(ValueError, match="cannot restore"):
        FewShotClassifier.from_checkpoint(run, other, device="cpu")


# ---------------------------------------------------------------------------
# the prototype families' serving against the JAX package's
# ---------------------------------------------------------------------------

SERVED = {"am3": dict(model="am3"), "protonet": dict(model="protonet"),
          "matchingnet": dict(model="matchingnet"),
          "am3-rand-lamda1": dict(model="am3", text_encoder="rand",
                                  lamda_fixed=1)}


def serve_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             prototype_dim=8, text_hid_dim=8, num_ways=N, num_shots=K,
             dropout=0.0, text_encoder="BERT", seed=0)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, kw in SERVED.items():
        jc = JaxClassifier(JaxConfig(**serve_kw(**kw)), None)
        params = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jc.params), kw["model"],
            device="cpu")
        out[name] = (jc, FewShotClassifier(Config(**serve_kw(**kw)), params,
                                           device="cpu"))
    return out


def same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_families_match_the_jax_classifier(pairs, name):
    jc, tc = pairs[name]
    s_im, s_y, q_im, s_tx = request(2)
    same(tc.episode_logits(s_im, s_y, q_im, support_text=s_tx),
         jc.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    rng = np.random.RandomState(3)
    R = 3  # pads to the bucket of 4; M=5 to 8
    b_im = rng.randn(R, N * K, D).astype(np.float32)
    b_tx = rng.randn(R, N * K, E).astype(np.float32)
    b_y = np.stack([rng.permutation(s_y) for _ in range(R)])
    b_q = rng.randn(R, Q, D).astype(np.float32)
    same(tc.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx),
         jc.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx))
    jc.adapt(s_im, s_tx, s_y)
    tc.adapt(s_im, s_tx, s_y)
    same(tc.logits(q_im), jc.logits(q_im))
    np.testing.assert_array_equal(tc.classify(q_im), jc.classify(q_im))
    np.testing.assert_allclose(tc.classify(q_im, return_probs=True),
                               np.asarray(jc.classify(q_im,
                                                      return_probs=True)),
                               **TOL)


def test_matchingnet_logits_are_log_probabilities(pairs):
    _, tc = pairs["matchingnet"]
    s_im, s_y, q_im, _ = request(4, text=False)
    probs = np.exp(tc.episode_logits(s_im, s_y, q_im))
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_am3_rand_noise_depends_on_the_episode_seed_only():
    """AM3's ``rand`` noise comes from episode r's own generator seed, so
    the same episodes answer the same in the R=4 and the R=8 bucket."""
    clf = FewShotClassifier(Config(**serve_kw("am3", text_encoder="rand")),
                            device="cpu")
    rng = np.random.RandomState(5)
    s_im = rng.randn(5, N * K, D).astype(np.float32)
    s_y = np.tile(np.repeat(np.arange(N), K), (5, 1)).astype(np.int32)
    q_im = rng.randn(5, Q, D).astype(np.float32)
    small = clf.episode_logits_batch(s_im[:3], s_y[:3], q_im[:3], seed=7)
    big = clf.episode_logits_batch(s_im, s_y, q_im, seed=7)
    np.testing.assert_allclose(small, big[:3], rtol=1e-6, atol=1e-6)
    other = clf.episode_logits_batch(s_im[:3], s_y[:3], q_im[:3], seed=8)
    assert not np.allclose(small, other)


# ---------------------------------------------------------------------------
# token text encoders served from the port's run dirs
# ---------------------------------------------------------------------------

TOKEN_RUNS = [("fumi", "RNN"), ("am3", "glove"), ("fumi", "w2v"),
              ("am3", "RNNhid")]


@pytest.fixture(scope="module")
def token_runs(tmp_path_factory):
    """(model, encoder) -> (config, run dir) of a token-encoder run the
    port's driver wrote, ``vocab.json`` included."""
    out = {}
    for model, enc in TOKEN_RUNS:
        log_dir = tmp_path_factory.mktemp(f"{model}-{enc}")
        argv = driver_argv(log_dir, model)
        argv[argv.index("precomputed")] = enc
        cli_main.cli(argv)
        (run,) = glob.glob(os.path.join(str(log_dir), "runs", "*"))
        out[(model, enc)] = (config_from_args(argv), run)
    return out


def token_request(seed, T=6):
    """A request whose support descriptions are token ids padded with PAD
    (0) to mixed lengths 1..T."""
    s_im, s_y, q_im, _ = request(seed)
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 128, size=(N * K, T))
    lengths = 1 + np.arange(N * K) % T
    s_tx = np.where(np.arange(T) < lengths[:, None], toks, 0).astype(
        np.int32)
    return s_im, s_y, q_im, s_tx


@pytest.mark.parametrize("model,enc", TOKEN_RUNS,
                         ids=[f"{m}-{e}" for m, e in TOKEN_RUNS])
def test_token_serving_from_a_run_dir_matches_the_jax_classifier(
        token_runs, model, enc):
    """``from_checkpoint`` rebuilds the encoder from the run's
    ``vocab.json``; every request path answers as
    ``fumi_tpu.serve.FewShotClassifier`` on the same weights and
    dictionary (1e-4, same argmax). A request without ``support_text``
    raises ``RequestError``; the warm-up's token-1 descriptions stay
    finite."""
    from fumi_tpu_torch.serve import RequestError, warmup
    cfg, run = token_runs[(model, enc)]
    vocab = serving_dictionary(cfg, run)
    assert vocab == synthetic_dictionary(128)
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    assert clf.text_is_tokens
    jc = JaxClassifier(JaxConfig(**dataclasses.asdict(cfg)),
                       bridge.params_to_numpy(clf.params, model), vocab)
    s_im, s_y, q_im, s_tx = token_request(6)
    same(clf.episode_logits(s_im, s_y, q_im, support_text=s_tx),
         jc.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    b = tuple(np.stack([a, a[::-1].copy()]) for a in (s_im, s_y, q_im,
                                                      s_tx))
    same(clf.episode_logits_batch(*b[:3], support_text=b[3]),
         jc.episode_logits_batch(*b[:3], support_text=b[3]))
    clf.adapt(s_im, s_tx, s_y)
    jc.adapt(s_im, s_tx, s_y)
    same(clf.logits(q_im), jc.logits(q_im))
    with pytest.raises(RequestError, match="support_text"):
        clf.episode_logits(s_im, s_y, q_im)
    warmup(clf)
    clf.reload(run, best=False)
    assert np.isfinite(clf.episode_logits(s_im, s_y, q_im,
                                          support_text=s_tx)).all()


@pytest.mark.parametrize("model,enc", TOKEN_RUNS[:2],
                         ids=[f"{m}-{e}" for m, e in TOKEN_RUNS[:2]])
def test_token_ids_outside_the_table_raise(token_runs, model, enc):
    """A token id outside the embedding table's rows [0, V) raises
    ``RequestError`` on every request path before the encoder sees it (on
    the card the lookup would fail the CUDA context); the next request
    answers bitwise as before."""
    from fumi_tpu_torch.serve import RequestError
    cfg, run = token_runs[(model, enc)]
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    s_im, s_y, q_im, s_tx = token_request(7)
    want = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    for bad_id in (128, -1, 2 ** 20):
        bad = s_tx.copy()
        bad[3, 0] = bad_id
        with pytest.raises(RequestError, match="token ids"):
            clf.episode_logits(s_im, s_y, q_im, support_text=bad)
        with pytest.raises(RequestError, match="token ids"):
            clf.episode_logits_batch(s_im[None], s_y[None], q_im[None],
                                     support_text=bad[None])
        with pytest.raises(RequestError, match="token ids"):
            clf.adapt(s_im, bad, s_y)
    np.testing.assert_array_equal(
        clf.episode_logits(s_im, s_y, q_im, support_text=s_tx), want)

