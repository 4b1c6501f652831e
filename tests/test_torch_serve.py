"""The port's FewShotClassifier against the JAX package's, on the CPU.

Same config, same weights (carried over with the bridge), same requests:
logits within 1e-4 and the same argmax, for FuMI and MAML, on every
request path. One case forces the port's fused-kernel branch on the CPU
(where the kernel's wrapper runs its plain version), so the fused glue is
held against JAX too.
"""

import numpy as np
import jax
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.ops import kernels
from fumi_tpu_torch.serve import (FewShotClassifier, RequestError,
                                  episode_seed, warmup)

N, K, Q, D, E = 3, 2, 5, 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["fumi", "maml"]


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 4), text_hid_dim=8, num_ways=N, num_shots=K,
             num_test_adapt_steps=10, step_size=0.1, dropout=0.0,
             text_encoder="precomputed", seed=0)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def pairs():
    """model -> (JAX classifier, port classifier on the same weights)."""
    out = {}
    for model in MODELS:
        jc = JaxClassifier(JaxConfig(**cfg_kw(model)), None)
        tree = jax.tree_util.tree_map(np.asarray, jc.params)
        params = bridge.params_from_jax(tree, model, device="cpu")
        out[model] = (jc, FewShotClassifier(Config(**cfg_kw(model)), params,
                                            device="cpu"))
    return out


def episode(seed, R=None):
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    s_im = rng.randn(*lead, N * K, D).astype(np.float32)
    s_tx = rng.randn(*lead, N * K, E).astype(np.float32)
    y = np.repeat(np.arange(N), K).astype(np.int32)
    s_y = y if R is None else np.stack([rng.permutation(y)
                                        for _ in range(R)])
    q_im = rng.randn(*lead, Q, D).astype(np.float32)
    return s_im, s_y, q_im, s_tx


def same(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("model", MODELS)
def test_episode_logits(pairs, model):
    jc, tc = pairs[model]
    s_im, s_y, q_im, s_tx = episode(0)
    same(tc.episode_logits(s_im, s_y, q_im, support_text=s_tx),
         jc.episode_logits(s_im, s_y, q_im, support_text=s_tx))


@pytest.mark.parametrize("model", MODELS)
def test_episode_logits_batch(pairs, model):
    """R=3 pads to the bucket of 4, M=5 to the bucket of 8."""
    jc, tc = pairs[model]
    s_im, s_y, q_im, s_tx = episode(1, R=3)
    got = tc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    assert got.shape == (3, Q, N)
    same(got, jc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx))


@pytest.mark.parametrize("model", MODELS)
def test_adapt_then_classify(pairs, model):
    jc, tc = pairs[model]
    s_im, s_y, q_im, s_tx = episode(2)
    jc.adapt(s_im, s_tx, s_y)
    tc.adapt(s_im, s_tx, s_y)
    same(tc.logits(q_im), jc.logits(q_im))
    np.testing.assert_array_equal(tc.classify(q_im), jc.classify(q_im))
    np.testing.assert_allclose(tc.classify(q_im, return_probs=True),
                               np.asarray(jc.classify(q_im,
                                                      return_probs=True)),
                               **TOL)


@pytest.mark.parametrize("model", MODELS)
def test_fused_branch_glue(pairs, model, monkeypatch):
    """Force the fused branch on the CPU: the wrapper runs the kernel's
    plain version, so the head split and per-task glue meet JAX's
    engine."""
    jc, tc = pairs[model]
    monkeypatch.setattr(kernels, "fused_adapt_applicable",
                        lambda *a, **k: True)
    fused = FewShotClassifier(tc.cfg, tc.params, device="cpu")
    s_im, s_y, q_im, s_tx = episode(3, R=3)
    same(fused.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx),
         jc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx))
    same(fused.episode_logits(s_im[0], s_y[0], q_im[0],
                              support_text=s_tx[0]),
         jc.episode_logits(s_im[0], s_y[0], q_im[0], support_text=s_tx[0]))
    assert kernels.fused_adapt.launches == 0  # no kernel on the CPU


REQUEST_ERRORS = {
    "label_too_high": lambda c, a: c.episode_logits(
        a[0], np.full(N * K, N, np.int32), a[2], support_text=a[3]),
    "label_negative": lambda c, a: c.episode_logits_batch(
        a[0][None], -np.ones((1, N * K), np.int32), a[2][None],
        support_text=a[3][None]),
    "adapt_label_out_of_range": lambda c, a: c.adapt(
        a[0], a[3], np.full(N * K, N + 2, np.int32)),
    "no_queries": lambda c, a: c.episode_logits(
        a[0], a[1], np.zeros((0, D), np.float32), support_text=a[3]),
    "no_queries_batch": lambda c, a: c.episode_logits_batch(
        a[0][None], a[1][None], np.zeros((1, 0, D), np.float32),
        support_text=a[3][None]),
    "no_episodes": lambda c, a: c.episode_logits_batch(
        np.zeros((0, N * K, D), np.float32), np.zeros((0, N * K), np.int32),
        np.zeros((0, Q, D), np.float32)),
}


@pytest.mark.parametrize("case", sorted(REQUEST_ERRORS))
def test_request_errors(pairs, case):
    """The same malformed requests raise RequestError on both sides."""
    jc, tc = pairs["fumi"]
    args = episode(4)
    with pytest.raises(RequestError):
        REQUEST_ERRORS[case](tc, args)
    with pytest.raises(ValueError):  # the JAX package's RequestError
        REQUEST_ERRORS[case](jc, args)


def test_classify_before_adapt():
    clf = FewShotClassifier(Config(**cfg_kw("maml")), device="cpu")
    with pytest.raises(RuntimeError):
        clf.classify(np.zeros((2, D), np.float32))


@pytest.mark.parametrize("kw", [
    # AM3, the raw-image backbones, bf16, iMAML, ANIL and the token
    # encoders serve since they were ported (tests/test_torch_raw_serve.py
    # serves raw and bf16 configs); CLIP serves through ClipRetrieval; a
    # seed sweep's run dir serves through SeedEnsemble
    # (tests/test_torch_seed_ensemble.py)
    dict(model="clip"), dict(seed_sweep=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_configs_raise(kw):
    if kw.get("model") != "clip":
        # a sweep's config serves one replica, as the JAX package's
        # FewShotClassifier does; an ensemble needs its stacked params
        from fumi_tpu_torch.serve import SeedEnsemble
        cfg = Config(**cfg_kw("fumi", **kw))
        assert FewShotClassifier(cfg, device="cpu").cfg.seed_sweep == 2
        with pytest.raises(ValueError, match="stacked"):
            SeedEnsemble(cfg, None, device="cpu")
        return
    # CLIP is no episodic family (the registry has none by that name): it
    # serves through ClipRetrieval, which the refusal names
    with pytest.raises(NotImplementedError, match="ClipRetrieval"):
        FewShotClassifier(Config(**cfg_kw(kw.pop("model"), **kw)),
                          device="cpu")


def test_checkpoint_loading_not_ported(pairs, tmp_path):
    """Run dirs of the port's driver load (tests/test_torch_serve_checkpoint
    .py), and since the import was ported so does a reference .pth.tar
    (tests/test_torch_interop.py): the classifier serves the file's
    weights; a file that does not load is a ``ValueError``."""
    from fumi_tpu_torch import interop
    clf = pairs["fumi"][1]
    good = str(tmp_path / "fumi.pth.tar")
    interop.export_torch_checkpoint(good, clf.params, "fumi")
    served = FewShotClassifier.from_checkpoint(good, Config(**cfg_kw("fumi")),
                                               device="cpu")
    assert all(torch.equal(served.params[k], v)
               for k, v in clf.params.items())
    ref = tmp_path / "best.pth.tar"
    ref.write_bytes(b"x")
    with pytest.raises(ValueError, match="not a loadable torch checkpoint"):
        FewShotClassifier.from_checkpoint(str(ref), Config(**cfg_kw("fumi")),
                                          device="cpu")
    with pytest.raises(ValueError, match="not a loadable torch checkpoint"):
        clf.reload(str(ref))


def test_rand_encoder_seeds_independent_of_bucket():
    """Episode r draws its text noise from episode_seed(seed, r), so the
    same episodes get the same answers in the R=4 and the R=8 bucket."""
    clf = FewShotClassifier(Config(**cfg_kw("fumi", text_encoder="rand")),
                            device="cpu")
    s_im, s_y, q_im, s_tx = episode(5, R=5)
    small = clf.episode_logits_batch(s_im[:3], s_y[:3], q_im[:3],
                                     support_text=s_tx[:3], seed=7)
    big = clf.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx,
                                   seed=7)
    np.testing.assert_allclose(small, big[:3], rtol=1e-6, atol=1e-6)
    other = clf.episode_logits_batch(s_im[:3], s_y[:3], q_im[:3],
                                     support_text=s_tx[:3], seed=8)
    assert not np.allclose(small, other)
    assert episode_seed(7, 2) != episode_seed(8, 2)


def test_warmup_keeps_a_live_state(pairs, capsys):
    _, tc = pairs["fumi"]
    clf = FewShotClassifier(tc.cfg, tc.params, device="cpu")
    s_im, s_y, q_im, s_tx = episode(6)
    clf.adapt(s_im, s_tx, s_y)
    before = clf.logits(q_im)
    warmup(clf, r_buckets=(1, 2), num_queries=(3, 5))
    np.testing.assert_array_equal(clf.logits(q_im), before)
    assert "episode path R=2 (M buckets [4, 8])" in capsys.readouterr().out
