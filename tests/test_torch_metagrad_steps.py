"""The meta-gradient variants' train and eval steps and their serving,
against the JAX package's on the CPU, on bridged weights: ANIL, Reptile
and iMAML for MAML, and iMAML for FuMI (``tests/test_torch_metagrad.py``
holds their episode losses and meta-gradients). Two Adam steps through
``train_step`` and the eval step to 1e-4; served logits to 1e-4 with the
same argmax, as ``tests/test_torch_serve.py`` holds the other families.
"""


import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
# the variants, their configs and weights, and the module-scoped episode
# fixture (a fixture imported into a module is the module's fixture)
from test_torch_metagrad import (VARIANTS, cfg_kw, families,  # noqa: E402
                                 jax_episodes, to_port)

from fumi_tpu.core.config import Config as JaxConfig  # noqa: E402
from fumi_tpu.serve import FewShotClassifier as JaxClassifier  # noqa: E402
from fumi_tpu.train import steps as jax_steps  # noqa: E402
from fumi_tpu_torch import bridge  # noqa: E402
from fumi_tpu_torch.core.config import Config  # noqa: E402
from fumi_tpu_torch.serve import FewShotClassifier  # noqa: E402
from fumi_tpu_torch.train import steps  # noqa: E402

N, K, D, E = 3, 2, 16, 8
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the families' steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_family_train_and_eval_match(jax_episodes, variant):
    """Two Adam steps through ``train_step`` on the same episodes (the
    metrics, the grad norms among them, and the params), then the eval
    step's loss, acc and predictions at 10 test-time steps."""
    jcfg, jfam, cfg, fam = families(variant)
    model = VARIANTS[variant][0]
    j_steps = jax_steps.steps_from_family(jfam, jax_steps.make_opt(jcfg))
    t_steps = steps.steps_from_family(fam, steps.make_opt(cfg))
    jp, js = j_steps.params, j_steps.opt.init(j_steps.params)
    tp, ts = t_steps.params, t_steps.opt.init(t_steps.params)
    for i, ep in enumerate(jax_episodes[:2]):
        jp, js, jm = j_steps.train_step(jp, js, ep, jax.random.PRNGKey(i))
        tp, ts, tm = t_steps.train_step(tp, ts, to_port(ep), None)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(
            bridge.params_to_numpy(tp, model)),
            jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    ep = jax_episodes[2]
    want = j_steps.eval_step(jp, ep, jax.random.PRNGKey(0))
    got = t_steps.eval_step(tp, to_port(ep), None)
    assert set(got) == set(want)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["preds"].numpy(),
                                  np.asarray(want["preds"]))


def test_reptile_evaluates_through_the_fused_branch(jax_episodes,
                                                     monkeypatch):
    """Reptile's test-time adaptation is plain full GD, so its eval takes
    the fused kernel's branch (on the CPU its wrapper runs the plain
    version), within 1e-4 of the JAX engine; iMAML and ANIL do not."""
    from fumi_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "fused_adapt_applicable", lambda *a: True)
    calls = []
    orig = kernels.fused_maml_adapt_batched
    monkeypatch.setattr(kernels, "fused_maml_adapt_batched",
                        lambda *a: calls.append(1) or orig(*a))
    for variant in ("reptile", "anil", "imaml-maml"):
        _, jfam, cfg, _ = families(variant)
        model, kw = VARIANTS[variant]
        cfg = cfg.replace(pallas_fused_eval=True)
        fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
        fam = fam._replace(params=bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jfam.params), model,
            device="cpu"))
        before = len(calls)
        ep = jax_episodes[2]
        want = jfam.eval_raw(jfam.params, ep, jax.random.PRNGKey(0))
        with torch.no_grad():
            got = fam.eval_raw(fam.params, to_port(ep), None)
        assert (len(calls) > before) == (variant == "reptile")
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["preds"].numpy(),
                                      np.asarray(want["preds"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_pair(variant):
    model, kw = VARIANTS[variant]
    jc = JaxClassifier(JaxConfig(**cfg_kw(model, **kw)), None)
    tree = jax.tree_util.tree_map(np.asarray, jc.params)
    return jc, FewShotClassifier(
        Config(**cfg_kw(model, **kw)),
        bridge.params_from_jax(tree, model, device="cpu"), device="cpu")


def request(seed, R=None):
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    s_im = rng.randn(*lead, N * K, D).astype(np.float32)
    s_tx = rng.randn(*lead, N * K, E).astype(np.float32)
    y = np.repeat(np.arange(N), K).astype(np.int32)
    s_y = y if R is None else np.stack([rng.permutation(y)
                                        for _ in range(R)])
    q_im = rng.randn(*lead, 5, D).astype(np.float32)
    return s_im, s_y, q_im, s_tx


def same(got, want):
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_served_logits_match(variant):
    """``episode_logits``, ``episode_logits_batch`` (R=3 in a bucket of 4)
    and ``adapt`` then ``logits``: the variant's own test-time adaptation
    (the masked steps, the proximal solve, plain GD) on both sides."""
    jc, tc = serve_pair(variant)
    s_im, s_y, q_im, s_tx = request(0)
    same(tc.episode_logits(s_im, s_y, q_im, support_text=s_tx),
         jc.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    b = request(1, R=3)
    same(tc.episode_logits_batch(b[0], b[1], b[2], support_text=b[3]),
         jc.episode_logits_batch(b[0], b[1], b[2], support_text=b[3]))
    tc.adapt(s_im, s_tx, s_y)
    jc.adapt(s_im, s_tx, s_y)
    same(tc.logits(q_im), jc.logits(q_im))


def test_served_variants_differ_from_plain_gd():
    """The masked and proximal engines answer differently from plain full
    GD on the same weights, so the test above holds each engine."""
    s_im, s_y, q_im, s_tx = request(0)
    plain = {}
    for model in ("maml", "fumi"):
        _, tc = serve_pair("imaml-" + model)
        clf = FewShotClassifier(tc.cfg.replace(meta_grad="explicit"),
                                tc.params, device="cpu")
        plain[model] = clf.episode_logits(s_im, s_y, q_im,
                                          support_text=s_tx)
    for variant in VARIANTS:
        if variant == "reptile":
            continue
        _, tc = serve_pair(variant)
        got = tc.episode_logits(s_im, s_y, q_im, support_text=s_tx)
        base = plain[VARIANTS[variant][0]]
        assert float(np.abs(got - base).max()) > 1e-4, variant
