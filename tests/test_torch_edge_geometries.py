"""The edge episode geometries of the JAX package's slow
``tests/test_edge_geometries.py`` in the port, against the JAX package, on
the CPU: 1-shot 5-way with 3 queries, 2-way 1-shot with a single query,
and 3-way 2-shot with a single query, each with one and two hidden
layers, at B=2 tasks, on bridged weights and the same episodes of the JAX
package's sampler.

Tolerances (fp32 on both sides, second order through other summation
orders): a meta-batch's loss within 1e-5 relative; the meta-gradient
within 1e-5 of the gradient's largest entry; ``episode_logits_batch`` at
R=3 within 1e-5 of the logits' largest entry, with the same argmax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import steps

B, IM, TX, R = 2, 16, 8, 3
REL = 1e-5
GEOMETRIES = [(5, 1, 3), (2, 1, 1), (3, 2, 1)]
HIDDEN = {"1-hidden": (8,), "2-hidden": (8, 8)}
# AM3, ProtoNet and MatchingNet embed through their own heads and read no
# --im_hid_dim: each runs once a geometry
CASES = [(m, h) for m in ("maml", "fumi") for h in HIDDEN] + \
    [(m, "1-hidden") for m in ("am3", "protonet", "matchingnet")]


def cfg_kw(model, n, k, q, hidden):
    return dict(model=model, dataset="synthetic", im_emb_dim=IM,
                text_emb_dim=TX, im_hid_dim=hidden, prototype_dim=8,
                text_hid_dim=8, num_ways=n, num_shots=k, num_shots_test=q,
                num_train_adapt_steps=1, num_test_adapt_steps=2,
                batch_size=B, dropout=0.0, text_encoder="precomputed",
                step_size=0.1, lr=1e-2, optim="adam",
                prng_impl="threefry2x32", seed=0)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_episode(n, k, q):
    """One meta-batch of the geometry from the JAX package's host sampler
    (its numpy backend: torchmeta's policy, no sampler to compile)."""
    cs, table, ids = synthetic_class_set(num_classes=max(n + 2, 6),
                                         images_per_class=k + q + 2,
                                         im_dim=IM, text_dim=TX, seed=0)
    smp = jax_sampler.HostEpisodeSampler(table, ids, cs,
                                         JaxSpec(B, n, k, q, IM, TX),
                                         seed=0, backend="numpy")
    return jax.tree_util.tree_map(jnp.asarray, smp.sample())


def assert_close_to_scale(got, want, rel=REL):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in w)
    for a, b in zip(g, w):
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=rel * scale)


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"N{n}K{k}Q{q}" for n, k, q in GEOMETRIES])
@pytest.mark.parametrize("model,hidden", CASES,
                         ids=[f"{m}-{h}" for m, h in CASES])
def test_meta_batch_loss_and_grad(model, geometry, hidden):
    """A meta-batch's training loss and its meta-gradient (second order
    for MAML and FuMI) against ``jax.value_and_grad`` of the JAX family."""
    kw = cfg_kw(model, *geometry, HIDDEN[hidden])
    jfam = jax_steps.build_family(JaxConfig(**kw), jax.random.PRNGKey(0))
    fam = steps.build_family(Config(**kw), torch.Generator().manual_seed(0))
    fam = fam._replace(params=bridge.params_from_jax(
        np_tree(jfam.params), model, device="cpu"))
    ep = jax_episode(*geometry)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        jfam.train_loss, has_aux=True))(jfam.params, ep,
                                        jax.random.PRNGKey(1))
    (loss, _), grads = steps.value_and_grad(
        fam, fam.params, bridge.episode_from_numpy(np_tree(ep),
                                                   device="cpu"), None)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=REL,
                               atol=0)
    assert_close_to_scale(bridge.params_to_numpy(grads, model), j_grads)


@pytest.mark.parametrize("hidden", list(HIDDEN), ids=list(HIDDEN))
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"N{n}K{k}Q{q}" for n, k, q in GEOMETRIES])
@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_served_batch_logits(model, geometry, hidden):
    """``episode_logits_batch`` of R=3 requests of the geometry (each its
    own label order) from both packages' classifiers on the same
    weights."""
    n, k, q = geometry
    kw = cfg_kw(model, n, k, q, HIDDEN[hidden])
    jc = JaxClassifier(JaxConfig(**kw), None)
    tc = FewShotClassifier(Config(**kw), bridge.params_from_jax(
        np_tree(jc.params), model, device="cpu"), device="cpu")
    rs = np.random.RandomState(sum(geometry) + len(HIDDEN[hidden]))
    y = np.repeat(np.arange(n), k).astype(np.int32)
    s_y = np.stack([rs.permutation(y) for _ in range(R)])
    s_im = rs.randn(R, n * k, IM).astype(np.float32)
    s_tx = rs.randn(R, n * k, TX).astype(np.float32)
    q_im = rs.randn(R, n * q, IM).astype(np.float32)
    want = np.asarray(jc.episode_logits_batch(s_im, s_y, q_im,
                                              support_text=s_tx))
    got = tc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    assert got.shape == want.shape == (R, n * q, n)
    assert_close_to_scale(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
