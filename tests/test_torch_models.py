"""The port's models and episodic math against the JAX package's, on the
same inputs (numpy, from a seed) and the same weights (carried over with
``fumi_tpu_torch.bridge``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fumi_tpu.models import mlp as jax_mlp
from fumi_tpu.models import text_encoders as jax_te
from fumi_tpu.models.fumi import FUMI as JaxFUMI
from fumi_tpu.ops import fewshot as jax_fewshot
from fumi_tpu_torch import bridge
from fumi_tpu_torch.models import mlp, text_encoders
from fumi_tpu_torch.models.fumi import FUMI
from fumi_tpu_torch.ops import fewshot

N, K, M, D, E, TH, H = 3, 2, 5, 16, 8, 8, (8, 8)
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def models(norm_hypernet, init_bias, encoder="precomputed"):
    kw = dict(n_way=N, im_emb_dim=D, im_hid_dim=H, text_emb_dim=E,
              text_hid_dim=TH, dropout_rate=0.25,
              norm_hypernet=norm_hypernet, fine_tune=False,
              init_bias=init_bias)
    jm = JaxFUMI(text_encoder=jax_te.make_text_encoder(
        encoder, jax.random.PRNGKey(1), E), **kw)
    tm = FUMI(text_encoder=text_encoders.make_text_encoder(
        encoder, torch.Generator().manual_seed(1), E), **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, params, bridge.params_from_jax(np_tree(params), "fumi",
                                                  device="cpu")


def task(seed, k=K):
    rng = np.random.RandomState(seed)
    text = rng.randn(N * k, E).astype(np.float32)
    y = rng.permutation(np.repeat(np.arange(N), k)).astype(np.int32)
    x = rng.randn(M, D).astype(np.float32)
    return text, y, x


@pytest.mark.parametrize("norm_hypernet,init_bias",
                         [(False, False), (True, False), (False, True)])
def test_fumi_get_hyper_params(norm_hypernet, init_bias):
    jm, tm, jp, tp = models(norm_hypernet, init_bias)
    text, y, _ = task(0)
    want = jm.get_hyper_params(jp, jnp.asarray(text), jnp.asarray(y),
                               rng=jax.random.PRNGKey(0))
    got = tm.get_hyper_params(tp, torch.from_numpy(text), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fumi_hyper_params_batched_equals_per_episode():
    """The written-out episode axis gives what vmap gives."""
    jm, tm, jp, tp = models(True, False)
    tasks = [task(s) for s in range(3)]
    text = np.stack([t[0] for t in tasks])
    y = np.stack([t[1] for t in tasks])
    want = jax.vmap(lambda a, b: jm.get_hyper_params(
        jp, a, b, rng=jax.random.PRNGKey(0)))(jnp.asarray(text),
                                               jnp.asarray(y))
    got = tm.get_hyper_params(tp, torch.from_numpy(text), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fumi_class_text_encoding_missing_class():
    """A class with no support sample takes row 0, as jnp.argmax does."""
    jm, tm, jp, tp = models(False, False)
    text, _, _ = task(1)
    y = np.zeros(N * K, np.int32)
    want = jm.class_text_encoding(jp, jnp.asarray(text), jnp.asarray(y),
                                  rng=jax.random.PRNGKey(0))
    got = tm.class_text_encoding(tp, torch.from_numpy(text),
                                 torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batched", [False, True])
def test_fumi_im_forward(batched):
    jm, tm, jp, tp = models(True, False)
    text, y, x = task(2)
    hyper = jm.get_hyper_params(jp, jnp.asarray(text), jnp.asarray(y),
                                rng=jax.random.PRNGKey(0))
    want = jm.im_forward(jp["im_net"], hyper, jnp.asarray(x),
                         rng=jax.random.PRNGKey(0), train=False)
    th = torch.from_numpy(np.array(hyper))
    tx = torch.from_numpy(x)
    if batched:
        th, tx = th[None].expand(2, -1, -1), tx[None].expand(2, -1, -1)
    got = tm.im_forward(tp, th, tx, train=False)
    got = got[1] if batched else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropout_only_in_training():
    from fumi_tpu_torch.models import layers
    _, tm, _, tp = models(False, False)
    x = torch.from_numpy(task(3)[2]) + 5.0
    assert torch.equal(layers.dropout(x, 0.25, False), x)
    y = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0 < int(kept.sum()) < x.numel()
    np.testing.assert_allclose(y[kept].numpy(), (x[kept] / 0.75).numpy(),
                               rtol=1e-6)
    # the image net drops out only when training
    gen = lambda: torch.Generator().manual_seed(0)
    assert torch.equal(tm.im_base(tp, x, train=False, gen=gen()),
                       tm.im_base(tp, x, train=False, gen=None))
    assert not torch.equal(tm.im_base(tp, x, train=True, gen=gen()),
                           tm.im_base(tp, x, train=False))


@pytest.mark.parametrize("hidden", [(8, 8), (8,), ()])
def test_maml_mlp_apply(hidden):
    params = jax_mlp.init(jax.random.PRNGKey(0), D, N, hidden)
    x = np.random.RandomState(4).randn(M, D).astype(np.float32)
    want = jax_mlp.apply(params, jnp.asarray(x))
    tp = bridge.params_from_jax(np_tree(params), "maml", device="cpu")
    got = mlp.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", ["maml", "fumi", "fumi_rand"])
def test_bridge_round_trip(family):
    if family == "maml":
        tree = np_tree(jax_mlp.init(jax.random.PRNGKey(0), D, N, H))
        fam = "maml"
    else:
        enc = "rand" if family == "fumi_rand" else "precomputed"
        tree = np_tree(models(False, False, enc)[2])
        fam = "fumi"
    back = bridge.params_to_numpy(
        bridge.params_from_jax(tree, fam, device="cpu"), fam)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_torch_linear_bounds():
    """Seeded init: nn.Linear's U(+-1/sqrt(fan_in)), deterministic."""
    a = mlp.init(torch.Generator().manual_seed(5), D, N, H)
    b = mlp.init(torch.Generator().manual_seed(5), D, N, H)
    for k in a:
        assert torch.equal(a[k], b[k])
    w = a["net.lin_0.weight"]
    assert w.shape == (H[0], D) and w.abs().max() <= 1 / np.sqrt(D)


def _fewshot_inputs(seed):
    rng = np.random.RandomState(seed)
    b, nk, q, p = 2, N * K, 4, 6
    return dict(im=rng.randn(b, nk, p).astype(np.float32),
                text=rng.randn(b, nk, p).astype(np.float32),
                lam=rng.rand(b, nk, 1).astype(np.float32),
                y=np.stack([rng.permutation(np.repeat(np.arange(N), K))
                            for _ in range(b)]).astype(np.int32),
                q=rng.randn(b, q, p).astype(np.float32),
                qy=rng.randint(0, N, (b, q)).astype(np.int32))


FEWSHOT_CASES = {
    "cross_entropy": lambda f, a: f.cross_entropy(a["q"][..., :N], a["qy"]),
    "get_prototypes": lambda f, a: f.get_prototypes(a["im"], a["text"],
                                                    a["lam"], a["y"], N),
    "prototype_logits": lambda f, a: f.prototype_logits(a["im"][:, :N],
                                                        a["q"]),
    "pairwise_sqdist": lambda f, a: f.pairwise_sqdist(a["im"][:, :N],
                                                      a["q"]),
    "prototypical_loss": lambda f, a: f.prototypical_loss(
        a["im"][:, :N], a["q"], a["qy"]),
    "get_num_samples": lambda f, a: f.get_num_samples(a["y"], N + 1),
    "matching_probs": lambda f, a: f.matching_probs(a["im"], a["y"],
                                                    a["q"], N),
}


@pytest.mark.parametrize("name", sorted(FEWSHOT_CASES))
def test_fewshot_op(name):
    a = _fewshot_inputs(7)
    want = FEWSHOT_CASES[name](jax_fewshot, {k: jnp.asarray(v)
                                             for k, v in a.items()})
    got = FEWSHOT_CASES[name](fewshot, {k: torch.from_numpy(v)
                                        for k, v in a.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predict_classes():
    a = _fewshot_inputs(8)
    want = jax_fewshot.predict_classes(jnp.asarray(a["im"][:, :N]),
                                       jnp.asarray(a["q"]))
    got = fewshot.predict_classes(torch.from_numpy(a["im"][:, :N]),
                                  torch.from_numpy(a["q"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
