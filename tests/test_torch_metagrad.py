"""The meta-gradient variants against the JAX package's, on the CPU, on
bridged weights and the same episodes: ANIL (``--tpu_adapt_params head``),
Reptile and iMAML (``--tpu_meta_grad reptile|imaml``) for MAML, and
iMAML for FuMI.

Tolerances: Reptile's loss and pseudo-gradient to 1e-6 (plain SGD steps
and a difference, no second-order chain). ANIL's and iMAML's losses and
meta-gradients to 1e-5 relative: the largest difference is at most 1e-5
of the largest magnitude of the whole meta-gradient (fp32 through a
second-order chain, or CG on HVPs, with different summation orders; a
leaf whose gradient is zero analytically, as FuMI's ``hyper_net.2.bias``
is under the softmax's shift invariance, holds only rounding noise). The CG stops each task at the
same iteration as ``jax.scipy.sparse.linalg.cg``. The families' train and
eval steps and served logits (to 1e-4 with the same argmax, as
``tests/test_torch_serve.py`` holds the other families) run through the
same functions.
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
from fumi_tpu.metalearn import implicit as jax_implicit
from fumi_tpu.metalearn import inner_loop as jax_inner
from fumi_tpu.metalearn import reptile as jax_reptile
from fumi_tpu.models import mlp as jax_mlp
from fumi_tpu.ops.fewshot import cross_entropy as jax_ce
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn import implicit, inner_loop, reptile
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.train import steps

B, N, K, Q, D, E = 3, 3, 2, 4, 16, 8
HID = (8, 4)
STEPS, STEP_SIZE, LAM, CG = 3, 0.1, 2.0, 5
REL = 1e-5

VARIANTS = {
    "anil": ("maml", dict(adapt_params="head")),
    "reptile": ("maml", dict(meta_grad="reptile")),
    "imaml-maml": ("maml", dict(meta_grad="imaml")),
    "imaml-fumi": ("fumi", dict(meta_grad="imaml")),
}


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=HID, text_hid_dim=8, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, num_train_adapt_steps=STEPS,
             num_test_adapt_steps=10, step_size=STEP_SIZE, dropout=0.0,
             text_encoder="precomputed", imaml_lambda=LAM,
             imaml_cg_iters=CG, lr=1e-3, seed=0)
    d.update(kw)
    return d


def families(variant, dictionary=None, **extra):
    """(JAX cfg, JAX family, port cfg, port family on the same weights)."""
    model, kw = VARIANTS[variant]
    jcfg = JaxConfig(**cfg_kw(model, **kw, **extra))
    jfam = jax_steps.build_family(jcfg, jax.random.PRNGKey(0), dictionary)
    cfg = Config(**cfg_kw(model, **kw, **extra))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0),
                             dictionary)
    tree = jax.tree_util.tree_map(np.asarray, jfam.params)
    return jcfg, jfam, cfg, fam._replace(
        params=bridge.params_from_jax(tree, model, device="cpu"))


@pytest.fixture(scope="module")
def jax_episodes():
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    return [smp.sample(jax.random.PRNGKey(i)) for i in range(3)]


def to_port(ep):
    return bridge.episode_from_numpy(jax.tree_util.tree_map(np.asarray, ep),
                                     device="cpu")


def rel_close(got, want, rel=REL):
    """Two trees of one structure: max |got - want| <= rel * max |want|,
    both maxima over every leaf."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    g = [np.asarray(a) for a in g]
    w = [np.asarray(b) for b in w]
    assert [a.shape for a in g] == [b.shape for b in w]
    scale = max(float(np.abs(b).max()) for b in w)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(g, w))
    assert diff <= rel * scale, (diff, scale)


def port_value_and_grad(loss_fn, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, aux = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), aux, grads


def check_aux(aux, j_aux):
    np.testing.assert_allclose(float(aux["acc"]), float(j_aux["acc"]),
                               atol=1e-6)
    np.testing.assert_array_equal(aux["preds"].numpy(),
                                  np.asarray(j_aux["preds"]))
    assert aux["preds"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the episode losses and their meta-gradients
# ---------------------------------------------------------------------------

def test_head_only_mask_marks_the_head():
    params = mlp.init(torch.Generator().manual_seed(0), D, N, HID)
    mask = inner_loop.head_only_mask(params)
    jmask = jax_inner.head_only_mask(jax_mlp.init(jax.random.PRNGKey(0), D,
                                                  N, HID))
    got = bridge.params_to_numpy({k: torch.tensor(float(v))
                                  for k, v in mask.items()}, "maml")
    want = jax.tree_util.tree_map(float, jmask)
    assert jax.tree_util.tree_map(float, got) == want
    # a raw backbone's explicit head (tests/test_torch_backbone_metalearn.py)
    assert inner_loop.head_only_mask({"convs.0.weight": torch.zeros(1),
                                      "head.weight": torch.zeros(2, 2)}) \
        == {"convs.0.weight": False, "head.weight": True}
    with pytest.raises(ValueError):
        inner_loop.head_only_mask({"convs.0.weight": torch.zeros(1)})


@pytest.mark.parametrize("first_order", [False, True])
def test_anil_loss_and_meta_grad(jax_episodes, first_order):
    _, jfam, _, fam = families("anil")
    ep = jax_episodes[0]
    apply_fn = functools.partial(jax_mlp.apply, compute_dtype=None)
    jmask = jax_inner.head_only_mask(jfam.params)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_inner.maml_episode_loss(
            apply_fn, p, ep, n_steps=STEPS, step_size=STEP_SIZE,
            first_order=first_order, adapt_mask=jmask),
        has_aux=True))(jfam.params)
    mask = inner_loop.head_only_mask(fam.params)
    loss, aux, grads = port_value_and_grad(
        lambda p: inner_loop.maml_episode_loss(
            mlp.apply, p, to_port(ep), n_steps=STEPS, step_size=STEP_SIZE,
            first_order=first_order, adapt_mask=mask), fam.params)
    rel_close(float(loss), float(j_loss))
    check_aux(aux, j_aux)
    rel_close(bridge.params_to_numpy(grads, "maml"), j_grads)


def test_anil_differs_from_full_adaptation(jax_episodes):
    """The mask changes the meta-gradient, so the test above holds the
    masked engine and not the plain one."""
    _, _, _, fam = families("anil")
    ep = to_port(jax_episodes[0])
    out = []
    for mask in (None, inner_loop.head_only_mask(fam.params)):
        _, _, g = port_value_and_grad(
            lambda p: inner_loop.maml_episode_loss(
                mlp.apply, p, ep, n_steps=STEPS, step_size=STEP_SIZE,
                first_order=False, adapt_mask=mask), fam.params)
        out.append(g["net.lin_0.weight"])
    assert float((out[0] - out[1]).abs().max()) > 1e-5


def test_reptile_loss_and_pseudo_gradient(jax_episodes):
    _, jfam, _, fam = families("reptile")
    ep = jax_episodes[1]
    apply_fn = functools.partial(jax_mlp.apply, compute_dtype=None)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_reptile.reptile_episode_loss(
            apply_fn, p, ep, n_steps=STEPS, step_size=STEP_SIZE),
        has_aux=True))(jfam.params)
    loss, aux, grads = port_value_and_grad(
        lambda p: reptile.reptile_episode_loss(
            mlp.apply, p, to_port(ep), n_steps=STEPS, step_size=STEP_SIZE),
        fam.params)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6,
                               atol=1e-6)
    check_aux(aux, j_aux)
    for a, b in zip(jax.tree_util.tree_leaves(
            bridge.params_to_numpy(grads, "maml")),
            jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_reptile_pseudo_gradient_is_the_mean_displacement(jax_episodes):
    """Its gradient is mean_t(θ − φ_t), φ_t the plain SGD adaptation of
    each task (JAX-free)."""
    _, _, _, fam = families("reptile")
    ep = to_port(jax_episodes[1])
    _, _, grads = port_value_and_grad(
        lambda p: reptile.reptile_episode_loss(
            mlp.apply, p, ep, n_steps=STEPS, step_size=STEP_SIZE),
        fam.params)
    phi = inner_loop.adapt(
        inner_loop.per_task(fam.params, fam.params.keys(), B),
        lambda p, s: inner_loop.task_cross_entropy(
            mlp.apply(p, ep.support_im), ep.support_y).sum(),
        STEPS, STEP_SIZE, differentiable=False)
    for k, g in grads.items():
        torch.testing.assert_close(
            g, (fam.params[k].unsqueeze(0) - phi[k]).mean(0),
            rtol=1e-6, atol=1e-7)


def test_imaml_maml_loss_and_meta_grad(jax_episodes):
    _, jfam, _, fam = families("imaml-maml")
    ep = jax_episodes[2]
    apply_fn = functools.partial(jax_mlp.apply, compute_dtype=None)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_implicit.imaml_episode_loss(
            apply_fn, p, ep, n_steps=STEPS, step_size=STEP_SIZE, lam=LAM,
            cg_iters=CG), has_aux=True))(jfam.params)
    loss, aux, grads = port_value_and_grad(
        lambda p: implicit.imaml_episode_loss(
            mlp.apply, p, to_port(ep), n_steps=STEPS, step_size=STEP_SIZE,
            lam=LAM, cg_iters=CG), fam.params)
    rel_close(float(loss), float(j_loss))
    check_aux(aux, j_aux)
    rel_close(bridge.params_to_numpy(grads, "maml"), j_grads)


def token_episode():
    """A JAX meta-batch with token text (6 ids a description from a
    vocabulary of 32) and its dictionary."""
    from fumi_tpu.data.synthetic import synthetic_dictionary
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_tokens=True,
                                         vocab_size=32, text_len=6)
    smp = jax_sampler.DeviceEpisodeSampler(
        jnp.asarray(table), jnp.asarray(ids), cs,
        JaxSpec(B, N, K, Q, D, 6, text_is_tokens=True))
    return smp.sample(jax.random.PRNGKey(5)), synthetic_dictionary(32)


@pytest.mark.parametrize("encoder,fine_tune", [
    ("precomputed", False), ("glove", False), ("glove", True)],
    ids=["precomputed", "glove-frozen", "glove-fine_tune"])
def test_imaml_fumi_loss_and_meta_grad(jax_episodes, encoder, fine_tune):
    """The pull-back through the hypernetwork, which reaches a token
    encoder's embedding table only under ``--fine_tune``."""
    ep, dictionary = (token_episode() if encoder == "glove"
                      else (jax_episodes[0], None))
    _, jfam, _, fam = families("imaml-fumi", dictionary,
                               text_encoder=encoder, fine_tune=fine_tune)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_implicit.imaml_fumi_episode_loss(
            jfam.model, p, ep, n_steps=STEPS, step_size=STEP_SIZE,
            rng=jax.random.PRNGKey(0), lam=LAM, cg_iters=CG),
        has_aux=True))(jfam.params)
    loss, aux, grads = port_value_and_grad(
        lambda p: implicit.imaml_fumi_episode_loss(
            fam.model, p, to_port(ep), n_steps=STEPS, step_size=STEP_SIZE,
            gen=None, lam=LAM, cg_iters=CG), fam.params)
    rel_close(float(loss), float(j_loss))
    check_aux(aux, j_aux)
    rel_close(bridge.params_to_numpy(grads, "fumi"), j_grads)
    assert set(grads) == set(fam.params)
    assert float(grads["hyper_net.0.weight"].abs().max()) > 0
    text = [g for k, g in grads.items() if k.startswith("text_encoder.")]
    assert bool(text) == (encoder == "glove")
    if text:
        assert (max(float(g.abs().max()) for g in text) > 0) == fine_tune


def _jax_cg_stops(solve, maxiter):
    """The iteration at which ``jax.scipy.sparse.linalg.cg`` stopped each
    task: the first budget whose answer the full budget repeats bitwise
    (a stopped task no longer moves, under ``vmap`` too)."""
    full = solve(maxiter)
    stops = [None] * len(full)
    for m in range(maxiter + 1):
        for t, x in enumerate(solve(m)):
            if stops[t] is None and np.array_equal(x, full[t]):
                stops[t] = m
        if None not in stops:
            return stops
    return stops  # pragma: no cover


def test_cg_stops_each_task_where_jax_does(jax_episodes):
    """Per-task CG on the proximal solutions of a small linear model: the
    tasks converge (to tol 1e-5) within the budget at their own
    iterations (task t's support images are scaled by 1 + t, which scales
    its Hessian), and the port stops each one where JAX does."""
    rng = np.random.RandomState(3)
    w = {"w": rng.randn(N, D).astype(np.float32) * 0.3,
         "b": rng.randn(N).astype(np.float32) * 0.1}

    def j_apply(p, x):
        return x @ p["w"].T + p["b"]

    def t_apply(p, x):
        return torch.matmul(x, p["w"].transpose(-1, -2)) + \
            p["b"].unsqueeze(-2)

    maxiter = 40
    ep = jax_episodes[0]
    scale = (1.0 + jnp.arange(B, dtype=jnp.float32))[:, None, None]
    ep = ep._replace(support_im=ep.support_im * scale)
    task = implicit.maml_implicit_task(t_apply, to_port(ep), n_steps=20,
                                       step_size=0.1, lam=LAM,
                                       cg_iters=maxiter)
    phi = task.solve({k: torch.from_numpy(v) for k, v in w.items()})
    _, iters = implicit.implicit_solution(task, phi)

    def one_task(s_x, s_y, q_x, q_y, m):
        jphi = jax_implicit.proximal_adapt(
            j_apply, {k: jnp.asarray(v) for k, v in w.items()}, s_x, s_y,
            n_steps=20, step_size=0.1, lam=LAM)
        v = jax.grad(lambda p: jax_ce(j_apply(p, q_x), q_y))(jphi)
        sgrad = jax.grad(lambda p: jax_ce(j_apply(p, s_x), s_y))

        def operator(x):
            _, hvp = jax.jvp(sgrad, (jphi,), (x,))
            return jax.tree_util.tree_map(lambda a, h: a + h / LAM, x, hvp)
        x = jax.scipy.sparse.linalg.cg(operator, v, maxiter=m)[0]
        return jnp.concatenate([jnp.ravel(x["w"]), x["b"]])

    @jax.jit
    def solve(m):  # the budget is traced: one program for every budget
        return jax.vmap(lambda *a: one_task(*a, m))(
            ep.support_im, ep.support_y, ep.query_im, ep.query_y)

    want = _jax_cg_stops(lambda m: np.asarray(solve(jnp.int32(m))), maxiter)
    assert iters.tolist() == want
    assert max(want) < maxiter and len(set(want)) > 1, want


def test_lambda_to_infinity_recovers_the_query_gradient():
    """λ→∞ pins φ* to θ, so the implicit gradient is the plain query
    gradient at θ (the inner lr keeps lr·λ < 2). JAX-free."""
    rng = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rng.randn(N, 6).astype(np.float32) * 0.3),
              "b": torch.from_numpy(rng.randn(N).astype(np.float32) * 0.1)}
    s_x = torch.from_numpy(rng.randn(1, N * 3, 6).astype(np.float32))
    s_y = torch.from_numpy(np.repeat(np.arange(N), 3)[None].astype(np.int32))
    q_x = torch.from_numpy(rng.randn(1, 12, 6).astype(np.float32))
    q_y = torch.from_numpy(rng.randint(0, N, (1, 12)).astype(np.int32))

    def apply_fn(p, x):
        return torch.matmul(x, p["w"].transpose(-1, -2)) + \
            p["b"].unsqueeze(-2)

    ep = Episode(support_im=s_x, support_text=None, support_text_mask=None,
                 support_ids=None, support_y=s_y, query_im=q_x,
                 query_ids=None, query_y=q_y)
    _, _, g = port_value_and_grad(
        lambda p: implicit.imaml_episode_loss(
            apply_fn, p, ep, n_steps=50, step_size=5e-5, lam=1e4,
            cg_iters=30), params)
    _, _, gq = port_value_and_grad(
        lambda p: (inner_loop.task_cross_entropy(apply_fn(p, q_x),
                                                 q_y).mean(), {}), params)
    for k in params:
        torch.testing.assert_close(g[k], gq[k], rtol=0.02, atol=2e-3)
