"""The port's meta-training and eval path against the JAX package's, on
the CPU, on bridged weights and the same episodes.

Tolerances: the meta-gradients, losses and parameter trajectories are fp32
on both sides with different summation orders through a second-order
chain: 1e-4. The optimizers alone are a few elementwise ops per update:
1e-6 over 5 updates. Predictions and metric key sets are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.metalearn import inner_loop as jax_inner
from fumi_tpu.models import mlp as jax_mlp
from fumi_tpu.train import optim as jax_optim
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.metalearn import inner_loop
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import kernels
from fumi_tpu_torch.train import optim, steps

B, N, K, Q, D, E = 2, 3, 2, 4, 64, 16
TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["fumi", "maml"]


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, num_train_adapt_steps=3,
             num_test_adapt_steps=10, step_size=0.1, dropout=0.0,
             text_encoder="precomputed", seed=0)
    d.update(kw)
    return d


def jax_family(model, **kw):
    cfg = JaxConfig(**cfg_kw(model, **kw))
    return cfg, jax_steps.build_family(cfg, jax.random.PRNGKey(0))


def port_family(model, jfam, **kw):
    """The port's family on the JAX family's weights."""
    cfg = Config(**cfg_kw(model, **kw))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(np.asarray, jfam.params)
    return cfg, fam._replace(params=bridge.params_from_jax(tree, model,
                                                           device="cpu"))


@pytest.fixture(scope="module")
def jax_episodes():
    """Three JAX meta-batches from the JAX device sampler."""
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    return [smp.sample(jax.random.PRNGKey(i)) for i in range(3)]


def to_port(ep):
    return bridge.episode_from_numpy(jax.tree_util.tree_map(np.asarray, ep),
                                     device="cpu")


def close_trees(got, want, **tol):
    """Leaf by leaf over two trees of the same structure."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# episode losses and meta-gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first_order", [False, True])
def test_maml_episode_loss_and_meta_grad(jax_episodes, first_order):
    _, jfam = jax_family("maml")
    _, fam = port_family("maml", jfam)
    ep = jax_episodes[0]
    apply_fn = functools.partial(jax_mlp.apply, compute_dtype=None)
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        lambda p: jax_inner.maml_episode_loss(
            apply_fn, p, ep, n_steps=3, step_size=0.1,
            first_order=first_order), has_aux=True)(jfam.params)

    leaves = {k: v.clone().requires_grad_() for k, v in fam.params.items()}
    loss, aux = inner_loop.maml_episode_loss(
        mlp.apply, leaves, to_port(ep), n_steps=3, step_size=0.1,
        first_order=first_order)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
    np.testing.assert_allclose(float(aux["acc"]), float(j_aux["acc"]),
                               atol=1e-6)
    np.testing.assert_array_equal(aux["preds"].numpy(),
                                  np.asarray(j_aux["preds"]))
    assert aux["preds"].dtype == torch.int32
    close_trees(bridge.params_to_numpy(grads, "maml"), j_grads, **TOL)


def test_first_order_differs_from_second_order(jax_episodes):
    """The two orders give different meta-gradients, so the test above
    holds each against its own JAX counterpart."""
    _, jfam = jax_family("maml")
    _, fam = port_family("maml", jfam)
    ep = to_port(jax_episodes[0])
    out = []
    for first_order in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in fam.params.items()}
        loss, _ = inner_loop.maml_episode_loss(
            mlp.apply, leaves, ep, n_steps=3, step_size=0.1,
            first_order=first_order)
        out.append(torch.autograd.grad(loss, leaves["net.lin_0.weight"])[0])
    assert float((out[0] - out[1]).abs().max()) > 1e-5


def test_fumi_episode_loss_and_meta_grad(jax_episodes):
    _, jfam = jax_family("fumi")
    _, fam = port_family("fumi", jfam)
    ep = jax_episodes[1]
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        lambda p: jax_inner.fumi_episode_loss(
            jfam.model, p, ep, n_steps=3, step_size=0.1,
            rng=jax.random.PRNGKey(0), train=True), has_aux=True)(jfam.params)

    leaves = {k: v.clone().requires_grad_() for k, v in fam.params.items()}
    loss, aux = inner_loop.fumi_episode_loss(
        fam.model, leaves, to_port(ep), n_steps=3, step_size=0.1, gen=None,
        train=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
    np.testing.assert_allclose(float(aux["acc"]), float(j_aux["acc"]),
                               atol=1e-6)
    np.testing.assert_array_equal(aux["preds"].numpy(),
                                  np.asarray(j_aux["preds"]))
    close_trees(bridge.params_to_numpy(grads, "fumi"), j_grads, **TOL)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMS = [("adam", {}), ("SGD", {}), ("adamw", {}),
          ("adamw_lin_schedule", dict(schedule_active=True)),
          ("adamw_lin_schedule", dict(schedule_active=False))]


@pytest.mark.parametrize("name,kw", OPTIMS,
                         ids=[f"{n}-{kw}" for n, kw in OPTIMS])
def test_optimizer_matches_optax(name, kw):
    """5 updates from the same params and gradients, to 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    args = dict(optim=name, lr=0.05, weight_decay=5e-4, momentum=0.9,
                num_warmup_steps=2, epochs=6, **kw)
    j_opt, t_opt = jax_optim.init_optim(**args), optim.init_optim(**args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        upd, js = j_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp)
        jp = optax.apply_updates(jp, upd)
        upd, ts = t_opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                               ts, tp)
        tp = optim.apply_updates(tp, upd)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def test_linear_warmup_schedule_matches():
    for warm, total in ((0, 5), (3, 10), (4, 4)):
        ours = optim.linear_warmup_schedule(0.1, warm, total)
        theirs = jax_optim.linear_warmup_schedule(0.1, warm, total)
        for step in range(total + 3):
            np.testing.assert_allclose(ours(step), float(theirs(step)),
                                       rtol=1e-6, atol=1e-9)


def test_zero_updates_for_key_matches():
    """Frozen ``text_encoder`` params do not move, even under coupled L2;
    the rest moves as the plain optimizer moves it."""
    rng = np.random.RandomState(1)
    enc = {"w": rng.randn(3, 3).astype(np.float32)}
    net = {"w": rng.randn(2, 3).astype(np.float32)}
    g_enc = {"w": rng.randn(3, 3).astype(np.float32)}
    g_net = {"w": rng.randn(2, 3).astype(np.float32)}
    j_opt = jax_optim.zero_updates_for_key(
        jax_optim.init_optim("adam", 0.1), "text_encoder")
    t_opt = optim.zero_updates_for_key(optim.init_optim("adam", 0.1),
                                       "text_encoder")
    jp = {"text_encoder": enc, "net": net}
    upd, _ = j_opt.update({"text_encoder": g_enc, "net": g_net},
                          j_opt.init(jp), jp)
    jp = optax.apply_updates(jp, upd)
    tp = {"text_encoder.w": torch.from_numpy(enc["w"]),
          "net.w": torch.from_numpy(net["w"])}
    upd, _ = t_opt.update({"text_encoder.w": torch.from_numpy(g_enc["w"]),
                           "net.w": torch.from_numpy(g_net["w"])},
                          t_opt.init(tp), tp)
    tp = optim.apply_updates(tp, upd)
    np.testing.assert_array_equal(tp["text_encoder.w"].numpy(), enc["w"])
    np.testing.assert_allclose(tp["net.w"].numpy(), np.asarray(jp["net"]["w"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,item", [(dict(ema=0.9), "item 10"),
                                     (dict(skip_nonfinite=3), "item 10")])
def test_unported_optimizer_wrappers_raise(kw, item):
    """The optimizer wrappers of ROADMAP.md item 10, which raised until
    they were ported: ``make_opt`` now wraps the optimizer as the JAX
    package's does, and one update of both agrees."""
    cfg = Config(**cfg_kw("fumi", **kw))
    t_opt = steps.make_opt(cfg)
    j_opt = jax_steps.make_opt(JaxConfig(**cfg_kw("fumi", **kw)))
    tp = {"w": torch.ones(3)}
    state = t_opt.init(tp)
    if "ema" in kw:
        assert set(state) == {"0", "1"} and set(state["1"]) == {"ema"}
    else:
        assert set(state) == {"notfinite_count", "last_finite",
                              "total_notfinite", "inner_state"}
    g = np.array([1.0, -2.0, 0.5], np.float32)
    upd, state = t_opt.update({"w": torch.from_numpy(g)}, state, tp)
    jp = {"w": jnp.ones(3)}
    j_upd, _ = j_opt.update({"w": jnp.asarray(g)}, j_opt.init(jp), jp)
    np.testing.assert_allclose(upd["w"].numpy(), np.asarray(j_upd["w"]),
                               rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("opt_kw", [dict(optim="adam", lr=1e-3),
                                    dict(optim="SGD", lr=0.1)],
                         ids=["adam", "SGD"])
def test_three_train_steps_match(jax_episodes, model, opt_kw):
    """3 train steps on the same episodes: params to 1e-4, the metric keys
    equal and their values to 1e-4 (the grad norms check the gradients
    themselves, which Adam's normalised steps would hide)."""
    jcfg, jfam = jax_family(model, **opt_kw)
    cfg, fam = port_family(model, jfam, **opt_kw)
    j_steps = jax_steps.steps_from_family(jfam, jax_steps.make_opt(jcfg))
    t_steps = steps.steps_from_family(fam, steps.make_opt(cfg))
    jp, js = j_steps.params, j_steps.opt.init(j_steps.params)
    tp, ts = t_steps.params, t_steps.opt.init(t_steps.params)
    for i, ep in enumerate(jax_episodes):
        jp, js, jm = j_steps.train_step(jp, js, ep, jax.random.PRNGKey(i))
        tp, ts, tm = t_steps.train_step(tp, ts, to_port(ep), None)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=k, **TOL)
    close_trees(bridge.params_to_numpy(tp, model), jp, **TOL)
    assert {"grad_norm/im_net", "grad_norm/hyper_net"} <= set(tm) \
        if model == "fumi" else {"grad_norm/layer0", "grad_norm/layer2"} \
        <= set(tm)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("fused", [False, True], ids=["engine", "fused"])
def test_eval_raw_matches(jax_episodes, model, fused, monkeypatch):
    """10 test-time steps; ``fused`` forces the port's fused-kernel branch
    (on the CPU the kernel's wrapper runs its plain version), held against
    the JAX engine."""
    _, jfam = jax_family(model)
    cfg, fam = port_family(model, jfam, pallas_fused_eval=fused)
    if fused:
        monkeypatch.setattr(kernels, "fused_adapt_applicable",
                            lambda *a: True)
    ep = jax_episodes[2]
    want = jfam.eval_finalize(jfam.eval_raw(jfam.params, ep,
                                            jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = fam.eval_finalize(fam.eval_raw(fam.params, to_port(ep), None))
    assert set(got) == set(want)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
    for k in ("preds", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_eval_keeps_no_outer_graph(jax_episodes):
    _, jfam = jax_family("fumi")
    _, fam = port_family("fumi", jfam)
    leaves = {k: v.clone().requires_grad_() for k, v in fam.params.items()}
    raw = fam.eval_raw(leaves, to_port(jax_episodes[0]), None)
    assert not raw["loss"].requires_grad


# ---------------------------------------------------------------------------
# chunked drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_chunked_drivers_metric_keys_and_shapes(model):
    kw = dict(num_train_adapt_steps=2, num_test_adapt_steps=2)
    jcfg, jfam = jax_family(model, **kw)
    cfg, fam = port_family(model, jfam, pallas_gather=True, **kw)
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    j_smp = jax_sampler.DeviceEpisodeSampler(
        jnp.asarray(table), jnp.asarray(ids), cs, JaxSpec(B, N, K, Q, D, E))
    t_smp = sampler.DeviceEpisodeSampler(table, ids, cs,
                                         EpisodeSpec(B, N, K, Q, D, E),
                                         use_pallas_gather=True, device="cpu")
    j_opt, t_opt = jax_steps.make_opt(jcfg), steps.make_opt(cfg)

    j_run = jax_steps.make_chunked_train(jfam, j_opt, j_smp, 2)
    *_, jm = j_run(jfam.params, j_opt.init(jfam.params),
                   jax.random.PRNGKey(1))
    t_run = steps.make_chunked_train(fam, t_opt, t_smp, 2)
    tp, _, gen, tm = t_run(fam.params, t_opt.init(fam.params),
                           t_smp.generator(1))
    assert set(tm) == set(jm)
    assert all(v.shape == (2,) and torch.isfinite(v).all()
               for v in tm.values())
    assert any(not torch.equal(tp[k], fam.params[k]) for k in tp)

    for collect in (False, True):
        _, je = jax_steps.make_chunked_eval(jfam, j_smp, collect)(
            jfam.params, jax.random.PRNGKey(2), 3)
        _, te = steps.make_chunked_eval(fam, t_smp, collect)(
            fam.params, gen, 3)
        assert set(te) == set(je)
        for k in te:
            assert tuple(te[k].shape) == tuple(np.shape(je[k])), k
            assert te[k].dtype == torch.from_numpy(np.array(je[k])).dtype, k


@pytest.mark.parametrize("kw", [dict(accum=2), dict(watch=True)])
def test_chunked_train_unported_options_raise(kw):
    """The options this test once saw rejected run since they were ported
    (tests/test_torch_grad_accum.py, tests/test_torch_watch.py): a chunk
    with ``accum=2`` ends within 1e-4 of the whole-batch chunk on the same
    episodes (dropout 0), one with ``watch=True`` bitwise equal to it, with
    one row of gradient counts a block of ``WATCH_STRIDE`` steps."""
    from fumi_tpu_torch.train import watch
    _, jfam = jax_family("maml")
    cfg, fam = port_family("maml", jfam)
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = sampler.DeviceEpisodeSampler(table, ids, cs,
                                       EpisodeSpec(B, N, K, Q, D, E),
                                       device="cpu")
    opt = steps.make_opt(cfg)
    n = watch.WATCH_STRIDE + 1
    outs = [steps.make_chunked_train(fam, opt, smp, n, **o)(
        fam.params, opt.init(fam.params), smp.generator(1))
        for o in ({}, kw)]
    (p0, _, _, m0), (p1, _, _, m1) = outs
    for k in p0:
        if kw.get("watch"):
            assert torch.equal(p0[k], p1[k]), k
        else:
            np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), **TOL)
    rows = {k: v for k, v in m1.items() if k.startswith("watch_counts/")}
    assert bool(rows) == bool(kw.get("watch"))
    assert all(v.shape == (1, watch.NUM_BUCKETS) for v in rows.values())
    assert m1["loss"].shape == m0["loss"].shape == (n,)


@pytest.mark.parametrize("kw,item", [
    # the meta-gradient variants, the bf16 policy and the raw-image
    # backbones build since they were ported (tests/test_torch_bf16.py,
    # tests/test_torch_backbone*.py); what the JAX package refuses too, and
    # a family nobody registered, still raise
    (dict(init_all_layers=True), "hypernet initialisation"),
    (dict(model="nope"), "not registered")])
def test_unported_configs_raise(kw, item):
    kw = {"model": "fumi", **kw}
    cfg = Config(**cfg_kw(**kw))
    with pytest.raises(NotImplementedError, match=item):
        steps.build_family(cfg, torch.Generator().manual_seed(0))
