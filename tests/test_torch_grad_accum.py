"""``--tpu_grad_accum`` in the port against the JAX package's, on the CPU.

``train/steps.py:accum_value_and_grad`` on bridged weights and the same
episode as ``fumi_tpu.train.steps.accum_value_and_grad``, for every
built-in family (dropout 0, so no forward noise): the loss, the
meta-gradient and the combined aux within 1e-4 (fp32 on both sides, the
micro-batches summed in other orders). The aux contract: ``conf`` summed,
scalars averaged, per-task leaves concatenated, a declared
``train_aux_reduce`` obeyed, and the ``ValueError``s of the JAX package.
``accum`` 2 and 4 against the whole batch in the port alone (1e-5); a
chunk of accumulated steps through ``--tpu_ema`` and
``--tpu_skip_nonfinite`` against the JAX package's (1e-4); and the driver
with and without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.train import steps

B, N, K, Q, D, E = 4, 3, 2, 3, 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["maml", "fumi", "am3", "protonet", "matchingnet"]


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
             num_train_adapt_steps=2, num_test_adapt_steps=2, step_size=0.1,
             dropout=0.0, text_encoder="precomputed", seed=0)
    d.update(kw)
    return d


def families(model, **kw):
    jfam = jax_steps.build_family(JaxConfig(**cfg_kw(model, **kw)),
                                  jax.random.PRNGKey(0))
    fam = steps.build_family(Config(**cfg_kw(model, **kw)),
                             torch.Generator().manual_seed(0))
    return jfam, fam._replace(params=bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfam.params), model,
        device="cpu"))


@pytest.fixture(scope="module")
def episode():
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    return smp.sample(jax.random.PRNGKey(3))


def to_port(ep):
    return bridge.episode_from_numpy(jax.tree_util.tree_map(np.asarray, ep),
                                     device="cpu")


@pytest.mark.parametrize("model", FAMILIES)
def test_accum_value_and_grad_matches_jax(episode, model):
    jfam, fam = families(model)
    (jl, jaux), jg = jax_steps.accum_value_and_grad(jfam, 2)(
        jfam.params, episode, jax.random.PRNGKey(0))
    (tl, taux), tg = steps.accum_value_and_grad(fam, 2)(
        fam.params, to_port(episode), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    got = jax.tree_util.tree_leaves(bridge.params_to_numpy(tg, model))
    want = jax.tree_util.tree_leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert set(taux) == set(jaux)
    for k in taux:
        assert tuple(taux[k].shape) == tuple(np.shape(jaux[k])), k
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)


@pytest.mark.parametrize("model,accum", [
    ("fumi", 2), ("fumi", 4), ("maml", 2), ("maml", 4), ("am3", 4)])
def test_accum_equals_the_whole_batch(episode, model, accum):
    """The mean over micro-batches is the meta-batch's loss and gradient;
    ``conf`` and ``preds`` are exactly the whole batch's."""
    _, fam = families(model)
    ep = to_port(episode)
    (l1, a1), g1 = steps.value_and_grad(fam, fam.params, ep, None)
    (l2, a2), g2 = steps.accum_value_and_grad(fam, accum)(fam.params, ep,
                                                          None)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in g1.values())
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
    assert set(a1) == set(a2)
    for k in ("conf", "preds"):
        if k in a1:
            assert torch.equal(a1[k], a2[k]), k
    for k in ("acc", "avg_lamda"):
        if k in a1:
            np.testing.assert_allclose(float(a2[k]), float(a1[k]),
                                       rtol=1e-6)


def with_aux(fam, name, value_fn, declared=None):
    def loss(p, ep, gen):
        out, aux = fam.train_loss(p, ep, gen)
        return out, dict(aux, **{name: value_fn(out)})
    return fam._replace(train_loss=loss, train_aux_reduce=declared)


def test_accum_aux_rule_and_its_errors(episode):
    """An undeclared leaf that is neither scalar, ``conf`` nor per-task
    raises naming it, as in the JAX package; a declared one is combined as
    declared; the rule's blind spot (a per-class leaf whose length equals
    B/accum is taken for per-task) stays as the JAX package documents it;
    an unknown reduction raises."""
    _, fam = families("fumi")
    ep = to_port(episode)
    bad = with_aux(fam, "per_class", lambda l: torch.zeros(N + 1),
                   dict(steps.TRAIN_AUX_REDUCE))
    with pytest.raises(ValueError, match="per_class"):
        steps.accum_value_and_grad(bad, 2)(fam.params, ep, None)
    jfam, _ = families("fumi")
    jbad = jfam._replace(train_loss=lambda p, e, k: (
        lambda out: (out[0], dict(out[1], per_class=jnp.zeros(N + 1))))(
            jfam.train_loss(p, e, k)))
    with pytest.raises(ValueError, match="per_class"):
        jax_steps.accum_value_and_grad(jbad, 2)(jfam.params, episode,
                                                jax.random.PRNGKey(0))
    # per-class of length B/accum = 2
    per_class = lambda l: torch.arange(2, dtype=torch.float32) * l
    ok = with_aux(fam, "per_class", per_class,
                  dict(steps.TRAIN_AUX_REDUCE, per_class="mean"))
    (_, aux), _ = steps.accum_value_and_grad(ok, 2)(fam.params, ep, None)
    assert tuple(aux["per_class"].shape) == (2,)
    blind = with_aux(fam, "per_class", per_class)
    (_, aux), _ = steps.accum_value_and_grad(blind, 2)(fam.params, ep, None)
    assert tuple(aux["per_class"].shape) == (B,)
    wrong = with_aux(fam, "per_class", per_class,
                     dict(steps.TRAIN_AUX_REDUCE, per_class="max"))
    with pytest.raises(ValueError, match="mean|sum|concat"):
        steps.accum_value_and_grad(wrong, 2)(fam.params, ep, None)
    assert steps.build_family(Config(**cfg_kw("am3")), torch.Generator()
                              ).train_aux_reduce == {
        "conf": "sum", "avg_lamda": "mean", "preds": "concat"}


def test_micro_generators_are_derived_and_leave_the_step_generator():
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    a = [torch.rand(3, generator=steps.micro_generator(gen, i))
         for i in range(3)]
    b = [torch.rand(3, generator=steps.micro_generator(gen, i))
         for i in range(3)]
    assert torch.equal(gen.get_state(), state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    torch.rand(1, generator=gen)
    assert not torch.equal(
        torch.rand(3, generator=steps.micro_generator(gen, 0)), a[0])
    assert steps.micro_generator(None, 0) is None


@pytest.mark.parametrize("kw,err", [
    (dict(grad_accum=3), ValueError), (dict(grad_accum=0), ValueError),
    (dict(grad_accum=2, device_sampler=False), NotImplementedError),
    (dict(grad_accum=2, mesh_mp=2), NotImplementedError)])
def test_accum_validation_matches_jax(kw, err):
    with pytest.raises(err):
        Config(**cfg_kw("fumi", **kw)).validate()
    with pytest.raises(err):
        JaxConfig(**cfg_kw("fumi", **kw)).validate()


def test_driver_with_accum(tmp_path):
    """The driver's TEST numbers with ``--tpu_grad_accum 2`` within 1e-4 of
    the same run without it (dropout 0: the same episodes)."""
    def run(sub, *extra):
        return cli_main.cli([
            "--model", "fumi", "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "8", "8",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", str(Q), "--batch_size", str(B),
            "--num_ep_test", "4", "--epochs", "6", "--eval_freq", "3",
            "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "3",
            "--lr", "0.05", "--step_size", "0.1", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--tpu_pallas_gather",
            "--log_dir", str(tmp_path / sub), *extra])
    whole, accum = run("whole"), run("accum", "--tpu_grad_accum", "2")
    assert set(whole) == set(accum)
    for k in whole:
        np.testing.assert_allclose(accum[k], whole[k], **TOL)


@pytest.fixture
def threefry():
    """JAX's default key impl as threefry2x32 for the test, so that the
    replayed key chain is well defined whatever a JAX driver run in this
    process set the default to (its ``--tpu_prng_impl``, ``rbg`` unless
    told)."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)


class Replay:
    """A sampler handing out fixed episodes in turn, whatever the
    generator."""

    def __init__(self, episodes):
        self.episodes, self.i = episodes, 0

    def sample(self, gen=None):
        self.i += 1
        return self.episodes[self.i - 1]


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_accumulated_chunk_through_the_optimizer_chain_matches_jax(
        model, threefry):
    """Three steps of ``make_chunked_train(accum=2)`` under ``--tpu_ema 0.9
    --tpu_skip_nonfinite 3`` against the JAX package's on its own episodes
    (its key chain replayed outside ``jit``): the params, the EMA and the
    per-step losses within 1e-4."""
    from fumi_tpu.train import loop as jax_loop
    from fumi_tpu_torch.train import loop
    kw = dict(ema=0.9, skip_nonfinite=3, lr=1e-2)
    jfam, fam = families(model, **kw)
    jcfg, cfg = JaxConfig(**cfg_kw(model, **kw)), Config(**cfg_kw(model,
                                                                  **kw))
    jopt, opt = jax_steps.make_opt(jcfg), steps.make_opt(cfg)
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    key = jax.random.PRNGKey(4)
    jp, js, _, jm = jax_steps.make_chunked_train(jfam, jopt, smp, 3,
                                                 accum=2)(
        jfam.params, jopt.init(jfam.params), key)
    episodes = []
    for _ in range(3):
        key, k_s, _ = jax.random.split(key, 3)
        episodes.append(to_port(smp.sample(k_s, smp.tables)))
    tp, ts, _, tm = steps.make_chunked_train(fam, opt, Replay(episodes), 3,
                                             accum=2)(
        fam.params, opt.init(fam.params), None)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    for got, want in ((tp, jp), (loop.eval_view(cfg, tp, ts),
                                 jax_loop.eval_view(jcfg, jp, js))):
        for a, b in zip(jax.tree_util.tree_leaves(
                bridge.params_to_numpy(got, model)),
                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert int(ts["total_notfinite"]) == int(js.total_notfinite) == 0
