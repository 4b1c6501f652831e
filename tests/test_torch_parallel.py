"""The port's episode-parallel engine (``fumi_tpu_torch/parallel/engine.py``)
on two gloo CPU ranks against the JAX package's ``make_parallel_steps`` on
a 2-device mesh, and against the port's own serial step.

Shapes: im_hid (16, 8), 3-way 2-shot, B=4, dropout 0, bridged weights and
one JAX episode. Tolerances: params after one Adam step at rtol 2e-4,
atol 1e-5 (JAX's own ``tests/test_parallel.py`` check); the loss within
1e-5; eval ``preds`` equal; AM3's prec/rec/f1 within 1e-6.

The ranks run in processes of their own (``parallel/launch.py``); one
world a module computes every case. The rank functions sit at the top of
this module, which imports JAX only inside its fixtures and tests, so a
rank never imports JAX.
"""

import sys

import numpy as np
import pytest
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.parallel.launch import spawn_world

IM, TXT, B = 32, 16, 4
MODELS = ["maml", "fumi", "am3"]
TOL = dict(rtol=2e-4, atol=1e-5)


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=IM,
             text_emb_dim=TXT, im_hid_dim=(16, 8), prototype_dim=16,
             text_hid_dim=16, num_ways=3, num_shots=2, num_shots_test=3,
             num_train_adapt_steps=2, num_test_adapt_steps=3, batch_size=B,
             lr=1e-2, optim="adam", dropout=0.0, text_encoder="precomputed",
             step_size=0.1, seed=0)
    d.update(kw)
    return d


def _sampler(cfg, batch=B):
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    from fumi_tpu_torch.data.synthetic import synthetic_class_set
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=16,
                                         im_dim=IM, text_dim=TXT, seed=0)
    return DeviceEpisodeSampler(
        table, ids, cs, EpisodeSpec(batch, 3, 2, cfg.num_query_train, IM,
                                    TXT), device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_free() -> bool:
    """Whether this process has imported neither JAX nor the JAX
    package."""
    return not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   or m == "fumi_tpu" or m.startswith("fumi_tpu.")
                   for m in sys.modules)


def _plain(jax_episode):
    """A JAX episode as the port's Episode with numpy leaves (a rank
    unpickles it without importing the JAX package)."""
    import jax
    from fumi_tpu_torch import bridge
    return bridge.episode_to_numpy(bridge.episode_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_episode), device="cpu"))


def dp_rank(rank, cases):
    """Every check's rank side, on a dp=2 mesh: the step and the eval on
    each case's weights and episode, the serial step beside it, a batch dp
    does not divide, the ranks' episodes, two chunks from one generator,
    and a chunk with --tpu_grad_accum 2 and --tpu_watch."""
    from fumi_tpu_torch import bridge
    from fumi_tpu_torch.core.mesh import make_mesh
    from fumi_tpu_torch.parallel.engine import (
        make_parallel_chunked_train, make_parallel_steps, rank_generator)
    from fumi_tpu_torch.train.steps import build_family, make_opt, make_steps
    mesh = make_mesh(2, 1)
    out = {"jax_free": _jax_free()}
    for model, (params_np, episode_np) in cases.items():
        cfg = Config(**cfg_kw(model))
        params = bridge.params_from_jax(params_np, model, device="cpu")
        episode = bridge.episode_from_numpy(episode_np, device="cpu")
        par = make_parallel_steps(cfg, _gen(0), mesh, device="cpu")
        p, _, m = par.train_step(params, par.opt.init(params), episode,
                                 _gen(1))
        e = par.eval_step(p, episode, _gen(2))
        ser = make_steps(cfg, _gen(0), device="cpu")
        sp, _, sm = ser.train_step(params, ser.opt.init(params), episode,
                                   _gen(1))
        se = ser.eval_step(sp, episode, _gen(2))
        out[model] = dict(params=p, metrics=m, eval=e, serial_params=sp,
                          serial_metrics=sm, serial_eval=se)
    try:
        make_parallel_steps(Config(**cfg_kw("maml", batch_size=3)), _gen(0),
                            mesh, device="cpu")
        out["indivisible"] = None
    except ValueError as err:
        out["indivisible"] = str(err)

    cfg = Config(**cfg_kw("fumi"))
    smp = _sampler(cfg)
    fam = build_family(cfg, _gen(0))
    opt = make_opt(cfg)
    out["episode_ids"] = _sampler(cfg, B // 2).sample(
        rank_generator(_gen(5), mesh)).support_ids
    chunks = []
    for accum, watch in ((1, False), (1, False), (2, True)):
        run = make_parallel_chunked_train(
            cfg.replace(grad_accum=accum), fam, opt, smp, mesh, 3,
            watch=watch)
        chunks.append(run(fam.params, opt.init(fam.params), _gen(7)))
    out["chunks"] = [(p, ms) for p, _, _, ms in chunks]
    return out


@pytest.fixture(scope="module")
def world():
    """The JAX package's dp=2 results and the two ranks' results on the
    same weights and episode."""
    import jax
    import jax.numpy as jnp
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
    from fumi_tpu.core.mesh import make_mesh, put_episode, put_replicated
    from fumi_tpu.data import DeviceEpisodeSampler, synthetic_class_set
    from fumi_tpu.parallel import make_parallel_steps

    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=16,
                                         im_dim=IM, text_dim=TXT, seed=0)
    mesh = make_mesh(dp=2, mp=1)
    jax_out, cases = {}, {}
    for model in MODELS:
        jcfg = JaxConfig(**cfg_kw(model, prng_impl="threefry2x32"))
        smp = DeviceEpisodeSampler(
            jnp.asarray(table), jnp.asarray(ids), cs,
            JaxSpec(B, 3, 2, jcfg.num_query_train, IM, TXT))
        episode = jax.jit(smp.sample)(jax.random.PRNGKey(0))
        par = make_parallel_steps(jcfg, jax.random.PRNGKey(0), mesh)
        rng = jax.random.PRNGKey(42)
        ep = put_episode(episode, mesh)
        p, _, m = par.train_step(put_replicated(par.params, mesh),
                                 put_replicated(par.opt.init(par.params),
                                                mesh), ep, rng)
        e = par.eval_step(p, ep, rng)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        jax_out[model] = dict(params=to_np(p), metrics=to_np(m),
                              eval=to_np(e))
        cases[model] = (to_np(par.params), _plain(episode))
    ranks = spawn_world(dp_rank, 2, cases, use_cuda=False, threads=1)
    return jax_out, [r.value for r in ranks]


def _close_params(port, jax_tree, model, **tol):
    import jax
    from fumi_tpu_torch import bridge
    got = jax.tree_util.tree_leaves(bridge.params_to_numpy(port, model))
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("model", MODELS)
def test_dp_step_matches_jax(world, model):
    """One dp=2 Adam step and the eval of its params: the JAX engine's."""
    jax_out, ranks = world
    want = jax_out[model]
    for r in ranks:
        got = r[model]
        _close_params(got["params"], want["params"], model, **TOL)
        assert abs(float(got["metrics"]["loss"])
                   - float(want["metrics"]["loss"])) < 1e-5
        np.testing.assert_allclose(float(got["metrics"]["grad_norm"]),
                                   float(want["metrics"]["grad_norm"]),
                                   rtol=2e-4)
        assert abs(float(got["eval"]["loss"])
                   - float(want["eval"]["loss"])) < 1e-5
        np.testing.assert_array_equal(got["eval"]["preds"].numpy(),
                                      want["eval"]["preds"])
        keys = ("acc", "prec", "rec", "f1") if model == "am3" else ("acc",)
        for k in keys:
            assert abs(float(got["eval"][k]) - float(want["eval"][k])) \
                < 1e-6, k


@pytest.mark.parametrize("model", MODELS)
def test_dp_step_matches_the_serial_step(world, model):
    """The same step against the port's serial step on the whole episode;
    the two ranks' params are bitwise equal."""
    _, ranks = world
    for r in ranks:
        got = r[model]
        for k, v in got["serial_params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       **TOL)
            assert torch.equal(got["params"][k], ranks[0][model]["params"][k])
        assert abs(float(got["metrics"]["loss"])
                   - float(got["serial_metrics"]["loss"])) < 1e-5
        np.testing.assert_array_equal(got["eval"]["preds"].numpy(),
                                      got["serial_eval"]["preds"].numpy())


def test_a_batch_dp_does_not_divide_raises(world):
    _, ranks = world
    for r in ranks:
        assert r["indivisible"] == "batch_size 3 not divisible by dp=2"


def test_the_ranks_import_no_jax(world):
    """The spawned ranks ran the engine without JAX or the JAX package."""
    _, ranks = world
    assert all(r["jax_free"] for r in ranks)


def test_ranks_draw_their_own_episodes_deterministically(world):
    """Each rank draws B/dp tasks of its own; two chunks from one
    generator are bitwise equal, on each rank and across the ranks."""
    _, ranks = world
    a, b = (r["episode_ids"] for r in ranks)
    assert a.shape == (B // 2, 6) and not torch.equal(a, b)
    for r in ranks:
        (p1, m1), (p2, m2), _ = r["chunks"]
        for k in p1:
            assert torch.equal(p1[k], p2[k])
            assert torch.equal(p1[k], ranks[0]["chunks"][0][0][k])
        assert torch.equal(m1["loss"], m2["loss"])


def test_grad_accum_and_watch_on_the_dp_chunk(world):
    """--tpu_grad_accum 2 micro-batches each rank's two tasks: the same
    episodes, the same params up to the order of the sums; --tpu_watch
    adds the histogram rows of the all-reduced gradient."""
    from fumi_tpu_torch.train.watch import NUM_BUCKETS, WATCH_METRIC_PREFIX
    _, ranks = world
    for r in ranks:
        (p1, m1), _, (p2, m2) = r["chunks"]
        for k in p1:
            np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), **TOL)
        np.testing.assert_allclose(m2["loss"].numpy(), m1["loss"].numpy(),
                                   rtol=1e-5)
        counts = [k for k in m2 if k.startswith(WATCH_METRIC_PREFIX)]
        assert counts and all(m2[k].shape == (1, NUM_BUCKETS)
                              for k in counts)
        assert not any(k.startswith(WATCH_METRIC_PREFIX) for k in m1)
