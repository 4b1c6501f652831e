"""The port's 2-D engine (``fumi_tpu_torch/parallel/pjit_engine.py``) on
gloo CPU ranks against the JAX package's ``make_pjit_steps``: mp=2 (ranks
0-1 of the world) and dp=2 x mp=2 (all four), one Adam step and the eval
of its params on bridged weights and one JAX episode; the shard rule
against JAX's ``param_pspecs``; and the leaves the models read whole (a
token encoder's embedding table and its LSTM's recurrent weights) through
their gather, against the port's serial step.

Shapes: image 512 (the first layer's input is wide enough to shard), text
256 and text_hid 256 (the hypernetwork's layers shard too), im_hid
(16, 8), 3-way 2-shot, B=4, dropout 0. Tolerances: params at rtol 2e-4,
atol 1e-5; the loss within 1e-5; eval ``preds`` equal.

One world of four ranks computes every case; the rank function sits at
the top of this module, which imports JAX only inside its fixtures and
tests.
"""

import sys

import numpy as np
import pytest
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.parallel.launch import spawn_world

IM, TXT, B = 512, 256, 4
MESHES = [(1, 2), (2, 2)]
MODELS = ["maml", "fumi"]
TOL = dict(rtol=2e-4, atol=1e-5)


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=IM,
             text_emb_dim=TXT, im_hid_dim=(16, 8), prototype_dim=16,
             text_hid_dim=256, num_ways=3, num_shots=2, num_shots_test=3,
             num_train_adapt_steps=2, num_test_adapt_steps=2, batch_size=B,
             lr=1e-2, optim="adam", dropout=0.0, text_encoder="precomputed",
             step_size=0.1, seed=0)
    d.update(kw)
    return d


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


def _token_case(episode):
    """A FuMI RNN config (two directions of 256: the recurrent weights
    shard; ``--fine_tune``, so their gather runs backward) and the episode
    with padded token text. SGD, so the params hold the gradient itself:
    Adam's first step divides each gradient entry by its own magnitude,
    and amplifies the rounding of entries near zero."""
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    cfg = Config(**cfg_kw("fumi", text_encoder="RNN", text_emb_dim=512,
                          fine_tune=True, optim="SGD"))
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, 32, size=episode.support_y.shape + (6,))
    tokens[..., 4:] = 0  # padding
    episode = episode._replace(
        support_text=torch.from_numpy(tokens.astype(np.int32)))
    return cfg, synthetic_dictionary(32), episode


def mp_rank(rank, cases):
    """The rank side: for each mesh, each case's step and eval on the
    2-D engine, and the FuMI RNN step beside the serial one."""
    from fumi_tpu_torch import bridge
    from fumi_tpu_torch.core.mesh import make_mesh
    from fumi_tpu_torch.parallel.pjit_engine import (make_pjit_steps,
                                                     param_pspecs)
    from fumi_tpu_torch.train.steps import make_steps
    out = {"jax_free": _jax_free()}
    for dp, mp in MESHES:
        mesh = make_mesh(dp, mp)
        if not mesh.member:
            continue
        for model, (params_np, episode_np) in cases.items():
            cfg = Config(**cfg_kw(model))
            params = bridge.params_from_jax(params_np, model, device="cpu")
            episode = bridge.episode_from_numpy(episode_np, device="cpu")
            st = make_pjit_steps(cfg, _gen(0), mesh, device="cpu")
            p, _, m = st.train_step(params, st.opt.init(params), episode,
                                    _gen(1))
            e = st.eval_step(p, episode, _gen(2))
            out[(dp, mp, model)] = dict(params=p, metrics=m, eval=e,
                                        specs=param_pspecs(params, mesh))
        cfg, dictionary, episode = _token_case(episode)
        st = make_pjit_steps(cfg, _gen(0), mesh, device="cpu",
                             dictionary=dictionary)
        ser = make_steps(cfg, _gen(0), device="cpu", dictionary=dictionary)
        p, _, m = st.train_step(st.params, st.opt.init(st.params), episode,
                                _gen(1))
        sp, _, sm = ser.train_step(ser.params, ser.opt.init(ser.params),
                                   episode, _gen(1))
        out[(dp, mp, "fumi RNN")] = dict(
            params=p, metrics=m, serial_params=sp, serial_metrics=sm,
            specs=param_pspecs(st.params, mesh))
    return out


@pytest.fixture(scope="module", autouse=True)
def threefry():
    """JAX's default key implementation pinned to threefry2x32 for the module,
    the old value restored after: the JAX package's `cli.main` sets the
    process-wide default to its ``--tpu_prng_impl`` (``rbg`` unless told),
    so without the pin the keys :func:`world` draws its weights and episode
    from, and with them the numbers compared, would depend on the test
    files an xdist worker ran before this one (under ``rbg`` the FuMI cases
    part from JAX by 5e-4 on 3 of 65,536 weights). Module-scoped and
    autouse, so it is in place before :func:`world` draws."""
    import jax
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)


@pytest.fixture(scope="module")
def world():
    import jax
    import jax.numpy as jnp
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
    from fumi_tpu.core.mesh import make_mesh
    from fumi_tpu.data import DeviceEpisodeSampler, synthetic_class_set
    from fumi_tpu.parallel.pjit_engine import make_pjit_steps, param_pspecs

    cs, table, ids = synthetic_class_set(num_classes=8, images_per_class=16,
                                         im_dim=IM, text_dim=TXT, seed=0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jax_out, cases = {}, {}
    for model in MODELS:
        jcfg = JaxConfig(**cfg_kw(model, prng_impl="threefry2x32"))
        smp = DeviceEpisodeSampler(
            jnp.asarray(table), jnp.asarray(ids), cs,
            JaxSpec(B, 3, 2, jcfg.num_query_train, IM, TXT))
        episode = jax.jit(smp.sample)(jax.random.PRNGKey(0))
        for dp, mp in MESHES:
            mesh = make_mesh(dp, mp)
            pj = make_pjit_steps(jcfg, jax.random.PRNGKey(0), mesh)
            rng = jax.random.PRNGKey(7)
            p, _, m = pj.train_step(pj.params, pj.opt.init(pj.params),
                                    episode, rng)
            e = pj.eval_step(p, episode, rng)
            jax_out[(dp, mp, model)] = dict(
                params=to_np(p), metrics=to_np(m), eval=to_np(e),
                specs=param_pspecs(pj.params, mesh))
            cases[model] = (to_np(pj.params), _plain(episode))
    ranks = spawn_world(mp_rank, 4, cases, use_cuda=False, threads=1)
    return jax_out, [r.value for r in ranks]


def _jax_leaves(port_tree, model):
    import jax
    from fumi_tpu_torch import bridge
    return jax.tree_util.tree_leaves(bridge.params_to_numpy(port_tree,
                                                            model))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xmp{m[1]}")
def test_2d_step_matches_jax(world, mesh, model):
    """One 2-D step and the eval of its params on every rank of the mesh:
    the JAX engine's."""
    import jax
    jax_out, ranks = world
    want = jax_out[mesh + (model,)]
    got_ranks = [r[mesh + (model,)] for r in ranks if mesh + (model,) in r]
    assert len(got_ranks) == mesh[0] * mesh[1]
    for got in got_ranks:
        for a, b in zip(_jax_leaves(got["params"], model),
                        jax.tree_util.tree_leaves(want["params"])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
        assert abs(float(got["metrics"]["loss"])
                   - float(want["metrics"]["loss"])) < 1e-5
        assert abs(float(got["eval"]["loss"])
                   - float(want["eval"]["loss"])) < 1e-5
        np.testing.assert_array_equal(got["eval"]["preds"].numpy(),
                                      want["eval"]["preds"])
        for k, v in got["params"].items():
            assert torch.equal(v, got_ranks[0]["params"][k])


@pytest.mark.parametrize("model", MODELS)
def test_param_pspecs_marks_the_jax_leaves(world, model):
    """The same leaves shard as under JAX's ``param_pspecs``: a leaf marked
    here maps (through the bridge's layout) onto a leaf JAX marks. The
    ranks imported no JAX."""
    import jax
    from jax.sharding import PartitionSpec as P
    from fumi_tpu_torch.parallel.pjit_engine import SHARDED
    jax_out, ranks = world
    for mesh in MESHES:
        specs = ranks[0][mesh + (model,)]["specs"]
        ones = {k: torch.full(tuple(v.shape), float(specs[k] == SHARDED))
                for k, v in ranks[0][mesh + (model,)]["params"].items()}
        got = [bool(np.all(a == 1.0)) for a in _jax_leaves(ones, model)]
        want = [s == P(None, "mp") for s in jax.tree_util.tree_leaves(
            jax_out[mesh + (model,)]["specs"],
            is_leaf=lambda x: isinstance(x, P))]
        assert got == want
        assert any(got)
    assert all(r["jax_free"] for r in ranks)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}xmp{m[1]}")
def test_token_encoder_leaves_read_whole(world, mesh):
    """FuMI with the RNN text encoder at 512: the embedding table (300
    wide) and the recurrent weights (1024 x 256) shard and enter the loss
    through their gather, the input projection through the row-parallel
    product; the step is the serial one's."""
    from fumi_tpu_torch.parallel.pjit_engine import SHARDED
    _, ranks = world
    for r in ranks:
        got = r.get(mesh + ("fumi RNN",))
        if got is None:
            continue
        sharded = {k for k, s in got["specs"].items() if s == SHARDED}
        assert {"text_encoder.embed.weight",
                "text_encoder.rnn.weight_hh_l0",
                "text_encoder.rnn.weight_ih_l0"} <= sharded
        for k, v in got["serial_params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       **TOL)
        assert abs(float(got["metrics"]["loss"])
                   - float(got["serial_metrics"]["loss"])) < 1e-5
