"""The port's dp-sharded batched request (``FewShotClassifier(...,
mesh=...)``) on two gloo CPU ranks against the JAX package's sharded
classifier on a 2-device mesh, and against the port's own unsharded
classifier.

Shapes: those of ``tests/test_serve.py`` (3-way 2-shot, D=16, E=8,
im_hid (8, 4), 4 adaptation steps); a request of R=3 episodes (padded to
4, two a rank) with M=5 queries (bucketed to 8); weights carried from the
JAX package with the bridge. Tolerance: rtol 2e-4, atol 1e-5, JAX's own
for its sharded classifier against the unsharded one
(``tests/test_serve.py``). The ranks' answers are bitwise equal to each
other.

One world computes every case. The rank function sits at the top of this
module, which imports JAX only inside its fixtures and tests, so a rank
never imports JAX.
"""

import sys

import numpy as np
import pytest
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.mesh import Mesh, episode_shard
from fumi_tpu_torch.parallel.launch import spawn_world
from fumi_tpu_torch.serve import (FewShotClassifier, _prep_batched_request,
                                  episode_seed)

N, K, Q, D, E = 3, 2, 5, 16, 8
R = 3
TOL = dict(rtol=2e-4, atol=1e-5)
JAX_MODELS = ["maml", "fumi", "am3"]
FUSED_MODELS = ["maml", "fumi"]
# the port against itself: dropout on, and the `rand` text encoder, whose
# noise is drawn from each episode's seed
SEED_CASES = {"dropout": dict(dropout=0.1),
              "rand": dict(dropout=0.1, text_encoder="rand")}
SEED = 7


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 4), prototype_dim=8, text_hid_dim=8,
             num_ways=N, num_shots=K, num_shots_test=Q,
             num_train_adapt_steps=2, num_test_adapt_steps=4,
             batch_size=1, dropout=0.0, text_encoder="precomputed",
             step_size=0.1, prng_impl="threefry2x32", seed=0)
    d.update(kw)
    return d


def request(r=R, seed=11):
    rng = np.random.RandomState(seed)
    s_im = rng.randn(r, N * K, D).astype(np.float32)
    y = np.repeat(np.arange(N), K).astype(np.int32)
    s_y = np.stack([rng.permutation(y) for _ in range(r)])
    q_im = rng.randn(r, Q, D).astype(np.float32)
    s_tx = rng.randn(r, N * K, E).astype(np.float32)
    return s_im, s_y, q_im, s_tx


def _jax_free() -> bool:
    """Whether this process has imported neither JAX nor the JAX
    package."""
    return not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   or m == "fumi_tpu" or m.startswith("fumi_tpu.")
                   for m in sys.modules)


def serve_rank(rank, runs, req):
    """Each run's sharded request on this rank: ``runs`` maps a name to
    (config kwargs, state dict, mesh name, fused, seed). ``fused`` forces
    the fused-kernel branch (its wrapper runs the plain version on CPU
    tensors) and records the tasks of each ``fused_adapt`` call. Also the
    single-episode and stateful paths under a mesh, and a rank off a
    (1 x 1) mesh."""
    from fumi_tpu_torch.core.mesh import make_mesh
    from fumi_tpu_torch.ops import kernels
    meshes = {"dp2": make_mesh(2, 1), "mp2": make_mesh(1, 2),
              "one": make_mesh(1, 1)}
    s_im, s_y, q_im, s_tx = req
    out = {"jax_free": _jax_free()}
    applicable, fused_adapt = kernels.fused_adapt_applicable, \
        kernels.fused_adapt
    for name, (kw, params, mesh, fused, seed) in runs.items():
        calls = []

        def counted(*args):
            calls.append(args[6].shape[0])  # support_x's tasks
            return fused_adapt(*args)
        if fused:
            kernels.fused_adapt_applicable = lambda *a, **k: True
            kernels.fused_adapt = counted
        try:
            clf = FewShotClassifier(Config(**kw), params, device="cpu",
                                    mesh=meshes[mesh])
            out[name] = clf.episode_logits_batch(s_im, s_y, q_im,
                                                 support_text=s_tx,
                                                 seed=seed)
        finally:
            kernels.fused_adapt_applicable = applicable
            kernels.fused_adapt = fused_adapt
        out[name + " fused calls"] = calls
    kw, params = runs["dp2 fumi"][:2]
    clf = FewShotClassifier(Config(**kw), params, device="cpu",
                            mesh=meshes["dp2"])
    out["single"] = clf.episode_logits(s_im[0], s_y[0], q_im[0],
                                       support_text=s_tx[0])
    clf.adapt(s_im[1], s_tx[1], s_y[1])
    out["stateful"] = clf.logits(q_im[1])
    clf = FewShotClassifier(Config(**kw), params, device="cpu",
                            mesh=meshes["one"])
    try:
        out["off the mesh"] = clf.episode_logits_batch(
            s_im, s_y, q_im, support_text=s_tx).shape
    except ValueError as err:
        out["off the mesh"] = str(err)
    return out


@pytest.fixture(scope="module")
def world():
    """The JAX package's sharded answers, the port's unsharded ones in this
    process, and the two ranks' sharded ones, on the same weights and
    request."""
    import jax
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.core.mesh import make_mesh
    from fumi_tpu.serve import FewShotClassifier as JaxClassifier
    from fumi_tpu_torch import bridge

    req = request()
    s_im, s_y, q_im, s_tx = req
    jax_out, plain, runs = {}, {}, {}
    for model in JAX_MODELS:
        jc = JaxClassifier(JaxConfig(**cfg_kw(model)), None)
        tree = jax.tree_util.tree_map(np.asarray, jc.params)
        sharded = JaxClassifier(JaxConfig(**cfg_kw(model)), jc.params,
                                mesh=make_mesh(dp=2, mp=1))
        jax_out[model] = np.asarray(sharded.episode_logits_batch(
            s_im, s_y, q_im, support_text=s_tx))
        params = bridge.params_from_jax(tree, model, device="cpu")
        runs[f"dp2 {model}"] = (cfg_kw(model), params, "dp2", False, 0)
        if model in FUSED_MODELS:
            runs[f"dp2 fused {model}"] = (cfg_kw(model), params, "dp2",
                                          True, 0)
            runs[f"mp2 {model}"] = (cfg_kw(model), params, "mp2", False, 0)
            plain[model] = FewShotClassifier(
                Config(**cfg_kw(model)), params,
                device="cpu").episode_logits_batch(s_im, s_y, q_im,
                                                   support_text=s_tx)
    for case, kw in SEED_CASES.items():
        clf = FewShotClassifier(Config(**cfg_kw("fumi", **kw)),
                                device="cpu")
        plain[case] = clf.episode_logits_batch(s_im, s_y, q_im,
                                               support_text=s_tx, seed=SEED)
        runs[f"dp2 {case}"] = (cfg_kw("fumi", **kw), clf.params, "dp2",
                               False, SEED)
    ranks = spawn_world(serve_rank, 2, runs, req, use_cuda=False, threads=1)
    return jax_out, plain, [r.value for r in ranks], req


@pytest.mark.parametrize("model", JAX_MODELS)
def test_sharded_request_matches_jax(world, model):
    """dp=2: every rank's whole (R, M, N) answer is the JAX package's
    sharded classifier's (AM3 through the engine: it never reaches the
    fused kernel)."""
    jax_out, _, ranks, _ = world
    for r in ranks:
        got = r[f"dp2 {model}"]
        assert got.shape == (R, Q, N)
        np.testing.assert_allclose(got, jax_out[model], **TOL)


@pytest.mark.parametrize("model", FUSED_MODELS)
def test_fused_branch_under_a_mesh(world, model):
    """The fused branch stays on under a mesh: each rank calls
    ``fused_adapt`` once, on its two of the four padded episodes, and the
    answer is still JAX's."""
    jax_out, _, ranks, _ = world
    for r in ranks:
        assert r[f"dp2 fused {model} fused calls"] == [2]
        assert r[f"dp2 {model} fused calls"] == []
        np.testing.assert_allclose(r[f"dp2 fused {model}"], jax_out[model],
                                   **TOL)


@pytest.mark.parametrize("case", sorted(SEED_CASES))
def test_episode_seeds_survive_sharding(world, case):
    """FuMI at dropout 0.1, and with the `rand` encoder whose noise comes
    from each episode's seed: the sharded answer is the unsharded one, so
    episode r kept episode_seed(seed, r) on the rank that ran it."""
    _, plain, ranks, _ = world
    for r in ranks:
        np.testing.assert_allclose(r[f"dp2 {case}"], plain[case], **TOL)


def test_the_ranks_answer_bitwise_alike(world):
    _, _, (a, b), _ = world
    names = [k for k in a if isinstance(a[k], np.ndarray)]
    assert len(names) == 11  # 9 sharded requests, single, stateful
    for k in names:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("model", FUSED_MODELS)
def test_dp1_mp2_computes_the_whole_batch(world, model):
    """dp=1 x mp=2: one shard, repeated on both ranks of the mp row; each
    computes every episode, as the unsharded classifier does."""
    _, plain, ranks, _ = world
    for r in ranks:
        np.testing.assert_allclose(r[f"mp2 {model}"], plain[model], **TOL)


def test_single_episode_and_stateful_paths_ignore_the_mesh(world):
    """Under a dp=2 mesh ``episode_logits`` and ``adapt``/``logits`` run
    one episode on the rank alone: the unsharded batch's episodes 0 and
    1."""
    _, plain, ranks, _ = world
    for r in ranks:
        np.testing.assert_allclose(r["single"], plain["fumi"][0], **TOL)
        np.testing.assert_allclose(r["stateful"], plain["fumi"][1], **TOL)


def test_a_rank_off_the_mesh_is_refused(world):
    """A (1 x 1) mesh in a world of two: rank 0 serves alone, rank 1 is
    refused before any collective."""
    _, _, (a, b), _ = world
    assert a["off the mesh"] == (R, Q, N)
    assert b["off the mesh"] == ("rank 1 is not on the (1x1) mesh (its "
                                 "first 1 ranks serve a sharded request)")


def test_the_ranks_import_no_jax(world):
    _, _, ranks, _ = world
    assert all(r["jax_free"] for r in ranks)


@pytest.mark.parametrize("r,dp", [(1, 1), (3, 2), (3, 3), (5, 3), (8, 4)])
def test_padding_matches_jax(r, dp):
    """The padded R and M, and the padded arrays, of the port's
    ``_prep_batched_request(..., dp=)`` are JAX's; the port's seeds are
    episode_seed over the padded episodes."""
    import jax
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.serve import FewShotClassifier as JaxClassifier
    from fumi_tpu.serve import _prep_batched_request as jax_prep
    s_im, s_y, q_im, s_tx = request(r)
    jc = JaxClassifier(JaxConfig(**cfg_kw("fumi")), None)
    tc = FewShotClassifier(Config(**cfg_kw("fumi")), device="cpu")
    want = jax_prep(jc.cfg, jc._prep_text, s_im, s_y, q_im, s_tx,
                    jax.random.PRNGKey(0), dp=dp)
    got = _prep_batched_request(tc.cfg, tc._prep_text, s_im, s_y, q_im,
                                s_tx, SEED, dp=dp)
    assert got[:2] == want[:2] == (r, Q)
    for a, b in zip(got[2:6], want[2:6]):
        np.testing.assert_array_equal(a, np.asarray(b))
    r_pad = got[2].shape[0]
    assert r_pad % dp == 0 and r_pad == want[-1].shape[0]
    assert got[-1] == [episode_seed(SEED, i) for i in range(r_pad)]


@pytest.mark.parametrize("dp,mp", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_episode_shard_tiles_the_padded_request(dp, mp):
    """The grid's ranks cover the padded episodes once per mp index, in
    rank order; the ranks of an mp row hold the same rows."""
    r_pad = 8
    rows = {m: [] for m in range(mp)}
    for rank in range(dp * mp):
        mesh = Mesh(dp, mp, rank, None, None, None, False)
        part = episode_shard(mesh, r_pad)
        rows[mesh.mp_index].extend(range(r_pad)[part])
        assert part == episode_shard(
            Mesh(dp, mp, mesh.dp_index * mp, None, None, None, False), r_pad)
    assert all(v == list(range(r_pad)) for v in rows.values())


def test_episode_shard_refuses_an_indivisible_request():
    with pytest.raises(ValueError, match="padded episode count 6 not "
                                         "divisible by dp=4"):
        episode_shard(Mesh(4, 1, 0, None, None, None, False), 6)


@pytest.mark.parametrize("value", [[3.5, 1.0], 2.0])
def test_device_sync_matches_jax(value):
    """``device_sync`` on a vector and a 0-d tensor, and on a list, gives
    the JAX package's float."""
    import jax.numpy as jnp
    from fumi_tpu.utils.profiling import device_sync as jax_sync
    from fumi_tpu_torch.utils.profiling import device_sync
    want = jax_sync(jnp.asarray(value))
    assert isinstance(want, float)
    for v in (torch.tensor(value), np.asarray(value), value):
        got = device_sync(v)
        assert isinstance(got, float) and got == want
