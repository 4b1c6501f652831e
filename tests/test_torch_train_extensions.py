"""The training extensions of the port (``--tpu_ema``,
``--tpu_skip_nonfinite``, ``--tpu_debug_nans``, resnet12's stage remat)
against the JAX package's, on the CPU.

Tolerances. The optimizer wrappers on a toy tree: the params and the EMA
to 1e-6 relative over 10 updates, as ``test_torch_train.py`` holds the
optimizers (XLA may fuse a product and a sum into one multiply-add where
torch rounds twice), the counters equal. Train steps of FuMI
and MAML on bridged weights: 1e-4, as ``test_torch_train.py`` holds them.
``--tpu_debug_nans`` and stage remat change no number: bitwise.
"""

import glob
import json
import os

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
from fumi_tpu.train import loop as jax_loop
from fumi_tpu.train import optim as jax_optim
from fumi_tpu.train import steps as jax_steps
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.models import resnet12
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import checkpoint, loop, optim, steps

B, N, K, Q, D, E = 2, 3, 2, 4, 32, 16
TOL = dict(rtol=1e-4, atol=1e-4)
# good (1) and non-finite (0) steps: a skip, a recovery, then four in a
# row, past max_consecutive_errors = 2, then recovery
PATTERN = (1, 0, 1, 0, 0, 0, 0, 1, 0, 1)


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, num_train_adapt_steps=2,
             num_test_adapt_steps=5, step_size=0.1, dropout=0.0,
             text_encoder="precomputed", seed=0, lr=1e-2)
    d.update(kw)
    return d


def toy_tree(rng):
    return {"text_encoder.w": rng.randn(3, 4).astype(np.float32),
            "net.w": rng.randn(4, 5).astype(np.float32),
            "net.b": rng.randn(5).astype(np.float32)}


def jax_toy(tree):
    """The toy tree in the JAX package's nesting (components at the top,
    so ``zero_updates_for_key("text_encoder")`` applies)."""
    return {"text_encoder": {"w": jnp.asarray(tree["text_encoder.w"])},
            "net": {"w": jnp.asarray(tree["net.w"]),
                    "b": jnp.asarray(tree["net.b"])}}


def flat(jtree):
    return {f"{c}.{k}": np.asarray(v) for c, sub in jtree.items()
            for k, v in sub.items()}


@pytest.mark.parametrize("kw", [
    dict(model="maml", optim="adam", ema=0.9, skip_nonfinite=2),
    dict(model="maml", optim="SGD", lr=0.1, ema=0.5, skip_nonfinite=2),
    dict(model="am3", optim="adamw_lin_schedule", num_warmup_steps=3,
         epochs=12, ema=0.99, skip_nonfinite=2),
    dict(model="fumi", text_encoder="rand", optim="adam", ema=0.9,
         skip_nonfinite=2),
], ids=["adam", "SGD", "am3-schedule", "fumi-frozen-encoder"])
def test_ema_and_skip_counters_match_optax(kw):
    """A run of good and non-finite steps through both packages'
    ``make_opt``: the params, the EMA, ``notfinite_count``,
    ``last_finite`` and ``total_notfinite`` after every step, including
    the steps past ``max_consecutive_errors`` where optax applies the
    update anyway and the NaNs reach the params."""
    kw = cfg_kw(**kw)
    j_opt = jax_steps.make_opt(JaxConfig(**kw))
    t_opt = steps.make_opt(Config(**kw))
    rng = np.random.RandomState(0)
    tree = toy_tree(rng)
    jp, tp = jax_toy(tree), {k: torch.from_numpy(v.copy())
                             for k, v in tree.items()}
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for i, good in enumerate(PATTERN):
        g = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in tree.items()}
        if not good:
            g["net.b"][2] = np.nan if i % 2 else np.inf
        ju, js = j_opt.update(jax_toy(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = t_opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts, tp)
        tp = optim.apply_updates(tp, tu)
        for got, want in ((tp, jp), (optim.find_ema(ts),
                                     jax_optim.find_ema(js))):
            for k, v in flat(want).items():
                np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6,
                                           atol=1e-7, err_msg=f"{i} {k}")
        for name in ("notfinite_count", "last_finite", "total_notfinite"):
            assert ts[name].item() == np.asarray(getattr(js, name)).item(), \
                (i, name)
    assert ts["total_notfinite"].item() == PATTERN.count(0)
    assert torch.isnan(tp["net.b"]).any()  # the update past the limit


def test_make_opt_chains_the_ema_after_the_optimizer_as_jax():
    """``apply_if_finite(chain(opt, params_ema(d)), n)``: the EMA is the
    chain's second link inside the skip wrapper, and the params move by
    the optimizer's update (the EMA does not replace the optimizer)."""
    cfg = Config(**cfg_kw("maml", optim="SGD", lr=0.5, ema=0.9,
                          skip_nonfinite=3))
    opt = steps.make_opt(cfg)
    p = {"w": torch.ones(2)}
    s = opt.init(p)
    assert set(s) == {"notfinite_count", "last_finite", "total_notfinite",
                      "inner_state"}
    assert set(s["inner_state"]) == {"0", "1"}
    assert set(s["inner_state"]["1"]) == {"ema"}
    assert set(s["inner_state"]["0"]) == {"trace"}
    u, s = opt.update({"w": torch.full((2,), 2.0)}, s, p)
    p2 = optim.apply_updates(p, u)
    # SGD with coupled L2 5e-4: p - 0.5 * (2 + 5e-4)
    assert torch.allclose(p2["w"], torch.full((2,), 1 - 0.5 * 2.0005),
                          rtol=0, atol=1e-6)
    assert torch.allclose(optim.find_ema(s)["w"], 0.9 * 1 + 0.1 * p2["w"],
                          rtol=0, atol=1e-6)
    assert optim.find_ema(steps.make_opt(Config(**cfg_kw("maml"))).init(p)) \
        is None
    chained = steps.make_opt(Config(**cfg_kw("maml", ema=0.9))).init(p)
    assert set(chained) == {"0", "1"} and isinstance(
        chained["0"]["count"], int)


@pytest.fixture(scope="module")
def episodes():
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    smp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                           jnp.asarray(ids), cs,
                                           JaxSpec(B, N, K, Q, D, E))
    return [smp.sample(jax.random.PRNGKey(i)) for i in range(3)]


def to_port(ep):
    return bridge.episode_from_numpy(jax.tree_util.tree_map(np.asarray, ep),
                                     device="cpu")


def with_nan(ep):
    im = np.array(ep.support_im)
    im[0, 1, 3] = np.nan
    return ep._replace(support_im=jnp.asarray(im))


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_ema_train_steps_match_jax(episodes, model):
    """Three train steps and a non-finite episode between them under
    ``--tpu_ema 0.9 --tpu_skip_nonfinite 3``: the params, the EMA
    (``eval_view``) and the counters against the JAX package's; the NaN
    episode leaves the params and the EMA bitwise as they were."""
    kw = cfg_kw(model, ema=0.9, skip_nonfinite=3)
    jcfg = JaxConfig(**kw)
    jfam = jax_steps.build_family(jcfg, jax.random.PRNGKey(0))
    cfg = Config(**kw)
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    fam = fam._replace(params=bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfam.params), model,
        device="cpu"))
    j_steps = jax_steps.steps_from_family(jfam, jax_steps.make_opt(jcfg))
    t_steps = steps.steps_from_family(fam, steps.make_opt(cfg))
    jp, js = j_steps.params, j_steps.opt.init(j_steps.params)
    tp, ts = t_steps.params, t_steps.opt.init(t_steps.params)
    eps = [episodes[0], with_nan(episodes[1]), episodes[1], episodes[2]]
    for i, ep in enumerate(eps):
        before = (dict(tp), dict(loop.eval_view(cfg, tp, ts)))
        jp, js, _ = j_steps.train_step(jp, js, ep, jax.random.PRNGKey(i))
        tp, ts, _ = t_steps.train_step(tp, ts, to_port(ep), None)
        if i == 1:
            for k in tp:
                assert torch.equal(tp[k], before[0][k])
                assert torch.equal(loop.eval_view(cfg, tp, ts)[k],
                                   before[1][k])
        assert ts["notfinite_count"].item() == int(js.notfinite_count)
        assert ts["total_notfinite"].item() == int(js.total_notfinite) \
            == (1 if i else 0)
    for got, want in ((tp, jp), (loop.eval_view(cfg, tp, ts),
                                 jax_loop.eval_view(jcfg, jp, js))):
        g = bridge.params_to_numpy(got, model)
        for a, b in zip(jax.tree_util.tree_leaves(g),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    ema = loop.eval_view(cfg, tp, ts)
    assert any(not torch.equal(ema[k], tp[k]) for k in tp)
    assert loop.eval_view(cfg.replace(ema=0.0), tp, ts) is tp


def small_argv(log_dir, model, *extra):
    return ["--model", model, "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "8", "8",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", str(Q), "--batch_size", str(B),
            "--num_ep_test", "4", "--epochs", "4", "--eval_freq", "2",
            "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "5",
            "--lr", "0.05", "--step_size", "0.1", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--log_dir", str(log_dir),
            *extra]


def test_eval_view_through_the_driver_and_serving(tmp_path):
    """A ``--tpu_ema`` run: its checkpoints hold the EMA, ``--evaluate
    --checkpoint`` tests the EMA (the training run's own test numbers),
    ``from_checkpoint`` serves it, and a restore without ``--tpu_ema``
    fails naming the flags the checkpoint was written with."""
    argv = small_argv(tmp_path / "train", "fumi", "--tpu_ema", "0.5",
                      "--tpu_skip_nonfinite", "2")
    trained = cli_main.cli(argv)
    (run,) = glob.glob(str(tmp_path / "train" / "runs" / "*"))
    cfg = config_from_args(argv)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    params, state, _ = checkpoint.load_checkpoint(
        run, st.params, st.opt.init(st.params))
    ema = optim.find_ema(state)
    assert ema is not None and any(not torch.equal(ema[k], params[k])
                                   for k in ema)
    evaluated = cli_main.cli(small_argv(
        tmp_path / "eval", "fumi", "--tpu_ema", "0.5",
        "--tpu_skip_nonfinite", "2", "--evaluate", "--checkpoint", run))
    assert evaluated == trained
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    for k in ema:
        assert torch.equal(clf.params[k], ema[k])
    with pytest.raises(ValueError, match="ema=0.5.*skip_nonfinite=2"):
        FewShotClassifier.from_checkpoint(run, cfg.replace(ema=0.0),
                                          device="cpu")


def test_skip_counters_go_on_after_a_checkpoint(tmp_path):
    cfg = Config(**cfg_kw("maml", ema=0.9, skip_nonfinite=5))
    opt = steps.make_opt(cfg)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    for g in (1.0, float("nan"), float("nan")):
        u, s = opt.update({"w": torch.full((3,), g)}, s, p)
        p = optim.apply_updates(p, u)
    checkpoint.save_checkpoint(str(tmp_path), p, s, 2, 1.0, is_best=True)
    p2, s2, _ = checkpoint.load_checkpoint(str(tmp_path), p, opt.init(p))
    assert s2["notfinite_count"].item() == 2
    assert s2["inner_state"]["0"]["count"].item() == 1
    u, s2 = opt.update({"w": torch.full((3,), float("inf"))}, s2, p2)
    assert s2["notfinite_count"].item() == 3
    assert s2["total_notfinite"].item() == 3
    assert not s2["last_finite"].item()


def nan_sampler(model):
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    table = table.copy()
    table[:, 0] = np.nan
    return sampler.DeviceEpisodeSampler(table, ids, cs,
                                        EpisodeSpec(B, N, K, Q, D, E),
                                        device="cpu")


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_debug_nans_raises_at_the_step_that_makes_a_nan(model):
    cfg = Config(**cfg_kw(model, debug_nans=True))
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    smp = nan_sampler(model)
    run = steps.make_chunked_train(st.family, st.opt, smp, 3,
                                   debug_nans=True)
    with pytest.raises(FloatingPointError,
                       match=r"train step 7 made a non-finite value in "
                             r"the loss"):
        run(st.params, st.opt.init(st.params), smp.generator(0),
            first_step=7)
    ep = smp.sample(smp.generator(1))
    with pytest.raises(FloatingPointError, match="train step 3 .*loss"):
        st.train_step(st.params, st.opt.init(st.params), ep, None, step=3)
    # without the flag the same step runs and returns NaNs
    plain = steps.make_steps(cfg.replace(debug_nans=False),
                             torch.Generator().manual_seed(0), device="cpu")
    _, _, m = plain.train_step(plain.params, plain.opt.init(plain.params),
                               ep, None)
    assert torch.isnan(m["loss"])


def test_debug_nans_names_the_first_non_finite_gradient():
    """A finite loss whose gradient overflows: the check names that
    gradient, in state-dict order."""
    loss = torch.tensor(1.0)
    grads = {"a.weight": torch.ones(2), "b.weight": torch.tensor(
        [1.0, float("inf")]), "c.weight": torch.tensor([float("nan")])}
    with pytest.raises(FloatingPointError,
                       match="step 4 .*the gradient of b.weight"):
        steps.check_finite(4, loss, grads, {"a.weight": torch.ones(2)})
    with pytest.raises(FloatingPointError, match="the param a.weight"):
        steps.check_finite(0, loss, {}, {"a.weight": torch.tensor(
            [float("nan")])})
    steps.check_finite(0, loss, {"a.weight": torch.ones(2)},
                       {"a.weight": torch.ones(2)})


def test_debug_nans_leaves_a_finite_run_bitwise(tmp_path):
    """The driver with and without ``--tpu_debug_nans``: the same test
    numbers and the same checkpointed params, bitwise."""
    out, params = {}, {}
    for flag in ((), ("--tpu_debug_nans",)):
        log = tmp_path / ("on" if flag else "off")
        out[flag] = cli_main.cli(small_argv(log, "maml", *flag))
        (run,) = glob.glob(str(log / "runs" / "*"))
        params[flag] = torch.load(os.path.join(run, "ckpt", "params.pt"),
                                  weights_only=True)
        with open(os.path.join(run, "config.json")) as f:
            assert json.load(f)["debug_nans"] == bool(flag)
    assert out[()] == out[("--tpu_debug_nans",)]
    for k, v in params[()].items():
        assert torch.equal(v, params[("--tpu_debug_nans",)][k])


def raw_episode(rs, b=2):
    im = torch.from_numpy(rs.rand(b, N * K, 16, 16, 3).astype(np.float32))
    q = torch.from_numpy(rs.rand(b, N * Q, 16, 16, 3).astype(np.float32))
    text = torch.from_numpy(rs.randn(b, N * K, E).astype(np.float32))
    y = torch.arange(N, dtype=torch.int32).repeat_interleave(K)
    qy = torch.arange(N, dtype=torch.int32).repeat_interleave(Q)
    from fumi_tpu_torch.core.episode import Episode
    return Episode(support_im=im, support_text=text, support_text_mask=None,
                   support_ids=torch.zeros(b, N * K, dtype=torch.int32),
                   support_y=y.repeat(b, 1), query_im=q,
                   query_ids=torch.zeros(b, N * Q, dtype=torch.int32),
                   query_y=qy.repeat(b, 1))


@pytest.mark.parametrize("model", ["maml", "fumi"])
def test_stage_remat_override_is_bitwise(model, monkeypatch):
    """``resnet12.STAGE_REMAT_OVERRIDE`` at a narrow resnet12: the loss
    and the meta-gradient bitwise equal to ``--tpu_remat auto`` without
    the override (whole-step remat) and to ``off``; the override replaces
    the step checkpointing."""
    kw = cfg_kw(model, im_encoder="resnet12", im_size=16,
                resnet12_channels=(4, 6, 8, 8), text_encoder="BERT",
                num_train_adapt_steps=2)
    ep = raw_episode(np.random.RandomState(0))
    out = {}
    for name, override, remat in (("stages", (True, False, True, True),
                                   "auto"), ("auto", None, "auto"),
                                  ("off", None, "off")):
        monkeypatch.setattr(resnet12, "STAGE_REMAT_OVERRIDE", override)
        cfg = Config(**kw, remat=remat)
        assert steps.resnet12_stage_remat(cfg) == (
            override if remat == "auto" else None)
        if override is not None:
            assert steps.remat_of(cfg) is None
        fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
        (loss, _), g = steps.value_and_grad(fam, fam.params, ep, None)
        out[name] = (loss, g)
    for name in ("auto", "off"):
        assert torch.equal(out["stages"][0], out[name][0])
        for k, v in out["stages"][1].items():
            assert torch.equal(v, out[name][1][k]), (name, k)
