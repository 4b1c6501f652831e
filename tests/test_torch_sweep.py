"""``--tpu_seed_sweep`` in the port (``train/sweep.py``), on the CPU.

- A lockstep chunk against ``fumi_tpu.train.sweep.make_sweep_chunked_train``
  on bridged per-seed weights and JAX's own episodes (its key chain
  ``split(k_i, 3)`` replayed outside ``jit``), dropout 0, a mixed ``live``
  mask: params, Adam's moments and count, and the (steps, seeds) metrics
  per seed within 1e-4.
- Replica ``i`` bitwise the port's standalone chunk of seed ``seed+i`` (the
  seed's init, its generators; dropout and ``--augment`` on), also under
  ``--tpu_ema 0.999 --tpu_skip_nonfinite 3``; a frozen seed holds its
  params and optimizer state, counters included, while its generator
  advances as a live one's.
- ``--tpu_seed_accum`` G = 1, 2, 4 bitwise equal through the driver.
- ``export_seed_runs``' meta and config against the JAX package's for the
  same ``info`` (a seed that never improved included); the report against
  ``fumi_tpu.train.sweep.sweep_main``'s on the same per-seed numbers.
- The driver: the ``SWEEP TEST`` line, the keys, one CSV a seed, the
  ``seed<k>/`` run dirs read back to each seed's test numbers (and one
  exported as a ``.pth.tar``), replica 0 equal to a standalone ``--seed
  0`` run, and ``--tpu_auto_resume`` of an interrupted sweep equal to the
  uninterrupted one.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fumi_tpu.cli.main as jax_cli
from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.train import steps as jax_steps
from fumi_tpu.train import sweep as jax_sweep
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.serve import FewShotClassifier
from fumi_tpu_torch.train import checkpoint, loop, steps, sweep

B, N, K, Q, D, E = 2, 3, 2, 3, 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
             num_train_adapt_steps=2, num_test_adapt_steps=2, step_size=0.1,
             dropout=0.0, text_encoder="precomputed", seed=0, lr=1e-2,
             seed_sweep=3, prng_impl="threefry2x32")
    d.update(kw)
    return d


def tables():
    return synthetic_class_set(num_classes=10, images_per_class=12,
                               im_dim=D, text_dim=E, seed=0)


class Replay:
    """A sampler handing out fixed episodes in turn, whatever the
    generator."""

    def __init__(self, episodes):
        self.episodes, self.i = episodes, 0

    def sample(self, gen=None):
        ep = self.episodes[self.i]
        self.i += 1
        return ep


def adam_state(state):
    """The optax ScaleByAdamState inside a JAX optimizer state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = adam_state(s)
            if found is not None:
                return found
    return None


def leaves(tree, model):
    return jax.tree_util.tree_leaves(bridge.params_to_numpy(tree, model))


@pytest.fixture
def threefry():
    """JAX's default key impl as threefry2x32 for the test, as the JAX
    package's sweep tests run it (``--tpu_prng_impl``): the JAX driver sets
    the process-wide default to its flag, ``rbg`` unless told, and an
    ``rbg`` key draws other bits under ``vmap`` than in a loop, so the
    replayed chain would not be the vmapped program's."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)


@pytest.mark.parametrize("model", ["fumi", "maml"])
def test_sweep_chunk_matches_jax(model, threefry):
    n, S = 3, 3
    jcfg = JaxConfig(**cfg_kw(model))
    jfam = jax_sweep.build_sweep_family(jcfg)
    jopt = jax_steps.make_opt(jcfg)
    cs, table, ids = tables()
    jsmp = jax_sampler.DeviceEpisodeSampler(jnp.asarray(table),
                                            jnp.asarray(ids), cs,
                                            JaxSpec(B, N, K, Q, D, E))
    keys = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(S)])
    live = np.array([True, False, True])
    run = jax_sweep.make_sweep_chunked_train(jfam, jopt, jsmp, n)
    jp, js, _, jm = run(jfam.params, jax.vmap(jopt.init)(jfam.params), keys,
                        jnp.asarray(live))
    # the episodes the JAX program drew: steps outer, seeds inner
    episodes, ks = [], list(keys)
    for _ in range(n):
        for i in range(S):
            ks[i], k_s, _ = jax.random.split(ks[i], 3)
            ep = jsmp.sample(k_s, jsmp.tables)
            episodes.append(bridge.episode_from_numpy(
                jax.tree_util.tree_map(np.asarray, ep), device="cpu"))

    cfg = Config(**cfg_kw(model))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    opt = steps.make_opt(cfg)
    params = [bridge.params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x[i]), jfam.params), model, device="cpu")
        for i in range(S)]
    tp, ts, _, tm = sweep.make_sweep_chunked_train(
        fam, opt, Replay(episodes), n)(params, [opt.init(p) for p in params],
                                       [None] * S, live)
    ja = adam_state(js)
    for i in range(S):
        for tree, want in ((tp[i], jax.tree_util.tree_map(
                lambda x: x[i], jp)), (ts[i]["mu"], jax.tree_util.tree_map(
                    lambda x: x[i], ja.mu)), (ts[i]["nu"],
                                              jax.tree_util.tree_map(
                    lambda x: x[i], ja.nu))):
            got = leaves(tree, model)
            for a, b in zip(got, jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
        assert ts[i]["count"] == int(ja.count[i]) == (n if live[i] else 0)
    for k in ("loss", "acc", "grad_norm"):
        assert tuple(tm[k].shape) == (n, S) == np.shape(jm[k])
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL)
    for k, v in params[1].items():
        assert torch.equal(tp[1][k], v)  # the frozen seed held


def device_sampler(augment=0.0):
    cs, table, ids = tables()
    return sampler.DeviceEpisodeSampler(table, ids, cs,
                                        EpisodeSpec(B, N, K, Q, D, E),
                                        use_pallas_gather=True,
                                        augment_scale=augment, device="cpu")


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("extra", [
    {}, dict(ema=0.999, skip_nonfinite=3)], ids=["plain", "ema-skip"])
def test_replicas_are_bitwise_their_standalone_chunks(extra):
    n = 3
    cfg = Config(**cfg_kw("fumi", dropout=0.25, **extra))
    smp = device_sampler(augment=0.1)
    family = sweep.build_sweep_family(cfg, device="cpu")
    opt = steps.make_opt(cfg)
    seeds = sweep.sweep_seeds(cfg)
    params = [sweep.unstack_tree(family.params, i) for i in range(3)]
    gens = [loop.stream_generator(s, loop.TRAIN, 0, "cpu") for s in seeds]
    sp, ss, _, sm = sweep.make_sweep_chunked_train(family, opt, smp, n)(
        params, [opt.init(p) for p in params], gens, [True] * 3)
    for i, s in enumerate(seeds):
        st = steps.make_steps(cfg.replace(seed=s, seed_sweep=0),
                              torch.Generator().manual_seed(s), device="cpu")
        p, state, _, m = steps.make_chunked_train(st.family, st.opt, smp, n)(
            st.params, st.opt.init(st.params),
            loop.stream_generator(s, loop.TRAIN, 0, "cpu"))
        assert_trees_equal(sp[i], p)
        assert_trees_equal(ss[i], state)
        for k, v in m.items():
            assert torch.equal(sm[k][:, i], v), k


class Poisoned:
    """A sampler whose support images are NaN."""

    def __init__(self, base):
        self.base = base

    def sample(self, gen):
        ep = self.base.sample(gen)
        return ep._replace(support_im=torch.full_like(ep.support_im,
                                                      float("nan")))


def test_a_frozen_seed_holds_its_state_and_counters():
    n = 2
    cfg = Config(**cfg_kw("fumi", ema=0.999, skip_nonfinite=3))
    smp = Poisoned(device_sampler())
    family = sweep.build_sweep_family(cfg, device="cpu")
    opt = steps.make_opt(cfg)
    seeds = sweep.sweep_seeds(cfg)
    params = [sweep.unstack_tree(family.params, i) for i in range(3)]
    states = [opt.init(p) for p in params]
    out = {}
    for name, live in (("mixed", [True, False, True]), ("all", [True] * 3)):
        gens = [loop.stream_generator(s, loop.TRAIN, 0, "cpu")
                for s in seeds]
        out[name] = sweep.make_sweep_chunked_train(family, opt, smp, n)(
            params, states, gens, live)
    p, s, gens, _ = out["mixed"]
    assert_trees_equal(p[1], params[1])
    assert_trees_equal(s[1], states[1])
    assert int(s[1]["notfinite_count"]) == 0
    assert int(s[0]["notfinite_count"]) == int(s[2]["total_notfinite"]) == n
    assert torch.equal(gens[1].get_state(), out["all"][2][1].get_state())
    assert not torch.equal(gens[1].get_state(), loop.stream_generator(
        seeds[1], loop.TRAIN, 0, "cpu").get_state())


def test_stack_and_unstack_walk_the_optimizer_state():
    cfg = Config(**cfg_kw("maml", ema=0.9, skip_nonfinite=2))
    opt = steps.make_opt(cfg)
    family = sweep.build_sweep_family(cfg, device="cpu")
    params = [sweep.unstack_tree(family.params, i) for i in range(3)]
    states = [opt.init(p) for p in params]
    stacked = sweep.stack_trees(states)
    assert stacked["notfinite_count"].shape == (3,)
    inner = stacked["inner_state"]["0"]
    assert inner["count"] == [0, 0, 0] or tuple(inner["count"].shape) == (3,)
    for i in range(3):
        assert_trees_equal(sweep.unstack_tree(stacked, i), states[i])
    plain = steps.make_opt(Config(**cfg_kw("maml")))
    assert sweep.stack_trees([plain.init(p) for p in params])["count"] \
        == [0, 0, 0]


def test_export_seed_runs_meta_equals_jax(tmp_path):
    seeds = [0, 1, 2]
    info = {"best_loss": np.array([0.5, 0.7, 0.6]),
            "best_batch_idx": np.array([4, 0, 8]), "batch_idx": 12,
            "ever_improved": np.array([True, False, True]),
            "selection": "best"}
    kw = cfg_kw("fumi")
    jcfg = JaxConfig(**kw)
    jfam = jax_sweep.build_sweep_family(jcfg)
    jopt = jax_steps.make_opt(jcfg)
    jax_sweep.export_seed_runs(jcfg, str(tmp_path / "jax"), seeds,
                               jfam.params,
                               jax.vmap(jopt.init)(jfam.params), info)
    cfg = Config(**kw)
    fam = sweep.build_sweep_family(cfg, device="cpu")
    opt = steps.make_opt(cfg)
    states = sweep.stack_trees([opt.init(sweep.unstack_tree(fam.params, i))
                                for i in range(3)])
    sweep.export_seed_runs(cfg, str(tmp_path / "port"), seeds, fam.params,
                           states, info)
    for s in seeds:
        for name in ("ckpt.meta.json", "best.meta.json", "config.json"):
            got, want = (json.load(open(tmp_path / pkg / f"seed{s}" / name))
                         for pkg in ("port", "jax"))
            assert got == want, (s, name)
        meta = json.load(open(tmp_path / "port" / f"seed{s}" /
                              "best.meta.json"))
        assert meta.get("no_improvement", False) == (s == 1)
        assert meta["batch_idx"] == (12 if s == 1 else info[
            "best_batch_idx"][s])
        st = steps.make_steps(cfg.replace(seed=s, seed_sweep=0),
                              torch.Generator(), device="cpu")
        p, state, _ = checkpoint.load_checkpoint(
            str(tmp_path / "port" / f"seed{s}"), st.params,
            st.opt.init(st.params))
        assert_trees_equal(p, sweep.unstack_tree(fam.params, s))
        assert_trees_equal(state, sweep.unstack_tree(states, s))


def test_sweep_report_equals_jax_sweep_main(monkeypatch, tmp_path):
    rng = np.random.RandomState(0)
    per_seed = [{"loss": float(rng.rand()), "acc": float(rng.rand()),
                 "acc_ci95": float(rng.rand()), "preds": [1, 2]}
                for _ in range(4)]
    for name, value in (("build_sweep_family", lambda *a: None),
                        ("make_opt", lambda cfg: None),
                        ("sweep_mesh", lambda cfg: None),
                        ("sweep_training_run",
                         lambda *a, **k: (None, None, {})),
                        ("export_seed_runs", lambda *a: None),
                        ("_eval_view_stacked", lambda *a: None),
                        ("sweep_test", lambda *a, **k: per_seed)):
        monkeypatch.setattr(jax_sweep, name, value)
    monkeypatch.setattr(jax_cli, "_save_predictions_csv", lambda *a: None)

    class Writer:
        run_name = "run_x"
        log = finish = lambda *a, **k: None
    cfg = JaxConfig(**cfg_kw("fumi", seed=5, seed_sweep=4))
    want = jax_sweep.sweep_main(cfg, {}, (None, None, None), Writer(),
                                str(tmp_path), str(tmp_path))
    got = sweep.sweep_report([5, 6, 7, 8], per_seed)
    assert got == want
    assert "test/acc_seed_ci95" in got and "test/seed8/loss" in got


def argv(log_dir, model="fumi", *extra):
    return ["--model", model, "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "8", "8",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", str(Q), "--batch_size", str(B),
            "--num_ep_test", "4", "--epochs", "6", "--eval_freq", "3",
            "--num_train_adapt_steps", "2", "--num_test_adapt_steps", "3",
            "--lr", "0.05", "--step_size", "0.1", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--augment",
            "--tpu_pallas_gather", "--log_dir", str(log_dir), *extra]


def test_driver_sweep(tmp_path, capsys):
    out = cli_main.cli(argv(tmp_path / "sweep", "fumi", "--tpu_seed_sweep",
                            "3", "--tpu_watch"))
    printed = capsys.readouterr().out
    assert "SWEEP TEST (mean over 3 seeds)" in printed
    assert "--tpu_watch is not supported with --tpu_seed_sweep" in printed
    for k in ("loss", "acc"):
        vals = [out[f"test/seed{s}/{k}"] for s in range(3)]
        assert out[f"test/{k}"] == pytest.approx(np.mean(vals), rel=1e-12)
        assert out[f"test/{k}_seed_ci95"] == pytest.approx(
            1.96 * np.std(vals, ddof=1) / np.sqrt(3), rel=1e-12)
    (run,) = glob.glob(str(tmp_path / "sweep" / "runs" / "*"))
    csvs = glob.glob(str(tmp_path / "sweep" / "results" / "*.csv"))
    assert sorted(os.path.basename(c) for c in csvs) == [
        f"{os.path.basename(run)}_seed{s}.csv" for s in range(3)]
    meta = json.load(open(os.path.join(run, "ckpt.meta.json")))
    assert meta["sweep_seeds"] == [0, 1, 2]
    assert checkpoint.find_latest_resumable(str(tmp_path / "sweep"),
                                            model="fumi") is None

    # replica 0 is the standalone --seed 0 run (the synthetic data is
    # seeded by --seed), and --evaluate reads its run dir back
    solo = cli_main.cli(argv(tmp_path / "solo"))
    assert solo == {k: out[f"test/seed0/{k[5:]}"] for k in solo}
    evaluated = cli_main.cli(argv(tmp_path / "eval", "fumi", "--evaluate",
                                  "--checkpoint", os.path.join(run,
                                                               "seed0")))
    assert evaluated == solo
    # every seed<k>/ dir on the sweep's data: that seed's test numbers
    cfg = config_from_args(argv(tmp_path / "x"))
    splits, table, ids, _ = cli_main._load_data(cfg)
    test_s = cli_main._samplers(cfg, splits, table, ids,
                                torch.device("cpu"))[2]
    for s in range(3):
        seed_dir = os.path.join(run, f"seed{s}")
        assert json.load(open(os.path.join(seed_dir, "config.json")))[
            "seed"] == s
        solo_cfg = cfg.replace(seed=s)
        st = steps.make_steps(solo_cfg, torch.Generator(), device="cpu")
        p, state, _ = checkpoint.load_checkpoint(seed_dir, st.params,
                                                 st.opt.init(st.params))
        got = loop.test_loop(solo_cfg, st, loop.eval_view(solo_cfg, p, state),
                             test_s, solo_cfg.max_test_batches,
                             loop.stream_generator(s, loop.TEST, 0, "cpu"))
        for k in ("loss", "acc"):
            assert got[k] == out[f"test/seed{s}/{k}"]
    # a seed's run dir exports to a .pth.tar as a standalone run's does
    from fumi_tpu_torch.cli import export_torch
    path = export_torch.main([os.path.join(run, "seed2"),
                              str(tmp_path / "seed2.pth.tar")])
    clf = FewShotClassifier.from_checkpoint(path, cfg.replace(seed=2),
                                            device="cpu")
    for k, v in FewShotClassifier.from_checkpoint(
            os.path.join(run, "seed2"), cfg.replace(seed=2),
            device="cpu").params.items():
        assert torch.equal(clf.params[k], v), k


def test_seed_accum_changes_no_bit(tmp_path):
    outs = {}
    for g in (1, 2, 4):
        log = tmp_path / f"g{g}"
        outs[g] = cli_main.cli(argv(log, "maml", "--tpu_seed_sweep", "4",
                                    "--tpu_seed_accum", str(g)))
        (run,) = glob.glob(str(log / "runs" / "*"))
        outs[g] = (outs[g], [torch.load(os.path.join(
            run, f"seed{s}", "ckpt", "params.pt")) for s in range(4)])
    for g in (2, 4):
        assert outs[g][0] == outs[1][0]
        for a, b in zip(outs[g][1], outs[1][1]):
            assert_trees_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        Config(**cfg_kw("maml", seed_sweep=4, seed_accum=3)).validate()


def test_auto_resume_of_an_interrupted_sweep(tmp_path, capsys):
    """The resumed segment restores the stacked live and best states and
    the train generators at batch 6 and trains batches 7-9 only; its
    result is the uninterrupted run's, bit for bit."""
    sweep_args = ("--tpu_seed_sweep", "2", "--tpu_ema", "0.9")
    full = cli_main.cli(argv(tmp_path / "full", "fumi", *sweep_args,
                             "--epochs", "9"))
    # the interrupted run: its last checkpoint is at batch 6
    cli_main.cli(argv(tmp_path / "crash", "fumi", *sweep_args, "--epochs",
                      "7"))
    capsys.readouterr()
    resumed = cli_main.cli(argv(tmp_path / "crash", "fumi", *sweep_args,
                                "--epochs", "9", "--tpu_auto_resume"))
    assert "(batch 6, live [True, True])" in capsys.readouterr().out
    assert resumed == full


def test_sweep_train_logs_mask_frozen_seeds():
    class Writer:
        def __init__(self):
            self.rows = []

        def log(self, rec, step=None):
            self.rows.append((step, rec))
    w = Writer()
    ms = {"loss": torch.tensor([[1.0, 9.0, 3.0], [2.0, 9.0, 4.0]]),
          "acc": torch.zeros(2, 3)}
    cfg = Config(**cfg_kw("fumi"))
    done = sweep._log_sweep_train(w, cfg, 5, ms, False,
                                  np.array([True, False, True]), 10)
    assert [s for s, _ in w.rows] == [5, 6]
    assert [r["train/loss"] for _, r in w.rows] == [2.0, 3.0]
    assert [r["num_episodes"] for _, r in w.rows] == [14, 18] and done == 18
