"""AM3, ProtoNet and MatchingNet in the port against the JAX package's, on
the CPU, on bridged weights and the same episodes.

Widths: image 64, text 32, prototype 16, text_hid 16; B=2 tasks of 3 ways,
2 shots, 4 queries. Random streams never match between the packages, so
parity runs with dropout 0 and BERT (identity) text, or, for the ``rand``
text encoder, with the JAX package's own noise injected into the port's
draw (``test_am3_rand_encoder_on_the_jax_noise``).

Tolerances: one episode's loss, metrics and gradients are a few fp32
matmuls and reductions summed in other orders: 1e-5. Three optimizer steps
of each family: params, loss and metrics to 1e-5. The harness
(``training_run`` / ``test_loop`` on replayed episodes) compounds that over
9 steps and 4 evaluations: 1e-4, as ``tests/test_torch_loop.py`` holds
MAML and FuMI. Predictions, targets, ids and metric key sets are equal.
"""

import csv
import glob
import json
import os
import types

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
from fumi_tpu.train import loop as jax_loop
from fumi_tpu.train import steps as jax_steps
from fumi_tpu.train.logging import MetricWriter as JaxWriter
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.models import am3 as am3_mod
from fumi_tpu_torch.train import loop, steps
from fumi_tpu_torch.train.logging import MetricWriter

B, N, K, Q, D, E, P, TH = 2, 3, 2, 4, 64, 32, 16, 16
TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["am3", "protonet", "matchingnet"]


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             prototype_dim=P, text_hid_dim=TH, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, dropout=0.0, optim="adam",
             lr=1e-2, text_encoder="BERT", seed=0)
    d.update(kw)
    return d


def jax_family(model, **kw):
    cfg = JaxConfig(**cfg_kw(model, **kw))
    return cfg, jax_steps.build_family(cfg, jax.random.PRNGKey(0))


def port_family(model, jfam, **kw):
    """The port's family on the JAX family's weights."""
    cfg = Config(**cfg_kw(model, **kw))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    return cfg, fam._replace(params=bridge.params_from_jax(
        np_tree(jfam.params), model, device="cpu"))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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
    return bridge.episode_from_numpy(np_tree(ep), device="cpu")


def close_trees(got, want, **tol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def grads_of(model, jfam, fam, ep):
    """((loss, aux), grads) on both sides: the JAX grads by ``jax.grad``,
    the port's as the JAX tree."""
    (jl, ja), jg = jax.value_and_grad(jfam.train_loss, has_aux=True)(
        jfam.params, ep, jax.random.PRNGKey(0))
    (tl, ta), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    return (jl, ja, jg), (tl, ta, bridge.params_to_numpy(tg, model))


# ---------------------------------------------------------------------------
# one episode: forward, loss, metrics, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lamda_fixed", [None, 0, 1])
def test_am3_forward_and_episode_loss(jax_episodes, lamda_fixed):
    """BERT (identity) text, dropout 0: the support forward, the loss, the
    aux outputs and jax.grad within 1e-5."""
    _, jfam = jax_family("am3", lamda_fixed=lamda_fixed)
    _, fam = port_family("am3", jfam, lamda_fixed=lamda_fixed)
    ep = jax_episodes[0]
    jm, tm = jfam.model, fam.model
    want = jm.forward(jfam.params, ep.support_text, ep.support_im,
                      rng=jax.random.PRNGKey(0), train=False)
    tep = to_port(ep)
    got = tm.forward(fam.params, tep.support_text, tep.support_im)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    jl, ja = jm.episode_loss(jfam.params, ep, N, rng=jax.random.PRNGKey(0),
                             train=True)
    tl, ta = tm.episode_loss(fam.params, tep, N, None, train=True)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(ta[k].detach().numpy(), np.asarray(ja[k]),
                                   err_msg=k, **TOL)
    if lamda_fixed is not None:
        assert float(ta["avg_lamda"]) == float(lamda_fixed)

    (jl, ja, jg), (tl, ta, tg) = grads_of("am3", jfam, fam, ep)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_array_equal(ta["conf"].numpy(), np.asarray(ja["conf"]))
    np.testing.assert_array_equal(ta["preds"].numpy(),
                                  np.asarray(ja["preds"]))
    close_trees(tg, jg, **TOL)


def test_am3_rand_encoder_on_the_jax_noise(jax_episodes, monkeypatch):
    """The ``rand`` encoder draws fresh ``2·U(0,1)−1`` noise at every
    forward. The port's draw is handed the JAX package's noise (its
    ``k_noise`` split of the step key), so the two forward passes, losses
    and gradients meet within 1e-5; the unused text Linear gets a zero
    gradient on both sides."""
    _, jfam = jax_family("am3", text_encoder="rand")
    _, fam = port_family("am3", jfam, text_encoder="rand")
    ep = jax_episodes[1]
    rng = jax.random.PRNGKey(3)
    k_noise = jax.random.split(rng, 3)[0]
    noise = np.asarray(jax.random.uniform(k_noise, (B, N * K, P)))
    monkeypatch.setattr(am3_mod.layers, "rand",
                        lambda shape, gen=None: torch.tensor(noise))
    jl, ja = jfam.model.episode_loss(jfam.params, ep, N, rng=rng, train=True)
    tl, ta = fam.model.episode_loss(fam.params, to_port(ep), N, None,
                                    train=True)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(ta["lamda"].detach().numpy(),
                               np.asarray(ja["lamda"]), **TOL)
    (jl, _), jg = jax.value_and_grad(jfam.train_loss, has_aux=True)(
        jfam.params, ep, rng)
    (tl, _), tg = steps.value_and_grad(fam, fam.params, to_port(ep), None)
    close_trees(bridge.params_to_numpy(tg, "am3"), jg, **TOL)
    assert not tg["text_encoder.weight"].any()


@pytest.mark.parametrize("model", ["protonet", "matchingnet"])
def test_prototype_family_loss_metrics_and_grads(jax_episodes, model):
    _, jfam = jax_family(model)
    _, fam = port_family(model, jfam)
    for ep in jax_episodes:
        (jl, ja, jg), (tl, ta, tg) = grads_of(model, jfam, fam, ep)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        np.testing.assert_allclose(float(ta["acc"]), float(ja["acc"]),
                                   **TOL)
        np.testing.assert_array_equal(ta["preds"].numpy(),
                                      np.asarray(ja["preds"]))
        close_trees(tg, jg, **TOL)


@pytest.mark.parametrize("model", FAMILIES)
def test_eval_raw_and_finalize_match(jax_episodes, model):
    _, jfam = jax_family(model)
    _, fam = port_family(model, jfam)
    ep = jax_episodes[2]
    want = jfam.eval_finalize(jfam.eval_raw(jfam.params, ep,
                                            jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = fam.eval_finalize(fam.eval_raw(fam.params, to_port(ep), None))
    assert set(got) == set(want)
    for k in want:
        if k in ("preds", "targets"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)
    assert set(fam.eval_reduce) == set(jfam.eval_reduce)


# ---------------------------------------------------------------------------
# train steps and the chunked drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,opt_kw", [
    ("am3", dict(optim="adam")), ("protonet", dict(optim="adam")),
    ("matchingnet", dict(optim="adam")),
    ("am3", dict(optim="adamw_lin_schedule", num_warmup_steps=2,
                 epochs=5)),
    ("am3", dict(optim="SGD", lr=0.1, text_encoder="rand",
                 lamda_fixed=1)),
], ids=["am3", "protonet", "matchingnet", "am3-lin_schedule",
        "am3-rand-SGD"])
def test_three_train_steps_match(jax_episodes, model, opt_kw):
    """3 optimizer steps on the same episodes: the params, the loss and
    every train metric within 1e-5, and the metric keys equal to the JAX
    package's (``grad_norm/w``/``grad_norm/b`` for ProtoNet and
    MatchingNet's bare linear). AM3's lr schedule steps; with the ``rand``
    encoder (and λ fixed at 1, so the noise does not enter the loss) its
    unused text Linear stays put under coupled L2."""
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
    if model == "am3":
        assert {"prec", "rec", "f1", "avg_lamda", "grad_norm/g",
                "grad_norm/h", "grad_norm/image_encoder"} <= set(tm)
    else:
        assert {"grad_norm/w", "grad_norm/b"} <= set(tm)
    if opt_kw.get("text_encoder") == "rand":
        assert torch.equal(tp["text_encoder.weight"],
                           fam.params["text_encoder.weight"])


@pytest.mark.parametrize("model", FAMILIES)
def test_chunked_drivers_metric_keys_and_shapes(model):
    """The chunked drivers' keys, shapes and dtypes equal the JAX
    package's; with ``collect`` AM3's per-support λ rides along."""
    jcfg, jfam = jax_family(model)
    cfg, fam = port_family(model, jfam, pallas_gather=True)
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=12,
                                         im_dim=D, text_dim=E)
    j_smp = jax_sampler.DeviceEpisodeSampler(
        jnp.asarray(table), jnp.asarray(ids), cs, JaxSpec(B, N, K, Q, D, E))
    t_smp = sampler.DeviceEpisodeSampler(table, ids, cs,
                                         EpisodeSpec(B, N, K, Q, D, E),
                                         use_pallas_gather=True, device="cpu")
    j_opt, t_opt = jax_steps.make_opt(jcfg), steps.make_opt(cfg)
    *_, jm = jax_steps.make_chunked_train(jfam, j_opt, j_smp, 2)(
        jfam.params, j_opt.init(jfam.params), jax.random.PRNGKey(1))
    tp, _, gen, tm = steps.make_chunked_train(fam, t_opt, t_smp, 2)(
        fam.params, t_opt.init(fam.params), t_smp.generator(1))
    assert set(tm) == set(jm)
    assert all(v.shape == (2,) and torch.isfinite(v).all()
               for v in tm.values())
    for collect in (False, True):
        _, je = jax_steps.make_chunked_eval(jfam, j_smp, collect)(
            jfam.params, jax.random.PRNGKey(2), 3)
        _, te = steps.make_chunked_eval(fam, t_smp, collect)(
            fam.params, gen, 3)
        assert set(te) == set(je)
        for k in te:
            assert tuple(te[k].shape) == tuple(np.shape(je[k])), k
            assert te[k].dtype == torch.from_numpy(np.array(je[k])).dtype, k
    assert ("lamda" in te) == (model == "am3")


@pytest.mark.parametrize("model", FAMILIES)
def test_bridge_round_trip(model):
    _, jfam = jax_family(model, text_encoder="rand")
    tree = np_tree(jfam.params)
    back = bridge.params_to_numpy(
        bridge.params_from_jax(tree, model, device="cpu"), model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the harness: training_run and test_loop on replayed episodes
# ---------------------------------------------------------------------------

class Replay:
    """A sampler that hands out a fixed list of episodes in turn."""

    def __init__(self, episodes):
        self.episodes, self.i = episodes, 0

    def sample(self):
        ep = self.episodes[self.i % len(self.episodes)]
        self.i += 1
        return ep


def recording(base):
    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []

        def log(self, metrics, step=None):
            self.records.append((step, dict(metrics)))
            super().log(metrics, step=step)
    return Recording


def jax_replay(spec, n, seed):
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=40,
                                         im_dim=D, text_dim=E, seed=seed)
    smp = jax_sampler.DeviceEpisodeSampler(table, ids, cs, spec)
    return [smp.sample(jax.random.PRNGKey(1000 * seed + i)) for i in range(n)]


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_am3_training_run_and_test_loop_match_the_jax_harness(tmp_path):
    """AM3 evaluates at batch 0 as well and reloads its best checkpoint:
    both loops log train steps and evals at the same batch indices, every
    AM3 train and val metric within 1e-4, the same best checkpoint, final
    params within 1e-4, and the same test metrics. Each package writes
    its prediction CSV from its own test metrics: the ``support_lamda``
    column, parsed, within 1e-5 (its floats differ in the last bits), the
    other columns byte for byte."""
    kw = dict(epochs=8, eval_freq=4, patience=0, num_ep_test=4,
              wandb_offline=True, prng_impl="threefry2x32")
    jcfg = JaxConfig(**cfg_kw("am3", **kw))
    cfg = Config(**cfg_kw("am3", **kw))
    eval_spec = JaxSpec(B, N, K, cfg.num_query_eval, D, E)
    train = jax_replay(JaxSpec(B, N, K, Q, D, E), 5, 1)
    val, test = jax_replay(eval_spec, 3, 2), jax_replay(eval_spec, 3, 3)

    j_steps = jax_steps.make_steps(jcfg, jax.random.PRNGKey(0))
    t_steps = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    t_steps = t_steps._replace(params=bridge.params_from_jax(
        np_tree(j_steps.params), "am3", device="cpu"))
    j_writer = recording(JaxWriter)(str(tmp_path / "jax"), use_wandb=False)
    t_writer = recording(MetricWriter)(str(tmp_path / "port"),
                                       use_wandb=False)
    j_dir, t_dir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    j_params = jax_loop.training_run(jcfg, j_steps, Replay(train),
                                     Replay(val), j_writer, j_dir,
                                     jax.random.PRNGKey(1))
    t_params = loop.training_run(cfg, t_steps,
                                 Replay([to_port(e) for e in train]),
                                 Replay([to_port(e) for e in val]), t_writer,
                                 t_dir, cfg.seed)

    def rows(records, prefix):
        return [(s, {k: v for k, v in m.items() if k.startswith(prefix)})
                for s, m in records if any(k.startswith(prefix) for k in m)]
    for prefix in ("train/", "val/"):
        j_rows, t_rows = rows(j_writer.records, prefix), \
            rows(t_writer.records, prefix)
        assert [s for s, _ in t_rows] == [s for s, _ in j_rows], prefix
        for (_, tm), (_, jm) in zip(t_rows, j_rows):
            assert set(tm) == set(jm), prefix
            for k in jm:
                np.testing.assert_allclose(tm[k], jm[k], err_msg=k,
                                           **LOOP_TOL)
    assert [s for s, _ in rows(t_writer.records, "val/")] == [0, 4, 8]
    assert "train/avg_lamda" in t_writer.records[-1][1] or any(
        "train/avg_lamda" in m for _, m in t_writer.records)
    for name in ("ckpt", "best"):
        j_meta, t_meta = (json.load(open(os.path.join(r, f"{name}.meta.json")))
                          for r in (j_dir, t_dir))
        assert t_meta["batch_idx"] == j_meta["batch_idx"], name
    close_trees(bridge.params_to_numpy(t_params, "am3"), j_params,
                **LOOP_TOL)

    j_test = jax_loop.test_loop(jcfg, j_steps, j_params, Replay(test),
                                jcfg.max_test_batches, jax.random.PRNGKey(2),
                                collect_artifacts=True)
    t_test = loop.test_loop(cfg, t_steps, t_params,
                            Replay([to_port(e) for e in test]),
                            cfg.max_test_batches, None,
                            collect_artifacts=True)
    assert set(t_test) == set(j_test)
    for k in ("loss", "acc", "prec", "rec", "f1", "avg_lamda", "loss_ci95",
              "acc_ci95"):
        np.testing.assert_allclose(t_test[k], j_test[k], err_msg=k,
                                   **LOOP_TOL)
    for k in ("preds", "targets", "query_idx", "support_idx"):
        assert t_test[k] == j_test[k], k
    np.testing.assert_allclose(t_test["support_lamdas"],
                               j_test["support_lamdas"], rtol=1e-5,
                               atol=1e-5)

    w = types.SimpleNamespace(run_name="am3")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = read_csv(cli_main._save_predictions_csv(cfg, w,
                                                   str(tmp_path / "a"),
                                                   t_test))
    theirs = read_csv(jax_cli._save_predictions_csv(jcfg, w,
                                                    str(tmp_path / "b"),
                                                    j_test))
    assert ours[0] == theirs[0] == ["", "support_idx", "support_lamda",
                                    "query_idx", "query_preds",
                                    "query_targets"]
    assert len(ours) == len(theirs) == (cfg.max_test_batches + 1) * B + 1
    for a, b in zip(ours[1:], theirs[1:]):
        assert a[:2] + a[3:] == b[:2] + b[3:]
        np.testing.assert_allclose(json.loads(a[2]), json.loads(b[2]),
                                   rtol=1e-5, atol=1e-5)
    j_writer.finish()
    t_writer.finish()


# ---------------------------------------------------------------------------
# the driver end to end on the CPU
# ---------------------------------------------------------------------------

def driver_argv(log_dir, model, *extra):
    return ["--model", model, "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--prototype_dim", str(P),
            "--text_hid_dim", str(TH), "--num_ways", "3", "--num_shots", "2",
            "--num_shots_test", "4", "--batch_size", "2", "--num_ep_test",
            "6", "--epochs", "6", "--eval_freq", "3", "--lr", "0.01",
            "--seed", "0", "--wandb_offline", "--disable_cuda", "--augment",
            "--tpu_pallas_gather", "--log_dir", str(log_dir), *extra]


@pytest.mark.parametrize("model", FAMILIES)
def test_driver_runs_the_family_on_the_cpu(tmp_path, model):
    """``cli.main --disable_cuda`` trains and tests the family: a finite
    ``TEST`` dict (AM3 with prec / rec / f1 / avg_lamda), ``ckpt/`` and
    ``best/``, a CSV with AM3's ``support_lamda`` column; ``--evaluate
    --checkpoint`` on the run it wrote tests its ``best/``, which for AM3
    (reloaded after training, as the reference does) reproduces the test
    metrics exactly."""
    out = cli_main.cli(driver_argv(tmp_path / "train", model))
    assert all(np.isfinite(v) for v in out.values())
    keys = {"test/loss", "test/acc", "test/acc_ci95", "test/loss_ci95"}
    if model == "am3":
        keys |= {"test/prec", "test/rec", "test/f1", "test/avg_lamda"}
    assert set(out) == keys
    (run,) = glob.glob(str(tmp_path / "train" / "runs" / "*"))
    assert all(os.path.exists(os.path.join(run, n))
               for n in ("ckpt", "best", "config.json", "best.meta.json"))
    (path,) = glob.glob(str(tmp_path / "train" / "results" / "run_*.csv"))
    rows = read_csv(path)
    assert ("support_lamda" in rows[0]) == (model == "am3")
    assert len(rows) == 1 + (6 // 2 + 1) * 2
    if model == "am3":
        lam = json.loads(rows[1][rows[0].index("support_lamda")])
        assert len(lam) == 6 and all(0.0 <= x <= 1.0 for x in lam)
    again = cli_main.main(config_from_args(driver_argv(
        tmp_path / "eval", model, "--evaluate", "--checkpoint", run)))
    assert set(again) == set(out)
    if model == "am3":  # AM3 tests its reloaded best/, as --evaluate does
        assert again == out
    else:  # ProtoNet and MatchingNet test their last params
        assert all(np.isfinite(v) for v in again.values())


# ---------------------------------------------------------------------------
# the family registry (--tpu_import, register_family, Family.serve)
# ---------------------------------------------------------------------------

PORT_FAMILY = '''
from fumi_tpu_torch.models import layers
from fumi_tpu_torch.ops import fewshot
from fumi_tpu_torch.train import steps


@steps.register_family("{name}")
def build(cfg, gen, dictionary=None):
    w, b = layers.linear_init(gen, cfg.im_emb_dim, cfg.prototype_dim)

    def embed(p, x):
        return layers.linear(p["proj.weight"], p["proj.bias"], x)

    def raw(p, ep):
        protos = steps.image_prototypes(embed(p, ep.support_im),
                                        ep.support_y, cfg.num_ways)
        q = embed(p, ep.query_im)
        preds = fewshot.predict_classes(protos, q)
        return (fewshot.prototypical_loss(protos, q, ep.query_y), preds,
                (preds == ep.query_y).float().mean())

    def train_loss(p, ep, gen):
        loss, preds, acc = raw(p, ep)
        return loss, {{"acc": acc, "preds": preds}}

    def eval_raw(p, ep, gen):
        loss, preds, acc = raw(p, ep)
        return {{"loss": loss, "acc": acc, "preds": preds,
                "targets": ep.query_y}}

    def serve(cfg, family):
        def adapt_fn(p, s_im, s_text, s_y, seeds):
            return steps.image_prototypes(embed(p, s_im), s_y, cfg.num_ways)

        def classify_fn(p, protos, q_im):
            return fewshot.prototype_logits(protos, embed(p, q_im))
        return adapt_fn, classify_fn

    return steps.Family(name="{name}",
                        params={{"proj.weight": w, "proj.bias": b}},
                        train_loss=train_loss, eval_raw=eval_raw,
                        eval_finalize=lambda raw: raw,
                        eval_reduce=dict(steps.EVAL_REDUCE), serve=serve)
'''

JAX_FAMILY = '''
import jax.numpy as jnp

from fumi_tpu.models import layers
from fumi_tpu.ops import fewshot
from fumi_tpu.train import steps


@steps.register_family("{name}")
def build(cfg, key, dictionary=None):
    def embed(p, x):
        return layers.linear(p, x)

    def protos_of(p, s_im, s_y):
        e = embed(p, s_im)
        lam = jnp.ones(e.shape[:-1] + (1,), e.dtype)
        return fewshot.get_prototypes(e, e, lam, s_y, cfg.num_ways)

    def raw(p, ep):
        protos = protos_of(p, ep.support_im, ep.support_y)
        q = embed(p, ep.query_im)
        preds = fewshot.predict_classes(protos, q)
        return (fewshot.prototypical_loss(protos, q, ep.query_y), preds,
                jnp.mean((preds == ep.query_y).astype(jnp.float32)))

    def train_loss(p, ep, rng):
        loss, preds, acc = raw(p, ep)
        return loss, {{"acc": acc, "preds": preds}}

    def eval_raw(p, ep, rng):
        loss, preds, acc = raw(p, ep)
        return {{"loss": loss, "acc": acc, "preds": preds,
                "targets": ep.query_y}}

    def serve(cfg, family):
        def adapt_fn(p, s_im, s_text, s_y, rng):
            return protos_of(p, s_im[None], s_y[None])[0]

        def classify(p, protos, q):
            return fewshot.prototype_logits(protos[None], embed(p, q)[None])[0]
        return adapt_fn, classify

    return steps.Family(
        name="{name}", params=layers.linear_init(key, cfg.im_emb_dim,
                                                 cfg.prototype_dim),
        train_loss=train_loss, eval_raw=eval_raw,
        eval_finalize=lambda raw: raw,
        eval_reduce={{"loss": "mean", "acc": "mean", "preds": "concat",
                     "targets": "concat"}}, serve=serve)
'''


def _family_module(tmp_path, monkeypatch, template, mod_name, family):
    (tmp_path / f"{mod_name}.py").write_text(template.format(name=family))
    monkeypatch.syspath_prepend(str(tmp_path))
    return mod_name


def test_a_registered_family_trains_and_serves_in_both_packages(
        tmp_path, monkeypatch):
    """A module named by ``--tpu_import`` registers a family with a
    ``Family.serve`` hook: the config validates only once it is imported,
    the port's driver trains and tests it on the CPU (the JAX driver does
    the same with its twin module), and both packages serve the port's
    trained weights through their hooks: logits to 1e-4, the same
    argmax."""
    from fumi_tpu.core import config as jax_config
    from fumi_tpu.serve import FewShotClassifier as JaxClassifier
    from fumi_tpu_torch.serve import FewShotClassifier
    name = "centroids_registry_test"
    port_mod = _family_module(tmp_path, monkeypatch, PORT_FAMILY,
                              "port_centroids_family", name)
    jax_mod = _family_module(tmp_path, monkeypatch, JAX_FAMILY,
                             "jax_centroids_family", name)
    argv = ["--model", name, "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--prototype_dim", str(P), "--num_ways", str(N),
            "--num_shots", str(K), "--num_shots_test", str(Q),
            "--batch_size", str(B), "--num_ep_test", "4", "--epochs", "4",
            "--eval_freq", "2", "--lr", "0.01", "--seed", "0",
            "--wandb_offline"]
    with pytest.raises(ValueError, match="unknown model"):
        config_from_args(argv)
    assert name not in steps.FAMILY_REGISTRY
    out = cli_main.cli(argv + ["--tpu_import", port_mod, "--disable_cuda",
                               "--log_dir", str(tmp_path / "port")])
    assert name in steps.FAMILY_REGISTRY
    assert set(out) == {"test/loss", "test/acc", "test/acc_ci95",
                        "test/loss_ci95"}
    assert all(np.isfinite(v) for v in out.values())
    jcfg = jax_config.config_from_args(
        argv + ["--tpu_import", jax_mod, "--log_dir", str(tmp_path / "jax")])
    assert set(jax_cli.main(jcfg)) == set(out)

    (run,) = glob.glob(str(tmp_path / "port" / "runs" / "*"))
    cfg = config_from_args(argv + ["--tpu_import", port_mod])
    clf = FewShotClassifier.from_checkpoint(run, cfg, device="cpu")
    jc = JaxClassifier(jcfg, {"w": clf.params["proj.weight"].numpy(),
                              "b": clf.params["proj.bias"].numpy()})
    rng = np.random.RandomState(0)
    s_im = rng.randn(N * K, D).astype(np.float32)
    s_y = np.repeat(np.arange(N), K).astype(np.int32)
    q_im = rng.randn(5, D).astype(np.float32)
    got = clf.episode_logits(s_im, s_y, q_im)
    want = np.asarray(jc.episode_logits(s_im, s_y, q_im))
    assert got.shape == (5, N)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    clf.adapt(s_im, None, s_y)
    np.testing.assert_array_equal(clf.classify(q_im), want.argmax(-1))


def test_the_registry_dispatches_and_serving_needs_a_hook():
    """The built-in families register themselves, under the JAX
    package's names; ``build_family`` dispatches through the registry; a
    registered family without a ``serve`` hook is refused by serving,
    naming the hook."""
    from fumi_tpu_torch.serve import FewShotClassifier
    builtin = {"maml", "fumi", "am3", "protonet", "matchingnet"}
    assert builtin <= set(steps.FAMILY_REGISTRY)
    assert builtin <= set(jax_steps.FAMILY_REGISTRY)
    calls = []
    name = "hookless_registry_test"

    @steps.register_family(name)
    def builder(cfg, gen, dictionary=None):
        calls.append(cfg.model)
        return steps.build_protonet_family(
            cfg.replace(model="protonet"), gen)._replace(name=name)
    try:
        cfg = Config(**cfg_kw(name))
        fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
        assert calls == [name] and fam.serve is None
        with pytest.raises(NotImplementedError, match="Family.serve"):
            FewShotClassifier(cfg, device="cpu").episode_logits(
                np.zeros((N * K, D), np.float32),
                np.repeat(np.arange(N), K), np.zeros((2, D), np.float32))
    finally:
        del steps.FAMILY_REGISTRY[name]
    with pytest.raises(NotImplementedError, match="not registered"):
        steps.build_family(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown model"):
        cfg.validate()
