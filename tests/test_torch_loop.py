"""The port's training harness against the JAX package's, on the CPU.

Both packages' ``training_run`` and ``test_loop`` take the same pre-drawn
JAX episodes (bridged to the port) through a replay sampler, on bridged
initial weights at dropout 0, along the per-batch path both loops have.
They must log train steps and evals at the same batch indices, with train
and val losses within 1e-4, choose the same best checkpoint, end on params
within 1e-4 (FuMI's reloaded from ``best/``, MAML's the last), and report
the same test metrics, 95% intervals included, within 1e-4: fp32 on both
sides through second-order steps summed in other orders, as
``tests/test_torch_train.py`` holds single steps.

One case stops on ``--patience`` between evals: the step indices and the
final params then come from the patience trigger.

Both ``MetricWriter``s' ``run_dir`` is ``log_dir`` without a wandb run, and
the run's ``dir`` with one: a stub ``wandb`` module, so nothing reaches the
network.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.train import loop as jax_loop
from fumi_tpu.train import steps as jax_steps
from fumi_tpu.train.logging import MetricWriter as JaxWriter
from fumi_tpu_torch import bridge
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.train import loop, steps
from fumi_tpu_torch.train.logging import MetricWriter

D, E = 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, num_ways=3, num_shots=2,
             num_shots_test=3, batch_size=2, num_train_adapt_steps=2,
             num_test_adapt_steps=3, step_size=0.1, dropout=0.0,
             optim="adam", lr=1e-3, num_ep_test=4, text_encoder="precomputed",
             seed=0, wandb_offline=True, prng_impl="threefry2x32")
    d.update(kw)
    return d


class Replay:
    """A sampler that hands out a fixed list of episodes in turn."""

    def __init__(self, episodes):
        self.episodes, self.i = episodes, 0

    def sample(self):
        ep = self.episodes[self.i % len(self.episodes)]
        self.i += 1
        return ep


def recording(base):
    """``base`` (a MetricWriter class) that also keeps every record."""
    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.records = []

        def log(self, metrics, step=None):
            self.records.append((step, dict(metrics)))
            super().log(metrics, step=step)
    return Recording


def series(records, prefix):
    """(steps, losses) of the records holding ``<prefix>loss``."""
    rows = [(s, float(m[prefix + "loss"])) for s, m in records
            if prefix + "loss" in m]
    return [s for s, _ in rows], np.array([v for _, v in rows])


def jax_episodes(spec, n, seed):
    cs, table, ids = synthetic_class_set(num_classes=10, images_per_class=40,
                                         im_dim=D, text_dim=E, seed=seed)
    smp = jax_sampler.DeviceEpisodeSampler(table, ids, cs, spec)
    return [smp.sample(jax.random.PRNGKey(1000 * seed + i)) for i in range(n)]


def port_of(episodes):
    return [bridge.episode_from_numpy(
        jax.tree_util.tree_map(np.asarray, ep), device="cpu")
        for ep in episodes]


@pytest.mark.parametrize("model,kw", [
    ("fumi", dict(epochs=12, eval_freq=4, patience=0)),
    ("maml", dict(epochs=12, eval_freq=4, patience=0)),
    ("fumi", dict(epochs=30, eval_freq=10, patience=3)),
], ids=["fumi", "maml", "fumi-patience-between-evals"])
def test_training_run_and_test_loop_match_the_jax_harness(tmp_path, model,
                                                         kw):
    jcfg = JaxConfig(**cfg_kw(model, **kw))
    cfg = Config(**cfg_kw(model, **kw))
    train_spec = JaxSpec(2, 3, 2, 3, D, E)
    eval_spec = JaxSpec(2, 3, 2, cfg.num_query_eval, D, E)
    train = jax_episodes(train_spec, 6, 1)
    val = jax_episodes(eval_spec, 3, 2)
    test = jax_episodes(eval_spec, 4, 3)

    j_steps = jax_steps.make_steps(jcfg, jax.random.PRNGKey(0))
    t_steps = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    t_steps = t_steps._replace(params=bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_steps.params), model,
        device="cpu"))

    j_writer = recording(JaxWriter)(str(tmp_path / "jax"), use_wandb=False)
    t_writer = recording(MetricWriter)(str(tmp_path / "port"),
                                       use_wandb=False)
    j_dir, t_dir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    j_params = jax_loop.training_run(jcfg, j_steps, Replay(train),
                                     Replay(val), j_writer, j_dir,
                                     jax.random.PRNGKey(1))
    t_params = loop.training_run(cfg, t_steps, Replay(port_of(train)),
                                 Replay(port_of(val)), t_writer, t_dir,
                                 cfg.seed)

    for prefix in ("train/", "val/"):
        j_idx, j_loss = series(j_writer.records, prefix)
        t_idx, t_loss = series(t_writer.records, prefix)
        assert t_idx == j_idx, prefix
        np.testing.assert_allclose(t_loss, j_loss, err_msg=prefix, **TOL)
    if kw["patience"]:
        # stopped at batch patience + 1, before the first eval
        assert series(t_writer.records, "train/")[0] == \
            list(range(kw["patience"] + 2))
        assert not series(t_writer.records, "val/")[0]
    else:
        assert series(t_writer.records, "val/")[0] == [4, 8, 12]

    for d in ("ckpt", "best"):
        metas = [os.path.join(r, f"{d}.meta.json") for r in (j_dir, t_dir)]
        assert os.path.exists(metas[0]) == os.path.exists(metas[1]), d
        if os.path.exists(metas[0]):
            j_meta, t_meta = (json.load(open(m)) for m in metas)
            assert t_meta["batch_idx"] == j_meta["batch_idx"], d
            np.testing.assert_allclose(t_meta["best_loss"],
                                       j_meta["best_loss"], **TOL)

    got = bridge.params_to_numpy(t_params, model)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)

    j_test = jax_loop.test_loop(jcfg, j_steps, j_params, Replay(test),
                                jcfg.max_test_batches, jax.random.PRNGKey(2),
                                collect_artifacts=True)
    t_test = loop.test_loop(cfg, t_steps, t_params, Replay(port_of(test)),
                            cfg.max_test_batches, None,
                            collect_artifacts=True)
    assert set(t_test) == set(j_test)
    for k in ("loss", "acc", "loss_ci95", "acc_ci95"):
        np.testing.assert_allclose(t_test[k], j_test[k], err_msg=k, **TOL)
    for k in ("preds", "targets", "query_idx", "support_idx"):
        assert t_test[k] == j_test[k], k
    j_writer.finish()
    t_writer.finish()


def test_stream_seeds_are_distinct_and_deterministic():
    seeds = {loop.stream_seed(s, stream, i) for s in (0, 1, 2 ** 32 - 1)
             for stream in (loop.TRAIN, loop.VAL, loop.TEST)
             for i in (0, 1, 2 ** 28 - 1)}
    assert len(seeds) == 27 and all(0 <= x < 2 ** 64 for x in seeds)
    a = loop.stream_generator(5, loop.VAL, 3, "cpu")
    b = loop.stream_generator(5, loop.VAL, 3, "cpu")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


@pytest.mark.parametrize("kw", [dict(use_wandb=False),
                                dict(use_wandb=True, offline=True)],
                         ids=["no-wandb", "offline"])
def test_run_dir_without_wandb_is_the_log_dir(tmp_path, kw):
    """With no wandb run, both writers' ``run_dir`` is ``log_dir``."""
    for name, cls in (("jax", JaxWriter), ("port", MetricWriter)):
        log_dir = str(tmp_path / name)
        w = cls(log_dir, run_name="r", run_suffix="-s", **kw)
        assert w.run_dir == log_dir
        assert w.run_name == "r-s"
        w.finish()


def test_run_dir_of_a_wandb_run(tmp_path, monkeypatch):
    """A stub ``wandb`` module (no network): both writers start its run,
    take its name plus the suffix, return its ``run.dir`` as ``run_dir``
    and log to it."""
    logged = []
    stub = types.ModuleType("wandb")
    stub.run = None

    def init(**kw):
        stub.run = types.SimpleNamespace(name="stub-run",
                                         dir=str(tmp_path / "wandb-run"))
    stub.init = init
    stub.log = lambda scalars, step=None: logged.append((step, scalars))
    stub.finish = lambda: None
    monkeypatch.setitem(sys.modules, "wandb", stub)
    for name, cls in (("jax", JaxWriter), ("port", MetricWriter)):
        stub.run = None
        w = cls(str(tmp_path / name), run_name="r", run_suffix="-s",
                offline=False)
        assert w.run_dir == str(tmp_path / "wandb-run")
        assert w.run_name == "stub-run-s"
        w.log({"loss": 0.5}, step=3)
        w.finish()
        assert (tmp_path / name / "stub-run-s.metrics.jsonl").exists()
    assert logged == [(3, {"loss": 0.5})] * 2
