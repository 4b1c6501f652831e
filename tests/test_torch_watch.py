"""``--tpu_watch`` and ``--tpu_profile_dir`` in the port, on the CPU.

- The buckets: counts exactly equal to ``fumi_tpu.train.watch``'s on the
  same arrays (random magnitudes over 16 decades, zeros, NaN and ±Inf), and
  ``component_histograms`` of bridged params equal to the JAX package's.
  On values placed exactly on a bucket edge (10^(k/2) and its float32
  neighbours) torch's ``log10`` and XLA's can differ by one ulp, so there
  an element lands in the same bucket or the neighbouring one; the test
  counts how many move (11 of 112 on the installed builds).
- The driver: the JSONL rows ``watch/params/<c>``, ``watch/grads/<c>`` and
  ``watch/grad_steps`` under the JAX package's component names, the bucket
  labels once; a watched chunk bitwise the unwatched one, its counts
  summing to the parameter count times the sampled steps.
- The host-sampler path: the gradient sample comes from ``watch_clone()``,
  so a watched run trains on the same episodes (its TEST numbers equal the
  unwatched run's) and the clone leaves the sampler's stream where it was.
- ``profile_trace``: a trace file naming the kernel wrappers' ranges.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.train import steps as jax_steps
from fumi_tpu.train import watch as jax_watch
from fumi_tpu_torch import bridge
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.data.synthetic import synthetic_class_set
from fumi_tpu_torch.ops import kernels
from fumi_tpu_torch.train import steps, watch
from fumi_tpu_torch.utils.profiling import profile_trace

B, N, K, Q, D, E = 2, 3, 1, 3, 16, 8


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_shots_test=Q, batch_size=B,
             num_train_adapt_steps=1, num_test_adapt_steps=2, step_size=0.1,
             dropout=0.0, text_encoder="precomputed", seed=0, lr=1e-3)
    d.update(kw)
    return d


def mixed_values(seed, n=100_000):
    rng = np.random.RandomState(seed)
    x = (rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-13, 4, n)).astype(np.float32)
    x[:50], x[50:60], x[60:70], x[70:80] = 0.0, np.nan, np.inf, -np.inf
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_counts_equal_jax(seed):
    x = mixed_values(seed)
    got = watch.bucketize(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_watch._bucketize(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == x.size and got[-1] == 30 and got[0] == 50


def test_bucket_edges_land_in_the_same_or_a_neighbouring_bucket():
    edges = np.array([10.0 ** (k / 2) for k in range(-22, 6)], np.float32)
    vals = np.concatenate([edges, -edges, np.nextafter(edges, 0),
                           np.nextafter(edges, np.inf)]).astype(np.float32)
    got = watch.bucket_index(torch.from_numpy(vals)).numpy()
    want = np.array([int(np.asarray(jax_watch._bucketize(
        jnp.asarray([v]))).argmax()) for v in vals])
    assert np.abs(got - want).max() <= 1
    assert (got != want).sum() <= len(vals) // 4


def test_bucket_layout_equals_jax():
    assert watch.NUM_BUCKETS == jax_watch.NUM_BUCKETS
    assert watch.bucket_labels() == jax_watch.bucket_labels()
    assert watch.WATCH_STRIDE == jax_watch.WATCH_STRIDE
    assert watch.WATCH_METRIC_PREFIX == jax_watch.WATCH_METRIC_PREFIX


@pytest.mark.parametrize("model", ["fumi", "maml", "am3", "protonet"])
def test_component_histograms_equal_jax(model):
    jfam = jax_steps.build_family(JaxConfig(**cfg_kw(model)),
                                  jax.random.PRNGKey(0))
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfam.params), model,
        device="cpu")
    got = watch.component_histograms(params, model)
    want = jax_watch.component_histograms(jfam.params)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    rec = watch.watch_record(params, model, grads=params)
    assert set(rec) == set(jax_watch.watch_record(jfam.params,
                                                  jfam.params))


def small_sampler():
    cs, table, ids = synthetic_class_set(num_classes=6, images_per_class=10,
                                         im_dim=D, text_dim=E, seed=0)
    return sampler.DeviceEpisodeSampler(table, ids, cs,
                                        EpisodeSpec(B, N, K, Q, D, E),
                                        use_pallas_gather=True, device="cpu")


@pytest.mark.parametrize("stride,n,sampled", [(1, 5, 5), (8, 10, 1),
                                              (8, 16, 2)])
def test_watched_chunk_is_bitwise_and_counts_every_sampled_step(
        monkeypatch, stride, n, sampled):
    monkeypatch.setattr(watch, "WATCH_STRIDE", stride)
    cfg = Config(**cfg_kw("fumi"))
    fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
    opt = steps.make_opt(cfg)
    smp = small_sampler()
    n_params = sum(v.numel() for v in fam.params.values())
    out = {w: steps.make_chunked_train(fam, opt, smp, n, watch=w)(
        fam.params, opt.init(fam.params), smp.generator(1))
        for w in (False, True)}
    for k, v in out[False][0].items():
        assert torch.equal(out[True][0][k], v), k
    plain, counts, got = watch.split_watch_counts(out[True][3])
    assert got == sampled
    assert set(plain) == set(out[False][3])
    for k, v in plain.items():
        assert torch.equal(v, out[False][3][k]), k
    assert sum(int(v.sum()) for v in counts.values()) == n_params * sampled
    assert set(counts) == {k[len("grad_norm/"):] for k in plain
                           if k.startswith("grad_norm/")}


def argv(log_dir, *extra):
    return ["--model", "maml", "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "8",
            "--num_ways", str(N), "--num_shots", str(K), "--num_shots_test",
            str(Q), "--batch_size", str(B), "--num_ep_test", "4", "--epochs",
            "6", "--eval_freq", "3", "--num_train_adapt_steps", "1",
            "--num_test_adapt_steps", "1", "--lr", "0.001", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--log_dir", str(log_dir),
            *extra]


def watch_rows(log_dir):
    (path,) = glob.glob(str(log_dir / "results" / "*.metrics.jsonl"))
    return [r for r in map(json.loads, open(path))
            if any(k.startswith("watch/") for k in r)]


def test_driver_writes_the_watch_rows(tmp_path):
    """Device sampler: one row at each eval boundary (batches 3 and 6),
    under the JAX package's names, the labels in the first only."""
    cli_main.cli(argv(tmp_path, "--tpu_watch", "--tpu_pallas_gather"))
    rows = watch_rows(tmp_path)
    assert [r["_step"] for r in rows] == [3, 6]
    jfam = jax_steps.build_family(JaxConfig(**cfg_kw("maml",
                                                     im_hid_dim=(8,))),
                                  jax.random.PRNGKey(0))
    names = set(jax_watch.watch_record(jfam.params, jfam.params))
    for i, r in enumerate(rows):
        want = names | {"watch/grad_steps", "_step"}
        if i == 0:
            want.add("watch/buckets")
            assert r["watch/buckets"] == watch.bucket_labels()
        assert set(r) == want
        # 4 steps (0..3), then 3 (4..6): one sampled block of 3 each
        assert r["watch/grad_steps"] == 1
        n = sum(sum(v) for k, v in r.items() if k.startswith("watch/grads/"))
        assert n == sum(sum(v) for k, v in r.items()
                        if k.startswith("watch/params/"))


def test_watch_does_not_shift_the_host_sampler_stream(tmp_path):
    off = cli_main.cli(argv(tmp_path / "off", "--tpu_host_sampler"))
    on = cli_main.cli(argv(tmp_path / "on", "--tpu_host_sampler",
                           "--tpu_watch"))
    assert on == off
    rows = watch_rows(tmp_path / "on")
    assert len(rows) == 2 and "watch/grad_steps" not in rows[0]
    assert any(k.startswith("watch/grads/") for k in rows[0])


def test_watch_clone_leaves_the_sampler_stream():
    cs, table, ids = synthetic_class_set(num_classes=6, images_per_class=10,
                                         im_dim=D, text_dim=E, seed=0)
    spec = EpisodeSpec(B, N, K, Q, D, E)

    def host():
        return sampler.HostEpisodeSampler(table, ids, cs, spec, seed=3,
                                          device="cpu")
    a, b = host(), host()
    first = a.sample()
    clone = a.watch_clone()
    side = [clone.sample() for _ in range(3)]
    assert torch.equal(b.sample().support_ids, first.support_ids)
    assert torch.equal(a.sample().support_ids, b.sample().support_ids)
    assert not torch.equal(side[0].support_ids, first.support_ids)


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(None) as prof:
        assert prof is None
    table = torch.randn(20, D)
    rows = torch.randint(0, 20, (B, N, K + Q), dtype=torch.int32)
    with profile_trace(str(tmp_path / "trace")):
        kernels.gather_episode_rows(table, rows, K)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "gather_episode_rows" in names
