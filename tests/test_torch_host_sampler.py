"""The port's host samplers and native index sampler against the JAX
package's, on the CPU.

Indices, rows, text, labels and ids are compared bitwise for the same seed
on both backends and every table dtype (fp32 embeddings, raw uint8 pixels,
bf16-stored rows). The ``--augment`` jitter draws other random bits than
JAX's, so it is held against the port's own plain version on the seed the
numpy stream gives, and the stream after it against JAX's. Loader
processes are checked under ``fork`` and ``spawn``; every wait on a thread
or process is bounded.
"""

import os
import signal
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.episode import EpisodeSpec as JaxSpec
from fumi_tpu.data import sampler as jax_sampler
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu_torch import native
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.data import sampler
from fumi_tpu_torch.data.class_set import ClassSet
from fumi_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, K, Q, D, E = 2, 3, 2, 3, 16, 8
FIELDS = ("support_im", "support_text", "support_ids", "support_y",
          "query_im", "query_ids", "query_y")


@pytest.fixture(scope="module")
def data():
    cs, table, ids = synthetic_class_set(num_classes=8, images_per_class=9,
                                         im_dim=D, text_dim=E, seed=3)
    return cs, table, ids


def port_set(cs) -> ClassSet:
    return ClassSet(categories=cs.categories,
                    class_image_rows=cs.class_image_rows,
                    class_counts=cs.class_counts,
                    text_features=cs.text_features)


def pair(data, table=None, seed=5, backend="native", augment=0.0):
    cs, t, ids = data
    t = t if table is None else table
    j = jax_sampler.HostEpisodeSampler(
        t[0] if isinstance(t, tuple) else t, ids, cs,
        JaxSpec(B, N, K, Q, D, E), seed=seed, backend=backend,
        augment_scale=augment)
    p = sampler.HostEpisodeSampler(
        t[1] if isinstance(t, tuple) else t, ids, port_set(cs),
        EpisodeSpec(B, N, K, Q, D, E), seed=seed, backend=backend,
        augment_scale=augment, device="cpu")
    return j, p


def assert_same(jep, tep, fields=FIELDS):
    for f in fields:
        want = np.asarray(getattr(jep, f))
        got = getattr(tep, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def bounded(fn, seconds=60.0):
    """``fn()`` on a thread joined with a timeout: a hang fails the test
    instead of stalling the run."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=seconds)
    assert not t.is_alive(), f"no answer within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def test_the_native_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "fumi_tpu", "native",
                           "episodic_sampler.cpp"), "rb") as f:
        theirs = f.read()
    with open(native.SOURCE, "rb") as f:
        assert f.read() == theirs


def test_the_native_library_builds_into_the_ports_build_dir():
    lib = native.load()
    assert lib is not None, "g++ could not build the native sampler"
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "fumi_tpu_torch",
                                                 "build")
    counts = np.array([10, 12, 8, 20, 9, 15], dtype=np.int32)
    from fumi_tpu import native as jax_native
    jlib = jax_native.load()
    for counter in (0, 7):
        got = native.sample_episodes_native(lib, 42, counter, counts, 4, 3, 7)
        want = jax_native.sample_episodes_native(jlib, 42, counter, counts,
                                                 4, 3, 7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    table = np.random.RandomState(0).randn(50, 33).astype(np.float32)
    rows = np.array([3, 49, 0, 3], dtype=np.int32)
    np.testing.assert_array_equal(native.gather_rows_native(lib, table, rows),
                                  table[rows])
    with pytest.raises(ValueError, match="N exceeds"):
        native.sample_episodes_native(lib, 0, 0, counts[:2], 1, 3, 2)


def test_the_port_never_loads_the_jax_packages_library():
    code = (
        "import numpy as np\n"
        "from fumi_tpu_torch.data import sampler\n"
        "from fumi_tpu_torch.data.synthetic import synthetic_class_set\n"
        "from fumi_tpu_torch.core.episode import EpisodeSpec\n"
        "cs, t, ids = synthetic_class_set(num_classes=6, "
        "images_per_class=8, im_dim=4, text_dim=4)\n"
        "s = sampler.HostEpisodeSampler(t, ids, cs, "
        "EpisodeSpec(1, 3, 2, 2, 4, 4), backend='native', device='cpu')\n"
        "s.sample()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'fumi_tpu/native/libepisodic' not in maps\n"
        "assert 'fumi_tpu_torch/build/libepisodic-' in maps\n"
        "import sys\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'fumi_tpu.')) "
        "for m in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_index_and_row_streams_equal_the_jax_samplers(data, backend):
    j, p = pair(data, backend=backend)
    assert p.backend_name == j.backend_name == backend
    for _ in range(4):
        assert_same(j.sample(), p.sample())


@pytest.mark.parametrize("kind", ["uint8 raw", "bf16"])
def test_raw_and_bf16_tables_give_the_jax_rows(data, kind):
    cs, table, ids = data
    rng = np.random.RandomState(1)
    if kind == "uint8 raw":
        raw = rng.randint(0, 256, (table.shape[0], 4, 4, 3)).astype(np.uint8)
        tables = (raw, raw)
    else:
        bf = jnp.asarray(table, jnp.bfloat16)
        tables = (np.asarray(bf), torch.from_numpy(
            np.asarray(bf).view(np.int16).copy()).view(torch.bfloat16))
    for backend in ("native", "numpy"):
        j, p = pair(data, table=tables, backend=backend)
        for _ in range(3):
            jep, tep = j.sample(), p.sample()
            assert tep.support_im.dtype == torch.float32
            assert_same(jep, tep)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_augmented_episodes_keep_the_jax_stream(data, backend):
    """Three augmented episodes, then the fourth's indices equal JAX's:
    the seed is drawn from the numpy stream as JAX draws its key, so the
    stream stays JAX's (the jitter's bits are the port's own)."""
    j, p = pair(data, backend=backend, augment=0.1)
    for _ in range(3):
        jep, tep = j.sample(), p.sample()
        assert_same(jep, tep, [f for f in FIELDS if f != "support_im"])
        assert not np.array_equal(tep.support_im.numpy(),
                                  np.asarray(jep.support_im))
    assert p.rng.get_state()[2] == j.rng.get_state()[2]
    np.testing.assert_array_equal(p.rng.get_state()[1],
                                  j.rng.get_state()[1])
    assert_same(j.sample(), p.sample(),
                ("support_ids", "query_ids", "support_text", "query_im"))


def test_the_jitter_is_the_kernel_on_the_drawn_seed(data):
    """On the numpy backend the seed follows the episode's draws: replay
    the stream, take the seed, and the support rows are
    ``augment_embeddings`` of the unjittered rows with it."""
    _, p = pair(data, backend="numpy", augment=0.1)
    _, clean = pair(data, backend="numpy")
    for _ in range(2):
        state = p.rng.get_state()
        tep = p.sample()
        replay = np.random.RandomState()
        replay.set_state(state)
        clean.rng = replay
        cep = clean.sample()  # the same indices from the same stream
        seed = int(replay.randint(0, 2 ** 31))
        assert replay.get_state()[2] == p.rng.get_state()[2]
        np.testing.assert_array_equal(tep.support_ids, cep.support_ids)
        want = kernels.augment_embeddings_reference(
            cep.support_im.reshape(B * N * K, D).contiguous(),
            torch.tensor([seed], dtype=torch.int64), 0.1)
        np.testing.assert_array_equal(
            tep.support_im.reshape(B * N * K, D).numpy(), want.numpy())
        np.testing.assert_array_equal(tep.query_im, cep.query_im)


def test_raw_augmentation_flips_and_crops_from_the_drawn_seed(data):
    cs, table, ids = data
    raw = np.random.RandomState(2).randint(
        0, 256, (table.shape[0], 6, 6, 3)).astype(np.uint8)
    p = sampler.HostEpisodeSampler(raw, ids, port_set(cs),
                                   EpisodeSpec(B, N, K, Q, D, E), seed=4,
                                   backend="numpy", augment_scale=0.1,
                                   device="cpu")
    state = p.rng.get_state()
    tep = p.sample()
    replay = np.random.RandomState()
    replay.set_state(state)
    clean = sampler.HostEpisodeSampler(raw, ids, port_set(cs),
                                       EpisodeSpec(B, N, K, Q, D, E),
                                       backend="numpy", device="cpu")
    clean.rng = replay
    cep = clean.sample()
    seed = int(replay.randint(0, 2 ** 31))
    gen = torch.Generator().manual_seed(seed)
    flat = cep.support_im.reshape(B * N * K, 6, 6, 3)
    want = sampler.augment_raw_images(
        flat, *sampler.raw_augment_noise(B * N * K, gen))
    np.testing.assert_array_equal(tep.support_im.reshape(want.shape), want)
    np.testing.assert_array_equal(tep.query_im, cep.query_im)


def test_watch_clone_draws_its_own_stream(data):
    j, p = pair(data, backend="numpy")
    jc, pc = j.watch_clone(), p.watch_clone()
    assert pc.seed == jc.seed == p.seed + 0x5EED
    assert_same(jc.sample(), pc.sample())
    # the training stream is untouched by the clone's draws
    assert_same(j.sample(), p.sample())


def test_prefetching_keeps_the_stream_and_relays_a_failure(data):
    j, p = pair(data, backend="numpy")
    pre = sampler.PrefetchingSampler(p, depth=2)
    try:
        for _ in range(3):
            assert_same(j.sample(), bounded(pre.sample))
    finally:
        pre.close()

    class Failing(sampler.HostEpisodeSampler):
        def sample(self):
            raise KeyError("broken table")
    bad = Failing.__new__(Failing)
    bad.__dict__.update(p.__dict__)
    pre = sampler.PrefetchingSampler(bad)
    try:
        for _ in range(2):  # and it keeps raising
            with pytest.raises(KeyError, match="broken table"):
                bounded(pre.sample)
    finally:
        pre.close()


@pytest.mark.parametrize("ctx", ["fork", "spawn"])
def test_loader_processes_give_the_single_process_stream(data, ctx):
    j, p = pair(data, backend="native")
    j.sample()
    p.sample()  # the loader starts at the sampler's counter
    mp = sampler.MultiprocessSampler(p, num_workers=2, mp_context=ctx)
    try:
        for _ in range(5):
            assert_same(j.sample(), bounded(mp.sample, 120))
    finally:
        mp.close()
    assert p._counter == 6
    assert_same(j.sample(), p.sample())  # unwrapped, it goes on


class _FailsAt(sampler.HostEpisodeSampler):
    """A sampler whose draw of episode ``fail_at`` raises (module level,
    so loader processes can unpickle it)."""
    fail_at = 2

    def _indices_at(self, counter):
        if counter == self.fail_at:
            raise ValueError(f"bad episode {counter}")
        return super()._indices_at(counter)


def test_a_worker_exception_reraises_after_the_episodes_before_it(data):
    cs, table, ids = data
    p = _FailsAt(table, ids, port_set(cs), EpisodeSpec(B, N, K, Q, D, E),
                 seed=5, backend="native", device="cpu")
    mp = sampler.MultiprocessSampler(p, num_workers=2)
    try:
        bounded(mp.sample)
        bounded(mp.sample)
        for _ in range(2):
            with pytest.raises(ValueError, match="bad episode 2"):
                bounded(mp.sample)
    finally:
        mp.close()


def test_a_killed_worker_raises_instead_of_hanging(data):
    _, p = pair(data, backend="native")
    mp = sampler.MultiprocessSampler(p, num_workers=2, depth=1)
    try:
        bounded(mp.sample)
        os.kill(mp._procs[1].pid, signal.SIGKILL)
        mp._procs[1].join(timeout=10)

        def drain():
            for _ in range(20):
                mp.sample()
        with pytest.raises(RuntimeError, match="died"):
            bounded(drain)
    finally:
        mp.close()
    assert all(not proc.is_alive() for proc in mp._procs)


def test_the_loader_refuses_what_it_cannot_stream(data):
    _, p = pair(data, backend="numpy")
    with pytest.raises(ValueError, match="native"):
        sampler.MultiprocessSampler(p, num_workers=2)
    _, p = pair(data, backend="native", augment=0.1)
    with pytest.raises(ValueError, match="augmentation"):
        sampler.MultiprocessSampler(p, num_workers=2)


# ---------------------------------------------------------------------------
# the harness and the driver on host samplers
# ---------------------------------------------------------------------------

def harness_cfg(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(8, 8), text_hid_dim=8, num_ways=N, num_shots=K,
             num_shots_test=Q, batch_size=B, num_train_adapt_steps=2,
             num_test_adapt_steps=3, step_size=0.1, dropout=0.0,
             optim="adam", lr=1e-2, num_ep_test=4, epochs=6, eval_freq=3,
             text_encoder="precomputed", seed=0, wandb_offline=True,
             device_sampler=False)
    d.update(kw)
    return d


@pytest.mark.parametrize("model,backend,kw", [
    ("fumi", "native", dict(ema=0.9, skip_nonfinite=2)),
    ("maml", "numpy", dict()),
], ids=["fumi-native-ema", "maml-numpy"])
def test_training_run_and_test_loop_on_host_samplers_match_jax(
        tmp_path, model, backend, kw):
    """Both packages' ``training_run`` and ``test_loop`` on their own host
    samplers (the same seeds, so the same episodes) from bridged weights:
    the train and val losses within 1e-4 (fp32, second order, other
    summation orders), the returned params (the EMA under ``--tpu_ema``)
    within 1e-4, the test metrics within 1e-4."""
    import jax
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.train import loop as jax_loop
    from fumi_tpu.train import steps as jax_steps
    from fumi_tpu.train.logging import MetricWriter as JaxWriter
    from fumi_tpu_torch import bridge
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.train import loop, steps
    from fumi_tpu_torch.train.logging import MetricWriter

    # eval episodes take int(100 / N) queries a class
    cs, table, ids = synthetic_class_set(num_classes=8, images_per_class=40,
                                         im_dim=D, text_dim=E, seed=3)
    jcfg = JaxConfig(**harness_cfg(model, **kw))
    cfg = Config(**harness_cfg(model, **kw))
    j_steps = jax_steps.make_steps(jcfg, jax.random.PRNGKey(0))
    t_steps = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    t_steps = t_steps._replace(params=bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_steps.params), model,
        device="cpu"))

    def samplers(pkg_sampler, spec, cset, **extra):
        return [pkg_sampler(table, ids, cset, spec(B, N, K, q, D, E),
                            seed=s, backend=backend, **extra)
                for s, q in ((0, Q), (1, cfg.num_query_eval),
                             (2, cfg.num_query_eval))]
    js = samplers(jax_sampler.HostEpisodeSampler, JaxSpec, cs)
    ts = samplers(sampler.HostEpisodeSampler, EpisodeSpec, port_set(cs),
                  device="cpu")

    class Recording:
        def __init__(self, base, path):
            self.w, self.records = base(path, use_wandb=False), []

        def log(self, metrics, step=None):
            self.records.append((step, dict(metrics)))
            self.w.log(metrics, step=step)

    jw = Recording(JaxWriter, str(tmp_path / "jw"))
    tw = Recording(MetricWriter, str(tmp_path / "tw"))
    jp = jax_loop.training_run(jcfg, j_steps, js[0], js[1], jw,
                               str(tmp_path / "jr"), jax.random.PRNGKey(1))
    tp = loop.training_run(cfg, t_steps, ts[0], ts[1], tw,
                           str(tmp_path / "tr"), cfg.seed)
    for prefix in ("train/loss", "val/loss"):
        jl = [(s, float(m[prefix])) for s, m in jw.records if prefix in m]
        tl = [(s, float(m[prefix])) for s, m in tw.records if prefix in m]
        assert [s for s, _ in tl] == [s for s, _ in jl] and tl, prefix
        np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                                   rtol=1e-4, atol=1e-4, err_msg=prefix)
    got = bridge.params_to_numpy(tp, model)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    jm = jax_loop.test_loop(jcfg, j_steps, jp, js[2], 3,
                            jax.random.PRNGKey(2), collect_artifacts=True)
    tm = loop.test_loop(cfg, t_steps, tp, ts[2], 3, None,
                        collect_artifacts=True)
    for k in ("loss", "acc", "loss_ci95", "acc_ci95"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert tm["query_idx"] == jm["query_idx"]
    assert tm["support_idx"] == jm["support_idx"]


@pytest.mark.parametrize("workers,evaluate", [(0, False), (1, False),
                                              (2, False), (2, True)])
def test_the_driver_chooses_the_jax_drivers_loader(data, capsys, workers,
                                                   evaluate):
    """``_samplers`` under ``--tpu_host_sampler``: the loader the JAX
    driver picks for ``--num_workers`` (processes for 2 and more on the
    native backend, a prefetch thread for 1, none under ``--evaluate``),
    with the same startup lines, and the same first episodes."""
    import fumi_tpu.cli.main as jax_cli
    from fumi_tpu.core.config import Config as JaxConfig
    from fumi_tpu.data.synthetic import synthetic_splits as jax_splits
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.data.synthetic import synthetic_splits

    kw = harness_cfg("maml", num_workers=workers, evaluate=evaluate)
    jsplits, table, ids = jax_splits(num_classes=32, images_per_class=40,
                                     im_dim=D, text_dim=E, seed=0)
    tsplits, t_table, t_ids = synthetic_splits(
        num_classes=32, images_per_class=40, im_dim=D, text_dim=E, seed=0)
    np.testing.assert_array_equal(table, t_table)
    j_out = jax_cli._samplers(JaxConfig(**kw).validate(), jsplits, table, ids)
    j_lines = capsys.readouterr().out
    t_out = cli_main._samplers(Config(**kw).validate(), tsplits, t_table,
                               t_ids, torch.device("cpu"))
    t_lines = capsys.readouterr().out
    try:
        assert t_lines == j_lines and "host sampler backend: native" in \
            t_lines
        assert [type(s).__name__ for s in t_out] == \
            [type(s).__name__ for s in j_out]
        for j, t in zip(j_out, t_out):
            assert_same(bounded(j.sample), bounded(t.sample))
    finally:
        for s in (*j_out, *t_out):
            getattr(s, "close", lambda: None)()
