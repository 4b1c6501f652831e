"""CLIP in the port against the JAX package's, on the CPU: the model, the
supervised batches, the masked loss, ``training_run`` and ``evaluate``,
the driver, ``ClipRetrieval`` and its HTTP service.

Widths: text 24, image 40, latent 16; 10 classes of 12 images (the
supervised set has 120 items), batches of 16, 5-image retrieval windows.
Weights are bridged from the JAX side.

Tolerances: the batches, dedupes and windows are numpy on both sides,
bitwise. The forward and the loss are a few fp32 matmuls and a norm
summed in other orders: 1e-5. ``evaluate`` is a count of argmax wins on
the same params: exactly equal. Two epochs of Adam (16 steps) compound
the forward's rounding: params within 1e-4, and ``best/`` chosen on the
same epochs. Retrieval scores within 1e-5 with equal indices (the test's
scores are distinct); HTTP answers as the JAX server's, same status
codes.
"""

import glob
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.data import supervised as jax_sup
from fumi_tpu.data.synthetic import synthetic_class_set
from fumi_tpu.models.clip import CLIP as JaxCLIP
from fumi_tpu.serve import ClipRetrieval as JaxRetrieval
from fumi_tpu.serve_http import make_server as jax_make_server
from fumi_tpu.train import clip_loop as jax_loop
from fumi_tpu.train.logging import MetricWriter as JaxWriter
from fumi_tpu.train.optim import init_optim as jax_init_optim
from fumi_tpu_torch import bridge, serve_http
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.data import supervised
from fumi_tpu_torch.models.clip import CLIP
from fumi_tpu_torch.serve import ClipRetrieval, RequestError, warmup
from fumi_tpu_torch.train import checkpoint, clip_loop, optim
from fumi_tpu_torch.train.logging import MetricWriter

TXT, IM, LAT, BATCH = 24, 40, 16, 16
TOL = dict(rtol=1e-5, atol=1e-5)
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def cfg_kw(**kw):
    d = dict(model="clip", dataset="synthetic", text_emb_dim=TXT,
             im_emb_dim=IM, clip_latent_dim=LAT, batch_size=BATCH,
             num_ways=5, epochs=2, lr=1e-2, optim="adam", seed=0)
    d.update(kw)
    return d


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(seed=0):
    model = JaxCLIP(text_input_dim=TXT, image_input_dim=IM, latent_dim=LAT)
    return model, model.init_params(jax.random.PRNGKey(seed))


def port_params(jparams):
    return bridge.params_from_jax(np_tree(jparams), "clip", device="cpu")


def port_model():
    return CLIP(text_input_dim=TXT, image_input_dim=IM, latent_dim=LAT)


@pytest.fixture(scope="module")
def data():
    """(JAX SupervisedSet, port SupervisedSet, image table)."""
    cs, table, _ = synthetic_class_set(num_classes=10, images_per_class=12,
                                       im_dim=IM, text_dim=TXT, seed=1)
    return (jax_sup.supervised_from_class_set(cs),
            supervised.supervised_from_class_set(cs), table)


def inputs(seed, nt=7, ni=9):
    rng = np.random.RandomState(seed)
    return (rng.randn(nt, TXT).astype(np.float32),
            rng.randn(ni, IM).astype(np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_symmetric_loss_match(seed):
    jm, jp = jax_model(seed)
    tm, tp = port_model(), port_params(jp)
    text, image = inputs(seed)
    np.testing.assert_allclose(
        tm.forward(tp, torch.from_numpy(text), torch.from_numpy(image))
        .numpy(), np.asarray(jm.forward(jp, jnp.asarray(text),
                                        jnp.asarray(image))), **TOL)
    for enc in ("encode_text", "encode_image"):
        x = text if enc == "encode_text" else image
        got = getattr(tm, enc)(tp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(getattr(jm, enc)(jp, jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-6)
    text, image = inputs(seed + 5, nt=6, ni=6)
    np.testing.assert_allclose(
        float(tm.symmetric_ce_loss(tp, torch.from_numpy(text),
                                   torch.from_numpy(image))),
        float(jm.symmetric_ce_loss(jp, jnp.asarray(text),
                                   jnp.asarray(image))), **TOL)


def test_norm_is_not_clamped_at_small_norms():
    """Each embedding is divided by its norm, with no eps clamp: an input
    whose projection has a tiny norm still comes out of unit length."""
    tm, tp = port_model(), port_params(jax_model()[1])
    tp = {k: v * (1e-7 if k.startswith("image_fc2") else 1.0)
          for k, v in tp.items()}
    out = tm.encode_image(tp, torch.from_numpy(inputs(2)[1]))
    np.testing.assert_allclose(torch.linalg.norm(out, dim=-1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("valid", [1, 4, 6])
def test_masked_loss_equals_the_deduped_slice(valid):
    """The static-shape masked loss equals the loss of the first ``valid``
    rows sliced out, and JAX's masked loss, 1e-5; its gradient is the
    sliced loss's."""
    jm, jp = jax_model(1)
    tm, tp = port_model(), port_params(jp)
    text, image = inputs(3, nt=6, ni=6)
    t, i = torch.from_numpy(text), torch.from_numpy(image)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    masked = clip_loop.masked_symmetric_ce(tm, leaves, t, i, valid)
    sliced = tm.symmetric_ce_loss(leaves, t[:valid], i[:valid])
    np.testing.assert_allclose(float(masked.detach()),
                               float(sliced.detach()), **TOL)
    np.testing.assert_allclose(
        float(masked.detach()), float(jax_loop.masked_symmetric_ce(
            jm, jp, jnp.asarray(text), jnp.asarray(image),
            jnp.asarray(valid))), **TOL)
    g_m = torch.autograd.grad(masked, list(leaves.values()))
    g_s = torch.autograd.grad(sliced, list(leaves.values()))
    for a, b in zip(g_m, g_s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the supervised batches, dedupe and evaluate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_batches_and_dedupe_bitwise(data, shuffle):
    jds, tds, table = data
    for f in ("image_rows", "category_ids", "class_index", "text_features"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    got = list(supervised.epoch_batches(tds, table, BATCH,
                                        np.random.RandomState(4), shuffle))
    want = list(jax_sup.epoch_batches(jds, table, BATCH,
                                      np.random.RandomState(4), shuffle))
    assert len(got) == len(want) == 8 and got[-1][3] == 120 - 7 * BATCH
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
        for a, b in zip(clip_loop.dedupe_batch(*g),
                        jax_loop.dedupe_batch(*w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eval_seed", [None, 5, 2 ** 31 + 3])
def test_evaluate_is_exactly_the_jax_accuracy(data, eval_seed):
    jds, tds, table = data
    jm, jp = jax_model(2)
    cfg = Config(**cfg_kw())
    want = jax_loop.evaluate(JaxConfig(**cfg_kw()), jm, jp, (jds, table),
                             eval_seed=eval_seed)
    got = clip_loop.evaluate(cfg, port_model(), port_params(jp),
                             (tds, table), eval_seed=eval_seed)
    assert got == want and 0.0 < got < 1.0


def test_training_run_matches_the_jax_loop(data, tmp_path):
    """Two epochs from the same weights on the same batches: params within
    1e-4, the same validation accuracies (the metric log), and ``best/``
    written on the same epochs with the same accuracy."""
    jds, tds, table = data
    jm, jp = jax_model(3)
    jcfg, cfg = JaxConfig(**cfg_kw()), Config(**cfg_kw())
    jw = JaxWriter(str(tmp_path / "jax"), use_wandb=False)
    jout = jax_loop.training_run(
        jcfg, jm, jp, jax_init_optim("adam", 1e-2, jcfg.weight_decay),
        (jds, table), (jds, table), jw, str(tmp_path / "jax_run"),
        np.random.RandomState(0))
    jw.finish()
    tw = MetricWriter(str(tmp_path / "port"), use_wandb=False)
    tout = clip_loop.training_run(
        cfg, port_model(), port_params(jp),
        optim.init_optim("adam", 1e-2, cfg.weight_decay), (tds, table),
        (tds, table), tw, str(tmp_path / "port_run"),
        np.random.RandomState(0))
    tw.finish()
    for a, b in zip(jax.tree_util.tree_leaves(
            bridge.params_to_numpy(tout, "clip")),
            jax.tree_util.tree_leaves(np_tree(jout))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def logged(root):
        (path,) = glob.glob(os.path.join(root, "*.metrics.jsonl"))
        return [json.loads(line)["val/acc"] for line in open(path)
                if "val/acc" in line]
    assert logged(str(tmp_path / "port")) == logged(str(tmp_path / "jax"))
    metas = [json.load(open(tmp_path / run / "best.meta.json"))
             for run in ("port_run", "jax_run")]
    assert [(m["batch_idx"], m["best_loss"], m["model"]) for m in metas[:1]] \
        == [(m["batch_idx"], m["best_loss"], m["model"]) for m in metas[1:]]
    assert torch.equal(tout["text_fc.weight"], checkpoint.load_checkpoint(
        str(tmp_path / "port_run"), tout,
        optim.init_optim("adam", 1e-2).init(tout))[0]["text_fc.weight"])


def test_training_run_refuses_a_mesh(data, tmp_path):
    """Multi-device CLIP runs since item 9 was ported
    (tests/test_torch_distributed.py); a dp mesh that does not divide the
    batch is refused before any collective."""
    import types
    jds, tds, table = data
    cfg = Config(**cfg_kw())
    model, params = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    opt = optim.init_optim("adam", 1e-2)
    mesh = types.SimpleNamespace(dp=cfg.batch_size + 1, dp_index=0)
    with pytest.raises(ValueError, match="not divisible by dp"):
        clip_loop.training_run(cfg, model, params, opt, (tds, table),
                               (tds, table), None, str(tmp_path),
                               np.random.RandomState(0), mesh=mesh)
    # bf16 builds since the policy was ported (tests/test_torch_bf16.py)
    bf16, _ = clip_loop.make_clip(cfg.replace(compute_dtype="bfloat16"),
                                  torch.Generator())
    assert bf16.compute_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def driver_argv(log_dir, *extra):
    return ["--model", "clip", "--dataset", "synthetic", "--text_emb_dim",
            str(TXT), "--im_emb_dim", str(IM), "--clip_latent_dim",
            str(LAT), "--batch_size", "32", "--epochs", "2", "--lr", "0.01",
            "--seed", "0", "--wandb_offline", "--disable_cuda",
            "--log_dir", str(log_dir), *extra]


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    """(argv, run dir, test metrics) of a CLIP run of the port's driver."""
    log_dir = tmp_path_factory.mktemp("clip")
    argv = driver_argv(log_dir)
    out = cli_main.cli(argv)
    (run,) = glob.glob(os.path.join(str(log_dir), "runs", "*"))
    return argv, run, out


def test_driver_trains_tests_and_reproduces(clip_run, tmp_path, capsys):
    argv, run, out = clip_run
    assert set(out) == {"test/acc"} and 0.0 <= out["test/acc"] <= 1.0
    for name in ("ckpt", "ckpt.meta.json", "config.json"):
        assert os.path.exists(os.path.join(run, name))
    with open(os.path.join(run, "ckpt.meta.json")) as f:
        meta = json.load(f)
    assert meta["model"] == "clip" and meta["batch_idx"] == 1
    again = cli_main.cli(driver_argv(tmp_path, "--evaluate",
                                     "--checkpoint", run))
    assert again == out
    assert f"TEST: test acc: {out['test/acc']}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="precomputed"):
        cli_main.cli(driver_argv(tmp_path, "--text_encoder", "glove"))


# ---------------------------------------------------------------------------
# serving: ClipRetrieval and ClipService against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def retrievals():
    jr = JaxRetrieval(JaxConfig(**cfg_kw()), None)
    tr = ClipRetrieval(Config(**cfg_kw()), port_params(jr.params),
                       device="cpu")
    return jr, tr


def test_retrieval_matches_the_jax_server(retrievals):
    jr, tr = retrievals
    rng = np.random.RandomState(8)
    gallery = rng.randn(30, IM).astype(np.float32)
    text = rng.randn(6, TXT).astype(np.float32)
    with pytest.raises(RuntimeError, match="index"):
        ClipRetrieval(tr.cfg, tr.params, device="cpu").retrieve(text)
    assert tr.index(gallery) == jr.index(gallery) == 30
    assert tr.gallery_size == 30
    for k in (1, 5, 50):
        ti, ts = tr.retrieve(text, k)
        ji, js = jr.retrieve(text, k)
        assert ti.dtype == np.int32 and ti.shape == (6, min(k, 30))
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), **TOL)
    for fn, args in ((tr.retrieve, (text[:, 1:],)),
                     (tr.index, (gallery[:, 1:],)),
                     (tr.similarity, (text, gallery[:, 1:])),
                     (tr.similarity, (text[0], gallery))):
        with pytest.raises(RequestError, match="must be"):
            fn(*args)
    assert tr.gallery_size == 30
    sim = tr.similarity(text, gallery[:7])
    np.testing.assert_allclose(sim, np.asarray(jr.similarity(
        text, gallery[:7])), **TOL)
    np.testing.assert_array_equal(sim, tr.model.forward(
        tr.params, torch.from_numpy(text),
        torch.from_numpy(gallery[:7])).numpy())


def test_from_checkpoint_reload_and_warmup(clip_run, capsys):
    argv, run, _ = clip_run
    cfg = config_from_args(argv)
    tr = ClipRetrieval.from_checkpoint(run, cfg, device="cpu")
    model, params = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    want, _, _ = checkpoint.load_checkpoint(
        run, params, optim.init_optim(cfg.optim, cfg.lr).init(params))
    assert all(torch.equal(tr.params[k], want[k]) for k in want)
    tr.index(np.random.RandomState(0).randn(5, IM).astype(np.float32))
    tr.reload(run, best=False)
    assert tr.gallery_size == 0
    with pytest.raises(RuntimeError):
        tr.retrieve(np.zeros((1, TXT), np.float32))
    warmup(tr)
    assert "warmup: skipped" in capsys.readouterr().out


def serve(clf, make_server):
    server = make_server(clf, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with OPENER.open(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_clip_service_answers_as_the_jax_server(clip_run):
    """index, retrieve (409 before any index), similarity, reload and
    healthz on both servers, same bodies: the same status codes, indices
    equal, scores within 1e-5. ``/v1/reload`` of a port run dir drops the
    gallery (409 after it) and serves that run's weights."""
    jr = JaxRetrieval(JaxConfig(**cfg_kw()), None)
    tr = ClipRetrieval(Config(**cfg_kw()), port_params(jr.params),
                       device="cpu")
    servers = [serve(jr, jax_make_server), serve(tr, serve_http.make_server)]
    try:
        rng = np.random.RandomState(9)
        images = rng.randn(12, IM).tolist()
        text = rng.randn(3, TXT).tolist()
        bodies = [("/v1/clip/retrieve", {"text": text}),
                  ("/v1/clip/index", {"images": images}),
                  ("/v1/clip/retrieve", {"text": text, "top_k": 4}),
                  ("/v1/clip/similarity", {"text": text,
                                           "images": images[:5]}),
                  ("/v1/clip/index", {}),
                  ("/v1/clip/retrieve", {"text": "x"}),
                  ("/v1/episode", {"text": text}),
                  ("/v1/reload", {"checkpoint": "/no/such/run"})]
        for path, body in bodies:
            (js, jb), (ts, tb) = (call(url, path, body)
                                  for _, url in servers)
            assert ts == js, (path, tb, jb)
            if ts != 200:
                continue
            for key in jb:
                if key == "scores" or key == "similarity":
                    np.testing.assert_allclose(tb[key], jb[key], **TOL)
                else:
                    assert tb[key] == jb[key], (path, key)
        # a text or image of another width: 400 on the port, which checks
        # the shape before the device sees it; the JAX server's projection
        # raises a TypeError there, which it answers 500
        for path, body in (
                ("/v1/clip/retrieve", {"text": [r[1:] for r in text]}),
                ("/v1/clip/index", {"images": [r[1:] for r in images]}),
                ("/v1/clip/similarity", {"text": text, "images": [
                    r[1:] for r in images[:5]]})):
            (js, jb), (ts, tb) = (call(url, path, body)
                                  for _, url in servers)
            assert (ts, js) == (400, 500), (path, tb, jb)
            assert "must be" in tb["error"]
        assert [call(url, "/healthz")[1]["gallery"]
                for _, url in servers] == [12, 12]
        assert call(servers[1][1], "/healthz")[1]["model"] == "clip"
        _, run, _ = clip_run
        url = servers[1][1]
        assert call(url, "/v1/reload", {"checkpoint": run}) == (
            200, {"ok": True, "checkpoint": run})
        assert call(url, "/v1/clip/retrieve", {"text": text})[0] == 409
        assert call(url, "/healthz")[1]["gallery"] == 0
        status, sim = call(url, "/v1/clip/similarity",
                           {"text": text, "images": images[:5]})
        want = ClipRetrieval.from_checkpoint(run, tr.cfg,
                                             device="cpu").similarity(
            np.asarray(text, np.float32), np.asarray(images[:5], np.float32))
        assert status == 200
        np.testing.assert_array_equal(np.asarray(sim["similarity"],
                                                 np.float32), want)
    finally:
        for server, _ in servers:
            server.shutdown()
            server.server_close()


def test_build_classifier_serves_clip(clip_run):
    argv, run, _ = clip_run
    cfg = config_from_args(argv)
    clf = serve_http.build_classifier(cfg, run)
    assert isinstance(clf, ClipRetrieval) and clf.device.type == "cpu"
    fresh = serve_http.build_classifier(cfg, None)
    assert isinstance(fresh, ClipRetrieval)
    assert any(not torch.equal(clf.params[k], fresh.params[k])
               for k in clf.params)
