"""``serve.SeedEnsemble`` against ``fumi_tpu.serve.SeedEnsemble``, on the CPU.

The same stacked replica weights (three seeds of FuMI, MAML and AM3,
bridged from the JAX package's sweep family), noise-free encoders:
``adapt``/``logits``, ``classify`` and the one-call ``episode_logits`` and
``episode_logits_batch`` within 1e-4 with the same labels. Then a sweep run
dir that the port's driver wrote, served by ``serve_http`` (which detects
it and prints ``seed ensemble: 3 replicas from ...``) on loopback beside
the JAX package's server on the same weights: same status codes, answers
within 1e-4, and ``/v1/reload`` of the run dir.
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
from fumi_tpu.serve import SeedEnsemble as JaxEnsemble
from fumi_tpu.serve_http import make_server as jax_make_server
from fumi_tpu.train import sweep as jax_sweep
from fumi_tpu_torch import bridge, serve_http
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.serve import FewShotClassifier, SeedEnsemble, replica_seed
from fumi_tpu_torch.train import sweep

N, K, M, D, E, S = 3, 2, 5, 16, 8, 3
TOL = dict(rtol=1e-4, atol=1e-4)
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(16, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_shots_test=3, batch_size=2,
             num_test_adapt_steps=3, step_size=0.1, dropout=0.0,
             text_encoder="precomputed", seed=0, seed_sweep=S)
    d.update(kw)
    return d


def port_stack(jax_params, model):
    return sweep.stack_trees([bridge.params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x[i]), jax_params), model, device="cpu")
        for i in range(S)])


@pytest.fixture(scope="module", params=["fumi", "maml", "am3"])
def ensembles(request):
    model = request.param
    jcfg = JaxConfig(**cfg_kw(model))
    stacked = jax_sweep.build_sweep_family(jcfg).params
    return (model, JaxEnsemble(jcfg, stacked),
            SeedEnsemble(Config(**cfg_kw(model)), port_stack(stacked, model),
                         device="cpu"))


def request_arrays(seed, R=None):
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    y = np.repeat(np.arange(N), K).astype(np.int32)
    return (rng.randn(*lead, N * K, D).astype(np.float32),
            y if R is None else np.tile(y, (R, 1)),
            rng.randn(*lead, M, D).astype(np.float32),
            rng.randn(*lead, N * K, E).astype(np.float32))


def test_stateful_pair_matches_jax(ensembles):
    model, jens, tens = ensembles
    s_im, s_y, q_im, s_tx = request_arrays(0)
    jens.adapt(s_im, s_tx, s_y)
    tens.adapt(s_im, s_tx, s_y)
    np.testing.assert_allclose(tens.logits(q_im), jens.logits(q_im), **TOL)
    np.testing.assert_array_equal(tens.classify(q_im), jens.classify(q_im))
    np.testing.assert_allclose(tens.classify(q_im, return_probs=True),
                               jens.classify(q_im, return_probs=True), **TOL)
    assert tens.num_seeds == jens.num_seeds == S


def test_episode_paths_match_jax(ensembles):
    model, jens, tens = ensembles
    s_im, s_y, q_im, s_tx = request_arrays(1)
    got = tens.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    want = jens.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the one-call answer is the stateful one
    tens.adapt(s_im, s_tx, s_y)
    np.testing.assert_allclose(tens.logits(q_im), got, rtol=1e-5, atol=1e-6)
    b = request_arrays(2, R=3)
    got = tens.episode_logits_batch(*b[:3], support_text=b[3])
    want = jens.episode_logits_batch(*b[:3], support_text=b[3])
    assert got.shape == want.shape == (3, M, N)
    np.testing.assert_allclose(got, want, **TOL)


def test_the_answer_is_the_mean_of_the_replicas_probabilities(ensembles):
    model, _, tens = ensembles
    s_im, s_y, q_im, s_tx = request_arrays(3)
    probs = []
    for i in range(S):
        solo = FewShotClassifier(tens.cfg, sweep.unstack_tree(tens.params, i),
                                 device="cpu")
        logits = solo.episode_logits(s_im, s_y, q_im, support_text=s_tx,
                                     seed=replica_seed(0, i))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs.append(e / e.sum(-1, keepdims=True))
    np.testing.assert_allclose(
        tens.episode_logits(s_im, s_y, q_im, support_text=s_tx),
        np.log(np.mean(probs, axis=0) + 1e-9), rtol=1e-5, atol=1e-6)
    assert len({replica_seed(7, i) for i in range(S)}) == S


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


def test_a_sweep_run_dir_over_http_answers_as_the_jax_server(tmp_path,
                                                             capsys):
    argv = ["--model", "fumi", "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "16", "8",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", "3", "--batch_size", "2",
            "--num_ep_test", "4", "--epochs", "4", "--eval_freq", "2",
            "--num_train_adapt_steps", "1", "--num_test_adapt_steps", "3",
            "--lr", "0.05", "--step_size", "0.1", "--dropout", "0",
            "--text_encoder", "precomputed", "--seed", "0",
            "--wandb_offline", "--disable_cuda", "--tpu_seed_sweep", str(S),
            "--log_dir", str(tmp_path)]
    cli_main.cli(argv)
    (run,) = glob.glob(str(tmp_path / "runs" / "*"))
    cfg = config_from_args(argv)
    capsys.readouterr()
    tens = serve_http.build_classifier(cfg, run)
    assert f"seed ensemble: {S} replicas from {run}/seed*/" in \
        capsys.readouterr().out
    assert isinstance(tens, SeedEnsemble) and tens.num_seeds == S
    jstack = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[bridge.params_to_numpy(sweep.unstack_tree(tens.params, i), "fumi")
          for i in range(S)])
    jens = JaxEnsemble(JaxConfig(**cfg_kw("fumi")), jstack)
    started = [serve(jens, jax_make_server), serve(tens,
                                                   serve_http.make_server)]
    (_, j_url), (_, t_url) = started
    try:
        s_im, s_y, q_im, s_tx = request_arrays(4)
        body = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
                "query_im": q_im.tolist(), "support_text": s_tx.tolist(),
                "return": "probs"}
        b = request_arrays(5, R=2)
        batch = {"support_im": b[0].tolist(), "support_y": b[1].tolist(),
                 "query_im": b[2].tolist(), "support_text": b[3].tolist(),
                 "return": "logits"}
        cases = [("/v1/classify", {"query_im": q_im.tolist()}),
                 ("/v1/episode", body), ("/v1/episode_batch", batch),
                 ("/v1/adapt", body), ("/v1/classify", body),
                 ("/v1/episode", {"support_im": s_im.tolist()}),
                 ("/v1/nope", body)]
        for path, req in cases:
            (js, jr), (ts, tr) = call(j_url, path, req), call(t_url, path,
                                                              req)
            assert js == ts, (path, jr, tr)
            if js == 200 and "result" in jr:
                np.testing.assert_allclose(np.asarray(tr["result"]),
                                           np.asarray(jr["result"]), **TOL)
        before = call(t_url, "/v1/episode", body)[1]["result"]
        assert call(t_url, "/v1/reload", {"checkpoint": run})[0] == 200
        assert call(t_url, "/v1/episode", body)[1]["result"] == before
        empty = tmp_path / "empty"
        os.makedirs(empty)
        assert call(t_url, "/v1/reload", {"checkpoint": str(empty)})[0] == 400
        assert call(t_url, "/healthz")[1]["backend"] == "cpu"
    finally:
        for server, _ in started:
            server.shutdown()
            server.server_close()
    # from the run dir's own config.json, as from_sweep_run defaults
    again = SeedEnsemble.from_sweep_run(run, device="cpu")
    for k, v in again.params.items():
        assert torch.equal(v, tens.params[k])
