"""The port's HTTP front-end (``fumi_tpu_torch.serve_http``) against the JAX
package's, both serving on loopback on the CPU.

Both servers get the same JSON bodies on classifiers with the same
weights (FuMI, MAML and AM3 on bridged JAX weights): answers within 1e-4
with equal labels, and the same status codes on every error path (400 for
a missing or bad field, 409 for classify before adapt, 404 for an unknown
route). The port's own paths: ``/v1/reload`` from a run dir the port's
driver wrote, a ``.pth.tar`` answering 400 "not ported", health from
torch, the lock that serialises requests on the worker threads, the
server's own flags equal to the JAX parser's, and ``main``'s refusals.
"""

import glob
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu.serve_http import build_net_parser as jax_net_parser
from fumi_tpu.serve_http import make_server as jax_make_server
from fumi_tpu_torch import bridge, serve_http
from fumi_tpu_torch.cli import main as cli_main
from fumi_tpu_torch.core.config import Config, config_from_args
from fumi_tpu_torch.serve import FewShotClassifier

N, K, M, D, E = 3, 2, 4, 16, 8
TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["fumi", "maml", "am3"]
# loopback only: no proxy may see these requests
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=D, text_emb_dim=E,
             im_hid_dim=(16, 8), text_hid_dim=8, prototype_dim=8,
             num_ways=N, num_shots=K, num_test_adapt_steps=3, step_size=0.1,
             dropout=0.0, text_encoder="precomputed", seed=0)
    d.update(kw)
    return d


def serve(clf, make_server):
    server = make_server(clf, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def servers():
    """model -> (JAX url, port url, port classifier), same weights."""
    out, started = {}, []
    for model in MODELS:
        jc = JaxClassifier(JaxConfig(**cfg_kw(model)), None)
        params = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jc.params), model,
            device="cpu")
        tc = FewShotClassifier(Config(**cfg_kw(model)), params, device="cpu")
        js, j_url = serve(jc, jax_make_server)
        ts, t_url = serve(tc, serve_http.make_server)
        started += [js, ts]
        out[model] = (j_url, t_url, tc)
    yield out
    for server in started:
        server.shutdown()
        server.server_close()


def call(url, path, body=None, raw=None):
    """(status, parsed JSON) of a GET (no body) or a POST."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with OPENER.open(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def bodies(seed, R=None):
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    y = np.repeat(np.arange(N), K)
    return {"support_im": rng.randn(*lead, N * K, D).tolist(),
            "support_text": rng.randn(*lead, N * K, E).tolist(),
            "support_y": (y if R is None else np.tile(y, (R, 1))).tolist(),
            "query_im": rng.randn(*lead, M, D).tolist()}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", ["logits", "probs", "labels"])
def test_episode_routes_answer_as_the_jax_server(servers, model, mode):
    j_url, t_url, _ = servers[model]
    for path, body in (("/v1/episode", bodies(0)),
                       ("/v1/episode_batch", bodies(1, R=3))):
        body = {**body, "return": mode}
        (js, jr), (ts, tr) = call(j_url, path, body), call(t_url, path, body)
        assert js == ts == 200
        got, want = np.asarray(tr["result"]), np.asarray(jr["result"])
        if mode == "labels":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("model", MODELS)
def test_adapt_then_classify_answers_as_the_jax_server(servers, model):
    j_url, t_url, _ = servers[model]
    body = bodies(2)
    support = {k: body[k] for k in ("support_im", "support_text",
                                    "support_y")}
    for url in (j_url, t_url):
        assert call(url, "/v1/adapt", support) == (200, {"ok": True})
    query = {"query_im": body["query_im"], "return": "probs"}
    (js, jr), (ts, tr) = (call(j_url, "/v1/classify", query),
                          call(t_url, "/v1/classify", query))
    assert js == ts == 200
    np.testing.assert_allclose(tr["result"], jr["result"], **TOL)
    labels = [call(u, "/v1/classify", {"query_im": body["query_im"]})
              for u in (j_url, t_url)]
    assert labels[0] == labels[1]


def error_cases():
    ok = bodies(3)
    bad_y = {**ok, "support_y": [N] * (N * K)}
    return {
        "missing_field": ("/v1/episode", {"support_im": ok["support_im"]}),
        "bad_field": ("/v1/episode", {**ok, "query_im": "abc"}),
        "bad_return_mode": ("/v1/episode", {**ok, "return": "nope"}),
        "label_out_of_range": ("/v1/episode", bad_y),
        "no_queries": ("/v1/episode", {**ok, "query_im": []}),
        "batch_without_request_axis": ("/v1/episode_batch", ok),
        "unknown_post_route": ("/v1/nope", ok),
        "invalid_json": ("/v1/episode", b"{not json"),
        "body_not_an_object": ("/v1/episode", [1, 2]),
        "reload_missing_field": ("/v1/reload", {}),
        "reload_not_found": ("/v1/reload", {"checkpoint": "/nonexistent"}),
        "adapt_missing_labels": ("/v1/adapt", {"support_im":
                                               ok["support_im"]}),
    }


@pytest.mark.parametrize("case", sorted(error_cases()))
def test_error_paths_give_the_jax_servers_status_codes(servers, case):
    j_url, t_url, _ = servers["fumi"]
    path, body = error_cases()[case]
    raw = body if isinstance(body, bytes) else None
    body = None if raw is not None else body
    (js, jr), (ts, tr) = (call(j_url, path, body, raw),
                          call(t_url, path, body, raw))
    assert ts == js, (tr, jr)
    assert 400 <= ts < 500 and "error" in tr


def test_classify_before_adapt_is_409_and_unknown_get_is_404():
    for make, clf in (
            (jax_make_server, JaxClassifier(JaxConfig(**cfg_kw("maml")),
                                            None)),
            (serve_http.make_server,
             FewShotClassifier(Config(**cfg_kw("maml")), device="cpu"))):
        server, url = serve(clf, make)
        try:
            status, payload = call(url, "/v1/classify",
                                   {"query_im": bodies(4)["query_im"]})
            assert status == 409 and "adapt" in payload["error"]
            assert call(url, "/nope")[0] == 404
        finally:
            server.shutdown()
            server.server_close()


def test_health_stats_and_metrics(servers):
    _, t_url, _ = servers["maml"]
    call(t_url, "/v1/episode", bodies(5))
    status, health = call(t_url, "/healthz")
    assert status == 200
    assert health == {"ok": True, "model": "maml", "backend": "cpu",
                      "devices": 1}
    status, stats = call(t_url, "/v1/stats")
    assert status == 200 and stats["routes"]["/v1/episode"]["count"] >= 1
    with OPENER.open(t_url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    assert 'fumi_tpu_requests_total{route="/v1/episode"}' in text


def test_the_lock_serialises_requests_on_worker_threads():
    """Requests run on the server's worker threads, one at a time: the
    classifier never sees two calls at once."""
    clf = FewShotClassifier(Config(**cfg_kw("maml")), device="cpu")
    inner, seen = clf.episode_logits, {"now": 0, "most": 0, "threads": set()}
    guard = threading.Lock()

    def watched(*a, **kw):
        with guard:
            seen["now"] += 1
            seen["most"] = max(seen["most"], seen["now"])
            seen["threads"].add(threading.get_ident())
        time.sleep(0.02)
        try:
            return inner(*a, **kw)
        finally:
            with guard:
                seen["now"] -= 1
    clf.episode_logits = watched
    server, url = serve(clf, serve_http.make_server)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = []
        clients = [threading.Thread(target=lambda: results.append(
            call(url, "/v1/episode", bodies(6))[0])) for _ in range(12)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
    assert results == [200] * 12
    assert seen["most"] == 1
    assert threading.get_ident() not in seen["threads"]


def driver_argv(log_dir):
    return ["--model", "fumi", "--dataset", "synthetic", "--im_emb_dim",
            str(D), "--text_emb_dim", str(E), "--im_hid_dim", "16", "8",
            "--text_hid_dim", "8", "--num_ways", str(N), "--num_shots",
            str(K), "--num_shots_test", "3", "--batch_size", "2",
            "--num_ep_test", "4", "--epochs", "2", "--eval_freq", "1",
            "--num_train_adapt_steps", "1", "--num_test_adapt_steps", "3",
            "--step_size", "0.1", "--lr", "0.05", "--text_encoder",
            "precomputed", "--seed", "0", "--wandb_offline",
            "--disable_cuda", "--log_dir", str(log_dir)]


def test_reload_over_http(tmp_path):
    """``/v1/reload`` swaps in a run dir's weights (the answers change to
    those of ``from_checkpoint``) and drops the adapted state (409 after
    it); a ``.pth.tar`` answers 400 with the "not ported" text naming its
    ROADMAP item, and the served weights stay."""
    argv = driver_argv(tmp_path / "log")
    cli_main.cli(argv)
    (run,) = glob.glob(str(tmp_path / "log" / "runs" / "*"))
    cfg = config_from_args(argv)
    clf = FewShotClassifier(cfg, device="cpu")
    server, url = serve(clf, serve_http.make_server)
    try:
        body = {**bodies(7), "return": "logits"}
        before = call(url, "/v1/episode", body)[1]["result"]
        support = {k: body[k] for k in ("support_im", "support_text",
                                        "support_y")}
        assert call(url, "/v1/adapt", support)[0] == 200
        assert call(url, "/v1/reload", {"checkpoint": run}) == (
            200, {"ok": True, "checkpoint": run})
        assert call(url, "/v1/classify", {"query_im": body["query_im"]})[0] \
            == 409
        after = call(url, "/v1/episode", body)[1]["result"]
        want = FewShotClassifier.from_checkpoint(run, cfg, device="cpu") \
            .episode_logits(*(np.asarray(body[k], dtype) for k, dtype in (
                ("support_im", np.float32), ("support_y", np.int32),
                ("query_im", np.float32))),
                support_text=np.asarray(body["support_text"], np.float32))
        np.testing.assert_array_equal(np.asarray(after, np.float32), want)
        assert not np.allclose(after, before)
        ref = tmp_path / "best.pth.tar"
        ref.write_bytes(b"x")
        status, payload = call(url, "/v1/reload", {"checkpoint": str(ref)})
        assert status == 400
        assert "not ported" in payload["error"] \
            and "item 4b" in payload["error"]
        assert call(url, "/v1/episode", body)[1]["result"] == after
    finally:
        server.shutdown()
        server.server_close()


def test_net_parser_flags_equal_the_jax_servers():
    def flags(parser):
        return {a.option_strings[0]: (a.default, a.type)
                for a in parser._actions if a.option_strings}
    assert flags(serve_http.build_net_parser()) == flags(jax_net_parser())
    assert set(flags(serve_http.build_net_parser())) == {
        "--host", "--port", "--warmup", "--warmup_queries"}


def test_main_refuses_what_is_not_ported(tmp_path):
    cfg = Config(**cfg_kw("fumi"), disable_cuda=True)
    # CLIP and the token encoders serve since they were ported; a token
    # model's dictionary from a dataset whose files are absent names them
    with pytest.raises(FileNotFoundError, match="CUB"):
        serve_http.build_classifier(
            cfg.replace(text_encoder="glove", dataset="cub",
                        data_dir=str(tmp_path)), None)
    sweep = tmp_path / "sweep"
    os.makedirs(sweep / "seed0" / "best")
    with pytest.raises(NotImplementedError, match="item 9"):
        serve_http.build_classifier(cfg, str(sweep))
    with pytest.raises(NotImplementedError, match="item 4b"):
        serve_http.main(["--port", "0", "--model", "fumi", "--checkpoint",
                         "someone/project/run", "--disable_cuda"])
    clf = serve_http.build_classifier(cfg, None)
    assert clf.device.type == "cpu" and clf.cfg.model == "fumi"


# ---------------------------------------------------------------------------
# token text encoders: both servers on the same bodies
# ---------------------------------------------------------------------------

TOKEN_MODELS = [("fumi", "RNN"), ("am3", "glove")]


@pytest.fixture(scope="module")
def token_servers():
    """(model, encoder) -> (JAX url, port url), the same weights and the
    synthetic dictionary."""
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    vocab = synthetic_dictionary(32)
    out, started = {}, []
    for model, enc in TOKEN_MODELS:
        kw = cfg_kw(model, text_encoder=enc)
        jc = JaxClassifier(JaxConfig(**kw), None, vocab)
        params = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jc.params), model,
            device="cpu")
        tc = FewShotClassifier(Config(**kw), params, vocab, device="cpu")
        js, j_url = serve(jc, jax_make_server)
        ts, t_url = serve(tc, serve_http.make_server)
        started += [js, ts]
        out[(model, enc)] = (j_url, t_url)
    yield out
    for server in started:
        server.shutdown()
        server.server_close()


def token_bodies(seed, R=None, T=5):
    """Bodies whose support descriptions are int token ids padded with PAD
    (0) to mixed lengths 1..T."""
    body = bodies(seed, R)
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    toks = rng.randint(1, 32, size=lead + (N * K, T))
    lengths = rng.randint(1, T + 1, size=lead + (N * K, 1))
    body["support_text"] = np.where(np.arange(T) < lengths, toks,
                                    0).tolist()
    return body


@pytest.mark.parametrize("model,enc", TOKEN_MODELS,
                         ids=[f"{m}-{e}" for m, e in TOKEN_MODELS])
def test_token_models_answer_as_the_jax_server(token_servers, model, enc):
    """``/v1/episode``, ``/v1/episode_batch`` and adapt-then-classify with
    token text: logits within 1e-4, labels equal; a request without
    ``support_text`` answers 400 on both."""
    j_url, t_url = token_servers[(model, enc)]
    for path, body in (("/v1/episode", token_bodies(0)),
                       ("/v1/episode_batch", token_bodies(1, R=3))):
        body = {**body, "return": "logits"}
        (js, jr), (ts, tr) = call(j_url, path, body), call(t_url, path, body)
        assert js == ts == 200
        got, want = np.asarray(tr["result"]), np.asarray(jr["result"])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    body = token_bodies(2)
    support = {k: body[k] for k in ("support_im", "support_text",
                                    "support_y")}
    for url in (j_url, t_url):
        assert call(url, "/v1/adapt", support) == (200, {"ok": True})
    labels = [call(u, "/v1/classify", {"query_im": body["query_im"]})
              for u in (j_url, t_url)]
    assert labels[0] == labels[1] and labels[0][0] == 200
    no_text = {k: v for k, v in body.items() if k != "support_text"}
    for path in ("/v1/episode", "/v1/adapt"):
        (js, jr), (ts, tr) = (call(j_url, path, no_text),
                              call(t_url, path, no_text))
        assert js == ts == 400 and "support_text" in tr["error"]


@pytest.mark.parametrize("bad_id", [32, -1])
@pytest.mark.parametrize("model,enc", TOKEN_MODELS,
                         ids=[f"{m}-{e}" for m, e in TOKEN_MODELS])
def test_token_ids_outside_the_table_answer_400(token_servers, model, enc,
                                                bad_id):
    """A token id outside the 32-row embedding table answers 400 on the
    port (the JAX server clamps the lookup and answers 200; on the card
    the port's lookup would fail the CUDA context and every later
    request), on ``/v1/episode`` and ``/v1/adapt``; the next valid request
    still answers 200 with the logits it gave before, within 1e-4 of the
    JAX server's."""
    j_url, t_url = token_servers[(model, enc)]
    body = {**token_bodies(3), "return": "logits"}
    status, first = call(t_url, "/v1/episode", body)
    assert status == 200
    bad = np.asarray(body["support_text"])
    bad[1, 0] = bad_id
    for path in ("/v1/episode", "/v1/adapt"):
        status, err = call(t_url, path, {**body, "support_text":
                                         bad.tolist()})
        assert status == 400 and "token ids" in err["error"]
    assert call(j_url, "/v1/episode", {**body, "support_text":
                                       bad.tolist()})[0] == 200
    status, again = call(t_url, "/v1/episode", body)
    assert status == 200 and again == first
    np.testing.assert_allclose(
        np.asarray(again["result"]),
        np.asarray(call(j_url, "/v1/episode", body)[1]["result"]), **TOL)

