"""Serving raw-image (conv4, resnet12) and bf16 configs: the port's
FewShotClassifier and HTTP server against the JAX package's, on the CPU,
on bridged weights and the same requests.

A raw-image model normalizes its queries with their own batch
statistics, so the query axis M is not padded to a power of two: a
request of M=7 and one of M=8 are each held against the JAX package's
unpadded answer, and the first 7 answers of the M=8 request differ from
the M=7 request's. A batched request normalizes each episode on its own.
MAML's and FuMI's batched raw requests are held against the JAX server's
answer to each episode alone: its ``vmap`` over the episodes of a
``lax.scan`` of inner steps through ``batch_stat_norm`` → ``maxpool2x2``
gives other numbers on the installed XLA (``tests/torch_raw_helpers.py``
says more).

Tolerances: fp32 logits within 1e-4 with the same argmax (3 test-time
steps through batch-stat norms); bf16 logits within 4 bf16 ulps of their
scale or 1.5× the distance between JAX's bf16 and fp32 answers (the
policy's own rounding noise), whichever is larger.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from fumi_tpu.core.config import Config as JaxConfig
from fumi_tpu.serve import FewShotClassifier as JaxClassifier
from fumi_tpu.serve_http import make_server as jax_make_server
from torch_raw_helpers import few_threads  # noqa: F401
from fumi_tpu_torch import bridge, serve_http
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.serve import FewShotClassifier

N, K, S, C, E = 3, 2, 16, 3, 8
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = 2.0 ** -8
RAW = {"protonet-conv4": ("protonet", dict(im_encoder="conv4")),
       "am3-conv4": ("am3", dict(im_encoder="conv4")),
       "matchingnet-resnet12": ("matchingnet", dict(im_encoder="resnet12")),
       "maml-conv4": ("maml", dict(im_encoder="conv4")),
       "fumi-resnet12": ("fumi", dict(im_encoder="resnet12"))}
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def cfg_kw(model, **kw):
    d = dict(model=model, dataset="synthetic", im_emb_dim=16,
             text_emb_dim=E, im_hid_dim=(16, 8), text_hid_dim=8,
             prototype_dim=8, num_ways=N, num_shots=K,
             num_test_adapt_steps=3, step_size=0.1, dropout=0.0,
             text_encoder="precomputed", im_size=S, im_channels=C,
             resnet12_channels=(4, 6, 8, 8), seed=0)
    d.update(kw)
    return d


def pair(model, **kw):
    jc = JaxClassifier(JaxConfig(**cfg_kw(model, **kw)), None)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jc.params), model, device="cpu")
    return jc, FewShotClassifier(Config(**cfg_kw(model, **kw)), params,
                                 device="cpu")


@pytest.fixture(scope="module")
def raw_pairs():
    return {name: pair(model, **kw) for name, (model, kw) in RAW.items()}


def request(seed, M, R=None, shape=(S, S, C)):
    rng = np.random.RandomState(seed)
    lead = () if R is None else (R,)
    y = np.repeat(np.arange(N), K).astype(np.int32)
    return (rng.rand(*lead, N * K, *shape).astype(np.float32),
            y if R is None else np.tile(y, (R, 1)),
            rng.rand(*lead, M, *shape).astype(np.float32),
            rng.randn(*lead, N * K, E).astype(np.float32))


def same(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_requests_of_seven_and_eight_queries(raw_pairs, name):
    jc, tc = raw_pairs[name]
    s_im, s_y, q8, s_tx = request(0, 8)
    got = {}
    for M in (7, 8):
        got[M] = tc.episode_logits(s_im, s_y, q8[:M], support_text=s_tx)
        same(got[M], jc.episode_logits(s_im, s_y, q8[:M],
                                       support_text=s_tx))
    assert not np.allclose(got[7], got[8][:7], atol=1e-6)


@pytest.mark.parametrize("name", sorted(RAW))
def test_raw_batched_requests_and_adapt_classify(raw_pairs, name):
    """R=3 episodes of M=5 (R padded to 4, M not padded), each normalized
    on its own; then the stateful pair."""
    jc, tc = raw_pairs[name]
    s_im, s_y, q_im, s_tx = request(1, 5, R=3)
    if RAW[name][0] in ("maml", "fumi"):
        want = np.stack([jc.episode_logits(s_im[r], s_y[r], q_im[r],
                                           support_text=s_tx[r])
                         for r in range(3)])
    else:
        want = jc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx)
    same(tc.episode_logits_batch(s_im, s_y, q_im, support_text=s_tx), want)
    s_im, s_y, q_im, s_tx = request(2, 6)
    jc.adapt(s_im, s_tx, s_y)
    tc.adapt(s_im, s_tx, s_y)
    same(tc.logits(q_im), jc.logits(q_im))


@pytest.mark.parametrize("model", ["fumi", "maml", "am3", "protonet"])
def test_bf16_requests_through_the_engine(model):
    """A bf16 config serves through the engine (the fused kernels compute
    fp32 only), held on the bf16 policy's own scale."""
    jc, tc = pair(model, compute_dtype="bfloat16")
    j32, _ = pair(model)
    s_im, s_y, q_im, s_tx = request(3, 5, shape=(16,))
    want = np.asarray(jc.episode_logits(s_im, s_y, q_im, support_text=s_tx))
    fp32 = np.asarray(j32.episode_logits(s_im, s_y, q_im,
                                         support_text=s_tx))
    got = tc.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    bound = max(4 * BF16 * float(np.abs(want).max()),
                1.5 * float(np.abs(want - fp32).max()))
    assert float(np.abs(got - want).max()) <= bound


def call(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with OPENER.open(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_raw_bodies_answer_as_the_jax_server(raw_pairs):
    """A 5-D raw ``/v1/episode_batch`` body and a 4-D ``/v1/episode`` body
    answer as the JAX server does; a raw batch without its request axis
    gets the JAX server's status code."""
    jc, tc = raw_pairs["protonet-conv4"]
    servers, urls = [], []
    for clf, make in ((jc, jax_make_server), (tc, serve_http.make_server)):
        server = make(clf, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        urls.append("http://%s:%d" % server.server_address[:2])
    try:
        s_im, s_y, q_im, _ = request(4, 5, R=2)
        batch = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
                 "query_im": q_im.tolist(), "return": "logits"}
        one = {"support_im": s_im[0].tolist(), "support_y": s_y[0].tolist(),
               "query_im": q_im[0].tolist(), "return": "logits"}
        for path, body in (("/v1/episode_batch", batch),
                           ("/v1/episode", one)):
            (js, jr), (ts, tr) = (call(u, path, body) for u in urls)
            assert js == ts == 200
            same(np.asarray(tr["result"]), np.asarray(jr["result"]))
        (js, _), (ts, tr) = (call(u, "/v1/episode_batch", one)
                             for u in urls)
        assert ts == js and 400 <= ts < 500 and "error" in tr
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
