"""HTTP serving front-end: few-shot-as-a-service over JSON.

The PyTorch counterpart of ``fumi_tpu/serve_http.py``. It puts
:class:`fumi_tpu_torch.serve.FewShotClassifier` (the episodic families)
or :class:`fumi_tpu_torch.serve.ClipRetrieval` (``--model clip``) behind a
wire protocol using only the standard library's ``http.server``.

Endpoints (JSON in / JSON out), as the JAX package's:

- ``GET  /healthz``: liveness, the model family, the backend (``cuda`` or
  ``cpu``) and the device count.
- ``GET  /v1/stats``: health plus per-route request and error counts and
  latency mean/max/p50/p95/p99 over a sliding window.
- ``GET  /metrics``: the same counters in Prometheus text format.
- ``POST /v1/episode``: adapt on the request's own support set AND
  classify its queries (``episode_logits``; MAML/FuMI through one launch
  of the fused kernel on the card). Body: ``{"support_im": [[...]],
  "support_y": [...], "query_im": [[...]], "support_text": [[...]]?,
  "return": "labels"|"probs"|"logits"?}``.
- ``POST /v1/episode_batch``: R independent episodes in one call (a
  leading request axis on every field).
- ``POST /v1/adapt``: keep the adapted state of a support set.
- ``POST /v1/classify``: classify queries against it (409 before any
  adapt). Body: ``{"query_im": [[...]], "return": ...?}``.
- ``POST /v1/reload``: swap in the weights of a run dir without a
  rebuild; drops the adapted state (CLIP: the indexed gallery). Body:
  ``{"checkpoint": "<run dir or .pth.tar>", "best": true?}``; a reference
  ``.pth.tar`` file is imported (``interop.py``), and one that does not
  load answers 400, as in the JAX server.

A token-encoder model (glove, w2v, RNN, RNNhid) takes ``support_text`` as
int token ids; FuMI and AM3 requests without it answer 400.

With ``--model clip`` the server exposes the retrieval routes instead
(:class:`ClipService`): ``POST /v1/clip/index`` (``{"images": [[...]]}``:
project and normalise a gallery once, kept on the card), ``POST
/v1/clip/retrieve`` (``{"text": [[...]], "top_k": 5?}``: top-k gallery
indices and cosine scores; 409 before any index), ``POST
/v1/clip/similarity`` (``{"text": ..., "images": ...}``: the stateless
cosine matrix) and ``POST /v1/reload``; ``/healthz`` reports the gallery
size.

Status codes: 400 for a missing or malformed field and other request
errors, 409 for classify before adapt, 404 for an unknown route, 500 for a
failure on the server's side.

Run::

    python -m fumi_tpu_torch.serve_http --checkpoint <run dir> \
        --model fumi --port 8080 <the run's model flags>

The full training flag surface applies, so the server rebuilds the
trained architecture; it runs on the card unless ``--disable_cuda`` asks
for the CPU. A ``--tpu_seed_sweep`` run dir (its ``seed<k>/`` exports)
serves as a :class:`fumi_tpu_torch.serve.SeedEnsemble` (``seed ensemble:
S replicas from ...``), and ``/v1/reload`` of a sweep run dir reloads
every replica.

Concurrency: ``ThreadingHTTPServer`` handles requests on worker threads,
and one lock serialises the classifier's work, as the JAX package's does:
the adapted state is a single slot. The kernels launch on the current
CUDA stream of the thread that handles the request.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from fumi_tpu_torch.serve import (ClipRetrieval, FewShotClassifier,
                                  RequestError, SeedEnsemble, _np_softmax,
                                  find_seed_exports, serving_dictionary,
                                  warmup)


class Metrics:
    """Per-route request counters and latency percentiles: cumulative
    request and error counts plus the last ``WINDOW`` latencies of each
    route. Thread-safe; the lock covers only the counters."""

    WINDOW = 1024
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._routes: dict = {}

    def observe(self, route: str, ms: float, status: int) -> None:
        with self._lock:
            r = self._routes.setdefault(
                route, {"count": 0, "errors": 0, "sum_ms": 0.0,
                        "max_ms": 0.0, "lat": deque(maxlen=self.WINDOW)})
            r["count"] += 1
            r["sum_ms"] += ms
            r["max_ms"] = max(r["max_ms"], ms)
            r["lat"].append(ms)
            if status >= 400:
                r["errors"] += 1

    @staticmethod
    def _pct(sorted_ms, q: float) -> float:
        if not sorted_ms:
            return 0.0
        return sorted_ms[min(len(sorted_ms) - 1, int(q * len(sorted_ms)))]

    def _snapshot(self) -> dict:
        with self._lock:
            return {route: {**{k: r[k] for k in
                               ("count", "errors", "sum_ms", "max_ms")},
                            "lat": sorted(r["lat"])}
                    for route, r in self._routes.items()}

    def stats(self) -> dict:
        out = {"uptime_s": round(time.time() - self._t0, 3), "routes": {}}
        for route, r in self._snapshot().items():
            lat = r.pop("lat")
            entry = {"count": r["count"], "errors": r["errors"],
                     "mean_ms": round(r["sum_ms"] / max(r["count"], 1), 3),
                     "max_ms": round(r["max_ms"], 3)}
            for q in self.QUANTILES:
                entry[f"p{int(q * 100)}_ms"] = round(self._pct(lat, q), 3)
            out["routes"][route] = entry
        return out

    def prometheus(self) -> str:
        """The counters in Prometheus text format, under the JAX
        package's metric names, so its dashboards read either server."""
        lines = [
            "# HELP fumi_tpu_requests_total Requests handled, by route.",
            "# TYPE fumi_tpu_requests_total counter",
            "# HELP fumi_tpu_request_errors_total 4xx/5xx responses.",
            "# TYPE fumi_tpu_request_errors_total counter",
            "# HELP fumi_tpu_request_latency_ms Request latency "
            "(sliding-window quantiles).",
            "# TYPE fumi_tpu_request_latency_ms summary",
            "# HELP fumi_tpu_uptime_seconds Server uptime.",
            "# TYPE fumi_tpu_uptime_seconds gauge",
            f"fumi_tpu_uptime_seconds {time.time() - self._t0:.3f}",
        ]
        for route, r in sorted(self._snapshot().items()):
            lab = f'route="{route}"'
            lat = r["lat"]
            lines.append(f"fumi_tpu_requests_total{{{lab}}} {r['count']}")
            lines.append(
                f"fumi_tpu_request_errors_total{{{lab}}} {r['errors']}")
            for q in self.QUANTILES:
                lines.append(
                    f'fumi_tpu_request_latency_ms{{{lab},quantile="{q}"}} '
                    f"{self._pct(lat, q):.3f}")
            lines.append(
                f"fumi_tpu_request_latency_ms_sum{{{lab}}} "
                f"{r['sum_ms']:.3f}")
            lines.append(
                f"fumi_tpu_request_latency_ms_count{{{lab}}} {r['count']}")
        return "\n".join(lines) + "\n"


class ServeError(Exception):
    """Client error with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _array(body: dict, key: str, dtype=np.float32,
           required: bool = True) -> Optional[np.ndarray]:
    if key not in body or body[key] is None:
        if required:
            raise ServeError(400, f"missing field {key!r}")
        return None
    try:
        return np.asarray(body[key], dtype=dtype)
    except (TypeError, ValueError, OverflowError) as e:
        raise ServeError(400, f"field {key!r} is not a numeric array: {e}")


def _render(logits, mode: str) -> list:
    logits = np.asarray(logits)
    if mode == "logits":
        out = logits
    elif mode == "probs":
        out = _np_softmax(logits)
    elif mode == "labels":
        out = np.argmax(logits, axis=-1)
    else:
        raise ServeError(400, f"unknown return mode {mode!r} "
                              "(labels|probs|logits)")
    return np.asarray(out).tolist()


class _Service:
    """What both services share: one lock over the served object, the
    request metrics, health and ``/v1/reload``."""

    def __init__(self, clf):
        self.clf = clf
        self.lock = threading.Lock()
        self.metrics = Metrics()

    def healthz(self) -> dict:
        dev = self.clf.device
        return {"ok": True, "model": self.clf.cfg.model,
                "backend": dev.type,
                "devices": (torch.cuda.device_count() if dev.type == "cuda"
                            else 1)}

    def reload(self, body: dict) -> dict:
        """Swap in the weights of a run dir or a reference ``.pth.tar``;
        any adapted state (CLIP: the gallery) is dropped. Body:
        ``{"checkpoint": "<path>", "best": true?}``."""
        path = body.get("checkpoint")
        if not isinstance(path, str) or not path:
            raise ServeError(400, "missing field 'checkpoint' "
                                  "(run dir or .pth.tar)")
        if not (os.path.isdir(path) or os.path.isfile(path)):
            raise ServeError(400, f"checkpoint not found: {path!r}")
        with self.lock:
            try:
                self.clf.reload(path, best=bool(body.get("best", True)))
            except (ValueError, FileNotFoundError, NotImplementedError) as e:
                # a structure mismatch, missing files, or a format whose
                # import is not ported: the request's problem
                raise ServeError(400, str(e))
        return {"ok": True, "checkpoint": path}


class FewShotService(_Service):
    """The endpoint logic, apart from the HTTP plumbing."""

    def _text(self, body: dict) -> Optional[np.ndarray]:
        # a token model's support_text is int ids on the wire: float32
        # would break the embedding lookup
        return _array(body, "support_text", dtype=self.clf.text_dtype,
                      required=False)

    def episode(self, body: dict) -> dict:
        s_im = _array(body, "support_im")
        s_y = _array(body, "support_y", dtype=np.int32)
        q_im = _array(body, "query_im")
        s_text = self._text(body)
        mode = body.get("return", "labels")
        with self.lock:
            logits = self.clf.episode_logits(s_im, s_y, q_im,
                                             support_text=s_text)
        return {"result": _render(logits, mode)}

    def episode_batch(self, body: dict) -> dict:
        s_im = _array(body, "support_im")
        s_y = _array(body, "support_y", dtype=np.int32)
        q_im = _array(body, "query_im")
        s_text = self._text(body)
        if s_y.ndim != 2:
            raise ServeError(400, "episode_batch expects a leading request "
                                  f"axis; support_y has shape {s_y.shape}")
        mode = body.get("return", "labels")
        with self.lock:
            logits = self.clf.episode_logits_batch(s_im, s_y, q_im,
                                                   support_text=s_text)
        return {"result": _render(logits, mode)}

    def adapt(self, body: dict) -> dict:
        s_im = _array(body, "support_im")
        s_y = _array(body, "support_y", dtype=np.int32)
        s_text = self._text(body)
        with self.lock:
            self.clf.adapt(s_im, support_text=s_text, support_y=s_y)
        return {"ok": True}

    def classify(self, body: dict) -> dict:
        q_im = _array(body, "query_im")
        mode = body.get("return", "labels")
        with self.lock:
            try:
                logits = self.clf.logits(q_im)
            except RuntimeError as e:  # adapt() not called yet
                raise ServeError(409, str(e))
        return {"result": _render(logits, mode)}

    ROUTES = {"/v1/episode": episode, "/v1/episode_batch": episode_batch,
              "/v1/adapt": adapt, "/v1/classify": classify,
              "/v1/reload": _Service.reload}


class ClipService(_Service):
    """CLIP retrieval endpoints (``--model clip``): index a gallery of
    image embeddings once, rank texts against it; plus the stateless
    similarity matrix. Serves :class:`fumi_tpu_torch.serve.ClipRetrieval`
    under one lock, as :class:`FewShotService` serves its classifier."""

    def healthz(self) -> dict:
        return {**super().healthz(), "gallery": self.clf.gallery_size}

    def index(self, body: dict) -> dict:
        images = _array(body, "images")
        with self.lock:
            size = self.clf.index(images)
        return {"ok": True, "gallery_size": size}

    def retrieve(self, body: dict) -> dict:
        text = _array(body, "text")
        top_k = int(body.get("top_k", 5))
        with self.lock:
            if self.clf.gallery_size == 0:
                raise ServeError(409, "call /v1/clip/index before "
                                      "/v1/clip/retrieve")
            idx, scores = self.clf.retrieve(text, top_k)
        return {"indices": idx.tolist(), "scores": scores.tolist()}

    def similarity(self, body: dict) -> dict:
        text = _array(body, "text")
        images = _array(body, "images")
        with self.lock:
            sim = self.clf.similarity(text, images)
        return {"similarity": sim.tolist()}

    ROUTES = {"/v1/clip/index": index, "/v1/clip/retrieve": retrieve,
              "/v1/clip/similarity": similarity,
              "/v1/reload": _Service.reload}


class _Handler(BaseHTTPRequestHandler):
    service: _Service  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, self.service.healthz())
        elif self.path == "/v1/stats":
            self._reply(200, {**self.service.healthz(),
                              **self.service.metrics.stats()})
        elif self.path == "/metrics":
            data = self.service.metrics.prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        route = type(self.service).ROUTES.get(self.path)
        if route is None:
            # read the body first: a client still sending it would see
            # the connection reset instead of the 404
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self._reply(404, {"error": f"no route {self.path}"})
            return
        t0 = time.perf_counter()
        status, payload = 500, {"error": "unhandled"}
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ServeError(400, "body must be a JSON object")
            status, payload = 200, route(self.service, body)
        except ServeError as e:
            status, payload = e.status, {"error": str(e)}
        except json.JSONDecodeError as e:
            status, payload = 400, {"error": f"invalid JSON: {e}"}
        except RequestError as e:
            # request-content errors found past the parse layer; narrow on
            # purpose, so a server-side defect stays a 500
            status, payload = 400, {"error": str(e)}
        except Exception as e:  # a failure on the server: the request fails
            status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
        finally:
            self.service.metrics.observe(
                self.path, (time.perf_counter() - t0) * 1e3, status)
        self._reply(status, payload)


def make_server(clf, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server for a
    :class:`FewShotClassifier` or a :class:`ClipRetrieval`; ``port=0``
    picks a free port, ``server.server_address[1]`` is the one bound."""
    service = (ClipService(clf) if isinstance(clf, ClipRetrieval)
               else FewShotService(clf))
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def build_net_parser() -> argparse.ArgumentParser:
    """The server's own flags; every other flag goes to the training
    config's parser."""
    net = argparse.ArgumentParser(add_help=False)
    net.add_argument("--host", type=str, default="127.0.0.1")
    net.add_argument("--port", type=int, default=8080)
    net.add_argument(
        "--warmup", type=str, default=None, metavar="R[,R...]",
        help="run synthetic requests before accepting traffic (the first "
             "use builds the kernels): comma-separated episode-batch "
             "buckets, e.g. '1,8' ('1' = the single-episode path)")
    net.add_argument(
        "--warmup_queries", type=str, default="16", metavar="M[,M...]",
        help="query count(s) whose power-of-two bucket(s) --warmup runs")
    return net


def build_classifier(cfg, run_dir: Optional[str]):
    """What ``main`` serves: a :class:`ClipRetrieval` for ``--model clip``,
    else a :class:`FewShotClassifier`; from a run dir, or the seeded init
    without one (a token model's dictionary then comes from the driver's
    dataset). A seed-sweep run dir (``seed<k>/`` exports) serves as a
    :class:`SeedEnsemble`."""
    device = "cpu" if cfg.disable_cuda else None
    if cfg.model == "clip":
        if run_dir:
            return ClipRetrieval.from_checkpoint(run_dir, cfg, device=device)
        return ClipRetrieval(cfg, None, device=device)
    if run_dir and find_seed_exports(run_dir):
        # a --tpu_seed_sweep run dir: the ensemble of its seed<k>/ exports
        # (the same strict seed<k> rule as the ensemble's loader)
        clf = SeedEnsemble.from_sweep_run(run_dir, cfg, device=device)
        print(f"seed ensemble: {clf.num_seeds} replicas from "
              f"{run_dir}/seed*/")
        return clf
    if run_dir:
        return FewShotClassifier.from_checkpoint(run_dir, cfg,
                                                 device=device)
    return FewShotClassifier(cfg, None, serving_dictionary(cfg),
                             device=device)


def main(argv=None) -> None:
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.train.checkpoint import resolve_checkpoint

    net_args, rest = build_net_parser().parse_known_args(argv)
    cfg = config_from_args(rest)  # the full training flag surface
    run_dir = None
    if cfg.checkpoint:
        run_dir = resolve_checkpoint(cfg.checkpoint, cfg.model,
                                     entity=cfg.wandb_entity,
                                     project=cfg.wandb_project)
    clf = build_classifier(cfg, run_dir)
    if net_args.warmup:
        warmup(clf,
               r_buckets=tuple(int(r) for r in net_args.warmup.split(",")),
               num_queries=tuple(
                   int(m) for m in net_args.warmup_queries.split(",")))

    server = make_server(clf, net_args.host, net_args.port)
    host, port = server.server_address[:2]
    routes = ", ".join(server.RequestHandlerClass.service.ROUTES)
    print(f"serving {cfg.model} on http://{host}:{port} on {clf.device} "
          f"(POST {routes})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
