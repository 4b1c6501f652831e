"""Few-shot serving: adapt on a request's support set, classify its queries.

The PyTorch counterpart of ``fumi_tpu/serve.py``'s ``FewShotClassifier``
for MAML and FuMI on precomputed embeddings (fp32, plain full-parameter
test-time adaptation):

- ``episode_logits`` / ``episode_logits_batch``: adapt AND classify in one
  call. Where the fused kernel applies (a CUDA device, fp32, plain full
  GD, 2 hidden layers, ``n_steps >= ops/kernels.py:MIN_FUSED_STEPS``) the
  whole adaptation runs in one
  launch of ``ops/kernels.py:fused_adapt``; otherwise the autograd engine
  (a loop of ``torch.autograd.grad`` SGD steps with no outer graph) runs.
- ``adapt`` then ``logits`` / ``classify``: the stateful pair, adapted by
  the autograd engine (the kernel returns logits, not adapted weights).

Request shapes keep the JAX package's power-of-two bucketing of the
episode axis R and the query axis M, and its request errors, so served
results match it. Per-episode randomness (only the ``rand`` text encoder
reads it) comes from per-episode ``torch.Generator`` seeds: episode ``r``
of a batched request uses :func:`episode_seed` ``(seed, r)``, whatever the
bucket size.

Usage::

    clf = FewShotClassifier(cfg, params)            # runs on cuda
    logits = clf.episode_logits(s_im, s_y, q_im, support_text=s_text)
    clf.adapt(s_im, s_text, s_y)
    labels = clf.classify(q_im)
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.metalearn.inner_loop import sgd_inner_update
from fumi_tpu_torch.models import mlp
from fumi_tpu_torch.ops import fewshot, kernels
from fumi_tpu_torch.train.steps import build_family, plain_full_gd_adaptation


class RequestError(ValueError):
    """A request-content problem detected past the parse layer (an HTTP
    front-end maps it to 400)."""


def _np_softmax(logits: np.ndarray) -> np.ndarray:
    """Stable host-side softmax for request post-processing."""
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _bucket_queries(query_im, axis: int):
    """Pad the QUERY axis M up to the next power of two by repeating the
    last query; callers slice the logits back to M. Exact for embedding
    inputs (adaptation reads only the support set; queries are classified
    independently). Returns ``(M, padded_query_im)``."""
    query_im = np.asarray(query_im)
    M = query_im.shape[axis]
    if M == 0:
        raise RequestError("request has no queries (query_im is empty "
                           "along the query axis)")
    m_pad = 1 << (M - 1).bit_length()
    if m_pad != M:
        idx = [slice(None)] * query_im.ndim
        idx[axis] = slice(M - 1, M)
        last = query_im[tuple(idx)]
        query_im = np.concatenate(
            [query_im, np.repeat(last, m_pad - M, axis=axis)], axis=axis)
    return M, query_im


def _pad_episodes(r_pad, *arrays):
    """Pad every array's leading (episode) axis from R up to ``r_pad`` by
    repeating the last episode."""
    arrays = tuple(np.asarray(x) for x in arrays)
    R = arrays[0].shape[0]
    if r_pad == R:
        return arrays
    pad = r_pad - R
    return tuple(np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
                 for x in arrays)


def episode_seed(seed: int, r: int) -> int:
    """Generator seed of episode ``r`` of a batched request: a function of
    (seed, r) only, so a request's episodes get the same randomness in any
    padding bucket."""
    return (int(seed) * 0x9E3779B97F4A7C15 + r + 1) % (1 << 63)


def _prep_batched_request(cfg, prep_text, support_im, support_y, query_im,
                          support_text, seed: int):
    """The batched-request policy: array coercion, per-episode seeds,
    power-of-two R bucketing and power-of-two M bucketing. Returns
    ``(R, M, support_im, support_y, support_text, query_im, seeds)`` with
    the arrays padded to the bucket sizes and ``R``/``M`` the true counts
    (callers slice outputs back with ``[:R, :M]``)."""
    _check_support_y(cfg, support_y)
    support_im = np.asarray(support_im, dtype=np.float32)
    support_y = np.asarray(support_y, dtype=np.int32)
    R = support_im.shape[0]
    if R == 0:
        raise RequestError("request has no episodes (support_im is "
                           "empty along the episode axis)")
    support_text = prep_text(support_text, R, support_im.shape[1])
    M, query_im = _bucket_queries(query_im, axis=1)
    r_pad = max(1, 1 << (R - 1).bit_length())
    seeds = [episode_seed(seed, r) for r in range(r_pad)]
    return (R, M) + _pad_episodes(r_pad, support_im, support_y,
                                  support_text, query_im) + (seeds,)


def _check_support_y(cfg: Config, support_y) -> None:
    """Reject out-of-range support labels: labels are episode-local class
    ids in [0, num_ways)."""
    y = np.asarray(support_y)
    if y.size and (y.min() < 0 or y.max() >= cfg.num_ways):
        raise RequestError(
            f"support_y must be episode-local class ids in "
            f"[0, {cfg.num_ways}) for this {cfg.num_ways}-way model "
            f"(got range [{y.min()}, {y.max()}]); remap dataset class "
            "ids to 0..N-1 per episode")


def _check_slice(cfg: Config) -> None:
    """Reject the serving configs the port does not serve yet. The model
    configs the port lacks are rejected by ``build_family``, each naming
    the ROADMAP item that will port it."""
    if cfg.seed_sweep > 1:
        raise NotImplementedError(
            "not ported to the PyTorch package yet — --tpu_seed_sweep "
            "(SeedEnsemble): Queue 1, item 9 (scale-out) in ROADMAP.md")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


class FewShotClassifier:
    """Adapt-once / classify-many wrapper over a trained MAML or FuMI model.

    ``params`` is the model's state dict (``fumi_tpu_torch/bridge.py``
    carries JAX weights over); None serves the family's own seeded init.
    ``device`` defaults to the current CUDA device; pass ``"cpu"`` to run
    on the CPU.
    """

    def __init__(self, cfg: Config, params: Optional[Dict] = None,
                 device: DeviceLike = None):
        cfg = cfg.validate()
        _check_slice(cfg)
        self.cfg = cfg
        self.family = build_family(
            cfg, torch.Generator().manual_seed(cfg.seed))
        self.device = resolve_device(device)
        src = params if params is not None else self.family.params
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in src.items()}
        self._state = None  # adapted params
        self._classify_fn = None
        self._episode_fn = None
        self._engine = None  # (adapt_fn, classify_fn), both batched over R

    @classmethod
    def from_checkpoint(cls, run_dir: str, cfg: Config, dictionary=None,
                        best: bool = True) -> "FewShotClassifier":
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP.md Queue 1, "
            "item 4); carry JAX weights over with fumi_tpu_torch.bridge")

    def reload(self, run_dir: str, best: bool = True) -> None:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP.md Queue 1, "
            "item 4)")

    # ------------------------------------------------------------------
    # The autograd engine: per-episode weights with a leading R axis (the
    # JAX package vmaps one episode's program over R instead).

    def _hyper0(self, p, s_text, s_y, seeds):
        """(R, N, H2+1) generated heads, one generator per episode."""
        model = self.family.model
        if model.text_encoder.kind == "rand":
            return torch.stack([
                model.get_hyper_params(
                    p, s_text[r], s_y[r],
                    torch.Generator().manual_seed(seeds[r]))
                for r in range(s_text.shape[0])])
        return model.get_hyper_params(p, s_text, s_y)

    def _build_engine(self):
        cfg = self.cfg
        n_steps, step = cfg.num_test_adapt_steps, cfg.step_size

        def sgd_steps(theta, loss_of):
            """n_steps of θ ← θ − α·∇loss(θ) with no outer graph."""
            for _ in range(n_steps):
                with torch.enable_grad():
                    leaves = {k: v.detach().requires_grad_()
                              for k, v in theta.items()}
                    loss = loss_of(leaves)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                theta = sgd_inner_update(
                    {k: v.detach() for k, v in leaves.items()},
                    dict(zip(leaves, grads)), step)
            return theta

        def per_episode(p, keys, R):
            return {k: p[k].expand((R,) + tuple(p[k].shape)).clone()
                    for k in keys}

        if cfg.model == "maml":
            def adapt_fn(p, s_im, s_text, s_y, seeds):
                R = s_im.shape[0]
                # sum of per-episode mean losses: each episode's gradient
                # is its own loss's gradient
                return sgd_steps(per_episode(p, p.keys(), R),
                                 lambda q: fewshot.cross_entropy(
                                     mlp.apply(q, s_im), s_y) * R)

            def classify_fn(p, state, q_im):
                return mlp.apply(state, q_im)
            return adapt_fn, classify_fn

        model = self.family.model

        def adapt_fn(p, s_im, s_text, s_y, seeds):
            R = s_im.shape[0]
            theta = per_episode(p, [k for k in p if k.startswith("im_net.")],
                                R)
            theta["hyper"] = self._hyper0(p, s_text, s_y, seeds)
            return sgd_steps(theta, lambda q: fewshot.cross_entropy(
                model.im_forward(q, q["hyper"], s_im, train=False),
                s_y) * R)

        def classify_fn(p, state, q_im):
            return model.im_forward(state, state["hyper"], q_im, train=False)
        return adapt_fn, classify_fn

    def _engine_fns(self):
        if self._engine is None:
            self._engine = self._build_engine()
        return self._engine

    # ------------------------------------------------------------------
    # Per-request episode path: one function for the single-episode and
    # the batched form (the single call is the R=1 view).

    def _build_episode_fn(self, force_engine: bool = False):
        """fn(p, s_im (R,NK,D), s_y (R,NK), q_im (R,M,D), s_text (R,NK,E),
        seeds) -> (R, M, N) logits. ``force_engine`` bypasses the fused
        kernel even where it applies."""
        cfg = self.cfg
        fused_ok = (not force_engine
                    and cfg.compute_dtype == "float32"
                    and plain_full_gd_adaptation(cfg)
                    and kernels.fused_adapt_applicable(
                        cfg.model, cfg.im_encoder, cfg.im_hid_dim,
                        cfg.num_test_adapt_steps, self.device))
        n_steps, step = cfg.num_test_adapt_steps, cfg.step_size

        if cfg.model == "maml" and fused_ok:
            def fn(p, s_im, s_y, q_im, s_text, seeds):
                return kernels.fused_maml_adapt(p, s_im, s_y, q_im,
                                                n_steps, step)
        elif cfg.model == "fumi" and fused_ok:
            def fn(p, s_im, s_y, q_im, s_text, seeds):
                hyper0 = self._hyper0(p, s_text, s_y, seeds)
                return kernels.fused_fumi_adapt(p, hyper0, s_im, s_y, q_im,
                                                n_steps, step)
        else:
            adapt_fn, classify_fn = self._engine_fns()

            def fn(p, s_im, s_y, q_im, s_text, seeds):
                state = adapt_fn(p, s_im, s_text, s_y, seeds)
                return classify_fn(p, state, q_im)
        return fn

    def _run_episodes(self, fn, s_im, s_y, q_im, s_text, seeds) -> np.ndarray:
        dev = self.device
        with torch.no_grad():
            out = fn(self.params, _tensor(s_im, np.float32, dev),
                     _tensor(s_y, np.int32, dev),
                     _tensor(q_im, np.float32, dev),
                     _tensor(s_text, np.float32, dev), seeds)
        return out.cpu().numpy()

    def _episode_request(self, s_im, s_y, q_im, s_text, seeds):
        if self._episode_fn is None:
            self._episode_fn = self._build_episode_fn()
        return self._run_episodes(self._episode_fn, s_im, s_y, q_im, s_text,
                                  seeds)

    def _prep_text(self, support_text, *fill_shape: int):
        """Precomputed float text embeddings (zeros when absent)."""
        if support_text is None:
            return np.zeros(fill_shape + (1,), np.float32)
        return np.asarray(support_text, dtype=np.float32)

    def episode_logits(self, support_im, support_y, query_im,
                       support_text=None, seed: int = 0) -> np.ndarray:
        """Adapt on this support set AND classify these queries in one
        call: support_im (NK, D), support_y (NK,), query_im (M, D) ->
        (M, N) logits (host numpy). This episode's generator seed is
        ``seed`` itself."""
        _check_support_y(self.cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_y = np.asarray(support_y, dtype=np.int32)
        support_text = self._prep_text(support_text, support_im.shape[0])
        M, query_im = _bucket_queries(query_im, axis=0)
        out = self._episode_request(support_im[None], support_y[None],
                                    query_im[None], support_text[None],
                                    [int(seed)])
        return out[0, :M]

    def episode_logits_batch(self, support_im, support_y, query_im,
                             support_text=None, seed: int = 0) -> np.ndarray:
        """R independent episodes adapted AND classified in one call —
        support_im (R, NK, D), support_y (R, NK), query_im (R, M, D) ->
        (R, M, N) logits. R and M are padded to powers of two internally
        (repeating the last episode / query) and sliced back."""
        R, M, support_im, support_y, support_text, query_im, seeds = \
            _prep_batched_request(self.cfg, self._prep_text, support_im,
                                  support_y, query_im, support_text, seed)
        out = self._episode_request(support_im, support_y, query_im,
                                    support_text, seeds)
        return out[:R, :M]

    # ------------------------------------------------------------------
    # Stateful pair

    def adapt(self, support_im, support_text=None, support_y=None,
              seed: int = 0) -> None:
        """Run the one-time adaptation for this support set: support_im
        (N*K, D), support_y (N*K,) int in [0, num_ways), support_text
        (N*K, E) for FuMI."""
        _check_support_y(self.cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_text = self._prep_text(support_text, support_im.shape[0])
        adapt_fn, classify_fn = self._engine_fns()
        dev = self.device
        with torch.no_grad():
            state = adapt_fn(self.params, _tensor(support_im[None],
                                                  np.float32, dev),
                             _tensor(support_text[None], np.float32, dev),
                             _tensor(np.asarray(support_y)[None], np.int32,
                                     dev), [int(seed)])
        self._state = (self.cfg.model, state)
        params = self.params

        def classify(q):
            with torch.no_grad():
                return classify_fn(params, state, q[None])[0]
        self._classify_fn = classify

    def logits(self, query_im) -> np.ndarray:
        if self._classify_fn is None:
            raise RuntimeError("call adapt(...) before classify/logits")
        M, query_im = _bucket_queries(query_im, axis=0)
        out = self._classify_fn(_tensor(query_im, np.float32, self.device))
        return out.cpu().numpy()[:M]

    def classify(self, query_im, return_probs: bool = False):
        """(M, D) queries -> (M,) int labels (or (M, N) probs)."""
        logits = self.logits(query_im)
        if return_probs:
            return _np_softmax(logits)
        return np.argmax(logits, axis=-1).astype(np.int32)


def warmup(clf: FewShotClassifier, r_buckets=(1,), num_queries=16) -> None:
    """Run synthetic requests through the serving paths before traffic
    arrives (first-use costs such as the kernel build land here, not on a
    live request): the stateful adapt+classify pair, and the episode path
    at each requested R bucket and at the M bucket(s) covering
    ``num_queries``. A live adapted state survives the warm-up."""
    cfg = clf.cfg
    NK = cfg.num_ways * cfg.num_shots
    rng = np.random.RandomState(0)
    s_im = rng.randn(NK, cfg.im_emb_dim).astype(np.float32)
    if isinstance(num_queries, int):
        num_queries = (num_queries,)
    q_ims = [rng.randn(m, cfg.im_emb_dim).astype(np.float32)
             for m in num_queries]
    s_y = np.repeat(np.arange(cfg.num_ways), cfg.num_shots).astype(np.int32)
    s_text = (rng.randn(NK, cfg.text_emb_dim).astype(np.float32)
              if cfg.model == "fumi" else None)

    saved = (clf._state, clf._classify_fn)
    t0 = time.perf_counter()
    try:
        clf.adapt(s_im, s_text, s_y)
        for q_im in q_ims:
            clf.classify(q_im)
    finally:
        clf._state, clf._classify_fn = saved
    print(f"warmup: adapt+classify in {time.perf_counter() - t0:.1f}s")

    for R in r_buckets:
        t0 = time.perf_counter()
        for q_im in q_ims:
            if R <= 1:
                clf.episode_logits(s_im, s_y, q_im, support_text=s_text)
            else:
                tile = lambda x: np.repeat(x[None], R, axis=0)
                clf.episode_logits_batch(
                    tile(s_im), tile(s_y), tile(q_im),
                    support_text=None if s_text is None else tile(s_text))
        m_buckets = sorted({1 << (m - 1).bit_length() for m in num_queries})
        print(f"warmup: episode path R={R} (M buckets {m_buckets}) "
              f"in {time.perf_counter() - t0:.1f}s")
