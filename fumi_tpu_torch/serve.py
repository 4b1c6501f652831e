"""Few-shot serving: adapt on a request's support set, classify its queries.

The PyTorch counterpart of ``fumi_tpu/serve.py``'s ``FewShotClassifier``
and ``ClipRetrieval`` on precomputed image embeddings, or raw NHWC images
for a conv4 or resnet12 model (``support_im`` (NK, H, W, C), batched
(R, NK, H, W, C)), in fp32 or under the bf16 policy
(``--tpu_compute_dtype bfloat16``, served through the engine):

- ``episode_logits`` / ``episode_logits_batch``: adapt AND classify in one
  call. For MAML and FuMI, where the fused kernel applies (a CUDA device,
  fp32, plain full GD, 2 hidden layers, ``n_steps >=
  ops/kernels.py:MIN_FUSED_STEPS``) the whole adaptation runs in one
  launch of ``ops/kernels.py:fused_adapt``; otherwise, and for AM3,
  ProtoNet and MatchingNet, the engine runs: MAML/FuMI as a loop of
  ``torch.autograd.grad`` SGD steps with no outer graph (the head alone
  under ANIL, the proximal solve of ``metalearn/implicit.py`` under
  iMAML, as they were trained), AM3 and ProtoNet to the class prototypes,
  MatchingNet to the embedded support set and its labels. A family a
  ``--tpu_import`` module registers serves through its ``Family.serve``
  hook.
- ``FewShotClassifier(..., mesh=make_mesh(dp, 1))`` (``core/mesh.py``):
  ``episode_logits_batch`` shards a request's episodes over the dp ranks
  of a ``torch.distributed`` world, each rank running its R/dp episodes
  (one fused launch on a card) and the logits gathered in rank order, so
  every rank returns the whole answer. Every rank of the mesh calls with
  the same request (SPMD, as a multi-process JAX program does).
- ``adapt`` then ``logits`` / ``classify``: the stateful pair, adapted by
  the engine (the kernel returns logits, not adapted weights).
  MatchingNet's logits are ``log(probs + 1e-8)``, so every return mode
  renders its probabilities.
- ``from_checkpoint`` / ``reload``: weights from a run dir the port's
  driver wrote (``train/checkpoint.py``) or a reference ``.pth.tar``
  (``interop.py``), the EMA under ``--tpu_ema``; a token-encoder run's
  ``vocab.json`` rebuilds its encoder (:func:`serving_dictionary`).
- Token text encoders (glove, w2v, RNN, RNNhid): ``support_text`` is
  (..., NK, T) int token ids, padded with the dictionary's PAD id where
  the descriptions differ in length. FuMI and AM3 requests without it
  raise :class:`RequestError`, and so do ids outside the embedding table
  (the JAX package clamps them; an out-of-range index on the card would
  fail the CUDA context, and every later request with it). The JAX
  package pads T up to a power of two to reuse compiled programs; the
  port compiles nothing per shape and takes every T as it comes.
- :class:`SeedEnsemble`: the replicas of a ``--tpu_seed_sweep`` run dir
  (its ``seed<k>/`` exports), each adapted on the request, their class
  probabilities averaged, behind the same surface.
- :class:`ClipRetrieval`: CLIP serving, a gallery indexed once and
  ranked against many texts; a text or image batch of another width
  raises :class:`RequestError`.

Request shapes keep the JAX package's power-of-two bucketing of the
episode axis R and the query axis M, and its request errors, so served
results match it. A raw-image model's batch statistics span its queries,
so padding M would change every answer: M is not bucketed there, and each
episode of a batched request is normalized on its own, as the JAX package
``vmap``s one episode. Per-episode randomness (only the ``rand`` text encoder
reads it) comes from per-episode ``torch.Generator`` seeds: episode ``r``
of a batched request uses :func:`episode_seed` ``(seed, r)``, whatever the
bucket size.

Usage::

    clf = FewShotClassifier.from_checkpoint(run_dir, cfg)   # runs on cuda
    logits = clf.episode_logits(s_im, s_y, q_im, support_text=s_text)
    clf.adapt(s_im, s_text, s_y)
    labels = clf.classify(q_im)

    clip = ClipRetrieval.from_checkpoint(clip_run_dir, cfg)
    clip.index(gallery_im)
    indices, scores = clip.retrieve(texts, top_k=5)
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fumi_tpu_torch.core.config import Config, TOKEN_TEXT_ENCODERS
from fumi_tpu_torch.core.mesh import Mesh, all_gather_cat, episode_shard
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.metalearn.implicit import (fumi_proximal_adapt,
                                               proximal_adapt)
from fumi_tpu_torch.metalearn.inner_loop import adapt, head_only_mask
from fumi_tpu_torch.models import RAW_IMAGE_ENCODERS
from fumi_tpu_torch.models.text_encoders import EMBED
from fumi_tpu_torch.ops import fewshot, kernels
from fumi_tpu_torch.train import checkpoint as ckpt_lib
from fumi_tpu_torch.train.clip_loop import make_clip
from fumi_tpu_torch.train.loop import eval_view
from fumi_tpu_torch.train.optim import init_optim
from fumi_tpu_torch.train.steps import (build_family, image_embedder,
                                        image_prototypes, make_opt,
                                        plain_full_gd_adaptation)
from fumi_tpu_torch.utils.profiling import span


class RequestError(ValueError):
    """A request-content problem detected past the parse layer (an HTTP
    front-end maps it to 400)."""


def _np_softmax(logits: np.ndarray) -> np.ndarray:
    """Stable host-side softmax for request post-processing."""
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _bucket_queries(query_im, axis: int, enabled: bool = True):
    """Pad the QUERY axis M up to the next power of two by repeating the
    last query; callers slice the logits back to M. Exact for embedding
    inputs (adaptation reads only the support set; queries are classified
    independently); ``enabled=False`` (raw-image backbones, whose batch
    statistics span the queries) only validates M. Returns ``(M,
    padded_query_im)``."""
    query_im = np.asarray(query_im)
    M = query_im.shape[axis]
    if M == 0:
        raise RequestError("request has no queries (query_im is empty "
                           "along the query axis)")
    m_pad = 1 << (M - 1).bit_length() if enabled else M
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
                          support_text, seed: int, dp: int = 1,
                          bucket_m: bool = True):
    """The batched-request policy: array coercion, per-episode seeds,
    power-of-two R bucketing (rounded up to a multiple of ``dp`` when the
    request shards over a mesh) and power-of-two M bucketing. Returns
    ``(R, M, support_im, support_y, support_text, query_im, seeds)`` with
    the arrays padded to the bucket sizes and ``R``/``M`` the true counts
    (callers slice outputs back with ``[:R, :M]``)."""
    with span("serve.checks"):
        _check_support_y(cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_y = np.asarray(support_y, dtype=np.int32)
        R = support_im.shape[0]
        if R == 0:
            raise RequestError("request has no episodes (support_im is "
                               "empty along the episode axis)")
        support_text = prep_text(support_text, R, support_im.shape[1])
        M, query_im = _bucket_queries(query_im, axis=1, enabled=bucket_m)
        r_pad = max(1, 1 << (R - 1).bit_length())
        if dp > 1:
            r_pad = ((r_pad + dp - 1) // dp) * dp
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


def _check_tokens(tokens: np.ndarray, vocab_size: int) -> None:
    """Reject token ids outside the embedding table's rows [0, V)."""
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab_size):
        raise RequestError(
            f"support_text token ids must lie in [0, {vocab_size}) for "
            f"this model's {vocab_size}-row embedding table (got range "
            f"[{tokens.min()}, {tokens.max()}])")


def _check_width(x: np.ndarray, width: int, name: str) -> None:
    """Reject a batch that is not (rows, ``width``)."""
    if x.ndim != 2 or x.shape[1] != width:
        raise RequestError(f"{name} must be (rows, {width}) for this "
                           f"model; got shape {x.shape}")


def serving_dictionary(cfg: Config, run_dir: Optional[str] = None):
    """The token dictionary a glove/w2v/RNN/RNNhid model is served with;
    ``None`` for the other text encoders. The run dir's ``vocab.json``
    (the driver writes one with every token-encoder run; the trained
    embedding table itself is in the checkpoint) comes first, else the
    driver's dataset (``cli/main.py:_load_data``)."""
    if cfg.text_encoder not in TOKEN_TEXT_ENCODERS:
        return None
    if run_dir is not None:
        path = os.path.join(run_dir, "vocab.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    from fumi_tpu_torch.cli.main import _load_data
    return _load_data(cfg)[3]


def find_seed_exports(run_dir: str) -> List[str]:
    """Per-seed export dirs of a ``--tpu_seed_sweep`` run: strictly-named
    ``run_dir/seed<k>/`` holding a ``best/`` checkpoint, sorted by seed
    number (the JAX package's definition)."""
    def seed_no(d):
        m = re.fullmatch(r"seed(\d+)", os.path.basename(d))
        return int(m.group(1)) if m and os.path.isdir(d) else None
    return sorted(
        (d for d in glob.glob(os.path.join(run_dir, "seed*"))
         if seed_no(d) is not None
         and os.path.isdir(os.path.join(d, "best"))),
        key=seed_no)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


class FewShotClassifier:
    """Adapt-once / classify-many wrapper over a trained episodic model
    (MAML, FuMI, AM3, ProtoNet, MatchingNet or a registered family with a
    ``Family.serve`` hook).

    ``params`` is the model's state dict (``fumi_tpu_torch/bridge.py``
    carries JAX weights over); None serves the family's own seeded init.
    ``dictionary`` is the token dictionary of a glove/w2v/RNN/RNNhid
    model. ``device`` defaults to the current CUDA device; pass ``"cpu"``
    to run on the CPU.

    ``mesh`` (optional, ``core/mesh.py:make_mesh``) shards the batched
    request path's episodes over the mesh's dp ranks, one rank a device;
    the params stay replicated (each rank holds the same weights). The
    contract is SPMD: every rank of the mesh calls
    ``episode_logits_batch`` with the same request, each computes its
    R/dp episodes, and every rank returns the whole (R, M, N) answer. An
    mp > 1 mesh repeats a shard on the ranks of its mp row. The
    single-episode and stateful paths ignore the mesh and stay on the
    rank's device. Unlike the JAX package, which serves through its vmap
    engine under a mesh (a ``pallas_call`` does not partition), a rank
    launches the fused kernel on its own shard: the function is the same.
    """

    def __init__(self, cfg: Config, params: Optional[Dict] = None,
                 dictionary=None, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None):
        cfg = cfg.validate()
        self.cfg = cfg
        self.mesh = mesh
        self.family = build_family(
            cfg, torch.Generator().manual_seed(cfg.seed), dictionary)
        self.device = resolve_device(device)
        src = params if params is not None else self.family.params
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in src.items()}
        self._state = None  # adapted params
        self._classify_fn = None
        self._episode_fn = None
        self._engine = None  # (adapt_fn, classify_fn), both batched over R
        # M-bucketing only where it is exact (not under batch statistics)
        self._bucket_m = cfg.im_encoder not in RAW_IMAGE_ENCODERS

    @classmethod
    def from_checkpoint(cls, run_dir: str, cfg: Config, dictionary=None,
                        best: bool = True, device: DeviceLike = None
                        ) -> "FewShotClassifier":
        """A classifier on the weights of a run dir written by the port's
        driver (``best/``, or ``ckpt/`` with ``best=False``), on
        ``device`` (default the current CUDA device). A token-encoder
        model without ``dictionary`` reads the run's ``vocab.json``."""
        if dictionary is None:
            dictionary = serving_dictionary(cfg, run_dir)
        self = cls(cfg, None, dictionary, device=device)
        self.params = self._load(run_dir, best)
        return self

    def _load(self, run_dir: str, best: bool) -> Dict[str, torch.Tensor]:
        """The weights evaluation sees, restored with this classifier's
        params and a fresh optimizer state as the template (AM3's
        ``adamw_lin_schedule`` state carries its update count)."""
        params, opt_state, _ = ckpt_lib.load_checkpoint(
            run_dir, self.params, make_opt(self.cfg).init(self.params),
            best=best)
        return eval_view(self.cfg, params, opt_state)

    def reload(self, run_dir: str, best: bool = True) -> None:
        """Swap in the weights of a run dir without a rebuild: the request
        paths take the params as an argument, and a token encoder keeps
        its dictionary (the new run must share it: the embedding table's
        shape is checked at load). The adapted state was derived from the
        old weights, so it is dropped, and ``classify`` raises until
        ``adapt`` runs again."""
        self.params = self._load(run_dir, best)
        self._state = None
        self._classify_fn = None

    # ------------------------------------------------------------------
    # The engine: per-episode state (MAML/FuMI's adapted weights, the
    # prototype families' prototypes or embedded support sets) with a
    # leading R axis (the JAX package vmaps one episode's program over R
    # instead).

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

        def sgd_steps(theta, loss_of, mask=None):
            """n_steps of θ ← θ − α·∇loss(θ) with no outer graph, on the
            leaves ``mask`` marks (all without one)."""
            return adapt(theta, lambda q, _: loss_of(q), n_steps, step,
                         differentiable=False, mask=mask)

        def per_episode(p, keys, R):
            return {k: p[k].expand((R,) + tuple(p[k].shape)).clone()
                    for k in keys}

        raw = not self._bucket_m  # a raw backbone: batch statistics

        def each_episode(fn, *args):
            """``fn`` on each episode's slice of the leading R axis where a
            raw backbone normalizes every episode with its own batch
            statistics; on all R at once otherwise."""
            if not raw:
                return fn(*args)
            outs = [fn(*(a[r:r + 1] for a in args))
                    for r in range(args[0].shape[0])]
            if isinstance(outs[0], tuple):
                return tuple(torch.cat(t) for t in zip(*outs))
            return torch.cat(outs)

        if cfg.model == "maml":
            apply_fn = self.family.model  # the config's forward
            # ANIL serves with the masked updates it trained with
            mask = head_only_mask(self.params) \
                if cfg.adapt_params == "head" else None

            def adapt_fn(p, s_im, s_text, s_y, seeds):
                R = s_im.shape[0]
                theta = per_episode(p, p.keys(), R)
                if cfg.meta_grad == "imaml":
                    # the proximal inner solve iMAML trained with
                    return proximal_adapt(
                        apply_fn, theta, s_im, s_y, n_steps=n_steps,
                        step_size=step, lam=cfg.imaml_lambda)
                # sum of per-episode mean losses: each episode's gradient
                # is its own loss's gradient
                return sgd_steps(theta, lambda q: fewshot.cross_entropy(
                    apply_fn(q, s_im), s_y) * R, mask)

            def classify_fn(p, state, q_im):
                return apply_fn(state, q_im)
            return adapt_fn, classify_fn

        if cfg.model == "fumi":
            model = self.family.model

            def adapt_fn(p, s_im, s_text, s_y, seeds):
                R = s_im.shape[0]
                theta = per_episode(
                    p, [k for k in p if k.startswith("im_net.")], R)
                theta["hyper"] = self._hyper0(p, s_text, s_y, seeds)
                if cfg.meta_grad == "imaml":
                    # the joint proximal solve iMAML-FuMI trained with
                    return fumi_proximal_adapt(
                        model, theta, s_im, s_y, n_steps=n_steps,
                        step_size=step, lam=cfg.imaml_lambda)
                return sgd_steps(theta, lambda q: fewshot.cross_entropy(
                    model.im_forward(q, q["hyper"], s_im, train=False),
                    s_y) * R)

            def classify_fn(p, state, q_im):
                return model.im_forward(state, state["hyper"], q_im,
                                        train=False)
            return adapt_fn, classify_fn

        if cfg.model == "am3":
            model = self.family.model

            def adapt_fn(p, s_im, s_text, s_y, seeds):
                """The λ-fused class prototypes (R, N, P)."""
                if model.text_encoder.kind == "rand":
                    # one generator per episode for its noise
                    im_e, tx_e, lam = (torch.cat(t) for t in zip(*(
                        model.forward(p, s_text[r:r + 1], s_im[r:r + 1],
                                      torch.Generator().manual_seed(
                                          seeds[r]))
                        for r in range(s_im.shape[0]))))
                else:
                    im_e, tx_e, lam = each_episode(
                        lambda t, x: model.forward(p, t, x), s_text, s_im)
                return fewshot.get_prototypes(im_e, tx_e,
                                              model.fixed_lamda(lam), s_y,
                                              cfg.num_ways)

            def classify_fn(p, protos, q_im):
                return fewshot.prototype_logits(protos, each_episode(
                    lambda x: model.encode_image(p, x), q_im))
            return adapt_fn, classify_fn

        if cfg.model in ("protonet", "matchingnet"):
            embed = image_embedder(cfg)

            def embed_images(p, x):
                return each_episode(lambda e: embed(p, e), x)

        if cfg.model == "protonet":
            def adapt_fn(p, s_im, s_text, s_y, seeds):
                """The class prototypes (R, N, P) of the support set."""
                return image_prototypes(embed_images(p, s_im), s_y,
                                        cfg.num_ways)

            def classify_fn(p, protos, q_im):
                return fewshot.prototype_logits(protos, embed_images(p, q_im))
            return adapt_fn, classify_fn

        if cfg.model == "matchingnet":
            def adapt_fn(p, s_im, s_text, s_y, seeds):
                """The embedded support set and its labels."""
                return embed_images(p, s_im), s_y

            def classify_fn(p, state, q_im):
                s_emb, s_y = state
                probs = fewshot.matching_probs(s_emb, s_y,
                                               embed_images(p, q_im),
                                               cfg.num_ways)
                # log-probs as the logits: softmax(log p) = p
                return torch.log(probs + 1e-8)
            return adapt_fn, classify_fn

        if self.family.serve is not None:
            # a registered family's serving hook (train/steps.py:Family)
            return self.family.serve(cfg, self.family)
        raise NotImplementedError(
            f"episodic serving for model {cfg.model!r} (CLIP serves via "
            "ClipRetrieval; registered families can provide a "
            "Family.serve hook)")

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
        kernel even where it applies. The mesh plays no part: a rank
        launches the kernel on its shard of a request."""
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
                with span("serve.adapt"):
                    state = adapt_fn(p, s_im, s_text, s_y, seeds)
                with span("serve.classify"):
                    return classify_fn(p, state, q_im)
        return fn

    def _run_episodes(self, fn, s_im, s_y, q_im, s_text, seeds,
                      mesh: Optional[Mesh] = None) -> np.ndarray:
        """The logits of these episodes on the host; under ``mesh``, the
        dp ranks' logits concatenated in rank order."""
        dev = self.device
        with torch.no_grad():
            with span("serve.to_device"):
                args = (_tensor(s_im, np.float32, dev),
                        _tensor(s_y, np.int32, dev),
                        _tensor(q_im, np.float32, dev),
                        _tensor(s_text, self.text_dtype, dev))
            out = fn(self.params, *args, seeds)
        if mesh is not None:
            out = all_gather_cat(out, mesh.dp_group, dim=0, gloo=mesh.gloo)
        with span("serve.to_host"):
            return out.cpu().numpy()

    def _episode_request(self, s_im, s_y, q_im, s_text, seeds,
                         mesh: Optional[Mesh] = None):
        if self._episode_fn is None:
            self._episode_fn = self._build_episode_fn()
        return self._run_episodes(self._episode_fn, s_im, s_y, q_im, s_text,
                                  seeds, mesh)

    @property
    def text_is_tokens(self) -> bool:
        """True when the wire format of ``support_text`` is int token ids
        (glove/w2v/RNN/RNNhid) rather than float embeddings."""
        return self.cfg.text_encoder in TOKEN_TEXT_ENCODERS

    @property
    def text_dtype(self):
        """``support_text``'s dtype on the wire and on the device."""
        return np.int32 if self.text_is_tokens else np.float32

    def _prep_text(self, support_text, *fill_shape: int):
        """``support_text`` as the encoder takes it: int32 tokens for a
        token encoder, each a row of its embedding table, else float
        embeddings (zeros when absent). A token FuMI or AM3 model needs
        it: zeros would be all-PAD text."""
        if support_text is None:
            if self.text_is_tokens and self.cfg.model in ("am3", "fumi"):
                raise RequestError(
                    f"--text_encoder {self.cfg.text_encoder} models need "
                    "support_text (int token ids)")
            return np.zeros(fill_shape + (1,), self.text_dtype)
        text = np.asarray(support_text, dtype=self.text_dtype)
        if EMBED in self.params:
            _check_tokens(text, self.params[EMBED].shape[0])
        return text

    def episode_logits(self, support_im, support_y, query_im,
                       support_text=None, seed: int = 0) -> np.ndarray:
        """Adapt on this support set AND classify these queries in one
        call: support_im (NK, D), support_y (NK,), query_im (M, D) ->
        (M, N) logits (host numpy). This episode's generator seed is
        ``seed`` itself."""
        with span("serve.request"):
            with span("serve.checks"):
                _check_support_y(self.cfg, support_y)
                support_im = np.asarray(support_im, dtype=np.float32)
                support_y = np.asarray(support_y, dtype=np.int32)
                support_text = self._prep_text(support_text,
                                               support_im.shape[0])
                M, query_im = _bucket_queries(query_im, axis=0,
                                              enabled=self._bucket_m)
            out = self._episode_request(support_im[None], support_y[None],
                                        query_im[None], support_text[None],
                                        [int(seed)])
            return out[0, :M]

    def episode_logits_batch(self, support_im, support_y, query_im,
                             support_text=None, seed: int = 0) -> np.ndarray:
        """R independent episodes adapted AND classified in one call —
        support_im (R, NK, D), support_y (R, NK), query_im (R, M, D) ->
        (R, M, N) logits. R and M are padded to powers of two internally
        (repeating the last episode / query) and sliced back.

        Under a mesh every rank of it calls with the same request: R is
        padded up to a multiple of dp as well, each rank runs its
        :func:`~fumi_tpu_torch.core.mesh.episode_shard` of the padded
        episodes and their seeds (episode ``r`` keeps ``episode_seed(seed,
        r)`` on whichever rank runs it), and every rank returns the whole
        answer. A rank off the mesh raises ``ValueError``."""
        with span("serve.request"):
            mesh = self.mesh
            if mesh is not None and not mesh.member:
                raise ValueError(
                    f"rank {mesh.rank} is not on the ({mesh.dp}x{mesh.mp}) "
                    f"mesh (its first {mesh.size} ranks serve a sharded "
                    "request)")
            R, M, support_im, support_y, support_text, query_im, seeds = \
                _prep_batched_request(self.cfg, self._prep_text, support_im,
                                      support_y, query_im, support_text, seed,
                                      dp=1 if mesh is None else mesh.dp,
                                      bucket_m=self._bucket_m)
            if mesh is not None:
                part = episode_shard(mesh, len(seeds))
                support_im, support_y, support_text, query_im = (
                    x[part] for x in (support_im, support_y, support_text,
                                      query_im))
                seeds = seeds[part]
            out = self._episode_request(support_im, support_y, query_im,
                                        support_text, seeds, mesh)
            return out[:R, :M]

    # ------------------------------------------------------------------
    # Stateful pair

    def adapt(self, support_im, support_text=None, support_y=None,
              seed: int = 0) -> None:
        """Run the one-time adaptation for this support set: support_im
        (N*K, D), support_y (N*K,) int in [0, num_ways), support_text
        (N*K, E) for FuMI and AM3."""
        _check_support_y(self.cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_text = self._prep_text(support_text, support_im.shape[0])
        adapt_fn, classify_fn = self._engine_fns()
        dev = self.device
        with torch.no_grad():
            state = adapt_fn(self.params, _tensor(support_im[None],
                                                  np.float32, dev),
                             _tensor(support_text[None], self.text_dtype,
                                     dev),
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
        M, query_im = _bucket_queries(query_im, axis=0,
                                      enabled=self._bucket_m)
        out = self._classify_fn(_tensor(query_im, np.float32, self.device))
        return out.cpu().numpy()[:M]

    def classify(self, query_im, return_probs: bool = False):
        """(M, D) queries -> (M,) int labels (or (M, N) probs)."""
        logits = self.logits(query_im)
        if return_probs:
            return _np_softmax(logits)
        return np.argmax(logits, axis=-1).astype(np.int32)


def replica_seed(seed: int, i: int) -> int:
    """Generator seed of replica ``i`` of a :class:`SeedEnsemble` for the
    episode seed ``seed``: a function of (seed, i) only, the JAX package's
    ``fold_in(key, i)``."""
    return (int(seed) * 0xD1B54A32D192ED03
            + (i + 1) * 0x632BE59BD9B4E019) % (1 << 63)


class SeedEnsemble:
    """Seed-ensemble serving: the S replicas of a ``--tpu_seed_sweep`` run
    (its per-seed exports, ``train/sweep.py:export_seed_runs``) each adapt
    on the request, and the answer averages their class probabilities.
    The surface is :class:`FewShotClassifier`'s (``adapt``, ``logits``,
    ``classify``, ``episode_logits[_batch]``, ``reload``), so the HTTP
    front-end serves an ensemble as it serves one model. The returned
    "logits" are ``log(mean_s softmax(logits_s) + 1e-9)``: every return
    mode renders the ensemble's distribution.

    ``params`` is the stacked ``(S, ...)`` state dict of the replicas'
    serving views. Each replica runs the single-replica classifier's own
    functions on its slice: on the one-call paths the episode function,
    which runs ``ops/kernels.py:fused_adapt`` where it applies, one launch
    a replica for all R episodes of a request (the JAX package vmaps its
    engine over the replicas instead, as a ``pallas_call`` has no batching
    rule over a stacked params axis; the function is the same). Replica
    ``i`` draws the noise of episode seed ``s`` from :func:`replica_seed`
    ``(s, i)``, on the stateful and the one-call paths alike, so
    ``solo.episode_logits(..., seed=replica_seed(s, i))`` reproduces it.
    """

    def __init__(self, cfg: Config, params, dictionary=None,
                 device: DeviceLike = None, _base=None):
        cfg = cfg.replace(seed_sweep=0)  # the config of one replica
        # _base: a built single-replica classifier (from_sweep_run passes
        # the one whose params served as the load template)
        self._base = (_base if _base is not None
                      else FewShotClassifier(cfg, None, dictionary,
                                             device=device))
        self.cfg = self._base.cfg
        self.device = self._base.device
        if params is None:
            raise ValueError("SeedEnsemble needs stacked (S, ...) params "
                             "(e.g. SeedEnsemble.from_sweep_run)")
        self._set_params(params)
        self._episode_fn = None

    def _set_params(self, params) -> None:
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in params.items()}
        self.num_seeds = next(iter(self.params.values())).shape[0]
        # each replica's slice of the stack, a view
        self._replicas = [{k: v[i] for k, v in self.params.items()}
                          for i in range(self.num_seeds)]
        self._classify_fn = None

    @classmethod
    def from_sweep_run(cls, run_dir: str, cfg: Optional[Config] = None,
                       best: bool = True, device: DeviceLike = None
                       ) -> "SeedEnsemble":
        """An ensemble of a sweep run dir's ``seed<k>/`` exports; ``cfg``
        defaults to the run's ``config.json``."""
        if cfg is None:
            from fumi_tpu_torch.core.config import config_from_json
            cfg = config_from_json(os.path.join(run_dir, "config.json"))
        cfg = cfg.replace(seed_sweep=0)
        base = FewShotClassifier(cfg, None, serving_dictionary(cfg, run_dir),
                                 device=device)
        self = cls(cfg, cls._load_stacked(run_dir, base, best), _base=base)
        self._run_dir = run_dir
        return self

    @staticmethod
    def _load_stacked(run_dir: str, base: FewShotClassifier, best: bool):
        """The ``seed<k>/`` exports' serving views (the EMA under
        ``--tpu_ema``), stacked in seed order."""
        seed_dirs = find_seed_exports(run_dir)
        if not seed_dirs:
            raise FileNotFoundError(
                f"no seed*/ exports under {run_dir} (a --tpu_seed_sweep "
                "run writes them at the end of training)")
        from fumi_tpu_torch.train.sweep import stack_trees
        return stack_trees([base._load(d, best) for d in seed_dirs])

    @property
    def text_is_tokens(self) -> bool:
        return self._base.text_is_tokens

    @property
    def text_dtype(self):
        return self._base.text_dtype

    @staticmethod
    def _reduce(logits_s: torch.Tensor) -> torch.Tensor:
        """(S, ..., N) replica logits -> the ensemble's log-probabilities."""
        return torch.log(torch.softmax(logits_s, dim=-1).mean(dim=0) + 1e-9)

    def adapt(self, support_im, support_text=None, support_y=None,
              seed: int = 0) -> None:
        """Adapt every replica on this support set (replica ``i`` with
        :func:`replica_seed` ``(seed, i)``)."""
        _check_support_y(self.cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_text = self._base._prep_text(support_text,
                                             support_im.shape[0])
        adapt_fn, classify_fn = self._base._engine_fns()
        dev = self.device
        s_im = _tensor(support_im[None], np.float32, dev)
        s_tx = _tensor(support_text[None], self.text_dtype, dev)
        s_y = _tensor(np.asarray(support_y)[None], np.int32, dev)
        replicas = self._replicas
        with torch.no_grad():
            states = [adapt_fn(p, s_im, s_tx, s_y, [replica_seed(seed, i)])
                      for i, p in enumerate(replicas)]

        def classify(q):
            with torch.no_grad():
                return self._reduce(torch.stack([
                    classify_fn(p, state, q[None])[0]
                    for p, state in zip(replicas, states)]))
        self._classify_fn = classify

    def logits(self, query_im) -> np.ndarray:
        if self._classify_fn is None:
            raise RuntimeError("call adapt(...) before classify/logits")
        M, query_im = _bucket_queries(query_im, axis=0,
                                      enabled=self._base._bucket_m)
        out = self._classify_fn(_tensor(query_im, np.float32, self.device))
        return out.cpu().numpy()[:M]

    def classify(self, query_im, return_probs: bool = False):
        """(M, D) queries -> (M,) int labels (or (M, N) probs)."""
        logits = self.logits(query_im)
        if return_probs:
            return _np_softmax(logits)
        return np.argmax(logits, axis=-1).astype(np.int32)

    def _episode_request(self, s_im, s_y, q_im, s_text, seeds):
        if self._episode_fn is None:
            self._episode_fn = self._base._build_episode_fn()
        dev = self.device
        args = (_tensor(s_im, np.float32, dev), _tensor(s_y, np.int32, dev),
                _tensor(q_im, np.float32, dev),
                _tensor(s_text, self.text_dtype, dev))
        with torch.no_grad():
            out = torch.stack([
                self._episode_fn(p, *args,
                                 [replica_seed(sd, i) for sd in seeds])
                for i, p in enumerate(self._replicas)])
            return self._reduce(out).cpu().numpy()

    def episode_logits(self, support_im, support_y, query_im,
                       support_text=None, seed: int = 0) -> np.ndarray:
        """One episode through every replica: (M, N) ensemble logits."""
        _check_support_y(self.cfg, support_y)
        support_im = np.asarray(support_im, dtype=np.float32)
        support_y = np.asarray(support_y, dtype=np.int32)
        support_text = self._base._prep_text(support_text,
                                             support_im.shape[0])
        M, query_im = _bucket_queries(query_im, axis=0,
                                      enabled=self._base._bucket_m)
        out = self._episode_request(support_im[None], support_y[None],
                                    query_im[None], support_text[None],
                                    [int(seed)])
        return out[0, :M]

    def episode_logits_batch(self, support_im, support_y, query_im,
                             support_text=None, seed: int = 0) -> np.ndarray:
        """R episodes through every replica: (R, M, N) ensemble logits."""
        R, M, support_im, support_y, support_text, query_im, seeds = \
            _prep_batched_request(self.cfg, self._base._prep_text,
                                  support_im, support_y, query_im,
                                  support_text, seed,
                                  bucket_m=self._base._bucket_m)
        out = self._episode_request(support_im, support_y, query_im,
                                    support_text, seeds)
        return out[:R, :M]

    def reload(self, run_dir: Optional[str] = None,
               best: bool = True) -> None:
        """Swap in every replica of a sweep run dir (default the one served)
        with no rebuild; the adapted state is dropped."""
        run_dir = run_dir or getattr(self, "_run_dir", None)
        if run_dir is None:
            raise ValueError("reload needs a sweep run dir")
        self._set_params(self._load_stacked(run_dir, self._base, best))
        self._run_dir = run_dir


class ClipRetrieval:
    """CLIP serving: index a gallery once, rank many queries against it.

    ``index(images)`` projects and normalises the gallery through the
    image head once and keeps it on the device; ``retrieve(text, top_k)``
    projects the query texts and ranks the whole gallery with one matmul
    and ``torch.topk``; ``similarity(text, images)`` is the stateless
    one-shot form, the model's own ``forward``. Answers come back as host
    numpy. ``params`` is CLIP's state dict (None: the seeded init);
    ``device`` defaults to the current CUDA device, ``"cpu"`` for the
    CPU. Of equal scores, ``torch.topk`` on the card returns them in no
    promised order (``jax.lax.top_k`` gives the lower index first).
    """

    def __init__(self, cfg: Config, params: Optional[Dict] = None,
                 device: DeviceLike = None):
        cfg = cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model, init = make_clip(
            cfg, torch.Generator().manual_seed(cfg.seed))
        src = params if params is not None else init
        self.params = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in src.items()}
        self._gallery = None  # (G, latent) normalised image embeddings

    @classmethod
    def from_checkpoint(cls, run_dir: str, cfg: Config, best: bool = True,
                        device: DeviceLike = None) -> "ClipRetrieval":
        """A retrieval server on the weights of a CLIP run dir written by
        the port's driver."""
        self = cls(cfg, None, device=device)
        self.params = self._load(run_dir, best)
        return self

    def _load(self, run_dir: str, best: bool) -> Dict[str, torch.Tensor]:
        """The params of ``run_dir``, restored with the driver's CLIP
        optimizer state as the template."""
        cfg = self.cfg
        opt = init_optim(cfg.optim, cfg.lr, cfg.weight_decay, cfg.momentum)
        params, _, _ = ckpt_lib.load_checkpoint(
            run_dir, self.params, opt.init(self.params), best=best)
        return params

    def reload(self, run_dir: str, best: bool = True) -> None:
        """Swap in a run dir's weights. The gallery was embedded under the
        old weights, so it is dropped: ``index`` must run again before
        ``retrieve``."""
        self.params = self._load(run_dir, best)
        self._gallery = None

    @property
    def gallery_size(self) -> int:
        return 0 if self._gallery is None else int(self._gallery.shape[0])

    def index(self, images) -> int:
        """Project and normalise a gallery of (G, im_emb_dim) image
        embeddings; returns the gallery size."""
        images = self._batch(images, self.cfg.im_emb_dim, "images")
        with torch.no_grad():
            self._gallery = self.model.encode_image(self.params, images)
        return self.gallery_size

    def retrieve(self, text, top_k: int = 5):
        """(M, text_emb_dim) texts -> (indices (M, k) int32, scores (M, k))
        against the indexed gallery, highest cosine first."""
        if self._gallery is None:
            raise RuntimeError("call index(images) before retrieve")
        text = self._batch(text, self.cfg.text_emb_dim, "text")
        with torch.no_grad():
            t = self.model.encode_text(self.params, text)
            scores = t @ self._gallery.T
            k = min(int(top_k), scores.shape[-1])
            top_scores, top_idx = torch.topk(scores, k, dim=-1)
        return (top_idx.to(torch.int32).cpu().numpy(),
                top_scores.cpu().numpy())

    def similarity(self, text, images) -> np.ndarray:
        """Stateless (Nt, Ni) cosine-similarity matrix."""
        text = self._batch(text, self.cfg.text_emb_dim, "text")
        images = self._batch(images, self.cfg.im_emb_dim, "images")
        with torch.no_grad():
            return self.model.forward(self.params, text,
                                      images).cpu().numpy()

    def _batch(self, x, width: int, name: str) -> torch.Tensor:
        """A (rows, ``width``) request batch on the device; another shape
        raises :class:`RequestError` (the JAX package's projection raises
        a ``TypeError`` there)."""
        x = np.asarray(x, dtype=np.float32)
        _check_width(x, width, name)
        return _tensor(x, np.float32, self.device)


def warmup(clf, r_buckets=(1,), num_queries=16,
           text_len: int = 8) -> None:
    """Run synthetic requests through the serving paths before traffic
    arrives (first-use costs such as the kernel build land here, not on a
    live request): the stateful adapt+classify pair, and the episode path
    at each requested R bucket and at the M bucket(s) covering
    ``num_queries``. A live adapted state survives the warm-up. A token
    model's dummy descriptions are ``text_len`` copies of token 1. A
    :class:`ClipRetrieval` is skipped with a notice, as in the JAX
    package."""
    if isinstance(clf, ClipRetrieval):
        print("warmup: skipped (CLIP gallery shapes are data-dependent)")
        return
    cfg = clf.cfg
    NK = cfg.num_ways * cfg.num_shots
    rng = np.random.RandomState(0)
    s_im = rng.randn(NK, cfg.im_emb_dim).astype(np.float32)
    if isinstance(num_queries, int):
        num_queries = (num_queries,)
    q_ims = [rng.randn(m, cfg.im_emb_dim).astype(np.float32)
             for m in num_queries]
    s_y = np.repeat(np.arange(cfg.num_ways), cfg.num_shots).astype(np.int32)
    if clf.text_is_tokens:
        # token id 1, not PAD: an all-PAD row pools to 0/0 = NaN under
        # mean pooling
        s_text = np.full((NK, text_len), 1, np.int32)
    elif cfg.model in ("am3", "fumi"):
        s_text = rng.randn(NK, cfg.text_emb_dim).astype(np.float32)
    else:
        s_text = None

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
