"""Model families, their episode losses, and the train and eval steps.

The counterpart of ``fumi_tpu/train/steps.py`` for the five episodic
families: MAML and FuMI (an inner loop), AM3, ProtoNet and MatchingNet
(prototypes or attention over the support set, no inner loop). Each takes
precomputed image embeddings (an MLP or a Linear) or, with ``--im_encoder
conv4|resnet12``, raw NHWC images through a backbone
(``models/conv4.py``, ``models/resnet12.py``): MAML adapts the whole
backbone and its head per task, FuMI the headless backbone and its
generated head, and AM3, ProtoNet and MatchingNet embed with the backbone
and a projection ``head``. ``--tpu_compute_dtype bfloat16``
(:func:`compute_dtype_of`) runs every family's matrix products and
convolutions on bf16 operands (``models/layers.py``), and ``--tpu_remat``
(:func:`remat_of`) checkpoints the inner steps. MAML's meta-gradient is
explicit (second order through the inner loop), Reptile's
(``metalearn/reptile.py``) or iMAML's (``metalearn/implicit.py``), and
``--tpu_adapt_params head`` adapts only its head (ANIL); FuMI's is
explicit or iMAML's. FuMI and AM3 take
precomputed text embeddings or, with a token dictionary, token text
through ``models/text_encoders.py`` (glove, w2v, RNN, RNNhid), frozen
unless ``--fine_tune``. Each family is built once as a :class:`Family` of
episode-level functions:

- ``train_loss(params, episode, gen) -> (loss, aux)``, differentiable;
- ``eval_raw(params, episode, gen) -> dict``, the test-time adaptation
  with no outer graph (or, with ``--tpu_pallas_fused_eval`` on a CUDA
  device, one launch of a fused kernel, ``ops/kernels.py``: FuMI's
  per-task heads through ``fused_fumi_adapt``, MAML's shared head through
  ``fused_maml_adapt_batched``);
- ``eval_finalize(raw) -> metrics`` and ``eval_reduce``. AM3's raw dict
  holds the meta-batch's confusion matrix, from which its finalize derives
  acc and the macro prec / rec / f1 (``ops/metrics.py``);
- ``serve``, optional: ``(cfg, family) -> (adapt_fn, classify_fn)``, how
  ``serve.FewShotClassifier`` serves a family it has no engine of its own
  for.

The families register themselves in :data:`FAMILY_REGISTRY`
(:func:`register_family`); a module named by ``--tpu_import`` can register
more, and :func:`build_family` dispatches through the registry.

:func:`make_steps` wraps a family into train/eval steps;
:func:`make_chunked_train` / :func:`make_chunked_eval` run ``chunk``
device-sampled steps per call and return the per-step metrics stacked to
``(chunk,)`` on the device, so the host syncs once per chunk. ``gen`` is a
``torch.Generator`` on the device, in place of the JAX package's keys.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from fumi_tpu_torch.core.config import Config, TOKEN_TEXT_ENCODERS
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.metalearn import implicit
from fumi_tpu_torch.metalearn.inner_loop import (fumi_episode_loss,
                                                 head_only_mask,
                                                 maml_episode_loss)
from fumi_tpu_torch.metalearn.reptile import reptile_episode_loss
from fumi_tpu_torch.models import (RAW_IMAGE_ENCODERS,
                                   headless_backbone_init, raw_image_net)
from fumi_tpu_torch.models import am3 as am3_mod
from fumi_tpu_torch.models import fumi as fumi_mod
from fumi_tpu_torch.models import layers, mlp, text_encoders
from fumi_tpu_torch.ops import fewshot, kernels
from fumi_tpu_torch.ops import metrics as metrics_ops
from fumi_tpu_torch.train import optim
from fumi_tpu_torch.train import watch as watch_lib
from fumi_tpu_torch.utils.profiling import count_memory, span


class Family(NamedTuple):
    """A model family's params and pure episode-level functions; ``model``
    is the model spec (MAML: its forward ``(params, x) -> logits``)."""
    name: str
    params: Dict[str, torch.Tensor]
    train_loss: Callable  # (params, episode, gen) -> (loss, aux)
    eval_raw: Callable  # (params, episode, gen) -> raw dict
    eval_finalize: Callable  # raw dict -> metrics dict
    eval_reduce: Dict[str, str]  # raw key -> "mean" | "sum" | "concat"
    model: Any = None
    # serving hook of a registered family: (cfg, family) ->
    # (adapt_fn(p, s_im, s_text, s_y, seeds) -> state,
    #  classify_fn(p, state, q_im) -> logits), each batched over the
    # request's R episodes (s_im (R, NK, D), q_im (R, M, D) -> (R, M, N))
    serve: Optional[Callable] = None
    # how --tpu_grad_accum combines each train aux key over micro-batches:
    # "mean" | "sum" | "concat" (:func:`accum_value_and_grad`)
    train_aux_reduce: Optional[Dict[str, str]] = None


class FamilySteps(NamedTuple):
    """Train/eval steps + params for one model family."""
    params: Dict[str, torch.Tensor]
    opt: optim.Optimizer
    train_step: Callable  # (params, opt_state, episode, gen) -> (p, s, m)
    eval_step: Callable  # (params, episode, gen) -> metrics
    family: Family = None
    # the engines' mesh (parallel/engine.py, parallel/pjit_engine.py);
    # None for the serial steps
    mesh: Any = None

    @property
    def model(self):
        return self.family.model if self.family else None


EVAL_REDUCE = {"loss": "mean", "acc": "mean", "preds": "concat",
               "targets": "concat"}
TRAIN_AUX_REDUCE = {"acc": "mean", "preds": "concat"}


def plain_full_gd_adaptation(cfg: Config) -> bool:
    """True when TEST-TIME adaptation is the plain full-parameter GD
    program the fused kernel implements. iMAML's proximal objective and
    ANIL's head-only updates are different programs; Reptile's eval-time
    adaptation IS plain GD (only its meta-update differs)."""
    return (cfg.meta_grad in ("explicit", "reptile")
            and cfg.adapt_params == "all")


def _use_fused_eval(cfg: Config, device: torch.device) -> bool:
    """Gate for the fused eval-adaptation kernel: opt-in
    (``--tpu_pallas_fused_eval``), fp32 (the kernel computes fp32 only),
    plain full GD, and covered by the kernel on this device."""
    return (cfg.pallas_fused_eval and plain_full_gd_adaptation(cfg)
            and cfg.compute_dtype == "float32"
            and kernels.fused_adapt_applicable(
                cfg.model, cfg.im_encoder, cfg.im_hid_dim,
                cfg.num_test_adapt_steps, device))


def _eval_raw_from_logits(logits: torch.Tensor, episode) -> Dict:
    """Eval-raw dict from post-adaptation query logits (fused kernel)."""
    loss = fewshot.cross_entropy(logits, episode.query_y)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    acc = (preds == episode.query_y).to(torch.float32).mean()
    return {"loss": loss, "acc": acc, "preds": preds,
            "targets": episode.query_y}


def _eval_raw_from_loss(loss, aux, episode) -> Dict:
    return {"loss": loss, "acc": aux["acc"], "preds": aux["preds"],
            "targets": episode.query_y}


def compute_dtype_of(cfg: Config) -> Optional[torch.dtype]:
    """``--tpu_compute_dtype`` as the operand dtype of matrix products and
    convolutions (None = fp32): the policy of ``models/layers.py``. It also
    stores the sampler's table in bf16 (``data/sampler.py:table_storage``,
    ``cli/main.py:_samplers``)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def remat_of(cfg: Config):
    """``--tpu_remat`` as the inner loop's ``remat`` argument
    (``metalearn/inner_loop.py:remat_active``): "on" checkpoints every
    inner step, "off" none; "auto" (None) checkpoints long horizons, and
    every horizon of resnet12 as ``"save_convs"``, the JAX package's
    policy for its 13-conv second-order step (whole-step checkpointing in
    the port)."""
    if cfg.remat == "on":
        return True
    if cfg.remat == "off":
        return False
    if cfg.im_encoder == "resnet12" and resnet12_stage_remat(cfg) is None:
        return "save_convs"
    return None


def resnet12_stage_remat(cfg: Config):
    """The per-stage checkpoint pattern of the resnet12 backbone
    (``resnet12.STAGE_REMAT_OVERRIDE``, the experiment switch) under
    ``--tpu_remat auto``; None in production. MAML and FuMI hand it to the
    backbone, in place of the step checkpointing (:func:`remat_of`)."""
    if cfg.im_encoder != "resnet12" or cfg.remat != "auto":
        return None
    from fumi_tpu_torch.models import resnet12
    return resnet12.STAGE_REMAT_OVERRIDE


# ---------------------------------------------------------------------------
# Family builders
# ---------------------------------------------------------------------------

def build_maml_family(cfg: Config, gen: torch.Generator,
                      dictionary=None) -> Family:
    """PureImageNetwork over precomputed embeddings + the MAML engine:
    explicit, Reptile or iMAML meta-gradients, all params or (ANIL) the
    head alone adapted. Eval adapts as training does, with no outer graph
    (Reptile's test-time adaptation is plain full GD). ``--im_encoder
    conv4|resnet12`` swaps the MLP for a backbone with its head."""
    cd = compute_dtype_of(cfg)
    if cfg.im_encoder in RAW_IMAGE_ENCODERS:
        net = raw_image_net(cfg.im_encoder)
        kw = ({"channels": tuple(cfg.resnet12_channels)}
              if cfg.im_encoder == "resnet12" else {})
        params = net.init(gen, cfg.im_size, cfg.im_channels,
                          n_way=cfg.num_ways, **kw)
    else:
        net = mlp
        params = mlp.init(gen, cfg.im_emb_dim, cfg.num_ways, cfg.im_hid_dim)

    kw = ({"stage_remat": resnet12_stage_remat(cfg)}
          if cfg.im_encoder == "resnet12" else {})

    def apply_fn(p, x):
        return net.apply(p, x, cd, **kw)
    # ANIL: only the head adapts
    adapt_mask = head_only_mask(params) if cfg.adapt_params == "head" \
        else None

    def loss_for(n_steps, differentiable):
        if cfg.meta_grad == "imaml":
            def loss_fn(p, episode, gen):
                return implicit.imaml_episode_loss(
                    apply_fn, p, episode, n_steps=n_steps,
                    step_size=cfg.step_size, lam=cfg.imaml_lambda,
                    cg_iters=cfg.imaml_cg_iters)
            return loss_fn
        if cfg.meta_grad == "reptile" and differentiable:
            def loss_fn(p, episode, gen):
                return reptile_episode_loss(
                    apply_fn, p, episode, n_steps=n_steps,
                    step_size=cfg.step_size)
            return loss_fn

        def loss_fn(p, episode, gen):
            return maml_episode_loss(
                apply_fn, p, episode, n_steps=n_steps,
                step_size=cfg.step_size, first_order=cfg.first_order,
                differentiable=differentiable, adapt_mask=adapt_mask,
                remat=remat_of(cfg))
        return loss_fn

    eval_loss = loss_for(cfg.num_test_adapt_steps, False)

    def eval_raw(p, episode, gen):
        if _use_fused_eval(cfg, episode.support_im.device):
            # the B tasks share one head: one launch spreads them over
            # the whole card
            with torch.no_grad():
                logits = kernels.fused_maml_adapt_batched(
                    p, episode.support_im, episode.support_y,
                    episode.query_im, cfg.num_test_adapt_steps,
                    cfg.step_size)
            return _eval_raw_from_logits(logits, episode)
        return _eval_raw_from_loss(*eval_loss(p, episode, gen), episode)

    return Family(name="maml", params=params,
                  train_loss=loss_for(cfg.num_train_adapt_steps, True),
                  eval_raw=eval_raw, eval_finalize=lambda raw: raw,
                  eval_reduce=dict(EVAL_REDUCE), model=apply_fn,
                  train_aux_reduce=dict(TRAIN_AUX_REDUCE))


def _make_text_encoder(cfg: Config, gen: torch.Generator, dictionary):
    return text_encoders.make_text_encoder(
        cfg.text_encoder, gen, cfg.text_emb_dim, dictionary=dictionary,
        pooling_strat=cfg.pooling_strat, fine_tune=cfg.fine_tune)


def build_fumi_family(cfg: Config, gen: torch.Generator,
                      dictionary=None) -> Family:
    """FuMI hypernet + headless image MLP + the joint inner loop (explicit
    or iMAML meta-gradients). A token text encoder (glove/w2v/RNN/RNNhid)
    needs ``dictionary``."""
    enc = _make_text_encoder(cfg, gen, dictionary)
    model = fumi_mod.FUMI(
        n_way=cfg.num_ways, im_emb_dim=cfg.im_emb_dim,
        im_hid_dim=tuple(cfg.im_hid_dim), text_encoder=enc,
        text_emb_dim=enc.out_dim, text_hid_dim=cfg.text_hid_dim,
        dropout_rate=cfg.dropout, norm_hypernet=cfg.norm_hypernet,
        fine_tune=cfg.fine_tune, init_bias=cfg.hypernet_bias_init,
        init_all_layers=cfg.init_all_layers,
        im_encoder_kind=(cfg.im_encoder
                         if cfg.im_encoder in RAW_IMAGE_ENCODERS else "mlp"),
        im_size=cfg.im_size, im_channels=cfg.im_channels,
        resnet12_channels=tuple(cfg.resnet12_channels),
        compute_dtype=compute_dtype_of(cfg),
        stage_remat=resnet12_stage_remat(cfg))
    params = model.init_params(gen)

    def loss_for(n_steps, train, differentiable):
        if cfg.meta_grad == "imaml":
            def loss_fn(p, episode, gen):
                return implicit.imaml_fumi_episode_loss(
                    model, p, episode, n_steps=n_steps,
                    step_size=cfg.step_size, gen=gen, lam=cfg.imaml_lambda,
                    cg_iters=cfg.imaml_cg_iters)
            return loss_fn

        def loss_fn(p, episode, gen):
            return fumi_episode_loss(
                model, p, episode, n_steps=n_steps, step_size=cfg.step_size,
                gen=gen, train=train, differentiable=differentiable,
                remat=remat_of(cfg))
        return loss_fn

    eval_loss = loss_for(cfg.num_test_adapt_steps, False, False)

    def eval_raw(p, episode, gen):
        if _use_fused_eval(cfg, episode.support_im.device):
            with torch.no_grad():
                hyper0 = model.get_hyper_params(p, episode.support_text,
                                                episode.support_y, gen)
                logits = kernels.fused_fumi_adapt(
                    p, hyper0, episode.support_im, episode.support_y,
                    episode.query_im, cfg.num_test_adapt_steps,
                    cfg.step_size)
            return _eval_raw_from_logits(logits, episode)
        return _eval_raw_from_loss(*eval_loss(p, episode, gen), episode)

    return Family(name="fumi", params=params,
                  train_loss=loss_for(cfg.num_train_adapt_steps, True, True),
                  eval_raw=eval_raw, eval_finalize=lambda raw: raw,
                  eval_reduce=dict(EVAL_REDUCE), model=model,
                  train_aux_reduce=dict(TRAIN_AUX_REDUCE))


def build_am3_family(cfg: Config, gen: torch.Generator,
                     dictionary=None) -> Family:
    """AM3's prototypical episode. Metrics come from the meta-batch's
    confusion matrix (``sum``-reducible), from which accuracy and the
    sklearn-macro P/R/F1 follow. A token text encoder needs
    ``dictionary``."""
    enc = _make_text_encoder(cfg, gen, dictionary)
    model = am3_mod.AM3(
        im_emb_dim=cfg.im_emb_dim, prototype_dim=cfg.prototype_dim,
        text_encoder=enc, text_emb_dim=enc.out_dim,
        text_hid_dim=cfg.text_hid_dim, dropout=cfg.dropout,
        fine_tune=cfg.fine_tune, lamda_fixed=cfg.lamda_fixed,
        im_encoder_kind=(cfg.im_encoder
                         if cfg.im_encoder in RAW_IMAGE_ENCODERS
                         else "linear"),
        im_size=cfg.im_size, im_channels=cfg.im_channels,
        resnet12_channels=tuple(cfg.resnet12_channels),
        compute_dtype=compute_dtype_of(cfg))
    params = model.init_params(gen)
    N = cfg.num_ways

    def train_loss(p, episode, gen):
        loss, aux = model.episode_loss(p, episode, N, gen, train=True)
        preds = fewshot.predict_classes(aux["prototypes"].detach(),
                                        aux["query_emb"].detach())
        conf = metrics_ops.confusion_matrix(episode.query_y, preds, N)
        return loss, {"conf": conf, "avg_lamda": aux["avg_lamda"],
                      "preds": preds}

    def eval_raw(p, episode, gen):
        loss, aux = model.episode_loss(p, episode, N, gen, train=False)
        preds = fewshot.predict_classes(aux["prototypes"], aux["query_emb"])
        conf = metrics_ops.confusion_matrix(episode.query_y, preds, N)
        return {"loss": loss, "conf": conf, "avg_lamda": aux["avg_lamda"],
                "preds": preds, "targets": episode.query_y,
                "lamda": aux["lamda"][..., 0]}

    def eval_finalize(raw):
        """acc, prec, rec and f1 of one meta-batch's confusion matrix."""
        return {"loss": raw["loss"], **metrics_ops.conf_metrics(raw["conf"]),
                "avg_lamda": raw["avg_lamda"],
                **{k: raw[k] for k in ("preds", "targets", "lamda")
                   if k in raw}}

    return Family(name="am3", params=params, train_loss=train_loss,
                  eval_raw=eval_raw, eval_finalize=eval_finalize,
                  eval_reduce={"loss": "mean", "conf": "sum",
                               "avg_lamda": "mean", "preds": "concat",
                               "targets": "concat", "lamda": "concat"},
                  model=model,
                  train_aux_reduce={"conf": "sum", "avg_lamda": "mean",
                                    "preds": "concat"})


def embedding_head_init(cfg: Config, gen: torch.Generator
                        ) -> Dict[str, torch.Tensor]:
    """ProtoNet's and MatchingNet's params: one Linear(im_emb_dim →
    prototype_dim) named ``image_encoder`` (the JAX package keeps it as a
    bare ``{"w", "b"}`` layer), or a headless backbone with a ``head``
    projection to prototype_dim."""
    if cfg.im_encoder in RAW_IMAGE_ENCODERS:
        params, fdim = headless_backbone_init(
            cfg.im_encoder, gen, cfg.im_size, cfg.im_channels,
            cfg.resnet12_channels)
        params["head.weight"], params["head.bias"] = layers.linear_init(
            gen, fdim, cfg.prototype_dim)
        return params
    w, b = layers.linear_init(gen, cfg.im_emb_dim, cfg.prototype_dim)
    return {"image_encoder.weight": w, "image_encoder.bias": b}


def image_embedder(cfg: Config) -> Callable:
    """ProtoNet's and MatchingNet's ``embed(p, x)``: (B, M, im_emb_dim) or
    raw (B, M, H, W, C) -> (B, M, P). A backbone normalizes with the
    statistics of all B·M images, as the JAX package reshapes them."""
    cd = compute_dtype_of(cfg)
    if cfg.im_encoder in RAW_IMAGE_ENCODERS:
        net = raw_image_net(cfg.im_encoder)

        def embed(p, x):
            B, M = x.shape[:2]
            feats = net.backbone(p, x.reshape((B * M,) + x.shape[2:]), cd)
            return layers.linear(p["head.weight"], p["head.bias"], feats,
                                 cd).reshape(B, M, -1)
        return embed

    def embed(p, x):
        return layers.linear(p["image_encoder.weight"],
                             p["image_encoder.bias"], x, cd)
    return embed


def image_prototypes(emb: torch.Tensor, targets: torch.Tensor,
                     num_ways: int) -> torch.Tensor:
    """ProtoNet's class prototypes (B, N, P): the λ-fused prototypes with
    λ ≡ 1, the image embeddings alone."""
    lam = torch.ones(emb.shape[:-1] + (1,), dtype=emb.dtype,
                     device=emb.device)
    return fewshot.get_prototypes(emb, emb, lam, targets, num_ways)


def _no_inner_loop_family(name: str, params, raw_fn) -> Family:
    """A family whose episode is ``raw_fn(p, episode) -> (loss, preds)``."""
    def metrics(p, episode):
        loss, preds = raw_fn(p, episode)
        acc = (preds == episode.query_y).to(torch.float32).mean()
        return loss, preds, acc

    def train_loss(p, episode, gen):
        loss, preds, acc = metrics(p, episode)
        return loss, {"acc": acc, "preds": preds}

    def eval_raw(p, episode, gen):
        loss, preds, acc = metrics(p, episode)
        return {"loss": loss, "acc": acc, "preds": preds,
                "targets": episode.query_y}

    return Family(name=name, params=params, train_loss=train_loss,
                  eval_raw=eval_raw, eval_finalize=lambda raw: raw,
                  eval_reduce=dict(EVAL_REDUCE))


def build_protonet_family(cfg: Config, gen: torch.Generator,
                          dictionary=None) -> Family:
    """Prototypical Networks (Snell et al. 2017): class means of the
    embedded support set, the queries' prototypical cross-entropy."""
    N = cfg.num_ways
    embed = image_embedder(cfg)

    def raw(p, episode):
        protos = image_prototypes(embed(p, episode.support_im),
                                  episode.support_y, N)
        q_e = embed(p, episode.query_im)  # (B, NQ, P)
        return (fewshot.prototypical_loss(protos, q_e, episode.query_y),
                fewshot.predict_classes(protos, q_e))
    return _no_inner_loop_family("protonet", embedding_head_init(cfg, gen),
                                 raw)


def build_matchingnet_family(cfg: Config, gen: torch.Generator,
                             dictionary=None) -> Family:
    """Matching Networks (Vinyals et al. 2016, without full context
    embeddings): queries attend over the support samples with softmaxed
    cosine similarity and sum their one-hot labels."""
    N = cfg.num_ways
    embed = image_embedder(cfg)

    def raw(p, episode):
        probs = fewshot.matching_probs(embed(p, episode.support_im),
                                       episode.support_y,
                                       embed(p, episode.query_im), N)
        picked = torch.gather(probs, -1,
                              episode.query_y.long().unsqueeze(-1))[..., 0]
        return (-torch.log(picked + 1e-8).mean(),
                torch.argmax(probs, dim=-1).to(torch.int32))
    return _no_inner_loop_family("matchingnet",
                                 embedding_head_init(cfg, gen), raw)


# ---------------------------------------------------------------------------
# Family registry
# ---------------------------------------------------------------------------
# A new episodic family registers itself and inherits the chunked drivers,
# the loop, the driver and (through Family.serve) serving.

FAMILY_REGISTRY: Dict[str, Callable] = {}


def register_family(name: str):
    """Decorator: register a ``(cfg, gen, dictionary) -> Family``
    builder under ``--model name``."""
    def deco(fn):
        FAMILY_REGISTRY[name] = fn
        return fn
    return deco


register_family("maml")(build_maml_family)
register_family("fumi")(build_fumi_family)
register_family("am3")(build_am3_family)
register_family("protonet")(build_protonet_family)
register_family("matchingnet")(build_matchingnet_family)


def build_family(cfg: Config, gen: torch.Generator,
                 dictionary=None) -> Family:
    """The registered builder of ``cfg.model``."""
    builder = FAMILY_REGISTRY.get(cfg.model)
    if builder is None:
        raise NotImplementedError(
            f"model {cfg.model!r} not registered (have "
            f"{sorted(FAMILY_REGISTRY)}; CLIP uses "
            "fumi_tpu_torch.train.clip_loop and serve.ClipRetrieval)")
    return builder(cfg, gen, dictionary)


# ---------------------------------------------------------------------------
# Optimizer and steps
# ---------------------------------------------------------------------------

def frozen_text_encoder(cfg: Config) -> bool:
    """True when the model's ``text_encoder`` params can never receive a
    gradient: ``--fine_tune`` off for token encoders, or the ``rand``
    encoder whose Linear is created but never used."""
    if cfg.model not in ("am3", "fumi"):
        return False
    if cfg.text_encoder == "rand":
        return True
    return cfg.text_encoder in TOKEN_TEXT_ENCODERS and not cfg.fine_tune


def make_opt(cfg: Config) -> optim.Optimizer:
    """The reference's optimizer for this config. Only AM3 steps the lr
    schedule; MAML/FuMI unpack it but never step it."""
    opt = optim.init_optim(cfg.optim, cfg.lr, cfg.weight_decay, cfg.momentum,
                           cfg.num_warmup_steps, cfg.epochs,
                           schedule_active=(cfg.model == "am3"))
    if frozen_text_encoder(cfg):
        # torch skips params whose grad is None: coupled L2 must not
        # drift the frozen encoder
        opt = optim.zero_updates_for_key(opt, "text_encoder")
    if cfg.ema > 0:
        # the EMA rides in the optimizer state, through the chunked
        # drivers and checkpoints; chained INSIDE any apply_if_finite, so
        # a skipped step does not move it either
        opt = optim.chain(opt, optim.params_ema(cfg.ema))
    if cfg.skip_nonfinite > 0:
        # a non-finite meta-gradient skips the update instead of writing
        # NaNs into the params (optax applies it after that many
        # consecutive skips)
        opt = optim.apply_if_finite(opt, cfg.skip_nonfinite)
    return opt


def value_and_grad(family: Family, params, episode, gen,
                   prepare: Optional[Callable] = None):
    """``((loss, aux), grads)`` of ``family.train_loss`` w.r.t. every
    param; a param the loss does not read gets a zero gradient.
    ``prepare`` maps the leaves to what the loss reads (the 2-D engine
    gathers its sharded non-linear leaves there,
    ``parallel/pjit_engine.py``)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        with span("train.loss"):
            loss, aux = family.train_loss(
                leaves if prepare is None else prepare(leaves), episode, gen)
            count_memory("train.loss")
        with span("train.meta_grad"):
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            count_memory("train.meta_grad")
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    # aux leaves (AM3's avg_lamda) must not keep the step's graph alive
    aux = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in aux.items()}
    return (loss.detach(), aux), grads


def check_finite(step, loss, grads, new_params) -> None:
    """``--tpu_debug_nans``: raise ``FloatingPointError`` naming train step
    ``step`` and the first non-finite leaf of the loss, the gradients or
    the updated params, in that order (each in state-dict order). One host
    sync a step; it only reads the tensors, so a finite run computes
    bitwise what it computes without the check."""
    named = [("loss", loss)]
    named += [(f"gradient of {k}", g) for k, g in grads.items()]
    named += [(f"param {k}", p) for k, p in new_params.items()]
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    if not all(ok):
        name = named[ok.index(False)][0]
        raise FloatingPointError(
            f"--tpu_debug_nans: train step {step} made a non-finite value "
            f"in the {name}")


def micro_generator(gen: Optional[torch.Generator], i: int
                    ) -> Optional[torch.Generator]:
    """The generator of micro-batch ``i`` of an accumulated step (the JAX
    package's ``fold_in(rng, i)``): a new generator on ``gen``'s device,
    seeded with 63 bits of the BLAKE2b hash of ``gen``'s state and ``i``.
    Reading the state is a host-side copy (a CUDA generator's state is its
    seed and offset), so it makes no device sync; ``gen`` itself does not
    advance. None stays None."""
    if gen is None:
        return None
    h = hashlib.blake2b(gen.get_state().numpy().tobytes()
                        + int(i).to_bytes(4, "little"), digest_size=8)
    return torch.Generator(device=gen.device).manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


def accum_value_and_grad(family: Family, accum: int) -> Callable:
    """``(params, episode, gen) -> ((loss, aux), grads)`` of the meta-batch
    in ``accum`` micro-batches (``--tpu_grad_accum``), one after another:
    the B tasks are split into ``accum`` slices of B/accum, so the
    second-order graph held at once scales with B/accum. Every family's
    loss is a mean over tasks, so the mean of the micro-batches' losses
    and gradients is the meta-batch's, up to the order of the sums.
    Micro-batch ``i`` draws its forward noise (dropout, the ``rand``
    encoder) from :func:`micro_generator` ``(gen, i)``, so a stochastic
    forward is the same in distribution as the whole batch's, not bitwise.

    The aux is combined as ``family.train_aux_reduce`` declares ("mean",
    "sum" or "concat" along the task axis); an undeclared key follows the
    shape rule: ``conf`` (a count matrix) is summed, a scalar averaged, a
    leaf whose leading size is B/accum concatenated, and any other leaf
    raises ``ValueError``. The rule cannot tell a per-task leaf from one
    whose leading size happens to equal B/accum (per-class with num_ways
    == B/accum): a family with such an aux declares it."""
    if accum <= 1:
        return lambda p, episode, gen: value_and_grad(family, p, episode,
                                                      gen)
    declared = family.train_aux_reduce or {}

    def combine(k, v, micro_size):
        # v: (accum,) + the micro-batch's aux shape
        how = declared.get(k)
        if how == "mean":
            return _mean0(v)
        if how == "sum":
            return v.sum(0)
        if how == "concat":
            return v.reshape((-1,) + tuple(v.shape[2:]))
        if how is not None:
            raise ValueError(f"train_aux_reduce[{k!r}] = {how!r} "
                             "(mean|sum|concat)")
        if k == "conf":
            return v.sum(0)
        if v.dim() <= 1:
            return _mean0(v)
        if v.shape[1] != micro_size:
            raise ValueError(
                f"--tpu_grad_accum cannot combine aux leaf {k!r}: "
                f"per-micro-batch shape {tuple(v.shape[1:])} is neither "
                f"scalar, 'conf' (summed counts), nor per-task (leading dim "
                f"{micro_size}) — declare it via Family.train_aux_reduce")
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def run(params, episode, gen):
        micro_size = episode.support_im.shape[0] // accum
        outs = []
        for i in range(accum):
            part = slice(i * micro_size, (i + 1) * micro_size)
            micro = type(episode)(*(None if x is None else x[part]
                                    for x in episode))
            outs.append(value_and_grad(family, params, micro,
                                       micro_generator(gen, i)))
        loss = torch.stack([l for (l, _), _ in outs]).mean(0)
        grads = {k: torch.stack([g[k] for _, g in outs]).mean(0)
                 for k in params}
        auxs = [a for (_, a), _ in outs]
        aux = {k: combine(k, torch.stack([torch.as_tensor(a[k])
                                          for a in auxs]), micro_size)
               for k in auxs[0]}
        return (loss, aux), grads

    return run


def _mean0(v: torch.Tensor) -> torch.Tensor:
    return (v if v.is_floating_point() else v.to(torch.float32)).mean(0)


def _step_and_grads(family: Family, opt: optim.Optimizer, params, opt_state,
                    episode, gen, debug_step=None, grad_fn=None):
    """One step, and its meta-gradient; ``grad_fn`` is
    :func:`accum_value_and_grad`'s (default: the whole batch's)."""
    grad_fn = grad_fn or accum_value_and_grad(family, 1)
    (loss, aux), grads = grad_fn(params, episode, gen)
    with torch.no_grad():
        with span("train.update"):
            updates, opt_state = opt.update(grads, opt_state, params)
            new_params = optim.apply_updates(params, updates)
        if debug_step is not None:
            check_finite(debug_step, loss, grads, new_params)
        with span("train.step_metrics"):
            metrics = _train_metrics(family, loss, aux, episode, grads)
    return new_params, opt_state, metrics, grads


def _train_step(family: Family, opt: optim.Optimizer, params, opt_state,
                episode, gen, debug_step=None):
    """One step; with ``debug_step`` (an int) the result is checked by
    :func:`check_finite`."""
    return _step_and_grads(family, opt, params, opt_state, episode, gen,
                           debug_step)[:3]


def steps_from_family(family: Family, opt: optim.Optimizer,
                      debug_nans: bool = False) -> FamilySteps:
    """Wrap a Family into train/eval steps. ``debug_nans`` checks every
    train step (:func:`check_finite`); ``train_step(..., step=i)`` names
    the step, which otherwise counts on from the last one (from 0)."""
    count = [0]

    def train_step(params, opt_state, episode, gen, step=None):
        if step is None:
            step = count[0]
        count[0] = step + 1
        return _train_step(family, opt, params, opt_state, episode, gen,
                           step if debug_nans else None)

    def eval_step(params, episode, gen):
        with torch.no_grad():
            return family.eval_finalize(family.eval_raw(params, episode, gen))

    return FamilySteps(params=family.params, opt=opt, train_step=train_step,
                       eval_step=eval_step, family=family)


def component_partition(tree: Dict[str, torch.Tensor], family: str
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's top-level components of a flat state dict: MAML's
    layer tuple is ``layer0``, ``layer1``, ...; ProtoNet's and
    MatchingNet's bare linear is ``w`` and ``b``; dicts (FuMI's, AM3's, a
    raw backbone's ``convs``/``blocks`` and ``head``) are the first part
    of each name (``text_encoder`` / ``hyper_net`` / ``im_net``;
    ``image_encoder`` / ``text_encoder`` / ``g`` / ``h``). An empty
    component has no entries, so it is absent."""
    if family == "maml" and "net.lin_final.weight" in tree:
        return {f"layer{i}": {name + ".weight": tree[name + ".weight"],
                              name + ".bias": tree[name + ".bias"]}
                for i, name in enumerate(mlp.layer_names(tree))}
    if family in ("protonet", "matchingnet") and \
            "image_encoder.weight" in tree:
        return {c: {k: tree[k]} for c, k in (
            ("w", "image_encoder.weight"), ("b", "image_encoder.bias"))}
    parts: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in tree.items():
        parts.setdefault(k.split(".", 1)[0], {})[k] = v
    return parts


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def per_layer_grad_norms(grads, family: str) -> Dict[str, torch.Tensor]:
    """``grad_norm/<component>`` for every top-level component."""
    return {f"grad_norm/{k}": global_norm(g)
            for k, g in component_partition(grads, family).items()}


def _train_metrics(family: Family, loss, aux, episode, grads=None,
                   per_layer=None) -> Dict:
    """Per-train-step metrics: loss, acc (AM3: acc, prec, rec, f1 and
    avg_lamda from the confusion matrix), and the global and per-component
    gradient norms when grads are supplied (``per_layer``: those norms
    computed already, as the 2-D engine computes them over its shards)."""
    extra = {}
    if grads is not None:
        if per_layer is None:
            per_layer = per_layer_grad_norms(grads, family.name)
        # the components partition the grads: the global norm follows
        extra["grad_norm"] = torch.sqrt(sum(v * v for v in per_layer.values()))
        extra.update(per_layer)
    if family.name == "am3":
        return {"loss": loss, **metrics_ops.conf_metrics(aux["conf"]),
                "avg_lamda": aux["avg_lamda"], **extra}
    return {"loss": loss, "acc": aux["acc"], **extra}


def make_steps(cfg: Config, gen: torch.Generator,
               device: DeviceLike = None, dictionary=None) -> FamilySteps:
    """The family's steps with its params on ``device`` (default the
    current CUDA device; ``"cpu"`` for the CPU); ``dictionary`` for a
    token text encoder."""
    dev = resolve_device(device)
    family = build_family(cfg, gen, dictionary)
    family = family._replace(params={k: v.to(dev)
                                     for k, v in family.params.items()})
    return steps_from_family(family, make_opt(cfg), cfg.debug_nans)


# ---------------------------------------------------------------------------
# Chunked drivers
# ---------------------------------------------------------------------------

def _stack(per_step) -> Dict[str, torch.Tensor]:
    """A list of per-step metric dicts -> one dict of (n, ...) tensors."""
    if not per_step:
        return {}
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_chunked_train(family: Family, opt: optim.Optimizer, sampler,
                       chunk: int, accum: int = 1,
                       watch: bool = False,
                       debug_nans: bool = False) -> Callable:
    """``(params, opt_state, gen, n=chunk, first_step=0) -> (params,
    opt_state, gen, metrics)`` running ``n`` device-sampled train steps;
    each metric is ``(n,)`` on the device (no host sync inside the chunk).
    ``accum`` > 1 computes each step's meta-gradient in micro-batches
    (:func:`accum_value_and_grad`) from the same B tasks, gathered in one
    launch and then split. ``watch`` adds ``watch_counts/<component>``
    rows, (n // K, NUM_BUCKETS), K = ``min(watch.WATCH_STRIDE, n)``: the
    histogram of the meta-gradient of the last step of each block of K
    (``train/watch.py``); it reads the gradients only, so the params are
    bitwise those of an unwatched chunk. ``debug_nans`` checks each step
    (:func:`check_finite`, one sync a step), numbering the steps from
    ``first_step``."""
    grad_fn = accum_value_and_grad(family, accum)

    def run(params, opt_state, gen, n=chunk, first_step=0):
        stride = max(1, min(watch_lib.WATCH_STRIDE, n)) if watch else 0
        per_step, counts = [], []
        for j in range(n):
            with span("train.step"):
                with span("train.sample"):
                    episode = sampler.sample(gen)
                params, opt_state, m, grads = _step_and_grads(
                    family, opt, params, opt_state, episode, gen,
                    first_step + j if debug_nans else None, grad_fn)
                per_step.append(m)
                if stride and (j + 1) % stride == 0:
                    counts.append(watch_lib.grad_histogram_metrics(
                        grads, family.name))
        ms = _stack(per_step)
        ms.update(_stack(counts))
        return params, opt_state, gen, ms
    return run


def make_chunked_eval(family: Family, sampler, collect: bool = False
                      ) -> Callable:
    """``(params, gen, n) -> (gen, metrics)`` over ``n`` device-sampled eval
    meta-batches; scalar metrics stack to ``(n,)``. With ``collect``,
    per-query predictions/targets, AM3's per-support λ and the episode's
    image ids ride along."""
    def run(params, gen, n):
        per_step = []
        with torch.no_grad():
            for _ in range(n):
                episode = sampler.sample(gen)
                out = family.eval_finalize(family.eval_raw(params, episode,
                                                           gen))
                m = {k: v for k, v in out.items() if v.dim() == 0}
                if collect:
                    m.update({k: out[k] for k in ("preds", "targets",
                                                  "lamda") if k in out})
                    m["query_idx"] = episode.query_ids
                    m["support_idx"] = episode.support_ids
                per_step.append(m)
        return gen, _stack(per_step)
    return run
