"""CLIP supervised training and retrieval evaluation.

The counterpart of ``fumi_tpu/train/clip_loop.py``:

- per-batch class dedupe (``np.unique(batch_ids, return_index=True)``) on
  the host, repadded to the batch size, so every step has one shape;
- the symmetric cross-entropy on the cosine-similarity matrix with arange
  labels, masked to the valid rows and columns (``NEG_INF`` on the invalid
  columns): the same function as the loss of the deduped batch sliced out;
- evaluation: sliding windows of ``n_ways`` images against the window's
  first text over a shuffled pass, with stride ``n_ways`` while
  ``shot_i + n_ways < valid_n``; all windows scored in one call;
- the epoch harness: an initial validation pass seeds ``best_acc``, then
  per epoch a validation pass on a fresh window draw, a checkpoint,
  best-accuracy tracking and patience, and ``best/`` reloaded at the end.

The batches come from numpy with the JAX package's seeds, so the windows
and dedupes are the JAX package's bit for bit. The optimizer is
``train/optim.py:init_optim`` with no schedule masking, as the JAX driver
builds it.

Several devices (``mesh``, a dp mesh of ranks, ``core/mesh.py``): every
rank draws the same batches; rank r embeds its ``B/dp`` rows
(:func:`dp_train_step`). The symmetric loss needs the global (B, B)
similarity, so the embeddings are all-gathered with autograd
(:class:`_GatherRows`: its backward all-reduces the rows' gradient and
keeps the rank's rows). Each rank takes the loss of its own rows and
columns only, or the gather's backward would count the loss dp times; the
ranks' gradients and losses are then all-reduced (summed), so every rank
applies the whole batch's update and the params stay equal across ranks.
Validation runs whole on every rank; only a rank that writes the run
(``core/distributed.py:writes_run``) saves checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fumi_tpu_torch.core import distributed
from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.mesh import Mesh, all_gather_cat, all_reduce_
from fumi_tpu_torch.data.supervised import SupervisedSet, epoch_batches
from fumi_tpu_torch.models import layers
from fumi_tpu_torch.models.clip import CLIP
from fumi_tpu_torch.train import checkpoint as ckpt_lib
from fumi_tpu_torch.train import optim
from fumi_tpu_torch.train.logging import MetricWriter

NEG_INF = -1e9


def make_clip(cfg: Config, gen: torch.Generator):
    """The CLIP spec at the config's widths and its params, drawn from
    ``gen`` on the CPU; ``--tpu_compute_dtype bfloat16`` rounds its
    products' operands."""
    model = CLIP(text_input_dim=cfg.text_emb_dim,
                 image_input_dim=cfg.im_emb_dim,
                 latent_dim=cfg.clip_latent_dim,
                 compute_dtype=(torch.bfloat16
                                if cfg.compute_dtype == "bfloat16" else None))
    return model, model.init_params(gen)


def masked_symmetric_ce(model: CLIP, params, text: torch.Tensor,
                        image: torch.Tensor, valid_n: int) -> torch.Tensor:
    """Symmetric CE over the first ``valid_n`` (deduped) rows and columns
    of a (B, B) similarity matrix: the loss of the batch sliced to
    ``valid_n``, at a static shape."""
    sim = model.forward(params, text, image)  # (B, B)
    valid = torch.arange(sim.shape[0], device=sim.device) < valid_n

    def masked_ce(logits):
        logits = torch.where(valid.unsqueeze(0), logits, NEG_INF)
        nll = -torch.diagonal(F.log_softmax(logits, dim=-1))
        return torch.where(valid, nll, 0.0).sum() / max(valid_n, 1)

    return (masked_ce(sim) + masked_ce(sim.T)) / 2.0


def dedupe_batch(image: np.ndarray, text: np.ndarray, ids: np.ndarray,
                 valid_n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """First-occurrence class dedupe, repadded with the first kept row."""
    _, unique_idx = np.unique(ids[:valid_n], return_index=True)
    u = len(unique_idx)
    B = image.shape[0]
    pad = np.concatenate([unique_idx,
                          np.repeat(unique_idx[:1], B - u)])
    return image[pad], text[pad], u


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def train_step(model: CLIP, opt: optim.Optimizer, params, opt_state,
               text: torch.Tensor, image: torch.Tensor, valid_n: int):
    """One optimizer step on a deduped batch of ``valid_n`` valid rows:
    ``(params, opt_state, loss)``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = masked_symmetric_ce(model, leaves, text, image, valid_n)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss.detach()


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks concatenated in rank order; backward sums the
    ranks' gradients of the whole and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_cat(x, mesh.dp_group, gloo=mesh.gloo)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.mesh.dp_group)
        lo = ctx.mesh.dp_index * ctx.rows
        return g[lo:lo + ctx.rows], None


def dp_loss(model: CLIP, params, text: torch.Tensor, image: torch.Tensor,
            valid_n: int, mesh: Mesh) -> torch.Tensor:
    """This rank's share of :func:`masked_symmetric_ce` of the whole
    batch: the terms of its ``B/dp`` rows of the similarity and of its
    transpose. The shares sum to the batch's loss."""
    B = text.shape[0]
    n = B // mesh.dp
    lo = mesh.dp_index * n
    t = _GatherRows.apply(model.encode_text(params, text[lo:lo + n]), mesh)
    i = _GatherRows.apply(model.encode_image(params, image[lo:lo + n]),
                          mesh)
    sim = layers.matmul_f32acc(t, i.transpose(-1, -2), model.compute_dtype)
    valid = torch.arange(B, device=sim.device) < valid_n

    def masked_ce(logits):
        logits = torch.where(valid.unsqueeze(0), logits, NEG_INF)
        nll = -torch.diagonal(F.log_softmax(logits, dim=-1))
        return torch.where(valid, nll, 0.0)[lo:lo + n].sum() / max(valid_n, 1)

    return (masked_ce(sim) + masked_ce(sim.T)) / 2.0


def dp_train_step(model: CLIP, opt: optim.Optimizer, params, opt_state,
                  text: torch.Tensor, image: torch.Tensor, valid_n: int,
                  mesh: Mesh):
    """:func:`train_step` over the rows of a dp mesh: each rank's loss
    share and its gradient, summed over the ranks in one all-reduce, then
    the same update on every rank. ``(params, opt_state, loss)``."""
    if text.shape[0] % mesh.dp:
        raise ValueError(f"batch_size {text.shape[0]} not divisible by "
                         f"dp={mesh.dp}")
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = dp_loss(model, leaves, text, image, valid_n, mesh)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    all_reduce_(flat.detach(), mesh.dp_group)
    out, at = {}, 0
    for k, g in zip(leaves, grads):
        out[k] = flat[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    with torch.no_grad():
        updates, opt_state = opt.update(out, opt_state, params)
        return (optim.apply_updates(params, updates), opt_state,
                flat[-1].detach())


def train_epoch(cfg: Config, model: CLIP, opt: optim.Optimizer, params,
                opt_state, train_data: Tuple[SupervisedSet, np.ndarray],
                rng: np.random.RandomState, mesh: Optional[Mesh] = None):
    """One shuffled pass over the train split: each batch deduped on the
    host, copied to the params' device and stepped (over ``mesh``'s rows
    where given). Returns ``(params, opt_state, steps)``."""
    train_ds, image_table = train_data
    dev = _device_of(params)
    n = 0
    for image, text, ids, valid_n in epoch_batches(
            train_ds, image_table, cfg.batch_size, rng):
        image, text, u = dedupe_batch(image, text, ids, valid_n)
        if mesh is None:
            params, opt_state, _ = train_step(
                model, opt, params, opt_state, _put(text, dev),
                _put(image, dev), u)
        else:
            params, opt_state, _ = dp_train_step(
                model, opt, params, opt_state, _put(text, dev),
                _put(image, dev), u, mesh)
        n += 1
    return params, opt_state, n


def training_run(cfg: Config, model: CLIP, params, opt: optim.Optimizer,
                 train_data: Tuple[SupervisedSet, np.ndarray],
                 val_data: Tuple[SupervisedSet, np.ndarray],
                 writer: MetricWriter, run_dir: str,
                 rng: np.random.RandomState, mesh=None):
    """The CLIP epoch loop on the params' device (its rows over ``mesh``,
    a dp mesh of ranks, where given). Returns the params of ``best/``
    where one was written, else the last ones."""
    opt_state = opt.init(params)
    if mesh is not None and mesh.dp == 1:
        mesh = None
    best_acc = evaluate(cfg, model, params, val_data)
    best_epoch = 0
    print("init val_acc", best_acc)

    for epoch in range(cfg.epochs):
        params, opt_state, _ = train_epoch(cfg, model, opt, params,
                                           opt_state, train_data, rng, mesh)
        # a fresh validation window draw each epoch, as the reference's
        # shuffling val DataLoader draws one per pass
        val_acc = evaluate(cfg, model, params, val_data,
                           eval_seed=cfg.seed + 1 + epoch)
        print("epoch", epoch, "val_acc", val_acc)
        writer.log({"val/acc": val_acc}, step=epoch)
        is_best = val_acc > best_acc
        if is_best:
            best_acc = val_acc
            best_epoch = epoch
        if distributed.writes_run():
            ckpt_lib.save_checkpoint(
                run_dir, params, opt_state, epoch, best_acc, is_best,
                extra_meta={"model": "clip", "args": dataclasses.asdict(cfg)})
        if cfg.patience > 0 and epoch - best_epoch > cfg.patience:
            break

    distributed.run_barrier()  # a spawned world reads rank 0's best/
    if os.path.exists(os.path.join(run_dir, "best")):
        params, _, _ = ckpt_lib.load_checkpoint(run_dir, params, opt_state,
                                                best=True)
    return params


def evaluate(cfg: Config, model: CLIP, params,
             data: Tuple[SupervisedSet, np.ndarray],
             eval_seed: Optional[int] = None) -> float:
    """Sliding-window retrieval accuracy over one shuffled pass.

    The shuffle is seeded from ``cfg.seed`` (or ``eval_seed``; the epoch
    loop passes one per epoch), so a run's draw is deterministic and a
    different draw per seed and epoch, as in the JAX package. Accuracy is
    the count of wins times the fp32 reciprocal of the window count, as
    XLA lowers ``jnp.mean``, so it is the JAX package's bit for bit when
    the wins agree."""
    ds, image_table = data
    n_ways = cfg.num_ways
    texts, windows = [], []
    seed = cfg.seed if eval_seed is None else eval_seed
    rng = np.random.RandomState(np.uint32(seed))
    for image, text, ids, valid_n in epoch_batches(
            ds, image_table, cfg.batch_size, rng, shuffle=True):
        shot_i = 0
        while shot_i + n_ways < valid_n:
            texts.append(text[shot_i])
            windows.append(image[shot_i:shot_i + n_ways])
            shot_i += n_ways
    if not windows:
        return 0.0
    dev = _device_of(params)
    with torch.no_grad():
        scores = model.retrieval_scores(params, _put(np.stack(texts), dev),
                                        _put(np.stack(windows), dev))
        return float(scores.sum() * (1.0 / scores.numel()))
