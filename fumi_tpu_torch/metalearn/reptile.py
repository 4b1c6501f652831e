"""Reptile — first-order meta-learning by parameter interpolation
(Nichol, Achiam & Schulman, 2018).

The counterpart of ``fumi_tpu/metalearn/reptile.py``. Each task runs plain
SGD on its support set with no meta-graph at all, and the meta-update
moves the initialization toward the adapted parameters:

    θ ← θ + ε·(φ_T − θ)   ⇔   pseudo-gradient g = θ − φ_T

It keeps the train step's contract (a loss whose gradient the optimizer
consumes) through a ``torch.autograd.Function``, the JAX package's
``custom_vjp``: the forward value is the post-adaptation QUERY loss of each
task (monitoring only; Reptile never differentiates it), with the accuracy
and the predictions marked non-differentiable, and the backward returns
``(θ − φ_T)·grad_output`` for every param. :func:`reptile_episode_loss`
averages over the B tasks, so each task's pseudo-gradient carries 1/B.
Adam and the other optimizers then consume it like any meta-gradient.

Select with ``--tpu_meta_grad reptile`` (MAML family). Test-time adaptation
is plain full-parameter GD, so evaluation and serving run the fused kernel
where it applies. An extension: the reference implements only explicit
MAML (ref: fumi/models/maml.py:134-193).
"""

from __future__ import annotations

from typing import Callable

import torch

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn.inner_loop import (Params, adapt, per_task,
                                                 task_cross_entropy)


class _ReptileTasks(torch.autograd.Function):
    """``(losses (B,), accs (B,), preds (B, M))`` of the B tasks after
    ``n_steps`` of support SGD from the shared ``theta``; the backward is
    the Reptile pseudo-gradient."""

    @staticmethod
    def forward(ctx, apply_fn, episode, n_steps, step_size, keys, *theta):
        B = episode.support_im.shape[0]
        s_x, s_y = episode.support_im, episode.support_y
        shared = dict(zip(keys, theta))

        def support_loss(p, step):
            return task_cross_entropy(apply_fn(p, s_x), s_y).sum()

        phi = adapt(per_task(shared, keys, B), support_loss, n_steps,
                    step_size, differentiable=False)
        logits = apply_fn(phi, episode.query_im)
        losses = task_cross_entropy(logits, episode.query_y)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        accs = (preds == episode.query_y).to(torch.float32).mean(dim=-1)
        ctx.mark_non_differentiable(accs, preds)
        ctx.deltas = [shared[k].unsqueeze(0) - phi[k] for k in keys]
        return losses, accs, preds

    @staticmethod
    def backward(ctx, g_loss, _g_acc, _g_preds):
        # the metric outputs carry no cotangent (JAX's is symbolic zero)
        grads = [(d * g_loss.view((-1,) + (1,) * (d.dim() - 1))).sum(0)
                 for d in ctx.deltas]
        return (None, None, None, None, None, *grads)


def reptile_episode_loss(apply_fn: Callable, params: Params,
                         episode: Episode, *, n_steps: int,
                         step_size: float):
    """Mean query loss over the meta-batch; its "gradient" is the Reptile
    pseudo-gradient ``mean_t(θ − φ_t)``. Same contract as
    :func:`inner_loop.maml_episode_loss`: ``(loss, {"acc", "preds"})``."""
    keys = list(params)
    losses, accs, preds = _ReptileTasks.apply(
        apply_fn, episode, n_steps, step_size, keys,
        *(params[k] for k in keys))
    return losses.mean(), {"acc": accs.mean(), "preds": preds}
