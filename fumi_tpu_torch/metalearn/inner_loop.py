"""The inner-loop meta-gradient engine.

The counterpart of ``fumi_tpu/metalearn/inner_loop.py``'s
``sgd_inner_update``, ``head_only_mask``, ``maml_episode_loss`` and
``fumi_episode_loss``.

- The B tasks of a meta-batch are a leading axis on per-task weights,
  ``expand``ed from the shared params (the JAX package ``vmap``s one
  task's program). The support loss summed over tasks gives each task its
  own inner gradient, taken with respect to the expanded per-task tensors
  (not the shared leaves, which would sum the tasks' gradients).
- One inner SGD step is ``torch.autograd.grad`` and the update, in a Python
  loop over the steps (the JAX package's ``lax.scan``). With
  ``create_graph=True`` the outer gradient differentiates through every
  step (second order); ``first_order`` drops the inner gradients from the
  graph, as ``stop_gradient`` does.
- ``differentiable=False`` runs the loop with no outer graph at all (eval:
  each step detaches, so nothing is retained across the steps).
- ``adapt_mask`` (ANIL, ``--tpu_adapt_params head``) restricts the inner
  updates to the marked leaves; only their inner gradients are taken.

- ``remat`` (``--tpu_remat``, ``train/steps.py:remat_of``) checkpoints
  each differentiable inner step with ``torch.utils.checkpoint``: the
  outer backward recomputes the step's forward and its inner gradient
  instead of storing them. It changes memory, never the numbers (a
  generator the step draws dropout masks from is replayed). None (auto)
  checkpoints horizons of ``REMAT_THRESHOLD`` steps or more; the JAX
  package's ``"save_convs"`` (checkpoint the step but keep the conv
  outputs) is whole-step checkpointing here, because torch's selective
  checkpointing refuses a region whose graph is differentiated twice
  (the inner ``autograd.grad`` and the outer backward), which is what a
  second-order step is. A checkpointed step's inner gradient unpacks what
  its forward saved, so torch builds the support forward twice in the
  step (:func:`_replaying`). Each recompute of a step inside the outer
  backward runs inside a span ``inner.recompute`` and ends in the memory
  counter of that name (``utils/profiling.py``), the step's graph rebuilt
  beside what the outer backward still holds. Both are inert without a
  profiler.

- :func:`recording` keeps, while it is open, each :func:`adapt` call's
  per-task states θ_0 … θ_n and the support loss at θ_0 … θ_{n−1}, all
  detached (an :class:`InnerRecord` each), so that a caller can check an
  inner step on its own from the program's state. It records in the
  forward pass only (a step that ``checkpoint`` recomputes adds nothing),
  launches nothing on the device and changes no number; closed, it costs
  :func:`adapt` one test of a module global.

The meta-gradient variants that do not differentiate through the loop are
``metalearn/reptile.py`` and ``metalearn/implicit.py``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.utils.profiling import count_memory, span

Params = Dict[str, torch.Tensor]
Mask = Optional[Dict[str, bool]]
Remat = Union[None, bool, str]

# adaptation horizons at or above this checkpoint their inner steps
REMAT_THRESHOLD = 16


class InnerRecord(NamedTuple):
    """One :func:`adapt` call as :func:`recording` keeps it: ``theta`` the
    per-task states θ_0 … θ_n (leaves with the leading task axis, as
    :func:`adapt` holds them), ``loss`` the support loss at θ_0 …
    θ_{n−1} as ``support_loss`` returned it (summed over the tasks); every
    tensor detached, none copied."""
    theta: List[Params]
    loss: List[torch.Tensor]


# the open recorder's list of InnerRecords; None while none is open
_RECORDS: Optional[List[InnerRecord]] = None


@contextlib.contextmanager
def recording():
    """Keep every :func:`adapt` call made inside the block as an
    :class:`InnerRecord`; yields the list they are appended to, in call
    order. The records hold the states, so they live as long as the
    list. An enclosing recorder is set aside inside the block and put
    back after it."""
    global _RECORDS
    outer, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = outer


def _detached(theta: Params) -> Params:
    return {k: v.detach() for k, v in theta.items()}


def remat_active(remat: Remat, n_steps: int) -> bool:
    """Whether ``remat`` checkpoints a differentiable ``n_steps`` loop:
    None (auto) at long horizons, ``"save_convs"`` always (as whole-step
    checkpointing, see the module docstring), a bool as given."""
    if remat == "save_convs":
        return True
    if remat is None:
        return n_steps >= REMAT_THRESHOLD
    return bool(remat)


def _replaying(fn: Callable, gen: Optional[torch.Generator]) -> Callable:
    """``fn`` for ``checkpoint``. Its first call is the step's forward.
    Torch calls it again wherever autograd unpacks what the step saved:
    inside the first call, where the step's own inner gradient needs the
    support forward that ``checkpoint`` kept no tensor of (torch builds it
    again and stops there), and inside the outer backward, the recompute
    proper, which runs inside a span ``inner.recompute`` that ends in the
    memory counter of that name. Every later call sees ``gen`` as the
    first call saw it and leaves ``gen`` as it found it, so the dropout
    masks drawn again are the same masks."""
    state = None if gen is None else gen.get_state()
    calls = []  # "first" while the first call runs, "done" after it

    def recompute(*args):
        with span("inner.recompute"):
            try:
                return fn(*args)
            finally:
                count_memory("inner.recompute")

    def run(*args):
        if not calls:
            calls.append("first")
            try:
                return fn(*args)
            finally:
                calls[0] = "done"
        body = recompute if calls[0] == "done" else fn
        if gen is None:
            return body(*args)
        after = gen.get_state()
        gen.set_state(state)
        try:
            return body(*args)
        finally:
            gen.set_state(after)
    return run


def sgd_inner_update(params: Params, grads: Params, step_size: float,
                     mask: Mask = None) -> Params:
    """θ' = θ − α·∇ℓ, leaf by leaf. ``mask`` (ANIL) restricts the update to
    the leaves it marks True; the others keep their value and need no
    gradient."""
    return {k: p - step_size * grads[k] if mask is None or mask.get(k)
            else p for k, p in params.items()}


def head_only_mask(params: Params) -> Dict[str, bool]:
    """ANIL's adapt-mask: True only on the network's head, the MLP's last
    layer ``net.lin_final`` or a raw-image backbone's ``head``."""
    head = "net.lin_final." if "net.lin_final.weight" in params else "head."
    if head + "weight" not in params:
        raise ValueError(f"no head in params {sorted(params)[:4]}...")
    return {k: k.startswith(head) for k in params}


def task_cross_entropy(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """(B, M, N) logits, (B, M) targets -> (B,) per-task mean CE."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long().unsqueeze(-1))[..., 0] \
        .mean(dim=-1)


def _accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Query accuracy over every task and query."""
    preds = torch.argmax(logits, dim=-1)
    return (preds == targets).to(torch.float32).mean()


def per_task(params: Params, keys, B: int) -> Params:
    """Per-task views (B, ...) of the shared params named in ``keys``."""
    return {k: params[k].expand((B,) + tuple(params[k].shape)) for k in keys}


def adapt(theta: Params, support_loss: Callable[[Params, int], torch.Tensor],
          n_steps: int, step_size: float, *, differentiable: bool,
          first_order: bool = False, mask: Mask = None, remat: Remat = False,
          gen: Optional[torch.Generator] = None) -> Params:
    """``n_steps`` of θ ← θ − α·∇ support_loss(θ, step) on the leaves
    ``mask`` marks (all without one).

    ``support_loss`` returns the per-task support losses summed over the
    tasks. ``differentiable`` keeps the outer graph (second order unless
    ``first_order``), each step checkpointed where :func:`remat_active`
    says (``gen``: the generator the loss draws from); otherwise every
    step detaches."""
    adapted = [k for k in theta if mask is None or mask.get(k)]
    keys = list(theta)
    remat = differentiable and remat_active(remat, n_steps)
    rec = None
    if _RECORDS is not None:
        rec = InnerRecord(theta=[], loss=[])
        _RECORDS.append(rec)
    for step in range(n_steps):
        with span("inner.step"):
            if rec is not None:
                rec.theta.append(_detached(theta))
            if differentiable:
                def one(*vals, step=step):
                    th = dict(zip(keys, vals))
                    loss = support_loss(th, step)
                    # the forward's loss only: checkpoint's recompute of
                    # the step finds it kept
                    if rec is not None and len(rec.loss) == step:
                        rec.loss.append(loss.detach())
                    grads = torch.autograd.grad(loss,
                                                [th[k] for k in adapted],
                                                create_graph=not first_order)
                    th = sgd_inner_update(th, dict(zip(adapted, grads)),
                                          step_size, mask)
                    return tuple(th[k] for k in keys)
                vals = tuple(theta[k] for k in keys)
                vals = (checkpoint(_replaying(one, gen), *vals,
                                   use_reentrant=False) if remat
                        else one(*vals))
                theta = dict(zip(keys, vals))
                continue
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(k in adapted)
                          for k, v in theta.items()}
                loss = support_loss(leaves, step)
                if rec is not None:
                    rec.loss.append(loss.detach())
                grads = torch.autograd.grad(loss,
                                            [leaves[k] for k in adapted])
            with torch.no_grad():
                theta = sgd_inner_update(
                    {k: v.detach() for k, v in leaves.items()},
                    dict(zip(adapted, grads)), step_size, mask)
    if rec is not None:
        rec.theta.append(_detached(theta))
    return theta


def _outer(q_logits: torch.Tensor, query_y: torch.Tensor):
    """(mean query loss over tasks, {"acc", "preds"})."""
    loss = task_cross_entropy(q_logits, query_y).mean()
    detached = q_logits.detach()
    preds = torch.argmax(detached, dim=-1).to(torch.int32)
    return loss, {"acc": _accuracy(detached, query_y), "preds": preds}


# ---------------------------------------------------------------------------
# MAML
# ---------------------------------------------------------------------------

def maml_episode_loss(apply_fn: Callable, params: Params, episode: Episode,
                      *, n_steps: int, step_size: float, first_order: bool,
                      differentiable: bool = True, adapt_mask: Mask = None,
                      remat: Remat = None):
    """Mean outer loss over the meta-batch.

    Each task adapts a private copy of every param for ``n_steps`` inner
    SGD steps on its support set, then contributes the query
    cross-entropy; ``adapt_mask`` restricts the inner updates to the leaves
    it marks (ANIL). Returns ``(outer_loss, {"acc", "preds"})``; the loss
    is differentiable w.r.t. ``params`` (second order unless
    ``first_order``) when ``differentiable``; ``remat`` as in
    :func:`adapt`."""
    B = episode.support_im.shape[0]
    s_x, s_y = episode.support_im, episode.support_y

    def support_loss(theta, step):
        return task_cross_entropy(apply_fn(theta, s_x), s_y).sum()

    theta = adapt(per_task(params, params.keys(), B), support_loss, n_steps,
                  step_size, differentiable=differentiable,
                  first_order=first_order, mask=adapt_mask, remat=remat)
    outer = differentiable and torch.is_grad_enabled()
    with torch.set_grad_enabled(outer), span("inner.query"):
        return _outer(apply_fn(theta, episode.query_im), episode.query_y)


# ---------------------------------------------------------------------------
# FuMI
# ---------------------------------------------------------------------------

def fumi_episode_loss(model, params: Params, episode: Episode, *,
                      n_steps: int, step_size: float,
                      gen: Optional[torch.Generator], train: bool,
                      differentiable: bool = True, remat: Remat = None):
    """Mean outer loss over the meta-batch.

    Per task: the hypernetwork emits the generated head from the
    per-class support text; the inner loop then jointly adapts (im_net,
    generated head) by SGD on the support cross-entropy, always second
    order when ``differentiable`` (``--first_order`` does not apply to
    FuMI). Both gradients are taken at the same pre-update point: one
    joint ``autograd.grad`` per step. ``gen`` draws the dropout masks
    (``train``) and the ``rand`` text encoder's noise."""
    B = episode.support_im.shape[0]
    s_x, s_y = episode.support_im, episode.support_y
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        hyper0 = model.get_hyper_params(params, episode.support_text, s_y,
                                        gen)
    theta = per_task(params, [k for k in params if k.startswith("im_net.")],
                     B)
    theta["hyper"] = hyper0

    def support_loss(theta, step):
        logits = model.im_forward(theta, theta["hyper"], s_x, train=train,
                                  gen=gen)
        return task_cross_entropy(logits, s_y).sum()

    theta = adapt(theta, support_loss, n_steps, step_size,
                  differentiable=differentiable, remat=remat, gen=gen)
    outer = differentiable and torch.is_grad_enabled()
    with torch.set_grad_enabled(outer), span("inner.query"):
        q_logits = model.im_forward(theta, theta["hyper"], episode.query_im,
                                    train=train, gen=gen)
        return _outer(q_logits, episode.query_y)
