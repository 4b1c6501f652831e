"""Optimizers as functional updates on state dicts.

The counterpart of ``fumi_tpu/train/optim.py``, which builds optax
transforms matching the reference's torch/HF optimizers update for update.
An :class:`Optimizer` has optax's shape: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; :func:`apply_updates`
adds the updates. Params, grads and updates are flat state dicts of
tensors; nothing is updated in place.

- ``adam``: torch.optim.Adam with coupled L2 ``weight_decay`` (``wd·θ``
  added to the gradient BEFORE the moments), betas (0.9, 0.999), eps 1e-8,
  bias correction.
- ``SGD``: momentum + coupled L2; the first momentum buffer is the raw
  gradient.
- ``adamw``: transformers' AdamW, decoupled decay with HF defaults
  (weight_decay 0.0, eps 1e-6).
- ``adamw_lin_schedule``: HF AdamW + ``get_linear_schedule_with_warmup``;
  only AM3 steps the schedule (``schedule_active``), MAML/FuMI keep the
  constant lr.

``params_ema`` (``--tpu_ema``) and ``apply_if_finite``
(``--tpu_skip_nonfinite``) are ROADMAP.md Queue 1, item 10.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
State = Dict[str, Any]


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``."""
    init: Callable[[Tree], State]
    update: Callable[[Tree, State, Tree], Tuple[Tree, State]]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k] for k, p in params.items()}


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def linear_warmup_schedule(lr: float, num_warmup_steps: int,
                           num_training_steps: int) -> Callable[[int], float]:
    """transformers.get_linear_schedule_with_warmup semantics: the lr of
    update number ``step`` (counted from 0)."""
    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return lr * step / max(num_warmup_steps, 1)
        denom = max(num_training_steps - num_warmup_steps, 1)
        return lr * max(0.0, (num_training_steps - step) / denom)
    return schedule


def _adam(lr, b1: float, b2: float, eps: float, weight_decay: float,
          decoupled: bool) -> Optimizer:
    """Adam with bias correction. ``lr`` is a float or a schedule of the
    update count. Coupled L2 adds ``wd·θ`` to the gradient; decoupled
    (AdamW) adds it to the normalised update."""
    sched = lr if callable(lr) else (lambda count: lr)

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        # bias corrections in fp32, as optax computes them (1 - 0.999 is
        # 1.3e-5 off in fp32, which moves the update by 6e-6 relative)
        c1, c2 = (np.float32(1) - np.float32(b) ** np.float32(count)
                  for b in (b1, b2))
        step = sched(state["count"])
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            if weight_decay and not decoupled:
                g = g + weight_decay * params[k]
            mu[k] = (1.0 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1.0 - b2) * g * g + b2 * state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
            if weight_decay and decoupled:
                u = u + weight_decay * params[k]
            updates[k] = -step * u
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _sgd(lr: float, momentum: float, weight_decay: float) -> Optimizer:
    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state, params):
        trace, updates = {}, {}
        for k, g in grads.items():
            g = g + weight_decay * params[k]
            trace[k] = g + momentum * state["trace"][k]
            updates[k] = -lr * trace[k]
        return updates, {"trace": trace}

    return Optimizer(init, update)


def zero_updates_for_key(inner: Optimizer, key: str) -> Optimizer:
    """Wrap ``inner`` so the updates of one top-level component (the state
    dict entries named ``<key>.*``) are zero: torch optimizers SKIP params
    whose grad is None (frozen text encoders, the ``rand`` encoder's unused
    Linear), so coupled L2 must not decay them. The state is ``inner``'s."""
    prefix = key + "."

    def update(grads, state, params):
        updates, state = inner.update(grads, state, params)
        return {k: torch.zeros_like(u) if k.startswith(prefix) else u
                for k, u in updates.items()}, state

    return Optimizer(inner.init, update)


def init_optim(optim: str, lr: float, weight_decay: float = 5e-4,
               momentum: float = 0.9, num_warmup_steps: int = 10,
               epochs: int = 50000, schedule_active: bool = True
               ) -> Optimizer:
    """The optimizer for a reference optimizer name."""
    if optim == "adam":
        return _adam(lr, 0.9, 0.999, 1e-8, weight_decay, decoupled=False)
    if optim == "SGD":
        return _sgd(lr, momentum, weight_decay)
    if optim == "adamw":
        return _adam(lr, 0.9, 0.999, 1e-6, 0.0, decoupled=True)
    if optim == "adamw_lin_schedule":
        if schedule_active:
            lr = linear_warmup_schedule(lr, num_warmup_steps, epochs)
        return _adam(lr, 0.9, 0.999, 1e-6, 0.0, decoupled=True)
    raise NotImplementedError(f"optimizer {optim!r}")


def params_ema(decay: float) -> Optimizer:
    raise NotImplementedError(
        "--tpu_ema (params_ema) is not ported yet (ROADMAP.md Queue 1, "
        "item 10: training extensions)")


def apply_if_finite(inner: Optimizer, max_consecutive_errors: int
                    ) -> Optimizer:
    raise NotImplementedError(
        "--tpu_skip_nonfinite (apply_if_finite) is not ported yet "
        "(ROADMAP.md Queue 1, item 10: training extensions)")
