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

Two wrappers extend them, as in the JAX package:

- :func:`params_ema` (``--tpu_ema``), chained after the optimizer by
  :func:`chain`, keeps an exponential moving average of the post-update
  params in the optimizer state (``{"ema": params}``), where
  :func:`find_ema` finds it;
- :func:`apply_if_finite` (``--tpu_skip_nonfinite``) is optax's
  ``apply_if_finite``: a step whose gradients hold a NaN or an Inf updates
  nothing (zero updates, the inner state kept), and is counted.

States are nested dicts of tensors (a chain's links under ``"0"``,
``"1"``, ...), so checkpoints save and restore them as they are. Adam's
update count is a Python int, or a 0-d int32 tensor under
:func:`apply_if_finite`, whose choice between an update and none stays on
the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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
    update number ``step`` (counted from 0). A tensor step gives a 0-d
    fp32 tensor, computed on its device as optax computes it."""
    def schedule(step):
        if torch.is_tensor(step):
            t = step.to(torch.float32)
            warm = t / max(num_warmup_steps, 1)
            denom = max(num_training_steps - num_warmup_steps, 1)
            decay = torch.clamp((num_training_steps - t) / denom, min=0.0)
            return lr * torch.where(t < num_warmup_steps, warm, decay)
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
        if torch.is_tensor(count):
            c1, c2 = (1.0 - torch.pow(
                torch.tensor(b, dtype=torch.float32, device=count.device),
                count.to(torch.float32)) for b in (b1, b2))
        else:
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


def chain(*links: Optimizer) -> Optimizer:
    """optax's ``chain``: each link updates the updates of the one before;
    the state is ``{"0": state0, "1": state1, ...}``."""
    def init(params):
        return {str(i): link.init(params) for i, link in enumerate(links)}

    def update(grads, state, params):
        new = {}
        for i, link in enumerate(links):
            grads, new[str(i)] = link.update(grads, state[str(i)], params)
        return grads, new

    return Optimizer(init, update)


def params_ema(decay: float) -> Optimizer:
    """An exponential moving average of the POST-update params, chained
    after the optimizer (``chain(opt, params_ema(d))``): ``update`` sees
    the final updates and the pre-update params, and the EMA tracks
    ``decay·e + (1−decay)·(p + u)``, in the JAX package's order. The
    updates pass through unchanged. Evaluation and checkpoint selection
    read the EMA through :func:`find_ema` (``train/loop.py:eval_view``)
    while training goes on with the raw params."""
    def init(params):
        return {"ema": dict(params)}

    def update(updates, state, params):
        new_p = apply_updates(params, updates)
        return updates, {"ema": {k: decay * e + (1.0 - decay) * new_p[k]
                                 for k, e in state["ema"].items()}}

    return Optimizer(init, update)


def find_ema(opt_state) -> Optional[Tree]:
    """The EMA of a :func:`params_ema` state inside a (chained, wrapped)
    optimizer state, or None."""
    if isinstance(opt_state, dict):
        if set(opt_state) == {"ema"}:
            return opt_state["ema"]
        children = tuple(opt_state.values())
    elif isinstance(opt_state, (tuple, list)):
        children = tuple(opt_state)
    else:
        return None
    for child in children:
        found = find_ema(child)
        if found is not None:
            return found
    return None


_INT32_MAX = 2 ** 31 - 1


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, saturating at the int32 maximum (optax's
    ``numerics.safe_increment``)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _on_device(state, device: torch.device):
    """``state`` with its Python ints (Adam's count) as 0-d int32 tensors
    on ``device``."""
    if isinstance(state, dict):
        return {k: _on_device(v, device) for k, v in state.items()}
    if isinstance(state, int) and not isinstance(state, bool):
        return torch.tensor(state, dtype=torch.int32, device=device)
    return state


def _select(ok: torch.Tensor, new, old):
    """``new`` where the 0-d bool ``ok`` holds, else ``old``, leaf by
    leaf, on the device."""
    if isinstance(new, dict):
        return {k: _select(ok, v, old[k]) for k, v in new.items()}
    if torch.is_tensor(new):
        return torch.where(ok, new, old)
    return new


def apply_if_finite(inner: Optimizer, max_consecutive_errors: int
                    ) -> Optimizer:
    """optax's ``apply_if_finite``: when a gradient holds a NaN or an Inf,
    the updates are zero and the inner state (with any EMA inside it)
    stays as it was. The state counts ``notfinite_count`` (consecutive
    non-finite steps), ``last_finite`` and ``total_notfinite``. Once
    ``notfinite_count`` exceeds ``max_consecutive_errors`` the update is
    applied anyway, as optax does: the non-finite values reach the
    params.

    The check and the choice are tensor ops on the params' device (one
    flag, ``torch.where`` on every leaf), so a step makes no host sync:
    the inner update always runs, and its result is kept or dropped."""
    def init(params):
        dev = next(iter(params.values())).device
        return {"notfinite_count": torch.zeros((), dtype=torch.int32,
                                               device=dev),
                "last_finite": torch.ones((), dtype=torch.bool, device=dev),
                "total_notfinite": torch.zeros((), dtype=torch.int32,
                                               device=dev),
                "inner_state": _on_device(inner.init(params), dev)}

    def update(grads, state, params):
        isfinite = torch.stack([torch.isfinite(g).all()
                                for g in grads.values()]).all()
        notfinite = torch.where(isfinite, torch.zeros_like(
            state["notfinite_count"]), _safe_increment(
                state["notfinite_count"]))
        updates, inner_state = inner.update(grads, state["inner_state"],
                                            params)
        ok = isfinite | (notfinite > max_consecutive_errors)
        updates = {k: torch.where(ok, u, torch.zeros_like(u))
                   for k, u in updates.items()}
        return updates, {
            "notfinite_count": notfinite, "last_finite": isfinite,
            "total_notfinite": torch.where(
                isfinite, state["total_notfinite"],
                _safe_increment(state["total_notfinite"])),
            "inner_state": _select(ok, inner_state, state["inner_state"])}

    return Optimizer(init, update)
