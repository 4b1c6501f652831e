"""iMAML — implicit meta-gradients (Rajeswaran et al., arXiv:1909.04630).

The counterpart of ``fumi_tpu/metalearn/implicit.py``. Each task adapts on
the PROXIMAL objective

    φ* = argmin_φ  L_s(φ) + (λ/2)·‖φ − θ‖²

with no graph kept, and the meta-gradient comes from the implicit function
theorem at the solution:

    dL_q/dθ = (I + (1/λ)·H_s(φ*))⁻¹ · dL_q/dφ*

solved matrix-free by conjugate gradient on Hessian-vector products, so its
cost does not grow with ``n_steps``.

- The B tasks are an explicit leading axis (``inner_loop.per_task``): the
  support loss summed over the tasks is block-diagonal in them, so one
  double ``autograd.grad`` gives every task's own HVP at once.
- :func:`batched_cg` is ``jax.scipy.sparse.linalg.cg`` per task: ``x0=0``,
  ``r=b``, ``p=r``, then ``alpha = γ/⟨p, Ap⟩`` and so on. A task stops when
  ‖r‖² ≤ max(tol²‖b‖², atol²) (tol=1e-5, atol=0) or at ``maxiter``; the
  loop runs ``maxiter`` iterations over the B tasks at once, and a task
  that has stopped keeps its state (``torch.where``), as JAX's while loop
  does under ``vmap``. There is no host sync in the loop.
- The meta-gradient reaches the params through a ``torch.autograd.Function``
  (the JAX package's ``custom_vjp``) whose inputs are the initial point z0
  of the solve. For MAML z0 is θ itself. For FuMI z0 is (θ_im, the
  generated head): the Function hands the head block's cotangent to the
  hypernetwork's graph, which carries it on into θ (and into the text
  encoder only under ``--fine_tune``), and the im_net block goes to θ_im
  unchanged. Dropout is off in the FuMI solve and its query forward.

Select with ``--tpu_meta_grad imaml`` (MAML and FuMI; λ and the CG budget
via ``--tpu_imaml_lambda`` / ``--tpu_imaml_cg_iters``). An extension: the
reference implements only explicit MAML (ref: fumi/models/maml.py:134-193).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from fumi_tpu_torch.core.episode import Episode
from fumi_tpu_torch.metalearn.inner_loop import (Params, adapt, per_task,
                                                 task_cross_entropy)


# set while a step of the 2-D engine runs (parallel/pjit_engine.py:
# mp_context): sums per-leaf inner products, those of the leaves that hold
# only their input columns over the mp row; None otherwise
VDOT_SUM = None


def _vdot(a: Params, b: Params) -> torch.Tensor:
    """Per-task inner product over every leaf: (B,)."""
    if VDOT_SUM is not None:
        return VDOT_SUM({k: (a[k] * b[k]).flatten(1).sum(1) for k in a})
    return sum((a[k] * b[k]).flatten(1).sum(1) for k in a)


def _per_task(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) per-task value shaped to broadcast against ``like``."""
    return s.view((-1,) + (1,) * (like.dim() - 1))


def batched_cg(operator: Callable[[Params], Params], b: Params,
               maxiter: int, tol: float = 1e-5, atol: float = 0.0
               ) -> Tuple[Params, torch.Tensor]:
    """Solve ``operator(x) = b`` for each of the B tasks by conjugate
    gradient. Returns ``(x, iters)``: ``iters`` (B,) is the iteration at
    which each task stopped."""
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=atol * atol)
    x = {k: torch.zeros_like(v) for k, v in b.items()}
    r = dict(b)
    p = dict(r)
    gamma = _vdot(r, r)
    iters = torch.zeros_like(gamma, dtype=torch.int32)
    for _ in range(maxiter):
        active = gamma > atol2
        ap = operator(p)
        alpha = gamma / _vdot(p, ap)
        x_ = {k: x[k] + _per_task(alpha, x[k]) * p[k] for k in x}
        r_ = {k: r[k] - _per_task(alpha, r[k]) * ap[k] for k in r}
        gamma_ = _vdot(r_, r_)
        beta = gamma_ / gamma
        p_ = {k: r_[k] + _per_task(beta, p[k]) * p[k] for k in p}

        def keep(new, old):
            return torch.where(_per_task(active, old), new, old)
        x = {k: keep(x_[k], x[k]) for k in x}
        r = {k: keep(r_[k], r[k]) for k in r}
        p = {k: keep(p_[k], p[k]) for k in p}
        gamma = keep(gamma_, gamma)
        iters = iters + active.to(torch.int32)
    return x, iters


def _proximal(theta0: Params, support_ce: Callable[[Params], torch.Tensor],
              n_steps: int, step_size: float, lam: float) -> Params:
    """GD from the per-task ``theta0`` on the summed per-task proximal
    objective ``support_ce(p) + (λ/2)·‖p − θ0‖²``; no graph kept."""
    theta0 = {k: v.detach() for k, v in theta0.items()}

    def prox_loss(p, step):
        sq = sum(torch.sum((p[k] - theta0[k]) ** 2) for k in p)
        return support_ce(p) + 0.5 * lam * sq

    return adapt(theta0, prox_loss, n_steps, step_size, differentiable=False)


class _ImplicitTask(NamedTuple):
    """One meta-batch's pieces for :class:`_ImplicitTasks`: the proximal
    solve, the query logits and the support loss whose Hessian the CG
    inverts, each on per-task (B, ...) leaves."""
    solve: Callable[[Params], Params]
    query_logits: Callable[[Params], torch.Tensor]
    support_ce: Callable[[Params], torch.Tensor]
    query_y: torch.Tensor
    lam: float
    cg_iters: int

    def query_ce(self, phi: Params) -> torch.Tensor:
        return task_cross_entropy(self.query_logits(phi), self.query_y).sum()


class _ImplicitTasks(torch.autograd.Function):
    """``(losses (B,), accs (B,), preds (B, M))`` at the proximal solutions
    from the initial point z0; the backward is the implicit gradient onto
    z0. A z0 leaf without the task axis is shared by the B tasks and gets
    their summed cotangent."""

    @staticmethod
    def forward(ctx, task, keys, *z0):
        z0 = dict(zip(keys, z0))
        phi = task.solve(z0)
        logits = task.query_logits(phi)
        losses = task_cross_entropy(logits, task.query_y)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        accs = (preds == task.query_y).to(torch.float32).mean(dim=-1)
        ctx.mark_non_differentiable(accs, preds)
        ctx.task, ctx.keys, ctx.phi = task, keys, phi
        ctx.shared = [z0[k].dim() < phi[k].dim() for k in keys]
        return losses, accs, preds

    @staticmethod
    def backward(ctx, g_loss, _g_acc, _g_preds):
        task, keys = ctx.task, ctx.keys
        x = implicit_solution(task, ctx.phi)[0]
        grads = []
        for k, shared in zip(keys, ctx.shared):
            g = x[k] * _per_task(g_loss, x[k])
            grads.append(g.sum(0) if shared else g)
        return (None, None, *grads)


def implicit_solution(task: _ImplicitTask, phi: Params
                      ) -> Tuple[Params, torch.Tensor]:
    """``(I + H_s(φ)/λ)⁻¹ · ∇L_q(φ)`` for every task by :func:`batched_cg`,
    and each task's stopping iteration."""
    keys = list(phi)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_() for k, v in phi.items()}
        v = dict(zip(keys, torch.autograd.grad(task.query_ce(leaves),
                                               list(leaves.values()))))
        grad_s = torch.autograd.grad(task.support_ce(leaves),
                                     list(leaves.values()), create_graph=True)

        def operator(x: Params) -> Params:
            hvp = torch.autograd.grad(grad_s, list(leaves.values()),
                                      grad_outputs=[x[k] for k in keys],
                                      retain_graph=True, allow_unused=True)
            return {k: x[k] if h is None else x[k] + h / task.lam
                    for k, h in zip(keys, hvp)}

        return batched_cg(operator, v, task.cg_iters)


def _episode_out(task: _ImplicitTask, z0: Dict[str, torch.Tensor]):
    keys = list(z0)
    losses, accs, preds = _ImplicitTasks.apply(task, keys,
                                               *(z0[k] for k in keys))
    return losses.mean(), {"acc": accs.mean(), "preds": preds}


# ---------------------------------------------------------------------------
# MAML
# ---------------------------------------------------------------------------

def proximal_adapt(apply_fn: Callable, theta: Params, s_x: torch.Tensor,
                   s_y: torch.Tensor, *, n_steps: int, step_size: float,
                   lam: float) -> Params:
    """GD on the proximal objective from per-task ``theta`` (B, ...);
    pure forward, no graph kept."""
    return _proximal(theta, lambda p: task_cross_entropy(
        apply_fn(p, s_x), s_y).sum(), n_steps, step_size, lam)


def maml_implicit_task(apply_fn: Callable, episode: Episode, *, n_steps: int,
                       step_size: float, lam: float, cg_iters: int
                       ) -> _ImplicitTask:
    """The iMAML-MAML pieces of one meta-batch, z0 = the shared params."""
    B = episode.support_im.shape[0]
    s_x, s_y = episode.support_im, episode.support_y

    def solve(theta):
        return proximal_adapt(apply_fn, per_task(theta, theta.keys(), B),
                              s_x, s_y, n_steps=n_steps,
                              step_size=step_size, lam=lam)

    return _ImplicitTask(
        solve, lambda phi: apply_fn(phi, episode.query_im),
        lambda phi: task_cross_entropy(apply_fn(phi, s_x), s_y).sum(),
        episode.query_y, lam, cg_iters)


def imaml_episode_loss(apply_fn: Callable, params: Params, episode: Episode,
                       *, n_steps: int, step_size: float, lam: float = 2.0,
                       cg_iters: int = 5):
    """Mean outer loss over the meta-batch with implicit meta-gradients.

    Same contract as :func:`inner_loop.maml_episode_loss` — ``(loss,
    {"acc", "preds"})``, the loss differentiable in ``params`` — but its
    gradient is the iMAML implicit gradient (CG on HVPs at the adapted
    point) rather than backprop through the inner loop."""
    return _episode_out(maml_implicit_task(
        apply_fn, episode, n_steps=n_steps, step_size=step_size, lam=lam,
        cg_iters=cg_iters), dict(params))


# ---------------------------------------------------------------------------
# FuMI: implicit gradients through the hypernetwork dual update
# ---------------------------------------------------------------------------

def fumi_proximal_adapt(model, z0: Params, s_x: torch.Tensor,
                        s_y: torch.Tensor, *, n_steps: int, step_size: float,
                        lam: float) -> Params:
    """Proximal GD on FuMI's joint per-task (im_net, generated head) vector,
    ``z0`` holding the ``im_net.*`` leaves and the head under ``"hyper"``,
    each (B, ...). THE inner solve of the iMAML-FuMI engine, shared with
    serving so the two cannot drift. Pure forward; dropout off."""
    return _proximal(z0, lambda z: task_cross_entropy(
        model.im_forward(z, z["hyper"], s_x, train=False), s_y).sum(),
        n_steps, step_size, lam)


def imaml_fumi_episode_loss(model, params: Params, episode: Episode, *,
                            n_steps: int, step_size: float,
                            gen, lam: float = 2.0, cg_iters: int = 5):
    """FuMI with implicit meta-gradients. Same contract as
    :func:`inner_loop.fumi_episode_loss` (minus ``train``: the inner solve
    is deterministic). ``gen`` draws the ``rand`` text encoder's noise."""
    B = episode.support_im.shape[0]
    s_x, s_y = episode.support_im, episode.support_y
    im_keys = [k for k in params if k.startswith("im_net.")]
    z0 = {k: params[k] for k in im_keys}
    z0["hyper"] = model.get_hyper_params(params, episode.support_text, s_y,
                                         gen)

    def solve(z):
        start = per_task(z, im_keys, B)
        start["hyper"] = z["hyper"]
        return fumi_proximal_adapt(model, start, s_x, s_y, n_steps=n_steps,
                                   step_size=step_size, lam=lam)

    def logits(z, x):
        return model.im_forward(z, z["hyper"], x, train=False)

    task = _ImplicitTask(
        solve, lambda z: logits(z, episode.query_im),
        lambda z: task_cross_entropy(logits(z, s_x), s_y).sum(),
        episode.query_y, lam, cg_iters)
    return _episode_out(task, z0)
