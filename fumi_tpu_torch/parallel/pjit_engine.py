"""The 2-D (dp x mp) engine: episodes over dp, wide weights over mp.

The counterpart of ``fumi_tpu/parallel/pjit_engine.py``. There XLA places
the shardings ``param_pspecs`` declares and inserts the collectives; here
each rank holds its slices and the collectives are written out:

- :func:`param_pspecs` keeps the JAX rule: a 2-D (out, in) weight with
  ``in >= MP_SHARD_MIN_DIM`` and ``in % mp == 0`` keeps only its
  input-column slice ``[mp_index · in/mp, (mp_index + 1) · in/mp)`` on
  each mp rank; everything else is replicated. Its optimizer state (Adam's
  moments, the EMA) is sliced with it.
- Such a weight is Megatron's row-parallel linear (:func:`row_parallel`,
  which ``models/layers.py:linear`` calls while a step of this engine
  runs): the input, replicated over the mp row, enters through "copy to
  mp" (identity forward, all-reduce backward), is sliced to the rank's
  columns, multiplied by the rank's weight slice, and the partial products
  leave through "reduce from mp" (all-reduce forward, identity backward);
  the bias is added after. Each one's backward calls the other's
  ``apply``, so the backward is itself differentiable: the inner loop's
  second-order meta-gradient runs through it. (``torch.distributed.nn``'s
  all-reduce would not do: its backward all-reduces again, which
  multiplies a replicated output's gradient by mp.)
- iMAML's conjugate gradients sum their inner products over every leaf:
  a sharded leaf's part is all-reduced over the mp row
  (``metalearn/implicit.py:VDOT_SUM``).
- A sharded leaf the model does not feed to ``layers.linear`` (a token
  encoder's embedding table and its LSTM's recurrent weights) enters the
  loss whole through "gather from mp" (an all-gather forward; backward the
  rank's slice of the gradient through "copy to mp").
- Episodes shard over dp as in ``parallel/engine.py``; the mp ranks of a
  dp shard draw the same tasks from the same generator. Gradients are
  all-reduced over the dp column; the per-component gradient norms sum the
  slices' squares over the mp row; ``--tpu_skip_nonfinite`` and
  ``--tpu_debug_nans`` decide on the whole gradient (one flag all-reduced
  over the grid), so the ranks never disagree.
- The drivers take and return whole params and optimizer states: they
  shard on entry and gather (``core/mesh.py:host_fetch``, one packed
  all-gather) at the end of each chunk, so the loop, its checkpoints and
  its evals see whole, replicated trees. Eval runs on the whole params,
  each dp shard on its tasks (``parallel/engine.py``): the fused kernels
  need whole weights.

``--tpu_grad_accum > 1`` stays refused with mp > 1, as the JAX package
refuses it (``core/config.py``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.mesh import (MP_AXIS, Mesh, all_gather_cat,
                                      all_reduce_, host_fetch, put_replicated)
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.metalearn import implicit
from fumi_tpu_torch.models import layers, text_encoders
from fumi_tpu_torch.parallel.engine import (_Engine, _MpHooks, _steps,
                                            chunked_eval, chunked_train)
from fumi_tpu_torch.train import optim
from fumi_tpu_torch.train.steps import (Family, FamilySteps, build_family,
                                        component_partition, make_opt,
                                        value_and_grad)

# weights whose *input* dim is at least this wide get sharded over mp
MP_SHARD_MIN_DIM = 256
SHARDED = (None, MP_AXIS)  # the JAX package's P(None, MP_AXIS)
REPLICATED = ()  # P()


def param_pspecs(params: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, Tuple]:
    """``{name: SHARDED | REPLICATED}``: 2-D (out, in) weights with a wide
    input dim shard it over mp; everything else is replicated."""
    mp = mesh.shape[MP_AXIS]

    def spec(leaf):
        shape = tuple(leaf.shape)
        if (len(shape) == 2 and shape[1] >= MP_SHARD_MIN_DIM
                and shape[1] % mp == 0):
            return SHARDED
        return REPLICATED
    return {k: spec(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the mp pair and the row-parallel linear
# ---------------------------------------------------------------------------

class _CopyToMP(torch.autograd.Function):
    """Identity forward; backward all-reduces over the mp row."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromMP.apply(g, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce (sum) over the mp row forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _CopyToMP.apply(g, ctx.group), None


class _GatherFromMP(torch.autograd.Function):
    """The whole leaf from its column slices (an all-gather) forward; the
    rank's columns of the gradient, through :class:`_CopyToMP`, backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return all_gather_cat(x, mesh.mp_group, dim=-1, gloo=mesh.gloo)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.mp_index * ctx.width
        g = _CopyToMP.apply(g, ctx.mesh.mp_group)
        return g[..., lo:lo + ctx.width], None


def row_parallel(mesh: Mesh) -> Callable:
    """``linear(w, b, x, compute_dtype)`` for a weight that holds this
    rank's input columns (``w.shape[-1] · mp == x.shape[-1]``)."""
    def linear(w, b, x, compute_dtype=None):
        width = w.shape[-1]
        if width * mesh.mp != x.shape[-1]:
            raise ValueError(f"row-parallel linear: input width "
                             f"{x.shape[-1]} is not {mesh.mp} x {width}")
        lo = mesh.mp_index * width
        x = _CopyToMP.apply(x, mesh.mp_group)[..., lo:lo + width]
        part = layers.matmul_f32acc(x, w.transpose(-1, -2), compute_dtype)
        return _ReduceFromMP.apply(part, mesh.mp_group) + b.unsqueeze(-2)
    return linear


def vdot_sum(mesh: Mesh, sharded) -> Callable:
    """iMAML's per-leaf inner products summed: the leaves in ``sharded``
    hold their input columns only, so their part is all-reduced over the
    mp row (``metalearn/implicit.py``'s conjugate gradients)."""
    def total(parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        local = [v for k, v in parts.items() if k in sharded]
        out = sum(v for k, v in parts.items() if k not in sharded)
        if local:
            out = out + _ReduceFromMP.apply(sum(local), mesh.mp_group)
        return out
    return total


@contextmanager
def mp_context(mesh: Mesh, sharded=()):
    """While active, ``layers.linear`` sends a weight that holds only its
    input columns through :func:`row_parallel`, and iMAML's inner products
    sum the ``sharded`` leaves over the mp row (:func:`vdot_sum`)."""
    old = layers.ROW_PARALLEL, implicit.VDOT_SUM
    layers.ROW_PARALLEL = row_parallel(mesh)
    implicit.VDOT_SUM = vdot_sum(mesh, frozenset(sharded))
    try:
        yield
    finally:
        layers.ROW_PARALLEL, implicit.VDOT_SUM = old


def _gathered(name: str) -> bool:
    """A leaf the models read other than through ``layers.linear``."""
    return name == text_encoders.EMBED or "weight_hh" in name


# ---------------------------------------------------------------------------
# the hooks of the 2-D engine
# ---------------------------------------------------------------------------

def _map_named(tree, fn, name=None):
    """``fn(key, tensor)`` on every tensor of a nested dict, ``key`` its
    innermost dict key (a param name in params and in optimizer states)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return fn(name, tree)
    return tree


class _Mp2dHooks(_MpHooks):
    def __init__(self, mesh: Mesh, params: Dict[str, torch.Tensor]):
        self.mesh = mesh
        specs = param_pspecs(params, mesh)
        self.full = {k: tuple(v.shape) for k, v in params.items()
                     if specs[k] == SHARDED}

    def _is_full(self, name, t) -> bool:
        return name in self.full and tuple(t.shape) == self.full[name]

    def _is_slice(self, name, t) -> bool:
        if name not in self.full:
            return False
        out, width = self.full[name]
        return tuple(t.shape) == (out, width // self.mesh.mp)

    def shard(self, tree):
        m = self.mesh

        def cut(name, t):
            if not self._is_full(name, t):
                return t
            w = t.shape[-1] // m.mp
            return t[..., m.mp_index * w:(m.mp_index + 1) * w].contiguous()
        return _map_named(tree, cut)

    def gather(self, tree):
        """One packed all-gather of every sliced leaf over the mp row."""
        m = self.mesh
        slices = []
        _map_named(tree, lambda n, t: slices.append(t)
                   if self._is_slice(n, t) else None)
        if not slices or m.mp_group is None:
            return tree
        flat = torch.cat([t.reshape(-1) for t in slices])
        ranks = host_fetch(flat, m, sharded=True).reshape(m.mp, -1)
        pieces, at = {}, 0
        for i, t in enumerate(slices):
            pieces[id(t)] = torch.cat(
                [r[at:at + t.numel()].reshape(t.shape) for r in ranks],
                dim=-1)
            at += t.numel()
        return _map_named(tree, lambda n, t: pieces.get(id(t), t))

    def grad_fn(self, family: Family, accum: int) -> Callable:
        if accum > 1:
            raise NotImplementedError(
                "--tpu_grad_accum > 1 is not wired into the 2-D (mp) "
                "engine — use --tpu_mesh_mp 1")
        mesh = self.mesh

        def prepare(leaves):
            return {k: _GatherFromMP.apply(v, mesh)
                    if _gathered(k) and self._is_slice(k, v) else v
                    for k, v in leaves.items()}

        def run(params, episode, gen):
            with mp_context(mesh, self.full):
                return value_and_grad(family, params, episode, gen,
                                      prepare=prepare)
        return run

    def finish_grads(self, family: Family, grads, skip_nonfinite: bool):
        """The whole gradient's per-component norms (the slices' squared
        sums all-reduced over the mp row, with a count of ranks that hold
        a non-finite entry); under ``--tpu_skip_nonfinite`` a non-finite
        entry on any rank makes every rank's gradient non-finite, so every
        rank skips the step."""
        names = list(grads)
        sq = [grads[k].to(torch.float32).square().sum() for k in names]
        bad = torch.stack([(~torch.isfinite(g)).any()
                           for g in grads.values()]).any()
        sliced = [i for i, k in enumerate(names)
                  if self._is_slice(k, grads[k])]
        flat = torch.stack([sq[i] for i in sliced] + [bad.float()])
        all_reduce_(flat, self.mesh.mp_group)
        for j, i in enumerate(sliced):
            sq[i] = flat[j]
        sqd = dict(zip(names, sq))
        per_layer = {f"grad_norm/{c}": torch.sqrt(sum(part.values()))
                     for c, part in component_partition(
                         sqd, family.name).items()}
        if skip_nonfinite:
            nan = torch.full((), float("nan"), device=flat.device)
            grads = {k: torch.where(flat[-1] > 0, nan, g)
                     for k, g in grads.items()}
        return grads, per_layer

    def any_nonfinite(self, tensors) -> bool:
        bad = torch.stack([(~torch.isfinite(t)).any()
                           for t in tensors]).float()
        flag = bad.max().reshape(1)
        all_reduce_(flag, self.mesh.group)
        return bool(flag.item() > 0)


def _engine(cfg: Config, family: Family, opt: optim.Optimizer, mesh: Mesh
            ) -> _Engine:
    return _Engine(cfg, family, opt, mesh, _Mp2dHooks(mesh, family.params))


def make_pjit_steps(cfg: Config, gen: torch.Generator, mesh: Mesh,
                    device: DeviceLike = None,
                    dictionary=None) -> FamilySteps:
    """Train and eval steps on a (dp, mp) mesh, with the contract of
    ``train/steps.py:make_steps`` (whole params in and out; rank 0's
    params broadcast to every rank)."""
    dev = resolve_device(device)
    family = build_family(cfg, gen, dictionary)
    family = family._replace(params=put_replicated(
        {k: v.to(dev) for k, v in family.params.items()}, mesh))
    return _steps(_engine(cfg, family, make_opt(cfg), mesh), family.params)


def make_pjit_chunked_train(cfg: Config, family: Family,
                            opt: optim.Optimizer, sampler, mesh: Mesh,
                            chunk: int) -> Callable:
    """The 2-D engine's chunked train driver: ``parallel/engine.py:
    chunked_train`` with the mp hooks (slices on entry, whole trees
    back)."""
    return chunked_train(_engine(cfg, family, opt, mesh), sampler, chunk,
                         accum=cfg.grad_accum)


def make_pjit_chunked_eval(cfg: Config, family: Family, sampler,
                           mesh: Mesh, collect: bool = False) -> Callable:
    """The 2-D engine's chunked eval: each dp shard evaluates its tasks on
    the whole params (replicated over the mp row)."""
    return chunked_eval(_engine(cfg, family, make_opt(cfg), mesh), sampler,
                        collect=collect)
