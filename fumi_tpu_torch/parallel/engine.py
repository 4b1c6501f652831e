"""Episode-parallel train and eval steps over a mesh of ranks.

The counterpart of ``fumi_tpu/parallel/engine.py``. There ``shard_map``
runs one program over the devices of a mesh; here each rank of the mesh
(``core/mesh.py``; one rank is one device) runs the family's functions on
its own shard, and the ranks meet in explicit collectives:

- each rank takes its ``B/dp`` tasks of the meta-batch (the single-step
  API slices the episode it is given, :func:`~fumi_tpu_torch.core.mesh.
  put_episode`; the chunked drivers sample only the rank's tasks, on its
  own device, from the sampler's tables);
- its generator is the step's generator derived with the rank's dp index
  (:func:`rank_generator`, as ``train/steps.py:micro_generator`` derives
  micro-batch generators): the counterpart of ``fold_in(key,
  axis_index)``; at dp 1 it is the step's generator itself, so a dp-1
  engine is the serial one;
- the meta-gradients and the loss are all-reduced to their mean over the
  dp ranks, in one packed all-reduce a step with the train aux (AM3's
  confusion matrix summed, ``avg_lamda`` averaged);
- the optimizer runs replicated: every rank applies the same update to the
  same params, so the params stay bitwise equal across the ranks;
- eval reduces each raw quantity as the family declares
  (``Family.eval_reduce``, :func:`reduce_eval`): ``mean`` an all-reduce
  divided by dp, ``sum`` an all-reduce (so AM3's macro metrics are exact
  over the global batch), ``concat`` an all-gather in rank order (the
  global meta-batch's order). A chunk reduces its meta-batches' stacked
  raws at once: one all-reduce and one all-gather a ``concat`` key.

``--tpu_grad_accum`` micro-batches each rank's local tasks before the
all-reduce (the mean of the micro-means, then the mean over the ranks, is
the global batch's gradient); ``--tpu_watch`` histograms the all-reduced
gradient, so its counts are the serial driver's kind. The train aux's
``concat`` keys (per-query predictions) feed no train metric and are not
gathered.

``parallel/pjit_engine.py`` runs the same steps with wide weights sharded
over the mesh's mp axis; the hooks it gives (:class:`_MpHooks`) are the
only difference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.mesh import (Mesh, all_gather_cat, all_reduce_,
                                      put_episode, put_replicated)
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.data.sampler import sample_episode
from fumi_tpu_torch.train import optim
from fumi_tpu_torch.train import watch as watch_lib
from fumi_tpu_torch.train.steps import (Family, FamilySteps, _stack,
                                        _train_metrics, accum_value_and_grad,
                                        build_family, check_finite, make_opt,
                                        micro_generator)

# micro_generator index of the generator a chunk hands on (ranks use 0..dp-1)
_ADVANCE = 1 << 31


def rank_generator(gen: Optional[torch.Generator], mesh: Mesh
                   ) -> Optional[torch.Generator]:
    """The rank's generator for a step (or a chunk) drawn under ``gen``:
    ``gen`` itself at dp 1, else ``micro_generator(gen, dp_index)``; the
    mp ranks of one dp shard share it."""
    if gen is None or mesh.dp == 1:
        return gen
    return micro_generator(gen, mesh.dp_index)


def next_generator(gen: torch.Generator, mesh: Mesh, n: int
                   ) -> torch.Generator:
    """The generator after a chunk of ``n`` steps: at dp 1 ``gen`` itself
    (the chunk advanced it), else one derived from ``gen`` and ``n`` (the
    JAX engine's ``fold_in(key, n)``)."""
    if mesh.dp == 1:
        return gen
    return micro_generator(gen, _ADVANCE + n)


def check_batch(batch_size: int, mesh: Mesh) -> None:
    if batch_size % mesh.dp != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by dp={mesh.dp}")


def _pack_reduce(mesh: Mesh, tensors, divide) -> list:
    """One all-reduce (sum) over the dp column of every tensor in
    ``tensors``, packed flat; entries with ``divide`` True come back
    divided by dp (the mean). Dtypes and shapes are kept."""
    if mesh.dp_group is None:
        return list(tensors)
    flat = torch.cat([t.to(torch.float32).reshape(-1) for t in tensors])
    all_reduce_(flat, mesh.dp_group)
    out, at = [], 0
    for t, d in zip(tensors, divide):
        part = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
        out.append((part / mesh.dp if d else part).to(t.dtype))
    return out


def reduce_step(mesh: Mesh, grads: Dict[str, torch.Tensor], loss, aux,
                aux_reduce: Dict[str, str]):
    """The meta-gradient and the loss averaged over the dp ranks, the aux's
    ``mean`` keys averaged and ``sum`` keys summed (``concat`` keys
    dropped): one all-reduce."""
    keys = [k for k in aux if aux_reduce.get(k, "mean") in ("mean", "sum")]
    tensors = ([grads[k] for k in grads] + [loss]
               + [torch.as_tensor(aux[k]) for k in keys])
    divide = ([True] * (len(grads) + 1)
              + [aux_reduce.get(k, "mean") == "mean" for k in keys])
    out = _pack_reduce(mesh, tensors, divide)
    n = len(grads)
    return (dict(zip(grads, out[:n])), out[n],
            dict(zip(keys, out[n + 1:])))


def reduce_eval(mesh: Mesh, raw: Dict[str, torch.Tensor],
                eval_reduce: Dict[str, str], axis: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The counterpart of the JAX engine's ``_reduce_raw`` on raws whose
    task axis is ``axis`` (1 for a chunk's stacked raws): ``mean`` and
    ``sum`` in one all-reduce, each ``concat`` key an all-gather along the
    task axis in rank order."""
    modes = {k: eval_reduce.get(k, "mean") for k in raw}
    bad = {m for m in modes.values()} - {"mean", "sum", "concat"}
    if bad:
        raise ValueError(f"unknown reduction {bad} in {modes}")
    red = [k for k, m in modes.items() if m != "concat"]
    out = dict(zip(red, _pack_reduce(mesh, [raw[k] for k in red],
                                     [modes[k] == "mean" for k in red])))
    for k, m in modes.items():
        if m == "concat":
            out[k] = all_gather_cat(raw[k], mesh.dp_group, dim=axis,
                                    gloo=mesh.gloo)
    return {k: out[k] for k in raw}


class _MpHooks:
    """What the dp engine needs of a model axis; the dp engine's own is
    the identity (``parallel/pjit_engine.py`` gives the 2-D one)."""

    def shard(self, tree):
        """Full params (or an optimizer state over them) -> this rank's."""
        return tree

    def gather(self, tree):
        """This rank's params (or optimizer state) -> the whole tree."""
        return tree

    def grad_fn(self, family: Family, accum: int) -> Callable:
        return accum_value_and_grad(family, accum)

    def finish_grads(self, family: Family, grads, skip_nonfinite: bool):
        """``(grads, per-layer norms or None)`` after the dp all-reduce."""
        return grads, None

    def any_nonfinite(self, tensors) -> bool:
        return False


class _Engine:
    """One rank's share of a family's steps on ``mesh``."""

    def __init__(self, cfg: Config, family: Family, opt: optim.Optimizer,
                 mesh: Mesh, hooks: Optional[_MpHooks] = None):
        check_batch(cfg.batch_size, mesh)
        self.cfg, self.family, self.opt, self.mesh = cfg, family, opt, mesh
        self.hooks = hooks or _MpHooks()
        self.aux_reduce = dict(family.eval_reduce)

    def local_spec(self, spec):
        check_batch(spec.batch_size, self.mesh)
        return dataclasses.replace(spec,
                                   batch_size=spec.batch_size // self.mesh.dp)

    def step(self, params, opt_state, local_episode, gen, grad_fn,
             debug_step=None):
        """One step on this rank's tasks (params and state this rank's):
        ``(params, opt_state, metrics, grads)``."""
        (loss, aux), grads = grad_fn(params, local_episode, gen)
        grads, loss, aux = reduce_step(self.mesh, grads, loss, aux,
                                       self.aux_reduce)
        with torch.no_grad():
            grads, per_layer = self.hooks.finish_grads(
                self.family, grads, self.cfg.skip_nonfinite > 0)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            new_params = optim.apply_updates(params, updates)
            if debug_step is not None:
                named = [loss, *grads.values(), *new_params.values()]
                if self.hooks.any_nonfinite(named):
                    check_finite(debug_step, loss, grads, new_params)
                    raise FloatingPointError(
                        f"--tpu_debug_nans: train step {debug_step} made a "
                        "non-finite value on another rank")
                check_finite(debug_step, loss, grads, new_params)
            metrics = _train_metrics(self.family, loss, aux, local_episode,
                                     grads, per_layer=per_layer)
        return new_params, opt_state, metrics, grads

    def eval_raw(self, params, local_episode, gen):
        """The family's eval raw of this rank's tasks, not yet reduced."""
        return self.family.eval_raw(params, local_episode, gen)


def _steps(engine: _Engine, params) -> FamilySteps:
    """The single-step API: ``train_step(params, opt_state, episode, gen,
    step=None)`` and ``eval_step(params, episode, gen)`` on the GLOBAL
    episode (each rank takes its shard) and whole params."""
    family, mesh, hooks = engine.family, engine.mesh, engine.hooks
    grad_fn = hooks.grad_fn(family, 1)
    count = [0]

    def train_step(params, opt_state, episode, gen, step=None):
        if step is None:
            step = count[0]
        count[0] = step + 1
        p, s, m, _ = engine.step(
            hooks.shard(params), hooks.shard(opt_state),
            put_episode(episode, mesh), rank_generator(gen, mesh), grad_fn,
            step if engine.cfg.debug_nans else None)
        return hooks.gather(p), hooks.gather(s), m

    def eval_step(params, episode, gen):
        with torch.no_grad():
            raw = engine.eval_raw(params, put_episode(episode, mesh),
                                  rank_generator(gen, mesh))
            return family.eval_finalize(
                reduce_eval(mesh, raw, family.eval_reduce))

    return FamilySteps(params=params, opt=engine.opt, train_step=train_step,
                       eval_step=eval_step, family=family, mesh=mesh)


def make_parallel_steps(cfg: Config, gen: torch.Generator, mesh: Mesh,
                        device: DeviceLike = None,
                        dictionary=None) -> FamilySteps:
    """Episode-parallel steps for ``cfg``'s family, with the contract of
    ``train/steps.py:make_steps``: the params are built from ``gen`` on
    the CPU, placed on ``device`` and broadcast from rank 0
    (:func:`~fumi_tpu_torch.core.mesh.put_replicated`), so every rank
    starts from the same ones."""
    dev = resolve_device(device)
    family = build_family(cfg, gen, dictionary)
    family = family._replace(params=put_replicated(
        {k: v.to(dev) for k, v in family.params.items()}, mesh))
    engine = _Engine(cfg, family, make_opt(cfg), mesh)
    return _steps(engine, family.params)


def chunked_train(engine: _Engine, sampler, chunk: int, accum: int = 1,
                  watch: bool = False) -> Callable:
    """``(params, opt_state, gen, n=chunk, first_step=0) -> (params,
    opt_state, gen, metrics)``, the contract of ``train/steps.py:
    make_chunked_train``: each rank samples its ``B/dp`` tasks a step from
    the sampler's tables on its own device under :func:`rank_generator`,
    steps, and all-reduces; the metrics are replicated."""
    cfg, mesh, hooks = engine.cfg, engine.mesh, engine.hooks
    local_spec = engine.local_spec(sampler.spec)
    if accum > 1 and local_spec.batch_size % accum != 0:
        raise ValueError(
            f"--tpu_grad_accum {accum} must divide the per-shard batch "
            f"{local_spec.batch_size} (batch_size/dp)")
    grad_fn = hooks.grad_fn(engine.family, accum)

    def run(params, opt_state, gen, n=chunk, first_step=0):
        rg = rank_generator(gen, mesh)
        p, s = hooks.shard(params), hooks.shard(opt_state)
        stride = max(1, min(watch_lib.WATCH_STRIDE, n)) if watch else 0
        per_step, counts = [], []
        for j in range(n):
            episode = sample_episode(
                sampler.tables, local_spec, rg,
                use_pallas_gather=sampler.use_pallas_gather,
                augment_scale=sampler.augment_scale)
            p, s, m, grads = engine.step(
                p, s, episode, rg, grad_fn,
                first_step + j if cfg.debug_nans else None)
            per_step.append(m)
            if stride and (j + 1) % stride == 0:
                counts.append(watch_lib.grad_histogram_metrics(
                    grads, engine.family.name))
        ms = _stack(per_step)
        ms.update(_stack(counts))
        return (hooks.gather(p), hooks.gather(s),
                next_generator(gen, mesh, n), ms)
    return run


def chunked_eval(engine: _Engine, sampler, collect: bool = False
                 ) -> Callable:
    """``(params, gen, n) -> (gen, metrics)``, the contract of
    ``train/steps.py:make_chunked_eval``: each rank evaluates its tasks of
    ``n`` meta-batches (the fused kernels under ``--tpu_pallas_fused_eval``,
    one launch a rank a meta-batch), then the stacked raws are reduced
    (:func:`reduce_eval`) and finalized a meta-batch at a time; artifacts
    come back in the global meta-batch's order."""
    family, mesh = engine.family, engine.mesh
    local_spec = engine.local_spec(sampler.spec)
    reduce_spec = dict(family.eval_reduce, query_idx="concat",
                       support_idx="concat")

    def run(params, gen, n):
        rg = rank_generator(gen, mesh)
        raws = []
        with torch.no_grad():
            for _ in range(n):
                episode = sample_episode(
                    sampler.tables, local_spec, rg,
                    use_pallas_gather=sampler.use_pallas_gather,
                    augment_scale=sampler.augment_scale)
                raw = engine.eval_raw(params, episode, rg)
                if collect:
                    raw = dict(raw, query_idx=episode.query_ids,
                               support_idx=episode.support_ids)
                raws.append({k: torch.as_tensor(v) for k, v in raw.items()})
            stacked = reduce_eval(mesh, _stack(raws), reduce_spec, axis=1)
            per_step = []
            for i in range(n):
                out = family.eval_finalize({k: v[i]
                                            for k, v in stacked.items()})
                m = {k: v for k, v in out.items() if v.dim() == 0}
                if collect:
                    m.update({k: out[k] for k in ("preds", "targets",
                                                  "lamda") if k in out})
                    m["query_idx"] = stacked["query_idx"][i]
                    m["support_idx"] = stacked["support_idx"][i]
                per_step.append(m)
        return gen, _stack(per_step)
    return run


def make_parallel_chunked_train(cfg: Config, family: Family,
                                opt: optim.Optimizer, sampler, mesh: Mesh,
                                chunk: int, watch: bool = False) -> Callable:
    """The dp engine's chunked train driver (:func:`chunked_train`)."""
    return chunked_train(_Engine(cfg, family, opt, mesh), sampler, chunk,
                         accum=cfg.grad_accum, watch=watch)


def make_parallel_chunked_eval(cfg: Config, family: Family, sampler,
                               mesh: Mesh, collect: bool = False
                               ) -> Callable:
    """The dp engine's chunked eval driver (:func:`chunked_eval`)."""
    return chunked_eval(_Engine(cfg, family, make_opt(cfg), mesh), sampler,
                        collect=collect)
