"""Lockstep multi-seed training: ``--tpu_seed_sweep S``.

The counterpart of ``fumi_tpu/train/sweep.py``. A paper's number is a mean
over seeds with its 95% interval: the same config trained under seeds
``seed, seed+1, ..., seed+S-1``. The sweep trains the S replicas in one
process, in lockstep: every seed takes train step t before any seed takes
step t+1, each with the standalone body (sample, meta-gradient, update).

Faithfulness contract, as in the JAX package: replica ``i`` follows exactly
the chain of a standalone port run with ``--seed seed+i``. Its params come
from ``build_family`` on a CPU generator seeded with ``seed+i`` (as
``cli/main.py`` makes them); its train, validation and test episodes and
its dropout come from its own generators, ``train/loop.py:
stream_generator(seed+i, ...)`` with the indices the standalone loop uses.
On one device the replica's params are then bitwise those of the
standalone run on the same sampler.

Per-seed early stopping runs on a ``live`` mask: a seed whose patience
lapses holds its params and its optimizer state (counters included) by a
``torch.where`` on a 0-d flag on the device, while its generator still
advances, so the other seeds' steps are untouched; training ends when every
seed is done.

The port runs the S seeds of a step one after another, each on its own
(unstacked) state. So ``--tpu_seed_accum G``, which in the JAX package runs
the vmapped seed axis as G groups to bound the working set, changes neither
the numbers nor the working set here: the seeds already run one at a time.
It is accepted and validated (G divides S) and changes nothing.

The states are kept per seed (lists of state dicts); :func:`stack_trees`
and :func:`unstack_tree` give the stacked ``(S, ...)`` form of the JAX
package at the boundaries: the sweep checkpoint, the returned state, the
per-seed export and ``serve.SeedEnsemble``. A Python int leaf (Adam's
update count) stacks to a list of ints.

Sharding the seeds over several devices (``--tpu_mesh_dp > 1``) is
ROADMAP.md Queue 1, item 9's multi-device part, which the driver rejects
(``cli/main.py:_check_driver``); ``--tpu_mesh_dp`` 0 or 1 is the
single-device layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.train import checkpoint as ckpt_lib
from fumi_tpu_torch.train.logging import MetricWriter
from fumi_tpu_torch.train.loop import (ARTIFACT_KEYS, CHUNK, TEST, TRAIN, VAL,
                                       _ci95, _flatten_artifacts,
                                       _train_log_keys, eval_view,
                                       stream_generator)
from fumi_tpu_torch.train.steps import (Family, _stack, _step_and_grads,
                                        accum_value_and_grad, build_family,
                                        make_chunked_eval, make_opt)
from fumi_tpu_torch.utils.profiling import Throughput, profile_trace


def sweep_seeds(cfg: Config) -> List[int]:
    """The sweep's seeds: ``seed, seed+1, ..., seed+S-1``."""
    return [cfg.seed + i for i in range(cfg.seed_sweep)]


def stack_trees(trees):
    """Stack identically nested state dicts along a new leading seed axis:
    tensors with ``torch.stack``, Python ints into a list."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if torch.is_tensor(first):
        return torch.stack(trees)
    return list(trees)


def unstack_tree(tree, i: int):
    """Replica ``i`` of a stacked tree (tensors copied out of the stack)."""
    if isinstance(tree, dict):
        return {k: unstack_tree(v, i) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree[i].clone()
    return tree[i]


def _where_seed(flag: torch.Tensor, live: bool, new, old):
    """``new`` where the seed is live, else ``old``, leaf by leaf: tensors
    by ``torch.where`` on the 0-d bool ``flag`` (on the device, no sync),
    a Python int by ``live``, its host copy."""
    if isinstance(new, dict):
        return {k: _where_seed(flag, live, v, old[k]) for k, v in new.items()}
    if torch.is_tensor(new):
        return torch.where(flag, new, old)
    return new if live else old


def build_sweep_family(cfg: Config, dictionary=None,
                       device: DeviceLike = None) -> Family:
    """The family with params stacked ``(S, ...)`` on ``device``: replica
    ``i``'s from ``build_family`` on ``torch.Generator().manual_seed(
    seed+i)`` and ``cfg.replace(seed=seed+i)``, as the standalone driver
    builds them. The functions are the first replica's (they close over no
    params)."""
    dev = resolve_device(device)
    families = [build_family(cfg.replace(seed=s, seed_sweep=0),
                             torch.Generator().manual_seed(s), dictionary)
                for s in sweep_seeds(cfg)]
    params = stack_trees([{k: v.to(dev) for k, v in f.params.items()}
                          for f in families])
    return families[0]._replace(params=params)


def make_sweep_chunked_train(family: Family, opt, sampler, chunk: int,
                             accum: int = 1, seed_accum: int = 1,
                             debug_nans: bool = False):
    """``(params, opt_states, gens, live, n=chunk, first_step=0) ->
    (params, opt_states, gens, metrics)`` running ``n`` lockstep steps.

    ``params``, ``opt_states`` and ``gens`` are per-seed lists; ``live`` is
    the host's (S,) bool mask. Each step runs the seeds one after another,
    each with ``make_chunked_train``'s body (sample from the seed's
    generator, the meta-gradient, micro-batched under ``accum`` > 1, the
    update); a seed that is not live computes the step and keeps its old
    state (:func:`_where_seed`), its generator advanced. Metrics are
    stacked ``(n, S)`` on the device. ``seed_accum`` G must divide S and
    changes nothing (module docstring)."""
    grad_fn = accum_value_and_grad(family, accum)

    def run(params, opt_states, gens, live, n=chunk, first_step=0):
        S = len(params)
        if seed_accum < 1 or S % seed_accum:
            raise ValueError(f"--tpu_seed_accum {seed_accum} must divide "
                             f"--tpu_seed_sweep {S}")
        params, opt_states = list(params), list(opt_states)
        live = [bool(x) for x in live]
        dev = next(iter(params[0].values())).device
        flags = [torch.full((), x, dtype=torch.bool, device=dev)
                 for x in live]
        per_step = []
        for j in range(n):
            ms = []
            for i in range(S):
                episode = sampler.sample(gens[i])
                p, s, m, _ = _step_and_grads(
                    family, opt, params[i], opt_states[i], episode, gens[i],
                    first_step + j if debug_nans else None, grad_fn)
                params[i] = _where_seed(flags[i], live[i], p, params[i])
                opt_states[i] = _where_seed(flags[i], live[i], s,
                                            opt_states[i])
                ms.append(m)
            per_step.append(_stack(ms))
        return params, opt_states, gens, _stack(per_step)

    return run


def make_sweep_chunked_eval(family: Family, sampler, collect: bool = False):
    """``(params, gens, n) -> metrics`` with leaves ``(S, n, ...)``: each
    seed's ``make_chunked_eval`` over ``n`` meta-batches from its own
    generator (``params`` and ``gens`` per-seed lists). Each goes through
    the family's ``eval_raw``, so through the fused kernels under
    ``--tpu_pallas_fused_eval``: one launch a seed a meta-batch."""
    run_one = make_chunked_eval(family, sampler, collect=collect)

    def run(params, gens, n):
        return _stack([run_one(p, g, n)[1] for p, g in zip(params, gens)])
    return run


def _eval_view_stacked(cfg: Config, params, opt_state):
    """The stacked counterpart of ``loop.eval_view``: the EMA rides in the
    stacked optimizer state, so the same lookup applies."""
    return eval_view(cfg, params, opt_state)


def _per_seed(tree, S: int) -> list:
    return [unstack_tree(tree, i) for i in range(S)]


def sweep_test(cfg: Config, family: Family, params, sampler, gens,
               max_num_batches: int, collect_artifacts: bool = False
               ) -> List[Dict]:
    """Per-seed test metrics, each dict shaped like ``loop.test_loop``'s:
    ``max_num_batches + 1`` meta-batches. ``params`` stacked ``(S, ...)``;
    ``gens`` the per-seed generators."""
    ms = make_sweep_chunked_eval(family, sampler, collect=collect_artifacts)(
        _per_seed(params, len(gens)), gens, max_num_batches + 1)
    ms = {k: v.cpu().numpy() for k, v in ms.items()}
    out = []
    for i in range(len(gens)):
        d = {k: float(v[i].mean()) for k, v in ms.items()
             if k not in ARTIFACT_KEYS}
        d.update(_ci95(ms["acc"][i] if "acc" in ms else None,
                       ms["loss"][i] if "loss" in ms else None))
        if collect_artifacts:
            d.update(_flatten_artifacts(
                {k: v[i] for k, v in ms.items() if k in ARTIFACT_KEYS}))
        out.append(d)
    return out


def _gen_states(gens) -> torch.Tensor:
    """(S, L) uint8: the generators' states, for the checkpoint."""
    return torch.stack([g.get_state() for g in gens])


def sweep_training_run(cfg: Config, family: Family, opt, train_sampler,
                       val_sampler, writer: MetricWriter, run_dir: str,
                       resume_dir: Optional[str] = None):
    """Lockstep training of the S replicas of ``family.params`` (stacked).

    Returns ``(params, opt_state, info)``: the stacked per-seed selected
    raw params and optimizer state (each seed's best for AM3 and FuMI, a
    seed that never improved keeping its last; the last for the MAML
    family: ``train/loop.py``'s reload), and ``info`` with per-seed
    ``best_loss``, ``best_batch_idx``, ``ever_improved``, the last trained
    ``batch_idx`` and ``selection``. Per seed the harness is
    ``training_run``'s: an initial validation seeds ``best_loss`` (AM3 also
    evaluates at batch 0), validation every ``eval_freq``, per-seed
    patience, the stop after step ``epochs``. Every validation writes the
    sweep checkpoint: the live and the best stacked states, the train
    generators' states and the per-seed bookkeeping, with ``sweep_seeds``
    in the meta, so ``--tpu_auto_resume`` (``resume_dir``) continues the
    same streams."""
    seeds = sweep_seeds(cfg)
    S = len(seeds)
    is_am3 = cfg.model == "am3"
    eval_at_zero = is_am3
    reload_best = cfg.model in ("am3", "fumi")
    dev = next(iter(family.params.values())).device

    params = _per_seed(family.params, S)
    opt_states = [opt.init(p) for p in params]
    train_gens = [stream_generator(s, TRAIN, 0, dev) for s in seeds]
    max_test_batches = cfg.max_test_batches // 2

    # each seed's best raw state, the standalone loop's best/ checkpoint;
    # ever_improved marks the seeds that have one
    best_params, best_opt = list(params), list(opt_states)
    best_loss = None
    best_batch_idx = np.zeros(S, dtype=np.int64)
    live = np.ones(S, dtype=bool)
    ever_improved = np.zeros(S, dtype=bool)
    start_batch = 0

    if resume_dir is not None:
        try:
            payload_p, payload_s, meta = ckpt_lib.load_checkpoint(
                resume_dir,
                {"state": stack_trees(params),
                 "best": stack_trees(best_params),
                 "train_gens": _gen_states(train_gens)},
                {"state": stack_trees(opt_states),
                 "best": stack_trees(best_opt)}, best=False)
        except ValueError as e:
            # an incompatible checkpoint starts fresh, as the standalone
            # driver's auto-resume does
            print(f"sweep auto-resume: cannot restore {resume_dir} ({e}); "
                  "starting fresh")
        else:
            params = _per_seed(payload_p["state"], S)
            best_params = _per_seed(payload_p["best"], S)
            opt_states = _per_seed(payload_s["state"], S)
            best_opt = _per_seed(payload_s["best"], S)
            for g, state in zip(train_gens, payload_p["train_gens"]):
                g.set_state(state.clone())
            best_loss = np.asarray(meta["best_loss_per_seed"], np.float64)
            best_batch_idx = np.asarray(meta["best_batch_idx_per_seed"],
                                        np.int64)
            live = np.asarray(meta["live_per_seed"], bool)
            ever_improved = np.asarray(meta["ever_improved_per_seed"], bool)
            start_batch = int(meta["batch_idx"]) + 1
            if cfg.patience > 0:
                # the boundary's patience flip came after the save
                live = live & ~(int(meta["batch_idx"]) - best_batch_idx
                                > cfg.patience)
            print(f"sweep auto-resume: {resume_dir} "
                  f"(batch {meta['batch_idx']}, live {live.tolist()})")

    eval_fn = make_sweep_chunked_eval(family, val_sampler)

    def run_eval(index: int):
        views = [eval_view(cfg, p, s) for p, s in zip(params, opt_states)]
        gens = [stream_generator(s, VAL, index, dev) for s in seeds]
        return {k: v.cpu().numpy() for k, v in eval_fn(
            views, gens, max_test_batches + 1).items()}

    throughput = Throughput()
    if best_loss is None:
        ms0 = run_eval(0)
        best_loss = ms0["loss"].mean(axis=1)
        print(f"\nsweep initial loss: {best_loss.tolist()}, "
              f"acc: {ms0['acc'].mean(axis=1).tolist()}")

    chunk = cfg.chunk or CHUNK
    chunked = make_sweep_chunked_train(family, opt, train_sampler, chunk,
                                       accum=cfg.grad_accum,
                                       seed_accum=cfg.seed_accum,
                                       debug_nans=cfg.debug_nans)

    def next_stop(batch_idx: int) -> int:
        stops = [cfg.epochs]
        if cfg.eval_freq > 0:
            b = (batch_idx // cfg.eval_freq) * cfg.eval_freq
            while b < batch_idx or (b == 0 and not eval_at_zero):
                b += cfg.eval_freq
            stops.append(b)
        if cfg.patience > 0 and live.any():
            stops.append(int(best_batch_idx[live].min()) + cfg.patience + 1)
        return min(stops)

    batch_idx = start_batch
    # episodes trained by live replicas; a resumed prefix counts as all live
    episodes_done = start_batch * cfg.batch_size * S
    try:
        while True:
            stop = next_stop(batch_idx)
            if not live.any() or stop < batch_idx:
                # a finished sweep resumed: the last trained batch is the
                # checkpointed one
                batch_idx = max(0, batch_idx - 1)
                break
            n = stop - batch_idx + 1
            done = 0
            while done < n:
                c = min(chunk, n - done)
                params, opt_states, train_gens, ms = chunked(
                    params, opt_states, train_gens, live, c,
                    first_step=batch_idx + done)
                episodes_done = _log_sweep_train(
                    writer, cfg, batch_idx + done, ms, is_am3, live,
                    episodes_done)
                done += c
            batch_idx = stop

            eps_rate = throughput.update((batch_idx + 1) * cfg.batch_size * S)
            is_eval = (cfg.eval_freq > 0 and batch_idx % cfg.eval_freq == 0
                       and (eval_at_zero or batch_idx != 0))
            if is_eval:
                ms = run_eval(batch_idx + 1)
                val_loss = ms["loss"].mean(axis=1)
                improved = live & (val_loss < best_loss)
                best_loss = np.where(improved, val_loss, best_loss)
                best_batch_idx = np.where(improved, batch_idx,
                                          best_batch_idx)
                ever_improved = ever_improved | improved
                for i in np.flatnonzero(improved):
                    best_params[i], best_opt[i] = params[i], opt_states[i]
                rec = {}
                for k, v in ms.items():
                    per_seed = v.mean(axis=1)
                    rec[f"val/{k}"] = float(per_seed.mean())
                    for i, s in enumerate(seeds):
                        rec[f"val/seed{s}/{k}"] = float(per_seed[i])
                rec["episodes_per_sec"] = eps_rate
                writer.log(rec, step=batch_idx)
                ckpt_lib.save_checkpoint(
                    run_dir,
                    {"state": stack_trees(params),
                     "best": stack_trees(best_params),
                     "train_gens": _gen_states(train_gens)},
                    {"state": stack_trees(opt_states),
                     "best": stack_trees(best_opt)},
                    batch_idx, float(best_loss.min()), bool(improved.any()),
                    extra_meta={
                        "model": cfg.model, "sweep_seeds": seeds,
                        "best_loss_per_seed": best_loss.tolist(),
                        "best_batch_idx_per_seed": best_batch_idx.tolist(),
                        "live_per_seed": live.tolist(),
                        "ever_improved_per_seed": ever_improved.tolist(),
                        "args": dataclasses.asdict(cfg)})
                print(f"\nBatch {batch_idx + 1}/{cfg.epochs}: "
                      f"val/loss per seed: {val_loss.tolist()}")

            if cfg.patience > 0:
                live = live & ~(batch_idx - best_batch_idx > cfg.patience)
            if (batch_idx > cfg.epochs - 1) or not live.any():
                break
            batch_idx += 1
    except KeyboardInterrupt:
        pass

    info = {"best_loss": best_loss, "best_batch_idx": best_batch_idx,
            "batch_idx": batch_idx, "ever_improved": ever_improved,
            "selection": "best" if reload_best else "last"}
    if reload_best:
        # a seed that never improved keeps its last trained state, as the
        # standalone loop reloads best/ only where it exists
        params = [b if e else p for b, p, e in
                  zip(best_params, params, ever_improved)]
        opt_states = [b if e else s for b, s, e in
                      zip(best_opt, opt_states, ever_improved)]
    return stack_trees(params), stack_trees(opt_states), info


def _log_sweep_train(writer: MetricWriter, cfg: Config, start_idx: int,
                     ms: Dict, is_am3: bool, live, episodes_done: int) -> int:
    """Per-step logs of a sweep chunk (metrics ``(n, S)``, one host fetch):
    each step logs the mean over the live seeds only, and
    ``num_episodes`` counts the live seeds' episodes. Returns the running
    episode count."""
    stacked = {k: ms[k].cpu().numpy() for k in _train_log_keys(ms, is_am3)}
    n = next(iter(stacked.values())).shape[0]
    live = np.asarray(live)
    per_step = cfg.batch_size * int(live.sum())
    for j in range(n):
        rec = {f"train/{k}": float(v[j][live].mean())
               for k, v in stacked.items()}
        episodes_done += per_step
        rec["num_episodes"] = episodes_done
        writer.log(rec, step=start_idx + j)
    return episodes_done


def sweep_report(seeds, per_seed: List[Dict]) -> Dict[str, float]:
    """``test/<k>`` (the mean over seeds), ``test/<k>_seed_ci95`` (1.96 ·
    std(ddof=1) / √S, for S > 1) and ``test/seed<s>/<k>`` for every scalar
    ``<k>`` of the per-seed test metrics."""
    out = {}
    for k in [k for k, v in per_seed[0].items()
              if isinstance(v, (int, float))]:
        vals = np.asarray([d[k] for d in per_seed], dtype=np.float64)
        out[f"test/{k}"] = float(vals.mean())
        if len(vals) > 1:
            out[f"test/{k}_seed_ci95"] = float(
                1.96 * vals.std(ddof=1) / np.sqrt(len(vals)))
        for s, d in zip(seeds, per_seed):
            out[f"test/seed{s}/{k}"] = float(d[k])
    return out


def sweep_main(cfg: Config, dictionary, samplers, writer: MetricWriter,
               run_dir: str, results_path: str,
               device: DeviceLike = None) -> dict:
    """The driver of ``--tpu_seed_sweep S``: lockstep training (inside
    ``profile_trace``), the per-seed exports, the per-seed test pass, the
    report (:func:`sweep_report`, the ``SWEEP TEST`` line) and one
    prediction CSV a seed, ``<run_name>_seed<s>``."""
    from fumi_tpu_torch.cli.main import _save_predictions_csv
    train_s, val_s, test_s = samplers
    if cfg.watch:
        print("--tpu_watch is not supported with --tpu_seed_sweep; "
              "skipping histogram telemetry (per-seed grad norms still "
              "logged)")
    seeds = sweep_seeds(cfg)
    dev = resolve_device(device)
    family = build_sweep_family(cfg, dictionary, dev)
    opt = make_opt(cfg)

    resume_dir = None
    if cfg.auto_resume:
        resume_dir = ckpt_lib.find_latest_resumable(
            cfg.log_dir, model=cfg.model, sweep_seeds=seeds)

    with profile_trace(cfg.profile_dir):
        params, opt_state, info = sweep_training_run(
            cfg, family, opt, train_s, val_s, writer, run_dir,
            resume_dir=resume_dir)

    export_seed_runs(cfg, run_dir, seeds, params, opt_state, info)

    per_seed = sweep_test(
        cfg, family, _eval_view_stacked(cfg, params, opt_state), test_s,
        [stream_generator(s, TEST, 0, dev) for s in seeds],
        cfg.max_test_batches, collect_artifacts=True)
    out = sweep_report(seeds, per_seed)
    print(f"\n SWEEP TEST (mean over {len(seeds)} seeds): "
          f"{ {k: v for k, v in out.items() if '/' not in k[5:]} }")
    writer.log(out)
    for s, d in zip(seeds, per_seed):
        _save_predictions_csv(
            cfg, types.SimpleNamespace(run_name=f"{writer.run_name}_seed{s}"),
            results_path, d)
    return out


def export_seed_runs(cfg: Config, run_dir: str, seeds, params, opt_state,
                     info) -> None:
    """One standalone run dir a seed, ``run_dir/seed<k>/``: the seed's
    selected raw params and optimizer state as both ``ckpt/`` and
    ``best/``, ``config.json`` with ``seed=k, seed_sweep=0``, the run's
    ``vocab.json`` where it has one. The meta stamps the step the state
    comes from: the best step for a seed selected at its best, the last
    trained step for ``last`` selection and for a seed that never improved
    (marked ``no_improvement``, ``selection: last``); ``best_loss`` is the
    best validation loss the run saw. ``--checkpoint``, ``--evaluate``,
    serving and ``cli/export_torch.py`` read these dirs as they read a
    standalone run's."""
    for i, s in enumerate(seeds):
        seed_dir = os.path.join(run_dir, f"seed{s}")
        fell_back = (info["selection"] == "best"
                     and not bool(info["ever_improved"][i]))
        selection = "last" if fell_back else info["selection"]
        at_step = (int(info["best_batch_idx"][i]) if selection == "best"
                   else int(info["batch_idx"]))
        extra = {"model": cfg.model, "seed": int(s),
                 "exported_from_sweep": True, "selection": selection}
        if fell_back:
            extra["no_improvement"] = True
        ckpt_lib.save_checkpoint(
            seed_dir, unstack_tree(params, i), unstack_tree(opt_state, i),
            at_step, float(info["best_loss"][i]), is_best=True,
            extra_meta=extra)
        solo = dataclasses.asdict(cfg.replace(seed=int(s), seed_sweep=0))
        with open(os.path.join(seed_dir, "config.json"), "w") as f:
            json.dump(solo, f, indent=1, default=str)
        vocab = os.path.join(run_dir, "vocab.json")
        if os.path.exists(vocab):
            shutil.copyfile(vocab, os.path.join(seed_dir, "vocab.json"))
