"""Episodic training and eval harness for the episodic families.

The counterpart of ``fumi_tpu/train/loop.py`` (its single-device paths;
the mesh engines are ROADMAP.md Queue 1, item 9). It keeps the reference harness's quirks as the JAX package does:

- an initial validation pass seeds ``best_loss``;
- validation and a checkpoint every ``--eval_freq`` batches; AM3 evaluates
  at batch 0 as well, MAML and FuMI do not;
- early stop on ``--patience`` (``batch_idx - best_batch_idx >
  patience``, checked after every step, so it can fire between evals) or
  after step ``--epochs`` (``epochs + 1`` steps in all);
- ``KeyboardInterrupt`` is caught, so a manual stop still reloads and
  tests;
- FuMI (and AM3) reload the best checkpoint after training, MAML returns
  its last parameters;
- :func:`test_loop` runs ``max_num_batches + 1`` meta-batches.

With the device sampler the train steps run through ``make_chunked_train``
in ``--tpu_chunk`` pieces (one host sync per piece) and are logged per
step; evals through ``make_chunked_eval``. Any other sampler object is
drawn one batch at a time with ``sampler.sample()``, as the JAX package's
host-sampler path does (``data/sampler.py``'s host samplers draw from
their own numpy streams). With ``--tpu_ema``, validation, the final test
and the returned params see the EMA (:func:`eval_view`);
``--tpu_debug_nans`` checks every train step
(``train/steps.py:check_finite``); ``--tpu_grad_accum`` micro-batches each
step's meta-gradient; ``--tpu_watch`` writes the params' and the sampled
meta-gradients' histograms at every eval boundary (:class:`_Watch`,
``train/watch.py``).

Random streams. Each is a ``torch.Generator`` on the params' device,
seeded with :func:`stream_seed` ``= (seed mod 2**32) * 2**32 + stream *
2**28 + index``: stream ``TRAIN`` (index 0) draws the training episodes
and dropout, stream ``VAL`` the validation passes (index 0 for the initial
pass, ``batch_idx + 1`` for the pass at that batch, so a pass's episodes
depend on the seed and the batch only), stream ``TEST`` the final test
pass, stream ``WATCH`` (index ``batch_idx``) the forward noise of the
host-sampler path's ``--tpu_watch`` gradient sample. They are
deterministic per seed and are not the JAX package's streams.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from fumi_tpu_torch.core.config import Config
from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
from fumi_tpu_torch.train import checkpoint as ckpt_lib
from fumi_tpu_torch.train.logging import AverageMeter, MetricWriter
from fumi_tpu_torch.train.optim import find_ema
from fumi_tpu_torch.train.steps import (FamilySteps, make_chunked_eval,
                                        make_chunked_train)
from fumi_tpu_torch.utils.profiling import Throughput, hbm_stats

AM3_TRAIN_KEYS = ("loss", "acc", "f1", "prec", "rec", "avg_lamda",
                  "grad_norm")
CHUNK = 1000  # train steps per driver call (one host sync each)
ARTIFACT_KEYS = ("preds", "targets", "lamda", "query_idx", "support_idx")
TRAIN, VAL, TEST, WATCH = 1, 2, 3, 4


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """The seed of random stream ``stream`` (TRAIN, VAL, TEST) at
    ``index`` (< 2**28) for the run seed ``seed``."""
    return ((int(seed) % 2 ** 32) << 32) + (stream << 28) + int(index)


def stream_generator(seed: int, stream: int, index: int,
                     device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _draw(sampler, gen):
    """One meta-batch: device samplers draw from ``gen``, any other
    sampler object from its own stream."""
    if isinstance(sampler, DeviceEpisodeSampler):
        return sampler.sample(gen)
    return sampler.sample()


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def test_loop(cfg: Config, steps: FamilySteps, params, sampler,
              max_num_batches: int, gen: torch.Generator,
              collect_artifacts: bool = False) -> Dict:
    """Evaluate on val/test episodes: ``max_num_batches + 1`` meta-batches
    (the reference's quirk). Device sampler: one ``make_chunked_eval`` call
    and one host sync."""
    total = max_num_batches + 1
    if isinstance(sampler, DeviceEpisodeSampler) and \
            steps.family is not None:
        run = make_chunked_eval(steps.family, sampler,
                                collect=collect_artifacts)
        _, ms = run(params, gen, total)
        ms = _host(ms)
        out = {k: float(v.mean()) for k, v in ms.items()
               if k not in ARTIFACT_KEYS}
        out.update(_ci95(ms.get("acc"), ms.get("loss")))
        if collect_artifacts:
            out.update(_flatten_artifacts(ms))
        return out

    # any other sampler: one meta-batch at a time
    meters: Dict[str, AverageMeter] = {}
    series: Dict[str, List] = {"acc": [], "loss": []}  # for the 95% CI
    arts: Dict[str, List] = {k: [] for k in ARTIFACT_KEYS}
    for _ in range(total):
        episode = _draw(sampler, gen)
        m = steps.eval_step(params, episode, gen)
        for k, v in m.items():
            if k in ("preds", "targets", "lamda"):
                continue
            meters.setdefault(k, AverageMeter()).update(float(v))
            if k in series:
                series[k].append(float(v))
        if collect_artifacts:
            for key, t in (("preds", m["preds"]), ("targets", m["targets"]),
                           ("query_idx", episode.query_ids),
                           ("support_idx", episode.support_ids)):
                arts[key] += t.reshape(-1).tolist()
            if "lamda" in m:
                arts["lamda"] += m["lamda"].reshape(-1).tolist()
    out = {k: meter.avg for k, meter in meters.items()}
    out.update(_ci95(np.asarray(series["acc"]), np.asarray(series["loss"])))
    if collect_artifacts:
        out.update(preds=arts["preds"], targets=arts["targets"],
                   query_idx=arts["query_idx"],
                   support_idx=arts["support_idx"],
                   support_lamdas=arts["lamda"])
    return out


def _ci95(accs, losses) -> Dict:
    """The 95% confidence half-width of the mean over the evaluated
    meta-batches (``acc_ci95``, ``loss_ci95``)."""
    out = {}
    for name, v in (("acc", accs), ("loss", losses)):
        if v is None:
            continue
        v = np.asarray(v).reshape(-1)
        if v.size > 1:
            out[f"{name}_ci95"] = float(
                1.96 * v.std(ddof=1) / np.sqrt(v.size))
    return out


def _flatten_artifacts(ms: Dict) -> Dict:
    out = {}
    for src, dst in (("preds", "preds"), ("targets", "targets"),
                     ("query_idx", "query_idx"),
                     ("support_idx", "support_idx"),
                     ("lamda", "support_lamdas")):
        if src in ms:
            out[dst] = ms[src].reshape(-1).tolist()
    return out


def eval_view(cfg: Config, params, opt_state):
    """The parameters evaluation should see: the EMA when ``--tpu_ema`` is
    on (and the state holds one), else the raw params."""
    if cfg.ema > 0:
        ema = find_ema(opt_state)
        if ema is not None:
            return ema
    return params


def training_run(cfg: Config, steps: FamilySteps, train_sampler, val_sampler,
                 writer: MetricWriter, run_dir: str, seed: int,
                 opt_state=None, start_batch: int = 0,
                 initial_best: float = None):
    """Train loop for the episodic families. Returns the final params.

    ``seed`` keys the TRAIN and VAL streams (module docstring).
    ``opt_state`` continues from a restored optimizer state;
    ``start_batch`` / ``initial_best`` continue the batch counter and the
    best-loss bookkeeping of a crash-resumed run (``--tpu_auto_resume``)."""
    is_am3 = cfg.model == "am3"
    eval_at_zero = is_am3
    reload_best = cfg.model in ("am3", "fumi")

    params = steps.params
    dev = _device_of(params)
    if opt_state is None:
        opt_state = steps.opt.init(params)
    max_test_batches = cfg.max_test_batches // 2

    val_m = test_loop(cfg, steps, eval_view(cfg, params, opt_state),
                      val_sampler, max_test_batches,
                      stream_generator(seed, VAL, 0, dev))
    best_loss = val_m["loss"]
    if initial_best is not None:
        best_loss = min(best_loss, float(initial_best))
    best_batch_idx = start_batch  # fresh patience window on resume
    throughput = Throughput()
    print(f"\ninitial loss: {best_loss}, acc: {val_m['acc']}")

    train_gen = stream_generator(seed, TRAIN, 0, dev)
    device_path = (isinstance(train_sampler, DeviceEpisodeSampler)
                   and steps.family is not None)
    chunk = cfg.chunk or CHUNK
    if device_path:
        chunked = make_chunked_train(steps.family, steps.opt, train_sampler,
                                     chunk, accum=cfg.grad_accum,
                                     watch=cfg.watch,
                                     debug_nans=cfg.debug_nans)
    watch = _Watch(steps, train_sampler, writer, seed, dev,
                   device_path) if cfg.watch else None

    def next_stop(batch_idx: int) -> int:
        """The next step index after which the loop must pause: an eval
        boundary, the epochs end, or the patience trigger."""
        stops = [cfg.epochs]  # the reference breaks after step `epochs`
        if cfg.eval_freq > 0:
            b = (batch_idx // cfg.eval_freq) * cfg.eval_freq
            while b < batch_idx or (b == 0 and not eval_at_zero):
                b += cfg.eval_freq
            stops.append(b)
        if cfg.patience > 0:
            stops.append(best_batch_idx + cfg.patience + 1)
        return min(stops)

    batch_idx = start_batch
    try:
        while True:
            stop = next_stop(batch_idx)
            if stop < batch_idx:  # resumed at/past the end: nothing to run
                break
            n = stop - batch_idx + 1  # steps batch_idx..stop inclusive

            if device_path:
                done = 0
                while done < n:
                    c = min(chunk, n - done)
                    params, opt_state, train_gen, ms = chunked(
                        params, opt_state, train_gen, c,
                        first_step=batch_idx + done)
                    if watch is not None:
                        ms = watch.absorb(ms)
                    _log_train_stack(writer, cfg, batch_idx + done, ms,
                                     is_am3)
                    done += c
            else:
                for j in range(n):
                    episode = _draw(train_sampler, train_gen)
                    params, opt_state, m = steps.train_step(
                        params, opt_state, episode, train_gen,
                        step=batch_idx + j)
                    _log_train_stack(writer, cfg, batch_idx + j,
                                     {k: v.reshape(1) for k, v in m.items()},
                                     is_am3)

            batch_idx = stop  # last processed step index

            eps_rate = throughput.update((batch_idx + 1) * cfg.batch_size)

            is_eval = (cfg.eval_freq > 0 and batch_idx % cfg.eval_freq == 0
                       and (eval_at_zero or batch_idx != 0))
            if is_eval:
                val_m = test_loop(cfg, steps,
                                  eval_view(cfg, params, opt_state),
                                  val_sampler, max_test_batches,
                                  stream_generator(seed, VAL, batch_idx + 1,
                                                   dev))
                is_best = val_m["loss"] < best_loss
                if is_best:
                    best_loss = val_m["loss"]
                    best_batch_idx = batch_idx
                rec = {f"val/{k}": v for k, v in val_m.items()}
                rec["episodes_per_sec"] = eps_rate
                rec.update(hbm_stats(dev))
                writer.log(rec, step=batch_idx)
                if watch is not None:
                    watch.log_boundary(params, batch_idx)
                ckpt_lib.save_checkpoint(
                    run_dir, params, opt_state, batch_idx, best_loss,
                    is_best,
                    extra_meta={"model": cfg.model,
                                "args": dataclasses.asdict(cfg)})
                print(f"\nBatch {batch_idx + 1}/{cfg.epochs}: "
                      f"val/loss: {val_m['loss']}, val/acc: {val_m['acc']}")

            # the reference's break on max iters or patience
            if (batch_idx > cfg.epochs - 1) or (
                    cfg.patience > 0 and
                    batch_idx - best_batch_idx > cfg.patience):
                break
            batch_idx += 1
    except KeyboardInterrupt:
        pass

    if reload_best and os.path.exists(os.path.join(run_dir, "best")):
        params, opt_state, _ = ckpt_lib.load_checkpoint(
            run_dir, params, opt_state, best=True)
    return eval_view(cfg, params, opt_state)


class _Watch:
    """``--tpu_watch`` in the loop. On the device path the chunked driver
    histograms the sampled meta-gradients (``train/steps.py:
    make_chunked_train``); :meth:`absorb` takes the counts out of each
    chunk's metrics (the one fetch a chunk) and sums them until the next
    eval boundary. On the host-sampler path :meth:`log_boundary` takes a
    point sample instead: the meta-gradient of one episode of
    ``watch_clone()``, a sampler with a seed of its own, so a watched run
    draws the same training episodes as an unwatched one; its forward noise
    comes from stream ``WATCH`` at the boundary's index."""

    def __init__(self, steps, train_sampler, writer, seed, dev,
                 device_path):
        self.steps, self.writer, self.seed, self.dev = steps, writer, seed, dev
        self.accumulate = device_path
        self.train_sampler = train_sampler
        self.counts: Dict[str, np.ndarray] = {}
        self.n_steps = 0
        self._clone = None

    def absorb(self, ms):
        from fumi_tpu_torch.train.watch import split_watch_counts
        ms, counts, n = split_watch_counts(ms)
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v
        self.n_steps += n
        return ms

    def log_boundary(self, params, batch_idx: int) -> None:
        from fumi_tpu_torch.train.steps import value_and_grad
        from fumi_tpu_torch.train.watch import log_watch, watch_record
        name = self.steps.family.name if self.steps.family else None
        if self.accumulate:
            rec = watch_record(params, name, grad_counts=dict(self.counts))
            rec["watch/grad_steps"] = np.int64(self.n_steps)
            self.counts, self.n_steps = {}, 0
        else:
            grads = None
            if self.steps.family is not None:
                if self._clone is None:
                    base = getattr(self.train_sampler, "sampler",
                                   self.train_sampler)
                    self._clone = base.watch_clone()
                _, grads = value_and_grad(
                    self.steps.family, params, self._clone.sample(),
                    stream_generator(self.seed, WATCH, batch_idx, self.dev))
            rec = watch_record(params, name, grads)
        log_watch(self.writer, rec, step=batch_idx)


def _train_log_keys(m: Dict, is_am3: bool):
    keys = AM3_TRAIN_KEYS if is_am3 else ("loss", "acc", "grad_norm")
    return [k for k in m if k in keys or k.startswith("grad_norm/")]


def _log_train_stack(writer: MetricWriter, cfg: Config, start_idx: int,
                     ms: Dict, is_am3: bool) -> None:
    """Per-step logs from stacked (n,) metrics, one host sync."""
    stacked = _host({k: ms[k] for k in _train_log_keys(ms, is_am3)})
    n = len(next(iter(stacked.values())))
    for j in range(n):
        rec = {f"train/{k}": float(v[j]) for k, v in stacked.items()}
        rec["num_episodes"] = (start_idx + j + 1) * cfg.batch_size
        writer.log(rec, step=start_idx + j)
