"""Experiment driver: ``python -m fumi_tpu_torch.cli.main``.

The counterpart of ``fumi_tpu/cli/main.py`` for the episodic families
(MAML, FuMI, AM3, ProtoNet, MatchingNet and any family a ``--tpu_import``
module registers) on precomputed image embeddings or, with ``--im_encoder
conv4|resnet12``, raw images (the synthetic raw set, or iNat-Anim's
``low-res-images.hdf5``; the driver adopts a raw table's stored
geometry), and CLIP. ``--tpu_compute_dtype bfloat16`` runs the bf16
policy and stores a floating table in bf16. The datasets
are ``inat-anim`` and ``supervised-inat-anim`` (``data/inat_anim.py``;
a token text encoder on ``inat-anim`` takes its pretrained vectors from
``data/vectors.py``'s artifact), ``cub`` (``data/cub.py``) and
``synthetic``. The flow is the JAX package's: validate the config, set up
the run and its log, load the data, build the family's steps and three
device samplers (train, val, test; ``--augment`` jitters the train support
set only), restore ``--checkpoint`` or ``--tpu_auto_resume`` state, train
(:func:`~fumi_tpu_torch.train.loop.training_run`), then the test pass,
the ``TEST`` line and the prediction CSV ``<log_dir>/results/run_*.csv``
(with AM3's ``support_lamda`` column). Each run writes its config to
``<log_dir>/runs/<run>/config.json`` and its checkpoints beside it; a
token-encoder run (``--text_encoder glove|w2v|RNN|RNNhid``) writes the
dictionary to ``vocab.json`` there too. ``--model clip`` runs
``train/clip_loop.py`` instead, on ``supervised-inat-anim`` or
``synthetic``: restore ``--checkpoint``, train unless ``--evaluate``, the
retrieval test pass and ``TEST: test acc: ...``.

Device: the driver runs on the card; ``--disable_cuda`` selects the CPU
(the reference's meaning of the flag). Without CUDA and without it, the
driver raises. Random streams are the loop's (``train/loop.py``); model
init draws from a CPU generator seeded with ``--seed``.

``--tpu_host_sampler`` draws episodes on the host
(``data/sampler.py:HostEpisodeSampler``, with ``--tpu_sampler_backend``,
``--num_workers`` and ``--tpu_loader_mp_context``). ``--tpu_ema``,
``--tpu_skip_nonfinite`` and ``--tpu_debug_nans`` are the training
extensions (``train/optim.py``, ``train/steps.py:check_finite``);
``--tpu_grad_accum`` micro-batches the meta-gradient, ``--tpu_watch``
logs histograms (``train/watch.py``) and ``--tpu_profile_dir`` writes a
``torch.profiler`` trace of training. ``--tpu_seed_sweep S`` trains S
seeds in lockstep (``train/sweep.py:sweep_main``, ``--tpu_seed_accum``):
per-seed run dirs ``seed<k>/``, the ``SWEEP TEST`` line and one CSV a
seed. ``--checkpoint`` takes a run dir or a reference ``.pth.tar`` file
(``interop.py``).

Several devices. One rank is one device (``core/distributed.py``): a
JAX process holds every device of its host, a port process is one rank.
``--tpu_dist_coordinator/--tpu_dist_num_processes/--tpu_dist_process_id``
(or torchrun's environment) make each process one rank of a world, joined
before anything else runs; each writes its own run dir, suffixed ``-p<rank>``,
with its own whole checkpoint, and only rank 0 logs to wandb. A single
process given ``--tpu_mesh_dp N`` and/or ``--tpu_mesh_mp M`` starts the
``N · M`` ranks itself (``parallel/launch.py``: one card each, or CPU
ranks under ``--disable_cuda``); rank 0 alone writes the run dir and
prints the ``TEST`` line, as the JAX package's one process does. The mesh
is decided before the steps are built, as the JAX driver decides it:
``--tpu_mesh_mp > 1`` runs the 2-D engine (``parallel/pjit_engine.py``),
dp > 1 the episode-parallel one (``parallel/engine.py``), ``--tpu_mesh_dp
0`` picks the largest dp that divides ``--batch_size`` and fits the
world's ranks. CLIP shards its rows over the world's ranks
(``train/clip_loop.py``) and a seed sweep its seeds
(``train/sweep.py``). The backend is NCCL where every rank has a card of
its own, gloo where ranks share a card or run on the CPU; the ``running
on`` line names it.

A wandb run path for ``--checkpoint`` needs the network and raises.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import shutil
import sys
from typing import Optional

import numpy as np
import torch

from fumi_tpu_torch.core import distributed
from fumi_tpu_torch.core import mesh as mesh_lib
from fumi_tpu_torch.core.config import (Config, TOKEN_TEXT_ENCODERS,
                                        config_from_args)
from fumi_tpu_torch.models import RAW_IMAGE_ENCODERS
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.data.cub import load_cub
from fumi_tpu_torch.data.inat_anim import load_inat_anim
from fumi_tpu_torch.data.sampler import (DeviceEpisodeSampler,
                                          HostEpisodeSampler,
                                          MultiprocessSampler,
                                          PrefetchingSampler, table_storage)
from fumi_tpu_torch.data.supervised import supervised_from_class_set
from fumi_tpu_torch.data.synthetic import (synthetic_dictionary,
                                           synthetic_splits)
from fumi_tpu_torch.data.vectors import Vocabulary, vectors_for_encoder
from fumi_tpu_torch.train import checkpoint as ckpt_lib
from fumi_tpu_torch.train import clip_loop
from fumi_tpu_torch.train.logging import MetricWriter
from fumi_tpu_torch.train.loop import (TEST, eval_view, stream_generator,
                                       test_loop, training_run)
from fumi_tpu_torch.train.optim import init_optim
from fumi_tpu_torch.train.steps import make_steps
from fumi_tpu_torch.train.sweep import sweep_main
from fumi_tpu_torch.utils.profiling import profile_trace


def _check_driver(cfg: Config) -> None:
    """Reject what the driver does not run yet, before any work."""
    if cfg.model == "clip":
        if cfg.dataset not in ("supervised-inat-anim", "synthetic"):
            raise NotImplementedError(
                "CLIP requires --dataset supervised-inat-anim")
        if cfg.dataset == "supervised-inat-anim" and \
                cfg.text_encoder != "BERT":
            # ref: data.py:61-62 — the supervised path is BERT-only
            raise NotImplementedError(
                "supervised-inat-anim supports only --text_encoder BERT")
        if cfg.text_encoder in TOKEN_TEXT_ENCODERS:
            raise ValueError(
                "--model clip reads precomputed text embeddings "
                f"(--text_encoder BERT or precomputed), not "
                f"{cfg.text_encoder} tokens")


def _load_data(cfg: Config):
    """Dataset dispatch, the JAX package's (ref: data.py:25-86): ``({"train",
    "val", "test"} -> ClassSet, image_table, image_ids, dictionary)``.

    - ``inat-anim`` / ``supervised-inat-anim``: :func:`load_inat_anim`
      (the raw ``low-res-images.hdf5`` table for a raw-image backbone on
      ``inat-anim``); on ``inat-anim`` a token text encoder's dictionary
      carries the
      pretrained vectors of ``prepare vectors``' artifact (an actionable
      error without one);
    - ``cub``: :func:`load_cub` (image-only, no dictionary);
    - ``synthetic``: 32 classes of 64 images, the JAX package's
      ``synthetic_splits`` at the config's widths and seed; for a token
      text encoder, 12 random tokens a class from a vocabulary of 128 and
      its dictionary (``{}`` otherwise); a raw-image backbone gets the raw
      synthetic set at ``--tpu_im_size`` / ``--tpu_im_channels``."""
    raw = cfg.im_encoder in RAW_IMAGE_ENCODERS
    if cfg.dataset in ("inat-anim", "supervised-inat-anim"):
        data = load_inat_anim(
            cfg.data_dir, text_encoder=cfg.text_encoder,
            text_type=cfg.text_type,
            remove_stop_words=cfg.remove_stop_words,
            image_embedding_model=cfg.image_embedding_model,
            raw_images=raw and cfg.dataset == "inat-anim")
        dictionary = (data.dictionary.token2id
                      if data.dictionary is not None else {})
        if cfg.dataset == "inat-anim" and \
                cfg.text_encoder in TOKEN_TEXT_ENCODERS:
            dictionary = Vocabulary(
                dictionary,
                vectors_for_encoder(cfg.text_encoder, cfg.data_dir))
        return data.splits, data.image_table, data.image_ids, dictionary
    if cfg.dataset == "cub":
        splits, table, ids = load_cub(cfg.data_dir)
        return splits, table, ids, {}
    if cfg.dataset != "synthetic":
        raise NotImplementedError(f"dataset {cfg.dataset!r}")
    tokens = cfg.text_encoder in TOKEN_TEXT_ENCODERS
    kw = dict(text_tokens=True, vocab_size=128, text_len=12) \
        if tokens else {}
    splits, table, ids = synthetic_splits(
        num_classes=32, images_per_class=64, im_dim=cfg.im_emb_dim,
        text_dim=cfg.text_emb_dim, seed=cfg.seed, raw_images=raw,
        im_size=cfg.im_size, channels=cfg.im_channels, **kw)
    return splits, table, ids, synthetic_dictionary(128) if tokens else {}


def _specs(cfg: Config, text_dim: int, tokens: bool):
    train = EpisodeSpec(cfg.batch_size, cfg.num_ways, cfg.num_shots,
                        cfg.num_query_train, cfg.im_emb_dim, text_dim,
                        text_is_tokens=tokens)
    evals = EpisodeSpec(cfg.batch_size, cfg.num_ways, cfg.num_shots,
                        cfg.num_query_eval, cfg.im_emb_dim, text_dim,
                        text_is_tokens=tokens)
    return train, evals


def _samplers(cfg: Config, splits, image_table, image_ids,
              device: torch.device):
    """Train, val and test samplers. Device samplers over one table on the
    device, stored as :func:`table_storage` says; ``--augment`` augments
    the train support set only (the jitter at scale 0.1, or on raw images
    the flip and crop). With ``--tpu_host_sampler``, host samplers over
    the numpy table (seeds ``seed``, ``seed + 1``, ``seed + 2``), the
    train sampler behind ``--num_workers`` loader processes (native
    backend, no augmentation) or a prefetch thread, as the JAX driver
    chooses."""
    cs = splits["train"]
    train_spec, eval_spec = _specs(cfg, cs.text_features.shape[-1],
                                   cs.text_is_tokens)
    if not cfg.device_sampler:
        return _host_samplers(cfg, splits, image_table, image_ids, device,
                              train_spec, eval_spec)
    table = table_storage(torch.as_tensor(np.asarray(image_table)),
                          cfg.compute_dtype).to(device)
    ids = torch.as_tensor(np.asarray(image_ids)).to(device)
    kw = dict(use_pallas_gather=cfg.pallas_gather,
              allow_replacement=cfg.allow_replacement, device=device)
    return (DeviceEpisodeSampler(table, ids, splits["train"], train_spec,
                                 augment_scale=0.1 if cfg.augment else 0.0,
                                 **kw),
            DeviceEpisodeSampler(table, ids, splits["val"], eval_spec, **kw),
            DeviceEpisodeSampler(table, ids, splits["test"], eval_spec, **kw))


def _host_samplers(cfg: Config, splits, image_table, image_ids, device,
                   train_spec, eval_spec):
    ar, be = cfg.allow_replacement, cfg.sampler_backend
    kw = dict(allow_replacement=ar, backend=be, device=device)
    train = HostEpisodeSampler(image_table, image_ids, splits["train"],
                               train_spec, seed=cfg.seed,
                               augment_scale=0.1 if cfg.augment else 0.0,
                               **kw)
    # "auto" resolves per machine, and the two backends' streams differ
    print(f"host sampler backend: {train.backend_name} "
          f"(--tpu_sampler_backend {be}; streams are backend-specific "
          "per seed)")
    if cfg.evaluate:
        pass  # --evaluate never draws a train episode: start no loader
    elif cfg.num_workers > 1 and train.backend_name == "native" \
            and train.augment_scale == 0.0:
        train = MultiprocessSampler(train, num_workers=cfg.num_workers,
                                    mp_context=cfg.loader_mp_context)
        print(f"loader: {cfg.num_workers} worker processes "
              f"({cfg.loader_mp_context})")
    elif cfg.num_workers > 0:
        train = PrefetchingSampler(train, depth=2 * cfg.num_workers)
        print("loader: prefetch thread")
    return (train,
            HostEpisodeSampler(image_table, image_ids, splits["val"],
                               eval_spec, seed=cfg.seed + 1, **kw),
            HostEpisodeSampler(image_table, image_ids, splits["test"],
                               eval_spec, seed=cfg.seed + 2, **kw))


def _save_predictions_csv(cfg: Config, writer: MetricWriter,
                          results_path: str, test_m: dict) -> Optional[str]:
    """The prediction artifact, one ``run_*.csv`` in the reference's shape:
    one row per evaluated task, columns ``support_idx, support_lamda,
    query_idx, query_preds, query_targets`` (``support_lamda`` only where
    the model computes it), each cell the task's list of values, and an
    unnamed index column: the bytes the JAX package's ``DataFrame.to_csv``
    writes, here with the ``csv`` module."""
    if "preds" not in test_m:
        return None
    nk = cfg.num_ways * cfg.num_shots
    nq = cfg.num_ways * cfg.num_query_eval

    def rows(flat, width):
        if flat is None or len(flat) == 0:
            return None
        return np.asarray(flat).reshape(-1, width).tolist()

    cols = {
        "support_idx": rows(test_m.get("support_idx"), nk),
        "support_lamda": rows(test_m.get("support_lamdas"), nk),
        "query_idx": rows(test_m.get("query_idx"), nq),
        "query_preds": rows(test_m.get("preds"), nq),
        "query_targets": rows(test_m.get("targets"), nq),
    }
    cols = {k: v for k, v in cols.items() if v is not None}
    stem = (writer.run_name if writer.run_name.startswith("run_")
            else f"run_{writer.run_name}")
    path = os.path.join(results_path, f"{stem}.csv")
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator=os.linesep)
        out.writerow([""] + list(cols))
        for i, cells in enumerate(zip(*cols.values())):
            out.writerow([i] + [str(c) for c in cells])
    return path


class _NullWriter:
    """The writer of a spawned rank other than rank 0: rank 0's run name,
    and nothing written."""

    def __init__(self, run_name: str):
        self.run_name = run_name
        self.summary: dict = {}

    def log(self, metrics, step=None) -> None:
        pass

    def log_arrays(self, arrays, step=None) -> None:
        pass

    def flush(self) -> None:
        pass

    def finish(self) -> None:
        pass


def _spawned_form(cfg: Config) -> bool:
    """``--tpu_mesh_dp N``/``--tpu_mesh_mp M`` in one process: the driver
    starts the ``N · M`` ranks itself."""
    return (not distributed.is_initialized()
            and max(cfg.mesh_dp, 1) * cfg.mesh_mp > 1)


def _driver_rank(rank: int, cfg: Config) -> dict:
    """One rank of the driver's spawned world; ranks other than 0 print
    nothing."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    return main(cfg, distributed.rank_device())


def _spawn_driver(cfg: Config) -> dict:
    from fumi_tpu_torch.parallel.launch import spawn_world
    dp, mp = max(cfg.mesh_dp, 1), cfg.mesh_mp
    n = dp * mp
    if not cfg.disable_cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError("CUDA is not available; pass --disable_cuda "
                               "to run the ranks on the CPU")
        if n > have:
            raise ValueError(f"mesh ({dp}x{mp}) needs {n} devices, have "
                             f"{have}")
    print(f"spawning {n} ranks for the ({dp}, {mp}) mesh "
          f"({'cuda' if not cfg.disable_cuda else 'cpu'})", flush=True)
    return spawn_world(_driver_rank, n, cfg,
                       use_cuda=not cfg.disable_cuda)[0].value


def main(cfg: Config, device: DeviceLike = None) -> dict:
    """Train (unless ``--evaluate``) and test one run; returns the test
    metrics as ``{"test/<name>": value}``."""
    cfg = cfg.validate()
    _check_driver(cfg)
    if _spawned_form(cfg):
        return _spawn_driver(cfg)
    dev = resolve_device("cpu" if cfg.disable_cuda else device)
    results_path = os.path.join(cfg.log_dir, "results")
    os.makedirs(results_path, exist_ok=True)
    if distributed.writes_run():
        writer = MetricWriter(
            results_path,
            use_wandb=not cfg.wandb_offline and distributed.is_primary(),
            offline=cfg.wandb_offline, run_suffix=distributed.process_tag(),
            wandb_kwargs=dict(entity=cfg.wandb_entity,
                              project=cfg.wandb_project,
                              group=cfg.wandb_experiment,
                              job_type="eval" if cfg.evaluate else "train"))
    else:
        writer = None
    if distributed.spawned():
        # the ranks of a spawned world run in rank 0's run dir
        name = distributed.broadcast_object(writer.run_name if writer
                                            else None)
        writer = writer or _NullWriter(name)
    try:
        return _run(cfg, dev, writer, results_path)
    finally:
        writer.finish()


def adopt_raw_geometry(cfg: Config, image_table) -> Config:
    """A raw table's stored geometry, not the flags, sets the backbone's
    image size and channels (``--tpu_im_size`` still sizes synthetic
    tables); the backbones take square images only."""
    if cfg.im_encoder not in RAW_IMAGE_ENCODERS or np.ndim(image_table) != 4:
        return cfg
    _, h, w, c = np.shape(image_table)
    if h != w:
        raise ValueError(f"raw image table is {h}x{w}; conv backbones "
                         "assume square images")
    if (h, c) != (cfg.im_size, cfg.im_channels):
        cfg = dataclasses.replace(cfg, im_size=h, im_channels=c)
        print(f"raw images: adopting stored geometry {h}x{w}x{c}")
    return cfg


def _run(cfg: Config, dev: torch.device, writer: MetricWriter,
         results_path: str) -> dict:
    splits, image_table, image_ids, dictionary = _load_data(cfg)
    cfg = adopt_raw_geometry(cfg, image_table)
    run_dir = os.path.join(cfg.log_dir, "runs", writer.run_name)
    if distributed.writes_run():
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1, default=str)
        if cfg.text_encoder in TOKEN_TEXT_ENCODERS and dictionary:
            # the vocabulary ships with the run, so serving rebuilds the
            # encoder without the dataset (the trained table is in the
            # checkpoint)
            with open(os.path.join(run_dir, "vocab.json"), "w") as f:
                json.dump(dict(dictionary), f)
    if cfg.model == "clip":
        return _run_clip(cfg, dev, writer, run_dir, splits, image_table)

    if cfg.seed_sweep > 1:
        # S replicas in lockstep, each the standalone run of its seed
        samplers = _samplers(cfg, splits, image_table, image_ids, dev)
        try:
            return sweep_main(cfg, dictionary, samplers, writer, run_dir,
                              results_path, dev)
        finally:
            # stop the loader processes or the prefetch thread
            for smp in samplers:
                close = getattr(smp, "close", None)
                if close is not None:
                    close()

    steps = _make_steps(cfg, dev, dictionary)
    train_s, val_s, test_s = _samplers(cfg, splits, image_table, image_ids,
                                       dev)

    params = steps.params
    restored_opt_state = None
    resume_meta = {}
    if cfg.checkpoint:
        ckpt_dir = ckpt_lib.resolve_checkpoint(
            cfg.checkpoint, cfg.model, entity=cfg.wandb_entity,
            project=cfg.wandb_project)
        params, restored_opt_state, _ = ckpt_lib.load_checkpoint(
            ckpt_dir, params, steps.opt.init(params), best=True)
        steps = steps._replace(params=params)
    elif cfg.auto_resume and not cfg.evaluate:
        # continue the newest checkpointed run of this family in this
        # log_dir: its LATEST state (ckpt/), batch counter and best loss
        prev = ckpt_lib.find_latest_resumable(cfg.log_dir, model=cfg.model)
        if prev is not None:
            try:
                params, restored_opt_state, resume_meta = \
                    ckpt_lib.load_checkpoint(
                        prev, params, steps.opt.init(params), best=False)
            except ValueError as e:
                # an incompatible checkpoint (other widths of the same
                # family) starts fresh rather than dying at startup
                print(f"auto-resume: cannot restore {prev} ({e}); "
                      "starting fresh")
                restored_opt_state, resume_meta, prev = None, {}, None
        if prev is not None:
            steps = steps._replace(params=params)
            # carry the interrupted run's best/ forward, so the reload
            # after training works even if this segment never improves
            for n in (("best", "best.meta.json")
                      if distributed.writes_run() else ()):
                src, dst = os.path.join(prev, n), os.path.join(run_dir, n)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                elif os.path.exists(src):
                    shutil.copyfile(src, dst)
            print(f"auto-resume: {prev} "
                  f"(batch {resume_meta.get('batch_idx')})")

    try:
        if not cfg.evaluate:
            with profile_trace(cfg.profile_dir):
                params = training_run(
                    cfg, steps, train_s, val_s, writer, run_dir, cfg.seed,
                    opt_state=restored_opt_state,
                    start_batch=int(resume_meta.get("batch_idx", -1)) + 1,
                    initial_best=resume_meta.get("best_loss"))
    finally:
        # stop the loader processes or the prefetch thread
        close = getattr(train_s, "close", None)
        if close is not None:
            close()
    if cfg.evaluate and restored_opt_state is not None:
        # --evaluate from a checkpoint: under --tpu_ema the smoothed
        # weights live in the restored optimizer state
        params = eval_view(cfg, params, restored_opt_state)

    test_m = test_loop(cfg, steps, params, test_s, cfg.max_test_batches,
                       stream_generator(cfg.seed, TEST, 0, dev),
                       collect_artifacts=True)
    scalars = {k: v for k, v in test_m.items()
               if isinstance(v, (int, float))}
    print(f"\n TEST: {scalars}")
    writer.log({f"test/{k}": v for k, v in scalars.items()})
    if distributed.writes_run():
        _save_predictions_csv(cfg, writer, results_path, test_m)
    return {f"test/{k}": v for k, v in scalars.items()}


def _make_steps(cfg: Config, dev: torch.device, dictionary):
    """The steps of the mesh the world and the flags give, decided before
    any is built (the JAX driver's order): mp > 1 the 2-D engine, dp > 1
    the episode-parallel engine, else the serial steps. A world's ranks
    must all sit on the mesh."""
    gen = torch.Generator().manual_seed(cfg.seed)
    world = distributed.world_size()
    dp, mp = cfg.mesh_dp, cfg.mesh_mp
    if dp == 0 and world > 1:
        # auto: the largest dp that divides the meta-batch and fits the
        # ranks left over by the model axis
        dp = mesh_lib.auto_dp(cfg.batch_size, max(1, world // mp))
    dp = max(dp, 1)
    if dp * mp == 1:
        return make_steps(cfg, gen, device=dev, dictionary=dictionary)
    if dp * mp != world:
        raise ValueError(
            f"mesh ({dp}x{mp}) must cover the world's {world} ranks: one "
            "rank is one device of the mesh")
    mesh = mesh_lib.make_mesh(dp, mp)
    print(f"mesh: dp={dp} x mp={mp} over {world} ranks "
          f"({distributed.backend()})")
    if mp > 1:
        from fumi_tpu_torch.parallel.pjit_engine import make_pjit_steps
        return make_pjit_steps(cfg, gen, mesh, dev, dictionary)
    from fumi_tpu_torch.parallel.engine import make_parallel_steps
    return make_parallel_steps(cfg, gen, mesh, dev, dictionary)


def _run_clip(cfg: Config, dev: torch.device, writer: MetricWriter,
              run_dir: str, splits, image_table) -> dict:
    """CLIP: restore ``--checkpoint``, train unless ``--evaluate``, then
    the retrieval test pass; returns ``{"test/acc": acc}``."""
    model, params = clip_loop.make_clip(
        cfg, torch.Generator().manual_seed(cfg.seed))
    params = {k: v.to(dev) for k, v in params.items()}
    opt = init_optim(cfg.optim, cfg.lr, cfg.weight_decay, cfg.momentum)
    data = {s: (supervised_from_class_set(splits[s]), image_table)
            for s in ("train", "val", "test")}
    if cfg.checkpoint:
        ckpt_dir = ckpt_lib.resolve_checkpoint(
            cfg.checkpoint, cfg.model, entity=cfg.wandb_entity,
            project=cfg.wandb_project)
        params, _, _ = ckpt_lib.load_checkpoint(ckpt_dir, params,
                                                opt.init(params), best=True)
    clip_mesh = None
    world = distributed.world_size()
    if world > 1:
        # rows over every rank (the JAX driver's auto dp over its devices)
        dp = mesh_lib.auto_dp(cfg.batch_size, world)
        if dp != world:
            raise ValueError(f"CLIP shards --batch_size {cfg.batch_size} "
                             f"over all {world} ranks; it must divide it")
        clip_mesh = mesh_lib.make_mesh(dp, 1)
    if not cfg.evaluate:
        params = clip_loop.training_run(
            cfg, model, params, opt, data["train"], data["val"], writer,
            run_dir, np.random.RandomState(cfg.seed), mesh=clip_mesh)
    test_acc = clip_loop.evaluate(cfg, model, params, data["test"])
    print(f"\n TEST: test acc: {test_acc}")
    writer.log({"test/acc": test_acc})
    return {"test/acc": test_acc}


def cli(argv=None) -> dict:
    cfg = config_from_args(argv)
    # a --tpu_dist_* (or torchrun) world comes up before any device use
    if distributed.initialize_from_config(cfg):
        dev = distributed.rank_device()
    else:
        dev = resolve_device("cpu" if cfg.disable_cuda else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"running on {dev} ({name}){distributed.describe()}", flush=True)
    out = main(cfg, dev)
    distributed.shutdown(wait=True)
    return out


if __name__ == "__main__":
    cli(sys.argv[1:])
