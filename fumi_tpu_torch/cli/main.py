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

Not ported yet, each rejected with ``NotImplementedError`` naming its
ROADMAP.md Queue 1 item: the host samplers (item 4b), multi-device and
sweep modes (item 9), and the training extensions of item 10 (EMA,
skipping non-finite steps, NaN debugging).
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

from fumi_tpu_torch.core.config import (Config, TOKEN_TEXT_ENCODERS,
                                        config_from_args)
from fumi_tpu_torch.models import RAW_IMAGE_ENCODERS
from fumi_tpu_torch.core.episode import EpisodeSpec
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.data.cub import load_cub
from fumi_tpu_torch.data.inat_anim import load_inat_anim
from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler, table_storage
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
from fumi_tpu_torch.utils.profiling import profile_trace


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md "
        f"Queue 1, {item})")


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
    if not cfg.device_sampler:
        raise _not_ported("--tpu_host_sampler", "item 4b: the host samplers")
    if cfg.seed_sweep > 1 or cfg.mesh_dp > 1 or cfg.mesh_mp > 1 or \
            cfg.dist_coordinator is not None or cfg.dist_num_processes > 0:
        raise _not_ported("--tpu_seed_sweep/--tpu_mesh_*/--tpu_dist_*",
                          "item 9: scale-out extensions")
    if cfg.grad_accum > 1 or cfg.watch:
        raise _not_ported("--tpu_grad_accum > 1 / --tpu_watch",
                          "item 9: scale-out extensions")
    if cfg.ema > 0 or cfg.skip_nonfinite > 0 or cfg.debug_nans:
        raise _not_ported("--tpu_ema/--tpu_skip_nonfinite/--tpu_debug_nans",
                          "item 10: training extensions")


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
    """Train, val and test device samplers over one table on the device,
    stored as :func:`table_storage` says; ``--augment`` augments the train
    support set only (the jitter at scale 0.1, or on raw images the flip
    and crop)."""
    cs = splits["train"]
    train_spec, eval_spec = _specs(cfg, cs.text_features.shape[-1],
                                   cs.text_is_tokens)
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


def main(cfg: Config, device: DeviceLike = None) -> dict:
    """Train (unless ``--evaluate``) and test one run; returns the test
    metrics as ``{"test/<name>": value}``."""
    cfg = cfg.validate()
    _check_driver(cfg)
    dev = resolve_device("cpu" if cfg.disable_cuda else device)
    results_path = os.path.join(cfg.log_dir, "results")
    os.makedirs(results_path, exist_ok=True)
    writer = MetricWriter(
        results_path, use_wandb=not cfg.wandb_offline,
        offline=cfg.wandb_offline,
        wandb_kwargs=dict(entity=cfg.wandb_entity, project=cfg.wandb_project,
                          group=cfg.wandb_experiment,
                          job_type="eval" if cfg.evaluate else "train"))
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

    steps = make_steps(cfg, torch.Generator().manual_seed(cfg.seed),
                       device=dev, dictionary=dictionary)
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
            for n in ("best", "best.meta.json"):
                src, dst = os.path.join(prev, n), os.path.join(run_dir, n)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                elif os.path.exists(src):
                    shutil.copyfile(src, dst)
            print(f"auto-resume: {prev} "
                  f"(batch {resume_meta.get('batch_idx')})")

    if not cfg.evaluate:
        with profile_trace(cfg.profile_dir):
            params = training_run(
                cfg, steps, train_s, val_s, writer, run_dir, cfg.seed,
                opt_state=restored_opt_state,
                start_batch=int(resume_meta.get("batch_idx", -1)) + 1,
                initial_best=resume_meta.get("best_loss"))
    elif restored_opt_state is not None:
        params = eval_view(cfg, params, restored_opt_state)

    test_m = test_loop(cfg, steps, params, test_s, cfg.max_test_batches,
                       stream_generator(cfg.seed, TEST, 0, dev),
                       collect_artifacts=True)
    scalars = {k: v for k, v in test_m.items()
               if isinstance(v, (int, float))}
    print(f"\n TEST: {scalars}")
    writer.log({f"test/{k}": v for k, v in scalars.items()})
    _save_predictions_csv(cfg, writer, results_path, test_m)
    return {f"test/{k}": v for k, v in scalars.items()}


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
    if not cfg.evaluate:
        params = clip_loop.training_run(
            cfg, model, params, opt, data["train"], data["val"], writer,
            run_dir, np.random.RandomState(cfg.seed))
    test_acc = clip_loop.evaluate(cfg, model, params, data["test"])
    print(f"\n TEST: test acc: {test_acc}")
    writer.log({"test/acc": test_acc})
    return {"test/acc": test_acc}


def cli(argv=None) -> dict:
    cfg = config_from_args(argv)
    dev = resolve_device("cpu" if cfg.disable_cuda else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"running on {dev} ({name})")
    return main(cfg, dev)


if __name__ == "__main__":
    cli(sys.argv[1:])
