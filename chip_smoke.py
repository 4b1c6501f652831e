#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fumi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. the card: name and power limit from ``nvidia-smi``;
2. build every CUDA kernel of the port from ``fumi_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once), print ``ptxas``'s
   registers and spills, and the cluster plan of the fused adaptation
   kernel (blocks per task, shared memory, the depth of its W1 tiles and
   its query chunks, where a block's private buffers live, how many such
   clusters the card holds at once);
3. hold each kernel wrapper against its plain PyTorch version on the card,
   at the shapes the flagship paths give it, with TF32 off:
   ``fused_adapt`` (both head forms, B=4, served R=4 and R=1) and
   ``fused_maml_adapt_batched`` within 1e-3 with the same argmax and no
   more than twice as far from the same loop in fp64 as the plain version,
   ``gather_rows``, ``augment_embeddings``, ``gather_augment_rows`` and
   ``gather_episode_rows`` bitwise (fp32, bf16 and uint8 tables, several
   widths, seeds and row offsets; the episode at the train and eval
   shapes, with and without the jitter), and the sampler's ``--augment``
   jitter through the episode's one launch (support only, queries clean);
4. drive the serving path (``FewShotClassifier``) at the flagship width
   (FuMI, BERT text 768, image 2048, im_hid (256, 64), 5-way 5-shot,
   100-step adaptation) with seeded random weights, then MAML; check the
   answers against the same classifier's autograd engine;
5. drive the meta-training path (``make_chunked_train`` on the device
   sampler with the kernel gather; B=4, 32 queries per class, 5
   second-order inner steps, Adam) for FuMI, then MAML, without and with
   the ``--augment`` jitter (one ``gather_episode_rows`` launch a step
   either way), FuMI ``--augment`` also on the library gather (the
   standalone ``augment_embeddings`` kernel), and hold one train step on
   the card against the same step on the CPU;
6. drive the eval path (``make_chunked_eval`` with the fused kernels, 100
   steps, 20 queries per class: FuMI through ``fused_adapt``, MAML
   through ``fused_maml_adapt_batched``) and hold it against the same
   episodes through the autograd engine;
7. drive the experiment driver, ``fumi_tpu_torch.cli.main``, for FuMI and
   MAML at the flagship width on ``--dataset synthetic --augment
   --tpu_pallas_gather --tpu_pallas_fused_eval`` (21 train steps, evals at
   batches 10 and 20, a 9-meta-batch test pass), then FuMI ``--evaluate
   --checkpoint`` on the run it wrote;
7a. serve from the FuMI and MAML run dirs the driver just wrote
   (``FewShotClassifier.from_checkpoint``, then ``reload(best=False)``):
   a flagship request bitwise (or within 1e-6) the answer of a classifier
   on ``load_checkpoint``'s params, one ``fused_adapt`` launch a request;
7b. serve FuMI over HTTP (``serve_http.make_server`` on 127.0.0.1 in a
   thread): health says cuda, ``/v1/episode`` gives the in-process labels
   and probabilities within 1e-5, ``/v1/episode_batch``, ``/v1/adapt``,
   ``/v1/classify`` and ``/v1/reload`` answer, concurrent requests run one
   at a time on worker threads; the request's median latency through HTTP
   beside the in-process call;
7c. train and evaluate AM3 (BERT text 768, prototype_dim 64, text_hid
   256, dropout 0.25), ProtoNet and MatchingNet at the flagship width on
   the device sampler with the kernel gather, without and with
   ``--augment`` (one ``gather_episode_rows`` a step or meta-batch, no
   other kernel), hold one AM3 train step against the CPU and profile an
   AM3 step;
7d. the driver for AM3 at the parser's defaults (``--augment
   --tpu_pallas_gather``, phase 7's epochs), then AM3 ``--evaluate
   --checkpoint``: the TEST line, the CSV with ``support_lamda``;
7e. CLIP at the parser's widths (text 768, image 2048, latent 512): one
   train step card against CPU; the driver (``--model clip --batch_size
   64 --epochs 3``: ``ckpt/``, ``best/``, the TEST line) and
   ``--evaluate`` reproducing its accuracy exactly; ``ClipRetrieval``
   from that run (index the 2048-row table, retrieve 100 texts top-5
   against the CPU, ``similarity`` bitwise ``model.forward``);
   ``ClipService`` on loopback (409 before an index, every route against
   the in-process answers); train steps/s and the busy share, index and
   retrieve ms, HTTP retrieve beside in process. No kernel launches;
7f. the token text encoders at the full width for FuMI and AM3 (RNN:
   300-wide embeddings into 2 × 384; glove: 300, mean pooling; RNNhid and
   w2v once each) on the driver's synthetic tokens, padded to every
   length 1..12: training on the device sampler (one
   ``gather_episode_rows`` a step, the frozen encoder bitwise unchanged),
   one FuMI and one AM3 RNN step card against CPU, a FuMI RNN
   ``--fine_tune`` step, FuMI RNN eval through ``fused_adapt`` against the
   engine, a served request with descriptions of mixed length through
   ``fused_adapt`` against the engine, the driver for FuMI RNN and AM3
   glove (``vocab.json``), serving the FuMI run dir in process and over
   HTTP (400 without ``support_text`` and for a token id outside the
   embedding table, the next request still answered as before); train
   episodes/s beside the BERT runs, the encoder's device ms a meta-batch,
   the busy share;
7g. the real datasets' layouts at their published scale, on fixture
   files written here: the driver on ``--dataset cub`` (200 classes,
   11,788 x 2048 fp32, split 100/50/50) for MAML (one
   ``gather_episode_rows`` a step and a meta-batch, one
   ``fused_maml_adapt_batched`` a meta-batch) and ProtoNet, the CSV's
   query rows from the test classes, train episodes/s through the
   driver's loader and samplers; iNat-Anim (673 species, 195,605 images,
   a BERT artifact, the 1.60 GB table on the card) built by the loader's
   table-building part, FuMI training and eval through ``fused_adapt``
   on the driver's samplers and steps, CLIP for one epoch of the
   supervised split, ``prepare vectors`` on 300-wide GloVe text and FuMI
   RNN on those vectors;
7h. ANIL, Reptile, iMAML-MAML and iMAML-FuMI (``--dropout 0``): training
   (one ``gather_episode_rows`` a step), the busy share, a train step
   card against CPU, Reptile's eval through ``fused_maml_adapt_batched``
   against the engine, the driver, a request served from its run dir
   (Reptile through ``fused_adapt`` against the engine, the others
   through the engine against the CPU);
7i. a family registered by a module the driver imports
   (``--tpu_import``), trained on the card and served through its
   ``Family.serve`` hook;
7j. the bf16 policy (``--tpu_compute_dtype bfloat16``) at the flagship
   widths: the product's cuBLAS route (bf16 GEMM, fp32 output) against
   the emulation; the table stored in bf16; FuMI, MAML and AM3 training
   (one ``gather_episode_rows`` a step), FuMI and MAML steps card against
   CPU, eval and a served FuMI request through the engine (the fused
   kernels compute fp32 only), CLIP steps;
7k. conv4 at 84×84×3 in fp32 and bf16: MAML training (B=4, 5
   second-order steps) with its busy share, a step card against CPU, an
   eval meta-batch and a served request through the engine; FuMI, AM3,
   ProtoNet, and MAML under ``--augment`` (the flip and crop);
7l. resnet12 (64, 160, 320, 640) at 84×84×3: MAML with ``--tpu_remat
   auto`` and ``off``, the loss and meta-gradient equal, the peak memory
   and episodes/s of each, a served request;
7m. the raw iNat-Anim layout: 195,605 uint8 images of 84×84×3 (4.14
   GB) through the loader's table-building part, ``gather_episode_rows``
   past 2³¹ bytes bitwise, and the conv4 MAML driver on it (the stored
   geometry adopted);
7n. the driver for conv4 MAML and FuMI and for FuMI in bf16, their run
   dirs served (card against CPU), one raw request over HTTP;
7o. ``--tpu_ema 0.999 --tpu_skip_nonfinite 3`` for FuMI and MAML at the
   flagship width: train episodes/s beside the same chunk without the
   flags, the EMA against its recomputation from the step's params, an
   episode with a NaN row that changes nothing and counts 1, eval of the
   EMA through the fused kernels against the engine, the FuMI driver
   with the flags and its run dir served (the EMA, through
   ``fused_adapt``);
7p. ``--tpu_debug_nans``: a finite chunk bitwise the same with the check
   and without it, a NaN step raising ``FloatingPointError``;
7q. the host samplers: the port's native index sampler built with
   ``g++``, card episodes bitwise the CPU's, ``--augment`` episodes
   through the standalone ``augment_embeddings`` kernel against its plain
   version, FuMI train episodes/s at ``--num_workers`` 0, 1 and 4 beside
   the device sampler (the flagship table and an iNat-Anim-sized one of
   195,605 rows), FuMI and MAML eval through the fused kernels on host
   episodes, the driver with ``--tpu_host_sampler --num_workers 4``;
7r. reference ``.pth.tar`` files: phase 7's FuMI and MAML run dirs
   exported and imported back (params and moments bitwise), ``--evaluate
   --checkpoint x.pth.tar`` (the run dir's test numbers), served from the
   file (bitwise the run dir's answer), ``/v1/reload`` with it (200) and
   with a corrupt file (400), the import's load time;
7s. ``resnet12.STAGE_REMAT_OVERRIDE`` against ``--tpu_remat auto`` at 2
   tasks of 5+5 a class: loss and meta-gradient bitwise, peak memory;
7s-b. ``conv4.BLOCK_REMAT`` on against off at 2 tasks of 5+5 a class
   on deterministic cuDNN, once the step repeats bitwise: the loss
   bitwise, the meta-gradient bitwise for FuMI and for MAML under
   ``--tpu_remat on``, within 1e-5 of its scale for MAML under ``auto``
   (the autograd engine's order moves with the recompute), peak memory;
   then phase 7k's conv4 MAML training (B=4, fp32) off, on, off, on:
   episodes/s, peak memory, busy share and device ms a step, one
   ``gather_episode_rows`` a step;
7t. the seed sweep at S=4 for FuMI and MAML at the flagship width on
   phase 5's sampler: a chunk of 10 lockstep steps (4
   ``gather_episode_rows`` a step), each seed bitwise its standalone
   chunk, MAML ``--tpu_seed_accum 2`` bitwise the ungrouped sweep, a
   frozen seed holding, episodes/s beside one standalone run's, the busy
   share of a sweep step, the sweep's eval through the fused kernels (one
   launch a seed a meta-batch);
7u. the driver with ``--tpu_seed_sweep 4`` for FuMI (phase 7's flags and
   epochs): the report's ``_seed_ci95`` keys, four CSVs, the ``seed<k>/``
   run dirs reproducing each seed's test numbers (seed 0 through
   ``--evaluate --checkpoint``), ``--tpu_auto_resume`` of an interrupted
   sweep equal to the uninterrupted one;
7v. that run dir served as a ``SeedEnsemble`` (``serve_http`` detects
   it): R=1 and R=4 requests through one ``fused_adapt`` launch a replica
   against the engine, over HTTP with ``/v1/reload``, the latency at S=4
   beside one replica's;
7w. FuMI at B=16 with ``--tpu_grad_accum 4`` against the whole batch
   (loss and meta-gradient within 1e-5), the peak memory and episodes/s
   of each;
7x. a FuMI chunk with ``--tpu_watch``: params bitwise the unwatched
   chunk's, the counts summing to the sampled steps × the parameter
   count, episodes/s beside the unwatched chunk;
7y. a FuMI driver run with ``--tpu_profile_dir``: the trace names
   ``gather_episode_rows`` and ``fused_adapt``, and its kernels' device
   time by name;
7z. the multi-device engines (``parallel/``) at the flagship widths with
   dropout 0 (B=4, 5-way 5-shot, 5 second-order inner steps, Adam), the
   ranks started by ``parallel/launch.py:spawn_world``: (a) two ranks
   sharing the card over gloo: one dp=2 step on a held episode against
   the serial step (rtol 2e-4, atol 1e-5), a chunk of 10 steps on each
   rank's own B/dp tasks (one ``gather_episode_rows`` a rank a step) with
   the params bitwise equal across the ranks, train episodes/s beside the
   serial chunk's (in turns), the card's busy share and the packed
   all-reduce's time, eval of 8 held meta-batches through ``fused_adapt``
   (FuMI) and ``fused_maml_adapt_batched`` (MAML) on each rank's tasks
   against the serial eval (loss 1e-5, acc 1e-6, preds equal) and a chunk
   of the ranks' own draws; (b) dp=1 x mp=2 steps of FuMI and MAML (wide
   weights sharded, Megatron's row-parallel product) against the serial
   step; (e) a CLIP SGD step over the ranks' rows against the serial step,
   a CLIP epoch, and an S=4 sweep (two seeds a rank) whose every seed is
   bitwise the single-rank sweep's; (c) a one-rank NCCL world's dp chunk
   bitwise the serial chunk; (d) the driver as two ``--tpu_dist_*``
   processes on the card: identical ``TEST`` lines, run dirs ``-p0`` and
   ``-p1`` with ``ckpt/``. The ranks' launches are summed by path;
7zs. the batched request sharded over the ranks of phase 7z
   (``FewShotClassifier(..., mesh=make_mesh(2, 1))``): FuMI and MAML at
   the flagship serving config on the seed-0 weights, a request of 8
   episodes (M=100), 4 a rank, on the two gloo ranks and on the one-rank
   NCCL world; every rank's whole answer against the single-rank request
   in this process (bitwise expected, else within 2e-4 of the logit
   scale), the gloo ranks' answers bitwise alike, one ``fused_adapt`` a
   rank a request; host ms beside the single-rank request's and the
   answer's gather alone;
7zn. ``norm_relu_pool`` (``csrc/norm_relu_pool.cu``, conv4's norm, ReLU
   and pool): at ``conv4.train``'s eight shapes its forward, backward and
   double backward against the plain versions on the card, each alone
   with CUDA events beside its bytes bound and the plain version's time;
   then a second-order conv4 MAML step (B=4, 5-way 5-shot, 32 queries a
   class, 5 steps) through the op and through the written-out chain
   (device ms and operations a step, peak memory) and the op's launches a
   step (:func:`norm_relu_pool_phase`; alone: ``python3 -c 'import
   chip_smoke; chip_smoke.norm_relu_pool_alone()'``);
8. time each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, and each path; time a
   FuMI R=1 request through ``fused_adapt`` and through the autograd
   engine at 1, 2, 4, 8 and 16 adaptation steps (the crossover that
   ``ops/kernels.py:MIN_FUSED_STEPS`` holds); at the support set's shape
   time ``gather_rows``, ``augment_embeddings``, the two in sequence and
   ``gather_augment_rows``; at the train and eval episodes, with and
   without the jitter, time ``gather_episode_rows`` against the two
   launches it replaced, one ``index_select`` over the same rows and two;
   each beside its bound; and profile an augmented train step through the
   one launch and through the two launches it replaced, on the same
   episodes (device time and operations a step); time
   ``gather_episode_rows`` on the bf16 table and on raw rows (fp32, bf16,
   uint8) beside ``index_select`` and the bytes bound;
9. print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Every path of phases 4-7zs sets the kernels' launch counts to 0 just
before it runs and reads them just after (phases 7z and 7zs in each rank,
the ranks' counts summed; the two driver processes of 7z (d) report
none); it fails if it did not launch each kernel it runs, as many times as
the path runs it.

It imports no JAX. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# fp32 on the CUDA cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# flagship serving shapes (fumi_tpu/core/config.py defaults)
B, WAYS, SHOTS, QN = 4, 5, 5, 100
D, E, TH, H1, H2 = 2048, 768, 256, 256, 64
STEPS, STEP_SIZE = 100, 0.01
S = WAYS * SHOTS
# flagship meta-training and eval (bench.py:25-44): 32 train queries per
# class, 5 second-order inner steps, Adam at 3e-5 with coupled L2 5e-4,
# dropout 0.25; eval 20 queries per class; the table is 64 classes of 64
# images (4096 x 2048 fp32, 32 MiB on the card)
TRAIN_Q, EVAL_Q, INNER_STEPS, LR = 32, 20, 5, 3e-5
TRAIN_CHUNK, EVAL_BATCHES = 50, 8
TABLE_CLASSES, TABLE_IMAGES = 64, 64
AUG_SCALE = 0.1  # the driver's --augment scale
KERNEL_NAMES = ("fused_adapt", "gather_rows", "augment_embeddings",
                "gather_augment_rows", "fused_maml_adapt_batched",
                "gather_episode_rows")
# fused_adapt and fused_maml_adapt_batched launch the one kernel of
# csrc/fused_adapt.cu; gather_rows, gather_augment_rows and
# gather_episode_rows are the three entry points of csrc/gather_rows.cu's
# one kernel body; augment_embeddings is csrc/augment_embeddings.cu
SOURCES = ("fused_adapt", "gather_rows", "augment_embeddings",
           "norm_relu_pool")
CROSSOVER_STEPS = (1, 2, 4, 8, 16)
# the driver phase: --epochs 20 --eval_freq 10 --num_ep_test 32 at B=4 runs
# 21 train steps, 3 validation passes of 8 // 2 + 1 meta-batches (before
# training, at batches 10 and 20) and a test pass of 8 + 1
DRIVER_EPOCHS, DRIVER_EVAL_FREQ, DRIVER_EP_TEST = 20, 10, 32
DRIVER_TRAIN_STEPS = DRIVER_EPOCHS + 1
DRIVER_TEST_BATCHES = DRIVER_EP_TEST // B + 1
DRIVER_EVAL_BATCHES = 3 * (DRIVER_EP_TEST // B // 2 + 1) + DRIVER_TEST_BATCHES
# phase 7e, CLIP at the parser's widths (text E, image D, latent 512): the
# driver's batches and epochs (lr 1e-3, so that 3 epochs improve on the
# first validation and write best/), 100 texts ranked top-5 against the
# 2048-row table, 256 gallery rows over HTTP; scores within 1e-5
CLIP_BATCH, CLIP_EPOCHS, CLIP_LR = 64, 3, 1e-3
CLIP_TEXTS, CLIP_TOP_K, CLIP_HTTP_ROWS, CLIP_TOL = 100, 5, 256, 1e-5
# phase 7f, the token encoders: the driver's synthetic tokens (12 a class,
# a vocabulary of 128), chunks of 20 train steps
TOKEN_LEN, TOKEN_VOCAB, TOKEN_CHUNK = 12, 128, 20
TOKEN_CASES = (("fumi", "RNN"), ("am3", "RNN"), ("fumi", "glove"),
               ("am3", "glove"), ("fumi", "RNNhid"), ("am3", "w2v"))
# phase 7g, the real datasets' layouts at their published scale: CUB_200_2011
# (200 classes, 11,788 images, split 100/50/50) and iNat-Anim (673 species,
# 195,605 images, the paper's counts); train chunks of 20 steps; 300-wide
# GloVe vectors for FuMI RNN, 5 train steps
CUB_CLASSES, CUB_ROWS, CUB_SPLIT = 200, 11788, (100, 50, 50)
INAT_CLASSES, INAT_IMAGES = 673, 195605
DATA_CHUNK, GLOVE_DIM, VECTOR_STEPS = 20, 300, 5
# phase 7h, the meta-gradient variants: (name, family, config, driver flags);
# their drivers at half phase 7's depth (11 train steps, 3 validation passes
# of 2 meta-batches, a test pass of 3), as ANIL and iMAML evaluate through
# the autograd engine's 100 steps
VARIANT_EPOCHS, VARIANT_EVAL_FREQ, VARIANT_EP_TEST = 10, 5, 8
VARIANTS = (
    ("anil", "maml", {"adapt_params": "head"},
     ("--tpu_adapt_params", "head")),
    ("reptile", "maml", {"meta_grad": "reptile"},
     ("--tpu_meta_grad", "reptile")),
    ("imaml-maml", "maml", {"meta_grad": "imaml"},
     ("--tpu_meta_grad", "imaml")),
    ("imaml-fumi", "fumi", {"meta_grad": "imaml", "dropout": 0.0},
     ("--tpu_meta_grad", "imaml", "--dropout", "0")))
# phases 7j-7n, the bf16 policy and the raw-image backbones at the JAX
# package's defaults: 84x84x3 images (84·84·3 = 21,168 elements a row);
# raw tables of 512 rows for the kernel holds; train chunks of 5 steps
# (resnet12: 2); 20 queries in a raw request; 5 CLIP steps in bf16
RAW_SIZE, RAW_CHANNELS = 84, 3
RAW_ROW = RAW_SIZE * RAW_SIZE * RAW_CHANNELS
RAW_TABLE_ROWS, RAW_CHUNK, RESNET_CHUNK = 512, 5, 2
RAW_REQUEST_Q, CLIP_BF16_STEPS = 20, 5
# the card against fp64 (hold_step_vs_fp64, served_vs_fp64): no farther
# than twice the CPU plus this share of the scale
FP64_SLACK = {"float32": 2e-2, "bfloat16": 5e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the card, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fns, replays: int = 5) -> float:
    """Median device milliseconds of one call in ``fns``: the calls are
    captured once into a CUDA graph and replayed, so the host's launch
    cost stays out of a microsecond kernel's time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    return statistics.median(times)


def synced_s(fn) -> float:
    """Host seconds of ``fn()`` up to the card's end of its work."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn, names=()):
    """(device ms, device operations, {name: (device us, count)}) of
    ``fn()`` summed over the CUDA entries of a ``torch.profiler`` trace
    (kernels, copies, sets), the last over the entries whose key holds
    each of ``names`` (the first name that matches takes an entry); or
    None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the program's spans appear on the device's timeline too, as user
    # annotations over the kernels they hold: they are not device time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    device_us = sum(getattr(e, "device_time_total", 0) for e in rows)
    if not device_us:
        return None
    by_name = {n: [0.0, 0] for n in names}
    for e in rows:
        n = next((n for n in names if n in e.key), None)
        if n is not None:
            by_name[n][0] += getattr(e, "device_time_total", 0)
            by_name[n][1] += e.count
    return (device_us / 1e3, sum(e.count for e in rows),
            {n: tuple(v) for n, v in by_name.items()})


def host_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the host clock, after one warm-up
    call; for requests, which end in a copy of their result to the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def fused_adapt_cost(b, s, qn, d, h1, h2, n, steps):
    """(flops, bytes) the fused adaptation must do and move: per task-step
    2·S·(2·D·H1 + 3·H1·H2 + 3·H2·N) (forward, and backward to every
    weight), the query forward 2·Qn·(D·H1 + H1·H2 + H2·N); each input read
    once and the logits written once."""
    flops = (b * steps * 2 * s * (2 * d * h1 + 3 * h1 * h2 + 3 * h2 * n)
             + b * 2 * qn * (d * h1 + h1 * h2 + h2 * n))
    floats = (b * s * d + b * s + b * qn * d + h1 * d + h1 + h2 * h1 + h2
              + b * n * h2 + b * n + b * qn * n)
    return flops, 4 * floats


def gather_bytes(m: int, row_bytes: int) -> int:
    """Bytes the row gather must move: M rows read, M rows written, M int32
    indices read; it does no arithmetic."""
    return 2 * m * row_bytes + 4 * m


def augment_cost(m: int, d: int):
    """(fp32 flops, bytes) of the jitter: x read once, the int64 seed read
    once, out written once; 4 fp32 operations an element (u - 1.5, the
    scale, 1 +, x *). Philox's integer operations have no peak in the
    table of published rates, so they are not counted."""
    return 4 * m * d, 2 * 4 * m * d + 8


def gather_augment_cost(m: int, d: int, elem_bytes: int):
    """(fp32 flops, bytes) of the fused support pass: M table rows and M
    int32 indices and the seed read once, M fp32 rows written once; the
    jitter's 4 fp32 operations an element (uint8's 1/255 adds one more,
    not counted)."""
    return 4 * m * d, m * d * elem_bytes + 4 * m + 8 + 4 * m * d


def check_gather_augment(table, dev) -> float:
    """``gather_augment_rows`` against its plain version, bitwise, on the
    flagship table and bf16 and uint8 tables of its shape (and an odd
    width of each), at the flagship support gather (B*S rows), for two
    seeds (the second at a row offset), which must give different
    jitters. Returns the largest |diff|."""
    import torch
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(8)
    u8 = torch.randint(0, 256, tuple(table.shape), generator=gen,
                       dtype=torch.uint8, device=dev)
    tables = {"fp32 D=2048": table, "bf16 D=2048": table.to(torch.bfloat16),
              "uint8 D=2048": u8, "fp32 D=99": table[:, :99].contiguous(),
              "bf16 D=99": table[:, :99].to(torch.bfloat16).contiguous(),
              "uint8 D=99": u8[:, :99].contiguous()}
    m = B * S
    max_err = 0.0
    for label, t in tables.items():
        idx = torch.randint(0, t.shape[0], (m,), generator=gen,
                            dtype=torch.int32, device=dev)
        outs = []
        for seed, offset in ((1, 0), (2 ** 62 - 3, 7)):
            s = torch.tensor([seed], dtype=torch.int64, device=dev)
            got = kernels.gather_augment_rows(t, idx, s, AUG_SCALE, offset)
            want = kernels.gather_augment_rows_reference(t, idx, s,
                                                         AUG_SCALE, offset)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                fail(f"gather_augment_rows differs from its plain version "
                     f"({label}, M={m}, seed {seed}, row offset {offset}): "
                     f"max|diff| {err:.3e}")
            max_err = max(max_err, err)
            outs.append(got)
        if torch.equal(outs[0], outs[1]):
            fail(f"gather_augment_rows: two seeds gave one jitter ({label})")
    print(f"kernel gather_augment_rows [{', '.join(tables)}; "
          f"{table.shape[0]} rows] vs plain: bitwise equal at M={m} for two "
          f"seeds (row offsets 0 and 7), which differ")
    return max_err


def check_episode(table, dev) -> float:
    """``gather_episode_rows`` against its plain version, bitwise, on the
    flagship table and bf16 and uint8 tables of its shape, at the train
    (5+32 a class) and eval (5+20) episodes, without and with the jitter
    (two seeds, which must give different support rows and the same
    queries). Returns the largest |diff|."""
    import torch
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(9)
    tables = {"fp32": table, "bf16": table.to(torch.bfloat16),
              "uint8": torch.randint(0, 256, tuple(table.shape),
                                     generator=gen, dtype=torch.uint8,
                                     device=dev)}
    max_err = 0.0
    for label, t in tables.items():
        for use, q in (("train", TRAIN_Q), ("eval", EVAL_Q)):
            rows = torch.randint(0, t.shape[0], (B, WAYS, SHOTS + q),
                                 generator=gen, dtype=torch.int32,
                                 device=dev)
            outs = []
            for seed in (None, 1, 2 ** 62 - 3):
                s = None if seed is None else torch.tensor(
                    [seed], dtype=torch.int64, device=dev)
                scale = 0.0 if seed is None else AUG_SCALE
                got = kernels.gather_episode_rows(t, rows, SHOTS, s, scale)
                want = kernels.gather_episode_rows_reference(t, rows, SHOTS,
                                                             s, scale)
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"gather_episode_rows differs from its plain "
                         f"version ({label}, {use} episode, seed {seed}): "
                         f"max|diff| {err:.3e}")
                max_err = max(max_err, err)
                outs.append(got)
            if (torch.equal(outs[1][0], outs[2][0])
                    or torch.equal(outs[0][0], outs[1][0])
                    or not torch.equal(outs[0][1], outs[1][1])):
                fail(f"gather_episode_rows: the jitter missed the support "
                     f"rows or touched the queries ({label}, {use})")
    print(f"kernel gather_episode_rows [{', '.join(tables)}; "
          f"{table.shape[0]}x{table.shape[1]}] vs plain: bitwise equal at "
          f"the train ({B}x{WAYS}x{SHOTS}+{TRAIN_Q}) and eval "
          f"({B}x{WAYS}x{SHOTS}+{EVAL_Q}) episodes, without the jitter and "
          f"for two seeds, which differ on the support rows only")
    return max_err


def check_augment(dev) -> float:
    """``augment_embeddings`` against its plain version, bitwise, at the
    flagship support set (B*N*K rows), the flagship query count and an odd
    shape, for two seeds, which must give different jitters."""
    import torch
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = [(B * S, D), (B * WAYS * TRAIN_Q, D), (37, 99)]
    for rows, width in shapes:
        x = torch.randn((rows, width), generator=gen, device=dev)
        outs = []
        for seed in (1, 2 ** 62 - 3):
            s = torch.tensor([seed], dtype=torch.int64, device=dev)
            got = kernels.augment_embeddings(x, s, AUG_SCALE)
            want = kernels.augment_embeddings_reference(x, s, AUG_SCALE)
            torch.cuda.synchronize()
            ratio = (got / x).double()
            if not torch.equal(got, want):
                err = float((got - want).abs().max())
                fail(f"augment_embeddings differs from its plain version "
                     f"({rows}x{width}, seed {seed}): max|diff| {err:.3e}")
            # 1 + jitter and x times it round to fp32: 1e-6 of slack
            if not (float(ratio.min()) >= 1 - AUG_SCALE - 1e-6
                    and float(ratio.max()) <= 1 + AUG_SCALE + 1e-6):
                fail(f"augment_embeddings out of bounds ({rows}x{width})")
            outs.append(got)
        if torch.equal(outs[0], outs[1]):
            fail(f"augment_embeddings: two seeds gave one jitter "
                 f"({rows}x{width})")
    print(f"kernel augment_embeddings vs plain: bitwise equal at "
          f"{', '.join(f'{r}x{w}' for r, w in shapes)} for two seeds, which "
          f"differ; out/x within [{1 - AUG_SCALE:g}, {1 + AUG_SCALE:g}] to "
          f"fp32 rounding")
    return 0.0


def check_sampler_augment(table, ids_np, cset, dev) -> None:
    """The sampler's --augment jitter, through the episode's one launch
    (``gather_episode_rows``; no other gather and no standalone jitter):
    the same episode identity and query embeddings as without it, the
    support embeddings jittered within the scale."""
    import torch
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    from fumi_tpu_torch.ops import kernels
    spec = EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E)
    eps = [DeviceEpisodeSampler(table, ids_np, cset, spec,
                                use_pallas_gather=True, augment_scale=scale,
                                device=dev)
           for scale in (0.0, AUG_SCALE)]
    plain = eps[0].sample(eps[0].generator(7))
    names = ("gather_episode_rows", "gather_rows", "gather_augment_rows",
             "augment_embeddings")
    before = [getattr(kernels, n).launches for n in names]
    aug = eps[1].sample(eps[1].generator(7))
    route = tuple(getattr(kernels, n).launches - b
                  for n, b in zip(names, before))
    ratio = (aug.support_im / plain.support_im).double()
    ok = (torch.equal(plain.support_ids, aug.support_ids)
          and torch.equal(plain.query_im, aug.query_im)
          and not torch.equal(plain.support_im, aug.support_im)
          and float((ratio - 1).abs().max()) <= AUG_SCALE + 1e-6
          and route == (1, 0, 0, 0))
    print(f"sampler --augment: support jittered (|out/x - 1| <= "
          f"{float((ratio - 1).abs().max()):.4f}), queries and ids as "
          f"without it, launches "
          f"{', '.join(f'{n} {c}' for n, c in zip(names, route))}: {ok}")
    if not ok:
        fail("the sampler's augmentation touched the queries or missed the "
             "support set")


def fused_ok(label: str, got, want, exact) -> float:
    """A fused adaptation kernel's logits against its plain version
    (``want``) and the same loop in fp64 (``exact``). Tolerance 1e-3 and
    the same argmax: the kernel sums the D-deep products in C partial sums
    of its cluster and the plain version in cuBLAS's order, and 100 fp32
    SGD steps carry the difference forward (a ReLU near 0 can flip), so
    two fp32 evaluations differ by up to a few 1e-4, as far as each lies
    from the fp64 loop. The kernel may lie no more than twice as far from
    the fp64 loop as the plain version does. Fails the run otherwise;
    returns max|kernel - plain|."""
    import torch
    err = float((got - want).abs().max())
    k64 = float((got.double() - exact).abs().max())
    p64 = float((want.double() - exact).abs().max())
    same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
    finite = bool(torch.isfinite(got).all())
    print(f"kernel {label} vs plain: max|diff| {err:.3e} (tolerance 1e-3), "
          f"argmax equal {same_argmax}, finite {finite}; vs the fp64 loop: "
          f"kernel {k64:.3e}, plain {p64:.3e} (kernel at most 2x plain)")
    if not (err <= 1e-3 and same_argmax and finite and k64 <= 2 * p64):
        fail(f"{label} disagrees with its plain version")
    return err


def check_batched(maml_p, sx, sy, qx, per_task) -> float:
    """``fused_maml_adapt_batched`` against its plain version at B=4
    flagship, 100 steps (:func:`fused_ok`); and bitwise against
    ``fused_adapt`` on the same head broadcast over the tasks
    (``per_task``): the same kernel on the same values."""
    import torch
    from fumi_tpu_torch.ops import kernels
    args = (sx, sy, qx, STEPS, STEP_SIZE)
    got = kernels.fused_maml_adapt_batched(maml_p, *args)
    want = kernels.fused_maml_adapt_batched_reference(maml_p, *args)
    exact = kernels.fused_maml_adapt_batched_reference(
        {k: v.double() for k, v in maml_p.items()}, sx.double(), sy,
        qx.double(), STEPS, STEP_SIZE)
    torch.cuda.synchronize()
    err = fused_ok(f"fused_maml_adapt_batched [maml head read at a task "
                   f"stride of 0, B={B}]", got, want, exact)
    same = torch.equal(got, per_task)
    print(f"fused_maml_adapt_batched vs fused_maml_adapt (the head copied "
          f"per task) on the same inputs: bitwise equal {same}")
    if not same:
        fail("fused_maml_adapt_batched and fused_maml_adapt differ")
    return err


def served_exact(model, clf, s_im, s_y, q_im, s_tx):
    """The served requests' logits by the plain adaptation loop in fp64,
    (R, M, N) on the host, from the classifier's weights (FuMI's head from
    its hypernetwork, as the served path computes it)."""
    import torch
    from fumi_tpu_torch.ops import kernels
    dev = next(iter(clf.params.values())).device
    sx, qx = (torch.from_numpy(a).to(dev).double() for a in (s_im, q_im))
    sy = torch.from_numpy(s_y).to(dev)
    p = clf.params
    with torch.no_grad():
        if model == "maml":
            out = kernels.fused_maml_adapt_batched_reference(
                {k: v.double() for k, v in p.items()}, sx, sy, qx, STEPS,
                STEP_SIZE)
        else:
            hyper0 = clf.family.model.get_hyper_params(
                p, torch.from_numpy(s_tx).to(dev), sy)
            R = hyper0.shape[0]
            out = kernels.fused_adapt_reference(
                *(p[f"im_net.linear{i}.{t}"].double()
                  for i in (0, 1) for t in ("weight", "bias")),
                hyper0[:, :, :-1].double(),
                hyper0[:, :, -1].reshape(R, 1, -1).double(), sx, sy, qx,
                STEPS, STEP_SIZE)
    return out.cpu().numpy()


def served_argmax(got, eng, exact):
    """(rows whose argmax differ, whether each is allowed). The kernel and
    the engine sum in other orders, and 100 fp32 steps carry that forward
    (up to a few 1e-4), so their argmax may differ only on a row whose two
    top logits lie within the 1e-3 tolerance in the engine's answer, and
    there the kernel's argmax must be the fp64 loop's."""
    import numpy as np
    a_got, a_eng, a_ex = (x.argmax(-1) for x in (got, eng, exact))
    rows = np.argwhere(a_got != a_eng)
    top2 = np.sort(eng, -1)
    gap = top2[..., -1] - top2[..., -2]
    ok = all(gap[tuple(r)] <= 1e-3 and a_got[tuple(r)] == a_ex[tuple(r)]
             for r in rows)
    return len(rows), ok


def print_plans(dev) -> None:
    """The fused adaptation kernel's plan at the flagship widths."""
    from fumi_tpu_torch.ops import kernels
    optin, max_cluster = kernels.card_limits(dev.index)
    print(f"fused_adapt card limits: {optin} B of shared memory a block, "
          f"clusters of up to {max_cluster} blocks of the kernel")
    for label, b, qn in (("eval B=4", B, QN), ("served R=1 M=128", 1, 128)):
        plan = kernels.device_plan(dev.index, (b, S, qn, D, H1, H2, WAYS))
        print(f"fused_adapt plan [{label}]: C={plan.C} blocks per task "
              f"({b * plan.C} blocks), {plan.cols} columns of D a block, "
              f"W1 tiles of {plan.tile_k} rows, queries {plan.query_rows} "
              f"rows a chunk, private buffers in {plan.private} memory, "
              f"{plan.smem_bytes} B of shared memory a block; "
              f"cudaOccupancyMaxActiveClusters "
              f"{kernels.active_clusters(dev.index, plan.C, plan.smem_bytes)}")


def check_gather(table, dev) -> float:
    """``gather_rows`` against its plain version, bitwise, on the flagship
    table (and bf16 and uint8 tables, and narrower and odd widths) at the
    index counts of the flagship paths. Returns the largest |diff|."""
    import torch
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(2)
    u8 = torch.randint(0, 256, tuple(table.shape), generator=gen,
                       dtype=torch.uint8, device=dev)
    tables = {"fp32 D=2048": table, "bf16 D=2048": table.to(torch.bfloat16),
              "uint8 D=2048": u8, "fp32 D=768": table[:, :768].contiguous(),
              "fp32 D=100": table[:, :100].contiguous(),
              "bf16 D=100": table[:, :100].to(torch.bfloat16).contiguous(),
              "uint8 D=99": u8[:, :99].contiguous()}
    counts = {"train support": B * S, "train query": B * WAYS * TRAIN_Q,
              "eval query": B * WAYS * EVAL_Q}
    max_err = 0.0
    for label, t in tables.items():
        for use, m in counts.items():
            idx = torch.randint(0, t.shape[0], (m,), generator=gen,
                                dtype=torch.int32, device=dev)
            got = kernels.gather_rows(t, idx)
            want = kernels.gather_rows_reference(t, idx)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, want):
                fail(f"gather_rows differs from its plain version ({label}, "
                     f"{use} M={m}): max|diff| {err:.3e}")
            max_err = max(max_err, err)
        print(f"kernel gather_rows [{label}, {t.shape[0]} rows] vs plain: "
              f"bitwise equal at M = {', '.join(map(str, counts.values()))}")
    return max_err


def flagship_cfg(Config, model: str = "fumi"):
    """The flagship serving config (5-way 5-shot, BERT text, 100 steps) at
    the JAX package's default widths."""
    return Config(model=model, text_encoder="BERT", im_emb_dim=D,
                  text_emb_dim=E, text_hid_dim=TH, im_hid_dim=(H1, H2),
                  num_ways=WAYS, num_shots=SHOTS,
                  num_test_adapt_steps=STEPS, step_size=STEP_SIZE, seed=0)


def train_cfg(Config, model: str, **kw):
    """The flagship meta-training config (bench.py:25-44) with the kernel
    gather on."""
    return Config(model=model, text_encoder="precomputed", im_emb_dim=D,
                  text_emb_dim=E, text_hid_dim=TH, im_hid_dim=(H1, H2),
                  num_ways=WAYS, num_shots=SHOTS, num_shots_test=TRAIN_Q,
                  batch_size=B, num_train_adapt_steps=INNER_STEPS,
                  num_test_adapt_steps=STEPS, step_size=STEP_SIZE,
                  optim="adam", lr=LR, weight_decay=5e-4, dropout=0.25,
                  pallas_gather=True, seed=0, **kw)


def train_step_card_vs_cpu(cfg, smp, dev, episode=None, dictionary=None,
                           label=None):
    """One train step on the card and on the CPU from the same weights on
    the same episode (``smp``'s, unless ``episode`` is given), dropout 0.

    Tolerances: both sides are fp32 through a 5-step second-order chain,
    summed in other orders (cuBLAS against the CPU's BLAS), so the loss
    agrees to 1e-4 of itself and each gradient tensor to 1e-4 of its own
    largest entry plus 1e-5 of the whole gradient's largest entry: a
    tensor whose gradient is zero in exact arithmetic (FuMI's hypernet
    output bias, as the softmax-CE gradient sums to zero over the classes
    that share it) holds only rounding noise. One Adam step
    from a fresh state moves each entry by lr·g/(|g|+eps), about lr in the
    sign of its (L2-coupled) gradient g: the updated params agree to 1e-6,
    except where g lies within the gradient tolerance of 0 and may take
    the other sign on the other device; there they differ by at most
    2·lr."""
    import torch
    from fumi_tpu_torch.core.episode import Episode
    from fumi_tpu_torch.train import optim, steps
    cfg0 = cfg.replace(dropout=0.0)
    if episode is None:
        episode = smp.sample(smp.generator(7))
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        st = steps.make_steps(cfg0, torch.Generator().manual_seed(0),
                              device=device, dictionary=dictionary)
        ep = Episode(*(None if t is None else t.to(device) for t in episode))
        (loss, _), grads = steps.value_and_grad(st.family, st.params, ep,
                                                None)
        with torch.no_grad():
            updates, _ = st.opt.update(grads, st.opt.init(st.params),
                                       st.params)
            new = optim.apply_updates(st.params, updates)
        runs[where] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                       {k: v.cpu() for k, v in st.params.items()},
                       {k: v.cpu() for k, v in new.items()})
    token = f" {cfg.text_encoder}" if dictionary is not None else ""
    hold_step(f"train step {label or cfg.model}{token}", runs, LR,
              cfg.weight_decay)


def hold_step(label: str, runs, lr: float, weight_decay: float) -> None:
    """One step's ``(loss, grads, params before, params after)`` on the
    card against the CPU (``runs["card"]``, ``runs["cpu"]``), with the
    tolerances :func:`train_step_card_vs_cpu` states for a fresh Adam
    step at ``lr`` with coupled L2 ``weight_decay``."""
    (l_card, g_card, _, p_card), (l_cpu, g_cpu, p0, p_cpu) = (
        runs["card"], runs["cpu"])
    p_err = g_err = 0.0
    worst, flipped = "", 0
    ok = abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    g_all = max(float(g.abs().max()) for g in g_cpu.values())
    for k, g in g_cpu.items():
        g_tol = 1e-4 * float(g.abs().max()) + 1e-5 * g_all
        err = float((g_card[k] - g).abs().max())
        if err / g_tol > g_err:
            g_err, worst = err / g_tol, f"{k} {err:.3e}"
        ok &= err <= g_tol
        diff = (p_card[k] - p_cpu[k]).abs()
        g_eff = g + weight_decay * p0[k]
        off = diff > 1e-6
        flipped += int(off.sum())
        ok &= bool((g_eff[off].abs() <= g_tol).all())
        ok &= bool((diff <= 2.001 * lr).all())
        p_err = max(p_err, float(diff.max()))
    print(f"{label} card vs cpu: loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (tolerance 1e-4 of itself); gradients at "
          f"{g_err:.3f} of their tolerance (1e-4 of the tensor's largest "
          f"entry + 1e-5 of the gradient's, {g_all:.3e}) at most "
          f"({worst}); updated "
          f"params max|diff| {p_err:.3e}, {flipped} entries off by more "
          f"than 1e-6 (each where the gradient is within its tolerance of "
          f"0, by at most 2·lr)")
    if not ok:
        fail(f"{label}: card and CPU disagree")


def driver_runs(root: str, reset_counts, read_counts, by_path):
    """Phase 7: ``fumi_tpu_torch.cli.main`` on the card at the flagship
    width (the parser's defaults) for FuMI and MAML, each in its own
    ``--log_dir`` under ``root``, then FuMI ``--evaluate --checkpoint``.
    Returns the wall seconds of each run, and each family's ``(run dir,
    driver arguments)``."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    walls = {}
    test = {}
    runs = {}
    for model in ("fumi", "maml"):
        log_dir = os.path.join(root, model)
        args = ["--model", model, "--dataset", "synthetic", "--augment",
                "--tpu_pallas_gather", "--tpu_pallas_fused_eval",
                "--epochs", str(DRIVER_EPOCHS), "--eval_freq",
                str(DRIVER_EVAL_FREQ), "--num_ep_test", str(DRIVER_EP_TEST),
                "--seed", "0", "--wandb_offline", "--log_dir", log_dir]
        reset_counts()
        t0 = time.perf_counter()
        out = test[model] = cli_main.cli(args)
        torch.cuda.synchronize()
        walls[model] = time.perf_counter() - t0
        by_path[f"driver {model}"] = counts = read_counts()
        (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
        runs[model] = (run, args)
        csvs = glob.glob(os.path.join(log_dir, "results", "run_*.csv"))
        with open(csvs[0]) as f:
            rows = len(f.read().splitlines()) - 1
        files = all(os.path.exists(os.path.join(run, n))
                    for n in ("ckpt", "best", "ckpt.meta.json"))
        finite = all(np.isfinite(out[f"test/{k}"])
                     for k in ("loss", "acc", "acc_ci95", "loss_ci95"))
        # an augmented train step and an eval meta-batch: one launch each
        # for the episode's rows
        expect = {"augment_embeddings": 0, "gather_augment_rows": 0,
                  "gather_rows": 0,
                  "gather_episode_rows": DRIVER_TRAIN_STEPS
                  + DRIVER_EVAL_BATCHES,
                  "fused_adapt": DRIVER_EVAL_BATCHES if model == "fumi"
                  else 0,
                  "fused_maml_adapt_batched": DRIVER_EVAL_BATCHES
                  if model == "maml" else 0}
        print(f"main path, driver {model}: TEST {out}; {rows} CSV rows, "
              f"ckpt/ and best/ {files}; {walls[model]:.3f} s of wall time; "
              f"launches {counts}")
        if not (finite and files and rows == DRIVER_TEST_BATCHES * B):
            fail(f"driver {model}: non-finite test metrics or missing "
                 "artifacts")
        if counts != expect:
            fail(f"driver {model}: launches {counts}, expected {expect}")
        if model == "fumi":
            reset_counts()
            t0 = time.perf_counter()
            again = cli_main.cli(args[:-1] + [log_dir + "_evaluate",
                                              "--evaluate", "--checkpoint",
                                              run])
            walls["fumi --evaluate"] = time.perf_counter() - t0
            by_path["driver fumi --evaluate"] = counts = read_counts()
            diff = max(abs(again[k] - out[k]) for k in out)
            print(f"main path, driver fumi --evaluate --checkpoint: TEST "
                  f"{again}; max|diff| to the training run's test "
                  f"{diff:.3e} (tolerance 1e-6); launches {counts}")
            if set(again) != set(out) or diff > 1e-6:
                fail("driver fumi --evaluate does not reproduce the test")
            expect = {name: 0 for name in KERNEL_NAMES}
            expect.update(fused_adapt=DRIVER_TEST_BATCHES,
                          gather_episode_rows=DRIVER_TEST_BATCHES)
            if counts != expect:
                fail(f"driver fumi --evaluate: launches {counts}, expected "
                     f"{expect}")
    return walls, runs


def checkpoint_serving(runs, request, dev, reset_counts, read_counts,
                       by_path):
    """Phase 7a: ``FewShotClassifier.from_checkpoint`` on the FuMI and MAML
    run dirs the driver just wrote, a flagship request (5-way 5-shot,
    M=100, 100 steps) against a classifier built on ``load_checkpoint``'s
    params (the same kernel on the same inputs: bitwise, else within
    1e-6), then ``reload(run, best=False)``: the same request path (no
    rebuild), the adapted state dropped, the answer of a classifier on
    ``ckpt/``'s params. Each request launches ``fused_adapt`` once and no
    other kernel. Returns the loaded classifiers and the load times
    (ms)."""
    import numpy as np
    import torch
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import checkpoint as ckpt_lib
    from fumi_tpu_torch.train import steps
    s_im, s_y, q_im, s_tx = request
    clfs, load_ms = {}, {}
    for model, (run, args) in runs.items():
        cfg = config_from_args(args)
        text = s_tx if model == "fumi" else None

        def ask(clf):
            return clf.episode_logits(s_im, s_y, q_im, support_text=text)

        def on(best):
            st = steps.make_steps(cfg, torch.Generator().manual_seed(
                cfg.seed), device=dev)
            params, _, _ = ckpt_lib.load_checkpoint(
                run, st.params, st.opt.init(st.params), best=best)
            return ask(FewShotClassifier(cfg, params, device=dev))
        want_best, want_ckpt = on(True), on(False)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf = FewShotClassifier.from_checkpoint(run, cfg, device=dev)
        torch.cuda.synchronize()
        load_ms[model] = 1e3 * (time.perf_counter() - t0)
        reset_counts()
        got = ask(clf)
        fn = clf._episode_fn
        clf.adapt(s_im, text, s_y)
        clf.reload(run, best=False)
        dropped = clf._state is None
        try:
            clf.classify(q_im)
            dropped = False
        except RuntimeError:
            pass
        again = ask(clf)
        by_path[f"serve {model} from checkpoint"] = counts = read_counts()
        errs = [float(np.abs(a - b).max()) for a, b in
                ((got, want_best), (again, want_ckpt))]
        exact = np.array_equal(got, want_best) and \
            np.array_equal(again, want_ckpt)
        moved = not np.array_equal(want_best, want_ckpt)
        print(f"main path, serve {model} from checkpoint: from_checkpoint "
              f"{load_ms[model]:.1f} ms; logits vs a classifier on "
              f"load_checkpoint's params: bitwise {exact}, max|diff| best/ "
              f"{errs[0]:.3e}, after reload(best=False) {errs[1]:.3e} "
              f"(tolerance 1e-6; best/ and ckpt/ differ: {moved}); the "
              f"request path kept: {clf._episode_fn is fn}; adapted state "
              f"dropped: {dropped}; launches {counts}")
        expect = {name: 0 for name in counts}
        expect["fused_adapt"] = 2  # one a request
        if not (max(errs) <= 1e-6 and clf._episode_fn is fn and dropped
                and np.isfinite(got).all() and got.shape == want_best.shape):
            fail(f"serving {model} from its checkpoint disagrees with "
                 "load_checkpoint's params")
        if counts != expect:
            fail(f"serve {model} from checkpoint: launches {counts}, "
                 f"expected {expect}")
        clf.reload(run)  # back to best/ for the HTTP phase
        clfs[model] = clf
    return clfs, load_ms


@contextlib.contextmanager
def loopback(clf):
    """``serve_http.make_server(clf)`` on 127.0.0.1, port 0, in a thread.
    Yields ``call(path, body=None) -> (status, JSON answer)``: a GET
    without a body, else a POST of ``body`` (bytes as they are, anything
    else as JSON). Stops the server on the way out."""
    import threading
    import urllib.error
    import urllib.request
    from fumi_tpu_torch import serve_http
    server = serve_http.make_server(clf, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, body=None):
        data = body if body is None or isinstance(body, bytes) else \
            json.dumps(body).encode()
        try:
            with opener.open(urllib.request.Request(url + path, data=data),
                             timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    try:
        yield call
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def http_serving(clf, run, request, batch, dev, reset_counts, read_counts,
                 by_path):
    """Phase 7b: ``serve_http.make_server`` on 127.0.0.1, port 0, in a
    thread, serving the FuMI classifier loaded from its run dir: health
    says cuda; ``/v1/episode`` answers the in-process labels and
    probabilities within 1e-5; ``/v1/episode_batch`` (R=4), ``/v1/adapt``
    then ``/v1/classify``, and ``/v1/reload`` (409 after it); four
    concurrent requests run one at a time on worker threads, on each
    thread's current stream. Returns the median request latency through
    HTTP and in process (ms, 20 calls each)."""
    import threading
    import numpy as np
    import torch
    from fumi_tpu_torch.serve import _np_softmax
    s_im, s_y, q_im, s_tx = request
    b_im, b_y, b_q, b_tx = batch
    server = contextlib.ExitStack()
    call = server.enter_context(loopback(clf))
    one = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
           "query_im": q_im.tolist(), "support_text": s_tx.tolist()}
    many = {"support_im": b_im.tolist(), "support_y": b_y.tolist(),
            "query_im": b_q.tolist(), "support_text": b_tx.tolist(),
            "return": "logits"}
    inner, seen = clf.episode_logits, {"now": 0, "most": 0, "calls": []}
    guard = threading.Lock()

    def watched(*a, **kw):
        with guard:
            seen["now"] += 1
            seen["most"] = max(seen["most"], seen["now"])
            seen["calls"].append((
                threading.get_ident(),
                torch.cuda.current_stream(dev).cuda_stream,
                torch.cuda.default_stream(dev).cuda_stream))
        try:
            return inner(*a, **kw)
        finally:
            with guard:
                seen["now"] -= 1
    try:
        status, health = call("/healthz")
        print(f"http: /healthz {status} {health}")
        if status != 200 or health.get("backend") != "cuda" or \
                health.get("devices") != torch.cuda.device_count():
            fail(f"http: /healthz says {health}")
        clf.episode_logits = watched
        reset_counts()
        codes = {}
        codes["episode probs"], probs = call("/v1/episode",
                                             {**one, "return": "probs"})
        codes["episode labels"], labels = call("/v1/episode", one)
        codes["episode_batch"], logits_b = call("/v1/episode_batch", many)
        codes["adapt"], _ = call("/v1/adapt", {
            k: one[k] for k in ("support_im", "support_y", "support_text")})
        codes["classify"], cls = call("/v1/classify",
                                      {"query_im": one["query_im"]})
        by_path["http fumi"] = counts = read_counts()
        clf.episode_logits = inner
        want = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
        want_b = clf.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx)
        clf.adapt(s_im, s_tx, s_y)
        want_cls = clf.classify(q_im)
        p_err = float(np.abs(np.asarray(probs["result"])
                             - _np_softmax(want)).max())
        b_err = float(np.abs(np.asarray(logits_b["result"]) - want_b).max())
        same = (labels["result"] == want.argmax(-1).tolist()
                and cls["result"] == want_cls.tolist()
                and np.array_equal(np.asarray(logits_b["result"]).argmax(-1),
                                   want_b.argmax(-1)))
        print(f"main path, http fumi: status {codes}; /v1/episode labels "
              f"equal in process: {same}, probabilities max|diff| "
              f"{p_err:.3e} (tolerance 1e-5); /v1/episode_batch R={B} "
              f"logits max|diff| {b_err:.3e}; launches {counts}")
        expect = {name: 0 for name in counts}
        expect["fused_adapt"] = 3  # two episodes and one batch of 4
        if set(codes.values()) != {200} or not same or p_err > 1e-5 or \
                b_err > 1e-5:
            fail("http: the answers differ from the in-process ones")
        if counts != expect:
            fail(f"http fumi: launches {counts}, expected {expect}")

        # four clients at once: the lock lets one request in at a time,
        # each on its worker thread's current stream
        clf.episode_logits = watched
        seen.update(most=0, calls=[])
        answers = []
        clients = [threading.Thread(target=lambda: answers.append(
            call("/v1/episode", one))) for _ in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        clf.episode_logits = inner
        threads = {t for t, _, _ in seen["calls"]}
        on_current = all(cur == default for _, cur, default in seen["calls"])
        agree = len(answers) == 4 and all(a == (200, labels)
                                          for a in answers)
        ok = (agree and seen["most"] == 1
              and threading.get_ident() not in threads and on_current)
        print(f"http: 4 concurrent requests: answers equal {agree}, "
              f"at most {seen['most']} in the classifier at once, on "
              f"{len(threads)} worker threads (not the main one), each on "
              f"its thread's current stream (the default stream "
              f"{sorted({d for _, _, d in seen['calls']})}): {on_current}")
        if not ok:
            fail("http: concurrent requests were not serialised or differ")

        codes = {
            "reload": call("/v1/reload", {"checkpoint": run,
                                          "best": False})[0],
            "classify after reload": call(
                "/v1/classify", {"query_im": one["query_im"]})[0],
            "unknown route": call("/v1/nope", one)[0],
            "missing field": call("/v1/episode", {"query_im": []})[0]}
        call("/v1/reload", {"checkpoint": run})
        print(f"http: {codes}")
        if codes != {"reload": 200, "classify after reload": 409,
                     "unknown route": 404, "missing field": 400}:
            fail(f"http: status codes {codes}")

        # latency: 20 requests through HTTP (the body encoded once) and 20
        # in process, in turns
        body = json.dumps(one).encode()
        turns = {}
        for turn in ("http", "in process", "in process", "http"):
            fn = (lambda: call("/v1/episode", body)) if turn == "http" else \
                (lambda: clf.episode_logits(s_im, s_y, q_im,
                                            support_text=s_tx))
            turns.setdefault(turn, []).append(host_ms(fn, reps=20))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        print(f"FuMI flagship request (M={QN}, {STEPS} steps), median of 20 "
              f"calls, 2 turns: through HTTP {ms['http']:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in turns['http'])}; a "
              f"{len(body) / 1e6:.2f} MB JSON body), in process "
              f"{ms['in process']:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in turns['in process'])})")
    finally:
        clf.episode_logits = inner
        server.close()
    return ms


def gaussian_episode(dev):
    """A train episode (B tasks, 5-way 5-shot, 32 queries a class) of
    N(0, 1) image and text embeddings, from a seed."""
    import torch
    from fumi_tpu_torch.core.episode import Episode, class_major_labels
    gen = torch.Generator().manual_seed(11)
    nq = WAYS * TRAIN_Q

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    zeros = torch.zeros((B, S), dtype=torch.int32, device=dev)
    return Episode(
        support_im=randn(B, S, D), support_text=randn(B, S, E),
        support_text_mask=None, support_ids=zeros,
        support_y=class_major_labels(B, WAYS, SHOTS, dev),
        query_im=randn(B, nq, D),
        query_ids=torch.zeros((B, nq), dtype=torch.int32, device=dev),
        query_y=class_major_labels(B, WAYS, TRAIN_Q, dev))


def prototype_families(Config, train_smp, aug_smp, eval_smp, dev,
                       reset_counts, read_counts, by_path):
    """Phase 7c: AM3 (BERT text 768, image 2048, prototype_dim 64, text_hid
    256, dropout 0.25), ProtoNet and MatchingNet on the device sampler with
    the kernel gather, B=4, 5-way 5-shot, 32 train queries per class:
    a timed chunk of 50 steps after a warm chunk, without and with
    ``--augment``, then 8 eval meta-batches at 20 queries per class. Each
    train step and eval meta-batch launches one ``gather_episode_rows``
    and no other kernel. One AM3 train step on the card is held against
    the CPU, and an AM3 step is profiled. Returns the episodes/s of each
    path and AM3's (device ms, operations, wall ms) a step."""
    import torch
    from fumi_tpu_torch.train import steps
    eps, am3_busy = {}, None
    for model in ("am3", "protonet", "matchingnet"):
        cfg = train_cfg(Config, model).replace(text_encoder="BERT",
                                               prototype_dim=64)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        for label, smp in (("", train_smp), (" --augment", aug_smp)):
            run = steps.make_chunked_train(st.family, st.opt, smp,
                                           TRAIN_CHUNK)
            p, s, gen, warm = run(st.params, st.opt.init(st.params),
                                  smp.generator(1))
            box = {}
            reset_counts()
            seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
            by_path[f"train {model}{label}"] = counts = read_counts()
            p2, _, _, ms = box["out"]
            losses = torch.cat([warm["loss"], ms["loss"]])
            moved = max(float((p2[k] - st.params[k]).abs().max())
                        for k in p2)
            eps[f"train {model}{label}"] = TRAIN_CHUNK * B / seconds
            print(f"main path, train {model}{label}: 2 chunks of "
                  f"{TRAIN_CHUNK} steps, loss {float(losses[0]):.4f} -> "
                  f"{float(losses[-1]):.4f}, acc {float(ms['acc'].mean()):.3f}"
                  f"; timed chunk {seconds:.3f} s = "
                  f"{eps[f'train {model}{label}']:.1f} episodes/s; launches "
                  f"{counts}; metrics {sorted(ms)}")
            expect = {name: 0 for name in counts}
            expect["gather_episode_rows"] = TRAIN_CHUNK
            am3_keys = {"prec", "rec", "f1", "avg_lamda"}
            if not bool(torch.isfinite(losses).all()) or moved == 0.0 or \
                    (model == "am3" and not am3_keys <= set(ms)):
                fail(f"training {model}{label}: non-finite losses, params "
                     "unmoved or metrics missing")
            if counts != expect:
                fail(f"training {model}{label}: launches {counts}, expected "
                     f"{expect}")
            if model == "am3" and not label:
                am3_run = (run, p, s, gen, seconds / TRAIN_CHUNK)

        evaluate = steps.make_chunked_eval(st.family, eval_smp,
                                           collect=True)
        evaluate(p2, eval_smp.generator(99), 1)  # warm
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(
            out=evaluate(p2, eval_smp.generator(3), EVAL_BATCHES)))
        by_path[f"eval {model}"] = counts = read_counts()
        out = box["out"][1]
        eps[f"eval {model}"] = EVAL_BATCHES * B / seconds
        lam_ok = model != "am3" or bool(
            ((out["lamda"] >= 0) & (out["lamda"] <= 1)).all()
            and out["lamda"].shape == (EVAL_BATCHES, B, S))
        print(f"main path, eval {model}: {EVAL_BATCHES} meta-batches, loss "
              f"{float(out['loss'].mean()):.4f}, acc "
              f"{float(out['acc'].mean()):.4f}; {seconds:.3f} s = "
              f"{eps[f'eval {model}']:.1f} episodes/s; launches {counts}; "
              f"collected {sorted(k for k in out if out[k].dim() > 1)}")
        expect = {name: 0 for name in counts}
        expect["gather_episode_rows"] = EVAL_BATCHES
        if not bool(torch.isfinite(out["loss"]).all()) or not lam_ok:
            fail(f"eval {model}: non-finite losses or λ out of [0, 1]")
        if counts != expect:
            fail(f"eval {model}: launches {counts}, expected {expect}")
        if model == "am3":
            # on the synthetic table AM3's loss is ~1e-5 (its classes lie
            # far apart), so every gradient is fp32 rounding of a saturated
            # softmax; the step is held on Gaussian embeddings of the same
            # shapes instead, where the loss is of order 1
            train_step_card_vs_cpu(cfg, train_smp, dev,
                                   gaussian_episode(dev))

    # an AM3 step on the card: device time and operations of 5 steps
    run, p, s, gen, step_s = am3_run
    prof_steps = 5
    traced = device_profile(lambda: run(p, s, gen, prof_steps))
    if traced is None:
        print("train am3: device busy share not measured (the profiler "
              "recorded no device time)")
    else:
        dev_ms, ops, _ = traced
        am3_busy = (dev_ms / prof_steps, ops / prof_steps, step_s * 1e3)
        print(f"train am3: device time {am3_busy[0]:.3f} ms a step in "
              f"{am3_busy[1]:.0f} device operations (torch.profiler, "
              f"{prof_steps} steps) against {am3_busy[2]:.3f} ms of wall "
              f"time a step: the card is busy "
              f"{100 * am3_busy[0] / am3_busy[2]:.1f}% of the step")
    return eps, am3_busy


def am3_driver(root, reset_counts, read_counts, by_path) -> dict:
    """Phase 7d: ``cli.main --model am3`` at the parser's defaults with
    ``--augment --tpu_pallas_gather`` and phase 7's epochs (AM3 validates
    at batch 0 as well: 4 validation passes), then ``--evaluate
    --checkpoint`` on its run, which tests the params the run tested
    (best/ where validation improved, which AM3 reloads, else ckpt/): the
    same test metrics within 1e-6. A finite TEST line with AM3's
    prec / rec / f1 / avg_lamda, ckpt/, a CSV with the
    ``support_lamda`` column (λ in [0, 1]); one ``gather_episode_rows`` a
    train step and eval meta-batch, no other kernel. Returns the wall
    seconds of both runs."""
    import csv
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    log_dir = os.path.join(root, "am3")
    args = ["--model", "am3", "--dataset", "synthetic", "--augment",
            "--tpu_pallas_gather", "--epochs", str(DRIVER_EPOCHS),
            "--eval_freq", str(DRIVER_EVAL_FREQ), "--num_ep_test",
            str(DRIVER_EP_TEST), "--seed", "0", "--wandb_offline",
            "--log_dir", log_dir]
    walls = {}
    reset_counts()
    t0 = time.perf_counter()
    out = cli_main.cli(args)
    torch.cuda.synchronize()
    walls["am3"] = time.perf_counter() - t0
    by_path["driver am3"] = counts = read_counts()
    (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
    (path,) = glob.glob(os.path.join(log_dir, "results", "run_*.csv"))
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    lam = [json.loads(r[rows[0].index("support_lamda")]) for r in rows[1:]] \
        if "support_lamda" in rows[0] else []
    lam_ok = (len(lam) == DRIVER_TEST_BATCHES * B
              and all(len(x) == S and all(0.0 <= v <= 1.0 for v in x)
                      for x in lam))
    # best/ is written only where a validation pass beat the first one;
    # on the synthetic table AM3's loss starts near 1e-6 and may never
    # improve, and then --evaluate tests ckpt/, as the run itself did
    files = all(os.path.exists(os.path.join(run, n))
                for n in ("ckpt", "ckpt.meta.json", "config.json"))
    has_best = os.path.isdir(os.path.join(run, "best"))
    keys = {f"test/{k}" for k in ("loss", "acc", "prec", "rec", "f1",
                                  "avg_lamda", "acc_ci95", "loss_ci95")}
    finite = set(out) == keys and all(np.isfinite(v) for v in out.values())
    # 4 validation passes of 5 meta-batches (before training and at
    # batches 0, 10 and 20) and the test pass
    val_batches = 4 * (DRIVER_EP_TEST // B // 2 + 1)
    expect = {name: 0 for name in counts}
    expect["gather_episode_rows"] = (DRIVER_TRAIN_STEPS + val_batches
                                     + DRIVER_TEST_BATCHES)
    print(f"main path, driver am3: TEST {out}; {len(rows) - 1} CSV rows "
          f"with support_lamda ({S} λ a row in [0, 1]): {lam_ok}; ckpt/ "
          f"{files}, best/ {has_best}; {walls['am3']:.3f} s of wall time; "
          f"launches {counts}")
    if not (finite and files and lam_ok):
        fail("driver am3: non-finite or missing test metrics, or missing "
             "artifacts")
    if counts != expect:
        fail(f"driver am3: launches {counts}, expected {expect}")
    reset_counts()
    t0 = time.perf_counter()
    again = cli_main.cli(args[:-1] + [log_dir + "_evaluate", "--evaluate",
                                      "--checkpoint", run])
    walls["am3 --evaluate"] = time.perf_counter() - t0
    by_path["driver am3 --evaluate"] = counts = read_counts()
    diff = max(abs(again[k] - out[k]) for k in out)
    print(f"main path, driver am3 --evaluate --checkpoint: TEST {again}; "
          f"max|diff| to the training run's test {diff:.3e} (tolerance "
          f"1e-6); launches {counts}")
    expect = {name: 0 for name in counts}
    expect["gather_episode_rows"] = DRIVER_TEST_BATCHES
    if set(again) != set(out) or diff > 1e-6:
        fail("driver am3 --evaluate does not reproduce the test")
    if counts != expect:
        fail(f"driver am3 --evaluate: launches {counts}, expected {expect}")
    return walls


def clip_phase(root, dev, reset_counts, read_counts, by_path) -> dict:
    """Phase 7e: CLIP at the parser's widths (text 768, image 2048, latent
    512) on the driver's synthetic data (32 classes × 64 images; the train
    split's 19 classes make a deduped batch of at most 19 valid rows).

    - One train step (the masked symmetric CE of a deduped batch of 64,
      Adam from a fresh state), card against CPU (:func:`hold_step`).
    - The driver: ``cli.main --model clip --dataset synthetic --batch_size
      64 --epochs 3 --lr 1e-3``: ``ckpt/``, ``best/``, the ``TEST: test
      acc`` line; then ``--evaluate --checkpoint`` on its run reproduces
      the accuracy exactly.
    - ``ClipRetrieval.from_checkpoint`` on that run: ``index`` the
      2048-row table, ``retrieve`` 100 texts top-5 against the CPU (scores
      within 1e-5; indices equal wherever the CPU's neighbouring scores
      differ by more than that), ``similarity`` bitwise ``model.forward``.
    - ``ClipService`` on loopback: retrieve before any index (409), index
      (256 rows), retrieve, similarity, reload (the gallery dropped: 409),
      healthz; each answer equal to the in-process one.
    - Times: train steps/s (host clock over 2 epochs after a warm one) and
      the device busy share of an epoch (``torch.profiler``), ``index``
      and ``retrieve`` in ms, HTTP ``retrieve`` beside in process.

    No path launches a kernel of ``ops/kernels.py``. Returns the times."""
    import contextlib
    import glob
    import io
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import Config, config_from_args
    from fumi_tpu_torch.data.supervised import (epoch_batches,
                                                supervised_from_class_set)
    from fumi_tpu_torch.serve import ClipRetrieval
    from fumi_tpu_torch.train import clip_loop, optim
    zero = {name: 0 for name in KERNEL_NAMES}
    times = {}

    # one train step, card against CPU, at the config's defaults (Adam
    # 3e-5, coupled L2 5e-4)
    cfg = Config(model="clip", dataset="synthetic", batch_size=CLIP_BATCH,
                 seed=0)
    splits, table, _, _ = cli_main._load_data(cfg)
    train = (supervised_from_class_set(splits["train"]), table)
    image, text, ids, valid_n = next(epoch_batches(
        *train, CLIP_BATCH, np.random.RandomState(0)))
    image, text, u = clip_loop.dedupe_batch(image, text, ids, valid_n)
    model, p0 = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    opt = optim.init_optim(cfg.optim, cfg.lr, cfg.weight_decay, cfg.momentum)
    runs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        p = {k: v.to(device) for k, v in p0.items()}
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = clip_loop.masked_symmetric_ce(
            model, leaves, torch.from_numpy(text).to(device),
            torch.from_numpy(image).to(device), u)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            updates, _ = opt.update(grads, opt.init(p), p)
            new = optim.apply_updates(p, updates)
        runs[where] = (float(loss.detach()),) + tuple(
            {k: v.detach().cpu() for k, v in t.items()}
            for t in (grads, p, new))
    hold_step(f"train step clip ({u} valid rows of {CLIP_BATCH})", runs,
              cfg.lr, cfg.weight_decay)

    # the driver, then --evaluate on its run
    log_dir = os.path.join(root, "clip")
    args = ["--model", "clip", "--dataset", "synthetic", "--batch_size",
            str(CLIP_BATCH), "--epochs", str(CLIP_EPOCHS), "--lr",
            str(CLIP_LR), "--seed", "0", "--wandb_offline", "--log_dir",
            log_dir]
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = cli_main.cli(args)
    times["driver clip s"] = time.perf_counter() - t0
    by_path["driver clip"] = counts = read_counts()
    sys.stdout.write(buf.getvalue())
    (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
    files = all(os.path.exists(os.path.join(run, n)) for n in (
        "ckpt", "best", "ckpt.meta.json", "best.meta.json", "config.json"))
    printed = f"TEST: test acc: {out['test/acc']}" in buf.getvalue()
    print(f"main path, driver clip: TEST {out}; printed {printed}; ckpt/ "
          f"and best/ {files}; {times['driver clip s']:.3f} s of wall "
          f"time; launches {counts}")
    if not (files and printed and 0.0 <= out["test/acc"] <= 1.0):
        fail("driver clip: no TEST line, an accuracy out of [0, 1] or "
             "missing artifacts")
    if counts != zero:
        fail(f"driver clip: launches {counts}, expected none")
    reset_counts()
    t0 = time.perf_counter()
    again = cli_main.cli(args[:-1] + [log_dir + "_evaluate", "--evaluate",
                                      "--checkpoint", run])
    times["driver clip --evaluate s"] = time.perf_counter() - t0
    by_path["driver clip --evaluate"] = counts = read_counts()
    print(f"main path, driver clip --evaluate --checkpoint: TEST {again}; "
          f"equal to the training run's test: {again == out} (tolerance "
          f"0); launches {counts}")
    if again != out or counts != zero:
        fail(f"driver clip --evaluate: TEST {again} against {out}, "
             f"launches {counts}")

    # ClipRetrieval on the run dir, card against CPU
    cfg = config_from_args(args)
    rng = np.random.RandomState(5)
    texts = rng.randn(CLIP_TEXTS, E).astype(np.float32)
    reset_counts()
    clf = ClipRetrieval.from_checkpoint(run, cfg, device=dev)
    size = clf.index(table)
    idx, scores = clf.retrieve(texts, CLIP_TOP_K)
    sim = clf.similarity(texts[:8], table[:64])
    with torch.no_grad():
        fwd = clf.model.forward(clf.params,
                                torch.from_numpy(texts[:8]).to(dev),
                                torch.from_numpy(table[:64]).to(dev))
    by_path["serve clip"] = counts = read_counts()
    host = ClipRetrieval.from_checkpoint(run, cfg, device="cpu")
    host.index(table)
    h_idx, h_scores = host.retrieve(texts, CLIP_TOP_K + 1)
    s_err = float(np.abs(scores - h_scores[:, :CLIP_TOP_K]).max())
    # an index is held only where the CPU's scores around it are apart by
    # more than the tolerance: ties within it may rank either way
    gap = np.abs(np.diff(h_scores, axis=1)) > CLIP_TOL  # (M, K)
    clear = gap[:, :CLIP_TOP_K] & np.concatenate(
        [np.ones((CLIP_TEXTS, 1), bool), gap[:, :CLIP_TOP_K - 1]], axis=1)
    idx_ok = np.array_equal(idx[clear], h_idx[:, :CLIP_TOP_K][clear])
    bitwise = np.array_equal(sim, fwd.cpu().numpy())
    print(f"main path, serve clip: from_checkpoint on the driver's run; "
          f"index {size} rows; retrieve {CLIP_TEXTS} texts top-"
          f"{CLIP_TOP_K} vs the CPU: scores max|diff| {s_err:.3e} "
          f"(tolerance {CLIP_TOL}), indices equal on the "
          f"{int(clear.sum())} of {clear.size} ranks apart from their "
          f"neighbours by more than it: {idx_ok}; similarity bitwise "
          f"model.forward: {bitwise}; launches {counts}")
    if not (size == table.shape[0] and s_err <= CLIP_TOL and idx_ok
            and bitwise and idx.shape == (CLIP_TEXTS, CLIP_TOP_K)):
        fail("serve clip: retrieval on the card disagrees with the CPU")
    if counts != zero:
        fail(f"serve clip: launches {counts}, expected none")
    times["index rows"] = size
    times["index ms"] = 1e3 * statistics.median(
        synced_s(lambda: clf.index(table)) for _ in range(5))
    times["retrieve ms"] = host_ms(lambda: clf.retrieve(texts, CLIP_TOP_K),
                                   reps=20)

    # ClipService on loopback
    with loopback(clf) as call:
        gallery = table[:CLIP_HTTP_ROWS]
        t_body = {"text": texts.tolist(), "top_k": CLIP_TOP_K}
        reset_counts()
        codes = {"reload": call("/v1/reload", {"checkpoint": run})[0]}
        codes["retrieve before index"] = call("/v1/clip/retrieve",
                                              t_body)[0]
        codes["index"], indexed = call("/v1/clip/index",
                                       {"images": gallery.tolist()})
        codes["retrieve"], got = call("/v1/clip/retrieve", t_body)
        codes["similarity"], got_sim = call("/v1/clip/similarity", {
            "text": texts[:8].tolist(), "images": gallery[:64].tolist()})
        status, health = call("/healthz")
        by_path["http clip"] = counts = read_counts()
        want_idx, want_scores = clf.retrieve(texts, CLIP_TOP_K)
        want_sim = clf.similarity(texts[:8], gallery[:64])
        same = (got["indices"] == want_idx.tolist()
                and np.array_equal(np.asarray(got["scores"], np.float32),
                                   want_scores)
                and np.array_equal(np.asarray(got_sim["similarity"],
                                              np.float32), want_sim)
                and indexed["gallery_size"] == CLIP_HTTP_ROWS)
        codes["reload again"] = call("/v1/reload", {"checkpoint": run})[0]
        codes["retrieve after reload"] = call("/v1/clip/retrieve",
                                              t_body)[0]
        dropped = call("/healthz")[1]["gallery"]
        print(f"main path, http clip: status {codes}; /healthz {health}; "
              f"answers equal to in process: {same}; gallery after reload "
              f"{dropped}; launches {counts}")
        want_codes = {"reload": 200, "retrieve before index": 409,
                      "index": 200, "retrieve": 200, "similarity": 200,
                      "reload again": 200, "retrieve after reload": 409}
        if codes != want_codes or not same or dropped != 0 or \
                health.get("model") != "clip" or \
                health.get("backend") != "cuda" or \
                health.get("gallery") != CLIP_HTTP_ROWS:
            fail("http clip: status codes, health or answers differ")
        if counts != zero:
            fail(f"http clip: launches {counts}, expected none")
        call("/v1/clip/index", {"images": gallery.tolist()})
        body = json.dumps(t_body).encode()
        times["http retrieve ms"] = host_ms(
            lambda: call("/v1/clip/retrieve", body), reps=20)
        times["in-process retrieve ms (gallery 256)"] = host_ms(
            lambda: clf.retrieve(texts, CLIP_TOP_K), reps=20)

    # training steps/s and the device busy share of an epoch
    model, p = clip_loop.make_clip(cfg, torch.Generator().manual_seed(0))
    p = {k: v.to(dev) for k, v in p.items()}
    opt = optim.init_optim(cfg.optim, cfg.lr, cfg.weight_decay, cfg.momentum)
    state = opt.init(p)
    rng = np.random.RandomState(0)
    p, state, n = clip_loop.train_epoch(cfg, model, opt, p, state, train,
                                        rng)  # warm
    box = {}
    reset_counts()
    seconds = synced_s(lambda: box.update(out=[
        clip_loop.train_epoch(cfg, model, opt, p, state, train, rng)
        for _ in range(2)]))
    by_path["train clip"] = counts = read_counts()
    times["train steps/s"] = 2 * n / seconds
    traced = device_profile(lambda: clip_loop.train_epoch(
        cfg, model, opt, p, state, train, rng))
    if traced is not None:
        times["train busy"] = (traced[0] / n, traced[1] / n,
                               1e3 * seconds / (2 * n))
    print(f"main path, train clip: 2 epochs of {n} steps (batch "
          f"{CLIP_BATCH}) in {seconds:.3f} s = {times['train steps/s']:.1f} "
          f"steps/s; launches {counts}" + (
              "" if traced is None else
              f"; device time {times['train busy'][0]:.3f} ms a step in "
              f"{times['train busy'][1]:.0f} device operations "
              f"(torch.profiler, one epoch) against "
              f"{times['train busy'][2]:.3f} ms of wall time: busy "
              f"{100 * times['train busy'][0] / times['train busy'][2]:.1f}%"))
    if counts != zero:
        fail(f"train clip: launches {counts}, expected none")
    return times


def padded_tokens(rng, rows: int):
    """(rows, TOKEN_LEN) token ids from 1..TOKEN_VOCAB-1 whose lengths
    cycle through 1..TOKEN_LEN, PAD (0) after the last."""
    import numpy as np
    toks = rng.randint(1, TOKEN_VOCAB, size=(rows, TOKEN_LEN))
    lengths = 1 + np.arange(rows) % TOKEN_LEN
    return np.where(np.arange(TOKEN_LEN) < lengths[:, None], toks,
                    0).astype(np.int32)


def token_encoders(Config, dev, root, reset_counts, read_counts, by_path,
                   bert_eps) -> dict:
    """Phase 7f: the token text encoders at the full width for FuMI and
    AM3 (``RNN``: 300-wide embeddings into 2 × 384; ``glove``: 300, mean
    pooling; ``RNNhid`` and ``w2v`` once each), on the driver's synthetic
    token data (12 tokens a class, a vocabulary of 128) with the train
    split's descriptions padded to every length 1..12.

    - Train on the device sampler with the kernel gather at the flagship
      training config (one ``gather_episode_rows`` a step and no other
      kernel), the frozen encoder bitwise unchanged; one FuMI and one AM3
      RNN step card against CPU (FuMI on a sampled episode, AM3 on
      Gaussian image embeddings and padded tokens); FuMI RNN
      ``--fine_tune``: the second-order step with the encoder in its
      graph moves the encoder.
    - Eval FuMI RNN through ``fused_adapt`` against the autograd engine.
    - Serve a token FuMI request (descriptions of lengths 1..12) through
      ``fused_adapt``, against the engine.
    - The driver for FuMI RNN and AM3 glove (``vocab.json`` in the run
      dir), ``from_checkpoint`` on the FuMI run, the same request in
      process and over HTTP, one without ``support_text`` (400) and one
      with a token id outside the embedding table (refused in process,
      400 over HTTP; the next request answers as the first did).
    - Times: train episodes/s beside the BERT runs (``bert_eps``), the
      encoder's device ms a meta-batch, the busy share of a FuMI RNN step.

    Returns the times."""
    import dataclasses
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    from fumi_tpu_torch.data.synthetic import synthetic_dictionary
    from fumi_tpu_torch.serve import (FewShotClassifier, RequestError,
                                      _np_softmax)
    from fumi_tpu_torch.train import checkpoint as ckpt_lib
    from fumi_tpu_torch.train import steps
    vocab = synthetic_dictionary(TOKEN_VOCAB)
    times = {"train eps": {}, "encoder": {}}
    splits, table_np, ids_np, _ = cli_main._load_data(
        train_cfg(Config, "fumi").replace(text_encoder="RNN",
                                          dataset="synthetic"))
    train_cs = splits["train"]
    train_cs = dataclasses.replace(train_cs, text_features=padded_tokens(
        np.random.RandomState(3), train_cs.num_classes))
    table = torch.from_numpy(table_np).to(dev)
    smp = {q: DeviceEpisodeSampler(
        table, ids_np, cs, EpisodeSpec(B, WAYS, SHOTS, q, D, TOKEN_LEN,
                                       text_is_tokens=True),
        use_pallas_gather=True, device=dev)
        for q, cs in ((TRAIN_Q, train_cs), (EVAL_Q, splits["test"]))}
    train_smp, eval_smp = smp[TRAIN_Q], smp[EVAL_Q]
    ep = train_smp.sample(train_smp.generator(9))
    if ep.support_text.dtype != torch.int32 or \
            tuple(ep.support_text.shape) != (B, S, TOKEN_LEN):
        fail(f"token sampler: support_text {ep.support_text.dtype} "
             f"{tuple(ep.support_text.shape)}")
    gauss = gaussian_episode(dev)._replace(support_text=torch.from_numpy(
        padded_tokens(np.random.RandomState(4), B * S).reshape(
            B, S, TOKEN_LEN)).to(dev))

    trained = {}
    for model, enc in TOKEN_CASES:
        label = f"{model} {enc}"
        cfg = train_cfg(Config, model).replace(text_encoder=enc,
                                               prototype_dim=64)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev, dictionary=vocab)
        run = steps.make_chunked_train(st.family, st.opt, train_smp,
                                       TOKEN_CHUNK)
        p, s, gen, warm = run(st.params, st.opt.init(st.params),
                              train_smp.generator(1))
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
        by_path[f"train {label}"] = counts = read_counts()
        p2, s2, gen2, ms = box["out"]
        losses = torch.cat([warm["loss"], ms["loss"]])
        frozen = all(torch.equal(p2[k], st.params[k]) for k in p2
                     if k.startswith("text_encoder."))
        eps = times["train eps"][label] = TOKEN_CHUNK * B / seconds
        with torch.no_grad():
            traced = device_profile(lambda: st.family.model.text_encoder
                                    .apply(p2, ep.support_text))
        if traced is not None:
            times["encoder"][enc] = traced[:2]
        print(f"main path, train {label}: 2 chunks of {TOKEN_CHUNK} steps, "
              f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}; "
              f"timed chunk {seconds:.3f} s = {eps:.1f} episodes/s; frozen "
              f"encoder bitwise unchanged: {frozen}; launches {counts}" + (
                  "" if traced is None else
                  f"; the encoder on a meta-batch's {B * S} descriptions: "
                  f"{traced[0]:.3f} ms of device time in {traced[1]} "
                  "device operations"))
        expect = {name: 0 for name in KERNEL_NAMES}
        expect["gather_episode_rows"] = TOKEN_CHUNK
        if not (bool(torch.isfinite(losses).all()) and frozen):
            fail(f"training {label}: non-finite losses or the frozen "
                 "encoder moved")
        if counts != expect:
            fail(f"training {label}: launches {counts}, expected {expect}")
        trained[label] = (cfg, p2)
        if enc == "RNN":
            # FuMI on a sampled episode, as phase 5 holds it; AM3's loss
            # saturates on the synthetic table, so on Gaussian image
            # embeddings, as phase 7c holds it
            train_step_card_vs_cpu(cfg, train_smp, dev,
                                   gauss if model == "am3" else None,
                                   vocab)
        if label == "fumi RNN":
            traced = device_profile(lambda: run(p2, s2, gen2, 5))
            if traced is not None:
                times["busy"] = (traced[0] / 5, traced[1] / 5,
                                 1e3 * seconds / TOKEN_CHUNK)

    # --fine_tune: the second-order step with the encoder in its graph
    cfg = train_cfg(Config, "fumi").replace(text_encoder="RNN",
                                            fine_tune=True)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev,
                          dictionary=vocab)
    reset_counts()
    p, _, _, ms = steps.make_chunked_train(st.family, st.opt, train_smp, 2)(
        st.params, st.opt.init(st.params), train_smp.generator(2))
    by_path["train fumi RNN --fine_tune"] = counts = read_counts()
    moved = all(not torch.equal(p[k], st.params[k]) for k in p
                if k.startswith("text_encoder.rnn."))
    print(f"main path, train fumi RNN --fine_tune: 2 steps, loss "
          f"{[round(float(x), 4) for x in ms['loss']]}; every LSTM weight "
          f"moved: {moved}; launches {counts}")
    if not (moved and bool(torch.isfinite(ms["loss"]).all())) or \
            counts["gather_episode_rows"] != 2:
        fail("training fumi RNN --fine_tune: the encoder did not train")

    # eval FuMI RNN through fused_adapt against the autograd engine
    cfg, params = trained["fumi RNN"]
    out = {}
    for path, fused in (("fused kernel", True), ("autograd engine", False)):
        family = steps.build_family(cfg.replace(pallas_fused_eval=fused),
                                    torch.Generator().manual_seed(0), vocab)
        run = steps.make_chunked_eval(family, eval_smp)
        run(params, eval_smp.generator(99), 1)  # warm
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(
            out=run(params, eval_smp.generator(3), EVAL_BATCHES)))
        counts = read_counts()
        out[path] = box["out"][1]
        expect = {name: 0 for name in KERNEL_NAMES}
        expect["gather_episode_rows"] = EVAL_BATCHES
        expect["fused_adapt"] = EVAL_BATCHES if fused else 0
        if fused:
            by_path["eval fumi RNN"] = counts
            times["eval eps"] = EVAL_BATCHES * B / seconds
        print(f"{'main path, ' if fused else ''}eval fumi RNN through the "
              f"{path}: {EVAL_BATCHES} meta-batches, loss "
              f"{float(out[path]['loss'].mean()):.4f}; "
              f"{EVAL_BATCHES * B / seconds:.1f} episodes/s; launches "
              f"{counts}")
        if counts != expect:
            fail(f"eval fumi RNN through the {path}: launches {counts}, "
                 f"expected {expect}")
    k, e = out["fused kernel"], out["autograd engine"]
    loss_diff = float((k["loss"] - e["loss"]).abs().max())
    acc_diff = float((k["acc"] - e["acc"]).abs().max())
    per_query = 1.0 / (B * WAYS * EVAL_Q)
    print(f"eval fumi RNN: kernel vs engine per meta-batch: loss max|diff| "
          f"{loss_diff:.3e} (tolerance 1e-3), acc max|diff| {acc_diff:.4f} "
          f"(tolerance one query, {per_query:.4f})")
    if not (loss_diff <= 1e-3 and acc_diff <= per_query + 1e-6):
        fail("eval fumi RNN: fused kernel and autograd engine disagree")

    # a served token FuMI request, descriptions of lengths 1..12
    rng = np.random.RandomState(6)
    s_im = rng.randn(S, D).astype(np.float32)
    s_y = np.repeat(np.arange(WAYS), SHOTS).astype(np.int32)
    q_im = rng.randn(QN, D).astype(np.float32)
    s_tx = padded_tokens(rng, S)
    b_tx = np.stack([padded_tokens(rng, S) for _ in range(B)])
    b_im = rng.randn(B, S, D).astype(np.float32)
    b_q = rng.randn(B, QN, D).astype(np.float32)
    b_y = np.repeat(s_y[None], B, axis=0)
    clf = FewShotClassifier(cfg, params, vocab, device=dev)
    engine = FewShotClassifier(cfg, params, vocab, device=dev)
    engine._episode_fn = engine._build_episode_fn(force_engine=True)
    reset_counts()
    one = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    batch = clf.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx)
    by_path["serve fumi RNN"] = counts = read_counts()
    got = np.concatenate([one[None], batch])
    eng = np.concatenate([
        engine.episode_logits(s_im, s_y, q_im, support_text=s_tx)[None],
        engine.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx)])
    exact = np.concatenate([
        served_exact("fumi", clf, s_im[None], s_y[None], q_im[None],
                     s_tx[None]),
        served_exact("fumi", clf, b_im, b_y, b_q, b_tx)])
    diff = float(np.abs(got - eng).max())
    ties, same = served_argmax(got, eng, exact)
    print(f"main path, serve fumi RNN: a request with descriptions of "
          f"lengths 1..{TOKEN_LEN} and a batch of {B}: kernel vs autograd "
          f"engine max|diff| {diff:.3e} (tolerance 1e-3); argmax differs "
          f"on {ties} rows, each a tie the fp64 loop decides for the "
          f"kernel: {same}; launches {counts}")
    if not (diff <= 1e-3 and same and np.isfinite(got).all()):
        fail("serving fumi RNN: kernel and autograd engine disagree")
    if counts != dict({name: 0 for name in KERNEL_NAMES}, fused_adapt=2):
        fail(f"serve fumi RNN: launches {counts}, expected 2 fused_adapt")
    times["request ms"] = host_ms(lambda: clf.episode_logits(
        s_im, s_y, q_im, support_text=s_tx), reps=20)

    # the driver for FuMI RNN and AM3 glove
    runs = {}
    for model, enc in (("fumi", "RNN"), ("am3", "glove")):
        log_dir = os.path.join(root, f"{model}-{enc}")
        args = ["--model", model, "--text_encoder", enc, "--dataset",
                "synthetic", "--tpu_pallas_gather", "--tpu_pallas_fused_eval",
                "--epochs", str(DRIVER_EPOCHS), "--eval_freq",
                str(DRIVER_EVAL_FREQ), "--num_ep_test", str(DRIVER_EP_TEST),
                "--seed", "0", "--wandb_offline", "--log_dir", log_dir]
        reset_counts()
        t0 = time.perf_counter()
        res = cli_main.cli(args)
        times[f"driver {model} {enc} s"] = time.perf_counter() - t0
        by_path[f"driver {model} {enc}"] = counts = read_counts()
        (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
        runs[model] = (run, args)
        with open(os.path.join(run, "vocab.json")) as f:
            shipped = json.load(f) == vocab
        finite = all(np.isfinite(v) for v in res.values())
        # FuMI validates at batches 10 and 20, AM3 at 0 too
        val = (3 if model == "fumi" else 4) * (DRIVER_EP_TEST // B // 2 + 1)
        expect = {name: 0 for name in KERNEL_NAMES}
        expect["gather_episode_rows"] = (DRIVER_TRAIN_STEPS + val
                                         + DRIVER_TEST_BATCHES)
        if model == "fumi":
            expect["fused_adapt"] = val + DRIVER_TEST_BATCHES
        print(f"main path, driver {model} {enc}: TEST {res}; vocab.json "
              f"the synthetic dictionary: {shipped}; "
              f"{times[f'driver {model} {enc} s']:.3f} s of wall time; "
              f"launches {counts}")
        if not (finite and shipped):
            fail(f"driver {model} {enc}: non-finite test metrics or no "
                 "vocab.json")
        if counts != expect:
            fail(f"driver {model} {enc}: launches {counts}, expected "
                 f"{expect}")

    # serve the FuMI RNN run dir, in process and over HTTP
    run, args = runs["fumi"]
    cfg = config_from_args(args)
    reset_counts()
    clf = FewShotClassifier.from_checkpoint(run, cfg, device=dev)
    got = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(cfg.seed),
                          device=dev, dictionary=vocab)
    loaded, _, _ = ckpt_lib.load_checkpoint(run, st.params,
                                            st.opt.init(st.params))
    want = FewShotClassifier(cfg, loaded, vocab, device=dev).episode_logits(
        s_im, s_y, q_im, support_text=s_tx)
    by_path["serve fumi RNN from checkpoint"] = counts = read_counts()
    err = float(np.abs(got - want).max())
    print(f"main path, serve fumi RNN from checkpoint (vocab.json): "
          f"max|diff| to a classifier on load_checkpoint's params "
          f"{err:.3e} (tolerance 1e-6); launches {counts}")
    if err > 1e-6 or counts["fused_adapt"] != 2:
        fail("serving fumi RNN from its checkpoint disagrees")
    # a token id past the embedding table is refused before the device
    # sees it (an out-of-range index would fail the CUDA context)
    refused = []
    for bad_id in (TOKEN_VOCAB, -1):
        bad = s_tx.copy()
        bad[0, 0] = bad_id
        try:
            clf.episode_logits(s_im, s_y, q_im, support_text=bad)
        except RequestError as e:
            refused.append(str(e))
    again = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    print(f"serve fumi RNN: token ids {TOKEN_VOCAB} and -1 refused: "
          f"{refused}; the next request max|diff| to the first "
          f"{float(np.abs(again - got).max()):.3e} (tolerance 1e-6)")
    if len(refused) != 2 or float(np.abs(again - got).max()) > 1e-6:
        fail("serve fumi RNN: a token id outside the table was not "
             "refused, or the next request differs")

    with loopback(clf) as call:
        one = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
               "query_im": q_im.tolist(), "support_text": s_tx.tolist()}
        reset_counts()
        codes = {}
        codes["episode probs"], probs = call("/v1/episode",
                                             {**one, "return": "probs"})
        codes["episode labels"], labels = call("/v1/episode", one)
        no_text = {k: v for k, v in one.items() if k != "support_text"}
        codes["without support_text"], missing = call("/v1/episode",
                                                      no_text)
        bad = s_tx.copy()
        bad[0, 0] = TOKEN_VOCAB
        codes[f"token id {TOKEN_VOCAB}"], outside = call(
            "/v1/episode", {**one, "support_text": bad.tolist()})
        codes["after it"], probs_after = call("/v1/episode",
                                              {**one, "return": "probs"})
        by_path["http fumi RNN"] = counts = read_counts()
        p_err = float(np.abs(np.asarray(probs["result"])
                             - _np_softmax(got)).max())
        p_after = float(np.abs(np.asarray(probs_after["result"])
                               - np.asarray(probs["result"])).max())
        same = labels["result"] == got.argmax(-1).tolist()
        print(f"main path, http fumi RNN: status {codes} ({missing}; "
              f"{outside}); labels equal in process: {same}, "
              f"probabilities max|diff| {p_err:.3e} (tolerance 1e-5), "
              f"after the refused request {p_after:.3e} (tolerance 1e-6); "
              f"launches {counts}")
        if codes != {"episode probs": 200, "episode labels": 200,
                     "without support_text": 400,
                     f"token id {TOKEN_VOCAB}": 400, "after it": 200} or \
                not same or p_err > 1e-5 or p_after > 1e-6:
            fail("http fumi RNN: status codes or answers differ")
        if counts != dict({name: 0 for name in KERNEL_NAMES},
                          fused_adapt=3):
            fail(f"http fumi RNN: launches {counts}, expected 3 "
                 "fused_adapt")
        body = json.dumps(one).encode()
        times["http ms"] = host_ms(lambda: call("/v1/episode", body),
                                   reps=20)

    print("token encoders, train episodes/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times["train eps"].items())
        + f"; BERT beside them: fumi {bert_eps['fumi']:.1f}, am3 "
        f"{bert_eps['am3']:.1f}")
    return times



# ---------------------------------------------------------------------------
# Phases 7g-7i: the real datasets' layouts, the meta-gradient variants and
# the family registry
# ---------------------------------------------------------------------------

def new_counts(**launches):
    """Expected launch counts: every kernel 0 but those named."""
    out = {name: 0 for name in KERNEL_NAMES}
    out.update(launches)
    return out


def driver_batches(epochs: int, ep_test: int, val_passes: int = 3):
    """(train steps, eval meta-batches) a driver run launches the episode
    gather for: ``epochs + 1`` steps, ``val_passes`` validation passes of
    ``ep_test // B // 2 + 1`` meta-batches and a test pass of
    ``ep_test // B + 1``."""
    return epochs + 1, (val_passes * (ep_test // B // 2 + 1)
                        + ep_test // B + 1)


def timed_train(st, smp, label, reset_counts, read_counts, by_path,
                chunk=DATA_CHUNK):
    """A warm chunk of ``make_chunked_train`` on ``smp``, then a timed one
    (its launches under ``by_path[label]``: one ``gather_episode_rows`` a
    step and no other kernel). Returns (episodes/s, the timed chunk's
    state ``(run, params, opt state, generator, seconds a step)``)."""
    import torch
    from fumi_tpu_torch.train import steps
    run = steps.make_chunked_train(st.family, st.opt, smp, chunk)
    p, s, gen, warm = run(st.params, st.opt.init(st.params), smp.generator(1))
    box = {}
    reset_counts()
    seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
    by_path[label] = counts = read_counts()
    p2, _, _, ms = box["out"]
    losses = torch.cat([warm["loss"], ms["loss"]])
    moved = max(float((p2[k] - st.params[k]).abs().max()) for k in p2)
    eps = chunk * B / seconds
    print(f"main path, {label}: 2 chunks of {chunk} steps, loss "
          f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, params moved "
          f"up to {moved:.3e}; timed chunk {seconds:.3f} s = {eps:.1f} "
          f"episodes/s; launches {counts}")
    if not bool(torch.isfinite(losses).all()) or moved == 0.0:
        fail(f"{label}: non-finite losses or params unmoved")
    if counts != new_counts(gather_episode_rows=chunk):
        fail(f"{label}: launches {counts}, expected {chunk} "
             "gather_episode_rows")
    return eps, (run, p, s, gen, seconds / chunk)


def busy_line(label, state, card, steps_n=5):
    """Device ms and operations a step (``torch.profiler`` over
    ``steps_n`` steps) against the wall time a step of the timed chunk;
    printed as phase 7f prints them. Returns (device ms, operations, wall
    ms) a step, or None where the trace holds no device time."""
    run, p, s, gen, step_s = state
    traced = device_profile(lambda: run(p, s, gen, steps_n))
    if traced is None:
        print(f"{label}: device busy share not measured (the profiler "
              f"recorded no device time) [{card}]")
        return None
    dev_ms, ops = traced[0] / steps_n, traced[1] / steps_n
    print(f"{label}: device time {dev_ms:.3f} ms a step in {ops:.0f} device "
          f"operations (torch.profiler, {steps_n} steps) against "
          f"{1e3 * step_s:.3f} ms of wall time a step: busy "
          f"{100 * dev_ms / (1e3 * step_s):.1f}% [{card}]")
    return dev_ms, ops, 1e3 * step_s


def cub_fixture(root: str, dev):
    """``<root>/CUB`` at CUB_200_2011's scale, as ``prepare cub`` writes
    it: 11,788 rows of 2048 fp32 (96.6 MB, N(0, 1) from a seed, drawn on
    the card) in class order, 200 classes of 58 or 59 rows split
    100/50/50 in class order (ids 1..200). Returns the test split's
    rows."""
    import numpy as np
    import torch
    out = os.path.join(root, "CUB")
    os.makedirs(out)
    counts = np.full(CUB_CLASSES, CUB_ROWS // CUB_CLASSES, np.int32)
    counts[:CUB_ROWS % CUB_CLASSES] += 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gen = torch.Generator(device=dev).manual_seed(11)
    np.save(os.path.join(out, "image_embeddings.npy"),
            torch.randn((CUB_ROWS, D), generator=gen, device=dev)
            .cpu().numpy())
    tabs, first = {}, 0
    for split, n in zip(("train", "val", "test"), CUB_SPLIT):
        cls = np.arange(first, first + n)
        first += n
        rows = np.zeros((n, counts.max()), np.int32)
        for i, c in enumerate(cls):
            rows[i, :counts[c]] = np.arange(starts[c], starts[c] + counts[c])
        tabs[f"{split}_rows"] = rows
        tabs[f"{split}_counts"] = counts[cls]
        tabs[f"{split}_categories"] = (cls + 1).astype(np.int32)
    np.savez(os.path.join(out, "class_image_rows.npz"), **tabs)
    return tabs["test_rows"]


def cub_phase(dev, root, card, reset_counts, read_counts, by_path) -> dict:
    """Phase 7g (CUB): the driver, ``python -m fumi_tpu_torch.cli.main
    --dataset cub``, for MAML (``--tpu_pallas_gather
    --tpu_pallas_fused_eval``: one ``gather_episode_rows`` a step and a
    meta-batch, one ``fused_maml_adapt_batched`` a meta-batch) and
    ProtoNet (the gather only), phase 7's epochs on a CUB_200_2011-scale
    ``<root>/CUB``; the test CSV's query rows from the test classes; then
    train episodes/s through the driver's own loader, samplers and steps.
    Returns the times."""
    import csv
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.train import steps
    times = {}
    t0 = time.perf_counter()
    test_rows = set(cub_fixture(root, dev).ravel().tolist())
    times["cub fixture s"] = time.perf_counter() - t0
    train_n, eval_n = driver_batches(DRIVER_EPOCHS, DRIVER_EP_TEST)
    for model in ("maml", "protonet"):
        log_dir = os.path.join(root, f"cub-{model}")
        args = ["--model", model, "--dataset", "cub", "--data_dir", root,
                "--tpu_pallas_gather", "--epochs", str(DRIVER_EPOCHS),
                "--eval_freq", str(DRIVER_EVAL_FREQ), "--num_ep_test",
                str(DRIVER_EP_TEST), "--seed", "0", "--wandb_offline",
                "--log_dir", log_dir]
        if model == "maml":
            args.append("--tpu_pallas_fused_eval")
        reset_counts()
        t0 = time.perf_counter()
        out = cli_main.cli(args)
        torch.cuda.synchronize()
        wall = times[f"driver {model} cub s"] = time.perf_counter() - t0
        by_path[f"driver {model} cub"] = counts = read_counts()
        (csv_path,) = glob.glob(os.path.join(log_dir, "results", "run_*.csv"))
        with open(csv_path) as f:
            table = list(csv.reader(f))
        col = table[0].index("query_idx")
        queries = {i for r in table[1:] for i in json.loads(r[col])}
        expect = new_counts(gather_episode_rows=train_n + eval_n)
        if model == "maml":
            expect["fused_maml_adapt_batched"] = eval_n
        finite = all(np.isfinite(v) for v in out.values())
        print(f"main path, driver {model} --dataset cub: TEST {out}; "
              f"{len(table) - 1} CSV rows, query rows of the test classes: "
              f"{queries <= test_rows}; {wall:.3f} s of wall time; launches "
              f"{counts} [{card}]")
        if not (finite and queries and queries <= test_rows
                and len(table) - 1 == (DRIVER_EP_TEST // B + 1) * B):
            fail(f"driver {model} --dataset cub: non-finite test metrics "
                 "or a CSV of other rows")
        if counts != expect:
            fail(f"driver {model} --dataset cub: launches {counts}, "
                 f"expected {expect}")
        cfg = config_from_args(args)
        splits, table_np, ids, _ = cli_main._load_data(cfg)
        train_s = cli_main._samplers(cfg, splits, table_np, ids, dev)[0]
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        times[f"train {model} cub eps"], _ = timed_train(
            st, train_s, f"train {model} cub", reset_counts, read_counts,
            by_path)
    print(f"cub (200 classes, {CUB_ROWS} x {D} fp32, split "
          f"{'/'.join(map(str, CUB_SPLIT))}): fixture "
          f"{times['cub fixture s']:.3f} s; driver maml "
          f"{times['driver maml cub s']:.3f} s, protonet "
          f"{times['driver protonet cub s']:.3f} s; train episodes/s maml "
          f"{times['train maml cub eps']:.1f}, protonet "
          f"{times['train protonet cub eps']:.1f} [{card}]")
    return times



def inat_fixture(root: str):
    """``<root>/inat_anim.json`` at the paper's scale, 673 species and
    195,605 images (290 or 291 a species, ids assigned to species in a
    seeded shuffle), with descriptions of 12 to 47 words (a quarter of
    them stop words) from a seeded 5000-word vocabulary, and the BERT
    artifact ``text_embeddings_bert_description.npy`` (673 x 768, N(0,
    1)). Returns the annotations."""
    import numpy as np
    rng = np.random.RandomState(12)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    pool = np.array(sorted({"".join(rng.choice(letters, rng.randint(4, 10)))
                            for _ in range(5000)}))
    stop = np.array(["the", "a", "of", "in", "and", "with", "its", "is",
                     "on", "at"])

    def words(n):
        picked = np.where(rng.rand(n) < 0.25,
                          stop[rng.randint(0, len(stop), n)],
                          pool[rng.randint(0, len(pool), n)])
        return " ".join(picked.tolist())
    cats = [{"id": i, "name": words(2), "common_name": words(2),
             "description": words(rng.randint(12, 48))}
            for i in range(INAT_CLASSES)]
    counts = np.full(INAT_CLASSES, INAT_IMAGES // INAT_CLASSES)
    counts[:INAT_IMAGES % INAT_CLASSES] += 1
    labels = np.repeat(np.arange(INAT_CLASSES), counts)
    rng.shuffle(labels)
    ann = {"categories": cats,
           "images": [{"id": i} for i in range(INAT_IMAGES)],
           "annotations": [{"category_id": int(c)} for c in labels]}
    with open(os.path.join(root, "inat_anim.json"), "w") as f:
        json.dump(ann, f)
    np.save(os.path.join(root, "text_embeddings_bert_description.npy"),
            rng.randn(INAT_CLASSES, E).astype(np.float32))
    return ann


def inat_phase(Config, dev, root, card, reset_counts, read_counts,
               by_path) -> dict:
    """Phase 7g (iNat-Anim): the loader's table-building part
    (``inat_anim_from_annotations``: the card's machine has no h5py for
    the HDF5 read) on a paper-scale fixture and a 195,605 x 2048 fp32
    table (1.60 GB, N(0, 1) drawn on the card), then the driver's samplers
    (the table resident on the card) and steps: FuMI training (one
    ``gather_episode_rows`` a step) and eval through ``fused_adapt``; CLIP
    on the supervised split for one epoch through the driver's CLIP run
    (no kernel); ``prepare vectors`` on a GloVe text file of 300-wide
    vectors over the fixture's vocabulary, then FuMI RNN on those vectors
    (the embedding table holds them): train steps and an eval meta-batch.
    Returns the times."""
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.data import inat_anim, prepare
    from fumi_tpu_torch.data.vectors import Vocabulary, vectors_for_encoder
    from fumi_tpu_torch.models.text_encoders import EMBED
    from fumi_tpu_torch.train import steps
    from fumi_tpu_torch.train.logging import MetricWriter
    times = {}
    t0 = time.perf_counter()
    ann = inat_fixture(root)
    times["fixture s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    table = torch.randn((INAT_IMAGES, D), generator=gen, device=dev) \
        .cpu().numpy()
    times["table s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = inat_anim.inat_anim_from_annotations(ann, table, root,
                                                text_encoder="BERT")
    times["build s"] = time.perf_counter() - t0
    sizes = {k: v.num_classes for k, v in data.splits.items()}
    per = data.splits["train"].class_counts
    print(f"inat-anim fixture: {INAT_CLASSES} species, {INAT_IMAGES} "
          f"images ({per.min()}-{per.max()} a species), splits {sizes}; "
          f"json and artifact {times['fixture s']:.3f} s, the "
          f"{table.nbytes / 1e9:.2f} GB table {times['table s']:.3f} s, "
          f"inat_anim_from_annotations "
          f"{times['build s']:.3f} s [{card}]")
    if sizes != {"train": 403, "val": 135, "test": 135} or \
            data.splits["train"].text_features.shape[1] != E:
        fail(f"inat-anim fixture: splits {sizes}")

    # FuMI through the driver's samplers and steps
    cfg = train_cfg(Config, "fumi").replace(
        dataset="inat-anim", data_dir=root, text_encoder="BERT",
        pallas_fused_eval=True)
    t0 = time.perf_counter()
    train_s, _, test_s = cli_main._samplers(cfg, data.splits,
                                            data.image_table,
                                            data.image_ids, dev)
    torch.cuda.synchronize()
    times["to card s"] = time.perf_counter() - t0
    resident = train_s.tables.image_table
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    times["train fumi eps"], state = timed_train(
        st, train_s, "train fumi inat-anim", reset_counts, read_counts,
        by_path)
    times["busy"] = busy_line("train fumi inat-anim", state, card)
    run = steps.make_chunked_eval(st.family, test_s)
    run(state[1], test_s.generator(99), 1)  # warm
    box = {}
    reset_counts()
    seconds = synced_s(lambda: box.update(
        out=run(state[1], test_s.generator(3), EVAL_BATCHES)))
    by_path["eval fumi inat-anim"] = counts = read_counts()
    times["eval fumi eps"] = EVAL_BATCHES * B / seconds
    loss = box["out"][1]["loss"]
    print(f"main path, eval fumi inat-anim through fused_adapt: "
          f"{EVAL_BATCHES} meta-batches, loss {float(loss.mean()):.4f}; "
          f"{times['eval fumi eps']:.1f} episodes/s; the table on the card "
          f"{tuple(resident.shape)} {resident.dtype} "
          f"({resident.numel() * resident.element_size() / 1e9:.2f} GB, "
          f"moved in {times['to card s']:.3f} s); launches {counts} "
          f"[{card}]")
    if not bool(torch.isfinite(loss).all()) or counts != new_counts(
            gather_episode_rows=EVAL_BATCHES, fused_adapt=EVAL_BATCHES):
        fail(f"eval fumi inat-anim: non-finite loss or launches {counts}")
    del train_s, test_s, resident, st, run, state, box
    torch.cuda.empty_cache()

    # CLIP on the supervised split, one epoch, through the driver's run
    ccfg = Config(model="clip", dataset="supervised-inat-anim",
                  data_dir=root, text_encoder="BERT", im_emb_dim=D,
                  text_emb_dim=E, batch_size=CLIP_BATCH, epochs=1,
                  lr=CLIP_LR, seed=0, wandb_offline=True,
                  log_dir=os.path.join(root, "clip"))
    results = os.path.join(ccfg.log_dir, "results")
    os.makedirs(results)
    writer = MetricWriter(results, use_wandb=False, offline=True)
    run_dir = os.path.join(ccfg.log_dir, "runs", writer.run_name)
    os.makedirs(run_dir)
    items = int(data.splits["train"].class_counts.sum())
    reset_counts()
    t0 = time.perf_counter()
    out = cli_main._run_clip(ccfg, dev, writer, run_dir, data.splits,
                             data.image_table)
    torch.cuda.synchronize()
    times["clip epoch s"] = time.perf_counter() - t0
    writer.finish()
    by_path["clip supervised-inat-anim"] = counts = read_counts()
    n_steps = -(-items // CLIP_BATCH)
    print(f"main path, clip supervised-inat-anim: one epoch of {items} "
          f"items ({n_steps} steps of {CLIP_BATCH}), validation and the "
          f"test pass in {times['clip epoch s']:.3f} s; TEST {out}; "
          f"launches {counts} [{card}]")
    if not 0.0 <= out["test/acc"] <= 1.0 or counts != new_counts():
        fail(f"clip supervised-inat-anim: TEST {out}, launches {counts}")

    # prepare vectors on a GloVe text file, then FuMI RNN on the vectors
    words = sorted({w for c in ann["categories"] for k in (
        "name", "common_name", "description") for w in c[k].split()})
    vrng = np.random.RandomState(14)
    src = os.path.join(root, "glove.300d.txt")
    t0 = time.perf_counter()
    with open(src, "w") as f:
        for w in words[:-5]:  # five words stay out of vocabulary
            f.write(w + " " + " ".join(
                f"{v:.5f}" for v in vrng.randn(GLOVE_DIM)) + "\n")
    rc = prepare.main(["vectors", "--src", src, "--kind", "glove",
                       "--data_dir", root])
    times["vectors s"] = time.perf_counter() - t0
    if rc != 0:
        fail(f"prepare vectors: exit code {rc}")
    rdata = inat_anim.inat_anim_from_annotations(ann, table, root,
                                                 text_encoder="RNN")
    vectors = vectors_for_encoder("RNN", root)
    vocab = Vocabulary(rdata.dictionary.token2id, vectors)
    cfg = train_cfg(Config, "fumi").replace(
        dataset="inat-anim", data_dir=root, text_encoder="RNN",
        pallas_fused_eval=True)
    train_s, _, test_s = cli_main._samplers(cfg, rdata.splits,
                                            rdata.image_table,
                                            rdata.image_ids, dev)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev,
                          dictionary=vocab)
    word = words[0]
    pretrained = np.array_equal(
        st.params[EMBED][vocab[word]].cpu().numpy(), vectors[word])
    reset_counts()
    t0 = time.perf_counter()
    p, s, gen, ms = steps.make_chunked_train(st.family, st.opt, train_s,
                                             VECTOR_STEPS)(
        st.params, st.opt.init(st.params), train_s.generator(1))
    _, em = steps.make_chunked_eval(st.family, test_s)(
        p, test_s.generator(2), 1)
    torch.cuda.synchronize()
    times["fumi RNN s"] = time.perf_counter() - t0
    by_path["train and eval fumi RNN inat-anim glove"] = counts = \
        read_counts()
    T = rdata.splits["train"].text_features.shape[1]
    print(f"main path, fumi RNN on inat-anim with prepare vectors' "
          f"{len(vectors)} x {GLOVE_DIM} glove artifact "
          f"({times['vectors s']:.3f} s; the embedding table holds the "
          f"pretrained vectors: {pretrained}; descriptions padded to {T} "
          f"tokens): {VECTOR_STEPS} train steps, loss "
          f"{[round(float(x), 4) for x in ms['loss']]}, an eval meta-batch "
          f"through fused_adapt, loss {float(em['loss'][0]):.4f}; "
          f"{times['fumi RNN s']:.3f} s; launches {counts} [{card}]")
    if not (pretrained and bool(torch.isfinite(ms["loss"]).all())
            and bool(torch.isfinite(em["loss"]).all())):
        fail("fumi RNN on inat-anim glove: the vectors did not reach the "
             "encoder, or non-finite losses")
    if counts != new_counts(gather_episode_rows=VECTOR_STEPS + 1,
                            fused_adapt=1):
        fail(f"fumi RNN on inat-anim glove: launches {counts}")
    del train_s, test_s, st
    torch.cuda.empty_cache()
    return times



def engine_fp64(clf, s_im, s_y, q_im, s_tx):
    """(M, N) logits of one request through ``clf``'s autograd engine (the
    masked steps or the proximal solve it serves with) in fp64 on the
    CPU, from its weights."""
    import numpy as np
    import torch
    adapt_fn, classify_fn = clf._engine_fns()
    p = {k: v.double().cpu() for k, v in clf.params.items()}

    def d(a):
        return torch.from_numpy(np.asarray(a)).double()[None]
    text = d(s_tx) if s_tx is not None else torch.zeros((1, len(s_im), 1),
                                                        dtype=torch.float64)
    with torch.no_grad():
        state = adapt_fn(p, d(s_im), text, torch.from_numpy(s_y)[None], [0])
        return classify_fn(p, state, d(q_im))[0].numpy()


def variants_phase(Config, dev, root, card, train_smp, eval_smp, request,
                   reset_counts, read_counts, by_path) -> dict:
    """Phase 7h: the meta-gradient variants at the flagship training
    config, ANIL (``--tpu_adapt_params head``), Reptile, iMAML-MAML and
    iMAML-FuMI (``--tpu_meta_grad reptile|imaml``, FuMI with ``--dropout
    0``). For each: training on phase 5's sampler (one
    ``gather_episode_rows`` a step), the busy share of a step, one train
    step card against CPU (``hold_step``'s tolerances), the driver
    (``VARIANT_*`` depth; Reptile evaluates through
    ``fused_maml_adapt_batched``, the others through the autograd engine)
    and a served request from its run dir (Reptile through
    ``fused_adapt`` against the engine; ANIL and iMAML through the engine,
    card against CPU; each within 1e-3 or no farther than twice the other
    side from the same steps in fp64).
    Reptile's eval through the batched kernel against
    the engine, as phase 6 holds MAML's. Returns the times."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import steps
    s_im, s_y, q_im, s_tx = request
    times = {"train eps": {}, "busy": {}, "driver s": {}, "request ms": {}}
    train_n, eval_n = driver_batches(VARIANT_EPOCHS, VARIANT_EP_TEST)
    for name, model, kw, flags in VARIANTS:
        cfg = train_cfg(Config, model).replace(**kw)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        eps, state = timed_train(st, train_smp, f"train {name}",
                                 reset_counts, read_counts, by_path)
        times["train eps"][name] = eps
        times["busy"][name] = busy_line(f"train {name}", state, card)
        train_step_card_vs_cpu(cfg, train_smp, dev, label=name)

        if name == "reptile":
            out = {}
            for path, fused in (("fused kernel", True),
                                ("autograd engine", False)):
                fam = steps.build_family(cfg.replace(pallas_fused_eval=fused),
                                         torch.Generator().manual_seed(0))
                run = steps.make_chunked_eval(fam, eval_smp)
                reset_counts()
                out[path] = run(state[1], eval_smp.generator(3),
                                EVAL_BATCHES)[1]
                counts = read_counts()
                if fused:
                    by_path["eval reptile"] = counts
                expect = new_counts(gather_episode_rows=EVAL_BATCHES)
                if fused:
                    expect["fused_maml_adapt_batched"] = EVAL_BATCHES
                if counts != expect:
                    fail(f"eval reptile through the {path}: launches "
                         f"{counts}, expected {expect}")
            k, e = out["fused kernel"], out["autograd engine"]
            loss_diff = float((k["loss"] - e["loss"]).abs().max())
            acc_diff = float((k["acc"] - e["acc"]).abs().max())
            per_query = 1.0 / (B * WAYS * EVAL_Q)
            print(f"main path, eval reptile through fused_maml_adapt_batched"
                  f" vs the autograd engine: {EVAL_BATCHES} meta-batches, "
                  f"loss max|diff| {loss_diff:.3e} (tolerance 1e-3), acc "
                  f"max|diff| {acc_diff:.4f} (tolerance one query, "
                  f"{per_query:.4f}); launches {by_path['eval reptile']}")
            if not (bool(torch.isfinite(k["loss"]).all())
                    and loss_diff <= 1e-3 and acc_diff <= per_query + 1e-6):
                fail("eval reptile: fused kernel and engine disagree")

        # the driver, then a request served from its run dir
        log_dir = os.path.join(root, f"variant-{name}")
        args = ["--model", model, "--dataset", "synthetic",
                "--tpu_pallas_gather", "--tpu_pallas_fused_eval",
                "--epochs", str(VARIANT_EPOCHS), "--eval_freq",
                str(VARIANT_EVAL_FREQ), "--num_ep_test", str(VARIANT_EP_TEST),
                "--seed", "0", "--wandb_offline", "--log_dir", log_dir,
                *flags]
        reset_counts()
        t0 = time.perf_counter()
        res = cli_main.cli(args)
        torch.cuda.synchronize()
        times["driver s"][name] = time.perf_counter() - t0
        by_path[f"driver {name}"] = counts = read_counts()
        expect = new_counts(gather_episode_rows=train_n + eval_n)
        if name == "reptile":
            expect["fused_maml_adapt_batched"] = eval_n
        print(f"main path, driver {name}: TEST {res}; "
              f"{times['driver s'][name]:.3f} s of wall time; launches "
              f"{counts}")
        if not all(np.isfinite(v) for v in res.values()) or counts != expect:
            fail(f"driver {name}: non-finite test metrics or launches "
                 f"{counts}, expected {expect}")
        (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
        rcfg = config_from_args(args)
        text = s_tx if model == "fumi" else None
        clf = FewShotClassifier.from_checkpoint(run, rcfg, device=dev)
        reset_counts()
        got = clf.episode_logits(s_im, s_y, q_im, support_text=text)
        by_path[f"serve {name} from checkpoint"] = counts = read_counts()
        times["request ms"][name] = host_ms(lambda: clf.episode_logits(
            s_im, s_y, q_im, support_text=text), reps=3)
        if name == "reptile":
            other = FewShotClassifier(rcfg, clf.params, device=dev)
            other._episode_fn = other._build_episode_fn(force_engine=True)
            versus = "the autograd engine on the card"
            exact = served_exact("maml", clf, s_im[None], s_y[None],
                                 q_im[None], None)[0]
            expect = new_counts(fused_adapt=1)
        else:
            other = FewShotClassifier(
                rcfg, {k: v.cpu() for k, v in clf.params.items()},
                device="cpu")
            versus = "the same engine on the CPU"
            exact = engine_fp64(other, s_im, s_y, q_im, text)
            expect = new_counts()
        want = other.episode_logits(s_im, s_y, q_im, support_text=text)
        # two fp32 evaluations of 100 steps summed in other orders: within
        # 1e-3, or, where a ReLU near 0 flips on the way (the trajectory
        # itself then moves by ~1e-3 in fp32), no farther than twice the
        # other's distance from the same steps in fp64; an argmax may
        # differ only on a near-tie that fp64 decides for this side
        diff = float(np.abs(got - want).max())
        g64 = float(np.abs(got - exact).max())
        w64 = float(np.abs(want - exact).max())
        flips, same = served_argmax(got[None], want[None], exact[None])
        print(f"main path, serve {name} from its run dir: logits {got.shape}"
              f" vs {versus}: max|diff| {diff:.3e} (tolerance 1e-3, or at "
              f"most twice the other's distance from fp64); from the same "
              f"steps in fp64: {g64:.3e} against {w64:.3e}; argmax differs "
              f"on {flips} of {len(got)} queries, each a near-tie fp64 "
              f"decides for this side: {same}; "
              f"{times['request ms'][name]:.3f} ms a request; launches "
              f"{counts}")
        if not (np.isfinite(got).all() and (diff <= 1e-3 or g64 <= 2 * w64)
                and same) or counts != expect:
            fail(f"serve {name}: the answer or the launches differ "
                 f"({counts}, expected {expect})")
    print("meta-gradient variants: train episodes/s " + ", ".join(
        f"{k} {v:.1f}" for k, v in times["train eps"].items())
        + "; busy share a step " + ", ".join(
            f"{k} {100 * v[0] / v[2]:.1f}% ({v[1]:.0f} operations)"
            for k, v in times["busy"].items() if v is not None)
        + "; driver s " + ", ".join(
            f"{k} {v:.3f}" for k, v in times["driver s"].items())
        + "; request ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in times["request ms"].items())
        + f" [{card}]")
    return times


REGISTRY_MODULE = """
from fumi_tpu_torch.models import layers
from fumi_tpu_torch.ops import fewshot
from fumi_tpu_torch.train import steps


@steps.register_family("card_centroids")
def build(cfg, gen, dictionary=None):
    w, b = layers.linear_init(gen, cfg.im_emb_dim, cfg.prototype_dim)

    def embed(p, x):
        return layers.linear(p["proj.weight"], p["proj.bias"], x)

    def raw(p, ep):
        protos = steps.image_prototypes(embed(p, ep.support_im),
                                        ep.support_y, cfg.num_ways)
        q = embed(p, ep.query_im)
        preds = fewshot.predict_classes(protos, q)
        return (fewshot.prototypical_loss(protos, q, ep.query_y), preds,
                (preds == ep.query_y).float().mean())

    def train_loss(p, ep, gen):
        loss, preds, acc = raw(p, ep)
        return loss, {"acc": acc, "preds": preds}

    def eval_raw(p, ep, gen):
        loss, preds, acc = raw(p, ep)
        return {"loss": loss, "acc": acc, "preds": preds,
                "targets": ep.query_y}

    def serve(cfg, family):
        def adapt_fn(p, s_im, s_text, s_y, seeds):
            return steps.image_prototypes(embed(p, s_im), s_y, cfg.num_ways)

        def classify_fn(p, protos, q_im):
            return fewshot.prototype_logits(protos, embed(p, q_im))
        return adapt_fn, classify_fn

    return steps.Family(name="card_centroids",
                        params={"proj.weight": w, "proj.bias": b},
                        train_loss=train_loss, eval_raw=eval_raw,
                        eval_finalize=lambda raw: raw,
                        eval_reduce=dict(steps.EVAL_REDUCE), serve=serve)
"""


def registry_phase(dev, root, card, request, reset_counts, read_counts,
                   by_path) -> dict:
    """Phase 7i: a module written to ``root`` registers the family
    ``card_centroids`` (a linear embedding and class centroids) with a
    ``Family.serve`` hook; the driver runs it by ``--tpu_import`` for a
    few steps on the card (one ``gather_episode_rows`` a step and a
    meta-batch), and a request from its run dir goes through the hook,
    against the same hook on the CPU. Returns the times."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    s_im, s_y, q_im, _ = request
    mod_dir = os.path.join(root, "plugins")
    os.makedirs(mod_dir)
    with open(os.path.join(mod_dir, "card_centroids_family.py"), "w") as f:
        f.write(REGISTRY_MODULE)
    sys.path.insert(0, mod_dir)
    epochs, ep_test = 6, 8
    log_dir = os.path.join(root, "registry")
    args = ["--model", "card_centroids", "--tpu_import",
            "card_centroids_family", "--dataset", "synthetic",
            "--tpu_pallas_gather", "--epochs", str(epochs), "--eval_freq",
            "3", "--num_ep_test", str(ep_test), "--seed", "0",
            "--wandb_offline", "--log_dir", log_dir]
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = cli_main.cli(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path["driver card_centroids (--tpu_import)"] = counts = \
            read_counts()
        train_n, eval_n = driver_batches(epochs, ep_test)
        (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
        cfg = config_from_args(args)
        clf = FewShotClassifier.from_checkpoint(run, cfg, device=dev)
        reset_counts()
        got = clf.episode_logits(s_im, s_y, q_im)
        served = read_counts()
        ms = host_ms(lambda: clf.episode_logits(s_im, s_y, q_im))
        want = FewShotClassifier(
            cfg, {k: v.cpu() for k, v in clf.params.items()},
            device="cpu").episode_logits(s_im, s_y, q_im)
    finally:
        sys.path.remove(mod_dir)
    diff = float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))
    print(f"main path, registry: driver --tpu_import card_centroids_family "
          f"--model card_centroids: TEST {res}; {wall:.3f} s of wall time; "
          f"launches {counts}; a request through its Family.serve hook: "
          f"logits {got.shape}, against the hook on the CPU max|diff| "
          f"{diff:.3e} of the largest logit (tolerance 1e-4), "
          f"{ms:.3f} ms; launches {served} [{card}]")
    if not all(np.isfinite(v) for v in res.values()) or counts != new_counts(
            gather_episode_rows=train_n + eval_n):
        fail(f"registry driver: non-finite test metrics or launches "
             f"{counts}")
    if got.shape != (len(q_im), WAYS) or diff > 1e-4 or \
            served != new_counts():
        fail("registry: the hook's answer differs from the CPU's")
    return {"driver s": wall, "request ms": ms}



LATE_PHASES = ("cub", "inat", "variants", "registry")


def late_phases(names, Config, dev, root, card, samplers, request,
                reset_counts, read_counts, by_path) -> None:
    """Phases 7g (``cub``, ``inat``), 7h (``variants``) and 7i
    (``registry``), each in its own directory under ``root``; ``samplers``
    is phase 5's train and phase 6's eval sampler."""
    for name in names:
        where = os.path.join(root, f"phase-{name}")
        os.makedirs(where)
        t0 = time.perf_counter()
        if name == "cub":
            cub_phase(dev, where, card, reset_counts, read_counts, by_path)
        elif name == "inat":
            inat_phase(Config, dev, where, card, reset_counts, read_counts,
                       by_path)
        elif name == "variants":
            variants_phase(Config, dev, where, card, *samplers, request,
                           reset_counts, read_counts, by_path)
        else:
            registry_phase(dev, where, card, request, reset_counts,
                           read_counts, by_path)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phases 7j-7n: the bf16 compute policy and the raw-image backbones
# ---------------------------------------------------------------------------

def widen_bytes(m: int, d: int, elem: int) -> int:
    """Bytes a widening row gather must move: M rows of ``elem``-byte
    elements read, M fp32 rows written, M int32 indices read."""
    return m * d * (elem + 4) + 4 * m


def raw_tables(dev, rows: int = 0):
    """fp32, bf16 and uint8 raw tables (``rows`` or 512, 84, 84, 3) on
    the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(21)
    shape = (rows or RAW_TABLE_ROWS, RAW_SIZE, RAW_SIZE, RAW_CHANNELS)
    f32 = torch.rand(shape, generator=gen, device=dev)
    return {"fp32": f32, "bf16": f32.to(torch.bfloat16),
            "uint8": torch.randint(0, 256, shape, generator=gen,
                                   dtype=torch.uint8, device=dev)}


def check_raw_gathers(dev) -> float:
    """``gather_episode_rows`` on the contiguous (R, 84·84·3) view of raw
    fp32, bf16 and uint8 tables at the train and eval episodes, bitwise
    its plain version (the bf16 flagship table is held above). Returns
    the largest |diff|."""
    import torch
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(22)
    for label, t in raw_tables(dev).items():
        flat = t.reshape(t.shape[0], -1)
        for use, q in (("train", TRAIN_Q), ("eval", EVAL_Q)):
            rows = torch.randint(0, t.shape[0], (B, WAYS, SHOTS + q),
                                 generator=gen, dtype=torch.int32,
                                 device=dev)
            got = kernels.gather_episode_rows(flat, rows, SHOTS)
            want = kernels.gather_episode_rows_reference(flat, rows, SHOTS)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"gather_episode_rows on raw {label} rows ({use}) "
                     "differs from its plain version")
    print(f"kernel gather_episode_rows [raw fp32, bf16, uint8; "
          f"{RAW_TABLE_ROWS}x{RAW_SIZE}x{RAW_SIZE}x{RAW_CHANNELS} as rows of "
          f"{RAW_ROW}] vs plain: bitwise equal at the train and eval "
          "episodes")
    return 0.0


def check_matmul_route(dev) -> float:
    """The bf16 policy's matrix product on the card (cuBLAS's bf16 GEMM
    with an fp32 output, ``layers._CublasBf16Matmul``) against the CPU's
    route, the emulation (operands rounded to bf16, an fp32 product), run
    on the card at the flagship shapes: the result within 1e-5 of its
    scale (fp32 sums in another order) and never rounded to bf16; the
    operands' gradients, rounded to bf16 on both routes, within one bf16
    ulp (2⁻⁸) of their scale. Returns the result's largest |diff|."""
    import torch
    from fumi_tpu_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(23)
    worst = 0.0
    for label, a_shape, b_shape in (
            ("linear (4, 740, 2048) x (2048, 256)", (B, 740, D), (D, H1)),
            ("generated head (4, 740, 64) x (4, 64, 5)", (B, 740, H2),
             (B, H2, WAYS))):
        a = torch.randn(a_shape, generator=gen, device=dev).requires_grad_()
        b = torch.randn(b_shape, generator=gen, device=dev).requires_grad_()
        g = torch.randn(a_shape[:-1] + b_shape[-1:], generator=gen,
                        device=dev)
        got = layers.matmul_f32acc(a, b, torch.bfloat16)
        ga = torch.autograd.grad(got, (a, b), g)
        emu = torch.matmul(a.to(torch.bfloat16).float(),
                           b.to(torch.bfloat16).float())
        ge = torch.autograd.grad(emu, (a, b), g)
        got, emu = got.detach(), emu.detach()
        err = float((got - emu).abs().max())
        scale = float(emu.abs().max())
        g_err = max(float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(ga, ge))
        unrounded = not torch.equal(got, got.to(torch.bfloat16).float())
        print(f"bf16 matmul route {label}: cuBLAS bf16 GEMM with fp32 "
              f"output vs the emulation: max|diff| {err:.3e} "
              f"({err / scale:.2e} of the scale, tolerance 1e-5), result "
              f"not rounded to bf16: {unrounded}; gradients "
              f"{g_err:.2e} of their scale (tolerance 2^-8)")
        if not (err <= 1e-5 * scale and unrounded and g_err <= 2.0 ** -8):
            fail(f"bf16 matmul route {label} disagrees with the emulation")
        worst = max(worst, err)
    return worst


def hold_step_vs_fp64(label, cfg, episode, dev):
    """One train step's loss and meta-gradient on the card and on the CPU
    from the same weights on the same episode, each held against the same
    step in fp64 on the card (of the fp32 function, for a bf16 config):
    the card no farther from it than twice the CPU plus ``FP64_SLACK`` of
    its scale. Second order through batch-stat norms at 84×84 is
    ill-conditioned: both fp32 sides sit percents of the gradient's scale
    from fp64 after 5 inner steps (card 2.9%, CPU 6.9% in one run), and
    the card's atomics move it from run to run, so a card-against-CPU
    tolerance would hold rounding, not the port."""
    import torch
    from fumi_tpu_torch.core.episode import Episode
    from fumi_tpu_torch.train import steps
    out = {}
    for where, device, dtype, c in (
            ("card", dev, torch.float32, cfg),
            ("cpu", "cpu", torch.float32, cfg),
            ("fp64", dev, torch.float64,
             cfg.replace(compute_dtype="float32"))):
        fam = steps.build_family(c, torch.Generator().manual_seed(0))
        p = {k: v.to(device, dtype) for k, v in fam.params.items()}
        ep = Episode(*(None if t is None else t.to(device).to(
            dtype if t.is_floating_point() else t.dtype) for t in episode))
        (loss, _), grads = steps.value_and_grad(fam, p, ep, None)
        out[where] = (float(loss), {k: v.double().cpu()
                                    for k, v in grads.items()})
    l64, g64 = out["fp64"]
    scale = max(float(g.abs().max()) for g in g64.values())
    slack = FP64_SLACK[cfg.compute_dtype]
    dist = {w: (abs(out[w][0] - l64), max(float((out[w][1][k] - g).abs()
                                                 .max())
                                           for k, g in g64.items()))
            for w in ("card", "cpu")}
    print(f"{label} against fp64: loss card {out['card'][0]:.6f}, cpu "
          f"{out['cpu'][0]:.6f}, fp64 {l64:.6f}; meta-gradient max|diff| "
          f"to fp64 card {dist['card'][1]:.3e}, cpu {dist['cpu'][1]:.3e} "
          f"(scale {scale:.3e}; the card within twice the CPU's distance "
          f"+ {slack:.1e} of the scale)")
    ok = all(dist["card"][i] <= 2 * dist["cpu"][i] + slack * s
             for i, s in ((0, abs(l64)), (1, scale)))
    if not ok:
        fail(f"{label}: the card is farther from fp64 than the CPU")


def served_vs_fp64(label, clf, request):
    """A served request on the card and on the CPU (the classifier's
    weights), each held against the same engine in fp64 on the card (of
    the fp32 function, for a bf16 config): the card's logits no farther
    from it than twice the CPU's plus ``FP64_SLACK`` of their scale, the
    card's labels those of fp64 but for near-ties. 100 SGD steps through
    a conv backbone's batch-stat norms carry fp32 rounding to ~1e-2 of
    the logits' scale, a little more or less from run to run on either
    device (:func:`hold_step_vs_fp64`). Returns the request's ms."""
    import numpy as np
    import torch
    from fumi_tpu_torch.serve import FewShotClassifier
    cfg = clf.cfg
    cpu = FewShotClassifier(cfg, {k: v.cpu() for k, v in
                                  clf.params.items()}, device="cpu")
    s_im, s_y, q_im, s_tx = request
    got = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    cpu_got = cpu.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    ref = FewShotClassifier(cfg.replace(compute_dtype="float32"),
                            clf.params, device=clf.device)
    adapt_fn, classify_fn = ref._engine_fns()
    p64 = {k: v.double() for k, v in clf.params.items()}

    def f64(a):
        return torch.from_numpy(np.asarray(a, np.float64))[None].to(
            clf.device)
    with torch.no_grad():
        state = adapt_fn(p64, f64(s_im), f64(s_tx),
                         torch.from_numpy(s_y)[None].to(clf.device), [0])
        want = classify_fn(p64, state, f64(q_im))[0].cpu().numpy()
    scale = float(np.abs(want).max())
    slack = FP64_SLACK[cfg.compute_dtype]
    d_card = float(np.abs(got - want).max())
    d_cpu = float(np.abs(cpu_got - want).max())
    top = np.sort(want, axis=-1)
    ties = top[:, -1] - top[:, -2] <= 2 * d_card
    same = (got.argmax(-1) == want.argmax(-1)) | ties
    ms = host_ms(lambda: clf.episode_logits(s_im, s_y, q_im,
                                            support_text=s_tx))
    print(f"served {label}: logits {got.shape}, max|diff| to fp64 card "
          f"{d_card:.3e}, cpu {d_cpu:.3e} (scale {scale:.3e}; the card "
          f"within twice the CPU's distance + {slack:.1e} of the scale), "
          f"labels those of fp64 but for near-ties: {bool(same.all())}; a "
          f"request {ms:.3f} ms")
    if not (np.isfinite(got).all() and same.all()
            and d_card <= 2 * d_cpu + slack * scale):
        fail(f"served {label}: the card is farther from fp64 than the CPU")
    return ms


def bf16_phase(Config, dev, table, ids_np, cset, card, reset_counts,
               read_counts, by_path) -> dict:
    """Phase 7j: the bf16 policy at the flagship widths. The table stored
    in bf16 (``table_storage``, 16 MiB) on the kernel gather: FuMI and
    MAML training (chunks of 20, one ``gather_episode_rows`` a step), a
    FuMI and a MAML step, card and CPU held against fp64
    (:func:`hold_step_vs_fp64`), their eval (8 meta-batches through the
    engine: the fused kernels compute fp32 only), a served FuMI request
    through the engine card against CPU, AM3 training and CLIP steps.
    Returns the times."""
    import numpy as np
    import torch
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import (DeviceEpisodeSampler,
                                             table_storage)
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import clip_loop, optim, steps
    times = {"matmul route err": check_matmul_route(dev)}
    bf = table_storage(table, "bfloat16")
    train_s = DeviceEpisodeSampler(bf, ids_np, cset, EpisodeSpec(
        B, WAYS, SHOTS, TRAIN_Q, D, E), use_pallas_gather=True, device=dev)
    eval_s = DeviceEpisodeSampler(bf, ids_np, cset, EpisodeSpec(
        B, WAYS, SHOTS, EVAL_Q, D, E), use_pallas_gather=True, device=dev)
    print(f"bf16 table on the card: {tuple(bf.shape)} {bf.dtype} "
          f"({bf.numel() * 2 / 2 ** 20:.0f} MiB) [{card}]")
    for model in ("fumi", "maml", "am3"):
        cfg = train_cfg(Config, model, compute_dtype="bfloat16",
                        pallas_fused_eval=True)
        if model == "am3":
            cfg = cfg.replace(text_encoder="BERT", prototype_dim=64)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        times[f"train {model} eps"], state = timed_train(
            st, train_s, f"train {model} bf16", reset_counts, read_counts,
            by_path, chunk=DATA_CHUNK if model != "am3" else 5)
        if model == "fumi":
            times["busy"] = busy_line("train fumi bf16", state, card)
        if model == "am3":
            continue
        hold_step_vs_fp64(f"train step {model} bf16", cfg.replace(
            dropout=0.0), train_s.sample(train_s.generator(7)), dev)
        run = steps.make_chunked_eval(st.family, eval_s)
        run(state[1], eval_s.generator(99), 1)  # warm
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(
            out=run(state[1], eval_s.generator(3), EVAL_BATCHES)))
        by_path[f"eval {model} bf16"] = counts = read_counts()
        times[f"eval {model} eps"] = EVAL_BATCHES * B / seconds
        loss = box["out"][1]["loss"]
        print(f"main path, eval {model} bf16 through the engine: "
              f"{EVAL_BATCHES} meta-batches, loss {float(loss.mean()):.4f}; "
              f"{times[f'eval {model} eps']:.1f} episodes/s; launches "
              f"{counts} [{card}]")
        if not bool(torch.isfinite(loss).all()) or counts != new_counts(
                gather_episode_rows=EVAL_BATCHES):
            fail(f"eval {model} bf16: non-finite loss or launches {counts}")
        if model == "fumi":
            clf = FewShotClassifier(cfg.replace(dropout=0.0), state[1],
                                    device=dev)
            srng = np.random.RandomState(31)
            request = (srng.randn(S, D).astype(np.float32),
                       np.repeat(np.arange(WAYS), SHOTS).astype(np.int32),
                       srng.randn(QN, D).astype(np.float32),
                       srng.randn(S, E).astype(np.float32))
            reset_counts()
            times["request fumi ms"] = served_vs_fp64(
                "fumi bf16 (the engine, 100 steps)", clf, request)
            by_path["serve fumi bf16"] = counts = read_counts()
            if counts["fused_adapt"]:
                fail("a bf16 request launched the fp32 fused kernel")
        del st, run, state, box
    # CLIP in bf16: a few train steps on random deduped batches
    ccfg = Config(model="clip", dataset="synthetic", compute_dtype="bfloat16",
                  im_emb_dim=D, text_emb_dim=E, seed=0)
    model, p = clip_loop.make_clip(ccfg, torch.Generator().manual_seed(0))
    p = {k: v.to(dev) for k, v in p.items()}
    opt = optim.init_optim(ccfg.optim, 1e-3, ccfg.weight_decay,
                           ccfg.momentum)
    o = opt.init(p)
    gen = torch.Generator(device=dev).manual_seed(32)
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(CLIP_BF16_STEPS):
        text = torch.randn((CLIP_BATCH, E), generator=gen, device=dev)
        image = torch.randn((CLIP_BATCH, D), generator=gen, device=dev)
        p, o, loss = clip_loop.train_step(model, opt, p, o, text, image,
                                          CLIP_BATCH)
        losses.append(float(loss))
    times["clip steps/s"] = CLIP_BF16_STEPS / (time.perf_counter() - t0)
    by_path["clip bf16"] = counts = read_counts()
    print(f"clip bf16: {CLIP_BF16_STEPS} train steps, loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, {times['clip steps/s']:.1f} steps/s; "
          f"launches {counts} [{card}]")
    if not np.isfinite(losses).all() or counts != new_counts():
        fail("clip bf16: non-finite loss or a kernel launch")
    del train_s, eval_s, bf
    torch.cuda.empty_cache()
    return times


def raw_cfg(Config, model: str, encoder: str, **kw):
    """The raw-image config at the JAX package's defaults: 84×84×3, 5-way
    5-shot, 32 train queries a class, B=4, 5 second-order inner steps,
    Adam; resnet12 at (64, 160, 320, 640); the kernel gather on."""
    base = dict(model=model, im_encoder=encoder, im_size=RAW_SIZE,
                im_channels=RAW_CHANNELS, text_encoder="precomputed",
                text_emb_dim=E, text_hid_dim=TH, prototype_dim=64,
                num_ways=WAYS, num_shots=SHOTS, num_shots_test=TRAIN_Q,
                batch_size=B, num_train_adapt_steps=INNER_STEPS,
                num_test_adapt_steps=STEPS, step_size=STEP_SIZE,
                optim="adam", lr=LR, weight_decay=5e-4, dropout=0.0,
                pallas_gather=True, seed=0)
    base.update(kw)
    return Config(**base)


def raw_samplers(dev, queries=None, augment=False, compute_dtype="float32"):
    """Samplers over the synthetic raw set at 84×84×3 (64 classes of 64
    images, 347 MB fp32 on the card) with the kernel gather, one for each
    of ``queries`` a class (default the train and eval episodes')."""
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import (DeviceEpisodeSampler,
                                             table_storage)
    from fumi_tpu_torch.data.synthetic import synthetic_raw_image_set
    import torch
    cs, table, ids = synthetic_raw_image_set(
        num_classes=TABLE_CLASSES, images_per_class=TABLE_IMAGES,
        im_size=RAW_SIZE, channels=RAW_CHANNELS, text_dim=E)
    t = table_storage(torch.from_numpy(table), compute_dtype).to(dev)
    return [DeviceEpisodeSampler(t, ids, cs, EpisodeSpec(
        B, WAYS, SHOTS, q, RAW_SIZE, E), use_pallas_gather=True,
        augment_scale=AUG_SCALE if augment else 0.0, device=dev)
        for q in queries or (TRAIN_Q, EVAL_Q)]


def raw_request(seed: int):
    """A raw request: 5-way 5-shot support images and 20 queries."""
    import numpy as np
    m = RAW_REQUEST_Q
    rng = np.random.RandomState(seed)
    shape = (RAW_SIZE, RAW_SIZE, RAW_CHANNELS)
    return (rng.rand(S, *shape).astype(np.float32),
            np.repeat(np.arange(WAYS), SHOTS).astype(np.int32),
            rng.rand(m, *shape).astype(np.float32),
            rng.randn(S, E).astype(np.float32))


def conv4_phase(Config, dev, card, reset_counts, read_counts,
                by_path) -> dict:
    """Phase 7k: conv4 at 84×84×3, fp32 and bf16. MAML training (B=4, 5
    second-order steps, one ``gather_episode_rows`` a step) with its busy
    share, a step card against CPU (on two tasks of 5+2 images a class),
    an eval meta-batch through the engine (100 steps), a served request
    card against CPU (:func:`hold_step_vs_fp64` says why the step is held
    against fp64); in fp32 also FuMI, AM3 and ProtoNet steps and MAML
    under ``--augment`` (the flip and crop, no kernel but the gather).
    Returns the times."""
    import torch
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import steps
    times = {}
    for dtype in ("float32", "bfloat16"):
        tag = "conv4" if dtype == "float32" else "conv4 bf16"
        train_s, eval_s = raw_samplers(dev, compute_dtype=dtype)
        cfg = raw_cfg(Config, "maml", "conv4", compute_dtype=dtype)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        times[f"train maml {tag} eps"], state = timed_train(
            st, train_s, f"train maml {tag}", reset_counts, read_counts,
            by_path, chunk=RAW_CHUNK)
        times[f"busy maml {tag}"] = busy_line(f"train maml {tag}", state,
                                              card, steps_n=2)
        small = raw_samplers(dev, queries=(2,), compute_dtype=dtype)[0]
        small_cfg = cfg.replace(batch_size=2, num_shots_test=2)
        episode = small.sample(small.generator(7))
        episode = type(episode)(*(None if t is None else t[:2]
                                  for t in episode))
        hold_step_vs_fp64(f"train step maml {tag} (2 tasks, 5+2 a class)",
                          small_cfg, episode, dev)
        run = steps.make_chunked_eval(st.family, eval_s)
        reset_counts()
        box = {}
        seconds = synced_s(lambda: box.update(
            out=run(state[1], eval_s.generator(3), 1)))
        by_path[f"eval maml {tag}"] = counts = read_counts()
        times[f"eval maml {tag} s"] = seconds
        loss = box["out"][1]["loss"]
        print(f"main path, eval maml {tag}: a meta-batch through the engine "
              f"({STEPS} steps), loss {float(loss[0]):.4f} in "
              f"{seconds:.3f} s; launches {counts} [{card}]")
        if not bool(torch.isfinite(loss).all()) or counts != new_counts(
                gather_episode_rows=1):
            fail(f"eval maml {tag}: non-finite loss or launches {counts}")
        clf = FewShotClassifier(cfg, state[1], device=dev)
        reset_counts()
        times[f"request maml {tag} ms"] = served_vs_fp64(
            f"maml {tag} (M={RAW_REQUEST_Q}, {STEPS} steps)", clf,
            raw_request(33))
        by_path[f"serve maml {tag}"] = read_counts()
        del st, run, state, clf, small
        if dtype == "float32":
            for model in ("fumi", "am3", "protonet"):
                mcfg = raw_cfg(Config, model, "conv4")
                mst = steps.make_steps(mcfg, torch.Generator().manual_seed(0),
                                       device=dev)
                times[f"train {model} conv4 eps"], _ = timed_train(
                    mst, train_s, f"train {model} conv4", reset_counts,
                    read_counts, by_path, chunk=RAW_CHUNK)
                del mst
            aug_s = raw_samplers(dev, queries=(TRAIN_Q,), augment=True)[0]
            ep = aug_s.sample(aug_s.generator(5))
            plain = raw_samplers(dev, queries=(TRAIN_Q,))[0].sample(
                aug_s.generator(5))
            if torch.equal(ep.support_im, plain.support_im) or \
                    not torch.equal(ep.query_im, plain.query_im):
                fail("--augment on raw images: the flip and crop missed the "
                     "support images or touched the queries")
            st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
            times["train maml conv4 --augment eps"], _ = timed_train(
                st, aug_s, "train maml conv4 --augment", reset_counts,
                read_counts, by_path, chunk=RAW_CHUNK)
            del st, aug_s
        del train_s, eval_s
        torch.cuda.empty_cache()
    return times


def resnet12_phase(Config, dev, card, reset_counts, read_counts,
                   by_path) -> dict:
    """Phase 7l: resnet12 at 84×84×3 with channels (64, 160, 320, 640),
    MAML, 5 second-order steps. At B=4 with 32 queries a class,
    ``--tpu_remat auto`` (``save_convs``: whole-step checkpointing in the
    port): episodes/s and the peak memory of training, and a served
    request; ``off`` does not fit the 80 GB card there (every inner step's
    second-order graph is kept), so on one episode of 2 tasks with 5
    queries a class the loss and meta-gradient with ``auto`` are held
    against ``off`` with cuDNN deterministic (the loss within 1e-5 of
    itself, the gradient within 1e-4 of its largest entry) with the peak
    memory of each. Returns the times."""
    import torch
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import steps
    times = {}

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    cfg = raw_cfg(Config, "maml", "resnet12", remat="auto")
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    train_s = raw_samplers(dev, queries=(TRAIN_Q,))[0]
    (times["train eps remat auto"], state), times["peak GB train auto"] = \
        peak_of(lambda: timed_train(st, train_s, "train maml resnet12",
                                    reset_counts, read_counts, by_path,
                                    chunk=RESNET_CHUNK))
    print(f"train maml resnet12 --tpu_remat auto (remat_of "
          f"{steps.remat_of(cfg)!r}): peak memory "
          f"{times['peak GB train auto']:.2f} GB over its chunks [{card}]")
    clf = FewShotClassifier(cfg, state[1], device=dev)
    s_im, s_y, q_im, _ = raw_request(34)
    reset_counts()
    logits = clf.episode_logits(s_im, s_y, q_im)
    by_path["serve maml resnet12"] = counts = read_counts()
    times["request ms"] = host_ms(
        lambda: clf.episode_logits(s_im, s_y, q_im), reps=2)
    print(f"served maml resnet12: logits {logits.shape} in "
          f"{times['request ms']:.3f} ms ({STEPS} steps through the "
          f"engine); launches {counts} [{card}]")
    if not (logits.shape == (RAW_REQUEST_Q, WAYS)
            and bool(torch.isfinite(torch.from_numpy(logits)).all())):
        fail("served maml resnet12: wrong shape or non-finite logits")
    del st, state, clf, train_s
    small = raw_samplers(dev, queries=(5,))[0]
    episode = small.sample(small.generator(9))
    episode = type(episode)(*(None if t is None else t[:2] for t in episode))
    out = {}
    # the same cuDNN algorithms on both sides and in the recompute: with
    # atomics in its backward, second order through 12 batch-stat norms
    # carries run-to-run rounding to percents of the gradient's scale
    torch.backends.cudnn.deterministic = True
    for remat in ("auto", "off"):
        rcfg = cfg.replace(remat=remat, batch_size=2, num_shots_test=5)
        fam = steps.build_family(rcfg, torch.Generator().manual_seed(0))
        params = {k: v.to(dev) for k, v in fam.params.items()}
        t0 = time.perf_counter()
        ((loss, _), grads), peak = peak_of(lambda: steps.value_and_grad(
            fam, params, episode, None))
        out[remat] = (float(loss), grads)
        times[f"peak GB remat {remat}"] = peak
        print(f"maml resnet12 --tpu_remat {remat} (2 tasks, 5+5 a class): "
              f"loss {float(loss):.6f}, a value_and_grad "
              f"{time.perf_counter() - t0:.3f} s, peak memory {peak:.2f} GB "
              f"[{card}]")
        del fam, params, grads
    torch.backends.cudnn.deterministic = False
    (l_a, g_a), (l_o, g_o) = out["auto"], out["off"]
    g_all = max(float(g.abs().max()) for g in g_o.values())
    g_err = max(float((g_a[k] - g).abs().max()) for k, g in g_o.items())
    print(f"maml resnet12 remat auto vs off: loss {l_a:.6f} vs {l_o:.6f}, "
          f"meta-gradient max|diff| {g_err:.3e} ({g_err / g_all:.2e} of its "
          f"largest entry; tolerance 1e-4); peak memory "
          f"{times['peak GB remat auto']:.2f} GB (auto) vs "
          f"{times['peak GB remat off']:.2f} GB (off) [{card}]")
    if not (abs(l_a - l_o) <= 1e-5 * abs(l_o) and g_err <= 1e-4 * g_all):
        fail("resnet12: remat changed the loss or the meta-gradient")
    del small, episode, out
    torch.cuda.empty_cache()
    return times


def raw_inat_phase(Config, dev, root, card, reset_counts, read_counts,
                   by_path) -> dict:
    """Phase 7m: the raw iNat-Anim layout at the paper's scale: 195,605
    uint8 images of 84×84×3 (4.14 GB; drawn on the card) through the
    loader's table-building part on the 673-species fixture of phase 7g,
    resident on the card; ``gather_episode_rows`` on rows near the end of
    the table (past 2³¹ bytes) bitwise its plain version; then the conv4
    MAML driver (``cli.main --dataset inat-anim --im_encoder conv4
    --augment --tpu_pallas_gather``, the HDF5 read replaced by the table,
    as the card's machine has no h5py; ``--tpu_im_size 32`` so the
    driver's adoption of the stored 84×84×3 shows) at phase 7h's depth.
    Returns the times."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.data import inat_anim
    from fumi_tpu_torch.ops import kernels
    times = {}
    os.makedirs(root, exist_ok=True)
    inat_fixture(root)
    gen = torch.Generator(device=dev).manual_seed(41)
    t0 = time.perf_counter()
    table = torch.randint(0, 256, (INAT_IMAGES, RAW_SIZE, RAW_SIZE,
                                   RAW_CHANNELS), generator=gen,
                          dtype=torch.uint8, device=dev)
    flat = table.reshape(INAT_IMAGES, -1)
    end = torch.arange(INAT_IMAGES - B * WAYS * (SHOTS + 2), INAT_IMAGES,
                       device=dev, dtype=torch.int32).reshape(
        B, WAYS, SHOTS + 2)
    got = kernels.gather_episode_rows(flat, end, SHOTS)
    want = kernels.gather_episode_rows_reference(flat, end, SHOTS)
    torch.cuda.synchronize()
    last = (INAT_IMAGES - 1) * RAW_ROW
    print(f"kernel gather_episode_rows at the end of the {INAT_IMAGES}-row "
          f"uint8 table ({table.numel() / 1e9:.2f} GB; the last row starts "
          f"at byte {last}, past 2^31 = {2 ** 31}): bitwise equal to its "
          f"plain version: "
          f"{all(torch.equal(g, w) for g, w in zip(got, want))}")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("gather_episode_rows differs past 2^31 bytes of the table")
    host = table.cpu().numpy()
    del table, flat, got, want
    torch.cuda.empty_cache()
    times["table s"] = time.perf_counter() - t0
    real = inat_anim.load_raw_image_table
    inat_anim.load_raw_image_table = lambda root_, *a: host
    log_dir = os.path.join(root, "driver")
    argv = ["--model", "maml", "--dataset", "inat-anim", "--data_dir", root,
            "--im_encoder", "conv4", "--tpu_im_size", "32",
            "--text_encoder", "BERT", "--augment", "--tpu_pallas_gather",
            "--batch_size", str(B), "--epochs", str(VARIANT_EPOCHS), "--eval_freq",
            str(VARIANT_EVAL_FREQ), "--num_ep_test", str(VARIANT_EP_TEST),
            "--log_dir", log_dir, "--wandb_offline"]
    train_n, eval_n = driver_batches(VARIANT_EPOCHS, VARIANT_EP_TEST)
    buf = io.StringIO()
    reset_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            test = cli_main.main(config_from_args(argv), dev)
        torch.cuda.synchronize()
        times["driver s"] = time.perf_counter() - t0
    finally:
        inat_anim.load_raw_image_table = real
    by_path["driver maml conv4 inat-anim raw"] = counts = read_counts()
    adopted = [l for l in buf.getvalue().splitlines() if "adopting" in l]
    run = glob.glob(os.path.join(log_dir, "runs", "*"))
    with open(os.path.join(run[0], "config.json")) as f:
        geometry = (json.load(f)["im_size"],)
    print(f"main path, driver maml conv4 on the raw inat-anim layout: "
          f"{adopted[0] if adopted else 'no adoption printed'}; config "
          f"im_size {geometry[0]}; TEST {test}; {times['driver s']:.3f} s; "
          f"the {host.nbytes / 1e9:.2f} GB table made and checked in "
          f"{times['table s']:.3f} s; launches {counts} [{card}]")
    if not (adopted and geometry[0] == RAW_SIZE
            and np.isfinite(test["test/loss"])
            and counts == new_counts(gather_episode_rows=train_n + eval_n)):
        fail(f"driver maml conv4 inat-anim: adopted {adopted}, TEST {test}, "
             f"launches {counts}, expected {train_n + eval_n} gathers")
    del host
    return times


def raw_drivers_phase(dev, root, card, reset_counts, read_counts,
                      by_path) -> dict:
    """Phase 7n: the driver (``cli.main --dataset synthetic``) for MAML and
    FuMI on conv4 at 84×84×3 (``--tpu_pallas_gather``, phase 7h's depth)
    and for FuMI at the flagship widths under ``--tpu_compute_dtype
    bfloat16``; each run dir served with ``from_checkpoint`` (a request
    card against CPU), and the conv4 MAML run over HTTP (one raw request,
    5-D; the answer equal to the in-process one). Returns the times."""
    import torch
    times = {}
    train_n, eval_n = driver_batches(VARIANT_EPOCHS, VARIANT_EP_TEST)
    common = ["--dataset", "synthetic", "--tpu_pallas_gather",
              "--batch_size", str(B), "--epochs", str(VARIANT_EPOCHS), "--eval_freq", str(VARIANT_EVAL_FREQ),
              "--num_ep_test", str(VARIANT_EP_TEST), "--wandb_offline"]
    raw = ["--im_encoder", "conv4", "--tpu_im_size", str(RAW_SIZE),
           "--text_encoder", "precomputed"]
    cases = (("maml conv4", ["--model", "maml"] + raw),
             ("fumi conv4", ["--model", "fumi"] + raw),
             ("fumi bf16", ["--model", "fumi", "--tpu_compute_dtype",
                            "bfloat16", "--tpu_pallas_fused_eval"]))
    for label, extra in cases:
        # the conv4 cases run cuDNN's deterministic algorithms: the
        # backward's atomics otherwise make each run train other weights,
        # and 100 served SGD steps through batch-stat norms at FuMI's
        # logit scale (~25) carry that into both devices' distance to fp64
        # (0.02 to 4 from run to run, on either device); with one set of
        # weights each run reads the same distances, and the HTTP answer
        # is the in-process one to the bit
        torch.backends.cudnn.deterministic = "conv4" in label
        try:
            raw_driver_case(label, extra + common, root, dev, card,
                            reset_counts, read_counts, by_path, times,
                            train_n + eval_n)
        finally:
            torch.backends.cudnn.deterministic = False
    return times


def raw_driver_case(label, argv, root, dev, card, reset_counts, read_counts,
                    by_path, times, gathers) -> None:
    """One case of :func:`raw_drivers_phase`: the driver on ``argv``
    (``gathers`` episode launches), its run dir served against fp64, and
    for conv4 MAML one raw request over HTTP; its times into ``times``."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    log_dir = os.path.join(root, label.replace(" ", "-"))
    cfg = config_from_args(argv + ["--log_dir", log_dir])
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        test = cli_main.main(cfg, dev)
    torch.cuda.synchronize()
    times[f"driver {label} s"] = time.perf_counter() - t0
    by_path[f"driver {label}"] = counts = read_counts()
    run = glob.glob(os.path.join(log_dir, "runs", "*"))[0]
    print(f"main path, driver {label}: TEST {test}; "
          f"{times[f'driver {label} s']:.3f} s; launches {counts} "
          f"[{card}]")
    if not (np.isfinite(test["test/loss"])
            and 0 <= test["test/acc"] <= 1
            and counts == new_counts(gather_episode_rows=gathers)):
        fail(f"driver {label}: TEST {test}, launches {counts}, "
             f"expected {gathers} gathers")
    clf = FewShotClassifier.from_checkpoint(run, cfg, best=False,
                                            device=dev)
    if "conv4" in label:
        request = raw_request(35)
    else:
        srng = np.random.RandomState(36)
        request = (srng.randn(S, D).astype(np.float32),
                   np.repeat(np.arange(WAYS), SHOTS).astype(np.int32),
                   srng.randn(QN, D).astype(np.float32),
                   srng.randn(S, E).astype(np.float32))
    times[f"request {label} ms"] = served_vs_fp64(
        f"{label} from its run dir", clf, request)
    if label == "maml conv4":
        s_im, s_y, q_im, _ = request
        body = {"support_im": s_im[None].tolist(),
                "support_y": s_y[None].tolist(),
                "query_im": q_im[None].tolist(), "return": "logits"}
        want = clf.episode_logits_batch(s_im[None], s_y[None], q_im[None])
        with loopback(clf) as call:
            t0 = time.perf_counter()
            status, answer = call("/v1/episode_batch", body)
            times["http raw ms"] = 1e3 * (time.perf_counter() - t0)
        got = np.asarray(answer.get("result", []), np.float32)
        err = float(np.abs(got - want).max()) if got.shape == \
            want.shape else float("inf")
        print(f"http raw request (5-D, 1x{S}x{RAW_SIZE}x{RAW_SIZE}x"
              f"{RAW_CHANNELS} support, {RAW_REQUEST_Q} queries): status "
              f"{status}, max|diff| to in process {err:.3e} (tolerance "
              f"1e-5), {times['http raw ms']:.1f} ms [{card}]")
        if status != 200 or err > 1e-5:
            fail("http raw request: wrong status or answer")
    del clf
    torch.cuda.empty_cache()


def time_raw_bf16_gathers(table, dev) -> dict:
    """``gather_episode_rows`` (device time in CUDA graphs of 100 calls)
    on the bf16 flagship table at the train and eval episodes, and on raw
    rows (84·84·3 in fp32, bf16, uint8) at the train episode, each beside
    its plain version, one ``index_select`` over the episode's rows (on
    the raw table's flat view; it does not widen) and its bytes bound at
    3.35 TB/s. The raw tables hold 4096 images (347 MB in fp32, past the
    50 MB L2, as the iNat-Anim table is). Returns {label: {"ms",
    "plain_ms", "library_ms", "bound_ms"}}."""
    import torch
    from fumi_tpu_torch.data.sampler import table_storage
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(51)
    cases = {"bf16 train": (table_storage(table, "bfloat16"), TRAIN_Q),
             "bf16 eval": (table_storage(table, "bfloat16"), EVAL_Q)}
    for label, t in raw_tables(dev, TABLE_CLASSES * TABLE_IMAGES).items():
        cases[f"raw {label} train"] = (t.reshape(t.shape[0], -1), TRAIN_Q)
    out = {}
    for label, (t, q) in cases.items():
        rows = [torch.randint(0, t.shape[0], (B, WAYS, SHOTS + q),
                              generator=gen, dtype=torch.int32, device=dev)
                for _ in range(100)]
        flat = [r.reshape(-1).long() for r in rows]
        calls = {"kernel": [lambda r=r: kernels.gather_episode_rows(
                     t, r, SHOTS) for r in rows],
                 "plain": [lambda r=r: kernels.gather_episode_rows_reference(
                     t, r, SHOTS) for r in rows],
                 "library": [lambda i=i: torch.index_select(t, 0, i)
                             for i in flat]}
        turns = {}
        for turn in ("kernel", "plain", "library", "library", "plain",
                     "kernel"):
            turns.setdefault(turn, []).append(graph_ms(calls[turn]))
        m = B * WAYS * (SHOTS + q)
        nbytes = widen_bytes(m, t.shape[1], t.element_size())
        out[label] = {"ms": statistics.median(turns["kernel"]),
                      "plain_ms": statistics.median(turns["plain"]),
                      "library_ms": statistics.median(turns["library"]),
                      "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S}
        r = out[label]
        print(f"gather_episode_rows {label} (M={m} rows of {t.shape[1]} "
              f"{t.dtype}): kernel {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, index_select (no widening) "
              f"{r['library_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us (bytes: {nbytes / 1e6:.2f} MB "
              f"at 3.35 TB/s): {100 * r['bound_ms'] / r['ms']:.0f}% of it")
    return out


PR10_PHASES = ("bf16", "conv4", "resnet12", "raw-inat", "raw-drivers")


def pr10_phases(names, Config, dev, root, card, table, ids_np, cset,
                reset_counts, read_counts, by_path) -> dict:
    """Phases 7j-7n, the ``names`` of :data:`PR10_PHASES` in order, each in
    its own directory under ``root``; the phases' times by name."""
    times = {}
    for name in names:
        t0 = time.perf_counter()
        where = os.path.join(root, f"phase-{name}")
        if name == "bf16":
            times[name] = bf16_phase(Config, dev, table, ids_np, cset, card,
                                     reset_counts, read_counts, by_path)
        elif name == "conv4":
            times[name] = conv4_phase(Config, dev, card, reset_counts,
                                      read_counts, by_path)
        elif name == "resnet12":
            times[name] = resnet12_phase(Config, dev, card, reset_counts,
                                         read_counts, by_path)
        elif name == "raw-inat":
            times[name] = raw_inat_phase(Config, dev, where, card,
                                         reset_counts, read_counts, by_path)
        elif name == "raw-drivers":
            times[name] = raw_drivers_phase(dev, where, card, reset_counts,
                                            read_counts, by_path)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return times


# ---------------------------------------------------------------------------
# Phases 7o-7s-b: the training extensions, the host samplers, reference
# checkpoints, resnet12's stage remat and conv4's block remat
# ---------------------------------------------------------------------------

# --tpu_ema 0.999 --tpu_skip_nonfinite 3; the host samplers timed over
# chunks of 20 train steps at --num_workers 0, 1 (the prefetch thread) and
# 4 (loader processes, fork), also on an iNat-Anim-sized table (673
# classes, 195,605 x 2048 fp32, 1.60 GB on the host)
EMA_DECAY, SKIP_LIMIT = 0.999, 3
HOST_STEPS, HOST_WORKERS, DEBUG_STEPS = 20, (0, 1, 4), 10


def add_counts(by_path, label, counts) -> None:
    """Sum ``counts`` into ``by_path[label]``."""
    into = by_path.setdefault(label, {name: 0 for name in counts})
    for name, n in counts.items():
        into[name] += n


def ema_phase(Config, dev, card, root, samplers, request, reset_counts,
              read_counts, by_path) -> dict:
    """Phase 7o: ``--tpu_ema 0.999 --tpu_skip_nonfinite 3`` at the
    flagship width for FuMI and MAML on phase 5's sampler: train
    episodes/s beside the same chunk without the flags (in turns: without,
    with, with, without); one step's EMA against ``0.999·e + 0.001·p`` of
    its own params (the same operations on the card: bitwise); an episode
    with a NaN support row leaves the params and the EMA bitwise as they
    were and counts 1; eval of the EMA through the fused kernels against
    the engine (1e-3); then the FuMI driver with the flags, its run dir
    served (``from_checkpoint`` serves the EMA, bitwise the restored
    state's) through ``fused_adapt`` against the engine (1e-3). Returns
    the times."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import checkpoint as ckpt_lib
    from fumi_tpu_torch.train import optim, steps
    from fumi_tpu_torch.train.loop import eval_view
    train_smp, eval_smp = samplers
    times = {}
    for model in ("fumi", "maml"):
        cfgs = {"without": train_cfg(Config, model),
                "with": train_cfg(Config, model, ema=EMA_DECAY,
                                  skip_nonfinite=SKIP_LIMIT)}
        runs = {}
        for name, cfg in cfgs.items():
            st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
            run = steps.make_chunked_train(st.family, st.opt, train_smp,
                                           TRAIN_CHUNK)
            runs[name] = (st, run, run(st.params, st.opt.init(st.params),
                                       train_smp.generator(1), 2)[:3])
        eps = {name: [] for name in cfgs}
        for name in ("without", "with", "with", "without"):
            st, run, (p, s, gen) = runs[name]
            box = {}
            reset_counts()
            seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
            counts = read_counts()
            if name == "with":
                add_counts(by_path, f"train {model} --tpu_ema", counts)
            losses = box["out"][3]["loss"]
            if counts != new_counts(gather_episode_rows=TRAIN_CHUNK) or \
                    not bool(torch.isfinite(losses).all()):
                fail(f"train {model} ({name} --tpu_ema): non-finite losses "
                     f"or launches {counts}")
            runs[name] = (st, run, box["out"][:3])
            eps[name].append(TRAIN_CHUNK * B / seconds)
        times[f"train {model} eps"] = eps
        print(f"main path, train {model} --tpu_ema {EMA_DECAY} "
              f"--tpu_skip_nonfinite {SKIP_LIMIT}: "
              f"{', '.join(f'{e:.1f}' for e in eps['with'])} episodes/s, "
              f"without the flags {', '.join(f'{e:.1f}' for e in eps['without'])}"
              f" (chunks of {TRAIN_CHUNK} steps, in turns) [{card}]")

        st, _, (p, s, gen) = runs["with"]
        cfg = cfgs["with"]
        episode = train_smp.sample(gen)
        p1, s1, _ = st.train_step(p, s, episode, gen)
        e0, e1 = optim.find_ema(s), optim.find_ema(s1)
        recomputed = all(torch.equal(
            e1[k], EMA_DECAY * e0[k] + (1.0 - EMA_DECAY) * p1[k]) for k in p1)
        im = episode.support_im.clone()
        im[0, 3, 7] = float("nan")
        p2, s2, m = st.train_step(p1, s1, episode._replace(support_im=im),
                                  gen)
        kept = all(torch.equal(p2[k], p1[k]) and torch.equal(
            optim.find_ema(s2)[k], e1[k]) for k in p1)
        counted = (int(s2["notfinite_count"]), int(s2["total_notfinite"]),
                   bool(s2["last_finite"]))
        print(f"train {model} --tpu_ema: the EMA after a step equals "
              f"0.999·e + 0.001·p of that step's params: {recomputed}; an "
              f"episode with a NaN support row (loss {float(m['loss'])}): "
              f"params and EMA unchanged {kept}, (notfinite_count, "
              f"total_notfinite, last_finite) {counted}")
        if not (recomputed and kept and counted == (1, 1, False)):
            fail(f"train {model} --tpu_ema: the EMA or the skip is wrong")

        ema = eval_view(cfg, p2, s2)
        out = {}
        for path, fused in (("fused kernel", True), ("autograd engine",
                                                     False)):
            family = steps.build_family(cfg.replace(pallas_fused_eval=fused),
                                        torch.Generator().manual_seed(0))
            run = steps.make_chunked_eval(family, eval_smp)
            reset_counts()
            out[path] = run(ema, eval_smp.generator(3), EVAL_BATCHES)[1]
            counts = read_counts()
            kernel = "fused_adapt" if model == "fumi" else \
                "fused_maml_adapt_batched"
            want = new_counts(gather_episode_rows=EVAL_BATCHES,
                              **({kernel: EVAL_BATCHES} if fused else {}))
            if fused:
                add_counts(by_path, f"eval {model} of the EMA", counts)
            if counts != want:
                fail(f"eval {model} of the EMA through the {path}: launches "
                     f"{counts}, expected {want}")
        diff = float((out["fused kernel"]["loss"]
                      - out["autograd engine"]["loss"]).abs().max())
        print(f"main path, eval {model} of the EMA: loss "
              f"{float(out['fused kernel']['loss'].mean()):.4f} through "
              f"{kernel}, max|diff| to the engine {diff:.3e} (tolerance "
              "1e-3)")
        if not diff <= 1e-3:
            fail(f"eval {model} of the EMA: kernel and engine disagree")

    log_dir = os.path.join(root, "fumi-ema")
    args = ["--model", "fumi", "--dataset", "synthetic",
            "--tpu_pallas_gather", "--tpu_pallas_fused_eval", "--epochs",
            str(DRIVER_EPOCHS), "--eval_freq", str(DRIVER_EVAL_FREQ),
            "--num_ep_test", str(DRIVER_EP_TEST), "--seed", "0",
            "--wandb_offline", "--tpu_ema", str(EMA_DECAY),
            "--tpu_skip_nonfinite", str(SKIP_LIMIT), "--log_dir", log_dir]
    reset_counts()
    t0 = time.perf_counter()
    test = cli_main.cli(args)
    times["driver fumi --tpu_ema s"] = time.perf_counter() - t0
    counts = read_counts()
    add_counts(by_path, "driver fumi --tpu_ema", counts)
    if counts != new_counts(gather_episode_rows=DRIVER_TRAIN_STEPS
                            + DRIVER_EVAL_BATCHES,
                            fused_adapt=DRIVER_EVAL_BATCHES) or \
            not np.isfinite(test["test/loss"]):
        fail(f"driver fumi --tpu_ema: TEST {test}, launches {counts}")
    (run_dir,) = glob.glob(os.path.join(log_dir, "runs", "*"))
    cfg = config_from_args(args)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    _, state, _ = ckpt_lib.load_checkpoint(run_dir, st.params,
                                           st.opt.init(st.params))
    clf = FewShotClassifier.from_checkpoint(run_dir, cfg, device=dev)
    ema_served = all(torch.equal(clf.params[k], v)
                     for k, v in optim.find_ema(state).items())
    s_im, s_y, q_im, s_tx = request
    reset_counts()
    got = clf.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    counts = read_counts()
    add_counts(by_path, "serve fumi --tpu_ema from checkpoint", counts)
    engine = FewShotClassifier(cfg, clf.params, device=dev)
    engine._episode_fn = engine._build_episode_fn(force_engine=True)
    diff = float(np.abs(got - engine.episode_logits(
        s_im, s_y, q_im, support_text=s_tx)).max())
    print(f"main path, driver fumi --tpu_ema: TEST {test} in "
          f"{times['driver fumi --tpu_ema s']:.3f} s; its run dir served: "
          f"the EMA {ema_served}, kernel vs engine max|diff| {diff:.3e} "
          f"(tolerance 1e-3), launches {counts}")
    if not (ema_served and diff <= 1e-3
            and counts == new_counts(fused_adapt=1)):
        fail("serving the --tpu_ema run dir: not the EMA, or the kernel "
             "and the engine disagree")
    return times


def debug_nans_phase(Config, dev, card, train_smp, reset_counts,
                     read_counts, by_path) -> dict:
    """Phase 7p: ``--tpu_debug_nans`` on FuMI at the flagship width: a
    chunk of 10 steps with the check and without it from the same state
    and generator gives bitwise the same losses and params; a step on an
    episode with a NaN support row raises ``FloatingPointError`` naming
    the step and the loss. Returns the times."""
    import torch
    from fumi_tpu_torch.train import steps
    times, out = {}, {}
    for flag in (False, True):
        cfg = train_cfg(Config, "fumi", debug_nans=flag)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        run = steps.make_chunked_train(st.family, st.opt, train_smp,
                                       DEBUG_STEPS, debug_nans=flag)
        run(st.params, st.opt.init(st.params), train_smp.generator(1), 2)
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(out=run(
            st.params, st.opt.init(st.params), train_smp.generator(4))))
        counts = read_counts()
        if flag:
            add_counts(by_path, "train fumi --tpu_debug_nans", counts)
        if counts != new_counts(gather_episode_rows=DEBUG_STEPS):
            fail(f"train fumi --tpu_debug_nans={flag}: launches {counts}")
        out[flag] = box["out"]
        times[f"eps debug_nans={flag}"] = DEBUG_STEPS * B / seconds
    same = torch.equal(out[False][3]["loss"], out[True][3]["loss"]) and \
        all(torch.equal(out[False][0][k], out[True][0][k])
            for k in out[False][0])
    episode = train_smp.sample(train_smp.generator(5))
    im = episode.support_im.clone()
    im[1, 0, 0] = float("nan")
    try:
        st.train_step(st.params, st.opt.init(st.params),
                      episode._replace(support_im=im),
                      train_smp.generator(6), step=11)
        raised = "nothing"
    except FloatingPointError as e:
        raised = str(e)
    print(f"train fumi --tpu_debug_nans: {DEBUG_STEPS} steps with the check "
          f"and without it bitwise equal (losses and params): {same}; "
          f"{times['eps debug_nans=True']:.1f} against "
          f"{times['eps debug_nans=False']:.1f} episodes/s; a NaN episode "
          f"raised: {raised!r} [{card}]")
    if not (same and "train step 11" in raised and "loss" in raised):
        fail("--tpu_debug_nans: a finite run changed, or a NaN step did "
             "not raise")
    return times


def inat_sized_table(table_np):
    """The flagship table tiled to iNat-Anim's 195,605 rows, as 673
    classes of 290-291 images (the paper's counts), with 768-wide text;
    host numpy, 1.60 GB."""
    import numpy as np
    from fumi_tpu_torch.data.class_set import ClassSet, build_class_tables
    reps = -(-INAT_IMAGES // table_np.shape[0])
    table = np.tile(table_np, (reps, 1))[:INAT_IMAGES]
    splits = np.array_split(np.arange(INAT_IMAGES, dtype=np.int32),
                            INAT_CLASSES)
    cats = np.arange(INAT_CLASSES)
    rows, counts = build_class_tables(cats, dict(zip(cats, splits)))
    text = np.random.RandomState(11).randn(INAT_CLASSES, E).astype(
        np.float32)
    return (ClassSet(categories=cats, class_image_rows=rows,
                     class_counts=counts, text_features=text), table,
            np.arange(INAT_IMAGES, dtype=np.int32))


def host_sampler_phase(Config, dev, card, root, table_np, ids_np, cset,
                       train_smp, reset_counts, read_counts,
                       by_path) -> dict:
    """Phase 7q: the host samplers (``--tpu_host_sampler``). The port's
    native index sampler builds with ``g++`` and is the backend; episodes
    assembled for the card equal the CPU's bitwise; ``--augment`` episodes
    equal ``augment_embeddings_reference`` of the CPU's rows at the seed
    the numpy stream draws, through the standalone kernel (one launch an
    episode); FuMI train episodes/s at ``--num_workers`` 0, 1 and 4
    beside the device sampler, on the flagship table and on an
    iNat-Anim-sized one; FuMI and MAML eval through the fused kernels on
    host episodes; the FuMI driver with ``--tpu_host_sampler
    --num_workers 4``. Returns the times."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch import native
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data import sampler as smp_mod
    from fumi_tpu_torch.ops import kernels
    from fumi_tpu_torch.train import steps
    times = {}
    t0 = time.perf_counter()
    lib = native.load()
    print(f"native sampler: {native.lib_path()} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s: {lib is not None}")
    if lib is None:
        fail("the native index sampler did not build")
    train_spec = EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E)
    eval_spec = EpisodeSpec(B, WAYS, SHOTS, EVAL_Q, D, E)

    def host(spec, seed, device=dev, table=table_np, ids=ids_np,
             cs=cset, **kw):
        return smp_mod.HostEpisodeSampler(table, ids, cs, spec, seed=seed,
                                          device=device, **kw)
    card_s, cpu_s = host(train_spec, 7), host(train_spec, 7, "cpu")
    if card_s.backend_name != "native":
        fail(f"host sampler backend {card_s.backend_name}, not native")
    reset_counts()
    same = True
    for _ in range(3):
        a, b = card_s.sample(), cpu_s.sample()
        same &= all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                    for f in ("support_im", "support_text", "support_ids",
                              "support_y", "query_im", "query_ids",
                              "query_y"))
    aug_s, clean = host(train_spec, 8, augment_scale=AUG_SCALE), \
        host(train_spec, 8, "cpu")
    mirror = np.random.RandomState(8)
    jittered = True
    for _ in range(3):
        a, c = aug_s.sample(), clean.sample()
        seed = torch.tensor([int(mirror.randint(0, 2 ** 31))],
                            dtype=torch.int64, device=dev)
        want = kernels.augment_embeddings_reference(
            c.support_im.reshape(-1, D).to(dev), seed, AUG_SCALE)
        jittered &= torch.equal(a.support_im.reshape(-1, D), want) and \
            torch.equal(a.query_im.cpu(), c.query_im)
    counts = read_counts()
    add_counts(by_path, "host sampler --augment", counts)
    print(f"main path, host sampler (native): card episodes equal the CPU "
          f"assembly bitwise {same}; --augment episodes equal "
          f"augment_embeddings_reference at the numpy stream's seeds "
          f"{jittered}; launches {counts}")
    if not (same and jittered and counts == new_counts(augment_embeddings=3)):
        fail("host sampler: card episodes differ from the CPU's, or the "
             "jitter is not the kernel's")

    cfg = train_cfg(Config, "fumi")
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    state0 = (st.params, st.opt.init(st.params))
    gen = torch.Generator(device=dev).manual_seed(3)

    def timed_host(smp, label):
        p, s = state0
        for _ in range(2):  # warm
            p, s, _ = st.train_step(p, s, smp.sample(), gen)
        reset_counts()

        def steps_():
            nonlocal p, s
            for _ in range(HOST_STEPS):
                p, s, m = st.train_step(p, s, smp.sample(), gen)
            return m
        seconds = synced_s(steps_)
        counts = read_counts()
        add_counts(by_path, label, counts)
        if counts != new_counts():
            fail(f"{label}: launches {counts}, expected none (the host "
                 "gathers)")
        return HOST_STEPS * B / seconds

    run = steps.make_chunked_train(st.family, st.opt, train_smp, HOST_STEPS)
    run(*state0, train_smp.generator(1), 2)
    reset_counts()
    seconds = synced_s(lambda: run(*state0, train_smp.generator(2)))
    times["train fumi eps, device sampler"] = HOST_STEPS * B / seconds
    read_counts()
    big = None
    for table_name in ("flagship", "inat-sized"):
        if table_name == "inat-sized":
            t0 = time.perf_counter()
            big = inat_sized_table(table_np)
            times["inat-sized table s"] = time.perf_counter() - t0
        for workers in HOST_WORKERS:
            if big is None:
                base = host(train_spec, 0)
            else:
                base = host(train_spec, 0, table=big[1], ids=big[2],
                            cs=big[0])
            smp = (base if workers == 0 else
                   smp_mod.PrefetchingSampler(base, depth=2) if workers == 1
                   else smp_mod.MultiprocessSampler(base, workers))
            try:
                times[f"train fumi eps, {table_name}, {workers} workers"] = \
                    timed_host(smp, f"train fumi, host sampler {table_name} "
                               f"--num_workers {workers}")
            finally:
                getattr(smp, "close", lambda: None)()
    print("train fumi episodes/s (chunks of "
          f"{HOST_STEPS} steps): device sampler "
          f"{times['train fumi eps, device sampler']:.1f}; host sampler "
          + "; ".join(f"{t} table " + ", ".join(
              f"{w} workers {times[f'train fumi eps, {t}, {w} workers']:.1f}"
              for w in HOST_WORKERS) for t in ("flagship", "inat-sized"))
          + f" (the iNat-sized table built in "
          f"{times['inat-sized table s']:.2f} s) [{card}]")
    del big

    for model, kernel in (("fumi", "fused_adapt"),
                          ("maml", "fused_maml_adapt_batched")):
        ecfg = train_cfg(Config, model, pallas_fused_eval=True)
        est = steps.make_steps(ecfg, torch.Generator().manual_seed(0),
                               device=dev)
        smp = host(eval_spec, 1)
        est.eval_step(est.params, smp.sample(), None)  # warm
        reset_counts()
        box = {}
        seconds = synced_s(lambda: box.update(out=[
            est.eval_step(est.params, smp.sample(), None)
            for _ in range(EVAL_BATCHES)]))
        counts = read_counts()
        add_counts(by_path, f"eval {model}, host sampler", counts)
        times[f"eval {model} eps, host sampler"] = EVAL_BATCHES * B / seconds
        loss = float(np.mean([float(m["loss"]) for m in box["out"]]))
        print(f"main path, eval {model} on the host sampler: "
              f"{EVAL_BATCHES} meta-batches, loss {loss:.4f}; "
              f"{times[f'eval {model} eps, host sampler']:.1f} episodes/s; "
              f"launches {counts}")
        if counts != new_counts(**{kernel: EVAL_BATCHES}) or \
                not np.isfinite(loss):
            fail(f"eval {model} on the host sampler: launches {counts}")

    log_dir = os.path.join(root, "fumi-host")
    args = ["--model", "fumi", "--dataset", "synthetic",
            "--tpu_pallas_fused_eval", "--tpu_host_sampler", "--num_workers",
            "4", "--epochs", str(DRIVER_EPOCHS), "--eval_freq",
            str(DRIVER_EVAL_FREQ), "--num_ep_test", str(DRIVER_EP_TEST),
            "--seed", "0", "--wandb_offline", "--log_dir", log_dir]
    printed = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        test = cli_main.cli(args)
    times["driver fumi --tpu_host_sampler s"] = time.perf_counter() - t0
    counts = read_counts()
    add_counts(by_path, "driver fumi --tpu_host_sampler --num_workers 4",
               counts)
    lines = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith(("host sampler backend", "loader"))]
    (run_dir,) = glob.glob(os.path.join(log_dir, "runs", "*"))
    print(f"main path, driver fumi --tpu_host_sampler --num_workers 4: "
          f"{lines}; TEST {test}; "
          f"{times['driver fumi --tpu_host_sampler s']:.3f} s; best/ "
          f"{os.path.isdir(os.path.join(run_dir, 'best'))}; launches "
          f"{counts}")
    if lines != ["host sampler backend: native (--tpu_sampler_backend "
                 "auto; streams are backend-specific per seed)",
                 "loader: 4 worker processes (fork)"] or \
            counts != new_counts(fused_adapt=DRIVER_EVAL_BATCHES) or \
            not np.isfinite(test["test/loss"]):
        fail("driver fumi --tpu_host_sampler --num_workers 4: wrong loader, "
             "launches or test metrics")
    return times


def pth_phase(Config, dev, card, root, driver_dirs, request, reset_counts,
              read_counts, by_path) -> dict:
    """Phase 7r: reference ``.pth.tar`` files. Phase 7's FuMI and MAML run
    dirs exported by ``python -m fumi_tpu_torch.cli.export_torch`` and
    imported back (``interop.load_torch_checkpoint``): params and Adam's
    moments and count bitwise the run dir's; ``--evaluate --checkpoint
    x.pth.tar`` gives the run dir's test numbers exactly; ``from_checkpoint
    (x.pth.tar)`` answers a flagship request (M=100, 100 steps) bitwise as
    the run dir's classifier, through one kernel launch; over HTTP,
    ``POST /v1/reload`` with the file answers 200 and a corrupt file 400.
    Returns the import's load times (ms)."""
    import numpy as np
    import torch
    from fumi_tpu_torch import interop
    from fumi_tpu_torch.cli import export_torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import checkpoint as ckpt_lib
    from fumi_tpu_torch.train import steps
    times = {}
    s_im, s_y, q_im, s_tx = request
    for model, kernel in (("fumi", "fused_adapt"),
                          ("maml", "fused_maml_adapt_batched")):
        run_dir, args = driver_dirs[model]
        out = os.path.join(root, f"{model}.pth.tar")
        export_torch.main([run_dir, out])
        cfg = config_from_args(args)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        params, state, _ = ckpt_lib.load_checkpoint(
            run_dir, st.params, st.opt.init(st.params))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i_params, i_state, meta = interop.load_torch_checkpoint(
            out, st.params, st.opt.init(st.params))
        torch.cuda.synchronize()
        times[f"{model} import ms"] = 1e3 * (time.perf_counter() - t0)
        same = all(torch.equal(i_params[k], params[k]) for k in params) \
            and all(torch.equal(i_state[m][k], state[m][k])
                    for m in ("mu", "nu") for k in params) \
            and i_state["count"] == state["count"]
        evaluated = {}
        for name, ckpt in (("run dir", run_dir), (".pth.tar", out)):
            reset_counts()
            evaluated[name] = cli_main.cli(args[:-1] + [
                os.path.join(root, f"{model}-eval-{name.strip('.')}"),
                "--evaluate", "--checkpoint", ckpt])
            counts = read_counts()
        add_counts(by_path, f"driver {model} --evaluate .pth.tar", counts)
        text = s_tx if model == "fumi" else None
        clf = FewShotClassifier.from_checkpoint(out, cfg, device=dev)
        reset_counts()
        got = clf.episode_logits(s_im, s_y, q_im, support_text=text)
        served = read_counts()
        add_counts(by_path, f"serve {model} from .pth.tar", served)
        want = FewShotClassifier.from_checkpoint(
            run_dir, cfg, device=dev).episode_logits(s_im, s_y, q_im,
                                                     support_text=text)
        print(f"main path, {model} .pth.tar: exported and imported in "
              f"{times[f'{model} import ms']:.1f} ms (batch "
              f"{meta['batch_idx']}), params and moments bitwise the run "
              f"dir's {same}; --evaluate from the file {evaluated['.pth.tar']}"
              f" (from the run dir {evaluated['run dir']}), launches "
              f"{counts}; served from the file bitwise as from the run dir "
              f"{np.array_equal(got, want)}, launches {served}")
        if not (same and evaluated[".pth.tar"] == evaluated["run dir"]
                and np.array_equal(got, want)):
            fail(f"{model} .pth.tar: the round trip changed the model")
        if counts != new_counts(gather_episode_rows=DRIVER_TEST_BATCHES,
                                **{kernel: DRIVER_TEST_BATCHES}) or \
                served != new_counts(fused_adapt=1):
            fail(f"{model} .pth.tar: launches {counts}, served {served}")
        if model == "fumi":
            corrupt = os.path.join(root, "corrupt.pth.tar")
            with open(corrupt, "wb") as f:
                f.write(b"not a checkpoint")
            with loopback(clf) as call:
                ok = call("/v1/reload", {"checkpoint": out})
                bad = call("/v1/reload", {"checkpoint": corrupt})
                body = {"support_im": s_im.tolist(), "support_y":
                        s_y.tolist(), "query_im": q_im.tolist(),
                        "support_text": s_tx.tolist(), "return": "logits"}
                status, answer = call("/v1/episode", body)
            print(f"main path, fumi .pth.tar over HTTP: /v1/reload "
                  f"{ok[0]}, a corrupt file {bad[0]} ({bad[1].get('error')!r});"
                  f" /v1/episode {status}, within 1e-5 of in process "
                  f"{np.allclose(answer['result'], got, atol=1e-5)}")
            if not (ok[0] == 200 and bad[0] == 400 and status == 200 and
                    np.allclose(answer["result"], got, atol=1e-5)):
                fail("serving a .pth.tar over HTTP")
    return times


def stage_remat_phase(Config, dev, card) -> dict:
    """Phase 7s: ``resnet12.STAGE_REMAT_OVERRIDE`` (per-stage
    checkpointing, an experiment switch) on MAML resnet12 at 84×84×3, one
    episode of 2 tasks with 5 queries a class as phase 7l cuts it: the
    loss and meta-gradient with the override (1, 1, 0, 0) against
    ``--tpu_remat auto`` without it (whole-step checkpointing), cuDNN
    deterministic: bitwise; the peak memory of each. Returns the peaks."""
    import torch
    from fumi_tpu_torch.models import resnet12
    from fumi_tpu_torch.train import steps
    times, out = {}, {}
    small = raw_samplers(dev, queries=(5,))[0]
    episode = small.sample(small.generator(9))
    episode = type(episode)(*(None if t is None else t[:2] for t in episode))
    torch.backends.cudnn.deterministic = True
    try:
        for name, override in (("auto", None),
                               ("stages 1100", (True, True, False, False))):
            resnet12.STAGE_REMAT_OVERRIDE = override
            cfg = raw_cfg(Config, "maml", "resnet12", remat="auto",
                          batch_size=2, num_shots_test=5)
            fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
            params = {k: v.to(dev) for k, v in fam.params.items()}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            (loss, _), grads = steps.value_and_grad(fam, params, episode,
                                                    None)
            torch.cuda.synchronize()
            times[f"{name} s"] = time.perf_counter() - t0
            times[f"peak GB {name}"] = (torch.cuda.max_memory_allocated(dev)
                                        - base) / 1e9
            out[name] = (loss, grads)
            del fam, params
    finally:
        resnet12.STAGE_REMAT_OVERRIDE = None
        torch.backends.cudnn.deterministic = False
    (l_a, g_a), (l_s, g_s) = out["auto"], out["stages 1100"]
    same = torch.equal(l_a, l_s) and all(torch.equal(g_a[k], g_s[k])
                                         for k in g_a)
    print(f"maml resnet12 STAGE_REMAT_OVERRIDE (1, 1, 0, 0) vs --tpu_remat "
          f"auto (2 tasks, 5+5 a class): loss {float(l_s):.6f} vs "
          f"{float(l_a):.6f}, loss and meta-gradient bitwise equal {same}; "
          f"peak memory {times['peak GB stages 1100']:.2f} GB vs "
          f"{times['peak GB auto']:.2f} GB; a value_and_grad "
          f"{times['stages 1100 s']:.3f} s vs {times['auto s']:.3f} s "
          f"[{card}]")
    if not same:
        fail("resnet12 stage remat changed the loss or the meta-gradient")
    del small, episode, out
    torch.cuda.empty_cache()
    return times


# runs of one step without the switch before phase 7s-b gives up waiting
# for two in a row to agree bitwise
SETTLE_RUNS = 8


def block_remat_phase(Config, dev, card, reset_counts, read_counts,
                      by_path) -> dict:
    """Phase 7s-b: ``conv4.BLOCK_REMAT`` (each conv block checkpointed, an
    experiment switch) at 84×84×3 in fp32. (a) conv4 MAML and FuMI on one
    episode of 2 tasks with 5 queries a class, cut as phase 7s cuts it,
    cuDNN deterministic, once the step repeats bitwise: the loss with the
    switch on bitwise the loss with it off, the meta-gradient bitwise for
    FuMI and for MAML under ``--tpu_remat on``, within 1e-5 of its scale
    for MAML under ``auto`` (the comment below says why), and the peak
    memory of each.
    (b) phase 7k's conv4 MAML training (B=4, 5-way 5-shot, 32 queries a
    class, 5 second-order steps, chunks of ``RAW_CHUNK``) off, on, off,
    on: the episodes/s, the peak memory, the busy share and device ms a
    step, and one ``gather_episode_rows`` a step. Returns the numbers."""
    import torch
    from fumi_tpu_torch.models import conv4
    from fumi_tpu_torch.train import steps
    times = {}
    small, train_s = raw_samplers(dev, queries=(5, TRAIN_Q))
    episode = small.sample(small.generator(9))
    episode = type(episode)(*(None if t is None else t[:2] for t in episode))

    def peak_gb(base):
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    def reset_peak():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)

    def run(model, on, remat):
        """(loss, meta-gradient, the step's peak GB) with the switch
        ``on`` under ``--tpu_remat remat``."""
        conv4.BLOCK_REMAT = on
        cfg = raw_cfg(Config, model, "conv4", batch_size=2, num_shots_test=5,
                      remat=remat)
        fam = steps.build_family(cfg, torch.Generator().manual_seed(0))
        params = {k: v.to(dev) for k, v in fam.params.items()}
        base = reset_peak()
        (loss, _), grads = steps.value_and_grad(fam, params, episode, None)
        return loss, grads, peak_gb(base)

    def rel_diff(a, b):
        """The largest gap between two meta-gradients, over the second's
        largest entry; 0.0 where every leaf is equal."""
        if all(torch.equal(a[1][k], b[1][k]) for k in a[1]):
            return 0.0
        scale = max(float(v.abs().max()) for v in b[1].values())
        return max(float((a[1][k] - b[1][k]).abs().max())
                   for k in a[1]) / scale

    try:
        # (a) the switch changes no number, on cuDNN's deterministic
        # algorithms. A second-order step's own bits depend on the
        # autograd engine's order: it runs the outer backward by the
        # nodes' sequence numbers, which the main thread (the forward) and
        # the CUDA worker thread (the inner steps' create_graph nodes, and
        # with the switch the blocks' recompute) count apart. So runs
        # without the switch repeat until two in a row are bitwise equal
        # (at most SETTLE_RUNS), and the run with it is held to the last:
        # the loss bitwise always; the meta-gradient bitwise where the
        # order stays (FuMI, and MAML nested under --tpu_remat on, whose
        # step checkpoint recomputes every inner step on the worker
        # thread in both runs), and for MAML under auto within 1e-5 of its
        # scale, as the CPU tests hold meta-gradients summed in other
        # orders.
        torch.backends.cudnn.deterministic = True
        for model, remat, tol in (("maml", "auto", 1e-5), ("maml", "on", 0.0),
                                  ("fumi", "auto", 0.0)):
            offs = [run(model, False, remat)]
            while len(offs) < SETTLE_RUNS and (
                    len(offs) < 2 or rel_diff(offs[-1], offs[-2]) != 0.0
                    or not torch.equal(offs[-1][0], offs[-2][0])):
                offs.append(run(model, False, remat))
            noise = max(rel_diff(o, offs[-1]) for o in offs)
            off, on = offs[-1], run(model, True, remat)
            gap = rel_diff(on, off)
            tag = f"{model} --tpu_remat {remat}"
            times[f"{tag} peak GB off"], times[f"{tag} peak GB on"] = (
                off[2], on[2])
            times[f"{tag} gap on/off"] = gap
            times[f"{tag} gap of the runs off"] = noise
            print(f"{tag} conv4 BLOCK_REMAT on vs off (2 tasks, 5+5 a "
                  f"class, fp32, cuDNN deterministic): loss "
                  f"{float(on[0]):.6f} vs {float(off[0]):.6f}, loss bitwise "
                  f"equal {torch.equal(on[0], off[0])}, meta-gradient "
                  f"{gap:.3e} of its scale apart (bound {tol:.0e}); off "
                  f"repeated after {len(offs)} runs, the runs up to "
                  f"{noise:.3e} apart; the step's peak memory {on[2]:.3f} "
                  f"GB vs {off[2]:.3f} GB [{card}]")
            if len(offs) > 1 and rel_diff(offs[-1], offs[-2]) != 0.0:
                fail(f"{tag} conv4: {SETTLE_RUNS} runs of the same step "
                     "never repeated bitwise")
            if not bool(torch.isfinite(on[0])):
                fail(f"{tag} conv4 BLOCK_REMAT: non-finite loss")
            if not torch.equal(on[0], off[0]) or gap > tol:
                fail(f"{tag} conv4 BLOCK_REMAT changed the loss or the "
                     f"meta-gradient ({gap:.3e} of its scale)")
            del offs, off, on
        torch.backends.cudnn.deterministic = False
        # (b) the A/B at phase 7k's configuration, in turns
        turns = {"off": [], "on": []}
        for i, name in enumerate(("off", "on", "off", "on")):
            conv4.BLOCK_REMAT = name == "on"
            cfg = raw_cfg(Config, "maml", "conv4")
            st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
            label = f"train maml conv4 BLOCK_REMAT {name} (turn {i + 1})"
            base = reset_peak()
            eps, state = timed_train(st, train_s, label, reset_counts,
                                     read_counts, by_path, chunk=RAW_CHUNK)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            busy = busy_line(label, state, card, steps_n=2)
            print(f"{label}: {eps:.2f} episodes/s, peak memory {peak:.3f} "
                  f"GB ({peak - base / 1e9:.3f} GB above the table and "
                  f"params) [{card}]")
            turns[name].append((eps, peak, busy))
            del st, state
        for name, rows in turns.items():
            times[f"A/B {name} eps"] = [r[0] for r in rows]
            times[f"A/B {name} peak GB"] = [r[1] for r in rows]
            times[f"A/B {name} device ms"] = [
                None if r[2] is None else r[2][0] for r in rows]
            times[f"A/B {name} busy"] = [
                None if r[2] is None else r[2][0] / r[2][2] for r in rows]
        eps_ratio = (statistics.median(times["A/B on eps"])
                     / statistics.median(times["A/B off eps"]))
        peak_ratio = (max(times["A/B on peak GB"])
                      / max(times["A/B off peak GB"]))
        times["A/B on/off eps"], times["A/B on/off peak"] = (eps_ratio,
                                                             peak_ratio)
        print(f"conv4 MAML B=4 BLOCK_REMAT on/off: episodes/s "
              f"{times['A/B on eps']} vs {times['A/B off eps']} "
              f"({eps_ratio:.3f}x), peak {times['A/B on peak GB']} vs "
              f"{times['A/B off peak GB']} GB ({peak_ratio:.3f}x) [{card}]")
    finally:
        conv4.BLOCK_REMAT = False
        torch.backends.cudnn.deterministic = False
    del small, train_s, episode
    torch.cuda.empty_cache()
    return times


def block_remat_alone() -> None:
    """Phase 7s-b by itself on the card, as ``python3 -c 'import
    chip_smoke; chip_smoke.block_remat_alone()'`` from a checkout: builds
    the kernels, runs the phase and prints its numbers and launches."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this phase needs a GPU")
    sys.path.insert(0, HERE)
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.ops import _build, kernels
    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build_all(SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reset_counts():
        for name in KERNEL_NAMES:
            getattr(kernels, name).launches = 0

    def read_counts():
        return {name: getattr(kernels, name).launches
                for name in KERNEL_NAMES}
    by_path = {}
    times = block_remat_phase(Config, torch.device("cuda", 0), card,
                              reset_counts, read_counts, by_path)
    print(json.dumps({"block-remat": times, "launches_by_path": by_path},
                     default=str))


# ---------------------------------------------------------------------------
# Phase 7zn: conv4's norm, ReLU and pool as one op
# ---------------------------------------------------------------------------

# conv4.train's calls: (support 25 | query 160 images, 4 tasks x 64
# channels, the four blocks' sides)
NRP_SHAPES = tuple((m, 256, side) for m in (25, 160)
                   for side in (84, 42, 21, 10))
# bytes a pass must move, in units of the activation's bytes (4 M H W G):
# the forward reads z twice and writes a quarter; the backward reads z and
# g_out twice and writes g_z; the double backward reads z, v_z and g_out
# twice and writes c_z and c_gout (csrc/norm_relu_pool.cu's note)
NRP_PASS_BYTES = {"forward": 2.25, "backward": 3.5, "double_backward": 5.75}
NRP_STEP_CHUNK = 2


def nrp_inputs(dev, M, G, side, seed, beta=True):
    """z (channels_last), b, gamma, beta (0 where ``beta`` is False: a =
    gamma*x then rounds alike in the kernels' fma and the plain version's
    product, so their ReLU masks and pool ties agree bitwise)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    z = r(M, side, side, G).permute(0, 3, 1, 2)
    return (z, r(G), 1.0 + 0.3 * r(G),
            0.2 * r(G) if beta else torch.zeros(G, device=dev))


def nrp_gap(label, got, want, tol) -> float:
    """max |got − want| over max |want|; fails above ``tol``."""
    scale = float(want.abs().max())
    gap = float((got - want).abs().max()) / max(scale, 1e-30)
    if not gap <= tol:
        fail(f"norm_relu_pool {label}: {gap:.3e} of the scale {scale:.3e}, "
             f"over {tol:.0e}")
    return gap


def nrp_hold(dev, M, G, side) -> float:
    """The three passes against the plain versions on one shape; the
    largest gap. The forward's output is continuous in its inputs, so it
    is held with a nonzero beta on each side's own statistics; the
    backward and double backward on beta = 0 and the kernel's statistics,
    where the two sides' masks and ties agree bitwise and only the sums'
    order parts them."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    gaps = []
    z, b, g, be = nrp_inputs(dev, M, G, side, 1)
    out, stats = K._nrp_forward(z, b, g, be)
    want, wstats = K.norm_relu_pool_forward_reference(z, b, g, be)
    gaps.append(nrp_gap("forward", out, want, 1e-5))
    gaps.append(nrp_gap("statistics", stats, wstats, 1e-6))
    del out, want
    be = torch.zeros_like(be)
    gen = torch.Generator(device=dev).manual_seed(2)
    g_out = torch.randn((M, side // 2, side // 2, G), generator=gen,
                        device=dev).permute(0, 3, 1, 2)
    got = K._nrp_backward(z, b, g, be, stats, g_out)
    ref = K.norm_relu_pool_backward_reference(z, b, g, be, stats, g_out)
    for name, x, y in zip(("g_z", "g_b", "g_gamma", "g_beta"), got, ref):
        if name == "g_b":
            if not (torch.equal(x, y) and not bool(x.any())):
                fail("norm_relu_pool backward: g_b is not 0")
            continue
        gaps.append(nrp_gap(f"backward {name}", x, y, 1e-5))
    v_z = torch.randn((M, side, side, G), generator=gen,
                      device=dev).permute(0, 3, 1, 2)
    v_g, v_b = torch.randn(G, generator=gen, device=dev), torch.randn(
        G, generator=gen, device=dev)
    got2 = K._nrp_double_backward(z, b, g, be, stats, g_out, got[4], v_z,
                                  v_g, v_b)
    ref2 = K.norm_relu_pool_double_backward_reference(
        z, b, g, be, stats, g_out, ref[4], v_z, v_g, v_b)
    for name, x, y in zip(("c_z", "c_b", "c_gamma", "c_beta", "c_gout"),
                          got2, ref2):
        if name in ("c_b", "c_beta"):
            if bool(x.any()):
                fail(f"norm_relu_pool double backward: {name} is not 0")
            continue
        gaps.append(nrp_gap(f"double backward {name}", x, y, 1e-5))
    return max(gaps)


def nrp_times(dev, M, G, side) -> dict:
    """Each pass alone (five calls in a CUDA graph, so the host's dispatch
    stays out: :func:`graph_ms`) and the plain version's (CUDA events,
    median of 3 after 1), ms, beside the bytes bound."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    z, b, g, be = nrp_inputs(dev, M, G, side, 3)
    gen = torch.Generator(device=dev).manual_seed(4)
    out, stats = K._nrp_forward(z, b, g, be)
    g_out = torch.randn_like(out)
    bw = K._nrp_backward(z, b, g, be, stats, g_out)
    v_z = torch.randn((M, side, side, G), generator=gen,
                      device=dev).permute(0, 3, 1, 2)
    v_g, v_b = torch.ones(G, device=dev), torch.ones(G, device=dev)
    passes = {
        "forward": (lambda: K._nrp_forward(z, b, g, be),
                    lambda: K.norm_relu_pool_forward_reference(z, b, g, be)),
        "backward": (lambda: K._nrp_backward(z, b, g, be, stats, g_out),
                     lambda: K.norm_relu_pool_backward_reference(
                         z, b, g, be, stats, g_out)),
        "double_backward": (
            lambda: K._nrp_double_backward(z, b, g, be, stats, g_out, bw[4],
                                           v_z, v_g, v_b),
            lambda: K.norm_relu_pool_double_backward_reference(
                z, b, g, be, stats, g_out, bw[4], v_z, v_g, v_b))}
    elems = M * side * side * G
    row = {}
    for name, (kernel, plain) in passes.items():
        row[f"{name}_ms"] = graph_ms([kernel] * 5)
        row[f"{name}_plain_ms"] = cuda_ms(plain, 1, 3)
        row[f"{name}_bound_ms"] = (1e3 * NRP_PASS_BYTES[name] * 4 * elems
                                   / PEAK_BYTES_PER_S)
    return row


def nrp_step(Config, dev, card, fused: bool) -> dict:
    """A chunk of conv4 MAML train steps at conv4.train's episode (B=4,
    5-way 5-shot, 32 queries, 5 second-order steps), through the op or, with
    ``fused`` False, through the written-out chain: device ms and
    operations a step (torch.profiler), peak memory, the op's launches a
    step."""
    import torch
    from fumi_tpu_torch.models import conv4
    from fumi_tpu_torch.ops import kernels as K
    from fumi_tpu_torch.train import steps
    applies = conv4.fused_norm_applies
    if not fused:
        conv4.fused_norm_applies = lambda z, low: False
    try:
        smp = raw_samplers(dev, queries=(TRAIN_Q,))[0]
        st = steps.make_steps(raw_cfg(Config, "maml", "conv4"),
                              torch.Generator().manual_seed(0), device=dev)
        run = steps.make_chunked_train(st.family, st.opt, smp, NRP_STEP_CHUNK)
        p, s, gen, _ = run(st.params, st.opt.init(st.params),
                           smp.generator(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.norm_relu_pool.launches = 0
        box = {}
        seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
        launches = K.norm_relu_pool.launches / NRP_STEP_CHUNK
        peak = torch.cuda.max_memory_allocated() / 1e9
        traced = device_profile(lambda: run(p, s, gen))
        loss = box["out"][3]["loss"]
        if not bool(torch.isfinite(loss).all()):
            fail(f"norm_relu_pool step (fused={fused}): non-finite loss")
    finally:
        conv4.fused_norm_applies = applies
    row = {"launches_a_step": launches, "wall_ms_a_step":
           1e3 * seconds / NRP_STEP_CHUNK, "peak_gb": peak,
           "loss": float(loss[0])}
    if traced is not None:
        row["device_ms_a_step"] = traced[0] / NRP_STEP_CHUNK
        row["device_ops_a_step"] = traced[1] / NRP_STEP_CHUNK
    print(f"norm_relu_pool step, {'the op' if fused else 'written out'}: "
          f"{row} [{card}]", flush=True)
    return row


def norm_relu_pool_phase(Config, dev, card) -> dict:
    """Phase 7zn (the module's docstring). Fails where a pass leaves the
    plain version by more than 1e-5 of its scale, or a step through the op
    launches other than 4 blocks x (6 forwards, 11 backwards, 5 double
    backwards)."""
    import torch
    from fumi_tpu_torch.ops import _build
    _build.build_all(["norm_relu_pool"])
    for line in _build.build_logs.get("norm_relu_pool", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas norm_relu_pool: {line.strip()}")
    shapes, worst = {}, 0.0
    for M, G, side in NRP_SHAPES:
        key = f"M{M}_G{G}_{side}x{side}"
        worst = max(worst, nrp_hold(dev, M, G, side))
        shapes[key] = nrp_times(dev, M, G, side)
        print(f"norm_relu_pool {key}: {shapes[key]} [{card}]", flush=True)
        torch.cuda.empty_cache()
    steps_ = {"op": nrp_step(Config, dev, card, True),
              "written_out": nrp_step(Config, dev, card, False)}
    want = 4 * (6 + 11 + 5)
    if steps_["op"]["launches_a_step"] != want or \
            steps_["written_out"]["launches_a_step"] != 0:
        fail(f"norm_relu_pool: launches a step {steps_}, expected {want} "
             "through the op and 0 written out")
    print(f"norm_relu_pool: the three passes within {worst:.2e} of the "
          f"plain versions at {len(NRP_SHAPES)} shapes [{card}]", flush=True)
    return {"max_abs_err": worst, "shapes": shapes, "step": steps_,
            "launches": steps_["op"]["launches_a_step"]}


def norm_relu_pool_alone() -> None:
    """Phase 7zn by itself on the card, as ``python3 -c 'import
    chip_smoke; chip_smoke.norm_relu_pool_alone()'`` from a checkout."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this phase needs a GPU")
    sys.path.insert(0, HERE)
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.ops import _build
    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build_all(SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"norm_relu_pool": norm_relu_pool_phase(
        Config, torch.device("cuda", 0), card)}, default=str))


PR11_PHASES = ("ema", "debug-nans", "host-sampler", "pth", "stage-remat",
               "block-remat")


def pr11_phases(names, Config, dev, root, card, ctx, reset_counts,
                read_counts, by_path) -> dict:
    """Phases 7o-7s-b, the ``names`` of :data:`PR11_PHASES` in order, each
    in its own directory under ``root``. ``ctx`` holds what they take from
    the earlier phases: ``samplers`` (phase 5's train and phase 6's eval
    sampler), ``request`` (phase 4's), ``table`` (the flagship table as
    numpy, its ``ids`` and ``cset``) and ``driver_dirs`` (phase 7's run
    dirs). The phases' times by name."""
    times = {}
    for name in names:
        t0 = time.perf_counter()
        where = os.path.join(root, f"phase-{name}")
        os.makedirs(where)
        if name == "ema":
            times[name] = ema_phase(Config, dev, card, where,
                                    ctx["samplers"], ctx["request"],
                                    reset_counts, read_counts, by_path)
        elif name == "debug-nans":
            times[name] = debug_nans_phase(Config, dev, card,
                                           ctx["samplers"][0], reset_counts,
                                           read_counts, by_path)
        elif name == "host-sampler":
            times[name] = host_sampler_phase(
                Config, dev, card, where, ctx["table"], ctx["ids"],
                ctx["cset"], ctx["samplers"][0], reset_counts, read_counts,
                by_path)
        elif name == "pth":
            times[name] = pth_phase(Config, dev, card, where,
                                    ctx["driver_dirs"], ctx["request"],
                                    reset_counts, read_counts, by_path)
        elif name == "stage-remat":
            times[name] = stage_remat_phase(Config, dev, card)
        elif name == "block-remat":
            times[name] = block_remat_phase(Config, dev, card, reset_counts,
                                            read_counts, by_path)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return times


# ---------------------------------------------------------------------------
# Phases 7t-7y: the seed sweep, its driver, the seed ensemble, grad-accum,
# --tpu_watch and --tpu_profile_dir
# ---------------------------------------------------------------------------

# S=4 seeds (the JAX package's flagship sweep), chunks of 10 lockstep
# steps; grad-accum at B=16 in 4 micro-batches, chunks of 5 steps; the
# watched chunk is 16 steps (two sampled blocks of WATCH_STRIDE 8); the
# traced driver run trains 5 steps
SWEEP_S, SWEEP_CHUNK, FROZEN_STEPS = 4, 10, 2
ACCUM_B, ACCUM, ACCUM_CHUNK = 16, 4, 5
WATCH_CHUNK, TRACE_EPOCHS = 16, 4


def trees_equal(a, b) -> bool:
    """Nested state dicts bitwise equal (tensors) or equal (ints)."""
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def sweep_phase(Config, dev, card, samplers, reset_counts, read_counts,
                by_path) -> dict:
    """Phase 7t: FuMI and MAML sweeps of S=4 seeds at the flagship width
    on phase 5's sampler (kernel gather): a timed chunk of 10 lockstep
    steps (S ``gather_episode_rows`` a step), each seed's params and
    optimizer state bitwise those of a standalone chunk of that seed (its
    init, its generator) on the same card, timed too; MAML with
    ``--tpu_seed_accum 2`` bitwise the same; a frozen seed holding its
    state while its generator advances; the busy share of a sweep step;
    and the sweep's eval through the fused kernel (one launch a seed a
    meta-batch), seed 0's within 1e-6 of its standalone eval. Returns the
    times."""
    import torch
    from fumi_tpu_torch.train import steps, sweep
    from fumi_tpu_torch.train.loop import TRAIN, VAL, stream_generator
    train_smp, eval_smp = samplers
    times = {}
    for model in ("fumi", "maml"):
        cfg = train_cfg(Config, model, seed_sweep=SWEEP_S,
                        pallas_fused_eval=True)
        seeds = sweep.sweep_seeds(cfg)
        family = sweep.build_sweep_family(cfg, device=dev)
        opt = steps.make_opt(cfg)
        init = [sweep.unstack_tree(family.params, i) for i in range(SWEEP_S)]
        states = [opt.init(p) for p in init]

        def gens():
            return [stream_generator(s, TRAIN, 0, dev) for s in seeds]

        def chunk(accum_seeds=1, live=(True,) * SWEEP_S, n=SWEEP_CHUNK):
            run = sweep.make_sweep_chunked_train(family, opt, train_smp,
                                                 SWEEP_CHUNK,
                                                 seed_accum=accum_seeds)
            return run(init, states, gens(), list(live), n)
        chunk(n=1)  # warm
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(out=chunk()))
        counts = read_counts()
        add_counts(by_path, f"sweep train {model} S={SWEEP_S}", counts)
        p, s, g, ms = box["out"]
        eps = SWEEP_CHUNK * B * SWEEP_S / seconds
        if counts != new_counts(gather_episode_rows=SWEEP_S * SWEEP_CHUNK) \
                or not bool(torch.isfinite(ms["loss"]).all()):
            fail(f"sweep train {model}: launches {counts} or non-finite "
                 "losses")
        solo_s, same = [], []
        for i, seed in enumerate(seeds):
            st = steps.make_steps(cfg.replace(seed=seed, seed_sweep=0),
                                  torch.Generator().manual_seed(seed),
                                  device=dev)
            run = steps.make_chunked_train(st.family, st.opt, train_smp,
                                           SWEEP_CHUNK)
            sbox = {}
            solo_s.append(synced_s(lambda: sbox.update(out=run(
                st.params, st.opt.init(st.params),
                stream_generator(seed, TRAIN, 0, dev)))))
            sp, ss, _, sm = sbox["out"]
            same.append(trees_equal(p[i], sp) and trees_equal(s[i], ss)
                        and torch.equal(ms["loss"][:, i], sm["loss"]))
        solo_eps = SWEEP_CHUNK * B / solo_s[0]
        times[f"sweep {model} eps"] = eps
        times[f"standalone {model} eps"] = solo_eps
        print(f"main path, sweep train {model} S={SWEEP_S}: {SWEEP_CHUNK} "
              f"lockstep steps in {seconds:.3f} s = {eps:.1f} episodes/s "
              f"(all seeds); one standalone run {solo_eps:.1f} episodes/s "
              f"({solo_s[0]:.3f} s for the same steps of seed 0); each "
              f"seed bitwise its standalone chunk: {same}; launches "
              f"{counts} [{card}]")
        if not all(same):
            fail(f"sweep train {model}: a replica differs from its "
                 "standalone chunk")

        if model == "maml":
            reset_counts()
            grouped = chunk(accum_seeds=2)
            counts = read_counts()
            add_counts(by_path, f"sweep train maml --tpu_seed_accum 2",
                       counts)
            equal = all(trees_equal(grouped[0][i], p[i])
                        and trees_equal(grouped[1][i], s[i])
                        for i in range(SWEEP_S))
            print(f"main path, sweep train maml --tpu_seed_accum 2: bitwise "
                  f"the ungrouped sweep {equal}; launches {counts}")
            if not equal or counts != new_counts(
                    gather_episode_rows=SWEEP_S * SWEEP_CHUNK):
                fail("--tpu_seed_accum 2 changed the sweep")

        live = [True, False] + [True] * (SWEEP_S - 2)
        fp, fs, fg, _ = chunk(live=live, n=FROZEN_STEPS)
        held = trees_equal(fp[1], init[1]) and trees_equal(fs[1], states[1])
        ref = chunk(n=FROZEN_STEPS)
        advanced = torch.equal(fg[1].get_state(), ref[2][1].get_state())
        print(f"sweep train {model}: a frozen seed held its params and "
              f"optimizer state {held}, its generator advanced as a live "
              f"seed's {advanced}")
        if not (held and advanced):
            fail(f"sweep train {model}: the frozen seed did not hold")

        wall_ms = 1e3 * seconds / SWEEP_CHUNK
        traced = device_profile(lambda: chunk(n=2))
        if traced is None:
            print(f"sweep {model}: device busy share not measured (the "
                  f"profiler recorded no device time) [{card}]")
        else:
            dev_ms = traced[0] / 2
            times[f"sweep {model} busy"] = dev_ms / wall_ms
            print(f"sweep {model} S={SWEEP_S}: device time {dev_ms:.3f} ms "
                  f"a lockstep step in {traced[1] / 2:.0f} device "
                  f"operations against {wall_ms:.3f} ms of wall time: busy "
                  f"{100 * dev_ms / wall_ms:.1f}% [{card}]")

        kernel = "fused_adapt" if model == "fumi" else \
            "fused_maml_adapt_batched"
        views = [sweep.unstack_tree(family.params, i)
                 for i in range(SWEEP_S)]
        reset_counts()
        ev = sweep.make_sweep_chunked_eval(family, eval_smp)(
            views, [stream_generator(s, VAL, 1, dev) for s in seeds],
            EVAL_BATCHES)
        counts = read_counts()
        add_counts(by_path, f"sweep eval {model} S={SWEEP_S}", counts)
        solo = steps.make_chunked_eval(family, eval_smp)(
            views[0], stream_generator(seeds[0], VAL, 1, dev),
            EVAL_BATCHES)[1]
        diff = float((ev["loss"][0] - solo["loss"]).abs().max())
        print(f"main path, sweep eval {model}: {EVAL_BATCHES} meta-batches "
              f"a seed, loss {ev['loss'].mean(dim=1).tolist()}; seed 0 vs "
              f"its standalone eval max|diff| {diff:.3e} (tolerance 1e-6); "
              f"launches {counts}")
        want = new_counts(gather_episode_rows=SWEEP_S * EVAL_BATCHES,
                          **{kernel: SWEEP_S * EVAL_BATCHES})
        if counts != want or not diff <= 1e-6:
            fail(f"sweep eval {model}: launches {counts}, expected {want}, "
                 "or seed 0 differs from its standalone eval")
    return times


def sweep_driver_phase(dev, root, card, reset_counts, read_counts,
                       by_path) -> dict:
    """Phase 7u: ``cli.main --tpu_seed_sweep 4`` for FuMI at the flagship
    width on ``--dataset synthetic --augment --tpu_pallas_gather
    --tpu_pallas_fused_eval`` (phase 7's epochs): the report's keys, four
    CSVs, the ``seed<k>/`` run dirs (``--evaluate --checkpoint seed0``
    reproduces seed 0's test numbers; every seed's dir, tested on the
    sweep's data with its own test stream, reproduces its own), and
    ``--tpu_auto_resume`` of a sweep interrupted after batch 11 equal to
    the uninterrupted one. Returns the times and the run dir with its
    arguments."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.train import checkpoint, loop, steps

    def args_for(log_dir, epochs=DRIVER_EPOCHS, *extra):
        return ["--model", "fumi", "--dataset", "synthetic", "--augment",
                "--tpu_pallas_gather", "--tpu_pallas_fused_eval", "--epochs",
                str(epochs), "--eval_freq", str(DRIVER_EVAL_FREQ),
                "--num_ep_test", str(DRIVER_EP_TEST), "--seed", "0",
                "--wandb_offline", "--log_dir", log_dir, *extra]
    sweep_flags = ("--tpu_seed_sweep", str(SWEEP_S))
    times = {}
    log_dir = os.path.join(root, "sweep")
    args = args_for(log_dir, DRIVER_EPOCHS, *sweep_flags)
    reset_counts()
    t0 = time.perf_counter()
    out = cli_main.cli(args)
    times["driver sweep s"] = time.perf_counter() - t0
    counts = read_counts()
    add_counts(by_path, f"driver fumi --tpu_seed_sweep {SWEEP_S}", counts)
    want = new_counts(gather_episode_rows=SWEEP_S * (DRIVER_TRAIN_STEPS
                                                     + DRIVER_EVAL_BATCHES),
                      fused_adapt=SWEEP_S * DRIVER_EVAL_BATCHES)
    (run,) = glob.glob(os.path.join(log_dir, "runs", "*"))
    csvs = sorted(glob.glob(os.path.join(log_dir, "results", "*.csv")))
    rows = [len(open(c).read().splitlines()) - 1 for c in csvs]
    keys = all(f"test/{k}" in out and f"test/{k}_seed_ci95" in out
               and all(f"test/seed{s}/{k}" in out for s in range(SWEEP_S))
               for k in ("loss", "acc"))
    print(f"main path, driver fumi --tpu_seed_sweep {SWEEP_S}: SWEEP TEST "
          f"{ {k: v for k, v in out.items() if '/' not in k[5:]} } in "
          f"{times['driver sweep s']:.3f} s; CSVs "
          f"{[os.path.basename(c) for c in csvs]} with {rows} rows; "
          f"launches {counts} [{card}]")
    if counts != want or not keys or rows != [DRIVER_TEST_BATCHES * B] * \
            SWEEP_S or not all(np.isfinite(v) for v in out.values()):
        fail(f"driver sweep: launches {counts} (expected {want}), the "
             "report's keys or the CSVs")

    again = cli_main.cli(args_for(
        log_dir + "_evaluate", DRIVER_EPOCHS, "--evaluate", "--checkpoint",
        os.path.join(run, "seed0")))
    diff0 = max(abs(again[k] - out[f"test/seed0/{k[5:]}"]) for k in again)
    cfg = config_from_args(args)
    splits, table, ids, _ = cli_main._load_data(cfg)
    test_s = cli_main._samplers(cfg, splits, table, ids, dev)[2]
    diffs = []
    for s in range(SWEEP_S):
        solo = cfg.replace(seed=s, seed_sweep=0)
        st = steps.make_steps(solo, torch.Generator(), device=dev)
        p, state, _ = checkpoint.load_checkpoint(
            os.path.join(run, f"seed{s}"), st.params, st.opt.init(st.params))
        got = loop.test_loop(solo, st, loop.eval_view(solo, p, state),
                             test_s, solo.max_test_batches,
                             loop.stream_generator(s, loop.TEST, 0, dev))
        diffs.append(max(abs(got[k] - out[f"test/seed{s}/{k}"])
                         for k in ("loss", "acc")))
    print(f"driver sweep: --evaluate --checkpoint <run>/seed0 vs seed 0's "
          f"test max|diff| {diff0:.3e}; each seed<k>/ tested on the sweep's "
          f"data vs its test numbers {['%.3e' % d for d in diffs]} "
          "(tolerance 1e-6)")
    if not (diff0 <= 1e-6 and max(diffs) <= 1e-6):
        fail("driver sweep: the seed<k>/ run dirs do not reproduce the "
             "seeds' test numbers")

    crash_dir = os.path.join(root, "sweep-crash")
    cli_main.cli(args_for(crash_dir, DRIVER_EVAL_FREQ + 1, *sweep_flags))
    t0 = time.perf_counter()
    resumed = cli_main.cli(args_for(crash_dir, DRIVER_EPOCHS, *sweep_flags,
                                    "--tpu_auto_resume"))
    times["driver sweep resumed s"] = time.perf_counter() - t0
    diff = max(abs(resumed[k] - out[k]) for k in out)
    print(f"driver sweep: interrupted after batch {DRIVER_EVAL_FREQ + 1}, "
          f"resumed with --tpu_auto_resume: max|diff| to the uninterrupted "
          f"report {diff:.3e} (tolerance 1e-6), keys equal "
          f"{set(resumed) == set(out)}")
    if set(resumed) != set(out) or not diff <= 1e-6:
        fail("driver sweep: the resumed sweep differs from the "
             "uninterrupted one")
    times["run"] = (run, args)
    return times


def ensemble_phase(dev, card, sweep_run, request, batch, reset_counts,
                   read_counts, by_path) -> dict:
    """Phase 7v: phase 7u's sweep run dir served as a ``SeedEnsemble``
    (``serve_http.build_classifier`` detects it): a FuMI request (M=100)
    and a batch of R=4 each through S ``fused_adapt`` launches (one a
    replica for the whole batch), against the autograd engine
    (``force_engine``): within 1e-3, the argmax differing only on ties
    that the fp64 loop decides for the kernel; the same request over HTTP
    (loopback) within 1e-5 of in process, ``/v1/reload`` answering 200;
    the request's latency at S=4 beside one replica's."""
    import contextlib as ctx
    import numpy as np
    from fumi_tpu_torch import serve_http
    from fumi_tpu_torch.core.config import config_from_args
    from fumi_tpu_torch.serve import (FewShotClassifier, SeedEnsemble,
                                      replica_seed)
    run, args = sweep_run
    cfg = config_from_args(args)
    printed = io.StringIO()
    with ctx.redirect_stdout(printed):
        ens = serve_http.build_classifier(cfg, run)
    print(printed.getvalue(), end="")
    detected = f"seed ensemble: {SWEEP_S} replicas from {run}/seed*/" in \
        printed.getvalue()
    s_im, s_y, q_im, s_tx = request
    b_im, b_y, b_q, b_tx = batch
    reset_counts()
    one = ens.episode_logits(s_im, s_y, q_im, support_text=s_tx)
    counts_one = read_counts()
    add_counts(by_path, f"serve seed ensemble fumi S={SWEEP_S} R=1",
               counts_one)
    reset_counts()
    many = ens.episode_logits_batch(b_im, b_y, b_q, support_text=b_tx)
    counts_many = read_counts()
    add_counts(by_path, f"serve seed ensemble fumi S={SWEEP_S} R={B}",
               counts_many)
    engine = SeedEnsemble(cfg, ens.params, device=dev)
    engine._episode_fn = engine._base._build_episode_fn(force_engine=True)
    eng = np.concatenate([engine.episode_logits(
        s_im, s_y, q_im, support_text=s_tx)[None], engine.episode_logits_batch(
        b_im, b_y, b_q, support_text=b_tx)])
    got = np.concatenate([one[None], many])
    probs = 0.0
    for i in range(SWEEP_S):
        solo = FewShotClassifier(cfg.replace(seed_sweep=0),
                                 {k: v[i] for k, v in ens.params.items()},
                                 device=dev)
        exact = np.concatenate([
            served_exact("fumi", solo, s_im[None], s_y[None], q_im[None],
                         s_tx[None]),
            served_exact("fumi", solo, b_im, b_y, b_q, b_tx)])
        e = np.exp(exact - exact.max(-1, keepdims=True))
        probs = probs + e / e.sum(-1, keepdims=True) / SWEEP_S
    exact = np.log(probs + 1e-9)
    diff = float(np.abs(got - eng).max())
    ties, same = served_argmax(got, eng, exact)
    print(f"main path, serve the sweep run dir as a seed ensemble "
          f"(detected {detected}): kernel vs engine max|diff| {diff:.3e} "
          f"(tolerance 1e-3), argmax differs on {ties} rows, each a tie the "
          f"fp64 loop decides for the kernel {same}; launches R=1 "
          f"{counts_one}, R={B} {counts_many}")
    if not (detected and diff <= 1e-3 and same
            and counts_one == new_counts(fused_adapt=SWEEP_S)
            and counts_many == new_counts(fused_adapt=SWEEP_S)):
        fail("serving the seed ensemble: detection, launches, or the kernel "
             "and the engine disagree")
    assert replica_seed(0, 0) != replica_seed(0, 1)

    body = {"support_im": s_im.tolist(), "support_y": s_y.tolist(),
            "query_im": q_im.tolist(), "support_text": s_tx.tolist(),
            "return": "logits"}
    with loopback(ens) as call:
        status, answer = call("/v1/episode", body)
        http_diff = float(np.abs(np.asarray(answer["result"]) - one).max())
        reload = call("/v1/reload", {"checkpoint": run})[0]
        again = call("/v1/episode", body)
        t_http = host_ms(lambda: call("/v1/episode", body))
    print(f"serve seed ensemble over HTTP: {status}, max|diff| to in "
          f"process {http_diff:.3e} (tolerance 1e-5); /v1/reload {reload}, "
          f"then {again[0]}")
    if not (status == 200 and http_diff <= 1e-5 and reload == 200
            and again[0] == 200):
        fail("serving the seed ensemble over HTTP")
    solo = FewShotClassifier.from_checkpoint(os.path.join(run, "seed0"),
                                             cfg.replace(seed_sweep=0),
                                             device=dev)
    times = {
        "ensemble R=1 ms": host_ms(lambda: ens.episode_logits(
            s_im, s_y, q_im, support_text=s_tx)),
        "one replica R=1 ms": host_ms(lambda: solo.episode_logits(
            s_im, s_y, q_im, support_text=s_tx)),
        f"ensemble R={B} ms": host_ms(lambda: ens.episode_logits_batch(
            b_im, b_y, b_q, support_text=b_tx)),
        f"one replica R={B} ms": host_ms(lambda: solo.episode_logits_batch(
            b_im, b_y, b_q, support_text=b_tx)),
        "ensemble R=1 over HTTP ms": t_http}
    print("serve seed ensemble latency: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()) + f" [{card}]")
    return times


def grad_accum_phase(Config, dev, card, table, ids, cset, reset_counts,
                     read_counts, by_path) -> dict:
    """Phase 7w: FuMI at B=16 (flagship width, dropout 0) with
    ``--tpu_grad_accum 4`` against the whole batch on the same episode:
    the loss within 1e-5 of itself and the meta-gradient within 1e-5 of
    its largest entry; then a chunk of 5 steps each way from the same
    state and generator (one ``gather_episode_rows`` a step either way:
    the 16 tasks gathered once, then split), with the peak memory and
    episodes/s of each."""
    import torch
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    from fumi_tpu_torch.train import steps
    cfg = train_cfg(Config, "fumi").replace(batch_size=ACCUM_B, dropout=0.0)
    smp = DeviceEpisodeSampler(table, ids, cset,
                               EpisodeSpec(ACCUM_B, WAYS, SHOTS, TRAIN_Q,
                                           D, E),
                               use_pallas_gather=True, device=dev)
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    episode = smp.sample(smp.generator(5))
    (l1, _), g1 = steps.value_and_grad(st.family, st.params, episode, None)
    (l4, _), g4 = steps.accum_value_and_grad(st.family, ACCUM)(
        st.params, episode, None)
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    scale = max(float(g.abs().max()) for g in g1.values())
    grad_rel = max(float((g4[k] - g1[k]).abs().max()) for k in g1) / scale
    print(f"grad-accum fumi B={ACCUM_B}: accum {ACCUM} vs the whole batch on "
          f"the same episode: loss rel diff {loss_rel:.3e}, meta-gradient "
          f"max|diff| / max|g| {grad_rel:.3e} (tolerance 1e-5)")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-5):
        fail("grad-accum: the accumulated meta-gradient differs from the "
             "whole batch's")
    times = {}
    for accum in (1, ACCUM):
        run = steps.make_chunked_train(st.family, st.opt, smp, ACCUM_CHUNK,
                                       accum=accum)
        run(st.params, st.opt.init(st.params), smp.generator(1), 1)  # warm
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(out=run(
            st.params, st.opt.init(st.params), smp.generator(1))))
        counts = read_counts()
        add_counts(by_path, f"train fumi B={ACCUM_B} --tpu_grad_accum "
                            f"{accum}", counts)
        peak = torch.cuda.max_memory_allocated(dev) - base
        eps = ACCUM_CHUNK * ACCUM_B / seconds
        times[f"accum {accum}"] = {"eps": eps, "peak_mib": peak / 2 ** 20}
        print(f"main path, train fumi B={ACCUM_B} --tpu_grad_accum {accum}: "
              f"{eps:.1f} episodes/s, peak memory above the resting state "
              f"{peak / 2 ** 20:.1f} MiB; launches {counts} [{card}]")
        if counts != new_counts(gather_episode_rows=ACCUM_CHUNK) or \
                not bool(torch.isfinite(box["out"][3]["loss"]).all()):
            fail(f"grad-accum {accum}: launches {counts} or non-finite "
                 "losses")
    return times


def watch_phase(Config, dev, card, train_smp, reset_counts, read_counts,
                by_path) -> dict:
    """Phase 7x: a FuMI chunk of 16 steps with ``--tpu_watch`` against the
    same chunk without it, from the same state and generator (in turns:
    without, with, with, without): params bitwise equal, the bucket counts
    of the two sampled steps summing to 2 × the parameter count, and the
    episodes/s of each."""
    import torch
    from fumi_tpu_torch.train import steps, watch
    cfg = train_cfg(Config, "fumi")
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), device=dev)
    n_params = sum(v.numel() for v in st.params.values())
    runs = {w: steps.make_chunked_train(st.family, st.opt, train_smp,
                                        WATCH_CHUNK, watch=w)
            for w in (False, True)}
    eps, outs = {False: [], True: []}, {}
    for w in (False, True, True, False):
        box = {}
        reset_counts()
        seconds = synced_s(lambda: box.update(out=runs[w](
            st.params, st.opt.init(st.params), train_smp.generator(1))))
        counts = read_counts()
        if w:
            add_counts(by_path, "train fumi --tpu_watch", counts)
        if counts != new_counts(gather_episode_rows=WATCH_CHUNK):
            fail(f"train fumi --tpu_watch {w}: launches {counts}")
        eps[w].append(WATCH_CHUNK * B / seconds)
        outs[w] = box["out"]
    same = trees_equal(outs[True][0], outs[False][0])
    _, counts, sampled = watch.split_watch_counts(outs[True][3])
    total = sum(int(v.sum()) for v in counts.values())
    want = WATCH_CHUNK // watch.WATCH_STRIDE
    print(f"main path, train fumi --tpu_watch: params bitwise the unwatched "
          f"chunk's {same}; {sampled} sampled steps, counts sum {total} = "
          f"{want} x {n_params} params {total == want * n_params}; "
          f"{', '.join(f'{e:.1f}' for e in eps[True])} episodes/s, "
          f"unwatched {', '.join(f'{e:.1f}' for e in eps[False])} (in "
          f"turns) [{card}]")
    if not (same and sampled == want and total == want * n_params):
        fail("--tpu_watch changed the chunk or miscounted")
    return {"watch eps": eps[True], "unwatched eps": eps[False]}


def trace_phase(dev, root, card, reset_counts, read_counts,
                by_path) -> dict:
    """Phase 7y: a short FuMI driver run (``--epochs 4 --eval_freq 2``)
    with ``--tpu_profile_dir``: the trace file's events name the
    ``gather_episode_rows`` and ``fused_adapt`` ranges; the device time of
    the kernels on the trace, by name."""
    import glob
    import numpy as np
    from fumi_tpu_torch.cli import main as cli_main
    trace_dir = os.path.join(root, "trace")
    args = ["--model", "fumi", "--dataset", "synthetic",
            "--tpu_pallas_gather", "--tpu_pallas_fused_eval", "--epochs",
            str(TRACE_EPOCHS), "--eval_freq", "2", "--num_ep_test",
            str(DRIVER_EP_TEST), "--seed", "0", "--wandb_offline",
            "--tpu_profile_dir", trace_dir, "--log_dir",
            os.path.join(root, "trace-run")]
    reset_counts()
    t0 = time.perf_counter()
    out = cli_main.cli(args)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    add_counts(by_path, "driver fumi --tpu_profile_dir", counts)
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        fail(f"--tpu_profile_dir wrote {paths}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    kernels_by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            t = kernels_by_name.setdefault(e["name"][:60], [0.0, 0])
            t[0] += e.get("dur", 0.0)
            t[1] += 1
    top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1][0])[:8]
    named = {"gather_episode_rows", "fused_adapt"} <= ranges
    print(f"main path, driver fumi --tpu_profile_dir: TEST {out} in "
          f"{seconds:.3f} s; trace {os.path.basename(paths[0])} "
          f"({os.path.getsize(paths[0]) / 2 ** 20:.1f} MiB, {len(events)} "
          f"events) names gather_episode_rows and fused_adapt {named}; "
          f"launches {counts}")
    print("trace: device time by kernel (us, launches): " + (", ".join(
        f"{k} {v[0]:.1f} ({v[1]})" for k, v in top) if top else
        "not measured (the trace holds no kernel events)") + f" [{card}]")
    if not named or not np.isfinite(out["test/loss"]):
        fail("the --tpu_profile_dir trace does not name the kernels")
    return {"kernels": {k: v for k, v in top}}


PR12_PHASES = ("sweep", "sweep-driver", "ensemble", "grad-accum", "watch",
               "trace")


def pr12_phases(names, Config, dev, root, card, ctx, reset_counts,
                read_counts, by_path) -> dict:
    """Phases 7t-7y, the ``names`` of :data:`PR12_PHASES` in order, each in
    its own directory under ``root``. ``ctx`` holds ``samplers`` (phase
    5's train and phase 6's eval sampler), ``request`` and ``batch``
    (phase 4's), and the flagship ``table`` on the card with its ``ids``
    and ``cset``; ``ensemble`` serves the run dir ``sweep-driver`` wrote.
    The phases' times by name."""
    times, sweep_run = {}, None
    for name in names:
        t0 = time.perf_counter()
        where = os.path.join(root, f"phase-{name}")
        os.makedirs(where)
        if name == "sweep":
            times[name] = sweep_phase(Config, dev, card, ctx["samplers"],
                                      reset_counts, read_counts, by_path)
        elif name == "sweep-driver":
            times[name] = sweep_driver_phase(dev, where, card, reset_counts,
                                             read_counts, by_path)
            sweep_run = times[name].pop("run")
        elif name == "ensemble":
            times[name] = ensemble_phase(dev, card, sweep_run,
                                         ctx["request"], ctx["batch"],
                                         reset_counts, read_counts, by_path)
        elif name == "grad-accum":
            times[name] = grad_accum_phase(Config, dev, card, ctx["table"],
                                           ctx["ids"], ctx["cset"],
                                           reset_counts, read_counts,
                                           by_path)
        elif name == "watch":
            times[name] = watch_phase(Config, dev, card, ctx["samplers"][0],
                                      reset_counts, read_counts, by_path)
        elif name == "trace":
            times[name] = trace_phase(dev, where, card, reset_counts,
                                      read_counts, by_path)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return times


# ---------------------------------------------------------------------------
# Phase 7z: the multi-device engines on one card
# ---------------------------------------------------------------------------

# two ranks share the card over gloo (NCCL refuses two ranks on one
# device); chunks of 10 dp steps, timed twice in each world; the CLIP
# epoch and the S=4 sweep at phase 7u's seeds, 4 epochs, a validation every
# 2; a rank's collective timed over 20 all-reduces of the gradient's size
MD_CHUNK, MD_COLLECTIVES = 10, 20
MD_SWEEP_EPOCHS, MD_SWEEP_EVAL_FREQ, MD_SWEEP_EP_TEST = 4, 2, 8
MD_CLIP_SGD_LR = 1e-2
MD_TOL = dict(rtol=2e-4, atol=1e-5)  # tests/test_parallel.py:84-86
# the ranks run on the card (False rehearses the phase on CPU ranks)
MD_USE_CUDA = True
# the sizes the parent runs at, handed to the ranks with their work
MD_SIZES = ("B", "WAYS", "SHOTS", "TRAIN_Q", "EVAL_Q", "D", "E", "TH", "H1",
            "H2", "STEPS", "STEP_SIZE", "QN", "INNER_STEPS", "EVAL_BATCHES",
            "SWEEP_S", "CLIP_BATCH", "MD_CHUNK", "MD_SWEEP_EPOCHS",
            "MD_SWEEP_EVAL_FREQ", "MD_SWEEP_EP_TEST", "MD_USE_CUDA", "MS_R",
            "MS_REPS")
MD_PATHS = ("dp2 train fumi", "dp2 eval fumi (steps)", "dp2 eval fumi",
            "dp2 eval maml (steps)", "dp2 eval maml", "mp2 step fumi",
            "mp2 step maml", "dp2 clip epoch", "dp2 sweep fumi S=4",
            "nccl dp1 train fumi")


def md_cfg(Config, model: str, **kw):
    """Phase 7z's configs: the flagship training config with dropout 0, so
    a held step sees no dropout draws."""
    return train_cfg(Config, model, **kw).replace(dropout=0.0)


def md_s(fn, dev) -> float:
    """Host seconds of ``fn()`` up to the end of its work on ``dev``."""
    import torch
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def md_rank_start(ctx):
    """A rank's first step: the parent's sizes, and the rank's device."""
    from fumi_tpu_torch.core import distributed
    globals().update(ctx["sizes"])
    return distributed.rank_device()


def md_counts():
    from fumi_tpu_torch.ops import kernels
    return {name: getattr(kernels, name).launches for name in KERNEL_NAMES}


def md_reset():
    from fumi_tpu_torch.ops import kernels
    for name in KERNEL_NAMES:
        getattr(kernels, name).launches = 0


def md_samplers(ctx, dev):
    """Phase 5's train and phase 6's eval sampler on this rank's card."""
    import torch
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    table = torch.from_numpy(ctx["table"]).to(dev)
    kw = dict(use_pallas_gather=True, device=dev)
    return (DeviceEpisodeSampler(table, ctx["ids"], ctx["cset"],
                                 EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E),
                                 **kw),
            DeviceEpisodeSampler(table, ctx["ids"], ctx["cset"],
                                 EpisodeSpec(B, WAYS, SHOTS, EVAL_Q, D, E),
                                 **kw))


def md_episode(np_episode, dev):
    from fumi_tpu_torch import bridge
    return bridge.episode_from_numpy(np_episode, device=dev)


def md_gloo_rank(rank: int, ctx: dict) -> dict:
    """One of the two ranks that share the card: (a) the dp engine's step
    on the held episode, a timed chunk and its busy share, the collective's
    time, eval through the fused kernels; (b) the 2-D engine's step; (e)
    a dp CLIP epoch and a dp sweep; (f) the batched request sharded over
    the two ranks (phase 7zs). Each path's launches come back beside its
    results."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from fumi_tpu_torch.cli.main import _NullWriter
    from fumi_tpu_torch.core import mesh as mesh_lib
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.data.supervised import supervised_from_class_set
    from fumi_tpu_torch.parallel import engine, pjit_engine
    from fumi_tpu_torch.train import clip_loop, optim, steps, sweep
    dev = md_rank_start(ctx)
    out = {"backend": dist.get_backend(), "device": str(dev),
           "launches": {}}
    train_smp, eval_smp = md_samplers(ctx, dev)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    dp = mesh_lib.make_mesh(2, 1)
    held = md_episode(ctx["episode"], dev)

    # (a) one step on the held episode, then a chunk on the rank's tasks
    cfg = md_cfg(Config, "fumi")
    par = engine.make_parallel_steps(cfg, torch.Generator().manual_seed(0),
                                     dp, dev)
    out["step fumi"] = par.train_step(par.params, par.opt.init(par.params),
                                      held, gen(12))[0]
    run = engine.make_parallel_chunked_train(cfg, par.family, par.opt,
                                             train_smp, dp, MD_CHUNK)
    p, s, g, _ = run(par.params, par.opt.init(par.params),
                     train_smp.generator(1))  # warm
    secs = []
    for turn in range(2):
        dist.barrier()
        md_reset()
        box = {}
        secs.append(md_s(lambda: box.update(out=run(p, s, g)), dev))
        if turn == 0:
            out["launches"]["dp2 train fumi"] = md_counts()
    p, s, g, ms = box["out"]
    out["chunk"] = (p, ms["loss"])
    out["chunk s"] = secs
    ran = []

    def three_steps():
        ran.append(1)
        run(p, s, g, 3)
    traced = None
    try:
        if dev.type == "cuda":
            traced = device_profile(three_steps)
    except Exception as e:  # a measurement, not a check
        out["profile error"] = repr(e)
    if not ran:
        three_steps()  # the other rank waits in this chunk's all-reduces
    out["device ms a step"] = None if traced is None else traced[0] / 3
    out["operations a step"] = None if traced is None else traced[1] / 3
    flat = torch.zeros(sum(v.numel() for v in p.values()) + 1, device=dev)
    dist.barrier()
    out["collective ms"] = 1e3 * md_s(lambda: [
        mesh_lib.all_reduce_(flat, dp.dp_group)
        for _ in range(MD_COLLECTIVES)], dev) / MD_COLLECTIVES
    out["collective numel"] = flat.numel()

    # eval of the held meta-batches (the single-step API), and of a chunk
    # of the rank's own draws, through the fused kernels
    for model in ("fumi", "maml"):
        ecfg = md_cfg(Config, model, pallas_fused_eval=True)
        est = engine.make_parallel_steps(ecfg,
                                         torch.Generator().manual_seed(0),
                                         dp, dev)
        evs = [md_episode(e, dev) for e in ctx["eval episodes"]]
        md_reset()
        got = [est.eval_step(est.params, e, gen(3)) for e in evs]
        out["launches"][f"dp2 eval {model} (steps)"] = md_counts()
        out[f"eval {model}"] = [(r["loss"], r["acc"], r["preds"])
                                for r in got]
        erun = engine.make_parallel_chunked_eval(ecfg, est.family, eval_smp,
                                                 dp)
        erun(est.params, eval_smp.generator(98), 1)  # warm
        dist.barrier()
        md_reset()
        box = {}
        sec = md_s(lambda: box.update(out=erun(
            est.params, eval_smp.generator(99), EVAL_BATCHES)), dev)
        out["launches"][f"dp2 eval {model}"] = md_counts()
        out[f"eval {model} chunk"] = (sec, box["out"][1]["loss"])

    # (b) the 2-D engine, dp=1 x mp=2, on the held episode
    mp = mesh_lib.make_mesh(1, 2)
    for model in ("fumi", "maml"):
        mcfg = md_cfg(Config, model)
        st = pjit_engine.make_pjit_steps(
            mcfg, torch.Generator().manual_seed(0), mp, dev)
        s0 = st.opt.init(st.params)
        st.train_step(st.params, s0, held, gen(12))  # warm
        dist.barrier()
        md_reset()
        box = {}
        sec = md_s(lambda: box.update(out=st.train_step(
            st.params, s0, held, gen(12))), dev)
        out["launches"][f"mp2 step {model}"] = md_counts()
        out[f"mp step {model}"] = (box["out"][0], sec, sorted(
            k for k, v in pjit_engine.param_pspecs(st.params, mp).items()
            if v == pjit_engine.SHARDED))

    # (e) a CLIP epoch over the two ranks' rows, and one SGD step of it
    ccfg = Config(model="clip", dataset="synthetic", im_emb_dim=D,
                  text_emb_dim=E, clip_latent_dim=512, batch_size=CLIP_BATCH,
                  lr=CLIP_LR, seed=0)
    model, cparams = clip_loop.make_clip(ccfg,
                                         torch.Generator().manual_seed(0))
    cparams = {k: v.to(dev) for k, v in cparams.items()}
    text, image, valid = ctx["clip batch"]
    sgd = optim.init_optim("SGD", MD_CLIP_SGD_LR, 0.0, 0.0)
    out["clip step"] = clip_loop.dp_train_step(
        model, sgd, cparams, sgd.init(cparams), text.to(dev), image.to(dev),
        valid, dp)[::2]
    opt = optim.init_optim(ccfg.optim, ccfg.lr, ccfg.weight_decay,
                           ccfg.momentum)
    data = (supervised_from_class_set(ctx["cset"]), ctx["table"])
    dist.barrier()
    md_reset()
    box = {}
    sec = md_s(lambda: box.update(out=clip_loop.train_epoch(
        ccfg, model, opt, cparams, opt.init(cparams), data,
        np.random.RandomState(0), dp)), dev)
    out["launches"]["dp2 clip epoch"] = md_counts()
    out["clip epoch"] = (box["out"][0], box["out"][2], sec)

    # (e) the S=4 sweep over the two ranks: seeds 0-1 here, 2-3 there
    scfg = md_cfg(Config, "fumi", seed_sweep=SWEEP_S, mesh_dp=2,
                  pallas_fused_eval=True, epochs=MD_SWEEP_EPOCHS,
                  eval_freq=MD_SWEEP_EVAL_FREQ, num_ep_test=MD_SWEEP_EP_TEST)
    smesh = sweep.sweep_mesh(scfg)
    fam = sweep.build_sweep_family(scfg, None, dev,
                                   sweep.seed_shard(SWEEP_S, smesh))
    dist.barrier()
    md_reset()
    box = {}
    sec = md_s(lambda: box.update(out=sweep.sweep_training_run(
        scfg, fam, steps.make_opt(scfg), train_smp, eval_smp,
        _NullWriter("sweep"), ctx["sweep dir"], mesh=smesh)), dev)
    out["launches"]["dp2 sweep fumi S=4"] = md_counts()
    out["sweep"] = (sweep.gather_seeds(box["out"][0], smesh), sec)

    # (f) phase 7zs: the batched request sharded over the two ranks
    ms_rank(ctx["serve"], dev, dp, "dp2", out)
    return out


def md_nccl_rank(rank: int, ctx: dict) -> dict:
    """(c) A world of one rank on the card, so NCCL: the dp engine's chunk
    with its gradient all-reduced over that world (a group of one rank,
    so the numbers are the serial chunk's); (f) the sharded request's
    path on that world."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from fumi_tpu_torch.core import mesh as mesh_lib
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.parallel import engine
    from fumi_tpu_torch.train import steps
    dev = md_rank_start(ctx)
    train_smp, _ = md_samplers(ctx, dev)
    mesh = dataclasses.replace(mesh_lib.make_mesh(1, 1),
                               dp_group=dist.group.WORLD,
                               group=dist.group.WORLD)
    cfg = md_cfg(Config, "fumi")
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), dev)
    run = engine.make_parallel_chunked_train(cfg, st.family, st.opt,
                                             train_smp, mesh, MD_CHUNK)
    md_reset()
    box = {}
    sec = md_s(lambda: box.update(out=run(
        st.params, st.opt.init(st.params), train_smp.generator(1))), dev)
    out = {"backend": dist.get_backend(), "params": box["out"][0],
           "s": sec, "launches": {"nccl dp1 train fumi": md_counts()}}
    # (f) phase 7zs: the request on this world, its logits gathered by NCCL
    ms_rank(ctx["serve"], dev, mesh, "nccl", out)
    return out


def md_driver(root: str, card: str) -> dict:
    """(d) The driver as two ``--tpu_dist_*`` processes sharing the card
    (gloo), FuMI at phase 7's flags and depth: identical ``TEST`` lines,
    run dirs ``-p0`` and ``-p1`` each with ``ckpt/``. Returns the wall
    seconds."""
    import ast
    import re
    import socket
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    log_dir = os.path.join(root, "dist")
    args = [sys.executable, "-m", "fumi_tpu_torch.cli.main", "--model",
            "fumi", "--dataset", "synthetic", "--augment",
            "--tpu_pallas_gather", "--tpu_pallas_fused_eval", "--epochs",
            str(DRIVER_EPOCHS), "--eval_freq", str(DRIVER_EVAL_FREQ),
            "--num_ep_test", str(DRIVER_EP_TEST), "--seed", "0",
            "--wandb_offline", "--log_dir", log_dir,
            "--tpu_dist_coordinator", f"localhost:{port}",
            "--tpu_dist_num_processes", "2"]
    share = "backend gloo (2 ranks share 1 card)"
    if not MD_USE_CUDA:
        args.append("--disable_cuda")
        share = "backend gloo"
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(args + ["--tpu_dist_process_id", str(i)],
                              cwd=HERE, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"driver process {i} of 2 failed:\n{o[-3000:]}")
    lines = []
    for i, o in enumerate(outs):
        m = re.search(r"TEST: (\{.*\})", o)
        run_line = next((ln for ln in o.splitlines()
                         if ln.startswith("running on")), "")
        print(f"main path, driver process {i}/2: {run_line}")
        if m is None or share not in run_line:
            fail(f"driver process {i}: no TEST line or not two gloo ranks "
                 f"on one card:\n{o[-3000:]}")
        lines.append(ast.literal_eval(m.group(1)))
    runs = sorted(os.listdir(os.path.join(log_dir, "runs")))
    dirs_ok = (len(runs) == 2 and runs[0].endswith("-p0")
               and runs[1].endswith("-p1")
               and all(os.path.isdir(os.path.join(log_dir, "runs", r, "ckpt"))
                       for r in runs))
    print(f"main path, driver as two --tpu_dist_* processes on one card: "
          f"TEST {lines[0]}; identical {lines[0] == lines[1]}; run dirs "
          f"{runs}; {wall:.1f} s of wall time for both [{card}]")
    if lines[0] != lines[1] or not dirs_ok:
        fail("the two driver processes disagree or their run dirs are wrong")
    return {"driver 2 processes s": wall}


def md_close(label: str, got, want) -> float:
    """The largest |difference| of two state dicts; fails past MD_TOL."""
    import numpy as np
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].detach().cpu().numpy(), w.detach().cpu().numpy()
        worst = max(worst, float(np.abs(g - w).max()))
        if not np.allclose(g, w, **MD_TOL):
            fail(f"{label}: {k} off by {np.abs(g - w).max():.3e} "
                 f"(rtol 2e-4, atol 1e-5)")
    return worst


def multi_device_phase(Config, dev, root, card, table_np, ids_np, cset,
                       by_path) -> dict:
    """Phases 7z and 7zs. The serial references on this process's card (and
    the single-rank request, ``ms_reference``), then a world of two gloo
    ranks sharing it (``md_gloo_rank``), the serial chunk timed again
    (turns), a one-rank NCCL world (``md_nccl_rank``), the sharded
    requests' checks (``ms_check``) and the driver as two ``--tpu_dist_*``
    processes (``md_driver``). Each rank's launches are summed into
    ``by_path``. Returns the times."""
    import numpy as np
    import torch
    from fumi_tpu_torch import bridge
    from fumi_tpu_torch.data.supervised import (epoch_batches,
                                                supervised_from_class_set)
    from fumi_tpu_torch.parallel.launch import spawn_world
    from fumi_tpu_torch.train import clip_loop, optim, steps, sweep
    from fumi_tpu_torch.cli.main import _NullWriter
    times = {}
    train_smp, eval_smp = md_samplers(
        {"table": table_np, "ids": ids_np, "cset": cset}, dev)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    held = train_smp.sample(gen(11))
    egen = gen(3)
    evals = [eval_smp.sample(egen) for _ in range(EVAL_BATCHES)]

    # serial references on the card
    serial = {}
    for model in ("fumi", "maml"):
        st = steps.make_steps(md_cfg(Config, model),
                              torch.Generator().manual_seed(0), dev)
        serial[f"step {model}"] = st.train_step(
            st.params, st.opt.init(st.params), held, gen(12))[0]
        est = steps.make_steps(md_cfg(Config, model, pallas_fused_eval=True),
                               torch.Generator().manual_seed(0), dev)
        serial[f"eval {model}"] = [est.eval_step(est.params, e, gen(3))
                                   for e in evals]
    cfg = md_cfg(Config, "fumi")
    st = steps.make_steps(cfg, torch.Generator().manual_seed(0), dev)
    srun = steps.make_chunked_train(st.family, st.opt, train_smp, MD_CHUNK)
    sp, ss, sg, _ = srun(st.params, st.opt.init(st.params),
                         train_smp.generator(1))
    serial_s = [md_s(lambda: srun(sp, ss, sg), dev)]
    nccl_ref = srun(st.params, st.opt.init(st.params),
                    train_smp.generator(1))[0]

    ccfg = Config(model="clip", dataset="synthetic", im_emb_dim=D,
                  text_emb_dim=E, clip_latent_dim=512, batch_size=CLIP_BATCH,
                  lr=CLIP_LR, seed=0)
    cmodel, cparams = clip_loop.make_clip(ccfg,
                                          torch.Generator().manual_seed(0))
    cparams = {k: v.to(dev) for k, v in cparams.items()}
    sup = supervised_from_class_set(cset)
    image, text, ids, valid_n = next(epoch_batches(
        sup, table_np, CLIP_BATCH, np.random.RandomState(5)))
    image, text, u = clip_loop.dedupe_batch(image, text, ids, valid_n)
    clip_batch = (torch.from_numpy(text), torch.from_numpy(image), u)
    sgd = optim.init_optim("SGD", MD_CLIP_SGD_LR, 0.0, 0.0)
    clip_step = clip_loop.train_step(
        cmodel, sgd, cparams, sgd.init(cparams), clip_batch[0].to(dev),
        clip_batch[1].to(dev), u)[::2]
    copt = optim.init_optim(ccfg.optim, ccfg.lr, ccfg.weight_decay,
                            ccfg.momentum)
    clip_s = md_s(lambda: serial.update(clip=clip_loop.train_epoch(
        ccfg, cmodel, copt, cparams, copt.init(cparams), (sup, table_np),
        np.random.RandomState(0))), dev)

    scfg = md_cfg(Config, "fumi", seed_sweep=SWEEP_S, pallas_fused_eval=True,
                  epochs=MD_SWEEP_EPOCHS, eval_freq=MD_SWEEP_EVAL_FREQ,
                  num_ep_test=MD_SWEEP_EP_TEST)
    sweep_dir = os.path.join(root, "sweep-dp2")
    sweep_s = md_s(lambda: serial.update(sweep=sweep.sweep_training_run(
        scfg, sweep.build_sweep_family(scfg, None, dev), steps.make_opt(scfg),
        train_smp, eval_smp, _NullWriter("sweep"),
        os.path.join(root, "sweep-1"))[0]), dev)

    # (f) phase 7zs: the single-rank request the sharded ones are held to
    serve_ctx, serve_ref = ms_reference(Config, dev)

    # (a), (b), (e), (f): two ranks share the card over gloo
    sizes = {k: globals()[k] for k in MD_SIZES}
    ctx = {"sizes": sizes, "table": table_np, "ids": ids_np, "cset": cset,
           "episode": bridge.episode_to_numpy(held),
           "eval episodes": [bridge.episode_to_numpy(e) for e in evals],
           "clip batch": clip_batch, "sweep dir": sweep_dir,
           "serve": serve_ctx}
    t0 = time.perf_counter()
    ranks = [r.value for r in spawn_world(md_gloo_rank, 2, ctx,
                                          store_dir=root,
                                          use_cuda=MD_USE_CUDA)]
    times["gloo world s"] = time.perf_counter() - t0
    serial_s.append(md_s(lambda: srun(sp, ss, sg), dev))
    for r in ranks:
        if r["backend"] != "gloo" or r["device"] != str(dev):
            fail(f"phase 7z: a rank on {r['device']} over {r['backend']}, "
                 "expected two gloo ranks on cuda:0")

    # (a) the step, the params across ranks, eval
    err = max(md_close(f"dp2 step fumi, rank {i}", r["step fumi"],
                       serial["step fumi"]) for i, r in enumerate(ranks))
    same = trees_equal(ranks[0]["chunk"][0], ranks[1]["chunk"][0])
    dp_eps = [MD_CHUNK * B / s for s in ranks[0]["chunk s"]]
    serial_eps = [MD_CHUNK * B / s for s in serial_s]
    step_ms = 1e3 * min(ranks[0]["chunk s"]) / MD_CHUNK
    dev_ms = [r["device ms a step"] for r in ranks]
    busy = (None if None in dev_ms
            else 100 * sum(dev_ms) / step_ms)
    print(f"main path, dp=2 train fumi (two gloo ranks on one card, B/dp=2 "
          f"tasks a rank): one step on the held episode within {err:.3e} of "
          f"the serial step (rtol 2e-4, atol 1e-5); params after a chunk of "
          f"{MD_CHUNK} bitwise equal across the ranks: {same}; episodes/s "
          f"(all ranks) {dp_eps[0]:.1f}, {dp_eps[1]:.1f} against serial "
          f"{serial_eps[0]:.1f}, {serial_eps[1]:.1f} (turns: serial, dp, "
          f"dp, serial); device time a step "
          f"{', '.join('not measured' if d is None else f'{d:.3f} ms' for d in dev_ms)} "
          f"(ranks 0, 1; torch.profiler, 3 steps) in {step_ms:.3f} ms of "
          f"wall time: card busy "
          f"{'not measured' if busy is None else f'{busy:.1f}%'}; one packed "
          f"all-reduce of {ranks[0]['collective numel']} fp32 (the "
          f"gradient and loss) {ranks[0]['collective ms']:.3f} ms "
          f"(gloo, rank 0) [{card}]")
    if not same:
        fail("dp=2: the ranks' params differ after a chunk")
    times.update({"dp2 train eps": dp_eps, "serial train eps": serial_eps,
                  "dp2 step ms": step_ms, "dp2 device ms": dev_ms,
                  "dp2 busy %": busy,
                  "dp2 collective ms": ranks[0]["collective ms"]})
    for model in ("fumi", "maml"):
        want = serial[f"eval {model}"]
        for i, r in enumerate(ranks):
            for j, ((loss, acc, preds), w) in enumerate(zip(
                    r[f"eval {model}"], want)):
                if abs(float(loss) - float(w["loss"])) > 1e-5 or \
                        abs(float(acc) - float(w["acc"])) > 1e-6 or \
                        not torch.equal(preds, w["preds"].cpu()):
                    fail(f"dp2 eval {model}, rank {i}, meta-batch {j}: "
                         f"{float(loss)}/{float(acc)} against "
                         f"{float(w['loss'])}/{float(w['acc'])}")
        sec, losses = ranks[0][f"eval {model} chunk"]
        times[f"dp2 eval {model} eps"] = EVAL_BATCHES * B / sec
        print(f"main path, dp=2 eval {model} through the fused kernel: "
              f"{EVAL_BATCHES} held meta-batches, loss, acc (1e-5, 1e-6) and "
              f"preds (equal) the serial eval's on both ranks; a chunk of "
              f"{EVAL_BATCHES} of the ranks' own draws {sec:.3f} s = "
              f"{times[f'dp2 eval {model} eps']:.1f} episodes/s, loss "
              f"{float(losses.mean()):.4f} [{card}]")
        if not bool(torch.isfinite(losses).all()):
            fail(f"dp2 eval {model}: non-finite losses")

    # (b) the 2-D engine
    for model in ("fumi", "maml"):
        errs = [md_close(f"mp2 step {model}, rank {i}",
                         r[f"mp step {model}"][0], serial[f"step {model}"])
                for i, r in enumerate(ranks)]
        sec, sharded = ranks[0][f"mp step {model}"][1:]
        times[f"mp2 step {model} ms"] = 1e3 * sec
        print(f"dp=1 x mp=2 step {model}: within {max(errs):.3e} of the "
              f"serial step on both ranks (rtol 2e-4, atol 1e-5); sharded "
              f"{sharded}; {1e3 * sec:.1f} ms a step [{card}]")
        if not sharded:
            fail(f"mp2 {model}: no leaf sharded")

    # (e) CLIP and the sweep
    (p, loss) = ranks[0]["clip step"]
    cerr = md_close("dp2 clip SGD step", p, clip_step[0])
    if abs(float(loss) - float(clip_step[1])) > 1e-5:
        fail(f"dp2 clip step: loss {float(loss)} against "
             f"{float(clip_step[1])}")
    cp, n_steps, csec = ranks[0]["clip epoch"]
    csame = trees_equal(cp, ranks[1]["clip epoch"][0])
    cdiff = max(float((cp[k].to(dev) - serial["clip"][0][k]).abs().max())
                for k in cp)
    finite = all(bool(torch.isfinite(v).all()) for v in cp.values())
    print(f"dp=2 CLIP: an SGD step within {cerr:.3e} of the serial step; an "
          f"epoch of {n_steps} Adam steps {csec:.3f} s ({n_steps / csec:.1f} "
          f"steps/s) against serial {clip_s:.3f} s, params bitwise across "
          f"the ranks {csame}, {cdiff:.3e} from the serial epoch's [{card}]")
    if not (csame and finite):
        fail("dp2 clip epoch: ranks differ or non-finite params")
    times.update({"dp2 clip epoch s": csec, "serial clip epoch s": clip_s})
    swept, ssec = ranks[0]["sweep"]
    ssame = trees_equal(swept, {k: v.cpu() for k, v in serial["sweep"].items()})
    print(f"dp=2 sweep S={SWEEP_S} (2 seeds a rank, {MD_SWEEP_EPOCHS + 1} "
          f"steps, fused eval): every seed's params bitwise the single-rank "
          f"sweep's: {ssame}; {ssec:.3f} s against {sweep_s:.3f} s [{card}]")
    if not ssame:
        fail("dp2 sweep: a seed differs from the single-rank sweep")
    times.update({"dp2 sweep s": ssec, "serial sweep s": sweep_s})

    # (c) one rank, NCCL
    nccl = spawn_world(md_nccl_rank, 1, {"sizes": sizes, "table": table_np,
                                          "ids": ids_np, "cset": cset,
                                          "serve": serve_ctx},
                       store_dir=root, use_cuda=MD_USE_CUDA)[0]
    nsame = trees_equal({k: v for k, v in nccl.value["params"].items()},
                        {k: v.cpu() for k, v in nccl_ref.items()})
    print(f"one-rank world: backend {nccl.value['backend']}, a chunk of "
          f"{MD_CHUNK} dp steps with the gradient all-reduced over it, "
          f"bitwise the serial chunk: {nsame}; {nccl.value['s']:.3f} s "
          f"[{card}]")
    want_backend = "nccl" if MD_USE_CUDA else "gloo"
    if nccl.value["backend"] != want_backend or not nsame:
        fail("the one-rank NCCL world did not run NCCL or differs")

    # launches, the ranks' counts summed
    expect = {
        "dp2 train fumi": new_counts(gather_episode_rows=2 * MD_CHUNK),
        "dp2 eval fumi (steps)": new_counts(fused_adapt=2 * EVAL_BATCHES),
        "dp2 eval fumi": new_counts(fused_adapt=2 * EVAL_BATCHES,
                                    gather_episode_rows=2 * EVAL_BATCHES),
        "dp2 eval maml (steps)": new_counts(
            fused_maml_adapt_batched=2 * EVAL_BATCHES),
        "dp2 eval maml": new_counts(fused_maml_adapt_batched=2 * EVAL_BATCHES,
                                    gather_episode_rows=2 * EVAL_BATCHES),
        "mp2 step fumi": new_counts(), "mp2 step maml": new_counts(),
        "dp2 clip epoch": new_counts(),
        "nccl dp1 train fumi": new_counts(gather_episode_rows=MD_CHUNK)}
    for r in ranks + [nccl.value]:
        for label, counts in r["launches"].items():
            add_counts(by_path, label, counts)
    for label, want in expect.items():
        if by_path[label] != want:
            fail(f"phase 7z {label}: launches {by_path[label]}, expected "
                 f"{want}")
    sw = by_path["dp2 sweep fumi S=4"]
    if not (sw["gather_episode_rows"] > 0 and sw["fused_adapt"] > 0):
        fail(f"dp2 sweep: launches {sw}")
    print(f"phase 7z launches, the ranks' counts summed: "
          f"{ {k: by_path[k] for k in MD_PATHS} }")
    times.update(ms_check(ranks, nccl.value, serve_ref, card, by_path))

    # (d) the driver as two processes
    times.update(md_driver(root, card))
    return times


# ---------------------------------------------------------------------------
# Phase 7zs: the batched request sharded over the ranks of phase 7z
# ---------------------------------------------------------------------------

# a request of 8 flagship episodes (M=QN queries each, bucketed to 128),
# 4 a rank at dp=2; each answer timed over 5 calls
MS_R, MS_REPS = 8, 5
MS_MODELS = ("fumi", "maml")


def ms_request():
    """MS_R flagship episodes: 5-way 5-shot supports with their labels
    shuffled, QN queries and BERT-width text each."""
    import numpy as np
    rng = np.random.RandomState(23)
    y = np.repeat(np.arange(WAYS), SHOTS).astype(np.int32)
    return (rng.randn(MS_R, S, D).astype(np.float32),
            np.stack([rng.permutation(y) for _ in range(MS_R)]),
            rng.randn(MS_R, QN, D).astype(np.float32),
            rng.randn(MS_R, S, E).astype(np.float32))


def ms_serve(clf, model: str, req):
    s_im, s_y, q_im, s_tx = req
    return clf.episode_logits_batch(
        s_im, s_y, q_im, support_text=s_tx if model == "fumi" else None)


def ms_times(fn, dev, barrier=None) -> list:
    """Host ms of MS_REPS calls of ``fn`` (each answer is fetched to the
    host), the ranks lined up by ``barrier`` before each."""
    out = []
    for _ in range(MS_REPS):
        if barrier is not None:
            barrier()
        out.append(1e3 * md_s(fn, dev))
    return out


def ms_reference(Config, dev):
    """Each model's flagship classifier on its seed-0 weights in this
    process: its answer to the request and its host ms. Returns the ranks'
    context (the request and the weights) and the references."""
    from fumi_tpu_torch.serve import FewShotClassifier
    req = ms_request()
    params, ref = {}, {}
    for model in MS_MODELS:
        clf = FewShotClassifier(flagship_cfg(Config, model), device=dev)
        params[model] = {k: v.cpu() for k, v in clf.params.items()}
        ms_serve(clf, model, req)  # warm
        ref[model] = (ms_serve(clf, model, req),
                      ms_times(lambda: ms_serve(clf, model, req), dev))
    return {"request": req, "params": params}, ref


def ms_rank(ctx, dev, mesh, label: str, out: dict) -> None:
    """A rank's side of phase 7zs: each model's classifier on the parent's
    weights under ``mesh``, its whole answer to the request (the launches
    of that one call under ``"{label} serve {model}"``) and its host ms,
    and the ms of the answer's gather alone (a shard of the padded
    logits, MD_COLLECTIVES times)."""
    import torch
    import torch.distributed as dist
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.core.mesh import all_gather_cat
    from fumi_tpu_torch.serve import FewShotClassifier
    req = ctx["request"]
    for model in MS_MODELS:
        clf = FewShotClassifier(flagship_cfg(Config, model),
                                ctx["params"][model], device=dev, mesh=mesh)
        ms_serve(clf, model, req)  # warm
        dist.barrier()
        md_reset()
        logits = ms_serve(clf, model, req)
        out["launches"][f"{label} serve {model}"] = md_counts()
        out[f"serve {model}"] = (logits, ms_times(
            lambda: ms_serve(clf, model, req), dev, dist.barrier))
    shard = torch.zeros((MS_R // mesh.dp, 1 << (QN - 1).bit_length(), WAYS),
                        device=dev)
    dist.barrier()
    out["serve gather ms"] = 1e3 * md_s(lambda: [
        all_gather_cat(shard, mesh.dp_group, gloo=mesh.gloo)
        for _ in range(MD_COLLECTIVES)], dev) / MD_COLLECTIVES


def ms_check(ranks, nccl, ref, card, by_path) -> dict:
    """Phase 7zs's checks: every rank's whole answer (two gloo ranks at
    dp=2, and the one-rank NCCL world) against the single-rank request,
    bitwise expected (a task's cluster does the same arithmetic at any R),
    else within 2e-4 of the logit scale; the gloo ranks' answers bitwise
    alike; one ``fused_adapt`` a rank a request. Returns the times."""
    import numpy as np
    times = {}
    for model in MS_MODELS:
        want, single_ms = ref[model]
        scale = float(np.abs(want).max())
        diffs = []
        for i, r in enumerate(ranks + [nccl]):
            got = r[f"serve {model}"][0]
            if got.shape != (MS_R, QN, WAYS) or not np.isfinite(got).all():
                fail(f"phase 7zs {model}: rank answer {i} of shape "
                     f"{got.shape} or not finite")
            diffs.append(float(np.abs(got - want).max()))
        alike = np.array_equal(ranks[0][f"serve {model}"][0],
                               ranks[1][f"serve {model}"][0])
        med = [statistics.median(r[f"serve {model}"][1])
               for r in ranks + [nccl]]
        single = statistics.median(single_ms)
        times[f"serve {model} ms"] = {
            "single rank": single, "dp2 rank 0": med[0],
            "dp2 rank 1": med[1], "nccl one rank": med[2]}
        print(f"phase 7zs, serve {model}, {MS_R} episodes sharded over dp=2 "
              f"(two gloo ranks on one card, {MS_R // 2} a rank, M={QN}, "
              f"{STEPS} steps): max|diff| against the single-rank request "
              f"{max(diffs[:2]):.3e} (ranks 0, 1; bitwise: "
              f"{max(diffs[:2]) == 0.0}), the one-rank NCCL world "
              f"{diffs[2]:.3e}, logit scale {scale:.3f} (rtol 2e-4 of it); "
              f"the two ranks' answers bitwise alike: {alike}; host ms, "
              f"median of {MS_REPS}: sharded {med[0]:.3f} / {med[1]:.3f} "
              f"(ranks 0, 1), single rank {single:.3f}, the NCCL world "
              f"{med[2]:.3f} [{card}]")
        if max(diffs) > 2e-4 * scale or not alike:
            fail(f"phase 7zs {model}: a rank's answer is off by "
                 f"{max(diffs):.3e} or the ranks differ")
    times["serve gather ms"] = {"gloo dp2 rank 0": ranks[0]["serve gather ms"],
                                "nccl one rank": nccl["serve gather ms"]}
    print(f"phase 7zs: the answer's gather alone ({MS_R // 2} x "
          f"{1 << (QN - 1).bit_length()} x {WAYS} fp32 a rank, "
          f"{MD_COLLECTIVES} times): {ranks[0]['serve gather ms']:.3f} ms "
          f"(gloo, staged through the host, rank 0), "
          f"{nccl['serve gather ms']:.3f} ms (NCCL, one rank) [{card}]")
    expect = {f"{w} serve {m}": new_counts(fused_adapt=n)
              for w, n in (("dp2", 2), ("nccl", 1)) for m in MS_MODELS}
    for label, want in expect.items():
        if by_path[label] != want:
            fail(f"phase 7zs {label}: launches {by_path[label]}, expected "
                 f"{want} (one fused_adapt a rank a request)")
    print(f"phase 7zs launches, the ranks' counts summed: "
          f"{ {k: by_path[k] for k in expect} }")
    return times


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "fumi_tpu_torch")):
        fail(f"no fumi_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    from fumi_tpu_torch.core.config import Config
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    from fumi_tpu_torch.data.synthetic import synthetic_class_set
    from fumi_tpu_torch.ops import _build, kernels
    from fumi_tpu_torch.serve import FewShotClassifier
    from fumi_tpu_torch.train import steps

    # ---- 1. the card --------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print_plans(dev)

    # ---- 3. kernels against their plain versions -----------------------
    # fp32 both sides; TF32 off so the plain version's matmuls are IEEE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    flagship = flagship_cfg(Config)
    fumi_clf = FewShotClassifier(flagship)
    p = fumi_clf.params
    rng = np.random.RandomState(0)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def reset_counts():
        for name in KERNEL_NAMES:
            getattr(kernels, name).launches = 0

    def read_counts():
        return {name: getattr(kernels, name).launches
                for name in KERNEL_NAMES}

    sx = on_card(rng.randn(B, S, D).astype(np.float32))
    st = on_card(rng.randn(B, S, E).astype(np.float32))
    qx = on_card(rng.randn(B, QN, D).astype(np.float32))
    sy = on_card(np.tile(np.repeat(np.arange(WAYS), SHOTS),
                         (B, 1)).astype(np.int32))
    with torch.no_grad():
        hyper0 = fumi_clf.family.model.get_hyper_params(p, st, sy)
    w = (p["im_net.linear0.weight"], p["im_net.linear0.bias"],
         p["im_net.linear1.weight"], p["im_net.linear1.bias"])
    maml_head = torch.randn((WAYS, H2), generator=torch.Generator()
                            .manual_seed(1)).to(dev) / H2 ** 0.5
    forms = {
        # FuMI: per-task head generated by the hypernetwork
        "fumi": (hyper0[:, :, :-1].contiguous(),
                 hyper0[:, :, -1].reshape(B, 1, WAYS).contiguous()),
        # MAML: one head broadcast over the tasks
        "maml": (maml_head.expand(B, WAYS, H2).contiguous(),
                 torch.zeros(B, 1, WAYS, device=dev)),
    }
    # tolerances: fused_ok
    q128 = torch.cat([qx, qx[:, -1:].expand(B, 128 - QN, D)], dim=1)
    cases = [("fumi head", B, qx, "fumi"), ("maml head", B, qx, "maml"),
             ("fumi head, served R=4 M=128", B, q128, "fumi"),
             ("fumi head, served R=1 M=128", 1, q128, "fumi")]
    max_err = 0.0
    for label, b, q, form in cases:
        head_w, head_b = forms[form]
        args = w + tuple(a[:b] for a in (head_w, head_b, sx, sy, q))
        got = kernels.fused_adapt(*args, STEPS, STEP_SIZE)
        want = kernels.fused_adapt_reference(*args, STEPS, STEP_SIZE)
        exact = kernels.fused_adapt_reference(
            *(a if a.dtype == torch.int32 else a.double() for a in args),
            STEPS, STEP_SIZE)
        torch.cuda.synchronize()
        max_err = max(max_err, fused_ok(f"fused_adapt [{label}]", got, want,
                                        exact))
        if label == "maml head":
            maml_per_task = got

    # the MAML form on the same weights: the shared head, zero bias
    maml_p = {"net.lin_0.weight": w[0], "net.lin_0.bias": w[1],
              "net.lin_1.weight": w[2], "net.lin_1.bias": w[3],
              "net.lin_final.weight": maml_head,
              "net.lin_final.bias": torch.zeros(WAYS, device=dev)}
    batched_err = check_batched(maml_p, sx, sy, qx, maml_per_task)
    aug_err = check_augment(dev)

    cset, table_np, ids_np = synthetic_class_set(
        num_classes=TABLE_CLASSES, images_per_class=TABLE_IMAGES, im_dim=D,
        text_dim=E, seed=0)
    table = on_card(table_np)
    gather_err = check_gather(table, dev)
    fused_aug_err = check_gather_augment(table, dev)
    episode_err = check_episode(table, dev)
    episode_err = max(episode_err, check_raw_gathers(dev))
    check_sampler_augment(table, ids_np, cset, dev)

    # ---- 4. the serving path at full width ------------------------------
    srng = np.random.RandomState(1)
    s_im = srng.randn(S, D).astype(np.float32)
    s_tx = srng.randn(S, E).astype(np.float32)
    s_y = np.repeat(np.arange(WAYS), SHOTS).astype(np.int32)
    q_im = srng.randn(QN, D).astype(np.float32)
    rb = lambda a: np.repeat(a[None], B, axis=0) + 0.1 * srng.randn(
        B, *a.shape).astype(np.float32)
    b_im, b_tx, b_q = rb(s_im), rb(s_tx), rb(q_im)
    b_y = np.repeat(s_y[None], B, axis=0)

    clfs = {"fumi": fumi_clf,
            "maml": FewShotClassifier(flagship.replace(model="maml"))}
    served = {}
    reset_counts()  # counts of the main path only
    for model, clf in clfs.items():
        text = (lambda x: x) if model == "fumi" else (lambda x: None)
        one = clf.episode_logits(s_im, s_y, q_im, support_text=text(s_tx))
        batch = clf.episode_logits_batch(b_im, b_y, b_q,
                                         support_text=text(b_tx))
        clf.adapt(s_im, text(s_tx), s_y)
        labels = clf.classify(q_im)
        probs = clf.classify(q_im, return_probs=True)
        served[model] = (one, batch)
        shapes_ok = (one.shape == (QN, WAYS) and batch.shape == (B, QN, WAYS)
                     and labels.shape == (QN,) and probs.shape == (QN, WAYS))
        finite = all(np.isfinite(a).all() for a in (one, batch, probs))
        print(f"serve {model}: episode_logits {one.shape}, "
              f"episode_logits_batch {batch.shape}, classify {labels.shape}; "
              f"finite {finite}")
        if not (shapes_ok and finite):
            fail(f"serving {model}: wrong shapes or non-finite logits")
    by_path = {"serve": read_counts()}
    print(f"main path, serve: launches {by_path['serve']}")
    if by_path["serve"]["fused_adapt"] == 0:
        fail("the serving path never launched fused_adapt")

    engines = {}
    for model, clf in clfs.items():
        engine = engines[model] = FewShotClassifier(clf.cfg, clf.params)
        engine._episode_fn = engine._build_episode_fn(force_engine=True)
        one, batch = served[model]
        text = (lambda x: x) if model == "fumi" else (lambda x: None)
        e_one = engine.episode_logits(s_im, s_y, q_im,
                                      support_text=text(s_tx))
        e_batch = engine.episode_logits_batch(b_im, b_y, b_q,
                                              support_text=text(b_tx))
        got = np.concatenate([one[None], batch])
        eng = np.concatenate([e_one[None], e_batch])
        exact = np.concatenate([
            served_exact(model, clf, s_im[None], s_y[None], q_im[None],
                         s_tx[None]),
            served_exact(model, clf, b_im, b_y, b_q, b_tx)])
        diff = float(np.abs(got - eng).max())
        ties, same = served_argmax(got, eng, exact)
        print(f"serve {model}: kernel vs autograd engine max|diff| "
              f"{diff:.3e} (tolerance 1e-3); argmax differs on {ties} rows, "
              f"each a tie within the tolerance that the fp64 loop decides "
              f"for the kernel: {same}; vs the fp64 loop: kernel "
              f"{float(np.abs(got - exact).max()):.3e}, engine "
              f"{float(np.abs(eng - exact).max()):.3e}")
        if not (diff <= 1e-3 and same):
            fail(f"serving {model}: kernel and autograd engine disagree")

    # ---- 5. meta-training at full width ---------------------------------
    train_spec = EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E)
    train_smp = DeviceEpisodeSampler(table, ids_np, cset, train_spec,
                                     use_pallas_gather=True, device=dev)
    aug_smp = DeviceEpisodeSampler(table, ids_np, cset, train_spec,
                                   use_pallas_gather=True,
                                   augment_scale=AUG_SCALE, device=dev)
    # --augment without --tpu_pallas_gather: the library gather, then the
    # standalone jitter kernel
    lib_aug_smp = DeviceEpisodeSampler(table, ids_np, cset, train_spec,
                                       augment_scale=AUG_SCALE, device=dev)
    trained, train_eps, train_state, aug_state = {}, {}, {}, {}
    for model in ("fumi", "maml"):
        cfg = train_cfg(Config, model)
        st = steps.make_steps(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        run = steps.make_chunked_train(st.family, st.opt, train_smp,
                                       TRAIN_CHUNK)
        gen = train_smp.generator(1)
        box = {}
        reset_counts()
        p, s, gen, warm = run(st.params, st.opt.init(st.params), gen)
        seconds = synced_s(lambda: box.update(out=run(p, s, gen)))
        by_path[f"train {model}"] = counts = read_counts()
        p, s, gen, ms = box["out"]
        losses = torch.cat([warm["loss"], ms["loss"]])
        moved = max(float((p[k] - st.params[k]).abs().max()) for k in p)
        train_eps[model] = TRAIN_CHUNK * B / seconds
        print(f"main path, train {model}: 2 chunks of {TRAIN_CHUNK} steps, "
              f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}, "
              f"acc {float(ms['acc'].mean()):.3f}, params moved up to "
              f"{moved:.3e}; timed chunk {seconds:.3f} s = "
              f"{train_eps[model]:.1f} episodes/s; launches {counts}; "
              f"metrics {sorted(ms)}")
        if not bool(torch.isfinite(losses).all()) or moved == 0.0:
            fail(f"training {model}: non-finite losses or params unmoved")
        # a step: one launch for the episode's rows
        expect = {name: 0 for name in KERNEL_NAMES}
        expect["gather_episode_rows"] = 2 * TRAIN_CHUNK
        if counts != expect:
            fail(f"training {model}: launches {counts}, expected {expect}")
        trained[model] = p
        train_state[model] = (run, p, s, gen, seconds / TRAIN_CHUNK)

        # the same, one chunk on from here, with the --augment jitter
        aug_run = steps.make_chunked_train(st.family, st.opt, aug_smp,
                                           TRAIN_CHUNK)
        aug_run(p, s, aug_smp.generator(2), 2)  # warm
        reset_counts()
        seconds = synced_s(lambda: box.update(
            out=aug_run(p, s, aug_smp.generator(3))))
        by_path[f"train {model} --augment"] = counts = read_counts()
        ms = box["out"][3]
        train_eps[f"{model} --augment"] = TRAIN_CHUNK * B / seconds
        print(f"main path, train {model} --augment: {TRAIN_CHUNK} steps, "
              f"loss {float(ms['loss'][-1]):.4f}; {seconds:.3f} s = "
              f"{train_eps[f'{model} --augment']:.1f} episodes/s; launches "
              f"{counts}")
        # a step: one launch for the episode's rows, jitter included
        expect = {name: 0 for name in KERNEL_NAMES}
        expect["gather_episode_rows"] = TRAIN_CHUNK
        if not bool(torch.isfinite(ms["loss"]).all()) or counts != expect:
            fail(f"training {model} --augment: non-finite losses or "
                 f"launches {counts}, expected {expect}")
        aug_state[model] = (aug_run, p, s)
        if model == "fumi":
            lib_run = steps.make_chunked_train(st.family, st.opt,
                                               lib_aug_smp, TRAIN_CHUNK)
            lib_run(p, s, lib_aug_smp.generator(2), 2)  # warm
            reset_counts()
            seconds = synced_s(lambda: box.update(
                out=lib_run(p, s, lib_aug_smp.generator(3))))
            by_path["train fumi --augment, library gather"] = counts = \
                read_counts()
            ms = box["out"][3]
            train_eps["fumi --augment, library gather"] = \
                TRAIN_CHUNK * B / seconds
            print(f"main path, train fumi --augment without "
                  f"--tpu_pallas_gather: {TRAIN_CHUNK} steps, loss "
                  f"{float(ms['loss'][-1]):.4f}; {seconds:.3f} s = "
                  f"{TRAIN_CHUNK * B / seconds:.1f} episodes/s; launches "
                  f"{counts}")
            expect = {name: 0 for name in KERNEL_NAMES}
            expect["augment_embeddings"] = TRAIN_CHUNK
            if not bool(torch.isfinite(ms["loss"]).all()) or \
                    counts != expect:
                fail(f"training fumi --augment on the library gather: "
                     f"non-finite losses or launches {counts}, expected "
                     f"{expect}")
        train_step_card_vs_cpu(cfg, train_smp, dev)

    # ---- 6. eval at full width, fused kernel against the engine ----------
    eval_smp = DeviceEpisodeSampler(
        table, ids_np, cset, EpisodeSpec(B, WAYS, SHOTS, EVAL_Q, D, E),
        use_pallas_gather=True, device=dev)
    eval_eps = {}
    per_query = 1.0 / (B * WAYS * EVAL_Q)
    for model, params in trained.items():
        out = {}
        for path, fused in (("fused kernel", True), ("autograd engine",
                                                     False)):
            cfg = train_cfg(Config, model, pallas_fused_eval=fused)
            family = steps.build_family(cfg, torch.Generator().manual_seed(0))
            run = steps.make_chunked_eval(family, eval_smp)
            run(params, eval_smp.generator(99), 1)  # warm
            box = {}
            reset_counts()
            seconds = synced_s(lambda: box.update(
                out=run(params, eval_smp.generator(3), EVAL_BATCHES)))
            counts = read_counts()
            if fused:
                by_path[f"eval {model}"] = counts
            out[path] = box["out"][1]
            eval_eps[(model, path)] = EVAL_BATCHES * B / seconds
            print(f"{'main path, ' if fused else ''}eval {model} through the "
                  f"{path}: {EVAL_BATCHES} meta-batches, loss "
                  f"{float(out[path]['loss'].mean()):.4f}, acc "
                  f"{float(out[path]['acc'].mean()):.4f}; {seconds:.3f} s = "
                  f"{eval_eps[(model, path)]:.1f} episodes/s; launches "
                  f"{counts}")
            # fused: FuMI's per-task heads through fused_adapt, MAML's
            # shared head through the batched kernel
            kernel = "fused_adapt" if model == "fumi" else \
                "fused_maml_adapt_batched"
            expect = {name: 0 for name in KERNEL_NAMES}
            expect["gather_episode_rows"] = EVAL_BATCHES
            expect[kernel] = EVAL_BATCHES if fused else 0
            if counts != expect:
                fail(f"eval {model} through the {path}: launches {counts}, "
                     f"expected {expect}")
        k, e = out["fused kernel"], out["autograd engine"]
        loss_diff = float((k["loss"] - e["loss"]).abs().max())
        acc_diff = float((k["acc"] - e["acc"]).abs().max())
        print(f"eval {model}: kernel vs engine per meta-batch: loss "
              f"max|diff| {loss_diff:.3e} (tolerance 1e-3), acc max|diff| "
              f"{acc_diff:.4f} (tolerance one query, {per_query:.4f})")
        finite = bool(torch.isfinite(k["loss"]).all())
        if not (finite and loss_diff <= 1e-3
                and acc_diff <= per_query + 1e-6):
            fail(f"eval {model}: fused kernel and autograd engine disagree")

    # ---- 7. the experiment driver at full width -------------------------
    import tempfile
    import shutil
    driver_root = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    request = (s_im, s_y, q_im, s_tx)
    try:
        driver_walls, driver_dirs = driver_runs(driver_root, reset_counts,
                                                read_counts, by_path)
        # ---- 7a. serving from the run dirs the driver just wrote -------
        served_clfs, load_ms = checkpoint_serving(
            driver_dirs, request, dev, reset_counts, read_counts, by_path)
        # ---- 7b. the HTTP front-end on the card --------------------------
        http_ms = http_serving(served_clfs["fumi"], driver_dirs["fumi"][0],
                               request, (b_im, b_y, b_q, b_tx), dev,
                               reset_counts, read_counts, by_path)
        # ---- 7c. AM3, ProtoNet and MatchingNet at the flagship width -----
        fam_eps, am3_busy = prototype_families(
            Config, train_smp, aug_smp, eval_smp, dev, reset_counts,
            read_counts, by_path)
        # ---- 7d. the driver for AM3 ---------------------------------------
        driver_walls.update(am3_driver(driver_root, reset_counts,
                                       read_counts, by_path))
        # ---- 7e. CLIP -----------------------------------------------------
        clip_times = clip_phase(driver_root, dev, reset_counts, read_counts,
                                by_path)
        # ---- 7f. the token text encoders ---------------------------------
        token_times = token_encoders(
            Config, dev, driver_root, reset_counts, read_counts, by_path,
            {"fumi": train_eps["fumi"], "am3": fam_eps["train am3"]})
        # ---- 7g-7i. datasets, meta-gradient variants, the registry -------
        late_phases(LATE_PHASES, Config, dev, driver_root, card,
                    (train_smp, eval_smp), request, reset_counts,
                    read_counts, by_path)
        # ---- 7j-7n. the bf16 policy and the raw-image backbones ---------
        pr10_times = pr10_phases(PR10_PHASES, Config, dev, driver_root, card,
                                 table, ids_np, cset, reset_counts,
                                 read_counts, by_path)
        # ---- 7o-7s-b. training extensions, host samplers, .pth.tar, stage
        # and block remat
        pr11_times = pr11_phases(
            PR11_PHASES, Config, dev, driver_root, card,
            {"samplers": (train_smp, eval_smp), "request": request,
             "table": table_np, "ids": ids_np, "cset": cset,
             "driver_dirs": driver_dirs},
            reset_counts, read_counts, by_path)
        # ---- 7t-7y. the seed sweep, its driver, the seed ensemble,
        # grad-accum, --tpu_watch and --tpu_profile_dir
        pr12_times = pr12_phases(
            PR12_PHASES, Config, dev, driver_root, card,
            {"samplers": (train_smp, eval_smp), "request": request,
             "batch": (b_im, b_y, b_q, b_tx), "table": table, "ids": ids_np,
             "cset": cset},
            reset_counts, read_counts, by_path)
        # ---- 7z. the multi-device engines on one card --------------------
        t0 = time.perf_counter()
        md_times = multi_device_phase(Config, dev, driver_root, card,
                                      table_np, ids_np, cset, by_path)
        print(f"phase multi-device: {time.perf_counter() - t0:.1f} s",
              flush=True)
        # ---- 7zn. conv4's norm, ReLU and pool as one op ------------------
        nrp = norm_relu_pool_phase(Config, dev, card)
    finally:
        shutil.rmtree(driver_root, ignore_errors=True)

    # ---- 8. times ------------------------------------------------------
    # fused_adapt at B=4 (FuMI eval) and at R=1 (a served request, the
    # queries in the bucket of 128), kernel and plain version in turns
    head_w, head_b = forms["fumi"]
    f_args = {"B=4": w + (head_w, head_b, sx, sy, qx, STEPS, STEP_SIZE),
              "R=1": w + tuple(a[:1] for a in (head_w, head_b, sx, sy))
              + (q128[:1], STEPS, STEP_SIZE)}
    f_cost = {"B=4": fused_adapt_cost(B, S, QN, D, H1, H2, WAYS, STEPS),
              "R=1": fused_adapt_cost(1, S, 128, D, H1, H2, WAYS, STEPS)}
    f_ms, f_plain_ms, f_bound = {}, {}, {}
    for label, args in f_args.items():
        turns = {}
        for turn in ("kernel", "plain", "kernel", "plain"):
            fn = kernels.fused_adapt if turn == "kernel" else \
                kernels.fused_adapt_reference
            turns.setdefault(turn, []).append(
                cuda_ms(lambda: fn(*args), 1, 5))
        f_ms[label] = statistics.median(turns["kernel"])
        f_plain_ms[label] = statistics.median(turns["plain"])
        flops, nbytes = f_cost[label]
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        f_bound[label] = (1e3 * max(t_ops, t_bytes),
                          "operations" if t_ops >= t_bytes else "bytes",
                          flops)
        print(f"fused_adapt {label} S={S} D={D} H=({H1},{H2}) N={WAYS} "
              f"steps={STEPS}: kernel {f_ms[label]:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in turns['kernel'])}), plain "
              f"{f_plain_ms[label]:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in turns['plain'])}), bound "
              f"{f_bound[label][0]:.4f} ms ({f_bound[label][1]}: "
              f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s fp32); no single "
              "PyTorch call computes this function, so library_ms is null")
    kernel_ms, plain_ms = f_ms["B=4"], f_plain_ms["B=4"]
    bound_ms, bound_by, _ = f_bound["B=4"]
    requests = {}
    for path, clf in (("fused kernel", fumi_clf),
                      ("autograd engine", engines["fumi"])):
        requests[path] = (
            host_ms(lambda: clf.episode_logits(s_im, s_y, q_im,
                                               support_text=s_tx)),
            host_ms(lambda: clf.episode_logits_batch(b_im, b_y, b_q,
                                                     support_text=b_tx)))
    for path, (one_ms, batch_ms) in requests.items():
        print(f"FuMI request through the {path} (M={QN}, bucket 128): "
              f"episode_logits {one_ms:.3f} ms, episode_logits_batch "
              f"R={B} {batch_ms:.3f} ms")

    # the crossover of ops/kernels.py:MIN_FUSED_STEPS: a FuMI R=1 request
    # through the kernel (the gate lowered to 1 while its path is built) and
    # through the autograd engine, at short horizons
    gate = kernels.MIN_FUSED_STEPS
    crossover = {}
    for n in CROSSOVER_STEPS:
        cfg_n = flagship.replace(num_test_adapt_steps=n)
        paths = {}
        for path in ("fused kernel", "autograd engine"):
            clf = FewShotClassifier(cfg_n, fumi_clf.params)
            kernels.MIN_FUSED_STEPS = 1
            try:
                clf._episode_fn = clf._build_episode_fn(
                    force_engine=path == "autograd engine")
            finally:
                kernels.MIN_FUSED_STEPS = gate
            before = kernels.fused_adapt.launches
            paths[path] = host_ms(lambda: clf.episode_logits(
                s_im, s_y, q_im, support_text=s_tx))
            if (kernels.fused_adapt.launches > before) != \
                    (path == "fused kernel"):
                fail(f"crossover n={n}: the {path} path took the other "
                     "route")
        crossover[n] = paths
        print(f"FuMI R=1 request at {n} adaptation steps: fused kernel "
              f"{paths['fused kernel']:.3f} ms, autograd engine "
              f"{paths['autograd engine']:.3f} ms")
    wins = [n for n in CROSSOVER_STEPS
            if all(crossover[m]["fused kernel"] < crossover[m]["autograd "
                                                            "engine"]
                   for m in CROSSOVER_STEPS if m >= n)]
    print(f"MIN_FUSED_STEPS: the kernel is faster from "
          f"{min(wins) if wins else 'no measured horizon'} steps on (the "
          f"constant is {gate})")

    # gather_rows at the flagship query gather: 100 index sets (as 100
    # episodes draw them) in one CUDA graph, so launch cost stays out; the
    # 32 MiB table fits the 50 MB L2, as it stays there while training
    m_q = B * WAYS * TRAIN_Q
    ggen = torch.Generator(device=dev).manual_seed(5)
    idx_sets = [torch.randint(0, table.shape[0], (m_q,), generator=ggen,
                              dtype=torch.int32, device=dev)
                for _ in range(100)]
    idx_long = [i.long() for i in idx_sets]
    calls = {"kernel": [lambda i=i: kernels.gather_rows(table, i)
                        for i in idx_sets],
             "plain": [lambda i=i: kernels.gather_rows_reference(table, i)
                       for i in idx_sets],
             "library": [lambda i=i: torch.index_select(table, 0, i)
                         for i in idx_long]}
    times = {}
    for turn in ("kernel", "plain", "library", "library", "plain",
                 "kernel"):
        times.setdefault(turn, []).append(graph_ms(calls[turn]))
    g_ms = statistics.median(times["kernel"])
    g_plain_ms = statistics.median(times["plain"])
    g_lib_ms = statistics.median(times["library"])
    g_bytes = gather_bytes(m_q, D * table.element_size())
    g_bound_ms = 1e3 * g_bytes / PEAK_BYTES_PER_S
    g_host_ms = cuda_ms(lambda: kernels.gather_rows(table, idx_sets[0]),
                        10, 50)
    print(f"gather_rows M={m_q} D={D} fp32 (device time, CUDA graph of 100 "
          f"calls): kernel {g_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times['kernel'])}), plain "
          f"{g_plain_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times['plain'])}), "
          f"index_select {g_lib_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times['library'])}), bound "
          f"{g_bound_ms * 1e3:.2f} us (bytes: {g_bytes / 1e6:.2f} MB at "
          f"3.35 TB/s); one call from the host with its launch, CUDA "
          f"events: {g_host_ms * 1e3:.2f} us")

    # fused_maml_adapt_batched at B=4 flagship on the MAML inputs of phase
    # 3, CUDA events, kernel and plain version in turns
    b_args = (sx, sy, qx, STEPS, STEP_SIZE)
    b_times = {}
    for turn in ("kernel", "plain", "kernel", "plain"):
        fn = kernels.fused_maml_adapt_batched if turn == "kernel" else \
            kernels.fused_maml_adapt_batched_reference
        b_times.setdefault(turn, []).append(
            cuda_ms(lambda: fn(maml_p, *b_args), 1, 5))
    b_ms = statistics.median(b_times["kernel"])
    b_plain_ms = statistics.median(b_times["plain"])
    b_bound_ms = bound_ms  # the same function and shapes as fused_adapt
    print(f"fused_maml_adapt_batched B={B} S={S} Qn={QN} D={D} H=({H1},"
          f"{H2}) N={WAYS} steps={STEPS}: kernel {b_ms:.3f} ms (turns "
          f"{', '.join(f'{t:.3f}' for t in b_times['kernel'])}), plain "
          f"{b_plain_ms:.3f} ms (turns "
          f"{', '.join(f'{t:.3f}' for t in b_times['plain'])}), bound "
          f"{b_bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
          "computes this function, so library_ms is null")

    # the support set of a training step (B*S = 100 rows of the 2048-wide
    # fp32 table): 100 index sets and seeds (as 100 episodes draw them),
    # each route in one CUDA graph of 100 calls, in turns (forward, then
    # backward, twice): the gather alone, the standalone jitter on a
    # gathered block, the two in sequence as PR 4's sampler ran them, and
    # the jittered gather that replaced them in PR 5
    m_s = B * S
    sgen = torch.Generator(device=dev).manual_seed(6)
    s_idx = [torch.randint(0, table.shape[0], (m_s,), generator=sgen,
                           dtype=torch.int32, device=dev)
             for _ in range(100)]
    s_idx_long = [i.long() for i in s_idx]
    seeds = [torch.randint(0, 2 ** 62, (1,), generator=sgen,
                           dtype=torch.int64, device=dev) for _ in range(100)]
    ax = torch.randn((m_s, D), generator=sgen, device=dev)
    pairs = list(zip(s_idx, seeds))
    s_calls = {
        "gather_rows": [lambda i=i: kernels.gather_rows(table, i)
                        for i in s_idx],
        "gather_rows plain": [
            lambda i=i: kernels.gather_rows_reference(table, i)
            for i in s_idx],
        "index_select": [lambda i=i: torch.index_select(table, 0, i)
                         for i in s_idx_long],
        "augment_embeddings": [
            lambda s_=s_: kernels.augment_embeddings(ax, s_, AUG_SCALE)
            for s_ in seeds],
        "augment_embeddings plain": [
            lambda s_=s_: kernels.augment_embeddings_reference(
                ax, s_, AUG_SCALE) for s_ in seeds],
        "gather_rows + augment_embeddings": [
            lambda i=i, s_=s_: kernels.augment_embeddings(
                kernels.gather_rows(table, i), s_, AUG_SCALE)
            for i, s_ in pairs],
        "gather_augment_rows": [
            lambda i=i, s_=s_: kernels.gather_augment_rows(table, i, s_,
                                                           AUG_SCALE)
            for i, s_ in pairs],
        "gather_augment_rows plain": [
            lambda i=i, s_=s_: kernels.gather_augment_rows_reference(
                table, i, s_, AUG_SCALE) for i, s_ in pairs]}
    s_times = {}
    order = list(s_calls) + list(reversed(s_calls))
    for turn in order + order:
        s_times.setdefault(turn, []).append(graph_ms(s_calls[turn]))
    s_ms = {k: statistics.median(v) for k, v in s_times.items()}
    gs_bytes = gather_bytes(m_s, D * table.element_size())
    gs_bound_ms = 1e3 * gs_bytes / PEAK_BYTES_PER_S
    a_flops, a_bytes = augment_cost(m_s, D)
    a_t_ops, a_t_bytes = (a_flops / PEAK_FP32_FLOPS,
                          a_bytes / PEAK_BYTES_PER_S)
    a_bound_ms = 1e3 * max(a_t_ops, a_t_bytes)
    a_bound_by = "operations" if a_t_ops >= a_t_bytes else "bytes"
    ga_flops, ga_bytes = gather_augment_cost(m_s, D, table.element_size())
    ga_t_ops, ga_t_bytes = (ga_flops / PEAK_FP32_FLOPS,
                            ga_bytes / PEAK_BYTES_PER_S)
    ga_bound_ms = 1e3 * max(ga_t_ops, ga_t_bytes)
    ga_bound_by = "operations" if ga_t_ops >= ga_t_bytes else "bytes"
    bounds = {"gather_rows": (gs_bound_ms, "bytes", gs_bytes),
              "augment_embeddings": (a_bound_ms, a_bound_by, a_bytes),
              "gather_rows + augment_embeddings": (
                  gs_bound_ms + a_bound_ms, "bytes", gs_bytes + a_bytes),
              "gather_augment_rows": (ga_bound_ms, ga_bound_by, ga_bytes)}
    for name, turns in s_times.items():
        bound = (f", bound {bounds[name][0] * 1e3:.3f} us ({bounds[name][1]}"
                 f": {bounds[name][2] / 1e6:.3f} MB at 3.35 TB/s)"
                 if name in bounds else "")
        print(f"support set M={m_s} D={D} fp32, {name} (device time, CUDA "
              f"graph of 100 calls): {s_ms[name] * 1e3:.2f} us (turns "
              f"{', '.join(f'{t * 1e3:.2f}' for t in turns)}){bound}")
    a_ms, a_plain_ms = (s_ms["augment_embeddings"],
                        s_ms["augment_embeddings plain"])
    ga_ms, ga_plain_ms = (s_ms["gather_augment_rows"],
                          s_ms["gather_augment_rows plain"])
    for name, fn in (("augment_embeddings", lambda: kernels.augment_embeddings(
            ax, seeds[0], AUG_SCALE)),
                     ("gather_augment_rows", lambda: kernels.
                      gather_augment_rows(table, s_idx[0], seeds[0],
                                          AUG_SCALE))):
        print(f"{name} M={m_s} D={D}: one call from the host with its "
              f"launch, CUDA events: {cuda_ms(fn, 10, 50) * 1e3:.2f} us")
    rand_mul_ms = cuda_ms(lambda: ax * (1.0 + (torch.rand_like(ax) - 0.5)
                                        * (2 * AUG_SCALE)), 10, 50)
    print(f"for comparison: torch.rand + multiply on the same {m_s}x{D} "
          f"fp32, one call from the host, CUDA events: {rand_mul_ms * 1e3:.2f}"
          f" us (other random bits; not a library call of this function)")
    # whole episodes (B=4 tasks of 5 ways, 5 shots and 32 or 20 queries a
    # class), 100 index tensors and seeds (as 100 episodes draw them), each
    # route in one CUDA graph of 100 calls, in turns (forward, then
    # backward, twice): the one launch, its plain version, the two launches
    # of PR 5's sampler (the support rows by gather_augment_rows, or by
    # gather_rows where there is no jitter, then the query rows by
    # gather_rows; fp32 needs no widening pass; the indices split before
    # the graph, as that sampler split them for the episode's ids too), one
    # index_select over the episode's rows and one for each segment
    egen = torch.Generator(device=dev).manual_seed(10)
    e_seeds = [torch.randint(0, 2 ** 62, (1,), generator=egen,
                             dtype=torch.int64, device=dev)
               for _ in range(100)]

    def pr5_route(t, s_idx, q_idx, seed):
        return (kernels.gather_rows(t, s_idx) if seed is None else
                kernels.gather_augment_rows(t, s_idx, seed, AUG_SCALE),
                kernels.gather_rows(t, q_idx))

    e_ms, e_turns, e_bounds = {}, {}, {}
    for use, q in (("train", TRAIN_Q), ("eval", EVAL_Q)):
        sets = [torch.randint(0, table.shape[0], (B, WAYS, SHOTS + q),
                              generator=egen, dtype=torch.int32, device=dev)
                for _ in range(100)]
        flat = [r.reshape(-1).long() for r in sets]
        split32 = [(r[..., :SHOTS].reshape(-1).contiguous(),
                    r[..., SHOTS:].reshape(-1).contiguous()) for r in sets]
        split = [(a.long(), b.long()) for a, b in split32]
        for jit in (False, True):
            pairs = [(r, e_seeds[k] if jit else None)
                     for k, r in enumerate(sets)]
            scale = AUG_SCALE if jit else 0.0
            calls = {
                "gather_episode_rows": [
                    lambda r=r, s_=s_, c=scale: kernels.gather_episode_rows(
                        table, r, SHOTS, s_, c) for r, s_ in pairs],
                "plain": [
                    lambda r=r, s_=s_, c=scale:
                    kernels.gather_episode_rows_reference(
                        table, r, SHOTS, s_, c) for r, s_ in pairs],
                "PR 5 route (two launches)": [
                    lambda a=a, b=b, s_=s_: pr5_route(table, a, b, s_)
                    for (a, b), (_, s_) in zip(split32, pairs)],
                "index_select": [
                    lambda i=i: torch.index_select(table, 0, i)
                    for i in flat],
                "two index_selects": [
                    lambda a=a, b=b: (torch.index_select(table, 0, a),
                                      torch.index_select(table, 0, b))
                    for a, b in split]}
            label = f"{use}{' jittered' if jit else ''}"
            turns = {}
            order = list(calls) + list(reversed(calls))
            for name in order + order:
                turns.setdefault(name, []).append(graph_ms(calls[name]))
            e_turns[label] = turns
            e_ms[label] = {k: statistics.median(v) for k, v in turns.items()}
            nbytes = gather_bytes(B * WAYS * (SHOTS + q),
                                  D * table.element_size()) + (8 if jit
                                                               else 0)
            e_bounds[label] = 1e3 * nbytes / PEAK_BYTES_PER_S
            for name, t in turns.items():
                print(f"episode {label} (M={B * WAYS * SHOTS}+{B * WAYS * q}"
                      f" rows of D={D} fp32), {name} (device time, CUDA graph "
                      f"of 100 calls): {e_ms[label][name] * 1e3:.2f} us "
                      f"(turns {', '.join(f'{x * 1e3:.2f}' for x in t)}), "
                      f"bound {e_bounds[label] * 1e3:.3f} us (bytes: "
                      f"{nbytes / 1e6:.3f} MB at 3.35 TB/s)")
    e_host_ms = cuda_ms(lambda: kernels.gather_episode_rows(
        table, sets[0], SHOTS), 10, 50)
    print(f"gather_episode_rows eval episode: one call from the host with "
          f"its launch, CUDA events: {e_host_ms * 1e3:.2f} us")

    # how busy the card is in a train step: device time from a profiler
    # trace of 5 steps against the wall time of a step in the timed chunk
    prof_steps = 5
    for model, (run, p, s, gen, step_s) in train_state.items():
        traced = device_profile(lambda: run(p, s, gen, prof_steps))
        if traced is None:
            print(f"train {model}: device busy share not measured (the "
                  "profiler recorded no device time)")
            continue
        dev_ms, ops, _ = traced
        print(f"train {model}: device time {dev_ms / prof_steps:.3f} ms a "
              f"step in {ops / prof_steps:.0f} device operations "
              f"(torch.profiler, {prof_steps} steps) against "
              f"{step_s * 1e3:.3f} ms of wall time a step: the card is "
              f"busy {100 * dev_ms / prof_steps / (step_s * 1e3):.1f}% of "
              "the step")

    # an augmented train step before and after the episode's one launch,
    # on the same episodes (one generator seed; both routes give bitwise
    # the same episode): through gather_episode_rows, and with it swapped
    # for PR 5's two launches, in turns. Per route a profile of 5 steps
    # (device time and operations), then a timed chunk (episodes/s)
    one_launch = kernels.gather_episode_rows

    def two_launches(t, rows, num_shots, seed=None, scale=0.0):
        s_idx = rows[..., :num_shots].reshape(-1).contiguous()
        q_idx = rows[..., num_shots:].reshape(-1).contiguous()
        b, n = rows.shape[:2]
        support = kernels.gather_augment_rows(t, s_idx, seed, scale)
        query = kernels.pixels_to_float(kernels.gather_rows(t, q_idx))
        return (support.reshape(b, n * num_shots, -1),
                query.reshape(b, n * (rows.shape[2] - num_shots), -1))

    def through(route, fn):
        kernels.gather_episode_rows = one_launch if route == "one launch" \
            else two_launches
        try:
            return fn()
        finally:
            kernels.gather_episode_rows = one_launch
    # every launch of csrc/gather_rows.cu runs an instance of its
    # gather_kernel (the prefix keeps PyTorch's vectorized_gather_kernel
    # out)
    names = ("::gather_kernel<", "::augment_kernel")
    for model, (aug_run, p, s) in aug_state.items():
        traces, route_eps = {}, {}
        for route in ("one launch", "two launches", "two launches",
                      "one launch"):
            reset_counts()
            traced = through(route, lambda: device_profile(
                lambda: aug_run(p, s, aug_smp.generator(4), prof_steps),
                names))
            counts = read_counts()
            want = ({"gather_episode_rows": prof_steps}
                    if route == "one launch" else
                    {"gather_rows": prof_steps,
                     "gather_augment_rows": prof_steps})
            if any(counts[k] != want.get(k, 0) for k in counts):
                fail(f"profile of train {model} --augment ({route}): "
                     f"launches {counts}, expected {want}")
            if traced is not None:
                traces.setdefault(route, []).append(traced)
            seconds = through(route, lambda: synced_s(
                lambda: aug_run(p, s, aug_smp.generator(5))))
            route_eps.setdefault(route, []).append(TRAIN_CHUNK * B / seconds)
        for route, eps in route_eps.items():
            label = (f"train {model} --augment through the {route} "
                     f"({'after' if route == 'one launch' else 'before'})")
            print(f"{label}: {', '.join(f'{e:.1f}' for e in eps)} "
                  f"episodes/s (a chunk of {TRAIN_CHUNK} steps, 2 turns)")
            runs = traces.get(route)
            if not runs:
                print(f"{label}: device time not measured (the profiler "
                      "recorded no device time)")
                continue
            per_step = [(t[0] / prof_steps, t[1] / prof_steps) for t in runs]
            steps_n = len(runs) * prof_steps
            kern = ", ".join(
                f"{k} {sum(t[2][k][0] for t in runs) / steps_n:.2f} us in "
                f"{sum(t[2][k][1] for t in runs) / steps_n:.0f}"
                for k in names)
            print(f"{label}: device time a step "
                  f"{', '.join(f'{t[0]:.4f}' for t in per_step)} ms in "
                  f"{', '.join(f'{t[1]:.0f}' for t in per_step)} device "
                  f"operations (torch.profiler, {prof_steps} steps, "
                  f"{len(runs)} turns); episode-assembly kernels a step: "
                  f"{kern}")
    for model in trained:
        fused = "fused_adapt" if model == "fumi" else \
            "fused_maml_adapt_batched"
        print(f"train {model}: {train_eps[model]:.1f} episodes/s, with "
              f"--augment {train_eps[f'{model} --augment']:.1f}"
              + (f", --augment on the library gather "
                 f"{train_eps['fumi --augment, library gather']:.1f}"
                 if model == "fumi" else "") + "; eval "
              f"through {fused} "
              f"{eval_eps[(model, 'fused kernel')]:.1f} episodes/s, through "
              f"the autograd engine "
              f"{eval_eps[(model, 'autograd engine')]:.1f} episodes/s")
    print("driver wall time per run (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in driver_walls.items()))
    print("from_checkpoint load time (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in load_ms.items()))
    print(f"FuMI request median (ms): through HTTP {http_ms['http']:.3f}, "
          f"in process {http_ms['in process']:.3f}")
    print("prototype families (episodes/s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in fam_eps.items()))
    if am3_busy is not None:
        print(f"train am3 a step: device {am3_busy[0]:.3f} ms in "
              f"{am3_busy[1]:.0f} operations, wall {am3_busy[2]:.3f} ms, "
              f"busy {100 * am3_busy[0] / am3_busy[2]:.1f}%")

    busy = clip_times.get("train busy")
    print(f"clip: train {clip_times['train steps/s']:.1f} steps/s (batch "
          f"{CLIP_BATCH})" + ("" if busy is None else
                               f", busy {100 * busy[0] / busy[2]:.1f}% of "
                               f"a step ({busy[0]:.3f} of {busy[2]:.3f} ms, "
                               f"{busy[1]:.0f} device operations)")
          + f"; index {clip_times['index rows']} rows "
          f"{clip_times['index ms']:.3f} ms; "
          f"retrieve {CLIP_TEXTS} texts {clip_times['retrieve ms']:.3f} ms; "
          f"over HTTP (gallery {CLIP_HTTP_ROWS}) "
          f"{clip_times['http retrieve ms']:.3f} ms against "
          f"{clip_times['in-process retrieve ms (gallery 256)']:.3f} ms in "
          f"process; driver {clip_times['driver clip s']:.3f} s, "
          f"--evaluate {clip_times['driver clip --evaluate s']:.3f} s")
    busy = token_times.get("busy")
    print("token encoders: train episodes/s " + ", ".join(
        f"{k} {v:.1f}" for k, v in token_times["train eps"].items())
        + f" (BERT: fumi {train_eps['fumi']:.1f}, am3 "
        f"{fam_eps['train am3']:.1f}); the encoder a meta-batch "
        + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]} device operations"
                    for k, v in token_times["encoder"].items())
        + ("" if busy is None else
           f"; a fumi RNN step: device {busy[0]:.3f} ms in {busy[1]:.0f} "
           f"operations, wall {busy[2]:.3f} ms, busy "
           f"{100 * busy[0] / busy[2]:.1f}%")
        + f"; eval fumi RNN {token_times['eval eps']:.1f} episodes/s; a "
        f"request {token_times['request ms']:.3f} ms, over HTTP "
        f"{token_times['http ms']:.3f} ms; drivers "
        f"{token_times['driver fumi RNN s']:.3f} s (fumi RNN), "
        f"{token_times['driver am3 glove s']:.3f} s (am3 glove)")

    # gather_episode_rows on the bf16 flagship table and on raw rows
    pr10_gathers = time_raw_bf16_gathers(table, dev)
    print("bf16 and raw-image phases (7j-7n): " + json.dumps(
        {name: {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in t.items()} for name, t in pr10_times.items()},
        default=str))

    print("training extensions, host samplers, .pth.tar, stage and block "
          "remat (7o-7s-b): " + json.dumps(pr11_times, default=str))
    print("seed sweep, sweep driver, seed ensemble, grad-accum, watch and "
          "trace (7t-7y): " + json.dumps(pr12_times, default=str))
    print("multi-device engines (7z): " + json.dumps(md_times, default=str))

    # ---- 9. result ------------------------------------------------------
    launches = {name: sum(c[name] for c in by_path.values())
                for name in KERNEL_NAMES}
    print(json.dumps({"kernels": [{
        "name": "fused_adapt", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/fused_adapt.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:113",
        "launches": launches["fused_adapt"], "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_r1": f_ms["R=1"], "plain_ms_r1": f_plain_ms["R=1"],
        "bound_ms_r1": f_bound["R=1"][0],
        "launches_by_path": {p: c["fused_adapt"] for p, c in by_path.items()},
    }, {
        "name": "gather_rows", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:288",
        "launches": launches["gather_rows"], "max_abs_err": gather_err,
        "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": g_bound_ms,
        "bound_by": "bytes", "library_ms": g_lib_ms,
        "ms_m100": s_ms["gather_rows"],
        "plain_ms_m100": s_ms["gather_rows plain"],
        "bound_ms_m100": gs_bound_ms, "library_ms_m100": s_ms["index_select"],
        "launches_by_path": {p: c["gather_rows"] for p, c in by_path.items()},
    }, {
        "name": "augment_embeddings", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/augment_embeddings.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:53",
        "launches": launches["augment_embeddings"], "max_abs_err": aug_err,
        "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound_ms,
        "bound_by": a_bound_by, "library_ms": None,
        "launches_by_path": {p: c["augment_embeddings"]
                             for p, c in by_path.items()},
    }, {
        "name": "gather_augment_rows", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:53",
        "launches": launches["gather_augment_rows"],
        "max_abs_err": fused_aug_err, "ms": ga_ms, "plain_ms": ga_plain_ms,
        "bound_ms": ga_bound_ms, "bound_by": ga_bound_by, "library_ms": None,
        "two_launch_ms": s_ms["gather_rows + augment_embeddings"],
        "launches_by_path": {p: c["gather_augment_rows"]
                             for p, c in by_path.items()},
    }, {
        "name": "fused_maml_adapt_batched", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/fused_adapt.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:353",
        "launches": launches["fused_maml_adapt_batched"],
        "max_abs_err": batched_err, "ms": b_ms, "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms, "bound_by": bound_by, "library_ms": None,
        "launches_by_path": {p: c["fused_maml_adapt_batched"]
                             for p, c in by_path.items()},
    }, {
        # the train episode without the jitter; the eval episode and the
        # jittered ones under their own keys
        "name": "gather_episode_rows", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:288",
        "launches": launches["gather_episode_rows"],
        "max_abs_err": episode_err,
        "ms": e_ms["train"]["gather_episode_rows"],
        "plain_ms": e_ms["train"]["plain"], "bound_ms": e_bounds["train"],
        "bound_by": "bytes", "library_ms": e_ms["train"]["index_select"],
        **{f"{key}_{label.replace(' ', '_')}": e_ms[label][name]
           for label in e_ms for key, name in (
               ("ms", "gather_episode_rows"), ("plain_ms", "plain"),
               ("two_launch_ms", "PR 5 route (two launches)"),
               ("library_ms", "index_select"),
               ("two_library_ms", "two index_selects"))},
        **{f"bound_ms_{label.replace(' ', '_')}": b
           for label, b in e_bounds.items()},
        # the bf16 flagship table and raw rows of 84·84·3
        **{f"{key}_{label.replace(' ', '_')}": v
           for label, r in pr10_gathers.items() for key, v in r.items()},
        "launches_by_path": {p: c["gather_episode_rows"]
                             for p, c in by_path.items()},
    }, {
        "name": "norm_relu_pool", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/norm_relu_pool.cu",
        "replaces": None, "bound_by": "bytes", **nrp,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
