#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fumi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. the card: name and power limit from ``nvidia-smi``;
2. build every CUDA kernel of the port from ``fumi_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the flagship paths give it, with TF32 off: ``fused_adapt`` and
   ``fused_maml_adapt_batched`` to a stated tolerance, ``gather_rows`` and
   ``augment_embeddings`` bitwise (several tables, widths and seeds), and
   the sampler's ``--augment`` jitter (support only, queries clean);
4. drive the serving path (``FewShotClassifier``) at the flagship width
   (FuMI, BERT text 768, image 2048, im_hid (256, 64), 5-way 5-shot,
   100-step adaptation) with seeded random weights, then MAML; check the
   answers against the same classifier's autograd engine;
5. drive the meta-training path (``make_chunked_train`` on the device
   sampler with the kernel gather; B=4, 32 queries per class, 5
   second-order inner steps, Adam) for FuMI, then MAML, without and with
   the ``--augment`` jitter, and hold one train step on the card against
   the same step on the CPU;
6. drive the eval path (``make_chunked_eval`` with the fused kernels, 100
   steps, 20 queries per class: FuMI through ``fused_adapt``, MAML
   through ``fused_maml_adapt_batched``) and hold it against the same
   episodes through the autograd engine;
7. drive the experiment driver, ``fumi_tpu_torch.cli.main``, for FuMI and
   MAML at the flagship width on ``--dataset synthetic --augment
   --tpu_pallas_gather --tpu_pallas_fused_eval`` (21 train steps, evals at
   batches 10 and 20, a 9-meta-batch test pass), then FuMI ``--evaluate
   --checkpoint`` on the run it wrote;
8. time each kernel, its plain version and (where one exists) the one
   PyTorch call that computes the same function, and each path;
9. print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Every path of phases 4-7 sets the kernels' launch counts to 0 just before
it runs and reads them just after; it fails if it did not launch each
kernel it runs, as many times as the path runs it.

It imports no JAX. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
                "fused_maml_adapt_batched")
SOURCES = ("fused_adapt", "gather_rows", "augment_embeddings",
           "fused_adapt_batched")
# the driver phase: --epochs 20 --eval_freq 10 --num_ep_test 32 at B=4 runs
# 21 train steps, 3 validation passes of 8 // 2 + 1 meta-batches (before
# training, at batches 10 and 20) and a test pass of 8 + 1
DRIVER_EPOCHS, DRIVER_EVAL_FREQ, DRIVER_EP_TEST = 20, 10, 32
DRIVER_TRAIN_STEPS = DRIVER_EPOCHS + 1
DRIVER_TEST_BATCHES = DRIVER_EP_TEST // B + 1
DRIVER_EVAL_BATCHES = 3 * (DRIVER_EP_TEST // B // 2 + 1) + DRIVER_TEST_BATCHES


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


def device_profile(fn):
    """(device ms, device operations) of ``fn()`` summed over the CUDA
    entries of a ``torch.profiler`` trace (kernels, copies, sets), or None
    where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, "device_time_total", 0) for e in rows)
    if not device_us:
        return None
    return device_us / 1e3, sum(e.count for e in rows)


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
    """The sampler's --augment jitter: the same episode identity and query
    embeddings as without it, the support embeddings jittered within the
    scale."""
    import torch
    from fumi_tpu_torch.core.episode import EpisodeSpec
    from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
    spec = EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E)
    eps = [DeviceEpisodeSampler(table, ids_np, cset, spec,
                                use_pallas_gather=True, augment_scale=scale,
                                device=dev)
           for scale in (0.0, AUG_SCALE)]
    plain, aug = (smp.sample(smp.generator(7)) for smp in eps)
    ratio = (aug.support_im / plain.support_im).double()
    ok = (torch.equal(plain.support_ids, aug.support_ids)
          and torch.equal(plain.query_im, aug.query_im)
          and not torch.equal(plain.support_im, aug.support_im)
          and float((ratio - 1).abs().max()) <= AUG_SCALE + 1e-6)
    print(f"sampler --augment: support jittered (|out/x - 1| <= "
          f"{float((ratio - 1).abs().max()):.4f}), queries and ids as "
          f"without it: {ok}")
    if not ok:
        fail("the sampler's augmentation touched the queries or missed the "
             "support set")


def check_batched(maml_p, sx, sy, qx, per_task) -> float:
    """``fused_maml_adapt_batched`` against its plain version at B=4
    flagship, 100 steps. Tolerance 1e-3 and the same argmax: the two sum
    in other orders, and 100 fp32 SGD steps carry the difference forward
    (up to 3.1e-4 for fused_adapt, PERF.md); both distances to the
    same loop in fp64 are printed, and the distance to ``fused_adapt``
    (``per_task``) on the same inputs."""
    import torch
    from fumi_tpu_torch.ops import kernels
    args = (sx, sy, qx, STEPS, STEP_SIZE)
    got = kernels.fused_maml_adapt_batched(maml_p, *args)
    want = kernels.fused_maml_adapt_batched_reference(maml_p, *args)
    exact = kernels.fused_maml_adapt_batched_reference(
        {k: v.double() for k, v in maml_p.items()}, sx.double(), sy,
        qx.double(), STEPS, STEP_SIZE)
    torch.cuda.synchronize()
    T, smem, priv = kernels.batched_plan(
        sx.device.index, (B, S, QN, D, H1, H2, WAYS))
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
    same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
    finite = bool(torch.isfinite(got).all())
    print(f"kernel fused_maml_adapt_batched [maml head, B={B}, {T} blocks "
          f"per task, {smem} B of shared memory, private copies in "
          f"{'shared' if priv else 'device'} memory] vs plain: max|diff| "
          f"{err:.3e} (tolerance 1e-3), argmax equal {same_argmax}, finite "
          f"{finite}; vs the fp64 loop: kernel "
          f"{float((got.double() - exact).abs().max()):.3e}, plain "
          f"{float((want.double() - exact).abs().max()):.3e}; vs "
          f"fused_adapt {float((got - per_task).abs().max()):.3e}")
    if not (ok and same_argmax and finite):
        fail("fused_maml_adapt_batched disagrees with its plain version")
    return err


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


def train_step_card_vs_cpu(cfg, smp, dev):
    """One train step on the card and on the CPU from the same weights on
    the same episode, dropout 0.

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
    episode = smp.sample(smp.generator(7))
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        st = steps.make_steps(cfg0, torch.Generator().manual_seed(0),
                              device=device)
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
        g_eff = g + cfg.weight_decay * p0[k]
        off = diff > 1e-6
        flipped += int(off.sum())
        ok &= bool((g_eff[off].abs() <= g_tol).all())
        ok &= bool((diff <= 2.001 * LR).all())
        p_err = max(p_err, float(diff.max()))
    print(f"train step {cfg.model} card vs cpu: loss {l_card:.6f} vs "
          f"{l_cpu:.6f}; gradients at {g_err:.3f} of their tolerance at "
          f"most ({worst}); updated params max|diff| {p_err:.3e}, "
          f"{flipped} entries off by more than 1e-6")
    if not ok:
        fail(f"train step {cfg.model}: card and CPU disagree")


def driver_runs(root: str, reset_counts, read_counts, by_path) -> dict:
    """Phase 7: ``fumi_tpu_torch.cli.main`` on the card at the flagship
    width (the parser's defaults) for FuMI and MAML, each in its own
    ``--log_dir`` under ``root``, then FuMI ``--evaluate --checkpoint``.
    Returns the wall seconds of each run."""
    import glob
    import numpy as np
    import torch
    from fumi_tpu_torch.cli import main as cli_main
    walls = {}
    test = {}
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
        csvs = glob.glob(os.path.join(log_dir, "results", "run_*.csv"))
        with open(csvs[0]) as f:
            rows = len(f.read().splitlines()) - 1
        files = all(os.path.exists(os.path.join(run, n))
                    for n in ("ckpt", "best", "ckpt.meta.json"))
        finite = all(np.isfinite(out[f"test/{k}"])
                     for k in ("loss", "acc", "acc_ci95", "loss_ci95"))
        expect = {"augment_embeddings": DRIVER_TRAIN_STEPS,
                  "gather_rows": 2 * (DRIVER_TRAIN_STEPS
                                      + DRIVER_EVAL_BATCHES),
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
            if counts["fused_adapt"] != DRIVER_TEST_BATCHES or \
                    counts["augment_embeddings"] != 0:
                fail(f"driver fumi --evaluate: launches {counts}")
    return walls


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

    # ---- 3. kernels against their plain versions -----------------------
    # fp32 both sides; TF32 off so the plain version's matmuls are IEEE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    flagship = Config(model="fumi", text_encoder="BERT", im_emb_dim=D,
                      text_emb_dim=E, text_hid_dim=TH, im_hid_dim=(H1, H2),
                      num_ways=WAYS, num_shots=SHOTS,
                      num_test_adapt_steps=STEPS, step_size=STEP_SIZE,
                      seed=0)
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
    # Tolerances. Kernel and plain version both run the 100-step chain in
    # fp32 but sum in different orders, and the chain carries rounding
    # forward (a ReLU near zero can flip). At B=4 the plain version's
    # batched matmuls sum in about the kernel's order: 1e-4 on the logits.
    # For one episode cuBLAS picks another summation order for the plain
    # version; two fp32 evaluations then differ by a few 1e-4, as far as
    # each lies from the same loop evaluated in fp64 (printed): 1e-3.
    q128 = torch.cat([qx, qx[:, -1:].expand(B, 128 - QN, D)], dim=1)
    cases = [("fumi head", B, qx, "fumi", 1e-4),
             ("maml head", B, qx, "maml", 1e-4),
             ("fumi head, served R=4 M=128", B, q128, "fumi", 1e-4),
             ("fumi head, served R=1 M=128", 1, q128, "fumi", 1e-3)]
    max_err = 0.0
    for label, b, q, form, tol in cases:
        head_w, head_b = forms[form]
        args = w + tuple(a[:b] for a in (head_w, head_b, sx, sy, q))
        got = kernels.fused_adapt(*args, STEPS, STEP_SIZE)
        want = kernels.fused_adapt_reference(*args, STEPS, STEP_SIZE)
        exact = kernels.fused_adapt_reference(
            *(a if a.dtype == torch.int32 else a.double() for a in args),
            STEPS, STEP_SIZE)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
        same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
        print(f"kernel fused_adapt [{label}] vs plain: max|diff| {err:.3e} "
              f"(tolerance {tol:g}), argmax equal {same_argmax}, finite "
              f"{bool(torch.isfinite(got).all())}; vs the fp64 loop: kernel "
              f"{float((got.double() - exact).abs().max()):.3e}, plain "
              f"{float((want.double() - exact).abs().max()):.3e}")
        if not (ok and same_argmax and torch.isfinite(got).all()):
            fail(f"fused_adapt disagrees with its plain version ({label})")
        max_err = max(max_err, err)
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
        diff = max(np.abs(one - e_one).max(), np.abs(batch - e_batch).max())
        same = (np.array_equal(one.argmax(-1), e_one.argmax(-1))
                and np.array_equal(batch.argmax(-1), e_batch.argmax(-1)))
        print(f"serve {model}: kernel vs autograd engine max|diff| "
              f"{diff:.3e} (tolerance 1e-3), argmax equal {same}")
        if not (diff <= 1e-3 and same):
            fail(f"serving {model}: kernel and autograd engine disagree")

    # ---- 5. meta-training at full width ---------------------------------
    train_spec = EpisodeSpec(B, WAYS, SHOTS, TRAIN_Q, D, E)
    train_smp = DeviceEpisodeSampler(table, ids_np, cset, train_spec,
                                     use_pallas_gather=True, device=dev)
    aug_smp = DeviceEpisodeSampler(table, ids_np, cset, train_spec,
                                   use_pallas_gather=True,
                                   augment_scale=AUG_SCALE, device=dev)
    trained, train_eps, train_state = {}, {}, {}
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
        if counts["gather_rows"] != 2 * 2 * TRAIN_CHUNK:
            fail(f"training {model}: gather_rows launched "
                 f"{counts['gather_rows']} times, not 2 per step")
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
        if not bool(torch.isfinite(ms["loss"]).all()) or \
                counts["augment_embeddings"] != TRAIN_CHUNK or \
                counts["gather_rows"] != 2 * TRAIN_CHUNK:
            fail(f"training {model} --augment: non-finite losses or "
                 f"launches {counts}")
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
            expect = {"fused_adapt": 0, "fused_maml_adapt_batched": 0,
                      "gather_rows": 2 * EVAL_BATCHES,
                      "augment_embeddings": 0}
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
    try:
        driver_walls = driver_runs(driver_root, reset_counts, read_counts,
                                   by_path)
    finally:
        shutil.rmtree(driver_root, ignore_errors=True)

    # ---- 8. times ------------------------------------------------------
    head_w, head_b = forms["fumi"]
    args = w + (head_w, head_b, sx, sy, qx, STEPS, STEP_SIZE)
    kernel_ms = cuda_ms(lambda: kernels.fused_adapt(*args), 2, 10)
    plain_ms = cuda_ms(lambda: kernels.fused_adapt_reference(*args), 1, 5)
    flops, nbytes = fused_adapt_cost(B, S, QN, D, H1, H2, WAYS, STEPS)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    requests = {}
    for path, clf in (("fused kernel", fumi_clf),
                      ("autograd engine", engines["fumi"])):
        requests[path] = (
            host_ms(lambda: clf.episode_logits(s_im, s_y, q_im,
                                               support_text=s_tx)),
            host_ms(lambda: clf.episode_logits_batch(b_im, b_y, b_q,
                                                     support_text=b_tx)))
    print(f"fused_adapt B={B} S={S} Qn={QN} D={D} H=({H1},{H2}) N={WAYS} "
          f"steps={STEPS}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} "
          f"GFLOP at 67 TFLOP/s fp32); no single PyTorch call computes "
          "this function, so library_ms is null")
    for path, (one_ms, batch_ms) in requests.items():
        print(f"FuMI request through the {path} (M={QN}, bucket 128): "
              f"episode_logits {one_ms:.3f} ms, episode_logits_batch "
              f"R={B} {batch_ms:.3f} ms")

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
    for turn in ("kernel", "plain", "library", "kernel", "plain"):
        times.setdefault(turn, []).append(graph_ms(calls[turn]))
    g_ms = statistics.median(times["kernel"])
    g_plain_ms = statistics.median(times["plain"])
    g_lib_ms = times["library"][0]
    g_bytes = gather_bytes(m_q, D * table.element_size())
    g_bound_ms = 1e3 * g_bytes / PEAK_BYTES_PER_S
    g_host_ms = cuda_ms(lambda: kernels.gather_rows(table, idx_sets[0]),
                        10, 50)
    print(f"gather_rows M={m_q} D={D} fp32 (device time, CUDA graph of 100 "
          f"calls): kernel {g_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times['kernel'])}), plain "
          f"{g_plain_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times['plain'])}), "
          f"index_select {g_lib_ms * 1e3:.2f} us, bound "
          f"{g_bound_ms * 1e3:.2f} us (bytes: {g_bytes / 1e6:.2f} MB at "
          f"3.35 TB/s); one call from the host with its launch, CUDA "
          f"events: {g_host_ms * 1e3:.2f} us")

    # fused_maml_adapt_batched at B=4 flagship on the MAML inputs of phase
    # 3, CUDA events; fused_adapt on the same inputs in turns beside it
    b_args = (sx, sy, qx, STEPS, STEP_SIZE)
    b_times = {}
    for turn in ("kernel", "fused_adapt", "kernel", "fused_adapt"):
        fn = (lambda: kernels.fused_maml_adapt_batched(maml_p, *b_args)) \
            if turn == "kernel" else \
            (lambda: kernels.fused_maml_adapt(maml_p, *b_args))
        b_times.setdefault(turn, []).append(cuda_ms(fn, 1, 5))
    b_ms = statistics.median(b_times["kernel"])
    b_plain_ms = cuda_ms(lambda: kernels.fused_maml_adapt_batched_reference(
        maml_p, *b_args), 1, 5)
    b_bound_ms = bound_ms  # the same function and shapes as fused_adapt
    print(f"fused_maml_adapt_batched B={B} S={S} Qn={QN} D={D} H=({H1},"
          f"{H2}) N={WAYS} steps={STEPS}: kernel {b_ms:.3f} ms (turns "
          f"{', '.join(f'{t:.3f}' for t in b_times['kernel'])}), plain "
          f"{b_plain_ms:.3f} ms, bound {b_bound_ms:.4f} ms ({bound_by}); "
          f"fused_adapt on the same inputs "
          f"{', '.join(f'{t:.3f}' for t in b_times['fused_adapt'])} ms; no "
          "single PyTorch call computes this function, so library_ms is "
          "null")

    # augment_embeddings at the flagship support set: 100 seeds (as 100
    # episodes draw them) in one CUDA graph
    m_s = B * S
    agen = torch.Generator(device=dev).manual_seed(6)
    ax = torch.randn((m_s, D), generator=agen, device=dev)
    seeds = [torch.randint(0, 2 ** 62, (1,), generator=agen,
                           dtype=torch.int64, device=dev) for _ in range(100)]
    a_calls = {
        "kernel": [lambda s_=s_: kernels.augment_embeddings(ax, s_, AUG_SCALE)
                   for s_ in seeds],
        "plain": [lambda s_=s_: kernels.augment_embeddings_reference(
            ax, s_, AUG_SCALE) for s_ in seeds]}
    a_times = {}
    for turn in ("kernel", "plain", "kernel", "plain"):
        a_times.setdefault(turn, []).append(graph_ms(a_calls[turn]))
    a_ms = statistics.median(a_times["kernel"])
    a_plain_ms = statistics.median(a_times["plain"])
    a_flops, a_bytes = augment_cost(m_s, D)
    a_t_ops, a_t_bytes = (a_flops / PEAK_FP32_FLOPS,
                          a_bytes / PEAK_BYTES_PER_S)
    a_bound_ms = 1e3 * max(a_t_ops, a_t_bytes)
    a_bound_by = "operations" if a_t_ops >= a_t_bytes else "bytes"
    a_host_ms = cuda_ms(lambda: kernels.augment_embeddings(ax, seeds[0],
                                                           AUG_SCALE), 10, 50)
    rand_mul_ms = cuda_ms(lambda: ax * (1.0 + (torch.rand_like(ax) - 0.5)
                                        * (2 * AUG_SCALE)), 10, 50)
    print(f"for comparison: torch.rand + multiply on the same {m_s}x{D} "
          f"fp32, one call from the host, CUDA events: {rand_mul_ms * 1e3:.2f}"
          f" us (other random bits; not a library call of this function)")
    print(f"augment_embeddings M={m_s} D={D} fp32 (device time, CUDA graph "
          f"of 100 calls): kernel {a_ms * 1e3:.2f} us (turns "
          f"{', '.join(f'{t * 1e3:.2f}' for t in a_times['kernel'])}), plain "
          f"{a_plain_ms * 1e3:.2f} us, bound {a_bound_ms * 1e3:.3f} us "
          f"({a_bound_by}: {a_bytes / 1e6:.2f} MB at 3.35 TB/s); one call "
          f"from the host with its launch, CUDA events: "
          f"{a_host_ms * 1e3:.2f} us; library_ms null")
    # how busy the card is in a train step: device time from a profiler
    # trace of 5 steps against the wall time of a step in the timed chunk
    prof_steps = 5
    for model, (run, p, s, gen, step_s) in train_state.items():
        traced = device_profile(lambda: run(p, s, gen, prof_steps))
        if traced is None:
            print(f"train {model}: device busy share not measured (the "
                  "profiler recorded no device time)")
            continue
        dev_ms, ops = traced
        print(f"train {model}: device time {dev_ms / prof_steps:.3f} ms a "
              f"step in {ops / prof_steps:.0f} device operations "
              f"(torch.profiler, {prof_steps} steps) against "
              f"{step_s * 1e3:.3f} ms of wall time a step: the card is "
              f"busy {100 * dev_ms / prof_steps / (step_s * 1e3):.1f}% of "
              "the step")
    for model in trained:
        fused = "fused_adapt" if model == "fumi" else \
            "fused_maml_adapt_batched"
        print(f"train {model}: {train_eps[model]:.1f} episodes/s, with "
              f"--augment {train_eps[f'{model} --augment']:.1f}; eval "
              f"through {fused} "
              f"{eval_eps[(model, 'fused kernel')]:.1f} episodes/s, through "
              f"the autograd engine "
              f"{eval_eps[(model, 'autograd engine')]:.1f} episodes/s")
    print("driver wall time per run (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in driver_walls.items()))

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
        "launches_by_path": {p: c["fused_adapt"] for p, c in by_path.items()},
    }, {
        "name": "gather_rows", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/gather_rows.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:288",
        "launches": launches["gather_rows"], "max_abs_err": gather_err,
        "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": g_bound_ms,
        "bound_by": "bytes", "library_ms": g_lib_ms,
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
        "name": "fused_maml_adapt_batched", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/fused_adapt_batched.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:353",
        "launches": launches["fused_maml_adapt_batched"],
        "max_abs_err": batched_err, "ms": b_ms, "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms, "bound_by": bound_by, "library_ms": None,
        "launches_by_path": {p: c["fused_maml_adapt_batched"]
                             for p, c in by_path.items()},
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
