"""Meta-training: ``train/steps.make_chunked_train`` on the device sampler.

Set-up builds one training object (the family with the benchmark's
weights, the optimizer and its state, the sampler over the split's
classes, the step generator seeded from the seed) and drives it through
its first steps with the window's own call (``run(..., n=1)``) and feed,
recording each episode the sampler hands out and the dropout noise the
step draws. The window then runs chunks of ``chunk`` steps on that same
object, each ending in a synchronisation, until ``--seconds`` have
passed. With ``--trace 0`` each chunk runs under the profiler (the
device's activity alone): ``train_device_ms_per_episode`` is the device's
busy time of every chunk of the window over every episode of it. With
``--trace 1`` the window runs unprofiled: ``wall_eps.train`` is every
episode of the window over its whole time on the host's clock.

``correct``: the plain reference follows the first steps from the same
weights, on episodes it gathers itself from the drawn rows, with the same
dropout noise, and Adam as ``torch.optim.Adam``. Compared: each step's
loss, the first gradient as Adam took it (worked out from the program's
first moment after one step), each leaf's change after the last step, and
the gathered episodes themselves.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from benchmark import check
from benchmark import trace as trace_lib
from benchmark.data import make_tables, widen
from benchmark.reference.common import Noise, follow, init_params, precision


class Feed:
    """The sampler as the chunked driver sees it; keeps the episodes it
    hands out while ``recording`` is a list."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.recording = None

    def sample(self, gen):
        episode = self.sampler.sample(gen)
        if self.recording is not None:
            self.recording.append(episode)
        return episode


class NoiseRecorder(TorchFunctionMode):
    """Keeps every ``torch.rand`` drawn from ``gen``, in order."""

    def __init__(self, gen):
        super().__init__()
        self.gen = gen
        self.draws: List[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.rand and kwargs.get("generator") is self.gen:
            self.draws.append(out.detach().clone())
        return out


def class_set(tables, split: str, text_of_class):
    """The program's ClassSet of ``split`` over the benchmark's layout."""
    from fumi_tpu_torch.data.class_set import ClassSet
    classes = tables.split_classes[split]
    b = tables.bounds
    counts = (b[classes + 1] - b[classes]).astype(np.int32)
    rows = np.zeros((len(classes), int(counts.max())), np.int32)
    for i, c in enumerate(classes):
        rows[i, :counts[i]] = np.arange(b[c], b[c + 1])
        rows[i, counts[i]:] = b[c]
    return ClassSet(categories=classes, class_image_rows=rows,
                    class_counts=counts, text_features=text_of_class)


class Setup:
    """The training object of a cell, built from the seed."""

    def __init__(self, ctx):
        from fumi_tpu_torch.core.episode import EpisodeSpec
        from fumi_tpu_torch.data.sampler import DeviceEpisodeSampler
        from fumi_tpu_torch.train.steps import (build_family,
                                                make_chunked_train,
                                                make_opt)
        ctx.mark("import")
        cfg, wl, dev = ctx.config, ctx.workload, ctx.device
        self.ctx = ctx
        self.tables = make_tables(cfg["data"], ctx.seed, dev)
        ctx.sync()
        ctx.mark("tables")
        self.params0 = init_params(ctx.reference.specs(cfg), ctx.seed, dev)
        self.ref_params0 = {k: v.clone() for k, v in self.params0.items()}
        ctx.sync()
        ctx.mark("weights")
        pcfg = ctx.program_config()
        split = wl["traffic"]["split"]
        ep = cfg["episode"]
        classes_t = torch.as_tensor(self.tables.split_classes[split],
                                    device=dev)
        cset = class_set(self.tables, split, self.tables.text[classes_t])
        spec = EpisodeSpec(
            batch_size=cfg["train"]["batch_size"], num_ways=ep["num_ways"],
            num_shots=ep["num_shots"], num_query=ep["num_query_train"],
            im_dim=int(cfg["data"]["row_shape"][0]),
            text_dim=int(cfg["data"]["text_dim"]))
        ids = np.arange(self.tables.image.shape[0], dtype=np.int32)
        self.sampler = DeviceEpisodeSampler(
            self.tables.image, ids, cset, spec,
            use_pallas_gather=bool(cfg["port"]["pallas_gather"]),
            device=dev)
        family = build_family(pcfg, torch.Generator().manual_seed(0))
        missing = set(family.params) ^ set(self.params0)
        if missing:
            raise KeyError(f"the program's leaves and the reference's differ: "
                           f"{sorted(missing)}")
        self.family = family._replace(params=self.params0)
        self.opt = make_opt(pcfg)
        self.feed = Feed(self.sampler)
        self.run = make_chunked_train(self.family, self.opt, self.feed,
                                      int(wl["traffic"]["chunk"]))
        self.gen = torch.Generator(device=dev).manual_seed(
            ctx.seed % (1 << 63))
        self.state = self.opt.init(self.params0)
        self.params = self.params0
        ctx.mark("program")

    def first_steps(self, n: int) -> dict:
        """The first ``n`` steps, one call of the window's ``run`` each,
        recorded; the program's readings of them."""
        episodes, noises, losses, grad1 = [], [], [], None
        b1 = float(self.ctx.config["train"]["adam_betas"][0])
        for t in range(n):
            self.feed.recording = []
            rec = NoiseRecorder(self.gen)
            with rec:
                self.params, self.state, self.gen, ms = self.run(
                    self.params, self.state, self.gen, n=1)
            episodes.append(self.feed.recording[0])
            noises.append(rec.draws)
            losses.append(ms["loss"][0])
            if t == 0:
                # Adam's first moment after one step is (1 - b1) times the
                # gradient it took
                grad1 = {k: v / (1.0 - b1)
                         for k, v in self.state["mu"].items()}
                self.ctx.sync()
                self.ctx.mark("first_call")
        self.feed.recording = None
        delta = {k: self.params[k] - self.ref_params0[k]
                 for k in self.params}
        return {"losses": [float(x) for x in losses], "grad1": grad1,
                "delta": delta, "episodes": episodes, "noises": noises}


def reference_episode(ctx, tables, episode, split: str):
    """The reference's own episode from the rows the program drew, and a
    count of what the draw broke: a support or query row outside its
    task's classes, a class twice, a row twice, labels other than
    class-major, a class outside the split."""
    ep = ctx.config["episode"]
    N, K, Q = ep["num_ways"], ep["num_shots"], ep["num_query_train"]
    s_ids = episode.support_ids.long().cpu().numpy()
    q_ids = episode.query_ids.long().cpu().numpy()
    B = s_ids.shape[0]
    row_class = tables.row_class()
    allowed = set(tables.split_classes[split].tolist())
    s_y = np.tile(np.repeat(np.arange(N), K), (B, 1))
    q_y = np.tile(np.repeat(np.arange(N), Q), (B, 1))
    bad = int((episode.support_y.cpu().numpy() != s_y).sum()
              + (episode.query_y.cpu().numpy() != q_y).sum())
    classes = np.zeros((B, N), np.int64)
    for b in range(B):
        for n in range(N):
            rows = np.concatenate([s_ids[b, n * K:(n + 1) * K],
                                   q_ids[b, n * Q:(n + 1) * Q]])
            cs = row_class[rows]
            classes[b, n] = cs[0]
            bad += int((cs != cs[0]).sum()) + (len(rows)
                                               - len(np.unique(rows)))
            bad += int(cs[0] not in allowed)
        bad += N - len(np.unique(classes[b]))
    dev = tables.image.device
    s_t = torch.as_tensor(s_ids, device=dev)
    q_t = torch.as_tensor(q_ids, device=dev)
    built = {"s_x": widen(tables.image[s_t]), "q_x": widen(tables.image[q_t]),
             "s_y": torch.as_tensor(s_y, device=dev),
             "q_y": torch.as_tensor(q_y, device=dev),
             "class_text": tables.text[torch.as_tensor(classes, device=dev)]}
    gap = max(float((episode.support_im - built["s_x"]).abs().max()),
              float((episode.query_im - built["q_x"]).abs().max()))
    return built, bad, gap


def follow_in(ctx, setup: Setup, built: List[dict], noises, dtype,
              tf32: bool = False) -> dict:
    """The reference's first steps in ``dtype`` (TF32 products where
    ``tf32``), from the benchmark's weights."""
    params = {k: v.to(dtype) for k, v in setup.ref_params0.items()}
    episodes = [{k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in e.items()} for e in built]
    with precision(tf32):
        return follow(ctx.reference, params, episodes,
                      [Noise(d) for d in noises], ctx.config["train"])


def reference_episodes(ctx, setup: Setup, prog: dict):
    split = ctx.workload["traffic"]["split"]
    built, bad, gap = [], 0, 0.0
    for episode in prog["episodes"]:
        b, n_bad, g = reference_episode(ctx, setup.tables, episode, split)
        built.append(b)
        bad, gap = bad + n_bad, max(gap, g)
    return built, bad, gap


def readings(ctx, setup: Setup, prog: dict) -> Dict[str, float]:
    """The check's numbers: the program's first steps against the
    reference's."""
    try:
        built, bad, gap = reference_episodes(ctx, setup, prog)
        ref = follow_in(ctx, setup, built, prog["noises"],
                        ctx.reference_dtype)
        out = check.trajectory(prog, ref)
        out.update(episode_gap=gap, episode_bad=float(bad))
        return out
    except Exception:  # the check could not be made: correct is false
        traceback.print_exc()
        return {}


def run(ctx) -> dict:
    wl = ctx.workload
    setup = Setup(ctx)
    prog = setup.first_steps(int(wl["check"]["steps"]))

    def chunk(n=None):
        kw = {} if n is None else {"n": n}
        return setup.run(setup.params, setup.state, setup.gen, **kw)

    # the device's clock reads the window of a --trace 0 run; the warm-up
    # runs under it too, so that the profiler's first start falls in set-up
    device_clock = ctx.cuda and not ctx.trace
    warm = int(wl["traffic"]["warm_steps"])
    if ctx.cuda:
        _, out = trace_lib.device_seconds(lambda: chunk(warm), ctx.sync)
    else:
        out = chunk(warm)
    setup.params, setup.state, setup.gen, _ = out
    ctx.sync()
    ctx.setup_done()
    B = int(ctx.config["train"]["batch_size"])
    losses, steps, device_s = [], 0, 0.0
    with ctx.window():
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        while time.perf_counter() < deadline:
            if device_clock:
                busy, out = trace_lib.device_seconds(chunk, ctx.sync)
                device_s += busy
            else:
                out = chunk()
                ctx.sync()
            setup.params, setup.state, setup.gen, ms = out
            losses.append(ms["loss"])
            steps += len(ms["loss"])
        window_s = time.perf_counter() - t_start
    bad_steps = int((~torch.isfinite(torch.cat(losses))).sum())
    trace = None
    n_trace = int(wl["trace"]["steps"])
    if ctx.trace:
        trace, _ = trace_lib.profiled(lambda: chunk(n_trace), ctx.sync)
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.cuda \
        else 0
    setup.run = setup.family = setup.feed = setup.sampler = None
    setup.state = setup.params = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    numbers = readings(ctx, setup, prog)
    return {"steps": steps, "episodes": steps * B, "window_s": window_s,
            "device_s": device_s if device_clock else None,
            "attempted": steps * B, "failed": bad_steps * B,
            "numbers": numbers, "memory_peak_bytes": peak, "trace": trace,
            "trace_steps": n_trace}


def calibrate(ctx) -> dict:
    """The readings the limits are set from, for this seed: the program
    (sound), the control (the reference in fp32 with TF32 products, in the
    program's place), the reference in fp64 (a witness of how far fp32
    itself lies from the exact function), and the
    reference with half of each batch left out (the mean over the rest).
    No window."""
    setup = Setup(ctx)
    prog = setup.first_steps(int(ctx.workload["check"]["steps"]))
    setup.run = setup.family = setup.feed = setup.sampler = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    out = {"program": readings(ctx, setup, prog)}
    built, _, _ = reference_episodes(ctx, setup, prog)
    dtype = ctx.reference_dtype
    ref = follow_in(ctx, setup, built, prog["noises"], dtype)
    out["control"] = check.trajectory(follow_in(
        ctx, setup, built, prog["noises"], torch.float32, tf32=True), ref)
    out["fp64_reference"] = check.trajectory(follow_in(
        ctx, setup, built, prog["noises"], torch.float64), ref)
    half = [{k: v[:v.shape[0] // 2] for k, v in e.items()} for e in built]
    # the dropout noise of a half batch is the first half of each draw
    half_noises = [[d[:d.shape[0] // 2] if d.dim() == 3 else d
                    for d in ds] for ds in prog["noises"]]
    out["half_batch"] = check.trajectory(follow_in(
        ctx, setup, half, half_noises, dtype), ref)
    print(json.dumps({"calibrate": ctx.cell, "seed": ctx.seed, **out}),
          file=sys.stderr, flush=True)
    return out
