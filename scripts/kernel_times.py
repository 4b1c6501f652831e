#!/usr/bin/env python3
"""Each CUDA kernel of the port alone on the card, beside its plain
PyTorch version, the one library call that computes the same function
where there is one, and its bound.

    python3 scripts/kernel_times.py

Prints the card's name and power limit, ``ptxas``'s registers and spills
of each kernel this process builds (none where ``fumi_tpu_torch/build/``
already holds them), the fused adaptation kernel's cluster plan at the
flagship shapes, then one line per kernel and shape: the device time of
one call, from CUDA graphs of repeated calls so the host's dispatch stays
out, the median over turns that go kernel, plain, library and back, twice.
The shapes are those of ``PERF.md`` §6's table, at the widths of the
benchmark's cells, read from ``benchmark/configs`` and
``benchmark/workloads``:

- ``fused_adapt``: B=4 at the flagship widths (S=25, Qn=100, D=2048,
  H=(256, 64), N=5, 100 steps), and a served request, R=1 with its
  queries in the bucket of 128; ``fused_maml_adapt_batched`` at B=4;
- ``gather_rows``: the train step's query rows (M=640) and support rows
  (M=100) of a 4096 x 2048 fp32 table (32 MiB, in the 50 MB L2 as it stays
  there while training); ``augment_embeddings`` and
  ``gather_augment_rows`` at M=100;
- ``gather_episode_rows``: the train (5+32 a class) and eval (5+20)
  episodes of that table, each also jittered; the table in bf16; raw rows
  of 84·84·3 in fp32, bf16 and uint8 (4096 of them, past the L2);
- ``norm_relu_pool``: its forward, backward and double backward at
  ``conv4.train``'s eight shapes, and its leaky forms' (``norm_leaky_relu``,
  ``norm_residual_pool``) at ``resnet12.train``'s eight (no plain version
  there: its fp64 sums of those activations take gigabytes);
- ``conv3x3``: its fprop, dgrad and wgrad at ``conv4.train``'s eight call
  shapes (block 0's images take no dgrad), beside cuDNN's ``F.conv2d``
  and its gradients, the library yardstick; and at ``resnet12.train``'s
  sixteen 3×3 call shapes (each stage's first and second unit at the
  support set and the queries), beside cuDNN (no plain version).

The bounds are the least time of ``benchmark/costs/peaks.py:least_seconds``
on the work ``benchmark/costs/kernels.py`` counts, the counts the
benchmark's roofline readers use; ``norm_relu_pool``'s bytes, which
``benchmark/costs`` does not count, are :data:`NRP_PASS_BYTES` here (and
:data:`NRP_LEAKY_PASS_BYTES`, :data:`NRP_RESIDUAL_PASS_BYTES`);
``conv3x3``'s are the call's products, ``benchmark/costs/maml.py``'s
``conv_units`` and ``benchmark/costs/maml_resnet12.py``'s
``conv_layers``, at the fp32 peak.

A subset runs by importing the per-kernel functions, for example

    python3 -c 'import sys; sys.path.insert(0, "scripts"); import kernel_times as t; t.conv3x3_times(t.setup())'

Needs one CUDA card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from benchmark.costs.kernels import (  # noqa: E402
    fused_adapt_cost, gather_bytes, widen_bytes)
from benchmark.costs.maml import conv_units  # noqa: E402
from benchmark.costs.maml_resnet12 import conv_layers  # noqa: E402
from benchmark.costs.peaks import PEAK_BYTES_PER_S, least_seconds  # noqa: E402
from fumi_tpu_torch.core.config import Config  # noqa: E402


def _bench_json(*parts):
    with open(os.path.join(HERE, "benchmark", *parts)) as f:
        return json.load(f)


# the widths of the benchmark's cells: fumi.serve and fumi.train run
# fumi-inat-anim, conv4.train runs maml-conv4-inat-anim, resnet12.train
# maml-resnet12-inat-anim
FUMI = _bench_json("configs", "fumi-inat-anim.json")
CONV4 = _bench_json("configs", "maml-conv4-inat-anim.json")
RESNET12 = _bench_json("configs", "maml-resnet12-inat-anim.json")
B, WAYS = FUMI["train"]["batch_size"], FUMI["episode"]["num_ways"]
SHOTS = FUMI["episode"]["num_shots"]
TRAIN_Q = FUMI["episode"]["num_query_train"]
EVAL_Q = Config(num_ways=WAYS).num_query_eval
S, QN = WAYS * SHOTS, WAYS * EVAL_Q
D = FUMI["widths"]["im_emb_dim"]
H1, H2 = FUMI["widths"]["im_hid_dim"]
STEPS, STEP_SIZE = (FUMI["serve"]["test_adapt_steps"],
                    FUMI["serve"]["step_size"])
# a served request's queries, padded to a power of two as serve.py pads them
SERVED_M = 1 << (max(_bench_json("workloads", "fumi.serve.json")[
    "traffic"]["queries"]) - 1).bit_length()
RAW_ROW = CONV4["widths"]["im_size"] ** 2 * CONV4["widths"]["im_channels"]
# the timing's own choices: table rows (a 32 MiB fp32 table stays in the
# 50 MB L2 as it does while training), the jitter's scale
TABLE_ROWS, AUG_SCALE = 4096, 0.1
SOURCES = ("fused_adapt", "gather_rows", "augment_embeddings",
           "norm_relu_pool", "conv3x3")
# conv4.train's norm_relu_pool calls (M images, G channels, side): the
# support set or the queries of each task, the tasks' channels side by
# side, each block's input side
NRP_SHAPES = tuple(
    (m, CONV4["train"]["batch_size"] * CONV4["widths"]["hidden"],
     CONV4["widths"]["im_size"] >> k)
    for m in (CONV4["episode"]["num_ways"] * CONV4["episode"]["num_shots"],
              CONV4["episode"]["num_ways"]
              * CONV4["episode"]["num_query_train"])
    for k in range(CONV4["widths"]["blocks"]))
# conv4.train's convolution calls (M images, groups, C_in a group, side):
# each block at the support set and at the queries, the tasks as groups
CONV_SHAPES = tuple(
    (m, CONV4["train"]["batch_size"],
     CONV4["widths"]["hidden"] if k else CONV4["widths"]["im_channels"],
     CONV4["widths"]["im_size"] >> k)
    for m in (CONV4["episode"]["num_ways"] * CONV4["episode"]["num_shots"],
              CONV4["episode"]["num_ways"]
              * CONV4["episode"]["num_query_train"])
    for k in range(CONV4["widths"]["blocks"]))
# resnet12.train's 3x3 convolution calls (M images, groups, C_in and C_out a
# group, side): each stage's first unit (C_in -> C_out) and second (C_out
# -> C_out, as the third), at the support set and at the queries
RESNET12_CONV_SHAPES = tuple(
    (m, RESNET12["train"]["batch_size"], cin, cout, side)
    for m in (RESNET12["episode"]["num_ways"]
              * RESNET12["episode"]["num_shots"],
              RESNET12["episode"]["num_ways"]
              * RESNET12["episode"]["num_query_train"])
    for _, unit, side, cin, cout, k, _ in conv_layers(RESNET12)
    if k == 3 and unit in ("c1", "c2"))
# resnet12.train's norm_relu_pool calls of the leaky forms (M images, G
# channels, side): the support set or the queries, the tasks' channels side
# by side, each stage's side (its units c1, c2 and c3 with the shortcut)
RESNET12_NRP_SHAPES = tuple(
    (m, RESNET12["train"]["batch_size"] * c,
     RESNET12["widths"]["im_size"] >> k)
    for m in (RESNET12["episode"]["num_ways"]
              * RESNET12["episode"]["num_shots"],
              RESNET12["episode"]["num_ways"]
              * RESNET12["episode"]["num_query_train"])
    for k, c in enumerate(RESNET12["widths"]["channels"]))
# bytes a pass must move, in units of the activation's bytes (4 M H W G):
# the forward reads z twice and writes a quarter; the backward reads z and
# g_out twice and writes g_z; the double backward reads z, v_z and g_out
# twice and writes c_z and c_gout (csrc/norm_relu_pool.cu's note)
NRP_PASS_BYTES = {"forward": 2.25, "backward": 3.5, "double_backward": 5.75}
# the same for the leaky form without the pool (an output as large as z)
NRP_LEAKY_PASS_BYTES = {"forward": 3.0, "backward": 5.0,
                        "double_backward": 8.0}
# and for the residual form, two branches z and z_sc read (and their
# gradients written) beside a pooled output
NRP_RESIDUAL_PASS_BYTES = {"forward": 4.25, "backward": 6.5,
                           "double_backward": 10.75}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fns, replays: int = 5) -> float:
    """Median device milliseconds of one call in ``fns``: the calls are
    captured once into a CUDA graph and replayed."""
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
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def in_turns(calls) -> dict:
    """{route: median ms} of ``calls`` ({route: [fn, ...]}), each route
    timed four times in the order given, then reversed, twice."""
    order = list(calls) + list(reversed(calls))
    turns = {}
    for route in order + order:
        turns.setdefault(route, []).append(graph_ms(calls[route]))
    return {route: statistics.median(t) for route, t in turns.items()}


def report(label: str, ms: dict, bound_s: float) -> None:
    """Print one line: each route's time and the kernel's share of its
    bound."""
    unit, scale = ("us", 1e3) if ms["kernel"] < 0.1 else ("ms", 1.0)
    routes = ", ".join(f"{route} {t * scale:.3f} {unit}"
                       for route, t in ms.items())
    print(f"{label}: {routes}; bound {1e3 * bound_s * scale:.4f} {unit} "
          f"({1e5 * bound_s / ms['kernel']:.1f}% of it)", flush=True)


def setup():
    """Build the kernels, turn TF32 off, print the card, the ptxas report
    and the fused kernel's plans; returns the card's device."""
    import torch
    from fumi_tpu_torch.ops import _build, kernels
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA GPU")
    print(f"card: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    _build.build_all(SOURCES)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    optin, max_cluster = kernels.card_limits(dev.index)
    print(f"fused_adapt card limits: {optin} B of shared memory a block, "
          f"clusters of up to {max_cluster} blocks")
    for label, b, qn in ((f"B={B}", B, QN),
                         (f"R=1 M={SERVED_M}", 1, SERVED_M)):
        plan = kernels.device_plan(dev.index, (b, S, qn, D, H1, H2, WAYS))
        print(f"fused_adapt plan [{label}]: {plan}; "
              f"{kernels.active_clusters(dev.index, plan.C, plan.smem_bytes)}"
              f" such clusters at once", flush=True)
    return dev


def fused_adapt_times(dev) -> None:
    """``fused_adapt`` at B=4 and at a served request (R=1, M=128),
    ``fused_maml_adapt_batched`` at B=4, each beside its plain loop; no
    single PyTorch call computes these functions."""
    import torch
    from fumi_tpu_torch.models import mlp
    from fumi_tpu_torch.ops import kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.to(dev) for k, v in mlp.init(
        torch.Generator().manual_seed(0), D, WAYS, (H1, H2)).items()}
    w = (p["net.lin_0.weight"], p["net.lin_0.bias"], p["net.lin_1.weight"],
         p["net.lin_1.bias"])
    head_w = 0.3 * torch.randn((B, WAYS, H2), generator=gen, device=dev)
    head_b = 0.3 * torch.randn((B, 1, WAYS), generator=gen, device=dev)
    sx = torch.randn((B, S, D), generator=gen, device=dev)
    sy = torch.arange(WAYS, device=dev, dtype=torch.int32).repeat_interleave(
        SHOTS).repeat(B, 1)
    qx = torch.randn((B, max(QN, SERVED_M), D), generator=gen, device=dev)
    for label, b, qn in ((f"B={B}", B, QN),
                         (f"R=1 M={SERVED_M}", 1, SERVED_M)):
        args = w + (head_w[:b], head_b[:b], sx[:b], sy[:b],
                    qx[:b, :qn].contiguous(), STEPS, STEP_SIZE)
        ms = in_turns({
            "kernel": [lambda: kernels.fused_adapt(*args)] * 10,
            "plain": [lambda: kernels.fused_adapt_reference(*args)] * 3})
        report(f"fused_adapt {label}", ms, least_seconds(*fused_adapt_cost(
                b, S, qn, D, H1, H2, WAYS, STEPS)))
    q = qx[:, :QN].contiguous()
    ms = in_turns({
        "kernel": [lambda: kernels.fused_maml_adapt_batched(
            p, sx, sy, q, STEPS, STEP_SIZE)] * 10,
        "plain": [lambda: kernels.fused_maml_adapt_batched_reference(
            p, sx, sy, q, STEPS, STEP_SIZE)] * 3})
    report(f"fused_maml_adapt_batched B={B}", ms, least_seconds(
        *fused_adapt_cost(B, S, QN, D, H1, H2, WAYS, STEPS)))


def _index_sets(dev, rows: int, shape, n: int = 100):
    """``n`` int32 index tensors of ``shape`` into ``rows`` rows, as n
    episodes draw them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + rows)
    return [torch.randint(0, rows, shape, generator=gen, dtype=torch.int32,
                          device=dev) for _ in range(n)]


def _seeds(dev, n: int = 100):
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    return [torch.randint(0, 2 ** 62, (1,), generator=gen, dtype=torch.int64,
                          device=dev) for _ in range(n)]


def gather_times(dev) -> None:
    """``gather_rows`` at M=640 and M=100 beside ``index_select``;
    ``augment_embeddings`` and ``gather_augment_rows`` at M=100."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    table = torch.randn((TABLE_ROWS, D), device=dev)
    for m in (B * WAYS * TRAIN_Q, B * S):
        idx = _index_sets(dev, TABLE_ROWS, (m,))
        ms = in_turns({
            "kernel": [lambda i=i: K.gather_rows(table, i) for i in idx],
            "plain": [lambda i=i: K.gather_rows_reference(table, i)
                      for i in idx],
            "index_select": [lambda i=i.long(): torch.index_select(
                table, 0, i) for i in idx]})
        report(f"gather_rows M={m} D={D} fp32", ms,
               least_seconds(0, gather_bytes(m, 4 * D)))
    m = B * S
    idx, seeds = _index_sets(dev, TABLE_ROWS, (m,)), _seeds(dev)
    x = torch.randn((m, D), device=dev)
    # the standalone jitter reads and writes the rows a gather moves, less
    # the indices (400 bytes of 1.64 MB): a gather's count bounds it
    ms = in_turns({
        "kernel": [lambda s=s: K.augment_embeddings(x, s, AUG_SCALE)
                   for s in seeds],
        "plain": [lambda s=s: K.augment_embeddings_reference(x, s, AUG_SCALE)
                  for s in seeds]})
    report(f"augment_embeddings M={m} D={D}", ms,
           least_seconds(0, gather_bytes(m, 4 * D)))
    ms = in_turns({
        "kernel": [lambda i=i, s=s: K.gather_augment_rows(
            table, i, s, AUG_SCALE) for i, s in zip(idx, seeds)],
        "plain": [lambda i=i, s=s: K.gather_augment_rows_reference(
            table, i, s, AUG_SCALE) for i, s in zip(idx, seeds)]})
    report(f"gather_augment_rows M={m} D={D} fp32", ms,
           least_seconds(0, widen_bytes(m, D, 4)))


def episode_times(dev) -> None:
    """``gather_episode_rows`` at the train and eval episodes, beside one
    ``index_select`` over the episode's rows (which does not widen)."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=dev).manual_seed(11)
    table = torch.randn((TABLE_ROWS, D), generator=gen, device=dev)
    raw = torch.rand((TABLE_ROWS, RAW_ROW), generator=gen, device=dev)
    u8 = torch.randint(0, 256, raw.shape, generator=gen, dtype=torch.uint8,
                       device=dev)
    # (label, table, queries a class, jittered)
    cases = [("train", table, TRAIN_Q, False),
             ("train jittered", table, TRAIN_Q, True),
             ("eval", table, EVAL_Q, False),
             ("eval jittered", table, EVAL_Q, True),
             ("bf16 train", table.to(torch.bfloat16), TRAIN_Q, False),
             ("bf16 eval", table.to(torch.bfloat16), EVAL_Q, False),
             ("raw fp32 train", raw, TRAIN_Q, False),
             ("raw bf16 train", raw.to(torch.bfloat16), TRAIN_Q, False),
             ("raw uint8 train", u8, TRAIN_Q, False)]
    seeds = _seeds(dev)
    for label, t, q, jit in cases:
        rows = _index_sets(dev, TABLE_ROWS, (B, WAYS, SHOTS + q))
        kw = [dict(seed=s, scale=AUG_SCALE) if jit else {} for s in seeds]
        ms = in_turns({
            "kernel": [lambda r=r, k=k: K.gather_episode_rows(
                t, r, SHOTS, **k) for r, k in zip(rows, kw)],
            "plain": [lambda r=r, k=k: K.gather_episode_rows_reference(
                t, r, SHOTS, **k) for r, k in zip(rows, kw)],
            "index_select": [lambda i=r.reshape(-1).long(): torch.index_select(
                t, 0, i) for r in rows]})
        m = B * WAYS * (SHOTS + q)
        report(f"gather_episode_rows {label} (M={m} rows of {t.shape[1]} "
               f"{str(t.dtype).removeprefix('torch.')})", ms,
               least_seconds(0, widen_bytes(m, t.shape[1], t.element_size())))


def _nrp_calls(dev, form, M, G, side):
    """The forward, backward and double backward of ``form`` at one shape
    on random inputs, each as (kernel, plain) callables."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=dev).manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    t, cots = [], []
    for _ in range(form.branches):
        t += [r(M, side, side, G).permute(0, 3, 1, 2),  # channels_last
              r(G), 1.0 + 0.3 * r(G), 0.2 * r(G)]
        cots += [r(M, side, side, G).permute(0, 3, 1, 2), None, r(G), r(G)]
    out, stats = K._nrp_forward(form, t)
    g_out = torch.randn_like(out)
    sums = K._nrp_backward(form, t, stats, g_out)[1]
    return {
        "forward": (lambda: K._nrp_forward(form, t),
                    lambda: K.norm_relu_pool_forward_reference(form, t)),
        "backward": (lambda: K._nrp_backward(form, t, stats, g_out),
                     lambda: K.norm_relu_pool_backward_reference(
                         form, t, stats, g_out)),
        "double_backward": (
            lambda: K._nrp_double_backward(form, t, stats, g_out, sums,
                                           cots),
            lambda: K.norm_relu_pool_double_backward_reference(
                form, t, stats, g_out, sums, cots))}


def norm_relu_pool_times(dev) -> None:
    """``norm_relu_pool``'s three passes at ``conv4.train``'s shapes, five
    calls a graph, beside the plain versions (two a graph); its leaky
    forms' at ``resnet12.train``'s, the kernels alone."""
    import torch
    from fumi_tpu_torch.ops import kernels as K
    cases = [("norm_relu_pool", K.RELU_POOL, NRP_SHAPES, NRP_PASS_BYTES,
              True),
             ("norm_leaky_relu", K.LEAKY, RESNET12_NRP_SHAPES,
              NRP_LEAKY_PASS_BYTES, False),
             ("norm_residual_pool", K.LEAKY_SUM_POOL, RESNET12_NRP_SHAPES,
              NRP_RESIDUAL_PASS_BYTES, False)]
    for label, form, shapes, pass_bytes, plain in cases:
        for M, G, side in shapes:
            for name, (kernel, reference) in _nrp_calls(
                    dev, form, M, G, side).items():
                routes = {"kernel": [kernel] * 5}
                if plain:
                    routes["plain"] = [reference] * 2
                nbytes = pass_bytes[name] * 4 * M * side * side * G
                report(f"{label} {name} M={M} G={G} {side}x{side}",
                       in_turns(routes), nbytes / PEAK_BYTES_PER_S)
            torch.cuda.empty_cache()


def conv3x3_times(dev) -> None:
    """``conv3x3``'s entry points at ``conv4.train``'s and
    ``resnet12.train``'s call shapes, five calls a graph, beside cuDNN's
    ``F.conv2d`` and its input or weight gradient
    (``aten::convolution_backward``, five a graph) and, at conv4's, the
    plain versions (two a graph; at ResNet-12's widths their windows take
    gigabytes); the bound is the call's products at the fp32 peak, the
    layer's operations for one image (``conv_units``, ``conv_layers``)
    times its images and groups."""
    import torch
    import torch.nn.functional as F
    from fumi_tpu_torch.ops import kernels as K
    units = conv_units(CONV4)[0]
    hidden = CONV4["widths"]["hidden"]
    ops = {(side, cin, cout): n for _, _, side, cin, cout, k, n
           in conv_layers(RESNET12) if k == 3}
    calls = [("", M, G, cin, hidden, side,
              units[CONV4["widths"]["im_size"].bit_length()
                    - side.bit_length()], True)
             for M, G, cin, side in CONV_SHAPES]
    calls += [("resnet12 ", M, G, cin, cout, side, ops[(side, cin, cout)],
               False) for M, G, cin, cout, side in RESNET12_CONV_SHAPES]
    for label, M, G, cin, cout, side, per_image, plain in calls:
        gen = torch.Generator(device=dev).manual_seed(5)

        def nhwc(c):
            return torch.randn((M, side, side, G * c), generator=gen,
                               device=dev).permute(0, 3, 1, 2)
        x, gy = nhwc(cin), nhwc(cout)
        w = torch.randn((G * cout, cin, 3, 3), generator=gen, device=dev)

        def library(mask):
            return lambda: torch.ops.aten.convolution_backward(
                gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], G,
                mask)
        passes = {
            "fprop": (lambda: K.conv3x3_fprop(x, w, G),
                      lambda: K.conv3x3_fprop_reference(x, w, G),
                      lambda: F.conv2d(x, w, padding=1, groups=G)),
            "dgrad": (lambda: K.conv3x3_dgrad(gy, w, G),
                      lambda: K.conv3x3_dgrad_reference(gy, w, G),
                      library([True, False, False])),
            "wgrad": (lambda: K.conv3x3_wgrad(x, gy, G),
                      lambda: K.conv3x3_wgrad_reference(x, gy, G),
                      library([False, True, False]))}
        for name, (kernel, reference, cudnn) in passes.items():
            if name == "dgrad" and cin <= 3:  # the images take no dgrad
                continue
            routes = {"kernel": [kernel] * 5}
            if plain:
                routes["plain"] = [reference] * 2
            routes["cudnn"] = [cudnn] * 5
            shape = f"C_in={cin}" + ("" if plain else f" C_out={cout}")
            report(f"conv3x3 {label}{name} M={M} G={G} {shape} "
                   f"{side}x{side}", in_turns(routes),
                   least_seconds(per_image * M * G, 0))
        del x, gy, w
        torch.cuda.empty_cache()


def main() -> int:
    dev = setup()
    for part in (fused_adapt_times, gather_times, episode_times,
                 norm_relu_pool_times, conv3x3_times):
        part(dev)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
