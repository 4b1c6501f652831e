#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fumi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it
fails:

1. the card: name and power limit from ``nvidia-smi``;
2. build every CUDA kernel of the serving path from ``fumi_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the flagship serving path gives it, with TF32 off;
4. drive the serving path (``FewShotClassifier``) at the flagship width
   (FuMI, BERT text 768, image 2048, im_hid (256, 64), 5-way 5-shot,
   100-step adaptation) with seeded random weights, then MAML; check the
   answers against the same classifier's autograd engine, and that the
   path launched every kernel (counts set to 0 just before, read after);
5. time each kernel and its plain version with CUDA events, and FuMI
   requests through the kernel and through the autograd engine on the
   host clock;
6. print the ``kernels`` JSON line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

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
    from fumi_tpu_torch.ops import _build, kernels
    from fumi_tpu_torch.serve import FewShotClassifier

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
    _build.build_all(["fused_adapt"])
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
    kernels.fused_adapt.launches = 0  # counts of the main path only
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
    launches = kernels.fused_adapt.launches
    print(f"main path: fused_adapt launched {launches} times")
    if launches == 0:
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

    # ---- 5. times ------------------------------------------------------
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

    # ---- 6. result ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_adapt", "route": "cuda",
        "source": "fumi_tpu_torch/csrc/fused_adapt.cu",
        "replaces": "fumi_tpu/ops/pallas_kernels.py:113",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
