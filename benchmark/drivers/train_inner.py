"""Meta-training checked an inner step at a time: ``drivers/train.py``'s
set-up and window, with the first steps run under the program's
inner-step recorder (``fumi_tpu_torch.metalearn.inner_loop.recording``).

Set-up, the first steps (the window's own ``run(..., n=1)``), the window
and the trajectory check are ``drivers/train.py``'s, loaded through
``ctx.module`` and used unchanged: its ``run`` builds its ``Setup`` and
reads its ``readings`` by name, and this driver hands it a ``Setup`` whose
first steps run under the recorder and a ``readings`` that adds the inner
steps' numbers.

Why: five second-order steps through batch-stat norm and max-pool carry
any fp32 evaluation of the loss and gradient to the error that TF32
products make, so the trajectory alone cannot tell the program from its
TF32 control. One step from the program's own state can. For every inner
step of every task of the first outer step, the reference takes the
program's state θ_k and computes that step alone in IEEE fp32:

- ``inner_update_gap``: the worst leaf's norm gap between the program's
  θ_{k+1} − θ_k and the reference's step from θ_k (θ_k − α·∇ rounded to
  the state's type, minus θ_k), over max(leaf, median leaf)
  (``check.leaf_gaps``); the worst task and step;
- ``support_loss_gap``: the support loss at θ_k (summed over the tasks, as
  the program returns it), relative; the worst step;
- ``query_loss_gap``: the first step's outer loss against the reference's
  query loss at the program's θ_n (mean over the tasks), relative.

``calibrate`` gives the readings the limits are set from: the program,
the reference with TF32 products in the program's place (the control),
the reference in fp64 (the witness), half of each batch left out, and a
state left unchanged.

A program without the recorder fails at once, before any table is made.
"""

from __future__ import annotations

import json
import math
import sys
import traceback
from typing import Dict, List

import torch

from benchmark import check
from benchmark.reference.common import precision


def recorder():
    """The program's inner-step recorder; raises where the program has
    none, so that such a program fails before its tables are made."""
    from fumi_tpu_torch.metalearn import inner_loop
    recording = getattr(inner_loop, "recording", None)
    if recording is None:
        raise RuntimeError("fumi_tpu_torch.metalearn.inner_loop has no "
                           "recording(): the inner steps cannot be checked")
    return recording


def recorded_setup(base, recording):
    """``base.Setup`` whose first steps run under the recorder and keep
    the first outer step's record as ``prog["inner"]``."""

    class Setup(base.Setup):
        def first_steps(self, n: int) -> dict:
            with recording() as records:
                prog = super().first_steps(n)
            prog["inner"] = records[0]
            return prog
    return Setup


def program_steps(record, outer_loss: float, horizon: int) -> dict:
    """The program's inner steps from its record: the support losses, each
    task's update θ_{k+1} − θ_k in fp64, and the outer loss. Raises where
    the record holds another number of steps than ``horizon``, the
    configuration's."""
    if len(record.loss) != horizon or len(record.theta) != horizon + 1:
        raise ValueError(f"the program recorded {len(record.loss)} inner "
                         f"steps; the configuration states {horizon}")
    updates = []
    for k in range(len(record.loss)):
        before, after = record.theta[k], record.theta[k + 1]
        B = next(iter(before.values())).shape[0]
        updates.append([{key: after[key][b].double() - before[key][b].double()
                         for key in before} for b in range(B)])
    return {"support": [float(x) for x in record.loss], "updates": updates,
            "query": float(outer_loss)}


def reference_steps(ref, record, episode: dict, step_size: float, dtype,
                    tf32: bool = False) -> dict:
    """The reference's inner steps at the program's states, in ``dtype``
    (TF32 products where ``tf32``): at each θ_k of each task the support
    loss and the step θ_k − α·∇ in ``dtype``, as an fp64 change; at θ_n
    the query loss, mean over the tasks."""
    def task(theta, b):
        return {k: v[b].to(dtype) for k, v in theta.items()}

    s_x, q_x = episode["s_x"].to(dtype), episode["q_x"].to(dtype)
    B = s_x.shape[0]
    support, updates = [], []
    with precision(tf32):
        for theta in record.theta[:-1]:
            total, per_task = 0.0, []
            for b in range(B):
                th = task(theta, b)
                loss, step = ref.inner_step(th, s_x[b], episode["s_y"][b],
                                            step_size)
                total += float(loss)
                per_task.append({k: (th[k] + step[k]).double()
                                 - th[k].double() for k in th})
            support.append(total)
            updates.append(per_task)
        with torch.no_grad():
            query = sum(float(ref.task_loss(task(record.theta[-1], b),
                                            q_x[b], episode["q_y"][b]))
                        for b in range(B)) / B
    return {"support": support, "updates": updates, "query": query}


def _relative(p: float, r: float) -> float:
    gap = abs(p - r) / max(abs(r), 1e-30)
    return gap if math.isfinite(gap) else math.nan


def inner_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The inner steps' numbers, ``prog``'s steps against ``ref``'s."""
    if len(prog["updates"]) != len(ref["updates"]) or not ref["updates"]:
        return {"inner_update_gap": math.nan, "support_loss_gap": math.nan,
                "query_loss_gap": math.nan}
    updates: List[float] = []
    for p_k, r_k in zip(prog["updates"], ref["updates"]):
        for p_b, r_b in zip(p_k, r_k):
            updates.append(check.worst(check.leaf_gaps(p_b, r_b)))
    return {"inner_update_gap": check.worst(updates),
            "support_loss_gap": check.worst(
                [_relative(p, r) for p, r in zip(prog["support"],
                                                 ref["support"])]),
            "query_loss_gap": _relative(prog["query"], ref["query"])}


def readings_with_inner(base, trajectory_readings):
    """``base.readings`` and the inner steps' numbers."""

    def readings(ctx, setup, prog) -> Dict[str, float]:
        out = trajectory_readings(ctx, setup, prog)
        if not out:
            return out
        try:
            built, _, _ = base.reference_episodes(ctx, setup, prog)
            ref = reference_steps(ctx.reference, prog["inner"], built[0],
                                  float(ctx.config["train"]["step_size"]),
                                  ctx.reference_dtype)
            out.update(inner_gaps(program_steps(
                prog["inner"], prog["losses"][0],
                int(ctx.config["train"]["inner_steps"])), ref))
            return out
        except Exception:  # the check could not be made: correct is false
            traceback.print_exc()
            return {}
    return readings


def run(ctx) -> dict:
    base = ctx.module("drivers", "train")
    recording = recorder()
    base.readings = readings_with_inner(base, base.readings)
    base.Setup = recorded_setup(base, recording)
    return base.run(ctx)


def calibrate(ctx) -> dict:
    """The readings the limits are set from, for this seed: the program,
    the control (the reference with TF32 products, in the program's
    place), the fp64 witness, half of each batch left out (the trajectory
    alone: a task's inner steps do not see the others), and a state left
    unchanged (no update, no change). No window."""
    base = ctx.module("drivers", "train")
    recording = recorder()
    readings = readings_with_inner(base, base.readings)
    setup = recorded_setup(base, recording)(ctx)
    prog = setup.first_steps(int(ctx.workload["check"]["steps"]))
    setup.run = setup.family = setup.feed = setup.sampler = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    out = {"program": readings(ctx, setup, prog)}
    built, _, _ = base.reference_episodes(ctx, setup, prog)
    dtype = ctx.reference_dtype
    step = float(ctx.config["train"]["step_size"])
    record = prog["inner"]
    ref = base.follow_in(ctx, setup, built, prog["noises"], dtype)
    ref_in = reference_steps(ctx.reference, record, built[0], step, dtype)
    for side, kind, tf32 in (("control", torch.float32, True),
                             ("fp64_reference", torch.float64, False)):
        out[side] = check.trajectory(base.follow_in(
            ctx, setup, built, prog["noises"], kind, tf32=tf32), ref)
        out[side].update(inner_gaps(reference_steps(
            ctx.reference, record, built[0], step, kind, tf32=tf32), ref_in))
    half = [{k: v[:v.shape[0] // 2] for k, v in e.items()} for e in built]
    half_noises = [[d[:d.shape[0] // 2] if d.dim() == 3 else d
                    for d in ds] for ds in prog["noises"]]
    out["half_batch"] = check.trajectory(base.follow_in(
        ctx, setup, half, half_noises, dtype), ref)
    still = {"losses": ref["losses"], "grad1": ref["grad1"],
             "delta": {k: torch.zeros_like(v)
                       for k, v in ref["delta"].items()}}
    out["unchanged_state"] = check.trajectory(still, ref)
    out["unchanged_state"].update(inner_gaps(
        dict(ref_in, updates=[[{k: torch.zeros_like(v) for k, v in u.items()}
                               for u in per_task]
                              for per_task in ref_in["updates"]]), ref_in))
    print(json.dumps({"calibrate": ctx.cell, "seed": ctx.seed, **out}),
          file=sys.stderr, flush=True)
    return out
