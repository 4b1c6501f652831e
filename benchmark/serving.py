"""What the serving drivers share: set-up of the served classifier on the
benchmark's own tables and weights, the closed loop of one client, the
profiled stretch, and the check of the answers against the reference.

The client sends what a caller of ``FewShotClassifier.episode_logits``
sends: the support rows (N·K of them), their labels, the support rows'
class texts and the query rows, as host arrays. Latency is timed by the
client from the call to the logits in its hands.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark import check
from benchmark import trace as trace_lib
from benchmark.data import make_tables, widen
from benchmark.reference.common import init_params, precision
from benchmark.traffic import EpisodeTraffic, Request

SPAN = "bench.episode_logits"


class Serving:
    """The served classifier and its traffic, set up from the seed."""

    def __init__(self, ctx):
        from fumi_tpu_torch.serve import FewShotClassifier
        ctx.mark("import")
        cfg, wl, dev = ctx.config, ctx.workload, ctx.device
        self.ctx = ctx
        self.tables = make_tables(cfg["data"], ctx.seed, dev)
        ctx.sync()
        ctx.mark("tables")
        self.params = init_params(ctx.reference.specs(cfg), ctx.seed, dev)
        # the reference's own copy: the program is handed its weights
        self.ref_params = {k: v.clone() for k, v in self.params.items()}
        ctx.sync()
        ctx.mark("weights")
        self.clf = FewShotClassifier(ctx.program_config(), params=self.params,
                                     device=dev)
        ctx.mark("program")
        self.traffic = EpisodeTraffic(wl["traffic"], cfg["episode"],
                                      self.tables, ctx.seed)
        self.spans: List[float] = []

    def arrays(self, req: Request) -> Dict[str, np.ndarray]:
        """What the client sends for ``req``, on the host."""
        t = self.tables
        s_rows = torch.as_tensor(req.support_rows, device=t.image.device)
        q_rows = torch.as_tensor(req.query_rows, device=t.image.device)
        k = len(req.support_rows) // len(req.classes)
        text = t.text[torch.as_tensor(np.repeat(req.classes, k),
                                      device=t.image.device)]
        return {"support_im": widen(t.image[s_rows]).cpu().numpy(),
                "support_y": req.support_y,
                "query_im": widen(t.image[q_rows]).cpu().numpy(),
                "support_text": text.cpu().numpy()}

    def warm_requests(self) -> List[Request]:
        """One request of each query count the traffic sends, from a
        stream of its own (the window's stream is left as it is)."""
        stream = EpisodeTraffic(self.ctx.workload["traffic"],
                                self.ctx.config["episode"], self.tables,
                                self.ctx.seed + 1)
        return [stream.draw(i, m) for i, m in enumerate(stream.sizes)]

    def wrap_spans(self) -> None:
        """Time each ``episode_logits`` of the served instance on the host,
        inside a profiler range of its own."""
        inner = self.clf.episode_logits
        spans = self.spans

        def timed(*args, **kwargs):
            with torch.profiler.record_function(SPAN):
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                spans.append(time.perf_counter() - t0)
            return out
        self.clf.episode_logits = timed


def closed_loop(seconds: float, nxt: Callable[[], object],
                call: Callable[[object], object]) -> (List[dict], float):
    """One client sending ``nxt()``'s requests back to back for
    ``seconds``; returns each request's record and the window's length
    (its start to the last answer)."""
    records = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        req, payload = nxt()
        t0 = time.perf_counter()
        try:
            out, ok = call(payload), True
        except Exception as e:  # the request failed: it is counted
            out, ok = repr(e), False
        t1 = time.perf_counter()
        records.append({"req": req, "ms": 1e3 * (t1 - t0), "out": out,
                        "ok": ok, "t1": t1})
    end = records[-1]["t1"] if records else time.perf_counter()
    return records, end - t_start


def profiled_requests(ctx, payloads: List[tuple], call) -> tuple:
    """The profiled stretch: these requests back to back."""
    def body():
        return [(req, call(p)) for req, p in payloads]
    return trace_lib.profiled(body, ctx.sync)


def reference_logits(ctx, tables, params, reqs: List[Request],
                     dtype: torch.dtype, tf32: bool = False
                     ) -> List[torch.Tensor]:
    """The plain reference's logits for ``reqs`` in ``dtype`` (TF32 products
    where ``tf32``), in blocks of requests."""
    ref, cfg = ctx.reference, ctx.config
    p = {k: v.to(dtype) for k, v in params.items()}
    out = []
    for i in range(0, len(reqs), 32):
        block = reqs[i:i + 32]
        mmax = max(r.m for r in block)
        dev = tables.image.device
        s_rows = torch.as_tensor(np.stack([r.support_rows for r in block]),
                                 device=dev)
        q_rows = torch.as_tensor(np.stack([np.pad(
            r.query_rows, (0, mmax - r.m), mode="edge") for r in block]),
            device=dev)
        s_y = torch.as_tensor(np.stack([r.support_y for r in block]),
                              device=dev)
        classes = torch.as_tensor(np.stack([r.classes for r in block]),
                                  device=dev)
        with precision(tf32):
            logits = ref.serve_logits(
                p, widen(tables.image[s_rows]).to(dtype), s_y,
                widen(tables.image[q_rows]).to(dtype),
                tables.text[classes].to(dtype),
                int(cfg["serve"]["test_adapt_steps"]),
                float(cfg["serve"]["step_size"]))
        out += [logits[j, :r.m].cpu() for j, r in enumerate(block)]
    return out


def sample(records: List[dict], size: int, seed: int) -> List[dict]:
    """The answered requests to check: ``size`` drawn from the seed, and
    one with the most queries where the draw holds none."""
    answered = [r for r in records if r["ok"]]
    if not answered:
        return []
    rng = np.random.default_rng(seed + 7)
    picked = set(rng.choice(len(answered), min(size, len(answered)),
                            replace=False).tolist())
    longest = max(r["req"].m for r in answered)
    if all(answered[i]["req"].m < longest for i in picked):
        picked.add(next(i for i, r in enumerate(answered)
                        if r["req"].m == longest))
    return [answered[i] for i in sorted(picked)]


def gaps(answers: List[torch.Tensor], refs: List[torch.Tensor],
         off_gap: float) -> dict:
    """Each answer's logit gap against its reference, summed up: the
    median answer's, and the share of answers whose gap is over
    ``off_gap``."""
    per = [check.logit_gap(torch.as_tensor(np.asarray(a)), r)
           for a, r in zip(answers, refs)]
    if not per or any(math.isnan(g) for g in per):
        return {"logit_gap_median": math.nan, "off_share": math.nan,
                "per_answer": per}
    return {"logit_gap_median": statistics.median(per),
            "off_share": sum(g > off_gap for g in per) / len(per),
            "per_answer": per}


def check_answers(ctx, serving: Serving, records: List[dict]
                  ) -> Dict[str, float]:
    """The answers to a sample of the window's requests against the
    reference's logits."""
    chk = ctx.workload["check"]
    picked = sample(records, int(chk["sample"]), ctx.seed)
    refs = reference_logits(ctx, serving.tables, serving.ref_params,
                            [r["req"] for r in picked], ctx.reference_dtype)
    out = gaps([r["out"] for r in picked], refs, float(chk["off_gap"]))
    out.pop("per_answer")
    out["failed_answers"] = float(sum(not r["ok"] for r in records))
    return out


# gaps at which calibration reads the share of answers over them
CALIBRATION_GAPS = (1e-4, 1e-3, 1e-2, 3e-2, 4e-2, 5e-2, 6e-2, 1e-1, 3e-1)


def calibration(ctx, serving: Serving, records: List[dict]) -> dict:
    """This seed's readings for the limits, on the answers the check
    samples: the program's answers against the reference, the control's
    (the reference in fp32 with TF32 products, in the program's place)
    and, as a witness of how far fp32 itself lies from the exact
    function, the reference in fp64's. Besides the compared numbers, the
    deciles of the per-answer gaps and the share of answers over each of
    ``CALIBRATION_GAPS``."""
    chk = ctx.workload["check"]
    picked = sample(records, int(chk["sample"]), ctx.seed)
    reqs = [r["req"] for r in picked]

    def ref(dtype, tf32=False):
        return reference_logits(ctx, serving.tables, serving.ref_params,
                                reqs, dtype, tf32)
    refs = ref(ctx.reference_dtype)
    out = {}
    for side, got in (("program", [r["out"] for r in picked]),
                      ("control", ref(torch.float32, tf32=True)),
                      ("fp64_reference", ref(torch.float64))):
        g = gaps(got, refs, float(chk["off_gap"]))
        per = g.pop("per_answer")
        g["deciles"] = statistics.quantiles(per, n=10) if len(per) > 1 \
            else per
        g["shares"] = {f"{t:g}": sum(x > t for x in per) / len(per)
                       for t in CALIBRATION_GAPS}
        out[side] = g
    print(json.dumps({"calibrate": ctx.cell, "seed": ctx.seed,
                      "answers": len(picked), **out}),
          file=sys.stderr, flush=True)
    return out


def memory_peak(ctx) -> int:
    return int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.cuda else 0
