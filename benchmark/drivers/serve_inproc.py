"""Serving in process: one client calls ``FewShotClassifier.episode_logits``
back to back (a closed loop), each request one episode (R=1).

Set-up makes the tables and weights, builds the classifier, and warms
every query count the traffic sends. The window sends requests until
``--seconds`` have passed; every request's latency is timed by the
client, from the call to the logits on the host. A traced run follows the
window with a profiled stretch of ``trace.requests`` requests. ``correct``:
the answers to a sample of the window's requests, drawn from the seed
with one of the longest among them, against the plain reference's
logits.
"""

from __future__ import annotations

import torch

from benchmark import serving


def _call(s):
    def call(a):
        return s.clf.episode_logits(a["support_im"], a["support_y"],
                                    a["query_im"],
                                    support_text=a["support_text"])
    return call


def run(ctx) -> dict:
    s = serving.Serving(ctx)
    if ctx.trace:
        s.wrap_spans()
    call = _call(s)
    for i in range(2):
        for r in s.warm_requests():
            call(s.arrays(r))
            if "first_call" not in ctx.parts:
                ctx.mark("first_call")
    ctx.setup_done()
    s.spans.clear()

    def nxt():
        r = s.traffic.next()
        return r, s.arrays(r)
    with ctx.window():
        records, window_s = serving.closed_loop(ctx.seconds, nxt, call)
    out = {"requests": records, "window_s": window_s,
           "window_spans": list(s.spans), "trace": None,
           "attempted": len(records),
           "failed": sum(not r["ok"] for r in records)}
    if ctx.trace:
        payloads = [nxt() for _ in range(int(ctx.workload["trace"]
                                             ["requests"]))]
        s.spans.clear()
        out["trace"], _ = serving.profiled_requests(ctx, payloads, call)
        out["trace_spans"] = list(s.spans)
        out["trace_queries"] = [r.m for r, _ in payloads]
    out["memory_peak_bytes"] = serving.memory_peak(ctx)
    s.clf = call = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    out["numbers"] = serving.check_answers(ctx, s, records)
    return out


def calibrate(ctx) -> dict:
    """This seed's readings: the program's answers to a short window of
    as many requests as the check samples, at the cell's own load, and
    the control's (the reference in TF32 in the program's place) on the
    same requests."""
    s = serving.Serving(ctx)
    call = _call(s)
    n = int(ctx.workload["check"]["sample"])
    records = []
    for _ in range(n):
        r = s.traffic.next()
        records.append({"req": r, "out": call(s.arrays(r)), "ok": True})
    s.clf = call = None
    return serving.calibration(ctx, s, records)
