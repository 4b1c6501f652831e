"""The readers of the program's spans (``benchmark/spans.py`` and its
metrics) on hand-built traces, and in a traced run of the tiny cells on
the CPU."""

import os

import pytest

from conftest import REPO, run_cpu
from benchmark import spans
from benchmark.harness import load_module
from benchmark.trace import STRETCH, Event, Trace

KERNEL = "void (anonymous namespace)::fused_adapt_kernel<true>(float)"


def metric(name):
    return load_module(os.path.join(REPO, "benchmark", "metrics",
                                    name + ".py"), "m_" + name.replace(
                                        ".", "_"))


def two_requests():
    """Two requests of 1000 us each; times in us on one clock."""
    host = [Event(STRETCH, 0, 2500)]
    device = []
    for at, tail in ((0, 40), (1200, 90)):
        host += [Event("bench.episode_logits", at, at + 1000),
                 Event("serve.request", at + 5, at + 995),
                 Event("serve.checks", at + 10, at + 60),
                 Event("serve.to_device", at + 60, at + 150),
                 Event("hypernet", at + 150, at + 350),
                 Event("fused_adapt", at + 350, at + 400),
                 Event("serve.to_host", at + 400, at + 900)]
        device.append(Event(KERNEL, at + 380, at + 900 - tail))
    return Trace(device, host, 2.5e-3)


def test_answer_tail_is_the_copy_back_after_the_kernel():
    tr = two_requests()
    assert spans.answer_tails_ms(tr) == pytest.approx([0.04, 0.09])
    assert metric("answer_tail_ms.serve").read(None, {"trace": tr}) == \
        pytest.approx(0.065)


@pytest.mark.parametrize("name,want", [
    ("checks_ms.serve", 0.05), ("to_device_ms.serve", 0.09),
    ("hypernet_ms.serve", 0.2)])
def test_request_phases_are_medians_over_requests(name, want):
    got = metric(name).read(None, {"trace": two_requests()})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "checks_ms.serve", "answer_tail_ms.serve", "sample_ms.train",
    "update_ms.train"])
def test_a_program_without_spans_reads_nothing(name):
    tr = Trace([Event(KERNEL, 10, 20)],
               [Event(STRETCH, 0, 100), Event("bench.episode_logits", 0, 90)],
               1e-4)
    assert metric(name).read(None, {"trace": tr, "trace_steps": 2}) is None
    assert metric(name).read(None, {"trace": None, "trace_steps": 2}) is None


def test_step_phases_are_their_union_a_step():
    host = [Event(STRETCH, 0, 1000), Event("train.step", 0, 500),
            Event("train.step", 500, 1000),
            Event("train.update", 100, 200), Event("train.update", 600, 640),
            Event("inner.step", 0, 50), Event("inner.step", 50, 90)]
    rec = {"trace": Trace([Event("k", 0, 1)], host, 1e-3), "trace_steps": 2}
    assert metric("update_ms.train").read(None, rec) == pytest.approx(0.07)
    assert metric("inner_loop_ms.train").read(None, rec) == \
        pytest.approx(0.045)


def test_a_gap_under_the_stretch_alone_is_unnamed_one_under_a_span_not():
    # device busy 0-10, 30-40, 60-100: gaps 10-30 (the stretch alone) and
    # 40-60 (train.update)
    device = [Event("k", 0, 10), Event("k", 30, 40), Event("k", 60, 100)]
    host = [Event(STRETCH, 0, 100), Event("train.update", 35, 65)]
    tr = Trace(device, host, 1e-4)
    assert metric("idle_unnamed_share.train").read(None, {"trace": tr}) == \
        pytest.approx(50.0)
    # a bare runtime call and the harness's own range name nothing either
    host += [Event("cudaStreamSynchronize", 12, 28)]
    tr = Trace(device, host, 1e-4)
    assert spans.unnamed_idle_share(tr) == pytest.approx(50.0)
    tr = Trace(device, [Event(STRETCH, 0, 100),
                        Event("bench.episode_logits", 0, 100),
                        Event("aten::copy_", 40, 60)], 1e-4)
    assert metric("idle_unnamed_share.serve").read(None, {"trace": tr}) == \
        pytest.approx(50.0)


def test_a_span_opened_many_host_events_earlier_still_names_its_gap():
    # ``Trace._host_at`` looks back a few hundred events: a gap after 500
    # short operators inside one inner step is the inner step's
    host = [Event(STRETCH, 0, 20000), Event("inner.step", 0, 20000)]
    host += [Event("aten::mul", 10 + 30 * i, 20 + 30 * i) for i in range(500)]
    device = [Event("k", 0, 15000), Event("k", 16000, 20000)]
    tr = Trace(device, host, 2e-2)
    assert tr._host_at(15500) == "(no host operation)"
    assert spans.unnamed_idle_share(tr) == pytest.approx(0.0)


def test_no_device_operation_reads_nothing():
    tr = Trace([], [Event(STRETCH, 0, 100)], 1e-4)
    assert spans.unnamed_idle_share(tr) is None


@pytest.mark.parametrize("cell,names", [
    ("tiny.serve", ["checks_ms.serve", "to_device_ms.serve",
                    "hypernet_ms.serve"]),
    ("tiny.train", ["sample_ms.train", "inner_loop_ms.train",
                    "meta_grad_ms.train", "update_ms.train",
                    "step_metrics_ms.train"])])
def test_a_traced_run_reports_the_phases(tiny_root, cell, names):
    """On the CPU the trace holds no device operation, so the readers that
    need one (the answer's tail, the unnamed idle share) read nothing."""
    result = run_cpu(tiny_root, cell, trace=True)
    assert result["correct"]
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
        assert result["metrics"][name]["unit"] == "ms"
