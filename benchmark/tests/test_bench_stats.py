"""The yardstick's arithmetic: idle shares as unions of device intervals,
percentiles over every request, rooflines and model operations from
shapes."""

import json
import math
import os
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import REPO
from benchmark import stats
from benchmark.costs import fumi, kernels, meta, peaks
from benchmark.harness import load_module
from benchmark.trace import STRETCH, Event, Trace


def metric(name):
    return load_module(os.path.join(REPO, "benchmark", "metrics",
                                    name + ".py"), "m_" + name.replace(
                                        ".", "_"))


def config(name):
    return json.load(open(os.path.join(REPO, "benchmark", "configs",
                                       name + ".json")))


@pytest.mark.parametrize("intervals,covered", [
    ([(0, 10), (5, 15), (20, 30)], 25),  # overlap counted once
    ([(0, 10), (0, 10), (0, 10)], 10),  # three streams at once
    ([(0, 4), (4, 8)], 8),  # touching
    ([(2, 3), (0, 10)], 10),  # nested
    ([], 0),
])
def test_union_counts_overlap_once(intervals, covered):
    assert stats.covered(intervals) == covered


def test_idle_share_is_one_minus_the_union_and_never_negative():
    # kernels that overlap: their sum (30 us) exceeds the 20 us window
    device = [Event("k", 0, 15), Event("k", 5, 20)]
    host = [Event(STRETCH, 0, 20)]
    tr = Trace(device, host, 20e-6)
    assert tr.busy_s == pytest.approx(20e-6)
    assert tr.idle_share() == pytest.approx(0.0)
    tr = Trace([Event("k", 2, 6), Event("k", 4, 8)], host, 20e-6)
    assert tr.idle_share() == pytest.approx(1 - 6 / 20)


def test_gaps_are_named_by_the_innermost_host_operation():
    host = [Event(STRETCH, 0, 100), Event("aten::mm", 10, 40),
            Event("cudaLaunchKernel", 30, 35), Event("prep", 50, 90)]
    device = [Event("k1", 0, 10), Event("k2", 40, 50), Event("k3", 90, 100)]
    out = Trace(device, host, 100e-6).breakdown()
    gaps = dict(out["idle_gaps"])
    assert gaps == {"aten::mm": pytest.approx(30e-6),
                    "prep": pytest.approx(40e-6)}
    assert dict(out["device_ops"])["k2"] == pytest.approx(10e-6)


@pytest.mark.parametrize("q", [0, 25, 50, 95, 100])
def test_percentile_over_every_value(q):
    values = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    want = statistics.quantiles(values, n=100, method="inclusive")
    got = stats.percentile(values, q)
    if 0 < q < 100:
        assert got == pytest.approx(want[q - 1])
    else:
        assert got == (min(values) if q == 0 else max(values))


def test_request_percentiles_count_a_failed_request_as_unanswered():
    rec = {"requests": [{"ms": float(i), "ok": True} for i in range(1, 40)]
           + [{"ms": 1.0, "ok": False}]}
    p50 = metric("request_p50_ms").read(None, rec)
    p95 = metric("request_p95_ms.serve").read(None, rec)
    # the failed request sorts last, as if it never came
    assert p50 == pytest.approx(20.5)
    assert p95 == pytest.approx(38.05)
    rec["requests"][-3]["ok"] = False
    assert math.isinf(metric("request_p95_ms.serve").read(None, rec))


def test_spread_is_the_interquartile_range_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_fused_adapt_cost_at_the_served_shape():
    flops, nbytes = kernels.fused_adapt_cost(1, 25, 128, 2048, 256, 64, 5,
                                             100)
    per_step = 2 * 25 * (2 * 2048 * 256 + 3 * 256 * 64 + 3 * 64 * 5)
    assert flops == 100 * per_step + 2 * 128 * (2048 * 256 + 256 * 64
                                                 + 64 * 5)
    # below 0.1 ms at the fp32 peak: bound by operations, not bytes
    assert 0.08e-3 < peaks.least_seconds(flops, nbytes) < 0.1e-3
    assert flops / peaks.PEAK_FP32_FLOPS > nbytes / peaks.PEAK_BYTES_PER_S


def test_gather_bytes_at_the_train_episode():
    m = 4 * 5 * 37
    assert kernels.widen_bytes(m, 2048, 4) == 8 * m * 2048 + 4 * m
    assert kernels.gather_bytes(m, 4 * 2048) == kernels.widen_bytes(
        m, 2048, 4)
    # the 3.62 us bound of the fp32 train episode
    assert kernels.widen_bytes(m, 2048, 4) / peaks.PEAK_BYTES_PER_S == \
        pytest.approx(3.62e-6, rel=2e-3)


def test_second_order_count_of_one_linear_layer():
    # one layer y = x W on data x: forward u, backward (dW only) u, the
    # outer backward through the step 2u; the query forward and backward 2v
    assert meta.second_order_task([3.0], [5.0], 2) == 2 * (3 + 3 + 6) + 10


def test_model_operations_of_the_configurations():
    f = config("fumi-inat-anim")
    assert 3.0e9 < fumi.step_flops(f) < 4.5e9
    assert fumi.request_flops(f, 128) == pytest.approx(
        kernels.fused_adapt_cost(1, 25, 128, 2048, 256, 64, 5, 100)[0]
        + 2 * 5 * (768 * 256 + 256 * 65))


def test_roofline_reader_counts_the_shapes_not_the_kernel():
    cfg = config("fumi-inat-anim")
    ctx = SimpleNamespace(config=cfg)
    host = [Event(STRETCH, 0, 1e4)]
    kern = [Event("void (anonymous namespace)::fused_adapt_kernel<true>(float)", 0, 2700),
            Event("void (anonymous namespace)::fused_adapt_kernel<true>(float)", 3000, 5700)]
    rec = {"trace": Trace(kern, host, 1e-2), "trace_queries": [128, 10]}
    got = metric("fused_adapt_roofline.serve").read(ctx, rec)
    least = sum(peaks.least_seconds(*kernels.fused_adapt_cost(
        1, 25, m, 2048, 256, 64, 5, 100)) for m in (128, 10))
    assert got == pytest.approx(100 * least / 5.4e-3)
    assert got < 100
    rec["trace_queries"] = [128]  # a launch the reader cannot match
    assert metric("fused_adapt_roofline.serve").read(ctx, rec) is None


def test_gather_roofline_reader_and_no_reading_without_a_kernel():
    # a uint8 table of 84x84x3 images, widened to fp32 by the gather
    cfg = config("fumi-inat-anim")
    cfg["data"] = dict(cfg["data"], row_shape=[84, 84, 3],
                       table_dtype="uint8")
    ctx = SimpleNamespace(config=cfg)
    host = [Event(STRETCH, 0, 1e3)]
    rec = {"trace": Trace([Event("void (anonymous namespace)::gather_kernel<Widen<unsigned char>>", 0, 30), Event("void at::native::vectorized_gather_kernel<16, long>", 40, 42)], host, 1e-3)}
    m = 4 * 5 * 37
    want = 100 * kernels.widen_bytes(m, 84 * 84 * 3, 1) / \
        peaks.PEAK_BYTES_PER_S / 30e-6
    got = metric("gather_episode_roofline.train").read(ctx, rec)
    assert got == pytest.approx(want)
    rec = {"trace": Trace([Event("other", 0, 30)], host, 1e-3)}
    assert metric("gather_episode_roofline.train").read(ctx, rec) is None


def test_tables_follow_the_seed_and_widen_uint8_pixels():
    import torch
    from benchmark.data import make_tables, widen
    data = {"classes": 10, "rows": 63, "split": [0.6, 0.2, 0.2],
            "row_shape": [4, 4, 3], "table_dtype": "uint8",
            "table_values": "uniform_uint8", "text_dim": 5}
    a, b = make_tables(data, 3, "cpu"), make_tables(data, 3, "cpu")
    assert torch.equal(a.image, b.image) and a.image.dtype == torch.uint8
    assert not torch.equal(a.image, make_tables(data, 4, "cpu").image)
    assert list(a.bounds) == [0] + list(np.cumsum([7, 7, 7] + [6] * 7))
    assert [len(a.split_classes[s]) for s in ("train", "val", "test")] == \
        [6, 2, 2]
    w = widen(a.image[:2])
    assert w.dtype == torch.float32
    assert torch.equal(w, a.image[:2].float() * (1.0 / 255.0))


def test_every_block_of_requests_sends_every_size_once():
    from benchmark.data import class_bounds, Tables
    from benchmark.traffic import EpisodeTraffic
    tables = Tables(image=None, text=None, bounds=class_bounds(300, 15),
                    split_classes={"test": np.arange(12, 15)})
    traffic = EpisodeTraffic({"split": "test", "queries": [3, 9, 7]},
                             {"num_ways": 3, "num_shots": 2}, tables, 11)
    reqs = [traffic.next() for _ in range(9)]
    for i in range(0, 9, 3):
        assert sorted(r.m for r in reqs[i:i + 3]) == [3, 7, 9]
    row_class = tables.row_class()
    for r in reqs:
        assert sorted(r.classes) == [12, 13, 14]
        rows = np.concatenate([r.support_rows, r.query_rows])
        assert len(np.unique(rows)) == len(rows)
        assert list(row_class[r.support_rows]) == list(
            np.repeat(r.classes, 2))
        assert list(row_class[r.query_rows]) == list(r.classes[r.query_y])
        assert sorted(np.bincount(r.query_y, minlength=3)) == sorted(
            [r.m // 3 + (j < r.m % 3) for j in range(3)])
    again = EpisodeTraffic({"split": "test", "queries": [3, 9, 7]},
                           {"num_ways": 3, "num_shots": 2}, tables, 11)
    assert all(np.array_equal(again.next().query_rows, r.query_rows)
               for r in reqs)


def test_the_sample_is_drawn_from_the_seed_with_one_longest():
    from benchmark.serving import sample
    from types import SimpleNamespace as Req
    records = [{"req": Req(m=m), "ok": i != 3} for i, m in
               enumerate([5] * 40 + [9])]
    got = sample(records, 6, 2)
    assert len(got) in (6, 7) and all(r["ok"] for r in got)
    assert sum(r["req"].m == 9 for r in got) == 1
    assert got == sample(records, 6, 2)
    assert sample(records, 100, 2) == [r for r in records if r["ok"]]
